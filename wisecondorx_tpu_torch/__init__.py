"""wisecondorx_tpu_torch — the PyTorch / CUDA port of wisecondorx_tpu.

Runs the ``newref`` -> ``predict`` path of the JAX package on PyTorch
tensors, with the per-bin KNN search of ``newref`` in two hand-written
CUDA kernels for Hopper (``csrc/``).  The reference ``.npz`` schema is
shared with the JAX package, so a reference built by either drives the
other's predict.

Host-only helpers that import no JAX (genome layouts, npz I/O, masks,
segment statistics, output tables) are imported from ``wisecondorx_tpu``.
"""

__version__ = "0.1.0"
