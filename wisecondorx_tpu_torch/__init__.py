"""wisecondorx_tpu_torch — the PyTorch / CUDA port of wisecondorx_tpu.

Runs the ``convert`` -> ``newref`` -> ``predict`` / ``predict-batch`` path
of the JAX package on PyTorch tensors, with the per-bin KNN search of
``newref`` in two hand-written CUDA kernels for Hopper (``csrc/``).  The
``.npz`` schemas and BED tables are the JAX package's, byte for byte, so a
reference built by either drives the other's predict.

The port imports nothing of ``wisecondorx_tpu``: it keeps its own copies of
the host modules it needs (genome layouts, npz and BAM/CRAM I/O with the
native reader sources, masks, segment statistics, output tables, reference
QC).  Its tests run on the CPU (``python -m pytest tests/test_torch_*.py``,
each module held against its JAX-package counterpart); on a machine with an
NVIDIA Hopper GPU, ``python3 chip_smoke.py`` builds the kernels and drives
the whole path on the card.
"""

__version__ = "0.1.0"
