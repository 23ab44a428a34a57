"""Device and dtype policy of the PyTorch port.

Every function of the port takes an explicit ``device`` (or reads it from
the tensor it is given); nothing consults a global backend.  The working
float type follows the device:

* CPU: float64, so the port can be held against the JAX package's x64
  CPU path at tight tolerances;
* CUDA: float32, the type the hand-written KNN kernels take.  The KNN
  wrapper centres and rescales its input before the norm-trick distance
  so float32 keeps its accuracy (ops/knn_cuda.py).

TF32 is switched off for both matmuls and cuDNN: TF32 keeps ~10 mantissa
bits, and the Gram and distance products here resolve differences many
decades below their operands' norms (the same trap as the TPU's bf16
default).  PyTorch already defaults matmuls to full float32, but cuDNN
defaults to TF32, so both are set explicitly.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | torch.device) -> torch.device:
    """Turn a ``--device`` value into a torch.device.

    ``cuda`` raises when no CUDA device is present: the CPU is taken only
    when it is asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def work_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (parity runs), float32 on CUDA."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
