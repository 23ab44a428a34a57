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

A fresh process pays for its first touch of a card (the CUDA context, the
first copy each way): :func:`warm_readback_channel` does that on a daemon
thread, first in every warm-up (utils/warmup.py).  Warm device work runs
under :func:`warm_work`, so a trace can tell it from the main path's.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from wisecondorx_tpu_torch.utils.threads import DaemonFuture, start_once

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | torch.device) -> torch.device:
    """Turn a ``--device`` value into a torch.device.

    ``cuda`` raises when no CUDA device is present: the CPU is taken only
    when it is asked for."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {name!r} (cuda, cuda:N or cpu)") from e
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda, cuda:N or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} was requested but torch.cuda.is_available() "
            "is False; pass --device cpu to run on the CPU"
        )
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(
            f"--device {name}: only {torch.cuda.device_count()} CUDA "
            "device(s) are visible"
        )
    return dev


def resolve_devices(name: str | torch.device) -> list[torch.device]:
    """The devices a ``--device`` value names: ``cuda`` every visible
    card, ``cuda:N`` that card, ``cpu`` the CPU.  Raises as
    :func:`resolve_device` does."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def work_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (parity runs), float32 on CUDA."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def to_device(array, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array on ``device``, converted to ``dtype`` on the host
    first.  A CUDA copy is staged in pinned memory and issued on the
    current stream without waiting; on the CPU the array's memory is
    shared where no conversion is needed."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


#: Native ids of the threads that ran warm work in this process.
_WARM_THREAD_IDS: set = set()


@contextlib.contextmanager
def warm_work(device: torch.device):
    """Run the block as a warm-up's device work on ``device``: this
    thread's native id kept (:func:`warm_thread_ids`), inside a
    ``record_function("warmup")`` range, on a CUDA stream of its own, and
    synchronized at its end."""
    device = torch.device(device)
    _WARM_THREAD_IDS.add(threading.get_native_id())
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function("warmup"))
        if device.type == "cuda":
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(device)))
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def warm_thread_ids() -> set:
    """Native ids of the threads that ran :func:`warm_work` so far."""
    return set(_WARM_THREAD_IDS)


#: The round trip of each device, started once per process.
_readback: dict = {}


def warm_readback_channel(devices) -> list[DaemonFuture]:
    """Start (once per process and device) one small host -> device ->
    host round trip per device, as :func:`warm_work`, on a daemon thread
    ``wcx-warm-d2h-<device>``: it creates the device's CUDA context and
    makes the first copy each way.  Returns one future per device;
    ``result()`` gives the round trip's seconds or raises its error."""
    def round_trip(dev):
        t0 = time.perf_counter()
        with warm_work(dev):
            back = (torch.zeros(8, device=dev) + 1).cpu()
        if not bool((back == 1).all()):
            raise RuntimeError(f"{dev}: the warm-up round trip read back {back}")
        return time.perf_counter() - t0

    return [start_once(_readback, torch.device(d),
                       lambda d=torch.device(d): round_trip(d),
                       f"wcx-warm-d2h-{torch.device(d)}")
            for d in devices]
