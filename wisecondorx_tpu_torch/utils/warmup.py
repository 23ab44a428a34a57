"""Cold-process warm-up.

Counterpart of wisecondorx_tpu/utils/warmup.py.  A fresh ``newref``,
``predict`` or ``predict-batch`` process pays, the first time it touches a
card, for work that no later call pays again: the CUDA context and the
first copy each way, the kernel library (an nvcc build in a fresh
checkout, then its load), and the loading of each kernel family's module
at its first launch.  Without a warm-up all of it lands on the critical
path, wherever the main path first needs the card.

The CLIs start a warm-up on daemon threads before they read their inputs:
:func:`start_warmup` (newref: the round trip and the kernel library),
:func:`start_predict_warmup` and :func:`start_predict_batch_warmup` (the
round trip, the translation of a small neighbour table at the reference's
``k``, and the load of the ``_bins.bed`` row formatter and of the
z-score's null-sum pass, a g++ build each in a fresh checkout).  On CUDA
no program is compiled per shape, so unlike the JAX module the warm-up
plans no pass shapes; what a first launch of the other kernel families
costs, and why nothing more is warmed, is measured in PERF.md
(chip_smoke.py's ``cold`` phase).

Unlike the JAX module, nothing here is best effort: a warm-up is a
:class:`Warmup` whose ``result()`` the main path calls just before its own
first device use (newref: the cohort's upload; predict and predict-batch:
the reference loader's first upload), and which raises there any error
the warm-up met (a kernel library that does not build fails the command
with nvcc's output).  A warm-up that failed is started again by the next
call; one that succeeded is not.  The warm work

* touches no random state and launches no KNN kernel or CBS round, so
  the main path's counters stay its own;
* runs under ``device.warm_work`` (its own stream, a
  ``record_function("warmup")`` range, its thread's id kept), so a trace
  can tell its kernels apart;
* keeps its Python to a few calls: the main thread is parsing inputs
  beside it;
* logs its steps as ``warmup.<step>`` stages, never traced; the main
  path's wait is ``warmup.wait.<label>``.

On the CPU the same code runs at a tiny size on the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from wisecondorx_tpu_torch.device import (
    to_device,
    warm_readback_channel,
    warm_work,
)
from wisecondorx_tpu_torch.utils.log import stage_timer
from wisecondorx_tpu_torch.utils.threads import DaemonFuture, start_once

#: Warm-ups started in this process, by (kind, device).
_started: dict = {}
#: Rows of the warm translation.
WARM_ROWS = 256


class Warmup:
    """The warm-ups a command started: ``result()`` joins them and raises
    the first error one of them met, timed as ``warmup.wait.<label>``;
    ``wait()`` joins them without raising."""

    def __init__(self, futures, label: str):
        self._futures = list(futures)
        self._label = label

    def result(self) -> None:
        with stage_timer(f"warmup.wait.{self._label}", trace=False):
            for fut in self._futures:
                fut.result()

    def wait(self) -> None:
        for fut in self._futures:
            fut.wait()


def _warm_context(device) -> None:
    """The device's round trip (``device.warm_readback_channel``)."""
    with stage_timer("warmup.context", trace=False):
        warm_readback_channel([device])[0].result()


def _warm_library(device) -> None:
    """Build if needed and load the kernel library (CUDA only)."""
    if device.type == "cuda":
        from wisecondorx_tpu_torch.ops import _build

        with stage_timer("warmup.library", trace=False):
            _build.load()


def _warm_tables() -> None:
    """Build if needed and load the ``_bins.bed`` row formatter and the
    z-score's null-sum pass (host only; once per process).  A library that
    does not build fails nothing: the rows then take the Python loop
    (``tables.load_formatter``), the sums numpy (``stats.load_null_sums``)."""
    from wisecondorx_tpu_torch.ops import stats
    from wisecondorx_tpu_torch.output import tables

    with stage_timer("warmup.tables", trace=False):
        tables.load_formatter()
        stats.load_null_sums()


def warm_translate(device, k: int) -> None:
    """The upload and the device translation of a small int32 neighbour
    table with ``k`` columns, its cutoff read from packed bits, on
    ``device`` (synchronous), as ``models/ref_loader.py`` runs them."""
    from wisecondorx_tpu_torch.models import ref_loader

    rows, k = WARM_ROWS, int(k)
    with stage_timer("warmup.translate", trace=False), warm_work(device):
        # Translated (start 0, size 3), the indexes stay in [3, rows).
        idx = np.arange(rows * k, dtype=np.int64).reshape(rows, k) * 7919
        idx = to_device((idx % (rows - 3)).astype(np.int32), device)
        starts = to_device(np.zeros(rows, np.int64), device)
        sizes = to_device(np.full(rows, 3, np.int64), device)
        packed = to_device(np.full((rows, -(-k // 8)), 0xA5, np.uint8), device)
        ref_loader.translate_on_device(idx, starts, sizes,
                                       ref_loader.keep_from_bits(packed, k))


def _start(kind: str, device, work) -> DaemonFuture:
    device = torch.device(device)
    return start_once(_started, (kind, device), lambda: work(device),
                      f"wcx-warmup-{kind}-{device}")


def start_warmup(devices) -> Warmup:
    """newref's warm-up on each of ``devices`` (the devices this process
    runs on): the round trip, then the kernel library.  Join it before
    the first device use."""
    warm_readback_channel(devices)

    def work(device):
        _warm_context(device)
        _warm_library(device)

    return Warmup((_start("newref", d, work) for d in devices), "newref")


def start_predict_warmup(ref_path, device) -> Warmup:
    """predict's warm-up on ``device``: the round trip, then
    :func:`warm_translate` at the reference's ``k``, read from the npz
    headers without its tables, then the row formatter and the null-sum
    pass (:func:`_warm_tables`).  Join it before the loader's first upload."""
    return start_predict_batch_warmup(ref_path, [device])


def start_predict_batch_warmup(ref_path, devices) -> Warmup:
    """predict-batch's warm-up: :func:`start_predict_warmup`'s on each of
    ``devices``."""
    from wisecondorx_tpu_torch.io.npz import reference_npz_headers

    warm_readback_channel(devices)

    def work(device):
        _warm_context(device)
        k = reference_npz_headers(ref_path)["A"]["indexes_shape"][1]
        warm_translate(device, k)
        _warm_tables()

    return Warmup((_start("predict", d, work) for d in devices), "predict")
