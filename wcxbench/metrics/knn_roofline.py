"""KNN kernels: the least time the card could take for the searches of
the traced builds over the device time of the searches, in %.

The device time is every device operation (kernel, copy, memset) that
the host threads running the searches launched in the traced window: the
threads that launch a kernel whose name holds "knn".  Each pass's search
runs its whole ``newref.pass_<g>.knn`` stage on a thread of its own, so
this is the stage's device work whatever implements it: the bucketed
scan and the top-k, the dense rerun of flagged rows and its sort, and
the null ratios and the tables' download that the stage also queues.

The work is what the search needs, whatever implements it, counted from
the cell's cohort and the build's masks:

* operations: 2 x samples x other-chromosome candidates, summed over each
  pass's searched rows (A: every masked autosomal bin; F and M: their
  chrX and chrY bins), per pass over its own samples;
* bytes: each pass's cohort read once in float32, and its searched rows'
  ``refsize`` int32 indexes and float32 distances written once.

The peak: the repository's precision rule asks for full float32 accuracy,
so the operations are bounded at the card's f32-accurate matrix rate: the
published TF32 peak of an H100 SXM at 700 W, 495 TFLOP/s, over the three
TF32 passes that accuracy takes; bytes at 3.35 TB/s.
"""

import numpy as np

from wcxbench import trace

LAYER = "KNN kernels"
MOVES = "newref_s"
UNIT = "%"
SOURCE = "device_trace"

POWER_LIMIT_W = 700
F32_ACCURATE_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
LAST_CHR = {"A": 22, "F": 23, "M": 24}


def search_work(masks: dict, bins_per_chr, samples: dict, refsize: int):
    """(operations, bytes) of one build's searches; ``masks`` and
    ``samples`` by pass ("A", "F", "M")."""
    flops = nbytes = 0
    for gender, mask in masks.items():
        n_chr = LAST_CHR[gender]
        chr_of_bin = np.repeat(np.arange(n_chr), np.asarray(bins_per_chr)[:n_chr])
        sizes = np.bincount(chr_of_bin[np.asarray(mask, dtype=bool)], minlength=n_chr)
        rows = sizes if gender == "A" else np.where(np.arange(n_chr) >= 22, sizes, 0)
        n, s = int(sizes.sum()), int(samples[gender])
        flops += 2 * s * int(np.sum(rows * (n - sizes)))
        nbytes += 4 * n * s + 8 * refsize * int(rows.sum())
    return flops, nbytes


def read(run):
    traced = run.traced
    built = sum(j["samples"] for j in traced["jobs"]) if traced else 0
    device_s = trace.device_seconds_of_threads(
        traced["events"], lambda name: "knn" in name.lower()) if traced else 0.0
    path = run.state.get("kept")
    if not built or device_s <= 0 or path is None:
        return None
    with np.load(path, allow_pickle=True) as ref:
        masks = {g: ref["mask" + ("" if g == "A" else f".{g}")]
                 for g in ("A", "F", "M") if ("mask" if g == "A" else f"mask.{g}") in ref}
        bins = ref["bins_per_chr.M" if "bins_per_chr.M" in ref else "bins_per_chr.F"]
    sexes = run.inputs["genders"]
    samples = {"A": len(sexes), "F": sexes.count("F"), "M": sexes.count("M")}
    flops, nbytes = search_work(masks, bins, samples, int(run.config["refsize"]))
    least = max(flops / F32_ACCURATE_FLOPS, nbytes / HBM_BYTES_PER_S)
    return 100.0 * least * built / device_s
