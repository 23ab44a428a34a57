"""The benchmark's own arithmetic: the generator copy, the KNN work count,
the idle share of a trace, and the comparison's parsing."""

import json
import os
import sys

import numpy as np
import pytest

from wcxbench import cohort, readers, spec, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_generator_copy_reproduces_the_tests_generator(seed):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from synthetic import CohortSim
    finally:
        sys.path.pop(0)
    a = CohortSim(binsize=5e4, genome_scale=0.02, seed=seed)
    b = cohort.CohortSim(binsize=5e4, genome_scale=0.02, seed=seed)
    cnvs = [(21, 0, len(a.bias[20]), 3.0)]
    for (sa, ga), (sb, gb) in zip(zip(*a.cohort(3, 2)), zip(*b.cohort(3, 2))):
        assert ga == gb
        assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    sa, sb = a.sample("F", cnvs), b.sample("F", cnvs)
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_seeds_past_32_bits_and_negative_ones_draw():
    assert cohort.numpy_seed(-1) == 2**64 - 1
    cohort.CohortSim(genome_scale=0.01, seed=cohort.numpy_seed(2**33 + 1))


def test_knn_work_by_hand():
    knn = spec.metric_reader("knn_roofline")
    # Two autosomes of 2 and 3 bins at 1 bin each (chr3..22 empty), chrX
    # of 2 bins, chrY of 1; one bin of chr2 masked out.
    bins = np.array([2, 3] + [0] * 20 + [2, 1])
    mask_a = np.array([1, 1, 1, 0, 1], dtype=bool)
    mask_f = np.array([1, 1, 1, 0, 1, 1, 1], dtype=bool)
    flops, nbytes = knn.search_work({"A": mask_a, "F": mask_f}, bins,
                                    {"A": 10, "F": 4}, refsize=3)
    # A: rows on chr1 (2) see chr2's 2 bins, rows on chr2 (2) see chr1's 2.
    a_flops = 2 * 10 * (2 * 2 + 2 * 2)
    # F: only chrX's 2 rows search, each over the 4 autosomal bins.
    f_flops = 2 * 4 * (2 * 4)
    assert flops == a_flops + f_flops
    assert nbytes == (4 * 4 * 10 + 8 * 3 * 4) + (4 * 6 * 4 + 8 * 3 * 2)


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_share_of_a_hand_made_trace(tmp_path):
    events = [
        _event("wcxbench.traced", "user_annotation", 0, 1000),
        _event("predict.write", "user_annotation", 500, 400),
        _event("k1", "kernel", 100, 100),        # 100-200
        _event("k2", "kernel", 150, 100),        # 150-250, overlaps k1
        _event("copy", "gpu_memcpy", 300, 50),   # 300-350
        _event("late", "kernel", 990, 100),      # clipped to 990-1000
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(trace.load_events(str(path)), "wcxbench.traced")
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((150 + 50 + 10) * 1e-6)
    assert s["idle_gaps"][0] == ["predict.write", pytest.approx(640e-6)]
    assert [g[1] for g in s["idle_gaps"]] == sorted((g[1] for g in s["idle_gaps"]), reverse=True)

    class Run:
        traced = s
    assert readers.idle_percent(Run) == pytest.approx(100 * (1 - 210 / 1000))
    Run.traced = {**s, "busy_s": 0.0}
    assert readers.idle_percent(Run) is None  # nothing ran on a device


def test_device_seconds_of_the_threads_that_launch_the_search():
    def launch(corr, tid, ts):
        return {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
                "pid": 1, "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def device(name, corr, dur, cat="kernel"):
        return {"ph": "X", "name": name, "cat": cat, "pid": 0, "tid": 7,
                "ts": 500, "dur": dur, "args": {"correlation": corr}}

    events = [
        launch(1, 11, 10), device("knn_bucket_kernel", 1, 40),
        launch(2, 11, 20), device("radixSortKVInPlace", 2, 300),  # same thread
        launch(3, 11, 30), device("Memcpy DtoH", 3, 25, "gpu_memcpy"),
        launch(4, 12, 40), device("knn_topk_kernel", 4, 5),       # another pass
        launch(5, 99, 50), device("arc_max_kernel", 5, 1000),     # not a search
        device("orphan", 6, 77),                                  # no launch seen
    ]
    got = trace.device_seconds_of_threads(events, lambda n: "knn" in n)
    assert got == pytest.approx((40 + 300 + 25 + 5) * 1e-6)
    assert trace.device_seconds_of_threads(events, lambda n: "none" in n) == 0.0


def test_tables_parse_in_their_own_precision():
    from wcxbench.reference.compare import _column

    f32 = [str(np.float32(v)) for v in (0.1, -0.25, 1e-7)] + ["nan"]
    got = _column(f32)
    assert got.tolist() == [float(np.float32(0.1)), -0.25, float(np.float32(1e-7)), 0.0]
    f64 = [repr(0.1), repr(1 / 3), "nan"]
    assert _column(f64).tolist() == [0.1, 1 / 3, 0.0]


def test_tf32_rounding():
    import torch

    from wcxbench.reference.predict import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11)])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10)]
