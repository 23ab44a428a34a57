"""Splitting the port's work over devices, against one device and against
wisecondorx_tpu on the CPU:

* the KNN search split into three row parts on ``[cpu] * 3`` equals one
  part bit for bit, on integer data with ties at the k boundary (as the
  JAX package's tests/test_parallel.py holds its own split), and equals
  the JAX package's ``knn_search_multidevice`` over its 8 virtual devices;
* gonosomal-style row ranges split correctly;
* ``knn_search_exact`` over all rows equals the concatenation of its row
  ranges split at 1, 3 and n // 2 (a product's rows depend on the rows
  beside them unless every product has one shape);
* ``shard_files`` equals the JAX package's;
* ``predict_batch`` on ``[cpu, cpu]`` equals one device bit for bit;
* ``resolve_devices`` turns ``--device`` values into device lists and
  never takes the CPU for a card.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from synthetic import CohortSim
from torch_parity import CPU, layout, t64
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu.parallel import multihost as jmultihost
from wisecondorx_tpu.parallel.sharded_knn import (
    knn_search_multidevice as jax_multidevice,
)
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.device import resolve_devices
from wisecondorx_tpu_torch.ops import knn as tknn
from wisecondorx_tpu_torch.parallel import multihost, sharded_knn

BINS = [400, 350, 274, 180]


def _integer_data(seed=7, samples=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=(sum(BINS), samples)).astype(np.float64)


@pytest.mark.parametrize("row_range", [None, (700, 1204)],
                         ids=["all-rows", "gonosomal-range"])
def test_three_part_split_equals_one_part_with_ties(row_range):
    starts, chr_of_bin = layout(BINS)
    data = _integer_data()
    one = sharded_knn.knn_search_multidevice(
        t64(data), chr_of_bin, starts, BINS, ref_size=25, row_range=row_range,
    )
    one = tuple(t.cpu().numpy() for t in one)
    srt = np.sort(one[1], axis=1)
    assert (srt[:, -1] == srt[:, -2]).any()  # ties at the k boundary
    stats = {}
    three = sharded_knn.knn_search_multidevice(
        t64(data), chr_of_bin, starts, BINS, ref_size=25, row_range=row_range,
        devices=[CPU] * 3, stats=stats,
    )
    three = tuple(t.cpu().numpy() for t in three)
    np.testing.assert_array_equal(three[0], one[0])
    np.testing.assert_array_equal(three[1], one[1])
    r0, r1 = row_range or (0, sum(BINS))
    assert three[0].shape == (r1 - r0, 25) and stats["n_rows"] == r1 - r0
    # The JAX package's own split over its virtual devices, in float64.
    want_i, want_d = jax_multidevice(
        data, chr_of_bin, starts, BINS, ref_size=25, row_range=row_range,
        devices=jax.devices(), col_tile=128, merge_method="sort",
    )
    np.testing.assert_array_equal(three[0], want_i)
    np.testing.assert_allclose(three[1], want_d, rtol=1e-10)


@pytest.mark.parametrize("r0,r1,parts,want", [
    (0, 1204, 3, [0, 401, 802, 1204]),
    (700, 1204, 3, [700, 868, 1036, 1204]),
    (0, 10, 3, [0, 10]),  # fewer than 4 rows a device: one part
])
def test_row_ranges_split_like_the_jax_package(r0, r1, parts, want,
                                               monkeypatch):
    """The parts' bounds are the JAX package's ``np.linspace`` ones, and a
    range too small to split stays one part."""
    seen = []
    real = sharded_knn.knn_search

    def spy(data, *args, row_range=None, **kw):
        seen.append(row_range)
        return real(data, *args, row_range=row_range, **kw)

    monkeypatch.setattr(sharded_knn, "knn_search", spy)
    starts, chr_of_bin = layout(BINS)
    sharded_knn.knn_search_multidevice(
        t64(_integer_data()), chr_of_bin, starts, BINS, ref_size=5,
        row_range=(r0, r1), devices=[CPU] * parts,
    )
    assert sorted(seen) == list(zip(want[:-1], want[1:]))
    if len(want) == parts + 1:
        np.testing.assert_array_equal(sharded_knn.split_bounds(r0, r1, parts),
                                      np.linspace(r0, r1, parts + 1).astype(int))


@pytest.mark.parametrize("kind", ["lognormal", "normal"])
def test_exact_search_does_not_depend_on_the_split(kind):
    rng = np.random.default_rng(5)
    starts, chr_of_bin = layout(BINS[:3])
    n = sum(BINS[:3])
    data = t64(rng.lognormal(0, 0.02, size=(n, 24)) if kind == "lognormal"
               else rng.normal(1.0, 0.03, size=(n, 40)))
    whole = tknn.knn_search_exact(data, chr_of_bin, starts, BINS[:3], 25)
    cuts = [0, 1, 3, n // 2, n]
    parts = [tknn.knn_search_exact(data, chr_of_bin, starts, BINS[:3], 25,
                                   row_range=(a, b))
             for a, b in zip(cuts[:-1], cuts[1:])]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts]), whole[1])


def test_multihost_with_one_process_is_multidevice():
    starts, chr_of_bin = layout(BINS)
    data = t64(_integer_data(seed=9))
    a = sharded_knn.knn_search_multidevice(data, chr_of_bin, starts, BINS,
                                           ref_size=15, devices=[CPU] * 2)
    b = multihost.knn_search_multihost(data, chr_of_bin, starts, BINS,
                                       ref_size=15, devices=[CPU] * 2)
    a, b = (tuple(t.cpu().numpy() for t in pair) for pair in (a, b))
    assert multihost.process_index_count() == (0, 1)
    assert multihost.all_agree(True) and not multihost.all_agree(False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_files,count", [(11, 4), (24, 2), (25, 2), (3, 5),
                                           (7, 1)])
def test_shard_files_equals_jax(n_files, count):
    files = [f"s{i}.npz" for i in range(n_files)]
    shards = [multihost.shard_files(files, p, count) for p in range(count)]
    assert shards == [jmultihost.shard_files(files, p, count)
                      for p in range(count)]
    assert sum(shards, []) == files


def test_maybe_initialize_distributed_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.maybe_initialize_distributed() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.maybe_initialize_distributed()


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_plate")
    sim = CohortSim(binsize=1e5, genome_scale=0.006, seed=31)
    samples, _ = sim.cohort(7, 6)
    infiles = []
    for i, s in enumerate(samples):
        path = tmp / f"control_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        infiles.append(str(path))
    ref = str(tmp / "reference.npz")
    torch_cli(["newref", *infiles, ref, "--refsize", "25", "--device", "cpu"])
    cases = [sim.sample("F", cnvs=[(18, 1, 5, 3.0)]), sim.sample("M"),
             sim.sample("F"), sim.sample("M", cnvs=[(4, 0, 4, 1.0)]),
             sim.sample("F")]
    return ref, [(c, 100000) for c in cases]


def test_predict_batch_on_two_devices_equals_one(plate):
    from wisecondorx_tpu_torch.models.predictor import PredictConfig
    from wisecondorx_tpu_torch.parallel.batch import predict_batch

    ref, cases = plate
    cfg = PredictConfig(minrefbins=10)
    # Chunks of 3: one device's chunks are samples 0-2 and 3-4; the two
    # devices' are 0-1 and 2-4, so most samples move within their chunk.
    one = predict_batch(copy.deepcopy(cases), ref, cfg, [CPU], chunk=3)
    two = predict_batch(copy.deepcopy(cases), ref, cfg, [CPU, CPU], chunk=3)
    assert len(one) == len(two) == len(cases)
    for a, b in zip(one, two):
        assert (a.ref_gender, a.gender) == (b.ref_gender, b.gender)
        for field in ("results_r", "results_z", "results_w", "results_nr"):
            for x, y in zip(getattr(a, field), getattr(b, field)):
                np.testing.assert_array_equal(x, y)


def test_launch_counts_lose_no_update_across_threads():
    """Searches on several devices count launches from several threads;
    with the interpreter switching threads every microsecond no update is
    lost."""
    import sys
    import threading

    from wisecondorx_tpu_torch.ops import knn_cuda

    knn_cuda.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [knn_cuda._count_launch("knn_bucket")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert knn_cuda.LAUNCHES["knn_bucket"] == 16 * 2000
    knn_cuda.reset_launch_counts()


def test_resolve_devices(monkeypatch):
    assert resolve_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_devices(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices("cuda") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 CUDA"):
        resolve_devices("cuda:2")
    for bad in ("tpu", "gpu", "meta"):
        with pytest.raises(ValueError, match="unsupported"):
            resolve_devices(bad)
