"""The CUDA kernels of the PyTorch port on the card: each against its plain
PyTorch version on the same CUDA tensors.  Marked ``cuda``; each test
skips where no CUDA device is present.  On a machine with an NVIDIA
Hopper GPU and nvcc, which has no JAX for tests/conftest.py:
``PYTHONPATH=tests python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import layout
from wisecondorx_tpu_torch.ops import knn as tknn
from wisecondorx_tpu_torch.ops import knn_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _integer_inputs(dev, n=6000, s=64, r=3000, offset=100, seed=0):
    """Integer-valued float32 inputs: every distance is exact in float32,
    so a kernel and its plain version must agree bit for bit."""
    rng = np.random.default_rng(seed)
    bins = [n // 4] * 3 + [n - 3 * (n // 4)]
    starts, chr_of_bin = layout(bins)
    lanes = knn_cuda.LANES
    n_pad = -(-n // lanes) * lanes
    cand = torch.zeros((n_pad, s), device=dev)
    cand[:n] = torch.as_tensor(rng.integers(0, 8, (n, s)), dtype=torch.float32,
                               device=dev)
    cnorm = (cand * cand).sum(dim=1)
    cchr = torch.full((n_pad,), -2, dtype=torch.int32, device=dev)
    cchr[:n] = torch.as_tensor(chr_of_bin, device=dev)
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    sz = torch.as_tensor(bins, dtype=torch.int32, device=dev)
    rchr = cchr[offset : offset + r]
    return (cand[offset : offset + r], cnorm[offset : offset + r], rchr,
            st[rchr.long()].contiguous(), sz[rchr.long()].contiguous(),
            cand, cnorm, cchr, n)


@pytest.mark.parametrize("sentinel", [1e30, 120.0])
def test_k1_k2_equal_plain_versions(dev, sentinel):
    *args, n = _integer_inputs(dev)
    got = knn_cuda.bucket_scan(*args, n, sentinel)
    want = knn_cuda.bucket_scan_reference(
        *args, n, sentinel, lanes=knn_cuda.LANES, depth=knn_cuda.DEPTH
    )
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in (300, 17):
        g2 = knn_cuda.extract_topk(*got, k)
        w2 = knn_cuda.extract_topk_reference(*want, k)
        torch.cuda.synchronize()
        assert torch.equal(g2[0], w2[0]) and torch.equal(g2[2], w2[2])
        finite = torch.isfinite(g2[0])
        assert torch.equal(g2[1][finite], w2[1][finite])


@pytest.mark.parametrize("s", [700, 1000, 4096])
def test_k1_equals_plain_version_on_wide_sample_axes(dev, s):
    """Above 672 samples (s_pad) the rows stream through K1's ring instead
    of staying resident; the pools stay exact on integer inputs."""
    *args, n = _integer_inputs(dev, n=5000, s=s, r=700, offset=300, seed=s)
    if s % knn_cuda.S_MULTIPLE:  # the wrapper's padding of the sample axis
        pad = knn_cuda.S_MULTIPLE - s % knn_cuda.S_MULTIPLE
        args[0] = torch.nn.functional.pad(args[0], (0, pad)).contiguous()
        args[5] = torch.nn.functional.pad(args[5], (0, pad)).contiguous()
    sentinel = chip_smoke.INT_SENTINEL_PER_SAMPLE * s  # masks about half
    knn_cuda.reset_launch_counts()
    got = knn_cuda.bucket_scan(*args, n, sentinel)
    assert knn_cuda.LAUNCHES["knn_bucket"] == 1
    want = knn_cuda.bucket_scan_reference(
        *args, n, sentinel, lanes=knn_cuda.LANES, depth=knn_cuda.DEPTH
    )
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", chip_smoke.k2_edge_cases(), ids=lambda c: c[0])
def test_k2_equals_plain_version_at_the_edges(dev, case):
    _, *arrays, k = case
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    got = knn_cuda.extract_topk(*args, k)
    want = knn_cuda.extract_topk_reference(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_search_agrees_with_exact_float64(dev):
    rng = np.random.default_rng(1)
    bins = [3000, 2500, 2000, 1500]
    starts, chr_of_bin = layout(bins)
    data = torch.as_tensor(
        1.0 + 0.03 * rng.standard_normal((sum(bins), 128)), device=dev
    )
    got_i, got_d = knn_cuda.knn_search_cuda(
        data.float(), chr_of_bin, starts, bins, 300
    )
    want_i, want_d = tknn.knn_search_exact(data, chr_of_bin, starts, bins, 300)
    agree = np.array([
        len(np.intersect1d(a, b))
        for a, b in zip(got_i.cpu().numpy(), want_i.cpu().numpy())
    ]) / 300
    # The bar of dev/tpu_vs_oracle.py: mean 99.9 %, min 299 of 300.
    assert agree.mean() >= 0.999 and agree.min() >= 299 / 300
    np.testing.assert_allclose(
        np.sort(got_d.cpu().numpy(), axis=1),
        np.sort(want_d.cpu().numpy(), axis=1), rtol=1e-4,
    )


def test_wrapper_rejects_what_the_kernels_do_not_take(dev):
    *args, n = _integer_inputs(dev, n=3000, r=100)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        knn_cuda.bucket_scan(*bad, n, 1e30)
    with pytest.raises(ValueError):
        knn_cuda.bucket_scan(*args, n, 1e30, depth=knn_cuda.DEPTH + 1)
    vals, idx, drop = knn_cuda.bucket_scan(*args, n, 1e30)
    with pytest.raises(ValueError):
        knn_cuda.extract_topk(vals, idx, drop, vals.shape[1] + 1)


def test_pipelined_newref_equals_the_checkpointed_one(dev, tmp_path, monkeypatch):
    """newref's passes on the card, built without and with a checkpoint
    directory, are equal in every member, bit for bit; in both builds the
    K1 launches come from the search threads, each on a stream other than
    the device's default one."""
    import copy
    import threading

    from synthetic import CohortSim
    from wisecondorx_tpu_torch.models.reference import NewrefConfig, build_reference

    samples, _ = CohortSim(binsize=1e5, genome_scale=0.05, seed=3).cohort(12, 12)
    launches = []
    scan = knn_cuda.bucket_scan

    def recording(*args, **kwargs):
        d = args[0].device
        launches.append((threading.current_thread().name,
                         torch.cuda.current_stream(d) != torch.cuda.default_stream(d)))
        return scan(*args, **kwargs)

    monkeypatch.setattr(knn_cuda, "bucket_scan", recording)
    built = {}
    for mode, ckpt_dir in (("pipelined", None), ("checkpointed", str(tmp_path / "ck"))):
        launches.clear()
        cfg = NewrefConfig(binsize=100000, refsize=50, checkpoint_dir=ckpt_dir)
        built[mode] = (build_reference([(copy.deepcopy(s), 100000) for s in samples],
                                       cfg, dev)[0], list(launches))
    (piped, piped_launches), (ckpt, ckpt_launches) = built["pipelined"], built["checkpointed"]
    for launched in (piped_launches, ckpt_launches):
        assert launched
        assert all(name.startswith("wcx-search-") and side for name, side in launched)
    assert piped.keys() == ckpt.keys()
    for g in piped:
        assert piped[g].keys() == ckpt[g].keys(), g
        for key in piped[g]:
            a, b = np.asarray(piped[g][key]), np.asarray(ckpt[g][key])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{g}/{key}"


@pytest.mark.parametrize("maskrepeats", [5, 3, 0])
def test_predict_tables_and_dispatch_on_the_card(dev, tmp_path, maskrepeats):
    """The streamed loader's tables built on the card (stored indexes and
    the cutoff bits or distances uploaded, translated there) equal the
    CPU's and the plain numpy translation; both passes dispatch with
    syncs made errors and equal the sequential passes."""
    from synthetic import CohortSim
    from wisecondorx_tpu_torch.io.npz import _savez_fast, flatten_reference
    from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader
    from wisecondorx_tpu_torch.models.reference import NewrefConfig, build_reference

    cpu = torch.device("cpu")
    sim = CohortSim(binsize=1e5, genome_scale=0.05, seed=4)
    samples, _ = sim.cohort(12, 12)
    passes, meta = build_reference([(s, 100000) for s in samples],
                                   NewrefConfig(binsize=100000, refsize=50), cpu)
    ref = str(tmp_path / "ref.npz")
    _savez_fast(ref, flatten_reference(passes, is_nipt=meta["is_nipt"],
                                       trained_cutoff=meta["trained_cutoff"]))
    for gender in ("F", "M"):
        on_card = chip_smoke.tables_vs_plain(ref, gender, dev, maskrepeats)
        assert all(t["equal"] for t in on_card.values())
        with ReferenceLoader(ref, dev) as card, ReferenceLoader(ref, cpu) as host:
            for loader in (card, host):
                loader.start([gender], maskrepeats)
            for g in ("A", gender):
                assert torch.equal(card.tables(g).sentinel_idx.cpu(),
                                   host.tables(g).sentinel_idx)
    case = str(tmp_path / "case.npz")
    chip_smoke.save_sample(case, sim.sample("F", cnvs=[(21, 0, 20, 3.0)]), 100000)
    record = chip_smoke.dispatch_without_sync(ref, case, dev, 100000)
    assert record["equal_to_sequential"] and record["passes"] == ["A", "F"]


@pytest.mark.parametrize("mode, route", [("always", "pieces"), ("never", "stored")])
def test_loader_reads_members_into_pinned_memory(dev, tmp_path, monkeypatch, mode,
                                                 route):
    """The streamed loader on the card reads the indexes it uploads
    straight into pinned memory, on the member's route (a deflated A table
    inflated in pieces, or a stored one read by range; the gonosomal rows
    from the first target row on), and its tables equal the plain numpy
    translation of the same reference."""
    from synthetic import CohortSim
    from wisecondorx_tpu_torch.io import npz
    from wisecondorx_tpu_torch.models import ref_loader
    from wisecondorx_tpu_torch.models.reference import NewrefConfig, build_reference

    samples, _ = CohortSim(binsize=1e5, genome_scale=1.0, seed=5).cohort(12, 12)
    passes, meta = build_reference([(s, 100000) for s in samples],
                                   NewrefConfig(binsize=100000, refsize=100), dev)
    ref = str(tmp_path / "ref.npz")
    with monkeypatch.context() as m:
        m.setenv("WCX_NPZ_COMPRESS", mode)
        npz._savez_fast(ref, npz.flatten_reference(
            passes, is_nipt=meta["is_nipt"], trained_cutoff=meta["trained_cutoff"]))
    read = npz.NpzReader.read
    seen = {}

    def spy(self, key, row_start=0, stats=None, alloc=None):
        stats = {} if stats is None else stats
        out = read(self, key, row_start, stats, alloc)
        seen[key] = (stats["route"], torch.from_numpy(out).is_pinned())
        return out

    monkeypatch.setattr(npz.NpzReader, "read", spy)
    torch.zeros(1, device=dev)  # the context exists, as after the warm-up
    with ref_loader.ReferenceLoader(ref, dev) as loader:
        loader.start(["F"], 5)
        cutoff = loader.cutoff()
        got = {g: loader.tables(g).sentinel_idx.cpu().numpy() for g in ("A", "F")}
    loaded = dict(seen)
    want, _ = npz.load_reference_npz(ref)
    for g in ("A", "F"):
        plain = ref_loader.plain_sentinel(want[g], g, cutoff, want["A"])
        assert np.array_equal(got[g], plain), g
    assert loaded["indexes"] == loaded["indexes.F"] == (route, True)
    assert not loaded["null_ratios"][1]  # read for the host


def test_scene_raster_on_the_card_equals_the_cpu_raster(dev):
    """A figure's raster is integer work on host-computed geometry, so the
    card's equals the CPU's bit for bit."""
    import types

    from wisecondorx_tpu_torch.output import plots
    from wisecondorx_tpu_torch.output.raster import render_scene

    rng = np.random.default_rng(0)
    sizes = rng.integers(200, 900, 24)
    results_r = [rng.normal(0.0, 0.1, n) * (rng.random(n) > 0.1) for n in sizes]
    results_w = [rng.uniform(0.2, 2.0, n) for n in sizes]
    bins = types.SimpleNamespace(results_r=results_r, results_w=results_w,
                                 ref_gender="M", gender="M", binsize=50_000,
                                 n_reads=8_000_000)
    segments = [[20, 0, int(sizes[20]), 12.0, 0.55], [4, 10, 90, -7.0, -0.8]]
    cfg = types.SimpleNamespace(zscore=5.0, beta=None)
    scenes = plots.build_scenes(bins, segments, cfg, plot_title="t")[:3]
    scenes.append(plots.yfrac_scene({
        "y_fractions": rng.uniform(0, 0.012, 60),
        "grid": np.linspace(0, 0.02, 5000),
        "density": np.exp(-((np.linspace(0, 0.02, 5000) - 0.01) / 0.002) ** 2)}))
    for scene in scenes:
        card = render_scene(scene, dev).cpu()
        assert torch.equal(card, render_scene(scene, torch.device("cpu"))), scene.name


def test_warmup_warms_every_visible_card_apart_from_the_counters(dev, monkeypatch):
    """newref's warm-up on every visible card: a context on each (one
    round trip per card), the kernel library loaded, no launch counted
    in LAUNCHES, and a kernel library that does not build fails it with
    nvcc's message."""
    from wisecondorx_tpu_torch import device as tdevice
    from wisecondorx_tpu_torch.ops import _build
    from wisecondorx_tpu_torch.utils import warmup

    monkeypatch.setattr(warmup, "_started", {})
    monkeypatch.setattr(tdevice, "_readback", {})
    devices = tdevice.resolve_devices("cuda")
    knn_cuda.reset_launch_counts()
    warmup.start_warmup(devices).result()
    assert knn_cuda.LAUNCHES == {"knn_bucket": 0, "knn_topk": 0}
    assert _build._lib is not None
    assert set(tdevice._readback) == set(devices)
    assert all(tdevice._readback[d].result() > 0 for d in devices)

    def no_nvcc():
        raise RuntimeError("nvcc failed: planted by the test")

    monkeypatch.setattr(warmup, "_started", {})
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed: planted"):
        warmup.start_warmup(devices[:1]).result()


def _same_or_nan(got, want):
    """Equal NaN and -inf positions, and bit for bit elsewhere (the
    kernel's IEEE operations on the same sums)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.nan_to_num(got).view(np.int64),
                                  np.nan_to_num(want).view(np.int64))


def _arc_rows(dev, n_pad, family="arc_rows", n_max=None):
    make = (chip_smoke.cbs_arc_rows if family == "arc_rows"
            else chip_smoke.cbs_adversarial_rows)
    w, wx, n = make(n_pad)
    if n_max is not None:  # every row at most n_max long
        n = np.minimum(n, n_max)
        cols = np.arange(n_pad)[None, :] < n[:, None]
        w, wx = np.where(cols, w, 0.0), np.where(cols, wx, 0.0)
    return [torch.as_tensor(a, device=dev) for a in (w, wx, n)]


@pytest.mark.parametrize("kmax", [0, 25])
@pytest.mark.parametrize("n_pad,mode", [
    (p, m) for p in (8, 32, 128, 2048) for m in ("exact", "thin", "short")
] + [(32768, "thin"), (32768, "short")])
def test_cbs_arc_max_equals_plain_version(dev, n_pad, mode, kmax):
    from wisecondorx_tpu_torch.ops import cbs

    rows = _arc_rows(dev, n_pad)
    lengths = cbs._lengths_tensor(n_pad, cbs.CBSConfig(kmax=kmax), mode, dev)
    cbs.reset_launch_counts()
    got = cbs.max_t_rows(*rows, lengths, 2, kmax)
    assert cbs.LAUNCHES["cbs_arc_max"] == 1
    want = cbs.max_t_rows_reference(*rows, lengths, 2, kmax)
    torch.cuda.synchronize()
    _same_or_nan(got, want)


@pytest.mark.parametrize("n_pad", [8, 32, 128, 2048])
def test_cbs_locate_equals_plain_version(dev, n_pad):
    from wisecondorx_tpu_torch.ops import cbs

    rows = _arc_rows(dev, n_pad)
    cbs.reset_launch_counts()
    got = cbs.locate_rows(*rows, 2)
    assert cbs.LAUNCHES["cbs_arc_argmax"] == 1
    want = cbs.locate_rows_reference(*rows, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_pad,n_max,mode", [
    (8, None, "exact"), (32, 32, "exact"), (128, 100, "exact"), (2048, 2048, "exact"),
    (2048, 2048, "thin"), (8192, 8192, "thin"), (32768, None, "thin"),
])
def test_cbs_arc_kernels_hold_on_adversarial_rows(dev, n_pad, n_max, mode):
    """chip_smoke.cbs_adversarial_rows (near-flat rows, exact ties, weights
    near 1e-300 and 1e150, values near 1e150 and 1e-300, a huge spike,
    zero-weight runs, absorbed weights): maxima bit-equal and (i*, L*)
    equal, with the sums cut to n_max (staged in shared memory up to
    n_pad 8,192, through L2 at 32,768) and the exact-arc counter on."""
    from wisecondorx_tpu_torch.ops import cbs

    rows = _arc_rows(dev, n_pad, "adversarial", n_max)
    lengths = cbs._lengths_tensor(n_pad, cbs.CBSConfig(), mode, dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    got = cbs.max_t_rows(*rows, lengths, 2, 25, n_max=n_max, exact_arcs=count)
    _same_or_nan(got, cbs.max_t_rows_reference(*rows, lengths, 2, 25))
    assert int(count) > 0
    if n_pad <= 8192:
        got = cbs.locate_rows(*rows, 2, n_max=n_max)
        for g, w in zip(got, cbs.locate_rows_reference(*rows, 2)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n_pad,n_true", [(8192, 8192), (32768, 16597)])
def test_cbs_arc_kernels_staged_and_through_l2(dev, n_pad, n_true):
    """A permutation round's shape on both paths: 64 permuted rows of a
    segment with a step, true size 8,192 at n_pad 8,192 (staged) and
    16,597 at 32,768 (read through L2): maxima bit-equal with the sums cut
    to the true size and uncut, (i*, L*) equal on the two observed rows,
    and far fewer arcs through the exact formula than there are arcs."""
    from wisecondorx_tpu_torch.ops import cbs

    rng = np.random.default_rng(n_true)
    x = rng.normal(0.0, 0.1, n_true)
    x[n_true // 3: n_true // 2] += 0.3
    w = rng.uniform(0.5, 1.5, n_true)
    rows = [(w, x)] + [(w[p], x[p]) for p in (rng.permutation(n_true)
                                             for _ in range(63))]
    w_all, wx_all, n = (torch.as_tensor(a, device=dev)
                        for a in chip_smoke._arc_row_tables(rows, n_pad))
    lengths = cbs._lengths_tensor(n_pad, cbs.CBSConfig(), "thin", dev)
    want = cbs.max_t_rows_reference(w_all, wx_all, n, lengths, 2, 25)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    for n_max in (n_true, None):
        _same_or_nan(cbs.max_t_rows(w_all, wx_all, n, lengths, 2, 25,
                                    n_max=n_max, exact_arcs=count), want)
    arcs = chip_smoke._arc_count(n.cpu().numpy(), lengths.cpu().numpy(), 2, 25)
    assert 0 < int(count) < 0.1 * 2 * arcs
    obs = [t[:2] for t in (w_all, wx_all, n)]
    got = cbs.locate_rows(*obs, 2, n_max=n_true)
    for g, v in zip(got, cbs.locate_rows_reference(*obs, 2)):
        assert torch.equal(g, v)


def test_cbs_arc_stage_bytes_match_the_library(dev):
    from wisecondorx_tpu_torch.ops import _build, cbs

    assert _build.load().wcx_cbs_arc_stage_bytes() == cbs.ARC_STAGE_BYTES


@pytest.mark.parametrize("rows,n_pad", [(1, 8), (37, 300), (1026, 8192)])
def test_cbs_keys_bit_equal_to_plain_version(dev, rows, n_pad):
    from wisecondorx_tpu_torch.ops import cbs

    rng = np.random.default_rng(rows)
    words = [torch.as_tensor(rng.integers(-2**40, 2**40, rows), device=dev)
             for _ in range(4)]
    n_rows = torch.as_tensor(rng.integers(0, n_pad + 1, rows), device=dev)
    for seed in (0, 2**33 + 5):
        key = cbs.prng_key(seed)
        cbs.reset_launch_counts()
        got = cbs.perm_keys(key, *words, n_rows, n_pad)
        assert cbs.LAUNCHES["cbs_keys"] == 1
        assert torch.equal(got, cbs.perm_keys_reference(key, *words, n_rows, n_pad))


def test_cbs_wrappers_reject_what_the_kernels_do_not_take(dev):
    from wisecondorx_tpu_torch.ops import cbs

    w, wx, n = (torch.as_tensor(a, device=dev) for a in chip_smoke.cbs_arc_rows(32))
    lengths = torch.arange(32, device=dev)
    with pytest.raises(TypeError):  # int64 lengths: the kernel takes int32
        cbs.max_t_rows(w, wx, n, lengths, 2, 25)
    with pytest.raises(TypeError):
        cbs.max_t_rows(w.float(), wx.float(), n, lengths.int(), 2, 25)
    with pytest.raises(ValueError):
        cbs.locate_rows(w, wx, n[:-1], 2)
    with pytest.raises(TypeError):
        cbs.perm_keys(cbs.prng_key(0), *([n.int()] * 4), n, 32)


def test_exec_cbs_kernels_equal_the_plain_route(dev, monkeypatch):
    """Whole CBS runs on the card (device permutation stream, perm and
    hybrid): the kernels' segments equal those of the plain versions run on
    the same CUDA tensors, and every kernel was launched."""
    from wisecondorx_tpu_torch.ops import cbs

    rng = np.random.default_rng(3)
    rs, ws = [], []
    for c in range(6):
        n = 3000 if c == 0 else int(rng.integers(100, 600))
        y = rng.normal(0, 0.1, n)
        y[n // 3: n // 2] += 0.6
        rs.append(y)
        ws.append(rng.uniform(0.5, 1.5, n))
    rs += [np.zeros(5)] * 17  # all-NA chromosomes: no CBS job
    ws += [np.ones(5)] * 17
    for p_method in ("perm", "hybrid"):
        cfg = cbs.CBSConfig(alpha=1e-2, nperm=300, seed=0, p_method=p_method)
        cbs.reset_launch_counts()
        got = cbs.exec_cbs(rs, ws, "F", 100000, cfg, dev)
        assert min(cbs.LAUNCHES.values()) > 0, cbs.LAUNCHES
        with monkeypatch.context() as m:
            m.setattr(cbs, "_on_card", lambda t: False)
            want = cbs.exec_cbs(rs, ws, "F", 100000, cfg, dev)
        assert got == want and len(got) > 6
