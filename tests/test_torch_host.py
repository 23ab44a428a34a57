"""The port's copies of the JAX package's host modules against their
originals, on the same numpy-seeded inputs.

The port imports nothing of ``wisecondorx_tpu``, so it keeps its own
``genome``, ``ops.mask``, ``ops.stats``, ``io.npz``, ``io.bam`` (with the
native reader sources), ``output.tables``, ``ref_qc`` and ``errors``.  Each
test below is one module, parametrised over its cases: equal layouts,
masks and statistics, ``.npz`` files written by one package and read by the
other (and byte-equal when both write), byte-equal BED tables, equal
reference-QC verdicts and log lines, and equal ``convert`` counts of a BAM
written by tests/bamtools.py.
"""

import logging
import types

import numpy as np
import pytest

from bamtools import bam_record, write_bam
from wisecondorx_tpu import errors as j_errors
from wisecondorx_tpu import genome as j_genome
from wisecondorx_tpu import ref_qc as j_ref_qc
from wisecondorx_tpu.io import bam as j_bam
from wisecondorx_tpu.io import npz as j_npz
from wisecondorx_tpu.ops import mask as j_mask
from wisecondorx_tpu.ops import stats as j_stats
from wisecondorx_tpu.output import tables as j_tables
from wisecondorx_tpu_torch import errors as t_errors
from wisecondorx_tpu_torch import genome as t_genome
from wisecondorx_tpu_torch import ref_qc as t_ref_qc
from wisecondorx_tpu_torch.io import bam as t_bam
from wisecondorx_tpu_torch.io import npz as t_npz
from wisecondorx_tpu_torch.ops import mask as t_mask
from wisecondorx_tpu_torch.ops import stats as t_stats
from wisecondorx_tpu_torch.output import tables as t_tables


def _sample(rng, lengths):
    return {str(c + 1): rng.integers(0, 50, n).astype(np.int32)
            for c, n in enumerate(lengths)}


# ---------------------------------------------------------------------------
# genome
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_genome_layouts_match_jax(seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(5, 40, 24)
    mask = rng.random(int(bins.sum())) < 0.8
    jl, tl = j_genome.GenomeLayout(bins), t_genome.GenomeLayout(bins)
    for name in ("n_chr", "total_bins"):
        assert getattr(jl, name) == getattr(tl, name)
    for name in ("chr_starts", "chr_ends", "bins_per_chr"):
        np.testing.assert_array_equal(getattr(jl, name), getattr(tl, name))
    np.testing.assert_array_equal(jl.chr_of_bin(), tl.chr_of_bin())
    np.testing.assert_array_equal(jl.truncated(22).bins_per_chr,
                                  tl.truncated(22).bins_per_chr)

    jm, tm = j_genome.MaskedLayout(jl, mask), t_genome.MaskedLayout(tl, mask)
    assert jm.n_masked == tm.n_masked
    for name in ("masked_bins_per_chr", "masked_bins_per_chr_cum",
                 "chr_of_masked_bin", "masked_chr_starts"):
        np.testing.assert_array_equal(getattr(jm, name), getattr(tm, name))
    k = 7
    idx = rng.integers(0, jm.n_masked - int(jm.masked_bins_per_chr.max()),
                       (jm.n_masked, k))
    np.testing.assert_array_equal(jm.neighbour_to_global(idx),
                                  tm.neighbour_to_global(idx))
    ct = int(jm.masked_chr_starts[22])
    np.testing.assert_array_equal(jm.neighbour_to_global(idx[ct:], ct),
                                  tm.neighbour_to_global(idx[ct:], ct))
    values = rng.standard_normal((jm.n_masked, 3))
    np.testing.assert_array_equal(jm.inflate(values), tm.inflate(values))
    full = rng.standard_normal(jl.total_bins)
    for a, b in zip(jm.split_by_chr(full), tm.split_by_chr(full)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t_genome.MaskedLayout(tl, mask[:-1])

    samples = [_sample(rng, rng.integers(5, 40, 24)) for _ in range(4)]
    (jmat, jlay), (tmat, tlay) = (j_genome.samples_to_matrix(samples),
                                  t_genome.samples_to_matrix(samples))
    np.testing.assert_array_equal(jmat, tmat)
    np.testing.assert_array_equal(jlay.bins_per_chr, tlay.bins_per_chr)
    assert t_genome.LAST_CHR == j_genome.LAST_CHR


# ---------------------------------------------------------------------------
# ops.mask and ops.stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,block", [(3, 32768), (4, 17)])
def test_masks_match_jax(seed, block):
    rng = np.random.default_rng(seed)
    matrix = rng.poisson(20, (300, 12)).astype(np.float64)
    matrix[rng.random(300) < 0.1] = 0.0  # empty bins
    matrix[:5] *= 0.01  # bins under the 5 % floor
    female = np.arange(12) % 2 == 0
    subsets = [None, female, ~female]
    got = t_mask.get_masks(matrix, subsets, block=block)
    want = j_mask.get_masks(matrix, subsets, block=block)
    for g, w, cols in zip(got, want, subsets):
        np.testing.assert_array_equal(g, w)
        sub = matrix if cols is None else matrix[:, cols]
        np.testing.assert_array_equal(g, j_mask.get_mask(sub))
    assert not got[0].all() and got[0].any()


def _results(rng, n_chr=4, n_null=6):
    lengths = rng.integers(10, 30, n_chr)
    r = [rng.normal(0, 0.1, n) for n in lengths]
    w = [rng.random(n) for n in lengths]
    nr = [rng.normal(0, 0.1, (n, n_null)) for n in lengths]
    for arr in r:
        arr[rng.random(len(arr)) < 0.2] = 0.0  # blanked bins
    return lengths, r, w, nr


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_stats_match_jax(case):
    rng = np.random.default_rng(5)
    lengths, r, w, nr = _results(rng)
    segs = [[c, 0, int(n) // 2, 0.05] for c, n in enumerate(lengths)]
    segs += [[c, int(n) // 2, int(n), -0.02] for c, n in enumerate(lengths)]
    if case == "degenerate":
        r[0][:] = 0.0  # no informative bin: "nan"
        nr[1][:] = np.nan  # no finite null: "nan"
        nr[2][:, :2] = np.inf  # some null samples not finite
    z_t = t_stats.get_z_score(segs, r, w, nr)
    z_j = j_stats.get_z_score(segs, r, w, nr)
    assert z_t == z_j
    if case == "degenerate":
        assert "nan" in z_t
    assert (t_stats.get_median_segment_variance(segs, r)
            == j_stats.get_median_segment_variance(segs, r))
    rows = [s[:3] + [z, s[3]] for s, z in zip(segs, z_t)]
    np.testing.assert_equal(t_stats.get_cpa(rows, 100000),
                            j_stats.get_cpa(rows, 100000))


# ---------------------------------------------------------------------------
# io.npz
# ---------------------------------------------------------------------------


def _passes(rng):
    passes = {}
    for gender, n_chr in (("A", 22), ("F", 23), ("M", 24)):
        bins = rng.integers(4, 12, 24)
        mask = rng.random(int(bins[:n_chr].sum())) < 0.9
        n = int(mask.sum())
        passes[gender] = {
            "binsize": 100000, "mask": mask, "bins_per_chr": bins[:n_chr],
            "masked_bins_per_chr": rng.integers(1, 5, n_chr),
            "masked_bins_per_chr_cum": np.cumsum(rng.integers(1, 5, n_chr)),
            "pca_components": rng.standard_normal((3, n)),
            "pca_mean": rng.standard_normal(n),
            "indexes": rng.integers(0, n, (n, 5)).astype(np.int32),
            "distances": rng.random((n, 5)),
            "null_ratios": rng.standard_normal((n, 4)),
            "wcx_weights": rng.random(n),
        }
    return passes


def _same_passes(got, want):
    assert got.keys() == want.keys()
    for gender in want:
        assert got[gender].keys() == want[gender].keys(), gender
        for key, w in want[gender].items():
            np.testing.assert_array_equal(got[gender][key], w, err_msg=key)


@pytest.mark.parametrize("case", [
    "sample_port_to_jax", "sample_jax_to_port", "reference_port_to_jax",
    "reference_jax_to_port", "writer_bytes", "scale_and_gender",
])
def test_npz_matches_jax(tmp_path, case):
    rng = np.random.default_rng(6)
    if case.startswith("sample"):
        sample = _sample(rng, rng.integers(5, 40, 24))
        quality = {"mapped": 100, "unmapped": 3}
        write, read = ((t_npz, j_npz) if case == "sample_port_to_jax"
                       else (j_npz, t_npz))
        path = str(tmp_path / "s.npz")
        write.save_sample_npz(path, 5000, sample, quality)
        got, binsize, q = read.load_sample_npz(path)
        assert binsize == 5000 and q == quality
        assert got.keys() == sample.keys()
        for key in sample:
            np.testing.assert_array_equal(got[key], sample[key])
    elif case.startswith("reference"):
        passes = _passes(rng)
        meta = dict(is_nipt=False, trained_cutoff=0.42)
        path = str(tmp_path / "r.npz")
        if case == "reference_port_to_jax":
            final = t_npz.flatten_reference(passes, **meta)
            t_npz._savez_fast(path, final)
            t_npz.verify_reference_npz(path, expected_keys=final.keys())
            read = j_npz
        else:
            j_npz.save_reference_npz(path, passes, **meta)
            read = t_npz
        got, got_meta = read.load_reference_npz(path)
        assert got_meta == dict(meta, has_female=True, has_male=True)
        want = {g: {k: v for k, v in p.items()} for g, p in passes.items()}
        _same_passes(got, want)
        if read is t_npz:
            with t_npz.NpzReader(path) as reader:
                small, _ = read.load_reference_small(reader)
        else:
            small, _ = read.load_reference_small(path)
        for gender in passes:
            assert "indexes" not in small[gender]
            np.testing.assert_array_equal(small[gender]["mask"],
                                          passes[gender]["mask"])
        tail = read.load_member_rows(path, "indexes.M", 3)
        np.testing.assert_array_equal(tail, passes["M"]["indexes"][3:])
    elif case == "writer_bytes":
        final = t_npz.flatten_reference(_passes(rng), is_nipt=True,
                                        trained_cutoff=0.3)
        t_npz._savez_fast(str(tmp_path / "t.npz"), final)
        j_npz._savez_fast(str(tmp_path / "j.npz"), final)
        assert ((tmp_path / "t.npz").read_bytes()
                == (tmp_path / "j.npz").read_bytes())
        with pytest.raises(KeyError):
            t_npz.flatten_reference({"A": {"mask": 1}}, is_nipt=False,
                                    trained_cutoff=0.0)
    else:
        sample = _sample(rng, rng.integers(5, 40, 24))
        for to in (None, 5000, 20000, 35000):
            got = t_npz.scale_sample(dict(sample), 5000, to)
            want = j_npz.scale_sample(dict(sample), 5000, to)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        with pytest.raises(t_npz.BinScalingError) as err:
            t_npz.scale_sample(sample, 5000, 7000)
        assert isinstance(err.value, t_errors.UserInputError)
        assert not isinstance(err.value, j_errors.UserInputError)
        for gender in ("F", "M"):
            got = t_npz.gender_correct(dict(sample), gender)
            want = j_npz.gender_correct(dict(sample), gender)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reference_npz_headers_match_jax(tmp_path, writer):
    """The predict warm-up's header peek: the small members and the
    indexes' shapes of each pass, equal to the JAX function's on a
    reference written by either package."""
    passes = _passes(np.random.default_rng(7))
    path = str(tmp_path / "r.npz")
    if writer == "port":
        t_npz._savez_fast(path, t_npz.flatten_reference(
            passes, is_nipt=False, trained_cutoff=0.42))
    else:
        j_npz.save_reference_npz(path, passes, is_nipt=False,
                                 trained_cutoff=0.42)
    got = t_npz.reference_npz_headers(path)
    want = j_npz.reference_npz_headers(path)
    assert got.keys() == want.keys() == passes.keys()
    for gender, entry in want.items():
        assert got[gender].keys() == entry.keys()
        assert got[gender]["indexes_shape"] == entry["indexes_shape"] \
            == passes[gender]["indexes"].shape
        for key in ("mask", "bins_per_chr", "masked_bins_per_chr_cum"):
            np.testing.assert_array_equal(got[gender][key], entry[key])
            assert got[gender][key].dtype == entry[key].dtype


# ---------------------------------------------------------------------------
# output.tables
# ---------------------------------------------------------------------------


def _bins(rng, dtype):
    lengths, r, w, nr = _results(rng, n_chr=24)
    z = [rng.normal(0, 3, len(x)) for x in r]
    for a, b in zip(z, r):
        a[b == 0] = 0.0
    return types.SimpleNamespace(
        results_r=[x.astype(dtype) for x in r],
        results_z=[x.astype(dtype) for x in z], results_w=w, results_nr=nr,
        ref_gender="M", gender="M", binsize=50000, n_reads=123456,
    ), lengths


@pytest.mark.parametrize("case,route", [
    pytest.param(case, route, id=case if route == "native" else
                 f"{case}-python")
    for route in ("native", "python")
    for case in ("zscore", "beta", "float32", "regions", "bad_regions")])
def test_tables_byte_equal_jax(tmp_path, monkeypatch, case, route):
    """Each table byte-equal to the JAX package's, with ``_bins.bed``'s
    rows from the native formatter and from the Python loop."""
    if route == "python":
        monkeypatch.setattr(t_tables, "_formatter", False)
    else:
        assert t_tables.load_formatter() is not None
    t_tables.reset_bin_row_counts()
    rng = np.random.default_rng(7)
    bins, lengths = _bins(rng, np.float32 if case == "float32" else np.float64)
    segments = []
    for c, n in enumerate(lengths):
        for s, e in ((0, int(n) // 2), (int(n) // 2, int(n) - 1)):
            z = float(rng.normal(0, 8))
            segments.append([c, s, e, "nan" if c == 3 else z,
                             float(rng.normal(0, 0.3))])
    cfg = types.SimpleNamespace(beta=0.3 if case == "beta" else None,
                                zscore=5.0)
    regions = None
    if case in ("regions", "bad_regions"):
        regions = str(tmp_path / "regions.bed")
        with open(regions, "w") as f:
            f.write("chr1\t0\t400000\tfirst\n2\t100000\t900000\tsecond\n"
                    "chrX\t0\t200000\tx\nY\t50000\t150000\ty\n"
                    "chr5\t900000\t100000\tbackwards\n\n")
            if case == "bad_regions":
                f.write("chrZ\t1\t2\tbad\n")
    outs = {}
    for name, mod in (("port", t_tables), ("jax", j_tables)):
        outs[name] = str(tmp_path / name)
        if case == "bad_regions":
            errors = t_errors if name == "port" else j_errors
            with pytest.raises(errors.BedParseError, match=":7:"):
                mod.generate_output_tables(outs[name], bins, segments, cfg,
                                           regions=regions)
        else:
            mod.generate_output_tables(outs[name], bins, segments, cfg,
                                       regions=regions)
    suffixes = ["_bins.bed", "_segments.bed", "_aberrations.bed",
                "_statistics.txt"]
    if case == "regions":
        suffixes.append("_regions.bed")
    if case == "bad_regions":
        suffixes = ["_bins.bed"]
    for suffix in suffixes:
        got = open(outs["port"] + suffix, "rb").read()
        assert got == open(outs["jax"] + suffix, "rb").read(), suffix
        assert got
    other = "python" if route == "native" else "native"
    assert t_tables.BIN_ROWS == {route: int(sum(lengths)), other: 0}


# ---------------------------------------------------------------------------
# ref_qc
# ---------------------------------------------------------------------------


def _qc_reference(rng, case):
    ref = {"binsize": np.array(100000)}
    suffixes = {"healthy": [""], "shallow": [".F"], "wide": [".F"],
                "male": [".F", ".M"], "empty": []}[case]
    for suffix in suffixes:
        n, k = 120, (100 if case == "shallow" else 200)
        dist = rng.gamma(4.0, 0.1, (n, k))
        if case == "wide":
            dist *= rng.gamma(0.3, 40.0, (n, 1))
        if suffix == ".M":
            dist[100:] *= 30.0  # a heavy chrY
        ref["bins_per_chr" + suffix] = np.full(24, 5)
        ref["indexes" + suffix] = np.zeros((n, k), np.int32)
        ref["distances" + suffix] = dist
        cum = np.linspace(4, 100, 24).astype(int)
        cum[22], cum[23] = 100, 120
        ref["masked_bins_per_chr_cum" + suffix] = cum
    return ref


@pytest.mark.parametrize("case", ["healthy", "shallow", "wide", "male",
                                  "empty"])
def test_ref_qc_matches_jax(caplog, case):
    ref = _qc_reference(np.random.default_rng(8), case)
    verdicts, logs = [], []
    for mod in (t_ref_qc, j_ref_qc):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            verdicts.append(mod.qc_reference_arrays(ref, label="ref"))
        logs.append([(r.levelno, r.getMessage()) for r in caplog.records])
    assert verdicts[0] == verdicts[1]
    assert logs[0] == logs[1] and logs[0]
    want = {"healthy": t_ref_qc.PASS, "shallow": t_ref_qc.WARN,
            "empty": t_ref_qc.FAIL}
    if case in want:
        assert verdicts[0] == want[case]


# ---------------------------------------------------------------------------
# io.bam
# ---------------------------------------------------------------------------

REFS = [("chr1", 40000), ("chr2", 20000), ("chrX", 15000), ("chrY", 6000),
        ("chrM", 1000), ("GL000220.1", 500)]


@pytest.mark.parametrize("case", ["dedup", "normdup", "bad_extension",
                                  "corrupt"])
def test_convert_matches_jax(tmp_path, case):
    rng = np.random.default_rng(9)
    records = []
    for _ in range(400):
        ref = int(rng.integers(0, len(REFS)))
        pos = int(rng.integers(0, REFS[ref][1]))
        flag = int(rng.choice([0, 0x1 | 0x2, 0x1, 0x4]))
        mate = pos + int(rng.integers(-300, 300)) if flag & 0x1 else -1
        records.append(bam_record(ref, pos, int(rng.choice([0, 10, 60])), flag,
                                  ref if flag & 0x1 else -1, mate))
        if rng.random() < 0.1:
            records.append(records[-1])
    path = str(tmp_path / "reads.bam")
    write_bam(path, REFS, records)
    if case in ("bad_extension", "corrupt"):
        if case == "corrupt":
            with open(path, "wb") as f:
                f.write(b"not a BGZF stream")
        else:
            path = str(tmp_path / "reads.sam")
        for mod in (t_bam, j_bam):
            with pytest.raises(mod.ConvertError):
                mod.convert_reads(path, 5000)
        assert issubclass(t_bam.ConvertError, t_errors.UserInputError)
        return
    normdup = case == "normdup"
    got_bins, got_qc = t_bam.convert_reads(path, 5000, normdup=normdup)
    want_bins, want_qc = j_bam.convert_reads(path, 5000, normdup=normdup)
    assert got_qc == want_qc
    assert got_bins.keys() == want_bins.keys()
    for key, w in want_bins.items():
        if w is None:
            assert got_bins[key] is None
        else:
            np.testing.assert_array_equal(got_bins[key], w)
    assert got_qc["post_retro"] > 50
