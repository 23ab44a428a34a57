"""The native null-sum pass of the segment z-score (``native/nullsums.cpp``,
loaded by ``wisecondorx_tpu_torch.ops.stats``) against its numpy version.

* Every z of ``get_z_score`` is the same on both routes by ``repr``
  ("nan" included), at both benchmark cells' shapes (24 whole chromosomes
  and CBS-like segments), at null widths 1-8, 16 and 100, with NaN and
  +-inf nulls, a chromosome whose nulls are all NaN, one whose ratios are
  all 0, empty and reversed intervals, the chromosome rows' ``e = len - 1``,
  products of -0.0, zero, negative, infinite and NaN weights, float32 and
  float64 ratios and list inputs; the sums themselves are bit-equal;
* the tables a sample's z-scores reach (``_segments.bed``,
  ``_aberrations.bed``, ``_statistics.txt``) are byte-equal between routes;
* ``Z_ROWS`` counts the rows of each route;
* a pass that does not build or load leaves numpy, after one warning;
* numpy sums a table's axis 0 row after row at exactly the widths
  ``row_ordered`` gives the native pass.

``tests/test_torch_host.py::test_stats_match_jax`` holds the native route
to the JAX package's z-scores.  No JAX here: the file also runs on the card
(``PYTHONPATH=tests python -m pytest --noconftest``).
"""

import logging
import subprocess
import types

import numpy as np
import pytest

from wisecondorx_tpu_torch.ops import stats
from wisecondorx_tpu_torch.output import tables

#: (bins, chromosomes) of the two predict cells: NIPT 100 kb, CNV 50 kb.
SHAPES = {"nipt100": 30830, "cnv50": 61660}


@pytest.fixture
def lib():
    lib = stats.load_null_sums()
    assert lib is not None, "the native null-sum pass did not build"
    return lib


def _sample(rng, n_bins, width=100, n_chr=24, r_dtype=np.float32):
    """Per-chromosome ratios, weights and views of one C-contiguous
    ``[n_bins, width]`` null table, as ``predict.postprocess`` leaves them:
    1 % NaN and 0.1 % +-inf nulls, 5 % blanked ratios."""
    edges = np.linspace(0, n_bins, n_chr + 1).astype(int)
    nr = rng.normal(0, 0.1, (n_bins, width))
    nr[rng.random(nr.shape) < 0.01] = np.nan
    nr[rng.random(nr.shape) < 0.0005] = np.inf
    nr[rng.random(nr.shape) < 0.0005] = -np.inf
    r = rng.normal(0, 0.1, n_bins).astype(r_dtype)
    r[rng.random(n_bins) < 0.05] = 0
    w = rng.random(n_bins) * 2
    cut = list(zip(edges[:-1], edges[1:]))
    return ([r[a:b] for a, b in cut], [w[a:b] for a, b in cut],
            [nr[a:b] for a, b in cut])


def _chromosome_rows(r):
    """The statistics file's rows: whole chromosomes, ``e = len - 1``."""
    return [[c, 0, len(x) - 1, 0.01 * c] for c, x in enumerate(r)]


def _segment_rows(rng, r, per_chr=3):
    """CBS-like segments: each chromosome cut at random points."""
    rows = []
    for c, x in enumerate(r):
        n = len(x)
        cuts = np.sort(rng.choice(np.arange(1, n), per_chr - 1,
                                  replace=False)) if n > per_chr else []
        bounds = [0, *map(int, cuts), n]
        rows += [[c, bounds[k], bounds[k + 1], float(rng.normal(0, 0.2))]
                 for k in range(len(bounds) - 1)]
    return rows


def _z_text(rows, r, w, nr):
    """``get_z_score``'s values as ``repr`` strings, or the error it
    raises: a null of one column has a standard deviation of 0, by which
    the z-score divides."""
    try:
        return [repr(z) for z in stats.get_z_score(rows, r, w, nr)]
    except ZeroDivisionError as exc:
        return repr(exc)


def _routes(monkeypatch, rows, r, w, nr):
    """(native, numpy) z-scores as ``repr`` strings."""
    native = _z_text(rows, r, w, nr)
    with monkeypatch.context() as m:
        m.setattr(stats, "_null_sums", False)
        plain = _z_text(rows, r, w, nr)
    return native, plain


def _assert_sums_bit_equal(rows, r, w, nr):
    """The native pass's sums against numpy's, bit for bit, on every row
    the native pass takes."""
    native = stats._native_null_sums(rows, r, w, nr)
    assert native
    for i, (num, den, informative) in native.items():
        c, s, e, _ = rows[i]
        want = stats._numpy_null_sums(r[c][s:e], w[c][s:e], nr[c][s:e])
        np.testing.assert_array_equal(num.view(np.uint64),
                                      want[0].view(np.uint64))
        np.testing.assert_array_equal(den.view(np.uint64),
                                      want[1].view(np.uint64))
        assert informative == want[2]


@pytest.mark.parametrize("kind", ["chromosomes", "segments"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cell_shapes_equal_between_routes(lib, monkeypatch, shape, kind):
    rng = np.random.default_rng(11)
    r, w, nr = _sample(rng, SHAPES[shape])
    rows = (_chromosome_rows(r) if kind == "chromosomes"
            else _segment_rows(rng, r))
    stats.reset_z_row_counts()
    native, plain = _routes(monkeypatch, rows, r, w, nr)
    assert native == plain
    assert all(z != "nan" for z in native)
    n = sum(min(e, len(r[c])) - s for c, s, e, _ in rows)
    assert stats.Z_ROWS == {"native": n, "numpy": n}
    _assert_sums_bit_equal(rows, r, w, nr)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6, 7, 8, 16, 100])
def test_widths_equal_between_routes(lib, monkeypatch, width):
    rng = np.random.default_rng(100 + width)
    r, w, nr = _sample(rng, 4000, width=width, n_chr=6)
    rows = _chromosome_rows(r) + _segment_rows(rng, r, per_chr=5)
    stats.reset_z_row_counts()
    native, plain = _routes(monkeypatch, rows, r, w, nr)
    assert native == plain
    if not stats.row_ordered(width):
        # One null column: both routes divide by a deviation of 0.
        assert native == repr(ZeroDivisionError("float division by zero"))
        assert stats.Z_ROWS["native"] == 0 < stats.Z_ROWS["numpy"]
        return
    assert isinstance(native, list)
    n = sum(min(e, len(r[c])) - s for c, s, e, _ in rows)
    assert stats.Z_ROWS == {"native": n, "numpy": n}
    _assert_sums_bit_equal(rows, r, w, nr)


def _edge_sample(rng, r_dtype):
    r, w, nr = _sample(rng, 1200, width=9, n_chr=8, r_dtype=r_dtype)
    nr[0][:] = np.nan  # no finite null: "nan"
    r[1][:] = 0  # no informative bin: "nan"
    nr[2][:, :3] = np.inf  # some null columns never finite
    nr[2][::7, 5] = -np.inf
    nr[3][:, :4] = -0.0  # columns of -0.0 products: numpy starts at +0.0
    nr[4][:, 2] = -nr[4][:, 2] * 0  # one column of -0.0 and +0.0
    w[5][::3] = 0.0  # zero weights: products of 0 and -0
    w[5][1::3] *= -1  # negative weights: w * 0 is -0.0
    w[6][::11] = np.inf  # inf * 0 is NaN in the weights' sum
    w[7][::13] = np.nan
    r[7][::5] = np.nan  # NaN ratios count as informative
    return r, w, nr


def _edge_rows(r):
    n = [len(x) for x in r]
    rows = _chromosome_rows(r)
    rows += [[c, 0, n[c], 0.5] for c in range(len(r))]
    rows += [
        [0, 5, 5, 0.1], [2, 9, 3, 0.1],  # e <= s: empty
        [2, 10, 11, 0.1], [3, 0, 40, 0.0], [4, 0, 40, -0.0],
        [5, 3, 60, 0.2], [6, 0, n[6] + 50, 0.3],  # e past the end
        [6, -40, -2, 0.3], [7, -10, n[7], 0.0],  # negative bounds
        [1, 0, n[1], 1.0],
    ]
    return rows


@pytest.mark.parametrize("r_dtype", [np.float32, np.float64])
def test_edge_cases_equal_between_routes(lib, monkeypatch, r_dtype):
    rng = np.random.default_rng(21)
    r, w, nr = _edge_sample(rng, r_dtype)
    rows = _edge_rows(r)
    stats.reset_z_row_counts()
    with np.errstate(invalid="ignore", over="ignore"):
        native, plain = _routes(monkeypatch, rows, r, w, nr)
        _assert_sums_bit_equal(rows, r, w, nr)
    assert native == plain
    assert native[0] == native[1] == repr("nan")
    assert stats.Z_ROWS["native"] == stats.Z_ROWS["numpy"] > 0


def test_list_inputs_equal_between_routes(lib, monkeypatch):
    rng = np.random.default_rng(31)
    r, w, nr = _edge_sample(rng, np.float64)
    rows = _edge_rows(r)
    as_lists = ([x.tolist() for x in r], [x.tolist() for x in w],
                [x.tolist() for x in nr])
    stats.reset_z_row_counts()
    with np.errstate(invalid="ignore", over="ignore"):
        native, plain = _routes(monkeypatch, rows, *as_lists)
        want, _ = _routes(monkeypatch, rows, r, w, nr)
    assert native == plain == want
    assert stats.Z_ROWS["native"] > 0


def test_z_rows_count_each_route(lib):
    """float64 null tables contiguous along a width above 1 take the
    native pass, a negative row stride too; other dtypes, strided columns
    and mismatched lengths, numpy (width 1:
    :func:`test_widths_equal_between_routes`)."""
    rng = np.random.default_rng(41)
    r, w, nr = _sample(rng, 2400, width=6, n_chr=8)
    nr[0] = nr[0].astype(np.float32)
    nr[1] = (np.nan_to_num(nr[1], posinf=0, neginf=0) * 1e3).astype(int)
    nr[2] = np.asfortranarray(nr[2])
    r[3] = r[3][:-1]  # numpy raises for it: left out of the rows below
    nr[4] = nr[4][::-1]  # negative row stride: native
    rows = _chromosome_rows(r)
    del rows[3]
    lengths = [len(x) - 1 for x in r]
    stats.reset_z_row_counts()
    stats.get_z_score(rows, r, w, nr)
    numpy_rows = lengths[0] + lengths[1] + lengths[2]
    assert stats.Z_ROWS == {
        "numpy": numpy_rows,
        "native": sum(lengths) - lengths[3] - numpy_rows,
    }
    with pytest.raises(IndexError):
        stats.get_z_score([[3, 0, len(nr[3]), 0.0]], r, w, nr)


@pytest.mark.parametrize("fault", ["build", "load"])
def test_fallback_when_the_pass_fails(lib, tmp_path, monkeypatch, caplog,
                                      fault):
    rng = np.random.default_rng(51)
    r, w, nr = _sample(rng, 3000, width=12, n_chr=6)
    rows = _chromosome_rows(r) + _segment_rows(rng, r)
    want = [repr(z) for z in stats.get_z_score(rows, r, w, nr)]

    def build(stem, sources, libs=()):
        if fault == "build":
            raise subprocess.CalledProcessError(1, ["g++"])
        not_a_library = tmp_path / "libnot.so"
        not_a_library.write_bytes(b"not an ELF file")
        return not_a_library

    monkeypatch.setattr(stats, "_null_sums", None)
    monkeypatch.setattr(stats, "build_library", build)
    stats.reset_z_row_counts()
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            assert [repr(z) for z in stats.get_z_score(rows, r, w, nr)] \
                == want
    warnings = [rec for rec in caplog.records
                if "z-score sums" in rec.getMessage()]
    assert len(warnings) == 1
    n = sum(min(e, len(r[c])) - s for c, s, e, _ in rows)
    assert stats.Z_ROWS == {"native": 0, "numpy": 2 * n}


def test_row_ordered_is_numpys_reduction_order():
    """At each width, numpy's axis-0 sum of a C-contiguous float64 table
    equals the row-after-row sum for every row count tried exactly when
    ``row_ordered`` admits the width (a shape-only rule)."""
    rng = np.random.default_rng(61)
    for width in [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 100, 128]:
        ordered = True
        for rows in [1, 2, 9, 17, 130, 1000, 5000]:
            x = rng.standard_normal((rows, width))
            x *= 10.0 ** rng.integers(-8, 9, x.shape)
            acc = np.zeros(width)
            for row in x:
                acc = acc + row
            got = np.sum(x, axis=0)
            ordered &= np.array_equal(got.view(np.uint64),
                                      acc.view(np.uint64))
        assert ordered == stats.row_ordered(width), width


def _bins(r, w, nr, rng):
    z = [rng.normal(0, 3, len(x)).astype(x.dtype) for x in r]
    return types.SimpleNamespace(
        results_r=r, results_z=z, results_w=w, results_nr=nr,
        ref_gender="F", gender="F", binsize=100000, n_reads=4567890,
    )


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tables_byte_equal_between_routes(lib, tmp_path, monkeypatch, shape):
    """``_segments.bed``, ``_aberrations.bed`` and ``_statistics.txt`` from
    z-scores of either route, byte for byte, with ``_bins.bed`` too."""
    rng = np.random.default_rng(71)
    r, w, nr = _sample(rng, SHAPES[shape])
    r[5][:] = 0  # a chromosome without informative bins: "nan"
    seg_rows = _segment_rows(rng, r)
    bins = _bins(r, w, nr, rng)
    cfg = types.SimpleNamespace(beta=None, zscore=0.5)
    files = {}
    for route in ("native", "numpy"):
        with monkeypatch.context() as m:
            if route == "numpy":
                m.setattr(stats, "_null_sums", False)
            stats.reset_z_row_counts()
            zs = stats.get_z_score(seg_rows, r, w, nr)
            segments = [[c, s, e, z, ratio]
                        for (c, s, e, ratio), z in zip(seg_rows, zs)]
            outid = str(tmp_path / route)
            tables.generate_output_tables(outid, bins, segments, cfg)
            assert stats.Z_ROWS[route] > 0
            assert stats.Z_ROWS["numpy" if route == "native"
                                else "native"] == 0
        files[route] = {
            suffix: open(outid + suffix, "rb").read()
            for suffix in ("_bins.bed", "_segments.bed", "_aberrations.bed",
                           "_statistics.txt")
        }
    for suffix, got in files["native"].items():
        assert got == files["numpy"][suffix], suffix
    assert b"\tgain\n" in files["native"]["_aberrations.bed"]
    assert b"\tnan\n" in files["native"]["_segments.bed"]
