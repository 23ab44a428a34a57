"""The native ``_bins.bed`` row formatter (``native/tablefmt.cpp``, loaded
by ``wisecondorx_tpu_torch.output.tables``) against Python's own strings.

* Each cell equals ``str(numpy.float32(x))`` for float32 values and
  ``repr(float(x))`` for float64 values ("nan" for 0), on edge values and
  their float neighbours, 10^6 random bit patterns and normals at the
  cells' scales, with the float32 bounds of positional notation found in
  the numpy installed;
* whole ``_bins.bed`` files from the native route and the Python loop are
  byte-equal, an empty chromosome included;
* ``BIN_ROWS`` counts the rows of each route;
* a formatter that does not build or load leaves the Python loop, after
  one warning.

``tests/test_torch_host.py::test_tables_byte_equal_jax`` holds both routes
to the JAX package's writer.
"""

import logging
import subprocess
import types

import numpy as np
import pytest

from wisecondorx_tpu_torch.output import tables

DTYPES = {"float32": np.float32, "float64": np.float64}
BITS = {"float32": np.uint32, "float64": np.uint64}


@pytest.fixture
def fmt():
    lib = tables.load_formatter()
    assert lib is not None, "the native formatter did not build"
    return lib


def _native_cells(fmt, values):
    """The ratio and z-score cells the formatter prints for ``values``
    (z-scores reversed), one row a value."""
    r = np.ascontiguousarray(values)
    z = np.ascontiguousarray(values[::-1])
    n = len(r)
    buf = np.empty(n * fmt.wcx_bins_row_max(1), np.uint8)
    size = fmt.wcx_format_bins(r.ctypes.data, z.ctypes.data,
                               r.dtype.itemsize * 8, n, 1, b"1",
                               buf.ctypes.data, len(buf),
                               *tables.float32_positional_range())
    assert size >= 0
    rows = [line.split("\t") for line in
            bytes(buf[:size]).decode("ascii").split("\n")[:-1]]
    assert len(rows) == n
    return [row[4] for row in rows], [row[5] for row in rows]


def _python_cells(values):
    if values.dtype == np.float32:
        text = [str(x) for x in list(values)]  # numpy scalars
    else:
        text = [repr(x) for x in values.tolist()]
    return ["nan" if x == 0 else t for x, t in zip(values, text)]


def _edges(dtype):
    info = np.finfo(dtype)
    base = np.array([
        0.0, 1e-4, 1e16, 1e-5, 1e15, 1e17, 1e-3, 1.0, 2.0, 10.0, 0.1, 0.5,
        123456789.0, 3e20, 1e7, 1e8, 9.5, 1e-45, 1e-300, 1e300,
        info.max, info.tiny, info.smallest_subnormal,
        info.smallest_subnormal * 3, info.tiny / 2,
        *tables.float32_positional_range(),
    ], dtype=np.float64)
    with np.errstate(over="ignore", under="ignore"):
        base = base.astype(dtype)
        near = [np.nextafter(base, dtype(np.inf)),
                np.nextafter(base, dtype(-np.inf))]
    integral = np.arange(-2000, 2001, dtype=np.float64).astype(dtype)
    powers = np.concatenate([10.0 ** np.arange(-8, 21),
                             2.0 ** np.arange(-30, 60)]).astype(dtype)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0], dtype)
    vals = np.concatenate([base, *near, integral, powers, special])
    return np.concatenate([vals, -vals])


@pytest.mark.parametrize("values", ["edges", "random_bits", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cells_equal_python_strings(fmt, dtype, values):
    rng = np.random.default_rng(16)
    if values == "edges":
        arr = _edges(DTYPES[dtype])
    elif values == "random_bits":
        bits = BITS[dtype]
        arr = rng.integers(0, np.iinfo(bits).max, 10**6, dtype=bits,
                           endpoint=True).view(DTYPES[dtype])
    else:
        arr = np.concatenate([rng.normal(0, 0.1, 100_000),
                              rng.normal(0, 3, 100_000)]).astype(DTYPES[dtype])
    got_r, got_z = _native_cells(fmt, arr)
    want = _python_cells(arr)
    bad = [(repr(x), g, w) for x, g, w in zip(arr, got_r, want) if g != w]
    assert not bad, bad[:10]
    assert got_z == want[::-1]


def test_float32_positional_range_is_numpys():
    """The bounds print in exponent form, the float32 values just inside
    them positionally, and 1e-4 and 1 lie inside (numpy 2.0 puts the
    upper bound at 1e16, numpy 2.3 at 1e6)."""
    low, high = tables.float32_positional_range()
    f32 = np.float32
    inside = [np.nextafter(f32(low), f32(1)), np.nextafter(f32(high), f32(1))]
    assert "e" in str(f32(low)) and "e" in str(f32(high))
    assert all("e" not in str(x) for x in inside)
    assert low < 1e-4 < 1.0 < high


def _bins(dtype, rng):
    lengths = [int(n) for n in rng.integers(0, 400, 24)]
    lengths[5] = 0  # an empty chromosome
    r = [rng.normal(0, 0.1, n).astype(dtype) for n in lengths]
    z = [rng.normal(0, 3, n).astype(dtype) for n in lengths]
    for a, b in zip(r, z):
        a[rng.random(len(a)) < 0.2] = 0.0
        b[a == 0] = 0.0
        if len(a) > 8:
            a[:4] = [np.nan, np.inf, -np.inf, -0.0]
            b[4:8] = [1e-4, 1e16, -1e-5, 123456789.0]
    return types.SimpleNamespace(results_r=r, results_z=z, binsize=100000)


def _write(tmp_path, name, bins):
    tables._generate_bins_bed(str(tmp_path / name), bins)
    return (tmp_path / f"{name}_bins.bed").read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_files_equal_between_routes(fmt, tmp_path, monkeypatch, dtype):
    bins = _bins(DTYPES[dtype], np.random.default_rng(3))
    tables.reset_bin_row_counts()
    native = _write(tmp_path, "native", bins)
    monkeypatch.setattr(tables, "_formatter", False)
    python = _write(tmp_path, "python", bins)
    assert native == python
    assert native.startswith(b"chr\tstart\tend\tid\tratio\tzscore\n")
    assert native.endswith(b"\n") and b"\n\n" not in native
    assert b"\n6\t" not in native
    n = sum(len(x) for x in bins.results_r)
    assert native.count(b"\n") == n + 1
    assert tables.BIN_ROWS == {"native": n, "python": n}


def test_bin_rows_count_each_route(fmt, tmp_path):
    """float32 and float64 arrays take the native route; other dtypes, and
    ratios and z-scores of different dtypes, the Python loop."""
    rng = np.random.default_rng(4)
    bins = _bins(np.float32, rng)
    bins.results_r[0] = bins.results_r[0].astype(np.float64)
    bins.results_r[1] = np.arange(len(bins.results_r[1])) % 3
    bins.results_z[1] = bins.results_r[1] - 1
    bins.results_r[2] = list(bins.results_r[2].astype(np.float64))
    bins.results_z[2] = bins.results_z[2].astype(np.float64)
    lengths = [len(x) for x in bins.results_r]
    tables.reset_bin_row_counts()
    _write(tmp_path, "mixed", bins)
    assert tables.BIN_ROWS == {"native": sum(lengths) - lengths[0]
                               - lengths[1], "python": lengths[0] + lengths[1]}


@pytest.mark.parametrize("fault", ["build", "load"])
def test_fallback_when_the_formatter_fails(fmt, tmp_path, monkeypatch,
                                           caplog, fault):
    bins = _bins(np.float32, np.random.default_rng(5))
    want = _write(tmp_path, "native", bins)

    def build(stem, sources, libs=()):
        if fault == "build":
            raise subprocess.CalledProcessError(1, ["g++"])
        not_a_library = tmp_path / "libnot.so"
        not_a_library.write_bytes(b"not an ELF file")
        return not_a_library

    monkeypatch.setattr(tables, "_formatter", None)
    monkeypatch.setattr(tables, "build_library", build)
    tables.reset_bin_row_counts()
    with caplog.at_level(logging.WARNING):
        assert _write(tmp_path, "first", bins) == want
        assert _write(tmp_path, "second", bins) == want
    warnings = [r for r in caplog.records if "formatter" in r.getMessage()]
    assert len(warnings) == 1
    n = sum(len(x) for x in bins.results_r)
    assert tables.BIN_ROWS == {"native": 0, "python": 2 * n}
