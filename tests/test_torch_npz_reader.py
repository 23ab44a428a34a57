"""The port's member reader (``io/npz.py:NpzReader``) against
``np.load(path)[key][row_start:]``, array for array, on every route:

* ``stored``: a stored member read by byte range in slices, whole (its
  CRC-32 combined from the slices') and from a row on;
* ``pieces``: a member ``_savez_fast`` deflated in 3 pieces joined at full
  flushes, inflated concurrently, whole and from a row on;
* ``serial``: a deflated member of one piece, a member of
  ``np.savez_compressed`` (no full flushes), and a split given one false
  candidate offset, which falls back: each left to ``np.load``;
* ``numpy``: Fortran-order and object arrays, left to ``np.load``;
* a flipped payload byte raises what ``np.load`` raises;

with ``MEMBER_READS``' counts by route, one reader shared by many
threads, ``crc32_combine`` against ``zlib.crc32``, and the loader's
``predict.load.<member>`` spans carrying the read's ``route``, ``pieces``
and ``serial_bytes``."""

import sys
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from torch_parity import CPU
from wisecondorx_tpu_torch.io import npz as t_npz
from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader
from wisecondorx_tpu_torch.utils import log as tlog

#: Rows of the big table: 19.2 MB of int32, over two 8 MiB pieces.
ROWS, K = 16_000, 300


def _table(seed=0, rows=ROWS):
    """A neighbour-index-like int32 table: deflate saves about a third."""
    rng = np.random.default_rng(seed)
    base = np.arange(rows, dtype=np.int64)[:, None]
    idx = np.clip(base + rng.integers(-5000, 5000, (rows, K)), 0, rows - 1)
    return np.sort(idx, axis=1).astype(np.int32)


def _write(path, arrays, monkeypatch, mode):
    """``_savez_fast`` with ``WCX_NPZ_COMPRESS=mode`` for the writer only."""
    with monkeypatch.context() as m:
        m.setenv("WCX_NPZ_COMPRESS", mode)
        t_npz._savez_fast(path, arrays)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("npz_reader")
    arrays = {"indexes": _table(), "small": _table(1, rows=1000),
              "nulls": np.random.default_rng(2).standard_normal((7000, 100)),
              "flag": np.array(True), "cutoff": np.array(0.25)}
    out = {}
    for mode in ("never", "always"):
        with pytest.MonkeyPatch.context() as m:
            out[mode] = _write(str(tmp / f"{mode}.npz"), arrays, m, mode)
    out["numpy"] = str(tmp / "numpy.npz")
    np.savez_compressed(out["numpy"], **arrays)
    out["arrays"] = arrays
    return out


def _read(path, key, row_start=0):
    """(array, stats, MEMBER_READS after) of one read by a fresh reader."""
    t_npz.reset_member_reads()
    stats = {}
    with t_npz.NpzReader(path) as reader:
        got = reader.read(key, row_start, stats)
    return got, stats, {r: dict(c) for r, c in t_npz.MEMBER_READS.items()}


def _check(got, path, key, row_start):
    want = np.load(path)[key][row_start:] if row_start else np.load(path)[key]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable


def _info(path, key):
    with zipfile.ZipFile(path) as zf:
        return zf.getinfo(f"{key}.npy")


def _only(reads, route, nbytes):
    """MEMBER_READS counted one member of ``nbytes`` on ``route`` alone."""
    for r, counts in reads.items():
        want = {"members": 1, "bytes": nbytes} if r == route else {
            "members": 0, "bytes": 0}
        assert counts == want, (r, counts)


@pytest.mark.parametrize("key", ["indexes", "nulls", "small", "flag", "cutoff"])
@pytest.mark.parametrize("row_start", [0, 1, 4321])
def test_stored_members_read_by_range(files, key, row_start):
    path = files["never"]
    info = _info(path, key)
    assert info.compress_type == zipfile.ZIP_STORED
    row_start = row_start if files["arrays"][key].ndim else 0
    got, stats, reads = _read(path, key, row_start)
    _check(got, path, key, row_start)
    assert (stats["route"], stats["pieces"], stats["serial_bytes"]) == ("stored", 0, 0)
    arr = files["arrays"][key]
    header = info.file_size - arr.nbytes
    rows = max(len(arr) - row_start, 0) if arr.ndim else 1
    nbytes = (info.compress_size if not row_start
              else header + rows * arr.nbytes // len(arr))
    assert stats["bytes"] == nbytes
    _only(reads, "stored", nbytes)


@pytest.mark.parametrize("row_start", [0, 9000])
def test_deflated_member_inflated_in_pieces(files, row_start):
    path = files["always"]
    info = _info(path, "indexes")
    assert info.compress_type == zipfile.ZIP_DEFLATED
    with open(path, "rb") as f:
        assert f.read().count(b"\x00\x00\xff\xff") >= 2  # the writer's flushes
    got, stats, reads = _read(path, "indexes", row_start)
    _check(got, path, "indexes", row_start)
    assert stats == {"bytes": info.compress_size, "route": "pieces", "pieces": 3,
                     "serial_bytes": 0}
    _only(reads, "pieces", info.compress_size)


@pytest.mark.parametrize("key", ["small", "nulls", "flag"])
def test_one_piece_member_inflated_on_one_thread(files, key):
    path = files["always"]
    info = _info(path, key)
    assert info.compress_type == zipfile.ZIP_DEFLATED and info.file_size < 8 << 20
    got, stats, reads = _read(path, key)
    _check(got, path, key, 0)
    assert stats == {"bytes": info.compress_size, "route": "serial", "pieces": 1,
                     "serial_bytes": info.compress_size}
    _only(reads, "serial", info.compress_size)


@pytest.mark.parametrize("row_start", [0, 15_000])
def test_numpy_writer_member_inflated_on_one_thread(files, row_start):
    path = files["numpy"]
    info = _info(path, "indexes")
    got, stats, reads = _read(path, "indexes", row_start)
    _check(got, path, "indexes", row_start)
    assert (stats["route"], stats["serial_bytes"]) == ("serial", info.compress_size)
    _only(reads, "serial", info.compress_size)


def test_a_false_flush_point_falls_back_to_one_thread(files, monkeypatch):
    path = files["always"]
    real = t_npz._flush_points

    def with_a_false_one(buf):
        points = list(real(buf))
        yield points[0] // 2  # inside the first piece's Huffman data
        yield from points

    monkeypatch.setattr(t_npz, "_flush_points", with_a_false_one)
    got, stats, reads = _read(path, "indexes")
    _check(got, path, "indexes", 0)
    assert (stats["route"], stats["pieces"]) == ("serial", 1)
    _only(reads, "serial", _info(path, "indexes").compress_size)


@pytest.mark.parametrize("writer", [np.savez, np.savez_compressed])
def test_members_left_to_numpy(tmp_path, writer):
    path = str(tmp_path / "other.npz")
    arrays = {"fortran": np.asfortranarray(_table(3, rows=50)),
              "objects": np.array([{"a": 1}, None], dtype=object)}
    writer(path, **arrays)
    for key in arrays:
        t_npz.reset_member_reads()
        stats = {}
        with t_npz.NpzReader(path) as reader:
            got = reader.read(key, 1, stats)
        want = np.load(path, allow_pickle=True)[key][1:]
        assert got.dtype == want.dtype and got.flags.f_contiguous == want.flags.f_contiguous
        assert got.tolist() == want.tolist()
        assert stats["route"] == "numpy"
        _only({r: dict(c) for r, c in t_npz.MEMBER_READS.items()}, "numpy",
              _info(path, key).compress_size)


def _flipped(src, tmp_path, key, at):
    """A copy of ``src`` with one byte of ``key``'s payload flipped, ``at``
    (a fraction) of the way through it."""
    info = _info(src, key)
    data = bytearray(open(src, "rb").read())
    name_len, extra_len = np.frombuffer(
        bytes(data[info.header_offset + 26:info.header_offset + 30]), "<u2")
    start = info.header_offset + 30 + int(name_len) + int(extra_len)
    data[start + int(info.compress_size * at)] ^= 0x5A
    path = str(tmp_path / "flipped.npz")
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("mode, key, at", [
    ("never", "indexes", 0.5), ("never", "small", 0.9),
    ("always", "indexes", 0.5), ("always", "indexes", 0.99),
    ("always", "small", 0.5)])
def test_a_flipped_byte_raises_as_numpy_does(files, tmp_path, mode, key, at):
    path = _flipped(files[mode], tmp_path, key, at)
    with pytest.raises(Exception) as want:
        np.load(path)[key]
    assert isinstance(want.value, (zipfile.BadZipFile, zlib.error, EOFError))
    with t_npz.NpzReader(path) as reader, pytest.raises(type(want.value)):
        reader.read(key)
    # The other members still read.
    with t_npz.NpzReader(path) as reader:
        np.testing.assert_array_equal(reader.read("cutoff"), 0.25)


@pytest.mark.parametrize("mode", ["never", "always"])
def test_one_reader_serves_many_threads(files, mode):
    """One reader shared by more threads than cores, as the loader's pool
    shares it, with a short switch interval: every array equals
    ``np.load``'s and ``MEMBER_READS`` loses no count."""
    path = files[mode]
    keys = ["indexes", "small", "nulls", "flag", "cutoff"] * 6
    want = {key: np.load(path)[key] for key in set(keys)}
    t_npz.reset_member_reads()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with t_npz.NpzReader(path) as reader, ThreadPoolExecutor(16) as pool:
            got = list(pool.map(reader.read, keys, timeout=120))
    finally:
        sys.setswitchinterval(switch)
    for key, arr in zip(keys, got):
        np.testing.assert_array_equal(arr, want[key])
    assert sum(c["members"] for c in t_npz.MEMBER_READS.values()) == len(keys)
    assert sum(c["bytes"] for c in t_npz.MEMBER_READS.values()) == 6 * sum(
        _info(path, key).compress_size for key in set(keys))


@pytest.mark.parametrize("n1, n2", [(0, 5), (1, 1), (1000, 777), (3, 1 << 20)])
def test_crc32_combine_equals_zlib(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    a, b = rng.bytes(n1), rng.bytes(n2)
    assert t_npz.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(a + b)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """A reference's members as the loader reads them (dummy small
    members, a big A ``indexes``), written stored and deflated."""
    tmp = tmp_path_factory.mktemp("npz_reader_loader")
    pass_a = {"binsize": np.array(100000), "mask": np.ones(ROWS, bool),
              "bins_per_chr": np.full(24, ROWS // 24),
              "masked_bins_per_chr": np.full(24, ROWS // 24),
              "masked_bins_per_chr_cum": np.cumsum(np.full(24, ROWS // 24)),
              "pca_components": np.zeros((5, ROWS)), "pca_mean": np.zeros(ROWS),
              "indexes": _table(), "distances": np.zeros((ROWS, K), np.float32),
              "null_ratios": np.zeros((ROWS, 10), np.float32)}
    final = t_npz.flatten_reference({"A": pass_a}, is_nipt=False,
                                    trained_cutoff=0.3)
    out = {}
    for mode in ("never", "always"):
        with pytest.MonkeyPatch.context() as m:
            out[mode] = _write(str(tmp / f"{mode}.npz"), final, m, mode)
    return out


@pytest.mark.parametrize("mode, route, pieces", [("never", "stored", 0),
                                                 ("always", "pieces", 3)])
def test_loader_spans_carry_the_route(references, mode, route, pieces):
    path = references[mode]
    info = _info(path, "indexes")
    with profile(activities=[ProfilerActivity.CPU]):
        with ReferenceLoader(path, CPU) as loader:
            got = loader._member("A", "indexes")
            loader._member("A", "mask")  # one piece: inflated on one thread
    _check(got, path, "indexes", 0)
    kept = {s["name"]: s["attrs"] for s in tlog.spans()}
    assert kept["predict.load.indexes"] == {
        "bytes": info.compress_size, "route": route, "pieces": pieces,
        "serial_bytes": 0}
    mask = _info(path, "mask")
    assert kept["predict.load.mask"] == (
        {"bytes": mask.compress_size, "route": "serial", "pieces": 1,
         "serial_bytes": mask.compress_size} if mode == "always" else
        {"bytes": mask.compress_size, "route": "stored", "pieces": 0,
         "serial_bytes": 0})
    assert loader.passes["A"].keys() == set(t_npz.SMALL_PASS_KEYS)
    np.testing.assert_array_equal(loader.passes["A"]["pca_mean"], np.zeros(ROWS))
    assert loader.meta == {"is_nipt": False, "trained_cutoff": 0.3,
                           "has_female": False, "has_male": False}
