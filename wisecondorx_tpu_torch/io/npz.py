"""Persistence: .npz schemas bit-compatible with the reference tool.

Two on-disk artifacts exist (SURVEY.md section 2.10/2.14):

* **sample npz** (output of ``convert``): keys ``binsize`` (scalar),
  ``sample`` (0-d object array holding dict chr-name -> int32 counts) and
  ``quality`` (0-d object array holding the read-filter QC dict)
  — reference main.py:33-35.

* **reference npz** (output of ``newref``): keys ``binsize, mask,
  bins_per_chr, masked_bins_per_chr, masked_bins_per_chr_cum,
  pca_components, pca_mean, indexes, distances, null_ratios`` plus ``.F`` /
  ``.M`` suffixed variants for the gonosomal passes and scalars
  ``has_female, has_male, is_nipt, trained_cutoff``
  — reference newref_control.py:220-237.

Keeping the formats identical lets a reference npz drive our predictor (and
vice versa), which is the basis of the parity test-suite.

Copy of wisecondorx_tpu/io/npz.py with what only the JAX package uses left
out (its distance-skipping load), and with a member reader of its own
(:class:`NpzReader`) through which the reference loads read; the port
imports nothing of that package, and tests/test_torch_host.py holds the
two to the same bytes.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wisecondorx_tpu_torch.errors import UserInputError
from wisecondorx_tpu_torch.utils.log import stage_timer


class BinScalingError(ValueError, UserInputError):
    """Raised on an impossible binsize rescale request."""


def scale_sample(sample: dict, from_size: int, to_size: int | None) -> dict:
    """Sum counts into coarser bins.

    Semantics of reference overall_tools.py:19-40: a no-op when ``to_size``
    is falsy or equal to ``from_size``; otherwise ``to_size`` must be a
    positive multiple of ``from_size``.  Block-sums each chromosome's counts
    (vectorized here instead of the reference's per-bin Python loop).
    """
    if not to_size or from_size == to_size:
        return sample
    if (
        to_size == 0
        or from_size == 0
        or to_size < from_size
        or to_size % from_size > 0
    ):
        raise BinScalingError(
            f"Impossible binsize scaling requested: {int(from_size)} "
            f"to {int(to_size)}"
        )

    scale = int(to_size // from_size)
    out = {}
    for chr_name, chr_data in sample.items():
        chr_data = np.asarray(chr_data)
        new_len = int(np.ceil(len(chr_data) / float(scale)))
        padded = np.zeros(new_len * scale, dtype=np.int64)
        padded[: len(chr_data)] = chr_data
        out[chr_name] = (
            padded.reshape(new_len, scale).sum(axis=1).astype(np.int32)
        )
    return out


def gender_correct(sample: dict, gender: str) -> dict:
    """Rescale gonosomal reads to diploid scale for males.

    Reference overall_tools.py:48-53: for "M" samples chrX ("23") and chrY
    ("24") counts are doubled; mutates and returns the dict (matching the
    reference's in-place behavior).
    """
    if gender == "M":
        sample["23"] = sample["23"] * 2
        sample["24"] = sample["24"] * 2
    return sample


# ---------------------------------------------------------------------------
# Sample npz
# ---------------------------------------------------------------------------


def save_sample_npz(path, binsize, sample: dict, quality: dict) -> None:
    """Write a convert-stage sample npz (reference main.py:33-35)."""
    np.savez_compressed(path, binsize=binsize, sample=sample, quality=quality)


def load_sample_npz(path):
    """Load a convert-stage sample npz.

    Returns (sample dict chr->int32 array, binsize int, quality dict|None).
    """
    npz = np.load(path, encoding="latin1", allow_pickle=True)
    sample = npz["sample"].item()
    binsize = int(np.atleast_1d(npz["binsize"])[0])
    quality = npz["quality"].item() if "quality" in npz else None
    return sample, binsize, quality


# ---------------------------------------------------------------------------
# Reference npz
# ---------------------------------------------------------------------------

#: Keys stored per gender pass, matching reference newref_control.py:176-189.
PASS_KEYS = (
    "binsize",
    "mask",
    "bins_per_chr",
    "masked_bins_per_chr",
    "masked_bins_per_chr_cum",
    "pca_components",
    "pca_mean",
    "indexes",
    "distances",
    "null_ratios",
)

#: Optional predict-side cache members (suffixed like PASS_KEYS): pure
#: float64 functions of the stored tables, precomputed by newref so the
#: predict stage skips decompressing/scanning the distance table.  The
#: reference tool reads its known keys only, so these are invisible to it.
OPTIONAL_PASS_KEYS = ("wcx_weights", "wcx_cutoffs", "wcx_distok")


def flatten_reference(
    passes: dict, *, is_nipt: bool, trained_cutoff: float
) -> dict:
    """Flatten per-pass arrays into the suffixed final-npz key layout.

    Key suffixing matches reference newref_control.py:220-237: the "A"
    pass is stored unsuffixed, "F"/"M" passes get ``.F`` / ``.M``
    appended.  The result is both what ``newref`` writes with
    :func:`_savez_fast` and what
    :func:`wisecondorx_tpu_torch.ref_qc.qc_reference_arrays` scores without
    a disk round-trip.
    """
    final = {
        "has_female": "F" in passes,
        "has_male": "M" in passes,
        "is_nipt": is_nipt,
        "trained_cutoff": trained_cutoff,
    }
    for gender, arrays in passes.items():
        suffix = "" if gender == "A" else f".{gender}"
        for key in PASS_KEYS:
            if key not in arrays:
                raise KeyError(f"pass {gender!r} missing key {key!r}")
            final[f"{key}{suffix}"] = arrays[key]
        for key in OPTIONAL_PASS_KEYS:
            if key in arrays:
                final[f"{key}{suffix}"] = arrays[key]
    return final


def _savez_fast(path, arrays: dict) -> None:
    """``np.savez_compressed``-compatible writer: parallel zlib level 1
    with per-member adaptive STORED.

    numpy hardwires single-threaded deflate level 6, which compresses the
    ~0.5 GB of index/distance tables at ~30-40 MB/s.  Here each member's
    deflate stream is produced from independently compressed chunks
    joined with Z_FULL_FLUSH boundaries (the pigz construction — a fully
    valid single deflate stream), with the chunks compressed at level 1
    on a thread pool (zlib releases the GIL), and the zip container
    written by hand.  The result is an ordinary npz (zip of .npy
    members) that ``np.load`` — ours or the reference's — reads
    identically.

    **Adaptive STORED**: float distance/null tables are near-random in
    the mantissa bytes and deflate to only ~0.85-0.95 of their size at
    ~30 MB/s per core — on a small host that is the bulk of both the
    newref write wall and the predict load wall (decompression runs at a
    similar rate).  A 4 MiB probe per big member decides: if deflate
    saves < 35% the member is stored raw (zip method 0 — still a fully
    standard npz), trading cheap disk bytes for tens of seconds of CPU
    on both ends.  ``WCX_NPZ_COMPRESS=always|never|auto`` overrides.

    Falls back to numpy's writer for members >= 4 GiB (zip64 territory).

    Stages ``npz.write.serialize``, ``npz.write.compress`` and
    ``npz.write.io``, each with span attributes ``raw_bytes`` (the members'
    ``.npy`` bytes) and ``stored_bytes`` (the members as the archive holds
    them, local headers included: the file less its zip directory).
    """
    import io
    import os
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"

    mode = os.environ.get("WCX_NPZ_COMPRESS", "auto")

    with stage_timer("npz.write.serialize") as serialize:
        members = []
        for key, val in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(
                buf, np.asanyarray(val), allow_pickle=True
            )
            members.append((f"{key}.npy", buf.getbuffer()))
    if any(len(raw) >= 2**32 - 1 for _, raw in members):
        np.savez_compressed(path, **arrays)  # zip64: numpy handles it
        return

    chunk = 1 << 23  # 8 MiB per deflate chunk
    probe = 1 << 22

    def want_deflate(raw) -> bool:
        if mode == "always":
            return True
        if mode == "never":
            return False  # fully STORED, seekable archive
        if len(raw) < (1 << 22):
            return True
        if len(raw) >= (64 << 20):
            # Big tables are stored outright: even a 2x ratio costs ~10 s
            # per 0.5 GB per core on each END of the pipeline (newref
            # write + every predict load), and stored members additionally
            # admit seekable row-slice reads (load_member_rows).
            return False
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        sample = co.compress(bytes(raw[:probe])) + co.flush()
        return len(sample) / probe <= 0.65

    def compress_member(raw):
        if not want_deflate(raw):
            return None, zlib.crc32(raw)  # stored
        pieces = [
            bytes(raw[a : a + chunk]) for a in range(0, len(raw), chunk)
        ] or [b""]

        def one(i):
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            out = co.compress(pieces[i])
            out += co.flush(
                zlib.Z_FULL_FLUSH if i < len(pieces) - 1 else zlib.Z_FINISH
            )
            return out

        with ThreadPoolExecutor(max_workers=8) as pool:
            blobs = list(pool.map(one, range(len(pieces))))
        return b"".join(blobs), zlib.crc32(raw)

    with stage_timer("npz.write.compress") as compress:
        with ThreadPoolExecutor(max_workers=4) as pool:
            compressed = list(
                pool.map(lambda m: compress_member(m[1]), members)
            )

    # Any 32-bit zip field overflowing (compressed size, or the running
    # archive offset of a later member / the central directory) needs
    # zip64 — let numpy's writer handle that instead of struct.error-ing.
    lim = 2**32 - 1
    offset = 0
    for (name, raw), (data, _) in zip(members, compressed):
        size = len(raw) if data is None else len(data)
        offset += 30 + len(name.encode()) + size
        if size >= lim or offset >= lim:
            np.savez_compressed(path, **arrays)
            return

    with stage_timer("npz.write.io") as writing, open(path, "wb") as f:
        raw_bytes = sum(len(raw) for _, raw in members)
        for span in (serialize, compress, writing):
            span.add("raw_bytes", raw_bytes)
            span.add("stored_bytes", offset)
        central = []
        for (name, raw), (data, crc) in zip(members, compressed):
            offset = f.tell()
            nameb = name.encode()
            method = 0 if data is None else 8  # stored / deflate
            payload = raw if data is None else data
            # Local file header: no flags, zeroed DOS timestamp.
            f.write(
                struct.pack(
                    "<IHHHHHIIIHH", 0x04034B50, 20, 0, method, 0, 0,
                    crc, len(payload), len(raw), len(nameb), 0,
                )
                + nameb
            )
            f.write(payload)
            central.append(
                struct.pack(
                    "<IHHHHHHIIIHHHHHII", 0x02014B50, 20, 20, 0, method,
                    0, 0, crc, len(payload), len(raw), len(nameb),
                    0, 0, 0, 0, 0, offset,
                )
                + nameb
            )
        cd_start = f.tell()
        for entry in central:
            f.write(entry)
        cd_size = f.tell() - cd_start
        f.write(
            struct.pack(
                "<IHHHHIIH", 0x06054B50, 0, 0,
                len(central), len(central), cd_size, cd_start, 0,
            )
        )


# ---------------------------------------------------------------------------
# Member reader
# ---------------------------------------------------------------------------

#: Members read by :class:`NpzReader` since :func:`reset_member_reads`, by
#: route: ``stored`` (a stored member read by byte range), ``pieces`` (a
#: deflated member inflated at its full-flush points in parallel),
#: ``serial`` (a deflated member that does not split, left to ``np.load``,
#: which inflates it on one thread) and ``numpy`` (a member the reader
#: cannot lay out, left to ``np.load``: see :class:`NpzReader`).  Each
#: ``{"members": n, "bytes": b}``, ``b`` the bytes read from the file
#: (``stats["bytes"]`` of :meth:`NpzReader.read`).
MEMBER_READS = {
    route: {"members": 0, "bytes": 0}
    for route in ("stored", "pieces", "serial", "numpy")
}
_READS_LOCK = threading.Lock()

#: The empty stored block that ends each piece of a full-flushed deflate
#: stream (``_savez_fast``'s 8 MiB pieces), byte-aligned.
_FLUSH_MARK = b"\x00\x00\xff\xff"
#: Bytes of a stored member's slice, at least, per pool task.
_SLICE_BYTES = 4 << 20
#: Threads of a reader's pool: slices and pieces read or inflated at once.
_WORKERS = 8
#: Bytes of a member's head read for its ``.npy`` header, at most.
_HEADER_BYTES = 1 << 12
#: Raw bytes of one of ``_savez_fast``'s pieces: a member no larger is
#: inflated whole, with no scan for a split.
_PIECE_BYTES = 1 << 23


def reset_member_reads() -> None:
    with _READS_LOCK:
        for counts in MEMBER_READS.values():
            counts["members"] = counts["bytes"] = 0


def _multmodp(a: int, b: int) -> int:
    """a x b modulo the CRC-32 polynomial (reflected; zlib's multmodp)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if a & (m - 1) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ 0xEDB88320 if b & 1 else b >> 1


#: x^(2^n) modulo the CRC-32 polynomial, n = 0..31 (zlib's x2n_table).
_X2N = [1 << 30]
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and
    ``len(b)`` (zlib's ``crc32_combine``, which Python's zlib lacks)."""
    p, k = 1 << 31, 3  # x^0; 2^3 bits a byte
    while len2:
        if len2 & 1:
            p = _multmodp(_X2N[k & 31], p)
        len2 >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


def _flush_points(buf):
    """Offsets in ``buf`` just past each ``00 00 FF FF``: where a
    full-flushed deflate stream may start a piece.  A marker can also
    occur by chance inside compressed data; the caller checks."""
    at = buf.find(_FLUSH_MARK)
    while at >= 0:
        yield at + 4
        at = buf.find(_FLUSH_MARK, at + 4)


def _plain_layout(head, info):
    """(header length, shape, dtype, bytes a row, data bytes) of the
    ``.npy`` member ``info`` whose first bytes are ``head``: a C-order
    array of plain data whose header lies within ``head`` and whose size
    agrees with the zip's; else None."""
    head = bytes(head)
    if head[:6] != b"\x93NUMPY" or len(head) < 12:
        return None
    if head[6] == 1:
        length = 10 + int.from_bytes(head[8:10], "little")
    else:
        length = 12 + int.from_bytes(head[8:12], "little")
    if len(head) < length:
        return None
    f = io.BytesIO(head[:length])
    try:
        version = tuple(np.lib.format.read_magic(f))
        reader = {
            (1, 0): np.lib.format.read_array_header_1_0,
        }.get(version, np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = reader(f)
    except ValueError:
        return None
    if fortran or dtype.hasobject:
        return None
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
    nbytes = row_bytes * (shape[0] if shape else 1)
    if length + nbytes != info.file_size:
        return None
    return length, shape, dtype, row_bytes, nbytes


def _pread_into(fd: int, view, offset: int) -> None:
    """Fill the writable buffer ``view`` from file offset ``offset``."""
    done = 0
    while done < len(view):
        got = os.preadv(fd, [view[done:]], offset + done)
        if got == 0:
            raise EOFError("the archive ends inside a member")
        done += got


def _inflate_piece(view, last: bool):
    """One piece of a full-flushed deflate stream inflated on its own:
    (output, its CRC-32), or None where it is no such piece (an error;
    a piece but the last that reaches the final block, or the last that
    does not; input left over)."""
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(view)
    except zlib.error:
        return None
    if d.unused_data or d.eof != last:
        return None
    return out, zlib.crc32(out)


def _empty(nbytes: int) -> np.ndarray:
    return np.empty(nbytes, np.uint8)


class NpzReader:
    """The ``.npy`` members of one ``.npz`` file, each read straight into
    its destination array.

    The zip's central directory and every member's local header are
    parsed once, on open; :meth:`read` then reads a member by its byte
    range:

    * a stored member: in slices across the reader's pool (``os.preadv``
      into the destination), each slice's CRC-32 taken beside it and the
      slices' combined (:func:`crc32_combine`) against the zip's; a read
      from row ``row_start > 0`` reads the rows from there on only, and
      checks no CRC (it lacks the member's head);
    * a deflated member: its compressed bytes read once, split at the
      ``00 00 FF FF`` markers that ``_savez_fast``'s full flushes leave
      between its independent 8 MiB pieces, and the pieces inflated
      concurrently (route ``pieces``); the split holds only where every
      piece inflates, every piece but the last ends before the final
      block and the last at it, the outputs add up to the member's size
      and their combined CRC-32 is the zip's.  Otherwise (a member of at
      most one piece, which is not scanned; no markers, as in a file of
      ``np.savez_compressed`` or the reference tool; or a marker that came
      about by chance) the member is left to
      ``np.load``, which inflates it on the calling thread (route
      ``serial``);
    * anything else (an object or Fortran-order array, a ``.npy`` header
      past the member's first 4 KiB, another zip method) through
      ``np.load`` (route ``numpy``).

    Every route gives ``np.load(path)[key][row_start:]``; a corrupt
    member raises as ``np.load`` does (``zipfile.BadZipFile`` on a CRC
    mismatch, ``zlib.error`` on bad deflate data).  The pool's tasks wait
    on nothing, so a read may be made from any thread, another pool's
    included.  Close the reader (or use it as a context manager) to stop
    its pool and close the file."""

    def __init__(self, path):
        self.path = str(path)
        # Its zip's directory is the one parse; the routes ``serial`` and
        # ``numpy`` read through it (zipfile reads members concurrently).
        self._npz = np.load(self.path, encoding="latin1", allow_pickle=True)
        self._fd = -1
        self._members = {}
        try:
            self._fd = os.open(self.path, os.O_RDONLY)
            for info in self._npz.zip.infolist():
                if not info.filename.endswith(".npy"):
                    continue
                head = bytearray(30)
                _pread_into(self._fd, memoryview(head), info.header_offset)
                sig, *_, name_len, extra_len = struct.unpack(
                    "<IHHHHHIIIHH", head)
                if sig != 0x04034B50:
                    raise zipfile.BadZipFile(
                        f"Bad magic number for file header {info.filename!r}")
                offset = info.header_offset + 30 + name_len + extra_len
                self._members[info.filename[:-4]] = (info, offset)
        except BaseException:
            if self._fd >= 0:
                os.close(self._fd)
            self._npz.close()
            raise
        self._pool = ThreadPoolExecutor(max_workers=_WORKERS,
                                        thread_name_prefix="wcx-npz")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
            self._npz.close()

    def __contains__(self, key) -> bool:
        return key in self._members

    def read(self, key: str, row_start: int = 0, stats: dict | None = None,
             alloc=None) -> np.ndarray:
        """``np.load(path)[key][row_start:]``, read by the member's route.

        ``alloc(nbytes)`` gives the destination, a writable uint8 array of
        ``nbytes`` (default ``np.empty``; the device loader passes pinned
        memory); the result is a view of it, except on the routes
        ``serial`` and ``numpy``, which ``np.load`` reads.  ``stats``, where
        given, gets ``bytes`` (read from the file: the member's stored
        size, or its ``.npy`` header and the rows read of a stored member
        read from a row on), ``route``, ``pieces`` (inflated concurrently;
        0 for a stored member, 1 on route ``serial``) and ``serial_bytes``
        (compressed bytes inflated on one thread)."""
        if key not in self._members:
            raise KeyError(f"{key} is not a file in the archive")
        info, offset = self._members[key]
        stats = {} if stats is None else stats
        stats.update(bytes=info.compress_size, route="numpy", pieces=0,
                     serial_bytes=0)
        method = {zipfile.ZIP_STORED: self._read_stored,
                  zipfile.ZIP_DEFLATED: self._read_deflated}.get(
                      info.compress_type)
        out = None
        if method is not None and not info.flag_bits & 1:  # not encrypted
            out = method(info, offset, row_start, stats, alloc or _empty)
        if out is None:  # route ``serial`` or ``numpy``
            out = self._npz[key]
            out = out[row_start:] if row_start else out
        with _READS_LOCK:
            counts = MEMBER_READS[stats["route"]]
            counts["members"] += 1
            counts["bytes"] += stats["bytes"]
        return out

    def _map(self, fn, *args):
        """``map(fn, *args)`` across the pool, or on this thread for one
        item; the results in order."""
        args = list(zip(*args))
        if len(args) <= 1:
            return [fn(*a) for a in args]
        futures = [self._pool.submit(fn, *a) for a in args]
        return [f.result() for f in futures]

    def _read_range(self, dest: np.ndarray, offset: int,
                    crc: bool) -> int | None:
        """Fill ``dest`` from file offset ``offset`` in slices across the
        pool; the CRC-32 of ``dest`` where ``crc``."""
        n = len(dest)
        parts = max(1, min(_WORKERS, -(-n // _SLICE_BYTES)))
        bounds = [n * i // parts for i in range(parts + 1)]
        view = memoryview(dest)

        def part(a, b):
            _pread_into(self._fd, view[a:b], offset + a)
            return zlib.crc32(view[a:b]) if crc else None

        crcs = self._map(part, bounds[:-1], bounds[1:])
        if not crc:
            return None
        total = 0
        for value, a, b in zip(crcs, bounds[:-1], bounds[1:]):
            total = crc32_combine(total, value, b - a)
        return total

    def _read_stored(self, info, offset, row_start, stats, alloc):
        head = np.empty(min(info.file_size, _HEADER_BYTES), np.uint8)
        self._read_range(head, offset, crc=False)
        layout = _plain_layout(head, info)
        if layout is None:
            return None
        length, shape, dtype, row_bytes, nbytes = layout
        stats.update(route="stored")
        if row_start and shape:
            rows = max(shape[0] - row_start, 0)
            dest = alloc(rows * row_bytes)
            if rows:
                self._read_range(dest, offset + length + row_start * row_bytes,
                                 crc=False)
            stats["bytes"] = length + rows * row_bytes
            return dest.view(dtype).reshape((rows,) + tuple(shape[1:]))
        dest = alloc(nbytes)
        crc = self._read_range(dest, offset + length, crc=True)
        crc = crc32_combine(zlib.crc32(head[:length]), crc, nbytes)
        if crc != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
        return dest.view(dtype).reshape(shape)

    def _read_deflated(self, info, offset, row_start, stats, alloc):
        head = np.empty(min(info.compress_size, _HEADER_BYTES), np.uint8)
        self._read_range(head, offset, crc=False)
        try:  # the header from the stream's first 4 KiB
            head = zlib.decompressobj(-15).decompress(head, _HEADER_BYTES)
        except zlib.error:
            return None
        layout = _plain_layout(head, info)
        if layout is None:
            return None
        length, shape, dtype, row_bytes, nbytes = layout
        stats.update(route="serial", pieces=1, serial_bytes=info.compress_size)
        if info.file_size <= _PIECE_BYTES:
            return None  # one piece: left to np.load
        comp = bytearray(info.compress_size)
        view = memoryview(comp)
        self._read_range(view, offset, crc=False)
        # The pieces are handed to the pool as the scan finds them.
        futures, start = [], 0
        for end in _flush_points(comp):
            if end >= len(comp):
                break
            futures.append(self._pool.submit(_inflate_piece, view[start:end],
                                             False))
            start = end
        pieces = None
        if futures:
            futures.append(self._pool.submit(_inflate_piece, view[start:],
                                             True))
            pieces = [f.result() for f in futures]
            if any(p is None for p in pieces):
                pieces = None
        if pieces is not None:
            crc, size = 0, 0
            for out, value in pieces:
                crc = crc32_combine(crc, value, len(out))
                size += len(out)
            if size != info.file_size or crc != info.CRC:
                pieces = None
        if pieces is None:
            return None  # left to np.load
        stats.update(route="pieces", pieces=len(pieces), serial_bytes=0)
        outs = [out for out, _ in pieces]
        del comp, view, futures, pieces  # before the destination is made
        dest = alloc(nbytes)
        # Each output's share of the destination (the first less the
        # header), copied across the pool.
        starts = np.cumsum([0] + [len(o) for o in outs[:-1]]) - length

        def place(out, at):
            skip = max(0, -at)
            src = np.frombuffer(out, np.uint8)[skip:]
            dest[at + skip : at + skip + len(src)] = src

        self._map(place, outs, [int(a) for a in starts])
        arr = dest.view(dtype).reshape(shape)
        return arr[row_start:] if row_start and shape else arr


def load_reference_npz(path):
    """Load a reference npz into {'A': {...}, 'F': {...}, 'M': {...}} + meta.

    Accepts files produced by either package or the reference tool.
    Returns (passes dict, meta dict with is_nipt/trained_cutoff/has_*).

    Members are read by one :class:`NpzReader`, four at a time on a thread
    pool besides the reader's own: the big index/distance/null tables are
    each hundreds of MB and dominate the predict cold start otherwise.
    """
    with NpzReader(path) as reader, ThreadPoolExecutor(max_workers=4) as pool:
        meta = _reference_meta(reader)
        wanted = []
        for gender in ("A", "F", "M"):
            suffix = "" if gender == "A" else f".{gender}"
            if f"bins_per_chr{suffix}" not in reader:
                continue
            wanted.extend((gender, key, f"{key}{suffix}") for key in PASS_KEYS)
            wanted.extend(
                (gender, key, f"{key}{suffix}")
                for key in OPTIONAL_PASS_KEYS
                if f"{key}{suffix}" in reader
            )
        arrays = list(pool.map(lambda w: reader.read(w[2]), wanted))
    passes: dict = {}
    for (gender, key, _), arr in zip(wanted, arrays):
        passes.setdefault(gender, {})[key] = arr
    return passes, meta


def _reference_meta(reader: NpzReader) -> dict:
    return {
        "is_nipt": bool(reader.read("is_nipt")),
        "trained_cutoff": float(reader.read("trained_cutoff")),
        "has_female": bool(reader.read("has_female")),
        "has_male": bool(reader.read("has_male")),
    }


#: Per-pass members small enough to load eagerly (everything except the
#: hundreds-of-MB ``indexes`` / ``distances`` / ``null_ratios`` tables).
SMALL_PASS_KEYS = (
    "binsize",
    "mask",
    "bins_per_chr",
    "masked_bins_per_chr",
    "masked_bins_per_chr_cum",
    "pca_components",
    "pca_mean",
)

def load_reference_small(reader: NpzReader):
    """Load a reference npz's meta + per-pass small members only.

    The predict path defers the bulk tables (indexes/distances/null
    ratios — ~1 GB decompressed per pass at 15 kb) to background threads
    that stream them straight toward the device
    (:class:`wisecondorx_tpu_torch.models.ref_loader.ReferenceLoader`); this
    returns in milliseconds with everything stage control flow needs.
    ``reader`` is an open :class:`NpzReader` of the file.  The members are
    read one after another: each inflates through ``np.load``, whose
    256 KiB reads hold the interpreter lock in between, so threads gain
    nothing.

    Returns (passes dict gender -> {small keys}, meta dict).
    """
    meta = _reference_meta(reader)
    passes: dict = {}
    for gender in ("A", "F", "M"):
        suffix = "" if gender == "A" else f".{gender}"
        if f"bins_per_chr{suffix}" not in reader:
            continue
        passes[gender] = {
            key: reader.read(f"{key}{suffix}") for key in SMALL_PASS_KEYS
        }
        for key in OPTIONAL_PASS_KEYS:
            if f"{key}{suffix}" in reader:
                passes[gender][key] = reader.read(f"{key}{suffix}")
    return passes, meta


def verify_reference_npz(path, expected_keys=None) -> None:
    """Structural verification of a just-written reference npz: the zip
    central directory parses, every member's stored CRC matches its
    payload, and (optionally) the member set covers ``expected_keys``.

    Restores the round-trip guarantee the in-memory QC path gave up: a
    short write, a disk error, or a writer bug fails HERE with a clear
    message instead of at the next predict.  Raises OSError/ValueError on
    any mismatch.
    """
    import zipfile

    with zipfile.ZipFile(path) as zf:
        bad = zf.testzip()  # reads + CRC-checks every member
        if bad is not None:
            raise ValueError(
                f"reference npz verification failed: member {bad!r} is "
                "corrupt (CRC mismatch)"
            )
        if expected_keys is not None:
            names = {n[:-4] for n in zf.namelist() if n.endswith(".npy")}
            missing = set(expected_keys) - names
            if missing:
                raise ValueError(
                    "reference npz verification failed: missing members "
                    f"{sorted(missing)}"
                )


def load_member_rows(path, key, row_start: int, stats: dict | None = None):
    """Load ``npz[key][row_start:]`` through a one-off :class:`NpzReader`:
    only the tail bytes of a STORED member (adaptive-stored big tables
    admit random access inside the zip), the whole of a deflated one.

    The gonosomal predict pass consumes only its chrX/chrY target rows
    (~5% of the table); on a stored member this turns a ~0.5 GB read
    into ~10 MB.  ``stats``, where given, gets what
    :meth:`NpzReader.read` reports: ``bytes`` read from the file (the
    member's ``.npy`` header and the rows read, or its whole stored size
    when it is read whole), ``route``, ``pieces`` and ``serial_bytes``.
    """
    with NpzReader(path) as reader:
        return reader.read(key, row_start, stats)


def reference_npz_headers(path):
    """Cheap structural peek at a reference npz: per-pass small arrays
    (mask, bins_per_chr, cumsums) plus the SHAPES of the big tables, read
    without decompressing the tables themselves -- the predict warm-up
    reads ``k`` from it before the tables arrive (utils/warmup.py).
    """
    import zipfile

    npz = np.load(path, encoding="latin1", allow_pickle=True)
    out = {}
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        for gender in ("A", "F", "M"):
            suffix = "" if gender == "A" else f".{gender}"
            if f"bins_per_chr{suffix}.npy" not in names:
                continue
            entry = {
                "mask": np.asarray(npz[f"mask{suffix}"], dtype=bool),
                "bins_per_chr": np.asarray(npz[f"bins_per_chr{suffix}"]),
                "masked_bins_per_chr_cum": np.asarray(
                    npz[f"masked_bins_per_chr_cum{suffix}"]
                ),
            }
            with zf.open(f"indexes{suffix}.npy") as member:
                version = np.lib.format.read_magic(member)
                readers = {
                    (1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0,
                }
                reader = readers.get(
                    tuple(version), np.lib.format.read_array_header_2_0
                )
                shape, _, _ = reader(member)
            entry["indexes_shape"] = shape
            out[gender] = entry
    return out
