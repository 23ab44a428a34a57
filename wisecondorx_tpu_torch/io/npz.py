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
out (its distance-skipping load); the port imports nothing of that
package, and tests/test_torch_host.py holds the two to the same bytes.
"""

from __future__ import annotations

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


def load_reference_npz(path):
    """Load a reference npz into {'A': {...}, 'F': {...}, 'M': {...}} + meta.

    Accepts files produced by either package or the reference tool.
    Returns (passes dict, meta dict with is_nipt/trained_cutoff/has_*).

    Members decompress on a thread pool (zlib releases the GIL): the big
    index/distance/null tables are each hundreds of MB and dominate the
    predict cold start otherwise.
    """
    from concurrent.futures import ThreadPoolExecutor

    npz = np.load(path, encoding="latin1", allow_pickle=True)
    meta = {
        "is_nipt": bool(npz["is_nipt"]),
        "trained_cutoff": float(npz["trained_cutoff"]),
        "has_female": bool(npz["has_female"]),
        "has_male": bool(npz["has_male"]),
    }
    wanted = []
    for gender in ("A", "F", "M"):
        suffix = "" if gender == "A" else f".{gender}"
        if f"bins_per_chr{suffix}" not in npz:
            continue
        wanted.extend((gender, key, f"{key}{suffix}") for key in PASS_KEYS)
        wanted.extend(
            (gender, key, f"{key}{suffix}")
            for key in OPTIONAL_PASS_KEYS
            if f"{key}{suffix}" in npz
        )
    with ThreadPoolExecutor(max_workers=4) as pool:
        arrays = list(
            pool.map(lambda w: np.load(
                path, encoding="latin1", allow_pickle=True
            )[w[2]], wanted)
        )
    passes: dict = {}
    for (gender, key, _), arr in zip(wanted, arrays):
        passes.setdefault(gender, {})[key] = arr
    return passes, meta


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

def load_reference_small(path):
    """Load a reference npz's meta + per-pass small members only.

    The predict path defers the bulk tables (indexes/distances/null
    ratios — ~1 GB decompressed per pass at 15 kb) to background threads
    that stream them straight toward the device
    (:class:`wisecondorx_tpu_torch.models.ref_loader.ReferenceLoader`); this
    returns in milliseconds with everything stage control flow needs.

    Returns (passes dict gender -> {small keys}, meta dict).
    """
    npz = np.load(path, encoding="latin1", allow_pickle=True)
    meta = {
        "is_nipt": bool(npz["is_nipt"]),
        "trained_cutoff": float(npz["trained_cutoff"]),
        "has_female": bool(npz["has_female"]),
        "has_male": bool(npz["has_male"]),
    }
    passes: dict = {}
    for gender in ("A", "F", "M"):
        suffix = "" if gender == "A" else f".{gender}"
        if f"bins_per_chr{suffix}" not in npz:
            continue
        passes[gender] = {
            key: npz[f"{key}{suffix}"] for key in SMALL_PASS_KEYS
        }
        for key in OPTIONAL_PASS_KEYS:
            if f"{key}{suffix}" in npz:
                passes[gender][key] = npz[f"{key}{suffix}"]
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
    """Load ``npz[key][row_start:]`` — reading only the tail bytes when
    the member is STORED (adaptive-stored big tables admit random access
    inside the zip), else falling back to a full load + slice.

    The gonosomal predict pass consumes only its chrX/chrY target rows
    (~5% of the table); on a stored member this turns a ~0.5 GB read
    into ~10 MB.  ``stats["bytes"]``, where given, is set to the member's
    bytes read from the file: its ``.npy`` header and the rows read, or
    its whole stored size when it is read whole.
    """
    import zipfile

    name = f"{key}.npy"
    if stats is None:
        stats = {}
    try:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(name)
            stats["bytes"] = info.compress_size
            if info.compress_type != 0:
                raise KeyError  # deflated: full load below
            with zf.open(name) as member:
                version = np.lib.format.read_magic(member)
                readers = {
                    (1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0,
                }
                reader = readers.get(
                    tuple(version), np.lib.format.read_array_header_2_0
                )
                shape, fortran, dtype = reader(member)
                if fortran or dtype.hasobject or len(shape) == 0:
                    raise KeyError
                row_bytes = int(
                    np.prod(shape[1:], dtype=np.int64)
                ) * dtype.itemsize
                rows = shape[0] - row_start
                header = member.tell()
                if rows <= 0:
                    stats["bytes"] = header
                    return np.empty((0,) + shape[1:], dtype=dtype)
                member.seek(row_start * row_bytes, 1)
                buf = member.read(rows * row_bytes)
            stats["bytes"] = header + len(buf)
            return np.frombuffer(buf, dtype=dtype).reshape(
                (rows,) + shape[1:]
            )
    except (KeyError, OSError, ValueError):
        return np.load(path, encoding="latin1", allow_pickle=True)[key][
            row_start:
        ]


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
