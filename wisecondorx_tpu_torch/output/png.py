"""PNG files with the standard library only: ``write_png`` encodes an RGB
image (8 bits per channel, filter type 0 on every row, one zlib stream)
and ``read_png`` decodes 8-bit RGB and RGBA PNGs of any filter type
(0-4), checking every chunk's CRC.  ``write_pngs`` encodes several on a
thread pool: ``zlib.compress`` releases the interpreter lock."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: zlib level of the figures: the fastest, since encoding lies on
#: predict's path and the images are mostly white.
LEVEL = 1
#: Encoder threads: the card's host has 8 cores.
WORKERS = 8


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """The PNG bytes of ``rgb``, a uint8 array [height, width, 3]."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> int:
    """Write ``rgb`` (uint8 [H, W, 3]) to ``path`` as a PNG; the bytes
    written."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def write_pngs(items) -> int:
    """Write each (path, rgb) of ``items`` on a pool of up to WORKERS
    threads; the bytes written."""
    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, min(WORKERS, len(items)))) as pool:
        return sum(fut.result() for fut in
                   [pool.submit(write_png, p, rgb) for p, rgb in items])


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for r in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum of each channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(stride):  # each byte depends on the one before
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"row {r}: unknown PNG filter type {ftype}")
        out[r] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB or RGBA, non-interlaced PNG into a uint8 array
    [H, W, channels].  Raises ValueError on a bad signature, a CRC
    mismatch or an unsupported format."""
    data = open(path, "rb").read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs "
                         f"are read (depth {depth}, color type {color})")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, "
                         f"want {h * (stride + 1)}")
    return _unfilter(raw, h, stride, channels).reshape(h, w, channels)
