"""Text of the PNG figures: strings laid out into 8-bit coverage masks from
the committed glyph atlas (``_glyphs.py``), rotated and aligned on their
anchor as matplotlib aligns text.

All of it is host numpy; the rasterizer blits the masks.  Glyph advances
are DejaVu Sans's unhinted ones, without kerning.  ``$...$`` spans take the
one mathtext construct the figures use, a subscript (``log$_2$(ratio)``),
set at 0.7 of the size as mathtext sets it.  A character outside the atlas
draws a placeholder box.
"""

from __future__ import annotations

import base64
import functools
import math
import re
import struct
import zlib

import numpy as np

from wisecondorx_tpu_torch.output import _glyphs

_HEADER = struct.Struct("<hhhhi")
#: mathtext's size of a subscript relative to its base.
SUBSCRIPT_SCALE = 0.7
#: A subscript's baseline below the base's, in ems of the base size.
SUBSCRIPT_DROP = 0.2


@functools.cache
def _atlas() -> dict:
    """{(pt, dpi): {char: (coverage [rows, cols] uint8, bearing_x,
    bearing_y, advance px)}}, decoded once."""
    raw = zlib.decompress(base64.b64decode("".join(_glyphs.DATA)))
    atlas, pos = {}, 0
    for size in _glyphs.SIZES:
        table = atlas[tuple(size)] = {}
        for char in _glyphs.CHARS:
            rows, cols, bx, by, adv = _HEADER.unpack_from(raw, pos)
            pos += _HEADER.size
            cov = np.frombuffer(raw, np.uint8, rows * cols, pos).reshape(rows, cols)
            pos += rows * cols
            table[char] = (cov, bx, by, adv / 64.0)
    return atlas


def _size_key(pt: float, dpi: float):
    key = (int(round(pt)), int(dpi))
    if key not in _atlas() or abs(pt - key[0]) > 1e-9:
        raise ValueError(f"no glyphs baked at {pt} pt and {dpi} dpi "
                         f"(sizes: {_glyphs.SIZES})")
    return key


def _placeholder(pt: float, dpi: float):
    """A box the size of a capital for a character the atlas lacks."""
    em = pt * dpi / 72.0
    w, h = max(2, int(round(0.55 * em))), max(3, int(round(0.7 * em)))
    box = np.zeros((h, w), np.uint8)
    box[[0, -1], :] = 255
    box[:, [0, -1]] = 255
    return box, int(round(0.05 * em)), h, 0.65 * em


def _runs(s: str, pt: float):
    """[(text, points, baseline drop in ems of the base size)] of ``s``:
    outside ``$...$`` the text itself; inside, subscripts ``_x`` and
    ``_{xy}`` at SUBSCRIPT_SCALE, everything else at the base size."""
    runs = []
    for i, part in enumerate(s.split("$")):
        if i % 2 == 0:
            runs.append((part, pt, 0.0))
            continue
        pos = 0
        for m in re.finditer(r"_(\{[^}]*\}|.)", part):
            runs.append((part[pos:m.start()], pt, 0.0))
            runs.append((m.group(1).strip("{}"), pt * SUBSCRIPT_SCALE,
                         SUBSCRIPT_DROP))
            pos = m.end()
        runs.append((part[pos:], pt, 0.0))
    return [r for r in runs if r[0]]


def layout(s: str, pt: float, dpi: float):
    """(coverage [rows, cols] uint8, baseline row, descent rows) of ``s``
    set horizontally."""
    glyphs, pen = [], 0.0
    em = pt * dpi / 72.0
    for text, size, drop in _runs(s, pt):
        table = _atlas()[_size_key(size, dpi)]
        for ch in text:
            cov, bx, by, adv = table.get(ch) or _placeholder(size, dpi)
            glyphs.append((cov, int(math.floor(pen + 0.5)) + bx,
                           by - int(round(drop * em))))
            pen += adv
    width = max([int(math.ceil(pen))] + [x + c.shape[1] for c, x, _ in glyphs])
    ascent = max([0] + [top for _, _, top in glyphs])
    descent = max([0] + [c.shape[0] - top for c, _, top in glyphs])
    left = min([0] + [x for _, x, _ in glyphs])
    out = np.zeros((ascent + descent, width - left), np.uint8)
    for cov, x, top in glyphs:
        r0, c0 = ascent - top, x - left
        view = out[r0:r0 + cov.shape[0], c0:c0 + cov.shape[1]]
        np.maximum(view, cov, out=view)
    return out, ascent, descent


def rotate(mask: np.ndarray, degrees: float) -> np.ndarray:
    """``mask`` turned counterclockwise by ``degrees`` (as matplotlib turns
    text), into the smallest box that holds it; bilinear coverage."""
    if degrees % 360 == 0:
        return mask
    if degrees % 360 == 90:
        return np.ascontiguousarray(np.rot90(mask, 1))
    h, w = mask.shape
    t = math.radians(degrees)
    c, s = math.cos(t), math.sin(t)
    # Source (x right, y up) turned by t: x' = c x - s y, y' = s x + c y.
    corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], float)
    xs = c * corners[:, 0] - s * corners[:, 1]
    ys = s * corners[:, 0] + c * corners[:, 1]
    x0, y1 = xs.min(), ys.max()
    ow, oh = int(math.ceil(xs.max() - x0)), int(math.ceil(y1 - ys.min()))
    px = x0 + np.arange(ow) + 0.5
    py = y1 - (np.arange(oh) + 0.5)
    gx, gy = np.meshgrid(px, py)
    sx = c * gx + s * gy - 0.5           # inverse turn, in pixel-centre units
    sy = -s * gx + c * gy
    sr = (h - sy) - 0.5                  # source rows count down from the top
    src = np.pad(mask.astype(np.float64), 1)
    r0, c0 = np.floor(sr).astype(int), np.floor(sx).astype(int)
    fr, fc = sr - r0, sx - c0
    r0, c0 = np.clip(r0 + 1, 0, h), np.clip(c0 + 1, 0, w)
    val = (src[r0, c0] * (1 - fr) * (1 - fc) + src[r0, c0 + 1] * (1 - fr) * fc
           + src[r0 + 1, c0] * fr * (1 - fc) + src[r0 + 1, c0 + 1] * fr * fc)
    inside = (sr > -1) & (sr < h) & (sx > -1) & (sx < w)
    return np.where(inside, np.rint(val), 0).astype(np.uint8)


def text_mask(s: str, pt: float, dpi: float, rotation: float = 0.0,
              ha: str = "left", va: str = "baseline"):
    """(coverage mask, row offset, column offset): the mask's top-left
    pixel lies at the anchor pixel plus the offsets (rows count down).

    Alignment follows matplotlib's ``rotation_mode="default"``: the text is
    turned first, then the turned box is aligned on the anchor by ``ha``
    (left, center, right) and ``va`` (top, center_baseline, bottom,
    baseline: the box's bottom, or for unturned text its baseline, at the
    anchor)."""
    mask, ascent, descent = layout(s, pt, dpi)
    turned = rotate(mask, rotation)
    h, w = turned.shape
    col = {"left": 0, "center": -(w // 2), "right": -w}[ha]
    if va == "top":
        row = 0
    elif va == "center_baseline":
        row = -(h // 2)
    elif va == "bottom":
        row = -h
    elif va == "baseline":
        row = -ascent if rotation % 360 == 0 else -h
    else:
        raise ValueError(f"unknown vertical alignment {va!r}")
    return turned, row, col
