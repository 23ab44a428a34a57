"""Rasterizer of the PNG figures: a :class:`Canvas` (uint8 [H, W, 3] on an
explicit torch device) and :func:`render_scene`, which draws a
``layout.Scene`` on it.

Every pixel coordinate, radius and span is computed on the host in float64
and handed to the device as integers, and all compositing is integer,
``(src * a + dst * (255 - a) + 127) // 255`` in int32, so the CPU and a
CUDA device give the same raster bit for bit.  Nothing is antialiased: a
pixel belongs to a shape when its centre does.

* A disc (scatter dot, marker) covers the pixels whose centres lie inside
  it, tested in fixed point (1/64 px) on the device; a disc that covers no
  pixel centre still draws the pixel holding its centre, and a disc of size
  0 draws nothing.  Within one scatter, later dots cover earlier ones: each
  pixel takes the dot of highest draw index (``scatter_reduce`` amax, which
  is deterministic where ``index_put_`` with repeated indices is not).
* Lines are spans ``lw * dpi / 72`` px wide, at least 1 px, solid or dotted
  (matplotlib's ':' pattern: on 1 x lw, off 1.65 x lw points); axis-aligned
  lines are drawn as masks, other polylines as chains of discs.
* Text masks come from ``output.text`` and are blended by their coverage.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wisecondorx_tpu_torch.output import layout as L
from wisecondorx_tpu_torch.output import text as T

#: Sub-pixel units of the disc test.
FP = 64
#: Draws made by :func:`render_scene` in this process (artists, axes,
#: spines, titles, legends and suptitles), read by ``output.plots`` for
#: its raster span.
DRAWS = {"draws": 0}
#: Disc-window elements handled per device step.
DISC_BUDGET = 1 << 22
BLACK = (0.0, 0.0, 0.0, 1.0)
#: Tick length and width, tick label pad, spine width, title pad, label
#: pad (points): matplotlib's defaults.
TICK_LEN, TICK_WIDTH, TICK_PAD = 3.5, 0.8, 3.5
SPINE_WIDTH, TITLE_PAD, LABEL_PAD = 0.8, 6.0, 4.0
#: The ':' pattern in units of the line width.
DOTTED = (1.0, 1.65)
#: Legend spacings in font sizes, its marker size and handle line width
#: in points.
LEGEND = {"borderaxespad": 0.5, "borderpad": 0.4, "handlelength": 2.0,
          "handletextpad": 0.8, "columnspacing": 2.0, "labelspacing": 0.5,
          "markersize": 6.0, "linewidth": 1.5, "framealpha": 0.8,
          "edge": (0.8, 0.8, 0.8, 1.0)}


def rgb8(color) -> tuple:
    return tuple(int(math.floor(float(c) * 255 + 0.5)) for c in color[:3])


def alpha8(color) -> int:
    return int(math.floor(float(color[3]) * 255 + 0.5)) if len(color) > 3 else 255


def span(a: float, b: float) -> tuple:
    """Pixels [i0, i1) whose centres lie in [a, b); the pixel holding the
    middle when there is none (a hairline draws 1 px)."""
    a, b = min(a, b), max(a, b)
    i0, i1 = math.ceil(a - 0.5), math.ceil(b - 0.5)
    if i1 <= i0:
        i0 = math.floor((a + b) / 2)
        i1 = i0 + 1
    return i0, i1


class Canvas:
    """A white uint8 [height, width, 3] image on ``device``."""

    def __init__(self, height: int, width: int, device: torch.device):
        self.h, self.w, self.device = int(height), int(width), torch.device(device)
        self.image = torch.full((self.h, self.w, 3), 255, dtype=torch.uint8,
                                device=self.device)

    def _blend(self, dst: torch.Tensor, alpha, rgb) -> torch.Tensor:
        src = torch.tensor(rgb, dtype=torch.int32, device=self.device)
        d = dst.to(torch.int32)
        return ((src * alpha + d * (255 - alpha) + 127) // 255).to(torch.uint8)

    def _clip(self, r0, r1, c0, c1, clip=None):
        cr0, cr1, cc0, cc1 = clip if clip is not None else (0, self.h, 0, self.w)
        return (max(r0, cr0, 0), min(r1, cr1, self.h),
                max(c0, cc0, 0), min(c1, cc1, self.w))

    def fill(self, r0, r1, c0, c1, color, clip=None):
        """Blend ``color`` (RGBA) over rows [r0, r1) x columns [c0, c1)."""
        r0, r1, c0, c1 = self._clip(r0, r1, c0, c1, clip)
        if r0 >= r1 or c0 >= c1:
            return
        view = self.image[r0:r1, c0:c1]
        view.copy_(self._blend(view, alpha8(color), rgb8(color)))

    def blit(self, mask: np.ndarray, r0: int, c0: int, color, clip=None):
        """Blend ``color`` by the coverage ``mask`` (uint8 [h, w]) with its
        top-left pixel at (r0, c0)."""
        h, w = mask.shape
        cr0, cr1, cc0, cc1 = self._clip(r0, r0 + h, c0, c0 + w, clip)
        if cr0 >= cr1 or cc0 >= cc1:
            return
        m = mask[cr0 - r0:cr1 - r0, cc0 - c0:cc1 - c0].astype(np.int32)
        a = (m * alpha8(color) + 127) // 255
        if not a.any():
            return
        view = self.image[cr0:cr1, cc0:cc1]
        at = torch.as_tensor(a, device=self.device)[..., None]
        view.copy_(self._blend(view, at, rgb8(color)))

    def columns(self, cols: np.ndarray, r0: int, r1: int, color, clip=None):
        """1-px-wide vertical lines at ``cols`` over rows [r0, r1); lines
        on one column blend once each, as separate strokes do."""
        r0, r1, _, _ = self._clip(r0, r1, 0, self.w, clip)
        cr = clip if clip is not None else (0, self.h, 0, self.w)
        cols = np.asarray(cols, np.int64)
        cols = cols[(cols >= max(cr[2], 0)) & (cols < min(cr[3], self.w))]
        if r0 >= r1 or not len(cols):
            return
        uniq, counts = np.unique(cols, return_counts=True)
        for k in range(1, int(counts.max()) + 1):
            idx = torch.as_tensor(uniq[counts >= k], device=self.device)
            band = self.image[r0:r1]
            band[:, idx] = self._blend(band[:, idx], alpha8(color), rgb8(color))

    def discs(self, x, y, r_out, colors, clip=None, r_in=None):
        """Discs (or, with ``r_in``, rings r_in <= d <= r_out) centred at
        image coordinates (x, y) (columns, rows; pixel centres at half
        integers), radii in px, uint8 RGB ``colors`` [n, 3], in painter's
        order."""
        x, y = np.asarray(x, float), np.asarray(y, float)
        r_out = np.broadcast_to(np.asarray(r_out, float), x.shape)
        keep = (r_out > 0) & np.isfinite(x) & np.isfinite(y)
        if not keep.any():
            return
        x, y, r_out = x[keep], y[keep], r_out[keep]
        colors = np.broadcast_to(np.asarray(colors, np.uint8), (len(keep), 3))[keep]
        r_in = (np.full(len(x), -1.0) if r_in is None else
                np.broadcast_to(np.asarray(r_in, float), keep.shape)[keep])
        cx, cy = np.rint(x * FP).astype(np.int64), np.rint(y * FP).astype(np.int64)
        ro2 = np.rint((r_out * FP) ** 2).astype(np.int64)
        ri2 = np.where(r_in > 0, np.rint((np.maximum(r_in, 0) * FP) ** 2), -1).astype(np.int64)
        c_lo = np.floor(x - r_out).astype(np.int64)
        r_lo = np.floor(y - r_out).astype(np.int64)
        centre = np.stack([np.floor(y).astype(np.int64) - r_lo,
                           np.floor(x).astype(np.int64) - c_lo], axis=1)
        k = int(math.ceil(2 * r_out.max())) + 2
        cr0, cr1, cc0, cc1 = self._clip(0, self.h, 0, self.w, clip)
        dev = self.device
        buf = torch.full((self.h * self.w + 1,), -1, dtype=torch.int64, device=dev)
        offs = torch.arange(k, dtype=torch.int64, device=dev)
        step = max(1, DISC_BUDGET // (k * k))
        for s in range(0, len(x), step):
            sl = slice(s, s + step)
            t = {n: torch.as_tensor(np.ascontiguousarray(v[sl]), device=dev)
                 for n, v in (("cx", cx), ("cy", cy), ("ro2", ro2), ("ri2", ri2),
                              ("c_lo", c_lo), ("r_lo", r_lo), ("centre", centre))}
            cols = t["c_lo"][:, None] + offs              # [n, k]
            rows = t["r_lo"][:, None] + offs
            dx = cols * FP + FP // 2 - t["cx"][:, None]
            dy = rows * FP + FP // 2 - t["cy"][:, None]
            d2 = dy[:, :, None] ** 2 + dx[:, None, :] ** 2  # [n, k, k]
            inside = (d2 <= t["ro2"][:, None, None]) & (d2 >= t["ri2"][:, None, None])
            empty = ~inside.flatten(1).any(dim=1)
            n = len(t["cx"])
            inside[torch.arange(n, device=dev), t["centre"][:, 0].clamp(0, k - 1),
                   t["centre"][:, 1].clamp(0, k - 1)] |= empty
            r_all = rows[:, :, None].expand(n, k, k)
            c_all = cols[:, None, :].expand(n, k, k)
            inside &= (r_all >= cr0) & (r_all < cr1) & (c_all >= cc0) & (c_all < cc1)
            pix = torch.where(inside, r_all * self.w + c_all, self.h * self.w)
            ids = torch.arange(s, s + n, dtype=torch.int64, device=dev)
            buf.scatter_reduce_(0, pix.flatten(), ids[:, None, None].expand(n, k, k).flatten(),
                                reduce="amax", include_self=True)
        win = buf[:-1]
        hit = win >= 0
        flat = self.image.view(-1, 3)
        flat[hit] = torch.as_tensor(np.ascontiguousarray(colors), device=dev)[win[hit]]

    def segment(self, x0, y0, x1, y1, width, color, clip=None, dash=None,
                cap=0.0):
        """An axis-aligned segment between image points, ``width`` px wide,
        extended by ``cap`` px at both ends; ``dash`` = (on, off) px from
        the first point."""
        horizontal = abs(y1 - y0) <= abs(x1 - x0)
        if horizontal:
            a, b, start, mid = min(x0, x1), max(x0, x1), x0, y0
        else:
            a, b, start, mid = min(y0, y1), max(y0, y1), y0, x0
        i0, i1 = span(a - cap, b + cap)
        j0, j1 = span(mid - width / 2, mid + width / 2)
        on = np.ones(i1 - i0, bool)
        if dash is not None:
            pos = np.abs(np.arange(i0, i1) + 0.5 - start)
            on = np.mod(pos, dash[0] + dash[1]) < dash[0]
        line = np.repeat((on * 255).astype(np.uint8)[None, :], j1 - j0, axis=0)
        if horizontal:
            self.blit(line, j0, i0, color, clip)
        else:
            self.blit(np.ascontiguousarray(line.T), i0, j0, color, clip)

    def polyline(self, xs, ys, width, color, clip=None):
        """A polyline through image points: discs of the line's width every
        quarter pixel along it."""
        if alpha8(color) != 255:
            raise ValueError("polylines are drawn opaque")
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        pts_x, pts_y = [xs[:1]], [ys[:1]]
        for i in range(1, len(xs)):
            n = max(1, int(math.ceil(math.hypot(xs[i] - xs[i - 1], ys[i] - ys[i - 1]) / 0.25)))
            t = np.arange(1, n + 1) / n
            pts_x.append(xs[i - 1] + (xs[i] - xs[i - 1]) * t)
            pts_y.append(ys[i - 1] + (ys[i] - ys[i - 1]) * t)
        px, py = np.concatenate(pts_x), np.concatenate(pts_y)
        self.discs(px, py, np.full(len(px), max(width, 1.0) / 2), [rgb8(color)],
                   clip)


# -------------------------------------------------------------------- scenes

def _pt(scene, pts):
    return pts * scene.dpi / 72.0


def _clip_rect(scene, ax):
    left, bottom, width, height = L.axes_px(scene, ax)
    top = scene.height - (bottom + height)
    r0, r1 = span(top, scene.height - bottom)
    c0, c1 = span(left, left + width)
    return (r0, r1, c0, c1)


def _draw_line(canvas, scene, ax, line, clip):
    xs, _ = L.to_pixel(scene, ax, line.x, np.zeros(len(line.x)))
    if line.yaxes:
        _, bottom, _, height = L.axes_px(scene, ax)
        ys = scene.height - (bottom + np.asarray(line.y, float) * height)
    else:
        _, ys = L.to_pixel(scene, ax, np.zeros(len(line.y)), line.y)
    width = max(_pt(scene, line.lw), 1.0)
    dash = None
    cap = width / 2
    if line.ls == ":":
        dash = tuple(_pt(scene, line.lw * d) for d in DOTTED)
        cap = 0.0
    pairs = list(zip(range(len(xs) - 1), range(1, len(xs))))
    if all(xs[i] == xs[j] or ys[i] == ys[j] for i, j in pairs):
        for i, j in pairs:
            canvas.segment(xs[i], ys[i], xs[j], ys[j], width, line.color, clip,
                           dash, cap)
    else:
        canvas.polyline(xs, ys, width, line.color, clip)


def _draw_artist(canvas, scene, ax, a, clip):
    if isinstance(a, L.Scatter):
        x, y = L.to_pixel(scene, ax, a.x, a.y)
        r = np.sqrt(np.asarray(a.sizes, float)) * scene.dpi / 72.0 / 2
        colors = np.floor(np.asarray(a.colors, float)[:, :3] * 255 + 0.5).astype(np.uint8)
        if a.ring_lw is None:
            canvas.discs(x, y, r, colors, clip)
        else:
            half = _pt(scene, a.ring_lw) / 2
            canvas.discs(x, y, r + half, colors, clip, r_in=r - half)
    elif isinstance(a, L.Markers):
        x, y = L.to_pixel(scene, ax, a.x, a.y)
        canvas.discs(x, y, _pt(scene, a.size) / 2, [rgb8(a.color)], clip)
    elif isinstance(a, L.Rect):
        x, y = L.to_pixel(scene, ax, [a.x, a.x + a.width], [a.y, a.y + a.height])
        c0, c1 = span(*x)
        r0, r1 = span(*y)
        canvas.fill(r0, r1, c0, c1, a.color, clip)
    elif isinstance(a, L.Bars):
        lefts, rights = a.left, a.left + a.width
        for l, r, h in zip(lefts, rights, a.height):
            x, y = L.to_pixel(scene, ax, [l, r], [0.0, h])
            c0, c1 = math.ceil(x[0] - 0.5), math.ceil(x[1] - 0.5)
            r0, r1 = math.ceil(min(y) - 0.5), math.ceil(max(y) - 0.5)
            canvas.fill(r0, r1, c0, c1, a.color, clip)
    elif isinstance(a, L.Line):
        _draw_line(canvas, scene, ax, a, clip)
    elif isinstance(a, L.VLines):
        x, y = L.to_pixel(scene, ax, a.x, np.zeros(len(a.x)))
        _, (yt, yb) = L.to_pixel(scene, ax, [0, 0], [a.ymax, a.ymin])
        width = _pt(scene, a.lw)
        r0, r1 = span(yt, yb)
        starts = [span(c - width / 2, c + width / 2) for c in x]
        if all(s[1] - s[0] == 1 for s in starts):
            canvas.columns(np.array([s[0] for s in starts], np.int64), r0, r1,
                           a.color, clip)
        else:
            for c in x:
                canvas.segment(c, yt, c, yb, width, a.color, clip)
    elif isinstance(a, L.Text):
        x, y = L.to_pixel(scene, ax, [a.x], [a.y])
        _text(canvas, scene, float(x[0]), float(y[0]), a.s, a.fontsize, a.color,
              a.rotation, a.ha, a.va)
    elif isinstance(a, L.BoxSpan):
        pass
    else:
        raise TypeError(f"cannot draw {type(a).__name__}")


def _text(canvas, scene, x, y, s, fontsize, color, rotation=0.0, ha="left",
          va="baseline"):
    """Draw ``s`` anchored at image point (x, y); returns its pixel box
    (r0, r1, c0, c1)."""
    mask, dr, dc = T.text_mask(s, fontsize, scene.dpi, rotation, ha, va)
    r0, c0 = int(math.floor(y + 0.5)) + dr, int(math.floor(x + 0.5)) + dc
    canvas.blit(mask, r0, c0, color)
    return r0, r0 + mask.shape[0], c0, c0 + mask.shape[1]


def _draw_axis(canvas, scene, ax):
    """Tick marks, tick labels, the offset text and the ylabel."""
    left, bottom, width, height = L.axes_px(scene, ax)
    row_bottom = scene.height - bottom
    row_top = scene.height - (bottom + height)
    tick_w, tick_len = _pt(scene, TICK_WIDTH), _pt(scene, TICK_LEN)
    pad = tick_len + _pt(scene, TICK_PAD)
    xs, _ = L.to_pixel(scene, ax, ax.xticks.locs, np.zeros(len(ax.xticks.locs)))
    for x, label in zip(xs, ax.xticks.labels):
        canvas.segment(x, row_bottom, x, row_bottom + tick_len, tick_w, BLACK)
        _text(canvas, scene, x, row_bottom + pad, label, ax.xticks.fontsize, BLACK,
              ax.xticks.rotation, "center", "top")
    _, ys = L.to_pixel(scene, ax, np.zeros(len(ax.yticks.locs)), ax.yticks.locs)
    label_left = left
    for y, label in zip(ys, ax.yticks.labels):
        canvas.segment(left, y, left - tick_len, y, tick_w, BLACK)
        box = _text(canvas, scene, left - pad, y, label, ax.yticks.fontsize, BLACK,
                    ax.yticks.rotation, "right", "center_baseline")
        label_left = min(label_left, box[2])
    if ax.yticks.offset_text:
        _text(canvas, scene, left, row_top - _pt(scene, 2.0), ax.yticks.offset_text,
              ax.yticks.fontsize, BLACK, 0.0, "left", "bottom")
    if ax.ylabel:
        mask, _, _ = T.text_mask(ax.ylabel, 10.0, scene.dpi, 90.0)
        r0 = int(math.floor(row_top + height / 2)) - mask.shape[0] // 2
        c0 = int(math.floor(label_left - _pt(scene, LABEL_PAD))) - mask.shape[1]
        canvas.blit(mask, r0, c0, BLACK)


def _draw_spines(canvas, scene, ax):
    left, bottom, width, height = L.axes_px(scene, ax)
    w = _pt(scene, SPINE_WIDTH)
    top_r, bot_r = scene.height - (bottom + height), scene.height - bottom
    right = left + width
    for x0, y0, x1, y1 in ((left, top_r, left, bot_r), (right, top_r, right, bot_r),
                           (left, top_r, right, top_r), (left, bot_r, right, bot_r)):
        canvas.segment(x0, y0, x1, y1, w, BLACK, cap=w / 2)


def legend_layout(scene, ax):
    """(box (r0, r1, c0, c1), [(kind, geometry...)]) of the legend of
    ``ax``: its frame and, for the title and each entry, where its text
    and handle go."""
    lg = ax.legend
    fs = _pt(scene, lg.fontsize)
    left, bottom, width, height = L.axes_px(scene, ax)
    row_top = scene.height - (bottom + height)
    masks = [T.layout(e.label, lg.fontsize, scene.dpi)[0] for e in lg.entries]
    title = T.layout(lg.title, lg.fontsize, scene.dpi)[0] if lg.title else None
    hl, hp = LEGEND["handlelength"] * fs, LEGEND["handletextpad"] * fs
    row_h = max([m.shape[0] for m in masks] + [int(fs)])
    nrow = -(-len(masks) // lg.ncol)
    cols = [list(range(c * nrow, min((c + 1) * nrow, len(masks))))
            for c in range(lg.ncol)]
    col_w = [max(hl + hp + masks[i].shape[1] for i in col) for col in cols if col]
    inner_w = sum(col_w) + LEGEND["columnspacing"] * fs * (len(col_w) - 1)
    title_h = title.shape[0] + LEGEND["labelspacing"] * fs if title is not None else 0
    inner_w = max(inner_w, title.shape[1] if title is not None else 0)
    inner_h = title_h + nrow * row_h + (nrow - 1) * LEGEND["labelspacing"] * fs
    bp, ba = LEGEND["borderpad"] * fs, LEGEND["borderaxespad"] * fs
    box_w, box_h = inner_w + 2 * bp, inner_h + 2 * bp
    top = row_top + ba
    if lg.loc == "upper center":
        x0 = left + width / 2 - box_w / 2
    elif lg.loc == "upper right":
        x0 = left + width - ba - box_w
    else:
        raise ValueError(f"unsupported legend location {lg.loc!r}")
    items = []
    if title is not None:
        items.append(("text", title, top + bp, x0 + box_w / 2 - title.shape[1] / 2,
                      BLACK))
    y = top + bp + title_h
    x = x0 + bp + (inner_w - sum(col_w) - LEGEND["columnspacing"] * fs
                   * (len(col_w) - 1)) / 2
    for col, cw in zip(cols, col_w):
        for r, i in enumerate(col):
            e, ry = lg.entries[i], y + r * (row_h + LEGEND["labelspacing"] * fs)
            mid = ry + row_h / 2
            items.append(("handle", e, x, x + hl, mid))
            items.append(("text", masks[i], ry + (row_h - masks[i].shape[0]) / 2,
                          x + hl + hp, BLACK))
        x += cw + LEGEND["columnspacing"] * fs
    box = (int(math.floor(top)), int(math.ceil(top + box_h)),
           int(math.floor(x0)), int(math.ceil(x0 + box_w)))
    return box, items


def _draw_legend(canvas, scene, ax):
    lg = ax.legend
    box, items = legend_layout(scene, ax)
    if lg.frameon:
        canvas.fill(*box, (1.0, 1.0, 1.0, LEGEND["framealpha"]))
        r0, r1, c0, c1 = box
        for seg in ((c0, r0, c1 - 1, r0), (c0, r1 - 1, c1 - 1, r1 - 1),
                    (c0, r0, c0, r1 - 1), (c1 - 1, r0, c1 - 1, r1 - 1)):
            canvas.segment(seg[0] + 0.5, seg[1] + 0.5, seg[2] + 0.5, seg[3] + 0.5,
                           1.0, LEGEND["edge"], cap=0.5)
    for item in items:
        if item[0] == "text":
            _, mask, r, c, color = item
            canvas.blit(mask, int(math.floor(r + 0.5)), int(math.floor(c + 0.5)), color)
            continue
        _, e, x0, x1, mid = item
        if e.marker:
            canvas.discs([(x0 + x1) / 2], [mid], _pt(scene, LEGEND["markersize"]) / 2,
                         [rgb8(e.color)])
        else:
            lw = LEGEND["linewidth"]
            dash = (tuple(_pt(scene, lw * d) for d in DOTTED) if e.ls == ":"
                    else None)
            w = max(_pt(scene, lw), 1.0)
            canvas.segment(x0, mid, x1, mid, w, e.color, dash=dash)


def render_scene(scene: L.Scene, device: torch.device) -> torch.Tensor:
    """The raster of ``scene`` on ``device``: uint8 [height, width, 3]."""
    canvas = Canvas(scene.height, scene.width, device)
    for ax in scene.axes:
        clip = _clip_rect(scene, ax)
        draws = [(a.zorder, i, lambda a=a: _draw_artist(canvas, scene, ax, a, clip))
                 for i, a in enumerate(ax.artists)]
        n = len(draws)
        draws += [(1.5, n, lambda: _draw_axis(canvas, scene, ax)),
                  (2.5, n + 1, lambda: _draw_spines(canvas, scene, ax))]
        if ax.title:
            left, bottom, width, height = L.axes_px(scene, ax)
            draws.append((3.0, n + 2, lambda: _text(
                canvas, scene, left + width / 2,
                scene.height - (bottom + height) - _pt(scene, TITLE_PAD),
                ax.title, 12.0, BLACK, 0.0, "center", "baseline")))
        if ax.legend is not None:
            draws.append((5.0, n + 3, lambda: _draw_legend(canvas, scene, ax)))
        for _, _, draw in sorted(draws, key=lambda d: (d[0], d[1])):
            draw()
        DRAWS["draws"] += len(draws)
    if scene.suptitle is not None:
        t = scene.suptitle
        _text(canvas, scene, t.x * scene.width, scene.height * (1 - t.y), t.s,
              t.fontsize, t.color, 0.0, t.ha, t.va)
        DRAWS["draws"] += 1
    return canvas.image
