"""The plain reference of ``predict --plot``: where each figure's dots and
segment lines lie, and in which colour, worked out from the tables the
program printed.

Written from WisecondorX's ``plotter.R`` as the JAX package's matplotlib
translation draws it (``wisecondorx_tpu/output/plots.py``: one genome-wide
figure and one figure per chromosome with data); numpy only, nothing of
the program.  For one sample:

1. each PNG is read by its own chunk reader (signature, every chunk's CRC,
   ``IHDR``), inflated with zlib and un-filtered (filter types 0-4);
2. from ``<outid>_bins.bed`` (ratios; "nan" is an empty bin) and
   ``_segments.bed``, with the per-bin weights of the set-up's reference
   (the dots' areas), each figure's main axes are placed in pixels:
   matplotlib's default subplot box, the genome-wide grid spec, the
   whisker y-limits and the x-margins;
3. every drawn bin's dot is a disc at its data point; at the pixel that
   holds the dot's centre, the dot drawn last among those covering the
   pixel's centre (painter's order: bins in genome order) gives the colour
   class that must be there.  A pixel is excused where a dot whose edge
   passes within :data:`EDGE` px of its centre would change that class,
   where it lies outside the axes or under the genome-wide legend;
4. each segment's line lies at its printed ratio; on the middle row of
   its pixel band, the pixels no dot can reach must read the line colour.

Rasterization is by pixel centres, without antialiasing, as the program's
figures are; nothing here depends on text, ticks or box plots.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
import zlib

import numpy as np

from wcxbench.reference.compare import read_tables
from wcxbench.reference.predict import CHR_NAMES

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: (width, height, dpi) of the figures: 14 x 10 in at 160 dpi genome-wide,
#: 14 x 10 in at 120 dpi per chromosome (the JAX package's plots.py).
GENOME_WIDE = (2240, 1600, 160)
CHROMOSOME = (1680, 1200, 120)
#: matplotlib's rcParams figure.subplot.{left, right, bottom, top}.
SUBPLOT = (0.125, 0.9, 0.11, 0.88)
#: The genome-wide figure: GridSpec(17, 25, hspace=4, wspace=2), main axes
#: on rows 0-9 over every column.
GRID_ROWS, GRID_HSPACE, MAIN_ROWS = 17, 4.0, 10
#: x-margins, as shares of the bins shown: 1 % genome-wide, 2 % a
#: chromosome.
XMARGIN_GENOME, XMARGIN_CHROMOSOME = 0.01, 0.02
#: Genome-wide y-limits: max(0.65, widest upper whisker) and min(-0.95,
#: lowest lower whisker), times 1.25 (plotter.R).
GENOME_Y = (-0.95, 0.65, 1.25)
#: Chromosome y-limits: the whiskers widened by 1.05 down and 0.6 up, or
#: the chromosome's extreme ratios where those lie further out.
CHROMOSOME_Y = (1.05, 0.6)
#: Whiskers: the furthest ratios within 1.5 IQR of the quartiles.
WHIS = 1.5
#: Dot area in pt^2 from a bin's weight: (sqrt(w / pi) * 0.8) * 20
#: (plotter.R:153, its cex taken as matplotlib's area).
DOT_AREA = 16.0
#: A segment line's width in pt: the mean dot area over its bins / 6, at
#: least 0.8.
LINE_FROM_AREA, LINE_MIN = 6.0, 0.8
#: Colour classes: neutral, loss and gain (plotter.R's color.A, .B, .C),
#: and the grey of a segment without a z-score (0.5, rounded half up).
CLASSES = np.array([(84, 84, 84), (227, 200, 138), (141, 209, 198),
                    (128, 128, 128)], dtype=np.uint8)
NEUTRAL, LOSS, GAIN, NO_Z = range(4)
#: The segment lines' colour, #e0e0e0.
LINE = np.array((224, 224, 224), dtype=np.uint8)
#: Distance (px) from a dot's edge within which a pixel centre may lie in
#: or out of the dot: the program's radii come from its own float32
#: weights and its discs are tested in fixed point.
EDGE = 0.5
#: The genome-wide legend (8 pt, no frame) sits at the top of the main
#: axes: 0.5 font sizes from the edge, 0.4 of padding above and below, a
#: title row and an entry row of at most 1.3 font sizes each, 0.5 between
#: them: 4.4 font sizes, taken as 5.  Dots there are not judged.
LEGEND_PT, LEGEND_BAND = 8.0, 5.0


class PngError(ValueError):
    pass


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8-bit RGB PNG as a uint8 array [H, W, 3]; raises
    :class:`PngError` on a bad signature, chunk, CRC, format or length."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise PngError("bad signature")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise PngError("truncated chunk")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if end + 4 > len(data):
            raise PngError("truncated chunk")
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(data[pos + 4:end]) & 0xFFFFFFFF != crc:
            raise PngError(f"CRC mismatch in {kind!r}")
        body = data[pos + 8:end]
        pos = end + 4
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise PngError("no IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace:
        raise PngError(f"depth {depth}, colour type {color}, interlace {interlace}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(str(e)) from None
    stride = 3 * w
    if len(raw) != h * (stride + 1):
        raise PngError(f"{len(raw)} bytes of image data for {w} x {h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    return unfilter(rows[:, 0], rows[:, 1:], 3).reshape(h, w, 3)


def unfilter(kinds: np.ndarray, lines: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters ``kinds`` of ``lines`` (uint8 [h, stride])."""
    if not kinds.any():
        return lines
    out = np.zeros(lines.shape, np.uint8)
    prev = np.zeros(lines.shape[1], np.int64)
    for r, kind in enumerate(kinds):
        line = lines[r].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros_like(line)
            for i in range(len(line)):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise PngError(f"row {r}: filter type {kind}")
        out[r] = cur
        prev = cur
    return out


# ------------------------------------------------------------- the figures

def _whiskers(values: np.ndarray) -> tuple:
    vals = values[~np.isnan(values)]
    if not len(vals):
        return math.nan, math.nan
    q1, q3 = np.percentile(vals, [25, 75])
    iqr = q3 - q1
    return (float(vals[vals >= q1 - WHIS * iqr].min()),
            float(vals[vals <= q3 + WHIS * iqr].max()))


def _main_axes_genome() -> tuple:
    """(left, bottom, width, height), figure fractions."""
    left, right, bottom, top = SUBPLOT
    cell = (top - bottom) / (GRID_ROWS + GRID_HSPACE * (GRID_ROWS - 1))
    height = MAIN_ROWS * cell + (MAIN_ROWS - 1) * GRID_HSPACE * cell
    return left, top - height, right - left, height


def _main_axes_single() -> tuple:
    left, right, bottom, top = SUBPLOT
    return left, bottom, right - left, top - bottom


def _span(a: float, b: float) -> tuple:
    """Pixels [i0, i1) whose centres lie in [a, b), or the pixel holding
    the middle where none does."""
    a, b = min(a, b), max(a, b)
    i0, i1 = math.ceil(a - 0.5), math.ceil(b - 0.5)
    if i1 <= i0:
        i0 = math.floor((a + b) / 2)
        i1 = i0 + 1
    return i0, i1


class Figure:
    """One figure's main axes and what they show: bins [m0, m1) of the
    sample's genome-order arrays and the segments among them."""

    def __init__(self, name, size, bounds, xlim, ylim, m0, m1, segments,
                 genome_wide: bool):
        self.name = name
        self.width, self.height, self.dpi = size
        left, bottom, width, height = bounds
        self.px = (left * self.width, bottom * self.height, width * self.width,
                   height * self.height)
        self.xlim, self.ylim = xlim, ylim
        self.m0, self.m1, self.segments = m0, m1, segments
        self.genome_wide = genome_wide

    def to_pixel(self, x, y):
        """Data to image coordinates (column, row from the top edge)."""
        left, bottom, width, height = self.px
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        col = left + (np.asarray(x, float) - x0) / (x1 - x0) * width
        row = self.height - (bottom + (np.asarray(y, float) - y0) / (y1 - y0) * height)
        return col, row

    def clip(self) -> tuple:
        """(r0, r1, c0, c1): the pixels of the axes."""
        left, bottom, width, height = self.px
        r0, r1 = _span(self.height - (bottom + height), self.height - bottom)
        c0, c1 = _span(left, left + width)
        if self.genome_wide:  # the legend's band
            r0 = math.ceil(r0 + LEGEND_BAND * LEGEND_PT * self.dpi / 72.0)
        return r0, r1, c0, c1


class Sample:
    """What one sample's figures must show, from its printed tables and
    the weights ``w`` (per chromosome) of the reference it was scored
    against."""

    def __init__(self, tables: dict, w: list, ref_gender: str, zscore: float):
        n_chr = 24 if ref_gender == "M" else 23
        r = [np.asarray(x, float) for x in tables["r"][:n_chr]]
        weights = [np.asarray(x, float) for x in w[:n_chr]]
        if len(r) < n_chr or any(len(a) != len(b) for a, b in zip(r, weights)):
            raise ValueError("tables and reference disagree on the bins")
        counts = np.array([len(a) for a in r])
        self.starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.ends = np.cumsum(counts)
        ratio = np.concatenate(r)
        self.ratio = np.where(ratio == 0, np.nan, ratio)
        weight = np.concatenate(weights)
        self.area = np.where(weight > 0, DOT_AREA * np.sqrt(np.maximum(weight, 0) / np.pi), 0.0)
        self.cls = np.full(len(self.ratio), NEUTRAL, np.int64)
        self.segments = []
        index = {name: i for i, name in enumerate(CHR_NAMES)}
        binsize = tables["binsize"]
        for line in tables["segments"]:
            name, start, end, height, z = line.split("\t")[:5]
            c = index[name]
            if c >= n_chr:
                continue
            lo = int(self.starts[c]) + (int(start) - 1) // binsize
            hi = int(self.starts[c]) + int(end) // binsize
            height = float(height)
            self.segments.append((c, lo, hi, height))
            if z == "nan":
                self.cls[lo:hi] = NO_Z
            elif float(z) < -zscore:
                self.cls[lo:hi] = LOSS
            elif float(z) > zscore:
                self.cls[lo:hi] = GAIN
            else:
                self.cls[lo:hi] = NEUTRAL
        self.figures = self._figures(n_chr)

    def _figures(self, n_chr: int) -> list:
        whiskers = [_whiskers(self.ratio[a:b]) for a, b in zip(self.starts, self.ends)]
        lo_w = np.array([w[0] for w in whiskers])
        hi_w = np.array([w[1] for w in whiskers])
        low, high, scale = GENOME_Y
        total = int(self.ends[-1])
        out = [Figure("genome_wide.png", GENOME_WIDE, _main_axes_genome(),
                      (-total * XMARGIN_GENOME, total * (1 + XMARGIN_GENOME)),
                      (np.nanmin([low, np.nanmin(lo_w)]) * scale,
                       np.nanmax([high, np.nanmax(hi_w)]) * scale),
                      0, total, self.segments, genome_wide=True)]
        down, up = CHROMOSOME_Y
        for c in range(n_chr):
            if math.isnan(lo_w[c]) or math.isnan(hi_w[c]):
                continue
            m0, m1 = int(self.starts[c]), int(self.ends[c])
            n = m1 - m0
            values = self.ratio[m0:m1]
            out.append(Figure(
                f"chr{CHR_NAMES[c]}.png", CHROMOSOME, _main_axes_single(),
                (m0 - n * XMARGIN_CHROMOSOME, m1 + n * XMARGIN_CHROMOSOME),
                (min(-down + lo_w[c], np.nanmin(values)),
                 max(up + hi_w[c], np.nanmax(values))),
                m0, m1, [s for s in self.segments if s[0] == c], genome_wide=False))
        return out

    def judge(self, fig: Figure, image: np.ndarray) -> dict:
        """Dots judged and missed, segments judged and differing, of one
        decoded figure."""
        idx = np.arange(fig.m0, fig.m1)
        idx = idx[~np.isnan(self.ratio[idx]) & (self.area[idx] > 0)]
        cx, cy = fig.to_pixel(idx, self.ratio[idx])
        radius = np.sqrt(self.area[idx]) * fig.dpi / 72.0 / 2
        cls = self.cls[idx]
        h, w = fig.height, fig.width
        top = np.full(h * w, -1, np.int64)
        unsure = np.full((len(CLASSES), h * w), -1, np.int64)
        near = np.zeros(h * w, bool)
        fx, fy = np.floor(cx).astype(np.int64), np.floor(cy).astype(np.int64)
        k = int(math.ceil(radius.max() + EDGE)) + 1 if len(idx) else 0
        order = np.arange(len(idx))
        for dy in range(-k, k + 1):
            for dx in range(-k, k + 1):
                px, py = fx + dx, fy + dy
                inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
                d = np.hypot(px + 0.5 - cx, py + 0.5 - cy)
                pix = py * w + px
                sure = inside & ((d <= radius - EDGE) | ((dx == 0) & (dy == 0)))
                np.maximum.at(top, pix[sure], order[sure])
                edge = inside & (np.abs(d - radius) < EDGE) & ~sure
                np.maximum.at(unsure.reshape(-1), cls[edge] * (h * w) + pix[edge],
                              order[edge])
                near[pix[inside & (d < radius + EDGE)]] = True
        r0, r1, c0, c1 = fig.clip()
        own = fy * w + fx
        keep = (fy >= r0) & (fy < r1) & (fx >= c0) & (fx < c1) & (radius >= 2 * EDGE)
        own, expect_at = own[keep], top[own[keep]]
        expect = cls[expect_at]
        flip = np.zeros(len(own), bool)
        for c in range(len(CLASSES)):
            flip |= (expect != c) & (unsure[c][own] > expect_at)
        own, expect = own[~flip], expect[~flip]
        flat = image.reshape(-1, 3)
        missed = int((flat[own] != CLASSES[expect]).any(axis=1).sum())

        # Columns where the genome-wide figure's full-height lines at empty
        # bins, in the segment lines' colour, could stand in for one.
        blocked = np.zeros(w + 2, bool)
        if fig.genome_wide:
            empty = fig.m0 + np.nonzero(np.isnan(self.ratio[fig.m0:fig.m1]))[0]
            x = fig.to_pixel(empty, np.zeros(len(empty)))[0]
            for off in (-1e-6, 1e-6):
                blocked[np.clip(np.floor(x + off).astype(np.int64), -1, w) + 1] = True
        judged = differ = 0
        for _, lo, hi, height in fig.segments:
            lw = (max(float(np.mean(self.area[lo:hi])) / LINE_FROM_AREA, LINE_MIN)
                  if hi > lo else 1.0)
            width = max(lw * fig.dpi / 72.0, 1.0)
            (x0, x1), (y, _) = fig.to_pixel([lo, hi], [height, height])
            j0, j1 = _span(y - width / 2, y + width / 2)
            row = (j0 + j1 - 1) // 2
            if not r0 <= row < r1:
                continue
            i0, i1 = _span(min(x0, x1) - width / 2, max(x0, x1) + width / 2)
            cols = np.arange(max(i0, c0), min(i1, c1))
            cols = cols[~near[row * w + cols] & ~blocked[cols + 1]]
            if not len(cols):
                continue
            judged += 1
            wrong = int((image[row, cols] != LINE).any(axis=1).sum())
            differ += int(2 * wrong > len(cols))
        return {"dots": len(own), "dots_missed": missed,
                "segments": judged, "segments_differ": differ,
                "dots_drawn": len(idx), "segments_drawn": len(fig.segments)}


def figure_dir(outid: str) -> str:
    return f"{outid}.plots"


def digest(outid: str) -> bytes | None:
    """A digest of every file under the sample's figure directory (names
    and bytes), or None where it is missing."""
    d = figure_dir(outid)
    if not os.path.isdir(d):
        return None
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode() + b"\0")
        with open(os.path.join(d, name), "rb") as f:
            h.update(f.read())
    return h.digest()


EMPTY = {"figures_missing": 0, "figure_size_differ": 0, "png_invalid": 0,
         "dots": 0, "dots_missed": 0, "segments": 0, "segments_differ": 0,
         "dots_drawn": 0, "segments_drawn": 0}


def judge_figures(outid: str, sample: Sample) -> dict:
    """The figure numbers of one sample's figure directory against
    ``sample``'s expectations."""
    out = dict(EMPTY)
    for fig in sample.figures:
        path = os.path.join(figure_dir(outid), fig.name)
        if not os.path.exists(path):
            out["figures_missing"] += 1
            continue
        try:
            image = read_png(path)
        except PngError:
            out["png_invalid"] += 1
            continue
        if image.shape != (fig.height, fig.width, 3):
            out["figure_size_differ"] += 1
            continue
        for k, v in sample.judge(fig, image).items():
            out[k] += v
    return out


class FigureCheck:
    """Accumulates the figure numbers of many jobs.  Each distinct set of
    figures of a case is judged and counted once, however many jobs wrote
    it; jobs of one case whose figures differ from the case's first job's
    are nondeterministic."""

    def __init__(self):
        self.first: dict = {}
        self.nondeterministic = 0
        self._memo: dict = {}

    def add(self, outid: str, case, expect) -> None:
        """Judge the figures of the job at ``outid`` (of ``case``);
        ``expect()`` gives the :class:`Sample` they must show, or None
        where its tables are missing."""
        key = digest(outid)
        if key is not None:
            first = self.first.setdefault(case, key)
            self.nondeterministic += int(key != first)
        if (case, key) not in self._memo:
            sample = expect()
            if sample is None:
                numbers = {**EMPTY, "figures_missing": 1}
            elif key is None:
                numbers = {**EMPTY, "figures_missing": len(sample.figures)}
            else:
                numbers = judge_figures(outid, sample)
            self._memo[(case, key)] = numbers

    def totals(self) -> dict:
        """Dots and segment lines judged, and drawn, over the distinct
        figure sets."""
        return {k: sum(x[k] for x in self._memo.values())
                for k in ("dots", "dots_drawn", "segments", "segments_drawn")}

    def numbers(self) -> dict:
        j = list(self._memo.values())
        dots = sum(x["dots"] for x in j)
        return {
            "figures_missing": sum(x["figures_missing"] for x in j),
            "figure_size_differ": sum(x["figure_size_differ"] for x in j),
            "png_invalid": sum(x["png_invalid"] for x in j),
            "figures_nondeterministic": self.nondeterministic,
            "dot_class_miss_share": (sum(x["dots_missed"] for x in j) / dots
                                     if dots else float("inf")),
            "segment_rows_differ": sum(x["segments_differ"] for x in j),
        }


def sample_of(outid: str, w: list, ref_gender: str, binsize: int,
              zscore: float) -> Sample | None:
    """The expectations of the sample whose tables are at ``outid``; None
    where its tables are missing or do not fit the reference."""
    tables = read_tables(outid)
    if tables is None:
        return None
    try:
        return Sample({**tables, "binsize": binsize}, w, ref_gender, zscore)
    except (ValueError, KeyError):
        return None
