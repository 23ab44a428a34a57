"""Geometry of the PNG figures, all host float64 numpy: the scene that
describes a figure, matplotlib's default subplot and grid-spec arithmetic,
the data-to-pixel transform, autoscaling, box-plot statistics, and tick
locations and labels.

The functions reproduce the rules of matplotlib (3.10) that the JAX
package's figures rely on, with matplotlib's own arithmetic, so a scene's
positions, limits, ticks and labels equal the JAX figure's:

* subplot parameters left 0.125, right 0.9, bottom 0.11, top 0.88, wspace
  and hspace 0.2 (``GridSpec.get_grid_positions``);
* autoscaling: the data limits of every artist, 5 % margins, no margin
  past a sticky edge (``Axes.autoscale_view``);
* ``cbook.boxplot_stats`` with whis 1.5;
* ``AutoLocator`` (``MaxNLocator`` with nbins 'auto' and steps 1, 2, 2.5,
  5, 10) and ``ScalarFormatter`` with the unicode minus; only ticks inside
  the view are kept.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

SUBPLOT = {"left": 0.125, "right": 0.9, "bottom": 0.11, "top": 0.88,
           "wspace": 0.2, "hspace": 0.2}
#: axes.xmargin / axes.ymargin.
MARGIN = 0.05
#: xtick.labelsize / ytick.labelsize ("medium") in points: the size the
#: tick space is taken at, whatever size the labels are drawn at.
TICK_LABEL_PT = 10.0
#: AutoLocator's steps, extended as MaxNLocator extends them.
_STEPS = np.array([1, 2, 2.5, 5, 10], dtype=float)
_EXTENDED_STEPS = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])
MINUS = "\N{MINUS SIGN}"
#: axes.formatter.limits and axes.formatter.offset_threshold.
POWER_LIMITS = (-5, 6)
OFFSET_THRESHOLD = 4


# --------------------------------------------------------------------- scene

@dataclasses.dataclass
class Scatter:
    """Filled discs of ``sizes`` pt² (matplotlib's ``s``), drawn in order;
    or, with ``ring_lw`` set, open rings of that line width."""
    x: np.ndarray
    y: np.ndarray
    colors: np.ndarray          # [n, 3] floats in [0, 1]
    sizes: np.ndarray           # [n] pt²
    zorder: float = 1.0
    ring_lw: float | None = None


@dataclasses.dataclass
class Markers:
    """Line markers of one colour (box-plot fliers): discs ``size`` pt
    across."""
    x: np.ndarray
    y: np.ndarray
    color: tuple
    size: float
    zorder: float = 2.0


@dataclasses.dataclass
class Rect:
    x: float
    y: float
    width: float
    height: float
    color: tuple                # RGBA
    zorder: float = 1.0


@dataclasses.dataclass
class Line:
    """A polyline in data coordinates; with ``yaxes`` its y values are
    axes fractions (``axvline``)."""
    x: np.ndarray
    y: np.ndarray
    color: tuple                # RGBA
    lw: float
    ls: str = "-"               # "-" or ":"
    zorder: float = 2.0
    yaxes: bool = False


@dataclasses.dataclass
class VLines:
    x: np.ndarray
    ymin: float
    ymax: float
    color: tuple                # RGBA
    lw: float
    zorder: float = 1.0


@dataclasses.dataclass
class Bars:
    """Histogram bars from y = 0."""
    left: np.ndarray
    width: np.ndarray
    height: np.ndarray
    color: tuple
    zorder: float = 1.0


@dataclasses.dataclass
class Text:
    x: float
    y: float
    s: str
    color: tuple
    fontsize: float
    rotation: float = 0.0
    ha: str = "left"
    va: str = "baseline"
    zorder: float = 3.0


@dataclasses.dataclass
class Ticks:
    """The ticks inside the view: locations and label strings."""
    locs: np.ndarray
    labels: list
    fontsize: float = TICK_LABEL_PT
    rotation: float = 0.0
    offset_text: str = ""


@dataclasses.dataclass
class LegendEntry:
    label: str
    color: tuple
    marker: bool                # a marker "o" handle, else a line
    ls: str = ":"


@dataclasses.dataclass
class Legend:
    entries: list
    loc: str                    # "upper center" or "upper right"
    fontsize: float
    title: str = ""
    ncol: int = 1
    frameon: bool = True


@dataclasses.dataclass
class Axes:
    bounds: tuple               # (left, bottom, width, height), figure fractions
    xlim: tuple
    ylim: tuple
    artists: list
    xticks: Ticks
    yticks: Ticks
    ylabel: str = ""
    title: str = ""
    legend: Legend | None = None
    box_stats: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Scene:
    """One figure: its file name, pixel size, dpi, axes and suptitle."""
    name: str
    width: int
    height: int
    dpi: float
    axes: list
    suptitle: Text | None = None


# ------------------------------------------------------------------ geometry

def grid_bounds(nrows, ncols, rows: slice, cols: slice, hspace=None,
                wspace=None):
    """``get_position().bounds`` of the subplot ``gs[rows, cols]`` of a
    GridSpec(nrows, ncols) on a figure with the default subplot
    parameters (``plt.subplots()`` is the 1 x 1 grid)."""
    left, right = SUBPLOT["left"], SUBPLOT["right"]
    bottom, top = SUBPLOT["bottom"], SUBPLOT["top"]
    hspace = SUBPLOT["hspace"] if hspace is None else hspace
    wspace = SUBPLOT["wspace"] if wspace is None else wspace
    tot_width, tot_height = right - left, top - bottom
    # matplotlib's operations in its order (equal height and width ratios),
    # so the bounds agree to the last bit.
    cell_h = tot_height / (nrows + hspace * (nrows - 1))
    sep_h = hspace * cell_h
    norm = cell_h * nrows / nrows
    cell_heights = [1 * norm for _ in range(nrows)]
    sep_heights = [0] + ([sep_h] * (nrows - 1))
    cell_hs = np.cumsum(np.column_stack([sep_heights, cell_heights]).flat)
    cell_w = tot_width / (ncols + wspace * (ncols - 1))
    sep_w = wspace * cell_w
    norm = cell_w * ncols / ncols
    cell_widths = [1 * norm for _ in range(ncols)]
    sep_widths = [0] + ([sep_w] * (ncols - 1))
    cell_ws = np.cumsum(np.column_stack([sep_widths, cell_widths]).flat)
    fig_tops, fig_bottoms = (top - cell_hs).reshape((-1, 2)).T
    fig_lefts, fig_rights = (left + cell_ws).reshape((-1, 2)).T
    r = [rows.start or 0, (rows.stop or nrows) - 1]
    c = [cols.start or 0, (cols.stop or ncols) - 1]
    x0, y0 = fig_lefts[c].min(), fig_bottoms[r].min()
    x1, y1 = fig_rights[c].max(), fig_tops[r].max()
    return (float(x0), float(y0), float(x1 - x0), float(y1 - y0))


def axes_px(scene: Scene, ax: Axes):
    """(left, bottom, width, height) of ``ax`` in display pixels (y up)."""
    b = ax.bounds
    return (b[0] * scene.width, b[1] * scene.height, b[2] * scene.width,
            b[3] * scene.height)


def to_display(scene: Scene, ax: Axes, x, y):
    """Data coordinates to display pixels (x right, y up from the bottom
    edge), as matplotlib's ``transData``."""
    left, bottom, width, height = axes_px(scene, ax)
    (x0, x1), (y0, y1) = ax.xlim, ax.ylim
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    return (left + (x - x0) / (x1 - x0) * width,
            bottom + (y - y0) / (y1 - y0) * height)


def to_pixel(scene: Scene, ax: Axes, x, y):
    """Data coordinates to image coordinates (column, row; rows count down
    from the top edge, pixel centres at half-integers)."""
    dx, dy = to_display(scene, ax, x, y)
    return dx, scene.height - dy


def tick_space(length_px: float, dpi: float, factor: float) -> int:
    """``Axis.get_tick_space``: the axis length in points over ``factor``
    times the tick label size (3 for x, 2 for y)."""
    return int(np.floor(length_px / dpi * 72 / (TICK_LABEL_PT * factor)))


# ----------------------------------------------------------------- autoscale

def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """``matplotlib.transforms.nonsingular`` (increasing)."""
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


def autoscale(lo: float, hi: float, stickies=()):
    """The view interval ``autoscale_view`` gives data limits (lo, hi)
    with the artists' sticky edges, on a linear axis."""
    x0, x1 = nonsingular(lo, hi, expander=0.05)
    stickies = np.sort(np.asarray(stickies, float))
    tol = 1e-5 * abs(x1 - x0)
    i0 = stickies.searchsorted(x0 + tol) - 1
    x0bound = stickies[i0] if i0 != -1 else None
    i1 = stickies.searchsorted(x1 - tol)
    x1bound = stickies[i1] if i1 != len(stickies) else None
    delta = (x1 - x0) * MARGIN
    if not np.isfinite(delta):
        delta = 0
    x0, x1 = x0 - delta, x1 + delta
    if x0bound is not None:
        x0 = max(x0, x0bound)
    if x1bound is not None:
        x1 = min(x1, x1bound)
    x0, x1 = nonsingular(x0, x1, expander=1e-12, tiny=1e-13)
    return float(x0), float(x1)


def data_limits(artists):
    """(xmin, xmax, ymin, ymax, x stickies, y stickies) over ``artists``,
    as the axes' dataLim and the artists' sticky edges hold them."""
    xs, ys, sx, sy = [], [], [], []
    for a in artists:
        if isinstance(a, (Line, Markers)) and not getattr(a, "yaxes", False):
            xs.append(a.x)
            ys.append(a.y)
        elif isinstance(a, Bars):
            xs += [a.left, a.left + a.width]
            ys += [np.zeros(len(a.height)), a.height]
            sy.append(np.zeros(len(a.height)))
        elif isinstance(a, BoxSpan):
            xs.append(a.interval)
            sx.append(a.stickies)
        else:
            raise TypeError(f"no data limits for {type(a).__name__}")
    x = np.concatenate([np.asarray(v, float).ravel() for v in xs]) if xs else np.array([])
    y = np.concatenate([np.asarray(v, float).ravel() for v in ys]) if ys else np.array([])
    x, y = x[np.isfinite(x)], y[np.isfinite(y)]
    return (x.min() if len(x) else np.inf, x.max() if len(x) else -np.inf,
            y.min() if len(y) else np.inf, y.max() if len(y) else -np.inf,
            np.concatenate(sx) if sx else np.array([]),
            np.concatenate(sy) if sy else np.array([]))


@dataclasses.dataclass
class BoxSpan:
    """What ``bxp`` adds to the x data limits (positions +- 0.5) and the
    sticky edges it puts on the median lines.  Not drawn."""
    interval: np.ndarray
    stickies: np.ndarray
    zorder: float = 0.0


def autoscale_axes(ax: Axes):
    """Fill in the limits of ``ax`` that are None by autoscaling."""
    if ax.xlim is not None and ax.ylim is not None:
        return
    x0, x1, y0, y1, sx, sy = data_limits(ax.artists)
    if ax.xlim is None:
        ax.xlim = autoscale(x0, x1, sx)
    if ax.ylim is None:
        ax.ylim = autoscale(y0, y1, sy)


# -------------------------------------------------------------- box plots

def boxplot_stats(x, whis: float = 1.5) -> dict:
    """``matplotlib.cbook.boxplot_stats`` of one data set."""
    x = np.asarray(x, float).ravel()
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    iqr = q3 - q1
    loval, hival = q1 - whis * iqr, q3 + whis * iqr
    wiskhi = x[x <= hival]
    whishi = q3 if len(wiskhi) == 0 or np.max(wiskhi) < q3 else np.max(wiskhi)
    wisklo = x[x >= loval]
    whislo = q1 if len(wisklo) == 0 or np.min(wisklo) > q1 else np.min(wisklo)
    fliers = np.concatenate([x[x < whislo], x[x > whishi]])
    return {"med": med, "q1": q1, "q3": q3, "iqr": iqr, "whislo": whislo,
            "whishi": whishi, "fliers": fliers, "mean": np.mean(x)}


def boxplot(data, flier_size: float):
    """(artists, stats) of ``Axes.boxplot(data)`` with default styling and
    markersize ``flier_size`` fliers: for each box, in bxp's order, the box
    outline, two whiskers, two caps, the median and the fliers."""
    black, orange = (0.0, 0.0, 0.0, 1.0), (1.0, 0.4980392156862745,
                                           0.054901960784313725, 1.0)
    positions = np.array(list(range(1, len(data) + 1)))
    width = np.clip(0.15 * np.ptp(positions), 0.15, 0.5)
    capwidth = 0.5 * np.array([width] * len(data))[0]
    artists, stats = [], []
    for pos, x in zip(positions, data):
        st = boxplot_stats(x)
        stats.append(st)
        cap_x = np.array([pos - capwidth * 0.5, pos + capwidth * 0.5])
        box_left, box_right = pos - width * 0.5, pos + width * 0.5
        box_x = np.array([box_left, box_right, box_right, box_left, box_left])
        box_y = np.array([st["q1"], st["q1"], st["q3"], st["q3"], st["q1"]])
        artists += [
            Line(box_x, box_y, black, 1.0),
            Line(np.array([pos, pos], float), np.array([st["q1"], st["whislo"]]), black, 1.0),
            Line(np.array([pos, pos], float), np.array([st["q3"], st["whishi"]]), black, 1.0),
            Line(cap_x, np.full(2, st["whislo"]), black, 1.0),
            Line(cap_x, np.full(2, st["whishi"]), black, 1.0),
            Line(np.array([box_left, box_right]), np.array([st["med"], st["med"]]),
                 orange, 1.0, zorder=2.1),
            Markers(np.full(len(st["fliers"]), pos, dtype=np.float64),
                    st["fliers"], black, flier_size),
        ]
    artists.append(BoxSpan(
        np.array([positions.min() - .5, positions.max() + .5], float),
        np.concatenate([[p - .5, p + .5] for p in positions]).astype(float)))
    return artists, stats


# --------------------------------------------------------------------- ticks

def in_view(locs, lo, hi):
    """Which ``locs`` an axis with view (lo, hi) draws
    (``_interval_contains_close``, rtol 1e-10)."""
    a, b = sorted((lo, hi))
    tol = (b - a) * 1e-10
    locs = np.asarray(locs, float)
    return (a - tol <= locs) & (locs <= b + tol)


def max_n_locator(vmin, vmax, nbins_space: int):
    """``AutoLocator().tick_values`` with nbins 'auto' on an axis whose
    tick space is ``nbins_space`` (min_n_ticks 2)."""
    min_n_ticks = 2
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    nbins = int(np.clip(nbins_space, max(1, min_n_ticks - 1), 9))
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0 if abs(meanv) / dv < 100 else math.copysign(
        10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXTENDED_STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if any(large) else len(steps) - 1
    ticks = None
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        low = _edge_le(_vmin - best_vmin, step, offset)
        high = _edge_ge(_vmax - best_vmin, step, offset)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset


def _edge_tol(step, offset):
    offset = abs(offset)
    if offset > 0:
        digits = np.log10(offset / step)
        return min(0.4999, max(1e-10, 10 ** (digits - 12)))
    return 1e-10


def _edge_le(x, step, offset):
    d, m = divmod(x, step)
    return d + 1 if abs(m / step - 1) < _edge_tol(step, offset) else d


def _edge_ge(x, step, offset):
    d, m = divmod(x, step)
    return d if abs(m / step) < _edge_tol(step, offset) else d + 1


def _fix_minus(s: str) -> str:
    return s.replace("-", MINUS)


def scalar_format(locs, vmin, vmax):
    """(labels, offset text) of ``ScalarFormatter`` for tick locations
    ``locs`` (all of the locator's, inside the view or not) on an axis with
    view (vmin, vmax)."""
    locs = np.asarray(locs, float)
    if not len(locs):
        return [], ""
    lo, hi = sorted((vmin, vmax))
    vis = locs[(lo <= locs) & (locs <= hi)]
    offset = _offset(vis)
    oom = _order_of_magnitude(vis, offset, lo, hi)
    fmt = _format(locs, offset, oom, vmin, vmax)
    labels = []
    for x in locs:
        xp = (x - offset) / (10. ** oom)
        if abs(xp) < 1e-8:
            xp = 0
        labels.append(_fix_minus(fmt % xp))
    text = ""
    if oom or offset:
        off = ""
        if offset:
            off = _format_data(offset)
            if offset > 0:
                off = "+" + off
        sci = "1e%d" % oom if oom else ""
        text = _fix_minus(sci + off)
    return labels, text


def _offset(locs):
    if not len(locs):
        return 0
    lmin, lmax = locs.min(), locs.max()
    if lmin == lmax or lmin <= 0 <= lmax:
        return 0
    abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
    sign = math.copysign(1, lmin)
    oom_max = np.ceil(math.log10(abs_max))
    oom = 1 + next(o for o in itertools.count(oom_max, -1)
                   if abs_min // 10 ** o != abs_max // 10 ** o)
    if (abs_max - abs_min) / 10 ** oom <= 1e-2:
        oom = 1 + next(o for o in itertools.count(oom_max, -1)
                       if abs_max // 10 ** o - abs_min // 10 ** o > 1)
    n = OFFSET_THRESHOLD - 1
    return (sign * (abs_max // 10 ** oom) * 10 ** oom
            if abs_max // 10 ** oom >= 10 ** n else 0)


def _order_of_magnitude(vis, offset, lo, hi):
    vis = np.abs(vis)
    if not len(vis):
        return 0
    if offset:
        oom = math.floor(math.log10(hi - lo))
    else:
        val = vis.max()
        oom = 0 if val == 0 else math.floor(math.log10(val))
    if oom <= POWER_LIMITS[0] or oom >= POWER_LIMITS[1]:
        return oom
    return 0


def _format(locs_all, offset, oom, vmin, vmax):
    pad = len(locs_all) < 2
    _locs = [*locs_all, vmin, vmax] if pad else locs_all
    locs = (np.asarray(_locs) - offset) / 10. ** oom
    loc_range = np.ptp(locs)
    if loc_range == 0:
        loc_range = np.max(np.abs(locs))
    if loc_range == 0:
        loc_range = 1
    if pad:
        locs = locs[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(locs - np.round(locs, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    sigfigs += 1
    return f"%1.{sigfigs}f"


def _format_data(value):
    e = math.floor(math.log10(abs(value)))
    s = round(value / 10 ** e, 10)
    significand = _fix_minus(("%d" if s % 1 == 0 else "%1.10g") % s)
    if e == 0:
        return significand
    return f"{significand}e{_fix_minus('%d' % e)}"


def auto_ticks(lo, hi, length_px, dpi, factor) -> Ticks:
    """The AutoLocator / ScalarFormatter ticks of an axis with view (lo,
    hi) and length ``length_px``, keeping those inside the view."""
    locs = max_n_locator(lo, hi, tick_space(length_px, dpi, factor))
    labels, offset_text = scalar_format(locs, lo, hi)
    keep = in_view(locs, lo, hi)
    return Ticks(locs[keep], [lab for lab, k in zip(labels, keep) if k],
                 offset_text=offset_text)


def fixed_ticks(locs, labels, lo, hi, fontsize=TICK_LABEL_PT,
                rotation=0.0) -> Ticks:
    """FixedLocator ticks with FixedFormatter labels, those inside the
    view."""
    locs = np.asarray(locs, float)
    keep = in_view(locs, lo, hi)
    return Ticks(locs[keep], [lab for lab, k in zip(labels, keep) if k],
                 fontsize, rotation)
