"""Plots of predict (``--plot``) and newref (``--plotyfrac``) without
matplotlib.

Counterpart of wisecondorx_tpu/output/plots.py and of the JAX CLI's
``--plotyfrac`` figure: the same files at the same pixel sizes, with the
same dots, colours, dot sizes, rectangles, lines, ticks, labels and limits.
Each figure is first built as a scene (``layout.Scene``, host float64),
then rasterized on a torch device (``raster.render_scene``) and encoded as
PNG with the standard library (``png``).  The rasters carry the figures'
content, not matplotlib's pixels: nothing is antialiased, hairlines are
drawn 1 px wide, text comes from a glyph atlas baked from DejaVu Sans, and
the legends take their entries, colours and titles from the JAX figures
but are placed by a simpler rule.  ``--cairo`` changes nothing, as in the
JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wisecondorx_tpu_torch.output import layout as L
from wisecondorx_tpu_torch.output import png, raster
from wisecondorx_tpu_torch.utils.log import stage_timer


def _hex(h: str) -> tuple:
    return tuple(int(h[i:i + 2], 16) / 255 for i in (1, 3, 5))


BLACK = _hex("#3f3f3f")
LIGHT_GREY = _hex("#e0e0e0")
COLOR_A = (84 / 255, 84 / 255, 84 / 255)  # neutral dots
COLOR_B = (227 / 255, 200 / 255, 138 / 255)  # loss
COLOR_C = (141 / 255, 209 / 255, 198 / 255)  # gain
COLOR_D = (150 / 255, 80 / 255, 33 / 255)  # region highlight
#: matplotlib's first cycle colour (histogram bars) and "r".
C0 = _hex("#1f77b4")
RED = (1.0, 0.0, 0.0)
GENOME_WIDE = {"figsize": (14, 10), "dpi": 160}
CHROMOSOME = {"figsize": (14, 10), "dpi": 120}
YFRAC = {"figsize": (16, 6), "dpi": 100}


def _rgba(color, alpha=1.0):
    return (*color[:3], alpha)


def _chr_label(c):
    return {22: "chrX", 23: "chrY"}.get(c, f"chr{c + 1}")


def _aberration_cutoffs(beta, ploidy):
    return (
        np.log2((ploidy - beta / 2) / ploidy),
        np.log2((ploidy + beta / 2) / ploidy),
    )


def _parse_ylim(ylim):
    if ylim and ylim != "def":
        lo, hi = ylim.strip("[]").split(",")
        return float(lo), float(hi)
    return None


def _dot_colors(n, segments, chr_starts, zscore, beta, ref_gender):
    """Per-bin colors from segment calls (plotter.R:154-182)."""
    colors = np.zeros((n, 3))
    colors[:] = COLOR_A
    for seg in segments:
        chrom, s, e, z, height = seg[0], seg[1], seg[2], seg[3], seg[4]
        lo = chr_starts[chrom] + s
        hi = chr_starts[chrom] + e
        ploidy = 1 if (chrom in (22, 23) and ref_gender == "M") else 2
        if beta is not None:
            loss_cut, gain_cut = _aberration_cutoffs(beta, ploidy)
            if height < loss_cut:
                colors[lo:hi] = COLOR_B
            elif height > gain_cut:
                colors[lo:hi] = COLOR_C
        else:
            if isinstance(z, str):
                colors[lo:hi] = (0.5, 0.5, 0.5)
                continue
            if z < -zscore:
                colors[lo:hi] = COLOR_B
            elif z > zscore:
                colors[lo:hi] = COLOR_C
    return colors


def _constitutional_lines(ploidy, x0, x1):
    return [
        L.Line(np.array([x0, x1]), np.array([y, y]), _rgba(col), 1.5, ":", 1)
        for y, col in ((np.log2(n / ploidy), col)
                       for n, col in ((1, COLOR_B), (2, COLOR_A), (3, COLOR_C)))
    ]


def _whiskers(values):
    vals = values[~np.isnan(values)]
    if len(vals) == 0:
        return np.nan, np.nan
    q1, q3 = np.percentile(vals, [25, 75])
    iqr = q3 - q1
    lo = vals[vals >= q1 - 1.5 * iqr].min()
    hi = vals[vals <= q3 + 1.5 * iqr].max()
    return lo, hi


def _collect_regions(regions, binsize, chr_starts, n_chr):
    out = []
    if regions is None:
        return out
    with open(regions) as f:
        lines = f.readlines()
    for line in lines:
        parts = line.strip().split("\t")
        if len(parts) < 4:
            continue
        chr_name = parts[0].removeprefix("chr")
        chrom = {"X": 23, "Y": 24}.get(chr_name)
        if chrom is None:
            try:
                chrom = int(chr_name)
            except ValueError:
                continue
        if not (1 <= chrom <= n_chr):
            continue
        start_bin = int(np.ceil(int(parts[1]) / binsize)) + int(
            chr_starts[chrom - 1]
        )
        end_bin = int(np.ceil(int(parts[2]) / binsize)) + int(
            chr_starts[chrom - 1]
        )
        out.append((start_bin, end_bin, parts[3]))
    return out


def _draw_segments(segments, chr_starts, colors, dot_size):
    artists = []
    for seg in segments:
        chrom, s, e, height = seg[0], seg[1], seg[2], seg[4]
        lo = int(chr_starts[chrom] + s)
        hi = int(chr_starts[chrom] + e)
        base = colors[lo] if lo < len(colors) else COLOR_A
        artists.append(L.Rect(lo, 0, hi - lo, height, _rgba(base, 0.3), 2))
        lw = (max(np.nanmean(dot_size[lo:hi]) / 6, 0.8) if hi > lo else 1.0)
        artists.append(L.Line(np.array([lo, hi]), np.array([height, height]),
                              _rgba(LIGHT_GREY), lw, "-", 3))
    return artists


def _draw_gene_labels(gene_labels, ratio):
    artists = []
    for start_bin, end_bin, label in gene_labels:
        xs = np.arange(start_bin, end_bin + 1)
        xs = xs[(xs >= 0) & (xs < len(ratio))]
        if len(xs) == 0:
            continue
        artists.append(L.Scatter(xs, ratio[xs], np.tile(COLOR_D, (len(xs), 1)),
                                 np.full(len(xs), 40.0), 6, ring_lw=2.0))
        seg_vals = ratio[xs]
        if np.all(np.isnan(seg_vals)):
            continue
        if np.nanmean(seg_vals) > 0:
            y = np.nanmax(seg_vals) + 0.2
            va = "bottom"
        else:
            y = np.nanmin(seg_vals) - 0.2
            va = "top"
        artists.append(L.Text((start_bin + end_bin) / 2, y, label, _rgba(COLOR_D),
                              8, 90, "center", va, 6))
    return artists


def _figure(name, spec):
    w, h = spec["figsize"]
    return L.Scene(name, int(round(w * spec["dpi"])), int(round(h * spec["dpi"])),
                   spec["dpi"], [])


def _finish_axes(scene, ax, xticks=None):
    """Autoscale what has no limit, then set the auto ticks: y always, x
    unless ``xticks`` = (locs, labels, fontsize, rotation) fixes them."""
    L.autoscale_axes(ax)
    _, _, width, height = L.axes_px(scene, ax)
    ax.yticks = L.auto_ticks(*ax.ylim, height, scene.dpi, 2)
    if xticks is None:
        ax.xticks = L.auto_ticks(*ax.xlim, width, scene.dpi, 3)
    else:
        locs, labels, fontsize, rotation = xticks
        ax.xticks = L.fixed_ticks(locs, labels, *ax.xlim, fontsize, rotation)
    return ax


def _new_axes(bounds, xlim=None, ylim=None):
    return L.Axes(bounds, xlim, ylim, [], None, None)


def _plot_genome_wide(bins, segments, ratio, colors, dot_size, chr_starts,
                      chr_ends, n_chr, lower, upper, l_whis, h_whis,
                      gene_labels, plot_title):
    scene = _figure("genome_wide.png", GENOME_WIDE)
    grid = (17, 25)
    total = int(chr_ends[-1])
    autosome_len = int(chr_ends[21])
    ax = _new_axes(L.grid_bounds(*grid, slice(0, 10), slice(None), 4.0, 2.0),
                   (-total * 0.01, total * 1.01), (lower, upper))
    ax_auto = _new_axes(L.grid_bounds(*grid, slice(10, None), slice(0, 22), 4.0, 2.0))
    ax_sex = _new_axes(L.grid_bounds(*grid, slice(10, None), slice(22, None), 4.0, 2.0))

    na_idx = np.nonzero(np.isnan(ratio))[0]
    ax.artists.append(L.VLines(na_idx, lower, upper, _rgba(LIGHT_GREY), 0.1, 0))
    if bins.ref_gender == "F":
        ax.artists += _constitutional_lines(2, -total * 0.025, total * 1.025)
    else:
        ax.artists += _constitutional_lines(2, -total * 0.025, autosome_len)
        ax.artists += _constitutional_lines(1, autosome_len, total * 1.025)
    x = np.arange(total)
    ok = ~np.isnan(ratio)
    ax.artists.append(L.Scatter(x[ok], ratio[ok], colors[ok], dot_size[ok], 4))
    ax.artists += _draw_segments(segments, chr_starts, colors, dot_size)
    ax.artists += _draw_gene_labels(gene_labels, ratio)
    for xb in np.concatenate([[0], chr_ends]):
        ax.artists.append(L.Line(np.array([xb, xb]), np.array([0, 1]), _rgba(BLACK),
                                 0.8, ":", 1, yaxes=True))
    mids = chr_ends - np.diff(np.concatenate([[0], chr_ends])) / 2
    ax.ylabel = r"log$_2$(ratio)"
    ax.legend = L.Legend(
        [L.LegendEntry("Gain", _rgba(COLOR_C), True, ""),
         L.LegendEntry("Loss", _rgba(COLOR_B), True, ""),
         L.LegendEntry("Constitutional 3n", _rgba(COLOR_C), False),
         L.LegendEntry("Constitutional 2n", _rgba(COLOR_A), False),
         L.LegendEntry("Constitutional 1n", _rgba(COLOR_B), False)],
        "upper center", 8, f"Number of reads: {bins.n_reads:,}".replace(",", "."),
        ncol=5, frameon=False)
    _finish_axes(scene, ax, (mids, [_chr_label(c) for c in range(n_chr)], 8, 45))
    if plot_title:
        scene.suptitle = L.Text(0.5, 0.98, plot_title, _rgba(COLOR_A), 12, 0,
                                "center", "top")

    per_chr = [ratio[chr_starts[c]: chr_ends[c]] for c in range(n_chr)]
    per_chr = [v[~np.isnan(v)] for v in per_chr]
    boxes, ax_auto.box_stats = L.boxplot(
        [v if len(v) else [0] for v in per_chr[:22]], flier_size=2)
    ax_auto.artists += boxes
    finite_l = l_whis[:22][np.isfinite(l_whis[:22])]
    finite_h = h_whis[:22][np.isfinite(h_whis[:22])]
    if len(finite_l) and len(finite_h):
        ax_auto.ylim = (finite_l.min(), finite_h.max())
    ax_auto.ylabel = r"log$_2$(ratio)"
    ax_auto.artists += _constitutional_lines(2, 0, 23)
    _finish_axes(scene, ax_auto, (np.arange(1, 23), [_chr_label(c) for c in range(22)],
                                  7, 45))

    sex_data = per_chr[22:]
    boxes, ax_sex.box_stats = L.boxplot(
        [v if len(v) else [0] for v in sex_data], flier_size=2)
    ax_sex.artists += boxes
    ploidy_sex = 1 if bins.ref_gender == "M" else 2
    ax_sex.artists += _constitutional_lines(ploidy_sex, 0.5, len(sex_data) + 0.5)
    _finish_axes(scene, ax_sex, (np.arange(1, len(sex_data) + 1),
                                 [_chr_label(c) for c in range(22, n_chr)], 7, 45))
    scene.axes = [ax, ax_auto, ax_sex]
    return scene


def _plot_chromosome(c, bins, segments, ratio, colors, dot_size, chr_starts,
                     chr_ends, whiskers, ylim_override, gene_labels):
    lo_w, hi_w = whiskers
    if np.isnan(lo_w) or np.isnan(hi_w):
        return None  # plotter.R:346-350 skips data-less chromosomes
    m0, m1 = int(chr_starts[c]), int(chr_ends[c])
    chr_ratio = ratio[m0:m1]

    upper = max(0.6 + hi_w, np.nanmax(chr_ratio))
    lower = min(-1.05 + lo_w, np.nanmin(chr_ratio))
    if ylim_override:
        lower, upper = ylim_override

    n_bins = m1 - m0
    scene = _figure(f"{_chr_label(c)}.png", CHROMOSOME)
    ax = _new_axes(L.grid_bounds(1, 1, slice(None), slice(None)),
                   (m0 - n_bins * 0.02, m1 + n_bins * 0.02), (lower, upper))
    ploidy = 1 if (c in (22, 23) and bins.ref_gender == "M") else 2
    ax.artists += _constitutional_lines(ploidy, m0 - (m1 - m0) * 0.02,
                                        m1 + (m1 - m0) * 0.02)
    na_idx = m0 + np.nonzero(np.isnan(chr_ratio))[0]
    ax.artists.append(L.VLines(na_idx, lower, upper, _rgba(COLOR_A, 0.6), 0.6, 0))
    x = np.arange(m0, m1)
    ok = ~np.isnan(chr_ratio)
    ax.artists.append(L.Scatter(x[ok], chr_ratio[ok], colors[m0:m1][ok],
                                dot_size[m0:m1][ok], 4))
    ax.artists += _draw_segments([s for s in segments if s[0] == c], chr_starts,
                                 colors, dot_size)
    ax.artists += _draw_gene_labels([g for g in gene_labels if m0 <= g[0] < m1],
                                    ratio)
    tick_bins = np.linspace(0, n_bins, 11)[1:-1]
    labels = [f"{int(t * bins.binsize):,}".replace(",", ".") for t in tick_bins]
    ax.ylabel = r"log$_2$(ratio)"
    ax.title = _chr_label(c)
    _finish_axes(scene, ax, (m0 + tick_bins, labels, 8, 45))
    scene.axes = [ax]
    return scene


def build_scenes(bins, segments, cfg, ylim="def", regions=None,
                 plot_title=None):
    """The scenes of ``write_plots``: genome-wide first, then each
    chromosome with data, in order."""
    n_chr = 24 if bins.ref_gender == "M" else 23
    ratio = np.concatenate(
        [np.asarray(bins.results_r[c], float) for c in range(n_chr)]
    )
    weights = np.concatenate(
        [np.asarray(bins.results_w[c], float) for c in range(n_chr)]
    )
    ratio = np.where(ratio == 0, np.nan, ratio)
    weights = np.where(weights == 0, np.nan, weights)
    bins_per_chr = np.array([len(bins.results_r[c]) for c in range(n_chr)])
    chr_starts = np.concatenate([[0], np.cumsum(bins_per_chr)[:-1]])
    chr_ends = np.cumsum(bins_per_chr)
    total = int(chr_ends[-1])

    colors = _dot_colors(
        total, segments, chr_starts, cfg.zscore, cfg.beta, bins.ref_gender
    )
    dot_size = (weights / np.pi) ** 0.5 * 0.8  # plotter.R:153
    dot_size = np.nan_to_num(dot_size, nan=0.0) * 20  # pt^2 for scatter

    per_chr_whiskers = [
        _whiskers(ratio[chr_starts[c]: chr_ends[c]]) for c in range(n_chr)
    ]
    l_whis = np.array([w[0] for w in per_chr_whiskers])
    h_whis = np.array([w[1] for w in per_chr_whiskers])
    upper = np.nanmax([0.65, np.nanmax(h_whis)]) * 1.25
    lower = np.nanmin([-0.95, np.nanmin(l_whis)]) * 1.25
    override = _parse_ylim(ylim)
    if override:
        lower, upper = override

    gene_labels = _collect_regions(regions, bins.binsize, chr_starts, n_chr)
    scenes = [_plot_genome_wide(
        bins, segments, ratio, colors, dot_size, chr_starts, chr_ends, n_chr,
        lower, upper, l_whis, h_whis, gene_labels, plot_title,
    )]
    for c in range(n_chr):
        scene = _plot_chromosome(
            c, bins, segments, ratio, colors, dot_size, chr_starts, chr_ends,
            per_chr_whiskers[c], override, gene_labels,
        )
        if scene is not None:
            scenes.append(scene)
    return scenes


def render_pngs(items, device: torch.device, timer: str = "predict.plots"):
    """Rasterize each (path, scene) on ``device`` and write the PNGs:
    stages ``<timer>.raster`` (to host memory; span attributes ``figures``
    and ``draws``, the draws of ``raster.render_scene``) and
    ``<timer>.encode`` (``bytes``, the PNG bytes written)."""
    rasters = []
    with stage_timer(f"{timer}.raster") as span:
        before = raster.DRAWS["draws"]
        for path, scene in items:
            rasters.append((path, raster.render_scene(scene, device).cpu().numpy()))
        span.add("figures", len(rasters))
        span.add("draws", raster.DRAWS["draws"] - before)
    with stage_timer(f"{timer}.encode") as span:
        span.add("bytes", png.write_pngs(rasters))


def write_plots(outid, bins, segments, cfg, ylim="def", regions=None,
                plot_title=None, device=torch.device("cuda")):
    """Write ``<outid>.plots/genome_wide.png`` and one PNG per chromosome
    with data, rasterized on ``device``."""
    out_dir = f"{outid}.plots"
    os.makedirs(out_dir, exist_ok=True)
    with stage_timer("predict.plots.scene"):
        scenes = build_scenes(bins, segments, cfg, ylim, regions, plot_title)
    render_pngs([(os.path.join(out_dir, s.name), s) for s in scenes],
                torch.device(device))


def yfrac_scene(fit: dict, name: str = "yfrac.png"):
    """The ``--plotyfrac`` figure: a 100-bin density histogram of the chrY
    fractions and the mixture's density on [0, 0.02]."""
    scene = _figure(name, YFRAC)
    ax = _new_axes(L.grid_bounds(1, 1, slice(None), slice(None)), (0, 0.02), None)
    m, edges = np.histogram(fit["y_fractions"], bins=100, density=True)
    totwidth = np.diff(edges)
    width = 1.0 * totwidth
    centre = edges[:-1] + 0.5 * totwidth
    ax.artists.append(L.Bars(centre - width / 2, width, m, _rgba(C0), 1))
    ax.artists.append(L.Line(np.asarray(fit["grid"], float),
                             np.asarray(fit["density"], float), _rgba(RED),
                             1.5, "-", 2))
    ax.legend = L.Legend([L.LegendEntry("Gaussian mixture fit", _rgba(RED), False,
                                        "-")], "upper right", 10)
    _finish_axes(scene, ax)
    scene.axes = [ax]
    return scene


def write_yfrac_plot(path, fit: dict, device=torch.device("cuda")):
    """Write the ``--plotyfrac`` PNG of ``fit`` (``train_gender_model``'s
    fit dict) to ``path``, rasterized on ``device``; like matplotlib's
    ``savefig``, a path without an extension gets ``.png``.  Returns the
    path written."""
    if not os.path.splitext(path)[1]:
        path += ".png"
    with stage_timer("newref.plotyfrac.scene"):
        scene = yfrac_scene(fit, os.path.basename(path))
    render_pngs([(path, scene)], torch.device(device), timer="newref.plotyfrac")
    return path
