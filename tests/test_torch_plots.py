"""The PyTorch port's plots (wisecondorx_tpu_torch/output) against the JAX
package's matplotlib figures, on the CPU.

The same numpy-seeded bins and segments go through the JAX ``write_plots``
(figures captured at ``savefig``, as tests/test_plots_golden.py does) and
through the port's scenes.  Each scene is held to its figure: file names
and pixel sizes, axes positions and limits, scatter offsets, face colours
and sizes in order, rectangles, lines (constitutional, segment, chromosome
boundaries, box plots), NaN-bin vlines, the ticks inside the view with
their labels, texts (ylabel source, titles, suptitle, gene labels with
their anchor and rotation, legend entries and title) and the box
statistics, to rtol 1e-12.  Then the port's PNGs are decoded with
``read_png`` (and PIL, where present): their size, every dot's pixel centre
against matplotlib's ``transData`` to 0.5 px, and the colour at the dot
centres.  ``--plotyfrac``: the bars against ``np.histogram`` and the curve
against the JAX fit.
"""

import os
import types

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.cbook  # noqa: E402
import matplotlib.figure  # noqa: E402

import torch  # noqa: E402

from torch_parity import CPU  # noqa: E402
from wisecondorx_tpu.output.plots import write_plots as jax_write_plots  # noqa: E402
from wisecondorx_tpu_torch.output import layout as L  # noqa: E402
from wisecondorx_tpu_torch.output import plots as tplots  # noqa: E402
from wisecondorx_tpu_torch.output.png import encode_png, read_png  # noqa: E402
from wisecondorx_tpu_torch.output.raster import render_scene, rgb8  # noqa: E402

RTOL = 1e-12
BINSIZE = 100_000


@pytest.fixture()
def captured(monkeypatch):
    figs = {}
    orig = matplotlib.figure.Figure.savefig

    def capture(self, fname, *a, **kw):
        figs[os.path.basename(str(fname))] = self
        return orig(self, fname, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", capture)
    return figs


def make_bins(seed, gender="F", empty_chr=None):
    """Seeded per-chromosome ratios and weights: 30-90 bins a chromosome,
    one in eight blanked (0, drawn as NaN), small weights so the dots stay
    a few pixels across."""
    rng = np.random.default_rng(seed)
    n_chr = 24 if gender == "M" else 23
    sizes = rng.integers(30, 90, n_chr)
    results_r, results_w = [], []
    for c, n in enumerate(sizes):
        r = rng.normal(0.0, 0.12, n)
        if gender == "M" and c >= 22:
            r -= 1.0
        r[rng.random(n) < 0.125] = 0.0
        w = rng.uniform(0.005, 0.05, n) * (r != 0)
        if c == empty_chr:
            r[:], w[:] = 0.0, 0.0
        results_r.append(r)
        results_w.append(w)
    return types.SimpleNamespace(
        results_r=results_r, results_w=results_w, ref_gender=gender,
        gender=gender, binsize=BINSIZE, n_reads=int(rng.integers(1e6, 2e7)),
    )


def make_segments(bins, nan_z=False):
    """A gain, a loss, a neutral segment and (optionally) one whose z is
    the string "nan", with heights raised into the bins they cover."""
    segs = [[20, 0, len(bins.results_r[20]), 9.0, 0.55],
            [4, 5, 25, -8.0, -0.9],
            [0, 0, 20, 1.0, 0.02],
            [10, 3, 12, 6.5, 0.4]]
    if nan_z:
        segs.append([7, 2, 15, "nan", 0.1])
    for c, s, e, z, h in segs:
        bins.results_r[c][s:e] = np.where(bins.results_r[c][s:e] != 0,
                                          bins.results_r[c][s:e] + h, 0.0)
    return segs


CASES = {
    "female": dict(seed=1),
    "male": dict(seed=2, gender="M"),
    "beta": dict(seed=3, beta=0.5),
    "nan_z": dict(seed=4, nan_z=True),
    "ylim": dict(seed=5, ylim="[-1.5,1.5]"),
    "regions_title": dict(seed=6, regions=True, title="sample_A"),
    "empty_chromosome": dict(seed=7, empty_chr=12),
}


def run_case(name, tmp_path, captured):
    spec = CASES[name]
    bins = make_bins(spec["seed"], spec.get("gender", "F"), spec.get("empty_chr"))
    segments = make_segments(bins, spec.get("nan_z", False))
    cfg = types.SimpleNamespace(zscore=5.0, beta=spec.get("beta"))
    regions = None
    if spec.get("regions"):
        regions = str(tmp_path / "regions.bed")
        with open(regions, "w") as f:
            f.write("21\t300000\t1500000\tDSCR\n5\t700000\t1200000\tLOSS1\n"
                    "X\t100000\t400000\tXG\nbad line\n")
    kwargs = dict(ylim=spec.get("ylim", "def"), regions=regions,
                  plot_title=spec.get("title"))
    jax_write_plots(str(tmp_path / "jax"), bins, segments, cfg, **kwargs)
    scenes = tplots.build_scenes(bins, segments, cfg, **kwargs)
    return bins, segments, cfg, kwargs, scenes, dict(captured)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=RTOL, atol=0, err_msg=what)


def _visible_ticks(axis):
    locs = axis.get_majorticklocs()
    labels = [t.get_text() for t in axis.get_majorticklabels()]
    keep = L.in_view(locs, *axis.get_view_interval())
    return locs[keep], [lab for lab, k in zip(labels, keep) if k]


def _port(ax, kind):
    return [a for a in ax.artists if isinstance(a, kind)]


def compare_axes(jax_ax, ax, where):
    _close(jax_ax.get_position().bounds, ax.bounds, f"{where} position")
    _close(jax_ax.get_xlim(), ax.xlim, f"{where} xlim")
    _close(jax_ax.get_ylim(), ax.ylim, f"{where} ylim")

    # scatters (filled dots and open rings), in order
    jax_sc = [c for c in jax_ax.collections if type(c).__name__ == "PathCollection"]
    sc = _port(ax, L.Scatter)
    assert len(jax_sc) == len(sc), where
    for j, s in zip(jax_sc, sc):
        _close(j.get_offsets(), np.column_stack([s.x, s.y]), f"{where} offsets")
        _close(j.get_sizes(), np.broadcast_to(s.sizes, len(s.x)) if len(j.get_sizes()) > 1
               else s.sizes[:1], f"{where} sizes")
        if s.ring_lw is None:
            _close(j.get_facecolor()[:, :3], s.colors, f"{where} face colours")
            assert np.all(j.get_facecolor()[:, 3] == 1.0)
        else:
            assert len(j.get_facecolor()) == 0
            _close(j.get_edgecolor()[0, :3], s.colors[0], f"{where} ring colour")
            _close(j.get_linewidths(), [s.ring_lw], f"{where} ring width")
    # rectangles
    from matplotlib.patches import Rectangle

    rects = [p for p in jax_ax.patches if isinstance(p, Rectangle)]
    prects = _port(ax, L.Rect) + [
        L.Rect(x, 0.0, w, h, b.color) for b in _port(ax, L.Bars)
        for x, w, h in zip(b.left, b.width, b.height)]
    assert len(rects) == len(prects), where
    for r, p in zip(rects, prects):
        _close([r.get_x(), r.get_y(), r.get_width(), r.get_height()],
               [p.x, p.y, p.width, p.height], f"{where} rectangle")
        _close(r.get_facecolor(), p.color, f"{where} rectangle colour")
    # lines: constitutional, segment, boundary and box-plot lines, fliers
    lines = [a for a in ax.artists if isinstance(a, (L.Line, L.Markers))]
    assert len(jax_ax.lines) == len(lines), where
    for j, p in zip(jax_ax.lines, lines):
        _close(j.get_xdata(), p.x, f"{where} line x")
        _close(j.get_ydata(), p.y, f"{where} line y")
        if isinstance(p, L.Markers):
            assert j.get_marker() == "." and j.get_linestyle() == "None"
            assert j.get_markersize() == p.size
            _close(matplotlib.colors.to_rgba(j.get_markeredgecolor()), p.color,
                   f"{where} flier colour")
            continue
        _close(matplotlib.colors.to_rgba(j.get_color()), p.color, f"{where} line colour")
        _close(j.get_linewidth(), p.lw, f"{where} line width")
        assert j.get_linestyle() == p.ls, where
        assert j.get_zorder() == p.zorder, where
        assert (j.get_transform() != jax_ax.transData) == p.yaxes, where
    # NaN-bin vlines
    vl = [c for c in jax_ax.collections if type(c).__name__ == "LineCollection"]
    pvl = _port(ax, L.VLines)
    assert len(vl) == len(pvl), where
    for j, p in zip(vl, pvl):
        segs = np.array(j.get_segments()).reshape(-1, 4)
        want = np.column_stack([p.x, np.full(len(p.x), p.ymin), p.x,
                                np.full(len(p.x), p.ymax)])
        _close(segs, want.reshape(-1, 4), f"{where} vlines")
        _close(j.get_color()[0], p.color, f"{where} vline colour")
        _close(j.get_linewidth(), [p.lw], f"{where} vline width")
    # ticks inside the view, with their labels
    for axis, ticks, name in ((jax_ax.xaxis, ax.xticks, "x"),
                              (jax_ax.yaxis, ax.yticks, "y")):
        locs, labels = _visible_ticks(axis)
        _close(locs, ticks.locs, f"{where} {name} ticks")
        assert labels == ticks.labels, (where, name)
        assert axis.get_offset_text().get_text() == ticks.offset_text, (where, name)
    jlabels = jax_ax.get_xticklabels()
    if jlabels and ax.xticks.labels:
        assert jlabels[0].get_rotation() == ax.xticks.rotation
        assert jlabels[0].get_fontsize() == ax.xticks.fontsize
    # texts
    assert jax_ax.get_ylabel() == ax.ylabel, where
    assert jax_ax.get_title() == ax.title, where
    texts = _port(ax, L.Text)
    assert [t.get_text() for t in jax_ax.texts] == [t.s for t in texts], where
    for j, p in zip(jax_ax.texts, texts):
        _close(j.get_position(), (p.x, p.y), f"{where} text anchor")
        assert (j.get_rotation(), j.get_ha(), j.get_va(), j.get_fontsize()) == (
            p.rotation, p.ha, p.va, p.fontsize), where
        _close(matplotlib.colors.to_rgba(j.get_color()), p.color, f"{where} text colour")
    legend = jax_ax.get_legend()
    assert (legend is None) == (ax.legend is None), where
    if legend is not None:
        assert [t.get_text() for t in legend.get_texts()] == [
            e.label for e in ax.legend.entries], where
        assert legend.get_title().get_text() == ax.legend.title, where
        for h, e in zip(legend.legend_handles, ax.legend.entries):
            _close(matplotlib.colors.to_rgba(h.get_color()), e.color, f"{where} legend")
            assert (h.get_marker() == "o") == e.marker, where
            if not e.marker:
                assert h.get_linestyle() == e.ls, where


def compare_scene(fig, scene):
    w, h = fig.get_size_inches() * fig.dpi
    assert (int(round(w)), int(round(h))) == (scene.width, scene.height)
    assert fig.dpi == scene.dpi
    assert len(fig.axes) == len(scene.axes)
    for i, (jax_ax, ax) in enumerate(zip(fig.axes, scene.axes)):
        compare_axes(jax_ax, ax, f"{scene.name} axes {i}")
    sup = fig._suptitle
    assert (sup is None) == (scene.suptitle is None)
    if sup is not None:
        assert sup.get_text() == scene.suptitle.s
        _close(matplotlib.colors.to_rgba(sup.get_color()), scene.suptitle.color,
               "suptitle colour")


def check_png(path, fig, scene):
    """Size, dot centres against matplotlib's transform, dot colours."""
    img = read_png(path)
    assert img.shape == (scene.height, scene.width, 3)
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as im:
            im.verify()
    hits = total = 0
    for jax_ax, ax in zip(fig.axes, scene.axes):
        jax_sc = [c for c in jax_ax.collections if type(c).__name__ == "PathCollection"]
        for j, s in zip(jax_sc, _port(ax, L.Scatter)):
            if s.ring_lw is not None:
                continue
            want = jax_ax.transData.transform(j.get_offsets())
            col, row = L.to_pixel(scene, ax, s.x, s.y)
            col, row = np.floor(col).astype(int), np.floor(row).astype(int)
            inside = ((s.x >= ax.xlim[0]) & (s.x <= ax.xlim[1])
                      & (s.y >= ax.ylim[0]) & (s.y <= ax.ylim[1]))
            assert np.all(np.abs(col + 0.5 - want[:, 0])[inside] <= 0.5 + 1e-9)
            assert np.all(np.abs(row + 0.5 - (scene.height - want[:, 1]))[inside]
                          <= 0.5 + 1e-9)
            colors = np.floor(s.colors * 255 + 0.5).astype(np.uint8)
            got = img[row[inside], col[inside]]
            hits += int(np.all(got == colors[inside], axis=1).sum())
            total += int(inside.sum())
    return hits, total


@pytest.mark.parametrize("case", list(CASES))
def test_scenes_and_pngs_match_the_jax_figures(case, tmp_path, captured):
    bins, segments, cfg, kwargs, scenes, figs = run_case(case, tmp_path, captured)
    jax_files = sorted(os.listdir(tmp_path / "jax.plots"))
    assert sorted(s.name for s in scenes) == jax_files == sorted(figs)
    if case == "empty_chromosome":
        assert "chr13.png" not in jax_files
    for scene in scenes:
        compare_scene(figs[scene.name], scene)
    ax_auto, ax_sex = scenes[0].axes[1:]
    per_chr = [r[r != 0] for r in bins.results_r]
    for st, data in zip(ax_auto.box_stats + ax_sex.box_stats,
                        [v if len(v) else [0] for v in per_chr]):
        want = matplotlib.cbook.boxplot_stats(data, whis=1.5)[0]
        for key in ("med", "q1", "q3", "whislo", "whishi", "fliers", "mean", "iqr"):
            _close(st[key], want[key], f"box {key}")

    tplots.write_plots(str(tmp_path / "port"), bins, segments, cfg, **kwargs,
                       device=CPU)
    assert sorted(os.listdir(tmp_path / "port.plots")) == jax_files
    hits = total = 0
    for scene in scenes:
        h, t = check_png(str(tmp_path / "port.plots" / scene.name),
                         figs[scene.name], scene)
        hits, total = hits + h, total + t
    assert total > 0 and hits >= 0.99 * total, (hits, total)


def test_yfrac_scene_matches_the_jax_figure(tmp_path, captured):
    """--plotyfrac: the JAX CLI's figure code on the JAX fit; the port's
    scene on the port's fit of the same fractions."""
    import matplotlib.pyplot as plt
    from wisecondorx_tpu.ops.gmm import train_gender_model as jax_train
    from wisecondorx_tpu_torch.ops.gmm import train_gender_model

    rng = np.random.default_rng(11)
    samples = []
    for i in range(40):
        male = i % 2
        total = rng.integers(2_000_000, 4_000_000)
        frac = rng.normal(0.009 if male else 0.0004, 0.0007 if male else 0.00005)
        y = int(total * max(frac, 1e-6))
        samples.append({str(c): np.array([total // 23 if c <= 23 else y])
                        for c in range(1, 25)})
    _, _, jfit = jax_train(samples, random_state=0)
    _, _, fit = train_gender_model(samples)
    np.testing.assert_allclose(fit["y_fractions"], jfit["y_fractions"], rtol=1e-12)
    np.testing.assert_allclose(fit["density"], jfit["density"], rtol=1e-6,
                               atol=1e-9 * np.max(jfit["density"]))
    fig, ax = plt.subplots(figsize=(16, 6))
    ax.hist(jfit["y_fractions"], bins=100, density=True)
    ax.plot(jfit["grid"], jfit["density"], "r-", label="Gaussian mixture fit")
    ax.set_xlim([0, 0.02])
    ax.legend(loc="best")
    plt.savefig(str(tmp_path / "jax_yfrac.png"))
    plt.close(fig)

    scene = tplots.yfrac_scene(jfit)
    bars = _port(scene.axes[0], L.Bars)[0]
    m, edges = np.histogram(jfit["y_fractions"], bins=100, density=True)
    _close(bars.height, m, "bar heights")
    np.testing.assert_allclose(bars.left, edges[:-1], rtol=1e-12, atol=1e-18)
    compare_scene(fig, scene)
    ported = tplots.yfrac_scene(fit)
    curve = _port(ported.axes[0], L.Line)[0]
    np.testing.assert_allclose(curve.y, jfit["density"], rtol=1e-6,
                               atol=1e-9 * np.max(jfit["density"]))
    path = str(tmp_path / "yfrac")
    tplots.write_yfrac_plot(path, fit, device=CPU)
    assert read_png(path + ".png").shape == (600, 1600, 3)


def test_render_is_deterministic_and_draws_in_painters_order():
    """Two overlapping dots: the later one wins the shared pixels; a dot
    under one pixel still draws its centre pixel; size 0 draws nothing."""
    scene = L.Scene("t.png", 40, 30, 72.0, [L.Axes(
        (0.0, 0.0, 1.0, 1.0), (0.0, 40.0), (0.0, 30.0),
        [L.Scatter(np.array([10.0, 12.0, 30.2, 5.0]), np.array([15.0, 15.0, 5.3, 5.0]),
                   np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0], [1, 1, 0]], float),
                   np.array([64.0, 64.0, 0.04, 0.0]), 4)],
        L.Ticks(np.array([]), []), L.Ticks(np.array([]), []))])
    img = render_scene(scene, CPU).numpy()
    assert tuple(img[14, 11]) == (0, 0, 255)       # shared: the later dot
    assert tuple(img[14, 7]) == (255, 0, 0)        # only the first dot
    assert tuple(img[30 - 6, 30]) == (0, 255, 0)   # sub-pixel dot, centre pixel
    assert tuple(img[30 - 6, 5]) == (255, 255, 255)  # size 0
    assert np.array_equal(img, render_scene(scene, CPU).numpy())


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_read_png_decodes_every_filter_type(tmp_path, ftype):
    """PNGs written with each filter type on every row decode to the
    image; a flipped byte fails the CRC check."""
    import struct
    import zlib

    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    raw, prev = bytearray(), np.zeros(15, np.int32)
    for row in img.reshape(7, 15).astype(np.int32):
        left = np.concatenate([np.zeros(3, np.int32), row[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if ftype == 0:
            pred = np.zeros(15, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    ref = encode_png(img)
    ihdr_end = 8 + 8 + 13 + 4

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    data = ref[:ihdr_end] + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")
    path = tmp_path / "f.png"
    path.write_bytes(data)
    assert np.array_equal(read_png(str(path)), img)
    bad = bytearray(data)
    bad[ihdr_end + 10] ^= 0xFF
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(path))


def test_glyph_atlas_is_the_generated_one():
    """The committed atlas equals what tests/torch_glyphs.py renders from
    matplotlib's DejaVu Sans."""
    import torch_glyphs

    assert open(torch_glyphs.MODULE).read() == torch_glyphs.module_source()


def test_text_masks_align_on_their_anchor():
    from wisecondorx_tpu_torch.output import text as T

    sub, _, sub_desc = T.layout("a$_2$", 10, 160)
    plain, _, plain_desc = T.layout("a2", 10, 160)
    assert sub_desc > plain_desc                     # the lowered subscript
    assert sub.shape[1] < plain.shape[1]             # and its smaller glyph
    assert T.layout("log$_2$(ratio)", 10, 160)[0].shape[1] < T.layout(
        "log2(ratio)", 10, 160)[0].shape[1]
    m, dr, dc = T.text_mask("chr21", 8, 160, 45, "center", "top")
    assert dr == 0 and dc == -(m.shape[1] // 2) and m.shape[0] > 15
    m90, dr, dc = T.text_mask("DSCR", 8, 160, 90, "center", "bottom")
    assert (dr, dc) == (-m90.shape[0], -(m90.shape[1] // 2))
    box, _, _ = T.layout("é", 10, 100)          # not in the atlas
    assert box.max() == 255 and (box[0] == 255).sum() >= box.shape[1] - 2


def test_cuda_plot_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tplots.yfrac_scene({"y_fractions": np.linspace(0, 0.01, 9),
                                "grid": np.linspace(0, 0.02, 50),
                                "density": np.ones(50)})
    with pytest.raises((RuntimeError, AssertionError)):
        render_scene(scene, torch.device("cuda"))
    assert rgb8((0.5, 0.5, 0.5)) == (128, 128, 128)
