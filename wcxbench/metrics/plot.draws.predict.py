"""Plots: the draws of the rasterizer (artists, axes, spines, titles,
legends; the ``draws`` of the traced jobs' ``predict.plots.raster``
spans), per sample."""

from wcxbench import spans

LAYER = "plots"
MOVES = "predict_s"
UNIT = "draws"
SOURCE = "program_counter"


def read(run):
    return spans.attribute_per_sample(
        run, lambda s: s["attrs"].get("draws")
        if s["name"] == "predict.plots.raster" else None)
