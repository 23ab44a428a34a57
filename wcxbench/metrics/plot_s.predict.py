"""Plots: the figure stages of predict (``predict.plots.scene``,
``.raster`` and ``.encode``), per sample."""

from wcxbench import readers

LAYER = "plots"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(
        run, names=("predict.plots.scene", "predict.plots.raster",
                    "predict.plots.encode"))
