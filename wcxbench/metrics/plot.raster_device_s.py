"""Plots: device seconds of the operations launched inside the
``predict.plots.raster`` spans (the figures' rasterization and their copy
to host memory), per sample."""

from wcxbench import spans

LAYER = "plots"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "device_trace"


def read(run):
    return spans.device_seconds_per_sample(run, "predict.plots.raster")
