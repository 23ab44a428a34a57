"""KNN: device seconds of the operations launched inside the search
threads' ``knn.nulls`` spans (the null ratios queued from the device
index table), per build."""

from wcxbench import spans

LAYER = "KNN"
MOVES = "newref_s"
UNIT = "s"
SOURCE = "device_trace"


def read(run):
    return spans.device_seconds_per_sample(run, "knn.nulls")
