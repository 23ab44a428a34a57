"""KNN kernels: device seconds of the operations launched inside the
search threads' ``knn.search`` spans (the search itself: the bucketed
scan, the top-k and the rerun of flagged rows), per build."""

from wcxbench import spans

LAYER = "KNN kernels"
MOVES = "newref_s"
UNIT = "s"
SOURCE = "device_trace"


def read(run):
    return spans.device_seconds_per_sample(run, "knn.search")
