"""CBS: the ``predict.cbs`` stage, per sample."""

from wcxbench import readers

LAYER = "CBS"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, names=("predict.cbs",))
