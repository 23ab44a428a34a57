"""Output tables: the ``predict.write`` stage, per sample."""

from wcxbench import readers

LAYER = "output tables"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, names=("predict.write",))
