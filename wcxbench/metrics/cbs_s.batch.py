"""CBS: the ``predict.cbs`` stage, per sample."""

from wcxbench import readers

LAYER = "CBS"
MOVES = "batch_samples_per_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, names=("predict.cbs",))
