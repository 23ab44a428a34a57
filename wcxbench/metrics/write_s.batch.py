"""Output tables: the ``predict_batch.write`` stage, per sample."""

from wcxbench import readers

LAYER = "output tables"
MOVES = "batch_samples_per_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, names=("predict_batch.write",))
