"""Reference loading: the loader's ``predict.load.*`` stages (on its
threads), summed, per sample."""

from wcxbench import readers

LAYER = "reference loading"
MOVES = "batch_samples_per_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, prefixes=("predict.load.",))
