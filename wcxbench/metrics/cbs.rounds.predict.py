"""CBS: device permutation rounds (``ops.cbs.ROUNDS["device"]``) per
sample."""

from wcxbench import readers

LAYER = "CBS"
MOVES = "predict_s"
UNIT = "rounds"
SOURCE = "program_counter"


def read(run):
    return readers.counter_per_sample(run, "cbs.rounds.device")
