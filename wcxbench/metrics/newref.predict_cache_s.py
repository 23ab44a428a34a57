"""newref orchestration: the wait for the predict caches
(``newref.predict_cache``), per build."""

from wcxbench import readers

LAYER = "newref orchestration"
MOVES = "newref_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, names=("newref.predict_cache",))
