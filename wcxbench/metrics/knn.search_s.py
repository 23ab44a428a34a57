"""KNN: the searches of the A, F and M passes (``newref.pass_*.knn``, on
their search threads), summed, per build."""

from wcxbench import readers

LAYER = "KNN"
MOVES = "newref_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    total, seen = 0.0, False
    for job in run.jobs:
        for stage, seconds in job["stages"].items():
            if stage.startswith("newref.pass_") and stage.endswith(".knn"):
                total += seconds
                seen = True
    n = readers.samples(run)
    return total / n if seen and n else None
