"""newref orchestration, npz I/O: reading the controls
(``newref.load_inputs``) and writing and verifying the reference
(``newref.write``, ``newref.verify``), per build."""

from wcxbench import readers

LAYER = "newref orchestration"
MOVES = "newref_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(
        run, names=("newref.load_inputs", "newref.write", "newref.verify"))
