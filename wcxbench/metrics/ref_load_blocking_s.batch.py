"""Reference loading as a plate waits for it: ``ref_loader.open`` and
``ref_loader.wait`` (see ``ref_load_blocking_s.predict``), per sample of
the plate."""

from wcxbench import readers

LAYER = "reference loading"
MOVES = "batch_samples_per_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(
        run, names=("ref_loader.open", "ref_loader.wait"))
