"""Reference loading as predict waits for it: the caller's own time in
the loader, ``ref_loader.open`` (the small members, read on the caller's
thread) and ``ref_loader.wait`` (each wait for the loader's threads),
per sample.  Unlike ``ref_load_s.predict``, the seconds of one thread,
so they add up with the sample's other stages."""

from wcxbench import readers

LAYER = "reference loading"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(
        run, names=("ref_loader.open", "ref_loader.wait"))
