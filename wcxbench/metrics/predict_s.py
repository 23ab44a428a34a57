"""Per-sample turnaround of predict: the window's time over the samples
it completed, each job timed whole."""

from wcxbench import readers

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    n = readers.samples(run)
    return run.window_s / n if n else None
