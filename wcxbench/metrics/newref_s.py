"""Reference-build wall: the window's time over its completed newref
builds, each reading the controls and writing, verifying and QC-ing the
reference."""

from wcxbench import readers

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    n = readers.samples(run)
    return run.window_s / n if n else None
