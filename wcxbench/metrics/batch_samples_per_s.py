"""Plate throughput of predict-batch: samples scored and written over the
window's time."""

from wcxbench import readers

UNIT = "samples/s"
SOURCE = "host_clock"


def read(run):
    n = readers.samples(run)
    return n / run.window_s if n and run.window_s > 0 else None
