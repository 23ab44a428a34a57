"""Device: the share of the traced jobs' window of ``predict --bed
--plot`` in which no kernel, copy or memset ran on the card."""

from wcxbench import readers

LAYER = "device"
MOVES = "predict_s"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    return readers.idle_percent(run)
