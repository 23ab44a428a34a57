"""95th percentile of the per-sample predict walls of the window
(numpy's linear interpolation between order statistics)."""

import numpy as np

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    walls = [j["wall"] for j in run.jobs if j["samples"]]
    return float(np.percentile(walls, 95)) if walls else None
