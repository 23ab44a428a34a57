"""Predict orchestration: both normalization passes
(``predict.normalize_*``), per sample."""

from wcxbench import readers

LAYER = "predict orchestration"
MOVES = "predict_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, prefixes=("predict.normalize_",))
