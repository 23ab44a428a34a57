"""Predict orchestration: both normalization passes
(``predict_batch.normalize_*``), per sample."""

from wcxbench import readers

LAYER = "predict orchestration"
MOVES = "batch_samples_per_s"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return readers.stage_seconds_per_sample(run, prefixes=("predict_batch.normalize_",))
