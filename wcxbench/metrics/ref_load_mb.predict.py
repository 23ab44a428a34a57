"""Reference loading: the bytes the loader read from the reference file
for its members (the ``bytes`` of the traced jobs' ``predict.load.*``
spans), in MB (1e6 bytes) per sample."""

from wcxbench import spans

LAYER = "reference loading"
MOVES = "predict_s"
UNIT = "MB"
SOURCE = "program_counter"


def read(run):
    total = spans.attribute_per_sample(
        run, lambda s: s["attrs"].get("bytes")
        if s["name"].startswith("predict.load.") else None)
    return None if total is None else total / 1e6
