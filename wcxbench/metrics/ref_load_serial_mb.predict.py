"""Reference loading: the compressed bytes the loader inflated on one
thread (the ``serial_bytes`` of the traced jobs' ``predict.load.*`` spans;
0 where every member was stored or inflated in pieces concurrently), in
MB (1e6 bytes) per sample.  Nothing where the program's spans carry no
``serial_bytes``."""

from wcxbench import spans

LAYER = "reference loading"
MOVES = "predict_s"
UNIT = "MB"
SOURCE = "program_counter"


def read(run):
    total = spans.attribute_per_sample(
        run, lambda s: s["attrs"].get("serial_bytes")
        if s["name"].startswith("predict.load.") else None)
    return None if total is None else total / 1e6
