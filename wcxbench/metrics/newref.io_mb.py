"""newref orchestration, npz I/O in bytes: the controls' files read
(``newref.load_inputs``), the reference read back (``newref.verify``) and
written (``npz.write.io``'s ``stored_bytes``), from the traced jobs'
spans, in MB (1e6 bytes) per build."""

from wcxbench import spans

LAYER = "newref orchestration"
MOVES = "newref_s"
UNIT = "MB"
SOURCE = "program_counter"
#: The span attribute read, by span name.
BYTES = {"newref.load_inputs": "bytes", "newref.verify": "bytes",
         "npz.write.io": "stored_bytes"}


def read(run):
    total = spans.attribute_per_sample(
        run, lambda s: s["attrs"].get(BYTES[s["name"]]) if s["name"] in BYTES else None)
    return None if total is None else total / 1e6
