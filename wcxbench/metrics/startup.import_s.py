"""Process start-up: seconds from the harness's first line to a live CUDA
context (import of torch and the port, the context)."""

LAYER = "process start-up"
MOVES = "setup_s"
UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup.get("import_s")
