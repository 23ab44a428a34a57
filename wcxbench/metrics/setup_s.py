"""The run's set-up: the process up to the window (import of torch and the
port, the context, the cohort, the stage's own set-up, the warm call)."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup["setup_s"]
