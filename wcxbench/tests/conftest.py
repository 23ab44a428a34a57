"""Shared fixtures of the benchmark's own tests (``python -m pytest
wcxbench/tests``): the tiny configuration the CPU runs take."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: A genome at 3 % of its length, 12 + 12 controls, 30 neighbours: every
#: stage runs in seconds on the CPU.
TINY = {"genome_scale": 0.03, "female_controls": 12, "male_controls": 12,
        "refsize": 30, "minrefbins": 10}


def tiny(workload: str) -> dict:
    if workload.startswith("nipt"):
        return {**TINY, "female_controls": 24, "male_controls": 0}
    return dict(TINY)


@pytest.fixture
def tiny_config():
    return tiny
