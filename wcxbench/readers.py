"""Arithmetic the metric readers share: per-sample means of the
program's stage seconds and counters over the window's jobs, and the
traced window's idle share."""

from __future__ import annotations


def samples(run) -> int:
    return sum(j["samples"] for j in run.jobs)


def stage_seconds_per_sample(run, names=(), prefixes=()) -> float | None:
    """Seconds of the named program stages (or of every stage under one of
    ``prefixes``), summed over the window's jobs, per sample completed;
    None where no job ran such a stage."""
    total, seen = 0.0, False
    for job in run.jobs:
        for stage, seconds in job["stages"].items():
            if stage in names or any(stage.startswith(p) for p in prefixes):
                total += seconds
                seen = True
    n = samples(run)
    return total / n if seen and n else None


def counter_per_sample(run, name: str) -> float | None:
    counts = [j["counters"][name] for j in run.jobs if name in j["counters"]]
    n = samples(run)
    return sum(counts) / n if counts and n else None


def idle_percent(run) -> float | None:
    t = run.traced
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
