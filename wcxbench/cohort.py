"""Seeded shallow-WGS cohorts and cases, written as convert-stage ``.npz``.

``CohortSim`` is a frozen copy of the repository's test generator
(``tests/synthetic.py``): per-bin mappability/GC bias shared by the cohort,
Poisson counts, unmappable bins, sex-dependent gonosome copy number and
planted CNVs.  The benchmark keeps its own copy so that a change to the
tests cannot move the yardstick.  Everything is drawn from one seed in a
fixed order: the controls (females, then males), then the cell's cases in
the order its workload file lists them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# hg38-ish chromosome lengths in megabases (chr1..22, X, Y).
CHR_MBP = np.array(
    [
        248, 242, 198, 190, 181, 171, 159, 145, 138, 133,
        135, 133, 114, 107, 102, 90, 83, 80, 59, 64,
        47, 51, 156, 57,
    ],
    dtype=float,
)


def bins_per_chr(binsize: float, scale: float = 1.0) -> np.ndarray:
    return np.maximum((CHR_MBP * 1e6 * scale / binsize).astype(np.int64), 8)


class CohortSim:
    """Simulator holding the shared per-bin biases of a cohort."""

    def __init__(self, binsize: float = 1e5, genome_scale: float = 0.05,
                 mean_reads_per_bin: float = 100.0,
                 unmappable_frac: float = 0.05, seed: int = 0):
        self.binsize = binsize
        self.bins = bins_per_chr(binsize, genome_scale)
        self.rng = np.random.default_rng(seed)
        self.mean_reads = mean_reads_per_bin
        self.bias = [np.exp(self.rng.normal(0.0, 0.15, size=n)) for n in self.bins]
        for b in self.bias:
            dead = self.rng.random(len(b)) < unmappable_frac
            b[dead] = 0.0

    def sample(self, gender: str = "F", cnvs: list | None = None) -> dict:
        """One sample; ``cnvs`` holds (chr_1based, start_bin, end_bin,
        copies) with the diploid baseline at copies=2."""
        counts = {}
        depth = float(np.exp(self.rng.normal(0.0, 0.25)))
        y_noise = float(self.rng.uniform(0.01, 0.06))
        for c in range(24):
            chrom = c + 1
            if chrom <= 22:
                copies = 2.0
            elif chrom == 23:
                copies = 2.0 if gender == "F" else 1.0
            else:
                copies = 2 * y_noise if gender == "F" else self.rng.uniform(0.8, 1.1)
            lam = depth * self.mean_reads * self.bias[c] * (copies / 2.0)
            if cnvs:
                lam = lam.copy()
                for chr1, s, e, cp in cnvs:
                    if chr1 == chrom:
                        lam[s:e] *= cp / copies
            counts[str(chrom)] = self.rng.poisson(lam).astype(np.int32)
        return counts

    def cohort(self, n_female: int, n_male: int, cnvs=None) -> tuple:
        samples, genders = [], []
        for _ in range(n_female):
            samples.append(self.sample("F", cnvs))
            genders.append("F")
        for _ in range(n_male):
            samples.append(self.sample("M", cnvs))
            genders.append("M")
        return samples, genders


def numpy_seed(seed: int) -> int:
    """A run's ``--seed`` as numpy's generators take it (non-negative)."""
    return int(seed) % (1 << 64)


def resolve_cnvs(sim: CohortSim, cnvs) -> list:
    """Workload CNVs ``[chr, start, end, copies]`` with ``end`` "end"
    meaning the chromosome's last bin."""
    out = []
    for chrom, start, end, copies in cnvs or ():
        n = len(sim.bias[int(chrom) - 1])
        out.append((int(chrom), int(start), n if end == "end" else int(end),
                    float(copies)))
    return out


def save_sample(path: str, sample: dict, binsize: int) -> None:
    """A convert-stage sample npz (the schema ``convert`` writes)."""
    np.savez_compressed(path, binsize=binsize, sample=sample,
                        quality={"mapped": 1})


def make_inputs(config: dict, cases: list, seed: int, work: str,
                scale: float | None = None) -> dict:
    """Draw and write the cell's controls and cases under ``work``.

    ``cases`` are the workload's case entries (name, gender, cnvs, count);
    an entry with ``count`` n gives n samples ``<name>_<i>``.  Returns
    {"controls": [paths], "genders": [...], "cases": [(name, path, gender,
    cnvs)], "samples": {path: counts}, "sim": the simulator}."""
    sim = CohortSim(binsize=config["binsize"],
                    genome_scale=config["genome_scale"] if scale is None else scale,
                    mean_reads_per_bin=config["reads_per_bin"],
                    seed=numpy_seed(seed))
    controls, genders = sim.cohort(config["female_controls"],
                                   config["male_controls"])
    drawn = []
    for entry in cases:
        cnvs = resolve_cnvs(sim, entry.get("cnvs"))
        n = int(entry.get("count", 1))
        for i in range(n):
            name = entry["name"] if "count" not in entry else f"{entry['name']}_{i:02d}"
            drawn.append((name, sim.sample(entry["gender"], cnvs),
                          entry["gender"], cnvs))
    os.makedirs(os.path.join(work, "controls"), exist_ok=True)
    os.makedirs(os.path.join(work, "cases"), exist_ok=True)
    writes = [(os.path.join(work, "controls", f"control_{i:03d}.npz"), s)
              for i, s in enumerate(controls)]
    writes += [(os.path.join(work, "cases", f"{name}.npz"), s)
               for name, s, _, _ in drawn]
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda ps: save_sample(ps[0], ps[1], config["binsize"]),
                      writes))
    return {
        "controls": [p for p, _ in writes[: len(controls)]],
        "genders": genders,
        "cases": [(name, os.path.join(work, "cases", f"{name}.npz"), g, cnvs)
                  for name, _, g, cnvs in drawn],
        "samples": {p: s for p, s in writes},
        "sim": sim,
    }
