#!/usr/bin/env python3
"""Times the CBS arc kernels of two checkouts in turns on one NVIDIA GPU.

    python3 torch_cbs_arcs_ab.py PARENT CHANGE [--pairs N] > out.jsonl
    python3 torch_cbs_arcs_ab.py --summarize out.jsonl

Each turn is a fresh process on one checkout: its own
``wisecondorx_tpu_torch``, its kernels built from its own sources (and
kept in its own ``build/``).  Turns run parent, change, change, parent,
... for N pairs.  Every turn runs the same seeded inputs at the round
shapes of chip_smoke.py's ``cbs_kernels`` phase, with numpy permutations
in place of the Threefry stream:

* ``t21_first_round``: two segments of 4,686 and 4,593 bins (chr1 and
  chr2 at 50 kb), 1,024 permuted rows plus the two observed, n_pad
  8,192, the thinned lengths;
* ``exact_2048``: nine segments of 876-2,036 bins, 1,024 + 9 rows, n_pad
  2,048, every length;
* ``bench_round``: two segments of 16,597 and 16,133 bins (chr1 and chr2
  at 15 kb), 1,024 + 2 rows, n_pad 32,768, thinned;

and the locate scan on the two 50 kb segments (n_pad 8,192) and the two
15 kb ones (n_pad 32,768).  Per shape and turn: the mean of 5 launches
after one warm launch (CUDA events), the SHA-256 of the output's bytes,
and, where the wrapper takes them, the sums cut to the largest segment
(``n_max``) and the number of arcs that took the exact formula.  Each turn
prints one JSON line; ``--summarize`` prints, per shape, each checkout's
times and median, and whether every turn's outputs are equal.  The card's
name and power limit head the output.
"""

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys

BENCH = (16597, 16133)
MAIN = (4686, 4593)
EXACT = (876, 1012, 1137, 1234, 1398, 1502, 1687, 1854, 2036)
ROUND_ROWS = 1024
REPS = 5


def _segments(sizes, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    segs = []
    for n in sizes:
        x = rng.normal(0.0, 0.1, n)
        x[n // 3: n // 3 + n // 20] += 0.3
        segs.append((rng.uniform(0.5, 1.5, n), x))
    return segs, rng


def _round(sizes, n_pad, seed):
    """(w, wx, n) of one round: the observed segments, then ROUND_ROWS
    permuted rows shared out among them."""
    import numpy as np

    segs, rng = _segments(sizes, seed)
    rows = list(segs)
    for r in range(ROUND_ROWS):
        w, x = segs[r % len(segs)]
        p = rng.permutation(len(w))
        rows.append((w[p], x[p]))
    return _tables(rows, n_pad)


def _tables(rows, n_pad):
    import numpy as np

    w_all = np.zeros((len(rows), n_pad))
    wx_all = np.zeros((len(rows), n_pad))
    n = np.zeros(len(rows), dtype=np.int64)
    for r, (w, x) in enumerate(rows):
        w_all[r, : len(w)] = w
        wx_all[r, : len(w)] = w * x
        n[r] = len(w)
    return w_all, wx_all, n


def _cuda_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def turn(checkout):
    """One checkout's times and output digests, as one JSON line."""
    sys.path = [checkout] + [p for p in sys.path
                             if os.path.abspath(p or ".") != os.path.dirname(
                                 os.path.abspath(__file__))]
    import torch

    from wisecondorx_tpu_torch.ops import _build, cbs

    if not torch.cuda.is_available():
        raise SystemExit("torch_cbs_arcs_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.load()
    takes = inspect.signature(cbs.max_t_rows).parameters
    cfg = cbs.CBSConfig()
    out = {"checkout": checkout, "shapes": {}}
    for name, sizes, n_pad, mode, seed in (
            ("t21_first_round", MAIN, 8192, "thin", 1),
            ("exact_2048", EXACT, 2048, "exact", 2),
            ("bench_round", BENCH, 32768, "thin", 3)):
        w, wx, n = (torch.as_tensor(a, device=dev) for a in _round(sizes, n_pad, seed))
        lengths = cbs._lengths_tensor(n_pad, cfg, mode, dev)
        kw = {}
        rec = {}
        if "n_max" in takes:
            kw["n_max"] = max(sizes)
            count = torch.zeros(1, dtype=torch.int64, device=dev)
            cbs.max_t_rows(w, wx, n, lengths, cfg.min_width, cfg.kmax,
                           exact_arcs=count, **kw)
            rec["exact_arcs"] = int(count)
        got = cbs.max_t_rows(w, wx, n, lengths, cfg.min_width, cfg.kmax, **kw)
        rec.update(ms=_cuda_ms(lambda: cbs.max_t_rows(
            w, wx, n, lengths, cfg.min_width, cfg.kmax, **kw)), digest=_digest(got))
        out["shapes"][name] = rec
        del w, wx, n
        torch.cuda.empty_cache()
    for name, sizes, n_pad in (("locate_t21", MAIN, 8192),
                               ("locate_bench", BENCH, 32768)):
        w, wx, n = (torch.as_tensor(a, device=dev)
                    for a in _tables(_segments(sizes, 4)[0], n_pad))
        kw = {"n_max": max(sizes)} if "n_max" in takes else {}
        got = cbs.locate_rows(w, wx, n, cfg.min_width, **kw)
        out["shapes"][name] = {
            "ms": _cuda_ms(lambda: cbs.locate_rows(w, wx, n, cfg.min_width, **kw)),
            "digest": _digest(*got)}
    print(json.dumps(out), flush=True)


def summarize(path):
    turns = [json.loads(line) for line in open(path) if line.startswith('{"checkout"')]
    names = sorted({s for t in turns for s in t["shapes"]})
    for name in names:
        digests = {t["shapes"][name]["digest"] for t in turns}
        row = {"shape": name, "outputs_equal": len(digests) == 1}
        for ck in dict.fromkeys(t["checkout"] for t in turns):
            ms = [t["shapes"][name]["ms"] for t in turns if t["checkout"] == ck]
            row[ck] = {"ms": ms, "median": statistics.median(ms)}
            exact = [t["shapes"][name].get("exact_arcs") for t in turns
                     if t["checkout"] == ck]
            if exact[0] is not None:
                row[ck]["exact_arcs"] = exact[0]
        print(json.dumps(row))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--turn")
    ap.add_argument("--summarize")
    args = ap.parse_args()
    if args.turn:
        return turn(os.path.abspath(args.turn))
    if args.summarize:
        return summarize(args.summarize)
    parent, change = (os.path.abspath(c) for c in args.checkouts)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    for _ in range(args.pairs):
        for ck in (parent, change, change, parent):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", ck],
                           check=True, timeout=900)


if __name__ == "__main__":
    main()
