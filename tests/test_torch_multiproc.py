"""The port's multi-process layer across two real OS processes on the CPU:
each worker gets a ``torchrun``-style environment (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR=127.0.0.1``, ``MASTER_PORT``), starts the gloo
process group through ``maybe_initialize_distributed`` and imports only
the port.  Every worker has its own timeout.

* ``knn_search_multihost``: each process searches half of the rows (over
  two devices of its own) and, after the all-gather, holds the whole
  table: equal to one process and to the JAX package's ``knn_search``
  with the sort merge in float64;
* ``newref``: process 0's reference equals a one-process build in every
  member, and process 1 writes none;
* ``predict-batch``: the two shards together write every sample's
  outputs, byte-equal to a one-process run of the whole plate.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from synthetic import CohortSim
from torch_parity import CPU, layout, t64
from wisecondorx_tpu.io import npz as io_npz
from wisecondorx_tpu.ops import knn as jknn
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.parallel.multihost import knn_search_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

WORKER = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
mode, out = sys.argv[1], sys.argv[2]
if mode == "knn":
    from wisecondorx_tpu_torch.parallel.multihost import (
        knn_search_multihost,
        maybe_initialize_distributed,
    )

    rank, world = maybe_initialize_distributed()
    assert world == 2, world
    bins = [300, 250, 200]
    starts = np.concatenate([[0], np.cumsum(bins)[:-1]])
    chr_of = np.repeat(np.arange(3), bins).astype(np.int32)
    data = np.random.default_rng(42).lognormal(0, 0.02, size=(sum(bins), 12))
    stats = {}
    idx, dist = knn_search_multihost(
        torch.as_tensor(data), chr_of, starts, bins, ref_size=17,
        devices=[torch.device("cpu")] * 2, stats=stats,
    )
    assert stats["n_rows"] == sum(bins), stats
    np.savez(out, idx=idx, dist=dist)
else:
    from wisecondorx_tpu_torch.cli import main

    main(sys.argv[3:])
print("WORKER_OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(tmp_path, mode, outs, argv=()):
    """Run the worker in two processes of one gloo group; returns their
    logs.  Each process is waited for with its own timeout."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), mode, str(outs[rank]), *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    assert all("WORKER_OK" in log for log in logs), "\n---\n".join(logs)
    return logs


def test_knn_search_multihost_two_processes(tmp_path):
    outs = [tmp_path / f"out{r}.npz" for r in range(2)]
    _run_two(tmp_path, "knn", outs)
    bins = [300, 250, 200]
    starts, chr_of = layout(bins)
    data = np.random.default_rng(42).lognormal(0, 0.02, size=(sum(bins), 12))
    one_i, one_d = knn_search_multihost(t64(data), chr_of, starts, bins,
                                        ref_size=17, devices=[CPU])
    want_i, want_d = jknn.knn_search(data, chr_of, starts, bins, ref_size=17,
                                     col_tile=128, merge_method="sort")
    for out in outs:
        got = np.load(out)
        assert got["idx"].dtype == np.int64
        np.testing.assert_array_equal(got["idx"], one_i)
        np.testing.assert_array_equal(got["dist"], one_d)
        np.testing.assert_array_equal(got["idx"], want_i)
        np.testing.assert_allclose(got["dist"], want_d, rtol=1e-10)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiproc")
    sim = CohortSim(binsize=1e5, genome_scale=0.006, seed=31)
    samples, _ = sim.cohort(7, 6)
    controls = []
    for i, s in enumerate(samples):
        path = tmp / f"control_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        controls.append(str(path))
    cases = []
    for i in range(5):
        s = sim.sample("F" if i % 2 == 0 else "M",
                       cnvs=[(18, 1, 5, 3.0)] if i == 0 else None)
        path = tmp / f"case_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        cases.append(str(path))
    ref = str(tmp / "reference.npz")
    torch_cli(["newref", *controls, ref, "--refsize", "25", "--device", "cpu"])
    return tmp, controls, cases, ref


def test_newref_two_processes(plate, tmp_path):
    """Both processes get one command line, as torchrun gives them, with a
    checkpoint directory (each keeps its own subdirectory)."""
    _, controls, _, ref = plate
    out = str(tmp_path / "ref.npz")
    logs = _run_two(tmp_path, "cli", [tmp_path / "unused"] * 2,
                    ["newref", *controls, out, "--refsize", "25", "--device",
                     "cpu", "--checkpoint-dir", str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "ck")
    want, got = np.load(ref), np.load(out)
    assert set(got.keys()) == set(want.keys())
    for key in want.keys():
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "process 0 writes the reference" in logs[1]


def test_predict_batch_two_processes(plate, tmp_path):
    _, _, cases, ref = plate
    flags = ["--bed", "--minrefbins", "10", "--device", "cpu", "--chunk", "2"]
    solo = str(tmp_path / "solo")
    torch_cli(["predict-batch", ref, solo, *flags, "--infiles", *cases])
    both = str(tmp_path / "both")
    logs = _run_two(tmp_path, "cli", [tmp_path / "unused"] * 2,
                    ["predict-batch", ref, both, *flags, "--infiles", *cases])
    assert "takes 2 of 5 samples" in logs[0]
    assert "takes 3 of 5 samples" in logs[1]
    for case in cases:
        base = os.path.basename(case)[:-4]
        for suffix in ("_bins.bed", "_segments.bed", "_aberrations.bed",
                       "_statistics.txt"):
            with open(os.path.join(both, base + suffix), "rb") as g, \
                    open(os.path.join(solo, base + suffix), "rb") as w:
                assert g.read() == w.read(), base + suffix
