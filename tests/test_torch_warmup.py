"""The cold-process warm-up of the PyTorch port (utils/warmup.py) on the
CPU, where it runs at its tiny size on the kernels' plain versions:

* the newref, predict and predict-batch CLIs start it (on ``wcx-warmup-*``
  threads) before they read their inputs and join it before the main
  path first needs the device (newref: the cohort's upload; predict and
  predict-batch: the reference loader's first upload);
* a warm-up that fails fails the command with its own error (a non-zero
  exit in a fresh process), writes nothing and leaves no ``wcx-warm*``
  thread behind;
* only newref's warm-up loads the kernel library: predict and
  predict-batch run with a library that does not build; only theirs load
  the ``_bins.bed`` row formatter and the z-score's null-sum pass;
* it touches neither numpy's global RandomState nor torch's generator;
* it launches nothing the main path's counters count;
* it runs once per process and device (again only after a failure).
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from synthetic import CohortSim
from torch_parity import CPU
from wisecondorx_tpu_torch import device as tdevice
from wisecondorx_tpu_torch.cli import main as torch_cli
from wisecondorx_tpu_torch.io.npz import save_sample_npz
from wisecondorx_tpu_torch.models import ref_loader, reference
from wisecondorx_tpu_torch.ops import _build
from wisecondorx_tpu_torch.ops import cbs as tcbs
from wisecondorx_tpu_torch.ops import knn_cuda
from wisecondorx_tpu_torch.ops import stats
from wisecondorx_tpu_torch.output import tables
from wisecondorx_tpu_torch.utils import warmup
from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

REFSIZE = "30"
PLANTED = "nvcc failed: planted by the test"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("warmup")
    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=6)
    samples, _ = sim.cohort(16, 14)
    infiles = []
    for i, s in enumerate(samples):
        infiles.append(str(tmp / f"control_{i}.npz"))
        save_sample_npz(infiles[-1], 100000, s, {"mapped": 1})
    case = str(tmp / "case.npz")
    save_sample_npz(case, 100000, sim.sample("F", cnvs=[(11, 2, 30, 3.0)]),
                    {"mapped": 1})
    ref = str(tmp / "ref.npz")
    torch_cli(["newref", *infiles, ref, "--refsize", REFSIZE, "--device", "cpu"])
    return tmp, infiles, case, ref


@pytest.fixture(autouse=True)
def fresh_process(monkeypatch):
    """Each test sees a process in which no warm-up has run yet."""
    monkeypatch.setattr(warmup, "_started", {})
    monkeypatch.setattr(tdevice, "_readback", {})


def _warm_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("wcx-warm") and t.is_alive()]


def _argv(command, cohort, out):
    tmp, infiles, case, ref = cohort
    if command == "newref":
        return ["newref", *infiles, str(out / "ref.npz"), "--refsize", REFSIZE,
                "--device", "cpu"]
    if command == "predict":
        return ["predict", case, ref, str(out / "case"), "--bed",
                "--minrefbins", "10", "--device", "cpu"]
    return ["predict-batch", ref, str(out / "plate"), "--infiles", case,
            infiles[0], "--bed", "--minrefbins", "10", "--device", "cpu"]


def _record(monkeypatch, events):
    """Log each warm step's end (with its thread's name) and the main
    path's input loads and first device uses.  The warm steps are slowed
    down, so a main path that did not wait for them would get to the
    device first."""
    def slow(fn, name):
        def run(*args, **kwargs):
            time.sleep(0.2)
            fn(*args, **kwargs)
            events.append((name, threading.current_thread().name))
        return run

    for name in ("_warm_library", "warm_translate"):
        monkeypatch.setattr(warmup, name, slow(getattr(warmup, name), name))

    def log(module, name, label):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            events.append((label, sorted(k for k, _ in warmup._started)))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, run)

    from wisecondorx_tpu_torch import cli

    log(cli, "load_sample_npz", "load")
    log(reference, "_build_passes", "device")
    log(ref_loader, "build_pass_tables", "device")


@pytest.mark.parametrize("command", ["newref", "predict", "predict-batch"])
def test_cli_starts_the_warmup_first_and_joins_it_before_the_device(
        cohort, tmp_path, monkeypatch, command):
    events = []
    _record(monkeypatch, events)
    torch_cli(_argv(command, cohort, tmp_path))
    names = [e[0] for e in events]
    threads = dict(events)
    kind, step = (("newref", "_warm_library") if command == "newref"
                  else ("predict", "warm_translate"))
    assert events[names.index("load")][1] == [kind], \
        "not started before the inputs"
    assert names.index(step) < names.index("device")
    assert threads[step].startswith(f"wcx-warmup-{kind}-cpu")
    assert not _warm_threads()


@pytest.mark.parametrize("command", ["newref", "predict", "predict-batch"])
def test_a_failing_warmup_fails_the_cli(cohort, tmp_path, monkeypatch, command):
    def boom(device):
        raise RuntimeError(PLANTED)

    monkeypatch.setattr(warmup, "_warm_context", boom)
    with pytest.raises(RuntimeError, match=PLANTED):
        torch_cli(_argv(command, cohort, tmp_path))
    assert not _warm_threads()
    assert not [p for p in tmp_path.rglob("*") if p.is_file()]


def test_a_failing_warmup_exits_non_zero(cohort, tmp_path):
    """In a fresh process, as a user runs it: the warm-up's error, and the
    exit code is not 0."""
    code = (
        "import sys\n"
        "from wisecondorx_tpu_torch.utils import warmup\n"
        "def boom(device):\n"
        f"    raise RuntimeError({PLANTED!r})\n"
        "warmup._warm_context = boom\n"
        "from wisecondorx_tpu_torch.cli import main\n"
        "main(sys.argv[1:])\n"
    )
    run = subprocess.run([sys.executable, "-c", code,
                          *_argv("newref", cohort, tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert PLANTED in run.stderr
    assert not (tmp_path / "ref.npz").exists()


@pytest.mark.parametrize("command", ["newref", "predict", "predict-batch"])
def test_only_newref_warmup_loads_the_kernel_library(cohort, tmp_path,
                                                     monkeypatch, command):
    """With the library step's device check patched to the card's and a
    library that does not build, newref fails with the build's error and
    writes nothing; predict and predict-batch, whose main path launches no
    KNN kernel, do not load the library and succeed."""
    def no_nvcc():
        raise RuntimeError(PLANTED)

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", no_nvcc)
    library = warmup._warm_library
    monkeypatch.setattr(warmup, "_warm_library",
                        lambda device: library(torch.device("cuda")))
    argv = _argv(command, cohort, tmp_path)
    if command == "newref":
        with pytest.raises(RuntimeError, match=PLANTED):
            torch_cli(argv)
        assert not [p for p in tmp_path.rglob("*") if p.is_file()]
    else:
        torch_cli(argv)
        assert list(tmp_path.rglob("*_bins.bed"))
    assert not _warm_threads()


@pytest.mark.parametrize("kind", ["predict", "predict-batch"])
def test_predict_warmups_load_the_row_formatter(cohort, monkeypatch, kind):
    """predict's and predict-batch's warm-ups load the ``_bins.bed`` row
    formatter and the z-score's null-sum pass, so the first table a
    process writes does not build or load either on the critical path;
    newref's does not."""
    _, _, _, ref = cohort
    monkeypatch.setattr(tables, "_formatter", None)
    monkeypatch.setattr(stats, "_null_sums", None)
    reset_stage_times()
    warmup.start_warmup([CPU]).result()
    assert tables._formatter is None
    assert stats._null_sums is None
    if kind == "predict":
        warmup.start_predict_warmup(ref, CPU).result()
    else:
        warmup.start_predict_batch_warmup(ref, [CPU]).result()
    assert tables._formatter
    assert stats._null_sums
    assert "warmup.tables" in stage_times()


def test_warmup_touches_no_random_state(cohort):
    _, _, _, ref = cohort
    np.random.seed(11)
    torch.manual_seed(11)
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    warmup.start_warmup([CPU]).result()
    warmup.start_predict_warmup(ref, CPU).result()
    warmup.start_predict_batch_warmup(ref, [CPU]).result()
    after = np.random.get_state()
    assert np_state[0] == after[0]
    np.testing.assert_array_equal(np_state[1], after[1])
    assert np_state[2:] == after[2:]
    assert torch.equal(torch_state, torch.get_rng_state())


def test_warm_launches_stay_out_of_the_main_counters(cohort):
    _, _, _, ref = cohort
    knn_cuda.reset_launch_counts()
    rounds = dict(tcbs.ROUNDS)
    reset_stage_times()
    warmup.start_warmup([CPU]).result()
    warmup.start_predict_warmup(ref, CPU).result()
    assert knn_cuda.LAUNCHES == {"knn_bucket": 0, "knn_topk": 0}
    assert tcbs.ROUNDS == rounds
    assert {"warmup.context", "warmup.translate",
            "warmup.wait.newref", "warmup.wait.predict"} <= set(stage_times())
    assert threading.get_native_id() not in tdevice.warm_thread_ids()
    assert tdevice.warm_thread_ids()


def test_a_second_start_does_nothing_unless_the_first_failed(monkeypatch):
    calls = []

    def library(device):
        calls.append(device)
        if len(calls) == 1:
            raise RuntimeError(PLANTED)

    monkeypatch.setattr(warmup, "_warm_library", library)
    with pytest.raises(RuntimeError, match=PLANTED):
        warmup.start_warmup([CPU]).result()
    first = warmup.start_warmup([CPU])  # a fresh attempt
    first.result()
    second = warmup.start_warmup([CPU])
    second.result()
    assert calls == [CPU, CPU]
    assert second._futures == first._futures
    assert len(tdevice.warm_readback_channel([CPU])) == 1
    assert not _warm_threads()
