#!/usr/bin/env python3
"""Smoke run of the PyTorch port (wisecondorx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line on stdout (logs go to stderr):

1. device  -- requires torch.cuda.is_available(); prints the card's name
   and power limit as nvidia-smi reports them;
2. build   -- compiles the CUDA kernels from wisecondorx_tpu_torch/csrc
   (one nvcc per source, in parallel) and prints each one's ptxas report;
3. cohort  -- a synthetic cohort at 50 kb bins over the whole genome
   (tests/synthetic.py CohortSim, genome_scale 1.0, ~62k bins), 100 female +
   100 male controls, seed 0, written as convert-stage sample npz files,
   then the cases and the plate below from the same simulator;
4. newref  -- ``wisecondorx_tpu_torch.cli newref --device cuda`` (one
   process, no checkpoint), with its stages and peak
   device memory;
5. predict -- ``predict --bed`` (streamed reference loader, device CBS
   permutation stream) on a trisomy-21 sample (must call a chr21 gain, and
   the bins table must cover every bin, and no other whole chromosome) and
   on a euploid male (must call no whole-chromosome aberration), each
   with its ``predict.load.*`` stages; then each sample's two passes'
   tables built again on the card by the streamed loader (stored int32
   indexes and the packed cutoff bits uploaded, translated there), with
   the bytes moved and the translate and upload seconds, held bit for bit
   against the plain numpy translation of the same members, whose host
   seconds stand beside them; for the trisomy-21 sample, its autosomal and
   gonosomal passes dispatched under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync before the
   first fetch fails) and equal to the sequential passes; then
   ``cbs_rounds``: the CBS rounds of both predicts, which must all be
   device-stream rounds; then ``warmup``: the ``warmup.*`` stages of both
   calls (newref's must have loaded the kernel library, predict's
   translated its small table, and each must have been joined); each
   predict line (and phase 7's) carries ``z_rows``, ``ops.stats.Z_ROWS``
   over the call, which must show every null-table row of the z-scores
   taking the native pass; then ``z_sums`` (:func:`phase_z_sums`, host
   only): the z-scores' null sums at the two benchmark cells' shapes;
6. cold -- what a fresh process pays (:func:`phase_cold`): the
   interpreter alone, ``import torch`` (walls and ``-X importtime``'s
   largest modules), and a probe process that times the imports,
   ``resolve_devices``, the context, the kernel library (hash, build
   check, load), the first and second call of each kernel family of the
   path and the first page-locked blocks, and its own exit; then one
   ``newref`` and one ``predict --bed`` of the trisomy-21 sample through
   the CLI in fresh processes, beside the in-process walls and stages of
   phases 4-5; the fresh reference must equal phase 4's and the fresh
   tables phase 5's byte for byte;
7. predict_batch -- ``predict-batch --bed`` on a plate of 24 samples
   (trisomies 21, 18 and 13, a 10 Mb deletion on chr5, the euploid male,
   19 euploid females) plus one corrupt npz: the exit code must be 3, every
   planted event called, no euploid sample called whole-chromosome, any
   other whole-chromosome call of an aneuploid sample made again by its
   single predict and by the reference path (CPU float64 normalization,
   host permutation stream), and the trisomy-21 sample's segments and
   calls equal to its single predict's;
8. cbs_stream -- on the trisomy-21 sample's CBS jobs: one round's Threefry
   keys equal on CUDA (the kernel) and the CPU, the first-level decisions
   of the device stream equal on both; then ``cbs_kernels``
   (:func:`cbs_kernel_checks`): the CBS kernels (csrc/cbs_arcs.cu's arc
   max and argmax, csrc/cbs_keys.cu's sort keys) against their plain
   PyTorch versions on the card at the sample's first round (n_pad 8,192,
   thin), its exact-mode bucket (n_pad 2,048) and a seeded bench-shape
   round (two segments of 15 kb chr1 and chr2 sizes, n_pad 32,768): keys
   bit-equal, maxima bit-equal with the same NaN and -inf positions,
   exceed counts equal, (i*, L*) equal on every first-level bucket, the NaN
   fixtures (:func:`cbs_arc_rows`) and the adversarial fixtures
   (:func:`cbs_adversarial_rows`) too, each timed beside its plain version
   and its bounds, with the number and share of arcs that took the exact
   formula past the screen; one whole device-stream round
   (``perm_round_device``) with the kernels and with the plain versions,
   beside its bound (:func:`_cbs_round_bound`); and the sample's CBS time
   with the device stream (kernels, then the plain versions on the card:
   equal segments) and with the host stream;
9. plots -- ``predict --bed --plot`` of the trisomy-21 sample through the
   CLI, timed with its scene, raster and encode stages; every figure
   decoded with ``read_png`` at its pixel size; gain-coloured pixels across
   chr21's gain dots on the genome-wide figure, none in chr1 and none
   outside a gain segment; every scene of the sample rendered again on the
   CPU and equal to the card's PNG bit for bit; ``predict-batch --bed
   --plot`` on the first four plate samples (every table and figure of
   each); ``newref --plotyfrac`` on the cohort (exit 0, a 1600 x 600 PNG,
   no reference);
10. kernels -- at the A-pass shape of the reference newref wrote (its mask
   and layout; rows = masked bins, 200 samples): K1 and K2 against their
   plain PyTorch versions on integer-valued inputs, where every distance is
   exact (tolerance 0), and K2 bit for bit on its edge fixtures
   (:func:`k2_edge_cases`); each kernel's time beside its plain version's,
   its bound (the larger of its operations at the TF32 peak and its bytes
   at the memory rate) and a library yardstick timed here and used nowhere
   in the port (``torch.topk`` of the pool for K2; for K1, which no single
   call matches, ``torch.mm`` of its product in full fp32); and the stored
   A-pass neighbours against the exact float64 search of the same
   PCA-corrected rows (neighbour-set agreement, mean >= 99.9 %, min >= 299
   of 300; median distance relative error <= 1e-6);
11. checkpoint -- newref with ``--checkpoint-dir``, stopped in process right
   after it saves its first ``knn_A_*`` artifact (``NewrefCheckpoint.save``
   patched), then run again: it resumes, writes a reference equal in every
   member to the newref phase's, removes the directory, and launches K1
   fewer times than the full build;
12. multidevice -- ``knn_search_multidevice`` on the A pass and
   ``predict_batch`` on the plate with the card listed twice (two parts,
   two host threads): equal bit for bit to one device;
13. multiproc -- newref and predict-batch as two worker processes on the
   one card, each with torchrun's environment on 127.0.0.1 and a timeout:
   process 0's reference (searched on the calling thread, through the
   all-gather) equals the newref phase's in every member, both
   processes launched both kernels, and the two plate shards together
   write every sample's outputs byte-equal to the predict_batch phase's;
14. wide -- newref through the CLI on 720 controls (360 F + 360 M) at 50
   kb, genome_scale 0.25, so the A pass's s_pad (736) is above the 672 at
   which K1 streams its rows; its stored neighbours meet the bar of phase 10
   against the exact float64 search; and K1 against its plain version
   (exact) at the A-pass row-chunk shape with 1,000 and 4,096 samples, each
   timed beside its bound;
15. trace -- the main cohort's newref, ``predict --bed --plot`` of the
   trisomy-21 sample and ``predict-batch --bed`` of the plate, then newref
   on bench.py's headline shape (15 kb bins over the whole genome, 250 F +
   250 M controls, seed 2), first untraced (its wall, stages, peak device
   memory and .npz size), then each through the CLI with ``WCX_PROFILE_DIR``
   set (only for those calls) to ``build/chip_smoke/trace/<shape>``;
   after the untraced bench newref, one untraced ``predict --bed`` of a
   trisomy-21 sample from the same simulator against its reference
   (``bench_predict``: wall, ``predict.load.*`` stages, peak device memory,
   the tables on the card against the plain translation's host seconds;
   chr21's gain and no other whole-chromosome call); one
   JSON line per traced stage name (:func:`trace_summary`: window, device
   busy ms and share, top device operations, longest idle gaps with their
   host ranges) and one per call (wall, busy share over its traced stages,
   the stages timed without a trace); the traced main newref's reference
   equal to the newref phase's, the traced bench newref's to the untraced
   one's; K1 and K2 kernel events in newref's traced stages at both shapes
   (the searches run on their own threads, so their kernels land in
   whatever stage the main thread traces), and traces with device kernels
   for ``predict.cbs`` (one from predict, one from predict-batch, each
   holding the CBS arc max and key kernels' events) and
   ``predict.plots.raster``; at the bench shape both kernels launched,
   their summed device time and traced launches, K1 and K2 at the A pass's
   first row chunk beside their plain versions, their bounds and their
   library yardsticks (``torch.mm`` of K1's product, ``torch.topk`` of K2's
   pool), K1's bound over the whole run, and the stored A-pass neighbours
   of the first BENCH_CHECK_ROWS rows against the exact float64 search
   (the bar of phase 10).

The kernels' launch counters are set to 0 just before newref and read just
after predict (the warm-ups launch no kernel): both KNN kernels
must have run on that path (predict-batch runs
no KNN kernel, nor do the plots), and the CBS arc max and keys (both
samples stay whole, so predict locates no split).  The CBS counters are
set to 0 again just before predict-batch and read just after: the plate
must have launched all three CBS kernels.  Each later path that searches (the resumed newref, the
two-device search, each worker's newref, the wide newref, the bench-shape
newref) is read the same way and must have launched both kernels too.
Then one JSON line lists the kernels (K1 with its wide-shape times, each
with its launches and the launches its traces caught in the traced main
newref, and its launches, traced launches, device time and chunk times in
the bench-shape newref; the CBS kernels with predict-batch's launches,
the main path's, and their times at every ``cbs_kernels`` shape, the
first shape's in the standard keys), and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, and the script exits non-zero without that line.  It
writes only under build/chip_smoke/ in the checkout.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
BINSIZE = 50000
GENOME_SCALE = 1.0
N_FEMALE = N_MALE = 100
SEED = 0
REFSIZE = 300
#: The KNN bar of the JAX package's f32 Pallas path against its f64
#: oracle (dev/tpu_vs_oracle.py): mean agreement >= 99.9 % and min
#: "99.67 %", which is 299 of 300 neighbours printed to two decimals.
MEAN_AGREE, MIN_AGREE = 0.999, 299 / 300
#: K1's masking threshold per sample in the kernel-vs-plain check.  Two
#: rows of integers drawn from [0, 8) lie 2 * 63/12 = 10.5 apart per sample
#: on average, so about half of the candidates reach the threshold and take
#: the ``d >= sentinel`` branch (on the real data the sentinel is far above
#: every distance).
INT_SENTINEL_PER_SAMPLE = 10.5
#: The plate's 10 Mb deletion: chr5 bins [1000, 1200) at 50 kb.
DELETION = (1000, 1200)
PLATE_EUPLOID = 19
#: The stored A-pass distances against the exact float64 ones: median
#: relative error at most this (the 3xTF32 products keep fp32 accuracy).
MAX_DIST_REL_ERR = 1e-6
#: Published H100 SXM peaks at 700 W (NVIDIA's data sheet): TF32 tensor
#: cores, dense, and device memory.
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12
#: FP32 and FP64 outside the tensor cores (NVIDIA's H100 SXM data sheet),
#: and 32-bit integer operations: 64 INT32 lanes per SM (Hopper
#: architecture whitepaper) x 132 SMs x 1.98 GHz boost clock.
H100_FP32_FLOPS = 67e12
H100_FP64_FLOPS = 34e12
H100_INT32_OPS = 64 * 132 * 1.98e9
#: 32-bit integer operations of one Threefry-2x32 block (csrc/cbs_keys.cu
#: threefry; its plain version ops/cbs.py threefry2x32): 2 key additions,
#: 20 rounds of an add, a rotation and a xor, and 5 key injections of 3
#: additions.  A rotation is one funnel shift on the card.
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3
#: Floating-point operations of one arc's |T| (csrc/cbs_arcs.cu, the
#: window loop and abs_t; its plain version ops/cbs.py _tstat_block), each
#: counted once: 4 differences of cumulative sums, 2 quotients, a
#: difference, 2 reciprocals, a sum, rsqrt, a product, abs and the
#: running max.
ARC_OPS = 14
#: Floating-point operations of the arc kernels' screen on a staged row
#: (csrc/cbs_arcs.cu screened_out; its plain version ops/cbs.py
#: arc_screen_reference), each counted once: the window's weight and
#: numerator differences, w0, the floor's sum, the square, the right
#: side's 2 products and the comparison.
SCREEN_OPS = 8
#: The same on a row read through L2, where each end's a[e] costs 3 more
#: (csrc/cbs_arcs.cu screen_a).
SCREEN_OPS_L2 = SCREEN_OPS + 3
#: FP64-pipe instructions of abs_t's fast path when the SASS cannot be
#: read (about 45; phase_build counts them from cuobjdump -sass), and the
#: H100's FP64 lane-instruction rate: 64 FP64 lanes per SM (Hopper
#: architecture whitepaper) x 132 SMs x 1.98 GHz boost clock.
ABS_T_INSTRS = 45
H100_FP64_INSTRS = 64 * 132 * 1.98e9
#: The plots phase: the plate samples it runs predict-batch --plot on, and
#: the pixel sizes of the figures (matplotlib's figsize x dpi).
PLOT_PLATE = 4
GENOME_WIDE_PX, CHROMOSOME_PX, YFRAC_PX = (1600, 2240), (1200, 1680), (600, 1600)
#: K2's edge fixtures: rows of pools of 64 buckets x 4 deep, k = 100.
EDGE_ROWS, EDGE_LANES, EDGE_DEPTH, EDGE_K = 8, 64, 4, 100
#: The wide cohort: 720 controls put the A pass's sample axis (s_pad 736)
#: above the 672 at which K1 stops keeping its row tile resident.
WIDE_FEMALE = WIDE_MALE = 360
WIDE_GENOME_SCALE = 0.25
#: Sample axes at which K1 is held to its plain version on the streamed
#: path, at the A-pass row-chunk shape.
WIDE_K1_SAMPLES = (1000, 4096)
#: Seconds each worker process of the multiproc phase may take.
WORKER_TIMEOUT = 400
#: The --device of every CLI call and worker.
CLI_DEVICE = "cuda"
#: The trace phase's second cohort: bench.py's headline shape (15 kb bins,
#: whole genome, 500 controls).
BENCH_BINSIZE = 15000
BENCH_GENOME_SCALE = 1.0
BENCH_FEMALE = BENCH_MALE = 250
BENCH_SEED = 2
#: The CBS kernels' bench-shape round: two segments of the sizes of chr1
#: and chr2 at 15 kb bins (about 249 and 242 Mb), in the n_pad 32,768
#: bucket.
BENCH_CBS_SIZES = (16597, 16133)
#: Rows of the bench-shape A pass held against the exact float64 search.
BENCH_CHECK_ROWS = 8192
#: Chrome-trace categories of device work, and of the host ranges that
#: label an idle gap of the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
#: Stages whose traces must hold device kernels: (shape, stage).
REQUIRED_TRACES = (("main", "predict.cbs"), ("main", "predict.plots.raster"))
#: Kernels that newref's traced stages must hold at both shapes, by the
#: names the traces give them.
NEWREF_TRACE_KERNELS = {"knn_bucket": "knn_bucket_kernel",
                        "knn_topk": "knn_topk_kernel"}
#: CBS kernels that the traced predict.cbs stages (predict and
#: predict-batch, main shape) must hold.
CBS_TRACE_KERNELS = ("arc_max_kernel", "cbs_keys_kernel")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` runs after one warm run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    for part in ("wisecondorx_tpu_torch", os.path.join("tests", "synthetic.py")):
        if not os.path.exists(os.path.join(REPO, part)):
            raise SystemExit(f"chip_smoke: {part} is missing; run from a checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    return torch.device("cuda")


def phase_build():
    """Builds the kernels (one nvcc per source, in parallel) and prints each
    source's ptxas report: registers, shared memory, spills; then counts
    the FP64 instructions of the arc kernels' exact formula and screen
    (:func:`sass_counts`).  Returns the reports by source file name."""
    from wisecondorx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    ptxas = {}
    for src, log in sorted(_build.build_logs.items()):
        lines = [ln.replace("ptxas info    :", "").strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        ptxas[src] = "; ".join(lines)
        print(f"ptxas {src}: {ptxas[src]}", flush=True)
    seconds = round(time.perf_counter() - t0, 3)
    sass = sass_counts()
    emit("build", seconds=seconds, library=os.path.relpath(path, REPO),
         ptxas=ptxas, sass=sass)
    return ptxas


SASS_PROBE = r"""// abs_t and the screen of cbs_arcs.cu alone, to count their instructions.
#include "cbs_arcs.cu"

__global__ void probe_abs_t(const double* in, double* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  out[k] = abs_t(in[4 * k], in[4 * k + 1], in[4 * k + 2], in[4 * k + 3]);
}

__global__ void probe_screen(const double* in, int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  Row r;
  r.W = in[0];
  r.X = in[1];
  r.F = in[2];
  out[k] = screened_out(__dsub_rn(in[4 + 4 * k], in[5 + 4 * k]),
                        __dsub_rn(in[6 + 4 * k], in[7 + 4 * k]), r, in[3]);
}
"""
#: Opcodes that issue to the FP64 pipe.
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX",
                "MUFU.RCP64H", "MUFU.RSQ64H")


def sass_counts():
    """FP64-pipe instructions of csrc/cbs_arcs.cu's abs_t and of its screen
    (the window differences included), read from ``cuobjdump -sass`` of a
    probe kernel each (SASS_PROBE, built with the library's flags): on the
    straight path up to the first EXIT (the divisions' slow paths lie
    past it) and in the whole function.  Sets ABS_T_INSTRS.  None where
    the toolkit has no cuobjdump."""
    global ABS_T_INSTRS
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from wisecondorx_tpu_torch.ops import _build

    cuobjdump = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    work = os.path.join(WORK, "sass")
    os.makedirs(work, exist_ok=True)
    src, cubin = os.path.join(work, "probe.cu"), os.path.join(work, "probe.cubin")
    with open(src, "w") as f:
        f.write(SASS_PROBE)
    flags = [a for a in _build.NVCC_FLAGS if a not in ("-Xcompiler", "-fPIC",
                                                       "-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", str(_build.CSRC),
                    "-o", cubin, src], check=True, capture_output=True, timeout=600)
    dump = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    op = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")
    for line in dump.splitlines():
        if "Function :" in line:
            name = next((k for k in ("probe_abs_t", "probe_screen") if k in line), None)
            if name:
                counts[name] = {"straight": 0, "all": 0, "exit": False}
            continue
        m = op.search(line)
        if not (name and m):
            continue
        c = counts[name]
        opcode = m.group(1)
        if opcode == "EXIT":
            c["exit"] = True
        elif any(opcode == p or opcode.startswith(p + ".") for p in FP64_OPCODES):
            c["all"] += 1
            c["straight"] += not c["exit"]
    out = {k: {"straight": v["straight"], "all": v["all"]} for k, v in counts.items()}
    if out.get("probe_abs_t", {}).get("straight"):
        ABS_T_INSTRS = out["probe_abs_t"]["straight"]
    print(f"sass FP64 instructions: {out}", flush=True)
    return out


def save_sample(path, sample, binsize=BINSIZE):
    """A convert-stage sample npz (the schema both CLIs read)."""
    import numpy as np

    np.savez_compressed(path, binsize=binsize, sample=sample,
                        quality={"mapped": 1})


def make_cohort():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import CohortSim

    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    sim = CohortSim(binsize=BINSIZE, genome_scale=GENOME_SCALE, seed=SEED)
    samples, _ = sim.cohort(N_FEMALE, N_MALE)
    files = []
    for i, s in enumerate(samples):
        path = os.path.join(WORK, f"control_{i:03d}.npz")
        save_sample(path, s)
        files.append(path)
    t21 = os.path.join(WORK, "case_t21.npz")
    save_sample(t21, sim.sample("F", cnvs=[_trisomy(sim, 21)]))
    euploid = os.path.join(WORK, "case_euploid.npz")
    save_sample(euploid, sim.sample("M"))
    plate = make_plate(sim, t21, euploid)
    emit("cohort", seconds=round(time.perf_counter() - t0, 3),
         samples=len(files), plate=len(plate), bins=int(sim.bins.sum()),
         binsize=BINSIZE)
    return samples, files, t21, euploid, plate


def _trisomy(sim, chrom):
    return (chrom, 0, len(sim.bias[chrom - 1]), 3.0)


def make_plate(sim, t21, euploid):
    """The predict-batch plate: the trisomy-21 case and the euploid male
    case from above, trisomies 18 and 13, a 10 Mb deletion and 19 euploid
    females (24 samples), then one corrupt ``.npz``.  Returns
    [(path, expected event or None)]; an event is (chromosome, start bin,
    end bin, "gain" or "loss")."""
    plate = [(t21, ("21", 0, len(sim.bias[20]), "gain")),
             (euploid, None)]
    for chrom in (18, 13):
        path = os.path.join(WORK, f"plate_t{chrom}.npz")
        save_sample(path, sim.sample("F", cnvs=[_trisomy(sim, chrom)]))
        plate.append((path, (str(chrom), 0, len(sim.bias[chrom - 1]), "gain")))
    path = os.path.join(WORK, "plate_del5.npz")
    save_sample(path, sim.sample("F", cnvs=[(5,) + DELETION + (1.0,)]))
    plate.append((path, ("5",) + DELETION + ("loss",)))
    for i in range(PLATE_EUPLOID):
        path = os.path.join(WORK, f"plate_euploid_{i:02d}.npz")
        save_sample(path, sim.sample("F"))
        plate.append((path, None))
    corrupt = os.path.join(WORK, "plate_corrupt.npz")
    with open(corrupt, "wb") as f:
        f.write(b"not a zip archive")
    plate.append((corrupt, "unreadable"))
    return plate


def phase_newref(files):
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    ref = os.path.join(WORK, "reference.npz")
    reset_stage_times()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli.main(["newref", *files, ref, "--binsize", str(BINSIZE),
              "--refsize", str(REFSIZE), "--device", CLI_DEVICE])
    wall = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in stage_times().items()}
    emit("newref", seconds=round(wall, 3),
         pipelined="newref.pass_A.prep" in stages,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), stages=stages)
    if "newref.pass_A.prep" not in stages:
        raise AssertionError("the one-process newref did not pipeline its passes")
    return ref, {"seconds": wall, "stages": stages}


def phase_predict(ref, case, tag, want_gain_chr, check_dispatch=False):
    """``predict --bed`` of ``case`` through the CLI, then its passes'
    tables built again on the card and held against the plain numpy
    translation (:func:`tables_vs_plain`) and, with ``check_dispatch``,
    both passes dispatched with syncs made errors
    (:func:`dispatch_without_sync`).  Returns its wall and stages."""
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.ops import stats
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    outid = os.path.join(WORK, tag)
    reset_stage_times()
    stats.reset_z_row_counts()
    t0 = time.perf_counter()
    cli.main(["predict", case, ref, outid, "--bed", "--device", CLI_DEVICE])
    wall = time.perf_counter() - t0
    stages = stage_times()
    z_rows = _z_rows_native(tag)
    gender, rows, whole = read_calls(outid, ref)
    tables = tables_vs_plain(ref, gender, torch.device(CLI_DEVICE))
    dispatch = (dispatch_without_sync(ref, case, torch.device(CLI_DEVICE), BINSIZE)
                if check_dispatch else None)
    emit("predict", sample=tag, gender=gender, seconds=round(wall, 3),
         cbs_seconds=round(stages["predict.cbs"], 3),
         aberrations=[f"{r[0]}:{r[1]}-{r[2]}:{r[-1]}" for r in rows],
         whole_chromosome=whole, tables=tables, dispatch=dispatch,
         z_rows=z_rows, stages={k: round(v, 3) for k, v in stages.items()})
    planted = set() if want_gain_chr is None else {f"{want_gain_chr}:gain"}
    if not planted <= set(whole):
        raise AssertionError(f"{tag}: no chr{want_gain_chr} gain in {rows}")
    if set(whole) - planted:
        raise AssertionError(f"{tag}: whole-chromosome calls {whole}")
    return {"seconds": wall, "stages": {k: round(v, 3) for k, v in stages.items()}}


def _z_rows_native(label):
    """``ops.stats.Z_ROWS`` since its reset; raises unless every null-table
    row of the z-scores took the native pass."""
    from wisecondorx_tpu_torch.ops import stats

    z_rows = dict(stats.Z_ROWS)
    if z_rows["numpy"] or not z_rows["native"]:
        raise AssertionError(f"{label}: z-score rows by route {z_rows}")
    return z_rows


def phase_z_sums(reps=9):
    """The segment z-score's null sums on the host at the predict cells'
    shapes (100 kb NIPT, 50 kb CNV; null width 100, 24 chromosomes, float32
    ratios, 1 % NaN and 0.1 % inf nulls): ``get_z_score`` over the
    chromosomes and over 72 CBS-like segments on the native pass and on
    numpy (equal by ``repr``), the native pass alone, and its one-pass
    bound, the table's bytes over the rate at which one core reads the
    same table (a ``uint64`` sum of its bits, which numpy vectorises).
    Medians of ``reps`` calls, the table warm."""
    import numpy as np

    from wisecondorx_tpu_torch.ops import stats

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return round(1e3 * sorted(times)[reps // 2], 3)

    assert stats.load_null_sums() is not None, "the null-sum pass did not build"
    rng = np.random.default_rng(SEED)
    shapes = []
    for name, n_bins in (("nipt100", 30830), ("cnv50", 61660)):
        edges = np.linspace(0, n_bins, 25).astype(int)
        table = rng.normal(0, 0.1, (n_bins, 100))
        table[rng.random(table.shape) < 0.01] = np.nan
        table[rng.random(table.shape) < 0.001] = np.inf
        ratios = rng.normal(0, 0.1, n_bins).astype(np.float32)
        ratios[rng.random(n_bins) < 0.05] = 0
        weights = rng.random(n_bins)
        cut = list(zip(edges[:-1], edges[1:]))
        r = [ratios[a:b] for a, b in cut]
        w = [weights[a:b] for a, b in cut]
        nr = [table[a:b] for a, b in cut]
        chromosomes = [[c, 0, b - a - 1, 0.01] for c, (a, b) in enumerate(cut)]
        segments = []
        for c, (a, b) in enumerate(cut):
            cuts = sorted(int(x) for x in rng.choice(np.arange(1, b - a), 2,
                                                      replace=False))
            bounds = [0, *cuts, b - a]
            segments += [[c, bounds[k], bounds[k + 1], 0.02] for k in range(3)]
        read_ms = median_ms(lambda: table.view(np.uint64).sum())
        record = {"shape": name, "bins": n_bins, "table_mb":
                  round(table.nbytes / 1e6, 2), "read_ms": read_ms,
                  "read_gb_s": round(table.nbytes / read_ms / 1e6, 2)}
        for kind, rows in (("chromosomes", chromosomes), ("segments", segments)):
            stats.reset_z_row_counts()
            native = [repr(z) for z in stats.get_z_score(rows, r, w, nr)]
            if stats.Z_ROWS["numpy"]:
                raise AssertionError(f"z_sums {name}: {stats.Z_ROWS}")
            record[f"{kind}_native_ms"] = median_ms(
                lambda: stats.get_z_score(rows, r, w, nr))
            record[f"{kind}_pass_ms"] = median_ms(
                lambda: stats._native_null_sums(rows, r, w, nr))
            with_numpy = stats._null_sums
            stats._null_sums = False
            try:
                plain = [repr(z) for z in stats.get_z_score(rows, r, w, nr)]
                record[f"{kind}_numpy_ms"] = median_ms(
                    lambda: stats.get_z_score(rows, r, w, nr))
            finally:
                stats._null_sums = with_numpy
            if native != plain:
                raise AssertionError(f"z_sums {name} {kind}: routes differ")
        shapes.append(record)
    emit("z_sums", shapes=shapes)
    return shapes


def tables_vs_plain(ref, gender, device, maskrepeats=5):
    """The A and ``gender`` passes' tables of ``ref`` built on ``device``
    by the streamed loader (stored indexes and cutoff source uploaded,
    translated on the card), each held bit for bit against the plain
    numpy translation of the same members (the host path the port ran
    before), which is timed on the host.  Fails on a difference.  Returns
    {pass: record}."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.io.npz import load_member_rows
    from wisecondorx_tpu_torch.models import ref_loader
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    out = {}
    reset_stage_times()
    with ref_loader.ReferenceLoader(ref, device) as loader:
        loader.start([gender], maskrepeats)
        cutoff, a_small = loader.cutoff(), loader.passes["A"]
        for g in ("A", gender):
            tables = loader.tables(g)
            got = tables.sentinel_idx.cpu().numpy()
            small, suffix = loader.passes[g], "" if g == "A" else f".{g}"
            ct = ref_loader.pass_ct(small, g)
            idx = load_member_rows(ref, f"indexes{suffix}", ct)
            dist = (load_member_rows(ref, f"distances{suffix}", ct)
                    if ref_loader.needs_distances(small, a_small, cutoff) else None)
            t0 = time.perf_counter()
            plain = ref_loader.plain_sentinel(small, g, cutoff, a_small, idx, dist)
            plain_s = time.perf_counter() - t0
            rows, k = plain.shape
            out[g] = dict(
                rows=rows, k=k, dtype=str(tables.sentinel_idx.dtype),
                source=ref_loader._cutoff_source(small, a_small, cutoff, ct, dist)[0],
                upload_bytes=tables.upload_bytes,
                parent_upload_bytes=(rows * k * 8 + tables.components.nbytes
                                     + tables.mean.nbytes),
                plain_translate_s=plain_s, equal=bool(np.array_equal(got, plain)),
                masked=int((plain < 0).sum()))
            if tables.sentinel_idx.dtype != torch.int64 or not out[g]["equal"]:
                raise AssertionError(f"pass {g}: the card's table differs from "
                                     f"the plain translation: {out[g]}")
    stages = stage_times()
    for g in out:
        for stage in ("translate", "upload"):
            out[g][f"{stage}_s"] = stages[f"predict.load.{stage}_{g}"]
    return out


def dispatch_without_sync(ref, case, device, binsize):
    """``case``'s autosomal and gonosomal passes dispatched one after the
    other with ``torch.cuda.set_sync_debug_mode("error")``, so that any
    host sync between the first dispatch and the first fetch raises; the
    fetched results must equal ``_pass_normalize``'s on the same tables.
    Returns a record."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.models import predictor
    from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader

    cfg = predictor.PredictConfig()
    sample = np.load(case, allow_pickle=True)["sample"].item()
    with ReferenceLoader(ref, device) as loader:
        sample, _, ref_gender, _ = predictor.prepare_sample(
            sample, binsize, loader.passes, loader.meta, cfg)
        loader.start([ref_gender], cfg.maskrepeats)
        passes = [(loader.passes[g], loader.tables(g)) for g in ("A", ref_gender)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            queued = [predictor._pass_normalize_dispatch(sample, p, t)
                      for p, t in passes]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dispatch_s = time.perf_counter() - t0
        fetched = [predictor._pass_fetch(q, t) for q, (_, t) in zip(queued, passes)]
        fetch_s = time.perf_counter() - t0 - dispatch_s
        sequential = [predictor._pass_normalize(sample, p, t) for p, t in passes]
    for got, want in zip(fetched, sequential):
        for g, w in zip(got, want):
            if not np.array_equal(g, w, equal_nan=True):
                raise AssertionError("the dispatched passes differ from "
                                     "_pass_normalize on the same tables")
    return dict(passes=["A", ref_gender], sync_debug="error",
                dispatch_s=dispatch_s, fetch_s=fetch_s,
                equal_to_sequential=True)


def read_calls(outid, ref, binsize=BINSIZE):
    """(gender, aberration rows, whole-chromosome calls "chr:type") of a
    predict output; checks that the bins table covers every bin."""
    import numpy as np

    n_rows = len(open(outid + "_bins.bed").read().splitlines()) - 1
    with open(outid + "_aberrations.bed") as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
    stats = open(outid + "_statistics.txt").read().splitlines()
    gender = next(ln.split(": ")[1] for ln in stats if ln.startswith("Gender"))
    bins_per_chr = np.load(ref)[f"bins_per_chr.{gender}"]
    if n_rows != int(np.sum(bins_per_chr)):
        raise AssertionError(
            f"{outid}: bins.bed has {n_rows} rows, want {np.sum(bins_per_chr)}"
        )
    names = {str(c + 1): c for c in range(22)} | {"X": 22, "Y": 23}
    whole = []
    for r in rows:
        span = (int(r[2]) - int(r[1]) + 1) / binsize
        if span >= 0.9 * bins_per_chr[names[r[0]]]:
            whole.append(f"{r[0]}:{r[-1]}")
    return gender, rows, whole


COLD_PROBE = r"""
import json, os, sys, time

t_start = time.perf_counter()
import torch

t_torch = time.perf_counter()
import wisecondorx_tpu_torch.cli

t_cli = time.perf_counter()
from wisecondorx_tpu_torch.device import resolve_devices

devices = resolve_devices("cuda")
t_resolve = time.perf_counter()
dev = devices[0]
out = {"spawn_s": t_start - float(sys.argv[1]),
       "import_torch_s": t_torch - t_start, "import_cli_s": t_cli - t_torch,
       "resolve_devices_s": t_resolve - t_cli,
       "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING")}


def timed(name, fn, runs=("first", "second")):
    for run in runs:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.setdefault(name, {})[run] = time.perf_counter() - t0


timed("context", lambda: (torch.zeros(8, device=dev) + 1).cpu())
import numpy as np
from wisecondorx_tpu_torch.ops import _build, knn_cuda
from wisecondorx_tpu_torch.ops.common import median
from wisecondorx_tpu_torch.models import ref_loader
from wisecondorx_tpu_torch.ops import cbs

timed("library_hash", _build.library_path, ("first",))
timed("library_build_check", _build.build, ("first",))
timed("library_dlopen", _build.load, ("first",))
box = {}


def filler(n, s):
    # [n, s] float64 values in [1, 2) from a hash of their positions.
    i = np.arange(n * s, dtype=np.uint64).reshape(n, s)
    h = (i * np.uint64(2654435761)) ^ (i >> np.uint64(7))
    return 1.0 + (h & np.uint64(0xFFFFFFFF)) % np.uint64(65521) / 65521.0


def segment():
    # CBS of one 256-bin step profile: Threefry keys, permutation rounds,
    # the split's exact location.
    x = np.where(np.arange(256) < 128, 1.0, 2.0) + 0.01 * np.sin(np.arange(256))
    rows = cbs.CBSConfig.perm_batch
    cbs._segment_jobs([(x, np.ones(256))], cbs.CBSConfig(nperm=rows,
                                                         perm_batch=rows), dev)


def inputs():
    r, n, s = 64, 2 * knn_cuda.LANES, 224
    cand = torch.as_tensor(filler(n, s) - 1.5, dtype=torch.float32,
                           device=dev)
    box["k1"] = (cand[:r].contiguous(), (cand[:r] ** 2).sum(1),
                 torch.zeros(r, dtype=torch.int32, device=dev),
                 torch.zeros(r, dtype=torch.int32, device=dev),
                 torch.full((r,), 64, dtype=torch.int32, device=dev),
                 cand, (cand ** 2).sum(1),
                 (torch.arange(n, device=dev) // 64).to(torch.int32), n, 1e30)
    box["x"] = torch.as_tensor(filler(4096, 200), dtype=torch.float32,
                               device=dev)
    box["idx"] = (torch.arange(4096, device=dev) * 7) % 4096
    box["t32"] = ((torch.arange(256 * 300, device=dev) * 7919) % 253).to(
        torch.int32).reshape(256, 300)


timed("inputs", inputs, ("first",))
timed("k1", lambda: box.update(pool=knn_cuda.bucket_scan(*box["k1"])))
timed("k2", lambda: knn_cuda.extract_topk(*box["pool"], 300))
timed("mm", lambda: box["x"].T @ box["x"])
timed("sort_median", lambda: median(box["x"], dim=0))
timed("gather", lambda: box["x"][box["idx"]][:, box["idx"][:100] % 200])
starts = torch.zeros(256, dtype=torch.int64, device=dev)
sizes = torch.full((256,), 3, dtype=torch.int64, device=dev)
bits = torch.full((256, 38), 0xA5, dtype=torch.uint8, device=dev)
timed("translate", lambda: ref_loader.translate_on_device(
    box["t32"], starts, sizes, ref_loader.keep_from_bits(bits, 300)))
timed("cbs", segment)


def pinned(nbytes):
    return lambda: box.update(p=torch.empty(nbytes, dtype=torch.uint8,
                                            pin_memory=True))


timed("pinned_64mib_first", pinned(64 << 20), ("first",))
box.pop("p")
timed("pinned_64mib_cached", pinned(64 << 20), ("first",))
timed("pinned_256mib_new", pinned(256 << 20), ("first",))
box.clear()
out["total_s"] = time.perf_counter() - t_start
out["end"] = time.perf_counter()
print("COLD " + json.dumps(out), flush=True)
"""

def _cli_process(argv):
    """The port's CLI with ``argv`` in a fresh process.  Returns (exit code,
    wall seconds, {stage: seconds} from its ``[timing]`` lines, stderr)."""
    import re

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "wisecondorx_tpu_torch.cli",
                          *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    stages = {}
    for name, secs in re.findall(r"\[timing\] (\S+): ([0-9.]+)s", run.stderr):
        stages[name] = round(stages.get(name, 0.0) + float(secs), 3)
    return run.returncode, wall, stages, run.stderr


def phase_cold(files, t21, ref, in_process):
    """What a fresh process pays on the card before and while it runs the
    main path: the interpreter alone (``python -c pass``), then one probe
    process (:data:`COLD_PROBE`) that times, in order, ``import torch``,
    ``import wisecondorx_tpu_torch.cli``, ``resolve_devices``, the context
    (first round trip), the kernel library (hash check, build check,
    load), the first and second call of each kernel family the path runs
    (K1, K2, cuBLAS, sort/median, gather, the int64 translation, a CBS
    segmentation with its Threefry rounds) and the first page-locked
    blocks; then one ``newref`` and one ``predict --bed`` of the
    trisomy-21 sample through the CLI, each in a fresh process, with their
    walls and stages beside the in-process ones (``in_process``: the
    newref and predict phases' records).  The fresh newref's reference
    must equal the newref phase's, and the fresh predict's tables the
    predict phase's byte for byte."""
    spawn, import_torch = [], []
    for code, walls in (("pass", spawn), ("import torch", import_torch)):
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
            walls.append(time.perf_counter() - t0)
    run = subprocess.run([sys.executable, "-X", "importtime", "-c", "import torch"],
                         capture_output=True, text=True, check=True, timeout=120)
    imports = []  # (self us, cumulative us, module) of each import
    for ln in run.stderr.splitlines():
        parts = ln.split("|")
        if ln.startswith("import time:") and parts[0].split()[-1].isdigit():
            imports.append((int(parts[0].split()[-1]), int(parts[1]),
                            parts[2].strip()))
    script = os.path.join(WORK, "cold_probe.py")
    with open(script, "w") as f:
        f.write(COLD_PROBE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, script, repr(t0)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    probe_wall = time.perf_counter() - t0
    returned = time.perf_counter()
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("COLD ")]
    if run.returncode or not lines:
        raise AssertionError(f"cold probe exited {run.returncode}:\n"
                             + run.stderr[-3000:])
    probe = json.loads(lines[-1][len("COLD "):])
    emit("cold_breakdown", interpreter_s=spawn, import_torch_process_s=import_torch,
         import_torch_cumulative_s=max(c for _, c, m in imports if m == "torch") / 1e6,
         import_torch_top_self_s=[[m, us / 1e6] for us, _, m in
                                  sorted(imports, reverse=True)[:8]],
         probe_wall_s=probe_wall, exit_s=returned - probe.pop("end"), **probe)

    problems = []
    out = os.path.join(WORK, "cold_reference.npz")
    code, wall, stages, err = _cli_process(
        ["newref", *files, out, "--binsize", str(BINSIZE), "--refsize",
         str(REFSIZE), "--device", CLI_DEVICE])
    if code:
        raise AssertionError(f"cold newref exited {code}:\n{err[-3000:]}")
    diff = _npz_differences(out, ref)
    if diff:
        problems.append(f"the cold newref's reference differs in {diff}")
    emit("cold_newref", seconds=wall, in_process_s=in_process["newref"]["seconds"],
         reference_differs=diff, stages=stages,
         in_process_stages=in_process["newref"]["stages"])
    outid = os.path.join(WORK, "cold_case_t21")
    code, wall, stages, err = _cli_process(
        ["predict", t21, ref, outid, "--bed", "--device", CLI_DEVICE])
    if code:
        raise AssertionError(f"cold predict exited {code}:\n{err[-3000:]}")
    single = os.path.join(WORK, "case_t21")
    differ = [suffix for suffix in ("_bins.bed", "_segments.bed",
                                    "_aberrations.bed", "_statistics.txt")
              if open(outid + suffix, "rb").read()
              != open(single + suffix, "rb").read()]
    if differ:
        problems.append(f"the cold predict's tables differ: {differ}")
    emit("cold_predict", seconds=wall,
         in_process_s=in_process["predict"]["seconds"], tables_differ=differ,
         stages=stages, in_process_stages=in_process["predict"]["stages"])
    if problems:
        raise AssertionError("; ".join(problems))


def phase_predict_batch(ref, plate, t21_outid, device):
    """``predict-batch`` of the plate: exit code 3 for the corrupt file,
    BED files for the 24 others, every planted event called, no
    whole-chromosome call on a euploid sample, every whole-chromosome call
    on an aneuploid sample besides its planted event made again by the
    reference path (:func:`_unplanted_calls`), and the trisomy-21 sample's
    segments and calls equal to its single-sample predict's."""
    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.ops import cbs, stats
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    outdir = os.path.join(WORK, "plate_out")
    reset_stage_times()
    cbs.reset_round_counts()
    cbs.reset_launch_counts()
    stats.reset_z_row_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["predict-batch", ref, outdir, "--bed", "--device", CLI_DEVICE,
                  "--infiles", *(path for path, _ in plate)])
    except SystemExit as e:
        code = e.code
    else:
        code = 0
    wall = time.perf_counter() - t0
    rounds = dict(cbs.ROUNDS)
    launches = dict(cbs.LAUNCHES)
    z_rows = _z_rows_native("predict-batch")
    stages = {k: round(v, 3) for k, v in stage_times().items()}
    if code != 3:
        raise AssertionError(f"predict-batch exited {code}, want 3")
    scored = [(p, ev) for p, ev in plate if ev != "unreadable"]
    calls, problems, unplanted = {}, [], []
    for path, event in scored:
        outid = os.path.join(outdir, os.path.basename(path)[:-4])
        for suffix in ("_bins.bed", "_segments.bed", "_aberrations.bed",
                       "_statistics.txt"):
            if not os.path.exists(outid + suffix):
                problems.append(f"{outid}{suffix} missing")
        gender, rows, whole = read_calls(outid, ref)
        name = os.path.basename(outid)
        if whole:
            calls[name] = [gender] + whole
        planted = set()
        if event is not None:
            chrom, lo, hi, kind = event
            if not any(r[0] == chrom and r[-1] == kind
                       and int(r[1]) < hi * BINSIZE and int(r[2]) > lo * BINSIZE
                       for r in rows):
                problems.append(f"{name}: planted {event} not called in {rows}")
            planted = {f"{chrom}:{kind}"}
        extra = sorted(c for c in whole if c not in planted)
        if extra and event is None:
            problems.append(f"{name}: whole-chromosome calls {extra} on a "
                            "euploid sample")
        elif extra:
            records, found = _unplanted_calls(ref, path, name, extra, planted,
                                              device)
            unplanted.append(records)
            problems += found
    problems += _batch_vs_single(os.path.join(outdir, "case_t21"), t21_outid)
    emit("predict_batch", samples=len(scored), exit_code=code,
         seconds=round(wall, 3), seconds_per_sample=round(wall / len(scored), 4),
         cbs_rounds=rounds, cbs_launches=launches, z_rows=z_rows, calls=calls,
         unplanted=unplanted, stages=stages)
    if rounds["device"] < 1 or rounds["host"]:
        raise AssertionError(f"predict-batch CBS rounds {rounds}: not the device stream")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched by predict-batch")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _unplanted_calls(ref, path, name, extra, planted, device):
    """A plate sample's whole-chromosome calls ``extra`` besides its
    ``planted`` one, held against the port's reference path.  A single
    ``predict`` on the card, and the CPU float64 normalization (the path
    the tests hold equal to the JAX package's CPU run) segmented with the
    host permutation stream (the JAX package's CPU stream, its arc
    statistic on the card), must both make exactly the same calls;
    otherwise the card's path made them and the plate fails.  Returns (a
    record of both, problems)."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.models.predictor import (
        PredictConfig,
        predict_bins,
        segment_bins,
    )
    from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader

    single = os.path.join(WORK, f"single_{name}")
    cli.main(["predict", path, ref, single, "--bed", "--device", CLI_DEVICE])
    whole_single = read_calls(single, ref)[2]
    cfg = PredictConfig()
    sample = np.load(path, allow_pickle=True)["sample"].item()
    with ReferenceLoader(ref, torch.device("cpu")) as loader:
        bins = predict_bins(sample, BINSIZE, None, cfg, loader=loader)
    chrom_names = [str(c + 1) for c in range(22)] + ["X", "Y"]
    whole_ref, segments = [], []
    for c, start, end, z, ratio in segment_bins(bins, cfg, device,
                                                 _device_stream=False):
        if (end - start < 0.9 * len(bins.results_r[c]) or z == "nan"
                or abs(z) <= cfg.zscore):
            continue
        whole_ref.append(f"{chrom_names[c]}:{'gain' if z > 0 else 'loss'}")
        segments.append([chrom_names[c], start, end, z, ratio])
    record = {"sample": name, "batch": extra, "single": sorted(whole_single),
              "reference_path": sorted(whole_ref), "reference_segments": segments}
    problems = []
    if set(whole_single) - planted != set(extra):
        problems.append(f"{name}: batch calls {extra}, single predict {whole_single}")
    if set(whole_ref) - planted != set(extra):
        problems.append(f"{name}: batch calls {extra}, reference path {whole_ref}")
    return record, problems


def _batch_vs_single(batch_outid, single_outid):
    """Differences between one sample's predict-batch and predict tables:
    segments and aberrations must have the same rows, coordinates and
    call types exactly and the same numbers to 1e-9 (the batched
    normalization reduces over other shapes on the card)."""
    problems = []
    for suffix in ("_segments.bed", "_aberrations.bed"):
        got, want = (open(o + suffix).read().splitlines()
                     for o in (batch_outid, single_outid))
        if len(got) != len(want):
            problems.append(f"{suffix}: {len(got)} rows in batch, {len(want)} single")
            continue
        for g, w in zip(got, want):
            g, w = g.split("\t"), w.split("\t")
            num = [i for i, v in enumerate(w) if _is_number(v) and i > 2]
            same_text = [x for i, x in enumerate(g) if i not in num] == [
                x for i, x in enumerate(w) if i not in num]
            close = all(_is_number(g[i]) and _close(float(g[i]), float(w[i]))
                        for i in num)
            if len(g) != len(w) or not same_text or not close:
                problems.append(f"{suffix}: batch row {g} != single row {w}")
    return problems


def _close(a, b):
    import math

    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-9 * max(1.0, abs(b))


def _is_number(v):
    try:
        float(v)
    except ValueError:
        return False
    return True


def phase_cbs_stream(ref, case, device):
    """The device permutation stream on the trisomy-21 sample's CBS jobs
    (its chromosomes at 50 kb): one round's Threefry keys on CUDA (the
    kernel) equal to the same call on the CPU (the plain version); the
    decisions of every first-level (bucket, mode) group equal on CUDA and on
    the CPU; the CBS kernels against their plain versions
    (:func:`cbs_kernel_checks`); one whole device-stream round
    (``perm_round_device``) with the kernels and with the plain versions on
    the card, beside its bound (:func:`_cbs_round_bound`); and the
    sample's CBS time with the device stream (kernels, then the plain
    versions on the card, whose segments must be equal) and the host stream.

    The decision check runs at ``nperm`` 40 (alpha 0.025, so two
    exceedances reject, as 1e-4 does at 10,000): the CPU side would
    otherwise take many minutes on the exact-length buckets.  Returns
    :func:`cbs_kernel_checks`' record."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.models.predictor import PredictConfig, predict_bins
    from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader
    from wisecondorx_tpu_torch.ops import cbs

    cpu = torch.device("cpu")
    pcfg = PredictConfig()
    sample = np.load(case, allow_pickle=True)["sample"].item()
    with ReferenceLoader(ref, device) as loader:
        bins = predict_bins(sample, BINSIZE, None, pcfg, loader=loader)
    args = (bins.results_r, bins.results_w, bins.ref_gender, bins.binsize)
    cfg = cbs.CBSConfig(alpha=pcfg.alpha, seed=0)
    jobs, _ = cbs._sample_jobs([args])
    salts = [cbs._job_salt(x, w) for x, w in jobs]

    def first_level(run_cfg):
        return cbs._group_items(
            [cbs._Item(ji, 0, len(x)) for ji, (x, _) in enumerate(jobs)
             if len(x) >= 2 * run_cfg.min_width], run_cfg)

    # One round's keys: the first group, as its first round allots rows.
    (n_pad, mode), items = first_level(cfg)[0]
    items = items[: cfg.seg_batch]
    b = max(64, cfg.perm_batch)
    active = list(range(len(items)))
    counts = cbs._alloc_rows(b, active, [cfg.nperm] * len(items))
    n_seg = np.array([it.n for it in items])

    def round_keys(dev):
        seg, words = cbs._round_rows(items, active, counts, salts, dev)
        n_rows = torch.as_tensor(n_seg, device=dev)[seg]
        return lambda: cbs.perm_keys(cbs.prng_key(cfg.seed), *words, n_rows, n_pad)

    keys_cpu = round_keys(cpu)()
    keys_equal = torch.equal(round_keys(device)().cpu(), keys_cpu)
    keys_ms = cuda_ms(round_keys(device))
    keys_shape = list(keys_cpu.shape)
    del keys_cpu

    kernels = cbs_kernel_checks(jobs, salts, first_level(cfg), cfg, device)

    # One whole round (keys, shuffle, arc statistic) at the same shape,
    # timed beside its bound, with the kernels and with the plain versions.
    w_seg, wx_seg, n_seg_t = cbs._seg_tables(items, jobs, n_pad, device)
    round_shape = [len(items), n_pad, mode]
    lengths = cbs._group_lengths(n_pad, cfg, mode)
    seg, words = cbs._round_rows(items, active, counts, salts, device)
    live = torch.ones(len(seg), dtype=torch.bool, device=device)
    obs0 = torch.zeros(len(items), dtype=w_seg.dtype, device=device)
    lengths_t = cbs._lengths_tensor(n_pad, cfg, mode, device)

    def one_round():
        return cbs.perm_round_device(
            cbs.prng_key(cfg.seed), w_seg, wx_seg, n_seg_t, seg, live, *words,
            obs0, lengths_t, cfg.min_width, cfg.kmax, n_max=int(n_seg.max()))

    round_ms = cuda_ms(one_round)
    with plain_cbs():
        round_plain_ms = cuda_ms(one_round)
    round_bound = _cbs_round_bound(n_seg[seg.cpu().numpy()], n_seg, n_pad,
                                   w_seg.element_size(), lengths, cfg)
    del w_seg, wx_seg

    # First-level decisions of the device stream on both devices.
    check_cfg = cbs.CBSConfig(alpha=0.025, nperm=40, seed=0)
    decisions = {}
    for name, dev in (("card", device), ("cpu", cpu)):
        out = []
        for (n_pad, mode), group in first_level(check_cfg):
            lengths = cbs._lengths_tensor(n_pad, check_cfg, mode, dev)
            for it in group:
                it.max_ones = int(np.floor(check_cfg.nperm * check_cfg.alpha)) + 1
            for chunk in cbs._chunks(group, check_cfg.seg_batch):
                cbs._perm_loop_device(chunk, jobs, salts, n_pad, lengths,
                                      check_cfg, dev)
            out.append([n_pad, mode, [(it.decision, it.exceed, it.done)
                                      for it in group]])
        decisions[name] = out

    # Whole-sample CBS on the card: the device stream with the kernels, then
    # with the plain versions, then the host stream.
    times = {}
    for route in ("device", "plain", "host"):
        cbs.reset_round_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_cbs():
                segs = cbs.exec_cbs(*args, cfg, device, _device_stream=True)
        else:
            segs = cbs.exec_cbs(*args, cfg, device,
                                _device_stream=route == "device")
        torch.cuda.synchronize()
        times[route] = (time.perf_counter() - t0, dict(cbs.ROUNDS), segs)
    splits = sum(d for _, _, g in decisions["cpu"] for d, _, _ in g)
    emit("cbs_stream", jobs=len(jobs), sizes=[len(x) for x, _ in jobs],
         keys_round_shape=keys_shape, keys_equal=keys_equal, keys_ms=keys_ms,
         keys_per_s=keys_shape[0] * keys_shape[1] / keys_ms * 1e3,
         round_segments_n_pad_mode=round_shape, round_ms=round_ms,
         round_plain_ms=round_plain_ms, round_bound=round_bound,
         decisions_equal=decisions["card"] == decisions["cpu"],
         first_level=decisions["card"], first_level_splits=splits,
         cbs_device_s=round(times["device"][0], 3),
         cbs_plain_s=round(times["plain"][0], 3),
         cbs_host_s=round(times["host"][0], 3),
         rounds_device=times["device"][1], rounds_plain=times["plain"][1],
         rounds_host=times["host"][1],
         segments=[len(times[r][2]) for r in ("device", "plain", "host")],
         plain_segments_equal=times["plain"][2] == times["device"][2])
    if not keys_equal:
        raise AssertionError("Threefry keys differ between CUDA and the CPU")
    if decisions["card"] != decisions["cpu"]:
        raise AssertionError("device-stream decisions differ between CUDA and the CPU")
    if times["plain"][2] != times["device"][2]:
        raise AssertionError("the CBS kernels' segments differ from the plain versions'")
    return kernels


@contextlib.contextmanager
def plain_cbs():
    """Within this context the CBS wrappers take their plain versions on
    the card too (``ops.cbs._on_card`` patched): the plain route, for
    comparisons only."""
    from wisecondorx_tpu_torch.ops import cbs

    saved = cbs._on_card
    cbs._on_card = lambda t: False
    try:
        yield
    finally:
        cbs._on_card = saved


def _nan_equal(got, want):
    """(NaN and -inf positions equal, bit-equal elsewhere, max abs error
    over the finite entries) of two float64 tensors."""
    import torch

    same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
    same_inf = torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(got) & torch.isfinite(want)
    bits = torch.equal(torch.where(torch.isnan(got), 0.0, got).view(torch.int64),
                       torch.where(torch.isnan(want), 0.0, want).view(torch.int64))
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    close = bool(torch.allclose(got[fin], want[fin], rtol=1e-12, atol=0.0))
    return same_nan and same_inf and close, same_nan and same_inf and bits, err


def cbs_kernel_checks(jobs, salts, groups, cfg, device):
    """The CBS kernels against their plain versions on the card, each
    timed beside its plain version and its bounds (:func:`_arc_bound`,
    :func:`_keys_bound`; the arc kernels' wrappers also as the kernel alone
    on precomputed sums, and the torch sums alone), at three shapes: the trisomy-21 sample's first
    round (its first (bucket, mode) group, as the round allots rows), its
    exact-mode group at n_pad 2,048, and a seeded bench-shape round (two
    segments of BENCH_CBS_SIZES bins, 15 kb chr1 and chr2, n_pad 32,768,
    thin).  The arc kernels get the sums cut to the largest segment, as the
    main path passes them (staged in shared memory at the first two shapes,
    read through L2 at the third).  Per shape: the keys bit-equal; the
    round's maxima (observed rows and permuted rows, as
    ``perm_round_device`` builds them) bit-equal with the same NaN and -inf
    positions, and the exceed counts equal; the number and share of arcs
    that took the exact formula.  The locate scan's (i*, L*) equal on every
    first-level bucket of the sample (timed on its largest) and on the
    bench segments.  Maxima bit-equal and (i*, L*) equal on the NaN
    fixtures (:func:`cbs_arc_rows` at n_pad 2,048 exact and 8,192 thin) and
    the adversarial fixtures (:func:`cbs_adversarial_rows` at those and at
    32,768 thin).  Returns {kernel: record} and emits one ``cbs_kernels``
    line; fails on any difference."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.ops import cbs

    rng = np.random.default_rng([SEED, 15000])
    bench_jobs = []
    for n in BENCH_CBS_SIZES:
        x = rng.normal(0.0, 0.1, n)
        x[n // 3: n // 3 + n // 20] += 0.3
        bench_jobs.append((x, rng.uniform(0.5, 1.5, n)))
    bench_salts = [cbs._job_salt(x, w) for x, w in bench_jobs]
    bench_items = [cbs._Item(ji, 0, len(x)) for ji, (x, _) in enumerate(bench_jobs)]
    first = groups[0]
    exact = next(g for g in groups if g[0] == (2048, "exact"))
    shapes = [("t21_first_round", jobs, salts, first),
              ("exact_2048", jobs, salts, exact),
              ("bench_round", bench_jobs, bench_salts,
               ((cbs._bucket(max(BENCH_CBS_SIZES)), "thin"), bench_items))]
    records = {"cbs_arc_max": [], "cbs_arc_argmax": [], "cbs_keys": []}
    problems = []
    b = max(64, cfg.perm_batch)

    def counted(fn, *args, **kwargs):
        count = torch.zeros(1, dtype=torch.int64, device=device)
        out = fn(*args, exact_arcs=count, **kwargs)
        return out, int(count)

    for name, sj, ss, ((n_pad, mode), items) in shapes:
        items = items[: cfg.seg_batch]
        active = list(range(len(items)))
        counts = cbs._alloc_rows(b, active, [cfg.nperm] * len(items))
        seg, words = cbs._round_rows(items, active, counts, ss, device)
        w_seg, wx_seg, n_seg = cbs._seg_tables(items, sj, n_pad, device)
        n_rows = n_seg[seg]
        key = cbs.prng_key(cfg.seed)
        keys = cbs.perm_keys(key, *words, n_rows, n_pad)
        keys_plain = cbs.perm_keys_reference(key, *words, n_rows, n_pad)
        sizes = n_rows.cpu().numpy()
        keys_err = int((keys - keys_plain).abs().max())
        records["cbs_keys"].append({
            "shape": name, "rows": len(sizes), "n_pad": n_pad,
            "equal": keys_err == 0, "max_abs_err": keys_err,
            "ms": cuda_ms(lambda: cbs.perm_keys(key, *words, n_rows, n_pad)),
            "plain_ms": cuda_ms(lambda: cbs.perm_keys_reference(
                key, *words, n_rows, n_pad)),
            **_keys_bound(sizes, n_pad)})
        w_p, wx_p = cbs.shuffle_rows(keys, w_seg[seg], wx_seg[seg])
        rows = (torch.cat([w_seg, w_p]), torch.cat([wx_seg, wx_p]),
                torch.cat([n_seg, n_rows]))
        del keys, keys_plain, w_p, wx_p
        lengths = cbs._lengths_tensor(n_pad, cfg, mode, device)
        n_max = max(it.n for it in items)
        arc_args = (*rows, lengths, cfg.min_width, cfg.kmax)
        got, exact_arcs = counted(cbs.max_t_rows, *arc_args, n_max=n_max)
        want = cbs.max_t_rows_reference(*arc_args)
        cw, cwx, _, chunks = cbs._arc_launch_args(*rows, lengths, n_max, None)
        close, bits, err = _nan_equal(got, want)
        s = len(items)
        ex = [np.bincount(seg.cpu().numpy(), minlength=s,
                          weights=(t[s:] >= t[:s][seg]).double().cpu().numpy()
                          ).astype(int).tolist() for t in (got, want)]
        records["cbs_arc_max"].append({
            "shape": name, "rows": len(sizes) + s, "n_pad": n_pad, "mode": mode,
            "width": n_max, "staged": cbs.arc_staged(n_max), "chunks": chunks,
            "equal": close, "bit_equal": bits, "max_abs_err": err,
            "exceed": ex[0], "exceed_equal": ex[0] == ex[1],
            "ms": cuda_ms(lambda: cbs.max_t_rows(*arc_args, n_max=n_max)),
            "kernel_ms": cuda_ms(lambda: cbs._arc_max_launch(
                cw, cwx, rows[2], lengths, cfg.min_width, cfg.kmax, n_max, chunks)),
            "sums_ms": cuda_ms(lambda: cbs._row_cumsums(rows[0], rows[1], n_max)),
            "plain_ms": cuda_ms(lambda: cbs.max_t_rows_reference(*arc_args)),
            **_arc_bound(np.concatenate([n_seg.cpu().numpy(), sizes]), n_pad,
                         lengths.cpu().numpy(), cfg.min_width, cfg.kmax,
                         exact_arcs=exact_arcs, staged=cbs.arc_staged(n_max))})
        if not (records["cbs_keys"][-1]["equal"] and bits and ex[0] == ex[1]):
            problems.append(f"{name}: keys {records['cbs_keys'][-1]['equal']}, "
                            f"maxima bit-equal {bits}, exceed {ex}")
        del rows, got, want, cw, cwx
        torch.cuda.empty_cache()

    # The locate scan on every first-level bucket of the sample, timed on
    # the largest, and on the bench segments.
    for name, sj, grouped in (("t21_buckets", jobs, groups),
                              ("bench_segments", bench_jobs,
                               [((cbs._bucket(max(BENCH_CBS_SIZES)), "thin"),
                                 bench_items)])):
        by_pad = {}
        for (n_pad, _), items in grouped:
            by_pad.setdefault(n_pad, []).extend(items)
        equal, err = True, 0
        for n_pad, items in by_pad.items():
            for chunk in cbs._chunks(items, cfg.seg_batch):
                tabs = cbs._seg_tables(chunk, sj, n_pad, device)
                got = cbs.locate_rows(*tabs, cfg.min_width,
                                      n_max=max(it.n for it in chunk))
                want = cbs.locate_rows_reference(*tabs, cfg.min_width)
                equal = equal and all(torch.equal(g, w) for g, w in zip(got, want))
                err = max([err] + [int((g - w).abs().max()) for g, w in zip(got, want)])
        n_pad = max(by_pad)
        timed = by_pad[n_pad][: cfg.seg_batch]
        n_max = max(it.n for it in timed)
        tabs = cbs._seg_tables(timed, sj, n_pad, device)
        got, exact_arcs = counted(cbs.locate_rows, *tabs, cfg.min_width, n_max=n_max)
        sizes = tabs[2].cpu().numpy()
        all_lengths = torch.arange(n_max, dtype=torch.int32, device=device)
        cw, cwx, _, chunks = cbs._arc_launch_args(*tabs, all_lengths, n_max, None)
        rec = {"shape": name, "rows": len(sizes), "n_pad": n_pad,
               "width": n_max, "staged": cbs.arc_staged(n_max), "chunks": chunks,
               "split": [got[0].cpu().tolist(), got[1].cpu().tolist()],
               "ms": cuda_ms(lambda: cbs.locate_rows(*tabs, cfg.min_width,
                                                     n_max=n_max)),
               "kernel_ms": cuda_ms(lambda: cbs._arc_argmax_launch(
                   cw, cwx, tabs[2], all_lengths, cfg.min_width, n_max, chunks)),
               "sums_ms": cuda_ms(lambda: cbs._row_cumsums(tabs[0], tabs[1], n_max)),
               "plain_ms": cuda_ms(lambda: cbs.locate_rows_reference(
                   *tabs, cfg.min_width), reps=1),
               **_arc_bound(sizes, n_pad, np.arange(n_pad), cfg.min_width, 0,
                            argmax=True, exact_arcs=exact_arcs,
                            staged=cbs.arc_staged(n_max))}
        rec.update(equal=equal, max_abs_err=err)
        records["cbs_arc_argmax"].append(rec)
        if not equal:
            problems.append(f"{name}: locate (i*, L*) differ from the plain version")

    # The NaN and adversarial fixtures.
    fixtures = {"nan_fixtures": [], "adversarial_fixtures": []}
    for family, make, cases in (
            ("nan_fixtures", cbs_arc_rows, ((2048, "exact"), (8192, "thin"))),
            ("adversarial_fixtures", cbs_adversarial_rows,
             ((2048, "exact"), (8192, "thin"), (32768, "thin")))):
        for n_pad, mode in cases:
            arrays = make(n_pad)
            n_max = int(arrays[2].max())
            w, wx, n = (torch.as_tensor(a, device=device) for a in arrays)
            lengths = cbs._lengths_tensor(n_pad, cfg, mode, device)
            got, exact_arcs = counted(cbs.max_t_rows, w, wx, n, lengths,
                                      cfg.min_width, cfg.kmax, n_max=n_max)
            want = cbs.max_t_rows_reference(w, wx, n, lengths, cfg.min_width, cfg.kmax)
            close, bits, err = _nan_equal(got, want)
            loc = [torch.equal(g, v) for g, v in zip(
                cbs.locate_rows(w, wx, n, cfg.min_width, n_max=n_max),
                cbs.locate_rows_reference(w, wx, n, cfg.min_width))]
            rec = {"n_pad": n_pad, "mode": mode, "width": n_max,
                   "nan_rows": int(torch.isnan(want).sum()),
                   "equal": close, "bit_equal": bits, "max_abs_err": err,
                   "locate_equal": all(loc), "exact_arcs": exact_arcs,
                   "arcs": _arc_count(arrays[2], lengths.cpu().numpy(),
                                      cfg.min_width, cfg.kmax)}
            fixtures[family].append(rec)
            if not (bits and all(loc)) or (family == "nan_fixtures"
                                           and not rec["nan_rows"]):
                problems.append(f"{family} {n_pad} {mode}: {rec}")
            del w, wx, n, got, want
            torch.cuda.empty_cache()
    emit("cbs_kernels", **records, **fixtures)
    if problems:
        raise AssertionError("; ".join(problems))
    return records


def _png_shapes(directory):
    """{file name: decoded image shape} of the PNGs in ``directory``, each
    read with read_png (CRCs checked)."""
    from wisecondorx_tpu_torch.output.png import read_png

    return {name: read_png(os.path.join(directory, name)).shape
            for name in sorted(os.listdir(directory))}


def _plot_dir_problems(directory, n_chr):
    """Problems of a --plot directory: the genome-wide figure and one
    figure per chromosome, at their pixel sizes."""
    shapes = _png_shapes(directory)
    problems = []
    if shapes.get("genome_wide.png") != GENOME_WIDE_PX + (3,):
        problems.append(f"{directory}: genome_wide.png {shapes.get('genome_wide.png')}")
    chrs = {n: v for n, v in shapes.items() if n.startswith("chr")}
    if len(chrs) != n_chr or any(v != CHROMOSOME_PX + (3,) for v in chrs.values()):
        problems.append(f"{directory}: chromosome figures {chrs}")
    return problems


def _chromosomes_with_data(outid):
    """How many chromosomes of a predict output's bins table hold a ratio
    (the plots draw a ratio of 0 as missing, and a chromosome without one
    gets no figure)."""
    import math

    chrom = set()
    with open(outid + "_bins.bed") as f:
        next(f)
        for line in f:
            row = line.split("\t")
            ratio = float(row[4])
            if math.isfinite(ratio) and ratio != 0:
                chrom.add(row[0])
    return len(chrom)


def _gain_pixels(image, scene, bins, segments, zscore):
    """Gain-coloured pixels of the genome-wide figure's main axes, leaving
    out the constitutional 3n line and the legend, which take that colour
    too: (share of the pixel columns of chr21's gain dots holding one,
    count in chr1's columns, count outside the columns of every gain
    segment's dots)."""
    import numpy as np

    from wisecondorx_tpu_torch.output import layout as L
    from wisecondorx_tpu_torch.output import plots, raster

    ax = scene.axes[0]
    r0, r1, c0, c1 = raster._clip_rect(scene, ax)
    gain = np.all(image == np.array(raster.rgb8(plots.COLOR_C), np.uint8), axis=2)
    mask = np.zeros_like(gain)
    mask[r0:r1, c0:c1] = gain[r0:r1, c0:c1]
    for line in ax.artists:
        if isinstance(line, L.Line) and tuple(line.color[:3]) == plots.COLOR_C:
            y = L.to_pixel(scene, ax, [0.0], line.y[:1])[1][0]
            w = max(line.lw * scene.dpi / 72, 1.0)
            a, b = raster.span(y - w / 2, y + w / 2)
            mask[max(a, 0):b] = False
    lr0, lr1, lc0, lc1 = raster.legend_layout(scene, ax)[0]
    mask[max(lr0, 0):lr1, max(lc0, 0):lc1] = False
    dots = next(a for a in ax.artists if isinstance(a, L.Scatter))
    radius = float(np.sqrt(dots.sizes.max()) * scene.dpi / 72 / 2) + 1
    n_chr = 24 if bins.ref_gender == "M" else 23
    ends = np.cumsum([len(bins.results_r[c]) for c in range(n_chr)])
    starts = ends - [len(bins.results_r[c]) for c in range(n_chr)]

    def cols(lo_bin, hi_bin, pad):
        x = L.to_pixel(scene, ax, np.array([lo_bin, hi_bin], float), np.zeros(2))[0]
        return slice(max(int(np.floor(x[0] - pad)), 0), int(np.ceil(x[1] + pad)))

    # chr21's gain dots (inside the view): the columns of their centres.
    in21 = ((dots.x >= starts[20]) & (dots.x < ends[20])
            & np.all(dots.colors == plots.COLOR_C, axis=1)
            & (dots.y >= ax.ylim[0]) & (dots.y <= ax.ylim[1]))
    centre_cols = np.unique(np.floor(L.to_pixel(scene, ax, dots.x[in21],
                                                 dots.y[in21])[0]).astype(int))
    chr21 = mask[:, centre_cols].any(axis=0) if len(centre_cols) else np.zeros(1)
    chr1 = int(mask[:, cols(starts[0], ends[0] - 1, 0)].sum())
    allowed = np.zeros(mask.shape[1], bool)
    for chrom, lo, hi, z, _ in segments:
        if not isinstance(z, str) and z > zscore:
            allowed[cols(starts[chrom] + lo, starts[chrom] + hi - 1, radius)] = True
    return float(chr21.mean()), chr1, int(mask[:, ~allowed].sum())


def phase_plots(ref, t21, plate, files, device):
    """``predict --bed --plot`` of the trisomy-21 sample through the CLI,
    timed with its stages; every figure decoded at its size; gain-coloured
    pixels across chr21 and nowhere outside a gain segment; every scene of
    that sample rendered again on the CPU, equal to the card's PNGs bit for
    bit; ``predict-batch --bed --plot`` on the first PLOT_PLATE plate
    samples (every file of every sample); ``newref --plotyfrac`` on the
    cohort (exit 0, a 1600 x 600 PNG, no reference)."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.output import plots
    from wisecondorx_tpu_torch.output.png import read_png
    from wisecondorx_tpu_torch.output.raster import render_scene
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    outid = os.path.join(WORK, "plots_t21")
    recorded = {}
    write_plots = plots.write_plots

    def recording(out, bins, segments, cfg, **kwargs):
        recorded.update(bins=bins, segments=segments, cfg=cfg, kwargs=kwargs)
        return write_plots(out, bins, segments, cfg, **kwargs)

    plots.write_plots = recording
    reset_stage_times()
    t0 = time.perf_counter()
    try:
        cli.main(["predict", t21, ref, outid, "--bed", "--plot", "--device", CLI_DEVICE])
    finally:
        plots.write_plots = write_plots
    predict_s = time.perf_counter() - t0
    stages = {k: round(v, 4) for k, v in stage_times().items()}
    plot_dir = outid + ".plots"
    bins, segments, cfg = recorded["bins"], recorded["segments"], recorded["cfg"]
    n_chr = 24 if bins.ref_gender == "M" else 23
    with_data = sum(1 for c in range(n_chr) if np.any(np.asarray(bins.results_r[c]) != 0))
    problems = _plot_dir_problems(plot_dir, with_data)
    if with_data != _chromosomes_with_data(outid):
        problems.append(f"{outid}: {with_data} chromosomes with data, the bins "
                        f"table {_chromosomes_with_data(outid)}")

    kwargs = {k: v for k, v in recorded["kwargs"].items() if k != "device"}
    scenes = plots.build_scenes(bins, segments, cfg, **kwargs)
    cpu = torch.device("cpu")
    differing, cpu_s = [], 0.0
    for scene in scenes:
        card = read_png(os.path.join(plot_dir, scene.name))
        t0 = time.perf_counter()
        again = render_scene(scene, cpu).numpy()
        cpu_s += time.perf_counter() - t0
        if not np.array_equal(card, again):
            differing.append(scene.name)
        if scene.name == "genome_wide.png":
            chr21_share, chr1_count, outside = _gain_pixels(
                card, scene, bins, segments, cfg.zscore)
    if chr21_share < 0.95 or chr1_count or outside:
        problems.append(f"gain pixels: chr21 columns {chr21_share}, chr1 {chr1_count}, "
                        f"outside gain segments {outside}")
    if differing:
        problems.append(f"CPU rasters differ from the card's in {differing}")

    # predict-batch --bed --plot on the first plate samples.
    batch = [p for p, ev in plate if ev != "unreadable"][:PLOT_PLATE]
    outdir = os.path.join(WORK, "plate_plots")
    reset_stage_times()
    t0 = time.perf_counter()
    cli.main(["predict-batch", ref, outdir, "--bed", "--plot", "--device", CLI_DEVICE,
              "--infiles", *batch])
    batch_s = time.perf_counter() - t0
    batch_stages = {k: round(v, 4) for k, v in stage_times().items()}
    for path in batch:
        base = os.path.join(outdir, os.path.basename(path)[:-4])
        for suffix in ("_bins.bed", "_segments.bed", "_aberrations.bed",
                       "_statistics.txt"):
            if not os.path.exists(base + suffix):
                problems.append(f"{base}{suffix} missing")
        problems += _plot_dir_problems(base + ".plots", _chromosomes_with_data(base))

    # newref --plotyfrac: the figure, and no reference.
    yfrac = os.path.join(WORK, "yfrac.png")
    never = os.path.join(WORK, "reference_yfrac.npz")
    t0 = time.perf_counter()
    try:
        cli.main(["newref", *files, never, "--binsize", str(BINSIZE),
                  "--plotyfrac", yfrac, "--device", CLI_DEVICE])
        code = 0
    except SystemExit as e:
        code = e.code
    yfrac_s = time.perf_counter() - t0
    yfrac_shape = read_png(yfrac).shape if os.path.exists(yfrac) else None
    if code != 0 or yfrac_shape != YFRAC_PX + (3,) or os.path.exists(never):
        problems.append(f"--plotyfrac: exit {code}, {yfrac_shape}, "
                        f"reference written: {os.path.exists(never)}")
    emit("plots", figures=len(scenes), predict_seconds=round(predict_s, 3),
         scene_s=stages.get("predict.plots.scene"),
         raster_s=stages.get("predict.plots.raster"),
         encode_s=stages.get("predict.plots.encode"),
         predict_stages=stages, cpu_raster_s=round(cpu_s, 3),
         cpu_equal=not differing, chr21_gain_columns=chr21_share,
         chr1_gain_pixels=chr1_count, gain_pixels_outside=outside,
         batch_samples=len(batch), batch_seconds=round(batch_s, 3),
         batch_seconds_per_sample=round(batch_s / len(batch), 4),
         batch_plot_s_per_sample={k.split(".")[-1]: round(v / len(batch), 4)
                                  for k, v in batch_stages.items()
                                  if k.startswith("predict.plots.")},
         batch_stages=batch_stages, yfrac_exit=code, yfrac_shape=yfrac_shape,
         yfrac_seconds=round(yfrac_s, 3))
    if problems:
        raise AssertionError("; ".join(problems))


def _cbs_round_bound(row_sizes, seg_sizes, n_pad, esz, lengths, cfg):
    """The least time of one device-stream permutation round
    (ops/cbs.py:perm_round_device) with rows of true sizes ``row_sizes``
    drawn from segments of sizes ``seg_sizes`` padded to ``n_pad``, values
    of ``esz`` bytes: bytes (the segment tables read once; the 31-bit sort
    keys, the permuted (w, wx) rows and their two cumulative sums written
    once; the arc statistic's per-row maxima) at the memory rate, the
    Threefry blocks at the INT32 rate, and the arcs this round's rows
    test (every valid window arc and wrap arc, ARC_OPS each) at the FP64
    or FP32 rate.  Returns {bytes, int32_ops, fp_ops, *_ms, bound_ms,
    bound_by}."""
    import numpy as np

    rows, s = len(row_sizes), len(seg_sizes)
    n_eff = int(np.max(row_sizes))
    nbytes = (2 * s * n_pad * esz + rows * n_pad * 4 + 2 * rows * n_pad * esz
              + 2 * rows * (n_eff + 1) * esz + (rows + s) * esz)
    int_ops = rows * n_pad * (THREEFRY_OPS + 3) + rows * 4 * THREEFRY_OPS
    arcs = _arc_count(np.concatenate([row_sizes, seg_sizes]), lengths,
                      cfg.min_width, cfg.kmax)
    fp_rate = H100_FP64_FLOPS if esz == 8 else H100_FP32_FLOPS
    times = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "int32": int_ops / H100_INT32_OPS * 1e3,
             "fp": arcs * ARC_OPS / fp_rate * 1e3}
    by = max(times, key=times.get)
    return {"bytes": nbytes, "int32_ops": int_ops, "fp_ops": arcs * ARC_OPS,
            "fp_bits": 8 * esz, **{f"{k}_ms": v for k, v in times.items()},
            "bound_ms": times[by], "bound_by": "bytes" if by == "bytes" else "operations"}


def _arc_count(row_sizes, lengths, min_width, kmax):
    """Valid arcs of rows of true sizes ``row_sizes``: every window arc of
    ``lengths`` and every wrap arc up to ``kmax`` (as ops/cbs.py counts
    them valid)."""
    import numpy as np

    lengths = np.asarray(lengths)
    lengths = lengths[lengths >= min_width]
    arcs = 0
    sizes, reps = np.unique(np.asarray(row_sizes), return_counts=True)
    for n, k in zip(sizes, reps):
        ok = lengths[lengths <= n - min_width]
        ks = np.arange(min_width, min(kmax, n - min_width) + 1)
        arcs += int(k) * (int(np.sum(n - ok + 1)) + int(np.sum(np.maximum(ks - 1, 0))))
    return arcs


def _arc_bound(row_sizes, n_pad, lengths, min_width, kmax, argmax=False,
               exact_arcs=None, staged=True):
    """The least time of one arc kernel call (csrc/cbs_arcs.cu) on rows of
    true sizes ``row_sizes``: its inputs read once (the two float64
    cumulative sums [rows, n_pad + 1], the int32 lengths, the int64 sizes)
    and its outputs written once (a float64 maximum, or two int64 (i*, L*),
    per row) at the memory rate, against the valid arcs (ARC_OPS each) at
    the FP64 rate: ``bound_ms``, the yardstick every PR is held to.
    Beside it, ``screened_ms``: every arc at the screen's SCREEN_OPS
    (SCREEN_OPS_L2 unless ``staged``) plus the ``exact_arcs`` that took the
    exact formula at ARC_OPS; and
    ``abs_t_floor_ms``: every arc at abs_t's ABS_T_INSTRS FP64
    instructions at the FP64 instruction rate, the floor of a kernel
    without the screen."""
    rows = len(row_sizes)
    arcs = _arc_count(row_sizes, lengths, min_width, kmax)
    nbytes = 2 * rows * (n_pad + 1) * 8 + len(lengths) * 4 + rows * 8 + rows * (
        16 if argmax else 8)
    ops_ms = arcs * ARC_OPS / H100_FP64_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    out = {"arcs": arcs, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "abs_t_floor_ms": arcs * ABS_T_INSTRS / H100_FP64_INSTRS * 1e3}
    if exact_arcs is not None:
        out.update(exact_arcs=exact_arcs, exact_share=exact_arcs / max(arcs, 1),
                   screened_ms=(arcs * (SCREEN_OPS if staged else SCREEN_OPS_L2)
                                + exact_arcs * ARC_OPS) / H100_FP64_FLOPS * 1e3)
    return out


def _keys_bound(row_sizes, n_pad):
    """The least time of one key kernel call (csrc/cbs_keys.cu): rows x
    n_pad int64 keys written and five int64 words per row read, against a
    Threefry block and 3 more operations per real slot, one per padding
    slot and four Threefry blocks per row at the INT32 rate."""
    import numpy as np

    rows = len(row_sizes)
    real = int(np.minimum(np.asarray(row_sizes), n_pad).sum())
    ops = (real * (THREEFRY_OPS + 3) + (rows * n_pad - real)
           + rows * 4 * THREEFRY_OPS)
    nbytes = rows * n_pad * 8 + rows * 5 * 8
    ops_ms, bytes_ms = ops / H100_INT32_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"int32_ops": ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def a_pass(samples, ref, device, binsize=BINSIZE):
    """The A pass of the reference newref wrote: its pass dict, masked
    layout, the PCA-corrected float32 rows it searched (rebuilt from the
    cohort with newref's own functions and the stored mask), and the
    controls' sexes as newref's gender model called them."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.models.ref_loader import load_reference
    from wisecondorx_tpu_torch.models.reference import (
        NewrefConfig,
        _normalize_and_pca,
        cohort_matrix,
    )

    dref = load_reference(ref, device)
    ref_a, ml = dref.passes["A"], dref.tables["A"].ml
    for key in ("indexes", "distances", "null_ratios", "pca_components"):
        if not np.isfinite(ref_a[key]).all():
            raise AssertionError(f"reference member {key} is not finite")
    cfg = NewrefConfig(binsize=binsize, refsize=REFSIZE)
    matrix, _, genders = cohort_matrix([(s, binsize) for s in samples], cfg)[:3]
    cohort = torch.as_tensor(matrix[: ml.layout.total_bins],
                             dtype=torch.float32, device=device)
    corrected = _normalize_and_pca(cohort, ml.mask, cfg)[0]
    if ref_a["indexes"].shape != (ml.n_masked, REFSIZE):
        raise AssertionError(f"indexes shape {ref_a['indexes'].shape}")
    return ref_a, ml, corrected, genders


def k2_edge_cases(seed=SEED):
    """K2's edge fixtures as numpy arrays, [(name, vals f32 [rows, pool],
    idx i32 [rows, pool], drop f32 [rows, lanes], k)], pools of
    EDGE_LANES x EDGE_DEPTH = 256 entries, unfilled slots +inf with index
    -1 as K1 leaves them, and the first row's drops all +inf:

    * ``negative``: standard normal values, half of them negative (the
      norm trick gives slightly negative distances between near-identical
      bins);
    * ``signed_zero``: 40 values -1, 120 zeros of random sign and the rest 1,
      so the k-th value (k = 100) lies among the zeros, where -0.0 and +0.0
      must tie and go by pool position;
    * ``ties_at_k``: integers 0-9, so a run of equal values straddles the
      k-th;
    * ``all_inf``: every slot unfilled;
    * ``short_pool``: 50 finite values, fewer than k, with finite drops on
      all rows but the first, which must be flagged;
    * ``k_equals_pool``: normal values with k = the whole pool.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    rows, lanes = EDGE_ROWS, EDGE_LANES
    pool = lanes * EDGE_DEPTH

    def case(name, vals, k=EDGE_K):
        vals = np.asarray(vals, np.float32)
        idx = np.stack([rng.permutation(10 * pool)[:pool] for _ in range(rows)])
        idx = np.where(np.isinf(vals), -1, idx).astype(np.int32)
        drop = rng.normal(1.5, 1.0, (rows, lanes)).astype(np.float32)
        drop[0] = np.inf
        return name, vals, idx, drop, k

    def shuffled(parts):
        return np.stack([rng.permutation(np.concatenate(parts)) for _ in range(rows)])

    signs = np.where(rng.random((rows, 120)) < 0.5, -1.0, 1.0)
    zeros = np.stack([rng.permutation(np.concatenate(
        [np.full(40, -1.0), signs[r] * 0.0, np.ones(pool - 160)])) for r in range(rows)])
    return [
        case("negative", rng.normal(0.0, 1.0, (rows, pool))),
        case("signed_zero", zeros),
        case("ties_at_k", rng.integers(0, 10, (rows, pool))),
        case("all_inf", np.full((rows, pool), np.inf)),
        case("short_pool", shuffled([rng.normal(0.0, 1.0, 50), np.full(pool - 50, np.inf)])),
        case("k_equals_pool", rng.normal(0.0, 1.0, (rows, pool)), k=pool),
    ]


def cbs_arc_rows(n_pad, seed=SEED, min_width=2):
    """Rows for the CBS arc kernels' checks as numpy arrays (w, wx float64
    [rows, n_pad], zero past each row's size; n int64 [rows]):

    * random rows (weights in [0.5, 1.5), values with a step) at sizes
      n_pad, random ones, 0, 1, 2 * min_width - 1 (no valid arc) and
      2 * min_width (one valid length);
    * ``zero_run``: three zero-weight slots, whose short arcs are 0/0 = NaN;
    * ``inner_block``: weight only on a middle block, so arcs around it
      have w0 = 0 and a NaN |T|;
    * ``nan_length``: a spike on the first two slots and two zero-weight
      slots further on, so the spike's length holds a NaN arc and drops out
      of the locate scan whole;
    * ties: a repeated random row, a flat row (every |T| is 0) and a row
      whose two equal bumps give equal maxima at two starts.
    """
    import numpy as np

    rng = np.random.default_rng([seed, n_pad])
    sizes = [n_pad, int(rng.integers(1, n_pad + 1)), int(rng.integers(1, n_pad + 1)),
             0, 1, 2 * min_width - 1, 2 * min_width]
    rows = []

    def random_row(n):
        w = rng.uniform(0.5, 1.5, n)
        x = rng.normal(0.0, 1.0, n)
        x[n // 3:] += 1.5
        return w, x

    for n in sizes:
        rows.append(random_row(min(n, n_pad)))
    n = n_pad
    w, x = random_row(n)
    w[n // 2: n // 2 + 3] = 0.0
    rows.append((w, x))  # zero_run
    w = np.zeros(n)
    w[n // 4: n // 4 + max(1, n // 4)] = 1.0
    rows.append((w, rng.normal(0.0, 1.0, n)))  # inner_block
    w, x = np.ones(n), rng.normal(0.0, 0.1, n)
    x[:2] += 50.0
    w[min(5, n - 2): min(7, n)] = 0.0
    rows.append((w, x))  # nan_length
    rows.append(rows[1])  # a repeated row
    rows.append((np.ones(n), np.full(n, 0.25)))  # flat
    x = np.zeros(n)
    x[1:3] = x[n - 3: n - 1] = 1.0
    rows.append((np.ones(n), x))  # two equal bumps
    return _arc_row_tables(rows, n_pad)


def _arc_row_tables(rows, n_pad):
    """(w, wx float64 [rows, n_pad], n int64 [rows]) of (w, x) rows."""
    import numpy as np

    w_all = np.zeros((len(rows), n_pad))
    wx_all = np.zeros((len(rows), n_pad))
    sizes = np.zeros(len(rows), dtype=np.int64)
    for r, (w, x) in enumerate(rows):
        w_all[r, : len(w)] = w
        wx_all[r, : len(w)] = w * x
        sizes[r] = len(w)
    return w_all, wx_all, sizes


#: The rows of :func:`cbs_adversarial_rows`, in order.
ADVERSARIAL_ROWS = ("near_flat", "ties", "tiny_weights", "huge_weights",
                    "huge_values", "tiny_values", "spike", "zero_runs",
                    "wide_weights", "short_near_flat")


def cbs_adversarial_rows(n_pad, seed=SEED):
    """Rows that push the arc kernels' screen (csrc/cbs_arcs.cu) to its
    edges, as :func:`cbs_arc_rows` returns them (ADVERSARIAL_ROWS names
    each):

    * ``near_flat``: values 0.25 plus 1e-14 noise, so every |T| is rounding
      noise and the absolute floor decides;
    * ``ties``: values in {0, 1} on a repeating pattern, so many arcs share
      the maximum exactly;
    * ``tiny_weights`` / ``huge_weights``: weights near 1e-300 / 1e150
      (underflow and overflow on the screen's sides: the row guard);
    * ``huge_values`` / ``tiny_values``: values near 1e150 / 1e-300;
    * ``spike``: one value of 1e12 among N(0, 0.1) noise;
    * ``zero_runs``: runs of zero weights (0/0 = NaN arcs);
    * ``wide_weights``: weights from 1e-12 to 1e12, whose cumulative sums
      absorb the small ones (window weights of 0, so NaN arcs);
    * ``short_near_flat``: ``near_flat`` at a random size below n_pad.
    """
    import numpy as np

    rng = np.random.default_rng([seed, n_pad, 13])
    n = n_pad
    rows = []
    rows.append((np.ones(n), 0.25 + 1e-14 * rng.normal(0.0, 1.0, n)))
    pattern = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0])
    rows.append((np.ones(n), np.resize(pattern, n)))
    rows.append((rng.uniform(0.5, 1.5, n) * 1e-300, rng.normal(0.0, 1.0, n)))
    rows.append((rng.uniform(0.5, 1.5, n) * 1e150, rng.normal(0.0, 1.0, n)))
    rows.append((rng.uniform(0.5, 1.5, n), rng.normal(0.0, 1.0, n) * 1e150))
    rows.append((rng.uniform(0.5, 1.5, n), rng.normal(0.0, 1.0, n) * 1e-300))
    x = rng.normal(0.0, 0.1, n)
    x[n // 2] = 1e12
    rows.append((rng.uniform(0.5, 1.5, n), x))
    w = rng.uniform(0.5, 1.5, n)
    for start in range(n // 5, n, max(1, n // 3)):
        w[start: start + 4] = 0.0
    rows.append((w, rng.normal(0.0, 1.0, n)))
    rows.append((10.0 ** rng.uniform(-12.0, 12.0, n), rng.normal(0.0, 1.0, n)))
    k = int(rng.integers(1, n + 1))
    rows.append((np.ones(k), 0.25 + 1e-14 * rng.normal(0.0, 1.0, k)))
    return _arc_row_tables(rows, n_pad)


def _bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations at the TF32
    tensor-core peak and the bytes at the memory rate."""
    ops_ms, bytes_ms = ops / H100_TF32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _k1_inputs(ml, s, device):
    """K1's arguments at the first row chunk of the A-pass shape of ``ml``
    with ``s`` samples, on integer-valued inputs (every distance exact in
    float32), and the share of distances the sentinel masks."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.ops import knn_cuda

    rng = np.random.default_rng(SEED)
    n, lanes = ml.n_masked, knn_cuda.LANES
    n_pad = -(-n // lanes) * lanes
    s_pad = -(-s // knn_cuda.S_MULTIPLE) * knn_cuda.S_MULTIPLE
    cand = torch.zeros((n_pad, s_pad), dtype=torch.float32, device=device)
    cand[:n, :s] = torch.as_tensor(rng.integers(0, 8, size=(n, s)),
                                   dtype=torch.float32, device=device)
    cnorm = (cand * cand).sum(dim=1)
    cchr = torch.full((cand.shape[0],), -2, dtype=torch.int32, device=device)
    cchr[:n] = torch.as_tensor(ml.chr_of_masked_bin, device=device)
    starts = torch.as_tensor(ml.masked_chr_starts, dtype=torch.int32, device=device)
    sizes = torch.as_tensor(ml.masked_bins_per_chr, dtype=torch.int32, device=device)
    r = min(knn_cuda.ROW_CHUNK, n)
    rchr = cchr[:r]
    sentinel = INT_SENTINEL_PER_SAMPLE * s
    d = cnorm[:256, None] + cnorm[None, :n] - 2.0 * (cand[:256] @ cand[:n].T)
    share = float((d >= sentinel).double().mean())
    if not 0.0 < share < 1.0:
        raise AssertionError(f"sentinel {sentinel} masks {share} of K1's input")
    return (cand[:r], cnorm[:r], rchr, starts[rchr.long()].contiguous(),
            sizes[rchr.long()].contiguous(), cand, cnorm, cchr, n,
            sentinel), share


def _k1_check(args):
    """K1 and its plain version on ``args``: (K1's pools, the plain
    version's, max_abs_err); raises unless they are equal."""
    import torch

    from wisecondorx_tpu_torch.ops import knn_cuda

    got = knn_cuda.bucket_scan(*args)
    want = knn_cuda.bucket_scan_reference(*args, lanes=knn_cuda.LANES,
                                          depth=knn_cuda.DEPTH)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(
            f"K1 pools differ from bucket_scan_reference at s_pad {args[0].shape[1]}"
        )
    return got, want, max(_max_abs(got[0], want[0]), _max_abs(got[2], want[2]))


def _k1_bound(args, got, s):
    """K1's bound on ``args`` with ``s`` real samples: 3xTF32 products of
    every row with every valid candidate; every input and output once."""
    return _bound(3 * 2 * args[0].shape[0] * args[8] * s,
                  _nbytes(*args[:8], *got))


def _stored_vs_exact(ref_a, ml, corrected, device, row_range=None):
    """The kernel search of the A pass (of its ``row_range`` rows, default
    all), timed, and the neighbours newref stored for those rows held
    against the exact float64 search of the same rows.  Returns the
    measures; raises below the bar."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.ops import knn, knn_cuda

    r0, r1 = row_range if row_range is not None else (0, ml.n_masked)
    layout_args = (ml.chr_of_masked_bin, ml.masked_chr_starts,
                   ml.masked_bins_per_chr)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn_cuda.knn_search_cuda(corrected, *layout_args, REFSIZE,
                             row_range=row_range, stats=stats)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_e, dist_e = knn.knn_search_exact(corrected.double(), *layout_args,
                                         REFSIZE, row_range=row_range)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    stored_idx = torch.as_tensor(ref_a["indexes"][r0:r1].astype(np.int64),
                                 device=device)
    stored_dist = torch.as_tensor(ref_a["distances"][r0:r1], dtype=torch.float64,
                                  device=device)
    agree = _agreement(stored_idx, idx_e, REFSIZE)
    rel = (stored_dist - dist_e).abs() / dist_e.abs().clamp(min=1e-300)
    out = dict(
        rows=r1 - r0, samples=corrected.shape[1],
        agree_mean=agree.mean(), agree_min=agree.min(),
        dist_rel_err_median=float(rel.median()),
        flagged_rows=stats["flagged_rows"],
        rerun_share=stats["flagged_rows"] / stats["n_rows"],
        search_s=round(search_s, 4), exact_f64_s=round(exact_s, 4),
    )
    if agree.mean() < MEAN_AGREE or agree.min() < MIN_AGREE:
        raise AssertionError(f"neighbour agreement below the bar: {out}")
    if not rel.median() <= MAX_DIST_REL_ERR:
        raise AssertionError(f"median distance error above {MAX_DIST_REL_ERR}: {out}")
    return out


def phase_kernels(ref_a, ml, corrected, device):
    """K1/K2 against their plain versions (and K2 on its edge fixtures),
    each with its time, its bound and its library yardstick; and the
    stored neighbours against the exact float64 search, at the A-pass
    shape."""
    import torch

    from wisecondorx_tpu_torch.ops import knn_cuda

    n, s = corrected.shape
    lanes, depth = knn_cuda.LANES, knn_cuda.DEPTH
    args, sentinel_share = _k1_inputs(ml, s, device)
    r, cand = args[0].shape[0], args[5]
    got, want, k1_err = _k1_check(args)
    k1_ms = cuda_ms(lambda: knn_cuda.bucket_scan(*args))
    k1_plain_ms = cuda_ms(
        lambda: knn_cuda.bucket_scan_reference(*args, lanes=lanes, depth=depth)
    )
    # K1's yardstick: the bare product of its distances in full fp32 (no
    # single call computes the distances and their bucketed top-M).
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_product_ms = cuda_ms(lambda: torch.mm(cand[:r], cand.T))
    k1_bound = _k1_bound(args, got, s)
    top = knn_cuda.extract_topk(*got, REFSIZE)
    top_ref = knn_cuda.extract_topk_reference(*want, REFSIZE)
    torch.cuda.synchronize()
    finite = torch.isfinite(top[0])
    if not (torch.equal(top[0], top_ref[0]) and torch.equal(top[2], top_ref[2])
            and torch.equal(top[1][finite], top_ref[1][finite])):
        raise AssertionError("K2 differs from extract_topk_reference")
    k2_err = _max_abs(top[0], top_ref[0])
    k2_ms = cuda_ms(lambda: knn_cuda.extract_topk(*got, REFSIZE))
    k2_plain_ms = cuda_ms(lambda: knn_cuda.extract_topk_reference(*want, REFSIZE))
    k2_topk_ms = cuda_ms(lambda: torch.topk(got[0], REFSIZE, dim=1, largest=False))
    # Each pool value and drop read once, the k chosen indexes, the outputs.
    k2_bound = _bound(0, _nbytes(got[0], got[2], top[1], *top))
    edges = k2_edges(device)
    del got, want, top, top_ref, args, cand

    result = dict(
        ref_size=REFSIZE, lanes=lanes, depth=depth,
        k1_sentinel=INT_SENTINEL_PER_SAMPLE * s, k1_sentinel_share=sentinel_share,
        **_stored_vs_exact(ref_a, ml, corrected, device),
        chunk_rows=r, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
        k1_product_ms=k1_product_ms, k1_bound_ms=k1_bound[0],
        k1_bound_by=k1_bound[1],
        k1_library="none: no single call computes distance + bucketed top-M",
        k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_topk_ms=k2_topk_ms,
        k2_bound_ms=k2_bound[0], k2_bound_by=k2_bound[1], k2_edges=edges,
    )
    emit("kernels", **result)
    return result, k1_err, k2_err


def k2_edges(device):
    """K2 against its plain version on each edge fixture, bit for bit
    (values, indexes and flags).  Returns {name: rows flagged}."""
    import torch

    from wisecondorx_tpu_torch.ops import knn_cuda

    out = {}
    for name, *arrays, k in k2_edge_cases():
        args = [torch.as_tensor(a, device=device) for a in arrays]
        got = knn_cuda.extract_topk(*args, k)
        want = knn_cuda.extract_topk_reference(*args, k)
        torch.cuda.synchronize()
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"K2 differs from extract_topk_reference on {name}")
        out[name] = int(got[2].sum())
    return out


def _max_abs(a, b):
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def _agreement(idx_a, idx_b, k):
    """Per-row share of common neighbours (dev/tpu_vs_oracle.py's metric)."""
    import torch

    a = torch.sort(idx_a, dim=1).values
    b = torch.sort(idx_b, dim=1).values
    # |a ∩ b| of sorted rows of distinct values via searchsorted.
    pos = torch.searchsorted(b, a).clamp(max=k - 1)
    common = (b.gather(1, pos) == a).sum(dim=1).double() / k
    return common.cpu().numpy()


def launches_of(label, fn):
    """Run ``fn`` with the kernels' launch counts set to 0 just before and
    read just after; fails unless both kernels ran.  Returns (its result,
    the counts, seconds)."""
    from wisecondorx_tpu_torch.ops import knn_cuda

    knn_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    counts = dict(knn_cuda.LAUNCHES)
    for name, count in counts.items():
        if count < 1:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    return out, counts, seconds


def _npz_differences(path_a, path_b):
    """Members of two .npz files that differ (in name or in any byte)."""
    import numpy as np

    a, b = (np.load(p, allow_pickle=True) for p in (path_a, path_b))
    diff = sorted(set(a.files) ^ set(b.files))
    for key in sorted(set(a.files) & set(b.files)):
        x, y = a[key], b[key]
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            diff.append(key)
    return diff


class SimulatedCrash(Exception):
    """Stops newref in the checkpoint phase, as a crash would."""


def phase_checkpoint(files, ref, full_launches):
    """newref with ``--checkpoint-dir``, stopped right after it saves its
    first ``knn_A_*`` artifact (``NewrefCheckpoint.save`` patched in
    process), then run again: it must resume, write a reference equal in
    every member to the newref phase's, remove the directory, and launch
    K1 fewer times than the full build did."""
    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.ops import knn_cuda
    from wisecondorx_tpu_torch.utils import checkpoint

    ckdir = os.path.join(WORK, "checkpoint")
    out = os.path.join(WORK, "reference_resumed.npz")
    argv = ["newref", *files, out, "--binsize", str(BINSIZE), "--refsize",
            str(REFSIZE), "--device", CLI_DEVICE, "--checkpoint-dir", ckdir]
    save = checkpoint.NewrefCheckpoint.save

    def crashing_save(self, name, **arrays):
        save(self, name, **arrays)
        if name.startswith("knn_A_"):
            raise SimulatedCrash(name)

    checkpoint.NewrefCheckpoint.save = crashing_save
    knn_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    except SimulatedCrash:
        pass
    else:
        raise AssertionError("newref finished without saving a knn_A_ artifact")
    finally:
        checkpoint.NewrefCheckpoint.save = save
    crashed_s = time.perf_counter() - t0
    crashed = dict(knn_cuda.LAUNCHES)
    left = sorted(os.listdir(ckdir))
    _, resumed, resumed_s = launches_of("resumed newref", lambda: cli.main(argv))
    diff = _npz_differences(out, ref)
    emit("checkpoint", left_by_crash=left, crashed_launches=crashed,
         resumed_launches=resumed, full_launches=full_launches,
         crashed_seconds=round(crashed_s, 3), resumed_seconds=round(resumed_s, 3),
         members_differing=diff, equal_to_newref=not diff,
         directory_removed=not os.path.exists(ckdir))
    if not any(f.startswith("knn_A_") for f in left) or "prep_A.npz" not in left:
        raise AssertionError(f"the crash left {left}")
    if diff:
        raise AssertionError(f"the resumed reference differs in {diff}")
    if os.path.exists(ckdir):
        raise AssertionError("the checkpoint directory is still there")
    if not resumed["knn_bucket"] < full_launches["knn_bucket"]:
        raise AssertionError(f"K1 launched {resumed} resumed, {full_launches} in full")


def _load_samples(paths):
    from wisecondorx_tpu_torch.io.npz import load_sample_npz

    return [load_sample_npz(p)[:2] for p in paths]


def phase_multidevice(ml, corrected, ref, plate, device):
    """The A pass's KNN search and predict_batch on the plate with the
    device listed twice, each part on its own host thread: equal bit for
    bit to one device."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.models.predictor import PredictConfig
    from wisecondorx_tpu_torch.parallel.batch import predict_batch
    from wisecondorx_tpu_torch.parallel.sharded_knn import knn_search_multidevice

    args = (corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
            ml.masked_bins_per_chr, REFSIZE)

    def search(devices):
        return tuple(t.cpu().numpy()
                     for t in knn_search_multidevice(*args, devices=devices))

    one, _, one_s = launches_of("one-device search", lambda: search([device]))
    two, counts, two_s = launches_of("two-device search",
                                     lambda: search([device, device]))
    knn_equal = all(np.array_equal(a, b) for a, b in zip(one, two))
    paths = [p for p, ev in plate if ev != "unreadable"]
    cfg = PredictConfig()
    runs = {}
    for n_dev in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[n_dev] = predict_batch(_load_samples(paths), ref, cfg,
                                    [device] * n_dev)
        runs[n_dev] = (runs[n_dev], time.perf_counter() - t0)
    fields = ("results_r", "results_z", "results_w", "results_nr")
    batch_diff = [
        os.path.basename(p) for p, a, b in zip(paths, runs[1][0], runs[2][0])
        if (a.ref_gender, a.gender) != (b.ref_gender, b.gender)
        or not all(np.array_equal(x, y, equal_nan=True)
                   for f in fields for x, y in zip(getattr(a, f), getattr(b, f)))
    ]
    emit("multidevice", devices=[str(device)] * 2, knn_equal=knn_equal,
         knn_launches=counts, knn_one_s=round(one_s, 4), knn_two_s=round(two_s, 4),
         batch_samples=len(paths), batch_differing=batch_diff,
         batch_one_s=round(runs[1][1], 3), batch_two_s=round(runs[2][1], 3))
    if not knn_equal:
        raise AssertionError("the two-device search differs from one device")
    if batch_diff:
        raise AssertionError(f"two-device predict_batch differs on {batch_diff}")


WORKER = r"""
import json, os, sys
from wisecondorx_tpu_torch import cli
from wisecondorx_tpu_torch.ops import knn_cuda

knn_cuda.reset_launch_counts()
code = 0
try:
    cli.main(sys.argv[1:])
except SystemExit as e:
    code = e.code
print("WORKER " + json.dumps({"rank": int(os.environ["RANK"]), "exit_code": code,
                              "launches": dict(knn_cuda.LAUNCHES)}), flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(tag, argv):
    """The CLI with ``argv`` in two processes of one gloo group on
    127.0.0.1 (torchrun's environment), both on the one card.  Each has
    WORKER_TIMEOUT seconds; its output goes to a log file.  Returns
    ([per-rank report], seconds)."""
    script = os.path.join(WORK, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        logs.append(os.path.join(WORK, f"{tag}_rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, script, *argv],
                                          env=env, stdout=log,
                                          stderr=subprocess.STDOUT, cwd=REPO))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, WORKER_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    reports = []
    for rank, (p, path) in enumerate(zip(procs, logs)):
        text = open(path).read()
        lines = [ln for ln in text.splitlines() if ln.startswith("WORKER ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"{tag} rank {rank} exited {p.returncode}:\n"
                                 + text[-3000:])
        reports.append(json.loads(lines[-1][len("WORKER "):]))
    return reports, seconds


def phase_multiproc(files, ref, plate):
    """newref and predict-batch as two worker processes on the one card.
    newref: process 0's reference equals the newref phase's in every
    member, and each process launched both kernels.  predict-batch on the
    plate: each process scores its shard (exit 3 where the corrupt file
    fell), and together they write every sample's outputs byte-equal to
    the predict_batch phase's."""
    from wisecondorx_tpu_torch.parallel.multihost import shard_files

    out = os.path.join(WORK, "reference_2proc.npz")
    newref, newref_s = run_workers("newref", [
        "newref", *files, out, "--binsize", str(BINSIZE), "--refsize",
        str(REFSIZE), "--device", CLI_DEVICE])
    diff = _npz_differences(out, ref)
    outdir = os.path.join(WORK, "plate_out_2proc")
    paths = [p for p, _ in plate]
    batch, batch_s = run_workers("predict_batch", [
        "predict-batch", ref, outdir, "--bed", "--device", CLI_DEVICE,
        "--infiles", *paths])
    want_codes = [3 if any(ev == "unreadable" for p, ev in plate
                           if p in shard_files(paths, r, 2)) else 0
                  for r in range(2)]
    differing = []
    for path, ev in plate:
        if ev == "unreadable":
            continue
        base = os.path.basename(path)[:-4]
        for suffix in ("_bins.bed", "_segments.bed", "_aberrations.bed",
                       "_statistics.txt"):
            got = os.path.join(outdir, base + suffix)
            want = os.path.join(WORK, "plate_out", base + suffix)
            if not os.path.exists(got) or open(got, "rb").read() != open(want, "rb").read():
                differing.append(base + suffix)
    emit("multiproc", newref_seconds=round(newref_s, 3),
         newref_ranks=newref, newref_members_differing=diff,
         equal_to_newref=not diff,
         batch_seconds=round(batch_s, 3), batch_ranks=batch,
         batch_exit_codes_wanted=want_codes, batch_files_differing=differing)
    for rep in newref:
        if rep["exit_code"] not in (0, None):
            raise AssertionError(f"newref rank {rep['rank']} exited {rep['exit_code']}")
        if min(rep["launches"].values()) < 1:
            raise AssertionError(f"newref rank {rep['rank']} launches {rep['launches']}")
    if diff:
        raise AssertionError(f"the two-process reference differs in {diff}")
    if [rep["exit_code"] or 0 for rep in batch] != want_codes:
        raise AssertionError(f"predict-batch exit codes {batch}, want {want_codes}")
    if differing:
        raise AssertionError(f"two-process predict-batch differs in {differing}")


def phase_wide(ml_main, device):
    """newref through the CLI on 720 controls (360 F + 360 M) at 50 kb,
    genome_scale 0.25, so the A pass's s_pad (736) is above K1's resident
    cap; its stored neighbours against the exact float64 search; then K1
    against its plain version at the main A pass's row-chunk shape with
    1,000 and 4,096 samples, each timed beside its bound."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.ops import _build, knn_cuda

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import CohortSim

    wide_dir = os.path.join(WORK, "wide")
    os.makedirs(wide_dir)
    t0 = time.perf_counter()
    sim = CohortSim(binsize=BINSIZE, genome_scale=WIDE_GENOME_SCALE, seed=SEED + 1)
    samples, _ = sim.cohort(WIDE_FEMALE, WIDE_MALE)
    files = []
    for i, sample in enumerate(samples):
        files.append(os.path.join(wide_dir, f"control_{i:03d}.npz"))
        save_sample(files[-1], sample)
    cohort_s = time.perf_counter() - t0
    ref = os.path.join(wide_dir, "reference.npz")
    _, launches, newref_s = launches_of("wide newref", lambda: cli.main([
        "newref", *files, ref, "--binsize", str(BINSIZE), "--refsize",
        str(REFSIZE), "--device", CLI_DEVICE]))
    ref_a, ml, corrected, _ = a_pass(samples, ref, device)
    resident = _build.load().wcx_knn_bucket_resident_s_pad()
    s_pad = -(-corrected.shape[1] // knn_cuda.S_MULTIPLE) * knn_cuda.S_MULTIPLE
    search = _stored_vs_exact(ref_a, ml, corrected, device)
    del corrected
    k1 = []
    for s in WIDE_K1_SAMPLES:
        torch.cuda.empty_cache()
        args, share = _k1_inputs(ml_main, s, device)
        got, want, err = _k1_check(args)
        del want
        bound = _k1_bound(args, got, s)
        k1.append(dict(
            samples=s, s_pad=args[0].shape[1], rows=args[0].shape[0],
            candidates=args[8], sentinel_share=share, max_abs_err=err,
            ms=cuda_ms(lambda: knn_cuda.bucket_scan(*args)),
            plain_ms=cuda_ms(lambda: knn_cuda.bucket_scan_reference(
                *args, lanes=knn_cuda.LANES, depth=knn_cuda.DEPTH), reps=1),
            bound_ms=bound[0], bound_by=bound[1]))
        del got, args
    emit("wide", controls=len(files), cohort_seconds=round(cohort_s, 3),
         newref_seconds=round(newref_s, 3), newref_launches=launches,
         s_pad=s_pad, resident_s_pad=resident, **search, k1=k1)
    if not s_pad > resident:
        raise AssertionError(f"s_pad {s_pad} does not reach past {resident}")
    return k1


def _warm_correlations(events, warm_tids):
    """Correlation ids of the device work launched from a warm-up thread:
    one of ``warm_tids`` (the warm-up's native thread ids) or a thread
    that holds a ``warmup`` range.  A trace taken on the main thread
    records other threads' launches (and so their kernels) but not their
    ranges, so the ids are what tells the warm-up's kernels apart."""
    tids = set(warm_tids) | {e.get("tid") for e in events
                             if e.get("cat") == "user_annotation"
                             and e.get("name") == "warmup"}
    return {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and e.get("tid") in tids} - {None}


def trace_summary(paths, stage, top=5, gaps=3, counts=None, warm_tids=()):
    """One stage's device activity over its ``torch.profiler`` Chrome
    traces ``paths`` (one per run of the stage).  In each, the window is
    the stage's own ``record_function`` range; device time is the union
    of the device events' intervals (DEVICE_CATS) clipped to it, so work
    on two streams at once counts once; an idle gap is a stretch of the
    window with no device event, labelled by the innermost host range
    (HOST_CATS, any thread, the stage's own range left out) covering its
    midpoint, or "no host range".  Device work the warm-up launched
    (:func:`_warm_correlations`) is left out and summed apart.  Returns
    (summary over all runs: window and device ms, busy share, kernel
    events, the ``top`` device operations by time with their counts, the
    ``gaps`` longest idle gaps, the warm-up's device ms; {operation name:
    device ms}); ``counts``, where given, receives {operation name:
    events}."""
    window_us = busy_us = warm_us = 0.0
    kernels = 0
    ops, idle = {}, []
    for path in paths:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        own = [e for e in events
               if e.get("cat") == "user_annotation" and e.get("name") == stage]
        if not own:
            raise AssertionError(f"{path}: no {stage} range")
        window = max(own, key=lambda e: e["dur"])
        w0, w1 = window["ts"], window["ts"] + window["dur"]
        warm = _warm_correlations(events, warm_tids)
        spans = []
        for e in events:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if e.get("cat") not in DEVICE_CATS or b <= a:
                continue
            if e.get("args", {}).get("correlation") in warm:
                warm_us += b - a
                continue
            spans.append((a, b))
            kernels += e["cat"] == "kernel"
            t, n = ops.get(e["name"], (0.0, 0))
            ops[e["name"]] = (t + b - a, n + 1)
        cursor, gaps_here = w0, []
        for a, b in sorted(spans):
            if a > cursor:
                gaps_here.append((cursor, a))
            if b > cursor:
                busy_us += b - max(a, cursor)
                cursor = b
        if cursor < w1:
            gaps_here.append((cursor, w1))
        hosts = [e for e in events if e.get("cat") in HOST_CATS and e is not window]
        for a, b in sorted(gaps_here, key=lambda g: g[0] - g[1])[:gaps]:
            mid = (a + b) / 2
            covering = [e for e in hosts if e["ts"] <= mid <= e["ts"] + e["dur"]]
            label = (min(covering, key=lambda e: e["dur"])["name"] if covering
                     else "no host range")
            idle.append((b - a, label))
        window_us += window["dur"]
    if counts is not None:
        counts.update({name: n for name, (_, n) in ops.items()})
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])
    summary = {
        "runs": len(paths), "window_ms": window_us / 1e3,
        "device_ms": busy_us / 1e3,
        "busy_share": busy_us / window_us if window_us else 0.0,
        "kernel_events": kernels,
        "top_ops": [[name[:120], t / 1e3, n] for name, (t, n) in ranked[:top]],
        "idle_gaps": [[g / 1e3, label] for g, label in sorted(idle, reverse=True)[:gaps]],
        "warmup_device_ms": warm_us / 1e3,
    }
    return summary, {name: t / 1e3 for name, (t, _) in ops.items()}


def _trace_files(run_dir):
    """{stage directory name: sorted trace files} under ``run_dir``."""
    out = {}
    for stage in sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else ():
        files = sorted(os.path.join(run_dir, stage, f)
                       for f in os.listdir(os.path.join(run_dir, stage))
                       if f.endswith(".pt.trace.json"))
        if files:
            out[stage] = files
    return out


def traced_call(run_dir, shape, label, argv, want_code=0):
    """The port's CLI with ``argv``, with WCX_PROFILE_DIR set to
    ``run_dir`` for this call only.  Prints one ``trace_stage`` line per
    stage name it traced and one ``trace_call`` line (wall, busy share over
    its traced stages, the stages it timed without a trace).  Returns
    ({stage: (summary, {op: device ms}, {op: events})}, wall seconds);
    raises unless it exited with ``want_code``."""
    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.device import warm_thread_ids
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    before = {f for fs in _trace_files(run_dir).values() for f in fs}
    reset_stage_times()
    os.environ["WCX_PROFILE_DIR"] = run_dir
    t0 = time.perf_counter()
    try:
        cli.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        del os.environ["WCX_PROFILE_DIR"]
    wall = time.perf_counter() - t0
    timed = stage_times()
    if code != want_code:
        raise AssertionError(f"traced {label} exited {code}, want {want_code}")
    stages = {}
    for stage, files in _trace_files(run_dir).items():
        new = [f for f in files if f not in before]
        if new:
            counts = {}
            stages[stage] = (*trace_summary(new, stage, counts=counts,
                                            warm_tids=warm_thread_ids()),
                             counts)
            emit("trace_stage", shape=shape, call=label, stage=stage,
                 stage_s=timed.get(stage), **stages[stage][0])
    window = sum(s[0]["window_ms"] for s in stages.values())
    device = sum(s[0]["device_ms"] for s in stages.values())
    emit("trace_call", shape=shape, call=label, wall_s=wall,
         traced_stages=len(stages), traced_window_ms=window, device_ms=device,
         busy_share=device / window if window else 0.0,
         untraced=sorted(set(timed) - set(stages)))
    return stages, wall


def _kernel_ms(stages, name):
    """Summed device ms of the kernels whose name holds ``name``."""
    return sum(ms for _, ops, _ in stages.values() for op, ms in ops.items()
               if name in op)


def _kernel_events(stages, name):
    """Events of the kernels whose name holds ``name``."""
    return sum(n for _, _, counts in stages.values()
               for op, n in counts.items() if name in op)


def _bench_chunk(ml, corrected, device):
    """K1 and K2 at the first row chunk of an A pass of real data
    (``corrected``, prepared as the search prepares it): each kernel's
    time beside its plain version's, its bound and its library yardstick
    (``torch.mm`` of K1's product in full fp32, since no single call
    computes its distances and bucketed top-M; ``torch.topk`` of K1's
    pool for K2), and each kernel's largest difference from its plain
    version on these inputs: for K1, between the k smallest distances of
    its pool and of the plain version's (its products round differently
    from a float32 product); for K2, on K1's pool (exact).  Returns
    {kernel: measures}."""
    import torch

    from wisecondorx_tpu_torch.ops import knn, knn_cuda

    n, s = corrected.shape
    lanes, depth = knn_cuda.LANES, knn_cuda.DEPTH
    cand, cnorm, scale = knn_cuda.prepare_candidates(corrected, lanes)
    cchr = torch.full((cand.shape[0],), -2, dtype=torch.int32, device=device)
    cchr[:n] = torch.as_tensor(ml.chr_of_masked_bin, device=device)
    starts = torch.as_tensor(ml.masked_chr_starts, dtype=torch.int32, device=device)
    sizes = torch.as_tensor(ml.masked_bins_per_chr, dtype=torch.int32, device=device)
    r = min(knn_cuda.ROW_CHUNK, n)
    rchr = cchr[:r]
    args = (cand[:r], cnorm[:r], rchr, starts[rchr.long()].contiguous(),
            sizes[rchr.long()].contiguous(), cand, cnorm, cchr, n,
            min(knn.SENTINEL_DISTANCE * scale * scale, 1e30))
    pool = knn_cuda.bucket_scan(*args)
    plain_pool = knn_cuda.bucket_scan_reference(*args, lanes=lanes, depth=depth)
    top = knn_cuda.extract_topk(*pool, REFSIZE)
    plain_top = knn_cuda.extract_topk_reference(*pool, REFSIZE)
    k1_err = _max_abs(top[0], knn_cuda.extract_topk_reference(*plain_pool, REFSIZE)[0])
    torch.cuda.synchronize()
    del plain_pool
    if not (torch.equal(top[0], plain_top[0]) and torch.equal(top[2], plain_top[2])):
        raise AssertionError("K2 differs from extract_topk_reference on the bench pool")
    k2_err = _max_abs(top[0], plain_top[0])
    del plain_top
    k1_bound = _k1_bound(args, pool, s)
    k2_bound = _bound(0, _nbytes(pool[0], pool[2], top[1], *top))
    k1 = dict(rows=r, candidates=n, samples=s, max_abs_err=k1_err,
              ms=cuda_ms(lambda: knn_cuda.bucket_scan(*args)),
              plain_ms=cuda_ms(lambda: knn_cuda.bucket_scan_reference(
                  *args, lanes=lanes, depth=depth), reps=1),
              bound_ms=k1_bound[0], bound_by=k1_bound[1],
              product_ms=cuda_ms(lambda: torch.mm(cand[:r], cand.T)))
    k2 = dict(rows=r, pool=pool[0].shape[1], max_abs_err=k2_err,
              ms=cuda_ms(lambda: knn_cuda.extract_topk(*pool, REFSIZE)),
              plain_ms=cuda_ms(lambda: knn_cuda.extract_topk_reference(
                  *pool, REFSIZE), reps=1),
              bound_ms=k2_bound[0], bound_by=k2_bound[1],
              library_ms=cuda_ms(lambda: torch.topk(pool[0], REFSIZE, dim=1,
                                                    largest=False)))
    return {"knn_bucket": k1, "knn_topk": k2}


def _k1_run_bound(ref_path, genders):
    """K1's bound over a whole newref (ms): the 3xTF32 products of every
    searched row of each pass (all rows of the A pass, the chrX/chrY rows
    of F and M) with all of that pass's candidates, over its samples, at
    the TF32 peak."""
    import numpy as np

    ref = np.load(ref_path)
    ops = 0
    for gender, suffix in (("A", ""), ("F", ".F"), ("M", ".M")):
        key = f"masked_bins_per_chr{suffix}"
        if key not in ref.files:
            continue
        per_chr = ref[key]
        n = int(per_chr.sum())
        rows = n - (0 if gender == "A" else int(per_chr[:22].sum()))
        samples = len(genders) if gender == "A" else genders.count(gender)
        ops += 3 * 2 * rows * n * samples
    return ops / H100_TF32_FLOPS * 1e3


def bench_predict(ref, case, outid, samples):
    """One untraced ``predict --bed`` of the bench-shape trisomy-21
    sample through the CLI: its wall, exit code, reference-load stages and
    peak device memory, then its tables built again on the card beside
    the plain translation's host seconds (:func:`tables_vs_plain`).  It
    must call chr21's gain and nothing else whole-chromosome, unless the
    reference cannot serve a predict: a gonosomal pass whose PCA-distance
    filter dropped autosomal bins after the autosomal pass was saved
    (the reference tool's shared-mask quirk) holds fewer autosome rows
    than the autosomal pass, and predict then refuses it with exit code 1,
    as the JAX package does.  That case is accepted only where the
    reference shows it (:func:`gonosomal_misalignment`, with ``samples``
    the cohort the reference was built from) and is reported."""
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    reset_stage_times()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        cli.main(["predict", case, ref, outid, "--bed", "--device", CLI_DEVICE])
        code = 0
    except SystemExit as e:
        code = e.code
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stages = stage_times()
    device = torch.device(CLI_DEVICE)
    record = dict(seconds=wall, exit_code=code, peak_memory_bytes=peak,
                  tables=tables_vs_plain(ref, "F", device),
                  load_stages={k: v for k, v in stages.items()
                               if k.startswith("predict.load.")},
                  stages={k: round(v, 3) for k, v in stages.items()})
    misaligned = gonosomal_misalignment(ref, samples, device, BENCH_BINSIZE)
    if code == 0:
        gender, rows, whole = read_calls(outid, ref, BENCH_BINSIZE)
        record.update(gender=gender, whole_chromosome=whole,
                      aberrations=[f"{r[0]}:{r[1]}-{r[2]}:{r[-1]}" for r in rows])
    record["misaligned_passes"] = misaligned
    emit("bench_predict", **record)
    if code == 0 and set(record["whole_chromosome"]) != {"21:gain"}:
        raise AssertionError(f"bench predict: whole-chromosome calls "
                             f"{record['whole_chromosome']}, want exactly 21:gain")
    if code != 0 and (code != 1 or "F" not in misaligned):
        raise AssertionError(f"bench predict exited {code} on a reference "
                             "whose F pass is aligned with the A pass")


def gonosomal_misalignment(ref, samples, device, binsize):
    """The gonosomal passes of ``ref`` whose autosome rows differ from the
    autosomal pass's.  For each: its first target row beside the A pass's
    row count, the autosomal bins the A pass keeps and it lacks, and those
    its own PCA-distance filter dropped (the passes are built A, F, M on
    one shared mask, so M also lacks what F dropped).  Where its own
    filter dropped autosomal bins, that filter runs again on the card
    from ``samples`` (the cohort the reference was built from), in
    float32, the build's type, and in float64: the cutoff, the bins
    dropped, and each dropped bin's distance over the cutoff.  The pass's
    mask before its filter is taken as its stored mask with those bins put
    back; ``premise_holds`` says whether the float32 run dropped exactly
    them again.  Returns {pass: record}, empty when every pass is
    aligned."""
    import numpy as np
    import torch

    from wisecondorx_tpu_torch.models.reference import (
        NewrefConfig,
        _normalize_and_pca,
        _pca_distance,
        cohort_matrix,
    )

    npz = np.load(ref)
    a_mask = npz["mask"]
    n_aut = int(npz["masked_bins_per_chr_cum"][21])
    out, prev, matrix = {}, a_mask, None
    cfg = NewrefConfig(binsize=binsize, refsize=REFSIZE)
    for g in ("F", "M"):
        if f"mask.{g}" not in npz.files:
            continue
        g_mask = npz[f"mask.{g}"]
        g_aut = g_mask[: len(a_mask)]
        missing = np.nonzero(a_mask & ~g_aut)[0]
        own = np.nonzero(prev & ~g_aut)[0]
        prev = g_aut
        ct = int(npz[f"masked_bins_per_chr_cum.{g}"][21])
        if ct == n_aut:
            continue
        rec = dict(first_target_row=ct, a_pass_rows=n_aut,
                   missing_autosomal_bins=missing[:20].tolist(),
                   n_missing=len(missing), dropped_by_own_filter=own[:20].tolist())
        if len(own):
            if matrix is None:
                matrix, _, genders = cohort_matrix(
                    [(s, binsize) for s in samples], cfg)[:3]
            before = g_mask.copy()
            before[own] = True
            rows = np.nonzero(before)[0]
            cols = np.nonzero(np.asarray(genders) == g)[0]
            rec["refilter"] = {}
            for name, dtype in (("float32", torch.float32),
                                ("float64", torch.float64)):
                sub = torch.as_tensor(matrix[: len(g_mask)][:, cols],
                                      dtype=dtype, device=device)
                dist = _pca_distance(_normalize_and_pca(sub, before, cfg)[0])
                dist = dist.cpu().numpy().astype(np.float64)
                del sub
                mad = np.median(np.abs(dist - np.median(dist)))
                cutoff = max(np.median(dist) + 10 * mad, 5.0)
                bad = rows[dist > cutoff]
                over = dict(zip(rows.tolist(), (dist / cutoff).tolist()))
                rec["refilter"][name] = dict(
                    cutoff=cutoff, n_dropped=len(bad), dropped=bad[:20].tolist(),
                    same_as_stored=set(bad.tolist()) == set(own.tolist()),
                    over_cutoff={int(b): over[int(b)] for b in own[:20]})
            rec["premise_holds"] = rec["refilter"]["float32"]["same_as_stored"]
        out[g] = rec
    return out


def phase_trace(files, ref, t21, plate, device):
    """Per-stage device traces (``WCX_PROFILE_DIR``) of the main cohort's
    newref, ``predict --bed --plot`` and ``predict-batch --bed``, and of
    newref at bench.py's headline shape, which first runs untraced; the
    stored A-pass neighbours of the first BENCH_CHECK_ROWS rows meet the
    bar of the kernels phase, and K1 and K2 are timed at that A pass's
    first row chunk.  Fails on a missing required trace, a required trace
    without a device kernel, a newref whose traced stages hold no K1 or
    K2 event, a traced reference that differs from the untraced one, a
    kernel a newref did not launch, or neighbours below the bar.  Returns
    {kernel: {"main": ..., "bench": ...}} for the kernels line."""
    import torch

    from wisecondorx_tpu_torch import cli
    from wisecondorx_tpu_torch.utils.log import reset_stage_times, stage_times

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import CohortSim

    root = os.path.join(WORK, "trace")
    shutil.rmtree(root, ignore_errors=True)
    main_dir, bench_dir = os.path.join(root, "main"), os.path.join(root, "bench")
    traces, problems, launches = {}, [], {}

    ref_t = os.path.join(root, "reference.npz")
    os.makedirs(root)
    (traces["main", "newref"], newref_s), launches["main"], _ = launches_of(
        "traced main newref", lambda: traced_call(
            main_dir, "main", "newref",
            ["newref", *files, ref_t, "--binsize", str(BINSIZE), "--refsize",
             str(REFSIZE), "--device", CLI_DEVICE]))
    diff = _npz_differences(ref_t, ref)
    if diff:
        problems.append(f"the traced newref's reference differs in {diff}")
    traces["main", "predict"], predict_s = traced_call(
        main_dir, "main", "predict",
        ["predict", t21, ref, os.path.join(root, "case_t21"), "--bed", "--plot",
         "--device", CLI_DEVICE])
    traces["main", "predict_batch"], batch_s = traced_call(
        main_dir, "main", "predict_batch",
        ["predict-batch", ref, os.path.join(root, "plate_out"), "--bed",
         "--device", CLI_DEVICE, "--infiles", *(p for p, _ in plate)], want_code=3)
    for call in ("predict", "predict_batch"):
        if "predict.cbs" not in traces["main", call]:
            problems.append(f"no predict.cbs trace from {call}")
            continue
        cbs_stage = {"predict.cbs": traces["main", call]["predict.cbs"]}
        for name in CBS_TRACE_KERNELS:
            if not _kernel_events(cbs_stage, name):
                problems.append(f"no {name} event in {call}'s predict.cbs trace")

    torch.cuda.empty_cache()
    bench_root = os.path.join(root, "bench_cohort")
    os.makedirs(bench_root)
    t0 = time.perf_counter()
    sim = CohortSim(binsize=BENCH_BINSIZE, genome_scale=BENCH_GENOME_SCALE,
                    seed=BENCH_SEED)
    samples, _ = sim.cohort(BENCH_FEMALE, BENCH_MALE)
    bench_files = []
    for i, sample in enumerate(samples):
        bench_files.append(os.path.join(bench_root, f"control_{i:03d}.npz"))
        save_sample(bench_files[-1], sample, BENCH_BINSIZE)
    cohort_s = time.perf_counter() - t0

    def bench_argv(out):
        return ["newref", *bench_files, out, "--binsize", str(BENCH_BINSIZE),
                "--refsize", str(REFSIZE), "--device", CLI_DEVICE]

    ref_u = os.path.join(bench_root, "reference_untraced.npz")
    reset_stage_times()
    torch.cuda.reset_peak_memory_stats()
    _, untraced_launches, untraced_s = launches_of(
        "untraced bench newref", lambda: cli.main(bench_argv(ref_u)))
    emit("bench_newref", seconds=untraced_s, launches=untraced_launches,
         npz_bytes=os.path.getsize(ref_u),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         stages={k: round(v, 3) for k, v in stage_times().items()})
    bench_t21 = os.path.join(bench_root, "case_t21.npz")
    save_sample(bench_t21, sim.sample("F", cnvs=[_trisomy(sim, 21)]), BENCH_BINSIZE)
    bench_predict(ref_u, bench_t21, os.path.join(bench_root, "case_t21"), samples)
    ref_b = os.path.join(bench_root, "reference.npz")
    (traces["bench", "newref"], bench_newref_s), launches["bench"], _ = launches_of(
        "traced bench newref",
        lambda: traced_call(bench_dir, "bench", "newref", bench_argv(ref_b)))
    bench_diff = _npz_differences(ref_b, ref_u)
    if bench_diff:
        problems.append(f"the traced bench reference differs in {bench_diff}")
    ref_a, ml, corrected, genders = a_pass(samples, ref_b, device, BENCH_BINSIZE)
    del samples
    search = _stored_vs_exact(ref_a, ml, corrected, device,
                              (0, min(BENCH_CHECK_ROWS, ml.n_masked)))
    chunk = _bench_chunk(ml, corrected, device)
    del corrected
    torch.cuda.empty_cache()
    k1_run_bound = _k1_run_bound(ref_b, genders)
    bench = traces["bench", "newref"]
    kernels = {}
    for key, name in NEWREF_TRACE_KERNELS.items():
        kernels[key] = {}
        for shape in ("main", "bench"):
            traced = _kernel_events(traces[shape, "newref"], name)
            if not traced:
                problems.append(f"{shape}: no {name} event in newref's traced stages")
            kernels[key][shape] = {"launches": launches[shape][key],
                                   "traced_launches": traced}
        kernels[key]["bench"].update(device_ms=_kernel_ms(bench, name),
                                     chunk=chunk[key])
    kernels["knn_bucket"]["bench"].update(
        run_bound_ms=k1_run_bound,
        launches_x_chunk_bound_ms=(launches["bench"]["knn_bucket"]
                                   * chunk["knn_bucket"]["bound_ms"]))
    k1_ms = kernels["knn_bucket"]["bench"]["device_ms"]
    k2_ms = kernels["knn_topk"]["bench"]["device_ms"]
    device_ms = sum(s[0]["device_ms"] for s in bench.values())
    emit("trace", main_walls_s={"newref": newref_s, "predict_plot": predict_s,
                                "predict_batch": batch_s},
         main_reference_differs=diff, bench_cohort_s=cohort_s,
         bench_bins=int(sim.bins.sum()), bench_masked_rows=ml.n_masked,
         bench_controls=len(bench_files), bench_genome_scale=BENCH_GENOME_SCALE,
         bench_newref_untraced_s=untraced_s, bench_newref_s=bench_newref_s,
         bench_reference_differs=bench_diff, bench_launches=launches["bench"],
         bench_k1_device_ms=k1_ms, bench_k2_device_ms=k2_ms,
         bench_device_ms=device_ms,
         bench_knn_share_of_wall=(k1_ms + k2_ms) / 1e3 / bench_newref_s,
         bench_search=search, kernels=kernels)
    for shape, stage in REQUIRED_TRACES:
        found = [s for (sh, _), stages in traces.items() if sh == shape
                 for name, (s, _, _) in stages.items() if name == stage]
        if not found:
            problems.append(f"{shape}: no {stage} trace")
        elif not all(s["kernel_events"] for s in found):
            problems.append(f"{shape}: a {stage} trace holds no device kernel")
    if problems:
        raise AssertionError("; ".join(problems))
    return kernels


def main():
    device = phase_device()
    import torch

    from wisecondorx_tpu_torch.ops import cbs, knn_cuda

    ptxas = phase_build()
    samples, files, t21, euploid, plate = make_cohort()

    knn_cuda.reset_launch_counts()
    cbs.reset_round_counts()
    cbs.reset_launch_counts()
    ref, newref_record = phase_newref(files)
    predict_record = phase_predict(ref, t21, "case_t21", want_gain_chr="21",
                                   check_dispatch=True)
    phase_predict(ref, euploid, "case_euploid", want_gain_chr=None)
    launches = dict(knn_cuda.LAUNCHES)
    rounds = dict(cbs.ROUNDS)
    cbs_launches = dict(cbs.LAUNCHES)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    emit("cbs_rounds", **rounds, launches=cbs_launches)
    if rounds["device"] < 1 or rounds["host"]:
        raise AssertionError(f"predict CBS rounds {rounds}: not the device stream")
    # Both samples' segments stay whole at alpha 1e-4, so only the plate
    # (predict-batch, below) locates a split.
    for name in ("cbs_arc_max", "cbs_keys"):
        if cbs_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by predict")
    warm = {call: {k: v for k, v in record["stages"].items()
                   if k.startswith("warmup.")}
            for call, record in (("newref", newref_record),
                                 ("predict", predict_record))}
    emit("warmup", stages=warm)
    phase_z_sums()
    missing = ({"warmup.wait.newref"} - set(warm["newref"])) | (
        {"warmup.wait.predict"} - set(warm["predict"]))
    if missing:
        raise AssertionError(f"warm-up stages missing: {sorted(missing)}")
    phase_cold(files, t21, ref, {"newref": newref_record, "predict": predict_record})

    batch_launches = phase_predict_batch(ref, plate, os.path.join(WORK, "case_t21"),
                                         device)
    cbs_records = phase_cbs_stream(ref, t21, device)
    phase_plots(ref, t21, plate, files, device)
    torch.cuda.empty_cache()
    ref_a, ml, corrected, _ = a_pass(samples, ref, device)
    result, k1_err, k2_err = phase_kernels(ref_a, ml, corrected, device)
    phase_checkpoint(files, ref, launches)
    phase_multidevice(ml, corrected, ref, plate, torch.device("cuda", 0))
    del corrected
    torch.cuda.empty_cache()
    phase_multiproc(files, ref, plate)
    wide_k1 = phase_wide(ml, device)
    bench = phase_trace(files, ref, t21, plate, device)

    kernels = [
        {"name": "knn_bucket", "route": "cuda",
         "source": "wisecondorx_tpu_torch/csrc/knn_bucket.cu",
         "replaces": "wisecondorx_tpu/ops/knn_pallas.py:54",
         "launches": launches["knn_bucket"], "max_abs_err": k1_err,
         "ms": result["k1_ms"], "plain_ms": result["k1_plain_ms"],
         "bound_ms": result["k1_bound_ms"], "bound_by": result["k1_bound_by"],
         "library_ms": None, "product_ms": result["k1_product_ms"],
         "wide": [{k: w[k] for k in ("samples", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err")} for w in wide_k1],
         "main_shape_trace": bench["knn_bucket"]["main"],
         "bench_shape": bench["knn_bucket"]["bench"], "ptxas": ptxas.get("knn_bucket.cu")},
        {"name": "knn_topk", "route": "cuda",
         "source": "wisecondorx_tpu_torch/csrc/knn_topk.cu",
         "replaces": "wisecondorx_tpu/ops/knn_pallas.py:228",
         "launches": launches["knn_topk"], "max_abs_err": k2_err,
         "ms": result["k2_ms"], "plain_ms": result["k2_plain_ms"],
         "bound_ms": result["k2_bound_ms"], "bound_by": result["k2_bound_by"],
         "library_ms": result["k2_topk_ms"],
         "main_shape_trace": bench["knn_topk"]["main"],
         "bench_shape": bench["knn_topk"]["bench"],
         "ptxas": ptxas.get("knn_topk.cu")},
    ]
    for name, source, replaces in (
            ("cbs_arc_max", "cbs_arcs.cu", "wisecondorx_tpu/ops/cbs.py:282"),
            ("cbs_arc_argmax", "cbs_arcs.cu", "wisecondorx_tpu/ops/cbs.py:309"),
            ("cbs_keys", "cbs_keys.cu", "wisecondorx_tpu/ops/cbs.py:377")):
        first = cbs_records[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wisecondorx_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": batch_launches[name], "main_path_launches": cbs_launches[name],
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "kernel_ms": first.get("kernel_ms"), "exact_share": first.get("exact_share"),
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "shapes": cbs_records[name], "ptxas": ptxas.get(source)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
