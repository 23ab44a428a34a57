"""Command-line interface of the PyTorch port: ``wisecondorx-tpu-torch``.

``convert``, ``newref``, ``predict --bed``, ``predict-batch --bed`` and
``gender`` take the JAX CLI's flags and read and write the same ``.npz``
schemas; the device stages add ``--device`` (``cuda``, the default: every
visible card, and a failure when there is none; ``cuda:N``; ``cpu``).
``convert`` runs the port's copy of the native BAM/CRAM reader and touches
no device.  ``newref`` and ``predict-batch`` run as several processes when
started the way ``torchrun`` starts them (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): newref splits its KNN rows over the
processes and process 0 writes the reference; predict-batch shards the
plate's files.  ``predict --plot`` and ``predict-batch --plot`` write the
JAX package's figures, and ``newref --plotyfrac`` its chrY-fraction figure,
as PNGs rasterized on the run's device (``output/plots.py``).

``newref``, ``predict`` and ``predict-batch`` each run inside one root
stage, ``cli.newref``, ``cli.predict`` or ``cli.predict_batch``: the
request of every span the call keeps (``utils/log.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wisecondorx_tpu_torch.io.npz import load_sample_npz
from wisecondorx_tpu_torch.utils.log import setup_logging, stage_timer


def tool_convert(args):
    from wisecondorx_tpu_torch.io.bam import convert_reads
    from wisecondorx_tpu_torch.io.npz import save_sample_npz

    logging.info("Starting conversion")
    sample, qual_info = convert_reads(
        args.infile, binsize=args.binsize, reference_fasta=args.reference,
        normdup=args.normdup,
    )
    save_sample_npz(args.outfile, args.binsize, sample, qual_info)
    logging.info("Finished conversion")


def tool_newref(args):
    from wisecondorx_tpu_torch.device import resolve_devices
    from wisecondorx_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed,
    )
    from wisecondorx_tpu_torch.utils import warmup

    with stage_timer("cli.newref", trace=False):
        rank, world = maybe_initialize_distributed()
        devices = resolve_devices(args.device)
        # Device start-up overlaps the input parsing; the build joins it
        # before its first device use (the --plotyfrac figure needs no
        # warm-up).
        warm = (warmup.start_warmup(devices) if args.plotyfrac is None
                else warmup.Warmup([], "newref"))
        try:
            _newref(args, rank, world, devices, warm)
        finally:
            warm.wait()


def _newref(args, rank, world, devices, warm):
    from wisecondorx_tpu_torch.io.npz import (
        _savez_fast,
        flatten_reference,
        verify_reference_npz,
    )
    from wisecondorx_tpu_torch.ref_qc import qc_reference_arrays
    from wisecondorx_tpu_torch.models.reference import (
        NewrefConfig,
        NewrefError,
        build_reference,
    )

    logging.info("Creating new reference on %s%s",
                 ", ".join(map(str, devices)),
                 f" (process {rank} of {world})" if world > 1 else "")
    with stage_timer("newref.load_inputs") as span:
        def load_one(infile):
            sample, binsize, _ = load_sample_npz(infile)
            return sample, binsize

        with ThreadPoolExecutor(max_workers=8) as pool:
            samples = list(pool.map(load_one, args.infiles))
        span.add("bytes", sum(os.path.getsize(f) for f in args.infiles))
    if args.plotyfrac is not None:
        # Plot the gender model's fit for --yfrac tuning, then stop.
        from wisecondorx_tpu_torch.io.npz import scale_sample
        from wisecondorx_tpu_torch.ops.gmm import train_gender_model
        from wisecondorx_tpu_torch.output.plots import write_yfrac_plot

        scaled = [scale_sample(s, bs, int(args.binsize)) for s, bs in samples]
        _, _, fit = train_gender_model(scaled, yfrac_override=args.yfrac,
                                       random_state=args.seed)
        if rank == 0:
            path = write_yfrac_plot(args.plotyfrac, fit, devices[0])
            logging.info("Image written to %s, now quitting ...", path)
        sys.exit(0)
    cfg = NewrefConfig(binsize=int(args.binsize), refsize=args.refsize,
                       nipt=args.nipt, yfrac=args.yfrac, seed=args.seed,
                       checkpoint_dir=args.checkpoint_dir)
    try:
        passes, meta = build_reference(samples, cfg, devices[0],
                                       devices=devices, warmup=warm)
    except NewrefError as e:
        logging.critical(str(e))
        sys.exit(1)
    if rank != 0:
        logging.info("Finished; process 0 writes the reference")
        return
    outfile = args.outfile if args.outfile.endswith(".npz") else args.outfile + ".npz"
    final = flatten_reference(passes, is_nipt=meta["is_nipt"],
                              trained_cutoff=meta["trained_cutoff"])
    with stage_timer("newref.write"):
        _savez_fast(outfile, final)
        logging.info("Reference written to %s", outfile)
    with stage_timer("newref.verify") as span:
        span.add("bytes", os.path.getsize(outfile))
        verify_reference_npz(outfile, expected_keys=final.keys())
    with stage_timer("newref.qc"):
        qc_reference_arrays(final, label=outfile)
    logging.info("Finished creating reference")


def output_gender(args):
    from wisecondorx_tpu_torch.ops.gmm import predict_gender

    sample, _, _ = load_sample_npz(args.infile)
    ref = np.load(args.reference, encoding="latin1", allow_pickle=True)
    gender = predict_gender(sample, float(ref["trained_cutoff"]))
    print("male" if gender == "M" else "female")


def _predict_config(args):
    """PredictConfig of the predict flags; exits on an invalid value."""
    from wisecondorx_tpu_torch.models.predictor import PredictConfig, PredictError

    if not args.bed and not args.plot:
        logging.critical(
            "No output format selected. "
            "Select at least one of the supported output formats "
            "(--bed, --plot)"
        )
        sys.exit(1)
    cfg = PredictConfig(
        minrefbins=args.minrefbins, maskrepeats=args.maskrepeats,
        alpha=args.alpha, zscore=args.zscore, beta=args.beta,
        blacklist=args.blacklist, gender=args.gender, seed=args.seed,
    )
    try:
        cfg.validate()
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)
    return cfg


def _write_plots(args, outid, bins, segments, cfg, device):
    from wisecondorx_tpu_torch.output.plots import write_plots

    write_plots(outid, bins, segments, cfg, ylim=args.ylim,
                regions=args.regions,
                plot_title=outid.split("/")[-1] if args.add_plot_title else None,
                device=device)


def tool_test(args):
    from wisecondorx_tpu_torch.device import resolve_device
    from wisecondorx_tpu_torch.utils import warmup

    with stage_timer("cli.predict", trace=False):
        cfg = _predict_config(args)
        device = resolve_device(args.device)
        # Device start-up overlaps the sample's load; the loader joins it
        # before its first upload.
        warm = warmup.start_predict_warmup(args.reference, device)
        try:
            _predict(args, cfg, device, warm)
        finally:
            warm.wait()


def _predict(args, cfg, device, warm):
    from wisecondorx_tpu_torch.output.tables import generate_output_tables
    from wisecondorx_tpu_torch.models.predictor import PredictError, predict
    from wisecondorx_tpu_torch.models.ref_loader import ReferenceLoader

    logging.info("Starting CNA prediction on %s", device)
    with stage_timer("predict.load_sample") as span:
        sample, sample_binsize, _ = load_sample_npz(args.infile)
        span.add("bytes", os.path.getsize(args.infile))
    with ReferenceLoader(args.reference, device, warmup=warm) as loader:
        try:
            bins, segments = predict(sample, sample_binsize, None, cfg,
                                     loader=loader)
        except PredictError as e:
            logging.critical(str(e))
            sys.exit(1)
    if args.bed:
        with stage_timer("predict.write"):
            generate_output_tables(args.outid, bins, segments, cfg,
                                   regions=args.regions)
    if args.plot:
        _write_plots(args, args.outid, bins, segments, cfg, device)
    logging.info("Finished prediction")


def tool_test_batch(args):
    """Score a plate of samples against one reference in one invocation.
    Unreadable samples and samples that fail preparation are logged and
    skipped, the others are written, and the exit code is then 3."""
    from wisecondorx_tpu_torch.device import resolve_devices
    from wisecondorx_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed,
    )
    from wisecondorx_tpu_torch.utils import warmup

    with stage_timer("cli.predict_batch", trace=False):
        cfg = _predict_config(args)
        rank, world = maybe_initialize_distributed()
        devices = resolve_devices(args.device)
        # As in predict, on every device.
        warm = warmup.start_predict_batch_warmup(args.reference, devices)
        try:
            _predict_batch(args, cfg, rank, world, devices, warm)
        finally:
            warm.wait()


def _predict_batch(args, cfg, rank, world, devices, warm):
    import pickle
    import zipfile

    from wisecondorx_tpu_torch.errors import UserInputError
    from wisecondorx_tpu_torch.output.tables import generate_output_tables
    from wisecondorx_tpu_torch.models.predictor import (
        PredictError,
        segment_bins_batch,
    )
    from wisecondorx_tpu_torch.parallel.batch import predict_batch
    from wisecondorx_tpu_torch.parallel.multihost import shard_files

    infiles = shard_files(args.infiles, rank, world)
    if world > 1:
        logging.info("Process %d of %d takes %d of %d samples", rank, world,
                     len(infiles), len(args.infiles))
    os.makedirs(args.outdir, exist_ok=True)
    loaded, outids, infiles_loaded, failed = [], [], [], []
    with stage_timer("predict_batch.load_samples"):
        for infile in infiles:
            try:
                sample, binsize, _ = load_sample_npz(infile)
            except (UserInputError, FileNotFoundError, KeyError,
                    zipfile.BadZipFile, pickle.UnpicklingError) as e:
                logging.error("Skipping unreadable sample %s: %s", infile, e)
                failed.append(infile)
                continue
            infiles_loaded.append(infile)
            loaded.append((sample, binsize))
            base = os.path.basename(infile)
            outids.append(os.path.join(
                args.outdir, base[:-4] if base.endswith(".npz") else base
            ))
    logging.info("Batch prediction: %d samples on %s", len(loaded),
                 ", ".join(map(str, devices)))
    try:
        all_bins = predict_batch(loaded, args.reference, cfg, devices,
                                 chunk=args.chunk, skip_errors=True,
                                 warmup=warm)
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)
    good = []
    for infile, outid, bins in zip(infiles_loaded, outids, all_bins):
        if bins is None:
            failed.append(infile)
        else:
            good.append((outid, bins))
    all_segments = segment_bins_batch([b for _, b in good], cfg, devices[0])
    for (outid, bins), segments in zip(good, all_segments):
        if args.bed:
            with stage_timer("predict_batch.write") as span:
                span.add("sample", outid)
                generate_output_tables(outid, bins, segments, cfg,
                                       regions=args.regions)
        if args.plot:
            _write_plots(args, outid, bins, segments, cfg, devices[0])
        logging.info("Wrote %s", outid)
    logging.info("Finished batch prediction")
    if failed:
        logging.error(
            "%d of %d samples%s failed and were skipped (see errors above): "
            "%s", len(failed), len(infiles),
            " in this process's shard" if world > 1 else "", ", ".join(failed),
        )
        sys.exit(3)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="WisecondorX-TPU, PyTorch port")
    parser.add_argument(
        "--loglevel", type=str, default="INFO",
        choices=["info", "warning", "debug", "error", "critical"],
    )
    sub = parser.add_subparsers()
    fmt = argparse.ArgumentDefaultsHelpFormatter

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (every visible card; fails when there is "
                       "none), cuda:N or cpu")

    p = sub.add_parser(
        "convert", formatter_class=fmt,
        description="Convert and filter aligned reads to .npz",
    )
    p.add_argument("infile", type=str, help="aligned reads input (.bam or .cram)")
    p.add_argument("outfile", type=str, help="Output .npz file")
    p.add_argument("-r", "--reference", type=str,
                   help="Fasta reference (accepted for compatibility; the "
                   "native CRAM reader needs none)")
    p.add_argument("--binsize", type=float, default=5e3, help="Bin size (bp)")
    p.add_argument("--normdup", action="store_true",
                   help="Do not remove duplicates")
    p.set_defaults(func=tool_convert)

    p = sub.add_parser(
        "newref", formatter_class=fmt,
        description="Create a new reference using healthy reference samples",
    )
    p.add_argument("infiles", type=str, nargs="+")
    p.add_argument("outfile", type=str)
    p.add_argument("--nipt", action="store_true")
    p.add_argument("--yfrac", type=float, default=None)
    p.add_argument("--plotyfrac", type=str, default=None)
    p.add_argument("--refsize", type=int, default=300)
    p.add_argument("--binsize", type=int, default=int(1e5))
    p.add_argument("--cpus", type=int, default=1,
                   help="Kept for CLI compatibility; ignored")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="Directory for crash-recovery artifacts; a killed "
                   "build re-run with the same inputs resumes after the last "
                   "completed stage (removed on success)")
    device_flag(p)
    p.set_defaults(func=tool_newref)

    p = sub.add_parser(
        "gender", formatter_class=fmt,
        description="Returns the gender of a .npz resulting from convert",
    )
    p.add_argument("infile", type=str)
    p.add_argument("reference", type=str)
    p.set_defaults(func=output_gender)

    def predict_flags(p):
        p.add_argument("--minrefbins", type=int, default=150)
        p.add_argument("--maskrepeats", type=int, default=5)
        p.add_argument("--alpha", type=float, default=1e-4)
        p.add_argument("--zscore", type=float, default=5)
        p.add_argument("--beta", type=float, default=None)
        p.add_argument("--blacklist", type=str, default=None)
        p.add_argument("--gender", type=str, choices=["F", "M"])
        p.add_argument("--ylim", type=str, default="def")
        p.add_argument("--bed", action="store_true")
        p.add_argument("--plot", action="store_true")
        p.add_argument("--cairo", action="store_true")
        p.add_argument("--add-plot-title", action="store_true")
        p.add_argument("--seed", type=int, default=None)
        p.add_argument("--regions", type=str, default=None)
        device_flag(p)

    p = sub.add_parser("predict", formatter_class=fmt,
                       description="Find copy number aberrations")
    p.add_argument("infile", type=str)
    p.add_argument("reference", type=str)
    p.add_argument("outid", type=str)
    predict_flags(p)
    p.set_defaults(func=tool_test)

    p = sub.add_parser(
        "predict-batch", formatter_class=fmt,
        description="Find copy number aberrations for a batch of samples "
        "in one invocation",
    )
    p.add_argument("reference", type=str)
    p.add_argument("outdir", type=str, help="Output directory; per-sample "
                   "outid = <outdir>/<input basename without .npz>")
    p.add_argument("--infiles", type=str, nargs="+", required=True)
    p.add_argument("--chunk", type=int, default=8,
                   help="Samples normalized together")
    predict_flags(p)
    p.set_defaults(func=tool_test_batch)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    setup_logging(args.loglevel)
    if not hasattr(args, "func"):
        parser.print_help()
        sys.exit(1)
    import pickle
    import zipfile

    from wisecondorx_tpu_torch.errors import UserInputError

    try:
        args.func(args)
    except UserInputError as e:
        logging.critical(str(e))
        sys.exit(1)
    except FileNotFoundError as e:
        logging.critical("Input file not found: %s", e.filename or e)
        sys.exit(1)
    except (zipfile.BadZipFile, pickle.UnpicklingError) as e:
        logging.critical("Not a valid .npz file: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
