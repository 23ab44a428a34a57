"""BED/statistics writers — byte-format parity with reference
predict_output.py.

Formats preserved exactly: header lines, 1-based starts (``bin*binsize+1``),
0 -> "nan" substitution in the bins table, gain/loss calling by segment z
against ``--zscore`` or by ratio against the beta cutoffs
``log2((ploidy +- beta/2)/ploidy)`` with ploidy 1 for male gonosomes.

Copy of wisecondorx_tpu/output/tables.py, but for ``_bins.bed``'s rows,
which a native formatter (``native/tablefmt.cpp``) writes one chromosome at
a time; the port imports nothing of that package, and
tests/test_torch_host.py holds the two to the same bytes on either route.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import subprocess
import threading

import numpy as np

from wisecondorx_tpu_torch.errors import BedParseError
from wisecondorx_tpu_torch.ops.stats import (
    get_cpa,
    get_median_segment_variance,
    get_z_score,
)
from wisecondorx_tpu_torch.utils.native import build_library

#: Rows of ``_bins.bed`` written since the last :func:`reset_bin_row_counts`,
#: by route: ``native`` (one ``native/tablefmt.cpp`` call a chromosome) or
#: ``python`` (:func:`_python_bin_rows`).
BIN_ROWS = {"native": 0, "python": 0}

#: The dtypes the native formatter prints, by their width in bits.
_NATIVE_BITS = {np.dtype(np.float32): 32, np.dtype(np.float64): 64}
_FORMATTER_LOCK = threading.Lock()
#: None until :func:`load_formatter` first runs, then the library or False.
_formatter = None


def reset_bin_row_counts() -> None:
    for key in BIN_ROWS:
        BIN_ROWS[key] = 0


def _chr_name(chr0: int) -> str:
    name = str(chr0 + 1)
    return {"23": "X", "24": "Y"}.get(name, name)


def generate_output_tables(outid, bins, segments, cfg, regions=None):
    """Write ``<outid>_bins.bed``, ``_segments.bed``, ``_aberrations.bed``,
    ``_statistics.txt`` and optionally ``_regions.bed``.

    ``bins`` is a :class:`wisecondorx_tpu_torch.models.predictor.BinResults`;
    ``segments`` the 5-column results_c rows; ``cfg`` a PredictConfig.
    """
    _generate_bins_bed(outid, bins)
    _generate_segments_and_aberrations_bed(outid, bins, segments, cfg)
    _generate_chr_statistics_file(outid, bins, segments)
    if regions is not None:
        _generate_regions_bed(outid, bins, regions)


def load_formatter():
    """The native row formatter (``native/tablefmt.cpp``), built with g++
    if needed and loaded once per process; None, after one warning, when
    it cannot be built or loaded (the rows then take the Python loop)."""
    global _formatter
    with _FORMATTER_LOCK:
        if _formatter is None:
            try:
                lib = ctypes.CDLL(
                    str(build_library("wcxtablefmt", ["tablefmt.cpp"]))
                )
            except (OSError, subprocess.CalledProcessError) as exc:
                logging.warning(
                    "The native _bins.bed formatter did not build or load "
                    "(%s); the rows are formatted in Python.", exc
                )
                _formatter = False
            else:
                lib.wcx_bins_row_max.restype = ctypes.c_int64
                lib.wcx_bins_row_max.argtypes = [ctypes.c_int64]
                lib.wcx_format_bins.restype = ctypes.c_int64
                lib.wcx_format_bins.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                    ctypes.c_double,
                ]
                _formatter = lib
        return _formatter or None


@functools.cache
def float32_positional_range() -> tuple[float, float]:
    """(low, high): numpy's ``str`` of a float32 scalar is positional iff
    low < |x| < high, and both print in exponent form.  numpy decides by
    comparing the value with powers of ten that its version sets (1e-4
    and 1e16 in numpy 2.0, 1e-4 and 1e6 in numpy 2.3); the bounds are
    found here by bisection over the float32 bit patterns on each side of
    1, so the native formatter follows the numpy installed."""

    def exponent_form(bits: int) -> bool:
        return "e" in str(np.array(bits, np.uint32).view(np.float32)[()])

    def first_exponent_form(inside: int, outside: int) -> float:
        # The pattern next to the positional ones, from inside (printed
        # positionally) towards outside (in exponent form).
        while abs(outside - inside) > 1:
            mid = (inside + outside) // 2
            if exponent_form(mid):
                outside = mid
            else:
                inside = mid
        return float(np.array(outside, np.uint32).view(np.float32)[()])

    one = int(np.array(1.0, np.float32).view(np.uint32))
    top = int(np.array(np.finfo(np.float32).max).view(np.uint32))
    # 1: the smallest subnormal.
    return first_exponent_form(one, 1), first_exponent_form(one, top)


def _generate_bins_bed(outid, bins):
    """reference predict_output.py:59-84.

    Each chromosome's rows come from one call of the native formatter when
    its ratios and z-scores are float32 (from a card) or float64 arrays and
    the formatter loads, else from :func:`_python_bin_rows`; both write
    the same bytes as the reference's per-row loop."""
    fmt = load_formatter()
    binsize = bins.binsize
    buf = np.empty(0, np.uint8)
    with open(f"{outid}_bins.bed", "wb") as f:
        f.write(b"chr\tstart\tend\tid\tratio\tzscore\n")
        for c in range(len(bins.results_r)):
            chr_name = _chr_name(c)
            r = np.asarray(bins.results_r[c])
            z = np.asarray(bins.results_z[c])
            n = min(len(r), len(z))
            bits = _NATIVE_BITS.get(r.dtype)
            if fmt is None or bits is None or z.dtype != r.dtype:
                f.write(_python_bin_rows(chr_name, r, z, binsize).encode())
                BIN_ROWS["python"] += n
                continue
            name = chr_name.encode()
            need = n * fmt.wcx_bins_row_max(len(name))
            if len(buf) < need:
                buf = np.empty(need, np.uint8)
            r = np.ascontiguousarray(r[:n])
            z = np.ascontiguousarray(z[:n])
            size = fmt.wcx_format_bins(r.ctypes.data, z.ctypes.data, bits, n,
                                       int(binsize), name, buf.ctypes.data,
                                       len(buf), *float32_positional_range())
            if size < 0:
                raise RuntimeError(
                    f"native formatter failed on chromosome {chr_name}"
                )
            f.write(memoryview(buf)[:size])
            BIN_ROWS["native"] += n


def _python_bin_rows(chr_name, r, z, binsize) -> str:
    """One chromosome's rows formatted bin by bin in Python: the plain
    version of ``native/tablefmt.cpp``.  ``repr`` of a Python float equals
    numpy's scalar ``str`` (both shortest round-trip)."""

    def cells(arr):
        # float64 values format fastest as Python floats (repr == the
        # old str(numpy scalar), shortest round-trip).  Other dtypes
        # (float32 from a device) keep their numpy scalars + str() so the
        # printed text stays the shortest representation OF THAT dtype —
        # .tolist() would widen f32 to double and print 17-digit
        # strings.
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            return arr.tolist(), repr
        return list(arr), str

    rs, rfmt = cells(r)
    zs, zfmt = cells(z)
    lines = []
    feat = 1
    for r, z in zip(rs, zs):
        e = feat + binsize - 1
        rstr = "nan" if r == 0 else rfmt(r)
        zstr = "nan" if z == 0 else zfmt(z)
        lines.append(
            f"{chr_name}\t{feat}\t{e}\t{chr_name}:{feat}-{e}\t"
            f"{rstr}\t{zstr}"
        )
        feat += binsize
    return "\n".join(lines) + "\n" if lines else ""


def _aberration_cutoffs(beta, ploidy):
    """reference predict_output.py:191-194."""
    return (
        np.log2((ploidy - beta / 2) / ploidy),
        np.log2((ploidy + beta / 2) / ploidy),
    )


def _generate_segments_and_aberrations_bed(outid, bins, segments, cfg):
    """reference predict_output.py:136-188."""
    seg_f = open(f"{outid}_segments.bed", "w")
    ab_f = open(f"{outid}_aberrations.bed", "w")
    seg_f.write("chr\tstart\tend\tratio\tzscore\n")
    ab_f.write("chr\tstart\tend\tratio\tzscore\ttype\n")

    for segment in segments:
        chr_name = _chr_name(segment[0])
        row = [
            chr_name,
            int(segment[1] * bins.binsize + 1),
            int(segment[2] * bins.binsize),
            segment[4],
            segment[3],
        ]
        seg_f.write("\t".join(str(x) for x in row) + "\n")

        ploidy = 2
        if chr_name in ("X", "Y") and bins.ref_gender == "M":
            ploidy = 1
        if cfg.beta is not None:
            loss_cut, gain_cut = _aberration_cutoffs(cfg.beta, ploidy)
            if float(segment[4]) > gain_cut:
                ab_f.write("\t".join(str(x) for x in row) + "\tgain\n")
            elif float(segment[4]) < loss_cut:
                ab_f.write("\t".join(str(x) for x in row) + "\tloss\n")
        elif isinstance(segment[3], str):
            continue
        else:
            if float(segment[3]) > cfg.zscore:
                ab_f.write("\t".join(str(x) for x in row) + "\tgain\n")
            elif float(segment[3]) < -cfg.zscore:
                ab_f.write("\t".join(str(x) for x in row) + "\tloss\n")

    seg_f.close()
    ab_f.close()


def _generate_chr_statistics_file(outid, bins, segments):
    """reference predict_output.py:197-263."""
    with open(f"{outid}_statistics.txt", "w") as f:
        f.write("chr\tratio.mean\tratio.median\tzscore\n")
        n_chr = len(bins.results_r)
        chr_ratio_means = [
            float(np.average(bins.results_r[c], weights=bins.results_w[c]))
            if np.sum(bins.results_w[c]) > 0
            else float("nan")
            for c in range(n_chr)
        ]
        chr_ratio_medians = [
            float(np.median([x for x in bins.results_r[c] if x != 0]))
            if any(x != 0 for x in bins.results_r[c])
            else float("nan")
            for c in range(n_chr)
        ]
        results_c_chr = [
            [c, 0, len(bins.results_r[c]) - 1, chr_ratio_means[c]]
            for c in range(n_chr)
        ]
        msv = round(
            get_median_segment_variance(segments, bins.results_r), 5
        )
        cpa = round(get_cpa(segments, bins.binsize), 5)
        chr_z = get_z_score(
            results_c_chr, bins.results_r, bins.results_w, bins.results_nr
        )

        for c in range(n_chr):
            row = [
                _chr_name(c),
                chr_ratio_means[c],
                chr_ratio_medians[c],
                chr_z[c],
            ]
            f.write("\t".join(str(x) for x in row) + "\n")

        f.write(
            "Gender based on --yfrac (or manually overridden by --gender): "
            f"{bins.gender}\n"
        )
        f.write(f"Number of reads: {bins.n_reads}\n")
        f.write(
            "Standard deviation of the ratios per chromosome: "
            f"{round(float(np.nanstd(chr_ratio_means)), 5)}\n"
        )
        f.write(
            "Median segment variance per bin (doi: 10.1093/nar/gky1263): "
            f"{msv}\n"
        )
        f.write(
            "Copy number profile abnormality (CPA) score (doi: "
            f"10.1186/s13073-020-00735-4): {cpa}\n"
        )


def _generate_regions_bed(outid, bins, regions_path):
    """reference predict_output.py:86-134 (fork addition), with its X/Y
    crash fixed: the reference assigns chr=21/22 for X/Y and then
    unconditionally overwrites it with ``int(re.sub("chr", "", name)) - 1``
    which raises ValueError on X/Y rows (predict_output.py:98-102); here
    X/Y map to their real indexes 22/23."""
    with open(f"{outid}_regions.bed", "w") as out:
        out.write("chr\tstart\tend\tname\tratio\tzscore\n")
        regions = [
            (lineno, line.strip().split("\t"))
            for lineno, line in enumerate(open(regions_path), 1)
            if line.strip() != ""
        ]
        for lineno, region in regions:
            if len(region) < 4:
                raise BedParseError(
                    f"{regions_path}:{lineno}: regions rows need at least "
                    "4 tab-separated columns (chr, start, end, name); got "
                    f"{len(region)}"
                )
            chr_name, start, end, name = region[:4]
            stripped = chr_name.removeprefix("chr")
            try:
                if stripped == "X":
                    chrom = 22
                elif stripped == "Y":
                    chrom = 23
                else:
                    chrom = int(stripped) - 1
                start_i, end_i = int(start), int(end)
            except ValueError:
                raise BedParseError(
                    f"{regions_path}:{lineno}: cannot parse region "
                    f"'{chr_name}\\t{start}\\t{end}' (chr must be 1-22/X/Y, "
                    "start/end integers)"
                ) from None
            if chrom >= len(bins.results_r):
                out.write(
                    "Skipping invalid region: " + "\t".join(region) + "\n"
                )
                continue
            start_bin = start_i // bins.binsize
            end_bin = end_i // bins.binsize
            n_bins_chr = len(bins.results_r[chrom])
            if end_bin >= n_bins_chr:
                end_bin = n_bins_chr - 1
            if start_bin < 0 or end_bin < 0 or start_bin > end_bin:
                out.write(
                    "Skipping invalid region: " + "\t".join(region) + "\n"
                )
                continue

            rr = np.asarray(bins.results_r[chrom][start_bin : end_bin + 1])
            ww = np.asarray(bins.results_w[chrom][start_bin : end_bin + 1])
            zz = np.asarray(bins.results_z[chrom][start_bin : end_bin + 1])
            if len(rr) == 0:
                out.write(
                    "Skipping region with no bins: " + "\t".join(region) + "\n"
                )
                continue
            if np.sum(ww) > 0:
                ratio_mean = float(np.average(rr, weights=ww))
                zscore_mean = float(np.average(zz, weights=ww))
            else:
                ratio_mean = float("nan")
                zscore_mean = float("nan")
            ratio_out = "nan" if ratio_mean == 0 else ratio_mean
            z_out = "nan" if zscore_mean == 0 else zscore_mean
            row = [chr_name, start, end, name, ratio_out, z_out]
            out.write("\t".join(str(x) for x in row) + "\n")
