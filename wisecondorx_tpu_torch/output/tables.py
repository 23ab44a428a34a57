"""BED/statistics writers — byte-format parity with reference
predict_output.py.

Formats preserved exactly: header lines, 1-based starts (``bin*binsize+1``),
0 -> "nan" substitution in the bins table, gain/loss calling by segment z
against ``--zscore`` or by ratio against the beta cutoffs
``log2((ploidy +- beta/2)/ploidy)`` with ploidy 1 for male gonosomes.

Copy of wisecondorx_tpu/output/tables.py; the port imports nothing of that
package, and tests/test_torch_host.py holds the two to the same bytes.
"""

from __future__ import annotations

import numpy as np

from wisecondorx_tpu_torch.errors import BedParseError
from wisecondorx_tpu_torch.ops.stats import (
    get_cpa,
    get_median_segment_variance,
    get_z_score,
)


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


def _generate_bins_bed(outid, bins):
    """reference predict_output.py:59-84.

    Byte-identical to the reference's per-row loop (``repr`` of a Python
    float equals numpy's scalar ``str`` — both shortest-round-trip), but
    batched per chromosome: at 15 kb a plate pays ~0.5 s per sample in
    row formatting otherwise."""
    binsize = bins.binsize

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

    with open(f"{outid}_bins.bed", "w") as f:
        f.write("chr\tstart\tend\tid\tratio\tzscore\n")
        for c in range(len(bins.results_r)):
            chr_name = _chr_name(c)
            rs, rfmt = cells(bins.results_r[c])
            zs, zfmt = cells(bins.results_z[c])
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
            if lines:
                f.write("\n".join(lines) + "\n")


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
