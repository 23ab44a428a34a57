"""BAM/CRAM conversion: aligned reads -> per-chromosome binned counts.

Drives the native C++ readers (native/bamreader.cpp for BGZF BAM,
native/cramreader.cpp for CRAM 3.0) through ctypes — the image has no
pysam, and the reference's per-read Python loop (convert_tools.py:15-120)
is its second hottest path anyway.  The native pass streams the whole
coordinate-sorted file once, binning all selected contigs simultaneously
(the reference re-fetches per contig through the index; a single
sequential pass visits reads in the same order, so the larp/larp2
duplicate-removal state machine behaves identically).

Contig-name semantics mirror convert_tools.py:50-71: a leading "chr" is
stripped case-insensitively, X -> "23", Y -> "24", anything not in 1..24
is skipped; per-contig count arrays are sized ``int(length/binsize + 1)``.

The CRAM reader decodes only the data series the binner needs (BF, CF,
RI, AP, MQ, NF, NP) — sequences are never reconstructed, so unlike
pysam/htslib no reference FASTA is required; ``-r/--reference`` is
accepted for CLI compatibility and ignored.

Copy of wisecondorx_tpu/io/bam.py; the port imports nothing of that
package and keeps its own copy of the reader sources (``native/`` in this
package), built on first use into ``build/wcx_torch_native/`` beside the
package, named by a hash of the sources.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np

from wisecondorx_tpu_torch.errors import UserInputError
from wisecondorx_tpu_torch.utils.native import NATIVE_DIR, build_library


class ConvertError(RuntimeError, UserInputError):
    pass


_LOCK = threading.Lock()
_LIB = None

_QC_KEYS = (
    "mapped",
    "unmapped",
    "no_coordinate",
    "filter_rmdup",
    "filter_mapq",
    "pre_retro",
    "pair_fail",
    "total",
)


def _build_library() -> Path:
    srcs = ["bamreader.cpp", "cramreader.cpp"]
    for src in srcs:
        if not (NATIVE_DIR / src).exists():
            raise ConvertError(f"native source missing: {NATIVE_DIR / src}")
    # -l: form — the image ships libbz2.so.1.0 without the dev symlink; the
    # three codecs have stable ABIs.
    return build_library("wcxbam", srcs,
                         ["-lz", "-l:libbz2.so.1.0", "-llzma"])


def _load_library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build_library())))
        return _LIB


def _bind(lib):
    for prefix in ("wcx_bam", "wcx_cram"):
        open_f = getattr(lib, prefix + "_open")
        open_f.restype = ctypes.c_void_p
        open_f.argtypes = [ctypes.c_char_p]
        err_f = getattr(lib, prefix + "_error")
        err_f.restype = ctypes.c_char_p
        err_f.argtypes = [ctypes.c_void_p]
        nref_f = getattr(lib, prefix + "_nref")
        nref_f.restype = ctypes.c_int
        nref_f.argtypes = [ctypes.c_void_p]
        name_f = getattr(lib, prefix + "_ref_name")
        name_f.restype = ctypes.c_char_p
        name_f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        len_f = getattr(lib, prefix + "_ref_len")
        len_f.restype = ctypes.c_int64
        len_f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        count_f = getattr(lib, prefix + "_count")
        count_f.restype = ctypes.c_int
        count_f.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        getattr(lib, prefix + "_close").argtypes = [ctypes.c_void_p]
    return lib


def _normalize_contig(name: str) -> str | None:
    """Map a contig name to the internal "1".."24" keys, or None to skip."""
    if name[:3].lower() == "chr":
        name = name[3:]
    if name == "X":
        return "23"
    if name == "Y":
        return "24"
    if name in {str(c) for c in range(1, 25)}:
        return name
    return None


def convert_reads(
    infile: str,
    binsize: float,
    reference_fasta: str | None = None,
    normdup: bool = False,
):
    """Convert a BAM/CRAM file to (bins dict chr->int32 counts, quality
    dict).

    Matches the reference's output contract (convert_tools.py:107-120).
    """
    if infile.endswith(".cram"):
        prefix = "wcx_cram"
        if reference_fasta:
            logging.info(
                "CRAM decode does not reconstruct sequences; the reference "
                "fasta is not needed and will be ignored."
            )
    elif infile.endswith(".bam"):
        prefix = "wcx_bam"
    else:
        raise ConvertError(
            "Unsupported input file type. Make sure your input filename "
            "has a correct extension (bam/cram)"
        )

    lib = _load_library()
    f_open = getattr(lib, prefix + "_open")
    f_error = getattr(lib, prefix + "_error")
    f_nref = getattr(lib, prefix + "_nref")
    f_ref_name = getattr(lib, prefix + "_ref_name")
    f_ref_len = getattr(lib, prefix + "_ref_len")
    f_count = getattr(lib, prefix + "_count")
    f_close = getattr(lib, prefix + "_close")

    handle = f_open(infile.encode())
    try:
        n_ref = f_nref(handle)
        if n_ref < 0:
            raise ConvertError(
                f"Failed to open {infile}: {f_error(handle).decode()}"
            )

        bins_per_chr: dict = {str(c): None for c in range(1, 25)}
        slot_of_ref = np.full(n_ref, -1, dtype=np.int32)
        buffers: list[np.ndarray] = []
        buffer_keys: list[str] = []
        for i in range(n_ref):
            raw_name = f_ref_name(handle, i).decode()
            length = f_ref_len(handle, i)
            key = _normalize_contig(raw_name)
            if key is None:
                continue
            n_bins = int(length / float(binsize) + 1)
            logging.info(
                "Working at %s; processing %d bins", raw_name, n_bins
            )
            arr = np.zeros(n_bins, dtype=np.int32)
            slot_of_ref[i] = len(buffers)
            buffers.append(arr)
            buffer_keys.append(key)

        ptr_type = ctypes.POINTER(ctypes.c_int32)
        counts_ptrs = (ptr_type * max(len(buffers), 1))(
            *[b.ctypes.data_as(ptr_type) for b in buffers]
        )
        counts_len = (ctypes.c_int64 * max(len(buffers), 1))(
            *[len(b) for b in buffers]
        )
        qc = (ctypes.c_int64 * 8)()

        logging.info(
            "Converting aligned reads ... This might take a while ..."
        )
        rc = f_count(
            handle,
            float(binsize),
            1 if normdup else 0,
            slot_of_ref.ctypes.data_as(ptr_type),
            counts_ptrs,
            counts_len,
            qc,
        )
        if rc != 0:
            raise ConvertError(
                f"Parsing failed: {f_error(handle).decode()}"
            )
    finally:
        f_close(handle)

    for key, arr in zip(buffer_keys, buffers):
        bins_per_chr[key] = arr

    reads_kept = int(sum(int(b.sum()) for b in buffers))
    qc_vals = dict(zip(_QC_KEYS, [int(x) for x in qc]))
    qual_info = {
        "mapped": qc_vals["mapped"],
        "unmapped": qc_vals["unmapped"],
        "no_coordinate": qc_vals["no_coordinate"],
        "filter_rmdup": qc_vals["filter_rmdup"],
        "filter_mapq": qc_vals["filter_mapq"],
        "pre_retro": qc_vals["pre_retro"],
        "post_retro": reads_kept,
        "pair_fail": qc_vals["pair_fail"],
    }
    return bins_per_chr, qual_info
