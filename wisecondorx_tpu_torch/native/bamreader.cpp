// wisecondorx_tpu native BAM reader.
//
// The reference tool streams reads through pysam/htslib and bins them in a
// per-read Python loop (reference convert_tools.py:15-120) — its second
// hottest loop.  This is a dependency-free reimplementation: BGZF
// decompression via zlib's gzip-member streaming and a single sequential
// pass over the alignment records, applying the reference's exact filter
// semantics (proper-pair, consecutive-start duplicate removal via the
// larp/larp2 state machine, mapq >= 1) and accumulating int32 bin counts.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image):
//   wcx_bam_open / wcx_bam_nref / wcx_bam_ref_name / wcx_bam_ref_len /
//   wcx_bam_count / wcx_bam_close
//
// CRAM is not handled here (it needs the full htslib codec stack); the
// Python layer reports a clear error for .cram inputs.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kInChunk = 1 << 20;
constexpr size_t kOutChunk = 1 << 20;

struct BgzfReader {
  FILE* f = nullptr;
  z_stream strm{};
  bool stream_live = false;
  bool in_eof = false;
  std::vector<uint8_t> in;
  size_t in_len = 0;
  std::string error;

  bool open(const char* path) {
    f = fopen(path, "rb");
    if (!f) {
      error = "cannot open file";
      return false;
    }
    in.resize(kInChunk);
    memset(&strm, 0, sizeof(strm));
    if (inflateInit2(&strm, 15 + 16) != Z_OK) {  // gzip member decoding
      error = "inflateInit2 failed";
      return false;
    }
    stream_live = true;
    return true;
  }

  // Decompress up to n bytes into out. Returns bytes produced; 0 at EOF,
  // -1 on error.
  long read(uint8_t* out, size_t n) {
    size_t produced = 0;
    while (produced < n) {
      if (strm.avail_in == 0 && !in_eof) {
        in_len = fread(in.data(), 1, in.size(), f);
        if (in_len == 0) {
          if (ferror(f)) {
            error = "read error";
            return -1;
          }
          in_eof = true;
        }
        strm.next_in = in.data();
        strm.avail_in = static_cast<uInt>(in_len);
      }
      if (strm.avail_in == 0 && in_eof) break;

      strm.next_out = out + produced;
      strm.avail_out = static_cast<uInt>(n - produced);
      int ret = inflate(&strm, Z_NO_FLUSH);
      produced = n - strm.avail_out;
      if (ret == Z_STREAM_END) {
        // End of one gzip member (one BGZF block); reset for the next.
        if (inflateReset(&strm) != Z_OK) {
          error = "inflateReset failed";
          return -1;
        }
      } else if (ret != Z_OK && ret != Z_BUF_ERROR) {
        error = std::string("inflate failed: ") +
                (strm.msg ? strm.msg : "unknown");
        return -1;
      }
      if (ret == Z_BUF_ERROR && strm.avail_in == 0 && in_eof) break;
    }
    return static_cast<long>(produced);
  }

  // Read exactly n bytes; false on EOF-before-n (eof==true if clean EOF at
  // a record boundary with n untouched).
  bool read_exact(uint8_t* out, size_t n, bool* clean_eof) {
    long got = read(out, n);
    if (got < 0) return false;
    if (static_cast<size_t>(got) == n) return true;
    if (got == 0 && clean_eof) *clean_eof = true;
    if (got != 0) error = "truncated BAM record";
    return false;
  }

  void close() {
    if (stream_live) inflateEnd(&strm);
    stream_live = false;
    if (f) fclose(f);
    f = nullptr;
  }
};

struct RefInfo {
  std::string name;
  int64_t length;
};

struct BamFile {
  BgzfReader bgzf;
  std::vector<RefInfo> refs;
  std::string error;
  long data_start_consumed = 0;

  bool open_and_parse_header(const char* path) {
    if (!bgzf.open(path)) {
      error = bgzf.error;
      return false;
    }
    uint8_t magic[4];
    bool clean = false;
    if (!bgzf.read_exact(magic, 4, &clean)) {
      error = bgzf.error.empty() ? "empty file" : bgzf.error;
      return false;
    }
    if (memcmp(magic, "BAM\1", 4) != 0) {
      error = "not a BAM file (bad magic)";
      return false;
    }
    int32_t l_text;
    if (!bgzf.read_exact(reinterpret_cast<uint8_t*>(&l_text), 4, nullptr))
      return fail();
    std::vector<uint8_t> text(l_text);
    if (l_text > 0 && !bgzf.read_exact(text.data(), l_text, nullptr))
      return fail();
    int32_t n_ref;
    if (!bgzf.read_exact(reinterpret_cast<uint8_t*>(&n_ref), 4, nullptr))
      return fail();
    refs.reserve(n_ref);
    for (int32_t i = 0; i < n_ref; i++) {
      int32_t l_name;
      if (!bgzf.read_exact(reinterpret_cast<uint8_t*>(&l_name), 4, nullptr))
        return fail();
      std::vector<char> name(l_name);
      if (!bgzf.read_exact(reinterpret_cast<uint8_t*>(name.data()), l_name,
                           nullptr))
        return fail();
      int32_t l_ref;
      if (!bgzf.read_exact(reinterpret_cast<uint8_t*>(&l_ref), 4, nullptr))
        return fail();
      refs.push_back({std::string(name.data()), l_ref});
    }
    return true;
  }

  bool fail() {
    error = bgzf.error.empty() ? "truncated BAM header" : bgzf.error;
    return false;
  }
};

}  // namespace

extern "C" {

// QC counter layout for wcx_bam_count's qc_out (length 8).
enum {
  QC_MAPPED = 0,
  QC_UNMAPPED = 1,
  QC_NO_COORDINATE = 2,
  QC_FILTER_RMDUP = 3,
  QC_FILTER_MAPQ = 4,
  QC_PRE_RETRO = 5,   // reads_seen
  QC_PAIR_FAIL = 6,
  QC_TOTAL = 7,
};

void* wcx_bam_open(const char* path) {
  auto* bam = new BamFile();
  if (!bam->open_and_parse_header(path)) {
    // keep the object alive so the error can be queried
    return bam;
  }
  return bam;
}

const char* wcx_bam_error(void* handle) {
  auto* bam = static_cast<BamFile*>(handle);
  return bam->error.c_str();
}

int wcx_bam_nref(void* handle) {
  auto* bam = static_cast<BamFile*>(handle);
  return bam->error.empty() ? static_cast<int>(bam->refs.size()) : -1;
}

const char* wcx_bam_ref_name(void* handle, int i) {
  auto* bam = static_cast<BamFile*>(handle);
  return bam->refs[i].name.c_str();
}

int64_t wcx_bam_ref_len(void* handle, int i) {
  auto* bam = static_cast<BamFile*>(handle);
  return bam->refs[i].length;
}

// Stream all alignment records, binning reads on selected references.
//
// slot_of_ref: length n_ref; slot_of_ref[refID] == -1 skips that contig,
//   otherwise indexes counts_ptrs.
// counts_ptrs: per-slot int32 buffers sized int(ref_len/binsize + 1).
// qc_out: 8 int64 counters (layout above).
//
// Returns 0 on success, -1 on error (see wcx_bam_error).
int wcx_bam_count(void* handle, double binsize, int normdup,
                  const int32_t* slot_of_ref, int32_t** counts_ptrs,
                  const int64_t* counts_len, int64_t* qc_out) {
  auto* bam = static_cast<BamFile*>(handle);
  if (!bam->error.empty()) return -1;
  BgzfReader& r = bam->bgzf;

  // The reference's duplicate-removal state machine
  // (convert_tools.py:45-46, 78-96): larp/larp2 persist across contigs.
  int64_t larp = -1, larp2 = -1;
  int64_t qc[8] = {0, 0, 0, 0, 0, 0, 0, 0};

  std::vector<uint8_t> rec;
  const int n_ref = static_cast<int>(bam->refs.size());

  for (;;) {
    int32_t block_size;
    bool clean_eof = false;
    if (!r.read_exact(reinterpret_cast<uint8_t*>(&block_size), 4,
                      &clean_eof)) {
      if (clean_eof) break;
      bam->error = r.error;
      return -1;
    }
    if (block_size < 32) {
      bam->error = "corrupt BAM record (block_size < 32)";
      return -1;
    }
    rec.resize(block_size);
    if (!r.read_exact(rec.data(), block_size, nullptr)) {
      bam->error = r.error.empty() ? "truncated BAM record" : r.error;
      return -1;
    }

    int32_t ref_id, pos, next_pos;
    uint32_t meta1, flag_nc;
    memcpy(&ref_id, rec.data() + 0, 4);
    memcpy(&pos, rec.data() + 4, 4);
    memcpy(&meta1, rec.data() + 8, 4);   // bin<<16 | mapq<<8 | l_read_name
    memcpy(&flag_nc, rec.data() + 12, 4);  // flag<<16 | n_cigar_op
    memcpy(&next_pos, rec.data() + 24, 4);
    const uint32_t mapq = (meta1 >> 8) & 0xff;
    const uint32_t flag = flag_nc >> 16;

    qc[QC_TOTAL]++;
    if (flag & 0x4)
      qc[QC_UNMAPPED]++;
    else
      qc[QC_MAPPED]++;
    if (ref_id < 0 || pos < 0) qc[QC_NO_COORDINATE]++;

    if (ref_id < 0 || ref_id >= n_ref) continue;
    const int32_t slot = slot_of_ref[ref_id];
    if (slot < 0) continue;

    const bool paired = flag & 0x1;
    if (paired) {
      if (!(flag & 0x2)) {  // not proper pair
        qc[QC_PAIR_FAIL]++;
        continue;
      }
      if (!normdup && larp == pos && larp2 == next_pos) {
        qc[QC_FILTER_RMDUP]++;
      } else {
        if (mapq >= 1) {
          const int64_t bin = static_cast<int64_t>(pos / binsize);
          if (bin >= 0 && bin < counts_len[slot]) counts_ptrs[slot][bin]++;
        } else {
          qc[QC_FILTER_MAPQ]++;
        }
      }
      larp2 = next_pos;
      qc[QC_PRE_RETRO]++;
      larp = pos;
    } else {
      if (!normdup && larp == pos) {
        qc[QC_FILTER_RMDUP]++;
      } else {
        if (mapq >= 1) {
          const int64_t bin = static_cast<int64_t>(pos / binsize);
          if (bin >= 0 && bin < counts_len[slot]) counts_ptrs[slot][bin]++;
        } else {
          qc[QC_FILTER_MAPQ]++;
        }
      }
      qc[QC_PRE_RETRO]++;
      larp = pos;
    }
  }

  memcpy(qc_out, qc, sizeof(qc));
  return 0;
}

void wcx_bam_close(void* handle) {
  auto* bam = static_cast<BamFile*>(handle);
  bam->bgzf.close();
  delete bam;
}

}  // extern "C"
