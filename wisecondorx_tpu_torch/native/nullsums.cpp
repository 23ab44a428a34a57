// The weighted null-ratio sums of WisecondorX's segment z-score, one
// chromosome's intervals per call.
//
// Built with g++ (C++17) by wisecondorx_tpu_torch/ops/stats.py and called
// through ctypes; its sums equal, bit for bit, that module's numpy version
// (_numpy_null_sums), which stays as the plain version.  For an interval
// [start, stop) of a chromosome's rows and each null column j:
//
//   num[j] = sum over rows i with r[i] != 0 of  nr[i, j] * w[i]  where that
//            product is a number and nr[i, j] is finite, else +0.0
//            (np.nansum of the products, non-finite nulls made NaN);
//   den[j] = the same sum of  w[i] * (nr[i, j] is finite ? 1.0 : 0.0)
//            (np.sum of w times the boolean mask);
//   rows   = the number of rows with r[i] != 0 (NaN included).
//
// numpy sums axis 0 of a C-contiguous [rows, width] table row after row
// into an output that starts at +0.0, for every width above 1 (at width 1
// it sums pairwise; the caller keeps that width on numpy).  This pass adds
// in the same order, and rounds each product before it is added: the
// pragmas below forbid contracting a multiply and an add into one fused
// operation, whatever flags the file is built with.  GCC's no-trapping-math
// lets it turn the selects into vector blends (no program reads the flags
// a compare raises); it changes no value.  On x86-64 the pass is built
// twice, for AVX2 and for the baseline, and the loader picks by the CPU.

#include <cfloat>
#include <cmath>
#include <cstdint>

#if defined(__clang__)
#pragma STDC FP_CONTRACT OFF
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off", "no-trapping-math")
#endif

#if defined(__GNUC__) && !defined(__clang__) && defined(__x86_64__)
#define WCX_CLONES __attribute__((target_clones("avx2", "default")))
#else
#define WCX_CLONES
#endif

namespace {

// One informative row added into an interval's sums.  Branch-free over the
// width, so the compiler vectorises it.
inline void add_row(const double *__restrict row, double w,
                    double *__restrict num, double *__restrict den,
                    int64_t width) {
  // numpy's w * mask, for a mask of 1 and of 0.
  const double w_one = w * 1.0, w_zero = w * 0.0;
  for (int64_t j = 0; j < width; ++j) {
    const double x = row[j];
    const bool finite = std::fabs(x) <= DBL_MAX;
    const double p = x * w;
    num[j] += (finite & (p == p)) ? p : 0.0;
    den[j] += finite ? w_one : w_zero;
  }
}

}  // namespace

extern "C" {

// r, w: the chromosome's ratios and weights (float64, n rows); nr: its null
// table, row i at nr + i * row_stride (float64, contiguous along the width).
// bounds: n_intervals (start, stop) pairs, 0 <= start <= stop <= n.  Writes
// num and den ([n_intervals, width]) and rows ([n_intervals]).  Returns 0,
// or -1 if a bound lies outside [0, n].
WCX_CLONES
int64_t wcx_null_sums(const double *r, const double *w, const double *nr,
                      int64_t n, int64_t row_stride, int64_t width,
                      const int64_t *bounds, int64_t n_intervals, double *num,
                      double *den, int64_t *rows) {
  for (int64_t t = 0; t < n_intervals; ++t) {
    const int64_t start = bounds[2 * t], stop = bounds[2 * t + 1];
    if (start < 0 || stop < start || stop > n) return -1;
    double *const num_t = num + t * width;
    double *const den_t = den + t * width;
    for (int64_t j = 0; j < width; ++j) num_t[j] = den_t[j] = 0.0;
    int64_t informative = 0;
    for (int64_t i = start; i < stop; ++i) {
      if (!(r[i] != 0.0)) continue;
      ++informative;
      add_row(nr + i * row_stride, w[i], num_t, den_t, width);
    }
    rows[t] = informative;
  }
  return 0;
}

}  // extern "C"
