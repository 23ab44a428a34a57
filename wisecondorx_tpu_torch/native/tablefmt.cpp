// The rows of WisecondorX's <outid>_bins.bed, one chromosome per call.
//
// Built with g++ (C++17, <charconv>) by wisecondorx_tpu_torch/output/
// tables.py and called through ctypes; its output equals, byte for byte,
// that module's Python loop (_python_bin_rows), which stays as the plain
// version.  A row is
//
//   chr \t start \t end \t chr:start-end \t ratio \t zscore \n
//
// with start = 1 + i * binsize and end = start + binsize - 1.  A cell equal
// to 0 (-0 too) or NaN prints "nan", +-inf prints "inf" / "-inf".  Any
// other value prints the shortest digits that round-trip in the array's own
// type (std::to_chars), laid out as
//
//   float32  str(numpy.float32(x)): positional iff f32_low < |x| < f32_high,
//            compared as values.  numpy's scalar rule puts the bounds at
//            powers of ten that depend on its version (1e-4 and 1e16 in
//            numpy 2.0, 1e-4 and 1e6 in numpy 2.3); the caller passes the
//            float32 values at them that print in exponent form;
//   float64  repr(float(x)): positional iff -4 <= decimal exponent < 16,
//            the exponent of the shortest digits (Python's rule).
//
// Positional values print every integral digit and at least one fraction
// digit ("123456790.0"); the others d[.ddd]e+-XX, at least two exponent
// digits ("1e-05", "3e+20"), as to_chars' scientific form prints them.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Longest cell: "-1.2345678901234567e-308" is 24 characters.
constexpr int64_t kCellMax = 48;
// Longest integer: a signed 64-bit value.
constexpr int64_t kIntMax = 20;

template <typename T>
char *put_cell(char *p, T v, double f32_low, double f32_high) {
  if (v == 0 || std::isnan(v)) {
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *p++ = '-';
    std::memcpy(p, "inf", 3);
    return p + 3;
  }
  char sci[kCellMax];
  char *const sci_end =
      std::to_chars(sci, sci + kCellMax, v, std::chars_format::scientific).ptr;
  const char *s = sci;
  const bool neg = *s == '-';
  if (neg) ++s;
  const char *e = static_cast<const char *>(std::memchr(s, 'e', sci_end - s));
  int exp = 0;
  for (const char *q = e + 2; q < sci_end; ++q) exp = exp * 10 + (*q - '0');
  if (e[1] == '-') exp = -exp;

  bool positional;
  if constexpr (sizeof(T) == 4) {
    const double a = std::fabs(static_cast<double>(v));
    positional = a > f32_low && a < f32_high;
  } else {
    positional = exp >= -4 && exp < 16;
  }
  if (!positional) {
    std::memcpy(p, sci, sci_end - sci);
    return p + (sci_end - sci);
  }

  char digits[kCellMax];
  int nd = 0;
  digits[nd++] = s[0];
  if (s[1] == '.')
    for (const char *q = s + 2; q < e; ++q) digits[nd++] = *q;
  if (neg) *p++ = '-';
  if (exp >= 0) {
    const int n_int = exp + 1;
    for (int k = 0; k < n_int; ++k) *p++ = k < nd ? digits[k] : '0';
    *p++ = '.';
    if (nd > n_int) {
      std::memcpy(p, digits + n_int, nd - n_int);
      p += nd - n_int;
    } else {
      *p++ = '0';
    }
  } else {
    *p++ = '0';
    *p++ = '.';
    for (int k = 0; k < -exp - 1; ++k) *p++ = '0';
    std::memcpy(p, digits, nd);
    p += nd;
  }
  return p;
}

template <typename T>
int64_t format_rows(const T *r, const T *z, int64_t n, int64_t binsize,
                    const char *chr, char *out, int64_t cap, double f32_low,
                    double f32_high) {
  const int64_t n_chr = static_cast<int64_t>(std::strlen(chr));
  const int64_t row_max = 2 * n_chr + 4 * kIntMax + 2 * kCellMax + 8;
  char *p = out;
  char *const lim = out + cap;
  int64_t start = 1;
  for (int64_t i = 0; i < n; ++i, start += binsize) {
    if (lim - p < row_max) return -1;
    const int64_t end = start + binsize - 1;
    std::memcpy(p, chr, n_chr);
    p += n_chr;
    *p++ = '\t';
    p = std::to_chars(p, lim, start).ptr;
    *p++ = '\t';
    p = std::to_chars(p, lim, end).ptr;
    *p++ = '\t';
    std::memcpy(p, chr, n_chr);
    p += n_chr;
    *p++ = ':';
    p = std::to_chars(p, lim, start).ptr;
    *p++ = '-';
    p = std::to_chars(p, lim, end).ptr;
    *p++ = '\t';
    p = put_cell(p, r[i], f32_low, f32_high);
    *p++ = '\t';
    p = put_cell(p, z[i], f32_low, f32_high);
    *p++ = '\n';
  }
  return p - out;
}

}  // namespace

extern "C" {

// Bytes of out one row may take, for a chromosome name of n_chr bytes.
int64_t wcx_bins_row_max(int64_t n_chr) {
  return 2 * n_chr + 4 * kIntMax + 2 * kCellMax + 8;
}

// Writes the n rows of one chromosome into out (cap bytes): r and z hold n
// contiguous values of dtype_bits (32: float32, 64: float64); float32
// values print positionally iff f32_low < |x| < f32_high.  Returns the
// bytes written, or -1 if cap is too small or dtype_bits is neither.
int64_t wcx_format_bins(const void *r, const void *z, int dtype_bits,
                        int64_t n, int64_t binsize, const char *chr_name,
                        char *out, int64_t cap, double f32_low,
                        double f32_high) {
  if (dtype_bits == 32)
    return format_rows(static_cast<const float *>(r),
                       static_cast<const float *>(z), n, binsize, chr_name,
                       out, cap, f32_low, f32_high);
  if (dtype_bits == 64)
    return format_rows(static_cast<const double *>(r),
                       static_cast<const double *>(z), n, binsize, chr_name,
                       out, cap, f32_low, f32_high);
  return -1;
}

}  // extern "C"
