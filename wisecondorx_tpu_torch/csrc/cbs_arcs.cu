// CBS's arc statistic: the per-row maximum of |T| over a permutation
// round's arcs (wcx_cbs_arc_max) and the exact scan that locates a split
// (wcx_cbs_arc_argmax).
//
// Replaces the XLA program the JAX package runs for them in
// wisecondorx_tpu/ops/cbs.py: _tstat_scan (:154), a lax.scan over arc
// lengths with an 8-way unrolled body and a carried running max, plus
// _wrap_max (:236), under _max_t_rows_impl (:282) inside the fused round
// _perm_round_device (:346), and _tstat_scan's argmax under _locate_batch
// (:309).  The plain PyTorch versions are max_t_rows_reference and
// locate_rows_reference in wisecondorx_tpu_torch/ops/cbs.py.
//
// For the window arc (i, i + L] of a row of true size n, with the
// zero-prefixed cumulative sums cw, cwx of its weights and weighted values:
//   w1 = cw[i+L] - cw[i], x1 = cwx[i+L] - cwx[i], w0 = cw[n] - w1,
//   x0 = cwx[n] - x1, |T| = |(x1/w1 - x0/w0) * rsqrt(1/w1 + 1/w0)|,
// valid iff i + L <= n and min_width <= L <= n - min_width.  A wrap arc is
// a suffix of s slots plus a prefix of p (s, p >= 1, s + p <= kmax,
// min_width <= s + p <= n - min_width, s < n): w1 = (cw[n] - cw[n-s]) +
// cw[p], and x1 likewise.  Every operation is the plain version's, in its
// order, with IEEE rounding (__ddiv_rn, __dsub_rn, __dadd_rn, __dmul_rn:
// never contracted into an FMA) and CUDA's rsqrt(double), which ATen's
// rsqrt calls too, so the maxima can equal the plain version's on the card
// bit for bit.
//
// NaN: torch.amax and torch.maximum propagate NaN; CUDA's fmax does not,
// so it is not used.  A row with one NaN valid arc has a NaN maximum.  In
// the argmax a length with one NaN valid arc never improves the best
// (jnp.max of that length is NaN, and NaN > best is false): it drops out
// whole.
//
// What bounds it on an H100: FP64 operations.  An arc reads four float64
// prefix sums, which stay in L1 and L2 (a row is at most 2 x 32,769 x 8
// bytes = 512 KB), and costs four IEEE divisions and an rsqrt, each a
// sequence of several instructions on the FP64 pipe.
//
// Design, simple first.  Grid (rows, chunks): a row's lengths are dealt
// out over its chunks and each chunk's 8 warps, so warp w of chunk c takes
// the lengths g = c + chunks * (w + 8 q), q = 0, 1, ...; its 32 lanes
// stride over the starts i.  A chunk stages its lengths in shared memory.
// Max: each lane keeps a running max and a NaN flag in registers over all
// its arcs (chunk 0 also takes the wrap arcs); one block reduction writes
// the chunk's partial (NaN if any arc was NaN).  Argmax: per length one
// warp reduction of (max, smallest i at the max, any NaN); a warp's best
// (value, g, i) changes only on a strict improvement and meets its lengths
// in increasing g, and the block and the finishing reductions break ties
// by the smallest g.  That is the JAX rule (lengths scanned in their given
// order, only a strict improvement replaces the best, the smallest start
// within a length) written as one argmax over (value, -g, -i).  A
// finishing kernel reduces each row's chunks.  The wrapper sets the chunk
// count so that a round's thousand rows and a locate scan's few long
// segments (up to 32,768 lengths each) both spread over the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Lengths one chunk stages in shared memory (32 KB, under the 48 KB that
// needs no opt-in).
constexpr int MAX_STAGED = 8192;
constexpr int MAX_KMAX = 4096;

__device__ __forceinline__ double abs_t(double w1, double x1, double w0,
                                        double x0) {
  const double d = __dsub_rn(__ddiv_rn(x1, w1), __ddiv_rn(x0, w0));
  const double s = __dadd_rn(__ddiv_rn(1.0, w1), __ddiv_rn(1.0, w0));
  return fabs(__dmul_rn(d, rsqrt(s)));
}

// A row's true size, clamped into [0, n_pad] (the cumulative sums have
// n_pad + 1 columns).
__device__ __forceinline__ int row_size(const long long* n_rows, int row,
                                        int n_pad) {
  const long long n = n_rows[row];
  return (int)(n < 0 ? 0 : (n > n_pad ? n_pad : n));
}

// Stages chunk `chunk`'s lengths (g = chunk + chunks * j) in `lens`;
// returns how many there are.
__device__ __forceinline__ int stage_lengths(const int* __restrict__ lengths,
                                             int n_lengths, int chunk,
                                             int chunks, int* lens) {
  const int per = chunk < n_lengths ? (n_lengths - chunk + chunks - 1) / chunks : 0;
  for (int j = threadIdx.x; j < per; j += THREADS)
    lens[j] = lengths[chunk + chunks * j];
  __syncthreads();
  return per;
}

__global__ void __launch_bounds__(THREADS)
arc_max_kernel(const double* __restrict__ cw, const double* __restrict__ cwx,
               const long long* __restrict__ n_rows, int n_pad,
               const int* __restrict__ lengths, int n_lengths, int min_width,
               int kmax, int chunks, double* __restrict__ partial) {
  extern __shared__ int lens[];
  __shared__ double red_m[WARPS];
  __shared__ int red_nan[WARPS];
  const int row = blockIdx.x, chunk = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t stride = (size_t)n_pad + 1;
  const double* c = cw + row * stride;
  const double* cx = cwx + row * stride;
  const int n = row_size(n_rows, row, n_pad);
  const int per = stage_lengths(lengths, n_lengths, chunk, chunks, lens);
  const double w_tot = c[n], x_tot = cx[n];

  double m = -CUDART_INF;
  bool nan = false;
  for (int j = warp; j < per; j += WARPS) {
    const int L = lens[j];
    if (L < min_width || L > n - min_width) continue;
    for (int i = lane; i + L <= n; i += 32) {
      const double w1 = __dsub_rn(c[i + L], c[i]);
      const double x1 = __dsub_rn(cx[i + L], cx[i]);
      const double t = abs_t(w1, x1, __dsub_rn(w_tot, w1), __dsub_rn(x_tot, x1));
      if (t != t) nan = true;
      else if (t > m) m = t;
    }
  }
  if (chunk == 0) {
    for (int q = threadIdx.x; q < kmax * kmax; q += THREADS) {
      const int s = q / kmax + 1, p = q % kmax + 1, k = s + p;
      if (k > kmax || k < min_width || k > n - min_width || s >= n) continue;
      const double w1 = __dadd_rn(__dsub_rn(w_tot, c[n - s]), c[p]);
      const double x1 = __dadd_rn(__dsub_rn(x_tot, cx[n - s]), cx[p]);
      const double t = abs_t(w1, x1, __dsub_rn(w_tot, w1), __dsub_rn(x_tot, x1));
      if (t != t) nan = true;
      else if (t > m) m = t;
    }
  }
  nan = __any_sync(FULL, nan);
  for (int o = 16; o; o >>= 1) {
    const double om = __shfl_xor_sync(FULL, m, o);
    if (om > m) m = om;
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_nan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      if (red_m[w] > m) m = red_m[w];
      nan = nan || red_nan[w];
    }
    partial[(size_t)row * chunks + chunk] = nan ? CUDART_NAN : m;
  }
}

__global__ void __launch_bounds__(THREADS)
arc_max_finish(const double* __restrict__ partial, int rows, int chunks,
               double* __restrict__ out) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  double m = -CUDART_INF;
  bool nan = false;
  for (int k = lane; k < chunks; k += 32) {
    const double v = partial[(size_t)row * chunks + k];
    if (v != v) nan = true;
    else if (v > m) m = v;
  }
  nan = __any_sync(FULL, nan);
  for (int o = 16; o; o >>= 1) {
    const double om = __shfl_xor_sync(FULL, m, o);
    if (om > m) m = om;
  }
  if (lane == 0) out[row] = nan ? CUDART_NAN : m;
}

// (v, g, i) beats (bv, bg, bi): a larger value, or an equal one at an
// earlier length.
__device__ __forceinline__ bool beats(double v, int g, double bv, int bg) {
  return v > bv || (v == bv && g < bg);
}

__global__ void __launch_bounds__(THREADS)
arc_argmax_kernel(const double* __restrict__ cw, const double* __restrict__ cwx,
                  const long long* __restrict__ n_rows, int n_pad,
                  const int* __restrict__ lengths, int n_lengths,
                  int min_width, int chunks, double* __restrict__ part_v,
                  int* __restrict__ part_g, int* __restrict__ part_i) {
  extern __shared__ int lens[];
  __shared__ double red_v[WARPS];
  __shared__ int red_g[WARPS], red_i[WARPS];
  const int row = blockIdx.x, chunk = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t stride = (size_t)n_pad + 1;
  const double* c = cw + row * stride;
  const double* cx = cwx + row * stride;
  const int n = row_size(n_rows, row, n_pad);
  const int per = stage_lengths(lengths, n_lengths, chunk, chunks, lens);
  const double w_tot = c[n], x_tot = cx[n];

  double bv = -CUDART_INF;
  int bg = INT_MAX, bi = 0;
  for (int j = warp; j < per; j += WARPS) {
    const int L = lens[j];
    if (L < min_width || L > n - min_width) continue;  // the same for the warp
    double m = -CUDART_INF;
    int mi = INT_MAX;
    bool nan = false;
    for (int i = lane; i + L <= n; i += 32) {
      const double w1 = __dsub_rn(c[i + L], c[i]);
      const double x1 = __dsub_rn(cx[i + L], cx[i]);
      const double t = abs_t(w1, x1, __dsub_rn(w_tot, w1), __dsub_rn(x_tot, x1));
      if (t != t) nan = true;
      else if (t > m) {  // strict: a lane meets its starts in increasing i
        m = t;
        mi = i;
      }
    }
    nan = __any_sync(FULL, nan);
    for (int o = 16; o; o >>= 1) {
      const double om = __shfl_xor_sync(FULL, m, o);
      const int oi = __shfl_xor_sync(FULL, mi, o);
      if (om > m || (om == m && oi < mi)) {
        m = om;
        mi = oi;
      }
    }
    if (!nan && m > bv) {
      bv = m;
      bg = chunk + chunks * j;
      bi = mi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_g[warp] = bg;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      if (beats(red_v[w], red_g[w], bv, bg)) {
        bv = red_v[w];
        bg = red_g[w];
        bi = red_i[w];
      }
    }
    const size_t k = (size_t)row * chunks + chunk;
    part_v[k] = bv;
    part_g[k] = bg;
    part_i[k] = bi;
  }
}

__global__ void __launch_bounds__(THREADS)
arc_argmax_finish(const double* __restrict__ part_v,
                  const int* __restrict__ part_g, const int* __restrict__ part_i,
                  int rows, int chunks, const int* __restrict__ lengths,
                  long long* __restrict__ best_i, long long* __restrict__ best_l) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  double bv = -CUDART_INF;
  int bg = INT_MAX, bi = 0;
  for (int k = lane; k < chunks; k += 32) {
    const size_t p = (size_t)row * chunks + k;
    if (beats(part_v[p], part_g[p], bv, bg)) {
      bv = part_v[p];
      bg = part_g[p];
      bi = part_i[p];
    }
  }
  for (int o = 16; o; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, bv, o);
    const int og = __shfl_xor_sync(FULL, bg, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats(ov, og, bv, bg)) {
      bv = ov;
      bg = og;
      bi = oi;
    }
  }
  if (lane == 0) {
    // No length improved on -inf: (0, 0), as the scan's initial carry.
    const bool found = bv > -CUDART_INF;
    best_i[row] = found ? bi : 0;
    best_l[row] = found ? lengths[bg] : 0;
  }
}

int check_shape(int rows, int n_pad, int n_lengths, int chunks) {
  if (rows < 0 || n_pad < 0 || n_lengths < 0 || chunks < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  if ((n_lengths + chunks - 1) / chunks > MAX_STAGED)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

int wcx_cbs_arc_stage_max(void) { return MAX_STAGED; }

// Per-row max |T| over the window arcs of `lengths` [n_lengths] int32 and
// the wrap arcs up to `kmax`, for `rows` rows of zero-prefixed cumulative
// sums cw, cwx [rows, n_pad + 1] float64 with true sizes n_rows [rows]
// int64, on `stream`: out [rows] float64 (-inf where no arc is valid, NaN
// where a valid arc is).  `partial` is scratch of rows * chunks float64;
// each chunk stages at most wcx_cbs_arc_stage_max() lengths.  Returns the
// CUDA error of the launches (0 on success).
int wcx_cbs_arc_max(const double* cw, const double* cwx, const long long* n_rows,
                    int rows, int n_pad, const int* lengths, int n_lengths,
                    int min_width, int kmax, int chunks, double* partial,
                    double* out, void* stream) {
  int bad = check_shape(rows, n_pad, n_lengths, chunks);
  if (bad) return bad;
  if (kmax < 0 || kmax > MAX_KMAX) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)((n_lengths + chunks - 1) / chunks) * sizeof(int);
  arc_max_kernel<<<dim3(rows, chunks), THREADS, smem, s>>>(
      cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, kmax, chunks,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  arc_max_finish<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      partial, rows, chunks, out);
  return (int)cudaGetLastError();
}

// Per-row (i*, L*) of the max |T| over the window arcs of `lengths`, with
// the JAX scan's tie rule; (0, 0) where no length improves on -inf.  Same
// inputs as wcx_cbs_arc_max without the wrap arcs; scratch part_v float64,
// part_g and part_i int32, each rows * chunks; best_i, best_l [rows] int64.
int wcx_cbs_arc_argmax(const double* cw, const double* cwx,
                       const long long* n_rows, int rows, int n_pad,
                       const int* lengths, int n_lengths, int min_width,
                       int chunks, double* part_v, int* part_g, int* part_i,
                       long long* best_i, long long* best_l, void* stream) {
  int bad = check_shape(rows, n_pad, n_lengths, chunks);
  if (bad) return bad;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)((n_lengths + chunks - 1) / chunks) * sizeof(int);
  arc_argmax_kernel<<<dim3(rows, chunks), THREADS, smem, s>>>(
      cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, chunks, part_v,
      part_g, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  arc_argmax_finish<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      part_v, part_g, part_i, rows, chunks, lengths, best_i, best_l);
  return (int)cudaGetLastError();
}

}  // extern "C"
