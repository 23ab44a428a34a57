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
// locate_rows_reference in wisecondorx_tpu_torch/ops/cbs.py; the screen
// below is arc_screen_reference there.
//
// For the window arc (i, i + L] of a row of true size n, with the
// zero-prefixed cumulative sums cw, cwx of its weights and weighted values
// and the totals W = cw[n], X = cwx[n]:
//   w1 = cw[i+L] - cw[i], x1 = cwx[i+L] - cwx[i], w0 = W - w1,
//   x0 = X - x1, |T| = |(x1/w1 - x0/w0) * rsqrt(1/w1 + 1/w0)|,
// valid iff i + L <= n and min_width <= L <= n - min_width.  A wrap arc is
// a suffix of s slots plus a prefix of p (s, p >= 1, s + p <= kmax,
// min_width <= s + p <= n - min_width, s < n): w1 = (W - cw[n-s]) + cw[p],
// and x1 likewise.  abs_t does every operation of the plain version, in
// its order, with IEEE rounding (__ddiv_rn, __dsub_rn, __dadd_rn,
// __dmul_rn: never contracted into an FMA) and CUDA's rsqrt(double), which
// ATen's rsqrt calls too, so the maxima equal the plain version's on the
// card bit for bit.
//
// NaN: torch.amax and torch.maximum propagate NaN; CUDA's fmax does not,
// so it is not used.  A row with one NaN valid arc has a NaN maximum.  In
// the argmax a length with one NaN valid arc never improves the best
// (jnp.max of that length is NaN, and NaN > best is false): it drops out
// whole.
//
// What bounds it on an H100: FP64 instructions.  abs_t is four IEEE
// divisions and an rsqrt, about 40 FP64-pipe instructions, and a row's
// maximum is decided by a handful of its arcs.  So every arc first goes
// through a screen of 8 FP64 operations without a division, and only the
// arcs the screen cannot rule out take abs_t.
//
// The screen.  Algebraically |T|^2 = N^2 / D with N = x1 w0 - x0 w1 and
// D = w1 w0 (w1 + w0); N = x1 W - X w1 = A(i + L) - A(i) with A(j) =
// cwx[j] W - X cw[j].  Against a threshold m, the exact value of an arc
// already taken, the window arc (i, e = i + L] is skipped iff
//   lhs = fl(t1 * t1) < rhs = fl(fl(w1 * w0) * Q),
//   t1 = fl(|num| + F), num = fl(a[e] - a[i]),
//   a[j] = fl(fl(cwx[j] * W) - fl(X * cw[j])),
//   Q = fl(W * fl(fl(m * m) * SHRINK)), SHRINK = 1 - 2^-36,
//   F = max(fl(fl(Xmax * Wmax) * 2^-44), 2^-100),
// with Xmax = max_j<=n |cwx[j]|, Wmax = max_j<=n |cw[j]|, and w1 =
// fl(cw[e] - cw[i]), w0 = fl(W - w1) exactly as abs_t gets them, all with
// the IEEE intrinsics, so that arc_screen_reference computes the same bits
// on the CPU.  Q is 0 (nothing is skipped) unless the row passes its
// guard, Xmax <= 2^100, Wmax <= 2^100 and W >= 2^-100 (so NaN and
// infinite sums never pass), and 2^-200 <= m <= 2^200.  Claim: a skipped
// arc's abs_t is finite and strictly below m.  With u = 2^-53:
//  1. lhs >= fl(F^2) >= 2^-200, so rhs > 2^-200 and Q > 0: the guards hold
//     and p = fl(w1 w0) > 0, so w1, w0 are nonzero and of one sign; w0 =
//     fl(W - w1) with W > 0 rules out w1 < 0, so 0 < w1 < W <= 2^100 and
//     0 < w0 <= W.  rhs <= p Q (1 + u) and Q <= 2^500 give p > 2^-701,
//     so w1, w0 > 2^-801, and every product on both sides is normal.
//  2. |x1|, |x0| <= 2^102, so abs_t's quotients stay below 2^903 and its
//     reciprocals below 2^801: no overflow, no 0/0, no inf - inf; abs_t
//     is finite.  Its seven roundings (rsqrt within 2 ulp) give
//     abs_t <= (1 + 8u) (|N| + u A) / sqrt(D) + 2^-700, A = |x1| w0 +
//     |x0| w1, the last term for quotients that fall below 2^-1022.
//  3. The absolute floor: the roundings of x1, w1, w0 and x0 move N from
//     xi W - X omega (xi, omega the exact differences of the sums) by at
//     most 9u Xmax Wmax; each a[j] is within 4.2u Xmax Wmax of A(j); and
//     A <= 6.1 Xmax Wmax.  So |N| + u A <= (1 + u) (|num| + 24u Xmax
//     Wmax), and F >= 2^-44 Xmax Wmax (1 - u)^2 covers the 24u many times
//     over (and the rounding of products below 2^-1022); so |N| + u A <=
//     (1 + 3u) t1, and t1 <= sqrt(lhs / (1 - u)).
//  4. The relative term: rhs <= D m^2 SHRINK (1 + u)^5 / (1 - u), since
//     W <= (w1 + w0) / (1 - u); so lhs < rhs gives
//     abs_t < m sqrt(SHRINK) (1 + 16u) + 2^-700 < m (1 - 2^-37 + 16u) +
//     2^-700 < m, as m >= 2^-200.
// So an arc equal to m is never skipped, a skipped arc is never NaN, and
// the maximum (and each block's argmax candidate) is the exact value of a
// real arc, bit-equal to the plain version's.  Near-flat rows, where every
// |T| is rounding noise, pass the floor F and take abs_t.
//
// Design.  One block of 256 threads per (row, chunk).  A chunk is a
// contiguous run of the lengths array holding about 1 / chunks of the
// row's arcs (chunk_range: a block scan of per-length arc counts, read on
// the card from the row's own size), so every length lies in one block
// and blocks cost about the same.  When 2 (n_pad + 1) float64 fit in
// STAGE_BYTES_MAX, the block stages the row in shared memory with
// cp.async as (cw[j], a[j]) pairs, one 16-byte load an arc; otherwise it
// reads cw and cwx through L1/L2 and computes a[j] on the way (the grid
// runs a row's chunks next to each other, so few rows are in flight).
// Warp w owns the start runs [128 w + 1024 k, + 128); a lane keeps cw[i],
// a[i] of four starts (32 apart) in registers and screens them against
// eight lengths of the chunk at a time, 32 arcs without a branch into a
// bit mask, then votes once (sorted lengths stop at the first step that no
// start reaches; a step whose 32 arcs are all valid skips the per-arc
// checks).  Arcs that pass go to a per-warp queue in shared
// memory, and the warp takes abs_t of 32 queued arcs at a time, all lanes
// busy, reading the sums from global memory.  The screen's m is the
// larger of the lane's own best and the block's, kept in shared memory
// (atomicMax on the bits of a non-negative double), read again after
// every queue flush and every tile; every block seeds it first with one
// exact arc per thread of its first length (and the max kernel's chunk 0
// with the wrap arcs).  Max: a NaN flag and running max per lane, one
// block reduction to a partial per chunk.  Argmax: each lane keeps the
// best (value, g, i) of its exact arcs (a larger value, then the earlier
// length, then the smaller start: the JAX rule as one argmax); a block
// that met a NaN arc scans its chunk again length by length with no
// screen, dropping NaN lengths whole.  A finishing kernel reduces each
// row's chunks in both.  An optional counter receives the number of arcs
// that took abs_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_KMAX = 4096;
constexpr int MAX_DEVICES = 64;
// Per-warp queue of arcs waiting for abs_t: at most 31 left over plus 32
// new.
constexpr int QUEUE = 64;
// A warp step screens STARTS starts per lane, 32 apart, against BATCH
// lengths: 32 arcs per lane between two votes.
constexpr int STARTS = 4;
constexpr int BATCH = 8;
static_assert(STARTS * BATCH == 32, "one bit per arc of a step");
// Dynamic shared memory a block may stage a row's sums in (n_pad + 1 <=
// 13,824), beside its static shared memory, under the 227 KB a block may
// have.
constexpr int STAGE_BYTES_MAX = 216 * 1024;

// The screen's constants (see the header).
constexpr double W_LO = 0x1p-100, W_HI = 0x1p100, X_HI = 0x1p100;
constexpr double M_LO = 0x1p-200, M_HI = 0x1p200;
constexpr double SHRINK = 1.0 - 0x1p-36;
constexpr double FLOOR_K = 0x1p-44, F_MIN = 0x1p-100;

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

__device__ __forceinline__ long long arcs_of(int L, int n, int min_width) {
  return (L >= min_width && L <= n - min_width) ? (long long)(n - L + 1) : 0;
}

// (v, g, i) beats (bv, bg, bi): a larger value, then an earlier length,
// then a smaller start.
__device__ __forceinline__ bool beats(double v, int g, int i, double bv,
                                      int bg, int bi) {
  return v > bv || (v == bv && (g < bg || (g == bg && i < bi)));
}

struct Smem {
  int q_g[WARPS][QUEUE], q_i[WARPS][QUEUE];  // the warps' queues
  long long warp_arcs[WARPS];
  double red_v[WARPS], red_w[WARPS];
  int red_g[WARPS], red_i[WARPS];
  unsigned long long red_n[WARPS];
  unsigned long long best_bits;  // the block's best |T| so far (>= +0.0)
  int bounds[2];
  bool sorted;
};

// A row as a block sees it: its sums, size, totals, the chunk's lengths
// [g0, g1) and the screen's row terms.
struct Row {
  const double* c;    // the row's sums in global memory
  const double* cx;
  const double2* ca;  // staged (cw[j], a[j]) pairs (see screen_a), or null
  int n, g0, g1;
  double W, X, F;
  bool screen;
  bool sorted;  // the lengths array ascends
};

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The chunk's lengths [g0, g1): the lengths array cut into `chunks`
// contiguous runs of about equal arc counts for a row of size n.  Chunk c
// starts at the first g whose preceding lengths hold total * c / chunks
// arcs, so every length with an arc lies in exactly one chunk.
__device__ void chunk_range(const int* __restrict__ lengths, int n_lengths,
                            int n, int min_width, int chunk, int chunks,
                            Smem& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n_lengths + THREADS - 1) / THREADS;
  const int s = min((int)threadIdx.x * per, n_lengths);
  const int e = min(s + per, n_lengths);
  long long sum = 0;
  bool up = true;
  for (int j = s; j < e; ++j) {
    sum += arcs_of(lengths[j], n, min_width);
    if (j + 1 < n_lengths && lengths[j + 1] < lengths[j]) up = false;
  }
  sh.sorted = __syncthreads_and(up);
  long long inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) sh.warp_arcs[warp] = inc;
  __syncthreads();
  long long before = inc - sum, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before += sh.warp_arcs[w];
    total += sh.warp_arcs[w];
  }
  const long long lo = total * chunk / chunks;
  const long long hi = total * (chunk + 1) / chunks;
  if (threadIdx.x == 0) {
    sh.bounds[0] = 0;
    sh.bounds[1] = 0;  // hi == 0: an empty chunk
  }
  __syncthreads();
  long long p = before;
  for (int j = s; j < e; ++j) {
    const long long next = p + arcs_of(lengths[j], n, min_width);
    if (p < lo && lo <= next) sh.bounds[0] = j + 1;
    if (p < hi && hi <= next) sh.bounds[1] = j + 1;
    p = next;
  }
  __syncthreads();
}

// The screen's position term a(j) = fl(fl(cwx[j] * W) - fl(X * cw[j])).
__device__ __forceinline__ double screen_a(double c, double cx, double W,
                                          double X) {
  return __dsub_rn(__dmul_rn(cx, W), __dmul_rn(X, c));
}

// Stages the row (when STAGED: (cw[j], a[j]) pairs), finds the chunk's
// lengths and the screen's row terms.  Every thread of the block returns
// the same Row.
template <bool STAGED>
__device__ __forceinline__ Row setup_row(const double* __restrict__ cw,
                                         const double* __restrict__ cwx,
                                         const long long* __restrict__ n_rows,
                                         int n_pad,
                                         const int* __restrict__ lengths,
                                         int n_lengths, int min_width, int row,
                                         int chunk, int chunks, double* s_row,
                                         Smem& sh) {
  const size_t stride = (size_t)n_pad + 1;
  Row r;
  r.c = cw + row * stride;
  r.cx = cwx + row * stride;
  r.ca = nullptr;
  r.n = row_size(n_rows, row, n_pad);
  double2* s = reinterpret_cast<double2*>(s_row);
  if (STAGED) {
    for (int j = threadIdx.x; j <= r.n; j += THREADS) {
      cp_async8(&s[j].x, r.c + j);
      cp_async8(&s[j].y, r.cx + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    r.ca = s;
  }
  if (threadIdx.x == 0) sh.best_bits = 0ull;
  chunk_range(lengths, n_lengths, r.n, min_width, chunk, chunks, sh);
  r.g0 = sh.bounds[0];
  r.g1 = sh.bounds[1];
  r.sorted = sh.sorted;
  if (STAGED) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  // Xmax = max |cwx[j]| and Wmax = max |cw[j]|, j <= n; a NaN or too
  // large sum fails the guard.
  double xm = 0.0, wm = 0.0;
  bool bad = false;
  for (int j = threadIdx.x; j <= r.n; j += THREADS) {
    const double a = fabs(STAGED ? s[j].y : r.cx[j]);
    const double b = fabs(STAGED ? s[j].x : r.c[j]);
    if (!(a <= X_HI) || !(b <= W_HI)) {
      bad = true;
    } else {
      if (a > xm) xm = a;
      if (b > wm) wm = b;
    }
  }
  bad = __syncthreads_or(bad);
  for (int o = 16; o; o >>= 1) {
    const double v = __shfl_xor_sync(FULL, xm, o);
    const double u = __shfl_xor_sync(FULL, wm, o);
    if (v > xm) xm = v;
    if (u > wm) wm = u;
  }
  if ((threadIdx.x & 31) == 0) {
    sh.red_v[threadIdx.x >> 5] = xm;
    sh.red_w[threadIdx.x >> 5] = wm;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    if (sh.red_v[w] > xm) xm = sh.red_v[w];
    if (sh.red_w[w] > wm) wm = sh.red_w[w];
  }
  r.W = r.c[r.n];
  r.X = r.cx[r.n];
  r.screen = !bad && r.W >= W_LO;
  const double f = __dmul_rn(__dmul_rn(xm, wm), FLOOR_K);
  r.F = f > F_MIN ? f : F_MIN;
  if (STAGED) {  // cwx[j] -> a[j] in place
    for (int j = threadIdx.x; j <= r.n; j += THREADS)
      s[j].y = screen_a(s[j].x, s[j].y, r.W, r.X);
  }
  __syncthreads();  // red_v is reused by the reductions; a[] is complete
  return r;
}

// The screen's Q for threshold m: 0 (nothing skipped) outside the guards.
__device__ __forceinline__ double screen_q(double m, const Row& r) {
  return (r.screen && m >= M_LO && m <= M_HI)
             ? __dmul_rn(r.W, __dmul_rn(__dmul_rn(m, m), SHRINK))
             : 0.0;
}

// Whether the arc with w1 = fl(cw[e] - cw[i]) and num = fl(a[e] - a[i])
// is proved below the threshold of q.
__device__ __forceinline__ bool screened_out(double w1, double num,
                                             const Row& r, double q) {
  const double w0 = __dsub_rn(r.W, w1);
  const double t1 = __dadd_rn(fabs(num), r.F);
  return __dmul_rn(t1, t1) < __dmul_rn(__dmul_rn(w1, w0), q);
}

// (cw[j], a[j]) of the row: staged, or read and computed.
template <bool STAGED>
__device__ __forceinline__ void load_ca(const Row& r, int j, double& c,
                                        double& a) {
  if (STAGED) {
    const double2 v = r.ca[j];
    c = v.x;
    a = v.y;
  } else {
    c = r.c[j];
    a = screen_a(c, r.cx[j], r.W, r.X);
  }
}

__device__ __forceinline__ double window_t(const Row& r, int i, int L) {
  const double w1 = __dsub_rn(r.c[i + L], r.c[i]);
  const double x1 = __dsub_rn(r.cx[i + L], r.cx[i]);
  return abs_t(w1, x1, __dsub_rn(r.W, w1), __dsub_rn(r.X, x1));
}

// The threshold the lane screens with: its own best and the block's
// (publishing its own when that is larger than what it published).
union Bits {
  unsigned long long u;
  double d;
};

__device__ __forceinline__ double block_best(double own, double& published,
                                             Smem& sh) {
  if (own > published) {
    Bits b;
    b.d = own;
    atomicMax(&sh.best_bits, b.u);
    published = own;
  }
  Bits b;
  b.u = *(volatile unsigned long long*)&sh.best_bits;
  return b.d > own ? b.d : own;
}

// The running max of the max kernel.
struct MaxVisit {
  const Row& r;
  const int* lengths;
  double m;
  bool nan;
  unsigned long long exact;
  __device__ void take(double t) {
    ++exact;
    if (t != t) nan = true;
    else if (t > m) m = t;
  }
  __device__ void visit(int g, int i) { take(window_t(r, i, lengths[g])); }
  __device__ double best() const { return m; }
};

// The best (value, g, i) of the argmax kernel.
struct ArgmaxVisit {
  const Row& r;
  const int* lengths;
  double bv;
  int bg, bi;
  bool nan;
  unsigned long long exact;
  __device__ void visit(int g, int i) {
    const double t = window_t(r, i, lengths[g]);
    ++exact;
    if (t != t) {
      nan = true;
    } else if (beats(t, g, i, bv, bg, bi)) {
      bv = t;
      bg = g;
      bi = i;
    }
  }
  __device__ double best() const { return bv; }
};

// Seeds the screen: each thread takes one arc of the chunk's first valid
// length exactly (starts spread over the row), the block publishes its
// best and every thread starts from it.  Returns the starting Q.
template <class Visit>
__device__ __forceinline__ double seed_screen(const Row& r,
                                              const int* __restrict__ lengths,
                                              int min_width, double& published,
                                              Smem& sh, Visit& v) {
  const int n = r.n;
  int g = r.g0;
  while (g < r.g1 && (lengths[g] < min_width || lengths[g] > n - min_width)) ++g;
  if (g < r.g1) {
    const int span = n - lengths[g] + 1;
    v.visit(g, (int)((long long)threadIdx.x * span / THREADS));
  }
  block_best(v.best(), published, sh);
  __syncthreads();
  return screen_q(block_best(v.best(), published, sh), r);
}

// One step of scan_windows: the lane's STARTS starts against the BATCH
// lengths len[] (INT_MAX past the chunk), one bit per arc the screen does
// not rule out.  CHECKED clamps each end into the row and drops the
// arcs that are not valid; otherwise every arc is valid.
template <bool STAGED, bool CHECKED>
__device__ __forceinline__ unsigned screen_step(const Row& r, const int* len,
                                                int base, int lane,
                                                const double* ci,
                                                const double* ai,
                                                int min_width, int reach,
                                                double q) {
  const int n = r.n;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const bool ok = !CHECKED || (len[j] >= min_width &&
                                 len[j] <= n - min_width && len[j] <= reach);
    const int L = ok ? len[j] : 0;
#pragma unroll
    for (int k = 0; k < STARTS; ++k) {
      const int i = base + lane + 32 * k;
      const int e = CHECKED ? min(i + L, n) : i + L;
      double ce, ae;
      load_ca<STAGED>(r, e, ce, ae);
      const bool out = screened_out(__dsub_rn(ce, ci[k]), __dsub_rn(ae, ai[k]), r, q);
      const bool pass = CHECKED ? ok & (i + L <= n) & !out : !out;
      if (pass) bits |= 1u << (j * STARTS + k);
    }
  }
  return bits;
}

// Every window arc of the chunk: screened, the rest through abs_t in
// batches of 32 per warp (Visit::visit).  q is the screen's starting Q.
// A warp step takes STARTS starts per lane (32 apart) and BATCH lengths,
// screens those STARTS * BATCH = 32 arcs per lane without a branch into a
// bit mask, and votes once; only a step where some arc passed walks the
// bits.  With sorted lengths the walk over lengths stops at the first
// step whose last length no start reaches.
template <bool STAGED, class Visit>
__device__ __forceinline__ void scan_windows(const Row& r,
                                             const int* __restrict__ lengths,
                                             int min_width, double q,
                                             double& published, Smem& sh,
                                             Visit& v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* q_g = sh.q_g[warp];
  int* q_i = sh.q_i[warp];
  const int n = r.n;
  int qn = 0;  // the same in every lane
  for (int base = warp * 32 * STARTS; base <= n - min_width;
       base += THREADS * STARTS) {
    const int reach = n - base;  // no start of the step takes a longer length
    double ci[STARTS], ai[STARTS];
#pragma unroll
    for (int k = 0; k < STARTS; ++k)
      load_ca<STAGED>(r, min(base + lane + 32 * k, n), ci[k], ai[k]);
    for (int g = r.g0; g < r.g1; g += BATCH) {
      int len[BATCH];
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        len[j] = g + j < r.g1 ? lengths[g + j] : INT_MAX;
        lo = min(lo, len[j]);
        hi = max(hi, len[j]);
      }
      // Every arc of the step valid: no clamp and no check per arc.
      const bool whole = lo >= min_width && hi <= n - min_width &&
                         hi <= reach - (32 * STARTS - 1);
      const unsigned bits =
          whole ? screen_step<STAGED, false>(r, len, base, lane, ci, ai,
                                             min_width, reach, q)
                : screen_step<STAGED, true>(r, len, base, lane, ci, ai,
                                            min_width, reach, q);
      const int last = g + BATCH <= r.g1 ? len[BATCH - 1] : hi;
      if (__any_sync(FULL, bits)) {
        for (int b = 0; b < BATCH * STARTS; ++b) {
          const bool pass = (bits >> b) & 1u;
          const unsigned mask = __ballot_sync(FULL, pass);
          if (!mask) continue;
          if (pass) {
            const int at = qn + __popc(mask & below);
            q_g[at] = g + b / STARTS;
            q_i[at] = base + lane + 32 * (b % STARTS);
          }
          qn += __popc(mask);
          if (qn >= 32) {
            __syncwarp();
            v.visit(q_g[lane], q_i[lane]);
            const bool rest = lane + 32 < qn;
            const int rg = rest ? q_g[lane + 32] : 0;
            const int ri = rest ? q_i[lane + 32] : 0;
            __syncwarp();
            if (rest) {
              q_g[lane] = rg;
              q_i[lane] = ri;
            }
            __syncwarp();
            qn -= 32;
            q = screen_q(block_best(v.best(), published, sh), r);
          }
        }
      }
      if (r.sorted && last > reach) break;
    }
    q = screen_q(block_best(v.best(), published, sh), r);
  }
  __syncwarp();
  if (lane < qn) v.visit(q_g[lane], q_i[lane]);
}

// Adds the block's abs_t count to *exact_arcs (when it is not null).
__device__ void count_exact(unsigned long long mine,
                            unsigned long long* exact_arcs, Smem& sh) {
  if (!exact_arcs) return;
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if ((threadIdx.x & 31) == 0) sh.red_n[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += sh.red_n[w];
    atomicAdd(exact_arcs, total);
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 2)
arc_max_kernel(const double* __restrict__ cw, const double* __restrict__ cwx,
               const long long* __restrict__ n_rows, int n_pad,
               const int* __restrict__ lengths, int n_lengths, int min_width,
               int kmax, int chunks, double* __restrict__ partial,
               unsigned long long* exact_arcs) {
  extern __shared__ double s_row[];
  __shared__ Smem sh;
  const int row = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Row r = setup_row<STAGED>(cw, cwx, n_rows, n_pad, lengths, n_lengths,
                                  min_width, row, chunk, chunks, s_row, sh);
  MaxVisit v{r, lengths, -CUDART_INF, false, 0};
  double published = 0.0;
  if (chunk == 0) {  // the wrap arcs, exactly; they seed the screen too
    const int n = r.n;
    for (int k = threadIdx.x; k < kmax * kmax; k += THREADS) {
      const int s = k / kmax + 1, p = k % kmax + 1, len = s + p;
      if (len > kmax || len < min_width || len > n - min_width || s >= n)
        continue;
      const double w1 = __dadd_rn(__dsub_rn(r.W, r.c[n - s]), r.c[p]);
      const double x1 = __dadd_rn(__dsub_rn(r.X, r.cx[n - s]), r.cx[p]);
      v.take(abs_t(w1, x1, __dsub_rn(r.W, w1), __dsub_rn(r.X, x1)));
    }
  }
  const double q = seed_screen(r, lengths, min_width, published, sh, v);
  scan_windows<STAGED>(r, lengths, min_width, q, published, sh, v);

  double m = v.m;
  const bool nan = __syncthreads_or(v.nan);
  for (int o = 16; o; o >>= 1) {
    const double om = __shfl_xor_sync(FULL, m, o);
    if (om > m) m = om;
  }
  if (lane == 0) sh.red_v[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w)
      if (sh.red_v[w] > m) m = sh.red_v[w];
    partial[(size_t)row * chunks + chunk] = nan ? CUDART_NAN : m;
  }
  count_exact(v.exact, exact_arcs, sh);
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

// The block's best (value, g, i) into sh.red_* [0] (every thread calls).
__device__ void reduce_best(double& bv, int& bg, int& bi, Smem& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, bv, o);
    const int og = __shfl_xor_sync(FULL, bg, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats(ov, og, oi, bv, bg, bi)) {
      bv = ov;
      bg = og;
      bi = oi;
    }
  }
  if (lane == 0) {
    sh.red_v[warp] = bv;
    sh.red_g[warp] = bg;
    sh.red_i[warp] = bi;
  }
  __syncthreads();
  bv = sh.red_v[0];
  bg = sh.red_g[0];
  bi = sh.red_i[0];
  for (int w = 1; w < WARPS; ++w) {
    if (beats(sh.red_v[w], sh.red_g[w], sh.red_i[w], bv, bg, bi)) {
      bv = sh.red_v[w];
      bg = sh.red_g[w];
      bi = sh.red_i[w];
    }
  }
  __syncthreads();
}

// The chunk's lengths in order, every arc through abs_t: per length the
// max, its smallest start and whether any arc is NaN; a length replaces
// the best only on a strict improvement and only without a NaN arc.  For
// blocks that met a NaN arc.
__device__ void scan_lengths_exactly(const Row& r,
                                     const int* __restrict__ lengths,
                                     int min_width, ArgmaxVisit& v,
                                     Smem& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = r.n;
  v.bv = -CUDART_INF;
  v.bg = INT_MAX;
  v.bi = 0;
  for (int g = r.g0; g < r.g1; ++g) {
    const int L = lengths[g];
    if (L < min_width || L > n - min_width) continue;  // the same for all
    double m = -CUDART_INF;
    int mi = INT_MAX;
    bool nan = false;
    for (int i = threadIdx.x; i + L <= n; i += THREADS) {
      const double t = window_t(r, i, L);
      ++v.exact;
      if (t != t) nan = true;
      else if (t > m) {  // strict: a thread meets its starts in increasing i
        m = t;
        mi = i;
      }
    }
    nan = __syncthreads_or(nan);
    for (int o = 16; o; o >>= 1) {
      const double om = __shfl_xor_sync(FULL, m, o);
      const int oi = __shfl_xor_sync(FULL, mi, o);
      if (om > m || (om == m && oi < mi)) {
        m = om;
        mi = oi;
      }
    }
    if (lane == 0) {
      sh.red_v[warp] = m;
      sh.red_i[warp] = mi;
    }
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) {
      if (sh.red_v[w] > m || (sh.red_v[w] == m && sh.red_i[w] < mi)) {
        m = sh.red_v[w];
        mi = sh.red_i[w];
      }
    }
    if (!nan && m > v.bv) {
      v.bv = m;
      v.bg = g;
      v.bi = mi;
    }
    __syncthreads();
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 2)
arc_argmax_kernel(const double* __restrict__ cw,
                  const double* __restrict__ cwx,
                  const long long* __restrict__ n_rows, int n_pad,
                  const int* __restrict__ lengths, int n_lengths,
                  int min_width, int chunks, double* __restrict__ part_v,
                  int* __restrict__ part_g, int* __restrict__ part_i,
                  unsigned long long* exact_arcs) {
  extern __shared__ double s_row[];
  __shared__ Smem sh;
  const int row = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const Row r = setup_row<STAGED>(cw, cwx, n_rows, n_pad, lengths, n_lengths,
                                  min_width, row, chunk, chunks, s_row, sh);
  ArgmaxVisit v{r, lengths, -CUDART_INF, INT_MAX, 0, false, 0};
  double published = 0.0;
  const double q = seed_screen(r, lengths, min_width, published, sh, v);
  scan_windows<STAGED>(r, lengths, min_width, q, published, sh, v);
  if (__syncthreads_or(v.nan)) {
    scan_lengths_exactly(r, lengths, min_width, v, sh);
  } else {
    reduce_best(v.bv, v.bg, v.bi, sh);
  }
  if (threadIdx.x == 0) {
    const size_t k = (size_t)row * chunks + chunk;
    part_v[k] = v.bv;
    part_g[k] = v.bg;
    part_i[k] = v.bi;
  }
  count_exact(v.exact, exact_arcs, sh);
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
    if (beats(part_v[p], part_g[p], part_i[p], bv, bg, bi)) {
      bv = part_v[p];
      bg = part_g[p];
      bi = part_i[p];
    }
  }
  for (int o = 16; o; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, bv, o);
    const int og = __shfl_xor_sync(FULL, bg, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats(ov, og, oi, bv, bg, bi)) {
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
  if (rows < 0 || n_pad < 0 || n_lengths < 0 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)rows * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  return 0;
}

// Dynamic shared memory of a launch: the row's two sums when they fit.
size_t stage_bytes(int n_pad) {
  const size_t bytes = 2 * ((size_t)n_pad + 1) * sizeof(double);
  return bytes <= (size_t)STAGE_BYTES_MAX ? bytes : 0;
}

// Lets the staged kernels take STAGE_BYTES_MAX of dynamic shared memory,
// once per device.
int opt_in(const void* kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_BYTES_MAX);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

bool max_opted[MAX_DEVICES], argmax_opted[MAX_DEVICES];

}  // namespace

extern "C" {

int wcx_cbs_arc_stage_bytes(void) { return STAGE_BYTES_MAX; }

// Per-row max |T| over the window arcs of `lengths` [n_lengths] int32 and
// the wrap arcs up to `kmax`, for `rows` rows of zero-prefixed cumulative
// sums cw, cwx [rows, n_pad + 1] float64 with true sizes n_rows [rows]
// int64, on `stream`: out [rows] float64 (-inf where no arc is valid, NaN
// where a valid arc is).  `partial` is scratch of rows * chunks float64.
// The rows are staged in shared memory when 2 (n_pad + 1) float64 fit in
// wcx_cbs_arc_stage_bytes().  When `exact_arcs` is not null, the number
// of arcs that took the exact formula is added to it.  Returns the CUDA
// error of the launches (0 on success).
int wcx_cbs_arc_max(const double* cw, const double* cwx, const long long* n_rows,
                    int rows, int n_pad, const int* lengths, int n_lengths,
                    int min_width, int kmax, int chunks, double* partial,
                    double* out, unsigned long long* exact_arcs, void* stream) {
  int bad = check_shape(rows, n_pad, n_lengths, chunks);
  if (bad) return bad;
  if (kmax < 0 || kmax > MAX_KMAX) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = stage_bytes(n_pad);
  if (smem) {
    bad = opt_in((const void*)arc_max_kernel<true>, max_opted);
    if (bad) return bad;
    arc_max_kernel<true><<<rows * chunks, THREADS, smem, s>>>(
        cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, kmax, chunks,
        partial, exact_arcs);
  } else {
    arc_max_kernel<false><<<rows * chunks, THREADS, 0, s>>>(
        cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, kmax, chunks,
        partial, exact_arcs);
  }
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
                       long long* best_i, long long* best_l,
                       unsigned long long* exact_arcs, void* stream) {
  int bad = check_shape(rows, n_pad, n_lengths, chunks);
  if (bad) return bad;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = stage_bytes(n_pad);
  if (smem) {
    bad = opt_in((const void*)arc_argmax_kernel<true>, argmax_opted);
    if (bad) return bad;
    arc_argmax_kernel<true><<<rows * chunks, THREADS, smem, s>>>(
        cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, chunks, part_v,
        part_g, part_i, exact_arcs);
  } else {
    arc_argmax_kernel<false><<<rows * chunks, THREADS, 0, s>>>(
        cw, cwx, n_rows, n_pad, lengths, n_lengths, min_width, chunks, part_v,
        part_g, part_i, exact_arcs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  arc_argmax_finish<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      part_v, part_g, part_i, rows, chunks, lengths, best_i, best_l);
  return (int)cudaGetLastError();
}

}  // extern "C"
