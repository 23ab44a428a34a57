// K1: fused squared-distance + bucketed top-M scan for the per-bin KNN
// search of newref.
//
// Replaces the TPU kernel wisecondorx_tpu/ops/knn_pallas.py::
// _knn_bucket_kernel (launched by _bucket_scan).  What it computes is the
// same: for every target row r and candidate column g,
//     d = ||t_r||^2 + ||c_g||^2 - 2 t_r . c_g        (full fp32, no TF32)
// set to +inf when g is on r's own chromosome, is padding (g >= n_valid)
// or d >= sentinel; the candidate's own-chromosome-excluded index is
// g - (g >= start(r) ? size(r) : 0).  Column g goes to bucket l = g mod L,
// whose M smallest (value, index) pairs are kept by an M-deep
// compare-swap cascade; what falls out of the bottom folds into the
// bucket's min_drop.  Outputs: vals/idx [R, L*M] (pool position m*L + l)
// and drop [R, L].
//
// What bounds it on an H100: the fp32 FFMA rate of the distance products
// (2*R*N*S flops) and the candidate reads (each row tile streams all N
// candidates).  The cascade costs M compare-swaps per distance.
//
// Design.  The TPU kept a 12 MB accumulator per row tile in VMEM and ran
// the column blocks as a sequential grid axis.  Here the column-block
// axis is a loop inside the block, and a block owns a fixed RT x CT tile
// of (row, bucket) pairs for the whole scan: each column block j maps its
// columns j*L + l onto the same buckets l, so every thread keeps the
// cascades of its TM x TN (row, bucket) pairs in registers from the first
// column block to the last and writes them once.  The inserts are
// therefore contention-free and never touch shared or device memory.
// Distances come from a plain shared-memory tiled fp32 product (KC-deep
// slices of the row and candidate vectors), computed in registers right
// where the cascade consumes them.  Any (L, M) is exact: the wrapper
// reruns every row whose drop certificate fails.  No wgmma, TMA or 3xTF32
// yet: this is the simple, right kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DEPTH = 4;   // M: cascade depth per bucket
constexpr int RT = 32;     // target rows per block
constexpr int CT = 64;     // bucket columns per block
constexpr int KC = 32;     // samples per shared-memory slice
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int TM = RT / TY;  // rows per thread
constexpr int TN = CT / TX;  // bucket columns per thread

__global__ void __launch_bounds__(TX * TY)
knn_bucket_kernel(const float* __restrict__ rows,
                  const float* __restrict__ rnorm,
                  const int* __restrict__ rchr,
                  const int* __restrict__ rstart,
                  const int* __restrict__ rsize, int n_rows,
                  const float* __restrict__ cand,
                  const float* __restrict__ cnorm,
                  const int* __restrict__ cchr, int n_pad, int s_pad,
                  int n_valid, float sentinel, int lanes,
                  float* __restrict__ vals, int* __restrict__ idx,
                  float* __restrict__ drop) {
  __shared__ float As[KC][RT + 1];
  __shared__ float Bs[KC][CT + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int row0 = blockIdx.y * RT;
  const int col0 = blockIdx.x * CT;

  float rn[TM];
  int rc[TM], rs[TM], rz[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    const bool ok = r < n_rows;
    rn[i] = ok ? rnorm[r] : 0.f;
    rc[i] = ok ? rchr[r] : -3;
    rs[i] = ok ? rstart[r] : 0;
    rz[i] = ok ? rsize[r] : 0;
  }

  float cv[TM][TN][DEPTH];
  int ci[TM][TN][DEPTH];
  float dr[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      dr[i][c] = INFINITY;
#pragma unroll
      for (int m = 0; m < DEPTH; ++m) {
        cv[i][c][m] = INFINITY;
        ci[i][c][m] = -1;
      }
    }

  for (int jb = 0; jb < n_pad; jb += lanes) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < s_pad; k0 += KC) {
      for (int e = tid; e < RT * KC; e += TX * TY) {
        const int r = e / KC, k = e % KC;
        const int gr = row0 + r;
        As[k][r] = gr < n_rows ? rows[(size_t)gr * s_pad + k0 + k] : 0.f;
      }
      for (int e = tid; e < CT * KC; e += TX * TY) {
        const int c = e / KC, k = e % KC;
        const size_t g = (size_t)jb + col0 + c;
        Bs[k][c] = cand[g * s_pad + k0 + k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty + TY * i];
#pragma unroll
        for (int c = 0; c < TN; ++c) b[c] = Bs[k][tx + TX * c];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int g = jb + col0 + tx + TX * c;
      const float cn = cnorm[g];
      const int cc = cchr[g];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = (rn[i] + cn) - 2.f * acc[i][c];
        if (rc[i] == cc || g >= n_valid || v >= sentinel) v = INFINITY;
        int ii = g - (g >= rs[i] ? rz[i] : 0);
#pragma unroll
        for (int m = 0; m < DEPTH; ++m) {
          const bool take = v < cv[i][c][m];
          const float tv = cv[i][c][m];
          const int ti = ci[i][c][m];
          cv[i][c][m] = take ? v : tv;
          ci[i][c][m] = take ? ii : ti;
          v = take ? tv : v;
          ii = take ? ti : ii;
        }
        // NaN-propagating minimum, as jnp.minimum / torch.minimum.
        if (v < dr[i][c] || v != v) dr[i][c] = v;
      }
    }
  }

  const size_t pool = (size_t)lanes * DEPTH;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int l = col0 + tx + TX * c;
#pragma unroll
      for (int m = 0; m < DEPTH; ++m) {
        vals[r * pool + (size_t)m * lanes + l] = cv[i][c][m];
        idx[r * pool + (size_t)m * lanes + l] = ci[i][c][m];
      }
      drop[(size_t)r * lanes + l] = dr[i][c];
    }
  }
}

}  // namespace

extern "C" {

int wcx_knn_bucket_depth(void) { return DEPTH; }
int wcx_knn_bucket_col_tile(void) { return CT; }
int wcx_knn_bucket_k_chunk(void) { return KC; }

// Launch K1 on `stream`.  Requires lanes % CT == 0, n_pad % lanes == 0
// and s_pad % KC == 0 (the wrapper checks and pads).  Returns the CUDA
// error of the launch (0 on success).
int wcx_knn_bucket(const float* rows, const float* rnorm, const int* rchr,
                   const int* rstart, const int* rsize, int n_rows,
                   const float* cand, const float* cnorm, const int* cchr,
                   int n_pad, int s_pad, int n_valid, float sentinel,
                   int lanes, float* vals, int* idx, float* drop,
                   void* stream) {
  if (n_rows <= 0) return 0;
  dim3 block(TX, TY);
  dim3 grid(lanes / CT, (n_rows + RT - 1) / RT);
  knn_bucket_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, rnorm, rchr, rstart, rsize, n_rows, cand, cnorm, cchr, n_pad,
      s_pad, n_valid, sentinel, lanes, vals, idx, drop);
  return (int)cudaGetLastError();
}

}  // extern "C"
