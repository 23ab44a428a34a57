// K2: top-k extraction from K1's bucket pool, plus the exactness flag.
//
// Replaces the TPU kernel wisecondorx_tpu/ops/knn_pallas.py::
// _extract_topk_kernel (launched by _finalize) together with the flag
// rule _finalize applies after it.  Per row: the `k` smallest entries of
// the L*M pool in ascending order, equal values ordered by lowest pool
// position; tau = the largest finite kept value; the row is flagged for
// an exact rerun when its smallest dropped value is finite and either
// <= tau, or fewer than k finite values were kept (a bucket overflowed
// while the pool holds fewer than k candidates; the TPU rule misses this
// case, so it is added here and in the plain version).
//
// What bounds it on an H100: shared memory.  A row's pool (L*M values and
// positions, 64 KB at L=2048, M=4) is sorted in one block's shared
// memory, so about three rows fit an SM at a time.
//
// Design.  The TPU extracted the k smallest by k sequential min-reduces
// over the pool (a VPU-friendly loop); on Hopper one block per row sorts
// the whole pool with a shared-memory bitonic network keyed on
// (value, pool position) -- a total order, so the tie rule comes out of the
// sort itself -- and writes the first k.  The flag needs the minimum of
// the row's L drop values and the max/count of the kept finite values,
// both block reductions.  A full sort does more work than a k-select;
// making it cheaper is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ bool after(float ka, int pa, float kb, int pb) {
  return ka > kb || (ka == kb && pa > pb);
}

__global__ void __launch_bounds__(THREADS)
knn_topk_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                const float* __restrict__ drop, int pool, int pool2,
                int lanes, int k, float* __restrict__ out_v,
                int* __restrict__ out_i, unsigned char* __restrict__ flagged) {
  extern __shared__ unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);
  int* pos = reinterpret_cast<int*>(key + pool2);
  __shared__ float red_drop[THREADS / 32];
  __shared__ float red_tau[THREADS / 32];
  __shared__ int red_fin[THREADS / 32];

  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const float* v_row = vals + r * pool;

  for (int e = tid; e < pool2; e += THREADS) {
    key[e] = e < pool ? v_row[e] : INFINITY;
    pos[e] = e;
  }
  __syncthreads();

  for (int size = 2; size <= pool2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < pool2 / 2; t += THREADS) {
        const int lo = (t / stride) * 2 * stride + (t % stride);
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const float kl = key[lo], kh = key[hi];
        const int pl = pos[lo], ph = pos[hi];
        if (after(kl, pl, kh, ph) == ascending) {
          key[lo] = kh;
          key[hi] = kl;
          pos[lo] = ph;
          pos[hi] = pl;
        }
      }
      __syncthreads();
    }
  }

  float tau = -INFINITY;
  int n_fin = 0;
  for (int e = tid; e < k; e += THREADS) {
    const float v = key[e];
    out_v[r * k + e] = v;
    out_i[r * k + e] = idx[r * pool + pos[e]];
    if (isfinite(v)) {
      tau = fmaxf(tau, v);
      ++n_fin;
    }
  }
  float md = INFINITY;
  for (int l = tid; l < lanes; l += THREADS) {
    const float d = drop[r * lanes + l];
    if (d < md || d != d) md = d;  // NaN-propagating minimum
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o_md = __shfl_down_sync(0xffffffffu, md, off);
    if (o_md < md || o_md != o_md) md = o_md;
    tau = fmaxf(tau, __shfl_down_sync(0xffffffffu, tau, off));
    n_fin += __shfl_down_sync(0xffffffffu, n_fin, off);
  }
  if ((tid & 31) == 0) {
    red_drop[tid >> 5] = md;
    red_tau[tid >> 5] = tau;
    red_fin[tid >> 5] = n_fin;
  }
  __syncthreads();
  if (tid == 0) {
    md = red_drop[0];
    tau = red_tau[0];
    n_fin = red_fin[0];
    for (int w = 1; w < THREADS / 32; ++w) {
      if (red_drop[w] < md || red_drop[w] != red_drop[w]) md = red_drop[w];
      tau = fmaxf(tau, red_tau[w]);
      n_fin += red_fin[w];
    }
    flagged[r] = isfinite(md) && (md <= tau || n_fin < k) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream` for `n_rows` rows of a pool of `pool` entries
// (k <= pool).  Shared memory is 8 bytes per entry of the pool rounded
// up to a power of two.  Returns the CUDA error of the launch.
int wcx_knn_topk(const float* vals, const int* idx, const float* drop,
                 int n_rows, int pool, int lanes, int k, float* out_v,
                 int* out_i, unsigned char* flagged, void* stream) {
  if (n_rows <= 0) return 0;
  int pool2 = 1;
  while (pool2 < pool) pool2 <<= 1;
  const size_t smem = (size_t)pool2 * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_topk_kernel<<<n_rows, THREADS, smem, (cudaStream_t)stream>>>(
      vals, idx, drop, pool, pool2, lanes, k, out_v, out_i, flagged);
  return (int)cudaGetLastError();
}

}  // extern "C"
