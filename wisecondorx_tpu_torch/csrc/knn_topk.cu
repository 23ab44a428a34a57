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
// What bounds it on an H100: device memory.  It must read each row's pool
// values (32 KB at L=2048, M=4) and drops (8 KB), and the k chosen
// indexes, and write k values and indexes: about 45 bytes read per
// arithmetic step, far below the card's ratio of operations to bytes.
//
// Design.  The TPU extracted the k smallest by k sequential min-reduces
// over the pool (a VPU-friendly loop).  Here one block of 256 threads owns
// a row and keeps it in registers (32 entries a thread, read once with
// 16-byte loads), as order-preserving uint32 keys (-0.0 mapped onto +0.0,
// so the two tie as they do in the plain version's comparison sort).  A
// radix select finds the k-th smallest key one bit at a time from the top:
// 32 block-wide counts, each one warp reduction and one barrier, and no
// shared-memory histogram to contend for.  The keys below it are taken,
// and of the keys equal to it the first ones in pool position order (a
// block prefix count), until k are taken; only those k (<= next power of
// two, 4 KB at k=300) go to shared memory, where a bitonic network sorts
// them by (key, pool position) -- a total order, so the tie rule comes out
// of the sort.  Shared memory is a few KB per row instead of the 64 KB a
// full pool sort took, so several rows are resident per SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 32;  // pool entries per thread, held in registers
constexpr int GROUPS = VPT / 4;  // 16-byte loads per thread
constexpr int POOL_MAX = THREADS * VPT;
constexpr unsigned PAD_KEY = 0xFFFFFFFFu;  // above the key of every float

// a < b  <=>  order_key(a) < order_key(b) for non-NaN floats, with -0.0
// and +0.0 equal.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;  // NaN-propagating, as torch.minimum
}

__global__ void __launch_bounds__(THREADS)
knn_topk_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                const float* __restrict__ drop, int pool, int lanes, int k,
                int k2, float* __restrict__ out_v, int* __restrict__ out_i,
                unsigned char* __restrict__ flagged) {
  extern __shared__ unsigned long long sel[];  // k2 (key << 32 | position)
  __shared__ unsigned red[2][WARPS];
  __shared__ unsigned warp_eq[WARPS][GROUPS / 2];
  __shared__ unsigned n_sel;
  __shared__ float red_drop[WARPS];
  __shared__ float red_tau[WARPS];
  __shared__ int red_fin[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t r = blockIdx.x;
  const float4* row4 = reinterpret_cast<const float4*>(vals + r * pool);
  const int n4 = pool >> 2;

  // 1. Keys of the row: pool position 4 * (tid + THREADS * j) + c is
  //    key[4 * j + c]; positions past the pool hold PAD_KEY.
  unsigned key[VPT];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int q = tid + THREADS * j;
    const bool in = q < n4;
    const float4 x = in ? row4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    key[4 * j + 0] = in ? order_key(x.x) : PAD_KEY;
    key[4 * j + 1] = in ? order_key(x.y) : PAD_KEY;
    key[4 * j + 2] = in ? order_key(x.z) : PAD_KEY;
    key[4 * j + 3] = in ? order_key(x.w) : PAD_KEY;
  }
  if (tid == 0) n_sel = 0;

  // 2. The k-th smallest key, one bit at a time from the top: `prefix`
  //    holds the bits decided so far and `need` the rank sought among the
  //    keys that share them.  The buffers of `red` alternate, so one
  //    barrier per bit suffices.
  unsigned prefix = 0u, need = (unsigned)k;
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const unsigned want = prefix >> b;  // bit b of prefix is still 0
    unsigned cnt = 0;
#pragma unroll
    for (int i = 0; i < VPT; ++i) cnt += (key[i] >> b) == want;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) red[b & 1][warp] = cnt;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red[b & 1][w];
    if (total < need) {
      need -= total;
      prefix |= 1u << b;
    }
  }
  const unsigned kth = prefix;  // need >= 1 keys equal to kth are taken

  // 3. Ranks of the keys equal to kth in pool position order: a block
  //    exclusive scan over threads of each group's count, two groups per
  //    word in 16-bit fields (a field's sum is at most 4 * THREADS).
  unsigned own[GROUPS / 2], inc[GROUPS / 2];
#pragma unroll
  for (int q = 0; q < GROUPS / 2; ++q) {
    unsigned e0 = 0, e1 = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e0 += key[8 * q + c] == kth;
      e1 += key[8 * q + 4 + c] == kth;
    }
    own[q] = inc[q] = e0 | (e1 << 16);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < GROUPS / 2; ++q) {
      const unsigned y = __shfl_up_sync(0xffffffffu, inc[q], off);
      if (lane >= off) inc[q] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < GROUPS / 2; ++q) warp_eq[warp][q] = inc[q];
  }
  __syncthreads();
  unsigned before[GROUPS / 2], total[GROUPS / 2];
#pragma unroll
  for (int q = 0; q < GROUPS / 2; ++q) {
    before[q] = total[q] = 0;
    for (int w = 0; w < WARPS; ++w) {
      const unsigned x = warp_eq[w][q];
      total[q] += x;
      if (w < warp) before[q] += x;
    }
  }

  // 4. Take the keys below kth and the first `need` equal to it.
  unsigned take = 0, base = 0;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int sh = (j & 1) * 16;
    const unsigned excl = inc[j >> 1] - own[j >> 1] + before[j >> 1];
    unsigned rank = base + ((excl >> sh) & 0xFFFFu);
    base += (total[j >> 1] >> sh) & 0xFFFFu;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned kk = key[4 * j + c];
      const bool eq = kk == kth;
      if (kk < kth || (eq && rank < need)) take |= 1u << (4 * j + c);
      rank += eq;
    }
  }
  unsigned slot = atomicAdd(&n_sel, (unsigned)__popc(take));
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (take & (1u << i)) {
      const unsigned pos = 4u * (tid + THREADS * (i >> 2)) + (i & 3);
      sel[slot++] = ((unsigned long long)key[i] << 32) | pos;
    }
  }
  for (int e = k + tid; e < k2; e += THREADS) sel[e] = ~0ull;
  __syncthreads();

  // 5. Bitonic sort of the k2 entries by (key, position).
  for (int size = 2; size <= k2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (k2 >> 1); t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = sel[lo], b = sel[hi];
        if ((a > b) == ((lo & size) == 0)) {
          sel[lo] = b;
          sel[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // 6. Write the k entries (the pool's own values and indexes) and the flag.
  const float* v_row = vals + r * pool;
  const int* i_row = idx + r * pool;
  float tau = -INFINITY;
  int n_fin = 0;
  for (int e = tid; e < k; e += THREADS) {
    const unsigned pos = (unsigned)sel[e];
    const float v = v_row[pos];
    out_v[r * k + e] = v;
    out_i[r * k + e] = i_row[pos];
    if (isfinite(v)) {
      tau = fmaxf(tau, v);
      ++n_fin;
    }
  }
  const float4* drop4 = reinterpret_cast<const float4*>(drop + r * lanes);
  float md = INFINITY;
  for (int q = tid; q < (lanes >> 2); q += THREADS) {
    const float4 d = drop4[q];
    md = nan_min(nan_min(md, d.x), nan_min(nan_min(d.y, d.z), d.w));
  }
  for (int off = 16; off > 0; off >>= 1) {
    md = nan_min(md, __shfl_down_sync(0xffffffffu, md, off));
    tau = fmaxf(tau, __shfl_down_sync(0xffffffffu, tau, off));
    n_fin += __shfl_down_sync(0xffffffffu, n_fin, off);
  }
  if (lane == 0) {
    red_drop[warp] = md;
    red_tau[warp] = tau;
    red_fin[warp] = n_fin;
  }
  __syncthreads();
  if (tid == 0) {
    md = red_drop[0];
    tau = red_tau[0];
    n_fin = red_fin[0];
    for (int w = 1; w < WARPS; ++w) {
      md = nan_min(md, red_drop[w]);
      tau = fmaxf(tau, red_tau[w]);
      n_fin += red_fin[w];
    }
    flagged[r] = isfinite(md) && (md <= tau || n_fin < k) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int wcx_knn_topk_pool_max(void) { return POOL_MAX; }

// Launch K2 on `stream` for `n_rows` rows of a pool of `pool` entries.
// Requires 1 <= k <= pool <= POOL_MAX, pool % 4 == 0, lanes % 4 == 0 and
// 16-byte aligned vals and drop (the wrapper checks).  Returns the CUDA
// error of the launch (0 on success).
int wcx_knn_topk(const float* vals, const int* idx, const float* drop,
                 int n_rows, int pool, int lanes, int k, float* out_v,
                 int* out_i, unsigned char* flagged, void* stream) {
  if (n_rows <= 0) return 0;
  if (k < 1 || k > pool || pool > POOL_MAX || pool % 4 || lanes % 4)
    return (int)cudaErrorInvalidValue;
  int k2 = 1;
  while (k2 < k) k2 <<= 1;
  const size_t smem = (size_t)k2 * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_topk_kernel<<<n_rows, THREADS, smem, (cudaStream_t)stream>>>(
      vals, idx, drop, pool, lanes, k, k2, out_v, out_i, flagged);
  return (int)cudaGetLastError();
}

}  // extern "C"
