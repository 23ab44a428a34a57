// The sort keys of a CBS permutation round: per row, the row's key folded
// from the base key and its four words (content salt, lo, hi, draw index),
// then per slot i the Threefry-2x32 block of (0, i) under that key,
// x0 ^ x1 & 0x7FFFFFFF on the row's real slots and 0x80000000 | i on its
// padding, written as int64 [rows, n_pad].
//
// Replaces the key generation of the XLA program
// wisecondorx_tpu/ops/cbs.py::_perm_round_device (:346): row_bits (:377),
// jax.random.fold_in four times and jax.random.bits, vmapped over the rows.
// The plain PyTorch version is perm_keys_reference in
// wisecondorx_tpu_torch/ops/cbs.py (about 120 int64 torch operations over
// [rows, n_pad]).  These are uint32 operations, so the keys are bit-equal
// to the plain version's and so to jax.random's.
//
// What bounds it on an H100: 32-bit integer operations.  A real slot
// costs one Threefry block (77 additions, rotations and xors; a rotation
// is one funnel shift) and writes 8 bytes: about 10 operations per byte,
// above the card's ratio of INT32 rate to memory rate (16.7e12 / 3.35e12
// = 5).
//
// Design.  One block per row: its first thread folds the four words into
// the row's key once and shares it; the threads stride over the slots,
// neighbouring threads on neighbouring slots, so the 8-byte writes
// coalesce.  Threefry is fully unrolled in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[(i & 1) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void __launch_bounds__(THREADS)
cbs_keys_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ salt,
                const long long* __restrict__ lo, const long long* __restrict__ hi,
                const long long* __restrict__ draw,
                const long long* __restrict__ n_rows, int n_pad,
                long long* __restrict__ out) {
  __shared__ uint32_t key[2];
  const int row = blockIdx.x;
  if (threadIdx.x == 0) {
    // jax.random.fold_in(key, word) = threefry(key, (0, word mod 2^32)).
    const long long words[4] = {salt[row], lo[row], hi[row], draw[row]};
    uint32_t a = k0, b = k1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t x0 = 0u, x1 = (uint32_t)words[w];
      threefry(a, b, x0, x1);
      a = x0;
      b = x1;
    }
    key[0] = a;
    key[1] = b;
  }
  __syncthreads();
  const uint32_t a = key[0], b = key[1];
  const long long n = n_rows[row];
  long long* o = out + (size_t)row * n_pad;
  for (int i = threadIdx.x; i < n_pad; i += THREADS) {
    uint32_t v;
    if (i < n) {
      uint32_t x0 = 0u, x1 = (uint32_t)i;
      threefry(a, b, x0, x1);
      v = (x0 ^ x1) & 0x7FFFFFFFu;
    } else {
      v = 0x80000000u | (uint32_t)i;
    }
    o[i] = (long long)v;
  }
}

}  // namespace

extern "C" {

// Sort keys [rows, n_pad] int64 into `out` on `stream`, for the base key
// (k0, k1) and per-row words salt, lo, hi, draw and true sizes n_rows,
// each [rows] int64 (the words taken mod 2^32).  Returns the CUDA error of
// the launch (0 on success).
int wcx_cbs_keys(unsigned k0, unsigned k1, const long long* salt,
                 const long long* lo, const long long* hi, const long long* draw,
                 const long long* n_rows, int rows, int n_pad, long long* out,
                 void* stream) {
  if (rows < 0 || n_pad < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n_pad == 0) return 0;
  cbs_keys_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, salt, lo, hi, draw, n_rows, n_pad, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
