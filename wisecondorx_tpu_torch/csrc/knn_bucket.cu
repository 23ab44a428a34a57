// K1: fused squared-distance + bucketed top-M scan for the per-bin KNN
// search of newref.
//
// Replaces the TPU kernel wisecondorx_tpu/ops/knn_pallas.py::
// _knn_bucket_kernel (launched by _bucket_scan).  What it computes is the
// same: for every target row r and candidate column g,
//     d = ||t_r||^2 + ||c_g||^2 - 2 t_r . c_g        (fp32 accuracy)
// set to +inf when g is on r's own chromosome, is padding (g >= n_valid)
// or d >= sentinel; the candidate's own-chromosome-excluded index is
// g - (g >= start(r) ? size(r) : 0).  Column g goes to bucket l = g mod L,
// whose M smallest (value, index) pairs are kept by an M-deep
// compare-swap cascade; what falls out of the bottom folds into the
// bucket's min_drop.  Outputs: vals/idx [R, L*M] (pool position m*L + l)
// and drop [R, L].
//
// What bounds it on an H100: operations.  The dot products are 2*R*N*S
// flops; to keep fp32 accuracy on the tensor cores each costs three TF32
// products (3xTF32), so the bound is 3 * 2*R*N*S at the TF32 peak.  The
// bytes (the candidates once, the written pools) take a fifth of that.
// The cascade is not in the bound, and it is what the kernel spends most
// of its instructions on after the products.
//
// Design.  The TPU kept a 12 MB accumulator per row tile in VMEM and ran
// the column blocks as a sequential grid axis.  Here a block owns a fixed
// 64-row x 64-bucket tile of (row, bucket) pairs for the whole scan, and
// the column-block axis is a loop inside it: column block j maps columns
// j*L + l onto the same buckets l, so the thread that holds the product
// of pair (r, l) in one column block holds it in all of them, and each
// pair's cascade stays in that thread's registers from the first column
// block to the last.  Its index is kept as the column block j, 16 bits,
// two depths to a register (7 registers a pair), and g and the exclusion
// are rebuilt only at the final write.
//
// The products run on the tensor cores in 3xTF32: each operand is split
// as a = hi + lo, both rounded to nearest TF32 (the tensor cores would
// truncate), and hi*hi' + hi*lo' + lo*hi' accumulates in fp32.  The block
// is two warpgroups, each issuing wgmma m64n32k8 for all 64 rows and its
// 32 buckets: the accumulator of a thread is 16 (row, bucket) pairs (rows
// g and g+8 of its warp's 16, buckets 8*i + 2*t + {0,1}).  The rows are
// the A operand, from registers: the block's 64 target rows stay resident
// in shared memory for the whole scan (up to 672 samples; wider rows
// stream, see below) and each warp splits its fragment as it goes.  The candidates are the B operand, from shared memory: they
// stream through a ring of 32-sample slices filled with cp.async (the
// next slices load while this one computes), and each slice is split once
// into TF32 hi and lo copies in wgmma's K-major core-matrix layout.
// Shared-memory rows are padded by 4 floats, which keeps every fragment
// and slice access free of bank conflicts.  A column block's candidate
// norms and chromosomes are read into registers at its first slice, so
// their latency is spent under the products, not in the cascade.  The
// grid's x axis walks the buckets, so the blocks resident at one time
// share row tiles and read the same candidate column block together from
// L2.
//
// What holds it back on an H100: the cascade, dozens of instructions per
// insert and 16 inserts per thread and column block, runs while the
// tensor cores idle, and the registers of its state (over 200 a thread)
// allow one block, 8 warps, per SM, too few to hide it.  A variant that
// overlapped it with the next column block's wgmma through a second
// accumulator was slower (PERF.md).
//
// Wide sample axes.  The resident row tile takes 64 * (s_pad + 4) floats
// of shared memory, which caps s_pad at 672.  Above that the rows stream
// too: the block's 64-row x 32-sample row slice rides through the same
// cp.async ring beside the candidate slice, and each warp splits its A
// fragment from the slice that landed.  The products, their order and the
// cascades are the same as on the resident path, so the pools are too.
// Its bound is the same operations bound (3 * 2*R*N*S at the TF32 peak);
// what it adds is traffic, not work: the rows are read again for every
// column block (R * S * 4 bytes * N_pad / L from L2, about as much as the
// candidates), so each slice costs twice the copies and the ring twice the
// shared memory (90 KB whatever the width).  The cascade still holds it
// back first; no faster variant was tried.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DEPTH = 4;     // M: cascade depth per bucket
constexpr int RT = 64;       // target rows per block: one wgmma M
constexpr int CT = 64;       // buckets per block
constexpr int KC = 32;       // samples per streamed candidate slice
constexpr int STAGES = 4;    // candidate slices in the ring
constexpr int THREADS = 256;  // two warpgroups
constexpr int WR = 16;       // rows per warp
constexpr int WN = 32;       // buckets per warpgroup: the wgmma N
constexpr int NT = WN / 8;   // n8 column groups of an accumulator
constexpr int PAD = 4;       // floats added to every shared-memory row
constexpr int BSTRIDE = KC + PAD;
constexpr int B_PIECES = CT * KC / 4 / THREADS;  // 16-byte copies a thread
constexpr int A_PIECES = RT * KC / 4 / THREADS;  // the same, of a row slice
constexpr unsigned NO_J = 0xFFFFu;  // column block of an empty slot
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of a block

// Resident: the row tile, the ring of raw candidate slices, the split
// slice.  Streamed: the ring holds a row slice beside each candidate slice.
size_t smem_floats(int s_pad, bool stream) {
  if (stream) return (size_t)STAGES * (CT + RT) * BSTRIDE + 2 * CT * KC;
  return (size_t)RT * (s_pad + PAD) + (size_t)STAGES * CT * BSTRIDE +
         2 * CT * KC;
}

// Round to nearest TF32 (ties away from zero), as cvt.rna.tf32.f32 does,
// in two integer operations.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo with both halves TF32 (the 3xTF32 split).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and
// `sbo` bytes apart along N.
__device__ __forceinline__ unsigned long long smem_desc(const float* p,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (unsigned long long)((a >> 4) & 0x3FFFu) |
         ((unsigned long long)((lbo >> 4) & 0x3FFFu) << 16) |
         ((unsigned long long)((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 32] += a[64 x 8] (registers) * b[8 x 32] (shared memory), TF32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4],
                                           const unsigned (&a)[4],
                                           unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of a pair's cascade: insert (v, column block jj) into the
// M sorted slots; what falls out folds into the NaN-propagating drop min.
__device__ __forceinline__ void insert(float (&cv)[DEPTH],
                                       unsigned (&cj)[DEPTH / 2], float& dr,
                                       float v, unsigned jj) {
#pragma unroll
  for (int m = 0; m < DEPTH; ++m) {
    const bool take = v < cv[m];
    const float tv = cv[m];
    cv[m] = take ? v : tv;
    v = take ? tv : v;
    const int sh = (m & 1) * 16;
    const unsigned w = cj[m >> 1];
    const unsigned old = (w >> sh) & 0xFFFFu;
    cj[m >> 1] = take ? ((w & ~(0xFFFFu << sh)) | (jj << sh)) : w;
    jj = take ? old : jj;
  }
  if (v < dr || v != v) dr = v;
}

// STREAM: the rows stream through the ring with the candidates (any
// s_pad); otherwise the row tile stays resident (s_pad <= 672).
template <bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
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
  extern __shared__ __align__(16) float smem[];
  // Row stride of the A operand in shared memory.
  const int sa = STREAM ? BSTRIDE : s_pad + PAD;
  // Resident: [RT][sa], the block's rows.  Streamed: [STAGES][RT][BSTRIDE],
  // the row slices of the ring.
  float* As = smem;
  // [STAGES][CT][BSTRIDE]: raw candidate slices.
  float* Bs = smem + (STREAM ? STAGES * RT * BSTRIDE : RT * sa);
  // The current slice split into its TF32 hi and lo halves, each
  // [KC/8][CT/8][2][8][4]: per 8-sample step, K-major core matrices of 8
  // candidates x 4 samples (128 bytes), the two of a step 128 bytes apart,
  // the 8-candidate groups 256 bytes apart.
  float* Bhl = Bs + STAGES * CT * BSTRIDE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;   // warp in its warpgroup: rows 16*wr..
  const int wc = warp >> 2;  // warpgroup: buckets 32*wc..
  const int row0 = blockIdx.y * RT;
  const int col0 = blockIdx.x * CT;
  const int n_k = s_pad / KC;
  const int n_slices = (n_pad / lanes) * n_k;

  if (!STREAM) {
    // The row tile (zeros past n_rows) joins the first slice's group.
    const int a_vec = s_pad / 4;
    for (int e = tid; e < RT * a_vec; e += THREADS) {
      const int rr = e / a_vec, q = e - rr * a_vec;
      float* dst = As + rr * sa + 4 * q;
      if (row0 + rr < n_rows) {
        cp_async16(dst, rows + (size_t)(row0 + rr) * s_pad + 4 * q);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  // Streamed row slices: samples kc*KC + [0, KC) of the block's rows; a
  // row past n_rows copies the last row (its results are never written).
  int aso[A_PIECES];
  size_t ago[A_PIECES];
#pragma unroll
  for (int i = 0; i < A_PIECES; ++i) {
    const int e = tid + THREADS * i;
    const int n = e / (KC / 4), q = e % (KC / 4);
    aso[i] = n * BSTRIDE + 4 * q;
    ago[i] = (size_t)min(row0 + n, n_rows - 1) * s_pad + 4 * q;
  }

  // Slice (j, kc): candidates j*L + col0 + [0, CT), samples kc*KC + [0,
  // KC).  A thread copies the same B_PIECES 16-byte pieces of every slice
  // and splits the same B_PIECES of every landed one.
  int so[B_PIECES], ro[B_PIECES], ho[B_PIECES];
  size_t go[B_PIECES];
#pragma unroll
  for (int i = 0; i < B_PIECES; ++i) {
    const int e = tid + THREADS * i;
    const int n = e / (KC / 4), q = e % (KC / 4);
    so[i] = n * BSTRIDE + 4 * q;
    go[i] = (size_t)n * s_pad + 4 * q;
    const int nc = e % CT, qc = e / CT;
    ro[i] = nc * BSTRIDE + 4 * qc;
    ho[i] = (qc >> 1) * (CT * 8) + (nc >> 3) * 64 + (qc & 1) * 32 + (nc & 7) * 4;
  }
  int ld_left = n_slices, ld_j = 0, ld_kc = 0, ld_stage = 0;
  auto issue_slice = [&]() {
    if (ld_left > 0) {
      const float* src =
          cand + ((size_t)ld_j * lanes + col0) * s_pad + ld_kc * KC;
      float* dst = Bs + ld_stage * (CT * BSTRIDE);
#pragma unroll
      for (int i = 0; i < B_PIECES; ++i) cp_async16(dst + so[i], src + go[i]);
      if (STREAM) {
        const float* asrc = rows + ld_kc * KC;
        float* adst = As + ld_stage * (RT * BSTRIDE);
#pragma unroll
        for (int i = 0; i < A_PIECES; ++i)
          cp_async16(adst + aso[i], asrc + ago[i]);
      }
      --ld_left;
      if (++ld_kc == n_k) {
        ld_kc = 0;
        ++ld_j;
      }
      if (++ld_stage == STAGES) ld_stage = 0;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_slice();

  float rn[2];
  int rc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wr * WR + g + 8 * h;
    rn[h] = r < n_rows ? rnorm[r] : 0.f;
    rc[h] = r < n_rows ? rchr[r] : -3;
  }

  // Pair (column group nt, element e) is row g + 8*(e >> 1) of the warp's
  // rows and bucket 8*nt + 2*t + (e & 1) of the warpgroup's (the wgmma
  // accumulator layout).
  float acc[NT][4];
  float cv[NT][4][DEPTH];
  unsigned cj[NT][4][DEPTH / 2];
  float dr[NT][4];
  float pcn[NT][2];
  int pcc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = 0.f;
      dr[nt][e] = INFINITY;
#pragma unroll
      for (int m = 0; m < DEPTH; ++m) cv[nt][e][m] = INFINITY;
#pragma unroll
      for (int m = 0; m < DEPTH / 2; ++m) cj[nt][e][m] = 0xFFFFFFFFu;
    }

  const int a_off = (wr * WR + g) * sa + t;
  int kc = 0, j = 0, stage = 0;
#pragma unroll 1
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice sl landed; the split copy is free again
    issue_slice();

    const float* raw = Bs + stage * (CT * BSTRIDE);
#pragma unroll
    for (int i = 0; i < B_PIECES; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(raw + ro[i]);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(Bhl + ho[i]) = h;
      *reinterpret_cast<uint4*>(Bhl + CT * KC + ho[i]) = l;
    }
    // The split copy is read by the tensor cores (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (kc == 0) {  // this column block's candidate norms and chromosomes
      const size_t gb = (size_t)j * lanes + col0 + wc * WN + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pcn[nt][c] = cnorm[gb + nt * 8 + c];
          pcc[nt][c] = cchr[gb + nt * 8 + c];
        }
    }
    const float* a = STREAM ? As + stage * (RT * BSTRIDE) + a_off
                            : As + a_off + kc * KC;
    unsigned ah[KC / 8][4], al[KC / 8][4];
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      split(a[kk * 8], ah[kk][0], al[kk][0]);
      split(a[kk * 8 + 8 * sa], ah[kk][1], al[kk][1]);
      split(a[kk * 8 + 4], ah[kk][2], al[kk][2]);
      split(a[kk * 8 + 8 * sa + 4], ah[kk][3], al[kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const float* bh = Bhl + kk * (CT * 8) + wc * (WN * 8);
      const unsigned long long dh = smem_desc(bh, 128, 256);
      const unsigned long long dl = smem_desc(bh + CT * KC, 128, 256);
      wgmma_tf32(acc, al[kk], dh);
      wgmma_tf32(acc, ah[kk], dl);
      wgmma_tf32(acc, ah[kk], dh);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (kc == n_k - 1) {  // column block j is complete: into the cascades
      const size_t gbase = (size_t)j * lanes + col0 + wc * WN + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t gc = gbase + nt * 8 + c;
          const float cn = pcn[nt][c];
          const int cc = pcc[nt][c];
          const bool pad_col = gc >= (size_t)n_valid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            float v = (rn[h] + cn) - 2.f * acc[nt][e];
            if (rc[h] == cc || pad_col || v >= sentinel) v = INFINITY;
            insert(cv[nt][e], cj[nt][e], dr[nt][e], v, (unsigned)j);
            acc[nt][e] = 0.f;
          }
        }
    }
    if (++kc == n_k) {
      kc = 0;
      ++j;
    }
    if (++stage == STAGES) stage = 0;
  }
  cp_async_wait<0>();

  const size_t pool = (size_t)lanes * DEPTH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wr * WR + g + 8 * h;
    if (r >= n_rows) continue;
    const int rs = rstart[r], rz = rsize[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int l = col0 + wc * WN + nt * 8 + 2 * t;
      const int e = 2 * h;
#pragma unroll
      for (int m = 0; m < DEPTH; ++m) {
        const int sh = (m & 1) * 16;
        int ii[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const unsigned jm = (cj[nt][e + c][m >> 1] >> sh) & 0xFFFFu;
          const int gi = (int)jm * lanes + l + c;
          ii[c] = jm == NO_J ? -1 : gi - (gi >= rs ? rz : 0);
        }
        const size_t o = r * pool + (size_t)m * lanes + l;
        *reinterpret_cast<float2*>(vals + o) =
            make_float2(cv[nt][e][m], cv[nt][e + 1][m]);
        *reinterpret_cast<int2*>(idx + o) = make_int2(ii[0], ii[1]);
      }
      *reinterpret_cast<float2*>(drop + (size_t)r * lanes + l) =
          make_float2(dr[nt][e], dr[nt][e + 1]);
    }
  }
}

}  // namespace

extern "C" {

int wcx_knn_bucket_depth(void) { return DEPTH; }
int wcx_knn_bucket_col_tile(void) { return CT; }
int wcx_knn_bucket_k_chunk(void) { return KC; }
// The widest sample axis whose row tile stays resident in shared memory;
// a wider one streams its rows.
int wcx_knn_bucket_resident_s_pad(void) {
  const int spare =
      SMEM_LIMIT / (int)sizeof(float) - (int)smem_floats(0, false);
  return (spare / RT) / KC * KC;
}

// Launch K1 on `stream`.  Requires lanes % CT == 0, n_pad % lanes == 0,
// n_pad / lanes < 0xFFFF, s_pad % KC == 0 and 16-byte aligned rows and
// cand (the wrapper checks and pads).  Returns the CUDA error of the
// launch (0 on success).
int wcx_knn_bucket(const float* rows, const float* rnorm, const int* rchr,
                   const int* rstart, const int* rsize, int n_rows,
                   const float* cand, const float* cnorm, const int* cchr,
                   int n_pad, int s_pad, int n_valid, float sentinel,
                   int lanes, float* vals, int* idx, float* drop,
                   void* stream) {
  if (n_rows <= 0) return 0;
  if (lanes % CT || n_pad % lanes || n_pad / lanes >= (int)NO_J ||
      s_pad <= 0 || s_pad % KC)
    return (int)cudaErrorInvalidValue;
  const bool stream_rows = s_pad > wcx_knn_bucket_resident_s_pad();
  const size_t smem = smem_floats(s_pad, stream_rows) * sizeof(float);
  auto kernel =
      stream_rows ? knn_bucket_kernel<true> : knn_bucket_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lanes / CT, (n_rows + RT - 1) / RT);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      rows, rnorm, rchr, rstart, rsize, n_rows, cand, cnorm, cchr, n_pad,
      s_pad, n_valid, sentinel, lanes, vals, idx, drop);
  return (int)cudaGetLastError();
}

}  // extern "C"
