// Fused linear + cross-entropy head for Hopper (sm_90a): forward, dx and dW.
//
// Replaces the three Pallas kernels of saturn_tpu/ops/ce.py:
//   ce_fwd_sm90_kernel (both modes)
//     + ce_fwd_combine_kernel               <- _run_fwd       (pallas_call at ce.py:208, _fwd_kernel)
//   ce_dx_sm90_kernel (stash mode),
//   ce_dx_kernel (recompute mode),
//     each + ce_dx_reduce_kernel            <- _fused_ce_bwd  (pallas_call at ce.py:290, _dx_kernel)
//   ce_dw_sm90_kernel (stash mode),
//   ce_dw_kernel (recompute mode)           <- _fused_ce_bwd  (pallas_call at ce.py:314, _dw_kernel)
//
// What they compute, for x (N, D) bf16, W (V, D) bf16 and labels (N,) int32
// (negative = ignored): s = x W^T in f32 with the columns >= V at -1e30;
// forward: lse = logsumexp over the vocab, loss = lse - s[label] (the label
// logit from the f32 s, 0 for an ignored row), and in stash mode a bf16 copy
// of s; backward: ds = (exp(s - lse) - onehot(label)) * g, rounded to bf16,
// dx = ds W (bf16 out) and dW = ds^T x (f32 out). s comes from the stash or,
// in recompute mode, from x W^T again in f32.
//
// What bounds them on an H100: each is one product of 2 N V D operations
// (recompute mode adds a second), K = D (fwd), K = V (dx) or K = N (dW), far
// above the card's ~295 operations per byte in bf16: bound by operations
// (0.32 ms at N 4096, D 768, V 50304). In practice the mma.sync kernels are
// bound by their mma.sync issue rate and their shared-memory fragment loads.
//
// What the design does about it. The forward (both modes) and the two
// stash-mode backward kernels, ce_dx_sm90_kernel and ce_dw_sm90_kernel, are
// built for Hopper (TMA rings, wgmma; ds formed in registers in the
// backward): see their own notes below. The forward's token tiles alone
// would not fill the card, so its vocab is split across blocks: each writes
// partial (max, sum, label logit) rows in f32 for its vocab range, and
// ce_fwd_combine_kernel forms lse and loss (the TPU kernel instead walks the
// whole vocab on one grid axis). The recompute-mode backward kernels compute
// a 128 x 128 output tile per block and stage the product's depth 32 at a
// time through shared memory with cp.async, double-buffered. Products run on
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Operands contiguous along the
// product's depth are read with 32-bit shared loads; operands contiguous
// along the output (W in dx, x in dW) are staged as they lie in memory and
// read with ldmatrix.trans.
//
// - The recompute-mode ce_dx and ce_dw: 8 warps as 4 x 2 warps of 32 x 64.
//   Each depth stage first forms its f32 score tile x W^T in registers, turns
//   it into a ds tile in shared memory, every element once, then runs the
//   product with ds as the A operand. Every D tile repeats the x W^T
//   recompute: D / 128 = 6 times over at D 768, the price of keeping the
//   accumulator of a 128 x 128 tile in registers; recompute is the
//   long-context mode, off the main path.
// - ce_dx (both kernels): output tiles over (token, D) with the vocab as
//   depth: at D 768 too few to fill the card, so the vocab is split
//   (split-K) into f32 partial sums that ce_dx_reduce_kernel adds in a fixed
//   order and casts to bf16: no atomics, a result independent of scheduling.
//   The D tiles of one token tile are neighbours in the grid, so they stream
//   the same stash rows at about the same time and all but the first read
//   come from L2.
// - ce_dw (both kernels): output tiles over (vocab, D), tokens as depth, the
//   depth loop inside the block, f32 out, no atomics.
// - The vocab is taken as it is (no pad to a tile multiple): loads past V or
//   N are zero-filled and ds is 0 in columns >= V; g is 0 in rows >= N.
// - The launchers choose the vocab splits of ce_fwd and ce_dx from the
//   kernel's occupancy on the current device (units_per_split);
//   ce_fwd_scratch and ce_dx_scratch tell the caller how much f32 scratch
//   that split takes, so no caller mirrors the tiles or the split rule.
//
// Layout: x, W, dx row-major with row stride D (D % 64 == 0); the stash is
// (N, ld_s) bf16 with ld_s % 8 == 0 and columns >= V unused; labels, lse, g,
// loss are (N,) contiguous. Each launcher returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;              // output rows per block
constexpr int BN = 128;              // output columns per block
constexpr int BK = 32;               // depth per pipeline stage
constexpr int WM = 32;               // rows of one warp's part of the tile
constexpr int MT = WM / 16;          // mma row tiles per warp
constexpr int PAD = 8;               // bf16 of row padding: 16 bytes, no bank conflicts
constexpr int LDK = BK + PAD;        // row stride of a tile contiguous along the depth
constexpr int LDN = BN + PAD;        // row stride of a tile contiguous along the output
constexpr float NEG_INF = -1e30f;    // the mask value of the Pallas kernels

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (src is
// then not read).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and register i of lane (g, t) receives
// {M_i[2t][g], M_i[2t + 1][g]}.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ROWS x BK of a row-major matrix (rows r0.., columns c0..; R rows and C
// columns exist, C % 8 == 0) -> shared memory at row stride LDK.
template <int ROWS>
__device__ __forceinline__ void load_k_tile(bf16* dst, const bf16* src, long long ld,
                                            int r0, int R, int c0, int C) {
  constexpr int SEG = BK / 8;
  for (int i = threadIdx.x; i < ROWS * SEG; i += blockDim.x) {
    const int r = i / SEG, c = (i % SEG) * 8;
    const bool ok = r0 + r < R && c0 + c < C;
    cp_async16(dst + r * LDK + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// BK x BN of a row-major matrix (rows k0.., columns n0..) -> shared memory at
// row stride LDN.
__device__ __forceinline__ void load_n_tile(bf16* dst, const bf16* src, long long ld,
                                            int k0, int K, int n0, int C) {
  constexpr int SEG = BN / 8;
  for (int i = threadIdx.x; i < BK * SEG; i += blockDim.x) {
    const int r = i / SEG, c = (i % SEG) * 8;
    const bool ok = k0 + r < K && n0 + c < C;
    cp_async16(dst + r * LDN + c, ok ? src + (size_t)(k0 + r) * ld + n0 + c : src, ok);
  }
}

// acc (RT*16 x CT*8) += A (RT*16 x 16) B^T (CT*8 x 16), depth columns k0..k0+15
// of A and B, both row-major over the depth in shared memory. acc[i][n] is a
// 16 x 8 tile in the mma.sync C layout: element e of lane (g, t) sits at row
// 16 i + g + 8 (e / 2), column 8 n + 2 t + e % 2.
template <int RT, int CT>
__device__ __forceinline__ void mma_kk(float (*acc)[CT][4], const bf16* A, const bf16* B,
                                       int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const bf16* pa = A + (i * 16 + g) * LDK + k0 + 2 * t;
    a[i][0] = ld32(pa);
    a[i][1] = ld32(pa + 8 * LDK);
    a[i][2] = ld32(pa + 8);
    a[i][3] = ld32(pa + 8 * LDK + 8);
  }
#pragma unroll
  for (int n = 0; n < CT; ++n) {
    const bf16* pb = B + (n * 8 + g) * LDK + k0 + 2 * t;
    const uint32_t b0 = ld32(pb), b1 = ld32(pb + 8);
#pragma unroll
    for (int i = 0; i < RT; ++i) mma16816(acc[i][n], a[i], b0, b1);
  }
}

// acc (MT*16 x CT*8) += a B: a holds the A fragments of MT 16 x 16 tiles at
// depth kk*16; B points at the first of the CT*8 columns in a (BK x BN) tile
// at row stride LDN, contiguous along the columns (read with ldmatrix.trans).
template <int CT>
__device__ __forceinline__ void mma_bt(float (*acc)[CT][4], uint32_t (*a)[4], const bf16* B,
                                       int kk, int lane) {
  const int i = lane >> 3, r = lane & 7;
  const bf16* row = B + (kk * 16 + (i & 1) * 8 + r) * LDN + (i >> 1) * 8;
#pragma unroll
  for (int n = 0; n < CT; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, row + n * 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma16816(acc[m][n], a[m], b[0], b[1]);
      mma16816(acc[m][n + 1], a[m], b[2], b[3]);
    }
  }
}

// A fragments of MT 16 x 16 tiles at depth kk*16 from a tile that is
// row-major over the depth (row stride LDK), its first row at A.
__device__ __forceinline__ void a_rows(uint32_t (*a)[4], const bf16* A, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const bf16* pa = A + (i * 16 + g) * LDK + kk * 16 + 2 * t;
    a[i][0] = ld32(pa);
    a[i][1] = ld32(pa + 8 * LDK);
    a[i][2] = ld32(pa + 8);
    a[i][3] = ld32(pa + 8 * LDK + 8);
  }
}

// A fragments of MT 16 x 16 tiles at depth kk*16 from a tile stored
// transposed, S[depth][row] at row stride LDN, the first row at column m0:
// matrix q of ldmatrix covers rows + 8 (q % 2) and depth + 8 (q / 2).
__device__ __forceinline__ void a_cols(uint32_t (*a)[4], const bf16* S, int kk, int m0,
                                       int lane) {
  const int li = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldsm_x4_t(a[i], S + (kk * 16 + (li >> 1) * 8 + lr) * LDN + m0 + i * 16 + (li & 1) * 8);
}

// One element of the softmax gradient: (exp(s - lse) - [label == col]) * g,
// 0 in the columns past the vocab.
__device__ __forceinline__ float ds_of(float s, int col, int V, float lse, float g,
                                       int label) {
  if (col >= V) return 0.f;
  return (__expf(s - lse) - (col == label ? 1.f : 0.f)) * g;
}

template <int CT>
__device__ __forceinline__ void zero(float (*acc)[CT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < CT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
}

// ------------------------------------------------- dx and dW, recompute mode
// Both recompute-mode backward kernels run 8 warps (THREADS_BWD) over a
// 128 x 128 output tile, as 4 x 2 warps of 32 x 64. Each depth stage first
// forms the f32 score tile of x W^T in registers and turns it into a ds tile
// in shared memory, every element once, then runs the product with ds as the
// A operand. Forming ds apart from the product keeps the mma loop free of the
// exponentials.
constexpr int THREADS_BWD = 256;
constexpr int NTW = 64 / 8;          // mma column tiles per warp in dx and dW

// Block (D tile, token tile, vocab split): part[split] (N x D, f32) = the
// split's sum over vocab of ds W.
__global__ void __launch_bounds__(THREADS_BWD, 2)
ce_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gr, float* __restrict__ part, int N, int V, int D,
             int chunks_per_split) {
  // sA: the x tile (BM tokens x BK of D); sW: the W tile (BK vocab x BK of
  // D); sDs: the ds tile; sB: the W tile of the product (BK vocab x BN of D).
  __shared__ __align__(16) bf16 sA[2][BM * LDK];
  __shared__ __align__(16) bf16 sW[2][BK * LDK];
  __shared__ __align__(16) bf16 sDs[BM * LDK];
  __shared__ __align__(16) bf16 sB[BK * LDN];
  __shared__ float sLse[BM], sG[BM];
  __shared__ int sLab[BM];

  const int d0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n_kc = (V + BK - 1) / BK;
  const int c0 = blockIdx.z * chunks_per_split, c1 = min(n_kc, c0 + chunks_per_split);

  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    const int r = row0 + i;
    sLse[i] = r < N ? lse[r] : 0.f;
    sG[i] = r < N ? gr[r] : 0.f;
    sLab[i] = r < N ? labels[r] : -1;
  }

  float acc[MT][NTW][4];
  zero<NTW>(acc);
  uint32_t a[MT][4];

  const int nd = D / BK;
  for (int c = c0; c < c1; ++c) {
    // s (16 tokens of this warp x BK vocab) = x W^T over all of D, in f32
    float s[1][BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[0][n][0] = s[0][n][1] = s[0][n][2] = s[0][n][3] = 0.f;
    load_n_tile(sB, w, D, c * BK, V, d0, D);
    load_k_tile<BM>(sA[0], x, D, row0, N, 0, D);
    load_k_tile<BK>(sW[0], w, D, c * BK, V, 0, D);
    cp_commit();
    for (int dk = 0; dk < nd; ++dk) {
      if (dk + 1 < nd) {
        load_k_tile<BM>(sA[(dk + 1) & 1], x, D, row0, N, (dk + 1) * BK, D);
        load_k_tile<BK>(sW[(dk + 1) & 1], w, D, c * BK, V, (dk + 1) * BK, D);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16)
        mma_kk<1, BK / 8>(s, sA[dk & 1] + warp * 16 * LDK, sW[dk & 1], k0, lane);
      __syncthreads();
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h, col = n * 8 + 2 * t, v = c * BK + col;
        *reinterpret_cast<uint32_t*>(sDs + r * LDK + col) =
            pack_bf16(ds_of(s[0][n][2 * h], v, V, sLse[r], sG[r], sLab[r]),
                      ds_of(s[0][n][2 * h + 1], v + 1, V, sLse[r], sG[r], sLab[r]));
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a_rows(a, sDs + wm * WM * LDK, kk, lane);
      mma_bt<NTW>(acc, a, sB + wn * 64, kk, lane);
    }
    __syncthreads();  // sB, sA[0], sW[0] and sDs are refilled for the next chunk
  }

  float* out = part + (size_t)blockIdx.z * N * D;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * WM + i * 16 + h * 8 + g;
      if (r >= N) continue;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int col = d0 + wn * 64 + n * 8 + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(out + (size_t)r * D + col) =
              make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
}

// dx = bf16(sum over the splits of part), in split order.
__global__ void ce_dx_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dx,
                                    long long n, int KS) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < KS; ++k) v += part[k * n + i];
    dx[i] = __float2bfloat16(v);
  }
}

// Recompute mode. Block (D tile, vocab tile): dW rows = sum over all tokens
// of ds^T x, in f32, with s = W x^T recomputed for each token chunk. The
// statistics of a token chunk sit in shared memory beside it.
__global__ void __launch_bounds__(THREADS_BWD, 2)
ce_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ labels, const float* __restrict__ lse,
             const float* __restrict__ gr, float* __restrict__ dw, int N, int V, int D) {
  // sS: the ds tile as S[token][vocab] (BK tokens x BM vocab), written from
  // the score tile. sWr, sXr: the W tile (BM vocab x BK of D) and the x tile
  // (BK tokens x BK of D). sB: the x tile of the product (BK tokens x BN of D).
  // sL, sG, sLab: the statistics of the chunk's tokens.
  __shared__ __align__(16) bf16 sS[BK * LDN];
  __shared__ __align__(16) bf16 sWr[2][BM * LDK];
  __shared__ __align__(16) bf16 sXr[2][BK * LDK];
  __shared__ __align__(16) bf16 sB[BK * LDN];
  __shared__ float sL[BK], sG[BK];
  __shared__ int sLab[BK];

  const int d0 = blockIdx.x * BN, v0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n_kc = (N + BK - 1) / BK;

  float acc[MT][NTW][4];
  zero<NTW>(acc);
  uint32_t a[MT][4];

  const int nd = D / BK;
  for (int c = 0; c < n_kc; ++c) {
    // s (16 vocab rows of this warp x BK tokens) = W x^T over all of D, in f32
    float s[1][BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[0][n][0] = s[0][n][1] = s[0][n][2] = s[0][n][3] = 0.f;
    load_n_tile(sB, x, D, c * BK, N, d0, D);
    load_k_tile<BM>(sWr[0], w, D, v0, V, 0, D);
    load_k_tile<BK>(sXr[0], x, D, c * BK, N, 0, D);
    cp_commit();
    if (threadIdx.x < BK) {
      const int r = c * BK + threadIdx.x;
      sL[threadIdx.x] = r < N ? lse[r] : 0.f;
      sG[threadIdx.x] = r < N ? gr[r] : 0.f;
      sLab[threadIdx.x] = r < N ? labels[r] : -1;
    }
    for (int dk = 0; dk < nd; ++dk) {
      if (dk + 1 < nd) {
        load_k_tile<BM>(sWr[(dk + 1) & 1], w, D, v0, V, (dk + 1) * BK, D);
        load_k_tile<BK>(sXr[(dk + 1) & 1], x, D, c * BK, N, (dk + 1) * BK, D);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16)
        mma_kk<1, BK / 8>(s, sWr[dk & 1] + warp * 16 * LDK, sXr[dk & 1], k0, lane);
      __syncthreads();
    }
    // ds, stored transposed as S[token][vocab]
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = warp * 16 + g + 8 * (e >> 1), k = n * 8 + 2 * t + (e & 1);
        sS[k * LDN + m] =
            __float2bfloat16(ds_of(s[0][n][e], v0 + m, V, sL[k], sG[k], sLab[k]));
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a_cols(a, sS, kk, wm * WM, lane);
      mma_bt<NTW>(acc, a, sB + wn * 64, kk, lane);
    }
    __syncthreads();  // sB, sWr[0], sXr[0], sS and the statistics are refilled next chunk
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = v0 + wm * WM + i * 16 + h * 8 + g;
      if (r >= V) continue;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int col = d0 + wn * 64 + n * 8 + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(dw + (size_t)r * D + col) =
              make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
}

// ------------------------------------------------ dW, stash mode, for Hopper
// ce_dw_sm90_kernel: one block per (D tile of 64 NB columns, vocab tile of
// 128 rows); dW tile = sum over all tokens of ds^T x, in f32.
// - Tiles arrive by TMA into a ring of DW_STAGES stages of DW_CHUNK tokens:
//   the stash chunk (tokens x 128 vocab as two 64-column blocks, 128-byte
//   swizzle; the map spans V columns and N rows, so boxes past them are
//   zero-filled), the x chunk (tokens x 64 NB) and the chunk's lse, g and
//   labels (1-d maps, zero past N, so g is 0 there). At the end of each step
//   thread 0 refills the stage of the chunk before, which every thread freed
//   a step earlier, with the chunk DW_STAGES ahead of it. There is no
//   producer warp: with one (288 threads) ptxas capped each thread at 168
//   registers, short of the 208 this kernel uses, and spilled.
// - Two warpgroups, each owning 64 vocab rows and all 64 NB columns: NB f32
//   accumulators of 64 x 64 in registers, 32 NB per thread.
// - ds is formed in registers as the A operand of the product, never stored:
//   each warp reads its 16 vocab rows x 16 tokens of the stash chunk with
//   ldmatrix.trans (A = ds^T: the stash rows are the depth), which lands in
//   wgmma's register A layout, turns each value into ds (one FFMA and one
//   ex2 per element) and multiplies with wgmma RS against the x chunk read
//   MN-major (m64n256k16 for a 256-column tile, else m64n64k16 per column
//   block). A warpgroup waits for its own products before it forms the next
//   operand, and the other warpgroup's products run meanwhile: keeping a
//   batch in flight while the next operand is written makes ptxas serialize
//   every wgmma (advisory C7513), and was no faster. Each (token, vocab)
//   element is formed once per D tile: D / (64 NB) = 3 times at D 768 (the
//   mma.sync kernel formed it 6 times); the D tiles of a vocab tile are
//   neighbours in the grid, so they run together and the stash streams from
//   device memory about once.
constexpr int DW_ROWS = 128;     // vocab rows per block: 64 per warpgroup
constexpr int DW_CHUNK = 64;     // tokens per ring stage
constexpr int DW_STAGES = 4;
constexpr int DW_THREADS = 256;  // two warpgroups; thread 0 also issues the loads
constexpr int BOX_BF16 = sm90::BOX * sm90::BOX;  // bf16 of one 64 x 64 box (column block)
constexpr float LOG2E = 1.4426950408889634f;

template <int NB>
struct DwSmem {
  bf16 s[DW_STAGES][2 * BOX_BF16];
  bf16 x[DW_STAGES][NB * BOX_BF16];
  float lse[DW_STAGES][DW_CHUNK], g[DW_STAGES][DW_CHUNK];
  int label[DW_STAGES][DW_CHUNK];
  uint64_t full[DW_STAGES], empty[DW_STAGES];
};

// The tensor maps of ce_dw_sm90_kernel.
struct DwMaps {
  CUtensorMap s, x, lse, g, label;
};

// Token chunk c into ring stage c % DW_STAGES, as the stage's round
// c / DW_STAGES: wait until every thread freed the previous round.
template <int NB>
__device__ __forceinline__ void load_dw_chunk(DwSmem<NB>& sm, const DwMaps& maps, int c, int v0,
                                              int d0) {
  const int st = c % DW_STAGES, round = c / DW_STAGES, k0 = c * DW_CHUNK;
  if (round > 0) sm90::mbar_wait(&sm.empty[st], (round - 1) & 1);
  sm90::mbar_expect_tx(&sm.full[st], (2 + NB) * sm90::BLOCK_BYTES + 3 * DW_CHUNK * 4);
#pragma unroll
  for (int b = 0; b < 2; ++b)
    sm90::tma_load_3d(sm.s[st] + b * BOX_BF16, &maps.s, &sm.full[st], v0 + b * sm90::BOX, k0, 0);
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
    sm90::tma_load_3d(sm.x[st] + cb * BOX_BF16, &maps.x, &sm.full[st], d0 + cb * sm90::BOX, k0,
                      0);
  sm90::tma_load_1d(sm.lse[st], &maps.lse, &sm.full[st], k0);
  sm90::tma_load_1d(sm.g[st], &maps.g, &sm.full[st], k0);
  sm90::tma_load_1d(sm.label[st], &maps.label, &sm.full[st], k0);
}

// This warp's A operand of one chunk, in place: a[kk] holds the stash values
// of depth step kk (tokens 16 kk ..) as ldmatrix.trans left them, register
// 2 hq + vh the tokens 16 kk + 8 hq + 2 t, + 1 and the vocab column
// vcol + 8 vh (t = lane % 4, vcol = this lane's first column); each becomes
// bf16 ds. exp(s - lse) is one FFMA and one ex2. CHECKED masks the columns
// >= V (with a bit mask) and subtracts the one-hot label term; without it
// neither occurs in this warp's columns.
template <bool CHECKED>
__device__ __forceinline__ void ds_operand(uint32_t (&a)[4][4], const float* lse, const float* g,
                                           const int* label, int t, int vcol, int V) {
#pragma unroll
  for (int kk = 0; kk < DW_CHUNK / 16; ++kk)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int tok = 16 * kk + 8 * hq + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(lse + tok);
      const float2 gg = *reinterpret_cast<const float2*>(g + tok);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E}, gt[2] = {gg.x, gg.y};
      int lab[2] = {-1, -1};
      if (CHECKED) {
        const int2 lb = *reinterpret_cast<const int2*>(label + tok);
        lab[0] = lb.x;
        lab[1] = lb.y;
      }
#pragma unroll
      for (int vh = 0; vh < 2; ++vh) {
        const float2 sc = unpack_bf16(a[kk][2 * hq + vh]);
        float d[2] = {sc.x, sc.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = sm90::exp2_approx(fmaf(d[e], LOG2E, -l2[e]));
          if (CHECKED) {
            const int c = vcol + 8 * vh;
            d[e] = (__int_as_float(__float_as_int(ex) & -(int)(c < V)) -
                    (c == lab[e] ? 1.f : 0.f)) * gt[e];
          } else {
            d[e] = ex * gt[e];
          }
        }
        a[kk][2 * hq + vh] = pack_bf16(d[0], d[1]);
      }
    }
}

template <int NB>
__global__ void __launch_bounds__(DW_THREADS, 1)
ce_dw_sm90_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ dw, int N, int V,
                  int D) {
  DwSmem<NB>& sm = *reinterpret_cast<DwSmem<NB>*>(sm90::smem_1024());
  const int d0 = blockIdx.x * NB * sm90::BOX, v0 = blockIdx.y * DW_ROWS;
  const int nc = (N + DW_CHUNK - 1) / DW_CHUNK;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < DW_STAGES; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], DW_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader)
    for (int c = 0; c < DW_STAGES && c < nc; ++c) load_dw_chunk<NB>(sm, maps, c, v0, d0);
  __syncwarp();

  // This warp's 16 vocab columns from vbase; ldmatrix: lane l gives row
  // l % 8 of matrix l / 8 (tokens + 8 (l / 16), columns + 8 (l / 8 % 2)),
  // its 16-byte chunk found through the swizzle (token % 8 == l % 8).
  const int vbase = v0 + wg * sm90::BOX + warp * 16, vcol = vbase + (lane >> 2);
  const int mi = lane >> 3, rr = lane & 7;
  const int lm_off = wg * sm90::BLOCK_BYTES + ((mi >> 1) * 8 + rr) * 128 +
                     (((2 * warp + (mi & 1)) ^ rr) << 4);
  const bool tail = vbase + 16 > V;

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  uint32_t a[4][4];  // the A operand of a chunk: ds^T, 16 vocab rows x 64 tokens
  for (int c = 0; c < nc; ++c) {
    const int st = c % DW_STAGES;
    sm90::mbar_wait(&sm.full[st], (c / DW_STAGES) & 1);
    const unsigned char* s_tile = reinterpret_cast<const unsigned char*>(sm.s[st]) + lm_off;
#pragma unroll
    for (int kk = 0; kk < DW_CHUNK / 16; ++kk) sm90::ldmatrix_x4_trans(a[kk], s_tile + kk * 2048);
    bool hit = false;  // a label of the chunk among this warp's columns
#pragma unroll
    for (int i = 0; i < DW_CHUNK / 8; ++i) {
      const int2 lb = *reinterpret_cast<const int2*>(sm.label[st] + 8 * i + 2 * (lane & 3));
      hit |= (unsigned)(lb.x - vbase) < 16u || (unsigned)(lb.y - vbase) < 16u;
    }
    if (tail || __any_sync(~0u, hit))
      ds_operand<true>(a, sm.lse[st], sm.g[st], sm.label[st], lane & 3, vcol, V);
    else
      ds_operand<false>(a, sm.lse[st], sm.g[st], sm.label[st], lane & 3, vcol, V);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) sm90::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < DW_CHUNK / 16; ++kk) sm90::fence_regs(a[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_CHUNK / 16; ++kk) {
      if constexpr (NB == 4) {
        sm90::wgmma_rs_n256(acc, a[kk], sm90::desc_mn(sm.x[st], kk));
      } else {
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          sm90::wgmma_rs(acc[cb], a[kk], sm90::desc_mn(sm.x[st] + cb * BOX_BF16, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) sm90::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < DW_CHUNK / 16; ++kk) sm90::fence_regs(a[kk]);
    sm90::mbar_arrive(&sm.empty[st]);
    // chunk c - 1 + DW_STAGES into the stage of chunk c - 1, which every
    // thread freed a step ago
    if (leader && c >= 1 && c - 1 + DW_STAGES < nc)
      load_dw_chunk<NB>(sm, maps, c - 1 + DW_STAGES, v0, d0);
    __syncwarp();
  }

  // accumulator element 4 n + e: row 16 warp + lane / 4 + 8 (e / 2) of the
  // warpgroup's 64, column 8 n + 2 (lane % 4) + e % 2 of the column block
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int v = vcol + 8 * hh;
    if (v >= V) continue;
    float* out = dw + (size_t)v * D + d0 + 2 * (lane & 3);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(out + cb * 64 + n * 8) =
            make_float2(acc[cb][4 * n + 2 * hh], acc[cb][4 * n + 2 * hh + 1]);
  }
}

template <int NB>
int launch_dw_sm90(const DwMaps& maps, void* dw, int N, int V, int D, cudaStream_t s) {
  constexpr int smem = (int)sizeof(DwSmem<NB>) + 1024;  // room to align to 1024
  const cudaError_t err = cudaFuncSetAttribute(
      ce_dw_sm90_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / (NB * sm90::BOX), (V + DW_ROWS - 1) / DW_ROWS);  // D tiles fastest
  ce_dw_sm90_kernel<NB><<<grid, DW_THREADS, smem, s>>>(maps, (float*)dw, N, V, D);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ dx, stash mode, for Hopper
// ce_dx_sm90_kernel: one block per (D tile of 64 NB columns, token tile of
// 128 rows, vocab split); part[split] (N x D, f32) = the split's sum over
// its vocab of ds W. ce_dw_sm90_kernel's design with the roles transposed:
// - Bound at N 4096, D 768, V 50304: the product, 2 N V D = 316 GFLOP, 0.32
//   ms on the tensor cores. Beside it the ex2 of ds, N V D / (64 NB) = 618 M
//   (each element once per D tile), about 0.17 ms on the special-function
//   units if nothing hid it, and about 0.6 GB of device memory, 0.18 ms: the
//   412 MB stash once, W (77 MB) once, the f32 partial sums written and read.
// - Tiles arrive by TMA into a ring of DX_STAGES stages of DX_CHUNK vocab
//   columns: the stash chunk (128 tokens x 64 vocab as two 64-row boxes;
//   its map spans V columns and N rows) and the W chunk (64 vocab rows x
//   64 NB columns; its map spans D columns and V rows), 128-byte swizzle,
//   zero-filled past V and N. Thread 0 refills the stage of the chunk before,
//   as in ce_dw_sm90_kernel; no producer warp.
// - Two warpgroups, each owning 64 token rows and all 64 NB columns: NB f32
//   accumulators of 64 x 64 in registers, 32 NB per thread.
// - ds is formed in registers as the A operand, never stored: each warp reads
//   its 16 token rows x 16 vocab columns per depth step with a plain
//   ldmatrix (the stash rows are dx's rows, the vocab its depth), which lands
//   in wgmma's register A layout, turns each value into ds (one FFMA, one
//   ex2, one multiply by g) and multiplies with wgmma RS against the W chunk
//   read MN-major (m64n256k16 for a 256-column tile, else m64n64k16 per
//   column block). A thread's two rows are fixed for the whole vocab loop,
//   so their lse, g and label sit in registers from the start. A warpgroup
//   waits for its own products before it forms the next operand (anything
//   else made ptxas serialize every wgmma in ce_dw_sm90_kernel).
// - Columns >= V: the rows of W past V read as 0, so they add nothing as
//   long as ds there is finite. It is exp(-lse) g there (the stash reads 0),
//   which overflows for lse below about -88: the chunk that reaches past V
//   therefore still masks ds to 0 there. The one-hot term is subtracted only
//   by a warp whose 16 rows have a label in the chunk: rare, and that chunk
//   takes the checked path; every other chunk runs branch-free.
// - Split-K: at D 768 there are 32 x 3 = 96 output tiles for 132 SMs, so
//   the vocab is split (dx_split: 4 splits, 384 blocks, one per SM). The grid
//   runs D tiles fastest, then token tiles, then splits: the blocks in flight
//   stream one split's range of W (about 19 MB) together from L2, where W
//   (77 MB) would not fit whole.
constexpr int DX_ROWS = 128;     // tokens per block: 64 per warpgroup
constexpr int DX_CHUNK = 64;     // vocab columns per ring stage
constexpr int DX_STAGES = 4;
constexpr int DX_THREADS = 256;  // two warpgroups; thread 0 also issues the loads

template <int NB>
struct DxSmem {
  bf16 s[DX_STAGES][2 * BOX_BF16];
  bf16 w[DX_STAGES][NB * BOX_BF16];
  uint64_t full[DX_STAGES], empty[DX_STAGES];
};

// The tensor maps of ce_dx_sm90_kernel.
struct DxMaps {
  CUtensorMap s, w;
};

template <int NB>
constexpr int dx_smem() { return (int)sizeof(DxSmem<NB>) + 1024; }  // room to align to 1024

// The i-th vocab chunk of the block (vocab columns k0..) into ring stage
// i % DX_STAGES, as the stage's round i / DX_STAGES: wait until every thread
// freed the previous round.
template <int NB>
__device__ __forceinline__ void load_dx_chunk(DxSmem<NB>& sm, const DxMaps& maps, int i, int k0,
                                              int row0, int d0) {
  const int st = i % DX_STAGES, round = i / DX_STAGES;
  if (round > 0) sm90::mbar_wait(&sm.empty[st], (round - 1) & 1);
  sm90::mbar_expect_tx(&sm.full[st], (2 + NB) * sm90::BLOCK_BYTES);
#pragma unroll
  for (int b = 0; b < 2; ++b)
    sm90::tma_load_3d(sm.s[st] + b * BOX_BF16, &maps.s, &sm.full[st], k0, row0 + b * sm90::BOX, 0);
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
    sm90::tma_load_3d(sm.w[st] + cb * BOX_BF16, &maps.w, &sm.full[st], d0 + cb * sm90::BOX, k0, 0);
}

// This warp's A operand of one vocab chunk, in place: a[kk][r] holds the
// stash values of row g + 8 (r % 2) of the warp's 16 (g = lane / 4) at vocab
// columns col + 16 kk + 8 (r / 2) and the one after (col: the chunk's first
// + 2 (lane % 4)), as ldmatrix left them; each pair becomes bf16 ds. l2, gr,
// lab: lse / ln 2, g and the label of the thread's two rows. CHECKED masks
// the columns >= V (with a bit mask) and subtracts the one-hot label term;
// without it neither occurs in this warp's rows.
template <bool CHECKED>
__device__ __forceinline__ void dx_ds_operand(uint32_t (&a)[4][4], const float (&l2)[2],
                                              const float (&gr)[2], const int (&lab)[2], int col,
                                              int V) {
#pragma unroll
  for (int kk = 0; kk < DX_CHUNK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1, c = col + 16 * kk + 8 * (r >> 1);
      const float2 sc = unpack_bf16(a[kk][r]);
      float d[2] = {sc.x, sc.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = sm90::exp2_approx(fmaf(d[e], LOG2E, -l2[h]));
        if (CHECKED) {
          d[e] = (__int_as_float(__float_as_int(ex) & -(int)(c + e < V)) -
                  (c + e == lab[h] ? 1.f : 0.f)) * gr[h];
        } else {
          d[e] = ex * gr[h];
        }
      }
      a[kk][r] = pack_bf16(d[0], d[1]);
    }
}

template <int NB>
__global__ void __launch_bounds__(DX_THREADS, 1)
ce_dx_sm90_kernel(const __grid_constant__ DxMaps maps, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ gr,
                  float* __restrict__ part, int N, int V, int D, int chunks_per_split) {
  DxSmem<NB>& sm = *reinterpret_cast<DxSmem<NB>*>(sm90::smem_1024());
  const int d0 = blockIdx.x * NB * sm90::BOX, row0 = blockIdx.y * DX_ROWS;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nc = min((V + DX_CHUNK - 1) / DX_CHUNK - c0, chunks_per_split);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < DX_STAGES; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], DX_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader)
    for (int i = 0; i < DX_STAGES && i < nc; ++i)
      load_dx_chunk<NB>(sm, maps, i, (c0 + i) * DX_CHUNK, row0, d0);
  __syncwarp();

  // The statistics of this thread's two rows, g and g + 8 of its warp's 16
  // (none past N: g = 0 there)
  const int row = row0 + wg * sm90::BOX + warp * 16 + (lane >> 2);
  float l2[2], gg[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    l2[h] = r < N ? lse[r] * LOG2E : 0.f;
    gg[h] = r < N ? gr[r] : 0.f;
    lab[h] = r < N ? labels[r] : -1;
  }
  // ldmatrix: lane l gives row l % 8 of matrix l / 8 (rows + 8 (l / 8 % 2),
  // vocab + 8 (l / 16)), its 16-byte chunk found through the swizzle (row % 8
  // == l % 8)
  const int lrow = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  int lm_off[DX_CHUNK / 16];
#pragma unroll
  for (int kk = 0; kk < DX_CHUNK / 16; ++kk)
    lm_off[kk] = wg * sm90::BLOCK_BYTES + lrow * 128 + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4);

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  uint32_t a[DX_CHUNK / 16][4];  // the A operand of a chunk: ds, 16 token rows x 64 vocab
  for (int i = 0; i < nc; ++i) {
    const int st = i % DX_STAGES, k0 = (c0 + i) * DX_CHUNK;
    sm90::mbar_wait(&sm.full[st], (i / DX_STAGES) & 1);
    const unsigned char* s_tile = reinterpret_cast<const unsigned char*>(sm.s[st]);
#pragma unroll
    for (int kk = 0; kk < DX_CHUNK / 16; ++kk) sm90::ldmatrix_x4(a[kk], s_tile + lm_off[kk]);
    // a label of this warp's rows in the chunk, or columns past V
    const bool hit = (unsigned)(lab[0] - k0) < (unsigned)DX_CHUNK ||
                     (unsigned)(lab[1] - k0) < (unsigned)DX_CHUNK;
    const int col = k0 + 2 * (lane & 3);
    if (k0 + DX_CHUNK > V || __any_sync(~0u, hit))
      dx_ds_operand<true>(a, l2, gg, lab, col, V);
    else
      dx_ds_operand<false>(a, l2, gg, lab, col, V);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) sm90::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < DX_CHUNK / 16; ++kk) sm90::fence_regs(a[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DX_CHUNK / 16; ++kk) {
      if constexpr (NB == 4) {
        sm90::wgmma_rs_n256(acc, a[kk], sm90::desc_mn(sm.w[st], kk));
      } else {
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          sm90::wgmma_rs(acc[cb], a[kk], sm90::desc_mn(sm.w[st] + cb * BOX_BF16, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) sm90::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < DX_CHUNK / 16; ++kk) sm90::fence_regs(a[kk]);
    sm90::mbar_arrive(&sm.empty[st]);
    // chunk i - 1 + DX_STAGES into the stage of chunk i - 1, which every
    // thread freed a step ago
    if (leader && i >= 1 && i - 1 + DX_STAGES < nc)
      load_dx_chunk<NB>(sm, maps, i - 1 + DX_STAGES, (c0 + i - 1 + DX_STAGES) * DX_CHUNK, row0,
                        d0);
    __syncwarp();
  }

  // accumulator element 4 n + e: row g + 8 (e / 2) of the warp's 16, column
  // 8 n + 2 (lane % 4) + e % 2 of the column block
  float* out = part + (size_t)blockIdx.z * N * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= N) continue;
    float* o = out + (size_t)r * D + d0 + 2 * (lane & 3);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(o + cb * 64 + n * 8) =
            make_float2(acc[cb][4 * n + 2 * hh], acc[cb][4 * n + 2 * hh + 1]);
  }
}

// ------------------------------------------------------ forward, for Hopper
// ce_fwd_sm90_kernel<STASH>: one block per (token tile of 128 rows, vocab
// split); it walks the split's vocab tiles of 256 columns and writes the
// split's running (max, sum of exp, label logit) per row into
// part[0 | 1 | 2][split][row]; ce_fwd_combine_kernel forms lse and loss.
// - Bound at N 4096, D 768, V 50304: the product, 2 N V D = 316 GFLOP, 0.32
//   ms on the tensor cores. Beside it N V = 206 M exponentials (one per
//   score, about 0.06 ms of the special-function units) and, in stash mode,
//   the 412 MB bf16 stash written once (0.12 ms at 3.35 TB/s).
// - Tiles arrive by TMA into a ring of FWD_STAGES stages over the flat
//   sequence of (vocab tile, 64-wide D chunk) pairs, so the ring never drains
//   between vocab tiles (at D 64 a tile is one chunk): the x chunk (128 tokens
//   x 64, two 64-row boxes) and the W chunk (256 vocab rows x 64, four
//   64-row boxes one after another: one K-major operand whose 8-row groups
//   lie 1024 bytes apart), 128-byte swizzle. The x map spans N rows and the
//   W map V rows, so boxes past them read as 0. x is re-read for every vocab
//   tile, from L2 (6 MB at the main shape). Thread 0 refills each stage a
//   step after every thread freed it; no producer warp.
// - Two warpgroups, each owning 64 token rows and all 256 columns of the
//   tile: wgmma SS m64n256k16, x and W both K-major, 128 f32 accumulators a
//   thread. Both warpgroups read each stage, which is freed when both have.
//   A warpgroup keeps one batch of products in flight: it issues pair i's
//   before it waits for pair i - 1's (wgmma_wait<1>) and frees that stage,
//   and waits for all of them (wgmma_wait<0>) only at the end of a tile,
//   before it reads its accumulators. Nothing else writes them while a batch
//   is in flight, so ptxas keeps the products asynchronous. Waiting for each
//   pair's own batch instead left the tensor cores idle between batches: of
//   the schedules tried on an H100 at the main shape, it was the slowest.
// - The epilogue of a tile runs on the accumulators in place, in the
//   warpgroup that owns them, while the other warpgroup's products may run.
//   A thread holds two rows (g and g + 8 of its warp's 16) at 64 columns
//   each. Columns >= V are set to -1e30 only in the one tile that reaches
//   past V. The tile's row max (a quad shuffle) is folded into the running
//   max m; the thread's part of the running sum l takes exp(s - m) with one
//   FFMA and one ex2 per score (quad-summed once, at the end). A row's label
//   lies in at most one tile: a range check per row finds it, and only then
//   does the thread that holds its column pick it.
// - Stash mode: each warp writes its 16 rows of the tile in two halves of
//   128 columns through stmatrix into its own staging tile (two 16 x 64
//   boxes, 128-byte swizzle, 4 KB), which lane 0 stores with TMA; the stash
//   map spans V columns and N rows, so the store clips there by itself. The
//   first half is stored before the exponentials and the second after them,
//   so the wait for the first store to read its staging tile is hidden.
//   Direct 4-byte stores from the accumulator layout were clearly slower on
//   an H100 at the main shape; staging a whole tile would cost a ring stage,
//   and 3 stages starve the ring.
// - The split: token tiles alone give N / 128 = 32 blocks for 132 SMs, so
//   the vocab tiles are split over blocks (fwd_split: the fewest splits that
//   fill the card's resident blocks to 90 %, 4 splits of 50 tiles and 128
//   blocks at the main shape; 12 splits of 17 tiles in 2.9 waves were
//   slower on an H100). The grid runs token tiles fastest, so the blocks in flight
//   share x in L2.
constexpr int FWD_ROWS = 128;     // tokens per block: 64 per warpgroup
constexpr int FWD_COLS = 256;     // vocab columns per tile
constexpr int FWD_STAGES = 4;
constexpr int FWD_THREADS = 256;  // two warpgroups; thread 0 also issues the loads
constexpr int STASH_ROWS = 16;    // rows of a warp's stash staging box
constexpr int STASH_BOX = STASH_ROWS * sm90::BOX;  // bf16 of one 16 x 64 staging box

struct FwdSmem {
  bf16 x[FWD_STAGES][2 * BOX_BF16];
  bf16 w[FWD_STAGES][4 * BOX_BF16];
  bf16 stash[FWD_THREADS / 32][2 * STASH_BOX];  // per warp: 16 rows x 128 columns
  uint64_t full[FWD_STAGES], empty[FWD_STAGES];
};

// The tensor maps of ce_fwd_sm90_kernel; s (16 x 64 boxes) only in stash mode.
struct FwdMaps {
  CUtensorMap x, w, s;
};

constexpr int fwd_smem() { return (int)sizeof(FwdSmem) + 1024; }  // room to align to 1024

// Pair i of the block (vocab tile vt0 + i / nk, D chunk i % nk) into ring
// stage i % FWD_STAGES, as the stage's round i / FWD_STAGES: wait until
// every thread freed the previous round.
__device__ __forceinline__ void load_fwd_pair(FwdSmem& sm, const FwdMaps& maps, int i, int nk,
                                              int vt0, int row0) {
  const int st = i % FWD_STAGES, round = i / FWD_STAGES;
  const int col0 = (vt0 + i / nk) * FWD_COLS, k0 = (i % nk) * sm90::BOX;
  if (round > 0) sm90::mbar_wait(&sm.empty[st], (round - 1) & 1);
  sm90::mbar_expect_tx(&sm.full[st], 6 * sm90::BLOCK_BYTES);
#pragma unroll
  for (int b = 0; b < 2; ++b)
    sm90::tma_load_3d(sm.x[st] + b * BOX_BF16, &maps.x, &sm.full[st], k0, row0 + b * sm90::BOX, 0);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    sm90::tma_load_3d(sm.w[st] + b * BOX_BF16, &maps.w, &sm.full[st], k0, col0 + b * sm90::BOX, 0);
}

// Pair j's products are complete: free its stage. Thread 0 then refills the
// stage of pair j - 1, which every thread freed a step earlier, with pair
// j - 1 + FWD_STAGES.
__device__ __forceinline__ void release_fwd_pair(FwdSmem& sm, const FwdMaps& maps, int j,
                                                 int n_pairs, int nk, int vt0, int row0,
                                                 bool leader) {
  sm90::mbar_arrive(&sm.empty[j % FWD_STAGES]);
  if (leader && j >= 1 && j - 1 + FWD_STAGES < n_pairs)
    load_fwd_pair(sm, maps, j - 1 + FWD_STAGES, nk, vt0, row0);
  __syncwarp();
}

// Half HALF (columns 128 HALF .. + 127 of the tile at col0) of this warp's 16
// stash rows from srow, in bf16: stmatrix into the warp's staging tile, then
// lane 0 stores its two 16 x 64 boxes with TMA. The staging tile is written
// only after lane 0 saw the previous store read it.
template <int HALF>
__device__ __forceinline__ void store_stash_half(bf16* stg, const CUtensorMap* map,
                                                 const float (&acc)[4][32], int col0, int srow,
                                                 int lane) {
  if (lane == 0) sm90::bulk_wait_read();
  __syncwarp();
  // lane l gives row l % 8 of matrix l / 8 (rows + 8 (l / 8 % 2), columns
  // + 8 (l / 16)), its 16-byte chunk found through the swizzle
  const int rr = lane & 7, mi = lane >> 3;
  unsigned char* base = reinterpret_cast<unsigned char*>(stg) + (8 * (mi & 1) + rr) * 128;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float(&a)[32] = acc[2 * HALF + q];
#pragma unroll
    for (int n = 0; n < 8; n += 2)
      sm90::stmatrix_x4(base + q * 2 * STASH_BOX + (((n + (mi >> 1)) ^ rr) << 4),
                        pack_bf16(a[4 * n], a[4 * n + 1]), pack_bf16(a[4 * n + 2], a[4 * n + 3]),
                        pack_bf16(a[4 * n + 4], a[4 * n + 5]),
                        pack_bf16(a[4 * n + 6], a[4 * n + 7]));
  }
  sm90::fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      sm90::tma_store_3d(map, stg + q * STASH_BOX, col0 + (2 * HALF + q) * sm90::BOX, srow, 0);
    sm90::bulk_commit();
  }
}

// The epilogue of one vocab tile (columns col0..) on this thread's
// accumulators: acc[cb][4 n + 2 h + e] is the thread's row h (g + 8 h of its
// warp's 16), column col0 + 64 cb + 8 n + 2 t + e. Folds the tile into the
// running max m[h], this thread's part of the sum l[h] and, where the row's
// label lies in the tile, the label logit lbl[h].
__device__ __forceinline__ void fwd_epilogue(float (&acc)[4][32], float (&m)[2], float (&l)[2],
                                             float (&lbl)[2], const int (&lab)[2], int col0,
                                             int t, int V) {
  if (col0 + FWD_COLS > V) {
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (col0 + 64 * cb + 8 * (i >> 2) + 2 * t + (i & 1) >= V) acc[cb][i] = NEG_INF;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lab[h] - col0;  // the label's column in the tile
    if ((unsigned)c < (unsigned)FWD_COLS && ((c >> 1) & 3) == t) {
      float v = 0.f;
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (64 * cb + 8 * n + 2 * t + e == c) v = acc[cb][4 * n + 2 * h + e];
      lbl[h] = v;
    }
    float mx[4], sum[4];
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      mx[cb] = acc[cb][2 * h];
#pragma unroll
      for (int i = 1; i < 16; ++i) mx[cb] = fmaxf(mx[cb], acc[cb][4 * (i >> 1) + 2 * h + (i & 1)]);
    }
    const float m_new = quad_max(fmaxf(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])), m[h]));
    const float ml = m_new * LOG2E;
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      sum[cb] = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        sum[cb] += sm90::exp2_approx(fmaf(acc[cb][4 * (i >> 1) + 2 * h + (i & 1)], LOG2E, -ml));
    }
    l[h] = l[h] * sm90::exp2_approx((m[h] - m_new) * LOG2E) + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[h] = m_new;
  }
}

template <bool STASH>
__global__ void __launch_bounds__(FWD_THREADS, 1)
ce_fwd_sm90_kernel(const __grid_constant__ FwdMaps maps, const int* __restrict__ labels,
                   float* __restrict__ part, int N, int V, int D, int tiles_per_split) {
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(sm90::smem_1024());
  const int row0 = blockIdx.x * FWD_ROWS, split = blockIdx.y, S = gridDim.y;
  const int vt0 = split * tiles_per_split;
  const int nt = min((V + FWD_COLS - 1) / FWD_COLS - vt0, tiles_per_split);
  const int nk = D / sm90::BOX, n_pairs = nt * nk;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], FWD_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader)
    for (int i = 0; i < FWD_STAGES && i < n_pairs; ++i) load_fwd_pair(sm, maps, i, nk, vt0, row0);
  __syncwarp();

  // This thread's rows: row and row + 8 (none past N: label -1 there)
  const int srow = row0 + wg * sm90::BOX + warp * 16, row = srow + (lane >> 2);
  bf16* stg = sm.stash[threadIdx.x >> 5];
  int lab[2];
  float m[2], l[2], lbl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lab[h] = row + 8 * h < N ? labels[row + 8 * h] : -1;
    m[h] = NEG_INF;
    l[h] = 0.f;
    lbl[h] = 0.f;
  }
  float acc[4][32];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  for (int vt = 0, i = 0; vt < nt; ++vt) {
    for (int kc = 0; kc < nk; ++kc, ++i) {
      const int st = i % FWD_STAGES;
      sm90::mbar_wait(&sm.full[st], (i / FWD_STAGES) & 1);
      const bf16* x_rows = sm.x[st] + wg * BOX_BF16;  // this warpgroup's 64 rows
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < sm90::BOX / 16; ++kk)
        sm90::wgmma_ss_n256(acc, sm90::desc_k(x_rows, kk), sm90::desc_k(sm.w[st], kk),
                            kc > 0 || kk > 0);
      sm90::wgmma_commit();
      if (kc > 0) {  // pair i's products in flight, pair i - 1's done
        sm90::wgmma_wait<1>();
        release_fwd_pair(sm, maps, i - 1, n_pairs, nk, vt0, row0, leader);
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    release_fwd_pair(sm, maps, i - 1, n_pairs, nk, vt0, row0, leader);
    const int col0 = (vt0 + vt) * FWD_COLS;
    if (STASH) store_stash_half<0>(stg, &maps.s, acc, col0, srow, lane);
    fwd_epilogue(acc, m, l, lbl, lab, col0, t, V);
    if (STASH) store_stash_half<1>(stg, &maps.s, acc, col0, srow, lane);
  }
  if (STASH && lane == 0) sm90::bulk_wait();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    const float b = quad_sum(lbl[h]);  // one lane of the quad holds the label column
    const int r = row + 8 * h;
    if (t == 0 && r < N) {
      part[(size_t)split * N + r] = m[h];
      part[(size_t)(S + split) * N + r] = sum;
      part[(size_t)(2 * S + split) * N + r] = b;
    }
  }
}

// One thread per row: lse = M + log sum_s l_s exp(m_s - M), loss = lse - label logit.
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part, float* __restrict__ loss,
                                      float* __restrict__ lse, int N, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float M = NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part[(size_t)s * N + r]);
  float L = 0.f, b = 0.f;
  for (int s = 0; s < S; ++s) {
    L += part[(size_t)(S + s) * N + r] * __expf(part[(size_t)s * N + r] - M);
    b += part[(size_t)(2 * S + s) * N + r];
  }
  const float z = M + logf(L);
  lse[r] = z;
  loss[r] = z - b;
}

inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// 64-column blocks per D tile of the stash-mode Hopper kernels: 256 columns
// where D allows, else 192, 128 or 64.
inline int sm90_blocks(int D) {
  return D % 256 == 0 ? 4 : D % 192 == 0 ? 3 : D % 128 == 0 ? 2 : 1;
}

// Blocks of `kernel` at `threads` and `smem` bytes of dynamic shared memory
// that the current device holds at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
  *slots = per_sm * sms;
  return e;
}

// Resident blocks of ce_dx_sm90_kernel<NB>, after allowing it its dynamic
// shared memory (which the launch needs as well).
template <int NB>
cudaError_t dx_sm90_slots(int* slots) {
  const cudaError_t e = cudaFuncSetAttribute(
      ce_dx_sm90_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, dx_smem<NB>());
  if (e != cudaSuccess) return e;
  return resident_blocks(ce_dx_sm90_kernel<NB>, DX_THREADS, dx_smem<NB>(), slots);
}

// Units of a reduction axis per block, when n_units are split over blocks
// beside n_tiles output tiles: the first split count that fills at least
// `waves` waves of resident blocks with the last at least 90 % full, else
// the one whose last wave is fullest (ties: the fewer splits).
int units_per_split(int n_units, int n_tiles, int slots, int waves) {
  int best_per = n_units;
  double best_fill = -1.0;
  const int cap = 8 * slots / n_tiles + 1;
  const int max_splits = n_units < cap ? n_units : cap;
  for (int splits = 1; splits <= max_splits; ++splits) {
    const int per = cdiv(n_units, splits);
    const long long blocks = (long long)cdiv(n_units, per) * n_tiles;
    const double fill = (double)blocks / (double)(cdiv(blocks, slots) * (long long)slots);
    if (blocks >= (long long)waves * slots && fill >= 0.9) return per;
    if (fill > best_fill || (fill == best_fill && per > best_per)) {
      best_fill = fill;
      best_per = per;
    }
  }
  return best_per;
}

// Resident blocks of ce_fwd_sm90_kernel<STASH>, after allowing it its
// dynamic shared memory (which the launch needs as well).
template <bool STASH>
cudaError_t fwd_sm90_slots(int* slots) {
  const cudaError_t e = cudaFuncSetAttribute(
      ce_fwd_sm90_kernel<STASH>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem());
  if (e != cudaSuccess) return e;
  return resident_blocks(ce_fwd_sm90_kernel<STASH>, FWD_THREADS, fwd_smem(), slots);
}

// The vocab split of ce_fwd: vocab tiles per block and the number of
// splits, the fewest that fill the resident blocks to 90 % (long blocks
// beat more waves). It also allows the kernel its shared memory.
cudaError_t fwd_split(int N, int V, bool stash, int* tiles_per_split, int* splits) {
  int slots = 0;
  const cudaError_t e = stash ? fwd_sm90_slots<true>(&slots) : fwd_sm90_slots<false>(&slots);
  if (e != cudaSuccess) return e;
  const int units = cdiv(V, FWD_COLS);
  *tiles_per_split = units_per_split(units, cdiv(N, FWD_ROWS), slots, 0);
  *splits = cdiv(units, *tiles_per_split);
  return cudaSuccess;
}

// The vocab split of ce_dx: vocab chunks per block (of DX_CHUNK for
// ce_dx_sm90_kernel in stash mode, of BK for ce_dx_kernel) and the number of
// splits. In stash mode it also allows the kernel its shared memory.
cudaError_t dx_split(int N, int V, int D, bool stash, int* chunks_per_split, int* splits) {
  int slots = 0, chunk = BK, tiles = cdiv(N, BM) * cdiv(D, BN);
  cudaError_t e;
  if (stash) {
    const int nb = sm90_blocks(D);
    const auto slots_of = nb == 4   ? &dx_sm90_slots<4>
                          : nb == 3 ? &dx_sm90_slots<3>
                          : nb == 2 ? &dx_sm90_slots<2>
                                    : &dx_sm90_slots<1>;
    e = slots_of(&slots);
    chunk = DX_CHUNK;
    tiles = cdiv(N, DX_ROWS) * (D / (nb * sm90::BOX));
  } else {
    e = resident_blocks(ce_dx_kernel, THREADS_BWD, 0, &slots);
  }
  if (e != cudaSuccess) return e;
  const int units = cdiv(V, chunk);
  *chunks_per_split = units_per_split(units, tiles, slots, 2);
  *splits = cdiv(units, *chunks_per_split);
  return cudaSuccess;
}

// Launch ce_dx_sm90_kernel<NB>, which dx_split allowed its shared memory.
template <int NB>
int launch_dx_sm90(const DxMaps& maps, const void* labels, const void* lse, const void* g,
                   void* part, int N, int V, int D, int chunks_per_split, int splits,
                   cudaStream_t s) {
  const dim3 grid(D / (NB * sm90::BOX), cdiv(N, DX_ROWS), splits);  // D tiles fastest
  ce_dx_sm90_kernel<NB><<<grid, DX_THREADS, dx_smem<NB>(), s>>>(
      maps, (const int*)labels, (const float*)lse, (const float*)g, (float*)part, N, V, D,
      chunks_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch (`part`) that ce_fwd takes for these shapes on the
// current device; a CUDA error as a negative number.
long long ce_fwd_scratch(int N, int V, int stash) {
  int tps = 0, splits = 0;
  const cudaError_t e = fwd_split(N, V, stash != 0, &tps, &splits);
  if (e != cudaSuccess) return -(long long)e;
  return 3LL * splits * N;
}

// Floats of scratch (`part`) that ce_dx takes, as ce_fwd_scratch.
long long ce_dx_scratch(int N, int V, int D, int stash) {
  int cps = 0, splits = 0;
  const cudaError_t e = dx_split(N, V, D, stash != 0, &cps, &splits);
  if (e != cudaSuccess) return -(long long)e;
  return (long long)splits * N * D;
}

// loss, lse (N,) f32; the stash (N, ld_s) bf16 when `stash` is not null;
// part: ce_fwd_scratch(N, V, stash != null) f32 of scratch, which holds
// per vocab split the partial (max, sum, label logit) rows. x, W and the
// stash 16-byte aligned.
int ce_fwd(const void* x, const void* w, const void* labels, void* stash, long long ld_s,
           void* part, void* loss, void* lse, int N, int V, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tiles_per_split = 0, S = 0;
  int err = (int)fwd_split(N, V, stash != nullptr, &tiles_per_split, &S);
  if (err) return err;
  FwdMaps maps = {};
  if ((err = sm90::encode_tile_map(&maps.x, x, D, N, 1, D, (long long)N * D)) ||
      (err = sm90::encode_tile_map(&maps.w, w, D, V, 1, D, (long long)V * D)) ||
      (stash && (err = sm90::encode_tile_map(&maps.s, stash, V, N, 1, ld_s, (long long)N * ld_s,
                                             STASH_ROWS))))
    return err;
  const dim3 grid(cdiv(N, FWD_ROWS), S);  // token tiles fastest
  if (stash)
    ce_fwd_sm90_kernel<true><<<grid, FWD_THREADS, fwd_smem(), s>>>(
        maps, (const int*)labels, (float*)part, N, V, D, tiles_per_split);
  else
    ce_fwd_sm90_kernel<false><<<grid, FWD_THREADS, fwd_smem(), s>>>(
        maps, (const int*)labels, (float*)part, N, V, D, tiles_per_split);
  if ((err = (int)cudaGetLastError())) return err;
  ce_fwd_combine_kernel<<<cdiv(N, 256), 256, 0, s>>>((const float*)part, (float*)loss,
                                                     (float*)lse, N, S);
  return (int)cudaGetLastError();
}

// dx (N, D) bf16; part: ce_dx_scratch(N, V, D, stash != null) f32 of
// scratch, one (N, D) partial sum per vocab split. Stash mode
// (ce_dx_sm90_kernel, D tiles as ce_dw's) when `stash` is not null; W and
// the stash 16-byte aligned.
int ce_dx(const void* x, const void* w, const void* stash, long long ld_s, const void* labels,
          const void* lse, const void* g, void* part, void* dx, int N, int V, int D,
          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int chunks_per_split = 0, KS = 0;
  int err = (int)dx_split(N, V, D, stash != nullptr, &chunks_per_split, &KS);
  if (err) return err;
  if (stash) {
    DxMaps maps;
    if ((err = sm90::encode_tile_map(&maps.s, stash, V, N, 1, ld_s, (long long)N * ld_s)) ||
        (err = sm90::encode_tile_map(&maps.w, w, D, V, 1, D, (long long)V * D)))
      return err;
    const int nb = sm90_blocks(D);
    const auto launch = nb == 4   ? &launch_dx_sm90<4>
                        : nb == 3 ? &launch_dx_sm90<3>
                        : nb == 2 ? &launch_dx_sm90<2>
                                  : &launch_dx_sm90<1>;
    err = launch(maps, labels, lse, g, part, N, V, D, chunks_per_split, KS, s);
  } else {
    ce_dx_kernel<<<dim3(cdiv(D, BN), cdiv(N, BM), KS), THREADS_BWD, 0, s>>>(
        (const bf16*)x, (const bf16*)w, (const int*)labels, (const float*)lse, (const float*)g,
        (float*)part, N, V, D, chunks_per_split);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  const long long n = (long long)N * D;
  const int blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  ce_dx_reduce_kernel<<<blocks, 256, 0, s>>>((const float*)part, (bf16*)dx, n, KS);
  return (int)cudaGetLastError();
}

// dW (V, D) f32. Stash mode (ce_dw_sm90_kernel, D tiles of sm90_blocks(D)
// 64-column blocks) when `stash` is not null; x, the stash, labels, lse and
// g 16-byte aligned.
int ce_dw(const void* x, const void* w, const void* stash, long long ld_s, const void* labels,
          const void* lse, const void* g, void* dw, int N, int V, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!stash) {
    ce_dw_kernel<<<dim3(cdiv(D, BN), cdiv(V, BM)), THREADS_BWD, 0, s>>>(
        (const bf16*)x, (const bf16*)w, (const int*)labels, (const float*)lse, (const float*)g,
        (float*)dw, N, V, D);
    return (int)cudaGetLastError();
  }
  DwMaps maps;
  int err;
  if ((err = sm90::encode_tile_map(&maps.s, stash, V, N, 1, ld_s, (long long)N * ld_s)) ||
      (err = sm90::encode_tile_map(&maps.x, x, D, N, 1, D, (long long)N * D)) ||
      (err = sm90::encode_vec_map(&maps.lse, lse, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) ||
      (err = sm90::encode_vec_map(&maps.g, g, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) ||
      (err = sm90::encode_vec_map(&maps.label, labels, N, CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return err;
  const int nb = sm90_blocks(D);
  const auto launch = nb == 4   ? &launch_dw_sm90<4>
                      : nb == 3 ? &launch_dw_sm90<3>
                      : nb == 2 ? &launch_dw_sm90<2>
                                : &launch_dw_sm90<1>;
  return launch(maps, dw, N, V, D, s);
}

}  // extern "C"
