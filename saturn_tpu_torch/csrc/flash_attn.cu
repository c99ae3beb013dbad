// Causal / full flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of saturn_tpu/ops/flash.py:
//   fwd_kernel  <- _fwd        (pallas_call at flash.py:132, kernel _fwd_kernel)
//   dq_kernel   <- _bwd        (pallas_call at flash.py:250, kernel _dq_kernel)
//   dkv_kernel  <- _bwd        (pallas_call at flash.py:276, kernel _dkv_kernel)
//
// What bounds them on an H100: at head dim 64 and T = 512 one (bh, 64-row)
// tile does 2 * 64 * 512 * 64 * 2 FLOPs of products per kernel pass against
// 2 * 512 * 64 * 2 bytes of k/v, about 64 FLOPs per byte read once, below
// the card's ~295 FLOPs/byte ridge in bf16: on paper the kernels are bound by
// operations only at long T and by bytes at short T. In practice a simple
// kernel is bound by neither: it is bound by the throughput of its mma.sync
// instructions and by its unpipelined tile loads.
//
// What the design does about it: the TPU kernels carry softmax state across
// a sequential grid axis in VMEM scratch. Here each thread block owns one
// (bh, 64-row q tile) [fwd, dQ] or one (bkv, 64-row kv tile) [dK/dV] and walks
// the other axis in a loop, with the walked tiles staged in shared memory and
// the running state (m, l, the output accumulator) kept in f32 registers, so
// nothing of size T x T ever reaches device memory. Products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate); each of
// the 4 warps owns 16 rows of the tile. Tiles above the causal diagonal are
// skipped. Grouped-query attention is native: the q-head -> kv-head map is
// computed in the kernel, and the dK/dV kernel sums the group members in its
// own loop, so dk/dv come back at KV heads with no atomics and a result that
// does not depend on scheduling. Pipelining (cp.async / TMA) and wgmma are
// left for a later change.
//
// Layout: q, o, do, dq are (B*H, T, D) and k, v, dk, dv are (B*KV, T, D),
// bf16, row stride `*_st` and head stride `*_sh` in elements, rows 16-byte
// aligned. lse and delta are (B*H, T) f32, contiguous. T % 64 == 0,
// D in {64, 128}. Each launcher returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;             // q rows and kv rows per tile
constexpr int WARPS = 4;             // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;               // bf16 of row padding: 16 bytes, no bank conflicts
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

// acc (16 x N) += A (16 x K) * B^T, with A (16 rows) and B (N rows) both
// row-major over K in shared memory. acc[n] is the n-th 16 x 8 accumulator
// tile in the mma.sync C layout: element e of lane (g = lane/4, t = lane%4)
// sits at row g + 8 * (e / 2), column 8 n + 2 t + e % 2.
template <int N, int K>
__device__ __forceinline__ void mma_smem(float (*acc)[4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* pa = A + g * lda + k0 + 2 * t;
    uint32_t a[4] = {ld32(pa), ld32(pa + 8 * lda), ld32(pa + 8),
                     ld32(pa + 8 * lda + 8)};
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const bf16* pb = B + (n * 8 + g) * ldb + k0 + 2 * t;
      mma16816(acc[n], a, ld32(pb), ld32(pb + 8));
    }
  }
}

// acc (16 x N) += S (16 x K) * B^T, with S held in registers as K/8
// accumulator tiles (rounded to bf16 here: the C layout of two neighbouring
// 16 x 8 tiles is the A layout of one 16 x 16 operand) and B (N rows)
// row-major over K in shared memory.
template <int N, int K>
__device__ __forceinline__ void mma_regs(float (*acc)[4], float (*s)[4],
                                         const bf16* B, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                     pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                     pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                     pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const bf16* pb = B + (n * 8 + g) * ldb + kk * 16 + 2 * t;
      mma16816(acc[n], a, ld32(pb), ld32(pb + 8));
    }
  }
}

// TILE x D rows of a (T, D) matrix (row stride st) -> shared memory at row
// stride D + PAD, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int st) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * st + c);
  }
}

// The same tile stored transposed: dst[c][r] at row stride TILE + PAD.
template <int D>
__device__ __forceinline__ void load_tile_t(bf16* dst, const bf16* src, int st) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * st + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (TILE + PAD) + r] = e[j];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write a warp's 16 x D accumulator (times row factors f0 for row g, f1 for
// row g + 8) as bf16 rows; `out` points at the warp's first row (stride st).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int st, float (*acc)[4],
                                           float f0, float f1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + (size_t)g * st + c) =
        pack_bf16(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<uint32_t*>(out + (size_t)(g + 8) * st + c) =
        pack_bf16(acc[n][2] * f1, acc[n][3] * f1);
  }
}

constexpr int tile_bytes(int D) { return TILE * (D + PAD) * 2; }
constexpr int tile_t_bytes(int D) { return D * (TILE + PAD) * 2; }

template <int D>
constexpr int fwd_smem() { return 2 * tile_bytes(D) + tile_t_bytes(D); }
template <int D>
constexpr int dq_smem() { return 4 * tile_bytes(D) + tile_t_bytes(D); }
template <int D>
constexpr int dkv_smem() {
  return 4 * tile_bytes(D) + 2 * tile_t_bytes(D) + 2 * TILE * 4;
}

// ------------------------------------------------------------------ forward
// One block per (q tile, bh). o = softmax(scale q k^T) v, lse = m + log l.
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, long long q_sh, int q_st, long long kv_sh,
           int kv_st, int T, int H, int KV, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE * (D + PAD);
  bf16* sVt = sK + TILE * (D + PAD);

  const int iq = blockIdx.x, bh = blockIdx.y;
  const int bkv = (bh / H) * KV + (bh % H) / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qh = q + bh * q_sh;
  const bf16* kh = k + bkv * kv_sh;
  const bf16* vh = v + bkv * kv_sh;

  load_tile<D>(sQ, qh + (size_t)iq * TILE * q_st, q_st);
  const bf16* sQw = sQ + warp * 16 * (D + PAD);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kv = causal ? iq + 1 : T / TILE;
  for (int jk = 0; jk < n_kv; ++jk) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sK, kh + (size_t)jk * TILE * kv_st, kv_st);
    load_tile_t<D>(sVt, vh + (size_t)jk * TILE * kv_st, kv_st);
    __syncthreads();

    float s[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_smem<TILE, D>(s, sQw, D + PAD, sK, D + PAD, lane);

    const bool diag = causal && jk == iq;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (diag && n * 8 + 2 * t + (e & 1) > warp * 16 + g + 8 * (e >> 1)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float corr0 = __expf(m[0] - mx[0]), corr1 = __expf(m[1] - mx[1]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
    l[0] = corr0 * l[0] + quad_sum(rs[0]);
    l[1] = corr1 * l[1] + quad_sum(rs[1]);
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    mma_regs<D, TILE>(acc, s, sVt, TILE + PAD, lane);
  }

  const int wrow = iq * TILE + warp * 16, row = wrow + g;
  store_rows<D>(o + bh * q_sh + (size_t)wrow * q_st, q_st, acc, 1.f / l[0],
                1.f / l[1], lane);
  if (t == 0) {
    lse[(size_t)bh * T + row] = m[0] + logf(l[0]);
    lse[(size_t)bh * T + row + 8] = m[1] + logf(l[1]);
  }
}

// ----------------------------------------------------------------------- dQ
// One block per (q tile, bh). dq = scale * sum_kv P o (dP - delta) k, with
// P = exp(scale q k^T - lse) and dP = do v^T.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, long long q_sh, int q_st, long long kv_sh,
          int kv_st, int T, int H, int KV, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE * (D + PAD);
  bf16* sK = sdO + TILE * (D + PAD);
  bf16* sV = sK + TILE * (D + PAD);
  bf16* sKt = sV + TILE * (D + PAD);

  const int iq = blockIdx.x, bh = blockIdx.y;
  const int bkv = (bh / H) * KV + (bh % H) / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kh = k + bkv * kv_sh;
  const bf16* vh = v + bkv * kv_sh;

  load_tile<D>(sQ, q + bh * q_sh + (size_t)iq * TILE * q_st, q_st);
  load_tile<D>(sdO, dout + bh * q_sh + (size_t)iq * TILE * q_st, q_st);
  const bf16* sQw = sQ + warp * 16 * (D + PAD);
  const bf16* sdOw = sdO + warp * 16 * (D + PAD);
  const int wrow = iq * TILE + warp * 16, row = wrow + g;
  const float lse_r[2] = {lse[(size_t)bh * T + row], lse[(size_t)bh * T + row + 8]};
  const float del_r[2] = {delta[(size_t)bh * T + row], delta[(size_t)bh * T + row + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kv = causal ? iq + 1 : T / TILE;
  for (int jk = 0; jk < n_kv; ++jk) {
    __syncthreads();
    load_tile<D>(sK, kh + (size_t)jk * TILE * kv_st, kv_st);
    load_tile<D>(sV, vh + (size_t)jk * TILE * kv_st, kv_st);
    load_tile_t<D>(sKt, kh + (size_t)jk * TILE * kv_st, kv_st);
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_smem<TILE, D>(s, sQw, D + PAD, sK, D + PAD, lane);
    mma_smem<TILE, D>(dp, sdOw, D + PAD, sV, D + PAD, lane);

    const bool diag = causal && jk == iq;
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (diag && n * 8 + 2 * t + (e & 1) > warp * 16 + g + 8 * (e >> 1)) x = NEG_INF;
        const float p = __expf(x - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - del_r[e >> 1]);
      }
    }
    mma_regs<D, TILE>(acc, s, sKt, TILE + PAD, lane);
  }
  store_rows<D>(dq + bh * q_sh + (size_t)wrow * q_st, q_st, acc, scale, scale, lane);
}

// -------------------------------------------------------------------- dK/dV
// One block per (kv tile, bkv); each warp owns 16 kv rows. Loops over the
// rep = H / KV q heads of the group and the q tiles at or below the diagonal:
// dv = sum P^T do, dk = scale * sum (P o (dP - delta))^T q.
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, long long q_sh,
           int q_st, long long kv_sh, int kv_st, int T, int H, int KV,
           float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE * (D + PAD);
  bf16* sQ = sV + TILE * (D + PAD);
  bf16* sdO = sQ + TILE * (D + PAD);
  bf16* sQt = sdO + TILE * (D + PAD);
  bf16* sdOt = sQt + D * (TILE + PAD);
  float* sLse = reinterpret_cast<float*>(sdOt + D * (TILE + PAD));
  float* sDel = sLse + TILE;

  const int jk = blockIdx.x, bkv = blockIdx.y;
  const int rep = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<D>(sK, k + bkv * kv_sh + (size_t)jk * TILE * kv_st, kv_st);
  load_tile<D>(sV, v + bkv * kv_sh + (size_t)jk * TILE * kv_st, kv_st);
  const bf16* sKw = sK + warp * 16 * (D + PAD);
  const bf16* sVw = sV + warp * 16 * (D + PAD);
  const int krow = warp * 16 + g;  // row within the kv tile

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  for (int gi = 0; gi < rep; ++gi) {
    const int bh = (bkv / KV) * H + (bkv % KV) * rep + gi;
    const bf16* qh = q + bh * q_sh;
    const bf16* doh = dout + bh * q_sh;
    for (int iq = causal ? jk : 0; iq < T / TILE; ++iq) {
      __syncthreads();
      load_tile<D>(sQ, qh + (size_t)iq * TILE * q_st, q_st);
      load_tile<D>(sdO, doh + (size_t)iq * TILE * q_st, q_st);
      load_tile_t<D>(sQt, qh + (size_t)iq * TILE * q_st, q_st);
      load_tile_t<D>(sdOt, doh + (size_t)iq * TILE * q_st, q_st);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        sLse[i] = lse[(size_t)bh * T + iq * TILE + i];
        sDel[i] = delta[(size_t)bh * T + iq * TILE + i];
      }
      __syncthreads();

      // st = S^T (kv rows x q columns), dpt = dP^T
      float st[TILE / 8][4], dpt[TILE / 8][4];
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
      mma_smem<TILE, D>(st, sKw, D + PAD, sQ, D + PAD, lane);
      mma_smem<TILE, D>(dpt, sVw, D + PAD, sdO, D + PAD, lane);

      const bool diag = causal && iq == jk;
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);  // q column within the tile
          float x = st[n][e] * scale;
          if (diag && qc < krow + 8 * (e >> 1)) x = NEG_INF;
          const float p = __expf(x - sLse[qc]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDel[qc]);
        }
      }
      mma_regs<D, TILE>(dv_acc, st, sdOt, TILE + PAD, lane);
      mma_regs<D, TILE>(dk_acc, dpt, sQt, TILE + PAD, lane);
    }
  }
  const size_t off = bkv * kv_sh + (size_t)(jk * TILE + warp * 16) * kv_st;
  store_rows<D>(dk + off, kv_st, dk_acc, scale, scale, lane);
  store_rows<D>(dv + off, kv_st, dv_acc, 1.f, 1.f, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BH,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  const dim3 grid(T / TILE, BH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    if ((err = allow_smem(fwd_kernel<64>, fwd_smem<64>())) != cudaSuccess) return (int)err;
    fwd_kernel<64><<<grid, THREADS, fwd_smem<64>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        q_sh, q_st, kv_sh, kv_st, T, H, KV, scale, causal);
  } else if (D == 128) {
    if ((err = allow_smem(fwd_kernel<128>, fwd_smem<128>())) != cudaSuccess) return (int)err;
    fwd_kernel<128><<<grid, THREADS, fwd_smem<128>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        q_sh, q_st, kv_sh, kv_st, T, H, KV, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, long long q_sh,
             int q_st, long long kv_sh, int kv_st, int BH, int T, int D, int H,
             int KV, float scale, int causal, void* stream) {
  const dim3 grid(T / TILE, BH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    if ((err = allow_smem(dq_kernel<64>, dq_smem<64>())) != cudaSuccess) return (int)err;
    dq_kernel<64><<<grid, THREADS, dq_smem<64>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq, q_sh, q_st, kv_sh,
        kv_st, T, H, KV, scale, causal);
  } else if (D == 128) {
    if ((err = allow_smem(dq_kernel<128>, dq_smem<128>())) != cudaSuccess) return (int)err;
    dq_kernel<128><<<grid, THREADS, dq_smem<128>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq, q_sh, q_st, kv_sh,
        kv_st, T, H, KV, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BKV,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  const dim3 grid(T / TILE, BKV);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    if ((err = allow_smem(dkv_kernel<64>, dkv_smem<64>())) != cudaSuccess) return (int)err;
    dkv_kernel<64><<<grid, THREADS, dkv_smem<64>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, q_sh,
        q_st, kv_sh, kv_st, T, H, KV, scale, causal);
  } else if (D == 128) {
    if ((err = allow_smem(dkv_kernel<128>, dkv_smem<128>())) != cudaSuccess) return (int)err;
    dkv_kernel<128><<<grid, THREADS, dkv_smem<128>(), s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, q_sh,
        q_st, kv_sh, kv_st, T, H, KV, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
