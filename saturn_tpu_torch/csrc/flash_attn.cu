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
// bytes at the training shapes and by operations only at long T. In practice
// neither: a block walks its tiles in a chain of dependent steps (product,
// softmax, product), and at the training shapes (walks of 1 to 8 steps) the
// latency of that chain and of a block's first loads bounds them. At long T
// the forward is bound by its exponentials (one MUFU ex2 per score, about as
// many cycles per tile as the tile's products take on the tensor cores) and
// by how well the resident blocks interleave the two.
//
// Common to all three: the TPU kernels carry softmax state across a
// sequential grid axis in VMEM scratch. Here a thread block owns one (bh,
// 64-row q tile) [fwd, dQ] or one (bkv, 64-row kv tile) [dK/dV] and walks the
// other axis in a loop, with the running state (m, l, the accumulators) in
// f32 registers, so nothing of size T x T reaches device memory. Tiles above
// the causal diagonal are skipped. Grouped-query attention is native: the
// q-head -> kv-head map is computed in the kernel, and the dK/dV kernel sums
// the group members in its own loop, so dk/dv come back at KV heads with no
// atomics and a result that does not depend on scheduling.
//
// All three share one Hopper design (helpers in sm90.cuh):
// - Tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle) into rings
//   of STAGES shared-memory stages completed on mbarriers; the warpgroup
//   frees a stage through a second mbarrier, and its thread 0 then reloads
//   it with the tile STAGES ahead, so loads run under the math of the tiles
//   before. The forward's and dQ's K and V tiles have rings of their own (a
//   stage of each frees once its last product is done). There is no
//   producer warp: it would hold a consumer's register count while it
//   waits, and a block of 128 threads instead of 160 lets 4 forward or dQ
//   blocks (3 dK/dV blocks) share an SM at D 64 instead of 3 (2).
// - One warpgroup per 64-row tile runs the products on wgmma m64n64k16
//   (bf16 in, f32 accumulate): S = Q K^T (fwd, dQ), dP = dO V^T (dQ), S^T =
//   K Q^T and dP^T = V dO^T (dK/dV) with both operands read K-major from
//   shared memory; O += P V (fwd), dQ += dS K (dQ), dV += P^T dO and dK +=
//   dS^T Q (dK/dV) with P, dS, P^T and dS^T as the register A operand (the
//   f32 accumulator rounded to bf16 pairs) and V, K, dO and Q read MN-major
//   through the transpose bit of the B descriptor: no transposed copy of any
//   tile is made.
// - The forward shortens its chain: step j issues S_j = Q K_j^T and O +=
//   P_{j-1} V_{j-1} together and runs the softmax of S_j while the second is
//   in flight; each exponential is one FFMA and one ex2 (the scale folded into
//   log2 units), row maxima and sums are trees, and a row's sum is reduced
//   across its 4 threads once, at the end. dQ keeps the plain chain (the
//   score products, wait, dS, dQ += dS K, wait): its other resident blocks
//   fill the waits, and the shortened chain would hold each K stage a step
//   longer, which needs a third K stage (a block fewer per SM at D 128) and
//   more live registers.
// - Heavy tiles first: causal blocks are launched longest walk first (fwd
//   and dQ: the last q tiles; dK/dV: the first kv tile), so the long blocks
//   do not start last. The forward and dQ order their blocks in groups of
//   heads whose k and v fit in half the L2 together, which keeps them there
//   at large B * H.
// - Q (forward), Q and dO (dQ) or K and V (dK/dV) are loaded once per block;
//   the dK/dV walk is over (group member x q tile), each stage bringing the Q
//   and dO tiles and their lse and delta rows (bulk copies); dQ reads each
//   thread's two lse and delta values once.
//
// Layout: q, o, do, dq are (B*H, T, D) and k, v, dk, dv are (B*KV, T, D),
// bf16, row stride `*_st` and head stride `*_sh` in elements, rows and base
// addresses 16-byte aligned. lse and delta are (B*H, T) f32, contiguous,
// 16-byte aligned. T % 64 == 0, D in {64, 128}. Each launcher returns a
// cudaError_t value as an int (a tensor map it could not encode, a refused
// launch); a deadlocked stage ring ends its kernel with an illegal-address
// error (sm90::mbar_wait) rather than hanging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;             // q rows and kv rows per tile
constexpr float NEG_INF = -1e30f;    // the mask value of the Pallas kernels
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -------------------------------------------------------- TMA rings, wgmma
constexpr int STAGES = 2;          // depth of the rings of walked tiles
constexpr int WG_THREADS = 128;    // one warpgroup a block; its thread 0 issues the loads

// Shared memory of fwd_kernel; every tile 1024-byte aligned (sm90.cuh). K and
// V have rings of their own: a K stage is free once its scores are formed, a
// V stage only after the product with P, one step later.
template <int D>
struct FwdSmem {
  bf16 q[TILE * D];
  bf16 k[STAGES][TILE * D];
  bf16 v[STAGES][TILE * D];
  uint64_t q_full, k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};

// Shared memory of dq_kernel: Q and dO loaded once, K and V in rings of
// their own (one ring of both made ptxas spill at D 64).
template <int D>
struct DqSmem {
  bf16 q[TILE * D];
  bf16 dout[TILE * D];
  bf16 k[STAGES][TILE * D];
  bf16 v[STAGES][TILE * D];
  uint64_t qd_full, k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};

template <int D>
struct DkvSmem {
  bf16 k[TILE * D];
  bf16 v[TILE * D];
  bf16 q[STAGES][TILE * D];
  bf16 dout[STAGES][TILE * D];
  float lse[STAGES][TILE];
  float delta[STAGES][TILE];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

// Dynamic shared memory to launch with: the layout and room to align it.
template <typename Smem>
constexpr int smem_bytes() { return (int)sizeof(Smem) + 1024; }

// Load a 64 x D tile (D / 64 boxes) at row `row` of matrix `mat`.
template <int D>
__device__ __forceinline__ void load_tile_tma(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int mat) {
#pragma unroll
  for (int cb = 0; cb < D / sm90::BOX; ++cb)
    sm90::tma_load_3d(dst + cb * TILE * sm90::BOX, map, bar, cb * sm90::BOX, row, mat);
}

// Before the load of round `round` into a ring stage: wait until the
// warpgroup has freed the stage's previous round (nothing to wait for in
// round 0), then expect `bytes` on its full barrier.
__device__ __forceinline__ void claim_stage(uint64_t* full, uint64_t* empty, int round,
                                            uint32_t bytes) {
  if (round > 0) sm90::mbar_wait(empty, (round - 1) & 1);
  sm90::mbar_expect_tx(full, bytes);
}

// Kv tile j (rows 64 j.., matrix `mat`) into ring stage j % STAGES, as the
// stage's round j / STAGES.
template <int D>
__device__ __forceinline__ void load_ring(bf16 (*ring)[TILE * D], uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* map, int j, int mat) {
  const int st = j % STAGES;
  claim_stage(&full[st], &empty[st], j / STAGES, TILE * D * 2);
  load_tile_tma<D>(ring[st], map, &full[st], j * TILE, mat);
}

// acc[cb] (64 x 64 column block cb of a 64 x D f32 result) += A B, A the
// 64 x 64 bf16 register operand (4 depth steps of 4 pairs), B the 64 x D
// tile `b` read MN-major.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 64][32], const uint32_t (&a)[16],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::wgmma_rs(acc[cb], a + 4 * kk, sm90::desc_mn(b + cb * TILE * 64, kk));
}

// s (64 x 64 f32) = A B^T over depth D, both 64-row tiles read K-major.
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss(s, sm90::desc_k(a, kk), sm90::desc_k(b, kk), kk > 0);
}

// The register A operand from a 64 x 64 f32 accumulator: bf16 pairs.
__device__ __forceinline__ void to_operand(uint32_t (&a)[16], const float (&s)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Write this thread's part of a 64 x D f32 result, times f0 in row r0 and
// f1 in row r0 + 8, as bf16; `out` points at the tile's first row.
template <int D>
__device__ __forceinline__ void store_tile(bf16* out, int st, const float (&acc)[D / 64][32],
                                           int r0, int t, float f0, float f1) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = cb * 64 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * st + c) =
          pack_bf16(acc[cb][4 * n] * f0, acc[cb][4 * n + 1] * f0);
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * st + c) =
          pack_bf16(acc[cb][4 * n + 2] * f1, acc[cb][4 * n + 3] * f1);
    }
}

// The (bh, q tile) of a block of a forward or dQ grid. Blocks go in groups of
// `group` heads whose k and v fit in L2 together (l2_group); within a group,
// longest walk first (causal: the last q tiles), so the long blocks do not
// start last.
struct QTile {
  int bh, iq;
};

__device__ __forceinline__ QTile q_tile_of_block(int BH, int n_tiles, int group, int causal) {
  const int first = blockIdx.x / (group * n_tiles) * group;
  const int heads = min(group, BH - first), in_group = blockIdx.x - first * n_tiles;
  const int rank = in_group / heads;
  return {first + in_group % heads, causal ? n_tiles - 1 - rank : rank};
}

// Host: heads whose k and v take at most 24 MB, half the H100's L2.
inline int l2_group(int BH, int T, int D) {
  const long long per_head = 4ll * T * D;
  const long long group = 24000000ll / per_head < BH ? 24000000ll / per_head : BH;
  return group > 0 ? (int)group : 1;
}

// ------------------------------------------------------------------ forward
// `op` (max or sum) over the 16 values of one of this thread's two rows in a
// 64 x 64 accumulator (elements 4 n + 2 h + {0, 1} for row half h), as a
// tree: a short dependency chain.
template <typename Op>
__device__ __forceinline__ float row_reduce(const float (&x)[32], int h, Op op) {
  float v[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) v[n] = op(x[4 * n + 2 * h], x[4 * n + 2 * h + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] = op(v[n], v[n + w]);
  return v[0];
}

// One online-softmax step over a 64 x 64 tile of raw scores q.k, in place:
// the scores become P = exp(scale (s - m)), unnormalised. m is the running
// max of the raw scores of this thread's rows r0 and r0 + 8 (over the whole
// row: reduced across the 4 threads that share it), l this thread's part of
// their running sums (reduced once, at the end); corr gets the factors for
// the accumulator of the earlier tiles. scale_log2 = scale * log2(e), so each
// exponential is one FFMA and one ex2.
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, bool diag,
                                             int r0, int t) {
  if (diag) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((i >> 2) * 8 + 2 * t + (i & 1) > r0 + 8 * ((i >> 1) & 1)) sc[i] = NEG_INF;
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(fmaxf(m[h], row_reduce(sc, h, [](float a, float b) { return fmaxf(a, b); })));
    corr[h] = sm90::exp2_approx((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    mx[h] *= scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = sm90::exp2_approx(fmaf(sc[i], scale_log2, -mx[(i >> 1) & 1]));
  const auto add = [](float a, float b) { return a + b; };
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + row_reduce(sc, h, add);
}

// One block per (bh, q tile), in q_tile_of_block's order. o = softmax(scale
// q k^T) v, lse = scale m + log l. The products
// of step j are issued together: S_j = Q K_j^T and O += P_{j-1} V_{j-1}; the
// softmax of S_j runs while the second is in flight. Thread 0 reloads stages
// while those products run, when its warp would wait for them anyway, and
// only stages every warp freed in an earlier step, so its wait on the empty
// barrier is already over.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
           float* __restrict__ lse, long long q_sh, int q_st, int BH, int T, int H, int KV,
           float scale, int causal, int group) {
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(sm90::smem_1024());
  const int n_tiles = T / TILE;
  const auto [bh, iq] = q_tile_of_block(BH, n_tiles, group, causal);
  const int bkv = (bh / H) * KV + (bh % H) / (H / KV);
  const int n_kv = causal ? iq + 1 : n_tiles;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.k_full[st], 1);
      sm90::mbar_init(&sm.v_full[st], 1);
      sm90::mbar_init(&sm.k_empty[st], WG_THREADS);
      sm90::mbar_init(&sm.v_empty[st], WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader) {
    sm90::mbar_expect_tx(&sm.q_full, TILE * D * 2);
    load_tile_tma<D>(sm.q, &q_map, &sm.q_full, iq * TILE, bh);
    for (int j = 0; j < STAGES && j < n_kv; ++j) {
      load_ring<D>(sm.k, sm.k_full, sm.k_empty, &k_map, j, bkv);
      load_ring<D>(sm.v, sm.v_full, sm.v_empty, &v_map, j, bkv);
    }
  }
  __syncwarp();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const float scale_log2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float acc[D / 64][32], sc[32];
  uint32_t pa[16];  // P of the previous tile, the A operand of O += P V
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) zero(acc[cb]);
  sm90::mbar_wait(&sm.q_full, 0);

  sm90::mbar_wait(&sm.k_full[0], 0);
  zero(sc);
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
  product_ss<D>(sc, sm.q, sm.k[0]);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  sm90::mbar_arrive(&sm.k_empty[0]);
  softmax_step(sc, m, l, corr, scale_log2, causal && iq == 0, r0, t);
  to_operand(pa, sc);

  for (int jk = 1; jk < n_kv; ++jk) {
    const int s = jk % STAGES, sp = (jk - 1) % STAGES;
    sm90::mbar_wait(&sm.k_full[s], (jk / STAGES) & 1);
    sm90::mbar_wait(&sm.v_full[sp], ((jk - 1) / STAGES) & 1);
    zero(sc);  // sc is dead between to_operand and here: fewer live registers
    sm90::fence_regs(sc);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
    product_ss<D>(sc, sm.q, sm.k[s]);
    sm90::wgmma_commit();
    product_rs<D>(acc, pa, sm.v[sp]);
    sm90::wgmma_commit();
    // while the products run: K of tile jk + 1 and V of tile jk into the
    // stages of tiles jk + 1 - STAGES and jk - STAGES, freed in earlier steps
    if (leader) {
      if (jk + 1 >= STAGES && jk + 1 < n_kv)
        load_ring<D>(sm.k, sm.k_full, sm.k_empty, &k_map, jk + 1, bkv);
      if (jk >= STAGES)
        load_ring<D>(sm.v, sm.v_full, sm.v_empty, &v_map, jk, bkv);
    }
    __syncwarp();
    sm90::wgmma_wait<1>();  // the scores; O += P V still in flight
    sm90::fence_regs(sc);
    sm90::mbar_arrive(&sm.k_empty[s]);
    softmax_step(sc, m, l, corr, scale_log2, causal && jk == iq, r0, t);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(pa);
    sm90::mbar_arrive(&sm.v_empty[sp]);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= corr[(i >> 1) & 1];
    to_operand(pa, sc);
  }

  const int last = (n_kv - 1) % STAGES;
  sm90::mbar_wait(&sm.v_full[last], ((n_kv - 1) / STAGES) & 1);
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
  sm90::wgmma_fence();
  product_rs<D>(acc, pa, sm.v[last]);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
  sm90::fence_regs(pa);

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_tile<D>(o + bh * q_sh + (size_t)iq * TILE * q_st, q_st, acc, r0, t, 1.f / l[0],
                1.f / l[1]);
  if (t == 0) {
    const size_t row = (size_t)bh * T + iq * TILE + r0;
    lse[row] = scale * m[0] + logf(l[0]);
    lse[row + 8] = scale * m[1] + logf(l[1]);
  }
}

// ----------------------------------------------------------------------- dQ
// dS = P o (dP - delta), in place of the raw scores sc (q rows r0 and r0 + 8
// by kv columns), with P = exp(scale sc - lse) as one FFMA and one ex2 (lse2
// = lse log2(e)); on a causal diagonal tile P is 0 above the diagonal.
__device__ __forceinline__ void ds_step(float (&sc)[32], const float (&dp)[32],
                                        const float (&lse2)[2], const float (&del)[2],
                                        float scale_log2, bool diag, int r0, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = sm90::exp2_approx(fmaf(sc[i], scale_log2, -lse2[h]));
    if (diag && (i >> 2) * 8 + 2 * t + (i & 1) > r0 + 8 * h) p = 0.f;
    sc[i] = p * (dp[i] - del[h]);
  }
}

// One block per (bh, q tile), in q_tile_of_block's order; warp w owns q rows
// 16 w..16 w + 15. dq = scale * sum_kv dS k, with dS = P o (dP - delta),
// P = exp(scale q k^T - lse) and dP = do v^T. Step j: S = Q K_j^T and
// dP = dO V_j^T as one batch, then dQ += dS K_j with dS (rounded to bf16)
// as the register operand and K_j read MN-major. While the score products of
// step j run, thread 0 reloads the stages that step j - 1 used (freed by
// every warp during that step) with step j - 1 + STAGES. At D 64 the
// registers are capped so that four blocks share an SM, as their shared
// memory allows.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 4 : 2)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
          long long q_sh, int q_st, int BH, int T, int H, int KV, float scale, int causal,
          int group) {
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(sm90::smem_1024());
  const int n_tiles = T / TILE;
  const auto [bh, iq] = q_tile_of_block(BH, n_tiles, group, causal);
  const int bkv = (bh / H) * KV + (bh % H) / (H / KV);
  const int n_kv = causal ? iq + 1 : n_tiles;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    sm90::mbar_init(&sm.qd_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.k_full[st], 1);
      sm90::mbar_init(&sm.v_full[st], 1);
      sm90::mbar_init(&sm.k_empty[st], WG_THREADS);
      sm90::mbar_init(&sm.v_empty[st], WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader) {
    sm90::mbar_expect_tx(&sm.qd_full, 2 * TILE * D * 2);
    load_tile_tma<D>(sm.q, &q_map, &sm.qd_full, iq * TILE, bh);
    load_tile_tma<D>(sm.dout, &do_map, &sm.qd_full, iq * TILE, bh);
    for (int j = 0; j < STAGES && j < n_kv; ++j) {
      load_ring<D>(sm.k, sm.k_full, sm.k_empty, &k_map, j, bkv);
      load_ring<D>(sm.v, sm.v_full, sm.v_empty, &v_map, j, bkv);
    }
  }
  __syncwarp();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's q rows: r0 and r0 + 8
  const float scale_log2 = scale * LOG2E;
  const size_t row = (size_t)bh * T + iq * TILE + r0;
  const float lse2[2] = {lse[row] * LOG2E, lse[row + 8] * LOG2E};
  const float del[2] = {delta[row], delta[row + 8]};
  float acc[D / 64][32];
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) zero(acc[cb]);
  sm90::mbar_wait(&sm.qd_full, 0);

  for (int jk = 0; jk < n_kv; ++jk) {
    const int s = jk % STAGES;
    sm90::mbar_wait(&sm.k_full[s], (jk / STAGES) & 1);
    sm90::mbar_wait(&sm.v_full[s], (jk / STAGES) & 1);
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    product_ss<D>(sc, sm.q, sm.k[s]);
    product_ss<D>(dp, sm.dout, sm.v[s]);
    sm90::wgmma_commit();
    if (leader && jk >= 1 && jk - 1 + STAGES < n_kv) {
      load_ring<D>(sm.k, sm.k_full, sm.k_empty, &k_map, jk - 1 + STAGES, bkv);
      load_ring<D>(sm.v, sm.v_full, sm.v_empty, &v_map, jk - 1 + STAGES, bkv);
    }
    __syncwarp();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::mbar_arrive(&sm.v_empty[s]);

    ds_step(sc, dp, lse2, del, scale_log2, causal && jk == iq, r0, t);
    uint32_t da[16];
    to_operand(da, sc);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
    product_rs<D>(acc, da, sm.k[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(da);
    sm90::mbar_arrive(&sm.k_empty[s]);
  }

  store_tile<D>(dq + bh * q_sh + (size_t)iq * TILE * q_st, q_st, acc, r0, t, scale, scale);
}

// -------------------------------------------------------------------- dK/dV
// Step i of a dK/dV walk into stage i % STAGES: the Q and dO tiles at row
// 64 iq of head bh and their lse and delta rows.
template <int D>
__device__ __forceinline__ void load_dkv_step(DkvSmem<D>& sm, const CUtensorMap* q_map,
                                              const CUtensorMap* do_map, const float* lse,
                                              const float* delta, int i, int iq, int bh, int T) {
  const int st = i % STAGES;
  claim_stage(&sm.full[st], &sm.empty[st], i / STAGES, 2 * TILE * D * 2 + 2 * TILE * 4);
  load_tile_tma<D>(sm.q[st], q_map, &sm.full[st], iq * TILE, bh);
  load_tile_tma<D>(sm.dout[st], do_map, &sm.full[st], iq * TILE, bh);
  const size_t row = (size_t)bh * T + iq * TILE;
  sm90::bulk_load(sm.lse[st], lse + row, TILE * 4, &sm.full[st]);
  sm90::bulk_load(sm.delta[st], delta + row, TILE * 4, &sm.full[st]);
}

// One block per (bkv, kv tile); warp w owns kv rows 16 w..16 w + 15. Walks
// the rep = H / KV q heads of the group and, for each, the q tiles at or
// below the diagonal: dv = sum P^T do, dk = scale * sum (P o (dP - delta))^T
// q. While the score products of step i run, thread 0 reloads the stage that
// step i - 1 used (freed by every warp at its end) with step i - 1 + STAGES.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, long long kv_sh, int kv_st, int T,
           int H, int KV, float scale, int causal) {
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(sm90::smem_1024());
  const int n_tiles = T / TILE;
  const int bkv = blockIdx.x, jk = blockIdx.y;  // jk = 0 walks the most q tiles
  const int rep = H / KV;
  const int first = causal ? jk : 0, n_q = n_tiles - first, n_steps = rep * n_q;
  const bool leader = threadIdx.x == 0;
  // step i: q tile first + i % n_q of the group's member i / n_q
  const auto bh_of = [&](int i) { return (bkv / KV) * H + (bkv % KV) * rep + i / n_q; };
  const auto row_of = [&](int i) { return first + i % n_q; };
  if (leader) {
    sm90::mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (leader) {
    sm90::mbar_expect_tx(&sm.kv_full, 2 * TILE * D * 2);
    load_tile_tma<D>(sm.k, &k_map, &sm.kv_full, jk * TILE, bkv);
    load_tile_tma<D>(sm.v, &v_map, &sm.kv_full, jk * TILE, bkv);
    for (int i = 0; i < STAGES && i < n_steps; ++i)
      load_dkv_step<D>(sm, &q_map, &do_map, lse, delta, i, row_of(i), bh_of(i), T);
  }
  __syncwarp();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's kv rows: r0 and r0 + 8
  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    zero(dk_acc[cb]);
    zero(dv_acc[cb]);
  }
  sm90::mbar_wait(&sm.kv_full, 0);

  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES, iq = row_of(i);
    sm90::mbar_wait(&sm.full[s], (i / STAGES) & 1);
    // st = S^T (kv rows x q columns), dpt = dP^T
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    product_ss<D>(st, sm.k, sm.q[s]);
    product_ss<D>(dpt, sm.v, sm.dout[s]);
    sm90::wgmma_commit();
    // while the products run: step i - 1 + STAGES into the stage of step
    // i - 1, freed by every warp at that step's end
    if (leader && i >= 1 && i - 1 + STAGES < n_steps)
      load_dkv_step<D>(sm, &q_map, &do_map, lse, delta, i - 1 + STAGES, row_of(i - 1 + STAGES),
                       bh_of(i - 1 + STAGES), T);
    __syncwarp();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    const bool diag = causal && iq == jk;
    const float* s_lse = sm.lse[s];
    const float* s_del = sm.delta[s];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = (j >> 2) * 8 + 2 * t + (j & 1);  // q column within the tile
      float x = st[j] * scale;
      if (diag && qc < r0 + 8 * ((j >> 1) & 1)) x = NEG_INF;
      const float p = __expf(x - s_lse[qc]);
      st[j] = p;
      dpt[j] = p * (dpt[j] - s_del[qc]);
    }
    uint32_t pa[16], da[16];
    to_operand(pa, st);
    to_operand(da, dpt);

#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      sm90::fence_regs(dv_acc[cb]);
      sm90::fence_regs(dk_acc[cb]);
    }
    sm90::wgmma_fence();
    product_rs<D>(dv_acc, pa, sm.dout[s]);
    product_rs<D>(dk_acc, da, sm.q[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      sm90::fence_regs(dv_acc[cb]);
      sm90::fence_regs(dk_acc[cb]);
    }
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::mbar_arrive(&sm.empty[s]);
  }

  const size_t off = bkv * kv_sh + (size_t)jk * TILE * kv_st;
  store_tile<D>(dk + off, kv_st, dk_acc, r0, t, scale, scale);
  store_tile<D>(dv + off, kv_st, dv_acc, r0, t, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
               void* lse, long long q_sh, int q_st, int BH, int T, int H, int KV, float scale,
               int causal, cudaStream_t s) {
  constexpr int smem = smem_bytes<FwdSmem<D>>();
  const cudaError_t err = allow_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<D><<<BH * (T / TILE), WG_THREADS, smem, s>>>(
      qm, km, vm, (bf16*)o, (float*)lse, q_sh, q_st, BH, T, H, KV, scale, causal,
      l2_group(BH, T, D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
              const CUtensorMap& dom, const void* lse, const void* delta, void* dq,
              long long q_sh, int q_st, int BH, int T, int H, int KV, float scale, int causal,
              cudaStream_t s) {
  constexpr int smem = smem_bytes<DqSmem<D>>();
  const cudaError_t err = allow_smem(dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<BH * (T / TILE), WG_THREADS, smem, s>>>(
      qm, km, vm, dom, (const float*)lse, (const float*)delta, (bf16*)dq, q_sh, q_st, BH, T, H,
      KV, scale, causal, l2_group(BH, T, D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
               const CUtensorMap& dom, const void* lse, const void* delta, void* dk, void* dv,
               long long kv_sh, int kv_st, int BKV, int T, int H, int KV, float scale,
               int causal, cudaStream_t s) {
  constexpr int smem = smem_bytes<DkvSmem<D>>();
  const cudaError_t err = allow_smem(dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<D><<<dim3(BKV, T / TILE), WG_THREADS, smem, s>>>(
      qm, km, vm, dom, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, kv_sh,
      kv_st, T, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BH,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const int BKV = BH / H * KV;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_fwd<64>(qm, km, vm, o, lse, q_sh, q_st, BH, T, H, KV, scale, causal, s)
                 : launch_fwd<128>(qm, km, vm, o, lse, q_sh, q_st, BH, T, H, KV, scale, causal, s);
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, long long q_sh,
             int q_st, long long kv_sh, int kv_st, int BH, int T, int D, int H,
             int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const int BKV = BH / H * KV;
  CUtensorMap qm, km, vm, dom;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&dom, dout, D, T, BH, q_st, q_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(qm, km, vm, dom, lse, delta, dq, q_sh, q_st, BH, T, H, KV, scale,
                                 causal, s)
                 : launch_dq<128>(qm, km, vm, dom, lse, delta, dq, q_sh, q_st, BH, T, H, KV,
                                  scale, causal, s);
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BKV,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const int BH = BKV / KV * H;
  CUtensorMap qm, km, vm, dom;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&dom, dout, D, T, BH, q_st, q_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64>(qm, km, vm, dom, lse, delta, dk, dv, kv_sh, kv_st, BKV, T, H,
                                  KV, scale, causal, s)
                 : launch_dkv<128>(qm, km, vm, dom, lse, delta, dk, dv, kv_sh, kv_st, BKV, T,
                                   H, KV, scale, causal, s);
}

}  // extern "C"
