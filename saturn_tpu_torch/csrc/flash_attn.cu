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
//   producer warp (but in the head-dim-256 kernels, below): it would hold a
//   consumer's register count while it waits, and a block of 128 threads
//   instead of 160 lets 4 forward or dQ blocks (3 dK/dV blocks) share an SM
//   at D 64 instead of 3 (2).
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
//   across its 4 threads once, at the end. dQ at D 64 and 128 keeps the
//   plain chain (the score products, wait, dS, dQ += dS K, wait): its other
//   resident blocks fill the waits, and the shortened chain would hold each
//   K stage a step longer, which needs a third K stage (a block fewer per SM
//   at D 128) and more live registers.
// - Heavy tiles first: causal blocks are launched longest walk first (fwd
//   and dQ: the last q tiles; dK/dV: the first kv tile), so the long blocks
//   do not start last. The forward and dQ order their blocks in groups of
//   heads whose k and v fit in half the L2 together, which keeps them there
//   at large B * H.
// - Q (forward), Q and dO (dQ) or K and V (dK/dV) are loaded once per tile;
//   the dK/dV walk is over (group member x q tile), each stage bringing the Q
//   and dO tiles and their lse and delta rows (bulk copies); dQ reads each
//   thread's two lse and delta values once.
//
// Head dim 256 (GPT-J's): the three are kernels of their own, each with a
// producer warpgroup, whose registers setmaxnreg gives to two consumer
// warpgroups. fwd_kernel widened to D 256 held one warpgroup an SM
// (165 KB), so the SM's tensor cores idled whenever it formed a softmax,
// rescaled its 128 accumulators, waited for its first 64 KB or stored O, and
// every 64-row tile read its head's K and V through a ring of its own. A
// block of fwd_pingpong_kernel owns 128 q rows (197 KB): two consumer
// warpgroups of 64 rows share the K and V rings, so each stage feeds both,
// and take turns on the tensor cores, ordered by named barriers: one's
// products (S_j with P_{j-1} V_{j-1}) run while the other forms its softmax.
// P V is one m64n256k16 product per 16 kv rows; O goes through the
// consumer's Q tile to one TMA store. dkv_kernel widened to D 256 could not
// hold dk and dv (two 64 x 256 f32 accumulators, 256 registers a thread), so
// two blocks each owned half of their columns and each formed the full-depth
// S^T and dP^T: every score twice, every Q and dO tile read twice (0.2656
// ms on an H100 at GPT-J's shape, 4.4x its bound). dkv_wide_kernel works
// one 64-row kv tile at a time (226 KB) and splits the work by output:
// consumer P forms S^T = K Q^T and P, hands P (f32) to consumer dS through
// shared memory and accumulates dv += P^T dO; consumer dS forms dP^T = V
// dO^T once S^T is done, then dS from P, and accumulates dk += dS^T Q. Each
// score is formed once, each stage of Q and dO feeds both, the four
// products split evenly between the two, and dV and dK take their A
// operand from registers on m64n256k16. Its blocks are persistent, one an
// SM, each walking kv tiles heavy with light: a tile's K and V load under
// the last step of the one before, and dk and dv go out by TMA from that
// step's stage. What bounds it: shared memory, where a step reads 128 KB
// for the score products (SS at the full rate reads 128 B a cycle, all an
// SM gives), 64 KB for dV and dK and 32 KB for the P hand-off, and TMA
// writes 64 KB, about 2300 cycles against the tensor cores' 2048; and a
// fixed cost a tile, a fifth of it the result store. dq_kernel widened to
// D 256 held one warpgroup an SM (198 KB) that ran its chain alone (the
// score products, a wait, dS, dQ += dS K on 16 m64n64k16, a wait), so the
// tensor cores idled through every dS and every block's first 128 KB of
// loads, and dq left by 4-byte stores (0.1105 ms at GPT-J's shape, 2.2x its
// bound). dq_wide_kernel keeps dQ's walk per 64-row q tile (209 KB) and
// splits each step by product: consumer S forms S = Q K_j^T and dP = dO
// V_j^T and dS, hands dS (bf16) to consumer Q through a shared tile and
// goes on to the next step's scores while consumer Q runs dq += dS K_j as
// four m64n256k16 with both operands in shared memory. Its blocks are
// persistent, one an SM, each walking q tiles heavy with light, a head's
// tiles one after another (in L2 head groups as the forward orders its
// blocks it was 15 % slower at GPT-J's shape): a tile's first K and V
// stages load under the last steps of the one before, its Q and dO under
// the last step's dS and dQ, and dq goes out by TMA from the last K stage.
// What bounds it: at long walks the step, about 1.3 us for 1536
// tensor-core cycles of work, with the score products on m64n64k16 reading
// both operands from shared memory (without the dQ product a step took 17 %
// less time, without dS's exponentials 6 %; Q and dO as register operands
// or a K stage freed early gained nothing); at short walks the tile's fixed
// cost and dq's writes to device memory (without any dq store 13 % faster).
//
// Layout: q, o, do, dq are (B*H, T, D) and k, v, dk, dv are (B*KV, T, D),
// bf16, row stride `*_st` and head stride `*_sh` in elements, rows and base
// addresses 16-byte aligned. lse and delta are (B*H, T) f32, contiguous,
// 16-byte aligned. T % 64 == 0, D in {64, 128, 256}. Each launcher returns a
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
constexpr int WG_THREADS = 128;    // a warpgroup: the whole block but in fwd_pingpong_kernel

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

// Shared memory of dkv_kernel (D 64 and 128): K and V loaded once, one ring
// of (Q, dO, lse, delta) stages.
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

// Kv tile j (rows 64 j.., matrix `mat`) as the ring's step g: into stage
// g % STAGES, as the stage's round g / STAGES. A block that walks one tile
// loads its tile j at step j; a persistent block carries g on across tiles.
template <int D>
__device__ __forceinline__ void load_ring_at(bf16 (*ring)[TILE * D], uint64_t* full,
                                             uint64_t* empty, const CUtensorMap* map, int g,
                                             int j, int mat) {
  const int st = g % STAGES;
  claim_stage(&full[st], &empty[st], g / STAGES, TILE * D * 2);
  load_tile_tma<D>(ring[st], map, &full[st], j * TILE, mat);
}

template <int D>
__device__ __forceinline__ void load_ring(bf16 (*ring)[TILE * D], uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* map, int j, int mat) {
  load_ring_at<D>(ring, full, empty, map, j, j, mat);
}

// acc[cb] (64 x 64 column block cb of a 64 x 64 NCB f32 result) += A B, A
// the 64 x 64 bf16 register operand (4 depth steps of 4 pairs), B the NCB
// column blocks of a tile from `b` on, read MN-major.
template <int NCB>
__device__ __forceinline__ void product_rs(float (&acc)[NCB][32], const uint32_t (&a)[16],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
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

// Write this thread's part of a 64 x 64 NCB f32 result, times f0 in row r0
// and f1 in row r0 + 8, as bf16; `out` points at the result's first element.
template <int NCB>
__device__ __forceinline__ void store_tile(bf16* out, int st, const float (&acc)[NCB][32],
                                           int r0, int t, float f0, float f1) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = cb * 64 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * st + c) =
          pack_bf16(acc[cb][4 * n] * f0, acc[cb][4 * n + 1] * f0);
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * st + c) =
          pack_bf16(acc[cb][4 * n + 2] * f1, acc[cb][4 * n + 3] * f1);
    }
}

// The (bh, q tile) of tile `k` (a block of a forward or dQ grid: blockIdx.x).
// Tiles go in groups of `group` heads whose k and v fit in L2 together
// (l2_group); within a group, longest walk first (causal: the last q tiles),
// so the long blocks do not start last.
struct QTile {
  int bh, iq;
};

__device__ __forceinline__ QTile q_tile_of_block(int BH, int n_tiles, int group, int causal,
                                                int k) {
  const int first = k / (group * n_tiles) * group;
  const int heads = min(group, BH - first), in_group = k - first * n_tiles;
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
  const auto [bh, iq] = q_tile_of_block(BH, n_tiles, group, causal, blockIdx.x);
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
    product_rs<D / 64>(acc, pa, sm.v[sp]);
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
  product_rs<D / 64>(acc, pa, sm.v[last]);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
  sm90::fence_regs(pa);

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_tile<D / 64>(o + bh * q_sh + (size_t)iq * TILE * q_st, q_st, acc, r0, t, 1.f / l[0],
                     1.f / l[1]);
  if (t == 0) {
    const size_t row = (size_t)bh * T + iq * TILE + r0;
    lse[row] = scale * m[0] + logf(l[0]);
    lse[row + 8] = scale * m[1] + logf(l[1]);
  }
}

// ------------------------------------------------- forward at head dim 256
// A block owns 128 q rows (PP_ROWS) in two consumer warpgroups of 64 rows,
// which share one K ring and one V ring, and a producer warpgroup that
// issues the loads.
constexpr int PP_D = 256;
constexpr int PP_CONSUMERS = 2;
constexpr int PP_ROWS = PP_CONSUMERS * TILE;
constexpr int PP_THREADS = (1 + PP_CONSUMERS) * WG_THREADS;
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 = 64512, what
// __launch_bounds__(384, 1) gives the block (168 a thread).
constexpr int PP_PRODUCER_REGS = 24;
constexpr int PP_CONSUMER_REGS = 240;
// Named barriers: 1 + c, consumer c's turn to issue products (both
// consumers' 256 threads); 3 + c, consumer c's 128 threads before its O store.
constexpr int BAR_TURN = 1;
constexpr int BAR_STORE = 3;

struct PingPongSmem {
  bf16 q[PP_CONSUMERS][TILE * PP_D];  // consumer c's Q tile, then its O tile
  bf16 k[STAGES][TILE * PP_D];
  bf16 v[STAGES][TILE * PP_D];
  uint64_t q_full[PP_CONSUMERS], k_full[STAGES], k_empty[STAGES], v_full[STAGES],
      v_empty[STAGES];
};

// Kv tiles consumer c walks in q block ib: up to its diagonal tile 2 ib + c
// (causal) or all of them; none where its rows lie past T.
__device__ __forceinline__ int pp_walk(int ib, int c, int n_tiles, int causal) {
  if (2 * ib + c >= n_tiles) return 0;
  return causal ? 2 * ib + c + 1 : n_tiles;
}

// The order in which the consumers issue their products: turn k of
// consumer 0 after turn k - 1 of consumer 1, turn k of consumer 1 after turn
// k of consumer 0, so one's products run while the other forms its softmax.
// A consumer takes walk + 1 turns (the last: P V of its last tile), none
// when it walks none; `other` is the other one's count, and a turn waits for
// / signals only a turn that exists, so every barrier phase is full.
__device__ __forceinline__ void turn_begin(int c, int k, int other) {
  if (c == 0 ? k >= 1 && k - 1 < other : k < other)
    sm90::bar_sync(BAR_TURN + c, PP_CONSUMERS * WG_THREADS);
}
__device__ __forceinline__ void turn_end(int c, int k, int other) {
  if (c == 0 ? k < other : k + 1 < other)
    sm90::bar_arrive(BAR_TURN + 1 - c, PP_CONSUMERS * WG_THREADS);
}

// O (64 x 256 f32) += P V: P the register operand, V one m64n256k16 product
// per 16 kv rows, read MN-major across its four column blocks.
__device__ __forceinline__ void product_pv(float (&acc)[4][32], const uint32_t (&pa)[16],
                                           const bf16* v) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    sm90::wgmma_rs_n256(acc, pa + 4 * kk, sm90::desc_mn(v, kk));
}

// This thread's part of a 64 x 64 f32 accumulator, times f0 in row r0 and f1
// in row r0 + 8, as bf16 into `block`, one 64 x 64 column block in the
// layout TMA loads it: row r at 128 r bytes, its 16-byte chunks swizzled by
// r % 8 (here lane / 4), so a warp's 32 stores hit 32 banks.
__device__ __forceinline__ void stage_block(bf16* block, const float (&acc)[32], float f0,
                                            float f1, int r0, int t) {
  unsigned char* out = reinterpret_cast<unsigned char*>(block);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float f = h ? f1 : f0;
      *reinterpret_cast<uint32_t*>(out + r * 128 + ((nn ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(acc[4 * nn + 2 * h] * f, acc[4 * nn + 2 * h + 1] * f);
    }
}

// A 64 x 256 f32 accumulator, as stage_block puts it, into `tile`, a 64 x 256
// tile no product reads any more (column block cb at 8 KB cb). Then a TMA
// store can write the tile out.
__device__ __forceinline__ void stage_tile(bf16* tile, const float (&acc)[4][32], float f0,
                                           float f1, int r0, int t) {
#pragma unroll
  for (int cb = 0; cb < 4; ++cb)
    stage_block(tile + cb * TILE * sm90::BOX, acc[cb], f0, f1, r0, t);
}

// Thread `tid` of a warpgroup that staged `tile` (stage_tile): once all 128
// have (named barrier `bar`), its thread 0 stores the tile at row `row0` of
// matrix `mat` through `map`, four 64-column boxes.
__device__ __forceinline__ void store_staged(const CUtensorMap* map, const bf16* tile, int bar,
                                             int row0, int mat, int tid) {
  sm90::fence_proxy_async();
  sm90::bar_sync(bar, WG_THREADS);
  if (tid == 0) {
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      sm90::tma_store_3d(map, tile + cb * TILE * sm90::BOX, cb * sm90::BOX, row0, mat);
    sm90::bulk_commit();
  }
}

// Consumer c of a ping-pong block: the online softmax over kv tiles 0..n-1
// (n >= 1) of its 64 q rows from q row `row0`, as fwd_kernel runs it (S_j
// issued with P_{j-1} V_{j-1}), in turns with the other consumer; then O,
// normalised, through its Q tile to one TMA store, and lse. `tid` is the
// thread's index in its warpgroup.
__device__ __forceinline__ void pp_consume(PingPongSmem& sm, const CUtensorMap* o_map,
                                           float* __restrict__ lse, int c, int n, int other,
                                           int diag, int bh, int row0, int T, float scale,
                                           int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const float scale_log2 = scale * LOG2E;
  const bf16* q = sm.q[c];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float acc[4][32], sc[32];
  uint32_t pa[16];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) zero(acc[cb]);
  sm90::mbar_wait(&sm.q_full[c], 0);

  sm90::mbar_wait(&sm.k_full[0], 0);
  zero(sc);
  sm90::fence_regs(sc);
  turn_begin(c, 0, other);
  sm90::wgmma_fence();
  product_ss<PP_D>(sc, q, sm.k[0]);
  sm90::wgmma_commit();
  turn_end(c, 0, other);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  sm90::mbar_arrive(&sm.k_empty[0]);
  softmax_step(sc, m, l, corr, scale_log2, diag == 0, r0, t);
  to_operand(pa, sc);

  for (int jk = 1; jk < n; ++jk) {
    const int s = jk % STAGES, sp = (jk - 1) % STAGES;
    sm90::mbar_wait(&sm.k_full[s], (jk / STAGES) & 1);
    sm90::mbar_wait(&sm.v_full[sp], ((jk - 1) / STAGES) & 1);
    zero(sc);
    sm90::fence_regs(sc);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    turn_begin(c, jk, other);
    sm90::wgmma_fence();
    product_ss<PP_D>(sc, q, sm.k[s]);
    sm90::wgmma_commit();
    product_pv(acc, pa, sm.v[sp]);
    sm90::wgmma_commit();
    turn_end(c, jk, other);
    sm90::wgmma_wait<1>();  // the scores; O += P V still in flight
    sm90::fence_regs(sc);
    sm90::mbar_arrive(&sm.k_empty[s]);
    softmax_step(sc, m, l, corr, scale_log2, jk == diag, r0, t);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(pa);
    sm90::mbar_arrive(&sm.v_empty[sp]);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= corr[(i >> 1) & 1];
    to_operand(pa, sc);
  }

  const int last = (n - 1) % STAGES;
  sm90::mbar_wait(&sm.v_full[last], ((n - 1) / STAGES) & 1);
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
  turn_begin(c, n, other);
  sm90::wgmma_fence();
  product_pv(acc, pa, sm.v[last]);
  sm90::wgmma_commit();
  turn_end(c, n, other);
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
  sm90::fence_regs(pa);
  sm90::mbar_arrive(&sm.v_empty[last]);

  // O into the Q tile (its last product is done), then one TMA store
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  stage_tile(sm.q[c], acc, 1.f / l[0], 1.f / l[1], r0, t);
  store_staged(o_map, sm.q[c], BAR_STORE + c, row0, bh, tid);
  if (t == 0) {
    const size_t row = (size_t)bh * T + row0 + r0;
    lse[row] = scale * m[0] + logf(l[0]);
    lse[row + 8] = scale * m[1] + logf(l[1]);
  }
  if (tid == 0) sm90::bulk_wait_read();  // the block's shared memory outlives the store's read
}

// The head-dim-256 forward (GPT-J's): one block per (bh, 128-row q block),
// in q_tile_of_block's order over q blocks; o = softmax(scale q k^T) v,
// lse = scale m + log l, as fwd_kernel computes them. Warpgroup 0 produces:
// its thread 0 loads both Q tiles and walks the K ring, its thread 32 the V
// ring, each over the kv tiles of the longer walk, so that every stage
// serves both consumers. Warpgroups 1 and 2 consume, rows 0-63 and 64-127,
// in turns. A consumer frees each stage it walks after its product, and the
// stages of the tiles it does not walk (consumer 0's last tile on a causal
// block, every tile where its rows lie past T) once they have arrived.
__global__ void __launch_bounds__(PP_THREADS, 1)
fwd_pingpong_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int BH,
                    int T, int H, int KV, float scale, int causal, int group) {
  PingPongSmem& sm = *reinterpret_cast<PingPongSmem*>(sm90::smem_1024());
  const int n_tiles = T / TILE;
  const auto [bh, ib] = q_tile_of_block(BH, (n_tiles + 1) / 2, group, causal, blockIdx.x);
  const int bkv = (bh / H) * KV + (bh % H) / (H / KV);
  const int walk0 = pp_walk(ib, 0, n_tiles, causal), walk1 = pp_walk(ib, 1, n_tiles, causal);
  const int n_kv = max(walk0, walk1);
  if (threadIdx.x == 0) {
    for (int c = 0; c < PP_CONSUMERS; ++c) sm90::mbar_init(&sm.q_full[c], 1);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.k_full[st], 1);
      sm90::mbar_init(&sm.v_full[st], 1);
      sm90::mbar_init(&sm.k_empty[st], PP_CONSUMERS * WG_THREADS);
      sm90::mbar_init(&sm.v_empty[st], PP_CONSUMERS * WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    sm90::setmaxnreg_dec<PP_PRODUCER_REGS>();
    if (threadIdx.x == 0) {  // Q of consumer 0, K of tile 0, Q of consumer 1, the K ring
      sm90::mbar_expect_tx(&sm.q_full[0], TILE * PP_D * 2);
      load_tile_tma<PP_D>(sm.q[0], &q_map, &sm.q_full[0], ib * PP_ROWS, bh);
      load_ring<PP_D>(sm.k, sm.k_full, sm.k_empty, &k_map, 0, bkv);
      if (walk1 > 0) {
        sm90::mbar_expect_tx(&sm.q_full[1], TILE * PP_D * 2);
        load_tile_tma<PP_D>(sm.q[1], &q_map, &sm.q_full[1], ib * PP_ROWS + TILE, bh);
      }
      for (int j = 1; j < n_kv; ++j) load_ring<PP_D>(sm.k, sm.k_full, sm.k_empty, &k_map, j, bkv);
    } else if (threadIdx.x == 32) {
      for (int j = 0; j < n_kv; ++j) load_ring<PP_D>(sm.v, sm.v_full, sm.v_empty, &v_map, j, bkv);
    }
  } else {
    sm90::setmaxnreg_inc<PP_CONSUMER_REGS>();
    const int c = wg - 1, n = c == 0 ? walk0 : walk1, n_other = c == 0 ? walk1 : walk0;
    const int other = n_other > 0 ? n_other + 1 : 0;  // the other consumer's turns
    if (n > 0)
      pp_consume(sm, &o_map, lse, c, n, other, causal ? 2 * ib + c : -1, bh,
                 ib * PP_ROWS + c * TILE, T, scale, threadIdx.x - wg * WG_THREADS);
    for (int j = n; j < n_kv; ++j) {
      const int s = j % STAGES, parity = (j / STAGES) & 1;
      sm90::mbar_wait(&sm.k_full[s], parity);
      sm90::mbar_arrive(&sm.k_empty[s]);
      sm90::mbar_wait(&sm.v_full[s], parity);
      sm90::mbar_arrive(&sm.v_empty[s]);
    }
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

// dQ at head dim 64 and 128 (dq_wide_kernel below takes 256). One block per
// (bh, q tile), in q_tile_of_block's order; warp w owns q rows
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
  const auto [bh, iq] = q_tile_of_block(BH, n_tiles, group, causal, blockIdx.x);
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
    product_rs<D / 64>(acc, da, sm.k[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(da);
    sm90::mbar_arrive(&sm.k_empty[s]);
  }

  store_tile<D / 64>(dq + bh * q_sh + (size_t)iq * TILE * q_st, q_st, acc, r0, t, scale, scale);
}

// -------------------------------------------------------------------- dK/dV
// Step i of a dK/dV walk into stage i % STAGES: the Q and dO tiles at row
// 64 iq of head bh and their lse and delta rows.
template <int D, typename Smem>
__device__ __forceinline__ void load_dkv_step(Smem& sm, const CUtensorMap* q_map,
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

// The walk of a dK/dV block over kv tile jk of kv head bkv: the rep = H / KV
// q heads of its group and, for each, the q tiles at or below the diagonal
// (causal) or all of them. Step i is q tile row(i) of q head bh(i).
struct DkvWalk {
  int bkv, jk, first, n_q, n_steps, H, KV;
  __device__ DkvWalk(int bkv_, int jk_, int n_tiles, int H_, int KV_, int causal)
      : bkv(bkv_), jk(jk_), first(causal ? jk_ : 0), n_q(n_tiles - first),
        n_steps(H_ / KV_ * n_q), H(H_), KV(KV_) {}
  __device__ int row(int i) const { return first + i % n_q; }
  __device__ int bh(int i) const { return (bkv / KV) * H + (bkv % KV) * (H / KV) + i / n_q; }
};

// One block per (bkv, kv tile); warp w owns kv rows 16 w..16 w + 15. dv =
// sum P^T do, dk = scale * sum (P o (dP - delta))^T q over the walk. While
// the score products of step i run, thread 0 reloads the stage that step
// i - 1 used (freed by every warp at its end) with step i - 1 + STAGES.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, long long kv_sh, int kv_st, int T,
           int H, int KV, float scale, int causal) {
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(sm90::smem_1024());
  constexpr int NCB = D / 64;
  const int jk = blockIdx.y;  // jk = 0 walks the most q tiles
  const DkvWalk w(blockIdx.x, jk, T / TILE, H, KV, causal);
  const bool leader = threadIdx.x == 0;
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
    load_tile_tma<D>(sm.k, &k_map, &sm.kv_full, jk * TILE, w.bkv);
    load_tile_tma<D>(sm.v, &v_map, &sm.kv_full, jk * TILE, w.bkv);
    for (int i = 0; i < STAGES && i < w.n_steps; ++i)
      load_dkv_step<D>(sm, &q_map, &do_map, lse, delta, i, w.row(i), w.bh(i), T);
  }
  __syncwarp();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's kv rows: r0 and r0 + 8
  float dk_acc[NCB][32], dv_acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
    zero(dk_acc[cb]);
    zero(dv_acc[cb]);
  }
  sm90::mbar_wait(&sm.kv_full, 0);

  for (int i = 0; i < w.n_steps; ++i) {
    const int s = i % STAGES, iq = w.row(i);
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
    if (leader && i >= 1 && i - 1 + STAGES < w.n_steps)
      load_dkv_step<D>(sm, &q_map, &do_map, lse, delta, i - 1 + STAGES, w.row(i - 1 + STAGES),
                       w.bh(i - 1 + STAGES), T);
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
    for (int cb = 0; cb < NCB; ++cb) {
      sm90::fence_regs(dv_acc[cb]);
      sm90::fence_regs(dk_acc[cb]);
    }
    sm90::wgmma_fence();
    product_rs<NCB>(dv_acc, pa, sm.dout[s]);
    product_rs<NCB>(dk_acc, da, sm.q[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      sm90::fence_regs(dv_acc[cb]);
      sm90::fence_regs(dk_acc[cb]);
    }
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::mbar_arrive(&sm.empty[s]);
  }

  const size_t off = w.bkv * kv_sh + (size_t)jk * TILE * kv_st;
  store_tile<NCB>(dk + off, kv_st, dk_acc, r0, t, scale, scale);
  store_tile<NCB>(dv + off, kv_st, dv_acc, r0, t, 1.f, 1.f);
}

// --------------------------------------------------- dK/dV at head dim 256
// A persistent block walks kv tiles one after another (wide_tile). Each
// tile is one 64-row kv tile, worked by a producer warpgroup and two consumer
// warpgroups that split the work by output. Consumer P (warpgroup 1) forms
// S^T = K Q^T and P^T, passes P in f32 to consumer dS and holds dv; consumer
// dS (warpgroup 2) forms dP^T = V dO^T, then dS^T from P, and holds dk. Each
// holds one 64 x 256 f32 accumulator (128 registers a thread) and runs half
// of each step's products. Registers as in fwd_pingpong_kernel.
constexpr int WIDE_D = 256;
constexpr int WIDE_THREADS = 3 * WG_THREADS;
// Named barriers 1 (consumer P) and 2 (consumer dS): a consumer's 128
// threads before its TMA store.
constexpr int BAR_WIDE_STORE = 1;

// P in f32 from consumer P to consumer dS, in the thread layout of their
// accumulators (thread tid's 32 values as 8 float4 at [m][tid], so a warp's
// 16-byte accesses fill whole wavefronts), double-buffered: the buffer of
// step g is free again once consumer dS has read it (p_free). It reads it
// before it frees step g's stage, which step g + 2 is loaded into, so
// consumer P's wait on p_free at step g + 2 is as a rule already over.
// Steps g count on across a block's tiles, so do the ring's rounds. s_done
// (consumer P's S^T of step g is done) orders the score products: consumer
// dS issues dP^T after it. K and V
// have barriers of their own: a consumer frees its tile (P: K, dS: V) once
// its last score product is done, so the next tile's load runs under the
// last step. A consumer stages its result in the last step's stage (P: dv
// in dO, dS: dk in Q, each once the other consumer's last product reading
// it is done) and frees that stage once the TMA store has read it.
struct DkvWideSmem {
  bf16 k[TILE * WIDE_D];
  bf16 v[TILE * WIDE_D];
  bf16 q[STAGES][TILE * WIDE_D];
  bf16 dout[STAGES][TILE * WIDE_D];
  float4 p[2][8][WG_THREADS];
  float lse[STAGES][TILE];
  float delta[STAGES][TILE];
  uint64_t k_full, v_full, k_empty, v_empty, full[STAGES], empty[STAGES], p_ready[2], p_free[2],
      s_done[2];
};

// The tile of round r of a persistent block, false when it has none, in
// q_tile_of_block's order over the n tiles of n_mat heads: heads in groups
// (`group`, see the launchers), within a group the longest causal walk
// first: tile 0 (dK/dV, heavy_last 0) or the last tile (dQ, heavy_last 1).
// Block b of G takes tile r G + b in even rounds and r G + G - 1 - b in odd
// ones: the snake pairs heavy walks of one round with light ones of the
// next.
struct WideTile {
  int mat, row;  // a head of the flattened batch (kv head: dK/dV) and its 64-row tile
};

__device__ __forceinline__ bool wide_tile(WideTile& tile, int r, int n, int n_mat, int n_tiles,
                                          int group, int heavy_last) {
  const int G = gridDim.x, k = r * G + (r & 1 ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  if (k >= n) return false;
  const QTile q = q_tile_of_block(n_mat, n_tiles, group, heavy_last, k);
  tile = {q.bh, q.iq};
  return true;
}

// Consumer P on one tile: per step S^T = K Q^T (kv rows x q columns), P =
// exp(scale S - lse) (0 above a causal diagonal), P to consumer dS, dv +=
// P^T dO with P^T the register operand and dO read MN-major across its four
// column blocks; then dv through the last step's dO tile to one TMA store.
// g: the block's steps before this tile; tt: its tiles before it. `tid` is
// the thread's index in its warpgroup.
__device__ __forceinline__ void wide_tile_p(DkvWideSmem& sm, const DkvWalk& w, int causal,
                                            float scale, const CUtensorMap* dv_map, int g,
                                            int tt, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's kv rows: r0 and r0 + 8
  const float scale_log2 = scale * LOG2E;
  float acc[4][32], st[32];
  uint32_t pa[16];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) zero(acc[cb]);
  sm90::mbar_wait(&sm.k_full, tt & 1);

  for (int i = 0; i < w.n_steps; ++i, ++g) {
    const int s = g % STAGES, b = g & 1;
    sm90::mbar_wait(&sm.full[s], (g / STAGES) & 1);
    zero(st);
    sm90::fence_regs(st);
    sm90::wgmma_fence();
    product_ss<WIDE_D>(st, sm.k, sm.q[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::mbar_arrive(&sm.s_done[b]);
    if (i == w.n_steps - 1) sm90::mbar_arrive(&sm.k_empty);

    const bool diag = causal && w.row(i) == w.jk;
    const float* s_lse = sm.lse[s];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = (j >> 2) * 8 + 2 * t + (j & 1);  // q column within the tile
      const float p = sm90::exp2_approx(fmaf(st[j], scale_log2, -s_lse[qc] * LOG2E));
      st[j] = diag && qc < r0 + 8 * ((j >> 1) & 1) ? 0.f : p;
    }
    // dv's product first, then P to consumer dS while it runs
    to_operand(pa, st);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
    product_pv(acc, pa, sm.dout[s]);
    sm90::wgmma_commit();
    if (g >= 2) sm90::mbar_wait(&sm.p_free[b], ((g >> 1) - 1) & 1);
#pragma unroll
    for (int m = 0; m < 8; ++m)
      sm.p[b][m][tid] = make_float4(st[4 * m], st[4 * m + 1], st[4 * m + 2], st[4 * m + 3]);
    sm90::mbar_arrive(&sm.p_ready[b]);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(pa);
    if (i < w.n_steps - 1) sm90::mbar_arrive(&sm.empty[s]);
  }
  // consumer dS read P of the last step after its dP^T, the last reader of dO
  --g;
  const int s = g % STAGES;
  sm90::mbar_wait(&sm.p_free[g & 1], (g >> 1) & 1);
  stage_tile(sm.dout[s], acc, 1.f, 1.f, r0, t);
  store_staged(dv_map, sm.dout[s], BAR_WIDE_STORE, w.jk * TILE, w.bkv, tid);
  if (tid == 0) {
    sm90::bulk_wait_read();
    sm90::mbar_arrive_count(&sm.empty[s], WG_THREADS);
  }
}

// Consumer dS on one tile: per step, once consumer P's S^T is done (so the
// two score products do not share the tensor cores and P's exponentials run
// beside this one), dP^T = V dO^T, dS = P o (dP - delta) with P from
// consumer P, then dk += dS^T Q with dS^T the register operand and Q read
// MN-major; dk = scale * the sum, through the last step's Q tile (consumer
// P's last S^T is done: this one waited for it) to one TMA store.
__device__ __forceinline__ void wide_tile_ds(DkvWideSmem& sm, const DkvWalk& w, float scale,
                                             const CUtensorMap* dk_map, int g, int tt, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  float acc[4][32], dpt[32];
  uint32_t da[16];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) zero(acc[cb]);
  sm90::mbar_wait(&sm.v_full, tt & 1);

  for (int i = 0; i < w.n_steps; ++i, ++g) {
    const int s = g % STAGES, b = g & 1;
    sm90::mbar_wait(&sm.full[s], (g / STAGES) & 1);
    sm90::mbar_wait(&sm.s_done[b], (g >> 1) & 1);
    zero(dpt);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    product_ss<WIDE_D>(dpt, sm.v, sm.dout[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dpt);
    if (i == w.n_steps - 1) sm90::mbar_arrive(&sm.v_empty);

    const float* s_del = sm.delta[s];
    sm90::mbar_wait(&sm.p_ready[b], (g >> 1) & 1);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float4 p = sm.p[b][m][tid];
      const float pm[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * m + e, qc = m * 8 + 2 * t + (j & 1);
        dpt[j] = pm[e] * (dpt[j] - s_del[qc]);
      }
    }
    sm90::mbar_arrive(&sm.p_free[b]);
    to_operand(da, dpt);

#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
    product_pv(acc, da, sm.q[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::fence_regs(da);
    if (i < w.n_steps - 1) sm90::mbar_arrive(&sm.empty[s]);
  }
  const int s = (g - 1) % STAGES;
  stage_tile(sm.q[s], acc, scale, scale, r0, t);
  store_staged(dk_map, sm.q[s], BAR_WIDE_STORE + 1, w.jk * TILE, w.bkv, tid);
  if (tid == 0) {
    sm90::bulk_wait_read();
    sm90::mbar_arrive_count(&sm.empty[s], WG_THREADS);
  }
}

// The head-dim-256 dK/dV (GPT-J's): persistent blocks, at most one an SM,
// each walking its kv tiles (wide_tile); dk and dv as dkv_kernel computes
// them. Warpgroup 0 produces: its thread 0 walks the ring of (Q, dO, lse,
// delta) stages that both consumers read (the empty barriers count both
// consumers' 256 threads) over all the block's tiles, its thread 32 loads
// each tile's K and V once the tile before is done with them, so a tile's
// first stages and its K and V load while the tile before finishes.
// Warpgroups 1 and 2 are consumers P and dS.
__global__ void __launch_bounds__(WIDE_THREADS, 1)
dkv_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dk_map,
                const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ lse,
                const float* __restrict__ delta, int BKV, int T, int H, int KV, float scale,
                int causal, int group) {
  DkvWideSmem& sm = *reinterpret_cast<DkvWideSmem*>(sm90::smem_1024());
  const int n_tiles = T / TILE, n = BKV * n_tiles;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.k_full, 1);
    sm90::mbar_init(&sm.v_full, 1);
    sm90::mbar_init(&sm.k_empty, WG_THREADS);
    sm90::mbar_init(&sm.v_empty, WG_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], 2 * WG_THREADS);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&sm.p_ready[b], WG_THREADS);
      sm90::mbar_init(&sm.p_free[b], WG_THREADS);
      sm90::mbar_init(&sm.s_done[b], WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  WideTile tile;
  if (wg == 0) {
    sm90::setmaxnreg_dec<PP_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int r = 0, g = 0; wide_tile(tile, r, n, BKV, n_tiles, group, 0); ++r) {
        const DkvWalk w(tile.mat, tile.row, n_tiles, H, KV, causal);
        for (int i = 0; i < w.n_steps; ++i, ++g)
          load_dkv_step<WIDE_D>(sm, &q_map, &do_map, lse, delta, g, w.row(i), w.bh(i), T);
      }
    } else if (threadIdx.x == 32) {
      for (int r = 0; wide_tile(tile, r, n, BKV, n_tiles, group, 0); ++r) {
        if (r > 0) sm90::mbar_wait(&sm.k_empty, (r - 1) & 1);
        sm90::mbar_expect_tx(&sm.k_full, TILE * WIDE_D * 2);
        load_tile_tma<WIDE_D>(sm.k, &k_map, &sm.k_full, tile.row * TILE, tile.mat);
        if (r > 0) sm90::mbar_wait(&sm.v_empty, (r - 1) & 1);
        sm90::mbar_expect_tx(&sm.v_full, TILE * WIDE_D * 2);
        load_tile_tma<WIDE_D>(sm.v, &v_map, &sm.v_full, tile.row * TILE, tile.mat);
      }
    }
  } else {
    sm90::setmaxnreg_inc<PP_CONSUMER_REGS>();
    const int tid = threadIdx.x - wg * WG_THREADS;
    for (int r = 0, g = 0; wide_tile(tile, r, n, BKV, n_tiles, group, 0); ++r) {
      const DkvWalk w(tile.mat, tile.row, n_tiles, H, KV, causal);
      if (wg == 1)
        wide_tile_p(sm, w, causal, scale, &dv_map, g, r, tid);
      else
        wide_tile_ds(sm, w, scale, &dk_map, g, r, tid);
      g += w.n_steps;
    }
  }
}

// ------------------------------------------------------- dQ at head dim 256
// A persistent block walks q tiles one after another (wide_tile, the last q
// tile, the longest causal walk, first). Each 64-row q tile is worked by a
// producer warpgroup and two consumer warpgroups that split each step's
// products: consumer S (warpgroup 1) forms S = Q K_j^T and dP = dO V_j^T and
// from them dS, which it hands to consumer Q in bf16 through shared memory,
// then goes on to the next step's scores; consumer Q (warpgroup 2) holds dq
// (64 x 256 f32, 128 registers a thread) and runs dq += dS K_j on four
// m64n256k16 products, A = dS and B = K_j read MN-major, both from shared
// memory. Registers as in fwd_pingpong_kernel.
constexpr int BAR_DQ_STORE = 1;  // named barrier: consumer Q's 128 threads before its TMA store

// dS of step g goes through buffer g & 1, a 64 x 64 bf16 tile in the layout
// TMA gives a column block (so desc_k reads it as wgmma's A operand): full
// once consumer S wrote it (ds_full), free again once consumer Q's product
// read it (ds_free). Q and dO are loaded once a tile and have barriers of
// their own: consumer S frees each once its last product reading it is done,
// so the next tile's Q loads under the last step's dP and both under its dS
// and dQ. K and V walk rings whose step count g carries on across the
// block's tiles: a K stage is freed by both consumers (its score product,
// then dQ), a V stage by consumer S alone. Consumer Q stages the tile's dq
// in its last K stage (nothing reads it any more) and frees that stage once
// the TMA store has read it.
struct DqWideSmem {
  bf16 q[TILE * WIDE_D];
  bf16 dout[TILE * WIDE_D];
  bf16 k[STAGES][TILE * WIDE_D];
  bf16 v[STAGES][TILE * WIDE_D];
  bf16 ds[2][TILE * TILE];
  uint64_t q_full, q_empty, do_full, do_empty, k_full[STAGES], k_empty[STAGES], v_full[STAGES],
      v_empty[STAGES], ds_full[2], ds_free[2];
};

// Consumer S on q tile iq of head bh, kv tiles 0..n_kv-1: per step S and dP
// (each score product over depth 256 as 16 m64n64k16, both operands K-major),
// K_j and Q freed once S is done, V_j and dO once dP is; dS = P o (dP -
// delta) as dq_kernel forms it (ds_step), rounded once to bf16 into its
// buffer. g: the block's steps before this tile; tt: its tiles before it.
__device__ __forceinline__ void dq_wide_tile_s(DqWideSmem& sm, const float* __restrict__ lse,
                                               const float* __restrict__ delta, int bh, int iq,
                                               int n_kv, int T, int causal, float scale, int g,
                                               int tt, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's q rows: r0 and r0 + 8
  const float scale_log2 = scale * LOG2E;
  const size_t row = (size_t)bh * T + iq * TILE + r0;
  const float lse2[2] = {lse[row] * LOG2E, lse[row + 8] * LOG2E};
  const float del[2] = {delta[row], delta[row + 8]};
  float sc[32], dp[32];
  sm90::mbar_wait(&sm.q_full, tt & 1);
  sm90::mbar_wait(&sm.do_full, tt & 1);

  for (int j = 0; j < n_kv; ++j, ++g) {
    const int s = g % STAGES, b = g & 1;
    const bool last = j == n_kv - 1;
    sm90::mbar_wait(&sm.k_full[s], (g / STAGES) & 1);
    sm90::mbar_wait(&sm.v_full[s], (g / STAGES) & 1);
    zero(sc);
    zero(dp);
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    product_ss<WIDE_D>(sc, sm.q, sm.k[s]);
    sm90::wgmma_commit();
    product_ss<WIDE_D>(dp, sm.dout, sm.v[s]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S; dP still in flight
    sm90::fence_regs(sc);
    sm90::mbar_arrive(&sm.k_empty[s]);
    if (last) sm90::mbar_arrive(&sm.q_empty);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    sm90::mbar_arrive(&sm.v_empty[s]);
    if (last) sm90::mbar_arrive(&sm.do_empty);

    ds_step(sc, dp, lse2, del, scale_log2, causal && j == iq, r0, t);
    if (g >= 2) sm90::mbar_wait(&sm.ds_free[b], ((g >> 1) - 1) & 1);
    stage_block(sm.ds[b], sc, 1.f, 1.f, r0, t);
    sm90::fence_proxy_async();  // the generic-proxy stores, before wgmma reads them
    sm90::mbar_arrive(&sm.ds_full[b]);
  }
}

// Consumer Q on the same tile: per step dq += dS K_j, then dS's buffer and
// (but at the last step) K_j's stage freed; dq = scale * the sum, through
// the last step's K stage to one TMA store.
__device__ __forceinline__ void dq_wide_tile_q(DqWideSmem& sm, const CUtensorMap* dq_map, int bh,
                                               int iq, int n_kv, float scale, int g, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  float acc[4][32];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) zero(acc[cb]);

  for (int j = 0; j < n_kv; ++j, ++g) {
    const int s = g % STAGES, b = g & 1;
    sm90::mbar_wait(&sm.ds_full[b], (g >> 1) & 1);
    sm90::mbar_wait(&sm.k_full[s], (g / STAGES) & 1);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      sm90::wgmma_ss_n256_mn(acc, sm90::desc_k(sm.ds[b], kk), sm90::desc_mn(sm.k[s], kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) sm90::fence_regs(acc[cb]);
    sm90::mbar_arrive(&sm.ds_free[b]);
    if (j < n_kv - 1) sm90::mbar_arrive(&sm.k_empty[s]);
  }
  const int s = (g - 1) % STAGES;
  stage_tile(sm.k[s], acc, scale, scale, r0, t);
  store_staged(dq_map, sm.k[s], BAR_DQ_STORE, iq * TILE, bh, tid);
  if (tid == 0) {
    sm90::bulk_wait_read();
    sm90::mbar_arrive_count(&sm.k_empty[s], WG_THREADS);
  }
}

// The head-dim-256 dQ (GPT-J's): persistent blocks, at most one an SM, each
// walking its q tiles (wide_tile, group 1: a head's tiles one after
// another, so the blocks running together read the same k and v, and each
// round of blocks holds walks of every length); dq as dq_kernel computes
// it. Warpgroup 0 produces: its thread 0 walks the K ring and its thread 32
// the V ring over all the block's tiles, its thread 64 loads each tile's Q
// and dO once the tile before is done with them, so a tile's first stages
// load under the last steps of the one before. Warpgroups 1 and 2 are
// consumers S and Q.
__global__ void __launch_bounds__(WIDE_THREADS, 1)
dq_wide_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
               const float* __restrict__ delta, int BH, int T, int H, int KV, float scale,
               int causal) {
  DqWideSmem& sm = *reinterpret_cast<DqWideSmem*>(sm90::smem_1024());
  const int n_tiles = T / TILE, n = BH * n_tiles;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    sm90::mbar_init(&sm.do_full, 1);
    sm90::mbar_init(&sm.q_empty, WG_THREADS);
    sm90::mbar_init(&sm.do_empty, WG_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(&sm.k_full[st], 1);
      sm90::mbar_init(&sm.v_full[st], 1);
      sm90::mbar_init(&sm.k_empty[st], 2 * WG_THREADS);
      sm90::mbar_init(&sm.v_empty[st], WG_THREADS);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&sm.ds_full[b], WG_THREADS);
      sm90::mbar_init(&sm.ds_free[b], WG_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  WideTile tile;
  if (wg == 0) {
    sm90::setmaxnreg_dec<PP_PRODUCER_REGS>();
    if (threadIdx.x == 0 || threadIdx.x == 32) {  // the K ring, the V ring
      const bool is_k = threadIdx.x == 0;
      for (int r = 0, g = 0; wide_tile(tile, r, n, BH, n_tiles, 1, causal); ++r) {
        const int bkv = (tile.mat / H) * KV + (tile.mat % H) / (H / KV);
        const int n_kv = causal ? tile.row + 1 : n_tiles;
        for (int j = 0; j < n_kv; ++j, ++g) {
          if (is_k)
            load_ring_at<WIDE_D>(sm.k, sm.k_full, sm.k_empty, &k_map, g, j, bkv);
          else
            load_ring_at<WIDE_D>(sm.v, sm.v_full, sm.v_empty, &v_map, g, j, bkv);
        }
      }
    } else if (threadIdx.x == 64) {
      for (int r = 0; wide_tile(tile, r, n, BH, n_tiles, 1, causal); ++r) {
        if (r > 0) sm90::mbar_wait(&sm.q_empty, (r - 1) & 1);
        sm90::mbar_expect_tx(&sm.q_full, TILE * WIDE_D * 2);
        load_tile_tma<WIDE_D>(sm.q, &q_map, &sm.q_full, tile.row * TILE, tile.mat);
        if (r > 0) sm90::mbar_wait(&sm.do_empty, (r - 1) & 1);
        sm90::mbar_expect_tx(&sm.do_full, TILE * WIDE_D * 2);
        load_tile_tma<WIDE_D>(sm.dout, &do_map, &sm.do_full, tile.row * TILE, tile.mat);
      }
    }
  } else {
    sm90::setmaxnreg_inc<PP_CONSUMER_REGS>();
    const int tid = threadIdx.x - wg * WG_THREADS;
    for (int r = 0, g = 0; wide_tile(tile, r, n, BH, n_tiles, 1, causal); ++r) {
      const int n_kv = causal ? tile.row + 1 : n_tiles;
      if (wg == 1)
        dq_wide_tile_s(sm, lse, delta, tile.mat, tile.row, n_kv, T, causal, scale, g, r, tid);
      else
        dq_wide_tile_q(sm, &dq_map, tile.mat, tile.row, n_kv, scale, g, tid);
      g += n_kv;
    }
  }
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

int launch_fwd_pingpong(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                        const CUtensorMap& om, void* lse, int BH, int T, int H, int KV,
                        float scale, int causal, cudaStream_t s) {
  constexpr int smem = smem_bytes<PingPongSmem>();
  const cudaError_t err = allow_smem(fwd_pingpong_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // causal: heavy first across heads that share the L2; full: a head's q
  // blocks one after another (group 1), so that those reading its k and v
  // run together
  fwd_pingpong_kernel<<<BH * ((T / TILE + 1) / 2), PP_THREADS, smem, s>>>(
      qm, km, vm, om, (float*)lse, BH, T, H, KV, scale, causal,
      causal ? l2_group(BH, T, PP_D) : 1);
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

int launch_dq_wide(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const CUtensorMap& dom, const CUtensorMap& dqm, const void* lse,
                   const void* delta, int BH, int T, int H, int KV, float scale, int causal,
                   cudaStream_t s) {
  constexpr int smem = smem_bytes<DqWideSmem>();
  static_assert(smem <= 232448, "dq_wide_kernel: over the 227 KB a block may hold");
  cudaError_t err = allow_smem(dq_wide_kernel, smem);
  int dev, sms;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n = BH * (T / TILE);  // tiles; one block an SM
  dq_wide_kernel<<<n < sms ? n : sms, WIDE_THREADS, smem, s>>>(
      qm, km, vm, dom, dqm, (const float*)lse, (const float*)delta, BH, T, H, KV, scale, causal);
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

int launch_dkv_wide(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                    const CUtensorMap& dom, const CUtensorMap& dkm, const CUtensorMap& dvm,
                    const void* lse, const void* delta, int BKV, int T, int H, int KV,
                    float scale, int causal, cudaStream_t s) {
  constexpr int smem = smem_bytes<DkvWideSmem>();
  static_assert(smem <= 232448, "dkv_wide_kernel: over the 227 KB a block may hold");
  cudaError_t err = allow_smem(dkv_wide_kernel, smem);
  int dev, sms;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one block an SM. causal: kv heads in groups whose Q and dO (the H / KV
  // q heads of each) take at most half the L2, so the tiles reading one q
  // tile run close together; full: a head's kv tiles one after another
  // (group 1), all reading the same q tiles
  const int n = BKV * (T / TILE);
  dkv_wide_kernel<<<n < sms ? n : sms, WIDE_THREADS, smem, s>>>(
      qm, km, vm, dom, dkm, dvm, (const float*)lse, (const float*)delta, BKV, T, H, KV, scale,
      causal, causal ? l2_group(BKV, T * (H / KV), WIDE_D) : 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BH,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const int BKV = BH / H * KV;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(qm, km, vm, o, lse, q_sh, q_st, BH, T, H, KV, scale, causal, s);
    case 128:
      return launch_fwd<128>(qm, km, vm, o, lse, q_sh, q_st, BH, T, H, KV, scale, causal, s);
    default: {
      CUtensorMap om;
      if ((err = sm90::encode_tile_map(&om, o, D, T, BH, q_st, q_sh))) return err;
      return launch_fwd_pingpong(qm, km, vm, om, lse, BH, T, H, KV, scale, causal, s);
    }
  }
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, long long q_sh,
             int q_st, long long kv_sh, int kv_st, int BH, int T, int D, int H,
             int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const int BKV = BH / H * KV;
  CUtensorMap qm, km, vm, dom;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&dom, dout, D, T, BH, q_st, q_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SATURN_DQ(d) \
  launch_dq<d>(qm, km, vm, dom, lse, delta, dq, q_sh, q_st, BH, T, H, KV, scale, causal, s)
  switch (D) {
    case 64: return SATURN_DQ(64);
    case 128: return SATURN_DQ(128);
    default: {
      CUtensorMap dqm;
      if ((err = sm90::encode_tile_map(&dqm, dq, D, T, BH, q_st, q_sh))) return err;
      return launch_dq_wide(qm, km, vm, dom, dqm, lse, delta, BH, T, H, KV, scale, causal, s);
    }
  }
#undef SATURN_DQ
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              long long q_sh, int q_st, long long kv_sh, int kv_st, int BKV,
              int T, int D, int H, int KV, float scale, int causal, void* stream) {
  if (D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const int BH = BKV / KV * H;
  CUtensorMap qm, km, vm, dom;
  int err;
  if ((err = sm90::encode_tile_map(&qm, q, D, T, BH, q_st, q_sh)) ||
      (err = sm90::encode_tile_map(&km, k, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&vm, v, D, T, BKV, kv_st, kv_sh)) ||
      (err = sm90::encode_tile_map(&dom, dout, D, T, BH, q_st, q_sh)))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SATURN_DKV(d) \
  launch_dkv<d>(qm, km, vm, dom, lse, delta, dk, dv, kv_sh, kv_st, BKV, T, H, KV, scale, causal, s)
  switch (D) {
    case 64: return SATURN_DKV(64);
    case 128: return SATURN_DKV(128);
    default: {
      CUtensorMap dkm, dvm;
      if ((err = sm90::encode_tile_map(&dkm, dk, D, T, BKV, kv_st, kv_sh)) ||
          (err = sm90::encode_tile_map(&dvm, dv, D, T, BKV, kv_st, kv_sh)))
        return err;
      return launch_dkv_wide(qm, km, vm, dom, dkm, dvm, lse, delta, BKV, T, H, KV, scale, causal,
                             s);
    }
  }
#undef SATURN_DKV
}

}  // extern "C"
