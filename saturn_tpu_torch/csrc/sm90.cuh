// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, named barriers and setmaxnreg, TMA tile loads and stores and the
// host-side tensor-map encodes, wgmma shared-memory descriptors, the
// m64n64k16 and m64n256k16 bf16 products (each with A from shared memory or
// from registers), ldmatrix, plain and transposed, and stmatrix.
//
// Tiles: a 64-row bf16 tile that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B
// from 64 x 64 boxes (encode_tile_map) lies in shared memory as D / 64
// column blocks of 8 KB, each 1024-byte aligned. In a block, row r sits at
// 128 r bytes and its eight 16-byte chunks are XOR-swizzled by r % 8. wgmma
// reads such a tile two ways:
//   - K-major (desc_k): the columns are the product's depth (Q, K, V, dO as
//     the left operand or as B = rows^T);
//   - MN-major (desc_mn): the rows are the product's depth, the columns its
//     output (V in P V, dO in P^T dO, Q in dS^T Q, K in dS K, x in ds^T x,
//     W in ds W), through the transpose bit of the B operand; no transposed
//     copy is made.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BOX = 64;                  // rows and columns of one TMA box
constexpr int BLOCK_BYTES = BOX * BOX * 2;  // one 64 x 64 bf16 column block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle repeats every 1024 bytes): launch with 1 KB to spare.
__device__ __forceinline__ unsigned char* smem_1024() {
  extern __shared__ __align__(1024) unsigned char sm90_dynamic_smem[];
  const uint32_t a = smem_addr(sm90_dynamic_smem);
  return sm90_dynamic_smem + ((1024u - (a & 1023u)) & 1023u);
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After every mbar_init of the block, before the barriers are used.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive `count` times at once (one thread standing for several).
__device__ __forceinline__ void mbar_arrive_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// of seconds can only be a deadlock: it stores to address 0, which ends the
// kernel with an illegal-address error at the caller's next synchronize,
// instead of hanging the card. Not a trap: where wgmma batches are in flight,
// ptxas would wait for them before the trap (advisory C7517).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > (1ll << 33))
      asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0) : "memory");
  }
}

// --------------------------------------------------- named barriers, registers
// Named barrier `id` (1-15: __syncthreads takes 0) of `threads` threads, a
// multiple of 32: bar_sync waits until that many have arrived or synced,
// bar_arrive counts this thread's warp and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Give back registers down to N a thread / take them up to N, for the whole
// warpgroup (its four warps execute it together). A kernel that uses them
// branches once into its roles and never reconverges, or ptxas ignores them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (ex2.approx, denormals flushed).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------------------- TMA
// One box of a 3-d tensor map at (c0, c1, c2), innermost first, into `dst`;
// completes on `bar` (which must expect its bytes).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 1-d tensor map at element c0 into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// into `dst`; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box from shared memory `src` into a 3-d tensor map at (c0, c1, c2);
// what lies past the array is not written. Before it, the threads that wrote
// `src` each call fence_proxy_async and then synchronize with this one.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(src))
      : "memory");
}

// Make this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Close this thread's group of TMA stores issued since the last commit.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed TMA stores have read their shared
// memory (it may then be written again).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's committed TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Host: cuTensorMapEncodeTiled, looked up through the runtime, so nothing
// links against libcuda. A cudaError_t value, 0 on success.
inline int encode_tiled(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return 0;
}

// Host: a tensor map for boxes of BOX columns x box_rows rows of bf16 of an
// (n, rows, cols) array with contiguous columns and element strides
// row_stride and mat_stride, laid out in shared memory with the 128-byte
// swizzle; what lies past the array reads as 0 (and a store does not write
// it). Returns a cudaError_t value, 0 on success.
inline int encode_tile_map(CUtensorMap* map, const void* base, int cols, int rows, int n,
                           long long row_stride, long long mat_stride, int box_rows = BOX) {
  EncodeTiled encode;
  if (const int err = encode_tiled(&encode)) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)mat_stride * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Host: a tensor map for boxes of BOX 4-byte elements (`type`: float32 or
// int32) of a contiguous (n,) array, 16-byte aligned; elements past n read
// as 0. Returns a cudaError_t value, 0 on success.
inline int encode_vec_map(CUtensorMap* map, const void* base, int n, CUtensorMapDataType type) {
  EncodeTiled encode;
  if (const int err = encode_tiled(&encode)) return err;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {0};
  const cuuint32_t box[1] = {BOX}, unit[1] = {1};
  const CUresult r = encode(map, type, 1, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Columns [16 kk, 16 kk + 16) of a 64-row tile, K-major: the chunk's start
// moves 32 bytes along the swizzled row, 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc_sw128(static_cast<const unsigned char*>(tile) + (kk / 4) * BLOCK_BYTES +
                        (kk % 4) * 32,
                    16, 1024);
}

// Rows [16 kk, 16 kk + 16) of a tile's 64-column blocks, from the first at
// `block`, MN-major: 64 columns are one swizzle atom, groups of 8 rows are
// 1024 bytes apart, and the next 64 columns are the next block (the leading
// byte offset, read only by a product wider than 64).
__device__ __forceinline__ uint64_t desc_mn(const void* block, int kk) {
  return desc_sw128(static_cast<const unsigned char*>(block) + kk * 2048, BLOCK_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in place across the asynchronous products: the compiler may
// neither read an accumulator before wgmma_wait nor reuse an operand
// register while a product may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_ACC32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_ACC32_OPERANDS(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B^T, both from shared memory K-major
// (B is 64 rows over the same depth); accumulate = 0 overwrites d.
// Accumulator layout: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4); d[4 n + e] is row 16 w + g + 8 (e / 2),
// column 8 n + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC32_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B, with B
// (16 x 64) read MN-major from shared memory through the transpose bit. A is
// laid out as mma.sync's m16n8k16 A operand per warp: a[0] = row g, columns
// 2 t..2 t+1; a[1] = row g + 8; a[2], a[3] the same at columns + 8 — which is
// the accumulator layout of columns 16 kk..16 kk+15, packed in pairs.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The 128 f32 accumulators of a 64 x 256 product, d[4][32]: d[cb] holds
// columns 64 cb .. 64 cb + 63 in the layout of wgmma_ss.
#define SM90_ACC128                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "         \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "     \
  "%124, %125, %126, %127}"
#define SM90_ACC128_OPERANDS(d)                                                       \
  SM90_ACC32_OPERANDS(d[0]), SM90_ACC32_OPERANDS(d[1]), SM90_ACC32_OPERANDS(d[2]), \
      SM90_ACC32_OPERANDS(d[3])

// wgmma_rs over 256 columns: B from four consecutive 64-column blocks.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[4][32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : SM90_ACC128_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// wgmma_ss over 256 columns: d (64 x 256, f32) (+)= A (64 x 16) B^T, both
// K-major in shared memory, B 256 rows over the same depth whose 8-row groups
// lie 1024 bytes apart (four 64-row tiles one after another, as desc_k reads
// each); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[4][32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC128_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256, f32) += A (64 x 16) B: A K-major in shared memory (desc_k), B
// (16 x 256) read MN-major through the transpose bit, as wgmma_rs_n256 reads
// it (desc_mn over four consecutive 64-column blocks).
__device__ __forceinline__ void wgmma_ss_n256_mn(float (&d)[4][32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : SM90_ACC128_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

#undef SM90_ACC128
#undef SM90_ACC128_OPERANDS
#undef SM90_ACC32
#undef SM90_ACC32_OPERANDS

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 i ..
// 8 i + 7 give the row addresses of matrix i, and register i of lane (g, t)
// receives {M_i[2 t][g], M_i[2 t + 1][g]}.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8 x 8 bf16 matrices from shared memory, as they lie: lanes 8 i ..
// 8 i + 7 give the row addresses of matrix i, and register i of lane (g, t)
// receives {M_i[g][2 t], M_i[g][2 t + 1]}. With matrices 0-3 at (rows, depth)
// + (0, 0), (8, 0), (0, 8), (8, 8) of a 16 x 16 tile that is row-major over
// the depth, that is wgmma's register A layout (wgmma_rs).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8 x 8 bf16 matrices into shared memory, the inverse of ldmatrix_x4:
// lanes 8 i .. 8 i + 7 give the row addresses of matrix i, and register i of
// lane (g, t) holds {M_i[g][2 t], M_i[g][2 t + 1]}, which is the accumulator
// layout of wgmma_ss packed in bf16 pairs.
__device__ __forceinline__ void stmatrix_x4(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

}  // namespace sm90
