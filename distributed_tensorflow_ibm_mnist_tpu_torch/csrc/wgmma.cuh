// Warpgroup-level building blocks for Hopper (sm_90a): wgmma on tiles that
// TMA copies into shared memory, with mbarriers between the copying warp
// and the computing warpgroups.  Used by K6b in flash_bwd.cu.
//
// * Tiles.  A TMA box is 64 rows x 64 bf16 (128 bytes a row) with the
//   128-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ (r % 8),
//   so a box is 8 KB and its base must be 1024-byte aligned.  A row wider
//   than 64 (head_dim 128) is two boxes, 8 KB apart.
// * Descriptors.  The same box serves both operand majors:
//   - kmajor_desc: rows are M or N, the 64 columns are K (Q, dO, K, V in
//     S = Q K^T and dP = dO V^T).  8-row groups are 1024 bytes apart
//     (SBO); a 16-wide k-step moves the start address by 32 bytes, inside
//     the swizzle atom (the hardware swizzles the final address).
//   - mnmajor_desc: rows are K, the 64 columns are N (K in dQ = dS K, read
//     with the transpose bit).  8 k-rows are 1024 bytes apart (SBO); a
//     k-step of 16 rows moves the start by 2048 bytes.
// * wgmma_ss / wgmma_rs_t: m64n64k16, bf16 operands, float32 accumulators,
//   A from shared memory (ss) or registers (rs), B from shared memory
//   (K-major for ss, MN-major for rs_t).  The accumulator layout of a
//   warpgroup is the mma.sync C layout per warp (tc.cuh): value i of a
//   thread sits at row 16 w + gid + 8 ((i >> 1) & 1) of warp w, column
//   8 (i >> 2) + 2 tig + (i & 1); a register A operand is the mma.sync A
//   fragment of the warp's 16 rows.  So two adjacent n-tiles of an
//   accumulator are one A k-step (tc::c_to_a).
// * mbarriers and the 4-D TMA load (cp.async.bulk.tensor) with
//   complete_tx: the copying thread arms a barrier with the bytes it
//   expects, and the barrier's phase completes when they have landed.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc.cuh"

namespace wg {

constexpr int BOX = 64;                          // rows and columns of a box
constexpr int BOX_BYTES = BOX * BOX * 2;         // 8 KB

// 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = tc::smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k-step kk (16 columns) of a K-major operand held as 64-column boxes
__device__ __forceinline__ uint64_t kmajor_desc(const __nv_bfloat16* tile, int kk) {
  return make_desc(reinterpret_cast<const char*>(tile) + (kk / 4) * BOX_BYTES + (kk % 4) * 32,
                   16, 1024);
}

// k-step kk (16 rows) and n-box nb (64 columns) of an MN-major operand
__device__ __forceinline__ uint64_t mnmajor_desc(const __nv_bfloat16* tile, int kk, int nb) {
  return make_desc(reinterpret_cast<const char*>(tile) + nb * BOX_BYTES + kk * 2048,
                   BOX_BYTES, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for a register A operand (four bf16x2 fragments per k16 step):
// a wgmma reads its A registers asynchronously, until the wait that
// retires it.
template <int K>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define WG_OUT32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B: A (64 x 16) and B (16 x 64) both K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B: A (64 x 16 bf16) from registers (the mma.sync A fragment of
// each warp's 16 rows), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_OUT32

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar))
               : "memory");
}

// One arrival that also adds `bytes` to the transaction count the phase
// waits for.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: waiting on parity 1 returns at once).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = tc::smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is reported to `bar`.  Out-of-bounds elements
// are filled with zeros and still count toward the box's bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace wg
