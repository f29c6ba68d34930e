// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by the
// bf16 flash-attention kernels in flash_fwd.cu and flash_bwd.cu.
//
// * mma_bf16: mma.sync m16n8k16, bf16 operands, float32 accumulators.
// * ldmatrix_x4 / ldmatrix_x4_t: four 8 x 8 bf16 matrices from shared memory
//   into the fragment layout mma.sync takes (_t: transposed on the way).
// * cp_async16 / cp_async4: asynchronous global -> shared copies, zero-filled
//   where the predicate is false, with commit / wait for a two-stage ring.
// * load_rows: a (ROWS, DT) bf16 tile with padded rows by cp.async.
//
// Fragment layouts (lane = 4 * gid + tig): an A fragment (16 x 16, row
// major) holds rows gid and gid + 8, columns 2 tig, 2 tig + 1 and those + 8;
// a B fragment (16 x 8) holds k rows 2 tig, 2 tig + 1 (and + 8) of column
// gid; a C fragment (16 x 8 float32) holds rows gid and gid + 8, columns
// 2 tig and 2 tig + 1.  Two adjacent C fragments (16 x 16) are exactly one
// A fragment, which is how a product's result feeds the next product from
// registers.
//
// Shared tiles are bf16 with rows padded by 8 elements (16 bytes): a row of
// 2 * DT + 16 bytes moves each of eight consecutive rows to its own 16-byte
// bank group, so every ldmatrix phase is free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b: (16 x 16) bf16 by (16 x 8) bf16 into (16 x 8) float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lanes 8i .. 8i + 7 give the row addresses of matrix i; register i holds
// matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// This lane's row and column offsets (within a 16 x 16 block) of its
// ldmatrix address, for:
//   a_row / a_col: an A fragment read as ldmatrix_x4 from row-major (m, k)
//           storage, and a B fragment pair (two n-tiles of 8) read as
//           ldmatrix_x4_t from row-major (k, n) storage;
//   b_row / b_col: a B fragment pair read as ldmatrix_x4 from (n, k)
//           storage, and an A fragment read as ldmatrix_x4_t from (k, m)
//           storage.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four C fragments' worth of a 16 x 16 float tile (n-tiles j and j + 1)
// rounded to bf16 as one A fragment.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until every committed group has landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [r0, r0 + ROWS) of a (rows, D) bf16 slice with row stride `rs`
// (elements) into a (ROWS, DT + 8) shared tile, 16 bytes a thread per
// step; rows at or past `end` and columns at or past D (D <= DT, a
// multiple of 8) are zero-filled.  Needs `src` and `rs * 2` 16-byte aligned.
template <int ROWS, int DT, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs,
                                          int r0, int end, int D) {
  constexpr int CH = DT / 8;  // 16-byte chunks a row
  constexpr int LD = DT + 8;
  constexpr int STEPS = (ROWS * CH + NT - 1) / NT;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int i = threadIdx.x + j * NT;
    if ((ROWS * CH) % NT != 0 && i >= ROWS * CH) break;
    const int r = i / CH, c = i % CH;
    const int row = r0 + r;
    const bool in = row < end && c * 8 < D;
    cp_async16(dst + r * LD + c * 8, in ? src + (long long)row * rs + c * 8 : src, in);
  }
}

}  // namespace tc
