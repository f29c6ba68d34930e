// Fused softmax cross-entropy, forward (K1) and backward (K2), for Hopper
// (sm_90a), bound to Python by ctypes.
//
// Replaces the JAX package's Pallas TPU kernels ops/xent.py:40 _fwd_kernel
// (K1: loss[i] = logsumexp(x[i]) - x[i, y[i]], float32 whatever the logits
// dtype) and ops/xent.py:53 _bwd_kernel (K2: dx = (softmax(x) - onehot(y))
// * g, in the logits dtype).
//
// Layout: logits x (N, C) float32 or bf16, rows `ld` elements apart and
// contiguous within a row; labels y (N,) int32; g (N,) float32 read with
// element stride `g_stride` (0 for the stride-0 tensor autograd hands the
// backward of a mean); loss (N,) float32 and dx (N, C) contiguous.
//
// Design.  One warp owns one row; a block of 256 threads holds 8 rows.  The
// warp walks the row in strided passes of 32 columns, so any C works: a
// row max by warp shuffles, then the sum of exp(x - max), then
// lse = log(sum) + max, all in float32 on values converted at load.  K1
// picks x[label] and writes lse - picked.  K2 recomputes max and sum from
// the logits alone, as the TPU kernel does, and writes
// (exp(x - max) / sum - onehot) * g[row]; nothing is saved between the two
// kernels, so each stands alone.  The TPU pads rows to 8 and classes to 128
// with -1e30; here the row and column indices are bound-checked and no
// padded copy is made.  A label outside [0, C) matches no column, so picked
// is 0 and the loss is lse, the TPU kernel's answer for such a label.  (A
// label in the TPU's padded columns, C <= y < ceil(C/128)*128, would pick the
// -1e30 fill there; that padding artifact is not reproduced.)
//
// What bounds it on this card: at the training path's (128, 10) float32
// shape K1 moves 6 KB (5 KB of logits, 512 B of labels, 512 B of loss) and
// K2 11 KB (logits in, labels, g, dx out): a couple of nanoseconds at
// 3.35 TB/s, and a few thousand FLOPs.  Both are bound by launch latency,
// not by bytes or arithmetic.  What the design does about it: one launch
// per kernel per step, no padded copy, no cast of the logits or of g in
// the wrapper (the kernel converts on load), and the softmax is never
// materialised in device memory.  Nothing more is done to make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int ROWS = NT / 32;        // rows per block, one warp each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row max and sum of exp(x - max) over one row, reduced across the warp.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int c, int lane, float& m, float& s) {
  m = -CUDART_INF_F;
  for (int j = lane; j < c; j += 32) m = fmaxf(m, to_f(row[j]));
  m = warp_max(m);
  s = 0.f;
  for (int j = lane; j < c; j += 32) s += expf(to_f(row[j]) - m);
  s = warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(NT) xent_fwd_kernel(
    const T* __restrict__ x, const int* __restrict__ y, float* __restrict__ loss,
    int n, int c, long long ld) {
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n) return;  // whole warps leave together: r is uniform in a warp
  const T* row = x + (long long)r * ld;
  float m, s;
  row_stats(row, c, lane, m, s);
  if (lane == 0) {
    const int lab = y[r];
    const float picked = (lab >= 0 && lab < c) ? to_f(row[lab]) : 0.f;
    loss[r] = logf(s) + m - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) xent_bwd_kernel(
    const T* __restrict__ x, const int* __restrict__ y, const float* __restrict__ g,
    long long g_stride, T* __restrict__ dx, int n, int c, long long ld) {
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const T* row = x + (long long)r * ld;
  float m, s;
  row_stats(row, c, lane, m, s);
  const float inv = 1.f / s;
  const float gr = g[(long long)r * g_stride];
  const int lab = y[r];
  T* out = dx + (long long)r * c;
  for (int j = lane; j < c; j += 32) {
    const float p = expf(to_f(row[j]) - m) * inv;
    out[j] = from_f<T>((p - (j == lab ? 1.f : 0.f)) * gr);
  }
}

inline unsigned blocks(int n) { return (unsigned)((n + ROWS - 1) / ROWS); }

}  // namespace

// Both entry points return a cudaError_t value: 0 when the launch was
// accepted.  The Python wrapper validates shapes, dtypes and strides first.
extern "C" int xent_fwd(const void* x, const void* y, void* loss, int n, int c,
                        long long ld, int is_bf16, void* stream) {
  if (n < 1 || c < 1 || ld < c) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* yy = static_cast<const int*>(y);
  float* out = static_cast<float*>(loss);
  if (is_bf16)
    xent_fwd_kernel<__nv_bfloat16><<<blocks(n), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), yy, out, n, c, ld);
  else
    xent_fwd_kernel<float><<<blocks(n), NT, 0, st>>>(
        static_cast<const float*>(x), yy, out, n, c, ld);
  return (int)cudaGetLastError();
}

extern "C" int xent_bwd(const void* x, const void* y, const void* g, long long g_stride,
                        void* dx, int n, int c, long long ld, int is_bf16, void* stream) {
  if (n < 1 || c < 1 || ld < c || g_stride < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* yy = static_cast<const int*>(y);
  const float* gg = static_cast<const float*>(g);
  if (is_bf16)
    xent_bwd_kernel<__nv_bfloat16><<<blocks(n), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), yy, gg, g_stride,
        static_cast<__nv_bfloat16*>(dx), n, c, ld);
  else
    xent_bwd_kernel<float><<<blocks(n), NT, 0, st>>>(
        static_cast<const float*>(x), yy, gg, g_stride, static_cast<float*>(dx), n, c, ld);
  return (int)cudaGetLastError();
}
