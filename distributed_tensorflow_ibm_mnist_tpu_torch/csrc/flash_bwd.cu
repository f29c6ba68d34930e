// Flash-attention backward for Hopper (sm_90a), bound to Python by ctypes.
//
// Replaces the JAX package's Pallas TPU backward kernels
// (distributed_tensorflow_ibm_mnist_tpu/ops/flash_attention.py):
//   flash_bwd_fused, one group  -> _fused_bwd_kernel (K4) with the shared
//                                  recompute chain _bwd_tile_chain;
//   flash_bwd_fused, G groups   -> _grouped_bwd_kernel (K5);
//   flash_bwd_dkv               -> _dkv_kernel (K6a);
//   flash_bwd_dq                -> _dq_kernel (K6b).
// Each recomputes the probabilities from the forward's natural-log row
// logsumexp, P = exp(s * scale - lse), then dP = dO V^T and
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O), and
// accumulates dV = P^T dO, dK = dS^T Q and dQ = dS K.  As on the TPU, P and
// dS are rounded to the input dtype before they enter a product (the
// MXU-operand cast), and every sum runs in float32.
//
// Layout: q/dO (B, S, H, D), k/v (B, S, H_kv, D), read through their element
// strides (only the last dim contiguous); lse and delta (B, S, H) float32
// contiguous.  GQA is by head index: q head h reads kv head h / (H / H_kv),
// and dK/dV come out per q head, (B, S, H, D) contiguous; the wrapper sums
// them per kv head.  S needs no padding: rows and columns past S are bound
// checks, and the pad-row masks of _bwd_tile_chain become: dK/dV mask the q
// rows past S (and past the group), dQ masks no q row (its rows past S are
// never written).
//
// Design.  The TPU walks a sequential grid and carries sums in VMEM scratch
// from step to step; here blocks run in parallel, so each sequential grid
// axis becomes a loop inside one block.  The k-tile walk (K4, K5, K6a) has
// two designs, chosen by the dtype flag (is_bf16) that every entry takes,
// not as a fallback; K6b keeps the scalar design in both dtypes:
//
// * bf16 K4 / K5 / K6a: flash_bwd_kv_tc, on the tensor cores.  A block of NW
//   warps (4 at D <= 64, three blocks an SM; 8 at D = 128) owns one
//   (batch*head, 16 NW-row k-tile, q-row group); warp w owns k rows
//   16w .. 16w + 15 and keeps their dK, dV in registers (float32 mma.sync
//   accumulators) for the whole walk over the group's live 64-row q-tiles.
//   K and V sit in shared memory as bf16 for the walk; Q, dO and the row
//   statistics come by cp.async into a two-stage ring, so the next
//   q-tile's copy overlaps this one's products.  Per q-tile each warp
//   computes S^T = K Q^T and dP^T = V dO^T (mma.sync m16n8k16, operands by
//   ldmatrix from rows padded by 16 bytes: no bank conflicts), then P^T and
//   dS^T in registers; rounded to bf16 (the TPU's MXU-operand cast) they are
//   the A operands of dV += P^T dO and dK += dS^T Q as they stand, with dO
//   and Q read transposed by ldmatrix.trans.  With dQ (K4, K5), dS^T goes to
//   shared memory as bf16 and the block adds this tile's dQ = dS K into a
//   float32 (B, S, H, D) buffer that the wrapper zeroed, by float4
//   atomicAdd (sm_90: one instruction for four floats).  The order of those
//   adds changes from run to run, so K4/K5's dQ is not bitwise reproducible
//   (float32 rounding of the sum only).  With one group dK/dV are written
//   in bf16 (K4); with G groups (K5) each group writes float32 partials
//   (G, B, S, H, D) that the wrapper sums and rounds once; K6a is the same
//   walk without dQ, deterministic.  Head dims below the instance's width
//   (32, 64 or 128) are zero-padded in shared memory, and only tiles that
//   cross a mask edge build the mask.
// * float32 K4 / K5 / K6a: flash_bwd_kv_kernel, scalar float32 FMAs on the
//   CUDA cores, 256 threads a 64-row k-tile, tiles in shared memory as
//   float32 with an odd (D + 1) row stride; the tensor cores have no
//   float32 product that keeps the float32 checks, and no path the port
//   trains or serves runs attention in float32.
// * K6b, both dtypes: flash_bwd_dq_kernel, the scalar design: a block owns
//   one (batch*head, 64-row q-tile), keeps Q and dO in shared memory and dQ
//   in registers, and loops over the live k-tiles (k <= q, k > q - window)
//   as the forward does; deterministic.
//
// What bounds it at the training path's shapes (B=8, S=8192, H=8, D=64,
// bf16, causal): on the roofline, operations.  Five products of 2*D FLOPs
// per live (q, k) pair, 2.15e9 pairs: 1.37 TFLOP against 0.47 GB of inputs
// and outputs (0.14 ms at 3.35 TB/s), ~1.4 ms at the bf16 tensor-core
// peak.  mma.sync reaches only part of that peak (wgmma alone reaches all
// of it); each warp reads the whole Q/dO tile from shared memory twice
// (plain for S^T and dP^T, transposed for dV and dK), so ldmatrix traffic
// is the next limit; the dQ atomics (one float4 per 4 dQ elements per
// k-tile) and the per-tile barriers follow.  At D=128 the 128 dK/dV
// accumulator registers a thread leave the kernel at 255 registers with a
// few bytes of spill (see the ptxas log that the build keeps).  Next:
// wgmma with TMA-fed Q/dO tiles and a producer warp; K6b on the same
// building blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // k rows per tile
constexpr int NT = 256;        // threads per block
constexpr int PS = BK + 1;     // padded row stride of the P / dS tiles
static_assert(BQ == BK, "load_tile stages BQ rows for either side's tiles");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the product operand the TPU kernel feeds its MXU
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO, laid out like q
  const float* lse;    // (B, S, H) natural-log row logsumexp
  const float* delta;  // (B, S, H) rowsum(dO * O)
  float* dq_acc;       // fused: (B, S, H, D) float32, zeroed by the caller
  void* dq;            // dq kernel: (B, S, H, D) in the input dtype
  void* dk;            // (B, S, H, D) input dtype, or (G, B, S, H, D) float32
  void* dv;
  int B, S, H, Hkv, D;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, gb, gs, gh;  // element strides
  int causal, window;
  int group_rows;      // q rows per group (blockIdx.z)
  float scale;         // D^-0.5
};

// Load rows [r0, r0 + BQ) of a (S, D) slice with row stride `rs` into a
// float tile of row stride D + 1; rows at or past `end` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs,
                                          int r0, int end, int D) {
  const int DP = D + 1;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    dst[r * DP + d] = row < end ? to_f(src[(long long)row * rs + d]) : 0.f;
  }
}

// The shared recompute chain for one (q-tile, k-tile) pair (_bwd_tile_chain):
// S = Q K^T and dP = dO V^T as 4 x 4 micro-tiles per thread, then P and dS
// (masked, rounded to T) into shared memory.  `q_end` masks the q rows past
// the live range (pass a value past S for no q mask).
template <typename T>
__device__ __forceinline__ void tile_chain(const Params& p, const float* Qs,
                                           const float* Gs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* del_s, float* Ps, float* Ds,
                                           int q0, int k0, int q_end) {
  const int D = p.D, DP = D + 1;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(tr * 4 + i) * DP + d];
      gv[i] = Gs[(tr * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tc + 16 * j) * DP + d];
      vv[j] = Vs[(tc + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
  const float scale_log2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int q = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const int kk = k0 + c;
      bool live = q < q_end && kk < p.S;
      if (p.causal) {
        live = live && kk <= q;
        if (p.window) live = live && kk > q - p.window;
      }
      // base-2 recompute against the natural-log lse, as the TPU kernel
      const float pij = live ? exp2f(s[i][j] * scale_log2 - lse_s[r]) : 0.f;
      const float dsij = pij * (dp[i][j] - del_s[r]) * p.scale;
      Ps[r * PS + c] = round_to<T>(pij);
      Ds[r * PS + c] = round_to<T>(dsij);
    }
  }
}

// Rows [q0, q0 + BQ) of lse (pre-multiplied by log2 e) and delta; rows at
// or past `end` read as 0.
__device__ __forceinline__ void load_stats(const Params& p, float* lse_s, float* del_s,
                                           int b, int h, int q0, int end) {
  if (threadIdx.x < BQ) {
    const int q = q0 + threadIdx.x;
    const long long at = ((long long)b * p.S + q) * p.H + h;
    lse_s[threadIdx.x] = q < end ? p.lse[at] * LOG2E : 0.f;
    del_s[threadIdx.x] = q < end ? p.delta[at] : 0.f;
  }
}

// Both kernels stage K, V, Q, dO (D + 1 floats a row), P, dS and the two
// row statistics: 166 KB at D=128, past the 48 KB default, so the launch
// raises the kernel's dynamic shared-memory limit first.
size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(2 * BK * dp + 2 * BQ * dp + 2 * BQ * PS + 2 * BQ);
}

// Float32 K4 / K5 (DQ) and K6a (!DQ): one block per (k-tile, batch*head,
// group).  PARTIAL writes per-group dK/dV partials (G, B, S, H, D).
template <int NJ, bool DQ, bool PARTIAL>
__global__ void __launch_bounds__(NT) flash_bwd_kv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, DP = D + 1;
  float* Ks = smem;               // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DP
  float* Qs = Vs + BK * DP;       // BQ x DP
  float* Gs = Qs + BQ * DP;       // BQ x DP (dO)
  float* Ps = Gs + BQ * DP;       // BQ x PS
  float* Ds = Ps + BQ * PS;       // BQ x PS (dS)
  float* lse_s = Ds + BQ * PS;    // BQ
  float* del_s = lse_s + BQ;      // BQ

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int grp = blockIdx.z;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + hk * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + hk * p.vh;
  const float* gg = static_cast<const float*>(p.g) + b * p.gb + h * p.gh;

  load_tile(Ks, kg, p.ks, k0, p.S, D);
  load_tile(Vs, vg, p.vs, k0, p.S, D);

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // live q rows of this k-tile inside the group: causal starts at the
  // tile's first row, a window ends at its last row's reach
  const int k_last = min(k0 + BK, p.S) - 1;
  int q_begin = grp * p.group_rows;
  int q_end = min(q_begin + p.group_rows, p.S);
  if (p.causal) {
    q_begin = max(q_begin, k0);
    if (p.window) q_end = min(q_end, k_last + p.window);
  }

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Qs, qg, p.qs, q0, q_end, D);
    load_tile(Gs, gg, p.gs, q0, q_end, D);
    load_stats(p, lse_s, del_s, b, h, q0, q_end);
    __syncthreads();
    tile_chain<float>(p, Qs, Gs, Ks, Vs, lse_s, del_s, Ps, Ds, q0, k0, q_end);
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: this thread's k rows tr*4+i, columns
    // tc + 16j of head_dim
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PS + tr * 4 + i];
        sv[i] = Ds[r * PS + tr * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 16 * j;
        const float go = d < D ? Gs[r * DP + d] : 0.f;
        const float qq = d < D ? Qs[r * DP + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], go, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qq, dk[i][j]);
        }
      }
    }

    if constexpr (DQ) {
      // this tile's share of dQ = dS K, added into the float32 buffer:
      // this thread's q rows tr*4+i, columns tc + 16j
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < BK; ++c) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ds[(tr * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tc + 16 * j;
          const float kv = d < D ? Ks[c * DP + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + tr * 4 + i;
        if (q >= q_end) continue;
        float* row = p.dq_acc + (((long long)b * p.S + q) * p.H + h) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tc + 16 * j;
          if (d < D) atomicAdd(row + d, acc[i][j]);
        }
      }
    }
  }

  // flush dK/dV; a k-tile no live q row reached writes zeros
  const long long part = PARTIAL ? (long long)grp * p.B * p.S * p.H * D : 0;
  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + tr * 4 + i;
    if (kk >= p.S) continue;
    const long long at = part + (((long long)b * p.S + kk) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d >= D) continue;
      dkg[at + d] = dk[i][j];
      dvg[at + d] = dv[i][j];
    }
  }
}

// K6b: one block per (q-tile, batch*head), dQ in registers over the live
// k-tiles; written once in the input dtype.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, DP = D + 1;
  float* Qs = smem;               // BQ x DP
  float* Gs = Qs + BQ * DP;       // BQ x DP (dO)
  float* Ks = Gs + BQ * DP;       // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DP
  float* Ps = Vs + BK * DP;       // BQ x PS (P, unused past the chain)
  float* Ds = Ps + BQ * PS;       // BQ x PS (dS)
  float* lse_s = Ds + BQ * PS;    // BQ
  float* del_s = lse_s + BQ;      // BQ

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;

  load_tile(Qs, qg, p.qs, q0, p.S, D);
  load_tile(Gs, gg, p.gs, q0, p.S, D);
  load_stats(p, lse_s, del_s, b, h, q0, p.S);

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // live k range of this q-tile, as the forward's
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int k_begin = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  // no q-side mask: rows past S compute finite values that are never written
  const int no_q_mask = q0 + BQ;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kg, p.ks, k0, p.S, D);
    load_tile(Vs, vg, p.vs, k0, p.S, D);
    __syncthreads();
    tile_chain<T>(p, Qs, Gs, Ks, Vs, lse_s, del_s, Ps, Ds, q0, k0, no_q_mask);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ds[(tr * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 16 * j;
        const float kv = d < D ? Ks[c * DP + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + tr * 4 + i;
    if (q >= p.S) continue;
    const long long at = (((long long)b * p.S + q) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d < D) dq[at + d] = from_f<T>(acc[i][j]);
    }
  }
}

template <int NJ, bool DQ, bool PARTIAL>
int launch_kv(const Params& p, int n_groups, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_kernel<NJ, DQ, PARTIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + BK - 1) / BK, p.B * p.H, n_groups);
  flash_bwd_kv_kernel<NJ, DQ, PARTIAL><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_kernel<T, NJ><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// NJ: columns of 16 over head_dim held per thread (D <= 16 * NJ).
template <bool DQ, bool PARTIAL>
int dispatch_kv(const Params& p, int n_groups, cudaStream_t s) {
  if (p.D <= 32) return launch_kv<2, DQ, PARTIAL>(p, n_groups, s);
  if (p.D <= 64) return launch_kv<4, DQ, PARTIAL>(p, n_groups, s);
  return launch_kv<8, DQ, PARTIAL>(p, n_groups, s);
}

template <typename T>
int dispatch_dq(const Params& p, cudaStream_t s) {
  if (p.D <= 32) return launch_dq<T, 2>(p, s);
  if (p.D <= 64) return launch_dq<T, 4>(p, s);
  return launch_dq<T, 8>(p, s);
}

// ------------------------------------------------------------ bf16: mma.sync

constexpr int TBQ = 64;  // q rows per step of the walk

// NW warps a block, each owning 16 k rows: a k-tile of 16 NW rows
template <int DT, int NW, bool DQ>
constexpr size_t tc_smem_bytes() {
  constexpr int TBK = 16 * NW;
  return sizeof(tc::bf16) * ((size_t)(2 * TBK + 4 * TBQ) * (DT + 8)  // K, V, 2 x (Q, dO)
                             + (DQ ? (size_t)TBK * (TBQ + 8) : 0))   // dS^T
         + sizeof(float) * 4 * TBQ;                                  // 2 x (lse, delta)
}

// Rows [q0, q0 + TBQ) of lse and delta by cp.async (4 bytes each: the rows
// are H floats apart); rows at or past `end` read as 0.
__device__ __forceinline__ void load_stats_async(const Params& p, float* lse_s,
                                                 float* del_s, int b, int h, int q0,
                                                 int end) {
  const int i = threadIdx.x % TBQ;
  const int q = q0 + i;
  const bool in = q < end;
  const long long at = in ? ((long long)b * p.S + q) * p.H + h : 0;
  if (threadIdx.x < TBQ)
    tc::cp_async4(lse_s + i, p.lse + at, in);
  else if (threadIdx.x < 2 * TBQ)
    tc::cp_async4(del_s + i, p.delta + at, in);
}

// K4 / K5 (DQ) and K6a (!DQ) on the tensor cores: one block of NW warps per
// (16 NW-row k-tile, batch*head, group); warp w owns k rows 16w .. 16w + 15
// and keeps
// their dK, dV in registers for the whole walk over the group's live q-tiles.
// Per q-tile, each warp computes S^T = K Q^T and dP^T = V dO^T (16 x TBQ),
// P^T and dS^T from them in registers, then dV += P^T dO and dK += dS^T Q
// with P^T, dS^T (rounded to bf16) as A operands straight from registers.
// With DQ, dS^T goes to shared memory as bf16 and the block adds this
// tile's dQ = dS K into the float32 buffer with float4 atomicAdd.
// At 4 warps, registers are capped so that three blocks share an SM.
template <int DT, int NW, bool DQ, bool PARTIAL>
__global__ void __launch_bounds__(32 * NW, NW == 4 ? 3 : 1) flash_bwd_kv_tc(Params p) {
  using tc::bf16;
  constexpr int TBK = 16 * NW;     // k rows a block
  constexpr int TNT = 32 * NW;     // threads a block
  constexpr int LD = DT + 8;       // padded K/V/Q/dO row, elements
  constexpr int LDS = TBQ + 8;     // padded dS^T row
  constexpr int KD = DT / 16;      // k-steps over head_dim
  constexpr int NS = TBQ / 8;      // S^T n-tiles over the q-tile
  constexpr int NO = DT / 8;       // dK/dV n-tiles over head_dim
  constexpr int MQ = TBQ / 16;     // dQ m-tiles; warps share them by columns
  constexpr int NQ = DT * MQ / (8 * NW);  // dQ n-tiles a warp
  static_assert(NW % MQ == 0 && NQ % 2 == 0 && TNT >= 2 * TBQ,
                "dQ m-tiles split evenly, n-tiles taken in pairs, a thread a statistic");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // TBK x LD
  bf16* Vs = Ks + TBK * LD;                       // TBK x LD
  bf16* Qs = Vs + TBK * LD;                       // 2 stages x TBQ x LD
  bf16* Gs = Qs + 2 * TBQ * LD;                   // 2 stages x TBQ x LD (dO)
  bf16* dSs = Gs + 2 * TBQ * LD;                  // TBK x LDS (dS^T), DQ only
  float* lse_s = reinterpret_cast<float*>(dSs + (DQ ? TBK * LDS : 0));  // 2 x TBQ
  float* del_s = lse_s + 2 * TBQ;                                        // 2 x TBQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * TBK;
  const int kw = warp * 16;  // this warp's first k row in the tile
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int grp = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.kb + hk * p.kh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vb + hk * p.vh;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.gb + h * p.gh;

  // live q rows of this k-tile inside the group, as the scalar kernel's
  const int k_last = min(k0 + TBK, p.S) - 1;
  int q_begin = grp * p.group_rows;
  int q_end = min(q_begin + p.group_rows, p.S);
  if (p.causal) {
    q_begin = max(q_begin, k0);
    if (p.window) q_end = min(q_end, k_last + p.window);
  }
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + TBQ - 1) / TBQ : 0;

  if (n_tiles > 0) {
    tc::load_rows<TBK, DT, TNT>(Ks, kg, p.ks, k0, p.S, p.D);
    tc::load_rows<TBK, DT, TNT>(Vs, vg, p.vs, k0, p.S, p.D);
    tc::load_rows<TBQ, DT, TNT>(Qs, qg, p.qs, q_begin, q_end, p.D);
    tc::load_rows<TBQ, DT, TNT>(Gs, gg, p.gs, q_begin, q_end, p.D);
    load_stats_async(p, lse_s, del_s, b, h, q_begin, q_end);
    tc::cp_async_commit();
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale_log2 = p.scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * TBQ;
    const int st = it & 1;
    // this q-tile has landed, and every warp is past the previous tile: its
    // stage (and dS^T) may be refilled
    tc::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {  // the next q-tile's copy overlaps this one
      const int nx = st ^ 1;
      tc::load_rows<TBQ, DT, TNT>(Qs + nx * TBQ * LD, qg, p.qs, q0 + TBQ, q_end, p.D);
      tc::load_rows<TBQ, DT, TNT>(Gs + nx * TBQ * LD, gg, p.gs, q0 + TBQ, q_end, p.D);
      load_stats_async(p, lse_s + nx * TBQ, del_s + nx * TBQ, b, h, q0 + TBQ, q_end);
      tc::cp_async_commit();
    }
    const bf16* Qt = Qs + st * TBQ * LD;
    const bf16* Gt = Gs + st * TBQ * LD;
    const float* lse_t = lse_s + st * TBQ;
    const float* del_t = del_s + st * TBQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k rows x TBQ q columns
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      tc::ldmatrix_x4(ka, Ks + (kw + tc::a_row(lane)) * LD + kk * 16 + tc::a_col(lane));
      tc::ldmatrix_x4(va, Vs + (kw + tc::a_row(lane)) * LD + kk * 16 + tc::a_col(lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t qb[4], gb[4];
        tc::ldmatrix_x4(qb, Qt + (np * 16 + tc::b_row(lane)) * LD + kk * 16 + tc::b_col(lane));
        tc::ldmatrix_x4(gb, Gt + (np * 16 + tc::b_row(lane)) * LD + kk * 16 + tc::b_col(lane));
        tc::mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        tc::mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma_bf16(dp[2 * np], va, gb[0], gb[1]);
        tc::mma_bf16(dp[2 * np + 1], va, gb[2], gb[3]);
      }
    }

    // P^T = exp2(s * scale log2 e - lse log2 e), masked; dS^T = P^T (dP^T -
    // delta) scale.  Masks only on a tile that crosses an edge: the group's
    // or the sequence's last q row, the sequence end, the diagonal, or the
    // window's far edge.
    const bool edge = q0 + TBQ > q_end || k0 + TBK > p.S ||
                      (p.causal && (k0 + TBK - 1 > q0 ||
                                    (p.window && k0 <= q0 + TBQ - 1 - p.window)));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = j * 8 + 2 * tig + c;  // q column in the tile
        const float lse2 = lse_t[qc] * LOG2E;
        const float dl = del_t[qc];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          bool live = true;
          if (edge) {
            const int q = q0 + qc, kk = k0 + kw + gid + 8 * r;
            live = q < q_end && kk < p.S;
            if (p.causal) {
              live = live && kk <= q;
              if (p.window) live = live && kk > q - p.window;
            }
          }
          const float pe = live ? exp2f(fmaf(s[j][e], scale_log2, -lse2)) : 0.f;
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - dl) * p.scale;
        }
      }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 in
    // registers are the A operands
#pragma unroll
    for (int kq = 0; kq < TBQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      tc::c_to_a(pa, s[2 * kq], s[2 * kq + 1]);
      tc::c_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t gb[4], qb[4];
        tc::ldmatrix_x4_t(gb, Gt + (kq * 16 + tc::a_row(lane)) * LD + np * 16 + tc::a_col(lane));
        tc::ldmatrix_x4_t(qb, Qt + (kq * 16 + tc::a_row(lane)) * LD + np * 16 + tc::a_col(lane));
        tc::mma_bf16(dv[2 * np], pa, gb[0], gb[1]);
        tc::mma_bf16(dv[2 * np + 1], pa, gb[2], gb[3]);
        tc::mma_bf16(dk[2 * np], da, qb[0], qb[1]);
        tc::mma_bf16(dk[2 * np + 1], da, qb[2], qb[3]);
      }
    }

    if constexpr (DQ) {
      // dS^T (bf16) to shared memory: row = k, column = q
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<__nv_bfloat162*>(dSs + (kw + gid + 8 * r) * LDS + j * 8 +
                                             2 * tig) =
              __floats2bfloat162_rn(dp[j][2 * r], dp[j][2 * r + 1]);
      __syncthreads();
      // this tile's dQ = dS K: warp w takes q rows 16 (w % MQ) .. + 15 and
      // NQ n-tiles of head_dim from column (w / MQ) * 8 NQ, over all TBK k
      const int mq = (warp % MQ) * 16, dc = (warp / MQ) * 8 * NQ;
      float acc[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
        uint32_t a[4];
        tc::ldmatrix_x4_t(a, dSs + (kk * 16 + tc::b_row(lane)) * LDS + mq + tc::b_col(lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t kb[4];
          tc::ldmatrix_x4_t(kb, Ks + (kk * 16 + tc::a_row(lane)) * LD + dc + np * 16 +
                                    tc::a_col(lane));
          tc::mma_bf16(acc[2 * np], a, kb[0], kb[1]);
          tc::mma_bf16(acc[2 * np + 1], a, kb[2], kb[3]);
        }
      }
      // lanes tig and tig ^ 1 trade halves: an even lane adds 4 floats of
      // row gid, an odd lane 4 floats of row gid + 8, as one float4
      const bool odd = tig & 1;
      const int q = q0 + mq + gid + (odd ? 8 : 0);
      float* row = p.dq_acc + (((long long)b * p.S + q) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][0] : acc[n][2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][1] : acc[n][3], 1);
        const float4 v = odd ? make_float4(r0, r1, acc[n][2], acc[n][3])
                             : make_float4(acc[n][0], acc[n][1], r0, r1);
        const int d = dc + n * 8 + 2 * (tig & 2);
        if (q < q_end && d < p.D) atomicAdd(reinterpret_cast<float4*>(row + d), v);
      }
    }
  }

  // flush dK/dV: rows k0 + kw + gid (+ 8); a k-tile no live q row reached
  // writes zeros
  const long long part = PARTIAL ? (long long)grp * p.B * p.S * p.H * p.D : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = k0 + kw + gid + 8 * r;
    if (kk >= p.S) continue;
    const long long at = part + (((long long)b * p.S + kk) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d >= p.D) continue;
      if constexpr (PARTIAL) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.dk) + at + d) =
            make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(p.dv) + at + d) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dk) + at + d) =
            __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dv) + at + d) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int DT, int NW, bool DQ, bool PARTIAL>
int launch_kv_tc(const Params& p, int n_groups, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DT, NW, DQ>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_tc<DT, NW, DQ, PARTIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + 16 * NW - 1) / (16 * NW), p.B * p.H, n_groups);
  flash_bwd_kv_tc<DT, NW, DQ, PARTIAL><<<grid, 32 * NW, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// DT: the instance's head-dim width; D is zero-padded up to it.  NW: warps
// a block.  At D <= 64, 4 warps (64-row k-tiles), registers capped at 168
// a thread: three blocks share an SM, so one block's barriers and dQ
// atomics overlap the others' products (on an H100, K4 at (8, 8192, 8,
// 64) runs faster this way than with 8 warps or with two blocks an SM).
// At D = 128, 8 warps (128-row k-tiles): the 128 dK/dV accumulators a
// thread fill the registers, and 128-row tiles halve the dQ atomics.
template <bool DQ, bool PARTIAL>
int dispatch_kv_tc(const Params& p, int n_groups, cudaStream_t s) {
  if (p.D <= 32) return launch_kv_tc<32, 4, DQ, PARTIAL>(p, n_groups, s);
  if (p.D <= 64) return launch_kv_tc<64, 4, DQ, PARTIAL>(p, n_groups, s);
  return launch_kv_tc<128, 8, DQ, PARTIAL>(p, n_groups, s);
}

bool bad_shape(int B, int S, int H, int Hkv, int D) {
  return D < 8 || D > 128 || D % 8 || Hkv < 1 || H % Hkv || S < 1 || B < 1;
}

Params make_params(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, int B, int S, int H, int Hkv,
                   int D, const long long* st, int causal, int window, float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B; p.S = S; p.H = H; p.Hkv = Hkv; p.D = D;
  p.qb = st[0]; p.qs = st[1]; p.qh = st[2];
  p.kb = st[3]; p.ks = st[4]; p.kh = st[5];
  p.vb = st[6]; p.vs = st[7]; p.vh = st[8];
  p.gb = st[9]; p.gs = st[10]; p.gh = st[11];
  p.causal = causal; p.window = window;
  p.group_rows = S;
  p.scale = scale;
  return p;
}

}  // namespace

// Every entry returns a cudaError_t value: 0 when the launch was accepted.
// `strides` holds the 12 element strides (batch, seq, head) of q, k, v and
// dO.  The Python wrapper validates shapes, dtypes and strides first.

// K4 (n_groups == 1: dk/dv in the input dtype) and K5 (n_groups > 1:
// dk/dv float32 partials (n_groups, B, S, H, D)).  dq_acc is a zeroed
// float32 (B, S, H, D) buffer.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, void* dq_acc,
                               void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                               const long long* strides, int causal, int window,
                               int group_rows, int n_groups, float scale, int is_bf16,
                               void* stream) {
  if (bad_shape(B, S, H, Hkv, D) || n_groups < 1 || group_rows < 1 ||
      (long long)group_rows * n_groups < S)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, g, lse, delta, B, S, H, Hkv, D, strides, causal,
                         window, scale);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk = dk;
  p.dv = dv;
  p.group_rows = group_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_groups > 1)
    return is_bf16 ? dispatch_kv_tc<true, true>(p, n_groups, s)
                   : dispatch_kv<true, true>(p, n_groups, s);
  return is_bf16 ? dispatch_kv_tc<true, false>(p, 1, s)
                 : dispatch_kv<true, false>(p, 1, s);
}

// K6a: dk/dv (B, S, H, D) in the input dtype.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int B, int S, int H, int Hkv, int D, const long long* strides,
                             int causal, int window, float scale, int is_bf16,
                             void* stream) {
  if (bad_shape(B, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, g, lse, delta, B, S, H, Hkv, D, strides, causal,
                         window, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_kv_tc<false, false>(p, 1, s)
                 : dispatch_kv<false, false>(p, 1, s);
}

// K6b: dq (B, S, H, D) in the input dtype.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, void* dq, int B, int S,
                            int H, int Hkv, int D, const long long* strides, int causal,
                            int window, float scale, int is_bf16, void* stream) {
  if (bad_shape(B, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, g, lse, delta, B, S, H, Hkv, D, strides, causal,
                         window, scale);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dq<__nv_bfloat16>(p, s) : dispatch_dq<float>(p, s);
}
