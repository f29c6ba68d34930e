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
// axis becomes a loop inside one block:
//   * fused / dkv: a block of 256 threads owns one (batch*head, 64-row
//     k-tile, q-row group).  K and V of the tile sit in shared memory and dK,
//     dV in registers (a 4 x ceil(D/16) micro-tile per thread) for the whole
//     walk over the group's live 64-row q-tiles.  The walk's bounds come from
//     `causal` and `window` (q >= k, q < k + window), so a dead tile is never
//     loaded.  For each tile pair the chain runs ONCE: S and dP in one pass
//     over D, P and dS into shared memory, then dV, dK and (fused) dQ.  dQ
//     has no row buffer on Hopper: each tile pair adds dS K into a float32
//     (B, S, H, D) buffer that the wrapper zeroed, with atomicAdd.  The order
//     of those adds changes from run to run, so K4/K5's dQ is not bitwise
//     reproducible (float32 rounding of the sum only).  With one group dK/dV
//     are written in the input dtype (K4); with G groups (K5) each group
//     writes float32 partials (G, B, S, H, D) that the wrapper sums and
//     rounds once.  flash_bwd_dkv is the same walk without dQ: deterministic.
//   * dq: a block owns one (batch*head, 64-row q-tile), keeps Q and dO in
//     shared memory and dQ in registers, and loops over the live k-tiles
//     (k <= q, k > q - window) as the forward does; deterministic.
//
// What bounds it at the training path's shapes (B=8, S=8192, H=8, D=64,
// bf16, causal): on the roofline, operations.  Five products of 2*D FLOPs
// per live (q, k) pair, 2.15e9 pairs: 1.37 TFLOP against 0.47 GB of inputs
// and outputs (0.14 ms at 3.35 TB/s), ~1.4 ms at the bf16 tensor-core peak.  This first kernel
// runs every product as scalar float32 FMAs on the CUDA cores, whose peak
// (67 TFLOP/s) alone sits ~15x above that bound, and it is held further by
// FMA issue and shared-memory reads.  The register micro-tiles reuse each
// shared-memory read 4 times, the odd row stride (D + 1) keeps column reads
// free of bank conflicts, and skipping dead tiles halves the causal work.
// Tensor-core products (mma.sync, then wgmma with TMA-fed tiles) and
// overlapped loads are the next steps; right and simple comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// K4 / K5 (DQ) and K6a (!DQ): one block per (k-tile, batch*head, group).
// PARTIAL writes float32 per-group dK/dV partials; else the input dtype.
template <typename T, int NJ, bool DQ, bool PARTIAL>
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
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;

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
    tile_chain<T>(p, Qs, Gs, Ks, Vs, lse_s, del_s, Ps, Ds, q0, k0, q_end);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + tr * 4 + i;
    if (kk >= p.S) continue;
    const long long at = part + (((long long)b * p.S + kk) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d >= D) continue;
      if constexpr (PARTIAL) {
        static_cast<float*>(p.dk)[at + d] = dk[i][j];
        static_cast<float*>(p.dv)[at + d] = dv[i][j];
      } else {
        static_cast<T*>(p.dk)[at + d] = from_f<T>(dk[i][j]);
        static_cast<T*>(p.dv)[at + d] = from_f<T>(dv[i][j]);
      }
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

template <typename T, int NJ, bool DQ, bool PARTIAL>
int launch_kv(const Params& p, int n_groups, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_kernel<T, NJ, DQ, PARTIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + BK - 1) / BK, p.B * p.H, n_groups);
  flash_bwd_kv_kernel<T, NJ, DQ, PARTIAL><<<grid, NT, smem, stream>>>(p);
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
template <typename T, bool DQ, bool PARTIAL>
int dispatch_kv(const Params& p, int n_groups, cudaStream_t s) {
  if (p.D <= 32) return launch_kv<T, 2, DQ, PARTIAL>(p, n_groups, s);
  if (p.D <= 64) return launch_kv<T, 4, DQ, PARTIAL>(p, n_groups, s);
  return launch_kv<T, 8, DQ, PARTIAL>(p, n_groups, s);
}

template <typename T>
int dispatch_dq(const Params& p, cudaStream_t s) {
  if (p.D <= 32) return launch_dq<T, 2>(p, s);
  if (p.D <= 64) return launch_dq<T, 4>(p, s);
  return launch_dq<T, 8>(p, s);
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
    return is_bf16 ? dispatch_kv<__nv_bfloat16, true, true>(p, n_groups, s)
                   : dispatch_kv<float, true, true>(p, n_groups, s);
  return is_bf16 ? dispatch_kv<__nv_bfloat16, true, false>(p, 1, s)
                 : dispatch_kv<float, true, false>(p, 1, s);
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
  return is_bf16 ? dispatch_kv<__nv_bfloat16, false, false>(p, 1, s)
                 : dispatch_kv<float, false, false>(p, 1, s);
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
