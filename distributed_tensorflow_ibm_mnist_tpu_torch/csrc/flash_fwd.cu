// Flash-attention forward for Hopper (sm_90a), bound to Python by ctypes.
//
// Replaces ops/flash_attention.py:_fwd_kernel of the JAX package (the Pallas
// TPU kernel K3): the online-softmax attention forward in base 2, with
// causal, sliding-window and sequence-end masks, dead tiles skipped, GQA by
// head index, output in the input dtype and the natural-log row logsumexp.
//
// Layout: q (B, S, H, D), k/v (B, S, H_kv, D), read through their element
// strides (only the last dim must be contiguous), so no transposed or
// head-repeated copy is ever made.  out is (B, S, H, D) contiguous in the
// input dtype; lse is (B, S, H) contiguous float32 (the flash_block_fwd
// contract).
//
// Two designs, chosen by the dtype flag (is_bf16), not as a fallback:
//
// * bf16: flash_fwd_tc, on the tensor cores.  A block of 4 warps owns one
//   (batch*head, 64-row q-tile); each warp owns 16 q rows, whose Q stays in
//   registers as mma.sync A fragments for the whole walk.  The TPU's
//   sequential k grid axis is a loop over 64-row K/V tiles, held in shared
//   memory as bf16 (rows padded by 16 bytes: ldmatrix without bank
//   conflicts) and loaded by cp.async into a two-stage ring, so the next
//   tile's copy overlaps this tile's products.  S = Q K^T and O += P V run
//   as mma.sync m16n8k16 (bf16 in, float32 accumulators); the running max
//   and sum stay in registers (quad shuffles); P is rounded to bf16 in
//   registers and is the PV product's A operand as it stands (the TPU
//   kernel's MXU-operand cast), with no trip through shared memory.  Head
//   dims below the instance's width (32, 64 or 128) are zero-padded in
//   shared memory.  The loop bounds come from `causal` and `window`
//   (k <= q and k > q - window), so a dead tile is never loaded, and only
//   tiles that cross a mask edge build the mask.
// * float32: flash_fwd_kernel, scalar float32 FMAs on the CUDA cores (the
//   tensor cores have no float32 product that keeps the float32 checks);
//   no path the port trains or serves runs attention in float32.
//
// What bounds it.  At the LM training shape (B=8, S=8192, H=8, D=64, bf16,
// causal) the work is 0.55 TFLOP of products against 0.27 GB of inputs and
// outputs: operations, 0.56 ms at the bf16 tensor-core peak.  mma.sync
// reaches a fraction of that peak (wgmma alone reaches all of it), and
// each warp reads the whole K/V tile from shared memory for its 16 rows,
// so ldmatrix traffic is the next limit.  At the serving prefill shapes
// (B=1, S <= 512) the bytes bound it (~0.6 us at S=512) and the grid is
// small (64 blocks at S=512 for 132 SMs), so launch latency and the one
// wave's tail decide.  Next: wgmma with TMA-fed K/V tiles and a producer
// warp, and more blocks per sequence at small S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // k rows per tile
constexpr int NT = 256;           // threads per block
constexpr int PS = BK + 1;        // padded row stride of the P tile
constexpr float NEG = -1e30f;     // masked score (the TPU kernel's _NEG)
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, S, H, Hkv, D;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // element strides
  int causal, window;
  float scale_log2;  // D^-0.5 * log2(e): the base-2 softmax's score scale
};

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(BQ * dp + 2 * BK * dp + BQ * PS + 3 * BQ);
}

// ------------------------------------------------------- float32: scalar

// NJ: columns of 16 over head_dim held per thread (D <= 16 * NJ).
template <int NJ>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;  // odd row stride: column reads hit distinct banks
  float* Qs = smem;              // BQ x DP
  float* Ks = Qs + BQ * DP;      // BK x DP
  float* Vs = Ks + BK * DP;      // BK x DP
  float* Ps = Vs + BK * DP;      // BQ x PS: scores, then probabilities
  float* m_s = Ps + BQ * PS;     // running max (base-2 units)
  float* l_s = m_s + BQ;         // running sum
  float* c_s = l_s + BQ;         // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);  // GQA: q head h reads kv head h / group
  const int q0 = blockIdx.x * BQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + hk * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + hk * p.vh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int q = q0 + r;
    Qs[r * DP + d] = q < p.S ? qg[(long long)q * p.qs + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  // micro-tile of this thread: rows tr*4 .. tr*4+3, columns tc + 16*j
  const int tr = tid / 16, tc = tid % 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // live k range of this q-tile: causal stops at its last row's diagonal,
  // a window starts at its first row's reach; tiles outside are skipped
  const int q_hi = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? q_hi + 1 : p.S;
  int k_begin = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      const int kk = k0 + r;
      const bool in = kk < p.S;
      Ks[r * DP + d] = in ? kg[(long long)kk * p.ks + d] : 0.f;
      Vs[r * DP + d] = in ? vg[(long long)kk * p.vs + d] : 0.f;
    }
    __syncthreads();

    // scores = q k^T, scaled into base 2, masked
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int q = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const int kk = k0 + c;
        bool live = kk < p.S;
        if (p.causal) {
          live = live && kk <= q;
          if (p.window) live = live && kk > q - p.window;
        }
        Ps[r * PS + c] = live ? s[i][j] * p.scale_log2 : NEG;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two columns
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int rr = 0; rr < 8; ++rr) {
        const int r = warp * 8 + rr;
        const float a = Ps[r * PS + lane];
        const float c = Ps[r * PS + lane + 32];
        float mx = fmaxf(a, c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float pa = a == NEG ? 0.f : exp2f(a - m_new);
        const float pc = c == NEG ? 0.f : exp2f(c - m_new);
        float sum = pa + pc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        Ps[r * PS + lane] = pa;
        Ps[r * PS + lane + 32] = pc;
        __syncwarp();
        if (lane == 0) {
          const float corr = exp2f(m_prev - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + sum;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 16 * j;
        const float vv = d < D ? Vs[kk * DP + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  // finalize: out = acc / l, lse = m ln2 + ln l
  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int q = q0 + r;
    if (q >= p.S) continue;
    float l = l_s[r];
    l = l == 0.f ? 1.f : l;  // a fully-masked row
    const long long row = ((long long)b * p.S + q) * p.H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d < D) og[row * D + d] = acc[i][j] / l;
    }
    if (tc == 0) p.lse[row] = m_s[r] * LN2 + logf(l);
  }
}

template <int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<NJ><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<2>(p, stream);
  if (p.D <= 64) return launch<4>(p, stream);
  return launch<8>(p, stream);
}

// ------------------------------------------------------------ bf16: mma.sync

constexpr int TBQ = 64;   // q rows per block: 4 warps x 16
constexpr int TBK = 64;   // k rows per K/V tile
constexpr int TNT = 128;  // threads per block

template <int DT>
constexpr size_t tc_smem_bytes() {
  return sizeof(tc::bf16) * (size_t)(TBQ + 4 * TBK) * (DT + 8);  // Q, 2 x (K, V)
}

// DT: the instance's head-dim width (a multiple of 16, D <= DT).
template <int DT>
__global__ void __launch_bounds__(TNT) flash_fwd_tc(Params p) {
  using tc::bf16;
  constexpr int LD = DT + 8;     // padded shared row, elements
  constexpr int KD = DT / 16;    // k-steps over head_dim
  constexpr int NS = TBK / 8;    // score n-tiles over a K tile
  constexpr int NO = DT / 8;     // output n-tiles over head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // TBQ x LD
  bf16* Ks = Qs + TBQ * LD;                       // 2 stages x TBK x LD
  bf16* Vs = Ks + 2 * TBK * LD;                   // 2 stages x TBK x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * TBQ;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.kb + hk * p.kh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vb + hk * p.vh;

  // live k range, as the scalar kernel's
  const int q_hi = min(q0 + TBQ, p.S) - 1;
  const int k_end = p.causal ? q_hi + 1 : p.S;
  int k_begin = (p.causal && p.window) ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / TBK) * TBK;
  const int n_tiles = (k_end - k_begin + TBK - 1) / TBK;

  tc::load_rows<TBQ, DT, TNT>(Qs, qg, p.qs, q0, p.S, p.D);
  tc::load_rows<TBK, DT, TNT>(Ks, kg, p.ks, k_begin, p.S, p.D);
  tc::load_rows<TBK, DT, TNT>(Vs, vg, p.vs, k_begin, p.S, p.D);
  tc::cp_async_commit();

  uint32_t qf[KD][4];  // this warp's 16 q rows, A fragments
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows gid and gid + 8 of this warp: running max (base-2 units) and this
  // thread's share of the running sum (summed over the quad at the end)
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + gid;  // this thread's first q row

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * TBK;
    const int st = it & 1;
    // this tile has landed, and every warp is past the previous tile: its
    // stage may be refilled
    tc::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      tc::load_rows<TBK, DT, TNT>(Ks + (st ^ 1) * TBK * LD, kg, p.ks, k0 + TBK, p.S, p.D);
      tc::load_rows<TBK, DT, TNT>(Vs + (st ^ 1) * TBK * LD, vg, p.vs, k0 + TBK, p.S, p.D);
      tc::cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], Qs + (warp * 16 + tc::a_row(lane)) * LD + kk * 16 +
                                    tc::a_col(lane));
    }
    const bf16* Kt = Ks + st * TBK * LD;
    const bf16* Vt = Vs + st * TBK * LD;

    // S = Q K^T, 16 x TBK per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, Kt + (np * 16 + tc::b_row(lane)) * LD + kk * 16 + tc::b_col(lane));
        tc::mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // masks, only on a tile that crosses an edge: the sequence end, the
    // diagonal or the window's far edge
    const bool edge = k0 + TBK > p.S ||
                      (p.causal && (k0 + TBK - 1 > q0 ||
                                    (p.window && k0 <= q0 + TBQ - 1 - p.window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = row0 + (e >> 1) * 8;
          const int kk = k0 + j * 8 + 2 * tig + (e & 1);
          bool live = kk < p.S;
          if (p.causal) {
            live = live && kk <= q;
            if (p.window) live = live && kk > q - p.window;
          }
          if (!live) s[j][e] = tc::neg_inf();
        }
    }

    // online softmax in base 2, rows gid (r = 0) and gid + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = tc::neg_inf();
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx * p.scale_log2);
      const float corr = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = exp2f(fmaf(s[j][e], p.scale_log2, -m_new));  // masked: 0
          s[j][e] = pe;
          sum += pe;
        }
      l_r[r] = l_r[r] * corr + sum;  // l sums the float32 p
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        tc::ldmatrix_x4_t(vb, Vt + (kk * 16 + tc::a_row(lane)) * LD + np * 16 + tc::a_col(lane));
        tc::mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        tc::mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // finalize: out = acc / l in bf16, lse = m ln2 + ln l
  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l == 0.f ? 1.f : l;  // a fully-masked row
    const int q = row0 + r * 8;
    if (q >= p.S) continue;
    const long long row = ((long long)b * p.S + q) * p.H + h;
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.D + d) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (tig == 0) p.lse[row] = m_r[r] * LN2 + logf(l);
  }
}

template <int DT>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + TBQ - 1) / TBQ, p.B * p.H);
  flash_fwd_tc<DT><<<grid, TNT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_tc(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_tc<32>(p, stream);
  if (p.D <= 64) return launch_tc<64>(p, stream);
  return launch_tc<128>(p, stream);
}

}  // namespace

// Returns a cudaError_t value: 0 when the launch was accepted.  The Python
// wrapper validates shapes, dtypes and strides before calling.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int H, int Hkv, int D,
                         long long qb, long long qs, long long qh,
                         long long kb, long long ks, long long kh,
                         long long vb, long long vs, long long vh,
                         int causal, int window, float scale_log2, int is_bf16,
                         void* stream) {
  if (D < 8 || D > 128 || D % 8 || Hkv < 1 || H % Hkv || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), B, S, H, Hkv, D,
           qb, qs, qh, kb, ks, kh, vb, vs, vh, causal, window, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_tc(p, s) : dispatch(p, s);
}
