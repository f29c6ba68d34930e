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
// Design.  One thread block of 256 threads owns one (batch*head, 64-row
// q-tile).  The TPU's sequential k grid axis becomes a loop inside the block
// over 64-row k/v tiles staged in shared memory; the running max m, sum l
// and the (64 x D) accumulator stay on chip (m, l in shared memory, the
// accumulator in registers, 4 rows x ceil(D/16) columns per thread) for
// the whole walk, so the (S x S) score matrix never reaches device memory.
// The loop bounds come from `causal` and `window` (k <= q and k > q -
// window), so a dead tile is never loaded: the CUDA form of the Pallas
// kernel's clamp/liveness pair.  Products run as scalar FMAs in float32 on
// values read in the input dtype (a bf16 x bf16 product is exact in f32,
// so this is the input-dtype matmul with f32 accumulation); P is rounded
// to the input dtype before the PV product, as the TPU kernel does.
//
// What bounds it at the serving slice's prefill shapes (B=1, S <= 512,
// H=8, D=64, bf16, causal): on the roofline, the bytes.  S=512 needs
// 0.27 GFLOP against 2.1 MB of q/k/v/o/lse, ~127 FLOP per byte, below the
// H100's bf16 ridge (~295), so the least time is ~0.6 us.  This first
// kernel computes on the CUDA cores, so in practice it is bound by FMA
// issue and shared-memory reads, and by latency: at S=512 its grid is
// only 64 blocks for 132 SMs, and each block loads a tile, then computes,
// with no overlap.  The register micro-tile (4 x 4 scores, 4 x ceil(D/16)
// outputs per thread) reuses each shared-memory read 4 times and the odd
// row stride keeps the reads free of bank conflicts.  Tensor-core
// products, more blocks per sequence and overlapped loads are the next
// steps; right and simple comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // k rows per tile
constexpr int NT = 256;           // threads per block
constexpr int PS = BK + 1;        // padded row stride of the P tile
constexpr float NEG = -1e30f;     // masked score (the TPU kernel's _NEG)
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// NJ: columns of 16 over head_dim held per thread (D <= 16 * NJ).
template <typename T, int NJ>
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
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int q = q0 + r;
    Qs[r * DP + d] = q < p.S ? to_f(qg[(long long)q * p.qs + d]) : 0.f;
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
      Ks[r * DP + d] = in ? to_f(kg[(long long)kk * p.ks + d]) : 0.f;
      Vs[r * DP + d] = in ? to_f(vg[(long long)kk * p.vs + d]) : 0.f;
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
        // P enters the PV product in the input dtype; l sums the f32 p
        Ps[r * PS + lane] = to_f(from_f<T>(pa));
        Ps[r * PS + lane + 32] = to_f(from_f<T>(pc));
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

  // finalize: out = acc / l in the input dtype, lse = m ln2 + ln l
  T* og = static_cast<T*>(p.o);
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
      if (d < D) og[row * D + d] = from_f<T>(acc[i][j] / l);
    }
    if (tc == 0) p.lse[row] = m_s[r] * LN2 + logf(l);
  }
}

template <typename T, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, NJ><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 2>(p, stream);
  if (p.D <= 64) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
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
  return is_bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}
