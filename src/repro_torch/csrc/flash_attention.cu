// Blocked GQA attention forward with an online softmax (flash attention),
// for Hopper (sm_90a): the float32 route.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:39
// _flash_kernel, reached by flash_attention_pallas (pl.pallas_call at
// repro/kernels/flash_attention.py:135), for float32 operands; bfloat16
// operands go to the tensor-core kernel in flash_attention_sm90.cu. On
// the tensor cores float32 operands would mean TF32, which the float32
// tolerances do not allow, so this route stays on scalar float32 FMAs.
// The plain torch version beside it is
// repro_torch/kernels/ref.py:flash_attention_ref.
//
// What it computes. q (B, Hq, S, hd), k and v (B, Hkv, S, hd), all
// contiguous float32; query head h reads kv head
// h / (Hq / Hkv). Key j is visible from query i where j <= i (causal),
// j > i - window (window > 0) and j < kv_len. For every query row:
//   out = sum_j softmax_j(scale * q.k_j) v_j   over the visible j,
// with the running max and denominator in float32. A row that sees no key comes out 0: its max is clamped at
// -1e30 / 2 before the exponent and its denominator at 1e-30, as the TPU
// kernel guards it (repro/kernels/flash_attention.py:86-89).
//
// Bound. 4 * hd flops per visible (query head, key) pair: 2 * hd for
// q.k and 2 * hd for p.v; recurrentgemma-2b's serving shapes (B = 4,
// Hq = 10, Hkv = 1, hd = 256) at S = 4096 with window 2048 do 2.6e11
// flops against 0.19 GB of operands, so the tensor cores' rate (989
// TFLOP/s bf16) bounds it, not device memory.
//
// Design (scalar float32 FMAs, no tensor cores).
// One block of 8 warps per (q tile of 64 rows, query head, batch row);
// the TPU grid's sequential kv axis becomes a loop inside the block over
// the 32-key tiles this q tile can see: tiles right of the diagonal
// (causal) and left of the window of the tile's first row are never
// visited, and keys past kv_len or S are masked. The q tile, one K tile
// and one V tile sit in dynamic shared memory as float32 (131.6 KB at
// hd = 256: above the 48 KB a block gets by default, so the launch raises
// the limit with cudaFuncSetAttribute). Each warp owns 8 query rows, and
// for a K tile each lane owns one key: a lane forms its key's 8 scores
// from broadcast float4 reads of q and its own float4 reads of k (the K
// rows are padded to hd + 4 floats, so a quarter-warp's 16-byte reads
// fall in distinct banks), the warp reduces the row max and sum with
// shuffles, and the probabilities move to the p.v product by shuffle,
// never through shared memory. The p.v accumulator, 8 rows x hd columns
// per warp, lives in registers: lane c holds columns c, c + 32, ...
// Products use explicit fused multiply-adds (__fmaf_rn), which the
// library-wide -fmad=false leaves alone.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 32;                    // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;        // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  int S, Hq, Hkv;
  int causal;    // 0 or 1
  int window;    // 0: no window
  int kv_len;    // keys at and past kv_len are masked (S when none)
  float scale;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * HD + kBK * (HD + 4) + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  constexpr int NJ = HD / 32;              // output columns per lane
  constexpr int KS = HD + 4;               // K row stride in shared memory
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBQ x HD
  float* sK = sQ + kBQ * HD;                     // kBK x KS
  float* sV = sK + kBK * KS;                     // kBK x HD

  const int S = p.S;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long long q_off = (static_cast<long long>(b) * p.Hq + h) * S * HD;
  const long long kv_off = (static_cast<long long>(b) * p.Hkv + hk) * S * HD;
  const T* qg = q + q_off;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;
  T* og = o + q_off;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;       // this warp's first row

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int qi = q0 + e / HD;
    sQ[e] = qi < S ? to_f32(qg[static_cast<long long>(qi) * HD + e % HD])
                   : 0.0f;
  }

  // the keys this tile of queries can see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = min(S, p.kv_len);
  if (p.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the last tile is consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const int kj = k0 + r;
      const long long g = static_cast<long long>(kj) * HD + c;
      sK[r * KS + c] = kj < S ? to_f32(kg[g]) : 0.0f;
      sV[e] = kj < S ? to_f32(vg[g]) : 0.0f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.0f;
    const float* krow = sK + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + i) * HD + d);
        s[i] = __fmaf_rn(qv.x, kv.x, s[i]);
        s[i] = __fmaf_rn(qv.y, kv.y, s[i]);
        s[i] = __fmaf_rn(qv.z, kv.z, s[i]);
        s[i] = __fmaf_rn(qv.w, kv.w, s[i]);
      }
    }

    // online softmax over the tile, one row at a time across the warp
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      bool vis = kj < S && kj < p.kv_len;
      if (p.causal) vis = vis && kj <= qi;
      if (p.window > 0) vis = vis && kj > qi - p.window;
      const float sc = vis ? s[i] * p.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      const float pe = vis ? expf(sc - m_safe) : 0.0f;
      const float alpha = expf(m[i] - m_safe);
      l[i] = l[i] * alpha + warp_sum(pe);
      m[i] = m_new;
      s[i] = pe;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    // acc += p v: key c's probability comes from lane c by shuffle
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * HD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pc = __shfl_sync(0xffffffffu, s[i], c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = __fmaf_rn(pc, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * p.Hq + h) * S + qi] =
          fmaxf(m[i], kNegInf / 2) + logf(denom);
    T* orow = og + static_cast<long long>(qi) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&orow[lane + 32 * j], acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, p);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

extern "C" {

// Launches the float32 forward on `stream` (q, k, v and o float32); hd
// must be 64, 128 or 256; window <= 0 means none.
// lse, when not null, receives each row's float32 log-sum-exp (B, Hq, S)
// for the backward; serving passes null. Returns the CUDA error code of
// the launch (0 when it was accepted). B = 0 or S = 0 launches nothing.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Hq, int Hkv,
                           int S, int hd,
                           int causal, int window, int kv_len, float scale,
                           void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{S, Hq, Hkv, causal != 0, window > 0 ? window : 0,
                 kv_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<float, 64>(q, k, v, o, lse, B, p, s);
    case 128: return launch<float, 128>(q, k, v, o, lse, B, p, s);
    case 256: return launch<float, 256>(q, k, v, o, lse, B, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
