// Backward of the blocked GQA attention in flash_attention.cu, for Hopper
// (sm_90a): the float32 route. bfloat16 operands go to the tensor-core
// backward in flash_attention_bwd_sm90.cu; float32 ones stay on scalar
// float32 FMAs (on the tensor cores they would mean TF32).
//
// No TPU counterpart: the reference differentiates plain jnp and has no
// backward kernel. It is the gradient of the port of
// repro/kernels/flash_attention.py:39 _flash_kernel; the plain torch
// version beside it is repro_torch/kernels/ref.py:flash_attention_bwd_ref.
//
// What it computes. The forward's operands q (B, Hq, S, hd), k and v
// (B, Hkv, S, hd), its output o and float32 log-sum-exp lse (B, Hq, S),
// and the output's gradient do (like q) give dq (like q) and dk, dv
// (like k), under the forward's causal, window and kv_len masks. For a
// visible pair (query row i of head h, key j of kv head h / (Hq / Hkv)):
//   P_ij = exp(scale q_i.k_j - lse_i),  D_i = sum_c do_ic o_ic,
//   dS_ij = P_ij (do_i.v_j - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_(h, i) dS_ij q_i,
//   dv_j = sum_(h, i) P_ij do_i,
// where dk_j and dv_j sum over every query head of the kv head's group.
// float32 operands, math and accumulation.
//
// Bound. 10 * hd flops per visible (query head, key) pair: the scores
// q.k are recomputed in both passes (2 * 2 hd), do.v likewise (2 * 2 hd),
// and dq, dk, dv take 2 hd each, so 14 hd are done for the 10 hd that a
// single pass would need at the least (a pass that kept P would skip
// one q.k and one do.v). recurrentgemma-2b's training shape (B 1, Hq 10,
// Hkv 1, hd 256, S 2048 causal) needs 5.4e10 flops against 55 MB of
// operands: the tensor cores' rate bounds it (54 us), not device memory.
//
// Design (simple first: scalar float32 FMAs, no tensor cores). Two
// deterministic passes, each output element written by one thread and
// summed in a fixed order; no float atomics, so a run repeats bit for
// bit.
//  1. dq pass: one block of 8 warps per (64 query rows, query head, batch
//     row), as the forward. It first forms D_i for its rows and writes
//     it out for pass 2. The q and do tiles (64 x hd) and one K and one
//     V tile (32 keys) sit in shared memory as float32; for each K tile
//     a lane owns one key and forms its 8 rows' q.k and do.v, recomputes
//     P from lse, and dS moves by shuffle into the dq product, where lane
//     c holds columns c, c + 32, ... of its warp's 8 rows in registers.
//  2. dk/dv pass: one block of 8 warps per (16 keys, kv head, batch row);
//     a warp owns 2 keys, whose dk and dv rows live in registers (lane c:
//     columns c, c + 32, ...). The block loops over the group's query
//     heads (all 10 for recurrentgemma's single kv head) and, for each,
//     over the 32-row query tiles that can see its keys (rows before the
//     keys are skipped under the causal mask, rows past the window's end
//     under the window). For each tile a lane owns one query row, forms
//     its q.k and do.v against the warp's 2 keys (rows padded to hd + 4
//     floats so a quarter-warp's 16-byte reads fall in distinct banks),
//     and P and dS reach the dk and dv products by shuffle.
// Shared memory at hd = 256: pass 1 holds q and do (2 x 64 x 256) and K
// and V (2 x 32 x 260) floats, 197,632 bytes; pass 2 holds K and V (2 x
// 16 x 256) and q and do (2 x 32 x 260) floats plus 64 row scalars,
// 99,584 bytes. Both stay under the 227 KB a block may have; the launch
// raises the 48 KB default with cudaFuncSetAttribute.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// pass 1 (dq)
constexpr int kBQ = 64;                    // query rows per block
constexpr int kRows = kBQ / kWarps;        // query rows per warp
constexpr int kBK = 32;                    // keys per tile: one per lane
// pass 2 (dk, dv)
constexpr int kKeysPerWarp = 2;
constexpr int kBKV = kWarps * kKeysPerWarp;  // keys per block
constexpr int kBQ2 = 32;                   // query rows per tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool vis = qi < p.S && kj < p.S && kj < p.kv_len;
  if (p.causal) vis = vis && kj <= qi;
  if (p.window > 0) vis = vis && kj > qi - p.window;
  return vis;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kBQ * HD + 2 * kBK * (HD + 4));
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * kBKV * HD + 2 * kBQ2 * (HD + 4) + 2 * kBQ2);
}

// ---- pass 1: D and dq ----------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    T* __restrict__ dq, Params p) {
  constexpr int NJ = HD / 32;
  constexpr int KS = HD + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBQ x HD
  float* sO = sQ + kBQ * HD;                     // kBQ x HD: do
  float* sK = sO + kBQ * HD;                     // kBK x KS
  float* sV = sK + kBK * KS;                     // kBK x KS

  const int S = p.S;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long long row0 = (static_cast<long long>(b) * p.Hq + h) * S;
  const long long q_off = row0 * HD;
  const long long kv_off = (static_cast<long long>(b) * p.Hkv + hk) * S * HD;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int qi = q0 + e / HD;
    const long long g = q_off + static_cast<long long>(qi) * HD + e % HD;
    sQ[e] = qi < S ? to_f32(q[g]) : 0.0f;
    sO[e] = qi < S ? to_f32(dout[g]) : 0.0f;
  }
  __syncthreads();

  // D_i = sum_c do_ic o_ic and lse_i for the warp's rows
  float dl[kRows], ls[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    float part = 0.0f;
    if (qi < S) {
      const T* orow = o + q_off + static_cast<long long>(qi) * HD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        part = __fmaf_rn(sO[(r0 + i) * HD + c], to_f32(orow[c]), part);
      }
    }
    dl[i] = warp_sum(part);
    ls[i] = qi < S ? lse[row0 + qi] : 0.0f;
    if (qi < S && lane == 0) dsum[row0 + qi] = dl[i];
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = min(S, p.kv_len);
  if (p.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the last tile is consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const int kj = k0 + r;
      const long long g = static_cast<long long>(kj) * HD + c;
      sK[r * KS + c] = kj < S ? to_f32(kg[g]) : 0.0f;
      sV[r * KS + c] = kj < S ? to_f32(vg[g]) : 0.0f;
    }
    __syncthreads();

    // this lane's key against the warp's rows: q.k and do.v
    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.0f;
    const float* krow = sK + lane * KS;
    const float* vrow = sV + lane * KS;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + i) * HD + d);
        const float4 ov = *reinterpret_cast<const float4*>(sO + (r0 + i) * HD + d);
        s[i] = __fmaf_rn(qv.x, kv.x, s[i]);
        s[i] = __fmaf_rn(qv.y, kv.y, s[i]);
        s[i] = __fmaf_rn(qv.z, kv.z, s[i]);
        s[i] = __fmaf_rn(qv.w, kv.w, s[i]);
        dp[i] = __fmaf_rn(ov.x, vv.x, dp[i]);
        dp[i] = __fmaf_rn(ov.y, vv.y, dp[i]);
        dp[i] = __fmaf_rn(ov.z, vv.z, dp[i]);
        dp[i] = __fmaf_rn(ov.w, vv.w, dp[i]);
      }
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float pr = visible(p, q0 + r0 + i, kj)
                           ? expf(s[i] * p.scale - ls[i]) : 0.0f;
      s[i] = pr * (dp[i] - dl[i]);         // dS
    }

    // acc += dS k: key c's dS comes from lane c by shuffle
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float kc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kc[j] = sK[c * KS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dsc = __shfl_sync(0xffffffffu, s[i], c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = __fmaf_rn(dsc, kc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    T* row = dq + q_off + static_cast<long long>(qi) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&row[lane + 32 * j], acc[i][j] * p.scale);
  }
}

// ---- pass 2: dk and dv ---------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, Params p) {
  constexpr int NJ = HD / 32;
  constexpr int QS = HD + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // kBKV x HD
  float* sV = sK + kBKV * HD;                    // kBKV x HD
  float* sQ = sV + kBKV * HD;                    // kBQ2 x QS
  float* sO = sQ + kBQ2 * QS;                    // kBQ2 x QS: do
  float* sL = sO + kBQ2 * QS;                    // kBQ2 lse
  float* sD = sL + kBQ2;                         // kBQ2 D

  const int S = p.S;
  const int k0 = blockIdx.x * kBKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long kv_off = (static_cast<long long>(b) * p.Hkv + hk) * S * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = (tid >> 5) * kKeysPerWarp;      // this warp's first key

  for (int e = tid; e < kBKV * HD; e += kThreads) {
    const int kj = k0 + e / HD;
    const long long g = kv_off + static_cast<long long>(kj) * HD + e % HD;
    sK[e] = kj < S ? to_f32(k[g]) : 0.0f;
    sV[e] = kj < S ? to_f32(v[g]) : 0.0f;
  }

  // the query rows that can see this block's keys: [i_begin, i_end)
  const int k_last = min(k0 + kBKV, S) - 1;
  int i_begin = p.causal ? k0 : 0;
  int i_end = p.window > 0 ? min(S, k_last + p.window) : S;
  if (k0 >= min(S, p.kv_len)) i_end = i_begin;   // every key masked

  float gk[kKeysPerWarp][NJ], gv[kKeysPerWarp][NJ];
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk)
#pragma unroll
    for (int j = 0; j < NJ; ++j) gk[kk][j] = gv[kk][j] = 0.0f;

  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const long long row0 = (static_cast<long long>(b) * p.Hq + hq) * S;
    for (int i0 = (i_begin / kBQ2) * kBQ2; i0 < i_end; i0 += kBQ2) {
      __syncthreads();                     // the last tile is consumed
      for (int e = tid; e < kBQ2 * HD; e += kThreads) {
        const int r = e / HD, c = e % HD;
        const int qi = i0 + r;
        const long long g = (row0 + qi) * HD + c;
        sQ[r * QS + c] = qi < S ? to_f32(q[g]) : 0.0f;
        sO[r * QS + c] = qi < S ? to_f32(dout[g]) : 0.0f;
      }
      if (tid < kBQ2) {
        const int qi = i0 + tid;
        sL[tid] = qi < S ? lse[row0 + qi] : 0.0f;
        sD[tid] = qi < S ? dsum[row0 + qi] : 0.0f;
      }
      __syncthreads();

      // this lane's query row against the warp's keys: q.k and do.v
      float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk) s[kk] = dp[kk] = 0.0f;
      const float* qrow = sQ + lane * QS;
      const float* orow = sO + lane * QS;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
        const float4 ov = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int kk = 0; kk < kKeysPerWarp; ++kk) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (w0 + kk) * HD + d);
          const float4 vv = *reinterpret_cast<const float4*>(sV + (w0 + kk) * HD + d);
          s[kk] = __fmaf_rn(qv.x, kv.x, s[kk]);
          s[kk] = __fmaf_rn(qv.y, kv.y, s[kk]);
          s[kk] = __fmaf_rn(qv.z, kv.z, s[kk]);
          s[kk] = __fmaf_rn(qv.w, kv.w, s[kk]);
          dp[kk] = __fmaf_rn(ov.x, vv.x, dp[kk]);
          dp[kk] = __fmaf_rn(ov.y, vv.y, dp[kk]);
          dp[kk] = __fmaf_rn(ov.z, vv.z, dp[kk]);
          dp[kk] = __fmaf_rn(ov.w, vv.w, dp[kk]);
        }
      }
      const int qi = i0 + lane;
      float pr[kKeysPerWarp], ds[kKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk) {
        pr[kk] = visible(p, qi, k0 + w0 + kk)
                     ? expf(s[kk] * p.scale - sL[lane]) : 0.0f;
        ds[kk] = pr[kk] * (dp[kk] - sD[lane]);
      }

      // dv += P do, dk += dS q: row r's P and dS come from lane r
#pragma unroll 4
      for (int r = 0; r < kBQ2; ++r) {
        float qc[NJ], oc[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          qc[j] = sQ[r * QS + lane + 32 * j];
          oc[j] = sO[r * QS + lane + 32 * j];
        }
#pragma unroll
        for (int kk = 0; kk < kKeysPerWarp; ++kk) {
          const float pc = __shfl_sync(0xffffffffu, pr[kk], r);
          const float dc = __shfl_sync(0xffffffffu, ds[kk], r);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            gv[kk][j] = __fmaf_rn(pc, oc[j], gv[kk][j]);
            gk[kk][j] = __fmaf_rn(dc, qc[j], gk[kk][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk) {
    const int kj = k0 + w0 + kk;
    if (kj >= S) continue;
    const long long g = kv_off + static_cast<long long>(kj) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(&dk[g + lane + 32 * j], gk[kk][j] * p.scale);
      store(&dv[g + lane + 32 * j], gv[kk][j]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, const Params& p, cudaStream_t stream) {
  constexpr size_t smem1 = dq_smem_bytes<HD>();
  constexpr size_t smem2 = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid1((p.S + kBQ - 1) / kBQ, p.Hq, B);
  flash_bwd_dq_kernel<T, HD><<<grid1, kThreads, smem1, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, dsum,
      static_cast<T*>(dq), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((p.S + kBKV - 1) / kBKV, p.Hkv, B);
  flash_bwd_dkdv_kernel<T, HD><<<grid2, kThreads, smem2, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      p);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

extern "C" {

// Launches both passes on `stream` (dq first, which also writes D into
// dsum (B, Hq, S) scratch; then dk and dv), every operand float32; lse
// (B, Hq, S) from the forward; hd must be 64, 128 or 256; window <= 0
// means none.
// Returns the CUDA error code of the first launch that was refused (0
// when both were accepted). B = 0 or S = 0 launches nothing.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* dsum, void* dq,
                               void* dk, void* dv, int B, int Hq, int Hkv,
                               int S, int hd, int causal, int window,
                               int kv_len, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{S, Hq, Hkv, causal != 0, window > 0 ? window : 0,
                 kv_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<float, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, p,
                               s);
    case 128:
      return launch<float, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                p, s);
    case 256:
      return launch<float, 256>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
