// One fused AdamW step over flat parameter, gradient and moment buffers,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_adamw.py:24 _adamw_kernel,
// reached by fused_adamw_pallas (pl.pallas_call at
// repro/kernels/fused_adamw.py:67). The plain torch version beside it is
// repro_torch/kernels/ref.py:fused_adamw_ref.
//
// What it computes. p and g (N,), float32 or bfloat16 (alike); m and v
// (N,) float32; host float32 scalars lr, bc1, bc2 and the constants b1,
// 1 - b1, b2, 1 - b2, eps, wd. For every element, in place:
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * (g * g)
//   p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
// in float32, every operation rounded on its own (the library is built
// with -fmad=false and without fast math, so division and sqrt are
// correctly rounded): the plain version's arithmetic step for step, so
// the two agree bit for bit. p is rounded back to its dtype.
//
// Bound. Each element reads p, g, m, v and writes p, m, v once: 28 bytes
// for float32 params (20 for bfloat16) against ~15 flops, so device
// memory (3.35 TB/s) bounds it. recurrentgemma-2b's 3,549,934,080 params
// move 99.4 GB: 29.7 ms.
//
// Design. N exceeds 2^31 at full width, so every index and stride is
// 64-bit. A grid-stride loop over groups of four elements reads each
// operand with one 16-byte load (8 bytes for bfloat16 p and g) when all
// four pointers are aligned for it; the ragged tail (N mod 4), and any
// call whose pointers are not so aligned, takes a scalar loop. The grid
// is sized to keep every SM busy (kBlocksPerSm blocks of 256 threads
// each), not to the length, so one launch covers any N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Scalars {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// one element, in registers; written so that no product meets an add
// before it is rounded (and -fmad=false keeps nvcc from contracting)
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.one_minus_b2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float vhat = __fdiv_rn(v, s.bc2);
  const float delta = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), s.eps)),
                                __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

// four elements of p or g: one 16-byte (float) or 8-byte (bfloat16) load
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ static void unpack(const float4& x, float* o) {
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static float4 pack(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;                        // 4 x bf16
  __device__ static void unpack(const uint2& x, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ static uint2 pack(const float* o) {
    uint2 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
    h[0] = __floats2bfloat162_rn(o[0], o[1]);
    h[1] = __floats2bfloat162_rn(o[2], o[3]);
    return x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_vec_kernel(T* __restrict__ p, const T* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v,
                 long long n4, Scalars s) {
  using V = typename Vec4<T>::type;
  V* p4 = reinterpret_cast<V*>(p);
  const V* g4 = reinterpret_cast<const V*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    float pv[4], gv[4];
    Vec4<T>::unpack(p4[i], pv);
    Vec4<T>::unpack(g4[i], gv);
    float4 mv = m4[i], vv = v4[i];
    step(pv[0], gv[0], mv.x, vv.x, s);
    step(pv[1], gv[1], mv.y, vv.y, s);
    step(pv[2], gv[2], mv.z, vv.z, s);
    step(pv[3], gv[3], mv.w, vv.w, s);
    p4[i] = Vec4<T>::pack(pv);
    m4[i] = mv;
    v4[i] = vv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_scalar_kernel(T* __restrict__ p, const T* __restrict__ g,
                    float* __restrict__ m, float* __restrict__ v,
                    long long begin, long long n, Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = begin + static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < n; i += stride) {
    float pi = to_f32(p[i]);
    float mi = m[i], vi = v[i];
    step(pi, to_f32(g[i]), mi, vi, s);
    from_f32(&p[i], pi);
    m[i] = mi;
    v[i] = vi;
  }
}

int grid_for(long long work) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch(void* p, const void* g, float* m, float* v, long long n,
           const Scalars& s, cudaStream_t stream) {
  T* pt = static_cast<T*>(p);
  const T* gt = static_cast<const T*>(g);
  constexpr uintptr_t pg_align = 4 * sizeof(T);
  const bool aligned =
      reinterpret_cast<uintptr_t>(pt) % pg_align == 0 &&
      reinterpret_cast<uintptr_t>(gt) % pg_align == 0 &&
      reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0;
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    adamw_vec_kernel<T><<<grid_for(n4), kThreads, 0, stream>>>(pt, gt, m, v,
                                                               n4, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    done = 4 * n4;
  }
  if (done < n) {
    adamw_scalar_kernel<T><<<grid_for(n - done), kThreads, 0, stream>>>(
        pt, gt, m, v, done, n, s);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches one AdamW step on `stream`, in place on p, m and v; dtype 0 =
// float32, 1 = bfloat16 (p and g alike; m and v are always float32). n is
// the element count (64-bit). Returns the CUDA error code of the launch
// (0 when it was accepted); n = 0 launches nothing. One call launches one
// kernel, or two when a ragged tail follows the vectorised body.
int fused_adamw_launch(void* p, const void* g, void* m, void* v,
                       long long n, float lr, float bc1, float bc2, float b1,
                       float one_minus_b1, float b2, float one_minus_b2,
                       float eps, float wd, int dtype, void* stream) {
  if (n <= 0) return 0;
  const Scalars s{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  if (dtype == 0) return launch<float>(p, g, mf, vf, n, s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, g, mf, vf, n, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
