// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + u_t, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru.py:58 _rglru_kernel (with
// its in-tile scan _tile_scan, :36), reached by rglru_scan_pallas
// (pl.pallas_call at repro/kernels/rglru.py:93). The plain torch version
// beside it is repro_torch/kernels/ref.py:rglru_scan_ref.
//
// What it computes. a, u, h (B, T, D), contiguous, float32 or bfloat16;
// for every batch row b and channel d, in time order from h_{-1} = 0:
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + u[b, t, d]
// in float32, each product rounded before its add (built with
// -fmad=false, no fast math), stored in the inputs' dtype. That is the
// plain version's arithmetic step for step, so the two agree bit for bit.
//
// Bound. Each element of a and u is read once and of h written once:
// 3 * B * T * D * (2 or 4) bytes, against 2 flops per element, so device
// memory (3.35 TB/s) bounds it. recurrentgemma-2b's serving shape (4,
// 4096, 2560) in float32 moves 503 MB: 150 us.
//
// Design (simple first). The TPU kernel carries the state across time
// blocks in VMEM scratch, relying on the grid running in order; Hopper's
// blocks run in no order, so the carry stays inside one thread: one
// thread per (b, d) channel walks T in order, and a warp's 32 threads
// read 32 neighbouring channels of one time step, so every load is
// coalesced. The TPU's log-depth in-tile composition is not carried over:
// a sequential walk does 2 flops per element, the composition ~2 log2 of
// the tile, and the bound is bytes. To keep loads in flight the walk
// fetches kUnroll time steps of a and u into registers before it runs
// them; blocks are narrow (64 channels) so that B * D / 64 blocks spread
// over the SMs (160 blocks at the serving shape). Left for later: a
// chunked two-pass scan over T, to put more of the card to work when
// B * D is small.
//
// The adjoint (rglru_scan_bwd_launch; no TPU counterpart: the reference
// differentiates plain jnp and has no backward kernel). Given the
// forward's a and h and the loss's gradient dh with respect to h, the
// same one-thread-per-channel walk runs backward in time from the last
// step: g_t = dh_t + a_{t+1} * g_{t+1} (a_T = 0), and writes du_t = g_t
// and da_t = g_t * h_{t-1} (h_{-1} = 0) from the saved h, so no
// elementwise pass follows it. Float32, the product rounded before its
// add: equal bit for bit to repro_torch/kernels/ref.py:rglru_scan_bwd_ref.
// It reads a, h and dh and writes da and du: 5 * B * T * D * (2 or 4)
// bytes, bound by device memory as the forward is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  T* __restrict__ h, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = static_cast<long long>(blockIdx.y) * T_len * D + d;
  const T* ap = a + base;
  const T* up = u + base;
  T* hp = h + base;
  float state = 0.0f;
  int t = 0;
  for (; t + kUnroll <= T_len; t += kUnroll) {
    float av[kUnroll], uv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long off = static_cast<long long>(t + j) * D;
      av[j] = load(ap + off);
      uv[j] = load(up + off);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      state = av[j] * state + uv[j];
      store(hp + static_cast<long long>(t + j) * D, state);
    }
  }
  for (; t < T_len; ++t) {
    const long long off = static_cast<long long>(t) * D;
    state = load(ap + off) * state + load(up + off);
    store(hp + off, state);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                      const T* __restrict__ dh, T* __restrict__ da,
                      T* __restrict__ du, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = static_cast<long long>(blockIdx.y) * T_len * D + d;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = dh + base;
  T* dap = da + base;
  T* dup = du + base;
  float carry = 0.0f;
  float a_next = 0.0f;                     // a_{t+1}; a_T = 0
  int t = T_len - 1;
  for (; t + 1 >= kUnroll; t -= kUnroll) { // steps t, t-1, ..., t-kUnroll+1
    float av[kUnroll], hv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int tj = t - j;
      const long long off = static_cast<long long>(tj) * D;
      av[j] = load(ap + off);
      gv[j] = load(gp + off);
      hv[j] = tj > 0 ? load(hp + off - D) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long off = static_cast<long long>(t - j) * D;
      carry = a_next * carry + gv[j];
      store(dup + off, carry);
      store(dap + off, carry * hv[j]);
      a_next = av[j];
    }
  }
  for (; t >= 0; --t) {
    const long long off = static_cast<long long>(t) * D;
    carry = a_next * carry + load(gp + off);
    store(dup + off, carry);
    store(dap + off, carry * (t > 0 ? load(hp + off - D) : 0.0f));
    a_next = load(ap + off);
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, void* da,
               void* du, int B, int T_len, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(du),
      T_len, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* u, void* h, int B, int T_len, int D,
           cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), static_cast<T*>(h),
      T_len, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the scan on `stream`; dtype 0 = float32, 1 = bfloat16 (a, u
// and h alike). Returns the CUDA error code of the launch (0 when it was
// accepted). An empty operand launches nothing.
int rglru_scan_launch(const void* a, const void* u, void* h, int B,
                      int T_len, int D, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, u, h, B, T_len, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, u, h, B, T_len, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the adjoint on `stream`: a, h (the forward's output) and dh
// in, da and du out, all (B, T, D) of one dtype (0 = float32, 1 =
// bfloat16). Returns the CUDA error code of the launch; an empty operand
// launches nothing.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                          void* da, void* du, int B, int T_len, int D,
                          int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, h, dh, da, du, B, T_len, D, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, dh, da, du, B, T_len, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
