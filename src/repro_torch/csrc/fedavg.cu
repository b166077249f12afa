// Weighted FedAvg reduction over row-indexed client updates, for Hopper
// (sm_90a).
//
// Replaces both FedAvg TPU kernels of the reference:
//   repro/kernels/fedavg.py:31 _fedavg_batched_kernel, reached by
//     fedavg_batched_pallas (pl.pallas_call at repro/kernels/fedavg.py:60);
//   repro/kernels/fedavg.py:25 _fedavg_kernel, reached by fedavg_pallas
//     (pl.pallas_call at repro/kernels/fedavg.py:86) — the case G = 1.
// The plain torch versions beside it are repro_torch/kernels/ref.py:
// fedavg_rows_ref, fedavg_batched_ref and fedavg_ref.
//
// What it computes, for every cluster g and column n:
//   out[g, n] = sum over k = 0..K-1 with rows[g, k] >= 0 of
//               w[g, k] * pool[rows[g, k], n]
// in float32, the terms added in k order, each product rounded before
// its add (built with -fmad=false, no fast math), the result stored in
// the pool's dtype (float32 or bfloat16, round to nearest even).
// Operands: pool (R, N) contiguous, rows (G, K) int32 with -1 for "no
// member" (a cluster with fewer than K members, or a padding cluster,
// which then comes out 0), w (G, K) f32, out (G, N) contiguous. Rows
// index the pool, so a tree level reads its clients' update rows and
// its child clusters' output rows in place: the (G, K, N) stack the TPU
// kernel takes is the special case rows = arange(G * K).
//
// Bound. Every member row is read once, every output row written once,
// and the tables once: bytes = in_bytes * N * (rows read) + out_bytes *
// G * N + 8 * G * K; two flops per element read. That is ~0.5 flop per
// byte, so device memory (3.35 TB/s) bounds it. paper-fig4 with the
// paper MLP (N = 1,791,754): the leaf level (G = 2, K = 5, 9 rows)
// moves 78.8 MB -> 23.5 us, the root level (G = 1, K = 3) 28.7 MB ->
// 8.6 us; a 256-client tree's leaf level (G = 4, K = 64, 253 rows)
// 1.84 GB -> 550 us.
//
// Design (simple first). A 1-D grid over (cluster, column chunk): each
// block of 256 threads owns 256 * V neighbouring columns of one cluster,
// each thread V of them, V = 16 bytes of the dtype (4 f32, 8 bf16). The
// thread walks k = 0..K-1 in order, loads its V columns of the member
// row with one 16-byte load when the address is 16-byte aligned, and
// element by element otherwise: a row starts at r * N elements, so when
// N is not a multiple of V the rows' alignments differ. The alignment
// depends only on the row, so the branch is uniform across a block.
// Columns past N (the ragged tail) are neither read nor written. The
// sequential grid dimension of the TPU kernel becomes the k loop inside
// the thread; nothing is staged in shared memory, since each element is
// read once. Left for later: keeping more loads in flight (cp.async or
// TMA staging) and fusing the next level's weighting.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec16;  // V elements of T in 16 bytes

template <>
struct Vec16<float> {
  static constexpr int V = 4;
  using type = float4;
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  using type = uint4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_rows_kernel(const T* __restrict__ pool,      // (R, N)
                   const int* __restrict__ rows,    // (G, K), -1 = none
                   const float* __restrict__ w,     // (G, K)
                   T* __restrict__ out,             // (G, N)
                   int K, long long N, long long blocks_per_cluster) {
  using VecT = typename Vec16<T>::type;
  constexpr int V = Vec16<T>::V;
  const long long g = blockIdx.x / blocks_per_cluster;
  const long long chunk = blockIdx.x % blocks_per_cluster;
  const long long c0 = (chunk * kThreads + threadIdx.x) * V;
  if (c0 >= N) return;
  const bool full = c0 + V <= N;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;

  const int* grow = rows + g * K;
  const float* gw = w + g * K;
  for (int k = 0; k < K; ++k) {
    const int r = __ldg(&grow[k]);
    if (r < 0) continue;
    const float wk = __ldg(&gw[k]);
    const T* src = pool + static_cast<long long>(r) * N + c0;
    if (full && aligned16(src)) {
      const VecT raw = __ldg(reinterpret_cast<const VecT*>(src));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = acc[j] + to_f32(e[j]) * wk;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (c0 + j < N) acc[j] = acc[j] + to_f32(src[j]) * wk;
      }
    }
  }

  T* dst = out + g * N + c0;
  if (full && aligned16(dst)) {
    VecT raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) store(&e[j], acc[j]);
    *reinterpret_cast<VecT*>(dst) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c0 + j < N) store(&dst[j], acc[j]);
    }
  }
}

template <typename T>
int launch(const void* pool, const void* rows, const void* w, void* out,
           int G, int K, long long N, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * Vec16<T>::V;
  const long long blocks_per_cluster = (N + per_block - 1) / per_block;
  const long long grid = static_cast<long long>(G) * blocks_per_cluster;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  fedavg_rows_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(pool), static_cast<const int*>(rows),
      static_cast<const float*>(w), static_cast<T*>(out), K, N,
      blocks_per_cluster);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the reduction on `stream`; dtype 0 = float32, 1 = bfloat16
// (pool and out). Returns the CUDA error code of the launch (0 when it
// was accepted). G = 0 or N = 0 launches nothing.
int fedavg_rows_launch(const void* pool, const void* rows, const void* w,
                       void* out, int G, int K, long long N, int dtype,
                       void* stream) {
  if (G <= 0 || N <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(pool, rows, w, out, G, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(pool, rows, w, out, G, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
