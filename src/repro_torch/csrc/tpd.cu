// Batched TPD (paper eqs. 6-7) over a placement swarm, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tpd.py:_tpd_kernel, reached by
// batch_tpd_pallas (pl.pallas_call at repro/kernels/tpd.py:133). It
// computes the same function; the plain torch version beside it is
// repro_torch/kernels/ref.py:tpd_ref.
//
// What it computes, per particle p and aggregator slot s, with the leaf
// level the slot range [leaf_start, D) and L = D - leaf_start leaves:
//   load  = mds[host] + (s >= leaf_start ? leaf_load[p, s - leaf_start]
//                        : sum over kids[s, w] >= 0 of mds[p[kids[s, w]]])
//   delay = load / pspeed[host]  (x (1 + penalty * over / max(cap, 1e-9)))
//   out[p] = sum over levels, deepest first, of max_{s in level} delay
//
// Operands: placements (P, D) int32, attrs (3, C) f32 = [mdatasize,
// pspeed, memcap], leaf_load (P, L) f32, kids (D, W) int32 with -1 where
// a slot has fewer than W child slots, and the depth + 1 level starts,
// passed by value. Leaf-ness and the leaf index follow from the level
// starts, a kid's validity from its -1 sentinel: the TPU kernel's
// kids_valid, is_leaf and slot_leaf_idx tables are not needed.
//
// Bound. The function reads each placement row, each leaf-load row and
// the kid rows of the internal slots once, writes P floats, and reads
// mdatasize and pspeed (and memcap when penalty > 0) only at the ids the
// swarm places: P*(4D + 4L + 4) + 4W*(D - L) + 4*rows*ids bytes, with
// rows 2 or 3 and ids <= C the number of distinct placed ids. Its
// arithmetic is a few flops per slot, so it is bound by bytes over the
// 3.35 TB/s of device memory: at large-10k with P = 10 about 0.2 MB, well
// under a microsecond, and the launch itself (a few microseconds) sets
// the pace. The design answers with one launch per swarm evaluation and
// nothing else on the device between host calls: one block per particle,
// the whole evaluation fused, no intermediate written to device memory.
//
// Design. One block per particle. The block stages the particle's
// placement row in shared memory (D ids, 5.5 KB at large-10k), then
// threads stride over slots; each thread computes one slot's load and
// delay, reading the attribute table through the read-only cache and
// summing the kids in column order 0..W-1, and stores the delay in
// shared memory. A level is the contiguous slot range
// [level_starts[l], level_starts[l+1]); each level's maximum is a block
// reduction (warp shuffles, then one value per warp). One thread adds
// the level maxima deepest level first. Built with -fmad=false and
// without fast math, every add, multiply and divide rounds as the plain
// torch version's does, so the two agree bit for bit.
//
// What stays behind from the TPU kernel: the one-hot (depth, D) masked
// max and its -3.4e38 sentinel (a level here is a slot range), the
// padding of the swarm with copies of row 0 (the grid is exactly P
// blocks), and the 8/64-particle tiles (a block is one particle).
//
// A placement id outside [0, C) is not read: the particle's output is
// NaN instead.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDepth = 32;
constexpr int kMaxThreads = 256;

struct LevelStarts {
  int at[kMaxDepth + 1];  // level l is the slot range [at[l], at[l + 1])
};

__global__ void __launch_bounds__(kMaxThreads)
tpd_kernel(const int* __restrict__ placements,     // (P, D)
           const float* __restrict__ attrs,        // (3, C)
           const float* __restrict__ leaf_load,    // (P, L)
           const int* __restrict__ kids,           // (D, W), -1 padded
           float* __restrict__ out,                // (P,)
           const LevelStarts levels, int D, int C, int W, int depth,
           float penalty) {
  extern __shared__ int smem[];
  int* row = smem;                                  // (D,) placement row
  float* delay = reinterpret_cast<float*>(smem + D);  // (D,) slot delays
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float level_max[kMaxDepth];
  __shared__ int bad_id;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const float* mds = attrs;
  const float* pspeed = attrs + C;
  const float* memcap = attrs + 2 * C;
  const int leaf_start = levels.at[depth - 1];
  const int L = D - leaf_start;

  if (tid == 0) bad_id = 0;
  __syncthreads();
  const int* prow = placements + static_cast<size_t>(p) * D;
  for (int s = tid; s < D; s += nthreads) {
    int id = prow[s];
    if (id < 0 || id >= C) {
      bad_id = 1;
      id = 0;
    }
    row[s] = id;
  }
  __syncthreads();

  const float* lrow = leaf_load + static_cast<size_t>(p) * L;
  for (int s = tid; s < D; s += nthreads) {
    const int host = row[s];
    float child;
    if (s >= leaf_start) {
      child = __ldg(&lrow[s - leaf_start]);
    } else {
      const int* ks = kids + static_cast<size_t>(s) * W;
      int k = __ldg(&ks[0]);
      child = k >= 0 ? __ldg(&mds[row[k]]) : 0.0f;
      for (int w = 1; w < W; ++w) {
        k = __ldg(&ks[w]);
        child = child + (k >= 0 ? __ldg(&mds[row[k]]) : 0.0f);
      }
    }
    const float load = __ldg(&mds[host]) + child;
    float d = load / __ldg(&pspeed[host]);
    if (penalty > 0.0f) {
      const float cap = __ldg(&memcap[host]);
      const float over = fmaxf(0.0f, load - cap);
      d = d * (1.0f + penalty * over / fmaxf(cap, 1e-9f));
    }
    delay[s] = d;
  }
  __syncthreads();

  for (int l = 0; l < depth; ++l) {
    const int a = levels.at[l];
    const int b = levels.at[l + 1];
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int s = a + tid; s < b; s += nthreads) m = fmaxf(m, delay[s]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (tid == 0) {
      float mm = warp_max[0];
      for (int i = 1; i < nwarps; ++i) mm = fmaxf(mm, warp_max[i]);
      level_max[l] = mm;
    }
    __syncthreads();
  }

  if (tid == 0) {
    float total = 0.0f;
    for (int l = depth - 1; l >= 0; --l) total = total + level_max[l];
    out[p] = bad_id ? __int_as_float(0x7fc00000) : total;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for P particles; `level_starts` is a
// host array of depth + 1 ints, copied into the launch's arguments.
// Returns the CUDA error code of the launch (0 when it was accepted).
int tpd_launch(const void* placements, const void* attrs,
               const void* leaf_load, const void* kids, void* out,
               const int* level_starts, int P, int D, int C, int W,
               int depth, float penalty, void* stream) {
  if (P <= 0) return 0;
  if (D <= 0 || W <= 0 || depth <= 0 || depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelStarts levels = {};
  for (int l = 0; l <= depth; ++l) levels.at[l] = level_starts[l];
  int threads = ((D + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(D) * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tpd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tpd_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(placements), static_cast<const float*>(attrs),
      static_cast<const float*>(leaf_load), static_cast<const int*>(kids),
      static_cast<float*>(out), levels, D, C, W, depth, penalty);
  return static_cast<int>(cudaGetLastError());
}

const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
