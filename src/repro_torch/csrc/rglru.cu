// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + u_t and its adjoint,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru.py:58 _rglru_kernel (with
// its in-tile scan _tile_scan, :36), reached by rglru_scan_pallas
// (pl.pallas_call at repro/kernels/rglru.py:93). The plain torch versions
// beside it are repro_torch/kernels/ref.py:rglru_scan_ref and
// rglru_scan_bwd_ref.
//
// What it computes. a, u, h (B, T, D), contiguous, float32 or bfloat16;
// for every batch row b and channel d, in time order from h_{-1} = 0:
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + u[b, t, d]
// in float32, each product rounded before its add (built with
// -fmad=false, no fast math), stored in the inputs' dtype. That is the
// plain version's arithmetic step for step, so the two agree bit for bit.
// The adjoint (rglru_scan_bwd_launch; no TPU counterpart: the reference
// differentiates plain jnp) takes the forward's a and h and the loss's
// gradient dh, walks backward in time from the last step,
//   g_t = dh_t + a_{t+1} * g_{t+1}   (a_T = 0),
// and writes du_t = g_t and da_t = g_t * h_{t-1} (h_{-1} = 0), again the
// plain version's float32 arithmetic in its order.
//
// Bound. Each element of the operands is read once and of the outputs
// written once: 3 * B * T * D elements for the forward (a, u -> h) and
// 5 for the adjoint (a, h, dh -> da, du), against 2 or 3 flops each, so
// device memory (3.35 TB/s) bounds both: the forward at recurrentgemma-
// 2b's serving shape (4, 4096, 2560) f32 moves 503 MB (150 us), at its
// training shape (1, 2048, 2560) 63 MB (18.8 us); the adjoint there 105
// MB (31.3 us).
//
// Design. The TPU kernel carries the state across time blocks in VMEM
// scratch, relying on the grid running in order, and composes each tile
// in log depth. Here each (b, d) channel is walked by one thread in time
// order, so the sums keep the plain version's order and the carry never
// leaves a register. Such a walk is limited by what one thread can keep
// moving: loads it issues itself keep a few steps in flight (the design
// before this one, 64 threads a block and 16 steps of loads a thread,
// reached 0.38 TB/s at the training shape). So a block is one warp, a
// group of kGroup = 32 neighbouring channels (B * D / 32 blocks, 80 at B
// 1, D 2560), and its operands stream through a ring of 2-8 stages in
// shared memory, each stage a tile of kTileSteps time steps x kGroup
// channels of every operand, guarded by one "full" mbarrier a stage. Two
// routes fill the ring:
//  - TMA (cp.async.bulk.tensor, 3-D maps over (D, T, B)), one box per
//    operand and stage, issued by thread 0, wherever a row of D elements
//    is a multiple of 16 bytes and every operand is 16-byte aligned (the
//    map's stride rule): every model shape. Boxes that run past T, past
//    D or before t = 0 come back zero-filled, so the adjoint's h tile is
//    simply read one row early: its row r is h_{t-1} for step t, and
//    h_{-1} arrives as the zero it must be. The outputs leave the same
//    way: each step's result goes to a staging tile in shared memory,
//    two a block so that one fills while the other is stored, and thread
//    0 stores a whole tile with one TMA store, clipped at T and D (a
//    store box may not start before t = 0, so the adjoint's last tile,
//    when T is not a multiple of kTileSteps, is written a step at a
//    time);
//  - cp.async (LDGSTS) of 4-byte words, each thread copying its own
//    channel's column, the stage's barrier tracking them through
//    cp.async.mbarrier.arrive, for the widths TMA cannot map (D 70 f32,
//    odd D bf16). A bf16 element is copied as the aligned 4-byte word
//    that holds it and its half picked on reading (every such word lies
//    inside the allocation that holds the element: allocations start
//    and end on 4-byte boundaries); rows outside [0, T) are zero-filled.
//    Outputs are stored a step at a time, a warp's stores of one step one
//    whole coalesced row of its group. This route issues a copy per
//    element and thread, so it is slower; no model width takes it. It
//    is kept over copying such operands into fresh padded, aligned
//    buffers in the wrapper, which adds a pass over every operand
//    outside the kernel (PERF.md has both times).
// The wrapper (kernels/rglru.py:launch_plan) picks the route and the
// stage count; no route gives way to another. The walk issues in
// order, one warp, so its instruction stream is the kernel: while the
// chain runs batch kb (kBatch steps) from registers, the loads of batch
// kb + 1 from shared memory are interleaved with it, step for step, so
// the chain never waits on a shared-memory load; stage, phase and
// staging tile advance as counters, so the walk holds no division; a
// stage is refilled once every thread of the block has run its last
// batch.
//
// In flight. The plan aims at ~48 KB of loads in flight an SM: its share
// of 3.35 TB/s, 25 GB/s, over ~2 us of loaded memory latency. A stage of
// the forward's tile is 64 steps x 32 channels x 2 operands x 4 B = 16
// KB (the adjoint's 24 KB): at the training shape (1, 2048, 2560) 80
// blocks, one an SM, take 4 stages and keep 3 loading while the walk
// runs one: 80 x 3 x 16 KB = 3.9 MB in flight over the card; at the
// serving shape (4, 4096, 2560) 320 blocks, 3 an SM, take 2 stages:
// 320 x 16 KB = 5.2 MB. Deeper rings at the serving shape were slower.
//
// What limits it now. At B 1 the card runs 80 warps, one an SM, each
// walking its 2048 steps in order: a step is an fmul and an fadd in
// chain (~8 cycles, -fmad=false) with 2 shared-memory loads and a
// staging store beside them (3 loads and 2 stores for the adjoint), so
// the walk's issue, not device memory, sets the time there; at the
// serving shape device memory does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using sm90::mbar_expect_tx;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load;

constexpr int kGroup = 32;      // channels of one block, a thread each
constexpr int kTileSteps = 64;  // time steps of one ring stage
constexpr int kBatch = 16;      // steps read into registers ahead of the chain
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kTmaRoute = 0;
constexpr int kCpAsyncRoute = 1;
static_assert(kTileSteps % kBatch == 0, "a batch never straddles two tiles");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one 4-byte word from global into shared memory; src_bytes 0 reads
// nothing and zero-fills it
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

// the barrier's phase counts this thread once all of its cp.async so far
// have landed (the barrier's count includes the arrival: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar) : "memory");
}

// this thread's shared-memory writes, seen by the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one box from shared memory at src to (c0, c1, c2) of the map's tensor;
// the parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N committed bulk stores are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

template <typename T>
struct Args {
  const T* in[3];  // forward: a, u; adjoint: a, h, dh
  T* out[2];       // forward: h; adjoint: da, du
  int T_len;
  int D;
  int stages;
};

// One block's walk: kGroup channels of batch row blockIdx.y, one a thread.
template <typename T, bool kBwd, int kRoute>
struct Walk {
  static constexpr int kOps = kBwd ? 3 : 2;
  static constexpr int kOuts = kOps - 1;
  static_assert(kOuts == (kBwd ? 2 : 1), "h, or da and du");
  static constexpr bool kTma = kRoute == kTmaRoute;
  // a ring word: the element itself (TMA), or the 4-byte word holding it
  using Word = typename std::conditional<kTma, T, uint32_t>::type;
  static constexpr int kTileWords = kTileSteps * kGroup;

  Args<T> p;
  const CUtensorMap* maps[5];  // the inputs', then (TMA) the outputs'
  Word* ring;
  T* staged;                   // TMA: two tiles of every output
  uint64_t* full;
  int c, d, d0, b, n_tiles, n_batches;
  long long row0;            // (b, 0)'s row in the (B * T, D) view
  uint32_t half_parity[3];   // bf16 cp.async: bit 1 of (b, 0, d)'s address
  // the stage and barrier phase of the tile being read (fslot, fphase),
  // of the tile to release next (rslot), and the staging tile being
  // written (obuf) advance a tile at a time: no division in the walk,
  // whose issue is in order
  int fslot, fphase, rslot, obuf;

  // the first step of tile k, and operand o's first row in it: the
  // adjoint's tiles are cut from the last step down, its h tile one row
  // early (row r holds h_{t-1} for step t = t0 + r)
  __device__ __forceinline__ int tile_t0(int k) const {
    return kBwd ? p.T_len - (k + 1) * kTileSteps : k * kTileSteps;
  }
  static __device__ __forceinline__ int shift(int o) {
    return kBwd && o == 1 ? -1 : 0;
  }
  __device__ __forceinline__ Word* slot(int s, int o) const {
    return ring + (s * kOps + o) * kTileWords;
  }
  // the row of a batch's step j within its tile: rows run down in time
  // for the adjoint
  static __device__ __forceinline__ int row(int kb, int j) {
    const int r = (kb * kBatch) % kTileSteps + j;
    return kBwd ? kTileSteps - 1 - r : r;
  }
  // the time step of a batch's step j
  __device__ __forceinline__ int step_t(int kb, int j) const {
    const int s = kb * kBatch + j;
    return kBwd ? p.T_len - 1 - s : s;
  }

  // tile k into stage s
  __device__ __forceinline__ void issue(int k, int s) const {
    const uint32_t bar = smem_u32(&full[s]);
    const int t0 = tile_t0(k);
    if constexpr (kTma) {
      if (c == 0) {
        mbar_expect_tx(bar, kOps * kTileWords * static_cast<int>(sizeof(T)));
#pragma unroll
        for (int o = 0; o < kOps; ++o)
          tma_load(smem_u32(slot(s, o)), maps[o], bar, d0, t0 + shift(o), b);
      }
    } else {
#pragma unroll
      for (int o = 0; o < kOps; ++o) {
        // this thread's column: rows [lo, hi) lie in [0, T), the rest
        // are zero-filled
        const int first = t0 + shift(o);
        const int lo = d < p.D ? max(0, -first) : kTileSteps;
        const int hi = min(kTileSteps, p.T_len - first);
        const uint32_t dst = smem_u32(slot(s, o) + c);
        const char* src = reinterpret_cast<const char*>(
            p.in[o] + (row0 + first) * p.D + d);
        const long long row_bytes = static_cast<long long>(p.D) * sizeof(T);
#pragma unroll 8
        for (int r = 0; r < kTileSteps; ++r) {
          const bool in = r >= lo && r < hi;
          const char* at = src + r * row_bytes;
          if constexpr (sizeof(T) == 2)   // the aligned word that holds it
            at -= reinterpret_cast<uintptr_t>(at) & 3;
          cp_async4(dst + r * kGroup * 4,
                    in ? static_cast<const void*>(at)
                       : static_cast<const void*>(p.in[o]),
                    in ? 4 : 0);
        }
      }
      cp_async_arrive(bar);
    }
  }

  // waits for the next tile, in the next stage
  __device__ __forceinline__ void open() {
    if (++fslot == p.stages) {
      fslot = 0;
      fphase ^= 1;
    }
    mbar_wait(smem_u32(&full[fslot]), fphase);
  }

  // operand o of batch kb's step j, read from the open stage
  __device__ __forceinline__ float read(int o, int kb, int j) const {
    const Word w = slot(fslot, o)[row(kb, j) * kGroup + c];
    if constexpr (kTma) {
      return to_float(w);
    } else if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(w);
    } else {
      // the element's half of its word: the high one where bit 1 of its
      // address is set (little-endian)
      const int t = step_t(kb, j) + shift(o);
      const uint32_t hi = half_parity[o] ^ (t & p.D & 1);
      return __uint_as_float(hi ? (w & 0xFFFF0000u) : (w << 16));
    }
  }

  // output q of batch kb's step j: into the staging tile (TMA), or to
  // device memory
  __device__ __forceinline__ void put(int q, int kb, int j, float x) const {
    if constexpr (kTma) {
      staged[(obuf * kOuts + q) * kTileWords + row(kb, j) * kGroup + c] =
          from_float<T>(x);
    } else if (d < p.D) {
      p.out[q][(row0 + step_t(kb, j)) * p.D + d] = from_float<T>(x);
    }
  }

  // after the last batch of tile k, once the whole block is past it: its
  // outputs go out (TMA: one store a staged tile), its stage takes tile
  // k + stages
  __device__ __forceinline__ void release(int kb) {
    const int s1 = (kb + 1) * kBatch;
    if (s1 % kTileSteps != 0 && s1 < p.T_len) return;
    const int k = kb * kBatch / kTileSteps;
    if constexpr (kTma) fence_proxy_async();
    __syncthreads();
    if constexpr (kTma) {
      const int t0 = tile_t0(k);
      if (t0 < 0) {
        // the adjoint's last tile starts before t = 0, where a store box
        // may not: its rows from t = 0 leave a step at a time
        if (d < p.D) {
#pragma unroll
          for (int q = 0; q < kOuts; ++q)
            for (int r = -t0; r < kTileSteps; ++r)
              p.out[q][(row0 + t0 + r) * p.D + d] =
                  staged[(obuf * kOuts + q) * kTileWords + r * kGroup + c];
        }
      } else if (c == 0) {
#pragma unroll
        for (int q = 0; q < kOuts; ++q)
          tma_store(maps[kOps + q],
                    smem_u32(staged + (obuf * kOuts + q) * kTileWords), d0,
                    t0, b);
        bulk_commit();
      }
    }
    if (k + p.stages < n_tiles) issue(k + p.stages, rslot);
    if (++rslot == p.stages) rslot = 0;
    if constexpr (kTma) {
      // the other staging tile is written next: its store must have read it
      if (c == 0) bulk_wait_read<1>();
      __syncthreads();
      obuf ^= 1;
    }
  }
};

// One batch: reads batch kb + 1 (when there is one) from its stage into
// nxt while the chain runs batch kb from cur. Forward: state = a * state
// + u, stored as h. Adjoint, steps t, t - 1, ...: carry = a_{t+1} * carry
// + dh_t, du_t = carry, da_t = carry * h_{t-1}.
template <typename T, bool kBwd, int kRoute>
__device__ __forceinline__ void batch(Walk<T, kBwd, kRoute>& w, int kb,
                                      const float (&cur)[kBwd ? 3 : 2][kBatch],
                                      float (&nxt)[kBwd ? 3 : 2][kBatch],
                                      float& state, float& a_next) {
  constexpr int kOps = kBwd ? 3 : 2;
  auto run = [&](int j) {
    if constexpr (kBwd) {
      state = a_next * state + cur[2][j];
      w.put(1, kb, j, state);
      w.put(0, kb, j, state * cur[1][j]);
      a_next = cur[0][j];
    } else {
      state = cur[0][j] * state + cur[1][j];
      w.put(0, kb, j, state);
    }
  };
  if (kb + 1 < w.n_batches) {      // a whole batch, and one after it
    if ((kb + 1) * kBatch % kTileSteps == 0) w.open();
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int o = 0; o < kOps; ++o) nxt[o][j] = w.read(o, kb + 1, j);
      run(j);
    }
  } else {                          // the last batch, maybe partial
    const int n = w.p.T_len - kb * kBatch;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < n) run(j);
  }
}

template <typename T, bool kBwd, int kRoute>
__device__ __forceinline__ void walk(const CUtensorMap* const (&maps)[5],
                                     const Args<T>& p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  using W = Walk<T, kBwd, kRoute>;
  W w;
  w.p = p;
#pragma unroll
  for (int i = 0; i < 5; ++i) w.maps[i] = maps[i];
  // the ring starts on a 128-byte boundary (TMA's rule), the staging
  // tiles after it
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 127u) & ~127u) - raw);
  w.ring = reinterpret_cast<typename W::Word*>(base);
  w.staged = reinterpret_cast<T*>(base + static_cast<size_t>(p.stages) *
                                             W::kOps * W::kTileWords *
                                             sizeof(typename W::Word));
  w.full = full;
  w.c = threadIdx.x;
  w.d0 = blockIdx.x * kGroup;
  w.d = w.d0 + w.c;
  w.b = blockIdx.y;
  w.n_tiles = (p.T_len + kTileSteps - 1) / kTileSteps;
  w.n_batches = (p.T_len + kBatch - 1) / kBatch;
  w.row0 = static_cast<long long>(w.b) * p.T_len;
#pragma unroll
  for (int o = 0; o < W::kOps; ++o)
    w.half_parity[o] = static_cast<uint32_t>(
        (reinterpret_cast<uintptr_t>(p.in[o] + w.row0 * p.D + w.d) >> 1) & 1);

  if (w.c == 0) {
    for (int s = 0; s < p.stages; ++s)
      mbar_init(smem_u32(&full[s]), W::kTma ? 1 : kGroup);
    mbar_fence_init();
  }
  __syncthreads();
  for (int k = 0; k < min(p.stages, w.n_tiles); ++k) w.issue(k, k);
  w.fslot = p.stages - 1;  // the first open() takes stage 0, phase 0
  w.fphase = 1;
  w.rslot = 0;
  w.obuf = 0;

  // two register buffers: batch kb + 1 is read while batch kb runs
  float x0[W::kOps][kBatch], x1[W::kOps][kBatch];
  float state = 0.0f, a_next = 0.0f;  // a_next: a_{t+1}, a_T = 0
  w.open();
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
#pragma unroll
    for (int o = 0; o < W::kOps; ++o) x0[o][j] = w.read(o, 0, j);
  for (int kb = 0; kb < w.n_batches; kb += 2) {
    batch(w, kb, x0, x1, state, a_next);
    w.release(kb);
    if (kb + 1 >= w.n_batches) break;
    batch(w, kb + 1, x1, x0, state, a_next);
    w.release(kb + 1);
  }
  if constexpr (W::kTma) {
    if (w.c == 0) bulk_wait_read<0>();  // the staged tiles stay until read
  }
}

template <typename T, int kRoute>
__global__ void __launch_bounds__(kGroup)
rglru_scan_kernel(const __grid_constant__ CUtensorMap a,
                  const __grid_constant__ CUtensorMap u,
                  const __grid_constant__ CUtensorMap h, Args<T> p) {
  const CUtensorMap* const maps[5] = {&a, &u, &h, nullptr, nullptr};
  walk<T, false, kRoute>(maps, p);
}

template <typename T, int kRoute>
__global__ void __launch_bounds__(kGroup)
rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap a,
                      const __grid_constant__ CUtensorMap h,
                      const __grid_constant__ CUtensorMap dh,
                      const __grid_constant__ CUtensorMap da,
                      const __grid_constant__ CUtensorMap du, Args<T> p) {
  const CUtensorMap* const maps[5] = {&a, &h, &dh, &da, &du};
  walk<T, true, kRoute>(maps, p);
}

// The map of one (B, T, D) operand, boxes of kGroup channels x
// kTileSteps steps of one batch row, no swizzle, zero fill. Returns 0 or
// a CUDA error code.
int make_map(CUtensorMap* map, const void* base, int dtype, int B, int T_len,
             int D) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int elem = dtype == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (static_cast<long long>(D) * elem % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(D) * elem,
      static_cast<cuuint64_t>(T_len) * static_cast<cuuint64_t>(D) * elem};
  const cuuint32_t box[3] = {kGroup, kTileSteps, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the ring, the TMA route's two staging tiles of every output, and the
// ring's alignment slack
int smem_bytes(bool bwd, int dtype, int route, int stages) {
  const int elem = dtype == 0 ? 4 : 2;
  const int ops = bwd ? 3 : 2;
  const int tile = kTileSteps * kGroup;
  if (route != kTmaRoute) return stages * ops * tile * 4 + 128;
  return (stages * ops + 2 * (ops - 1)) * tile * elem + 128;
}

template <typename T, bool kBwd, int kRoute>
int launch(const Args<T>& p, int B, int dtype, cudaStream_t stream) {
  constexpr int ops = kBwd ? 3 : 2;
  CUtensorMap maps[5] = {};
  if (kRoute == kTmaRoute) {
    for (int o = 0; o < 2 * ops - 1; ++o) {
      const void* base = o < ops ? static_cast<const void*>(p.in[o])
                                 : static_cast<const void*>(p.out[o - ops]);
      const int err = make_map(&maps[o], base, dtype, B, p.T_len, p.D);
      if (err != 0) return err;
    }
  }
  const int smem = smem_bytes(kBwd, dtype, kRoute, p.stages);
  const dim3 grid((p.D + kGroup - 1) / kGroup, B);
  cudaError_t e;
  if constexpr (kBwd) {
    e = cudaFuncSetAttribute(rglru_scan_bwd_kernel<T, kRoute>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    rglru_scan_bwd_kernel<T, kRoute><<<grid, kGroup, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], p);
  } else {
    e = cudaFuncSetAttribute(rglru_scan_kernel<T, kRoute>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    rglru_scan_kernel<T, kRoute><<<grid, kGroup, smem, stream>>>(
        maps[0], maps[1], maps[2], p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd>
int dispatch(const Args<T>& p, int B, int dtype, int route, cudaStream_t s) {
  if (route == kTmaRoute) return launch<T, kBwd, kTmaRoute>(p, B, dtype, s);
  if (route == kCpAsyncRoute)
    return launch<T, kBwd, kCpAsyncRoute>(p, B, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBwd>
int launch_any(const void* const* in, void* const* out, int B, int T_len,
               int D, int dtype, int route, int stages, cudaStream_t s) {
  if (B <= 0 || T_len <= 0 || D <= 0) return 0;
  if (B > 65535 || stages < kMinStages || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int ops = kBwd ? 3 : 2;
  if (dtype == 0) {
    Args<float> p{{}, {}, T_len, D, stages};
    for (int o = 0; o < ops; ++o) p.in[o] = static_cast<const float*>(in[o]);
    for (int o = 0; o < ops - 1; ++o) p.out[o] = static_cast<float*>(out[o]);
    return dispatch<float, kBwd>(p, B, dtype, route, s);
  }
  if (dtype == 1) {
    Args<__nv_bfloat16> p{{}, {}, T_len, D, stages};
    for (int o = 0; o < ops; ++o)
      p.in[o] = static_cast<const __nv_bfloat16*>(in[o]);
    for (int o = 0; o < ops - 1; ++o)
      p.out[o] = static_cast<__nv_bfloat16*>(out[o]);
    return dispatch<__nv_bfloat16, kBwd>(p, B, dtype, route, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches the scan on `stream`: a, u in, h out, all (B, T, D) of one
// dtype (0 = float32, 1 = bfloat16). route 0 fills the ring by TMA (D *
// element size a multiple of 16 bytes, a and u 16-byte aligned), 1 by
// cp.async (any D; bfloat16 operands 2-byte aligned); stages 2-8.
// Returns the CUDA error code of the launch (0 when it was accepted). An
// empty operand launches nothing.
int rglru_scan_launch(const void* a, const void* u, void* h, int B,
                      int T_len, int D, int dtype, int route, int stages,
                      void* stream) {
  const void* in[2] = {a, u};
  void* out[1] = {h};
  return launch_any<false>(in, out, B, T_len, D, dtype, route, stages,
                           static_cast<cudaStream_t>(stream));
}

// Launches the adjoint on `stream`: a, h (the forward's output) and dh
// in, da and du out, all (B, T, D) of one dtype; route and stages as
// for the scan (TMA needs a, h and dh 16-byte aligned). Returns the CUDA
// error code of the launch; an empty operand launches nothing.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                          void* da, void* du, int B, int T_len, int D,
                          int dtype, int route, int stages, void* stream) {
  const void* in[3] = {a, h, dh};
  void* out[2] = {da, du};
  return launch_any<true>(in, out, B, T_len, D, dtype, route, stages,
                          static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of one block (the ring).
int rglru_smem_bytes(int bwd, int dtype, int route, int stages) {
  return smem_bytes(bwd != 0, dtype, route, stages);
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
