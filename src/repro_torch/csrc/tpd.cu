// Batched TPD (paper eqs. 6-7) over a placement swarm, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tpd.py:_tpd_kernel, reached by
// batch_tpd_pallas (pl.pallas_call at repro/kernels/tpd.py:133). It
// computes the same function, and on the card it also computes the
// trainer leaf loads that the TPU kernel takes as an operand. The plain
// torch versions beside it are repro_torch/kernels/tpd.py:leaf_loads and
// repro_torch/kernels/ref.py:tpd_ref.
//
// What it computes, per particle p and aggregator slot s, with the leaf
// level the slot range [leaf_start, D) and L = D - leaf_start leaves:
//   load  = mds[host] + (s >= leaf_start ? leaf_load[p, s - leaf_start]
//                        : sum over kids[s, w] >= 0 of mds[p[kids[s, w]]])
//   delay = load / pspeed[host]  (x (1 + penalty * over / max(cap, 1e-9)))
//   out[p] = sum over levels, deepest first, of max_{s in level} delay
// and, on the routes that build the leaf loads: every client id that
// row p does not place, ranked in ascending id order, is a trainer of
// leaf rank % L, and leaf_load[p, j] is the float64 sum of its trainers'
// mds in ascending id order, rounded to float32. That is the order in
// which the reference's np.bincount adds them, so the two agree bit for
// bit whatever the payloads.
//
// Operands: placements (P, D) int32, attrs (3, C) f32 = [mdatasize,
// pspeed, memcap], kids (D, W) int32 with -1 where a slot has fewer than
// W child slots, the depth + 1 level starts (passed by value), and, on
// the route that takes them, leaf_load (P, L) f32.
//
// Routes (template argument, chosen by kernels/tpd.py:launch_plan):
//   kGiven   leaf_load is an operand (the TPU kernel's operand set);
//   kShared  the kernel builds the leaf loads in shared memory: a copy of
//            mdatasize (4 C bytes), and the leaf stage's work area: the
//            leaf row, the bitmap of placed ids, the rank of each bitmap
//            word and the ranked payloads of the unplaced clients, 4 (L +
//            2 ceil(C / 32) + C) bytes, beside the placement row;
//   kScratch the work area in a (P, scratch_words) scratch tensor that
//            the wrapper allocates, mdatasize read where it lies, for a C
//            whose copy and work area do not fit a block's shared memory.
//
// Bound. The function reads each placement row and the kid rows of the
// internal slots once, writes P floats, and reads pspeed (and memcap
// when penalty > 0) at the ids the swarm places; given the leaf loads it
// reads them (4 P L bytes) and mdatasize at the placed ids, building
// them it reads mdatasize whole (4 C bytes) instead. A few flops a slot
// and one float64 add a client: bound by bytes over 3.35 TB/s, at
// large-10k well under a microsecond at P = 10. What sets the pace is
// the block: a particle's whole evaluation is one block's instruction
// stream on one SM (bring-up probes put its start-up, its compaction and
// its slot stage each at thousands of cycles), behind a launch of about
// 2 us. The design answers with one launch that does the whole
// evaluation, leaf loads included, nothing in device memory between its
// stages (on the kShared route), few instructions a client and a slot,
// and block sizes from the swarm's size (kernels/tpd.py:launch_plan).
//
// Design. One block per particle, up to 1024 threads.
//  1. The placement row goes to shared memory; each placed id sets its
//     bit of a C-bit bitmap (an integer atomicOr; duplicate ids set the
//     same bit; the bits past C start set, so a word's free ids are its
//     zero bits). On kShared mdatasize is copied to shared memory in the
//     same breath (16-byte loads, issued with the row's), so that every
//     later gather of a payload is a shared-memory read.
//  2. Each thread takes a run of consecutive bitmap words and counts the
//     free (unplaced) ids in them; a block-wide exclusive scan (warp
//     scans, then one value per warp) gives each word the rank of its
//     first free id.
//  3. Compaction: a warp takes a word at a time, a lane a bit; each free
//     id's payload lands at its word's rank plus the free bits below it.
//  4. Leaf j adds the payloads at ranks j, j + L, j + 2L, ... in float64,
//     in that (ascending id) order, and rounds to float32.
//  5. Slots, one a thread, two slots' loads in flight at once, all W kid
//     ids of a slot loaded before the float32 child sum over kids 0..W-1
//     (the plain version's order). Each warp reduces the maxima of its
//     slots for every level it covers at once (__reduce_max_sync on
//     order-preserving unsigned keys) and folds them into one key a
//     level in shared memory with an integer atomicMax: a max is exact,
//     so the order of the folds does not matter.
//  6. After one barrier, warp 0 reads the level maxima, lane by level,
//     and adds them deepest level first.
// Built with -fmad=false and without fast math, every add, multiply and
// divide rounds as the plain torch versions' do, so the outputs agree
// bit for bit; no atomic touches a float, so reruns are bit-equal.
//
// Tried and dropped: a cluster of 2, 4 or 8 blocks a particle, splitting
// the bitmap words and the slots, with the blocks' rank totals, payloads
// and level maxima exchanged over distributed shared memory. It was not
// faster at P = 10 (four cluster barriers and the work every block
// repeats, the placement row, the bitmap and the copy of mdatasize, ate
// the split) and much slower once the swarm fills the card.
//
// What stays behind from the TPU kernel: the host-side leaf loads, the
// one-hot (depth, D) masked max and its -3.4e38 sentinel (a level here
// is a slot range), the padding of the swarm with copies of row 0 (the
// grid is exactly P blocks), and the 8/64-particle tiles.
//
// A placement id outside [0, C) is not read: the particle's output is
// NaN instead.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDepth = 32;
constexpr int kMaxThreads = 1024;
constexpr int kKidsInFlight = 8;    // kid ids a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

enum Route { kGiven = 0, kShared = 1, kScratch = 2 };

struct LevelStarts {
  int at[kMaxDepth + 1];  // level l is the slot range [at[l], at[l + 1])
};

// float -> unsigned with the same order (negative floats below positive
// ones, a positive NaN above +inf), and back
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// 4-byte words of the leaf stage's work area: the leaf row, the bitmap,
// the word ranks and the ranked payloads
__host__ __device__ __forceinline__ long long work_words(int C, int L) {
  return L + 2LL * ((C + 31) / 32) + C;
}

// copies mds[0, C) to shared memory: 16-byte loads where the source is
// 16-byte aligned, four of them in flight a thread, then the tail
__device__ __forceinline__ void stage(const float* __restrict__ mds,
                                      float* dst, int C, int tid,
                                      int nthreads) {
  const int nvec = (reinterpret_cast<size_t>(mds) & 15) == 0 ? C / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(mds);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int i = tid; i < nvec; i += 4 * nthreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = i + u * nthreads;
      v[u] = k < nvec ? __ldg(&src4[k]) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u * nthreads < nvec) dst4[i + u * nthreads] = v[u];
    }
  }
  for (int i = 4 * nvec + tid; i < C; i += nthreads) dst[i] = __ldg(&mds[i]);
}

// sum over w of mds[row[kids[w]]] (0 for a -1 kid), left to right
__device__ __forceinline__ float kid_sum(const int* __restrict__ ks, int W,
                                         const int* row, const float* mds) {
  float child = 0.0f;
  for (int w0 = 0; w0 < W; w0 += kKidsInFlight) {
    int k[kKidsInFlight];
    float v[kKidsInFlight];
#pragma unroll
    for (int u = 0; u < kKidsInFlight; ++u) {
      k[u] = w0 + u < W ? __ldg(&ks[w0 + u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kKidsInFlight; ++u) {
      v[u] = k[u] >= 0 ? mds[row[k[u]]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kKidsInFlight; ++u) {
      if (w0 + u < W) child = w0 + u == 0 ? v[u] : child + v[u];
    }
  }
  return child;
}

template <int kRoute>
__global__ void __launch_bounds__(kMaxThreads, 1)
tpd_kernel(const int* __restrict__ placements,     // (P, D)
           const float* __restrict__ attrs,        // (3, C)
           const float* __restrict__ leaf_load,    // (P, L), kGiven only
           const int* __restrict__ kids,           // (D, W), -1 padded
           float* __restrict__ scratch,            // kScratch only
           float* __restrict__ leaf_out,           // (P, L) or null
           float* __restrict__ out,                // (P,)
           const LevelStarts levels, int D, int C, int W, int depth,
           int leaf_start, float penalty) {
  constexpr bool kBuild = kRoute != kGiven;
  constexpr bool kStaged = kRoute == kShared;
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned level_key[kMaxDepth];   // this block's level maxima
  __shared__ int starts[kMaxDepth + 1];
  __shared__ int warp_total[kMaxThreads / 32];
  __shared__ int bad_id;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;   // a multiple of 32
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* pspeed = attrs + C;
  const float* memcap = attrs + 2 * static_cast<size_t>(C);
  const int L = D - leaf_start;
  const int NW = (C + 31) >> 5;

  // on kShared a copy of mdatasize (16-byte aligned), read from here on
  float* staged = reinterpret_cast<float*>(smem);               // (C,)
  const float* mds = kStaged ? staged : attrs;
  int* row = smem + (kStaged ? C : 0);                          // (D,)
  // the work area of the leaf stage: shared memory, or this particle's
  // row of the scratch tensor
  float* leaf = kRoute == kScratch
      ? scratch + static_cast<size_t>(p) * work_words(C, L)
      : reinterpret_cast<float*>(row + D);                      // (L,)
  unsigned* placed = reinterpret_cast<unsigned*>(leaf + L);     // (NW,)
  int* word_rank = reinterpret_cast<int*>(placed + NW);         // (NW,)
  float* pay = reinterpret_cast<float*>(word_rank + NW);        // (C,)

  // the loads that start the chain: this thread's first two placement
  // ids, and on kShared all of mdatasize, before anything waits
  const int* prow = placements + static_cast<size_t>(p) * D;
  const int id0 = tid < D ? __ldg(&prow[tid]) : 0;
  const int id1 = tid + nthreads < D ? __ldg(&prow[tid + nthreads]) : 0;
  if (kStaged) stage(attrs, staged, C, tid, nthreads);
  if (tid == 0) bad_id = 0;
  if (warp == 0) {
#pragma unroll
    for (int l = 0; l <= kMaxDepth; ++l) {
      if (lane == (l & 31) && l <= depth) starts[l] = levels.at[l];
    }
  }
  if (tid < kMaxDepth) level_key[tid] = 0u;
  if (kBuild) {
    // the bits past C count as placed, so a word's free ids are ~word
    for (int w = tid; w < NW; w += nthreads) {
      placed[w] = w == NW - 1 && (C & 31) ? ~((1u << (C & 31)) - 1u) : 0u;
    }
  }
  __syncthreads();

  // 1. the placement row, and the bitmap of placed ids
  auto place = [&](int s, int id) {
    if (id < 0 || id >= C) {
      bad_id = 1;
      id = 0;
    } else if (kBuild) {
      atomicOr(&placed[id >> 5], 1u << (id & 31));
    }
    row[s] = id;
  };
  if (tid < D) place(tid, id0);
  if (tid + nthreads < D) place(tid + nthreads, id1);
  for (int s = tid + 2 * nthreads; s < D; s += nthreads) {
    place(s, __ldg(&prow[s]));
  }
  __syncthreads();
  if (bad_id) {
    if (tid == 0) out[p] = __int_as_float(0x7fc00000);
    return;
  }

  if (kBuild) {
    // 2. each word's rank: the free ids before it, by a block-wide scan
    const int per = (NW + nthreads - 1) / nthreads;
    const int w0 = min(tid * per, NW);
    const int w1 = min(w0 + per, NW);
    int count = 0;
    for (int w = w0; w < w1; ++w) count += __popc(~placed[w]);
    int incl = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nwarps ? warp_total[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, t, off);
        if (lane >= off) t += v;
      }
      if (lane < nwarps) warp_total[lane] = t;
    }
    __syncthreads();
    int rank = (warp > 0 ? warp_total[warp - 1] : 0) + incl - count;
    const int unplaced = warp_total[nwarps - 1];
    for (int w = w0; w < w1; ++w) {
      word_rank[w] = rank;
      rank += __popc(~placed[w]);
    }
    __syncthreads();

    // 3. compaction: a warp a word, a lane a bit; each free id's payload
    // at its rank
    const unsigned below = (1u << lane) - 1u;
    for (int w = warp; w < NW; w += nwarps) {
      const unsigned free = ~placed[w];
      if ((free >> lane) & 1u) {
        pay[word_rank[w] + __popc(free & below)] = mds[32 * w + lane];
      }
    }
    __syncthreads();

    // 4. leaf j: ranks j, j + L, ... in float64, ascending, then f32
    for (int j = tid; j < L; j += nthreads) {
      double acc = 0.0;
      for (int r = j; r < unplaced; r += L) {
        acc = acc + static_cast<double>(pay[r]);
      }
      const float load = __double2float_rn(acc);
      leaf[j] = load;
      if (leaf_out != nullptr) leaf_out[static_cast<size_t>(p) * L + j] = load;
    }
    __syncthreads();
  }

  // 5. a slot a thread, two slots' loads in flight at once; the level
  // maxima into level_key
  const float* lrow = leaf_load + static_cast<size_t>(p) * L;
  auto slot_key = [&](int s) -> unsigned {
    if (s >= D) return 0u;
    const int host = row[s];
    float child;
    if (s >= leaf_start) {
      child = kBuild ? leaf[s - leaf_start] : __ldg(&lrow[s - leaf_start]);
    } else {
      child = kid_sum(kids + static_cast<size_t>(s) * W, W, row, mds);
    }
    const float load = mds[host] + child;
    float d = load / __ldg(&pspeed[host]);
    if (penalty > 0.0f) {
      const float cap = __ldg(&memcap[host]);
      const float over = fmaxf(0.0f, load - cap);
      d = d * (1.0f + penalty * over / fmaxf(cap, 1e-9f));
    }
    return order_key(d);
  };
  // the warp's slots are consecutive: its levels run from lane 0's to the
  // deepest of its lanes' (a lane past D takes no part); a max is exact,
  // so the order of the integer atomics does not matter
  auto reduce_levels = [&](int s, unsigned key) {
    int lv = -1;
    if (s < D) {
      lv = 0;
      while (s >= starts[lv + 1]) ++lv;
    }
    const int lo = __shfl_sync(kFull, lv, 0);
    const int hi = __reduce_max_sync(kFull, lv);
    for (int l = max(lo, 0); l <= hi; ++l) {
      const unsigned m = __reduce_max_sync(kFull, lv == l ? key : 0u);
      if (lane == 0) atomicMax(&level_key[l], m);
    }
  };
  for (int base = 0; base < D; base += 2 * nthreads) {
    const int s0 = base + tid;
    const int s1 = s0 + nthreads;
    const unsigned k0 = slot_key(s0);
    const unsigned k1 = slot_key(s1);
    reduce_levels(s0, k0);
    reduce_levels(s1, k1);
  }
  __syncthreads();

  // 6. the level maxima, lane by level; their sum, deepest level first
  if (warp == 0) {
    const float level_max = key_value(lane < depth ? level_key[lane] : 0u);
    float total = 0.0f;
    for (int l = depth - 1; l >= 0; --l) {
      total = total + __shfl_sync(kFull, level_max, l);
    }
    if (lane == 0) out[p] = total;
  }
}

template <int kRoute>
int launch(const void* placements, const void* attrs, const void* leaf_load,
           const void* kids, void* scratch, void* leaf_out, void* out,
           const LevelStarts& levels, int P, int D, int C, int W, int depth,
           int threads, size_t smem, float penalty, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tpd_kernel<kRoute>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tpd_kernel<kRoute><<<P, threads, smem, stream>>>(
      static_cast<const int*>(placements), static_cast<const float*>(attrs),
      static_cast<const float*>(leaf_load), static_cast<const int*>(kids),
      static_cast<float*>(scratch), static_cast<float*>(leaf_out),
      static_cast<float*>(out), levels, D, C, W, depth,
      levels.at[depth - 1], penalty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block on `route` (0 kGiven, 1 kShared,
// 2 kScratch), in bytes: the placement row, and on kShared a copy of
// mdatasize and the leaf stage's work area.
long long tpd_smem_bytes(int D, int C, int L, int route) {
  return 4 * (D + (route == kShared ? C + work_words(C, L) : 0));
}

// 4-byte words of one particle's row of the kScratch route's scratch.
long long tpd_scratch_words(int C, int L) { return work_words(C, L); }

// The kernel's static shared memory, in bytes.
int tpd_static_smem_bytes() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, tpd_kernel<kShared>) != cudaSuccess) {
    return -1;
  }
  return static_cast<int>(a.sharedSizeBytes);
}

// Launches the kernel on `stream` for P particles, `threads` a block;
// `level_starts` is a host array of depth + 1 ints, copied into the
// launch's arguments. `leaf_load` is read on route 0 only, `scratch`
// (P * tpd_scratch_words floats) used on route 2 only; on routes 1 and 2
// a non-null `leaf_out` (P, L) receives the leaf loads the launch built.
// Returns the CUDA error code of the launch (0 when it was accepted).
int tpd_launch(const void* placements, const void* attrs,
               const void* leaf_load, const void* kids, void* scratch,
               void* leaf_out, void* out, const int* level_starts, int P,
               int D, int C, int W, int depth, int threads, int route,
               float penalty, void* stream) {
  if (P <= 0) return 0;
  if (D <= 0 || C < 0 || W <= 0 || depth <= 0 || depth > kMaxDepth ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      route < kGiven || route > kScratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelStarts levels = {};
  for (int l = 0; l <= depth; ++l) levels.at[l] = level_starts[l];
  if (D - levels.at[depth - 1] <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = D - levels.at[depth - 1];
  const size_t smem = static_cast<size_t>(tpd_smem_bytes(D, C, L, route));
  decltype(&launch<kGiven>) run = route == kGiven ? launch<kGiven>
      : route == kShared ? launch<kShared> : launch<kScratch>;
  return run(placements, attrs, leaf_load, kids, scratch, leaf_out, out,
             levels, P, D, C, W, depth, threads, smem, penalty,
             static_cast<cudaStream_t>(stream));
}

const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
