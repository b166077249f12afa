// Backward of the blocked GQA attention in flash_attention.cu, for Hopper
// (sm_90a): the float32 route, on the tensor cores in split TF32
// (csrc/flash_tf32.cuh). Float32 operands take it, and bfloat16 ones at
// hd > 256, which the wrapper reads as float32; bfloat16 at hd <= 256
// goes to the wgmma backward in flash_attention_bwd_sm90.cu.
//
// No TPU counterpart: the reference differentiates plain jnp and has no
// backward kernel. It is the gradient of the port of
// repro/kernels/flash_attention.py:39 _flash_kernel; the plain torch
// version beside it is repro_torch/kernels/ref.py:flash_attention_bwd_ref.
//
// What it computes. The forward's operands q (B, Hq, S, hd), k and v
// (B, Hkv, S, hd), its output o and float32 log-sum-exp lse (B, Hq, S),
// and the output's gradient do (like q) give dq (like q) and dk, dv
// (like k), under the forward's causal, window and kv_len masks; hd a
// multiple of 8 (the wrapper zero-pads any other). For a visible pair
// (query row i of head h, key j of kv head h / (Hq / Hkv)):
//   P_ij = exp(scale q_i.k_j - lse_i),  D_i = sum_c do_ic o_ic,
//   dS_ij = P_ij (do_i.v_j - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_(h, i) dS_ij q_i,
//   dv_j = sum_(h, i) P_ij do_i,
// where dk_j and dv_j sum over every query head of the kv head's group.
// float32 operands and accumulation; every product in split TF32.
//
// Bound. 10 * hd flops per visible (query head, key) pair: q.k, do.v,
// dq, dk, dv at 2 hd each; the passes below recompute q.k and do.v, so
// 14 hd are done. Split TF32 gives 165 TFLOP/s of float32-accurate
// products (a third of the card's 495 TFLOP/s dense TF32).
// recurrentgemma-2b's training shape (B 1, Hq 10, Hkv 1, hd 256, S 2048
// causal) needs 5.371e10 flops against 55 MB of operands: 0.326 ms at
// 165 TFLOP/s (0.8017 ms at the 67 TFLOP/s of scalar float32 FMAs), not
// device memory (0.017 ms).
//
// Design. Three launches, deterministic: every output element is summed
// in a fixed order, with no float atomics, so a run repeats bit for bit.
//  1. dq pass: one block of 8 warps per (query head x column block, batch
//     row, 64 query rows), the q tiles launched last to first so the
//     blocks that see the most keys start first. It first forms D for its
//     rows from do and o and writes it out for pass 2. Warps 0-3 (S
//     warps) and 4-7 (dP warps) share 16 rows each: per 32-key tile, score
//     units (64 head-dim columns of K and V) give S = Q K^T in an S warp
//     and dP = dO V^T in a dP warp, in split-TF32 mma.sync, with Q and dO
//     resident at hd <= 256 (streamed with each unit above). The S warp
//     forms P = exp(scale S - lse) and hands it to its partner through
//     shared memory, which forms dS = P (dP - D) and hands it back (two
//     named barriers a pair order the exchange); dq units (64 output
//     columns of K, read N-major) add dS K, the first 32 columns of each
//     in the dP warp and the other 32 in the S warp, so both work on
//     every unit and each holds half of dq's columns (64 registers a
//     thread at hd 256).
//  2. dk/dv pass: one block of 8 warps per (part of the group x column
//     block, batch row x kv head, 64 keys), the key blocks launched first
//     to last (the first keys are seen by the most rows). Warps 0-3 own dV
//     and warps 4-7 dK, 16 keys each, so each accumulator (16 x 256
//     floats, 128 registers a thread) has a warp of its own. The block
//     walks the 32-row query tiles that can see its keys, for each query
//     head of its part of the group. Per tile, score units (64 columns of
//     q and do, with the tile's lse and D) give: in a dV warp S^T = K Q^T
//     and P^T, which it also hands to its dK partner through 8 KB of
//     shared memory (thread to thread: both accumulators share one
//     layout); in a dK warp dP^T = V dO^T, and then dS^T = P^T (dP^T - D).
//     Value units (64 output columns of q and do, N-major) add P^T dO to
//     dV and dS^T Q to dK. K and V are resident at hd <= 256. A group of
//     10 query heads on one kv head (recurrentgemma) gives few key blocks
//     at B 1, so the wrapper splits the group's heads over `split` blocks
//     (kernels/flash_attention.py:f32_geometry: the fewest waves of work,
//     10 at the training shape); each block writes float32 partial dk and
//     dv for its heads.
//  3. sum: adds the partials of each element in split order and scales
//     dk.
// Units stream through a 2-slot cp.async ring, their B operands split in
// place by the threads that copied them (csrc/flash_tf32.cuh); the
// exchanges are ordered by the ring's one __syncthreads a unit. Shared
// memory at hd = 256: pass 1 holds q and do (2 x 64 x 264 floats), lse
// and D, the two 8 KB exchanges and 2 units of 4 x 32 x 72 floats,
// 225,792 bytes; pass 2 holds K and V (2 x 64 x 264), the 8 KB exchange
// and 2 units of 4 x 32 x 72 + 64 floats, 217,600 bytes. Both stay under
// the 227 KB a block may have.

#include "flash_tf32.cuh"

namespace {

using namespace tf32;

constexpr int kStages = 2;
constexpr int kExchange = 4 * 16 * 32;     // 16 floats x 32 lanes x 4 warps
// pass 1 (dq)
constexpr int kDqThreads = 256;            // 4 S warps + 4 dP warps
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 32;                    // keys per tile
// pass 2 (dk, dv)
constexpr int kDkvThreads = 256;           // 4 dV warps + 4 dK warps
constexpr int kBKV = 64;                   // keys per block
constexpr int kBQ2 = 32;                   // query rows per tile
constexpr int kSumThreads = 256;

__host__ __device__ inline int max2(int a, int b) { return a > b ? a : b; }

// a dq score unit: K's and V's two planes (and Q, dO when not
// resident); a dq unit: K's two planes
__host__ __device__ inline int dq_unit_floats(bool resident) {
  return max2(4 * kBK * kKStride + (resident ? 0 : 2 * kBQ * kKStride),
              2 * kBK * kNStride);
}

__host__ __device__ inline int dq_smem_floats(int hd, bool resident) {
  return (resident ? 2 * kBQ * resident_stride(hd) : 0) + 2 * kBQ +
         2 * kExchange + kStages * dq_unit_floats(resident);
}

// a dk/dv score unit: q's and do's two planes, lse, D (and K, V when
// not resident); a value unit: q's and do's two planes
__host__ __device__ inline int dkdv_unit_floats(bool resident) {
  return max2(4 * kBQ2 * kKStride + 2 * kBQ2 +
                  (resident ? 0 : 2 * kBKV * kKStride),
              4 * kBQ2 * kNStride);
}

__host__ __device__ inline int dkdv_smem_floats(int hd, bool resident) {
  return (resident ? 2 * kBKV * resident_stride(hd) : 0) + kExchange +
         kStages * dkdv_unit_floats(resident);
}

// ---- pass 1: D and dq ----------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dsum, float* __restrict__ dq,
                         Params p) {
  constexpr int NJ = (NT + 7) / 8;         // dq units a key tile
  constexpr int NA = NJ * 4;               // n-tiles a warp holds: half a unit
  extern __shared__ __align__(16) float smem[];
  const int HD = p.hd, S = p.S;
  const bool resident = p.col_blocks == 1;
  const int rld = resident_stride(HD);
  float* sQ = smem;                                   // kBQ x rld
  float* sO = sQ + (resident ? kBQ * rld : 0);        // kBQ x rld: do
  float* sL = sO + (resident ? kBQ * rld : 0);        // kBQ lse
  float* sD = sL + kBQ;                               // kBQ D
  float* sP = sD + kBQ;                               // P exchange
  float* sS = sP + kExchange;                         // dS exchange
  float* ring = sS + kExchange;
  const int unit = dq_unit_floats(resident);

  // q tiles last to first, the longest blocks first (as the forward)
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x / p.col_blocks;
  const int c0 = (blockIdx.x % p.col_blocks) * p.cols;
  const int c_end = min(HD, c0 + p.cols);
  const int b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const long long row0 = (static_cast<long long>(b) * p.Hq + h) * S;
  const float* qg = q + row0 * HD;
  const float* og = dout + row0 * HD;
  const float* kg = k + (static_cast<long long>(b) * p.Hkv + hk) * S * HD;
  const float* vg = v + (static_cast<long long>(b) * p.Hkv + hk) * S * HD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool s_role = warp < 4;            // S warps; the others dP warps
  const int half = s_role ? 1 : 0;         // the half of each dq unit held
  const int r0 = (warp & 3) * 16;          // the pair's first row
  const int nkc = (HD + kChunk - 1) / kChunk;
  const int per_tile = nkc + NJ;

  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = min(S, p.kv_len);
  if (p.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const int n_units = max(0, t_end - t_begin) * per_tile;

  // the next unit to issue: key tile, and its place in the tile (score
  // chunks, then dq chunks)
  int next = 0, next_tile = t_begin, next_r = 0;
  const int r_t = tid >> 4, c_t = (tid & 15) * 4;
  auto issue = [&]() {
    float* dst = ring + (next % kStages) * unit;
    const int k0 = next_tile * kBK;
    const long long kr = static_cast<long long>(k0) * HD;
    if (next_r < nkc) {
      const int col = next_r * kChunk;
      const bool col_ok = col + c_t < HD;
      copy_unit<kBK, kDqThreads>(dst, kKStride, kg + kr + col, HD, S - k0,
                                 col_ok, r_t, c_t, kg);
      copy_unit<kBK, kDqThreads>(dst + 2 * kBK * kKStride, kKStride,
                                 vg + kr + col, HD, S - k0, col_ok, r_t, c_t,
                                 vg);
      if (!resident) {
        const long long qr = static_cast<long long>(q0) * HD + col;
        float* dq_dst = dst + 4 * kBK * kKStride;
        copy_unit<kBQ, kDqThreads>(dq_dst, kKStride, qg + qr, HD, S - q0,
                                   col_ok, r_t, c_t, qg);
        copy_unit<kBQ, kDqThreads>(dq_dst + kBQ * kKStride, kKStride, og + qr,
                                   HD, S - q0, col_ok, r_t, c_t, og);
      }
    } else {
      const int col = c0 + (next_r - nkc) * kChunk;
      copy_unit<kBK, kDqThreads>(dst, kNStride, kg + kr + col, HD, S - k0,
                                 col + c_t < c_end, r_t, c_t, kg);
    }
    ++next;
    if (++next_r == per_tile) {
      next_r = 0;
      ++next_tile;
    }
  };
  // before unit u: this thread's pieces of it have landed and it splits
  // them (K and V, or K); after the barrier the whole unit is split, and
  // the slot of unit u - 1 takes unit u + 1
  auto step = [&](int u, bool value) {
    cp_async_wait<0>();
    float* cur = ring + (u % kStages) * unit;
    if (value) {
      split_unit<kBK, kDqThreads>(cur, kNStride, kBK * kNStride, r_t, c_t);
    } else {
      split_unit<kBK, kDqThreads>(cur, kKStride, kBK * kKStride, r_t, c_t);
      split_unit<kBK, kDqThreads>(cur + 2 * kBK * kKStride, kKStride,
                                  kBK * kKStride, r_t, c_t);
    }
    __syncthreads();
    if (next < n_units) issue();
    cp_async_commit();
  };

  if (resident) {
    const long long qr = static_cast<long long>(q0) * HD;
    copy_tile(sQ, rld, qg + qr, HD, kBQ, S - q0, (rld - 8) / 4, HD / 4, qg, tid,
              kDqThreads);
    copy_tile(sO, rld, og + qr, HD, kBQ, S - q0, (rld - 8) / 4, HD / 4, og, tid,
              kDqThreads);
  }
  if (n_units > 0) issue();
  cp_async_commit();

  // D_i = sum_c do_ic o_ic and lse_i, 8 rows a warp
  for (int i = 0; i < kBQ / 8; ++i) {
    const int r = warp * (kBQ / 8) + i;
    const int qi = q0 + r;
    float part = 0.0f;
    if (qi < S) {
      const float* orow = o + (row0 + qi) * HD;
      const float* drow = og + static_cast<long long>(qi) * HD;
      for (int c = lane; c < HD; c += 32)
        part = __fmaf_rn(drow[c], orow[c], part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      sD[r] = part;
      sL[r] = qi < S ? lse[row0 + qi] : 0.0f;
      if (qi < S && c0 == 0) dsum[row0 + qi] = part;
    }
  }
  __syncthreads();
  const float li[2] = {sL[r0 + g], sL[r0 + g + 8]};
  const float di[2] = {sD[r0 + g], sD[r0 + g + 8]};
  const float* A_res = s_role ? sQ : sO;
  const int a_off = s_role ? 0 : kBQ * kKStride;      // in a streamed unit
  const int b_off = s_role ? 0 : 2 * kBK * kKStride;  // K or V in a unit
  const int x_off = (warp & 3) * 16 * 32 + lane;      // [n * 4 + e] * 32

  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  int u = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kBK;
    // S warps: S = Q K^T; dP warps: dP = dO V^T (16 rows x 32 keys)
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    for (int c = 0; c < nkc; ++c, ++u) {
      step(u, false);
      const float* unit_p = ring + (u % kStages) * unit;
      const float* Bc = unit_p + b_off;
      const float* Ac =
          resident ? A_res + r0 * rld + c * kChunk
                   : unit_p + 4 * kBK * kKStride + a_off + r0 * kKStride;
      const int ald = resident ? rld : kKStride;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const FragA a = load_a(Ac, ald, ks * 8, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(s[n], a, load_b_kmajor(Bc, kBK * kKStride, kKStride, n * 8,
                                      ks * 8, lane));
      }
    }
    // S warps: P, handed to the dP warp of the pair; dP warps: dS = P
    // (dP - D), handed back. Two named barriers a pair order the exchange,
    // so both warps hold dS before the first dq unit.
    const int pair = warp & 3;
    if (s_role) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + r0 + g + 8 * (e >> 1);
          const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
          s[n][e] = visible(p, qi, kj)
                        ? expf(s[n][e] * p.scale - li[e >> 1]) : 0.0f;
          sP[x_off + (n * 4 + e) * 32] = s[n][e];
        }
      named_arrive(1 + pair, 64);
      named_sync(5 + pair, 64);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sS[x_off + (n * 4 + e) * 32];
    } else {
      named_sync(1 + pair, 64);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = sP[x_off + (n * 4 + e) * 32] * (s[n][e] - di[e >> 1]);
          sS[x_off + (n * 4 + e) * 32] = s[n][e];
        }
      named_arrive(5 + pair, 64);
    }
    FragA da[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) da[n] = frag_of_acc(s[n]);

    // dq += dS K, 64 output columns a unit: the dP warp of a pair takes
    // the unit's first 32 columns, the S warp the other 32
#pragma unroll
    for (int j = 0; j < NJ; ++j, ++u) {
      step(u, true);
      const float* Kc = ring + (u % kStages) * unit;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          if (j * 8 + half * 4 + nn < NT)
            mma3(acc[j * 4 + nn], da[n],
                 load_b_nmajor(Kc, kBK * kNStride, kNStride, n * 8,
                               (half * 4 + nn) * 8, lane));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= S) continue;
    float* row = dq + (row0 + qi) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int nt = j * 8 + half * 4 + nn;
        const int col = c0 + nt * 8 + 2 * t4;
        if (nt < NT && col < c_end)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(acc[j * 4 + nn][2 * i] * p.scale,
                          acc[j * 4 + nn][2 * i + 1] * p.scale);
      }
  }
}

// ---- pass 2: partial dk and dv ---------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int B, Params p) {
  constexpr int NJ = (NT + 7) / 8;
  extern __shared__ __align__(16) float smem[];
  const int HD = p.hd, S = p.S;
  const bool resident = p.col_blocks == 1;
  const int rld = resident_stride(HD);
  float* sK = smem;                                   // kBKV x rld
  float* sV = sK + (resident ? kBKV * rld : 0);       // kBKV x rld
  float* sX = sV + (resident ? kBKV * rld : 0);       // P^T exchange
  float* ring = sX + kExchange;
  const int unit = dkdv_unit_floats(resident);
  constexpr int kLse = 4 * kBQ2 * kKStride;           // lse, D in a unit
  constexpr int kKV = kLse + 2 * kBQ2;                // K, V in a unit

  // key blocks first to last (the slowest grid axis): under the causal
  // mask the first keys are seen by the most rows, so the longest blocks
  // start first
  const int k0 = blockIdx.z * kBKV;
  const int part = blockIdx.x / p.col_blocks;
  const int c0 = (blockIdx.x % p.col_blocks) * p.cols;
  const int c_end = min(HD, c0 + p.cols);
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int heads = group / p.split;
  const int h_first = hk * group + part * heads;
  const long long kv_off = (static_cast<long long>(b) * p.Hkv + hk) * S * HD;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool dv_role = warp < 4;
  const int kw = (warp & 3) * 16;          // this warp's first key
  const int nkc = (HD + kChunk - 1) / kChunk;
  const int per_tile = nkc + NJ;

  // the query rows that can see this block's keys: [i_begin, i_end)
  const int k_last = min(k0 + kBKV, S) - 1;
  const int i_begin = p.causal ? k0 : 0;
  int i_end = p.window > 0 ? min(S, k_last + p.window) : S;
  if (k0 >= min(S, p.kv_len)) i_end = i_begin;     // every key masked
  const int tq_begin = i_begin / kBQ2;
  const int ntq = i_end > i_begin ? (i_end + kBQ2 - 1) / kBQ2 - tq_begin : 0;
  const int n_units = heads * ntq * per_tile;

  // the next unit to issue: (query head, query tile), and its place in
  // the tile (score chunks, then value chunks)
  int next = 0, next_tile = 0, next_r = 0;
  const int r_t = tid >> 4, c_t = (tid & 15) * 4;
  auto issue = [&]() {
    float* dst = ring + (next % kStages) * unit;
    const int hq = h_first + next_tile / ntq;
    const int i0 = (tq_begin + next_tile % ntq) * kBQ2;
    const long long row0 = (static_cast<long long>(b) * p.Hq + hq) * S;
    const float* qt = q + (row0 + i0) * HD;
    const float* ot = dout + (row0 + i0) * HD;
    if (next_r < nkc) {
      const int col = next_r * kChunk;
      const bool col_ok = col + c_t < HD;
      copy_unit<kBQ2, kDkvThreads>(dst, kKStride, qt + col, HD, S - i0,
                                   col_ok, r_t, c_t, q);
      copy_unit<kBQ2, kDkvThreads>(dst + 2 * kBQ2 * kKStride, kKStride,
                                   ot + col, HD, S - i0, col_ok, r_t, c_t,
                                   dout);
      if (next_r == nkc - 1 && tid < 2 * kBQ2) {
        const int i = tid & (kBQ2 - 1);
        const bool ok = i0 + i < S;
        const float* src = tid < kBQ2 ? lse : dsum;
        cp_async4(dst + kLse + tid, ok ? src + row0 + i0 + i : src, ok);
      }
      if (!resident) {
        const long long kr = static_cast<long long>(k0) * HD + col;
        copy_unit<kBKV, kDkvThreads>(dst + kKV, kKStride, kg + kr, HD, S - k0,
                                     col_ok, r_t, c_t, kg);
        copy_unit<kBKV, kDkvThreads>(dst + kKV + kBKV * kKStride, kKStride,
                                     vg + kr, HD, S - k0, col_ok, r_t, c_t,
                                     vg);
      }
    } else {
      const int col = c0 + (next_r - nkc) * kChunk;
      const bool col_ok = col + c_t < c_end;
      copy_unit<kBQ2, kDkvThreads>(dst, kNStride, qt + col, HD, S - i0,
                                   col_ok, r_t, c_t, q);
      copy_unit<kBQ2, kDkvThreads>(dst + 2 * kBQ2 * kNStride, kNStride,
                                   ot + col, HD, S - i0, col_ok, r_t, c_t,
                                   dout);
    }
    ++next;
    if (++next_r == per_tile) {
      next_r = 0;
      ++next_tile;
    }
  };
  // before unit u: this thread's pieces of it have landed and it splits
  // them (q and do); after the barrier the whole unit is split, and the
  // slot of unit u - 1 takes unit u + 1
  auto step = [&](int u, bool value) {
    cp_async_wait<0>();
    float* cur = ring + (u % kStages) * unit;
    const int ld = value ? kNStride : kKStride;
    split_unit<kBQ2, kDkvThreads>(cur, ld, kBQ2 * ld, r_t, c_t);
    split_unit<kBQ2, kDkvThreads>(cur + 2 * kBQ2 * ld, ld, kBQ2 * ld, r_t,
                                  c_t);
    __syncthreads();
    if (next < n_units) issue();
    cp_async_commit();
  };

  if (resident) {
    const long long kr = static_cast<long long>(k0) * HD;
    copy_tile(sK, rld, kg + kr, HD, kBKV, S - k0, (rld - 8) / 4, HD / 4, kg, tid,
              kDkvThreads);
    copy_tile(sV, rld, vg + kr, HD, kBKV, S - k0, (rld - 8) / 4, HD / 4, vg, tid,
              kDkvThreads);
  }
  if (n_units > 0) issue();
  cp_async_commit();

  // dV (dV warps) or dK (dK warps) of the warp's 16 keys
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float* xch = sX + (warp & 3) * 16 * 32 + lane;      // [n * 4 + e] * 32

  int u = 0;
  for (int tile = 0; tile < heads * ntq; ++tile) {
    const int i0 = (tq_begin + tile % ntq) * kBQ2;
    // dV warps: S^T = K Q^T; dK warps: dP^T = V dO^T (16 keys x 32 rows)
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const float* unit_p = nullptr;
    for (int c = 0; c < nkc; ++c, ++u) {
      step(u, false);
      unit_p = ring + (u % kStages) * unit;
      const float* Bc = unit_p + (dv_role ? 0 : 2 * kBQ2 * kKStride);
      const float* Ac =
          resident ? (dv_role ? sK : sV) + kw * rld + c * kChunk
                   : unit_p + kKV + (dv_role ? 0 : kBKV * kKStride) +
                         kw * kKStride;
      const int ald = resident ? rld : kKStride;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const FragA a = load_a(Ac, ald, ks * 8, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(s[n], a, load_b_kmajor(Bc, kBQ2 * kKStride, kKStride, n * 8,
                                      ks * 8, lane));
      }
    }
    // rows of the accumulators are keys (g, g + 8), columns query rows
    const float* sL = unit_p + kLse;
    const float* sD = sL + kBQ2;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        if (dv_role) {
          const int kj = k0 + kw + g + 8 * (e >> 1);
          const float pr = visible(p, i0 + col, kj)
                               ? expf(s[n][e] * p.scale - sL[col]) : 0.0f;
          s[n][e] = pr;
          xch[(n * 4 + e) * 32] = pr;
        } else {
          s[n][e] -= sD[col];              // dP^T - D
        }
      }
    FragA fa[4];
    if (dv_role) {
#pragma unroll
      for (int n = 0; n < 4; ++n) fa[n] = frag_of_acc(s[n]);
    }

    // dV += P^T dO, dK += dS^T Q, 64 output columns a unit
#pragma unroll
    for (int j = 0; j < NJ; ++j, ++u) {
      step(u, true);
      if (j == 0 && !dv_role) {
        // P^T from the partner dV warp, written before this step's sync
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= xch[(n * 4 + e) * 32];
          fa[n] = frag_of_acc(s[n]);
        }
      }
      const float* Bv = ring + (u % kStages) * unit +
                        (dv_role ? 2 * kBQ2 * kNStride : 0);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          if (j * 8 + nn < NT)
            mma3(acc[j * 8 + nn], fa[n],
                 load_b_nmajor(Bv, kBQ2 * kNStride, kNStride, n * 8, nn * 8,
                               lane));
    }
  }
  cp_async_wait<0>();

  float* out = (dv_role ? dv_part : dk_part) +
               ((static_cast<long long>(part) * B + b) * p.Hkv + hk) * S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + kw + g + 8 * i;
    if (kj >= S) continue;
    float* row = out + static_cast<long long>(kj) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (col < c_end)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// ---- pass 3: the partials summed in split order ----------------------------
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_sum_tf32_kernel(const float4* __restrict__ dk_part,
                          const float4* __restrict__ dv_part,
                          float4* __restrict__ dk, float4* __restrict__ dv,
                          long long n4, int split, float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = dk_part[i], c = dv_part[i];
    for (int s = 1; s < split; ++s) {
      const float4 x = dk_part[s * n4 + i], y = dv_part[s * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dk[i] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    dv[i] = c;
  }
}

template <int NT>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dsum, float* dq,
           float* dk_part, float* dv_part, float* dk, float* dv, int B,
           const Params& p, cudaStream_t stream) {
  const bool resident = p.col_blocks == 1;
  const size_t smem1 = sizeof(float) * dq_smem_floats(p.hd, resident);
  const size_t smem2 = sizeof(float) * dkdv_smem_floats(p.hd, resident);
  cudaError_t err =
      set_smem(flash_bwd_dq_tf32_kernel<NT>, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem(flash_bwd_dkdv_tf32_kernel<NT>, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1(p.Hq * p.col_blocks, B, (p.S + kBQ - 1) / kBQ);
  flash_bwd_dq_tf32_kernel<NT><<<grid1, kDqThreads, smem1, stream>>>(
      q, k, v, o, dout, lse, dsum, dq, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(p.split * p.col_blocks, B * p.Hkv,
                   (p.S + kBKV - 1) / kBKV);
  flash_bwd_dkdv_tf32_kernel<NT><<<grid2, kDkvThreads, smem2, stream>>>(
      q, k, v, dout, lse, dsum, dk_part, dv_part, B, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(B) * p.Hkv * p.S * p.hd / 4;
  const long long blocks = (n4 + kSumThreads - 1) / kSumThreads;
  flash_bwd_sum_tf32_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                  : 4096),
                              kSumThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part),
      reinterpret_cast<const float4*>(dv_part), reinterpret_cast<float4*>(dk),
      reinterpret_cast<float4*>(dv), n4, p.split, p.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the three passes on `stream` (dq first, which also writes D
// into dsum (B, Hq, S) scratch; then partial dk and dv into dk_part and
// dv_part (split, B, Hkv, S, hd) scratch; then their sum into dk and
// dv), every operand float32 and 16-byte aligned; lse (B, Hq, S) from the
// forward; hd a multiple of 8; the output columns split over col_blocks
// blocks of `cols` as in the forward; `split` divides Hq / Hkv; window
// <= 0 means none. Returns the CUDA error code of the first launch that
// was refused (0 when all three were accepted). B = 0 or S = 0 launches
// nothing.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* dsum, void* dq,
                               void* dk_part, void* dv_part, void* dk,
                               void* dv, int B, int Hq, int Hkv, int S,
                               int hd, int causal, int window, int kv_len,
                               float scale, int col_blocks, int cols,
                               int split, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Params p{S, Hq, Hkv, hd, causal != 0, window > 0 ? window : 0,
                 kv_len, scale, col_blocks, cols, split};
  if (!params_ok(B, p) || split < 1 || (Hq / Hkv) % split != 0 ||
      static_cast<long long>(B) * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  auto* kp = static_cast<float*>(dk_part);
  auto* vp = static_cast<float*>(dv_part);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(NT)                                                  \
  case NT:                                                                  \
    return launch<NT>(qf, kf, vf, of, df, lse, dsum, dqf, kp, vp, dkf, dvf, \
                      B, p, s);
  switch (n_tiles(cols)) {
    FLASH_BWD_CASE(4)
    FLASH_BWD_CASE(8)
    FLASH_BWD_CASE(12)
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(20)
    FLASH_BWD_CASE(24)
    FLASH_BWD_CASE(28)
    FLASH_BWD_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
