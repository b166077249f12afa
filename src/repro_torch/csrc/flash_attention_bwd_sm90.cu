// Backward of the bf16 flash attention in flash_attention_sm90.cu, on
// Hopper's tensor cores (sm_90a: wgmma fed by TMA).
//
// No TPU counterpart: the reference differentiates plain jnp and has no
// backward kernel. It is the gradient of the port of
// repro/kernels/flash_attention.py:39 _flash_kernel for bf16 operands;
// float32 operands keep the scalar kernel in flash_attention_bwd.cu. The
// plain torch version beside it is
// repro_torch/kernels/ref.py:flash_attention_bwd_ref.
//
// What it computes. The forward's operands q (B, Hq, S, hd), k and v
// (B, Hkv, S, hd), its output o and float32 log-sum-exp lse (B, Hq, S),
// and the output's gradient do (like q), all bf16 but lse, give dq (like
// q) and dk, dv (like k), under the forward's causal, window and kv_len
// masks. For a visible pair (query row i of head h, key j of kv head
// h / (Hq / Hkv)):
//   P_ij = exp(scale q_i.k_j - lse_i),  D_i = sum_c do_ic o_ic,
//   dS_ij = P_ij (do_i.v_j - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_(h, i) dS_ij q_i,
//   dv_j = sum_(h, i) P_ij do_i,
// where dk_j and dv_j sum over every query head of the kv head's group.
// Products in bf16 with float32 sums (P and dS rounded to bf16 where
// they enter a product), every other step in float32; each gradient
// rounded to bf16 once.
//
// Bound. 10 * hd flops per visible (query head, key) pair (q.k, do.v,
// dq, dk, dv at 2 hd each); the two passes below recompute q.k and do.v,
// so 14 hd are done. recurrentgemma-2b's training shape (B 1, Hq 10, Hkv
// 1, hd 256, S 2048 causal) needs 5.4e10 flops against 55 MB of
// operands: the tensor cores' rate (989 TFLOP/s bf16) bounds it (54 us),
// not device memory.
//
// Design. Three launches, deterministic: every output element is summed
// in a fixed order by one thread, with no atomics, so a run repeats bit
// for bit.
//  1. dq pass: one block per (64 query rows, query head, batch row), a
//     producer warpgroup and one consumer warpgroup. The consumer first
//     forms D for its rows from do and o and writes it out for pass 2;
//     the producer loads the q and do tiles once and streams 64-key K
//     and V tiles by TMA through a 2-stage mbarrier ring. Per tile,
//     S = Q K^T and dP = dO V^T are wgmma m64n64k16 with all operands in
//     shared memory, P = 2^(S scale log2e - lse log2e) and
//     dS = P (dP - D) are formed on the accumulators in registers, and
//     dQ += dS K takes dS from registers as bf16 and K as an MN-major B
//     operand (the same swizzled tile q.k read K-major).
//  2. dk/dv pass: one block per (64 keys, head split, batch row x kv
//     head): K and V are loaded once, and the producer streams the
//     (q, do) tiles of the query rows that can see the block's keys, for
//     each query head of its part of the group, through a 2-stage ring.
//     The dK and dV accumulators (64 x hd f32 each, 128 registers a
//     thread at hd 256) do not fit in one warpgroup, so each has its own
//     consumer warpgroup: the dV warpgroup forms S^T = K Q^T and
//     P^T = exp(...), hands P^T to the dK warpgroup through 16 KB of
//     shared memory (f32, thread to thread: both accumulators share one
//     layout), and adds P^T dO; the dK warpgroup forms dP^T = V dO^T,
//     dS^T = P^T (dP^T - D), and adds dS^T Q. Named barriers order the
//     exchange. A group of 10 query heads on one kv head (recurrentgemma)
//     gives few key blocks at B 1, so the wrapper splits the group's
//     heads over `split` blocks (kernels/flash_attention.py:
//     launch_geometry) until the grid covers the SMs; each block writes
//     float32 partial dk and dv for its heads.
//  3. reduce: sums the partials of each element in split order, scales
//     dk, and rounds both to bf16.
// Shared memory at hd = 256: pass 1 holds q and do (64 KB) and 2 stages
// of K and V (128 KB); pass 2 holds K and V (64 KB), 2 stages of q and
// do (128 KB) and the 16 KB exchange; each plus 1 KB of alignment.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;
constexpr int kDqThreads = 256;     // producer + one consumer warpgroup
constexpr int kDkvThreads = 384;    // producer + dV and dK warpgroups
constexpr int kReady = 1;           // named barriers of the P^T exchange
constexpr int kFree = 2;

struct Params {
  Mask mask;
  int Hq, Hkv;
  int kv_tiles;          // key tiles holding a key below kv_len
  int split;             // blocks sharing a kv head's query heads
  float scale;
  float scale_log2;      // scale * log2(e)
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* dsum;           // D (B, Hq, S), written by pass 1
  __nv_bfloat16* dq;
  float* dk_part;        // (split, B * Hkv, S, hd)
  float* dv_part;
};

template <int HD>
struct DqLayout {
  static constexpr int kTile = kTileRows * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kK = 2 * kTile;                 // kStages tiles
  static constexpr int kV = kK + kStages * kTile;      // kStages tiles
  static constexpr int kBytes = kV + kStages * kTile + 1024;
};

template <int HD>
struct DkvLayout {
  static constexpr int kTile = kTileRows * HD * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;                 // kStages tiles
  static constexpr int kDo = kQ + kStages * kTile;     // kStages tiles
  static constexpr int kX = kDo + kStages * kTile;     // 32 x 128 floats
  static constexpr int kBytes = kX + 32 * 128 * 4 + 1024;
};

// ---- pass 1: D and dq ------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DqLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  __shared__ float sD[kTileRows];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);
  const uint32_t v_full = smem_u32(&bars[1 + kStages]);
  const uint32_t empty = smem_u32(&bars[1 + 2 * kStages]);

  const int S = p.mask.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qhead = b * p.Hq + h;
  const int kvhead = b * p.Hkv + h / (p.Hq / p.Hkv);

  const int q_last = min(q0 + kTileRows, S) - 1;
  int t_end = p.kv_tiles;
  if (p.mask.causal) t_end = min(t_end, q_last / kTileRows + 1);
  const int t_begin = p.mask.window > 0
                          ? max(0, q0 - p.mask.window + 1) / kTileRows : 0;
  const int n_tiles = max(0, t_end - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kTile);
      tma_load_tile(base + L::kQ, &tq, q_full, HD, q0, qhead);
      tma_load_tile(base + L::kDo, &tdo, q_full, HD, q0, qhead);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const int k0 = (t_begin + i) * kTileRows;
        mbar_expect_tx(k_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kK + s * L::kTile, &tk, k_full + 8 * s, HD,
                      k0, kvhead);
        mbar_expect_tx(v_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kV + s * L::kTile, &tv, v_full + 8 * s, HD,
                      k0, kvhead);
      }
    }
    return;
  }

  // ---- consumer ----
  const int t = threadIdx.x - 128;
  const long long row0 = static_cast<long long>(qhead) * S;
  {
    // D for the tile's rows: two threads a row, 8 columns a load
    const int r = t >> 1;
    const int qi = q0 + r;
    float part = 0.0f;
    if (qi < S) {
      const uint4* dr = reinterpret_cast<const uint4*>(p.dout + (row0 + qi) * HD);
      const uint4* orow = reinterpret_cast<const uint4*>(p.o + (row0 + qi) * HD);
#pragma unroll
      for (int c = (t & 1); c < HD / 8; c += 2) {
        const uint4 a = dr[c], o = orow[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a2[j]);
          const float2 y = __bfloat1622float2(o2[j]);
          part = __fmaf_rn(x.x, y.x, part);
          part = __fmaf_rn(x.y, y.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((t & 1) == 0) {
      sD[r] = part;
      if (qi < S) p.dsum[row0 + qi] = part;
    }
  }
  named_sync(kReady, 128);

  const int row_lo = q0 + acc_row(t, 0);
  const int row_hi = row_lo + 8;
  const float d_lo = sD[acc_row(t, 0)], d_hi = sD[acc_row(t, 0) + 8];
  const float lse_lo = row_lo < S ? p.lse[row0 + row_lo] * kLog2e : 0.0f;
  const float lse_hi = row_hi < S ? p.lse[row0 + row_hi] * kLog2e : 0.0f;

  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (t_begin + i) * kTileRows;
    const int state = p.mask.tile(q0, k0);
    mbar_wait(k_full + 8 * s, phase);
    mbar_wait(v_full + 8 * s, phase);
    if (state != 0) {
      const uint32_t sk = base + L::kK + s * L::kTile;
      float sc[32], dp[32];
      fence_regs(acc);
      wgmma_fence();
      gemm_abt<HD>(sc, base + L::kQ, sk);
      gemm_abt<HD>(dp, base + L::kDo, base + L::kV + s * L::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = fast_exp2(__fmaf_rn(sc[e], p.scale_log2,
                                    (e & 2) ? -lse_hi : -lse_lo));
      if (state == 2) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (!p.mask.visible((e & 2) ? row_hi : row_lo, k0 + acc_col(t, e)))
            sc[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = sc[e] * (dp[e] - ((e & 2) ? d_hi : d_lo));
      uint32_t ds[4][4];
      to_fragments(sc, ds);
      fence_regs(acc);
      wgmma_fence();
      gemm_pb<HD>(acc, ds, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if ((t & 31) == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_hi : row_lo;
    if (row >= S) continue;
    __nv_bfloat16* out = p.dq + (row0 + row) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + acc_col(t, 4 * i)) =
          pack_bf16(acc[4 * i + 2 * r] * p.scale,
                    acc[4 * i + 2 * r + 1] * p.scale);
  }
}

// ---- pass 2: partial dk and dv -------------------------------------------
// the (query head, query tile) items of key block k0: heads h0 ..
// h0 + per - 1, each over query tiles it0 .. it1 - 1
struct Items {
  int h0, per, it0, it1;
  __device__ __forceinline__ int count() const { return per * max(0, it1 - it0); }
  __device__ __forceinline__ int head(int i) const {
    return h0 + i / max(1, it1 - it0);
  }
  __device__ __forceinline__ int tile(int i) const {
    return it0 + i % max(1, it1 - it0);
  }
};

__device__ __forceinline__ Items items_of(const Params& p, int k0, int hk,
                                          int part) {
  const int S = p.mask.S;
  const int group = p.Hq / p.Hkv;
  Items it;
  it.per = group / p.split;
  it.h0 = hk * group + part * it.per;
  const int k_last = min(k0 + kTileRows, S) - 1;
  const int i_begin = p.mask.causal ? k0 : 0;
  int i_end = p.mask.window > 0 ? min(S, k_last + p.mask.window) : S;
  if (k0 >= p.mask.kv_len) i_end = i_begin;    // every key masked
  it.it0 = i_begin / kTileRows;
  it.it1 = i_end > i_begin ? (i_end + kTileRows - 1) / kTileRows : it.it0;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           Params p) {
  using L = DkvLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* xchg = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::kX);
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t q_full = smem_u32(&bars[1]);
  const uint32_t do_full = smem_u32(&bars[1 + kStages]);
  const uint32_t empty = smem_u32(&bars[1 + 2 * kStages]);

  const int S = p.mask.S;
  const int k0 = blockIdx.x * kTileRows;
  const int part = blockIdx.y;
  const int b = blockIdx.z / p.Hkv;
  const int hk = blockIdx.z % p.Hkv;
  const int kvhead = blockIdx.z;
  const Items it = items_of(p, k0, hk, part);
  const int n_items = it.count();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(do_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      tma_load_tile(base + L::kK, &tk, kv_full, HD, k0, kvhead);
      tma_load_tile(base + L::kV, &tv, kv_full, HD, k0, kvhead);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const int qhead = b * p.Hq + it.head(i);
        const int i0 = it.tile(i) * kTileRows;
        mbar_expect_tx(q_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kQ + s * L::kTile, &tq, q_full + 8 * s, HD,
                      i0, qhead);
        mbar_expect_tx(do_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kDo + s * L::kTile, &tdo, do_full + 8 * s, HD,
                      i0, qhead);
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 owns dV, warpgroup 2 owns dK ----
  setmaxnreg_inc<232>();
  const bool owns_dv = threadIdx.x < 256;
  const int t = threadIdx.x % 128;
  const int key_lo = k0 + acc_row(t, 0);       // this thread's rows: keys
  const int key_hi = key_lo + 8;

  // the exchanges this block makes: one per item that is not wholly masked
  int n_live = 0;
  for (int i = 0; i < n_items; ++i)
    n_live += p.mask.tile(it.tile(i) * kTileRows, k0) != 0;

  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;

  mbar_wait(kv_full, 0);
  int live = 0;
  for (int i = 0; i < n_items; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int i0 = it.tile(i) * kTileRows;
    const int state = p.mask.tile(i0, k0);
    const long long row0 = static_cast<long long>(b * p.Hq + it.head(i)) * S;
    // per query column of this thread: lse (dV side) or D (dK side)
    float colv[16];
    if (state != 0) {
      const float* src = owns_dv ? p.lse : p.dsum;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qi = i0 + acc_col(t, (e >> 1) * 4 + (e & 1));
        colv[e] = qi < S ? src[row0 + qi] : 0.0f;
        if (owns_dv) colv[e] *= kLog2e;
      }
    }
    if (owns_dv) {
      mbar_wait(q_full + 8 * s, phase);
      if (state != 0) {
        float st[32];
        fence_regs(acc);
        wgmma_fence();
        gemm_abt<HD>(st, base + L::kK, base + L::kQ + s * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
#pragma unroll
        for (int e = 0; e < 32; ++e)         // colv: by column slot
          st[e] = fast_exp2(__fmaf_rn(st[e], p.scale_log2,
                                      -colv[(e >> 2) * 2 + (e & 1)]));
        if (state == 2) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (!p.mask.visible(i0 + acc_col(t, e),
                                (e & 2) ? key_hi : key_lo))
              st[e] = 0.0f;
        }
        if (live > 0) named_sync(kFree, 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) xchg[e * 128 + t] = st[e];
        named_arrive(kReady, 256);
        uint32_t pf[4][4];
        to_fragments(st, pf);
        mbar_wait(do_full + 8 * s, phase);
        fence_regs(acc);
        wgmma_fence();
        gemm_pb<HD>(acc, pf, base + L::kDo + s * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        ++live;
      } else {
        mbar_wait(do_full + 8 * s, phase);
      }
    } else {
      mbar_wait(do_full + 8 * s, phase);
      if (state != 0) {
        float dpt[32];
        fence_regs(acc);
        wgmma_fence();
        gemm_abt<HD>(dpt, base + L::kV, base + L::kDo + s * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dpt);
        named_sync(kReady, 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int ce = (e >> 2) * 2 + (e & 1);
          dpt[e] = xchg[e * 128 + t] * (dpt[e] - colv[ce]);
        }
        if (live + 1 < n_live) named_arrive(kFree, 256);
        uint32_t dsf[4][4];
        to_fragments(dpt, dsf);
        mbar_wait(q_full + 8 * s, phase);
        fence_regs(acc);
        wgmma_fence();
        gemm_pb<HD>(acc, dsf, base + L::kQ + s * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        ++live;
      } else {
        mbar_wait(q_full + 8 * s, phase);
      }
    }
    if ((t & 31) == 0) mbar_arrive(empty + 8 * s);
  }

  float* out = owns_dv ? p.dv_part : p.dk_part;
  out += (static_cast<long long>(part) * gridDim.z + kvhead) * S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_hi : key_lo;
    if (key >= S) continue;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(out + static_cast<long long>(key) * HD +
                                 acc_col(t, 4 * i)) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ---- pass 3: sum the partials in split order -------------------------------
__global__ void __launch_bounds__(256)
flash_bwd_reduce_sm90_kernel(const float4* __restrict__ dk_part,
                             const float4* __restrict__ dv_part,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, long long n4,
                             int split, float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = dk_part[i], c = dv_part[i];
    for (int s = 1; s < split; ++s) {
      const float4 x = dk_part[s * n4 + i], y = dv_part[s * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    uint2 ka, va;
    ka.x = pack_bf16(a.x * scale, a.y * scale);
    ka.y = pack_bf16(a.z * scale, a.w * scale);
    va.x = pack_bf16(c.x, c.y);
    va.y = pack_bf16(c.z, c.w);
    reinterpret_cast<uint2*>(dk)[i] = ka;
    reinterpret_cast<uint2*>(dv)[i] = va;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, dim3 dq_grid, dim3 dkv_grid, __nv_bfloat16* dk,
           __nv_bfloat16* dv, cudaStream_t stream) {
  const int S = p.mask.S;
  const long long qh = static_cast<long long>(B) * p.Hq;
  const long long kh = static_cast<long long>(B) * p.Hkv;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, HD, S, qh);
  if (err == 0) err = make_map(&tk, k, HD, S, kh);
  if (err == 0) err = make_map(&tv, v, HD, S, kh);
  if (err == 0) err = make_map(&tdo, p.dout, HD, S, qh);
  if (err != 0) return err;
  constexpr int smem1 = DqLayout<HD>::kBytes;
  constexpr int smem2 = DkvLayout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_sm90_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_sm90_kernel<HD><<<dq_grid, kDqThreads, smem1, stream>>>(
      tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_sm90_kernel<HD><<<dkv_grid, kDkvThreads, smem2, stream>>>(
      tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = kh * S * HD / 4;
  const int blocks = static_cast<int>(n4 / 256 + 1 < 1056 ? n4 / 256 + 1 : 1056);
  flash_bwd_reduce_sm90_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(p.dk_part),
      reinterpret_cast<const float4*>(p.dv_part), dk, dv, n4, p.split,
      p.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the three bf16 passes on `stream`: dq (which also writes D
// into dsum (B, Hq, S) float32 scratch), then partial dk and dv into
// dk_part and dv_part ((split, B, Hkv, S, hd) float32 scratch each), then
// their sum into dk and dv. lse (B, Hq, S) float32 from the forward; hd
// must be 64, 128 or 256; window <= 0 means none; kv_tiles = ceil(kv_len
// / 64). The grids are the wrapper's (kernels/flash_attention.py:
// launch_geometry): dq (ceil(S / 64), Hq, B), dk/dv (ceil(S / 64),
// split, B * Hkv), split dividing Hq / Hkv. Every bf16 operand must be
// 16-byte aligned. Returns the CUDA error code of the first launch that
// was refused (0 when all three were accepted). B = 0 or S = 0 launches
// nothing.
int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dsum, void* dq, float* dk_part,
    float* dv_part, void* dk, void* dv, int B, int Hq, int Hkv, int S, int hd,
    int causal, int window, int kv_len, int kv_tiles, float scale, int split,
    int dq_x, int dq_y, int dq_z, int kv_x, int kv_y, int kv_z,
    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  if (Hkv <= 0 || Hq % Hkv != 0 || split <= 0 || (Hq / Hkv) % split != 0 ||
      dq_x != tiles || dq_y != Hq || dq_z != B || kv_x != tiles ||
      kv_y != split || static_cast<long long>(kv_z) != static_cast<long long>(B) * Hkv ||
      dq_y > 65535 || dq_z > 65535 || kv_y > 65535 || kv_z > 65535 ||
      kv_len < 0 || kv_len > S || kv_tiles != (kv_len + kTileRows - 1) / kTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{{S, causal != 0, window > 0 ? window : 0, kv_len},
                 Hq, Hkv, kv_tiles, split, scale, scale * kLog2e,
                 static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout), lse, dsum,
                 static_cast<__nv_bfloat16*>(dq), dk_part, dv_part};
  const dim3 g1(dq_x, dq_y, dq_z), g2(kv_x, kv_y, kv_z);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, p, B, g1, g2, dkb, dvb, s);
    case 128: return launch<128>(q, k, v, p, B, g1, g2, dkb, dvb, s);
    case 256: return launch<256>(q, k, v, p, B, g1, g2, dkb, dvb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one block of pass 1 (dq) or 2 (dk/dv) takes
// at head dim hd (0 for an hd or pass the kernels do not have).
int flash_attention_bwd_sm90_smem_bytes(int hd, int pass) {
  switch (hd * 10 + pass) {
    case 641: return DqLayout<64>::kBytes;
    case 642: return DkvLayout<64>::kBytes;
    case 1281: return DqLayout<128>::kBytes;
    case 1282: return DkvLayout<128>::kBytes;
    case 2561: return DqLayout<256>::kBytes;
    case 2562: return DkvLayout<256>::kBytes;
    default: return 0;
  }
}

const char* flash_attention_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
