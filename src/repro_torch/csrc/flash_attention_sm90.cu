// Blocked GQA attention forward with an online softmax (flash attention)
// for bf16 operands, on Hopper's tensor cores (sm_90a: wgmma fed by TMA).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:39
// _flash_kernel, reached by flash_attention_pallas (pl.pallas_call at
// repro/kernels/flash_attention.py:135), for bf16 operands; float32
// operands keep the scalar kernel in flash_attention.cu. The plain torch
// version beside it is repro_torch/kernels/ref.py:flash_attention_ref.
//
// What it computes. q (B, Hq, S, hd), k and v (B, Hkv, S, hd), all
// contiguous bf16, hd 64, 128 or 256; query head h reads kv head
// h / (Hq / Hkv). Key j is visible from query i where j <= i (causal),
// j > i - window (window > 0) and j < kv_len. For every query row:
//   out = sum_j softmax_j(scale * q.k_j) v_j   over the visible j,
// products in bf16 with float32 sums, the running max and denominator
// in float32, the output rounded to bf16. A row that sees no key comes
// out 0: its max is clamped at -1e30 / 2 before the exponent and its
// denominator at 1e-30, as the TPU kernel guards it
// (repro/kernels/flash_attention.py:86-89). When asked (training), each
// row's float32 log-sum-exp, max + log(denominator), goes to lse.
//
// Bound. 4 * hd flops per visible (query head, key) pair: 2 * hd for
// q.k and 2 * hd for p.v. recurrentgemma-2b's serving shapes (B = 4,
// Hq = 10, Hkv = 1, hd = 256) at S = 4096 with window 2048 do 2.6e11
// flops against 0.19 GB of operands, so the tensor cores' rate (989
// TFLOP/s bf16) bounds it, not device memory.
//
// Design. One block per (128 query rows, query head, batch row), three
// warpgroups, the causal grid walked heaviest tile first:
//  - a producer warpgroup whose first thread loads the block's q tile
//    (two 64-row tiles) once, then keeps TMA loads of 64-key K and V
//    tiles in flight through a 2-stage ring of shared memory guarded by
//    mbarriers: K and V each have a "full" and an "empty" barrier per
//    stage, so q.k can start before V lands and a K stage refills as
//    soon as its scores are taken; it gives its registers away
//    (setmaxnreg 40);
//  - two consumer warpgroups (setmaxnreg 232), each owning 64 query
//    rows: S = Q K^T is wgmma m64n64k16 with both operands in shared
//    memory (hd / 16 instructions), the online softmax runs on the f32
//    accumulator in registers (2^x on the special-function unit with
//    the scale folded into one FMA, each row's max and sum as a tree
//    over its 16 registers and then its quad of lanes, the output's
//    rescale skipped by a warp whose rows kept their max), P goes back
//    into the tensor cores from registers as bf16 (the accumulator's
//    layout is the A operand's), and O += P V is wgmma m64n{hd}k16 with
//    V read as an MN-major B operand: 4 instructions per tile, the
//    64 x hd f32 O accumulator in registers (128 a thread at hd = 256).
//    A warpgroup skips the tiles wholly masked for its rows. Each step
//    issues tile i's scores and tile i - 1's P V together, and tile i's
//    softmax runs on the CUDA cores while that P V runs on the tensor
//    cores; the two warpgroups interleave there as well.
// Only the tiles the block can see are loaded (right of the diagonal and
// left of the window are never visited), and only tiles that straddle
// the causal diagonal, the window's edge or kv_len test each pair. Shared memory at hd = 256: q 64 KB + 2 stages x (K + V) 128 KB,
// plus 1 KB to align the 128-byte-swizzled boxes. The library-wide
// -fmad=false splits a*b+c; the softmax writes its fused multiply-adds
// explicitly (__fmaf_rn).

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 2;              // warpgroups of 64 query rows
constexpr int kBQ = kConsumers * kTileRows; // query rows per block
constexpr int kBN = kTileRows;             // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);

template <int HD>
struct Layout {
  static constexpr int kTile = kTileRows * HD * 2;   // one 64-row tile
  static constexpr int kQ = 0;                       // kConsumers tiles
  static constexpr int kK = kQ + kConsumers * kTile; // kStages tiles
  static constexpr int kV = kK + kStages * kTile;    // kStages tiles
  static constexpr int kBytes = kV + kStages * kTile + 1024;
};

struct Params {
  Mask mask;
  int Hq, Hkv;
  int kv_tiles;        // key tiles holding a key below kv_len
  float scale_log2;    // scale * log2(e)
  __nv_bfloat16* o;
  float* lse;          // null: not asked for
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // barriers: q full; K and V full (TMA completes them) and K and V empty
  // (every consumer warp arrives), one of each per stage, 8 bytes apart
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);
  const uint32_t v_full = smem_u32(&bars[1 + kStages]);
  const uint32_t k_empty = smem_u32(&bars[1 + 2 * kStages]);
  const uint32_t v_empty = smem_u32(&bars[1 + 3 * kStages]);

  const int S = p.mask.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qhead = b * p.Hq + h;
  const int kvhead = b * p.Hkv + h / (p.Hq / p.Hkv);

  // the key tiles this block's rows can see: [t_begin, t_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  int t_end = p.kv_tiles;
  if (p.mask.causal) t_end = min(t_end, q_last / kBN + 1);
  const int t_begin = p.mask.window > 0
                          ? max(0, q0 - p.mask.window + 1) / kBN : 0;
  const int n_tiles = max(0, t_end - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kConsumers);
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kConsumers * L::kTile);
      for (int c = 0; c < kConsumers; ++c)
        tma_load_tile(base + L::kQ + c * L::kTile, &tq, q_full, HD,
                      q0 + c * kTileRows, qhead);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t reuse = ((i / kStages) & 1) ^ 1;
        const int k0 = (t_begin + i) * kBN;
        if (i >= kStages) mbar_wait(k_empty + 8 * s, reuse);
        mbar_expect_tx(k_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kK + s * L::kTile, &tk, k_full + 8 * s, HD,
                      k0, kvhead);
        if (i >= kStages) mbar_wait(v_empty + 8 * s, reuse);
        mbar_expect_tx(v_full + 8 * s, L::kTile);
        tma_load_tile(base + L::kV + s * L::kTile, &tv, v_full + 8 * s, HD,
                      k0, kvhead);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int r0 = q0 + c * kTileRows;           // this warpgroup's rows
  const int row_lo = r0 + acc_row(t, 0);
  const int row_hi = row_lo + 8;
  const uint32_t sq = base + L::kQ + c * L::kTile;
  auto stage = [](int i) { return 8 * (i % kStages); };
  auto parity = [](int i) { return static_cast<uint32_t>((i / kStages) & 1); };
  auto k_tile = [&](int i) { return base + L::kK + (i % kStages) * L::kTile; };
  auto v_tile = [&](int i) { return base + L::kV + (i % kStages) * L::kTile; };
  auto release = [&](uint32_t bar, int i) {
    if ((t & 31) == 0) mbar_arrive(bar + stage(i));
  };

  // the tiles holding a visible pair for this warpgroup's rows are one
  // run [live_lo, live_hi) of the block's (the window's edge starts it,
  // the causal diagonal and kv_len end it)
  int live_lo = n_tiles, live_hi = n_tiles;
  for (int i = 0; i < n_tiles; ++i) {
    if (p.mask.tile(r0, (t_begin + i) * kBN) != 0) {
      live_lo = min(live_lo, i);
      live_hi = i + 1;
    }
  }
  if (live_lo == n_tiles) live_hi = n_tiles;

  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};   // this thread's share of each row's sum
  float sc[32];
  float alpha[2];
  uint32_t pf[4][4];

  // online softmax of tile i's raw scores in sc, the running max m in
  // the log2 domain (scores times c = scale log2(e)): P into sc, the row
  // sums moved on, alpha the factor the output takes. Only an edge tile
  // tests each pair; a masked score becomes one whose scaled value is
  // -3e38 x |c| (exponent 0), and a row that has seen no key keeps
  // m = -1e30, clamped at -1e30 / 2 before the exponent as the TPU kernel
  // does. The largest scaled score is c times the row's max, or its min
  // when c < 0.
  const bool up = p.scale_log2 >= 0.0f;
  auto softmax = [&](int i) {
    const int k0 = (t_begin + i) * kBN;
    if (p.mask.tile(r0, k0) == 2) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (!p.mask.visible((e & 2) ? row_hi : row_lo, k0 + acc_col(t, e)))
          sc[e] = up ? kMasked : -kMasked;
    }
    float msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = quad_max((up ? row_extreme<true>(sc, r)
                              : row_extreme<false>(sc, r)) * p.scale_log2);
      mx = fmaxf(m[r], mx);
      msafe[r] = fmaxf(mx, kNegInf / 2);
      alpha[r] = fast_exp2(m[r] - msafe[r]);
      m[r] = mx;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = fast_exp2(__fmaf_rn(sc[e], p.scale_log2,
                                  -msafe[(e >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], row_sum(sc, r));
  };

  mbar_wait(q_full, 0);
  // wholly masked tiles before the run: wait for them and hand them back
  for (int i = 0; i < live_lo; ++i) {
    mbar_wait(k_full + stage(i), parity(i));
    mbar_wait(v_full + stage(i), parity(i));
    release(k_empty, i);
    release(v_empty, i);
  }
  if (live_lo < live_hi) {
    // the first tile's scores alone, then each step issues tile i's
    // scores and tile i - 1's P V together, and tile i's softmax runs on
    // the CUDA cores while that P V runs on the tensor cores
    mbar_wait(k_full + stage(live_lo), parity(live_lo));
    wgmma_fence();
    gemm_abt<HD>(sc, sq, k_tile(live_lo));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty, live_lo);
    softmax(live_lo);
    to_fragments(sc, pf);
    for (int i = live_lo + 1; i < live_hi; ++i) {
      mbar_wait(k_full + stage(i), parity(i));
      mbar_wait(v_full + stage(i - 1), parity(i - 1));
      fence_regs(acc);
      wgmma_fence();
      gemm_abt<HD>(sc, sq, k_tile(i));
      wgmma_commit();
      gemm_pb<HD>(acc, pf, v_tile(i - 1));
      wgmma_commit();
      wgmma_wait<1>();                 // the scores; P V still running
      fence_regs(sc);
      release(k_empty, i);
      softmax(i);
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty, i - 1);
      // a warp whose rows kept their max skips the rescale (alpha = 1)
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      }
      to_fragments(sc, pf);
    }
    const int last = live_hi - 1;
    mbar_wait(v_full + stage(last), parity(last));
    fence_regs(acc);
    wgmma_fence();
    gemm_pb<HD>(acc, pf, v_tile(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_empty, last);
  }
  // wholly masked tiles after the run
  for (int i = live_hi; i < n_tiles; ++i) {
    mbar_wait(k_full + stage(i), parity(i));
    mbar_wait(v_full + stage(i), parity(i));
    release(k_empty, i);
    release(v_empty, i);
  }

  // each row's sum over its quad of lanes; out = acc / sum
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    inv[r] = 1.0f / denom;
    l[r] = denom;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_hi : row_lo;
    if (row >= S) continue;
    __nv_bfloat16* orow = p.o + (static_cast<long long>(qhead) * S + row) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + acc_col(t, 4 * i)) =
          pack_bf16(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
    if (p.lse != nullptr && (t & 3) == 0)
      p.lse[static_cast<long long>(qhead) * S + row] =
          fmaxf(m[r] * kLn2, kNegInf / 2) + logf(l[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, dim3 grid, cudaStream_t stream) {
  const int S = p.mask.S;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, HD, S, static_cast<long long>(B) * p.Hq);
  if (err == 0) err = make_map(&tk, k, HD, S, static_cast<long long>(B) * p.Hkv);
  if (err == 0) err = make_map(&tv, v, HD, S, static_cast<long long>(B) * p.Hkv);
  if (err != 0) return err;
  constexpr int smem = Layout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_sm90_kernel<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the bf16 forward on `stream`. hd must be 64, 128 or 256;
// window <= 0 means none; kv_tiles = ceil(kv_len / 64). The grid is the
// wrapper's (kernels/flash_attention.py:launch_geometry): grid_x blocks
// of 128 query rows must cover S exactly, grid_y = Hq, grid_z = B. lse,
// when not null, receives each row's float32 log-sum-exp (B, Hq, S) for
// the backward; serving passes null. q, k, v and o must be 16-byte
// aligned. Returns the CUDA error code of the launch (0 when it was
// accepted). B = 0 or S = 0 launches nothing.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int Hq, int Hkv,
                                int S, int hd, int causal, int window,
                                int kv_len, int kv_tiles, float scale,
                                int grid_x, int grid_y, int grid_z,
                                void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || grid_y != Hq || grid_z != B ||
      grid_y > 65535 || grid_z > 65535 ||
      static_cast<long long>(grid_x) * kBQ < S ||
      static_cast<long long>(grid_x - 1) * kBQ >= S || kv_len < 0 ||
      kv_len > S || kv_tiles != (kv_len + kBN - 1) / kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{{S, causal != 0, window > 0 ? window : 0, kv_len}, Hq, Hkv,
                 kv_tiles, scale * kLog2e,
                 static_cast<__nv_bfloat16*>(o), lse};
  const dim3 grid(grid_x, grid_y, grid_z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, p, B, grid, s);
    case 128: return launch<128>(q, k, v, p, B, grid, s);
    case 256: return launch<256>(q, k, v, p, B, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one block takes at head dim hd (0 for an hd
// the kernel does not take).
int flash_attention_sm90_smem_bytes(int hd) {
  switch (hd) {
    case 64: return Layout<64>::kBytes;
    case 128: return Layout<128>::kBytes;
    case 256: return Layout<256>::kBytes;
    default: return 0;
  }
}

const char* flash_attention_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
