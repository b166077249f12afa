// Blocked GQA attention forward with an online softmax (flash attention),
// for Hopper (sm_90a): the float32 route, on the tensor cores in split
// TF32 (csrc/flash_tf32.cuh).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:39
// _flash_kernel, reached by flash_attention_pallas (pl.pallas_call at
// repro/kernels/flash_attention.py:135), for float32 operands, and for
// bfloat16 operands at hd > 256, which the wrapper reads as float32 (the
// reference computes in float32 for both: flash_attention.py:66-98);
// bfloat16 at hd <= 256 goes to the wgmma kernel in
// flash_attention_sm90.cu. Plain TF32 would keep about 2^-11 of each
// product, which the float32 tolerances do not allow; split TF32 keeps
// float32 accuracy on the tensor cores. The plain torch version beside
// it is repro_torch/kernels/ref.py:flash_attention_ref.
//
// What it computes. q (B, Hq, S, hd), k and v (B, Hkv, S, hd), all
// contiguous float32, hd a multiple of 8 (the wrapper zero-pads any
// other: the zero columns add exact zeros to every product); query head
// h reads kv head h / (Hq / Hkv). Key j is visible from query i where
// j <= i (causal), j > i - window (window > 0) and j < kv_len. For every
// query row:
//   out = sum_j softmax_j(scale * q.k_j) v_j   over the visible j,
// with the running max and denominator in float32. A row that sees no
// key comes out 0: its max is clamped at -1e30 / 2 before the exponent
// and its denominator at 1e-30, as the TPU kernel guards it
// (repro/kernels/flash_attention.py:86-89).
//
// Bound. 4 * hd flops per visible (query head, key) pair: 2 * hd for
// q.k and 2 * hd for p.v. Split TF32 runs three TF32 products for each
// float32-accurate one, so the card's dense TF32 rate (495 TFLOP/s)
// gives 165 TFLOP/s of them. (4, 10, 1, 256) at S = 1024 causal does
// 2.149e10 flops against 92 MB of operands: 0.130 ms at 165 TFLOP/s
// (0.3208 ms at the 67 TFLOP/s of scalar float32 FMAs), not device
// memory (0.0275 ms). mma.sync, which this kernel issues, runs TF32
// below the dense rate; a third of its rate is the most this design can
// get.
//
// Design. One block of 4 warps per (query head x column block, batch
// row, 64 query rows), the q tiles launched last to first so that, under
// the causal mask, the blocks that see the most keys start first and the
// grid's tail is short; each warp owns 16 rows (an m16 tile). The TPU
// grid's sequential kv axis becomes a loop inside the block over the
// 32-key tiles this q tile can see: tiles right of the diagonal (causal)
// and left of the window of the tile's first row are never visited, and
// keys past kv_len or S are masked. For each key tile:
//  - score units (64 head-dim columns of K each): S = Q K^T, 16 rows x
//    32 keys a warp, in split-TF32 mma.sync; Q is resident in shared
//    memory at hd <= 256 and streamed with each unit above;
//  - the online softmax on the accumulators (rows g and g + 8 of each
//    thread, reduced over the quad by shuffles), which rescales the
//    output accumulator and leaves P in the same registers;
//  - value units (64 output columns of V each): acc += P V, P split once
//    a tile, V read down its columns (N-major).
// K and V units stream through a 2-slot cp.async ring, each split into
// TF32 big and small planes in place by the threads that copied it (so
// once a block, not once a warp). The output accumulator (16 rows x up
// to 256 columns a warp, 128 registers a thread at 256) stays in
// registers; a wider hd is split over column blocks (at most 256 columns
// each), which each recompute the scores. Shared memory at hd = 256:
// resident Q (64 x 264 floats) and 2 units of 2 x 32 x 72 floats,
// 104,448 bytes: two blocks an SM.

#include "flash_tf32.cuh"

namespace {

using namespace tf32;

constexpr int kThreads = 128;              // 4 warps
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 32;                    // keys per tile
constexpr int kStages = 2;

// floats of one ring unit: a score unit (K's two planes, and Q when not
// resident) or a value unit (V's two planes)
__host__ __device__ inline int unit_floats(bool resident) {
  const int score = 2 * kBK * kKStride + (resident ? 0 : kBQ * kKStride);
  const int value = 2 * kBK * kNStride;
  return score > value ? score : value;
}

__host__ __device__ inline int smem_floats(int hd, bool resident) {
  return (resident ? kBQ * resident_stride(hd) : 0) +
         kStages * unit_floats(resident);
}

template <int NT>  // output n-tiles of 8 columns a block holds
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Params p) {
  constexpr int NJ = (NT + 7) / 8;         // value units a key tile
  extern __shared__ __align__(16) float smem[];
  const int HD = p.hd, S = p.S;
  const bool resident = p.col_blocks == 1;
  const int rld = resident_stride(HD);
  float* sQ = smem;
  float* ring = smem + (resident ? kBQ * rld : 0);
  const int unit = unit_floats(resident);

  // q tiles run last to first (the slowest grid axis): under the causal
  // mask the last tiles see the most keys, so the longest blocks start
  // first and the tail of the grid is short
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x / p.col_blocks;
  const int c0 = (blockIdx.x % p.col_blocks) * p.cols;
  const int c_end = min(HD, c0 + p.cols);
  const int b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const long long row0 = (static_cast<long long>(b) * p.Hq + h) * S;
  const float* qg = q + row0 * HD;
  const float* kg = k + (static_cast<long long>(b) * p.Hkv + hk) * S * HD;
  const float* vg = v + (static_cast<long long>(b) * p.Hkv + hk) * S * HD;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (tid >> 5) * 16;          // this warp's first row
  const int nkc = (HD + kChunk - 1) / kChunk;
  const int per_tile = nkc + NJ;

  // the keys this tile of queries can see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = min(S, p.kv_len);
  if (p.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const int n_units = max(0, t_end - t_begin) * per_tile;

  // the next unit to issue: key tile, and its place in the tile (score
  // chunks, then value chunks)
  int next = 0, next_tile = t_begin, next_r = 0;
  const int r_t = tid >> 4, c_t = (tid & 15) * 4;
  auto issue = [&]() {
    float* dst = ring + (next % kStages) * unit;
    const int k0 = next_tile * kBK;
    if (next_r < nkc) {
      const int col = next_r * kChunk;
      const bool col_ok = col + c_t < HD;
      copy_unit<kBK, kThreads>(dst, kKStride,
                               kg + static_cast<long long>(k0) * HD + col, HD,
                               S - k0, col_ok, r_t, c_t, kg);
      if (!resident)
        copy_unit<kBQ, kThreads>(dst + 2 * kBK * kKStride, kKStride,
                                 qg + static_cast<long long>(q0) * HD + col,
                                 HD, S - q0, col_ok, r_t, c_t, qg);
    } else {
      const int col = c0 + (next_r - nkc) * kChunk;
      copy_unit<kBK, kThreads>(dst, kNStride,
                               vg + static_cast<long long>(k0) * HD + col, HD,
                               S - k0, col + c_t < c_end, r_t, c_t, vg);
    }
    ++next;
    if (++next_r == per_tile) {
      next_r = 0;
      ++next_tile;
    }
  };
  // before unit u: this thread's pieces of it have landed and it splits
  // them (K or V: the B operand); after the barrier the whole unit is
  // split, and the slot of unit u - 1 takes unit u + 1
  auto step = [&](int u, bool value) {
    cp_async_wait<0>();
    float* cur = ring + (u % kStages) * unit;
    if (value)
      split_unit<kBK, kThreads>(cur, kNStride, kBK * kNStride, r_t, c_t);
    else
      split_unit<kBK, kThreads>(cur, kKStride, kBK * kKStride, r_t, c_t);
    __syncthreads();
    if (next < n_units) issue();
    cp_async_commit();
  };

  if (resident)
    copy_tile(sQ, rld, qg + static_cast<long long>(q0) * HD, HD, kBQ, S - q0,
              (rld - 8) / 4, HD / 4, qg, tid, kThreads);
  if (n_units > 0) issue();
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  int u = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kBK;
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;

    for (int c = 0; c < nkc; ++c, ++u) {
      step(u, false);
      const float* Kc = ring + (u % kStages) * unit;
      const float* Qc = resident ? sQ + r0 * rld + c * kChunk
                                 : Kc + 2 * kBK * kKStride + r0 * kKStride;
      const int qld = resident ? rld : kKStride;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const FragA a = load_a(Qc, qld, ks * 8, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(s[n], a, load_b_kmajor(Kc, kBK * kKStride, kKStride, n * 8,
                                      ks * 8, lane));
      }
    }

    // the online softmax on rows g and g + 8 of the warp's 16
    uint32_t vis = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + g + (e >> 1) * 8;
        const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool on = visible(p, qi, kj);
        vis |= static_cast<uint32_t>(on) << (n * 4 + e);
        s[n][e] = on ? s[n][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float m_safe[2], alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      m_safe[i] = fmaxf(m_new, kNegInf / 2);
      alpha[i] = expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe =
            (vis >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_safe[e >> 1]) : 0.0f;
        s[n][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    FragA pa[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) pa[n] = frag_of_acc(s[n]);

    // acc += P V, 64 output columns a unit
#pragma unroll
    for (int j = 0; j < NJ; ++j, ++u) {
      step(u, true);
      const float* Vc = ring + (u % kStages) * unit;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          if (j * 8 + nn < NT)
            mma3(acc[j * 8 + nn], pa[n],
                 load_b_nmajor(Vc, kBK * kNStride, kNStride, n * 8, nn * 8,
                               lane));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && c0 == 0 && t4 == 0)
      lse[row0 + qi] = fmaxf(m[i], kNegInf / 2) + logf(denom);
    float* orow = o + (row0 + qi) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (col < c_end)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    }
  }
}

template <int NT>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.hd, p.col_blocks == 1);
  const cudaError_t err =
      set_smem(flash_fwd_tf32_kernel<NT>, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.Hq * p.col_blocks, B, (p.S + kBQ - 1) / kBQ);
  flash_fwd_tf32_kernel<NT><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the float32 forward on `stream` (q, k, v and o float32,
// 16-byte aligned); hd a multiple of 8; the output columns split over
// col_blocks blocks of `cols` (a multiple of 8, at most 256; col_blocks
// 1 needs hd <= 256); window <= 0 means none. lse, when not null,
// receives each row's float32 log-sum-exp (B, Hq, S) for the backward;
// serving passes null. Returns the CUDA error code of the launch (0 when
// it was accepted). B = 0 or S = 0 launches nothing.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Hq, int Hkv, int S,
                           int hd, int causal, int window, int kv_len,
                           float scale, int col_blocks, int cols,
                           void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const Params p{S, Hq, Hkv, hd, causal != 0, window > 0 ? window : 0,
                 kv_len, scale, col_blocks, cols, 1};
  if (!params_ok(B, p)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles(cols)) {
    case 4: return launch<4>(qf, kf, vf, of, lse, B, p, s);
    case 8: return launch<8>(qf, kf, vf, of, lse, B, p, s);
    case 12: return launch<12>(qf, kf, vf, of, lse, B, p, s);
    case 16: return launch<16>(qf, kf, vf, of, lse, B, p, s);
    case 20: return launch<20>(qf, kf, vf, of, lse, B, p, s);
    case 24: return launch<24>(qf, kf, vf, of, lse, B, p, s);
    case 28: return launch<28>(qf, kf, vf, of, lse, B, p, s);
    case 32: return launch<32>(qf, kf, vf, of, lse, B, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
