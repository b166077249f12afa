// Shared machinery of the float32 flash-attention kernels on Hopper's
// tensor cores (sm_90a): flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward).
//
// - Split TF32 (also called 3xTF32). A float32 operand x of a product
//   becomes big = tf32(x) and small = tf32(x - big), both rounded to
//   nearest, ties away, as cvt.rna.tf32.f32 rounds (round_tf32 below
//   does it with integer ops); x - big is exact in float32. A
//   product a.b is summed in float32 on the tensor cores as
//   small_a big_b + big_a small_b + big_a big_b (three mma.sync
//   m16n8k8 .tf32 with one accumulator, the small terms first), which
//   drops only small_a small_b, about 2^-22 of the product: float32
//   accuracy, where one TF32 product keeps about 2^-11.
// - mma.sync fragments are loaded by the threads from shared memory, in
//   any layout. Inside an 8-deep k step the order of the k slots is free
//   as long as A and B agree, so slot t holds element 2t and slot t + 4
//   element 2t + 1: a thread then reads both of its A (or K-major B)
//   elements as one float2, and the float32 accumulator of one product
//   (row g: columns 2t, 2t + 1) is already the A fragment of the next
//   product over those columns (P V, dS K, P^T dO, dS^T Q), whose B rows
//   2t and 2t + 1 are read from an N-major tile.
// - Row strides in shared memory: K-major tiles (read as float2 across
//   rows) take a stride of 8 (mod 32) words and N-major tiles (read down
//   a column) 4 (mod 32), so no two threads of a quarter (half) warp hit
//   one bank.
// - A ring of two "units" in shared memory, filled by cp.async (16-byte
//   pieces, zero-filled past the edges) one unit ahead of the consumer,
//   one __syncthreads a unit. Before that barrier each thread splits the
//   pieces of the unit's B operands that it copied itself, in place
//   (split_unit), so B fragments load pre-split and each element is
//   split once a block, not once a warp; the A side (the block's own
//   rows, and P or dS) is split by the warp that uses it, as each warp
//   owns its rows. A unit holds 64 head-dim columns
//   of the tiles one step of the walk reads: the score units cover the
//   head dim in chunks of 64, the value units the block's output columns
//   in chunks of 64, zero-filled past hd (a zero column adds exact
//   zeros, and a unit's k steps then run with no branch between them,
//   so the compiler can load one step's fragments while the last one's
//   products run). So any head dim runs: a block accumulates at most
//   256 output columns (kMaxCols); a wider hd is split over blocks that
//   each recompute the scores. At hd <= 256 the block's own rows (the
//   A side of its score products) are loaded once and stay resident;
//   above 256 they come with each score unit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 64;                 // head-dim columns of one unit
constexpr int kKStride = kChunk + 8;       // K-major unit rows: 8 (mod 32)
constexpr int kNStride = kChunk + 4;       // N-major unit rows: 4 (mod 32)
constexpr int kMaxCols = 256;              // output columns a block holds

// Row stride (floats) of an operand held whole in shared memory: its
// columns up to a multiple of kChunk (zero-filled past hd, so that every
// unit runs all its k steps without a branch), plus 8.
__host__ __device__ inline int resident_stride(int hd) {
  return (hd + kChunk - 1) / kChunk * kChunk + 8;
}

struct Params {
  int S, Hq, Hkv;
  int hd;          // the padded head dim: a multiple of 8
  int causal;      // 0 or 1
  int window;      // 0: no window
  int kv_len;      // keys at and past kv_len are masked (S when none)
  float scale;
  int col_blocks;  // blocks the output columns are split over
  int cols;        // output columns a block writes: a multiple of 8
  int split;       // backward: blocks sharing one kv head's query heads
};

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool vis = qi < p.S && kj < p.S && kj < p.kv_len;
  if (p.causal) vis = vis && kj <= qi;
  if (p.window > 0) vis = vis && kj > qi - p.window;
  return vis;
}

// ---- split TF32 on mma.sync ----------------------------------------------

// x rounded to TF32: to nearest, ties away from zero, the rounding of
// cvt.rna.tf32.f32 bit for bit for finite x and infinities, as an
// integer add and mask (the cvt issues more slowly on the card, for the
// same bits). Not for a NaN: the add can carry its payload into the
// exponent or the sign (0x7fffffff, the NaN the card's arithmetic makes,
// becomes -0).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big keeps a NaN's own bits, so a NaN operand makes its products NaN as
// in float32; small is then NaN minus NaN, whose rounding does not matter
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = isnan(x) ? __float_as_uint(x) : round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

struct FragA { uint32_t big[4], small[4]; };   // 16 x 8
struct FragB { uint32_t big[2], small[2]; };   // 8 x 8

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.small, b.big[0], b.big[1]);
  mma(c, a.big, b.small[0], b.small[1]);
  mma(c, a.big, b.big[0], b.big[1]);
}

// A from rows [0, 16) of a K-major tile T (row stride ld), k step at
// columns [k0, k0 + 8)
__device__ __forceinline__ FragA load_a(const float* T, int ld, int k0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(T + g * ld + k0 + 2 * t);
  const float2 y =
      *reinterpret_cast<const float2*>(T + (g + 8) * ld + k0 + 2 * t);
  FragA a;
  split(x.x, a.big[0], a.small[0]);
  split(y.x, a.big[1], a.small[1]);
  split(x.y, a.big[2], a.small[2]);
  split(y.y, a.big[3], a.small[3]);
  return a;
}

// B operands come pre-split: a tile's big halves in one plane (over the
// raw values, see split_unit) and its small halves lo_off floats on, in a
// plane of the same layout.
// B[k][n] = T[n0 + n][k0 + k] of a K-major tile T (row stride ld)
__device__ __forceinline__ FragB load_b_kmajor(const float* T, int lo_off,
                                               int ld, int n0, int k0,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* at = T + (n0 + g) * ld + k0 + 2 * t;
  const uint2 big = *reinterpret_cast<const uint2*>(at);
  const uint2 small = *reinterpret_cast<const uint2*>(at + lo_off);
  return FragB{{big.x, big.y}, {small.x, small.y}};
}

// B[k][n] = T[k0 + k][n0 + n] of an N-major tile T (row stride ld)
__device__ __forceinline__ FragB load_b_nmajor(const float* T, int lo_off,
                                               int ld, int k0, int n0,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* at =
      reinterpret_cast<const uint32_t*>(T + (k0 + 2 * t) * ld + n0 + g);
  return FragB{{at[0], at[ld]}, {at[lo_off], at[lo_off + ld]}};
}

// A over the 8 columns of an accumulator tile c (16 x 8), in the slot
// order load_b_nmajor reads its rows in
__device__ __forceinline__ FragA frag_of_acc(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// named barriers (0 is __syncthreads'): `count` threads in all, the
// producer warps arrive after writing, the consumer warps sync before
// reading
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [0, rows) x `pieces` 16-byte pieces of a row-major global tile
// (src, row stride ld floats) into shared memory (dst, row stride dld),
// zero-filling rows >= rows_valid and pieces >= pieces_valid; `base` is
// a valid address the zero-filled copies name (they read nothing)
__device__ __forceinline__ void copy_tile(float* dst, int dld,
                                          const float* src, long long ld,
                                          int rows, int rows_valid,
                                          int pieces, int pieces_valid,
                                          const float* base, int tid,
                                          int nthreads) {
  for (int i = tid; i < rows * pieces; i += nthreads) {
    const int r = i / pieces, c = (i - r * pieces) * 4;
    const bool ok = r < rows_valid && c < pieces_valid * 4;
    cp_async16(dst + r * dld + c, ok ? src + r * ld + c : base, ok);
  }
}

// the launch's shared memory: `bytes` of dynamic shared memory (above the
// 48 KB default) and the whole carve-out for it, so that as many blocks
// an SM fit as its shared memory allows
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// One ring unit's copy, ROWS rows x kChunk columns of a row-major global
// tile (src: its row 0 at the chunk's first column, row stride ld) into
// shared memory (row stride dld). Thread (r_t = tid / 16, c_t = 4 (tid %
// 16)) of NTHR copies the 16-byte pieces at columns [c_t, c_t + 4) of
// rows r_t, r_t + NTHR / 16, ...; rows >= rows_valid, and every piece
// when !col_ok, are zero-filled (reading nothing: `base` is any valid
// address).
template <int ROWS, int NTHR>
__device__ __forceinline__ void copy_unit(float* dst, int dld,
                                          const float* src, int ld,
                                          int rows_valid, bool col_ok,
                                          int r_t, int c_t,
                                          const float* base) {
  constexpr int kStep = NTHR / 16;
  static_assert(ROWS % kStep == 0, "rows a pass");
#pragma unroll
  for (int m = 0; m < ROWS / kStep; ++m) {
    const int r = r_t + m * kStep;
    const bool ok = col_ok && r < rows_valid;
    cp_async16(dst + r * dld + c_t,
               ok ? src + static_cast<long long>(r) * ld + c_t : base, ok);
  }
}

// Splits in place the pieces of a B operand this thread copied with
// copy_unit<ROWS, NTHR> (same r_t, c_t): big halves over the raw values,
// small halves lo_off floats on. A thread sees its own cp.async copies
// once cp_async_wait returns, so no barrier comes between; one barrier
// after it publishes the whole tile. Each element is split once a block
// instead of once a warp.
template <int ROWS, int NTHR>
__device__ __forceinline__ void split_unit(float* T, int ld, int lo_off,
                                           int r_t, int c_t) {
  constexpr int kStep = NTHR / 16;
#pragma unroll
  for (int m = 0; m < ROWS / kStep; ++m) {
    float* at = T + (r_t + m * kStep) * ld + c_t;
    const float4 x = *reinterpret_cast<const float4*>(at);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    *reinterpret_cast<uint4*>(at) = big;
    *reinterpret_cast<uint4*>(at + lo_off) = small;
  }
}

// output columns a block holds: cols rounded up to n-tiles of 8, in
// steps of 4 n-tiles (the kernels' template argument)
__host__ __device__ inline int n_tiles(int cols) { return (cols + 31) / 32 * 4; }

// the checks every launch shares; returns false on a shape the kernels
// do not take
inline bool params_ok(int B, const Params& p) {
  if (p.hd <= 0 || p.hd % 8 != 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0) return false;
  if (p.cols <= 0 || p.cols % 8 != 0 || p.cols > kMaxCols) return false;
  if (p.col_blocks < 1 || p.col_blocks * p.cols < p.hd ||
      (p.col_blocks - 1) * p.cols >= p.hd)
    return false;
  // grids: (heads x column blocks, B, 64-row tiles of S); the backward
  // checks its (B x Hkv) axis itself
  return (p.S + 63) / 64 <= 65535 && B <= 65535 && p.kv_len >= 0 &&
         p.kv_len <= p.S;
}

}  // namespace tf32
