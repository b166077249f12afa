// Shared machinery of the Hopper (sm_90a) flash-attention kernels for
// bf16 operands: flash_attention_sm90.cu (forward) and
// flash_attention_bwd_sm90.cu (backward).
//
// - TMA: host-built 3-D tensor maps over a (B * H, S, hd) bf16 tensor,
//   read in boxes of 64 columns x 64 rows with the 128-byte swizzle
//   (128 bytes is the widest inner box the swizzle allows: 64 bf16). A
//   64-row tile of hd columns is hd / 64 boxes of 8 KB, box after box.
//   The map's rows end at S, so a box that runs past S comes back
//   zero-filled and never reads the next head's rows: nothing is padded.
//   cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is
//   fetched through the runtime's entry-point query, so the library
//   links no libcuda.
// - mbarrier rings: "full" barriers that a TMA load completes, "empty"
//   barriers that each consumer warp arrives on once it is done with a
//   stage.
// - wgmma: m64nNk16 bf16 -> f32, A from shared memory (K-major, SS form)
//   or from registers (RS form), B from shared memory, K-major or
//   MN-major (the transposed-B bit, legal for 16-bit types).
// - The per-tile mask logic shared by both kernels: a tile wholly outside
//   the causal, window and kv_len masks is skipped, a tile wholly inside
//   takes no per-element mask, and only the tiles that straddle an edge
//   test each (query, key) pair.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTileRows = 64;              // rows of every TMA box and tile
constexpr int kBoxBytes = kTileRows * 128; // one 64 x 64 bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -3e38f;          // a masked raw score
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- host: tensor maps ---------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a contiguous (heads, rows, hd) bf16 tensor, boxes of 64 x 64.
// Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, const void* base, int hd, int rows,
                    long long heads) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, kTileRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---- device: shared memory, barriers, TMA --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box (64 columns from c0, 64 rows from c1, head c2) into shared
// memory at dst, completing `bar`'s transactions
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// a 64-row tile of hd columns: hd / 64 boxes, kBoxBytes apart
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int hd, int row,
                                              int head) {
  for (int c = 0; c < hd / 64; ++c)
    tma_load(dst + c * kBoxBytes, map, bar, 64 * c, row, head);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- device: wgmma -------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major (a row of a
// box holds 64 consecutive K values): sbo = 1024 bytes between groups of
// 8 rows, lbo unused. MN-major (a row holds 64 consecutive N values, rows
// run along K): sbo = 1024 bytes between groups of 8 K rows, lbo = the
// bytes between 64-wide N chunks (one box). Within a 128-byte swizzled
// row, the k-th 16-wide K slice of a K-major operand starts 32 k bytes in.
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_field(addr) | (desc_field(16) << 16) | (desc_field(1024) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_field(addr) | (desc_field(kBoxBytes) << 16) |
         (desc_field(1024) << 32) | (1ull << 62);
}

// K slice kk (16 wide) of a K-major 64-row tile whose boxes start at tile
__device__ __forceinline__ uint64_t kslice(uint32_t tile, int kk) {
  return desc_kmajor(tile + (kk >> 2) * kBoxBytes + (kk & 3) * 32);
}

// K slice kk (16 rows) of an MN-major 64-row tile
__device__ __forceinline__ uint64_t kslice_mn(uint32_t tile, int kk) {
  return desc_mnmajor(tile + kk * 16 * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one wrapper per wgmma shape the kernels issue, each operand spelled out
// d (64 x 64) += a (smem, K-major) * b (smem, K-major)^T; scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += a (registers, 64 x 16 bf16) * b (smem, MN-major); scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128) += a (registers, 64 x 16 bf16) * b (smem, MN-major); scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 256) += a (registers, 64 x 16 bf16) * b (smem, MN-major); scale_d 0 zeroes d first
__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[HD / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  if constexpr (HD == 64) wgmma_rs_m64n64_tb(d, a, db, scale_d);
  else if constexpr (HD == 128) wgmma_rs_m64n128_tb(d, a, db, scale_d);
  else wgmma_rs_m64n256_tb(d, a, db, scale_d);
}

// d (64 x 64) = a (64 x hd, K-major tile) b (64 x hd, K-major tile)^T
template <int HD>
__device__ __forceinline__ void gemm_abt(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_m64n64(d, kslice(a, kk), kslice(b, kk), kk > 0);
}

// d (64 x HD) += p (64 x 64 accumulator, as bf16 A fragments) b (64 x HD
// tile, MN-major)
template <int HD>
__device__ __forceinline__ void gemm_pb(float (&d)[HD / 2],
                                        const uint32_t (&p)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(d, p[kk], kslice_mn(b, kk), 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator as the bf16 A fragments of four k16 slices:
// the accumulator's register pairs are the A operand's, in order.
__device__ __forceinline__ void to_fragments(const float (&s)[32],
                                             uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// 2^x on the special-function unit (relative error ~2^-22; 0 for x far
// below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max (or min) and sum of one row's 16 values in a 64 x 64 accumulator
// (r = 0: registers 4 i, 4 i + 1; r = 1: 4 i + 2, 4 i + 3), as balanced
// trees
template <bool kMax>
__device__ __forceinline__ float row_extreme(const float (&s)[32], int r) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = kMax ? fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1])
                : fminf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i)
      v[i] = kMax ? fmaxf(v[i], v[i + w]) : fminf(v[i], v[i + w]);
  return v[0];
}

__device__ __forceinline__ float row_sum(const float (&s)[32], int r) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[4 * i + 2 * r] + s[4 * i + 2 * r + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] += v[i + w];
  return v[0];
}

// the max over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Accumulator layout (m64nN, per warpgroup thread t): warp w = t / 32 owns
// rows 16 w .. 16 w + 15; lane l holds rows 16 w + l / 4 (registers 4 i,
// 4 i + 1) and 16 w + l / 4 + 8 (4 i + 2, 4 i + 3), columns 8 i + 2 (l % 4)
// and the next, for i = 0 .. N / 8 - 1.
__device__ __forceinline__ int acc_row(int t, int e) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + ((e & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int t, int e) {
  return 8 * (e >> 2) + 2 * (t & 3) + (e & 1);
}

// ---- masks ---------------------------------------------------------------

struct Mask {
  int S;
  int causal;    // 0 or 1
  int window;    // 0: none
  int kv_len;    // keys at and past kv_len are masked (<= S)

  __device__ __forceinline__ bool visible(int i, int j) const {
    bool vis = j < kv_len;
    if (causal) vis = vis && j <= i;
    if (window > 0) vis = vis && j > i - window;
    return vis;
  }

  // queries [i0, i0 + 64) against keys [j0, j0 + 64), rows past S not
  // counted: 0 every pair masked, 1 every pair visible, 2 mixed
  __device__ __forceinline__ int tile(int i0, int j0) const {
    const int i1 = min(i0 + kTileRows, S) - 1;
    const int j1 = j0 + kTileRows - 1;
    if (i0 > i1 || j0 >= kv_len) return 0;
    if (causal && j0 > i1) return 0;
    if (window > 0 && j1 <= i0 - window) return 0;
    const bool all = j1 < kv_len && (!causal || j1 <= i0) &&
                     (window <= 0 || j0 > i1 - window);
    return all ? 1 : 2;
  }
};

}  // namespace sm90
