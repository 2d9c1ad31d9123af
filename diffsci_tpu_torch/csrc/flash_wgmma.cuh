// Hopper building blocks of the bf16 flash-attention kernels on wgmma:
// the narrow route (head dims 32 and 64, K4 also 128): K4's
// flash_fwd_narrow_kernel (flash_attention.cu), K5's
// flash_dq_narrow_kernel and K6's flash_dkv_narrow_kernel
// (flash_attention_bwd.cu); and the wide route
// (head dims above 128): K4's flash_fwd_wgmma_kernel, K5's
// flash_dq_wgmma_kernel and flash_dq_wgmma_pair_kernel and K6's
// flash_dkv_wgmma_kernel. They need sm_90a: TMA copies completing on
// mbarriers, wgmma on the warpgroup's tensor cores and setmaxnreg.
//
// Layout shared by all of them. Every operand tile in shared memory is a
// "slice": rows of one tensor (queries or keys) by 64 columns of d, 128
// bytes a row, with the 128-byte swizzle; at d 32 by 32 columns, 64 bytes
// a row, with the 64-byte swizzle. One TMA box of a 3-D tensor map
// [BH, T, d] writes it (encode_box), 1024-byte aligned. Rows past T and
// columns past d come in as zeros (the map's bounds), never from the next
// head. The wide route's slices are 64 x 64 (8 KB); the narrow route's
// hold a whole tile of 64 to 192 rows. wgmma reads a slice in two ways
// (desc_rows):
// - K-major (the contraction runs along d: Q K^T, dO V^T, K Q^T, V dO^T):
//   the descriptor's start moves 32 bytes a k16 step inside the swizzled
//   row; 8-row groups lie 8 rows apart (SBO: 1024 or 512 bytes).
// - MN-major (the contraction runs along the rows: P V, dS K, P^T dO,
//   dS^T Q): the B operand is transposed by the descriptor (imm-trans-b);
//   a k16 step is 16 rows (2048 or 1024 bytes); the slice's columns are N.
// Every product is wgmma m64nNk16 with f32 accumulators: a warpgroup owns
// 64 rows of its own side. In the accumulator of m64nNk16 thread (warp w,
// lane = 4 g + t) holds rows 16 w + g and 16 w + g + 8, and of each
// 8-column block i the columns 8 i + 2 t and 8 i + 2 t + 1: d[4 i + 0..1]
// the first row, d[4 i + 2..3] the second, the m16n8 C layout of mma.sync
// repeated across N. So the quad-shuffle row reductions of the mma.sync
// kernels hold, and the A operand of the next product, taken from
// registers (k16 step kk: the same layout as mma.sync's m16n8k16 A),
// packs blocks 2 kk and 2 kk + 1 (a_from_acc).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kSlice = 64;             // rows and columns of a slice
constexpr int kSliceBytes = 64 * 128;  // 8 KB
constexpr int kWgThreads = 128;        // a warpgroup
// The largest head dim of the wgmma route: Q (K4), Q and dO (K5) or K and
// V (K6) stay in shared memory over the whole d. Above it the mma.sync
// wide kernels. A build with -DFLASH_WGMMA_MAX_DIM=128 sends every head
// dim to those (scripts/torch_flash_wide.py times the two routes side by
// side).
#ifndef FLASH_WGMMA_MAX_DIM
#define FLASH_WGMMA_MAX_DIM 512
#endif
constexpr int kWgmmaMaxDim = FLASH_WGMMA_MAX_DIM;
// dynamic shared memory a block may ask for on the H100 (227 KB)
constexpr int kMaxSmem = 232448;

// The wgmma route: bf16 rows of head_dim in (128, kWgmmaMaxDim] that TMA
// can read (16-byte aligned rows and bases).
inline bool wgmma_route(int head_dim,
                        std::initializer_list<const void*> ptrs) {
  return head_dim > 128 && head_dim <= kWgmmaMaxDim &&
         rows_aligned(head_dim, ptrs);
}

// The narrow route: bf16 rows of head_dim 32 or 64 (K4: also 128; K5 and
// K6 ask with max_dim 64) that TMA can read; every other head dim up to
// 128 stays on the mma.sync kernels. A build with
// -DFLASH_WGMMA_MIN_DIM=129 sends every head dim up to 128 to those
// (scripts/torch_flash_variants.py --set narrow times the two routes side
// by side).
#ifndef FLASH_WGMMA_MIN_DIM
#define FLASH_WGMMA_MIN_DIM 32
#endif
constexpr int kWgmmaMinDim = FLASH_WGMMA_MIN_DIM;
inline bool narrow_route(int head_dim, int max_dim,
                         std::initializer_list<const void*> ptrs) {
  return head_dim >= kWgmmaMinDim && head_dim <= max_dim &&
         (head_dim == 32 || head_dim == 64 || head_dim == 128) &&
         rows_aligned(head_dim, ptrs);
}
// A narrow operand's slices: 32 columns at D 32 (64-byte rows, 64-byte
// swizzle), else 64 (128-byte rows, 128-byte swizzle); D / cols of them.
template <int D>
constexpr int kNarrowCols = D == 32 ? 32 : 64;
template <int D>
constexpr int kNarrowSlices = D / kNarrowCols<D>;
// A narrow kernel with NWG consumer warpgroups and one producer: the
// blocks an SM holds (two at NWG 1), and the registers a consumer thread
// takes once the producer warpgroup has given back all but 24 of its own
// (65536 / (blocks x threads) a thread on average, rounded down to 8).
template <int NWG>
constexpr int kNarrowBlocks = NWG == 1 ? 2 : 1;
template <int NWG>
constexpr int kNarrowRegs = NWG == 1 ? 232 : NWG == 2 ? 240 : 160;

// Chunks of the output's columns: one pass (one chunk) up to d 256,
// otherwise ceil(d / 256) chunks (grid z) of DC = 64 * boxes columns.
inline int wgmma_chunks(int head_dim) { return (head_dim + 255) / 256; }
inline int wgmma_boxes(int head_dim) {
  const int n = wgmma_chunks(head_dim);
  return ((head_dim + n - 1) / n + kSlice - 1) / kSlice;  // 3 or 4
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query so that the library needs no -lcuda.
inline cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A map of one bf16 tensor [bh, seq_len, head_dim] read in boxes of
// box_rows rows by box_cols columns (64: the 128-byte swizzle; 32: the
// 64-byte swizzle); out-of-bounds rows and columns read as zero. Encoded
// at every launch from the call's own pointer (under a CUDA graph capture
// it is frozen with the captured buffers, as the pointers are).
inline cudaError_t encode_box(CUtensorMap* map, const void* base, int bh,
                              int seq_len, int head_dim, int box_cols,
                              int box_rows) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)head_dim, (cuuint64_t)seq_len,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)head_dim * 2,
                                 (cuuint64_t)seq_len * head_dim * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wide route's map: 64 x 64 boxes.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int bh,
                               int seq_len, int head_dim) {
  return encode_box(map, base, bh, seq_len, head_dim, kSlice, kSlice);
}

// ---- device: barriers and copies ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `phase` has completed (a fresh barrier
// counts its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// The box of `map` at (column, row, bh) into the slice at `dst`;
// completes on `bar`.
__device__ __forceinline__ void tma_slice(uint32_t dst, const CUtensorMap* map,
                                          int col, int row, int bh,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// Named barriers between the two consumer warpgroups (256 threads); id 0
// is __syncthreads'.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- device: wgmma -------------------------------------------------------

// Descriptor of a swizzled (128-byte) operand at shared address `addr`:
// 8-row groups 1024 bytes apart (SBO); LBO, the stride between 64-column
// blocks of an MN-major operand, is one slice (unused at N = 64).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kSliceBytes >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
// k16 steps, added to a descriptor: K-major 32 bytes, MN-major 16 rows.
constexpr uint64_t kStepK = 32 >> 4;
constexpr uint64_t kStepMN = 2048 >> 4;

// Descriptor of a narrow slice at shared address `addr` whose rows are
// RB = 128 (128-byte swizzle) or 64 bytes (64-byte swizzle): 8-row groups
// 8 RB bytes apart (SBO). A K-major k16 step adds kStepK; an MN-major
// one, 16 rows, adds 16 RB bytes, RB in the descriptor's 16-byte units.
template <int RB>
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr) {
  static_assert(RB == 64 || RB == 128, "64- or 128-byte rows");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * RB) >> 4) << 32) |
         ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the
// wgmma_wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, A and B both from shared memory, K-major; d = A B when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B, A (bf16, m64 x k16) from registers in the layout above, B from
// shared memory MN-major (transposed by the descriptor).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (+)= A B at N = 128, A and B from shared memory, K-major; d = A B when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B at N = 32, A (bf16) from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// The A operands (bf16) of the KS k16 steps of a product whose A is the
// 64 x 16 KS accumulator c: step kk takes c's 8-column blocks 2 kk and
// 2 kk + 1.
template <int KS>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[KS][4],
                                           const float (&c)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

}  // namespace
