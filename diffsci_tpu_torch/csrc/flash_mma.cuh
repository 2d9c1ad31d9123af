// Tensor-core building blocks of the bf16 flash-attention kernels, K4
// (flash_attention.cu), K5 and K6 (flash_attention_bwd.cu). The f32
// kernels keep flash_common.cuh's FP32 tile layout, which this header does
// not touch.
//
// Every product is mma.sync.m16n8k16 with bf16 operands and f32
// accumulators. A warp owns a strip of 16 rows of the block's own tile
// (queries in K4 and K5, keys in K6); tiles of the other side stream through a
// double-buffered ring in shared memory filled by 16-byte cp.async copies.
// Shared tiles are bf16 [rows][D + 8]: the 16-byte pad puts the eight rows
// that one ldmatrix phase reads in eight distinct groups of four banks, for
// every D of 16, 32, 64 and 128 (and the 128-column chunks of the wide
// kernels, flash_common.cuh).
//
// The tile choices are macros with the committed values as defaults, so a
// variant builds with an nvcc -D flag (scripts/torch_flash_variants.py):
// FLASH_MMA_WARPS here, FLASH_FWD_KEYS in flash_attention.cu,
// FLASH_DQ_KEYS and FLASH_DKV_BQ32 in flash_attention_bwd.cu, and
// FLASH_EXACT_EXP2, which makes fast_exp2 call exp2f.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#ifndef FLASH_MMA_WARPS
#define FLASH_MMA_WARPS 4
#endif

namespace {

constexpr int kMmaWarps = FLASH_MMA_WARPS;   // warps per block
constexpr int kMmaThreads = 32 * kMmaWarps;  // 128
constexpr int kMmaRows = 16 * kMmaWarps;     // rows of the block's own tile

// row stride of a shared bf16 tile, in elements
template <int D>
constexpr int kMmaLd = D + 8;

// Whether 16-byte cp.async copies can stage rows of head_dim bf16 from
// every base pointer: rows and bases 16-byte aligned.
inline bool rows_aligned(int head_dim,
                         std::initializer_list<const void*> ptrs) {
  if (head_dim % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// ---- PTX wrappers ----------------------------------------------------------

// c += a b: a 16x16 (row-major A fragment), b 16x8 (col-major B fragment,
// two registers), c 16x8 f32.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives, of matrix j, in r[j]: row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: r[j] holds rows 2 (lane % 4) and 2 (lane % 4) + 1
// of column lane / 4 of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x on the special-function unit alone (ex2.approx.ftz: results below
// 2^-126 flush to zero, where a probability is negligible anyway); exp2f
// adds instructions on the FP32 pipe to keep such results.
__device__ __forceinline__ float fast_exp2(float x) {
#ifdef FLASH_EXACT_EXP2
  return exp2f(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

// 16 bytes global -> shared, asynchronous; zeros where !valid (nothing is
// read from gmem then, but it must still be a global address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until this thread's copies of every committed group have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- Fragment layouts ------------------------------------------------------
//
// m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16x16): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//              a[3] = (g+8, 2t+8..)
//   B (16x8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8):  c[0], c[1] = (g, 2t), (g, 2t+1); c[2], c[3] = (g+8, 2t), ...
// The lower column (or k) of a pair sits in the lower half of its register.

// Offset, in elements, of the row that this lane gives ldmatrix_x4 to load
// the A fragment of the 16x16 block at a tile's origin (row-major, stride
// LD): r = a[0..3].
__device__ __forceinline__ int a_frag_offset(int lane, int ld) {
  return (lane % 16) * ld + (lane / 16) * 8;
}

// For ldmatrix_x4 on a row-major [n][k] tile (rows are the B matrix's
// columns, as K's rows are for Q K^T): B fragments of two n8 tiles at one
// k16 step, r = {b0, b1} of n rows 0-7, then {b0, b1} of n rows 8-15.
__device__ __forceinline__ int b_frag_offset(int lane, int ld) {
  return ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
}

// For ldmatrix_x4_trans on a row-major [k][n] tile (as V's rows are for
// P V): B fragments of two n8 tiles at one k16 step, in the same order.
__device__ __forceinline__ int bt_frag_offset(int lane, int ld) {
  return ((lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 product operand from two f32 C fragments (its
// columns 0-7 and 8-15), rounded to bf16 in registers: the C layout of
// Q K^T is the A layout of P V, so P never leaves the registers.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stage rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of src
// [seq_len, head_dim] (bf16, row-major) into dst [ROWS][COLS + 8]; rows
// past seq_len and columns past head_dim are zero. kAsync: 16-byte cp.async
// copies, for rows that are 16-byte aligned (head_dim % 8 == 0, aligned
// base, c0 % 8 == 0); otherwise element loads and one 16-byte shared store
// per chunk, finished when the call returns.
template <int ROWS, int COLS, bool kAsync>
__device__ __forceinline__ void load_block(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int r0, int c0, int seq_len,
                                           int head_dim) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int rr = i / kChunks, cl = (i % kChunks) * 8, row = r0 + rr;
    const int c = c0 + cl;
    __nv_bfloat16* out = dst + rr * kMmaLd<COLS> + cl;
    if constexpr (kAsync) {
      const bool valid = row < seq_len && c < head_dim;
      cp_async_16(out, valid ? src + (size_t)row * head_dim + c : src, valid);
    } else {
      uint32_t w[4];
      for (int e = 0; e < 8; e += 2) {
        float lo = 0.f, hi = 0.f;
        if (row < seq_len) {
          const __nv_bfloat16* p = src + (size_t)row * head_dim + c + e;
          if (c + e < head_dim) lo = __bfloat162float(p[0]);
          if (c + e + 1 < head_dim) hi = __bfloat162float(p[1]);
        }
        w[e / 2] = pack_bf16(lo, hi);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// All of a row's head_dim columns, padded to D: dst [ROWS][D + 8].
template <int ROWS, int D, bool kAsync>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int seq_len,
                                          int head_dim) {
  load_block<ROWS, D, kAsync>(dst, src, r0, 0, seq_len, head_dim);
}

}  // namespace
