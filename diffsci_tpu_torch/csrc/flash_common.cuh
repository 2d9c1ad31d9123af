// Shared by the flash-attention kernels, K4 (flash_attention.cu) and K5/K6
// (flash_attention_bwd.cu): the tile layout of their float32 kernels and
// the dispatch from the dtype code and head dim to the kernels' template
// arguments, and the chunking of the mma.sync and f32 wide kernels
// (head_dim > 128). A change to any of them reaches all three kernels.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace {

// Square tiles: a block owns kBQ query rows (K4, K5) or kBK key rows (K6)
// and loops over tiles of the other side; kTPR threads share a row of the
// block's own tile, each scoring kPT rows of the other tile and owning a
// kTPR-th of the output columns.
constexpr int kBQ = 64;                // query rows per tile
constexpr int kBK = 64;                // key rows per tile
constexpr int kTPR = 4;                // threads per row of the own tile
constexpr int kThreads = kBQ * kTPR;   // 256
constexpr int kPT = kBK / kTPR;        // other-tile rows scored per thread
constexpr int kLDP = kBK + 4;          // row stride of the P / dS tiles
static_assert(kBQ == kBK, "K5 and K6 share one tile size for both sides");

// Head dims above 128 go to the wide kernels. In bf16, rows that TMA can
// read (d % 8 == 0, 16-byte aligned bases) up to d 512 take K4's, K5's
// and K6's wgmma kernels (flash_wgmma.cuh): the scores once per tile up to
// d 256, twice at most above. Everything else above 128 (f32, unaligned
// bf16 rows, d > 512) takes the kernels chunked here, one per K4, K5, K6
// and dtype, which take any head_dim: a block owns one kWideCols-column
// chunk of the output (blockIdx.z), and S = Q K^T (and dP = dO V^T) are
// summed over chunks of kWideCols columns of d staged one at a time, so
// shared memory and registers do not grow with d. Each
// block recomputes the full scores of its rows, so the score work grows
// with the number of chunks (⌈d/128⌉ times). The bf16 ones stream
// kWideKeys rows of the other side a step; the f32 ones keep kBQ / kBK.
constexpr int kWideCols = 128;
constexpr int kWideKeys = 32;
constexpr int kWideLdF = kWideCols + 4;  // f32 chunk row stride

inline int wide_chunks(int head_dim) {
  return (head_dim + kWideCols - 1) / kWideCols;
}

// f32: stage rows [r0, r0 + kBK) and columns [c0, c0 + kWideCols) of src
// [seq_len, head_dim] into dst [kBK][kWideLdF] times mul; rows past seq_len
// and columns past head_dim are 0.
__device__ __forceinline__ void stage_cols(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int c0, int seq_len,
                                           int head_dim, float mul) {
  for (int i = threadIdx.x; i < kBK * kWideCols; i += kThreads) {
    const int rr = i / kWideCols, cc = i % kWideCols;
    const int ri = r0 + rr, ci = c0 + cc;
    float val = 0.f;
    if (ri < seq_len && ci < head_dim)
      val = src[(size_t)ri * head_dim + ci] * mul;
    dst[rr * kWideLdF + cc] = val;
  }
}

template <typename T>
struct Type {
  using type = T;
};
template <int D>
using Dim = std::integral_constant<int, D>;

template <typename T, typename F>
cudaError_t dispatch_dim(int head_dim, F& launch) {
  if (head_dim <= 16) return launch(Type<T>{}, Dim<16>{});
  if (head_dim <= 32) return launch(Type<T>{}, Dim<32>{});
  if (head_dim <= 64) return launch(Type<T>{}, Dim<64>{});
  if (head_dim <= 128) return launch(Type<T>{}, Dim<128>{});
  return cudaErrorInvalidValue;
}

// Calls launch(Type<T>{}, Dim<D>{}): T is the storage type of the dtype
// code (0 = float32, 1 = bfloat16), D the smallest head-dim template of
// 16, 32, 64, 128 that holds head_dim (columns past head_dim are
// zero-padded in shared memory only). Head dims above 128 never get here:
// the launchers send them to the wide kernels.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& launch) {
  if (dtype == 0) return dispatch_dim<float>(head_dim, launch);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(head_dim, launch);
  return cudaErrorInvalidValue;
}

}  // namespace
