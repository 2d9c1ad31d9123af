// Shared by the flash-attention kernels, K4 (flash_attention.cu) and K5/K6
// (flash_attention_bwd.cu): the tile layout of their float32 kernels and
// the dispatch from the dtype code and head dim to the kernels' template
// arguments. A change to either reaches all three kernels.

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
// zero-padded in shared memory only).
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& launch) {
  if (dtype == 0) return dispatch_dim<float>(head_dim, launch);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(head_dim, launch);
  return cudaErrorInvalidValue;
}

}  // namespace
