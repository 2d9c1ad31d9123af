// K4: flash-attention forward. O = softmax(Q K^T / sqrt(d)) V and the
// per-row logsumexp, over q, k, v of shape [BH, T, d] (row-major).
//
// Replaces diffsci_tpu/kernels/flash_attention.py:_fwd_kernel. See
// diffsci_tpu_torch/kernels/flash_attention.py for the design note.
//
// One block per (bh, tile of kBQ query rows); it loops over tiles of kBK
// keys staged in shared memory and keeps the online-softmax state (running
// max, running sum, output accumulator) in f32 registers. Four threads share
// a query row: each scores a quarter of the tile's keys and owns a quarter
// of the output columns. Ragged T is masked in the kernel, on query rows
// (never stored) and on keys (score -inf); head dims below the template's D
// are zero-padded in shared memory only.
//
// Tile constants, conversions and dispatch: flash_common.cuh, shared with
// K5/K6. Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles with row stride D + 4 (16-byte aligned rows, conflict-free
  // float4 reads), plus the P tile.
  return (kBQ + 2 * kBK) * (D + 4) + kBQ * kLDP;
}

// Logits are taken in the log2 domain: Q is pre-scaled by
// log2(e) / sqrt(d), so p = exp2(s - m) and lse = (m + log2 l) * ln 2.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq_len, int head_dim,
                     float scale_log2) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / (4 * kTPR);  // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;             // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;    // [kBK][LD]
  float* Ps = Vs + kBK * LD;    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int r = tid / kTPR;     // this thread's query row in the tile
  const int t = tid % kTPR;     // its lane within the row's group of four
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * seq_len * head_dim;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, cc = i % D, qi = q0 + rr;
    float val = 0.f;
    if (qi < seq_len && cc < head_dim)
      val = to_f32(q[base + (size_t)qi * head_dim + cc]) * scale_log2;
    Qs[rr * LD + cc] = val;
  }

  float m = -CUDART_INF_F, l = 0.f;
  float acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's K/V no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, cc = i % D, kj = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (kj < seq_len && cc < head_dim) {
        const size_t off = base + (size_t)kj * head_dim + cc;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[rr * LD + cc] = kv;
      Vs[rr * LD + cc] = vv;
    }
    __syncthreads();

    // scores of keys t, t + 4, t + 8, ... of this tile
    float s[kPT];
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) s[jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + c);
#pragma unroll
      for (int jj = 0; jj < kPT; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + (t + kTPR * jj) * LD + c);
        s[jj] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) {
      if (k0 + t + kTPR * jj >= seq_len) s[jj] = -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) {
      const float p = exp2f(s[jj] - m_new);
      Ps[r * kLDP + t + kTPR * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * CPT; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's four threads wrote its P entries

    // acc[chunk] += sum_j P[r][j] * V[j][chunk], chunk = t, t + 4, ...
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + r * kLDP + j);
      const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (j + u) * LD;
#pragma unroll
        for (int ch = 0; ch < CPT; ++ch) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * (t + kTPR * ch));
          acc[4 * ch + 0] += pj[u] * vv.x;
          acc[4 * ch + 1] += pj[u] * vv.y;
          acc[4 * ch + 2] += pj[u] * vv.z;
          acc[4 * ch + 3] += pj[u] * vv.w;
        }
      }
    }
    __syncwarp();  // P row read before the next tile overwrites it
  }

  const int qi = q0 + r;
  if (qi < seq_len) {
    const float inv_l = 1.f / l;
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int ch = 0; ch < CPT; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (t + kTPR * ch) + e;
        if (c < head_dim) o[row + c] = from_f32<T>(acc[4 * ch + e] * inv_l);
      }
    }
    if (t == 0)
      lse[(size_t)blockIdx.y * seq_len + qi] =
          (m + log2f(l)) * 0.69314718055994531f;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_len, int head_dim,
                   float scale_log2, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq_len, head_dim, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it); lse is
// f32 [bh, seq_len]. head_dim <= 128, bh <= 65535. Returns a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int seq_len,
                                int head_dim, float scale_log2, int dtype,
                                void* stream) {
  return (int)dispatch(dtype, head_dim, [&](auto type, auto dim) {
    return launch<typename decltype(type)::type, decltype(dim)::value>(
        q, k, v, o, lse, bh, seq_len, head_dim, scale_log2,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
