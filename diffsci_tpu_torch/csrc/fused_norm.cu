// K2: y = SiLU(norm(x) * w + b), per (batch, channel) over the spatial
// extent, on the NC* layout where each (b, c) is one contiguous row; and
// K3, its backward.
//
// Replaces diffsci_tpu/kernels/fused_norm.py:_fwd_kernel (K2) and
// _bwd_kernel (K3). See diffsci_tpu_torch/kernels/fused_norm.py for the
// design note.
//
// Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the block; every thread gets the total. blockDim.x is a multiple
// of 32 and at most 1024. The leading barrier keeps `red` from being
// overwritten while a previous call's partials are still being read.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per row. Pass 1: the sum, giving the mean ('ln' only).
// Pass 2: the centred sum of squares, giving rstd (the two-pass form).
// Pass 3: y. Passes 2 and 3 re-read a row the block has just read, which
// the 50 MB L2 serves for every row size on the path.
template <typename T>
__global__ void norm_silu_fwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     const T* __restrict__ b,
                                     T* __restrict__ y,
                                     float* __restrict__ mean_out,
                                     float* __restrict__ rstd_out, int channels,
                                     int64_t row_len, int subtract_mean,
                                     float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  const float inv_n = 1.f / (float)row_len;

  float mean = 0.f;
  if (subtract_mean) {
    float s = 0.f;
    for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x)
      s += to_f32(xr[i]);
    mean = block_sum(s, red) * inv_n;
  }
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    const float d = to_f32(xr[i]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_sum(ss, red) * inv_n + eps);

  const int c = (int)(row % channels);
  const float wc = to_f32(w[c]), bc = to_f32(b[c]);
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    const float u = (to_f32(xr[i]) - mean) * rstd * wc + bc;
    yr[i] = from_f32<T>(u / (1.f + expf(-u)));
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// K3: one block per row, reading the forward's mean and rstd. With
// n = (x - mean) * rstd, u = n * w + b and gu = g * SiLU'(u), dn = gu * w:
// pass 1 sums dn, dn * n, gu * n and gu over the row; pass 2 writes
// dx = rstd * (dn - mean(dn) - n * mean(dn * n)) ('rms' drops mean(dn)).
// The row's sums of gu * n and gu are its partials of dw and db; the sum
// over the batch is taken outside (one writer per output, no atomics).
template <typename T>
__global__ void norm_silu_bwd_kernel(const T* __restrict__ g,
                                     const T* __restrict__ x,
                                     const float* __restrict__ mean_in,
                                     const float* __restrict__ rstd_in,
                                     const T* __restrict__ w,
                                     const T* __restrict__ b,
                                     T* __restrict__ dx,
                                     float* __restrict__ dw_part,
                                     float* __restrict__ db_part,
                                     int channels, int64_t row_len,
                                     int subtract_mean) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* gr = g + row * row_len;
  const T* xr = x + row * row_len;
  T* dxr = dx + row * row_len;
  const float inv_n = 1.f / (float)row_len;
  const float mean = mean_in[row], rstd = rstd_in[row];
  const int c = (int)(row % channels);
  const float wc = to_f32(w[c]), bc = to_f32(b[c]);

  float s_dn = 0.f, s_dnn = 0.f, s_gun = 0.f, s_gu = 0.f;
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    const float n = (to_f32(xr[i]) - mean) * rstd;
    const float u = n * wc + bc;
    const float sg = 1.f / (1.f + expf(-u));
    const float gu = to_f32(gr[i]) * (sg * (1.f + u * (1.f - sg)));
    const float dn = gu * wc;
    s_dn += dn;
    s_dnn += dn * n;
    s_gun += gu * n;
    s_gu += gu;
  }
  const float m_dn = subtract_mean ? block_sum(s_dn, red) * inv_n : 0.f;
  const float m_dnn = block_sum(s_dnn, red) * inv_n;
  const float t_gun = block_sum(s_gun, red);
  const float t_gu = block_sum(s_gu, red);

  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    const float n = (to_f32(xr[i]) - mean) * rstd;
    const float u = n * wc + bc;
    const float sg = 1.f / (1.f + expf(-u));
    const float dn = to_f32(gr[i]) * (sg * (1.f + u * (1.f - sg))) * wc;
    dxr[i] = from_f32<T>(rstd * (dn - m_dn - n * m_dnn));
  }
  if (threadIdx.x == 0) {
    dw_part[row] = t_gun;
    db_part[row] = t_gu;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, int64_t rows, int channels,
                   int64_t row_len, int subtract_mean, float eps, int threads,
                   cudaStream_t stream) {
  norm_silu_fwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), channels, row_len, subtract_mean, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* mean,
                       const void* rstd, const void* w, const void* b,
                       void* dx, void* dw_part, void* db_part, int64_t rows,
                       int channels, int64_t row_len, int subtract_mean,
                       int threads, cudaStream_t stream) {
  norm_silu_bwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(dx),
      static_cast<float*>(dw_part), static_cast<float*>(db_part), channels,
      row_len, subtract_mean);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w, b and y share it).
// threads: a multiple of 32 in [32, 1024]. Returns a cudaError_t.
extern "C" int norm_silu_fwd_launch(const void* x, const void* w,
                                    const void* b, void* y, void* mean,
                                    void* rstd, long long rows, int channels,
                                    long long row_len, int subtract_mean,
                                    float eps, int dtype, int threads,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, b, y, mean, rstd, rows, channels, row_len,
                         subtract_mean, eps, threads, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, mean, rstd, rows, channels,
                                 row_len, subtract_mean, eps, threads, s);
  return (int)cudaErrorInvalidValue;
}

// K3. g, x, w, b and dx share the dtype code; mean, rstd, dw_part and
// db_part are f32 [rows]. Returns a cudaError_t.
extern "C" int norm_silu_bwd_launch(const void* g, const void* x,
                                    const void* mean, const void* rstd,
                                    const void* w, const void* b, void* dx,
                                    void* dw_part, void* db_part,
                                    long long rows, int channels,
                                    long long row_len, int subtract_mean,
                                    int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(g, x, mean, rstd, w, b, dx, dw_part, db_part,
                             rows, channels, row_len, subtract_mean, threads,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, mean, rstd, w, b, dx, dw_part,
                                     db_part, rows, channels, row_len,
                                     subtract_mean, threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
