// K1: out = a[batch] * x + b[batch] * f over a flat [B, N] view.
//
// Replaces diffsci_tpu/kernels/fused_precondition.py:_axby_kernel (the
// Karras denoiser combine D = c_skip * x + c_out * F). See
// diffsci_tpu_torch/kernels/fused_precondition.py for the design note.
//
// Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One flat pass; the per-batch coefficients are read from [B] f32 arrays.
// __fmul_rn/__fadd_rn keep the two products and the sum separately rounded,
// exactly as the plain PyTorch version computes them (no FMA contraction).
template <typename TX, typename TF>
__global__ void axby_kernel(const TX* __restrict__ x, const TF* __restrict__ f,
                            const float* __restrict__ a,
                            const float* __restrict__ b, TX* __restrict__ out,
                            int64_t n_per_batch, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t batch = i / n_per_batch;
    const float ax = __fmul_rn(a[batch], load_f32(x + i));
    const float bf = __fmul_rn(b[batch], load_f32(f + i));
    store_f32(out + i, __fadd_rn(ax, bf));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // a few waves over 132 SMs

template <typename TX, typename TF>
cudaError_t launch(const void* x, const void* f, const void* a, const void* b,
                   void* out, int64_t n_per_batch, int64_t total,
                   cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  axby_kernel<TX, TF><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(f),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TX*>(out), n_per_batch, total);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int axby_launch(const void* x, const void* f, const void* a,
                           const void* b, void* out, long long n_per_batch,
                           long long total, int x_dtype, int f_dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && f_dtype == 0)
    return launch<float, float>(x, f, a, b, out, n_per_batch, total, s);
  if (x_dtype == 0 && f_dtype == 1)
    return launch<float, __nv_bfloat16>(x, f, a, b, out, n_per_batch, total, s);
  if (x_dtype == 1 && f_dtype == 0)
    return launch<__nv_bfloat16, float>(x, f, a, b, out, n_per_batch, total, s);
  if (x_dtype == 1 && f_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, f, a, b, out, n_per_batch,
                                                 total, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
