// K1: out = a[batch] * x + b[batch] * f over a flat [B, N] view.
// K7: out = a[batch] * x + b[batch] * f + c[batch] * g, likewise.
//
// K1 replaces diffsci_tpu/kernels/fused_precondition.py:_axby_kernel (the
// Karras denoiser combine D = c_skip * x + c_out * F), K7 _lincomb3_kernel
// (the DDPM/DDIM update). See diffsci_tpu_torch/kernels/fused_precondition.py
// for the design note.
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

// One flat pass each; the per-batch coefficients are read from [B] f32
// arrays. __fmul_rn/__fadd_rn keep every product and sum separately rounded,
// in the order the plain PyTorch version computes them (no FMA contraction):
// K1 a*x + b*f, K7 (a*x + b*f) + c*g.
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

template <typename TX, typename TF, typename TG>
__global__ void lincomb3_kernel(const TX* __restrict__ x,
                                const TF* __restrict__ f,
                                const TG* __restrict__ g,
                                const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ c,
                                TX* __restrict__ out, int64_t n_per_batch,
                                int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t batch = i / n_per_batch;
    const float ax = __fmul_rn(a[batch], load_f32(x + i));
    const float bf = __fmul_rn(b[batch], load_f32(f + i));
    const float cg = __fmul_rn(c[batch], load_f32(g + i));
    store_f32(out + i, __fadd_rn(__fadd_rn(ax, bf), cg));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // a few waves over 132 SMs

unsigned blocks_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename TX, typename TF>
cudaError_t launch_axby(const void* x, const void* f, const void* a,
                        const void* b, void* out, int64_t n_per_batch,
                        int64_t total, cudaStream_t stream) {
  axby_kernel<TX, TF><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(f),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TX*>(out), n_per_batch, total);
  return cudaGetLastError();
}

template <typename TX, typename TF, typename TG>
cudaError_t launch_lincomb3(const void* x, const void* f, const void* g,
                            const void* a, const void* b, const void* c,
                            void* out, int64_t n_per_batch, int64_t total,
                            cudaStream_t stream) {
  lincomb3_kernel<TX, TF, TG><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(f),
      static_cast<const TG*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<TX*>(out), n_per_batch, total);
  return cudaGetLastError();
}

// Every dtype combination, indexed by the dtype codes (0 = float32,
// 1 = bfloat16) of x, f (and g).
using bf16 = __nv_bfloat16;
using AxbyFn = cudaError_t (*)(const void*, const void*, const void*,
                               const void*, void*, int64_t, int64_t,
                               cudaStream_t);
using Lincomb3Fn = cudaError_t (*)(const void*, const void*, const void*,
                                   const void*, const void*, const void*,
                                   void*, int64_t, int64_t, cudaStream_t);
const AxbyFn kAxby[2][2] = {
    {launch_axby<float, float>, launch_axby<float, bf16>},
    {launch_axby<bf16, float>, launch_axby<bf16, bf16>}};
const Lincomb3Fn kLincomb3[2][2][2] = {
    {{launch_lincomb3<float, float, float>, launch_lincomb3<float, float, bf16>},
     {launch_lincomb3<float, bf16, float>, launch_lincomb3<float, bf16, bf16>}},
    {{launch_lincomb3<bf16, float, float>, launch_lincomb3<bf16, float, bf16>},
     {launch_lincomb3<bf16, bf16, float>, launch_lincomb3<bf16, bf16, bf16>}}};

bool valid_code(int code) { return code == 0 || code == 1; }

}  // namespace

// Each returns a cudaError_t.
extern "C" int axby_launch(const void* x, const void* f, const void* a,
                           const void* b, void* out, long long n_per_batch,
                           long long total, int x_dtype, int f_dtype,
                           void* stream) {
  if (!valid_code(x_dtype) || !valid_code(f_dtype))
    return (int)cudaErrorInvalidValue;
  return kAxby[x_dtype][f_dtype](x, f, a, b, out, n_per_batch, total,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lincomb3_launch(const void* x, const void* f, const void* g,
                               const void* a, const void* b, const void* c,
                               void* out, long long n_per_batch,
                               long long total, int x_dtype, int f_dtype,
                               int g_dtype, void* stream) {
  if (!valid_code(x_dtype) || !valid_code(f_dtype) || !valid_code(g_dtype))
    return (int)cudaErrorInvalidValue;
  return kLincomb3[x_dtype][f_dtype][g_dtype](
      x, f, g, a, b, c, out, n_per_batch, total,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
