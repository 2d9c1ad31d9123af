// K1: out = a[row] * x + b[row] * f over a [B, N] view.
// K7: out = a[row] * x + b[row] * f + c[row] * g, likewise.
//
// K1 replaces diffsci_tpu/kernels/fused_precondition.py:_axby_kernel (the
// Karras denoiser combine D = c_skip * x + c_out * F), K7 _lincomb3_kernel
// (the DDPM/DDIM update). See diffsci_tpu_torch/kernels/fused_precondition.py
// for the design note.
//
// Rows on the grid: blockIdx.y is the row (the batch index), blockIdx.x a
// chunk of it, so a thread reads its row's coefficients once, beside its
// first data loads, and no index is divided by N. A thread combines the
// neighbouring elements of one 16-byte word of x and out (4 in f32, 8 in
// bf16), with word loads and stores of each operand whose row starts on a
// word boundary and an element path for the others and for the end of a
// row.
//
// Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// The bytes of x (and out) a thread combines, one 16-byte word; the most
// threads of a CTA; and the CTAs a launch aims at. nvcc -D overrides them
// (scripts/torch_precond_variants.py, which measured the choices).
#ifndef PRECOND_X_BYTES
#define PRECOND_X_BYTES 16
#endif
#ifndef PRECOND_THREADS
#define PRECOND_THREADS 512
#endif
#ifndef PRECOND_CTAS
#define PRECOND_CTAS 64
#endif

namespace {

constexpr int kXBytes = PRECOND_X_BYTES;
constexpr int kMaxThreads = PRECOND_THREADS;
constexpr uint32_t kMinThreads = 64;
constexpr uint32_t kTargetCtas = PRECOND_CTAS;
constexpr unsigned kMaxGridY = 65535;
static_assert(kXBytes == 16 || kXBytes == 32 || kXBytes == 64,
              "PRECOND_X_BYTES must be 16, 32 or 64");
static_assert(kMaxThreads % 32 == 0 && kMaxThreads >= (int)kMinThreads &&
                  kMaxThreads <= 1024,
              "PRECOND_THREADS must be a multiple of 32 in 64..1024");
static_assert(kTargetCtas >= 1, "PRECOND_CTAS must be at least 1");

using bf16 = __nv_bfloat16;

// The elements a thread combines: those of its kXBytes of x.
template <typename TX>
constexpr int kElems = kXBytes / (int)sizeof(TX);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// A thread's N elements of one operand move as words of 16 bytes (8 bytes
// for 4 bf16 elements beside f32 x); the vector path needs the row's base
// on a word boundary.
template <typename T, int N>
struct Words {
  static constexpr int kBytes = N * (int)sizeof(T);
  using W = typename std::conditional<kBytes % 16 == 0, uint4, uint2>::type;
  static constexpr int kCount = kBytes / (int)sizeof(W);
  __device__ __forceinline__ static bool aligned(const T* row) {
    return ((uintptr_t)row & (sizeof(W) - 1)) == 0;
  }
};

// v[i] = row[off + i] as f32 (0 past the row's end n).
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ row, uint32_t off,
                                     uint32_t n, float (&v)[N]) {
  using Wd = Words<T, N>;
  if (Wd::aligned(row) && off + N <= n) {
    typename Wd::W w[Wd::kCount];
    const typename Wd::W* src =
        reinterpret_cast<const typename Wd::W*>(row + off);
#pragma unroll
    for (int i = 0; i < Wd::kCount; ++i) w[i] = __ldg(src + i);
    const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = off + i < n ? to_f32(row[off + i]) : 0.f;
  }
}

// row[off + i] = v[i] for the elements before the row's end n.
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ row, uint32_t off,
                                      uint32_t n, const float (&v)[N]) {
  using Wd = Words<T, N>;
  if (Wd::aligned(row) && off + N <= n) {
    typename Wd::W w[Wd::kCount];
    T* e = reinterpret_cast<T*>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(v[i]);
    typename Wd::W* dst = reinterpret_cast<typename Wd::W*>(row + off);
#pragma unroll
    for (int i = 0; i < Wd::kCount; ++i) dst[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (off + i < n) row[off + i] = from_f32<T>(v[i]);
  }
}

// __fmul_rn/__fadd_rn keep every product and sum separately rounded, in the
// order the plain PyTorch version computes them (no FMA contraction): K1
// a*x + b*f, K7 (a*x + b*f) + c*g. Rows beyond gridDim.y (more than 65535)
// come round again.
template <typename TX, typename TF>
__global__ void __launch_bounds__(kMaxThreads)
    axby_kernel(const TX* __restrict__ x, const TF* __restrict__ f,
                const float* __restrict__ a, const float* __restrict__ b,
                TX* __restrict__ out, uint32_t n, uint32_t rows) {
  constexpr int N = kElems<TX>;
  const uint32_t off = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (off >= n) return;
  for (uint32_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t base = (size_t)r * n;
    const float ca = __ldg(a + r), cb = __ldg(b + r);
    float vx[N], vf[N];
    load(x + base, off, n, vx);
    load(f + base, off, n, vf);
#pragma unroll
    for (int i = 0; i < N; ++i)
      vx[i] = __fadd_rn(__fmul_rn(ca, vx[i]), __fmul_rn(cb, vf[i]));
    store(out + base, off, n, vx);
  }
}

template <typename TX, typename TF, typename TG>
__global__ void __launch_bounds__(kMaxThreads)
    lincomb3_kernel(const TX* __restrict__ x, const TF* __restrict__ f,
                    const TG* __restrict__ g, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ c,
                    TX* __restrict__ out, uint32_t n, uint32_t rows) {
  constexpr int N = kElems<TX>;
  const uint32_t off = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (off >= n) return;
  for (uint32_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t base = (size_t)r * n;
    const float ca = __ldg(a + r), cb = __ldg(b + r), cc = __ldg(c + r);
    float vx[N], vf[N], vg[N];
    load(x + base, off, n, vx);
    load(f + base, off, n, vf);
    load(g + base, off, n, vg);
#pragma unroll
    for (int i = 0; i < N; ++i)
      vx[i] = __fadd_rn(__fadd_rn(__fmul_rn(ca, vx[i]), __fmul_rn(cb, vf[i])),
                        __fmul_rn(cc, vg[i]));
    store(out + base, off, n, vx);
  }
}

// The launch: as many CTAs a row as bring the launch to kTargetCtas, within
// kMinThreads..kMaxThreads threads a CTA, and a row's threads split evenly
// over its CTAs in whole warps. At the main paths' sizes a launch is one
// wave of 4 to 64 CTAs in which each thread makes one round of loads; at
// large sizes the CTAs have kMaxThreads threads.
struct Launch {
  dim3 grid, block;
};

uint32_t ceil_div(uint32_t a, uint32_t b) { return (a + b - 1) / b; }

template <typename TX>
Launch launch_for(uint32_t n, uint32_t rows) {
  const uint32_t lanes = ceil_div(n, kElems<TX>);
  uint32_t ctas = ceil_div(kTargetCtas, rows);
  if (ctas < ceil_div(lanes, kMaxThreads)) ctas = ceil_div(lanes, kMaxThreads);
  if (ctas > ceil_div(lanes, kMinThreads)) ctas = ceil_div(lanes, kMinThreads);
  const uint32_t threads = ceil_div(ceil_div(lanes, ctas), 32) * 32;
  return {dim3(ctas, rows < kMaxGridY ? rows : kMaxGridY), dim3(threads)};
}

template <typename TX, typename TF>
cudaError_t launch_axby(const void* x, const void* f, const void* a,
                        const void* b, void* out, uint32_t n, uint32_t rows,
                        cudaStream_t stream) {
  const Launch l = launch_for<TX>(n, rows);
  axby_kernel<TX, TF><<<l.grid, l.block, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(f),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TX*>(out), n, rows);
  return cudaGetLastError();
}

template <typename TX, typename TF, typename TG>
cudaError_t launch_lincomb3(const void* x, const void* f, const void* g,
                            const void* a, const void* b, const void* c,
                            void* out, uint32_t n, uint32_t rows,
                            cudaStream_t stream) {
  const Launch l = launch_for<TX>(n, rows);
  lincomb3_kernel<TX, TF, TG><<<l.grid, l.block, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TF*>(f),
      static_cast<const TG*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<TX*>(out), n, rows);
  return cudaGetLastError();
}

// Every dtype combination, indexed by the dtype codes (0 = float32,
// 1 = bfloat16) of x, f (and g).
using AxbyFn = cudaError_t (*)(const void*, const void*, const void*,
                               const void*, void*, uint32_t, uint32_t,
                               cudaStream_t);
using Lincomb3Fn = cudaError_t (*)(const void*, const void*, const void*,
                                   const void*, const void*, const void*,
                                   void*, uint32_t, uint32_t, cudaStream_t);
const AxbyFn kAxby[2][2] = {
    {launch_axby<float, float>, launch_axby<float, bf16>},
    {launch_axby<bf16, float>, launch_axby<bf16, bf16>}};
const Lincomb3Fn kLincomb3[2][2][2] = {
    {{launch_lincomb3<float, float, float>, launch_lincomb3<float, float, bf16>},
     {launch_lincomb3<float, bf16, float>, launch_lincomb3<float, bf16, bf16>}},
    {{launch_lincomb3<bf16, float, float>, launch_lincomb3<bf16, float, bf16>},
     {launch_lincomb3<bf16, bf16, float>, launch_lincomb3<bf16, bf16, bf16>}}};

bool valid_code(int code) { return code == 0 || code == 1; }

// A row's offsets, and the row index, are 32-bit with room to spare.
bool valid_shape(long long n_per_batch, long long total) {
  return n_per_batch > 0 && total % n_per_batch == 0 &&
         n_per_batch <= (1LL << 31) && total / n_per_batch <= (1LL << 31);
}

}  // namespace

// Each returns a cudaError_t.
extern "C" int axby_launch(const void* x, const void* f, const void* a,
                           const void* b, void* out, long long n_per_batch,
                           long long total, int x_dtype, int f_dtype,
                           void* stream) {
  if (!valid_code(x_dtype) || !valid_code(f_dtype) ||
      !valid_shape(n_per_batch, total))
    return (int)cudaErrorInvalidValue;
  return kAxby[x_dtype][f_dtype](x, f, a, b, out, (uint32_t)n_per_batch,
                                 (uint32_t)(total / n_per_batch),
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lincomb3_launch(const void* x, const void* f, const void* g,
                               const void* a, const void* b, const void* c,
                               void* out, long long n_per_batch,
                               long long total, int x_dtype, int f_dtype,
                               int g_dtype, void* stream) {
  if (!valid_code(x_dtype) || !valid_code(f_dtype) || !valid_code(g_dtype) ||
      !valid_shape(n_per_batch, total))
    return (int)cudaErrorInvalidValue;
  return kLincomb3[x_dtype][f_dtype][g_dtype](
      x, f, g, a, b, c, out, (uint32_t)n_per_batch,
      (uint32_t)(total / n_per_batch), static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
