// K5 and K6: flash-attention backward over q, k, v, dO of shape [BH, T, d]
// (row-major), with the forward's natural-log lse [BH, T] and
// delta = rowsum(dO * O) [BH, T] (both f32). P is recomputed from lse:
//   P = exp(s - lse), s = q k^T / sqrt(d);  dS = P * (dO v^T - delta)
//   K5: dQ = dS K / sqrt(d)
//   K6: dK = dS^T Q / sqrt(d),  dV = P^T dO
//
// Replaces diffsci_tpu/kernels/flash_attention.py:_dq_kernel (K5) and
// _dkv_kernel (K6). See diffsci_tpu_torch/kernels/flash_attention.py for the
// design note.
//
// K5: one block per (bh, tile of kBQ query rows) loops over tiles of kBK
// keys. K6: one block per (bh, tile of kBK key rows) loops over tiles of
// kBQ queries. Either way each output tile has one block as its only
// writer and sums in f32 registers: no atomics. Four threads share a row
// of the block's own tile; each scores a quarter of the other tile's rows
// and owns a quarter of the output columns, as in K4. Scores are taken in
// the log2 domain (one side pre-scaled by log2(e)/sqrt(d), lse by log2(e)).
// Ragged T is masked in the kernel: rows past T are loaded as zeros, get
// P = 0 and are never stored. Head dims below the template's D are
// zero-padded in shared memory only.
//
// Tile constants, conversions and dispatch: flash_common.cuh, shared with
// K4. Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Stage rows [r0, r0 + kBK) of src [seq_len, head_dim] into dst
// [kBK][D + 4] as f32 times `mul`; rows past seq_len and columns past
// head_dim are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int seq_len, int head_dim,
                                      float mul) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int rr = i / D, cc = i % D, ri = r0 + rr;
    float val = 0.f;
    if (ri < seq_len && cc < head_dim)
      val = to_f32(src[(size_t)ri * head_dim + cc]) * mul;
    dst[rr * LD + cc] = val;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles and dS
  return (2 * kBQ + 2 * kBK) * (D + 4) + kBQ * kLDP;
}

template <int D>
constexpr int dkv_smem_floats() {
  // K, V (own), Q, dO tiles, P and dS, lse and delta of the query tile
  return (2 * kBK + 2 * kBQ) * (D + 4) + 2 * kBK * kLDP + 2 * kBQ;
}

// K5. acc[chunk] accumulates row r's dQ over columns 4 * (t + kTPR * ch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq_len, int head_dim, float scale) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / (4 * kTPR);  // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;              // [kBQ][LD], times log2(e) * scale
  float* dOs = Qs + kBQ * LD;    // [kBQ][LD]
  float* Ks = dOs + kBQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][LD]
  float* dSs = Vs + kBK * LD;    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + r;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;

  stage<T, D>(Qs, q + base, q0, seq_len, head_dim, kLog2e * scale);
  stage<T, D>(dOs, dout + base, q0, seq_len, head_dim, 1.f);
  const float lse2 = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
  const float dl = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;

  float acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kBK) {
    __syncthreads();  // Q, dO staged; the previous K/V tile no longer read
    stage<T, D>(Ks, k + base, k0, seq_len, head_dim, 1.f);
    stage<T, D>(Vs, v + base, k0, seq_len, head_dim, 1.f);
    __syncthreads();

    // scores and dP of keys t, t + 4, t + 8, ... of this tile
    float s[kPT], dp[kPT];
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + c);
      const float4 ov = *reinterpret_cast<const float4*>(dOs + r * LD + c);
#pragma unroll
      for (int jj = 0; jj < kPT; ++jj) {
        const int j = t + kTPR * jj;
        const float4 kv = *reinterpret_cast<const float4*>(Ks + j * LD + c);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * LD + c);
        s[jj] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        dp[jj] += ov.x * vv.x + ov.y * vv.y + ov.z * vv.z + ov.w * vv.w;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) {
      const int j = t + kTPR * jj;
      const float p = k0 + j < seq_len ? exp2f(s[jj] - lse2) : 0.f;
      dSs[r * kLDP + j] = p * (dp[jj] - dl);
    }
    __syncwarp();  // the row's four threads wrote its dS entries

    // acc[chunk] += sum_j dS[r][j] * K[j][chunk]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(dSs + r * kLDP + j);
      const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = Ks + (j + u) * LD;
#pragma unroll
        for (int ch = 0; ch < CPT; ++ch) {
          const float4 kv =
              *reinterpret_cast<const float4*>(krow + 4 * (t + kTPR * ch));
          acc[4 * ch + 0] += sj[u] * kv.x;
          acc[4 * ch + 1] += sj[u] * kv.y;
          acc[4 * ch + 2] += sj[u] * kv.z;
          acc[4 * ch + 3] += sj[u] * kv.w;
        }
      }
    }
    __syncwarp();  // dS row read before the next tile overwrites it
  }

  if (qi < seq_len) {
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int ch = 0; ch < CPT; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (t + kTPR * ch) + e;
        if (c < head_dim) dq[row + c] = from_f32<T>(acc[4 * ch + e] * scale);
      }
    }
  }
}

// K6. Thread (r, t) owns key row r of the block's tile; dk/dv accumulate
// its columns 4 * (t + kTPR * ch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq_len, int head_dim,
                     float scale) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / (4 * kTPR);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;              // [kBK][LD], times log2(e) * scale
  float* Vs = Ks + kBK * LD;     // [kBK][LD]
  float* Qs = Vs + kBK * LD;     // [kBQ][LD]
  float* dOs = Qs + kBQ * LD;    // [kBQ][LD]
  float* Ps = dOs + kBQ * LD;    // [kBK][kLDP]: P[i][key r] at Ps[r][i]
  float* dSs = Ps + kBK * kLDP;  // [kBK][kLDP]
  float* lse2s = dSs + kBK * kLDP;  // [kBQ], lse * log2(e)
  float* dls = lse2s + kBQ;         // [kBQ]

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int t = tid % kTPR;
  const int k0 = blockIdx.x * kBK;
  const int kj = k0 + r;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;

  stage<T, D>(Ks, k + base, k0, seq_len, head_dim, kLog2e * scale);
  stage<T, D>(Vs, v + base, k0, seq_len, head_dim, 1.f);

  float dk_acc[4 * CPT], dv_acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < seq_len; q0 += kBQ) {
    __syncthreads();  // K, V staged; the previous Q/dO tile no longer read
    stage<T, D>(Qs, q + base, q0, seq_len, head_dim, 1.f);
    stage<T, D>(dOs, dout + base, q0, seq_len, head_dim, 1.f);
    if (tid < kBQ) {
      const int qi = q0 + tid;
      lse2s[tid] = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
      dls[tid] = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;
    }
    __syncthreads();

    // scores and dP of queries t, t + 4, t + 8, ... against key row r
    float s[kPT], dp[kPT];
#pragma unroll
    for (int ii = 0; ii < kPT; ++ii) s[ii] = dp[ii] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + r * LD + c);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + r * LD + c);
#pragma unroll
      for (int ii = 0; ii < kPT; ++ii) {
        const int i = t + kTPR * ii;
        const float4 qv = *reinterpret_cast<const float4*>(Qs + i * LD + c);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + i * LD + c);
        s[ii] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        dp[ii] += ov.x * vv.x + ov.y * vv.y + ov.z * vv.z + ov.w * vv.w;
      }
    }
#pragma unroll
    for (int ii = 0; ii < kPT; ++ii) {
      const int i = t + kTPR * ii;
      const float p = q0 + i < seq_len ? exp2f(s[ii] - lse2s[i]) : 0.f;
      Ps[r * kLDP + i] = p;
      dSs[r * kLDP + i] = p * (dp[ii] - dls[i]);
    }
    __syncwarp();  // the row's four threads wrote its P and dS entries

    // dv_acc += sum_i P[i][r] * dO[i];  dk_acc += sum_i dS[i][r] * Q[i]
#pragma unroll 2
    for (int i = 0; i < kBQ; i += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + r * kLDP + i);
      const float4 sv = *reinterpret_cast<const float4*>(dSs + r * kLDP + i);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* orow = dOs + (i + u) * LD;
        const float* qrow = Qs + (i + u) * LD;
#pragma unroll
        for (int ch = 0; ch < CPT; ++ch) {
          const int col = 4 * (t + kTPR * ch);
          const float4 ov = *reinterpret_cast<const float4*>(orow + col);
          const float4 qv = *reinterpret_cast<const float4*>(qrow + col);
          dv_acc[4 * ch + 0] += pa[u] * ov.x;
          dv_acc[4 * ch + 1] += pa[u] * ov.y;
          dv_acc[4 * ch + 2] += pa[u] * ov.z;
          dv_acc[4 * ch + 3] += pa[u] * ov.w;
          dk_acc[4 * ch + 0] += sa[u] * qv.x;
          dk_acc[4 * ch + 1] += sa[u] * qv.y;
          dk_acc[4 * ch + 2] += sa[u] * qv.z;
          dk_acc[4 * ch + 3] += sa[u] * qv.w;
        }
      }
    }
    __syncwarp();  // P and dS rows read before the next tile overwrites them
  }

  if (kj < seq_len) {
    const size_t row = base + (size_t)kj * head_dim;
#pragma unroll
    for (int ch = 0; ch < CPT; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (t + kTPR * ch) + e;
        if (c < head_dim) {
          dk[row + c] = from_f32<T>(dk_acc[4 * ch + e] * scale);
          dv[row + c] = from_f32<T>(dv_acc[4 * ch + e]);
        }
      }
    }
  }
}

// which = 0 launches K5 (out0 = dq), which = 1 launches K6 (out0 = dk,
// out1 = dv).
template <typename T, int D>
cudaError_t launch(int which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* out0, void* out1, int bh, int seq_len, int head_dim,
                   float scale, cudaStream_t stream) {
  const dim3 grid((seq_len + kBQ - 1) / kBQ, bh);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  if (which == 0) {
    const int smem = dq_smem_floats<D>() * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse_, delta_, static_cast<T*>(out0), seq_len,
        head_dim, scale);
  } else {
    const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse_, delta_, static_cast<T*>(out0),
        static_cast<T*>(out1), seq_len, head_dim, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_any(int which, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, void* out0, void* out1, int bh,
                       int seq_len, int head_dim, float scale, int dtype,
                       void* stream) {
  return dispatch(dtype, head_dim, [&](auto type, auto dim) {
    return launch<typename decltype(type)::type, decltype(dim)::value>(
        which, q, k, v, dout, lse, delta, out0, out1, bh, seq_len, head_dim,
        scale, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs
// share it); lse and delta are f32 [bh, seq_len]. head_dim <= 128,
// bh <= 65535, scale = 1 / sqrt(head_dim). Each returns a cudaError_t.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh,
                               int seq_len, int head_dim, float scale,
                               int dtype, void* stream) {
  return (int)launch_any(0, q, k, v, dout, lse, delta, dq, nullptr, bh,
                         seq_len, head_dim, scale, dtype, stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int seq_len, int head_dim, float scale,
                                int dtype, void* stream) {
  return (int)launch_any(1, q, k, v, dout, lse, delta, dk, dv, bh, seq_len,
                         head_dim, scale, dtype, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
