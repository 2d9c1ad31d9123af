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
// Both are bound by operations (6 and 8 T^2 d flops and T^2 exponentials
// per head against O(T d) bytes); at d 32 the exponentials' floor on the
// special-function unit (16 a clock per SM) lies near the tensor cores'
// (A's shape on the H100: 0.032 against 0.026 ms for K5, 0.035 for K6),
// at d 64 below it. K5: one block per (bh, tile of query rows) loops over
// key tiles. K6: one block per (bh, tile of key rows) loops over query
// tiles. Either way each output tile has one block as its only writer and
// sums in f32 registers: no atomics, so one input gives one result.
//
// Routes, by a shape rule in launch_any; a call is one launch: bf16 K5
// and K6 at d 32 and 64 on rows that TMA can read, flash_dq_narrow_kernel
// and flash_dkv_narrow_kernel on wgmma/TMA (below); bf16 K5 and K6 at the
// other d <= 128 (d 128 among them) or on unaligned rows, and every d <=
// 128 in a build with -DFLASH_WGMMA_MIN_DIM=129, the mma.sync kernels;
// f32, the FP32 pipes; above d 128, the wide kernels.
//
// K5 in bfloat16 at d 32 and 64 (flash_dq_narrow_kernel): the roundings
// below on wgmma, warp-specialised. A producer warp streams 128-key tiles
// of K and V by TMA through an mbarrier ring; each consumer warpgroup owns
// 64 query rows end to end (Q, dO, lse and delta staged once), issues the
// next tile's S and dP on wgmma before this tile's exponentials and
// overlaps them with its own dQ product in flight.
//
// K5 in bfloat16 on mma.sync (flash_dq_mma_kernel): tensor cores, on K4's
// pattern.
// Each of kMmaWarps warps owns 16 query rows and keeps their Q and dO A
// fragments, lse log2(e) and delta in registers for the whole loop; K and
// V tiles stream through a double-buffered cp.async ring in bf16 shared
// memory (flash_mma.cuh). Per tile, on mma.sync with f32 accumulators:
// S = Q K^T and dP = dO V^T (K and V read as B fragments of their rows);
// P = exp2(S scale log2(e) - lse log2(e)) in registers (fast_exp2), 0 for
// keys past T in the last tile only; dS = P (dP - delta) rounded to bf16
// as A fragments, where the Pallas kernel casts ds to the input dtype
// (flash_attention.py:179); dQ += dS K with K through ldmatrix.trans. dQ
// stays in f32 registers; the scale is applied once and it is written
// once. The key tile shrinks with D (kDqKeys) to keep S, dP, dQ and the
// fragments in registers.
//
// K6 in bfloat16 (flash_dkv_mma_kernel): tensor cores. Each of kMmaWarps
// warps owns 16 key rows; Q and dO tiles (with their lse and delta) stream
// through a double-buffered cp.async ring in bf16 shared memory
// (flash_mma.cuh). Per tile, on mma.sync with f32 accumulators:
// S^T = K Q^T; P^T = exp2(S^T scale log2(e) - lse log2(e)) in registers
// (fast_exp2); dV += P^T dO with P^T rounded to bf16 as A fragments and dO
// through ldmatrix.trans; dP^T = V dO^T; dS^T = P^T (dP^T - delta) rounded
// to bf16 in registers; dK += dS^T Q with Q through ldmatrix.trans. Q and
// dO are each read plainly and transposed from one shared tile. The bf16
// roundings are the Pallas kernel's (flash_attention.py:209, 211: p and ds
// cast to the input dtype before the MXU). dK and dV stay in f32
// registers; the scale is applied once and each is written once. Padded
// query rows are zeros with lse = delta = 0, so they add exactly 0.
//
// K6 in bfloat16 at d 32 and 64 (flash_dkv_narrow_kernel): the roundings
// above on wgmma, warp-specialised. A producer warp streams 64-query
// tiles of Q and dO, with their lse log2(e) and delta, through an mbarrier
// ring by TMA; each of two consumer warpgroups owns 64 keys end to end
// (all four accumulators fit its registers, so nothing passes between
// them), and one warpgroup's exponentials overlap the other's products.
//
// K5 and K6 in float32: the FP32 pipes. Four threads share a row of the
// block's own tile; each scores a quarter of the other tile's rows and
// owns a quarter of the output columns, as in K4's f32 kernel.
// Scores are taken in the log2 domain (one side pre-scaled by
// log2(e)/sqrt(d), lse by log2(e)). f32 keeps full f32 products: TF32 or
// bf16 tensor cores would not hold the 1e-4 checks against the plain
// version.
//
// Ragged T is masked in the kernels: rows past T are loaded as zeros, get
// P = 0 or add 0, and are never stored. Head dims below the template's D
// are zero-padded in shared memory only. Head dims above 128: K5 and K6
// in bf16, on rows that TMA can read up to d 512, go to warp-specialised
// wgmma kernels (TMA into rings of shared-memory stages, the scores once
// per (query tile, key tile) over all of d, twice at most above d 256;
// flash_wgmma.cuh): K5 to flash_dq_wgmma_kernel up to d 256 and to
// flash_dq_wgmma_pair_kernel above (dQ in 256-column chunks), K6 to
// flash_dkv_wgmma_kernel (dK and dV in 256-column chunks above d 256). The
// rest (f32, unaligned rows, d > 512) goes to the wide kernels
// (flash_dq_wide_*, flash_dkv_wide_*), which stage d in 128-column chunks
// (flash_common.cuh) and take any head_dim. Either way a call is one
// launch.
//
// f32 tile constants and dispatch: flash_common.cuh, shared with K4;
// tensor-core pieces: flash_mma.cuh (mma.sync) and flash_wgmma.cuh (wgmma,
// TMA, mbarriers). Plain C interface, built with nvcc and loaded with
// ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Stage rows [r0, r0 + kBK) of src [seq_len, head_dim] into dst
// [kBK][D + 4] as f32 times `mul`; rows past seq_len and columns past
// head_dim are 0.
template <int D>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int r0, int seq_len, int head_dim,
                                      float mul) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int rr = i / D, cc = i % D, ri = r0 + rr;
    float val = 0.f;
    if (ri < seq_len && cc < head_dim)
      val = src[(size_t)ri * head_dim + cc] * mul;
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

// K5 in float32. acc[chunk] accumulates row r's dQ over columns
// 4 * (t + kTPR * ch).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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

  stage<D>(Qs, q + base, q0, seq_len, head_dim, kLog2e * scale);
  stage<D>(dOs, dout + base, q0, seq_len, head_dim, 1.f);
  const float lse2 = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
  const float dl = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;

  float acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kBK) {
    __syncthreads();  // Q, dO staged; the previous K/V tile no longer read
    stage<D>(Ks, k + base, k0, seq_len, head_dim, 1.f);
    stage<D>(Vs, v + base, k0, seq_len, head_dim, 1.f);
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
        if (c < head_dim) dq[row + c] = acc[4 * ch + e] * scale;
      }
    }
  }
}

// K6 in float32. Thread (r, t) owns key row r of the block's tile; dk/dv
// accumulate its columns 4 * (t + kTPR * ch).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int seq_len, int head_dim,
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

  stage<D>(Ks, k + base, k0, seq_len, head_dim, kLog2e * scale);
  stage<D>(Vs, v + base, k0, seq_len, head_dim, 1.f);

  float dk_acc[4 * CPT], dv_acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < seq_len; q0 += kBQ) {
    __syncthreads();  // K, V staged; the previous Q/dO tile no longer read
    stage<D>(Qs, q + base, q0, seq_len, head_dim, 1.f);
    stage<D>(dOs, dout + base, q0, seq_len, head_dim, 1.f);
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
          dk[row + c] = dk_acc[4 * ch + e] * scale;
          dv[row + c] = dv_acc[4 * ch + e];
        }
      }
    }
  }
}

// K6 in bf16. Query tiles of BQ rows: the two score tiles (16 x BQ) and
// dK, dV (16 x D) take BQ + D f32 registers a thread: about 160
// with BQ = 128 at D <= 32, 64 at D = 64 and 32 at D = 128. At D = 32 the
// larger tile halves the block syncs and fragment loads per query
// (scripts/torch_flash_variants.py times the alternatives).
#ifndef FLASH_DKV_BQ32
#define FLASH_DKV_BQ32 128
#endif
template <int D>
constexpr int kDkvBQ = D <= 32 ? FLASH_DKV_BQ32 : D == 64 ? 64 : 32;

template <int D>
constexpr int dkv_mma_smem_bytes() {
  // K, V (own), a ring of two Q and dO tiles, lse and delta per stage
  return (2 * kMmaRows + 4 * kDkvBQ<D>) * kMmaLd<D> * 2 +
         4 * kDkvBQ<D> * 4;
}

template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int seq_len,
                         int head_dim, float scale) {
  constexpr int LD = kMmaLd<D>;
  constexpr int BQ = kDkvBQ<D>;
  constexpr int KT = D / 16;   // k16 steps over the head dim
  constexpr int NT = D / 8;    // n8 tiles of dK's and dV's columns
  constexpr int ST = BQ / 8;   // n8 tiles of a query tile
  constexpr int TILE = BQ * LD;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Vs = Ks + kMmaRows * LD;
  __nv_bfloat16* Qs = Vs + kMmaRows * LD;  // [2][BQ][LD]
  __nv_bfloat16* dOs = Qs + 2 * TILE;      // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                               // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kMmaRows;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int ntiles = (seq_len + BQ - 1) / BQ;
  const float scale_log2 = scale * kLog2e;

  // Q, dO, lse and delta of query tile t into ring stage t & 1
  auto load_queries = [&](int t) {
    const int st = t & 1, r0 = t * BQ;
    load_tile<BQ, D, kAsync>(Qs + st * TILE, q + base, r0, seq_len,
                             head_dim);
    load_tile<BQ, D, kAsync>(dOs + st * TILE, dout + base, r0, seq_len,
                             head_dim);
    for (int i = threadIdx.x; i < 2 * BQ; i += kMmaThreads) {
      const int qi = r0 + i % BQ;
      const bool valid = qi < seq_len;
      const float* src = i < BQ ? lse : delta;
      cp_async_4((i < BQ ? Ls : Ds) + st * BQ + i % BQ,
                 src + (valid ? bh * seq_len + qi : 0), valid);
    }
  };

  load_tile<kMmaRows, D, kAsync>(Ks, k + base, k0, seq_len, head_dim);
  load_tile<kMmaRows, D, kAsync>(Vs, v + base, k0, seq_len, head_dim);
  load_queries(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const __nv_bfloat16* Kw = Ks + warp * 16 * LD + a_frag_offset(lane, LD);
  const __nv_bfloat16* Vw = Vs + warp * 16 * LD + a_frag_offset(lane, LD);

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_queries(t + 1);  // the stage tile t - 1 used
    cp_async_commit();
    const __nv_bfloat16* Qt = Qs + (t & 1) * TILE;
    const __nv_bfloat16* dOt = dOs + (t & 1) * TILE;
    const float* Lt = Ls + (t & 1) * BQ;
    const float* Dt = Ds + (t & 1) * BQ;

    // S^T = K Q^T: rows are this warp's keys, columns the tile's queries
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t ka[4];
      ldmatrix_x4(ka, Kw + ks * 16);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Qt + np * 16 * LD + ks * 16 + b_frag_offset(lane, LD));
        mma_16816(s[2 * np], ka, b[0], b[1]);
        mma_16816(s[2 * np + 1], ka, b[2], b[3]);
      }
    }
    // P^T, in place; columns (queries) n * 8 + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      const float l0 = Lt[c] * kLog2e, l1 = Lt[c + 1] * kLog2e;
      s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, -l0));
      s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, -l1));
      s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, -l0));
      s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, -l1));
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, dOt + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(dv_acc[2 * np], pa, b[0], b[1]);
        mma_16816(dv_acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    // dP^T = V dO^T
    float dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t va[4];
      ldmatrix_x4(va, Vw + ks * 16);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b,
                    dOt + np * 16 * LD + ks * 16 + b_frag_offset(lane, LD));
        mma_16816(dp[2 * np], va, b[0], b[1]);
        mma_16816(dp[2 * np + 1], va, b[2], b[3]);
      }
    }
    // dS^T = P^T (dP^T - delta), in place of dP^T
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      const float d0 = Dt[c], d1 = Dt[c + 1];
      dp[n][0] = s[n][0] * (dp[n][0] - d0);
      dp[n][1] = s[n][1] * (dp[n][1] - d1);
      dp[n][2] = s[n][2] * (dp[n][2] - d0);
      dp[n][3] = s[n][3] * (dp[n][3] - d1);
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t da[4];
      a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Qt + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(dk_acc[2 * np], da, b[0], b[1]);
        mma_16816(dk_acc[2 * np + 1], da, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile t + 1 landed; tile t no longer read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + warp * 16 + lane / 4 + 8 * r;
    if (kj >= seq_len) continue;
    const size_t row = base + (size_t)kj * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim) {
          dk[row + c] = __float2bfloat16(dk_acc[n][2 * r + e] * scale);
          dv[row + c] = __float2bfloat16(dv_acc[n][2 * r + e]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int seq_len, int head_dim, float scale,
                           cudaStream_t stream) {
  auto* kernel = rows_aligned(head_dim, {q, k, v, dout})
                     ? flash_dkv_mma_kernel<D, true>
                     : flash_dkv_mma_kernel<D, false>;
  const int smem = dkv_mma_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kMmaRows - 1) / kMmaRows, bh);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      seq_len, head_dim, scale);
  return cudaGetLastError();
}

// K5 in bf16. Key tiles of BK rows: the S and dP tiles (16 x BK each) take
// BK f32 registers a thread beside dQ (D / 2) and the Q and dO fragments
// (D / 2): about 128 at D <= 64 with BK = 64, 160 at D = 128 with BK = 32
// (scripts/torch_flash_variants.py times FLASH_DQ_KEYS).
#ifndef FLASH_DQ_KEYS
#define FLASH_DQ_KEYS 64
#endif
template <int D>
constexpr int kDqKeys = D <= 64 ? FLASH_DQ_KEYS : 32;

template <int D>
constexpr int dq_mma_smem_bytes() {
  // Q and dO (own, staged once for the fragments), a ring of two K and V
  // tiles
  return (2 * kMmaRows + 4 * kDqKeys<D>) * kMmaLd<D> * 2;
}

template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int seq_len,
                        int head_dim, float scale) {
  constexpr int LD = kMmaLd<D>;
  constexpr int BK = kDqKeys<D>;
  constexpr int KT = D / 16;   // k16 steps over the head dim
  constexpr int NT = D / 8;    // n8 tiles of dQ's columns
  constexpr int ST = BK / 8;   // n8 tiles of a key tile
  constexpr int TILE = BK * LD;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* dOs = Qs + kMmaRows * LD;
  __nv_bfloat16* Ks = dOs + kMmaRows * LD;  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;        // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int ntiles = (seq_len + BK - 1) / BK;
  const float scale_log2 = scale * kLog2e;

  load_tile<kMmaRows, D, kAsync>(Qs, q + base, q0, seq_len, head_dim);
  load_tile<kMmaRows, D, kAsync>(dOs, dout + base, q0, seq_len, head_dim);
  load_tile<BK, D, kAsync>(Ks, k + base, 0, seq_len, head_dim);
  load_tile<BK, D, kAsync>(Vs, v + base, 0, seq_len, head_dim);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows: Q and dO A fragments, and lse·log2(e) and
  // delta of rows lane / 4 and lane / 4 + 8 (0 past T: never stored)
  uint32_t qa[KT][4], da[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    const int off = warp * 16 * LD + ks * 16 + a_frag_offset(lane, LD);
    ldmatrix_x4(qa[ks], Qs + off);
    ldmatrix_x4(da[ks], dOs + off);
  }
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    l2[r] = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
    dl[r] = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {  // the buffer that tile t - 1 used
      const int nb = (t + 1) & 1;
      load_tile<BK, D, kAsync>(Ks + nb * TILE, k + base, (t + 1) * BK,
                               seq_len, head_dim);
      load_tile<BK, D, kAsync>(Vs + nb * TILE, v + base, (t + 1) * BK,
                               seq_len, head_dim);
    }
    cp_async_commit();
    const __nv_bfloat16* Kt = Ks + (t & 1) * TILE;
    const __nv_bfloat16* Vt = Vs + (t & 1) * TILE;

    // S = Q K^T and dP = dO V^T: rows are this warp's queries, columns the
    // tile's keys; K and V are both read as B fragments of their rows
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        const int off = np * 16 * LD + ks * 16 + b_frag_offset(lane, LD);
        uint32_t b[4];
        ldmatrix_x4(b, Kt + off);
        mma_16816(s[2 * np], qa[ks], b[0], b[1]);
        mma_16816(s[2 * np + 1], qa[ks], b[2], b[3]);
        ldmatrix_x4(b, Vt + off);
        mma_16816(dp[2 * np], da[ks], b[0], b[1]);
        mma_16816(dp[2 * np + 1], da[ks], b[2], b[3]);
      }
    }
    // P = exp2(S scale log2(e) - lse log2(e)), 0 for keys past T (last
    // tile only); dS = P (dP - delta), in place of dP. Columns (keys)
    // n * 8 + 2 (lane % 4) + {0, 1}, rows lane / 4 (i < 2) and + 8.
    const int k0 = t * BK;
    const bool ragged = k0 + BK > seq_len;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[n][i], scale_log2, -l2[i / 2]));
        if (ragged && k0 + n * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
          p = 0.f;
        dp[n][i] = p * (dp[n][i] - dl[i / 2]);
      }
    }
    // dQ += dS K: dS rounded to bf16 as A fragments (the Pallas kernel's
    // cast, flash_attention.py:179), K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t dsa[4];
      a_from_c(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Kt + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(acc[2 * np], dsa, b[0], b[1]);
        mma_16816(acc[2 * np + 1], dsa, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile t + 1 landed; tile t no longer read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim)
          dq[row + c] = __float2bfloat16(acc[n][2 * r + e] * scale);
      }
    }
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int seq_len,
                          int head_dim, float scale, cudaStream_t stream) {
  auto* kernel = rows_aligned(head_dim, {q, k, v, dout})
                     ? flash_dq_mma_kernel<D, true>
                     : flash_dq_mma_kernel<D, false>;
  const int smem = dq_mma_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kMmaRows - 1) / kMmaRows, bh);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), seq_len, head_dim, scale);
  return cudaGetLastError();
}

// ---- head dims above 128 (flash_common.cuh: any head_dim) -------------

// K5 in bf16, wide, for rows that TMA cannot read (d % 8 != 0, unaligned
// bases), d > 512 and builds with -DFLASH_WGMMA_MAX_DIM=128; the rest of
// bf16 above d 128 takes the wgmma kernels further down (launch_wide).
// One block per (bh, tile of kMmaRows query rows, kWideCols-column chunk
// c0 of dQ). Per tile of kWideKeys keys, S = Q K^T and dP = dO V^T are
// summed over staged kWideCols-column chunks of Q, dO, K and V (the A
// fragments read from shared memory); P and dS as in K5; then K's chunk
// c0 is staged and dQ's chunk += bf16(dS) K[:, c0:].
template <bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int seq_len,
                             int head_dim, float scale) {
  constexpr int LD = kMmaLd<kWideCols>;
  constexpr int BK = kWideKeys;
  constexpr int KT = kWideCols / 16;
  constexpr int NT = kWideCols / 8;
  constexpr int ST = BK / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* dOs = Qs + kMmaRows * LD;
  __nv_bfloat16* Ks = dOs + kMmaRows * LD;  // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;         // [BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kMmaRows, c0 = blockIdx.z * kWideCols;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int ntiles = (seq_len + BK - 1) / BK;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;
  const float scale_log2 = scale * kLog2e;
  const int aoff = warp * 16 * LD + a_frag_offset(lane, LD);

  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    l2[r] = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
    dl[r] = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = ch * kWideCols;
      __syncthreads();  // the previous chunk (and tile) no longer read
      load_block<kMmaRows, kWideCols, kAsync>(Qs, q + base, q0, cc, seq_len,
                                              head_dim);
      load_block<kMmaRows, kWideCols, kAsync>(dOs, dout + base, q0, cc,
                                              seq_len, head_dim);
      load_block<BK, kWideCols, kAsync>(Ks, k + base, k0, cc, seq_len,
                                        head_dim);
      load_block<BK, kWideCols, kAsync>(Vs, v + base, k0, cc, seq_len,
                                        head_dim);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, Qs + aoff + ks * 16);
        ldmatrix_x4(da, dOs + aoff + ks * 16);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          const int off = np * 16 * LD + ks * 16 + b_frag_offset(lane, LD);
          uint32_t b[4];
          ldmatrix_x4(b, Ks + off);
          mma_16816(s[2 * np], qa, b[0], b[1]);
          mma_16816(s[2 * np + 1], qa, b[2], b[3]);
          ldmatrix_x4(b, Vs + off);
          mma_16816(dp[2 * np], da, b[0], b[1]);
          mma_16816(dp[2 * np + 1], da, b[2], b[3]);
        }
      }
    }
    const bool ragged = k0 + BK > seq_len;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[n][i], scale_log2, -l2[i / 2]));
        if (ragged && k0 + n * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
          p = 0.f;
        dp[n][i] = p * (dp[n][i] - dl[i / 2]);
      }
    }
    __syncthreads();  // K's last chunk no longer read
    load_block<BK, kWideCols, kAsync>(Ks, k + base, k0, c0, seq_len,
                                      head_dim);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t dsa[4];
      a_from_c(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Ks + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(acc[2 * np], dsa, b[0], b[1]);
        mma_16816(acc[2 * np + 1], dsa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim)
          dq[row + c] = __float2bfloat16(acc[n][2 * r + e] * scale);
      }
    }
  }
}

// K6 in bf16, wide: one block per (bh, tile of kMmaRows key rows,
// kWideCols-column chunk c0 of dK and dV). Per tile of kWideKeys queries,
// S^T = K Q^T and dP^T = V dO^T are summed over staged chunks of K, V, Q
// and dO; P^T and dS^T as in K6; then Q's and dO's chunk c0 are staged and
// dV's chunk += bf16(P^T) dO[:, c0:], dK's chunk += bf16(dS^T) Q[:, c0:].
template <bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq_len,
                              int head_dim, float scale) {
  constexpr int LD = kMmaLd<kWideCols>;
  constexpr int BQ = kWideKeys;
  constexpr int KT = kWideCols / 16;
  constexpr int NT = kWideCols / 8;
  constexpr int ST = BQ / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Vs = Ks + kMmaRows * LD;
  __nv_bfloat16* Qs = Vs + kMmaRows * LD;  // [BQ][LD]
  __nv_bfloat16* dOs = Qs + BQ * LD;       // [BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + BQ * LD);  // [BQ]
  float* Ds = Ls + BQ;                                  // [BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kMmaRows, c0 = blockIdx.z * kWideCols;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int ntiles = (seq_len + BQ - 1) / BQ;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;
  const float scale_log2 = scale * kLog2e;
  const int aoff = warp * 16 * LD + a_frag_offset(lane, LD);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * BQ;
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = ch * kWideCols;
      __syncthreads();  // the previous chunk (and tile) no longer read
      load_block<kMmaRows, kWideCols, kAsync>(Ks, k + base, k0, cc, seq_len,
                                              head_dim);
      load_block<kMmaRows, kWideCols, kAsync>(Vs, v + base, k0, cc, seq_len,
                                              head_dim);
      load_block<BQ, kWideCols, kAsync>(Qs, q + base, r0, cc, seq_len,
                                        head_dim);
      load_block<BQ, kWideCols, kAsync>(dOs, dout + base, r0, cc, seq_len,
                                        head_dim);
      if (ch == 0) {
        for (int i = threadIdx.x; i < 2 * BQ; i += kMmaThreads) {
          const int qi = r0 + i % BQ;
          const bool valid = qi < seq_len;
          const float* src = i < BQ ? lse : delta;
          cp_async_4((i < BQ ? Ls : Ds) + i % BQ,
                     src + (valid ? bh * seq_len + qi : 0), valid);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + aoff + ks * 16);
        ldmatrix_x4(va, Vs + aoff + ks * 16);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          const int off = np * 16 * LD + ks * 16 + b_frag_offset(lane, LD);
          uint32_t b[4];
          ldmatrix_x4(b, Qs + off);
          mma_16816(s[2 * np], ka, b[0], b[1]);
          mma_16816(s[2 * np + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, dOs + off);
          mma_16816(dp[2 * np], va, b[0], b[1]);
          mma_16816(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T; columns (queries)
    // n * 8 + 2 (lane % 4) + {0, 1}. Padded queries have lse = delta = 0
    // and zero rows, so they add exactly 0.
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      const float l0 = Ls[c] * kLog2e, l1 = Ls[c + 1] * kLog2e;
      const float d0 = Ds[c], d1 = Ds[c + 1];
      s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, -l0));
      s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, -l1));
      s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, -l0));
      s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, -l1));
      dp[n][0] = s[n][0] * (dp[n][0] - d0);
      dp[n][1] = s[n][1] * (dp[n][1] - d1);
      dp[n][2] = s[n][2] * (dp[n][2] - d0);
      dp[n][3] = s[n][3] * (dp[n][3] - d1);
    }
    __syncthreads();  // the last chunk's Q and dO no longer read
    load_block<BQ, kWideCols, kAsync>(Qs, q + base, r0, c0, seq_len,
                                      head_dim);
    load_block<BQ, kWideCols, kAsync>(dOs, dout + base, r0, c0, seq_len,
                                      head_dim);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t pa[4], da[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
      a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD);
        uint32_t b[4];
        ldmatrix_x4_trans(b, dOs + off);
        mma_16816(dv_acc[2 * np], pa, b[0], b[1]);
        mma_16816(dv_acc[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, Qs + off);
        mma_16816(dk_acc[2 * np], da, b[0], b[1]);
        mma_16816(dk_acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + warp * 16 + lane / 4 + 8 * r;
    if (kj >= seq_len) continue;
    const size_t row = base + (size_t)kj * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim) {
          dk[row + c] = __float2bfloat16(dk_acc[n][2 * r + e] * scale);
          dv[row + c] = __float2bfloat16(dv_acc[n][2 * r + e]);
        }
      }
    }
  }
}

// K5 in f32, wide: flash_dq_kernel's layout with S and dP summed over
// staged kWideCols-column chunks, then K's chunk c0 staged for dQ's.
__global__ void __launch_bounds__(kThreads)
    flash_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int seq_len, int head_dim,
                         float scale) {
  constexpr int LD = kWideLdF;
  constexpr int CPT = kWideCols / (4 * kTPR);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;              // [kBQ][LD], times log2(e) * scale
  float* dOs = Qs + kBQ * LD;    // [kBQ][LD]
  float* Ks = dOs + kBQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][LD]
  float* dSs = Vs + kBK * LD;    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int r = tid / kTPR, t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ, qi = q0 + r, c0 = blockIdx.z * kWideCols;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;
  const float lse2 = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
  const float dl = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;

  float acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kBK) {
    float s[kPT], dp[kPT];
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) s[jj] = dp[jj] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = ch * kWideCols;
      __syncthreads();  // the previous chunk (and tile) no longer read
      stage_cols(Qs, q + base, q0, cc, seq_len, head_dim, kLog2e * scale);
      stage_cols(dOs, dout + base, q0, cc, seq_len, head_dim, 1.f);
      stage_cols(Ks, k + base, k0, cc, seq_len, head_dim, 1.f);
      stage_cols(Vs, v + base, k0, cc, seq_len, head_dim, 1.f);
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kWideCols; c += 4) {
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
    }
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) {
      const int j = t + kTPR * jj;
      const float p = k0 + j < seq_len ? exp2f(s[jj] - lse2) : 0.f;
      dSs[r * kLDP + j] = p * (dp[jj] - dl);
    }
    __syncthreads();  // K's last chunk no longer read; dS written
    stage_cols(Ks, k + base, k0, c0, seq_len, head_dim, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(dSs + r * kLDP + j);
      const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = Ks + (j + u) * LD;
#pragma unroll
        for (int cq = 0; cq < CPT; ++cq) {
          const float4 kv =
              *reinterpret_cast<const float4*>(krow + 4 * (t + kTPR * cq));
          acc[4 * cq + 0] += sj[u] * kv.x;
          acc[4 * cq + 1] += sj[u] * kv.y;
          acc[4 * cq + 2] += sj[u] * kv.z;
          acc[4 * cq + 3] += sj[u] * kv.w;
        }
      }
    }
  }

  if (qi < seq_len) {
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int cq = 0; cq < CPT; ++cq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * (t + kTPR * cq) + e;
        if (c < head_dim) dq[row + c] = acc[4 * cq + e] * scale;
      }
    }
  }
}

// K6 in f32, wide: flash_dkv_kernel's layout with S^T and dP^T summed over
// staged kWideCols-column chunks, then Q's and dO's chunk c0 staged for
// dK's and dV's.
__global__ void __launch_bounds__(kThreads)
    flash_dkv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int seq_len, int head_dim, float scale) {
  constexpr int LD = kWideLdF;
  constexpr int CPT = kWideCols / (4 * kTPR);
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
  const int r = tid / kTPR, t = tid % kTPR;
  const int k0 = blockIdx.x * kBK, kj = k0 + r, c0 = blockIdx.z * kWideCols;
  const size_t bh = blockIdx.y;
  const size_t base = bh * seq_len * head_dim;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;

  float dk_acc[4 * CPT], dv_acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < seq_len; q0 += kBQ) {
    float s[kPT], dp[kPT];
#pragma unroll
    for (int ii = 0; ii < kPT; ++ii) s[ii] = dp[ii] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = ch * kWideCols;
      __syncthreads();  // the previous chunk (and tile) no longer read
      stage_cols(Ks, k + base, k0, cc, seq_len, head_dim, kLog2e * scale);
      stage_cols(Vs, v + base, k0, cc, seq_len, head_dim, 1.f);
      stage_cols(Qs, q + base, q0, cc, seq_len, head_dim, 1.f);
      stage_cols(dOs, dout + base, q0, cc, seq_len, head_dim, 1.f);
      if (ch == 0 && tid < kBQ) {
        const int qi = q0 + tid;
        lse2s[tid] = qi < seq_len ? lse[bh * seq_len + qi] * kLog2e : 0.f;
        dls[tid] = qi < seq_len ? delta[bh * seq_len + qi] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kWideCols; c += 4) {
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
    }
#pragma unroll
    for (int ii = 0; ii < kPT; ++ii) {
      const int i = t + kTPR * ii;
      const float p = q0 + i < seq_len ? exp2f(s[ii] - lse2s[i]) : 0.f;
      Ps[r * kLDP + i] = p;
      dSs[r * kLDP + i] = p * (dp[ii] - dls[i]);
    }
    __syncthreads();  // the last chunk's Q and dO no longer read
    stage_cols(Qs, q + base, q0, c0, seq_len, head_dim, 1.f);
    stage_cols(dOs, dout + base, q0, c0, seq_len, head_dim, 1.f);
    __syncthreads();

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
        for (int cq = 0; cq < CPT; ++cq) {
          const int col = 4 * (t + kTPR * cq);
          const float4 ov = *reinterpret_cast<const float4*>(orow + col);
          const float4 qv = *reinterpret_cast<const float4*>(qrow + col);
          dv_acc[4 * cq + 0] += pa[u] * ov.x;
          dv_acc[4 * cq + 1] += pa[u] * ov.y;
          dv_acc[4 * cq + 2] += pa[u] * ov.z;
          dv_acc[4 * cq + 3] += pa[u] * ov.w;
          dk_acc[4 * cq + 0] += sa[u] * qv.x;
          dk_acc[4 * cq + 1] += sa[u] * qv.y;
          dk_acc[4 * cq + 2] += sa[u] * qv.z;
          dk_acc[4 * cq + 3] += sa[u] * qv.w;
        }
      }
    }
  }

  if (kj < seq_len) {
    const size_t row = base + (size_t)kj * head_dim;
#pragma unroll
    for (int cq = 0; cq < CPT; ++cq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * (t + kTPR * cq) + e;
        if (c < head_dim) {
          dk[row + c] = dk_acc[4 * cq + e] * scale;
          dv[row + c] = dv_acc[4 * cq + e];
        }
      }
    }
  }
}

// K6 in bf16, wgmma route (flash_wgmma.cuh: d in (128, 512], 16-byte
// aligned rows): one block per (bh, 64 key rows, DC-column chunk c0 of dK
// and dV; DC = 64 NB). K's and V's ns 64-column slices are staged once.
// Per 64-query tile the producer (warpgroup 2, one thread issuing TMA)
// streams Q and dO slices through a ring of `rq` 16 KB stages (a Q slice
// and the dO slice of the same columns), first the slices of d outside
// the chunk, then the NB chunk slices, with the tile's lse log2(e) and
// delta (zero past T) written beside its first stage. Warpgroup 0:
// S^T = K Q^T over all of d, P^T = exp2(S^T scale log2(e) - lse log2(e))
// (f32), handed to warpgroup 1 through shared memory, then dV += bf16(P^T)
// dO[:, c0:]. Warpgroup 1: dP^T = V dO^T over all of d, dS^T = P^T (dP^T -
// delta) with the f32 P^T, then dK += bf16(dS^T) Q[:, c0:]. So the scores
// are computed once per (key tile, query tile), the roundings are the
// Pallas kernel's (flash_attention.py:209, 211), and a stage is released
// (one arrival from each of the 8 consumer warps) once the products that
// read it have completed: slices outside the chunk after S^T / dP^T, the
// chunk's after dV / dK. Padded queries have zero rows and lse = delta =
// 0, so they add exactly 0. dK (times the scale, applied once) and dV are
// written once; rows past T are not stored.
template <int NB>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int seq_len,
                           int head_dim, float scale, int ns, int rq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const gbase = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(gbase);
  const uint32_t Ks = base;                          // [ns] slices
  const uint32_t Vs = Ks + ns * kSliceBytes;         // [ns] slices
  const uint32_t Rs = Vs + ns * kSliceBytes;         // [rq] stages: Q, dO
  const int p_off = (2 * ns + 2 * rq) * kSliceBytes;
  float4* const Ps = reinterpret_cast<float4*>(gbase + p_off);  // [8][128]
  float* const Ls = reinterpret_cast<float*>(gbase + p_off + 16 * 1024);
  // Ls: [rq][128], lse log2(e) of the tile's 64 queries, then delta
  const uint32_t bars = smem_u32(Ls + rq * 128);
  const uint32_t kv_full = bars;
  const uint32_t full = bars + 8, empty = full + 8 * rq;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kSlice, bh = blockIdx.y;
  const int cs = blockIdx.z * NB;  // the chunk's first slice
  const int c0 = cs * kSlice;
  const int ntiles = (seq_len + kSlice - 1) / kSlice;
  // slices a query tile streams: those of d outside the chunk, then the
  // chunk's NB
  const int n_out = cs + max(0, ns - cs - NB);
  const int n_tile = n_out + NB;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < rq; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: warp 0 (lane 0 issues the copies)
    reg_dealloc<24>();
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect(kv_full, 2 * ns * kSliceBytes);
      for (int s = 0; s < ns; ++s) {
        tma_slice(Ks + s * kSliceBytes, &tk, s * kSlice, k0, bh, kv_full);
        tma_slice(Vs + s * kSliceBytes, &tv, s * kSlice, k0, bh, kv_full);
      }
    }
    const size_t head = (size_t)bh * seq_len;
    int ri = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int r0 = t * kSlice;
      for (int idx = 0; idx < n_tile; ++idx, ++ri) {
        const int sl = idx < cs ? idx : idx < n_out ? idx + NB
                                                    : cs + idx - n_out;
        const int st = ri % rq;
        mbar_wait(empty + 8 * st, ((ri / rq) & 1) ^ 1);
        if (idx == 0) {
          float* ld = Ls + st * 128;
          for (int i = lane; i < kSlice; i += 32) {
            const int qi = r0 + i;
            ld[i] = qi < seq_len ? lse[head + qi] * kLog2e : 0.f;
            ld[kSlice + i] = qi < seq_len ? delta[head + qi] : 0.f;
          }
          __syncwarp();
        }
        if (lane == 0) {
          const uint32_t stage = Rs + st * 2 * kSliceBytes;
          mbar_expect(full + 8 * st, 2 * kSliceBytes);
          tma_slice(stage, &tq, sl * kSlice, r0, bh, full + 8 * st);
          tma_slice(stage + kSliceBytes, &tdo, sl * kSlice, r0, bh,
                    full + 8 * st);
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: key rows k0 + 16 warp + lane / 4 (+ 8); accumulator columns
  // (queries of the tile) 8 i + 2 (lane % 4) (+ 1)
  reg_alloc<240>();
  const float scale_log2 = scale * kLog2e;
  const uint32_t own = wg == 0 ? Ks : Vs;  // K for S^T, V for dP^T
  const uint32_t other = wg == 0 ? 0 : kSliceBytes;  // Q or dO in a stage
  const uint32_t chunk_op = wg == 0 ? kSliceBytes : 0;  // dO or Q
  float acc[NB][32];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  mbar_wait(kv_full, 0);

  int ri = 0;
  for (int t = 0; t < ntiles; ++t) {
    float s[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
    float2 rows[8];  // lse log2(e) or delta of columns 8 i + 2 (lane % 4)
    const int first = ri;
    wgmma_fence();
    for (int idx = 0; idx < n_tile; ++idx, ++ri) {
      const int sl = idx < cs ? idx : idx < n_out ? idx + NB
                                                  : cs + idx - n_out;
      const int st = ri % rq;
      mbar_wait(full + 8 * st, (ri / rq) & 1);
      if (idx == 0) {
        const float* ld = Ls + st * 128 + (wg == 0 ? 0 : kSlice);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          rows[i] = *reinterpret_cast<const float2*>(ld + 8 * i +
                                                     2 * (lane % 4));
      }
      if (sl < ns) {
        const uint64_t da = desc_sw128(own + sl * kSliceBytes);
        const uint64_t db =
            desc_sw128(Rs + st * 2 * kSliceBytes + other);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, idx | kk);
        wgmma_commit();
      }
      if (idx < n_out) {  // a slice outside the chunk: done with it
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }
    wgmma_wait<0>();
    fence_regs(s);

    uint32_t a[4][4];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 lr = rows[i / 4];
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -(i % 2 ? lr.y : lr.x)));
      }
      if (t > 0) named_sync(2);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[j * kWgThreads + tid] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      named_arrive(1);
      a_from_acc(a, s);
    } else {
      named_sync(1);  // P^T of this tile written
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = Ps[j * kWgThreads + tid];
        const float2 dl = rows[j];
        s[4 * j + 0] = p.x * (s[4 * j + 0] - dl.x);
        s[4 * j + 1] = p.y * (s[4 * j + 1] - dl.y);
        s[4 * j + 2] = p.z * (s[4 * j + 2] - dl.x);
        s[4 * j + 3] = p.w * (s[4 * j + 3] - dl.y);
      }
      if (t + 1 < ntiles) named_arrive(2);
      a_from_acc(a, s);
    }

    // dV += bf16(P^T) dO[:, c0:] or dK += bf16(dS^T) Q[:, c0:], over the
    // chunk's slices (the tile's last NB stages)
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int st = (first + n_out + b) % rq;
      const uint64_t db = desc_sw128(Rs + st * 2 * kSliceBytes + chunk_op);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc[b], a[kk], db + kk * kStepMN);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (lane == 0)
      for (int b = 0; b < NB; ++b)
        mbar_arrive(empty + 8 * ((first + n_out + b) % rq));
  }

  __nv_bfloat16* const out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
  const size_t head = (size_t)bh * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + warp * 16 + lane / 4 + 8 * r;
    if (kj >= seq_len) continue;
    __nv_bfloat16* row = out + (head + kj) * head_dim;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + b * kSlice + i * 8 + (lane % 4) * 2;
        if (c < head_dim)
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
              acc[b][4 * i + 2 * r] * mul, acc[b][4 * i + 2 * r + 1] * mul);
      }
  }
}

// Shared memory of flash_dkv_wgmma_kernel<NB> with `rq` stages: the
// 1024-byte alignment slack, K and V, the ring, P^T, the rows of lse and
// delta and the barriers.
inline int dkv_wgmma_smem(int ns, int rq) {
  return 1024 + (2 * ns + 2 * rq) * kSliceBytes + 16 * 1024 + rq * 512 +
         8 * (1 + 2 * rq);
}

template <int NB>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int seq_len, int head_dim, float scale,
                             cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_rows(&tq, q, bh, seq_len, head_dim)) != cudaSuccess ||
      (err = encode_rows(&tk, k, bh, seq_len, head_dim)) != cudaSuccess ||
      (err = encode_rows(&tv, v, bh, seq_len, head_dim)) != cudaSuccess ||
      (err = encode_rows(&tdo, dout, bh, seq_len, head_dim)) != cudaSuccess)
    return err;
  const int ns = (head_dim + kSlice - 1) / kSlice;
  // the ring holds the chunk's NB slices of a tile at once, and at most
  // two tiles' worth
  int rq = 8;
  while (rq > NB && dkv_wgmma_smem(ns, rq) > kMaxSmem) --rq;
  const int smem = dkv_wgmma_smem(ns, rq);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_dkv_wgmma_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kSlice - 1) / kSlice, bh,
                  wgmma_chunks(head_dim));
  flash_dkv_wgmma_kernel<NB><<<grid, 3 * kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq_len, head_dim, scale, ns, rq);
  return cudaGetLastError();
}

// K6 in bf16, narrow route (d 32 or 64, 16-byte aligned rows): one block
// per (bh, 128 key rows). Warpgroups 0 and 1 consume, 64 keys each, and
// each owns its keys end to end: no handoff between them. Warpgroup 2
// produces (warp 0: lane 0 issues the TMA copies). The block's K and V are
// staged once; per tile of 64 queries the producer streams Q and dO
// through a ring of R stages, writing the tile's lse log2(e) and delta
// (zero past T) beside them. A consumer takes S^T = K Q^T and dP^T = V dO^T
// (wgmma from shared memory, committed together), then in f32 registers
// P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T -
// delta), and dV += bf16(P^T) dO and dK += bf16(dS^T) Q with P^T and dS^T
// as the register A operands and dO and Q transposed by the descriptor:
// the Pallas kernel's roundings (flash_attention.py:209, 211). The two
// warpgroups run apart, so the scheduler interleaves one's exponentials
// with the other's products. Registers a thread at d 64: S^T and dP^T 32
// each, dK and dV 32 each. Each key row has one writer and no atomics, so
// a repeat gives the same bits. Padded queries have zero rows and lse =
// delta = 0, so they add exactly 0; dK (times the scale, applied once)
// and dV are written once; rows past T are not stored.
#ifndef FLASH_DKV_NARROW_STAGES
#define FLASH_DKV_NARROW_STAGES 4
#endif
constexpr int kDkvNarrowQ = 64;  // queries a tile

template <int D>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_dkv_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int seq_len,
                            float scale) {
  constexpr int SC = kNarrowCols<D>, NS = kNarrowSlices<D>;
  constexpr int RB = 2 * SC;                 // bytes of a slice's row
  constexpr int BQ = kDkvNarrowQ;
  constexpr int R = FLASH_DKV_NARROW_STAGES;
  constexpr int KVS = 128 * RB;              // a slice of the block's K or V
  constexpr int QS = BQ * RB;                // a slice of a tile's Q or dO
  constexpr int KT = SC / 16;                // k16 steps a slice of d
  constexpr int PT = BQ / 16;                // k16 steps of dV and dK
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const gbase =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(gbase);
  const uint32_t Ks = base;                  // [NS] slices
  const uint32_t Vs = Ks + NS * KVS;         // [NS] slices
  const uint32_t Rs = Vs + NS * KVS;         // [R] stages: [NS] Q, [NS] dO
  const int rows_off = 2 * NS * KVS + R * 2 * NS * QS;
  float* const Ls = reinterpret_cast<float*>(gbase + rows_off);
  // Ls: [R][2 BQ], lse log2(e) of the tile's queries, then delta
  const uint32_t kv_full = base + rows_off + R * 2 * BQ * 4;
  const uint32_t full = kv_full + 8, empty = full + 8 * R;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * 128, bh = blockIdx.y;
  const int ntiles = (seq_len + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: warp 0 (lane 0 issues the copies)
    reg_dealloc<24>();
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect(kv_full, 2 * NS * KVS);
      for (int s = 0; s < NS; ++s) {
        tma_slice(Ks + s * KVS, &tk, s * SC, k0, bh, kv_full);
        tma_slice(Vs + s * KVS, &tv, s * SC, k0, bh, kv_full);
      }
    }
    const size_t head = (size_t)bh * seq_len;
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % R, r0 = t * BQ;
      mbar_wait(empty + 8 * st, ((t / R) & 1) ^ 1);
      float* ld = Ls + st * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const int qi = r0 + i;
        ld[i] = qi < seq_len ? lse[head + qi] * kLog2e : 0.f;
        ld[BQ + i] = qi < seq_len ? delta[head + qi] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t stage = Rs + st * 2 * NS * QS;
        mbar_expect(full + 8 * st, 2 * NS * QS);
        for (int s = 0; s < NS; ++s) {
          tma_slice(stage + s * QS, &tq, s * SC, r0, bh, full + 8 * st);
          tma_slice(stage + (NS + s) * QS, &tdo, s * SC, r0, bh,
                    full + 8 * st);
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumers: key rows k0 + 64 wg + 16 warp + lane / 4 (+ 8); the S^T
  // and dP^T accumulators' columns (queries of the tile) 8 i + 2 (lane %
  // 4) (+ 1)
  reg_alloc<240>();
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_own = Ks + wg * 64 * RB, v_own = Vs + wg * 64 * RB;
  float dka[NS][SC / 2], dva[NS][SC / 2];
#pragma unroll
  for (int b = 0; b < NS; ++b)
#pragma unroll
    for (int i = 0; i < SC / 2; ++i) dka[b][i] = dva[b][i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % R;
    const uint32_t stage = Rs + st * 2 * NS * QS;
    mbar_wait(full + 8 * st, (t / R) & 1);
    float s[BQ / 2], dp[BQ / 2];  // S^T, dP^T
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t da = desc_rows<RB>(k_own + sl * KVS);
      const uint64_t db = desc_rows<RB>(stage + sl * QS);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t da = desc_rows<RB>(v_own + sl * KVS);
      const uint64_t db = desc_rows<RB>(stage + (NS + sl) * QS);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_ss(dp, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
    wgmma_commit();
    const float* ld = Ls + st * 2 * BQ + 2 * (lane % 4);
    float2 lr[BQ / 8], dl[BQ / 8];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      lr[i] = *reinterpret_cast<const float2*>(ld + 8 * i);
      dl[i] = *reinterpret_cast<const float2*>(ld + BQ + 8 * i);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const float l2 = i % 2 ? lr[i / 4].y : lr[i / 4].x;
      const float dt = i % 2 ? dl[i / 4].y : dl[i / 4].x;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -l2));
      dp[i] = s[i] * (dp[i] - dt);
    }
    uint32_t pa[PT][4], dsa[PT][4];  // bf16 P^T and dS^T
    a_from_acc(pa, s);
    a_from_acc(dsa, dp);
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t d_do = desc_rows<RB>(stage + (NS + sl) * QS);
      const uint64_t d_q = desc_rows<RB>(stage + sl * QS);
#pragma unroll
      for (int kk = 0; kk < PT; ++kk) {
        wgmma_rs_t(dva[sl], pa[kk], d_do + kk * RB);
        wgmma_rs_t(dka[sl], dsa[kk], d_q + kk * RB);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NS; ++b) {
      fence_regs(dva[b]);
      fence_regs(dka[b]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  const size_t head = (size_t)bh * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (kj >= seq_len) continue;
    __nv_bfloat16* rk = dk + (head + kj) * D;
    __nv_bfloat16* rv = dv + (head + kj) * D;
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int i = 0; i < SC / 8; ++i) {
        const int c = b * SC + i * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(rk + c) = __floats2bfloat162_rn(
            dka[b][4 * i + 2 * r] * scale, dka[b][4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(rv + c) = __floats2bfloat162_rn(
            dva[b][4 * i + 2 * r], dva[b][4 * i + 2 * r + 1]);
      }
  }
}

// Shared memory of flash_dkv_narrow_kernel<D>: the 1024-byte alignment
// slack, K and V, the ring, the rows of lse and delta and the barriers.
template <int D>
constexpr int dkv_narrow_smem() {
  return 1024 + D * 2 * (2 * 128 + 2 * FLASH_DKV_NARROW_STAGES * kDkvNarrowQ) +
         FLASH_DKV_NARROW_STAGES * 2 * kDkvNarrowQ * 4 +
         8 * (1 + 2 * FLASH_DKV_NARROW_STAGES);
}
static_assert(dkv_narrow_smem<64>() <= kMaxSmem, "K6's narrow ring fits");

template <int D>
cudaError_t launch_dkv_narrow(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int seq_len, float scale, cudaStream_t stream) {
  constexpr int SC = kNarrowCols<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_box(&tq, q, bh, seq_len, D, SC, kDkvNarrowQ)) !=
          cudaSuccess ||
      (err = encode_box(&tk, k, bh, seq_len, D, SC, 128)) != cudaSuccess ||
      (err = encode_box(&tv, v, bh, seq_len, D, SC, 128)) != cudaSuccess ||
      (err = encode_box(&tdo, dout, bh, seq_len, D, SC, kDkvNarrowQ)) !=
          cudaSuccess)
    return err;
  const int smem = dkv_narrow_smem<D>();
  err = cudaFuncSetAttribute(flash_dkv_narrow_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + 127) / 128, bh);
  flash_dkv_narrow_kernel<D><<<grid, 3 * kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq_len, scale);
  return cudaGetLastError();
}

// K5 in bf16 at d 32 and 64, narrow wgmma route (flash_wgmma.cuh: rows
// that TMA can read): flash_dq_narrow_kernel<D, NWG>. One block per (bh,
// 64 NWG query rows); warpgroups 0 .. NWG - 1 consume, 64 query rows each,
// end to end with no handoff; warpgroup NWG produces (one thread issues
// every TMA copy). Q and dO of the block's rows are staged once (a box of
// 64 NWG rows a slice); per tile of 128 keys, K and V stream through a
// ring of R stages with full and empty mbarriers for each (the empty ones
// take one arrival from each consumer warp). Per tile a consumer issues
// S_j = Q K_j^T and dP_j = dO V_j^T (wgmma m64n128k16, both from shared
// memory) and dQ += bf16(dS_{j-1}) K_{j-1} (dS from registers, K
// transposed by the descriptor, as K4's P V takes V) as two groups, and
// forms P_j = exp2(S_j scale log2(e) - lse log2(e)) (keys past T: P = 0,
// their rows read as zeros) and dS_j = P_j (dP_j - delta) in f32 while
// the dQ product is in flight: its exponentials overlap the tensor cores,
// as flash_fwd_narrow_kernel's softmax does. dS is rounded to bf16 as the
// A operand, where the Pallas kernel rounds it (flash_attention.py:179).
// lse log2(e) and delta of a thread's two rows stay in registers. V's
// stage is released once S and dP have landed, K's once the dQ product
// that read it has. Registers a consumer thread: S 64, dP 64, bf16(dS)
// 32, dQ D / 2. Padded query rows are zeros with lse = delta = 0 and are
// not stored; dQ (times the scale, applied once) is written once, one
// writer an element, no atomics.
//
// Consumer warpgroups a block (a variant builds with an nvcc -D flag,
// scripts/torch_flash_variants.py --set narrow): one at d 32, where two
// blocks share an SM (232 registers a consumer thread), two at d 64 (240);
// three would leave 160, below the ~200 that S, dP, bf16(dS) and dQ hold
// live at once. The ring holds FLASH_DQ_NARROW_STAGES tiles at most, fewer
// where the block's share of the SM is smaller.
#ifndef FLASH_DQ_NARROW_WGS32
#define FLASH_DQ_NARROW_WGS32 1
#endif
#ifndef FLASH_DQ_NARROW_WGS64
#define FLASH_DQ_NARROW_WGS64 2
#endif
#ifndef FLASH_DQ_NARROW_STAGES
#define FLASH_DQ_NARROW_STAGES 4
#endif
constexpr int kDqNarrowKeys = 128;
template <int D>
constexpr int kDqNarrowWgs =
    D == 32 ? FLASH_DQ_NARROW_WGS32 : FLASH_DQ_NARROW_WGS64;
static_assert(kDqNarrowWgs<32> >= 1 && kDqNarrowWgs<32> <= 3 &&
                  kDqNarrowWgs<64> >= 1 && kDqNarrowWgs<64> <= 3,
              "one to three consumer warpgroups");

// Shared memory of flash_dq_narrow_kernel<D, NWG> with R ring stages: the
// 1024-byte alignment slack, Q and dO, the K and V rings and the barriers.
template <int D, int NWG>
constexpr int dq_narrow_smem(int stages) {
  return 1024 + D * 2 * (2 * NWG * 64 + 2 * stages * kDqNarrowKeys) +
         8 * (1 + 4 * stages);
}
// The deepest ring up to FLASH_DQ_NARROW_STAGES that fits the block's
// share of the SM (1 KB of it reserved a block).
template <int D, int NWG>
constexpr int dq_narrow_stages() {
  int r = FLASH_DQ_NARROW_STAGES;
  while (r > 2 && dq_narrow_smem<D, NWG>(r) >
                      kMaxSmem / kNarrowBlocks<NWG> -
                          1024 * (kNarrowBlocks<NWG> - 1))
    --r;
  return r;
}
// (a variable template: nvcc takes no call of a host function in device
// code, constexpr or not)
template <int D, int NWG>
constexpr int kDqNarrowStages = dq_narrow_stages<D, NWG>();

template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * kWgThreads, kNarrowBlocks<NWG>)
    flash_dq_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int seq_len,
                           float scale) {
  constexpr int SC = kNarrowCols<D>, NS = kNarrowSlices<D>;
  constexpr int RB = 2 * SC;                // bytes of a slice's row
  constexpr int BK = kDqNarrowKeys;
  constexpr int R = kDqNarrowStages<D, NWG>;
  constexpr int QS = NWG * 64 * RB;         // a slice of Q or dO
  constexpr int KS = BK * RB;               // a slice of a K or V tile
  constexpr int KT = SC / 16;               // k16 steps a slice of d
  constexpr int PT = BK / 16;               // k16 steps of dS K
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;                 // [NS] slices
  const uint32_t dOs = Qs + NS * QS;        // [NS] slices
  const uint32_t Ks = dOs + NS * QS;        // [R][NS] slices
  const uint32_t Vs = Ks + R * NS * KS;     // [R][NS] slices
  const uint32_t qd_full = Vs + R * NS * KS;
  const uint32_t k_full = qd_full + 8, v_full = k_full + 8 * R;
  const uint32_t k_empty = v_full + 8 * R, v_empty = k_empty + 8 * R;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * NWG * 64, bh = blockIdx.y;
  const int ntiles = (seq_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 4 * NWG);
      mbar_init(v_empty + 8 * i, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // producer
    reg_dealloc<24>();
    if (tid != 0) return;
    mbar_expect(qd_full, 2 * NS * QS);
    for (int s = 0; s < NS; ++s) {
      tma_slice(Qs + s * QS, &tq, s * SC, q0, bh, qd_full);
      tma_slice(dOs + s * QS, &tdo, s * SC, q0, bh, qd_full);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % R;
      const uint32_t par = ((j / R) & 1) ^ 1;  // the stage's last use done
      mbar_wait(k_empty + 8 * st, par);
      mbar_expect(k_full + 8 * st, NS * KS);
      for (int s = 0; s < NS; ++s)
        tma_slice(Ks + (st * NS + s) * KS, &tk, s * SC, j * BK, bh,
                  k_full + 8 * st);
      mbar_wait(v_empty + 8 * st, par);
      mbar_expect(v_full + 8 * st, NS * KS);
      for (int s = 0; s < NS; ++s)
        tma_slice(Vs + (st * NS + s) * KS, &tv, s * SC, j * BK, bh,
                  v_full + 8 * st);
    }
    return;
  }

  // consumers: rows q0 + 64 wg + 16 warp + lane / 4 (+ 8); the S and dP
  // accumulators' columns (keys of the tile) 8 i + 2 (lane % 4) (+ 1)
  reg_alloc<kNarrowRegs<NWG>>();
  const float scale_log2 = scale * kLog2e;
  const size_t head = (size_t)bh * seq_len;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    l2[r] = qi < seq_len ? lse[head + qi] * kLog2e : 0.f;
    dl[r] = qi < seq_len ? delta[head + qi] : 0.f;
  }
  float acc[NS][SC / 2];
#pragma unroll
  for (int b = 0; b < NS; ++b)
#pragma unroll
    for (int i = 0; i < SC / 2; ++i) acc[b][i] = 0.f;
  float s[BK / 2], dp[BK / 2];  // S_j, then P_j; dP_j, then dS_j (f32)
  uint32_t dsa[PT][4];          // bf16(dS_j), the A operand of dS_j K_j
  const uint32_t q_own = Qs + wg * 64 * RB, do_own = dOs + wg * 64 * RB;

  // S = Q K_j^T and dP = dO V_j^T over the NS slices of d, one group
  auto issue_sdp = [&](int j) {
    const int st = j % R;
    mbar_wait(k_full + 8 * st, (j / R) & 1);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t da = desc_rows<RB>(q_own + sl * QS);
      const uint64_t db = desc_rows<RB>(Ks + (st * NS + sl) * KS);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
    mbar_wait(v_full + 8 * st, (j / R) & 1);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t da = desc_rows<RB>(do_own + sl * QS);
      const uint64_t db = desc_rows<RB>(Vs + (st * NS + sl) * KS);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        wgmma_ss(dp, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
    wgmma_commit();
  };
  // dQ += bf16(dS_j) K_j into the NS output slices, one group
  auto issue_dq = [&](int j) {
    const int st = j % R;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t dk = desc_rows<RB>(Ks + (st * NS + sl) * KS);
#pragma unroll
      for (int kk = 0; kk < PT; ++kk)
        wgmma_rs_t(acc[sl], dsa[kk], dk + kk * RB);
    }
    wgmma_commit();
  };
  // P and dS of tile j, dS in place of dP, in f32
  auto grads = [&](int j) {
    const int k0 = j * BK;
    const bool ragged = k0 + BK > seq_len;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      float p = fast_exp2(fmaf(s[i], scale_log2, -l2[r]));
      if (ragged && k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
        p = 0.f;
      dp[i] = p * (dp[i] - dl[r]);
    }
  };
  auto release = [&](uint32_t empty, int j) {
    if (lane == 0) mbar_arrive(empty + 8 * (j % R));
  };
  mbar_wait(qd_full, 0);
  wgmma_fence();
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  release(v_empty, 0);
  grads(0);
  a_from_acc(dsa, dp);
  for (int j = 1; j < ntiles; ++j) {
    wgmma_fence();
    issue_sdp(j);
    issue_dq(j - 1);
    wgmma_wait<1>();  // S_j and dP_j have landed; dS_{j-1} K_{j-1} may run
    fence_regs(s);
    fence_regs(dp);
    release(v_empty, j);
    grads(j);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NS; ++b) fence_regs(acc[b]);
    release(k_empty, j - 1);
    a_from_acc(dsa, dp);
  }
  wgmma_fence();
  issue_dq(ntiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NS; ++b) fence_regs(acc[b]);
  release(k_empty, ntiles - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    __nv_bfloat16* row = dq + (head + qi) * D;
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int i = 0; i < SC / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + b * SC + i * 8 +
                                           (lane % 4) * 2) =
            __floats2bfloat162_rn(acc[b][4 * i + 2 * r] * scale,
                                  acc[b][4 * i + 2 * r + 1] * scale);
  }
}
static_assert(dq_narrow_smem<64, kDqNarrowWgs<64>>(
                  kDqNarrowStages<64, kDqNarrowWgs<64>>) <=
                  kMaxSmem / kNarrowBlocks<kDqNarrowWgs<64>>,
              "K5's narrow ring fits at d 64");
static_assert(dq_narrow_smem<32, kDqNarrowWgs<32>>(
                  kDqNarrowStages<32, kDqNarrowWgs<32>>) <=
                  kMaxSmem / kNarrowBlocks<kDqNarrowWgs<32>>,
              "K5's narrow ring fits at d 32");

template <int D>
cudaError_t launch_dq_narrow(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh,
                             int seq_len, float scale, cudaStream_t stream) {
  constexpr int NWG = kDqNarrowWgs<D>, SC = kNarrowCols<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_box(&tq, q, bh, seq_len, D, SC, NWG * 64)) !=
          cudaSuccess ||
      (err = encode_box(&tk, k, bh, seq_len, D, SC, kDqNarrowKeys)) !=
          cudaSuccess ||
      (err = encode_box(&tv, v, bh, seq_len, D, SC, kDqNarrowKeys)) !=
          cudaSuccess ||
      (err = encode_box(&tdo, dout, bh, seq_len, D, SC, NWG * 64)) !=
          cudaSuccess)
    return err;
  const int smem = dq_narrow_smem<D, NWG>(kDqNarrowStages<D, NWG>);
  err = cudaFuncSetAttribute(flash_dq_narrow_kernel<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + NWG * 64 - 1) / (NWG * 64), bh);
  flash_dq_narrow_kernel<D, NWG><<<grid, (NWG + 1) * kWgThreads, smem,
                                   stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      seq_len, scale);
  return cudaGetLastError();
}

// K5 in bf16, wgmma route (flash_wgmma.cuh: 16-byte aligned rows), d in
// (128, 256] (FLASH_DQ_WGMMA_ROWS 128, the default): K4's layout. One
// block per (bh, 128 query rows); warpgroups 0 and 1 consume, 64 query
// rows each, with no handoff; warpgroup 2 produces (one thread issues
// every TMA copy). Q's and dO's NB 64-column slices of the block's rows
// are staged once; per 64-key tile the NB K slices stream through a ring
// of `rk` 8 KB stages and the NB V slices through a ring of `rv`. Each
// consumer warpgroup takes S = Q K^T and dP = dO V^T over all of d (both
// on wgmma from shared memory, issued together), releases the V stages,
// forms P = exp2(S scale log2(e) - lse log2(e)) (keys past T: P = 0, their
// rows read as zeros and would score 0, not -inf) and dS = P (dP - delta)
// in f32 registers, rounds dS to bf16 as the A operand, where the Pallas
// kernel rounds it (flash_attention.py:179), and takes dQ += bf16(dS) K
// over its NB accumulators (K transposed by the descriptor, as K4's P V
// takes V), then releases the K stages. So the scores are computed once
// per (query tile, key tile), and the two warpgroups run apart: one's
// exponentials overlap the other's products. Registers a thread: dQ
// 32 NB, S and dP 32 each. Padded query rows are zeros with lse = delta =
// 0 and are not stored; dQ (times the scale, applied once) is written
// once, one writer an element. Shared memory (dq_wgmma_smem): 1 KB slack,
// Q and dO 4 NB 8 KB, the rings (rk + rv) 8 KB, barriers 8 (1 + 2 rk +
// 2 rv) bytes: at d 256 (NB 4, rk 8, rv 4) 230,600 of 232,448 bytes.
template <int NB>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int seq_len,
                          int head_dim, float scale, int rk, int rv) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;                      // [NB][2] slices
  const uint32_t dOs = Qs + NB * 2 * kSliceBytes;  // [NB][2] slices
  const uint32_t Ks = dOs + NB * 2 * kSliceBytes;  // [rk] slices
  const uint32_t Vs = Ks + rk * kSliceBytes;       // [rv] slices
  const uint32_t bars = Vs + rv * kSliceBytes;
  const uint32_t qd_full = bars;
  const uint32_t k_full = bars + 8, k_empty = k_full + 8 * rk;
  const uint32_t v_full = k_empty + 8 * rk, v_empty = v_full + 8 * rv;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * 128, bh = blockIdx.y;
  const int ntiles = (seq_len + kSlice - 1) / kSlice;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < rk; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 8);
    }
    for (int i = 0; i < rv; ++i) {
      mbar_init(v_full + 8 * i, 1);
      mbar_init(v_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    reg_dealloc<24>();
    if (tid != 0) return;
    mbar_expect(qd_full, NB * 4 * kSliceBytes);
    for (int s = 0; s < NB; ++s)
      for (int h = 0; h < 2; ++h) {
        tma_slice(Qs + (2 * s + h) * kSliceBytes, &tq, s * kSlice,
                  q0 + h * kSlice, bh, qd_full);
        tma_slice(dOs + (2 * s + h) * kSliceBytes, &tdo, s * kSlice,
                  q0 + h * kSlice, bh, qd_full);
      }
    int ki = 0, vi = 0;
    for (int t = 0; t < ntiles; ++t) {
      for (int s = 0; s < NB; ++s, ++ki) {
        const int st = ki % rk;
        mbar_wait(k_empty + 8 * st, ((ki / rk) & 1) ^ 1);
        mbar_expect(k_full + 8 * st, kSliceBytes);
        tma_slice(Ks + st * kSliceBytes, &tk, s * kSlice, t * kSlice, bh,
                  k_full + 8 * st);
      }
      for (int s = 0; s < NB; ++s, ++vi) {
        const int st = vi % rv;
        mbar_wait(v_empty + 8 * st, ((vi / rv) & 1) ^ 1);
        mbar_expect(v_full + 8 * st, kSliceBytes);
        tma_slice(Vs + st * kSliceBytes, &tv, s * kSlice, t * kSlice, bh,
                  v_full + 8 * st);
      }
    }
    return;
  }

  // consumers: rows q0 + 64 wg + 16 warp + lane / 4 (+ 8)
  reg_alloc<240>();
  const float scale_log2 = scale * kLog2e;
  const size_t head = (size_t)bh * seq_len;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wg * kSlice + warp * 16 + lane / 4 + 8 * r;
    l2[r] = qi < seq_len ? lse[head + qi] * kLog2e : 0.f;
    dl[r] = qi < seq_len ? delta[head + qi] : 0.f;
  }
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  const uint32_t q_own = Qs + wg * kSliceBytes;
  const uint32_t do_own = dOs + wg * kSliceBytes;
  mbar_wait(qd_full, 0);

  int ki = 0, vi = 0;
  for (int t = 0; t < ntiles; ++t) {
    // S = Q K^T and dP = dO V^T over the NB slices of d
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NB; ++sl) {
      const int st = (ki + sl) % rk;
      mbar_wait(k_full + 8 * st, ((ki + sl) / rk) & 1);
      const uint64_t da = desc_sw128(q_own + 2 * sl * kSliceBytes);
      const uint64_t db = desc_sw128(Ks + st * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
    wgmma_commit();
#pragma unroll
    for (int sl = 0; sl < NB; ++sl) {
      const int st = (vi + sl) % rv;
      mbar_wait(v_full + 8 * st, ((vi + sl) / rv) & 1);
      const uint64_t da = desc_sw128(do_own + 2 * sl * kSliceBytes);
      const uint64_t db = desc_sw128(Vs + st * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, da + kk * kStepK, db + kk * kStepK, sl | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0)
      for (int sl = 0; sl < NB; ++sl)
        mbar_arrive(v_empty + 8 * ((vi + sl) % rv));
    vi += NB;

    const int k0 = t * kSlice;
    const bool ragged = k0 + kSlice > seq_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = fast_exp2(fmaf(s[i], scale_log2, -l2[r]));
      if (ragged && k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
        p = 0.f;
      dp[i] = p * (dp[i] - dl[r]);
    }
    uint32_t a[4][4];
    a_from_acc(a, dp);

    // dQ += bf16(dS) K, K transposed by the descriptor
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint64_t db = desc_sw128(Ks + ((ki + b) % rk) * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc[b], a[kk], db + kk * kStepMN);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (lane == 0)
      for (int b = 0; b < NB; ++b) mbar_arrive(k_empty + 8 * ((ki + b) % rk));
    ki += NB;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wg * kSlice + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    __nv_bfloat16* out = dq + (head + qi) * head_dim;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = b * kSlice + i * 8 + (lane % 4) * 2;
        if (c < head_dim)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[b][4 * i + 2 * r] * scale, acc[b][4 * i + 2 * r + 1] * scale);
      }
  }
}

// Shared memory of flash_dq_wgmma_kernel<NB> with `rk` K and `rv` V
// stages: the alignment slack, Q and dO, the rings and the barriers.
inline int dq_wgmma_smem(int nb, int rk, int rv) {
  return 1024 + (4 * nb + rk + rv) * kSliceBytes + 8 * (1 + 2 * rk + 2 * rv);
}

template <int NB>
cudaError_t launch_dq_rows(const CUtensorMap (&maps)[4], const void* lse,
                           const void* delta, void* dq, int bh, int seq_len,
                           int head_dim, float scale, cudaStream_t stream) {
  int rk = 2 * NB, rv = NB;
  while (rk > NB && dq_wgmma_smem(NB, rk, rv) > kMaxSmem) --rk;
  const int smem = dq_wgmma_smem(NB, rk, rv);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_wgmma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + 127) / 128, bh);
  flash_dq_wgmma_kernel<NB><<<grid, 3 * kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      seq_len, head_dim, scale, rk, rv);
  return cudaGetLastError();
}

// K5 in bf16, wgmma route above d 256 (at every d of the route when
// FLASH_DQ_WGMMA_ROWS is 64), where Q and dO of 128 rows would not fit:
// one block per (bh, 64 query rows, DC-column chunk c0 of dQ; DC = 64
// NB). Q's and dO's ns 64-column slices are staged once. Per 64-key tile
// the producer (warpgroup 2, one thread issuing TMA) streams K and V
// slices through a ring of `rk` 16 KB stages (a K slice and the V slice of
// the same columns), first the slices of d outside the chunk, then the NB
// chunk slices. Warpgroup 0: S = Q K^T over all of d,
// P = exp2(S scale log2(e) - lse log2(e)) in f32 (keys past T: P = 0,
// their rows read as zeros and would score 0, not -inf), handed to
// warpgroup 1 through shared memory. Warpgroup 1: dP = dO V^T over all of
// d, dS = P (dP - delta) with the f32 P, rounded to bf16 where the Pallas
// kernel rounds it (flash_attention.py:179) and handed back as the A
// fragments of the next product (the two warpgroups' accumulators share
// one layout, so a thread reads what the same thread of the other wrote).
// Then both: dQ[:, their half of the chunk] += bf16(dS) K[:, half]
// (warpgroup 0 the first NH = ceil(NB / 2) slices, warpgroup 1 the rest),
// K transposed by the descriptor, as K4's P V takes V. So the scores are
// computed once per (query tile, key tile) up to d 256 and twice at d 512.
// A stage is released (one arrival from each of the 8 consumer warps)
// once the products that read it have completed: slices outside the chunk
// after S / dP, the chunk's after both dQ products. Handoffs: named
// barriers 1 (P written), 2 (P read), 3 (dS written), 4 (dS read).
// Padded query rows are zeros with lse = delta = 0 and are not stored. dQ
// (times the scale, applied once) is written once, one writer an element.
// Shared memory (dq_pair_smem): 1 KB alignment slack, Q and dO 2 ns 8 KB,
// the ring rk 16 KB, P 16 KB, bf16(dS) 8 KB, barriers 8 (1 + 2 rk) bytes:
// d 256 (ns 4, rk 8) 222,344 bytes; d 512 (ns 8, two 256-column chunks,
// rk 4 = NB: the ring holds one tile's chunk slices) 222,280 bytes, of
// 232,448.
template <int NB>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_dq_wgmma_pair_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int seq_len,
                               int head_dim, float scale, int ns, int rk) {
  constexpr int NH = (NB + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const gbase = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(gbase);
  const uint32_t Qs = base;                          // [ns] slices
  const uint32_t dOs = Qs + ns * kSliceBytes;        // [ns] slices
  const uint32_t Rs = dOs + ns * kSliceBytes;        // [rk] stages: K, V
  const int p_off = (2 * ns + 2 * rk) * kSliceBytes;
  float4* const Ps = reinterpret_cast<float4*>(gbase + p_off);  // [8][128]
  uint4* const dSs =
      reinterpret_cast<uint4*>(gbase + p_off + 16 * 1024);      // [4][128]
  const uint32_t bars = smem_u32(dSs + 4 * kWgThreads);
  const uint32_t qd_full = bars;
  const uint32_t full = bars + 8, empty = full + 8 * rk;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kSlice, bh = blockIdx.y;
  const int cs = blockIdx.z * NB;  // the chunk's first slice
  const int c0 = cs * kSlice;
  const int ntiles = (seq_len + kSlice - 1) / kSlice;
  // slices a key tile streams: those of d outside the chunk, then the
  // chunk's NB
  const int n_out = cs + max(0, ns - cs - NB);
  const int n_tile = n_out + NB;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < rk; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    reg_dealloc<24>();
    if (tid != 0) return;
    mbar_expect(qd_full, 2 * ns * kSliceBytes);
    for (int s = 0; s < ns; ++s) {
      tma_slice(Qs + s * kSliceBytes, &tq, s * kSlice, q0, bh, qd_full);
      tma_slice(dOs + s * kSliceBytes, &tdo, s * kSlice, q0, bh, qd_full);
    }
    int ri = 0;
    for (int t = 0; t < ntiles; ++t) {
      for (int idx = 0; idx < n_tile; ++idx, ++ri) {
        const int sl = idx < cs ? idx : idx < n_out ? idx + NB
                                                    : cs + idx - n_out;
        const int st = ri % rk;
        const uint32_t stage = Rs + st * 2 * kSliceBytes;
        mbar_wait(empty + 8 * st, ((ri / rk) & 1) ^ 1);
        mbar_expect(full + 8 * st, 2 * kSliceBytes);
        tma_slice(stage, &tk, sl * kSlice, t * kSlice, bh, full + 8 * st);
        tma_slice(stage + kSliceBytes, &tv, sl * kSlice, t * kSlice, bh,
                  full + 8 * st);
      }
    }
    return;
  }

  // consumers: query rows q0 + 16 warp + lane / 4 (+ 8); accumulator
  // columns (keys of the tile, then dQ's) 8 i + 2 (lane % 4) (+ 1)
  reg_alloc<240>();
  const float scale_log2 = scale * kLog2e;
  const size_t head = (size_t)bh * seq_len;
  float row[2];  // lse log2(e) (warpgroup 0) or delta (warpgroup 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    row[r] = qi >= seq_len ? 0.f
             : wg == 0     ? lse[head + qi] * kLog2e
                           : delta[head + qi];
  }
  const uint32_t own = wg == 0 ? Qs : dOs;           // Q for S, dO for dP
  const uint32_t other = wg == 0 ? 0 : kSliceBytes;  // K or V in a stage
  // dQ's chunk slices b0 + b, b < nw: the first NH in warpgroup 0
  const int b0 = wg == 0 ? 0 : NH, nw = wg == 0 ? NH : NB - NH;
  float acc[NH][32];
#pragma unroll
  for (int b = 0; b < NH; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  mbar_wait(qd_full, 0);

  int ri = 0;
  for (int t = 0; t < ntiles; ++t) {
    float s[32];  // S (warpgroup 0) or dP (warpgroup 1)
    const int first = ri;
    wgmma_fence();
    for (int idx = 0; idx < n_tile; ++idx, ++ri) {
      const int sl = idx < cs ? idx : idx < n_out ? idx + NB
                                                  : cs + idx - n_out;
      const int st = ri % rk;
      mbar_wait(full + 8 * st, (ri / rk) & 1);
      if (sl < ns) {
        const uint64_t da = desc_sw128(own + sl * kSliceBytes);
        const uint64_t db = desc_sw128(Rs + st * 2 * kSliceBytes + other);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, idx | kk);
        wgmma_commit();
      }
      if (idx < n_out) {  // a slice outside the chunk: done with it
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }
    wgmma_wait<0>();
    fence_regs(s);

    uint32_t a[4][4];  // bf16(dS), the A operand of dQ's product
    if (wg == 0) {
      const int k0 = t * kSlice;
      const bool ragged = k0 + kSlice > seq_len;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -row[(i / 2) % 2]));
        if (ragged && k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
          s[i] = 0.f;
      }
      if (t > 0) named_sync(2);  // warpgroup 1 has read the last P
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[j * kWgThreads + tid] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      named_arrive(1);
      named_sync(3);  // bf16(dS) of this tile written
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 w = dSs[kk * kWgThreads + tid];
        a[kk][0] = w.x;
        a[kk][1] = w.y;
        a[kk][2] = w.z;
        a[kk][3] = w.w;
      }
      if (t + 1 < ntiles) named_arrive(4);
    } else {
      named_sync(1);  // P of this tile written
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = Ps[j * kWgThreads + tid];
        s[4 * j + 0] = p.x * (s[4 * j + 0] - row[0]);
        s[4 * j + 1] = p.y * (s[4 * j + 1] - row[0]);
        s[4 * j + 2] = p.z * (s[4 * j + 2] - row[1]);
        s[4 * j + 3] = p.w * (s[4 * j + 3] - row[1]);
      }
      if (t + 1 < ntiles) named_arrive(2);
      a_from_acc(a, s);
      if (t > 0) named_sync(4);  // warpgroup 0 has read the last dS
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dSs[kk * kWgThreads + tid] =
            make_uint4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
      named_arrive(3);
    }

    // dQ[:, own slices] += bf16(dS) K[:, own slices]: K transposed by the
    // descriptor, a k16 step is 16 keys. Outside the branches above, so
    // that ptxas keeps the products asynchronous; at NB = 3 warpgroup 1's
    // second product repeats its one slice and is not stored.
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NH; ++b) {
      const int st = (first + n_out + min(b0 + b, NB - 1)) % rk;
      const uint64_t db = desc_sw128(Rs + st * 2 * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc[b], a[kk], db + kk * kStepMN);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NH; ++b) fence_regs(acc[b]);
    if (lane == 0)
      for (int b = 0; b < NB; ++b)
        mbar_arrive(empty + 8 * ((first + n_out + b) % rk));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    __nv_bfloat16* out = dq + (head + qi) * head_dim;
#pragma unroll
    for (int b = 0; b < NH; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + (b0 + b) * kSlice + i * 8 + (lane % 4) * 2;
        if (b < nw && c < head_dim)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[b][4 * i + 2 * r] * scale, acc[b][4 * i + 2 * r + 1] * scale);
      }
  }
}

// Shared memory of flash_dq_wgmma_pair_kernel with `rk` stages: the
// 1024-byte alignment slack, Q and dO, the ring, P, bf16(dS) and the
// barriers.
inline int dq_pair_smem(int ns, int rk) {
  return 1024 + (2 * ns + 2 * rk) * kSliceBytes + 16 * 1024 + 8 * 1024 +
         8 * (1 + 2 * rk);
}

// The layout of the wgmma K5 up to d 256: 128 query rows a block, one
// warpgroup each 64 (flash_dq_wgmma_kernel), or 64 a block shared by the
// two warpgroups through the P and dS handoffs (64:
// flash_dq_wgmma_pair_kernel, which takes d above 256 either way).
// scripts/torch_flash_wide.py times both: at I's d 256 the first took
// 0.32 ms and the second 0.57 ms at [8, 1, 4096, 256] on the H100.
#ifndef FLASH_DQ_WGMMA_ROWS
#define FLASH_DQ_WGMMA_ROWS 128
#endif

template <int NB>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int seq_len,
                            int head_dim, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err;
  for (int i = 0; i < 4; ++i)
    if ((err = encode_rows(&maps[i], ptrs[i], bh, seq_len, head_dim)) !=
        cudaSuccess)
      return err;
  if (FLASH_DQ_WGMMA_ROWS == 128 && head_dim <= 256)
    return launch_dq_rows<NB>(maps, lse, delta, dq, bh, seq_len, head_dim,
                              scale, stream);
  const int ns = (head_dim + kSlice - 1) / kSlice;
  // the ring holds the chunk's NB slices of a tile at once, and at most
  // two tiles' worth
  int rk = 8;
  while (rk > NB && dq_pair_smem(ns, rk) > kMaxSmem) --rk;
  const int smem = dq_pair_smem(ns, rk);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_dq_wgmma_pair_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kSlice - 1) / kSlice, bh,
                  wgmma_chunks(head_dim));
  flash_dq_wgmma_pair_kernel<NB><<<grid, 3 * kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      seq_len, head_dim, scale, ns, rk);
  return cudaGetLastError();
}

cudaError_t launch_wide(int which, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* out0, void* out1, int bh,
                        int seq_len, int head_dim, float scale, int dtype,
                        cudaStream_t stream) {
  const int nch = wide_chunks(head_dim);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 1 && wgmma_route(head_dim, {q, k, v, dout})) {
    const bool three = wgmma_boxes(head_dim) == 3;
    if (which == 0)
      return three ? launch_dq_wgmma<3>(q, k, v, dout, lse, delta, out0, bh,
                                        seq_len, head_dim, scale, stream)
                   : launch_dq_wgmma<4>(q, k, v, dout, lse, delta, out0, bh,
                                        seq_len, head_dim, scale, stream);
    return three ? launch_dkv_wgmma<3>(q, k, v, dout, lse, delta, out0, out1,
                                       bh, seq_len, head_dim, scale, stream)
                 : launch_dkv_wgmma<4>(q, k, v, dout, lse, delta, out0, out1,
                                       bh, seq_len, head_dim, scale, stream);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const bf* q_ = static_cast<const bf*>(q);
    const bf* k_ = static_cast<const bf*>(k);
    const bf* v_ = static_cast<const bf*>(v);
    const bf* do_ = static_cast<const bf*>(dout);
    const bool aligned = rows_aligned(head_dim, {q, k, v, dout});
    const dim3 grid((seq_len + kMmaRows - 1) / kMmaRows, bh, nch);
    const int smem = (2 * kMmaRows + 2 * kWideKeys) * kMmaLd<kWideCols> *
                         (int)sizeof(bf) +
                     (which == 0 ? 0 : 2 * kWideKeys * (int)sizeof(float));
    if (which == 0) {
      auto* kernel = aligned ? flash_dq_wide_mma_kernel<true>
                             : flash_dq_wide_mma_kernel<false>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kMmaThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<bf*>(out0), seq_len,
          head_dim, scale);
    } else {
      auto* kernel = aligned ? flash_dkv_wide_mma_kernel<true>
                             : flash_dkv_wide_mma_kernel<false>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kMmaThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<bf*>(out0),
          static_cast<bf*>(out1), seq_len, head_dim, scale);
    }
  } else if (dtype == 0) {
    const float* q_ = static_cast<const float*>(q);
    const float* k_ = static_cast<const float*>(k);
    const float* v_ = static_cast<const float*>(v);
    const float* do_ = static_cast<const float*>(dout);
    const dim3 grid((seq_len + kBQ - 1) / kBQ, bh, nch);
    if (which == 0) {
      const int smem =
          ((2 * kBQ + 2 * kBK) * kWideLdF + kBQ * kLDP) * (int)sizeof(float);
      err = cudaFuncSetAttribute(flash_dq_wide_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_dq_wide_kernel<<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<float*>(out0), seq_len,
          head_dim, scale);
    } else {
      const int smem = ((2 * kBK + 2 * kBQ) * kWideLdF + 2 * kBK * kLDP +
                        2 * kBQ) *
                       (int)sizeof(float);
      err = cudaFuncSetAttribute(flash_dkv_wide_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_dkv_wide_kernel<<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<float*>(out0),
          static_cast<float*>(out1), seq_len, head_dim, scale);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// which = 0 launches K5 (out0 = dq), which = 1 launches K6 (out0 = dk,
// out1 = dv): the tensor-core kernels in bf16, the FP32 ones in f32.
template <typename T, int D>
cudaError_t launch(int which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* out0, void* out1, int bh, int seq_len, int head_dim,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return which == 0 ? launch_dq_mma<D>(q, k, v, dout, lse, delta, out0, bh,
                                         seq_len, head_dim, scale, stream)
                      : launch_dkv_mma<D>(q, k, v, dout, lse, delta, out0,
                                          out1, bh, seq_len, head_dim, scale,
                                          stream);
  } else {
    const dim3 grid((seq_len + kBQ - 1) / kBQ, bh);
    const float* q_ = static_cast<const float*>(q);
    const float* k_ = static_cast<const float*>(k);
    const float* v_ = static_cast<const float*>(v);
    const float* do_ = static_cast<const float*>(dout);
    const float* lse_ = static_cast<const float*>(lse);
    const float* delta_ = static_cast<const float*>(delta);
    if (which == 0) {
      const int smem = dq_smem_floats<D>() * (int)sizeof(float);
      const cudaError_t err = cudaFuncSetAttribute(
          flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<float*>(out0), seq_len,
          head_dim, scale);
    } else {
      const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
      const cudaError_t err = cudaFuncSetAttribute(
          flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, do_, lse_, delta_, static_cast<float*>(out0),
          static_cast<float*>(out1), seq_len, head_dim, scale);
    }
    return cudaGetLastError();
  }
}

cudaError_t launch_any(int which, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, void* out0, void* out1, int bh,
                       int seq_len, int head_dim, float scale, int dtype,
                       void* stream) {
  if (head_dim > 128)
    return launch_wide(which, q, k, v, dout, lse, delta, out0, out1, bh,
                       seq_len, head_dim, scale, dtype,
                       static_cast<cudaStream_t>(stream));
  if (which == 0 && dtype == 1 && narrow_route(head_dim, 64, {q, k, v, dout}))
    return head_dim == 32
               ? launch_dq_narrow<32>(q, k, v, dout, lse, delta, out0, bh,
                                      seq_len, scale,
                                      static_cast<cudaStream_t>(stream))
               : launch_dq_narrow<64>(q, k, v, dout, lse, delta, out0, bh,
                                      seq_len, scale,
                                      static_cast<cudaStream_t>(stream));
  if (which == 1 && dtype == 1 && narrow_route(head_dim, 64, {q, k, v, dout}))
    return head_dim == 32
               ? launch_dkv_narrow<32>(q, k, v, dout, lse, delta, out0, out1,
                                       bh, seq_len, scale,
                                       static_cast<cudaStream_t>(stream))
               : launch_dkv_narrow<64>(q, k, v, dout, lse, delta, out0, out1,
                                       bh, seq_len, scale,
                                       static_cast<cudaStream_t>(stream));
  return dispatch(dtype, head_dim, [&](auto type, auto dim) {
    return launch<typename decltype(type)::type, decltype(dim)::value>(
        which, q, k, v, dout, lse, delta, out0, out1, bh, seq_len, head_dim,
        scale, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (the tensor cores); q, k,
// v, dout and the outputs share it; lse and delta are f32 [bh, seq_len].
// Any head_dim (above 128: the wide kernels), bh <= 65535, scale =
// 1 / sqrt(head_dim). Each returns a cudaError_t.
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
