// K4: flash-attention forward. O = softmax(Q K^T / sqrt(d)) V and the
// per-row logsumexp, over q, k, v of shape [BH, T, d] (row-major).
//
// Replaces diffsci_tpu/kernels/flash_attention.py:_fwd_kernel. See
// diffsci_tpu_torch/kernels/flash_attention.py for the design note.
//
// Bound by operations: 4 T^2 d flops and T^2 exponentials per head against
// O(T d) bytes. The special-function unit gives 16 exp2 per clock per SM:
// at d 64 its floor and the tensor cores' are about equal (configuration
// H's shape on the H100: 0.193 against 0.209 ms), at d 32 the
// exponentials' lies above (A's: 0.032 against 0.017 ms). The narrow
// kernel below runs at about twice the higher of the two
// (scripts/torch_flash_variants.py --set narrow), so neither floor sets
// its time yet.
//
// Routes, by a shape rule in flash_fwd_launch; a call is one launch:
// - bf16, d 32, 64 or 128, rows that TMA can read (16-byte aligned rows
//   and bases): flash_fwd_narrow_kernel, warp-specialised on wgmma/TMA
//   (below): a producer warp streams 128-key K and V tiles through an
//   mbarrier ring; consumer warpgroups own 64 query rows each and overlap
//   their softmax with the products in flight.
// - bf16 at the other d <= 128 or on unaligned rows: flash_fwd_mma_kernel
//   on mma.sync (below).
// - f32 at d <= 128: flash_fwd_kernel on the FP32 pipes (below).
// - d above 128: the wide kernels (below).
//
// bfloat16 (flash_fwd_mma_kernel): tensor cores. One block of kMmaWarps
// warps per (bh, tile of kMmaRows query rows); each warp owns 16 query
// rows, keeps their Q fragments in registers for the whole loop and loops
// over tiles of kMmaKeys keys. K/V tiles stream through a double-buffered
// cp.async ring in bf16 shared memory (flash_mma.cuh), so the next tile
// loads while this one computes. S = Q K^T on mma.sync with f32
// accumulators; the online softmax (running max and sum, f32) works on the
// C fragments, with row reductions by quad shuffles and exponentials on
// the SFU alone (fast_exp2); P is rounded to bf16 in registers and is the
// A operand of P V, as the Pallas kernel feeds the MXU p.astype(v.dtype)
// (flash_attention.py:106). The sum l is taken over the f32 P, as there.
// O (bf16) and lse are written once. Rows that are not 16-byte aligned
// (head_dim % 8 != 0) are staged by element loads in the same kernel
// (template flag kAsync).
//
// float32 (flash_fwd_kernel): the FP32 pipes, unchanged, so the f32 path
// keeps full f32 products (TF32 or bf16 tensor cores would not hold the
// 1e-4 checks against the plain version). One block per (bh, tile of kBQ
// query rows) loops over tiles of kBK keys staged in shared memory and
// keeps the online-softmax state in f32 registers; four threads share a
// query row, each scoring a quarter of the tile's keys and owning a
// quarter of the output columns.
//
// All of them mask ragged T in the kernel, on query rows (never stored)
// and on keys (score -inf); head dims below the template's D are
// zero-padded in shared memory only. Head dims above 128: in bf16, rows that TMA can read
// up to d 512 go to flash_fwd_wgmma_kernel (warp-specialised: TMA into a
// ring of shared-memory stages, S = Q K^T once per key tile over all of d
// on wgmma, O in 256-column chunks above d 256; flash_wgmma.cuh); the rest
// (f32, unaligned rows, d > 512) to flash_fwd_wide_mma_kernel (bf16) and
// flash_fwd_wide_kernel (f32), which stage d in 128-column chunks
// (flash_common.cuh) and take any head_dim. Either way a call is one
// launch. Tile constants, conversions and dispatch: flash_common.cuh
// (shared with K5/K6); tensor-core pieces: flash_mma.cuh (mma.sync) and
// flash_wgmma.cuh (wgmma, TMA, mbarriers).
// Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace {

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles with row stride D + 4 (16-byte aligned rows, conflict-free
  // float4 reads), plus the P tile.
  return (kBQ + 2 * kBK) * (D + 4) + kBQ * kLDP;
}

// Logits are taken in the log2 domain: Q is pre-scaled by
// log2(e) / sqrt(d), so p = exp2(s - m) and lse = (m + log2 l) * ln 2.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
      val = q[base + (size_t)qi * head_dim + cc] * scale_log2;
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
        kv = k[off];
        vv = v[off];
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
        if (c < head_dim) o[row + c] = acc[4 * ch + e] * inv_l;
      }
    }
    if (t == 0)
      lse[(size_t)blockIdx.y * seq_len + qi] =
          (m + log2f(l)) * 0.69314718055994531f;
  }
}

#ifndef FLASH_FWD_KEYS
#define FLASH_FWD_KEYS 64
#endif
constexpr int kMmaKeys = FLASH_FWD_KEYS;  // keys per tile of the bf16 kernel

// Scores stay unscaled in the C fragments; p = exp2(s * scale_log2 - m *
// scale_log2) with the running max m in score units, so lse = m * scale +
// ln l.
template <int D, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int seq_len, int head_dim,
                         float scale_log2) {
  constexpr int LD = kMmaLd<D>;
  constexpr int KT = D / 16;         // k16 steps over the head dim
  constexpr int NT = D / 8;          // n8 tiles of O's columns
  constexpr int ST = kMmaKeys / 8;   // n8 tiles of a key tile
  constexpr int TILE = kMmaKeys * LD;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kMmaRows * LD;  // [2][kMmaKeys][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;       // [2][kMmaKeys][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t base = (size_t)blockIdx.y * seq_len * head_dim;
  const int ntiles = (seq_len + kMmaKeys - 1) / kMmaKeys;

  load_tile<kMmaRows, D, kAsync>(Qs, q + base, q0, seq_len, head_dim);
  load_tile<kMmaKeys, D, kAsync>(Ks, k + base, 0, seq_len, head_dim);
  load_tile<kMmaKeys, D, kAsync>(Vs, v + base, 0, seq_len, head_dim);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
    ldmatrix_x4(qa[ks],
                Qs + warp * 16 * LD + ks * 16 + a_frag_offset(lane, LD));

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows lane / 4 and lane / 4 + 8 of the warp's strip; l is this
  // thread's share of the row sum until the end
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {  // the buffer that tile t - 1 used
      const int nb = (t + 1) & 1;
      load_tile<kMmaKeys, D, kAsync>(Ks + nb * TILE, k + base,
                                     (t + 1) * kMmaKeys, seq_len, head_dim);
      load_tile<kMmaKeys, D, kAsync>(Vs + nb * TILE, v + base,
                                     (t + 1) * kMmaKeys, seq_len, head_dim);
    }
    cp_async_commit();
    const __nv_bfloat16* Kt = Ks + (t & 1) * TILE;
    const __nv_bfloat16* Vt = Vs + (t & 1) * TILE;

    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + np * 16 * LD + ks * 16 + b_frag_offset(lane, LD));
        mma_16816(s[2 * np], qa[ks], b[0], b[1]);
        mma_16816(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    const int k0 = t * kMmaKeys;
    if (k0 + kMmaKeys > seq_len) {
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + n * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
            s[n][i] = -CUDART_INF_F;
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one real key, so mx is finite
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = fast_exp2(fmaf(s[n][i], scale_log2, -ms[i / 2]));
        l[i / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's A fragments from S's C fragments, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Vt + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(acc[2 * np], pa, b[0], b[1]);
        mma_16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile t + 1 landed; tile t no longer read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const float inv_l = 1.f / l[r];
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim)
          o[row + c] = __float2bfloat16(acc[n][2 * r + e] * inv_l);
      }
    }
    if (lane % 4 == 0)
      lse[(size_t)blockIdx.y * seq_len + qi] =
          (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f;
  }
}

// ---- head dims above 128 (flash_common.cuh: any head_dim) -------------

// bf16: one block of kMmaWarps warps per (bh, tile of kMmaRows query rows,
// kWideCols-column chunk c0 of O). Per tile of kWideKeys keys, S = Q K^T
// is summed over d in chunks of kWideCols columns, each chunk of Q and K
// staged in shared memory (Q's A fragments read from there: they would not
// fit in registers); the online softmax is K4's; O's chunk += P V[:, c0:]
// with P rounded to bf16 in registers, as in K4. Every chunk block of a
// row computes the same S, m and l; the c0 = 0 block writes lse.
template <bool kAsync>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int seq_len,
                              int head_dim, float scale_log2) {
  constexpr int LD = kMmaLd<kWideCols>;
  constexpr int KT = kWideCols / 16;  // k16 steps over a chunk of d
  constexpr int NT = kWideCols / 8;   // n8 tiles of O's chunk
  constexpr int ST = kWideKeys / 8;   // n8 tiles of a key tile
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kMmaRows * LD;   // [kWideKeys][LD]
  __nv_bfloat16* Vs = Ks + kWideKeys * LD;  // [kWideKeys][LD], chunk c0

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kMmaRows, c0 = blockIdx.z * kWideCols;
  const size_t base = (size_t)blockIdx.y * seq_len * head_dim;
  const int ntiles = (seq_len + kWideKeys - 1) / kWideKeys;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;
  const __nv_bfloat16* Qw = Qs + warp * 16 * LD + a_frag_offset(lane, LD);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kWideKeys;
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // the previous chunk (and tile) no longer read
      load_block<kMmaRows, kWideCols, kAsync>(Qs, q + base, q0,
                                              ch * kWideCols, seq_len,
                                              head_dim);
      load_block<kWideKeys, kWideCols, kAsync>(Ks, k + base, k0,
                                               ch * kWideCols, seq_len,
                                               head_dim);
      if (ch == 0)
        load_block<kWideKeys, kWideCols, kAsync>(Vs, v + base, k0, c0,
                                                 seq_len, head_dim);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qw + ks * 16);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + np * 16 * LD + ks * 16 + b_frag_offset(lane, LD));
          mma_16816(s[2 * np], qa, b[0], b[1]);
          mma_16816(s[2 * np + 1], qa, b[2], b[3]);
        }
      }
    }
    if (k0 + kWideKeys > seq_len) {
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + n * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
            s[n][i] = -CUDART_INF_F;
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = fast_exp2(fmaf(s[n][i], scale_log2, -ms[i / 2]));
        l[i / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Vs + kk * 16 * LD + np * 16 + bt_frag_offset(lane, LD));
        mma_16816(acc[2 * np], pa, b[0], b[1]);
        mma_16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const float inv_l = 1.f / l[r];
    const size_t row = base + (size_t)qi * head_dim;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + n * 8 + (lane % 4) * 2 + e;
        if (c < head_dim)
          o[row + c] = __float2bfloat16(acc[n][2 * r + e] * inv_l);
      }
    }
    if (lane % 4 == 0 && blockIdx.z == 0)
      lse[(size_t)blockIdx.y * seq_len + qi] =
          (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f;
  }
}

// f32: flash_fwd_kernel's layout (kTPR threads a query row, kBK-key
// tiles) with S summed over staged kWideCols-column chunks of Q (pre-scaled
// as there) and K, and O's chunk c0 in registers.
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int seq_len, int head_dim,
                          float scale_log2) {
  constexpr int LD = kWideLdF;
  constexpr int CPT = kWideCols / (4 * kTPR);  // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;             // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;    // [kBK][LD]
  float* Vs = Ks + kBK * LD;    // [kBK][LD], chunk c0
  float* Ps = Vs + kBK * LD;    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int r = tid / kTPR, t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ, c0 = blockIdx.z * kWideCols;
  const size_t base = (size_t)blockIdx.y * seq_len * head_dim;
  const int nch = (head_dim + kWideCols - 1) / kWideCols;

  float m = -CUDART_INF_F, l = 0.f;
  float acc[4 * CPT];
#pragma unroll
  for (int i = 0; i < 4 * CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += kBK) {
    float s[kPT];
#pragma unroll
    for (int jj = 0; jj < kPT; ++jj) s[jj] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // the previous chunk (and tile) no longer read
      stage_cols(Qs, q + base, q0, ch * kWideCols, seq_len, head_dim,
                 scale_log2);
      stage_cols(Ks, k + base, k0, ch * kWideCols, seq_len, head_dim, 1.f);
      if (ch == 0)
        stage_cols(Vs, v + base, k0, c0, seq_len, head_dim, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kWideCols; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + c);
#pragma unroll
        for (int jj = 0; jj < kPT; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(
              Ks + (t + kTPR * jj) * LD + c);
          s[jj] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
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

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + r * kLDP + j);
      const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (j + u) * LD;
#pragma unroll
        for (int cq = 0; cq < CPT; ++cq) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * (t + kTPR * cq));
          acc[4 * cq + 0] += pj[u] * vv.x;
          acc[4 * cq + 1] += pj[u] * vv.y;
          acc[4 * cq + 2] += pj[u] * vv.z;
          acc[4 * cq + 3] += pj[u] * vv.w;
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
    for (int cq = 0; cq < CPT; ++cq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * (t + kTPR * cq) + e;
        if (c < head_dim) o[row + c] = acc[4 * cq + e] * inv_l;
      }
    }
    if (t == 0 && blockIdx.z == 0)
      lse[(size_t)blockIdx.y * seq_len + qi] =
          (m + log2f(l)) * 0.69314718055994531f;
  }
}

// bf16, wgmma route (flash_wgmma.cuh: d in (128, 512], 16-byte aligned
// rows): one block per (bh, 128 query rows, DC-column chunk c0 of O;
// DC = 64 NB). Warpgroups 0 and 1 consume, 64 query rows each; warpgroup
// 2 produces: one thread issues every TMA copy. Q's ns 64-column slices
// are staged once; per 64-key tile, K's ns slices stream through a ring of
// `rk` 8 KB stages and V's NB chunk slices through a ring of two tiles,
// each stage with a full and an empty mbarrier (the empty ones take one
// arrival from each of the 8 consumer warps). S = Q K^T is computed once
// per key tile over all of d (wgmma, both operands in shared memory), the
// online softmax is K4's on the accumulator, P is rounded to bf16 in
// registers and O += P V (V transposed by the descriptor) into NB
// accumulators of 64 columns. O (bf16) and, from chunk 0, lse are written
// once; rows past T are not stored and keys past T score -inf.
template <int NB>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int seq_len, int head_dim,
                           float scale_log2, int ns, int rk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;                             // [ns][2] slices
  const uint32_t Ks = Qs + ns * 2 * kSliceBytes;        // [rk] slices
  const uint32_t Vs = Ks + rk * kSliceBytes;            // [2][NB] slices
  const uint32_t bars = Vs + 2 * NB * kSliceBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, k_empty = k_full + 8 * rk;
  const uint32_t v_full = k_empty + 8 * rk, v_empty = v_full + 16;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * 128, bh = blockIdx.y;
  const int c0 = blockIdx.z * NB * kSlice;
  const int ntiles = (seq_len + kSlice - 1) / kSlice;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < rk; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(v_full + 8 * i, 1);
      mbar_init(v_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    reg_dealloc<24>();
    if (tid != 0) return;
    mbar_expect(q_full, ns * 2 * kSliceBytes);
    for (int s = 0; s < ns; ++s)
      for (int h = 0; h < 2; ++h)
        tma_slice(Qs + (2 * s + h) * kSliceBytes, &tq, s * kSlice,
                  q0 + h * kSlice, bh, q_full);
    int ki = 0;
    for (int j = 0; j < ntiles; ++j) {
      for (int s = 0; s < ns; ++s, ++ki) {
        const int st = ki % rk;
        mbar_wait(k_empty + 8 * st, ((ki / rk) & 1) ^ 1);
        mbar_expect(k_full + 8 * st, kSliceBytes);
        tma_slice(Ks + st * kSliceBytes, &tk, s * kSlice, j * kSlice, bh,
                  k_full + 8 * st);
      }
      const int vs = j & 1;
      mbar_wait(v_empty + 8 * vs, ((j >> 1) & 1) ^ 1);
      mbar_expect(v_full + 8 * vs, NB * kSliceBytes);
      for (int b = 0; b < NB; ++b)
        tma_slice(Vs + (vs * NB + b) * kSliceBytes, &tv, c0 + b * kSlice,
                  j * kSlice, bh, v_full + 8 * vs);
    }
    return;
  }

  // consumers: rows q0 + 64 wg + 16 warp + lane / 4 (+ 8)
  reg_alloc<240>();
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const uint32_t q_own = Qs + wg * kSliceBytes;
  mbar_wait(q_full, 0);

  int ki = 0;
  for (int j = 0; j < ntiles; ++j) {
    // S = Q K^T over the ns slices of d; each K stage is released once
    // the product that read it has completed
    float s[32];
    wgmma_fence();
    for (int sl = 0; sl < ns; ++sl, ++ki) {
      const int st = ki % rk;
      mbar_wait(k_full + 8 * st, (ki / rk) & 1);
      const uint64_t da = desc_sw128(q_own + 2 * sl * kSliceBytes);
      const uint64_t db = desc_sw128(Ks + st * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, da + kk * kStepK, db + kk * kStepK, sl | kk);
      wgmma_commit();
      if (sl > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(k_empty + 8 * ((ki - 1) % rk));
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty + 8 * ((ki - 1) % rk));

    const int k0 = j * kSlice;
    if (k0 + kSlice > seq_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
          s[i] = -CUDART_INF_F;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one real key, so mx is finite
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[r]));
      l[r] += s[i];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] *= alpha[(i / 2) % 2];
    uint32_t pa[4][4];
    a_from_acc(pa, s);

    // O += P V[:, c0:c0 + DC]
    const int vs = j & 1;
    mbar_wait(v_full + 8 * vs, (j >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint64_t dv = desc_sw128(Vs + (vs * NB + b) * kSliceBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t(acc[b], pa[kk], dv + kk * kStepMN);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (lane == 0) mbar_arrive(v_empty + 8 * vs);
  }

  const size_t head = (size_t)bh * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + wg * kSlice + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const float inv_l = 1.f / l[r];
    __nv_bfloat16* row = o + (head + qi) * head_dim;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + b * kSlice + i * 8 + (lane % 4) * 2;
        if (c < head_dim)
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
              acc[b][4 * i + 2 * r] * inv_l, acc[b][4 * i + 2 * r + 1] * inv_l);
      }
    if (lane % 4 == 0 && blockIdx.z == 0)
      lse[head + qi] = (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f;
  }
}

// Shared memory of flash_fwd_wgmma_kernel<NB> with `rk` K stages: the
// 1024-byte alignment slack, Q, the K and V rings and the barriers.
inline int fwd_wgmma_smem(int ns, int nb, int rk) {
  return 1024 + (2 * ns + rk + 2 * nb) * kSliceBytes + 8 * (1 + 2 * rk + 4);
}

template <int NB>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int seq_len,
                             int head_dim, float scale_log2,
                             cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = encode_rows(&tq, q, bh, seq_len, head_dim)) != cudaSuccess ||
      (err = encode_rows(&tk, k, bh, seq_len, head_dim)) != cudaSuccess ||
      (err = encode_rows(&tv, v, bh, seq_len, head_dim)) != cudaSuccess)
    return err;
  const int ns = (head_dim + kSlice - 1) / kSlice;
  int rk = 8;
  while (rk > 2 && fwd_wgmma_smem(ns, NB, rk) > kMaxSmem) --rk;
  const int smem = fwd_wgmma_smem(ns, NB, rk);
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + 127) / 128, bh, wgmma_chunks(head_dim));
  flash_fwd_wgmma_kernel<NB><<<grid, 3 * kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      seq_len, head_dim, scale_log2, ns, rk);
  return cudaGetLastError();
}

// ---- head dims 32 and 64 (and 128) in bf16: the narrow wgmma route --------

// The narrow K4's tile choices; a variant builds with an nvcc -D flag
// (scripts/torch_flash_variants.py --set narrow): consumer warpgroups a
// block at d 32, 64 and 128 (64 query rows each; with one, two blocks
// share an SM) and the depth of the K and V rings. A tile holds 128 keys.
#ifndef FLASH_NARROW_WGS32
#define FLASH_NARROW_WGS32 1
#endif
#ifndef FLASH_NARROW_WGS64
#define FLASH_NARROW_WGS64 3
#endif
#ifndef FLASH_NARROW_WGS128
#define FLASH_NARROW_WGS128 2
#endif
#ifndef FLASH_NARROW_STAGES
#define FLASH_NARROW_STAGES 3
#endif
constexpr int kNarrowKeys = 128;
template <int D>
constexpr int kNarrowWgs = D == 32   ? FLASH_NARROW_WGS32
                           : D == 64 ? FLASH_NARROW_WGS64
                                     : FLASH_NARROW_WGS128;
static_assert(kNarrowWgs<32> >= 1 && kNarrowWgs<32> <= 3 &&
                  kNarrowWgs<64> >= 1 && kNarrowWgs<64> <= 3 &&
                  kNarrowWgs<128> >= 1 && kNarrowWgs<128> <= 3,
              "one to three consumer warpgroups");

// Shared memory of flash_fwd_narrow_kernel<D, NWG> with R ring stages: the
// 1024-byte alignment slack, Q, the K and V rings and the barriers.
template <int D, int NWG>
constexpr int fwd_narrow_smem(int stages) {
  return 1024 + D * 2 * (NWG * 64 + 2 * stages * kNarrowKeys) +
         8 * (1 + 4 * stages);
}
// The deepest ring up to FLASH_NARROW_STAGES that fits the block's share
// of the SM (1 KB of it reserved a block).
template <int D, int NWG>
constexpr int fwd_narrow_stages() {
  int r = FLASH_NARROW_STAGES;
  while (r > 2 && fwd_narrow_smem<D, NWG>(r) >
                      kMaxSmem / kNarrowBlocks<NWG> -
                          1024 * (kNarrowBlocks<NWG> - 1))
    --r;
  return r;
}
// (a variable template: nvcc takes no call of a host function in device
// code, constexpr or not)
template <int D, int NWG>
constexpr int kFwdNarrowStages = fwd_narrow_stages<D, NWG>();

// bf16, narrow route (d 32, 64 or 128, 16-byte aligned rows): one block per
// (bh, 64 NWG query rows). Warpgroups 0 .. NWG - 1 consume, 64 query rows
// each, kept for the whole loop; warpgroup NWG produces: one thread issues
// every TMA copy. Q is staged once; per tile of BK keys, K and V stream
// through a ring of R stages, each with full and empty mbarriers for K and
// for V (the empty ones take one arrival from each consumer warp). A
// consumer overlaps its own exponentials with the tensor cores: S_j =
// Q K_j^T and O += P_{j-1} V_{j-1} are issued together (wgmma, S from
// shared memory, P from registers, V transposed by the descriptor), the
// online softmax of S_j runs while P_{j-1} V_{j-1} is in flight, and O is
// rescaled once that product has landed. Across warpgroups the scheduler
// interleaves one's softmax with another's products. The softmax
// is the mma.sync kernel's (running max and sum in f32, quad shuffles,
// fast_exp2) and P is rounded to bf16 in registers as the A operand of
// P V, as the Pallas kernel feeds the MXU p.astype(v.dtype); l is summed
// over the f32 P. O (bf16) and lse are written once; rows past T are not
// stored and keys past T score -inf.
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * kWgThreads, kNarrowBlocks<NWG>)
    flash_fwd_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int seq_len,
                            float scale_log2) {
  constexpr int SC = kNarrowCols<D>, NS = kNarrowSlices<D>;
  constexpr int RB = 2 * SC;                // bytes of a slice's row
  constexpr int BK = kNarrowKeys;
  constexpr int R = kFwdNarrowStages<D, NWG>;
  constexpr int QS = NWG * 64 * RB;         // a slice of Q
  constexpr int KS = BK * RB;               // a slice of a K or V tile
  constexpr int KT = SC / 16;               // k16 steps a slice of d
  constexpr int PT = BK / 16;               // k16 steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;                 // [NS] slices
  const uint32_t Ks = Qs + NS * QS;         // [R][NS] slices
  const uint32_t Vs = Ks + R * NS * KS;     // [R][NS] slices
  const uint32_t q_full = Vs + R * NS * KS;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * R;
  const uint32_t k_empty = v_full + 8 * R, v_empty = k_empty + 8 * R;

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * NWG * 64, bh = blockIdx.y;
  const int ntiles = (seq_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
    mbar_expect(q_full, NS * QS);
    for (int s = 0; s < NS; ++s)
      tma_slice(Qs + s * QS, &tq, s * SC, q0, bh, q_full);
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

  // consumers: rows q0 + 64 wg + 16 warp + lane / 4 (+ 8)
  reg_alloc<kNarrowRegs<NWG>>();
  float acc[NS][SC / 2];
#pragma unroll
  for (int b = 0; b < NS; ++b)
#pragma unroll
    for (int i = 0; i < SC / 2; ++i) acc[b][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float s[BK / 2];      // S_j, then P_j in f32
  uint32_t pa[PT][4];   // P_j in bf16, the A operand of P_j V_j
  float alpha[2];
  const uint32_t q_own = Qs + wg * 64 * RB;

  // S = Q K_j^T over the NS slices of d, committed as one group
  auto issue_s = [&](int j) {
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
    wgmma_commit();
  };
  // O += P_j V_j into the NS output slices, committed as one group
  auto issue_pv = [&](int j) {
    const int st = j % R;
    mbar_wait(v_full + 8 * st, (j / R) & 1);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const uint64_t dv = desc_rows<RB>(Vs + (st * NS + sl) * KS);
#pragma unroll
      for (int kk = 0; kk < PT; ++kk)
        wgmma_rs_t(acc[sl], pa[kk], dv + kk * RB);
    }
    wgmma_commit();
  };
  // the online softmax of S_j in place: alpha rescales the earlier O and l
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > seq_len) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= seq_len)
          s[i] = -CUDART_INF_F;
    }
    float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one real key, so mx is finite
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[r]));
      l[r] += s[i];
    }
  };
  auto release = [&](uint32_t empty, int j) {
    if (lane == 0) mbar_arrive(empty + 8 * (j % R));
  };
  mbar_wait(q_full, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  release(k_empty, 0);
  softmax(0);
  a_from_acc(pa, s);
  for (int j = 1; j < ntiles; ++j) {
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
    fence_regs(s);
    release(k_empty, j);
    softmax(j);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NS; ++b) fence_regs(acc[b]);
    release(v_empty, j - 1);
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int i = 0; i < SC / 2; ++i) acc[b][i] *= alpha[(i / 2) % 2];
    a_from_acc(pa, s);
  }
  wgmma_fence();
  issue_pv(ntiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NS; ++b) fence_regs(acc[b]);
  release(v_empty, ntiles - 1);

  const size_t head = (size_t)bh * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (qi >= seq_len) continue;
    const float inv_l = 1.f / l[r];
    __nv_bfloat16* row = o + (head + qi) * D;
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int i = 0; i < SC / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + b * SC + i * 8 +
                                           (lane % 4) * 2) =
            __floats2bfloat162_rn(acc[b][4 * i + 2 * r] * inv_l,
                                  acc[b][4 * i + 2 * r + 1] * inv_l);
    if (lane % 4 == 0)
      lse[head + qi] = (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f;
  }
}

template <int D>
cudaError_t launch_fwd_narrow(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int seq_len,
                              float scale_log2, cudaStream_t stream) {
  constexpr int NWG = kNarrowWgs<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = encode_box(&tq, q, bh, seq_len, D, kNarrowCols<D>, NWG * 64)) !=
          cudaSuccess ||
      (err = encode_box(&tk, k, bh, seq_len, D, kNarrowCols<D>,
                        kNarrowKeys)) != cudaSuccess ||
      (err = encode_box(&tv, v, bh, seq_len, D, kNarrowCols<D>,
                        kNarrowKeys)) != cudaSuccess)
    return err;
  const int smem = fwd_narrow_smem<D, NWG>(kFwdNarrowStages<D, NWG>);
  err = cudaFuncSetAttribute(flash_fwd_narrow_kernel<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + NWG * 64 - 1) / (NWG * 64), bh);
  flash_fwd_narrow_kernel<D, NWG><<<grid, (NWG + 1) * kWgThreads, smem,
                                    stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      seq_len, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int seq_len, int head_dim,
                        float scale_log2, int dtype, cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 1 && wgmma_route(head_dim, {q, k, v})) {
    if (wgmma_boxes(head_dim) == 3)
      return launch_fwd_wgmma<3>(q, k, v, o, lse, bh, seq_len, head_dim,
                                 scale_log2, stream);
    return launch_fwd_wgmma<4>(q, k, v, o, lse, bh, seq_len, head_dim,
                               scale_log2, stream);
  } else if (dtype == 1) {
    auto* kernel = rows_aligned(head_dim, {q, k, v})
                       ? flash_fwd_wide_mma_kernel<true>
                       : flash_fwd_wide_mma_kernel<false>;
    const int smem = (kMmaRows + 2 * kWideKeys) * kMmaLd<kWideCols> *
                     (int)sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_len + kMmaRows - 1) / kMmaRows, bh,
                    wide_chunks(head_dim));
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), seq_len, head_dim, scale_log2);
  } else if (dtype == 0) {
    const int smem =
        ((kBQ + 2 * kBK) * kWideLdF + kBQ * kLDP) * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_fwd_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_len + kBQ - 1) / kBQ, bh, wide_chunks(head_dim));
    flash_fwd_wide_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), seq_len, head_dim, scale_log2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int seq_len, int head_dim,
                       float scale_log2, cudaStream_t stream) {
  auto* kernel = rows_aligned(head_dim, {q, k, v})
                     ? flash_fwd_mma_kernel<D, true>
                     : flash_fwd_mma_kernel<D, false>;
  const int smem =
      (kMmaRows + 4 * kMmaKeys) * kMmaLd<D> * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kMmaRows - 1) / kMmaRows, bh);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), seq_len, head_dim, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int seq_len, int head_dim,
                       float scale_log2, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq_len, head_dim, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32 (FP32 kernel), 1 = bfloat16 (tensor-core
// kernel); q, k, v and o share it; lse is f32 [bh, seq_len].
// Any head_dim (above 128: the wide kernels), bh <= 65535. Returns a
// cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int seq_len,
                                int head_dim, float scale_log2, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim > 128)
    return (int)launch_wide(q, k, v, o, lse, bh, seq_len, head_dim,
                            scale_log2, dtype, st);
  if (dtype == 1 && narrow_route(head_dim, 128, {q, k, v})) {
    if (head_dim == 32)
      return (int)launch_fwd_narrow<32>(q, k, v, o, lse, bh, seq_len,
                                        scale_log2, st);
    if (head_dim == 64)
      return (int)launch_fwd_narrow<64>(q, k, v, o, lse, bh, seq_len,
                                        scale_log2, st);
    return (int)launch_fwd_narrow<128>(q, k, v, o, lse, bh, seq_len,
                                       scale_log2, st);
  }
  return (int)dispatch(dtype, head_dim, [&](auto type, auto dim) {
    using T = typename decltype(type)::type;
    constexpr int D = decltype(dim)::value;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_mma<D>(q, k, v, o, lse, bh, seq_len, head_dim, scale_log2,
                           st);
    else
      return launch_f32<D>(q, k, v, o, lse, bh, seq_len, head_dim,
                           scale_log2, st);
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
