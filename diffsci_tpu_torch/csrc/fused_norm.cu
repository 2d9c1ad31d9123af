// K2: y = SiLU(norm(x) * w + b), per (batch, channel) over the spatial
// extent, on the NC* layout where each (b, c) is one contiguous row; and
// K3, its backward.
//
// Replaces diffsci_tpu/kernels/fused_norm.py:_fwd_kernel (K2) and
// _bwd_kernel (K3). See diffsci_tpu_torch/kernels/fused_norm.py for the
// design note.
//
// Both are bound by bytes: K2 reads x and writes y, K3 reads g and x and
// writes dx, each element once. A block holds what it reads in shared
// memory, so each element is read from device memory once, and runs every
// pass over the values held there: K2 the two-pass variance of the TPU
// kernel (the mean, then the centred sum of squares) and y; K3 the row's
// sums of gu and gu * n and then dx (its rows kernel keeps gu as f32 in
// shared memory between the passes, so the second pass does no SFU work).
// The launch (`pick_shape`, one rule for both) picks one of three shapes
// from the row length S, the row count and the bytes a row holds (x; g and
// x):
// - S <= kWarpRowMax (the rows kernels): a group of lanes of one warp per
//   row (a 16-byte word a lane up to 16 lanes, kWordsPerLane words a lane
//   for longer rows), several rows a block, warp-shuffle sums only;
// - longer rows (the cluster kernels): one CTA per row up to kBlockRowMax
//   (a plain launch), else a thread block cluster of up to kMaxCluster
//   CTAs per row, enough for kFillWaves waves of the SMs; the CTAs exchange
//   their partial sums through distributed shared memory;
// - rows longer than a cluster's shared memory holds (kMaxCluster x
//   kSliceBytes, 1 MB over the arrays; no main path has one): the stream
//   kernels, one block per row streaming it from device memory in each
//   pass, the re-reads served by L2.
// A block's segments are copied in with 16-byte cp.async copies where
// their words line up, element by element at the unaligned ends (and for
// a g whose words do not line up with x's); outputs are computed from the
// values held there and stored as 16-byte words where those line up. Every
// sum runs in a fixed order (no float atomics), so one input gives one
// result.
//
// K2·S and K3·S (below K3) are K2 and K3 split in two halves each around
// an all-reduce of [rows] partial sums, for rows that lie across the ranks
// of a spatial mesh; they take the same launch rule and word paths.
//
// Plain C interface, built with nvcc and loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. blockDim.x is a multiple
// of 32 and at most 1024. The leading barrier keeps `red` from being
// overwritten while a previous call's partials are still being read.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  return warp_sum(lane < nwarps ? red[lane] : 0.f);
}

// Two sums over the block at once, in block_sum's order.
__device__ float2 block_sum2(float2 v, float2* red) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  const float2 t = lane < nwarps ? red[lane] : make_float2(0.f, 0.f);
  return make_float2(warp_sum(t.x), warp_sum(t.y));
}

// u·sigmoid(u) on the SFU: __expf is ex2.approx, __fdividef one rcp.approx
// and a multiply (0 when the denominator overflows, as u/inf is)
__device__ __forceinline__ float silu(float u) {
  return __fdividef(u, 1.f + __expf(-u));
}

// K3's per-element term: with p = (mean, rstd, w, b) of the row,
// n = (x - mean) * rstd, u = n * w + b, returns gu = g * SiLU'(u), where
// SiLU'(u) = s * (1 + u * (1 - s)), s = sigmoid(u) (on the SFU, as silu).
__device__ __forceinline__ float grad_u(float xv, float gv, float4 p,
                                        float& n) {
  n = (xv - p.x) * p.y;
  const float u = fmaf(n, p.z, p.w);
  const float s = __fdividef(1.f, 1.f + __expf(-u));
  return gv * (s * fmaf(u, 1.f - s, 1.f));
}

// ---- segments in shared memory ---------------------------------------------

// elements of T in a 16-byte word
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// p's offset within its 16-byte word, in elements
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem)
               : "memory");
}

// Waits until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// src[0, n) into buf[mis, mis + n), mis = misalign(src), so that src's
// 16-byte words land on buf's (buf 16-byte aligned): cp.async for the
// whole words, element copies at the two ends. Threads t0, t0 + step, ...
// share the work; the caller waits (cp_async_wait_all) and syncs.
template <typename T>
__device__ void load_segment(T* buf, const T* __restrict__ src, int n,
                             int t0, int step) {
  constexpr int V = kVec<T>;
  const int mis = misalign(src);
  const int head = min(n, (V - mis) % V);
  const int words = (n - head) / V;
  T* out = buf + mis;
  for (int i = t0; i < head; i += step) out[i] = src[i];
  for (int j = t0; j < words; j += step)
    cp_async_16(out + head + j * V, src + head + j * V);
  for (int i = head + words * V + t0; i < n; i += step) out[i] = src[i];
}

// This thread's sum of f(buf[i]) over i in [lo, hi), read as 16-byte words
// lo / V + t0, + step, ..., in order.
template <typename T, typename F>
__device__ __forceinline__ float words_sum(const T* buf, int lo, int hi,
                                           int t0, int step, F f) {
  constexpr int V = kVec<T>;
  const uint4* words = reinterpret_cast<const uint4*>(buf);
  float s = 0.f;
  for (int c = lo / V + t0; c * V < hi; c += step) {
    float v[V];
    unpack(words[c], v);
    if (c * V >= lo && c * V + V <= hi) {
#pragma unroll
      for (int e = 0; e < V; ++e) s += f(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        if (i >= lo && i < hi) s += f(v[e]);
      }
    }
  }
  return s;
}

// dst[i - lo] = f(buf[i]) for i in [lo, hi), by the same words as
// words_sum: 16-byte stores of whole words where dst's words line up with
// buf's (misalign(dst) == lo % V), element stores otherwise and for the
// words at the two ends (which a neighbouring row may share).
template <typename T, typename F>
__device__ __forceinline__ void words_store(T* __restrict__ dst,
                                            const T* buf, int lo, int hi,
                                            int t0, int step, F f) {
  constexpr int V = kVec<T>;
  const uint4* words = reinterpret_cast<const uint4*>(buf);
  const bool aligned = misalign(dst) == lo % V;
  for (int c = lo / V + t0; c * V < hi; c += step) {
    float v[V];
    unpack(words[c], v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = f(v[e]);
    if (aligned && c * V >= lo && c * V + V <= hi) {
      *reinterpret_cast<uint4*>(dst + (c * V - lo)) = pack(v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        if (i >= lo && i < hi) dst[i - lo] = from_f32<T>(v[e]);
      }
    }
  }
}

// K3's copy-in: the 16-byte words c = c0, c0 + step, ... below c_end of
// buf that hold src[0, n) at buf[mis, mis + n) (buf 16-byte aligned):
// cp.async for a whole word when src's words line up with buf's
// (misalign(src) == mis, x's own misalignment), element copies for the
// words at the two ends and for a g whose words do not line up with x's.
// The caller waits (cp_async_wait_all).
template <typename T>
__device__ __forceinline__ void copy_words(T* buf, const T* __restrict__ src,
                                           int n, int mis, int c0,
                                           int c_end, int step) {
  constexpr int V = kVec<T>;
  const bool lined = misalign(src) == mis;
  for (int c = c0; c < c_end; c += step) {
    const int i0 = c * V - mis;  // src's index of the word's first element
    if (lined && i0 >= 0 && i0 + V <= n) {
      cp_async_16(buf + c * V, src + i0);
    } else {
      for (int i = max(i0, 0); i < min(i0 + V, n); ++i) buf[mis + i] = src[i];
    }
  }
}

// K3's pass 1 over the segments xb and gb (one layout): this thread's sums
// of gu and gu * n over [lo, hi), by words_sum's words and order. Where
// gub is given, gu is also kept there as f32, at the same element
// positions, for pass 2.
template <typename T>
__device__ __forceinline__ float2 grad_sums(const T* xb, const T* gb,
                                            float* gub, int lo, int hi,
                                            int t0, int step, float4 p) {
  constexpr int V = kVec<T>;
  float2 s = make_float2(0.f, 0.f);
  const uint4* xw = reinterpret_cast<const uint4*>(xb);
  const uint4* gw = reinterpret_cast<const uint4*>(gb);
  for (int c = lo / V + t0; c * V < hi; c += step) {
    float xv[V], gv[V];
    unpack(xw[c], xv);
    unpack(gw[c], gv);
    if (c * V >= lo && c * V + V <= hi) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float n;
        gv[e] = grad_u(xv[e], gv[e], p, n);
        s.x += gv[e];
        s.y += gv[e] * n;
      }
      if (gub) {
        float4* out = reinterpret_cast<float4*>(gub + c * V);
#pragma unroll
        for (int e = 0; e < V; e += 4)
          out[e / 4] = make_float4(gv[e], gv[e + 1], gv[e + 2], gv[e + 3]);
      }
    } else {  // a word at a row's end, which may hold another row's
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        if (i >= lo && i < hi) {
          float n;
          const float gu = grad_u(xv[e], gv[e], p, n);
          s.x += gu;
          s.y += gu * n;
          if (gub) gub[i] = gu;
        }
      }
    }
  }
  return s;
}

// K3's pass 2: dst[i - lo] = dx = rstd * (gu * w - m_dn - n * m_dnn) for i
// in [lo, hi), stored as words_store stores; gu is recomputed from x and g,
// or read from pass 1's f32 copy gub where it is given (gb unused).
template <typename T>
__device__ __forceinline__ void grad_store(T* __restrict__ dst, const T* xb,
                                           const T* gb, const float* gub,
                                           int lo, int hi, int t0, int step,
                                           float4 p, float m_dn,
                                           float m_dnn) {
  constexpr int V = kVec<T>;
  const uint4* xw = reinterpret_cast<const uint4*>(xb);
  const uint4* gw = reinterpret_cast<const uint4*>(gb);
  const bool aligned = misalign(dst) == lo % V;
  const float a = p.y * p.z, bn = -p.y * m_dnn, c0 = -p.y * m_dn;
  for (int c = lo / V + t0; c * V < hi; c += step) {
    float v[V], gu[V];
    unpack(xw[c], v);
    if (gub) {
      const float4* in = reinterpret_cast<const float4*>(gub + c * V);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 q = in[e / 4];
        gu[e] = q.x;
        gu[e + 1] = q.y;
        gu[e + 2] = q.z;
        gu[e + 3] = q.w;
      }
    } else {
      unpack(gw[c], gu);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float n = (v[e] - p.x) * p.y;
      if (!gub) gu[e] = grad_u(v[e], gu[e], p, n);
      v[e] = fmaf(gu[e], a, fmaf(n, bn, c0));
    }
    if (aligned && c * V >= lo && c * V + V <= hi) {
      *reinterpret_cast<uint4*>(dst + (c * V - lo)) = pack(v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        if (i >= lo && i < hi) dst[i - lo] = from_f32<T>(v[e]);
      }
    }
  }
}

// ---- launch choices ----------------------------------------------------------

// The launch's choices are macros with the committed values as defaults,
// so a variant builds with an nvcc -D flag (scripts/torch_norm_variants.py).
#ifndef NORM_WARP_ROW_MAX
#define NORM_WARP_ROW_MAX 1024
#endif
#ifndef NORM_ROWS_BLOCK_BYTES
#define NORM_ROWS_BLOCK_BYTES 8192
#endif
#ifndef NORM_WORDS_PER_LANE
#define NORM_WORDS_PER_LANE 2
#endif
#ifndef NORM_BLOCK_ROW_MAX
#define NORM_BLOCK_ROW_MAX 4096
#endif
#ifndef NORM_FILL_WAVES
#define NORM_FILL_WAVES 1
#endif
#ifndef NORM_SLICE_THREADS
#define NORM_SLICE_THREADS 256
#endif
constexpr int kWarpRowMax = NORM_WARP_ROW_MAX;  // longest row of a warp
constexpr int kRowsBlockBytes = NORM_ROWS_BLOCK_BYTES;  // of each array
constexpr int kWordsPerLane = NORM_WORDS_PER_LANE;  // beyond 16 lanes a row
constexpr int kBlockRowMax = NORM_BLOCK_ROW_MAX;  // longest row of one CTA
constexpr int kFillWaves = NORM_FILL_WAVES;  // cluster CTAs, in waves of SMs
constexpr int kSliceThreads = NORM_SLICE_THREADS;
constexpr int kSliceBytes = 128 * 1024;  // most bytes a cluster CTA holds
constexpr int kMaxCluster = 8;           // the portable cluster size

// ---- K2 ---------------------------------------------------------------------

// The sum over the `lanes` lanes (a power of two) of this lane's group.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of up to kWarpRowMax elements: the block's rows_per_block rows are
// one contiguous segment of x, held in shared memory. A row takes a group
// of `lanes` lanes of one warp (a power of two; a 16-byte word or a few of
// the row each), so a warp takes 32 / lanes rows at once: the mean, then
// the centred sum of squares, each a shuffle sum within the group; y is
// computed from shared memory and stored to device memory.
template <typename T>
__global__ void norm_silu_rows_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out,
                                      int channels, int64_t rows,
                                      int row_len, int rows_per_block,
                                      int lanes, int subtract_mean,
                                      float eps) {
  extern __shared__ uint4 seg_u4[];
  T* buf = reinterpret_cast<T*>(seg_u4);
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - r0);
  const T* src = x + r0 * row_len;
  const int mis = misalign(src);
  load_segment(buf, src, nrows * row_len, threadIdx.x, blockDim.x);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / lanes, sub = lane % lanes, per_warp = 32 / lanes;
  const int c0 = (int)(r0 % channels);
  const float inv_n = 1.f / (float)row_len;
  // the loop is uniform across the warp; a group past the last row sums
  // an empty range and stores nothing
  for (int rw = warp * per_warp; rw < nrows;
       rw += (blockDim.x / 32) * per_warp) {
    const int r = rw + group;
    const int lo = mis + min(r, nrows) * row_len;
    const int hi = r < nrows ? lo + row_len : lo;
    float mean = 0.f;
    if (subtract_mean)
      mean = group_sum(words_sum(buf, lo, hi, sub, lanes,
                                 [](float v) { return v; }), lanes) * inv_n;
    const float ss = group_sum(words_sum(buf, lo, hi, sub, lanes,
                                         [=](float v) {
                                           const float d = v - mean;
                                           return d * d;
                                         }), lanes);
    if (r >= nrows) continue;
    const float rstd = rsqrtf(ss * inv_n + eps);
    const int c = (c0 + r) % channels;
    const float scale = rstd * to_f32(w[c]), bc = to_f32(b[c]);
    words_store(y + (r0 + r) * row_len, buf, lo, hi, sub, lanes,
                [=](float v) { return silu(fmaf(v - mean, scale, bc)); });
    if (sub == 0) {
      mean_out[r0 + r] = mean;
      rstd_out[r0 + r] = rstd;
    }
  }
}

// Longer rows: a cluster of CTAs per row, CTA `rank` holding the slice
// [rank * slice, (rank + 1) * slice) in shared memory. Each sum is the
// block's sum of its slice, then the sum of the cluster's partials read
// through distributed shared memory in one fixed order, so every CTA of
// the row gets the same mean and rstd.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads)
    norm_silu_cluster_kernel(const T* __restrict__ x,
                             const T* __restrict__ w,
                             const T* __restrict__ b, T* __restrict__ y,
                             float* __restrict__ mean_out,
                             float* __restrict__ rstd_out, int channels,
                             int row_len, int slice, int subtract_mean,
                             float eps) {
  extern __shared__ uint4 seg_u4[];
  __shared__ float red[32];
  __shared__ float part[2];
  T* buf = reinterpret_cast<T*>(seg_u4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / cs;
  const int off = rank * slice;
  const int n = max(0, min(slice, row_len - off));
  const T* src = x + row * row_len + off;
  const int mis = misalign(src);
  const int tid = threadIdx.x, nt = blockDim.x;
  load_segment(buf, src, n, tid, nt);
  cp_async_wait_all();
  __syncthreads();

  // lane r of every warp reads rank r's partial; the warp's shuffle sum
  // runs in one order in every warp of every CTA of the row
  const int lane = tid % 32;
  auto cluster_sum = [&](float v, int slot) {
    v = block_sum(v, red);
    if (tid == 0) part[slot] = v;
    cluster.sync();
    return warp_sum(lane < cs ? *cluster.map_shared_rank(&part[slot], lane)
                              : 0.f);
  };
  const float inv_n = 1.f / (float)row_len;
  float mean = 0.f;
  if (subtract_mean)
    mean = cluster_sum(words_sum(buf, mis, mis + n, tid, nt,
                                 [](float v) { return v; }), 0) * inv_n;
  const float ss = cluster_sum(words_sum(buf, mis, mis + n, tid, nt,
                                         [=](float v) {
                                           const float d = v - mean;
                                           return d * d;
                                         }), 1);
  const float rstd = rsqrtf(ss * inv_n + eps);
  const int c = (int)(row % channels);
  const float scale = rstd * to_f32(w[c]), bc = to_f32(b[c]);
  words_store(y + row * row_len + off, buf, mis, mis + n, tid, nt,
              [=](float v) { return silu(fmaf(v - mean, scale, bc)); });
  if (rank == 0 && tid == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  cluster.sync();  // no CTA leaves while another may still read its part
}

// Rows beyond a cluster's shared memory: one block per row. Pass 1: the
// sum, giving the mean ('ln' only). Pass 2: the centred sum of squares,
// giving rstd. Pass 3: y. Passes 2 and 3 re-read the row through L2.
template <typename T>
__global__ void norm_silu_stream_kernel(const T* __restrict__ x,
                                        const T* __restrict__ w,
                                        const T* __restrict__ b,
                                        T* __restrict__ y,
                                        float* __restrict__ mean_out,
                                        float* __restrict__ rstd_out,
                                        int channels, int64_t row_len,
                                        int subtract_mean, float eps) {
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
  const float scale = rstd * to_f32(w[c]), bc = to_f32(b[c]);
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x)
    yr[i] = from_f32<T>(silu(fmaf(to_f32(xr[i]) - mean, scale, bc)));
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// ---- K3 ---------------------------------------------------------------------
//
// The forward's mean and rstd are read back. With n = (x - mean) * rstd,
// u = n * w + b, gu = g * SiLU'(u) and dn = gu * w:
// dx = rstd * (dn - mean(dn) - n * mean(dn * n)) ('rms' drops mean(dn)).
// w is one value per row, so mean(dn) = w * sum(gu) / S and
// mean(dn * n) = w * sum(gu * n) / S: pass 1 takes the two sums, which are
// also the row's partials of db and dw (their sum over the batch is taken
// outside: one writer per output, no atomics); pass 2 writes dx. Both
// passes run over the segments of x and g held in shared memory.

// Rows of up to kWarpRowMax elements, on K2's rows layout: the block's
// rows are one contiguous segment of x and one of g, both held at x's
// misalignment, then pass 1's gu as f32 at the same positions, then the
// rows' (mean, rstd, w, b). Pass 2 reads gu back (no SFU work again).
template <typename T>
__global__ void norm_silu_bwd_rows_kernel(const T* __restrict__ g,
                                          const T* __restrict__ x,
                                          const float* __restrict__ mean_in,
                                          const float* __restrict__ rstd_in,
                                          const T* __restrict__ w,
                                          const T* __restrict__ b,
                                          T* __restrict__ dx,
                                          float* __restrict__ dw_part,
                                          float* __restrict__ db_part,
                                          int channels, int64_t rows,
                                          int row_len, int rows_per_block,
                                          int seg_words, int lanes,
                                          int subtract_mean) {
  constexpr int V = kVec<T>;
  extern __shared__ uint4 seg_u4[];
  T* xb = reinterpret_cast<T*>(seg_u4);
  T* gb = reinterpret_cast<T*>(seg_u4 + seg_words);
  float* gub = reinterpret_cast<float*>(seg_u4 + 2 * seg_words);
  float4* stats = reinterpret_cast<float4*>(gub + seg_words * V);
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - r0);
  const int n = nrows * row_len;
  const T* xs = x + r0 * row_len;
  const int mis = misalign(xs);
  const int words = (mis + n + V - 1) / V;
  copy_words(xb, xs, n, mis, threadIdx.x, words, blockDim.x);
  copy_words(gb, g + r0 * row_len, n, mis, threadIdx.x, words, blockDim.x);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int c = (int)((r0 + r) % channels);
    stats[r] = make_float4(mean_in[r0 + r], rstd_in[r0 + r], to_f32(w[c]),
                           to_f32(b[c]));
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / lanes, sub = lane % lanes, per_warp = 32 / lanes;
  const float inv_n = 1.f / (float)row_len;
  // uniform across the warp, as in K2's rows kernel; a lane group writes
  // and reads back only its own row's gu
  for (int rw = warp * per_warp; rw < nrows;
       rw += (blockDim.x / 32) * per_warp) {
    const int r = rw + group;
    const int lo = mis + min(r, nrows) * row_len;
    const int hi = r < nrows ? lo + row_len : lo;
    const float4 p = stats[min(r, nrows - 1)];
    const float2 s = grad_sums(xb, gb, gub, lo, hi, sub, lanes, p);
    const float s_gu = group_sum(s.x, lanes);
    const float s_gun = group_sum(s.y, lanes);
    if (r >= nrows) continue;
    const float m_dn = subtract_mean ? p.z * s_gu * inv_n : 0.f;
    grad_store(dx + (r0 + r) * row_len, xb, gb, gub, lo, hi, sub, lanes, p,
               m_dn, p.z * s_gun * inv_n);
    if (sub == 0) {
      dw_part[r0 + r] = s_gun;
      db_part[r0 + r] = s_gu;
    }
  }
}

// Longer rows, on K2's cluster layout: CTA `rank` holds the slice
// [rank * slice, (rank + 1) * slice) of x and of g. The two sums are the
// block's sums of its slice, then the sums of the cluster's partials read
// through distributed shared memory in one fixed order.
template <typename T>
__global__ void __launch_bounds__(kSliceThreads)
    norm_silu_bwd_cluster_kernel(const T* __restrict__ g,
                                 const T* __restrict__ x,
                                 const float* __restrict__ mean_in,
                                 const float* __restrict__ rstd_in,
                                 const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ dx,
                                 float* __restrict__ dw_part,
                                 float* __restrict__ db_part, int channels,
                                 int row_len, int slice, int seg_words,
                                 int subtract_mean) {
  extern __shared__ uint4 seg_u4[];
  __shared__ float2 red[32];
  __shared__ float2 part;
  T* xb = reinterpret_cast<T*>(seg_u4);
  T* gb = reinterpret_cast<T*>(seg_u4 + seg_words);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / cs;
  const int off = rank * slice;
  const int n = max(0, min(slice, row_len - off));
  const T* xs = x + row * row_len + off;
  const T* gs = g + row * row_len + off;
  const int mis = misalign(xs);
  const int tid = threadIdx.x, nt = blockDim.x;
  // each thread copies the words it reads (no barrier before pass 1)
  constexpr int V = kVec<T>;
  const int words = (mis + n + V - 1) / V;
  copy_words(xb, xs, n, mis, tid, words, nt);
  copy_words(gb, gs, n, mis, tid, words, nt);
  const int c = (int)(row % channels);
  const float4 p = make_float4(mean_in[row], rstd_in[row], to_f32(w[c]),
                               to_f32(b[c]));
  cp_async_wait_all();
  float2 s =
      block_sum2(grad_sums(xb, gb, nullptr, mis, mis + n, tid, nt, p), red);
  if (tid == 0) part = s;
  cluster.sync();
  // lane r of every warp reads rank r's partials, as in K2's cluster kernel
  const int lane = tid % 32;
  s = lane < cs ? *cluster.map_shared_rank(&part, lane)
                : make_float2(0.f, 0.f);
  const float s_gu = warp_sum(s.x), s_gun = warp_sum(s.y);
  const float inv_n = 1.f / (float)row_len;
  const float m_dn = subtract_mean ? p.z * s_gu * inv_n : 0.f;
  grad_store(dx + row * row_len + off, xb, gb, nullptr, mis, mis + n, tid,
             nt, p, m_dn, p.z * s_gun * inv_n);
  if (rank == 0 && tid == 0) {
    dw_part[row] = s_gun;
    db_part[row] = s_gu;
  }
  cluster.sync();  // no CTA leaves while another may still read its part
}

// Rows beyond a cluster's shared memory: one block per row, each pass
// reading g and x from device memory (the second through L2).
template <typename T>
__global__ void norm_silu_bwd_stream_kernel(const T* __restrict__ g,
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
  __shared__ float2 red[32];
  const int64_t row = blockIdx.x;
  const T* gr = g + row * row_len;
  const T* xr = x + row * row_len;
  T* dxr = dx + row * row_len;
  const int c = (int)(row % channels);
  const float4 p = make_float4(mean_in[row], rstd_in[row], to_f32(w[c]),
                               to_f32(b[c]));
  float2 s = make_float2(0.f, 0.f);
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    float n;
    const float gu = grad_u(to_f32(xr[i]), to_f32(gr[i]), p, n);
    s.x += gu;
    s.y += gu * n;
  }
  s = block_sum2(s, red);
  const float inv_n = 1.f / (float)row_len;
  const float m_dn = subtract_mean ? p.z * s.x * inv_n : 0.f;
  const float a = p.y * p.z, bn = -p.y * p.z * s.y * inv_n, c0 = -p.y * m_dn;
  for (int64_t i = threadIdx.x; i < row_len; i += blockDim.x) {
    float n;
    const float gu = grad_u(to_f32(xr[i]), to_f32(gr[i]), p, n);
    dxr[i] = from_f32<T>(fmaf(gu, a, fmaf(n, bn, c0)));
  }
  if (threadIdx.x == 0) {
    dw_part[row] = s.y;
    db_part[row] = s.x;
  }
}

// ---- K2·S and K3·S: K2 and K3 split around an all-reduce --------------------
//
// Under a spatial mesh each (b, c) row lies across the ranks of the spatial
// group, a slab of it on each. K2·S is K2 in two halves: (a)
// norm_silu_stats takes each row's Σx over the slab, or its Σ(x − c)²
// about a given centre c (0 for 'rms'), and the caller all-reduces the
// [rows] partials over the ranks between the passes ('ln' runs (a) twice:
// the mean, then the centred squares about the global mean, so every
// rank centres on the same mean); (b) norm_silu_apply writes
// y = SiLU((x − mean) · rstd · w + b) from the global mean and rstd. K3·S
// is K3 in two halves: (a) norm_silu_bwd_partials takes each row's Σgu and
// Σgu·n over the slab (the local partials of db and dw); (b)
// norm_silu_bwd_dx writes dx from their all-reduced sums over the whole
// row of N elements: dx = rstd·(gu·w − w·Σgu/N − n·w·Σgu·n/N) ('rms' drops
// the Σgu term).
//
// Each launch reads a row once, so nothing is staged in shared memory: the
// kernels read the 16-byte words of the row straight from device memory
// (the words_sum / words_store / grad_sums / grad_store paths over the
// row's word-aligned base, a word's elements outside the row masked as at
// a segment's ends) and take K2's and K3's launch shapes (pick_shape):
// lane groups of one warp for rows of up to kWarpRowMax, else a cluster of
// CTAs a row whose partial sums meet in distributed shared memory in one
// fixed order (one CTA a row for rows beyond a cluster). g must share x's
// misalignment (the wrapper copies it to do so when it does not).

// The per-row terms of a split launch.
enum SplitOp { kSum = 0, kSquares = 1, kGrad = 2 };

// This thread's sums over elements [lo, hi) of the word-aligned bases xb
// (and gb) by the words t0, t0 + step, ...: Σx, Σ(x − c)², or (Σgu, Σgu·n)
// with p = (mean, rstd, w, b).
template <typename T, int kOp>
__device__ __forceinline__ float2 split_terms(const T* xb, const T* gb,
                                              int lo, int hi, int t0,
                                              int step, float4 p, float c) {
  if constexpr (kOp == kGrad) {
    return grad_sums(xb, gb, nullptr, lo, hi, t0, step, p);
  } else if constexpr (kOp == kSum) {
    return make_float2(
        words_sum(xb, lo, hi, t0, step, [](float v) { return v; }), 0.f);
  } else {
    return make_float2(words_sum(xb, lo, hi, t0, step,
                                 [=](float v) {
                                   const float d = v - c;
                                   return d * d;
                                 }),
                       0.f);
  }
}

// A row's (mean, rstd, w, b); zeros where the op reads none.
template <typename T>
__device__ __forceinline__ float4 row_params(const float* mean,
                                             const float* rstd, const T* w,
                                             const T* b, int64_t row,
                                             int channels) {
  if (rstd == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int c = (int)(row % channels);
  return make_float4(mean ? mean[row] : 0.f, rstd[row], to_f32(w[c]),
                     to_f32(b[c]));
}

template <typename T>
__device__ __forceinline__ const T* word_base(const T* p) {
  return p == nullptr ? nullptr : p - misalign(p);
}

// (a) halves, rows of up to kWarpRowMax: K2's rows layout (a lane group a
// row, several rows a block); out0 = Σx, Σ(x − c)² or Σgu, out1 = Σgu·n.
template <typename T, int kOp>
__global__ void norm_split_sums_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ w, const T* __restrict__ b,
    float* __restrict__ out0, float* __restrict__ out1, int channels,
    int64_t rows, int row_len, int rows_per_block, int lanes) {
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - r0);
  const T* xs = x + r0 * row_len;
  const int mis = misalign(xs);
  const T* xb = xs - mis;
  const T* gb = g ? g + r0 * row_len - mis : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / lanes, sub = lane % lanes, per_warp = 32 / lanes;
  for (int rw = warp * per_warp; rw < nrows;
       rw += (blockDim.x / 32) * per_warp) {
    const int r = rw + group;
    const int lo = mis + min(r, nrows) * row_len;
    const int hi = r < nrows ? lo + row_len : lo;
    const int64_t row = r0 + min(r, nrows - 1);
    const float4 p = row_params(kOp == kGrad ? mean : nullptr,
                                kOp == kGrad ? rstd : nullptr, w, b, row,
                                channels);
    const float c = (kOp == kSquares && mean) ? mean[row] : 0.f;
    float2 s = split_terms<T, kOp>(xb, gb, lo, hi, sub, lanes, p, c);
    s.x = group_sum(s.x, lanes);
    if (kOp == kGrad) s.y = group_sum(s.y, lanes);
    if (r >= nrows) continue;
    if (sub == 0) {
      out0[r0 + r] = s.x;
      if (kOp == kGrad) out1[r0 + r] = s.y;
    }
  }
}

// (a) halves, longer rows: K2's cluster layout, CTA `rank` of a row taking
// the slice [rank * slice, (rank + 1) * slice); block sums, then the
// cluster's partials read through distributed shared memory in one fixed
// order (a plain launch of one CTA a row, and one CTA a row of any length
// for rows beyond a cluster).
template <typename T, int kOp>
__global__ void __launch_bounds__(1024) norm_split_sums_slices_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ w, const T* __restrict__ b,
    float* __restrict__ out0, float* __restrict__ out1, int channels,
    int row_len, int slice) {
  __shared__ float2 red[32];
  __shared__ float2 part;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / cs;
  const int off = rank * slice;
  const int n = max(0, min(slice, row_len - off));
  const T* xs = x + row * row_len + off;
  const int mis = misalign(xs);
  const float4 p = row_params(kOp == kGrad ? mean : nullptr,
                              kOp == kGrad ? rstd : nullptr, w, b, row,
                              channels);
  const float c = (kOp == kSquares && mean) ? mean[row] : 0.f;
  float2 s = block_sum2(
      split_terms<T, kOp>(xs - mis,
                          g ? word_base(g + row * row_len + off) : nullptr,
                          mis, mis + n, threadIdx.x, blockDim.x, p, c),
      red);
  if (cs > 1) {
    if (threadIdx.x == 0) part = s;
    cluster.sync();
    const int lane = threadIdx.x % 32;
    s = lane < cs ? *cluster.map_shared_rank(&part, lane)
                  : make_float2(0.f, 0.f);
    s = make_float2(warp_sum(s.x), warp_sum(s.y));
  }
  if (rank == 0 && threadIdx.x == 0) {
    out0[row] = s.x;
    if (kOp == kGrad) out1[row] = s.y;
  }
  if (cs > 1) cluster.sync();  // no CTA leaves while another reads its part
}

// The (b) halves' per-row store over [lo, hi) of the word-aligned bases:
// y (kOp kSum) or dx (kGrad) from the row's global statistics (and sums).
template <typename T, int kOp>
__device__ __forceinline__ void split_store(T* dst, const T* xb,
                                            const T* gb, int lo, int hi,
                                            int t0, int step, float4 p,
                                            float s_gu, float s_gun,
                                            float inv_n, int subtract_mean) {
  if constexpr (kOp == kGrad) {
    grad_store(dst, xb, gb, nullptr, lo, hi, t0, step, p,
               subtract_mean ? p.z * s_gu * inv_n : 0.f,
               p.z * s_gun * inv_n);
  } else {
    const float scale = p.y * p.z, mu = p.x, bc = p.w;
    words_store(dst, xb, lo, hi, t0, step,
                [=](float v) { return silu(fmaf(v - mu, scale, bc)); });
  }
}

// (b) halves, rows of up to kWarpRowMax, on K2's rows layout.
template <typename T, int kOp>
__global__ void norm_split_store_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ w, const T* __restrict__ b,
    const float* __restrict__ s_gu, const float* __restrict__ s_gun,
    T* __restrict__ out, int channels, int64_t rows, int row_len,
    int rows_per_block, int lanes, float inv_n, int subtract_mean) {
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - r0);
  const T* xs = x + r0 * row_len;
  const int mis = misalign(xs);
  const T* gb = g ? g + r0 * row_len - mis : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / lanes, sub = lane % lanes, per_warp = 32 / lanes;
  for (int r = warp * per_warp + group; r < nrows;
       r += (blockDim.x / 32) * per_warp) {
    const int64_t row = r0 + r;
    const int lo = mis + r * row_len;
    split_store<T, kOp>(out + row * row_len, xs - mis, gb, lo, lo + row_len,
                        sub, lanes,
                        row_params(mean, rstd, w, b, row, channels),
                        kOp == kGrad ? s_gu[row] : 0.f,
                        kOp == kGrad ? s_gun[row] : 0.f, inv_n,
                        subtract_mean);
  }
}

// (b) halves, longer rows: cs blocks a row, block `rank` storing the slice
// [rank * slice, (rank + 1) * slice) (a plain launch: nothing is summed).
template <typename T, int kOp>
__global__ void __launch_bounds__(1024) norm_split_store_slices_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ w, const T* __restrict__ b,
    const float* __restrict__ s_gu, const float* __restrict__ s_gun,
    T* __restrict__ out, int channels, int row_len, int slice, int cs,
    float inv_n, int subtract_mean) {
  const int64_t row = blockIdx.x / cs;
  const int off = (int)(blockIdx.x % cs) * slice;
  const int n = max(0, min(slice, row_len - off));
  const T* xs = x + row * row_len + off;
  const int mis = misalign(xs);
  split_store<T, kOp>(out + row * row_len + off, xs - mis,
                      g ? word_base(g + row * row_len + off) : nullptr, mis,
                      mis + n, threadIdx.x, blockDim.x,
                      row_params(mean, rstd, w, b, row, channels),
                      kOp == kGrad ? s_gu[row] : 0.f,
                      kOp == kGrad ? s_gun[row] : 0.f, inv_n, subtract_mean);
}

// ---- launch -----------------------------------------------------------------

// 16-byte words that hold a segment of n elements at any misalignment:
// those from its first to its last element.
template <typename T>
int segment_words(int n) {
  return (n + 2 * kVec<T> - 2) / kVec<T>;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

enum Kernel { kRows, kCluster, kStream };

struct Shape {
  Kernel kernel;
  int64_t blocks;  // blocks, or CTAs of all clusters
  int threads;
  int seg_words;   // 16-byte words of shared memory an array's segment takes
  int lanes, rows_per_block;  // rows kernels
  int cs, slice;              // cluster kernels
};

// The launch shape of K2 (arrays = 1: x) or K3 (arrays = 2: g and x), from
// the row length and count; one rule for both. Rows kernels: a group of
// lanes per row (a power of two: a word a lane up to 16 lanes, then
// kWordsPerLane words a lane), up to 8 warps a block (fewer when rows are
// few, so that blocks spread over the SMs), and rows_per_block a multiple
// of the rows the warps take at once: about kRowsBlockBytes of each array
// or two waves of blocks, whichever is smaller. Cluster kernels: the fewest CTAs
// per row (a power of two up to kMaxCluster) whose slices fit kSliceBytes
// over the arrays, and, for rows longer than kBlockRowMax, give at least
// kFillWaves waves of CTAs. Stream kernels: `stream_threads` a block.
template <typename T>
Shape pick_shape(int64_t rows, int64_t row_len, int arrays,
                 int stream_threads) {
  constexpr int V = kVec<T>, size = (int)sizeof(T);
  const int64_t sms = sm_count();
  Shape s = {};
  if (row_len <= kWarpRowMax) {
    const int len = (int)row_len;
    int lanes = 1;
    while (lanes < 16 && lanes * V < len) lanes *= 2;
    while (lanes < 32 && lanes * kWordsPerLane * V < len) lanes *= 2;
    const int per_warp = 32 / lanes;
    const int64_t groups = (rows + per_warp - 1) / per_warp;
    const int warps = (int)std::min<int64_t>(
        std::max<int64_t>(groups / (2 * sms), 1), 8);
    const int per_group = (int)std::max<int64_t>(
        std::min<int64_t>(
            kRowsBlockBytes / (warps * per_warp * len * size),
            groups / (warps * 2 * sms)), 1);
    s.kernel = kRows;
    s.lanes = lanes;
    s.rows_per_block = warps * per_warp * per_group;
    s.blocks = (rows + s.rows_per_block - 1) / s.rows_per_block;
    s.threads = 32 * warps;
    s.seg_words = segment_words<T>(s.rows_per_block * len);
    return s;
  }
  const int64_t need =
      (arrays * row_len * size + kSliceBytes - 1) / kSliceBytes;
  if (need > kMaxCluster) {
    s.kernel = kStream;
    s.blocks = rows;
    s.threads = stream_threads;
    return s;
  }
  const int64_t fill =
      row_len <= kBlockRowMax ? 1 : (kFillWaves * sms + rows - 1) / rows;
  int cs = 1;
  while (cs < kMaxCluster && (cs < need || cs < fill)) cs *= 2;
  const int len = (int)row_len;
  s.kernel = kCluster;
  s.cs = cs;
  s.slice = ((len + cs - 1) / cs + V - 1) / V * V;
  s.blocks = rows * cs;
  s.threads = std::min(kSliceThreads, (s.slice / V + 1 + 31) / 32 * 32);
  s.seg_words = segment_words<T>(s.slice);
  return s;
}

// Dynamic shared memory above the default 48 KB must be asked for.
template <typename Kern>
cudaError_t allow_smem(Kern* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// A cluster kernel's launch: clusters of s.cs CTAs along x (a plain
// launch for one CTA a row, whose cluster is the CTA itself: faster).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const Shape& s,
                           int smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)s.blocks);
  config.blockDim = dim3(s.threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = s.cs > 1 ? 1 : 0;  // one CTA a row: a plain launch
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, int64_t rows, int channels,
                   int64_t row_len, int subtract_mean, float eps, int threads,
                   cudaStream_t stream) {
  const T* x_ = static_cast<const T*>(x);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(b);
  T* y_ = static_cast<T*>(y);
  float* mean_ = static_cast<float*>(mean);
  float* rstd_ = static_cast<float*>(rstd);
  const Shape s = pick_shape<T>(rows, row_len, 1, threads);
  const int smem = s.seg_words * 16;
  if (s.kernel == kRows) {
    const cudaError_t err = allow_smem(norm_silu_rows_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    norm_silu_rows_kernel<T><<<(unsigned)s.blocks, s.threads, smem, stream>>>(
        x_, w_, b_, y_, mean_, rstd_, channels, rows, (int)row_len,
        s.rows_per_block, s.lanes, subtract_mean, eps);
    return cudaGetLastError();
  }
  if (s.kernel == kStream) {
    norm_silu_stream_kernel<T><<<(unsigned)s.blocks, s.threads, 0, stream>>>(
        x_, w_, b_, y_, mean_, rstd_, channels, row_len, subtract_mean, eps);
    return cudaGetLastError();
  }
  return launch_cluster(norm_silu_cluster_kernel<T>, s, smem, stream, x_, w_,
                        b_, y_, mean_, rstd_, channels, (int)row_len, s.slice,
                        subtract_mean, eps);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* mean,
                       const void* rstd, const void* w, const void* b,
                       void* dx, void* dw_part, void* db_part, int64_t rows,
                       int channels, int64_t row_len, int subtract_mean,
                       int threads, cudaStream_t stream) {
  const T* g_ = static_cast<const T*>(g);
  const T* x_ = static_cast<const T*>(x);
  const float* mean_ = static_cast<const float*>(mean);
  const float* rstd_ = static_cast<const float*>(rstd);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(b);
  T* dx_ = static_cast<T*>(dx);
  float* dw_ = static_cast<float*>(dw_part);
  float* db_ = static_cast<float*>(db_part);
  const Shape s = pick_shape<T>(rows, row_len, 2, threads);
  if (s.kernel == kRows) {
    // the two segments, gu as f32, then a float4 of statistics per row
    const int smem = (2 * s.seg_words + s.seg_words * kVec<T> / 4 +
                      s.rows_per_block) * 16;
    const cudaError_t err = allow_smem(norm_silu_bwd_rows_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    norm_silu_bwd_rows_kernel<T>
        <<<(unsigned)s.blocks, s.threads, smem, stream>>>(
            g_, x_, mean_, rstd_, w_, b_, dx_, dw_, db_, channels, rows,
            (int)row_len, s.rows_per_block, s.seg_words, s.lanes,
            subtract_mean);
    return cudaGetLastError();
  }
  if (s.kernel == kStream) {
    norm_silu_bwd_stream_kernel<T>
        <<<(unsigned)s.blocks, s.threads, 0, stream>>>(
            g_, x_, mean_, rstd_, w_, b_, dx_, dw_, db_, channels, row_len,
            subtract_mean);
    return cudaGetLastError();
  }
  return launch_cluster(norm_silu_bwd_cluster_kernel<T>, s,
                        2 * s.seg_words * 16, stream, g_, x_, mean_, rstd_,
                        w_, b_, dx_, dw_, db_, channels, (int)row_len, s.slice,
                        s.seg_words, subtract_mean);
}

// Whether g (when given) sits at x's offset within a 16-byte word: the
// split K3's word paths read g's words beside x's. (A host function:
// misalign() is device code.)
template <typename T>
bool same_word_offset(const T* g, const T* x) {
  return g == nullptr || ((reinterpret_cast<uintptr_t>(g) ^
                           reinterpret_cast<uintptr_t>(x)) & 15) == 0;
}

// A split launch's shape: K2's (arrays = 1) or K3's (arrays = 2) rule; rows
// beyond a cluster take one block a row of `threads` (a slice of the whole
// row).
template <typename T>
Shape split_shape(int64_t rows, int64_t row_len, int arrays, int threads) {
  Shape s = pick_shape<T>(rows, row_len, arrays, threads);
  if (s.kernel == kStream) {
    s.cs = 1;
    s.slice = (int)row_len;
  }
  return s;
}

// The (a) halves: out0 (and out1) f32 [rows].
template <typename T, int kOp>
cudaError_t launch_split_sums(const void* x, const void* g, const void* mean,
                              const void* rstd, const void* w, const void* b,
                              void* out0, void* out1, int64_t rows,
                              int channels, int64_t row_len, int threads,
                              cudaStream_t stream) {
  const T* x_ = static_cast<const T*>(x);
  const T* g_ = static_cast<const T*>(g);
  const float* mean_ = static_cast<const float*>(mean);
  const float* rstd_ = static_cast<const float*>(rstd);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(b);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  if (!same_word_offset(g_, x_)) return cudaErrorInvalidValue;
  const Shape s = split_shape<T>(rows, row_len, kOp == kGrad ? 2 : 1,
                                 threads);
  if (s.kernel == kRows) {
    norm_split_sums_rows_kernel<T, kOp>
        <<<(unsigned)s.blocks, s.threads, 0, stream>>>(
            x_, g_, mean_, rstd_, w_, b_, o0, o1, channels, rows,
            (int)row_len, s.rows_per_block, s.lanes);
    return cudaGetLastError();
  }
  return launch_cluster(norm_split_sums_slices_kernel<T, kOp>, s, 0, stream,
                        x_, g_, mean_, rstd_, w_, b_, o0, o1, channels,
                        (int)row_len, s.slice);
}

// The (b) halves: y (kSum) or dx (kGrad) into out.
template <typename T, int kOp>
cudaError_t launch_split_store(const void* x, const void* g,
                               const void* mean, const void* rstd,
                               const void* w, const void* b,
                               const void* s_gu, const void* s_gun, void* out,
                               int64_t rows, int channels, int64_t row_len,
                               float inv_n, int subtract_mean, int threads,
                               cudaStream_t stream) {
  const T* x_ = static_cast<const T*>(x);
  const T* g_ = static_cast<const T*>(g);
  const float* mean_ = static_cast<const float*>(mean);
  const float* rstd_ = static_cast<const float*>(rstd);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(b);
  const float* sg = static_cast<const float*>(s_gu);
  const float* sgn = static_cast<const float*>(s_gun);
  T* out_ = static_cast<T*>(out);
  if (!same_word_offset(g_, x_)) return cudaErrorInvalidValue;
  const Shape s = split_shape<T>(rows, row_len, kOp == kGrad ? 2 : 1,
                                 threads);
  if (s.kernel == kRows) {
    norm_split_store_rows_kernel<T, kOp>
        <<<(unsigned)s.blocks, s.threads, 0, stream>>>(
            x_, g_, mean_, rstd_, w_, b_, sg, sgn, out_, channels, rows,
            (int)row_len, s.rows_per_block, s.lanes, inv_n, subtract_mean);
    return cudaGetLastError();
  }
  norm_split_store_slices_kernel<T, kOp>
      <<<(unsigned)s.blocks, s.threads, 0, stream>>>(
          x_, g_, mean_, rstd_, w_, b_, sg, sgn, out_, channels,
          (int)row_len, s.slice, s.cs, inv_n, subtract_mean);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w, b and y share it).
// threads: a multiple of 32 in [32, 1024], the block size for rows longer
// than a cluster holds. Returns a cudaError_t.
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

// The split launches' common checks: a block size for rows beyond a
// cluster (a multiple of 32 in [32, 1024]) and rows an int indexes.
static bool split_args_ok(int threads, long long row_len) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0 &&
         row_len > 0 && row_len < (1LL << 31);
}

// K2·S (a): out[r] = Σ x over row r ('square' 0), or Σ (x − center[r])²
// ('square' 1; center f32 [rows] or null for 0). Returns a cudaError_t.
extern "C" int norm_silu_stats_launch(const void* x, const void* center,
                                      void* out, long long rows,
                                      long long row_len, int square,
                                      int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_args_ok(threads, row_len)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return square ? launch_split_sums<float, kSquares>(
                        x, nullptr, center, nullptr, nullptr, nullptr, out,
                        nullptr, rows, 1, row_len, threads, s)
                  : launch_split_sums<float, kSum>(
                        x, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                        nullptr, rows, 1, row_len, threads, s);
  if (dtype == 1)
    return square ? launch_split_sums<__nv_bfloat16, kSquares>(
                        x, nullptr, center, nullptr, nullptr, nullptr, out,
                        nullptr, rows, 1, row_len, threads, s)
                  : launch_split_sums<__nv_bfloat16, kSum>(
                        x, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                        nullptr, rows, 1, row_len, threads, s);
  return (int)cudaErrorInvalidValue;
}

// K2·S (b): y = SiLU((x − mean[r]) · rstd[r] · w[c] + b[c]); mean and rstd
// f32 [rows]. Returns a cudaError_t.
extern "C" int norm_silu_apply_launch(const void* x, const void* mean,
                                      const void* rstd, const void* w,
                                      const void* b, void* y, long long rows,
                                      int channels, long long row_len,
                                      int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_args_ok(threads, row_len)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_split_store<float, kSum>(x, nullptr, mean, rstd, w, b,
                                           nullptr, nullptr, y, rows,
                                           channels, row_len, 0.f, 0,
                                           threads, s);
  if (dtype == 1)
    return launch_split_store<__nv_bfloat16, kSum>(
        x, nullptr, mean, rstd, w, b, nullptr, nullptr, y, rows, channels,
        row_len, 0.f, 0, threads, s);
  return (int)cudaErrorInvalidValue;
}

// K3·S (a): s_gu[r] = Σ gu and s_gun[r] = Σ gu·n over row r (f32 [rows]);
// g shares x's misalignment. Returns a cudaError_t.
extern "C" int norm_silu_bwd_partials_launch(
    const void* g, const void* x, const void* mean, const void* rstd,
    const void* w, const void* b, void* s_gu, void* s_gun, long long rows,
    int channels, long long row_len, int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_args_ok(threads, row_len)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_split_sums<float, kGrad>(x, g, mean, rstd, w, b, s_gu,
                                           s_gun, rows, channels, row_len,
                                           threads, s);
  if (dtype == 1)
    return launch_split_sums<__nv_bfloat16, kGrad>(
        x, g, mean, rstd, w, b, s_gu, s_gun, rows, channels, row_len,
        threads, s);
  return (int)cudaErrorInvalidValue;
}

// K3·S (b): dx from the sums of gu and gu·n over the whole row (f32
// [rows], all-reduced), inv_n = 1 / the whole row's length; g shares x's
// misalignment. Returns a cudaError_t.
extern "C" int norm_silu_bwd_dx_launch(
    const void* g, const void* x, const void* mean, const void* rstd,
    const void* w, const void* b, const void* s_gu, const void* s_gun,
    void* dx, long long rows, int channels, long long row_len, float inv_n,
    int subtract_mean, int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_args_ok(threads, row_len)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_split_store<float, kGrad>(x, g, mean, rstd, w, b, s_gu,
                                            s_gun, dx, rows, channels,
                                            row_len, inv_n, subtract_mean,
                                            threads, s);
  if (dtype == 1)
    return launch_split_store<__nv_bfloat16, kGrad>(
        x, g, mean, rstd, w, b, s_gu, s_gun, dx, rows, channels, row_len,
        inv_n, subtract_mean, threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
