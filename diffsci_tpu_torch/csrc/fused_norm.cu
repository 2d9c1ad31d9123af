// K2: y = SiLU(norm(x) * w + b), per (batch, channel) over the spatial
// extent, on the NC* layout where each (b, c) is one contiguous row; and
// K3, its backward.
//
// Replaces diffsci_tpu/kernels/fused_norm.py:_fwd_kernel (K2) and
// _bwd_kernel (K3). See diffsci_tpu_torch/kernels/fused_norm.py for the
// design note.
//
// K2 is bound by bytes: one read of x and one write of y per element. It
// holds what it reads in shared memory, so x is read from device memory
// once, and takes the two-pass variance of the TPU kernel (the mean, then
// the centred sum of squares) over the values held there. The launch
// picks one of three shapes from the row length S and the row count:
// - S <= kWarpRowMax (norm_silu_rows_kernel): a group of lanes of one warp
//   per row (about a 16-byte word each), several rows a block,
//   warp-shuffle sums only;
// - longer rows (norm_silu_cluster_kernel): each row split over a thread
//   block cluster of up to kMaxCluster CTAs, sized so that rows x CTAs
//   fills several waves of the SMs; the CTAs exchange their partial sums
//   through distributed shared memory;
// - rows longer than a cluster's shared memory holds (kMaxCluster x
//   kSliceBytes, 1 MB; no main path has one): norm_silu_stream_kernel, one
//   block per row streaming it three times, the re-reads served by L2.
// A block's segment of x is copied in with 16-byte cp.async copies where
// its words line up, element by element at its unaligned ends; y is
// computed from the values held there and stored likewise. Every sum runs
// in a fixed order (no float atomics), so one input gives one result.
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

// u·sigmoid(u) on the SFU: __expf is ex2.approx, __fdividef one rcp.approx
// and a multiply (0 when the denominator overflows, as u/inf is)
__device__ __forceinline__ float silu(float u) {
  return __fdividef(u, 1.f + __expf(-u));
}

// ---- K2's segments in shared memory ---------------------------------------

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

// ---- K2 ---------------------------------------------------------------------

// The launch's choices are macros with the committed values as defaults,
// so a variant builds with an nvcc -D flag (scripts/torch_norm_variants.py).
#ifndef NORM_WARP_ROW_MAX
#define NORM_WARP_ROW_MAX 1024
#endif
#ifndef NORM_ROWS_BLOCK_BYTES
#define NORM_ROWS_BLOCK_BYTES 8192
#endif
#ifndef NORM_WORDS_PER_LANE
#define NORM_WORDS_PER_LANE 1
#endif
#ifndef NORM_FILL_WAVES
#define NORM_FILL_WAVES 2
#endif
#ifndef NORM_SLICE_THREADS
#define NORM_SLICE_THREADS 256
#endif
constexpr int kWarpRowMax = NORM_WARP_ROW_MAX;  // longest row of a warp
constexpr int kRowsBlockBytes = NORM_ROWS_BLOCK_BYTES;  // x of a rows block
constexpr int kWordsPerLane = NORM_WORDS_PER_LANE;  // of a row, at least
constexpr int kFillWaves = NORM_FILL_WAVES;  // cluster CTAs, in waves of SMs
constexpr int kSliceThreads = NORM_SLICE_THREADS;
constexpr int kSliceBytes = 128 * 1024;  // most x bytes a cluster CTA holds
constexpr int kMaxCluster = 8;           // the portable cluster size

// The sum over the `lanes` lanes (a power of two) of this lane's group.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of up to kWarpRowMax elements: the block's rows_per_block rows are
// one contiguous segment of x, held in shared memory. A row takes a group
// of `lanes` lanes of one warp (a power of two; about one 16-byte word of
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

// Shared bytes that hold a segment of n elements at any misalignment: the
// 16-byte words from its first to its last element.
template <typename T>
int segment_bytes(int n) {
  return (n + 2 * kVec<T> - 2) / kVec<T> * 16;
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

// K2's launch: the kernel and its shape from the row length and count.
// Rows kernel: a group of lanes per row (a power of two, at least
// kWordsPerLane words a lane), up to 8 warps a block (fewer when rows are
// few, so that blocks spread over the SMs), and rows_per_block a multiple
// of the rows the warps take at once: about kRowsBlockBytes of x or two
// waves of blocks, whichever is smaller. Cluster kernel: the fewest CTAs
// per row (a power of two up to kMaxCluster) whose slices fit kSliceBytes
// and give at least kFillWaves waves of CTAs. `threads` sizes the stream
// kernel's blocks.
template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, int64_t rows, int channels,
                   int64_t row_len, int subtract_mean, float eps, int threads,
                   cudaStream_t stream) {
  constexpr int V = kVec<T>, size = (int)sizeof(T);
  const T* x_ = static_cast<const T*>(x);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(b);
  T* y_ = static_cast<T*>(y);
  float* mean_ = static_cast<float*>(mean);
  float* rstd_ = static_cast<float*>(rstd);
  const int64_t sms = sm_count();
  if (row_len <= kWarpRowMax) {
    const int len = (int)row_len;
    int lanes = 1;
    while (lanes < 32 && lanes * kWordsPerLane * V < len) lanes *= 2;
    const int per_warp = 32 / lanes;
    const int64_t groups = (rows + per_warp - 1) / per_warp;
    const int warps = (int)std::min<int64_t>(
        std::max<int64_t>(groups / (2 * sms), 1), 8);
    const int per_group = (int)std::max<int64_t>(
        std::min<int64_t>(kRowsBlockBytes / (warps * per_warp * len * size),
                          groups / (warps * 2 * sms)), 1);
    const int rows_per_block = warps * per_warp * per_group;
    const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
    const int smem = segment_bytes<T>(rows_per_block * len);
    norm_silu_rows_kernel<T><<<(unsigned)blocks, 32 * warps, smem, stream>>>(
        x_, w_, b_, y_, mean_, rstd_, channels, rows, len, rows_per_block,
        lanes, subtract_mean, eps);
    return cudaGetLastError();
  }
  const int64_t need = (row_len * size + kSliceBytes - 1) / kSliceBytes;
  if (need > kMaxCluster) {
    norm_silu_stream_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
        x_, w_, b_, y_, mean_, rstd_, channels, row_len, subtract_mean, eps);
    return cudaGetLastError();
  }
  const int64_t fill = (kFillWaves * sms + rows - 1) / rows;
  int cs = 1;
  while (cs < kMaxCluster && (cs < need || cs < fill)) cs *= 2;
  const int len = (int)row_len;
  const int slice = ((len + cs - 1) / cs + V - 1) / V * V;
  const int smem = segment_bytes<T>(slice);
  const int nt = std::min(kSliceThreads, (slice / V + 1 + 31) / 32 * 32);
  auto* kernel = norm_silu_cluster_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(rows * cs));
  config.blockDim = dim3(nt);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, x_, w_, b_, y_, mean_, rstd_,
                            channels, len, slice, subtract_mean, eps);
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

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
