// Tiled one-hot warps, forward and backward, for sm_90a.
//
// warp_tile_image_fwd and warp_tile_features_fwd replace the Pallas TPU
// kernel `_mxu_fwd_kernel` (real_time_self_adaptive_deep_stereo_tpu/ops/
// warp_pallas.py), launched through `_mxu_call` by `warp_image_mxu`
// (kind 'image') and `warp_features_mxu` (kind 'feat'); warp_tile_image_bwd
// and warp_tile_features_bwd replace `_mxu_bwd_kernel`, the backward of the
// same functions.
//
// What they compute. Both samplings of csrc/warp.cu as the TPU kernel has
// them: per tile of 128 output columns,
//
//   out[c, x] = sum_v win[c, v] * M[x, v],
//   M[x, v]   = w0[x] * [v == rel0[x]] + w1[x] * [v == rel1[x]],
//
// over a window of source columns around the tile. The row is taken as
// padded with zero columns to a multiple of 128 (`wp`), and the sample
// columns are clamped to [0, wp - 1], the padded width, as `_mxu_call`
// has it: a feature tap just right of the row gets a non-zero weight on a
// zero column where warp.cu gives it a zero weight (the same value), and
// an image tap at a disparity of exactly 0 in the last column reads a
// zero where warp.cu reads the edge (the same value, since its weight is
// 0, but `ddisp` there is g*v0 and not 0). The output is fp32.
//
// What carries over from the TPU kernel, and what does not. M has two
// non-zeros a row; on the TPU the product with it runs on the matrix
// unit because a lane gather is slow there, and at fp32 `HIGHEST` it is
// exactly w0*win[rel0] + w1*win[rel1]. On this card a product of zeros
// is no design: a thread gathers its two taps through L1 (`tile_tap`
// computes them, clamped to the padded row; a tap on a column in
// [W, wp) reads a zero).
//
// The forwards are gathers, in the forms of csrc/warp.cu's forwards:
//
// * the image warp (`tile_image_fwd_kernel`, [3, 320, 1216] on the main
//   path): one thread per output pixel (b, h, x), consecutive threads on
//   consecutive x, the taps computed once for all channels. Its taps equal
//   `image_tap`'s wherever their weight is not 0, so it equals
//   warp_image_fwd bit for bit;
// * the feature warp (`tile_feat_fwd_kernel`, MADNet's short, deep rows
//   [C, W] = [128, 38] to [32, 304]): one thread per (pixel of the H*W
//   plane, group of kGatherChannels channels), consecutive threads on
//   consecutive pixels across row ends, so that the offset load and the
//   stores stay coalesced on rows of 38 floats; a thread issues its group's
//   2 * kGatherChannels gathers before its first store.
//
// Why gathers. Earlier forms staged the source in shared memory, the image
// warp a window per 128-column tile, the feature warp a whole row per
// chunk of channels with `cp.async`, and the offset gradient a window per
// tile and chunk of 16 channels. Measured on the H100 (PERF.md, §6),
// staging lost to `grid_sample` and to the gathers: each block waits for
// its stage, a barrier, its taps and another barrier before its first
// store, and at MADNet's shapes those phases lie on the critical path,
// 0.6-1.3 us a call more than a gather. No MADNet row is long enough for
// the reuse of a staged column to pay that back, and a gather has no
// row-length or window limit.
//
// What bounds them: by count, memory: (2C + 1) * 4 bytes per pixel
// forward, a handful of operations per element; in practice at scales 5
// and 4 (380 and 1,520 pixels) the launch, about 2.2 us a call in a CUDA
// graph, and the latency of a chain of dependent loads. The backward
// reads the incoming gradient too and writes the gradients asked for.
//
// The backward is two kernels behind one entry point, each skipped when
// its gradient is not asked for:
//
// * the offset gradient (`tile_bwd_offset_kernel`), a gather: a thread
//   owns (pixel of the H*W plane, slice of channels), consecutive threads
//   on consecutive pixels across row ends, so that the loads of g and of
//   the offset and the store stay coalesced on rows of 38 floats. It
//   computes its taps once and sums g * (v0 - v1) (image) or
//   g * (in1*v1 - in0*v0) (features) over its slice's channels in order,
//   gathering v0 and v1 through the read-only cache. The host cuts the
//   channels into as many slices (threadIdx.y, at most 32) as it takes
//   to put some 1,024 threads on each SM: the image warp (3 channels,
//   389,120 pixels) keeps one slice, as csrc/warp.cu's offset gradient
//   has it, and MADNet's scale-5 features [128, 10, 38] take 32 slices of
//   4 channels, where one thread a pixel would leave 380 threads to walk
//   128 channels each. The slices' partial sums meet in static shared
//   memory and the first slice's thread adds them in slice order, so the
//   order of the sum is fixed and two runs agree bit for bit. The result
//   is zeroed where the unclipped offset lies outside [lo, hi];
// * the source gradient, dwin = g * M summed over overlapping tile
//   windows: a block owns (batch, row, chunk of channels) and keeps the
//   row's gradient in a shared-memory row buffer. It walks the row's
//   tiles in increasing order; for each it stages the tile's 128 tap
//   records and its slice of g, then the thread of each window column v
//   walks the records of the outputs x that can reach v, in increasing x,
//   and adds w * g where a tap's column equals v: first into registers,
//   then once into the row buffer. Each column has one owner per tile and
//   tiles come in order, so there are no atomics, in shared memory
//   either, and two runs agree bit for bit. The row is written once,
//   cropped to the real width. This is the transpose of a gather; done as
//   a gather from device memory it would need atomics (whose order changes
//   from run to run, and the adaptation's trajectory depends on the order
//   of sums) or csrc/warp.cu's walk, which recomputes every tap a column
//   can be reached from. So it keeps its row buffer.
//
// Dynamic shared memory is used by the source gradient alone.
// `warp_tile_init` raises its limit to the card's 227 KB once, when the
// library is loaded, so that no launch changes a function attribute (a
// launch may be under stream capture); the entry point refuses a row that
// needs more. The offset gradient's 4 KB are static.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kTile = 128;          // output columns per tile
constexpr int kGatherThreads = 128; // threads of a forward block
constexpr int kGatherChannels = 4;  // channels per thread, feature forward
constexpr int kWarp = 32;
constexpr int kOffMaxThreads = 1024;  // threads of an offset-gradient block, at most
constexpr int kOffMaxSlices = kOffMaxThreads / kWarp;  // channel slices a pixel, at most
// threads an offset-gradient launch aims for: 1,024 on each of the H100's
// 132 SMs, where the channels allow
constexpr long long kOffFillThreads = 132LL * 1024;
constexpr int kBwdChunk = 8;        // channels per row buffer
constexpr int kBwdThreads = 256;    // threads of the source-gradient block
constexpr int kMaxSmem = 232448;    // bytes a block can use on sm_90

// w0*a + w1*b with every product and sum rounded on its own, as the TPU
// kernel's fp32 product and the plain PyTorch version compute it.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// The two taps of one output column: weights, sample columns clamped to
// the padded row [0, wp - 1], and whether each unclamped column lies
// inside it (always 1 for the image warp).
struct Tap {
  float w0, w1, in0, in1;
  int i0, i1;
};

// kImage: sample at x - clip(off, lo, hi), clamp to edge; else at
// x + clip(off, lo, hi) with the weight of an outside corner zeroed.
template <bool kImage>
__device__ __forceinline__ Tap tile_tap(float off, int x, int wp, float lo,
                                        float hi) {
  const float d = fminf(fmaxf(off, lo), hi);
  const float xf = static_cast<float>(x);
  const float cx = kImage ? xf - d : xf + d;
  const float x0 = floorf(cx);
  const float x1 = x0 + 1.f;
  const float last = static_cast<float>(wp - 1);
  Tap t;
  t.w1 = cx - x0;
  t.w0 = 1.f - t.w1;
  if (kImage) {
    t.in0 = 1.f;
    t.in1 = 1.f;
  } else {
    t.in0 = (x0 >= 0.f && x0 <= last) ? 1.f : 0.f;
    t.in1 = (x1 >= 0.f && x1 <= last) ? 1.f : 0.f;
    t.w0 = __fmul_rn(t.w0, t.in0);
    t.w1 = __fmul_rn(t.w1, t.in1);
  }
  t.i0 = static_cast<int>(fminf(fmaxf(x0, 0.f), last));
  t.i1 = static_cast<int>(fminf(fmaxf(x1, 0.f), last));
  return t;
}

// Column `col` of a row of the padded source: the real row [0, W) read
// through the read-only cache, a zero in [W, wp).
__device__ __forceinline__ float padded_load(const float* __restrict__ row,
                                             int col, int W) {
  return col < W ? __ldg(row + col) : 0.f;
}

// Image warp: one thread per output pixel (b, h, x).
__global__ void __launch_bounds__(kGatherThreads)
    tile_image_fwd_kernel(const float* __restrict__ src,
                          const float* __restrict__ off,
                          float* __restrict__ out, int C, int H, int W, int wp,
                          float max_disp) {
  const int x = blockIdx.x * kGatherThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const Tap t = tile_tap<true>(
      __ldg(off + static_cast<size_t>(b) * plane + row + x), x, wp, 0.f,
      max_disp);

  const float* s = src + static_cast<size_t>(b) * C * plane + row;
  float* dst = out + static_cast<size_t>(b) * C * plane + row + x;
  // i0 = floor(x - d) <= x < W, as d >= 0: only the second tap can reach
  // the pad (x = W - 1 at d = 0, with weight 0)
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = s + c * plane;
    dst[c * plane] =
        lerp2(t.w0, __ldg(r + t.i0), t.w1, padded_load(r, t.i1, W));
  }
}

// Feature warp: one thread per (pixel of the plane, group of
// kGatherChannels channels). blockIdx.x = group * pix_blocks + block of
// pixels; blockIdx.y is the batch. A group past C's end keeps its gathers
// and stores masked.
__global__ void __launch_bounds__(kGatherThreads)
    tile_feat_fwd_kernel(const float* __restrict__ src,
                         const float* __restrict__ off, float* __restrict__ out,
                         int C, int W, int wp, size_t plane, int pix_blocks,
                         float lo, float hi) {
  const int g = blockIdx.x / pix_blocks;
  const size_t p =
      static_cast<size_t>(blockIdx.x - g * pix_blocks) * kGatherThreads +
      threadIdx.x;
  if (p >= plane) return;
  const int b = blockIdx.y;
  // the column; a plane under 2^32 pixels (every real one) divides in 32 bits
  const int x = plane <= UINT_MAX
                    ? static_cast<int>(static_cast<unsigned>(p) % static_cast<unsigned>(W))
                    : static_cast<int>(p % W);
  const Tap t = tile_tap<false>(
      __ldg(off + static_cast<size_t>(b) * plane + p), x, wp, lo, hi);

  const int c0 = g * kGatherChannels;
  const size_t first = (static_cast<size_t>(b) * C + c0) * plane;
  const float* r = src + first + (p - x);  // column 0 of the pixel's row
  float v0[kGatherChannels], v1[kGatherChannels];
#pragma unroll
  for (int j = 0; j < kGatherChannels; ++j) {
    const bool in = c0 + j < C;
    v0[j] = in ? padded_load(r + j * plane, t.i0, W) : 0.f;
    v1[j] = in ? padded_load(r + j * plane, t.i1, W) : 0.f;
  }
  float* dst = out + first + p;
#pragma unroll
  for (int j = 0; j < kGatherChannels; ++j) {
    if (c0 + j < C) dst[j * plane] = lerp2(t.w0, v0[j], t.w1, v1[j]);
  }
}

// Gradient of the offset: a thread per (pixel of the plane, slice of
// channels). blockDim = (pixels, slices), blockIdx.x the block of pixels,
// blockIdx.y the batch; slice y sums channels [y * cps, (y + 1) * cps).
template <bool kImage>
__global__ void __launch_bounds__(kOffMaxThreads)
    tile_bwd_offset_kernel(const float* __restrict__ src,
                           const float* __restrict__ off,
                           const float* __restrict__ g,
                           float* __restrict__ doff, int C, int W, int wp,
                           size_t plane, int cps, float lo, float hi) {
  __shared__ float part[kOffMaxThreads];
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = p < plane;  // an idle thread still meets the barrier
  const size_t pix = static_cast<size_t>(blockIdx.y) * plane + (active ? p : 0);
  const int x = !active            ? 0
                : plane <= UINT_MAX ? static_cast<int>(static_cast<unsigned>(p) %
                                                       static_cast<unsigned>(W))
                                    : static_cast<int>(p % W);
  const float raw = __ldg(off + pix);
  const Tap t = tile_tap<kImage>(raw, x, wp, lo, hi);

  const int c0 = threadIdx.y * cps;
  const int c1 = min(C, c0 + cps);
  float acc = 0.f;
  if (active) {
    const size_t first = (static_cast<size_t>(blockIdx.y) * C + c0) * plane;
    const float* r = src + first + (p - x);  // column 0 of the pixel's row
    const float* gp = g + first + p;
#pragma unroll 4
    for (int c = c0; c < c1; ++c, r += plane, gp += plane) {
      // image: i0 = floor(x - d) <= x < W, only the second tap can reach the pad
      const float v0 = kImage ? __ldg(r + t.i0) : padded_load(r, t.i0, W);
      const float v1 = padded_load(r, t.i1, W);
      // image: d out / d disp = v0 - v1 (the sample moves left as disp
      // grows); features: d out / d dx = in1 * v1 - in0 * v0
      const float diff =
          kImage ? __fsub_rn(v0, v1)
                 : __fsub_rn(__fmul_rn(t.in1, v1), __fmul_rn(t.in0, v0));
      acc = __fadd_rn(acc, __fmul_rn(__ldg(gp), diff));
    }
  }
  if (blockDim.y > 1) {  // the slices' partial sums, added in slice order
    part[threadIdx.y * blockDim.x + threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y != 0) return;
    for (unsigned s = 1; s < blockDim.y; ++s)
      acc = __fadd_rn(acc, part[s * blockDim.x + threadIdx.x]);
  }
  if (active) doff[pix] = (raw >= lo && raw <= hi) ? acc : 0.f;
}

// Gradient of the source: one block per (row, batch, chunk of channels);
// the row's tiles are walked in order into a shared-memory row buffer.
// Shared memory: rowbuf [kBwdChunk][W], g tile [kBwdChunk][kTile], the
// tile's tap records w0, w1 [kTile] floats and i0, i1 [kTile] ints.
template <bool kImage>
__global__ void tile_bwd_source_kernel(const float* __restrict__ off,
                                       const float* __restrict__ g,
                                       float* __restrict__ dsrc, int C, int H,
                                       int W, int wp, float lo, float hi,
                                       int back, int ahead, int n_chunks) {
  extern __shared__ float smem[];
  float* rowbuf = smem;
  float* gt = rowbuf + static_cast<size_t>(kBwdChunk) * W;
  float* tw0 = gt + kBwdChunk * kTile;
  float* tw1 = tw0 + kTile;
  int* ti0 = reinterpret_cast<int*>(tw1 + kTile);
  int* ti1 = ti0 + kTile;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y / n_chunks;
  const int c0 = (blockIdx.y % n_chunks) * kBwdChunk;
  const int nc = min(kBwdChunk, C - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float* offr = off + static_cast<size_t>(b) * plane + row;
  const size_t chan0 = (static_cast<size_t>(b) * C + c0) * plane + row;

  for (int i = tid; i < nc * W; i += kBwdThreads) rowbuf[i] = 0.f;

  const int n_tiles = (W + kTile - 1) / kTile;
  for (int k = 0; k < n_tiles; ++k) {
    const int x0c = k * kTile;
    __syncthreads();  // the previous tile's records have been walked
    if (tid < kTile) {
      const int x = x0c + tid;
      if (x < W) {
        const Tap t = tile_tap<kImage>(__ldg(offr + x), x, wp, lo, hi);
        tw0[tid] = t.w0;
        tw1[tid] = t.w1;
        ti0[tid] = t.i0;
        ti1[tid] = t.i1;
      } else {  // a pad column: its gradient is zero
        tw0[tid] = 0.f;
        tw1[tid] = 0.f;
        ti0[tid] = -1;
        ti1[tid] = -1;
      }
    }
    for (int i = tid; i < nc * kTile; i += kBwdThreads) {
      const int j = i / kTile;
      const int x = x0c + i % kTile;
      gt[i] = x < W ? __ldg(g + chan0 + j * plane + x) : 0.f;
    }
    __syncthreads();

    // the columns this tile can reach, cropped to the real row; an output
    // x reaches columns [x - back, x + ahead] only
    const int v_first = max(x0c - back, 0);
    const int v_last = min(x0c + kTile - 1 + ahead, W - 1);
    for (int v = v_first + tid; v <= v_last; v += kBwdThreads) {
      const int x_lo = max(v - ahead, x0c) - x0c;
      const int x_hi = min(min(v + back, x0c + kTile - 1), W - 1) - x0c;
      float acc[kBwdChunk];
#pragma unroll
      for (int j = 0; j < kBwdChunk; ++j) acc[j] = 0.f;
      for (int xx = x_lo; xx <= x_hi; ++xx) {
        const bool hit0 = ti0[xx] == v;
        const bool hit1 = ti1[xx] == v;
        if (hit0 || hit1) {
          const float w0 = tw0[xx];
          const float w1 = tw1[xx];
#pragma unroll
          for (int j = 0; j < kBwdChunk; ++j) {
            if (j < nc) {
              const float gv = gt[j * kTile + xx];
              if (hit0) acc[j] = __fadd_rn(acc[j], __fmul_rn(w0, gv));
              if (hit1) acc[j] = __fadd_rn(acc[j], __fmul_rn(w1, gv));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBwdChunk; ++j) {
        if (j < nc) rowbuf[j * W + v] = __fadd_rn(rowbuf[j * W + v], acc[j]);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nc * W; i += kBwdThreads) {
    const int j = i / W;
    dsrc[chan0 + j * plane + i % W] = rowbuf[i];
  }
}

// The window of a tile from the clip bounds [lo, hi] of the offset: an
// output x samples columns [x - back, x + ahead] (before and hence after
// clamping to the row).
template <bool kImage>
void window_of(float lo, float hi, int* back, int* ahead) {
  // image: floor(x - d) and the next, 0 <= d <= hi;
  // features: floor(x + d) and the next, lo <= d <= hi
  const int min_shift = kImage ? -static_cast<int>(std::ceil(hi))
                               : static_cast<int>(std::floor(lo));
  const int max_shift = kImage ? 1 : static_cast<int>(std::floor(hi)) + 1;
  *back = min_shift < 0 ? -min_shift : 0;
  *ahead = max_shift > 0 ? max_shift : 0;
}

inline int padded_width(int W) { return (W + kTile - 1) / kTile * kTile; }

int launch_image_fwd(const float* src, const float* off, float* out, int B,
                     int C, int H, int W, float max_disp,
                     cudaStream_t stream) {
  const dim3 grid((W + kGatherThreads - 1) / kGatherThreads, H, B);
  tile_image_fwd_kernel<<<grid, kGatherThreads, 0, stream>>>(
      src, off, out, C, H, W, padded_width(W), max_disp);
  return static_cast<int>(cudaGetLastError());
}

int launch_features_fwd(const float* src, const float* off, float* out, int B,
                        int C, int H, int W, float lo, float hi,
                        cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const long long pix_blocks = (plane + kGatherThreads - 1) / kGatherThreads;
  const long long groups =
      (static_cast<long long>(C) + kGatherChannels - 1) / kGatherChannels;
  if (pix_blocks * groups > INT_MAX || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(pix_blocks * groups), B);
  tile_feat_fwd_kernel<<<grid, kGatherThreads, 0, stream>>>(
      src, off, out, C, W, padded_width(W), plane,
      static_cast<int>(pix_blocks), lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// The offset gradient's launch: as many channel slices as it takes to put
// kOffFillThreads threads on the card, at most one a channel and
// kOffMaxSlices; each slice a warp of consecutive pixels, and up to 4 warps
// of pixels a block where the slices are fewer than 4.
template <bool kImage>
int launch_bwd_offset(const float* src, const float* off, const float* g,
                      float* doff, int B, int C, int H, int W, float lo,
                      float hi, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const long long pixels = static_cast<long long>(B) * static_cast<long long>(plane);
  long long want = pixels > 0 ? (kOffFillThreads + pixels - 1) / pixels : 1;
  want = want < kOffMaxSlices ? want : kOffMaxSlices;
  want = want < C ? want : C;
  const int slices0 = want > 1 ? static_cast<int>(want) : 1;
  const int cps = C > slices0 ? (C + slices0 - 1) / slices0 : 1;
  const int slices = C > cps ? (C + cps - 1) / cps : 1;  // none empty
  const int pix = kWarp * (slices < 4 ? 4 / slices : 1);
  const long long blocks = (static_cast<long long>(plane) + pix - 1) / pix;
  if (blocks > INT_MAX || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tile_bwd_offset_kernel<kImage>
      <<<dim3(static_cast<unsigned>(blocks), B), dim3(pix, slices), 0, stream>>>(
          src, off, g, doff, C, W, padded_width(W), plane, cps, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <bool kImage>
int launch_bwd(const float* src, const float* off, const float* g, float* dsrc,
               float* doff, int B, int C, int H, int W, float lo, float hi,
               int need_dsrc, int need_doff, cudaStream_t stream) {
  if (need_doff) {
    const int err =
        launch_bwd_offset<kImage>(src, off, g, doff, B, C, H, W, lo, hi, stream);
    if (err != 0) return err;
  }
  if (need_dsrc) {
    int back, ahead;
    window_of<kImage>(lo, hi, &back, &ahead);
    const int n_chunks = (C + kBwdChunk - 1) / kBwdChunk;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(kBwdChunk) * W +
                         kBwdChunk * kTile + 2 * kTile) +
        sizeof(int) * 2 * kTile;
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(H, B * n_chunks);
    tile_bwd_source_kernel<kImage><<<grid, kBwdThreads, smem, stream>>>(
        off, g, dsrc, C, H, W, padded_width(W), lo, hi, back, ahead, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

extern "C" {

// Raises the dynamic shared-memory limit of the source-gradient kernels,
// the only ones here that use it, on the current device. Called once when
// the library is loaded.
int warp_tile_init() {
  cudaError_t err = allow_max_smem(tile_bwd_source_kernel<true>);
  if (err == cudaSuccess) err = allow_max_smem(tile_bwd_source_kernel<false>);
  return static_cast<int>(err);
}

// img: [B, C, H, W] fp32 contiguous; disp: [B, 1, H, W]; out like img.
// Returns cudaGetLastError() after the launch (0 on success).
int warp_tile_image_fwd(const float* img, const float* disp, float* out, int B,
                        int C, int H, int W, float max_disp,
                        cudaStream_t stream) {
  return launch_image_fwd(img, disp, out, B, C, H, W, max_disp, stream);
}

// feats: [B, C, H, W] fp32 contiguous; dx: [B, 1, H, W]; out like feats.
int warp_tile_features_fwd(const float* feats, const float* dx, float* out,
                           int B, int C, int H, int W, float max_neg,
                           float max_pos, cudaStream_t stream) {
  return launch_features_fwd(feats, dx, out, B, C, H, W, -max_neg, max_pos,
                             stream);
}

// Backward of warp_tile_image_fwd. g: gradient of the output, like img.
// dimg (like img) is written when need_dimg != 0, ddisp (like disp) when
// need_ddisp != 0; a pointer whose flag is 0 is not touched.
int warp_tile_image_bwd(const float* img, const float* disp, const float* g,
                        float* dimg, float* ddisp, int B, int C, int H, int W,
                        float max_disp, int need_dimg, int need_ddisp,
                        cudaStream_t stream) {
  return launch_bwd<true>(img, disp, g, dimg, ddisp, B, C, H, W, 0.f, max_disp,
                          need_dimg, need_ddisp, stream);
}

// Backward of warp_tile_features_fwd, with the same conventions.
int warp_tile_features_bwd(const float* feats, const float* dx, const float* g,
                           float* dfeats, float* ddx, int B, int C, int H,
                           int W, float max_neg, float max_pos,
                           int need_dfeats, int need_ddx,
                           cudaStream_t stream) {
  return launch_bwd<false>(feats, dx, g, dfeats, ddx, B, C, H, W, -max_neg,
                           max_pos, need_dfeats, need_ddx, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
