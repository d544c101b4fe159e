// Tiled one-hot warps, forward and backward, for sm_90a.
//
// warp_tile_image_fwd and warp_tile_features_fwd replace the Pallas TPU
// kernel `_mxu_fwd_kernel` (real_time_self_adaptive_deep_stereo_tpu/ops/
// warp_pallas.py), launched through `_mxu_call` by `warp_image_mxu` and
// `warp_features_mxu`; warp_tile_image_bwd and warp_tile_features_bwd
// replace `_mxu_bwd_kernel`, the backward of the same functions.
//
// What they compute. Both samplings of csrc/warp.cu as one scheme: per
// tile of 128 output columns,
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
// is no design: a thread gathers. What carries over is staging the source
// in fast memory, and each kernel stages it in the shape its row asks for.
//
// The image warp (`tile_fwd_kernel`, one [3, 1216] row a block row): one
// block owns (batch, row, tile, chunk of channels), stages the tile's
// window (`back` columns to the left, `ahead` to the right, from the clip
// bounds) in shared memory with coalesced loads, computes each column's
// two taps and weights once for all channels, and reads the taps from
// shared memory.
//
// The feature warp (`feat_row_fwd_kernel`) runs on MADNet's short, deep
// rows, [C, W] = [128, 38] to [32, 304]. There a 128-column tile leaves
// most of a block idle and most of its window zero fill, and the time is
// set by latency, not bytes: a call moves 0.4-2 MB, under a microsecond at
// the card's memory rate, while a block that stages channel after channel
// waits for one round of loads after another. So, as the TPU kernel stages
// each row whole once (`buf_ref`), a block owns one whole row of a chunk
// of kRowChunk channels, (batch, row, chunk), and stages it once: with
// `cp.async`, 4 bytes a copy (the rows of a [C, H, 38] map are not 16-byte
// aligned), so every load of the block is in flight at once without
// passing through registers, and columns from W up to the padded width
// are zero-filled by the same instruction. The row's offsets are staged
// the same way, so one round of load latency serves the whole block. Then
// the block computes each column's taps once (`tile_tap`) into shared
// memory, and its threads stride over the chunk's outputs, x fastest, so
// the stores are coalesced. Threads map to (channel, column) pairs with
// one division each, so that no element pays for one. The taps are clamped
// to the padded row, so the staged row [0, min(W + ahead, wp)) holds every
// column they read.
//
// kRowChunk = 4 gives scales 5 and 4 (10 and 20 rows) 320 and 480 blocks,
// more than the 132 SMs. With kRowThreads = 128 it was picked on the H100
// from 2, 4, 8 and 16 channels by 128 and 256 threads (PERF.md, PR 4).
// Staging stays slower than `grid_sample` there, where the gather of
// csrc/warp.cu is faster: each block pays its stage, a barrier, the taps
// and a barrier before its first store, about half a microsecond more than
// the gather at scale 5, where both sit at the launch floor, and about
// 1.3 us more at scales 3 and 2. Copy groups per channel (stores
// overlapping the later channels' loads), taps kept in registers, and
// plain loads instead of `cp.async` did no better.
//
// A row whose staging would pass the card's 227 KB is cut into segments
// of output columns, each with the window its clip bounds reach,
// [x - back, x + ahead]; only such a row stages a column more than once.
// A chunk holds at most as many channels as a tile's window did, so every
// clip window that fits a tile's staging fits a segment too.
//
// What bounds them: latency at MADNet's shapes (above); by count, memory:
// (2C + 1) * 4 bytes per pixel forward, a handful of operations per
// element; the backward reads the incoming gradient too and writes both
// gradients.
//
// The backward is two kernels behind one entry point, each skipped when
// its gradient is not asked for:
//
// * the offset gradient: a block owns (batch, row, tile) and walks the
//   channel chunks, staging each chunk's window as the forward does; the
//   thread of output column x takes v0 and v1 from the staged window and
//   sums g * (v0 - v1) (image) or g * (in1*v1 - in0*v0) (features) over
//   the channels in order, zeroed where the unclipped offset lies outside
//   its window (inclusive bounds);
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
//   cropped to the real width.
//
// Shared memory is dynamic. `warp_tile_init` raises every kernel's limit
// to the card's 227 KB once, when the library is loaded, so that no launch
// changes a function attribute (a launch may be under stream capture); an
// entry point refuses a shape that needs more.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace {

constexpr int kTile = 128;        // output columns per tile
constexpr int kFwdChunk = 16;     // channels per staged window
constexpr int kRowChunk = 4;      // channels per staged row
constexpr int kRowThreads = 128;  // threads of the row block
constexpr int kBwdChunk = 8;      // channels per row buffer
constexpr int kBwdThreads = 256;  // threads of the source-gradient block
constexpr int kMaxSmem = 232448;  // bytes a block can use on sm_90

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

// Columns [col0, col0 + vlen) of `nc` channel rows into `win`
// ([nc][vlen]); zero outside the real row [0, W). `rows` points at
// column 0 of the first channel's row.
__device__ __forceinline__ void stage_window(const float* __restrict__ rows,
                                             size_t plane, int nc, int W,
                                             int col0, int vlen, float* win) {
  for (int j = 0; j < nc; ++j) {
    const float* r = rows + j * plane;
    for (int v = threadIdx.x; v < vlen; v += blockDim.x) {
      const int col = col0 + v;
      win[j * vlen + v] = (col >= 0 && col < W) ? __ldg(r + col) : 0.f;
    }
  }
}

// Window index of a clamped sample column; the clip bounds keep it inside
// [0, vlen), the min/max only guards the shared-memory read.
__device__ __forceinline__ int window_index(int col, int col0, int vlen) {
  return min(max(col - col0, 0), vlen - 1);
}

// Image warp: one block per (tile, row, batch times channel chunk).
__global__ void tile_fwd_kernel(const float* __restrict__ src,
                                const float* __restrict__ off,
                                float* __restrict__ out, int C, int H, int W,
                                int wp, float lo, float hi, int back, int vlen,
                                int n_chunks) {
  extern __shared__ float win[];
  const int x0c = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * kFwdChunk;
  const int nc = min(kFwdChunk, C - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const size_t chan0 = (static_cast<size_t>(b) * C + c0) * plane + row;
  const int col0 = x0c - back;

  stage_window(src + chan0, plane, nc, W, col0, vlen, win);
  __syncthreads();

  const int x = x0c + threadIdx.x;
  if (x >= W) return;
  const Tap t = tile_tap<true>(
      __ldg(off + static_cast<size_t>(b) * plane + row + x), x, wp, lo, hi);
  const int r0 = window_index(t.i0, col0, vlen);
  const int r1 = window_index(t.i1, col0, vlen);
  float* dst = out + chan0 + x;
  for (int j = 0; j < nc; ++j) {
    const float* wj = win + j * vlen;
    dst[j * plane] = lerp2(t.w0, wj[r0], t.w1, wj[r1]);
  }
}

// One output column's taps, as the row block keeps them in shared memory:
// weights and the two sample columns relative to the staged window.
struct RowTap {
  float w0, w1;
  int r0, r1;
};

// 4-byte asynchronous copy from device to shared memory; with `valid`
// false it reads nothing and writes a zero.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Feature warp: one block per (segment of output columns, chunk of
// kRowChunk channels), row, batch; blockIdx.x = chunk * n_seg + segment.
// Shared memory: the segment's taps [seg], its offsets [seg], then the
// staged window [nc][L] of columns [ws, ws + L).
__global__ void __launch_bounds__(kRowThreads)
    feat_row_fwd_kernel(const float* __restrict__ src,
                        const float* __restrict__ off, float* __restrict__ out,
                        int C, int H, int W, int wp, float lo, float hi,
                        int back, int ahead, int seg, int n_seg) {
  extern __shared__ float4 smem4[];
  RowTap* taps = reinterpret_cast<RowTap*>(smem4);
  float* offs = reinterpret_cast<float*>(taps + seg);
  float* win = offs + seg;

  const int chunk = blockIdx.x / n_seg;
  const int xs = (blockIdx.x - chunk * n_seg) * seg;
  const int xe = min(xs + seg, W);
  const int nx = xe - xs;
  const int ws = max(xs - back, 0);
  const int len = min(xe + ahead, wp) - ws;  // L
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = chunk * kRowChunk;
  const int nc = min(kRowChunk, C - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const size_t chan0 = (static_cast<size_t>(b) * C + c0) * plane + row;

  // stage the offsets and the window, every copy in flight at once;
  // columns >= W are zero. A thread takes one column v0 of channels j0,
  // j0 + lanes, ... where the block has threads for several channels of a
  // column, else columns v0, v0 + kRowThreads, ... of every channel: one
  // division a thread, none an element.
  const float* offr = off + static_cast<size_t>(b) * plane + row + xs;
  for (int x = threadIdx.x; x < nx; x += kRowThreads)
    cp_async_f32(offs + x, offr + x, true);
  {
    const int lanes = max(kRowThreads / len, 1);
    const int j0 = threadIdx.x / len;
    const int v0 = threadIdx.x - j0 * len;
    const float* rows = src + chan0;
    for (int j = j0 < lanes ? j0 : nc; j < nc; j += lanes) {  // spare threads idle
      for (int v = v0; v < len; v += kRowThreads) {
        const bool in = ws + v < W;
        cp_async_f32(win + j * len + v, rows + j * plane + (in ? ws + v : 0),
                     in);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the taps, once per column; the min/max only guards the shared-memory
  // reads, the clip bounds keep them in [0, L)
  for (int x = threadIdx.x; x < nx; x += kRowThreads) {
    const Tap t = tile_tap<false>(offs[x], xs + x, wp, lo, hi);
    taps[x] = RowTap{t.w0, t.w1, min(max(t.i0 - ws, 0), len - 1),
                     min(max(t.i1 - ws, 0), len - 1)};
  }
  __syncthreads();

  // the outputs, x fastest across the threads, with the same split of
  // channels and columns; each thread reads a column's tap once
  const int lanes = max(kRowThreads / nx, 1);
  const int j0 = threadIdx.x / nx;
  const int x0 = threadIdx.x - j0 * nx;
  float* dst = out + chan0 + xs;
  for (int x = x0; x < nx; x += kRowThreads) {
    const RowTap t = taps[x];
#pragma unroll 4
    for (int j = j0 < lanes ? j0 : nc; j < nc; j += lanes) {
      const float* wj = win + j * len;
      dst[j * plane + x] = lerp2(t.w0, wj[t.r0], t.w1, wj[t.r1]);
    }
  }
}

// Gradient of the offset: one block per (tile, row, batch), 128 threads,
// one per output column; the channel chunks are walked in order.
template <bool kImage>
__global__ void tile_bwd_offset_kernel(const float* __restrict__ src,
                                       const float* __restrict__ off,
                                       const float* __restrict__ g,
                                       float* __restrict__ doff, int C, int H,
                                       int W, int wp, float lo, float hi,
                                       int back, int vlen) {
  extern __shared__ float win[];
  const int x0c = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const int col0 = x0c - back;
  const int x = x0c + threadIdx.x;
  const bool active = x < W;
  const size_t pix = static_cast<size_t>(b) * plane + row + (active ? x : 0);

  const float raw = __ldg(off + pix);
  const Tap t = tile_tap<kImage>(raw, active ? x : 0, wp, lo, hi);
  const int r0 = window_index(t.i0, col0, vlen);
  const int r1 = window_index(t.i1, col0, vlen);

  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += kFwdChunk) {
    const int nc = min(kFwdChunk, C - c0);
    const size_t chan0 = (static_cast<size_t>(b) * C + c0) * plane + row;
    __syncthreads();  // the previous chunk's window has been read
    stage_window(src + chan0, plane, nc, W, col0, vlen, win);
    __syncthreads();
    if (active) {
      const float* gp = g + chan0 + x;
      for (int j = 0; j < nc; ++j) {
        const float v0 = win[j * vlen + r0];
        const float v1 = win[j * vlen + r1];
        // image: d out / d disp = v0 - v1 (the sample moves left as disp
        // grows); features: d out / d dx = in1 * v1 - in0 * v0
        const float diff =
            kImage ? __fsub_rn(v0, v1)
                   : __fsub_rn(__fmul_rn(t.in1, v1), __fmul_rn(t.in0, v0));
        acc = __fadd_rn(acc, __fmul_rn(__ldg(gp + j * plane), diff));
      }
    }
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
  int back, ahead;
  window_of<true>(0.f, max_disp, &back, &ahead);
  const int vlen = back + kTile + ahead;
  const int n_chunks = (C + kFwdChunk - 1) / kFwdChunk;
  const size_t smem = sizeof(float) * (C < kFwdChunk ? C : kFwdChunk) * vlen;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTile - 1) / kTile, H, B * n_chunks);
  tile_fwd_kernel<<<grid, kTile, smem, stream>>>(
      src, off, out, C, H, W, padded_width(W), 0.f, max_disp, back, vlen,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Floats of shared memory per output column of a segment: its tap record
// and its offset.
constexpr long long kRowColFloats = sizeof(RowTap) / sizeof(float) + 1;

// Shared memory of a row block: `seg` columns' taps and offsets, and nc
// rows of the window, which spans at most seg + back + ahead columns of the
// padded row (a whole row: the columns [0, min(W + ahead, wp))).
long long row_smem(long long seg, int nc, int W, int wp, int back,
                   int ahead) {
  const long long span =
      seg >= W ? std::min<long long>(W + ahead, wp)
               : std::min<long long>(seg + back + ahead, wp);
  return static_cast<long long>(sizeof(float)) *
         (kRowColFloats * seg + static_cast<long long>(nc) * span);
}

// The most output columns a segment can have within kMaxSmem bytes (< 1
// if the window alone does not fit).
long long row_seg_fit(int nc, int back, int ahead) {
  const long long floats = kMaxSmem / static_cast<long long>(sizeof(float));
  return (floats - static_cast<long long>(nc) * (back + ahead)) /
         (kRowColFloats + nc);
}

int launch_features_fwd(const float* src, const float* off, float* out, int B,
                        int C, int H, int W, float lo, float hi,
                        cudaStream_t stream) {
  int back, ahead;
  window_of<false>(lo, hi, &back, &ahead);
  const int wp = padded_width(W);
  const int nc = C < kRowChunk ? C : kRowChunk;
  long long seg = W;  // the whole row, unless it passes kMaxSmem
  if (row_smem(seg, nc, W, wp, back, ahead) > kMaxSmem) {
    seg = std::min<long long>(row_seg_fit(nc, back, ahead), W);
    if (seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = row_smem(seg, nc, W, wp, back, ahead);
  const long long n_seg = (W + seg - 1) / seg;
  const long long n_chunks = (static_cast<long long>(C) + kRowChunk - 1) / kRowChunk;
  if (n_seg * n_chunks > INT_MAX || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_seg * n_chunks), H, B);
  feat_row_fwd_kernel<<<grid, kRowThreads, static_cast<size_t>(smem), stream>>>(
      src, off, out, C, H, W, wp, lo, hi, back, ahead, static_cast<int>(seg),
      static_cast<int>(n_seg));
  return static_cast<int>(cudaGetLastError());
}

template <bool kImage>
int launch_bwd(const float* src, const float* off, const float* g, float* dsrc,
               float* doff, int B, int C, int H, int W, float lo, float hi,
               int need_dsrc, int need_doff, cudaStream_t stream) {
  int back, ahead;
  window_of<kImage>(lo, hi, &back, &ahead);
  const int wp = padded_width(W);
  if (need_doff) {
    const int vlen = back + kTile + ahead;
    const size_t smem = sizeof(float) * (C < kFwdChunk ? C : kFwdChunk) * vlen;
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((W + kTile - 1) / kTile, H, B);
    tile_bwd_offset_kernel<kImage><<<grid, kTile, smem, stream>>>(
        src, off, g, doff, C, H, W, wp, lo, hi, back, vlen);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dsrc) {
    const int n_chunks = (C + kBwdChunk - 1) / kBwdChunk;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(kBwdChunk) * W +
                         kBwdChunk * kTile + 2 * kTile) +
        sizeof(int) * 2 * kTile;
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(H, B * n_chunks);
    tile_bwd_source_kernel<kImage><<<grid, kBwdThreads, smem, stream>>>(
        off, g, dsrc, C, H, W, wp, lo, hi, back, ahead, n_chunks);
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

// Raises the dynamic shared-memory limit of every kernel here, on the
// current device. Called once when the library is loaded.
int warp_tile_init() {
  cudaError_t err = allow_max_smem(tile_fwd_kernel);
  if (err == cudaSuccess) err = allow_max_smem(feat_row_fwd_kernel);
  if (err == cudaSuccess) err = allow_max_smem(tile_bwd_offset_kernel<true>);
  if (err == cudaSuccess) err = allow_max_smem(tile_bwd_offset_kernel<false>);
  if (err == cudaSuccess) err = allow_max_smem(tile_bwd_source_kernel<true>);
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
