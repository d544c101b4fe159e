// Horizontal disparity warps, forward and backward, for sm_90a.
//
// warp_image_fwd replaces the Pallas TPU kernel `_img_fwd_kernel`
// (real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py), launched
// by `warp_image_pallas`: a clamp-to-edge warp of the right image at
// x - d, with d clipped to [0, max_disp] and bilinear weights taken from
// the unclamped coordinate. warp_image_bwd replaces `_img_bwd_kernel`,
// the backward of the same function.
//
// warp_features_fwd replaces `_feat_fwd_kernel` (same file), launched by
// `warp_features_pallas`: a warp of feature maps at x + dx, with dx
// clipped to [-max_neg, max_pos] and the weight of a corner outside
// [0, W-1] set to zero (`_feat_weights`). warp_features_bwd replaces
// `_feat_bwd_kernel`.
//
// What bounds them. Each output element is two loads, two multiplies and
// an add, so the compulsory traffic is (2C + 1) * 4 bytes per pixel
// (forward; the backward reads the incoming gradient too and writes both
// gradients). The TPU kernels sweep every shift of a static window
// because a lane gather is slow there; a GPU thread gathers directly, so
// in the forward the window costs nothing and the clip only sets the
// semantics. The sampling weights and indices are computed once per
// pixel (`image_tap`, `feature_tap`, shared by forward and backward so
// that they cannot disagree) and reused across channels.
//
// The image warp (C = 3, 389,120 pixels) has one thread per output pixel
// (b, h, x), consecutive threads on consecutive x: the offset load and
// every store are coalesced, and the gathered columns of neighbouring
// threads share cache lines.
//
// The feature warp runs on MADNet's short, deep rows: [C, H, W] =
// [128, 10, 38] to [32, 80, 304], 380 to 24,320 pixels. There a thread
// per pixel that walks every channel leaves most SMs idle (10 blocks at
// scale 5) and chains dozens of rounds of dependent gathers, and load
// latency, not bytes, sets the time: the whole call moves 0.4-2 MB, under
// a microsecond at the card's memory rate. So `feat_gather_fwd_kernel`
// spreads the channels over the grid. Each channel plane is taken as one
// run of H*W pixels (contiguous in NCHW); consecutive threads take
// consecutive pixels, across row ends, so the offset load and the stores
// stay coalesced even where a row is 38 floats long. A thread computes
// its pixel's tap once for a group of kFeatChannels channels and issues
// the group's 2 * kFeatChannels gathers before its first store, so they
// are in flight together. The grid's x axis holds the channel groups
// times the pixel blocks, its y axis the batch. kFeatChannels = 4 and
// kFeatThreads = 128 were picked on the H100 from 1, 2, 4 and 8 channels
// by 64, 128 and 256 threads (PERF.md, PR 4): one or two channels keep too
// few gathers in flight at scales 3 and 2, eight need more registers and
// halve the grid for no gain. At scale 5 every choice sits at the launch
// floor, about 2.2 us.
//
// The backward is two kernels behind one entry point, each skipped when
// its gradient is not asked for. Floating-point atomics are out: their
// order changes from run to run, and the adaptation's trajectory depends
// on the order of sums. So both gradients are gathers, and every run adds
// in the same order and agrees bit for bit.
//
// The image warp's (`warp_bwd_offset_kernel<true>`,
// `warp_bwd_source_kernel<true>`, [3, 320, 1216] on the main path):
//
// * the offset gradient: the thread of output pixel x sums g * v0 and
//   g * v1 over the channels at its two taps, and the result is zeroed
//   where the unclipped offset lies outside its window (inclusive bounds,
//   as `torch.clamp` and the TPU kernel have it);
// * the source gradient, the transpose of the sampling: the thread of
//   source column v and a chunk of kChunk channels walks the outputs x
//   that can sample v, in increasing x, recomputes their taps and adds
//   w * g where a tap's clamped index equals v. An output x samples
//   floor(x - d) and the column after it with 0 <= d <= S, so column v
//   is reached only from x in [v - 1, v + S]. Clamped indices make the
//   fold into column 0 (everything sampled left of the image) fall out of
//   the same test, and column 0's walk [0, S] covers it.
//
// The feature warp's run on MADNet's short, deep rows, where that form
// left most lanes idle and chained a load per channel (380 threads
// walking 128 channels each at scale 5), and asked C / kChunk times the
// channel-independent question of which outputs reach a column. They take
// the forms of csrc/warp_tile.cu's tiled backward, with K5's own tap
// (`feature_tap`: clamped to the row [0, W - 1], a corner outside it of
// weight 0):
//
// * the offset gradient (`feat_bwd_offset_kernel`): a thread owns (pixel
//   of the H*W plane, slice of channels), consecutive threads on
//   consecutive pixels across row ends, so that the loads of g and of the
//   offset and the store stay coalesced on rows of 38 floats. It computes
//   its taps once and sums g * (in1 * v1 - in0 * v0) over its slice's
//   channels in order. The host cuts the channels into as many slices
//   (threadIdx.y, at most 32, none empty) as it takes to put some 1,024
//   threads on each SM: scale 5 ([128, 10, 38]) takes 32 slices of 4
//   channels. The slices' sums meet in static shared memory and the first
//   slice's thread adds them in slice order. The result is zeroed where
//   the unclipped offset lies outside [-max_neg, max_pos];
// * the source gradient (`feat_bwd_source_kernel`): a thread owns
//   (column of the H*W plane, slice of at most kSrcMaxCps channels kept
//   in registers). An output x samples columns [x - ceil(max_neg),
//   x + floor(max_pos) + 1], so column v is reached from the outputs
//   [v - floor(max_pos) - 1, v + ceil(max_neg)] of its row alone. A block
//   computes the taps of the outputs that can reach its columns once,
//   into static shared memory; the slices of a column build, a word of 32
//   outputs each, the bit mask of the outputs whose tap lands on it; then
//   each thread walks its column's bits in increasing x and adds w * g[c,
//   x] for its channels. Each dfeats value has one owner and one order of
//   sum, fixed by x, as in the image warp's walk. Taps of weight 0 are
//   cropped from the mask: every output that samples left of the row has
//   a tap clamped to column 0 with weight 0, and every one that samples
//   right of it a tap clamped to column W - 1; kept, they would pile up
//   on those columns and one thread would walk the pile in series. A
//   tap of non-zero weight lies in the row unclamped, so the window
//   bounds every such tap. A window of more than 256 outputs is taken in
//   passes of 256, so no window is refused.
//
// No kernel here uses dynamic shared memory (the offset gradient keeps 4
// KB of partial sums, the source gradient 10 KB of tap records and masks),
// so no launch sets a function attribute (a launch may be under stream
// capture).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 4;  // channels per thread in the source gradient
constexpr int kFeatChannels = 4;  // channels per thread, feature forward
constexpr int kFeatThreads = 128;  // threads per block, feature forward
constexpr int kWarp = 32;
// the feature backward: threads of a block, at most, and channel slices a
// pixel, at most
constexpr int kOffMaxThreads = 1024;
constexpr int kOffMaxSlices = kOffMaxThreads / kWarp;
// threads a feature backward launch aims for: 1,024 on each of the H100's
// 132 SMs, where the channels allow
constexpr long long kOffFillThreads = 132LL * 1024;
constexpr int kSrcMaxCps = 4;  // channels a source-gradient thread sums, at most
constexpr int kSrcMaxPix = 4 * kWarp;  // columns of a source-gradient block, at most
constexpr int kMaskWords = 8;  // 32-output words of a column's mask a pass
constexpr int kPassCands = kMaskWords * kWarp;  // outputs a column tests a pass
constexpr int kSrcStage = kSrcMaxPix + kPassCands - 1;  // tap records a pass

// w0*a + w1*b with every product and sum rounded on its own, as the plain
// PyTorch version computes it: no contraction into an FMA, so the kernel
// and its plain version agree bit for bit.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// The two taps of one output pixel: weights, clamped source columns, and
// whether each unclamped column lies inside the row (always 1 for the
// image warp, whose out-of-range taps read the edge).
struct Tap {
  float w0, w1, in0, in1;
  int i0, i1;
};

__device__ __forceinline__ Tap image_tap(float disp, int x, int W,
                                         float max_disp) {
  const float d = fminf(fmaxf(disp, 0.f), max_disp);
  const float cx = static_cast<float>(x) - d;
  const float x0 = floorf(cx);
  const float last = static_cast<float>(W - 1);
  Tap t;
  t.w1 = cx - x0;
  t.w0 = 1.f - t.w1;
  t.in0 = 1.f;
  t.in1 = 1.f;
  t.i0 = static_cast<int>(fminf(fmaxf(x0, 0.f), last));
  t.i1 = static_cast<int>(fminf(fmaxf(x0 + 1.f, 0.f), last));
  return t;
}

__device__ __forceinline__ Tap feature_tap(float dx, int x, int W,
                                           float max_neg, float max_pos) {
  const float d = fminf(fmaxf(dx, -max_neg), max_pos);
  const float cx = static_cast<float>(x) + d;
  const float x0 = floorf(cx);
  const float x1 = x0 + 1.f;
  const float last = static_cast<float>(W - 1);
  Tap t;
  t.in0 = (x0 >= 0.f && x0 <= last) ? 1.f : 0.f;
  t.in1 = (x1 >= 0.f && x1 <= last) ? 1.f : 0.f;
  t.w0 = (x1 - cx) * t.in0;
  t.w1 = (cx - x0) * t.in1;
  t.i0 = static_cast<int>(fminf(fmaxf(x0, 0.f), last));
  t.i1 = static_cast<int>(fminf(fmaxf(x1, 0.f), last));
  return t;
}

// kImage: image warp with window [0, hi]; else feature warp with window
// [-lo, hi] (lo = max_neg, hi = max_pos).
template <bool kImage>
__device__ __forceinline__ Tap tap_of(float off, int x, int W, float lo,
                                      float hi) {
  return kImage ? image_tap(off, x, W, hi) : feature_tap(off, x, W, lo, hi);
}

// Image warp: one thread per output pixel (b, h, x).
__global__ void warp_fwd_kernel(const float* __restrict__ src,
                                const float* __restrict__ off,
                                float* __restrict__ out, int C, int H, int W,
                                float max_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const Tap t = image_tap(
      __ldg(off + static_cast<size_t>(b) * plane + row + x), x, W, max_disp);

  const float* s = src + static_cast<size_t>(b) * C * plane + row;
  float* dst = out + static_cast<size_t>(b) * C * plane + row + x;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = s + c * plane;
    dst[c * plane] = lerp2(t.w0, __ldg(r + t.i0), t.w1, __ldg(r + t.i1));
  }
}

// Feature warp: one thread per (pixel of the plane, group of kFeatChannels
// channels). blockIdx.x = group * pix_blocks + block of pixels; blockIdx.y
// is the batch. A group past C's end keeps its gathers and stores masked.
__global__ void __launch_bounds__(kFeatThreads)
    feat_gather_fwd_kernel(const float* __restrict__ src,
                           const float* __restrict__ off,
                           float* __restrict__ out, int C, int W,
                           size_t plane, int pix_blocks, float lo, float hi) {
  const int g = blockIdx.x / pix_blocks;
  const size_t p =
      static_cast<size_t>(blockIdx.x - g * pix_blocks) * kFeatThreads +
      threadIdx.x;
  if (p >= plane) return;
  const int b = blockIdx.y;
  // the column; a plane under 2^32 pixels (every real one) divides in 32 bits
  const int x = plane <= UINT_MAX
                    ? static_cast<int>(static_cast<unsigned>(p) % static_cast<unsigned>(W))
                    : static_cast<int>(p % W);
  const Tap t = feature_tap(__ldg(off + static_cast<size_t>(b) * plane + p), x,
                            W, lo, hi);

  const int c0 = g * kFeatChannels;
  const size_t first = (static_cast<size_t>(b) * C + c0) * plane;
  const float* r = src + first + (p - x);  // column 0 of the pixel's row
  float v0[kFeatChannels], v1[kFeatChannels];
#pragma unroll
  for (int j = 0; j < kFeatChannels; ++j) {
    const bool in = c0 + j < C;
    v0[j] = in ? __ldg(r + j * plane + t.i0) : 0.f;
    v1[j] = in ? __ldg(r + j * plane + t.i1) : 0.f;
  }
  float* dst = out + first + p;
#pragma unroll
  for (int j = 0; j < kFeatChannels; ++j) {
    if (c0 + j < C) dst[j * plane] = lerp2(t.w0, v0[j], t.w1, v1[j]);
  }
}

// Gradient of the offset: one thread per output pixel (b, h, x).
template <bool kImage>
__global__ void warp_bwd_offset_kernel(const float* __restrict__ src,
                                       const float* __restrict__ off,
                                       const float* __restrict__ g,
                                       float* __restrict__ doff, int C, int H,
                                       int W, float lo, float hi) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const size_t pix = static_cast<size_t>(b) * plane + row + x;
  const float raw = __ldg(off + pix);
  const Tap t = tap_of<kImage>(raw, x, W, lo, hi);

  const float* s = src + static_cast<size_t>(b) * C * plane + row;
  const float* gp = g + static_cast<size_t>(b) * C * plane + row + x;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = s + c * plane;
    const float gv = __ldg(gp + c * plane);
    s0 = __fadd_rn(s0, __fmul_rn(gv, __ldg(r + t.i0)));
    s1 = __fadd_rn(s1, __fmul_rn(gv, __ldg(r + t.i1)));
  }
  // image: d out / d disp = v0 - v1 (the sample moves left as disp grows);
  // features: d out / d dx = in1 * v1 - in0 * v0
  const float val = kImage ? __fsub_rn(s0, s1)
                           : __fsub_rn(__fmul_rn(s1, t.in1), __fmul_rn(s0, t.in0));
  const bool inside = kImage ? (raw >= 0.f && raw <= hi) : (raw >= -lo && raw <= hi);
  doff[pix] = inside ? val : 0.f;
}

// Gradient of the source: one thread per source column (b, h, v) and
// chunk of kChunk channels; outputs x in [v - back, v + ahead] can sample v.
template <bool kImage>
__global__ void warp_bwd_source_kernel(const float* __restrict__ off,
                                       const float* __restrict__ g,
                                       float* __restrict__ dsrc, int C, int H,
                                       int W, float lo, float hi, int back,
                                       int ahead, int n_chunks) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * kChunk;
  if (v >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float* offr = off + static_cast<size_t>(b) * plane + row;
  const float* gr = g + (static_cast<size_t>(b) * C + c0) * plane + row;

  float acc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;

  const int x_first = max(v - back, 0);
  const int x_last = min(v + ahead, W - 1);
  for (int x = x_first; x <= x_last; ++x) {
    const Tap t = tap_of<kImage>(__ldg(offr + x), x, W, lo, hi);
    const bool hit0 = t.i0 == v;
    const bool hit1 = t.i1 == v;
    if (hit0 || hit1) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < C) {
          const float gv = __ldg(gr + j * plane + x);
          if (hit0) acc[j] = __fadd_rn(acc[j], __fmul_rn(t.w0, gv));
          if (hit1) acc[j] = __fadd_rn(acc[j], __fmul_rn(t.w1, gv));
        }
      }
    }
  }

  float* dst = dsrc + (static_cast<size_t>(b) * C + c0) * plane + row + v;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (c0 + j < C) dst[j * plane] = acc[j];
  }
}

template <bool kImage>
int launch_bwd(const float* src, const float* off, const float* g, float* dsrc,
               float* doff, int B, int C, int H, int W, float lo, float hi,
               int back, int ahead, int need_dsrc, int need_doff,
               cudaStream_t stream) {
  const int tiles = (W + kThreads - 1) / kThreads;
  if (need_doff) {
    warp_bwd_offset_kernel<kImage><<<dim3(tiles, H, B), kThreads, 0, stream>>>(
        src, off, g, doff, C, H, W, lo, hi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dsrc) {
    const int n_chunks = (C + kChunk - 1) / kChunk;
    warp_bwd_source_kernel<kImage>
        <<<dim3(tiles, H, B * n_chunks), kThreads, 0, stream>>>(
            off, g, dsrc, C, H, W, lo, hi, back, ahead, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column of plane index p, for a plane of W-pixel rows; a plane under
// 2^32 pixels (every real one) divides in 32 bits.
__device__ __forceinline__ int column_of(size_t p, size_t plane, int W) {
  return plane <= UINT_MAX
             ? static_cast<int>(static_cast<unsigned>(p) % static_cast<unsigned>(W))
             : static_cast<int>(p % W);
}

// Gradient of the feature offset: a thread per (pixel of the plane, slice
// of channels). blockDim = (pixels, slices), blockIdx.x the block of
// pixels, blockIdx.y the batch; slice y sums channels [y * cps, (y + 1) *
// cps). The offset is clipped to [-max_neg, max_pos].
__global__ void __launch_bounds__(kOffMaxThreads)
    feat_bwd_offset_kernel(const float* __restrict__ src,
                           const float* __restrict__ off,
                           const float* __restrict__ g,
                           float* __restrict__ doff, int C, int W,
                           size_t plane, int cps, float max_neg,
                           float max_pos) {
  __shared__ float part[kOffMaxThreads];
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = p < plane;  // an idle thread still meets the barrier
  const size_t pix = static_cast<size_t>(blockIdx.y) * plane + (active ? p : 0);
  const int x = active ? column_of(p, plane, W) : 0;
  const float raw = __ldg(off + pix);
  const Tap t = feature_tap(raw, x, W, max_neg, max_pos);

  const int c0 = threadIdx.y * cps;
  const int c1 = min(C, c0 + cps);
  float acc = 0.f;
  if (active) {
    const size_t first = (static_cast<size_t>(blockIdx.y) * C + c0) * plane;
    const float* r = src + first + (p - x);  // column 0 of the pixel's row
    const float* gp = g + first + p;
#pragma unroll 4
    for (int c = c0; c < c1; ++c, r += plane, gp += plane) {
      // d out / d dx = in1 * v1 - in0 * v0
      const float diff = __fsub_rn(__fmul_rn(t.in1, __ldg(r + t.i1)),
                                   __fmul_rn(t.in0, __ldg(r + t.i0)));
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
  if (active) doff[pix] = (raw >= -max_neg && raw <= max_pos) ? acc : 0.f;
}

// Gradient of the features: a thread per (column of the plane, slice of
// channels). blockDim = (columns, slices), blockIdx.x the block of
// columns, blockIdx.y = batch * groups + group of channels; slice y of
// group n sums channels [(n * slices + y) * cps, ... + cps). Column p is
// reached by the outputs [p - ahead, p + back] of its row alone; a pass
// takes kPassCands of them, in increasing order:
//   1. the block computes the taps of the pass's outputs once, into shared
//      memory, each tap as a plane column relative to the block's first
//      column (INT_MIN where it is cropped: outside the plane, or of
//      weight 0);
//   2. the column's slices build, a 32-output word each, the mask of the
//      outputs whose tap i0 or i1 is the column (one test an output and
//      column, for every channel of the block);
//   3. each thread walks its column's set bits in increasing order and adds
//      w * g[c, x] for its channels (at most one tap of an output lands on
//      a column with a weight: the two taps' columns differ unless one is
//      clamped, and a clamped tap has weight 0).
__global__ void __launch_bounds__(kOffMaxThreads)
    feat_bwd_source_kernel(const float* __restrict__ off,
                           const float* __restrict__ g,
                           float* __restrict__ dsrc, int C, int W,
                           size_t plane, int cps, int groups, float max_neg,
                           float max_pos, int back, int ahead) {
  __shared__ int tap0[kSrcStage], tap1[kSrcStage];
  __shared__ float wt0[kSrcStage], wt1[kSrcStage];
  __shared__ unsigned mask[kMaskWords][kSrcMaxPix];

  const int j = threadIdx.x;  // the column, relative to the block's first
  const int tid = threadIdx.y * blockDim.x + j;
  const int n_threads = blockDim.x * blockDim.y;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * blockDim.x;
  const size_t p = p0 + j;
  const bool active = p < plane;  // an idle thread still builds and meets barriers
  const int b = blockIdx.y / groups;
  const int c0 = ((blockIdx.y - b * groups) * blockDim.y + threadIdx.y) * cps;
  const int nc = max(0, min(cps, C - c0));
  const float* offb = off + static_cast<size_t>(b) * plane;
  const float* gp = g + (static_cast<size_t>(b) * C + c0) * plane;
  const int n_words = (back + ahead + kWarp) / kWarp;  // 32-output words a column

  float acc[kSrcMaxCps];
#pragma unroll
  for (int c = 0; c < kSrcMaxCps; ++c) acc[c] = 0.f;

  for (int w0 = 0; w0 < n_words; w0 += kMaskWords) {
    const int nw = min(kMaskWords, n_words - w0);
    // the plane index of record 0: column j's word k holds the outputs of
    // records [j + 32k, j + 32k + 32)
    const long long base = static_cast<long long>(p0) - ahead + kWarp * w0;
    const int n_stage = blockDim.x + kWarp * nw - 1;
    __syncthreads();  // the previous pass has been walked
    for (int r = tid; r < n_stage; r += n_threads) {
      const long long q = base + r;
      int t0 = INT_MIN, t1 = INT_MIN;
      float a0 = 0.f, a1 = 0.f;
      if (q >= 0 && q < static_cast<long long>(plane)) {
        const int x = column_of(static_cast<size_t>(q), plane, W);
        const Tap t = feature_tap(__ldg(offb + q), x, W, max_neg, max_pos);
        const int row = static_cast<int>(q - x - static_cast<long long>(p0));
        if (t.w0 != 0.f) t0 = row + t.i0;
        if (t.w1 != 0.f) t1 = row + t.i1;
        a0 = t.w0;
        a1 = t.w1;
      }
      tap0[r] = t0;
      tap1[r] = t1;
      wt0[r] = a0;
      wt1[r] = a1;
    }
    __syncthreads();
    for (int k = threadIdx.y; k < nw; k += blockDim.y) {
      unsigned bits = 0;
      const int r0 = j + kWarp * k;
#pragma unroll 8
      for (int i = 0; i < kWarp; ++i) {
        const bool hit = tap0[r0 + i] == j || tap1[r0 + i] == j;
        bits |= static_cast<unsigned>(hit) << i;
      }
      mask[k][j] = bits;
    }
    __syncthreads();
    if (!active || nc == 0) continue;
    for (int k = 0; k < nw; ++k) {
      for (unsigned bits = mask[k][j]; bits != 0; bits &= bits - 1) {
        const int r = j + kWarp * k + __ffs(bits) - 1;
        const float w = tap0[r] == j ? wt0[r] : wt1[r];
        const float* gx = gp + (base + r);
#pragma unroll
        for (int c = 0; c < kSrcMaxCps; ++c) {
          if (c < nc) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(gx + c * plane)));
        }
      }
    }
  }
  if (!active) return;
  float* dp = dsrc + (static_cast<size_t>(b) * C + c0) * plane + p;
#pragma unroll
  for (int c = 0; c < kSrcMaxCps; ++c) {
    if (c < nc) dp[c * plane] = acc[c];
  }
}

// Channel slices of a feature backward launch: as many as it takes to put
// kOffFillThreads threads on the card, at most one a channel and
// kOffMaxSlices. Returns the channels a slice would sum.
int slice_channels(long long pixels, int C) {
  long long want = pixels > 0 ? (kOffFillThreads + pixels - 1) / pixels : 1;
  want = want < kOffMaxSlices ? want : kOffMaxSlices;
  want = want < C ? want : C;
  const int slices = want > 1 ? static_cast<int>(want) : 1;
  return C > slices ? (C + slices - 1) / slices : 1;
}

// The offset gradient's launch: each slice a warp of consecutive pixels,
// and up to 4 warps of pixels a block where the slices are fewer than 4.
int launch_feat_bwd_offset(const float* src, const float* off, const float* g,
                           float* doff, int B, int C, int H, int W,
                           float max_neg, float max_pos, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const int cps = slice_channels(static_cast<long long>(B) * static_cast<long long>(plane), C);
  const int slices = C > cps ? (C + cps - 1) / cps : 1;  // none empty
  const int pix = kWarp * (slices < 4 ? 4 / slices : 1);
  const long long blocks = (static_cast<long long>(plane) + pix - 1) / pix;
  if (blocks > INT_MAX || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  feat_bwd_offset_kernel<<<dim3(static_cast<unsigned>(blocks), B), dim3(pix, slices), 0,
                           stream>>>(src, off, g, doff, C, W, plane, cps, max_neg, max_pos);
  return static_cast<int>(cudaGetLastError());
}

// The source gradient's launch: slices as the offset gradient's, with at
// most kSrcMaxCps channels a thread; channels beyond kOffMaxSlices such
// slices go to further groups on the grid's y axis (ceil(C / 128) a batch).
int launch_feat_bwd_source(const float* off, const float* g, float* dsrc, int B,
                           int C, int H, int W, float max_neg, float max_pos,
                           cudaStream_t stream) {
  // an output x samples columns [x - back, x + ahead]
  const int back = static_cast<int>(std::ceil(max_neg));
  const int ahead = static_cast<int>(std::floor(max_pos)) + 1;
  const size_t plane = static_cast<size_t>(H) * W;
  int cps = slice_channels(static_cast<long long>(B) * static_cast<long long>(plane), C);
  cps = cps < kSrcMaxCps ? cps : kSrcMaxCps;
  const int total = C > cps ? (C + cps - 1) / cps : 1;
  const int groups = (total + kOffMaxSlices - 1) / kOffMaxSlices;
  const int slices = (total + groups - 1) / groups;
  const int pix = kWarp * (slices < 4 ? 4 / slices : 1);
  const long long blocks = (static_cast<long long>(plane) + pix - 1) / pix;
  // a tap is kept as an int relative to the block's first column
  const long long reach = static_cast<long long>(back) + ahead + W + kSrcStage;
  if (blocks > INT_MAX || static_cast<long long>(B) * groups > 65535 || reach > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  feat_bwd_source_kernel<<<dim3(static_cast<unsigned>(blocks), B * groups), dim3(pix, slices),
                           0, stream>>>(off, g, dsrc, C, W, plane, cps, groups, max_neg,
                                        max_pos, back, ahead);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// img: [B, C, H, W] fp32 contiguous; disp: [B, 1, H, W]; out like img.
// Returns cudaGetLastError() after the launch (0 on success).
int warp_image_fwd(const float* img, const float* disp, float* out, int B,
                   int C, int H, int W, float max_disp, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  warp_fwd_kernel<<<grid, kThreads, 0, stream>>>(img, disp, out, C, H, W,
                                                 max_disp);
  return static_cast<int>(cudaGetLastError());
}

// feats: [B, C, H, W] fp32 contiguous; dx: [B, 1, H, W]; out like feats.
int warp_features_fwd(const float* feats, const float* dx, float* out, int B,
                      int C, int H, int W, float max_neg, float max_pos,
                      cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const long long pix_blocks = (plane + kFeatThreads - 1) / kFeatThreads;
  const long long groups =
      (static_cast<long long>(C) + kFeatChannels - 1) / kFeatChannels;
  if (pix_blocks * groups > INT_MAX || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(pix_blocks * groups), B);
  feat_gather_fwd_kernel<<<grid, kFeatThreads, 0, stream>>>(
      feats, dx, out, C, W, plane, static_cast<int>(pix_blocks), max_neg,
      max_pos);
  return static_cast<int>(cudaGetLastError());
}

// Backward of warp_image_fwd. g: gradient of the output, like img.
// dimg (like img) is written when need_dimg != 0, ddisp (like disp) when
// need_ddisp != 0; a pointer whose flag is 0 is not touched.
int warp_image_bwd(const float* img, const float* disp, const float* g,
                   float* dimg, float* ddisp, int B, int C, int H, int W,
                   float max_disp, int need_dimg, int need_ddisp,
                   cudaStream_t stream) {
  return launch_bwd<true>(img, disp, g, dimg, ddisp, B, C, H, W, 0.f, max_disp,
                          1, static_cast<int>(std::ceil(max_disp)), need_dimg,
                          need_ddisp, stream);
}

// Backward of warp_features_fwd, with the same conventions.
int warp_features_bwd(const float* feats, const float* dx, const float* g,
                      float* dfeats, float* ddx, int B, int C, int H, int W,
                      float max_neg, float max_pos, int need_dfeats,
                      int need_ddx, cudaStream_t stream) {
  if (need_ddx) {
    const int err = launch_feat_bwd_offset(feats, dx, g, ddx, B, C, H, W,
                                           max_neg, max_pos, stream);
    if (err != 0) return err;
  }
  if (need_dfeats) {
    return launch_feat_bwd_source(dx, g, dfeats, B, C, H, W, max_neg, max_pos,
                                  stream);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
