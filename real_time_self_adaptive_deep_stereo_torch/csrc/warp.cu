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
// The image warp's (`warp_bwd_offset_kernel`, `warp_bwd_source_kernel`,
// [3, 320, 1216] and max_disp 192 on the main path):
//
// * the offset gradient: the thread of output pixel x sums g * v0 and
//   g * v1 over the channels at its two taps, and the result is zeroed
//   where the unclipped offset lies outside its window (inclusive bounds,
//   as `torch.clamp` and the TPU kernel have it);
// * the source gradient, the transpose of the sampling. An output x
//   samples floor(x - d) and the column after it with 0 <= d <= S, so
//   column v is reached only from the outputs [v - 1, v + ceil(S)] of its
//   row: 194 of them at S = 192. A form with one thread a column that
//   walked those outputs recomputed every output's tap 194 times (75 M
//   taps a call; 0.126 ms with both gradients on an NVIDIA H100 80GB HBM3
//   at 700 W, 2.4 times the PyTorch op). Here a block owns 128 columns
//   of one row and a chunk of kChunk channels. Per pass of kImgPass
//   outputs it computes the taps of the outputs that can reach its
//   columns once, into static shared memory, with their g (a tap pair, a
//   weight pair and the chunk's g as one int2, float2 and float4, read
//   together by a hit); a warp then takes each word of 32 outputs and, with
//   `__match_any_sync` over the taps' columns, writes for every column the
//   word's bit mask of the outputs whose tap lands on it (one lane per
//   column, no atomics). Each thread loads its column's mask words
//   together, walks their bits in increasing x and adds w * g for its
//   channels, tap 0 before tap 1, in the order of the walk before it:
//   every column but 0 keeps its bits.
//   The image warp clamps to the edge, so every output that samples left
//   of the row puts both taps on column 0 with their weights: up to 2 *
//   193 terms, in series in one thread. Column 0's outputs are cut into 32
//   contiguous segments, a lane of the first warp each; each lane sums its
//   segment in increasing x, and the segments' sums meet in a fixed
//   shuffle tree. Taps of weight 0 are cropped (adding 0 * g leaves a sum's
//   bits as they are). Every dimg value has one order of sum, so two runs
//   agree bit for bit.
//
// The feature warp's run on MADNet's short, deep rows, where a thread a
// column walking a chunk of channels left most lanes idle and chained a
// load per channel (380 threads walking 128 channels each at scale 5),
// and asked C / 4 times the channel-independent question of which outputs
// reach a column. They take the forms of csrc/warp_tile.cu's tiled
// backward, with K5's own tap
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
// No kernel here uses dynamic shared memory (the feature offset gradient
// keeps 4 KB of partial sums, its source gradient 10 KB of tap records
// and masks, the image source gradient 18 KB of taps, g and masks),
// so no launch sets a function attribute (a launch may be under stream
// capture).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

// image warps: threads a block, and columns of a source-gradient block
constexpr int kThreads = 128;
constexpr int kChunk = 4;  // channels of an image source-gradient block, a float4 of g
static_assert(kChunk == 4, "a float4 holds the g of a chunk");
constexpr int kImgWords = 12;  // 32-output words of an image source-gradient pass
// outputs of a pass: 128 columns' 321 at max_disp 192 fit in one
constexpr int kImgPass = kImgWords * 32;
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

// Gradient of the image offset: one thread per output pixel (b, h, x).
__global__ void warp_bwd_offset_kernel(const float* __restrict__ src,
                                       const float* __restrict__ off,
                                       const float* __restrict__ g,
                                       float* __restrict__ doff, int C, int H,
                                       int W, float max_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const size_t pix = static_cast<size_t>(b) * plane + row + x;
  const float raw = __ldg(off + pix);
  const Tap t = image_tap(raw, x, W, max_disp);

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
  // d out / d disp = v0 - v1 (the sample moves left as disp grows)
  doff[pix] = (raw >= 0.f && raw <= max_disp) ? __fsub_rn(s0, s1) : 0.f;
}

// The bits of word k of a pass (outputs [32k, 32k + 32)) that lie in the
// outputs [lo, hi) of the pass.
__device__ __forceinline__ unsigned span_bits(int k, int lo, int hi) {
  const int a = max(lo - 32 * k, 0), z = min(hi - 32 * k, 32);
  if (z <= a) return 0u;
  return (z == 32 ? ~0u : (1u << z) - 1u) & ~((1u << a) - 1u);
}

// Adds, for the set bits of `bits` (outputs 32k + i of the pass, in
// increasing order), w * g of each tap that lands on column j, tap 0
// before tap 1.
__device__ __forceinline__ void walk_word(unsigned bits, int k, int j, const int2* taps,
                                          const float2* wts, const float4* gs,
                                          float (&acc)[kChunk]) {
  for (; bits != 0u; bits &= bits - 1u) {
    const int r = 32 * k + __ffs(bits) - 1;
    const int2 t = taps[r];
    const float2 w = wts[r];
    const float4 g4 = gs[r];
    const float gv[kChunk] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t.x == j) acc[c] = __fadd_rn(acc[c], __fmul_rn(w.x, gv[c]));
      if (t.y == j) acc[c] = __fadd_rn(acc[c], __fmul_rn(w.y, gv[c]));
    }
  }
}

// Gradient of the image: a block per (tile of kThreads columns, row,
// batch * chunk of kChunk channels), a thread per column. The outputs
// that can reach the tile, [x_first, x_last], are taken in passes of
// kImgPass:
//   1. the block computes their taps once, as columns relative to the
//      tile (-1 where a tap lands outside it or has weight 0), with their
//      weights and g for the chunk's channels;
//   2. the warp of word k writes mask[k][j], the bits of the word's
//      outputs with a tap on column j: `__match_any_sync` groups the lanes
//      by tap column, and the lowest lane of each group writes its group
//      (tap 0's groups first, then tap 1's OR-ed in);
//   3. each thread walks its column's words [v - 1, v + ahead] in
//      increasing x; column 0's outputs [0, ahead] are walked by the first
//      warp of the first tile in 32 segments, whose sums meet in a shuffle
//      tree, once a pass.
__global__ void __launch_bounds__(kThreads)
    warp_bwd_source_kernel(const float* __restrict__ off,
                           const float* __restrict__ g,
                           float* __restrict__ dsrc, int C, int H, int W,
                           float max_disp, int ahead, int n_chunks) {
  __shared__ int2 taps[kImgPass];
  __shared__ float2 wts[kImgPass];
  __shared__ float4 gs[kImgPass];  // g of the chunk's kChunk channels
  __shared__ unsigned mask[kImgWords][kThreads];

  const int j = threadIdx.x;  // the column, relative to the tile
  const int lane = j % kWarp, warp = j / kWarp;
  const int v0 = blockIdx.x * kThreads;
  const int v = v0 + j;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * kChunk;
  const int last_c = C - c0 - 1;  // the chunk's last channel, relative

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float* offr = off + static_cast<size_t>(b) * plane + row;
  const float* gr = g + (static_cast<size_t>(b) * C + c0) * plane + row;

  // the outputs that reach the tile, and this column's
  const int x_first = max(v0 - 1, 0);
  const int x_last = min(v0 + kThreads - 1 + ahead, W - 1);
  const int n_out = x_last - x_first + 1;
  const int my_lo = max(v - 1, 0) - x_first;
  const int my_hi = min(v + ahead, W - 1) - x_first;  // inclusive
  const bool pile = v0 == 0;  // the tile of column 0, the same in a block

  float acc[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;

  for (int p0 = 0; p0 < n_out; p0 += kImgPass) {
    __syncthreads();  // the previous pass has been walked
#pragma unroll
    for (int m = 0; m < kImgPass / kThreads; ++m) {
      const int r = j + m * kThreads;
      const bool in = p0 + r < n_out;
      const int x = min(x_first + p0 + r, W - 1);  // every load made
      const Tap t = image_tap(__ldg(offr + x), x, W, max_disp);
      const int a0 = t.i0 - v0, a1 = t.i1 - v0;
      taps[r] = make_int2((in && t.w0 != 0.f && a0 >= 0 && a0 < kThreads) ? a0 : -1,
                          (in && t.w1 != 0.f && a1 >= 0 && a1 < kThreads) ? a1 : -1);
      wts[r] = make_float2(t.w0, t.w1);
      float gv[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) gv[c] = __ldg(gr + min(c, last_c) * plane + x);
      gs[r] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
    __syncthreads();
    // the words that hold outputs of this pass; no walk reads another
    const int n_words = min(kImgWords, (n_out - p0 + kWarp - 1) / kWarp);
    for (int k = warp; k < n_words; k += kThreads / kWarp) {
#pragma unroll
      for (int q = lane; q < kThreads; q += kWarp) mask[k][q] = 0u;
      __syncwarp();
      const int2 a = taps[32 * k + lane];
      const int a0 = a.x, a1 = a.y;
      const unsigned m0 = __match_any_sync(0xffffffffu, a0);
      if (a0 >= 0 && lane == __ffs(m0) - 1) mask[k][a0] = m0;
      __syncwarp();
      const unsigned m1 = __match_any_sync(0xffffffffu, a1);
      if (a1 >= 0 && lane == __ffs(m1) - 1) mask[k][a1] |= m1;
    }
    __syncthreads();

    if (v < W && !(pile && j == 0)) {
      // the column's words, loaded together before the walk
      const int lo = max(my_lo - p0, 0), hi = min(my_hi - p0, kImgPass - 1);
      const int k_lo = lo / 32, k_hi = lo <= hi ? hi / 32 : -1;
      unsigned words[kImgWords];
#pragma unroll
      for (int k = 0; k < kImgWords; ++k) words[k] = (k >= k_lo && k <= k_hi) ? mask[k][j] : 0u;
#pragma unroll
      for (int k = 0; k < kImgWords; ++k) walk_word(words[k], k, j, taps, wts, gs, acc);
    }
    if (pile && warp == 0) {  // column 0: lane i sums segment i
      const int lo = max(-p0, 0), end = min(min(ahead, W - 1) - p0 + 1, kImgPass);
      const int seg = (max(end - lo, 0) + kWarp - 1) / kWarp;
      const int s_lo = lo + lane * seg, s_hi = min(s_lo + seg, end);
      float part[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) part[c] = 0.f;
      for (int k = s_lo / 32; s_lo < s_hi && k <= (s_hi - 1) / 32; ++k)
        walk_word(mask[k][0] & span_bits(k, s_lo, s_hi), k, 0, taps, wts, gs, part);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        for (int o = kWarp / 2; o > 0; o /= 2)
          part[c] = __fadd_rn(part[c], __shfl_down_sync(0xffffffffu, part[c], o));
        if (lane == 0) acc[c] = __fadd_rn(acc[c], part[c]);
      }
    }
  }

  if (v >= W) return;
  float* dst = dsrc + (static_cast<size_t>(b) * C + c0) * plane + row + v;
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    if (c <= last_c) dst[c * plane] = acc[c];
  }
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
// need_ddisp != 0; a pointer whose flag is 0 is not touched. max_disp
// must be >= 0.
int warp_image_bwd(const float* img, const float* disp, const float* g,
                   float* dimg, float* ddisp, int B, int C, int H, int W,
                   float max_disp, int need_dimg, int need_ddisp,
                   cudaStream_t stream) {
  if (!(max_disp >= 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (W + kThreads - 1) / kThreads;
  if (need_ddisp) {
    warp_bwd_offset_kernel<<<dim3(tiles, H, B), kThreads, 0, stream>>>(
        img, disp, g, ddisp, C, H, W, max_disp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dimg) {
    // an output samples at most ceil(max_disp) columns left of itself,
    // and no row holds more than W
    const double reach = std::ceil(static_cast<double>(max_disp));
    const int ahead = static_cast<int>(std::fmin(reach, static_cast<double>(W)));
    const int n_chunks = (C + kChunk - 1) / kChunk;
    warp_bwd_source_kernel<<<dim3(tiles, H, B * n_chunks), kThreads, 0, stream>>>(
        disp, g, dimg, C, H, W, max_disp, ahead, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
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
