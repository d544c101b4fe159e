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
// its gradient is not asked for:
//
// * the offset gradient is a gather like the forward: the thread of
//   output pixel x sums g * v0 and g * v1 over the channels at its two
//   taps, and the result is zeroed where the unclipped offset lies
//   outside its window (inclusive bounds, as `torch.clamp` and the TPU
//   kernel have it);
// * the source gradient is the transpose of the sampling. The TPU kernel
//   scatters with the inverse lane rotation; a scatter on the card would
//   need float atomics, whose order changes from run to run, and the
//   adaptation's trajectory depends on the summation order. So it is a
//   gather too: the thread of source column v walks the outputs x that
//   can sample v, in increasing x, recomputes their taps and adds w * g
//   where a tap's clamped index equals v. The clipped offset bounds that
//   walk: an image output x samples floor(x - d) and the column after it
//   with 0 <= d <= S, so column v is reached only from x in [v - 1, v + S];
//   a feature output samples floor(x + d) and the next with -N <= d <= P,
//   so v is reached from x in [v - P - 1, v + N]. Clamped indices make
//   the image warp's fold into column 0 (everything sampled left of the
//   image) fall out of the same test, and column 0's walk [0, S] covers
//   it. Every run adds in the same order, so two runs agree bit for bit.
//   A thread keeps kChunk channels' sums so that one walk serves them.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 4;  // channels per thread in the source gradient
constexpr int kFeatChannels = 4;  // channels per thread, feature forward
constexpr int kFeatThreads = 128;  // threads per block, feature forward

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
  return launch_bwd<false>(feats, dx, g, dfeats, ddx, B, C, H, W, max_neg,
                           max_pos, static_cast<int>(std::ceil(max_pos)) + 1,
                           static_cast<int>(std::ceil(max_neg)), need_dfeats,
                           need_ddx, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
