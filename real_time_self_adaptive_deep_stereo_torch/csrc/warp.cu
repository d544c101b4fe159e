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
// What bounds them: memory. Each output element is two loads, two
// multiplies and an add, so the time is the (2C + 1) * 4 bytes per pixel
// of compulsory traffic (forward; the backward reads the incoming
// gradient too and writes both gradients). The TPU kernels sweep every
// shift of a static window because a lane gather is slow there; a GPU
// thread gathers directly, so in the forward the window costs nothing
// and the clip only sets the semantics. One thread per output pixel
// (b, h, x), consecutive threads on consecutive x: the offset load and
// every output store are coalesced, and the two gathered source columns
// of neighbouring threads lie close together in the same row, so they
// share cache lines. The sampling weights and indices are computed once
// per pixel (`image_tap`, `feature_tap`, shared by forward and backward
// so that they cannot disagree) and reused across the C channels, whose
// loop is unrolled so that several channels' gathers are in flight at
// once: MADNet's feature warps hold few pixels and many channels, and
// there load latency, not bandwidth, sets the time.
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

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 4;  // channels per thread in the source gradient

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

template <bool kImage>
__global__ void warp_fwd_kernel(const float* __restrict__ src,
                                const float* __restrict__ off,
                                float* __restrict__ out, int C, int H, int W,
                                float lo, float hi) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const Tap t = tap_of<kImage>(
      __ldg(off + static_cast<size_t>(b) * plane + row + x), x, W, lo, hi);

  const float* s = src + static_cast<size_t>(b) * C * plane + row;
  float* dst = out + static_cast<size_t>(b) * C * plane + row + x;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = s + c * plane;
    dst[c * plane] = lerp2(t.w0, __ldg(r + t.i0), t.w1, __ldg(r + t.i1));
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
  warp_fwd_kernel<true><<<grid, kThreads, 0, stream>>>(img, disp, out, C, H, W,
                                                       0.f, max_disp);
  return static_cast<int>(cudaGetLastError());
}

// feats: [B, C, H, W] fp32 contiguous; dx: [B, 1, H, W]; out like feats.
int warp_features_fwd(const float* feats, const float* dx, float* out, int B,
                      int C, int H, int W, float max_neg, float max_pos,
                      cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  warp_fwd_kernel<false><<<grid, kThreads, 0, stream>>>(feats, dx, out, C, H,
                                                        W, max_neg, max_pos);
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
