// Horizontal disparity warps, forward, for sm_90a.
//
// warp_image_fwd replaces the Pallas TPU kernel `_img_fwd_kernel`
// (real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py), launched
// by `warp_image_pallas`: a clamp-to-edge warp of the right image at
// x - d, with d clipped to [0, max_disp] and bilinear weights taken from
// the unclamped coordinate.
//
// warp_features_fwd replaces `_feat_fwd_kernel` (same file), launched by
// `warp_features_pallas`: a warp of feature maps at x + dx, with dx
// clipped to [-max_neg, max_pos] and the weight of a corner outside
// [0, W-1] set to zero (`_feat_weights`).
//
// What bounds them: memory. Each output element is two loads, two
// multiplies and an add, so the time is the (2C + 1) * 4 bytes per pixel
// of compulsory traffic. The TPU kernels sweep every shift of a static
// window because a lane gather is slow there; a GPU thread gathers
// directly, so the window costs nothing here and the clip only sets the
// semantics. One thread per output pixel (b, h, x), consecutive threads on
// consecutive x: the disparity load and every output store are coalesced,
// and the two gathered source columns of neighbouring threads lie close
// together in the same row, so they share cache lines. The sampling
// weights and indices are computed once per pixel and reused across the
// C channels, whose loop is unrolled so that several channels' gathers
// are in flight at once: MADNet's feature warps hold few pixels and many
// channels, and there load latency, not bandwidth, sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// w0*a + w1*b with every product and sum rounded on its own, as the plain
// PyTorch version computes it: no contraction into an FMA, so the kernel
// and its plain version agree bit for bit.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__global__ void warp_image_fwd_kernel(const float* __restrict__ img,
                                      const float* __restrict__ disp,
                                      float* __restrict__ out, int C, int H,
                                      int W, float max_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float d =
      fminf(fmaxf(__ldg(disp + static_cast<size_t>(b) * plane + row + x), 0.f),
            max_disp);
  const float cx = static_cast<float>(x) - d;
  const float x0 = floorf(cx);
  const float w1 = cx - x0;
  const float w0 = 1.f - w1;
  const float last = static_cast<float>(W - 1);
  const int i0 = static_cast<int>(fminf(fmaxf(x0, 0.f), last));
  const int i1 = static_cast<int>(fminf(fmaxf(x0 + 1.f, 0.f), last));

  const float* src = img + static_cast<size_t>(b) * C * plane + row;
  float* dst = out + static_cast<size_t>(b) * C * plane + row + x;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = src + c * plane;
    dst[c * plane] = lerp2(w0, __ldg(r + i0), w1, __ldg(r + i1));
  }
}

__global__ void warp_features_fwd_kernel(const float* __restrict__ feats,
                                         const float* __restrict__ dx,
                                         float* __restrict__ out, int C, int H,
                                         int W, float max_neg, float max_pos) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float d =
      fminf(fmaxf(__ldg(dx + static_cast<size_t>(b) * plane + row + x), -max_neg),
            max_pos);
  const float cx = static_cast<float>(x) + d;
  const float x0 = floorf(cx);
  const float x1 = x0 + 1.f;
  const float last = static_cast<float>(W - 1);
  const float in0 = (x0 >= 0.f && x0 <= last) ? 1.f : 0.f;
  const float in1 = (x1 >= 0.f && x1 <= last) ? 1.f : 0.f;
  const float w0 = (x1 - cx) * in0;
  const float w1 = (cx - x0) * in1;
  const int i0 = static_cast<int>(fminf(fmaxf(x0, 0.f), last));
  const int i1 = static_cast<int>(fminf(fmaxf(x1, 0.f), last));

  const float* src = feats + static_cast<size_t>(b) * C * plane + row;
  float* dst = out + static_cast<size_t>(b) * C * plane + row + x;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* r = src + c * plane;
    dst[c * plane] = lerp2(w0, __ldg(r + i0), w1, __ldg(r + i1));
  }
}

}  // namespace

extern "C" {

// img: [B, C, H, W] fp32 contiguous; disp: [B, 1, H, W]; out like img.
// Returns cudaGetLastError() after the launch (0 on success).
int warp_image_fwd(const float* img, const float* disp, float* out, int B,
                   int C, int H, int W, float max_disp, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  warp_image_fwd_kernel<<<grid, kThreads, 0, stream>>>(img, disp, out, C, H, W,
                                                       max_disp);
  return static_cast<int>(cudaGetLastError());
}

// feats: [B, C, H, W] fp32 contiguous; dx: [B, 1, H, W]; out like feats.
int warp_features_fwd(const float* feats, const float* dx, float* out, int B,
                      int C, int H, int W, float max_neg, float max_pos,
                      cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  warp_features_fwd_kernel<<<grid, kThreads, 0, stream>>>(feats, dx, out, C, H,
                                                          W, max_neg, max_pos);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
