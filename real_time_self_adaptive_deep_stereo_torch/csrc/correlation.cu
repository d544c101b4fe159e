// 1-D stereo correlation cost volume, forward, for sm_90a.
//
// Replaces the Pallas TPU kernel `_corr_fwd_kernel`
// (real_time_self_adaptive_deep_stereo_tpu/ops/correlation.py), launched
// by `correlation_pallas` / `_corr_pallas_fwd_impl`. It computes, in NCHW,
//
//   out[b, k, h, w] = (1/C) * sum_c x[b, c, h, w] * y[b, c, h, w + k - R]
//
// for k = 0 .. 2R, with y read as zero outside [0, W-1].
//
// What bounds it: memory. Each output element costs 2C(2R+1) flops for
// (2C + 2R + 1) * 4 bytes of compulsory traffic, about one flop per byte
// at R = 2, far below the card's fp32 ridge point. The design reads x and
// y once from device memory: one thread per output pixel (b, h, w),
// consecutive threads on consecutive w, so every load of x and of the
// 2R+1 shifted y values is coalesced and the shifted reads of neighbouring
// threads hit the same cache lines. The 2R+1 partial sums stay in
// registers (R is a template parameter), the bounds check replaces the
// TPU kernel's zero-padded copy of y, and each output plane is written
// once, coalesced. At MADNet's coarse scales the calls hold too few
// pixels to approach the card's bandwidth (95 threads at scale 6): there
// the latency of the loads down the channel loop sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int R>
__global__ void corr_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, int C, int H, int W,
                                float inv_c) {
  constexpr int K = 2 * R + 1;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (w >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const float* xp = x + static_cast<size_t>(b) * C * plane + row;
  const float* yp = y + static_cast<size_t>(b) * C * plane + row;

  // The bounds check is made once per thread: every load in the channel
  // loop is unconditional (at a clamped column) and an out-of-range shift
  // keeps its sum unchanged, so the unrolled loop can put several
  // channels' loads in flight at once. At the coarse scales few threads
  // walk many channels, and load latency, not bandwidth, sets the time.
  float acc[K];
  int col[K];
  bool inside[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int wy = w + k - R;
    acc[k] = 0.f;
    inside[k] = wy >= 0 && wy < W;
    col[k] = min(max(wy, 0), W - 1);
  }

#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float xv = __ldg(xp + c * plane + w);
    const float* yr = yp + c * plane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float yv = __ldg(yr + col[k]);
      acc[k] = inside[k] ? fmaf(xv, yv, acc[k]) : acc[k];
    }
  }

  float* op = out + static_cast<size_t>(b) * K * plane + row + w;
#pragma unroll
  for (int k = 0; k < K; ++k) op[k * plane] = acc[k] * inv_c;
}

template <int R>
void launch(const float* x, const float* y, float* out, int B, int C, int H,
            int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  corr_fwd_kernel<R><<<grid, kThreads, 0, stream>>>(x, y, out, C, H, W,
                                                    1.0f / C);
}

}  // namespace

extern "C" {

// x, y: [B, C, H, W] fp32 contiguous; out: [B, 2*radius+1, H, W].
// Returns cudaGetLastError() after the launch (0 on success).
int corr_fwd(const float* x, const float* y, float* out, int B, int C, int H,
             int W, int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: launch<1>(x, y, out, B, C, H, W, stream); break;
    case 2: launch<2>(x, y, out, B, C, H, W, stream); break;
    case 3: launch<3>(x, y, out, B, C, H, W, stream); break;
    case 4: launch<4>(x, y, out, B, C, H, W, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
