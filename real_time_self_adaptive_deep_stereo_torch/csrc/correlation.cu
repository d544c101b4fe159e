// 1-D stereo correlation cost volume, forward and backward, for sm_90a.
//
// corr_fwd replaces the Pallas TPU kernel `_corr_fwd_kernel`
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
//
// corr_bwd is the backward of the same function. The JAX package has no
// TPU kernel for it: `_corr_pallas_bwd`, the backward of the
// `custom_vjp` around the Pallas kernel, is plain jnp. It computes
//
//   dx[b, c, h, w] = (1/C) * sum_k g[b, k, h, w]         * y[b, c, h, w + k - R]
//   dy[b, c, h, v] = (1/C) * sum_k g[b, k, h, v + R - k] * x[b, c, h, v + R - k]
//
// with every column outside [0, W-1] contributing zero. Both are gathers
// (dy reads the outputs whose shift k pointed at column v), so there are
// no atomics and two runs agree bit for bit. It is bound by memory: it
// reads x, y and g once and writes dx and dy, (4C + 2R + 1) * 4 bytes a
// pixel for 4C(2R+1) flops. One thread per element (b, c, h, w), with the
// pixels of a plane flattened so that the 19-column planes of the coarse
// scales still fill their warps; consecutive threads read consecutive
// addresses of x, y and g, and the 2R+1 shifted reads of neighbours share
// cache lines. Each product and sum is rounded on its own, in the plain
// version's order, so that the two agree to the last bit where no column
// is out of range and within a rounding elsewhere.

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
__global__ void corr_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ g,
                                float* __restrict__ dx, float* __restrict__ dy,
                                int C, int H, int W, float inv_c) {
  constexpr int K = 2 * R + 1;
  const int plane = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // pixel h * W + w
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (p >= plane) return;

  const int w = p % W;
  const int row = p - w;
  const size_t chan = (static_cast<size_t>(b) * C + c) * plane;
  const float* xr = x + chan + row;
  const float* yr = y + chan + row;
  const float* gr = g + static_cast<size_t>(b) * K * plane + row;

  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int wy = w + k - R;  // the y column that output w reads at shift k
    if (wy >= 0 && wy < W) {
      const float t = __fmul_rn(__ldg(gr + k * plane + w), __ldg(yr + wy));
      ax = __fadd_rn(ax, __fmul_rn(t, inv_c));
    }
    const int wx = w + R - k;  // the output whose shift k reads y column w
    if (wx >= 0 && wx < W) {
      const float t = __fmul_rn(__ldg(gr + k * plane + wx), __ldg(xr + wx));
      ay = __fadd_rn(ay, __fmul_rn(t, inv_c));
    }
  }
  dx[chan + p] = ax;
  dy[chan + p] = ay;
}

template <int R>
void launch_bwd(const float* x, const float* y, const float* g, float* dx,
                float* dy, int B, int C, int H, int W, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, C, B);
  corr_bwd_kernel<R><<<grid, kThreads, 0, stream>>>(x, y, g, dx, dy, C, H, W,
                                                    1.0f / C);
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

// x, y: [B, C, H, W] fp32 contiguous; g: [B, 2*radius+1, H, W], the gradient
// of corr_fwd's output; dx, dy like x. C may be at most 65535.
int corr_bwd(const float* x, const float* y, const float* g, float* dx,
             float* dy, int B, int C, int H, int W, int radius,
             cudaStream_t stream) {
  switch (radius) {
    case 1: launch_bwd<1>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 2: launch_bwd<2>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 3: launch_bwd<3>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 4: launch_bwd<4>(x, y, g, dx, dy, B, C, H, W, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
