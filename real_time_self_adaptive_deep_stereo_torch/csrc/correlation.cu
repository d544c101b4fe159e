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
//
// Both are instantiated for radius 1-4 (R a template parameter, 2R+1 sums
// in registers). That does not scale to DispNet-Corr1D's radius of 40 (81
// shifts over C = 128 at 1/4 resolution), so two more kernels take any
// radius as a runtime argument:
//
// corr_fwd_wide computes what corr_fwd computes. A block owns one row
// (b, h) and a tile of 64 output columns, and, for a radius above 47, one
// chunk of 96 shifts. It walks the channels in chunks of 32, staging
// x[c, tile] and the y window [c, tile + k0 - R, tile + k0 - R + 159) in
// shared memory (28.5 KB, zeros outside [0, W-1]). Each of its 256 threads
// owns one column and every 4th shift of the chunk, 24 sums in registers
// (21 used at R = 40); a warp reads 32 consecutive words of the window per
// shift, free of bank conflicts. The channels are summed in one fixed
// order, c = 0 .. C-1, with fused multiply-adds, and each output plane is
// written once, coalesced along w. At R = 40 and C = 128 it does 2C(2R+1)
// flops a pixel for (2C + 2R + 1) * 4 bytes, 15 flops a byte, close to the
// card's fp32 ridge of 20: the bytes bound it, the operations nearly so.
//
// corr_bwd_wide computes what corr_bwd computes, as the same two gathers.
// A block owns one row and a tile of 64 columns and walks the channels in
// chunks of 32, and for each the shifts in chunks of 32 in increasing
// order. Per shift chunk it stages g[k, tile] / C (for dx), the diagonal
// g[k, v + R - k] / C for v in the tile (for dy), and the two windows of
// 95 columns of y and x that those shifts reach (40.7 KB of static shared
// memory at any radius). Each thread owns one column and 8 channels and
// keeps both gradients' 16 sums in registers across the shift chunks, so
// every output is the sum over k = 0 .. 2R in one fixed order: no
// atomics, and two runs agree bit for bit. Folding 1/C into the staged g
// and fusing the products into the sums rounds otherwise than the plain
// version, within a few ulps of each output's terms.
//
// Precision. Each kernel is a template on its element type T, float or
// __nv_bfloat16, and has an fp32 and a bf16 entry point. The JAX package
// calls the Pallas kernel on bf16 features under its `bf16_act` precision
// mode: `_corr_fwd_kernel` widens x and y to fp32, accumulates in fp32
// and stores in the input dtype. The bf16 instances do the same: every
// load widens with __bfloat162float (exact), every sum is kept in fp32,
// and the one store of each output rounds with __float2bfloat16_rn,
// round-to-nearest-even as JAX's `astype`. Their backward computes in
// fp32 from the bf16 values and rounds each gradient once, where the
// reference's plain-jnp backward computes in bf16 (ROADMAP.md, section 3).
// A product of two bf16 values is exact in fp32, so the bf16 instances
// round as the fp32 kernels round on the widened inputs. The wide kernels
// widen while they stage, so their shared memory holds fp32 as before.
// bf16 halves the bytes each kernel must move, not its fp32 operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// one element of T from device memory through the read-only path, as fp32
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// an fp32 value stored as T: rounded to nearest even for bf16
template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int R, typename T>
__global__ void corr_fwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ y,
                                T* __restrict__ out, int C, int H, int W,
                                float inv_c) {
  constexpr int K = 2 * R + 1;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (w >= W) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const T* xp = x + static_cast<size_t>(b) * C * plane + row;
  const T* yp = y + static_cast<size_t>(b) * C * plane + row;

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
    const float xv = load(xp + c * plane + w);
    const T* yr = yp + c * plane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float yv = load(yr + col[k]);
      acc[k] = inside[k] ? fmaf(xv, yv, acc[k]) : acc[k];
    }
  }

  T* op = out + static_cast<size_t>(b) * K * plane + row + w;
#pragma unroll
  for (int k = 0; k < K; ++k) op[k * plane] = store_as<T>(acc[k] * inv_c);
}

template <int R, typename T>
__global__ void corr_bwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ y,
                                const T* __restrict__ g,
                                T* __restrict__ dx, T* __restrict__ dy,
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
  const T* xr = x + chan + row;
  const T* yr = y + chan + row;
  const T* gr = g + static_cast<size_t>(b) * K * plane + row;

  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int wy = w + k - R;  // the y column that output w reads at shift k
    if (wy >= 0 && wy < W) {
      const float t = __fmul_rn(load(gr + k * plane + w), load(yr + wy));
      ax = __fadd_rn(ax, __fmul_rn(t, inv_c));
    }
    const int wx = w + R - k;  // the output whose shift k reads y column w
    if (wx >= 0 && wx < W) {
      const float t = __fmul_rn(load(gr + k * plane + wx), load(xr + wx));
      ay = __fadd_rn(ay, __fmul_rn(t, inv_c));
    }
  }
  dx[chan + p] = store_as<T>(ax);
  dy[chan + p] = store_as<T>(ay);
}

template <int R, typename T>
void launch_bwd(const T* x, const T* y, const T* g, T* dx, T* dy, int B, int C,
                int H, int W, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, C, B);
  corr_bwd_kernel<R, T><<<grid, kThreads, 0, stream>>>(x, y, g, dx, dy, C, H,
                                                       W, 1.0f / C);
}

template <int R, typename T>
void launch(const T* x, const T* y, T* out, int B, int C, int H, int W,
            cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  corr_fwd_kernel<R, T><<<grid, kThreads, 0, stream>>>(x, y, out, C, H, W,
                                                       1.0f / C);
}

// ---------------------------------------------------------- any radius
constexpr int kWideTile = 64;  // output columns a block
constexpr int kWideThreads = 256;
constexpr int kWideGroups = kWideThreads / kWideTile;  // threads per column
constexpr int kFwdShiftsPerThread = 24;
constexpr int kFwdShifts = kWideGroups * kFwdShiftsPerThread;  // 96 a block
constexpr int kFwdChannels = 32;  // channels staged at a time
constexpr int kFwdWindow = kWideTile + kFwdShifts - 1;  // y columns staged
constexpr int kBwdShifts = 32;    // shifts staged at a time
constexpr int kBwdChannels = 32;  // channels a block sums for at a time
constexpr int kBwdChannelsPerThread = kBwdChannels / kWideGroups;  // 8
constexpr int kBwdWindow = kWideTile + kBwdShifts - 1;  // x, y columns staged

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    corr_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         T* __restrict__ out, int C, int H, int W, int R,
                         int n_tiles, float inv_c) {
  __shared__ float xs[kFwdChannels][kWideTile];
  __shared__ float ys[kFwdChannels][kFwdWindow];
  const int K = 2 * R + 1;
  const int w0 = (blockIdx.x % n_tiles) * kWideTile;
  const int k0 = (blockIdx.x / n_tiles) * kFwdShifts;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % kWideTile;  // the thread's column
  const int grp = threadIdx.x / kWideTile;   // its shifts: grp + 4j
  const int n_shifts = min(kFwdShifts, K - k0);
  const int ystart = w0 + k0 - R;  // the column of ys[.][0]

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const T* xp = x + static_cast<size_t>(b) * C * plane + row;
  const T* yp = y + static_cast<size_t>(b) * C * plane + row;

  float acc[kFwdShiftsPerThread];
#pragma unroll
  for (int j = 0; j < kFwdShiftsPerThread; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kFwdChannels) {
    const int nc = min(kFwdChannels, C - c0);
    __syncthreads();  // the previous chunk is read
    for (int i = threadIdx.x; i < nc * kWideTile; i += kWideThreads) {
      const int c = i / kWideTile, j = i % kWideTile;
      const int col = w0 + j;
      xs[c][j] = col < W ? load(xp + (c0 + c) * plane + col) : 0.f;
    }
    for (int i = threadIdx.x; i < nc * kFwdWindow; i += kWideThreads) {
      const int c = i / kFwdWindow, j = i - c * kFwdWindow;
      const int col = ystart + j;
      ys[c][j] = (col >= 0 && col < W) ? load(yp + (c0 + c) * plane + col) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float xv = xs[c][lane];
#pragma unroll
      for (int j = 0; j < kFwdShiftsPerThread; ++j) {
        const int s = grp + kWideGroups * j;  // the same in a warp
        if (s < n_shifts) acc[j] = fmaf(xv, ys[c][lane + s], acc[j]);
      }
    }
  }

  const int w = w0 + lane;
  if (w >= W) return;
  T* op = out + (static_cast<size_t>(b) * K + k0) * plane + row + w;
#pragma unroll
  for (int j = 0; j < kFwdShiftsPerThread; ++j) {
    const int s = grp + kWideGroups * j;
    if (s < n_shifts) op[s * plane] = store_as<T>(acc[j] * inv_c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    corr_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ g, T* __restrict__ dx,
                         T* __restrict__ dy, int C, int H, int W, int R,
                         float inv_c) {
  __shared__ float gx[kBwdShifts][kWideTile];  // g[k][w] / C, w in the tile
  __shared__ float gy[kBwdShifts][kWideTile];  // g[k][v + R - k] / C
  __shared__ float ys[kBwdChannels][kBwdWindow];
  __shared__ float xs[kBwdChannels][kBwdWindow];
  const int K = 2 * R + 1;
  const int w0 = blockIdx.x * kWideTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % kWideTile;  // the thread's column
  const int grp = threadIdx.x / kWideTile;   // its channels: grp + 4i

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const size_t batch = static_cast<size_t>(b) * C * plane + row;
  const T* gp = g + static_cast<size_t>(b) * K * plane + row;

  for (int c0 = 0; c0 < C; c0 += kBwdChannels) {
    const int nc = min(kBwdChannels, C - c0);
    const T* xp = x + batch + c0 * plane;
    const T* yp = y + batch + c0 * plane;
    float ax[kBwdChannelsPerThread], ay[kBwdChannelsPerThread];
#pragma unroll
    for (int i = 0; i < kBwdChannelsPerThread; ++i) ax[i] = ay[i] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBwdShifts) {
      const int ns = min(kBwdShifts, K - k0);
      // ys[c][j] = y[c][w0 + k0 - R + j]: dx at column w0 + l, shift
      // k0 + kk reads ys[c][l + kk]. xs[c][j] = x[c][xstart + j]: dy at
      // column w0 + l, shift k0 + kk reads xs[c][l - kk + kBwdShifts - 1].
      const int ystart = w0 + k0 - R;
      const int xstart = w0 + R - k0 - (kBwdShifts - 1);
      __syncthreads();  // the previous chunk is read
      for (int i = threadIdx.x; i < ns * kWideTile; i += kWideThreads) {
        const int kk = i / kWideTile, j = i % kWideTile;
        const int k = k0 + kk;
        const T* gr = gp + k * plane;
        const int cx = w0 + j, cy = w0 + j + R - k;
        gx[kk][j] = cx < W ? load(gr + cx) * inv_c : 0.f;
        gy[kk][j] = (cy >= 0 && cy < W) ? load(gr + cy) * inv_c : 0.f;
      }
      for (int i = threadIdx.x; i < nc * kBwdWindow; i += kWideThreads) {
        const int c = i / kBwdWindow, j = i - c * kBwdWindow;
        const int cy = ystart + j, cx = xstart + j;
        ys[c][j] = (cy >= 0 && cy < W) ? load(yp + c * plane + cy) : 0.f;
        xs[c][j] = (cx >= 0 && cx < W) ? load(xp + c * plane + cx) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < ns; ++kk) {
        const float g1 = gx[kk][lane];
        const float g2 = gy[kk][lane];
#pragma unroll
        for (int i = 0; i < kBwdChannelsPerThread; ++i) {
          const int c = grp + kWideGroups * i;  // the same in a warp
          ax[i] = fmaf(g1, ys[c][lane + kk], ax[i]);
          ay[i] = fmaf(g2, xs[c][lane - kk + kBwdShifts - 1], ay[i]);
        }
      }
    }

    const int w = w0 + lane;
    if (w < W) {
#pragma unroll
      for (int i = 0; i < kBwdChannelsPerThread; ++i) {
        const int c = grp + kWideGroups * i;
        if (c < nc) {
          const size_t at = batch + (c0 + c) * plane + w;
          dx[at] = store_as<T>(ax[i]);
          dy[at] = store_as<T>(ay[i]);
        }
      }
    }
  }
}

// ------------------------------------------------------- entry points
template <typename T>
int corr_fwd_impl(const T* x, const T* y, T* out, int B, int C, int H, int W,
                  int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: launch<1, T>(x, y, out, B, C, H, W, stream); break;
    case 2: launch<2, T>(x, y, out, B, C, H, W, stream); break;
    case 3: launch<3, T>(x, y, out, B, C, H, W, stream); break;
    case 4: launch<4, T>(x, y, out, B, C, H, W, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr_bwd_impl(const T* x, const T* y, const T* g, T* dx, T* dy, int B,
                  int C, int H, int W, int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: launch_bwd<1, T>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 2: launch_bwd<2, T>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 3: launch_bwd<3, T>(x, y, g, dx, dy, B, C, H, W, stream); break;
    case 4: launch_bwd<4, T>(x, y, g, dx, dy, B, C, H, W, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr_fwd_wide_impl(const T* x, const T* y, T* out, int B, int C, int H,
                       int W, int radius, cudaStream_t stream) {
  if (radius < 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (W + kWideTile - 1) / kWideTile;
  const int n_chunks = (2 * radius + 1 + kFwdShifts - 1) / kFwdShifts;
  const dim3 grid(n_tiles * n_chunks, H, B);
  corr_fwd_wide_kernel<T><<<grid, kWideThreads, 0, stream>>>(
      x, y, out, C, H, W, radius, n_tiles, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr_bwd_wide_impl(const T* x, const T* y, const T* g, T* dx, T* dy,
                       int B, int C, int H, int W, int radius,
                       cudaStream_t stream) {
  if (radius < 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kWideTile - 1) / kWideTile, H, B);
  corr_bwd_wide_kernel<T><<<grid, kWideThreads, 0, stream>>>(
      x, y, g, dx, dy, C, H, W, radius, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [B, C, H, W] fp32 contiguous; out: [B, 2*radius+1, H, W].
// Returns cudaGetLastError() after the launch (0 on success).
int corr_fwd(const float* x, const float* y, float* out, int B, int C, int H,
             int W, int radius, cudaStream_t stream) {
  return corr_fwd_impl(x, y, out, B, C, H, W, radius, stream);
}

// x, y: [B, C, H, W] fp32 contiguous; g: [B, 2*radius+1, H, W], the gradient
// of corr_fwd's output; dx, dy like x. C may be at most 65535.
int corr_bwd(const float* x, const float* y, const float* g, float* dx,
             float* dy, int B, int C, int H, int W, int radius,
             cudaStream_t stream) {
  return corr_bwd_impl(x, y, g, dx, dy, B, C, H, W, radius, stream);
}

// Any radius >= 0; same arguments as corr_fwd. B and H may be at most 65535.
int corr_fwd_wide(const float* x, const float* y, float* out, int B, int C,
                  int H, int W, int radius, cudaStream_t stream) {
  return corr_fwd_wide_impl(x, y, out, B, C, H, W, radius, stream);
}

// Any radius >= 0; same arguments as corr_bwd. B and H may be at most 65535.
int corr_bwd_wide(const float* x, const float* y, const float* g, float* dx,
                  float* dy, int B, int C, int H, int W, int radius,
                  cudaStream_t stream) {
  return corr_bwd_wide_impl(x, y, g, dx, dy, B, C, H, W, radius, stream);
}

// The bf16 instances of the four: the same arguments with every tensor
// bf16 (outputs too); fp32 sums, one rounding per output.
int corr_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                  __nv_bfloat16* out, int B, int C, int H, int W, int radius,
                  cudaStream_t stream) {
  return corr_fwd_impl(x, y, out, B, C, H, W, radius, stream);
}

int corr_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                  const __nv_bfloat16* g, __nv_bfloat16* dx,
                  __nv_bfloat16* dy, int B, int C, int H, int W, int radius,
                  cudaStream_t stream) {
  return corr_bwd_impl(x, y, g, dx, dy, B, C, H, W, radius, stream);
}

int corr_fwd_wide_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                       __nv_bfloat16* out, int B, int C, int H, int W,
                       int radius, cudaStream_t stream) {
  return corr_fwd_wide_impl(x, y, out, B, C, H, W, radius, stream);
}

int corr_bwd_wide_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                       const __nv_bfloat16* g, __nv_bfloat16* dx,
                       __nv_bfloat16* dy, int B, int C, int H, int W,
                       int radius, cudaStream_t stream) {
  return corr_bwd_wide_impl(x, y, g, dx, dy, B, C, H, W, radius, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
