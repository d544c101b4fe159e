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
// at R = 2, far below the card's fp32 ridge point. At MADNet's shapes the
// bytes are few (3.5 us over the five calls), and what set the time of a
// form with one thread per output pixel was the latency of its loads down
// the channel loop: at scale 6, [1,192,5,19], 95 threads each walked 192
// channels (0.033 ms of the five calls' 0.090 on the H100). So a thread
// owns one pixel of the flattened H*W plane and one slice of channels, as
// the tiled warp's offset gradient does (csrc/warp_tile.cu): consecutive
// threads on consecutive pixels across row ends, so that the loads of x
// and of the 2R+1 shifted y values stay coalesced on rows of 19 floats and
// the shifted reads of neighbouring threads share cache lines. The host
// cuts the channels into as many slices (threadIdx.y, at most 32, none
// empty) as it takes to put some 1,024 threads on each SM: scale 6 takes
// 32 slices of 6 channels, scale 2 ([1,32,80,304]) 6 of 6. Each thread
// keeps its 2R+1 partial sums in registers (R is a template parameter) and
// checks the bounds once (y is read as zero outside [0, W-1], the TPU
// kernel's zero-padded copy of y); the slices' sums meet in static shared
// memory, where the thread of slice k adds shift k's in slice order and
// makes the output's one store. The order of every sum is fixed, so two
// runs agree bit for bit.
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
// pixel for 6C(2R+1) flops. A thread owns one pixel of the flattened H*W
// plane and one slice of channels, consecutive threads on consecutive
// pixels across row ends, as in corr_fwd. It loads the 2(2R+1) values of g
// that its pixel's outputs read, g[k, w] and g[k, w + R - k], once into
// registers with their bounds, then walks its channels, loading 2R+1
// values of y and of x each (coalesced along the row, the shifted reads of
// neighbours sharing cache lines), and stores that channel's dx and dy.
// The outputs are per channel, so the slices never meet: no shared
// memory, no barrier, and the slices go on the grid, as many as it takes
// to put some 2,048 threads on each SM, at most one a channel. At MADNet's
// five shapes the bytes are few (6.8 us in all, 3.9 at scale 2) and launch
// and latency set the time: spread over the grid, the coarse scales keep
// one channel a thread (scale 6: 18,240 threads in 192 blocks), where
// corr_fwd's block of 32 slices of 6 channels would put scale 6 on 3 SMs;
// scale 2 takes 11 slices of 3 channels. Each term is rounded as the plain
// version rounds it, (g * y) then * (1/C), and added in increasing k, as
// the form with one thread per (pixel, channel) before it did: the two
// agree bit for bit, and agree with the plain version to the last bit
// where no column is out of range and within a rounding elsewhere.
//
// Both are instantiated for radius 1-4 (R a template parameter, 2R+1 sums
// in registers). That does not scale to DispNet-Corr1D's radius of 40 (81
// shifts over C = 128 at 1/4 resolution), so two more kernels take any
// radius as a runtime argument:
//
// corr_fwd_wide computes what corr_fwd computes, at any radius. At
// DispNet's call, [1,128,80,304] at radius 40, it does 2C(2R+1) flops a
// pixel for (2C + 2R + 1) * 4 bytes, 15 flops a byte, close to the card's
// fp32 ridge of 20: the bytes bound it (0.0098 ms on an NVIDIA H100 80GB
// HBM3 at 700 W), the operations nearly so. A form with one thread a
// column and every 4th of 96 shifts made one 4-byte shared-memory load per
// multiply-add (0.0825 ms there). It now takes the form of corr_bwd_wide:
// a block owns one row (b, h), a tile of 64 columns and a chunk of 84
// shifts (81 at radius 40), in 128 threads, 112 of which sum: thread (t,
// r) owns the 4 adjacent columns w0 + 4t .. + 3 and the 12 consecutive
// shifts k0 + 12r .. + 11, 48 sums in registers. The block walks the
// channels in chunks of 32, staging x[c, tile] and the y window [c, w0 +
// k0 - R, + 148) in static shared memory (27 KB, zeros outside [0, W-1];
// unconditional, unrolled loads). For each channel a thread loads its 4 x values as one float4
// and slides a float4 window of y over its shifts, so each staged y value
// feeds 4 multiply-adds: 5 loads of 16 bytes make 48 multiply-adds where
// the form before made 48 loads of 4. Staging and the sums take turns
// between the block's barriers, and the sums set the time: two buffers
// (the next chunk's loads in flight while a chunk is summed), lanes that
// share their window loads, other tiles and unrolling did not beat this
// form on the card (PERF.md, section 6). Each output is the same chain of
// fmaf over c = 0 .. C-1, in increasing c, of the same staged operands
// (zeros outside the row), then one multiply by 1/C, as the form before:
// the two agree bit for bit. At R = 40 the 84 shifts leave 3 idle, the
// last tile of a 304-column row 16 columns.
//
// corr_bwd_wide computes what corr_bwd computes, as the same two gathers,
// at any radius. dx and dy share nothing but g, so a block computes one of
// them (dx from y, or dy from x) for one row (b, h), a tile of 64 columns
// and a chunk of 64 channels: 2 * 5 * 2 * 80 = 1,600 blocks of 128 threads
// at DispNet's [1,128,80,304], radius 40. A thread owns 4 adjacent
// columns and 8 channels, 32 sums in registers. The block walks the
// shifts in chunks of 48 in increasing order, staging per chunk g / C for
// its 64 columns (g[k, w] for dx, the diagonal g[k, v + R - k] for dy) and
// the 112-column window of y or x that those shifts reach, for its 64
// channels (40 KB of static shared memory, zeros outside [0, W-1]). It
// does 2C(2R+1) multiply-adds a pixel for (4C + 2R + 1) * 4 bytes, 17
// flops a byte at C = 128, near the card's fp32 ridge of 20. What sets
// its time is the chip's own traffic: the shared-memory loads that feed
// the multiply-adds, and the staging, which reads 131 MB from L2 at
// DispNet's call (each window 1.75 times its 64 columns, g once a channel
// chunk). A form with one column a thread made 18 scalar shared-memory
// loads for 16 multiply-adds; here a thread takes 4 shifts at a time and,
// for each of its channels, loads the 4 window values the next shifts
// bring in as one float4 and slides the 8 it holds (for dx the window
// moves right as k grows, for dy left): with a float4 of g for each shift,
// 12 loads of 16 bytes make 128 multiply-adds. A thread stages a fixed
// count of elements, its loads unconditional and unrolled so that a batch
// is in flight at once. Staging and the multiply-adds take turns between
// the block's barriers and do not overlap. Each output is the same chain
// of fmaf over k = 0 .. 2R, in increasing k, of the same staged operands
// (g * 1/C rounded as staged, zeros outside the row) as the form before:
// the two agree bit for bit, no atomics, and two runs agree. Folding 1/C
// into the staged g and fusing the products into the sums rounds otherwise
// than the plain version, within a few ulps of each output's terms.
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

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kFwdMaxThreads = 1024;  // threads of a corr_fwd block, at most
constexpr int kFwdMaxSlices = kFwdMaxThreads / kWarp;  // channel slices a pixel, at most
// threads a corr_fwd launch aims for: 1,024 on each of the H100's 132 SMs,
// where the channels allow
constexpr long long kFwdFill = 132LL * 1024;

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

// One thread per (pixel of the H*W plane, slice of channels): blockDim =
// (pixels, slices), blockIdx.x the block of pixels, blockIdx.y the batch;
// slice y sums channels [y * cps, (y + 1) * cps). The slices' K partial
// sums meet in static shared memory, and thread (x, y) adds those of
// shifts y, y + slices, ... in slice order and stores them.
template <int R, typename T>
__global__ void __launch_bounds__(kFwdMaxThreads)
    corr_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    T* __restrict__ out, int C, int W, size_t plane, int cps,
                    float inv_c) {
  constexpr int K = 2 * R + 1;
  __shared__ float part[K][kFwdMaxThreads];
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = p < plane;  // an idle thread still meets the barrier
  const int b = blockIdx.y;
  const int w = !active            ? 0
                : plane <= UINT_MAX ? static_cast<int>(static_cast<unsigned>(p) %
                                                       static_cast<unsigned>(W))
                                    : static_cast<int>(p % W);

  // The bounds check is made once per thread: every load in the channel
  // loop is unconditional (at a clamped column) and an out-of-range shift
  // keeps its sum unchanged, so the unrolled loop can put several
  // channels' loads in flight at once.
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

  const int c0 = threadIdx.y * cps;
  const int c1 = min(C, c0 + cps);
  if (active) {
    const size_t first = (static_cast<size_t>(b) * C + c0) * plane;
    const T* xp = x + first + p;
    const T* yr = y + first + (p - w);  // column 0 of the pixel's row
#pragma unroll 4
    for (int c = c0; c < c1; ++c, xp += plane, yr += plane) {
      const float xv = load(xp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float yv = load(yr + col[k]);
        acc[k] = inside[k] ? fmaf(xv, yv, acc[k]) : acc[k];
      }
    }
  }

  T* op = out + static_cast<size_t>(b) * K * plane + p;
  if (blockDim.y == 1) {
    if (active) {
#pragma unroll
      for (int k = 0; k < K; ++k) op[k * plane] = store_as<T>(acc[k] * inv_c);
    }
    return;
  }
  const int slot = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) part[k][slot] = acc[k];
  __syncthreads();
  if (!active) return;
  for (int k = threadIdx.y; k < K; k += blockDim.y) {
    float s = part[k][threadIdx.x];
    for (unsigned sl = 1; sl < blockDim.y; ++sl)
      s = __fadd_rn(s, part[k][sl * blockDim.x + threadIdx.x]);
    op[k * plane] = store_as<T>(s * inv_c);
  }
}

constexpr int kBwdPixels = 64;  // pixels a corr_bwd block
// threads a corr_bwd launch aims for: 2,048 on each of the 132 SMs, where
// the channels allow
constexpr long long kBwdFill = 132LL * 2048;

// Thread x of block (bx, slice, b) owns pixel p = bx * kBwdPixels + x of
// the plane and the channels [slice * cps, (slice + 1) * cps), and writes
// their dx and dy once each: no shared memory, no barrier. Up to radius 2
// it is held to 64 registers a thread (16 blocks an SM), which spills
// nothing; at radius 3 and 4 that bound would spill.
template <int R, typename T>
__global__ void __launch_bounds__(kBwdPixels, R <= 2 ? 16 : 1)
    corr_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ g, T* __restrict__ dx,
                    T* __restrict__ dy, int C, int W, size_t plane, int cps,
                    float inv_c) {
  constexpr int K = 2 * R + 1;
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int b = blockIdx.z;
  const int w = plane <= UINT_MAX ? static_cast<int>(static_cast<unsigned>(p) %
                                                     static_cast<unsigned>(W))
                                  : static_cast<int>(p % W);
  const size_t row = p - w;  // column 0 of the pixel's row

  // g and the bounds once a pixel: dx's shift k reads y column w + k - R
  // with g[k, w]; dy's reads x column w + R - k with g[k, w + R - k]. The
  // loads in the channel loop are unconditional (at a clamped column) and
  // an out-of-range term leaves its sum unchanged.
  float gx[K], gy[K];
  int col_y[K], col_x[K];
  bool in_y[K], in_x[K];
  const T* gp = g + static_cast<size_t>(b) * K * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int wy = w + k - R, wx = w + R - k;
    in_y[k] = wy >= 0 && wy < W;
    in_x[k] = wx >= 0 && wx < W;
    col_y[k] = min(max(wy, 0), W - 1);
    col_x[k] = min(max(wx, 0), W - 1);
    gx[k] = load(gp + k * plane + p);
    gy[k] = load(gp + k * plane + row + col_x[k]);
  }

  const int c0 = blockIdx.y * cps;
  const int c1 = min(C, c0 + cps);
  const size_t first = (static_cast<size_t>(b) * C + c0) * plane;
  const T* xr = x + first + row;
  const T* yr = y + first + row;
  T* dxp = dx + first + p;
  T* dyp = dy + first + p;
  for (int c = c0; c < c1; ++c, xr += plane, yr += plane, dxp += plane, dyp += plane) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float tx = __fmul_rn(gx[k], load(yr + col_y[k]));
      const float ty = __fmul_rn(gy[k], load(xr + col_x[k]));
      ax = in_y[k] ? __fadd_rn(ax, __fmul_rn(tx, inv_c)) : ax;
      ay = in_x[k] ? __fadd_rn(ay, __fmul_rn(ty, inv_c)) : ay;
    }
    *dxp = store_as<T>(ax);
    *dyp = store_as<T>(ay);
  }
}

// corr_fwd's launch: as many channel slices as it takes to put kFwdFill
// threads on the card, at most one a channel and kFwdMaxSlices; each slice
// a warp of consecutive pixels, and up to 4 warps of pixels a block where
// the slices are fewer than 4.
template <int R, typename T>
int launch(const T* x, const T* y, T* out, int B, int C, int H, int W,
           cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const long long pixels = static_cast<long long>(B) * static_cast<long long>(plane);
  long long want = pixels > 0 ? (kFwdFill + pixels - 1) / pixels : 1;
  want = want < kFwdMaxSlices ? want : kFwdMaxSlices;
  want = want < C ? want : C;
  const int slices0 = want > 1 ? static_cast<int>(want) : 1;
  const int cps = C > slices0 ? (C + slices0 - 1) / slices0 : 1;
  const int slices = C > cps ? (C + cps - 1) / cps : 1;  // none empty
  const int pix = kWarp * (slices < 4 ? 4 / slices : 1);
  const long long blocks = (static_cast<long long>(plane) + pix - 1) / pix;
  if (blocks > INT_MAX || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  corr_fwd_kernel<R, T>
      <<<dim3(static_cast<unsigned>(blocks), B), dim3(pix, slices), 0, stream>>>(
          x, y, out, C, W, plane, cps, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

// corr_bwd's launch: its slices never meet, so they go on the grid's y
// axis, as many as it takes to put kBwdFill threads on the card, at most
// one a channel (and 65535), none empty.
template <int R, typename T>
int launch_bwd(const T* x, const T* y, const T* g, T* dx, T* dy, int B, int C,
               int H, int W, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(H) * W;
  const long long pixels = static_cast<long long>(B) * static_cast<long long>(plane);
  long long want = pixels > 0 ? (kBwdFill + pixels - 1) / pixels : 1;
  want = want < C ? want : C;
  want = want < 65535 ? want : 65535;
  const int slices0 = want > 1 ? static_cast<int>(want) : 1;
  const int cps = C > slices0 ? (C + slices0 - 1) / slices0 : 1;
  const int slices = C > cps ? (C + cps - 1) / cps : 1;  // none empty
  const long long blocks = (static_cast<long long>(plane) + kBwdPixels - 1) / kBwdPixels;
  if (blocks > INT_MAX || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  corr_bwd_kernel<R, T>
      <<<dim3(static_cast<unsigned>(blocks), slices, B), kBwdPixels, 0, stream>>>(
          x, y, g, dx, dy, C, W, plane, cps, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- any radius
constexpr int kWideTile = 64;  // output columns a block, both kernels
constexpr int kQuad = 4;  // adjacent columns a thread, and shifts a step
// corr_fwd_wide: 16 quads of columns by 7 runs of 12 shifts a block
constexpr int kFwdQuads = kWideTile / kQuad;  // 16
constexpr int kFwdRun = 12;  // consecutive shifts a thread, a multiple of kQuad
constexpr int kFwdRuns = 7;
constexpr int kFwdShifts = kFwdRuns * kFwdRun;  // 84 a block: 81 at radius 40
constexpr int kFwdThreads = 128;  // 112 sum; all stage
constexpr int kFwdChannels = 32;  // channels staged at a time
// y columns staged: a run's last step reads 4 past its 12 shifts' 15 columns
constexpr int kFwdWindow = kWideTile + kFwdShifts;
static_assert(kFwdRun % kQuad == 0 && kFwdRuns * kFwdQuads <= kFwdThreads, "the block's layout");
static_assert(kFwdChannels * kWideTile % kFwdThreads == 0 && kFwdChannels * kFwdWindow % kFwdThreads == 0,
              "every thread stages the same count");
// corr_bwd_wide: 16 quads of columns by 8 groups of channels a block
constexpr int kBwdQuads = kWideTile / kQuad;  // 16
constexpr int kBwdGroups = 8;
constexpr int kBwdThreads = kBwdQuads * kBwdGroups;  // 128
constexpr int kBwdChannelsPerThread = 8;  // channel grp + kBwdGroups * i
constexpr int kBwdChannels = kBwdGroups * kBwdChannelsPerThread;  // 64 a block
constexpr int kBwdShifts = 48;  // shifts staged at a time, a multiple of kQuad
constexpr int kBwdWindow = kWideTile + kBwdShifts;  // y or x columns staged
static_assert(kBwdShifts % kQuad == 0, "a step of kQuad shifts stays in one chunk");
static_assert(kBwdShifts * kWideTile % kBwdThreads == 0 && kBwdChannels * kBwdWindow % kBwdThreads == 0,
              "every thread stages the same count");

// Stages a channel chunk of corr_fwd_wide: xs[c][j] = x[c, w0 + j] and
// ys[c][j] = y[c, ystart + j] (xr, yr: the chunk's first channel of the
// row), zeros outside [0, W-1]; rows past the chunk's nc channels hold a
// copy of its last, which no sum reads. Every thread stages a fixed count
// of elements, unrolled and every load made (at a clamped row and column),
// so that a batch of loads is in flight before its stores.
template <typename T>
__device__ __forceinline__ void stage_fwd(const T* __restrict__ xr, const T* __restrict__ yr,
                                          float (*__restrict__ xs)[kWideTile],
                                          float (*__restrict__ ys)[kFwdWindow], int W,
                                          size_t plane, int w0, int ystart, int nc) {
  constexpr int kX = kFwdChannels * kWideTile / kFwdThreads;
  constexpr int kY = kFwdChannels * kFwdWindow / kFwdThreads;
#pragma unroll
  for (int m = 0; m < kX; ++m) {
    const int i = threadIdx.x + m * kFwdThreads;
    const int c = i / kWideTile, j = i % kWideTile;
    const int col = w0 + j;
    const float v = load(xr + min(c, nc - 1) * plane + min(col, W - 1));
    xs[c][j] = col < W ? v : 0.f;
  }
#pragma unroll 16
  for (int m = 0; m < kY; ++m) {
    const int i = threadIdx.x + m * kFwdThreads;
    const int c = i / kFwdWindow, j = i - c * kFwdWindow;
    const int col = ystart + j;
    const float v = load(yr + min(c, nc - 1) * plane + min(max(col, 0), W - 1));
    ys[c][j] = (col >= 0 && col < W) ? v : 0.f;
  }
}

// blockIdx.x = chunk of kFwdShifts shifts * n_tiles + tile of kWideTile
// columns, blockIdx.y the row, blockIdx.z the batch. Thread (quad t, run
// r) owns the columns w0 + 4t .. + 3 and the shifts k0 + 12r .. + 11: 48
// sums. For each channel it loads x's 4 columns as one float4 and slides
// a float4 window of y (ys[4t + 12r + 4s .. + 7] for step s) over its
// shifts: 5 shared-memory loads of 16 bytes make 48 multiply-adds.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    corr_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         T* __restrict__ out, int C, int H, int W, int R,
                         int n_tiles, float inv_c) {
  __shared__ __align__(16) float xs[kFwdChannels][kWideTile];
  __shared__ __align__(16) float ys[kFwdChannels][kFwdWindow];
  const int K = 2 * R + 1;
  const int w0 = (blockIdx.x % n_tiles) * kWideTile;
  const int k0 = (blockIdx.x / n_tiles) * kFwdShifts;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x % kFwdQuads;  // columns w0 + 4t .. + 3
  const int run = threadIdx.x / kFwdQuads;  // shifts k0 + 12 run .. + 11
  const bool sums = run < kFwdRuns;  // the same in a half warp
  const int s0 = run * kFwdRun;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const T* xp = x + static_cast<size_t>(b) * C * plane + row;
  const T* yp = y + static_cast<size_t>(b) * C * plane + row;

  float acc[kFwdRun][kQuad];
#pragma unroll
  for (int s = 0; s < kFwdRun; ++s) {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) acc[s][q] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kFwdChannels) {
    const int nc = min(kFwdChannels, C - c0);
    __syncthreads();  // the previous chunk is read
    stage_fwd(xp + c0 * plane, yp + c0 * plane, xs, ys, W, plane, w0, w0 + k0 - R, nc);
    __syncthreads();
    if (!sums) continue;
#pragma unroll 2
    for (int c = 0; c < nc; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[c][kQuad * t]);
      const float xq[kQuad] = {xv.x, xv.y, xv.z, xv.w};
      const float* yw = &ys[c][kQuad * t + s0];
      float4 lo = *reinterpret_cast<const float4*>(yw);
#pragma unroll
      for (int st = 0; st < kFwdRun / kQuad; ++st) {
        const float4 hi = *reinterpret_cast<const float4*>(yw + kQuad * (st + 1));
        const float v[2 * kQuad] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int s = 0; s < kQuad; ++s) {
#pragma unroll
          for (int q = 0; q < kQuad; ++q) {
            acc[kQuad * st + s][q] = fmaf(xq[q], v[q + s], acc[kQuad * st + s][q]);
          }
        }
        lo = hi;
      }
    }
  }

  if (!sums) return;
  const int w = w0 + kQuad * t;
#pragma unroll
  for (int s = 0; s < kFwdRun; ++s) {
    const int k = k0 + s0 + s;
    if (k >= K) break;
    T* op = out + (static_cast<size_t>(b) * K + k) * plane + row + w;
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (w + q < W) op[q] = store_as<T>(acc[s][q] * inv_c);
    }
  }
}

// One step of corr_bwd_wide: shifts kk .. kk + n - 1 of the chunk (n =
// kQuad but at the chunk's end) for each of the thread's channels. gs holds
// the chunk's g / C, win its window; carry[i] holds the 4 window values
// channel i's previous step loaded (dx: columns 4t + kk .. + 3 of the
// window; dy: 4t - kk + kBwdShifts .. + 3), and the step loads the next 4.
// Output column 4t + q at shift kk + s reads window column 4t + kk + q + s
// for dx, 4t - kk + kBwdShifts - 1 + q - s for dy.
template <bool kDy, bool kTail>
__device__ __forceinline__ void bwd_wide_step(
    const float (*__restrict__ gs)[kWideTile],
    const float (*__restrict__ win)[kBwdWindow], int t, int grp, int kk, int n,
    float4 (&carry)[kBwdChannelsPerThread],
    float (&acc)[kBwdChannelsPerThread][kQuad]) {
  float gq[kQuad][kQuad];  // [shift][column]
#pragma unroll
  for (int s = 0; s < kQuad; ++s) {
    if (!kTail || s < n) {
      const float4 v = *reinterpret_cast<const float4*>(&gs[kk + s][kQuad * t]);
      gq[s][0] = v.x, gq[s][1] = v.y, gq[s][2] = v.z, gq[s][3] = v.w;
    }
  }
  const int next = kDy ? kQuad * t - kk + kBwdShifts - kQuad : kQuad * t + kk + kQuad;
#pragma unroll
  for (int i = 0; i < kBwdChannelsPerThread; ++i) {
    const float4 nw = *reinterpret_cast<const float4*>(&win[grp + kBwdGroups * i][next]);
    const float4 lo = kDy ? nw : carry[i];
    const float4 hi = kDy ? carry[i] : nw;
    const float v[2 * kQuad] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int s = 0; s < kQuad; ++s) {
      if (!kTail || s < n) {
#pragma unroll
        for (int q = 0; q < kQuad; ++q) {
          acc[i][q] = fmaf(gq[s][q], v[kDy ? q - s + kQuad - 1 : q + s], acc[i][q]);
        }
      }
    }
    carry[i] = nw;
  }
}

// Stages a chunk of corr_bwd_wide: gs[kk][j] = g[k0 + kk, col] / C for the
// tile's 64 columns (col = w0 + j for dx, the diagonal w0 + j + R - k for
// dy), win[c][j] = src[c, start + j] (start = w0 + k0 - R for dx, w0 + R -
// k0 - (kBwdShifts - 1) for dy): zeros outside [0, W-1] and in the rows
// past the chunk's ns shifts or nc channels, which no step reads into a
// stored sum. Every thread stages a fixed count of elements, unrolled and
// every load made (at a clamped row and column), so that a batch of loads
// is in flight before its stores.
template <bool kDy, typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ src_rows, const T* __restrict__ gp,
    float (*__restrict__ gs)[kWideTile], float (*__restrict__ win)[kBwdWindow],
    int W, int R, int K, size_t plane, int w0, int k0, int ns, int nc, float inv_c) {
  constexpr int kG = kBwdShifts * kWideTile / kBwdThreads;
  constexpr int kWin = kBwdChannels * kBwdWindow / kBwdThreads;
  const int start = kDy ? w0 + R - k0 - (kBwdShifts - 1) : w0 + k0 - R;
#pragma unroll 16
  for (int m = 0; m < kG; ++m) {
    const int i = threadIdx.x + m * kBwdThreads;
    const int kk = i / kWideTile, j = i % kWideTile;
    const int k = min(k0 + kk, K - 1);
    const int col = kDy ? w0 + j + R - k : w0 + j;
    const float v = load(gp + k * plane + min(max(col, 0), W - 1));
    gs[kk][j] = (kk < ns && col >= 0 && col < W) ? v * inv_c : 0.f;
  }
#pragma unroll 16
  for (int m = 0; m < kWin; ++m) {
    const int i = threadIdx.x + m * kBwdThreads;
    const int c = i / kBwdWindow, j = i - c * kBwdWindow;
    const int col = start + j;
    const float v = load(src_rows + min(c, nc - 1) * plane + min(max(col, 0), W - 1));
    win[c][j] = (c < nc && col >= 0 && col < W) ? v : 0.f;
  }
}

// One of corr_bwd_wide's two gathers for the block's row, tile and
// channel chunk: dx from y (kDy false) or dy from x, into out.
template <bool kDy, typename T>
__device__ __forceinline__ void bwd_wide_half(
    const T* __restrict__ src, const T* __restrict__ g, T* __restrict__ out,
    float (*__restrict__ gs)[kWideTile], float (*__restrict__ win)[kBwdWindow],
    int C, int H, int W, int R, int w0, int c0, float inv_c) {
  const int K = 2 * R + 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x % kBwdQuads;    // columns w0 + 4t .. + 3
  const int grp = threadIdx.x / kBwdQuads;  // channels c0 + grp + 8i
  const int nc = min(kBwdChannels, C - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(h) * W;
  const T* src_rows = src + (static_cast<size_t>(b) * C + c0) * plane + row;
  const T* gp = g + static_cast<size_t>(b) * K * plane + row;

  float acc[kBwdChannelsPerThread][kQuad];
#pragma unroll
  for (int i = 0; i < kBwdChannelsPerThread; ++i) {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) acc[i][q] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBwdShifts) {
    const int ns = min(kBwdShifts, K - k0);
    __syncthreads();  // the previous chunk is read
    stage_chunk<kDy>(src_rows, gp, gs, win, W, R, K, plane, w0, k0, ns, nc, inv_c);
    __syncthreads();

    float4 carry[kBwdChannelsPerThread];
#pragma unroll
    for (int i = 0; i < kBwdChannelsPerThread; ++i) {
      carry[i] = *reinterpret_cast<const float4*>(
          &win[grp + kBwdGroups * i][kQuad * t + (kDy ? kBwdShifts : 0)]);
    }
    int kk = 0;
#pragma unroll 2
    for (; kk + kQuad <= ns; kk += kQuad) {
      bwd_wide_step<kDy, false>(gs, win, t, grp, kk, kQuad, carry, acc);
    }
    if (kk < ns) bwd_wide_step<kDy, true>(gs, win, t, grp, kk, ns - kk, carry, acc);
  }

  const int w = w0 + kQuad * t;
#pragma unroll
  for (int i = 0; i < kBwdChannelsPerThread; ++i) {
    const int c = grp + kBwdGroups * i;
    if (c >= nc) continue;
    T* op = out + (static_cast<size_t>(b) * C + c0 + c) * plane + row + w;
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (w + q < W) op[q] = store_as<T>(acc[i][q]);
    }
  }
}

// blockIdx.x = (half * n_chunks + chunk) * n_tiles + tile: half 0 computes
// dx, half 1 dy; blockIdx.y the row, blockIdx.z the batch.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    corr_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ g, T* __restrict__ dx,
                         T* __restrict__ dy, int C, int H, int W, int R,
                         int n_tiles, int n_chunks, float inv_c) {
  __shared__ __align__(16) float gs[kBwdShifts][kWideTile];
  __shared__ __align__(16) float win[kBwdChannels][kBwdWindow];
  const int w0 = (blockIdx.x % n_tiles) * kWideTile;
  const int rest = blockIdx.x / n_tiles;
  const int c0 = (rest % n_chunks) * kBwdChannels;
  if (rest < n_chunks) {  // the same in a block
    bwd_wide_half<false>(y, g, dx, gs, win, C, H, W, R, w0, c0, inv_c);
  } else {
    bwd_wide_half<true>(x, g, dy, gs, win, C, H, W, R, w0, c0, inv_c);
  }
}

// ------------------------------------------------------- entry points
template <typename T>
int corr_fwd_impl(const T* x, const T* y, T* out, int B, int C, int H, int W,
                  int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch<1, T>(x, y, out, B, C, H, W, stream);
    case 2: return launch<2, T>(x, y, out, B, C, H, W, stream);
    case 3: return launch<3, T>(x, y, out, B, C, H, W, stream);
    case 4: return launch<4, T>(x, y, out, B, C, H, W, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int corr_bwd_impl(const T* x, const T* y, const T* g, T* dx, T* dy, int B,
                  int C, int H, int W, int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch_bwd<1, T>(x, y, g, dx, dy, B, C, H, W, stream);
    case 2: return launch_bwd<2, T>(x, y, g, dx, dy, B, C, H, W, stream);
    case 3: return launch_bwd<3, T>(x, y, g, dx, dy, B, C, H, W, stream);
    case 4: return launch_bwd<4, T>(x, y, g, dx, dy, B, C, H, W, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int corr_fwd_wide_impl(const T* x, const T* y, T* out, int B, int C, int H,
                       int W, int radius, cudaStream_t stream) {
  if (radius < 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || W == 0) return 0;  // nothing to write
  const int n_tiles = (W + kWideTile - 1) / kWideTile;
  const int n_chunks = (2 * radius + 1 + kFwdShifts - 1) / kFwdShifts;
  const long long blocks = static_cast<long long>(n_tiles) * n_chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  corr_fwd_wide_kernel<T><<<dim3(static_cast<unsigned>(blocks), H, B), kFwdThreads, 0, stream>>>(
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
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;  // nothing to write
  const int n_tiles = (W + kWideTile - 1) / kWideTile;
  const int n_chunks = (C + kBwdChannels - 1) / kBwdChannels;
  const long long blocks = 2LL * n_tiles * n_chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  corr_bwd_wide_kernel<T>
      <<<dim3(static_cast<unsigned>(blocks), H, B), kBwdThreads, 0, stream>>>(
          x, y, g, dx, dy, C, H, W, radius, n_tiles, n_chunks, 1.0f / C);
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
// of corr_fwd's output; dx, dy like x. B may be at most 65535.
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
