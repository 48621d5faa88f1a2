// Fused depth-preprocessing stencil for Hopper (sm_90a):
// support filter (t1) -> 13x13 class-gated smooth -> support filter (t2).
//
// Replaces the TPU kernel
// surfelmapping_tpu/ops/pallas_preprocess.py:preprocess_stencil_tpu (body
// _make_kernel, lines 51-184); the semantics are those of the plain chain in
// surfelmapping_tpu_torch/ops/preprocess.py (depth_filter.frag,
// depth_smooth.frag, depth_filter.frag):
//   t1/t2: keep a pixel iff >= support_min of its 8 in-image neighbours have
//          |dd| < thresh and the same class; zero sky/person/rider and
//          d <= near or d >= cap;
//   smooth: sum over the (2R+1)^2 in-image neighbours with col + 0.5 >=
//          border, near < d < cap and the same class of d*w, and of w, with
//          w from a constant table; zero a centre that is sky or out of range.
//
// What bounds it on the H100: operations.  It reads 8 B and writes 4 B per
// pixel, but evaluates 169 gated taps per pixel (~540 f32 operations), so
// the least time is the operation count over the 67 TFLOP/s f32 rate.
//
// Design.  One CTA per 32x32 output tile.  The tile plus an 8-pixel halo
// (1 for t2, 6 for the smooth, 1 for t1) of depth and class is loaded once
// into shared memory (48x48x8 B); t1 is computed on the tile + 7 halo, the
// smooth on the tile + 1 halo, t2 on the tile, each from the previous stage
// in shared memory.  Device memory sees one read of each input and one write
// of the output.  Out-of-image neighbours are gated by the image bounds,
// exactly as the plain version gates them.  The 169 weights sit in a
// __constant__ table (every thread reads the same tap at once: a broadcast).
// The source is compiled with -fmad=false and without --use_fast_math, so
// the smooth's products and sums round as the plain version's separate
// multiply and add do, and division stays IEEE: the kernel reproduces the
// plain version's smooth bit for bit, and a t2 gate near its threshold
// cannot flip between the two.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 8;
constexpr int kRMax = kHalo - 2;           // smooth radius the halo admits
constexpr int kIn = kTile + 2 * kHalo;     // 48: loaded depth / class
constexpr int kF1 = kTile + 2 * kHalo - 2; // 46: t1 region (tile + 7)
constexpr int kSm = kTile + 2;             // 34: smooth region (tile + 1)
constexpr int kTaps = 2 * kRMax + 1;
constexpr int kThreads = 256;

__constant__ float c_weight[kTaps * kTaps];

struct Params {
  int H, W;
  float near_clip, cap_depth, border, thresh1, thresh2;
  int support_min, radius, sky, person, rider;
};

__device__ __forceinline__ bool in_image(int r, int c, const Params& p) {
  return r >= 0 && r < p.H && c >= 0 && c < p.W;
}

__device__ __forceinline__ bool support_removed(float d, int s, const Params& p) {
  return d <= p.near_clip || d >= p.cap_depth || s == p.sky || s == p.person ||
         s == p.rider;
}

__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ metric, const int32_t* __restrict__ sem,
               float* __restrict__ out, Params p) {
  __shared__ float s_d[kIn][kIn];
  __shared__ int32_t s_c[kIn][kIn];
  __shared__ float s_f1[kF1][kF1];
  __shared__ float s_sm[kSm][kSm];

  const int tile_r = blockIdx.y * kTile;
  const int tile_c = blockIdx.x * kTile;
  const int r0 = tile_r - kHalo;  // image row of s_d[0][*]
  const int c0 = tile_c - kHalo;

  // ---- load the tile + halo ------------------------------------------------
  for (int i = threadIdx.x; i < kIn * kIn; i += blockDim.x) {
    const int ly = i / kIn, lx = i % kIn;
    const int r = r0 + ly, c = c0 + lx;
    const bool in = in_image(r, c, p);
    s_d[ly][lx] = in ? metric[(int64_t)r * p.W + c] : 0.0f;
    s_c[ly][lx] = in ? sem[(int64_t)r * p.W + c] : -1;
  }
  __syncthreads();

  // ---- support t1 on the tile + 7 halo: s_f1[y][x] <-> s_d[y+1][x+1] ----
  for (int i = threadIdx.x; i < kF1 * kF1; i += blockDim.x) {
    const int fy = i / kF1, fx = i % kF1;
    const int ly = fy + 1, lx = fx + 1;
    const int r = r0 + ly, c = c0 + lx;
    float v = 0.0f;
    if (in_image(r, c, p)) {
      const float d = s_d[ly][lx];
      const int s = s_c[ly][lx];
      int support = 0;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          if ((dy == 0 && dx == 0) || !in_image(r + dy, c + dx, p)) continue;
          if (fabsf(s_d[ly + dy][lx + dx] - d) < p.thresh1 &&
              s_c[ly + dy][lx + dx] == s)
            ++support;
        }
      v = (!support_removed(d, s, p) && support >= p.support_min) ? d : 0.0f;
    }
    s_f1[fy][fx] = v;
  }
  __syncthreads();

  // ---- smooth on the tile + 1 halo: s_sm[y][x] <-> s_f1[y+6][x+6] ---------
  const int R = p.radius;
  for (int i = threadIdx.x; i < kSm * kSm; i += blockDim.x) {
    const int my = i / kSm, mx = i % kSm;
    const int fy = my + kHalo - 2, fx = mx + kHalo - 2;
    const int ly = my + kHalo - 1, lx = mx + kHalo - 1;
    const int r = r0 + ly, c = c0 + lx;
    float v = 0.0f;
    if (in_image(r, c, p)) {
      const float dc = s_f1[fy][fx];
      const int sc = s_c[ly][lx];
      float num = 0.0f, den = 0.0f;
      int cnt = 0;
      for (int dy = -R; dy <= R; ++dy) {
        if (r + dy < 0 || r + dy >= p.H) continue;
        for (int dx = -R; dx <= R; ++dx) {
          const int cc = c + dx;
          if (cc < 0 || cc >= p.W || (float)cc + 0.5f < p.border) continue;
          const float dk = s_f1[fy + dy][fx + dx];
          if (dk > p.near_clip && dk < p.cap_depth && s_c[ly + dy][lx + dx] == sc) {
            const float w = c_weight[(dy + kRMax) * kTaps + dx + kRMax];
            num += dk * w;
            den += w;
            ++cnt;
          }
        }
      }
      const float smoothed = cnt > 0 ? num / fmaxf(den, 1e-30f) : 0.0f;
      const bool removed = dc <= p.near_clip || dc >= p.cap_depth || sc == p.sky;
      v = removed ? 0.0f : smoothed;
    }
    s_sm[my][mx] = v;
  }
  __syncthreads();

  // ---- support t2 on the tile: s_sm[y+1][x+1], s_c[y+8][x+8] --------------
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int r = tile_r + ty, c = tile_c + tx;
    if (!in_image(r, c, p)) continue;
    const int my = ty + 1, mx = tx + 1;
    const int ly = ty + kHalo, lx = tx + kHalo;
    const float d = s_sm[my][mx];
    const int s = s_c[ly][lx];
    int support = 0;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if ((dy == 0 && dx == 0) || !in_image(r + dy, c + dx, p)) continue;
        if (fabsf(s_sm[my + dy][mx + dx] - d) < p.thresh2 &&
            s_c[ly + dy][lx + dx] == s)
          ++support;
      }
    out[(int64_t)r * p.W + c] =
        (!support_removed(d, s, p) && support >= p.support_min) ? d : 0.0f;
  }
}

}  // namespace

// Copy the (2*kRMax+1)^2 tap weights (row-major, dy outer) into the constant
// table.  Synchronous; the wrapper calls it once per distinct weight set.
extern "C" int preprocess_stencil_set_weights(const float* weights, int n) {
  if (n != kTaps * kTaps) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbol(c_weight, weights, sizeof(float) * n);
  return (int)e;
}

extern "C" int preprocess_stencil_max_radius() { return kRMax; }

extern "C" int preprocess_stencil_launch(
    const float* metric, const int32_t* sem, float* out, int H, int W,
    float near_clip, float cap_depth, float border, float thresh1, float thresh2,
    int support_min, int radius, int sky, int person, int rider, void* stream) {
  if (radius < 0 || radius > kRMax) return (int)cudaErrorInvalidValue;
  Params p{H, W, near_clip, cap_depth, border, thresh1, thresh2,
           support_min, radius, sky, person, rider};
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  stencil_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      metric, sem, out, p);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
