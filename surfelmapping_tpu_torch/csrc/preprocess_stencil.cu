// Fused depth-preprocessing stencil for Hopper (sm_90a):
// support filter (t1) -> (2R+1)^2 class-gated smooth -> support filter (t2).
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
//          w from the weight table; zero a centre that is sky or out of range.
//
// What bounds it on the H100: operations.  It reads 8 B and writes 4 B per
// pixel, but evaluates 169 gated taps per pixel at R = 6 (~540 f32
// operations), so the least time is the operation count over the 67 TFLOP/s
// f32 rate.
//
// Design.  One CTA of 32 x 8 threads per 30 x 30 output tile.  The tile
// plus an (R + 2)-pixel halo of depth and class is loaded once into shared
// memory; t1 runs on the tile + R + 1, the smooth on the tile + 1 (the
// "smooth region", 32 x 32: one warp across), t2 on the tile, each stage
// from the previous one in shared memory.  Device memory sees one read of
// each input and one write of the output.  At KITTI's 1226 x 370 that is
// 41 x 13 = 533 CTAs; 6 fit on an SM (32 KB of shared memory, 40 registers
// a thread at R = 6), so the whole grid is resident at once and an SM runs
// 4 or 5 tiles.  Half-height tiles of 128 threads balance the SMs better
// but recompute more halo, and ran slower in a development run.
//  * The smooth's neighbour-only gates (in image, col + 0.5 >= border,
//    near < t1 < cap) are folded into a gated class plane once, right after
//    t1: a neighbour that fails them stores kSentinel = INT32_MIN instead of
//    its class.  A tap is then: load depth, load gated class, compare with
//    the centre's class, multiply by the weight, and two predicated adds.
//    The sentinel cannot match: a thread whose centres include the class
//    INT32_MIN takes the general path (the gates tested per tap, from the
//    t1 depth and the raw class plane) instead.
//  * The kernel is a template on the radius (0..kRMax, picked by a switch),
//    so the taps unroll and each weight is read at a compile-time offset of
//    the kernel's parameters (no index arithmetic, no weight table to keep
//    loaded between launches).
//  * Register blocking: each thread computes kRowsPerThread = 4 smooth
//    pixels of one column.  It walks the source rows upward and each loaded
//    neighbour serves every output within R rows of it, so each output's
//    taps are summed in the plain version's order: dy ascending, dx
//    ascending within a row.  The 32 x 32 smooth pixels map onto the 256
//    threads with no ragged round; t2 reuses the same mapping.
// The source is compiled with -fmad=false, without --use_fast_math, and the
// smooth uses __fmul_rn / __fadd_rn: products and sums round as the plain
// version's separate multiply and add do, and division stays IEEE.  A gated
// tap adds nothing (the plain version adds +0.0, which leaves a non-negative
// sum unchanged), and a pixel with no tap has num = den = 0, so
// num / max(den, 1e-30) gives the plain version's 0 without a tap count.
// The kernel reproduces its plain version bit for bit.
//
// SASS (cuobjdump -sass, sm_90a, nvcc 12.9; chip_smoke's `build` phase): the
// R = 6 kernel has 5.80 instructions per tap more than the R = 0 one: 2.00
// FADD, 1.03 ISETP, 1.00 FMUL (predicated, with the compare folded in), 0.83
// LDC (ptxas loads the weights from the parameter bank into registers rather
// than using them as operands; a __constant__ table did no better), 0.61
// LDS (two per source element, shared by the 4 outputs), 0.25 IADD3, 0.15
// MOV, 0.10 ULDC.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRMax = 6;
constexpr int kTaps = 2 * kRMax + 1;
constexpr int kRowsPerThread = 4;
constexpr int kThreadRows = 8;
constexpr int kThreads = 32 * kThreadRows;
constexpr int kSmoothH = kRowsPerThread * kThreadRows;  // smooth region rows
constexpr int kSmoothW = 32;                            // smooth region cols
constexpr int kTileH = kSmoothH - 2;
constexpr int kTileW = kSmoothW - 2;
constexpr int32_t kSentinel = INT_MIN;

struct Params {
  int H, W;
  float near_clip, cap_depth, border, thresh1, thresh2;
  int support_min, sky, person, rider;
  float weight[kTaps * kTaps];  // dy outer, centred at (kRMax, kRMax)
};

// Region geometry for radius R; each region's origin is given relative to
// the output tile's first pixel.
template <int R>
struct Geo {
  static constexpr int FH = kSmoothH + 2 * R, FW = kSmoothW + 2 * R;  // t1, at -(R+1)
  static constexpr int LH = FH + 2, LW = FW + 2;                      // load, at -(R+2)
};

__device__ __forceinline__ bool in_image(int r, int c, const Params& p) {
  return r >= 0 && r < p.H && c >= 0 && c < p.W;
}

__device__ __forceinline__ bool support_removed(float d, int s, const Params& p) {
  return d <= p.near_clip || d >= p.cap_depth || s == p.sky || s == p.person ||
         s == p.rider;
}

__device__ __forceinline__ float weight(const Params& p, int dy, int dx) {
  return p.weight[(dy + kRMax) * kTaps + dx + kRMax];
}

// The smooth's fast path for one thread: f1 and g point at the thread's
// first source element (t1 row of its first output - R, its column - R).
template <int R>
__device__ __forceinline__ void smooth_fast(const float* __restrict__ f1,
                                            const int32_t* __restrict__ g,
                                            const int (&sc)[kRowsPerThread],
                                            const Params& p,
                                            float (&num)[kRowsPerThread],
                                            float (&den)[kRowsPerThread]) {
  constexpr int FW = Geo<R>::FW;
#pragma unroll
  for (int s = 0; s < kRowsPerThread + 2 * R; ++s) {
#pragma unroll
    for (int x = 0; x <= 2 * R; ++x) {
      const float d = f1[s * FW + x];
      const int32_t c = g[s * FW + x];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int dy = s - i - R;
        if (dy < -R || dy > R) continue;
        const float w = weight(p, dy, x - R);
        const float t = __fmul_rn(d, w);
        if (c == sc[i]) {
          num[i] = __fadd_rn(num[i], t);
          den[i] = __fadd_rn(den[i], w);
        }
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ metric, const int32_t* __restrict__ sem,
               float* __restrict__ out, const __grid_constant__ Params p) {
  using G = Geo<R>;
  __shared__ float s_d[G::LH][G::LW];    // raw depth; then the smooth region
  __shared__ int32_t s_c[G::LH][G::LW];  // raw class
  __shared__ float s_f1[G::FH][G::FW];   // t1
  __shared__ int32_t s_g[G::FH][G::FW];  // class gated for the smooth
  static_assert(kSmoothH <= G::LH && kSmoothW <= G::LW, "smooth region fits s_d");
  float(*s_sm)[kSmoothW] = reinterpret_cast<float(*)[kSmoothW]>(&s_d[0][0]);

  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int tile_r = blockIdx.y * kTileH;
  const int tile_c = blockIdx.x * kTileW;
  const int r0 = tile_r - (R + 2);  // image row of s_d[0][*]
  const int c0 = tile_c - (R + 2);

  // ---- load the tile + (R + 2) halo ------------------------------------
  for (int i = tid; i < G::LH * G::LW; i += kThreads) {
    const int ly = i / G::LW, lx = i - ly * G::LW;
    const int r = r0 + ly, c = c0 + lx;
    const bool in = in_image(r, c, p);
    s_d[ly][lx] = in ? metric[r * p.W + c] : 0.0f;
    s_c[ly][lx] = in ? sem[r * p.W + c] : -1;
  }
  __syncthreads();

  // ---- t1 on the tile + (R + 1): s_f1[y][x] <-> s_d[y + 1][x + 1] --------
  for (int i = tid; i < G::FH * G::FW; i += kThreads) {
    const int fy = i / G::FW, fx = i - fy * G::FW;
    const int ly = fy + 1, lx = fx + 1;
    const int r = r0 + ly, c = c0 + lx;
    float v = 0.0f;
    int32_t gated = kSentinel;
    if (in_image(r, c, p)) {
      const float d = s_d[ly][lx];
      const int s = s_c[ly][lx];
      int support = 0;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if ((dy == 0 && dx == 0) || !in_image(r + dy, c + dx, p)) continue;
          if (fabsf(s_d[ly + dy][lx + dx] - d) < p.thresh1 && s_c[ly + dy][lx + dx] == s)
            ++support;
        }
      v = (!support_removed(d, s, p) && support >= p.support_min) ? d : 0.0f;
      if (v > p.near_clip && v < p.cap_depth && (float)c + 0.5f >= p.border) gated = s;
    }
    s_f1[fy][fx] = v;
    s_g[fy][fx] = gated;
  }
  __syncthreads();

  // ---- smooth on the tile + 1: thread (x, y) owns smooth pixels
  // (y * 4 + i, x); smooth (sy, sx) <-> t1 (sy + R, sx + R) <-> load
  // (sy + R + 1, sx + R + 1) ------------------------------------------------
  const int tx = threadIdx.x;
  const int sy0 = threadIdx.y * kRowsPerThread;
  const int img_c = tile_c - 1 + tx;
  const int img_r0 = tile_r - 1 + sy0;
  int sc[kRowsPerThread];
  float num[kRowsPerThread], den[kRowsPerThread];
  bool sentinel = false;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    sc[i] = s_c[sy0 + i + R + 1][tx + R + 1];
    sentinel |= sc[i] == kSentinel;
    num[i] = 0.0f;
    den[i] = 0.0f;
  }
  const bool needed = img_c >= 0 && img_c < p.W && img_r0 < p.H &&
                      img_r0 + kRowsPerThread > 0;
  if (needed && !sentinel) {
    smooth_fast<R>(&s_f1[sy0][tx], &s_g[sy0][tx], sc, p, num, den);
  } else if (needed) {
    // general path: a centre of class kSentinel would match the gated-out
    // neighbours, so test the gates per tap (i unrolled: the per-output
    // arrays stay in registers)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll 1
      for (int dy = -R; dy <= R; ++dy)
#pragma unroll 1
        for (int dx = -R; dx <= R; ++dx) {
          const int r = img_r0 + i + dy, c = img_c + dx;
          if (!in_image(r, c, p) || (float)c + 0.5f < p.border) continue;
          const float d = s_f1[sy0 + i + R + dy][tx + R + dx];
          if (d > p.near_clip && d < p.cap_depth &&
              s_c[sy0 + i + R + 1 + dy][tx + R + 1 + dx] == sc[i]) {
            const float w = weight(p, dy, dx);
            num[i] = __fadd_rn(num[i], __fmul_rn(d, w));
            den[i] = __fadd_rn(den[i], w);
          }
        }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float v = 0.0f;
    if (in_image(img_r0 + i, img_c, p)) {
      const float dc = s_f1[sy0 + i + R][tx + R];
      const bool removed = dc <= p.near_clip || dc >= p.cap_depth || sc[i] == p.sky;
      v = removed ? 0.0f : num[i] / fmaxf(den[i], 1e-30f);
    }
    s_sm[sy0 + i][tx] = v;  // s_d is dead since t1
  }
  __syncthreads();

  // ---- t2 on the tile: the same smooth pixels, inside the tile -----------
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int sy = sy0 + i, sx = tx;
    const int r = img_r0 + i, c = img_c;
    if (sy < 1 || sy > kSmoothH - 2 || sx < 1 || sx > kSmoothW - 2 || !in_image(r, c, p))
      continue;
    const float d = s_sm[sy][sx];
    const int s = sc[i];
    int support = 0;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if ((dy == 0 && dx == 0) || !in_image(r + dy, c + dx, p)) continue;
        if (fabsf(s_sm[sy + dy][sx + dx] - d) < p.thresh2 &&
            s_c[sy + R + 1 + dy][sx + R + 1 + dx] == s)
          ++support;
      }
    out[r * p.W + c] = (!support_removed(d, s, p) && support >= p.support_min) ? d : 0.0f;
  }
}

template <int R>
cudaError_t launch(const float* metric, const int32_t* sem, float* out, const Params& p,
                   cudaStream_t s) {
  dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + kTileH - 1) / kTileH);
  stencil_kernel<R><<<grid, dim3(32, kThreadRows), 0, s>>>(metric, sem, out, p);
  return cudaGetLastError();
}

template <int R>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stencil_kernel<R>,
                                                       kThreads, 0);
}

}  // namespace

extern "C" int preprocess_stencil_max_radius() { return kRMax; }

// weights: (2*kRMax+1)^2 floats on the host, row-major (dy outer), centred.
extern "C" int preprocess_stencil_launch(
    const float* metric, const int32_t* sem, float* out, int H, int W,
    float near_clip, float cap_depth, float border, float thresh1, float thresh2,
    int support_min, int radius, int sky, int person, int rider, const float* weights,
    void* stream) {
  Params p{H, W, near_clip, cap_depth, border, thresh1, thresh2,
           support_min, sky, person, rider, {}};
  for (int i = 0; i < kTaps * kTaps; ++i) p.weight[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return (int)launch<0>(metric, sem, out, p, s);
    case 1: return (int)launch<1>(metric, sem, out, p, s);
    case 2: return (int)launch<2>(metric, sem, out, p, s);
    case 3: return (int)launch<3>(metric, sem, out, p, s);
    case 4: return (int)launch<4>(metric, sem, out, p, s);
    case 5: return (int)launch<5>(metric, sem, out, p, s);
    case 6: return (int)launch<6>(metric, sem, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the radius-R kernel that fit on one SM, its threads per CTA and
// its output tile (rows, cols).
extern "C" int preprocess_stencil_occupancy(int radius, int* blocks_per_sm, int* threads,
                                            int* tile_h, int* tile_w) {
  *threads = kThreads;
  *tile_h = kTileH;
  *tile_w = kTileW;
  switch (radius) {
    case 0: return (int)occupancy<0>(blocks_per_sm);
    case 1: return (int)occupancy<1>(blocks_per_sm);
    case 2: return (int)occupancy<2>(blocks_per_sm);
    case 3: return (int)occupancy<3>(blocks_per_sm);
    case 4: return (int)occupancy<4>(blocks_per_sm);
    case 5: return (int)occupancy<5>(blocks_per_sm);
    case 6: return (int)occupancy<6>(blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
