// The association stage of the fusion step for Hopper (sm_90a): data.vert's
// candidate, window search, merge and world transform in one kernel.
//
// Replaces no TPU kernel.  The JAX package's stage
// (surfelmapping_tpu/ops/active.py:associate_active) is plain XLA, which
// fuses its elementwise chain into a few loops.  The port ran the same chain
// as eager PyTorch ops (ops/active.py:associate_active_plain): ~470 launches
// per fused frame, half of the frame's, each a pass over the 226,810
// checkerboard pixels of a KITTI frame, plus a 9-column copy of the whole
// active table.  The host's time to enqueue them set the fusion path's pace.
//
// What bounds it on the H100: launches, then bytes.  One launch replaces
// the chain.  Per checkerboard pixel it reads the depth of the pixel and its
// 4 neighbours (each depth pixel once from device memory), 12 B of colour,
// 4 B of class, 8 B of index per window and the 9 table attributes (36 B)
// of each window's surfel, and writes the 12 AssocFlat columns (52 B): ~27
// MB at 1226x370, ~8 us at 3.35 TB/s.  Its ~200 f32 operations and one
// double acos per pixel and window are far below the operations bound.
//
// Design.  One thread per lattice entry k, in the plain version's
// column-major lattice order (ops/active.py:checkerboard_flat):
//   uh = k / H, s = (k / (H/2)) % 2, vh = k % (H/2);
//   column u = 2 uh + s, row v = 2 vh + 1 - s.
// Consecutive threads write consecutive entries, so the 12 output columns
// are written coalesced; the image reads stride down a column and are served
// from L2 (each row of the images is shared by the warps of neighbouring
// columns).  Nothing between the stages touches device memory: the
// candidate, the best window's old surfel and the merge stay in registers,
// and the table's columns are read in place (the plain version's stacked
// copy of the table is gone).  The index image may be sampled F x F times
// per pixel (index_factor F); the kernel takes any F.
//
// Bits.  The result equals the plain version's on the card bit for bit:
//  * the source is compiled with -fmad=false and without --use_fast_math,
//    so each product and sum rounds on its own, in the plain version's
//    order (left to right, as PyTorch's separate ops evaluate);
//  * divisions are IEEE (the plain version divides by device tensors,
//    ops/transforms.device_scalar) and square roots __fsqrt_rn
//    (ops/transforms.ieee_sqrt);
//  * arccos is taken in double and rounded once (ops/transforms.acos);
//  * the Python constants reach the kernel rounded to float32 by the
//    wrapper, as PyTorch rounds a Python scalar against a float32 tensor;
//    the 1e-12 guards are rounded from double here;
//  * clamp, minimum and where keep PyTorch's NaN rules (a NaN passes clamp
//    and wins minimum).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// The launch's arguments (passed by value as a __grid_constant__), outside
// the anonymous namespace so the C entry point can name it; the wrapper
// (ops/associate_merge.py) mirrors it field for field.
struct AssociateMergeArgs {
  const float* depth;     // f32[H, W]
  const float* rgb;       // f32[H, W, 3]
  const int32_t* sem;     // i32[H, W]
  const int64_t* index;   // i64[H F, W F], active slot or -1
  const float* x;         // the active table's columns, [A] each
  const float* y;
  const float* z;
  const float* conf;
  const int32_t* colorsem;
  const float* nx;
  const float* ny;
  const float* nz;
  const float* radius;
  const float* pose;      // f32[4, 4] camera to world
  const float* t_inv;     // f32[4, 4] world to camera
  int32_t* out;           // [11, N] columns, float bits but colorsem
  int64_t* mark;          // i64[N]
  long long A;
  int H, W, F;
  float fx, fy, cx, cy, mean_focal, sqrt2;
  float near_clip, far_clip, conf_new, fuse_thresh, merge_normal_angle,
      merge_radius_factor, time;
};

namespace {

constexpr int kThreads = 256;
constexpr int kOutCols = 11;  // x y z conf colorsem init_t last_t nx ny nz radius

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(a * a + b * b + c * c);
}

__device__ __forceinline__ int32_t channel(float c) {
  return static_cast<int32_t>(rintf(clamp(c, 0.0f, 1.0f) * 255.0f));
}

// The best window's old surfel in the camera frame.
struct Old {
  float dist, x, y, z, conf, nx, ny, nz, rad;
  int32_t cs;
  int64_t id;
};

__global__ void __launch_bounds__(kThreads)
associate_merge_kernel(const __grid_constant__ AssociateMergeArgs a) {
  const long long n = static_cast<long long>(a.H) * a.W / 2;
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int H = a.H, W = a.W, Hh = a.H / 2;
  const int uh = static_cast<int>(k / H), r = static_cast<int>(k % H);
  const int s = r / Hh, vh = r % Hh;
  const int u = 2 * uh + s, v = 2 * vh + 1 - s;
  const int pix = v * W + u;
  const float eps = static_cast<float>(1e-12);

  // ---- the candidate (frame_surfels.association_candidates) -------------
  const float d = a.depth[pix];
  const float dl = a.depth[v * W + max(u - 1, 0)];
  const float dr = a.depth[v * W + min(u + 1, W - 1)];
  const float du = a.depth[max(v - 1, 0) * W + u];
  const float dd = a.depth[min(v + 1, H - 1) * W + u];
  const float xc = static_cast<float>(u) + 0.5f;
  const float yc = static_cast<float>(v) + 0.5f;
  const float X = (xc - a.cx) * d / a.fx;
  const float Y = (yc - a.cy) * d / a.fy;
  // central_normals: clamped depth samples at unclamped coordinates
  const float xm = xc + -1.0f, xp = xc + 1.0f, ym = yc + -1.0f, yp = yc + 1.0f;
  const float lx = (xm - a.cx) * dl / a.fx, ly = (yc - a.cy) * dl / a.fy;
  const float rx = (xp - a.cx) * dr / a.fx, ry = (yc - a.cy) * dr / a.fy;
  const float ux = (xc - a.cx) * du / a.fx, uy = (ym - a.cy) * du / a.fy;
  const float dx = (xc - a.cx) * dd / a.fx, dy = (yp - a.cy) * dd / a.fy;
  const float ax = lx - rx, ay = ly - ry, az = dl - dr;
  const float bx = ux - dx, by = uy - dy, bz = du - dd;
  const float gx = ay * bz - az * by, gy = az * bx - ax * bz, gz = ax * by - ay * bx;
  const float gn = clamp_min(norm3(gx, gy, gz), eps);
  const float cnx = gx / gn, cny = gy / gn, cnz = gz / gn;
  const float rad0 = d * a.sqrt2 / a.mean_focal;
  const float crad = minimum(2.0f * rad0, rad0 / clamp_min(fabsf(cnz), eps));
  const int32_t csem = a.sem[pix];
  const float* rgb = a.rgb + 3 * static_cast<long long>(pix);
  const int32_t ccs = static_cast<int32_t>(
      (static_cast<uint32_t>(csem) << 24) | (static_cast<uint32_t>(channel(rgb[0])) << 16) |
      (static_cast<uint32_t>(channel(rgb[1])) << 8) | static_cast<uint32_t>(channel(rgb[2])));
  const bool cvalid = dl != 0.0f && du != 0.0f && dr != 0.0f && dd != 0.0f &&
                      d > a.near_clip && d < a.far_clip;
  // ray_geometry: the unit-plane ray (xl, yl, 1) and its length
  const float xl = (xc - a.cx) / a.fx, yl = (yc - a.cy) / a.fy;
  const float lam = __fsqrt_rn(xl * xl + yl * yl + 1.0f);

  // ---- the windows: the first strictly nearest old surfel ---------------
  const float* T = a.t_inv;
  Old best = {INFINITY, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, -1};
  const long long iw = static_cast<long long>(W) * a.F;
  for (int wi = 0; wi < a.F; ++wi) {
    for (int wj = 0; wj < a.F; ++wj) {
      const int64_t mid = a.index[(static_cast<long long>(v) * a.F + wj) * iw +
                                  static_cast<long long>(u) * a.F + wi];
      const bool has = mid >= 0;
      // the index image holds active slots below A (the plain version's
      // gather raises on any other)
      const long long slot = (has && mid < a.A) ? mid : 0;
      const float ox = a.x[slot], oy = a.y[slot], oz = a.z[slot];
      const float onx = a.nx[slot], ony = a.ny[slot], onz = a.nz[slot];
      const int32_t ocs = a.colorsem[slot];
      const float px = T[0] * ox + T[1] * oy + T[2] * oz + T[3];
      const float py = T[4] * ox + T[5] * oy + T[6] * oz + T[7];
      const float pz = T[8] * ox + T[9] * oy + T[10] * oz + T[11];
      float qx = T[0] * onx + T[1] * ony + T[2] * onz;
      float qy = T[4] * onx + T[5] * ony + T[6] * onz;
      float qz = T[8] * onx + T[9] * ony + T[10] * onz;
      const float ql = clamp_min(norm3(qx, qy, qz), eps);
      qx = qx / ql;
      qy = qy / ql;
      qz = qz / ql;
      const bool depth_gate = fabsf(pz * lam - d * lam) <= a.fuse_thresh;
      const bool sem_gate = csem == ((ocs >> 24) & 0xFF);
      // perpendicular ray distance |ray x p| / lam (data.vert:150)
      const float crx = yl * pz - 1.0f * py;
      const float cry = 1.0f * px - xl * pz;
      const float crz = xl * py - yl * px;
      float dist = norm3(crx, cry, crz) / lam;
      // _angle_between(old normal, candidate normal)
      const float dot = qx * cnx + qy * cny + qz * cnz;
      const float cosv = dot / clamp_min(norm3(qx, qy, qz) * norm3(cnx, cny, cnz), eps);
      const float ang = static_cast<float>(acos(static_cast<double>(clamp(cosv, -1.0f, 1.0f))));
      const bool ok = has && sem_gate && depth_gate && fabsf(ang) < a.merge_normal_angle;
      if (!ok) dist = INFINITY;
      if ((wi == 0 && wj == 0) || dist < best.dist) {
        best.dist = dist;
        best.id = mid;
        best.x = px;
        best.y = py;
        best.z = pz;
        best.conf = a.conf[slot];
        best.cs = ocs;
        best.nx = qx;
        best.ny = qy;
        best.nz = qz;
        best.rad = a.radius[slot];
      }
    }
  }

  // ---- the merge (data.vert:174-208) and the new-unstable record --------
  const bool matched = cvalid && isfinite(best.dist);
  const float cn = a.conf_new;
  const float csum = cn + best.conf;
  float ox = X, oy = Y, oz = d, onx = cnx, ony = cny, onz = cnz;
  float conf = cn, rad = crad, init_t = a.time;
  int32_t cs = ccs;
  if (matched) {
    if (crad < a.merge_radius_factor * best.rad) {
      ox = (cn * X + best.conf * best.x) / csum;
      oy = (cn * Y + best.conf * best.y) / csum;
      oz = (cn * d + best.conf * best.z) / csum;
      onx = (cn * cnx + best.conf * best.nx) / csum;
      ony = (cn * cny + best.conf * best.ny) / csum;
      onz = (cn * cnz + best.conf * best.nz) / csum;
      rad = minimum(crad, best.rad);
      cs = ccs;  // data.vert:183: merged colour == new colour
    } else {
      ox = best.x;
      oy = best.y;
      oz = best.z;
      onx = best.nx;
      ony = best.ny;
      onz = best.nz;
      rad = best.rad;
      cs = best.cs;
    }
    conf = csum;
    init_t = 0.0f;  // a merge keeps the old initTime in place
  }

  // ---- world frame -------------------------------------------------------
  const float* P = a.pose;
  const float wx = P[0] * ox + P[1] * oy + P[2] * oz + P[3];
  const float wy = P[4] * ox + P[5] * oy + P[6] * oz + P[7];
  const float wz = P[8] * ox + P[9] * oy + P[10] * oz + P[11];
  const float nwx = P[0] * onx + P[1] * ony + P[2] * onz;
  const float nwy = P[4] * onx + P[5] * ony + P[6] * onz;
  const float nwz = P[8] * onx + P[9] * ony + P[10] * onz;
  const float wl = clamp_min(norm3(nwx, nwy, nwz), eps);

  const float cols[kOutCols] = {wx, wy, wz, conf, 0.0f, init_t, a.time,
                                nwx / wl, nwy / wl, nwz / wl, rad};
#pragma unroll
  for (int c = 0; c < kOutCols; ++c) {
    a.out[c * n + k] = c == 4 ? cs : __float_as_int(cols[c]);
  }
  a.mark[k] = cvalid ? (matched ? best.id : -1) : -10;
}

}  // namespace

extern "C" int associate_merge_args_size() {
  return static_cast<int>(sizeof(AssociateMergeArgs));
}

extern "C" int associate_merge_launch(const AssociateMergeArgs* args, void* stream) {
  const long long n = static_cast<long long>(args->H) * args->W / 2;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    associate_merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
