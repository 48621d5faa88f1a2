// The fast renderer's dilation for Hopper (sm_90a): disc-shaped min-dilations
// of K1's class buffers, merged over the classes, in one kernel.
//
// Replaces no TPU kernel.  The JAX package's dilation
// (surfelmapping_tpu/ops/splat.py:420-429) is plain XLA: a pad and one
// minimum per disc stamp, which XLA fuses into a few loops.  The port ran the
// same loop as eager PyTorch ops (ops/splat.py:dilate_plain): one
// torch.minimum over an int64 H x W plane per stamp, 164 for the classes
// (1, 2, 3, 5), ~173 launches per render with the fill and the pads, and the
// host's time to enqueue them held the render back.
//
// What bounds it on the H100: bytes, in the least time.  Each class buffer
// is read once and the merged plane written once: 4 x 3.63 MB read and
// 3.63 MB written at 1226x370, ~18 MB, ~5.4 us at 3.35 TB/s.  In practice
// its 164 shared-memory reads and int64 compares per pixel set its time:
// ~45 us on an H100 at that shape, against ~0.5 ms of device time and
// ~2 ms of host launches for the plain loop.
//
// Design.  One block of 32 x 8 threads per 32 x 16 output tile; each thread
// keeps a running int64 minimum for two pixels of one column in registers.
// For each class in turn the block copies the tile and a halo of the class's
// radius R from device memory into shared memory (words outside the image
// read as the empty word, as the plain loop's constant pad does, so a stamp
// from outside the image contributes nothing), then walks the class's stamp
// row by row: row dj covers the offsets di in [lo, hi], and pixel (y, x)
// takes min(word, centre[y - dj][x - di]).  A warp reads 32 consecutive words
// of a shared row per offset.  The stamps are not written here: the wrapper
// (ops/disc_dilate.py) passes the rows of ops/disc_dilate.disc_stamps, the
// table the plain loop reads, by value in the launch's parameters.  The halo
// is sized from the largest class radius, in dynamic shared memory (opted in
// past 48 KB); 8.7 KB at R = 5.
//
// Bits.  int64 minimum is exact, associative and commutative, and the words
// (key << 32) | id order as the plain loop's signed torch.minimum orders
// them, so the plane equals the plain loop's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxClasses = 8;
constexpr int kMaxRows = 1024;

// The stamps of the classes, outside the anonymous namespace so the C entry
// point can name it; the wrapper's _Table mirrors it field for field.
struct DiscTable {
  int nc;                    // classes, 1 to kMaxClasses
  int radius[kMaxClasses];   // class c reaches |dj|, |di| <= radius[c]
  int row0[kMaxClasses];     // its rows dj = -R..R are lo/hi[row0 .. row0 + 2R]
  signed char lo[kMaxRows];  // row r covers di in [lo[r], hi[r]] (empty if lo > hi)
  signed char hi[kMaxRows];
};

struct DiscDilateArgs {
  DiscTable t;
  const long long* src;  // i64[nc, H, W]
  long long* out;        // i64[H, W]
  int H, W;
};

namespace {

constexpr long long kEmpty = 0x7FFFFFFF7FFFFFFFll;
constexpr int kTileW = 32;
constexpr int kRowsPerPass = 8;
constexpr int kPix = 2;  // output rows per thread
constexpr int kTileH = kRowsPerPass * kPix;
constexpr int kThreads = kTileW * kRowsPerPass;
constexpr int kStaticSmem = 48 * 1024;

size_t tile_bytes(int R) {
  return static_cast<size_t>(kTileH + 2 * R) * (kTileW + 2 * R) * sizeof(long long);
}

__global__ void __launch_bounds__(kThreads)
disc_dilate_kernel(const __grid_constant__ DiscDilateArgs a) {
  extern __shared__ long long tile[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  long long best[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) best[p] = kEmpty;

  for (int c = 0; c < a.t.nc; ++c) {
    const int R = a.t.radius[c];
    const int sw = kTileW + 2 * R;
    const int n = (kTileH + 2 * R) * sw;
    const long long* __restrict__ src = a.src + c * plane;
    if (c > 0) __syncthreads();  // the previous class's reads are done
    for (int i = tid; i < n; i += kThreads) {
      const int sy = i / sw, sx = i - sy * sw;
      const int y = y0 - R + sy, x = x0 - R + sx;
      tile[i] = (y >= 0 && y < a.H && x >= 0 && x < a.W)
                    ? __ldg(src + static_cast<size_t>(y) * a.W + x) : kEmpty;
    }
    __syncthreads();
    // pixel (y0 + ty + 8p, x0 + tx) reads centre (y - dj, x - di) at tile
    // row ty + 8p + R - dj and column tx + R - di; dj = r - R
    const int row0 = a.t.row0[c];
    for (int r = 0; r <= 2 * R; ++r) {
      const int lo = a.t.lo[row0 + r], hi = a.t.hi[row0 + r];
      const long long* __restrict__ row = tile + (ty + 2 * R - r) * sw + tx + R;
      for (int di = lo; di <= hi; ++di) {
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const long long w = row[p * kRowsPerPass * sw - di];
          best[p] = w < best[p] ? w : best[p];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int y = y0 + ty + p * kRowsPerPass, x = x0 + tx;
    if (y < a.H && x < a.W) a.out[static_cast<size_t>(y) * a.W + x] = best[p];
  }
}

}  // namespace

extern "C" int disc_dilate_table_size() { return static_cast<int>(sizeof(DiscTable)); }

// The largest class radius whose tile and halo fit the current device's
// shared memory.
extern "C" int disc_dilate_max_radius() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  int R = 0;
  while (R < 127 && tile_bytes(R + 1) <= static_cast<size_t>(optin)) ++R;
  return R;
}

extern "C" int disc_dilate_launch(const DiscTable* t, const long long* src, long long* out,
                                  int H, int W, void* stream) {
  if (t->nc < 1 || t->nc > kMaxClasses || H < 1 || W < 1 || (H + kTileH - 1) / kTileH > 65535)
    return cudaErrorInvalidValue;
  int r_max = 0;
  for (int c = 0; c < t->nc; ++c) {
    const int R = t->radius[c];
    if (R < 0 || R > 127 || t->row0[c] < 0 || t->row0[c] + 2 * R + 1 > kMaxRows)
      return cudaErrorInvalidValue;
    if (R > r_max) r_max = R;
  }
  const size_t smem = tile_bytes(r_max);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        disc_dilate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check to find
      return static_cast<int>(e);
    }
  }
  const DiscDilateArgs a{*t, src, out, H, W};
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  disc_dilate_kernel<<<grid, dim3(kTileW, kRowsPerPass), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
