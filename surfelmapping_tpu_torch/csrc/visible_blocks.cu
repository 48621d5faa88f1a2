// The render cull's visibility pass for Hopper (sm_90a): for each block of
// the map, whether any of its slots is live and projects into the padded
// image between the depth limits, in one kernel.
//
// Replaces no TPU kernel.  The JAX package's cull
// (surfelmapping_tpu/ops/splat.py:cull_for_render) is plain XLA, which fuses
// it into a few loops.  The port ran it as eager PyTorch ops
// (ops/visible_blocks.py:visible_blocks_plain): the guarded projection of
// transforms.project_planar, seven gates, six ANDs and the per-block any(),
// 42 launches on the card, each reading and writing whole float columns of
// the map: ~300 bytes of traffic per slot, ~20 GB per cull at 2^26 slots.
//
// What bounds it on the H100: bytes.  The gate needs px, py, pz and conf of
// every slot once, 16 B a slot, and writes one byte per block: 1.07 GB at
// 2^26 slots, 0.32 ms at 3.35 TB/s.  Its ~30 float operations a slot are far
// below the card's rate.
//
// Design.  A pure streaming pass.  A CTA of 256 threads covers a tile of
// 1024 consecutive slots per pass, each thread four neighbouring slots,
// read as one 16-byte load of each column where the wrapper found the
// columns 16-byte aligned, else as four scalar loads (the same kernel,
// instantiated twice).  Blocks of 1024 slots or more (the main path's 2048)
// take one CTA each, in passes; the CTA ORs each pass with
// __syncthreads_or and stops at the first pass that finds a visible slot:
// the OR is the same.  Smaller blocks (the tests' 32 and 256) lie
// 1024 / block to a tile: a warp's vote where a block spans whole warps,
// else each visible thread's flag, lands in a byte of shared memory per
// block.  One byte is written per block.  G = 32,768 CTAs at the render
// cell's shape, ~31 waves of 8 CTAs on each of the 132 SMs.
//
// Bits.  The gate is the plain form's: (x, y, z) = ((R0 x + R1 y) + R2 z) + t
// with every product and sum rounded on its own (the source is compiled
// with -fmad=false, and the intrinsics say so besides), then
// u = (fx x) / z + cx and v = (fy y) / z + cy with IEEE division; the
// intrinsics, margins and depth limit arrive rounded to float32 as PyTorch
// rounds a Python scalar for a float32 tensor.  project_pixels divides by
// safe_divisor(z), which differs from z only where |z| < 1e-12, and there
// the gate z > 1 fails whatever u and v are, so the kernel divides by z.
// NaN fails every comparison, as in torch.  T_inv (world to camera, f32[4,4],
// row-major) is read from device memory: no host read.

#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;  // slots one pass of a CTA covers

// The launch's arguments, outside the anonymous namespace so the C entry
// point can name it; the wrapper's _Args mirrors it field for field.
struct VisibleBlocksArgs {
  const float* px;      // f32[n]
  const float* py;
  const float* pz;
  const float* conf;
  const float* t_inv;   // f32[4, 4]
  unsigned char* out;   // bool[n / block]
  long long n;          // slots, a whole number of blocks
  int block;            // slots per block: a divisor of kTile that 4 divides, or a multiple of it
  int vec;              // 1: the four columns are 16-byte aligned
  float fx, fy, cx, cy;
  float max_depth;
  float u_lo, u_hi, v_lo, v_hi;  // -margin, W + margin, -margin, H + margin
};

namespace {

__device__ __forceinline__ float affine_row(const float* r, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)), r[3]);
}

__device__ __forceinline__ bool visible(const VisibleBlocksArgs& a, const float* T, float x,
                                        float y, float z, float c) {
  const float xc = affine_row(T, x, y, z);
  const float yc = affine_row(T + 4, x, y, z);
  const float zc = affine_row(T + 8, x, y, z);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(a.fx, xc), zc), a.cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(a.fy, yc), zc), a.cy);
  return (c > 0.0f) & (zc > 1.0f) & (zc < a.max_depth) & (u >= a.u_lo) & (u <= a.u_hi) &
         (v >= a.v_lo) & (v <= a.v_hi);
}

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ p, long long i, float (&r)[4]) {
  if (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = __ldg(p + i + k);
  }
}

// Whether any of the slots i .. i + 3 is visible.
template <bool kVec>
__device__ __forceinline__ bool visible4(const VisibleBlocksArgs& a, const float* T, long long i) {
  float x[4], y[4], z[4], c[4];
  load4<kVec>(a.px, i, x);
  load4<kVec>(a.py, i, y);
  load4<kVec>(a.pz, i, z);
  load4<kVec>(a.conf, i, c);
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) any |= visible(a, T, x[k], y[k], z[k], c[k]);
  return any;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
visible_blocks_kernel(const __grid_constant__ VisibleBlocksArgs a) {
  __shared__ float T[12];
  __shared__ unsigned char hit[kTile / 4];  // small blocks: one flag per block of the tile
  const int tid = threadIdx.x;
  const int per_tile = a.block < kTile ? kTile / a.block : 1;
  if (tid < 12) T[tid] = a.t_inv[tid];
  if (tid < per_tile) hit[tid] = 0;
  __syncthreads();
  if (a.block >= kTile) {
    const long long base = static_cast<long long>(blockIdx.x) * a.block + 4 * tid;
    int any = 0;
    for (int off = 0; off < a.block && !any; off += kTile)
      any = __syncthreads_or(visible4<kVec>(a, T, base + off));
    if (tid == 0) a.out[blockIdx.x] = any != 0;
    return;
  }
  const long long i = static_cast<long long>(blockIdx.x) * kTile + 4 * tid;
  const bool v = i < a.n && visible4<kVec>(a, T, i);
  const int lb = 4 * tid / a.block;  // this thread's block within the tile
  if (a.block >= 4 * 32) {           // a warp's 128 slots lie in one block
    if (__any_sync(0xffffffffu, v) && (tid & 31) == 0) hit[lb] = 1;
  } else if (v) {
    hit[lb] = 1;
  }
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * per_tile + tid;
  if (tid < per_tile && g < a.n / a.block) a.out[g] = hit[tid];
}

}  // namespace

extern "C" int visible_blocks_args_size() { return static_cast<int>(sizeof(VisibleBlocksArgs)); }

extern "C" int visible_blocks_tile() { return kTile; }

extern "C" int visible_blocks_launch(const VisibleBlocksArgs* a, void* stream) {
  const int B = a->block;
  const bool whole = B >= kTile ? B % kTile == 0 : B >= 4 && B % 4 == 0 && kTile % B == 0;
  if (!whole || a->n < B || a->n % B != 0) return cudaErrorInvalidValue;
  const long long ctas = B >= kTile ? a->n / B : (a->n + kTile - 1) / kTile;
  if (ctas > 0x7fffffffll) return cudaErrorInvalidValue;
  const auto kernel = a->vec ? visible_blocks_kernel<true> : visible_blocks_kernel<false>;
  kernel<<<static_cast<unsigned>(ctas), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
