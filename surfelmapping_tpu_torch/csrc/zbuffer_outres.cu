// Output-resident scatter-argmin z-buffer for Hopper (sm_90a): the probe
// kernels that measured the z-buffer on the TPU.
//
// Replaces two TPU kernels that compute one function:
//   tools/probe_pallas_zbuf.py:pallas_zbuf (body make_kernel, lines 35-91),
//     one buffer pair of P_pad = rows * 128 pixels;
//   tools/probe_zbuf_variants.py:outres (body make_outres_kernel, lines
//     23-63), the same with the outputs as the working buffers and one spare
//     row for the pixel num_pix.
// For each pixel it finds the minimum int32 key among the candidates that
// land there, and the smallest candidate index among those with that key
// (the TPU kernels' strict < over ascending indices).  A candidate with key
// INT32_MAX never writes; an empty pixel comes out as (INT32_MAX, INT32_MAX).
// The wrapper (ops/zbuf_outres.py) has checked that every pixel lies in
// [0, n_pix) and that there are fewer than 2^31 candidates.
//
// What bounds it on the H100: bytes.  One compare per candidate, so the least
// time is the 8 B read per candidate (key + pixel) plus the 8 B written per
// pixel (key + id) over 3.35 TB/s.  In practice the 64-bit atomics to L2 set
// its speed.
//
// Design.  The TPU kernels kept the buffers in VMEM, streamed candidates
// through SMEM chunks and did a masked 128-lane row read-modify-write per
// candidate.  None of that carries over.  Here the output is one
// int32[n_pix, 2] tensor whose pair (id, key) is, on a little-endian card,
// the 64-bit word (key << 32) | id.  One signed 64-bit atomicMin per
// candidate goes straight into it: the high word orders by the key as a
// signed int32, exactly the TPU kernels' compare, and the low word breaks ties
// by the smaller index (indices are below 2^31).  Two launches on the
// caller's stream: fill with (INT32_MAX, INT32_MAX), then the scatter.  The
// wrapper hands out the key and id planes as strided views of the output, so
// there is no separate packed buffer and no unpack pass.  An INT32_MAX key
// must be skipped, not merely compared: (INT32_MAX << 32) | i is below the
// empty word for every i < INT32_MAX and would write its id into an empty
// pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalidKey = 0x7FFFFFFF;
constexpr long long kEmpty = 0x7FFFFFFF7FFFFFFFll;
constexpr int kThreads = 256;

__global__ void fill_empty(long long* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = kEmpty;
  }
}

__global__ void scatter_min(const int32_t* __restrict__ zkey,
                            const int32_t* __restrict__ fpix, int64_t A,
                            int64_t n_pix, long long* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < A;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t key = zkey[i];
    const int32_t p = fpix[i];
    if (key == kInvalidKey || p < 0 || p >= n_pix) continue;
    const unsigned long long bits =
        ((unsigned long long)(uint32_t)key << 32) | (uint32_t)i;
    atomicMin(out + p, (long long)bits);
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  // grid-stride beyond ~16 waves of 132 SMs x 8 blocks
  return (int)(b < 16896 ? b : 16896);
}

}  // namespace

extern "C" int zbuffer_outres_launch(const int32_t* zkey, const int32_t* fpix,
                                     int64_t A, int64_t n_pix, long long* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_empty<<<blocks_for(n_pix), kThreads, 0, s>>>(out, n_pix);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (A > 0) {
    scatter_min<<<blocks_for(A), kThreads, 0, s>>>(zkey, fpix, A, n_pix, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
