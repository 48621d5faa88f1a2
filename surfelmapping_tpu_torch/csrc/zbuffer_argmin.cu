// Scatter-argmin z-buffer for Hopper (sm_90a): the index map's depth test.
//
// Replaces the TPU kernel surfelmapping_tpu/ops/pallas_zbuf.py:zbuffer_argmin
// (body _make_kernel, lines 105-182).  For each of P pixels it finds the
// minimum depth key among the candidates that land there, and the smallest
// candidate index among those with that key.  Only candidates below the
// device-resident bound n_valid are read; a key of INT32_MAX (invalid) or a
// pixel >= P (discard) never writes; an empty pixel comes out as
// (INT32_MAX, INT32_MAX).
//
// What bounds it on the H100: bytes.  It does one compare per candidate, so
// the least time is the 8 B read per valid candidate (key + pixel) plus the
// 8 B written per pixel (key + id) over 3.35 TB/s.  In practice the 64-bit
// atomics to L2 set its speed.
//
// Design.  The TPU kernel kept the buffers in VMEM and walked candidates one
// scalar at a time with replicated buffers for instruction-level parallelism.
// None of that carries over.  Here the key and the index are packed into one
// 64-bit word, (key << 32) | index, so that one atomicMin orders by key and
// breaks ties by the smaller index, exactly the TPU kernel's strict-< rule
// over ascending ids.  Keys are the bits of positive floats, so they are
// non-negative and compare as unsigned.  Three launches on the caller's
// stream: fill the packed buffer with (INT32_MAX, INT32_MAX), one thread per
// candidate (grid-stride) does the atomicMin, then split the words into the
// two int32 outputs.  An invalid candidate must be skipped, not merely
// compared: (INT32_MAX << 32) | i is below the empty value for every
// i < INT32_MAX and would write its id into an empty pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalidKey = 0x7FFFFFFF;
constexpr unsigned long long kEmpty = 0x7FFFFFFF7FFFFFFFull;
constexpr int kThreads = 256;

__global__ void fill_empty(unsigned long long* __restrict__ packed, int64_t P) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < P;
       i += (int64_t)gridDim.x * blockDim.x) {
    packed[i] = kEmpty;
  }
}

__global__ void scatter_min(const int32_t* __restrict__ zkey,
                            const int32_t* __restrict__ fpix,
                            const int32_t* __restrict__ n_valid, int64_t A,
                            int64_t P, unsigned long long* __restrict__ packed) {
  int64_t nv = *n_valid;
  nv = nv < 0 ? 0 : (nv > A ? A : nv);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nv;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t key = zkey[i];
    const int32_t p = fpix[i];
    if (key == kInvalidKey || p < 0 || p >= P) continue;
    const unsigned long long v =
        ((unsigned long long)(uint32_t)key << 32) | (uint32_t)i;
    atomicMin(packed + p, v);
  }
}

__global__ void unpack(const unsigned long long* __restrict__ packed, int64_t P,
                       int32_t* __restrict__ zbuf, int32_t* __restrict__ idbuf) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < P;
       i += (int64_t)gridDim.x * blockDim.x) {
    const unsigned long long v = packed[i];
    zbuf[i] = (int32_t)(v >> 32);
    idbuf[i] = (int32_t)(v & 0xFFFFFFFFull);
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  // grid-stride beyond ~16 waves of 132 SMs x 8 blocks
  return (int)(b < 16896 ? b : 16896);
}

}  // namespace

extern "C" int zbuffer_argmin_launch(const int32_t* zkey, const int32_t* fpix,
                                     const int32_t* n_valid, int64_t A, int64_t P,
                                     unsigned long long* packed, int32_t* zbuf,
                                     int32_t* idbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_empty<<<blocks_for(P), kThreads, 0, s>>>(packed, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (A > 0) {
    scatter_min<<<blocks_for(A), kThreads, 0, s>>>(zkey, fpix, n_valid, A, P, packed);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  unpack<<<blocks_for(P), kThreads, 0, s>>>(packed, P, zbuf, idbuf);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
