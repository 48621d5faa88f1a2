// Scatter-argmin z-buffer for Hopper (sm_90a): the index map's depth test
// and the fast renderer's centre buffers.
//
// Replaces the TPU kernel surfelmapping_tpu/ops/pallas_zbuf.py:zbuffer_argmin
// (body _make_kernel, lines 105-182).  For each of P pixels it finds the
// minimum int32 depth key among the candidates that land there, and the
// smallest candidate index among those with that key.  Only candidates below
// the device-resident bound n_valid are read (all A when the wrapper passes
// no bound); a key of INT32_MAX (invalid) or a pixel outside [0, P) never
// writes; an empty pixel comes out as (INT32_MAX, INT32_MAX).
//
// What bounds it on the H100: bytes.  It does one compare per candidate, so
// the least time is the 8 B read per valid candidate (key + pixel) plus the
// 8 B written per pixel (key + id) over 3.35 TB/s.  In practice the 64-bit
// atomics to L2 set its speed.
//
// Design.  The TPU kernel kept the buffers in VMEM and walked candidates one
// scalar at a time with replicated buffers for instruction-level parallelism.
// None of that carries over.  The output is resident: one int64[P] buffer of
// packed words (key << 32) | id, which the wrapper hands out as it is (the
// renderer's dilation takes packed words) and as two strided int32 views,
// the key and id planes of the little-endian words.  Two launches on the
// caller's stream: one fill with INT32_MAX in both halves, and one scatter of
// a signed 64-bit atomicMin per candidate.  The high word orders by the key
// as a signed int32 and the low word breaks ties by the smaller index
// (indices are below 2^31): exactly the TPU kernel's strict < over ascending
// ids.  The scatter uses 32-bit indexing (the wrapper checks A, P < 2^31) and
// loads four keys and four pixels per thread as two 16-byte loads when both
// arrays are 16-byte aligned.  An invalid key must be skipped, not merely
// compared: (INT32_MAX << 32) | i is below the empty word for every
// i < INT32_MAX and would write its id into an empty pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalidKey = 0x7FFFFFFF;
constexpr long long kEmpty = 0x7FFFFFFF7FFFFFFFll;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond ~16 blocks per SM

__global__ void fill_empty(longlong2* __restrict__ out2, long long* __restrict__ out,
                           int P) {
  const int n2 = P >> 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n2; i += gridDim.x * blockDim.x)
    out2[i] = make_longlong2(kEmpty, kEmpty);
  if ((P & 1) && blockIdx.x == 0 && threadIdx.x == 0) out[P - 1] = kEmpty;
}

__device__ __forceinline__ void candidate(int32_t key, int32_t p, int i, int P,
                                          long long* __restrict__ out) {
  if (key == kInvalidKey || (uint32_t)p >= (uint32_t)P) return;
  const unsigned long long bits = ((unsigned long long)(uint32_t)key << 32) | (uint32_t)i;
  atomicMin(out + p, (long long)bits);
}

// vec4: the first n_valid / 4 groups of four candidates go through 16-byte
// loads, the rest one at a time; otherwise every candidate one at a time.
__global__ void scatter_min(const int32_t* __restrict__ zkey,
                            const int32_t* __restrict__ fpix,
                            const int32_t* __restrict__ n_valid, int A, int P, bool vec4,
                            long long* __restrict__ out) {
  int nv = A;
  if (n_valid != nullptr) {
    nv = *n_valid;
    nv = nv < 0 ? 0 : (nv > A ? A : nv);
  }
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = vec4 ? nv >> 2 : 0;
  const int4* __restrict__ zkey4 = reinterpret_cast<const int4*>(zkey);
  const int4* __restrict__ fpix4 = reinterpret_cast<const int4*>(fpix);
  for (int q = t0; q < n4; q += stride) {
    const int4 k = zkey4[q];
    const int4 p = fpix4[q];
    const int i = q << 2;
    candidate(k.x, p.x, i, P, out);
    candidate(k.y, p.y, i + 1, P, out);
    candidate(k.z, p.z, i + 2, P, out);
    candidate(k.w, p.w, i + 3, P, out);
  }
  for (int i = (n4 << 2) + t0; i < nv; i += stride) candidate(zkey[i], fpix[i], i, P, out);
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// n_valid: a device int32 scalar, or null for all A candidates.
extern "C" int zbuffer_argmin_launch(const int32_t* zkey, const int32_t* fpix,
                                     const int32_t* n_valid, int A, int P,
                                     long long* packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_empty<<<blocks_for(P / 2 + 1), kThreads, 0, s>>>(
      reinterpret_cast<longlong2*>(packed), packed, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (A > 0) {
    const bool vec4 = ((reinterpret_cast<uintptr_t>(zkey) | reinterpret_cast<uintptr_t>(fpix)) & 15) == 0;
    scatter_min<<<blocks_for(vec4 ? A / 4 + 3 : A), kThreads, 0, s>>>(
        zkey, fpix, n_valid, A, P, vec4, packed);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
