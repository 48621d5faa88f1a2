// Binned shared-memory scatter-argmin z-buffer for Hopper (sm_90a): the probe
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
// INT32_MAX, or with a pixel outside [0, n_pix), never writes; an empty pixel
// comes out as (INT32_MAX, INT32_MAX).  The wrapper's plan
// (ops/zbuf_outres.py:outres_plan) is the one check of the sizes: fewer than
// 2^31 candidates, a tile of 2^10 to 2^14 pixels, at most 12,000 tiles; it
// sizes the scratch for the span kSpan below.
//
// What bounds it on the H100: bytes.  One compare per candidate, so the least
// time is the 8 B read per candidate (key + pixel) plus the 8 B written per
// pixel (key + id) over 3.35 TB/s.
//
// Design.  The TPU kernels kept the whole buffer pair in VMEM, streamed
// candidates through SMEM chunks and did a masked 128-lane row
// read-modify-write per candidate: possible because VMEM holds megabytes.  A
// block on Hopper has at most 227 KB of shared memory, so the buffer is cut
// into tiles of T pixels that fit one block's shared memory (T a power of two
// from 1024 to 16384, chosen by the plan), and the candidates are binned by
// tile first.  Two launches on the caller's stream, and no global atomic:
//   bin      one block per span of kSpan = 8192 candidates (16 per
//            thread, 512 threads).  It reads
//            its span with 16-byte loads where both arrays are aligned,
//            counts its candidates per tile in shared memory (one shared
//            atomicAdd per run of one tile among a thread's 16), scans the
//            counts, writes its segment offsets to the table
//            starts[(tiles + 1) x blocks] (tile-major, so a tile's row is
//            contiguous for the resolve pass; the last row holds each block's
//            count), sorts its span by tile in shared memory and writes it to
//            its own span of the entry scratch as one contiguous run of
//            16-byte stores.  An entry is one 64-bit word: key << 32 |
//            (index within the span) << log2(T) | pixel within the tile.  No
//            scan runs across blocks: each block's segments stay in its span.
//   resolve  one block per tile: fill the tile with the empty word in shared
//            memory, walk the tile's segments of every bin block, four
//            consecutive entries per thread (one binary search over the
//            segment offsets, then a walk across segment ends), apply each
//            entry as a shared 64-bit atomicMin of (key << 32) | id after a
//            plain read shows that it can win, and write the tile out once
//            with 16-byte stores.  It is launched with programmatic
//            dependent launch, triggered as each bin block finishes, and
//            waits (griddepcontrol.wait) after its fill.  A trigger at the
//            start of bin lets early resolve blocks crowd onto the SMs that
//            bin leaves idle.
// The high word of (key << 32) | id orders by the key as a signed int32,
// exactly the TPU kernels' compare, and the low word breaks ties by the
// smaller index (indices are below 2^31).  So the result does not depend on
// the order of a segment or of the atomics: it is bit for bit the function.
// sm_90a has no native 64-bit shared atomicMin: it compiles to a
// compare-and-store loop (ATOMS.CAST.SPIN.64).  The other exact form, two
// native 32-bit mins (ATOMS.MIN.S32: the key, a barrier, then the id where
// the key won), needs each entry twice.  Built and timed against this one
// on the H100 (tools/zbuf_ab, PERF.md), it was slower in every order: by
// 1% on random candidates, 5-7% in block order and 1.9x when every
// candidate lands in one tile, where one SM reads the 2^20 entries twice.
// So the loop stays; the plain read before it skips most losers.
//
// What this does about the atomics.  The first port did one fill and one
// random 64-bit atomicMin per candidate into L2: every written pixel saw a
// store and then an atomic read-modify-write, and L2's atomic units set the
// pace.  Here every output pixel is written once, from shared memory, with
// no separate fill, and every atomic is a shared-memory one.  The price is
// the bucket round trip: 8 B written per valid candidate by bin and 8 B read
// back by resolve, and the segment table (4 (tiles + 1) B per bin block,
// written once and read once): at A = 2^20 and 443 tiles, 8 MB + 8 MB +
// 0.45 MB, all of it inside the 50 MB L2, in streaming accesses instead of
// 2^20 random L2 atomics.  Bytes moved per call: 8 A read and 8 A + 4 (tiles
// + 1) blocks written by bin, the same read by resolve, and 8 n_pix written,
// against the bound's 8 A + 8 n_pix.  PERF.md has its times beside the
// atomic design's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInvalidKey = 0x7FFFFFFF;
constexpr long long kEmpty = 0x7FFFFFFF7FFFFFFFll;
constexpr int kSpanLog2 = 13;    // candidates per bin block: the plan's SPAN
constexpr int kSpan = 1 << kSpanLog2;
constexpr int kPerThread = 16;   // candidates per bin thread: four groups of four
constexpr int kGroups = kPerThread / 4;
constexpr int kBinThreads = kSpan / kPerThread;
constexpr int kResolveThreads = 512;
constexpr int kChunk = 512;      // bin blocks whose segments resolve tables at once
constexpr int kRun = 4;          // consecutive entries of a tile per resolve thread

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Exclusive prefix sum in place over a[0, n); every thread of the block calls
// it and gets the total.  It begins and ends with a barrier.
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  __syncthreads();
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;  // inclusive scan over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[n_warps - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// One candidate of a bin thread: its tile (-1 if it never writes) and its
// entry word.
__device__ __forceinline__ void classify(int32_t key, int32_t p, int local, int n_pix,
                                         int tile_log2, int& tile,
                                         unsigned long long& word) {
  const bool valid = key != kInvalidKey && (uint32_t)p < (uint32_t)n_pix;
  tile = valid ? (p >> tile_log2) : -1;
  word = ((unsigned long long)(uint32_t)key << 32) |
         (((uint32_t)local << tile_log2) | ((uint32_t)p & ((1u << tile_log2) - 1u)));
}

// Thread g of block b holds the candidates 4 (k * blockDim + g) + e of the
// block's span, k < 4, e < 4: each of its four loads is one coalesced 16-byte
// load across the block.
__global__ void __launch_bounds__(kBinThreads) bin_candidates(
    const int32_t* __restrict__ zkey, const int32_t* __restrict__ fpix, int A, int n_pix,
    int tile_log2, int tiles, bool vec4, unsigned long long* __restrict__ entries,
    int32_t* __restrict__ starts) {
  extern __shared__ unsigned long long stage[];  // the span's entries, sorted by tile
  int32_t* counts = reinterpret_cast<int32_t*>(stage + kSpan);  // per tile
  __shared__ int32_t warp_sums[32];
  const int nb = gridDim.x, b = blockIdx.x;
  const int base = b << kSpanLog2;
  const int n = min(A - base, kSpan);
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) counts[t] = 0;

  int tile[kPerThread];
  unsigned long long word[kPerThread];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int q = k * blockDim.x + threadIdx.x;
    int kk[4], pp[4];
    if (vec4 && 4 * q + 3 < n) {
      const int4 k4 = reinterpret_cast<const int4*>(zkey + base)[q];
      const int4 p4 = reinterpret_cast<const int4*>(fpix + base)[q];
      kk[0] = k4.x; kk[1] = k4.y; kk[2] = k4.z; kk[3] = k4.w;
      pp[0] = p4.x; pp[1] = p4.y; pp[2] = p4.z; pp[3] = p4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        kk[e] = j < n ? zkey[base + j] : kInvalidKey;
        pp[e] = j < n ? fpix[base + j] : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      classify(kk[e], pp[e], 4 * q + e, n_pix, tile_log2, tile[4 * k + e], word[4 * k + e]);
  }
  // len[k]: candidates from k to the end of its run of one tile
  int len[kPerThread];
#pragma unroll
  for (int k = kPerThread - 1; k >= 0; --k)
    len[k] = (k + 1 < kPerThread && tile[k + 1] == tile[k]) ? len[k + 1] + 1 : 1;

  __syncthreads();  // counts zeroed
  bool head[kPerThread];  // the first of a run of one valid tile
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) head[k] = tile[k] >= 0 && (k == 0 || tile[k - 1] != tile[k]);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (head[k]) atomicAdd(&counts[tile[k]], len[k]);
  const int count = block_exclusive_scan(counts, tiles, warp_sums);
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    starts[(size_t)t * nb + b] = counts[t];
  if (threadIdx.x == 0) starts[(size_t)tiles * nb + b] = count;
  __syncthreads();  // offsets read before the cursors move

  int at[kPerThread];  // every run's place, its atomics issued back to back
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) at[k] = head[k] ? atomicAdd(&counts[tile[k]], len[k]) : 0;
  int pos = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    pos = head[k] ? at[k] : pos + 1;
    if (tile[k] >= 0) stage[pos] = word[k];
  }
  __syncthreads();
  // the sorted span goes out as one contiguous run of 16-byte stores
  const ulonglong2* __restrict__ src2 = reinterpret_cast<const ulonglong2*>(stage);
  ulonglong2* __restrict__ dst2 = reinterpret_cast<ulonglong2*>(entries + base);
  for (int i = threadIdx.x; i < count / 2; i += blockDim.x) dst2[i] = src2[i];
  if ((count & 1) && threadIdx.x == 0) entries[base + count - 1] = stage[count - 1];
  launch_dependents();  // the resolve blocks may take this block's place
}

__global__ void __launch_bounds__(kResolveThreads) resolve_tiles(
    const unsigned long long* __restrict__ entries, const int32_t* __restrict__ starts,
    int nb, int tile_log2, int n_pix, long long* __restrict__ out) {
  extern __shared__ long long zb[];  // the tile's T words, then the segment table
  __shared__ int32_t warp_sums[32];
  const int T = 1 << tile_log2;
  int* seg_base = reinterpret_cast<int*>(zb + T);  // first entry of each segment
  int* seg_off = seg_base + kChunk;  // segment lengths, then their offsets and the total
  const int t = blockIdx.x;
  const int n_here = min(T, n_pix - (t << tile_log2));
  longlong2* zb2 = reinterpret_cast<longlong2*>(zb);
  for (int i = threadIdx.x; i < T / 2; i += blockDim.x) zb2[i] = make_longlong2(kEmpty, kEmpty);
  wait_for_prerequisites();  // the bin pass has finished and its writes are visible

  for (int c0 = 0; c0 < nb; c0 += kChunk) {
    const int m = min(kChunk, nb - c0);
    for (int s = threadIdx.x; s < m; s += blockDim.x) {
      const int b = c0 + s;
      const int lo = starts[(size_t)t * nb + b], hi = starts[(size_t)(t + 1) * nb + b];
      seg_base[s] = (b << kSpanLog2) + lo;
      seg_off[s] = hi - lo;
    }
    const int total = block_exclusive_scan(seg_off, m, warp_sums);
    if (threadIdx.x == 0) seg_off[m] = total;
    __syncthreads();
    // thread by run of kRun consecutive entries of the tile, in segment order:
    // one search for the run's first segment, then a walk across segment ends
    for (int j0 = threadIdx.x * kRun; j0 < total; j0 += blockDim.x * kRun) {
      int s = 0, hi = m - 1;  // the last segment whose offset is at most j0
      while (s < hi) {
        const int mid = (s + hi + 1) >> 1;
        if (seg_off[mid] <= j0) s = mid;
        else hi = mid - 1;
      }
      unsigned long long e[kRun];
      uint32_t id0[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int j = min(j0 + k, total - 1);
        while (seg_off[s + 1] <= j) ++s;
        e[k] = entries[seg_base[s] + (j - seg_off[s])];
        id0[k] = (uint32_t)((c0 + s) << kSpanLog2);
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (j0 + k >= total) break;
        const uint32_t low = (uint32_t)e[k];
        const long long w =
            (long long)((e[k] & 0xFFFFFFFF00000000ull) | (id0[k] + (low >> tile_log2)));
        long long* slot = zb + (low & (uint32_t)(T - 1));
        if (w < *reinterpret_cast<volatile long long*>(slot)) atomicMin(slot, w);
      }
    }
    __syncthreads();  // this chunk's table is consumed before the next is loaded
  }
  __syncthreads();

  long long* dst = out + ((size_t)t << tile_log2);
  longlong2* dst2 = reinterpret_cast<longlong2*>(dst);
  for (int i = threadIdx.x; i < n_here / 2; i += blockDim.x) dst2[i] = zb2[i];
  if ((n_here & 1) && threadIdx.x == 0) dst[n_here - 1] = zb[n_here - 1];
}

}  // namespace

// entries: int64 scratch of A words; starts: int32 scratch of
// (tiles + 1) * ceil(A / kSpan) values; out: int64[n_pix], 16-byte aligned;
// tiles = ceil(n_pix / 2^tile_log2) > 0.  The sizes are the plan's
// (ops/zbuf_outres.py:outres_plan).
extern "C" int zbuffer_outres_launch(const int32_t* zkey, const int32_t* fpix, int A,
                                     int n_pix, int tile_log2, unsigned long long* entries,
                                     int32_t* starts, long long* out, void* stream) {
  const int tiles = (int)(((long long)n_pix + (1 << tile_log2) - 1) >> tile_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)(((long long)A + kSpan - 1) >> kSpanLog2);
  if (nb > 0) {
    const bool vec4 =
        ((reinterpret_cast<uintptr_t>(zkey) | reinterpret_cast<uintptr_t>(fpix)) & 15) == 0;
    const size_t smem = (size_t)8 * kSpan + (size_t)tiles * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(bin_candidates,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    bin_candidates<<<nb, kBinThreads, smem, s>>>(zkey, fpix, A, n_pix, tile_log2, tiles, vec4,
                                                 entries, starts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = ((size_t)8 << tile_log2) + (2 * kChunk + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(resolve_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kResolveThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, resolve_tiles, (const unsigned long long*)entries,
                                     (const int32_t*)starts, nb, tile_log2, n_pix, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
