// Cassandra-1 unary exponent decode for Hopper (sm_90a): the paper's
// Alg. 1 parallel zero counter.
//
// Replaces the TPU kernel `unary_decode` (src/repro/kernels/unary_decode.py,
// `_kernel`): a region of W uint32 words (little-endian bits) holds codes of
// `rank` zeros ended by a one. Code j's rank is pos_j - pos_{j-1} - 1, where
// pos_j is the position of the (j+1)-th set bit (W*32 when the region holds
// fewer) and pos_{-1} = -1, clipped to [0, 31]: the TPU kernel's
// compare-count pos_j = #{p : prefix(p) <= j}, bit for bit, including
// regions that run into the word padding or hold fewer than K ones.
//
// Bound. A region is read once (4 W bytes) and its K ranks written once
// (4 K bytes); the work is a few integer operations per bit, so the kernel
// is bound by those bytes at 3.35 TB/s. The TPU kernel compared every
// prefix entry against every code index (K x 32 W compares per region, on
// 128-lane vectors); on the card one warp decodes one region in one pass:
//   * lane l takes word l of each 32-word chunk; a warp scan of __popc gives
//     the number of ones before its word, i.e. the code index of its first
//     set bit, and a warp max-scan the position of the last set bit before
//     its word, i.e. pos_{j-1} of that first code;
//   * the lane then walks its word's set bits (__ffs), writing one rank per
//     bit, while the index is below K;
//   * the counts carry across chunks (W > 32), and the codes past the
//     region's ones are written last (pos = W*32).
// What this first version leaves out: fusing the decode into its consumer
// (the codebook lookup and the bf16 join of the target reconstruction).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip_rank(int r) { return min(max(r, 0), 31); }

__global__ void __launch_bounds__(kThreads)
unary_decode_kernel(const uint32_t* __restrict__ words,
                    int32_t* __restrict__ out, int rows, int W, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;                        // whole warps only
  const uint32_t* w = words + row * W;
  int32_t* o = out + row * K;
  int base = 0;    // set bits before the current chunk
  int last = -1;   // position of the last set bit before the current chunk
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int wi = c0 + lane;
    const uint32_t x = wi < W ? w[wi] : 0u;
    const int cnt = __popc(x);
    int incl = cnt;                               // inclusive scan of counts
    int lastincl = x ? wi * 32 + 31 - __clz(x) : -1;   // inclusive max-scan
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(kFull, incl, d);
      const int b = __shfl_up_sync(kFull, lastincl, d);
      if (lane >= d) {
        incl += a;
        lastincl = max(lastincl, b);
      }
    }
    int prev = __shfl_up_sync(kFull, lastincl, 1);
    if (lane == 0) prev = -1;
    prev = max(prev, last);
    int idx = base + incl - cnt;
    uint32_t y = x;
    while (y != 0u && idx < K) {
      const int pos = wi * 32 + __ffs(y) - 1;
      o[idx] = clip_rank(pos - prev - 1);
      prev = pos;
      ++idx;
      y &= y - 1u;
    }
    base += __shfl_sync(kFull, incl, 31);
    last = max(last, __shfl_sync(kFull, lastincl, 31));
  }
  // codes past the region's ones: pos = W*32, so the first of them ranks
  // W*32 - last - 1 and the rest -1 (clipped to 0)
  for (int j = base + lane; j < K; j += 32)
    o[j] = j == base ? clip_rank(W * 32 - last - 1) : 0;
}

}  // namespace

// words (rows,W) u32 -> out (rows,K) int32 ranks in [0, 31].
// Returns cudaGetLastError() after the launch.
extern "C" int unary_decode_launch(const void* words, void* out, int rows,
                                   int W, int K, void* stream) {
  if (rows < 0 || W < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  unary_decode_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), rows,
      W, K);
  return static_cast<int>(cudaGetLastError());
}
