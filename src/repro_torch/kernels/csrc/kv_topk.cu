// Online KV encoder top-k selection for Hopper (sm_90a) (paper Fig. 8b).
//
// Replaces the TPU kernel `kv_topk` (src/repro/kernels/kv_topk.py, `_kernel`):
// per (token, head) vector of D bf16 values, rank_i = #{j : |v_j| > |v_i|}
// + #{j < i : |v_j| == |v_i|} with |v| taken in f32 (so -0 ties +0 and a NaN
// compares false both ways), keep the lanes of rank < keep, and emit
//   * the bitmap of kept positions, D/32 words, bit b of word w = lane
//     w*32+b;
//   * the kept values in position order (the speculation side);
//   * the pruned values in position order (the verification side's raw
//     payload), which the TPU kernel left to a gather outside it.
// Values are moved as bits: a kept -0.0 stays -0.0, as in the reference's
// serving selection (`pruning.select_topk_blocked`); the TPU kernel's one-hot
// product would return +0.0. Kept slots past the kept count and pruned slots
// past the pruned count (both only reachable with NaNs, which rank 0) are 0.
//
// Bound. A vector is read once (2 D bytes) and written once (D/8 + 2 D
// bytes); the selection itself is D log D compares at the least, so the
// kernel is bound by those bytes at 3.35 TB/s. The TPU kernel built the
// D x D compare matrix on 128-lane vectors and compacted with a one-hot
// matmul. Here one warp owns one vector: lane l holds the D/32 values at
// positions i*32 + l, the vector's magnitudes are staged once in shared
// memory, and each lane counts its values' ranks against all D of them
// (broadcast reads, D compares per value). A __ballot_sync per word is the
// bitmap word, and a __popc prefix over the ballots gives each value its
// kept or pruned slot, so the compaction needs no second pass.
// D runs from 32 (one value per lane) to 512 (16 per lane: MLA's latent c,
// 8 KB of staged magnitudes per CTA).
// What this first version leaves out: the O(D^2) compare count (a bitonic
// sort network would take O(D log^2 D)) and fusing the sign|mantissa and
// exponent packing of the kept values into the same pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

template <int DPL>
__global__ void __launch_bounds__(kThreads)
kv_topk_kernel(const uint16_t* __restrict__ v, uint32_t* __restrict__ bitmap,
               uint16_t* __restrict__ kept, uint16_t* __restrict__ pruned,
               int rows, int keep) {
  constexpr int D = DPL * 32;
  __shared__ float mag[kWarps][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;                        // whole warps only
  const uint16_t* vr = v + row * D;
  uint16_t val[DPL];
  float a[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    val[i] = vr[i * 32 + lane];
    a[i] = fabsf(bf16_to_f32(val[i]));
    mag[warp][i * 32 + lane] = a[i];
  }
  __syncwarp();
  int rank[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) rank[i] = 0;
  for (int t = 0; t < D; ++t) {
    const float at = mag[warp][t];
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      rank[i] += (at > a[i]) || (at == a[i] && t < i * 32 + lane);
  }
  const int pruned_w = D - keep;
  const uint32_t below = (1u << lane) - 1u;
  int kbase = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const bool m = rank[i] < keep;
    const uint32_t ball = __ballot_sync(kFull, m);
    if (lane == 0) bitmap[row * DPL + i] = ball;
    const int kidx = kbase + __popc(ball & below);
    const int pidx = i * 32 + lane - kidx;
    if (m) {
      if (kidx < keep) kept[row * keep + kidx] = val[i];
    } else if (pidx < pruned_w) {
      pruned[row * pruned_w + pidx] = val[i];
    }
    kbase += __popc(ball);
  }
  for (int s = kbase + lane; s < keep; s += 32) kept[row * keep + s] = 0;
  for (int s = D - kbase + lane; s < pruned_w; s += 32)
    pruned[row * pruned_w + s] = 0;
}

}  // namespace

// v (rows,D) bf16 -> bitmap (rows,D/32) u32, kept (rows,keep) bf16, pruned
// (rows,D-keep) bf16. Returns cudaGetLastError() after the launch.
extern "C" int kv_topk_launch(const void* v, void* bitmap, void* kept,
                              void* pruned, int rows, int D, int keep,
                              void* stream) {
  if (rows < 0 || keep < 1 || keep > D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  uint32_t* bp = static_cast<uint32_t*>(bitmap);
  uint16_t* kp = static_cast<uint16_t*>(kept);
  uint16_t* pp = static_cast<uint16_t*>(pruned);
  switch (D) {
    case 32: kv_topk_kernel<1><<<blocks, kThreads, 0, s>>>(vp, bp, kp, pp, rows, keep); break;
    case 64: kv_topk_kernel<2><<<blocks, kThreads, 0, s>>>(vp, bp, kp, pp, rows, keep); break;
    case 128: kv_topk_kernel<4><<<blocks, kThreads, 0, s>>>(vp, bp, kp, pp, rows, keep); break;
    case 256: kv_topk_kernel<8><<<blocks, kThreads, 0, s>>>(vp, bp, kp, pp, rows, keep); break;
    case 512: kv_topk_kernel<16><<<blocks, kThreads, 0, s>>>(vp, bp, kp, pp, rows, keep); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
