// Fused Cassandra-1 draft decode + matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel `draft_matmul` (src/repro/kernels/draft_matmul.py,
// `_kernel` / `_decode_tile`, entry `ops.draft_matmul`): y = x @ W_draft,
// where W_draft is rebuilt on chip from the packed speculation stream and
// never exists densely in device memory. Per 512-value superblock of one
// output column it reads a 16-word bitmap, 40 words of sign|mantissa codes
// (4 bits each at the paper defaults), 30 words of 3-bit exponent-rank codes
// and one int32 block-max exponent: ~348 B against 1024 B of bf16.
//
// Decode semantics are the TPU kernel's exactly (`ops.draft_matmul_rank3_
// oracle`): rank r < 7 maps through the 8-entry book, rank 7 is the C-1T
// escape to the block max exponent, and the kept values are scattered back
// to their bitmap positions. The result is an f32 sum of exact bf16 x bf16
// products (only the summation order differs from the oracle).
//
// Bound: at decode batch sizes (M = B or B*(gamma+1), a few rows) the work is
// ~2*M*nnz flops against the packed bytes, far below the ~295 flop/byte at
// which bf16 tensor cores become the limit, so the kernel is bound by the
// packed bytes it streams (3.35 TB/s on the H100). The design spends no
// tensor cores and aims at keeping enough loads in flight:
//   * The TPU grid (M/tm, N/tn, NB) carried the output tile across a
//     sequential NB axis. Here one thread block owns a tile of output columns
//     for a tile of TM rows and loops over the NB superblocks itself; nothing
//     carries between blocks, so there are no atomics and the sum order is
//     deterministic.
//   * Each column's superblock is split over `block/32` lanes, one bitmap
//     word each. A lane finds the kept index of its first set bit with
//     __popc and a shuffle prefix sum over the column's lanes, then walks its
//     set bits (__ffs), reading codes with two streaming bit readers that
//     start at that index. This gives N*block/32 threads per call, enough to
//     fill the card even for the 1024-column K/V projections.
//   * The TM x block slice of x for the current superblock is staged in
//     shared memory as f32, 33 floats per 32 positions so that the lanes of a
//     column fall on distinct banks.
//   * Partial sums stay in f32 registers and are reduced across the column's
//     lanes with warp shuffles before one store per output.
// The ragged edges of N and M are masked.
// What this first version leaves out, and where its gap to the bound lies:
// the packed words are read with plain loads as each lane's walk needs them
// (no cp.async/TMA stage ahead of the decode), every superblock pays a
// __syncthreads for the x stage, and one column's decode is serial within
// its lane. PERF.md records the measured time beside the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEsc = 7;
constexpr int kChunk = 33;   // 32 positions + 1 pad float per bitmap word
constexpr int kMaxLanes = 16;

// Little-endian bit stream over packed uint32 words (the reference's
// pack_codes layout). Reads only the words the requested codes cover.
struct BitReader {
  const uint32_t* p;
  uint64_t buf;
  int nbits;

  __device__ __forceinline__ void init(const uint32_t* base, int bit0) {
    p = base + (bit0 >> 5);
    const int off = bit0 & 31;
    buf = static_cast<uint64_t>(__ldg(p) >> off);
    nbits = 32 - off;
    ++p;
  }

  __device__ __forceinline__ uint32_t get(int width) {
    if (nbits < width) {
      buf |= static_cast<uint64_t>(__ldg(p)) << nbits;
      nbits += 32;
      ++p;
    }
    const uint32_t v = static_cast<uint32_t>(buf) & ((1u << width) - 1u);
    buf >>= width;
    nbits -= width;
    return v;
  }
};

template <int TM>
__global__ void __launch_bounds__(kThreads)
draft_matmul_kernel(const uint16_t* __restrict__ x,
                    const uint32_t* __restrict__ bitmap,
                    const uint32_t* __restrict__ signmant,
                    const uint32_t* __restrict__ exp3,
                    const int32_t* __restrict__ emax,
                    const int32_t* __restrict__ book,
                    float* __restrict__ y,
                    int M, int K, int N, int NB, int bw_log2, int keep,
                    int trunc, int wsm, int we) {
  __shared__ float xs[TM * kMaxLanes * kChunk];
  __shared__ uint32_t book_s[8];

  const int bw = 1 << bw_log2;             // lanes (bitmap words) per column
  const int block = bw * 32;               // superblock length
  const int lane = threadIdx.x & (bw - 1);
  const int col = blockIdx.x * (kThreads >> bw_log2) + (threadIdx.x >> bw_log2);
  const int m0 = blockIdx.y * TM;
  const bool live = col < N;
  const int t_keep = 7 - trunc;
  const int sm_width = 1 + t_keep;
  const uint32_t mant_mask = (1u << t_keep) - 1u;

  if (threadIdx.x < 8) book_s[threadIdx.x] = static_cast<uint32_t>(book[threadIdx.x]);

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.f;

  for (int sb = 0; sb < NB; ++sb) {
    __syncthreads();                       // previous superblock's reads done
    for (int i = threadIdx.x; i < TM * block; i += kThreads) {
      const int m = i >> (bw_log2 + 5);
      const int k = i & (block - 1);
      float v = 0.f;
      if (m0 + m < M) {
        const uint16_t u = x[static_cast<size_t>(m0 + m) * K
                             + static_cast<size_t>(sb) * block + k];
        v = __uint_as_float(static_cast<uint32_t>(u) << 16);
      }
      xs[(m * bw + (k >> 5)) * kChunk + (k & 31)] = v;
    }
    __syncthreads();

    const size_t cb = static_cast<size_t>(live ? col : 0) * NB + sb;
    uint32_t bits = live ? __ldg(bitmap + cb * bw + lane) : 0u;
    const int cnt = __popc(bits);
    int incl = cnt;                        // inclusive prefix over the lanes
    for (int d = 1; d < bw; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d, bw);
      if (lane >= d) incl += t;
    }
    int j = incl - cnt;                    // kept index of the first set bit
    if (cnt > 0 && j < keep) {
      const uint32_t emx = static_cast<uint32_t>(__ldg(emax + cb));
      BitReader rs, re;
      rs.init(signmant + cb * wsm, j * sm_width);
      re.init(exp3 + cb * we, j * 3);
      const float* xl = xs + lane * kChunk;
      while (bits != 0u && j < keep) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t code = rs.get(sm_width);
        const uint32_t r3 = re.get(3);
        const uint32_t sign = (code >> t_keep) & 1u;
        const uint32_t mant = (code & mant_mask) << trunc;
        const uint32_t e = (r3 == kEsc) ? emx : book_s[r3];
        const uint32_t w16 = (sign << 15) | ((e & 0xFFu) << 7) | (mant & 0x7Fu);
        const float w = __uint_as_float(w16 << 16);
#pragma unroll
        for (int m = 0; m < TM; ++m)
          acc[m] = fmaf(xl[m * bw * kChunk + b], w, acc[m]);
        ++j;
      }
    }
  }

  // reduce the column's lanes (groups of bw aligned inside the warp)
  for (int d = bw >> 1; d >= 1; d >>= 1) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], d, bw);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
      if (m0 + m < M) y[static_cast<size_t>(m0 + m) * N + col] = acc[m];
  }
}

template <int TM>
void launch(const void* x, const void* bitmap, const void* signmant,
            const void* exp3, const void* emax, const void* book, void* y,
            int M, int K, int N, int NB, int bw_log2, int keep, int trunc,
            int wsm, int we, cudaStream_t stream) {
  const int cols = kThreads >> bw_log2;
  dim3 grid((N + cols - 1) / cols, (M + TM - 1) / TM);
  draft_matmul_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint32_t*>(bitmap),
      static_cast<const uint32_t*>(signmant),
      static_cast<const uint32_t*>(exp3), static_cast<const int32_t*>(emax),
      static_cast<const int32_t*>(book), static_cast<float*>(y), M, K, N, NB,
      bw_log2, keep, trunc, wsm, we);
}

}  // namespace

// x (M,K) bf16 · bitmap (N,NB,block/32) · signmant (N,NB,wsm) · exp3
// (N,NB,we) uint32 words · emax (N,NB) int32 · book (8,) int32 -> y (M,N) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cassandra_draft_matmul(const void* x, const void* bitmap,
                                      const void* signmant, const void* exp3,
                                      const void* emax, const void* book,
                                      void* y, int M, int K, int N, int block,
                                      int keep, int trunc, int wsm, int we,
                                      void* stream) {
  int bw_log2 = -1;
  for (int l = 0; l <= 4; ++l)
    if ((32 << l) == block) bw_log2 = l;
  if (bw_log2 < 0 || K % block != 0 || M < 1 || N < 1 || trunc < 0 || trunc > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NB = K / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    launch<4>(x, bitmap, signmant, exp3, emax, book, y, M, K, N, NB, bw_log2,
              keep, trunc, wsm, we, s);
  } else if (M <= 8) {
    launch<8>(x, bitmap, signmant, exp3, emax, book, y, M, K, N, NB, bw_log2,
              keep, trunc, wsm, we, s);
  } else {
    launch<16>(x, bitmap, signmant, exp3, emax, book, y, M, K, N, NB, bw_log2,
               keep, trunc, wsm, we, s);
  }
  return static_cast<int>(cudaGetLastError());
}
