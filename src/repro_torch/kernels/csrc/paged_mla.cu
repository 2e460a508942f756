// Paged MLA decode attention in latent space for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_mla` of src/repro/kernels/paged_attention.py
// (`_mla_kernel`, step `_mla_block`): a flash walk over each row's (B, MB)
// block table into bf16 pools of the MLA latent c (NB, BS, L) and rope key
// kr (NB, BS, R), under the row's `length` mask, with absorbed math:
//   s   = (q_eff . c + q_rope . kr) * scale      per (head, query, token)
//   acc = sum softmax(s) * c                     (c is the key AND the value)
// q_eff (B, T, H, L) f32 is q_nope absorbed through w_uk; q_rope (B, T, H, R)
// f32. Returns the unnormalised flash state acc (B, H, T, L), m and l
// (B, H, T), all f32; the caller folds the scratch/new-token suffix in
// (`merge_mla_suffix`) and applies w_uv.
//
// Bound. A launch reads each row's `length` latent rows once ((L + R) bf16
// per token, shared by all H heads), q_eff/q_rope once and writes acc, m, l
// once. At DeepSeek-V3's widths (H = 128, L = 512, R = 64) the query side
// dominates the bytes at decode lengths (q_eff and acc are 256 KB per query
// position each), while the work is 2(L + R) + 2L flops per head, query and
// token: thousands of flops per pool byte, so the kernel is bound by its
// operations. This version does them as f32 FMAs on the CUDA cores.
//
// Design (simple and right first):
//   * The TPU grid (B, MB) held all H heads of a row in one step and carried
//     the flash state across a sequential MB axis; one row's f32 acc is
//     H * T * L * 4 B = 256 KB per query position, more than an SM's shared
//     memory. Here one CTA owns (row b, a tile of 16 of the H*T (head, query)
//     pairs) and walks the row's table entries 0.. itself, in order: the
//     state accumulates in the reference's block order, with no atomics.
//     Blocks past the row's length are skipped: an all-masked flash step is
//     an exact no-op (corr = exp(0) = 1, p = 0).
//   * Each block's c (BS <= 32 tokens x L bf16) and kr rows are staged in
//     shared memory once per CTA and read by all its query pairs. Rows past
//     the length are staged as zeros and never read (a NaN in an unwritten or
//     trash slot never reaches acc, as the reference's zeroing ensures).
//   * Each warp owns two query pairs; each lane holds L/32 dims of q_eff and
//     of acc, in runs of up to 8 (one 16-byte shared load), and up to 4 rope
//     dims. A score is a warp-shuffle reduction; lane s keeps key s's score,
//     so the block max, p and the row sum are warp reductions too. The
//     online softmax runs in f32 registers, in the reference's form: scores
//     masked to -1e30, p = 0 by select, m from -1e30, l from 0, expf.
//   * Table entries outside [0, NB) read block 0, the trash block.
// What this first version leaves out: the blocks are read with plain loads
// as the walk reaches them (no cp.async/TMA stage ahead), every head tile of
// a row re-reads the row's blocks (from L2), and the products run on the
// CUDA cores, not the tensor cores (an mma over the 16 query pairs x BS
// tokens would). PERF.md records the measured times beside the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kQTile = kWarps * kRowsPerWarp;   // (head, query) pairs per CTA
constexpr int kMaxBS = 32;
constexpr int kMaxL = 512;
constexpr int kMaxR = 128;
constexpr int kRPL = kMaxR / 32;                 // rope dims per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Walk {
  const float* q_eff;         // (B, T, H, L)
  const float* q_rope;        // (B, T, H, R)
  const uint16_t* c_pool;     // (NB, BS, L) bf16
  const uint16_t* kr_pool;    // (NB, BS, R) bf16
  const int32_t* table;       // (B, MB)
  const int32_t* length;      // (B,)
  float* acc;                 // (B, H, T, L)
  float* m;                   // (B, H, T)
  float* l;
  int B, T, H, L, R, NB, BS, MB;
  float scale;
};

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// VEC consecutive bf16 values (VEC * 2 bytes, aligned) as f32.
template <int VEC>
__device__ __forceinline__ void load_run(const uint16_t* p, float* out) {
  if constexpr (VEC == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else if constexpr (VEC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xFFFF0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else if constexpr (VEC == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(v << 16);
    out[1] = __uint_as_float(v & 0xFFFF0000u);
  } else {
    out[0] = bf16_to_f32(p[0]);
  }
}

// Lane `lane` holds latent dims (k * 32 + lane) * VEC + j, k < NV, j < VEC.
template <int DPL>
__global__ void __launch_bounds__(kThreads) paged_mla_kernel(Walk w) {
  constexpr int L = DPL * 32;
  constexpr int VEC = DPL < 8 ? DPL : 8;
  constexpr int NV = DPL / VEC;
  __shared__ __align__(16) uint16_t cs[kMaxBS * kMaxL];
  __shared__ __align__(16) uint16_t krs[kMaxBS * kMaxR];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ht = w.H * w.T, R = w.R;

  float q[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL], qr[kRowsPerWarp][kRPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qrow[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = blockIdx.y * kQTile + warp * kRowsPerWarp + i;
    qrow[i] = r < ht ? r : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kRPL; ++c) qr[i][c] = 0.f;
    if (qrow[i] >= 0) {
      const int h = r / w.T, t = r % w.T;
      const size_t qoff = ((size_t)b * w.T + t) * w.H + h;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          q[i][k * VEC + j] = w.q_eff[qoff * L + (k * 32 + lane) * VEC + j];
#pragma unroll
      for (int c = 0; c < kRPL; ++c)
        if (lane + 32 * c < R) qr[i][c] = w.q_rope[qoff * R + lane + 32 * c];
    }
  }

  const int len = w.length[b];
  const int n_blocks = len > 0 ? min(w.MB, (len + w.BS - 1) / w.BS) : 0;
  for (int jb = 0; jb < n_blocks; ++jb) {
    int blk = w.table[(size_t)b * w.MB + jb];
    if (blk < 0 || blk >= w.NB) blk = 0;                   // trash block
    const int nvalid = min(w.BS, len - jb * w.BS);
    __syncthreads();                    // the previous block's tiles are used
    constexpr int kChunks = L / 8;                         // 16 B per chunk
    for (int idx = threadIdx.x; idx < w.BS * kChunks; idx += kThreads) {
      const int s = idx / kChunks, c8 = idx % kChunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < nvalid)
        v = *reinterpret_cast<const uint4*>(
            w.c_pool + ((size_t)blk * w.BS + s) * L + c8 * 8);
      *reinterpret_cast<uint4*>(cs + s * L + c8 * 8) = v;
    }
    for (int idx = threadIdx.x; idx < w.BS * R; idx += kThreads) {
      const int s = idx / R;
      krs[idx] = s < nvalid ? w.kr_pool[((size_t)blk * w.BS + s) * R + idx % R]
                            : static_cast<uint16_t>(0);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (qrow[i] < 0) continue;                           // warp-uniform
      float sc = kNegInf;                                  // lane s: key s
      for (int s = 0; s < nvalid; ++s) {
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float cd[VEC];
          load_run<VEC>(cs + s * L + (k * 32 + lane) * VEC, cd);
#pragma unroll
          for (int j = 0; j < VEC; ++j) part += q[i][k * VEC + j] * cd[j];
        }
#pragma unroll
        for (int c = 0; c < kRPL; ++c)
          if (lane + 32 * c < R)
            part += qr[i][c] * bf16_to_f32(krs[s * R + lane + 32 * c]);
        part = warp_sum(part);
        if (lane == s) sc = part * w.scale;
      }
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = lane < nvalid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      for (int s = 0; s < nvalid; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float cd[VEC];
          load_run<VEC>(cs + s * L + (k * 32 + lane) * VEC, cd);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][k * VEC + j] += ps * cd[j];
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qrow[i] < 0) continue;
    const int h = qrow[i] / w.T, t = qrow[i] % w.T;
    const size_t st = ((size_t)b * w.H + h) * w.T + t;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        w.acc[st * L + (k * 32 + lane) * VEC + j] = acc[i][k * VEC + j];
    if (lane == 0) {
      w.m[st] = m[i];
      w.l[st] = l[i];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take, without launching).
extern "C" int paged_mla_launch(const void* q_eff, const void* q_rope,
                                const void* c_pool, const void* kr_pool,
                                const void* table, const void* length,
                                void* acc, void* m, void* l, int B, int T,
                                int H, int L, int R, int NB, int BS, int MB,
                                float scale, void* stream) {
  if (BS < 1 || BS > kMaxBS || R < 1 || R > kMaxR || B < 0 || T < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk w{};
  w.q_eff = static_cast<const float*>(q_eff);
  w.q_rope = static_cast<const float*>(q_rope);
  w.c_pool = static_cast<const uint16_t*>(c_pool);
  w.kr_pool = static_cast<const uint16_t*>(kr_pool);
  w.table = static_cast<const int32_t*>(table);
  w.length = static_cast<const int32_t*>(length);
  w.acc = static_cast<float*>(acc);
  w.m = static_cast<float*>(m);
  w.l = static_cast<float*>(l);
  w.B = B; w.T = T; w.H = H; w.L = L; w.R = R;
  w.NB = NB; w.BS = BS; w.MB = MB;
  w.scale = scale;
  const dim3 grid(B, (H * T + kQTile - 1) / kQTile);
  if (grid.x == 0 || grid.y == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 32: paged_mla_kernel<1><<<grid, kThreads, 0, s>>>(w); break;
    case 64: paged_mla_kernel<2><<<grid, kThreads, 0, s>>>(w); break;
    case 128: paged_mla_kernel<4><<<grid, kThreads, 0, s>>>(w); break;
    case 256: paged_mla_kernel<8><<<grid, kThreads, 0, s>>>(w); break;
    case 512: paged_mla_kernel<16><<<grid, kThreads, 0, s>>>(w); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
