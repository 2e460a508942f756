// Paged GQA decode attention for Hopper (sm_90a), plain and Cassandra-packed.
//
// Replaces two TPU kernels of src/repro/kernels/paged_attention.py:
//   * `paged_gqa` (`_gqa_kernel`, step `_gqa_block`): a flash walk over each
//     row's (B, MB) block table into bf16 pool blocks (NB, BS, Hkv, D) under
//     the row's `length` mask;
//   * `paged_gqa_packed` (`_gqa_packed_kernel`, decode `_decode_kv_rows`,
//     `_unary_ranks`): the same walk, where every K/V block is first decoded
//     on chip from the Cassandra-1 speculation leaves (bitmap, sign|mantissa
//     codes, exponent words, mode, emax), so the draft pass's KV never
//     exists densely in device memory.
// Both return the unnormalised flash state (acc (B,Hkv,G,T,D), m, l) in f32.
// `decode_spec_rows` runs the packed kernel's decode alone (for checking it
// bit for bit against the plain version).
//
// Bound. A launch reads each row's `length` tokens of K and of V for every
// kv head once: at D = 128, 512 B per token and head in bf16, or ~180 B
// packed (4 bitmap + 10 sign|mantissa + 8 exponent words and two bytes, at
// the paper's 40% prune and 4-bit truncation). The work is 4*G*T*D flops
// per token and head, far below the ~295 flop/byte where the card's tensor
// cores become the limit, so both kernels are bound by those bytes (3.35
// TB/s); at decode batch sizes the bytes are a few MB and a launch is bound
// by its own overhead.
//
// Design (simple and right first):
//   * The TPU grid (B, MB) carried the flash state across a sequential MB
//     axis. Here one CTA owns (row b, kv head h, a tile of <= 16 of the G*T
//     query rows) and walks the row's table entries 0.. itself, in order:
//     the state accumulates in the reference's block order, with no atomics.
//     Blocks past the row's length are skipped: an all-masked flash step is
//     an exact no-op (corr = exp(0) = 1, p = 0).
//   * Each K and V block of head h (BS <= 32 tokens x D bf16) is staged in
//     shared memory once per CTA; the packed kernel decodes its BS K rows and
//     BS V rows there, one warp per row. Masked V rows are zeroed there (a
//     masked packed lane can decode to NaN), masked K rows are never read.
//   * Each warp owns query rows; each lane holds D/32 dims of q and of acc.
//     A score is a warp-shuffle reduction; lane s keeps key s's score, so the
//     block max, p and the row sum are warp reductions too. The online
//     softmax runs in f32 registers, in the reference's form: scores masked
//     by select to -1e30, p = 0 by select, m from -1e30, l from 0, expf.
//   * Table entries outside [0, NB) read block 0, the trash block.
//   * The decode: a lane takes the dims it owns; a set bitmap bit's kept
//     index is the __popc prefix of the bitmap; its sign|mantissa and 3-bit
//     delta codes are read across word boundaries; a unary rank is the gap
//     between the positions of the k-th and (k+1)-th set bits over the full
//     word-padded exponent region (the strict-< rule of `_unary_ranks`),
//     clipped to [0, 31] and mapped through the 32-entry book; the escape
//     delta code decodes to exponent 0.
// What this first version leaves out: the blocks are read with plain loads
// as the walk reaches them (no cp.async/TMA stage ahead), every query tile
// of a head re-reads (and, packed, re-decodes) the head's blocks, and the
// products run on the CUDA cores. PERF.md records the measured times beside
// the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16;                    // query rows of G*T per CTA
constexpr int kRowsPerWarp = kQTile / kWarps;
constexpr int kMaxBS = 32;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Spec {
  const uint32_t* bitmap;     // (rows, D/32)
  const uint32_t* signmant;   // (rows, wsm)
  const uint32_t* exp_words;  // (rows, we)
  const uint8_t* mode;        // (rows,)
  const uint8_t* emax;        // (rows,)
};

struct Codec {
  const uint8_t* book;        // exp_of_rank, >= 32 entries
  int keep, trunc, exp_bits, wsm, we;
};

struct Walk {
  const uint16_t* q;          // (B, T, Hkv, G, D) bf16
  const uint16_t* k_pool;     // (NB, BS, Hkv, D) bf16 (plain walk)
  const uint16_t* v_pool;
  Spec k_spec, v_spec;        // packed walk
  Codec codec;
  const int32_t* table;       // (B, MB)
  const int32_t* length;      // (B,)
  float* acc;                 // (B, Hkv, G, T, D)
  float* m;                   // (B, Hkv, G, T)
  float* l;
  int B, T, Hkv, G, D, NB, BS, MB;
  float scale;
};

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same (commutative) sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// `width` (<= 8) bits at bit offset `off` of a little-endian word stream.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* w, int nwords,
                                            int off, int width) {
  const int wi = off >> 5;
  uint64_t v = w[wi];
  if (wi + 1 < nwords) v |= static_cast<uint64_t>(w[wi + 1]) << 32;
  return static_cast<uint32_t>(v >> (off & 31)) & ((1u << width) - 1u);
}

// 0-indexed position of the n-th (n >= 1) set bit of the stream, or the
// stream's bit count when it holds fewer than n.
__device__ __forceinline__ int select_bit(const uint32_t* w, int nwords,
                                          int n) {
  for (int i = 0; i < nwords; ++i) {
    uint32_t x = w[i];
    const int c = __popc(x);
    if (n <= c) {
      for (int k = 1; k < n; ++k) x &= x - 1u;
      return i * 32 + __ffs(x) - 1;
    }
    n -= c;
  }
  return nwords * 32;
}

// Decode one speculation row into D bf16 bit patterns (warp-cooperative:
// lane takes dims lane, lane+32, ...). Bit for bit the reference's
// `_decode_kv_rows`.
__device__ void decode_row(const Spec& sp, size_t row, const Codec& c, int D,
                           uint16_t* dst, int lane) {
  const uint32_t* bm = sp.bitmap + row * (D >> 5);
  const uint32_t* sm = sp.signmant + row * c.wsm;
  const uint32_t* ew = sp.exp_words + row * c.we;
  const int mode = sp.mode[row];
  const int emax = sp.emax[row];
  const int t_keep = 7 - c.trunc;
  const int width = 1 + t_keep;
  const int esc = (1 << c.exp_bits) - 1;
  for (int dd = lane; dd < D; dd += 32) {
    const int wi = dd >> 5, bi = dd & 31;
    const uint32_t word = bm[wi];
    uint32_t out = 0;
    if ((word >> bi) & 1u) {
      int rank = __popc(word & ((1u << bi) - 1u));
      for (int i = 0; i < wi; ++i) rank += __popc(bm[i]);
      const int k = min(rank, c.keep - 1);
      const uint32_t code = bits_at(sm, c.wsm, k * width, width);
      const uint32_t sign = (code >> t_keep) & 1u;
      const uint32_t mant = (code & ((1u << t_keep) - 1u)) << c.trunc;
      int e;
      if (mode == 0) {
        const int pos = select_bit(ew, c.we, k + 1);
        const int prev = k > 0 ? select_bit(ew, c.we, k) : -1;
        e = c.book[min(max(pos - prev - 1, 0), 31)];
      } else {
        const int dc = static_cast<int>(
            bits_at(ew, c.we, k * c.exp_bits, c.exp_bits));
        e = dc == esc ? 0 : min(max(emax - dc, 0), 255);
      }
      out = ((sign << 15) | (static_cast<uint32_t>(e) << 7) | mant) & 0xFFFFu;
    }
    dst[dd] = static_cast<uint16_t>(out);
  }
}

template <int DPL>
__device__ __forceinline__ void load_dims(const uint16_t* p, float* out) {
  if constexpr (DPL == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xFFFF0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else if constexpr (DPL == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(v << 16);
    out[1] = __uint_as_float(v & 0xFFFF0000u);
  } else {
    out[0] = bf16_to_f32(p[0]);
  }
}

template <int DPL, bool PACKED>
__global__ void __launch_bounds__(kThreads) paged_gqa_kernel(Walk w) {
  constexpr int D = DPL * 32;
  __shared__ __align__(16) uint16_t ks[kMaxBS * kMaxD];
  __shared__ __align__(16) uint16_t vs[kMaxBS * kMaxD];
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gt = w.G * w.T;

  float q[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qrow[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = blockIdx.z * kQTile + warp + i * kWarps;
    qrow[i] = r < gt ? r : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
    if (qrow[i] >= 0) {
      const int g = r / w.T, t = r % w.T;
      const size_t off =
          ((((size_t)b * w.T + t) * w.Hkv + h) * w.G + g) * D + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) q[i][c] = bf16_to_f32(w.q[off + c]);
    }
  }

  const int len = w.length[b];
  const int n_blocks = len > 0 ? min(w.MB, (len + w.BS - 1) / w.BS) : 0;
  for (int j = 0; j < n_blocks; ++j) {
    int blk = w.table[(size_t)b * w.MB + j];
    if (blk < 0 || blk >= w.NB) blk = 0;                   // trash block
    const int nvalid = min(w.BS, len - j * w.BS);
    __syncthreads();                    // the previous block's tiles are used
    if constexpr (PACKED) {
      for (int rr = warp; rr < 2 * w.BS; rr += kWarps) {
        const bool is_v = rr >= w.BS;
        const int s = is_v ? rr - w.BS : rr;
        uint16_t* dst = (is_v ? vs : ks) + s * D;
        if (s < nvalid) {
          const size_t row = ((size_t)blk * w.BS + s) * w.Hkv + h;
          decode_row(is_v ? w.v_spec : w.k_spec, row, w.codec, D, dst, lane);
        } else {
          for (int dd = lane; dd < D; dd += 32) dst[dd] = 0;
        }
      }
    } else {
      constexpr int kChunks = D / 8;                    // 16 B per chunk
      for (int idx = threadIdx.x; idx < 2 * w.BS * kChunks; idx += kThreads) {
        const bool is_v = idx >= w.BS * kChunks;
        const int rel = is_v ? idx - w.BS * kChunks : idx;
        const int s = rel / kChunks, c8 = rel % kChunks;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (s < nvalid) {
          const uint16_t* src = (is_v ? w.v_pool : w.k_pool) +
              (((size_t)blk * w.BS + s) * w.Hkv + h) * D + c8 * 8;
          v = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>((is_v ? vs : ks) + s * D + c8 * 8) = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (qrow[i] < 0) continue;                     // warp-uniform
      float sc = kNegInf;                            // lane s: key s
      for (int s = 0; s < nvalid; ++s) {
        float kd[DPL];
        load_dims<DPL>(ks + s * D + lane * DPL, kd);
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) part += q[i][c] * kd[c];
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
        float vd[DPL];
        load_dims<DPL>(vs + s * D + lane * DPL, vd);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += ps * vd[c];
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qrow[i] < 0) continue;
    const int g = qrow[i] / w.T, t = qrow[i] % w.T;
    const size_t st = (((size_t)b * w.Hkv + h) * w.G + g) * w.T + t;
#pragma unroll
    for (int c = 0; c < DPL; ++c) w.acc[st * D + lane * DPL + c] = acc[i][c];
    if (lane == 0) {
      w.m[st] = m[i];
      w.l[st] = l[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_rows_kernel(Spec sp, Codec c, uint16_t* out, int rows, int D) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  decode_row(sp, row, c, D, out + (size_t)row * D, threadIdx.x & 31);
}

template <bool PACKED>
cudaError_t launch_walk(const Walk& w, cudaStream_t stream) {
  if (w.BS < 1 || w.BS > kMaxBS) return cudaErrorInvalidValue;
  const dim3 grid(w.B, w.Hkv, (w.G * w.T + kQTile - 1) / kQTile);
  if (grid.x == 0 || grid.z == 0) return cudaSuccess;
  switch (w.D) {
    case 32: paged_gqa_kernel<1, PACKED><<<grid, kThreads, 0, stream>>>(w); break;
    case 64: paged_gqa_kernel<2, PACKED><<<grid, kThreads, 0, stream>>>(w); break;
    case 128: paged_gqa_kernel<4, PACKED><<<grid, kThreads, 0, stream>>>(w); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

Walk make_walk(const void* q, const void* table, const void* length, void* acc,
               void* m, void* l, int B, int T, int Hkv, int G, int D, int NB,
               int BS, int MB, float scale) {
  Walk w{};
  w.q = static_cast<const uint16_t*>(q);
  w.table = static_cast<const int32_t*>(table);
  w.length = static_cast<const int32_t*>(length);
  w.acc = static_cast<float*>(acc);
  w.m = static_cast<float*>(m);
  w.l = static_cast<float*>(l);
  w.B = B; w.T = T; w.Hkv = Hkv; w.G = G; w.D = D;
  w.NB = NB; w.BS = BS; w.MB = MB;
  w.scale = scale;
  return w;
}

Spec make_spec(const void* bitmap, const void* signmant, const void* exp_words,
               const void* mode, const void* emax) {
  return Spec{static_cast<const uint32_t*>(bitmap),
              static_cast<const uint32_t*>(signmant),
              static_cast<const uint32_t*>(exp_words),
              static_cast<const uint8_t*>(mode),
              static_cast<const uint8_t*>(emax)};
}

}  // namespace

extern "C" int paged_gqa_launch(const void* q, const void* k_pool,
                                const void* v_pool, const void* table,
                                const void* length, void* acc, void* m,
                                void* l, int B, int T, int Hkv, int G, int D,
                                int NB, int BS, int MB, float scale,
                                void* stream) {
  Walk w = make_walk(q, table, length, acc, m, l, B, T, Hkv, G, D, NB, BS, MB,
                     scale);
  w.k_pool = static_cast<const uint16_t*>(k_pool);
  w.v_pool = static_cast<const uint16_t*>(v_pool);
  return static_cast<int>(
      launch_walk<false>(w, static_cast<cudaStream_t>(stream)));
}

extern "C" int paged_gqa_packed_launch(
    const void* q, const void* kbm, const void* ksm, const void* kew,
    const void* kmo, const void* kem, const void* vbm, const void* vsm,
    const void* vew, const void* vmo, const void* vem, const void* book,
    const void* table, const void* length, void* acc, void* m, void* l,
    int B, int T, int Hkv, int G, int D, int NB, int BS, int MB, int keep,
    int trunc, int exp_bits, int wsm, int we, float scale, void* stream) {
  Walk w = make_walk(q, table, length, acc, m, l, B, T, Hkv, G, D, NB, BS, MB,
                     scale);
  w.k_spec = make_spec(kbm, ksm, kew, kmo, kem);
  w.v_spec = make_spec(vbm, vsm, vew, vmo, vem);
  w.codec = Codec{static_cast<const uint8_t*>(book), keep, trunc, exp_bits,
                  wsm, we};
  return static_cast<int>(
      launch_walk<true>(w, static_cast<cudaStream_t>(stream)));
}

extern "C" int decode_spec_rows_launch(const void* bitmap,
                                       const void* signmant,
                                       const void* exp_words,
                                       const void* mode, const void* emax,
                                       const void* book, void* out, int rows,
                                       int D, int keep, int trunc,
                                       int exp_bits, int wsm, int we,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (D % 32 != 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const Spec sp = make_spec(bitmap, signmant, exp_words, mode, emax);
  const Codec c{static_cast<const uint8_t*>(book), keep, trunc, exp_bits, wsm,
                we};
  const int blocks = (rows + kWarps - 1) / kWarps;
  decode_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sp, c, static_cast<uint16_t*>(out), rows, D);
  return static_cast<int>(cudaGetLastError());
}
