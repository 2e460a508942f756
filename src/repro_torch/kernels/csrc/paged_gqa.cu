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
// kv head once: at D = 128, 512 B per token and head in bf16, or ~90 B
// packed (4 bitmap + 10 sign|mantissa + 8 exponent words and two bytes, at
// the paper's 40% prune and 4-bit truncation). The work is 4*G*T*D flops
// per token and head, far below the ~295 flop/byte where the card's tensor
// cores become the limit, so both kernels are bound by those bytes (3.35
// TB/s); at decode batch sizes the bytes are a few MB, and what a launch
// costs is latency: how many blocks one CTA walks in order, and how long
// one block's decode takes.
//
// The plain walk (`paged_gqa`, redesigned for the card) reads bf16 K and V
// rows straight from the pools. At the verify pass's shapes one launch
// moves ~1 MB (Llama-3-8B, 4 rows of ~330 tokens), at 4 x 4096 tokens 67 MB;
// what held the first version back was one CTA per (row, kv head, query
// tile) walking the row's whole table in order (32 CTAs at T = 4), each
// block loaded synchronously between two barriers, a shuffle reduction per
// key. Its design now:
//   * the packed walk's table split (flash decoding, below): `gqa_split_plan`
//     cuts each (row, kv head)'s table into chunks of `bps` blocks, one CTA
//     each, and the split-order merge kernel (a programmatic dependent)
//     folds the partial states; no atomics, the same bits on every launch.
//     `plain_split_plan` splits only while the (row, kv head, query tile)
//     grid leaves SMs idle: a prefill chunk's tiles fill the card alone, and
//     its CTAs walk their tables in order, with no merge;
//   * loads kept in flight: a two-slot ring in shared memory; `cp.async`
//     copies the next block's K and V rows of head h (D bf16 each, 16 bytes
//     a thread, rows strided by Hkv * D in the pool) while the current block
//     runs its flash step; rows past the row's length are neither copied nor
//     read, and table entries outside [0, NB) read block 0, the trash block;
//   * every lane busy in the flash step: lane (group, key) takes the whole
//     dot q·k of one key for every GR-th of its warp's query rows, GR = 32
//     over the block's keys rounded up (2 rows a lane at 16 keys, the
//     verify pass's block), the rows interleaved for independent chains;
//     each dot is a sequential f32 sum over D, the packed walk's order, and
//     a tile with one live row a warp (G*T <= 4) takes the packed walk's
//     step as it is: both give the same bits. QK^T on `mma.sync` was tried:
//     its f32 accumulation differs from a sequential one enough that,
//     through exp, rows of spread-out keys leave the tolerance the tests
//     hold. P·V stays f32 on the CUDA cores: lane l holds D/32 dims of each
//     of its warp's query rows, and every V row is read once for all of
//     them.
// The online softmax is the reference's form: scores masked by select to
// -1e30, p = 0 by select, m from -1e30, l from 0, expf.
//
// The packed walk (`paged_gqa_packed`) is bound by latency: at the draft
// pass's shapes one launch moves under 1 MB, so what it costs is how many
// dependent steps one block takes (table, stage, decode, flash) and how many
// blocks one CTA walks in order. Its design:
//   * A table split across CTAs (flash decoding). The draft pass has only
//     B*Hkv = 32 (row, kv head) pairs, and a 4096-token row holds 256
//     blocks, so each pair's table is cut into chunks of `bps` blocks, one
//     CTA each (`gqa_split_plan` in paged_attention.py picks `bps` so that
//     the grid fills the card). Each CTA walks its chunk in order into a
//     partial (acc, m, l); a second kernel, one thread per output element,
//     merges the partials in split order with the usual rescale by
//     exp(m_s - m), launched as a programmatic dependent so that its launch
//     overlaps the walk's tail. No atomics: the same bits on every launch.
//     An empty chunk leaves the initial state, which the merge leaves alone.
//   * One decode per block, shared by all query rows. A block's K and V are
//     decoded once per (row, kv head, split, tile of 16 query rows) into
//     bf16 tiles in shared memory, which the flash step of every query row
//     of the tile reads.
//   * The decode runs on all threads in parallel: one thread per (token,
//     32-dim word), so D = 128 and BS = 16 give the 128 words of a K and a V
//     block to 128 threads. A thread's kept indices are a __popc prefix of
//     the row's bitmap; four set bits at a time, their consecutive codes
//     come from one 32-bit window of each code region. Unary ranks are gaps
//     between successive set bits of the row's exponent region, a serial
//     walk: instead, the row's threads first write the region's set-bit
//     positions to shared memory (a __popc prefix places each thread's
//     slice), so that every rank is two reads. Bit for bit the reference's
//     `_decode_kv_rows`: the unary strict-< rule over the full word-padded
//     region, ranks clipped to [0, 31] through the 32-entry book, the
//     escape delta code read as exponent 0, kept indices clamped at
//     keep - 1.
//   * The flash step gives each key a lane that computes the whole dot q·k
//     from the tile's q rows staged in shared memory, in place of a
//     shuffle reduction per key.
//   * Loads kept in flight: a two-slot shared-memory ring holds the packed
//     words of a block's BS valid K and V rows of head h; `cp.async` fills
//     the next block's slot while the current block decodes, and each
//     thread loads its rows' mode and emax bytes while the slot lands.
// The products stay on the CUDA cores (a few MFLOP per launch).

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
  int bps, splits;            // packed: blocks per split, splits
  float* ws;                  // packed, splits > 1: partial (acc, m, l)
  int rs, sm0, ew0;           // packed: staged row stride / region offsets
  int g_bm, g_sm, g_ew;       // packed: cp.async granularity (words)
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

// One warp's query rows of a CTA: q and the flash state in registers.
template <int DPL>
struct Rows {
  float q[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qrow[kRowsPerWarp];
};

template <int DPL>
__device__ __forceinline__ void init_rows(const Walk& w, int b, int h,
                                          int warp, int lane,
                                          Rows<DPL>& st) {
  constexpr int D = DPL * 32;
  const int gt = w.G * w.T;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = blockIdx.z * kQTile + warp + i * kWarps;
    st.qrow[i] = r < gt ? r : -1;
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) st.acc[i][c] = 0.f;
    if (st.qrow[i] >= 0) {
      const int g = r / w.T, t = r % w.T;
      const size_t off =
          ((((size_t)b * w.T + t) * w.Hkv + h) * w.G + g) * D + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) st.q[i][c] = bf16_to_f32(w.q[off + c]);
    }
  }
}

template <int DPL>
__device__ __forceinline__ void store_rows(const Walk& w, float* acc,
                                           float* m, float* l, int b, int h,
                                           int lane, const Rows<DPL>& st) {
  constexpr int D = DPL * 32;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (st.qrow[i] < 0) continue;
    const int g = st.qrow[i] / w.T, t = st.qrow[i] % w.T;
    const size_t o = (((size_t)b * w.Hkv + h) * w.G + g) * w.T + t;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[o * D + lane * DPL + c] = st.acc[i][c];
    if (lane == 0) {
      m[o] = st.m[i];
      l[o] = st.l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The packed walk: decode, staging, split and merge
// ---------------------------------------------------------------------------

// `mask` bits at bit offset `off` of a little-endian word stream of
// `nwords` words (reads past the stream as zeros).
__device__ __forceinline__ uint32_t bits_at(const uint32_t* w, int nwords,
                                            int off, uint32_t mask) {
  const int wi = off >> 5;
  const uint32_t hi = wi + 1 < nwords ? w[wi + 1] : 0u;
  return __funnelshift_r(w[wi], hi, off) & mask;
}

// Unary exponent regions, phase 1: the positions of the first `keep` set
// bits of a row's region (pos_j, the position of the (j+1)-th set bit) go
// to `pos`, and the region's set-bit count to `*total`. The row's `dw`
// threads (consecutive lanes, dims word wi each) take consecutive slices
// of the region's words and place their bits after a __popc prefix over
// the slices. Every lane of the warp calls it (the prefix shuffles);
// `active` says whether this lane's row is a unary row to decode.
__device__ __forceinline__ void unary_positions(const uint32_t* ew, int we,
                                                int keep, int wi, int dw,
                                                bool active, int16_t* pos,
                                                int* total) {
  const int ch = (we + dw - 1) / dw;
  const int j0 = min(we, wi * ch), j1 = min(we, j0 + ch);
  int cnt = 0;
  if (active)
    for (int j = j0; j < j1; ++j) cnt += __popc(ew[j]);
  int incl = cnt;
  for (int d = 1; d < dw; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d, dw);
    if (wi >= d) incl += t;
  }
  const int tot = __shfl_sync(kFull, incl, dw - 1, dw);
  if (!active) return;
  int k = incl - cnt;
  for (int j = j0; j < j1 && k < keep; ++j) {
    uint32_t word = ew[j];
    while (word != 0u && k < keep) {
      pos[k++] = static_cast<int16_t>(j * 32 + __ffs(word) - 1);
      word &= word - 1u;
    }
  }
  if (wi == 0) *total = tot;
}

// Phase 2: dims 32*wi .. 32*wi+31 of one speculation row into `dst` (bf16
// bit patterns; bitmap bm, codes sm, exponent words ew; a unary row's
// positions from phase 1). Bit for bit the reference's `_decode_kv_rows`:
// kept indices clamped at keep - 1, unary ranks pos_k - pos_{k-1} - 1
// (pos_{-1} = -1, the region's bit count past its last set bit) clipped to
// [0, 31] through the book, the delta escape read as exponent 0.
__device__ __forceinline__ void decode_word(
    const uint32_t* bm, const uint32_t* sm, const uint32_t* ew, int wi,
    int mode, int emax, const Codec& c, const uint8_t* book,
    const int16_t* pos, int total, uint16_t* dst) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) d4[i] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t bits = bm[wi];
  if (bits == 0u) return;
  int base = 0;
  for (int i = 0; i < wi; ++i) base += __popc(bm[i]);
  const int tk = 7 - c.trunc, width = 8 - c.trunc;
  const uint32_t cmask = (1u << width) - 1u, mmask = (1u << tk) - 1u;
  const uint32_t emask = (1u << c.exp_bits) - 1u;
  const int esc = static_cast<int>(emask);
  const int nbits = c.we * 32;
  // four set bits a step: their kept indices are consecutive from kb (or
  // clamped to keep - 1), so one 32-bit window of each code region holds
  // their codes (widths <= 8) and five positions their unary ranks
  int r = 0;
  while (bits != 0u) {
    int p[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = bits != 0u;
      p[u] = __ffs(bits) - 1;
      bits &= bits - 1u;
    }
    const int kb = min(base + r, c.keep - 1);
    const uint32_t swin = bits_at(sm, c.wsm, kb * width, 0xFFFFFFFFu);
    uint32_t ewin = 0u;
    int pv[5];
    if (mode != 0) {
      ewin = bits_at(ew, c.we, kb * c.exp_bits, 0xFFFFFFFFu);
    } else {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int kk = kb - 1 + j;
        pv[j] = kk < 0 ? -1 : kk < total && kk < c.keep ? pos[kk] : nbits;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = min(base + r + u, c.keep - 1) - kb;      // 0..3
      const uint32_t code = (swin >> (d * width)) & cmask;
      uint32_t e;
      if (mode != 0) {
        const int dc = static_cast<int>((ewin >> (d * c.exp_bits)) & emask);
        e = dc == esc ? 0u
                      : static_cast<uint32_t>(min(max(emax - dc, 0), 255));
      } else {                                  // pos_k - pos_{k-1} - 1
        const int p0 = d == 0 ? pv[0] : d == 1 ? pv[1] : d == 2 ? pv[2] : pv[3];
        const int p1 = d == 0 ? pv[1] : d == 1 ? pv[2] : d == 2 ? pv[3] : pv[4];
        e = book[min(max(p1 - p0 - 1, 0), 31)];
      }
      if (ok[u])
        dst[p[u]] = static_cast<uint16_t>(((code >> tk) & 1u) << 15 |
                                          e << 7 |
                                          ((code & mmask) << c.trunc));
    }
    r += 4;
  }
}

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         int words) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (words == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src));
  else if (words == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void copy_region(uint32_t* dst,
                                            const uint32_t* src, int n,
                                            int g, int sub) {
  for (int i = sub * g; i < n; i += 4 * g) cp_async(dst + i, src + i, g);
}

// The packed words of block `blk`'s valid K and V rows of head h into a
// ring slot: row r < BS is K token r, row BS + r V token r. 4 threads a
// row.
__device__ __forceinline__ void stage_block(const Walk& w, uint32_t* slot,
                                            int blk, int h, int nvalid,
                                            int dw) {
  const int sub = threadIdx.x & 3;
  for (int r = threadIdx.x >> 2; r < 2 * w.BS; r += kThreads / 4) {
    const bool is_v = r >= w.BS;
    const int s = is_v ? r - w.BS : r;
    if (s >= nvalid) continue;
    const Spec& sp = is_v ? w.v_spec : w.k_spec;
    const size_t row = ((size_t)blk * w.BS + s) * w.Hkv + h;
    uint32_t* dst = slot + r * w.rs;
    copy_region(dst, sp.bitmap + row * dw, dw, w.g_bm, sub);
    copy_region(dst + w.sm0, sp.signmant + row * w.codec.wsm, w.codec.wsm,
                w.g_sm, sub);
    copy_region(dst + w.ew0, sp.exp_words + row * w.codec.we, w.codec.we,
                w.g_ew, sub);
  }
  asm volatile("cp.async.commit_group;" ::);
}

// The packed kernel's flash step. One lane per key computes the whole dot
// q·k from the q rows staged in shared memory (f32) and the K tile (rows
// padded to kKStride, so the lanes' 16-byte reads fall on distinct banks):
// no shuffle chain per key. The V accumulation is the plain walk's.
constexpr int kKStride = kMaxD + 8;

template <int DPL>
__device__ __forceinline__ void flash_block_keys(const uint16_t* ks,
                                                 const uint16_t* vs,
                                                 const float* qs, int nvalid,
                                                 float scale, int warp,
                                                 int lane, Rows<DPL>& st) {
  constexpr int D = DPL * 32;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (st.qrow[i] < 0) continue;                  // warp-uniform
    float sc = kNegInf;                            // lane s: key s
    if (lane < nvalid) {
      const uint16_t* kr = ks + lane * kKStride;
      const float* qr = qs + (warp + i * kWarps) * D;
      float dot = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 8) {
        const uint4 k8 = *reinterpret_cast<const uint4*>(kr + c);
        const float4 qa = *reinterpret_cast<const float4*>(qr + c);
        const float4 qb = *reinterpret_cast<const float4*>(qr + c + 4);
        dot += qa.x * __uint_as_float(k8.x << 16);
        dot += qa.y * __uint_as_float(k8.x & 0xFFFF0000u);
        dot += qa.z * __uint_as_float(k8.y << 16);
        dot += qa.w * __uint_as_float(k8.y & 0xFFFF0000u);
        dot += qb.x * __uint_as_float(k8.z << 16);
        dot += qb.y * __uint_as_float(k8.z & 0xFFFF0000u);
        dot += qb.z * __uint_as_float(k8.w << 16);
        dot += qb.w * __uint_as_float(k8.w & 0xFFFF0000u);
      }
      sc = dot * scale;
    }
    const float m_new = fmaxf(st.m[i], warp_max(sc));
    const float p = lane < nvalid ? expf(sc - m_new) : 0.f;
    const float corr = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * corr + warp_sum(p);
#pragma unroll
    for (int c = 0; c < DPL; ++c) st.acc[i][c] *= corr;
#pragma unroll 4
    for (int s = 0; s < nvalid; ++s) {
      const float ps = __shfl_sync(kFull, p, s);
      float vd[DPL];
      load_dims<DPL>(vs + s * D + lane * DPL, vd);
#pragma unroll
      for (int c = 0; c < DPL; ++c) st.acc[i][c] += ps * vd[c];
    }
    st.m[i] = m_new;
  }
}

// grid (B*Hkv, splits, query tiles): chunk `split` of row b's table, kv
// head h, into (acc, m, l), or into partial state slice `split` of the
// workspace when the table is split.
template <int DPL>
__global__ void __launch_bounds__(kThreads) paged_gqa_packed_kernel(Walk w) {
  constexpr int D = DPL * 32;
  constexpr int kTasks = (2 * kMaxBS * DPL + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint16_t ks[kMaxBS * kKStride];
  __shared__ __align__(16) uint16_t vs[kMaxBS * kMaxD];
  __shared__ __align__(16) float qs[kQTile * kMaxD];
  __shared__ uint8_t book[32];
  __shared__ int utot[2 * kMaxBS];
  extern __shared__ __align__(16) uint32_t ring[];
  int16_t* upos = reinterpret_cast<int16_t*>(ring + 2 * 2 * w.BS * w.rs);
  const int b = blockIdx.x / w.Hkv, h = blockIdx.x % w.Hkv;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = split * w.bps;
  const int32_t* trow = w.table + (size_t)b * w.MB;
  // the row's length and first table entry, loaded together
  const int len = w.length[b];
  const int first = j0 < w.MB ? trow[j0] : 0;
  if (threadIdx.x < 32) book[threadIdx.x] = w.codec.book[threadIdx.x];

  Rows<DPL> st;
  init_rows<DPL>(w, b, h, warp, lane, st);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    if (st.qrow[i] >= 0)
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        qs[(warp + i * kWarps) * D + lane * DPL + c] = st.q[i][c];

  const int n_blocks = len > 0 ? min(w.MB, (len + w.BS - 1) / w.BS) : 0;
  const int j1 = min(n_blocks, j0 + w.bps);
  const int slot_words = 2 * w.BS * w.rs;
  auto sanitize = [&](int blk) {
    return blk < 0 || blk >= w.NB ? 0 : blk;               // trash block
  };
  if (j0 < j1)
    stage_block(w, ring, sanitize(first), h, min(w.BS, len - j0 * w.BS),
                DPL);
  for (int j = j0; j < j1; ++j) {
    const int i = j - j0;
    const int blk = sanitize(j == j0 ? first : trow[j]);
    const int nvalid = min(w.BS, len - j * w.BS);
    if (j + 1 < j1)
      stage_block(w, ring + ((i + 1) & 1) * slot_words,
                  sanitize(trow[j + 1]), h, min(w.BS, len - (j + 1) * w.BS),
                  DPL);
    // this block's rows' mode and emax, loaded while the slot lands
    int mode[kTasks], emax[kTasks];
#pragma unroll
    for (int q = 0; q < kTasks; ++q) {
      const int r = (threadIdx.x + q * kThreads) / DPL;
      const bool is_v = r >= w.BS;
      const int s = is_v ? r - w.BS : r;
      mode[q] = emax[q] = 0;
      if (r < 2 * w.BS && s < nvalid) {
        const Spec& sp = is_v ? w.v_spec : w.k_spec;
        const size_t row = ((size_t)blk * w.BS + s) * w.Hkv + h;
        mode[q] = sp.mode[row];
        emax[q] = sp.emax[row];
      }
    }
    if (j + 1 < j1)
      asm volatile("cp.async.wait_group 1;" ::);
    else
      asm volatile("cp.async.wait_group 0;" ::);
    // the slot has landed, and every thread is past the previous flash
    // step (the tiles are free) and decode (the other slot is free)
    __syncthreads();
    const uint32_t* slot = ring + (i & 1) * slot_words;
    // unary rows: their exponent regions' set-bit positions
#pragma unroll
    for (int q = 0; q < kTasks; ++q) {
      const int task = threadIdx.x + q * kThreads;
      const int r = min(task / DPL, 2 * w.BS - 1), wi = task % DPL;
      const int s = r >= w.BS ? r - w.BS : r;
      unary_positions(slot + r * w.rs + w.ew0, w.codec.we, w.codec.keep, wi,
                      DPL, task < 2 * w.BS * DPL && s < nvalid && mode[q] == 0,
                      upos + r * w.codec.keep, utot + r);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kTasks; ++q) {
      const int task = threadIdx.x + q * kThreads;
      if (task >= 2 * w.BS * DPL) break;
      const int r = task / DPL, wi = task % DPL;
      const bool is_v = r >= w.BS;
      const int s = is_v ? r - w.BS : r;
      uint16_t* dst = is_v ? vs + s * D + 32 * wi : ks + s * kKStride + 32 * wi;
      if (s >= nvalid) {
        uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
        for (int z = 0; z < 4; ++z) d4[z] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const uint32_t* src = slot + r * w.rs;
      decode_word(src, src + w.sm0, src + w.ew0, wi, mode[q], emax[q],
                  w.codec, book, upos + r * w.codec.keep, utot[r], dst);
    }
    __syncthreads();
    flash_block_keys<DPL>(ks, vs, qs, nvalid, w.scale, warp, lane, st);
  }
  if (w.splits == 1) {
    store_rows<DPL>(w, w.acc, w.m, w.l, b, h, lane, st);
    return;
  }
  const size_t slab = (size_t)w.B * w.Hkv * w.G * w.T;
  float* pm = w.ws + w.splits * slab * D;
  store_rows<DPL>(w, w.ws + split * slab * D, pm + split * slab,
                  pm + (w.splits + split) * slab, b, h, lane, st);
  asm volatile("griddepcontrol.launch_dependents;");    // the merge may start
}

// xor-butterfly reductions over groups of KL consecutive lanes (KL a power
// of two): every lane ends with its group's result.
template <int KL>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = KL / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int KL>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = KL / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The plain walk's flash step over a staged block (nvalid <= KL keys). The
// warp's lanes form GR groups of KL = 32/GR lanes; lane (grp, key) takes the
// dot q·k of key `key` for the warp's rows grp, grp + GR, ... (RPL of them),
// each a sequential f32 sum over the D dims (flash_block_keys' order, so
// the two steps give the same bits), the rows interleaved. The
// softmax reduces within each group; every lane then holds D/32 dims of
// each of the warp's rows, and each V row is read once for all of them.
template <int DPL, int GR>
__device__ __forceinline__ void flash_block_rows(const uint16_t* ks,
                                                 const uint16_t* vs,
                                                 const float* qs, int nvalid,
                                                 float scale, int warp,
                                                 int lane, int nr,
                                                 Rows<DPL>& st) {
  constexpr int D = DPL * 32;
  constexpr int KL = 32 / GR, RPL = kRowsPerWarp / GR;
  const int grp = lane / KL, key = lane % KL;
  float sc[RPL];
#pragma unroll
  for (int u = 0; u < RPL; ++u) sc[u] = kNegInf;
  if (key < nvalid) {
    const uint16_t* kr = ks + key * kKStride;
    float dot[RPL];
#pragma unroll
    for (int u = 0; u < RPL; ++u) dot[u] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      const uint4 k8 = *reinterpret_cast<const uint4*>(kr + c);
      const float k0 = __uint_as_float(k8.x << 16);
      const float k1 = __uint_as_float(k8.x & 0xFFFF0000u);
      const float k2 = __uint_as_float(k8.y << 16);
      const float k3 = __uint_as_float(k8.y & 0xFFFF0000u);
      const float k4 = __uint_as_float(k8.z << 16);
      const float k5 = __uint_as_float(k8.z & 0xFFFF0000u);
      const float k6 = __uint_as_float(k8.w << 16);
      const float k7 = __uint_as_float(k8.w & 0xFFFF0000u);
#pragma unroll
      for (int u = 0; u < RPL; ++u) {
        const float* qr = qs + (warp + (grp + GR * u) * kWarps) * D + c;
        const float4 qa = *reinterpret_cast<const float4*>(qr);
        const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
        float d = dot[u];
        d += qa.x * k0;
        d += qa.y * k1;
        d += qa.z * k2;
        d += qa.w * k3;
        d += qb.x * k4;
        d += qb.y * k5;
        d += qb.z * k6;
        d += qb.w * k7;
        dot[u] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < RPL; ++u) sc[u] = dot[u] * scale;
  }
  float mx[RPL], p[RPL], ps[RPL];
#pragma unroll
  for (int u = 0; u < RPL; ++u) mx[u] = group_max<KL>(sc[u]);
  // every row's new max, on every lane; then this lane's p and row sums
  float m_new[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    m_new[r] = fmaxf(st.m[r], __shfl_sync(kFull, mx[r / GR], (r % GR) * KL));
#pragma unroll
  for (int u = 0; u < RPL; ++u) {
    float own = m_new[GR * u];
#pragma unroll
    for (int q = 1; q < GR; ++q)
      if (grp == q) own = m_new[q + GR * u];
    p[u] = key < nvalid ? expf(sc[u] - own) : 0.f;
    ps[u] = group_sum<KL>(p[u]);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r < nr) {                                 // warp-uniform
      const float corr = expf(st.m[r] - m_new[r]);
      st.l[r] = st.l[r] * corr +
                __shfl_sync(kFull, ps[r / GR], (r % GR) * KL);
#pragma unroll
      for (int c = 0; c < DPL; ++c) st.acc[r][c] *= corr;
      st.m[r] = m_new[r];
    }
  }
  for (int s = 0; s < nvalid; ++s) {
    float vd[DPL];
    load_dims<DPL>(vs + s * D + lane * DPL, vd);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pr = __shfl_sync(kFull, p[r / GR], (r % GR) * KL + s);
      if (r < nr)
#pragma unroll
        for (int c = 0; c < DPL; ++c) st.acc[r][c] += pr * vd[c];
    }
  }
}

// grid (B*Hkv, splits, query tiles): chunk `split` of row b's table over
// the bf16 pools, kv head h, into (acc, m, l), or into partial state slice
// `split` of the workspace when the table is split. The ring's slots hold
// a K tile (BS rows of kKStride) and a V tile (BS rows of D). GR: lane
// groups of the flash step (32 / GR >= BS).
template <int DPL, int GR>
__global__ void __launch_bounds__(kThreads) paged_gqa_kernel(Walk w) {
  constexpr int D = DPL * 32;
  constexpr int kChunks = D / 8;                      // 16 B per copy
  __shared__ __align__(16) float qs[kQTile * kMaxD];
  extern __shared__ __align__(16) uint32_t tiles[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(tiles);
  const int slot_elems = w.BS * (kKStride + D);
  const int b = blockIdx.x / w.Hkv, h = blockIdx.x % w.Hkv;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = split * w.bps;
  const int32_t* trow = w.table + (size_t)b * w.MB;
  const int len = w.length[b];
  const int first = j0 < w.MB ? trow[j0] : 0;

  Rows<DPL> st;
  init_rows<DPL>(w, b, h, warp, lane, st);
  int nr = 0;                                 // this warp's live rows
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    nr += st.qrow[i] >= 0;
#pragma unroll
    for (int c = 0; c < DPL; ++c)             // zero past G*T: no NaN there
      qs[(warp + i * kWarps) * D + lane * DPL + c] =
          st.qrow[i] >= 0 ? st.q[i][c] : 0.f;
  }

  const int n_blocks = len > 0 ? min(w.MB, (len + w.BS - 1) / w.BS) : 0;
  const int j1 = min(n_blocks, j0 + w.bps);
  // block j's valid K and V rows of head h into ring slot `slot`
  auto stage = [&](int blk, int j, int slot) {
    if (blk < 0 || blk >= w.NB) blk = 0;                   // trash block
    const int nvalid = min(w.BS, len - j * w.BS);
    uint16_t* kt = ring + slot * slot_elems;
    uint16_t* vt = kt + w.BS * kKStride;
    for (int idx = threadIdx.x; idx < 2 * nvalid * kChunks; idx += kThreads) {
      const bool is_v = idx >= nvalid * kChunks;
      const int rel = is_v ? idx - nvalid * kChunks : idx;
      const int s = rel / kChunks, c8 = rel % kChunks;
      const uint16_t* src = (is_v ? w.v_pool : w.k_pool) +
          (((size_t)blk * w.BS + s) * w.Hkv + h) * D + c8 * 8;
      uint16_t* dst = (is_v ? vt + s * D : kt + s * kKStride) + c8 * 8;
      cp_async(reinterpret_cast<uint32_t*>(dst),
               reinterpret_cast<const uint32_t*>(src), 4);
    }
    asm volatile("cp.async.commit_group;" ::);
  };
  if (j0 < j1) stage(first, j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int i = j - j0;
    if (j + 1 < j1) {
      stage(trow[j + 1], j + 1, (i + 1) & 1);
      asm volatile("cp.async.wait_group 1;" ::);
    } else {
      asm volatile("cp.async.wait_group 0;" ::);
    }
    // the slot has landed, and q is in shared memory
    __syncthreads();
    const uint16_t* kt = ring + (i & 1) * slot_elems;
    if (nr > 1)
      flash_block_rows<DPL, GR>(kt, kt + w.BS * kKStride, qs,
                                min(w.BS, len - j * w.BS), w.scale, warp,
                                lane, nr, st);
    else                            // one live row a warp (G*T <= 4)
      flash_block_keys<DPL>(kt, kt + w.BS * kKStride, qs,
                            min(w.BS, len - j * w.BS), w.scale, warp, lane,
                            st);
    __syncthreads();                     // the slot may be refilled
  }
  if (w.splits == 1) {
    store_rows<DPL>(w, w.acc, w.m, w.l, b, h, lane, st);
    return;
  }
  const size_t slab = (size_t)w.B * w.Hkv * w.G * w.T;
  float* pm = w.ws + w.splits * slab * D;
  store_rows<DPL>(w, w.ws + split * slab * D, pm + split * slab,
                  pm + (w.splits + split) * slab, b, h, lane, st);
  asm volatile("griddepcontrol.launch_dependents;");    // the merge may start
}

// Merge the partial states of `splits` table chunks, one thread per output
// element, in chunk order: m = max m_s, l = sum l_s exp(m_s - m), acc =
// sum acc_s exp(m_s - m). ws: acc (splits, rows, D), then m and l (splits,
// rows).
__global__ void merge_splits_kernel(const float* __restrict__ ws,
                                    float* __restrict__ acc,
                                    float* __restrict__ m,
                                    float* __restrict__ l, int splits,
                                    int rows, int D) {
  // launched as a programmatic dependent of the walk: wait for its
  // partial states
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(rows) * D) return;
  const int row = static_cast<int>(idx / D);
  const bool lead = idx % D == 0;
  const float* pm = ws + static_cast<size_t>(splits) * rows * D;
  const float* pl = pm + static_cast<size_t>(splits) * rows;
  // splits in batches of 8: each batch's loads are issued together
  float mx = kNegInf;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float mv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      mv[u] = s0 + u < splits ? pm[(size_t)(s0 + u) * rows + row] : kNegInf;
#pragma unroll
    for (int u = 0; u < 8; ++u) mx = fmaxf(mx, mv[u]);
  }
  float a = 0.f, ls = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float mv[8], av[8], lv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = s0 + u < splits;
      mv[u] = in ? pm[(size_t)(s0 + u) * rows + row] : kNegInf;
      av[u] = in ? ws[(size_t)(s0 + u) * rows * D + idx] : 0.f;
      lv[u] = in && lead ? pl[(size_t)(s0 + u) * rows + row] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u >= splits) break;
      const float c = expf(mv[u] - mx);
      a += av[u] * c;
      ls += lv[u] * c;
    }
  }
  acc[idx] = a;
  if (lead) {
    m[row] = mx;
    l[row] = ls;
  }
}

// One thread per (row, 32-dim word) of a whole pool, the packed kernel's
// two-phase decode (unary positions in shared memory, then the values).
__global__ void __launch_bounds__(kThreads)
decode_rows_kernel(Spec sp, Codec c, uint16_t* out, int rows, int dw) {
  __shared__ int utot[kThreads];
  extern __shared__ __align__(16) uint32_t dyn[];      // (kThreads/dw, keep)
  int16_t* upos = reinterpret_cast<int16_t*>(dyn);
  const size_t task = blockIdx.x * static_cast<size_t>(kThreads) +
                      threadIdx.x;
  const int lr = threadIdx.x / dw, wi = static_cast<int>(task % dw);
  const bool live = task < static_cast<size_t>(rows) * dw;
  const size_t row = live ? task / dw : static_cast<size_t>(rows) - 1;
  const int mode = sp.mode[row];
  unary_positions(sp.exp_words + row * c.we, c.we, c.keep, wi, dw,
                  live && mode == 0, upos + lr * c.keep, utot + lr);
  __syncthreads();
  if (!live) return;
  decode_word(sp.bitmap + row * dw, sp.signmant + row * c.wsm,
              sp.exp_words + row * c.we, wi, mode, sp.emax[row], c, c.book,
              upos + lr * c.keep, utot[lr], out + row * dw * 32 + 32 * wi);
}

template <int DPL, int GR>
cudaError_t launch_plain_g(const Walk& w, dim3 grid, size_t ring_bytes,
                           cudaStream_t stream) {
  static size_t granted = 0;
  const size_t total = ring_bytes + sizeof(float) * kQTile * kMaxD;
  if (total > 48 * 1024 && ring_bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_kernel<DPL, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring_bytes));
    if (e != cudaSuccess) return e;
    granted = ring_bytes;
  }
  paged_gqa_kernel<DPL, GR><<<grid, kThreads, ring_bytes, stream>>>(w);
  return cudaGetLastError();
}

// Lane groups of the flash step: as many rows a pass as the block's keys
// leave lanes for (32, 16 or 8 key lanes).
template <int DPL>
cudaError_t launch_plain_d(const Walk& w, dim3 grid, size_t ring_bytes,
                           cudaStream_t stream) {
  if (w.BS > 16) return launch_plain_g<DPL, 1>(w, grid, ring_bytes, stream);
  if (w.BS > 8) return launch_plain_g<DPL, 2>(w, grid, ring_bytes, stream);
  return launch_plain_g<DPL, 4>(w, grid, ring_bytes, stream);
}

// The split-order merge of a split walk's partial states, launched as a
// programmatic dependent of the walk.
cudaError_t launch_merge(const Walk& w, cudaStream_t stream) {
  const int rows = w.B * w.Hkv * w.G * w.T;
  const size_t n = static_cast<size_t>(rows) * w.D;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>((n + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_splits_kernel,
                            static_cast<const float*>(w.ws), w.acc, w.m, w.l,
                            w.splits, rows, w.D);
}

template <int DPL>
cudaError_t launch_packed_d(const Walk& w, dim3 grid, size_t ring_bytes,
                            cudaStream_t stream) {
  static size_t granted = 0;
  const size_t total = ring_bytes + sizeof(uint16_t) * kMaxBS *
      (kKStride + kMaxD) + sizeof(float) * kQTile * kMaxD + 32;
  if (total > 48 * 1024 && ring_bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_packed_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring_bytes));
    if (e != cudaSuccess) return e;
    granted = ring_bytes;
  }
  paged_gqa_packed_kernel<DPL><<<grid, kThreads, ring_bytes, stream>>>(w);
  return cudaGetLastError();
}

inline int round4(int x) { return (x + 3) & ~3; }

inline int imin(int a, int b) { return a < b ? a : b; }

int granule(const void* p, int n) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  if (n % 4 == 0 && u % 16 == 0) return 4;
  if (n % 2 == 0 && u % 8 == 0) return 2;
  return 1;
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

// `bps` table blocks per CTA; with more than one split, the partial states
// go to `ws` (acc (splits, B, Hkv, G, T, D), then m and l (splits, B, Hkv,
// G, T)) and a second kernel merges them into (acc, m, l).
extern "C" int paged_gqa_launch(const void* q, const void* k_pool,
                                const void* v_pool, const void* table,
                                const void* length, void* acc, void* m,
                                void* l, void* ws, int B, int T, int Hkv,
                                int G, int D, int NB, int BS, int MB, int bps,
                                float scale, void* stream) {
  if (BS < 1 || BS > kMaxBS || bps < 1 || (D != 32 && D != 64 && D != 128) ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk w = make_walk(q, table, length, acc, m, l, B, T, Hkv, G, D, NB, BS, MB,
                     scale);
  w.k_pool = static_cast<const uint16_t*>(k_pool);
  w.v_pool = static_cast<const uint16_t*>(v_pool);
  w.bps = bps;
  w.splits = MB > 0 ? (MB + bps - 1) / bps : 1;
  if (w.splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  w.ws = static_cast<float*>(ws);
  if (B * Hkv * G * T == 0) return 0;
  const dim3 grid(B * Hkv, w.splits, (G * T + kQTile - 1) / kQTile);
  const size_t ring_bytes =
      static_cast<size_t>(2) * BS * (kKStride + D) * sizeof(uint16_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_plain_d<1>(w, grid, ring_bytes, s); break;
    case 64: e = launch_plain_d<2>(w, grid, ring_bytes, s); break;
    default: e = launch_plain_d<4>(w, grid, ring_bytes, s); break;
  }
  if (e != cudaSuccess || w.splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge(w, s));
}

// `bps` table blocks per CTA; with more than one split, the partial states
// go to `ws` (acc (splits, B, Hkv, G, T, D), then m and l (splits, B, Hkv,
// G, T)) and a second kernel merges them into (acc, m, l).
extern "C" int paged_gqa_packed_launch(
    const void* q, const void* kbm, const void* ksm, const void* kew,
    const void* kmo, const void* kem, const void* vbm, const void* vsm,
    const void* vew, const void* vmo, const void* vem, const void* book,
    const void* table, const void* length, void* acc, void* m, void* l,
    void* ws, int B, int T, int Hkv, int G, int D, int NB, int BS, int MB,
    int keep, int trunc, int exp_bits, int wsm, int we, int bps,
    float scale, void* stream) {
  if (BS < 1 || BS > kMaxBS || bps < 1 || (D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Walk w = make_walk(q, table, length, acc, m, l, B, T, Hkv, G, D, NB, BS,
                     MB, scale);
  w.splits = MB > 0 ? (MB + bps - 1) / bps : 1;
  if (w.splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  w.ws = static_cast<float*>(ws);
  w.k_spec = make_spec(kbm, ksm, kew, kmo, kem);
  w.v_spec = make_spec(vbm, vsm, vew, vmo, vem);
  w.codec = Codec{static_cast<const uint8_t*>(book), keep, trunc, exp_bits,
                  wsm, we};
  const int dw = D / 32;
  w.bps = bps;
  w.sm0 = round4(dw);
  w.ew0 = w.sm0 + round4(wsm + 1);
  w.rs = w.ew0 + round4(we + 1);
  w.g_bm = imin(granule(kbm, dw), granule(vbm, dw));
  w.g_sm = imin(granule(ksm, wsm), granule(vsm, wsm));
  w.g_ew = imin(granule(kew, we), granule(vew, we));
  const int rows = B * Hkv * G * T;
  if (rows == 0) return 0;
  const dim3 grid(B * Hkv, w.splits, (G * T + kQTile - 1) / kQTile);
  // the ring's two slots, then the unary positions of one block's rows
  const size_t ring_bytes = static_cast<size_t>(2) * 2 * BS * w.rs * 4 +
                            static_cast<size_t>(2) * BS * keep * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_packed_d<1>(w, grid, ring_bytes, s); break;
    case 64: e = launch_packed_d<2>(w, grid, ring_bytes, s); break;
    default: e = launch_packed_d<4>(w, grid, ring_bytes, s); break;
  }
  if (e != cudaSuccess || w.splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge(w, s));
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
  const size_t tasks = static_cast<size_t>(rows) * (D / 32);
  const size_t pos_bytes =
      static_cast<size_t>(kThreads / (D / 32)) * keep * sizeof(int16_t);
  decode_rows_kernel<<<static_cast<unsigned>((tasks + kThreads - 1) / kThreads),
                       kThreads, pos_bytes, static_cast<cudaStream_t>(stream)>>>(
      sp, c, static_cast<uint16_t*>(out), rows, D / 32);
  return static_cast<int>(cudaGetLastError());
}
