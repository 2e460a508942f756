// Cassandra-1 unary exponent decode for Hopper (sm_90a), alone and inside
// the one-launch reconstruction of a packed weight's exact (target) view.
//
// Replaces the TPU kernel `unary_decode` (src/repro/kernels/unary_decode.py,
// `_kernel`) and, in `target_decode`, the reference's chain around it for a
// whole weight: `format.target_tensor` with `coding.decode_exponents`,
// `delta_decode_block` and `pruning.desparsify` (src/repro/core/).
//
// The unary code. A region of W uint32 words (little-endian bits) holds codes
// of `rank` zeros ended by a one. Code j's rank is pos_j - pos_{j-1} - 1,
// where pos_j is the position of the (j+1)-th set bit (W*32 when the region
// holds fewer) and pos_{-1} = -1, clipped to [0, 31]: the TPU kernel's
// compare-count pos_j = #{p : prefix(p) <= j}, bit for bit, including
// regions that run into the word padding or hold fewer than K ones.
// One warp decodes one region with no serial walk of the region
// (`unary_positions`, the form of paged_gqa.cu's packed decode):
//   * lane w takes word w of each 32-word chunk; a warp scan of __popc gives
//     the ones before its word, so the lane writes its word's set-bit
//     positions straight to their slots pos[j] in shared memory, the
//     highest first, one step a bit (FLO, a clear, one predicated store),
//     as many steps as the warp's fullest word needs; slots past the
//     region's ones hold W*32;
//   * every rank is then two shared-memory reads, pos[j] - pos[j-1] - 1.
// Two regions (a superblock's kept and pruned exponents) share one pass:
// one scan carries both counts and a step stores a bit of each.
//
// `unary_decode` (the standalone entry: the KV views and the C-1 draft-view
// weight decode call it through `coding.decode_exponents`): one warp per
// region; lane l writes ranks l, l + 32, ... as coalesced int32 stores.
// Bound: a region read once (4 W bytes), its ranks written once (4 K
// bytes).
//
// `target_decode`: the bf16 (N, NB * block) exact view of one packed C-1
// weight in one launch, from its spec leaves (bitmap, sign|mantissa codes,
// exponent region, mode, emax, 32-entry book) and verif leaves (low mantissa
// codes, the pruned values as 8-bit sign|mantissa codes with an exponent
// region of their own, or raw 16-bit patterns; the optional nibble
// corrections of mode-1 regions). It computes, bit for bit, what the plain
// chain `format.target_weight_plain` computes:
//   * mode 0 (unary): exponent = book[rank]; mode 1: a 3-bit (`exp_bits`)
//     delta below the superblock's max exponent plus its correction nibble,
//     exponent 0 for the escape code with correction 15 (escape code alone
//     when the weight carries no corrections), clamped to [0, 255];
//   * kept value = sign | exponent | high mantissa | low mantissa; pruned
//     value = its 8-bit code's sign and mantissa with its own exponent, or
//     its raw pattern; with nothing pruned (keep == block), zero;
//   * scattered back by the bitmap: kept indices and pruned indices are
//     prefix counts of set and clear bits, clamped at keep - 1 and at
//     block - keep - 1, as `pruning.desparsify` clamps them.
// What bounds it on this card: the packed streams read once (1.51 B per
// weight at the paper's defaults, the correction nibbles of mode-1
// superblocks only) and the bf16 view written once (2 B): about 61 us for
// Llama-3-8B's w_gate at 3.35 TB/s. The work is integer ALU and
// shared-memory traffic with short dependent chains (PERF.md has its time
// against that bound). The design:
//   * one warp owns one 512-value superblock at a time; a CTA of 8 warps owns
//     a run of superblocks (`target_plan` in unary_decode.py sizes the runs
//     so the grid is one wave), the warps interleaved along it;
//   * each warp streams its superblocks through a two-stage ring in shared
//     memory: `cp.async` (16-byte pieces where the regions allow, listed
//     once per CTA in a table of the stage's pieces) fills the next
//     superblock's packed words while the current one decodes; the
//     mode/emax bytes are loaded one superblock ahead of the copies, so a
//     mode-0 region's correction nibbles are never copied;
//   * the mode byte picks the exponent path per superblock (warp-uniform):
//     a unary region's set-bit positions go to shared memory as above (the
//     kept and the pruned region in one pass) and each rank is two reads,
//     or a mode-1 region's delta codes are read where they lie;
//   * lane l then builds its run of kept values (10 at the paper's
//     defaults) and its run of pruned values (6) into a bf16 array in
//     shared memory, over the positions once they are read: with 4-bit
//     sign|mantissa and low-mantissa codes (the paper's truncation) each
//     run's codes come from one funnel-shifted 64-bit window per stream;
//     and lane l gathers positions 16l..16l+15 from that array: a warp
//     scan of the bitmap's __popc gives its first kept index (the clamps
//     of arbitrary bitmaps only where an index would leave the values),
//     and the lane's 32 output bytes leave as two 16-byte stores, the
//     warp's 1 KB coalesced.
// The product that follows stays outside the kernel (torch.matmul on this
// view in models/layers.py::dense, as the reference leaves it to XLA).
//
// `kv_view`: a Cassandra-1 KV store's draft or target view, (rows, D) bf16,
// in one launch, where the reference runs `format.draft_tensor` /
// `target_tensor` over the store (`serving/kvcache.py::read_store`): the
// chain of `decode_exponents` (here with 8-bit corrections, one byte a kept
// value, and a cache-global book passed apart from the store) and
// `pruning.desparsify`. Bit for bit what that chain computes:
//   * mode 0: exponent = book[rank] with the ranks above; mode 1: an
//     exp_bits-wide delta below emax, plus its correction in the target view
//     (none where it is 255; exponent 0 for the escape code with correction
//     255), clamped to [0, 255]; the draft view reads the deltas alone;
//   * kept value = sign | exponent | high mantissa | low mantissa (the
//     draft view: low mantissa 0); the target view's pruned values are their
//     raw 16-bit patterns (NaN payloads kept); the draft view's pruned
//     positions are 0;
//   * scattered by the bitmap, the indices clamped at keep - 1 and D - keep
//     - 1 as `desparsify` clamps them.
// Bound: the store's leaves read once (the draft view reads only `spec`:
// bitmap, codes, exponent region, mode, emax) and the bf16 view written once.
// The design: a CTA owns a run of `chunk` vectors (`kv_view_plan` in
// unary_decode.py: a multiple of 16, so each leaf's run starts on a 16-byte
// boundary of an aligned leaf) and first copies each leaf's run, which is
// contiguous, into shared memory with cp.async (16-byte pieces on 16-byte
// aligned leaves, 4-byte on 4-byte aligned ones, bytes otherwise; nothing
// past the run is read); then the vectors of the run are decoded from
// shared memory by lane groups: G lanes a vector, D/16 rounded up to a
// power of two (the width of the group shuffles must be one: 8 at D = 96
// and at D = 128, so a warp decodes 4 at once), lane g < D/16 owning 16
// output positions (8 g .. 8 g + 7 and D/2 + 8 g .., so that a store
// instruction writes each group's half vector as contiguous bytes, not
// half sectors at a 32-byte stride; at D = 96 lanes 6 and 7 own none) and
// every lane a run of ceil(keep / G) kept values. A vector's fixed costs (its
// scans, its run's start, the loop) are shared by 16 positions a lane, where
// a warp a vector spent them on D/32. A KV region is short (8 words at D =
// 128), so the position pass above, which walks each word's ones on the
// lane that holds it, would leave most lanes idle for as many steps as the
// densest word has ones; here each lane finds the start of its run (a group
// scan of the words' __popc counts, a binary search of those counts for the
// word holding the end of the code before the run) and walks the run's set
// bits in order (__ffs and a clear a code). The lane builds its run of kept
// values into a bf16 array (4-bit codes from one funnel-shifted window a
// stream), then gathers its 16 positions by a group scan of the bitmap's
// __popc and writes them as two 16-byte stores. The grid is persistent, and
// each CTA streams its runs through a two-stage cp.async ring.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                 // both kernels: 8 warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRank = 31;
constexpr int kRegions = 8;
constexpr int kMinCtas = 4;               // target_decode, kv_view: CTAs an SM

__device__ __forceinline__ int clip_rank(int r) {
  return min(max(r, 0), kMaxRank);
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += a;
  }
  return v;
}

constexpr int kRun = 16;          // codes per lane at most: K <= 512

// A unary region to decode: W words at R, its first K set-bit positions
// into pos (int16: W <= 1023).
struct Unary {
  const uint32_t* R;
  int W, K;
  int16_t* pos;
};

// x with only its lowest m set bits (m >= 0). The loop runs only for a
// word that holds more ones than codes are left.
__device__ __forceinline__ uint32_t lowest_ones(uint32_t x, int m) {
  while (__popc(x) > m) x &= ~(0x80000000u >> __clz(x));
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 16-bit store *p = v where live > 0, as one predicated st.shared (a
// branch around a plain store costs more than the store).
__device__ __forceinline__ void st_u16_if(unsigned p, int v, int live) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.gt.s32 q, %2, 0;\n\t"
      "@q st.shared.u16 [%0], %1;\n\t}" ::"r"(p),
      "h"(static_cast<unsigned short>(v)), "r"(live)
      : "memory");
}

// pos[j] for j < K: the position of the region's (j+1)-th set bit, W*32
// where the region holds fewer. Lane w places the ones of word w of each
// 32-word chunk after a warp scan of __popc; with TWO, region b in the
// same pass (both counts in one scan, b's in the high 16 bits: a region
// holds at most 32736 ones). The whole warp calls it; __syncwarp before
// reading pos.
template <bool TWO>
__device__ __forceinline__ void unary_positions(const Unary& a,
                                                const Unary& b, int lane) {
  int base = 0;
  const int W = TWO ? max(a.W, b.W) : a.W;
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int wi = c0 + lane;
    uint32_t xa = wi < a.W ? a.R[wi] : 0u;
    uint32_t xb = TWO && wi < b.W ? b.R[wi] : 0u;
    const int na = __popc(xa), nb = TWO ? __popc(xb) : 0;
    const int incl = warp_incl_sum(na | nb << 16, lane);
    const int before = base + incl - (na | nb << 16);
    const int ka = before & 0xFFFF, kb = before >> 16;
    // the word's ones that are codes < K, stored in steps of one set bit
    // of each region, as many steps as the warp's fullest word needs; the
    // highest one first (its slot is the word's last), so that a step is
    // FLO, a clear and one predicated store
    const int ca = max(0, min(na, a.K - ka));
    const int cb = TWO ? max(0, min(nb, b.K - kb)) : 0;
    if (ca < na) xa = lowest_ones(xa, ca);
    if (TWO && cb < nb) xb = lowest_ones(xb, cb);
    const int steps = __reduce_max_sync(kFull, max(ca, cb));
    const unsigned qa = smem_u32(a.pos + ka + ca - 1);
    const unsigned qb = TWO ? smem_u32(b.pos + kb + cb - 1) : 0u;
    const int pw = wi * 32;
    for (int i0 = 0; i0 < steps; i0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        const int za = __clz(xa);
        st_u16_if(qa - 2 * i, pw + 31 - za, ca - i);
        xa &= ~__funnelshift_rc(0x80000000u, 0u, za);
        if (TWO) {
          const int zb = __clz(xb);
          st_u16_if(qb - 2 * i, pw + 31 - zb, cb - i);
          xb &= ~__funnelshift_rc(0x80000000u, 0u, zb);
        }
      }
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  for (int j = (base & 0xFFFF) + lane; j < a.K; j += 32)
    a.pos[j] = static_cast<int16_t>(a.W * 32);
  if (TWO)
    for (int j = (base >> 16) + lane; j < b.K; j += 32)
      b.pos[j] = static_cast<int16_t>(b.W * 32);
}

// Code j's rank from the positions: two reads.
__device__ __forceinline__ int rank_at(const int16_t* pos, int j) {
  const int prev = j > 0 ? pos[j - 1] : -1;
  return clip_rank(pos[j] - prev - 1);
}

// Exponents of codes j0 .. j0 + n - 1 of a unary region: book[rank], each
// rank the difference of consecutive positions. PAIRS: the run's
// positions as RUN / 2 32-bit reads (RUN even, j0 even, pos 4-byte
// aligned, and the whole run inside the array).
template <int RUN, bool PAIRS>
__device__ __forceinline__ void unary_run(const int16_t* pos,
                                          const uint8_t* book, int j0, int n,
                                          uint32_t (&e)[RUN]) {
  int p[RUN + 1];
  p[0] = j0 > 0 ? pos[j0 - 1] : -1;
  if constexpr (PAIRS) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(pos + j0);
#pragma unroll
    for (int k = 0; k < RUN / 2; ++k) {
      const uint32_t v = pw[k];
      p[2 * k + 1] = static_cast<int>(v & 0xFFFFu);
      p[2 * k + 2] = static_cast<int>(v >> 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) p[k + 1] = k < n ? pos[j0 + k] : 0;
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k)
    if (k < n) e[k] = book[clip_rank(p[k + 1] - p[k] - 1)];
}

// ---------------------------------------------------------------------------
// unary_decode: (rows, W) regions -> (rows, K) int32 ranks
// ---------------------------------------------------------------------------

// Per warp: one region's K positions (int16) in shared memory; its ranks
// leave as coalesced int32 stores.
__global__ void __launch_bounds__(kThreads)
unary_decode_kernel(const uint32_t* __restrict__ words,
                    int32_t* __restrict__ out, int rows, int W, int K) {
  extern __shared__ __align__(16) int16_t pos_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;                          // whole warps only
  const Unary u{words + row * W, W, K, pos_smem + warp * K};
  unary_positions<false>(u, u, lane);
  __syncwarp();
  int32_t* o = out + row * K;
  for (int j = lane; j < K; j += 32) o[j] = rank_at(u.pos, j);
}

// ---------------------------------------------------------------------------
// target_decode: one packed C-1 weight -> its bf16 (N, NB * block) view
// ---------------------------------------------------------------------------

// Regions of one superblock, in stage order; the correction nibbles last.
enum Region { kBitmap, kSignMant, kExpWords, kMantLo, kPruned, kPExpWords,
              kCorr, kPCorr };
constexpr int kMaxPieces = 1024;          // a stage's cp.async pieces

struct Target {
  const uint32_t* src[kRegions];  // (S, nw[r]) words each; null if absent
  const uint8_t* mode;            // (S,)
  const uint8_t* emax;
  const uint8_t* pmode;           // coded pruned values only
  const uint8_t* pemax;
  const uint8_t* book;            // 32 entries
  const uint8_t* pbook;
  uint16_t* out;                  // (S, block) bf16 bit patterns
  long long S;                    // superblocks: N * NB
  int block, keep, P, trunc, eb, chunk;
  int pruned;                     // 0 none, 1 coded, 2 raw
  int nw[kRegions];               // words per superblock
  int off[kRegions];              // word offset inside a stage
  int gran[kRegions];             // cp.async piece, in words (4, 2 or 1)
  int stage_words, warp_words;
};

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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Where a region's words come from: superblock s's lie at base + s * nw.
struct Feed {
  const uint32_t* base;
  int nw, pad;
};

// One superblock's packed words into a stage. The CTA's piece table lists
// every cp.async piece of a stage (dst word | src word << 12 | region << 24
// | piece words << 27), the correction regions' last; lane l copies pieces
// l, l + 32, ..., and a region's correction nibbles only where its mode
// byte (md, pmd) is 1.
__device__ __forceinline__ void stage_copy(const uint32_t* table, int n_main,
                                           int n_all, const Feed* feed,
                                           uint32_t* st, int s, int md,
                                           int pmd, int lane) {
  const int n = (md | pmd) != 0 ? n_all : n_main;
  for (int p = lane; p < n; p += 32) {
    const uint32_t e = table[p];
    const int r = static_cast<int>(e >> 24) & 7;
    if ((r == kCorr && md == 0) || (r == kPCorr && pmd == 0)) continue;
    const Feed f = feed[r];
    cp_async(st + (e & 0xFFFu),
             f.base + (s * f.nw + static_cast<int>((e >> 12) & 0xFFFu)),
             static_cast<int>(e >> 27));
  }
  asm volatile("cp.async.commit_group;" ::);
}

// `mask` bits at bit offset `bit` of a staged word stream (the stage pads
// every region by two words, so word wi + 1 is always readable).
__device__ __forceinline__ uint32_t bits_at(const uint32_t* R, int bit,
                                            uint32_t mask) {
  const int wi = bit >> 5;
  return __funnelshift_r(R[wi], R[wi + 1], bit) & mask;
}

// Exponent of code j of a mode-1 region: delta below emax plus its
// correction nibble (C: the packed nibbles, or null), the escape read as 0.
__device__ __forceinline__ uint32_t delta_exp(const uint32_t* R,
                                              const uint32_t* C, int j,
                                              int eb, int emax) {
  const int esc = (1 << eb) - 1;
  const int code = static_cast<int>(bits_at(R, j * eb, esc));
  int delta = code;
  bool zero = code == esc;
  if (C != nullptr) {
    const int c = static_cast<int>((C[j >> 3] >> ((j & 7) * 4)) & 15u);
    delta += c == 15 ? 0 : c;
    zero = zero && c == 15;
  }
  return zero ? 0u : static_cast<uint32_t>(min(max(emax - delta, 0), 255));
}

// Kept values j0 .. j0 + n - 1 (exponents e[]) into vals. FAST: 4-bit
// sign|mantissa and low-mantissa codes, the run's codes from one 64-bit
// window per stream (the stage pads every region by two words).
template <bool FAST, int RUN>
__device__ __forceinline__ void kept_run(const uint32_t* SM,
                                         const uint32_t* ML, int j0, int n,
                                         int tr, const uint32_t (&e)[RUN],
                                         uint16_t* vals) {
  if constexpr (FAST) {
    const int w = j0 >> 3, sh = (j0 & 7) * 4;
    const uint32_t s0 = __funnelshift_r(SM[w], SM[w + 1], sh);
    const uint32_t s1 = __funnelshift_r(SM[w + 1], SM[w + 2], sh);
    const uint32_t m0 = __funnelshift_r(ML[w], ML[w + 1], sh);
    const uint32_t m1 = __funnelshift_r(ML[w + 1], ML[w + 2], sh);
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < n) {
        const uint32_t c = ((k < 8 ? s0 : s1) >> (4 * (k & 7))) & 15u;
        const uint32_t lo = ((k < 8 ? m0 : m1) >> (4 * (k & 7))) & 15u;
        vals[j0 + k] = static_cast<uint16_t>((c >> 3) << 15 | e[k] << 7 |
                                             (c & 7u) << 4 | lo);
      }
    }
  } else {
    const int ws = 8 - tr, tk = 7 - tr;
    const uint32_t smask = (1u << ws) - 1u, tmask = (1u << tk) - 1u;
    const uint32_t lmask = (1u << tr) - 1u;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < n) {
        const int j = j0 + k;
        const uint32_t c = bits_at(SM, j * ws, smask);
        const uint32_t lo = tr ? bits_at(ML, j * tr, lmask) : 0u;
        vals[j] = static_cast<uint16_t>(((c >> tk) & 1u) << 15 | e[k] << 7 |
                                        (((c & tmask) << tr) | lo) & 0x7Fu);
      }
    }
  }
}

// Exponents of codes j0 .. j0 + n - 1 of a mode-1 region: the delta codes
// below emax.
template <int RUN>
__device__ __forceinline__ void delta_run(const uint32_t* R, const uint32_t* C,
                                          int emax, int eb, int j0, int n,
                                          uint32_t (&e)[RUN]) {
#pragma unroll
  for (int k = 0; k < RUN; ++k)
    if (k < n) e[k] = delta_exp(R, C, j0 + k, eb, emax);
}

// The PPL values at positions p0 .. p0 + PPL - 1, packed two to a word:
// a set bit takes the next kept value (from kb), a clear one the next
// pruned value (0 when nothing is pruned). CLAMP: the indices clamped at
// K - 1 and P - 1, as `pruning.desparsify` clamps them; without it every
// index must already lie in range.
template <int PPL, bool CLAMP>
__device__ __forceinline__ void gather_run(const uint16_t* vals,
                                           uint32_t bits, int kb, int p0,
                                           int K, int P, bool has_p,
                                           uint32_t (&pk)[(PPL + 1) / 2]) {
  uint32_t v[PPL];
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const bool set = (bits >> i) & 1u;
    if constexpr (CLAMP) {
      const int idx = set ? min(kb, K - 1) : K + min(p0 + i - kb, P - 1);
      v[i] = (set || has_p) ? vals[idx] : 0u;
    } else {
      v[i] = vals[set ? kb : K + p0 + i - kb];
    }
    kb += set;
  }
#pragma unroll
  for (int i = 0; i < PPL; i += 2)
    pk[i >> 1] = i + 1 < PPL ? __byte_perm(v[i], v[i + 1], 0x5410) : v[i];
}

template <int PPL, bool FAST, int KRUN, int PRUN>
__device__ __forceinline__ void decode_superblock(
    const Target& a, const uint32_t* st, int mode, int emax, int pmode,
    int pemax, const uint8_t* book, const uint8_t* pbook, uint16_t* vals,
    uint16_t* out, int lane) {
  const int K = a.keep, P = a.P;
  // runs of ceil(K/32) kept and ceil(P/32) pruned values a lane (KRUN and
  // PRUN when those are exact, so the divisions below fold)
  const int krun = KRUN < kRun ? KRUN : (K + 31) >> 5;
  const int prun = PRUN < kRun ? PRUN : (P + 31) >> 5;
  const int kj0 = lane * krun, kn = min(krun, K - kj0);
  const int pj0 = lane * prun, pn = min(prun, P - pj0);
  const bool coded = a.pruned == 1;
  // 1. lane l's runs of kept and pruned exponents. Unary regions (mode 0,
  // the same on the whole warp) first put their set-bit positions in
  // shared memory, kept then pruned, where `vals` will be (K + P values);
  // mode-1 regions read their delta codes.
  const bool ku = mode == 0, pu = coded && pmode == 0;
  const Unary uk{st + a.off[kExpWords], a.nw[kExpWords], K,
                 reinterpret_cast<int16_t*>(vals)};
  const Unary up{st + a.off[kPExpWords], a.nw[kPExpWords], P,
                 reinterpret_cast<int16_t*>(vals) + K};
  if (ku && pu)
    unary_positions<true>(uk, up, lane);
  else if (ku)
    unary_positions<false>(uk, uk, lane);
  else if (pu)
    unary_positions<false>(up, up, lane);
  __syncwarp();
  uint32_t ke[KRUN], pe[PRUN];
  // the paper's exact runs (K = 32 * KRUN, P = 32 * PRUN) read pairs
  constexpr bool kPairs = KRUN < kRun && KRUN % 2 == 0 && PRUN % 2 == 0;
  if (ku)
    unary_run<KRUN, kPairs>(uk.pos, book, kj0, kn, ke);
  else
    delta_run<KRUN>(uk.R, a.nw[kCorr] ? st + a.off[kCorr] : nullptr, emax,
                    a.eb, kj0, kn, ke);
  if (pu)
    unary_run<PRUN, kPairs>(up.pos, pbook, pj0, pn, pe);
  else if (coded)
    delta_run<PRUN>(up.R, a.nw[kPCorr] ? st + a.off[kPCorr] : nullptr,
                    pemax, a.eb, pj0, pn, pe);
  __syncwarp();                               // positions read: vals free
  // 2. the values
  if (kn > 0)
    kept_run<FAST, KRUN>(st + a.off[kSignMant], st + a.off[kMantLo], kj0, kn,
                         a.trunc, ke, vals);
  if (pn > 0) {
    const uint32_t* PS = st + a.off[kPruned];
    if (coded) {
#pragma unroll
      for (int k = 0; k < PRUN; ++k) {
        if (k < pn) {
          const int j = pj0 + k;
          const uint32_t pc = (PS[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
          vals[K + j] = static_cast<uint16_t>((pc >> 7) << 15 | pe[k] << 7 |
                                              (pc & 0x7Fu));
        }
      }
    } else if (a.pruned == 2) {             // raw 16-bit patterns
#pragma unroll
      for (int k = 0; k < PRUN; ++k) {
        const int j = pj0 + k;
        if (k < pn) vals[K + j] = static_cast<uint16_t>(PS[j >> 1] >>
                                                        ((j & 1) * 16));
      }
    }
  }
  __syncwarp();
  // 3. scatter: lane l owns positions PPL*l .. PPL*l + PPL - 1
  const uint32_t* BM = st + a.off[kBitmap];
  const int p0 = lane * PPL;
  const uint32_t word = BM[p0 >> 5];
  const uint32_t bits = (word >> (p0 & 31)) & ((1u << PPL) - 1u);
  const int cnt = __popc(bits);
  int kb = warp_incl_sum(cnt, lane) - cnt;        // kept values before p0
  uint32_t pk[(PPL + 1) / 2];
  if (a.pruned != 0 && kb + cnt <= K && p0 + PPL - kb - cnt <= P)
    gather_run<PPL, false>(vals, bits, kb, p0, K, P, true, pk);
  else                      // indices past the values (arbitrary bitmaps)
    gather_run<PPL, true>(vals, bits, kb, p0, K, P, a.pruned != 0, pk);
  uint16_t* o = out + p0;
  if constexpr (PPL == 16) {
    reinterpret_cast<uint4*>(o)[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    reinterpret_cast<uint4*>(o)[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
  } else if constexpr (PPL == 8) {
    reinterpret_cast<uint4*>(o)[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  } else if constexpr (PPL == 4) {
    reinterpret_cast<uint2*>(o)[0] = make_uint2(pk[0], pk[1]);
  } else if constexpr (PPL == 2) {
    reinterpret_cast<uint32_t*>(o)[0] = pk[0];
  } else {
    o[0] = static_cast<uint16_t>(pk[0]);
  }
}

// grid (CTAs): CTA c owns superblocks [c * chunk, (c + 1) * chunk); warp w
// takes every 8th of them from c * chunk + w.
template <int PPL, bool FAST, int KRUN, int PRUN>
__global__ void __launch_bounds__(kThreads, kMinCtas)
target_decode_kernel(Target a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint8_t books[64];
  __shared__ uint32_t table[kMaxPieces];
  __shared__ Feed feed[kRegions];
  __shared__ int pieces[2];                   // before the corrections, all
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 32)
    books[threadIdx.x] = a.book[threadIdx.x];
  else if (threadIdx.x < 64)
    books[threadIdx.x] = a.pbook != nullptr ? a.pbook[threadIdx.x - 32] : 0;
  else if (threadIdx.x < 64 + kRegions)
    feed[threadIdx.x - 64] = Feed{a.src[threadIdx.x - 64],
                                  a.nw[threadIdx.x - 64], 0};
  if (warp == 0) {                            // the piece table
    int n = 0;
    for (int r = 0; r < kRegions; ++r) {
      const int g = a.gran[r], c = a.nw[r] / g;
      for (int i = lane; i < c; i += 32)
        table[n + i] = static_cast<uint32_t>(a.off[r] + i * g) |
                       static_cast<uint32_t>(i * g) << 12 |
                       static_cast<uint32_t>(r) << 24 |
                       static_cast<uint32_t>(g) << 27;
      n += c;
      if (r == kCorr - 1 && lane == 0) pieces[0] = n;
    }
    if (lane == 0) pieces[1] = n;
  }
  __syncthreads();
  const int n_main = pieces[0], n_all = pieces[1];
  const long long s0 = static_cast<long long>(blockIdx.x) * a.chunk;
  const long long s1 = min(a.S, s0 + a.chunk);
  long long s = s0 + warp;
  if (s >= s1) return;                        // no CTA-wide barrier follows
  uint32_t* st0 = smem + warp * a.warp_words;
  uint32_t* st1 = st0 + a.stage_words;
  uint16_t* vals = reinterpret_cast<uint16_t*>(st1 + a.stage_words);
  const bool coded = a.pruned == 1;
  // mode and emax bytes run one superblock ahead of the copies, which need
  // the mode to skip unused corrections
  int md = a.mode[s], em = a.emax[s];
  int pmd = coded ? a.pmode[s] : 0, pem = coded ? a.pemax[s] : 0;
  stage_copy(table, n_main, n_all, feed, st0, static_cast<int>(s), md, pmd,
             lane);
  int nmd = 0, nem = 0, npmd = 0, npem = 0;
  if (s + kWarps < s1) {
    nmd = a.mode[s + kWarps];
    nem = a.emax[s + kWarps];
    if (coded) {
      npmd = a.pmode[s + kWarps];
      npem = a.pemax[s + kWarps];
    }
  }
  for (int it = 0; s < s1; s += kWarps, ++it) {
    const long long nx = s + kWarps, nx2 = nx + kWarps;
    int md2 = 0, em2 = 0, pmd2 = 0, pem2 = 0;
    if (nx < s1) {
      stage_copy(table, n_main, n_all, feed, (it & 1) ? st0 : st1,
                 static_cast<int>(nx), nmd, npmd, lane);
      if (nx2 < s1) {
        md2 = a.mode[nx2];
        em2 = a.emax[nx2];
        if (coded) {
          pmd2 = a.pmode[nx2];
          pem2 = a.pemax[nx2];
        }
      }
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();                             // every lane's copies landed
    decode_superblock<PPL, FAST, KRUN, PRUN>(
        a, (it & 1) ? st1 : st0, md, em, pmd, pem, books, books + 32, vals,
        a.out + s * a.block, lane);
    __syncwarp();                             // the stage is free again
    md = nmd;
    em = nem;
    pmd = npmd;
    pem = npem;
    nmd = md2;
    nem = em2;
    npmd = pmd2;
    npem = pem2;
  }
}

inline int round4(int x) { return (x + 3) & ~3; }

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

int granule(const void* p, int n) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  if (n % 4 == 0 && u % 16 == 0) return 4;
  if (n % 2 == 0 && u % 8 == 0) return 2;
  return 1;
}

template <int PPL, bool FAST, int KRUN, int PRUN>
cudaError_t launch_target_f(const Target& a, unsigned ctas,
                            size_t smem_bytes, cudaStream_t stream) {
  static size_t granted = 0;                  // dynamic smem granted so far
  if (smem_bytes > 48 * 1024 && smem_bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        target_decode_kernel<PPL, FAST, KRUN, PRUN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
    granted = smem_bytes;
  }
  target_decode_kernel<PPL, FAST, KRUN, PRUN>
      <<<ctas, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The paper's superblock (512 values, 320 kept, 4-bit codes) has runs of
// exactly 10 kept and 6 pruned values a lane; other formats take runs of
// up to 16 with a bound.
template <int PPL>
cudaError_t launch_target(const Target& a, unsigned ctas, size_t smem_bytes,
                          cudaStream_t stream) {
  if constexpr (PPL == 16) {
    if (a.trunc == 4 && a.keep == 320)
      return launch_target_f<16, true, 10, 6>(a, ctas, smem_bytes, stream);
  }
  return a.trunc == 4
             ? launch_target_f<PPL, true, kRun, kRun>(a, ctas, smem_bytes,
                                                      stream)
             : launch_target_f<PPL, false, kRun, kRun>(a, ctas, smem_bytes,
                                                       stream);
}

// ---------------------------------------------------------------------------
// kv_view: a C-1 KV store -> its bf16 (rows, D) draft or target view
// ---------------------------------------------------------------------------

enum KvLeaf { kvBitmap, kvSignMant, kvExp, kvMode, kvEmax, kvMantLo, kvCorr,
              kvPruned, kvLeaves };

struct KvView {
  const uint8_t* src[kvLeaves];   // (rows, bpv[r]) bytes each; null if absent
  int bpv[kvLeaves];              // bytes a vector (0: not read)
  int gran[kvLeaves];             // copy piece: 16, 4 or 1 bytes
  int soff[kvLeaves];             // byte offset of the run in shared memory
  const uint8_t* book;            // exp_of_rank, >= 32 entries
  uint16_t* out;                  // (rows, D) bf16 bit patterns
  long long rows;
  int chunk, keep, trunc, eb, sw, ew, mw;
  int stage_bytes, scratch_bytes; // shared memory: runs, then per-warp scratch
};

// A leaf's run of vectors [v0, v0 + nv) into shared memory: cp.async pieces
// of `gran` bytes, the bytes past the last whole piece one at a time.
__device__ __forceinline__ void kv_stage(const KvView& a, int r, uint8_t* smem,
                                         long long v0, int nv) {
  const int n = nv * a.bpv[r];
  if (n == 0) return;
  const uint8_t* src = a.src[r] + v0 * a.bpv[r];
  uint8_t* dst = smem + a.soff[r];
  const int g = a.gran[r];
  int done = 0;
  if (g == 16) {
    const int np = n >> 4;
    for (int p = threadIdx.x; p < np; p += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_u32(dst + 16 * p)), "l"(src + 16 * p));
    done = np << 4;
  } else if (g == 4) {
    const int np = n >> 2;
    for (int p = threadIdx.x; p < np; p += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_u32(dst + 4 * p)), "l"(src + 4 * p));
    done = np << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Exponent of code j of a mode-1 region with 8-bit corrections (C null: the
// draft view, or a store without corrections).
__device__ __forceinline__ uint32_t kv_delta_exp(const uint32_t* R,
                                                 const uint8_t* C, int j,
                                                 int eb, int emax) {
  const int esc = (1 << eb) - 1;
  const int code = static_cast<int>(bits_at(R, j * eb, esc));
  int delta = code;
  bool zero = code == esc;
  if (C != nullptr) {
    const int c = C[j];
    delta += c == 255 ? 0 : c;
    zero = zero && c == 255;
  }
  return zero ? 0u : static_cast<uint32_t>(min(max(emax - delta, 0), 255));
}

// Position of the (r+1)-th set bit of x (r < __popc(x)).
__device__ __forceinline__ int nth_set(uint32_t x, int r) {
  int pos = 0, c = __popc(x & 0xFFFFu);
  if (r >= c) { r -= c; pos += 16; x >>= 16; }
  c = __popc(x & 0xFFu);
  if (r >= c) { r -= c; pos += 8; x >>= 8; }
  c = __popc(x & 0xFu);
  if (r >= c) { r -= c; pos += 4; x >>= 4; }
  c = __popc(x & 0x3u);
  if (r >= c) { r -= c; pos += 2; x >>= 2; }
  return pos + (r >= static_cast<int>(x & 1u));
}

// Exponents of codes j0 .. j0 + n - 1 (n >= 1) of a unary region of W words
// at R, whose inclusive per-word counts of ones are incl[0 .. W): the lane
// finds the word of the j0-th one (the j0 - 1 code's end) by a binary search
// of incl, then walks the set bits of its run in order. pos_j is the
// position of the (j+1)-th one, W*32 past the region's ones, pos_-1 = -1.
template <int RUN>
__device__ __forceinline__ void unary_walk(const uint32_t* R, int W,
                                           const int* incl,
                                           const uint8_t* book, int j0, int n,
                                           uint32_t (&e)[RUN]) {
  const int end = W * 32;
  const int j = j0 > 0 ? j0 - 1 : 0;
  int lo = 0, hi = W;                       // the first word with incl > j
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] > j) hi = mid;
    else lo = mid + 1;
  }
  int w = lo, pos = end;
  uint32_t x = 0;
  if (w < W) {
    x = R[w];
    const int b = nth_set(x, j - (w > 0 ? incl[w - 1] : 0));
    pos = 32 * w + b;
    x &= ~((2u << b) - 1u);                 // the ones up to b are taken
  }
  int prev = -1;
  if (j0 > 0) prev = pos;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (k < n) {
      if (k > 0 || j0 > 0) {                // the next one after pos
        while (x == 0u && w < W) {
          ++w;
          x = w < W ? R[w] : 0u;
        }
        if (w < W) {
          pos = 32 * w + __ffs(x) - 1;
          x &= x - 1u;
        } else {
          pos = end;
        }
      }
      e[k] = book[clip_rank(pos - prev - 1)];
      prev = pos;
    }
  }
}

// Kept values j0 .. j0 + n - 1 (exponents e[]) into vals; the low mantissa
// from ML (the target view) or 0 (ML null). FAST: 4-bit codes, the run's
// codes from one 64-bit window per stream (the stage pads every run by 16
// bytes, so words w + 1 and w + 2 are readable).
template <bool FAST, int RUN>
__device__ __forceinline__ void kv_kept_run(const uint32_t* SM,
                                            const uint32_t* ML, int j0, int n,
                                            int tr, const uint32_t (&e)[RUN],
                                            uint16_t* vals) {
  if constexpr (FAST) {
    const int w = j0 >> 3, sh = (j0 & 7) * 4;
    const uint32_t s0 = __funnelshift_r(SM[w], SM[w + 1], sh);
    const uint32_t s1 = RUN > 8 ? __funnelshift_r(SM[w + 1], SM[w + 2], sh)
                                : 0u;
    uint32_t m0 = 0u, m1 = 0u;
    if (ML != nullptr) {
      m0 = __funnelshift_r(ML[w], ML[w + 1], sh);
      if (RUN > 8) m1 = __funnelshift_r(ML[w + 1], ML[w + 2], sh);
    }
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < n) {
        const uint32_t c = ((k < 8 ? s0 : s1) >> (4 * (k & 7))) & 15u;
        const uint32_t lo = ((k < 8 ? m0 : m1) >> (4 * (k & 7))) & 15u;
        vals[j0 + k] = static_cast<uint16_t>((c >> 3) << 15 | e[k] << 7 |
                                             (c & 7u) << 4 | lo);
      }
    }
  } else {
    const int ws = 8 - tr, tk = 7 - tr;
    const uint32_t smask = (1u << ws) - 1u, tmask = (1u << tk) - 1u;
    const uint32_t lmask = (1u << tr) - 1u;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < n) {
        const int j = j0 + k;
        const uint32_t c = bits_at(SM, j * ws, smask);
        const uint32_t lo = ML != nullptr ? bits_at(ML, j * tr, lmask) : 0u;
        vals[j] = static_cast<uint16_t>(((c >> tk) & 1u) << 15 | e[k] << 7 |
                                        (((c & tmask) << tr) | lo) & 0x7Fu);
      }
    }
  }
}

// kv_view's lanes a vector: D/16 rounded up to a power of two.
__host__ __device__ constexpr int kv_group_lanes(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 128 ? 8 : d <= 256 ? 16 : 32;
}

// Inclusive sum over the G lanes of a lane group (gl: the lane's index in
// its group).
template <int G>
__device__ __forceinline__ int group_incl_sum(int v, int gl) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d, G);
    if (gl >= d) v += a;
  }
  return v;
}

// The vectors [v0, v0 + nv) of one staged run, decoded by lane groups. vals
// holds a vector's kept values at [0, K), its pruned values at [K, D) (the
// target view) and a zero at [D] (the draft view's pruned positions).
template <int DPL, bool TARGET, bool FAST, int RUN>
__device__ __forceinline__ void kv_view_run(const KvView& a,
                                            const uint8_t* kv_smem,
                                            const uint8_t* book, long long v0,
                                            int nv, int warp, int grp, int gl,
                                            int j0, int n, int* incl,
                                            uint16_t* vals) {
  constexpr int D = DPL * 32;
  constexpr int GP = D / 16;                  // lanes that own positions
  constexpr int G = kv_group_lanes(D), NG = 32 / G;
  const int K = a.keep, P = D - K;
  const bool owner = gl < GP;
  for (int vb = warp * NG; vb < nv; vb += kWarps * NG) {
    const bool live = vb + grp < nv;
    const int v = live ? vb + grp : vb;
    const uint32_t* BM =
        reinterpret_cast<const uint32_t*>(kv_smem + a.soff[kvBitmap]) +
        v * DPL;
    const uint32_t* SM =
        reinterpret_cast<const uint32_t*>(kv_smem + a.soff[kvSignMant]) +
        v * a.sw;
    const uint32_t* E =
        reinterpret_cast<const uint32_t*>(kv_smem + a.soff[kvExp]) + v * a.ew;
    const int md = kv_smem[a.soff[kvMode] + v];
    const int em = kv_smem[a.soff[kvEmax] + v];
    const uint32_t* ML = nullptr;
    const uint8_t* C = nullptr;
    if constexpr (TARGET) {
      if (a.bpv[kvMantLo] > 0)
        ML = reinterpret_cast<const uint32_t*>(kv_smem + a.soff[kvMantLo]) +
             v * a.mw;
      if (a.bpv[kvCorr] > 0) C = kv_smem + a.soff[kvCorr] + v * K;
    }
    // 1. the region's per-word counts of ones (every group, whatever its
    // mode: the scan's shuffles need the whole warp), then lane gl's run of
    // kept exponents: a walk over the unary region's ones, or mode-1 deltas
    int base = 0;
    for (int c0 = 0; c0 < a.ew; c0 += G) {
      const int wi = c0 + gl;
      const int cnt = wi < a.ew ? __popc(E[wi]) : 0;
      const int in = group_incl_sum<G>(cnt, gl) + base;
      if (wi < a.ew) incl[wi] = in;
      base = __shfl_sync(kFull, in, G - 1, G);
    }
    __syncwarp();
    uint32_t ex[RUN];
    if (md == 0) {
      if (n > 0) unary_walk<RUN>(E, a.ew, incl, book, j0, n, ex);
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k)
        if (k < n) ex[k] = kv_delta_exp(E, C, j0 + k, a.eb, em);
    }
    // 2. the kept values, and (the target view) the pruned values after
    // them
    if (n > 0) kv_kept_run<FAST, RUN>(SM, ML, j0, n, a.trunc, ex, vals);
    if constexpr (TARGET) {                 // two values a word: K, P even
      const uint32_t* p2 = reinterpret_cast<const uint32_t*>(
          kv_smem + a.soff[kvPruned] + v * 2 * P);
      uint32_t* d2 = reinterpret_cast<uint32_t*>(vals + K);
      for (int i = gl; i < P / 2; i += G) d2[i] = p2[i];
    }
    __syncwarp();
    // 3. lane gl's 16 positions: 8 in each half of the vector (8 gl .. and
    // D/2 + 8 gl ..), so that each of its two 16-byte stores joins the
    // group's into D contiguous bytes; the kept values before each piece
    // by one group scan of both halves' __popc counts. A set bit reads the
    // next kept value, a clear one the next pruned value (the target view)
    // or the zero at [D]; indices clamped at K - 1 and P - 1, as
    // `desparsify` clamps them, only where a bitmap needs it. A lane past
    // the D/16 owners adds nothing to the scans and stores nothing.
    uint32_t bits[2] = {0u, 0u};
    int cnt = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h * (D / 2) + 8 * gl;
      if (owner) bits[h] = (BM[p >> 5] >> (p & 31)) & 0xFFu;
      cnt |= __popc(bits[h]) << (16 * h);
    }
    const int in = group_incl_sum<G>(cnt, gl);
    const int ex0 = in - cnt;
    const int half = __shfl_sync(kFull, in, G - 1, G) & 0xFFFF;
    const bool has_p = TARGET && P > 0;
    uint4* out = reinterpret_cast<uint4*>(a.out + (v0 + v) * D);
#pragma unroll
    for (int h = 0; h < 2 && owner; ++h) {
      const int p0 = h * (D / 2) + 8 * gl;
      int kb = h == 0 ? ex0 & 0xFFFF : half + (ex0 >> 16);
      const int kend = kb + __popc(bits[h]);
      const bool clamp = kend > K || (has_p && p0 + 8 - kend > P);
      uint32_t o[8];
      if (!clamp) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool set = (bits[h] >> i) & 1u;
          o[i] = vals[set ? kb : has_p ? K + p0 + i - kb : D];
          kb += set;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool set = (bits[h] >> i) & 1u;
          o[i] = vals[set ? min(kb, K - 1)
                          : has_p ? K + min(p0 + i - kb, P - 1) : D];
          kb += set;
        }
      }
      if (live)
        out[h * GP + gl] = make_uint4(__byte_perm(o[0], o[1], 0x5410),
                                     __byte_perm(o[2], o[3], 0x5410),
                                     __byte_perm(o[4], o[5], 0x5410),
                                     __byte_perm(o[6], o[7], 0x5410));
    }
    __syncwarp();                     // incl and vals free for the next vector
  }
}

// Run q of the store (vectors [q * chunk, q * chunk + nv)) into a stage.
__device__ __forceinline__ void kv_stage_run(const KvView& a, uint8_t* stage,
                                             long long q) {
  const long long v0 = q * a.chunk;
  const int nv = static_cast<int>(min(static_cast<long long>(a.chunk),
                                      a.rows - v0));
#pragma unroll
  for (int r = 0; r < kvLeaves; ++r) kv_stage(a, r, stage, v0, nv);
  asm volatile("cp.async.commit_group;" ::);
}

// A group of G lanes (`kv_group_lanes`) owns a vector (lane gl < D/16:
// output positions 8 gl .. 8 gl + 7 and D/2 + 8 gl ..; every lane: kept
// values gl * krun ..), so a warp decodes 32/G vectors at once. Every lane
// runs every group step, for a vector of the run or, past its end, again
// for the warp's first (nothing stored).
// The grid is persistent (`kv_view_plan`): CTA b decodes runs b, b + grid,
// ... through a two-stage ring, the next run's copies in flight while the
// current one decodes.
template <int DPL, bool TARGET, bool FAST, int RUN>
__global__ void __launch_bounds__(kThreads, kMinCtas) kv_view_kernel(KvView a) {
  constexpr int D = DPL * 32;
  constexpr int G = kv_group_lanes(D), NG = 32 / G;
  extern __shared__ __align__(16) uint8_t kv_smem[];
  __shared__ uint8_t book[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G;
  const long long runs = (a.rows + a.chunk - 1) / a.chunk;
  if (threadIdx.x < 32) book[threadIdx.x] = a.book[threadIdx.x];
  long long q = blockIdx.x;
  if (q < runs) kv_stage_run(a, kv_smem, q);
  const int K = a.keep;
  const int krun = (K + G - 1) / G;
  const int j0 = gl * krun, n = max(0, min(krun, K - j0));
  uint8_t* scratch =
      kv_smem + 2 * a.stage_bytes + (warp * NG + grp) * a.scratch_bytes;
  int* incl = reinterpret_cast<int*>(scratch);
  uint16_t* vals = reinterpret_cast<uint16_t*>(scratch + 4 * a.ew);
  if (gl == 0) vals[D] = 0;                   // the zero slot, never written
  for (int it = 0; q < runs; q += gridDim.x, ++it) {
    if (q + gridDim.x < runs) {
      kv_stage_run(a, kv_smem + ((it + 1) & 1) * a.stage_bytes,
                   q + gridDim.x);
      asm volatile("cp.async.wait_group 1;" ::);
    } else {
      asm volatile("cp.async.wait_group 0;" ::);
    }
    __syncthreads();                          // the run's copies landed
    const uint8_t* st = kv_smem + (it & 1) * a.stage_bytes;
    const long long v0 = q * a.chunk;
    const int nv = static_cast<int>(min(static_cast<long long>(a.chunk),
                                        a.rows - v0));
    kv_view_run<DPL, TARGET, FAST, RUN>(a, st, book, v0, nv, warp, grp, gl,
                                        j0, n, incl, vals);
    __syncthreads();                          // the stage is free again
  }
}

template <int DPL, int RUN>
cudaError_t launch_kv_view_run(const KvView& a, bool target, int ctas,
                               size_t smem_bytes, cudaStream_t stream) {
  static size_t granted[4] = {0, 0, 0, 0};  // dynamic smem granted so far
  // 4-bit codes (FAST) with any run; other widths only with runs of 16
  const bool fast = a.trunc == 4;
  const int which = 2 * target + fast;
  const auto kernel =
      target ? (fast || RUN != 16 ? kv_view_kernel<DPL, true, true, RUN>
                                  : kv_view_kernel<DPL, true, false, 16>)
             : (fast || RUN != 16 ? kv_view_kernel<DPL, false, true, RUN>
                                  : kv_view_kernel<DPL, false, false, 16>);
  // the opt-in above the default 48 KB counts the static shared memory
  // too, so every size takes it (once per kernel and size)
  if (smem_bytes > granted[which]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
    granted[which] = smem_bytes;
  }
  kernel<<<ctas, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// A lane's run of kept values is ceil(keep / G) <= 16. The paper's keep
// with 4-bit codes (0.6 D in multiples of 16: runs of 10 from D = 128 up, 8
// below) has a kernel of its exact run; other formats take runs of up to
// 16 with a bound.
template <int DPL>
cudaError_t launch_kv_view(const KvView& a, bool target, int ctas,
                           size_t smem_bytes, cudaStream_t stream) {
  constexpr int kPaperRun = DPL >= 4 ? 10 : 8;
  constexpr int G = kv_group_lanes(DPL * 32);
  const int krun = (a.keep + G - 1) / G;
  if (a.trunc == 4 && krun <= kPaperRun)
    return launch_kv_view_run<DPL, kPaperRun>(a, target, ctas, smem_bytes,
                                              stream);
  return launch_kv_view_run<DPL, 16>(a, target, ctas, smem_bytes, stream);
}

}  // namespace

// words (rows,W) u32 -> out (rows,K) int32 ranks in [0, 31]; K <= 512 and
// W <= 1023 (positions are int16). Returns cudaGetLastError() after the
// launch.
extern "C" int unary_decode_launch(const void* words, void* out, int rows,
                                   int W, int K, void* stream) {
  if (rows < 0 || W < 1 || W > 1023 || K < 1 || K > 32 * kRun)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const size_t smem_bytes = static_cast<size_t>(kWarps) * K * 2;
  unary_decode_kernel<<<blocks, kThreads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), rows,
      W, K);
  return static_cast<int>(cudaGetLastError());
}

// One packed C-1 weight (N columns of NB superblocks of `block` values, keep
// kept) -> out (N, NB * block) bf16. Spec: bitmap (N,NB,block/32) u32 ·
// signmant (N,NB,wsm) u32 · exp_words (N,NB,we) u32 · mode, emax (N,NB) u8 ·
// book (>= 32) u8. Verif: mant_lo (N,NB,wml) u32 · corr (N,NB,keep/2) u8 or
// null; pruned == 1: psm (N,NB,block-keep) u8, pexp_words (N,NB,pwe) u32,
// pmode, pemax (N,NB) u8, pbook (>= 32) u8, pcorr (N,NB,(block-keep)/2) u8
// or null; pruned == 2: psm is the raw (N,NB,block-keep) 16-bit patterns;
// pruned == 0: nothing pruned. Every pointer 4-byte aligned; `chunk`
// superblocks per CTA. Returns the CUDA error of the launch (0 on success).
extern "C" int target_decode_launch(
    const void* bitmap, const void* signmant, const void* exp_words,
    const void* mode, const void* emax, const void* book, const void* mant_lo,
    const void* corr, const void* psm, const void* pexp_words,
    const void* pmode, const void* pemax, const void* pbook,
    const void* pcorr, void* out, int N, int NB, int block, int keep,
    int trunc, int exp_bits, int pruned, int chunk, void* stream) {
  const int P = block - keep;
  const bool pow2 = block >= 32 && block <= 512 && (block & (block - 1)) == 0;
  if (!pow2 || keep < 1 || keep > block || keep % 8 != 0 || P % 8 != 0 ||
      trunc < 0 || trunc > 7 || exp_bits < 1 || exp_bits > 8 || N < 0 ||
      NB < 0 || chunk < 1 || pruned < 0 || pruned > 2 ||
      (pruned != 0) != (P > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(N) * NB == 0) return 0;
  Target a{};
  const void* src[kRegions] = {bitmap, signmant, exp_words, mant_lo,
                               pruned ? psm : nullptr,
                               pruned == 1 ? pexp_words : nullptr, corr,
                               pruned == 1 ? pcorr : nullptr};
  a.nw[kBitmap] = block / 32;
  a.nw[kSignMant] = ceil_div(keep * (8 - trunc), 32);
  a.nw[kExpWords] = ceil_div(keep * exp_bits, 32);
  a.nw[kMantLo] = ceil_div(keep * trunc, 32);
  a.nw[kCorr] = corr != nullptr ? keep / 8 : 0;
  a.nw[kPruned] = pruned == 1 ? P / 4 : pruned == 2 ? P / 2 : 0;
  a.nw[kPExpWords] = pruned == 1 ? ceil_div(P * exp_bits, 32) : 0;
  a.nw[kPCorr] = pruned == 1 && pcorr != nullptr ? P / 8 : 0;
  int off = 0, pieces = 0;
  for (int r = 0; r < kRegions; ++r) {
    a.src[r] = static_cast<const uint32_t*>(src[r]);
    if (a.nw[r] == 0) {
      a.off[r] = 0;
      a.gran[r] = 1;
      continue;
    }
    if (src[r] == nullptr || reinterpret_cast<uintptr_t>(src[r]) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // word offsets are int32 (superblock * words), piece fields 12 bits
    if (static_cast<long long>(N) * NB * a.nw[r] >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    a.off[r] = off;
    a.gran[r] = granule(src[r], a.nw[r]);
    pieces += a.nw[r] / a.gran[r];
    off += round4(a.nw[r] + 2);               // + pad words for the windows
  }
  if (pieces > kMaxPieces || off >= 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  a.stage_words = off;
  // per warp: two stages, then the block's bf16 values, where the unary
  // regions' int16 set-bit positions go first (keep + P of them)
  a.warp_words = 2 * a.stage_words + block / 2;
  a.mode = static_cast<const uint8_t*>(mode);
  a.emax = static_cast<const uint8_t*>(emax);
  a.pmode = static_cast<const uint8_t*>(pmode);
  a.pemax = static_cast<const uint8_t*>(pemax);
  a.book = static_cast<const uint8_t*>(book);
  a.pbook = static_cast<const uint8_t*>(pbook);
  if (pruned == 1 && (pmode == nullptr || pemax == nullptr || pbook == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<uint16_t*>(out);
  a.S = static_cast<long long>(N) * NB;
  a.block = block;
  a.keep = keep;
  a.P = P;
  a.trunc = trunc;
  a.eb = exp_bits;
  a.chunk = chunk;
  a.pruned = pruned;
  const unsigned ctas = static_cast<unsigned>((a.S + chunk - 1) / chunk);
  const size_t smem_bytes = static_cast<size_t>(kWarps) * a.warp_words * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (block) {
    case 512: e = launch_target<16>(a, ctas, smem_bytes, s); break;
    case 256: e = launch_target<8>(a, ctas, smem_bytes, s); break;
    case 128: e = launch_target<4>(a, ctas, smem_bytes, s); break;
    case 64: e = launch_target<2>(a, ctas, smem_bytes, s); break;
    default: e = launch_target<1>(a, ctas, smem_bytes, s); break;
  }
  return static_cast<int>(e);
}

// A Cassandra-1 KV store of `rows` vectors of D values (each leaf (rows, 1,
// ·) flattened) -> out (rows, D) bf16, its draft (target == 0) or target
// view. Spec: bitmap (rows,D/32) u32 · signmant (rows,sw) u32 · exp_words
// (rows,ew) u32 · mode, emax (rows,) u8; book: exp_of_rank (>= 32) u8;
// keep a multiple of 16 (pruning.KV_KEEP_MULTIPLE), D in {32, 64, 96, 128,
// 256, 512}.
// Target only: mant_lo (rows,mw) u32 (null when trunc == 0) · corr
// (rows,keep) u8 or null · pruned (rows,D-keep) 16-bit patterns (null when
// keep == D). sw, ew, mw are ceil(keep * width / 32) for widths 8 - trunc,
// exp_bits and trunc; runs of `chunk` vectors (a multiple of 16), `ctas`
// persistent CTAs. Returns the CUDA error of the launch (0 on success).
extern "C" int kv_view_launch(const void* bitmap, const void* signmant,
                              const void* exp_words, const void* mode,
                              const void* emax, const void* book,
                              const void* mant_lo, const void* corr,
                              const void* pruned, void* out, int rows, int D,
                              int keep, int trunc, int exp_bits, int target,
                              int chunk, int ctas, void* stream) {
  const int P = D - keep;
  if (rows < 0 || keep < 16 || keep > D || keep % 16 != 0 || trunc < 0 ||
      trunc > 7 || exp_bits < 1 || exp_bits > 8 || chunk < 16 ||
      chunk % 16 != 0 || ctas < 1 || book == nullptr ||
      (target && (trunc > 0) != (mant_lo != nullptr)) ||
      (target && (P > 0) != (pruned != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  KvView a{};
  a.sw = (keep * (8 - trunc) + 31) / 32;
  a.ew = (keep * exp_bits + 31) / 32;
  a.mw = (keep * trunc + 31) / 32;
  if (a.ew > 1023) return static_cast<int>(cudaErrorInvalidValue);
  const void* src[kvLeaves] = {bitmap, signmant, exp_words, mode, emax,
                               target ? mant_lo : nullptr,
                               target ? corr : nullptr,
                               target ? pruned : nullptr};
  const int bpv[kvLeaves] = {D / 8, 4 * a.sw, 4 * a.ew, 1, 1, 4 * a.mw, keep,
                             2 * P};
  int off = 0;
  for (int r = 0; r < kvLeaves; ++r) {
    a.src[r] = static_cast<const uint8_t*>(src[r]);
    a.bpv[r] = src[r] != nullptr ? bpv[r] : 0;
    a.soff[r] = off;
    const uintptr_t u = reinterpret_cast<uintptr_t>(src[r]);
    a.gran[r] = u % 16 == 0 ? 16 : u % 4 == 0 ? 4 : 1;
    if (r <= kvEmax && src[r] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    // the run, rounded to 16 bytes, and 16 bytes the bit windows may read
    off += ((chunk * a.bpv[r] + 15) & ~15) + 16;
  }
  a.stage_bytes = off;
  // per lane group (kv_group_lanes(D) lanes, one vector at a time): the
  // unary region's per-word counts, then the kept and pruned values and a
  // zero
  a.scratch_bytes = (4 * a.ew + 2 * (D + 1) + 15) & ~15;
  a.book = static_cast<const uint8_t*>(book);
  a.out = static_cast<uint16_t*>(out);
  a.rows = rows;
  a.chunk = chunk;
  a.keep = keep;
  a.trunc = trunc;
  a.eb = exp_bits;
  const size_t smem_bytes = 2 * static_cast<size_t>(a.stage_bytes) +
                            static_cast<size_t>(kThreads /
                                                kv_group_lanes(D)) *
                                a.scratch_bytes;
  if (smem_bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = target != 0;
  cudaError_t e;
  switch (D) {
    case 32: e = launch_kv_view<1>(a, t, ctas, smem_bytes, s); break;
    case 64: e = launch_kv_view<2>(a, t, ctas, smem_bytes, s); break;
    case 96: e = launch_kv_view<3>(a, t, ctas, smem_bytes, s); break;
    case 128: e = launch_kv_view<4>(a, t, ctas, smem_bytes, s); break;
    case 256: e = launch_kv_view<8>(a, t, ctas, smem_bytes, s); break;
    case 512: e = launch_kv_view<16>(a, t, ctas, smem_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
