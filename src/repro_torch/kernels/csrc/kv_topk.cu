// Online KV encoder for Hopper (sm_90a) (paper Fig. 8b): the top-k selection
// alone (`kv_topk`) and the whole Cassandra-1 vector encode built on it
// (`kv_encode`).
//
// `kv_topk` replaces the TPU kernel `kv_topk` (src/repro/kernels/kv_topk.py,
// `_kernel`): per (token, head) vector of D bf16 values, rank_i =
// #{j : |v_j| > |v_i|} + #{j < i : |v_j| == |v_i|} with |v| taken in f32 (so
// -0 ties +0 and a NaN compares false both ways: it ranks 0 and counts
// against no other lane), keep the lanes of rank < keep, and emit
//   * the bitmap of kept positions, D/32 words, bit b of word w = lane
//     w*32+b;
//   * the kept values in position order (the speculation side);
//   * the pruned values in position order (the verification side's raw
//     payload), which the TPU kernel left to a gather outside it.
// Values are moved as bits: a kept -0.0 stays -0.0, as in the reference's
// serving selection (`pruning.select_topk_blocked`); the TPU kernel's one-hot
// product would return +0.0. Kept slots past the kept count and pruned slots
// past the pruned count (both only reachable with NaNs) are 0.
//
// The selection. For a lane that is not NaN the 15-bit key `bits & 0x7FFF`
// orders |v| exactly as the f32 compare does (inf and subnormals included; an
// integer compare, so no flush-to-zero can enter). One warp owns one vector,
// lane l the D/32 values at positions i*32 + l. With kk = min(keep, lanes
// that are not NaN) the warp finds T, the kk-th largest key, by a radix
// select over the 15 key bits: per bit one warp-wide count
// (__reduce_add_sync of each lane's count) of the keys that match T's bits so
// far and have this bit set. A lane is kept when its key is above T, or equal
// to T with fewer than kk - #{key > T} equal lanes before it in position order
// (a ballot prefix), or when it is NaN. That is the rank rule above, in 15
// rounds of D/32 compares a lane where the first version counted D compares
// for each of a lane's values. A __ballot_sync per word is the bitmap word,
// and a __popc prefix over the ballots gives each value its kept or pruned
// slot.
// Bound: a vector read once (2 D bytes) and written once (D/8 + 2 D bytes).
//
// `kv_encode` replaces, for a Cassandra-1 KV store, the TPU kernel together
// with the reference's chain around it (`format.format_tensor` at one block
// per vector, `corr_bits` 8 and raw pruned values: `_split_kept`,
// `coding.encode_exponents`, `bitops.pack_codes` / `pack_bits`). Per vector,
// after the selection:
//   * the kept values, then the pruned values, go to shared memory in
//     position order (the compaction above);
//   * sign | high mantissa codes (1 + 7 - trunc bits) and low mantissa codes
//     (trunc bits) pack little-endian into words, lane w building word w;
//   * the kept exponents' ranks come from the cache-global book
//     (`rank_of_exp`); a warp scan of rank + 1 places each unary code's end
//     bit, and the region is unary (mode 0) iff every rank < 32 and the
//     stream fits region_words(keep, exp_bits) * 32 bits; otherwise (mode 1)
//     each exponent is an exp_bits-wide delta below the kept maximum `emax`
//     (the escape code for exponent 0, deltas clamped to escape - 1) with an
//     8-bit correction (delta - code clamped to 254; 255 for exponent 0); a
//     unary region's corrections are 0;
//   * every leaf leaves as words or bytes in the store's layout.
// Bound: 2 D bytes read, the store's leaves written (at D = 128, keep 80:
// 306 bytes a vector).
// kv_topk stays a launch of its own: the Cassandra-2 encode and the codec
// rows of the smoke run call it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRank = 32;               // ranks a unary code can carry
constexpr int kMaxExpWords = 128;          // region words: 512 codes x 8 bits
constexpr int kCorrZero = 255;             // 8-bit correction of exponent 0

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += a;
  }
  return v;
}

// The kept lanes of one vector: ball[i] is bitmap word i (bit l = position
// i*32 + l). val holds lane l's values at positions i*32 + l.
template <int DPL>
__device__ __forceinline__ void select_lanes(const uint16_t (&val)[DPL],
                                             int keep, int lane,
                                             uint32_t (&ball)[DPL]) {
  constexpr int D = DPL * 32;
  // a NaN's key is 0x8000: above every T, and no radix count matches it
  // (the candidates have bit 15 clear)
  int key[DPL], nan = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int k = val[i] & 0x7FFF;
    key[i] = k > 0x7F80 ? 0x8000 : k;
    nan += k > 0x7F80;
  }
  nan = static_cast<int>(__reduce_add_sync(kFull, nan));
  const int kk = min(keep, D - nan);
  // T: the kk-th largest key of the lanes that are not NaN (0x7FFF, above
  // every such key, when kk == 0)
  int t = 0x7FFF;
  if (kk > 0) {
    int prefix = 0, need = kk;
#pragma unroll 1
    for (int b = 14; b >= 0; --b) {
      const int cand = prefix | (1 << b);
      const int hi = 0xFFFF & ~((1 << b) - 1);
      int c = 0;
#pragma unroll
      for (int i = 0; i < DPL; ++i) c += (key[i] & hi) == cand;
      c = static_cast<int>(__reduce_add_sync(kFull, c));
      if (c >= need) prefix = cand;
      else need -= c;
    }
    t = prefix;
  }
  int gt = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) gt += key[i] > t;
  const int ties =
      kk - (static_cast<int>(__reduce_add_sync(kFull, gt)) - nan);
  const uint32_t below = (1u << lane) - 1u;
  int eq_before = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const bool eq = key[i] == t;
    const uint32_t e = __ballot_sync(kFull, eq);
    const bool take = eq && eq_before + __popc(e & below) < ties;
    eq_before += __popc(e);
    ball[i] = __ballot_sync(kFull, key[i] > t || take);
  }
}

// Kept values to their slots kept[0 .. keep), pruned ones to pruned[0 .. P)
// (P = D - keep), each in position order; slots past either count are 0.
// kept and pruned may lie in shared or device memory.
template <int DPL>
__device__ __forceinline__ void compact(const uint16_t (&val)[DPL],
                                        const uint32_t (&ball)[DPL], int keep,
                                        int lane, uint16_t* kept,
                                        uint16_t* pruned) {
  constexpr int D = DPL * 32;
  const int pw = D - keep;
  const uint32_t below = (1u << lane) - 1u;
  int kbase = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const bool m = (ball[i] >> lane) & 1u;
    const int kidx = kbase + __popc(ball[i] & below);
    const int pidx = i * 32 + lane - kidx;
    if (m) {
      if (kidx < keep) kept[kidx] = val[i];
    } else if (pidx < pw) {
      pruned[pidx] = val[i];
    }
    kbase += __popc(ball[i]);
  }
  for (int s = kbase + lane; s < keep; s += 32) kept[s] = 0;
  for (int s = D - kbase + lane; s < pw; s += 32) pruned[s] = 0;
}

template <int DPL>
__device__ __forceinline__ void load_vector(const uint16_t* vr, int lane,
                                            uint16_t (&val)[DPL]) {
#pragma unroll
  for (int i = 0; i < DPL; ++i) val[i] = vr[i * 32 + lane];
}

// Lane i < DPL writes bitmap word i.
template <int DPL>
__device__ __forceinline__ void store_bitmap(const uint32_t (&ball)[DPL],
                                             int lane, uint32_t* bm) {
  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane == i) mine = ball[i];
  if (lane < DPL) bm[lane] = mine;
}

template <int DPL>
__global__ void __launch_bounds__(kThreads)
kv_topk_kernel(const uint16_t* __restrict__ v, uint32_t* __restrict__ bitmap,
               uint16_t* __restrict__ kept, uint16_t* __restrict__ pruned,
               int rows, int keep) {
  constexpr int D = DPL * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;                        // whole warps only
  uint16_t val[DPL];
  load_vector<DPL>(v + row * D, lane, val);
  uint32_t ball[DPL];
  select_lanes<DPL>(val, keep, lane, ball);
  store_bitmap<DPL>(ball, lane, bitmap + row * DPL);
  compact<DPL>(val, ball, keep, lane, kept + row * keep,
               pruned + row * (D - keep));
}

// The bits [32 w, 32 w + 32) of K codes of `width` bits (code j at bit
// j * width), code j taken from vals[j] by `code`.
template <typename Code>
__device__ __forceinline__ uint32_t code_word(const uint16_t* vals, int K,
                                              int width, int w, Code code) {
  const int b0 = 32 * w;
  const int j0 = b0 / width, j1 = min(K - 1, (b0 + 31) / width);
  uint32_t word = 0;
  for (int j = j0; j <= j1; ++j) {
    const int sh = j * width - b0;
    const uint32_t c = code(vals[j]);
    word |= sh >= 0 ? c << sh : c >> -sh;
  }
  return word;
}

// Store leaves of `rows` vectors (each store leaf (rows, 1, ·) flattened).
struct Encode {
  const uint16_t* v;              // (rows, D) bf16
  const uint8_t* rank_of_exp;     // 256 entries
  uint32_t* bitmap;               // (rows, D/32)
  uint32_t* signmant;             // (rows, sw)
  uint32_t* exp_words;            // (rows, ew)
  uint8_t* mode;                  // (rows,)
  uint8_t* emax;                  // (rows,)
  uint32_t* mant_lo;              // (rows, mw); null when trunc == 0
  uint8_t* corr;                  // (rows, keep)
  uint16_t* pruned;               // (rows, D - keep); null when keep == D
  int rows, keep, trunc, eb, sw, ew, mw;
};

template <int DPL>
__global__ void __launch_bounds__(kThreads) kv_encode_kernel(Encode a) {
  constexpr int D = DPL * 32;
  constexpr int kRun = DPL;                      // kept values a lane, at most
  __shared__ uint8_t rob[256];
  __shared__ __align__(16) uint16_t vals_s[kWarps][D];
  __shared__ uint32_t region_s[kWarps][kMaxExpWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 256; i += kThreads) rob[i] = a.rank_of_exp[i];
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= a.rows) return;                      // no barrier follows
  const int K = a.keep, P = D - K;
  uint16_t* vals = vals_s[warp];
  uint32_t* R = region_s[warp];
  // 1. selection, bitmap, kept and pruned values in position order
  uint16_t val[DPL];
  load_vector<DPL>(a.v + row * D, lane, val);
  uint32_t ball[DPL];
  select_lanes<DPL>(val, K, lane, ball);
  store_bitmap<DPL>(ball, lane, a.bitmap + row * DPL);
  compact<DPL>(val, ball, K, lane, vals, vals + K);
  for (int w = lane; w < a.ew; w += 32) R[w] = 0u;
  __syncwarp();
  // 2. lane l's run of kept exponents: ranks, the unary stream's length
  const int krun = (K + 31) >> 5;
  const int j0 = lane * krun, n = max(0, min(krun, K - j0));
  int e[kRun], len = 0, rmax = 0, emax = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    e[k] = 0;
    if (k < n) {
      e[k] = (vals[j0 + k] >> 7) & 0xFF;
      const int r = rob[e[k]];
      len += r + 1;
      rmax = max(rmax, r);
      emax = max(emax, e[k]);
    }
  }
  const int incl = warp_incl_sum(len, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  rmax = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(rmax)));
  emax = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(emax)));
  const bool unary = total <= a.ew * 32 && rmax < kMaxRank;
  // 3. the exponent region (the corrections: 5.)
  const int esc = (1 << a.eb) - 1;
  if (unary) {
    int end = incl - len - 1;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < n) {
        end += rob[e[k]] + 1;
        atomicOr(&R[end >> 5], 1u << (end & 31));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < n) {
        const int code = e[k] == 0 ? esc : min(emax - e[k], esc - 1);
        const int b = (j0 + k) * a.eb, sh = b & 31;
        atomicOr(&R[b >> 5], static_cast<uint32_t>(code) << sh);
        if (sh + a.eb > 32)
          atomicOr(&R[(b >> 5) + 1], static_cast<uint32_t>(code) >> (32 - sh));
      }
    }
  }
  __syncwarp();
  // 4. the word leaves
  const int tr = a.trunc, tk = 7 - tr;
  for (int w = lane; w < a.ew; w += 32) a.exp_words[row * a.ew + w] = R[w];
  if (tr == 4) {
    // 4-bit codes: word w holds kept values 8w .. 8w + 7 of both streams
    for (int w = lane; w < K / 8; w += 32) {
      const uint4 q = reinterpret_cast<const uint4*>(vals)[w];
      const uint32_t h[4] = {q.x, q.y, q.z, q.w};
      uint32_t sm = 0, ml = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t x = (h[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
        sm |= ((x >> 15) << 3 | (x >> 4) & 7u) << (4 * i);
        ml |= (x & 15u) << (4 * i);
      }
      a.signmant[row * a.sw + w] = sm;
      a.mant_lo[row * a.mw + w] = ml;
    }
  } else {
    for (int w = lane; w < a.sw; w += 32)
      a.signmant[row * a.sw + w] = code_word(
          vals, K, 8 - tr, w, [tr, tk](uint16_t x) {
            return static_cast<uint32_t>((x >> 15) << tk | (x & 0x7F) >> tr);
          });
    for (int w = lane; w < a.mw; w += 32)
      a.mant_lo[row * a.mw + w] = code_word(
          vals, K, tr, w, [tr](uint16_t x) {
            return static_cast<uint32_t>(x & ((1u << tr) - 1u));
          });
  }
  if (lane == 0) {
    a.mode[row] = unary ? 0 : 1;
    a.emax[row] = static_cast<uint8_t>(emax);
  }
  // 5. the corrections: 0 for a unary region; else delta - code, clamped
  // to 254, and 255 for exponent 0
  auto corr_of = [unary, emax, esc](uint32_t x) -> uint32_t {
    const int ex = (x >> 7) & 0xFF, delta = emax - ex;
    if (unary) return 0u;
    return ex == 0 ? kCorrZero : min(delta - min(delta, esc - 1),
                                     kCorrZero - 1);
  };
  // (keep and D - keep are multiples of 16: four bytes a word)
  uint32_t* c4 = reinterpret_cast<uint32_t*>(a.corr + row * K);
  for (int q = lane; q < K / 4; q += 32) {
    const uint2 x = reinterpret_cast<const uint2*>(vals)[q];
    c4[q] = corr_of(x.x & 0xFFFFu) | corr_of(x.x >> 16) << 8 |
            corr_of(x.y & 0xFFFFu) << 16 | corr_of(x.y >> 16) << 24;
  }
  // 6. the pruned values' raw patterns, two a word
  uint32_t* p2 = reinterpret_cast<uint32_t*>(a.pruned + row * P);
  const uint32_t* v2 = reinterpret_cast<const uint32_t*>(vals + K);
  for (int q = lane; q < P / 2; q += 32) p2[q] = v2[q];
}

template <int DPL>
cudaError_t launch_encode(const Encode& a, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((a.rows + kWarps - 1) / kWarps);
  kv_encode_kernel<DPL><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
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

// v (rows,D) bf16 + rank_of_exp (256) u8 -> a Cassandra-1 KV store's leaves:
// bitmap (rows,D/32) u32, signmant (rows,ceil(keep*(8-trunc)/32)) u32,
// exp_words (rows,ceil(keep*exp_bits/32)) u32, mode and emax (rows,) u8,
// mant_lo (rows,ceil(keep*trunc/32)) u32 (null when trunc == 0), corr
// (rows,keep) u8, pruned (rows,D-keep) 16-bit patterns (null when keep == D).
// keep is a multiple of 16 (pruning.KV_KEEP_MULTIPLE). Returns the CUDA
// error of the launch (0 on success).
extern "C" int kv_encode_launch(const void* v, const void* rank_of_exp,
                                void* bitmap, void* signmant, void* exp_words,
                                void* mode, void* emax, void* mant_lo,
                                void* corr, void* pruned, int rows, int D,
                                int keep, int trunc, int exp_bits,
                                void* stream) {
  Encode a{};
  a.rows = rows;
  a.keep = keep;
  a.trunc = trunc;
  a.eb = exp_bits;
  a.sw = (keep * (8 - trunc) + 31) / 32;
  a.ew = (keep * exp_bits + 31) / 32;
  a.mw = (keep * trunc + 31) / 32;
  if (rows < 0 || keep < 16 || keep > D || keep % 16 != 0 || trunc < 0 ||
      trunc > 7 || exp_bits < 1 || exp_bits > 8 || a.ew > kMaxExpWords ||
      (trunc > 0) != (mant_lo != nullptr) ||
      (keep < D) != (pruned != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  a.v = static_cast<const uint16_t*>(v);
  a.rank_of_exp = static_cast<const uint8_t*>(rank_of_exp);
  a.bitmap = static_cast<uint32_t*>(bitmap);
  a.signmant = static_cast<uint32_t*>(signmant);
  a.exp_words = static_cast<uint32_t*>(exp_words);
  a.mode = static_cast<uint8_t*>(mode);
  a.emax = static_cast<uint8_t*>(emax);
  a.mant_lo = static_cast<uint32_t*>(mant_lo);
  a.corr = static_cast<uint8_t*>(corr);
  a.pruned = static_cast<uint16_t*>(pruned);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_encode<1>(a, s); break;
    case 64: e = launch_encode<2>(a, s); break;
    case 128: e = launch_encode<4>(a, s); break;
    case 256: e = launch_encode<8>(a, s); break;
    case 512: e = launch_encode<16>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
