// Fused Cassandra-1 draft decode + matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel `draft_matmul` (src/repro/kernels/draft_matmul.py,
// `_kernel` / `_decode_tile`, entry `ops.draft_matmul`): y = x @ W_draft,
// where W_draft is rebuilt on chip from the packed speculation stream and
// never exists densely in device memory. Per 512-value superblock of one
// output column it reads a 16-word bitmap, 40 words of sign|mantissa codes
// (4 bits each at the paper defaults), 30 words of 3-bit exponent-rank codes
// and one int32 block-max exponent: 348 B against 1024 B of bf16.
//
// Decode semantics are the TPU kernel's exactly (`ops.draft_matmul_rank3_
// oracle`): rank r < 7 maps through the 8-entry book, rank 7 is the C-1T
// escape to the block max exponent, and the kept values are scattered back
// to their bitmap positions (the encoder writes exactly `keep` set bits per
// superblock). The result is an f32 sum of exact bf16 x bf16 products; only
// the summation order differs from the oracle.
//
// What bounds it on this card. At decode batch sizes (M = a few rows) the
// products are ~2*M flops per weight, far below the ~295 flop/byte where the
// tensor cores become the limit, so the floor is the packed bytes (5.1 GB per
// Llama-3-8B draft pass, 1.5 ms at 3.35 TB/s). Two things keep it above
// that floor: the decode, which at the floor would have ~10 integer
// lane-instructions per kept value, and the copies, which fetch each
// column's 64-160 byte pieces of every superblock separately.
// The design, against each:
//   * Enough CTAs for every shape. A CTA owns 32 output columns and a range
//     of superblocks (split-K); `plan` in draft_matmul.py picks the range so
//     that narrow products (wk/wv 1024 columns, MLA kv_a 576) still put a few
//     hundred CTAs on the 132 SMs. Split partials go to an f32 workspace;
//     the last CTA of a column tile to finish (a ticket counter, re-armed
//     by that CTA) sums them in split order, so the result has the same bits
//     on every launch and no second kernel waits on the first. Inside a CTA,
//     two warps split each superblock's bitmap words in halves and their
//     sums meet in shared memory in a fixed order.
//   * Loads kept in flight. A two-stage shared-memory ring holds the tile's
//     packed words; `cp.async` fills the next superblock (16/8/4-byte copies
//     as the regions' alignment allows) while the current one decodes.
//   * A word-parallel decode straight into tensor-core fragments. The K
//     order inside an mma is free as long as A and B agree, so each thread
//     takes whole bitmap bytes: byte t of every bitmap word, 8 consecutive
//     positions, i.e. the A fragment's two k-pairs of two k-steps. Its kept
//     index is one __popc prefix; its <= 8 sign|mantissa nibbles and 3-bit
//     rank codes are one 32-bit window each (a funnel shift over two words);
//     each position pair is then one __popc, a handful of shifts, one
//     `prmt` over an 8-byte table in two registers (book[0..6], then the
//     superblock's emax in slot 7 -- the C-1T escape stays exact) and a
//     sign-replicating `prmt` mask for pruned positions: ~11 integer ALU
//     instructions per pair, no serial walk, no dependent loads. Other
//     mantissa widths (trunc != 4) take a general per-value path; its
//     speed does not matter, its bits do.
//   * Products on the tensor cores, A and B swapped for small M: the decoded
//     weight tile (16 output columns x 16 K) is the A operand of
//     `mma.sync.m16n8k16` (bf16 in, f32 accumulate) and x^T the B operand at
//     n = 8, so M <= 8 rows take one n-tile; larger M loops over n-tiles in
//     chunks of 32 rows. x is read through the read-only cache as one 16-byte
//     load per thread and bitmap word, in the same permuted K order.
// The ragged edges of N and M are masked; columns past N decode from a
// zeroed bitmap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;         // output columns per CTA (two mma row groups)
constexpr int kStages = 2;
constexpr int kPad = 4;           // spare words around each code region

struct Layout {                   // word offsets of one column's regions
  int bm, sm, ex, em, cs;         // cs: column stride inside a stage
};

inline int round4(int x) { return (x + 3) & ~3; }

Layout make_layout(int bw, int wsm, int we) {
  Layout L;
  L.bm = 0;
  L.sm = round4(bw) + kPad;
  L.ex = L.sm + round4(wsm) + kPad;
  L.em = L.ex + round4(we) + kPad;
  L.cs = L.em + 4;
  if ((L.cs >> 2) % 2 == 0) L.cs += 4;   // odd multiple of 16 B: the 8
  return L;                              // columns of a warp hit 8 banks
}

struct Args {
  const uint16_t* x;              // (M, K) bf16
  const uint32_t* bitmap;         // (N, NB, bw)
  const uint32_t* signmant;       // (N, NB, wsm)
  const uint32_t* exp3;           // (N, NB, we)
  const uint32_t* emax;           // (N, NB) int32
  const int32_t* book;            // (8,)
  float* y;                       // (M, N)
  float* ws;                      // split partials (S, M, N) when S > 1
  int* tickets;                   // per tile: splits done (0 between launches)
  int M, K, N, NB, bw, keep, trunc, wsm, we, chunk, splits;
  int g_bm, g_sm, g_ex;           // copy granularity per region, in words
  Layout L;
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ void copy_region(uint32_t* dst,
                                            const uint32_t* src, int n,
                                            int g, int sub) {
  for (int i = sub * g; i < n; i += 4 * g) cp_async(dst + i, src + i, g);
}

// One superblock of the CTA's 32 columns into a stage: 4 threads a column.
__device__ __forceinline__ void load_stage(const Args& a, uint32_t* st,
                                           int col0, int sb) {
  const int c = threadIdx.x >> 2, sub = threadIdx.x & 3;
  uint32_t* dst = st + c * a.L.cs;
  const int col = col0 + c;
  if (col >= a.N) {                        // decodes to zeros
    for (int i = sub; i < a.bw; i += 4) dst[a.L.bm + i] = 0u;
    return;
  }
  const size_t cb = static_cast<size_t>(col) * a.NB + sb;
  copy_region(dst + a.L.bm, a.bitmap + cb * a.bw, a.bw, a.g_bm, sub);
  copy_region(dst + a.L.sm, a.signmant + cb * a.wsm, a.wsm, a.g_sm, sub);
  copy_region(dst + a.L.ex, a.exp3 + cb * a.we, a.we, a.g_ex, sub);
  if (sub == 0) cp_async(dst + a.L.em, a.emax + cb, 1);
}

// prmt selectors that replicate the msb of byte i of {sa, sb} into a
// 16-bit lane each: position 2i of the bitmap byte (sa) and 2i+1 (sb).
__device__ __forceinline__ uint32_t mask_sel(int i) {
  return (0x8u | i) * 0x11u | ((0xCu | i) * 0x11u) << 8;
}

// Byte t of a bitmap word: positions 8t..8t+7 -> four bf16 pairs (the
// low half holds the lower position). `q0` is the kept index of the first
// set bit in the byte; S / E point at the column's sign|mantissa and rank
// regions in the stage. Fast path: 4-bit sign|mantissa codes (trunc 4).
__device__ __forceinline__ void decode_byte_fast(uint32_t byte, int q0,
                                                 const uint32_t* S,
                                                 const uint32_t* E,
                                                 uint32_t tlo, uint32_t thi,
                                                 uint32_t out[4]) {
  const int js = q0 >> 3;
  const uint32_t ws = __funnelshift_r(S[js], S[js + 1], q0 << 2);
  const uint32_t vlo = ws << 4, vhi = ws >> 28;   // nibble r+1: code q0+r
  const int e0 = q0 * 3;
  const uint32_t ve =                              // field r+1: rank q0+r
      __funnelshift_r(E[e0 >> 5], E[(e0 >> 5) + 1], e0) << 3;
  const uint32_t sa = (byte & 0x55u) * 0x02082080u;  // msb of byte i: bit 2i
  const uint32_t sb = (byte & 0xAAu) * 0x01041040u;  // ... bit 2i+1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // set bits up to position 2i: the pair's codes are k0-1 and k0
    const uint32_t k0 = __popc(byte << (31 - 2 * i));
    const uint32_t s8 = prmt(__funnelshift_r(vlo, vhi, 4 * k0), 0u, 0x4440u);
    const uint32_t xs = s8 * 0x10010u;       // nibbles at bits 4 and 20
    const uint32_t smb = (xs | (xs << 8)) & 0x80708070u;   // sign, mantissa
    const uint32_t e6 = (ve >> (3 * k0)) & 0x3Fu;
    const uint32_t sel = e6 + (e6 & 0x38u);  // ranks -> nibbles 0 and 1
    // exponents to bytes 0 and 2, zeros between: bits 7-14 and 23-30
    const uint32_t ex = prmt(prmt(tlo, thi, sel), 0u, 0x4140u) << 7;
    out[i] = (smb | ex) & prmt(sa, sb, mask_sel(i));
  }
}

__device__ __forceinline__ uint32_t bits_at(const uint32_t* R, int bit,
                                            uint32_t mask) {
  const int wi = bit >> 5;                 // bit >= -8: word -1 is a pad
  return __funnelshift_r(R[wi], R[wi + 1], bit) & mask;
}

// The same for any sign|mantissa width (1 + 7 - trunc bits), one value at
// a time.
__device__ __forceinline__ void decode_byte_general(
    uint32_t byte, int q0, const uint32_t* S, const uint32_t* E,
    uint32_t tlo, uint32_t thi, int trunc, uint32_t out[4]) {
  const int tk = 7 - trunc, width = 8 - trunc;
  const uint32_t cmask = (1u << width) - 1u, mmask = (1u << tk) - 1u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k0 = __popc(byte & ((2u << (2 * i)) - 1u));
    const int ia = q0 + k0 - 1, ib = q0 + k0;
    const uint32_t ca = bits_at(S, ia * width, cmask);
    const uint32_t cb = bits_at(S, ib * width, cmask);
    const uint32_t p = prmt(tlo, thi, bits_at(E, ia * 3, 7u) |
                                          (bits_at(E, ib * 3, 7u) << 8));
    const uint32_t va = ((ca >> tk) & 1u) << 15 | (p & 0xFFu) << 7 |
                        ((ca & mmask) << trunc);
    const uint32_t vb = ((cb >> tk) & 1u) << 15 | ((p >> 16) & 0xFFu) << 7 |
                        ((cb & mmask) << trunc);
    out[i] = (((byte >> (2 * i)) & 1u) ? va : 0u) |
             (((byte >> (2 * i + 1)) & 1u) ? vb << 16 : 0u);
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (N/32, splits, M/(8*MT)); 4 warps: warp&1 the column group of 16,
// warp>>1 the half of each superblock's bitmap words. Thread (g = lane/4,
// t = lane%4) decodes byte t of every word of columns g and g+8 and holds
// the sums of x rows 2t, 2t+1 of every n-tile.
template <int MT, bool FAST>
__global__ void __launch_bounds__(kThreads) draft_mma_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int stage_words = kCols * a.L.cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp & 1, kw = warp >> 1;
  const int col0 = blockIdx.x * kCols;
  const int sb0 = blockIdx.y * a.chunk;
  const int nsb = min(a.NB, sb0 + a.chunk) - sb0;
  const int m0 = blockIdx.z * 8 * MT;

  uint32_t tlo = 0u, thi = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    tlo |= (static_cast<uint32_t>(__ldg(a.book + i)) & 0xFFu) << (8 * i);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    thi |= (static_cast<uint32_t>(__ldg(a.book + 4 + i)) & 0xFFu) << (8 * i);

  const int half = (a.bw + 1) >> 1;
  const int w_lo = kw ? half : 0, w_hi = kw ? a.bw : half;
  const uint32_t lowmask = (1u << (8 * t)) - 1u;
  const int lc0 = cg * 16 + g, lc1 = lc0 + 8;

  const uint4* xrow[MT];
  bool xok[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + mt * 8 + g;
    xok[mt] = m < a.M;
    xrow[mt] = reinterpret_cast<const uint4*>(
        a.x + static_cast<size_t>(xok[mt] ? m : 0) * a.K + 8 * t);
  }
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;

  load_stage(a, smem, col0, sb0);
  cp_commit();
  for (int i = 0; i < nsb; ++i) {
    if (i + 1 < nsb) {
      load_stage(a, smem + ((i + 1) & 1) * stage_words, col0, sb0 + i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t* st = smem + (i & 1) * stage_words;
    const uint32_t* c0 = st + lc0 * a.L.cs;
    const uint32_t* c1 = st + lc1 * a.L.cs;
    const uint32_t thi0 = thi | (c0[a.L.em] << 24);
    const uint32_t thi1 = thi | (c1[a.L.em] << 24);
    int base0 = 0, base1 = 0;
    for (int w = 0; w < w_lo; ++w) {
      base0 += __popc(c0[a.L.bm + w]);
      base1 += __popc(c1[a.L.bm + w]);
    }
    const int k_sb = (sb0 + i) * a.bw * 4;   // x offset in 16-byte units
    for (int w = w_lo; w < w_hi; ++w) {
      const uint32_t b0 = c0[a.L.bm + w], b1 = c1[a.L.bm + w];
      const int q0 = min(base0 + __popc(b0 & lowmask), a.keep);
      const int q1 = min(base1 + __popc(b1 & lowmask), a.keep);
      const uint32_t y0 = prmt(b0, 0u, 0x4440u | t);    // byte t
      const uint32_t y1 = prmt(b1, 0u, 0x4440u | t);
      uint32_t A0[4], A1[4];
      if constexpr (FAST) {
        decode_byte_fast(y0, q0, c0 + a.L.sm, c0 + a.L.ex, tlo, thi0, A0);
        decode_byte_fast(y1, q1, c1 + a.L.sm, c1 + a.L.ex, tlo, thi1, A1);
      } else {
        decode_byte_general(y0, q0, c0 + a.L.sm, c0 + a.L.ex, tlo, thi0,
                            a.trunc, A0);
        decode_byte_general(y1, q1, c1 + a.L.sm, c1 + a.L.ex, tlo, thi1,
                            a.trunc, A1);
      }
      base0 += __popc(b0);
      base1 += __popc(b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 xv = xok[mt] ? __ldg(xrow[mt] + k_sb + 4 * w)
                                 : make_uint4(0u, 0u, 0u, 0u);
        // k-step A: positions 8t..8t+3; k-step B: 8t+4..8t+7
        mma_bf16(acc[mt], A0[0], A1[0], A0[1], A1[1], xv.x, xv.y);
        mma_bf16(acc[mt], A0[2], A1[2], A0[3], A1[3], xv.z, xv.w);
      }
    }
    __syncthreads();                       // the stage is free for reuse
  }

  // the second half's sums join the first's, in that order
  float* red = reinterpret_cast<float*>(smem);
  if (kw == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[((cg * MT + mt) * 4 + r) * 32 + lane] = acc[mt][r];
  }
  __syncthreads();
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  float* out = a.splits > 1 ? a.ws + blockIdx.y * mn : a.y;
  if (kw == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v =
            acc[mt][r] + red[((cg * MT + mt) * 4 + r) * 32 + lane];
        const int col = col0 + (r < 2 ? lc0 : lc1);
        const int m = m0 + mt * 8 + 2 * t + (r & 1);
        if (col < a.N && m < a.M) out[static_cast<size_t>(m) * a.N + col] = v;
      }
  }
  if (a.splits == 1) return;
  // split-K: the tile's last CTA to finish sums the partials in split order
  // (the same bits whichever CTA is last) and re-arms the ticket
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(a.tickets + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(8 * MT, a.M - m0);
  for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
    const int col = col0 + (i % kCols);
    if (col >= a.N) continue;
    const size_t o = static_cast<size_t>(m0 + i / kCols) * a.N + col;
    float v = __ldcg(a.ws + o);
#pragma unroll 4
    for (int k = 1; k < a.splits; ++k) v += __ldcg(a.ws + k * mn + o);
    a.y[o] = v;
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0;
}

int granule(const void* p, int n) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  if (n % 4 == 0 && u % 16 == 0) return 4;
  if (n % 2 == 0 && u % 8 == 0) return 2;
  return 1;
}

template <int MT, bool FAST>
cudaError_t launch(const Args& a, dim3 grid, size_t smem_bytes,
                   cudaStream_t stream) {
  static size_t attr = 0;                  // dynamic smem granted so far
  if (smem_bytes > 48 * 1024 && smem_bytes > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        draft_mma_kernel<MT, FAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
    attr = smem_bytes;
  }
  draft_mma_kernel<MT, FAST><<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (M,K) bf16 · bitmap (N,NB,block/32) · signmant (N,NB,wsm) · exp3
// (N,NB,we) uint32 words · emax (N,NB) int32 · book (8,) int32 -> y (M,N)
// f32. `chunk` superblocks per CTA; when that gives more than one split,
// `ws` is an f32 workspace of (splits, M, N) and `tickets` an int32 array,
// zero on entry and on return, of one entry per (column tile, row tile).
// Returns the CUDA error of the launch (0 on success).
extern "C" int cassandra_draft_matmul(const void* x, const void* bitmap,
                                      const void* signmant, const void* exp3,
                                      const void* emax, const void* book,
                                      void* y, void* ws, void* tickets, int M,
                                      int K, int N, int block, int keep,
                                      int trunc, int wsm, int we, int chunk,
                                      void* stream) {
  int bw = 0;
  for (int l = 0; l <= 4; ++l)
    if ((32 << l) == block) bw = 1 << l;
  if (bw == 0 || K % block != 0 || M < 1 || N < 1 || trunc < 0 ||
      trunc > 7 || keep < 1 || keep > block || chunk < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const uint16_t*>(x);
  a.bitmap = static_cast<const uint32_t*>(bitmap);
  a.signmant = static_cast<const uint32_t*>(signmant);
  a.exp3 = static_cast<const uint32_t*>(exp3);
  a.emax = static_cast<const uint32_t*>(emax);
  a.book = static_cast<const int32_t*>(book);
  a.M = M; a.K = K; a.N = N; a.NB = K / block; a.bw = bw; a.keep = keep;
  a.trunc = trunc; a.wsm = wsm; a.we = we; a.chunk = chunk;
  a.g_bm = granule(bitmap, bw);
  a.g_sm = granule(signmant, wsm);
  a.g_ex = granule(exp3, we);
  a.L = make_layout(bw, wsm, we);
  a.splits = (a.NB + chunk - 1) / chunk;
  a.y = static_cast<float*>(y);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  if (a.splits > 1 && (ws == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool small = M <= 8;
  const int rows = small ? 8 : 32;
  const dim3 grid((N + kCols - 1) / kCols, a.splits, (M + rows - 1) / rows);
  const size_t smem_bytes = static_cast<size_t>(kStages) * kCols * a.L.cs * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = trunc == 4;
  cudaError_t e;
  if (small)
    e = fast ? launch<1, true>(a, grid, smem_bytes, s)
             : launch<1, false>(a, grid, smem_bytes, s);
  else
    e = fast ? launch<4, true>(a, grid, smem_bytes, s)
             : launch<4, false>(a, grid, smem_bytes, s);
  return static_cast<int>(e);
}
