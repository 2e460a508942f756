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
// once; the work is 2(L + R) + 2L flops per (head, query, token). At
// DeepSeek-V3's widths (H = 128, L = 512, R = 64) that is thousands of flops
// per pool byte, so the kernel is bound by its products.
//
// Design:
//   * Products on the tensor cores at f32 grade: `mma.sync` m16n8k8 TF32 with
//     f32 accumulators. c and kr are bf16, exact in TF32; the f32 operand (q
//     for the scores, p for the update) is split into hi + lo TF32 parts
//     (cvt.rna, the remainder rounded again), two products per term, so a
//     product keeps ~22 of the 24 mantissa bits. Both products are computed
//     transposed, so the bf16 pool is always the A operand and only the
//     small operand is split:
//       scores^T (tokens x pairs)  = [c | kr] (tokens x (L+R)) . [q_eff |
//                                    q_rope]^T, the (L+R)/8 k-steps cut
//                                    among the 8 warps, the partials summed
//                                    in warp order;
//       acc^T (L x pairs)         += c^T (L x tokens) . p^T, each warp a
//                                    slice of L/8 latent dims for every pair.
//   * One CTA owns (row b, a tile of 32 (head, query) pairs, one chunk of the
//     row's table). The tile's q (32 x (L + R) f32) is staged in shared
//     memory once. The walk takes steps of 32 tokens (32 / BS whole blocks,
//     or one block when BS > 16): each step's c (32 x L bf16) and kr rows go
//     through a two-slot `cp.async` ring, the next step's copy in flight
//     while this one runs. Rows past the row's length, past the CTA's chunk
//     or past the step's blocks are staged as zeros, so a NaN in an
//     unwritten or trash slot never reaches acc; their scores are masked to
//     -1e30 and their p is 0.
//   * The scores' hi and lo products go to accumulators of their own (two
//     independent mma chains), summed once; the softmax writes p already
//     split, so phase B's 8 warps load its hi and lo parts.
//   * The online softmax runs between the two products (8 threads a pair),
//     in the reference's form: m from -1e30, l from 0, expf, corr =
//     exp(m - m_new) applied to acc before the step's update (a step of
//     several blocks is one flash step over their tokens: the same sum in
//     another order, within the tolerance).
//   * Table split (flash decoding): when the (row, pair tile) grid leaves SMs
//     idle, `mla_split_plan` (paged_attention.py) cuts each row's table into
//     chunks of `bps` blocks, one CTA each, and a dependent kernel
//     (programmatic launch) merges the partial states in split order. The
//     plan depends on (B, T, H, MB) alone, so a result does not depend on
//     the data or the run. A grid whose tiles fill the card (a 32-token
//     prefill chunk) walks each table whole, in order.
//   * Table entries outside [0, NB) read block 0, the trash block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQT = 32;                         // (head, query) pairs a CTA
constexpr int kMaxBS = 32;
constexpr int kMaxR = 128;
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
  float* ws;                  // splits > 1: partial acc, then m and l
  int B, T, H, R, NB, BS, MB, bps, splits;
  float scale;
};

// Shared-memory layout (floats / bf16 counts), all strides chosen so that
// the fragment loads of a warp hit 32 distinct banks. A step takes kTS
// tokens: 32 / BS whole table blocks (one block when BS > 16).
constexpr int kTS = 32;

struct Layout {
  int qstr, cstr, kstr, sps, pstr;
  int slot;                   // bf16 elements of one ring slot
  size_t q_off, ring_off, sp_off, ps_off, cs_off, bytes;
};

__host__ __device__ inline Layout layout(int L, int R) {
  Layout y{};
  y.qstr = (L + R + 31) / 32 * 32 + 4;
  y.cstr = L + 8;
  y.kstr = R + 8;
  y.sps = kTS + 4;
  y.pstr = kTS + 4;
  y.slot = kTS * (y.cstr + y.kstr);
  y.q_off = 0;
  y.ring_off = y.q_off + sizeof(float) * kQT * y.qstr;
  y.sp_off = y.ring_off + sizeof(uint16_t) * 2 * y.slot;
  y.ps_off = y.sp_off + sizeof(float) * kWarps * kQT * y.sps;
  y.cs_off = y.ps_off + sizeof(uint32_t) * 2 * kQT * y.pstr;
  y.bytes = y.cs_off + sizeof(float) * kQT;
  return y;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ a remainder below 2^-22 |x|), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bf(const uint16_t* p) {
  return static_cast<uint32_t>(*p) << 16;       // bf16 -> f32/TF32, exact
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The step at table column js of row b (blocks js .. js + 32/BS - 1, those
// before je) into ring slot `dst`: valid rows by cp.async (16-byte pieces),
// rows past the length, past je, or past the step's blocks as zeros.
template <int L>
__device__ __forceinline__ void issue(const Walk& w, const Layout& y, int b,
                                      int js, int je, int len,
                                      uint16_t* dst) {
  constexpr int kC = L / 8;                                // pieces a c row
  const int kK = w.R / 8;
  const int per = kC + kK;
  const int nb = max(1, kTS / w.BS);                       // blocks a step
  for (int i = threadIdx.x; i < kTS * per; i += kThreads) {
    const int t = i / per, c = i - t * per;
    const int j = js + t / w.BS, s = t - (t / w.BS) * w.BS;
    uint16_t* d = c < kC ? dst + t * y.cstr + c * 8
                         : dst + kTS * y.cstr + t * y.kstr + (c - kC) * 8;
    if (t / w.BS < nb && j < je && j * w.BS + s < len) {
      int blk = w.table[static_cast<size_t>(b) * w.MB + j];
      if (blk < 0 || blk >= w.NB) blk = 0;                 // trash block
      const uint16_t* src =
          c < kC ? w.c_pool + (static_cast<size_t>(blk) * w.BS + s) * L + c * 8
                 : w.kr_pool + (static_cast<size_t>(blk) * w.BS + s) * w.R +
                       (c - kC) * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_u32(d)),
                   "l"(src));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// grid (B * pair tiles, splits): chunk `split` of row b's table for pairs
// tile * 32 ... (pair r: head r / T, query r % T).
template <int L>
__global__ void __launch_bounds__(kThreads, 1) paged_mla_kernel(Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = w.R;
  const Layout y = layout(L, R);
  float* qs = reinterpret_cast<float*>(smem + y.q_off);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + y.ring_off);
  float* sp = reinterpret_cast<float*>(smem + y.sp_off);
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + y.ps_off);
  uint32_t* pl = ph + kQT * y.pstr;
  float* cs = reinterpret_cast<float*>(smem + y.cs_off);
  const int ht = w.H * w.T;
  const int tiles = (ht + kQT - 1) / kQT;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = tile * kQT;

  // the tile's q rows: [q_eff | q_rope], zeros past H*T
  const int qw = (L + R) / 4;
  for (int i = threadIdx.x; i < kQT * qw; i += kThreads) {
    const int p = i / qw, c4 = (i - p * qw) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int r = r0 + p;
    if (r < ht) {
      const int h = r / w.T, t = r - h * w.T;
      const size_t qoff = (static_cast<size_t>(b) * w.T + t) * w.H + h;
      v = c4 < L ? *reinterpret_cast<const float4*>(w.q_eff + qoff * L + c4)
                 : *reinterpret_cast<const float4*>(w.q_rope + qoff * R + c4 -
                                                    L);
    }
    *reinterpret_cast<float4*>(qs + p * y.qstr + c4) = v;
  }

  // phase B's tiles: m-tiles of 16 latent dims x n-tiles of 8 pairs
  constexpr int TPW = L / 32;                    // (L/16) * 4 tiles / 8 warps
  constexpr int NTW = TPW >= 4 ? 4 : TPW;
  constexpr int MTW = TPW / NTW;
  const int mt0 = warp * TPW / 4, nt0 = warp * TPW % 4;
  float acc[MTW][NTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  // the softmax state of pair threadIdx.x / 8 (its 8 threads hold copies)
  const int sp_pair = threadIdx.x >> 3, sub = threadIdx.x & 7;
  float m_run = kNegInf, l_run = 0.f;

  const int len = w.length[b];
  const int n_blocks = len > 0 ? min(w.MB, (len + w.BS - 1) / w.BS) : 0;
  const int j0 = split * w.bps;
  const int j1 = min(n_blocks, j0 + w.bps);
  const int nb = max(1, kTS / w.BS);             // table blocks a step
  const int KT = (L + R) / 8;
  const int kt0 = warp * KT / kWarps, kt1 = (warp + 1) * KT / kWarps;

  if (j0 < j1) issue<L>(w, y, b, j0, j1, len, ring);
  asm volatile("cp.async.commit_group;");
  for (int js = j0, s = 0; js < j1; js += nb, s ^= 1) {
    const uint16_t* cslot = ring + s * y.slot;
    const uint16_t* kslot = cslot + kTS * y.cstr;
    if (js + nb < j1)
      issue<L>(w, y, b, js + nb, j1, len, ring + (s ^ 1) * y.slot);
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();

    // phase A: scores^T over this warp's k-steps kt0 .. kt1, both m-tiles
    // of tokens; the hi and lo products in accumulators of their own
    {
      float sh[2][4][4], sl[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sh[mt][n][e] = sl[mt][n][e] = 0.f;
      for (int kk = kt0; kk < kt1; ++kk) {
        const int d0 = kk * 8;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* q = qs + (n * 8 + g) * y.qstr + d0 + tig;
          split_tf32(q[0], bh[n][0], bl[n][0]);
          split_tf32(q[4], bh[n][1], bl[n][1]);
        }
        const bool lat = d0 < L;
        const int as = lat ? y.cstr : y.kstr;
        const uint16_t* a0 = lat ? cslot + g * as + d0 + tig
                                 : kslot + g * as + d0 - L + tig;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint16_t* a = a0 + mt * 16 * as;
          const uint32_t af[4] = {bf(a), bf(a + 8 * as), bf(a + 4),
                                  bf(a + 8 * as + 4)};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            mma(sh[mt][n], af, bh[n][0], bh[n][1]);
            mma(sl[mt][n], af, bl[n][0], bl[n][1]);
          }
        }
      }
      float* out = sp + warp * kQT * y.sps;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = n * 8 + 2 * tig, t = mt * 16 + g;
          out[p * y.sps + t] = sh[mt][n][0] + sl[mt][n][0];
          out[(p + 1) * y.sps + t] = sh[mt][n][1] + sl[mt][n][1];
          out[p * y.sps + t + 8] = sh[mt][n][2] + sl[mt][n][2];
          out[(p + 1) * y.sps + t + 8] = sh[mt][n][3] + sl[mt][n][3];
        }
    }
    __syncthreads();

    // the online softmax: pair sp_pair, tokens sub, sub + 8, ...; p goes
    // to shared memory split into its TF32 hi and lo parts
    {
      float sc[kTS / 8];
      bool ok[kTS / 8];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kTS / 8; ++i) {
        const int t = sub + 8 * i;
        const int j = js + t / w.BS;
        ok[i] = t / w.BS < nb && j < j1 &&
                j * w.BS + (t - (t / w.BS) * w.BS) < len;
        float v = 0.f;
#pragma unroll
        for (int u = 0; u < kWarps; ++u)
          v += sp[(u * kQT + sp_pair) * y.sps + t];
        sc[i] = ok[i] ? v * w.scale : kNegInf;
        mx = fmaxf(mx, sc[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTS / 8; ++i) {
        const int t = sub + 8 * i;
        const float p = ok[i] ? expf(sc[i] - m_new) : 0.f;
        uint32_t hi, lo;
        split_tf32(p, hi, lo);
        ph[sp_pair * y.pstr + t] = hi;
        pl[sp_pair * y.pstr + t] = lo;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (sub == 0) cs[sp_pair] = corr;
    }
    __syncthreads();

    // phase B: acc^T = acc^T * corr + c^T . p^T over this warp's tiles
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const float c0 = cs[(nt0 + n) * 8 + 2 * tig];
      const float c1 = cs[(nt0 + n) * 8 + 2 * tig + 1];
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        acc[i][n][0] *= c0;
        acc[i][n][1] *= c1;
        acc[i][n][2] *= c0;
        acc[i][n][3] *= c1;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < kTS; k0 += 8) {
      uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int o = ((nt0 + n) * 8 + g) * y.pstr + k0 + tig;
        bh[n][0] = ph[o];
        bh[n][1] = ph[o + 4];
        bl[n][0] = pl[o];
        bl[n][1] = pl[o + 4];
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        const uint16_t* a = cslot + (k0 + tig) * y.cstr + (mt0 + i) * 16 + g;
        const uint32_t af[4] = {bf(a), bf(a + 8), bf(a + 4 * y.cstr),
                                bf(a + 4 * y.cstr + 8)};
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          mma(acc[i][n], af, bh[n][0], bh[n][1]);
          mma(acc[i][n], af, bl[n][0], bl[n][1]);
        }
      }
    }
    __syncthreads();                  // the slot, sp, p and cs are free
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // the state: (acc, m, l), or this split's partial in ws
  const int rows = w.B * ht;
  const size_t rb = static_cast<size_t>(b) * ht + r0;
  float* acc_out = w.acc;
  float* m_out = w.m;
  float* l_out = w.l;
  if (w.splits > 1) {
    acc_out = w.ws + static_cast<size_t>(split) * rows * L;
    m_out = w.ws + static_cast<size_t>(w.splits) * rows * L +
            static_cast<size_t>(split) * rows;
    l_out = m_out + static_cast<size_t>(w.splits) * rows;
  }
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int p = (nt0 + n) * 8 + 2 * tig, d = (mt0 + i) * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pe = p + (e & 1), de = d + (e >> 1) * 8;
        if (r0 + pe < ht) acc_out[(rb + pe) * L + de] = acc[i][n][e];
      }
    }
  if (sub == 0 && r0 + sp_pair < ht) {
    m_out[rb + sp_pair] = m_run;
    l_out[rb + sp_pair] = l_run;
  }
  if (w.splits > 1) asm volatile("griddepcontrol.launch_dependents;");
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
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, pm[static_cast<size_t>(s) * rows + row]);
  float a = 0.f, ls = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = expf(pm[static_cast<size_t>(s) * rows + row] - mx);
    a += ws[static_cast<size_t>(s) * rows * D + idx] * c;
    if (lead) ls += pl[static_cast<size_t>(s) * rows + row] * c;
  }
  acc[idx] = a;
  if (lead) {
    m[row] = mx;
    l[row] = ls;
  }
}

template <int L>
cudaError_t launch_walk(const Walk& w, dim3 grid, size_t smem,
                        cudaStream_t stream) {
  static size_t granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  paged_mla_kernel<L><<<grid, kThreads, smem, stream>>>(w);
  return cudaGetLastError();
}

cudaError_t launch_merge(const Walk& w, int L, cudaStream_t stream) {
  const int rows = w.B * w.H * w.T;
  const size_t n = static_cast<size_t>(rows) * L;
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
                            w.splits, rows, L);
}

}  // namespace

// `bps` table blocks per CTA; with more than one split, the partial states
// go to `ws` (acc (splits, B, H, T, L), then m and l (splits, B, H, T)) and
// a second kernel merges them into (acc, m, l). Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a shape the kernel does not
// take, without launching).
extern "C" int paged_mla_launch(const void* q_eff, const void* q_rope,
                                const void* c_pool, const void* kr_pool,
                                const void* table, const void* length,
                                void* acc, void* m, void* l, void* ws, int B,
                                int T, int H, int L, int R, int NB, int BS,
                                int MB, int bps, float scale, void* stream) {
  if (BS < 1 || BS > kMaxBS || R < 8 || R > kMaxR || R % 8 != 0 || B < 0 ||
      T < 0 || H < 0 || bps < 1 ||
      reinterpret_cast<uintptr_t>(c_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(kr_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q_eff) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q_rope) % 16 != 0)
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
  w.ws = static_cast<float*>(ws);
  w.B = B; w.T = T; w.H = H; w.R = R;
  w.NB = NB; w.BS = BS; w.MB = MB;
  w.bps = bps;
  w.splits = MB > 0 ? (MB + bps - 1) / bps : 1;
  w.scale = scale;
  if (w.splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (H * T + kQT - 1) / kQT;
  if (B * tiles == 0) return 0;
  const dim3 grid(B * tiles, w.splits);
  const size_t smem = layout(L, R).bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (L) {
    case 32: e = launch_walk<32>(w, grid, smem, s); break;
    case 64: e = launch_walk<64>(w, grid, smem, s); break;
    case 128: e = launch_walk<128>(w, grid, smem, s); break;
    case 256: e = launch_walk<256>(w, grid, smem, s); break;
    case 512: e = launch_walk<512>(w, grid, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess || w.splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge(w, L, s));
}
