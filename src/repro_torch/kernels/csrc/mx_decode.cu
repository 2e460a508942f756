// Cassandra-2 MX decode for Hopper (sm_90a): MX lanes -> bf16, alone and
// inside the one-launch draft and target views of a packed C-2 tensor.
//
// Replaces the TPU kernel `mx_decode` (src/repro/kernels/mx_decode.py,
// `_kernel`) and, in `mx_view`, the reference's chain around it
// (`format.draft_tensor` / `target_tensor` with `bitops.unpack_codes`,
// `format._mx_lanes` and `pruning.desparsify`, src/repro/core/).
//
// The decode (`mx_lane`, shared by both entries). Each lane holds a sign bit
// and a 16-bit fixed-point container m16 = (1.mmmmmmm << 8) >> (E_shared -
// e), and `group` lanes share one 8-bit exponent. Bit for bit the TPU
// kernel's arithmetic: lead = 15 - clz16(m16) (-1 for 0), e = shared - (15 -
// lead), shift = clip(lead - 7, -7, 8), mant = (m16 >> shift or m16 <<
// -shift) & 0x7F, the sign's bit 0 at bit 15; a zero container or e <= 0
// flushes to +-0. A group with an exponent gap above 8 has had the lane
// shifted out of its container by the encoder (MX's own loss): the decode
// gives what the chain gives.
//
// `mx_decode` (the standalone entry: phase 9's codec rows hold it against
// its plain version). A thread takes 8 lanes of one row: an 8-byte sign load,
// a 16-byte container load, one shared-exponent byte where a group covers
// the 8 lanes, and one 16-byte store. The 2-D grid walks (rows, 8-lane
// pieces), so no thread divides its lane index. Rows whose lane count is not
// a multiple of 8 take the same path with scalar loads. Bound: 1 + 2 bytes
// read and 2 written a lane, plus 1/group of an exponent byte.
//
// `mx_view`: a packed C-2 tensor's draft or target view in one launch. The
// tensor is U blocks of `block` values (a weight: n_out x n_in / block; a KV
// store: one block a (token, head) vector), each with leaves
//   bitmap (block/32 words), signmant (codes of 1 + draft_bits bits),
//   shared_exp (keep/group bytes), and for the target view mant_lo (codes of
//   16 - draft_bits bits) and pruned_raw (block - keep 16-bit patterns),
// laid out as `format.format_tensor` writes them. One warp owns one block at
// a time; a CTA of 8 warps owns a run of blocks (`view_plan` in mx_decode.py
// sizes the runs so the grid is one wave), the warps interleaved along it.
// Per block:
//   1. the leaves are staged in a two-slot ring in shared memory with
//      `cp.async` (16-byte pieces where a region allows, else 4-byte; the
//      exponent bytes through a register loaded one block ahead), the next
//      block's copies in flight while this one decodes;
//   2. phase 1: lane l decodes kept ranks 2l and 2l + 1, then 2l + 64, ...:
//      both codes of a stream come from one funnel shift of two words at
//      bit offset rank x width (codes straddle words), the container is
//      assembled from the sign|top code and, for the target view, the low
//      code, and the shared decode writes a bf16 pair of the block's kept
//      values in shared memory;
//   3. phase 2: lane l owns positions l * V .. l * V + V - 1 (V = block/32);
//      a warp scan of the __popc of its bitmap bits gives its first kept
//      rank (the ones before) and its first pruned rank (the zeros before);
//      each position takes its kept value or its pruned value (raw, moved as
//      16-bit patterns, NaN payloads and all; zero for the draft view and
//      when nothing is pruned), with the indices clamped to keep - 1 and
//      block - keep - 1 as `pruning.desparsify` clamps them;
//   4. the lane's V values leave as 16-byte stores where V allows (bf16, or
//      f32 for the draft product: the bf16 pattern widened, bit for bit the
//      chain's `.to(torch.float32)`), the warp's row coalesced.
// Bound: the packed leaves read once (274 B a 512-value block of the
// speculation side at the paper's defaults, 864 B more of the verification
// side for the target view) and the view written once (1 KB bf16 or 2 KB
// f32), at 3.35 TB/s; PERF.md has the times beside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 8;                 // mx_decode: lanes per thread

// The MX decode of one lane: sign bit 0, container m (< 2^16), shared
// exponent se (0..255) -> bf16 bits. lead = 31 - clz(m) is 15 - clz16(m),
// and -1 for m = 0. For a nonzero container lead - 7 lies in [-7, 8], so the
// reference's clip never binds and its two shifts are one: the 7 bits below
// the leading one are (m << 16) >> (lead + 9); e = se - (15 - lead) <= 255,
// so the clamp to 255 never binds either, and a lane with m = 0 or e <= 0
// flushes to its signed zero.
__device__ __forceinline__ uint32_t mx_lane(uint32_t sign, uint32_t m,
                                            int se) {
  const int lead = 31 - __clz(m);
  const int e = se - (15 - lead);
  const uint32_t mant = ((m << 16) >> (lead + 9)) & 0x7Fu;
  const uint32_t s = (sign & 1u) << 15;
  return (m == 0u || e <= 0) ? s : s | static_cast<uint32_t>(e) << 7 | mant;
}

// ---------------------------------------------------------------------------
// mx_decode: lanes of (rows, K)
// ---------------------------------------------------------------------------

// Thread (x, y) of CTA (bx, by): row bx * blockDim.y + y, lanes
// (by * blockDim.x + x) * 8 .. + 7. VEC: K % 8 == 0 and 16-byte rows.
template <bool VEC>
__global__ void __launch_bounds__(256)
mx_decode_kernel(const uint8_t* __restrict__ sign,
                 const uint16_t* __restrict__ m16,
                 const uint8_t* __restrict__ shared_exp,
                 uint16_t* __restrict__ out, int rows, int K, int group) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                      threadIdx.y;
  const int k0 = (blockIdx.y * blockDim.x + threadIdx.x) * kLanes;
  if (r >= rows || k0 >= K) return;
  const int ng = K / group;
  const long long base = r * K + k0;
  uint32_t s[kLanes], m[kLanes];
  if constexpr (VEC) {
    const uint2 sv = *reinterpret_cast<const uint2*>(sign + base);
    const uint4 mv = *reinterpret_cast<const uint4*>(m16 + base);
    const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      s[j] = ((j < 4 ? sv.x : sv.y) >> (8 * (j & 3))) & 0xFFu;
      m[j] = (mw[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool in = k0 + j < K;
      s[j] = in ? sign[base + j] : 0u;
      m[j] = in ? m16[base + j] : 0u;
    }
  }
  const uint8_t* se_row = shared_exp + r * ng;
  const bool one_exp = group % kLanes == 0;   // the 8 lanes share a group
  const int se0 = one_exp ? se_row[k0 / group] : 0;
  uint32_t o[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int se = one_exp ? se0 : (k0 + j < K ? se_row[(k0 + j) / group] : 0);
    o[j] = mx_lane(s[j], m[j], se);
  }
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(out + base) =
        make_uint4(o[0] | o[1] << 16, o[2] | o[3] << 16, o[4] | o[5] << 16,
                   o[6] | o[7] << 16);
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      if (k0 + j < K) out[base + j] = static_cast<uint16_t>(o[j]);
  }
}

// ---------------------------------------------------------------------------
// mx_view: a packed C-2 tensor's view
// ---------------------------------------------------------------------------

struct View {
  const uint32_t* bitmap;     // (U, block / 32)
  const uint32_t* signmant;   // (U, wsm)
  const uint8_t* sexp;        // (U, ng)
  const uint32_t* mant_lo;    // (U, wlo), target view
  const uint32_t* pruned;     // (U, P / 2) pairs of 16-bit patterns, target
  void* out;                  // (U, block) bf16 or f32
  long long U;
  int block, keep, gshift, db, wsm, wlo, ng, P;
  int chunk;                  // blocks per CTA
  // word offsets of a ring slot's regions, and the slot's size
  int o_sm, o_lo, o_pr, o_se, slot;
  int wstride;                // words a warp owns: two slots, kept values
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// n words from src to dst (shared), the warp's lanes strided: 16-byte
// pieces when both ends allow, else 4-byte.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int n, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = lane * 4; i < n; i += 128)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_u32(dst + i)),
                   "l"(src + i));
  } else {
    for (int i = lane; i < n; i += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_u32(dst + i)),
                   "l"(src + i));
  }
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += a;
  }
  return v;
}

// The 32 bits at bit offset `off` of the staged words: two codes of up to
// 16 bits each, wherever they straddle a word.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* w, int off) {
  return __funnelshift_r(w[off >> 5], w[(off >> 5) + 1], off & 31);
}

template <bool TARGET>
__device__ __forceinline__ void issue(const View& v, long long u,
                                      uint32_t* slot, int lane) {
  const int nbw = v.block >> 5;
  stage(slot, v.bitmap + u * nbw, nbw, lane);
  stage(slot + v.o_sm, v.signmant + u * v.wsm, v.wsm, lane);
  if (TARGET) {
    stage(slot + v.o_lo, v.mant_lo + u * v.wlo, v.wlo, lane);
    stage(slot + v.o_pr, v.pruned + u * (v.P >> 1), v.P >> 1, lane);
  }
}

// The V output values of lane l: bf16 patterns in o[], stored as f32 or
// bf16, 16 bytes a store where V allows.
template <int V>
__device__ __forceinline__ void store_run(void* out, long long at,
                                          const uint32_t* o, bool f32) {
  if (f32) {
    uint32_t* p = static_cast<uint32_t*>(out) + at;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<uint4*>(p + i) =
            make_uint4(o[i] << 16, o[i + 1] << 16, o[i + 2] << 16,
                       o[i + 3] << 16);
    } else if constexpr (V % 2 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 2)
        *reinterpret_cast<uint2*>(p + i) = make_uint2(o[i] << 16,
                                                      o[i + 1] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = o[i] << 16;
    }
    return;
  }
  uint16_t* p = static_cast<uint16_t*>(out) + at;
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 8)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(o[i] | o[i + 1] << 16, o[i + 2] | o[i + 3] << 16,
                     o[i + 4] | o[i + 5] << 16, o[i + 6] | o[i + 7] << 16);
  } else if constexpr (V % 4 == 0) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(o[0] | o[1] << 16, o[2] | o[3] << 16);
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 2)
      *reinterpret_cast<uint32_t*>(p + i) = o[i] | o[i + 1] << 16;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = static_cast<uint16_t>(o[i]);
  }
}

// The lane's V positions: position i takes kept value k (ones before it)
// or pruned value z (zeros before it), 16-bit patterns; CLAMP clamps the
// indices to keep - 1 and P - 1 as `pruning.desparsify` does.
template <int V, bool TARGET, bool CLAMP>
__device__ __forceinline__ void place(uint32_t* o, uint32_t bits, int k,
                                      int z, const uint16_t* kept,
                                      const uint16_t* pv, int keep, int P) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const bool one = (bits >> i) & 1u;
    const uint32_t kv = kept[CLAMP ? min(k, keep - 1) : k];
    uint32_t pr = 0u;
    if (TARGET && P > 0) pr = pv[CLAMP ? min(z, P - 1) : z];
    o[i] = one ? kv : pr;
    k += one;
    z += !one;
  }
}

template <int V, bool TARGET>
__global__ void __launch_bounds__(kThreads, 4) mx_view_kernel(View v,
                                                              int f32) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* ring = smem + warp * v.wstride;
  uint16_t* kept = reinterpret_cast<uint16_t*>(ring + 2 * v.slot);
  const long long end = min(v.U, static_cast<long long>(blockIdx.x + 1) *
                                     v.chunk);
  long long u = static_cast<long long>(blockIdx.x) * v.chunk + warp;
  const int W1 = 1 + v.db, WLO = 16 - v.db;
  const uint32_t dmask = (1u << v.db) - 1u;
  const uint32_t m1 = (1u << W1) - 1u, mlo = (1u << WLO) - 1u;
  int s = 0;
  uint32_t se = 0;
  if (u < end) {
    issue<TARGET>(v, u, ring, lane);
    if (lane < v.ng) se = v.sexp[u * v.ng + lane];
  }
  asm volatile("cp.async.commit_group;");
  for (; u < end; u += kWarps, s ^= 1) {
    uint32_t* cur = ring + s * v.slot;
    const long long un = u + kWarps;
    uint32_t se_next = 0;
    if (un < end) {
      issue<TARGET>(v, un, ring + (s ^ 1) * v.slot, lane);
      if (lane < v.ng) se_next = v.sexp[un * v.ng + lane];
    }
    asm volatile("cp.async.commit_group;");
    if (lane < v.ng) reinterpret_cast<uint8_t*>(cur + v.o_se)[lane] = se;
    se = se_next;
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    // phase 1: the kept values, lane l ranks 2l and 2l + 1, then + 64:
    // both codes of a stream from one 32-bit window
    const uint8_t* sev = reinterpret_cast<const uint8_t*>(cur + v.o_se);
    for (int j = 2 * lane; j < v.keep; j += 64) {
      const uint32_t c2 = bits_at(cur + v.o_sm, j * W1);
      const uint32_t c0 = c2 & m1, c1 = (c2 >> W1) & m1;
      uint32_t m0 = (c0 & dmask) << WLO, m1v = (c1 & dmask) << WLO;
      if (TARGET) {
        const uint32_t l2 = bits_at(cur + v.o_lo, j * WLO);
        m0 |= l2 & mlo;
        m1v |= (l2 >> WLO) & mlo;
      }
      const int se0 = sev[j >> v.gshift];
      const int se1 = v.gshift ? se0 : sev[j + 1];
      *reinterpret_cast<uint32_t*>(kept + j) =
          mx_lane(c0 >> v.db, m0, se0) | mx_lane(c1 >> v.db, m1v, se1) << 16;
    }
    __syncwarp();
    // phase 2: lane l's positions l * V ...
    const int p0 = lane * V;
    uint32_t bits;
    if constexpr (32 % V == 0) {
      bits = cur[p0 >> 5] >> (p0 & 31);
    } else {
      bits = __funnelshift_r(cur[p0 >> 5], cur[(p0 >> 5) + 1], p0 & 31);
    }
    bits &= V == 32 ? kFull : ((1u << V) - 1u);
    const int c = __popc(bits);
    int k = warp_incl_sum(c, lane) - c;       // ones before p0
    int z = p0 - k;                           // zeros before p0
    const uint16_t* pv = reinterpret_cast<const uint16_t*>(cur + v.o_pr);
    uint32_t o[V];
    // the encoder's bitmaps hold exactly keep ones, so no index leaves the
    // values and the clamps of `desparsify` are needed only for others
    if (__all_sync(kFull, k + c <= v.keep && (!TARGET || z + V - c <= v.P)))
      place<V, TARGET, false>(o, bits, k, z, kept, pv, v.keep, v.P);
    else
      place<V, TARGET, true>(o, bits, k, z, kept, pv, v.keep, v.P);
    store_run<V>(v.out, u * v.block + p0, o, f32 != 0);
    __syncwarp();                 // the slot and the kept values are free
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int V>
cudaError_t launch_view(const View& v, bool target, int f32, unsigned ctas,
                        size_t smem, cudaStream_t stream) {
  auto kern = target ? mx_view_kernel<V, true> : mx_view_kernel<V, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<ctas, kThreads, smem, stream>>>(v, f32);
  return cudaGetLastError();
}

inline int round4(int x) { return (x + 3) & ~3; }

}  // namespace

// sign (rows,K) u8 · m16 (rows,K) u16 · shared_exp (rows,K/group) u8 ->
// out (rows,K) bf16 bits. Returns cudaGetLastError() after the launch.
extern "C" int mx_decode_launch(const void* sign, const void* m16,
                                const void* shared_exp, void* out, int rows,
                                int K, int group, void* stream) {
  if (rows < 0 || K < 1 || group < 1 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int pieces = (K + kLanes - 1) / kLanes;
  const int bx = pieces < 256 ? pieces : 256;
  const int by = 256 / bx;
  const dim3 block(bx, by);
  const dim3 grid((rows + by - 1) / by, (pieces + bx - 1) / bx);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % kLanes == 0 &&
                   reinterpret_cast<uintptr_t>(sign) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(m16) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    mx_decode_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(sign), static_cast<const uint16_t*>(m16),
        static_cast<const uint8_t*>(shared_exp), static_cast<uint16_t*>(out),
        rows, K, group);
  else
    mx_decode_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(sign), static_cast<const uint16_t*>(m16),
        static_cast<const uint8_t*>(shared_exp), static_cast<uint16_t*>(out),
        rows, K, group);
  return static_cast<int>(cudaGetLastError());
}

// The draft (mant_lo == pruned == NULL) or target view of U packed blocks
// of `block` values -> out (U, block), bf16 or (f32 != 0) f32. `chunk`
// blocks per CTA (`view_plan`). group must be a power of two, keep/group <=
// 32, block a multiple of 32 up to 512, block - keep even.
extern "C" int mx_view_launch(const void* bitmap, const void* signmant,
                              const void* shared_exp, const void* mant_lo,
                              const void* pruned, void* out, int U,
                              int block, int keep, int group, int draft_bits,
                              int f32, int chunk, void* stream) {
  const bool target = mant_lo != nullptr;
  if (U < 0 || block < 32 || block > 512 || block % 32 != 0 || keep < 1 ||
      keep > block || group < 1 || (group & (group - 1)) != 0 ||
      keep % group != 0 || keep / group > 32 || draft_bits < 1 ||
      draft_bits > 15 || (block - keep) % 2 != 0 || chunk < 1 ||
      (target && block > keep && pruned == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (U == 0) return 0;
  View v{};
  v.bitmap = static_cast<const uint32_t*>(bitmap);
  v.signmant = static_cast<const uint32_t*>(signmant);
  v.sexp = static_cast<const uint8_t*>(shared_exp);
  v.mant_lo = static_cast<const uint32_t*>(mant_lo);
  v.pruned = static_cast<const uint32_t*>(pruned);
  v.out = out;
  v.U = U;
  v.block = block;
  v.keep = keep;
  v.gshift = __builtin_ctz(static_cast<unsigned>(group));
  v.db = draft_bits;
  v.wsm = (keep * (1 + draft_bits) + 31) / 32;
  v.wlo = target ? (keep * (16 - draft_bits) + 31) / 32 : 0;
  v.ng = keep / group;
  v.P = target ? block - keep : 0;
  v.chunk = chunk;
  // a region's words, one more read past its end (a code's second word),
  // each region on a 16-byte boundary
  v.o_sm = round4(block / 32 + 1);
  v.o_lo = v.o_sm + round4(v.wsm + 1);
  v.o_pr = v.o_lo + round4(v.wlo + 1);
  v.o_se = v.o_pr + round4(v.P / 2 + 1);
  v.slot = v.o_se + round4(v.ng / 4 + 1);
  // the kept values and one more: a position past the block's last one
  // reads kept value `keep` (and discards it) when no clamp runs
  v.wstride = round4(2 * v.slot + keep / 2 + 1);
  const long long ctas = (static_cast<long long>(U) + chunk - 1) / chunk;
  const size_t smem = static_cast<size_t>(kWarps) * v.wstride *
                      sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(ctas);
  cudaError_t e;
  switch (block / 32) {
#define MXV_CASE(n) \
  case n: e = launch_view<n>(v, target, f32, g, smem, s); break;
    MXV_CASE(1) MXV_CASE(2) MXV_CASE(3) MXV_CASE(4) MXV_CASE(5) MXV_CASE(6)
    MXV_CASE(7) MXV_CASE(8) MXV_CASE(9) MXV_CASE(10) MXV_CASE(11)
    MXV_CASE(12) MXV_CASE(13) MXV_CASE(14) MXV_CASE(15) MXV_CASE(16)
#undef MXV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
