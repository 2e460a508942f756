// Cassandra-2 MX decode for Hopper (sm_90a): MX lanes -> bf16.
//
// Replaces the TPU kernel `mx_decode` (src/repro/kernels/mx_decode.py,
// `_kernel`): each lane holds a sign byte and a 16-bit fixed-point container
// m16 = (1.mmmmmmm << 8) >> (E_shared - e), and `group` lanes share one 8-bit
// exponent. The decode finds the container's leading one (a leading-zero
// count), shifts the 7 bits below it into the bf16 mantissa and subtracts
// the leading one's distance from the container top from the shared
// exponent; a zero container or an exponent <= 0 flushes to +-0. Bit for bit
// the TPU kernel's arithmetic: lead = 15 - clz16(m16) (-1 for 0), e =
// shared - (15 - lead), shift = clip(lead - 7, -7, 8), mant = (m16 >> shift
// or m16 << -shift) & 0x7F, the sign's bit 0 at bit 15.
//
// Bound. Per lane the kernel reads 1 + 2 bytes and 1/group of a shared
// exponent byte and writes 2 bytes; its ~15 integer operations per lane are
// far below what the CUDA cores issue per byte, so it is bound by those
// bytes at 3.35 TB/s. The TPU kernel did the same work as one vector pass
// over (tile, K) blocks. Here one thread decodes one lane (grid-stride over
// all lanes): neighbouring threads read neighbouring bytes, so loads and the
// store coalesce; the shared exponent is a broadcast read within a group.
// What this first version leaves out: wider per-thread loads (two or four
// lanes per thread) and fusing the decode into its consumers (the
// desparsify and the matmul of the C-2 weights).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 64;

__global__ void __launch_bounds__(kThreads)
mx_decode_kernel(const uint8_t* __restrict__ sign,
                 const uint16_t* __restrict__ m16,
                 const uint8_t* __restrict__ shared_exp,
                 uint16_t* __restrict__ out, long long total, int K,
                 int group) {
  const int ng = K / group;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long r = i / K;
    const int k = static_cast<int>(i - r * K);
    const uint32_t m = m16[i];
    const int se = shared_exp[r * ng + k / group];
    const int lead = m ? 31 - __clz(m) : -1;  // m < 2^16: bit index 0..15
    const int e = se - (15 - lead);
    const bool zero = (m == 0u) || (e <= 0);
    const int shift = min(max(lead - 7, -7), 8);
    const uint32_t mant = (shift >= 0 ? (m >> shift) : (m << -shift)) & 0x7Fu;
    const uint32_t ef = zero ? 0u : static_cast<uint32_t>(min(max(e, 0), 255));
    const uint32_t mf = zero ? 0u : mant;
    out[i] = static_cast<uint16_t>(((static_cast<uint32_t>(sign[i]) & 1u) << 15) |
                                   (ef << 7) | mf);
  }
}

}  // namespace

// sign (rows,K) u8 · m16 (rows,K) u16 · shared_exp (rows,K/group) u8 ->
// out (rows,K) bf16 bits. Returns cudaGetLastError() after the launch.
extern "C" int mx_decode_launch(const void* sign, const void* m16,
                                const void* shared_exp, void* out, int rows,
                                int K, int group, void* stream) {
  if (rows < 0 || K < 1 || group < 1 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(rows) * K;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  mx_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sign), static_cast<const uint16_t*>(m16),
      static_cast<const uint8_t*>(shared_exp), static_cast<uint16_t*>(out),
      total, K, group);
  return static_cast<int>(cudaGetLastError());
}
