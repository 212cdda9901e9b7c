// chunk_key — the chunk store's key of each chunk of a tensor's bytes:
// unkeyed BLAKE2b with a 16-byte digest (RFC 7693), byte for byte
// hashlib.blake2b(chunk, digest_size=16), the ragged last chunk at its own
// length.  The spec and the plain version: kernels/chunk_key/ops.py.
//
// Replaces no TPU kernel: the JAX package keys chunks on the host with
// hashlib (src/repro/core/chunkstore.py: chunk_key).  It is added so that a
// base streamed off the card whole (core/staging.py) is keyed by the card
// while the host only copies its chunks into the bytes the store keeps.
//
// What bounds it on an H100: integer operations along chains.  A chunk's
// compressions form one sequential chain (8,192 for a 1 MiB chunk); each
// compression is 12 rounds of 8 G functions, and each G's 64-bit adds,
// xors and rotations are 22 32-bit ALU instructions (an add and its carry,
// two xors, two funnel shifts a rotation; a rotation by 32 is a swap of
// halves), about 17 a byte.  The card's integer issue rate would key
// 612 MB in under a millisecond, but one chain cannot be split: its
// latency, not the card's throughput, is the bound.
//
// Design:
//  - one thread a chain, 32 chains a warp: the ALU pipe issues a warp's
//    instruction in the same two cycles whether one lane or 32 are live, so
//    packing chains into lanes costs nothing, and up to 132 x 4 x 32 chains
//    run without two warps sharing a scheduler; the chunk time is the
//    time of one chain at the scheduler's full issue rate;
//  - inside the chain, the state and the message words stay in registers:
//    the rounds are written out with their message indices as literals
//    (KISHU_ROUND), so no register array is indexed at run time, and the
//    four independent G functions of a half-round give the scheduler four
//    instruction streams to interleave;
//  - rotations are __funnelshift_r on the two 32-bit halves;
//  - the next block's 128 bytes are loaded (16-byte loads where the base
//    and the chunk size allow, bytes with zero fill otherwise and for a
//    chunk's partial last block) before the current block is compressed,
//    so the load's latency hides behind ~2,000 instructions;
//  - one compression body a thread: the last block's counter and flag are
//    values, not a second copy of the code.
#include "common.cuh"

namespace kishu {

constexpr int kKeyThreads = 32;       // chains a block: one warp
constexpr uint64_t kIV0 = 0x6A09E667F3BCC908ULL;
constexpr uint64_t kIV1 = 0xBB67AE8584CAA73BULL;
constexpr uint64_t kIV2 = 0x3C6EF372FE94F82BULL;
constexpr uint64_t kIV3 = 0xA54FF53A5F1D36F1ULL;
constexpr uint64_t kIV4 = 0x510E527FADE682D1ULL;
constexpr uint64_t kIV5 = 0x9B05688C2B3E6C1FULL;
constexpr uint64_t kIV6 = 0x1F83D9ABFB41BD6BULL;
constexpr uint64_t kIV7 = 0x5BE0CD19137E2179ULL;
// parameter block word 0: digest length 16, key length 0, fanout 1, depth 1
constexpr uint64_t kParam0 = 0x01010000ULL | 16ULL;

// rotate right by N (a literal) on the 32-bit halves
template <int N>
__device__ __forceinline__ uint64_t rotr64(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  uint32_t rlo, rhi;
  if constexpr (N == 32) {
    rlo = hi;
    rhi = lo;
  } else if constexpr (N < 32) {
    rlo = __funnelshift_r(lo, hi, N);
    rhi = __funnelshift_r(hi, lo, N);
  } else {
    rlo = __funnelshift_r(hi, lo, N - 32);
    rhi = __funnelshift_r(lo, hi, N - 32);
  }
  return (static_cast<uint64_t>(rhi) << 32) | rlo;
}

#define KISHU_G(a, b, c, d, x, y)   \
  do {                              \
    a = a + b + (x);                \
    d = rotr64<32>(d ^ a);          \
    c = c + d;                      \
    b = rotr64<24>(b ^ c);          \
    a = a + b + (y);                \
    d = rotr64<16>(d ^ a);          \
    c = c + d;                      \
    b = rotr64<63>(b ^ c);          \
  } while (0)

// one round with its message schedule row (RFC 7693's SIGMA) as literals
#define KISHU_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, \
                    s13, s14, s15)                                          \
  do {                                                                      \
    KISHU_G(v0, v4, v8, v12, m[s0], m[s1]);                                 \
    KISHU_G(v1, v5, v9, v13, m[s2], m[s3]);                                 \
    KISHU_G(v2, v6, v10, v14, m[s4], m[s5]);                                \
    KISHU_G(v3, v7, v11, v15, m[s6], m[s7]);                                \
    KISHU_G(v0, v5, v10, v15, m[s8], m[s9]);                                \
    KISHU_G(v1, v6, v11, v12, m[s10], m[s11]);                              \
    KISHU_G(v2, v7, v8, v13, m[s12], m[s13]);                               \
    KISHU_G(v3, v4, v9, v14, m[s14], m[s15]);                               \
  } while (0)

// BLAKE2b's F: h ^= the 12 rounds over (h, IV ^ (t, 0, last ? ~0 : 0, 0))
__device__ __forceinline__ void compress(uint64_t (&h)[8],
                                         const uint64_t (&m)[16], uint64_t t,
                                         bool last) {
  uint64_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint64_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint64_t v8 = kIV0, v9 = kIV1, v10 = kIV2, v11 = kIV3;
  uint64_t v12 = kIV4 ^ t, v13 = kIV5, v14 = last ? ~kIV6 : kIV6, v15 = kIV7;
  KISHU_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  KISHU_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  KISHU_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  KISHU_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  KISHU_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  KISHU_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  KISHU_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  KISHU_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  KISHU_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  KISHU_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  KISHU_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  KISHU_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

#undef KISHU_ROUND
#undef KISHU_G

// the 16 little-endian message words of the block of `len` bytes (1..128)
// at p: 16-byte loads when `vec` (p 16-byte aligned and the block whole),
// else byte loads, zero-filled past len; never reads at or past len
__device__ __forceinline__ void load_block(const uint8_t* p, long long len,
                                           bool vec, uint64_t (&m)[16]) {
  if (vec && len >= 128) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 w = __ldg(q + k);
      m[2 * k] = (static_cast<uint64_t>(w.y) << 32) | w.x;
      m[2 * k + 1] = (static_cast<uint64_t>(w.w) << 32) | w.z;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint64_t w = 0;
    for (int b = 0; b < 8; ++b) {
      const long long off = 8 * k + b;
      if (off < len) w |= static_cast<uint64_t>(__ldg(p + off)) << (8 * b);
    }
    m[k] = w;
  }
}

// thread k keys chunk idx[k] of data[0, nbytes): out[16k, 16k + 16) gets
// the first 16 bytes of its final state, little-endian
__global__ void __launch_bounds__(kKeyThreads)
    chunk_key_kernel(const uint8_t* __restrict__ data, long long nbytes,
                     long long chunk_bytes, const long long* __restrict__ idx,
                     long long n_idx, int vec16,
                     uint64_t* __restrict__ out) {
  const long long k = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (k >= n_idx) return;
  const long long c0 = idx[k] * chunk_bytes;
  const long long len = min(chunk_bytes, nbytes - c0);
  const long long n_blocks = len > 0 ? (len + 127) / 128 : 1;
  const uint8_t* p = data + c0;
  uint64_t h[8] = {kIV0 ^ kParam0, kIV1, kIV2, kIV3,
                   kIV4, kIV5, kIV6, kIV7};
  uint64_t next[16];
  load_block(p, min(len, 128LL), vec16, next);
  for (long long b = 0; b < n_blocks; ++b) {
    uint64_t m[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = next[w];
    const long long end = min((b + 1) * 128, len);
    if (b + 1 < n_blocks) {
      load_block(p + 128 * (b + 1), min(len - 128 * (b + 1), 128LL), vec16,
                 next);
    }
    compress(h, m, static_cast<uint64_t>(end), b + 1 == n_blocks);
  }
  out[2 * k] = h[0];
  out[2 * k + 1] = h[1];
}

}  // namespace kishu

// data: the bytes (nbytes > 0); idx: int64 [n_idx] chunk indices, each
// below the chunk count; out: [n_idx, 16] bytes, 8-byte aligned.
KISHU_API int kishu_chunk_key(const void* data, long long nbytes,
                              long long chunk_bytes, const void* idx,
                              long long n_idx, void* out, void* stream) {
  if (n_idx <= 0) return 0;
  const auto addr = reinterpret_cast<uintptr_t>(data);
  const int vec16 = (addr % 16 == 0) && (chunk_bytes % 16 == 0);
  const long long blocks = (n_idx + kishu::kKeyThreads - 1)
                           / kishu::kKeyThreads;
  kishu::chunk_key_kernel<<<static_cast<unsigned>(blocks),
                            kishu::kKeyThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, chunk_bytes,
      static_cast<const long long*>(idx), n_idx, vec16,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
