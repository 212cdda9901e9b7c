// Shared device helpers of the port's kernels: the detection-hash
// arithmetic (the spec is repro_torch/core/hashing.py), byte-exact word
// loads, block reductions and a single-block ordered scan.
//
// Every kernel is compiled for sm_90a by nvcc into its own shared library
// with a plain C interface (see repro_torch/kernels/_lib.py).  Each C entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KISHU_API extern "C" __attribute__((visibility("default")))

namespace kishu {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kSeed1 = 0x517CC1B7u;   // lane 1 seed; lane 0 seeds 0
constexpr unsigned kFull = 0xFFFFFFFFu;

// Little-endian uint32 word `w` of a byte range of `len` bytes at `p`,
// zero-filled past `len`: the packing chunk_hash/ops.py:_to_words gives
// 1- and 2-byte dtypes.  Never reads a byte at or past `len`.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, long long len,
                                              long long w, bool aligned4) {
  const long long off = 4 * w;
  if (aligned4 && off + 4 <= len) {
    return *reinterpret_cast<const uint32_t*>(p + off);
  }
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    if (off + b < len) v |= static_cast<uint32_t>(p[off + b]) << (8 * b);
  }
  return v;
}

// Avalanche mix of one word with its seeded position (all arithmetic is
// uint32, so wrap-around mod 2^32 is defined and matches numpy's).
__device__ __forceinline__ uint32_t mix(uint32_t w, uint32_t pos_seeded) {
  uint32_t m = (w ^ pos_seeded) * kC1;
  m ^= m >> 16;
  m *= kC2;
  m ^= m >> 13;
  return m;
}

__device__ __forceinline__ void mix2(uint32_t w, uint32_t idx, uint32_t& h0,
                                     uint32_t& h1) {
  const uint32_t p = idx * kGolden;
  h0 ^= mix(w, p);
  h1 ^= mix(w, p + kSeed1);
}

__device__ __forceinline__ uint32_t finalize(uint32_t h, uint32_t nbytes) {
  h = (h ^ nbytes) * kC1;
  return h ^ (h >> 16);
}

// XOR of `v` over the block (blockDim.x a multiple of 32); the result is
// valid in thread 0.  `smem` holds 32 words.
__device__ __forceinline__ uint32_t block_xor(uint32_t v, uint32_t* smem) {
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // smem may hold a previous result
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? smem[threadIdx.x] : 0u;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(kFull, v, o);
  }
  return v;
}

// Partial detection hash of words [w0, w1) of one chunk: block b hashes
// part (b % splits) of chunk (b / splits) and XORs its two lanes into
// `out` (zeroed by the caller).  XOR is associative, so the parts combine
// in any order and the result is bit-identical to a sequential pass.
__global__ void hash_partial_kernel(const uint8_t* __restrict__ data,
                                    long long nbytes, long long chunk_bytes,
                                    int splits, int vec16, int aligned4,
                                    uint32_t* __restrict__ out) {
  __shared__ uint32_t smem[32];
  const long long chunk = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const long long c0 = chunk * chunk_bytes;
  const long long cn = min(chunk_bytes, nbytes - c0);
  const long long n_valid = (cn + 3) / 4, n_full = cn / 4;
  const long long wpc = chunk_bytes / 4;
  const long long per = ((wpc + splits - 1) / splits + 3) & ~3LL;
  const long long w0 = part * per, w1 = min(w0 + per, n_valid);
  const uint8_t* p = data + c0;
  uint32_t h0 = 0, h1 = 0;
  long long q_end = w0;
  if (vec16) {
    const long long lim = min(w1, n_full);
    if (lim > w0) q_end = w0 + ((lim - w0) & ~3LL);
    for (long long w = w0 + 4LL * threadIdx.x; w < q_end;
         w += 4LL * blockDim.x) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * w);
      const uint32_t i = static_cast<uint32_t>(w);
      mix2(v.x, i, h0, h1);
      mix2(v.y, i + 1, h0, h1);
      mix2(v.z, i + 2, h0, h1);
      mix2(v.w, i + 3, h0, h1);
    }
  }
  for (long long w = q_end + threadIdx.x; w < w1; w += blockDim.x) {
    mix2(load_word(p, cn, w, aligned4), static_cast<uint32_t>(w), h0, h1);
  }
  h0 = block_xor(h0, smem);
  h1 = block_xor(h1, smem);
  if (threadIdx.x == 0 && w0 < w1) {
    atomicXor(out + 2 * chunk, h0);
    atomicXor(out + 2 * chunk + 1, h1);
  }
}

// Exclusive scan of in[0, n) into out[0, n) by ONE block (blockDim.x a
// multiple of 32, at most 1024), tile by tile with a carried total, so
// the order is the index order whatever the grid did before.  With
// flag_mode, out[i] is -1 where in[i] is 0.  In place (in == out) is safe:
// each thread reads its element before it writes it.  *total gets the sum.
__global__ void scan_kernel(const int* in, int* out, long long n, int* total,
                            int flag_mode) {
  __shared__ int warp_sums[32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const int v = (i < n) ? in[i] : 0;
    int x = v;                                   // inclusive warp scan
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = (lane < n_warps) ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;                       // inclusive over warps
    }
    __syncthreads();
    const int excl = carry_s + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n) out[i] = (flag_mode && v == 0) ? -1 : excl;
    __syncthreads();                             // everyone has read carry_s
    if (threadIdx.x == blockDim.x - 1) carry_s = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry_s;
}

}  // namespace kishu

KISHU_API const char* kishu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
