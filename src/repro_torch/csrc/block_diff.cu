// block_diff — exact per-chunk "do these two buffers differ" flags.
//
// Replaces the TPU kernel src/repro/kernels/block_diff/kernel.py
// (_block_diff_kernel, pallas_call in block_diff_pallas), which streams one
// zero-padded (1, W) uint32 row of each input per grid step and writes
// max(a != b) as one int32.
//
// What bounds it on an H100: bytes.  Both inputs are read once (2 x nbytes)
// and 4 bytes per chunk are written, against one XOR and one OR per loaded
// word, so 3.35 TB/s of HBM is the limit, far below the integer issue rate.
//
// Design:
//  - no padding copy: the kernel reads both tensors' storage in place,
//    given their common byte length; a ragged last chunk compares only its
//    true bytes, which is what zero padding on both sides computes;
//  - a 1 MiB chunk is split over `splits` blocks (the same splitting as
//    chunk_hash), each block ORs its "differs" bit with __syncthreads_or and
//    one thread per block atomicOr's it into the chunk's zeroed flag;
//  - 16-byte vector loads only when both bases are 16-byte aligned, 4-byte
//    loads when both are 4-byte aligned, bytewise otherwise — never a
//    misaligned access, never a read at or past nbytes.
#include "common.cuh"

namespace kishu {

__global__ void block_diff_kernel(const uint8_t* __restrict__ a,
                                  const uint8_t* __restrict__ b,
                                  long long nbytes, long long chunk_bytes,
                                  int splits, int align,
                                  int* __restrict__ flags) {
  const long long chunk = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const long long c0 = chunk * chunk_bytes;
  const long long cn = min(chunk_bytes, nbytes - c0);
  const long long per = ((chunk_bytes + splits - 1) / splits + 15) & ~15LL;
  const long long lo = part * per, hi = min(lo + per, cn);
  const uint8_t* pa = a + c0;
  const uint8_t* pb = b + c0;
  uint32_t diff = 0;
  long long done = lo;
  if (lo < hi && align >= 16) {
    const long long n16 = (hi - lo) / 16;
    const uint4* va = reinterpret_cast<const uint4*>(pa + lo);
    const uint4* vb = reinterpret_cast<const uint4*>(pb + lo);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 x = va[i], y = vb[i];
      diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
    }
    done = lo + 16 * n16;
  } else if (lo < hi && align >= 4) {
    const long long n4 = (hi - lo) / 4;
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(pa + lo);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(pb + lo);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      diff |= wa[i] ^ wb[i];
    }
    done = lo + 4 * n4;
  }
  for (long long i = done + threadIdx.x; i < hi; i += blockDim.x) {
    diff |= static_cast<uint32_t>(pa[i] ^ pb[i]);
  }
  // every thread of the block reaches this barrier (no early return)
  if (__syncthreads_or(diff != 0) && threadIdx.x == 0) {
    atomicOr(flags + chunk, 1);
  }
}

}  // namespace kishu

// a, b: two buffers of nbytes (> 0) bytes each; flags: int32 [n_chunks],
// zeroed by the caller; any chunk_bytes > 0.
KISHU_API int kishu_block_diff(const void* a, const void* b, long long nbytes,
                               long long chunk_bytes, int splits, void* flags,
                               void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const auto pa = reinterpret_cast<uintptr_t>(a);
  const auto pb = reinterpret_cast<uintptr_t>(b);
  // part offsets are multiples of 16 and chunk offsets are multiples of
  // chunk_bytes, so the alignment that the bases and chunk_bytes share is
  // every block's alignment
  int align = 1;
  if (pa % 16 == 0 && pb % 16 == 0 && chunk_bytes % 16 == 0) {
    align = 16;
  } else if (pa % 4 == 0 && pb % 4 == 0 && chunk_bytes % 4 == 0) {
    align = 4;
  }
  kishu::block_diff_kernel<<<static_cast<unsigned>(n_chunks * splits), 256,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), nbytes,
      chunk_bytes, splits, align, static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}
