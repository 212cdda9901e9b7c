// chunk_hash — per-chunk 2x32-bit detection hash of a tensor's bytes.
//
// Replaces the TPU kernel src/repro/kernels/chunk_hash/kernel.py
// (_chunk_hash_kernel, pallas_call in chunk_hash_pallas), which streams one
// padded chunk per grid step and XOR-tree-reduces it in VMEM.
//
// What bounds it on an H100: about 17 integer operations per 4-byte word
// (two seeded mix chains plus the XOR), so 4 bytes at 3.35 TB/s against
// 17 ops at the card's ~16.7 T int32 op/s put it near the balance point of
// bandwidth and integer issue rate (both datasheet reckonings).
//
// Design:
//  - no padding copy: the kernel reads the tensor's storage in place, given
//    its byte length, masks the ragged last chunk and packs a partial last
//    word little-endian with zero fill, and never reads past nbytes;
//  - 16-byte vector loads where the base is 16-byte aligned (checked on the
//    host), scalar loads otherwise — never a silent misaligned access;
//  - a 1 MiB chunk is 262,144 words, so one block per chunk would leave
//    most of the 132 SMs idle on small tensors: each chunk is split over
//    `splits` blocks whose partial lanes are combined with atomicXor into a
//    zeroed buffer (XOR is associative), then one small pass folds in the
//    byte length.
#include "common.cuh"

namespace kishu {

__global__ void hash_finalize_kernel(long long nbytes, long long chunk_bytes,
                                     long long n_chunks,
                                     uint32_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n_chunks) return;
  const uint32_t cn =
      static_cast<uint32_t>(min(chunk_bytes, nbytes - i * chunk_bytes));
  out[2 * i] = finalize(out[2 * i], cn);
  out[2 * i + 1] = finalize(out[2 * i + 1], cn);
}

}  // namespace kishu

// data: the tensor's bytes (nbytes > 0); out: uint32 [n_chunks, 2], zeroed.
KISHU_API int kishu_chunk_hash(const void* data, long long nbytes,
                               long long chunk_bytes, int splits, void* out,
                               void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const auto addr = reinterpret_cast<uintptr_t>(data);
  const int vec16 = (addr % 16 == 0) && (chunk_bytes % 16 == 0);
  const int aligned4 = addr % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  kishu::hash_partial_kernel<<<static_cast<unsigned>(n_chunks * splits), 256,
                               0, s>>>(static_cast<const uint8_t*>(data),
                                       nbytes, chunk_bytes, splits, vec16,
                                       aligned4, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kishu::hash_finalize_kernel<<<static_cast<unsigned>((n_chunks + 255) / 256),
                                256, 0, s>>>(nbytes, chunk_bytes, n_chunks,
                                             o);
  return static_cast<int>(cudaGetLastError());
}
