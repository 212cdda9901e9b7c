// patch_scatter — land K fetched chunks in a live tensor's storage in place.
//
// Replaces the TPU kernel src/repro/kernels/patch_scatter/kernel.py
// (_scatter_kernel, pallas_call in patch_scatter_pallas), which routes each
// (1, W) row to block idx[k] through a scalar-prefetch BlockSpec and keeps
// untouched chunks by aliasing its output to its input.
//
// What bounds it on an H100: bytes — each dirty chunk is read once from
// the uploaded rows and written once into the tensor, 2 * K * chunk_bytes
// over 3.35 TB/s.
//
// Design: torch tensors are mutable, so the kernel writes straight into
// the live storage (no aliasing or donation needed) and views of it stay
// valid.  Block b copies part (b % splits) of row (b / splits), 16-byte
// vectors where the destination is 16-byte aligned (checked on the host),
// bytes otherwise; the ragged last chunk is cut at nbytes, so nothing is
// ever written past the tensor's bytes.  Chunk indices are checked on the
// host before the launch.
#include "common.cuh"

namespace kishu {

__global__ void scatter_kernel(uint8_t* __restrict__ dst, long long nbytes,
                               long long chunk_bytes, int splits, int vec16,
                               const int* __restrict__ idx,
                               const uint8_t* __restrict__ rows) {
  const long long k = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const long long c0 = static_cast<long long>(idx[k]) * chunk_bytes;
  const long long cn = min(chunk_bytes, nbytes - c0);
  const long long per = ((chunk_bytes + splits - 1) / splits + 15) & ~15LL;
  const long long b0 = part * per, b1 = min(b0 + per, cn);
  uint8_t* d = dst + c0;
  const uint8_t* s = rows + k * chunk_bytes;
  long long q_end = b0;
  if (vec16 && b1 > b0) {
    q_end = b0 + ((b1 - b0) & ~15LL);
    for (long long b = b0 + 16LL * threadIdx.x; b < q_end;
         b += 16LL * blockDim.x) {
      *reinterpret_cast<uint4*>(d + b) =
          *reinterpret_cast<const uint4*>(s + b);
    }
  }
  for (long long b = q_end + threadIdx.x; b < b1; b += blockDim.x) {
    d[b] = s[b];
  }
}

}  // namespace kishu

// dst: the tensor's bytes; idx: int32 [k] chunk indices in range;
// rows: uint32 [k, chunk_bytes / 4] (row r holds chunk idx[r]'s bytes).
KISHU_API int kishu_patch_scatter(void* dst, long long nbytes,
                                  long long chunk_bytes, int splits,
                                  const void* idx, long long k,
                                  const void* rows, void* stream) {
  const auto daddr = reinterpret_cast<uintptr_t>(dst);
  const auto raddr = reinterpret_cast<uintptr_t>(rows);
  const int vec16 = (daddr % 16 == 0) && (raddr % 16 == 0)
                    && (chunk_bytes % 16 == 0);
  kishu::scatter_kernel<<<static_cast<unsigned>(k * splits), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(dst), nbytes, chunk_bytes, splits, vec16,
      static_cast<const int*>(idx), static_cast<const uint8_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}
