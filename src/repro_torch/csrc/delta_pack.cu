// delta_pack — fused hash + diff + ordered compaction of dirty chunks.
//
// Replaces the TPU kernel src/repro/kernels/delta_pack/kernel.py
// (_delta_pack_kernel, pallas_call in delta_pack_pallas).  That kernel
// appends each dirty chunk at a running counter kept in SMEM, which is
// legal only because the TPU grid runs in order.  CUDA blocks run in no
// order, so the compaction here is a flag pass, an exclusive scan and a
// gather — rows land in ascending chunk order, exactly as the plain
// version's stable argsort puts them (an atomicAdd counter would reorder
// rows and break the byte-identity of the stored frames).
//
// What bounds it on an H100: the hash pass is the chunk_hash kernel's
// (near the bandwidth / integer-rate balance point); the gather moves the
// dirty bytes twice (read + write), so the whole call is bytes-bound at
// nbytes + 2 * dirty_bytes over 3.35 TB/s.
//
// Two entry points, because the host must learn the dirty count (and the
// hashes — 12 bytes per chunk, which the session needs anyway) before it
// allocates the compacted buffer:
//  1. kishu_delta_pack_scan: split-chunk hash (atomicXor partials), a
//     finalize + diff pass that writes the dirty flags, and a single-block
//     scan giving each dirty chunk its row (-1 when clean) and the count;
//  2. kishu_delta_pack_gather: each dirty chunk's words copied to its row,
//     16-byte vectors where aligned, zero fill past the true byte length.
#include "common.cuh"

namespace kishu {

__global__ void finalize_diff_kernel(long long nbytes, long long chunk_bytes,
                                     long long n_chunks,
                                     uint32_t* __restrict__ hashes,
                                     const uint32_t* __restrict__ prev,
                                     int* __restrict__ dirty) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n_chunks) return;
  const uint32_t cn =
      static_cast<uint32_t>(min(chunk_bytes, nbytes - i * chunk_bytes));
  const uint32_t h0 = finalize(hashes[2 * i], cn);
  const uint32_t h1 = finalize(hashes[2 * i + 1], cn);
  hashes[2 * i] = h0;
  hashes[2 * i + 1] = h1;
  dirty[i] = (h0 != prev[2 * i]) || (h1 != prev[2 * i + 1]);
}

__global__ void gather_kernel(const uint8_t* __restrict__ data,
                              long long nbytes, long long chunk_bytes,
                              int splits, int vec16, int aligned4,
                              const int* __restrict__ pos,
                              uint32_t* __restrict__ buf) {
  const long long chunk = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const int row = pos[chunk];
  if (row < 0) return;
  const long long c0 = chunk * chunk_bytes;
  const long long cn = min(chunk_bytes, nbytes - c0);
  const long long wpc = chunk_bytes / 4, n_full = cn / 4;
  const long long per = ((wpc + splits - 1) / splits + 3) & ~3LL;
  const long long w0 = part * per, w1 = min(w0 + per, wpc);
  const uint8_t* p = data + c0;
  uint32_t* dst = buf + static_cast<long long>(row) * wpc;
  long long q_end = w0;
  if (vec16) {
    const long long lim = min(w1, n_full);
    if (lim > w0) q_end = w0 + ((lim - w0) & ~3LL);
    for (long long w = w0 + 4LL * threadIdx.x; w < q_end;
         w += 4LL * blockDim.x) {
      *reinterpret_cast<uint4*>(dst + w) =
          *reinterpret_cast<const uint4*>(p + 4 * w);
    }
  }
  for (long long w = q_end + threadIdx.x; w < w1; w += blockDim.x) {
    dst[w] = load_word(p, cn, w, aligned4);     // zero past the true length
  }
}

}  // namespace kishu

// prev: uint32 [n, 2]; hashes: uint32 [n, 2] zeroed; dirty, pos: int32 [n];
// count: int32 [1].
KISHU_API int kishu_delta_pack_scan(const void* data, long long nbytes,
                                    long long chunk_bytes, int splits,
                                    const void* prev, void* hashes,
                                    void* dirty, void* pos, void* count,
                                    void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const auto addr = reinterpret_cast<uintptr_t>(data);
  const int vec16 = (addr % 16 == 0) && (chunk_bytes % 16 == 0);
  const int aligned4 = addr % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* h = static_cast<uint32_t*>(hashes);
  auto* d = static_cast<int*>(dirty);
  kishu::hash_partial_kernel<<<static_cast<unsigned>(n_chunks * splits), 256,
                               0, s>>>(static_cast<const uint8_t*>(data),
                                       nbytes, chunk_bytes, splits, vec16,
                                       aligned4, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kishu::finalize_diff_kernel<<<static_cast<unsigned>((n_chunks + 255) / 256),
                                256, 0, s>>>(
      nbytes, chunk_bytes, n_chunks, h, static_cast<const uint32_t*>(prev), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kishu::scan_kernel<<<1, 1024, 0, s>>>(d, static_cast<int*>(pos), n_chunks,
                                        static_cast<int*>(count), 1);
  return static_cast<int>(cudaGetLastError());
}

// pos: int32 [n] from the scan; buf: uint32 [count, chunk_bytes / 4].
KISHU_API int kishu_delta_pack_gather(const void* data, long long nbytes,
                                      long long chunk_bytes, int splits,
                                      const void* pos, void* buf,
                                      void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const auto addr = reinterpret_cast<uintptr_t>(data);
  const auto baddr = reinterpret_cast<uintptr_t>(buf);
  const int vec16 = (addr % 16 == 0) && (baddr % 16 == 0)
                    && (chunk_bytes % 16 == 0);
  const int aligned4 = addr % 4 == 0;
  kishu::gather_kernel<<<static_cast<unsigned>(n_chunks * splits), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, chunk_bytes, splits, vec16,
      aligned4, static_cast<const int*>(pos), static_cast<uint32_t*>(buf));
  return static_cast<int>(cudaGetLastError());
}
