// delta_codec — on-device bit-plane encode of compacted dirty rows.
//
// Replaces the TPU kernel src/repro/kernels/delta_codec/kernel.py
// (_codec_encode_kernel, pallas_call in codec_encode_pallas), which
// transposes each group of gw words into 32 bit-planes with shift +
// OR-trees and appends stored planes at an SMEM running counter — legal
// only because the TPU grid runs in order.
//
// What bounds it on an H100: this design is bound by instructions.  Each
// word costs 32 ballots (one per plane) plus selects in its warp, against 4
// bytes read, and the rows are read twice.  The function itself needs far
// less: a 5-stage butterfly transpose (about 15 integer ops per word) plus
// the zero/ones classify (2 per word), which puts its least time at the
// bytes of one read of the rows and one write of masks and stored planes.
// The bound chip_smoke.py prints is that function bound, not this
// kernel's own op count, so the gap to it is this design's cost.
//
// Design:
//  - one block per group, one word per thread: a warp holds 32 consecutive
//    words, so __ballot_sync(~0u, (w >> p) & 1) is exactly plane p's bitmap
//    word with bit k taken from word k ("lane k carries bit k"), and lane p
//    keeps plane p's word;
//  - a plane is all-zero / all-one when the OR / AND of its words over the
//    block's warps (shared atomics) is 0 / ~0;
//  - ordered compaction without a sequential grid: a classify pass writes
//    (stored_mask, ones_mask) and popcount(stored_mask) per group, a
//    single-block exclusive scan turns the counts into offsets, and an
//    emit pass recomputes the ballots and writes each stored plane at
//    offset[g] + rank of p among the group's stored planes — (group, plane)
//    order, byte-identical to host.bitplane_compress.  Reading the rows
//    twice is cheaper than writing and re-reading all 32 planes.
#include "common.cuh"

namespace kishu {

__device__ __forceinline__ uint32_t plane_word(uint32_t w, int lane) {
  uint32_t mine = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const uint32_t b = __ballot_sync(kFull, (w >> p) & 1u);
    if (lane == p) mine = b;
  }
  return mine;
}

__global__ void classify_kernel(const uint32_t* __restrict__ rows, int gw,
                                uint32_t* __restrict__ masks,
                                int* __restrict__ counts) {
  __shared__ uint32_t s_or[32], s_and[32];
  const long long g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  if (t < 32) {
    s_or[t] = 0u;
    s_and[t] = kFull;
  }
  __syncthreads();
  const uint32_t mine = plane_word(rows[g * gw + t], lane);
  atomicOr(&s_or[lane], mine);
  atomicAnd(&s_and[lane], mine);
  __syncthreads();
  if (t < 32) {
    const bool ones = s_and[t] == kFull;
    const bool store = !ones && s_or[t] != 0u;
    const uint32_t sm = __ballot_sync(kFull, store);
    const uint32_t om = __ballot_sync(kFull, ones);
    if (t == 0) {
      masks[2 * g] = sm;
      masks[2 * g + 1] = om;
      counts[g] = __popc(sm);
    }
  }
}

__global__ void emit_kernel(const uint32_t* __restrict__ rows, int gw,
                            const uint32_t* __restrict__ masks,
                            const int* __restrict__ offsets,
                            uint32_t* __restrict__ planes) {
  const long long g = blockIdx.x;
  const uint32_t sm = masks[2 * g];
  if (sm == 0u) return;                  // uniform over the block
  const int t = threadIdx.x, lane = t & 31, j = t >> 5, pw = gw >> 5;
  const uint32_t mine = plane_word(rows[g * gw + t], lane);
  if ((sm >> lane) & 1u) {
    const int rank = __popc(sm & ((1u << lane) - 1u));
    planes[(static_cast<long long>(offsets[g]) + rank) * pw + j] = mine;
  }
}

}  // namespace kishu

// rows: uint32 [n_groups * gw]; masks: uint32 [n_groups, 2];
// offsets: int32 [n_groups] (exclusive plane offsets on return);
// total: int32 [1] (stored planes).  gw: a power of two in [32, 1024].
KISHU_API int kishu_codec_classify(const void* rows, long long n_groups,
                                   int gw, void* masks, void* offsets,
                                   void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* off = static_cast<int*>(offsets);
  kishu::classify_kernel<<<static_cast<unsigned>(n_groups), gw, 0, s>>>(
      static_cast<const uint32_t*>(rows), gw, static_cast<uint32_t*>(masks),
      off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kishu::scan_kernel<<<1, 1024, 0, s>>>(off, off, n_groups,
                                        static_cast<int*>(total), 0);
  return static_cast<int>(cudaGetLastError());
}

// planes: uint32 [total, gw / 32].
KISHU_API int kishu_codec_emit(const void* rows, long long n_groups, int gw,
                               const void* masks, const void* offsets,
                               void* planes, void* stream) {
  kishu::emit_kernel<<<static_cast<unsigned>(n_groups), gw, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), gw,
      static_cast<const uint32_t*>(masks), static_cast<const int*>(offsets),
      static_cast<uint32_t*>(planes));
  return static_cast<int>(cudaGetLastError());
}
