// delta_codec — on-device bit-plane encode of compacted dirty rows, in one
// pass.
//
// Replaces the TPU kernel src/repro/kernels/delta_codec/kernel.py
// (_codec_encode_kernel, pallas_call in codec_encode_pallas), which
// transposes each group of gw words into 32 bit-planes with shift +
// OR-trees and appends stored planes at an SMEM running counter — legal
// only because the TPU grid runs in order.
//
// What bounds it on an H100: bytes — one read of the rows and one write of
// the masks and the stored planes.  The earlier design of this file was
// bound by instructions instead: 32 ballots and 32 selects per word, the
// rows read twice (a classify and an emit kernel), a serial single-block
// scan between them, and a host read-back of the plane count to size the
// output.  This design spends about 17 warp-instructions per 32 words and
// reads each word once.
//
// Design:
//  - a warp encodes a group at a time (kGroupsPerWarp of them, one after
//    another, so that a full-size call fits the card in one wave of CTAs):
//    lane k loads word j*32+k for j = 0..pw-1 (pw = gw/32), one 128-byte
//    coalesced load per j, and keeps all pw words in registers;
//  - a 32 x 32 bit transpose in five __shfl_xor_sync butterfly stages
//    (host.transpose32's stages, with lanes in place of rows) leaves plane
//    p's word j in lane p; each lane ORs and ANDs its plane over j, and two
//    ballots give the group's (stored_mask, ones_mask);
//  - ordered compaction in the same launch: a CTA encodes a tile of
//    kTileGroups consecutive groups, scans its warps' stored-plane counts
//    in shared memory, and finds the tile's first plane by a chained scan
//    with decoupled look-back over the tiles before it.  Tiles take their
//    index from an atomic ticket, so look-back only waits on tiles already
//    running.  No memset before the launch: the ticket shares a 64-bit
//    word with a call epoch, so one atomicAdd hands a CTA both, and the CTA
//    of the last ticket sets the word to (epoch + 1, ticket 0) for the next
//    call.  Each tile status carries its call's tag (epoch + 1), so the
//    statuses a previous call left count as not yet published, and the
//    scratch is zeroed once, when it is allocated, not by a memset node in
//    every call (tags repeat only after 2^32 calls on one scratch);
//  - each warp stages its stored planes in shared memory (row stride pw+1
//    words, so lanes writing word j of their rows hit distinct banks) and
//    writes them as whole rows of pw words, coalesced, at the tile's first
//    plane plus the warp's offset: (group, plane) order, byte-identical to
//    host.bitplane_compress.  The last tile writes the total count.
#include "common.cuh"

#include <climits>

namespace kishu {
namespace codec {

constexpr int kTileGroups = 8;                    // groups a CTA encodes
constexpr int kGroupsPerWarp = 2;   // groups a warp encodes, one after another
constexpr int kWarps = kTileGroups / kGroupsPerWarp;
// a tile status: the call's tag << 32 | prefix flag << 31 | stored planes
// (the tile's own, or with the prefix flag all through the tile)
constexpr unsigned long long kPrefixFlag = 1ull << 31;
constexpr unsigned long long kValueMask = kPrefixFlag - 1;

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Stage (J, M) of the butterfly: lanes r and r ^ J swap the J x J bit
// blocks off the diagonal.  The lower lane (r & J == 0) takes bits M << J
// from its partner shifted up, the upper lane bits M shifted down.
template <int J, uint32_t M>
__device__ __forceinline__ uint32_t butterfly(uint32_t v, int lane) {
  const uint32_t x = __shfl_xor_sync(kFull, v, J);
  const bool upper = lane & J;
  const uint32_t take = upper ? M : (M << J);
  // the partner's word rotated left by J (lower lane) or right by J (upper
  // lane) has the bits to take in place; the bits that wrap around fall
  // outside `take`
  const uint32_t y = __funnelshift_l(x, x, upper ? 32 - J : J);
  return (v & ~take) | (y & take);
}

// Lane c holds a[c]; returns b[lane] with bit c of b[p] = bit p of a[c].
__device__ __forceinline__ uint32_t transpose_lane(uint32_t v, int lane) {
  v = butterfly<16, 0x0000FFFFu>(v, lane);
  v = butterfly<8, 0x00FF00FFu>(v, lane);
  v = butterfly<4, 0x0F0F0F0Fu>(v, lane);
  v = butterfly<2, 0x33333333u>(v, lane);
  return butterfly<1, 0x55555555u>(v, lane);
}

// Stored planes of all tiles before `tile`, by warp 0 of the CTA: lanes
// read the statuses of 32 predecessors at once, wait until each carries
// this call's tag, and sum back to the nearest one that holds a prefix.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         long long tile, unsigned tag,
                                         int lane) {
  int excl = 0;
  for (long long look = tile - 1;; look -= 32) {
    const long long idx = look - lane;
    const unsigned long long none = (static_cast<unsigned long long>(tag)
                                     << 32) | kPrefixFlag;
    unsigned long long s = idx >= 0 ? load_relaxed(status + idx) : none;
    while (__any_sync(kFull, (s >> 32) != tag)) {
      if ((s >> 32) != tag) s = load_relaxed(status + idx);
    }
    const unsigned prefix = __ballot_sync(kFull, (s & kPrefixFlag) != 0);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & kValueMask) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (prefix) return excl;
  }
}

template <int PW>
__global__ void __launch_bounds__(kWarps * 32)
encode_kernel(const uint32_t* __restrict__ rows, long long n_groups,
              long long n_tiles, uint2* __restrict__ masks,
              int* __restrict__ count, uint32_t* __restrict__ planes,
              unsigned long long* __restrict__ control,
              unsigned long long* __restrict__ status) {
  // a warp's stored planes, row after row in (group, plane) order, each
  // row padded to pw + 1 words
  __shared__ uint32_t stage[kWarps][kGroupsPerWarp * 32 * (PW + 1)];
  __shared__ int warp_off[kWarps];
  __shared__ unsigned long long ticket_s;
  __shared__ int base_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(control, 1ull);  // epoch | ticket
    if ((t & 0xFFFFFFFFu) == n_tiles - 1) {      // the last ticket: reset it
      store_relaxed(control, ((t >> 32) + 1) << 32);  // for the next call
    }
    ticket_s = t;
  }
  __syncthreads();
  const long long tile = ticket_s & 0xFFFFFFFFu;
  const unsigned tag = static_cast<unsigned>(ticket_s >> 32) + 1u;
  const unsigned long long tagged = static_cast<unsigned long long>(tag)
                                    << 32;
  int mine = 0;                                  // this warp's stored planes
#pragma unroll 1
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const long long g = tile * kTileGroups
        + static_cast<long long>(warp) * kGroupsPerWarp + i;
    if (g >= n_groups) break;                    // uniform over the warp
    const uint32_t* src = rows + g * (32LL * PW) + lane;
    uint32_t v[PW];
#pragma unroll
    for (int j = 0; j < PW; ++j) v[j] = __ldg(src + 32 * j);
    uint32_t any = 0u, all = kFull;
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      v[j] = transpose_lane(v[j], lane);
      any |= v[j];
      all &= v[j];
    }
    const bool ones = all == kFull;
    const bool store = !ones && any != 0u;
    const uint32_t smask = __ballot_sync(kFull, store);
    const uint32_t omask = __ballot_sync(kFull, ones);
    if (lane == 0) masks[g] = make_uint2(smask, omask);
    if (store) {
      const int row = mine + __popc(smask & ((1u << lane) - 1u));
#pragma unroll
      for (int j = 0; j < PW; ++j) stage[warp][row * (PW + 1) + j] = v[j];
    }
    mine += __popc(smask);
  }
  if (lane == 0) warp_off[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kWarps ? warp_off[lane] : 0;
    int incl = own;                              // scan of the warps' counts
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, kWarps - 1);
    if (lane < kWarps) warp_off[lane] = incl - own;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_relaxed(status, tagged | kPrefixFlag | total);
    } else {
      if (lane == 0) store_relaxed(status + tile, tagged | total);
      excl = look_back(status, tile, tag, lane);
      if (lane == 0) {
        store_relaxed(status + tile, tagged | kPrefixFlag | (excl + total));
      }
    }
    if (lane == 0) {
      base_s = excl;
      if (tile == n_tiles - 1) *count = excl + total;
    }
  }
  __syncthreads();
  if (mine != 0) {                               // uniform over the warp
    uint32_t* dst =
        planes + static_cast<long long>(base_s + warp_off[warp]) * PW;
    const int n = mine * PW;
    for (int i = lane; i < n; i += 32) {
      dst[i] = stage[warp][(i / PW) * (PW + 1) + i % PW];
    }
  }
}

template <int PW>
cudaError_t launch(const void* rows, long long n_groups, long long n_tiles,
                   void* masks, void* count, void* planes, void* status,
                   cudaStream_t s) {
  encode_kernel<PW><<<static_cast<unsigned>(n_tiles), kWarps * 32, 0, s>>>(
      static_cast<const uint32_t*>(rows), n_groups, n_tiles,
      static_cast<uint2*>(masks), static_cast<int*>(count),
      static_cast<uint32_t*>(planes), static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(status) + 1);
  return cudaGetLastError();
}

}  // namespace codec
}  // namespace kishu

// rows: uint32 [n_groups * gw]; gw a power of two in [32, 1024].
// masks: uint32 [n_groups, 2] (stored_mask, ones_mask); count: int32 [1]
// (stored planes); planes: uint32 [n_groups * 32, gw / 32], the stored
// planes at the front (rows past count are left as they were).
// status: status_words >= ceil(n_groups / 8) + 1 eight-byte words of
// scratch, zeroed before its first call and left to the kernel after it:
// calls that share it must run one after another (one stream).
KISHU_API int kishu_codec_encode(const void* rows, long long n_groups, int gw,
                                 void* masks, void* count, void* planes,
                                 void* status, long long status_words,
                                 void* stream) {
  using namespace kishu::codec;
  const long long n_tiles = (n_groups + kTileGroups - 1) / kTileGroups;
  if (n_groups <= 0 || n_groups > INT_MAX / 32 || status_words < n_tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = launch<1>;
  switch (gw) {
    case 32: run = launch<1>; break;
    case 64: run = launch<2>; break;
    case 128: run = launch<4>; break;
    case 256: run = launch<8>; break;
    case 512: run = launch<16>; break;
    case 1024: run = launch<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(run(rows, n_groups, n_tiles, masks, count, planes,
                              status, static_cast<cudaStream_t>(stream)));
}
