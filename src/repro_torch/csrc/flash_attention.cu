// flash_attention — tiled softmax attention, forward only (prefill).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, pallas_call in flash_attention_bhsd), which walks a
// sequential (B*Hq, S/BQ, S/BK) grid and carries the running max, the
// normalizer and the [BQ, hd] accumulator in VMEM scratch across the K
// steps.
//
// Two routes, chosen by the wrapper before the launch from dtype and
// strides (repro_torch/kernels/flash_attention/ops.py:flash_route):
//
//  - "tc" (kishu_flash_attention_tc): bf16 q, k, v that TMA can address.
//    Both products on the tensor cores (wgmma), tiles brought in by TMA
//    through a ring of mbarrier-guarded stages.  See the tc namespace.
//  - "fma" (kishu_flash_attention): float32, and bf16 in any other layout
//    (a dim stride other than 1, unaligned strides or base).  Both products
//    as float32 FMAs on the CUDA cores; described right below.
//
// What bounds it on an H100: bytes at SmolLM-360M's prefill shape (B 8,
// S 512, 15/5 heads of 64, causal): 21 MB of q, k, v and o take 6.3 us at
// 3.35 TB/s; the 4.0 GFLOP (6.0 with the tc route's hi/lo P.V) take 4-6 us
// on the bf16 tensor cores.  The fma route is bound by the 67 TFLOP/s of
// float32 FMAs instead.
//
// fma route design:
//  - one CTA of 256 threads per (query tile of 64 rows, batch * query head);
//    the K/V tiles of 64 keys are a loop inside the CTA, since CUDA blocks
//    carry nothing between them;
//  - q, k and v are read in place in their [B, S, H, hd] layout through
//    64-bit element strides (no transposed copies), converted to float32
//    and staged in shared memory; the K/V head is h / n_rep (GQA without
//    repeating K/V);
//  - scores, p and the P.V accumulator are float32 (p is never rounded to
//    the input type); online softmax with the finite -1e30 mask, p re-masked
//    to 0 where a key is invalid, the normalizer clamped at 1e-30 before the
//    one divide — the TPU kernel's arithmetic;
//  - causal: K tiles strictly above the diagonal are skipped; any S: rows
//    and keys past S are zero-filled on load, masked as keys, and never
//    written as rows;
//  - head dims up to 256, zero-padded in shared memory to 64, 128 or 256;
//  - thread (r, c) owns score rows 4r..4r+3 at keys c + 16j (j < 4), and
//    output rows 4r..4r+3 at dims 4c + 64i .. +3, so a row's running max
//    and normalizer live in the 16 lanes of one half-warp (shuffle reduce).
#include "common.cuh"

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>

namespace kishu {
namespace flash {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // kernel.py's finite NEG_INF
constexpr int kLDP = kBQ + 4;    // row of P^T in shared memory (floats)

struct Strides {
  long long b, s, h, d;          // element strides of a [B, S, H, hd] tensor
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even, as torch's cast
}

__host__ __device__ constexpr int padded_row(int hdp) { return hdp + 4; }

__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * padded_row(hdp) +
          static_cast<size_t>(kBK) * kLDP);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int S, int Hq, int n_rep,
                 int hd, float scale, int causal) {
  constexpr int LD = padded_row(HDP);   // a multiple of 4: float4-aligned
  constexpr int NV = HDP / 64;          // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;            // [kBK][LD]
  float* Vs = Ks + kBK * LD;            // [kBK][LD]
  float* Ps = Vs + kBK * LD;            // [kBK][kLDP], p transposed

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / n_rep;
  const int tid = threadIdx.x;
  const int r = tid >> 4;               // rows 4r .. 4r+3
  const int c = tid & 15;               // keys c + 16j; dims 4c + 64i

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    const int row = e / HDP, d = e % HDP, s = q0 + row;
    Qs[row * LD + d] =
        (s < S && d < hd) ? to_f32(qb[s * sq.s + d * sq.d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < 4 * NV; ++a) acc[i][a] = 0.f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  const int hd4 = (hd + 3) / 4;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // the last tile's Ks/Vs/Ps are read
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int j = e / HDP, d = e % HDP, s = k0 + j;
      const bool in = s < S && d < hd;
      Ks[j * LD + d] = in ? to_f32(kb[s * sk.s + d * sk.d]) : 0.f;
      Vs[j * LD + d] = in ? to_f32(vb[s * sv.s + d * sv.d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int dq = 0; dq < hd4; ++dq) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * r + i) * LD +
                                                     4 * dq]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(c + 16 * j) * LD +
                                                     4 * dq]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sc[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          sc[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps += p;
        Ps[(c + 16 * j) * kLDP + 4 * r + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(kFull, ps, off);
      l[i] = corr * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int a = 0; a < 4 * NV; ++a) acc[i][a] *= corr;
    }
    __syncthreads();                    // every p of the tile is in Ps

    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[j * kLDP +
                                                            4 * r]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &Vs[j * LD + 4 * c + 64 * g]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pr[i], v4.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pr[i], v4.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pr[i], v4.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pr[i], v4.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * r + i;
    if (s >= S) continue;               // rows of the ragged tile past S
    const float lv = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + s * so.s + h * so.h;
#pragma unroll
    for (int g = 0; g < NV; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * c + 64 * g + e;
        if (d < hd) orow[d * so.d] = from_f32<T>(acc[i][4 * g + e] / lv);
      }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides* st, int B, int S, int Hq, int Hkv, int hd,
                   float scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HDP>;
  const size_t smem = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * Hq));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], S, Hq, Hq / Hkv, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* o, const Strides* st, int B, int S, int Hq,
                        int Hkv, int hd, float scale, int causal,
                        cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, st, B, S, Hq, Hkv, hd, scale, causal,
                         stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, st, B, S, Hq, Hkv, hd, scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, st, B, S, Hq, Hkv, hd, scale, causal,
                        stream);
}


// ---------------------------------------------------------------------------
// The tensor-core route: bf16, sm_90a
// ---------------------------------------------------------------------------
//
// Design:
//  - a CTA owns 64 * CONS query rows of one (batch, query head): CONS
//    warpgroups of 64 rows each (wgmma's M).  The shape per head dim
//    (tc::Shape) was chosen by device time on the H100: hd 64 two CTAs of
//    two warpgroups per SM, so one's softmax runs while another's products
//    do; hd 128 one CTA of three; hd 256 one of two.  Query tiles are
//    ordered longest first;
//  - tiles are bf16 in shared memory in the 128-byte swizzled layout that
//    TMA writes and wgmma reads: blocks of [64 rows x 64 columns] (8 KB),
//    hd / 64 of them side by side for hd 128 and 256; hd < 64 is zero-filled
//    by TMA past hd.  q, k and v are read in place as 4-D tensors
//    (d, h, s, b) through their strides; keys and rows past S are
//    zero-filled by TMA;
//  - Q is loaded once per CTA; K and V go through a ring of two stages.
//    Thread 0 issues every copy: it refills a stage once every warp has
//    released it ("empty" mbarrier, one arrival per warp) and re-arms its
//    "full" mbarrier with the bytes it expects;
//  - S = Q.K^T: m64n64k16 with both operands from shared memory (K-major),
//    float32 accumulation of exact bf16 products;
//  - softmax on the accumulator fragment in registers: a row's 16 values
//    in a thread, its max over the 4 lanes of a quad (shuffles); the
//    running normalizer is kept per thread and summed over the quad once at
//    the end; the TPU kernel's arithmetic otherwise: the finite -1e30 mask,
//    p re-masked to 0, the normalizer clamped at 1e-30.  The max is kept
//    in log2 units, so a p is one FFMA and one ex2 (scale * log2(e) folded
//    into the FFMA); tiles that cross neither S nor the diagonal skip the
//    mask, and the accumulator is rescaled only when a row's max moved;
//  - O += P.V: m64n64k16 per 64 output columns with P from registers (the
//    S fragment is the A fragment: no shared-memory round trip) and V from
//    shared memory, read MN-major through the descriptor (no transposed
//    copy).  p stays float32 in effect: p = hi + lo with hi = bf16(p) and
//    lo = bf16(p - hi), two wgmmas into one accumulator, so the residual
//    is ~2^-17 relative instead of the 2^-9 of one bf16 rounding.  Causal
//    row 0 has p = 1 up to the FFMA's last bit, and its bf16 output is v[0]
//    exactly;
//  - causal: K tiles above a warpgroup's diagonal are not computed, only
//    tiles that cross the diagonal or S are masked.
namespace tc {

constexpr int kRows = 64;                 // rows per consumer warpgroup
constexpr int kBK = 64;                   // keys per K/V tile
constexpr int kStages = 2;                // K/V stages in the ring
constexpr int kBlock = 64 * 128;          // one swizzled [64 x 64] bf16 block
constexpr float kLog2e = 1.4426950408889634f;

// A kernel shape: NB column blocks of 64 (the padded head dim / 64),
// CONS consumer warpgroups (a CTA owns 64 * CONS query rows) and CTAS
// CTAs per SM.  Registers are split over the SM's four schedulers, 16384
// each, among the warps each one holds: kRegs is the cap a thread gets, a
// multiple of 8 and at most 255.  Thread 0 issues every TMA copy between
// its own tiles: a producer warp of its own would be a fifth warp on one
// scheduler and cut every thread's registers (measured slower, PERF.md).
template <int NB_, int CONS_, int CTAS_> struct Shape {
  static constexpr int NB = NB_, CONS = CONS_, CTAS = CTAS_;
  static constexpr int kBQ = kRows * CONS;        // query rows per CTA
  static constexpr int kThreads = 128 * CONS;
  static constexpr int kWarpsPerScheduler = (kThreads / 32 * CTAS + 3) / 4;
  static constexpr int kRegs =
      16384 / (32 * kWarpsPerScheduler) / 8 * 8 > 255
          ? 248
          : 16384 / (32 * kWarpsPerScheduler) / 8 * 8;
  // Q (CONS blocks per column block), K and V stages, 5 mbarriers, and
  // 1 KB of slack to align the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmem =
      static_cast<size_t>(NB) * kBlock * (CONS + 2 * kStages) + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// 8-row groups (8-key groups of the MN-major V) 1024 bytes apart, the
// stride byte offset.  The leading byte offset (between 64-column blocks
// of an MN-major operand) is not walked by an N = 64 instruction; it is
// set to 1024 too.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait (or the issue).
__device__ __forceinline__ void own(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void own(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define KISHU_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define KISHU_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A.B^T: A [64 x 16] and B [64 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KISHU_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KISHU_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B: A [64 x 16] from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KISHU_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KISHU_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef KISHU_ACC32
#undef KISHU_D32

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Issue S = Q.K^T for one warpgroup: its [64 x hd] Q block against the
// [64 keys x hd] K tile at `k_tile`, over ceil(hd / 16) k-steps.
template <class SH>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile,
                                         uint32_t k_tile, int n_k16) {
  wg_fence();
  for (int kk = 0; kk < n_k16; ++kk) {
    const uint32_t qa = q_tile + (kk / 4) * SH::CONS * kBlock + (kk % 4) * 32;
    const uint32_t ka = k_tile + (kk / 4) * kBlock + (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(qa), desc_sw128(ka), kk > 0);
  }
  wg_commit();
}

// Issue acc += P.V over the [64 keys x hd] V tile at `v_tile`, p as
// hi + lo halves.
template <class SH>
__device__ __forceinline__ void issue_pv(float (&acc)[SH::NB][32],
                                         const uint32_t (&phi)[4][4],
                                         const uint32_t (&plo)[4][4],
                                         uint32_t v_tile) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < SH::NB; ++cb) {
      const uint64_t dv = desc_sw128(v_tile + cb * kBlock + kk * 2048);
      wgmma_rs(acc[cb], phi[kk], dv);
      wgmma_rs(acc[cb], plo[kk], dv);
    }
  wg_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one [64 x 64] score tile in the accumulator fragment:
// s[4j + e] is (row qrow0 + 8 (e / 2), key k0 + 8j + cq + e % 2), raw
// q.k.  Updates the running max m (log2 units) and this thread's part of
// the normalizer l, returns the factor the accumulator's rows take in corr
// and whether any row of the warp moved its max, and p as hi + lo bf16 A
// fragments.  MASKED: the tile crosses S or the diagonal.
template <bool MASKED>
__device__ __forceinline__ bool softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&phi)[4][4], uint32_t (&plo)[4][4], int k0, int qrow0,
    int cq, int S, int causal, float scale2) {
  uint32_t valid = 0xFFFFFFFFu;
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      const int qpos = qrow0 + 8 * ((i / 2) % 2);
      if (key >= S || (causal && key > qpos)) {
        valid &= ~(1u << i);
        s[i] = kNegInf;
      }
    }
  }
  // max(s) * scale2 is max(s * scale2): rounding is monotonic
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = ex2(fmaf(s[i], scale2, -m[(i / 2) % 2]));
    if (MASKED) p = (valid >> i) & 1u ? p : 0.f;
    s[i] = p;
    ps[(i / 2) % 2] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + ps[r];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float p0 = s[8 * kk + 2 * a], p1 = s[8 * kk + 2 * a + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      phi[kk][a] = bf16x2_bits(hi);
      plo[kk][a] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
  return __any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f);
}

// The tile's softmax, masked only where the tile crosses S or the
// diagonal of the warpgroup's rows (first row qw): uniform over it.
__device__ __forceinline__ bool softmax_any(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&phi)[4][4], uint32_t (&plo)[4][4], int k0, int qrow0,
    int qw, int cq, int S, int causal, float scale2) {
  if (k0 + kBK > S || (causal && k0 + kBK - 1 > qw))
    return softmax_tile<true>(s, m, l, corr, phi, plo, k0, qrow0, cq, S,
                              causal, scale2);
  return softmax_tile<false>(s, m, l, corr, phi, plo, k0, qrow0, cq, S,
                             causal, scale2);
}

template <int NB>
__device__ __forceinline__ void rescale(float (&acc)[NB][32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] *= corr[(i / 2) % 2];
}

template <class SH>
__global__ void __launch_bounds__(SH::kThreads) __maxnreg__(SH::kRegs)
flash_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                __nv_bfloat16* __restrict__ o, long long osb, long long oss,
                long long osh, int S, int Hq, int n_rep, int hd, float scale,
                int causal) {
  constexpr int NB = SH::NB, CONS = SH::CONS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                           // [NB][CONS * 64 rows]
  const uint32_t k_s = q_s + NB * CONS * kBlock;       // [stage][NB]
  const uint32_t v_s = k_s + NB * kStages * kBlock;    // [stage][NB]
  const uint32_t bars = v_s + NB * kStages * kBlock;
  const uint32_t q_bar = bars;
  auto full_bar = [&](int st) { return bars + 8u * (1 + st); };
  auto empty_bar = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SH::kBQ;   // longest first
  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + SH::kBQ - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), CONS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the TMA copies of tile kt into stage kt % kStages
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    mbar_expect_tx(full_bar(st), 2 * NB * kBlock);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load(k_s + (st * NB + cb) * kBlock, &tmk, full_bar(st), 64 * cb,
               hk, kt * kBK, b);
      tma_load(v_s + (st * NB + cb) * kBlock, &tmv, full_bar(st), 64 * cb,
               hk, kt * kBK, b);
    }
  };
  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 0;
  if (loader) {
    mbar_expect_tx(q_bar, NB * CONS * kBlock);
    for (int cb = 0; cb < NB; ++cb)
      tma_load(q_s + cb * CONS * kBlock, &tmq, q_bar, 64 * cb, h, q0, b);
    for (int kt = 0; kt < min(n_kt, kStages); ++kt) load_kv(kt);
  }

  // ---- each warpgroup: 64 query rows ----
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int qw = q0 + wg * kRows;            // this warpgroup's first row
  const int qrow0 = qw + warp * 16 + lane / 4;   // its rows qrow0, + 8
  const int cq = 2 * (lane % 4);             // columns 8j + cq, + 1
  int n_mine = n_kt;                         // tiles this warpgroup needs
  if (qw >= S) n_mine = 0;
  else if (causal) n_mine = min(n_kt, (qw + kRows - 1) / kBK + 1);
  const int n_k16 = (hd + 15) / 16;
  const float scale2 = scale * kLog2e;       // scores in log2 units
  const uint32_t q_tile = q_s + wg * kBlock;

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t phi[4][4], plo[4][4];

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t v_tile = v_s + st * NB * kBlock;
    mbar_wait(full_bar(st), (kt / kStages) & 1);
    if (kt < n_mine) {   // else a tile above this warpgroup's diagonal
      own(s);
      issue_qk<SH>(s, q_tile, k_s + st * NB * kBlock, n_k16);
      wg_wait();
      own(s);
      if (softmax_any(s, m, l, corr, phi, plo, kt * kBK, qrow0, qw, cq, S,
                      causal, scale2))
        rescale(acc, corr);     // a row's max moved (else corr is 1)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) own(acc[cb]);
      own(phi);
      own(plo);
      issue_pv<SH>(acc, phi, plo, v_tile);
      wg_wait();
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) own(acc[cb]);
      own(phi);
      own(plo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(st));
    if (loader && kt + kStages < n_kt) {    // refill the stage once every
      mbar_wait(empty_bar(st), (kt / kStages) & 1);   // warp is done with it
      load_kv(kt + kStages);
    }
    __syncwarp();                 // wgmma needs the whole warp converged
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int qpos = qrow0 + 8 * r;
    if (qpos >= S) continue;                 // rows of the ragged tile
    const float lv = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + b * osb + qpos * oss + h * osh;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * cb + 8 * j + cq;     // hd % 8 == 0: d + 1 < hd
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(acc[cb][4 * j + 2 * r] / lv,
                                    acc[cb][4 * j + 2 * r + 1] / lv);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library, which the kernel
// libraries do not link: reach it through the runtime's entry-point query.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qres;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qres);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qres);
#endif
    if (err == cudaSuccess && qres == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, S, H, hd] bf16 tensor with dim stride 1 as a 4-D TMA map
// (d, h, s, b), boxes of 64 columns x `rows` rows, 128-byte swizzle;
// out-of-range elements read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int hd, long long sb, long long ss, long long sh,
                     int rows) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, Hq, Hkv, hd, causal;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];   // (b, s, h) element strides
};

// What the route takes (anything else is refused without a launch): B,
// S > 0, hd % 8 == 0 and 0 < hd <= 256, Hq % Hkv == 0, S within the grid;
// q, k, v with 16-byte-aligned bases and (b, s, h) element strides that
// are multiples of 8 (TMA's 16 bytes); o with a 4-byte-aligned base and
// even strides.
inline bool takes(const Args& a) {
  bool ok = a.B > 0 && a.S > 0 && a.hd > 0 && a.hd <= 256 && a.hd % 8 == 0 &&
            a.Hkv > 0 && a.Hq > 0 && a.Hq % a.Hkv == 0 &&
            a.S <= 64LL * 65535 &&
            static_cast<long long>(a.B) * a.Hq <= 0x7FFFFFFFLL;
  const long long* in[3] = {a.qs, a.ks, a.vs};
  for (const long long* st : in)
    for (int i = 0; i < 3; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return ok && reinterpret_cast<uintptr_t>(a.o) % 4 == 0 &&
         a.os[0] % 2 == 0 && a.os[1] % 2 == 0 && a.os[2] % 2 == 0;
}

template <class SH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, a.B, a.S, a.Hq, a.hd, a.qs[0], a.qs[1], a.qs[2],
                SH::kBQ) ||
      !make_map(&mk, a.k, a.B, a.S, a.Hkv, a.hd, a.ks[0], a.ks[1], a.ks[2],
                kBK) ||
      !make_map(&mv, a.v, a.B, a.S, a.Hkv, a.hd, a.vs[0], a.vs[1], a.vs[2],
                kBK)) {
    return cudaErrorInvalidValue;
  }
  auto kern = flash_tc_kernel<SH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SH::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.B * a.Hq),
                  static_cast<unsigned>((a.S + SH::kBQ - 1) / SH::kBQ));
  kern<<<grid, SH::kThreads, SH::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.os[0], a.os[1],
      a.os[2], a.S, a.Hq, a.Hq / a.Hkv, a.hd, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace flash
}  // namespace kishu

// q: [B, S, Hq, hd], k and v: [B, S, Hkv, hd], o: [B, S, Hq, hd], each
// given by its base pointer and four element strides (b, s, h, d).
// dtype 0 = float32, 1 = bfloat16 (all four tensors).  Needs B, S > 0,
// 0 < hd <= 256, Hq % Hkv == 0 and B * Hq <= 65535; anything else is
// cudaErrorInvalidValue without a launch.
KISHU_API int kishu_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Hq, int Hkv, int hd, int dtype, int causal, float scale,
    long long qsb, long long qss, long long qsh, long long qsd,
    long long ksb, long long kss, long long ksh, long long ksd,
    long long vsb, long long vss, long long vsh, long long vsd,
    long long osb, long long oss, long long osh, long long osd,
    void* stream) {
  using kishu::flash::Strides;
  if (B <= 0 || S <= 0 || hd <= 0 || hd > 256 || Hkv <= 0 || Hq <= 0 ||
      Hq % Hkv != 0 || static_cast<long long>(B) * Hq > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st[4] = {{qsb, qss, qsh, qsd}, {ksb, kss, ksh, ksd},
                         {vsb, vss, vsh, vsd}, {osb, oss, osh, osd}};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? kishu::flash::dispatch_hd<float>(q, k, v, o, st, B, S, Hq, Hkv,
                                             hd, scale, causal, s)
          : kishu::flash::dispatch_hd<__nv_bfloat16>(q, k, v, o, st, B, S,
                                                     Hq, Hkv, hd, scale,
                                                     causal, s);
  return static_cast<int>(err);
}

// The tensor-core route: q [B, S, Hq, hd], k and v [B, S, Hkv, hd] and o
// [B, S, Hq, hd], all bf16 with dim stride 1, each given by its base
// pointer and three element strides (b, s, h).  What tc::takes refuses,
// or a TMA map the driver refuses, is cudaErrorInvalidValue without a
// launch.
KISHU_API int kishu_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Hq, int Hkv, int hd, int causal, float scale, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, void* stream) {
  namespace tc = kishu::flash::tc;
  const tc::Args a{q, k, v, o, B, S, Hq, Hkv, hd, causal, scale,
                   {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                   {osb, oss, osh}};
  if (!tc::takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  using namespace tc;
  const cudaError_t err =
      hd <= 64 ? launch<Shape<1, 2, 2>>(a, s)
      : hd <= 128 ? launch<Shape<2, 3, 1>>(a, s)
                  : launch<Shape<4, 2, 1>>(a, s);
  return static_cast<int>(err);
}
