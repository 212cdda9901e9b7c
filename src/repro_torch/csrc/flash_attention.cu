// flash_attention — tiled softmax attention, forward only (prefill).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, pallas_call in flash_attention_bhsd), which walks a
// sequential (B*Hq, S/BQ, S/BK) grid and carries the running max, the
// normalizer and the [BQ, hd] accumulator in VMEM scratch across the K
// steps.
//
// What bounds it on an H100: operations.  At SmolLM-360M's prefill shape
// (B 8, S 512, 15/5 heads of 64, causal) the function needs 4*B*Hq*S^2*hd/2
// = 4.0 GFLOP against 31 MB of q, k, v and o.  This first kernel computes
// both products with float32 FMAs on the CUDA cores (no tensor cores), so
// it sits far above that bound; wgmma/TMA tiles are later work.
//
// Design:
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
