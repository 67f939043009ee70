// Flash-attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `_flash_forward`):
// fused attention with an online softmax, causal at GLOBAL positions
// q_offset + i >= k_offset + j, an optional sliding-window band
// (q - k < window), grouped-query attention through kv head h / group,
// and the row logsumexp written beside the output (-inf and a zero
// output row where every key is masked).
//
// What bounds it on this card: at the serving shapes
// ([1, 2048, 8, 128] bf16, causal) the work is ~2*S^2*D*H
// multiply-adds against ~4 tensors of bytes, far above the H100's
// ~295 flop/byte ridge, so it is bound by operations. This first
// version computes in f32 on the CUDA cores (plain FMA, no tensor
// cores), so it sits well under the bf16 tensor-core roofline; moving
// the two products onto wgmma with TMA-fed tiles is later work.
//
// Design:
//  * grid = (ceil(Sq/64) q-tiles, H heads, B batch); one 256-thread
//    block owns a 64-row q-tile and walks the k-tiles in a loop (the
//    TPU kernel's sequential grid axis and its scratch carry become
//    registers of one block);
//  * the k range is cut to the causal/window band before the loop, so
//    out-of-band K/V is never read (the rule of `_band_j0`);
//  * Q (pre-scaled) and K sit transposed in shared memory so each
//    thread's 4x4 score block is 2 float4 loads per d; P goes through
//    shared memory once per tile for the P.V product;
//  * tensors are read and written in their [B, S, H, D] layout through
//    strides (no transposes, no padding copies); the ragged tail of
//    Sq and Sk is masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the transposed tiles

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

// One 16-byte load, widened to f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return D * (BQ + PAD) + D * (BK + PAD) + BK * D + BQ * (BK + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int group,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, int window, int q_offset, int k_offset, float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                      // [D][BQ+PAD], pre-scaled
  float* Kt = Qt + D * (BQ + PAD);       // [D][BK+PAD]
  float* Vs = Kt + D * (BK + PAD);       // [BK][D]
  float* Ps = Vs + BK * D;               // [BQ][BK+PAD]

  constexpr int VN = VecN<T>::N;
  constexpr int CH = D / VN;             // 16-byte chunks per row
  constexpr int OG = D / 64;             // float4 column groups per thread

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // Q tile, transposed and scaled in f32 (rows past Sq load as 0).
  for (int id = tid; id < BQ * CH; id += NT) {
    const int r = id % BQ, c = id / BQ;
    float buf[VN];
    if (q0 + r < Sq) {
      load16(qb + (long long)(q0 + r) * qss + c * VN, buf);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) Qt[(c * VN + e) * (BQ + PAD) + r] = buf[e] * scale;
  }

  const int rg = tid >> 4;   // row group: rows r0..r0+3
  const int cg = tid & 15;   // column group within the row group
  const int r0 = rg * 4;
  const int c0 = cg * 4;

  float acc[4][OG * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OG * 4; ++c) acc[i][c] = 0.f;
  }

  // Key range of this q-tile's band (local key indices).
  const int q_last = min(q0 + BQ, Sq) - 1;
  int j_hi = Sk - 1;
  int j_lo = 0;
  if (causal) {
    j_hi = min(j_hi, q_offset + q_last - k_offset);
    if (window > 0) j_lo = max(0, q_offset + q0 - (window - 1) - k_offset);
  }

  for (int k0 = (j_lo / BK) * BK; k0 <= j_hi; k0 += BK) {
    __syncthreads();   // the previous tile's Kt/Vs/Ps reads are done
    for (int id = tid; id < BK * CH; id += NT) {   // K, transposed
      const int r = id % BK, c = id / BK;
      float buf[VN];
      if (k0 + r < Sk) {
        load16(kb + (long long)(k0 + r) * kss + c * VN, buf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) buf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) Kt[(c * VN + e) * (BK + PAD) + r] = buf[e];
    }
    for (int id = tid; id < BK * CH; id += NT) {   // V, row-major
      const int c = id % CH, r = id / CH;
      float buf[VN];
      if (k0 + r < Sk) {
        load16(vb + (long long)(k0 + r) * vss + c * VN, buf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) buf[e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN / 4; ++u)
        *reinterpret_cast<float4*>(&Vs[r * D + c * VN + 4 * u]) =
            make_float4(buf[4 * u], buf[4 * u + 1], buf[4 * u + 2],
                        buf[4 * u + 3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * (BQ + PAD) + r0]);
      const float4 bb = *reinterpret_cast<const float4*>(&Kt[d * (BK + PAD) + c0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        bool ok = kj < Sk;
        if (causal) {
          const int kp = k_offset + kj;
          ok = ok && qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
        }
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // Rows with every key masked so far keep m == -inf: shift by 0
      // there so exp(-inf - 0) = 0 instead of NaN.
      const float shift = (m_new == -INFINITY) ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - shift);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = (m[i] == -INFINITY) ? 0.f : expf(m[i] - shift);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OG * 4; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(&Ps[(r0 + i) * (BK + PAD) + c0]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(r0 + i) * (BK + PAD) + kk];
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[kk * D + g * 64 + c0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(p[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(p[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(p[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(p[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
    T* orow = o + b * osb + (long long)qi * oss + h * osh;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(orow + g * 64 + c0 + e, acc[i][g * 4 + e] / denom);
    if (cg == 0)
      lse[((long long)b * H + h) * Sq + qi] =
          (l[i] == 0.f) ? -INFINITY : m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int Hkv,
                   const long long* st, int causal, int window,
                   int q_offset, int k_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H,
      H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, window, q_offset, k_offset,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head); the head_dim axis must be contiguous.
// window <= 0 disables the band. Returns cudaGetLastError() after the
// launch (0 = launched).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int dtype, int B, int Sq, int Sk, int H, int Hkv,
              int D, long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh, long long vsb,
              long long vss, long long vsh, long long osb, long long oss,
              long long osh, int causal, int window, int q_offset,
              int k_offset, float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                             window, q_offset, k_offset, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                              window, q_offset, k_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st,
                                      causal, window, q_offset, k_offset,
                                      scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st,
                                       causal, window, q_offset, k_offset,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
