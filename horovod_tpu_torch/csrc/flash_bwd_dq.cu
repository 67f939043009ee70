// Flash-attention backward, dQ, for Hopper (sm_90a): f32 or bf16 in,
// f32 math.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `_flash_backward`):
// dq = scale * sum_j ds_ij k_j with ds = p * (dO v^T - dvec), where the
// probabilities p = exp(scale q k^T - lse) are rebuilt from the
// forward's saved row logsumexp (0 on rows whose lse is -inf) under
// the forward's mask: causal at GLOBAL positions q_offset + i >=
// k_offset + j, an optional sliding-window band (q - k < window), and
// grouped-query attention through kv head h / group. dvec = rowsum(dO
// * O) - dlse comes in precomputed, [B, H, Sq] f32.
//
// What bounds it on this card: per (batch, head) it does three
// [Sq, D] x [D, Sk] products (s, dO v^T, ds k) against ~5 tensors of
// bytes, far above the H100's ~295 flop/byte ridge at the training
// shapes ([8, 2048, 8, 128] bf16, causal), so it is bound by
// operations. This first version computes in f32 on the CUDA cores
// (plain FMA, no tensor cores), well under the bf16 tensor-core
// roofline; moving the products onto wgmma is later work.
//
// Design:
//  * grid = (ceil(Sq/64) q-tiles, H heads, B batch); one 256-thread
//    block owns a 64-row q-tile and loops over the k-tiles of its
//    causal/window band (`_band_j0` and the causal end of
//    `_relevant_block`), so out-of-band K/V is never read; dq
//    accumulates in registers (the TPU kernel's VMEM carry) and is
//    written once, scaled, at the input dtype;
//  * q (pre-scaled) and dO sit transposed in shared memory, so a
//    thread's 4 rows of s and dp are one float4 load per d; K and V
//    sit row-major (padded rows), read as scalars for s and dp and as
//    float4 rows for ds.k; ds goes through shared memory, transposed,
//    once per tile;
//  * tensors are read and written in their [B, S, H, D] layout through
//    strides (no transposes, no padding copies); the ragged tails of
//    Sq and Sk are masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the shared tiles
constexpr int LQ = BQ + PAD;

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
  // Qt, dOt [D][LQ]; Ks, Vs [BK][D+PAD]; DsT [BK][LQ]
  return 2 * D * LQ + 2 * BK * (D + PAD) + BK * LQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, int Sq, int Sk, int H, int group,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long gsb, long long gss, long long gsh,
    long long osb, long long oss, long long osh,
    int causal, int window, int q_offset, int k_offset, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Qt = smem;                 // [D][LQ], q * scale
  float* dOt = Qt + D * LQ;         // [D][LQ]
  float* Ks = dOt + D * LQ;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* DsT = Vs + BK * LD;        // [BK][LQ], ds transposed

  constexpr int VN = VecN<T>::N;
  constexpr int CH = D / VN;        // 16-byte chunks per row
  constexpr int OG = D / 64;        // float4 column groups per thread

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* gb = dout + b * gsb + h * gsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q (scaled) and dO tiles, transposed (rows past Sq load as 0).
  for (int id = tid; id < BQ * CH; id += NT) {
    const int r = id % BQ, c = id / BQ;
    float bq[VN], bg[VN];
    if (q0 + r < Sq) {
      load16(qb + (long long)(q0 + r) * qss + c * VN, bq);
      load16(gb + (long long)(q0 + r) * gss + c * VN, bg);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) bq[e] = bg[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      Qt[(c * VN + e) * LQ + r] = bq[e] * scale;
      dOt[(c * VN + e) * LQ + r] = bg[e];
    }
  }

  // Thread layout: rows r0..r0+3 of the tile; for s/dp the keys
  // cg + 16 * jj of the k-tile, for dq the columns g * 64 + c0 + e.
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int r0 = rg * 4;
  const int c0 = cg * 4;

  // This thread's rows' lse and dvec; rows past Sq get lse -inf (p = 0).
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi < Sq) {
      const long long at = ((long long)b * H + h) * Sq + qi;
      rl[i] = lse[at];
      rd[i] = dvec[at];
    } else {
      rl[i] = -INFINITY;
      rd[i] = 0.f;
    }
  }

  float acc[4][OG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OG * 4; ++c) acc[i][c] = 0.f;

  // Key range of this q-tile's band (local key indices).
  const int q_last = min(q0 + BQ, Sq) - 1;
  int j_hi = Sk - 1;
  int j_lo = 0;
  if (causal) {
    j_hi = min(j_hi, q_offset + q_last - k_offset);
    if (window > 0) j_lo = max(0, q_offset + q0 - (window - 1) - k_offset);
  }

  for (int k0 = (j_lo / BK) * BK; k0 <= j_hi; k0 += BK) {
    __syncthreads();   // the previous tile's Ks/Vs/DsT reads are done
    for (int id = tid; id < BK * CH; id += NT) {   // K, V row-major
      const int c = id % CH, r = id / CH;
      float bk[VN], bv[VN];
      if (k0 + r < Sk) {
        load16(kb + (long long)(k0 + r) * kss + c * VN, bk);
        load16(vb + (long long)(k0 + r) * vss + c * VN, bv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) bk[e] = bv[e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN / 4; ++u) {
        *reinterpret_cast<float4*>(&Ks[r * LD + c * VN + 4 * u]) =
            make_float4(bk[4 * u], bk[4 * u + 1], bk[4 * u + 2],
                        bk[4 * u + 3]);
        *reinterpret_cast<float4*>(&Vs[r * LD + c * VN + 4 * u]) =
            make_float4(bv[4 * u], bv[4 * u + 1], bv[4 * u + 2],
                        bv[4 * u + 3]);
      }
    }
    __syncthreads();

    // s = (scale q) k^T and dp = dO v^T: rows r0+i, keys cg + 16 jj.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LQ + r0]);
      const float4 gg = *reinterpret_cast<const float4*>(&dOt[d * LQ + r0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
      float kv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(cg + 16 * j) * LD + d];
        vv[j] = Vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

    // ds = p * (dp - dvec), p = exp(s - lse) where the mask keeps the
    // pair and lse is finite, else 0; stored transposed.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + cg + 16 * j;
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok = kj < Sk && rl[i] != -INFINITY;
        if (causal) {
          const int qp = q_offset + q0 + r0 + i;
          const int kp = k_offset + kj;
          ok = ok && qp >= kp;
          if (window > 0) ok = ok && (qp - kp) < window;
        }
        const float p = ok ? expf(s[i][j] - rl[i]) : 0.f;
        dsv[i] = p * (dp[i][j] - rd[i]);
      }
      *reinterpret_cast<float4*>(&DsT[(cg + 16 * j) * LQ + r0]) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();

    // dq += ds k
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 dd = *reinterpret_cast<const float4*>(&DsT[kk * LQ + r0]);
      const float dsa[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 kr =
            *reinterpret_cast<const float4*>(&Ks[kk * LD + g * 64 + c0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(dsa[i], kr.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(dsa[i], kr.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(dsa[i], kr.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(dsa[i], kr.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  // dq = scale * sum_j ds k (ds was taken w.r.t. scale q k^T).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    T* row = dq + b * osb + (long long)qi * oss + h * osh;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(row + g * 64 + c0 + e, acc[i][g * 4 + e] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dvec,
                   void* dq, int B, int Sq, int Sk, int H, int Hkv,
                   const long long* st, int causal, int window,
                   int q_offset, int k_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dq), Sq, Sk, H, H / Hkv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], causal, window, q_offset, k_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head) for q, k, v, dO and dq; the head_dim axis
// must be contiguous. lse and dvec are contiguous [B, H, Sq] float32.
// window <= 0 disables the band. Returns cudaGetLastError() after the
// launch (0 = launched).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dvec,
                 void* dq, int dtype, int B, int Sq, int Sk, int H, int Hkv,
                 int D, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, long long gsb, long long gss,
                 long long gsh, long long osb, long long oss, long long osh,
                 int causal, int window, int q_offset, int k_offset,
                 float scale, void* stream) {
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, gsb, gss, gsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dv = static_cast<const float*>(dvec);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv,
                             st, causal, window, q_offset, k_offset, scale,
                             s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv,
                              st, causal, window, q_offset, k_offset,
                              scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, l, dv, dq, B, Sq, Sk,
                                      H, Hkv, st, causal, window, q_offset,
                                      k_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, l, dv, dq, B, Sq, Sk,
                                       H, Hkv, st, causal, window, q_offset,
                                       k_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
