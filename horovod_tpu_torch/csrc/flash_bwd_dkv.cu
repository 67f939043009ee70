// Flash-attention backward, dK and dV, for Hopper (sm_90a): f32 or
// bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `_flash_backward`):
// dv_j = sum_i p_ij dO_i and dk_j = sum_i ds_ij (scale q_i), with
// p = exp(scale q k^T - lse) rebuilt from the forward's saved row
// logsumexp (0 on rows whose lse is -inf) under the forward's mask
// (causal at GLOBAL positions q_offset + i >= k_offset + j, an
// optional sliding-window band q - k < window) and ds = p * (dO v^T -
// dvec), dvec = rowsum(dO * O) - dlse precomputed as [B, H, Sq] f32.
// Under grouped-query attention the sums run over every query head of
// the kv head's group, so dK/dV come out at kv width, each written
// once: no atomics, no full-H gradient and no reduce pass after it.
//
// What bounds it on this card: per (batch, head) it does four
// [Sk, D] x [D, Sq] products (s, dO v^T, p^T dO, ds^T q) against ~6
// tensors of bytes, far above the H100's ~295 flop/byte ridge at the
// training shapes ([8, 2048, 8, 128] bf16, causal), so it is bound by
// operations. This first version computes in f32 on the CUDA cores
// (plain FMA, no tensor cores); moving the products onto wgmma is
// later work.
//
// Design:
//  * grid = (ceil(Sk/64) k-tiles, Hkv kv heads, B batch); one
//    256-thread block owns a 64-key tile, keeps K and V transposed in
//    shared memory, and loops over the group's query heads x the
//    q-tiles of the tile's causal/window band (`_band_i0` and the
//    window's end), the TPU kernel's sequential inner grid axis; the
//    dK and dV sums stay in registers (two 4 x D/16 blocks a thread);
//  * per q-tile, q (pre-scaled) and dO sit row-major (padded rows) in
//    shared memory: scalars for s and dp, float4 rows for the two
//    accumulations; p and ds go through shared memory once per tile;
//  * tensors are read and written in their [B, S, H, D] layout through
//    strides (no transposes, no padding copies); the ragged tails of
//    Sq and Sk are masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // keys per block
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the shared tiles
constexpr int LK = BK + PAD;

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
  // Kt, Vt [D][LK]; Qs, dOs [BQ][D+PAD]; Ps, dSs [BQ][LK]; lse, dvec [BQ]
  return 2 * D * LK + 2 * BQ * (D + PAD) + 2 * BQ * LK + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
    int group,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long gsb, long long gss, long long gsh,
    long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh,
    int causal, int window, int q_offset, int k_offset, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Kt = smem;                 // [D][LK]
  float* Vt = Kt + D * LK;          // [D][LK]
  float* Qs = Vt + D * LK;          // [BQ][LD], q * scale
  float* dOs = Qs + BQ * LD;        // [BQ][LD]
  float* Ps = dOs + BQ * LD;        // [BQ][LK]
  float* dSs = Ps + BQ * LK;        // [BQ][LK]
  float* lse_s = dSs + BQ * LK;     // [BQ]
  float* dvec_s = lse_s + BQ;       // [BQ]

  constexpr int VN = VecN<T>::N;
  constexpr int CH = D / VN;        // 16-byte chunks per row
  constexpr int OG = D / 64;        // float4 column groups per thread

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // K and V tiles, transposed (rows past Sk load as 0).
  for (int id = tid; id < BK * CH; id += NT) {
    const int r = id % BK, c = id / BK;
    float bk[VN], bv[VN];
    if (k0 + r < Sk) {
      load16(kb + (long long)(k0 + r) * kss + c * VN, bk);
      load16(vb + (long long)(k0 + r) * vss + c * VN, bv);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) bk[e] = bv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      Kt[(c * VN + e) * LK + r] = bk[e];
      Vt[(c * VN + e) * LK + r] = bv[e];
    }
  }

  // Thread layout: keys j0..j0+3 of the tile; for s/dp the queries
  // cg + 16 * ii of the q-tile, for dk/dv the columns g * 64 + c0 + e.
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int j0 = rg * 4;
  const int c0 = cg * 4;

  float dk_acc[4][OG * 4], dv_acc[4][OG * 4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < OG * 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // Query range of this k-tile's band (local query indices): causal
  // rows start at the tile's first key, windowed rows end window - 1
  // past its last.
  const int k_last = min(k0 + BK, Sk) - 1;
  int i_lo = 0;
  int i_hi = Sq - 1;
  if (causal) {
    i_lo = max(0, k_offset + k0 - q_offset);
    if (window > 0)
      i_hi = min(i_hi, k_offset + k_last + window - 1 - q_offset);
  }

  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const T* qb = q + b * qsb + hq * qsh;
    const T* gb = dout + b * gsb + hq * gsh;
    const long long lrow = ((long long)b * H + hq) * Sq;
    for (int t0 = (i_lo / BQ) * BQ; t0 <= i_hi; t0 += BQ) {
      __syncthreads();   // the previous tile's Qs/dOs/Ps/dSs reads are done
      for (int id = tid; id < BQ * CH; id += NT) {   // q, dO row-major
        const int c = id % CH, r = id / CH;
        float bq[VN], bg[VN];
        if (t0 + r < Sq) {
          load16(qb + (long long)(t0 + r) * qss + c * VN, bq);
          load16(gb + (long long)(t0 + r) * gss + c * VN, bg);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) bq[e] = bg[e] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < VN / 4; ++u) {
          *reinterpret_cast<float4*>(&Qs[r * LD + c * VN + 4 * u]) =
              make_float4(bq[4 * u] * scale, bq[4 * u + 1] * scale,
                          bq[4 * u + 2] * scale, bq[4 * u + 3] * scale);
          *reinterpret_cast<float4*>(&dOs[r * LD + c * VN + 4 * u]) =
              make_float4(bg[4 * u], bg[4 * u + 1], bg[4 * u + 2],
                          bg[4 * u + 3]);
        }
      }
      for (int r = tid; r < BQ; r += NT) {   // rows past Sq: p = 0
        const bool in = t0 + r < Sq;
        lse_s[r] = in ? lse[lrow + t0 + r] : -INFINITY;
        dvec_s[r] = in ? dvec[lrow + t0 + r] : 0.f;
      }
      __syncthreads();

      // s^T = k (scale q)^T and dp^T = v dO^T: keys j0+jj, queries
      // cg + 16 ii.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&Kt[d * LK + j0]);
        const float4 w = *reinterpret_cast<const float4*>(&Vt[d * LK + j0]);
        const float kv[4] = {a.x, a.y, a.z, a.w};
        const float vv[4] = {w.x, w.y, w.z, w.w};
        float qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(cg + 16 * i) * LD + d];
          gv[i] = dOs[(cg + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
            dp[j][i] = fmaf(vv[j], gv[i], dp[j][i]);
          }
      }

      // p = exp(s - lse) where the mask keeps the pair and lse is
      // finite, else 0; ds = p * (dp - dvec). Stored [query][key].
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = cg + 16 * i;
        const int qp = q_offset + t0 + ql;
        const float l = lse_s[ql];
        const float dvv = dvec_s[ql];
        float pv[4], dsv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + j0 + j;
          bool ok = kj < Sk && l != -INFINITY;
          if (causal) {
            const int kp = k_offset + kj;
            ok = ok && qp >= kp;
            if (window > 0) ok = ok && (qp - kp) < window;
          }
          pv[j] = ok ? expf(s[j][i] - l) : 0.f;
          dsv[j] = pv[j] * (dp[j][i] - dvv);
        }
        *reinterpret_cast<float4*>(&Ps[ql * LK + j0]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(&dSs[ql * LK + j0]) =
            make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T (scale q)
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(&Ps[i * LK + j0]);
        const float4 dd = *reinterpret_cast<const float4*>(&dSs[i * LK + j0]);
        const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
        const float da[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          const float4 o =
              *reinterpret_cast<const float4*>(&dOs[i * LD + g * 64 + c0]);
          const float4 qq =
              *reinterpret_cast<const float4*>(&Qs[i * LD + g * 64 + c0]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[j][g * 4 + 0] = fmaf(pa[j], o.x, dv_acc[j][g * 4 + 0]);
            dv_acc[j][g * 4 + 1] = fmaf(pa[j], o.y, dv_acc[j][g * 4 + 1]);
            dv_acc[j][g * 4 + 2] = fmaf(pa[j], o.z, dv_acc[j][g * 4 + 2]);
            dv_acc[j][g * 4 + 3] = fmaf(pa[j], o.w, dv_acc[j][g * 4 + 3]);
            dk_acc[j][g * 4 + 0] = fmaf(da[j], qq.x, dk_acc[j][g * 4 + 0]);
            dk_acc[j][g * 4 + 1] = fmaf(da[j], qq.y, dk_acc[j][g * 4 + 1]);
            dk_acc[j][g * 4 + 2] = fmaf(da[j], qq.z, dk_acc[j][g * 4 + 2]);
            dk_acc[j][g * 4 + 3] = fmaf(da[j], qq.w, dk_acc[j][g * 4 + 3]);
          }
        }
      }
    }
  }

  // Each dK/dV row written once, at kv width (q already carried scale).
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + j0 + j;
    if (kj >= Sk) continue;
    T* krow = dk + b * dksb + (long long)kj * dkss + hk * dksh;
    T* vrow = dv + b * dvsb + (long long)kj * dvss + hk * dvsh;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store1(krow + g * 64 + c0 + e, dk_acc[j][g * 4 + e]);
        store1(vrow + g * 64 + c0 + e, dv_acc[j][g * 4 + e]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dvec,
                   void* dk, void* dv, int B, int Sq, int Sk, int H,
                   int Hkv, const long long* st, int causal, int window,
                   int q_offset, int k_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, H / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16],
      st[17], causal, window, q_offset, k_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head) for q, k, v, dO, dk and dv; the head_dim
// axis must be contiguous. lse and dvec are contiguous [B, H, Sq]
// float32. window <= 0 disables the band. Returns cudaGetLastError()
// after the launch (0 = launched).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dvec,
                  void* dk, void* dv, int dtype, int B, int Sq, int Sk,
                  int H, int Hkv, int D, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, long long gsb,
                  long long gss, long long gsh, long long dksb,
                  long long dkss, long long dksh, long long dvsb,
                  long long dvss, long long dvsh, int causal, int window,
                  int q_offset, int k_offset, float scale, void* stream) {
  const long long st[18] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                            gsb, gss, gsh, dksb, dkss, dksh, dvsb, dvss,
                            dvsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dvp = static_cast<const float*>(dvec);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                             Hkv, st, causal, window, q_offset, k_offset,
                             scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                              Hkv, st, causal, window, q_offset, k_offset,
                              scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, l, dvp, dk, dv, B, Sq,
                                      Sk, H, Hkv, st, causal, window,
                                      q_offset, k_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, l, dvp, dk, dv, B, Sq,
                                       Sk, H, Hkv, st, causal, window,
                                       q_offset, k_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
