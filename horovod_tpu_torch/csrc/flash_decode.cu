// Flash-decode for Hopper (sm_90a): one S=1 decode tick against the
// linear KV cache, f32 or bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by
// `flash_decode_attention`): the query of every lane attends the
// filled prefix [0, length) of its cache, read in the cache's stored
// [B, W, Hkv, D] layout, with an online softmax in f32 and grouped
// query heads consumed at kv width (the H/Hkv query rows of a group
// share every K/V load).
//
// What bounds it on this card: each tick reads lanes x length x Hkv x
// D x 2 (K and V) cache elements and does ~4 flops per element, so it
// is bound by bytes (far below the ~295 flop/byte ridge). The design
// keeps every byte read exactly once and coalesced: a warp reads one
// cache row (D contiguous elements) per key, lanes splitting D, and
// eight warps per block stream disjoint key sets, each keeping its own
// online-softmax state in registers; the eight partial states merge
// through shared memory at the end.
//
// Per-lane lengths arrive as a device int32 tensor [L] (no host sync
// on the tick). length == 0 is defined as an all-zero output row; the
// TPU kernel's clamped index map would read block -1 there. One block
// per (kv head, lane); splitting a long cache across blocks (a second
// merge pass) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;    // warps per block
constexpr int U = 4;     // keys in flight per warp step

template <typename T, int N> __device__ __forceinline__ void load_vec(const T* p, float* out);
template <> __device__ __forceinline__ void load_vec<float, 4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void load_vec<float, 2>(const float* p, float* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <> __device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <> __device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(const __nv_bfloat16* p, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = a.x; out[1] = a.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int GRP>
__global__ void __launch_bounds__(NW * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ length,
    T* __restrict__ out, int W, int H, int Hkv, long long qsb,
    long long qsh, float scale) {
  constexpr int VD = D / 32;   // head_dim elements per thread
  __shared__ float sm_m[NW][GRP];
  __shared__ float sm_l[NW][GRP];
  __shared__ float sm_acc[NW][GRP][D];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(length[b], W));

  float qv[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    load_vec<T, VD>(q + b * qsb + (long long)(hk * GRP + g) * qsh + lane * VD, qv[g]);
#pragma unroll
    for (int e = 0; e < VD; ++e) qv[g][e] *= scale;
  }

  float m[GRP], l[GRP], acc[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VD; ++e) acc[g][e] = 0.f;
  }

  const long long row = (long long)Hkv * D;   // cache stride per position
  const T* kb = kc + (long long)b * W * row + hk * D + lane * VD;
  const T* vb = vc + (long long)b * W * row + hk * D + lane * VD;

  for (int j0 = w * U; j0 < len; j0 += NW * U) {
    float kv[U][VD], vv[U][VD];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < len) {
        load_vec<T, VD>(kb + (long long)(j0 + u) * row, kv[u]);
        load_vec<T, VD>(vb + (long long)(j0 + u) * row, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VD; ++e) kv[u][e] = vv[u][e] = 0.f;
      }
    }
    float s[U][GRP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GRP; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VD; ++e) part = fmaf(qv[g][e], kv[u][e], part);
        s[u][g] = part;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GRP; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      // Key j0 is always valid here (j0 < len), so m_new is finite.
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (j0 + u < len) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VD; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < len) {
          const float p = expf(s[u][g] - m_new);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
        }
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VD; ++e) sm_acc[w][g][lane * VD + e] = acc[g][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < GRP * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float res = 0.f;
    if (M != -INFINITY) {
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) {
        if (sm_m[ww][g] == -INFINITY) continue;   // this warp saw no key
        const float wt = expf(sm_m[ww][g] - M);
        L = fmaf(sm_l[ww][g], wt, L);
        A = fmaf(sm_acc[ww][g][d], wt, A);
      }
      res = A / L;
    }
    store1(out + ((long long)b * H + hk * GRP + g) * D + d, res);
  }
}

template <typename T, int D, int GRP>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* length, void* out, int L, int W, int H,
                   int Hkv, long long qsb, long long qsh, float scale,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, L);
  flash_decode_kernel<T, D, GRP><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(length),
      static_cast<T*>(out), W, H, Hkv, qsb, qsh, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int grp, const void* q, const void* kc, const void* vc,
                     const void* length, void* out, int L, int W, int H,
                     int Hkv, long long qsb, long long qsh, float scale,
                     cudaStream_t s) {
  switch (grp) {
    case 1: return launch<T, D, 1>(q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
    case 2: return launch<T, D, 2>(q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
    case 4: return launch<T, D, 4>(q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
    case 8: return launch<T, D, 8>(q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [L, 1, H, D] with element strides (qsb, qsh) and a contiguous head
// dim; caches [L, W, Hkv, D] contiguous; length int32 [L] on device;
// out [L, 1, H, D] contiguous. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched).
int flash_decode(const void* q, const void* kc, const void* vc,
                 const void* length, void* out, int dtype, int L, int W,
                 int H, int Hkv, int D, long long qsb, long long qsh,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grp = H / Hkv;
  if (dtype == 0 && D == 64)
    return by_group<float, 64>(grp, q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
  if (dtype == 0 && D == 128)
    return by_group<float, 128>(grp, q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
  if (dtype == 1 && D == 64)
    return by_group<__nv_bfloat16, 64>(grp, q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
  if (dtype == 1 && D == 128)
    return by_group<__nv_bfloat16, 128>(grp, q, kc, vc, length, out, L, W, H, Hkv, qsb, qsh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
