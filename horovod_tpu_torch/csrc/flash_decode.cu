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
// keeps every byte read exactly once and coalesced (a warp reads one
// cache row, D contiguous elements, per key, lanes splitting D) and
// keeps enough of them in flight to fill the card:
//  * Split over the cache: grid = (Hkv, lanes, NS). Block (kv head,
//    lane, split) owns keys [split * chunk, (split + 1) * chunk) of the
//    lane's filled prefix, chunk = ceil(W / NS). The host picks NS from
//    W, Hkv x lanes and the SM count, never from `length` (reading it
//    would sync the tick): 8 lanes x 8 kv heads at W = 2048 give 5
//    splits, 320 blocks on the 132 SMs where one block per pair gave 64.
//  * Prefetch: eight warps per block stream disjoint groups of U keys;
//    each warp issues the loads of its next group before it reduces the
//    current one, so a group's latency hides behind the last one's math.
//  * Each warp keeps its own online-softmax state in registers; the
//    block merges its warps through shared memory and writes one
//    partial (row max m, row sum l, unnormalized o, all f32) per query
//    head to a workspace. A split that starts at or past the lane's
//    length writes the empty partial (m = -inf, l = 0).
//  * A second kernel on the same stream merges the partials of each
//    (lane, query head): o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M)
//    l_s with M = max_s m_s, skipping empty partials (e^(-inf - -inf)
//    is NaN). A lane whose partials are all empty (length 0) gets the
//    zero row; the TPU kernel's clamped index map would read block -1
//    there.
//
// Per-lane lengths arrive as a device int32 tensor [L] (no host sync
// on the tick).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;    // warps per block
constexpr int U = 4;     // keys a warp loads per step

// A thread's VD-element slice of one cache row, as loaded (raw bits).
template <typename T, int VD> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 2> { using type = unsigned int; };

template <typename R>
__device__ __forceinline__ R load_raw(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void widen(float4 r, float* out) {
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
__device__ __forceinline__ void widen(float2 r, float* out) {
  out[0] = r.x; out[1] = r.y;
}
__device__ __forceinline__ void widen(unsigned int r, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  out[0] = a.x; out[1] = a.y;
}
__device__ __forceinline__ void widen(uint2 r, float* out) {
  widen(r.x, out);
  widen(r.y, out + 2);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One split of one (kv head, lane): its partial (m, l, o) per query
// head of the group. Partials are indexed ((split * L + lane) * H +
// head); part_o holds D floats each, part_ml the pair (m, l).
template <typename T, int D, int GRP>
__global__ void __launch_bounds__(NW * 32) flash_decode_split(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ length,
    float* __restrict__ part_o, float* __restrict__ part_ml, int L, int W,
    int H, int Hkv, int chunk, long long qsb, long long qsh, float scale) {
  constexpr int VD = D / 32;   // head_dim elements per thread
  using R = typename Raw<T, VD>::type;
  __shared__ float sm_m[NW][GRP];
  __shared__ float sm_l[NW][GRP];
  __shared__ float sm_acc[NW][GRP][D];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int len = max(0, min(length[b], W));
  const int j_begin = sp * chunk;
  const int j_end = min(j_begin + chunk, len);
  const long long p0 = ((long long)sp * L + b) * H + hk * GRP;

  if (j_begin >= j_end) {   // nothing of this lane's prefix here
    if (threadIdx.x < GRP) {
      part_ml[2 * (p0 + threadIdx.x)] = -INFINITY;
      part_ml[2 * (p0 + threadIdx.x) + 1] = 0.f;
    }
    return;
  }

  float qv[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    widen(load_raw<R>(q + b * qsb + (long long)(hk * GRP + g) * qsh + lane * VD),
          qv[g]);
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

  int j0 = j_begin + w * U;
  R ck[U], cv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ck[u] = cv[u] = R{};
    if (j0 + u < j_end) {
      ck[u] = load_raw<R>(kb + (long long)(j0 + u) * row);
      cv[u] = load_raw<R>(vb + (long long)(j0 + u) * row);
    }
  }
  for (; j0 < j_end; j0 += NW * U) {
    // The next group's loads go out before this group is reduced.
    const int jn = j0 + NW * U;
    R nk[U], nv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      nk[u] = nv[u] = R{};
      if (jn + u < j_end) {
        nk[u] = load_raw<R>(kb + (long long)(jn + u) * row);
        nv[u] = load_raw<R>(vb + (long long)(jn + u) * row);
      }
    }
    float kv[U][VD], vv[U][VD];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      widen(ck[u], kv[u]);
      widen(cv[u], vv[u]);
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
      // Key j0 is always valid here (j0 < j_end), so m_new is finite.
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (j0 + u < j_end) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VD; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < j_end) {
          const float p = expf(s[u][g] - m_new);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
        }
      }
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ck[u] = nk[u];
      cv[u] = nv[u];
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

  // The block's partial. Warp 0 holds key j_begin, so M is finite.
  for (int idx = threadIdx.x; idx < GRP * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      if (sm_m[ww][g] == -INFINITY) continue;   // this warp saw no key
      const float wt = expf(sm_m[ww][g] - M);
      Lsum = fmaf(sm_l[ww][g], wt, Lsum);
      A = fmaf(sm_acc[ww][g][d], wt, A);
    }
    part_o[(p0 + g) * D + d] = A;
    if (d == 0) {
      part_ml[2 * (p0 + g)] = M;
      part_ml[2 * (p0 + g) + 1] = Lsum;
    }
  }
}

// Merge the NS partials of (query head h, lane b) into out [L, 1, H, D].
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_decode_merge(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    T* __restrict__ out, int L, int H, int NS) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < NS; ++s)
    M = fmaxf(M, part_ml[2 * (((long long)s * L + b) * H + h)]);
  float res = 0.f;
  if (M != -INFINITY) {
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < NS; ++s) {
      const long long p = ((long long)s * L + b) * H + h;
      const float ms = part_ml[2 * p];
      if (ms == -INFINITY) continue;   // an empty split
      const float wt = expf(ms - M);
      Lsum = fmaf(part_ml[2 * p + 1], wt, Lsum);
      A = fmaf(part_o[p * D + d], wt, A);
    }
    res = A / Lsum;
  }
  store1(out + ((long long)b * H + h) * D + d, res);
}

template <typename T, int D, int GRP>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* length, void* out, float* ws, int L, int W,
                   int H, int Hkv, int NS, long long qsb, long long qsh,
                   float scale, cudaStream_t stream) {
  float* part_o = ws;
  float* part_ml = ws + (long long)NS * L * H * D;
  const int chunk = (W + NS - 1) / NS;
  flash_decode_split<T, D, GRP><<<dim3(Hkv, L, NS), NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(length), part_o,
      part_ml, L, W, H, Hkv, chunk, qsb, qsh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge<T, D><<<dim3(H, L), D, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), L, H, NS);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int grp, const void* q, const void* kc, const void* vc,
                     const void* length, void* out, float* ws, int L, int W,
                     int H, int Hkv, int NS, long long qsb, long long qsh,
                     float scale, cudaStream_t s) {
  switch (grp) {
    case 1: return launch<T, D, 1>(q, kc, vc, length, out, ws, L, W, H, Hkv, NS, qsb, qsh, scale, s);
    case 2: return launch<T, D, 2>(q, kc, vc, length, out, ws, L, W, H, Hkv, NS, qsb, qsh, scale, s);
    case 4: return launch<T, D, 4>(q, kc, vc, length, out, ws, L, W, H, Hkv, NS, qsb, qsh, scale, s);
    case 8: return launch<T, D, 8>(q, kc, vc, length, out, ws, L, W, H, Hkv, NS, qsb, qsh, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [L, 1, H, D] with element strides (qsb, qsh) and a contiguous head
// dim; caches [L, W, Hkv, D] contiguous; length int32 [L] on device;
// out [L, 1, H, D] contiguous; ws a float32 workspace of
// splits * L * H * (D + 2) elements (the partials), splits >= 1.
// dtype: 0 = float32, 1 = bfloat16. Launches the split kernel and the
// merge kernel on `stream`; returns cudaGetLastError() after the
// launches (0 = launched).
int flash_decode(const void* q, const void* kc, const void* vc,
                 const void* length, void* out, void* ws, int dtype, int L,
                 int W, int H, int Hkv, int D, int splits, long long qsb,
                 long long qsh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const int grp = H / Hkv;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return by_group<float, 64>(grp, q, kc, vc, length, out, w, L, W, H, Hkv, splits, qsb, qsh, scale, s);
  if (dtype == 0 && D == 128)
    return by_group<float, 128>(grp, q, kc, vc, length, out, w, L, W, H, Hkv, splits, qsb, qsh, scale, s);
  if (dtype == 1 && D == 64)
    return by_group<__nv_bfloat16, 64>(grp, q, kc, vc, length, out, w, L, W, H, Hkv, splits, qsb, qsh, scale, s);
  if (dtype == 1 && D == 128)
    return by_group<__nv_bfloat16, 128>(grp, q, kc, vc, length, out, w, L, W, H, Hkv, splits, qsb, qsh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
