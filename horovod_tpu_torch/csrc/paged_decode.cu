// Paged decode for Hopper (sm_90a): one S=1 decode tick of every lane
// against the shared paged KV pool, read through each lane's block
// table; f32 or bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/paged_attention.py, launched by
// `_paged_decode_call`). For each lane it walks the first
// min(ceil((fill + 1) / block_size), T) entries of the lane's table,
// reads each block's [block_size, Hkv, D] rows from the pool IN PLACE
// (no gather copy), replaces the row at position `fill` with the
// current token's k_new / v_new, masks positions > fill, keeps the
// online softmax in f32 and writes acc / l at the input dtype.
//
// What bounds it on this card: a tick reads sum(fill + 1) x Hkv x D x
// 2 (K and V) pool elements and does ~4 flops per element per query
// head of the group, so it is bound by bytes, far below the ~295
// flop/byte ridge. The design is flash_decode.cu's: one block per
// (kv head, lane), the H/Hkv query heads of the group sharing every
// K/V load; a warp reads one key row (D contiguous elements, lanes
// splitting D, so each load is coalesced) per position, eight warps
// stream disjoint positions with their own online-softmax state in
// registers and merge through shared memory at the end. Positions map
// to pool rows through the table (one broadcast table read per key),
// so the pool is read where it lies and only filled blocks are
// touched. The table and the fills are device int32 tensors: no host
// sync on the tick.
//
// Arithmetic follows the plain version (the walk at walk_block ==
// block_size): q is scaled and rounded to the input dtype, p is
// rounded to the input dtype before P.V while l sums the unrounded p.
// A split over blocks and cp.async / TMA prefetch of the next table
// entry's block are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;    // warps per block
constexpr int U = 4;     // positions in flight per warp step

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

// Round an f32 value to the input dtype and back (identity for f32).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int GRP>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, const int* __restrict__ table,
    const int* __restrict__ fill, const T* __restrict__ kp,
    const T* __restrict__ vp, T* __restrict__ out, int H, int Hkv, int bs,
    int nt, long long qsl, long long qsh, long long ksl, long long ksh,
    long long vsl, long long vsh, float scale) {
  constexpr int VD = D / 32;   // head_dim elements per thread
  __shared__ float sm_m[NW][GRP];
  __shared__ float sm_l[NW][GRP];
  __shared__ float sm_acc[NW][GRP][D];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int f = max(0, fill[b]);
  // Positions [0, npos) are attended: those <= fill, clamped to the
  // table's span (fill == span is the pipelined tick past the budget:
  // the whole table, no merged row).
  const int npos = min(f + 1, bs * nt);
  const int* trow = table + (long long)b * nt;
  const T* tq = nullptr;

  float qv[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    load_vec<T, VD>(q + b * qsl + (long long)(hk * GRP + g) * qsh + lane * VD, qv[g]);
#pragma unroll
    for (int e = 0; e < VD; ++e) qv[g][e] = round_to(qv[g][e] * scale, tq);
  }
  float knv[VD], vnv[VD];
  load_vec<T, VD>(kn + b * ksl + (long long)hk * ksh + lane * VD, knv);
  load_vec<T, VD>(vn + b * vsl + (long long)hk * vsh + lane * VD, vnv);

  float m[GRP], l[GRP], acc[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VD; ++e) acc[g][e] = 0.f;
  }

  const long long row = (long long)Hkv * D;   // pool stride per position
  const long long blk_stride = (long long)bs * row;
  const long long col = (long long)hk * D + lane * VD;

  for (int j0 = w * U; j0 < npos; j0 += NW * U) {
    float kv[U][VD], vv[U][VD];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = j0 + u;
      if (p < npos && p != f) {
        const long long off = (long long)trow[p / bs] * blk_stride +
                              (long long)(p % bs) * row + col;
        load_vec<T, VD>(kp + off, kv[u]);
        load_vec<T, VD>(vp + off, vv[u]);
      } else {
        // The merged current row, or a zero row past the end (masked).
        const bool cur = p == f;
#pragma unroll
        for (int e = 0; e < VD; ++e) {
          kv[u][e] = cur ? knv[e] : 0.f;
          vv[u][e] = cur ? vnv[e] : 0.f;
        }
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
      // Position j0 is always valid here (j0 < npos), so m_new is finite.
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (j0 + u < npos) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VD; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < npos) {
          const float p = expf(s[u][g] - m_new);
          const float pr = round_to(p, tq);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VD; ++e) acc[g][e] = fmaf(pr, vv[u][e], acc[g][e]);
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
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      if (sm_m[ww][g] == -INFINITY) continue;   // this warp saw no key
      const float wt = expf(sm_m[ww][g] - M);
      L = fmaf(sm_l[ww][g], wt, L);
      A = fmaf(sm_acc[ww][g][d], wt, A);
    }
    // npos >= 1, so warp 0 saw position 0 and L > 0.
    store1(out + ((long long)b * H + hk * GRP + g) * D + d, A / L);
  }
}

struct Args {
  const void *q, *kn, *vn, *table, *fill, *kp, *vp;
  void* out;
  int L, H, Hkv, bs, nt;
  long long qsl, qsh, ksl, ksh, vsl, vsh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GRP>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.Hkv, a.L);
  paged_decode_kernel<T, D, GRP><<<grid, NW * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<const int*>(a.table),
      static_cast<const int*>(a.fill), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<T*>(a.out), a.H, a.Hkv,
      a.bs, a.nt, a.qsl, a.qsh, a.ksl, a.ksh, a.vsl, a.vsh, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int grp, const Args& a) {
  switch (grp) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [L, H, D] with element strides (qsl, qsh); k_new / v_new [L, Hkv, D]
// with strides (ksl, ksh) / (vsl, vsh); head dims contiguous. table
// [L, nt] and fill [L] contiguous int32 on the device; pools
// [num_blocks, bs, Hkv, D] contiguous; out [L, H, D] contiguous.
// dtype: 0 = float32, 1 = bfloat16. `scale` is D^-0.5 rounded to the
// dtype. Returns cudaGetLastError() after the launch (0 = launched).
int paged_decode(const void* q, const void* kn, const void* vn,
                 const void* table, const void* fill, const void* kp,
                 const void* vp, void* out, int dtype, int L, int H,
                 int Hkv, int D, int bs, int nt, long long qsl,
                 long long qsh, long long ksl, long long ksh,
                 long long vsl, long long vsh, float scale,
                 void* stream) {
  if (L <= 0 || Hkv <= 0 || bs <= 0 || nt <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kn, vn, table, fill, kp, vp, out, L, H, Hkv, bs, nt,
               qsl, qsh, ksl, ksh, vsl, vsh, scale,
               static_cast<cudaStream_t>(stream)};
  const int grp = H / Hkv;
  if (dtype == 0 && D == 64) return by_group<float, 64>(grp, a);
  if (dtype == 0 && D == 128) return by_group<float, 128>(grp, a);
  if (dtype == 1 && D == 64) return by_group<__nv_bfloat16, 64>(grp, a);
  if (dtype == 1 && D == 128) return by_group<__nv_bfloat16, 128>(grp, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
