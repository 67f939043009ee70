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
// keeps every byte read exactly once and coalesced (neighbouring lanes
// read a cache row's D contiguous elements, 16 bytes each) and keeps
// enough of them in flight to fill the card:
//  * Split over the cache: grid = (Hkv, lanes, NS). Block (kv head,
//    lane, split) owns keys [split * chunk, (split + 1) * chunk) of the
//    lane's filled prefix, chunk = ceil(W / NS). The host picks NS from
//    W, Hkv x lanes and the SM count, never from `length` (reading it
//    would sync the tick): 8 lanes x 8 kv heads at W = 2048 give 4
//    splits, 256 blocks, one wave of the 132 SMs' resident slots, where
//    one block per pair gave 64.
//  * The loads, per-thread softmax state, the block's partial and the
//    merge kernel are `decode_split.cuh`'s, shared with the paged
//    decode: 16-byte loads a lane (two bf16 rows a warp load), each warp
//    issuing the loads of its next step before it reduces the current
//    one; the block writes one f32 partial (m, l, unnormalized o) per
//    query head to a workspace, a split that starts at or past the
//    lane's length writes the empty partial, and a second kernel on the
//    same stream merges them. A lane whose partials are all empty
//    (length 0) gets the zero row; the TPU kernel's clamped index map
//    would read block -1 there.
//
// Per-lane lengths arrive as a device int32 tensor [L] (no host sync
// on the tick).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

// One split of one (kv head, lane): its partial (m, l, o) per query
// head of the group (see decode_split.cuh for the layout).
template <typename T, int D, int GRP>
__global__ void __launch_bounds__(decode::NW * 32) flash_decode_split(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ length,
    float* __restrict__ part_o, float* __restrict__ part_ml, int L, int W,
    int H, int Hkv, int chunk, long long qsb, long long qsh, float scale) {
  constexpr int VD = decode::Row<T, D>::VD;     // elements a lane loads
  using R = uint4;                               // one 16-byte load
  // This thread's VD columns of every row it reads.
  const int col = (threadIdx.x & 31) % decode::Row<T, D>::LPR * VD;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int len = max(0, min(length[b], W));
  const int j_begin = sp * chunk;
  const int j_end = min(j_begin + chunk, len);
  const long long p0 = ((long long)sp * L + b) * H + hk * GRP;

  if (j_begin >= j_end) {   // nothing of this lane's prefix here
    decode::write_empty<GRP>(part_ml, p0);
    return;
  }

  float qv[GRP][VD];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    decode::widen(decode::load_raw<R>(
        q + b * qsb + (long long)(hk * GRP + g) * qsh + col), qv[g],
                  static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < VD; ++e) qv[g][e] *= scale;
  }

  const long long row = (long long)Hkv * D;   // cache stride per position
  const T* kb = kc + (long long)b * W * row + hk * D + col;
  const T* vb = vc + (long long)b * W * row + hk * D + col;
  decode::split_partial<T, D, GRP, false>(
      qv, j_begin, j_end,
      [&](int j, R& k, R& v) {
        k = decode::load_raw<R>(kb + (long long)j * row);
        v = decode::load_raw<R>(vb + (long long)j * row);
      },
      part_o, part_ml, p0);
}

template <typename T, int D, int GRP>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* length, void* out, float* ws, int L, int W,
                   int H, int Hkv, int NS, long long qsb, long long qsh,
                   float scale, cudaStream_t stream) {
  float* part_o = ws;
  float* part_ml = ws + (long long)NS * L * H * D;
  const int chunk = (W + NS - 1) / NS;
  flash_decode_split<T, D, GRP><<<dim3(Hkv, L, NS), decode::NW * 32, 0,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(length), part_o,
      part_ml, L, W, H, Hkv, chunk, qsb, qsh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return decode::launch_merge<T, D>(ws, out, L, H, NS, stream);
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
