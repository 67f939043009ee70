// Paged decode for Hopper (sm_90a): one S=1 decode tick of every lane
// against the shared paged KV pool, read through each lane's block
// table; f32 or bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/paged_attention.py, launched by
// `_paged_decode_call`). Each lane attends its positions [0, npos),
// npos = min(fill + 1, T * bs): the first ceil(npos / bs) entries of its
// table, each block's [bs, Hkv, D] rows read from the pool IN PLACE (no
// gather copy), with the current token's k_new / v_new in place of the
// row at `fill` and positions > fill masked; the online softmax is f32
// and the output is written at the input dtype. fill == T * bs (the
// pipelined tick past the budget) attends the whole table and no new
// row.
//
// What bounds it on this card: a tick reads sum(npos) x Hkv x D x 2 (K
// and V) pool elements and does ~4 flops per element per query head of
// the group, so it is bound by bytes, far below the ~295 flop/byte
// ridge. Bytes in flight are what count, and the design keeps them up:
//  * Split each lane's table across the card: grid = (Hkv, lanes, NS).
//    Block (kv head, lane, split) owns table entries [split * ce,
//    (split + 1) * ce), ce = ceil(T / NS): ce * bs positions, always
//    whole pool blocks. The host picks NS from the table span T * bs,
//    Hkv x lanes and the SM count, never from the fills (reading them
//    would sync the tick): splits of at most 512 positions, more where
//    full lanes would not fill the card's resident slots once. 8 lanes x
//    8 kv heads at T = 128, bs = 16 give 4 splits, 256 blocks, one wave
//    on 132 SMs, where one block per (kv head, lane) gave 64; the
//    engine's 16 lanes also 4, their short lanes' later splits empty. A
//    split that starts at or past npos writes the empty partial (m =
//    -inf, l = 0) and returns.
//  * Stage the split's table slice in shared memory once (one coalesced
//    load of at most ce int32), so a row's address costs a shared-memory
//    read, not a dependent device-memory round trip before the row load.
//  * Wide loads and prefetch (decode_split.cuh, shared with
//    flash_decode.cu): each lane loads 16 bytes of a row, so a warp load
//    covers two bf16 rows of 128 (one of 256), and each of the eight
//    warps issues the loads of its next step (8 rows of K and of V at
//    D = 128) before it reduces the current one, so a row load waits on
//    one memory round trip and its latency hides behind the last step's
//    math.
//    Rows at positions >= npos are never read: table entries past a
//    lane's filled blocks may name block 0 or stale blocks.
//  * Each block writes one f32 partial (m, l, unnormalized o) per query
//    head of its group to a workspace; the merge kernel of
//    decode_split.cuh, launched by the same C entry on the same stream,
//    combines them, skipping empty partials. npos >= 1, so split 0 is
//    never empty and no lane merges to nothing.
//
// Arithmetic follows the plain version (the walk at walk_block ==
// block_size): q is scaled by D^-0.5 rounded to the dtype and the
// product rounded to the dtype; p is rounded to the dtype before P.V
// while l sums the unrounded p; softmax state and partials are f32.
// Each thread rounds p against its own running max, not the walk's. The
// bf16 tolerance (2e-3 + 1e-2 |ref|) still holds: bf16's relative
// rounding error (<= 2^-9) does not depend on the scale of the value
// rounded, so another max only changes which bf16 neighbour each p
// takes, every p within 2^-9 of its exact value either way; the
// rescales e^(m - M) and the merges apply to f32 sums and round
// nothing. Kernel and walk then differ by per-key errors of <= 2^-9 p
// |v| in a p-weighted mean, which are of either sign and average out,
// below the final bf16 rounding of the output that the 1e-2 relative
// term allows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

// Table entries a split stages in shared memory; the wrapper picks NS
// so that ceil(T / NS) stays within it
// (ops/paged_attention.py::PAGED_MAX_SPLIT_ENTRIES).
constexpr int MAX_CE = 1024;

// One split of one (kv head, lane): its partial (m, l, o) per query head
// of the group (see decode_split.cuh for the layout).
template <typename T, int D, int GRP>
__global__ void __launch_bounds__(decode::NW * 32) paged_decode_split(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, const int* __restrict__ table,
    const int* __restrict__ fill, const T* __restrict__ kp,
    const T* __restrict__ vp, float* __restrict__ part_o,
    float* __restrict__ part_ml, int L, int H, int Hkv, int bs, int nt,
    int ce, long long qsl, long long qsh, long long ksl, long long ksh,
    long long vsl, long long vsh, float scale) {
  using RW = decode::Row<T, D>;
  constexpr int VD = RW::VD, NC = RW::NC;
  using R = uint4;                               // one 16-byte load
  __shared__ int sm_tab[MAX_CE];

  // This thread's chunks of every row it reads: columns col + c * CSTEP.
  const int col = (threadIdx.x & 31) % RW::LPR * VD;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int f = max(0, fill[b]);
  const int npos = min(f + 1, bs * nt);
  const int e_begin = sp * ce;
  const int e_end = min(e_begin + ce, (npos + bs - 1) / bs);
  const long long p0 = ((long long)sp * L + b) * H + hk * GRP;

  if (e_begin >= e_end) {   // none of the lane's positions here
    decode::write_empty<GRP>(part_ml, p0);
    return;
  }

  // The split's table slice, one coalesced load; the query and the
  // current token's rows are loaded while it lands.
  const int* trow = table + (long long)b * nt + e_begin;
  for (int i = threadIdx.x; i < e_end - e_begin; i += decode::NW * 32)
    sm_tab[i] = trow[i];

  const T* tq = nullptr;
  float qv[GRP][RW::EPT];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      decode::widen(decode::load_raw<R>(
          q + b * qsl + (long long)(hk * GRP + g) * qsh + col + c * RW::CSTEP),
          qv[g] + c * VD, tq);
#pragma unroll
    for (int e = 0; e < RW::EPT; ++e)
      qv[g][e] = decode::round_to(qv[g][e] * scale, tq);
  }
  R knr[NC], vnr[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    knr[c] = decode::load_raw<R>(kn + b * ksl + (long long)hk * ksh + col +
                                 c * RW::CSTEP);
    vnr[c] = decode::load_raw<R>(vn + b * vsl + (long long)hk * vsh + col +
                                 c * RW::CSTEP);
  }
  __syncthreads();

  const long long row = (long long)Hkv * D;   // pool stride per position
  const long long blk = (long long)bs * row;  // pool stride per block
  const T* kb = kp + hk * D + col;
  const T* vb = vp + hk * D + col;
  const int j_begin = e_begin * bs;
  decode::split_partial<T, D, GRP, true>(
      qv, j_begin, min(e_end * bs, npos),
      [&](int j, R (&k)[NC], R (&v)[NC]) {
        if (j == f) {   // the current token's row
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            k[c] = knr[c];
            v[c] = vnr[c];
          }
          return;
        }
        const int rel = j - j_begin;
        const int e = rel / bs;
        const long long off = (long long)sm_tab[e] * blk +
                              (long long)(rel - e * bs) * row;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          k[c] = decode::load_raw<R>(kb + off + c * RW::CSTEP);
          v[c] = decode::load_raw<R>(vb + off + c * RW::CSTEP);
        }
      },
      part_o, part_ml, p0);
}

struct Args {
  const void *q, *kn, *vn, *table, *fill, *kp, *vp;
  void* out;
  float* ws;
  int L, H, Hkv, bs, nt, NS;
  long long qsl, qsh, ksl, ksh, vsl, vsh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GRP>
cudaError_t launch(const Args& a) {
  const int ce = (a.nt + a.NS - 1) / a.NS;
  float* part_o = a.ws;
  float* part_ml = a.ws + (long long)a.NS * a.L * a.H * D;
  paged_decode_split<T, D, GRP><<<dim3(a.Hkv, a.L, a.NS), decode::NW * 32,
                                  0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<const int*>(a.table),
      static_cast<const int*>(a.fill), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), part_o, part_ml, a.L, a.H, a.Hkv, a.bs,
      a.nt, ce, a.qsl, a.qsh, a.ksl, a.ksh, a.vsl, a.vsh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return decode::launch_merge<T, D>(a.ws, a.out, a.L, a.H, a.NS, a.stream);
}

// One instantiation per query-head group 1..8 (the reference's Pallas
// kernel takes any group; 8 covers the families the HF import brings:
// Gemma's 8:1, Qwen2's 7:1 and 6:1, Qwen2.5-32B's 5:1).
template <typename T, int D>
cudaError_t by_group(int grp, const Args& a) {
  switch (grp) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 3: return launch<T, D, 3>(a);
    case 4: return launch<T, D, 4>(a);
    case 5: return launch<T, D, 5>(a);
    case 6: return launch<T, D, 6>(a);
    case 7: return launch<T, D, 7>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int D, int grp, const Args& a) {
  switch (D) {
    case 64: return by_group<T, 64>(grp, a);
    case 128: return by_group<T, 128>(grp, a);
    case 256: return by_group<T, 256>(grp, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [L, H, D] with element strides (qsl, qsh); k_new / v_new [L, Hkv, D]
// with strides (ksl, ksh) / (vsl, vsh); head dims contiguous, D 64, 128
// or 256, H / Hkv 1..8. table
// [L, nt] and fill [L] contiguous int32 on the device; pools
// [num_blocks, bs, Hkv, D] contiguous; out [L, H, D] contiguous; ws a
// float32 workspace of splits * L * H * (D + 2) elements (the
// partials), 1 <= splits, ceil(nt / splits) <= 1024. dtype: 0 =
// float32, 1 = bfloat16. `scale` is D^-0.5 rounded to the dtype.
// Launches the split kernel and the merge kernel on `stream`; returns
// cudaGetLastError() after the first launch that fails, else after the
// merge (0 = both launched).
int paged_decode(const void* q, const void* kn, const void* vn,
                 const void* table, const void* fill, const void* kp,
                 const void* vp, void* out, void* ws, int dtype, int L,
                 int H, int Hkv, int D, int bs, int nt, int splits,
                 long long qsl, long long qsh, long long ksl, long long ksh,
                 long long vsl, long long vsh, float scale, void* stream) {
  if (L <= 0 || Hkv <= 0 || bs <= 0 || nt <= 0 || H % Hkv || splits < 1 ||
      (nt + splits - 1) / splits > MAX_CE)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kn, vn, table, fill, kp, vp, out,
               static_cast<float*>(ws), L, H, Hkv, bs, nt, splits,
               qsl, qsh, ksl, ksh, vsl, vsh, scale,
               static_cast<cudaStream_t>(stream)};
  const int grp = H / Hkv;
  if (dtype == 0) return (int)by_dim<float>(D, grp, a);
  if (dtype == 1) return (int)by_dim<__nv_bfloat16>(D, grp, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
