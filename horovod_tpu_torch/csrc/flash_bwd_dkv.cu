// Flash-attention backward, dK and dV, for Hopper (sm_90a).
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
// What bounds it on this card: per (batch, head) four [Sk, D] x [D, Sq]
// products (s, dO v^T, p^T dO, ds^T q) against ~6 tensors of bytes, far
// above the H100's ~295 flop/byte ridge at the training shapes ([8,
// 2048, 8, 128] bf16, causal), so it is bound by tensor-core operations.
//
// bf16 (the training path): every product on wgmma (bf16 in, f32
// accumulators), fed by TMA.
//  * grid = (Hkv, B, k-tiles): k-tile 0, the longest causal band, starts
//    first. One warpgroup (128 threads) owns 64 keys of one kv head,
//    keeps K and V in shared memory and loops over the group's query
//    heads x the q-tiles of the tile's band (the TPU kernel's sequential
//    inner grid axis); q and dO come through a 2-stage ring of TMA loads
//    completed on mbarriers, the next tile's load in flight while this
//    one computes. ~99 KB of shared memory at D = 128: two blocks an SM.
//  * At D = 256 (Gemma's heads) dk and dv would be two [64, 256] f32
//    accumulators, 256 registers a thread in one warpgroup, over the
//    limit of 255. Two warpgroups (256 threads) split D instead: each
//    owns 128 columns of dk and dv (the same 128 accumulator floats a
//    thread as D = 128) and computes the full s^T and dp^T itself, from
//    the shared K/V and q/dO tiles. That costs 1.5x the tensor-core work
//    (s^T and dp^T twice, the two gradient products once), but needs no
//    exchange of partial products through shared memory and no named
//    barrier: a right, simple kernel first. Six 32 KB tiles (K, V and a
//    2-stage q/dO ring), ~194 KB of shared memory, one block an SM.
//  * s^T = k q^T and dp^T = v dO^T are SS wgmmas with the keys as M, so
//    p^T and ds^T come out in the accumulator layout, which is the
//    register A operand of dv += p^T dO and dk += ds^T q (dO and q read
//    N-major with the transpose bit). p and ds never leave registers; dk
//    and dv (two 64 x D f32 accumulators) stay in registers throughout.
//  * p and ds go in as bf16 hi + bf16 lo, two wgmmas on the same B
//    descriptor: one bf16 rounding of each would miss the f32 plain
//    backward by more than the check's tolerance at the path shape.
//    scale multiplies the f32 s accumulator and the final dk; q stays
//    unscaled bf16.
//  * Only tiles that cross the causal diagonal or the window's edge
//    mask, per element in registers. Each q row's lse (as log2; +inf
//    past Sq or where lse is -inf, so p = 0 without a branch) and dvec
//    are staged in shared memory beside its tile.
//  * Operands are read in place through their [B, S, H, D] strides by
//    4-D tensor maps (q/k/v may be views of the fused qkv projection);
//    TMA zero-fills the ragged tail of S.
//
// f32: the CUDA-core kernel below (`flash_bwd_dkv_kernel`), f32 FMA with
// q pre-scaled: wgmma has no f32 input, and tf32 would not hold the
// plain backward to 1e-5. It is the anchor that matches the plain
// version at the path shape: each query head's sums are folded into
// the dK/dV rows in turn, the plain version's order. At D = 256 its
// q/dO tiles hold 32 rows (`F32Tile`): with 64 the tiles would not fit
// the 227 KB a block may use; with 32 they take 223,488 bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;    // keys per block
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the shared tiles
constexpr int LK = BK + PAD;

// q rows per tile of the f32 kernel (see the note above).
template <int D>
struct F32Tile { static constexpr int BQ = D == 256 ? 32 : 64; };

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };

// One 16-byte load.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

template <int D>
constexpr int smem_floats() {
  // Kt, Vt [D][LK]; Qs, dOs [BQ][D+PAD]; Ps, dSs [BQ][LK]; lse, dvec [BQ]
  constexpr int BQ = F32Tile<D>::BQ;
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
  constexpr int BQ = F32Tile<D>::BQ;   // q rows per tile
  constexpr int IQ = BQ / 16;       // queries a thread takes in s and dp
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
  // cg + 16 * ii (ii < IQ) of the q-tile, for dk/dv the columns
  // g * 64 + c0 + e.
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int j0 = rg * 4;
  const int c0 = cg * 4;

  float dk_acc[4][OG * 4], dv_acc[4][OG * 4];

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
    // This head's sums over its queries; folded into the dK/dV rows
    // after its last q-tile (below).
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < OG * 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;
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
      float s[4][IQ], dp[4][IQ];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < IQ; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&Kt[d * LK + j0]);
        const float4 w = *reinterpret_cast<const float4*>(&Vt[d * LK + j0]);
        const float kv[4] = {a.x, a.y, a.z, a.w};
        const float vv[4] = {w.x, w.y, w.z, w.w};
        float qv[IQ], gv[IQ];
#pragma unroll
        for (int i = 0; i < IQ; ++i) {
          qv[i] = Qs[(cg + 16 * i) * LD + d];
          gv[i] = dOs[(cg + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < IQ; ++i) {
            s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
            dp[j][i] = fmaf(vv[j], gv[i], dp[j][i]);
          }
      }

      // p = exp(s - lse) where the mask keeps the pair and lse is
      // finite, else 0; ds = p * (dp - dvec). Stored [query][key].
#pragma unroll
      for (int i = 0; i < IQ; ++i) {
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

    // Fold this head into the dK/dV rows at kv width (q already carried
    // scale): the first head stores, the others add in turn — the plain
    // version's order (a per-head sum over the queries, then the
    // group's heads one by one), so that f32 sums over a large group
    // (Gemma's 8 heads x 2048 queries) do not drift from it. Each
    // thread owns its elements: no atomics.
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
          T* kp = krow + g * 64 + c0 + e;
          T* vp = vrow + g * 64 + c0 + e;
          const bool first = hq == hk * group;
          const float ka = dk_acc[j][g * 4 + e], va = dv_acc[j][g * 4 + e];
          store1(kp, first ? ka : *kp + ka);
          store1(vp, first ? va : *vp + va);
        }
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

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int WG = 128;   // threads of one warpgroup

// Warpgroups that split dk/dv's columns: two at D = 256 (see the note
// above), else one.
template <int D>
constexpr int dkv_warpgroups() { return D == 256 ? 2 : 1; }

template <int D>
struct DkvLayout {                      // byte offsets from the aligned base
  static constexpr int TILE = (D / 64) * sm90::BOX_BYTES;   // [64, D] bf16
  static constexpr int K = 0, V = TILE, Q = 2 * TILE, G = 4 * TILE;
  static constexpr int VEC = 6 * TILE;  // a stage: lse (log2), dvec [64]
  static constexpr int BARS = VEC + 2 * 128 * 4;            // 3 mbarriers
  static constexpr int BYTES = BARS + 64 + 1024;            // + alignment
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * WG, D <= 128 ? 2 : 1)
flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int Sq, int Sk, int H, int group, long long dksb, long long dkss,
    long long dksh, long long dvsb, long long dvss, long long dvsh,
    int causal, int window, int q_offset, int k_offset, float scale) {
  using L = DkvLayout<D>;
  constexpr int DC = D / NWG;           // dk/dv columns a warpgroup owns
  constexpr int NA = DC / 2;            // floats a thread, each of dk, dv
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_u32(sm);
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t barKV = base + L::BARS;         // then barQG[2]
  float* vec = reinterpret_cast<float*>(sm + L::VEC);

  const int tid = threadIdx.x;
  const int wg = tid / WG;              // this warpgroup's column block
  const int warp = (tid % WG) >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * 64;       // k-tile 0, the longest band, first
  // This thread's accumulator rows (keys; and +8) and first column pair.
  const int ra = 16 * warp + (lane >> 2);
  const int c2 = 2 * (lane & 3);

  // Query range of this k-tile's band (local query indices): causal
  // rows start at the tile's first key, windowed rows end window - 1
  // past its last.
  const int k_last = min(k0 + 64, Sk) - 1;
  int i_lo = 0, i_hi = Sq - 1;
  if (causal) {
    i_lo = max(0, k_offset + k0 - q_offset);
    if (window > 0)
      i_hi = min(i_hi, k_offset + k_last + window - 1 - q_offset);
  }
  const int t_first = (i_lo / 64) * 64;
  const int nt = i_hi >= t_first ? (i_hi - t_first) / 64 + 1 : 0;
  const int n = group * nt;             // the group's heads x q-tiles

  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n > 0) {
    const CUtensorMap* mq = &tq;
    const CUtensorMap* mg = &tg;
    // Item `it` = (query head, q-tile); its rows' lse (as log2, +inf
    // where p must be 0) and dvec go to stage `st` of `vec`, written by
    // the first 128 threads.
    auto fill_vec = [&](int it, int st) {
      if (tid >= 128) return;
      const int hq = hk * group + it / nt;
      const int qi = t_first + 64 * (it % nt) + (tid & 63);
      const long long at = ((long long)b * H + hq) * Sq + qi;
      float val = tid < 64 ? INFINITY : 0.f;
      if (qi < Sq) {
        if (tid < 64) {
          const float l = lse[at];
          if (l != -INFINITY) val = l * sm90::LOG2E;
        } else {
          val = dvec[at];
        }
      }
      vec[st * 128 + tid] = val;
    };
    auto load_qg = [&](int it, int st) {
      const int hq = hk * group + it / nt;
      const int t0 = t_first + 64 * (it % nt);
      const uint32_t bar = barKV + 8 * (1 + st);
      sm90::mbar_expect_tx(bar, 2 * L::TILE);
      sm90::tma_tile<D>(base + L::Q + st * L::TILE, mq, bar, b, t0, hq);
      sm90::tma_tile<D>(base + L::G + st * L::TILE, mg, bar, b, t0, hq);
    };
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) sm90::mbar_init(barKV + 8 * i, 1);
      sm90::mbar_fence_init();
    }
    fill_vec(0, 0);
    if (n > 1) fill_vec(1, 1);
    __syncthreads();
    if (tid == 0) {
      sm90::mbar_expect_tx(barKV, 2 * L::TILE);
      sm90::tma_tile<D>(sK, &tk, barKV, b, k0, hk);
      sm90::tma_tile<D>(sV, &tv, barKV, b, k0, hk);
      for (int st = 0; st < min(n, 2); ++st) load_qg(st, st);
    }
    const float sl2 = scale * sm90::LOG2E;
    sm90::mbar_wait(barKV, 0);

    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      const int t0 = t_first + 64 * (it % nt);
      const uint32_t sQ = base + L::Q + st * L::TILE;
      const uint32_t sG = base + L::G + st * L::TILE;
      const float* l2s = vec + st * 128;
      const float* dvs = l2s + 64;
      sm90::mbar_wait(barKV + 8 * (1 + st), (it >> 1) & 1);

      // s^T = k q^T and dp^T = v dO^T, [64 keys, 64 q] each.
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      sm90::fence_regs<32>(s);
      sm90::fence_regs<32>(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64(s, sm90::desc_kmajor(sK, kk),
                           sm90::desc_kmajor(sQ, kk), 1);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64(dp, sm90::desc_kmajor(sV, kk),
                           sm90::desc_kmajor(sG, kk), 1);
      sm90::wgmma_commit();

      // p^T = exp(scale s^T - lse) while dp^T is in flight; masked where
      // the tile crosses the diagonal or the window's edge (rows past Sq
      // have lse +inf, keys past Sk are never written).
      sm90::wgmma_wait<1>();
      sm90::fence_regs<32>(s);
      bool edge = false;
      if (causal) {
        edge = q_offset + t0 < k_offset + k0 + 63;
        if (window > 0) edge |= q_offset + t0 + 63 - (k_offset + k0) >= window;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(l2s + 8 * i + c2);
#pragma unroll
        for (int e = 4 * i; e < 4 * i + 4; ++e) {
          const float x = exp2f(fmaf(s[e], sl2, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int qp = q_offset + t0 + 8 * i + c2 + (e & 1);
            const int kp = k_offset + k0 + ra + 8 * ((e >> 1) & 1);
            bool ok = qp >= kp;
            if (window > 0) ok = ok && qp - kp < window;
            s[e] = ok ? x : 0.f;
          } else {
            s[e] = x;
          }
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(dp);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d2 = *reinterpret_cast<const float2*>(dvs + 8 * i + c2);
#pragma unroll
        for (int e = 4 * i; e < 4 * i + 4; ++e)
          dp[e] = s[e] * (dp[e] - ((e & 1) ? d2.y : d2.x));
      }

      // dv += p^T dO and dk += ds^T q over this warpgroup's columns, p
      // and ds as hi + lo; dO and q read N-major from this stage.
      const uint32_t col = wg * (DC / 64) * sm90::BOX_BYTES;
      uint32_t ph[16], pl[16], dh[16], dl[16];
      sm90::split_hi_lo(s, ph, pl);
      sm90::fence_regs<NA>(acc_v);
      sm90::fence_regs<16>(ph);
      sm90::fence_regs<16>(pl);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dg = sm90::desc_nmajor(sG + col, kk);
        sm90::wgmma_rs<DC>(acc_v, ph + 4 * kk, dg);
        sm90::wgmma_rs<DC>(acc_v, pl + 4 * kk, dg);
      }
      sm90::wgmma_commit();
      sm90::split_hi_lo(dp, dh, dl);
      sm90::fence_regs<NA>(acc_k);
      sm90::fence_regs<16>(dh);
      sm90::fence_regs<16>(dl);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dq_ = sm90::desc_nmajor(sQ + col, kk);
        sm90::wgmma_rs<DC>(acc_k, dh + 4 * kk, dq_);
        sm90::wgmma_rs<DC>(acc_k, dl + 4 * kk, dq_);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<NA>(acc_v);
      sm90::fence_regs<NA>(acc_k);
      sm90::fence_regs<16>(ph);
      sm90::fence_regs<16>(pl);
      sm90::fence_regs<16>(dh);
      sm90::fence_regs<16>(dl);

      __syncthreads();   // every warp is done with this stage
      if (it + 2 < n) {
        if (tid == 0) load_qg(it + 2, st);
        fill_vec(it + 2, st);   // read after the next iteration's barrier
      }
    }
  }

  // Each dK/dV row written once, at kv width (dk = scale * sum ds^T q).
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int kj = k0 + ra + 8 * u;
    if (kj >= Sk) continue;
    __nv_bfloat16* krow =
        dk + b * dksb + (long long)kj * dkss + hk * dksh + wg * DC;
    __nv_bfloat16* vrow =
        dv + b * dvsb + (long long)kj * dvss + hk * dvsh + wg * DC;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i + c2) =
          __floats2bfloat162_rn(acc_k[4 * i + 2 * u] * scale,
                                acc_k[4 * i + 2 * u + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i + c2) =
          __floats2bfloat162_rn(acc_v[4 * i + 2 * u],
                                acc_v[4 * i + 2 * u + 1]);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
                 const long long* st, int causal, int window, int q_offset,
                 int k_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  int err;
  if ((err = sm90::bshd_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2])) ||
      (err = sm90::bshd_map(&tk, k, B, Sk, Hkv, D, st[3], st[4], st[5])) ||
      (err = sm90::bshd_map(&tv, v, B, Sk, Hkv, D, st[6], st[7], st[8])) ||
      (err = sm90::bshd_map(&tg, dout, B, Sq, H, D, st[9], st[10], st[11])))
    return err;
  const int smem = DkvLayout<D>::BYTES;
  constexpr int NWG = dkv_warpgroups<D>();
  auto kern = flash_bwd_dkv_wgmma<D, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hkv, B, (Sk + 63) / 64);
  kern<<<grid, NWG * WG, smem, stream>>>(
      tq, tk, tv, tg, lse, dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, H / Hkv, st[12], st[13],
      st[14], st[15], st[16], st[17], causal, window, q_offset, k_offset,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head) for q, k, v, dO, dk and dv; the head_dim
// axis must be contiguous. lse and dvec are contiguous [B, H, Sq]
// float32. window <= 0 disables the band. Returns cudaGetLastError()
// after the launch (0 = launched), or sm90::ENCODE_ERROR + a CUresult
// when a bf16 operand's tensor map cannot be encoded.
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
    return launch_wgmma<64>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                            Hkv, st, causal, window, q_offset, k_offset,
                            scale, s);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                              Hkv, st, causal, window, q_offset, k_offset,
                              scale, s);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                             Hkv, st, causal, window, q_offset, k_offset,
                             scale, s);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, dout, l, dvp, dk, dv, B, Sq, Sk, H,
                             Hkv, st, causal, window, q_offset, k_offset,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 (wgmma) kernel at head dim D, in
// bytes; 0 for a head dim it does not take.
int flash_bwd_dkv_smem_bytes(int D) {
  return D == 64    ? DkvLayout<64>::BYTES
         : D == 128 ? DkvLayout<128>::BYTES
         : D == 256 ? DkvLayout<256>::BYTES
                    : 0;
}

const char* flash_bwd_dkv_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
