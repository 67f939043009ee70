// Flash-attention backward, dQ, for Hopper (sm_90a).
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
// What bounds it on this card: per (batch, head) three [Sq, D] x [D, Sk]
// products (s, dO v^T, ds k) against ~5 tensors of bytes, far above the
// H100's ~295 flop/byte ridge at the training shapes ([8, 2048, 8, 128]
// bf16, causal), so it is bound by operations: tensor-core operations.
//
// bf16 (the training path): every product on wgmma (bf16 in, f32
// accumulators), fed by TMA.
//  * grid = (H, B, q-tiles), the q-tile index reversed (the last q-tile,
//    the longest causal band, starts first); one warpgroup (128
//    threads) owns 64 q rows and loops over the k-tiles of its band.
//    The q and dO tiles stay in shared memory; K and V come through a
//    2-stage ring of TMA loads completed on mbarriers, the next tile's
//    load in flight while this one computes. ~97 KB of shared memory at
//    D = 128, so two blocks share an SM; at D = 256 (Gemma's heads) six
//    32 KB tiles, ~193 KB, one block an SM.
//  * At D = 256 the dq accumulator is [64, 256] f32, 128 floats a
//    thread beside the s and dp tiles (64) and ds's hi/lo split (32):
//    one warpgroup still holds it (221 registers, no spill; checked on
//    the card each run), and dq += ds k is two n128 wgmmas per k-step
//    (`sm90::wgmma_rs<256>`).
//  * s = q k^T and dp = dO v^T are two SS wgmmas (K-major descriptors
//    into the 128-byte swizzle TMA writes); p and ds are formed in the
//    accumulator registers, whose layout is the register A operand of
//    dq += ds k (k read N-major with the transpose bit). p and ds never
//    leave registers.
//  * ds goes in as bf16 hi + bf16 lo, two wgmmas on the same k
//    descriptor: one bf16 rounding of ds would miss the f32 plain
//    backward by more than the check's tolerance at the path shape.
//    scale multiplies the f32 s accumulator and the final dq; q stays
//    unscaled bf16.
//  * Only tiles that cross the causal diagonal, the window's edge or the
//    ragged end of Sk mask, per element in registers; rows past Sq and
//    rows whose lse is -inf get lse = +inf, so p = 0 without a branch.
//  * Operands are read in place through their [B, S, H, D] strides by
//    4-D tensor maps (q/k/v may be views of the fused qkv projection);
//    TMA zero-fills the ragged tail of S. No atomics: dq is written once.
//
// f32: the CUDA-core kernel below (`flash_bwd_dq_kernel`), f32 FMA with
// q pre-scaled: wgmma has no f32 input, and tf32 would not hold the
// plain backward to 1e-5. It is the anchor that matches the plain
// version bit for bit at the path shape. At D = 256 its K/V tiles hold
// 32 keys (`F32Tile`): four [64, 256] f32 tiles would not fit the 227 KB
// a block may use; with 32 they take 214,528 bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the shared tiles
constexpr int LQ = BQ + PAD;

// Keys per tile of the f32 kernel (see the note above).
template <int D>
struct F32Tile { static constexpr int BK = D == 256 ? 32 : 64; };

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
  // Qt, dOt [D][LQ]; Ks, Vs [BK][D+PAD]; DsT [BK][LQ]
  return 2 * D * LQ + 2 * F32Tile<D>::BK * (D + PAD) + F32Tile<D>::BK * LQ;
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
  constexpr int BK = F32Tile<D>::BK;   // keys per tile
  constexpr int JK = BK / 16;       // keys a thread takes in s and dp
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
  // cg + 16 * jj (jj < JK) of the k-tile, for dq the columns
  // g * 64 + c0 + e.
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
    float s[4][JK], dp[4][JK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LQ + r0]);
      const float4 gg = *reinterpret_cast<const float4*>(&dOt[d * LQ + r0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
      float kv[JK], vv[JK];
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        kv[j] = Ks[(cg + 16 * j) * LD + d];
        vv[j] = Vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

    // ds = p * (dp - dvec), p = exp(s - lse) where the mask keeps the
    // pair and lse is finite, else 0; stored transposed.
#pragma unroll
    for (int j = 0; j < JK; ++j) {
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

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int WG = 128;   // one warpgroup per block

template <int D>
struct DqLayout {                       // byte offsets from the aligned base
  static constexpr int TILE = (D / 64) * sm90::BOX_BYTES;   // [64, D] bf16
  static constexpr int Q = 0, G = TILE, K = 2 * TILE, V = 4 * TILE;
  static constexpr int BARS = 6 * TILE;                     // 3 mbarriers
  static constexpr int BYTES = BARS + 64 + 1024;            // + alignment
};

template <int D>
__global__ void __launch_bounds__(WG, D <= 128 ? 2 : 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int group,
    long long osb, long long oss, long long osh, int causal, int window,
    int q_offset, int k_offset, float scale) {
  using L = DqLayout<D>;
  constexpr int NA = D / 2;             // dq accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_u32(sm);
  const uint32_t sQ = base + L::Q, sG = base + L::G;
  const uint32_t barQ = base + L::BARS;          // then barKV[2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;   // heaviest first
  const int hk = h / group;
  // This thread's accumulator rows (and +8) and first column pair.
  const int ra = 16 * warp + (lane >> 2);
  const int c2 = 2 * (lane & 3);

  // Key range of this q-tile's band (local key indices).
  const int q_last = min(q0 + 64, Sq) - 1;
  int j_hi = Sk - 1, j_lo = 0;
  if (causal) {
    j_hi = min(j_hi, q_offset + q_last - k_offset);
    if (window > 0) j_lo = max(0, q_offset + q0 - (window - 1) - k_offset);
  }
  const int k_first = (j_lo / 64) * 64;
  const int n = j_hi >= k_first ? (j_hi - k_first) / 64 + 1 : 0;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  if (n > 0) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) sm90::mbar_init(barQ + 8 * i, 1);
      sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      sm90::mbar_expect_tx(barQ, 2 * L::TILE);
      sm90::tma_tile<D>(sQ, &tq, barQ, b, q0, h);
      sm90::tma_tile<D>(sG, &tg, barQ, b, q0, h);
      for (int s = 0; s < min(n, 2); ++s) {
        const uint32_t bar = barQ + 8 * (1 + s);
        sm90::mbar_expect_tx(bar, 2 * L::TILE);
        sm90::tma_tile<D>(base + L::K + s * L::TILE, &tk, bar, b,
                          k_first + 64 * s, hk);
        sm90::tma_tile<D>(base + L::V + s * L::TILE, &tv, bar, b,
                          k_first + 64 * s, hk);
      }
    }
    // Rows' lse (as log2, +inf where p must be 0) and dvec.
    float l2[2], dv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int qi = q0 + ra + 8 * u;
      l2[u] = INFINITY;
      dv[u] = 0.f;
      if (qi < Sq) {
        const long long at = ((long long)b * H + h) * Sq + qi;
        const float l = lse[at];
        if (l != -INFINITY) l2[u] = l * sm90::LOG2E;
        dv[u] = dvec[at];
      }
    }
    const float sl2 = scale * sm90::LOG2E;
    sm90::mbar_wait(barQ, 0);

    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      const int k0 = k_first + 64 * it;
      const uint32_t sK = base + L::K + st * L::TILE;
      const uint32_t sV = base + L::V + st * L::TILE;
      sm90::mbar_wait(barQ + 8 * (1 + st), (it >> 1) & 1);

      // s = q k^T and dp = dO v^T, [64 q, 64 keys] each.
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      sm90::fence_regs<32>(s);
      sm90::fence_regs<32>(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64(s, sm90::desc_kmajor(sQ, kk),
                           sm90::desc_kmajor(sK, kk), 1);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64(dp, sm90::desc_kmajor(sG, kk),
                           sm90::desc_kmajor(sV, kk), 1);
      sm90::wgmma_commit();

      // p = exp(scale s - lse) while dp is in flight; masked where the
      // tile crosses the diagonal, the window's edge or the end of Sk.
      sm90::wgmma_wait<1>();
      sm90::fence_regs<32>(s);
      bool edge = k0 + 64 > Sk;
      if (causal) {
        edge |= q_offset + q0 < k_offset + k0 + 63;
        if (window > 0) edge |= q_offset + q0 + 63 - (k_offset + k0) >= window;
      }
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qp = q_offset + q0 + ra + 8 * ((e >> 1) & 1);
          const int kj = k0 + 8 * (e >> 2) + c2 + (e & 1);
          const int kp = k_offset + kj;
          bool ok = kj < Sk;
          if (causal) {
            ok = ok && qp >= kp;
            if (window > 0) ok = ok && qp - kp < window;
          }
          s[e] = ok ? exp2f(fmaf(s[e], sl2, -l2[(e >> 1) & 1])) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = exp2f(fmaf(s[e], sl2, -l2[(e >> 1) & 1]));
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - dv[(e >> 1) & 1]);

      // dq += ds k, ds as hi + lo; k read N-major from the same stage.
      uint32_t hi[16], lo[16];
      sm90::split_hi_lo(dp, hi, lo);
      sm90::fence_regs<NA>(acc);
      sm90::fence_regs<16>(hi);
      sm90::fence_regs<16>(lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dk = sm90::desc_nmajor(sK, kk);
        sm90::wgmma_rs<D>(acc, hi + 4 * kk, dk);
        sm90::wgmma_rs<D>(acc, lo + 4 * kk, dk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<NA>(acc);
      sm90::fence_regs<16>(hi);
      sm90::fence_regs<16>(lo);

      __syncthreads();   // every warp is done with this stage
      if (tid == 0 && it + 2 < n) {
        const uint32_t bar = barQ + 8 * (1 + st);
        sm90::mbar_expect_tx(bar, 2 * L::TILE);
        sm90::tma_tile<D>(sK, &tk, bar, b, k0 + 128, hk);
        sm90::tma_tile<D>(sV, &tv, bar, b, k0 + 128, hk);
      }
    }
  }

  // dq = scale * sum_j ds k, written once (bf16 pairs).
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = q0 + ra + 8 * u;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + b * osb + (long long)qi * oss + h * osh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c2) =
          __floats2bfloat162_rn(acc[4 * i + 2 * u] * scale,
                                acc[4 * i + 2 * u + 1] * scale);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dq, int B, int Sq, int Sk, int H, int Hkv,
                 const long long* st, int causal, int window, int q_offset,
                 int k_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  int err;
  if ((err = sm90::bshd_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2])) ||
      (err = sm90::bshd_map(&tk, k, B, Sk, Hkv, D, st[3], st[4], st[5])) ||
      (err = sm90::bshd_map(&tv, v, B, Sk, Hkv, D, st[6], st[7], st[8])) ||
      (err = sm90::bshd_map(&tg, dout, B, Sq, H, D, st[9], st[10], st[11])))
    return err;
  const int smem = DqLayout<D>::BYTES;
  auto kern = flash_bwd_dq_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + 63) / 64);
  kern<<<grid, WG, smem, stream>>>(
      tq, tk, tv, tg, lse, dvec, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H,
      H / Hkv, st[12], st[13], st[14], causal, window, q_offset, k_offset,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head) for q, k, v, dO and dq; the head_dim axis
// must be contiguous. lse and dvec are contiguous [B, H, Sq] float32.
// window <= 0 disables the band. Returns cudaGetLastError() after the
// launch (0 = launched), or sm90::ENCODE_ERROR + a CUresult when a
// bf16 operand's tensor map cannot be encoded.
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
    return launch_wgmma<64>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv, st,
                            causal, window, q_offset, k_offset, scale, s);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv,
                              st, causal, window, q_offset, k_offset,
                              scale, s);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv,
                             st, causal, window, q_offset, k_offset, scale,
                             s);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, dout, l, dv, dq, B, Sq, Sk, H, Hkv,
                             st, causal, window, q_offset, k_offset, scale,
                             s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 (wgmma) kernel at head dim D, in
// bytes; 0 for a head dim it does not take.
int flash_bwd_dq_smem_bytes(int D) {
  return D == 64    ? DqLayout<64>::BYTES
         : D == 128 ? DqLayout<128>::BYTES
         : D == 256 ? DqLayout<256>::BYTES
                    : 0;
}

const char* flash_bwd_dq_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
