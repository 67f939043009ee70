// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `_flash_forward`):
// fused attention with an online softmax, causal at GLOBAL positions
// q_offset + i >= k_offset + j, an optional sliding-window band
// (q - k < window), grouped-query attention through kv head h / group,
// and the row logsumexp (natural log, f32) written beside the output
// (-inf and a zero output row where every key is masked).
//
// What bounds it on this card: per (batch, head) two [Sq, D] x [D, Sk]
// products (s = q k^T, o = p v; half of each under a causal mask)
// against ~4 tensors of bytes, far above the H100's ~295 flop/byte
// ridge at the training shapes ([8, 2048, 8, 128] bf16, causal), so it
// is bound by operations: tensor-core operations.
//
// bf16 (the training and prefill path): both products on wgmma (bf16
// in, f32 accumulators), fed by TMA.
//  * grid = (H, B, q-tiles), the q-tile index reversed (the last q-tile,
//    the longest causal band, starts first); one warpgroup (128
//    threads) owns 64 q rows and loops over the k-tiles of its band, cut
//    before the loop (the rule of `_band_j0`). The q tile is loaded once;
//    K and V come through a 2-stage ring of TMA loads completed on
//    mbarriers, the next tile's load in flight while this one computes.
//    ~81 KB of shared memory at D = 128, so two blocks share an SM; at
//    D = 256 (Gemma's heads) five 32 KB tiles, ~161 KB, one block an SM.
//  * At D = 256 the o accumulator is 128 floats a thread beside the s
//    tile and p's hi/lo split, and o += p v is two n128 wgmmas per
//    k-step (`sm90::wgmma_rs<256>`); ptxas's registers and spills of
//    that instantiation are checked on the card.
//  * s = q k^T is one SS wgmma per 16-column k-step (both read K-major
//    from the 128-byte swizzle TMA writes). scale * log2(e) multiplies
//    the f32 accumulator (exp2 on the card's MUFU); q stays unscaled
//    bf16, so no rounding the plain version lacks is added.
//  * The online softmax runs in the accumulator registers: a row's 64
//    columns live in the 4 threads of a quad, so the row max reduces
//    with two xor-shuffles; each thread keeps its share of the row sum
//    and the quad sums it once, at the end. A row masked so far keeps
//    m = -inf and shifts by 0 (exp2(-inf) = 0, not NaN).
//  * o += p v runs as two RS wgmmas per k-step: p is split into bf16 hi
//    + bf16 lo (`split_hi_lo`) in the accumulator layout, which is the
//    register A operand, and v is read N-major (transpose bit). p never
//    leaves registers. One bf16 rounding of p misses the f32 plain
//    forward by more than the check's tolerance where a row attends few
//    keys (a narrow window, the first rows of a causal band).
//  * Only tiles that cross the causal diagonal, the window's edge or the
//    ragged end of Sk mask, per element in registers: TMA zero-fills
//    keys past Sk, and a zero score is not a masked one.
//  * Operands are read in place through their [B, S, H, D] strides by
//    4-D tensor maps (q/k/v may be views of the fused qkv projection);
//    o is written as bf16 pairs from registers, lse once per row.
//
// f32: the CUDA-core kernel below (`flash_fwd_kernel`), f32 FMA with q
// pre-scaled: wgmma has no f32 input, and tf32 would not hold the plain
// forward to 1e-5. Its tiles take 55,552 floats (217 KB) at D = 256,
// inside the 227 KB a block may opt into.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // row padding (floats) of the transposed tiles

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

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int WG = 128;   // one warpgroup per block
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdLayout {                      // byte offsets from the aligned base
  static constexpr int TILE = (D / 64) * sm90::BOX_BYTES;   // [64, D] bf16
  static constexpr int Q = 0, K = TILE, V = 3 * TILE;       // K, V: 2 stages
  static constexpr int BARS = 5 * TILE;                     // 3 mbarriers
  static constexpr int BYTES = BARS + 64 + 1024;            // + alignment
};

template <int D>
__global__ void __launch_bounds__(WG, D <= 128 ? 2 : 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
    int H, int group, long long osb, long long oss, long long osh,
    int causal, int window, int q_offset, int k_offset, float scale) {
  using L = FwdLayout<D>;
  constexpr int NA = D / 2;             // o accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_u32(sm);
  const uint32_t sQ = base + L::Q;
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

  // Per row u (ra, ra + 8): running max in log2 units and this thread's
  // share of the running sum.
  float acc[NA], m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  if (n > 0) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) sm90::mbar_init(barQ + 8 * i, 1);
      sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      sm90::mbar_expect_tx(barQ, L::TILE);
      sm90::tma_tile<D>(sQ, &tq, barQ, b, q0, h);
      for (int s = 0; s < min(n, 2); ++s) {
        const uint32_t bar = barQ + 8 * (1 + s);
        sm90::mbar_expect_tx(bar, 2 * L::TILE);
        sm90::tma_tile<D>(base + L::K + s * L::TILE, &tk, bar, b,
                          k_first + 64 * s, hk);
        sm90::tma_tile<D>(base + L::V + s * L::TILE, &tv, bar, b,
                          k_first + 64 * s, hk);
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

      // s = q k^T, [64 q, 64 keys].
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      sm90::fence_regs<32>(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64(s, sm90::desc_kmajor(sQ, kk),
                           sm90::desc_kmajor(sK, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(s);

      // Scores in log2 units; -inf where the tile crosses the diagonal,
      // the window's edge or the end of Sk and the pair is masked.
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
          s[e] = ok ? s[e] * sl2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] *= sl2;
      }

      // Online softmax: new row max over the quad, p = exp2(s - m),
      // rescale of the running sum and of o by exp2(m_old - m_new).
      float corr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 2 * u; e < 32; e += 4)
          mx = fmaxf(mx, fmaxf(s[e], s[e + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m2[u], mx);
        // Rows with every key masked so far keep m == -inf: shift by 0
        // there so exp2(-inf - 0) = 0 instead of NaN.
        const float shift = (m_new == -INFINITY) ? 0.f : m_new;
        corr[u] = (m2[u] == -INFINITY) ? 0.f : exp2f(m2[u] - shift);
        m2[u] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int e = 2 * u; e < 32; e += 4) {
          s[e] = exp2f(s[e] - shift);
          s[e + 1] = exp2f(s[e + 1] - shift);
          ps += s[e] + s[e + 1];
        }
        lsum[u] = lsum[u] * corr[u] + ps;
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] *= corr[(i >> 1) & 1];

      // o += p v, p as hi + lo; v read N-major from the same stage.
      uint32_t hi[16], lo[16];
      sm90::split_hi_lo(s, hi, lo);
      sm90::fence_regs<NA>(acc);
      sm90::fence_regs<16>(hi);
      sm90::fence_regs<16>(lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sm90::desc_nmajor(sV, kk);
        sm90::wgmma_rs<D>(acc, hi + 4 * kk, dv);
        sm90::wgmma_rs<D>(acc, lo + 4 * kk, dv);
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

  // o = acc / l (a row with l = 0 stays 0), bf16 pairs; lse = m + log l.
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float l = lsum[u];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + ra + 8 * u;
    if (qi >= Sq) continue;
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    __nv_bfloat16* row = o + b * osb + (long long)qi * oss + h * osh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c2) =
          __floats2bfloat162_rn(acc[4 * i + 2 * u] * inv,
                                acc[4 * i + 2 * u + 1] * inv);
    if ((lane & 3) == 0)
      lse[((long long)b * H + h) * Sq + qi] =
          (l == 0.f) ? -INFINITY : m2[u] * LN2 + logf(l);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int Hkv,
                 const long long* st, int causal, int window, int q_offset,
                 int k_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = sm90::bshd_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2])) ||
      (err = sm90::bshd_map(&tk, k, B, Sk, Hkv, D, st[3], st[4], st[5])) ||
      (err = sm90::bshd_map(&tv, v, B, Sk, Hkv, D, st[6], st[7], st[8])))
    return err;
  const int smem = FwdLayout<D>::BYTES;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + 63) / 64);
  kern<<<grid, WG, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, H / Hkv,
      st[9], st[10], st[11], causal, window, q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head); the head_dim axis must be contiguous.
// window <= 0 disables the band. Returns cudaGetLastError() after the
// launch (0 = launched), or sm90::ENCODE_ERROR + a CUresult when a
// bf16 operand's tensor map cannot be encoded.
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
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                              window, q_offset, k_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                            window, q_offset, k_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                             window, q_offset, k_offset, scale, s);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, o, l, B, Sq, Sk, H, Hkv, st, causal,
                             window, q_offset, k_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 (wgmma) kernel at head dim D, in
// bytes; 0 for a head dim it does not take.
int flash_fwd_smem_bytes(int D) {
  return D == 64    ? FwdLayout<64>::BYTES
         : D == 128 ? FwdLayout<128>::BYTES
         : D == 256 ? FwdLayout<256>::BYTES
                    : 0;
}

const char* flash_fwd_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
