// Split decode shared by the port's two decode kernels: flash_decode.cu
// (each lane's linear KV cache) and paged_decode.cu (the paged pool, read
// through each lane's block table).
//
// A decode tick is bound by bytes: every K/V row of a lane's prefix is
// read once, at ~4 flops a byte. To keep enough bytes in flight the
// lane's rows are split over the card: block (kv head, lane, split)
// folds rows [j_begin, j_end) into one f32 partial per query head of its
// group, and a second kernel on the same stream merges the partials.
//
//  * `split_partial`: eight warps stream disjoint groups of rows. Every
//    load is 16 bytes a thread, neighbouring lanes on neighbouring
//    chunks of a row (coalesced): a row of D elements is CH = D *
//    sizeof(T) / 16 chunks. Where CH <= 32 a row takes LPR = CH lanes, one
//    chunk each, and a warp load covers RPW = 32 / LPR rows (two bf16 rows
//    of 128, one of 256); where CH > 32 (f32 rows of 256) a row takes all
//    32 lanes, NC = CH / 32 chunks each, RPW = 1. Each thread issues U = 4
//    such loads of K and of V per step (U / NC rows), and a warp issues
//    the loads of its next step before it reduces the current one (a
//    register double buffer): a warp keeps 8 bf16 rows of 128 of K and V
//    in flight while it reduces 8 more. Each thread keeps the
//    online-softmax state of its own rows in registers; a warp merges
//    its RPW row groups by shuffles, the block its warps through shared
//    memory, into the partial: row max m, row sum l, unnormalized o. The
//    warps' o rows go through shared memory in one pass, or in two
//    halves of D where they exceed 32 KB (D = 256 at groups of 5 to 8;
//    from group 6 one pass would not fit the 48 KB of static shared
//    memory beside the paged kernel's staged table). Where row j lies is
//    the caller's `load(j, k, v)`.
//  * `write_empty`: the partial of a split that holds none of the lane's
//    rows, (m = -inf, l = 0).
//  * `decode_merge`: o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s
//    with M = max_s m_s, skipping empty partials (e^(-inf - -inf) is
//    NaN). A lane whose partials are all empty gets the zero row.
//
// Partials are indexed ((split * L + lane) * H + head): part_o holds D
// floats each, part_ml the pair (m, l); the workspace is part_o followed
// by part_ml, NS * L * H * (D + 2) floats.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace decode {

constexpr int NW = 8;    // warps per split block
constexpr int U = 4;     // 16-byte loads of K (and of V) a thread issues a step

// How a warp reads rows of D elements of T, 16 bytes a load.
template <typename T, int D> struct Row {
  static constexpr int VD = 16 / sizeof(T);   // elements of one load
  static constexpr int CH = D / VD;           // loads a row
  static constexpr int NC = CH > 32 ? CH / 32 : 1;   // loads a lane, a row
  static constexpr int LPR = CH / NC;         // lanes a row (<= 32)
  static constexpr int RPW = 32 / LPR;        // rows a warp load
  static constexpr int EPT = NC * VD;         // elements a lane holds
  static constexpr int CSTEP = LPR * VD;      // elements between its chunks
  static_assert(CH % NC == 0 && 32 % LPR == 0, "row does not tile a warp");
};

template <typename R>
__device__ __forceinline__ R load_raw(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

// Widen a thread's raw 16 bytes of a row to f32.
__device__ __forceinline__ void widen2(unsigned int r, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  out[0] = a.x; out[1] = a.y;
}
__device__ __forceinline__ void widen(uint4 r, float* out, const __nv_bfloat16*) {
  widen2(r.x, out); widen2(r.y, out + 2); widen2(r.z, out + 4); widen2(r.w, out + 6);
}
__device__ __forceinline__ void widen(uint4 r, float* out, const float*) {
  out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
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

template <int GRP>
__device__ __forceinline__ void write_empty(float* __restrict__ part_ml,
                                            long long p0) {
  if (threadIdx.x < GRP) {
    part_ml[2 * (p0 + threadIdx.x)] = -INFINITY;
    part_ml[2 * (p0 + threadIdx.x) + 1] = 0.f;
  }
}

// The partial of rows [j_begin, j_end), j_begin < j_end, for the GRP
// query heads whose (scaled) elements this thread holds in `qv` (its
// EPT columns: chunk c at (lane % LPR) * VD + c * CSTEP, VD each).
// `load(j, k, v)` fetches this thread's NC raw 16-byte chunks of row j's
// key and value. ROUND_P: p is rounded to T before P.V while l sums the
// unrounded p. Every thread of the block must call it (it synchronizes
// the block).
template <typename T, int D, int GRP, bool ROUND_P, typename Load>
__device__ __forceinline__ void split_partial(
    const float (&qv)[GRP][Row<T, D>::EPT], int j_begin, int j_end,
    const Load& load, float* __restrict__ part_o,
    float* __restrict__ part_ml, long long p0) {
  using RW = Row<T, D>;
  constexpr int VD = RW::VD, NC = RW::NC, LPR = RW::LPR, RPW = RW::RPW,
                EPT = RW::EPT, CSTEP = RW::CSTEP;
  constexpr int UR = U / NC > 0 ? U / NC : 1;   // rows a thread, a step
  constexpr int STEP = NW * UR * RPW;
  // The warps' o rows go through shared memory in PASSES slices of DP
  // columns: one pass where it fits, else two halves of D.
  constexpr int PASSES = NW * GRP * D * 4 > 32768 ? 2 : 1;
  constexpr int DP = D / PASSES;
  __shared__ float sm_m[NW][GRP];
  __shared__ float sm_l[NW][GRP];
  __shared__ float sm_acc[NW][GRP][DP];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int col = (lane % LPR) * VD;
  const T* tq = nullptr;

  float m[GRP], l[GRP], acc[GRP][EPT];
#pragma unroll
  for (int g = 0; g < GRP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  }

  // Step by step a warp covers rows [jw, jw + UR * RPW), this thread rows
  // jw + u * RPW + r; the loop runs on the warp's own jw, uniform across
  // its lanes (the shuffles need every lane).
  int jw = j_begin + w * UR * RPW;
  const int r = lane / LPR;
  uint4 ck[UR][NC], cv[UR][NC];
#pragma unroll
  for (int u = 0; u < UR; ++u) {
#pragma unroll
    for (int c = 0; c < NC; ++c) ck[u][c] = cv[u][c] = uint4{};
    const int j = jw + u * RPW + r;
    if (j < j_end) load(j, ck[u], cv[u]);
  }
  for (; jw < j_end; jw += STEP) {
    // The next step's loads go out before this step is reduced.
    uint4 nk[UR][NC], nv[UR][NC];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
#pragma unroll
      for (int c = 0; c < NC; ++c) nk[u][c] = nv[u][c] = uint4{};
      const int j = jw + STEP + u * RPW + r;
      if (j < j_end) load(j, nk[u], nv[u]);
    }
    float s[UR][GRP];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      float kv[EPT];
#pragma unroll
      for (int c = 0; c < NC; ++c) widen(ck[u][c], kv + c * VD, tq);
#pragma unroll
      for (int g = 0; g < GRP; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) part = fmaf(qv[g][e], kv[e], part);
        s[u][g] = part;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UR; ++u)
#pragma unroll
        for (int g = 0; g < GRP; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      // A thread may hold no valid row this step (the split's last one).
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < UR; ++u)
        if (jw + u * RPW + r < j_end) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[g][e] *= corr;
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (jw + u * RPW + r < j_end) {
        float vv[EPT];
#pragma unroll
        for (int c = 0; c < NC; ++c) widen(cv[u][c], vv + c * VD, tq);
#pragma unroll
        for (int g = 0; g < GRP; ++g) {
          const float p = expf(s[u][g] - m[g]);
          const float pv = ROUND_P ? round_to(p, tq) : p;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[g][e] = fmaf(pv, vv[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UR; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ck[u][c] = nk[u][c];
        cv[u][c] = nv[u][c];
      }
  }

  // Merge the warp's RPW row groups (lanes equal mod LPR hold the same
  // columns).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = (m[g] == -INFINITY) ? 0.f : expf(m[g] - mn);
      const float b = (mo == -INFINITY) ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * b;
      }
      m[g] = mn;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
  }
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int d0 = pass * DP;   // this pass's columns [d0, d0 + DP)
    if (lane < LPR) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int cx = col + c * CSTEP - d0;   // a chunk lies in one pass
        if (cx >= 0 && cx < DP) {
#pragma unroll
          for (int g = 0; g < GRP; ++g)
#pragma unroll
            for (int e = 0; e < VD; ++e)
              sm_acc[w][g][cx + e] = acc[g][c * VD + e];
        }
      }
    }
    __syncthreads();

    // The block's partial. Warp 0 holds row j_begin, so M is finite.
    for (int idx = threadIdx.x; idx < GRP * DP; idx += NW * 32) {
      const int g = idx / DP, d = idx % DP;
      float M = -INFINITY;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
      float Lsum = 0.f, A = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) {
        if (sm_m[ww][g] == -INFINITY) continue;   // this warp saw no row
        const float wt = expf(sm_m[ww][g] - M);
        Lsum = fmaf(sm_l[ww][g], wt, Lsum);
        A = fmaf(sm_acc[ww][g][d], wt, A);
      }
      part_o[(p0 + g) * D + d0 + d] = A;
      if (pass == 0 && d == 0) {
        part_ml[2 * (p0 + g)] = M;
        part_ml[2 * (p0 + g) + 1] = Lsum;
      }
    }
    if (pass + 1 < PASSES) __syncthreads();   // sm_acc is refilled
  }
}

// Merge the NS partials of (query head h, lane b) into out [L, H, D].
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_merge(
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

// Launch the merge of the NS partials in workspace `ws` into `out` on
// `stream`; returns cudaGetLastError() after the launch.
template <typename T, int D>
cudaError_t launch_merge(const float* ws, void* out, int L, int H, int NS,
                         cudaStream_t stream) {
  decode_merge<T, D><<<dim3(H, L), D, 0, stream>>>(
      ws, ws + (long long)NS * L * H * D, static_cast<T*>(out), L, H, NS);
  return cudaGetLastError();
}

}  // namespace decode
