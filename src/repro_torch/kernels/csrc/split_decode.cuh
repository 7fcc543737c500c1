// Flash-decoding body shared by the slab decode (decode_attention.cu) and
// the paged decode (paged_attention.cu).
//
// One query token per row attends a range of the row's positions.  Kernel 1
// runs one CTA per (split, KV head, row): the split walks its positions
// [s_lo, s_hi) in tiles of 32, loaded by 16-byte cp.async into a
// double-buffered shared-memory ring while the previous tile is computed,
// and writes (m, l, acc[d]) per query head into f32 scratch.  The G (<= 32)
// query heads of the KV head share each tile: their q sits in shared
// memory, warp w takes heads w, w + 4, ...; for Q K^T a lane owns one
// position's whole key row (no shuffle reduction per score), for P V a
// lane owns d / 32 output dims (2, 4 or 8 at d = 64, 128, 256; at d = 256
// an f32 K/V tile pair is 2 x 33 KB, so the two-stage ring takes 130 KB
// and one CTA fits an SM).  Kernel 2 merges a row's splits in split
// order (no atomics: the result does not depend on which split ends
// first).  A warp's head slots HPW (ceil(G / 4) rounded up to 1, 2, 4 or
// 8) are a template parameter, so that a small group does not pay for 8
// slots in its score loop; a head's own sums run in the same order
// whatever HPW is.  Where a position's K/V row lives is the caller's: a
// `Rows` object maps a position to its key and value rows (a strided
// slab, or a page of the pool named by the block table).

#pragma once

#include "paged_common.cuh"

namespace split_decode {

using paged::cp_async16;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::from_f;
using paged::kNegInf;
using paged::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // positions per tile: a lane owns one
constexpr int kMaxG = 32;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tile of kTile positions x D in the K/V's own type; rows
// padded by 16 bytes, so they stay 16-byte aligned and a lane reading its
// own row 16 bytes at a time meets no bank conflict.
template <typename TKV, int D>
struct SplitTile {
  static constexpr int VEC = 16 / sizeof(TKV);          // elements per 16 B
  static constexpr int LD = D + VEC;
  static constexpr int ELEMS = kTile * LD;
  static constexpr int CHUNKS = D / VEC;                 // 16 B per row
  static constexpr int SMEM_KV = 4 * ELEMS * sizeof(TKV);  // K, V x 2
  // the whole dynamic shared memory: the ring, q of G heads, P per warp
  // (sized by G, so that small groups fit more CTAs on an SM)
  static constexpr int smem(int G) {
    return SMEM_KV + (G * D + kWarps * kTile) * 4;
  }
  static constexpr int SMEM_MAX = SMEM_KV + (kMaxG * D + kWarps * kTile) * 4;
};

// Issue positions [p0, p0 + nt) of one KV head into a tile pair.
template <typename TKV, int D, typename Rows>
__device__ __forceinline__ void load_tile(TKV* ks, TKV* vs, const Rows& rows,
                                          int p0, int nt) {
  using L = SplitTile<TKV, D>;
  for (int e = threadIdx.x; e < nt * L::CHUNKS; e += kThreads) {
    const int r = e / L::CHUNKS, c = (e % L::CHUNKS) * L::VEC;
    cp_async16(ks + r * L::LD + c, rows.k(p0 + r) + c);
    cp_async16(vs + r * L::LD + c, rows.v(p0 + r) + c);
  }
}

// n consecutive elements of a shared-memory row as f32
template <int N>
__device__ __forceinline__ void row_f32(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x; x[i + 1] = t.y; x[i + 2] = t.z; x[i + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void row_f32(float (&x)[N],
                                        const __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Scale of q in shared memory: scores go to the exp2 domain, scale *
// log2(e) folded into q, or the softcap first on the natural scale.
__device__ __forceinline__ float q_scale(float scale, float cap) {
  return cap > 0.f ? scale : scale * kLog2e;
}

// Kernel 1's body, after the caller has put the G heads' q, scaled by
// q_scale, into the shared-memory block `smem` (SplitTile::smem(G) bytes:
// the K/V ring, then q, then P).
// Walks positions [s_lo, s_hi) and writes this split's (m, l, acc) of each
// head: ml[2 * idx], ml[2 * idx + 1], acc[idx * D ..] with idx = (head0 +
// g) * n_split + split; a split with no position writes -inf, 0, 0.
template <typename TKV, int D, int HPW, typename Rows>
__device__ __forceinline__ void attend_split(uint8_t* smem, const Rows& rows,
                                             int s_lo, int s_hi, int G,
                                             float cap, long long head0,
                                             int n_split, int split,
                                             float* __restrict__ ml_out,
                                             float* __restrict__ acc_out) {
  using L = SplitTile<TKV, D>;
  constexpr int DPL = D / 32;                       // output dims per lane
  TKV* ks = reinterpret_cast<TKV*>(smem);           // [2][kTile][LD]
  TKV* vs = ks + 2 * L::ELEMS;
  const float* qs = reinterpret_cast<const float*>(smem + L::SMEM_KV);
  float* ps = reinterpret_cast<float*>(smem + L::SMEM_KV) + G * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool capped = cap > 0.f;

  if (s_lo < s_hi) {
    load_tile<TKV, D>(ks, vs, rows, s_lo, min(kTile, s_hi - s_lo));
    cp_async_commit();
  }

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  int st = 0;
  for (int p0 = s_lo; p0 < s_hi; p0 += kTile, st ^= 1) {
    const int nt = min(kTile, s_hi - p0);
    if (p0 + kTile < s_hi) {            // the next tile flies during this one
      load_tile<TKV, D>(ks + (st ^ 1) * L::ELEMS, vs + (st ^ 1) * L::ELEMS,
                        rows, p0 + kTile, min(kTile, s_hi - p0 - kTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // tile st landed, q in place
    const TKV* kt = ks + st * L::ELEMS;
    const TKV* vt = vs + st * L::ELEMS;

    // Q K^T: lane t scores position t of the tile against this warp's heads
    float x[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) x[j] = 0.f;
    if (lane < nt) {
      const TKV* kr = kt + lane * L::LD;
#pragma unroll 4
      for (int i = 0; i < D; i += 4) {
        float kv[4];
        row_f32(kv, kr + i);
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          const int g = warp + kWarps * j;
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + i);
            x[j] += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + kWarps * j;
      if (g >= G) continue;              // uniform over the warp
      float s = x[j];
      if (capped) s = cap * tanhf(s / cap) * kLog2e;
      s = lane < nt ? s : __uint_as_float(0xff800000u);   // -inf
      const float m_new = fmaxf(m[j], warp_max(s));
      const float corr = exp2f(m[j] - m_new);
      m[j] = m_new;
      const float p = exp2f(s - m_new);
      l[j] = l[j] * corr + p;           // this lane's share of the sum
      ps[warp * kTile + lane] = p;
      __syncwarp();
      // P V: lane owns dims lane * DPL .. + DPL
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] *= corr;
      for (int t = 0; t < nt; ++t) {
        const float pt = ps[warp * kTile + t];
        float vv[DPL];
        row_f32(vv, vt + t * L::LD + lane * DPL);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[j][i] += pt * vv[i];
      }
      __syncwarp();
    }
    __syncthreads();                    // tile st free for the load after next
  }

  // (m, l, acc) of this split per head; a split with no position: -inf, 0, 0
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = warp + kWarps * j;
    if (g >= G) continue;
    const float lsum = warp_sum(l[j]);
    const long long idx = (head0 + g) * n_split + split;
    if (lane == 0) {
      ml_out[2 * idx] = lsum > 0.f ? m[j] : __uint_as_float(0xff800000u);
      ml_out[2 * idx + 1] = lsum;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_out[idx * D + lane * DPL + i] = acc[j][i];
  }
}

// Heads per warp for a group of G <= kMaxG heads: 1, 2, 4 or 8.
inline int heads_per_warp(int G) {
  const int need = (G + kWarps - 1) / kWarps;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

// Kernel 2: one CTA per (row, query head), a thread per output dim: the
// row's first n_live splits merged in split order, those with l = 0
// skipped; a row with none writes exact zeros.  n_live is n_split, or with
// split_len > 0 the splits that hold a position of the row's live range
// [0, min(lengths[b], n_pos)), so splits past it are never read.
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
split_merge_kernel(TQ* __restrict__ out, const float* __restrict__ ml_in,
                   const float* __restrict__ acc_in,
                   const int32_t* __restrict__ lengths, int H, int n_split,
                   int split_len, int n_pos, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x, i = threadIdx.x;
  const int b = bh / H, h = bh % H;
  int n_live = n_split;
  if (split_len > 0)
    n_live = (min(max(lengths[b], 0), n_pos) + split_len - 1) / split_len;
  const float* ml = ml_in + (long long)bh * n_split * 2;
  float mx = __uint_as_float(0xff800000u);
  for (int s = 0; s < n_live; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  // a split with l = 0 has acc = 0 and weight 0: adding its +0 leaves
  // the sums' bits as they were, and the loop keeps no branch around its
  // loads, so they run ahead
  float lsum = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float ls = ml[2 * s + 1];
    const float w = ls > 0.f ? exp2f(ml[2 * s] - mx) : 0.f;
    lsum += ls * w;
    o += acc_in[((long long)bh * n_split + s) * D + i] * w;
  }
  out[b * o_sb + h * o_sh + i] = from_f<TQ>(lsum > 0.f ? o / lsum : 0.f);
}

}  // namespace split_decode
