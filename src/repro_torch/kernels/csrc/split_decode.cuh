// Flash-decoding bodies shared by the slab decode (decode_attention.cu)
// and the paged decode (paged_attention.cu).
//
// One query token per row attends a range of the row's positions.  Kernel 1
// runs one CTA of 4 warps per (split, KV head, row) and writes, per query
// head, this split's (m, l, acc[d]) into f32 scratch; kernel 2
// (split_merge_kernel) merges a row's splits in split order (no atomics:
// the result does not depend on which split ends first).  Where a
// position's K/V row lives is the caller's: a `Rows` object maps a
// position to its key and value rows (a strided slab, or a page of the
// pool named by the block table).  Kernel 1 has two bodies:
//
// bf16 q (every call of the serving engine; f32 or bf16 K/V):
// attend_split_mma, on the tensor cores, transposed: a warp's 16
// positions are mma.sync's M rows and the G (<= 8 a CTA; a larger group
// takes a CTA per block of 8) query heads of the KV head its N columns,
// S^T = K Q^T and O^T = V^T P^T, so the products of a group of G <= 8
// (every registered config) cost 8 columns, not 16 padded rows.  The
// split's positions come in tiles of 64; warp w owns the w-th 16 of every
// tile, so no warp reads another's rows, and streams its slices through a
// ring of its own (1-4 stages of 16-byte cp.async by head dim and type,
// zero-filled past the range) with no barrier but its own __syncwarp.
// Per slice: S^T, the online softmax on its fragments per head column
// (f32, exp2 domain, softcap before the mask), O^T += V^T P^T, each warp
// keeping (m, l, O) of its own positions; at the end the four warps' (m,
// l, O) are merged in shared memory in warp order.  P^T's B fragment
// wants the P of head g at keys that other lanes' rows hold: eight
// shuffles a slice fetch them.  Against bf16 K/V: m16n8k16, K by
// ldmatrix, V^T by ldmatrix.trans, P as bf16 big + small in two products
// (one bf16 rounding of P would move an output of a short row by a bf16
// ulp of itself, past the card tests' 1e-2 at |out| >= 2).  Against f32
// K/V: TF32 m16n8k8 with every f32 operand split into big + small TF32
// parts (sm90::split_tf32): K Q^T in two products (bf16 q is exact in
// TF32), V^T P^T in three, so the result stays within ~2^-22 of an f32
// sum, as the CUDA-core body was (one TF32 rounding of V and P would move
// an output near zero by ~1e-4 and miss the rings' one-bf16-ulp gate).
// K's contraction order is permuted as in paged_prefill.cu (A column t
// stands for dim 2t, t + 4 for 2t + 1), so one float2 load gives a lane
// two K values and one 32-bit load both bf16 q values of a k-step.  At d
// = 256 an f32 slice is 8 positions (rows 8-15 zero): 16 would need 135
// KB a stage.
//
// f32 q (f32 K/V, held to 2e-5, which TF32 products cannot promise; not
// on the engine's path): attend_split on the CUDA cores.  Tiles of 32
// positions in a double-buffered ring; the heads' q in shared memory,
// warp w takes heads w, w + 4, ...; for Q K^T a lane owns one position's
// whole key row (no shuffle reduction per score), for P V a lane owns d /
// 32 output dims.  A warp's head slots HPW (ceil(G / 4) rounded up to 1,
// 2, 4 or 8) are a template parameter, so that a small group does not pay
// for 8 slots in its score loop.

#pragma once

#include "paged_common.cuh"

namespace split_decode {

using namespace sm90;
using paged::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // positions per tile: a lane owns one
constexpr int kMaxG = 32;
constexpr float kLog2e = 1.4426950408889634f;

// ====================== f32 q: the CUDA-core body ======================== //
// Shared-memory tile of kTile positions x D of f32 K/V; rows padded by 16
// bytes, so they stay 16-byte aligned and a lane reading its own row 16
// bytes at a time meets no bank conflict.
template <int D>
struct SplitTile {
  static constexpr int VEC = 4;                          // floats per 16 B
  static constexpr int LD = D + VEC;
  static constexpr int ELEMS = kTile * LD;
  static constexpr int CHUNKS = D / VEC;                 // 16 B per row
  static constexpr int SMEM_KV = 4 * ELEMS * 4;          // K, V x 2
  // the whole dynamic shared memory: the ring, q of G heads, P per warp
  // (sized by G, so that small groups fit more CTAs on an SM)
  static constexpr int smem(int G) {
    return SMEM_KV + (G * D + kWarps * kTile) * 4;
  }
  static constexpr int SMEM_MAX = SMEM_KV + (kMaxG * D + kWarps * kTile) * 4;
};

// Issue positions [p0, p0 + nt) of one KV head into a tile pair.
template <int D, typename Rows>
__device__ __forceinline__ void load_tile(float* ks, float* vs,
                                          const Rows& rows, int p0, int nt) {
  using L = SplitTile<D>;
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
template <int D, int HPW, typename Rows>
__device__ __forceinline__ void attend_split(uint8_t* smem, const Rows& rows,
                                             int s_lo, int s_hi, int G,
                                             float cap, long long head0,
                                             int n_split, int split,
                                             float* __restrict__ ml_out,
                                             float* __restrict__ acc_out) {
  using L = SplitTile<D>;
  constexpr int DPL = D / 32;                       // output dims per lane
  float* ks = reinterpret_cast<float*>(smem);       // [2][kTile][LD]
  float* vs = ks + 2 * L::ELEMS;
  const float* qs = reinterpret_cast<const float*>(smem + L::SMEM_KV);
  float* ps = reinterpret_cast<float*>(smem + L::SMEM_KV) + G * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool capped = cap > 0.f;

  if (s_lo < s_hi) {
    load_tile<D>(ks, vs, rows, s_lo, min(kTile, s_hi - s_lo));
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
      load_tile<D>(ks + (st ^ 1) * L::ELEMS, vs + (st ^ 1) * L::ELEMS, rows,
                   p0 + kTile, min(kTile, s_hi - p0 - kTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // tile st landed, q in place
    const float* kt = ks + st * L::ELEMS;
    const float* vt = vs + st * L::ELEMS;

    // Q K^T: lane t scores position t of the tile against this warp's heads
    float x[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) x[j] = 0.f;
    if (lane < nt) {
      const float* kr = kt + lane * L::LD;
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

// ====================== bf16 q: the tensor-core body ====================== //
// A warp's slice of PW positions is mma.sync's M (16 rows; f32 K/V at d =
// 256 takes 8, the rows past them zero), the CTA's block of up to 8 query
// heads its N: S^T = K Q^T and O^T = V^T P^T, so a group of G <= 8 heads
// pays for 8 columns, not 16 rows.
constexpr int kHeadBlock = 8;         // query heads of a CTA: mma.sync's N

// Dynamic shared memory of attend_split_mma: the 8 rows of bf16 q, then the
// ring, stage-major, each stage one slice of PW positions per warp (its K
// rows, then its V rows, in the K/V's own type).  Rows of D + 8 elements
// stay 16-byte aligned for cp.async and keep every fragment read free of
// bank conflicts: ldmatrix rows (bf16) and 32-bit q reads 4 words mod 32
// apart; f32 K as float2 reads of [position g][2t, 2t + 1] (8 words mod
// 32: a half-warp covers all banks), f32 V as scalar reads of [key t][dim
// g] (8t + g).  STAGES is what fits ~110 KB (two CTAs an SM, ~140 KB of
// K/V in flight at bf16 d = 128; three at f32 d <= 128, whose splits are
// short or compute-bound); a launch sizes the ring to the slices a warp
// can walk (smem(slices)), so the paged decode's split of 64 positions
// takes one stage.  After the walk the ring's place holds the four warps'
// (m, l, O).
template <typename TKV, int D>
struct MmaRing {
  static constexpr bool kBf16 = sizeof(TKV) == 2;
  static constexpr int PW = !kBf16 && D == 256 ? 8 : 16;   // M rows used
  static constexpr int TILE = kWarps * PW;        // positions a tile
  static constexpr int LD = D + 8;                // K and V rows, elements
  static constexpr int SLICE = PW * 2 * LD * (int)sizeof(TKV);
  static constexpr int STAGE = kWarps * SLICE;
  static constexpr int STAGES = 4 * STAGE <= 110 * 1024   ? 4
                                : 3 * STAGE <= 110 * 1024 ? 3
                                : 2 * STAGE <= 110 * 1024 ? 2
                                                          : 1;
  static constexpr int LDQ = D + 8;               // bf16 q rows
  static constexpr int RING = kHeadBlock * LDQ * 2;   // byte offset of the ring
  static constexpr int LDO = D + 4;               // f32 O rows of the merge
  static constexpr int MERGE = kWarps * kHeadBlock * (LDO + 2) * 4;
  // bytes for a walk of at most `slices` slices a warp
  static constexpr int smem(int slices) {
    const int st = slices < STAGES ? slices : STAGES;
    return RING + (st * STAGE > MERGE ? st * STAGE : MERGE);
  }
  static constexpr int BYTES = smem(STAGES);
};

// Issue positions [p0, p0 + n) (1 <= n; at most PW count) of one KV head
// into a warp's slice; rows past n are zero-filled, so a masked position
// multiplies P = 0 by 0, never by stale bits.
template <typename TKV, int D, typename Rows>
__device__ __forceinline__ void load_slice(uint8_t* slice, const Rows& rows,
                                           int p0, int n, int lane) {
  using R = MmaRing<TKV, D>;
  constexpr int VEC = 16 / sizeof(TKV), CH = D / VEC;
  TKV* ks = reinterpret_cast<TKV*>(slice);
  TKV* vs = ks + R::PW * R::LD;
#pragma unroll
  for (int e = lane; e < R::PW * CH; e += 32) {
    const int r = e / CH, c = (e % CH) * VEC;
    const bool ok = r < n;
    const int p = ok ? p0 + r : p0;
    cp_async16_zfill(ks + r * R::LD + c, rows.k(p) + c, ok);
    cp_async16_zfill(vs + r * R::LD + c, rows.v(p) + c, ok);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four f32 values as big + small TF32 fragments
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

// One warp's slice of PW positions against the CTA's 8 q rows: S^T = K Q^T,
// the online softmax on its fragments, O^T += V^T P^T.  A thread holds
// rows g = lane / 4 and g + 8 (positions; dims of O^T) and columns 2t,
// 2t + 1 (t = lane % 4: heads) of every fragment; m, l are its heads'
// (l its share of the sum over its positions).  The slice's first n_live
// positions count (n_live >= 1, may exceed PW).
template <typename TKV, int D>
__device__ __forceinline__ void attend_slice(const uint8_t* slice,
                                             const __nv_bfloat16* qs,
                                             float (&o)[D / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             int n_live, float scale,
                                             float cap) {
  using R = MmaRing<TKV, D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const TKV* ks = reinterpret_cast<const TKV*>(slice);
  const TKV* vs = ks + R::PW * R::LD;
  const __nv_bfloat16* qg = qs + g * R::LDQ + 2 * t;    // head g's q

  // S^T = K Q^T; accumulators by k-step parity (and big / small) halve
  // the mma chains
  float s[4];
  if constexpr (R::kBf16) {
    float c[2][4] = {};
    // ldmatrix: matrix j = lane / 8 is positions 8 (j % 2) .., dims
    // 8 (j / 2) .. of the k-step: the A fragment a0 .. a3
    const TKV* kl = ks + (((lane >> 3) & 1) * 8 + (lane & 7)) * R::LD +
                    (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, kl + k0);
      mma_bf16(c[(k0 / 16) & 1], a, lds32(qg + k0), lds32(qg + k0 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = c[0][e] + c[1][e];
  } else {
    // TF32, k-step of 8 dims; A column t is dim k0 + 2t, t + 4 is 2t + 1,
    // K as big + small (c[h][0] the big products, c[h][1] the small)
    float c[2][2][4] = {};
    const float* kr = reinterpret_cast<const float*>(ks) + g * R::LD + 2 * t;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      const uint32_t w = lds32(qg + k0);
      const float2 x0 = *reinterpret_cast<const float2*>(kr + k0);
      float2 x1 = make_float2(0.f, 0.f);
      if constexpr (R::PW == 16)
        x1 = *reinterpret_cast<const float2*>(kr + 8 * R::LD + k0);
      const float x[4] = {x0.x, x1.x, x0.y, x1.y};
      uint32_t ab[4], as[4];
      split4(x, ab, as);
      const int h = (k0 / 8) & 1;
      mma_tf32(c[h][1], as, w << 16, w & 0xffff0000u);
      mma_tf32(c[h][0], ab, w << 16, w & 0xffff0000u);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = (c[0][0][e] + c[1][0][e]) + (c[0][1][e] + c[1][1][e]);
  }

  // online softmax in the exp2 domain, per head (column); softcap before
  // the mask.  s[0], s[1]: position g, heads 2t, 2t + 1; s[2], s[3]:
  // position g + 8
  const float ninf = __uint_as_float(0xff800000u);
  const bool capped = cap > 0.f;
  const float sl = capped ? scale : scale * kLog2e;
  const int lim = min(n_live, R::PW);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float x = s[e] * sl;
    if (capped) x = cap * tanhf(x / cap) * kLog2e;
    s[e] = g + 8 * (e / 2) < lim ? x : ninf;
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(s[r], s[r + 2]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m[r], mx);      // m starts finite (kNegInf)
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = exp2f(s[e] - m[e % 2]);
  l[0] += s[0] + s[2];
  l[1] += s[1] + s[3];
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb) {
    o[mb][0] *= corr[0];
    o[mb][1] *= corr[1];
    o[mb][2] *= corr[0];
    o[mb][3] *= corr[1];
  }

  // P^T's B fragments want head g's P at keys the lanes of other rows
  // hold: P[head h][position p] sits in lane (p % 8) * 4 + h / 2, element
  // h % 2 (+ 2 past position 7).  Two sources a thread, four values each.
  const int odd = g & 1;
  if constexpr (R::kBf16) {
    // k-step of 16 keys: b0 = keys 2t, 2t + 1; b1 = keys 2t + 8, 2t + 9
    const int sa = 8 * t + g / 2, sb = sa + 4;
    float pa[4], pb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[e] = __shfl_sync(0xffffffffu, s[e], sa);
      pb[e] = __shfl_sync(0xffffffffu, s[e], sb);
    }
    const float p0 = odd ? pa[1] : pa[0], p1 = odd ? pb[1] : pb[0];
    const float p8 = odd ? pa[3] : pa[2], p9 = odd ? pb[3] : pb[2];
    // P as bf16 big + small: P to ~2^-17, so an output lands where an f32
    // P would put it, not one bf16 ulp off
    const uint32_t bb0 = pack_bf16(p0, p1), bb1 = pack_bf16(p8, p9);
    const uint32_t bs0 = pack_bf16(p0 - bf16_lo(bb0), p1 - bf16_hi(bb0));
    const uint32_t bs1 = pack_bf16(p8 - bf16_lo(bb1), p9 - bf16_hi(bb1));
    // ldmatrix.trans: matrix j is keys 8 (j / 2) .., dims 8 (j % 2) ..
    // of the m-block: V^T's A fragment a0 .. a3
    const TKV* vl = vs + ((lane >> 4) * 8 + (lane & 7)) * R::LD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb) {
      uint32_t a[4];
      ldsm_x4_trans(a, vl + mb * 16);
      mma_bf16(o[mb], a, bs0, bs1);
      mma_bf16(o[mb], a, bb0, bb1);
    }
  } else {
    // k-steps of 8 keys: b0 = key t, b1 = key t + 4 (+ 8 in the second);
    // P and V as big + small, three products: small x big, big x small,
    // big x big
    const int sa = 4 * t + g / 2, sb = sa + 16;
    float pa[4], pb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[e] = __shfl_sync(0xffffffffu, s[e], sa);
      pb[e] = __shfl_sync(0xffffffffu, s[e], sb);
    }
    const float* vr = reinterpret_cast<const float*>(vs) + t * R::LD + g;
#pragma unroll
    for (int ks8 = 0; ks8 < R::PW / 8; ++ks8) {
      uint32_t pbig[2], psml[2];
      split_tf32(odd ? pa[2 * ks8 + 1] : pa[2 * ks8], pbig[0], psml[0]);
      split_tf32(odd ? pb[2 * ks8 + 1] : pb[2 * ks8], pbig[1], psml[1]);
      const float* v0 = vr + ks8 * 8 * R::LD;
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb) {
        const float x[4] = {v0[mb * 16], v0[mb * 16 + 8],
                            v0[4 * R::LD + mb * 16],
                            v0[4 * R::LD + mb * 16 + 8]};
        uint32_t ab[4], as[4];
        split4(x, ab, as);
        mma_tf32(o[mb], as, pbig[0], pbig[1]);
        mma_tf32(o[mb], ab, psml[0], psml[1]);
        mma_tf32(o[mb], ab, pbig[0], pbig[1]);
      }
    }
  }
}

// Kernel 1's tensor-core body.  Walks positions [s_lo, s_hi) of one KV head
// against Gb <= 8 query heads, whose bf16 q rows start at q (head stride
// q_sh, dims dense), and writes this split's (m, l, acc) of each head:
// ml[2 * idx], ml[2 * idx + 1], acc[idx * D ..] with idx = (head0 + h) *
// n_split + split; a split with no position writes -inf, 0, 0.  smem:
// MmaRing<TKV, D>::smem(slices) for at most `slices` slices a warp, i.e.
// ceil((s_hi - s_lo) / TILE).
template <typename TKV, int D, typename Rows>
__device__ __forceinline__ void attend_split_mma(
    uint8_t* smem, const Rows& rows, int s_lo, int s_hi,
    const __nv_bfloat16* __restrict__ q, long long q_sh, int Gb, float scale,
    float cap, long long head0, int n_split, int split,
    float* __restrict__ ml_out, float* __restrict__ acc_out) {
  using R = MmaRing<TKV, D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + R::RING + warp * R::SLICE;
  // this warp's slices: tile i holds [w0 + i * TILE, + PW)
  const int w0 = s_lo + warp * R::PW;
  const int n_t = w0 < s_hi ? (s_hi - w0 + R::TILE - 1) / R::TILE : 0;
  auto issue = [&](int i) {
    const int p0 = w0 + i * R::TILE;
    load_slice<TKV, D>(ring + (i % R::STAGES) * R::STAGE, rows, p0,
                       min(R::PW, s_hi - p0), lane);
  };
  // slices 0 .. STAGES - 2 in flight, one commit group each (empty past
  // the last slice); a one-stage ring loads each slice when it is due
#pragma unroll
  for (int i = 0; i < R::STAGES - 1; ++i) {
    if (i < n_t) issue(i);
    cp_async_commit();
  }
  // q of the Gb heads while the first slices fly; rows past Gb are zero
  for (int e = threadIdx.x; e < kHeadBlock * D / 2; e += kThreads) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2));
    __nv_bfloat162 w = __floats2bfloat162_rn(0.f, 0.f);
    if (r < Gb) {
      w.x = q[r * q_sh + c];
      w.y = q[r * q_sh + c + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(qs + r * R::LDQ + c) = w;
  }
  __syncthreads();

  float o[D / 16][4];
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb)
    o[mb][0] = o[mb][1] = o[mb][2] = o[mb][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_t; ++i) {
    __syncwarp();                       // slice i - 1 read by every lane
    if (i + R::STAGES - 1 < n_t) issue(i + R::STAGES - 1);
    cp_async_commit();
    cp_async_wait<R::STAGES - 1>();     // this lane's copies of slice i,
    __syncwarp();                       // and every lane's
    attend_slice<TKV, D>(ring + (i % R::STAGES) * R::STAGE, qs, o, m, l,
                         s_hi - (w0 + i * R::TILE), scale, cap);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
  }

  // the four warps' (m, l, O) in the ring's place, merged in warp order
  __syncthreads();                      // every warp is done with the ring
  float* mw = reinterpret_cast<float*>(smem + R::RING);   // [kWarps][8]
  float* lw = mw + kWarps * kHeadBlock;
  float* ow = lw + kWarps * kHeadBlock;           // [kWarps][8][LDO]
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = warp * kHeadBlock + 2 * t + r;
    if (g == 0) {
      mw[head] = m[r];
      lw[head] = l[r];
    }
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb) {
      ow[head * R::LDO + mb * 16 + g] = o[mb][r];
      ow[head * R::LDO + mb * 16 + g + 8] = o[mb][r + 2];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Gb * D; e += kThreads) {
    const int h = e / D, i = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kHeadBlock + h]);
    // a warp with no position keeps m = kNegInf, l = 0, O = 0: weight 0
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mw[w * kHeadBlock + h] - mx);
      lsum += lw[w * kHeadBlock + h] * wt;
      acc += ow[(w * kHeadBlock + h) * R::LDO + i] * wt;
    }
    const long long idx = (head0 + h) * n_split + split;
    if (i == 0) {
      ml_out[2 * idx] = lsum > 0.f ? mx : __uint_as_float(0xff800000u);
      ml_out[2 * idx + 1] = lsum;
    }
    acc_out[idx * D + i] = acc;
  }
}

// Head blocks of 8 a KV head's group of G <= kMaxG heads takes
__host__ __device__ inline int head_blocks(int G) {
  return (G + kHeadBlock - 1) / kHeadBlock;
}

// A paged split's length is a multiple of every tile: 32 (f32 q), 64
// (bf16 q)
constexpr int kSplitQuantum = 64;

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
