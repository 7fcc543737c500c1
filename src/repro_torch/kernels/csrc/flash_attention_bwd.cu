// Dense GQA flash attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's flash kernel
// (src/repro/kernels/flash_attention.py, flash_attention) has no backward,
// and its trainer differentiates its jnp attention
// (src/repro/models/attention.py:82, attention_fwd: blocks of 512 queries
// under jax.checkpoint).  This file gives the forward of flash_attention.cu
// those same gradients on the card: (dq, dk, dv) for the output gradient
// dO, with the forward's semantics (scores q.k * scale in f32, softcap cap
// * tanh(s / cap) before the mask, causal, sliding window or
// bidirectional).  The trainer calls it once for every attention layer of
// every backward pass.  kernels/ref.py flash_attention_backward_ref is the
// same computation in plain PyTorch:
//   lse_i = log sum_j exp(s_ij) over the keys query i keeps,
//   D_i = dO_i . O_i,  P = exp(s - lse),  dV = P^T dO,  dP = dO V^T,
//   dS = P o (dP - D) o (1 - (s / cap)^2 with a softcap),
//   dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the G query heads of each KV head.
//
// What bounds it on this card: operations once sequences are long, bytes
// at the trainer's short rows.  It reads q, k, v, O and dO once and writes
// dq, dk and dv once, and needs 10 d flops per (query, key) pair it keeps
// (the five products); it runs 16 d (the scores three times, dP twice) and
// more where a column chunk repeats them (below).
//
// Design: three launches on the caller's stream, so that every sum has one
// owner and a fixed order (no float atomics; repeated launches are
// bit-identical, and a (row, head)'s gradients do not depend on B, on the
// head count or on the SM count):
//  (i)   row statistics: per (row, query head, tile of 64 queries), lse by
//        one Q K^T pass over the keys the tile sees, and D = rowsum(dO o
//        O); both f32 [B, H, S] scratch.  The forward kernel is left as it
//        is (its bits, and the serving graphs that capture it), so lse is
//        recomputed here rather than saved there.
//  (ii)  dK and dV: per (row, KV head, tile of 64 keys, chunk of DC head
//        columns), a loop over the G query heads and the query tiles that
//        see the key tile, in that order; tiles wholly outside the causal
//        or window mask are skipped, not masked.  Each warp owns 16 keys:
//        S^T = K Q^T and dP^T = V dO^T land in its registers, P and dS
//        become the A operands of dV += P^T dO and dK += dS^T Q without a
//        trip through shared memory.
//  (iii) dQ: per (row, query head, tile of 64 queries, chunk of DC head
//        columns), a loop over the key tiles the tile sees: S and dP
//        recomputed, dQ += dS K.
//  A column chunk DC bounds the accumulators a warp holds (16 rows x DC
//  f32, two of them in (ii)): D <= 80 runs whole; d = 128 splits (ii) in
//  two, d = 256 splits (ii) in four and (iii) in two, each chunk
//  recomputing S and dP.
//  bf16 (the trainer's) runs on mma.sync.m16n8k16 with f32 accumulators:
//  tiles of [64][d + 8] bf16 arrive by cp.async (16-byte aligned bases and
//  strides, which the model's [B, S, heads, d] views meet), operands come
//  from shared memory through ldmatrix (.trans for the operands read down
//  a column), and P and dS are rounded to bf16 for their products, as the
//  forward rounds P.  f32 runs on the CUDA cores (8 threads a row, dims
//  strided over them as the forward's f32 path), so its inputs keep their
//  precision; it is not on the trainer's path.  wgmma and TMA are left to
//  a later version.  Any S: positions past S load as zeros, keep nothing
//  and write nothing.

#include "paged_common.cuh"

namespace {

using namespace paged;

struct BwdArgs {
  int B, H, K, S, G;
  // element strides of (batch, head, position); the head dim is dense
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int causal, window;
  float scale, cap;
};

// The keys query i keeps: [key_lo, key_hi); a query past S keeps none.
__device__ __forceinline__ int key_lo(const BwdArgs& a, int i) {
  return a.window ? max(0, i - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const BwdArgs& a, int i) {
  return a.causal ? min(a.S, i + 1) : a.S;
}
__device__ __forceinline__ bool keeps(const BwdArgs& a, int i, int j) {
  return i < a.S && j >= key_lo(a, i) && j < key_hi(a, i);
}

// A score from its dot product: s = cap tanh(dot scale / cap) (or dot
// scale), and ds/d(dot scale) = 1 - tanh^2 (or 1).
struct Score {
  float s, dcap;
};
__device__ __forceinline__ Score score(float dot, const BwdArgs& a) {
  const float raw = dot * a.scale;
  if (a.cap > 0.f) {
    const float t = tanhf(raw / a.cap);
    return {a.cap * t, 1.f - t * t};
  }
  return {raw, 1.f};
}

// ------------------------------ bf16: mma.sync ---------------------------- //
constexpr int kBT = 64;          // queries or keys a tile
constexpr int kBThreads = 128;   // 4 warps, 16 rows of a tile each

// head-dim columns of the dK / dV (dQ) accumulators a CTA holds
template <int D>
struct Chunk {
  static constexpr int KV = D <= 80 ? D : 64;
  static constexpr int Q = D <= 128 ? D : 128;
};

// Rows [0, 64) of a [64][D + 8] bf16 tile from rows of `src` (row stride
// ss elements, 16-byte aligned); rows >= valid are zeros.  The caller
// commits and waits.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int valid) {
  constexpr int LDS = D + 8, CPR = D / 8;
  for (int e = threadIdx.x; e < kBT * CPR; e += kBThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * LDS + c, src + (ok ? r * ss + c : 0), ok);
  }
}

// acc[j] (16 x 8: rows r0 + [0, 16) of `as`, columns 8j + [0, 8) of the
// tile) += sum over the head dim of as[r][:] bts[8j + c][:], both [64][D +
// 8] bf16 tiles: A read row-major, B read as the rows of B^T.
template <int D>
__device__ __forceinline__ void rows_dot(float (&acc)[8][4],
                                         const __nv_bfloat16* as, int r0,
                                         const __nv_bfloat16* bts) {
  constexpr int LDS = D + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + (r0 + lane % 16) * LDS + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bts + (16 * np + lane % 8 + 8 * (lane / 16)) * LDS +
                     16 * kk + 8 * ((lane / 8) % 2));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (16 x 8, columns c0 + 8j) += sum over the tile's 64 rows t of
// X[r][t] vs[t][c0 + 8j + c], X the 16 x 64 f32 C fragments x (rounded to
// bf16 as the A operand), vs a [64][D + 8] bf16 tile read down its
// columns (ldmatrix .trans).
template <int D, int NJ>
__device__ __forceinline__ void frag_times_tile(float (&acc)[NJ][4],
                                                const float (&x)[8][4],
                                                const __nv_bfloat16* vs,
                                                int c0) {
  constexpr int LDS = D + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                LDS + c0 + 16 * np + 8 * (lane / 16));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// (i) one CTA per (tile of 64 queries, query head, row)
template <int D>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_stats_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ g,
                            float* __restrict__ lse,
                            float* __restrict__ delta, BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = D + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBT * LDS;
  const int i0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)b * a.H + h;
  load_tile<D>(qs, q + b * a.q_sb + h * a.q_sh + i0 * a.q_ss, a.q_ss,
               a.S - i0);
  cp_async_commit();
  {
    // D = rowsum(dO o O): two threads a query, halves of the head dim
    const int r = threadIdx.x / 2, part = threadIdx.x % 2, i = i0 + r;
    float sum = 0.f;
    if (i < a.S) {
      const __nv_bfloat16* ob = o + b * a.o_sb + h * a.o_sh + i * a.o_ss;
      const __nv_bfloat16* gb = g + b * a.g_sb + h * a.g_sh + i * a.g_ss;
      for (int c = part * (D / 2); c < (part + 1) * (D / 2); ++c)
        sum += to_f(ob[c]) * to_f(gb[c]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0 && i < a.S) delta[row * a.S + i] = sum;
  }
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int lo = a.window ? max(0, i0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.S, i0 + kBT) : a.S;
  const __nv_bfloat16* kb = k + b * a.k_sb + (h / a.G) * a.k_sh;
  for (int j0 = lo / kBT * kBT; j0 < hi; j0 += kBT) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<D>(ks, kb + j0 * a.k_ss, a.k_ss, a.S - j0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4] = {};
    rows_dot<D>(s, qs, 16 * w, ks);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 16 * w + gq + 8 * r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = j0 + 8 * j + 2 * tq + c;
          const float sc = score(s[j][2 * r + c], a).s;
          s[j][2 * r + c] = keeps(a, i, key) ? sc : kNegInf;
          mt = fmaxf(mt, s[j][2 * r + c]);
        }
      const float m_new = fmaxf(m[r], mt);
      l[r] *= expf(m[r] - m_new);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (s[j][2 * r + c] > kNegInf) l[r] += expf(s[j][2 * r + c] - m_new);
      m[r] = m_new;
    }
  }
  // the quad's four partial (max, sum) pairs, merged in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      l[r] = l[r] * expf(m[r] - mm) + lo_ * expf(mo - mm);
      m[r] = mm;
    }
    const int i = i0 + 16 * w + gq + 8 * r;
    if (tq == 0 && i < a.S) lse[row * a.S + i] = m[r] + logf(l[r]);
  }
}

// (ii) one CTA per (tile of 64 keys x column chunk, KV head, row)
template <int D>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, BwdArgs a) {
  constexpr int LDS = D + 8, DC = Chunk<D>::KV, NJ = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBT * LDS;
  __nv_bfloat16* qs = vs + kBT * LDS;
  __nv_bfloat16* gs = qs + kBT * LDS;
  float* ls = reinterpret_cast<float*>(gs + kBT * LDS);   // [kBT] lse
  float* dl = ls + kBT;                                   // [kBT] D
  const int j0 = blockIdx.x / (D / DC) * kBT, c0 = blockIdx.x % (D / DC) * DC;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  load_tile<D>(ks, k + b * a.k_sb + kh * a.k_sh + j0 * a.k_ss, a.k_ss,
               a.S - j0);
  load_tile<D>(vs, v + b * a.v_sb + kh * a.v_sh + j0 * a.v_ss, a.v_ss,
               a.S - j0);
  cp_async_commit();
  float dka[NJ][4] = {}, dva[NJ][4] = {};
  const int qlo = a.causal ? j0 : 0;
  const int qhi = a.window ? min(a.S, j0 + kBT + a.window - 1) : a.S;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kh * a.G + gi;
    const long long row = (long long)b * a.H + h;
    for (int i0 = qlo / kBT * kBT; i0 < qhi; i0 += kBT) {
      __syncthreads();               // the last tile's readers are done
      load_tile<D>(qs, q + b * a.q_sb + h * a.q_sh + i0 * a.q_ss, a.q_ss,
                   a.S - i0);
      load_tile<D>(gs, g + b * a.g_sb + h * a.g_sh + i0 * a.g_ss, a.g_ss,
                   a.S - i0);
      cp_async_commit();
      if (threadIdx.x < kBT) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < a.S ? lse[row * a.S + i] : 0.f;
        dl[threadIdx.x] = i < a.S ? delta[row * a.S + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: rows this warp's 16 keys
      float s[8][4] = {}, dp[8][4] = {};
      rows_dot<D>(s, ks, 16 * w, qs);
      rows_dot<D>(dp, vs, 16 * w, gs);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 16 * w + gq + 8 * (e / 2);
          const int qi = 8 * j + 2 * tq + (e & 1);
          const Score sc = score(s[j][e], a);
          const float p = keeps(a, i0 + qi, key) ? expf(sc.s - ls[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl[qi]) * sc.dcap;
        }
      frag_times_tile<D, NJ>(dva, s, gs, c0);     // dV += P^T dO
      frag_times_tile<D, NJ>(dka, dp, qs, c0);    // dK += dS^T Q
    }
  }
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + 16 * w + gq + 8 * (e / 2);
      const int col = c0 + 8 * jn + 2 * tq + (e & 1);
      if (key < a.S) {
        dk[b * a.dk_sb + kh * a.dk_sh + key * a.dk_ss + col] =
            __float2bfloat16(dka[jn][e] * a.scale);
        dv[b * a.dv_sb + kh * a.dv_sh + key * a.dv_ss + col] =
            __float2bfloat16(dva[jn][e]);
      }
    }
}

// (iii) one CTA per (tile of 64 queries x column chunk, query head, row)
template <int D>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, BwdArgs a) {
  constexpr int LDS = D + 8, DC = Chunk<D>::Q, NJ = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + kBT * LDS;
  __nv_bfloat16* ks = gs + kBT * LDS;
  __nv_bfloat16* vs = ks + kBT * LDS;
  const int i0 = blockIdx.x / (D / DC) * kBT, c0 = blockIdx.x % (D / DC) * DC;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.G;
  const long long row = (long long)b * a.H + h;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  load_tile<D>(qs, q + b * a.q_sb + h * a.q_sh + i0 * a.q_ss, a.q_ss,
               a.S - i0);
  load_tile<D>(gs, g + b * a.g_sb + h * a.g_sh + i0 * a.g_ss, a.g_ss,
               a.S - i0);
  cp_async_commit();
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 16 * w + gq + 8 * r;
    lr[r] = i < a.S ? lse[row * a.S + i] : 0.f;
    dr[r] = i < a.S ? delta[row * a.S + i] : 0.f;
  }
  float dqa[NJ][4] = {};
  const int lo = a.window ? max(0, i0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.S, i0 + kBT) : a.S;
  for (int j0 = lo / kBT * kBT; j0 < hi; j0 += kBT) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<D>(ks, k + b * a.k_sb + kh * a.k_sh + j0 * a.k_ss, a.k_ss,
                 a.S - j0);
    load_tile<D>(vs, v + b * a.v_sb + kh * a.v_sh + j0 * a.v_ss, a.v_ss,
                 a.S - j0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // S = Q K^T and dP = dO V^T: rows this warp's 16 queries
    float s[8][4] = {}, dp[8][4] = {};
    rows_dot<D>(s, qs, 16 * w, ks);
    rows_dot<D>(dp, gs, 16 * w, vs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 16 * w + gq + 8 * (e / 2);
        const int key = j0 + 8 * j + 2 * tq + (e & 1);
        const Score sc = score(s[j][e], a);
        const float p = keeps(a, i, key) ? expf(sc.s - lr[e / 2]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dr[e / 2]) * sc.dcap;
      }
    frag_times_tile<D, NJ>(dqa, dp, ks, c0);      // dQ += dS K
  }
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 16 * w + gq + 8 * (e / 2);
      const int col = c0 + 8 * jn + 2 * tq + (e & 1);
      if (i < a.S)
        dq[b * a.dq_sb + h * a.dq_sh + i * a.dq_ss + col] =
            __float2bfloat16(dqa[jn][e] * a.scale);
    }
}

// ---------------------------- f32: CUDA cores ----------------------------- //
constexpr int kFT = 8;                  // threads a query or key
constexpr int kFRows = 32;              // queries or keys a CTA
constexpr int kFThreads = kFT * kFRows;
constexpr int kFTile = 16;              // rows of a staged tile

// rows [r0, r0 + kFTile) of src (row stride ss) into dst [kFTile][D]; rows
// >= S are zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int r0, int S) {
  for (int e = threadIdx.x; e < kFTile * D; e += kFThreads) {
    const int r = e / D, c = e % D;
    dst[e] = r0 + r < S ? src[(r0 + r) * ss + c] : 0.f;
  }
}

// (i) one CTA per (32 queries, query head, row)
template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_stats_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ o,
                           const float* __restrict__ g,
                           float* __restrict__ lse, float* __restrict__ delta,
                           BwdArgs a) {
  constexpr int DPT = D / kFT;
  __shared__ float ks[kFTile * D];
  const int sub = threadIdx.x % kFT, i0 = blockIdx.x * kFRows;
  const int i = i0 + threadIdx.x / kFT, h = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)b * a.H + h;
  float qr[DPT], dsum = 0.f;
#pragma unroll
  for (int u = 0; u < DPT; ++u) {
    const int c = sub + kFT * u;
    qr[u] = i < a.S ? q[b * a.q_sb + h * a.q_sh + i * a.q_ss + c] : 0.f;
    if (i < a.S)
      dsum += o[b * a.o_sb + h * a.o_sh + i * a.o_ss + c] *
              g[b * a.g_sb + h * a.g_sh + i * a.g_ss + c];
  }
  dsum = group_sum<kFT>(dsum);
  if (sub == 0 && i < a.S) delta[row * a.S + i] = dsum;
  float m = kNegInf, l = 0.f;
  const int lo = a.window ? max(0, i0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.S, i0 + kFRows) : a.S;
  const float* kb = k + b * a.k_sb + (h / a.G) * a.k_sh;
  for (int j0 = lo; j0 < hi; j0 += kFTile) {
    __syncthreads();
    stage_rows<D>(ks, kb, a.k_ss, j0, a.S);
    __syncthreads();
    for (int t = 0; t < kFTile; ++t) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < DPT; ++u) part += qr[u] * ks[t * D + sub + kFT * u];
      const float sc = score(group_sum<kFT>(part), a).s;
      if (keeps(a, i, j0 + t)) {
        const float m_new = fmaxf(m, sc);
        l = l * expf(m - m_new) + expf(sc - m_new);
        m = m_new;
      }
    }
  }
  if (sub == 0 && i < a.S) lse[row * a.S + i] = m + logf(l);
}

// (ii) one CTA per (32 keys, KV head, row)
template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         BwdArgs a) {
  constexpr int DPT = D / kFT;
  __shared__ float qs[kFTile * D], gs[kFTile * D], ls[kFTile], dl[kFTile];
  const int sub = threadIdx.x % kFT, j0 = blockIdx.x * kFRows;
  const int j = j0 + threadIdx.x / kFT, kh = blockIdx.y, b = blockIdx.z;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int u = 0; u < DPT; ++u) {
    const int c = sub + kFT * u;
    kr[u] = j < a.S ? k[b * a.k_sb + kh * a.k_sh + j * a.k_ss + c] : 0.f;
    vr[u] = j < a.S ? v[b * a.v_sb + kh * a.v_sh + j * a.v_ss + c] : 0.f;
    dka[u] = dva[u] = 0.f;
  }
  const int qlo = a.causal ? j0 : 0;
  const int qhi = a.window ? min(a.S, j0 + kFRows + a.window - 1) : a.S;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kh * a.G + gi;
    const long long row = (long long)b * a.H + h;
    for (int i0 = qlo; i0 < qhi; i0 += kFTile) {
      __syncthreads();
      stage_rows<D>(qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, i0, a.S);
      stage_rows<D>(gs, g + b * a.g_sb + h * a.g_sh, a.g_ss, i0, a.S);
      if (threadIdx.x < kFTile) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < a.S ? lse[row * a.S + i] : 0.f;
        dl[threadIdx.x] = i < a.S ? delta[row * a.S + i] : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < kFTile; ++t) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int u = 0; u < DPT; ++u) {
          ps += qs[t * D + sub + kFT * u] * kr[u];
          pd += gs[t * D + sub + kFT * u] * vr[u];
        }
        const Score sc = score(group_sum<kFT>(ps), a);
        const float dpv = group_sum<kFT>(pd);
        const float p = keeps(a, i0 + t, j) ? expf(sc.s - ls[t]) : 0.f;
        const float ds = p * (dpv - dl[t]) * sc.dcap;
#pragma unroll
        for (int u = 0; u < DPT; ++u) {
          dva[u] += p * gs[t * D + sub + kFT * u];
          dka[u] += ds * qs[t * D + sub + kFT * u];
        }
      }
    }
  }
  if (j < a.S) {
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int c = sub + kFT * u;
      dk[b * a.dk_sb + kh * a.dk_sh + j * a.dk_ss + c] = dka[u] * a.scale;
      dv[b * a.dv_sb + kh * a.dv_sh + j * a.dv_ss + c] = dva[u];
    }
  }
}

// (iii) one CTA per (32 queries, query head, row)
template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, BwdArgs a) {
  constexpr int DPT = D / kFT;
  __shared__ float ks[kFTile * D], vs[kFTile * D];
  const int sub = threadIdx.x % kFT, i0 = blockIdx.x * kFRows;
  const int i = i0 + threadIdx.x / kFT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.G;
  const long long row = (long long)b * a.H + h;
  float qr[DPT], gr[DPT], dqa[DPT];
#pragma unroll
  for (int u = 0; u < DPT; ++u) {
    const int c = sub + kFT * u;
    qr[u] = i < a.S ? q[b * a.q_sb + h * a.q_sh + i * a.q_ss + c] : 0.f;
    gr[u] = i < a.S ? g[b * a.g_sb + h * a.g_sh + i * a.g_ss + c] : 0.f;
    dqa[u] = 0.f;
  }
  const float lr = i < a.S ? lse[row * a.S + i] : 0.f;
  const float dr = i < a.S ? delta[row * a.S + i] : 0.f;
  const int lo = a.window ? max(0, i0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.S, i0 + kFRows) : a.S;
  for (int j0 = lo; j0 < hi; j0 += kFTile) {
    __syncthreads();
    stage_rows<D>(ks, k + b * a.k_sb + kh * a.k_sh, a.k_ss, j0, a.S);
    stage_rows<D>(vs, v + b * a.v_sb + kh * a.v_sh, a.v_ss, j0, a.S);
    __syncthreads();
    for (int t = 0; t < kFTile; ++t) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        ps += qr[u] * ks[t * D + sub + kFT * u];
        pd += gr[u] * vs[t * D + sub + kFT * u];
      }
      const Score sc = score(group_sum<kFT>(ps), a);
      const float dpv = group_sum<kFT>(pd);
      const float p = keeps(a, i, j0 + t) ? expf(sc.s - lr) : 0.f;
      const float ds = p * (dpv - dr) * sc.dcap;
#pragma unroll
      for (int u = 0; u < DPT; ++u) dqa[u] += ds * ks[t * D + sub + kFT * u];
    }
  }
  if (i < a.S) {
#pragma unroll
    for (int u = 0; u < DPT; ++u)
      dq[b * a.dq_sb + h * a.dq_sh + i * a.dq_ss + sub + kFT * u] =
          dqa[u] * a.scale;
  }
}

// --------------------------------- launch --------------------------------- //
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* g, void* dq, void* dk, void* dv, float* lse,
                float* delta, const BwdArgs& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t tile = sizeof(bf) * kBT * (D + 8);
  const size_t st_bytes = 2 * tile, kv_bytes = 4 * tile + 2 * kBT * 4,
               q_bytes = 4 * tile;
  int rc = allow_smem(flash_bwd_stats_bf16_kernel<D>, st_bytes);
  if (rc == 0) rc = allow_smem(flash_bwd_dkv_bf16_kernel<D>, kv_bytes);
  if (rc == 0) rc = allow_smem(flash_bwd_dq_bf16_kernel<D>, q_bytes);
  if (rc != 0) return rc;
  const int n_t = (a.S + kBT - 1) / kBT;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* gb = static_cast<const bf*>(g);
  flash_bwd_stats_bf16_kernel<D><<<dim3(n_t, a.H, a.B), kBThreads, st_bytes,
                                   stream>>>(qb, kb, static_cast<const bf*>(o),
                                             gb, lse, delta, a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkv_bf16_kernel<D><<<dim3(n_t * (D / Chunk<D>::KV), a.K, a.B),
                                 kBThreads, kv_bytes, stream>>>(
      qb, kb, vb, gb, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dq_bf16_kernel<D><<<dim3(n_t * (D / Chunk<D>::Q), a.H, a.B),
                                kBThreads, q_bytes, stream>>>(
      qb, kb, vb, gb, lse, delta, static_cast<bf*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* g, void* dq, void* dk, void* dv, float* lse,
               float* delta, const BwdArgs& a, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const int n_t = (a.S + kFRows - 1) / kFRows;
  flash_bwd_stats_f32_kernel<D><<<dim3(n_t, a.H, a.B), kFThreads, 0,
                                  stream>>>(
      qf, kf, static_cast<const float*>(o), gf, lse, delta, a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dkv_f32_kernel<D><<<dim3(n_t, a.K, a.B), kFThreads, 0, stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_bwd_dq_f32_kernel<D><<<dim3(n_t, a.H, a.B), kFThreads, 0, stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* g, void* dq, void* dk, void* dv,
           float* lse, float* delta, const BwdArgs& a, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, g, dq, dk, dv, lse, delta, a, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, g, dq, dk, dv, lse, delta, a, stream);
  return -1;
}

}  // namespace

// dtype code (q, k, v, out, dO and the three gradients share it): 0 =
// float32, 1 = bfloat16.  q, out, dO, dq [B, H, S, d]; k, v, dk, dv [B, K,
// S, d]; any strides with a dense head dim (bf16: 16-byte aligned bases
// and strides, for cp.async); strides in elements, (batch, head,
// position) for each of the eight tensors in that order.  `lse` and
// `delta` are f32 scratch of B * H * S floats the caller allocates.
// Returns cudaGetLastError() after the launches, or -1 for a head dim or
// dtype this file was not built for.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int H, int K, int S, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long g_sb, long long g_sh,
    long long g_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, int causal, int window, float scale,
    float cap, int dtype, void* stream) {
  if (K <= 0 || H % K != 0) return -1;
  const BwdArgs a{B, H, K, S, H / K,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                  o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                  dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh,
                  dv_ss, causal, window, scale, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, g, dq, dk, dv, ls, dl, a, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, g, dq, dk, dv, ls, dl, a, st);
    case 80:
      return launch<80>(dtype, q, k, v, o, g, dq, dk, dv, ls, dl, a, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, g, dq, dk, dv, ls, dl, a, st);
    case 256:
      return launch<256>(dtype, q, k, v, o, g, dq, dk, dv, ls, dl, a, st);
    default:
      return -1;
  }
}
