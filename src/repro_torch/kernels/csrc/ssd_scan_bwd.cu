// Mamba-2 SSD scan backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's scan kernel
// (src/repro/kernels/ssd_scan.py, ssd_scan) has no backward, and its
// trainer differentiates its chunked jnp scan (src/repro/models/ssm.py:36,
// ssd_chunked, one jax.checkpoint a chunk).  This file gives the forward of
// ssd_scan.cu those same gradients on the card: (dx, ddt, dA, dB, dC) for
// the gradients dy of y and dS of the final state.  The trainer calls it
// once for every SSM layer of every backward pass.
//
// The chunked form (cum = the inclusive cumulative sum of dt A over a
// chunk, last its final value, L[s, t] = exp(cum_s - cum_t) for t <= s, S_in
// the state entering the chunk, dS_out the gradient of the state leaving
// it):
//   dS_out of the last chunk = dS (or 0); dS_out[k - 1] = exp(last_k)
//     dS_out[k] + sum_s exp(cum_s) dy_s (x) C_s               (over chunks)
//   d(dt x)_t = sum_{s >= t} (C_s . B_t) L[s, t] dy_s
//               + exp(last - cum_t) dS_out B_t
//   dC_s = sum_{t <= s} L[s, t] (dy_s . dt_t x_t) B_t + exp(cum_s) S_in^T dy_s
//   dB_t = sum_{s >= t} L[s, t] (dy_s . dt_t x_t) C_s
//          + exp(last - cum_t) dS_out^T dt_t x_t
//   d(cum) from the intra-chunk pairs, the carried state exp(cum_s) C_s .
//     S_in dy_s, the chunk state's exp(last - cum_t) and exp(last) <dS_out,
//     S_in>; d(dt A) is its reverse cumulative sum, so ddt = x . d(dt x) +
//     A d(dt A) and dA = sum dt d(dt A).
// Every decay is formed as exp(cum_s - cum_t) or exp(last - cum_t), in
// [0, 1], never as exp(cum_s) exp(-cum_t): that product overflows once cum
// runs far negative.  kernels/ref.py ssd_scan_backward_ref is the same
// computation in plain PyTorch.
//
// What bounds it on this card: operations.  Its products are about twice
// the forward's (C B^T, dy (dt x)^T, M^T dy, B dS_out^T, Y B, dy S_in, Y^T
// C, (dt x) dS_out per chunk), each run as three TF32 products, plus the
// forward's passes (a) and (b) again; its bytes are x, dt, B, C and dy read
// and the five gradients written, plus ~4 x b H (L / c) P N f32 of scratch
// (the recomputed states and the state gradients, each written and read).
//
// Design (one launch = these passes on the caller's stream):
//  (a) the forward's passes (a) and (b) (ssd_common.cuh, shared with
//      ssd_scan.cu) recompute the state entering each chunk into `work`
//      and each chunk's decay exp(last); saving them in the forward would
//      hold b H (L / c) P N f32 a layer (805 MB at Mamba2's train_4k) for
//      every layer of a step;
//  (b) ssd_dstate_contrib_kernel, chunk-parallel like forward pass (a):
//      each chunk's sum_s exp(cum_s) dy_s (x) C_s into `dwork`; then
//      ssd_dstate_passing_kernel, the only serial part, elementwise and
//      last chunk first as forward pass (b) runs first chunk first: slot k
//      of `dwork` ends holding dS_out[k];
//  (c) ssd_chunk_grads_kernel: one CTA of 8 warps per (chunk, row, group,
//      block of up to `hb` heads of the group).  C B^T is computed once for
//      the CTA's heads; for each head in order it stages x, dy, S_in and
//      dS_out, forms M = C B^T o L and Y = (dy (dt x)^T) o L, and runs the
//      products above: dx and ddt are written per head, dB and dC are
//      summed over the CTA's heads in registers, in head order, and
//      written as one partial per head block; d(cum)'s reductions go
//      through shared memory in a fixed order.  Head blocks trade the
//      card's fill against scratch: one CTA per (row, chunk, group) over
//      all of a group's heads would leave most SMs idle at Hymba's train
//      batch (4 rows x 18 chunks = 72 CTAs), per-head partials would cost
//      b L H N f32 twice (1.6 GB at train_4k); blocks of 8 heads give 504
//      CTAs there and b L G ceil(H / (8 G)) N f32 of partials (3 or 7 per
//      group in the served families, 0.1 GB each at train_4k);
//  (d) ssd_group_sum_kernel sums the head blocks' partials of dB and dC in
//      block order, and ssd_da_sum_kernel the per-(row, chunk, head)
//      partials of dA in a fixed order.
// No atomics and no order set by the scheduler: repeated launches are
// bit-identical.  Products run on mma.sync.m16n8k8 TF32 in the forward's
// 3xTF32 split (ssd_common.cuh: split4, mma3_tiles); their operands are
// read from shared-memory tiles element by element in whatever
// orientation a product needs (warp_mma3 below), which keeps one code
// path for all eight products at the cost of bank conflicts the forward's
// permuted fragments avoid.  Tiles are the forward's: 64 positions, P <= 64,
// chunk <= 64; N <= 128 (the served families' 16 and 128).  A CTA of pass
// (c) holds 223 KB of shared memory at N = 128, one a SM.

#include "ssd_common.cuh"

namespace {

using sm90::from_f;

constexpr int kGradThreads = 256;    // pass (c): 8 warps

struct BwdArgs {
  long long gy_sb, gy_sl, gy_sh;     // dy's element strides, last dim dense
  int PP;                            // P rounded up to 8
  int hb, nb;                        // heads a pass (c) CTA walks; blocks
  bool vec_gy;                       // 16-byte loads of dy allowed
};

__host__ __device__ inline int contrib_smem_floats(int NP) {
  return kCH * kLDX + kCH * ld_n(NP) + 2 * kCH;
}
__host__ __device__ inline int grads_smem_floats(int NP) {
  return 4 * kCH * ld_n(NP) + 3 * kCH * kLDW + 2 * kCH * kLDX + 13 * kCH + 8;
}

// One warp's 3xTF32 product on 16 rows: acc[0][j] (the 16 x 8 tile j) +=
// sum over k in [k0, k1) (steps of 8) of fa(r, k) fb(k, j, c), r < 16 the
// tile's row and c < 8 its column; tiles j < live take part.  fa and fb
// read shared memory in any orientation.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma3(float (&acc)[1][NT][4], FA fa,
                                          FB fb, int k0, int k1, int live) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  for (int k = k0; k < k1; k += 8) {
    const AFrag f[1] = {split4(fa(gq, k + tq), fa(gq + 8, k + tq),
                               fa(gq, k + tq + 4), fa(gq + 8, k + tq + 4))};
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < live) {
        split(fb(k + tq, j, gq), bb[j][0], bs[j][0]);
        split(fb(k + tq + 4, j, gq), bb[j][1], bs[j][1]);
      }
    }
    mma3_tiles(acc, f, bb, bs, 0, live);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the four lanes of a quad (tq = 0..3), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------ (b) the state gradient, chunk by chunk ---------------- //
// One CTA per (chunk, head, row): sum_s exp(cum_s) dy_s (x) C_s, [kPP, NP]
// (rows >= P and columns >= N exact zeros), into its tile of `dwork`; warp
// w computes rows p in [16w, 16w + 16), NB column tiles at a time.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_dstate_contrib_kernel(const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Cm,
                          const float* __restrict__ gy,
                          float* __restrict__ dwork, SsdArgs a, BwdArgs ba) {
  extern __shared__ __align__(16) float smem[];
  const int LDN = ld_n(a.NP);
  float* ys = smem;                  // [kCH][kLDX] dy
  float* cs = ys + kCH * kLDX;       // [kCH][LDN] C
  float* dts = cs + kCH * LDN;       // [kCH]
  float* ec = dts + kCH;             // [kCH] exp(cum)

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int l0 = k * a.chunk, nt = min(a.chunk, a.L - l0);
  stage<kThreads, float>(ys, kLDX,
                         gy + bi * ba.gy_sb + l0 * ba.gy_sl + h * ba.gy_sh,
                         ba.gy_sl, nt, a.P, kPP, ba.vec_gy);
  stage<kThreads, T>(cs, LDN, Cm + bi * a.C_sb + l0 * a.C_sl + g * a.C_sg,
                     a.C_sl, nt, a.N, a.NP, a.vec_c);
  stage_dt<T>(dts, dt + bi * a.dt_sb + l0 * a.dt_sl + h * a.dt_sh, a.dt_sl,
              nt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (w == 0) {
    float c0, c1;
    chunk_cum(dts, A[h], c0, c1);
    ec[2 * lane] = expf(c0);
    ec[2 * lane + 1] = expf(c1);
  }
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4;
  float* out = dwork + (((long long)bi * a.H + h) * a.nc + k) * kPP * a.NP;
  for (int n0 = 0; n0 < a.NP; n0 += 8 * NB) {
    const int live = min(NB, (a.NP - n0) / 8);
    float acc[1][NB][4] = {};
    warp_mma3<NB>(
        acc, [&](int r, int s) { return ys[s * kLDX + 16 * w + r] * ec[s]; },
        [&](int s, int j, int c) { return cs[s * LDN + n0 + 8 * j + c]; }, 0,
        kCH, live);
    const int p = 16 * w + gq;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      if (j < live) {
        *reinterpret_cast<float2*>(out + p * a.NP + n) =
            make_float2(acc[0][j][0], acc[0][j][1]);
        *reinterpret_cast<float2*>(out + (p + 8) * a.NP + n) =
            make_float2(acc[0][j][2], acc[0][j][3]);
      }
    }
  }
}

// One thread per 4 floats of a (row, head)'s [kPP, NP] tile, last chunk
// first: slot k of `dwork` (chunk k's contribution) is replaced by dS_out[k]
// and dS_out[k - 1] = decay[k] dS_out[k] + contribution[k]; dS_out of the
// last chunk is `gstate` [b, H, P, N] (null: 0).
__global__ void __launch_bounds__(kPassThreads)
ssd_dstate_passing_kernel(float* __restrict__ dwork,
                          const float* __restrict__ decay,
                          const float* __restrict__ gstate, SsdArgs a) {
  const int tile4 = kPP * a.NP / 4;
  const int e4 = blockIdx.x * kPassThreads + threadIdx.x;
  if (e4 >= tile4) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float4* st = reinterpret_cast<float4*>(dwork) + bh * a.nc * tile4 + e4;
  const float* dk = decay + bh * a.nc;
  const int p = 4 * e4 / a.NP, n = 4 * e4 % a.NP;
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
  if (gstate != nullptr && p < a.P) {
    const float* gs = gstate + (bh * a.P + p) * a.N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < a.N) s4[i] = gs[n + i];
  }
  float4 D = make_float4(s4[0], s4[1], s4[2], s4[3]);
  // kBatch chunks' loads in flight at once, then their updates in order
  constexpr int kBatch = 8;
  for (int k0 = a.nc - 1; k0 >= 0; k0 -= kBatch) {
    float4 v[kBatch];
    float d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 - i >= 0) {
        v[i] = st[(long long)(k0 - i) * tile4];
        d[i] = dk[k0 - i];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 - i >= 0) {
        st[(long long)(k0 - i) * tile4] = D;
        D = make_float4(fmaf(D.x, d[i], v[i].x), fmaf(D.y, d[i], v[i].y),
                        fmaf(D.z, d[i], v[i].z), fmaf(D.w, d[i], v[i].w));
      }
    }
  }
}

// ------------------------ (c) each chunk's gradients ---------------------- //
// One CTA of 8 warps per (chunk, group x head block, row).  Warp w owns row
// tile i = w / 2 (16 positions) and half = w % 2 of the columns: position
// tiles half + 2u of C B^T and dy (dt x)^T (on and below the diagonal),
// P tiles 32 half + 8u of d(dt x), N tiles half + 2u of dB and dC.
template <typename T, int NB>
__global__ void __launch_bounds__(kGradThreads, 1)
ssd_chunk_grads_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ A,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ gy,
                       const float* __restrict__ work,
                       const float* __restrict__ dwork, T* __restrict__ dx,
                       T* __restrict__ ddt, float* __restrict__ part_b,
                       float* __restrict__ part_c,
                       float* __restrict__ part_a, SsdArgs a, BwdArgs ba) {
  extern __shared__ __align__(16) float smem[];
  const int LDN = ld_n(a.NP);
  float* cs = smem;                  // [kCH][LDN] C            (the group's)
  float* bs = cs + kCH * LDN;        // [kCH][LDN] B
  float* s_in = bs + kCH * LDN;       // [kPP][LDN] S_in         (each head's)
  float* dso = s_in + kCH * LDN;      // [kPP][LDN] dS_out
  float* cbs = dso + kCH * LDN;      // [kCH][kLDW] C B^T, zero above the diagonal
  float* ms = cbs + kCH * kLDW;      // [kCH][kLDW] M = C B^T o L
  float* ys = ms + kCH * kLDW;       // [kCH][kLDW] Y = dy (dt x)^T o L
  float* xs = ys + kCH * kLDW;       // [kCH][kLDX] x
  float* dys = xs + kCH * kLDX;      // [kCH][kLDX] dy
  float* dts = dys + kCH * kLDX;     // [kCH] dt
  float* cum = dts + kCH;            // [kCH] cum
  float* ecum = cum + kCH;           // [kCH] exp(cum)
  float* elast = ecum + kCH;         // [kCH] exp(last - cum)
  float* wdt = elast + kCH;          // [kCH] exp(last - cum) dt
  float* tp = wdt + kCH;             // [2][kCH] per column half: T
  float* dp = tp + 2 * kCH;          //          x . d(dt x)
  float* rp = dp + 2 * kCH;          //          C . (dy S_in)
  float* rowq = rp + 2 * kCH;        // [kCH] intra-chunk pairs, by row
  float* colq = rowq + kCH;          // [kCH]                    by column
  float* ep = colq + kCH;            // [8] <dS_out, S_in> per warp

  const int k = blockIdx.x, bi = blockIdx.z;
  const int R = a.H / a.G, g = blockIdx.y / ba.nb, jb = blockIdx.y % ba.nb;
  const int h0 = g * R + jb * ba.hb, h1 = min(h0 + ba.hb, (g + 1) * R);
  const int l0 = k * a.chunk, nt = min(a.chunk, a.L - l0);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int i = w / 2, half = w % 2;
  const int live_n = max(0, (a.NP / 8 - half + 1) / 2);
  const int live_p = max(0, min(4, (ba.PP - 32 * half) / 8));

  stage<kGradThreads, T>(cs, LDN, Cm + bi * a.C_sb + l0 * a.C_sl + g * a.C_sg,
                         a.C_sl, nt, a.N, a.NP, a.vec_c);
  stage<kGradThreads, T>(bs, LDN, Bm + bi * a.B_sb + l0 * a.B_sl + g * a.B_sg,
                         a.B_sl, nt, a.N, a.NP, a.vec_b);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // C B^T once for the CTA's heads: tiles on and below the diagonal
  {
    float acc[1][4][4] = {};
    warp_mma3<4>(
        acc, [&](int r, int n) { return cs[(16 * i + r) * LDN + n]; },
        [&](int n, int u, int c) {
          return bs[(8 * (half + 2 * u) + c) * LDN + n];
        },
        0, a.NP, i + 1);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * i + gq + 8 * (e / 2);
        const int t = 8 * (half + 2 * u) + 2 * tq + (e & 1);
        cbs[s * kLDW + t] = t <= s ? acc[0][u][e] : 0.f;
      }
  }

  float dbacc[1][NB][4] = {}, dcacc[1][NB][4] = {};
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                 // the last head's readers are done
    const long long tile =
        (((long long)bi * a.H + h) * a.nc + k) * kPP * a.NP;
    stage<kGradThreads, T>(xs, kLDX,
                           x + bi * a.x_sb + l0 * a.x_sl + h * a.x_sh, a.x_sl,
                           nt, a.P, kPP, a.vec_x);
    stage<kGradThreads, float>(
        dys, kLDX, gy + bi * ba.gy_sb + l0 * ba.gy_sl + h * ba.gy_sh,
        ba.gy_sl, nt, a.P, kPP, ba.vec_gy);
    // the state entering chunk 0 is 0 (its slot holds its contribution)
    stage<kGradThreads, float>(s_in, LDN, work + tile, a.NP, k > 0 ? kPP : 0,
                               a.NP, a.NP, true);
    stage<kGradThreads, float>(dso, LDN, dwork + tile, a.NP, kPP, a.NP, a.NP,
                               true);
    stage_dt<T>(dts, dt + bi * a.dt_sb + l0 * a.dt_sl + h * a.dt_sh,
                a.dt_sl, nt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float Ah = A[h];
    if (w == 0) {
      float c0, c1;
      chunk_cum(dts, Ah, c0, c1);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      const float cc[2] = {c0, c1};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 2 * lane + r;
        cum[s] = cc[r];
        ecum[s] = expf(cc[r]);
        elast[s] = expf(last - cc[r]);
        wdt[s] = elast[s] * dts[s];
      }
    }
    __syncthreads();

    // M = C B^T o L and Y = dy (dt x)^T o L, zero above the diagonal
    {
      float acc[1][4][4] = {};
      warp_mma3<4>(
          acc, [&](int r, int p) { return dys[(16 * i + r) * kLDX + p]; },
          [&](int p, int u, int c) {
            return xs[(8 * (half + 2 * u) + c) * kLDX + p];
          },
          0, ba.PP, i + 1);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * i + gq + 8 * (e / 2);
          const int t = 8 * (half + 2 * u) + 2 * tq + (e & 1);
          const float Lst = t <= s ? expf(cum[s] - cum[t]) : 0.f;
          ms[s * kLDW + t] = cbs[s * kLDW + t] * Lst;
          ys[s * kLDW + t] = acc[0][u][e] * dts[t] * Lst;
        }
    }
    __syncthreads();

    // d(dt x)[t, p] = sum_{s >= t} M[s, t] dy[s, p] + exp(last - cum_t)
    // (B dS_out^T)[t, p]; dx = dt d(dt x); x . d(dt x) and T_t = dt_t
    // exp(last - cum_t) x_t . (B dS_out^T)_t summed by row
    {
      float t2[1][4][4] = {}, t1[1][4][4] = {};
      if (live_p > 0) {
        warp_mma3<4>(
            t2, [&](int r, int n) { return bs[(16 * i + r) * LDN + n]; },
            [&](int n, int u, int c) {
              return dso[(32 * half + 8 * u + c) * LDN + n];
            },
            0, a.NP, live_p);
        warp_mma3<4>(
            t1, [&](int r, int s) { return ms[s * kLDW + 16 * i + r]; },
            [&](int s, int u, int c) {
              return dys[s * kLDX + 32 * half + 8 * u + c];
            },
            16 * i, kCH, live_p);
      }
      float tsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
      T* dxb = dx + (((long long)bi * a.L + l0) * a.H + h) * a.P;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < live_p) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2, t = 16 * i + gq + 8 * r;
            const int p = 32 * half + 8 * u + 2 * tq + (e & 1);
            const float xv = xs[t * kLDX + p];
            const float dxdt = t1[0][u][e] + elast[t] * t2[0][u][e];
            tsum[r] += xv * t2[0][u][e];
            dsum[r] += xv * dxdt;
            if (t < nt && p < a.P)
              dxb[(long long)t * a.H * a.P + p] = from_f<T>(dts[t] * dxdt);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ts = quad_sum(tsum[r]), ds = quad_sum(dsum[r]);
        if (tq == 0) {
          tp[half * kCH + 16 * i + gq + 8 * r] = ts;
          dp[half * kCH + 16 * i + gq + 8 * r] = ds;
        }
      }
    }
    // dC[s, n] += exp(cum_s) (dy S_in)[s, n] + sum_{t <= s} Y[s, t] B[t, n];
    // R_s = exp(cum_s) C_s . (dy S_in)_s summed by row
    {
      float tb[1][NB][4] = {};
      warp_mma3<NB>(
          tb, [&](int r, int p) { return dys[(16 * i + r) * kLDX + p]; },
          [&](int p, int u, int c) {
            return s_in[p * LDN + 8 * (half + 2 * u) + c];
          },
          0, ba.PP, live_n);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (u < live_n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2, s = 16 * i + gq + 8 * r;
            const int n = 8 * (half + 2 * u) + 2 * tq + (e & 1);
            rsum[r] += cs[s * LDN + n] * tb[0][u][e];
            dcacc[0][u][e] += ecum[s] * tb[0][u][e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float rs = quad_sum(rsum[r]);
        if (tq == 0) rp[half * kCH + 16 * i + gq + 8 * r] = rs;
      }
      warp_mma3<NB>(
          dcacc, [&](int r, int t) { return ys[(16 * i + r) * kLDW + t]; },
          [&](int t, int u, int c) {
            return bs[t * LDN + 8 * (half + 2 * u) + c];
          },
          0, 16 * i + 16, live_n);
    }
    // dB[t, n] += sum_{s >= t} Y[s, t] C[s, n] + exp(last - cum_t) dt_t
    // (x dS_out)[t, n]
    warp_mma3<NB>(
        dbacc, [&](int r, int s) { return ys[s * kLDW + 16 * i + r]; },
        [&](int s, int u, int c) {
          return cs[s * LDN + 8 * (half + 2 * u) + c];
        },
        16 * i, kCH, live_n);
    warp_mma3<NB>(
        dbacc,
        [&](int r, int p) {
          return xs[(16 * i + r) * kLDX + p] * wdt[16 * i + r];
        },
        [&](int p, int u, int c) {
          return dso[p * LDN + 8 * (half + 2 * u) + c];
        },
        0, ba.PP, live_n);
    // <dS_out, S_in> and the intra-chunk pairs' sums (off the diagonal)
    {
      float e = 0.f;
      for (int idx = threadIdx.x; idx < kPP * a.NP; idx += kGradThreads) {
        const int p = idx / a.NP, n = idx % a.NP;
        e += dso[p * LDN + n] * s_in[p * LDN + n];
      }
      e = warp_sum(e);
      if (lane == 0) ep[w] = e;
      const int tid = threadIdx.x;
      if (tid < kCH) {
        float q = 0.f;
        for (int t = 0; t < tid; ++t) q += cbs[tid * kLDW + t] * ys[tid * kLDW + t];
        rowq[tid] = q;
      } else if (tid < 2 * kCH) {
        const int t = tid - kCH;
        float q = 0.f;
        for (int s = t + 1; s < kCH; ++s) q += cbs[s * kLDW + t] * ys[s * kLDW + t];
        colq[t] = q;
      }
    }
    __syncthreads();

    // d(cum), its reverse cumulative sum d(dt A), ddt and this chunk's part
    // of dA: warp 0, positions 2 lane and 2 lane + 1
    if (w == 0) {
      float d[2], tt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 2 * lane + r;
        tt[r] = wdt[s] * (tp[s] + tp[kCH + s]);
        d[r] = rowq[s] - colq[s] + ecum[s] * (rp[s] + rp[kCH + s]) - tt[r];
      }
      const float tsum = warp_sum(tt[0] + tt[1]);
      float esum = 0.f;
#pragma unroll
      for (int j = 0; j < kGradThreads / 32; ++j) esum += ep[j];
      if (lane == 31) d[1] += expf(cum[kCH - 1]) * esum + tsum;
      // suffix sums over lanes of the pairs: v = sum of lanes >= lane
      float v = d[0] + d[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
      float after = __shfl_down_sync(0xffffffffu, v, 1);
      if (lane == 31) after = 0.f;
      const float da1 = after + d[1], da0 = da1 + d[0];
      const float da[2] = {da0, da1};
      T* ddtb = ddt + ((long long)bi * a.L + l0) * a.H + h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 2 * lane + r;
        if (s < nt)
          ddtb[(long long)s * a.H] =
              from_f<T>(dp[s] + dp[kCH + s] + Ah * da[r]);
      }
      const float pa = warp_sum(dts[2 * lane] * da0 + dts[2 * lane + 1] * da1);
      if (lane == 0) part_a[((long long)bi * a.nc + k) * a.H + h] = pa;
    }
  }

  // this head block's part of the group's dB and dC
  const long long row0 = (long long)bi * a.L + l0;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    if (u < live_n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * i + gq + 8 * (e / 2);
        const int n = 8 * (half + 2 * u) + 2 * tq + (e & 1);
        if (s < nt && n < a.N) {
          const long long o =
              (((row0 + s) * a.G + g) * ba.nb + jb) * a.N + n;
          part_b[o] = dbacc[0][u][e];
          part_c[o] = dcacc[0][u][e];
        }
      }
    }
  }
}

// ------------------------------ (d) the sums ------------------------------ //
// dB and dC [b, L, G, N] (dense): the head blocks' partials in block order
template <typename T>
__global__ void ssd_group_sum_kernel(const float* __restrict__ part_b,
                                     const float* __restrict__ part_c,
                                     T* __restrict__ dB, T* __restrict__ dC,
                                     long long n_out, int nb, int N) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const long long row = e / N;
  const int n = static_cast<int>(e % N);
  const float* pb = part_b + row * nb * N + n;
  const float* pc = part_c + row * nb * N + n;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < nb; ++j) {
    sb += pb[(long long)j * N];
    sc += pc[(long long)j * N];
  }
  dB[e] = from_f<T>(sb);
  dC[e] = from_f<T>(sc);
}

// dA[h]: the (row, chunk) partials of head h, one warp, in a fixed order
__global__ void ssd_da_sum_kernel(const float* __restrict__ part_a,
                                  float* __restrict__ dA, int rows, int H) {
  const int h = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
  for (int r = lane; r < rows; r += 32) s += part_a[(long long)r * H + h];
  s = warp_sum(s);
  if (lane == 0) dA[h] = s;
}

template <typename T, int NB>
int launch_grads(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* gy, const void* work,
                 const void* dwork, void* dx, void* ddt, void* part_b,
                 void* part_c, void* part_a, const SsdArgs& a,
                 const BwdArgs& ba, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * grads_smem_floats(a.NP);
  const int rc = allow_smem(ssd_chunk_grads_kernel<T, NB>, bytes);
  if (rc != 0) return rc;
  ssd_chunk_grads_kernel<T, NB><<<dim3(a.nc, a.G * ba.nb, a.b), kGradThreads,
                                  bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(gy),
      static_cast<const float*>(work), static_cast<const float*>(dwork),
      static_cast<T*>(dx), static_cast<T*>(ddt),
      static_cast<float*>(part_b), static_cast<float*>(part_c),
      static_cast<float*>(part_a), a, ba);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* gy,
                    const void* gstate, void* dx, void* ddt, void* dA,
                    void* dB, void* dC, void* work, void* decay, void* state,
                    void* dwork, void* part_b, void* part_c, void* part_a,
                    SsdArgs a, BwdArgs ba, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  a.vec_x = vec_ok(x, a.x_sb, a.x_sl, a.x_sh, a.P, V);
  a.vec_b = vec_ok(B, a.B_sb, a.B_sl, a.B_sg, a.N, V);
  a.vec_c = vec_ok(C, a.C_sb, a.C_sl, a.C_sg, a.N, V);
  ba.vec_gy = vec_ok(gy, ba.gy_sb, ba.gy_sl, ba.gy_sh, a.P, 4);
  if (sizeof(float) * grads_smem_floats(a.NP) > 232448) return -1;
  const size_t cb_bytes = sizeof(float) * contrib_smem_floats(a.NP);
  const auto contrib = a.NP <= 16 ? ssd_dstate_contrib_kernel<T, 2>
                                  : ssd_dstate_contrib_kernel<T, 8>;
  int rc = allow_smem(contrib, cb_bytes);
  if (rc == 0) rc = launch_states<T>(x, dt, A, B, work, decay, state, a,
                                     stream);
  if (rc != 0) return rc;
  if (a.nc > 0) {
    contrib<<<dim3(a.nc, a.H, a.b), kThreads, cb_bytes, stream>>>(
        static_cast<const T*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(C), static_cast<const float*>(gy),
        static_cast<float*>(dwork), a, ba);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const int tile4 = kPP * a.NP / 4;
    ssd_dstate_passing_kernel<<<dim3((tile4 + kPassThreads - 1) /
                                         kPassThreads,
                                     a.H, a.b),
                                kPassThreads, 0, stream>>>(
        static_cast<float*>(dwork), static_cast<const float*>(decay),
        static_cast<const float*>(gstate), a);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    // column tiles of dB / dC a warp holds: ceil(NP / 16)
    const auto grads = a.NP <= 16   ? launch_grads<T, 1>
                       : a.NP <= 32 ? launch_grads<T, 2>
                       : a.NP <= 64 ? launch_grads<T, 4>
                                    : launch_grads<T, 8>;
    rc = grads(x, dt, A, B, C, gy, work, dwork, dx, ddt, part_b, part_c,
               part_a, a, ba, stream);
    if (rc != 0) return rc;
    const long long n_out = (long long)a.b * a.L * a.G * a.N;
    if (n_out > 0) {
      ssd_group_sum_kernel<T><<<static_cast<unsigned>((n_out + 255) / 256),
                                256, 0, stream>>>(
          static_cast<const float*>(part_b), static_cast<const float*>(part_c),
          static_cast<T*>(dB), static_cast<T*>(dC), n_out, ba.nb, a.N);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
    }
  }
  ssd_da_sum_kernel<<<a.H, 32, 0, stream>>>(static_cast<const float*>(part_a),
                                            static_cast<float*>(dA),
                                            a.b * a.nc, a.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code (x, dt, B and C share it, and so do dx, ddt, dB and dC): 0 =
// float32, 1 = bfloat16; A, dA [H] f32; gy (dy) [b, L, H, P] f32 with any
// strides and a dense last dim; gstate (dS) [b, H, P, N] dense f32 or null.
// dx [b, L, H, P], ddt [b, L, H], dB / dC [b, L, G, N] are dense.  Scratch,
// all f32, the caller allocates: `work` and `dwork` of b * H * ceil(L /
// chunk) * 64 * NP floats (NP = N rounded up to 8), `decay` of b * H *
// ceil(L / chunk), `state` of b * H * P * N, `part_b` and `part_c` of b * L
// * G * nb * N (nb = ceil(H / G / hb)), `part_a` of b * ceil(L / chunk) *
// H.  Strides in elements.  Returns cudaGetLastError() after the launches,
// or -1 for a configuration this file was not built for.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* gy, const void* gstate, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* work, void* decay, void* state,
    void* dwork, void* part_b, void* part_c, void* part_a, int b, int L,
    int H, int G, int P, int N, int chunk, int hb, long long x_sb,
    long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long B_sb, long long B_sl, long long B_sg,
    long long C_sb, long long C_sl, long long C_sg, long long gy_sb,
    long long gy_sl, long long gy_sh, int dtype, void* stream) {
  if (G <= 0 || H % G != 0 || chunk <= 0 || chunk > kCH || P <= 0 ||
      P > kPP || N <= 0 || N > 128 || hb <= 0)
    return -1;
  const int NP = (N + 7) / 8 * 8;
  const SsdArgs a{b, L, H, G, P, N, NP, chunk, (L + chunk - 1) / chunk,
                  x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,
                  B_sb, B_sl, B_sg, C_sb, C_sl, C_sg, false, false, false};
  const BwdArgs ba{gy_sb, gy_sl, gy_sh, (P + 7) / 8 * 8, hb,
                   (H / G + hb - 1) / hb, false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(x, dt, A, B, C, gy, gstate, dx, ddt, dA,
                                  dB, dC, work, decay, state, dwork, part_b,
                                  part_c, part_a, a, ba, st);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(x, dt, A, B, C, gy, gstate, dx,
                                          ddt, dA, dB, dC, work, decay, state,
                                          dwork, part_b, part_c, part_a, a,
                                          ba, st);
  return -1;
}
