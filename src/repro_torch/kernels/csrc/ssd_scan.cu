// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan (defined
// at :73, its pallas_call at :86).  For each (row, head) it runs the
// state-space recurrence
//   state_t = exp(dt_t * A) * state_{t-1} + (dt_t * x_t) outer B_t,
//   y_t     = state_t . C_t
// in the chunked (state-space duality) form: per chunk of c positions,
// with cum = the inclusive cumulative sum of dt * A over the chunk,
//   y[s]   = sum_{t <= s} (C[s] . B[t]) exp(cum[s] - cum[t]) dt[t] x[t]
//            + exp(cum[s]) C[s] . state,
//   state' = exp(cum[c-1]) state
//            + sum_t exp(cum[c-1] - cum[t]) dt[t] x[t] outer B[t].
// Head h reads SSD group h // (H / G).  The serving model calls it in every
// mamba / hybrid layer of every prefill.
//
// What bounds it on this card.  The least time is the larger of its bytes
// (x, dt, B and C read once, y and the final state written once: ~8 bytes
// per x element in f32) and its products (2 (c N / 2 + c P / 2 + 2 P N)
// flops per position and head in the chunked form, each run as three TF32
// products for f32 accuracy, below) at 495 TFLOP/s: the products at
// Mamba2-130m's served prefill (b = 8, L = 1152, H = 24, P = 64, N = 128,
// c = 64; 0.061 ms against 0.039 ms of bytes), the bytes at Hymba's (H =
// 50, N = 16; 0.072 ms against 0.026 ms).  What holds it above that
// (NVIDIA H100, chip_smoke.py and builds of this file with parts removed):
// the chunk states below, b H (L / c) P N f32 of scratch written, read and
// rewritten, and read again (~0.45 GB at Mamba2's served prefill; pass (b)
// alone is a fifth of the scan there); x read by passes (a) and (c); and
// mma.sync's TF32 rate, which the 3xTF32 split triples.
//
// What the design does (the single-pass kernel before it walked each
// (row, head)'s chunks in series in one CTA, on the f32 CUDA cores):
//  1. Three chunk-parallel passes on the caller's stream, so the grid is
//     (row, head, chunk) and not (row, head): 3,456 tiles at Mamba2's
//     served prefill instead of 192 serial walks, 7,200 at Hymba's.
//     (a) ssd_chunk_states_kernel: per chunk, cum (each warp scans the 64
//         positions in registers, two a lane, so no barrier), exp(cum_last)
//         into `decay`, and the chunk's own contribution
//         sum_t exp(cum_last - cum[t]) dt[t] x[t] outer B[t], [P, N], into
//         `work`; 4 warps, one 16-row tile of P each.
//     (b) ssd_state_passing_kernel: elementwise over (row, head, 4 floats
//         of [P, N]), in chunk order, the only serial part:
//         S_in[k] = decay[k-1] S_in[k-1] + contribution[k-1], written over
//         the contribution in place (S_in[0] = 0 is never stored or read),
//         and the final state; eight chunks' loads in flight a thread.
//     (c) ssd_chunk_outputs_kernel: per chunk, y = (L o C B^T)(dt x) +
//         (exp(cum) C) S_in^T, with L[s, t] = exp(cum[s] - cum[t]) for t <=
//         s (never exp(cum[s]) exp(-cum[t]), which overflows once cum runs
//         far negative).  8 warps: the 20 causal score tiles split 3 / 2 a
//         warp, W = L o C B^T through shared memory, and the y products
//         split evenly by pairing row tiles {0, 3} and {1, 2} (the causal
//         work of row tile i grows with i).
//     The summation order is fixed (no atomics, no order set by the
//     scheduler), so repeated launches are bit-identical.  (b) is not fused
//     into (a) or (c): either would make a CTA wait on its predecessor.
//  2. The four products (C B^T, its masked weighted sum over x, (x w)^T B
//     and C S_in^T) run on mma.sync.m16n8k8 TF32 in the 3xTF32 split: each
//     f32 operand a is big + small, big = tf32(a), small = tf32(a - big),
//     and a b ~ small b_big + big b_small + big b_big in f32 (the small x
//     small term, ~2^-22 relative, is dropped).  Plain TF32 (~2^-11) would
//     miss the 2e-5 relative gate.  Rounding is round to nearest, ties away
//     from zero (cvt.rna's), done with two integer operations.  The three
//     mma.sync of a product go phase by phase over a warp's independent
//     accumulators, not back to back into one.  bf16 inputs widen exactly
//     to f32 and take the same path.  The fragment layouts are
//     paged_prefill.cu's: where a product's A operand is the C fragment of
//     the one before or a transposed tile (x^T), the contraction index is
//     permuted (A column t is position 2t, t + 4 is 2t + 1), so a lane's C
//     pair is its A pair and B reads rows 2t and 2t + 1.  Tile rows are
//     padded to 4 mod 8 words (W's to 8 mod 32, read as float2), which
//     keeps every fragment read free of bank conflicts.
//  3. x, B and C tiles arrive by 16-byte cp.async where the base and
//     strides allow (f32), by 16-byte loads widened in registers (bf16),
//     else one element a thread: one kernel, three load paths chosen from
//     the strides.  In (c) the entering state is copied into B's buffer
//     once the scores are done, in flight while W x is computed.  A CTA of
//     pass (c) holds 104 KB at N = 128 (B and the state share a buffer),
//     so two fit an SM and their loads overlap each other's products; 46
//     KB at N = 16.
// Measured on the card and not kept, each slower or no faster: persistent
// CTAs on a two-stage cp.async ring, launches over blocks of rows sized to
// L2, 4-warp CTAs for pass (c) (faster at N = 16 only).  Not done: C B^T
// shared across the heads of a group; the state passing fused into pass
// (a), which would chain each (row, head)'s CTAs one after another.
//
// Tiles are 64 positions by a head dim of 64, so chunk <= 64 and P <= 64
// (the served families have chunk 64 and P = 64); a shorter chunk or head
// dim pads its tile with positions of dt = 0 and columns of zeros, which
// add exact zeros.  Positions past L load as dt = x = B = C = 0 and write
// nothing; dt = 0 leaves the state exactly as it was, so right-padded
// prefill rows carry their state through the padding.

// The passes' shared device code (tiles, loads, 3xTF32 products, passes
// (a) and (b)) lives in ssd_common.cuh, which the backward
// (ssd_scan_bwd.cu) includes too.

#include "ssd_common.cuh"

namespace {

// ---------------------------- (c) the outputs ----------------------------- //
// One CTA of 8 warps per (chunk, head, row).  The 20 score tiles (row tile
// i of 16 positions, key tile j of 8, j <= 2i + 1) go in runs of one row
// tile a warp, 3 or 2 tiles each: warp w takes key tiles [J0, J0 + CNT) of
// row tile I, read from the nibble w of the tables below.  W goes through
// shared memory, so the y products are split evenly too: warp w computes
// row tiles {0, 3} (w < 4) or {1, 2} (w >= 4), whose causal key tiles sum
// to 10 either way, against columns [16 (w % 4), + 16) of P.
constexpr uint32_t kScoreI = 0x01122333u;     // row tile, w = 0 in nibble 0
constexpr uint32_t kScoreJ0 = 0x02030630u;    // first key tile
constexpr uint32_t kScoreCnt = 0x22233233u;   // key tiles (3 or 2)

__device__ __forceinline__ int nibble(uint32_t table, int w) {
  return static_cast<int>((table >> (4 * w)) & 0xfu);
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads)
ssd_chunk_outputs_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                         const float* __restrict__ A,
                         const T* __restrict__ Bm, const T* __restrict__ Cm,
                         const float* __restrict__ work, float* __restrict__ y,
                         SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int LDN = ld_n(a.NP);
  float* cs = smem;                  // [kCH][LDN] C
  float* bs = cs + kCH * LDN;        // [kCH][LDN] B, then S_in [kPP][NP]
  float* xs = bs + kCH * LDN;        // [kCH][kLDX]
  float* ws = xs + kCH * kLDX;       // [kCH][kLDW] W
  float* dts = ws + kCH * kLDW;      // [kCH]

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int l0 = k * a.chunk, nt = min(a.chunk, a.L - l0);
  stage<kOutThreads, T>(cs, LDN, Cm + bi * a.C_sb + l0 * a.C_sl + g * a.C_sg,
                        a.C_sl, nt, a.N, a.NP, a.vec_c);
  stage<kOutThreads, T>(bs, LDN, Bm + bi * a.B_sb + l0 * a.B_sl + g * a.B_sg,
                        a.B_sl, nt, a.N, a.NP, a.vec_b);
  stage<kOutThreads, T>(xs, kLDX,
                        x + bi * a.x_sb + l0 * a.x_sl + h * a.x_sh, a.x_sl,
                        nt, a.P, kPP, a.vec_x);
  stage_dt<T>(dts, dt + bi * a.dt_sb + l0 * a.dt_sl + h * a.dt_sh, a.dt_sl,
              nt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float c0, c1;
  chunk_cum(dts, A[h], c0, c1);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;

  // this warp's score tiles C B^T: A = C rows of row tile si, B[n][t] =
  // B[t][n]; the A fragment is split once for all of them
  const int si = nibble(kScoreI, w), sj0 = nibble(kScoreJ0, w);
  const int scnt = nibble(kScoreCnt, w);
  float sc[1][3][4] = {};
  {
    const float* ca = cs + (16 * si + gq) * LDN + tq;
    for (int k0 = 0; k0 < a.NP; k0 += 8) {
      const AFrag f[1] = {split4(ca[k0], ca[8 * LDN + k0], ca[k0 + 4],
                                 ca[8 * LDN + k0 + 4])};
      uint32_t bb[3][2], bsm[3][2];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (u < scnt) {
          const float* br = bs + (8 * (sj0 + u) + gq) * LDN + k0 + tq;
          split(br[0], bb[u][0], bsm[u][0]);
          split(br[4], bb[u][1], bsm[u][1]);
        }
      }
      mma3_tiles(sc, f, bb, bsm, 0, scnt);
    }
  }
  // W = scores exp(cum[s] - cum[t]) dt[t] for t <= s, else 0, into ws
  {
    const int s = 16 * si + gq;
    const float cs0 = cum_at(c0, c1, s), cs1 = cum_at(c0, c1, s + 8);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int j = sj0 + min(u, scnt - 1);
      const float t0 = __shfl_sync(0xffffffffu, c0, 4 * j + tq);
      const float t1 = __shfl_sync(0xffffffffu, c1, 4 * j + tq);
      if (u < scnt) {
        const float2 d = reinterpret_cast<const float2*>(dts)[4 * j + tq];
        const int t = 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(ws + s * kLDW + t) = make_float2(
            t <= s ? sc[0][u][0] * expf(cs0 - t0) * d.x : 0.f,
            t + 1 <= s ? sc[0][u][1] * expf(cs0 - t1) * d.y : 0.f);
        *reinterpret_cast<float2*>(ws + (s + 8) * kLDW + t) = make_float2(
            t <= s + 8 ? sc[0][u][2] * expf(cs1 - t0) * d.x : 0.f,
            t + 1 <= s + 8 ? sc[0][u][3] * expf(cs1 - t1) * d.y : 0.f);
      }
    }
  }
  __syncthreads();                   // W is whole; every warp is done with B

  // the entering state into B's buffer, in flight during W x
  const bool carry = k > 0;
  if (carry) {
    stage<kOutThreads, float>(
        bs, LDN, work + (((long long)bi * a.H + h) * a.nc + k) * kPP * a.NP,
        a.NP, kPP, a.NP, a.NP, true);
    cp_async_commit();
  }

  // y = W x on row tiles {pair, 3 - pair} (r = 0, 1), columns [16q, 16q +
  // 16); W's A fragment is read permuted (A column tq is position 8j + 2tq,
  // tq + 4 is 8j + 2tq + 1), so x's B fragment, shared by both row tiles,
  // reads rows 2tq and 2tq + 1.  Row tile r = 0 stops at key tile 2 pair +
  // 1, r = 1 at 7 - 2 pair.
  const int pair = w / 4, q = w % 4;
  float yacc[2][2][4] = {};
  const float* xb = xs + 2 * tq * kLDX + 16 * q + gq;
  const float* wr0 = ws + (16 * pair + gq) * kLDW + 2 * tq;
  const float* wr1 = ws + (16 * (3 - pair) + gq) * kLDW + 2 * tq;
  for (int j = 0; j < 8 - 2 * pair; ++j) {
    const bool both = j <= 2 * pair + 1;
    AFrag f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 || both) {
        const float* wr = (r == 0 ? wr0 : wr1) + 8 * j;
        const float2 lo = *reinterpret_cast<const float2*>(wr);
        const float2 hi = *reinterpret_cast<const float2*>(wr + 8 * kLDW);
        f[r] = split4(lo.x, hi.x, lo.y, hi.y);
      }
    }
    const float* xr = xb + 8 * j * kLDX;
    uint32_t bb[2][2], bsm[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      split(xr[8 * n], bb[n][0], bsm[n][0]);
      split(xr[kLDX + 8 * n], bb[n][1], bsm[n][1]);
    }
    mma3_tiles(yacc, f, bb, bsm, both ? 0 : 1);
  }

  // y += (exp(cum[s]) C) S_in^T; S_in's B fragments are split once for
  // both row tiles
  if (carry) {
    float e[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = 16 * (r == 0 ? pair : 3 - pair) + gq;
      e[r][0] = expf(cum_at(c0, c1, s));
      e[r][1] = expf(cum_at(c0, c1, s + 8));
    }
    cp_async_wait<0>();
    __syncthreads();
    const float* sb = bs + (16 * q + gq) * LDN + tq;
    for (int k0 = 0; k0 < a.NP; k0 += 8) {
      uint32_t bb[2][2], bsm[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        split(sb[8 * n * LDN + k0], bb[n][0], bsm[n][0]);
        split(sb[8 * n * LDN + k0 + 4], bb[n][1], bsm[n][1]);
      }
      AFrag f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r == 0 ? pair : 3 - pair;
        const float* cr = cs + (16 * i + gq) * LDN + k0 + tq;
        f[r] = split4(cr[0] * e[r][0], cr[8 * LDN] * e[r][1],
                      cr[4] * e[r][0], cr[8 * LDN + 4] * e[r][1]);
      }
      mma3_tiles(yacc, f, bb, bsm);
    }
  }

  const long long HP = (long long)a.H * a.P;
  float* yb = y + ((long long)bi * a.L + l0) * HP + (long long)h * a.P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s0 = 16 * (r == 0 ? pair : 3 - pair) + gq;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int p = 16 * q + 8 * n + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + 8 * (e / 2), pe = p + (e & 1);
        if (s < nt && pe < a.P) yb[s * HP + pe] = yacc[r][n][e];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, void* work, void* decay,
           SsdArgs a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  a.vec_x = vec_ok(x, a.x_sb, a.x_sl, a.x_sh, a.P, V);
  a.vec_b = vec_ok(B, a.B_sb, a.B_sl, a.B_sg, a.N, V);
  a.vec_c = vec_ok(C, a.C_sb, a.C_sl, a.C_sg, a.N, V);
  const size_t out_bytes = sizeof(float) * outputs_smem_floats(a.NP);
  if (out_bytes > 232448) return -1;
  int rc = allow_smem(ssd_chunk_outputs_kernel<T>, out_bytes);
  if (rc == 0) rc = launch_states<T>(x, dt, A, B, work, decay, state, a,
                                     stream);
  if (rc != 0 || a.nc == 0) return rc;
  ssd_chunk_outputs_kernel<T><<<dim3(a.nc, a.H, a.b), kOutThreads,
                                out_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(work),
      static_cast<float*>(y), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code (x, dt, B and C share it): 0 = float32, 1 = bfloat16; A is
// f32 [H]; y [b, L, H, P] and state [b, H, P, N] are dense f32.  `work` is
// f32 scratch of b * H * ceil(L / chunk) * 64 * NP floats (NP = N rounded
// up to 8) and `decay` of b * H * ceil(L / chunk); the caller allocates
// both.  Strides in elements.  Returns cudaGetLastError() after the
// launches, or -1 for a configuration this file was not built for.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, void* work, void* decay, int b,
    int L, int H, int G, int P, int N, int chunk, long long x_sb,
    long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long B_sb, long long B_sl, long long B_sg,
    long long C_sb, long long C_sl, long long C_sg, int dtype,
    void* stream) {
  if (G <= 0 || H % G != 0 || chunk <= 0 || chunk > kCH || P <= 0 ||
      P > kPP || N <= 0)
    return -1;
  const int NP = (N + 7) / 8 * 8;
  const SsdArgs a{b, L, H, G, P, N, NP, chunk, (L + chunk - 1) / chunk,
                  x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,
                  B_sb, B_sl, B_sg, C_sb, C_sl, C_sg, false, false, false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, state, work, decay, a, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, work, decay, a,
                                 st);
  return -1;
}
