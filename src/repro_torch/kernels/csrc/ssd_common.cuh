// The Mamba-2 SSD scan's device code that its forward (ssd_scan.cu) and
// its backward (ssd_scan_bwd.cu) share: the tiles and their shared-memory
// layout, the 3xTF32 products on mma.sync, the loads, the within-chunk
// cumulative sum, and the forward's passes (a) the chunks' states and (b)
// the state passing, which the backward reruns to recompute the states
// entering each chunk.  ssd_scan.cu's header says what they compute.
#pragma once

#include "sm90_common.cuh"

namespace {

using sm90::allow_smem;
using sm90::cp_async16_zfill;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::mma_tf32;
using sm90::to_f;

constexpr int kCH = 64;              // positions per chunk tile
constexpr int kPP = 64;              // head-dim (P) tile
constexpr int kThreads = 128;       // pass (a): 4 warps
constexpr int kOutThreads = 256;    // pass (c): 8 warps
constexpr int kLDX = kPP + 4;        // x tile row stride, 4 mod 8 words
constexpr int kLDW = kCH + 8;        // W tile row stride, 8 mod 32 words
constexpr int kPassThreads = 256;
static_assert(kCH == kPP, "stage() copies kCH rows, also for the state");
static_assert(kCH == 64, "pass (c)'s warp tables assume 4 row tiles");

struct SsdArgs {
  int b, L, H, G, P, N, NP, chunk, nc;   // NP: N rounded up to 8
  // element strides (batch, position, head / group); the last dim is dense
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long B_sb, B_sl, B_sg;
  long long C_sb, C_sl, C_sg;
  bool vec_x, vec_b, vec_c;              // 16-byte loads allowed
};

// row stride (floats) of an [rows][NP] tile: 4 mod 8 words
__host__ __device__ inline int ld_n(int NP) { return NP + 4; }

__host__ __device__ inline int states_smem_floats(int NP) {
  return kCH * kLDX + kCH * ld_n(NP) + kCH;
}
__host__ __device__ inline int outputs_smem_floats(int NP) {
  return 2 * kCH * ld_n(NP) + kCH * kLDX + kCH * kLDW + kCH;
}

// ----------------------------- 3xTF32 products ---------------------------- //
// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds, in f32 format
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));   // x - big is exact
}

struct AFrag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ AFrag split4(float a0, float a1, float a2,
                                        float a3) {
  AFrag f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

// The 3xTF32 products of R row tiles (A fragments a[r]) against NB column
// tiles (B fragments split into bb / bs), phase by phase: the small x big
// terms of every tile, then big x small, then big x big, so consecutive
// mma.sync feed different accumulators.
// Row tile r takes part where r >= r0; column tile n where n < live.
template <int R, int NB>
__device__ __forceinline__ void mma3_tiles(float (&acc)[R][NB][4],
                                           const AFrag (&a)[R],
                                           const uint32_t (&bb)[NB][2],
                                           const uint32_t (&bs)[NB][2],
                                           int r0 = 0, int live = NB) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (r >= r0 && n < live)
        mma_tf32(acc[r][n], a[r].small, bb[n][0], bb[n][1]);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (r >= r0 && n < live)
        mma_tf32(acc[r][n], a[r].big, bs[n][0], bs[n][1]);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (r >= r0 && n < live)
        mma_tf32(acc[r][n], a[r].big, bb[n][0], bb[n][1]);
}

// --------------------------------- loads ---------------------------------- //
// Rows [0, kCH) x columns [0, wpad) of a tile with row stride ld: row r <
// live holds src[r * rs + c] for c < width, everything else is zero.  With
// `vec` (base and strides 16-byte aligned, width a multiple of the vector)
// 16 bytes a thread: cp.async for f32 (the caller commits and waits), a
// register load widened to f32 for bf16; else one element a thread.
template <int NT, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long rs, int live, int width,
                                      int wpad, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = wpad / V;
    for (int e = threadIdx.x; e < kCH * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * V;
      const bool ok = r < live && c < width;
      const T* s = src + (ok ? r * rs + c : 0);
      float* d = dst + r * ld + c;
      if constexpr (sizeof(T) == 4) {
        cp_async16_zfill(d, s, ok);
      } else {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (ok) u = __ldg(reinterpret_cast<const uint4*>(s));
        // bf16 element 2i is the low half of word i, 2i + 1 the high half
        reinterpret_cast<float4*>(d)[0] = make_float4(
            __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
            __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        reinterpret_cast<float4*>(d)[1] = make_float4(
            __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
            __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    }
  } else {
    for (int e = threadIdx.x; e < kCH * wpad; e += NT) {
      const int r = e / wpad, c = e % wpad;
      dst[r * ld + c] = r < live && c < width ? to_f(src[r * rs + c]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_dt(float* dts, const T* dt,
                                         long long rs, int live) {
  const int t = threadIdx.x;
  if (t < kCH) dts[t] = t < live ? to_f(dt[t * rs]) : 0.f;
}

// The inclusive cumulative sum of dt * A over the tile, in registers: lane
// l holds positions 2l (c0) and 2l + 1 (c1).  Every warp computes the same
// values in the same order, so no warp waits on another.
__device__ __forceinline__ void chunk_cum(const float* dts, float Ah,
                                          float& c0, float& c1) {
  const int lane = threadIdx.x % 32;
  const float2 d = reinterpret_cast<const float2*>(dts)[lane];
  const float d0 = d.x * Ah, d1 = d.y * Ah;
  float v = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  float ex = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) ex = 0.f;
  c0 = ex + d0;
  c1 = c0 + d1;
}

// cum at position s, from chunk_cum's registers (every lane must call it)
__device__ __forceinline__ float cum_at(float c0, float c1, int s) {
  const float u0 = __shfl_sync(0xffffffffu, c0, s / 2);
  const float u1 = __shfl_sync(0xffffffffu, c1, s / 2);
  return (s & 1) ? u1 : u0;
}

// ------------------------- (a) the chunks' states ------------------------- //
// One CTA per (chunk, head, row).  Warp w computes rows p in [16w, 16w + 16)
// of the chunk's contribution, [kPP, NP] (rows >= P and columns >= N are
// exact zeros), NB column tiles at a time, and writes it to its tile of
// `work`.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_states_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ A,
                        const T* __restrict__ Bm, float* __restrict__ work,
                        float* __restrict__ decay, SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int LDN = ld_n(a.NP);
  float* xs = smem;                  // [kCH][kLDX]
  float* bs = xs + kCH * kLDX;       // [kCH][LDN]
  float* dts = bs + kCH * LDN;       // [kCH]

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int l0 = k * a.chunk, nt = min(a.chunk, a.L - l0);
  stage<kThreads, T>(xs, kLDX, x + bi * a.x_sb + l0 * a.x_sl + h * a.x_sh,
                     a.x_sl, nt, a.P, kPP, a.vec_x);
  stage<kThreads, T>(bs, LDN, Bm + bi * a.B_sb + l0 * a.B_sl + g * a.B_sg,
                     a.B_sl, nt, a.N, a.NP, a.vec_b);
  stage_dt<T>(dts, dt + bi * a.dt_sb + l0 * a.dt_sl + h * a.dt_sh, a.dt_sl,
              nt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float c0, c1;
  chunk_cum(dts, A[h], c0, c1);
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  // exp(cum_last - cum[t]) dt[t] at this lane's positions 8j + 2tq, + 1
  float wt[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t0 = __shfl_sync(0xffffffffu, c0, 4 * j + tq);
    const float t1 = __shfl_sync(0xffffffffu, c1, 4 * j + tq);
    const float2 d = reinterpret_cast<const float2*>(dts)[4 * j + tq];
    wt[j][0] = expf(last - t0) * d.x;
    wt[j][1] = expf(last - t1) * d.y;
  }

  // A[p][t] = x[t][p] w[t] (permuted: A column tq is position 8j + 2tq,
  // tq + 4 is 8j + 2tq + 1), B[t][n] = B[t][n]
  const float* xa = xs + 2 * tq * kLDX + 16 * w + gq;
  float* out = work + (((long long)bi * a.H + h) * a.nc + k) * kPP * a.NP;
  for (int n0 = 0; n0 < a.NP; n0 += 8 * NB) {
    const int live = min(NB, (a.NP - n0) / 8);
    float acc[1][NB][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* xr = xa + 8 * j * kLDX;
      const AFrag f[1] = {split4(xr[0] * wt[j][0], xr[8] * wt[j][0],
                                 xr[kLDX] * wt[j][1],
                                 xr[kLDX + 8] * wt[j][1])};
      const float* br = bs + (8 * j + 2 * tq) * LDN + n0 + gq;
      uint32_t bb[NB][2], bsm[NB][2];
#pragma unroll
      for (int ni = 0; ni < NB; ++ni) {
        if (ni < live) {
          split(br[8 * ni], bb[ni][0], bsm[ni][0]);
          split(br[LDN + 8 * ni], bb[ni][1], bsm[ni][1]);
        }
      }
      mma3_tiles(acc, f, bb, bsm, 0, live);
    }
    const int p = 16 * w + gq;
#pragma unroll
    for (int ni = 0; ni < NB; ++ni) {
      const int n = n0 + 8 * ni + 2 * tq;
      if (ni < live) {
        *reinterpret_cast<float2*>(out + p * a.NP + n) =
            make_float2(acc[0][ni][0], acc[0][ni][1]);
        *reinterpret_cast<float2*>(out + (p + 8) * a.NP + n) =
            make_float2(acc[0][ni][2], acc[0][ni][3]);
      }
    }
  }
  if (threadIdx.x == 0)
    decay[((long long)bi * a.H + h) * a.nc + k] = expf(last);
}

// ---------------------------- (b) state passing --------------------------- //
// One thread per 4 floats of a (row, head)'s [kPP, NP] state, in chunk
// order: the state entering chunk k replaces chunk k's contribution in
// `work` (k >= 1); the state after the last chunk goes to `state_out`.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_passing_kernel(float* __restrict__ work,
                         const float* __restrict__ decay,
                         float* __restrict__ state_out, SsdArgs a) {
  const int tile4 = kPP * a.NP / 4;
  const int e4 = blockIdx.x * kPassThreads + threadIdx.x;
  if (e4 >= tile4) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float4* st = reinterpret_cast<float4*>(work) + bh * a.nc * tile4 + e4;
  const float* dk = decay + bh * a.nc;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  // kBatch chunks' loads in flight at once, then their updates in order
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < a.nc; k0 += kBatch) {
    float4 v[kBatch];
    float d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 + i < a.nc) {
        v[i] = st[(long long)(k0 + i) * tile4];
        d[i] = dk[k0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 + i < a.nc) {
        if (k0 + i > 0) st[(long long)(k0 + i) * tile4] = S;
        S = make_float4(fmaf(S.x, d[i], v[i].x), fmaf(S.y, d[i], v[i].y),
                        fmaf(S.z, d[i], v[i].z), fmaf(S.w, d[i], v[i].w));
      }
    }
  }
  const int p = 4 * e4 / a.NP, n = 4 * e4 % a.NP;
  if (p >= a.P) return;
  float* so = state_out + (bh * a.P + p) * a.N;
  const float s4[4] = {S.x, S.y, S.z, S.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < a.N) so[n + i] = s4[i];
}

// 16-byte loads of a [.., rows, width] tensor: base and strides aligned
bool vec_ok(const void* p, long long s0, long long s1, long long s2,
            int width, int elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % elems == 0 &&
         s1 % elems == 0 && s2 % elems == 0 && width % elems == 0;
}

// Passes (a) and (b) on `stream`: `work` ends holding the state entering
// each chunk k >= 1 (chunk 0's slot keeps its own contribution: the state
// entering it is 0), `decay` exp(cum_last) of each chunk, `state` the
// state after the last chunk.  `a` carries its vec flags.
template <typename T>
int launch_states(const void* x, const void* dt, const void* A,
                  const void* B, void* work, void* decay, void* state,
                  const SsdArgs& a, cudaStream_t stream) {
  const size_t st_bytes = sizeof(float) * states_smem_floats(a.NP);
  // column tiles a pass (a) warp holds at once: 2 where N <= 16
  const auto states = a.NP <= 16 ? ssd_chunk_states_kernel<T, 2>
                                 : ssd_chunk_states_kernel<T, 8>;
  int rc = allow_smem(states, st_bytes);
  if (rc != 0) return rc;
  float* wk = static_cast<float*>(work);
  float* dk = static_cast<float*>(decay);
  if (a.nc > 0) {
    states<<<dim3(a.nc, a.H, a.b), kThreads, st_bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B), wk, dk, a);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const int tile4 = kPP * a.NP / 4;
  ssd_state_passing_kernel<<<dim3((tile4 + kPassThreads - 1) / kPassThreads,
                                  a.H, a.b),
                             kPassThreads, 0, stream>>>(
      wk, dk, static_cast<float*>(state), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
