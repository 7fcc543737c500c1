// Device helpers shared by the paged attention kernels: the paged pool's
// row addressing and the CUDA-core tile attention of the f32 paths (paged
// prefill, flash).
//
// The CUDA-core paths stream a row's KV through shared memory in tiles of TT
// positions (K and V as f32, 32 KB per tile pair whatever the head width)
// and keep one flash-style online softmax per (query, head) pair.  A pair
// is spread over TPP neighbouring threads of one warp: thread `sub` of the
// group holds dims sub, sub + TPP, sub + 2*TPP, ... of q and of the
// accumulator, so a warp's reads of one shared-memory row touch TPP
// consecutive words (no bank conflicts) and a group sum is log2(TPP)
// shuffles.
#pragma once

#include "sm90_common.cuh"

namespace paged {

// the conversions and copies of sm90_common.cuh, unqualified here and in
// every file that uses this namespace
using namespace sm90;

constexpr float kNegInf = -1.0e30f;

// Positions per shared-memory tile: 2 * TT * D * 4 bytes = 32 KB.
template <int D>
struct Tile {
  static constexpr int TT = 4096 / D;
};

template <int D, int TPP>
struct PairState {
  static constexpr int DPT = D / TPP;
  float q[DPT];
  float acc[DPT];
  float m;
  float l;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  // Output value of dim sub + TPP * i; a pair that attended nothing
  // (l == 0) writes exact zeros.
  __device__ __forceinline__ float out(int i) const {
    return acc[i] / (l == 0.f ? 1.f : l);
  }
};

// Sum over the TPP lanes of an aligned lane group.  Every lane of the warp
// must call it (full shuffle mask).
template <int TPP>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One tile of the online softmax.  ks/vs: [TT][D] f32 in shared memory.
// nt (the same for the whole block) positions of the tile are loaded; this
// pair attends the first n_valid of them (0 <= n_valid <= nt).  Every lane
// runs the score loop to nt, so the shuffles see a full warp even where
// pairs of one warp have different causal limits.
template <int D, int TPP, int TT>
__device__ __forceinline__ void attend_tile(PairState<D, TPP>& st,
                                            const float* ks, const float* vs,
                                            int nt, int n_valid, int sub,
                                            float cap) {
  constexpr int DPT = D / TPP;
  float s[TT];
  float mt = kNegInf;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t < nt) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += st.q[i] * ks[t * D + sub + TPP * i];
      float x = group_sum<TPP>(part);
      if (cap > 0.f) x = cap * tanhf(x / cap);   // softcap before the mask
      s[t] = x;
      if (t < n_valid) mt = fmaxf(mt, x);
    }
  }
  if (n_valid <= 0) return;
  const float m_new = fmaxf(st.m, mt);
  const float corr = expf(st.m - m_new);
  st.l *= corr;
#pragma unroll
  for (int i = 0; i < DPT; ++i) st.acc[i] *= corr;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t < n_valid) {
      const float p = expf(s[t] - m_new);
      st.l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) st.acc[i] += p * vs[t * D + sub + TPP * i];
    }
  }
  st.m = m_new;
}

// Load positions [p0, p0 + nt) of one KV head of a paged row into the
// tile.  bt_row holds the row's page ids; the caller keeps p0 + nt within
// the table (nb * ps), so no entry past the row is read.
template <typename TKV, int D, int TT>
__device__ __forceinline__ void load_page_tile(float* ks, float* vs,
                                               const TKV* kp, const TKV* vp,
                                               const int32_t* bt_row, int ps,
                                               int K, int h, int p0, int nt) {
  for (int e = threadIdx.x; e < nt * D; e += blockDim.x) {
    const int t = e / D, j = e % D;
    const int p = p0 + t;
    const int64_t page = bt_row[p / ps];
    const int64_t off = ((page * ps + p % ps) * K + h) * D + j;
    ks[e] = to_f(kp[off]);
    vs[e] = to_f(vp[off]);
  }
}

// Position p of one (row, KV head h) of a paged pool [P, ps, K, D]: the
// contiguous row ((bt_row[p / ps] * ps + p % ps) * K + h) * D.  The caller
// keeps p < nb * ps, so no table entry past the row is read.
template <typename TKV, int D>
struct PagedRows {
  const TKV* kp;
  const TKV* vp;
  const int32_t* bt_row;
  int ps, K, h;
  __device__ __forceinline__ long long off(int p) const {
    return (((long long)bt_row[p / ps] * ps + p % ps) * K + h) * D;
  }
  __device__ __forceinline__ const TKV* k(int p) const { return kp + off(p); }
  __device__ __forceinline__ const TKV* v(int p) const { return vp + off(p); }
};

}  // namespace paged
