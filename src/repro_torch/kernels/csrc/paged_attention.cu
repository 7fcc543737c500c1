// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_decode_attention (its pallas_call at :134).  One query token per
// row attends the row's KV, scattered over a shared page pool
// [P, ps, K, d] and named by the row's block table.
//
// What bounds it on this card: bytes.  Each row reads 2 * len * K * d pool
// elements and does about 4 * G flops per element read (G = H / K query
// heads per KV head), far below the H100's ~295 flops per byte, so the
// least time is (K/V pages read + q + out) / 3.35 TB/s.
//
// Design: one CTA per (row, KV head), one warp per query head of that KV
// head's GQA group, so a page tile is read from device memory once and
// used by all G heads.  The CTA walks only the row's live positions,
// min(len, nb * ps): pages past the length are never read, and the table
// is never indexed past its width, which keeps frozen rows inside a decode
// horizon (their length may point past the table they were masked to)
// in bounds.  Softcap is applied before the length mask; a row of length 0
// writes zeros.  Simple first: no split over the page stream (with
// B * K < 132 CTAs most SMs idle), no TMA, no tensor cores.

#include "paged_common.cuh"

namespace {

using namespace paged;

struct DecodeArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const int32_t* bt;
  const int32_t* lengths;
  void* out;
  int B, H, K, ps, nb;
  float scale, cap;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
__global__ void paged_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ kp,
                                    const TKV* __restrict__ vp,
                                    const int32_t* __restrict__ bt,
                                    const int32_t* __restrict__ lengths,
                                    TQ* __restrict__ out, int H, int K, int ps,
                                    int nb, float scale, float cap) {
  constexpr int TPP = 32;
  constexpr int TT = Tile<D>::TT;
  constexpr int DPT = D / TPP;
  __shared__ float ks[TT * D];
  __shared__ float vs[TT * D];

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / K;
  const int g = threadIdx.x / TPP, sub = threadIdx.x % TPP;
  const int64_t qoff = ((int64_t)b * H + h * G + g) * D;

  PairState<D, TPP> st;
  st.init();
#pragma unroll
  for (int i = 0; i < DPT; ++i) st.q[i] = to_f(q[qoff + sub + TPP * i]) * scale;

  const int n = min(max(lengths[b], 0), nb * ps);
  const int32_t* bt_row = bt + (int64_t)b * nb;
  for (int p0 = 0; p0 < n; p0 += TT) {
    const int nt = min(TT, n - p0);
    __syncthreads();                     // previous tile fully consumed
    load_page_tile<TKV, D, TT>(ks, vs, kp, vp, bt_row, ps, K, h, p0, nt);
    __syncthreads();
    attend_tile<D, TPP, TT>(st, ks, vs, nt, nt, sub, cap);
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) out[qoff + sub + TPP * i] = from_f<TQ>(st.out(i));
}

template <typename TQ, typename TKV, int D>
int launch(const DecodeArgs& a) {
  dim3 grid(a.B, a.K);
  dim3 block(32 * (a.H / a.K));
  paged_decode_kernel<TQ, TKV, D><<<grid, block, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.bt, a.lengths, static_cast<TQ*>(a.out),
      a.H, a.K, a.ps, a.nb, a.scale, a.cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const DecodeArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q f32 needs f32 pools.  Returns
// cudaGetLastError() after the launch, or -1 for a configuration this file
// was not built for.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int B, int H,
    int K, int d, int ps, int nb, int q_dtype, int kv_dtype, float scale,
    float cap, void* stream) {
  DecodeArgs a{q, k_pages, v_pages,
               static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(lengths), out, B, H, K, ps, nb,
               scale, cap, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
