// Decode attention over a contiguous KV slab for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (defined at :75, its pallas_call at :91).  One query
// token per row attends the row's slab k/v [B, K, T, d] (slot t holds
// position t): slots t < length, and with a window only those with
// length - 1 - t < window; scores q.k * scale in f32, softcap
// cap * tanh(s / cap) before the mask.  The serving model calls it in
// every layer of the hybrid family on the per-slot ring of its sliding
// window, whose valid slots are exactly the first min(pos + 1, W).
//
// What bounds it on this card: bytes.  Each row reads 2 * n * K * d slab
// elements for its n live slots and does about 4 * G flops per element
// read (G = H / K query heads per KV head), far below the H100's ~295
// flops per byte, so the least time is (live K/V + q + out) / 3.35 TB/s.
//
// Design: the Pallas kernel streams KV blocks along a sequential grid
// axis with (m, l, acc) in VMEM scratch; here one CTA per (row, KV head)
// loops over its live slots in shared-memory tiles, one warp per query
// head of the GQA group (G <= 32), so a tile is read from device memory
// once for all G heads, with the online softmax in registers
// (paged_common.cuh: the same loop as the paged decode kernel, behind a
// strided slab instead of a page table).  Slots outside [lo, hi) =
// [max(0, length - window), min(length, T)) are neither loaded nor
// computed; a row with nothing to attend writes exact zeros.  k/v are read
// through their strides (head dim dense), so the model's [B, W, K, d]
// ring is read in place with no transpose copy.  Simple first: no split
// over T (with B * K < 132 CTAs most SMs idle), no TMA, no tensor cores.

#include "paged_common.cuh"

namespace {

using namespace paged;

struct SlabArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* out;
  int B, H, K, T, window;
  long long q_sb, q_sh;                 // q / out: [B, H, d], head dim dense
  long long k_sb, k_sh, k_st;           // k: [B, K, T, d] strides
  long long v_sb, v_sh, v_st;
  float scale, cap;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
__global__ void slab_decode_kernel(const TQ* __restrict__ q,
                                   const TKV* __restrict__ k,
                                   const TKV* __restrict__ v,
                                   const int32_t* __restrict__ lengths,
                                   TQ* __restrict__ out, SlabArgs a) {
  constexpr int TPP = 32;
  constexpr int TT = Tile<D>::TT;
  constexpr int DPT = D / TPP;
  __shared__ float ks[TT * D];
  __shared__ float vs[TT * D];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = a.H / a.K;
  const int g = threadIdx.x / TPP, sub = threadIdx.x % TPP;
  const long long qoff = b * a.q_sb + (long long)(kh * G + g) * a.q_sh;

  PairState<D, TPP> st;
  st.init();
#pragma unroll
  for (int i = 0; i < DPT; ++i)
    st.q[i] = to_f(q[qoff + sub + TPP * i]) * a.scale;

  const int len = lengths[b];
  const int hi = min(max(len, 0), a.T);
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const TKV* kb = k + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = v + b * a.v_sb + kh * a.v_sh;
  for (int p0 = lo; p0 < hi; p0 += TT) {
    const int nt = min(TT, hi - p0);
    __syncthreads();                     // previous tile fully consumed
    load_slab_tile<TKV, D, TT>(ks, vs, kb, vb, a.k_st, a.v_st, p0, nt);
    __syncthreads();
    attend_tile<D, TPP, TT>(st, ks, vs, nt, nt, sub, a.cap);
  }
  // out is [B, H, d] with q's strides
#pragma unroll
  for (int i = 0; i < DPT; ++i)
    out[qoff + sub + TPP * i] = from_f<TQ>(st.out(i));
}

template <typename TQ, typename TKV, int D>
int launch(const SlabArgs& a) {
  dim3 grid(a.B, a.K);
  dim3 block(32 * (a.H / a.K));
  slab_decode_kernel<TQ, TKV, D><<<grid, block, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.lengths, static_cast<TQ*>(a.out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const SlabArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q f32 needs f32 k/v.  Strides in
// elements; q and out share theirs.  Returns cudaGetLastError() after the
// launch, or -1 for a configuration this file was not built for.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int K, int T, int d, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, int window, float scale,
    float cap, int q_dtype, int kv_dtype, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > 32) return -1;
  SlabArgs a{q, k, v, static_cast<const int32_t*>(lengths), out,
             B, H, K, T, window, q_sb, q_sh, k_sb, k_sh, k_st,
             v_sb, v_sh, v_st, scale, cap, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
