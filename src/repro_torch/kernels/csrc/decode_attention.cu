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
// At decode_32k's slab (8 rows of ~32,770 bf16 slots, G = 7) that is
// 0.16 ms for 537 MB; the kernel has to keep the card's memory busy, not
// its arithmetic.
//
// Design (flash-decoding): the Pallas kernel streams KV blocks along a
// sequential grid axis with (m, l, acc) in VMEM scratch; here the slots of a
// row are split over the grid too, so that B * K rows of KV heads fill the
// card.  Kernel 1 runs one CTA per (split, KV head, row): split s walks its
// share [lo_s, hi_s) of the row's live slots [lo, hi) = [max(0, length -
// window), min(length, T)) and writes (m, l, acc[d]) per query head into f32
// scratch (m = -inf, l = 0, acc = 0 for a split with no slots); kernel 2 merges
// a row's splits in a fixed order (no atomics: the result does not depend on
// which split ends first); a row with no live slot writes exact zeros.  Kernel
// 1's bodies are split_decode.cuh's, shared with the paged decode
// (paged_attention.cu): bf16 q on the tensor cores (mma.sync; a warp's 16
// positions as the M rows and the G heads of a KV head as the N columns, each
// warp streaming its own quarter of every tile through a cp.async ring), f32 q
// on the CUDA cores (held to 2e-5, which the tensor cores' TF32 cannot promise;
// the work is bytes-bound anyway).  The host picks the split count from B, K, T
// and the SM count alone (decode_attention.py:plan_splits: two CTAs an SM, and
// no split longer than SPLIT_CAP slots), so a row's result does not depend on
// the other rows' lengths.  k/v are read through their strides (head dim dense,
// 16-byte aligned rows), so the model's [B, W, K, d] ring is read in place with
// no transpose copy.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

struct SlabArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* out;
  float* ml;                            // [B, H, n_split, 2]: m, l
  float* acc;                           // [B, H, n_split, d]
  int B, H, K, T, window, n_split;
  long long q_sb, q_sh;                 // q / out: [B, H, d], head dim dense
  long long k_sb, k_sh, k_st;           // k: [B, K, T, d] strides
  long long v_sb, v_sh, v_st;
  float scale, cap;
  cudaStream_t stream;
};

// Slot t of one (row, KV head) of the slab: rows t * k_st from the base.
template <typename TKV>
struct SlabRows {
  const TKV* kb;
  const TKV* vb;
  long long k_st, v_st;
  __device__ __forceinline__ const TKV* k(int p) const { return kb + p * k_st; }
  __device__ __forceinline__ const TKV* v(int p) const { return vb + p * v_st; }
};

// HPW: the CUDA-core body's head slots a warp (f32 q); 0 for bf16 q,
// whose tensor-core body takes a block of up to 8 heads a CTA.
template <typename TQ, typename TKV, int D, int HPW>
__global__ void __launch_bounds__(kThreads)
slab_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                         const TKV* __restrict__ v,
                         const int32_t* __restrict__ lengths, SlabArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int G = a.H / a.K;

  // this split's share of the row's live slots
  const int len = lengths[b];
  const int hi = min(max(len, 0), a.T);
  const int lo = a.window > 0 ? min(max(0, len - a.window), hi) : 0;
  const int per = (hi - lo + a.n_split - 1) / a.n_split;
  const int s_lo = min(lo + split * per, hi);
  const int s_hi = min(s_lo + per, hi);

  if constexpr (sizeof(TQ) == 2) {
    const int n_hb = head_blocks(G);
    const int kh = blockIdx.y / n_hb;
    const int h0 = kh * G + (blockIdx.y % n_hb) * kHeadBlock;   // first head
    const SlabRows<TKV> rows{
        static_cast<const TKV*>(k) + b * a.k_sb + kh * a.k_sh,
        static_cast<const TKV*>(v) + b * a.v_sb + kh * a.v_sh, a.k_st,
        a.v_st};
    attend_split_mma<TKV, D>(smem, rows, s_lo, s_hi,
                             q + b * a.q_sb + h0 * a.q_sh, a.q_sh,
                             min(kHeadBlock, kh * G + G - h0), a.scale, a.cap,
                             (long long)b * a.H + h0, a.n_split, split, a.ml,
                             a.acc);
  } else {
    using L = SplitTile<D>;
    const int kh = blockIdx.y;
    float* qs = reinterpret_cast<float*>(smem + L::SMEM_KV);   // [G][D]
    const float qscale = q_scale(a.scale, a.cap);
    for (int e = threadIdx.x; e < G * D; e += kThreads)
      qs[e] = to_f(q[b * a.q_sb + (long long)(kh * G + e / D) * a.q_sh +
                     e % D]) * qscale;
    const SlabRows<TKV> rows{
        static_cast<const TKV*>(k) + b * a.k_sb + kh * a.k_sh,
        static_cast<const TKV*>(v) + b * a.v_sb + kh * a.v_sh, a.k_st, a.v_st};
    attend_split<D, HPW>(smem, rows, s_lo, s_hi, G, a.cap,
                         (long long)b * a.H + kh * G, a.n_split, split,
                         a.ml, a.acc);
  }
}

template <typename TQ, typename TKV, int D, int HPW>
int launch_split(const SlabArgs& a) {
  using R = MmaRing<TKV, D>;
  constexpr bool mma = sizeof(TQ) == 2;
  constexpr int smem_max = mma ? R::BYTES : SplitTile<D>::SMEM_MAX;
  auto split = slab_decode_split_kernel<TQ, TKV, D, HPW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(split),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = a.H / a.K;
  // the longest split has ceil(T / n_split) slots: a warp walks at most
  // that many tiles, and the ring holds no more stages than that
  const int per = (a.T + a.n_split - 1) / a.n_split;
  const int smem = mma ? R::smem((per + R::TILE - 1) / R::TILE)
                       : SplitTile<D>::smem(G);
  dim3 grid(a.n_split, mma ? a.K * head_blocks(G) : a.K, a.B);
  split<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.lengths, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch(const SlabArgs& a) {
  int e = -1;
  if constexpr (sizeof(TQ) == 2) {
    e = launch_split<TQ, TKV, D, 0>(a);
  } else {
    switch (heads_per_warp(a.H / a.K)) {
      case 1: e = launch_split<TQ, TKV, D, 1>(a); break;
      case 2: e = launch_split<TQ, TKV, D, 2>(a); break;
      case 4: e = launch_split<TQ, TKV, D, 4>(a); break;
      case 8: e = launch_split<TQ, TKV, D, 8>(a); break;
    }
  }
  if (e != 0) return e;
  split_merge_kernel<TQ, D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<TQ*>(a.out), a.ml, a.acc, a.lengths, a.H, a.n_split, 0, 0,
      a.q_sb, a.q_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const SlabArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    case 256: return launch<TQ, TKV, 256>(a);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q f32 needs f32 k/v.  Strides in
// elements; q and out share theirs; k/v rows 16-byte aligned.  ml / acc:
// f32 scratch of B * H * n_split * 2 and B * H * n_split * d values.
// Returns cudaGetLastError() after the launches, or -1 for a configuration
// this file was not built for.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* ml, void* acc, int B, int H, int K, int T, int d,
    int n_split, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, int window, float scale, float cap, int q_dtype,
    int kv_dtype, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kMaxG || n_split < 1) return -1;
  SlabArgs a{q, k, v, static_cast<const int32_t*>(lengths), out,
             static_cast<float*>(ml), static_cast<float*>(acc),
             B, H, K, T, window, n_split, q_sb, q_sh, k_sb, k_sh, k_st,
             v_sb, v_sh, v_st, scale, cap, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
