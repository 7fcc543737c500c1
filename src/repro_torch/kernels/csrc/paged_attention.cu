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
// least time is (live K/V pages + q + out + table) / 3.35 TB/s.  With one
// CTA per (row, KV head), B * K = 80 CTAs at Qwen3-8B's B = 10 would leave
// most of the 132 SMs idle and walk a 512-position row's tiles in series.
//
// Design (flash-decoding, split_decode.cuh): each row's positions are split
// over the grid, so that many CTAs stream pages at once.  Kernel 1 runs one CTA
// per (split, KV head, row); split s walks positions [s * S, (s + 1) * S) of
// the row's live range [0, min(len, nb * ps)), gathered through the block table
// by 16-byte cp.async into shared memory: position p of KV head h is the
// contiguous row ((bt[p / ps] * ps + p % ps) * K + h) * d of the pool.  bf16 q
// (the engine's calls, over its f32 pools) runs on the tensor cores: a warp's
// 16 positions are mma.sync's M rows and the G heads of the KV head its N
// columns, each of the 4 warps gathers its own quarter of every tile of 64
// positions through a ring of its own, the f32 pool's products in split TF32
// (big + small, an f32 result); f32 q runs on the CUDA cores.  Each CTA writes
// (m, l, acc) per head to f32 scratch; kernel 2 merges a row's splits in split
// order, reading only the splits that hold a live position, so a split past the
// row's length exits at once and writes nothing; a row of length 0 writes exact
// zeros.  The table is never indexed past its width, which keeps frozen rows
// inside a decode horizon (their length may point past the table they were
// masked to) in bounds.  Softcap is applied before the length mask.
//
// Why the split boundaries are fixed in position space: the engine's table
// width nb is a power-of-two bucket of the pages its rows need, so it
// differs between a horizon of 8 and of 1, between horizons, and between
// the two ends of a migration.  A split count planned from nb, B, the SM
// count or other rows' lengths would change a row's summation order there,
// and greedy H=8 would no longer equal H=1 nor a migrated row an unmigrated
// one.  With a constant S (a multiple of every tile, kSplitQuantum) a row's
// result is a function of its own length and data alone; the grid has
// ceil(nb * ps / S) splits, computed from shapes, so the wrapper never reads
// the lengths on the host.

#include "split_decode.cuh"

namespace {

using namespace split_decode;
using paged::PagedRows;

struct DecodeArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const int32_t* bt;
  const int32_t* lengths;
  void* out;
  float* ml;                            // [B, H, n_split, 2]: m, l
  float* acc;                           // [B, H, n_split, d]
  int B, H, K, ps, nb, split_len, n_split;
  float scale, cap;
  cudaStream_t stream;
};

// HPW: the CUDA-core body's head slots a warp (f32 q); 0 for bf16 q,
// whose tensor-core body takes a block of up to 8 heads a CTA.
template <typename TQ, typename TKV, int D, int HPW>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ kp,
                          const TKV* __restrict__ vp,
                          const int32_t* __restrict__ bt,
                          const int32_t* __restrict__ lengths, DecodeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int hi = min(max(lengths[b], 0), a.nb * a.ps);
  const int s_lo = split * a.split_len;
  if (s_lo >= hi) return;               // past the row: the merge skips it
  const int s_hi = min(s_lo + a.split_len, hi);
  const int G = a.H / a.K;

  if constexpr (sizeof(TQ) == 2) {
    const int n_hb = head_blocks(G);
    const int kh = blockIdx.y / n_hb;
    const int h0 = kh * G + (blockIdx.y % n_hb) * kHeadBlock;   // first head
    const PagedRows<TKV, D> rows{kp, vp, bt + (long long)b * a.nb, a.ps, a.K,
                                 kh};
    attend_split_mma<TKV, D>(smem, rows, s_lo, s_hi,
                             q + ((long long)b * a.H + h0) * D, D,
                             min(kHeadBlock, kh * G + G - h0), a.scale, a.cap,
                             (long long)b * a.H + h0, a.n_split, split, a.ml,
                             a.acc);
  } else {
    using L = SplitTile<D>;
    const int kh = blockIdx.y;
    float* qs = reinterpret_cast<float*>(smem + L::SMEM_KV);   // [G][D]
    const float qscale = q_scale(a.scale, a.cap);
    const long long q0 = ((long long)b * a.H + kh * G) * D;
    for (int e = threadIdx.x; e < G * D; e += kThreads)
      qs[e] = to_f(q[q0 + e]) * qscale;
    const PagedRows<TKV, D> rows{kp, vp, bt + (long long)b * a.nb, a.ps, a.K,
                                 kh};
    attend_split<D, HPW>(smem, rows, s_lo, s_hi, G, a.cap,
                         (long long)b * a.H + kh * G, a.n_split, split,
                         a.ml, a.acc);
  }
}

template <typename TQ, typename TKV, int D, int HPW>
int launch_split(const DecodeArgs& a) {
  using R = MmaRing<TKV, D>;
  constexpr bool mma = sizeof(TQ) == 2;
  constexpr int smem_max = mma ? R::BYTES : SplitTile<D>::SMEM_MAX;
  auto split = paged_decode_split_kernel<TQ, TKV, D, HPW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(split),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = a.H / a.K;
  // a warp walks split_len / TILE tiles at most, and the ring holds no
  // more stages than that (one or two at a split of 64: more CTAs an SM)
  const int smem = mma ? R::smem(a.split_len / R::TILE)
                       : SplitTile<D>::smem(G);
  dim3 grid(a.n_split, mma ? a.K * head_blocks(G) : a.K, a.B);
  split<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.bt, a.lengths, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch(const DecodeArgs& a) {
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
      static_cast<TQ*>(a.out), a.ml, a.acc, a.lengths, a.H, a.n_split,
      a.split_len, a.nb * a.ps, (long long)a.H * D, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const DecodeArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    case 256: return launch<TQ, TKV, 256>(a);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q f32 needs f32 pools; pools
// 16-byte aligned.  ml / acc: f32 scratch of B * H * n_split * 2 and
// B * H * n_split * d values; split_len a positive multiple of 64 and
// n_split >= 1 splits of it covering the table's nb * ps positions.
// Returns cudaGetLastError() after the launches, or -1 for a configuration
// this file was not built for.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, void* ml,
    void* acc, int B, int H, int K, int d, int ps, int nb, int split_len,
    int n_split, int q_dtype, int kv_dtype, float scale, float cap,
    void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kMaxG || split_len <= 0 ||
      split_len % kSplitQuantum != 0 || n_split < 1 ||
      (long long)n_split * split_len < (long long)nb * ps)
    return -1;
  DecodeArgs a{q, k_pages, v_pages,
               static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(lengths), out,
               static_cast<float*>(ml), static_cast<float*>(acc), B, H, K, ps,
               nb, split_len, n_split, scale, cap,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
