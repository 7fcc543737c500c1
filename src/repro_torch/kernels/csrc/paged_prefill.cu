// Ragged paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py:
// paged_prefill_attention (its pallas_call at :189).  One chunk of C
// queries per row attends the row's paged prefix (positions < offset) and
// the chunk's own K/V causally (j <= i, j < chunk_len), under one softmax.
// The chunk's K/V is not in the pool yet; the model writes it after.
//
// What bounds it on this card: bytes at the serving shapes, operations
// once prefixes grow long.  Every query reads its bf16 q and writes its
// output once (4 * H * d bytes per query), and the chunk's bf16 k/v are
// read once.  Products against the f32 pool prefix count at the TF32
// tensor-core peak (495 TFLOP/s, the fastest rate for an f32 operand),
// those against the chunk's bf16 k/v at the bf16 peak (989 TFLOP/s).  The
// prefix alone does C * G / 2 flops per byte it reads, above the TF32
// ridge; but with C = 256 and prefixes of a few hundred positions
// (chip_smoke.py's inputs) the bytes take 7.6 us and the products 6.3 us.
// Prefixes of thousands of positions make the products bind.  This first
// kernel does its products on the f32 CUDA cores (67 TFLOP/s).
//
// Design: one CTA per (row, KV head, tile of 64 (query, head) pairs), that
// is floor(64 / G) queries with the G heads of the KV head beside each
// (any G up to 64: the 64 mod G pair slots left over keep nothing and
// write nothing; Qwen3-32B's G = 5 uses 60 of the 64).  The pairs
// share each K/V tile the CTA stages in shared memory, so device memory
// sees each prefix page once per query tile, not once per query.  A tile
// of 64 queries would hold 64 * G pairs; at G = 4 their f32 q and
// accumulators alone (256 KB) would fill the SM's register file, so the
// tile is counted in pairs.  Phase 1 walks the live prefix, min(offset, nb * ps) positions;
// phase 2 walks the chunk up to the tile's last query (blocks above the
// diagonal are skipped).  Queries past chunk_len still attend chunk
// positions < chunk_len, exactly as the reference oracle does; rows with
// offset 0 and chunk_len 0 write exact zeros.  Any C is allowed: the last
// query tile is masked.  Tensor cores (wgmma), TMA and split-K come later.

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kTPP = 4;      // threads per (query, head) pair
constexpr int kPairs = 64;   // pairs per CTA
constexpr int kThreads = kTPP * kPairs;

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kp;
  const void* vp;
  const int32_t* bt;
  const int32_t* offsets;
  const int32_t* chunk_lens;
  void* out;
  int B, C, H, K, ps, nb;
  float scale, cap;
  cudaStream_t stream;
};

template <typename TQ, int D, int TT>
__device__ __forceinline__ void load_chunk_tile(float* ks, float* vs,
                                                const TQ* kc, const TQ* vc,
                                                int b, int C, int K, int h,
                                                int j0, int nt) {
  for (int e = threadIdx.x; e < nt * D; e += blockDim.x) {
    const int t = e / D, jd = e % D;
    const int64_t off = (((int64_t)b * C + j0 + t) * K + h) * D + jd;
    ks[e] = to_f(kc[off]);
    vs[e] = to_f(vc[off]);
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kc,
                     const TQ* __restrict__ vc, const TKV* __restrict__ kp,
                     const TKV* __restrict__ vp,
                     const int32_t* __restrict__ bt,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ chunk_lens,
                     TQ* __restrict__ out, int C, int H, int K, int ps, int nb,
                     float scale, float cap) {
  constexpr int TT = Tile<D>::TT;
  constexpr int DPT = D / kTPP;
  __shared__ float ks[TT * D];
  __shared__ float vs[TT * D];

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / K;
  const int QT = kPairs / G;                        // queries per CTA
  const int pair = threadIdx.x / kTPP, sub = threadIdx.x % kTPP;
  const int i = blockIdx.z * QT + pair / G;         // query index in chunk
  const int g = pair % G;
  // the 64 mod G slots past QT * G would hold the next tile's first
  // query, whose phase 2 this CTA cuts short at `last`: they stay idle
  const bool live = pair < QT * G && i < C;
  const int64_t qoff = (((int64_t)b * C + i) * H + h * G + g) * D;

  PairState<D, kTPP> st;
  st.init();
#pragma unroll
  for (int t = 0; t < DPT; ++t)
    st.q[t] = live ? to_f(q[qoff + sub + kTPP * t]) * scale : 0.f;

  // ---- phase 1: the live prefix pages ----
  const int n_pre = min(max(offsets[b], 0), nb * ps);
  const int32_t* bt_row = bt + (int64_t)b * nb;
  for (int p0 = 0; p0 < n_pre; p0 += TT) {
    const int nt = min(TT, n_pre - p0);
    __syncthreads();
    load_page_tile<TKV, D, TT>(ks, vs, kp, vp, bt_row, ps, K, h, p0, nt);
    __syncthreads();
    attend_tile<D, kTPP, TT>(st, ks, vs, nt, live ? nt : 0, sub, cap);
  }

  // ---- phase 2: in-chunk causal positions, up to the tile's last query ----
  const int cl = min(max(chunk_lens[b], 0), C);
  const int last = min(C, (int)(blockIdx.z + 1) * QT);
  const int n_ch = min(cl, last);
  const int my_lim = min(i + 1, cl);                // j < my_lim
  for (int j0 = 0; j0 < n_ch; j0 += TT) {
    const int nt = min(TT, n_ch - j0);
    __syncthreads();
    load_chunk_tile<TQ, D, TT>(ks, vs, kc, vc, b, C, K, h, j0, nt);
    __syncthreads();
    const int nv = live ? min(max(my_lim - j0, 0), nt) : 0;
    attend_tile<D, kTPP, TT>(st, ks, vs, nt, nv, sub, cap);
  }

  if (live) {
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      out[qoff + sub + kTPP * t] = from_f<TQ>(st.out(t));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const PrefillArgs& a) {
  const int QT = kPairs / (a.H / a.K);
  dim3 grid(a.B, a.K, (a.C + QT - 1) / QT);
  paged_prefill_kernel<TQ, TKV, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const TQ*>(a.v), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.bt, a.offsets, a.chunk_lens,
      static_cast<TQ*>(a.out), a.C, a.H, a.K, a.ps, a.nb, a.scale, a.cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const PrefillArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q/k/v share q_dtype, the pools
// kv_dtype; q f32 needs f32 pools).  1 <= G = H / K <= 64.  Returns
// cudaGetLastError() after the launch, or -1 for a configuration this file
// was not built for.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pages,
    const void* v_pages, const void* block_tables, const void* offsets,
    const void* chunk_lens, void* out, int B, int C, int H, int K, int d,
    int ps, int nb, int q_dtype, int kv_dtype, float scale, float cap,
    void* stream) {
  if (K <= 0 || H % K != 0 || H / K <= 0 || H / K > kPairs) return -1;
  PrefillArgs a{q, k, v, k_pages, v_pages,
                static_cast<const int32_t*>(block_tables),
                static_cast<const int32_t*>(offsets),
                static_cast<const int32_t*>(chunk_lens), out, B, C, H, K, ps,
                nb, scale, cap, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
