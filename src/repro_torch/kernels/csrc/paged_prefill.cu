// Ragged paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py:
// paged_prefill_attention (its pallas_call at :189).  One chunk of C
// queries per row attends the row's paged prefix (positions < offset) and
// the chunk's own K/V causally (j <= i, j < chunk_len), under one softmax.
// The chunk's K/V is not in the pool yet; the model writes it after.
//
// What bounds it on this card: bytes at chip_smoke.py's shapes, operations
// once prefixes grow long.  Every query reads its bf16 q and writes its
// output once (4 * H * d bytes per query), the live prefix pages and the
// chunk's bf16 k/v are read once.  Products against the f32 pool count at
// the TF32 tensor-core peak (495 TFLOP/s), those against the chunk's bf16
// k/v at the bf16 peak (989 TFLOP/s).  With C = 256 and prefixes of a few
// hundred positions the bytes take 7.6 us and the products 6.3 us; the
// prefix alone does C * G / 2 flops per byte it reads, so prefixes of
// thousands of positions make the products bind.
//
// Design, bf16 q (the engine's calls; f32 or bf16 pools): one CTA of 8
// warps per (row, KV head, tile of 128 (query, head) rows): floor(128 / G)
// queries with the G heads of the KV head stacked under each (any G up to
// 64; the 128 mod G rows left over keep nothing and write nothing), so
// device memory sees each prefix page once per 128 / G queries.  The tile's
// q is staged once in shared memory as bf16; warp w owns rows 16w..16w+15.
// K/V tiles of 32 positions arrive by 16-byte cp.async in a two-stage ring
// (the next tile is in flight while this one is computed), prefix pages
// gathered through the block table, rows padded so that every fragment
// read below is free of bank conflicts; positions past the end are
// zero-filled.  Phase 1 walks the live prefix, min(offset, nb * ps)
// positions; phase 2 the chunk up to the tile's last query (blocks above
// the diagonal are never loaded; the diagonal is masked per score).  Queries
// past chunk_len attend chunk positions < chunk_len, exactly as the
// reference oracle does; rows with offset 0 and chunk_len 0 write exact
// zeros.  Both phases run S = Q K^T and O += P V on the tensor cores with
// mma.sync and share one online softmax on the accumulator fragments (f32,
// exp2 domain; two shuffles per row per tile for the max):
//   - an f32 pool tile: TF32 m16n8k8.  bf16 q is exact in TF32; K, V and
//     P are rounded by cvt.rna.tf32.f32 (10 mantissa bits).  The A layout
//     of m16n8k8 is not its C layout, so the contraction order is permuted
//     instead of moving P: A column t stands for key 2t and t + 4 for 2t+1,
//     so a lane's C values (2t, 2t+1) of S are its A values of P V, and the
//     V fragment reads rows 2t and 2t+1.  The same permutation on the
//     dims lets one 32-bit load give a lane both bf16 q values of a k-step.
//   - a bf16 tile (the chunk's k/v, or a bf16 pool): bf16 m16n8k16, P
//     rounded to bf16 (two C blocks are one A fragment), V's fragments by
//     ldmatrix.trans.
// At d = 256 (gemma3) the same code runs with a thread's accumulator at
// 128 f32 registers (of the 255 a thread of this 256-thread CTA may hold)
// and 198 KB of shared memory (two f32 K/V stages of 66 KB and the bf16
// q tile of 66 KB), one CTA an SM; the f32 path's tile is 16 positions.
// Why mma.sync and not wgmma: TF32 wgmma takes only K-major operands, and
// V as the B operand of P V is MN-major, so every f32 V tile would need a
// transposed copy; mma.sync's B fragments are read from shared memory by
// hand in any layout.
//
// f32 q (f32 pools): the f32 CUDA cores, so the result holds an f32
// tolerance (TF32 could not).  One CTA per (row, KV head, tile of 64
// (query, head) pairs) whose pairs share each K/V tile staged as f32;
// not on the engine's path.

#include "paged_common.cuh"

namespace {

using namespace paged;

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

// ------------------------- f32: the CUDA cores ---------------------------- //
constexpr int kTPP = 4;      // threads per (query, head) pair
constexpr int kPairs = 64;   // pairs per CTA
constexpr int kThreads = kTPP * kPairs;

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
paged_prefill_f32_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kc,
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


// --------------------- bf16 q: tensor cores (mma.sync) -------------------- //
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRows = 16 * kMmaWarps;   // (query, head) rows per CTA
constexpr int kTN = 32;                 // positions per K/V tile
constexpr int kStages = 2;              // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// Row strides (elements) of the shared-memory tiles.  f32 K: a lane reads
// K[key g][2t, 2t+1] as a float2 (a stride of 8 mod 32 words spreads a
// half-warp over all banks); f32 V: lanes read V[2t or 2t+1][g] (4 mod
// 32); bf16 q, K, V: 32-bit reads of [row g][2t, 2t+1] and ldmatrix rows
// (4 mod 32 words).  All keep rows 16-byte aligned for cp.async.
template <typename T, int D>
struct TileLD;
template <int D>
struct TileLD<float, D> {
  static constexpr int K = D + 8, V = D + 4;
};
template <int D>
struct TileLD<__nv_bfloat16, D> {
  static constexpr int K = D + 8, V = D + 8;
};

template <int D>
struct MmaSmem {
  static constexpr int LDQ = D + 8;                   // bf16
  static constexpr int HALF = kTN * (D + 8) * 4;      // a K or V tile, bytes
  static constexpr int STAGE = 2 * HALF;
  static constexpr int Q = kStages * STAGE;           // offset of q
  static constexpr int BYTES = Q + kRows * LDQ * 2;
};

// Position j of one (row, KV head h) of the chunk's own k/v [B, C, K, D].
template <int D>
struct ChunkRows {
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  long long base;        // (b * C) * K + h, in rows of D
  int K;
  __device__ __forceinline__ const __nv_bfloat16* k(int j) const {
    return kc + (base + (long long)j * K) * D;
  }
  __device__ __forceinline__ const __nv_bfloat16* v(int j) const {
    return vc + (base + (long long)j * K) * D;
  }
};

// Issue positions [p0, p0 + nt) (1 <= nt <= kTN) of a K/V tile into a ring
// stage; the tile's rows past nt are zero-filled.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void load_kv_tile(uint8_t* stage, const Rows& rows,
                                             int p0, int nt) {
  using LD = TileLD<T, D>;
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
  T* ks = reinterpret_cast<T*>(stage);
  T* vs = reinterpret_cast<T*>(stage + MmaSmem<D>::HALF);
  for (int e = threadIdx.x; e < kTN * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * VEC;
    const bool ok = r < nt;
    const int p = ok ? p0 + r : p0;
    cp_async16_zfill(ks + r * LD::K + c, rows.k(p) + c, ok);
    cp_async16_zfill(vs + r * LD::V + c, rows.v(p) + c, ok);
  }
}

// One K/V tile against this warp's 16 rows: S = Q K^T on the tensor cores,
// the online softmax on the fragments, O += P V.  A thread holds rows
// g = lane / 4 and g + 8 of the warp's tile, columns 2t, 2t+1 (t = lane %
// 4) of every 8-wide block.  lim[r]: this row attends the tile's first
// lim[r] positions (any int; <= 0 attends none).
template <typename T, int D>
__device__ __forceinline__ void attend_mma(const uint8_t* stage,
                                           const __nv_bfloat16* qs,
                                           float (&o)[D / 8][4], float (&m)[2],
                                           float (&l)[2], const int (&lim)[2],
                                           float scale, float cap) {
  using LD = TileLD<T, D>;
  constexpr int LDQ = MmaSmem<D>::LDQ;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qa = qs + (16 * (threadIdx.x / 32) + g) * LDQ + 2 * t;
  const __nv_bfloat16* qb = qa + 8 * LDQ;
  const T* ks = reinterpret_cast<const T*>(stage);
  const T* vs = reinterpret_cast<const T*>(stage + MmaSmem<D>::HALF);

  float s[kTN / 8][4];
#pragma unroll
  for (int n = 0; n < kTN / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  if constexpr (sizeof(T) == 4) {
    // TF32, k-step of 8 dims; A column t is dim k0 + 2t, t + 4 is 2t + 1
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      const uint32_t wa = lds32(qa + k0), wb = lds32(qb + k0);
      const uint32_t a[4] = {wa << 16, wb << 16, wa & 0xffff0000u,
                             wb & 0xffff0000u};
#pragma unroll
      for (int n = 0; n < kTN / 8; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (n * 8 + g) * LD::K + k0 + 2 * t);
        mma_tf32(s[n], a, to_tf32(kv.x), to_tf32(kv.y));
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      const uint32_t a[4] = {lds32(qa + k0), lds32(qb + k0),
                             lds32(qa + k0 + 8), lds32(qb + k0 + 8)};
#pragma unroll
      for (int n = 0; n < kTN / 8; ++n) {
        const T* kr = ks + (n * 8 + g) * LD::K + k0 + 2 * t;
        mma_bf16(s[n], a, lds32(kr), lds32(kr + 8));
      }
    }
  }

  // online softmax in the exp2 domain; softcap before the mask
  const float ninf = __uint_as_float(0xff800000u);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int n = 0; n < kTN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      x = n * 8 + 2 * t + (e & 1) < lim[e / 2] ? x * kLog2e : ninf;
      s[n][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < kTN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m[e / 2]);
      s[n][e] = p;
      l[e / 2] += p;
    }
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    o[nd][0] *= corr[0];
    o[nd][1] *= corr[0];
    o[nd][2] *= corr[1];
    o[nd][3] *= corr[1];
  }

  if constexpr (sizeof(T) == 4) {
    // TF32, k-step of 8 keys; A column t is key 2t, t + 4 is key 2t + 1
#pragma unroll
    for (int n = 0; n < kTN / 8; ++n) {
      const uint32_t a[4] = {to_tf32(s[n][0]), to_tf32(s[n][2]),
                             to_tf32(s[n][1]), to_tf32(s[n][3])};
      const T* v0 = vs + (n * 8 + 2 * t) * LD::V + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        mma_tf32(o[nd], a, to_tf32(v0[nd * 8]), to_tf32(v0[LD::V + nd * 8]));
    }
  } else {
    // bf16, k-step of 16 keys: S blocks 2kk and 2kk + 1 are one A fragment
    const int mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int kk = 0; kk < kTN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const T* vr = vs + (kk * 16 + (mi & 1) * 8 + ri) * LD::V + (mi >> 1) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vr + nd * 8);
        mma_bf16(o[nd], a, b[0], b[1]);
        mma_bf16(o[nd + 1], a, b[2], b[3]);
      }
    }
  }
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kMmaThreads)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kc,
                         const __nv_bfloat16* __restrict__ vc,
                         const TKV* __restrict__ kp, const TKV* __restrict__ vp,
                         const int32_t* __restrict__ bt,
                         const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ chunk_lens,
                         __nv_bfloat16* __restrict__ out, int C, int H, int K,
                         int ps, int nb, float scale, float cap) {
  using SM = MmaSmem<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + SM::Q);

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / K;
  const int QT = kRows / G;                         // queries per CTA
  const int q0 = blockIdx.z * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the tile's q, once; rows past QT * G or past C are zeros
  for (int e = threadIdx.x; e < kRows * (D / 8); e += kMmaThreads) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const int i = q0 + r / G;
    const bool live = r < QT * G && i < C;
    const __nv_bfloat16* src =
        live ? q + (((long long)b * C + i) * H + h * G + r % G) * D + c : q;
    cp_async16_zfill(qs + r * SM::LDQ + c, src, live);
  }

  const int n_pre = min(max(offsets[b], 0), nb * ps);
  const int cl = min(max(chunk_lens[b], 0), C);
  const int n_ch = min(cl, min(C, q0 + QT));        // up to the last query
  const int n1 = (n_pre + kTN - 1) / kTN;
  const int n_tiles = n1 + (n_ch + kTN - 1) / kTN;
  const PagedRows<TKV, D> pool{kp, vp, bt + (long long)b * nb, ps, K, h};
  const ChunkRows<D> chunk{kc, vc, (long long)b * C * K + h, K};
  auto issue = [&](int tile) {
    uint8_t* stage = smem + (tile % kStages) * SM::STAGE;
    if (tile < n1) {
      const int p0 = tile * kTN;
      load_kv_tile<TKV, D>(stage, pool, p0, min(kTN, n_pre - p0));
    } else {
      const int j0 = (tile - n1) * kTN;
      load_kv_tile<__nv_bfloat16, D>(stage, chunk, j0, min(kTN, n_ch - j0));
    }
  };
  // tiles 0 .. kStages - 2 in flight (q rides with tile 0), one commit
  // group each, empty past the last tile
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < n_tiles) issue(tile);
    cp_async_commit();
  }

  // this thread's two rows: query index and chunk limit (j < min(i + 1, cl))
  int row_lim[2], row_i[2], row_g[2];
  bool row_live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + lane / 4 + 8 * r;
    row_i[r] = q0 + rr / G;
    row_g[r] = rr % G;
    row_live[r] = rr < QT * G && row_i[r] < C;
    row_lim[r] = min(row_i[r] + 1, cl);
  }

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();       // this tile (and q) landed here,
    __syncthreads();                    // for every thread; tile - 1 is done
    // the stage tile - 1 used takes the tile kStages - 1 ahead
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_async_commit();
    const uint8_t* stage = smem + (tile % kStages) * SM::STAGE;
    if (tile < n1) {
      const int n = n_pre - tile * kTN;
      const int lim[2] = {n, n};
      attend_mma<TKV, D>(stage, qs, o, m, l, lim, scale, cap);
    } else {
      const int j0 = (tile - n1) * kTN;
      const int lim[2] = {row_lim[0] - j0, row_lim[1] - j0};
      attend_mma<__nv_bfloat16, D>(stage, qs, o, m, l, lim, scale, cap);
    }
  }
  cp_async_wait<0>();                   // q's copy, when no tile ran

  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum = l[r];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    if (!row_live[r]) continue;
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
    __nv_bfloat16* dst =
        out + (((long long)b * C + row_i[r]) * H + h * G + row_g[r]) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          pack_bf16(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const PrefillArgs& a) {
  const int G = a.H / a.K;
  if constexpr (sizeof(TQ) == 4) {
    const int QT = kPairs / G;
    dim3 grid(a.B, a.K, (a.C + QT - 1) / QT);
    paged_prefill_f32_kernel<TQ, TKV, D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
        static_cast<const TQ*>(a.v), static_cast<const TKV*>(a.kp),
        static_cast<const TKV*>(a.vp), a.bt, a.offsets, a.chunk_lens,
        static_cast<TQ*>(a.out), a.C, a.H, a.K, a.ps, a.nb, a.scale, a.cap);
  } else {
    constexpr int smem = MmaSmem<D>::BYTES;
    auto kern = paged_prefill_mma_kernel<TKV, D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int QT = kRows / G;
    dim3 grid(a.B, a.K, (a.C + QT - 1) / QT);
    kern<<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const TKV*>(a.kp),
        static_cast<const TKV*>(a.vp), a.bt, a.offsets, a.chunk_lens,
        static_cast<__nv_bfloat16*>(a.out), a.C, a.H, a.K, a.ps, a.nb,
        a.scale, a.cap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_head_dim(int d, const PrefillArgs& a) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    case 256: return launch<TQ, TKV, 256>(a);
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
