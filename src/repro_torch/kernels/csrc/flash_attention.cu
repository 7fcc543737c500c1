// Dense GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (defined at :96, its pallas_call at :116).  Every query
// of a sequence attends the same sequence's keys under one online softmax:
// scores q.k * scale in f32, softcap cap * tanh(s / cap) before the mask,
// causal (key <= query), sliding window (query - key < window) or
// bidirectional (hubert's encoder, d = 80).  The model's train-mode forward
// calls it in every layer.
//
// What bounds it on this card: operations once sequences are long, bytes
// at the trainer's rollout batches.  It reads q, k and v once and writes
// the output once, 2 * S * (2 * H + 2 * K) * d bytes per row in bf16, and
// does 4 * d flops per (query, key) pair it keeps, S * (S + 1) / 2 pairs
// per head when causal.  At the bf16 tensor-core rate (989 TFLOP/s) and
// 3.35 TB/s the two cross near S = 740 with H = 32, K = 8 (causal): the
// trainer's ~370-token rows are bound by bytes, S = 4096 by operations.
//
// Design: the Pallas kernel carries (m, l, acc) in VMEM scratch across a
// sequential grid axis over KV blocks; Hopper blocks run in no order, so
// here each CTA loops over the KV tiles itself, keeping the running max,
// sum and accumulator of its queries in registers.  Two paths:
//   - bf16 (the trainer's and the hybrid and gemma prefills'): persistent
//     CTAs of three warpgroups (two waves of one a SM) walk work items of
//     (row, query head, tile of 128 queries), the most loaded first.  A
//     producer warp keeps Q and K/V tiles of 128 keys (64 at d = 256)
//     arriving by TMA into a two-stage ring in shared memory (mbarriers
//     count the bytes in and the consumers out), running into the next
//     item while the consumers finish one; two consumer warpgroups of 64
//     queries each run S = Q K^T on wgmma from shared memory, the online
//     softmax on the accumulator fragments (exp2 with scale * log2(e)
//     folded in, its reductions in short chains: at 8 warps a SM it is
//     latency-bound), and O += P V on wgmma with P from registers as bf16
//     and V read through the transposed (MN-major) operand layout.
//     Accumulators are f32.
//     The tensor maps are built on the host from the strides of the
//     [B, S, heads, d] views; TMA fills keys and queries past S with
//     zeros.  See the section below.
//   - f32: the f32 CUDA cores (the tensor cores' bf16 would lose the f32
//     inputs' precision), one CTA per (row, KV head, floor(64 / G)
//     queries) whose G = H / K heads share each K/V tile staged as f32;
//     any G up to 64 (Hymba's G = 5 uses 60 of the 64 pair slots).  Not on
//     the main path.
// Block skipping, in both: a query tile's loop runs over keys
// [kv_lo, kv_hi) only, kv_hi = its last query + 1 when causal (tiles
// above the diagonal are never loaded) and kv_lo = its first query -
// window + 1 with a window (tiles wholly outside every query's window are
// never loaded);
// inside a tile each query masks its own [lo, hi) (in bf16 only on the
// tiles that straddle a limit).  Any S: queries past S load nothing, keep
// nothing and write nothing.  A query with nothing to keep (l == 0)
// writes exact zeros, as the Pallas kernel does.  Layout: q/out
// [B, H, S, d], k/v [B, K, S, d] as strided views (innermost stride 1),
// so the model's [B, S, H, d] activations are read and written in place,
// with no head-major copy; the bf16 path needs 16-byte aligned bases and
// strides (TMA).

#include "paged_common.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace paged;

struct FlashArgs {
  int B, H, K, S;
  // element strides of (batch, head, position); the head dim is dense
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal, window;
  float scale, cap;
  int n_qt;                   // bf16: query tiles of kBM (128) per sequence
};

// ---------------------------------------------------------------------------
// f32: CUDA cores.  A (query, head) pair is spread over kTPP neighbouring
// threads (paged_common.cuh); up to 64 pairs, floor(64 / G) queries x the
// G heads of one KV head (16 x 4 at Qwen3's shapes, 12 x 5 at Hymba's),
// share each K/V tile; the 64 mod G pair slots left over keep nothing.
// ---------------------------------------------------------------------------
constexpr int kTPP = 4;      // threads per (query, head) pair
constexpr int kPairs = 64;   // pairs per CTA
constexpr int kThreads = kTPP * kPairs;

// Keys per shared-memory tile: 2 * TT * D * 4 bytes <= 32 KB, and the
// per-thread score row s[TT] stays in registers.
template <int D>
struct FlashTile {
  static constexpr int TT = D >= 256 ? 16 : D >= 128 ? 32 : 64;
};

// One K/V tile of the online softmax: this pair keeps tile positions
// [lo, hi) (0 <= lo, hi <= nt).  Every lane runs the score loop to nt, the
// same for the whole block, so the group shuffles see a full warp whatever
// each pair's own limits are.
template <int D, int TPP, int TT>
__device__ __forceinline__ void attend_range(PairState<D, TPP>& st,
                                             const float* ks, const float* vs,
                                             int nt, int lo, int hi, int sub,
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
      if (t >= lo && t < hi) mt = fmaxf(mt, x);
    }
  }
  if (hi <= lo) return;
  const float m_new = fmaxf(st.m, mt);
  const float corr = expf(st.m - m_new);
  st.l *= corr;
#pragma unroll
  for (int i = 0; i < DPT; ++i) st.acc[i] *= corr;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t >= lo && t < hi) {
      const float p = expf(s[t] - m_new);
      st.l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) st.acc[i] += p * vs[t * D + sub + TPP * i];
    }
  }
  st.m = m_new;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, FlashArgs a) {
  constexpr int TT = FlashTile<D>::TT;
  constexpr int DPT = D / kTPP;
  __shared__ float ks[TT * D];
  __shared__ float vs[TT * D];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = a.H / a.K;
  const int QT = kPairs / G;                        // queries per CTA
  const int pair = threadIdx.x / kTPP, sub = threadIdx.x % kTPP;
  const int i0 = blockIdx.z * QT;
  const int i = i0 + pair / G;                      // this pair's query
  const int h = kh * G + pair % G;                  // and its head
  const bool live = pair < QT * G && i < a.S;

  PairState<D, kTPP> st;
  st.init();
  const long long qoff = b * a.q_sb + h * a.q_sh + (long long)i * a.q_ss;
#pragma unroll
  for (int t = 0; t < DPT; ++t)
    st.q[t] = live ? q[qoff + sub + kTPP * t] * a.scale : 0.f;

  // keys any query of this CTA may keep: the block skip
  const int i_last = min(a.S, i0 + QT) - 1;
  const int kv_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? i_last + 1 : a.S;
  // keys this pair keeps
  const int my_lo = a.window > 0 ? max(0, i - a.window + 1) : 0;
  const int my_hi = a.causal ? i + 1 : a.S;

  const long long kbase = b * a.k_sb + kh * a.k_sh;
  const long long vbase = b * a.v_sb + kh * a.v_sh;
  for (int j0 = kv_lo; j0 < kv_hi; j0 += TT) {
    const int nt = min(TT, kv_hi - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < nt * D; e += kThreads) {
      const int t = e / D, jd = e % D;
      ks[e] = k[kbase + (long long)(j0 + t) * a.k_ss + jd];
      vs[e] = v[vbase + (long long)(j0 + t) * a.v_ss + jd];
    }
    __syncthreads();
    const int lo = live ? min(max(my_lo - j0, 0), nt) : 0;
    const int hi = live ? min(max(my_hi - j0, 0), nt) : 0;
    attend_range<D, kTPP, TT>(st, ks, vs, nt, lo, hi, sub, a.cap);
  }

  if (live) {
    const long long ooff = b * a.o_sb + h * a.o_sh + (long long)i * a.o_ss;
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      out[ooff + sub + kTPP * t] = st.out(t);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.  Persistent CTAs of three warpgroups, each walking
// work items of (row, query head, tile of kBM = 128 queries).  Warpgroup
// 0 is the producer: one thread issues the TMA loads (an item's Q, then
// its K and V tiles of BN keys into a kStages ring, running ahead
// into the next item while the consumers finish one); the others only
// give their registers back.  Warpgroups 1
// and 2 are consumers, 64 query rows each; they take turns issuing their
// Q K^T, so one's softmax runs while the other's products hold the tensor
// cores.
//
// Shared memory (1024-byte aligned): Q [128 x DP], then kStages K and
// kStages V tiles [BN x DP], all bf16 in TMA's swizzled layout, DP = d
// rounded up to whole column blocks (d = 80: DP = 128, the tensor maps'
// inner extent of 80 zero-filling columns 80..127, so Q K^T runs its 5
// k-steps of real columns and P V an m64n128 whose last 48 columns are
// never stored: 1.6x the products of a 80-wide P V, no copy or pad of q,
// k or v on the host): a tile is split into column blocks of CB = 64
// elements (32 when d = 32), each
// [rows x CB] with 128-byte rows (64 when d = 32) whose 16-byte chunks
// are XOR-swizzled by the row within groups of 8 rows, the layout wgmma's
// SWIZZLE_128B (64B) descriptors read.  BN = 128 keys, or 64 at d = 256:
// there Q is 64 KB and a K + V stage of 128 keys would be 128 KB, over
// the 227 KB a block may have in two stages, and the score fragments of
// 128 keys would not fit beside the 64 x 256 f32 accumulator (128
// registers a thread); with 64 keys a stage is 64 KB (192 KB in all) and
// a consumer thread holds 128 + 32 + 16 values of O, S and P.  O's 256
// columns take two m64n128 products a k-step.  Barriers: q_full, k_full[s],
// v_full[s] (TMA transaction bytes), q_empty and empty[s] (one arrival per
// consumer warp).
//
// A consumer warp's 16 rows and the thread layout of its accumulators are
// the mma.sync m16n8 C layout repeated along N (rows g and g + 8 of the
// warp, columns 2t, 2t + 1 of every 8-wide block), so the softmax reduces
// a row over the four threads of a quad, and the score fragments of two
// neighbouring 8-key blocks are, rounded to bf16, the A fragment of the
// P V product for those 16 keys.
// ---------------------------------------------------------------------------
constexpr int kBM = 128;              // queries per CTA: 2 consumers x 64
constexpr int kStages = 2;            // K/V ring depth (3 measured no faster)
constexpr int kTmaThreads = 3 * 128;  // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TmaTile {
  static constexpr int CB = D >= 64 ? 64 : 32;    // elements per column block
  static constexpr int RB = CB * 2;                // bytes per smem row
  static constexpr int NCB = (D + CB - 1) / CB;    // column blocks per tile
  // the tile's width: d rounded up to whole column blocks (d = 80: 128,
  // the tensor maps' inner extent of 80 filling columns 80..127 with zeros)
  static constexpr int DP = NCB * CB;
  static constexpr int BN = DP > 128 ? 64 : 128;   // keys per K/V tile
  static constexpr int QBLOCK = kBM * RB;          // bytes per Q column block
  static constexpr int BLOCK = BN * RB;            // and per K/V column block
  static constexpr int QTILE = NCB * QBLOCK;       // bytes per 128 x d Q tile
  static constexpr int TILE = NCB * BLOCK;         // bytes per BN x d K/V tile
  static constexpr int LAYOUT = RB == 128 ? 1 : 2; // wgmma: 128B / 64B swizzle
  // Q, kStages K and V tiles, 128 bytes of barriers, 1024 of alignment
  static constexpr int SMEM = QTILE + 2 * kStages * TILE + 128 + 1024;
};

// Issue S[64 x BN] = Q[64 x d] K^T for this warpgroup's 64 rows (the
// caller waits): Q and K both K-major (d contiguous); k-step kk reads 16
// columns, 32 bytes into its column block's swizzled rows.
template <int D>
__device__ __forceinline__ void qk_wgmma(float (&s)[TmaTile<D>::BN / 2],
                                         uint32_t q, uint32_t k) {
  using L = TmaTile<D>;
  constexpr int KPB = L::CB / 16;                  // k-steps per column block
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % KPB) * 32;
    const uint64_t dq = gmma_desc(q + (kk / KPB) * L::QBLOCK + col, 16,
                                  8 * L::RB, L::LAYOUT);
    const uint64_t dk = gmma_desc(k + (kk / KPB) * L::BLOCK + col, 16,
                                  8 * L::RB, L::LAYOUT);
    if constexpr (L::BN == 128) wgmma_ss_n128(s, dq, dk, kk > 0);
    else wgmma_ss_n64(s, dq, dk, kk > 0);
  }
  wgmma_commit();
}

// Start O[64 x DP] += P[64 x BN] V (the caller waits): P from registers
// (k-step kk = keys 16 kk .. 16 kk + 15), V MN-major (d contiguous): 8-key
// groups one atom (8 rows) apart, column blocks of CB values one BLOCK
// apart; at d = 256 columns 128..255 start two column blocks in.  At d =
// 80 the product is m64n128 over the tile's 128 columns, of which V's 80..127
// are TMA's zeros: O's columns there stay 0 and are never stored.
template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[TmaTile<D>::DP / 2],
                                         uint32_t (&pa)[TmaTile<D>::BN / 16][4],
                                         uint32_t v) {
  using L = TmaTile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
    const uint32_t vk = v + kk * 16 * L::RB;
    const uint64_t dv = gmma_desc(vk, L::BLOCK, 8 * L::RB, L::LAYOUT);
    if constexpr (L::DP == 256) {
      wgmma_rs_n128<0>(o, pa[kk], dv);
      wgmma_rs_n128<64>(o, pa[kk], gmma_desc(vk + 2 * L::BLOCK, L::BLOCK,
                                             8 * L::RB, L::LAYOUT));
    } else if constexpr (L::DP == 128) {
      wgmma_rs_n128<0>(o, pa[kk], dv);
    } else if constexpr (D == 64) {
      wgmma_rs_n64(o, pa[kk], dv);
    } else {
      wgmma_rs_n32(o, pa[kk], dv);
    }
  }
  wgmma_commit();
}


// One K/V tile of the online softmax for a thread's two rows (g and g + 8
// of its warp): S (raw Q K^T fragments) becomes P as the bf16 A fragments
// of P V, with m / l / O rescaled.  It runs with 8 consumer warps a SM, so
// latency, not issue rate, bounds it: the row maxima and sums run in four
// independent chains each, the maximum is taken on the raw scores (the
// scale is positive), the scale folds into the exponent's FFMA, exp2 is
// one ex2.approx.ftz (results under 2^-126 flush to 0, far below a
// bf16 P's resolution), and O is rescaled only when a row's maximum moved.
template <int D, int BN = TmaTile<D>::BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&o)[TmaTile<D>::DP / 2],
                                             uint32_t (&pa)[BN / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             const FlashArgs& a, int j0,
                                             int r0, const int (&rows)[2],
                                             int t) {
  const bool capped = a.cap > 0.f;
  // the exp2 domain: scale * log2(e), or the softcap on the natural scale
  float sc = a.scale * kLog2e;
  if (capped) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = a.cap * tanhf(s[i] * a.scale / a.cap) * kLog2e;
    sc = 1.f;
  }
  // per-element masks only on tiles that straddle a limit of some row of
  // this warpgroup (keys past S, the diagonal, the window's edge)
  if (j0 + BN > a.S || (a.causal && j0 + BN - 1 > r0) ||
      (a.window > 0 && r0 + 63 - j0 >= a.window)) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rows[e >> 1];
        const int col = j0 + 8 * n + 2 * t + (e & 1);
        if (!(col < a.S && (!a.causal || col <= r) &&
              (a.window <= 0 || r - col < a.window)))
          s[4 * n + e] = neg_inf();
      }
    }
  }
  float mx[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = neg_inf();
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][n & 3] = fmaxf(mx[e >> 1][n & 3], s[4 * n + e]);
  float corr[2], neg_m[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float rm = fmaxf(fmaxf(mx[j][0], mx[j][1]),
                           fmaxf(mx[j][2], mx[j][3]));
    const float m_new = fmaxf(m[j], quad_max(rm) * sc);
    corr[j] = ex2(m[j] - m_new);
    m[j] = m_new;
    neg_m[j] = -m_new;
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
  }
  // P = exp2(s * sc - m) (exp2 of -inf is 0), summed in f32 and rounded to
  // bf16 as the A fragments of P V: 8-key blocks 2 kk and 2 kk + 1 make
  // k-step kk
  float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = (e >> 1) & 1;
      p[e] = ex2(fmaf(s[8 * kk + e], sc, neg_m[j]));
      ls[j][kk & 3] += p[e];
    }
    pa[kk][0] = pack_bf16(p[0], p[1]);
    pa[kk][1] = pack_bf16(p[2], p[3]);
    pa[kk][2] = pack_bf16(p[4], p[5]);
    pa[kk][3] = pack_bf16(p[6], p[7]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    l[j] = l[j] * corr[j] + ((ls[j][0] + ls[j][1]) + (ls[j][2] + ls[j][3]));
}

// Named barriers 1 and 2 (0 is __syncthreads): consumer c waits on
// kTurn + c before issuing its Q K^T and then lets the other one go, so the
// two warpgroups take turns at the tensor cores and one's softmax runs
// while the other's products do.
constexpr int kTurn = 1;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One work item: a 128-query tile of one (row, head), and the keys its
// queries may keep, [j_first, j_first + n_tiles * bn) on a grid of bn keys:
// kv_hi = the tile's last query + 1 when causal (tiles above the diagonal
// are never loaded), kv_lo = its first query - window + 1 with a window.
struct Item {
  int b, h, kh, i0, j_first, n_tiles;
};

__device__ __forceinline__ Item item(const FlashArgs& a, int w, int bn) {
  Item it;
  const int hb = a.H * a.B;
  it.i0 = (a.n_qt - 1 - w / hb) * kBM;
  it.h = (w % hb) % a.H;
  it.b = (w % hb) / a.H;
  it.kh = it.h / (a.H / a.K);
  const int i_last = min(a.S, it.i0 + kBM) - 1;
  const int kv_lo = a.window > 0 ? max(0, it.i0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? i_last + 1 : a.S;
  it.j_first = kv_lo - kv_lo % bn;
  it.n_tiles = (kv_hi - it.j_first + bn - 1) / bn;
  return it;
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_attention_tma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out, FlashArgs a) {
  using L = TmaTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks = base + L::QTILE;
  const uint32_t vs = ks + kStages * L::TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem_raw + (base - raw) + L::QTILE + 2 * kStages * L::TILE);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = bars + 2 + kStages;
  uint64_t* empty = bars + 2 + 2 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work items (query tile, head, row), the last query tiles (the most keys
  // when causal) first; CTA c takes items c, c + gridDim.x, ...  The ring's
  // stage and phase run on across items (tile_it), Q's phase per item.
  const int n_items = a.n_qt * a.H * a.B;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int tile_it = 0, item_it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++item_it) {
        const Item it = item(a, w, L::BN);
        // Q's buffer is free once both consumers' last Q K^T of the
        // previous item is done (the first wait passes at once)
        mbar_wait(q_empty, (item_it & 1) ^ 1);
        mbar_expect_tx(q_full, L::QTILE);
        for (int c = 0; c < L::NCB; ++c)
          tma_load(qs + c * L::QBLOCK, &tq, c * L::CB, it.i0, it.h, it.b,
                   q_full);
        for (int t = 0; t < it.n_tiles; ++t, ++tile_it) {
          const int st = tile_it % kStages;
          const uint32_t ph = (tile_it / kStages) & 1;
          const int j0 = it.j_first + t * L::BN;
          mbar_wait(&empty[st], ph ^ 1);   // the first round passes at once
          mbar_expect_tx(&k_full[st], L::TILE);
          for (int c = 0; c < L::NCB; ++c)
            tma_load(ks + st * L::TILE + c * L::BLOCK, &tk, c * L::CB, j0,
                     it.kh, it.b, &k_full[st]);
          mbar_expect_tx(&v_full[st], L::TILE);
          for (int c = 0; c < L::NCB; ++c)
            tma_load(vs + st * L::TILE + c * L::BLOCK, &tv, c * L::CB, j0,
                     it.kh, it.b, &v_full[st]);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t q_wg = qs + 64 * cw * L::RB;
    float o[L::DP / 2], s[L::BN / 2];
#pragma unroll
    for (int i = 0; i < L::BN / 2; ++i) s[i] = 0.f;
    uint32_t pa[L::BN / 16][4];

    if (cw == 1) named_arrive(kTurn);              // consumer 0 goes first
    int tile_it = 0, item_it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++item_it) {
      const Item it = item(a, w, L::BN);
      const bool last_item = w + gridDim.x >= n_items;
      const int r0 = it.i0 + 64 * cw;              // this warpgroup's rows
      const int rows[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
#pragma unroll
      for (int i = 0; i < L::DP / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      mbar_wait(q_full, item_it & 1);
      for (int t = 0; t < it.n_tiles; ++t, ++tile_it) {
        const int st = tile_it % kStages;
        const uint32_t ph = (tile_it / kStages) & 1;
        mbar_wait(&k_full[st], ph);
        named_sync(kTurn + cw);
        qk_wgmma<D>(s, q_wg, ks + st * L::TILE);
        // the other consumer's turn (consumer 1's very last pass owes
        // none: every wait of consumer 0 is matched by one arrival)
        if (cw == 0 || !(last_item && t + 1 == it.n_tiles))
          named_arrive(kTurn + 1 - cw);
        wgmma_wait_all();
        fence_regs(s);
        if (t + 1 == it.n_tiles) {                 // Q may be reloaded
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
        }
        softmax_tile<D>(s, o, pa, m, l, a, it.j_first + t * L::BN, r0, rows,
                        t4);
        mbar_wait(&v_full[st], ph);
        pv_wgmma<D>(o, pa, vs + st * L::TILE);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);    // this warp is done
      }

      // rows with l == 0 would write zeros; rows past S write nothing
      __nv_bfloat16* ob = out + it.b * a.o_sb + it.h * a.o_sh;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float lsum = quad_sum(l[j]);
        const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
        if (rows[j] >= a.S) continue;
        __nv_bfloat16* orow = ob + (long long)rows[j] * a.o_ss + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[4 * n + 2 * j] * inv, o[4 * n + 2 * j + 1] * inv);
      }
    }
  }
}

// ---- host: tensor maps and launch ----
// A [B, heads, S, d] bf16 view as a 4-D map, dims innermost first (d, S,
// heads, B) with the view's own byte strides; boxes of CB x `rows`
// positions.  Positions past S, and columns past d in a tile's last
// column block (d = 80), read as zeros.
template <int D>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int heads, int S, long long sb, long long sh, long long ss,
              int rows) {
  using L = TmaTile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CB, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               FlashArgs a, int max_ctas, cudaStream_t stream) {
  using L = TmaTile<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -2;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(enc, &mq, q, a.B, a.H, a.S, a.q_sb, a.q_sh, a.q_ss,
                   kBM) ||
      !make_map<D>(enc, &mk, k, a.B, a.K, a.S, a.k_sb, a.k_sh, a.k_ss,
                   L::BN) ||
      !make_map<D>(enc, &mv, v, a.B, a.K, a.S, a.v_sb, a.v_sh, a.v_ss,
                   L::BN))
    return -3;
  auto kernel = flash_attention_tma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  a.n_qt = (a.S + kBM - 1) / kBM;
  const int n_items = a.n_qt * a.H * a.B;
  kernel<<<min(n_items, max_ctas), kTmaThreads, L::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const FlashArgs& a, cudaStream_t stream) {
  const int QT = kPairs / (a.H / a.K);
  dim3 grid(a.B, a.K, (a.S + QT - 1) / QT);
  flash_attention_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}


int by_head_dim_f32(int d, const void* q, const void* k, const void* v,
                    void* out, const FlashArgs& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_f32<32>(q, k, v, out, a, stream);
    case 64: return launch_f32<64>(q, k, v, out, a, stream);
    case 80: return launch_f32<80>(q, k, v, out, a, stream);
    case 128: return launch_f32<128>(q, k, v, out, a, stream);
    case 256: return launch_f32<256>(q, k, v, out, a, stream);
  }
  return -1;
}

int by_head_dim_bf16(int d, const void* q, const void* k, const void* v,
                     void* out, const FlashArgs& a, int max_ctas,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch_tma<32>(q, k, v, out, a, max_ctas, stream);
    case 64: return launch_tma<64>(q, k, v, out, a, max_ctas, stream);
    case 80: return launch_tma<80>(q, k, v, out, a, max_ctas, stream);
    case 128: return launch_tma<128>(q, k, v, out, a, max_ctas, stream);
    case 256: return launch_tma<256>(q, k, v, out, a, max_ctas, stream);
  }
  return -1;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Strides are in elements, (batch, head, position) for each of q, k, v,
// out; for bf16 the pointers are 16-byte aligned and the strides multiples
// of 8 (TMA).  G = H / K is at most 64.  Returns cudaGetLastError() after
// the launch, -1 for a
// configuration this file was not built for, -2 without the driver's
// cuTensorMapEncodeTiled, -3 for strides a tensor map refuses.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int S, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale, float cap,
    int dtype, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kPairs) return -1;
  const FlashArgs a{B, H, K, S,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                    v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                    causal, window, scale, cap, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim_f32(d, q, k, v, out, a, st);
  // bf16: persistent CTAs, two waves of one a SM, so each CTA's set-up
  // spreads over several work items and the second wave evens out the
  // tail (measured faster than one wave or one CTA an item)
  const int sms = sm_count();
  if (dtype == 1 && sms > 0)
    return by_head_dim_bf16(d, q, k, v, out, a, 2 * sms, st);
  return -1;
}

