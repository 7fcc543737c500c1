// Ragged paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py:
// paged_prefill_attention (defined at :115, its pallas_call at :189).  One
// chunk of C queries per row attends the row's paged prefix (positions <
// offset, gathered through the block table) and the chunk's own K/V
// causally (j <= i, j < chunk_len), under one softmax; softcap before the
// mask; a row with nothing to attend writes exact zeros.  The chunk's K/V
// is not in the pool yet; the model writes it after.
//
// What bounds it on this card: bytes at chip_smoke.py's shapes, operations
// once prefixes or chunks grow long.  Every query reads its bf16 q and
// writes its output once (4 * H * d bytes per query), the live prefix
// pages and the chunk's bf16 k/v are read once.  Products against the f32
// pool count at the TF32 tensor-core peak (495 TFLOP/s), those against the
// chunk's bf16 k/v at the bf16 peak (989 TFLOP/s).  With C = 256 and
// prefixes of a few hundred positions the bytes take 7.6 us and the
// products 6.3 us; the prefix alone does C * G / 2 flops per byte it
// reads, so prefixes of thousands of positions make the products bind.
//
// What bounded the earlier mma.sync design, from tools/prefill_ab.py's
// probes (that kernel with a part patched out, NVIDIA H100 80GB HBM3,
// 700 W): at Qwen3-8B C 256 leaving out the products saved 28%, the loads
// 16%, the softmax 11%; over 4,096-position prefixes the products 35%,
// the loads 20%; at gemma2-27b's served chunk (a tanhf on every score)
// the products 51% and the softmax 45%.  No one part bound it: each CTA
// walked its whole prefix in series in tiles of 32 with mma.sync, at
// 7-14% of the bound.
//
// Design, bf16 q (the engine's calls; f32 or bf16 pools): persistent CTAs
// of three warpgroups, one a SM, walk work items of (row, KV head, tile of
// 128 (query, head) rows: floor(128 / G) queries with the G heads of the
// KV head stacked under each, any G up to 64; the 128 mod G rows left over
// keep nothing and write nothing).  Warpgroup 0 produces: its thread 0
// loads each item's Q (a 5-D tensor map stacks the G heads; two Q slots at
// d <= 128, so the next item's Q arrives under this one) and each chunk
// K/V tile by TMA straight into the ring; all of its 128 threads gather
// the prefix's pool rows through the block table with 16-byte cp.async
// into staging slots, NS - 1 tiles ahead, and then write them into the
// ring as bf16 (an f32 pool value as hi = bf16(x) and lo = bf16(x - hi),
// a plane each, with a flag where some lo is not zero), signalling a
// stage's mbarrier; no __syncthreads a tile.  Warpgroups 1 and 2 consume
// 64 rows each, taking turns at the tensor cores (named barriers, as in
// flash_attention.cu): S = Q K^T on wgmma from shared memory (+ Q K_lo^T
// where the tile's flag is set), the online softmax on the accumulator
// fragments (exp2 domain; the softcap's tanh from one ex2 and one divide,
// ~1e-7 from tanhf, without its branches), O += P V on wgmma with P from
// registers as bf16 (+ P V_lo), f32 accumulators.  Tiles hold BNB = 64
// positions of bf16 (32 at d = 256) and BNF = BNB / 2 of an f32 pool (its
// four planes fill a stage); the ring has three stages (four at d = 64).
// Why bf16 halves and not TF32: TF32 wgmma takes only K-major operands,
// and V as the B operand of P V is MN-major, so an f32 V tile would need a
// transposed copy; hi + lo keeps an f32 value to 2^-17 of itself in two
// bf16 products, as many tensor-core cycles as one TF32 product, K and V
// alike, on wgmma's MN-major bf16 layout.  P is rounded to bf16 (the
// mma.sync design rounded it to TF32 against an f32 pool).  The engine's
// f32 pools hold bf16 values (the model writes its bf16 k/v), so their lo
// is zero and the flag drops the second products.
//
// Balance: a row's prefix is cut into pieces every `split` positions
// (kernels/paged_prefill.py PREFILL_SPLIT), fixed in position space; the
// last piece also walks the chunk, up to the tile's last query.  A row's
// pieces fold in split order: (M, L, O) is piece 0's (m, l, o), then each
// next piece joins with weights 2^(m - max) (fold_weights / fold_add).  In
// split mode each piece is a work item of its own, writes its partial to
// scratch, and a second launch folds them; in fold mode (where split
// mode's scratch, n_split * B * C * H * (d + 2) * 4 bytes, would pass the
// wrapper's cap) one CTA walks a row's pieces and folds them as it goes in
// a scratch slot of its own.  The operations are the same, so a row's
// output is the same bits in either mode, at any B, table width, C or SM
// count: tile and piece boundaries depend on the row's offset, chunk
// length, query index, G and d alone.  The items are cut into runs of
// equal estimated cost (item_cost) over the CTAs, so that the one wave
// ends together; the last query tile of a (row, head) comes first.  The
// grid and the scratch depend on (B, C, H, K, d, nb) and the SM count, so
// a CUDA graph can hold the launches; an item past its row's prefix is
// skipped.
//
// What bounds this design (the same probes of it): at gemma2-27b's served
// chunk the softmax (53% saved without it: two MUFU operations for the
// softcap and one for P on every score, on 8 consumer warps a SM); over
// long prefixes and at Qwen3-8B C 256 the chain of a tile (staging copy,
// conversion, the two products and the softmax in turn), 15-22% of it the
// loads: each part's share is small, and one CTA a SM leaves little to
// hide a tile's latency behind.

// f32 q (f32 pools): the f32 CUDA cores, so the result holds an f32
// tolerance (TF32 could not).  One CTA per (row, KV head, tile of 64
// (query, head) pairs) whose pairs share each K/V tile staged as f32;
// not on the engine's path.

#include "paged_common.cuh"
#include "sm90_wgmma.cuh"

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
  float* o_part;
  void* ml_part;
  float* fold;
  int B, C, H, K, ps, nb, split, n_split, fold_mode, max_ctas;
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


// ------------------- bf16 q: TMA + wgmma on a three-role CTA ---------------- //
// One CTA a SM, persistent, of three warpgroups.  Warpgroup 0 produces,
// warpgroups 1 and 2 consume 64 (query, head) rows each of a work item's
// 128.  Shared memory (1024-byte aligned): Q [128 x D] bf16, NC ring
// stages and NS staging slots of UNIT bytes each, then the barriers and
// the lo flags.  Every tile in the ring is bf16 in TMA's 128B-swizzled
// layout, column blocks of 64 values (128-byte rows) one after the other:
//   - a bf16 tile (the chunk's k/v, or a bf16 pool's page rows): BNB
//     positions, planes K at 0 and V at UNIT / 2;
//   - an f32 pool tile: BNF = BNB / 2 positions as four planes, K's and
//     V's high halves at 0 and UNIT / 4, their low halves at UNIT / 2
//     and 3 UNIT / 4 (x = hi + lo, hi = bf16(x), lo = bf16(x - hi)).
constexpr int kRows = 128;            // (query, head) rows of a work item
constexpr int kWThreads = 3 * 128;    // producer + two consumer warpgroups
constexpr int kProducerThreads = 128;
constexpr int kConsumerWarps = 8;
constexpr int kRB = 128;              // bytes of a swizzled row
constexpr int kRuns = 4;              // item runs a CTA (see the prologue)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int NCB = D / 64;              // column blocks of a tile
  static constexpr int BNB = D > 128 ? 32 : 64;   // positions, bf16 tile
  static constexpr int BNF = BNB / 2;             // positions, f32 tile
  static constexpr int QBLOCK = kRows * kRB;      // bytes, a Q column block
  static constexpr int QTILE = NCB * QBLOCK;
  static constexpr int QS = D > 128 ? 1 : 2;      // Q slots: the next item's
  static constexpr int UNIT = 2 * BNB * D * 2;    // a stage or a slot
  static constexpr int NC = D == 64 ? 4 : 3;      // ring stages
  static constexpr int NS = D == 64 ? 4 : 2;      // staging slots
  // producer / consumer registers a thread (setmaxnreg): 128 P + 256 C <= 64K
  static constexpr int PREG = D > 128 ? 64 : 96;
  static constexpr int CREG = D > 128 ? 216 : 200;
  static constexpr int SMEM = QS * QTILE + (NC + NS) * UNIT + 256 + 1024;
};

struct WArgs {
  const void* kp;
  const void* vp;
  const int32_t* bt;
  const int32_t* offsets;
  const int32_t* chunk_lens;
  __nv_bfloat16* out;
  float* o_part;         // split mode: [n_split][B][C][H][D] f32, else null
  float2* ml_part;       // split mode: [n_split][B][C][H] (m, l)
  float* fold;           // fold mode: [grid][D / 2][256] f32, else null
  int B, C, H, K, G, QT, n_qt, ps, nb, split, n_split, fold_mode;
  float scale, cap;
};

// A work item: a query tile z (QT queries x the G heads of KV head h) of
// row b, and the pieces s0 .. s1 - 1 of the row's prefix it walks: one
// piece in split mode (its partial goes to o_part / ml_part), all of them
// in fold mode (folded in place, in order).  The last piece also walks the
// chunk, up to the tile's last query.  Item order, the last query tile
// (the most chunk keys) first: (b, h, s, z) where a CTA holds several runs
// of items (`grouped`), so that the items running at one time read one
// head's pages and chunk K/V (from L2); else (z, s, h, b), so that a
// CTA's one run mixes rows.
struct Item {
  int b, h, z, q0, n_pre, cl, n_ch, pieces, s0, s1;
};

__device__ __forceinline__ Item item_at(const WArgs& a, int w, int s_live,
                                        bool grouped) {
  Item it;
  const int S = a.fold_mode ? 1 : s_live;
  int s;
  if (grouped) {
    it.z = a.n_qt - 1 - w % a.n_qt;
    const int rest = w / a.n_qt;
    s = rest % S;
    it.h = (rest / S) % a.K;
    it.b = rest / S / a.K;
  } else {
    const int kb = a.K * a.B;
    it.z = a.n_qt - 1 - w / (S * kb);
    const int rem = w % (S * kb);
    s = rem / kb;
    it.h = (rem % kb) / a.B;
    it.b = rem % a.B;
  }
  if (a.fold_mode) s = 0;
  it.n_pre = min(max(a.offsets[it.b], 0), a.nb * a.ps);
  it.cl = min(max(a.chunk_lens[it.b], 0), a.C);
  it.pieces = max(1, (it.n_pre + a.split - 1) / a.split);
  it.q0 = it.z * a.QT;
  it.n_ch = min(it.cl, min(a.C, it.q0 + a.QT));
  it.s0 = s;
  it.s1 = a.fold_mode ? it.pieces : s + 1;
  return it;
}

// Tiles of piece s: n_pt prefix tiles of BNP positions from s * split,
// then, in the last piece, n_ct chunk tiles of BNB.
template <int BNP, int BNB>
__device__ __forceinline__ void piece_tiles(const WArgs& a, const Item& it,
                                            int s, int& n_pt, int& n_ct) {
  const int lo = s * a.split, hi = min(lo + a.split, it.n_pre);
  n_pt = hi > lo ? (hi - lo + BNP - 1) / BNP : 0;
  n_ct = s == it.pieces - 1 ? (it.n_ch + BNB - 1) / BNB : 0;
}

// An item's estimated cost, in chunk positions: its prefix positions (an
// f32 pool's count twice: two products and a conversion each), its chunk
// positions and a fixed cost (Q, the pipeline's fill; an item with no tile
// loads no Q and only writes zeros).  Items past their row's prefix cost
// nothing.
template <int KP>
__device__ __forceinline__ long long item_cost(const WArgs& a, int w,
                                               int s_live, bool grouped) {
  const Item it = item_at(a, w, s_live, grouped);
  if (it.s0 >= it.pieces) return 0;
  long long c = 0;
  for (int s = it.s0; s < it.s1; ++s) {
    c += KP * (long long)max(0, min((s + 1) * a.split, it.n_pre) - s * a.split);
    if (s == it.pieces - 1) c += it.n_ch;
  }
  return c + (c > 0 ? 128 : 64);
}

// Whether an item has a tile to walk (else it loads no Q).
__device__ __forceinline__ bool has_tiles(const WArgs& a, const Item& it) {
  return it.n_pre > it.s0 * a.split || (it.s1 == it.pieces && it.n_ch > 0);
}

// The first item w whose costs before it, in item order, reach `target`;
// excl[t]: the costs before thread t's run of L items.
template <int KP>
__device__ int cost_boundary(const WArgs& a, int s_live, bool grouped,
                             int n_items, const long long* excl, int L,
                             long long target) {
  if (target <= 0) return 0;
  int lo = 0, hi = kWThreads - 1;             // the last t with excl[t] < target
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (excl[mid] < target) lo = mid;
    else hi = mid - 1;
  }
  long long acc = excl[lo];
  const int end = min(n_items, (lo + 1) * L);
  for (int w = lo * L; w < end; ++w) {
    if (acc >= target) return w;
    acc += item_cost<KP>(a, w, s_live, grouped);
  }
  return end;
}

// The producer's walk ahead: the pool tiles' 16-byte cp.async copies into
// the staging slots run NS - 1 tiles ahead of the tile being filled.
template <int BNP, int BNB>
struct Ahead {
  int w, r, s, t, n_pt, n_ct;
  Item it;
  bool more, grouped;
  const int* rng;            // this CTA's item runs [rng[2r], rng[2r + 1])
  // the first item of run r or later, if any
  __device__ __forceinline__ bool to_run(int r0) {
    for (r = r0; r < kRuns; ++r)
      if (rng[2 * r] < rng[2 * r + 1]) {
        w = rng[2 * r];
        return true;
      }
    return false;
  }
  __device__ __forceinline__ void settle(const WArgs& a, int s_live) {
    // the first tile at or after (w, s, t)
    while (more) {
      if (s < it.s1) {
        piece_tiles<BNP, BNB>(a, it, s, n_pt, n_ct);
        if (t < n_pt + n_ct) return;
        ++s;
        t = 0;
        continue;
      }
      if (++w >= rng[2 * r + 1] && !to_run(r + 1)) {
        more = false;
        return;
      }
      it = item_at(a, w, s_live, grouped);
      s = it.s0;
      t = 0;
    }
  }
  __device__ __forceinline__ void start(const WArgs& a, int s_live,
                                        bool grp, const int* runs) {
    rng = runs;
    grouped = grp;
    more = to_run(0);
    if (!more) return;
    it = item_at(a, w, s_live, grouped);
    s = it.s0;
    t = 0;
    settle(a, s_live);
  }
  __device__ __forceinline__ void advance(const WArgs& a, int s_live) {
    ++t;
    settle(a, s_live);
  }
};

// Position p of one (row, KV head h) of the pool: its row of D values.
template <int D>
__device__ __forceinline__ long long pool_off(const WArgs& a,
                                              const int32_t* bt_row, int h,
                                              int p) {
  return (((long long)bt_row[p / a.ps] * a.ps + p % a.ps) * a.K + h) * D;
}

// 16-byte units of a pool tile: 8 values of one position (the f32 pool's
// two 16-byte pieces, a bf16 pool's one); thread `pt` of the producer
// copies units pt, pt + 128, ... into its staging slot and converts the
// same units later, so no other thread touches them.
template <typename TKV, int D, int BNP>
__device__ __forceinline__ void stage_pool_tile(uint8_t* slot, const WArgs& a,
                                                const Item& it, int p0,
                                                int nval, int pt) {
  constexpr int UB = 8 * sizeof(TKV);          // bytes of a unit
  constexpr int HALF = BNP * D * sizeof(TKV);  // K's, then V's
  const TKV* kp = static_cast<const TKV*>(a.kp);
  const TKV* vp = static_cast<const TKV*>(a.vp);
  constexpr int UPT = BNP * (D / 8) / kProducerThreads;   // units a thread
  static_assert(UPT * kProducerThreads == BNP * (D / 8), "units per thread");
  const int32_t* bt_row = a.bt + (long long)it.b * a.nb;
  // every unit's table read first, so that they are in flight together
  long long off[UPT];
  bool ok[UPT];
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int u = pt + j * kProducerThreads;
    const int r = u / (D / 8), c = (u % (D / 8)) * 8;
    ok[j] = r < nval;
    off[j] = pool_off<D>(a, bt_row, it.h, ok[j] ? p0 + r : p0) + c;
  }
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int u = pt + j * kProducerThreads;
#pragma unroll
    for (int x = 0; x < UB; x += 16) {
      cp_async16_zfill(slot + u * UB + x, reinterpret_cast<const uint8_t*>(
                           kp + off[j]) + x, ok[j]);
      cp_async16_zfill(slot + HALF + u * UB + x,
                       reinterpret_cast<const uint8_t*>(vp + off[j]) + x,
                       ok[j]);
    }
  }
}

// Byte offset of 16-byte chunk c8 (values 8 c8 .. 8 c8 + 7) of row r in a
// swizzled plane of `rows` rows.
__device__ __forceinline__ int swz(int rows, int r, int c8) {
  return (c8 >> 3) * rows * kRB + r * kRB + (((c8 & 7) ^ (r & 7)) << 4);
}

// Staged units into the ring stage: an f32 pool tile as its hi / lo
// planes (returns whether this thread wrote a nonzero lo), a bf16 pool
// tile copied as it is.
template <typename TKV, int D, int BNP>
__device__ __forceinline__ bool convert_pool_tile(uint8_t* stage,
                                                  const uint8_t* slot, int pt) {
  constexpr int UB = 8 * sizeof(TKV);
  constexpr int HALF = BNP * D * sizeof(TKV);
  constexpr int PLANE = BNP * D * 2;
  bool lo_any = false;
  for (int u = pt; u < BNP * (D / 8); u += kProducerThreads) {
    const int r = u / (D / 8), c8 = u % (D / 8);
    const int dst = swz(BNP, r, c8);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint8_t* src = slot + kv * HALF + u * UB;
      uint8_t* plane = stage + kv * PLANE;
      if constexpr (sizeof(TKV) == 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(src);
        const float4 x1 = *reinterpret_cast<const float4*>(src + 16);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 h0 = __float2bfloat16_rn(x[2 * e]);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(x[2 * e + 1]);
          const float l0 = x[2 * e] - __bfloat162float(h0);
          const float l1 = x[2 * e + 1] - __bfloat162float(h1);
          lo_any |= (l0 != 0.f) | (l1 != 0.f);
          hi[e] = (uint32_t)__bfloat16_as_ushort(h0) |
                  ((uint32_t)__bfloat16_as_ushort(h1) << 16);
          lo[e] = pack_bf16(l0, l1);
        }
        *reinterpret_cast<uint4*>(plane + dst) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(plane + 2 * PLANE + dst) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        *reinterpret_cast<uint4*>(plane + dst) =
            *reinterpret_cast<const uint4*>(src);
      }
    }
  }
  return lo_any;
}

// S[64 x BN] = Q[64 x D] K^T from shared memory (K-major both); with `lo`
// the low plane's product is added.  The caller waits.
template <int D, int BN>
__device__ __forceinline__ void qk(float (&s)[BN / 2], uint32_t q,
                                   uint32_t k, uint32_t k_lo, bool lo) {
  constexpr int KB = BN * kRB;             // bytes, a K column block
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && !lo) break;
    const uint32_t kb = pass ? k_lo : k;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      const uint64_t dq = gmma_desc(q + (kk >> 2) * Geo<D>::QBLOCK + col, 16,
                                    8 * kRB, 1);
      const uint64_t dk = gmma_desc(kb + (kk >> 2) * KB + col, 16, 8 * kRB, 1);
      const int acc = pass > 0 || kk > 0;
      if constexpr (BN == 64) wgmma_ss_n64(s, dq, dk, acc);
      else if constexpr (BN == 32) wgmma_ss_n32(s, dq, dk, acc);
      else wgmma_ss_n16(s, dq, dk, acc);
    }
  }
  wgmma_commit();
}

// O[64 x D] += P[64 x BN] V (P from registers as bf16, V MN-major); with
// `lo` the low plane's product is added.  The caller waits.
template <int D, int BN>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   uint32_t (&pa)[BN / 16][4], uint32_t v,
                                   uint32_t v_lo, bool lo) {
  constexpr int VB = BN * kRB;             // bytes, a V column block
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && !lo) break;
    const uint32_t vb = pass ? v_lo : v;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t vk = vb + kk * 16 * kRB;
      if constexpr (D == 256) {
        wgmma_rs_n128<0>(o, pa[kk], gmma_desc(vk, VB, 8 * kRB, 1));
        wgmma_rs_n128<64>(o, pa[kk], gmma_desc(vk + 2 * VB, VB, 8 * kRB, 1));
      } else if constexpr (D == 128) {
        wgmma_rs_n128<0>(o, pa[kk], gmma_desc(vk, VB, 8 * kRB, 1));
      } else {
        wgmma_rs_n64(o, pa[kk], gmma_desc(vk, VB, 8 * kRB, 1));
      }
    }
  }
  wgmma_commit();
}

// One tile of the online softmax for a thread's two rows: S (raw Q K^T
// fragments) becomes P, the bf16 A fragments of P V, with m / l / O
// rescaled (flash_attention.cu's softmax_tile with this kernel's masks).
// Masks: with lim = nullptr the tile's first `nval` positions are live for
// every row (a prefix tile); otherwise position j0 + col is live for row r
// when j0 + col < lim[r] (a chunk tile).  `edge`: some position is masked.
template <int D, int BN>
__device__ __forceinline__ void softmax(float (&s)[BN / 2],
                                        float (&o)[D / 2],
                                        uint32_t (&pa)[BN / 16][4],
                                        float (&m)[2], float (&l)[2],
                                        float scale, float cap, bool edge,
                                        int nval, int j0, const int* lim,
                                        int t) {
  float sc = scale * kLog2e;
  if (cap > 0.f) {
    // cap tanh(s scale / cap) in the exp2 domain; tanh |y| = (1 - e) / (1
    // + e), e = 2^(-2 |y| log2 e): two MUFU operations and no branch,
    // within ~1e-7 of tanh (its absolute error, cap times that on the
    // score, is what the softmax sees)
    const float c2 = -2.f * kLog2e * scale / cap, out = cap * kLog2e;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float e = ex2(fabsf(s[i]) * c2);
      s[i] = copysignf(__fdividef(1.f - e, 1.f + e), s[i]) * out;
    }
    sc = 1.f;
  }
  if (edge) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const bool ok = lim == nullptr ? col < nval : j0 + col < lim[e >> 1];
        if (!ok) s[4 * n + e] = neg_inf();
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

// Named barriers 1 and 2 (0 is __syncthreads): consumer c waits on kTurn +
// c before it issues a tile's Q K^T and then lets the other go, so the two
// warpgroups take turns at the tensor cores and one's softmax runs while
// the other's products do (flash_attention.cu's scheme).  Both walk the
// same tiles; consumer 0's last wait takes consumer 1's last arrival.
constexpr int kTurn = 1;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A row's pieces fold in split order, the same operations whether one CTA
// folds them as it walks (fold mode) or the merge kernel does (split mode),
// so a row's output is the same bits either way: (M, L, O) is the first
// piece's (m, l, o), then each next piece's joins with weights
// 2^(m - max).  Unfused roundings pin the arithmetic.
__device__ __forceinline__ void fold_weights(float& M, float m, float& a,
                                             float& c) {
  const float mn = fmaxf(M, m);
  a = ex2(M - mn);
  c = ex2(m - mn);
  M = mn;
}
__device__ __forceinline__ float fold_add(float X, float a, float x,
                                          float c) {
  return __fadd_rn(__fmul_rn(X, a), __fmul_rn(x, c));
}
__device__ __forceinline__ float fold_out(float O, float L) {
  return L > 0.f ? __fmul_rn(O, __frcp_rn(L)) : 0.f;
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kWThreads, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, WArgs a) {
  using L = Geo<D>;
  constexpr bool F32 = sizeof(TKV) == 4;
  constexpr int BNP = F32 ? L::BNF : L::BNB;       // positions, prefix tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);        // generic view of base
  const uint32_t qs = base;
  const uint32_t ring = base + L::QS * L::QTILE;
  uint8_t* g_ring = gbase + L::QS * L::QTILE;
  uint8_t* g_slots = g_ring + L::NC * L::UNIT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(g_slots + L::NS * L::UNIT);
  uint64_t* q_full = bars;                         // [QS]
  uint64_t* q_empty = bars + L::QS;                // [QS]
  uint64_t* full = bars + 2 * L::QS;               // [NC]
  uint64_t* empty = full + L::NC;                  // [NC]
  int* flags = reinterpret_cast<int*>(empty + L::NC);  // [NC][4]
  int* s_live_sh = flags + 4 * L::NC;
  int* runs_sh = s_live_sh + 1;                    // [2 kRuns]: item runs

  // Q rows past QT * G are never loaded: zeros, once.  The live split
  // count (split mode): the most pieces any row has.
  for (int e = threadIdx.x; e < L::QS * L::QTILE / 16; e += kWThreads)
    reinterpret_cast<uint4*>(gbase)[e] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    *s_live_sh = 1;
    for (int s = 0; s < L::QS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < L::NC; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!a.fold_mode && a.n_split > 1) {
    for (int b = threadIdx.x; b < a.B; b += kWThreads) {
      const int n_pre = min(max(a.offsets[b], 0), a.nb * a.ps);
      atomicMax(s_live_sh, (n_pre + a.split - 1) / a.split);
    }
  }
  __syncthreads();
  const int s_live = *s_live_sh;
  const int n_items =
      a.n_qt * (a.fold_mode ? 1 : s_live) * a.K * a.B;
  // runs a CTA: of at least ~8 items, so that a run's items even out
  const int R = min(kRuns, max(1, n_items / (8 * (int)gridDim.x)));
  const bool grouped = R > 1;
  // This CTA's items: the item order cut into gridDim.x * R runs of equal
  // estimated cost (item_cost), CTA c taking runs c, c + gridDim.x, ...,
  // so that every CTA of the one wave holds about as much work and, with
  // several runs, the CTAs walk the order together (its neighbours share
  // pages and chunk K/V in L2).  Each thread sums the costs of L items; warp 0 scans
  // the sums (in the staging slots, not in use yet) and finds the runs'
  // ends.
  {
    constexpr int KP = F32 ? 2 : 1;
    const int L = (n_items + kWThreads - 1) / kWThreads;
    long long* excl = reinterpret_cast<long long*>(g_slots);
    long long mine = 0;
    for (int w = threadIdx.x * L; w < min(n_items, (threadIdx.x + 1) * L); ++w)
      mine += item_cost<KP>(a, w, s_live, grouped);
    excl[threadIdx.x] = mine;
    __syncthreads();
    if (threadIdx.x < 32) {
      constexpr int PER = kWThreads / 32;
      long long run = 0;
      for (int j = 0; j < PER; ++j) run += excl[threadIdx.x * PER + j];
      long long inc = run;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, inc, o);
        if (threadIdx.x >= o) inc += y;
      }
      const long long total = __shfl_sync(0xffffffffu, inc, 31);
      long long before = inc - run;
      for (int j = 0; j < PER; ++j) {
        const long long x = excl[threadIdx.x * PER + j];
        excl[threadIdx.x * PER + j] = before;
        before += x;
      }
      __syncwarp();
      if (threadIdx.x < 2 * kRuns) {                 // one end a thread
        const long long n = (long long)gridDim.x * R;
        const long long j = blockIdx.x + (long long)(threadIdx.x / 2) *
                            gridDim.x + threadIdx.x % 2;
        runs_sh[threadIdx.x] =
            threadIdx.x >= 2 * R ? 0
            : j == n ? n_items
                     : cost_boundary<KP>(a, s_live, grouped, n_items, excl,
                                         L, (total * j + n - 1) / n);
      }
    }
    __syncthreads();
  }
  const int* runs = runs_sh;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PREG)
                 : "memory");
    const int pt = threadIdx.x;
    Ahead<BNP, L::BNB> ah;
    ah.start(a, s_live, grouped, runs);
    int ahead_it = 0;
    auto issue_ahead = [&]() {
      if (ah.more && ah.t < ah.n_pt) {
        const int p0 = ah.s * a.split + ah.t * BNP;
        const int nval = min(BNP, min((ah.s + 1) * a.split, ah.it.n_pre) - p0);
        stage_pool_tile<TKV, D, BNP>(g_slots + (ahead_it % L::NS) * L::UNIT,
                                     a, ah.it, p0, nval, pt);
      }
      cp_async_commit();
      if (ah.more) ah.advance(a, s_live);
      ++ahead_it;
    };
    for (int k = 0; k < L::NS - 1; ++k) issue_ahead();

    int tile_it = 0, item_it = 0;
    for (int r = 0; r < kRuns; ++r)
    for (int w = runs[2 * r]; w < runs[2 * r + 1]; ++w) {
      const Item it = item_at(a, w, s_live, grouped);
      if (it.s0 >= it.pieces) continue;              // past the row's prefix
      if (!has_tiles(a, it)) continue;               // zeros, from consumers
      if (pt == 0) {
        // a Q slot is free once both consumers are done with the item
        // that held it (the first round's waits pass at once)
        const int qi = item_it % L::QS;
        mbar_wait(&q_empty[qi], ((item_it / L::QS) & 1) ^ 1);
        mbar_expect_tx(&q_full[qi], L::NCB * 64 * a.G * a.QT * 2);
        for (int c = 0; c < L::NCB; ++c)
          tma_load5(qs + qi * L::QTILE + c * L::QBLOCK, &tq, c * 64, 0, it.h,
                    it.q0, it.b, &q_full[qi]);
      }
      ++item_it;
      for (int s = it.s0; s < it.s1; ++s) {
        int n_pt, n_ct;
        piece_tiles<BNP, L::BNB>(a, it, s, n_pt, n_ct);
        for (int t = 0; t < n_pt + n_ct; ++t, ++tile_it) {
          issue_ahead();
          cp_async_wait<L::NS - 1>();                 // this tile's units
          const int st = tile_it % L::NC;
          const uint32_t ph = (tile_it / L::NC) & 1;
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* stage = g_ring + st * L::UNIT;
          if (t < n_pt) {
            const bool lo = convert_pool_tile<TKV, D, BNP>(
                stage, g_slots + (tile_it % L::NS) * L::UNIT, pt);
            const bool any = __any_sync(0xffffffffu, lo);
            if (pt % 32 == 0) flags[st * 4 + pt / 32] = any;
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(&full[st]);
          } else if (pt == 0) {
            const int j0 = (t - n_pt) * L::BNB;
            mbar_expect_tx(&full[st], 2 * L::BNB * D * 2);
            const uint32_t ks = ring + st * L::UNIT;
            for (int c = 0; c < L::NCB; ++c) {
              tma_load(ks + c * L::BNB * kRB, &tk, c * 64, j0, it.h, it.b,
                       &full[st]);
              tma_load(ks + L::UNIT / 2 + c * L::BNB * kRB, &tv, c * 64, j0,
                       it.h, it.b, &full[st]);
            }
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CREG)
                 : "memory");
    const int cw = wg - 1;
    const int ct = threadIdx.x - 128;                 // 0 .. 255
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane >> 2, t4 = lane & 3;
    float o[D / 2];
    float* fold = a.fold == nullptr ? nullptr
                  : a.fold + (long long)blockIdx.x * (D / 2) * 256 + ct;

    if (cw == 1) named_arrive(kTurn);              // consumer 0 goes first
    int tile_it = 0, item_it = 0;
    for (int r = 0; r < kRuns; ++r)
    for (int w = runs[2 * r]; w < runs[2 * r + 1]; ++w) {
      const Item it = item_at(a, w, s_live, grouped);
      if (it.s0 >= it.pieces) continue;
      const bool tiles = has_tiles(a, it);
      const int qi = item_it % L::QS;
      const uint32_t q_wg = qs + qi * L::QTILE + 64 * cw * kRB;
      int rr[2], ri[2], lim[2];
      bool live[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rr[j] = 64 * cw + 16 * warp + g + 8 * j;
        ri[j] = it.q0 + rr[j] / a.G;
        live[j] = rr[j] < a.QT * a.G && ri[j] < a.C;
        lim[j] = min(ri[j] + 1, it.cl);
      }
      // the chunk tiles any row of this warpgroup masks: past its limit
      const int lim_wg = min(it.q0 + (64 * cw) / a.G + 1, it.cl);
      if (tiles) {
        mbar_wait(&q_full[qi], (item_it / L::QS) & 1);
        ++item_it;
      }
      float FM[2], FL[2];
      for (int s = it.s0; s < it.s1; ++s) {
        int n_pt, n_ct;
        piece_tiles<BNP, L::BNB>(a, it, s, n_pt, n_ct);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
        const int p_end = min((s + 1) * a.split, it.n_pre);
        for (int t = 0; t < n_pt + n_ct; ++t, ++tile_it) {
          const int st = tile_it % L::NC;
          const uint32_t ph = (tile_it / L::NC) & 1;
          const uint32_t stage = ring + st * L::UNIT;
          mbar_wait(&full[st], ph);
          if (t < n_pt && F32) {
            const int* f = flags + st * 4;
            const bool lo = (f[0] | f[1] | f[2] | f[3]) != 0;
            const int p0 = s * a.split + t * L::BNF;
            const int nval = min(L::BNF, p_end - p0);
            float sf[L::BNF / 2];
            uint32_t pf[L::BNF / 16][4];
            named_sync(kTurn + cw);
            qk<D, L::BNF>(sf, q_wg, stage, stage + L::UNIT / 2, lo);
            named_arrive(kTurn + 1 - cw);
            wgmma_wait_all();
            fence_regs(sf);
            softmax<D, L::BNF>(sf, o, pf, m, l, a.scale, a.cap,
                               nval < L::BNF, nval, 0, nullptr, t4);
            pv<D, L::BNF>(o, pf, stage + L::UNIT / 4,
                          stage + 3 * (L::UNIT / 4), lo);
            wgmma_wait_all();
            fence_regs(o);
            fence_regs(pf);
          } else {
            const bool pre = t < n_pt;
            const int j0 = pre ? 0 : (t - n_pt) * L::BNB;
            const int nval =
                pre ? min(L::BNB, p_end - (s * a.split + t * L::BNB)) : 0;
            float sb[L::BNB / 2];
            uint32_t pb[L::BNB / 16][4];
            named_sync(kTurn + cw);
            qk<D, L::BNB>(sb, q_wg, stage, stage, false);
            named_arrive(kTurn + 1 - cw);
            wgmma_wait_all();
            fence_regs(sb);
            softmax<D, L::BNB>(sb, o, pb, m, l, a.scale, a.cap,
                               pre ? nval < L::BNB : j0 + L::BNB > lim_wg,
                               nval, j0, pre ? nullptr : lim, t4);
            pv<D, L::BNB>(o, pb, stage + L::UNIT / 2, stage + L::UNIT / 2,
                          false);
            wgmma_wait_all();
            fence_regs(o);
            fence_regs(pb);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);     // this warp is done
        }
        // ---- the piece's end ----
        float Lr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) Lr[j] = quad_sum(l[j]);
        const bool last = s == it.pieces - 1;
        if (it.pieces == 1 || (a.fold_mode && s > 0)) {
          float a_w[2], c_w[2];
          if (it.pieces > 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              fold_weights(FM[j], m[j], a_w[j], c_w[j]);
              FL[j] = fold_add(FL[j], a_w[j], Lr[j], c_w[j]);
            }
#pragma unroll
            for (int i = 0; i < D / 2; ++i)
              o[i] = fold_add(fold[i * 256], a_w[(i >> 1) & 1], o[i],
                              c_w[(i >> 1) & 1]);
          } else {
            FL[0] = Lr[0];
            FL[1] = Lr[1];
          }
          if (last) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (!live[j]) continue;
              __nv_bfloat16* dst =
                  a.out + (((long long)it.b * a.C + ri[j]) * a.H +
                           it.h * a.G + rr[j] % a.G) * D + 2 * t4;
#pragma unroll
              for (int n = 0; n < D / 8; ++n)
                *reinterpret_cast<uint32_t*>(dst + n * 8) =
                    pack_bf16(fold_out(o[4 * n + 2 * j], FL[j]),
                              fold_out(o[4 * n + 2 * j + 1], FL[j]));
            }
          } else {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) fold[i * 256] = o[i];
          }
        } else if (a.fold_mode) {                     // s == 0 of several
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            FM[j] = m[j];
            FL[j] = Lr[j];
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) fold[i * 256] = o[i];
        } else {                                      // a split's partial
          const long long rows = (long long)a.B * a.C * a.H;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!live[j]) continue;
            const long long r = s * rows +
                ((long long)it.b * a.C + ri[j]) * a.H + it.h * a.G +
                rr[j] % a.G;
            float* dst = a.o_part + r * D + 2 * t4;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              *reinterpret_cast<float2*>(dst + n * 8) =
                  make_float2(o[4 * n + 2 * j], o[4 * n + 2 * j + 1]);
            if (t4 == 0) a.ml_part[r] = make_float2(m[j], Lr[j]);
          }
        }
      }
      // the Q slot may be reloaded
      __syncwarp();
      if (tiles && lane == 0) mbar_arrive(&q_empty[qi]);
    }
    if (cw == 0) named_sync(kTurn);                // consumer 1's last turn
  }
}

// Split mode's second launch: each (row, query, head) with two pieces or
// more folds its pieces' partials in split order (fold_weights / fold_add,
// the operations fold mode runs in place); rows of one piece were written
// by kernel 1 and are left alone.  A fixed grid strides over the output
// values of each row that has pieces, so a call where no row does costs
// one short wave.
constexpr int kMergeThreads = 256;

template <int D>
__global__ void __launch_bounds__(kMergeThreads)
paged_prefill_merge_kernel(__nv_bfloat16* __restrict__ out,
                           const float* __restrict__ o_part,
                           const float2* __restrict__ ml_part,
                           const int32_t* __restrict__ offsets, int B, int C,
                           int H, int ps, int nb, int split) {
  const long long rows = (long long)B * C * H;      // partial rows a piece
  const long long per_b = (long long)C * H * D;     // values of a row
  for (int b = 0; b < B; ++b) {
    const int n_pre = min(max(offsets[b], 0), nb * ps);
    const int pieces = max(1, (n_pre + split - 1) / split);
    if (pieces < 2) continue;
    for (long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
         e < per_b; e += (long long)gridDim.x * kMergeThreads) {
      const long long r = b * (per_b / D) + e / D;
      const int dd = e % D;
      float2 ml = ml_part[r];
      float M = ml.x, Lsum = ml.y, O = o_part[r * D + dd];
#pragma unroll 4
      for (int s = 1; s < pieces; ++s) {
        ml = ml_part[s * rows + r];
        const float o = o_part[(s * rows + r) * D + dd];
        float aw, cw;
        fold_weights(M, ml.x, aw, cw);
        Lsum = fold_add(Lsum, aw, ml.y, cw);
        O = fold_add(O, aw, o, cw);
      }
      out[r * D + dd] = __float2bfloat16(fold_out(O, Lsum));
    }
  }
}

// ------------------------------- host ------------------------------------ //
// q [B, C, H, D] read as [B, C, K, G, D], the G heads of a KV head stacked
// under each query: a 5-D map, dims innermost first (D, G, K, C, B), boxes
// of 64 values x G heads x 1 x QT queries x 1, so that box row qi * G + g is
// tile row qi * G + g; queries past C read as zeros.
bool make_q_map(EncodeTiled enc, CUtensorMap* map, const void* q, int B,
                int C, int K, int G, int D, int QT) {
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)K,
                              (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)D * 2, (cuuint64_t)G * D * 2,
                                 (cuuint64_t)K * G * D * 2,
                                 (cuuint64_t)C * K * G * D * 2};
  const cuuint32_t box[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)QT, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(q),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The chunk's k or v [B, C, K, D]: dims (D, C, K, B), boxes of 64 values x
// `rows` positions; positions past C read as zeros.
bool make_kv_map(EncodeTiled enc, CUtensorMap* map, const void* x, int B,
                 int C, int K, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)K,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)K * D * 2, (cuuint64_t)D * 2,
                                 (cuuint64_t)C * K * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TKV, int D>
int launch_wgmma(const PrefillArgs& a) {
  using L = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -2;
  const int G = a.H / a.K, QT = kRows / G;
  CUtensorMap mq, mk, mv;
  if (!make_q_map(enc, &mq, a.q, a.B, a.C, a.K, G, D, QT) ||
      !make_kv_map(enc, &mk, a.k, a.B, a.C, a.K, D, L::BNB) ||
      !make_kv_map(enc, &mv, a.v, a.B, a.C, a.K, D, L::BNB))
    return -3;
  auto kern = paged_prefill_wgmma_kernel<TKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  WArgs w{a.kp, a.vp, a.bt, a.offsets, a.chunk_lens,
          static_cast<__nv_bfloat16*>(a.out), a.o_part,
          static_cast<float2*>(a.ml_part), a.fold, a.B, a.C, a.H, a.K, G, QT,
          (a.C + QT - 1) / QT, a.ps, a.nb, a.split, a.n_split, a.fold_mode,
          a.scale, a.cap};
  const long long items = (long long)w.n_qt * (a.fold_mode ? 1 : a.n_split)
                          * a.K * a.B;
  const int grid = (int)(items < a.max_ctas ? items : a.max_ctas);
  kern<<<grid, kWThreads, L::SMEM, a.stream>>>(mq, mk, mv, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.o_part == nullptr) return static_cast<int>(err);
  paged_prefill_merge_kernel<D><<<4 * a.max_ctas, kMergeThreads, 0,
                                  a.stream>>>(
      static_cast<__nv_bfloat16*>(a.out), a.o_part,
      static_cast<const float2*>(a.ml_part), a.offsets, a.B, a.C, a.H, a.ps,
      a.nb, a.split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch(const PrefillArgs& a) {
  if constexpr (sizeof(TQ) == 4) {
    const int QT = kPairs / (a.H / a.K);
    dim3 grid(a.B, a.K, (a.C + QT - 1) / QT);
    paged_prefill_f32_kernel<TQ, TKV, D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
        static_cast<const TQ*>(a.v), static_cast<const TKV*>(a.kp),
        static_cast<const TKV*>(a.vp), a.bt, a.offsets, a.chunk_lens,
        static_cast<TQ*>(a.out), a.C, a.H, a.K, a.ps, a.nb, a.scale, a.cap);
    return static_cast<int>(cudaGetLastError());
  } else {
    return launch_wgmma<TKV, D>(a);
  }
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
// kv_dtype; q f32 needs f32 pools).  1 <= G = H / K <= 64.  bf16 q: a
// row's prefix is cut into pieces every `split` positions (a multiple of
// 64); n_split = max(1, ceil(nb * ps / split)) pieces at most.  Split mode
// (o_part and ml_part given, [n_split][B][C][H][d] f32 and
// [n_split][B][C][H] (m, l) f32 pairs): pieces run on CTAs of their own and
// a second launch merges them; fold mode (fold given, [max_ctas][128 * d]
// f32): one CTA walks a row's pieces and folds them as it goes; neither
// (n_split 1): no row has two pieces.  The result is the same bits in
// every mode.  max_ctas: the persistent grid's cap.  Returns
// cudaGetLastError() after the launches, -1 for a configuration this file
// was not built for, -2 without the driver's cuTensorMapEncodeTiled, -3
// for a layout a tensor map refuses.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pages,
    const void* v_pages, const void* block_tables, const void* offsets,
    const void* chunk_lens, void* out, void* o_part, void* ml_part,
    void* fold, int B, int C, int H, int K, int d, int ps, int nb,
    int q_dtype, int kv_dtype, int split, int n_split, int fold_mode,
    int max_ctas, float scale, float cap, void* stream) {
  if (K <= 0 || H % K != 0 || H / K <= 0 || H / K > kPairs) return -1;
  if (q_dtype == 1 && (split <= 0 || split % 64 != 0 || n_split < 1 ||
                       max_ctas < 1))
    return -1;
  PrefillArgs a{q, k, v, k_pages, v_pages,
                static_cast<const int32_t*>(block_tables),
                static_cast<const int32_t*>(offsets),
                static_cast<const int32_t*>(chunk_lens), out,
                static_cast<float*>(o_part), ml_part,
                static_cast<float*>(fold), B, C, H, K, ps, nb, split, n_split,
                fold_mode, max_ctas, scale, cap,
                static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 0) return by_head_dim<__nv_bfloat16, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(d, a);
  return -1;
}
