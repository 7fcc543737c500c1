// Dense GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (defined at :96, its pallas_call at :116).  Every query
// of a sequence attends the same sequence's keys under one online softmax:
// scores q.k * scale in f32, softcap cap * tanh(s / cap) before the mask,
// causal (key <= query), sliding window (query - key < window) or
// bidirectional.  The model's train-mode forward calls it in every layer.
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
//   - bf16 (the trainer's): tensor cores through mma.sync (m16n8k16, f32
//     accumulators), one CTA of 4 warps per (row, head, 64 queries), K/V
//     tiles of 64 keys staged in shared memory as bf16 (see the section
//     below).  No TMA, no wgmma, no pipelining of the tile loads yet:
//     those are later work.
//   - f32: the f32 CUDA cores (the tensor cores' bf16 would lose the f32
//     inputs' precision), one CTA per (row, KV head, floor(64 / G)
//     queries) whose G = H / K heads share each K/V tile staged as f32;
//     any G up to 64 (Hymba's G = 5 uses 60 of the 64 pair slots).
// Block skipping, in both: a CTA's loop runs over keys [kv_lo, kv_hi)
// only, kv_hi = its last query + 1 when causal (tiles above the diagonal
// are never loaded) and kv_lo = its first query - window + 1 with a
// window (tiles wholly outside every query's window are never loaded);
// inside a tile each query masks its own [lo, hi).  Any S: queries past S
// in the last tile load nothing, keep nothing and write nothing, and
// kv_hi never passes S (K/V rows past it are zeros in shared memory).  A
// query with nothing to keep (l == 0) writes exact zeros, as the Pallas
// kernel does.  Layout: q/out [B, H, S, d], k/v [B, K, S, d] as strided
// views (innermost stride 1; the bf16 path reads bf16 pairs, so the other
// strides are even), so the model's [B, S, H, d] activations are read and
// written in place, with no head-major copy.

#include "paged_common.cuh"

namespace {

using namespace paged;

struct FlashArgs {
  int B, H, K, S;
  // element strides of (batch, head, position); the head dim is dense
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal, window;
  float scale, cap;
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
  static constexpr int TT = D >= 128 ? 32 : 64;
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
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators).  One CTA of four
// warps per (row, head, tile of kTcRows queries); each warp owns 16 query
// rows.  Q stays in registers as A fragments for the whole loop; each K/V
// tile of kTcKeys keys is staged in shared memory as bf16 (rows padded by
// 8 elements, so the fragment loads hit 32 distinct banks).  S = Q K^T and
// the online softmax run on the accumulator fragments; P is rounded to
// bf16 and multiplied by V through ldmatrix.trans fragments.  Each thread
// holds two query rows (g and g + 8 of its warp's 16) and reduces row
// maxima and sums over the four threads of its quad.
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;          // queries per CTA: 4 warps x 16
constexpr int kTcKeys = 64;          // keys per K/V tile
constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// -inf marks a masked score (finite scores never reach it)
__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, FlashArgs a) {
  constexpr int LD = D + 8;          // padded shared-memory row
  constexpr int NT = kTcKeys / 8;    // score n-tiles of one K/V tile
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int OT = D / 8;          // output n-tiles
  __shared__ __align__(16) __nv_bfloat16 ks[kTcKeys * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTcKeys * LD];

  const int b = blockIdx.x, h = blockIdx.y, kh = h / (a.H / a.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.z * kTcRows;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};

  // Q as A fragments, zero past S
  uint32_t qa[KS][4];
  const __nv_bfloat16* qb = q + b * a.q_sb + h * a.q_sh;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e & 1];
      const int c = kk * 16 + 2 * t + (e >> 1) * 8;
      qa[kk][e] = r < a.S ? ld32(qb + (long long)r * a.q_ss + c) : 0u;
    }
  }

  // keys each row keeps, [lo, hi); nothing for rows past S
  int lo[2], hi[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rows[j];
    lo[j] = a.window > 0 ? max(0, r - a.window + 1) : 0;
    hi[j] = r >= a.S ? 0 : (a.causal ? r + 1 : a.S);
  }
  // keys any row of this CTA keeps: the block skip
  const int i_last = min(a.S, i0 + kTcRows) - 1;
  const int kv_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? i_last + 1 : a.S;

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const __nv_bfloat16* kb = k + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vb = v + b * a.v_sb + kh * a.v_sh;
  for (int j0 = kv_lo; j0 < kv_hi; j0 += kTcKeys) {
    const int nk = min(kTcKeys, kv_hi - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < kTcKeys * (D / 2); e += kTcThreads) {
      const int r = e / (D / 2), c = (e % (D / 2)) * 2;
      uint32_t kv = 0u, vv = 0u;          // rows past the tile: zeros
      if (r < nk) {
        kv = ld32(kb + (long long)(j0 + r) * a.k_ss + c);
        vv = ld32(vb + (long long)(j0 + r) * a.v_ss + c);
      }
      *reinterpret_cast<uint32_t*>(&ks[r * LD + c]) = kv;
      *reinterpret_cast<uint32_t*>(&vs[r * LD + c]) = vv;
    }
    __syncthreads();

    // S = Q K^T: B[k][n] = K[key n][dim k], a bf16 pair of one K row
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* kr = &ks[(n * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[n], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // scale, softcap, mask (to -inf), row maxima over the quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;
        const int col = j0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        x = (col >= lo[j] && col < hi[j]) ? x : neg_inf();
        s[n][e] = x;
        mx[j] = fmaxf(mx[j], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m_new = fmaxf(m[j], quad_max(mx[j]));
      corr[j] = expf(m[j] - m_new);
      m[j] = m_new;
      l[j] *= corr[j];
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;
        const float p = s[n][e] == neg_inf() ? 0.f : expf(s[n][e] - m[j]);
        s[n][e] = p;
        l[j] += p;
      }
    }

    // O += P V: the score fragments of n-tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk; V's B fragments come transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n2 = 0; n2 < OT / 2; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[vr * LD + n2 * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * n2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // rows with l == 0 (none past S is written) would write zeros
  __nv_bfloat16* ob = out + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float lsum = quad_sum(l[j]);
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
    if (rows[j] >= a.S) continue;
    __nv_bfloat16* orow = ob + (long long)rows[j] * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * j] * inv, o[n][2 * j + 1] * inv);
  }
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              const FlashArgs& a, cudaStream_t stream) {
  dim3 grid(a.B, a.H, (a.S + kTcRows - 1) / kTcRows);
  flash_attention_tc_kernel<D><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

int by_head_dim_f32(int d, const void* q, const void* k, const void* v,
                    void* out, const FlashArgs& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_f32<32>(q, k, v, out, a, stream);
    case 64: return launch_f32<64>(q, k, v, out, a, stream);
    case 128: return launch_f32<128>(q, k, v, out, a, stream);
  }
  return -1;
}

int by_head_dim_bf16(int d, const void* q, const void* k, const void* v,
                     void* out, const FlashArgs& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, out, a, stream);
    case 64: return launch_tc<64>(q, k, v, out, a, stream);
    case 128: return launch_tc<128>(q, k, v, out, a, stream);
  }
  return -1;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Strides are in elements, (batch, head, position) for each of q, k, v,
// out; for bf16 they are even and the pointers 4-byte aligned.  G = H / K
// is at most 64.  Returns cudaGetLastError() after the
// launch, or -1 for a configuration this file was not built for.
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
                    causal, window, scale, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim_f32(d, q, k, v, out, a, st);
  if (dtype == 1) return by_head_dim_bf16(d, q, k, v, out, a, st);
  return -1;
}
