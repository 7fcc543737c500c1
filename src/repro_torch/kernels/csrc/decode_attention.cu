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
// The ring is f32 and an f32 q is held to 2e-5, which rules out TF32 tensor
// cores; the work is bytes-bound anyway.
//
// Design (flash-decoding): the Pallas kernel streams KV blocks along a
// sequential grid axis with (m, l, acc) in VMEM scratch; here the slots of
// a row are split over the grid too, so that B * K rows of KV heads fill
// the card.  Kernel 1 runs one CTA per (split, KV head, row): split s
// walks its share [lo_s, hi_s) of the row's live slots [lo, hi) =
// [max(0, length - window), min(length, T)) in tiles of 32 slots, loaded by
// 16-byte cp.async into a double-buffered shared-memory ring while the
// previous tile is computed, and writes (m, l, acc[d]) per query head into
// f32 scratch (m = -inf, l = 0, acc = 0 for a split with no slots).  The G
// (<= 32) query heads of the KV head share each tile: their q sits in
// shared memory, warp w takes heads w, w + 4, ...; for Q K^T a lane owns
// one slot's whole key row (no shuffle reduction per score), for P V a
// lane owns d / 32 output dims.  Kernel 2 merges a row's splits in a fixed
// order (no atomics: the result does not depend on which split ends
// first); a row with no live slot writes exact zeros.  The host picks the
// split count from B, K, T and the SM count alone
// (decode_attention.py:plan_splits), so a row's result does not depend on
// the other rows' lengths.  k/v are read
// through their strides (head dim dense, 16-byte aligned rows), so the
// model's [B, W, K, d] ring is read in place with no transpose copy.

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // slots per tile: a lane owns one
constexpr int kMaxG = 32;
constexpr int kHeadsPerWarp = kMaxG / kWarps;
constexpr float kLog2e = 1.4426950408889634f;

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

// Shared-memory tile of kTile slots x D in the slab's own type; rows padded
// by 16 bytes, so they stay 16-byte aligned and a lane reading its own row
// 16 bytes at a time meets no bank conflict.
template <typename TKV, int D>
struct SlabTile {
  static constexpr int VEC = 16 / sizeof(TKV);          // elements per 16 B
  static constexpr int LD = D + VEC;
  static constexpr int ELEMS = kTile * LD;
  static constexpr int CHUNKS = D / VEC;                 // 16 B per row
  static constexpr int SMEM_KV = 4 * ELEMS * sizeof(TKV);  // K, V x 2
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue slots [p0, p0 + nt) of one KV head into a tile pair.
template <typename TKV, int D>
__device__ __forceinline__ void load_tile(TKV* ks, TKV* vs, const TKV* kb,
                                          const TKV* vb, long long k_st,
                                          long long v_st, int p0, int nt) {
  using L = SlabTile<TKV, D>;
  for (int e = threadIdx.x; e < nt * L::CHUNKS; e += kThreads) {
    const int r = e / L::CHUNKS, c = (e % L::CHUNKS) * L::VEC;
    cp_async16(ks + r * L::LD + c, kb + (p0 + r) * k_st + c);
    cp_async16(vs + r * L::LD + c, vb + (p0 + r) * v_st + c);
  }
}

// n consecutive elements of a shared-memory row as f32
template <int N>
__device__ __forceinline__ void row_f32(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void row_f32(float (&x)[N],
                                        const __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
slab_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                         const TKV* __restrict__ v,
                         const int32_t* __restrict__ lengths, SlabArgs a) {
  using L = SlabTile<TKV, D>;
  constexpr int DPL = D / 32;                       // output dims per lane
  extern __shared__ __align__(16) uint8_t smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);           // [2][kTile][LD]
  TKV* vs = ks + 2 * L::ELEMS;
  float* qs = reinterpret_cast<float*>(smem + L::SMEM_KV);   // [G][D]
  float* ps = qs + kMaxG * D;                       // [kWarps][kTile]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this split's share of the row's live slots
  const int len = lengths[b];
  const int hi = min(max(len, 0), a.T);
  const int lo = a.window > 0 ? min(max(0, len - a.window), hi) : 0;
  const int per = (hi - lo + a.n_split - 1) / a.n_split;
  const int s_lo = min(lo + split * per, hi);
  const int s_hi = min(s_lo + per, hi);

  // scores go to the exp2 domain: scale * log2(e) folded into q, or the
  // softcap first on the natural scale
  const bool capped = a.cap > 0.f;
  const float qscale = capped ? a.scale : a.scale * kLog2e;
  for (int e = threadIdx.x; e < G * D; e += kThreads)
    qs[e] = to_f(q[b * a.q_sb + (long long)(kh * G + e / D) * a.q_sh +
                   e % D]) * qscale;

  const TKV* kb = static_cast<const TKV*>(k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(v) + b * a.v_sb + kh * a.v_sh;
  if (s_lo < s_hi) {
    load_tile<TKV, D>(ks, vs, kb, vb, a.k_st, a.v_st, s_lo,
                      min(kTile, s_hi - s_lo));
    cp_async_commit();
  }

  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kHeadsPerWarp][DPL];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  int st = 0;
  for (int p0 = s_lo; p0 < s_hi; p0 += kTile, st ^= 1) {
    const int nt = min(kTile, s_hi - p0);
    if (p0 + kTile < s_hi) {            // the next tile flies during this one
      load_tile<TKV, D>(ks + (st ^ 1) * L::ELEMS, vs + (st ^ 1) * L::ELEMS,
                        kb, vb, a.k_st, a.v_st, p0 + kTile,
                        min(kTile, s_hi - p0 - kTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // tile st landed, q in place
    const TKV* kt = ks + st * L::ELEMS;
    const TKV* vt = vs + st * L::ELEMS;

    // Q K^T: lane t scores slot t of the tile against this warp's heads
    float x[kHeadsPerWarp];
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) x[j] = 0.f;
    if (lane < nt) {
      const TKV* kr = kt + lane * L::LD;
#pragma unroll 4
      for (int i = 0; i < D; i += 4) {
        float kv[4];
        row_f32(kv, kr + i);
#pragma unroll
        for (int j = 0; j < kHeadsPerWarp; ++j) {
          const int g = warp + kWarps * j;
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + i);
            x[j] += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g >= G) continue;              // uniform over the warp
      float s = x[j];
      if (capped) s = a.cap * tanhf(s / a.cap) * kLog2e;
      s = lane < nt ? s : __uint_as_float(0xff800000u);   // -inf
      const float m_new = fmaxf(m[j], warp_max(s));
      const float corr = exp2f(m[j] - m_new);
      m[j] = m_new;
      const float p = exp2f(s - m_new);
      l[j] = l[j] * corr + p;           // this lane's share of the sum
      ps[warp * kTile + lane] = p;
      __syncwarp();
      // P V: lane owns dims lane * DPL .. + DPL
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] *= corr;
      for (int t = 0; t < nt; ++t) {
        const float pt = ps[warp * kTile + t];
        float vv[DPL];
        row_f32(vv, vt + t * L::LD + lane * DPL);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[j][i] += pt * vv[i];
      }
      __syncwarp();
    }
    __syncthreads();                    // tile st free for the load after next
  }

  // (m, l, acc) of this split per head; a split with no slots: -inf, 0, 0
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + kWarps * j;
    if (g >= G) continue;
    const float lsum = warp_sum(l[j]);
    const long long idx =
        ((long long)b * a.H + kh * G + g) * a.n_split + split;
    if (lane == 0) {
      a.ml[2 * idx] = lsum > 0.f ? m[j] : __uint_as_float(0xff800000u);
      a.ml[2 * idx + 1] = lsum;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) a.acc[idx * D + lane * DPL + i] = acc[j][i];
  }
}

// One CTA per (row, query head), a thread per output dim: the row's splits
// merged in split order.
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
slab_decode_merge_kernel(TQ* __restrict__ out, SlabArgs a) {
  const int bh = blockIdx.x, i = threadIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const float* ml = a.ml + (long long)bh * a.n_split * 2;
  float mx = __uint_as_float(0xff800000u);
  for (int s = 0; s < a.n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {
      const float w = exp2f(ml[2 * s] - mx);
      lsum += ls * w;
      o += a.acc[((long long)bh * a.n_split + s) * D + i] * w;
    }
  }
  out[b * a.q_sb + h * a.q_sh + i] = from_f<TQ>(lsum > 0.f ? o / lsum : 0.f);
}

template <typename TQ, typename TKV, int D>
int launch(const SlabArgs& a) {
  using L = SlabTile<TKV, D>;
  constexpr int smem = L::SMEM_KV + (kMaxG * D + kWarps * kTile) * 4;
  auto split = slab_decode_split_kernel<TQ, TKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(split),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(a.n_split, a.K, a.B);
  split<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.lengths, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  slab_decode_merge_kernel<TQ, D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<TQ*>(a.out), a);
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
