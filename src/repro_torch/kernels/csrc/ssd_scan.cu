// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan (defined
// at :73, its pallas_call at :86).  For each (row, head) it runs the
// state-space recurrence
//   state_t = exp(dt_t * A) * state_{t-1} + (dt_t * x_t) outer B_t,
//   y_t     = state_t . C_t
// in the chunked (state-space duality) form: per chunk of c positions,
// with cum = the inclusive cumulative sum of dt * A over the chunk,
//   y[s]   = sum_{t <= s} (C[s] . B[t]) exp(cum[s] - cum[t]) dt[t] x[t]
//            + exp(cum[s]) C[s] . state,
//   state' = exp(cum[c-1]) state
//            + sum_t exp(cum[c-1] - cum[t]) dt[t] x[t] outer B[t].
// Head h reads SSD group h // (H / G).  The serving model calls it in every
// mamba / hybrid layer of every prefill.
//
// What bounds it on this card: near the balance point.  It reads x, dt,
// B and C once and writes y and the final state once, ~8 bytes per x
// element in f32, and does about 2 * (c * N / 2 + c * P / 2 + 2 * P * N)
// f32 flops per position and head (c the chunk): ~9 k flops per 512
// bytes at Hymba's P = 64, N = 16 with c = 64 (18 flops a byte, against
// the f32 CUDA cores' 67 TFLOP/s over 3.35 TB/s = 20), ~44 k at
// Mamba2-130m's N = 128 (operations).
//
// Design: the Pallas kernel carries the [P, N] state in VMEM scratch
// across a sequential grid axis over chunks; here one CTA per (row, head)
// walks its chunks in order with the state in shared memory (P x N f32:
// 4 KB at Hymba's P = 64, N = 16, 32 KB at Mamba2-130m's N = 128).  Per
// chunk it stages x, dt, B and C (read through strides, so the model's
// slices of the conv output need no copy), scans cum with one warp,
// builds the decay-weighted scores L[s, t] from exp(cum[s] - cum[t])
// (never exp(cum[s]) * exp(-cum[t]), which overflows once cum runs far
// negative), then computes y and updates the state on f32 CUDA cores.
// Shared rows of B, C and the state are padded by one word, so a warp's
// column reads hit 32 banks.  Positions past L (the ragged last chunk)
// load as dt = x = B = C = 0 and write nothing; dt = 0 leaves the state
// exactly as it was, so right-padded prefill rows carry their state
// through the padding.  Simple first: no tensor cores, no overlap of the
// next chunk's loads with this chunk's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct SsdArgs {
  int b, L, H, G, P, N, chunk;
  // element strides (batch, position, head / group); the last dim is dense
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long B_sb, B_sl, B_sg;
  long long C_sb, C_sl, C_sg;
};

__host__ __device__ inline int smem_floats(int c, int P, int N) {
  const int NS = N + 1;
  return c * P + 2 * c * NS + P * NS + c * c + 3 * c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, SsdArgs a) {
  extern __shared__ float smem[];
  const int c = a.chunk, P = a.P, N = a.N, NS = N + 1;
  float* xs = smem;               // [c][P]
  float* bs = xs + c * P;         // [c][NS]
  float* cs = bs + c * NS;        // [c][NS]
  float* S = cs + c * NS;         // [P][NS], the carried state
  float* Lw = S + P * NS;         // [c][c]
  float* dts = Lw + c * c;        // [c]
  float* cum = dts + c;           // [c]
  float* w = cum + c;             // [c]

  const int tid = threadIdx.x, lane = tid % 32;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (a.H / a.G);
  const float Ah = A[h];
  for (int e = tid; e < P * NS; e += kThreads) S[e] = 0.f;

  const T* xb = x + bi * a.x_sb + h * a.x_sh;
  const T* dtb = dt + bi * a.dt_sb + h * a.dt_sh;
  const T* Bb = Bm + bi * a.B_sb + g * a.B_sg;
  const T* Cb = Cm + bi * a.C_sb + g * a.C_sg;
  const long long row_stride = (long long)a.H * P;     // y: [b, L, H, P]
  float* yb = y + (long long)bi * a.L * row_stride + (long long)h * P;

  for (int l0 = 0; l0 < a.L; l0 += c) {
    const int nt = min(c, a.L - l0);
    __syncthreads();                    // the last chunk's reads are done
    for (int e = tid; e < c * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[e] = t < nt ? to_f(xb[(long long)(l0 + t) * a.x_sl + p]) : 0.f;
    }
    for (int e = tid; e < c * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool live = t < nt;
      bs[t * NS + n] = live ? to_f(Bb[(long long)(l0 + t) * a.B_sl + n]) : 0.f;
      cs[t * NS + n] = live ? to_f(Cb[(long long)(l0 + t) * a.C_sl + n]) : 0.f;
    }
    for (int t = tid; t < c; t += kThreads)
      dts[t] = t < nt ? to_f(dtb[(long long)(l0 + t) * a.dt_sl]) : 0.f;
    __syncthreads();

    if (tid < 32) {                     // cum: inclusive scan of dt * A
      float carry = 0.f;
      for (int base = 0; base < c; base += 32) {
        const int t = base + lane;
        float v = t < c ? dts[t] * Ah : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (t < c) cum[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    const float cum_last = cum[c - 1];
    for (int e = tid; e < c * c; e += kThreads) {
      const int s = e / c, t = e % c;
      float val = 0.f;
      if (t <= s) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += cs[s * NS + n] * bs[t * NS + n];
        val = dot * expf(cum[s] - cum[t]) * dts[t];
      }
      Lw[e] = val;
    }
    for (int t = tid; t < c; t += kThreads)
      w[t] = expf(cum_last - cum[t]) * dts[t];
    __syncthreads();

    for (int e = tid; e < c * P; e += kThreads) {
      const int s = e / P, p = e % P;
      if (s >= nt) continue;
      float acc = 0.f;
      for (int t = 0; t <= s; ++t) acc += Lw[s * c + t] * xs[t * P + p];
      float off = 0.f;
      for (int n = 0; n < N; ++n) off += cs[s * NS + n] * S[p * NS + n];
      yb[(long long)(l0 + s) * row_stride + p] = acc + expf(cum[s]) * off;
    }
    __syncthreads();                    // y read the state before the update

    const float decay = expf(cum_last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int t = 0; t < nt; ++t) acc += w[t] * xs[t * P + p] * bs[t * NS + n];
      S[p * NS + n] = S[p * NS + n] * decay + acc;
    }
  }
  __syncthreads();
  float* so = state_out + ((long long)bi * a.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    so[e] = S[p * NS + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, const SsdArgs& a,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(a.chunk, a.P, a.N);
  if (bytes > 232448) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.H, a.b);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(state), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code (x, dt, B and C share it): 0 = float32, 1 = bfloat16; A is
// f32 [H]; y [b, L, H, P] and state [b, H, P, N] are dense f32.  Strides
// in elements.  Returns cudaGetLastError() after the launch, or -1 for a
// configuration this file was not built for.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int b, int L, int H, int G, int P,
    int N, int chunk, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long B_sb,
    long long B_sl, long long B_sg, long long C_sb, long long C_sl,
    long long C_sg, int dtype, void* stream) {
  if (G <= 0 || H % G != 0 || chunk <= 0 || P <= 0 || N <= 0) return -1;
  const SsdArgs a{b, L, H, G, P, N, chunk,
                  x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,
                  B_sb, B_sl, B_sg, C_sb, C_sl, C_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, B, C, y, state, a, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, a, st);
  return -1;
}
