// Fused int8 dequantization and delta accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dequant.py: fused_dequant (its
// pallas_calls at :49 and :53).  A leaf travels as int8 q [R, C] with one
// f32 scale per last-dim channel; installing it computes, in one pass,
//
//   out[r, c] = base[r, c] + q[r, c] * scale[c]      (f32 out)
//
// with base the receiver's resident leaf (f32 or bf16, delta-int8 codec) or
// absent (int8 codec).
//
// What bounds it on this card: bytes.  Per element it reads 1 byte of q and
// 0, 2 or 4 bytes of base and writes 4 bytes of out, for one multiply and
// one add: about 0.2 flops per byte, so the least time is
// (R * C * (1 + 4 + base bytes) + 4 * C) / 3.35 TB/s.
//
// Design: a grid-stride loop over the flat element index, 64-bit
// throughout (the largest Qwen3-8B leaf, mlp.wi at 131072 x 12288, has an
// f32 output of 6.4 GB, whose byte offsets overflow 32 bits).  When C is a
// multiple of 4 each thread handles 4 neighbouring elements of one row per
// step: one 4-byte load of q, one 16-byte load of scale (L1/L2 resident:
// C floats), one 8- or 16-byte load of base and one 16-byte store.
// Otherwise (C = 1 for 1-D leaves, odd widths, or a pointer that is not
// 16-byte aligned) it goes element by element.  The product and the sum
// are rounded separately (__fmul_rn, __fadd_rn: no fused multiply-add), as
// the plain version computes them, so the kernel agrees with it bit for
// bit; bf16 -> f32 of base is exact.
// Simple first: no wider loads than 16 bytes, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

enum BaseType { kNone = 0, kF32 = 1, kBF16 = 2 };

__device__ __forceinline__ float dq(int8_t q, float s, float b) {
  return __fadd_rn(b, __fmul_rn(static_cast<float>(q), s));
}

__device__ __forceinline__ float4 load_base4(const void* base, int64_t i,
                                             int kind) {
  if (kind == kF32) {
    return reinterpret_cast<const float4*>(base)[i / 4];
  }
  if (kind == kBF16) {
    const uint2 raw = reinterpret_cast<const uint2*>(base)[i / 4];
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float load_base1(const void* base, int64_t i,
                                            int kind) {
  if (kind == kF32) return static_cast<const float*>(base)[i];
  if (kind == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  return 0.f;
}

// C % 4 == 0: thread steps over groups of 4 elements of one row.
template <int KIND>
__global__ void dequant_vec4_kernel(const int8_t* __restrict__ q,
                                    const float* __restrict__ scale,
                                    const void* __restrict__ base,
                                    float* __restrict__ out, int64_t n,
                                    int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const char4 qv = reinterpret_cast<const char4*>(q)[i / 4];
    const float4 sv = reinterpret_cast<const float4*>(scale)[(i % C) / 4];
    const float4 bv = load_base4(base, i, KIND);
    float4 o;
    o.x = dq(qv.x, sv.x, bv.x);
    o.y = dq(qv.y, sv.y, bv.y);
    o.z = dq(qv.z, sv.z, bv.z);
    o.w = dq(qv.w, sv.w, bv.w);
    reinterpret_cast<float4*>(out)[i / 4] = o;
  }
}

// Any C: one element per thread step.
template <int KIND>
__global__ void dequant_scalar_kernel(const int8_t* __restrict__ q,
                                      const float* __restrict__ scale,
                                      const void* __restrict__ base,
                                      float* __restrict__ out, int64_t n,
                                      int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = dq(q[i], scale[i % C], load_base1(base, i, KIND));
  }
}

int64_t blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks;
}

template <int KIND>
int launch(const int8_t* q, const float* scale, const void* base, float* out,
           int64_t R, int64_t C, cudaStream_t stream) {
  const int64_t n = R * C;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(base) |
                         reinterpret_cast<uintptr_t>(out);
  if (C % 4 == 0 && addr % 16 == 0) {
    dequant_vec4_kernel<KIND><<<blocks_for(n / 4), kThreads, 0, stream>>>(
        q, scale, base, out, n, C);
  } else {
    dequant_scalar_kernel<KIND><<<blocks_for(n), kThreads, 0, stream>>>(
        q, scale, base, out, n, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [R, C] int8; scale: [C] f32; base: [R, C] (base_dtype 1 = f32,
// 2 = bf16) or null (base_dtype 0); out: [R, C] f32.  All contiguous on one
// device.  Returns the CUDA error of the launch (0 = launched), or -1 for
// an unknown base dtype.
extern "C" int fused_dequant_launch(const void* q, const void* scale,
                                    const void* base, void* out,
                                    long long R, long long C, int base_dtype,
                                    void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (base_dtype) {
    case kNone:
      return launch<kNone>(qp, sp, nullptr, op, R, C, st);
    case kF32:
      return launch<kF32>(qp, sp, base, op, R, C, st);
    case kBF16:
      return launch<kBF16>(qp, sp, base, op, R, C, st);
    default:
      return -1;
  }
}
