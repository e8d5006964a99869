// Helpers shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: dtype conversion, warp
// reductions, f32 tile staging for the CUDA-core kernels, and for the
// tensor-core kernels bf16 packing, the base-2 exp and the alignment check.
// The Hopper pieces (TMA, mbarriers, wgmma, bulk reduce) are in
// hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and back: the value a product sees after `astype(T)`
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows x DP tile of a (S, d) row-major matrix into f32 shared memory; rows
// past `valid` and columns past `d` are zero (zero keys/values contribute
// nothing: their P is 0, and zero columns add nothing to QK^T).
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int valid, int d) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    dst[r * LD + c] = (r < valid && c < d) ? to_f32(src[size_t(r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A score tile in a wgmma accumulator (f32, NR registers a thread) as the
// bf16 A fragments of a register-operand wgmma, one per 16 of its columns:
// the product's reduction then runs over the score tile's columns.
template <int NR>
__device__ __forceinline__ void pack_p(uint32_t (&p)[NR / 8][4], const float (&s)[NR]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

inline bool bases_aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t addr = 0;
  for (const void* p : ptrs) addr |= reinterpret_cast<uintptr_t>(p);
  return addr % 16 == 0;
}

// The tensor-core kernels take 16-byte aligned bf16 rows: d % 8 == 0 and
// every base pointer 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs, int d) { return d % 8 == 0 && bases_aligned16(ptrs); }

}  // namespace
