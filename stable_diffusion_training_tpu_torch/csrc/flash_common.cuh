// Helpers shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: dtype conversion, warp
// reductions, f32 tile staging for the CUDA-core kernels, and the bf16
// tensor-core pieces (mma.sync m16n8k16, fragment packing, cp.async tile
// loads, ldmatrix.trans).
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

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of an m16n8k16 product for k-step kk, taken from the f32
// accumulators of two adjacent 8-column n-tiles of an earlier product
// (rows g, g+8; columns 2t, 2t+1 of each tile), rounded to bf16. This is
// how a score tile (S, P or dS) feeds the next product without leaving
// registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); with `valid` false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Starts copying a rows x DP tile of a (S, d) bf16 matrix into shared memory,
// row stride LD, 16 bytes at a time; rows past `valid` (>= 1) and columns
// past `d` land as zeros. Complete after cp_async_wait_all().
template <int DP, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int rows, int valid, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool in = r < valid && c < d;
    cp_async_16(dst + r * LD + c, in ? src + size_t(r) * d + c : src, in);
  }
}

// The A fragments of a 16-row tile of a row-major (rows x D) bf16 matrix in
// shared memory, one per 16-deep k-step over D: rows g and g + 8, columns
// 2t, 2t + 1 and 8 on.
template <int KS, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KS][4], const __nv_bfloat16* tile,
                                             int g, int t) {
  const __nv_bfloat16* row = tile + g * LD + 2 * t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = ld32(row + ks * 16);
    a[ks][1] = ld32(row + 8 * LD + ks * 16);
    a[ks][2] = ld32(row + ks * 16 + 8);
    a[ks][3] = ld32(row + 8 * LD + ks * 16 + 8);
  }
}

// The B fragments of P V for 16 keys and two adjacent 8-column tiles of V,
// read from the row-major (keys x D) V tile in shared memory with ldmatrix,
// which transposes on the way: lanes 8m..8m+7 give the row addresses of
// 8x8 matrix m (keys +8 for odd m, columns +8 for m >= 2). b[0], b[1] feed
// the column tile at `tile`, b[2], b[3] the one 8 columns on.
template <int LD>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                                  int lane) {
  const int m = lane / 8;
  const __nv_bfloat16* row = tile + ((m & 1) * 8 + lane % 8) * LD + (m >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// The tensor-core kernels take 16-byte aligned rows: d % 8 == 0 and every
// base pointer 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs, int d) {
  uintptr_t addr = 0;
  for (const void* p : ptrs) addr |= reinterpret_cast<uintptr_t>(p);
  return d % 8 == 0 && addr % 16 == 0;
}

}  // namespace
