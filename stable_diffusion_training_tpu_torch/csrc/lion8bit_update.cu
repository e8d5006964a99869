// Fused 8-bit Lion update for Hopper (sm_90a): one pass over the int8
// momentum blocks that dequantizes, takes the Lion direction, updates the
// momentum and requantizes it with a fresh per-block scale.
//
// Replaces the TPU kernels `_lion_kernel_dense` (K4, via
// `fused_lion8bit_update_dense`) and `_lion_kernel_transposed` (K5, via
// `fused_lion8bit_update_transposed_packed`) in
// stable_diffusion_training_tpu/ops/lion_kernel.py. Both compute, for each
// block of `bs` consecutive elements of a leaf in the JAX package's flat
// element order:
//   mu    = ((q / 127)^5 - off) / scale            (exact compander)
//         = (q^5 * 127^-5 - off) * (1 / scale)     (fast compander)
//   upd   = sign((1 - b1) g + b1 mu)               (in the grad's dtype)
//   mu'   = (1 - b2) g + b2 mu
//   scale'= 1 / (absmax(mu') <= 0 ? 1 : absmax(mu'))
//   q'    = round_half_even(sign(x + off) |x + off|^(1/5) 127), x = mu' scale'
// with g upcast to f32 first and off = 3.7398995e-09 (zero momentum is code
// 3). Each product and sum is rounded on its own (no FMA contraction), and
// the 5th power is x * ((x x)(x x)), the order of XLA's integer_pow, so the
// dequant is bitwise the JAX package's. powf(x, 0.2f) may differ from XLA's
// pow by an ulp, which moves a code by one at a rounding boundary.
//
// Layout: codes (n_blocks, bs) int8 and scales (n_blocks,) f32 per leaf, the
// reference order of lion_quant.py; codes and scales are updated in place.
// One kernel serves both entries: `lion8bit_update` launches it over one
// leaf (K4's role: every large leaf), `lion8bit_update_multi` over a table
// of leaves (K5's role: all small leaves of a model in one launch, instead
// of one launch per leaf or the JAX package's concat/split copies). A table
// row is four pointers (grad, codes, scales, update) and a prefix sum of
// block counts maps a thread's global block to its leaf.
//
// What bounds it on this card: bytes. Per element it reads a bf16 grad and
// an int8 code and writes a bf16 sign and an int8 code (6 B, plus 8 B of
// scale per block), against ~40 flops and one powf: far below the ~295
// flop/byte ridge. The design: one thread per block, so the absmax and the
// requantization stay in registers with no shuffles or shared memory;
// blocks are read and written as 16-byte vectors where their size allows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kOffset = 3.7398995e-09f;  // _ZERO_CROSSING_OFFSET
constexpr float kPow5C = 0x1.0a3d1cp-35f;  // float32(127^-5), the fast compander's constant
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }

// copy N elements of T between global memory and a register array, in
// 16-, 8- or 4-byte vectors as the size allows
template <typename T, int N>
__device__ __forceinline__ void copy_in(T (&dst)[N], const T* src) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void copy_out(T* dst, const T (&src)[N]) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

struct Coefs {
  float c1, b1, c2, b2;  // 1 - b1, b1, 1 - b2, b2, each rounded to f32
};

// one quantization block of one leaf
template <typename T, int BS, bool FAST>
__device__ __forceinline__ void lion_block(const T* __restrict__ g, int8_t* __restrict__ codes,
                                           float* __restrict__ scale, T* __restrict__ upd,
                                           Coefs k) {
  alignas(16) T gv[BS];
  alignas(16) int8_t qv[BS];
  alignas(16) T uv[BS];
  float mu[BS];
  copy_in(gv, g);
  copy_in(qv, codes);
  const float s = *scale;
  const float inv = FAST ? 1.0f / s : 0.f;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const float gi = to_f32(gv[i]);
    const float q = static_cast<float>(qv[i]);
    float m;
    if (FAST) {
      const float q2 = __fmul_rn(q, q);
      const float q5 = __fmul_rn(__fmul_rn(q2, q2), q);
      m = __fmul_rn(__fsub_rn(__fmul_rn(q5, kPow5C), kOffset), inv);
    } else {
      const float x = __fdiv_rn(q, 127.0f);
      const float x2 = __fmul_rn(x, x);
      const float x5 = __fmul_rn(x, __fmul_rn(x2, x2));
      m = __fdiv_rn(__fsub_rn(x5, kOffset), s);
    }
    uv[i] = from_f32<T>(sign(__fadd_rn(__fmul_rn(k.c1, gi), __fmul_rn(k.b1, m))));
    mu[i] = __fadd_rn(__fmul_rn(k.c2, gi), __fmul_rn(k.b2, m));
    amax = fmaxf(amax, fabsf(mu[i]));
  }
  const float s_new = __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const float shifted = __fadd_rn(__fmul_rn(mu[i], s_new), kOffset);
    const float p = powf(fabsf(shifted), 0.2f);
    qv[i] = static_cast<int8_t>(rintf(__fmul_rn(p * sign(shifted), 127.0f)));
  }
  copy_out(upd, uv);
  copy_out(codes, qv);
  *scale = s_new;
}

template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(kThreads)
    lion_single_kernel(const T* __restrict__ g, int8_t* __restrict__ codes,
                       float* __restrict__ scales, T* __restrict__ upd, int64_t n_blocks,
                       Coefs k) {
  const int64_t blk = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (blk >= n_blocks) return;
  const int64_t off = blk * BS;
  lion_block<T, BS, FAST>(g + off, codes + off, scales + blk, upd + off, k);
}

// table: n_leaves rows of (grad, codes, scales, update) pointers; offsets:
// n_leaves + 1 block-count prefix sums (offsets[0] = 0)
template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(kThreads)
    lion_multi_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ offsets,
                      int n_leaves, Coefs k) {
  const int64_t blk = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (blk >= offsets[n_leaves]) return;
  int lo = 0, hi = n_leaves;  // the leaf with offsets[lo] <= blk < offsets[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (offsets[mid] <= blk) lo = mid;
    else hi = mid;
  }
  const int64_t* row = table + 4 * lo;
  const int64_t local = blk - offsets[lo];
  const int64_t off = local * BS;
  lion_block<T, BS, FAST>(reinterpret_cast<const T*>(row[0]) + off,
                          reinterpret_cast<int8_t*>(row[1]) + off,
                          reinterpret_cast<float*>(row[2]) + local,
                          reinterpret_cast<T*>(row[3]) + off, k);
}

template <typename T, int BS, bool FAST>
cudaError_t launch(const void* g, int8_t* codes, float* scales, void* upd, int64_t n_blocks,
                   const int64_t* table, const int64_t* offsets, int n_leaves, Coefs k,
                   cudaStream_t stream) {
  const int64_t grid = (n_blocks + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (table == nullptr) {
    lion_single_kernel<T, BS, FAST><<<unsigned(grid), kThreads, 0, stream>>>(
        static_cast<const T*>(g), codes, scales, static_cast<T*>(upd), n_blocks, k);
  } else {
    lion_multi_kernel<T, BS, FAST><<<unsigned(grid), kThreads, 0, stream>>>(table, offsets,
                                                                            n_leaves, k);
  }
  return cudaGetLastError();
}

template <typename T, bool FAST>
cudaError_t by_block_size(int bs, const void* g, int8_t* codes, float* scales, void* upd,
                          int64_t n_blocks, const int64_t* table, const int64_t* offsets,
                          int n_leaves, Coefs k, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, 8, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 16: return launch<T, 16, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 32: return launch<T, 32, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 64: return launch<T, 64, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int fast, int bs, const void* g, int8_t* codes, float* scales,
                     void* upd, int64_t n_blocks, const int64_t* table, const int64_t* offsets,
                     int n_leaves, Coefs k, cudaStream_t s) {
  if (dtype == 0)
    return fast ? by_block_size<float, true>(bs, g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s)
                : by_block_size<float, false>(bs, g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
  if (dtype == 1)
    return fast ? by_block_size<__nv_bfloat16, true>(bs, g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s)
                : by_block_size<__nv_bfloat16, false>(bs, g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One leaf: g and upd (n_blocks * bs) of dtype 0 = float32 or 1 = bfloat16,
// in the JAX package's flat element order; codes (n_blocks, bs) int8 and
// scales (n_blocks,) float32, updated in place. bs in {8, 16, 32, 64};
// fast = 1 picks the fast compander. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int lion8bit_update(const void* g, int8_t* codes, float* scales, void* upd,
                               long long n_blocks, int bs, float c1, float b1, float c2,
                               float b2, int fast, int dtype, void* stream) {
  if (n_blocks < 0) return int(cudaErrorInvalidValue);
  return int(dispatch(dtype, fast, bs, g, codes, scales, upd, n_blocks, nullptr, nullptr, 0,
                      Coefs{c1, b1, c2, b2}, static_cast<cudaStream_t>(stream)));
}

// Many leaves of one dtype and block size in one launch: `table` and
// `offsets` in device memory as described above, total_blocks =
// offsets[n_leaves].
extern "C" int lion8bit_update_multi(const int64_t* table, const int64_t* offsets, int n_leaves,
                                     long long total_blocks, int bs, float c1, float b1, float c2,
                                     float b2, int fast, int dtype, void* stream) {
  if (n_leaves < 1 || total_blocks < 0) return int(cudaErrorInvalidValue);
  return int(dispatch(dtype, fast, bs, nullptr, nullptr, nullptr, nullptr, total_blocks, table,
                      offsets, n_leaves, Coefs{c1, b1, c2, b2},
                      static_cast<cudaStream_t>(stream)));
}
