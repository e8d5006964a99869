// Fused 8-bit Lion update for Hopper (sm_90a): one pass over the int8
// momentum blocks that dequantizes, takes the Lion direction, updates the
// momentum and requantizes it with a fresh per-block scale.
//
// Replaces the TPU kernels `_lion_kernel_dense` (K4, via
// `fused_lion8bit_update_dense`), `_lion_kernel_transposed` (K5, via
// `fused_lion8bit_update_transposed_packed`), `_lion_kernel` (K6, via
// `fused_lion8bit_update(layout="narrow")`) and `_lion_kernel_wide` (K7, via
// `layout="wide"`) in stable_diffusion_training_tpu/ops/lion_kernel.py. All
// four compute, for each block of `bs` consecutive elements of a leaf in the
// JAX package's flat element order:
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
//
// Two kernels compute it.
//
// lion_leaves_kernel (K4's and K5's role on the train step): every
// quantized leaf of a model in one launch, the grads read and the update
// signs written in torch layout, so no permute copy precedes it. A leaf
// table built once per optimizer state (LeafRecord below) holds each leaf's
// codes and scales pointers, its torch shape as (O, C) with the column map,
// and its first tile; an int per tile names its leaf. Only the grads'
// pointers change between steps: they come by value as a kernel parameter.
// The layout fact it rests on: JAX keeps a Dense kernel (I, O) and a Conv
// kernel (kh, kw, I, O) where torch keeps (O, I) and (O, I, kh, kw); with
// bs dividing O, a JAX block is bs consecutive output channels at one torch
// column, torch column c = i kh kw + h kw + w being JAX row (h kw + w) I +
// i. A tile is kG bs torch rows by kT torch columns (LeafTile): the block
// stages it in shared memory with 16-byte cp.async along torch's
// contiguous columns, each thread then owns one whole JAX block (one
// column, bs rows), keeps its absmax in registers and writes its signs
// back into the tile, which goes out as it came in. Five blocks share an
// SM (the new momentum waits in shared memory, not registers), so one
// block's loads run under the others' arithmetic; a persistent block with
// two tiles in flight needed twice the registers and ran slower. Leaves whose
// two layouts agree (1-D, or no permutation) are the trivial case of the
// same table: a tile is kG kT consecutive blocks, staged as they lie.
// Sector use, per access, for bs = 16 (kG = 4, kT = 64):
// grads and signs 100% (each tile row is 128 or 256 contiguous bytes);
// codes 100% (a thread's 16 bytes, its column's 4 blocks 64 contiguous
// bytes); scales 50% in the block (4 blocks of 4 bytes a column) and full
// in L2, since tiles run along axis 0 first and the next tile reads the
// other half. Neighbouring columns' blocks lie O / bs blocks apart (Dense)
// or I O / bs (Conv, across kh kw), so each column's codes are a sector of
// their own. Its arithmetic per element: the dequant ((q / 127)^5 - off or
// q^5 127^-5 - off) depends only on the code and comes from a 256-entry
// table built by the same operations; the divide by the scale stays the
// IEEE quotient; the requantization takes its code from
// ex2(0.2 lg2 |x| + log2 127)
// and calls powf only within kRoundMargin of a half-integer (requantize).
// Codes are therefore powf's, bitwise those of lion_part.
//
// lion_part, through lion_single_kernel and lion_multi_kernel: the earlier
// kernel over grads already in JAX order, kept for the entries
// `lion8bit_update` (one leaf a launch), `lion8bit_update_multi` (a table
// of leaves built per call) and the functional entry of K6 and K7, and for
// a leaf the table cannot take (bs does not divide its axis 0).
//
// What bounds both on this card: bytes. Per element they read a bf16 grad
// and an int8 code and write a bf16 sign and an int8 code (6 B, plus 8 B of
// scale per block), against ~40 flops and one powf: far below the ~295
// flop/byte ridge. lion_part: for bs <= 64 one thread per block, so the
// absmax and the requantization stay in registers with no shuffles or
// shared memory; blocks are read and written as 16-, 8- or 4-byte vectors
// where their size allows. At bs = 128 one thread would hold 3 x 128 values
// and spill, so a group of 16 neighbouring lanes of a warp takes a block,
// 8 elements each, and the block's absmax meets across the group through
// __shfl_xor_sync: max does not depend on the order, so every element gets
// the same bits whichever variant ran it. Block sizes 1, 2, 4, 8, 16, 32,
// 64 and 128 are built for both kernels; any other is refused
// (cudaErrorInvalidValue).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace {

constexpr float kOffset = 3.7398995e-09f;  // _ZERO_CROSSING_OFFSET
constexpr float kPow5C = 0x1.0a3d1cp-35f;  // float32(127^-5), the fast compander's constant
constexpr int kThreads = 256;

// how a block of BS elements is split over threads: kVec elements on each
// of kGroup neighbouring lanes (kGroup divides 32 and kThreads)
template <int BS>
struct Split {
  static constexpr int kVec = BS <= 64 ? BS : 8;
  static constexpr int kGroup = BS / kVec;
  static_assert(kVec * kGroup == BS && 32 % kGroup == 0, "block size split");
};

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
// 16-, 8- or 4-byte vectors as the size allows (the wrappers hand in
// 16-byte aligned tensors; a part starts at a multiple of its own size)
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
  } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      reinterpret_cast<unsigned*>(dst)[i] = reinterpret_cast<const unsigned*>(src)[i];
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
  } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      reinterpret_cast<unsigned*>(dst)[i] = reinterpret_cast<const unsigned*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

struct Coefs {
  float c1, b1, c2, b2;  // 1 - b1, b1, 1 - b2, b2, each rounded to f32
};

// kVec consecutive elements of one quantization block of one leaf: part
// `part` of the block's kGroup parts, which lie on neighbouring lanes of one
// warp. `valid` is false for a lane past the last block: it still takes part
// in the shuffles, which need every lane of the warp, and stores nothing.
template <typename T, int BS, bool FAST>
__device__ __forceinline__ void lion_part(const T* __restrict__ g, int8_t* __restrict__ codes,
                                          float* __restrict__ scale, T* __restrict__ upd,
                                          Coefs k, bool valid, int part) {
  constexpr int kVec = Split<BS>::kVec;
  constexpr int kGroup = Split<BS>::kGroup;
  alignas(16) T gv[kVec];
  alignas(16) int8_t qv[kVec];
  alignas(16) T uv[kVec];
  float mu[kVec];
  float amax = 0.f;
  if (valid) {
    copy_in(gv, g);
    copy_in(qv, codes);
    // read before the shuffles below, which part 0's store follows
    const float s = *scale;
    const float inv = FAST ? 1.0f / s : 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
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
  }
#pragma unroll
  for (int lane = kGroup / 2; lane > 0; lane >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, lane));
  if (!valid) return;
  const float s_new = __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float shifted = __fadd_rn(__fmul_rn(mu[i], s_new), kOffset);
    const float p = powf(fabsf(shifted), 0.2f);
    qv[i] = static_cast<int8_t>(rintf(__fmul_rn(p * sign(shifted), 127.0f)));
  }
  copy_out(upd, uv);
  copy_out(codes, qv);
  if (part == 0) *scale = s_new;
}

template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(kThreads)
    lion_single_kernel(const T* __restrict__ g, int8_t* __restrict__ codes,
                       float* __restrict__ scales, T* __restrict__ upd, int64_t n_blocks,
                       Coefs k) {
  constexpr int kGroup = Split<BS>::kGroup;
  const int64_t blk = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  const int part = threadIdx.x % kGroup;
  const bool valid = blk < n_blocks;
  if (kGroup == 1 && !valid) return;  // no shuffles to take part in
  const int64_t off = blk * BS + part * Split<BS>::kVec;
  lion_part<T, BS, FAST>(g + off, codes + off, scales + blk, upd + off, k, valid, part);
}

// table: n_leaves rows of (grad, codes, scales, update) pointers; offsets:
// n_leaves + 1 block-count prefix sums (offsets[0] = 0)
template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(kThreads)
    lion_multi_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ offsets,
                      int n_leaves, Coefs k) {
  constexpr int kGroup = Split<BS>::kGroup;
  const int64_t blk = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  const int part = threadIdx.x % kGroup;
  const bool valid = blk < offsets[n_leaves];
  if (kGroup == 1 && !valid) return;  // no shuffles to take part in
  int lo = 0, hi = n_leaves;  // the leaf with offsets[lo] <= blk < offsets[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (offsets[mid] <= blk) lo = mid;
    else hi = mid;
  }
  const int64_t* row = table + 4 * lo;
  const int64_t local = blk - offsets[lo];
  const int64_t off = local * BS + part * Split<BS>::kVec;
  lion_part<T, BS, FAST>(reinterpret_cast<const T*>(row[0]) + off,
                         reinterpret_cast<int8_t*>(row[1]) + off,
                         reinterpret_cast<float*>(row[2]) + local,
                         reinterpret_cast<T*>(row[3]) + off, k, valid, part);
}

template <typename T, int BS, bool FAST>
cudaError_t launch(const void* g, int8_t* codes, float* scales, void* upd, int64_t n_blocks,
                   const int64_t* table, const int64_t* offsets, int n_leaves, Coefs k,
                   cudaStream_t stream) {
  const int64_t grid = (n_blocks * Split<BS>::kGroup + kThreads - 1) / kThreads;
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
    case 1: return launch<T, 1, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 2: return launch<T, 2, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 4: return launch<T, 4, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 8: return launch<T, 8, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 16: return launch<T, 16, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 32: return launch<T, 32, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 64: return launch<T, 64, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
    case 128: return launch<T, 128, FAST>(g, codes, scales, upd, n_blocks, table, offsets, n_leaves, k, s);
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

// ---------------------------------------------------------------------------
// lion_leaves_kernel: every quantized leaf of a model in one launch, grads
// and update signs in torch layout (see the note at the top of the file).

// One leaf of the table, ten int64 (ops/lion_kernel.py LeafTable builds it
// once per optimizer state). kind 0: a torch (O, C) matrix whose JAX layout
// is its transpose with the column map below (Dense (O, I): C = I, kk = 1;
// Conv (O, I, kh, kw): C = I kh kw, kk = kh kw); rows = O. kind 1: a leaf
// whose two layouts agree; rows = its block count, C unused.
struct LeafRecord {
  int64_t codes, scales;  // device pointers, (n_blocks, bs) int8 and (n_blocks,) f32
  int64_t upd_off;        // element offset of the leaf's update in the call's buffer
  int64_t tile0;          // the leaf's first tile
  int64_t rows, cols, in, kk;
  int64_t row_tiles;      // kind 0: tiles along axis 0
  int64_t kind;
};
static_assert(sizeof(LeafRecord) == 80, "ten int64, as the Python table");

// the grads' pointers change every step: they travel by value, as a kernel
// parameter (8 KB: CUDA 12.1+ takes up to 32,764 bytes of parameters)
constexpr int kMaxLeaves = 1024;
struct GradPtrs {
  const void* g[kMaxLeaves];
};

// A tile is kRows = kG * BS torch rows (axis 0) by kT torch columns; thread
// (gl, cl) owns the JAX block of column c0 + cl, rows gl * BS ... + BS - 1.
template <int BS>
struct LeafTile {
  static constexpr int kG = BS <= 16 ? 4 : (BS == 32 ? 2 : 1);
  static constexpr int kT = BS == 128 ? 32 : 64;
  static constexpr int kThreads = kG * kT;
  static constexpr int kRows = kG * BS;
  // the new momentum in shared memory above bs 8, else in registers: with
  // it out of registers, five blocks of 256 threads fit an SM at bs 16
  // without spilling (six spill, and ran slower)
  static constexpr bool kMuInSmem = BS > 8;
  static constexpr int kMinBlocks = 5;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// above this distance from a half-integer, the approximation of
// 127 |x|^(1/5) below rounds to powf's code (its error is < 2e-4, a
// fifth of the margin)
constexpr float kRoundMargin = 1.0f / 1024;
constexpr float kLog2Of127 = 6.98868465f;  // float32(log2 127)

// (q / 127)^5 - off (exact) or q^5 127^-5 - off (fast), the operations
// and roundings of lion_part, for q = -128 ... 127
template <bool FAST>
__device__ __forceinline__ float dequant_entry(float q) {
  if (FAST) {
    const float q2 = __fmul_rn(q, q);
    const float q5 = __fmul_rn(__fmul_rn(q2, q2), q);
    return __fsub_rn(__fmul_rn(q5, kPow5C), kOffset);
  }
  const float v = __fdiv_rn(q, 127.0f);
  const float v2 = __fmul_rn(v, v);
  return __fsub_rn(__fmul_rn(v, __fmul_rn(v2, v2)), kOffset);
}

// the SFU's base-2 logarithm and power (PTX lg2.approx: at most 2^-22.6
// absolute error; ex2.approx: at most 2^-22.5 relative), subnormals as 0
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rint(sign(s) powf(|s|, 0.2f) 127), as lion_part computes it. The SFU
// approximation y = ex2(0.2 lg2 |s| + log2 127) is within 2e-4 of powf's
// product: y <= 127, and its relative error is at most ln 2 (0.2 2^-22.6 +
// 2^-22 + 2^-22) from lg2, the FMA's rounding (|exponent| <= 8 wherever y
// >= 0.5) and the constant's, plus 2^-22.5 from ex2, plus powf's 4 ulp and
// the product's rounding: 1.1e-6 relative in all. Where y lies more than
// kRoundMargin from a half-integer, both round to the same integer; the
// rest (about 2 kRoundMargin of the elements) calls powf. Below |s| =
// 2^-126, y is 0 and so is the code.
__device__ __forceinline__ int8_t requantize(float shifted) {
  const float a = fabsf(shifted);
  const float y = ex2_approx(__fmaf_rn(lg2_approx(a), 0.2f, kLog2Of127));
  float code = rintf(y);
  if (fabsf(__fsub_rn(y, code)) > 0.5f - kRoundMargin) code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));
  // sign(s) code: a zero s has a zero code, whatever its sign bit
  return static_cast<int8_t>(__float2int_rn(copysignf(code, shifted)));
}

// One tile of one leaf as this thread sees it: where the tile lies in
// torch memory and which JAX block the thread owns.
template <typename T>
struct TileView {
  const T* g;
  T* upd;
  int8_t* codes;
  float* scales;
  int64_t blk;       // this thread's JAX block
  int64_t base;      // kind 0: torch offset of the tile's first row and column; kind 1: of its first block
  int64_t cols;      // kind 0: the leaf's torch columns
  int rows_valid;    // kind 0: torch rows (axis 0) of the tile inside the leaf
  int cols_valid;    // kind 0: columns of the tile inside the leaf; kind 1: elements of the tile
  bool transposed, vec, valid;
};

template <typename T, int BS>
__device__ __forceinline__ TileView<T> tile_view(const LeafRecord* __restrict__ leaves,
                                                 const int* __restrict__ tile_leaf, const GradPtrs& grads,
                                                 T* upd_base, int64_t tile) {
  using L = LeafTile<BS>;
  constexpr int kVec = 16 / sizeof(T);
  const int li = tile_leaf[tile];
  const LeafRecord lf = leaves[li];
  TileView<T> v;
  v.g = static_cast<const T*>(grads.g[li]);
  v.upd = upd_base + lf.upd_off;
  v.codes = reinterpret_cast<int8_t*>(lf.codes);
  v.scales = reinterpret_cast<float*>(lf.scales);
  v.cols = lf.cols;
  v.transposed = lf.kind == 0;
  const int64_t t = tile - lf.tile0;
  const int gl = threadIdx.x / L::kT, cl = threadIdx.x % L::kT;
  if (v.transposed) {
    const int64_t nog = lf.rows / BS;  // blocks along axis 0
    const int64_t og0 = (t % lf.row_tiles) * L::kG;
    const int64_t c0 = (t / lf.row_tiles) * L::kT;
    v.rows_valid = int(min64(L::kRows, lf.rows - og0 * BS));
    v.cols_valid = int(min64(L::kT, lf.cols - c0));
    v.base = og0 * BS * lf.cols + c0;
    const int64_t c = c0 + cl;
    v.valid = og0 + gl < nog && cl < v.cols_valid;
    // torch column c = i kk + k is JAX row (k I + i): Dense kk = 1, Conv k = h kw + w
    v.blk = ((c % lf.kk) * lf.in + c / lf.kk) * nog + og0 + gl;
  } else {
    const int64_t blk0 = t * L::kThreads;
    v.blk = blk0 + threadIdx.x;
    v.valid = v.blk < lf.rows;
    v.base = blk0 * BS;
    v.rows_valid = 0;
    v.cols_valid = int(min64(L::kThreads, lf.rows - blk0)) * BS;
  }
  v.vec = (reinterpret_cast<uintptr_t>(v.g) % 16 == 0) && (reinterpret_cast<uintptr_t>(v.upd) % 16 == 0) &&
          (!v.transposed || lf.cols % kVec == 0);
  return v;
}

// Start the copy of a tile's grads into `buf`: kind 0 as kRows x kT (torch
// rows by columns, 16-byte cp.async along the columns), kind 1 as the
// tile's blocks one after another. Without 16-byte alignment, plain loads.
template <typename T, int BS>
__device__ __forceinline__ void stage(T* buf, const TileView<T>& v) {
  using L = LeafTile<BS>;
  constexpr int kVec = 16 / sizeof(T);
  if (v.transposed) {
    constexpr int kPerRow = L::kT / kVec;
    if (v.vec) {
      for (int s = threadIdx.x; s < L::kRows * kPerRow; s += L::kThreads) {
        const int r = s / kPerRow, cv = (s % kPerRow) * kVec;
        const bool in = r < v.rows_valid && cv < v.cols_valid;
        cp_async16(&buf[r * L::kT + cv], in ? v.g + v.base + r * v.cols + cv : v.g, in);
      }
    } else {
      for (int e = threadIdx.x; e < L::kRows * L::kT; e += L::kThreads) {
        const int r = e / L::kT, col = e % L::kT;
        if (r < v.rows_valid && col < v.cols_valid) buf[e] = v.g[v.base + r * v.cols + col];
      }
    }
  } else {
    const int n_vec = v.vec ? v.cols_valid / kVec : 0;
    for (int s = threadIdx.x; s < n_vec; s += L::kThreads)
      cp_async16(&buf[s * kVec], v.g + v.base + s * kVec, true);
    for (int e = n_vec * kVec + threadIdx.x; e < v.cols_valid; e += L::kThreads) buf[e] = v.g[v.base + e];
  }
}

// The tile's update signs from `buf` to torch memory, as stage read them.
template <typename T, int BS>
__device__ __forceinline__ void store(const T* buf, const TileView<T>& v) {
  using L = LeafTile<BS>;
  constexpr int kVec = 16 / sizeof(T);
  if (v.transposed) {
    constexpr int kPerRow = L::kT / kVec;
    if (v.vec) {
      for (int s = threadIdx.x; s < L::kRows * kPerRow; s += L::kThreads) {
        const int r = s / kPerRow, cv = (s % kPerRow) * kVec;
        if (r < v.rows_valid && cv < v.cols_valid)
          *reinterpret_cast<uint4*>(v.upd + v.base + r * v.cols + cv) =
              *reinterpret_cast<const uint4*>(&buf[r * L::kT + cv]);
      }
    } else {
      for (int e = threadIdx.x; e < L::kRows * L::kT; e += L::kThreads) {
        const int r = e / L::kT, col = e % L::kT;
        if (r < v.rows_valid && col < v.cols_valid) v.upd[v.base + r * v.cols + col] = buf[e];
      }
    }
  } else {
    const int n_vec = v.vec ? v.cols_valid / kVec : 0;
    for (int s = threadIdx.x; s < n_vec; s += L::kThreads)
      *reinterpret_cast<uint4*>(v.upd + v.base + s * kVec) = *reinterpret_cast<const uint4*>(&buf[s * kVec]);
    for (int e = n_vec * kVec + threadIdx.x; e < v.cols_valid; e += L::kThreads) v.upd[v.base + e] = buf[e];
  }
}

// the thread's codes and scale for a tile (left as they are when it owns no block)
template <typename T, int BS>
__device__ __forceinline__ void load_block(const TileView<T>& v, int8_t (&qv)[BS], float& s) {
  if (v.valid) {
    copy_in(qv, v.codes + v.blk * BS);
    s = v.scales[v.blk];
  }
}

// The update of the thread's block: grads from `buf`, update signs back
// into `buf`, new codes and scale to device memory.
template <typename T, int BS, bool FAST>
__device__ __forceinline__ void update_block(T* buf, float* mu_smem, const float* deq, const TileView<T>& v,
                                             int8_t (&qv)[BS], float s, Coefs k) {
  using L = LeafTile<BS>;
  const int gl = threadIdx.x / L::kT, cl = threadIdx.x % L::kT;
  // element i of the block in buf: a column of the tile, or a run of BS
  const int at0 = v.transposed ? gl * BS * L::kT + cl : threadIdx.x * BS;
  const int step = v.transposed ? L::kT : 1;
  const float inv = FAST ? 1.0f / s : 0.f;  // the fast compander multiplies by it
  float mu_reg[L::kMuInSmem ? 1 : BS];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const int at = at0 + i * step;
    const float gi = to_f32(buf[at]);
    const float entry = deq[int(qv[i]) + 128];
    const float m = FAST ? __fmul_rn(entry, inv) : __fdiv_rn(entry, s);
    buf[at] = from_f32<T>(sign(__fadd_rn(__fmul_rn(k.c1, gi), __fmul_rn(k.b1, m))));
    const float mu = __fadd_rn(__fmul_rn(k.c2, gi), __fmul_rn(k.b2, m));
    if constexpr (L::kMuInSmem) mu_smem[threadIdx.x + i * L::kThreads] = mu;
    else mu_reg[i] = mu;
    amax = fmaxf(amax, fabsf(mu));
  }
  const float new_scale = __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    float mu;
    if constexpr (L::kMuInSmem) mu = mu_smem[threadIdx.x + i * L::kThreads];
    else mu = mu_reg[i];
    qv[i] = requantize(__fadd_rn(__fmul_rn(mu, new_scale), kOffset));
  }
  copy_out(v.codes + v.blk * BS, qv);
  v.scales[v.blk] = new_scale;
}

// One tile a block: its grads staged by cp.async while the thread's codes
// and scale load into registers, the update, the signs back out. The
// loads of one block run under the arithmetic of the others on the SM
// (kMinBlocks of them).
template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(LeafTile<BS>::kThreads, LeafTile<BS>::kMinBlocks)
    lion_leaves_kernel(const LeafRecord* __restrict__ leaves, const int* __restrict__ tile_leaf,
                       GradPtrs grads, T* __restrict__ upd_base, Coefs k) {
  using L = LeafTile<BS>;
  __shared__ alignas(16) T buf[L::kRows * L::kT];  // grads in, update signs out
  __shared__ float mu_smem[L::kMuInSmem ? L::kRows * L::kT : 1];
  __shared__ float deq[256];
  for (int q = threadIdx.x; q < 256; q += L::kThreads) deq[q] = dequant_entry<FAST>(float(q - 128));
  const TileView<T> v = tile_view<T, BS>(leaves, tile_leaf, grads, upd_base, blockIdx.x);
  alignas(16) int8_t qv[BS];
  float s = 1.f;
  load_block<T, BS>(v, qv, s);
  stage<T, BS>(buf, v);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (v.valid) update_block<T, BS, FAST>(buf, mu_smem, deq, v, qv, s, k);
  __syncthreads();
  store<T, BS>(buf, v);
}

template <typename T, int BS, bool FAST>
cudaError_t launch_leaves(const LeafRecord* leaves, const int* tile_leaf, const GradPtrs& grads,
                          void* upd, int64_t n_tiles, Coefs k, cudaStream_t stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  lion_leaves_kernel<T, BS, FAST><<<unsigned(n_tiles), LeafTile<BS>::kThreads, 0, stream>>>(
      leaves, tile_leaf, grads, static_cast<T*>(upd), k);
  return cudaGetLastError();
}

template <typename T, bool FAST>
cudaError_t leaves_by_block_size(int bs, const LeafRecord* leaves, const int* tile_leaf,
                                 const GradPtrs& grads, void* upd, int64_t n_tiles, Coefs k,
                                 cudaStream_t s) {
  switch (bs) {
    case 1: return launch_leaves<T, 1, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 2: return launch_leaves<T, 2, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 4: return launch_leaves<T, 4, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 8: return launch_leaves<T, 8, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 16: return launch_leaves<T, 16, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 32: return launch_leaves<T, 32, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 64: return launch_leaves<T, 64, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    case 128: return launch_leaves<T, 128, FAST>(leaves, tile_leaf, grads, upd, n_tiles, k, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One leaf: g and upd (n_blocks * bs) of dtype 0 = float32 or 1 = bfloat16,
// in the JAX package's flat element order; codes (n_blocks, bs) int8 and
// scales (n_blocks,) float32, updated in place. bs in {1, 2, 4, 8, 16, 32,
// 64, 128};
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

// Every leaf of a LeafTable in one launch: `leaves` (n_leaves records) and
// `tile_leaf` (n_tiles ints: each tile's leaf) in device memory, built once
// per optimizer state; `grad_ptrs` a host array of n_leaves grad pointers,
// each leaf's grad contiguous in torch layout, of dtype 0 = float32 or 1 =
// bfloat16; `upd` the call's update buffer (each leaf's signs at its
// upd_off, torch layout). Codes and scales are updated in place. n_leaves
// <= 1024 (the wrapper launches once per 1024 leaves). Returns the launch's
// cudaError_t; does not synchronise.
extern "C" int lion8bit_update_leaves(const void* leaves, const int* tile_leaf,
                                      const long long* grad_ptrs, int n_leaves, long long n_tiles,
                                      void* upd, int bs, float c1, float b1, float c2, float b2,
                                      int fast, int dtype, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_tiles < 0) return int(cudaErrorInvalidValue);
  GradPtrs grads{};
  for (int i = 0; i < n_leaves; ++i) grads.g[i] = reinterpret_cast<const void*>(grad_ptrs[i]);
  const auto* table = static_cast<const LeafRecord*>(leaves);
  const Coefs k{c1, b1, c2, b2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(fast ? leaves_by_block_size<float, true>(bs, table, tile_leaf, grads, upd, n_tiles, k, s)
                    : leaves_by_block_size<float, false>(bs, table, tile_leaf, grads, upd, n_tiles, k, s));
  if (dtype == 1)
    return int(fast ? leaves_by_block_size<__nv_bfloat16, true>(bs, table, tile_leaf, grads, upd, n_tiles, k, s)
                    : leaves_by_block_size<__nv_bfloat16, false>(bs, table, tile_leaf, grads, upd, n_tiles, k, s));
  return int(cudaErrorInvalidValue);
}

// The tile of lion_leaves_kernel at block size bs: JAX blocks per column
// (*groups) and torch columns (*cols); 0 if bs is not built. The Python
// table and its addressing model read the same numbers.
extern "C" int lion8bit_leaf_tile(int bs, int* groups, int* cols) {
  switch (bs) {
#define LION_TILE(B) \
  case B: *groups = LeafTile<B>::kG; *cols = LeafTile<B>::kT; return 0;
    LION_TILE(1) LION_TILE(2) LION_TILE(4) LION_TILE(8) LION_TILE(16) LION_TILE(32) LION_TILE(64)
    LION_TILE(128)
#undef LION_TILE
    default: return int(cudaErrorInvalidValue);
  }
}
