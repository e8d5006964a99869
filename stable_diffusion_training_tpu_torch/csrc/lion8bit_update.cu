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
// Two kernels compute it, on one arithmetic (the device functions below:
// the dequant table, the IEEE divide by the block's scale, the block's new
// scale, the requantization, the absmax across a block's lanes).
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
// their own.
//
// lion_stream_kernel (the entries over grads already in JAX order:
// `lion8bit_update` one leaf a launch, which the train step sends a leaf
// the table cannot take, among them the FSDP and TP ranks' whole leaves;
// `lion8bit_update_multi` a list of leaves in one launch; the functional
// entry of K6 and K7, a list of one). A leaf list (StreamLeaf: grad, codes,
// scales and sign pointers and the block count; a list of one travels by
// value, a longer one from device memory with its tile prefix sums) is cut
// into tiles of kElems consecutive elements of one leaf (StreamTile: about
// kStageBytes of grads, codes and scales). A persistent grid of 4 CTAs an
// SM (bf16 grads; 2 for f32) walks the tiles, CTA c taking tiles c, c + grid, ...; thread 0
// streams each tile's three runs in by 1-D bulk copies
// (cp.async.bulk ... mbarrier::complete_tx) into a ring of kStages stages,
// one mbarrier each, kStages - 1 tiles ahead of the one computed; the
// updated stage (signs over the consumed grads, new codes over the codes,
// new scales over the scales) goes out by bulk stores, and a stage is
// loaded again only once its stores have read it
// (cp.async.bulk.wait_group.read). A tile whose runs are not all 16-byte
// sized and aligned (a leaf's ragged last tile, a leaf off a 16-byte
// boundary) goes the same way through plain loads and stores. Each thread
// takes 16 bytes of grads (kVec elements) and kVec codes a round, so a
// warp reads shared memory without bank conflicts at any block size; the
// kGroup = bs / kVec neighbouring lanes of a block meet on its absmax by
// shuffles (max does not depend on the order, so every element gets the
// same bits whichever lanes ran it). Codes and scales are bitwise those of
// lion_leaves_kernel on the same bytes.
//
// The arithmetic, per element: the dequant ((q / 127)^5 - off or q^5
// 127^-5 - off) depends only on the code and comes from a 256-entry table
// built by the same operations; the divide by the scale stays the IEEE
// quotient; the requantization takes its code from
// ex2(0.2 lg2 |x| + log2 127)
// and calls powf only within kRoundMargin of a half-integer (requantize),
// so codes are powf's.
//
// What bounds both on this card: bytes. Per element they read a bf16 grad
// and an int8 code and write a bf16 sign and an int8 code (6 B, plus 8 B of
// scale per block), against ~40 flops: far below the ~295 flop/byte ridge,
// if the arithmetic runs under the loads. Block sizes 1, 2, 4, 8, 16, 32,
// 64 and 128 are built for both kernels; any other is refused
// (cudaErrorInvalidValue).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

constexpr float kOffset = 3.7398995e-09f;  // _ZERO_CROSSING_OFFSET
constexpr float kPow5C = 0x1.0a3d1cp-35f;  // float32(127^-5), the fast compander's constant

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

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// copy N elements of T between memory and a register array, in 16-, 8- or
// 4-byte vectors as the size allows (both sides aligned to the vector)
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

// --- the arithmetic both kernels share ------------------------------------------

// above this distance from a half-integer, the approximation of
// 127 |x|^(1/5) below rounds to powf's code (its error is < 2e-4, a
// fifth of the margin)
constexpr float kRoundMargin = 1.0f / 1024;
constexpr float kLog2Of127 = 6.98868465f;  // float32(log2 127)

// (q / 127)^5 - off (exact) or q^5 127^-5 - off (fast), each product and
// sum rounded on its own, for q = -128 ... 127
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

// the 256 entries of dequant_entry, code q at q + 128, by the block's threads
template <bool FAST>
__device__ __forceinline__ void fill_dequant_table(float* deq) {
  for (int q = threadIdx.x; q < 256; q += blockDim.x) deq[q] = dequant_entry<FAST>(float(q - 128));
}

// what the fast compander multiplies by: the IEEE 1 / scale
template <bool FAST>
__device__ __forceinline__ float inverse(float s) {
  return FAST ? 1.0f / s : 0.f;
}

// One element: the momentum from its table entry (divided by the block's
// scale: the IEEE quotient; the fast compander multiplies by `inv`), the
// update sign into `upd`; returns the new momentum.
template <bool FAST>
__device__ __forceinline__ float lion_element(float gi, float entry, float s, float inv, Coefs k, float& upd) {
  const float m = FAST ? __fmul_rn(entry, inv) : __fdiv_rn(entry, s);
  upd = sign(__fadd_rn(__fmul_rn(k.c1, gi), __fmul_rn(k.b1, m)));
  return __fadd_rn(__fmul_rn(k.c2, gi), __fmul_rn(k.b2, m));
}

// the block's new scale from the absmax of its new momentum (1 for a zero block)
__device__ __forceinline__ float block_scale(float amax) {
  return __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);
}

// the absmax of a block whose elements lie on kGroup neighbouring lanes
// (every lane of the warp takes part)
template <int kGroup>
__device__ __forceinline__ float group_absmax(float amax) {
#pragma unroll
  for (int lane = kGroup / 2; lane > 0; lane >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, lane));
  return amax;
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

// rint(sign(s) powf(|s|, 0.2f) 127). The SFU approximation y = ex2(0.2 lg2
// |s| + log2 127) is within 2e-4 of powf's product: y <= 127, and its
// relative error is at most ln 2 (0.2 2^-22.6 + 2^-22 + 2^-22) from lg2,
// the FMA's rounding (|exponent| <= 8 wherever y >= 0.5) and the
// constant's, plus 2^-22.5 from ex2, plus powf's 4 ulp and the product's
// rounding: 1.1e-6 relative in all. Where y lies more than kRoundMargin
// from a half-integer, both round to the same integer; the rest (about 2
// kRoundMargin of the elements) calls powf. Below |s| = 2^-126, y is 0 and
// so is the code.
__device__ __forceinline__ int8_t requantize(float shifted) {
  const float a = fabsf(shifted);
  const float y = ex2_approx(__fmaf_rn(lg2_approx(a), 0.2f, kLog2Of127));
  float code = rintf(y);
  if (fabsf(__fsub_rn(y, code)) > 0.5f - kRoundMargin) code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));
  // sign(s) code: a zero s has a zero code, whatever its sign bit
  return static_cast<int8_t>(__float2int_rn(copysignf(code, shifted)));
}

// the code of new momentum `mu` under the block's new scale
__device__ __forceinline__ int8_t new_code(float mu, float scale) {
  return requantize(__fadd_rn(__fmul_rn(mu, scale), kOffset));
}

// --- lion_stream_kernel: leaves in JAX order, streamed through shared memory ----

constexpr int kThreads = 256;
constexpr int kStageBytes = 16384;  // a tile's grads, codes and scales, about
constexpr int kStages = 4;          // tiles a CTA holds: kStages - 1 in flight
// the grid: this many CTAs an SM (at most one a tile). bf16 grads carry
// the same arithmetic as f32 ones on 3 bytes an element instead of 5, and
// need more warps to run it under the copies; f32 ones ran slower with more
// (probe_lion.py: 4 CTAs 0.079 ms against 2's 0.090 at K6's bf16 leaf, 3 or
// 4 CTAs 0.126 against 2's 0.114 at its f32 one; an H100 at 700 W)
constexpr int kCtasPerSmBf16 = 4;
constexpr int kCtasPerSmF32 = 2;

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// One leaf of a list: ops/lion_kernel.py builds the same five int64.
struct StreamLeaf {
  const void* g;  // grads, n_blocks * bs in JAX order
  int8_t* codes;  // (n_blocks, bs)
  float* scales;  // (n_blocks,)
  void* upd;      // the update signs, like g
  int64_t n_blocks;
};
static_assert(sizeof(StreamLeaf) == 40, "five int64, as the Python table");

// the kernel's parameter: one leaf by value (leaves == nullptr) or a list
// in device memory with each leaf's first tile (tile_offsets, n_leaves + 1)
struct StreamArgs {
  StreamLeaf one;
  const StreamLeaf* leaves;
  const int64_t* tile_offsets;
  int64_t n_tiles;
  int n_leaves;
};

// One tile as thread 0 resolved it, kept in shared memory beside its stage.
struct TileDesc {
  const void* g;
  void* upd;
  int8_t* codes;
  float* scales;
  int blocks;  // blocks in the tile
  int bulk;    // 1: its runs are 16-byte sized and aligned (bulk copies); 0: plain loads
};

// The tile at block size BS and grad type T: kElems elements (kBlocks
// blocks), the largest power of two whose grads, codes and scales fit
// kStageBytes; a thread takes kVec elements (16 bytes of grads, or the
// block) a round, kGroup lanes a block, kRounds rounds a tile. A stage is
// the grads (the signs go out over them), the codes, the scales.
template <typename T, int BS>
struct StreamTile {
  static constexpr int kElems = pow2_floor(kStageBytes / (BS * int(sizeof(T) + 1) + 4) * BS);
  static constexpr int kBlocks = kElems / BS;
  static constexpr int kVec = BS < int(16 / sizeof(T)) ? BS : int(16 / sizeof(T));
  static constexpr int kGroup = BS / kVec;
  static constexpr int kRounds = kElems / (kThreads * kVec);
  static constexpr int kGradBytes = kElems * int(sizeof(T));
  static constexpr int kScaleOffset = kGradBytes + kElems;
  static constexpr int kStage = kScaleOffset + kBlocks * 4;
  static constexpr int kSmem = kStages * kStage + 256 * 4 + kStages * int(sizeof(TileDesc) + sizeof(uint64_t));
  static constexpr int kCtasPerSm = sizeof(T) == 2 ? kCtasPerSmBf16 : kCtasPerSmF32;
  static_assert(kRounds >= 1 && kElems == kRounds * kThreads * kVec, "whole rounds a tile");
  static_assert(kBlocks % 4 == 0 && kStage % 16 == 0, "a full tile's runs are 16-byte multiples");
  static_assert(32 % kGroup == 0, "a block's lanes lie in one warp");
};

// thread 0: which tile `tile` is, and whether bulk copies can move it
template <typename T, int BS>
__device__ __forceinline__ TileDesc tile_desc(const StreamArgs& a, int64_t tile) {
  using L = StreamTile<T, BS>;
  StreamLeaf lf = a.one;
  int64_t t = tile;
  if (a.leaves != nullptr) {
    int lo = 0, hi = a.n_leaves;  // the leaf with tile_offsets[lo] <= tile < tile_offsets[lo + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (a.tile_offsets[mid] <= tile) lo = mid;
      else hi = mid;
    }
    lf = a.leaves[lo];
    t = tile - a.tile_offsets[lo];
  }
  const int64_t b0 = t * L::kBlocks;
  TileDesc d;
  d.blocks = int(min64(L::kBlocks, lf.n_blocks - b0));
  d.g = static_cast<const T*>(lf.g) + b0 * BS;
  d.upd = static_cast<T*>(lf.upd) + b0 * BS;
  d.codes = lf.codes + b0 * BS;
  d.scales = lf.scales + b0;
  const int elems = d.blocks * BS;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(d.g) | reinterpret_cast<uintptr_t>(d.upd) |
                          reinterpret_cast<uintptr_t>(d.codes) | reinterpret_cast<uintptr_t>(d.scales);
  d.bulk = (elems * int(sizeof(T))) % 16 == 0 && elems % 16 == 0 && d.blocks % 4 == 0 && bases % 16 == 0;
  return d;
}

// thread 0: tile j of this CTA into its stage, announced on the stage's barrier
template <typename T, int BS>
__device__ __forceinline__ void stream_in(const StreamArgs& a, unsigned char* smem, TileDesc* desc, uint64_t* bar,
                                          int64_t j) {
  using L = StreamTile<T, BS>;
  const int s = int(j % kStages);
  const TileDesc d = tile_desc<T, BS>(a, blockIdx.x + j * gridDim.x);
  desc[s] = d;
  unsigned char* stage = smem + s * L::kStage;
  if (d.bulk) {
    const uint32_t elems = uint32_t(d.blocks) * BS;
    mbar_arrive_expect_tx(&bar[s], elems * uint32_t(sizeof(T) + 1) + uint32_t(d.blocks) * 4);
    bulk_load(stage, d.g, elems * uint32_t(sizeof(T)), &bar[s]);
    bulk_load(stage + L::kGradBytes, d.codes, elems, &bar[s]);
    bulk_load(stage + L::kScaleOffset, d.scales, uint32_t(d.blocks) * 4, &bar[s]);
  } else {
    mbar_arrive(&bar[s]);  // the consumers load it themselves
  }
}

// thread 0: the updated tile out of its stage, in this thread's bulk group
template <typename T, int BS>
__device__ __forceinline__ void stream_out(const unsigned char* stage, const TileDesc& d) {
  using L = StreamTile<T, BS>;
  const uint32_t elems = uint32_t(d.blocks) * BS;
  bulk_store(d.upd, stage, elems * uint32_t(sizeof(T)));
  bulk_store(d.codes, stage + L::kGradBytes, elems);
  bulk_store(d.scales, stage + L::kScaleOffset, uint32_t(d.blocks) * 4);
}

// every thread: a tile that bulk copies cannot move, element by element
template <typename T, int BS>
__device__ __forceinline__ void plain_in(unsigned char* stage, const TileDesc& d) {
  using L = StreamTile<T, BS>;
  T* g = reinterpret_cast<T*>(stage);
  int8_t* q = reinterpret_cast<int8_t*>(stage + L::kGradBytes);
  float* sc = reinterpret_cast<float*>(stage + L::kScaleOffset);
  const int elems = d.blocks * BS;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    g[e] = static_cast<const T*>(d.g)[e];
    q[e] = d.codes[e];
  }
  for (int b = threadIdx.x; b < d.blocks; b += kThreads) sc[b] = d.scales[b];
}

template <typename T, int BS>
__device__ __forceinline__ void plain_out(const unsigned char* stage, const TileDesc& d) {
  using L = StreamTile<T, BS>;
  const T* g = reinterpret_cast<const T*>(stage);
  const int8_t* q = reinterpret_cast<const int8_t*>(stage + L::kGradBytes);
  const float* sc = reinterpret_cast<const float*>(stage + L::kScaleOffset);
  const int elems = d.blocks * BS;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    static_cast<T*>(d.upd)[e] = g[e];
    d.codes[e] = q[e];
  }
  for (int b = threadIdx.x; b < d.blocks; b += kThreads) d.scales[b] = sc[b];
}

// kVec consecutive elements of one block, part `part` of its kGroup, in a
// stage: the signs over the grads, the new codes over the codes and (part
// 0) the new scale over the scale. `valid` is false for a lane past the
// tile's last block: it still takes part in the shuffles, which need every
// lane of the warp, and writes nothing.
template <typename T, int BS, bool FAST>
__device__ __forceinline__ void update_part(T* g, int8_t* codes, float* scale, const float* deq, Coefs k,
                                            bool valid, int part) {
  using L = StreamTile<T, BS>;
  alignas(16) T gv[L::kVec];
  alignas(16) int8_t qv[L::kVec];
  float mu[L::kVec];
  float amax = 0.f;
  if (valid) {
    copy_in(gv, g);
    copy_in(qv, codes);
    // read before the shuffles below, which part 0's store follows
    const float s = *scale;
    const float inv = inverse<FAST>(s);
#pragma unroll
    for (int i = 0; i < L::kVec; ++i) {
      float upd;
      mu[i] = lion_element<FAST>(to_f32(gv[i]), deq[int(qv[i]) + 128], s, inv, k, upd);
      gv[i] = from_f32<T>(upd);
      amax = fmaxf(amax, fabsf(mu[i]));
    }
  }
  amax = group_absmax<L::kGroup>(amax);
  if (!valid) return;
  const float s_new = block_scale(amax);
#pragma unroll
  for (int i = 0; i < L::kVec; ++i) qv[i] = new_code(mu[i], s_new);
  copy_out(g, gv);
  copy_out(codes, qv);
  if (part == 0) *scale = s_new;
}

// every thread: the update of a tile of `blocks` blocks in its stage
template <typename T, int BS, bool FAST>
__device__ __forceinline__ void update_tile(unsigned char* stage, const float* deq, int blocks, Coefs k) {
  using L = StreamTile<T, BS>;
  T* g = reinterpret_cast<T*>(stage);
  int8_t* q = reinterpret_cast<int8_t*>(stage + L::kGradBytes);
  float* sc = reinterpret_cast<float*>(stage + L::kScaleOffset);
  const int part = threadIdx.x % L::kGroup;
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) {
    const int e0 = (r * kThreads + threadIdx.x) * L::kVec;
    const int blk = e0 / BS;
    if (L::kGroup == 1 && blk >= blocks) break;  // no shuffles to take part in
    update_part<T, BS, FAST>(g + e0, q + e0, sc + blk, deq, k, blk < blocks, part);
  }
}

// A persistent CTA: thread 0 keeps kStages - 1 tiles in flight ahead of the
// one every thread computes, and sends each updated tile out by bulk
// stores; a stage is refilled once its stores have read it.
template <typename T, int BS, bool FAST>
__global__ void __launch_bounds__(kThreads, StreamTile<T, BS>::kCtasPerSm) lion_stream_kernel(StreamArgs a, Coefs k) {
  using L = StreamTile<T, BS>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* deq = reinterpret_cast<float*>(smem + kStages * L::kStage);
  TileDesc* desc = reinterpret_cast<TileDesc*>(deq + 256);
  uint64_t* bar = reinterpret_cast<uint64_t*>(desc + kStages);
  const int64_t mine = (a.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // tiles blockIdx.x + j gridDim.x
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  fill_dequant_table<FAST>(deq);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int64_t j = 0; j < min64(kStages - 1, mine); ++j) stream_in<T, BS>(a, smem, desc, bar, j);
  for (int64_t j = 0; j < mine; ++j) {
    const int s = int(j % kStages);
    unsigned char* stage = smem + s * L::kStage;
    mbar_wait(&bar[s], uint32_t(j / kStages) & 1);
    const TileDesc d = desc[s];
    if (!d.bulk) {
      plain_in<T, BS>(stage, d);
      __syncthreads();
    }
    update_tile<T, BS, FAST>(stage, deq, d.blocks, k);
    fence_proxy_async_smem();  // the stage's new bytes, before the bulk stores read them
    __syncthreads();
    if (!d.bulk) plain_out<T, BS>(stage, d);
    if (threadIdx.x == 0) {
      if (d.bulk) stream_out<T, BS>(stage, d);
      bulk_commit();  // a group a tile, empty for a plain one
      if (j + kStages - 1 < mine) {
        bulk_wait_read<1>();  // tile j - 1's stores have read its stage
        stream_in<T, BS>(a, smem, desc, bar, j + kStages - 1);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();  // shared memory outlives the last stores' reads
}

constexpr int kMaxDevices = 64;

template <typename T, int BS, bool FAST>
cudaError_t launch_stream(const StreamArgs& a, Coefs k, cudaStream_t stream) {
  using L = StreamTile<T, BS>;
  if (a.n_tiles == 0) return cudaSuccess;
  // the instance's full grid on each device (its SMs times kCtasPerSm), set
  // up at its first launch there with its shared memory raised: later
  // launches make no query
  static std::atomic<int> full_grid[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kernel = lion_stream_kernel<T, BS, FAST>;
  int grid_max = full_grid[device].load(std::memory_order_acquire);
  if (grid_max == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    grid_max = sms * L::kCtasPerSm;
    full_grid[device].store(grid_max, std::memory_order_release);
  }
  const int64_t grid = min64(a.n_tiles, grid_max);
  kernel<<<unsigned(grid), kThreads, L::kSmem, stream>>>(a, k);
  return cudaGetLastError();
}

// f(std::integral_constant<int, BS>) at the block sizes built; others refused
template <typename F>
cudaError_t by_block_size(int bs, F&& f) {
  switch (bs) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(T{}, std::bool_constant<FAST>) for grad dtype 0 = float32, 1 = bfloat16
template <typename F>
cudaError_t by_type(int dtype, int fast, F&& f) {
  if (dtype == 0) return fast ? f(float{}, std::true_type{}) : f(float{}, std::false_type{});
  if (dtype == 1) return fast ? f(__nv_bfloat16{}, std::true_type{}) : f(__nv_bfloat16{}, std::false_type{});
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_stream(const StreamArgs& a, int bs, int dtype, int fast, Coefs k, cudaStream_t stream) {
  return by_type(dtype, fast, [&](auto t, auto fast_c) {
    return by_block_size(bs, [&](auto bs_c) {
      return launch_stream<decltype(t), decltype(bs_c)::value, decltype(fast_c)::value>(a, k, stream);
    });
  });
}

// kElems of StreamTile at (bs, dtype); 0 if not built
int stream_tile_elems(int bs, int dtype) {
  int elems = 0;
  by_type(dtype, 0, [&](auto t, auto) {
    return by_block_size(bs, [&](auto bs_c) {
      elems = StreamTile<decltype(t), decltype(bs_c)::value>::kElems;
      return cudaSuccess;
    });
  });
  return elems;
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
  const float inv = inverse<FAST>(s);
  float mu_reg[L::kMuInSmem ? 1 : BS];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const int at = at0 + i * step;
    float upd;
    const float mu = lion_element<FAST>(to_f32(buf[at]), deq[int(qv[i]) + 128], s, inv, k, upd);
    buf[at] = from_f32<T>(upd);
    if constexpr (L::kMuInSmem) mu_smem[threadIdx.x + i * L::kThreads] = mu;
    else mu_reg[i] = mu;
    amax = fmaxf(amax, fabsf(mu));
  }
  const float new_scale = block_scale(amax);
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    float mu;
    if constexpr (L::kMuInSmem) mu = mu_smem[threadIdx.x + i * L::kThreads];
    else mu = mu_reg[i];
    qv[i] = new_code(mu, new_scale);
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
  fill_dequant_table<FAST>(deq);
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

}  // namespace

// One leaf: g and upd (n_blocks * bs) of dtype 0 = float32 or 1 = bfloat16,
// in the JAX package's flat element order; codes (n_blocks, bs) int8 and
// scales (n_blocks,) float32, updated in place. bs in {1, 2, 4, 8, 16, 32,
// 64, 128}; fast = 1 picks the fast compander. lion_stream_kernel, the leaf
// by value. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int lion8bit_update(const void* g, int8_t* codes, float* scales, void* upd,
                               long long n_blocks, int bs, float c1, float b1, float c2,
                               float b2, int fast, int dtype, void* stream) {
  const int elems = stream_tile_elems(bs, dtype);
  if (n_blocks < 0 || elems == 0) return int(cudaErrorInvalidValue);
  StreamArgs a{};
  a.one = StreamLeaf{g, codes, scales, upd, n_blocks};
  a.n_leaves = 1;
  const int64_t per_tile = elems / bs;
  a.n_tiles = (n_blocks + per_tile - 1) / per_tile;
  return int(dispatch_stream(a, bs, dtype, fast, Coefs{c1, b1, c2, b2}, static_cast<cudaStream_t>(stream)));
}

// Many leaves of one dtype and block size in one launch of
// lion_stream_kernel: `leaves` (n_leaves StreamLeaf records, five int64
// each) and `tile_offsets` (n_leaves + 1 prefix sums of the leaves' tiles,
// ceil(n_blocks bs / tile_elems) each; tile_offsets[0] = 0) in device
// memory, n_tiles = tile_offsets[n_leaves]. `tile_elems` is the tile the
// caller cut the list by (ops/lion_kernel.py stream_tile_elements): a tile
// other than the kernel's is refused (cudaErrorInvalidValue).
extern "C" int lion8bit_update_multi(const void* leaves, const long long* tile_offsets, int n_leaves,
                                     long long n_tiles, int tile_elems, int bs, float c1, float b1,
                                     float c2, float b2, int fast, int dtype, void* stream) {
  if (n_leaves < 1 || n_tiles < 0 || tile_elems != stream_tile_elems(bs, dtype)) return int(cudaErrorInvalidValue);
  StreamArgs a{};
  a.leaves = static_cast<const StreamLeaf*>(leaves);
  a.tile_offsets = reinterpret_cast<const int64_t*>(tile_offsets);
  a.n_leaves = n_leaves;
  a.n_tiles = n_tiles;
  return int(dispatch_stream(a, bs, dtype, fast, Coefs{c1, b1, c2, b2}, static_cast<cudaStream_t>(stream)));
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
  return int(by_type(dtype, fast, [&](auto t, auto fast_c) {
    return by_block_size(bs, [&](auto bs_c) {
      return launch_leaves<decltype(t), decltype(bs_c)::value, decltype(fast_c)::value>(table, tile_leaf, grads, upd,
                                                                                         n_tiles, k, s);
    });
  }));
}

// The tile of lion_leaves_kernel at block size bs: JAX blocks per column
// (*groups) and torch columns (*cols); cudaErrorInvalidValue if bs is not
// built. The Python table and its addressing model read the same numbers.
extern "C" int lion8bit_leaf_tile(int bs, int* groups, int* cols) {
  return int(by_block_size(bs, [&](auto bs_c) {
    *groups = LeafTile<decltype(bs_c)::value>::kG;
    *cols = LeafTile<decltype(bs_c)::value>::kT;
    return cudaSuccess;
  }));
}
