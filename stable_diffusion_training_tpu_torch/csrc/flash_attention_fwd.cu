// Flash-attention forward for Hopper (sm_90a), f32 and bf16 I/O.
//
// Replaces the TPU kernel `_fwd_kernel` (stable_diffusion_training_tpu/ops/
// flash_attention.py:47), launched by `_flash_fwd_impl` (:237): blockwise
// online-softmax attention over heads folded to (B*H, S, D), f32 logits and
// accumulator, P cast to V's dtype before the PV product with l summing the
// unrounded f32 P, keys past kv_len masked, the `l == 0` guard, and the
// per-row logsumexp written beside O.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16 on the tensor
// cores, 16 exps per clock per SM, 50 MB of L2):
// - D = 40, the UNet's 64x64 latent self-attention ((64, 4096, 40) in the
//   train step, (16, 4096, 40) when serving): the exps. A logit costs one
//   exp and 160 flops of products; the train shape's 1.07 G exps take the
//   SFUs 0.257 ms, its 172 GFLOP the tensor cores 0.174 ms. Around each exp
//   the softmax issues a max, an FFMA, an add and half a bf16 pack, so the
//   issue slots and the latency of that chain matter as much as the SFU.
// - D = 512, the VAE's single-head mid-block ((8, 4096, 512) in the train
//   step, (1, 4096, 512) when serving): the products (275 GFLOP, 0.278 ms
//   for the train shape), then the bytes from L2: every block streams its
//   head's whole K and V (8 MB), query blocks x 8 MB per head.
//
// The design. Six routes share the entry point `flash_attention_fwd`, which
// picks one from the dtype, the head dim and the bases' alignment (the same
// choice as ops/flash_attention.py's `forward_route`) and reports it:
//
// bf16, D % 8 == 0, every base 16-byte aligned: the tensor cores. The three
// bf16 kernels are one template (`flash_fwd_tma_kernel`), warp-
// specialised: warpgroup 0 produces (setmaxnreg down to 24 or 40), the
// others consume (up to 112, 160 or 232). One producer thread streams Q once
// and the K tiles, another the V tiles, each by TMA into a ring of stages
// with a full and an empty mbarrier per stage; K and V have separate rings
// because a tile's K is free once S is computed and its V only after P V.
// A consumer warpgroup owns 64 query rows and runs, per key tile j:
//   S_j = Q K_j^T          wgmma, both operands K-major in shared memory
//   O  *= corr_{j-1}       while S_j runs
//   O  += P_{j-1} V_{j-1}  wgmma, P the bf16 register A operand, V MN-major
//                          (row-major tiles, the transpose bit)
//   softmax of S_j         while P_{j-1} V_{j-1} runs: a tree of row maxima,
//                          one FFMA and one exp2 per logit
//                          (s * scale_log2 - m * scale_log2), the mask only
//                          on the last tile
// ptxas hoists a wgmma wait to the top of its basic block; the wait for the
// next K tile (a loop) ends the block before the wait for P V, which keeps
// the softmax above it.
//
// 1. bf16, D % 8 == 0, D <= 64 (`flash_fwd_tma_kernel<DP, false>`, DP = D
//    rounded up to 16, 40 kept as is): four consumer warpgroups, 256 query
//    rows per block, 64-key tiles, three stages. QK^T runs 3 k-steps at
//    D = 40 (TMA zero-fills columns 40-47 of the 64-column box); P V is
//    m64n40k16. Four consumer warps on each SM sub-partition hide the
//    softmax's dependency chain better than two warpgroups of 128 rows
//    (PERF.md has the measurements). 256 rows per block also quarter the L2
//    bytes of the 64-row mma.sync kernel this replaces. Shared memory: Q
//    32 KB, K and V 2 x 3 x 8 KB = 80 KB (+1 KB for alignment); 640 threads,
//    one block per SM.
// 2. bf16, D % 8 == 0, 64 < D <= 128 (`flash_fwd_tma_kernel<DP, false>`, DP
//    = D rounded up to 16: 80, 96, 112, 128; route `tma_mid`, SD1.5's
//    640-channel level, 8 heads of 80): design 1 over two 64-column TMA
//    boxes. Each consumer warpgroup owns 64 query rows and all of D, so S is
//    computed once per warpgroup and nothing is exchanged: QK^T runs DP / 16
//    k-steps across both boxes (5 at D = 80; TMA zero-fills columns 80-127,
//    which no product reads), and P V runs one wgmma over V's columns 0-63
//    and one over the DP - 64 in its second box (m64n64k16 + m64n16k16 at
//    D = 80), each inside one 128-byte swizzle atom (an MN-major operand of
//    80 columns would span 1.25 atoms), into one accumulator whose columns
//    run on as a single m64nDP product's would: 40 f32 registers a thread
//    at D = 80, 64 at 128. Three consumers (192 query rows a block): 160
//    registers a consumer thread after the producer's setmaxnreg (four
//    would leave 112, which O, S and P of D = 128 alone exceed). 64-key
//    tiles, three stages: Q 48 KB, K and V 2 x 3 x 16 KB (+1 KB), 512
//    threads, one block per SM. Bound at (64, 2704, 80): the products
//    (150 GFLOP, 0.151 ms) and the exps (0.47 G, 0.13 ms on the SFUs); it
//    runs at ~2.4x that, two and four consumers slower (PERF.md,
//    probe_flash_fwd.py).
// 3. bf16, D % 8 == 0, 128 < D <= 512 (`flash_fwd_tma_kernel<DP, true>`, DP
//    = 256 or 512; route `tma_wide`): O for 64 rows at D = 512 is 256 f32 registers a
//    thread in one warpgroup, so two consumer warpgroups split D: each owns
//    half of O's columns (m64n256k16 at D = 512: 128 registers) and
//    computes the partial S over its half of D (16 k-steps of m64n32k16).
//    The halves meet through shared memory (double-buffered by tile parity,
//    one named barrier a tile), so S is computed once and both warpgroups
//    hold identical S, m and l. O's 128 registers are corrected only where
//    a warp's row maxima moved (a warp vote). 64 query rows per block (4x
//    fewer L2 bytes than the 16-row kernel this replaces), 32-key tiles, two
//    stages: Q 64 KB, K and V 2 x 2 x 32 KB, S halves 32 KB = 224 KB at
//    DP = 512 (+1 KB), which leaves no room for a third stage or wider key
//    tiles; 384 threads, one block per SM. Its DP = 128 instance (D padded
//    to 128, 64 rows a block) ran 64 < D <= 128 until route 2 and stays
//    callable (`flash_attention_fwd_tma_wide`) to compare with it.
// 4. f32, D % 4 == 0, every base 16-byte aligned (`flash_fwd_f32_narrow_kernel`
//    at D <= 64, `flash_fwd_f32_mid_kernel` at 64 < D <= 128, route
//    `f32_mid`, `flash_fwd_f32_wide_kernel` above): exact f32 FMA on the
//    CUDA cores (TF32 would change the numerics), so 67 TFLOP/s bounds them:
//    2.56 ms at (64, 4096, 40), 2.24 ms at (64, 2704, 80), 4.10 ms at
//    (8, 4096, 512). The FMA instruction rate limits all three, so each
//    holds big register micro-tiles (one block of
//    8 warps an SM, up to 254 registers a thread): each float4 read from
//    shared memory feeds 16 to 32 FMAs. The softmax is one FFMA and one exp2
//    a logit (scale * log2 e folded in, the mask only on the last tile); row
//    maxima are reduced over the few lanes that share a row; the next chunk
//    of K or V arrives by cp.async (zero-filled past S and D) while this one
//    is computed. Fixed orders throughout: O and lse repeat bitwise.
//    - narrow (DP = D rounded up to 16, 32, 40, 48 or 64): 256 threads own
//      one head's 256 query rows, Q staged once. K and V tiles of 64 keys
//      stream through a two-stage ring. A thread holds S for 8 rows x 8 keys
//      (rows rg + 32 i, keys kg + 8 j: a row's 64 keys on 8 lanes, 3
//      shuffles for its max; the sum is reduced once at the end); P goes to
//      shared memory, and O += P V holds 8 rows x D/8 columns a thread
//      (columns kg + 8 c, so D = 40 has no padded column; V is read as
//      scalars, one load per 8 FMAs). Two barriers a tile; 164 KB of shared
//      memory at DP = 40. Four rows a thread at two blocks an SM (16 warps,
//      128 registers) measured slower.
//    - mid (DP = D rounded up to 16: 80, 96, 112 or 128; SD1.5's 640-channel
//      level, heads of 80): the narrow design over all of D, S summed in
//      column order in one pass, no column padded at D = 80 (O's columns
//      4 kg + 32 x as float4s, x < DP / 32, then 32 (DP / 32) + 2 kg as a
//      float2 where DP % 32 == 16: 10 columns a thread at 80). A key's V
//      columns are read as those float4s and that float2 (3 loads for 60
//      FMAs at RT = 6). Shared memory: Q, P and two stages of K and V
//      would take 245,760 bytes at DP = 80 and 256 rows, and cost rows a
//      block at every DP, so V has one stage: the barrier that starts tile j (K_j is in, P V of tile j - 1
//      is done) is where V_j and K_{j+1} are requested, V_j lands while
//      S_j is computed and K_{j+1} while the rest of the tile is. Rows a
//      thread: 6 at DP = 80 (192 a block, 183,296 bytes; 8 and 7 fit and
//      took 4.33 and 4.31 ms against 6's 4.19 at (64, 2704, 80), the last
//      wave and the last block of each head partly idle either way;
//      probe_flash_fwd.py --route f32_mid), above the most that fit (RT =
//      7, 6, 5 at DP = 96, 112, 128). 254 registers, no spills. The wide
//      kernel's DP = 128 instance ran
//      these head dims until then (37.5% of its FMAs multiplied padding at
//      D = 80) and stays callable (`flash_attention_fwd_f32_wide`) to
//      compare with it.
//    - wide (DP = 128, 256 or 512): O for 64 rows x 512 columns is 128 f32
//      registers a thread across 256 threads, and Q (132 KB at D = 512) fits
//      beside a two-stage ring of 32 KB chunks but not beside whole K and V
//      tiles. Each 128-key tile's K streams as 64-column chunks (S, 8 rows x
//      4 keys a thread, sums them in column order), then its V as chunks of
//      64 keys x 128 columns (a thread holds 8 rows x 4 columns of every
//      128-column pair). A warp spans 4 rows x 8 keys (or columns), so every
//      load hits 32 distinct banks (K's float4s are permuted by key % 8)
//      and feeds 16 or 32 FMAs; a row's keys span 4 warps, whose partial maxima
//      meet in P's spare columns (one more barrier a tile). One barrier a
//      chunk; 232,448 bytes of shared memory, the most a block may have.
//      64 query rows a block stream a quarter of the L2 bytes of the
//      CUDA-core kernel's 16-row blocks.
// 5. CUDA cores (`flash_fwd_kernel`): what no route above takes: bf16 with
//    D % 8 != 0, f32 with D % 4 != 0, or an unaligned base; head dims up to
//    512. `flash_attention_fwd_cuda_cores` runs it on any input, to compare.
//    f32 FMA with both operands staged in shared memory as f32. Each block
//    owns BQ query rows of one (batch*head); its four warps own BQ/4 rows
//    each, so the row max and
//    row sum are warp shuffles and P never leaves the warp's own slice of
//    shared memory. K and V tiles are re-read from shared memory as float4
//    (rows padded by 4 floats, so the 8 lanes of a 128-bit phase hit 8
//    distinct bank groups). O stays in registers: each lane owns the
//    columns lane, lane + 32, ... of its warp's rows. The head dim picks the
//    tile shape (DP = padded D):
//      DP  64: BQ 64, BK 64  ( 68.6 KB smem, 3 blocks/SM)
//      DP 128: BQ 32, BK 64  ( 92.7 KB)
//      DP 256: BQ 16, BK 32  ( 85.2 KB)
//      DP 512: BQ 16, BK 32  (167.2 KB, 1 block/SM)
//
// TMA: Q, K and V are 3-D tensor maps {D, S, B*H} with boxes of 64 columns
// (128 bytes, 128-byte swizzle), so rows past S inside a head and columns
// past D arrive as zeros (a 2-D (B*H*S, D) map would read the next head's
// rows into a ragged tile). The maps are encoded on the host at every call
// (the pointers change) and pass as __grid_constant__ parameters. The TMA,
// mbarrier and wgmma helpers are in hopper_common.cuh.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

template <int DP, int BQ, int BK>
struct Tile {
  static_assert(DP % 32 == 0 && BQ % kWarps == 0 && BK % 32 == 0, "tile shape");
  static constexpr int RW = BQ / kWarps;  // query rows per warp
  static constexpr int KPL = BK / 32;     // keys per lane in S
  static constexpr int CPL = DP / 32;     // O columns per lane
  static constexpr int LD = DP + 4;       // smem row stride (floats) of Q/K/V
  static constexpr size_t kSmemBytes =
      (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * BK) * sizeof(float);
};

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int d,
                     float scale) {
  using C = Tile<DP, BQ, BK>;
  constexpr int RW = C::RW, KPL = C::KPL, CPL = C::CPL, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;
  const int d4 = (d + 3) / 4 * 4;
  const T* kb = k + size_t(bh) * sk * d;
  const T* vb = v + size_t(bh) * sk * d;

  load_tile<T, DP, LD>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);

  float m[RW], l[RW], acc[RW][CPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    const int kv = min(BK, sk - k0);
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    load_tile<T, DP, LD>(sK, kb + size_t(k0) * d, BK, kv, d);
    load_tile<T, DP, LD>(sV, vb + size_t(k0) * d, BK, kv, d);
    __syncthreads();

    // S = Q K^T for this warp's rows and this lane's keys, in f32
    float s[RW][KPL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 kk[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        kk[j] = *reinterpret_cast<const float4*>(sK + (lane + 32 * j) * LD + c);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(sQ + (row0 + r) * LD + c);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[r][j] = fmaf(qq.x, kk[j].x, s[r][j]);
          s[r][j] = fmaf(qq.y, kk[j].y, s[r][j]);
          s[r][j] = fmaf(qq.z, kk[j].z, s[r][j]);
          s[r][j] = fmaf(qq.w, kk[j].w, s[r][j]);
        }
      }
    }

    // online softmax: mask keys past kv_len, new row max, rescale, P
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[r][j] = (lane + 32 * j < kv) ? s[r][j] * scale : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = (lane + 32 * j < kv) ? expf(s[r][j] - m_new) : 0.f;
        sum += p;  // l sums P in f32; the product takes P in V's dtype
        sP[(row0 + r) * BK + lane + 32 * j] = to_f32(from_f32<T>(p));
      }
      l[r] = l[r] * corr + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] *= corr;
    }
    __syncwarp();

    // O += P V over the whole tile (P and V are zero past kv)
    for (int kk = 0; kk < BK; kk += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < CPL; ++j) vv[t][j] = sV[(kk + t) * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(sP + (row0 + r) * BK + kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          acc[r][j] = fmaf(p.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(p.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(p.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(p.w, vv[3][j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + row0 + r;
    if (row >= sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) orow[c] = from_f32<T>(acc[r][j] / safe_l);
    }
    if (lane == 0) lse[size_t(bh) * sq + row] = m[r] + logf(safe_l);
  }
}

template <typename T, int DP, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int sq, int sk, int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<DP, BQ, BK>::kSmemBytes;
  auto kernel = flash_fwd_kernel<T, DP, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse,
                                           sq, sk, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                     int sq, int sk, int d, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64, 64, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, stream);
  if (d <= 128) return launch<T, 128, 32, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, stream);
  if (d <= 256) return launch<T, 256, 16, 32>(q, k, v, o, lse, bh, sq, sk, d, scale, stream);
  return launch<T, 512, 16, 32>(q, k, v, o, lse, bh, sq, sk, d, scale, stream);
}


// --- f32 kernels: d % 4 == 0, 16-byte aligned (exact f32 FMA, cp.async rings) ---

constexpr int kF32Threads = 256;

// Rows [0, rows) x columns [0, DP) of a row-major (., d) f32 matrix at
// `src` into shared memory at `dst` (row stride LD floats), as 16-byte
// cp.async copies in this thread's current group; rows at or past `valid`
// and columns at or past d arrive as zeros.
template <int DP, int LD>
__device__ __forceinline__ void fetch_rows_f32(float* dst, const float* src, int rows, int valid, int d, int tid) {
  for (int e = tid; e < rows * (DP / 4); e += kF32Threads) {
    const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
    const bool ok = r < valid && c < d;
    cp_async16(dst + r * LD + c, ok ? src + size_t(r) * d + c : src, ok);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float lane_of(const float4& x, int t) {
  return t == 0 ? x.x : t == 1 ? x.y : t == 2 ? x.z : x.w;
}

template <int DP>
struct F32NarrowTile {
  static constexpr int RT = 8;        // query rows a thread: rg + 32 i, i < RT
  static constexpr int BQ = 32 * RT;  // query rows a block
  static constexpr int BK = 64;       // keys a tile; a thread's logits are keys kg + 8 j, j < 8
  static constexpr int CPG = DP / 8;  // O columns a thread: kg + 8 c, c < CPG (no padded column at 40)
  static constexpr int LD = DP + 4;   // row stride (floats) of Q, K and V: 8 keys' float4s hit 32 banks
  static constexpr int LDP = BK + 8;  // row stride of P: a warp's 4 rows x 8 keys hit 32 banks
  static constexpr int kStage = 2 * BK * LD;  // K and V of one tile
  static constexpr int kOffKV = BQ * LD;
  static constexpr int kOffP = kOffKV + 2 * kStage;
  static constexpr size_t kSmemBytes = size_t(kOffP + BQ * LDP) * sizeof(float);
  static_assert(DP % 8 == 0 && DP <= 64, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// D <= 64: one block of 256 threads per (head, 256 query rows); the design
// is in the note at the top of this file.
template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_narrow_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                                int sq, int sk, int d, float scale_log2) {
  using C = F32NarrowTile<DP>;
  constexpr int RT = C::RT, BQ = C::BQ, BK = C::BK, CPG = C::CPG, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) float f32_smem[];
  float* sQ = f32_smem;
  float* sP = f32_smem + C::kOffP;  // P of the tile, [query][key]

  const int tid = threadIdx.x;
  const int rg = tid / 8, kg = tid % 8;  // the 8 lanes of a row group share its rows
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (sk + BK - 1) / BK;
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;
  auto stage = [&](int j) { return f32_smem + C::kOffKV + (j & 1) * C::kStage; };
  auto fetch = [&](int j) {  // tile j's K and V, zeros past sk, as one cp.async group
    float* s = stage(j);
    const int k0 = j * BK;
    fetch_rows_f32<DP, LD>(s, kb + size_t(k0) * d, BK, sk - k0, d, tid);
    fetch_rows_f32<DP, LD>(s + BK * LD, vb + size_t(k0) * d, BK, sk - k0, d, tid);
    cp_async_commit();
  };
  fetch_rows_f32<DP, LD>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d, tid);
  fetch(0);  // Q and the first tile: one group

  const float c = scale_log2;
  float m[RT], l[RT], acc[RT][CPG];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPG; ++cc) acc[i][cc] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in for every thread; tile j - 1's stage and P are consumed
    if (j + 1 < n_tiles) fetch(j + 1);
    const float* sK = stage(j);
    const float* sV = sK + BK * LD;

    // S = Q K^T: RT rows x 8 keys a thread, each float4 of K feeding 4 RT FMAs
    float s[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DP; cc += 4) {
      float4 qq[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qq[i] = lds4(sQ + (rg + 32 * i) * LD + cc);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 kk = lds4(sK + (kg + 8 * jj) * LD + cc);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          s[i][jj] = fmaf(qq[i].x, kk.x, s[i][jj]);
          s[i][jj] = fmaf(qq[i].y, kk.y, s[i][jj]);
          s[i][jj] = fmaf(qq[i].z, kk.z, s[i][jj]);
          s[i][jj] = fmaf(qq[i].w, kk.w, s[i][jj]);
        }
      }
    }

    // online softmax in base 2: the row max over the row group's 8 lanes,
    // then one FFMA and one exp2 a logit; keys past sk masked on the last tile
    const int kv = sk - j * BK;
    if (kv < BK) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (kg + 8 * jj >= kv) s[i][jj] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, s[i][jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float ms = mx * c;  // = max of s * c: rounding is monotone
      const float corr = fast_exp2(m[i] * c - ms);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = fast_exp2(fmaf(s[i][jj], c, -ms));
        sum += p;
        sP[(rg + 32 * i) * LDP + kg + 8 * jj] = p;
      }
      l[i] = l[i] * corr + sum;  // this lane's share of the row sum
#pragma unroll
      for (int cc = 0; cc < CPG; ++cc) acc[i][cc] *= corr;
    }
    __syncthreads();  // P of the tile is in shared memory

    // O += P V: RT rows x CPG columns a thread, in key order (P and V are 0 past sk)
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = lds4(sP + (rg + 32 * i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[CPG];
#pragma unroll
        for (int cc = 0; cc < CPG; ++cc) vv[cc] = sV[(kk + t) * LD + kg + 8 * cc];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pt = lane_of(p[i], t);
#pragma unroll
          for (int cc = 0; cc < CPG; ++cc) acc[i][cc] = fmaf(pt, vv[cc], acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + rg + 32 * i;
    if (row >= sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int cc = 0; cc < CPG; ++cc) {
      const int col = kg + 8 * cc;
      if (col < d) orow[col] = acc[i][cc] / safe_l;
    }
    if (kg == 0) lse[size_t(bh) * sq + row] = (m[i] * c + log2f(safe_l)) * kLn2;
  }
}

template <int DP>
struct F32WideTile {
  static constexpr int BQ = 64;        // query rows a block; a thread's rows are rg + 8 i, i < 8
  static constexpr int BK = 128;       // keys a tile; a thread's logits are keys kg + 32 j, j < 4
  static constexpr int NK = DP / 64;   // K chunks a tile: 128 keys x 64 columns, summed in column order
  static constexpr int NV = DP / 64;   // V chunks a tile: 64 keys x 128 columns (column pairs x key halves)
  static constexpr int NPAIR = DP / 128;  // O's 128-column pairs; a thread holds 8 rows x 4 columns of each
  static constexpr int LDQ = DP + 4;   // row stride (floats) of Q: 4 consecutive rows' float4s hit 16 banks
  static constexpr int LDP = BK + 8;   // row stride of P: a warp's 4 rows x 8 keys hit 32 banks; columns
                                       // 128-131 hold the row's 4 partial maxima (one per warp pair)
  static constexpr int kChunk = 128 * 64;  // floats of a ring stage: a K or a V chunk, unpadded
  static constexpr int kOffRing = BQ * LDQ;
  static constexpr int kOffP = kOffRing + 2 * kChunk;
  static constexpr size_t kSmemBytes = size_t(kOffP + BQ * LDP) * sizeof(float);
  static_assert(DP % 128 == 0 && DP <= 512, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// 64 < D <= 512: one block of 256 threads per (head, 64 query rows); the
// design is in the note at the top of this file.
template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int sq,
                              int sk, int d, float scale_log2) {
  using C = F32WideTile<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NK = C::NK, NV = C::NV, NPAIR = C::NPAIR, LDQ = C::LDQ, LDP = C::LDP;
  extern __shared__ __align__(16) float f32_smem[];
  float* sQ = f32_smem;
  float* ring = f32_smem + C::kOffRing;
  float* sP = f32_smem + C::kOffP;  // P of the tile, [query][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // rows rg + 8 i; keys kg + 32 j in S, columns 128 p + 4 kg in O. A row's
  // 128 keys lie on 8 lanes of each of 4 warps (kh = warp / 2).
  const int kh = warp / 2;
  const int rg = 4 * (warp % 2) + lane / 8, kg = 8 * kh + lane % 8;
  const int sw = lane % 8;  // K rows kg + 32 j are stored with their float4s permuted by key % 8 = sw
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (sk + BK - 1) / BK;
  const int n_chunks = n_tiles * (NK + NV);
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;
  // chunk g into its ring stage as one cp.async group; zeros past sk and d
  auto fetch = [&](int g) {
    float* dst = ring + (g & 1) * C::kChunk;
    const int j = g / (NK + NV), x = g % (NK + NV);
    if (x < NK) {  // K: keys j BK .. + 127, columns 64 x .. + 63, float4 c4 stored at c4 ^ (key % 8)
      const float* src = kb + size_t(j) * BK * d;
      const int valid = sk - j * BK;
      for (int e = tid; e < BK * 16; e += kF32Threads) {
        const int r = e / 16, c4 = e % 16, col = 64 * x + 4 * c4;
        const bool ok = r < valid && col < d;
        cp_async16(dst + r * 64 + 4 * (c4 ^ (r % 8)), ok ? src + size_t(r) * d + col : src, ok);
      }
    } else {  // V: keys j BK + 64 h .. + 63, columns 128 p .. + 127 (y = x - NK = 2 p + h)
      const int y = x - NK, p = y / 2, h = y % 2;
      const float* src = vb + (size_t(j) * BK + 64 * h) * d;
      const int valid = sk - j * BK - 64 * h;
      for (int e = tid; e < 64 * 32; e += kF32Threads) {
        const int r = e / 32, c4 = e % 32, col = 128 * p + 4 * c4;
        const bool ok = r < valid && col < d;
        cp_async16(dst + r * 128 + 4 * c4, ok ? src + size_t(r) * d + col : src, ok);
      }
    }
    cp_async_commit();
  };
  fetch_rows_f32<DP, LDQ>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d, tid);
  fetch(0);  // Q joins the first chunk's group

  const float c = scale_log2;
  float m[8], l[8], acc[NPAIR][8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NPAIR; ++p)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[p][i][cc] = 0.f;
  }
  // the next chunk's wait and barrier, then its successor's copies
  auto next_chunk = [&](int g) {
    cp_async_wait<0>();
    __syncthreads();  // chunk g is in; chunk g - 1's stage is consumed
    if (g + 1 < n_chunks) fetch(g + 1);
    return ring + (g & 1) * C::kChunk;
  };

  int g = 0;  // the chunk being consumed
  for (int j = 0; j < n_tiles; ++j) {
    // S = Q K^T over the chunks of D in column order
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < NK; ++ch, ++g) {
      const float* sK = next_chunk(g);
      const float* qc = sQ + 64 * ch;
#pragma unroll 1
      for (int c4 = 0; c4 < 16; ++c4) {
        float4 kk[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kk[jj] = lds4(sK + (kg + 32 * jj) * 64 + 4 * (c4 ^ sw));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qq = lds4(qc + (rg + 8 * i) * LDQ + 4 * c4);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qq.x, kk[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qq.y, kk[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qq.z, kk[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qq.w, kk[jj].w, s[i][jj]);
          }
        }
      }
    }

    // online softmax in base 2: row maxima over 8 lanes, then over the 4
    // warp pairs through P's spare columns; one FFMA and one exp2 a logit
    const int kv = sk - j * BK;
    if (kv < BK) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (kg + 32 * jj >= kv) s[i][jj] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      if (sw == 0) sP[(rg + 8 * i) * LDP + BK + kh] = mx;
    }
    __syncthreads();  // the partial maxima are in
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 part = lds4(sP + (rg + 8 * i) * LDP + BK);
      const float mx = fmaxf(m[i], fmaxf(fmaxf(part.x, part.y), fmaxf(part.z, part.w)));
      const float ms = mx * c;
      const float corr = fast_exp2(m[i] * c - ms);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = fast_exp2(fmaf(s[i][jj], c, -ms));
        sum += p;
        sP[(rg + 8 * i) * LDP + kg + 32 * jj] = p;
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int p = 0; p < NPAIR; ++p)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[p][i][cc] *= corr;
    }

    // O += P V: column pair by column pair, each over the tile's two key
    // halves in order (the first chunk's barrier publishes P)
#pragma unroll
    for (int p = 0; p < NPAIR; ++p) {
#pragma unroll 1
      for (int h = 0; h < 2; ++h, ++g) {
        const float* sV = next_chunk(g);
        const float* pk = sP + 64 * h;
#pragma unroll 1
        for (int kk = 0; kk < 64; kk += 4) {
          float4 vv[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) vv[t] = lds4(sV + (kk + t) * 128 + 4 * kg);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 pp = lds4(pk + (rg + 8 * i) * LDP + kk);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float pt = lane_of(pp, t);
              acc[p][i][0] = fmaf(pt, vv[t].x, acc[p][i][0]);
              acc[p][i][1] = fmaf(pt, vv[t].y, acc[p][i][1]);
              acc[p][i][2] = fmaf(pt, vv[t].z, acc[p][i][2]);
              acc[p][i][3] = fmaf(pt, vv[t].w, acc[p][i][3]);
            }
          }
        }
      }
    }
  }

  // l: over 8 lanes, then the 4 warp pairs' shares through P's spare
  // columns, in warp-pair order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  __syncthreads();  // the last tile's partial maxima are read
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (sw == 0) sP[(rg + 8 * i) * LDP + BK + kh] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + rg + 8 * i;
    if (row >= sq) continue;
    const float4 part = lds4(sP + (rg + 8 * i) * LDP + BK);
    const float sum = ((part.x + part.y) + part.z) + part.w;
    const float safe_l = sum == 0.f ? 1.f : sum;
    float* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int p = 0; p < NPAIR; ++p) {
      const int col = 128 * p + 4 * kg;  // d % 4 == 0: the float4 is in or out together
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[p][i][0] / safe_l, acc[p][i][1] / safe_l, acc[p][i][2] / safe_l,
                        acc[p][i][3] / safe_l);
    }
    if (kg == 0) lse[size_t(bh) * sq + row] = (m[i] * c + log2f(safe_l)) * kLn2;
  }
}

template <int DP>
struct F32MidTile {
  // query rows a thread (rows rg + 32 i, i < RT): at DP = 80 six (eight and
  // seven fit and measured slower), above the most that fit in shared
  // memory beside two K stages, one V stage and P
  static constexpr int RT = DP <= 80 ? 6 : DP <= 96 ? 7 : DP <= 112 ? 6 : 5;
  static constexpr int BQ = 32 * RT;             // query rows a block
  static constexpr int BK = 64;                  // keys a tile; a thread's logits are keys kg + 8 j, j < 8
  static constexpr int NQUAD = DP / 32;          // O's float4 columns a thread: 4 kg + 32 x, x < NQUAD,
  static constexpr int NPAIR = DP % 32 / 16;     // then a float2 at 32 NQUAD + 2 kg (DP = 80 and 112)
  static constexpr int CPG = 4 * NQUAD + 2 * NPAIR;  // O columns a thread, DP / 8: none padded at 80
  static constexpr int LD = DP + 4;    // row stride (floats) of Q and K: 8 keys' float4s hit 32 banks
  static constexpr int LDP = BK + 8;   // row stride of P: a warp's 4 rows x 8 keys hit 32 banks
  static constexpr int kOffK = BQ * LD;              // two K stages
  static constexpr int kOffV = kOffK + 2 * BK * LD;  // one V stage, rows of DP (a warp reads one row)
  static constexpr int kOffP = kOffV + BK * DP;
  static constexpr size_t kSmemBytes = size_t(kOffP + BQ * LDP) * sizeof(float);
  static_assert(DP % 16 == 0 && DP > 64 && DP <= 128 && 8 * CPG == DP, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// 64 < D <= 128: one block of 256 threads per (head, BQ query rows); the
// design is in the note at the top of this file.
template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_mid_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                             int sq, int sk, int d, float scale_log2) {
  using C = F32MidTile<DP>;
  constexpr int RT = C::RT, BQ = C::BQ, BK = C::BK, NQUAD = C::NQUAD, CPG = C::CPG, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) float f32_smem[];
  float* sQ = f32_smem;
  float* sV = f32_smem + C::kOffV;
  float* sP = f32_smem + C::kOffP;  // P of the tile, [query][key]

  const int tid = threadIdx.x;
  const int rg = tid / 8, kg = tid % 8;  // the 8 lanes of a row group share its rows
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (sk + BK - 1) / BK;
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;
  auto k_stage = [&](int j) { return f32_smem + C::kOffK + (j & 1) * BK * LD; };
  auto fetch_k = [&](int j) {  // tile j's K, zeros past sk, as one cp.async group (empty past the last tile)
    if (j < n_tiles) fetch_rows_f32<DP, LD>(k_stage(j), kb + size_t(j) * BK * d, BK, sk - j * BK, d, tid);
    cp_async_commit();
  };
  fetch_rows_f32<DP, LD>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d, tid);
  fetch_k(0);  // Q and the first K tile: one group

  const float c = scale_log2;
  float m[RT], l[RT], acc[RT][CPG];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPG; ++cc) acc[i][cc] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // K of tile j is in for every thread; P V of tile j - 1 is done, so V's stage and P are free
    fetch_rows_f32<DP, DP>(sV, vb + size_t(j) * BK * d, BK, sk - j * BK, d, tid);
    cp_async_commit();  // V of tile j lands while S is computed
    fetch_k(j + 1);     // into the stage that S of tile j - 1 read
    const float* sK = k_stage(j);

    // S = Q K^T over all of D in column order: RT rows x 8 keys a thread,
    // each float4 of K feeding 4 RT FMAs
    float s[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DP; cc += 4) {
      float4 qq[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qq[i] = lds4(sQ + (rg + 32 * i) * LD + cc);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 kk = lds4(sK + (kg + 8 * jj) * LD + cc);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          s[i][jj] = fmaf(qq[i].x, kk.x, s[i][jj]);
          s[i][jj] = fmaf(qq[i].y, kk.y, s[i][jj]);
          s[i][jj] = fmaf(qq[i].z, kk.z, s[i][jj]);
          s[i][jj] = fmaf(qq[i].w, kk.w, s[i][jj]);
        }
      }
    }

    // online softmax in base 2, as the narrow kernel's
    const int kv = sk - j * BK;
    if (kv < BK) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (kg + 8 * jj >= kv) s[i][jj] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, s[i][jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float ms = mx * c;  // = max of s * c: rounding is monotone
      const float corr = fast_exp2(m[i] * c - ms);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = fast_exp2(fmaf(s[i][jj], c, -ms));
        sum += p;
        sP[(rg + 32 * i) * LDP + kg + 8 * jj] = p;
      }
      l[i] = l[i] * corr + sum;  // this lane's share of the row sum
#pragma unroll
      for (int cc = 0; cc < CPG; ++cc) acc[i][cc] *= corr;
    }
    cp_async_wait<1>();  // V of tile j is in (K of tile j + 1 may still be in flight)
    __syncthreads();     // P and V of the tile are in for every thread

    // O += P V: RT rows x CPG columns a thread, in key order (P and V are 0
    // past sk); a key's V columns come as NQUAD float4s and a float2
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = lds4(sP + (rg + 32 * i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = sV + (kk + t) * DP;
        float vv[CPG];
#pragma unroll
        for (int x = 0; x < NQUAD; ++x) {
          const float4 w = lds4(vrow + 4 * kg + 32 * x);
          vv[4 * x] = w.x, vv[4 * x + 1] = w.y, vv[4 * x + 2] = w.z, vv[4 * x + 3] = w.w;
        }
        if constexpr (C::NPAIR > 0) {
          const float2 w = *reinterpret_cast<const float2*>(vrow + 32 * NQUAD + 2 * kg);
          vv[4 * NQUAD] = w.x, vv[4 * NQUAD + 1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pt = lane_of(p[i], t);
#pragma unroll
          for (int cc = 0; cc < CPG; ++cc) acc[i][cc] = fmaf(pt, vv[cc], acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + rg + 32 * i;
    if (row >= sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int x = 0; x < NQUAD; ++x) {
      const int col = 4 * kg + 32 * x;  // d % 4 == 0: the float4 is in or out together
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) = make_float4(acc[i][4 * x] / safe_l, acc[i][4 * x + 1] / safe_l,
                                                             acc[i][4 * x + 2] / safe_l, acc[i][4 * x + 3] / safe_l);
    }
    if constexpr (C::NPAIR > 0) {
      const int col = 32 * NQUAD + 2 * kg;
      if (col < d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[i][4 * NQUAD] / safe_l, acc[i][4 * NQUAD + 1] / safe_l);
    }
    if (kg == 0) lse[size_t(bh) * sq + row] = (m[i] * c + log2f(safe_l)) * kLn2;
  }
}

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, size_t smem, int bq, unsigned& devices_set, const void* q, const void* k,
                       const void* v, void* o, float* lse, int bh, int sq, int sk, int d, float scale,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem_once(kernel, smem, devices_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sq + bq - 1) / bq, bh), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_narrow(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                              int sk, int d, float scale, cudaStream_t stream) {
  using C = F32NarrowTile<DP>;
  static unsigned devices_set = 0;
  return launch_f32(flash_fwd_f32_narrow_kernel<DP>, C::kSmemBytes, C::BQ, devices_set, q, k, v, o, lse, bh, sq,
                    sk, d, scale, stream);
}

template <int DP>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                            int sk, int d, float scale, cudaStream_t stream) {
  using C = F32WideTile<DP>;
  static unsigned devices_set = 0;
  return launch_f32(flash_fwd_f32_wide_kernel<DP>, C::kSmemBytes, C::BQ, devices_set, q, k, v, o, lse, bh, sq,
                    sk, d, scale, stream);
}

template <int DP>
cudaError_t launch_f32_mid(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                           int sk, int d, float scale, cudaStream_t stream) {
  using C = F32MidTile<DP>;
  static unsigned devices_set = 0;
  return launch_f32(flash_fwd_f32_mid_kernel<DP>, C::kSmemBytes, C::BQ, devices_set, q, k, v, o, lse, bh, sq,
                    sk, d, scale, stream);
}

// the wide f32 kernel at its DP (128 for 64 < d <= 128, which route f32_mid
// takes; 256; 512)
cudaError_t launch_f32_wide_dp(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                               int sk, int d, float scale, cudaStream_t s) {
  if (d <= 128) return launch_f32_wide<128>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 256) return launch_f32_wide<256>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  return launch_f32_wide<512>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}

// routes f32 (the narrow kernel at d <= 64, the wide one above 128) and
// f32_mid (64 < d <= 128)
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int sk,
                         int d, float scale, cudaStream_t s) {
  if (d <= 16) return launch_f32_narrow<16>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 32) return launch_f32_narrow<32>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 40) return launch_f32_narrow<40>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 48) return launch_f32_narrow<48>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 64) return launch_f32_narrow<64>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 80) return launch_f32_mid<80>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 96) return launch_f32_mid<96>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 112) return launch_f32_mid<112>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 128) return launch_f32_mid<128>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  return launch_f32_wide_dp(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}


// --- tensor-core kernels: bf16, D % 8 == 0 (TMA, wgmma, warp-specialised) ----

template <int DP, bool kWide>
struct TmaTile {
  // route tma_mid: design 1 (all of D a consumer) over two 64-column boxes
  static constexpr bool kMid = !kWide && DP > 64;
  // consumer warpgroups; warpgroup 0 produces
  static constexpr int kConsumers = kWide ? 2 : kMid ? 3 : 4;
  static constexpr int kThreadsTotal = 128 * (1 + kConsumers);
  static constexpr int BQ = kWide ? 64 : 64 * kConsumers;  // query rows per block
  static constexpr int BK = kWide ? 32 : 64;               // keys per shared-memory tile
  static constexpr int kStages = kWide ? 2 : 3;            // K and V tiles in flight
  // Registers a thread. At launch every thread has kLaunchRegs (ptxas
  // gives a kernel that uses setmaxnreg all that its launch bounds allow);
  // then the producer drops to kProducerRegs and the consumers take what it
  // freed, out of the block's own allocation.
  static constexpr int kLaunchRegs = 65536 / kThreadsTotal / 8 * 8;
  static constexpr int kProducerRegs = kConsumers > 2 ? 24 : 40;
  static constexpr int kSpareRegs =
      (kLaunchRegs * kThreadsTotal - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
  static constexpr int kConsumerRegs = kSpareRegs > 240 ? 240 : kSpareRegs;
  static constexpr int kChunks = (DP + 63) / 64;  // 64-column boxes per row
  // 16-deep k-steps of one consumer's S: all of D, or its share of the chunks
  static constexpr int kQkSteps = kWide ? kChunks / kConsumers * 4 : (DP + 15) / 16;
  static constexpr int kPvN = kWide ? DP / kConsumers : DP;  // O columns per consumer
  static constexpr int kSRegs = BK / 2;           // f32 registers of S per thread
  static constexpr int kORegs = kPvN / 2;         // f32 registers of O per thread
  static constexpr uint32_t kQBytes = kChunks * BQ * 128;
  static constexpr uint32_t kKvBytes = kChunks * BK * 128;  // one stage of K (or of V)
  // wide: the consumers' partial S, two tiles' worth (by parity)
  static constexpr uint32_t kXBytes = kWide ? 2 * kConsumers * kSRegs * 128 * 4 : 0;
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kKvBytes;
  static constexpr uint32_t kOffX = kOffV + kStages * kKvBytes;
  static constexpr uint32_t kOffBar = kOffX + kXBytes;
  static constexpr uint32_t kBars = 1 + 4 * kStages;  // Q full; K and V full and empty per stage
  static constexpr size_t kSmemBytes = kOffBar + kBars * 8 + 1024;  // + slack to align to 1024
  static_assert(kWide ? (DP % (64 * kConsumers) == 0 && DP <= 512)
                      : kMid ? (DP % 16 == 0 && DP <= 128) : (DP % 8 == 0 && DP <= 64),
                "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// S = Q K^T for one key tile over this consumer's k-steps; K-major both.
// `q` and `k` describe the first k-step; the others are fixed byte offsets.
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[C::kSRegs], uint64_t q, uint64_t k) {
#pragma unroll
  for (int ks = 0; ks < C::kQkSteps; ++ks) {
    const uint32_t col_bytes = (ks % 4) * 32, chunk = ks / 4;
    Wgmma<C::BK>::ss(s, wgmma_desc_advance(q, chunk * C::BQ * 128 + col_bytes),
                     wgmma_desc_advance(k, chunk * C::BK * 128 + col_bytes), ks > 0);
  }
}

// O += P V for one key tile; P in registers, V (described by `v`) MN-major.
// Route tma_mid: V's columns 0-63 and 64..DP-1 lie in two boxes, one wgmma
// each (N = 64, then DP - 64) into O's first 32 registers and the rest,
// which hold columns 64.. as one m64nDP accumulator would.
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::kORegs], const uint32_t (&p)[C::BK / 16][4],
                                         uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint64_t vk = wgmma_desc_advance(v, kk * 16 * 128);
    if constexpr (C::kMid) {
      Wgmma<64>::rs(*reinterpret_cast<float(*)[32]>(o), p[kk], vk, 1);
      Wgmma<C::kPvN - 64>::rs(*reinterpret_cast<float(*)[C::kORegs - 32]>(o + 32), p[kk],
                              wgmma_desc_advance(vk, C::BK * 128), 1);
    } else {
      Wgmma<C::kPvN>::rs(o, p[kk], vk, 1);
    }
  }
}

// Online softmax over one tile of raw logits in `s` (this thread's rows g
// and g + 8, base 2): masks keys at or past `kv` (only when kv < 2 * NR),
// folds the new row max into m, turns s into P = exp2(s * c - m * c) in
// place, and gives each row's correction for O. l holds this thread's share
// of each row's sum (the quad's four shares are added at the end).
template <int NR>
__device__ __forceinline__ void online_softmax(float (&s)[NR], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float c, int kv, int t) {
  if (kv < 2 * NR) {
#pragma unroll
    for (int i = 0; i < NR / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * i + 2 * t + (e & 1) >= kv) s[4 * i + e] = kNegInf;
  }
  // four running maxima per row, combined at the end: a short dependency chain
  float part[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) part[e / 2][e % 2] = s[e], part[e / 2][2 + e % 2] = s[4 + e];
#pragma unroll
  for (int i = 2; i < NR / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[e / 2][(i % 2) * 2 + e % 2] = fmaxf(part[e / 2][(i % 2) * 2 + e % 2], s[4 * i + e]);
  float mx[2], ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(m[r], fmaxf(part[r][0], part[r][1])), fmaxf(part[r][2], part[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] * c;  // = max of s * c: rounding is monotone
    corr[r] = fast_exp2(m[r] * c - ms[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NR / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[4 * i + e], c, -ms[e / 2]);  // one FFMA: scale and shift
      s[4 * i + e] = fast_exp2(x);
      sum[e / 2] += s[4 * i + e];  // l sums P in f32; the product takes it in bf16
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// O's rows scaled by their corrections (rows g and g + 8 of the accumulator)
template <int NR>
__device__ __forceinline__ void rescale_o(float (&o)[NR], const float (&corr)[2]) {
  // A wide O (64 or 128 registers): once the row maxima settle most tiles
  // correct by exactly 1, and where the whole warp's are 1 the multiplies
  // change nothing. (At D <= 64 the vote costs more than the multiplies.)
  if (NR > 32 && !__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < NR / 4; ++i) {
    o[4 * i] *= corr[0];
    o[4 * i + 1] *= corr[0];
    o[4 * i + 2] *= corr[1];
    o[4 * i + 3] *= corr[1];
  }
}

// Wide heads: adds the other consumer's partial S (same thread, same
// registers) to this one's through shared memory, so both hold the full S.
// Buffers alternate with the tile's parity: a consumer rewrites one only
// after the barrier of the next tile, which the other passes only after
// reading it. mine + other == other + mine bit for bit.
template <int NR>
__device__ __forceinline__ void exchange_partial_s(float (&s)[NR], float* x, int tile, int w, int tid) {
  float* mine = x + ((tile & 1) * 2 + w) * NR * 128;
  const float* other = x + ((tile & 1) * 2 + 1 - w) * NR * 128;
#pragma unroll
  for (int i = 0; i < NR; ++i) mine[i * 128 + tid] = s[i];
  named_barrier_sync(1, 256);  // the two consumers of a wide block
#pragma unroll
  for (int i = 0; i < NR; ++i) s[i] += other[i * 128 + tid];
}

template <int DP, bool kWide>
__global__ void __launch_bounds__(TmaTile<DP, kWide>::kThreadsTotal, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  using C = TmaTile<DP, kWide>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::kStages;
  extern __shared__ unsigned char tma_smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = tma_smem_raw + ((1024 - (smem_u32(tma_smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::kOffK;
  unsigned char* sV = smem + C::kOffV;
  float* sX = reinterpret_cast<float*>(smem + C::kOffX);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + NS;
  uint64_t* v_full = k_empty + NS;
  uint64_t* v_empty = v_full + NS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (sk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, 128 * C::kConsumers);
      mbar_init(v_empty + st, 128 * C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread streams Q and the K tiles, one in the next warp
    // the V tiles, each as fast as its ring frees up; the warpgroup's
    // registers go to the consumers
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) tma_load_3d(sQ + c * BQ * 128, &tm_q, q_full, c * 64, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(k_empty + st, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + st, C::kKvBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_3d(sK + st * C::kKvBytes + c * BK * 128, &tm_k, k_full + st, c * 64, j * BK, bh);
      }
    } else if (threadIdx.x == 32) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(v_empty + st, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(v_full + st, C::kKvBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_3d(sV + st * C::kKvBytes + c * BK * 128, &tm_v, v_full + st, c * 64, j * BK, bh);
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;  // consumer warpgroup
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    // narrow and mid: this consumer's 64 rows of Q; wide: its half of D, in Q, K and V
    const int chunk0 = kWide ? w * C::kChunks / C::kConsumers : 0;
    const uint64_t q_desc = wgmma_desc(sQ + (kWide ? chunk0 * BQ * 128 : w * 64 * 128), 16, 1024);
    const uint64_t k_desc = wgmma_desc(sK + chunk0 * BK * 128, 16, 1024);  // stage 0
    const uint64_t v_desc = wgmma_desc(sV + chunk0 * BK * 128, BK * 128, 1024);
    const float c = scale_log2;

    float s[C::kSRegs];
    uint32_t p[C::kSRegs / 8][4];
    float acc[C::kORegs];
#pragma unroll
    for (int i = 0; i < C::kORegs; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

    auto k_tile = [&](int j) { return wgmma_desc_advance(k_desc, (j % NS) * C::kKvBytes); };
    auto v_tile = [&](int j) { return wgmma_desc_advance(v_desc, (j % NS) * C::kKvBytes); };
    auto softmax = [&](int j) {
      if constexpr (kWide) exchange_partial_s(s, sX, j, w, tid);
      online_softmax(s, m, l, corr, c, j == n_tiles - 1 ? sk - j * BK : BK, t);
    };

    mbar_wait(q_full, 0);
    // tile 0: S, softmax, P
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<C>(s, q_desc, k_desc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty);
    softmax(0);
    pack_p(p, s);
    if (n_tiles > 1) mbar_wait(k_full + 1 % NS, (1 / NS) & 1);

    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % NS, pst = (j - 1) % NS;
      // K_j has landed (waited for at the end of the last tile). S_j and
      // PV_{j-1} go to the tensor cores back to back; O's correction for
      // tile j-1 runs under S_j.
      mbar_wait(v_full + pst, ((j - 1) / NS) & 1);
      wgmma_fence();
      issue_qk<C>(s, q_desc, k_tile(j));
      wgmma_commit();
      rescale_o(acc, corr);
      wgmma_fence();
      issue_pv<C>(acc, p, v_tile(j - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done
      fence_regs(s);
      mbar_arrive(k_empty + st);
      softmax(j);
      // The softmax must run under PV_{j-1}. ptxas hoists a wgmma wait to
      // the top of its basic block, above register-only work; the wait for
      // the next K tile (a loop) ends the block, so the wait for PV_{j-1}
      // stays below the softmax.
      fence_regs(s);
      fence_regs(m);
      fence_regs(l);
      fence_regs(corr);
      if (j + 1 < n_tiles) mbar_wait(k_full + (j + 1) % NS, ((j + 1) / NS) & 1);
      wgmma_wait<0>();  // PV_{j-1} is done
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(v_empty + pst);
      pack_p(p, s);
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full + last % NS, (last / NS) & 1);
    rescale_o(acc, corr);
    wgmma_fence();
    issue_pv<C>(acc, p, v_tile(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    mbar_arrive(v_empty + last % NS);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int col0 = kWide ? w * C::kPvN : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (kWide ? 0 : w * 64) + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float safe_l = l[r] == 0.f ? 1.f : l[r];
      __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
      for (int i = 0; i < C::kPvN / 8; ++i) {
        const int col = col0 + 8 * i + 2 * t;  // d % 8 == 0: the pair is in or out together
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] / safe_l, acc[4 * i + 2 * r + 1] / safe_l);
      }
      if (t == 0 && (!kWide || w == 0))
        lse[size_t(bh) * sq + row] = (m[r] * c + log2f(safe_l)) * kLn2;
    }
  }
}

template <int DP, bool kWide>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int sq, int sk, int d, float scale, cudaStream_t stream) {
  using C = TmaTile<DP, kWide>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bf16_3d(&tm_q, q, bh, sq, d, C::BQ) || !encode_bf16_3d(&tm_k, k, bh, sk, d, C::BK) ||
      !encode_bf16_3d(&tm_v, v, bh, sk, d, C::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tma_kernel<DP, kWide>;
  static unsigned devices_set = 0;
  cudaError_t err = allow_smem_once(kernel, C::kSmemBytes, devices_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::kThreadsTotal, C::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

// The forward's routes, as ops/flash_attention.py's `forward_route` names
// them; chosen from the dtype, the head dim and the bases' alignment.
enum FwdRoute {
  kRouteCudaCores = 0, kRouteTmaNarrow = 1, kRouteTmaWide = 2, kRouteF32 = 3, kRouteTmaMid = 4, kRouteF32Mid = 5
};

int forward_route(const void* q, const void* k, const void* v, const void* o, int d, int dtype) {
  const bool aligned = bases_aligned16({q, k, v, o});
  if (dtype == 1 && aligned && d % 8 == 0) return d <= 64 ? kRouteTmaNarrow : d <= 128 ? kRouteTmaMid : kRouteTmaWide;
  if (dtype == 0 && aligned && d % 4 == 0) return d > 64 && d <= 128 ? kRouteF32Mid : kRouteF32;
  return kRouteCudaCores;
}

bool valid_fwd(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && d >= 1 && d <= 512 && (dtype == 0 || dtype == 1);
}

// the wide bf16 kernel at its DP (128 for 64 < d <= 128, which route
// tma_mid takes; 256; 512)
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int sk,
                        int d, float scale, cudaStream_t s) {
  if (d <= 128) return launch_tma<128, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  if (d <= 256) return launch_tma<256, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
  return launch_tma<512, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}

cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                              int sk, int d, float scale, int dtype, cudaStream_t s) {
  return dtype == 0 ? dispatch<float>(q, k, v, o, lse, bh, sq, sk, d, scale, s)
                    : dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), o (bh, sq, d): contiguous rows, all of one
// dtype (0 = float32, 1 = bfloat16); lse (bh, sq) float32. Launches the
// kernel of the inputs' route on `stream`, writes the route to `*route`
// (FwdRoute) and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int bh, int sq, int sk, int d, float scale,
                                   int dtype, int* route, void* stream) {
  if (!valid_fwd(bh, sq, sk, d, dtype)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = forward_route(q, k, v, o, d, dtype);
  switch (*route) {
    case kRouteF32:
    case kRouteF32Mid:
      return int(dispatch_f32(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    case kRouteTmaNarrow:
      if (d <= 16) return int(launch_tma<16, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      if (d <= 32) return int(launch_tma<32, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      if (d <= 40) return int(launch_tma<40, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      if (d <= 48) return int(launch_tma<48, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      return int(launch_tma<64, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    case kRouteTmaMid:
      if (d <= 80) return int(launch_tma<80, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      if (d <= 96) return int(launch_tma<96, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      if (d <= 112) return int(launch_tma<112, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      return int(launch_tma<128, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    case kRouteTmaWide:
      return int(launch_wide(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    default:
      return int(launch_cuda_cores(q, k, v, o, lse, bh, sq, sk, d, scale, dtype, s));
  }
}

// The CUDA-core kernel (`flash_fwd_kernel`) on any input the entry above
// takes, whatever its route: the kernel the f32 and bf16 routes replaced,
// kept callable to compare against them on the same inputs.
extern "C" int flash_attention_fwd_cuda_cores(const void* q, const void* k, const void* v, void* o, float* lse,
                                              int bh, int sq, int sk, int d, float scale, int dtype,
                                              void* stream) {
  if (!valid_fwd(bh, sq, sk, d, dtype)) return int(cudaErrorInvalidValue);
  return int(launch_cuda_cores(q, k, v, o, lse, bh, sq, sk, d, scale, dtype, static_cast<cudaStream_t>(stream)));
}

// The wide bf16 kernel (`flash_fwd_tma_kernel<DP, true>`) on bf16 with
// d % 8 == 0, 64 < d <= 512 and 16-byte aligned bases, whatever its route:
// at 64 < d <= 128 the kernel route tma_mid replaced (D padded to 128),
// kept callable to compare against it on the same inputs.
extern "C" int flash_attention_fwd_tma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                                            int bh, int sq, int sk, int d, float scale, void* stream) {
  if (!valid_fwd(bh, sq, sk, d, 1) || d <= 64 || !aligned16({q, k, v, o}, d)) return int(cudaErrorInvalidValue);
  return int(launch_wide(q, k, v, o, lse, bh, sq, sk, d, scale, static_cast<cudaStream_t>(stream)));
}

// The wide f32 kernel (`flash_fwd_f32_wide_kernel`) on f32 with d % 4 == 0,
// 64 < d <= 512 and 16-byte aligned bases, whatever its route: at
// 64 < d <= 128 the kernel route f32_mid replaced (D padded to 128), kept
// callable to compare against it on the same inputs.
extern "C" int flash_attention_fwd_f32_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                                            int bh, int sq, int sk, int d, float scale, void* stream) {
  if (!valid_fwd(bh, sq, sk, d, 0) || d <= 64 || d % 4 != 0 || !bases_aligned16({q, k, v, o}))
    return int(cudaErrorInvalidValue);
  return int(launch_f32_wide_dp(q, k, v, o, lse, bh, sq, sk, d, scale, static_cast<cudaStream_t>(stream)));
}
