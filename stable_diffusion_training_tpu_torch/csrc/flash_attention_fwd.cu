// Flash-attention forward for Hopper (sm_90a), f32 and bf16 I/O.
//
// Replaces the TPU kernel `_fwd_kernel` in
// stable_diffusion_training_tpu/ops/flash_attention.py (launched by
// `_flash_fwd_impl`): blockwise online-softmax attention over heads folded to
// (B*H, S, D), f32 logits and accumulator, P cast to V's dtype before the PV
// product, keys past kv_len masked, the `l == 0` guard, and the per-row
// logsumexp written beside O.
//
// What bounds it on this card. At the serving path's shapes it is compute:
// the UNet's 64x64 latent self-attention, (16, 4096, 40), is 4*16*4096^2*40
// ~ 43 GFLOP and 268 M exps per launch against 16*4096*40*2 B * 4 ~ 21 MB
// of traffic; the VAE mid-block, (1, 4096, 512), is ~ 34 GFLOP and 17 M exps
// against ~ 17 MB. Both sit far above the card's ~295 FLOP/byte ridge, so
// the bound is the product rate, and at D = 40 the exp (MUFU) rate is a
// large share of it (0.064 ms of exps against 0.043 ms of bf16 products).
//
// What the design does about that. Three kernels share the entry point; the
// input picks one.
//
// 1. Tensor cores, narrow heads (`flash_fwd_mma_kernel`): bf16 with
//    D % 8 == 0 and D <= 64, the UNet's 64x64 latent self-attention.
//    mma.sync m16n8k16 (bf16 in, f32 accumulate) for both products,
//    FlashAttention-2 style: each of four warps owns 16 query rows, keeps its
//    Q fragments and its O accumulator in registers, and turns the S
//    accumulator straight into the bf16 A fragment of the PV product, so P
//    never touches shared memory. D is zero-padded to a multiple of 16 in
//    shared memory (40 -> 48), which changes neither product. The softmax
//    runs in base 2 (exp2 of logits pre-scaled by log2 e), one MUFU op per
//    logit. K and V tiles are staged row-major, rows padded by 8 bf16 so
//    that fragment loads hit distinct banks: a K fragment is one 32-bit
//    shared load, a V fragment comes transposed from ldmatrix.trans. Key
//    tiles are double-buffered with cp.async, so tile i + 1 streams in
//    while tile i is multiplied. wgmma, TMA and a warp-specialised pipeline
//    are later work.
// 2. Tensor cores, wide heads (`flash_fwd_mma_wide_kernel`): bf16 with
//    D % 8 == 0 and 64 < D <= 512, the VAE's single-head mid-block. One
//    warp's 16 rows of O at D = 512 would take 256 f32 registers a thread,
//    so the four warps of a block share one 16-row query tile and split D:
//    partial S tiles are summed through shared memory in a fixed order
//    (every warp then holds the same S, m and l) and each warp multiplies P
//    by its own quarter of V. Same staging as (1), 16-key tiles: 88 KB of
//    shared memory at D = 512, 2 blocks/SM; the VAE call has 4096/16 = 256
//    blocks for 132 SMs, and each streams all of K and V, so L2-to-SM
//    traffic (16 query rows per 8 MB of K and V) bounds it before the
//    tensor cores do.
// 3. CUDA cores (`flash_fwd_kernel`): everything else — f32 I/O (exact f32
//    products; TF32 would change the numerics), bf16 with D % 8 != 0 —
//    for head dims up to 512. f32 FMA with both operands staged in shared
//    memory as f32. Each block owns BQ query rows of one (batch*head); its
//    four warps own BQ/4 rows each, so the row max and row sum are warp
//    shuffles and P never leaves the warp's own slice of shared memory. K
//    and V tiles are re-read from shared memory as float4 (rows padded by 4
//    floats, so the 8 lanes of a 128-bit phase hit 8 distinct bank groups).
//    O stays in registers: each lane owns the columns lane, lane + 32, ...
//    of its warp's rows. The head dim picks the tile shape (DP = padded D):
//      DP  64: BQ 64, BK 64  ( 68.6 KB smem, 3 blocks/SM)
//      DP 128: BQ 32, BK 64  ( 92.7 KB)
//      DP 256: BQ 16, BK 32  ( 85.2 KB)
//      DP 512: BQ 16, BK 32  (167.2 KB, 1 block/SM)
#include "flash_common.cuh"

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


// --- tensor-core paths: bf16, D % 8 == 0 -------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  constexpr int BQ = 16 * kWarps, BK = 64;
  constexpr int LDQ = DP + 8;  // bf16 per smem row of Q, K and V
  constexpr int KS = DP / 16;  // k-steps of QK^T over D
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int OT = DP / 8;   // 8-wide column tiles of O
  static_assert(OT % 2 == 0, "V fragments are loaded two column tiles at a time");
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDQ];
  // two stages: key tile i + 1 lands while tile i is in use
  __shared__ __align__(16) __nv_bfloat16 sK[2][BK * LDQ];
  __shared__ __align__(16) __nv_bfloat16 sV[2][BK * LDQ];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const __nv_bfloat16* kb = k + size_t(bh) * sk * d;
  const __nv_bfloat16* vb = v + size_t(bh) * sk * d;

  const int n_tiles = (sk + BK - 1) / BK;
  load_tile_async<DP, LDQ>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);
  load_tile_async<DP, LDQ>(sK[0], kb, BK, min(BK, sk), d);
  load_tile_async<DP, LDQ>(sV[0], vb, BK, min(BK, sk), d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KS][4];
  const __nv_bfloat16* qrow = sQ + (warp * 16 + g) * LDQ + 2 * t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = ld32(qrow + ks * 16);
    qa[ks][1] = ld32(qrow + 8 * LDQ + ks * 16);
    qa[ks][2] = ld32(qrow + ks * 16 + 8);
    qa[ks][3] = ld32(qrow + 8 * LDQ + ks * 16 + 8);
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int kv = min(BK, sk - k0);
    const __nv_bfloat16* sKt = sK[it & 1];
    const __nv_bfloat16* sVt = sV[it & 1];
    if (it > 0) {  // tile `it` has landed, and every warp is done with tile it - 1
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the stage tile it - 1 used
      const int k1 = k0 + BK;
      load_tile_async<DP, LDQ>(sK[(it + 1) & 1], kb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      load_tile_async<DP, LDQ>(sV[(it + 1) & 1], vb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      cp_async_commit();
    }

    // S = Q K^T; s[j] holds rows (g, g, g+8, g+8) x keys (8j+2t, 8j+2t+1)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sKt + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_16816(s[j], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    // online softmax in base 2; the 4 lanes of a quad share a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j * 8 + 2 * t + (e & 1) < kv;
        s[j][e] = valid ? s[j][e] * scale_log2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j * 8 + 2 * t + (e & 1) < kv;
        s[j][e] = valid ? exp2f(s[j][e] - m[e / 2]) : 0.f;
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];  // l sums P in f32
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, with P rounded to bf16 (V's dtype) as the A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans<LDQ>(b, sVt + kk * 16 * LDQ + j * 8, lane);
        mma_16816(acc[j], pa, b[0], b[1]);
        mma_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t;  // d % 8 == 0: the pair is in or out together
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[j][2 * r] / safe_l, acc[j][2 * r + 1] / safe_l);
    }
    if (t == 0) lse[size_t(bh) * sq + row] = (m[r] + log2f(safe_l)) * kLn2;
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int sq, int sk, int d, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * kWarps;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_mma_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, sk, d,
      scale * kLog2e);
  return cudaGetLastError();
}


// --- tensor-core path for wide heads: bf16, D % 8 == 0, 64 < D <= 512 -------
//
// A 16-row query tile per block; its four warps split D, each owning DW =
// DP/4 columns of Q, K, V and O (the VAE's D = 512 would need 256 f32
// accumulator registers per thread in one warp). Each warp computes S over
// its slice of D; the four partial S tiles are summed through shared memory
// in a fixed order, so every warp holds the same S, m and l, and each warp
// then multiplies P by its slice of V.

template <int DP>
struct WideTile {
  static constexpr int BQ = 16, BK = 16;
  static constexpr int DW = DP / kWarps;  // D columns per warp
  static constexpr int LDQ = DP + 8;      // bf16 per smem row of Q, K and V
  static constexpr int LDS = BK + 8;      // f32 per smem row of a partial S
  static_assert(DW % 16 == 0, "each warp's slice of D is whole k-steps");
  // Q, two stages of K and V, the partial S tiles
  static constexpr size_t kSmemBytes =
      (size_t(BQ) * LDQ + 4 * size_t(BK) * LDQ) * 2 + size_t(kWarps) * BQ * LDS * 4;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_wide_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  using W = WideTile<DP>;
  constexpr int BQ = W::BQ, BK = W::BK, DW = W::DW, LDQ = W::LDQ, LDS = W::LDS;
  constexpr int KS = DW / 16;  // k-steps of the warp's partial QK^T
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int OT = DW / 8;   // 8-wide column tiles of the warp's O
  static_assert(OT % 2 == 0, "V fragments are loaded two column tiles at a time");
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* sK = sQ + BQ * LDQ;    // [2][BK][LDQ]
  __nv_bfloat16* sV = sK + 2 * BK * LDQ;  // [2][BK][LDQ]
  float* sS = reinterpret_cast<float*>(sV + 2 * BK * LDQ);  // [kWarps][BQ][LDS]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c0 = warp * DW;  // this warp's slice of D
  const __nv_bfloat16* kb = k + size_t(bh) * sk * d;
  const __nv_bfloat16* vb = v + size_t(bh) * sk * d;

  const int n_tiles = (sk + BK - 1) / BK;
  load_tile_async<DP, LDQ>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);
  load_tile_async<DP, LDQ>(sK, kb, BK, min(BK, sk), d);
  load_tile_async<DP, LDQ>(sV, vb, BK, min(BK, sk), d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KS][4];
  const __nv_bfloat16* qrow = sQ + g * LDQ + c0 + 2 * t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = ld32(qrow + ks * 16);
    qa[ks][1] = ld32(qrow + 8 * LDQ + ks * 16);
    qa[ks][2] = ld32(qrow + ks * 16 + 8);
    qa[ks][3] = ld32(qrow + 8 * LDQ + ks * 16 + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int kv = min(BK, sk - k0);
    const __nv_bfloat16* sKt = sK + (it & 1) * BK * LDQ;
    const __nv_bfloat16* sVt = sV + (it & 1) * BK * LDQ;
    if (it > 0) {  // tile `it` has landed, and every warp is done with tile it - 1 and S
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the stage tile it - 1 used
      const int k1 = k0 + BK;
      const size_t stage = ((it + 1) & 1) * BK * LDQ;
      load_tile_async<DP, LDQ>(sK + stage, kb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      load_tile_async<DP, LDQ>(sV + stage, vb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      cp_async_commit();
    }

    // this warp's partial S over its slice of D, to shared memory
    float s[NT][4];
    float* mine = sS + warp * BQ * LDS;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sKt + (j * 8 + g) * LDQ + c0 + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_16816(s[j], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(g + 8 * (e / 2)) * LDS + j * 8 + 2 * t + (e & 1)] = s[j][e];
    }
    __syncthreads();

    // the full S, summed over the warps in a fixed order: identical in all
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (g + 8 * (e / 2)) * LDS + j * 8 + 2 * t + (e & 1);
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += sS[w * BQ * LDS + idx];
        const bool valid = j * 8 + 2 * t + (e & 1) < kv;
        s[j][e] = valid ? tot * scale_log2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j * 8 + 2 * t + (e & 1) < kv;
        s[j][e] = valid ? exp2f(s[j][e] - m[e / 2]) : 0.f;
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O[:, slice] += P V[:, slice], P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans<LDQ>(b, sVt + kk * 16 * LDQ + c0 + j * 8, lane);
        mma_16816(acc[j], pa, b[0], b[1]);
        mma_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    if (row >= sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = c0 + j * 8 + 2 * t;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[j][2 * r] / safe_l, acc[j][2 * r + 1] / safe_l);
    }
    if (warp == 0 && t == 0) lse[size_t(bh) * sq + row] = (m[r] + log2f(safe_l)) * kLn2;
  }
}

template <int DP>
cudaError_t launch_mma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                            int bh, int sq, int sk, int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = WideTile<DP>::kSmemBytes;
  auto kernel = flash_fwd_mma_wide_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + WideTile<DP>::BQ - 1) / WideTile<DP>::BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, sk, d,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), o (bh, sq, d): contiguous rows, all of one
// dtype (0 = float32, 1 = bfloat16); lse (bh, sq) float32. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int bh, int sq, int sk, int d, float scale,
                                   int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > 512)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch<float>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    case 1:
      if (aligned16({q, k, v, o}, d)) {
        if (d <= 16) return int(launch_mma<16>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 32) return int(launch_mma<32>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 48) return int(launch_mma<48>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 64) return int(launch_mma<64>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 128) return int(launch_mma_wide<128>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 256) return int(launch_mma_wide<256>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        return int(launch_mma_wide<512>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      }
      return int(dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
