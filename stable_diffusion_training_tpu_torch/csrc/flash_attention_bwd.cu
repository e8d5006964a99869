// Flash-attention backward for Hopper (sm_90a), f32 and bf16 I/O: dQ, dK
// and dV.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3)
// in stable_diffusion_training_tpu/ops/flash_attention.py (launched by
// `_flash_bwd`). Both recompute P = exp(S * scale - lse) from the forward's
// logsumexp, with keys past kv_len masked, and dS = P * (dO V^T - delta),
// where delta = rowsum(dO * O) is computed outside the kernels as on the TPU:
//   K2: dQ = scale * dS K
//   K3: dV = P^T dO, dK = scale * dS^T Q
// P is rounded to dO's dtype before P^T dO and dS to K's/Q's dtype before
// the dQ/dK products; every product accumulates in f32. dQ comes back in Q's
// dtype, dK/dV in K's/V's.
//
// What bounds it on this card. At the train step's shape, (64, 4096, 40) bf16
// (the UNet's 64x64 latent self-attention, batch 8, 8 heads), it is compute:
// five products of 2 * 64 * 4096^2 * 40 flops (S, dO V^T, P^T dO, dS^T Q,
// dS K: 0.43 TFLOP, 0.434 ms at 989 TFLOP/s) and 1.07 G exps (0.257 ms on the
// SFUs), against ~0.1 GB of inputs and outputs. At D = 40 the exps weigh
// nearly as much as the products.
//
// In f32 (the fidelity path: every product exact f32 FMA on the CUDA cores,
// no TF32) the same five products at 67 TFLOP/s bound it: 6.41 ms at
// (64, 4096, 40), 0.80 ms at train_parity's (8, 4096, 40).
//
// The design. Four routes, picked by the caller (ops/flash_attention.py,
// `backward_route`) by dtype, head dim and alignment:
//
// 1. bf16, D % 8 == 0, D <= 64 (`flash_bwd_fused_kernel<DP>`, DP = D rounded
//    up to 16, 40 and 48 kept): one fused kernel, so S, dO V^T and the exps
//    are computed once (the TPU's two kernels compute them twice: 7 products
//    for 5). One block per (head, 128 keys); warpgroup 0 produces
//    (setmaxnreg down to 40), two consumer warpgroups own 64 keys each (up to
//    232). K and V of the block arrive once by TMA; one producer thread
//    streams 128-query tiles of Q and dO by TMA, and one producer warp each
//    tile's lse (times log2 e; +1e30 past sq, which zeroes P there) and
//    delta, through a two-stage mbarrier ring. Per query tile a consumer runs
//      S^T = K Q^T, dP^T = V dO^T   wgmma, both operands K-major (m64n128k16)
//      P^T = exp2(S^T c - lse2)     in registers, keys past sk masked
//      dS^T = P^T (dP^T - delta)    in registers
//      dV += P^T dO, dK += dS^T Q   wgmma, P^T / dS^T the bf16 register A
//                                   operand, dO / Q MN-major (the transpose
//                                   bit), dK and dV in f32 registers to the end
//      dQ_tile = dS K               dS^T written to shared memory as bf16
//                                   (128-byte swizzle, double-buffered by
//                                   tile); after a barrier of both consumers
//                                   each computes dQ for 64 of the tile's
//                                   queries over all 128 keys, wgmma with A
//                                   = dS^T MN-major and B = K MN-major
//    and adds its f32 dQ rows into an f32 (B*H, Sq, D) buffer that the
//    caller zeroed, with one bulk reduce-add (cp.reduce.async.bulk .add.f32)
//    of the rows' contiguous bytes, clipped at sq (the next rows belong to
//    the next head). A second kernel (`flash_bwd_dq_convert_kernel`) writes
//    dQ = bf16(scale * buffer). dK and dV are deterministic; dQ's sum over
//    key blocks lands in an order that changes from run to run. dQ traffic
//    into L2: Sk / 128 * B*H * Sq * D * 4 bytes (1.34 GB at the train
//    shape).
//    Each tile drains a consumer's wgmma queue twice (after S^T/dP^T, and
//    after dV/dK/dQ), and those drains, not the exps or any one product,
//    set the pace. What was tried against it and measured slower on the
//    card: 64-query halves with their own waits (more drains); the next
//    tile's S^T issued before the dQ wait (its accumulators then stay in
//    flight across the loop's back edge and ptxas serialises every
//    wgmma); per-consumer dQ partials with no barrier between the
//    consumers, started half a tile apart (twice the reduce-add bytes).
// 2. bf16, D % 8 == 0, 64 < D <= 128 (`flash_bwd_fused_wide_kernel<DP>`,
//    DP = D rounded up to 16: 80, 96, 112, 128): route 1's design and
//    arithmetic for SD1.5's 640-channel level (8 heads of 80), with three
//    changes that its registers and shared memory force. (a) 64-query
//    tiles: S^T and dP^T take 32 registers each, beside dK and dV's DP
//    (up to 128 at DP = 128), under the 232 that setmaxnreg leaves. (b) D
//    spans two 64-column TMA boxes (zeros past D): S^T and dP^T run DP / 16
//    k-steps over both (5 at D = 80, no product padded to 128); dV and dK
//    run one wgmma for columns 0-63 and one of DP - 64 for the rest, each
//    inside one 128-byte swizzle atom, as route 1's MN-major operands are.
//    (c) dQ = dS K for the 64 queries over the block's 128 keys is split by
//    columns: consumer w computes columns w DP / 2 .. (m64n40k16 at D = 80),
//    its B operand K's columns from w DP / 2, which for consumer 1 is one
//    more TMA box of K loaded at column DP / 2 (K's second chunk at
//    DP = 128). Both consumers stage their columns of the tile's dQ rows,
//    meet at a second barrier, and one thread adds the rows into the f32
//    buffer. Shared memory: Q/dO 2 x 32 KB, K and V 64 KB, K's box 16 KB,
//    dS^T 2 x 16 KB, staging 20 KB at D = 80 (198 KB in all). Numbers as
//    route 1: P and dS rounded to bf16, f32 sums; dQ's adds land in any
//    order. Compute bounds it as it does route 1 (five products, 0.38 ms
//    at (64, 2704, 80), SD1.5's 832x832 level at batch 8); it runs at
//    2.6-2.9x that on the card, a little faster than SDPA's backward
//    (PERF.md).
// 3. f32, D % 4 == 0, D <= 128 (`flash_bwd_f32_fused_kernel<DP>`, DP = D
//    rounded up to 16, 32, 40, 48 or 64, and above 64 to a multiple of 16,
//    80-128): one fused CUDA-core kernel, so
//    S^T, dP^T and the exps are computed once (5 products, not the pair's
//    7), deterministic. One block of 256 threads per (head, 128 keys); K and
//    V of the block stay in shared memory as f32; 64-query tiles of Q, dO,
//    lse and delta stream through a two-stage cp.async ring (16-byte copies,
//    zero-filled past sq), the next tile in flight while this one is
//    computed. Per tile:
//      S^T, dP^T        8 keys x 4 queries a thread in registers, each
//                       float4 of K/V/Q/dO read from shared memory feeding
//                       16 FMAs; P^T = exp2(S^T c - lse2), dS^T = P^T (dP^T -
//                       delta), keys past sk zeroed in the last block; P^T
//                       and dS^T to shared memory as [query][key]
//      dV += P^T dO,    4 keys x D/8 columns a thread (columns cg + 8c: the
//      dK += dS^T Q     D = 40 columns split 8 ways with no padded column),
//                       in registers to the end
//      dQ_tile = dS K   4 queries x D/8 columns a thread over one 64-key
//                       half; the second half hands its sums over through
//                       shared memory and the first writes half + half as
//                       the block's unscaled partial of those rows
//    Two barriers a tile. Each block of keys writes its own slice of an f32
//    scratch (ceil(Sk / 128), B*H, Sq, D); `flash_bwd_f32_dq_sum_kernel`
//    writes dQ = scale * (the slices summed in key-block order), so f32 dQ,
//    like dK and dV, repeats bitwise. The scratch is 2 x 1.34 GB of traffic
//    at (64, 4096, 40), ~0.8 ms at 3.35 TB/s against 6.41 ms of products; a
//    separate dQ kernel would recompute two products (~2.6 ms). With up to
//    254 registers a thread (no spill) one block runs per SM. In the S^T /
//    dP^T phase each float4 load feeds 16 FMAs; the dV/dK and dQ phases
//    read their column operands as scalars (one load per 4 FMAs), and with
//    8 warps an SM the two barriers a tile are not hidden: these hold the
//    kernel at about 2x its bound.
//    Wide heads (64 < D <= 128; SD1.5's 640-channel level, heads of 80, in
//    the f32 step at 832x832 and up): 64 keys a block, since dK and dV of
//    128 keys would be 128 registers a thread at D = 128 and K, V, the ring
//    and P^T/dS^T of 128 keys pass 227 KB from D = 80 on; 64-query tiles
//    (48 at DP = 128, whose 64 would pass it too). S^T and dP^T: 4 keys x 4
//    queries a thread; dK and dV: 4 keys x D/16 columns (cg + 16 c); dQ: 4
//    queries x D/16 columns over all 64 keys, no halves and no hand-over.
//    Shared memory 161 KB at DP = 80 (K, V 42 KB, the ring 85 KB, P^T and
//    dS^T 34 KB), 209 KB at 112, 191 KB at 128. Twice the partials of 128-key
//    blocks: at (64, 2704, 80) 43 of 55.4 MB, 2.38 GB written and read
//    again (1.42 ms at 3.35 TB/s beside the products' 5.59 ms at 67
//    TFLOP/s); 6.91 GB at (64, 4624, 80) (4.13 ms beside 16.3 ms). It runs
//    at ~2.2x the products' bound there, 2.7-2.8x faster than the pair it
//    replaced (PERF.md).
// 4. CUDA cores (`bwd_dq_kernel`, `bwd_dkv_kernel`): everything else (f32
//    with D % 4 != 0 or D > 128, bf16 with D % 8 != 0 or D > 128, unaligned
//    bases). Two kernels following the TPU grid (dQ per query tile over the
//    keys; dK/dV per key tile over the queries),
//    deterministic. f32 FMA with the tiles staged in shared memory as f32,
//    dS (and P) rounded to the input dtype through shared memory, tile
//    shapes picked by the head dim as in the forward's CUDA-core kernel.
//
// TMA: Q, dO, K and V are 3-D tensor maps {D, S, B*H} with boxes of 64
// columns and 128 rows (64 for route 2's Q and dO; 128-byte swizzle), so
// rows past S inside a head and columns past D arrive as zeros. The TMA,
// mbarrier, wgmma and bulk reduce helpers are in hopper_common.cuh.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// --- CUDA-core kernels: f32, and bf16 off the tensor-core path ----------------

template <int DP, int BQ, int BK>
struct DqTile {
  static_assert(DP % 32 == 0 && BQ % kWarps == 0 && BK % 32 == 0, "tile shape");
  static constexpr int RW = BQ / kWarps;  // query rows per warp
  static constexpr int KPL = BK / 32;     // keys per lane in S
  static constexpr int CPL = DP / 32;     // dQ columns per lane
  static constexpr int LD = DP + 4;       // smem row stride (floats)
  // Q, dO, K, V tiles and the warps' dS rows
  static constexpr size_t kSmemBytes =
      (2 * size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * BK) * sizeof(float);
};

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int d,
                  float scale) {
  using C = DqTile<DP, BQ, BK>;
  constexpr int RW = C::RW, KPL = C::KPL, CPL = C::CPL, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;  // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS, rounded to K's dtype

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;
  const int d4 = (d + 3) / 4 * 4;
  const T* kb = k + size_t(bh) * sk * d;
  const T* vb = v + size_t(bh) * sk * d;

  load_tile<T, DP, LD>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);
  load_tile<T, DP, LD>(sO, dout + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);

  float l[RW], dl[RW], acc[RW][CPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + row0 + r;
    l[r] = row < sq ? lse[size_t(bh) * sq + row] : 0.f;
    dl[r] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    const int kv = min(BK, sk - k0);
    __syncthreads();  // the previous tile is consumed (and sQ, sO are loaded)
    load_tile<T, DP, LD>(sK, kb + size_t(k0) * d, BK, kv, d);
    load_tile<T, DP, LD>(sV, vb + size_t(k0) * d, BK, kv, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's rows and this lane's keys
    float s[RW][KPL], dp[RW][KPL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 kk[KPL], vv[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        kk[j] = *reinterpret_cast<const float4*>(sK + (lane + 32 * j) * LD + c);
        vv[j] = *reinterpret_cast<const float4*>(sV + (lane + 32 * j) * LD + c);
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(sQ + (row0 + r) * LD + c);
        const float4 oo = *reinterpret_cast<const float4*>(sO + (row0 + r) * LD + c);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[r][j] = fmaf(qq.x, kk[j].x, s[r][j]);
          s[r][j] = fmaf(qq.y, kk[j].y, s[r][j]);
          s[r][j] = fmaf(qq.z, kk[j].z, s[r][j]);
          s[r][j] = fmaf(qq.w, kk[j].w, s[r][j]);
          dp[r][j] = fmaf(oo.x, vv[j].x, dp[r][j]);
          dp[r][j] = fmaf(oo.y, vv[j].y, dp[r][j]);
          dp[r][j] = fmaf(oo.z, vv[j].z, dp[r][j]);
          dp[r][j] = fmaf(oo.w, vv[j].w, dp[r][j]);
        }
      }
    }

    // P from lse (keys past kv_len masked to 0), dS = P (dP - delta)
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int key = lane + 32 * j;
        const float p = key < kv ? expf(s[r][j] * scale - l[r]) : 0.f;
        sS[(row0 + r) * BK + key] = round_to<T>(p * (dp[r][j] - dl[r]));
      }
    __syncwarp();

    // dQ += dS K over the whole tile (dS is zero past kv)
    for (int kk = 0; kk < BK; kk += 4) {
      float kr[4][CPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < CPL; ++j) kr[t][j] = sK[(kk + t) * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 ds = *reinterpret_cast<const float4*>(sS + (row0 + r) * BK + kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          acc[r][j] = fmaf(ds.x, kr[0][j], acc[r][j]);
          acc[r][j] = fmaf(ds.y, kr[1][j], acc[r][j]);
          acc[r][j] = fmaf(ds.z, kr[2][j], acc[r][j]);
          acc[r][j] = fmaf(ds.w, kr[3][j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + row0 + r;
    if (row >= sq) continue;
    T* out = dq + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) out[c] = from_f32<T>(acc[r][j] * scale);
    }
  }
}

template <int DP, int BKB, int BQ>
struct DkvTile {
  static_assert(DP % 32 == 0 && BKB % kWarps == 0 && BQ % 32 == 0, "tile shape");
  static constexpr int RW = BKB / kWarps;  // key rows per warp
  static constexpr int QPL = BQ / 32;      // queries per lane in S^T
  static constexpr int CPL = DP / 32;      // dK/dV columns per lane
  static constexpr int LD = DP + 4;
  // K, V, Q, dO tiles, the warps' P^T and dS^T rows, lse and delta of a tile
  static constexpr size_t kSmemBytes =
      (2 * size_t(BKB) * LD + 2 * size_t(BQ) * LD + 2 * size_t(BKB) * BQ + 2 * size_t(BQ)) *
      sizeof(float);
};

template <typename T, int DP, int BKB, int BQ>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int sq, int sk, int d, float scale) {
  using C = DkvTile<DP, BKB, BQ>;
  constexpr int RW = C::RW, QPL = C::QPL, CPL = C::CPL, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BKB * LD;
  float* sQ = sV + BKB * LD;
  float* sO = sQ + BQ * LD;  // dO
  float* sP = sO + BQ * LD;  // P^T, rounded to dO's dtype
  float* sS = sP + BKB * BQ;  // dS^T, rounded to Q's dtype
  float* sL = sS + BKB * BQ;  // lse of the query tile
  float* sD = sL + BQ;        // delta of the query tile

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;
  const int d4 = (d + 3) / 4 * 4;
  const T* qb = q + size_t(bh) * sq * d;
  const T* ob = dout + size_t(bh) * sq * d;

  load_tile<T, DP, LD>(sK, k + (size_t(bh) * sk + k0) * d, BKB, sk - k0, d);
  load_tile<T, DP, LD>(sV, v + (size_t(bh) * sk + k0) * d, BKB, sk - k0, d);

  float ak[RW][CPL], av[RW][CPL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) ak[r][j] = av[r][j] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    const int qv = min(BQ, sq - q0);
    __syncthreads();  // the previous tile is consumed (and sK, sV are loaded)
    load_tile<T, DP, LD>(sQ, qb + size_t(q0) * d, BQ, qv, d);
    load_tile<T, DP, LD>(sO, ob + size_t(q0) * d, BQ, qv, d);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      sL[i] = i < qv ? lse[size_t(bh) * sq + q0 + i] : 0.f;
      sD[i] = i < qv ? delta[size_t(bh) * sq + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys and this lane's queries
    float s[RW][QPL], dp[RW][QPL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < QPL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 qq[QPL], oo[QPL];
#pragma unroll
      for (int j = 0; j < QPL; ++j) {
        qq[j] = *reinterpret_cast<const float4*>(sQ + (lane + 32 * j) * LD + c);
        oo[j] = *reinterpret_cast<const float4*>(sO + (lane + 32 * j) * LD + c);
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 kk = *reinterpret_cast<const float4*>(sK + (row0 + r) * LD + c);
        const float4 vv = *reinterpret_cast<const float4*>(sV + (row0 + r) * LD + c);
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
          s[r][j] = fmaf(kk.x, qq[j].x, s[r][j]);
          s[r][j] = fmaf(kk.y, qq[j].y, s[r][j]);
          s[r][j] = fmaf(kk.z, qq[j].z, s[r][j]);
          s[r][j] = fmaf(kk.w, qq[j].w, s[r][j]);
          dp[r][j] = fmaf(vv.x, oo[j].x, dp[r][j]);
          dp[r][j] = fmaf(vv.y, oo[j].y, dp[r][j]);
          dp[r][j] = fmaf(vv.z, oo[j].z, dp[r][j]);
          dp[r][j] = fmaf(vv.w, oo[j].w, dp[r][j]);
        }
      }
    }

    // P^T (queries past sq give 0), dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < QPL; ++j) {
        const int qi = lane + 32 * j;
        const float p = qi < qv ? expf(s[r][j] * scale - sL[qi]) : 0.f;
        sP[(row0 + r) * BQ + qi] = round_to<T>(p);
        sS[(row0 + r) * BQ + qi] = round_to<T>(p * (dp[r][j] - sD[qi]));
      }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q over the whole query tile
    for (int i = 0; i < BQ; i += 4) {
      float orow[4][CPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < CPL; ++j) orow[t][j] = sO[(i + t) * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(sP + (row0 + r) * BQ + i);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          av[r][j] = fmaf(p.x, orow[0][j], av[r][j]);
          av[r][j] = fmaf(p.y, orow[1][j], av[r][j]);
          av[r][j] = fmaf(p.z, orow[2][j], av[r][j]);
          av[r][j] = fmaf(p.w, orow[3][j], av[r][j]);
        }
      }
    }
    for (int i = 0; i < BQ; i += 4) {
      float qrow[4][CPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < CPL; ++j) qrow[t][j] = sQ[(i + t) * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 ds = *reinterpret_cast<const float4*>(sS + (row0 + r) * BQ + i);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          ak[r][j] = fmaf(ds.x, qrow[0][j], ak[r][j]);
          ak[r][j] = fmaf(ds.y, qrow[1][j], ak[r][j]);
          ak[r][j] = fmaf(ds.z, qrow[2][j], ak[r][j]);
          ak[r][j] = fmaf(ds.w, qrow[3][j], ak[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int key = k0 + row0 + r;
    if (key >= sk) continue;
    T* okr = dk + (size_t(bh) * sk + key) * d;
    T* ovr = dv + (size_t(bh) * sk + key) * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        okr[c] = from_f32<T>(ak[r][j] * scale);
        ovr[c] = from_f32<T>(av[r][j]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T, int DP, int BQ, int BK>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                      int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = DqTile<DP, BQ, BK>::kSmemBytes;
  auto kernel = bwd_dq_kernel<T, DP, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk, d, scale);
  return cudaGetLastError();
}

template <typename T, int DP, int BKB, int BQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
                       int sk, int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = DkvTile<DP, BKB, BQ>::kSmemBytes;
  auto kernel = bwd_dkv_kernel<T, DP, BKB, BQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BKB - 1) / BKB, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, d, scale);
  return cudaGetLastError();
}

// tile shapes by padded head dim (smem: dQ 86/109/102/200 KB, dKV
// 68/76/104/202 KB at DP 64/128/256/512)
template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                        int d, float scale, cudaStream_t s) {
  if (d <= 64) return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s);
  if (d <= 128) return launch_dq<T, 128, 32, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s);
  if (d <= 256) return launch_dq<T, 256, 16, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s);
  return launch_dq<T, 512, 16, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s);
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, int bh,
                         int sq, int sk, int d, float scale, cudaStream_t s) {
  if (d <= 64) return launch_dkv<T, 64, 64, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s);
  if (d <= 128) return launch_dkv<T, 128, 32, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s);
  if (d <= 256) return launch_dkv<T, 256, 16, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s);
  return launch_dkv<T, 512, 16, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s);
}

// --- fused tensor-core kernel: bf16, D % 8 == 0, D <= 64 (TMA, wgmma) ---------

constexpr float kLseMasked = 1e30f;  // lse of a query past sq: exp2(s c - lse) = 0

template <int DP>
struct FusedTile {
  // consumer warpgroups, 64 keys each; warpgroup 0 produces
  static constexpr int kConsumers = 2;
  static constexpr int kThreadsTotal = 128 * (1 + kConsumers);
  static constexpr int BK = 64 * kConsumers;  // keys per block
  static constexpr int BQ = 128;              // queries per streamed tile
  static constexpr int kStages = 2;           // Q and dO tiles in flight
  // registers a thread: at launch, then after setmaxnreg (as TmaTile in
  // flash_attention_fwd.cu: the consumers take what the producer frees)
  static constexpr int kLaunchRegs = 65536 / kThreadsTotal / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kSpareRegs =
      (kLaunchRegs * kThreadsTotal - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
  static constexpr int kConsumerRegs = kSpareRegs > 240 ? 240 : kSpareRegs;
  static constexpr int kQkSteps = (DP + 15) / 16;  // 16-deep k-steps of S^T and dP^T over D
  static constexpr int kSRegs = BQ / 2;            // f32 registers of S^T (and of dP^T) a thread
  static constexpr int kGRegs = DP / 2;            // f32 registers of dK, dV, dQ a thread
  static constexpr uint32_t kQBytes = BQ * 128;    // a tile of Q or dO: one box of 64 columns
  static constexpr uint32_t kKBytes = BK * 128;    // the block's K or V
  static constexpr uint32_t kStageBytes = 2 * kQBytes;       // Q, then dO
  static constexpr uint32_t kDsBytes = BQ / 64 * BK * 128;  // dS^T: 64-query chunks of BK rows
  static constexpr uint32_t kStgBytes = BQ * DP * 4;        // a tile's f32 dQ rows, row-major
  static constexpr uint32_t kOffK = kStages * kStageBytes;
  static constexpr uint32_t kOffV = kOffK + kKBytes;
  static constexpr uint32_t kOffDs = kOffV + kKBytes;
  static constexpr uint32_t kOffStg = kOffDs + 2 * kDsBytes;
  static constexpr uint32_t kOffStats = kOffStg + kStgBytes;  // [stage][lse2 | delta][BQ] f32
  static constexpr uint32_t kOffBar = kOffStats + kStages * 2 * BQ * 4;
  static constexpr uint32_t kBars = 1 + 2 * kStages;  // K/V full; Q/dO full and empty per stage
  static constexpr size_t kSmemBytes = kOffBar + kBars * 8 + 1024;  // + slack to align to 1024
  static_assert(DP % 8 == 0 && DP <= 64, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// This thread's dS^T entries (block rows 64w + 16 warp + g and + 8, queries
// 8i + 2t and + 1 of the tile) into the MN-major A of dQ: 64-query chunk
// i / 8, the row's 128 bytes, the 16-byte unit (i % 8) swizzled by the row
// (row % 8 == g), as a TMA box with the 128-byte swizzle would hold it.
template <int BK, int NT>
__device__ __forceinline__ void store_ds(unsigned char* ds, const uint32_t (&da)[NT / 2][4], int row,
                                         int g, int t) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(ds + (i / 8) * BK * 128 + (row + 8 * r) * 128 + (((i % 8) ^ g) << 4) +
                                   4 * t) = da[i / 2][(i % 2) * 2 + r];
}

template <int DP>
__global__ void __launch_bounds__(FusedTile<DP>::kThreadsTotal, 1)
    flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int sq, int sk, int d, float scale) {
  using C = FusedTile<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::kStages;
  extern __shared__ unsigned char fused_smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = fused_smem_raw + ((1024 - (smem_u32(fused_smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;  // stage st: Q at st * kStageBytes, dO kQBytes after it
  unsigned char* sK = smem + C::kOffK;
  unsigned char* sV = smem + C::kOffV;
  unsigned char* sDs = smem + C::kOffDs;
  float* sStg = reinterpret_cast<float*>(smem + C::kOffStg);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int n_tiles = (sq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1 + 32);  // the TMA thread and the stats warp
      mbar_init(empty + st, 128 * C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads K and V once, then streams the Q and dO
    // tiles; the next warp stages each tile's lse (base 2) and delta
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
      tma_load_3d(sK, &tm_k, kv_full, 0, k0, bh);
      tma_load_3d(sV, &tm_v, kv_full, 0, k0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(empty + st, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st, C::kStageBytes);
        tma_load_3d(sQ + st * C::kStageBytes, &tm_q, full + st, 0, j * BQ, bh);
        tma_load_3d(sQ + st * C::kStageBytes + C::kQBytes, &tm_do, full + st, 0, j * BQ, bh);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const float* lb = lse + size_t(bh) * sq;
      const float* db = delta + size_t(bh) * sq;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(empty + st, ((j / NS) & 1) ^ 1);
        float* stats = sStats + st * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int q = j * BQ + i;
          stats[i] = q < sq ? lb[q] * kLog2e : kLseMasked;
          stats[BQ + i] = q < sq ? db[q] : 0.f;
        }
        mbar_arrive(full + st);
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;  // consumer warpgroup: keys 64w.. of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row = 64 * w + 16 * warp + g;  // this thread's first key row in the block
    const float c = scale * kLog2e;
    // descriptors of stage 0 / buffer 0; the others are fixed byte offsets
    const uint64_t k_desc = wgmma_desc(sK + w * 64 * 128, 16, 1024);  // A of S^T, K-major
    const uint64_t v_desc = wgmma_desc(sV + w * 64 * 128, 16, 1024);  // A of dP^T
    const uint64_t q_desc = wgmma_desc(sQ, 16, 1024);                 // B of S^T, K-major
    const uint64_t do_desc = wgmma_desc(sQ + C::kQBytes, 16, 1024);   // B of dP^T
    const uint64_t q_mn = wgmma_desc(sQ, BQ * 128, 1024);                // B of dK, MN-major
    const uint64_t do_mn = wgmma_desc(sQ + C::kQBytes, BQ * 128, 1024);  // B of dV, MN-major
    const uint64_t ds_mn = wgmma_desc(sDs + w * BK * 128, BK * 128, 1024);  // A of dQ: chunk w, MN-major
    const uint64_t k_mn = wgmma_desc(sK, BK * 128, 1024);                   // B of dQ, MN-major
    // keys past sk (the last block) arrive as zeros; their P must be 0, not exp2(-lse2)
    const bool ragged = k0 + BK > sk;
    const bool row_ok[2] = {k0 + row < sk, k0 + row + 8 < sk};
    float* stg = sStg + w * 64 * d;  // this warpgroup's 64 dQ rows

    float s[C::kSRegs], dp[C::kSRegs];
    uint32_t pa[C::kSRegs / 8][4], da[C::kSRegs / 8][4];
    float dk_acc[C::kGRegs], dv_acc[C::kGRegs], dq[C::kGRegs];
#pragma unroll
    for (int i = 0; i < C::kGRegs; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      const uint32_t stage = st * C::kStageBytes;
      const uint32_t buf = (j & 1) * C::kDsBytes;
      mbar_wait(full + st, (j / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kQkSteps; ++ks)
        Wgmma<BQ>::ss(s, wgmma_desc_advance(k_desc, ks * 32), wgmma_desc_advance(q_desc, stage + ks * 32),
                      ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < C::kQkSteps; ++ks)
        Wgmma<BQ>::ss(dp, wgmma_desc_advance(v_desc, ks * 32), wgmma_desc_advance(do_desc, stage + ks * 32),
                      ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done
      fence_regs(s);
      // P^T = exp2(S^T c - lse2) in place, while dP^T runs
      const float* stats = sStats + st * 2 * BQ;
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(stats + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], c, -((e & 1) ? l.y : l.x)));
      }
      if (ragged) {
#pragma unroll
        for (int i = 0; i < C::kSRegs; ++i)
          if (!row_ok[(i % 4) / 2]) s[i] = 0.f;
      }
      wgmma_wait<0>();  // dP^T is done
      fence_regs(dp);
      // dS^T = P^T (dP^T - delta) in place
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(stats + BQ + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x));
      }
      pack_p(pa, s);
      pack_p(da, dp);
      // dS^T to shared memory first: the registers of an in-flight wgmma's
      // A operand may not be read
      store_ds<BK, BQ / 8>(sDs + buf, da, row, g, t);
      fence_proxy_async_smem();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(dv_acc, pa[kk], wgmma_desc_advance(do_mn, stage + kk * 16 * 128), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(dk_acc, da[kk], wgmma_desc_advance(q_mn, stage + kk * 16 * 128), 1);
      wgmma_commit();
      if (tid == 0) bulk_wait_read<0>();  // the last tile's dQ rows have left the staging buffer
      named_barrier_sync(1, 128 * C::kConsumers);  // both consumers' dS^T are in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DP>::template ss<1, 1>(dq, wgmma_desc_advance(ds_mn, buf + kk * 16 * 128),
                                     wgmma_desc_advance(k_mn, kk * 16 * 128), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty + st);
      // this warpgroup's 64 dQ rows (f32, unscaled) row-major, then one
      // bulk reduce-add of the rows inside sq
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          const int col = 8 * i + 2 * t;  // d % 8 == 0: the pair is in or out together
          if (col < d)
            *reinterpret_cast<float2*>(stg + (16 * warp + g + 8 * r) * d + col) =
                make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
        }
      fence_proxy_async_smem();
      named_barrier_sync(2 + w, 128);
      if (tid == 0) {
        const int q0 = j * BQ + 64 * w;
        const int rows = min(64, sq - q0);
        if (rows > 0) bulk_reduce_add_f32(dq_acc + (size_t(bh) * sq + q0) * d, stg, uint32_t(rows) * d * 4);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();

    // dK = scale dS^T Q and dV = P^T dO for this thread's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + row + 8 * r;
      if (key >= sk) continue;
      __nv_bfloat16* okr = dk + (size_t(bh) * sk + key) * d;
      __nv_bfloat16* ovr = dv + (size_t(bh) * sk + key) * d;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * t;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(okr + col) =
              __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * scale, dk_acc[4 * i + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(ovr + col) =
              __floats2bfloat162_rn(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ = bf16(scale * acc), four elements a thread per step (n4 = elements / 4)
__global__ void __launch_bounds__(256)
    flash_bwd_dq_convert_kernel(const float4* __restrict__ acc, __nv_bfloat162* __restrict__ dq, size_t n4,
                                float scale) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4; i += size_t(gridDim.x) * blockDim.x) {
    const float4 a = acc[i];
    dq[2 * i] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    dq[2 * i + 1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  }
}

// the dQ conversion after a fused kernel: dq = bf16(scale * dq_acc), (bh, sq, d)
cudaError_t launch_dq_convert(const float* dq_acc, void* dq, int bh, int sq, int d, float scale,
                              cudaStream_t stream) {
  const size_t n4 = size_t(bh) * sq * d / 4;
  const unsigned blocks = unsigned(n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  flash_bwd_dq_convert_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(dq_acc),
                                                          static_cast<__nv_bfloat162*>(dq), n4, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fused(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                         const float* delta, float* dq_acc, void* dq, void* dk, void* dv, int bh, int sq,
                         int sk, int d, float scale, cudaStream_t stream) {
  using C = FusedTile<DP>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_bf16_3d(&tm_q, q, bh, sq, d, C::BQ) || !encode_bf16_3d(&tm_do, dout, bh, sq, d, C::BQ) ||
      !encode_bf16_3d(&tm_k, k, bh, sk, d, C::BK) || !encode_bf16_3d(&tm_v, v, bh, sk, d, C::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_fused_kernel<DP>;
  static unsigned devices_set = 0;
  cudaError_t err = allow_smem_once(kernel, C::kSmemBytes, devices_set);
  if (err != cudaSuccess) return err;
  using B = __nv_bfloat16;
  const dim3 grid((sk + C::BK - 1) / C::BK, bh);
  kernel<<<grid, C::kThreadsTotal, C::kSmemBytes, stream>>>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq_acc,
                                                            static_cast<B*>(dk), static_cast<B*>(dv), sq, sk,
                                                            d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dq_convert(dq_acc, dq, bh, sq, d, scale, stream);
}

// --- fused tensor-core kernel, wide heads: bf16, D % 8 == 0, 64 < D <= 128 ----

template <int DP>
struct FusedWideTile {
  // consumer warpgroups, 64 keys each; warpgroup 0 produces
  static constexpr int kConsumers = 2;
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreadsTotal = 128 + kConsumerThreads;
  static constexpr int BK = 64 * kConsumers;  // keys per block
  static constexpr int BQ = 64;               // queries per streamed tile
  static constexpr int kStages = 2;           // Q and dO tiles in flight
  static constexpr int kLaunchRegs = 65536 / kThreadsTotal / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kSpareRegs =
      (kLaunchRegs * kThreadsTotal - 128 * kProducerRegs) / kConsumerThreads / 8 * 8;
  static constexpr int kConsumerRegs = kSpareRegs > 240 ? 240 : kSpareRegs;
  static constexpr int kQkSteps = DP / 16;  // 16-deep k-steps of S^T and dP^T over D, 4 a 64-column chunk
  static constexpr int kSRegs = BQ / 2;     // f32 registers of S^T (and of dP^T) a thread
  static constexpr int kHiN = DP - 64;      // dK and dV columns in the second 64-column chunk
  static constexpr int kDqN = DP / 2;       // dQ columns a consumer computes
  static constexpr uint32_t kQBytes = 2 * BQ * 128;  // a tile of Q or dO: two boxes of 64 columns
  static constexpr uint32_t kKBytes = 2 * BK * 128;  // the block's K or V
  // K's columns DP/2 .. as one more box (consumer 1's B of dQ); at DP = 128
  // that is K's second chunk
  static constexpr uint32_t kKhBytes = DP == 128 ? 0 : BK * 128;
  static constexpr uint32_t kStageBytes = 2 * kQBytes;  // Q, then dO
  static constexpr uint32_t kDsBytes = BK * 128;        // dS^T: BK rows of the tile's 64 queries
  static constexpr uint32_t kStgBytes = BQ * DP * 4;    // a tile's f32 dQ rows, row-major
  static constexpr uint32_t kOffK = kStages * kStageBytes;
  static constexpr uint32_t kOffV = kOffK + kKBytes;
  static constexpr uint32_t kOffKh = kOffV + kKBytes;
  static constexpr uint32_t kOffDs = kOffKh + kKhBytes;
  static constexpr uint32_t kOffStg = kOffDs + 2 * kDsBytes;
  static constexpr uint32_t kOffStats = kOffStg + kStgBytes;  // [stage][lse2 | delta][BQ] f32
  static constexpr uint32_t kOffBar = kOffStats + kStages * 2 * BQ * 4;
  static constexpr uint32_t kBars = 1 + 2 * kStages;  // K/V full; Q/dO full and empty per stage
  static constexpr size_t kSmemBytes = kOffBar + kBars * 8 + 1024;  // + slack to align to 1024
  static_assert(DP % 16 == 0 && DP > 64 && DP <= 128, "head dim");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// P^T = exp2(S^T c - lse2) in place: a wgmma accumulator over NQ queries
// (its columns), `lse2` the queries' lse log2 e
template <int NQ>
__device__ __forceinline__ void exp2_scores(float (&s)[NQ / 2], const float* lse2, float c, int t) {
#pragma unroll
  for (int i = 0; i < NQ / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], c, e & 1 ? -l.y : -l.x));
  }
}

// dS^T = P^T (dP^T - delta) in place in dp
template <int NQ>
__device__ __forceinline__ void ds_scores(float (&dp)[NQ / 2], const float (&p)[NQ / 2], const float* delta, int t) {
#pragma unroll
  for (int i = 0; i < NQ / 8; ++i) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * i + e] = p[4 * i + e] * (dp[4 * i + e] - (e & 1 ? dl.y : dl.x));
  }
}

// One row pair of a wgmma accumulator of N columns (starting at column
// col0) scaled to bf16: the thread's row g (r = 0) or g + 8 (r = 1),
// columns past d left out
template <int N>
__device__ __forceinline__ void store_bf16_row(__nv_bfloat16* out, const float (&acc)[N / 2], int r, int col0, int t,
                                               int d, float scale) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = col0 + 8 * i + 2 * t;  // d % 8 == 0: the pair is in or out together
    if (col < d)
      *reinterpret_cast<__nv_bfloat162*>(out + col) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(FusedWideTile<DP>::kThreadsTotal, 1)
    flash_bwd_fused_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int sq, int sk, int d, float scale) {
  using C = FusedWideTile<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::kStages;
  extern __shared__ unsigned char fused_wide_smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = fused_wide_smem_raw + ((1024 - (smem_u32(fused_wide_smem_raw) & 1023)) & 1023);
  // stage st: Q at st * kStageBytes (two 64-column chunks of BQ rows), dO kQBytes after it
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::kOffK;  // two chunks of BK rows
  unsigned char* sV = smem + C::kOffV;
  unsigned char* sKh = C::kKhBytes ? smem + C::kOffKh : sK + BK * 128;  // K's columns DP/2 ..
  unsigned char* sDs = smem + C::kOffDs;
  float* sStg = reinterpret_cast<float*>(smem + C::kOffStg);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int n_tiles = (sq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1 + 32);  // the TMA thread and the stats warp
      mbar_init(empty + st, C::kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads K (and its columns from DP/2) and V once,
    // then streams the Q and dO tiles; the next warp stages each tile's lse
    // (base 2) and delta
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes + C::kKhBytes);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tma_load_3d(sK + c * BK * 128, &tm_k, kv_full, 64 * c, k0, bh);
        tma_load_3d(sV + c * BK * 128, &tm_v, kv_full, 64 * c, k0, bh);
      }
      if (C::kKhBytes) tma_load_3d(sKh, &tm_k, kv_full, DP / 2, k0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        unsigned char* stage = sQ + st * C::kStageBytes;
        mbar_wait(empty + st, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st, C::kStageBytes);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load_3d(stage + c * BQ * 128, &tm_q, full + st, 64 * c, j * BQ, bh);
          tma_load_3d(stage + C::kQBytes + c * BQ * 128, &tm_do, full + st, 64 * c, j * BQ, bh);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const float* lb = lse + size_t(bh) * sq;
      const float* db = delta + size_t(bh) * sq;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        mbar_wait(empty + st, ((j / NS) & 1) ^ 1);
        float* stats = sStats + st * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int q = j * BQ + i;
          stats[i] = q < sq ? lb[q] * kLog2e : kLseMasked;
          stats[BQ + i] = q < sq ? db[q] : 0.f;
        }
        mbar_arrive(full + st);
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;  // consumer warpgroup: keys 64w.. of the block, dQ columns w DP/2..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row = 64 * w + 16 * warp + g;  // this thread's first key row in the block
    const bool reducer = w == 0 && tid == 0;  // the thread that adds the tile's dQ rows into dq_acc
    const float c = scale * kLog2e;
    // descriptors of stage 0 / buffer 0 / chunk 0; the others are fixed byte offsets
    const uint64_t k_desc = wgmma_desc(sK + w * 64 * 128, 16, 1024);  // A of S^T, K-major
    const uint64_t v_desc = wgmma_desc(sV + w * 64 * 128, 16, 1024);  // A of dP^T
    const uint64_t q_desc = wgmma_desc(sQ, 16, 1024);                 // B of S^T, K-major
    const uint64_t do_desc = wgmma_desc(sQ + C::kQBytes, 16, 1024);   // B of dP^T
    const uint64_t q_mn = wgmma_desc(sQ, BQ * 128, 1024);                // B of dK, MN-major
    const uint64_t do_mn = wgmma_desc(sQ + C::kQBytes, BQ * 128, 1024);  // B of dV, MN-major
    const uint64_t ds_mn = wgmma_desc(sDs, BK * 128, 1024);              // A of dQ, MN-major
    const uint64_t k_mn = wgmma_desc(w ? sKh : sK, BK * 128, 1024);      // B of dQ: columns w DP/2.., MN-major
    // keys past sk (the last block) arrive as zeros; their P must be 0, not exp2(-lse2)
    const bool ragged = k0 + BK > sk;
    const bool row_ok[2] = {k0 + row < sk, k0 + row + 8 < sk};

    float s[C::kSRegs], dp[C::kSRegs];
    uint32_t pa[C::kSRegs / 8][4], da[C::kSRegs / 8][4];
    // dK and dV: columns 0-63 (lo) and 64.. (hi), one wgmma each per k-step
    float dk_lo[32], dk_hi[C::kHiN / 2], dv_lo[32], dv_hi[C::kHiN / 2], dq[C::kDqN / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_lo[i] = dv_lo[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kHiN / 2; ++i) dk_hi[i] = dv_hi[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      const uint32_t stage = st * C::kStageBytes;
      const uint32_t buf = (j & 1) * C::kDsBytes;
      mbar_wait(full + st, (j / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kQkSteps; ++ks)
        Wgmma<BQ>::ss(s, wgmma_desc_advance(k_desc, (ks / 4) * BK * 128 + (ks % 4) * 32),
                      wgmma_desc_advance(q_desc, stage + (ks / 4) * BQ * 128 + (ks % 4) * 32), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < C::kQkSteps; ++ks)
        Wgmma<BQ>::ss(dp, wgmma_desc_advance(v_desc, (ks / 4) * BK * 128 + (ks % 4) * 32),
                      wgmma_desc_advance(do_desc, stage + (ks / 4) * BQ * 128 + (ks % 4) * 32), ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done
      fence_regs(s);
      const float* stats = sStats + st * 2 * BQ;
      exp2_scores<BQ>(s, stats, c, t);  // while dP^T runs
      if (ragged) {
#pragma unroll
        for (int i = 0; i < C::kSRegs; ++i)
          if (!row_ok[(i % 4) / 2]) s[i] = 0.f;
      }
      wgmma_wait<0>();  // dP^T is done
      fence_regs(dp);
      ds_scores<BQ>(dp, s, stats + BQ, t);
      pack_p(pa, s);
      pack_p(da, dp);
      // dS^T to shared memory first: the registers of an in-flight wgmma's
      // A operand may not be read
      store_ds<BK, BQ / 8>(sDs + buf, da, row, g, t);
      fence_proxy_async_smem();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t at = stage + kk * 16 * 128;  // queries 16 kk.. of chunk 0; chunk 1 BQ * 128 on
        Wgmma<64>::rs(dv_lo, pa[kk], wgmma_desc_advance(do_mn, at), 1);
        Wgmma<C::kHiN>::rs(dv_hi, pa[kk], wgmma_desc_advance(do_mn, at + BQ * 128), 1);
        Wgmma<64>::rs(dk_lo, da[kk], wgmma_desc_advance(q_mn, at), 1);
        Wgmma<C::kHiN>::rs(dk_hi, da[kk], wgmma_desc_advance(q_mn, at + BQ * 128), 1);
      }
      wgmma_commit();
      if (reducer) bulk_wait_read<0>();  // the last tile's dQ rows have left the staging buffer
      named_barrier_sync(1, C::kConsumerThreads);  // both consumers' dS^T are in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<C::kDqN>::template ss<1, 1>(dq, wgmma_desc_advance(ds_mn, buf + kk * 16 * 128),
                                          wgmma_desc_advance(k_mn, kk * 16 * 128), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dk_lo);
      fence_regs(dk_hi);
      fence_regs(dv_lo);
      fence_regs(dv_hi);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty + st);
      // the tile's dQ rows (f32, unscaled) row-major, this consumer's
      // columns; then one bulk reduce-add of the rows inside sq
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < C::kDqN / 8; ++i) {
          const int col = w * C::kDqN + 8 * i + 2 * t;  // d % 8 == 0: the pair is in or out together
          if (col < d)
            *reinterpret_cast<float2*>(sStg + (16 * warp + g + 8 * r) * d + col) =
                make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
        }
      fence_proxy_async_smem();
      named_barrier_sync(2, C::kConsumerThreads);
      if (reducer) {
        const int q0 = j * BQ;
        bulk_reduce_add_f32(dq_acc + (size_t(bh) * sq + q0) * d, sStg, uint32_t(min(BQ, sq - q0) * d * 4));
        bulk_commit();
      }
    }
    if (reducer) bulk_wait<0>();

    // dK = scale dS^T Q and dV = P^T dO for this thread's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t key = size_t(k0) + row + 8 * r;
      if (key >= size_t(sk)) continue;
      __nv_bfloat16* okr = dk + (size_t(bh) * sk + key) * d;
      __nv_bfloat16* ovr = dv + (size_t(bh) * sk + key) * d;
      store_bf16_row<64>(okr, dk_lo, r, 0, t, d, scale);
      store_bf16_row<C::kHiN>(okr, dk_hi, r, 64, t, d, scale);
      store_bf16_row<64>(ovr, dv_lo, r, 0, t, d, 1.f);
      store_bf16_row<C::kHiN>(ovr, dv_hi, r, 64, t, d, 1.f);
    }
  }
}

template <int DP>
cudaError_t launch_fused_wide(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                              const float* delta, float* dq_acc, void* dq, void* dk, void* dv, int bh, int sq,
                              int sk, int d, float scale, cudaStream_t stream) {
  using C = FusedWideTile<DP>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_bf16_3d(&tm_q, q, bh, sq, d, C::BQ) || !encode_bf16_3d(&tm_do, dout, bh, sq, d, C::BQ) ||
      !encode_bf16_3d(&tm_k, k, bh, sk, d, C::BK) || !encode_bf16_3d(&tm_v, v, bh, sk, d, C::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_fused_wide_kernel<DP>;
  static unsigned devices_set = 0;
  cudaError_t err = allow_smem_once(kernel, C::kSmemBytes, devices_set);
  if (err != cudaSuccess) return err;
  using B = __nv_bfloat16;
  const dim3 grid((sk + C::BK - 1) / C::BK, bh);
  kernel<<<grid, C::kThreadsTotal, C::kSmemBytes, stream>>>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq_acc,
                                                            static_cast<B*>(dk), static_cast<B*>(dv), sq, sk,
                                                            d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dq_convert(dq_acc, dq, bh, sq, d, scale, stream);
}

// --- fused CUDA-core kernel: f32, D % 4 == 0, D <= 128 (cp.async, dQ by partials) ---

template <int DP>
struct F32Tile {
  static constexpr int kThreads = 256;
  // 64 < D <= 128: 64 keys a block. At 128 keys dK and dV alone would hold
  // 128 registers a thread at D = 128, and K, V, the Q/dO ring and P^T/dS^T
  // of 128 keys pass the 227 KB of shared memory from D = 80 on.
  static constexpr bool kWideHead = DP > 64;
  static constexpr int BK = kWideHead ? 64 : 128;  // keys per block
  static constexpr int BQ = DP > 112 ? 48 : 64;    // queries per streamed tile (64 passes 227 KB at DP = 128)
  static constexpr int KS = BK / 16;               // S^T keys a thread: s_kg + 16 i, i < KS
  static constexpr int QS = BQ / 16;               // S^T and dQ queries a thread: 16 apart, QS of them
  static constexpr int KVG = 1024 / BK;            // dK/dV column groups: keys 4 (tid / KVG) + r, r < 4
  static constexpr int CPG = DP / KVG;             // dK and dV columns a thread: tid % KVG + KVG c
  // dQ: D <= 64 sums two 64-key halves (128 threads each) that meet in
  // shared memory; wide heads have one 64-key block and no halves
  static constexpr int kHalves = kWideHead ? 1 : 2;
  static constexpr int DQG = 16 / kHalves;         // dQ column groups of a half
  static constexpr int DQC = DP / DQG;             // dQ columns a thread
  static constexpr int LD = DP + 4;   // row stride (floats) of K, V, Q, dO: [row][column]
  static constexpr int LDP = BK + 4;  // row stride of P^T and dS^T, kept as [query][key]
  // row stride of the dQ half handed between the two key halves (a bank
  // offset of 8 or 24 a row: the 4 rows x 8 columns a warp writes hit 32 banks)
  static constexpr int LDR = (DP % 32 == 8 || DP % 32 == 24) ? DP : DP + 8;
  static constexpr int kStage = 2 * BQ * LD + 2 * BQ;  // Q, dO, lse, delta of one query tile
  static constexpr int kOffV = BK * LD;
  static constexpr int kOffStage = 2 * BK * LD;
  static constexpr int kOffP = kOffStage + 2 * kStage;
  static constexpr int kOffDs = kOffP + BQ * LDP;
  static constexpr int kOffRed = kOffDs + BQ * LDP;
  static constexpr size_t kSmemBytes = size_t(kOffRed + (kHalves == 2 ? BQ * LDR : 0)) * sizeof(float);
  static_assert(DP % 8 == 0 && DP <= 128 && (!kWideHead || DP % 16 == 0), "head dim");
  static_assert(BK * BQ == 16 * 16 * KS * QS && (BK / 4) * KVG == kThreads, "thread maps");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

template <int DP>
__global__ void __launch_bounds__(F32Tile<DP>::kThreads, 1)
    flash_bwd_f32_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq_part, float* __restrict__ dk, float* __restrict__ dv,
                               int sq, int sk, int d, float scale) {
  using C = F32Tile<DP>;
  constexpr int BK = C::BK, BQ = C::BQ, KS = C::KS, QS = C::QS, CPG = C::CPG, DQC = C::DQC;
  constexpr int LD = C::LD, LDP = C::LDP, LDR = C::LDR;
  constexpr int kThreadsF32 = C::kThreads;
  extern __shared__ __align__(16) float f32_smem[];
  float* sK = f32_smem;                 // [key][column], zeros past sk and d
  float* sV = f32_smem + C::kOffV;
  float* sP = f32_smem + C::kOffP;      // P^T of the tile, [query][key]
  float* sDs = f32_smem + C::kOffDs;    // dS^T of the tile, [query][key]
  float* sRed = f32_smem + C::kOffRed;  // the second key half's dQ rows, [query][column] (D <= 64)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int n_tiles = (sq + BQ - 1) / BQ;
  const int d4 = d / 4;
  const float* qb = q + size_t(bh) * sq * d;
  const float* ob = dout + size_t(bh) * sq * d;
  const float* lb = lse + size_t(bh) * sq;
  const float* db = delta + size_t(bh) * sq;
  // stage st: Q [BQ][LD], dO [BQ][LD], lse [BQ], delta [BQ]
  auto stage = [&](int st) { return f32_smem + C::kOffStage + st * C::kStage; };

  // query tile j's Q and dO rows (16-byte copies, columns < d), lse and delta
  // into stage st, as one cp.async group; rows past sq arrive as zeros
  auto fetch = [&](int j, int st) {
    float* s = stage(st);
    const int q0 = j * BQ;
    for (int e = tid; e < BQ * d4; e += kThreadsF32) {
      const int r = e / d4, c = 4 * (e - r * d4);
      const bool ok = q0 + r < sq;
      const size_t off = ok ? size_t(q0 + r) * d + c : 0;
      cp_async16(s + r * LD + c, qb + off, ok);
      cp_async16(s + (BQ + r) * LD + c, ob + off, ok);
    }
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < sq;
      cp_async4(s + 2 * BQ * LD + tid, (tid < BQ ? lb : db) + (ok ? q0 + r : 0), ok);
    }
    cp_async_commit();
  };

  // K and V of the block, and zeros in the stages' columns d..DP-1, which
  // the copies never write
  for (int e = tid; e < BK * (DP / 4); e += kThreadsF32) {
    const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (k0 + r < sk && c < d) {
      const size_t off = (size_t(bh) * sk + k0 + r) * d + c;
      kk = *reinterpret_cast<const float4*>(k + off);
      vv = *reinterpret_cast<const float4*>(v + off);
    }
    *reinterpret_cast<float4*>(sK + r * LD + c) = kk;
    *reinterpret_cast<float4*>(sV + r * LD + c) = vv;
  }
  const int pad4 = (DP - d) / 4;
  for (int e = tid; e < 4 * BQ * pad4; e += kThreadsF32) {
    const int row = e / pad4;  // stage row / (2 BQ); Q's rows, then dO's
    const int c = d + 4 * (e - row * pad4);
    *reinterpret_cast<float4*>(stage(row / (2 * BQ)) + (row % (2 * BQ)) * LD + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fetch(0, 0);
  cp_async_wait<0>();
  __syncthreads();

  // S^T and dP^T: keys s_kg + 16 i (i < KS) x queries s_qg + 16 j (j < QS)
  const int s_kg = lane / 8 + 4 * (warp % 4), s_qg = lane % 8 + 8 * (warp / 4);
  // dK and dV: keys 4 kv_kg + r (r < 4) x columns cg + KVG c
  const int cg = tid % C::KVG, kv_kg = tid / C::KVG;
  // dQ: queries dq_qg + 16 i (i < QS) x columns dq_cg + DQG c over the 64
  // keys 64 half ..; with two halves their sums meet in sRed
  constexpr int kHalfThreads = kThreadsF32 / C::kHalves;
  const int half = tid / kHalfThreads, dq_qg = (tid % kHalfThreads) / C::DQG, dq_cg = tid % C::DQG;
  const float c2 = scale * kLog2e;
  const bool ragged = k0 + BK > sk;  // the last block: its keys past sk get P = 0

  float dk_acc[4][CPG], dv_acc[4][CPG];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPG; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    // the other stage was last read before the previous tile's second barrier
    if (j + 1 < n_tiles) fetch(j + 1, st ^ 1);
    const float* sQ = stage(st);
    const float* sO = sQ + BQ * LD;
    const float* sL = sQ + 2 * BQ * LD;
    const float* sD = sL + BQ;

    // S^T = K Q^T and dP^T = V dO^T, f32 FMA over the (padded) head dim
    float s[KS][QS], dp[KS][QS];
#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int jj = 0; jj < QS; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 qq[QS], oo[QS];
#pragma unroll
      for (int jj = 0; jj < QS; ++jj) {
        qq[jj] = *reinterpret_cast<const float4*>(sQ + (s_qg + 16 * jj) * LD + c);
        oo[jj] = *reinterpret_cast<const float4*>(sO + (s_qg + 16 * jj) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(sK + (s_kg + 16 * i) * LD + c);
        const float4 vv = *reinterpret_cast<const float4*>(sV + (s_kg + 16 * i) * LD + c);
#pragma unroll
        for (int jj = 0; jj < QS; ++jj) {
          s[i][jj] = fmaf(kk.x, qq[jj].x, s[i][jj]);
          s[i][jj] = fmaf(kk.y, qq[jj].y, s[i][jj]);
          s[i][jj] = fmaf(kk.z, qq[jj].z, s[i][jj]);
          s[i][jj] = fmaf(kk.w, qq[jj].w, s[i][jj]);
          dp[i][jj] = fmaf(vv.x, oo[jj].x, dp[i][jj]);
          dp[i][jj] = fmaf(vv.y, oo[jj].y, dp[i][jj]);
          dp[i][jj] = fmaf(vv.z, oo[jj].z, dp[i][jj]);
          dp[i][jj] = fmaf(vv.w, oo[jj].w, dp[i][jj]);
        }
      }
    }

    // P^T = exp2(S^T c2 - lse log2 e), dS^T = P^T (dP^T - delta). Queries
    // past sq have zero Q, dO, lse and delta: P = 1 there, but dS = 0 and P
    // meets only zero dO rows, so they add nothing.
#pragma unroll
    for (int jj = 0; jj < QS; ++jj) {
      const int qi = s_qg + 16 * jj;
      const float l2 = sL[qi] * kLog2e, dl = sD[qi];
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int key = s_kg + 16 * i;
        float p = fast_exp2(fmaf(s[i][jj], c2, -l2));
        if (ragged && k0 + key >= sk) p = 0.f;
        sP[qi * LDP + key] = p;
        sDs[qi * LDP + key] = p * (dp[i][jj] - dl);
      }
    }
    __syncthreads();  // P^T and dS^T of the tile are in shared memory

    // dV += P^T dO and dK += dS^T Q over the tile's queries, in query order
#pragma unroll 4
    for (int qi = 0; qi < BQ; ++qi) {
      const float4 p = *reinterpret_cast<const float4*>(sP + qi * LDP + 4 * kv_kg);
      const float4 ds = *reinterpret_cast<const float4*>(sDs + qi * LDP + 4 * kv_kg);
      float o[CPG], x[CPG];
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        o[c] = sO[qi * LD + cg + C::KVG * c];
        x[c] = sQ[qi * LD + cg + C::KVG * c];
      }
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        dv_acc[0][c] = fmaf(p.x, o[c], dv_acc[0][c]);
        dv_acc[1][c] = fmaf(p.y, o[c], dv_acc[1][c]);
        dv_acc[2][c] = fmaf(p.z, o[c], dv_acc[2][c]);
        dv_acc[3][c] = fmaf(p.w, o[c], dv_acc[3][c]);
        dk_acc[0][c] = fmaf(ds.x, x[c], dk_acc[0][c]);
        dk_acc[1][c] = fmaf(ds.y, x[c], dk_acc[1][c]);
        dk_acc[2][c] = fmaf(ds.z, x[c], dk_acc[2][c]);
        dk_acc[3][c] = fmaf(ds.w, x[c], dk_acc[3][c]);
      }
    }

    // this block's dQ rows of the tile, dS K, over this thread's 64 keys in
    // key order
    float dq_acc[QS][DQC];
#pragma unroll
    for (int i = 0; i < QS; ++i)
#pragma unroll
      for (int c = 0; c < DQC; ++c) dq_acc[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 64 * half; kk < 64 * half + 64; kk += 4) {
      float ds[QS][4];
#pragma unroll
      for (int i = 0; i < QS; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(sDs + (dq_qg + 16 * i) * LDP + kk);
        ds[i][0] = x.x;
        ds[i][1] = x.y;
        ds[i][2] = x.z;
        ds[i][3] = x.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kr[DQC];
#pragma unroll
        for (int c = 0; c < DQC; ++c) kr[c] = sK[(kk + t) * LD + dq_cg + C::DQG * c];
#pragma unroll
        for (int i = 0; i < QS; ++i)
#pragma unroll
          for (int c = 0; c < DQC; ++c) dq_acc[i][c] = fmaf(ds[i][t], kr[c], dq_acc[i][c]);
      }
    }
    if (C::kHalves == 2 && half == 1) {
#pragma unroll
      for (int i = 0; i < QS; ++i)
#pragma unroll
        for (int c = 0; c < DQC; ++c) sRed[(dq_qg + 16 * i) * LDR + dq_cg + 8 * c] = dq_acc[i][c];
    }
    cp_async_wait<0>();  // this thread's copies of the next tile have landed
    __syncthreads();     // the tile is consumed, sRed is written, the next tile is in

    // (first half + second half,) written as this key block's dQ partial
    // (unscaled) of the tile's rows inside sq; the next tile's sRed is
    // written only after its first barrier
    if (half == 0) {
      float* out = dq_part + ((size_t(blockIdx.x) * gridDim.y + bh) * sq + size_t(j) * BQ) * d;
#pragma unroll
      for (int i = 0; i < QS; ++i) {
        const int qi = dq_qg + 16 * i;
        if (j * BQ + qi >= sq) continue;
#pragma unroll
        for (int c = 0; c < DQC; ++c) {
          const int col = dq_cg + C::DQG * c;
          if (col < d) {
            if constexpr (C::kHalves == 2)
              out[size_t(qi) * d + col] = dq_acc[i][c] + sRed[qi * LDR + col];
            else
              out[size_t(qi) * d + col] = dq_acc[i][c];
          }
        }
      }
    }
  }

  // dK = scale dS^T Q and dV = P^T dO for this thread's keys
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 4 * kv_kg + r;
    if (key >= sk) continue;
    float* okr = dk + (size_t(bh) * sk + key) * d;
    float* ovr = dv + (size_t(bh) * sk + key) * d;
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      const int col = cg + C::KVG * c;
      if (col < d) {
        okr[col] = dk_acc[r][c] * scale;
        ovr[col] = dv_acc[r][c];
      }
    }
  }
}

// dQ = scale * (part[0] + part[1] + ... + part[n_parts - 1]), summed in key
// block order; four elements a thread per step (n4 = elements / 4)
__global__ void __launch_bounds__(256)
    flash_bwd_f32_dq_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dq, size_t n4, int n_parts,
                                float scale) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4; i += size_t(gridDim.x) * blockDim.x) {
    float4 a = part[i];
#pragma unroll 8
    for (int b = 1; b < n_parts; ++b) {
      const float4 x = part[size_t(b) * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    dq[i] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
  }
}

template <int DP>
cudaError_t launch_f32_fused(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                             const float* delta, float* dq_part, float* dq, float* dk, float* dv, int bh, int sq,
                             int sk, int d, float scale, cudaStream_t stream) {
  using C = F32Tile<DP>;
  auto kernel = flash_bwd_f32_fused_kernel<DP>;
  static unsigned devices_set = 0;
  cudaError_t err = allow_smem_once(kernel, C::kSmemBytes, devices_set);
  if (err != cudaSuccess) return err;
  const int n_parts = (sk + C::BK - 1) / C::BK;
  kernel<<<dim3(n_parts, bh), C::kThreads, C::kSmemBytes, stream>>>(q, k, v, dout, lse, delta, dq_part, dk, dv,
                                                                    sq, sk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = size_t(bh) * sq * d / 4;
  const unsigned blocks = unsigned(n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  flash_bwd_f32_dq_sum_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(dq_part),
                                                         reinterpret_cast<float4*>(dq), n4, n_parts, scale);
  return cudaGetLastError();
}

bool valid_shape(int bh, int sq, int sk, int d) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && d >= 1 && d <= 512;
}

}  // namespace

// q/dout/dq (bh, sq, d), k/v (bh, sk, d): contiguous rows, all of one dtype
// (0 = float32, 1 = bfloat16); lse and delta (bh, sq) float32, lse as the
// forward wrote it. The CUDA-core kernels: dQ, and dK with dV. Launch on
// `stream` and return the launch's cudaError_t (0 on success); they do not
// synchronise.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int bh, int sq, int sk, int d, float scale,
                                      int dtype, void* stream) {
  if (!valid_shape(bh, sq, sk, d)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
    case 1:
      return int(dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int bh, int sq, int sk, int d,
                                       float scale, int dtype, void* stream) {
  if (!valid_shape(bh, sq, sk, d)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
    case 1:
      return int(dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The fused kernel: bf16 only, d % 8 == 0, d <= 64, every pointer 16-byte
// aligned. dq_acc (bh, sq, d) float32 must hold zeros; it ends holding dQ /
// scale in f32, and dq the bf16 dQ. Launches the fused kernel and the dQ
// conversion on `stream`; returns the first failed launch's cudaError_t
// (0 on success); does not synchronise.
extern "C" int flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         float* dq_acc, void* dq, void* dk, void* dv, int bh, int sq,
                                         int sk, int d, float scale, void* stream) {
  if (!valid_shape(bh, sq, sk, d) || d > 64 || !aligned16({q, k, v, dout, dq_acc, dq, dk, dv}, d))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return int(launch_fused<16>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 32) return int(launch_fused<32>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 40) return int(launch_fused<40>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 48) return int(launch_fused<48>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  return int(launch_fused<64>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
}

// The fused kernel for wide heads: bf16 only, d % 8 == 0, 64 < d <= 128,
// every pointer 16-byte aligned; arguments and result as
// flash_attention_bwd_fused's.
extern "C" int flash_attention_bwd_fused_wide(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse, const float* delta,
                                              float* dq_acc, void* dq, void* dk, void* dv, int bh, int sq,
                                              int sk, int d, float scale, void* stream) {
  if (!valid_shape(bh, sq, sk, d) || d <= 64 || d > 128 || !aligned16({q, k, v, dout, dq_acc, dq, dk, dv}, d))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 80)
    return int(launch_fused_wide<80>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 96)
    return int(launch_fused_wide<96>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 112)
    return int(launch_fused_wide<112>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
  return int(launch_fused_wide<128>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d, scale, s));
}

// The fused f32 kernel: f32 only, d % 4 == 0, d <= 128, q, k, v, dout, dq_part
// and dq 16-byte aligned. dq_part (ceil(sk / BK), bh, sq, d) float32 is
// scratch, BK = 128 keys at d <= 64 and 64 above (F32Tile::BK): each block of
// keys writes its unscaled dQ partial there, and
// a second kernel writes dq = scale * (the partials summed in key-block
// order). Returns the first failed launch's cudaError_t (0 on success); does
// not synchronise.
extern "C" int flash_attention_bwd_f32_fused(const float* q, const float* k, const float* v, const float* dout,
                                             const float* lse, const float* delta, float* dq_part, float* dq,
                                             float* dk, float* dv, int bh, int sq, int sk, int d, float scale,
                                             void* stream) {
  uintptr_t addr = 0;
  for (const void* p : {static_cast<const void*>(q), static_cast<const void*>(k), static_cast<const void*>(v),
                        static_cast<const void*>(dout), static_cast<const void*>(dq_part),
                        static_cast<const void*>(dq)})
    addr |= reinterpret_cast<uintptr_t>(p);
  if (!valid_shape(bh, sq, sk, d) || d > 128 || d % 4 != 0 || addr % 16 != 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return int(launch_f32_fused<16>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 32) return int(launch_f32_fused<32>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 40) return int(launch_f32_fused<40>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 48) return int(launch_f32_fused<48>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 64) return int(launch_f32_fused<64>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 80) return int(launch_f32_fused<80>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 96) return int(launch_f32_fused<96>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  if (d <= 112) return int(launch_f32_fused<112>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
  return int(launch_f32_fused<128>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, sq, sk, d, scale, s));
}
