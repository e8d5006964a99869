// Flash-attention backward for Hopper (sm_90a), f32 and bf16 I/O: dQ, and
// dK with dV.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3)
// in stable_diffusion_training_tpu/ops/flash_attention.py (launched by
// `_flash_bwd`). Both recompute P = exp(S * scale - lse) from the forward's
// logsumexp, with keys past kv_len masked, and dS = P * (dO V^T - delta),
// where delta = rowsum(dO * O) is computed outside the kernels as on the TPU:
//   K2: dQ = scale * dS K            (one block per query tile, loops keys)
//   K3: dV = P^T dO, dK = scale * dS^T Q  (one block per key tile, loops queries)
// P is rounded to dO's dtype before P^T dO and dS to K's/Q's dtype before
// the dQ/dK products; every product accumulates in f32. dQ comes back in Q's
// dtype, dK/dV in K's/V's.
//
// Two kernels following the TPU grid, not one fused kernel: dK/dV sum over
// query tiles and dQ over key tiles, so a fused kernel would need f32 atomics
// on dQ (an order that changes from run to run) or a second pass. The split
// recomputes S and dO V^T once more (7 products of 2*S^2*D per head instead
// of 5) and is deterministic.
//
// What bounds it on this card. At the train step's shape, (64, 4096, 40) bf16
// (the UNet's 64x64 latent self-attention, batch 8, 8 heads), it is compute:
// 7 * 2 * 64 * 4096^2 * 40 ~ 0.60 TFLOP and 2 * 64 * 4096^2 ~ 2.1 G exps
// against ~ 0.1 GB of traffic. At D = 40 the exps (MUFU) weigh nearly as
// much as the products.
//
// What the design does about that. bf16 with D % 8 == 0 and D <= 64 runs on
// the tensor cores (`bwd_dq_mma_kernel`, `bwd_dkv_mma_kernel`): mma.sync
// m16n8k16 with f32 accumulators, FlashAttention-2 style, each of four warps
// owning 16 rows (queries for K2, keys for K3) whose operand fragments stay
// in registers for the whole loop. Score tiles (S, P, dS) never leave
// registers: the f32 accumulator layout of one product is repacked as the
// bf16 A fragment of the next (`acc_to_a`), and the operand it is multiplied
// with comes from shared memory through ldmatrix.trans. D is zero-padded to a
// multiple of 16 in shared memory (40 -> 48). The streamed tiles are
// double-buffered with cp.async. The exps run in base 2. Everything else (f32,
// bf16 with D % 8 != 0 or D > 64) runs on the CUDA cores
// (`bwd_dq_kernel`, `bwd_dkv_kernel`): f32 FMA with the tiles staged in
// shared memory as f32, dS (and P) rounded to the input dtype through shared
// memory, tile shapes picked by the head dim as in the forward's CUDA-core
// kernel. wgmma, TMA and a warp-specialised pipeline are later work.
#include "flash_common.cuh"

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

// --- tensor-core kernels: bf16, D % 8 == 0, D <= 64 ----------------------------
//
// Fragment bookkeeping (m16n8k16): a thread holds rows g = lane / 4 and
// g + 8 of its warp's 16, and in each 8-column n-tile columns 2t, 2t + 1
// (t = lane % 4). Score tiles are 16 rows x 64 columns: NT = 8 n-tiles.

template <int DP>
struct MmaTile {
  static constexpr int BR = 16 * kWarps;  // rows a block owns (queries for dQ, keys for dK/dV)
  static constexpr int BS = 64;           // rows of each streamed tile
  static constexpr int LD = DP + 8;       // bf16 per smem row
  static constexpr int KS = DP / 16;      // k-steps over D
  static constexpr int NT = BS / 8;       // 8-column n-tiles of a score tile
  static constexpr int OT = DP / 8;       // 8-column n-tiles of an output row
  static_assert(OT % 2 == 0, "B fragments are loaded two column tiles at a time");
  // the block's two row tiles, two stages of the two streamed tiles, and
  // two stages of the streamed tile's lse and delta (dK/dV only)
  static constexpr size_t kSmemBytes =
      (2 * size_t(BR) * LD + 4 * size_t(BS) * LD) * 2 + 4 * size_t(BS) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int sq, int sk, int d, float scale) {
  using M = MmaTile<DP>;
  constexpr int BQ = M::BR, BK = M::BS, LD = M::LD, KS = M::KS, NT = M::NT, OT = M::OT;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* sO = sQ + BQ * LD;  // dO
  __nv_bfloat16* sK = sO + BQ * LD;  // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * BK * LD;  // [2][BK][LD]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* kb = k + size_t(bh) * sk * d;
  const __nv_bfloat16* vb = v + size_t(bh) * sk * d;

  const int n_tiles = (sk + BK - 1) / BK;
  load_tile_async<DP, LD>(sQ, q + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);
  load_tile_async<DP, LD>(sO, dout + (size_t(bh) * sq + q0) * d, BQ, sq - q0, d);
  load_tile_async<DP, LD>(sK, kb, BK, min(BK, sk), d);
  load_tile_async<DP, LD>(sV, vb, BK, min(BK, sk), d);
  cp_async_commit();

  // lse (base 2) and delta of this thread's rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    l2[r] = row < sq ? lse[size_t(bh) * sq + row] * kLog2e : 0.f;
    dl[r] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
  }

  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KS][4], oa[KS][4];
  load_a_frags<KS, LD>(qa, sQ + warp * 16 * LD, g, t);
  load_a_frags<KS, LD>(oa, sO + warp * 16 * LD, g, t);

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int kv = min(BK, sk - k0);
    const __nv_bfloat16* sKt = sK + (it & 1) * BK * LD;
    const __nv_bfloat16* sVt = sV + (it & 1) * BK * LD;
    if (it > 0) {  // tile `it` has landed, and every warp is done with tile it - 1
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the stage tile it - 1 used
      const int k1 = k0 + BK;
      const size_t stage = ((it + 1) & 1) * BK * LD;
      load_tile_async<DP, LD>(sK + stage, kb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      load_tile_async<DP, LD>(sV + stage, vb + size_t(k1) * d, BK, min(BK, sk - k1), d);
      cp_async_commit();
    }

    // S = Q K^T and dP = dO V^T; [j] holds rows (g, g, g+8, g+8) x keys (8j+2t, 8j+2t+1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* krow = sKt + (j * 8 + g) * LD + 2 * t;
      const __nv_bfloat16* vrow = sVt + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_16816(s[j], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
        mma_16816(dp[j], oa[ks], ld32(vrow + ks * 16), ld32(vrow + ks * 16 + 8));
      }
    }

    // P = exp(S scale - lse), keys past kv_len masked to 0; dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j * 8 + 2 * t + (e & 1) < kv;
        const float p = valid ? exp2f(s[j][e] * scale_log2 - l2[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e / 2]);
      }

    // dQ += dS K, dS rounded to bf16 as the A fragment, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans<LD>(b, sKt + kk * 16 * LD + j * 8, lane);
        mma_16816(acc[j], da, b[0], b[1]);
        mma_16816(acc[j + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + (size_t(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t;  // d % 8 == 0: the pair is in or out together
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                       int sk, int d, float scale) {
  using M = MmaTile<DP>;
  constexpr int BKB = M::BR, BQ = M::BS, LD = M::LD, KS = M::KS, NT = M::NT, OT = M::OT;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* sV = sK + BKB * LD;
  __nv_bfloat16* sQ = sV + BKB * LD;     // [2][BQ][LD]
  __nv_bfloat16* sO = sQ + 2 * BQ * LD;  // dO, [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);  // [2][BQ] lse * log2 e
  float* sD = sL + 2 * BQ;                                  // [2][BQ] delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* qb = q + size_t(bh) * sq * d;
  const __nv_bfloat16* ob = dout + size_t(bh) * sq * d;
  const float* lb = lse + size_t(bh) * sq;
  const float* db = delta + size_t(bh) * sq;

  // the lse and delta of query tile q0 into stage `st` (plain stores, seen
  // after the next __syncthreads)
  auto load_stats = [&](int st, int q1) {
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q1 + i < sq;
      sL[st * BQ + i] = in ? lb[q1 + i] * kLog2e : 0.f;
      sD[st * BQ + i] = in ? db[q1 + i] : 0.f;
    }
  };

  const int n_tiles = (sq + BQ - 1) / BQ;
  load_tile_async<DP, LD>(sK, k + (size_t(bh) * sk + k0) * d, BKB, sk - k0, d);
  load_tile_async<DP, LD>(sV, v + (size_t(bh) * sk + k0) * d, BKB, sk - k0, d);
  load_tile_async<DP, LD>(sQ, qb, BQ, min(BQ, sq), d);
  load_tile_async<DP, LD>(sO, ob, BQ, min(BQ, sq), d);
  cp_async_commit();
  load_stats(0, 0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
  load_a_frags<KS, LD>(ka, sK + warp * 16 * LD, g, t);
  load_a_frags<KS, LD>(va, sV + warp * 16 * LD, g, t);

  float ak[OT][4], av[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    ak[j][0] = ak[j][1] = ak[j][2] = ak[j][3] = 0.f;
    av[j][0] = av[j][1] = av[j][2] = av[j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BQ;
    const int qv = min(BQ, sq - q0);
    const int st = it & 1;
    const __nv_bfloat16* sQt = sQ + st * BQ * LD;
    const __nv_bfloat16* sOt = sO + st * BQ * LD;
    const float* sLt = sL + st * BQ;
    const float* sDt = sD + st * BQ;
    if (it > 0) {  // tile `it` has landed, and every warp is done with tile it - 1
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the stage tile it - 1 used
      const int q1 = q0 + BQ;
      const size_t stage = (st ^ 1) * BQ * LD;
      load_tile_async<DP, LD>(sQ + stage, qb + size_t(q1) * d, BQ, min(BQ, sq - q1), d);
      load_tile_async<DP, LD>(sO + stage, ob + size_t(q1) * d, BQ, min(BQ, sq - q1), d);
      cp_async_commit();
      load_stats(st ^ 1, q1);
    }

    // S^T = K Q^T and dP^T = V dO^T; [j] holds keys (g, g, g+8, g+8) x queries (8j+2t, 8j+2t+1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* qrow = sQt + (j * 8 + g) * LD + 2 * t;
      const __nv_bfloat16* orow = sOt + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_16816(s[j], ka[ks], ld32(qrow + ks * 16), ld32(qrow + ks * 16 + 8));
        mma_16816(dp[j], va[ks], ld32(orow + ks * 16), ld32(orow + ks * 16 + 8));
      }
    }

    // P^T (queries past sq give 0) into s, dS^T = P^T (dP^T - delta) into dp
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = col < qv ? exp2f(s[j][e] * scale_log2 - sLt[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sDt[col]);
      }

    // dV += P^T dO and dK += dS^T Q; P^T and dS^T rounded to bf16 as A
    // fragments, dO and Q through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans<LD>(b, sOt + kk * 16 * LD + j * 8, lane);
        mma_16816(av[j], pa, b[0], b[1]);
        mma_16816(av[j + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans<LD>(b, sQt + kk * 16 * LD + j * 8, lane);
        mma_16816(ak[j], da, b[0], b[1]);
        mma_16816(ak[j + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= sk) continue;
    __nv_bfloat16* okr = dk + (size_t(bh) * sk + key) * d;
    __nv_bfloat16* ovr = dv + (size_t(bh) * sk + key) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(okr + c) =
            __floats2bfloat162_rn(ak[j][2 * r] * scale, ak[j][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(ovr + c) =
            __floats2bfloat162_rn(av[j][2 * r], av[j][2 * r + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                          int d, float scale, cudaStream_t stream) {
  using M = MmaTile<DP>;
  auto kernel = bwd_dq_mma_kernel<DP>;
  cudaError_t err = allow_smem(kernel, M::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + M::BR - 1) / M::BR, bh);
  using B = __nv_bfloat16;
  kernel<<<grid, kThreads, M::kSmemBytes, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(dout), lse, delta, static_cast<B*>(dq), sq, sk, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int bh,
                           int sq, int sk, int d, float scale, cudaStream_t stream) {
  using M = MmaTile<DP>;
  auto kernel = bwd_dkv_mma_kernel<DP>;
  cudaError_t err = allow_smem(kernel, M::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + M::BR - 1) / M::BR, bh);
  using B = __nv_bfloat16;
  kernel<<<grid, kThreads, M::kSmemBytes, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(dout), lse, delta, static_cast<B*>(dk), static_cast<B*>(dv), sq,
      sk, d, scale);
  return cudaGetLastError();
}

bool valid_shape(int bh, int sq, int sk, int d) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && d >= 1 && d <= 512;
}

}  // namespace

// q/dout/dq (bh, sq, d), k/v (bh, sk, d): contiguous rows, all of one dtype
// (0 = float32, 1 = bfloat16); lse and delta (bh, sq) float32, lse as the
// forward wrote it. Launch on `stream` and return the launch's cudaError_t
// (0 on success); they do not synchronise.
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
      if (d <= 64 && aligned16({q, k, v, dout, dq}, d)) {
        if (d <= 16) return int(launch_dq_mma<16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
        if (d <= 32) return int(launch_dq_mma<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
        if (d <= 48) return int(launch_dq_mma<48>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
        return int(launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, s));
      }
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
      if (d <= 64 && aligned16({q, k, v, dout, dk, dv}, d)) {
        if (d <= 16) return int(launch_dkv_mma<16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
        if (d <= 32) return int(launch_dkv_mma<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
        if (d <= 48) return int(launch_dkv_mma<48>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
        return int(launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
      }
      return int(dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
