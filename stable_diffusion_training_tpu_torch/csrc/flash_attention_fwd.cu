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
// The design. Three kernels share the entry point; the input picks one.
// The two bf16 kernels are one template (`flash_fwd_tma_kernel`), warp-
// specialised: warpgroup 0 produces (setmaxnreg down to 24 or 40), the
// others consume (up to 112 or 232). One producer thread streams Q once
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
// 2. bf16, D % 8 == 0, 64 < D <= 512 (`flash_fwd_tma_kernel<DP, true>`, DP
//    = 128, 256 or 512): O for 64 rows at D = 512 is 256 f32 registers a
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
//    tiles; 384 threads, one block per SM.
// 3. CUDA cores (`flash_fwd_kernel`): everything else — f32 I/O (exact f32
//    products; TF32 would change the numerics), bf16 with D % 8 != 0 or an
//    unaligned base — for head dims up to 512. f32 FMA with both operands
//    staged in shared memory as f32. Each block owns BQ query rows of one
//    (batch*head); its four warps own BQ/4 rows each, so the row max and
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


// --- tensor-core kernels: bf16, D % 8 == 0 (TMA, wgmma, warp-specialised) ----

template <int DP, bool kWide>
struct TmaTile {
  // consumer warpgroups; warpgroup 0 produces
  static constexpr int kConsumers = kWide ? 2 : 4;
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
  static_assert(kWide ? (DP % (64 * kConsumers) == 0 && DP <= 512) : (DP % 8 == 0 && DP <= 64),
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
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::kORegs], const uint32_t (&p)[C::BK / 16][4],
                                         uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    Wgmma<C::kPvN>::rs(o, p[kk], wgmma_desc_advance(v, kk * 16 * 128), 1);
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
    // narrow: this consumer's 64 rows of Q; wide: its half of D, in Q, K and V
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
        if (d <= 16) return int(launch_tma<16, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 32) return int(launch_tma<32, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 40) return int(launch_tma<40, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 48) return int(launch_tma<48, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 64) return int(launch_tma<64, false>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 128) return int(launch_tma<128, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        if (d <= 256) return int(launch_tma<256, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
        return int(launch_tma<512, true>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
      }
      return int(dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
