// Non-local spatial attention of the 'nl' pooling, in two passes:
//
//   nl_minmax  lo, hi = min and max of q k^T over the WHOLE batch
//   nl_apply   out = softmax((q k^T - lo) / (hi - lo)) k        (no +q)
//
// q (B, N, C) holds every pixel of a feature map, k (B, M, C) its 8x8
// average pool; f32 or bf16, C = 112 (Res2Fusion's attention, the only
// channel count built; add instances when a model needs another). Replaces
// multi_modal_image_fusion_tpu/ops/pallas/nl_kernel.py:132 nl_spatial_flash
// (pallas_calls at :160, _nl_minmax_kernel :58, and :183, _nl_apply_kernel
// :102). Like the TPU kernel, neither pass writes the (N, M) energy matrix to
// device memory, and pass 2 uses that the normalised energies lie in [0, 1]:
// exp() cannot overflow, so acc += p k and l += sum p need no running max or
// rescaling, and there is one divide at the end. The TPU kernel's grid-
// resident min/max does not carry over (blocks run in no order): each block
// of pass 1 writes its own (min, max) and a one-block kernel of the same
// launch reduces them; pass 2 reads the result from device memory, so no
// value goes through the host. The ragged last query rows and keys are
// masked.
//
// What bounds each pass on an H100 (bf16, the Res2Fusion bench's nl call:
// B = 2, N = 1,253,376, M = 19,584):
// - MMA: q k^T is 2 N M C = 5.5 TFLOP an image. Pass 1 does it once (11.1
//   ms for the batch at 989 TFLOP/s), pass 2 twice, adding p k (22.2 ms).
// - The SFU: pass 2 takes B N M = 4.9e10 exps; at 16 ex2 a clock an SM
//   that is ~12-13 ms, over half the MMA time, so it has to run beside the
//   products. Pass 1's min and max are 2 FP32 operations a score (~3-6 ms).
// - L2: every block streams all of its image's k (4.39 MB). A block of R
//   query rows makes that B N / R times a call: 172 GB at 64 rows (the
//   mma.sync design before this one), 86 GB at pass 2's 128 rows, 43 GB at
//   pass 1's 256; at an L2 rate of ~5.5 TB/s (published microbenchmarks,
//   not measured here) 15.6 and 7.8 ms, under each pass's MMA time.
// The f32 instances run every product as FMAs on the CUDA cores (67
// TFLOP/s), exact f32 as the JAX package's precision="float32" einsums: a
// block owns 64 query rows and streams k through shared memory in tiles of
// 64 keys, both staged c-major; a thread holds a 4x4 tile of energies and
// in pass 2 4 rows x C/16 columns of the accumulator.
//
// The bf16 design (FlashAttention-3's layout, Shah et al. 2024):
// - k is repacked once by the wrapper (ops/cuda/nl_attention.py pack_keys)
//   into wgmma's no-swizzle core matrices, kp[b][m / 8][c / 8][m % 8][c % 8]
//   (8 keys x 8 channels, 128 contiguous bytes), zero keys up to a multiple
//   of 64, so a tile of 64 keys is 14,336 contiguous bytes: one bulk copy
//   (cp.async.bulk) completing on an mbarrier. That was preferred to TMA
//   tensor maps: no cuTensorMapEncodeTiled from libcuda, which the library
//   does not link; no 128-byte swizzle box split in two for 224-byte rows;
//   and the same staged bytes serve both products through descriptors.
// - A block is one producer warpgroup (one thread issues the copies into a
//   ring of 4 tiles; setmaxnreg gives its registers away: 24 a thread) and
//   two consumer warpgroups (240 registers a thread).
// - One staged tile is the K-major B of q k^T (N = 64 keys, K = C in 7
//   k-steps) and the MN-major (transposed) B of p k (K = 64 keys in 4
//   k-steps, N = 112 channels). q is loaded once and held as the register A
//   of q k^T (28 registers a thread for 64 rows); the score accumulators,
//   exponentiated and rounded to bf16 pairs, are the register A of p k
//   (their layout is the A layout), so p never goes to shared memory.
// - Pass 1: 256 rows a block, each consumer two m64 tiles; it issues both
//   tiles' scores and folds the first into per-register running minima and
//   maxima while the second is on the tensor cores.
// - Pass 2: 128 rows a block, one m64 tile a consumer. Each round issues the
//   scores of tile j + 1, then the value product of tile j, and takes the
//   weights of tile j + 1 while that product runs: p = 2^(s a + b) with a
//   = log2(e) / (hi - lo), b = -lo a set once, one FMA and one ex2 a score.
//   The row sums add the f32 p, the value product takes p rounded to bf16,
//   as the TPU kernel (nl_kernel.py:116-120). Only the last tile is masked.
// - Both passes: the two consumers take turns issuing their products
//   (named barriers), so one consumer's folds or exps run while the
//   other's products occupy the tensor cores.
// Tried and not kept (times: python -m multi_modal_image_fusion_tpu_torch.
// nl_variants, the bench's nl call, an H100 80GB HBM3 at 700 W, 3 runs
// each; the committed kernels ran nl_minmax 15.3-17.8 ms, nl_apply
// 29.6-33.0 ms):
// - the design before this one: mma.sync m16n8k16 in 64-row blocks of 4
//   warps, each key tile staged with 4-byte loads between two
//   __syncthreads, the exps and folds in the same warps as the MMAs with
//   nothing overlapped (81.52 and 128.40 ms, chip_smoke.py, same card);
// - a ring of 2 tiles: nl_apply 41.4-41.8 ms; 3, 6 or 8 tiles: within the
//   spread of 4 (8 slower in some runs);
// - nl_apply waiting for its value product before the next tile's exps:
//   32.1-33.0 ms;
// - consumers that issue without taking turns: within the spread (the
//   turns stay, the design's way of keeping one consumer's exps beside the
//   other's products; they cost nothing measurable);
// - the weights rounded into the A registers while the value product runs,
//   and a round whose score product was issued under a branch: ptxas then
//   serializes the wgmmas (C7513, C7520). The weights are packed after the
//   product's wait and the last round is peeled.
// Not tried: a cluster of 2 with multicast of the key tiles (it would
// halve the L2 bytes again); 128-key tiles (N = 128 products; the
// registers of two score tiles and the weights pass 240 a thread).
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

constexpr int NL_BQ = 64;          // query rows a block
constexpr int NL_BK = 64;          // keys a tile
constexpr int NL_C = 112;          // channels (the one instance built)
constexpr int NL_THREADS = 256;    // 16 x 16 threads, 4 x 4 energies each
constexpr int NL_PT = NL_BQ + 4;   // pitch (floats) of the c-major tiles
constexpr int NL_RED_THREADS = 1024;

// Rows [r0, r0 + 64) of a (rows, C) matrix into the c-major tile t[c][r],
// zeros past `rows`.
__device__ __forceinline__ void stage_cmajor(float* t, const float* src, int r0, int rows,
                                             int C) {
  for (int idx = threadIdx.x; idx < NL_BQ * C; idx += NL_THREADS) {
    const int r = idx / C, c = idx - r * C;
    const int gr = r0 + r;
    t[c * NL_PT + r] = gr < rows ? src[(size_t)gr * C + c] : 0.f;
  }
}

// s[i][j] = q[tr*4+i] . k[tc*4+j] over the real C channels.
__device__ __forceinline__ void tile_scores(const float* qt, const float* kt, int C, int tr,
                                            int tc, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(qt + c * NL_PT + tr * 4);
    const float4 b = *reinterpret_cast<const float4*>(kt + c * NL_PT + tc * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Block-wide (min, max) of every thread's (lo, hi); valid in thread 0.
template <int THREADS>
__device__ __forceinline__ float2 block_minmax(float lo, float hi) {
  __shared__ float red_lo[THREADS / 32], red_hi[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      lo = fminf(lo, red_lo[w]);
      hi = fmaxf(hi, red_hi[w]);
    }
  }
  return make_float2(lo, hi);
}

// Pass 1 (f32): the (min, max) of one block's 64 query rows against all of k.
__global__ void __launch_bounds__(NL_THREADS)
nl_minmax_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 float2* __restrict__ part, int N, int M, int C) {
  extern __shared__ float4 nl_smem4[];
  float* qt = reinterpret_cast<float*>(nl_smem4);  // [C][NL_PT]
  float* kt = qt + C * NL_PT;                       // [C][NL_PT]
  const int b = blockIdx.y, q0 = blockIdx.x * NL_BQ;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float* kb = k + (size_t)b * M * C;
  stage_cmajor(qt, q + (size_t)b * N * C, q0, N, C);
  float lo = INFINITY, hi = -INFINITY;
  for (int m0 = 0; m0 < M; m0 += NL_BK) {
    __syncthreads();  // the previous tile is consumed
    stage_cmajor(kt, kb, m0, M, C);
    __syncthreads();
    float s[4][4];
    tile_scores(qt, kt, C, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + tr * 4 + i < N && m0 + tc * 4 + j < M) {
          lo = fminf(lo, s[i][j]);
          hi = fmaxf(hi, s[i][j]);
        }
  }
  const float2 r = block_minmax<NL_THREADS>(lo, hi);
  if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = r;
}

// Pass 1's second kernel: the batch-global (min, max) of the blocks' partials.
__global__ void __launch_bounds__(NL_RED_THREADS)
nl_reduce_kernel(const float2* __restrict__ part, int n, float* __restrict__ lohi) {
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < n; i += NL_RED_THREADS) {
    const float2 p = part[i];
    lo = fminf(lo, p.x);
    hi = fmaxf(hi, p.y);
  }
  const float2 r = block_minmax<NL_RED_THREADS>(lo, hi);
  if (threadIdx.x == 0) {
    lohi[0] = r.x;
    lohi[1] = r.y;
  }
}

// Pass 2 (f32): 64 output rows of softmax((q k^T - lo) / (hi - lo)) k. CJ = C / 16
// output columns a thread (tc, tc + 16, ...).
__global__ void __launch_bounds__(NL_THREADS, 2)
nl_apply_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ lohi, float* __restrict__ out, int N, int M, int C) {
  constexpr int CJ = NL_C / 16;
  constexpr int KR = CJ * 16;  // pitch of the key-major tile
  extern __shared__ float4 nl_smem4[];
  float* qt = reinterpret_cast<float*>(nl_smem4);  // [C][NL_PT]
  float* kt = qt + C * NL_PT;                       // [C][NL_PT]
  float* kr = kt + C * NL_PT;                       // [NL_BK][KR]
  float* pt = kr + NL_BK * KR;                      // [NL_BK][NL_PT], p transposed
  const int b = blockIdx.y, q0 = blockIdx.x * NL_BQ;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float* kb = k + (size_t)b * M * C;
  const float lo = lohi[0];
  const float inv = 1.f / (lohi[1] - lohi[0]);  // hi == lo gives NaN, as in JAX
  stage_cmajor(qt, q + (size_t)b * N * C, q0, N, C);

  float o[4][CJ], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) o[i][jj] = 0.f;
  }
  for (int m0 = 0; m0 < M; m0 += NL_BK) {
    __syncthreads();  // the previous tile is consumed
    stage_cmajor(kt, kb, m0, M, C);
    for (int idx = threadIdx.x; idx < NL_BK * KR; idx += NL_THREADS) {
      const int j = idx / KR, c = idx - j * KR;
      const int gj = m0 + j;
      kr[idx] = (gj < M && c < C) ? kb[(size_t)gj * C + c] : 0.f;
    }
    __syncthreads();
    float s[4][4];
    tile_scores(qt, kt, C, tr, tc, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = m0 + tc * 4 + j < M;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ok ? __expf((s[i][j] - lo) * inv) : 0.f;
        l[i] += p[i];
      }
      *reinterpret_cast<float4*>(pt + (tc * 4 + j) * NL_PT + tr * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    const int keys = min(NL_BK, M - m0);
    for (int j = 0; j < keys; ++j) {
      const float4 pv4 = *reinterpret_cast<const float4*>(pt + j * NL_PT + tr * 4);
      const float pv[4] = {pv4.x, pv4.y, pv4.z, pv4.w};
      const float* krow = kr + j * KR + tc;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const float kv = krow[16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pv[i], kv, o[i][jj]);
      }
    }
  }
  // a row's 16 partial sums sit in the 16 lanes of one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  float* ob = out + (size_t)b * N * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= N) continue;
    const float r = 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int c = tc + 16 * jj;
      if (c < C) ob[(size_t)row * C + c] = o[i][jj] * r;
    }
  }
}

// ---- bf16: warp-specialised wgmma kernels fed by a ring of key tiles ----

constexpr int NL_KT = 64;                          // keys a staged tile
constexpr int NL_CK = NL_C / 16;                   // k-steps of q k^T (channels)
constexpr int NL_PK = NL_KT / 16;                  // k-steps of p k (keys)
constexpr int NL_GROUP_BYTES = NL_C / 8 * 128;     // 8 keys x 112 channels: 1792
constexpr int NL_TILE_BYTES = NL_KT / 8 * NL_GROUP_BYTES;  // 14,336
constexpr int NL_STAGES = 4;                       // tiles in the ring
constexpr int NL_WS_THREADS = 384;                 // producer + 2 consumer warpgroups
constexpr int NL_CONSUMERS = 256;
constexpr int NL_MINMAX_ROWS = 256;                // query rows a block, pass 1
constexpr int NL_APPLY_ROWS = 128;                 // pass 2
constexpr size_t NL_WS_SMEM = NL_STAGES * NL_TILE_BYTES + 2 * NL_STAGES * 8 + 8 * 2 * 4;
constexpr float NL_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The register A fragments of q for rows r0 (this lane's g) and r0 + 8 of a
// warp's 16: k-step kk holds channels 16kk..16kk+15. Rows past N are zero.
__device__ __forceinline__ void load_q_ra(const uint32_t* q32, int r0, int N, int t,
                                          uint32_t (&qa)[NL_CK][4]) {
  const uint32_t* p0 = q32 + (size_t)r0 * (NL_C / 2) + t;
  const uint32_t* p1 = p0 + 8 * (NL_C / 2);
  const bool ok0 = r0 < N, ok1 = r0 + 8 < N;
#pragma unroll
  for (int kk = 0; kk < NL_CK; ++kk) {
    qa[kk][0] = ok0 ? p0[8 * kk] : 0u;
    qa[kk][1] = ok1 ? p1[8 * kk] : 0u;
    qa[kk][2] = ok0 ? p0[8 * kk + 4] : 0u;
    qa[kk][3] = ok1 ? p1[8 * kk + 4] : 0u;
  }
}

// S = q k^T for one staged tile: 7 k-steps of m64n64k16, B the tile read
// K-major (leading byte offset: the next 8 channels, 128 bytes; stride byte
// offset: the next 8 keys, one key group). Issued, not waited for.
__device__ __forceinline__ void issue_scores(float (&s)[32], const uint32_t (&qa)[NL_CK][4],
                                             uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < NL_CK; ++kk)
    wgmma_bf16_ra<64, 0>(s, qa[kk], wgmma_desc(tile + kk * 256, 128, NL_GROUP_BYTES), kk);
}

// O += P k for one staged tile: 4 k-steps (16 keys each) of m64n112k16, B
// the same tile read MN-major (leading byte offset: the next 8 keys, one key
// group; stride byte offset: the next 8 channels, 128 bytes).
__device__ __forceinline__ void issue_values(float (&o)[NL_C / 2], const uint32_t (&pa)[NL_PK][4],
                                             uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < NL_PK; ++kk)
    wgmma_bf16_ra<NL_C, 1>(o, pa[kk], wgmma_desc(tile + kk * 2 * NL_GROUP_BYTES,
                                                 NL_GROUP_BYTES, 128), 1);
}

// The producer: one thread fills the ring with the image's tiles of packed
// keys, each one contiguous bulk copy, as the consumers free the stages.
__device__ __forceinline__ void produce_tiles(const uint8_t* src, int T, uint32_t tiles,
                                              uint32_t full, uint32_t empty) {
  for (int j = 0; j < T; ++j) {
    const int s = j % NL_STAGES;
    if (j >= NL_STAGES) mbar_wait(empty + 8 * s, ((j / NL_STAGES) - 1) & 1);
    mbar_arrive_expect_tx(full + 8 * s, NL_TILE_BYTES);
    bulk_copy_g2s(tiles + s * NL_TILE_BYTES, src + (size_t)j * NL_TILE_BYTES, NL_TILE_BYTES,
                  full + 8 * s);
  }
}

// The block's shared memory: the ring, then the full and empty barriers of
// each stage (full: the producer's one arrival and the tile's bytes; empty:
// all 256 consumer threads), initialised before the warpgroups part.
__device__ __forceinline__ uint32_t init_ring(uint8_t* smem) {
  const uint32_t tiles = smem_u32(smem);
  const uint32_t full = tiles + NL_STAGES * NL_TILE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NL_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(full + 8 * (NL_STAGES + s), NL_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return tiles;
}

// Pass 1's fold of one 64 x 64 score tile into a thread's running minima and
// maxima (one per accumulator register, so the folds do not chain). MASK:
// rows past N (row0 / row1 false) and keys past M (8j + e % 2 >= kvalid,
// kvalid = the tile's real keys less 2 (lane % 4)) take no part.
template <bool MASK>
__device__ __forceinline__ void fold_minmax(const float (&s)[32], float (&lo)[32], float (&hi)[32],
                                            bool row0, bool row1, int kvalid) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      if (MASK) {
        const bool ok = (e < 2 ? row0 : row1) && 8 * j + (e & 1) < kvalid;
        lo[i] = fminf(lo[i], ok ? s[i] : INFINITY);
        hi[i] = fmaxf(hi[i], ok ? s[i] : -INFINITY);
      } else {
        lo[i] = fminf(lo[i], s[i]);
        hi[i] = fmaxf(hi[i], s[i]);
      }
    }
}

// Pass 1: the (min, max) of q k^T over one block's 256 query rows and all
// of the image's keys. Warpgroup 0 produces; consumer warpgroup c owns rows
// 128c..128c+127 as two m64 tiles, issues both tiles' scores on a staged key
// tile and folds the first while the second is on the tensor cores; the two
// consumers take turns issuing (named barriers 1 and 2), so one folds while
// the other's products run.
__global__ void __launch_bounds__(NL_WS_THREADS, 1)
nl_minmax_ws_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    float2* __restrict__ part, int N, int M) {
  extern __shared__ __align__(128) uint8_t nl_ws_smem[];
  const uint32_t tiles = init_ring(nl_ws_smem);
  const uint32_t full = tiles + NL_STAGES * NL_TILE_BYTES, empty = full + 8 * NL_STAGES;
  const int b = blockIdx.y, T = (M + NL_KT - 1) / NL_KT, wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      produce_tiles(reinterpret_cast<const uint8_t*>(kp) + (size_t)b * T * NL_TILE_BYTES, T,
                    tiles, full, empty);
    return;
  }
  setmaxnreg_inc<240>();
  const int c = wg - 1, tid = threadIdx.x % 128, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int base = blockIdx.x * NL_MINMAX_ROWS + 128 * c + 16 * w + g;  // m-tile 0, row g
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + (size_t)b * N * NL_C);
  uint32_t qa[2][NL_CK][4];
  load_q_ra(q32, base, N, t, qa[0]);
  load_q_ra(q32, base + 64, N, t, qa[1]);
  const bool rows_full = blockIdx.x * NL_MINMAX_ROWS + 128 * (c + 1) <= N;
  const bool ok[4] = {base < N, base + 8 < N, base + 64 < N, base + 72 < N};
  const int klast = M - (T - 1) * NL_KT - 2 * t;
  const bool ragged = M % NL_KT != 0;
  float lo[32], hi[32], sa[32], sb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    lo[i] = INFINITY;
    hi[i] = -INFINITY;
  }
  const int me = 1 + c, other = 2 - c;
  if (c == 1) named_bar_arrive(1, NL_CONSUMERS);  // consumer 0 issues first
  for (int j = 0; j < T; ++j) {
    const int s = j % NL_STAGES;
    const uint32_t tile = tiles + s * NL_TILE_BYTES;
    named_bar_sync(me, NL_CONSUMERS);
    mbar_wait(full + 8 * s, (j / NL_STAGES) & 1);
    wgmma_fence();
    issue_scores(sa, qa[0], tile);
    wgmma_commit();
    issue_scores(sb, qa[1], tile);
    wgmma_commit();
    if (c == 0 || j + 1 < T) named_bar_arrive(other, NL_CONSUMERS);
    const bool mask = !rows_full || (ragged && j == T - 1);
    const int kvalid = j == T - 1 ? klast : NL_KT;
    wgmma_wait<1>();
    fence_acc(sa);
    if (mask) fold_minmax<true>(sa, lo, hi, ok[0], ok[1], kvalid);
    else fold_minmax<false>(sa, lo, hi, true, true, kvalid);
    wgmma_wait<0>();
    fence_acc(sb);
    mbar_arrive(empty + 8 * s);
    if (mask) fold_minmax<true>(sb, lo, hi, ok[2], ok[3], kvalid);
    else fold_minmax<false>(sb, lo, hi, true, true, kvalid);
  }
#pragma unroll
  for (int i = 1; i < 32; ++i) {
    lo[0] = fminf(lo[0], lo[i]);
    hi[0] = fmaxf(hi[0], hi[i]);
  }
  float l = lo[0], h = hi[0];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l = fminf(l, __shfl_xor_sync(0xffffffffu, l, off));
    h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
  }
  float* red = reinterpret_cast<float*>(nl_ws_smem + NL_STAGES * NL_TILE_BYTES +
                                        2 * NL_STAGES * 8);  // [8 warps][2]
  const int cw = 4 * c + w;
  if (tid % 32 == 0) {
    red[2 * cw] = l;
    red[2 * cw + 1] = h;
  }
  named_bar_sync(3, NL_CONSUMERS);
  if (c == 0 && tid == 0) {
    for (int i = 1; i < 8; ++i) {
      l = fminf(l, red[2 * i]);
      h = fmaxf(h, red[2 * i + 1]);
    }
    part[(size_t)b * gridDim.x + blockIdx.x] = make_float2(l, h);
  }
}

// Pass 2's weights of one 64 x 64 score tile: p = 2^(s a + b) = exp((s -
// lo) / (hi - lo)), zero for keys past M (MASK; kvalid as in fold_minmax),
// in f32, summed into the row sums l0 (row g) and l1 (row g + 8).
template <bool MASK>
__device__ __forceinline__ void tile_weights(const float (&s)[32], float a, float bb, int kvalid,
                                             float& l0, float& l1, float (&p)[32]) {
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[4 * j + e] = ex2_approx(fmaf(s[4 * j + e], a, bb));
      if (MASK && 8 * j + (e & 1) >= kvalid) p[4 * j + e] = 0.f;
    }
    r0 += p[4 * j] + p[4 * j + 1];
    r1 += p[4 * j + 2] + p[4 * j + 3];
  }
  l0 += r0;
  l1 += r1;
}

// The weights rounded to bf16 as the register A of the value product (the
// TPU kernel's rounding: the unnormalised weights; the sums stay f32).
// Called only while no MMA is in flight: a register that an MMA takes,
// written between the issue and the wait of another, makes ptxas serialize
// the MMAs.
__device__ __forceinline__ void pack_weights(const float (&p)[32], uint32_t (&pa)[NL_PK][4]) {
#pragma unroll
  for (int kk = 0; kk < NL_PK; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
    fence_regs(pa[kk]);
  }
}

// Pass 2: 128 output rows of softmax((q k^T - lo) / (hi - lo)) k. Warpgroup 0
// produces; consumer c owns rows 64c..64c+63. Each round issues the scores
// of tile j + 1 and then the value product of tile j (whose weights are in
// registers), takes the weights of tile j + 1 while that product runs, and
// frees tile j once it is done; the two consumers take turns issuing, so one
// takes its exps while the other's products run.
__global__ void __launch_bounds__(NL_WS_THREADS, 1)
nl_apply_ws_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                   const float* __restrict__ lohi, __nv_bfloat16* __restrict__ out, int N, int M) {
  extern __shared__ __align__(128) uint8_t nl_ws_smem[];
  const uint32_t tiles = init_ring(nl_ws_smem);
  const uint32_t full = tiles + NL_STAGES * NL_TILE_BYTES, empty = full + 8 * NL_STAGES;
  const int b = blockIdx.y, T = (M + NL_KT - 1) / NL_KT, wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      produce_tiles(reinterpret_cast<const uint8_t*>(kp) + (size_t)b * T * NL_TILE_BYTES, T,
                    tiles, full, empty);
    return;
  }
  setmaxnreg_inc<240>();
  const int c = wg - 1, tid = threadIdx.x % 128, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int row0 = blockIdx.x * NL_APPLY_ROWS + 64 * c + 16 * w + g, row1 = row0 + 8;
  uint32_t qa[NL_CK][4];
  load_q_ra(reinterpret_cast<const uint32_t*>(q + (size_t)b * N * NL_C), row0, N, t, qa);
  const float lo = lohi[0];
  const float a = NL_LOG2E / (lohi[1] - lo);  // hi == lo gives NaN, as in JAX
  const float bb = -lo * a;
  const int klast = M - (T - 1) * NL_KT - 2 * t;
  const bool ragged = M % NL_KT != 0;
  float o[NL_C / 2], s[32];
#pragma unroll
  for (int i = 0; i < NL_C / 2; ++i) o[i] = 0.f;
  fence_acc(o);
  float l0 = 0.f, l1 = 0.f;
  float p[32];
  uint32_t pa[NL_PK][4];
  const int me = 1 + c, other = 2 - c;
  if (c == 1) named_bar_arrive(1, NL_CONSUMERS);  // consumer 0 issues first

  named_bar_sync(me, NL_CONSUMERS);  // round 0: the scores of tile 0
  mbar_wait(full, 0);
  wgmma_fence();
  issue_scores(s, qa, tiles);
  wgmma_commit();
  named_bar_arrive(other, NL_CONSUMERS);
  wgmma_wait<0>();
  fence_acc(s);
  if (ragged && T == 1) tile_weights<true>(s, a, bb, klast, l0, l1, p);
  else tile_weights<false>(s, a, bb, NL_KT, l0, l1, p);
  pack_weights(p, pa);

  for (int j = 0; j + 1 < T; ++j) {  // rounds 1..T-1
    const int sj = j % NL_STAGES, sn = (j + 1) % NL_STAGES;
    named_bar_sync(me, NL_CONSUMERS);
    mbar_wait(full + 8 * sn, ((j + 1) / NL_STAGES) & 1);
    wgmma_fence();
    issue_scores(s, qa, tiles + sn * NL_TILE_BYTES);
    wgmma_commit();
    issue_values(o, pa, tiles + sj * NL_TILE_BYTES);
    wgmma_commit();
    named_bar_arrive(other, NL_CONSUMERS);
    wgmma_wait<1>();
    fence_acc(s);
    if (ragged && j + 2 == T) tile_weights<true>(s, a, bb, klast, l0, l1, p);
    else tile_weights<false>(s, a, bb, NL_KT, l0, l1, p);
    wgmma_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < NL_PK; ++kk) fence_regs(pa[kk]);
    mbar_arrive(empty + 8 * sj);
    pack_weights(p, pa);
  }
  named_bar_sync(me, NL_CONSUMERS);  // round T: the value product of the last tile
  wgmma_fence();
  issue_values(o, pa, tiles + ((T - 1) % NL_STAGES) * NL_TILE_BYTES);
  wgmma_commit();
  if (c == 0) named_bar_arrive(other, NL_CONSUMERS);
  wgmma_wait<0>();
  fence_acc(o);
  // a row's partial sums sit in the 4 lanes of one quad
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out + (size_t)b * N * NL_C);
#pragma unroll
  for (int n = 0; n < NL_C / 8; ++n) {
    const int wd = 4 * n + t;  // 32-bit word of channels 8n + 2t, 8n + 2t + 1
    if (row0 < N) o32[(size_t)row0 * (NL_C / 2) + wd] = pack_bf16(o[4 * n] * r0, o[4 * n + 1] * r0);
    if (row1 < N)
      o32[(size_t)row1 * (NL_C / 2) + wd] = pack_bf16(o[4 * n + 2] * r1, o[4 * n + 3] * r1);
  }
}

// ---- launchers ----

// Pass 1's second kernel, on pass 1's stream.
int launch_reduce(const void* part, int n, float* lohi, cudaStream_t stream) {
  nl_reduce_kernel<<<1, NL_RED_THREADS, 0, stream>>>(static_cast<const float2*>(part), n, lohi);
  return (int)cudaGetLastError();
}

int minmax_f32(const void* q, const void* k, void* part, float* lohi, int B, int N, int M,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * NL_C * NL_PT;
  cudaError_t err = cudaFuncSetAttribute(
      nl_minmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_BQ - 1) / NL_BQ, B);
  nl_minmax_kernel<<<grid, NL_THREADS, smem, stream>>>(static_cast<const float*>(q),
                                                       static_cast<const float*>(k),
                                                       static_cast<float2*>(part), N, M, NL_C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part, (int)grid.x * B, lohi, stream);
}

int apply_f32(const void* q, const void* k, const float* lohi, void* out, int B, int N, int M,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * NL_C * NL_PT + NL_BK * NL_C + NL_BK * NL_PT);
  cudaError_t err = cudaFuncSetAttribute(
      nl_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_BQ - 1) / NL_BQ, B);
  nl_apply_kernel<<<grid, NL_THREADS, smem, stream>>>(static_cast<const float*>(q),
                                                      static_cast<const float*>(k), lohi,
                                                      static_cast<float*>(out), N, M, NL_C);
  return (int)cudaGetLastError();
}

int minmax_bf16(const void* q, const void* kp, void* part, float* lohi, int B, int N, int M,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nl_minmax_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)NL_WS_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_MINMAX_ROWS - 1) / NL_MINMAX_ROWS, B);
  nl_minmax_ws_kernel<<<grid, NL_WS_THREADS, NL_WS_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<float2*>(part), N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part, (int)grid.x * B, lohi, stream);
}

int apply_bf16(const void* q, const void* kp, const float* lohi, void* out, int B, int N, int M,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nl_apply_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)NL_WS_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_APPLY_ROWS - 1) / NL_APPLY_ROWS, B);
  nl_apply_ws_kernel<<<grid, NL_WS_THREADS, NL_WS_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp), lohi,
      static_cast<__nv_bfloat16*>(out), N, M);
  return (int)cudaGetLastError();
}

bool nl_shapes_ok(int B, int N, int M, int C) {
  return B >= 1 && B <= 65535 && N >= 1 && M >= 1 && C == NL_C;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// q (B, N, C) contiguous, C = 112, dtype 0 = f32, 1 = bf16; k (B, M, C)
// contiguous in f32, in bf16 packed into core matrices (ops/cuda/
// nl_attention.py pack_keys: kp[b][m / 8][c / 8][m % 8][c % 8], M rounded up
// to 64 keys with zeros). part: scratch of B * ceil(N / 64) float2; lohi: 2
// f32, written (min, max) of q k^T.
int mmif_nl_minmax(int dtype, const void* q, const void* k, void* part, float* lohi, int B,
                   int N, int M, int C, void* stream) {
  if (!nl_shapes_ok(B, N, M, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return minmax_f32(q, k, part, lohi, B, N, M, s);
  if (dtype == DT_BF16) return minmax_bf16(q, k, part, lohi, B, N, M, s);
  return (int)cudaErrorInvalidValue;
}

// out (B, N, C) in q's dtype = softmax((q k^T - lohi[0]) / (lohi[1] - lohi[0])) k;
// q and k as for mmif_nl_minmax.
int mmif_nl_apply(int dtype, const void* q, const void* k, const float* lohi, void* out, int B,
                  int N, int M, int C, void* stream) {
  if (!nl_shapes_ok(B, N, M, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return apply_f32(q, k, lohi, out, B, N, M, s);
  if (dtype == DT_BF16) return apply_bf16(q, k, lohi, out, B, N, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
