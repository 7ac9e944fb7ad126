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
// device memory: each tile of energies lives in registers and shared memory.
// And like it, pass 2 uses that normalised energies lie in [0, 1]: exp()
// cannot overflow, so acc += exp(s) k and l += sum exp(s) need no running
// max or rescaling, and there is one divide at the end.
//
// What bounds it on an H100: operations. At 1224x1024 (N = 1,253,376,
// M = 19,584, C = 112) q k^T is 5.5 TFLOP an image; pass 1 does it once,
// pass 2 does it again and adds p k, and the inputs are ~0.3 GB. Two designs,
// one a dtype:
//
// - f32: every product as f32 FMAs on the CUDA cores (67 TFLOP/s peak), so
//   the f32 path is exact f32 as the JAX package's precision="float32"
//   einsums. A block owns 64 query rows and streams k through shared
//   memory in tiles of 64 keys; a thread holds a 4x4 tile of energies and,
//   in pass 2, 4 rows x C/16 columns of the output accumulator. Both tiles
//   are staged c-major (transposed) so the score loop reads float4s; pass 2
//   also stages k key-major for the value product.
// - bf16: both products on the tensor cores with warp-level mma.sync
//   m16n8k16 (bf16 in, f32 accumulate). A block of 4 warps owns 64 query
//   rows, 16 a warp, their q fragments held in registers; each 64-key tile
//   of k is staged once, key-major, and read as
//   the B operand of q k^T with 32-bit loads and of p k with ldmatrix.trans.
//   The energies stay in the mma accumulators: exp() is taken in place and
//   the same registers, rounded to bf16 (as the TPU kernel casts the
//   unnormalised weights), are the A operand of p k (the FlashAttention-2
//   register reuse). The row sums stay f32. The pitch of the staged tiles,
//   C + 8 values, keeps the fragment loads free of bank conflicts.
//
// A wgmma/TMA pipeline is a later redesign.
//
// The TPU kernel's grid-resident min/max accumulator does not carry over:
// blocks run in no order here. Each block of pass 1 writes its own (min, max)
// and a second, one-block kernel of the same launch reduces them; pass 2
// reads the result from device memory, so nothing goes back to the host. C
// is not padded to 128 lanes: the score loop runs over the real C and the
// ragged query rows and keys of the last tiles are masked.
#include <cstdint>

#include "common.cuh"

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

// ---- bf16 on the tensor cores (mma.sync m16n8k16) ----

constexpr int NL_MMA_THREADS = 128;  // 4 warps x 16 query rows

// Rows [r0, r0 + 64) of a (rows, C) bf16 matrix into t[r][0..C) (pitch C + 8),
// zeros past `rows`, as 32-bit words.
__device__ __forceinline__ void stage_rows_bf16(uint32_t* t, const __nv_bfloat16* src, int r0,
                                                int rows, int C) {
  const int cw = C / 2, pw = cw + 4;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
  for (int idx = threadIdx.x; idx < NL_BQ * cw; idx += NL_MMA_THREADS) {
    const int r = idx / cw, w = idx - r * cw;
    const int gr = r0 + r;
    t[r * pw + w] = gr < rows ? s32[(size_t)gr * cw + w] : 0u;
  }
}

// A warp's 16 x 64 energies q k^T of the staged tiles: s[j] is the mma
// accumulator of keys 8j..8j+7 (rows g, g + 8; keys 2t, 2t + 1).
template <int CK>
__device__ __forceinline__ void mma_scores(const uint32_t (&qa)[CK][4], const uint32_t* ks,
                                           int pw, int g, int t, float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t* krow = ks + (8 * j + g) * pw + t;
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) mma_bf16(s[j], qa[kk], krow[8 * kk], krow[8 * kk + 4]);
  }
}

// q fragments of a warp's 16 rows (A operand, row-major), CK = C / 16 k-steps.
template <int CK>
__device__ __forceinline__ void load_q_frags(const uint32_t* qs, int pw, int row, int t,
                                             uint32_t (&qa)[CK][4]) {
#pragma unroll
  for (int kk = 0; kk < CK; ++kk) {
    const uint32_t* r0 = qs + row * pw + 8 * kk + t;
    const uint32_t* r1 = r0 + 8 * pw;
    qa[kk][0] = r0[0];
    qa[kk][1] = r1[0];
    qa[kk][2] = r0[4];
    qa[kk][3] = r1[4];
  }
}

__global__ void __launch_bounds__(NL_MMA_THREADS)
nl_minmax_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     float2* __restrict__ part, int N, int M) {
  constexpr int C = NL_C, CK = C / 16, PW = C / 2 + 4;
  extern __shared__ float4 nl_smem4[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(nl_smem4);  // [64][PW]
  uint32_t* ks = qs + NL_BQ * PW;                         // [64][PW]
  const int b = blockIdx.y, q0 = blockIdx.x * NL_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * M * C;
  stage_rows_bf16(qs, q + (size_t)b * N * C, q0, N, C);
  __syncthreads();
  uint32_t qa[CK][4];
  load_q_frags<CK>(qs, PW, warp * 16 + g, t, qa);
  const bool row0_ok = q0 + warp * 16 + g < N, row1_ok = q0 + warp * 16 + g + 8 < N;
  float lo = INFINITY, hi = -INFINITY;
  for (int m0 = 0; m0 < M; m0 += NL_BK) {
    __syncthreads();  // the previous tile is consumed
    stage_rows_bf16(ks, kb, m0, M, C);
    __syncthreads();
    float s[8][4];
    mma_scores<CK>(qa, ks, PW, g, t, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = m0 + 8 * j + 2 * t + (e & 1) < M && (e < 2 ? row0_ok : row1_ok);
        if (ok) {
          lo = fminf(lo, s[j][e]);
          hi = fmaxf(hi, s[j][e]);
        }
      }
  }
  const float2 r = block_minmax<NL_MMA_THREADS>(lo, hi);
  if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = r;
}

__global__ void __launch_bounds__(NL_MMA_THREADS)
nl_apply_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const float* __restrict__ lohi, __nv_bfloat16* __restrict__ out, int N,
                    int M) {
  constexpr int C = NL_C, CK = C / 16, PW = C / 2 + 4, CN = C / 8;
  extern __shared__ float4 nl_smem4[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(nl_smem4);  // [64][PW]
  uint32_t* ks = qs + NL_BQ * PW;                         // [64][PW]
  const __nv_bfloat16* ks16 = reinterpret_cast<const __nv_bfloat16*>(ks);
  const int b = blockIdx.y, q0 = blockIdx.x * NL_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * M * C;
  const float lo = lohi[0];
  const float inv = 1.f / (lohi[1] - lohi[0]);  // hi == lo gives NaN, as in JAX
  stage_rows_bf16(qs, q + (size_t)b * N * C, q0, N, C);
  __syncthreads();
  uint32_t qa[CK][4];
  load_q_frags<CK>(qs, PW, warp * 16 + g, t, qa);

  float o[CN][4];
#pragma unroll
  for (int n = 0; n < CN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int m0 = 0; m0 < M; m0 += NL_BK) {
    __syncthreads();  // the previous tile is consumed
    stage_rows_bf16(ks, kb, m0, M, C);
    __syncthreads();
    float s[8][4];
    mma_scores<CK>(qa, ks, PW, g, t, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = m0 + 8 * j + 2 * t + (e & 1) < M ? __expf((s[j][e] - lo) * inv) : 0.f;
        s[j][e] = p;
        if (e < 2) l0 += p; else l1 += p;
      }
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // 16 keys a k-step
      const uint32_t pa[4] = {pack_bf16(s[2 * m][0], s[2 * m][1]),
                              pack_bf16(s[2 * m][2], s[2 * m][3]),
                              pack_bf16(s[2 * m + 1][0], s[2 * m + 1][1]),
                              pack_bf16(s[2 * m + 1][2], s[2 * m + 1][3])};
      const __nv_bfloat16* krow = ks16 + (16 * m + (lane & 15)) * (2 * PW);
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, krow + 8 * n);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }
  // a row's partial sums sit in the 4 lanes of one quad
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out + (size_t)b * N * C);
#pragma unroll
  for (int n = 0; n < CN; ++n) {
    const int w = 4 * n + t;  // 32-bit word of columns 8n + 2t, 8n + 2t + 1
    if (row0 < N) o32[(size_t)row0 * (C / 2) + w] = pack_bf16(o[n][0] * r0, o[n][1] * r0);
    if (row1 < N) o32[(size_t)row1 * (C / 2) + w] = pack_bf16(o[n][2] * r1, o[n][3] * r1);
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

constexpr size_t NL_MMA_SMEM = sizeof(uint32_t) * 2 * NL_BQ * (NL_C / 2 + 4);

int minmax_bf16(const void* q, const void* k, void* part, float* lohi, int B, int N, int M,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nl_minmax_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)NL_MMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_BQ - 1) / NL_BQ, B);
  nl_minmax_mma_kernel<<<grid, NL_MMA_THREADS, NL_MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float2*>(part), N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part, (int)grid.x * B, lohi, stream);
}

int apply_bf16(const void* q, const void* k, const float* lohi, void* out, int B, int N, int M,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nl_apply_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)NL_MMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NL_BQ - 1) / NL_BQ, B);
  nl_apply_mma_kernel<<<grid, NL_MMA_THREADS, NL_MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), lohi,
      static_cast<__nv_bfloat16*>(out), N, M);
  return (int)cudaGetLastError();
}

bool nl_shapes_ok(int B, int N, int M, int C) {
  return B >= 1 && B <= 65535 && N >= 1 && M >= 1 && C == NL_C;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// q (B, N, C), k (B, M, C) contiguous, C = 112, dtype 0 = f32, 1 = bf16. part:
// scratch of B * ceil(N / 64) float2; lohi: 2 f32, written (min, max) of q k^T.
int mmif_nl_minmax(int dtype, const void* q, const void* k, void* part, float* lohi, int B,
                   int N, int M, int C, void* stream) {
  if (!nl_shapes_ok(B, N, M, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return minmax_f32(q, k, part, lohi, B, N, M, s);
  if (dtype == DT_BF16) return minmax_bf16(q, k, part, lohi, B, N, M, s);
  return (int)cudaErrorInvalidValue;
}

// out (B, N, C) in q's dtype = softmax((q k^T - lohi[0]) / (lohi[1] - lohi[0])) k.
int mmif_nl_apply(int dtype, const void* q, const void* k, const float* lohi, void* out, int B,
                  int N, int M, int C, void* stream) {
  if (!nl_shapes_ok(B, N, M, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return apply_f32(q, k, lohi, out, B, N, M, s);
  if (dtype == DT_BF16) return apply_bf16(q, k, lohi, out, B, N, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
