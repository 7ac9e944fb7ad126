// The int8 tensor-core conv body shared by conv_int8 (the quantized
// ConvLayer conv) and conv_int8_chain (DeepFuse's int8 chain), NHWC.
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   multi_modal_image_fusion_tpu/ops/pallas/conv_int8.py:219 conv_tlane_dma_q
//     (pallas_call :263): an int8 VALID conv of an input the caller padded
//     and quantized by round(x / f);
//   multi_modal_image_fusion_tpu/ops/pallas/hiw_int8.py:260 conv_hiw_chain_q
//     (pallas_call :354): a reflect-SAME chain conv that quantizes in-kernel
//     by round(x * (1/f)) or reads an int8-resident input, with the siamese
//     fuse_n sum, and may requantize its output to int8.
// Here both are one kernel:
//
//   q[b]  = quantize(x[b] (+ x[b + fuse_n]))     per input channel, in the tile load
//   acc   = sum_{taps, ci} q[reflect(.)] * w8     int32, exact
//   y     = act(fma(float(acc), dq[co], bias[co]))  f32, one rounding
//   out   = y in f32 / bf16, or clip(rint(y), +-127) as int8
//
// quantize is round-half-even(x / f_c) (QM_DIV, the ConvLayer route) or
// round-half-even(x * invf_c) (QM_MUL, the chain), clipped to +-127; an int8
// input is taken as it is, its fuse_n sum saturating at +-127. A float fuse_n
// sum is rounded to the input's dtype first, as a sum in that dtype is. The
// epilogue's multiply-add rounds once, written as __fmaf_rn (and __fmul_rn
// without a bias) so it does not depend on nvcc's contraction: the JAX
// package's kernels compute acc * s + b inside jax.jit, where XLA contracts
// it into one FMA (on the CPU, measured: 0 of 100,000 results differ from
// the FMA, 25,211 from two roundings), and an int8 requant at a .5
// boundary flips on that rounding. Every rounding to an integer is
// __float2int_rn (half to even, as torch.round and jnp.round).
//
// What bounds it on an H100: DeepFuse's enc1 (16 -> 32, k7) and dec0 (32 ->
// 32, k7) do 784-1568 MACs per output pixel and channel pair on 1 byte
// operands; at 16 pairs of 1224x1024 that is 1.0 / 1.0 TOP of int8 work
// against ~0.2 GB of traffic, so the int8 tensor cores (1979 TOP/s dense)
// bound it, not memory. The design is the implicit GEMM of conv_wide.cu on
// the int8 tensor cores: warp-level mma.sync m16n8k32 (s8 x s8 -> s32). M is
// a 2 x 64 tile of output pixels (4 warps, 32 pixels each), N a block of
// 16, 32 or 64 output channels (the one that pads Cout least), K runs over
// 32-channel chunks x k^2 taps. For each chunk one reflect-indexed input
// tile plus its halo is quantized into shared memory (32 int8 channels a
// pixel, rows padded to 12 words so the fragment loads hit 32 distinct
// banks) beside the chunk's k^2 x N int8 weights (dynamic shared memory, up
// to 177 KB at k7 with 64 channels); every tap then reads a shifted window
// of that tile. Channels past Cin are zero: the wrapper packs the weights
// with Cin padded to a multiple of 32 (enc1's 16 channels use half a
// k-step), so Cin 1 and Cout 1 need no other path. |acc| stays below
// 127^2 * 9 * 1280 < 2^31 on every ported layer. No pipelining, wgmma or
// TMA yet: a simple kernel that is right first.
#pragma once

#include "common.cuh"

namespace mmif {

constexpr int Q_TH = 2, Q_TW = 64;  // output tile: 2 rows x 64 columns
constexpr int Q_THREADS = 128;      // 4 warps, 32 pixels of one row each
constexpr int Q_CK = 32;            // input channels a stage: one mma k-step
constexpr int Q_PW = 12;            // 32-bit words a staged row: 8 + 4 padding

enum QType { QT_F32 = 0, QT_BF16 = 1, QT_S8 = 2 };
enum QMode { QM_DIV = 0, QM_MUL = 1 };

struct QConvArgs {
  const void* x;        // (B, H, W, Cin) in in_type
  const float* scale;   // (Cin,): f (QM_DIV) or 1/f (QM_MUL); unused for int8 input
  const int8_t* w;      // (k*k, cout_pad, cin_pad) int8, zeros in the padding
  const float* dq;      // (Cout,) dequant scale
  const float* bias;    // (Cout,) or null
  void* y;              // (b_out, H, W, Cout) in out_type
  int H, W, Cin, Cout, cout_pad, cin_pad, fuse_n, act, in_type, out_type, qmode;
};

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col). Fragments of one
// lane (g = lane / 4, t = lane % 4), 4 int8 a register, lowest byte first:
// a0 = A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][4t+16..], a3 = A[g+8][4t+16..];
// b0 = B[4t..4t+3][g], b1 = B[4t+16..4t+19][g]; d0, d1 = D[g][2t..2t+1],
// d2, d3 = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round half to even, then clip to +-127
__device__ __forceinline__ int q127(float v) { return min(max(__float2int_rn(v), -127), 127); }

__device__ __forceinline__ float quantize_in(float v, float s, int qmode) {
  return qmode == QM_DIV ? __fdiv_rn(v, s) : __fmul_rn(v, s);
}

// The float siamese sum, rounded to the input's dtype as a sum in it is.
template <typename T> __device__ __forceinline__ float sum_in(float a, float b);
template <> __device__ __forceinline__ float sum_in<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ float sum_in<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

// Eight channels c0..c0+7 of one float pixel (off; sibling at sib when
// fuse_n) quantized; channels at or past Cin are 0.
template <typename T>
__device__ __forceinline__ void stage_float(const QConvArgs& a, const T* x, size_t off,
                                            size_t sib, bool fuse, int c0,
                                            const float* s_sc, int (&q)[8]) {
  float v[8];
  if (a.Cin % 8 == 0) {
    load8(x + off, v);
    if (fuse) {
      float s[8];
      load8(x + sib, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sum_in<T>(v[j], s[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = 0.f;
      if (c0 + j < a.Cin) {
        v[j] = to_f32(x[off + j]);
        if (fuse) v[j] = sum_in<T>(v[j], to_f32(x[sib + j]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    q[j] = c0 + j < a.Cin ? q127(quantize_in(v[j], s_sc[(c0 + j) % Q_CK], a.qmode)) : 0;
}

// The same for an int8-resident input: its fuse_n sum saturates at +-127.
__device__ __forceinline__ void stage_s8(const QConvArgs& a, const int8_t* x, size_t off,
                                         size_t sib, bool fuse, int c0, int (&q)[8]) {
  if (a.Cin % 8 == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(x + off);
    const int8_t* p = reinterpret_cast<const int8_t*>(&u);
    uint2 us = make_uint2(0u, 0u);
    if (fuse) us = *reinterpret_cast<const uint2*>(x + sib);
    const int8_t* ps = reinterpret_cast<const int8_t*>(&us);
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = fuse ? min(max(p[j] + ps[j], -127), 127) : p[j];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      q[j] = 0;
      if (c0 + j < a.Cin) {
        q[j] = x[off + j];
        if (fuse) q[j] = min(max(q[j] + x[sib + j], -127), 127);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack4_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// One output value in out_type.
__device__ __forceinline__ void store1(const QConvArgs& a, size_t i, float v) {
  if (a.out_type == QT_F32)
    static_cast<float*>(a.y)[i] = v;
  else if (a.out_type == QT_BF16)
    static_cast<__nv_bfloat16*>(a.y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<int8_t*>(a.y)[i] = (int8_t)q127(v);
}

// Two neighbouring channels (i even, i + 1 in the tensor) in one store.
__device__ __forceinline__ void store2(const QConvArgs& a, size_t i, float v0, float v1) {
  if (a.out_type == QT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(a.y) + i) = make_float2(v0, v1);
  } else if (a.out_type == QT_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) + i) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    char2 c;
    c.x = (char)q127(v0);
    c.y = (char)q127(v1);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(a.y) + i) = c;
  }
}

template <int K, int NT>
__global__ void __launch_bounds__(Q_THREADS) conv_int8_kernel(const QConvArgs a) {
  constexpr int BN = 8 * NT;
  constexpr int P = K / 2;
  constexpr int IN_H = Q_TH + K - 1, IN_W = Q_TW + K - 1;
  extern __shared__ __align__(16) uint32_t q_smem[];
  uint32_t* s_in = q_smem;                      // [pixel][32 ch] int8
  uint32_t* s_w = q_smem + IN_H * IN_W * Q_PW;  // [tap][co][32 ch] int8
  __shared__ float s_sc[Q_CK];                  // the chunk's f or 1/f

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int x0 = blockIdx.x * Q_TW, y0 = blockIdx.y * Q_TH;
  const int n_co = a.cout_pad / BN;
  const int b = blockIdx.z / n_co, co0 = (blockIdx.z % n_co) * BN;
  const int wr = warp >> 1;        // the warp's output row in the tile
  const int wc = (warp & 1) * 32;  // and its first output column
  const int H = a.H, W = a.W, Cin = a.Cin;
  const size_t img = (size_t)H * W * Cin;
  const size_t xb = (size_t)b * img;
  const size_t xsb = (size_t)(b + a.fuse_n) * img;
  const bool fuse = a.fuse_n > 0;

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int ci0 = 0; ci0 < Cin; ci0 += Q_CK) {
    if (tid < Q_CK) s_sc[tid] = (a.in_type != QT_S8 && ci0 + tid < Cin) ? a.scale[ci0 + tid] : 1.f;
    __syncthreads();
    // quantize the input tile: reflect halo, 8 channels an item
    for (int idx = tid; idx < IN_H * IN_W * 4; idx += Q_THREADS) {
      const int quarter = idx & 3, pix = idx >> 2;
      const int r = pix / IN_W, c = pix - r * IN_W;
      const int c0 = ci0 + 8 * quarter;
      int q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (c0 < Cin) {
        const size_t p = ((size_t)reflect_index(y0 - P + r, H) * W +
                          reflect_index(x0 - P + c, W)) * Cin + c0;
        if (a.in_type == QT_F32)
          stage_float(a, static_cast<const float*>(a.x), xb + p, xsb + p, fuse, c0, s_sc, q);
        else if (a.in_type == QT_BF16)
          stage_float(a, static_cast<const __nv_bfloat16*>(a.x), xb + p, xsb + p, fuse, c0,
                      s_sc, q);
        else
          stage_s8(a, static_cast<const int8_t*>(a.x), xb + p, xsb + p, fuse, c0, q);
      }
      *reinterpret_cast<uint2*>(s_in + pix * Q_PW + 2 * quarter) =
          make_uint2(pack4_s8(q[0], q[1], q[2], q[3]), pack4_s8(q[4], q[5], q[6], q[7]));
    }
    // the chunk's weights: k^2 x BN rows of 32 input channels
    for (int idx = tid; idx < K * K * BN * 2; idx += Q_THREADS) {
      const int half = idx & 1, row = idx >> 1;  // row = tap * BN + co
      const int tap = row / BN, co = row - tap * BN;
      const int8_t* src =
          a.w + ((size_t)tap * a.cout_pad + co0 + co) * a.cin_pad + ci0 + 16 * half;
      *reinterpret_cast<uint4*>(s_w + row * Q_PW + 4 * half) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();

#pragma unroll 1
    for (int kh = 0; kh < K; ++kh) {
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        uint32_t bf[NT][2];
        const uint32_t* wrow = s_w + ((kh * K + kw) * BN + g) * Q_PW + t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bf[j][0] = wrow[j * 8 * Q_PW];
          bf[j][1] = wrow[j * 8 * Q_PW + 4];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A fragment: pixels g and g + 8 of the m-tile, shifted by the tap
          const uint32_t* p0 = s_in + ((wr + kh) * IN_W + wc + 16 * i + g + kw) * Q_PW + t;
          const uint32_t* p1 = p0 + 8 * Q_PW;
          const uint32_t af[4] = {p0[0], p1[0], p0[4], p1[4]};
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: acc * dq + bias (one rounding), activation, store
  const int gy = y0 + wr;
  if (gy >= H) return;
  const int Cout = a.Cout;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = co0 + 8 * j + 2 * t;
    if (co >= Cout) continue;
    const bool two = co + 1 < Cout;
    const float d0 = a.dq[co], d1 = two ? a.dq[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gx = x0 + wc + 16 * i + g + 8 * e;
        if (gx >= W) continue;
        const float p0 = __int2float_rn(acc[i][j][2 * e]);
        const float p1 = __int2float_rn(acc[i][j][2 * e + 1]);
        float v0 = a.bias ? __fmaf_rn(p0, d0, a.bias[co]) : __fmul_rn(p0, d0);
        float v1 = a.bias && two ? __fmaf_rn(p1, d1, a.bias[co + 1]) : __fmul_rn(p1, d1);
        v0 = apply_act(v0, a.act);
        v1 = apply_act(v1, a.act);
        const size_t o = (((size_t)b * H + gy) * W + gx) * Cout + co;
        if (two && Cout % 2 == 0)
          store2(a, o, v0, v1);
        else {
          store1(a, o, v0);
          if (two) store1(a, o + 1, v1);
        }
      }
    }
  }
}

// Dynamic shared memory of one block: the input tile and the chunk's weights.
template <int K, int NT>
constexpr size_t conv_int8_smem() {
  return (size_t)((Q_TH + K - 1) * (Q_TW + K - 1) + K * K * 8 * NT) * Q_PW * 4;
}

template <int K, int NT>
int launch_conv_int8(const QConvArgs& a, int b_out, cudaStream_t s) {
  const size_t smem = conv_int8_smem<K, NT>();
  cudaError_t e = cudaFuncSetAttribute(conv_int8_kernel<K, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long gz = (long long)b_out * (a.cout_pad / (8 * NT));
  if (gz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((a.W + Q_TW - 1) / Q_TW, (a.H + Q_TH - 1) / Q_TH, (unsigned)gz);
  conv_int8_kernel<K, NT><<<grid, Q_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The instances of one kernel size, by output-channel block. conv_int8.cu
// instantiates k1 and k3, conv_int8_k5.cu and conv_int8_k7.cu the larger
// ones, so the three compile in parallel.
template <int K>
int conv_int8_by_bn(int bn, const QConvArgs& a, int b_out, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_conv_int8<K, 2>(a, b_out, s);
    case 32: return launch_conv_int8<K, 4>(a, b_out, s);
    case 64: return launch_conv_int8<K, 8>(a, b_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern template int conv_int8_by_bn<5>(int, const QConvArgs&, int, cudaStream_t);
extern template int conv_int8_by_bn<7>(int, const QConvArgs&, int, cudaStream_t);

}  // namespace mmif
