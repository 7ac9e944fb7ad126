// The int8 tensor-core conv shared by conv_int8 (the quantized ConvLayer
// conv) and conv_int8_chain (DeepFuse's int8 chain), NHWC.
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   multi_modal_image_fusion_tpu/ops/pallas/conv_int8.py:219 conv_tlane_dma_q
//     (pallas_call :263): an int8 VALID conv of an input the caller padded
//     and quantized by round(x / f);
//   multi_modal_image_fusion_tpu/ops/pallas/hiw_int8.py:260 conv_hiw_chain_q
//     (pallas_call :354): a reflect-SAME chain conv that quantizes in-kernel
//     by round(x * (1/f)) or reads an int8-resident input, with the siamese
//     fuse_n sum, and may requantize its output to int8.
// Here both are one function over up to MAX_LEGS float input legs (their
// channel concat is the layer's input, read in place) or one int8 tensor:
//
//   q[b]  = quantize(x_l[b + b_off_l] (+ x_l[b + b_off_l + fuse_n]))  per channel
//   acc   = sum_{taps, ci} q[reflect(.)] * w8            int32, exact
//   y     = act(fma(float(acc), dq[co], bias[co]))      f32, one rounding
//   out   = y in f32 / bf16, or clip(rint(y), +-127) as int8
//
// quantize is round-half-even(x / f_c) (QM_DIV, the ConvLayer route) or
// round-half-even(x * invf_c) (QM_MUL, the chain), clipped to +-127, with
// f_c the channel's entry of the concat's fold; an int8 input is taken as
// it is, its fuse_n sum saturating at +-127. A float fuse_n sum is rounded
// to the input's dtype first, as a sum in that dtype is. The epilogue's
// multiply-add rounds once, written as __fmaf_rn (and __fmul_rn without a
// bias) so it does not depend on nvcc's contraction: the JAX package's
// kernels compute acc * s + b inside jax.jit, where XLA contracts it into
// one FMA (on the CPU, measured: 0 of 100,000 results differ from the FMA,
// 25,211 from two roundings), and an int8 requant at a .5 boundary flips on
// that rounding. Every rounding to an integer is __float2int_rn (half to
// even, as torch.round and jnp.round).
//
// What bounds it on an H100: DeepFuse's enc1 (16 -> 32, k7) and dec0 (32 ->
// 32, k7) do 784-1568 MACs per output pixel and channel pair on 1-byte
// operands; at 16 pairs of 1224x1024 that is 1.0 / 1.0 TOP of int8 work
// against ~0.2 GB of traffic, so the int8 tensor cores (1979 TOP/s dense)
// bound it, not memory; UNFusion's DB3_1 conv1 (1280 -> 640, k3) is 18.5
// TOP. Two kernels:
//
// - q8_quantize_kernel, a float input's quantizer: 16 channels of a pixel a
//   thread, read from their legs in place (the fuse_n sibling added in the
//   input's dtype), quantized by the channel's scale, written once as int8
//   (the concat, its channels zero-padded to a multiple of 16). Memory
//   bound: 2 or 4 bytes read and 1 written an element. Quantizing in the
//   conv's stage load instead (through registers, after the stage's wgmmas
//   were issued) redid it for every N slice and halo pixel and waited on
//   its loads and divisions: on an H100, 16 pairs, DeepFuse's enc1 8.27 ms
//   and DenseFuse's dec0 20.03 ms with it, against the bf16 body's 5.31
//   and the mma.sync kernel's 13.69.
// - conv_int8_tc_kernel, the conv on an int8 input: the bf16 conv_chain
//   body's design (conv_chain.cuh) on the s8 tensor cores, a wgmma
//   m64nNk32 s8 x s8 -> s32 implicit GEMM with a cp.async ring of staged
//   input tiles. A k-step is 32 int8 channels, 32 bytes a pixel: byte for
//   byte the bf16 body's 16 bf16 channels, so its tile geometry (TcGeom),
//   its no-swizzle descriptors (two 16-byte channel halves one leading byte
//   offset apart, a tap a 16-byte move of the start address), its plan
//   (tc_plan_bytes: resident weights beside the deepest ring that fits) and
//   its persistent grid (tc_grid) carry over, and a layer takes half the
//   bf16 body's k-steps. One stage loop (conv_chain.cuh tc_conv) runs both
//   bodies, this one through its operand traits (Q8Op). An int8 fuse_n
//   pair (DeepFuse's dec0) is copied into two buffers of a ring slot and
//   summed with __vaddss4 / __vmaxs4 in shared memory where tc_plan_bytes
//   fits that ring; else (dec0 writing f32, which the f32 chain does when
//   dec1 is skipped: a 72 KiB output tile) summed in registers as the tile
//   is staged, as the bf16 body sums its own k7 dec0.
//   Tap pairs (TP): where the input has at most 16 channels (DeepFuse's
//   enc1, DenseFuse's dense0), a k-step would be half zeros; its two 16-byte
//   halves carry taps kw and kw + 1 of the same 16 channels instead: half
//   1's descriptor is half 0's moved by one pixel (a leading byte offset of
//   16), and the packed weights hold tap kw in half 0 and kw + 1 in half 1,
//   zeros for the odd last tap (whose half 1 reads one pixel past the row,
//   inside the slot: any byte times a zero weight adds nothing). A k7 row
//   takes 4 wgmmas instead of 7. The epilogue: int32 to f32
//   (__int2float_rn), the one-rounding FMA with the dequant scale and bias,
//   the activation, then f32, bf16 or requantized int8 (q127) into the
//   output tile in shared memory (pitch: the output's element size times
//   BN plus 16 bytes), which goes to global memory in 16-byte stores (byte
//   by byte where a pixel's channels are not 16-byte aligned: a Cout of 1).
//
// |acc| stays below 127^2 * 9 * 1280 < 2^31 on every ported layer.
#pragma once

#include "conv_chain.cuh"

namespace mmif {

enum QType { QT_F32 = 0, QT_BF16 = 1, QT_S8 = 2 };
enum QMode { QM_DIV = 0, QM_MUL = 1 };
constexpr int Q_CK = 32;  // input channels a k-step (m64nNk32)

struct Q8Args {
  const int8_t* x;        // (b_in, H, W, Cin) int8, Cin a multiple of 16
  const int8_t* w;        // [Cout_pad / BN][KS][taps][2][BN][16]
  const float* dq;        // (Cout,) dequant scale
  const float* bias;      // (Cout,) or null
  void* y;                // (b_out, H, W, Cout) in out_type
  int b_out, H, W, Cin, Cout, KS, fuse_n, act, out_type;
  int tiles_x, tiles_y, n_tiles;  // set by tc_grid
  int resident, ring, pair;       // set by tc_plan_bytes
  int out_pitch;                  // bytes of one staged output pixel
};

// round half to even, then clip to +-127
__device__ __forceinline__ int q127(float v) { return min(max(__float2int_rn(v), -127), 127); }

// round-half-even(x / f) as __float2int_rn(__fdiv_rn(x, f)) gives it,
// through r = 1/f rounded to nearest: x * r (rounded) is within 2^-22 of x
// / f relative to it, and so is the rounded quotient, so both round to the
// same integer unless a half-integer lies within 2^-20 of x * r (relative):
// those values, about one in 2^20, take the division itself. Beyond 256 in
// magnitude either clips to +-127.
__device__ __forceinline__ int div_rint(float x, float f, float r) {
  const float y = __fmul_rn(x, r);
  const float t = fabsf(y);
  if (t < 256.f && fabsf(y - (floorf(y) + 0.5f)) <= t * 0x1p-20f)
    return __float2int_rn(__fdiv_rn(x, f));
  return __float2int_rn(y);
}

// x quantized and clipped: round(x / f) (QM_DIV; r = 1/f) or round(x * s)
// (QM_MUL, s = 1/f), to +-127.
__device__ __forceinline__ int quantize_in(float x, float s, float r, int qmode) {
  const int q = qmode == QM_DIV ? div_rint(x, s, r) : __float2int_rn(__fmul_rn(x, s));
  return min(max(q, -127), 127);
}

// The float siamese sum, rounded to the input's dtype as a sum in it is.
template <typename T> __device__ __forceinline__ float sum_in(float a, float b);
template <> __device__ __forceinline__ float sum_in<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ float sum_in<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

__device__ __forceinline__ uint32_t pack4_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// Four int8 pairs summed, saturating at +-127: the int8 fuse_n sum.
__device__ __forceinline__ uint32_t add_s8x4(uint32_t a, uint32_t b) {
  return __vmaxs4(__vaddss4(a, b), 0x81818181u);
}
__device__ __forceinline__ uint4 add_s8x16(uint4 a, uint4 b) {
  return make_uint4(add_s8x4(a.x, b.x), add_s8x4(a.y, b.y), add_s8x4(a.z, b.z),
                    add_s8x4(a.w, b.w));
}

// ---------------------------------------------------------------------------
// The quantizer: float legs -> one int8 tensor
// ---------------------------------------------------------------------------
struct QuantArgs {
  Legs legs;              // float legs in T (s2d 0)
  int cofs[MAX_LEGS + 1];  // each leg's first channel in the concat; cofs[n] = cin
  const float* scale;     // (cin,): f (QM_DIV) or 1/f (QM_MUL)
  const float* rscale;    // (cin,): 1 / scale rounded to nearest (QM_DIV's multiplier)
  int8_t* q;              // (b_out, H, W, cin_q), channels past cin 0
  int hw, cin_q, fuse_n, qmode;  // hw = H * W
  int vec;                // every leg's channel count a multiple of 8
};

// Eight concat channels c0 .. c0 + 7 of pixel p of image b, quantized;
// channels at or past the concat's end are 0. vec: the group lies in one
// leg (every leg's channel count a multiple of 8): one or two 16-byte
// loads and the sibling's, and the eight scales (and reciprocals) in
// 16-byte loads too (one scalar load a channel made UNFusion's 1280-channel
// DB3_1 conv1 take 26.4 ms on an H100 instead of 22).
template <typename T>
__device__ __forceinline__ uint2 q8_quant8(const QuantArgs& a, int b, int p, int c0) {
  const int cin = a.cofs[a.legs.n];
  int q[8];
  if (a.vec && c0 < cin) {
    int l = 0;
    while (c0 >= a.cofs[l + 1]) ++l;
    const int cl = a.legs.cin[l];
    const T* x = static_cast<const T*>(a.legs.x[l]) +
                 ((size_t)(b + a.legs.b_off[l]) * a.hw + p) * cl + (c0 - a.cofs[l]);
    float v[8];
    load8(x, v);
    if (a.fuse_n) {
      float u[8];
      load8(x + (size_t)a.fuse_n * a.hw * cl, u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sum_in<T>(v[j], u[j]);
    }
    float sc[8], rc[8] = {};
    load8(a.scale + c0, sc);
    if (a.qmode == QM_DIV) load8(a.rscale + c0, rc);
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quantize_in(v[j], sc[j], rc[j], a.qmode);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      q[j] = 0;
      if (c < cin) {
        int l = 0;
        while (c >= a.cofs[l + 1]) ++l;
        const int cl = a.legs.cin[l];
        const T* x = static_cast<const T*>(a.legs.x[l]) +
                     ((size_t)(b + a.legs.b_off[l]) * a.hw + p) * cl + (c - a.cofs[l]);
        float v = to_f32(x[0]);
        if (a.fuse_n) v = sum_in<T>(v, to_f32(x[(size_t)a.fuse_n * a.hw * cl]));
        q[j] = quantize_in(v, __ldg(a.scale + c), __ldg(a.rscale + c), a.qmode);
      }
    }
  }
  return make_uint2(pack4_s8(q[0], q[1], q[2], q[3]), pack4_s8(q[4], q[5], q[6], q[7]));
}

// One thread 16 concat channels of one pixel (both 8-channel groups' loads
// in flight together, one 16-byte store), grid-stride over the pixels of
// image blockIdx.y: consecutive threads on consecutive channels, so loads
// and stores coalesce; 32-bit index math within an image.
template <typename T>
__global__ void __launch_bounds__(256) q8_quantize_kernel(const __grid_constant__ QuantArgs a) {
  const int groups = a.cin_q / 16;
  const int n = a.hw * groups;
  const int b = blockIdx.y;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int p = i / groups;
    const int c0 = (i - p * groups) * 16;
    const uint2 lo = q8_quant8<T>(a, b, p, c0), hi = q8_quant8<T>(a, b, p, c0 + 8);
    *reinterpret_cast<uint4*>(a.q + ((size_t)b * a.hw + p) * a.cin_q + c0) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// ---------------------------------------------------------------------------
// The conv on an int8 input: s8 wgmma implicit GEMM
// ---------------------------------------------------------------------------

// The 16-byte copies of the staged tile (k-step channels c0 .. c0 + 31;
// HALVES 1: half 0 only, the tap pairs) into buf, zero-filled past the
// last channel.
template <int K, int BN, int HALVES>
__device__ __forceinline__ void q8_copy_tile(const Q8Args& a, const int8_t* x, int c0, int y0,
                                             int x0, uint32_t buf) {
  using G = TcGeom<K, BN>;
  for (int i = threadIdx.x; i < G::IN_H * G::IN_W * HALVES; i += TC_THREADS) {
    const int half = HALVES == 2 ? (i & 1) : 0, pix = HALVES == 2 ? (i >> 1) : i;
    const int r = pix / G::IN_W, c = pix - r * G::IN_W;
    const int ch = c0 + 16 * half;
    const size_t off =
        ((size_t)reflect_index(y0 + r, a.H) * a.W + reflect_index(x0 + c, a.W)) * a.Cin + ch;
    cp_async16(buf + half * G::HALF + pix * 16, ch < a.Cin ? x + off : x, ch < a.Cin ? 16 : 0);
  }
}

// The fuse_n pair where no ring of doubled slots fits: both halves loaded,
// summed (saturating) and stored, 16 bytes an item.
template <int K, int BN, int HALVES>
__device__ __forceinline__ void q8_sum_tile(const Q8Args& a, const int8_t* x, size_t sib, int c0,
                                            int y0, int x0, uint32_t buf) {
  using G = TcGeom<K, BN>;
  for (int i = threadIdx.x; i < G::IN_H * G::IN_W * HALVES; i += TC_THREADS) {
    const int half = HALVES == 2 ? (i & 1) : 0, pix = HALVES == 2 ? (i >> 1) : i;
    const int r = pix / G::IN_W, c = pix - r * G::IN_W;
    const int ch = c0 + 16 * half;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ch < a.Cin) {
      const size_t off =
          ((size_t)reflect_index(y0 + r, a.H) * a.W + reflect_index(x0 + c, a.W)) * a.Cin + ch;
      v = add_s8x16(*reinterpret_cast<const uint4*>(x + off),
                    *reinterpret_cast<const uint4*>(x + off + sib));
    }
    st_shared16(buf + half * G::HALF + pix * 16, v);
  }
}

// Issue stage s (tile s / KS, k-step s % KS) into ring slot s % ring: the
// input tile (an int8 fuse_n pair: both halves into the slot's two buffers,
// or without a pair plan summed here) and, when the weights are not
// resident, the k-step's weights (W_BYTES).
template <int K, int BN, bool TP, int W_BYTES>
__device__ __forceinline__ void q8_load_stage(const Q8Args& a, int s, uint32_t s_in,
                                              uint32_t s_w, const int8_t* wblk) {
  using G = TcGeom<K, BN>;
  constexpr int P = K / 2;
  constexpr int HALVES = TP ? 1 : 2;
  const int ks = s % a.KS;
  int b, ty, tx;
  tc_tile(a, blockIdx.x + (s / a.KS) * gridDim.x, b, ty, tx);
  const size_t img = (size_t)a.H * a.W * a.Cin;
  const int8_t* x = a.x + (size_t)b * img;
  const uint32_t buf = s_in + (s % a.ring) * G::IN_BYTES;
  const int y0 = ty * G::TH - P, x0 = tx * TC_TW - P, c0 = ks * Q_CK;
  if (a.fuse_n == 0 || a.pair) {
    q8_copy_tile<K, BN, HALVES>(a, x, c0, y0, x0, buf);
    if (a.fuse_n)
      q8_copy_tile<K, BN, HALVES>(a, x + (size_t)a.fuse_n * img, c0, y0, x0,
                                  buf + a.ring * G::IN_BYTES);
  } else {
    q8_sum_tile<K, BN, HALVES>(a, x, (size_t)a.fuse_n * img, c0, y0, x0, buf);
  }
  tc_load_weights<W_BYTES>(a, ks, s, s_w, wblk);
}

// The tile's accumulators dequantized (one rounding), activation ACT, as
// output type OT into the output tile in shared memory: two neighbouring
// channels a store.
template <int K, int BN, int ACT, int OT>
__device__ __forceinline__ void q8_stage_out(const Q8Args& a,
                                             int (&acc)[TcGeom<K, BN>::MT][BN / 2],
                                             uint32_t s_out, uint32_t s_dqb) {
  using G = TcGeom<K, BN>;
  constexpr int ESZ = OT == QT_F32 ? 4 : OT == QT_BF16 ? 2 : 1;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // the slice's dequant scales and biases from shared memory, next to
    // their use (the block's N slice loaded once: loads of every column
    // hoisted ahead of the loop held 64 registers at N 128)
    float d0, d1, b0, b1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(d0), "=f"(d1)
                 : "r"(s_dqb + (8 * j + 2 * q) * 4));
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(b0), "=f"(b1)
                 : "r"(s_dqb + (BN + 8 * j + 2 * q) * 4));
#pragma unroll
    for (int m = 0; m < G::MT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pix = (wg * G::MT + m) * TC_TW + 16 * warp + g + 8 * e;
        const float p0 = __int2float_rn(acc[m][4 * j + 2 * e]);
        const float p1 = __int2float_rn(acc[m][4 * j + 2 * e + 1]);
        const float v0 = apply_act_c<ACT>(a.bias ? __fmaf_rn(p0, d0, b0) : __fmul_rn(p0, d0));
        const float v1 = apply_act_c<ACT>(a.bias ? __fmaf_rn(p1, d1, b1) : __fmul_rn(p1, d1));
        const uint32_t at = s_out + pix * a.out_pitch + (8 * j + 2 * q) * ESZ;
        if constexpr (OT == QT_F32) {
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(v0), "f"(v1)
                       : "memory");
        } else if constexpr (OT == QT_BF16) {
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(v0, v1))
                       : "memory");
        } else {
          const uint16_t v = (uint16_t)((q127(v0) & 0xff) | ((q127(v1) & 0xff) << 8));
          asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(at), "h"(v) : "memory");
        }
      }
  }
}

// The staged output tile to global memory: 16 bytes of one pixel a thread,
// consecutive threads on consecutive bytes; byte by byte where a pixel's
// channels are not 16-byte aligned (a Cout of 1), none past Cout.
template <int K, int BN>
__device__ __forceinline__ void q8_store_out(const Q8Args& a, int tile, uint32_t s_out, int nb) {
  using G = TcGeom<K, BN>;
  const int esz = a.out_type == QT_F32 ? 4 : a.out_type == QT_BF16 ? 2 : 1;
  const int per = 16 / esz;       // channels a 16-byte chunk
  const int chunks = BN / per;    // chunks a staged pixel
  const bool vec = (a.Cout * esz) % 16 == 0;
  int b, ty, tx;
  tc_tile(a, tile, b, ty, tx);
  uint8_t* y = static_cast<uint8_t*>(a.y);
  for (int i = threadIdx.x; i < G::TH * TC_TW * chunks; i += TC_THREADS) {
    const int pix = i / chunks, c = i - pix * chunks;
    const int oy = ty * G::TH + pix / TC_TW, ox = tx * TC_TW + pix % TC_TW;
    const int co = nb * BN + per * c;
    if (oy >= a.H || ox >= a.W || co >= a.Cout) continue;
    uint8_t* dst = y + ((((size_t)b * a.H + oy) * a.W + ox) * a.Cout + co) * esz;
    const uint32_t src = s_out + pix * a.out_pitch + 16 * c;
    if (vec) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(src));
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const int n = min(per, a.Cout - co) * esz;
      for (int e = 0; e < n; ++e) {
        uint16_t v;
        asm volatile("ld.shared.u8 %0, [%1];\n" : "=h"(v) : "r"(src + e));
        dst[e] = (uint8_t)v;
      }
    }
  }
}

// The s8 operand traits of conv_chain.cuh's stage loop (tc_conv).
template <int K, int BN, bool TP>
struct Q8Op {
  using Args = Q8Args;
  using Acc = int;
  using G = TcGeom<K, BN>;
  static constexpr int KW = TP ? (K + 1) / 2 : K;  // wgmmas a row of taps
  static constexpr int W_BYTES = K * KW * BN * 32;
  // tap pairs: half 1 is half 0 one pixel on (a leading byte offset of 16)
  static constexpr int LBO = TP ? 16 : G::HALF, TAP = TP ? 2 : 1, HALVES = TP ? 1 : 2;
  // the N slice's dequant scales and biases, [2][BN] f32 past the output tile
  static __device__ __forceinline__ uint32_t dqb(const Q8Args& a, uint32_t s_out) {
    return s_out + G::TH * TC_TW * a.out_pitch;
  }
  // the N slice's dequant scales and biases, zeros past Cout (read after
  // the loop's first barrier)
  static __device__ __forceinline__ void start(const Q8Args& a, uint32_t s_out, int nb) {
    if (threadIdx.x < 2 * BN) {
      const int c = nb * BN + threadIdx.x % BN;
      const float* src = threadIdx.x < BN ? a.dq : a.bias;
      const float v = c < a.Cout && src ? __ldg(src + c) : 0.f;
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dqb(a, s_out) + threadIdx.x * 4), "f"(v)
                   : "memory");
    }
  }
  static __device__ __forceinline__ void load_stage(const Q8Args& a, int s, uint32_t s_in,
                                                    uint32_t s_w, const int8_t* wblk) {
    q8_load_stage<K, BN, TP, W_BYTES>(a, s, s_in, s_w, wblk);
  }
  static __device__ __forceinline__ bool pair_vec(const Q8Args&, int) { return true; }
  // saturating at +-127
  static __device__ __forceinline__ void sum16(uint32_t at, uint32_t sib) {
    uint4 u, v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                 : "r"(at));
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(sib));
    st_shared16(at, add_s8x16(u, v));
  }
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db,
                                             int scale_d) {
    wgmma_s8<BN>(d, da, db, scale_d);
  }
  template <int ACT>
  static __device__ __forceinline__ void stage_out(const Q8Args& a, int (&acc)[G::MT][BN / 2],
                                                   uint32_t s_out, int) {
    if (a.out_type == QT_F32)
      q8_stage_out<K, BN, ACT, QT_F32>(a, acc, s_out, dqb(a, s_out));
    else if (a.out_type == QT_BF16)
      q8_stage_out<K, BN, ACT, QT_BF16>(a, acc, s_out, dqb(a, s_out));
    else
      q8_stage_out<K, BN, ACT, QT_S8>(a, acc, s_out, dqb(a, s_out));
  }
  static __device__ __forceinline__ void store_out(const Q8Args& a, int tile, uint32_t s_out,
                                                   int nb) {
    q8_store_out<K, BN>(a, tile, s_out, nb);
  }
};

template <int K, int BN, bool TP>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_int8_tc_kernel(const __grid_constant__ Q8Args a) {
  tc_conv<Q8Op<K, BN, TP>>(a);
}

// The plan (tc_plan_bytes over this body's byte counts; ops/cuda/
// conv_int8.py int8_plan mirrors it), the persistent grid and the launch
// of one instance.
template <int K, int BN, bool TP>
int launch_q8(Q8Args a, cudaStream_t s) {
  using G = TcGeom<K, BN>;
  const int esz = a.out_type == QT_F32 ? 4 : a.out_type == QT_BF16 ? 2 : 1;
  a.out_pitch = esz * BN + 16;
  size_t smem = 0;
  if (!tc_plan_bytes(G::IN_BYTES, Q8Op<K, BN, TP>::W_BYTES,
                     (size_t)G::TH * TC_TW * a.out_pitch + 8 * BN, a.KS, a.fuse_n > 0,
                     a.resident, a.ring, a.pair, smem))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_int8_tc_kernel<K, BN, TP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid;
  const int e = tc_grid((const void*)conv_int8_tc_kernel<K, BN, TP>, a, G::TH, smem,
                        (a.Cout + BN - 1) / BN, grid);
  if (e) return e;
  conv_int8_tc_kernel<K, BN, TP><<<grid, TC_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The instances of one kernel size by N block and tap-pair mode (the
// blocks ops/cuda/conv_int8.py INT8_INSTANCES lists): conv_int8.cu
// builds k1, conv_int8_k3.cu, _k5.cu and _k7.cu the others, so they
// compile in parallel.
template <int K>
int q8_by_bn(int bn, bool tp, const Q8Args& a, cudaStream_t s);
template <> int q8_by_bn<1>(int, bool, const Q8Args&, cudaStream_t);
template <> int q8_by_bn<3>(int, bool, const Q8Args&, cudaStream_t);
template <> int q8_by_bn<5>(int, bool, const Q8Args&, cudaStream_t);
template <> int q8_by_bn<7>(int, bool, const Q8Args&, cudaStream_t);

}  // namespace mmif
