// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel here is exported through a plain C function that launches on
// the caller's stream and returns cudaGetLastError() as an int, so the
// Python wrapper (ops/cuda/*.py, bound with ctypes) can raise on a refused
// launch. Activation codes match ops/cuda/conv_chain.py ACT_CODES.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmif {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LRELU = 3, ACT_TANH = 4 };

// Epilogue activation, in f32 before the output cast (the TPU kernels'
// _apply_act, ops/pallas/conv_kernel.py:43). The compile-time form keeps a
// per-element switch (an indirect branch each) out of a hot epilogue.
template <int ACT>
__device__ __forceinline__ float apply_act_c(float y) {
  if constexpr (ACT == ACT_RELU) return fmaxf(y, 0.f);
  if constexpr (ACT == ACT_RELU6) return fminf(fmaxf(y, 0.f), 6.f);
  if constexpr (ACT == ACT_LRELU) return y >= 0.f ? y : 0.2f * y;
  if constexpr (ACT == ACT_TANH) return tanhf(y);
  return y;
}

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_RELU: return apply_act_c<ACT_RELU>(y);
    case ACT_RELU6: return apply_act_c<ACT_RELU6>(y);
    case ACT_LRELU: return apply_act_c<ACT_LRELU>(y);
    case ACT_TANH: return apply_act_c<ACT_TANH>(y);
    default: return y;
  }
}

// torch ReflectionPad2d index math: i<0 -> -i, i>=n -> 2n-2-i. The clamp
// only matters for tile positions that feed no stored output (ragged
// tiles); it keeps every read inside the tensor.
__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// The source pixel (row * W + column) of tile position (y, x), either side
// of the image: reflect index math. With s2d set the tensor is
// space-to-depth packed (f = 2, phase-major channels, ops/s2d.py) and H, W
// are its packed sizes: a channel of phase ph = py*2 + px reads the packed
// reflect extension of the original image, packed row
// reflect(2y + py, 2H) / 2 of the same phase (reflection keeps the parity),
// so phase 0 mirrors exclusively and phase 1 inclusively.
__device__ __forceinline__ size_t src_pixel(int y, int x, int H, int W, int s2d, int ph) {
  if (!s2d) return (size_t)reflect_index(y, H) * W + reflect_index(x, W);
  return (size_t)(reflect_index(2 * y + (ph >> 1), 2 * H) >> 1) * W +
         (reflect_index(2 * x + (ph & 1), 2 * W) >> 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive values as f32, one or two 16-byte loads. p must be
// 16-byte aligned (8 elements into a tensor whose channel count is a
// multiple of 8).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Eight f32 values stored as T, with the same alignment rule as load8.
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- warp-level bf16 tensor-core helpers (mma.sync m16n8k16) ----
// Fragments of one lane (g = lane / 4, t = lane % 4): A (16 x 16, row-major)
// a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// B (16 x 8, k x n) b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; the f32
// accumulator d0, d1 = D[g][2t..2t+1], d2, d3 = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight f32 values rounded to bf16, as one 16-byte word.
__device__ __forceinline__ uint4 pack8_bf16(const float* v) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// Row pitch (floats) of a staged input tile: the tile's width plus halo,
// rounded up to float4, and wide enough that the last thread's NV float4
// loads stay inside the row.
template <int TW, int PX, int K>
struct TileGeom {
  static constexpr int P = K / 2;
  static constexpr int NV = (PX + K - 1 + 3) / 4;  // float4 loads per row segment
  static constexpr int W_IN = TW + K - 1;
  static constexpr int PITCH_A = (W_IN + 3) / 4 * 4;
  static constexpr int PITCH_B = TW - PX + 4 * NV;
  static constexpr int PITCH = PITCH_A > PITCH_B ? PITCH_A : PITCH_B;
};

}  // namespace mmif
