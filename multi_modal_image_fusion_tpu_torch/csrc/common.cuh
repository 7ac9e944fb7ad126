// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel here is exported through a plain C function that launches on
// the caller's stream and returns cudaGetLastError() as an int, so the
// Python wrapper (ops/cuda/*.py, bound with ctypes) can raise on a refused
// launch. Activation codes match ops/cuda/conv_chain.py ACT_CODES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmif {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LRELU = 3, ACT_TANH = 4 };

// Epilogue activation, in f32 before the output cast (the TPU kernels'
// _apply_act, ops/pallas/conv_kernel.py:43).
__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_RELU6: return fminf(fmaxf(y, 0.f), 6.f);
    case ACT_LRELU: return y >= 0.f ? y : 0.2f * y;
    case ACT_TANH: return tanhf(y);
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
