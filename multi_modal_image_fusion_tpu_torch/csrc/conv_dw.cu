// Depthwise (groups = C) reflect-SAME conv over a channel window of a wider
// NHWC tensor, with an optional second tensor added to the input first.
//
// The depthwise instance of multi_modal_image_fusion_tpu/ops/pallas/
// hiw_kernel.py:335 conv_hiw_chain, which runs depthwise weights as diagonal
// bands of a dense conv (:157-185); the Res2 blocks' hierarchy
// (ops/blocks.py:286-292 of the JAX package) reads each group's channels in
// place from the expanded tensor (hiw_scale.py:50 hiw_channels) and adds the
// previous group's output before the conv. Here the window is a base
// channel and the tensor's own pixel stride, so the 384-channel expansion of
// a Res2 block is never sliced into copies, and the add happens in the load.
//
// What bounds it on an H100: bytes. Per output value it reads one input
// value (two with the add) and writes one, against 2 k^2 flops: at k3 that
// is 4.5 flops a byte in bf16, far below the card's balance. A thread owns
// one pixel and 8 channels (16-byte loads in bf16, two in f32); the k x k
// taps of neighbouring pixels come from L1/L2, so device memory sees each
// input about once. The weights ([k*k][C] f32) sit in shared memory; the
// arithmetic is f32, the output is cast once. Built for k1 and k3 (the Res2
// blocks' dwconv0 and dwconv1..); the wrapper raises on anything else.
#include "common.cuh"

namespace mmif {

constexpr int DW_THREADS = 256;
constexpr int DW_MAX_C = 512;

template <typename T, int K>
__global__ void __launch_bounds__(DW_THREADS)
conv_dw_kernel(const T* __restrict__ x, int x_pitch, int lo, const T* __restrict__ add,
               int add_pitch, const float* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ y, int B, int H, int W, int C, int act) {
  constexpr int P = K / 2;
  __shared__ float sw[K * K * DW_MAX_C];
  for (int i = threadIdx.x; i < K * K * C; i += DW_THREADS) sw[i] = w[i];
  __syncthreads();

  const int nch = C / 8;
  const size_t idx = (size_t)blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= (size_t)B * H * W * nch) return;
  const int ch = (int)(idx % nch) * 8;
  const size_t pix = idx / nch;
  const int px = (int)(pix % W);
  const int py = (int)((pix / W) % H);
  const size_t row0 = (pix / W - py) * W;  // first pixel of image b

  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = bias != nullptr ? bias[ch + c] : 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int yy = reflect_index(py + dy - P, H);
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int xx = reflect_index(px + dx - P, W);
      const size_t p = row0 + (size_t)yy * W + xx;
      float v[8];
      load8(x + p * x_pitch + lo + ch, v);
      if (add != nullptr) {
        float a[8];
        load8(add + p * add_pitch + ch, a);
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] += a[c];
      }
      const float* wt = sw + (dy * K + dx) * C + ch;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(wt[c], v[c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = apply_act(acc[c], act);
  store8(y + pix * C + ch, acc);
}

template <typename T, int K>
int launch_dw(const void* x, int x_pitch, int lo, const void* add, int add_pitch,
              const float* w, const float* bias, void* y, int B, int H, int W, int C, int act,
              cudaStream_t stream) {
  const size_t total = (size_t)B * H * W * (C / 8);
  const size_t blocks = (total + DW_THREADS - 1) / DW_THREADS;
  conv_dw_kernel<T, K><<<(unsigned)blocks, DW_THREADS, 0, stream>>>(
      static_cast<const T*>(x), x_pitch, lo, static_cast<const T*>(add), add_pitch, w, bias,
      static_cast<T*>(y), B, H, W, C, act);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dw(int k, const void* x, int x_pitch, int lo, const void* add, int add_pitch,
                const float* w, const float* bias, void* y, int B, int H, int W, int C,
                int act, cudaStream_t s) {
  if (k == 1)
    return launch_dw<T, 1>(x, x_pitch, lo, add, add_pitch, w, bias, y, B, H, W, C, act, s);
  if (k == 3)
    return launch_dw<T, 3>(x, x_pitch, lo, add, add_pitch, w, bias, y, B, H, W, C, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// y (B, H, W, C) contiguous = act(dwconv(x[..., lo:lo+C] + add) + bias), reflect-SAME.
// x: (B, H, W, x_pitch), read at channels [lo, lo + C); add: null or
// (B, H, W, add_pitch) read at [0, C); w: [k*k][C] f32; bias: null or C f32.
// C, x_pitch, lo and add_pitch multiples of 8, 16-byte aligned bases.
int mmif_conv_dw(int dtype, const void* x, int x_pitch, int lo, const void* add, int add_pitch,
                 const float* w, const float* bias, void* y, int B, int H, int W, int C, int k,
                 int act, void* stream) {
  if (B < 1 || H <= k / 2 || W <= k / 2 || C < 8 || C % 8 || C > DW_MAX_C || x_pitch % 8 ||
      lo % 8 || lo + C > x_pitch || (add != nullptr && (add_pitch % 8 || add_pitch < C)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_dw<float>(k, x, x_pitch, lo, add, add_pitch, w, bias, y, B, H, W, C, act, s);
  if (dtype == DT_BF16)
    return dispatch_dw<__nv_bfloat16>(k, x, x_pitch, lo, add, add_pitch, w, bias, y, B, H, W, C,
                                      act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
