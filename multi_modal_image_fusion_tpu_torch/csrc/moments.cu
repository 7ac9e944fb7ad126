// Five Gaussian-filtered moment maps of an image pair in one pass (VALID on
// input the caller padded).
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/moments_kernel.py:50
// moments_pallas: mu1, mu2, E[x1^2], E[x2^2] and E[x1*x2] under a separable
// ws-tap Gaussian, up to the 17 taps of the VIF pyramid's first scale. All
// f32. The VIF masking chain that consumes the maps stays in torch
// (ops/metrics.py), as the TPU kernel leaves it to XLA.
//
// What bounds it on an H100: 2 reads and 5 writes of 4 bytes an output pixel
// (28 bytes) against 3 products and 5 maps x ws taps x 2 passes x 2 flops,
// ~343 operations at ws 17 and ~63 at ws 3: 2-12 operations per byte, below
// the card's f32 balance of ~20 (67 TFLOP/s over 3.35 TB/s), so it is bound
// by memory traffic. The design is csrc/ssim.cu's: each input pixel is read
// from device memory once per tile (plus the ws-1 halo), the five
// vertical-filtered maps stay in shared memory, and each output is written
// once; none of the plain version's products or half-filtered maps reaches
// device memory. The tile holds a 16-pixel halo, so its static shared memory
// is 46,080 bytes, under the 48 KB a block may take without opting in. The
// TPU kernel's 128-row strips, lane padding and lane rolls are not carried
// over: outputs are exact VALID maps.
#include "common.cuh"

namespace mmif {

constexpr int MO_MAX_WS = 17;
constexpr int MO_TH = 16, MO_TW = 64;
constexpr int MO_THREADS = 256;
constexpr int MO_IN_H = MO_TH + MO_MAX_WS - 1;
constexpr int MO_IN_W = MO_TW + MO_MAX_WS - 1;

struct MomentTaps {
  float t[MO_MAX_WS];
};

__global__ void __launch_bounds__(MO_THREADS)
moments_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ mu1, float* __restrict__ mu2, float* __restrict__ m11,
               float* __restrict__ m22, float* __restrict__ m12, int H, int W, int OH,
               int OW, int ws, MomentTaps taps) {
  __shared__ float sa[MO_IN_H][MO_IN_W];
  __shared__ float sb[MO_IN_H][MO_IN_W];
  __shared__ float sv[5][MO_TH][MO_IN_W];  // vertical-filtered x, y, xx, yy, xy

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * MO_TW;
  const int y0 = blockIdx.y * MO_TH;
  const int n = blockIdx.z;
  const size_t img = (size_t)H * W;
  const float* an = a + n * img;
  const float* bn = b + n * img;
  const int in_h = MO_TH + ws - 1, in_w = MO_TW + ws - 1;

  for (int idx = tid; idx < in_h * in_w; idx += MO_THREADS) {
    const int r = idx / in_w, c = idx % in_w;
    const int gy = y0 + r, gx = x0 + c;
    const bool in = gy < H && gx < W;
    sa[r][c] = in ? an[(size_t)gy * W + gx] : 0.f;
    sb[r][c] = in ? bn[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  for (int idx = tid; idx < MO_TH * in_w; idx += MO_THREADS) {
    const int r = idx / in_w, c = idx % in_w;
    float s1 = 0.f, s2 = 0.f, s11 = 0.f, s22 = 0.f, s12 = 0.f;
    for (int d = 0; d < ws; ++d) {
      const float t = taps.t[d];
      const float u = sa[r + d][c], v = sb[r + d][c];
      s1 = fmaf(t, u, s1);
      s2 = fmaf(t, v, s2);
      s11 = fmaf(t, u * u, s11);
      s22 = fmaf(t, v * v, s22);
      s12 = fmaf(t, u * v, s12);
    }
    sv[0][r][c] = s1; sv[1][r][c] = s2; sv[2][r][c] = s11; sv[3][r][c] = s22; sv[4][r][c] = s12;
  }
  __syncthreads();

  for (int idx = tid; idx < MO_TH * MO_TW; idx += MO_THREADS) {
    const int r = idx / MO_TW, c = idx % MO_TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= OH || gx >= OW) continue;
    float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < ws; ++d) {
      const float t = taps.t[d];
#pragma unroll
      for (int m = 0; m < 5; ++m) o[m] = fmaf(t, sv[m][r][c + d], o[m]);
    }
    const size_t i = (size_t)n * OH * OW + (size_t)gy * OW + gx;
    mu1[i] = o[0]; mu2[i] = o[1]; m11[i] = o[2]; m22[i] = o[3]; m12[i] = o[4];
  }
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// a, b (n, h, w) f32, already padded; outputs (n, h-ws+1, w-ws+1) f32 each.
// taps: ws f32 values in host memory (copied into the launch parameters).
int mmif_moments(const float* a, const float* b, float* mu1, float* mu2, float* m11,
                 float* m22, float* m12, int n, int h, int w, int ws, const float* taps,
                 void* stream) {
  if (ws < 1 || ws > MO_MAX_WS || h < ws || w < ws || n < 1)
    return (int)cudaErrorInvalidValue;
  MomentTaps t = {};
  for (int i = 0; i < ws; ++i) t.t[i] = taps[i];
  const int oh = h - ws + 1, ow = w - ws + 1;
  const dim3 grid((ow + MO_TW - 1) / MO_TW, (oh + MO_TH - 1) / MO_TH, n);
  moments_kernel<<<grid, MO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, mu1, mu2, m11, m22, m12, h, w, oh, ow, ws, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
