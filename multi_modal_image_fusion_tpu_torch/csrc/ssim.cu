// Gaussian-window SSIM maps in one pass (VALID on input the caller padded).
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/ssim_kernel.py:86
// ssim_maps_pallas: the five products (x, y, x^2, y^2, xy), a separable
// ws-tap Gaussian (sigma 1.5 at ws 11), then the SSIM algebra with sigma^2
// clamped at 0, writing the ssim, cs and sigma1^2 maps. All f32.
//
// What bounds it on an H100: ~2 x 5 x ws multiply-adds per output pixel
// against 2 reads and 3 writes of 4 bytes, i.e. ~5 operations per byte,
// far below the card's balance: it is bound by memory traffic. So the
// design reads each input pixel from device memory once per tile (plus the
// ws-1 halo), keeps the five vertical-filtered maps in shared memory, and
// writes each output once; none of the ten intermediate filtered maps of the
// plain version ever reaches device memory. The TPU kernel's lane-padded
// garbage tail columns do not exist here: outputs are exact VALID maps.
#include "common.cuh"

namespace mmif {

constexpr int SS_MAX_WS = 11;
constexpr int SS_TH = 16, SS_TW = 64;
constexpr int SS_THREADS = 256;
constexpr int SS_IN_H = SS_TH + SS_MAX_WS - 1;
constexpr int SS_IN_W = SS_TW + SS_MAX_WS - 1;

struct Taps {
  float t[SS_MAX_WS];
};

__global__ void __launch_bounds__(SS_THREADS)
ssim_maps_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ ssim, float* __restrict__ cs,
                 float* __restrict__ sig1, int H, int W, int OH, int OW, int ws,
                 Taps taps, float c1, float c2) {
  __shared__ float sa[SS_IN_H][SS_IN_W];
  __shared__ float sb[SS_IN_H][SS_IN_W];
  __shared__ float sv[5][SS_TH][SS_IN_W];  // vertical-filtered x, y, xx, yy, xy

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * SS_TW;
  const int y0 = blockIdx.y * SS_TH;
  const int n = blockIdx.z;
  const size_t img = (size_t)H * W;
  const float* an = a + n * img;
  const float* bn = b + n * img;
  const int in_h = SS_TH + ws - 1, in_w = SS_TW + ws - 1;

  for (int idx = tid; idx < in_h * in_w; idx += SS_THREADS) {
    const int r = idx / in_w, c = idx % in_w;
    const int gy = y0 + r, gx = x0 + c;
    const bool in = gy < H && gx < W;
    sa[r][c] = in ? an[(size_t)gy * W + gx] : 0.f;
    sb[r][c] = in ? bn[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  for (int idx = tid; idx < SS_TH * in_w; idx += SS_THREADS) {
    const int r = idx / in_w, c = idx % in_w;
    float m1 = 0.f, m2 = 0.f, m11 = 0.f, m22 = 0.f, m12 = 0.f;
    for (int d = 0; d < ws; ++d) {
      const float t = taps.t[d];
      const float u = sa[r + d][c], v = sb[r + d][c];
      m1 = fmaf(t, u, m1);
      m2 = fmaf(t, v, m2);
      m11 = fmaf(t, u * u, m11);
      m22 = fmaf(t, v * v, m22);
      m12 = fmaf(t, u * v, m12);
    }
    sv[0][r][c] = m1; sv[1][r][c] = m2; sv[2][r][c] = m11; sv[3][r][c] = m22; sv[4][r][c] = m12;
  }
  __syncthreads();

  for (int idx = tid; idx < SS_TH * SS_TW; idx += SS_THREADS) {
    const int r = idx / SS_TW, c = idx % SS_TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= OH || gx >= OW) continue;
    float mu1 = 0.f, mu2 = 0.f, e11 = 0.f, e22 = 0.f, e12 = 0.f;
    for (int d = 0; d < ws; ++d) {
      const float t = taps.t[d];
      mu1 = fmaf(t, sv[0][r][c + d], mu1);
      mu2 = fmaf(t, sv[1][r][c + d], mu2);
      e11 = fmaf(t, sv[2][r][c + d], e11);
      e22 = fmaf(t, sv[3][r][c + d], e22);
      e12 = fmaf(t, sv[4][r][c + d], e12);
    }
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float s1 = fmaxf(e11 - mu1_sq, 0.f);
    const float s2 = fmaxf(e22 - mu2_sq, 0.f);
    const float s12 = e12 - mu1_mu2;
    const float m1v = 2.f * mu1_mu2 + c1;
    const float m2v = mu1_sq + mu2_sq + c1;
    const float v1 = 2.f * s12 + c2;
    const float v2 = s1 + s2 + c2;
    const size_t o = (size_t)n * OH * OW + (size_t)gy * OW + gx;
    cs[o] = v1 / v2;
    ssim[o] = (m1v * v1) / (m2v * v2);
    sig1[o] = s1;
  }
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// a, b (n, h, w) f32, already padded; outputs (n, h-ws+1, w-ws+1) f32 each.
// taps: ws f32 values in host memory (copied into the launch parameters).
int mmif_ssim_maps(const float* a, const float* b, float* ssim, float* cs, float* sig1,
                   int n, int h, int w, int ws, const float* taps, float c1, float c2,
                   void* stream) {
  if (ws < 1 || ws > SS_MAX_WS || h < ws || w < ws) return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int i = 0; i < ws; ++i) t.t[i] = taps[i];
  const int oh = h - ws + 1, ow = w - ws + 1;
  const dim3 grid((ow + SS_TW - 1) / SS_TW, (oh + SS_TH - 1) / SS_TH, n);
  ssim_maps_kernel<<<grid, SS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, ssim, cs, sig1, h, w, oh, ow, ws, t, c1, c2);
  return (int)cudaGetLastError();
}

}  // extern "C"
