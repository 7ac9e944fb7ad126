// Gaussian-window SSIM maps in one pass (VALID on input the caller padded).
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/ssim_kernel.py:86
// ssim_maps_pallas: the five products (x, y, x^2, y^2, xy), a separable
// ws-tap Gaussian (sigma 1.5 at ws 11), then the SSIM algebra with sigma^2
// clamped at 0, writing the ssim, cs and sigma1^2 maps. All f32.
//
// What bounds it on an H100: memory traffic, ~5 operations per byte (2
// reads and 3 writes of 4 bytes an output against ~2 x 5 x ws multiply-adds).
// The body is the window stencil of csrc/window_stencil.cuh (tall strips,
// the vertical pass in registers, the horizontal pass register-blocked,
// cp.async staging, coalesced stores) with the SSIM epilogue; none of the
// ten filtered maps of the plain version reaches device memory. The TPU
// kernel's lane-padded garbage tail columns do not exist here: outputs are
// exact VALID maps. Instances: ws 11 (every caller's window at 11 x 11 and
// above) and a generic one for the smaller windows calc_ssim picks on small
// images.
#include "window_stencil.cuh"

using namespace mmif;

extern "C" {

// a, b (n, h, w) f32, already padded; outputs (n, h-ws+1, w-ws+1) f32 each.
// taps: ws f32 values in host memory (copied into the launch parameters).
int mmif_ssim_maps(const float* a, const float* b, float* ssim, float* cs, float* sig1,
                   int n, int h, int w, int ws, const float* taps, float c1, float c2,
                   void* stream) {
  if (ws < 1 || ws > 11 || h < ws || w < ws || n < 1) return (int)cudaErrorInvalidValue;
  WinArgs p = window_args(a, b, h, w, ws, taps);
  p.out[0] = ssim;
  p.out[1] = cs;
  p.out[2] = sig1;
  p.c1 = c1;
  p.c2 = c2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ws == 11 ? window_launch<11, EpiSsim>(p, n, s) : window_launch<0, EpiSsim>(p, n, s);
}

}  // extern "C"
