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
// the card's f32 balance of ~20, so it is bound by memory traffic. The body
// is the window stencil of csrc/window_stencil.cuh with an epilogue that
// stores the five maps; none of the plain version's products or
// half-filtered maps reaches device memory. The TPU kernel's 128-row strips,
// lane padding and lane rolls are not carried over: outputs are exact VALID
// maps. Instances: the VIF pyramid's windows 17, 9, 5 and 3, and a generic
// one for any other window up to 17.
#include "window_stencil.cuh"

using namespace mmif;

extern "C" {

// a, b (n, h, w) f32, already padded; outputs (n, h-ws+1, w-ws+1) f32 each.
// taps: ws f32 values in host memory (copied into the launch parameters).
int mmif_moments(const float* a, const float* b, float* mu1, float* mu2, float* m11,
                 float* m22, float* m12, int n, int h, int w, int ws, const float* taps,
                 void* stream) {
  if (ws < 1 || ws > WN_MAX_WS || h < ws || w < ws || n < 1)
    return (int)cudaErrorInvalidValue;
  WinArgs p = window_args(a, b, h, w, ws, taps);
  p.out[0] = mu1;
  p.out[1] = mu2;
  p.out[2] = m11;
  p.out[3] = m22;
  p.out[4] = m12;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ws) {
    case 17: return window_launch<17, EpiMoments>(p, n, s);
    case 9: return window_launch<9, EpiMoments>(p, n, s);
    case 5: return window_launch<5, EpiMoments>(p, n, s);
    case 3: return window_launch<3, EpiMoments>(p, n, s);
    default: return window_launch<0, EpiMoments>(p, n, s);
  }
}

}  // extern "C"
