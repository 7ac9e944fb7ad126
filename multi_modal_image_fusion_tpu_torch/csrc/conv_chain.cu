// Reflect-SAME k x k convolutions of the serving chain (DeepFuse k5/k7;
// DenseFuse and VIFNet k3; UNFusion's encoder, Res2Fusion's k1 and DBNet's
// dense convs), NHWC, f32 accumulate.
//
// Replaces two TPU kernels of multi_modal_image_fusion_tpu/ops/pallas/:
//   conv_chain      <- hiw_kernel.py:335 conv_hiw_chain (every chain conv,
//                      with the fuse_n siamese-sum prologue), one leg
//   conv_multi      <- hiw_kernel.py:619 conv_hiw_chain_multi: the same
//                      kernel over up to 8 legs with batch offsets
// (the chain's c_in=1 entry and c_out=1 exit convs are csrc/conv_gray.cu's)
//
// What bounds them on an H100: enc1 and dec0 (16/32 -> 32, k7) do ~25k MACs
// per output pixel against ~128 bytes of bf16 traffic, far above the card's
// ~295 operations-per-byte balance, so they are bound by the tensor cores'
// 989 TFLOP/s (2.035 ms each at 16 pairs of 1224x1024). The k3 DenseFuse and
// VIFNet layers do 2.3k-147k MACs against 64-512 bytes (72-576 operations
// per byte): the 16-channel ones are bound by their bytes, the 64- and
// 128-channel ones by operations. In bf16 conv_chain and conv_multi run the
// wgmma implicit GEMM of conv_chain.cuh on the tensor cores; in f32 its
// register-blocked FMA body (67 TFLOP/s of f32 CUDA cores; TF32 would miss
// the f32 budget). The TPU
// layout (H-major guard bands, banded weights, W-on-lanes strips) is not
// carried over: the halo is reflect index math in the tile load.
#include "conv_chain.cuh"

namespace mmif {

// Kernel sizes 1, 3, 5 and 7, as the TPU kernels take (DenseFuse and VIFNet
// run k3, DeepFuse k5 and k7); Cout a multiple of 16.
constexpr int CO_TILE = 16;

static int chain_f32(int k, const Legs& legs, const float* w, const float* bias, void* y,
                     int b_out, int h, int wd, int cout, int fuse_n, int act, cudaStream_t s) {
  switch (k) {
    case 1: return launch_chain<1, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 3: return launch_chain<3, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 5: return launch_chain<5, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 7: return launch_chain<7, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template int chain_tc_by_bn<1>(int, const TcArgs&, cudaStream_t);

// f32: w [sum cin][k][k][cout] f32, the FMA body; bf16: w packed for the
// wgmma body (conv_chain.cuh TcArgs::w) with N blocks of bn channels.
static int chain_launch(int dtype, int k, int bn, const Legs& legs, const void* w,
                        const float* bias, void* y, int b_out, int h, int wd, int cout,
                        int fuse_n, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % CO_TILE || b_out < 1 || h <= k / 2 || wd <= k / 2) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return chain_f32(k, legs, static_cast<const float*>(w), bias, y, b_out, h, wd, cout,
                     fuse_n, act, s);
  if (dtype == DT_BF16)
    return launch_tc(k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// x (b_in, h, w, cin) in dtype; w as chain_launch takes it (bn: the bf16 N
// block, 16, 32, 48, 64, 96, 128 or 256; ignored in f32); bias f32 or null;
// y (b_out, h, w, cout) in dtype. fuse_n > 0: b_in == 2 * fuse_n == 2 * b_out.
// The kernel with one leg at batch offset 0.
int mmif_conv_chain(int dtype, const void* x, const void* w, const float* bias, void* y,
                    int b_out, int h, int wd, int cin, int cout, int k, int bn, int fuse_n,
                    int act, void* stream) {
  if (cin < 1) return (int)cudaErrorInvalidValue;
  Legs legs = {};
  legs.x[0] = x;
  legs.cin[0] = cin;
  legs.n = 1;
  return chain_launch(dtype, k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, stream);
}

// n_legs legs: xs[l] (B_l, h, w, cins[l]) in dtype, read at batch b + b_offs[l]
// (and b + b_offs[l] + fuse_n when fuse_n > 0) for output image b;
// w and bn as mmif_conv_chain takes them; bias f32 or null; y (b_out, h, w,
// cout).
int mmif_conv_multi(int dtype, int n_legs, const void* const* xs, const int* cins,
                    const int* b_offs, const void* w, const float* bias, void* y, int b_out,
                    int h, int wd, int cout, int k, int bn, int fuse_n, int act, void* stream) {
  if (n_legs < 1 || n_legs > MAX_LEGS) return (int)cudaErrorInvalidValue;
  Legs legs = {};
  for (int l = 0; l < n_legs; ++l) {
    if (cins[l] < 1) return (int)cudaErrorInvalidValue;
    legs.x[l] = xs[l];
    legs.cin[l] = cins[l];
    legs.b_off[l] = b_offs[l];
  }
  legs.n = n_legs;
  return chain_launch(dtype, k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, stream);
}

}  // extern "C"
