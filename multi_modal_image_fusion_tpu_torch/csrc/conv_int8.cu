// The C entry point of the int8 tensor-core conv (body and design notes in
// conv_int8.cuh). Both wrappers of ops/cuda/conv_int8.py launch it:
// conv_int8 (the ConvLayer route: float input quantized by division, output
// in the input's dtype; replaces ops/pallas/conv_int8.py:219
// conv_tlane_dma_q) and conv_int8_chain (DeepFuse's chain: float input
// quantized by the reciprocal, or int8 input, fuse_n, output in the chain
// dtype or int8; replaces ops/pallas/hiw_int8.py:260 conv_hiw_chain_q).
#include "conv_int8.cuh"

using namespace mmif;

extern "C" {

// x (B, h, w, cin) in in_type (0 f32, 1 bf16, 2 int8), read at images b and
// b + fuse_n for output image b when fuse_n > 0; scale (cin,) f32: f for
// qmode 0 (round(x / f)), 1/f for qmode 1 (round(x * (1/f))), unused for an
// int8 input; w (k*k, cout_pad, cin_pad) int8 with cout_pad = cout rounded
// up to a multiple of bn (16, 32 or 64) and cin_pad = cin rounded up to a
// multiple of 32, zeros in the padding; dq (cout,) f32; bias (cout,) f32 or
// null; y (b_out, h, w, cout) in out_type (0 f32, 1 bf16, 2 int8); k 1, 3, 5
// or 7; act a common.cuh Act code.
int mmif_conv_int8(int in_type, int out_type, int qmode, const void* x, const float* scale,
                   const void* w, const float* dq, const float* bias, void* y, int b_out, int h,
                   int wd, int cin, int cout, int k, int bn, int fuse_n, int act, void* stream) {
  if (in_type < QT_F32 || in_type > QT_S8 || out_type < QT_F32 || out_type > QT_S8 ||
      (qmode != QM_DIV && qmode != QM_MUL) || cin < 1 || cout < 1 || b_out < 1 ||
      fuse_n < 0 || bn <= 0 || h <= k / 2 || wd <= k / 2)
    return (int)cudaErrorInvalidValue;
  QConvArgs a;
  a.x = x;
  a.scale = scale;
  a.w = static_cast<const int8_t*>(w);
  a.dq = dq;
  a.bias = bias;
  a.y = y;
  a.H = h;
  a.W = wd;
  a.Cin = cin;
  a.Cout = cout;
  a.cout_pad = (cout + bn - 1) / bn * bn;
  a.cin_pad = (cin + Q_CK - 1) / Q_CK * Q_CK;
  a.fuse_n = fuse_n;
  a.act = act;
  a.in_type = in_type;
  a.out_type = out_type;
  a.qmode = qmode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return conv_int8_by_bn<1>(bn, a, b_out, s);
    case 3: return conv_int8_by_bn<3>(bn, a, b_out, s);
    case 5: return conv_int8_by_bn<5>(bn, a, b_out, s);
    case 7: return conv_int8_by_bn<7>(bn, a, b_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
