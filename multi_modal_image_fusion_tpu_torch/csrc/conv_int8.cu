// The C entry point of the int8 conv (the quantizer and the s8 wgmma body;
// design notes in conv_int8.cuh) and the body's k1 instances. Both
// wrappers of ops/cuda/conv_int8.py launch it: conv_int8 (the ConvLayer
// route: float legs quantized by division, output in their dtype; replaces
// ops/pallas/conv_int8.py:219 conv_tlane_dma_q) and conv_int8_chain
// (DeepFuse's chain: one float leg quantized by the reciprocal, or an int8
// one, fuse_n, output in the chain dtype or int8; replaces
// ops/pallas/hiw_int8.py:260 conv_hiw_chain_q).
#include "conv_int8.cuh"

using namespace mmif;

namespace mmif {

template <>
int q8_by_bn<1>(int bn, bool tp, const Q8Args& a, cudaStream_t s) {
  if (tp) return (int)cudaErrorInvalidValue;  // k1 has no tap pairs
  switch (bn) {
    case 16: return launch_q8<1, 16, false>(a, s);
    case 32: return launch_q8<1, 32, false>(a, s);
    case 48: return launch_q8<1, 48, false>(a, s);
    case 64: return launch_q8<1, 64, false>(a, s);
    case 96: return launch_q8<1, 96, false>(a, s);
    case 128: return launch_q8<1, 128, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmif

extern "C" {

// The conv over n_legs legs xs[l] (B_l, h, w, cins[l]), read at images b +
// b_offs[l] (and b + b_offs[l] + fuse_n when fuse_n > 0) for output image
// b. A float input (in_type 0 f32, 1 bf16; one type for all legs) is first
// quantized into q (b_out, h, w, sum cins rounded up to 16) int8 by scale
// (sum cins,) f32 over the legs' channel concat: f for qmode 0 (round(x /
// f)), 1/f for qmode 1 (round(x * (1/f))); rscale (sum cins,) its
// reciprocals rounded to nearest. An int8 input (in_type 2) is one leg at
// offset 0 whose channel count is a multiple of 16; scale, rscale and q
// are unused. w: the packed int8 weights (ops/cuda/conv_int8.py
// pack_weights_int8 for sum cins input channels at N block bn); dq (cout,)
// f32; bias (cout,) f32 or null; y (b_out, h, w, cout) in out_type (0 f32,
// 1 bf16, 2 int8); k 1, 3, 5 or 7; act a common.cuh Act code.
int mmif_conv_int8(int in_type, int out_type, int qmode, int n_legs, const void* const* xs,
                   const int* cins, const int* b_offs, const float* scale,
                   const float* rscale, void* q,
                   const void* w, const float* dq, const float* bias, void* y, int b_out, int h,
                   int wd, int cout, int k, int bn, int fuse_n, int act, void* stream) {
  if (in_type < QT_F32 || in_type > QT_S8 || out_type < QT_F32 || out_type > QT_S8 ||
      (qmode != QM_DIV && qmode != QM_MUL) || n_legs < 1 || n_legs > MAX_LEGS || cout < 1 ||
      b_out < 1 || fuse_n < 0 || h <= k / 2 || wd <= k / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Q8Args a = {};
  if (in_type == QT_S8) {
    if (n_legs != 1 || b_offs[0] != 0 || cins[0] < 16 || cins[0] % 16)
      return (int)cudaErrorInvalidValue;
    a.x = static_cast<const int8_t*>(xs[0]);
    a.Cin = cins[0];
    a.fuse_n = fuse_n;
  } else {
    if (scale == nullptr || rscale == nullptr || q == nullptr) return (int)cudaErrorInvalidValue;
    QuantArgs qa = {};
    qa.cofs[0] = 0;
    qa.vec = 1;
    for (int l = 0; l < n_legs; ++l) {
      if (cins[l] < 1) return (int)cudaErrorInvalidValue;
      qa.legs.x[l] = xs[l];
      qa.legs.cin[l] = cins[l];
      qa.legs.b_off[l] = b_offs[l];
      qa.cofs[l + 1] = qa.cofs[l] + cins[l];
      qa.vec = qa.vec && cins[l] % 8 == 0;
    }
    qa.legs.n = n_legs;
    qa.scale = scale;
    qa.rscale = rscale;
    qa.q = static_cast<int8_t*>(q);
    qa.hw = h * wd;
    qa.cin_q = (qa.cofs[n_legs] + 15) / 16 * 16;
    qa.fuse_n = fuse_n;
    qa.qmode = qmode;
    // one image a grid row, its pixels' channel groups in 32-bit indices
    const long long items = (long long)qa.hw * (qa.cin_q / 16);
    if (items > 0x7fffffffLL || b_out > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(items / 256 + 1 < 1024 ? items / 256 + 1 : 1024),
                    (unsigned)b_out);
    if (in_type == QT_F32)
      q8_quantize_kernel<float><<<grid, 256, 0, s>>>(qa);
    else
      q8_quantize_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(qa);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a.x = qa.q;
    a.Cin = qa.cin_q;
  }
  // tap pairs: the input fits half a k-step
  const bool tp = k > 1 && a.Cin <= 16;
  a.KS = tp ? 1 : (a.Cin + Q_CK - 1) / Q_CK;
  a.w = static_cast<const int8_t*>(w);
  a.dq = dq;
  a.bias = bias;
  a.y = y;
  a.b_out = b_out;
  a.H = h;
  a.W = wd;
  a.Cout = cout;
  a.act = act;
  a.out_type = out_type;
  switch (k) {
    case 1: return q8_by_bn<1>(bn, tp, a, s);
    case 3: return q8_by_bn<3>(bn, tp, a, s);
    case 5: return q8_by_bn<5>(bn, tp, a, s);
    case 7: return q8_by_bn<7>(bn, tp, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
