// Entry points of the train step's VALID conv kernels (conv_valid.cuh has
// the kernels, what they replace, what bounds them and their design):
// conv_valid in its two modes (forward with the valid step's bias and
// activation epilogue; dx, the full correlation of the cotangent) and
// conv_valid_dw. Kernel sizes 3, 5 and 7, instantiated in
// conv_valid_k3/k5/k7.cu.
#include "conv_valid.cuh"

using namespace mmif;

extern "C" {

// dx = 0: x = xp (b, hout + k - 1, wout + k - 1, cc), w (cn, cc, k, k);
// dx = 1: x = dy (b, hout - k + 1, wout - k + 1, cc), w (cc, cn, k, k).
// x, w and y (b, hout, wout, cn) in dtype, w OIHW as the layer holds it;
// bias f32 or null; bn the N block (8, 16 or 32); tw the output columns of
// a strip (1 <= tw <= wout).
int mmif_conv_valid(int dtype, int dx, const void* x, const void* w, const float* bias, void* y,
                    int b, int hin, int win, int cc, int cn, int hout, int wout, int k, int bn,
                    int act, int tw, void* stream) {
  if (b < 1 || cc < 1 || cn < 1 || hout < 1 || wout < 1 || tw < 1 || tw > wout)
    return (int)cudaErrorInvalidValue;
  const int grow = dx ? k - 1 : -(k - 1);  // hout - hin
  if (hin + grow != hout || win + grow != wout || (dx && bias)) return (int)cudaErrorInvalidValue;
  VaArgs a{x, w, bias, y, b, hin, win, cc, cn, hout, wout, dx ? 1 : 0, act, tw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return valid_tc_by_bn<3>(dtype, bn, a, s);
    case 5: return valid_tc_by_bn<5>(dtype, bn, a, s);
    case 7: return valid_tc_by_bn<7>(dtype, bn, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// xp (b, h + k - 1, w + k - 1, cin), dy (b, h, w, cout) in dtype; dw (cout,
// cin, k, k) f32; part f32 [groups][chunks][k * 16 * bn] scratch; ticket
// [groups] zeros (left zero); groups = k * ceil(cin / 16) * ceil(cout / bn).
int mmif_conv_valid_dw(int dtype, const void* xp, const void* dy, float* part,
                       unsigned* ticket, float* dw, int b, int h, int wd, int cin, int cout,
                       int k, int bn, int chunks, void* stream) {
  if (b < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  DwArgs a{xp, dy, part, ticket, dw, b, h, wd, cin, cout, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return valid_dw_by_bn<3>(dtype, bn, a, s, nullptr);
    case 5: return valid_dw_by_bn<5>(dtype, bn, a, s, nullptr);
    case 7: return valid_dw_by_bn<7>(dtype, bn, a, s, nullptr);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the conv_valid_dw instance (dtype, k, bn) that fit on one
// multiprocessor, or -1.
int mmif_conv_valid_dw_blocks(int dtype, int k, int bn) {
  DwArgs a{};
  int n = -1, err = (int)cudaErrorInvalidValue;
  switch (k) {
    case 3: err = valid_dw_by_bn<3>(dtype, bn, a, nullptr, &n); break;
    case 5: err = valid_dw_by_bn<5>(dtype, bn, a, nullptr, &n); break;
    case 7: err = valid_dw_by_bn<7>(dtype, bn, a, nullptr, &n); break;
  }
  return err == 0 ? n : -1;
}

}  // extern "C"
