// The k3 instances of the int8 conv body (conv_int8.cuh), in a source of
// their own so nvcc builds them beside conv_int8.cu.
#include "conv_int8.cuh"

namespace mmif {

template <>
int q8_by_bn<3>(int bn, bool tp, const Q8Args& a, cudaStream_t s) {
  if (tp) {
    switch (bn) {
      case 16: return launch_q8<3, 16, true>(a, s);
      case 32: return launch_q8<3, 32, true>(a, s);
      case 64: return launch_q8<3, 64, true>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bn) {
    case 16: return launch_q8<3, 16, false>(a, s);
    case 32: return launch_q8<3, 32, false>(a, s);
    case 48: return launch_q8<3, 48, false>(a, s);
    case 64: return launch_q8<3, 64, false>(a, s);
    case 96: return launch_q8<3, 96, false>(a, s);
    case 128: return launch_q8<3, 128, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmif
