// The k5 instances of the int8 conv body (conv_int8.cuh), in a source of
// their own so nvcc builds them beside conv_int8.cu.
#include "conv_int8.cuh"

namespace mmif {

template <>
int q8_by_bn<5>(int bn, bool tp, const Q8Args& a, cudaStream_t s) {
  if (tp) {
    switch (bn) {
      case 16: return launch_q8<5, 16, true>(a, s);
      case 32: return launch_q8<5, 32, true>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bn) {
    case 16: return launch_q8<5, 16, false>(a, s);
    case 32: return launch_q8<5, 32, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmif
