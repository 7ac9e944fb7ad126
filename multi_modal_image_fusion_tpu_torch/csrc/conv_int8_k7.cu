// The k7 instances of the int8 tensor-core conv (conv_int8.cuh), in a
// source of their own so nvcc builds them beside conv_int8.cu.
#include "conv_int8.cuh"

namespace mmif {
template int conv_int8_by_bn<7>(int, const QConvArgs&, int, cudaStream_t);
}  // namespace mmif
