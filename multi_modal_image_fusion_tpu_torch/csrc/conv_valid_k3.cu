// The k3 instances of the train step's VALID conv kernels (conv_valid.cuh),
// in a source of their own so nvcc builds them beside conv_valid.cu.
#include "conv_valid.cuh"

namespace mmif {
template int valid_tc_by_bn<3>(int, int, const VaArgs&, cudaStream_t);
template int valid_dw_by_bn<3>(int, int, const DwArgs&, cudaStream_t, int*);
}  // namespace mmif
