// The k3 bf16 instances of the wgmma conv_chain body (conv_chain.cuh), in a
// source of their own so nvcc builds them beside conv_chain.cu.
#include "conv_chain.cuh"

namespace mmif {
template int chain_tc_by_bn<3>(int, const TcArgs&, cudaStream_t);
}  // namespace mmif
