// conv_wide: the wide reflect-SAME convs of the C-major chain (UNFusion's
// nested decoder and encoder k1 convs, DBNet's decoder), NHWC, f32
// accumulate.
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/conv_kernel.py:719
// conv_tlane_chain (pallas_call :799) with halo=True: a k x k reflect-SAME
// conv with bias and activation in the epilogue and the fuse_n siamese-sum
// prologue, over the channel concat of several legs, the way the JAX
// package's ConvLayer chain route sums per-part convs (ops/layers.py:579-591):
//
//   y[b] = act(bias + sum_l conv(x_l[b + b_off_l] (+ x_l[b + b_off_l + fuse_n]), W_l))
//
// What bounds it on an H100: UNFusion's decoder convs do 0.7k-11.5k MACs per
// output pixel and channel block (DB3_1's 1280 -> 640 k3 is 577.6 GMAC a
// pair), far above the card's ~295 operations per byte of bf16 traffic, so
// they are bound by arithmetic. In bf16 conv_wide runs the wgmma implicit
// GEMM of conv_chain.cuh (conv_chain_tc_kernel, the body of conv_chain and
// conv_multi) on the tensor cores: its legs of any channel count (each
// zero-padded to whole 16-channel k-steps in the weights packed by
// ops/cuda/conv_chain.py pack_weights_tc; a ragged leg staged through
// registers), Cout zero-padded to the N block that
// pick_bn_tc picks, the weights resident where they fit and else streamed
// through the copy ring with each k-step, a fuse_n pair summed in shared
// memory where the plan fits it. What conv_wide adds to that body: a Cout
// that is a multiple of 4 (8-byte stores where it is 4 mod 8) and the s2d
// halo below.
//
// In f32 the chain's FMA body (conv_chain.cuh) runs with 16 output channels
// a block, or 8 or 4 where Cout is not a multiple of 16: TF32 would miss the
// f32 reference over 11,520-term sums.
//
// s2d mode (conv_tlane_chain's s2d_f=2, ops/layers.py:409-437 and :531 of
// the JAX package): DeepFuse's packed chain runs its k5/k7 convs as k3/k5
// convs on space-to-depth packed tensors (ops/s2d.py): enc0 4 -> 64 k3,
// enc1 64 -> 128 k5, dec0 128 -> 128 k5 with fuse_n, dec1 128 -> 64 k3,
// dec2 64 -> 4 k3. The only change is the halo: each channel's phase reads
// the packed reflect extension of the original image (src_pixel in
// common.cuh; conv_kernel.py:544-560 mirrors it on the TPU), in the bf16
// body's stage load (a staged half of 8 channels lies in one phase for
// enc1-dec2; enc0's 4 channels are one phase each) and in the f32 body's.
//
// Not carried over from the TPU kernel: the guard layout, the kw_order
// weight permutation, the ssa/ssai/acc epilogues and the VMEM-driven c_in
// chunking. The halo is reflect index math in the tile load.
#include "conv_chain.cuh"

namespace mmif {

template <int K>
static int wide_f32(const Legs& legs, const float* w, const float* bias, void* y, int b_out,
                    int h, int wd, int cout, int fuse_n, int act, cudaStream_t s) {
  if (cout % 16 == 0)
    return launch_chain<K, 16>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  if (cout % 8 == 0)
    return launch_chain<K, 8>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  return launch_chain<K, 4>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// n_legs legs: xs[l] (B_l, h, w, cins[l]) in dtype, read at batch b + b_offs[l]
// (and b + b_offs[l] + fuse_n when fuse_n > 0) for output image b; y (b_out,
// h, w, cout) in dtype; bias f32 or null; k 1, 3 or 5; cout a multiple of 4.
// s2d: one leg, space-to-depth packed (f = 2, phase-major, cins[0] a
// multiple of 4), h and w its packed sizes; the halo is the packed reflect
// extension of the original image.
// bf16: w packed by pack_weights_tc for the N block bn (conv_chain.cuh
// TcArgs::w, Cout zero-padded to a multiple of bn) that pick_bn_tc picks.
// f32: w is [sum(cins)][k][k][cout] f32 and bn is ignored.
int mmif_conv_wide(int dtype, int n_legs, const void* const* xs, const int* cins,
                   const int* b_offs, const void* w, const float* bias, void* y, int b_out,
                   int h, int wd, int cout, int k, int bn, int fuse_n, int act, int s2d,
                   void* stream) {
  if (n_legs < 1 || n_legs > MAX_LEGS || cout < 4 || cout % 4 || b_out < 1 ||
      (k != 1 && k != 3 && k != 5) || h <= k / 2 || wd <= k / 2 ||
      (s2d && (n_legs != 1 || cins[0] % 4)))
    return (int)cudaErrorInvalidValue;
  Legs legs = {};
  for (int l = 0; l < n_legs; ++l) {
    if (cins[l] < 1) return (int)cudaErrorInvalidValue;
    legs.x[l] = xs[l];
    legs.cin[l] = cins[l];
    legs.b_off[l] = b_offs[l];
  }
  legs.n = n_legs;
  legs.s2d = s2d ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_tc(k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  switch (k) {
    case 1: return wide_f32<1>(legs, wf, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 3: return wide_f32<3>(legs, wf, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    default: return wide_f32<5>(legs, wf, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  }
}

}  // extern "C"
