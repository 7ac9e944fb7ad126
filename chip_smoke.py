#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 off, so f32 comparisons are f32.
2. Build every kernel from the sources in multi_modal_image_fusion_tpu_torch/
   csrc/ (one nvcc per source, in parallel); print the build time. Count
   the HGMMA (wgmma) instructions in the SASS of every bf16 conv_chain /
   conv_multi / conv_wide instance (the one wgmma body, conv_chain_tc_kernel;
   cuobjdump -sass of the library; fails without the tool or with an
   instance that has none, if a bf16 FMA conv_chain_kernel was built, if a
   kernel of conv_wide's own is left beside it) and print ptxas's
   registers, spills and shared memory of each, failing on a spill. The same for the two bf16 nl kernels (their
   HGMMA, and the HMMA of warp-level mma.sync, of which they must hold
   none), failing on a spill or on wgmmas that ptxas serialized. And for
   the int8 body (rows 11 and 12, conv_int8_tc_kernel): the integer wgmma
   instructions (IGMMA) of every instance, failing on an instance without
   them, on a warp-level IMMA in one, on a mma.sync conv_int8_kernel left
   in the library, on a spill or on a serialized wgmma. And for the enter
   and exit convs (csrc/conv_gray.cu): the warp-level bf16 MMAs (HMMA) of
   every bf16 instance (none in the f32 ones), failing on an instance
   without them or on a spill in the instances of the models' activations
   (relu, none). And for the pair kernels (csrc/conv_pair.cu): the HGMMA
   and HMMA of the bf16 enter and exit (enc1 and dec1 on wgmma, enc0 and
   dec2 on mma.sync), neither in the f32 ones, failing on a wgmma that
   ptxas serialized or a spill in the instances of the models'
   activations. And for the train step's VALID conv (csrc/conv_valid.cuh):
   the HMMA of every conv_valid_tc_kernel and conv_valid_dw_kernel
   instance, TF32 ones only in f32 (a multiple of 3: the 3xTF32 split) and
   BF16 ones only in bf16, failing on fewer than one split product a tap
   and n tile or on a spill. And ptxas's registers and spills of every
   conv_dw instance (csrc/conv_dw.cu: k1, the k3 tile kernel's channel
   slices with and without the add, the k5 and k7 ones with their taps in
   shared memory, bf16 and f32), failing on a spill or a missing instance.
3. Hold each kernel (conv_gray_enter, conv_chain, conv_gray_exit; the
   convs in DeepFuse's k5/k7 instances, DenseFuse's and VIFNet's k3
   ones, DBNet's 32-channel enter, UNFusion's k1 exit and its nine encoder
   convs at their scales, NestFuse's k1 enter and 64-channel k1 exit, its
   twelve conv_chain convs and RFN1's conv1 and fuse2) against its
   plain PyTorch version on the card: at the main path's shapes (1224x1024;
   bf16 batch 16 as the bench runs it, f32 batch 1 as the test CLI runs
   it) and at 45x61, with tolerances relative to the plain output's largest
   magnitude: f32 1e-4 of max(|y|, 1) (same f32 products, another
   summation order), bf16 1e-3 of max|y| beyond one bf16 ulp of each output
   (the same exact products of bf16 weights and inputs summed in f32 in
   another order, one rounding to bf16, which may land on the neighbouring
   value). At the bench's shapes each bf16 conv_chain check has controls
   that must miss by 10x: the taps transposed, the halo zero-padded
   instead of reflected (a k1 conv: its input channels reversed), and for
   fuse_n one half's images in reverse order;
   so has each enter and exit check (the taps transposed, the zero halo,
   the enter's two images swapped, a k1 exit's input channels reversed, a
   k1 enter's bias dropped and output channels reversed),
   and the enter and exit are also checked where their last tile is
   ragged (8x200, 1224x1000). Each enter is also timed as a raw launch of
   its C entry (weights packed and output allocated beforehand), with the
   wrapper's host time a call and F.conv2d + relu as a second library
   time.
   Time the kernel, the plain version and, for the convs, one F.conv2d on
   the reflect-padded input in the same dtype (the pad timed apart), each
   with CUDA events over cold-L2 repetitions; compute each kernel's bound
   from this run's shapes.
4. Main path, with every launch count set to 0 just before it (and the
   smoke's own heap collected and frozen first, so no garbage collection
   over it lands in a timed forward or CLI pair): the port's
   bench (DeepFuse, 1224x1024, bf16, batch 16, 1 warmup + 10 timed
   forwards), then the port's test CLI on 51 synthetic 1224x1024 BMP pairs
   with a seeded checkpoint (the first pair is the CLI's warmup; the other
   50 give the per-pair latency's median and spread). Counts are read just
   after; every kernel must have run, and each forward must be 1 enter +
   3 chain + 1 exit launches.
5. Check the outputs: the bench's last timed batch (16 bf16 fused pairs)
   has a mean SSIM against its inputs within 1e-3 of the f32 plain forward
   of the same weights on the same inputs (the BASELINE contract), and the
   CLI's SSIM is finite and within 1e-4 of the f32 plain path on the card,
   its NN.bmp files exist and it printed fps.
6. Training, with every launch count set to 0 just before it: the port's
   train CLI on 10 synthetic seeded 512x512 BMP pairs (8 train, 2 valid) at
   the reference defaults (bs 16, 64x64 patches, f32, --fast_train), 2
   epochs of 32 train steps and 8 valid batches. Counts are read just
   after: conv_valid must have launched exactly 9 times a train step (5
   forward, 4 dx) and 5 times a valid batch, conv_valid_dw 5 times a train
   step. Each train step is timed (host
   clock, synchronised before and after); the median and spread exclude
   the first epoch's first 3 steps. Then one train step (train mode) of
   every model that trains (TRAIN_CHECKS: the 16 models, MyFusion in its
   default and both MetaFormer configurations) through the kernels,
   through F.conv2d (TF32 off) and through F.conv2d in float64, each on
   its own copy, at a weight seed whose step is live and whose f32
   F.conv2d route lies within TRAIN_COND of float64 (`train_seed`):
   conv_valid launched exactly where the model has a dense k3/k5/k7 conv,
   Res2Fusion's nl kernels inside the step with a gradient (its autograd
   Function), loss parts within 1e-5 relative and gradients within 1e-4 of
   the largest gradient magnitude of the f32 route's, each gradient within
   1e-4 of its own largest magnitude (DeepFuse, DenseFuse) or of the
   largest float64 gradient (the others) of the float64 route's, the new
   running statistics equal across the routes within 1e-5 relative, every
   parameter the loss reaches with a non-zero gradient, a bias under a
   norm near zero; and each model's step time through the Trainer,
   kernels and F.conv2d (`train_step_check`). Then IFCNN trained by the
   train CLI (--fast_train, one epoch) and its checkpoint served by the
   test CLI, its trained running statistics folded (`bn_cli_path`).
   Then 20 DeepFuse steps under torch.profiler on one
   device batch: summed kernel time against the wall time of the same steps
   without the profiler (the device's busy share), and the conv_valid
   kernels', the dw kernel's (by name and by its range), the loss's and the
   optimizer's device time. Last, the
   port's test CLI on the checkpoint the training wrote: its SSIM must be
   finite.

Phase 3 also holds conv_valid (forward and dx modes) and conv_valid_dw
against their plain versions (TF32 off; f32 1e-4, bf16 1e-3 of the largest
output, a bf16 output beyond one ulp): the 5 forward, 4 dx and 5 dw
launches of a train step in f32 and bf16 (and SEDRFuse's step's: enc0 1 ->
64, the ResBlock's 256 -> 256 at 16x16, dec2 64 -> 1, k3), a k3 layer and
a 1-image 20x50 case of each mode, the valid step's bias+relu and
bias+none epilogues, and enc1 at 1224x1024 in bf16, batch 2; controls
that must miss by 10x (dx: the taps not flipped, the halo shifted by one;
dw: kh and kw swapped), and dw's bits equal on two runs. The library time is one F.conv2d on the same
pre-padded input (forward), one torch.nn.grad.conv2d_input (dx) or one
torch.nn.grad.conv2d_weight (dw); f32 bounds also at the 3xTF32 rate. It
holds ssim_maps and moments (rows 4 and 6, one window-stencil body)
against their plain versions at every shape the test and eval CLIs launch
(the test CLI's 1x1224x1024 pair, the eval chunk's 16 pairs at its five
MS-SSIM levels and its four VIF scales, ab_times.window_cases), f32 at
1e-4 of max(|y|, 1), with controls that must miss by 10x (the plain maps
of the pair shifted by one row and by one column), and at 45x61 with
use_padding; times per shape the raw launch (its C entry on outputs allocated beforehand: `ms`),
the wrapper call and the wrapper's host time a call, the plain version,
and as the library two grouped F.conv2d passes over the five stacked
products (the products timed apart); and conv_multi
against the concat of its legs and conv_chain_plain at DenseFuse's dense
convs and dec0, VIFNet's 8-leg dec0, NestFuse's 3-leg DB2_2 conv1 and
RFNNest's RFN1 res (two legs of one tensor at b_offs 0 and n) and fuse1
at their scales of 1224x1024 (bf16 batch 16, f32
one pair) and at k1, k5, 1-channel-leg and identity-leg cases at 45x61,
at conv_chain's tolerances, the bf16 bench shapes with controls that must
miss by 10x (the taps transposed, two legs of one width swapped, res's
b_offs swapped, the halo zero-padded, one fuse_n half reversed); its
library time one F.conv2d on
the padded concat (the concat and the pad timed apart).

Phase 3 also holds the non-local attention kernels nl_minmax and nl_apply
against their plain two-pass version (nl_spatial_plain's passes) at the
shapes of Res2Fusion's 112-channel attention: 1224x1024 bf16 batch 2 (one
nl call of the res2fusion bench) and f32 batch 1 (the test CLI's), 45x61
and a ragged 20x50, and at the edges of the bf16 kernels' tiling (64 keys
a tile, 256 and 128 query rows a block: ragged last tiles and blocks), on
independent centred q and k (k of zero mean, so the output is the
attention term alone). nl_minmax is held to 1e-4 of the range hi - lo in
both dtypes, nl_apply to 1e-4 (f32) and 5e-2 (bf16) of the largest
attention term, and bf16 nl_apply to 1e-2 of it against
nl_apply_flash_plain, the same function with the TPU kernel's rounding;
at every shape a control (keys swapped within pairs in the value product;
k's channels rolled by 8 for the range) must fail those tolerances, and
with one image's queries scaled 3x the range and output reduced per image
must fail them too. nl_apply's library time is one
scaled_dot_product_attention(q, k, k, scale=1/(hi-lo)) (the same
function: softmax is shift-invariant), nl_minmax has none; the bf16
wrappers' key repack is timed apart. And conv_dw
against F.conv2d(groups=C) in f32 at all 12 of a Res2Fusion forward's
depthwise layers (RB1 dw0-dw3, RB2 dw0-dw7: k1, k3, with and without the
added previous group): 1224x1024 bf16 batch 4 and f32 batch 2, and 45x61,
with controls at the full sizes (the window shifted by 8 channels, a zero
halo) that must fail; timed at the full sizes as wrapper calls, raw
launches and the wrapper's host time; its library time is one
F.conv2d(groups=C) on the padded window (the window's copy and the pad
timed apart).

Phase 3 also holds conv_wide (the wide chain conv of UNFusion, DBNet,
MAFusion and NestFuse's 8-mod-16 widths;
in bf16 the wgmma body of conv_chain, its N block and weight plan beside
each layer's times) against its plain version (the legs' concat, F.conv2d in f32, TF32 off) on
centred independent inputs: UNFusion's DB3_1 conv1 (legs 256 + 1024 ->
640, 306x256, batch 2), DB1_3 conv1 (legs 16 x 3 + 64 -> 56, 1224x1024,
batch 2), an odd 45x61 case, DBNet's dec0 with fuse_n at 1224x1024,
NestFuse's CB1_0 conv1 (16 -> 8, 32 images), CB3_0 conv1 (112 -> 56, 32
images at 306x256) and DB1_1 conv1 (legs 64 + 112 -> 88, 16 images) and
MAFusion's DB1 conv1 (legs 64 + 128 + 256 + 512 -> 480, 4 images), in
f32 (1e-4 of max|y|) and bf16 (1e-3 of max|y| beyond one bf16 ulp of each
output), each with controls that must miss by 10x (the taps transposed;
two legs of one width swapped); then every conv_wide launch of a UNFusion,
a DBNet, a NestFuse and a MAFusion forward at 1224x1024, bf16 at the
bench's pairs (16; MAFusion 4) and f32 at the test CLI's pair, checked
and timed beside the plain version and one
F.conv2d on the padded concat (the concat and the pad timed apart).

Phase 3 also holds the int8 kernels (rows 11 and 12) against their plain
versions (the exact integer conv in float64 and the same one-rounding
epilogue): conv_int8_chain at DeepFuse's chain legs (enc1 to an
int8-resident output, dec0 on int8 input with fuse_n to int8, dec1 on int8
input; enc1 and dec0 without resident hops) at 1224x1024, bf16 16 pairs
and f32 one pair; conv_int8 at DeepFuse's five layers, DenseFuse's eight
and UNFusion's DB3_1 conv1 (bf16 16 pairs; DeepFuse also f32 one pair),
as the int8 forwards launch them: legs read in place, a fuse_n pair summed
in the kernel.
int8 outputs must be equal, f32 within 1e-6 of max|y|, bf16 within one
bf16 ulp of each output; controls (taps transposed, the fold left out of
the weights, one fuse_n half's images in reverse order) must miss by more
than 1e-2 of max|y|. Input channel ranges span 100x so the fold matters.
Times beside the plain version, one torch._int_mm on the im2col'd int8
input (the unfold timed apart) and one bf16 F.conv2d on the padded input.

Later paths, each with every count set to 0 just before it and read just
after, with exact counts: the eval CLI in both sheet layouts over the 51
NN.bmp files phase 4's test CLI dumped (8 moments and 12 ssim_maps
launches per eval_metrics call, one call per chunk of at most 16 images;
51 rows plus mean and std; every value finite; the first 3 images' card
values within 1e-4 relative, VIFF 1e-3, of the same function on CPU
tensors, and so are image 16's (the last of a full chunk) and image 51's;
its wall seconds and ms a pair; then, outside the counts, its time split
chunk by chunk into BMP decoding, eval_metrics and xlsx writing, and one
chunk's eval_metrics device time by kernel: ssim_maps, moments, the torch
rest); the test CLI on a seeded
DenseFuse checkpoint with fusion_mode l1 over 11 pairs and on a seeded
Res2Fusion checkpoint over 3 pairs (SSIM within 1e-4 of the f32 plain path
on the card: F.conv2d for every conv, TF32 off, and the plain 'nl'
attention); the test CLI on seeded DBNet, UNFusion, NestFuse, RFNNest and
MAFusion checkpoints over 3 pairs each (f32; SSIM within 1e-4 of the f32 plain
path, each fused image within 1e-4 relative); the bench with --model
densefuse and --model vifnet (batch
16), --model res2fusion (batch 2: 1 enter, 5 chain, 4 conv_multi, 12
conv_dw, 2 nl_minmax, 2 nl_apply and 1 exit launches a forward), --model
dbnet, unfusion, nestfuse and rfnnest (batch 16) and mafusion (batch 4)
(FORWARD_LAUNCHES; their peak device memory; the three new models' weights
from the first seed whose fused image is live, `live_seed`, also for their
test CLIs), each held to the BASELINE
contract on its last batch: mean SSIM
and Qabf within 1e-3 of the f32 forward (VIFNet too; the gap to the bf16
forward through F.conv2d is printed beside it) and a fused image that is
not constant, Res2Fusion, DBNet, UNFusion, NestFuse, RFNNest and MAFusion
with a profiled forward split by kernel group. The DeepFuse
contract of phase 5 holds Qabf too. Then int8: the test CLI --int8 on the
51 pairs (f32; the calibration line; 4 calibration forwards on the float
kernels, then 1 enter + 3 conv_int8_chain + 1 exit a pair; the kernel
path equal to the plain int8 path on the card over 6 pairs, within 2e-2
max and 1e-4 mean of max|y|), and the bench --int8 of DeepFuse, DenseFuse
and UNFusion (16 pairs; its calibration forward counted apart, then
exactly 1 enter + 3 conv_int8_chain + 1 exit, 8 and 29 conv_int8 a
forward; peak memory), each with its quality gap (mean SSIM and Qabf of
int8 against the f32 and the bf16 forwards; DeepFuse with
MMIF_HIW_INT8_RES=1 and 0), reported and not gated.

DeepFuse's opt-in chain routes (rows 10, 13, 14 and row 9's s2d mode):
phase 3 holds conv_pair_enter and conv_pair_exit (the fused enc0 + enc1
and dec1 + dec2), conv_wide's s2d mode at DeepFuse's five packed layers
(k3 and k5, c_in 4, c_out 4) and s2d_enter / s2d_exit against their plain
versions at 1224x1024, bf16 at the bench's 16 pairs and f32 at the test
CLI's pair: the pair and the packed conv within conv_wide's tolerance
(f32 1e-4 of max|y|, bf16 1e-3 beyond one ulp of each output), each with
a control that must miss by 10x (the mid's halo computed over the
extended input, and for the pair also that control on the bf16 walk's
bottom-right tile only; the phase-blind reflect of the packed tensor), and
the packed dec2 (4 output channels, 8-byte stores) written into the head of a
buffer prefilled with a sentinel that must stay past the output; the pack
and unpack bit for bit, with a pack whose px phases are swapped as the
control. Times beside the plain versions and the library: two F.conv2d a
pair, one F.conv2d on the per-phase padded packed input,
F.pixel_unshuffle / F.pixel_shuffle (the pads, concats and NHWC permutes
timed apart). Later paths, counts from 0 before each: the DeepFuse bench
(bf16, 16 pairs) under MMIF_CHAIN_PAIR=1 (exactly 1 conv_pair_enter + 1
conv_chain + 1 conv_pair_exit a forward), MMIF_S2D=1 MMIF_CHAIN_HIW=0 (5
conv_wide in s2d mode) and with MMIF_S2D_IO=1 too (1 s2d_enter + 5
conv_wide + 1 s2d_exit), each beside phase 4's default pairs/s and held
to the BASELINE contract; the test CLI (f32, 3 pairs) under the pair and
packed switches, its SSIM and each fused image within 1e-4 of the f32
default route; the bench --int8 with MMIF_CHAIN_PAIR=1, whose forwards
take the float pair route (no conv_int8_chain launch). Every kernel of
the `kernels` line must have launched on a path.

PFNetv1, PFNetv2, IFCNN, DIFNet and PMGI: phase 2 counts the
k7 and two-gray-leg enter instances (no spill in the two-leg ones, whose
lrelu takes the switch); phase 3 holds the k7 enter (IFCNN's enc0, 1 ->
64, with the enter's controls and ragged tiles), the two-gray-leg enter
and the exit over eight legs (`check_gray_legs`: controls in bf16 and f32
at 1224x1024: the second leg's weight dropped, the legs' weights swapped,
taps transposed, a zero halo; the tanh left out, two legs swapped, a leg's
batch offset wrong), their conv_chain shapes (IFCNN's 64 channels,
DIFNet's and PMGI's 16, PFNetv2's fuse1 and fuse2) and conv_multi shapes
(DIFNet's identity leg and batch-half fuse, PMGI's 4-leg conv), and times
PFNetv2's fuse net three ways (`check_fuse_net`: the block-diagonal
route, `F.conv2d(groups=64)`, the grouped work's bound). Later paths, each
with counts from 0: their benches (16 pairs, exact FORWARD_LAUNCHES,
profiled forwards, peak memory) and contracts, and their test CLIs (3
pairs), with weights from `seeded_model` (batch norms with seeded random
statistics). IFCNN's, DIFNet's and PMGI's f32 plain path is the serving
kernels' plain versions on the folded weights (`plain_kernels`): a
normed layer's F.conv2d route is its training route, which raises.

SEDRFuse (group norms, stride-2 and transpose convs, the softmax-attention
fusion): phase 3 holds its three serving launches (`check_sedrfuse`:
enc0 on the k3 enter, 1 -> 64 without activation; the ResBlock's conv on
conv_chain, 256 -> 256 at 306x256, 32 images; dec2 on the exit, 64 -> 1,
relu) in bf16 at the bench's 16 pairs and in f32 at the test CLI's pair,
with controls that must miss by 10x in both (the taps transposed, a zero
halo, the enter's images swapped, the exit's relu left out), and times
its forward's library parts at the bench's shapes beside their bounds:
enc1 and enc2 on F.conv2d, dec0 and dec1 on F.conv_transpose2d, the group
norm of enc0's output (the port's `group_norm` against F.group_norm on
the NCHW view). Later paths, counts from 0: its bench (16 pairs, exactly
1 enter, 2 conv_chain and 1 exit a forward; peak memory; a profiled
forward split into conv kernels, cuDNN's convs (`cudnn_conv_ms`, the
device time under aten::convolution) and torch ops), its contract, its
test CLI (3 pairs; its f32 plain path is F.conv2d, fast_training(False):
a group norm has no statistics, so its training route is the serving
function), weights from `seeded_model` (group norms' scale and bias
seeded) at a `live_seed`; phase 6 checks one SEDRFuse train step
(`train_step_check`: its stride-1 convs on conv_valid, the biases under a
group norm at a zero gradient).

MyFusion (its default configuration: sep encoder, nest decoder, 'sca'
fusion, strided depthwise downs, every level shared): phase 2 counts the
enter's 8-channel k1 instances (relu6 compiled in, so spill-checked);
phase 3 holds its enter (1 -> 8, k1, relu6; the k1 enter's controls,
ragged tiles), its exit (16 -> 1, k1, relu6; a k1 exit's control), three
conv_chain shapes (level 1's pw 8 -> 16, pwconv1 16 -> 64, DB1_1's pw2
24 -> 16), two conv_multi shapes (pwconv2 with its identity leg,
DB2_1's k1 pw1 over two legs), conv_wide's k1 over two legs to 24
(control: the input channels reversed, as for every k1 conv_multi check)
and its two launches (DB1_1's and DB1_3's pw1),
conv_dw at five shapes (`check_myfusion`: 8 k1 relu6, 64 and 512 k3, 24
and 40 k3 relu6; controls a zero halo or the channels reversed), and
times its three strided depthwise downs on cuDNN beside their bound.
Later paths, counts from 0: its bench (16 pairs; exactly 1 enter, 14
conv_chain, 8 conv_multi, 2 conv_wide, 11 conv_dw and 1 exit a forward;
peak memory; a profiled forward), its contract, its test CLI (3 pairs)
and the test CLI of the res2_plain_rfn configuration (res2 encoder, plain
decoder, RFN, max-pool downs, no level shared; 3 pairs: 2 enters, 38
conv_chain, 16 conv_multi, 37 conv_dw, 1 exit a pair), weights at a
`live_seed` of each.

MyFusion's MetaFormer, MixConv and transformer encoders: phase 2 counts
conv_dw's k5 and k7 instances (no spill); phase 3 holds the 8-channel k1
enter without an activation (conv_in under act hswish, silu or gelu, or
norm 'layer'), conv_dw at MixConvBlock's four windows (k1, k3, k5, k7, each
C of its 4C channels read in place) at level 1 (16 of 64 channels, 32
images of 1224x1024) and level 4 (128 of 512 at 153x128), bf16 and f32,
each with a control that must fail (a zero halo; k1 the channels
reversed), timed beside its bound and F.conv2d(groups=C); and the
Attention's SDPA route (`check_sdpa`: flash in bf16, memory-efficient in
f32) against the plain einsum-softmax-einsum at the level-3 shape (306x256,
64 channels, 4864 keys), a control with k's heads rolled, its bound from
its bytes, products and exponentials, and a float64 input refused rather
than sent to the math backend. Later paths, counts from 0: the benches of
transformer_fs_elem and mixformer_ls_concat (16 pairs; exact
FORWARD_LAUNCHES; pairs/s, ms a forward, peak memory, a profiled forward
split into conv kernels, SDPA, cuDNN's pools and downs and the other torch
ops), their contracts (f32 plain path: the kernels' plain versions, the
attention on SDPA), and the test CLI of mixformer_ls_concat (3 pairs),
weights at a `live_seed` of each.

Phase "parallel" (after phase 6, its seconds stamped; `parallel_phase`),
every count set to 0 before each path: height tiling (parallel/
tiling.py) of DeepFuse (whole-model slabs), MAFusion, UNFusion and
Res2Fusion (two phases) on one H x W pair reflect-padded to 1248 rows, f32
and bf16: `tiled_forward(4)` against the whole forward (f32 within 1e-5
of max|y|, bf16 within 1e-3 of max|y| beyond one bf16 ulp, UNFusion's
bf16, whose cuDNN stride-2 convs pick their algorithm per shape, no
farther from the f32 forward than its whole bf16 output: TILE_CUDNN; the
largest difference printed), an enter and an exit a slab and every kernel of the
whole forward at least as often, peak device memory and ms a pair both
ways, and in f32 the controls halo 0 and MAFusion without the bilinear
tile context, which must miss by 10x; MAFusion's and UNFusion's bf16
forwards profiled tiled and whole (the slabs' bilinear span against the
conv kernels); DeepFuse under --int8 tiled against whole (the int8 chain
a slab); the test CLI with --tiles 4
(UNFusion, 3 pairs: the note, the launches, its SSIM equal to the
untiled CLI's on the same padded input within 1e-6); the train CLI with
--multihost at WORLD_SIZE=1 over NCCL (DeepFuse, --fast_train, an epoch
of one step) against the plain CLI, on cuDNN's deterministic
algorithms: equal bit for bit, or within 1e-6 where the plain one does not repeat itself
(the reflect pad's atomic backward, named); a step's time with and
without the world-1 group; two gloo ranks sharing the card (`run_ranks`,
`dist_rank`): one step of DeepFuse through conv_valid and of IFCNN on
F.conv2d and through conv_valid (DIST_CASES, the CPU test's) at a global
batch of 16 64x64 pairs against the one-process step on the card
replaying the ranks' piecewise decisions, whose flips against its own
`excess` bounds (`dist_errors`, `dist_within`; beside it the error
against the plain one-process step and the reversed batch's noise),
conv_valid launched on each rank where fast, both
ranks' parameters equal, the controls (no gradient all-reduce, per-rank
batch statistics) missing by 10x, 10 more steps timed on each rank.

Progress lines `[N s] what (M GiB held)` stamp the phases with the device
memory live tensors hold. Prints the `kernels` JSON line, the card line,
and last
{"ok": true, "device": {...}}. Needs one card; exits non-zero without one.
"""

import collections
import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 1224, 1024
BATCH = 16
REPS = 3
CLI_PAIRS = 51        # the first is the CLI's warmup
# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
TOL = {"f32": 1e-4, "bf16": 2e-2}


_START = time.perf_counter()


def stamp(what):
    """A progress line with the seconds since the script started and the
    device memory that live tensors hold."""
    torch = sys.modules.get("torch")
    held = (f" ({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB held)"
            if torch is not None and torch.cuda.is_initialized() else "")
    print(f"[{time.perf_counter() - _START:.1f} s] {what}{held}", flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas_props(log, wanted):
    """ptxas -v's registers, spills and static shared memory of every
    function of the build log for which wanted(name) holds."""
    props, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if wanted(m.group(1)) else None
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            props[fn] = {"spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in props:
            sm = re.search(r"(\d+) bytes smem", line)
            props[fn].update(registers=int(m.group(1)),
                             static_smem=int(sm.group(1)) if sm else 0)
            fn = None
    return props


def tensor_core_report(build, lib_path):
    """Phase 2's proof that the bf16 conv_chain / conv_multi / conv_wide
    and nl kernels run on the tensor cores: the HGMMA (wgmma) instructions
    in the SASS of every conv_chain_tc_kernel instance (cuobjdump -sass of
    the built library), no bf16 instance of the FMA conv_chain_kernel and
    no conv_wide kernel of its own; then ptxas's registers, spills (none
    allowed) and static shared memory of each wgmma instance. For each bf16 nl kernel (NL_KERNELS) its HGMMA, that it holds
    no HMMA (warp-level mma.sync), and its ptxas registers with no spills.
    Returns the conv_chain summary and the nl kernels' reports."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        raise AssertionError(f"cuobjdump not found beside nvcc "
                             f"({cuobjdump}): cannot count HGMMA")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, hmma, igmma, imma, fn = {}, {}, {}, {}, None
    hmma_ops = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = hmma[fn] = igmma[fn] = imma[fn] = 0
            hmma_ops[fn] = set()
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
        elif fn is not None and "HMMA" in line:
            hmma[fn] += 1
            hmma_ops[fn].add(re.search(r"HMMA[\w.]*", line).group(0))
        elif fn is not None and "IGMMA" in line:
            igmma[fn] += 1
        elif fn is not None and "IMMA" in line:
            imma[fn] += 1
    tc = {f: c for f, c in counts.items() if "conv_chain_tc_kernel" in f}
    fma = [f for f in counts if "conv_chain_kernel" in f]
    if not tc or min(tc.values()) == 0:
        raise AssertionError(f"conv_chain_tc_kernel instances without "
                             f"HGMMA: {tc}")
    # conv_wide launches these instances (bf16) and conv_wide.cu's copies of
    # the FMA conv_chain_kernel (f32): no kernel of its own is left
    own = [f for f in counts
           if "conv_wide" in f and "conv_chain_kernel" not in f]
    if own:
        raise AssertionError(f"conv_wide kernels beside the wgmma body: "
                             f"{own}")
    if any("bfloat16" in f for f in fma):
        raise AssertionError(f"a bf16 FMA conv_chain_kernel was built: "
                             f"{fma}")
    def inst(f):
        return "k{}/bn{}".format(*re.search(r"ILi(\d+)ELi(\d+)EE",
                                            f).groups())
    print(f"SASS: {sum(tc.values())} HGMMA in {len(tc)} "
          f"conv_chain_tc_kernel instances (per instance "
          f"{ {inst(f): c for f, c in sorted(tc.items())} }); "
          f"{len(fma)} FMA conv_chain_kernel instances, none bf16")
    log = build.build_log()
    serialized = [line.strip() for line in log.splitlines()
                  if "serialized" in line and ("conv_chain_tc" in line
                                               or "_ws_kernel" in line)]
    if serialized:   # ptxas made the wgmmas wait for each other
        raise AssertionError("ptxas serialized the wgmmas: "
                             + "; ".join(serialized))
    ptxas = _ptxas_props(log, lambda f: "conv_chain_tc_kernel" in f)
    if set(ptxas) != set(tc):
        raise AssertionError(f"ptxas -v lines for {sorted(ptxas)}, SASS "
                             f"for {sorted(tc)}")
    spills = {inst(f): v for f, v in ptxas.items()
              if v["spill_stores"] or v["spill_loads"]}
    if spills:
        raise AssertionError(f"conv_chain_tc_kernel instances spill: "
                             f"{spills}")
    print("ptxas -v, conv_chain_tc_kernel (the dynamic shared memory is "
          "the launch's tc_plan): " + json.dumps(
              {inst(f): v for f, v in sorted(ptxas.items())}))
    nl_ptxas = _ptxas_props(log, lambda f: any(
        k in f for k in NL_KERNELS.values()))
    nl = {}
    for name, kern in NL_KERNELS.items():
        fns = [f for f in counts if kern in f]
        props = [v for f, v in nl_ptxas.items() if kern in f]
        if len(fns) != 1 or len(props) != 1:
            raise AssertionError(f"{name}: SASS functions {fns}, ptxas "
                                 f"lines {props}")
        nl[name] = {"hgmma": counts[fns[0]], "hmma": hmma[fns[0]],
                    **props[0]}
        if (nl[name]["hgmma"] == 0 or nl[name]["hmma"] != 0
                or props[0]["spill_stores"] or props[0]["spill_loads"]):
            raise AssertionError(f"{name} ({kern}): {nl[name]}: want HGMMA, "
                                 f"no HMMA and no spills")
    print(f"SASS and ptxas -v, bf16 nl kernels: {json.dumps(nl)}")
    # the int8 body (rows 11 and 12): integer wgmma (IGMMA) in every
    # conv_int8_tc_kernel instance, no warp-level IMMA there, no mma.sync
    # conv_int8_kernel left, no spill, no serialized wgmma
    i8 = [f for f in counts if "conv_int8_tc_kernel" in f]
    old = [f for f in counts if "conv_int8_kernel" in f]
    mnemonics = sorted({m.group(0) for m in re.finditer(
        r"\bI\w*MMA[\w.]*", sass)})
    print(f"SASS integer MMA mnemonics: {mnemonics[:12]}")
    if old or not i8 or any(igmma[f] == 0 or imma[f] for f in i8):
        raise AssertionError(
            f"int8: want IGMMA and no IMMA in every conv_int8_tc_kernel and "
            f"no conv_int8_kernel; IGMMA "
            f"{ {f: igmma[f] for f in i8} }, IMMA "
            f"{ {f: imma[f] for f in i8} }, mma.sync kernels {old}")
    serialized = [line.strip() for line in log.splitlines()
                  if "serialized" in line and "conv_int8_tc" in line]
    if serialized:
        raise AssertionError("ptxas serialized the int8 wgmmas: "
                             + "; ".join(serialized))

    def inst8(f):
        k, bn, tp = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", f).groups()
        return f"k{k}/bn{bn}" + ("/tp" if tp == "1" else "")
    i8_ptxas = _ptxas_props(log, lambda f: "conv_int8_tc_kernel" in f)
    if set(i8_ptxas) != set(i8):
        raise AssertionError(f"ptxas -v lines for {sorted(i8_ptxas)}, SASS "
                             f"for {sorted(i8)}")
    spills = {inst8(f): v for f, v in i8_ptxas.items()
              if v["spill_stores"] or v["spill_loads"]}
    if spills:
        raise AssertionError(f"conv_int8_tc_kernel instances spill: {spills}")
    int8 = {"igmma": sum(igmma[f] for f in i8), "instances": len(i8),
            "per_instance": {inst8(f): {"igmma": igmma[f], **i8_ptxas[f]}
                             for f in sorted(i8)}}
    print(f"SASS and ptxas -v, int8 conv_int8_tc_kernel: {json.dumps(int8)}")
    # rows 2 and 3 (csrc/conv_gray.cu): warp-level bf16 MMAs (HMMA) in every
    # bf16 instance, none in the f32 ones; no spill in the instances of the
    # models' activations (relu, none: the last template argument 1 or 0),
    # nor in the two-gray-leg enter's (PMGI's lrelu takes the switch); the
    # other switch instances, n1, are reported. Names: enter/dtype/K/legs/
    # pass width/act, exit/dtype/K/act
    gray = {}
    g_ptxas = _ptxas_props(log, lambda f: "gray_e" in f)
    for f in sorted(f for f in counts if "gray_enter_kernel" in f
                    or "gray_exit_kernel" in f):
        bf16 = "bfloat16" in f
        kind = "enter" if "gray_enter" in f else "exit"
        name = "{}/{}/{}".format(kind, "bf16" if bf16 else "f32", "/".join(
            re.findall(r"Li(n?\d+)E", f)))
        gray[name] = {"hmma": hmma[f], **g_ptxas.get(f, {})}
        two_legs = kind == "enter" and name.split("/")[3] == "2"
        spill = f not in g_ptxas or (
            (two_legs or not name.endswith("/n1")) and (
                g_ptxas[f]["spill_stores"] or g_ptxas[f]["spill_loads"]))
        if (bf16 and hmma[f] == 0) or (not bf16 and hmma[f]) or spill:
            raise AssertionError(f"{name}: {gray[name]}: want HMMA in the "
                                 f"bf16 instances only, no spills")
    # per dtype: the enter's k1, k3, k5 and k7 on one gray leg and k5 on
    # two, each at two pass widths, and the exit's k1, k3 and k5, each with
    # three activations; the enter's k1 8-channel pass (MyFusion's conv_in)
    # with four: none, relu, relu6 (compiled in, so spill-checked) and the
    # switch
    if len(gray) != 2 * ((4 + 1) * 2 * 3 + 4 + 3 * 3):
        raise AssertionError(f"conv_gray.cu instances: {sorted(gray)}")
    print(f"SASS and ptxas -v, conv_gray.cu: {json.dumps(gray)}")
    gray_sum = {"hmma": sum(v["hmma"] for v in gray.values()),
                "instances": len(gray)}
    # row 10 (csrc/conv_pair.cu): the bf16 enter and exit run their wide
    # conv (enc1, dec1) on wgmma (HGMMA) and their thin one (enc0, dec2) on
    # mma.sync (HMMA), the f32 kernels neither; no spill in the bf16
    # instances of the models' activations (not n1: apply_act's switch), no
    # wgmma that ptxas serialized
    pair = {}
    p_ptxas = _ptxas_props(log, lambda f: "pair_e" in f
                           or "conv_pair_kernel" in f)
    for f in sorted(f for f in counts if "pair_enter_kernel" in f
                    or "pair_exit_kernel" in f or "conv_pair_kernel" in f):
        bf16 = "conv_pair_kernel" not in f
        args = "/".join(re.findall(r"Li(n?\d+)E", f))
        name = ("{}/bf16/{}".format("enter" if "pair_enter" in f else "exit",
                                    args) if bf16 else f"f32/{args}")
        pair[name] = {"hgmma": counts[f], "hmma": hmma[f],
                      **p_ptxas.get(f, {})}
        spill = f not in p_ptxas or (bf16 and "n1" not in name and (
            p_ptxas[f]["spill_stores"] or p_ptxas[f]["spill_loads"]))
        if (bf16 and (counts[f] == 0 or hmma[f] == 0)) or (
                not bf16 and (counts[f] or hmma[f])) or spill:
            raise AssertionError(f"conv_pair {name}: {pair[name]}: want "
                                 f"HGMMA and HMMA in the bf16 kernels only, "
                                 f"no spills")
    if len(pair) != 6:
        raise AssertionError(f"conv_pair.cu instances: {sorted(pair)}")
    serialized = [line.strip() for line in log.splitlines()
                  if "serialized" in line and "pair_e" in line]
    if serialized:
        raise AssertionError("ptxas serialized the pair kernels' wgmmas: "
                             + "; ".join(serialized))
    print(f"SASS and ptxas -v, conv_pair.cu: {json.dumps(pair)}")
    pair_sum = {name: {"hgmma": v["hgmma"], "hmma": v["hmma"]}
                for name, v in pair.items() if "bf16" in name}
    # rows 8 and 15 (csrc/conv_valid.cuh): mma.sync (HMMA) in every
    # conv_valid_tc_kernel and conv_valid_dw_kernel instance, the thin
    # launches' instances too. f32 instances hold TF32 HMMAs only, a
    # multiple of 3 (the 3xTF32 split: lo*hi, hi*lo, hi*hi) and at least 3
    # a tap and n tile of the unrolled stage body (conv) or k-step (dw);
    # bf16 instances BF16 ones only; no spill anywhere
    valid = {}
    v_ptxas = _ptxas_props(log, lambda f: "conv_valid_tc_kernel" in f
                           or "conv_valid_dw_kernel" in f)
    for f in sorted(f for f in counts if "conv_valid_tc_kernel" in f
                    or "conv_valid_dw_kernel" in f):
        op, k, bn = re.search(r"(VaF32|VaBf16)ELi(\d+)ELi(\d+)E",
                              f).groups()
        k, bn, f32 = int(k), int(bn), op == "VaF32"
        dw = "dw_kernel" in f
        name = "{}/{}/k{}/bn{}".format("dw" if dw else "conv",
                                       "f32" if f32 else "bf16", k, bn)
        want_min = (3 if f32 else 1) * (bn // 8) * (1 if dw else k)
        valid[name] = {"hmma": hmma[f], "ops": sorted(hmma_ops[f]),
                       **v_ptxas.get(f, {})}
        kind_ok = all(("TF32" if f32 else "BF16") in o for o in hmma_ops[f])
        spill = f not in v_ptxas or v_ptxas[f]["spill_stores"] \
            or v_ptxas[f]["spill_loads"]
        if (hmma[f] < want_min or not kind_ok or spill
                or (f32 and hmma[f] % 3)):
            raise AssertionError(f"conv_valid {name}: {valid[name]}: want "
                                 f">= {want_min} "
                                 f"{'TF32' if f32 else 'BF16'} HMMA"
                                 f"{' (a multiple of 3)' if f32 else ''} "
                                 f"and no spills")
    if len(valid) != 2 * 2 * 3 * 3:
        raise AssertionError(f"conv_valid.cuh instances: {sorted(valid)}")
    print(f"SASS and ptxas -v, conv_valid.cuh: {json.dumps(valid)}")
    valid_sum = {"hmma": sum(v["hmma"] for v in valid.values()),
                 "instances": len(valid),
                 "min_hmma": min(v["hmma"] for v in valid.values())}
    return {"hgmma": sum(tc.values()), "instances": len(tc)}, nl, int8, \
        gray_sum, pair_sum, valid_sum


def dw_ptxas_report(build):
    """Phase 2 for conv_dw (csrc/conv_dw.cu): ptxas's registers and spills
    of every instance (k1 and the k3 tile kernel's slices and add, in bf16
    and f32), failing on a spill or a missing instance."""
    props = _ptxas_props(build.build_log(), lambda f: "conv_dw_" in f)
    dw = {}
    for f, v in props.items():
        m = re.search(r"conv_dw_(k1|tile)_kernelI(13__nv_bfloat16|f)"
                      r"(?:Li(\d+)ELi(\d+)ELb(\d))?", f)
        kind, dt = m.group(1), "bf16" if "bfloat" in m.group(2) else "f32"
        name = (f"k1/{dt}" if kind == "k1" else
                f"k{m.group(3)}/{dt}/ng{m.group(4)}"
                f"{'/add' if m.group(5) == '1' else ''}")
        dw[name] = v
        if v["spill_stores"] or v["spill_loads"]:
            raise AssertionError(f"conv_dw {name} spills: {v}")
    # per dtype: k1; k3 at NG 6, 2, 1 with and without the add; k5 and k7
    # at NG 2, 1 without it (taps in shared memory)
    if len(dw) != 2 * (1 + 3 * 2 + 2 * 2):
        raise AssertionError(f"conv_dw instances: {sorted(dw)}")
    print(f"ptxas -v, conv_dw.cu: {json.dumps(dw)}")
    return {"instances": len(dw), "spills": 0,
            "max_registers": max(v["registers"] for v in dw.values())}


def _rand(torch, shape, seed, dev, dtype, lo=0.0, scale=1.0):
    """Seeded uniform [lo, lo + 1) * scale, drawn on the device: the
    1224x1024 inputs of the wide layers are gigabytes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand(shape, generator=g, device=dev) + lo) * scale
    return x.to(dtype)


class Timer:
    """Mean device time of a callable over cold-L2 repetitions."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=dev)   # 256 MB > the 50 MB L2

    def __call__(self, fn, reps=REPS):
        torch = self.torch
        fn()                                     # warmup
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def _library_parts(F, xnchw, k, cout):
    """Batch slices of an NCHW input and their reflect-padded copies, for
    the library conv: one F.conv2d call, or one per chunk where the padded
    input or the output would pass 2^31 elements (torch's reflect pad
    indexes with 32 bits)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        batch_step
    b, c, h, w = xnchw.shape
    step = batch_step(h, w, max(c, cout), k)
    p = k // 2
    parts = [slice(i, i + step) for i in range(0, b, step)]
    return parts, [F.pad(xnchw[sl], (p, p, p, p), mode="reflect")
                   for sl in parts]


def _err(torch, got, want, dt):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    if err > TOL[dt] * scale:
        raise AssertionError(f"max abs err {err} above {TOL[dt]} x {scale}")
    return err, err / scale


# conv_chain and conv_multi (the wgmma body in bf16), and the enter / exit
# checked beside them: f32 within 1e-4 of max(|y|, 1) (TOL); bf16 within
# 1e-3 of max|y| beyond one bf16 ulp of each output, conv_wide's standard
# (the same exact products of bf16 weights and inputs, an f32 sum in another
# order, one rounding to bf16). At the bench's shapes every conv_chain and
# conv_multi check in bf16 has controls that must miss by 10x: the taps
# transposed (kh <-> kw), two legs of one width swapped, the halo
# zero-padded instead of reflected, and one fuse_n half's images in reverse
# order.
CHAIN_TOL = {"f32": 1e-4, "bf16": 1e-3}


def _chain_err(torch, got, want, dt):
    if dt == "f32":
        return _err(torch, got, want, dt)
    err, rel = _wide_rel(torch, got, want, dt)
    if rel > CHAIN_TOL[dt]:
        raise AssertionError(f"max err {err} is {rel:.3g} of max|y|, above "
                             f"{CHAIN_TOL[dt]} beyond one bf16 ulp")
    return err, rel


def _zero_halo_plain(torch, F, x, wt, bias, act, n=2):
    """The plain conv of x's first n images with a zero halo in place of
    the reflect: a control the checks must catch."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act
    y = F.conv2d(x[:n].float().permute(0, 3, 1, 2), wt.to(x.dtype).float(),
                 None if bias is None else bias.float(),
                 padding=wt.shape[-1] // 2)
    return apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype)


def _check_controls(torch, r, key, want, ctls):
    """Each control (bf16) must miss the plain output by 10x CHAIN_TOL."""
    for what, y in ctls.items():
        c = _wide_rel(torch, y, want[:y.shape[0]], "bf16")[1]
        if c <= 10 * CHAIN_TOL["bf16"]:
            raise AssertionError(f"{key}: the control ({what}) misses by "
                                 f"{c:.3g} only")
        r["min_control_rel_err"] = min(r["min_control_rel_err"], c)
        print(f"{key} bf16: control ({what}) {c:.3g} (tolerance "
              f"{CHAIN_TOL['bf16']})")


# (h, w, pairs) where the enter's and exit's last tile is ragged
# (conv_gray.cu: 128-pixel tile rows): a narrow image and a 1000-pixel one
GRAY_RAGGED = [(8, 200, 2), (1224, 1000, 1)]

# UNFusion's conv_chain launches (models/zoo.py:438-461, ops/blocks.py:
# 181-197 of the port): CB2_0-CB4_0 and the six ECBs' k3 convs, over the
# siamese fold's 2 images a pair, at their scale of 1224x1024 (_S):
# (name, c_in, c_out, scale)
UNFUSION_CHAIN = [("unfusion.CB2_0", 16, 32, 1), ("unfusion.CB3_0", 32, 48, 2),
                  ("unfusion.CB4_0", 48, 64, 3),
                  ("unfusion.EB2_1.conv2", 24, 64, 1),
                  ("unfusion.EB3_1.conv2", 40, 96, 2),
                  ("unfusion.EB4_1.conv2", 56, 128, 3),
                  ("unfusion.EB3_2.conv2", 104, 256, 2),
                  ("unfusion.EB4_2.conv2", 144, 304, 3),
                  ("unfusion.EB4_3.conv2", 376, 1024, 3)]
# NestFuse's 12 conv_chain launches (port ops/blocks.py nest_block: every
# ConvBlock conv whose output width is a multiple of 16, on one tensor) and
# RFN1's four (RFNNest, 64 channels at scale 0): (name, c_in, c_out, k,
# scale, images a pair). CB1_0.conv2 (8 channels in) and CB3_0.conv2 (56)
# take the body's ragged k-step.
NEST_CHAIN = [("nestfuse.CB1_0.conv2", 8, 64, 1, 0, 2),
              ("nestfuse.CB2_0.conv1", 64, 32, 3, 1, 2),
              ("nestfuse.CB2_0.conv2", 32, 112, 1, 1, 2),
              ("nestfuse.CB3_0.conv2", 56, 160, 1, 2, 2),
              ("nestfuse.CB4_0.conv1", 160, 80, 3, 3, 2),
              ("nestfuse.CB4_0.conv2", 80, 208, 1, 3, 2),
              ("nestfuse.DB1_1.conv2", 88, 64, 1, 0, 1),
              ("nestfuse.DB2_1.conv2", 136, 112, 1, 1, 1),
              ("nestfuse.DB3_1.conv2", 184, 160, 1, 2, 1),
              ("nestfuse.DB1_2.conv2", 120, 64, 1, 0, 1),
              ("nestfuse.DB2_2.conv2", 192, 112, 1, 1, 1),
              ("nestfuse.DB1_3.conv2", 152, 64, 1, 0, 1),
              ("rfnnest.RFN1.conv1", 64, 64, 3, 0, 1),
              ("rfnnest.RFN1.fuse2", 64, 64, 3, 0, 1)]


def _gray_enter_raw(torch, a, b, wt, bias, act):
    """A zero-argument raw launch of conv_gray_enter's C entry on the pair
    (a, b) (weights packed, output allocated here once): the kernel without
    the wrapper's host work. A (Cout, 2, K, K) weight takes the two-leg
    entry (a and b the two input channels)."""
    import ctypes
    from multi_modal_image_fusion_tpu_torch.ops.cuda.build import \
        kernel_function
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        ACT_CODES, DTYPE_CODES, gray_weights)
    I, P = ctypes.c_int, ctypes.c_void_p
    legs = wt.shape[1]
    fn = kernel_function("mmif_conv_gray_enter" if legs == 1
                         else "mmif_conv_gray_enter_legs",
                         [I, P, P, P, P, P, I, I, I, I, I, I, P])
    n, h, w, _ = a.shape
    cout, k = wt.shape[0], wt.shape[-1]
    wk, bk = gray_weights("enter", wt, bias, a.dtype)
    y = torch.empty((n * (3 - legs), h, w, cout), dtype=a.dtype,
                    device=a.device)
    args = (DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), wk.data_ptr(),
            None if bk is None else bk.data_ptr(), y.data_ptr(), n, h, w,
            cout, k, ACT_CODES[act])

    def launch(wk=wk, bk=bk, y=y):   # keeps them alive
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"conv_gray_enter: raw launch failed with "
                               f"error {err}")
        return y
    return launch


def check_kernels(torch, F, dev, timer):
    """Phase 3. Returns {kernel name: record} for the kernels line."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        apply_act, conv_chain, conv_chain_plain, conv_gray_enter,
        conv_gray_enter_plain, conv_gray_exit, conv_gray_exit_plain)

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    # DeepFuse's layers, the k3 instances of DenseFuse and VIFNet (their
    # dense convs and concat-fed dec0 are conv_multi's, below), UNFusion's
    # encoder convs: (name, kernel, c_in, c_out, k, act, fuse, scale,
    # images a pair)
    layers = [("enc0", "conv_gray_enter", 1, 16, 5, "relu", False, 0, 1),
              ("enc1", "conv_chain", 16, 32, 7, "relu", False, 0, 2),
              ("dec0", "conv_chain", 32, 32, 7, "relu", True, 0, 1),
              ("dec1", "conv_chain", 32, 16, 5, "relu", False, 0, 1),
              ("dec2", "conv_gray_exit", 16, 1, 5, None, False, 0, 1),
              ("densefuse.conv_in", "conv_gray_enter", 1, 16, 3, "relu",
               False, 0, 1),
              ("densefuse_l1.dec0", "conv_chain", 64, 64, 3, "relu", False,
               0, 1),
              ("densefuse.dec1", "conv_chain", 64, 32, 3, "relu", False, 0,
               1),
              ("densefuse.dec2", "conv_chain", 32, 16, 3, "relu", False, 0,
               1),
              ("densefuse.dec3", "conv_gray_exit", 16, 1, 3, None, False, 0,
               1),
              ("dbnet.encode", "conv_gray_enter", 1, 32, 3, "relu", False, 0,
               1),
              ("unfusion.conv_out", "conv_gray_exit", 16, 1, 1, "relu", False,
               0, 1),
              ("nestfuse.conv_in", "conv_gray_enter", 1, 16, 1, "relu", False,
               0, 1),
              ("nestfuse.conv_out", "conv_gray_exit", 64, 1, 1, "relu",
               False, 0, 1),
              ("vifnet.dec1", "conv_chain", 128, 64, 3, "relu", False, 0, 1),
              ("vifnet.dec2", "conv_chain", 64, 32, 3, "relu", False, 0, 1),
              ("vifnet.dec3", "conv_chain", 32, 16, 3, "relu", False, 0, 1),
              # IFCNN's k7 enc0 (64 out, no activation), the new
              # conv_chain shapes of IFCNN, DIFNet, PMGI and PFNetv2's
              # block-diagonal fuse net (fuse1 128 -> 128, fuse2 -> 64)
              ("ifcnn.enc0", "conv_gray_enter", 1, 64, 7, None, False, 0,
               1),
              ("ifcnn.enc1", "conv_chain", 64, 64, 3, "relu", False, 0, 2),
              ("difnet.enc1.conv1", "conv_chain", 16, 16, 3, "relu", False,
               0, 2),
              ("pmgi.gradient1", "conv_chain", 16, 16, 3, "lrelu", False, 0,
               1),
              ("pfnetv2.fuse1", "conv_chain", 128, 128, 3, "relu", False, 0,
               1),
              ("pfnetv2.fuse2", "conv_chain", 128, 64, 3, None, False, 0, 1),
              # MyFusion: conv_in (1 -> 8, the enter's 8-channel pass),
              # conv_out (16 -> 1), level 1's pw, SepConvBlock pwconv1 and
              # DB1_1's pw2 (24 -> 16), all k1 relu6
              ("myfusion.conv_in", "conv_gray_enter", 1, 8, 1, "relu6",
               False, 0, 1),
              # the same pass without an activation: conv_in with act
              # hswish, silu or gelu (a torch op after the kernel) or with
              # norm 'layer'
              ("myfusion.conv_in.none", "conv_gray_enter", 1, 8, 1, None,
               False, 0, 1),
              ("myfusion.conv_out", "conv_gray_exit", 16, 1, 1, "relu6",
               False, 0, 1),
              ("myfusion.down1_1.pw", "conv_chain", 8, 16, 1, "relu6", False,
               0, 2),
              ("myfusion.EB1_1.pwconv1", "conv_chain", 16, 64, 1, "relu6",
               False, 0, 2),
              ("myfusion.DB1_1.pw2", "conv_chain", 24, 16, 1, "relu6", False,
               0, 1)]
    layers += [(name, "conv_chain", cin, cout, 3, "relu", False, s, 2)
               for name, cin, cout, s in UNFUSION_CHAIN]
    layers += [(name, "conv_chain", cin, cout, k, "relu", False, s, per_pair)
               for name, cin, cout, k, s, per_pair in NEST_CHAIN]
    rec = {}
    for name, kern, cin, cout, k, act, fuse, scale, per_pair in layers:
        wt = _rand(torch, (cout, cin, k, k), 10 + k + cin, dev, torch.float32,
                   lo=-0.5, scale=2.0 / np.sqrt(cin * k * k))
        bias = _rand(torch, (cout,), 20 + cout, dev, torch.float32, lo=-0.5,
                     scale=0.1)
        # (dtype, pairs, h, w): bench shape, test-CLI shape, odd small shape;
        # the enter and exit also where their last tile is ragged
        hs, ws = _S[scale]
        shapes = [("bf16", BATCH, hs, ws), ("f32", 1, hs, ws),
                  ("bf16", 2, 45, 61), ("f32", 2, 45, 61)]
        if kern != "conv_chain":
            shapes += [(dt, n, h, w) for h, w, n in GRAY_RAGGED
                       for dt in ("bf16", "f32")]
        for dt, n, h, w in shapes:
            dtype = dts[dt]
            wk = wt.to(dtype)
            b_out = n * per_pair
            fuse_n = n if fuse else 0
            if kern == "conv_gray_enter":
                a = _rand(torch, (n, h, w, 1), 1, dev, dtype)
                b = _rand(torch, (n, h, w, 1), 2, dev, dtype)
                xin = torch.cat([a, b], 0)

                def run(wk=wk):
                    return conv_gray_enter(a, b, wk, bias, act)

                def plain():
                    return conv_gray_enter_plain(a, b, wk, bias, act)
                b_in, b_out = 2 * n, 2 * n
            else:
                b_in = 2 * n if fuse else b_out
                xin = _rand(torch, (b_in, h, w, cin), 3, dev, dtype)
                if kern == "conv_chain":
                    def run(wk=wk, xin=xin):
                        return conv_chain(xin, wk, bias, act, fuse_n)

                    def plain():
                        return conv_chain_plain(xin, wk, bias, act, fuse_n)
                else:
                    def run(wk=wk):
                        return conv_gray_exit(xin, wk, bias, act)

                    def plain():
                        return conv_gray_exit_plain(xin, wk, bias, act)
            want = plain()
            err, rel = _chain_err(torch, run(), want, dt)
            r = rec.setdefault(kern, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                      "tolerance_rel": CHAIN_TOL,
                                      "layers": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            if not (dt == "bf16" and h == hs and n == BATCH):
                continue
            xn = xin[:n] + xin[n:] if fuse else xin
            if kern == "conv_chain":
                r.setdefault("min_control_rel_err", float("inf"))
                if k > 1:
                    ctls = {"zero halo": _zero_halo_plain(torch, F, xn, wk,
                                                          bias, act),
                            "taps transposed": run(wk.transpose(2, 3))}
                else:
                    # a k1 conv has one tap and no halo
                    ctls = {"input channels reversed": run(wk.flip(1))}
                if fuse:
                    ctls["one half reversed"] = run(xin=torch.cat(
                        [xin[:n], xin[n:].flip(0)]))
                _check_controls(torch, r, f"conv_chain {name}", want, ctls)
                del ctls
            else:
                # the enter and exit: the taps transposed, the halo
                # zero-padded, the enter's two images swapped; a k1 exit
                # (no halo, no taps) its input channels reversed
                r.setdefault("min_control_rel_err", float("inf"))
                ctls = {}
                if k > 1:
                    ctls["zero halo"] = _zero_halo_plain(torch, F, xn, wk,
                                                         bias, act)
                    ctls["taps transposed"] = run(wk.transpose(2, 3))
                elif kern == "conv_gray_exit":
                    ctls["channels reversed"] = run(wk.flip(1))
                else:
                    # a k1 enter has one tap and no halo
                    ctls["bias dropped"] = conv_gray_enter(a, b, wk, None,
                                                           act)
                    ctls["channels reversed"] = run(wk.flip(0))
                if kern == "conv_gray_enter":
                    ctls["images swapped"] = conv_gray_enter(b, a, wk, bias,
                                                             act)
                _check_controls(torch, r, f"{kern} {name}", want, ctls)
                del ctls
            del want
            # timings at the bench's shape
            p = k // 2
            xnchw = xn.permute(0, 3, 1, 2)
            parts, xp = _library_parts(F, xnchw, k, cout)
            wb, bb = wk, bias.to(dtype)
            esz = 2
            flops = 2.0 * b_out * h * w * cin * k * k * cout
            nbytes = (b_in * h * w * cin + b_out * h * w * cout
                      + wt.numel()) * esz
            bound = max(nbytes / PEAK_BYTES_S,
                        flops / PEAK_FLOPS[dt]) * 1e3
            r["layers"][name] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: [F.conv2d(t, wb, bb)
                                             for t in xp]),
                "library_pad_ms": timer(lambda: [
                    F.pad(xnchw[sl], (p, p, p, p), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                "bound_ms": bound,
                "bound_by": ("bytes" if nbytes / PEAK_BYTES_S
                             > flops / PEAK_FLOPS[dt] else "operations"),
                "shape": f"{b_in}x{h}x{w}x{cin}->{b_out}x{h}x{w}x{cout} "
                         f"k{k} {dt}"}
            if kern == "conv_chain":
                r["layers"][name].update(
                    _tc_block(cout, [cin], k, dt, fuse_n))
            if kern == "conv_gray_enter":
                raw = _gray_enter_raw(torch, a, b, wk, bias, act)
                _chain_err(torch, raw(), plain(), dt)
                r["layers"][name].update({
                    "raw_ms": timer(raw),
                    "host_us": _host_us(torch, run),
                    "library_act_ms": timer(lambda: [
                        apply_act(F.conv2d(t, wb, bb), act) for t in xp])})
                del raw
            del xp, xnchw, xn
        del xin
        torch.cuda.empty_cache()
        stamp(f"{kern} {name} checked")

    return rec


def check_gray_legs(torch, F, dev, timer, rec):
    """Rows 2 and 3's PMGI instances against their plain versions:
    the two-gray-leg enter (gradient0: img1 and img2 the two channels of
    one input, 2 -> 16, k5, lrelu) and the exit over legs (decode: eight
    16-channel legs -> 1, k1, tanh; leg 3 read at batch offset 1 of a
    tensor with one more image), at 1224x1024 in bf16 (the bench's 16
    pairs) and f32 (the test CLI's pair) and at 45x61, CHAIN_TOL. At both
    full shapes controls that must miss by 10x: the enter's second leg's
    weight dropped, the legs' weights swapped, the taps transposed, a zero
    halo; the exit's tanh left out, two legs swapped, leg 3's offset wrong.
    Timed at the bench's shape beside the plain version and one F.conv2d
    on the padded channel concat (the concat and the pad timed apart; the
    enter also as its raw launch). The records join rec's conv_gray_enter
    and conv_gray_exit layers."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        apply_act, conv_gray_enter, conv_gray_enter_plain, conv_gray_exit,
        conv_gray_exit_plain, gray_legs_input)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    for kern, key in (("conv_gray_enter", "pmgi.gradient0"),
                      ("conv_gray_exit", "pmgi.decode")):
        r = rec[kern]
        for dt, n, h, w in (("bf16", BATCH, H, W), ("f32", 1, H, W),
                            ("bf16", 2, 45, 61), ("f32", 2, 45, 61)):
            dtype = dts[dt]
            if kern == "conv_gray_enter":
                cin, cout, k, act = 2, 16, 5, "lrelu"
                a = _rand(torch, (n, h, w, 1), 1, dev, dtype)
                b = _rand(torch, (n, h, w, 1), 2, dev, dtype)
                wk = _rand(torch, (cout, cin, k, k), 130, dev, torch.float32,
                           lo=-0.5, scale=2.0 / np.sqrt(cin * k * k)
                           ).to(dtype)
                bias = _rand(torch, (cout,), 131, dev, torch.float32,
                             lo=-0.5, scale=0.1)

                def run(wk=wk):
                    return conv_gray_enter(a, b, wk, bias, act)

                def plain():
                    return conv_gray_enter_plain(a, b, wk, bias, act)

                def cat():
                    return torch.cat([a, b], -1)

                def ctls():
                    return {"second leg dropped": run(torch.cat(
                                [wk[:, :1], 0 * wk[:, 1:]], 1)),
                            "legs' weights swapped": run(wk.flip(1)),
                            "taps transposed": run(wk.transpose(2, 3)),
                            "zero halo": _zero_halo_plain(
                                torch, F, cat(), wk, bias, act)}
                in_elems = 2 * n * h * w
            else:
                cin, cout, k, act = 128, 1, 1, "tanh"
                ts = [_rand(torch, (n + (i == 3), h, w, 16), 140 + i, dev,
                            dtype, lo=-0.5) for i in range(8)]
                legs = [(t, int(i == 3)) for i, t in enumerate(ts)]
                wk = _rand(torch, (cout, cin, k, k), 150, dev, torch.float32,
                           lo=-0.5, scale=4.0 / np.sqrt(cin)).to(dtype)
                bias = _rand(torch, (cout,), 151, dev, torch.float32,
                             lo=-0.5, scale=0.1)

                def run(legs=legs, act=act):
                    return conv_gray_exit(legs, wk, bias, act)

                def plain():
                    return conv_gray_exit_plain(legs, wk, bias, act)

                def cat():
                    return gray_legs_input(legs)

                def ctls():
                    return {"tanh left out": run(act=None),
                            "two legs swapped": run(
                                [legs[1], legs[0], *legs[2:]]),
                            "leg 3's offset wrong": run(
                                [(t, 0) for t in ts])}
                in_elems = n * h * w * cin
            want = plain()
            err, rel = _chain_err(torch, run(), want, dt)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            if h != H:
                continue
            r.setdefault("min_control_rel_err", float("inf"))
            _check_controls(torch, r, f"{kern} {key} {dt}", want, ctls())
            del want
            if dt != "bf16":
                continue
            xn = cat().permute(0, 3, 1, 2)
            p = k // 2
            parts, xp = _library_parts(F, xn, k, cout)
            bb = bias.to(dtype)
            bound, by = _bound((in_elems + n * h * w * cout) * 2
                               + wk.numel() * 2,
                               2.0 * n * h * w * cin * k * k * cout, dt)
            lay = r["layers"][key] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: [F.conv2d(t, wk, bb)
                                             for t in xp]),
                "library_act_ms": timer(lambda: [
                    apply_act(F.conv2d(t, wk, bb), act) for t in xp]),
                "library_concat_ms": timer(cat),
                "library_pad_ms": timer(lambda: [
                    F.pad(xn[sl], (p, p, p, p), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                "host_us": _host_us(torch, run),
                "bound_ms": bound, "bound_by": by,
                "shape": (f"2 gray legs {n}x{h}x{w} -> {n}x{h}x{w}x{cout} "
                          f"k{k} {dt}" if kern == "conv_gray_enter" else
                          f"8 legs of 16 -> {n}x{h}x{w}x1 k{k} {dt}")}
            if kern == "conv_gray_enter":
                raw = _gray_enter_raw(torch, a, b, wk, bias, act)
                _chain_err(torch, raw(), plain(), dt)
                lay["raw_ms"] = timer(raw)
                del raw
            del xn, xp
        torch.cuda.empty_cache()
        stamp(f"{kern} {key} checked")


# SEDRFuse's serving kernel launches (port models/zoo.py SEDRFuse), k3:
# (key, kernel, c_in, c_out, act, scale of 1224x1024, images a pair). enc0
# and the ResBlock's convs run without activation (a group norm follows);
# the ResBlock's two convs are one shape, checked once
SEDR_LAYERS = [("sedrfuse.enc0", "conv_gray_enter", 1, 64, None, 0, 2),
               ("sedrfuse.res.conv1", "conv_chain", 256, 256, None, 2, 2),
               ("sedrfuse.dec2", "conv_gray_exit", 64, 1, "relu", 0, 1)]
# its forward's library parts at the bench's 16 pairs: (key, kind, c_in,
# c_out, scale, images a pair)
SEDR_LIBRARY = [("enc1", "stride2", 64, 128, 0, 2),
                ("enc2", "stride2", 128, 256, 1, 2),
                ("dec0", "transpose", 256, 128, 2, 1),
                ("dec1", "transpose", 128, 64, 1, 1)]


def check_sedrfuse(torch, F, dev, timer, rec):
    """SEDRFuse's three serving launches against their plain versions at
    its bench's shape (bf16, 16 pairs of 1224x1024) and its test CLI's
    (f32, one pair), CHAIN_TOL, each with controls that must miss by 10x in
    both dtypes (the taps transposed, a zero halo; the enter's images
    swapped; the exit's relu left out), timed in bf16 beside the plain
    version and one F.conv2d on the reflect-padded input (the pad timed
    apart). The records join rec's conv_gray_enter, conv_chain and
    conv_gray_exit layers. Then the forward's library parts at the bench's
    shapes, each timed beside its bound: enc1 and enc2 on F.conv2d (stride
    2, on the reflect-padded input; F.pad on the NCHW view timed apart, and
    the port's route: `reflect_pad_nhwc`, F.conv2d on the channels-last
    view), dec0 and dec1 on F.conv_transpose2d,
    and the group norm + relu of enc0's output (32 images of 64 channels):
    the port's `group_norm` (checked against F.group_norm in f32 on two
    images) and, as its library call, F.group_norm on the NCHW view plus
    the relu, both in batch chunks of GN_CHUNK_ELEMS elements. Returns the
    library parts' record."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        conv_chain, conv_chain_plain, conv_gray_enter, conv_gray_enter_plain,
        conv_gray_exit, conv_gray_exit_plain)
    from multi_modal_image_fusion_tpu_torch.ops.layers import (
        GN_CHUNK_ELEMS, group_norm, reflect_pad_nhwc)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    for key, kern, cin, cout, act, scale, per_pair in SEDR_LAYERS:
        hs, ws = _S[scale]
        r = rec[kern]
        wt = _rand(torch, (cout, cin, 3, 3), 160 + cin, dev, torch.float32,
                   lo=-0.5, scale=2.0 / np.sqrt(cin * 9))
        bias = _rand(torch, (cout,), 161 + cout, dev, torch.float32,
                     lo=-0.5, scale=0.1)
        for dt, n in (("bf16", BATCH), ("f32", 1)):
            dtype = dts[dt]
            wk = wt.to(dtype)
            if kern == "conv_gray_enter":
                a = _rand(torch, (n, hs, ws, 1), 1, dev, dtype)
                b = _rand(torch, (n, hs, ws, 1), 2, dev, dtype)
                xin = torch.cat([a, b])

                def run(wk=wk, a=a, b=b):
                    return conv_gray_enter(a, b, wk, bias, act)

                def plain():
                    return conv_gray_enter_plain(a, b, wk, bias, act)

                def ctls():
                    return {"images swapped": run(a=b, b=a)}
            else:
                xin = _rand(torch, (n * per_pair, hs, ws, cin), 3, dev, dtype,
                            lo=-0.5 if kern == "conv_gray_exit" else 0.0)
                if kern == "conv_chain":
                    def run(wk=wk):
                        return conv_chain(xin, wk, bias, act)

                    def plain():
                        return conv_chain_plain(xin, wk, bias, act)

                    def ctls():
                        return {}
                else:
                    def run(wk=wk, act=act):
                        return conv_gray_exit(xin, wk, bias, act)

                    def plain():
                        return conv_gray_exit_plain(xin, wk, bias, act)

                    def ctls():
                        return {"relu left out": run(act=None)}
            want = plain()
            err, rel = _chain_err(torch, run(), want, dt)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            r.setdefault("min_control_rel_err", float("inf"))
            _check_controls(torch, r, f"{kern} {key} {dt}", want, {
                "taps transposed": run(wk.transpose(2, 3)),
                "zero halo": _zero_halo_plain(torch, F, xin, wk, bias, act),
                **ctls()})
            del want
            if dt != "bf16":
                continue
            b_in, b_out = xin.shape[0], n * per_pair
            xn = xin.permute(0, 3, 1, 2)
            parts, xp = _library_parts(F, xn, 3, cout)
            bb = bias.to(dtype)
            bound, by = _bound(
                (b_in * hs * ws * cin + b_out * hs * ws * cout) * 2
                + wk.numel() * 2, 2.0 * b_out * hs * ws * cin * 9 * cout, dt)
            lay = r["layers"][key] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: [F.conv2d(t, wk, bb)
                                             for t in xp]),
                "library_pad_ms": timer(lambda: [
                    F.pad(xn[sl], (1, 1, 1, 1), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                "host_us": _host_us(torch, run),
                "bound_ms": bound, "bound_by": by,
                "shape": f"{b_in}x{hs}x{ws}x{cin}->{b_out}x{hs}x{ws}x{cout} "
                         f"k3 {dt}"}
            if kern == "conv_chain":
                lay.update(_tc_block(cout, [cin], 3, dt))
            del xn, xp
        del xin
        torch.cuda.empty_cache()
        stamp(f"{kern} {key} checked")

    lib = {}
    bf = torch.bfloat16
    for key, kind, cin, cout, scale, per_pair in SEDR_LIBRARY:
        h, w = _S[scale]
        b = BATCH * per_pair
        x = _rand(torch, (b, h, w, cin), 170, dev, bf, lo=-0.5)
        wshape = (cin, cout, 3, 3) if kind == "transpose" else (cout, cin,
                                                                 3, 3)
        wt = _rand(torch, wshape, 171, dev, bf, lo=-0.5,
                   scale=2.0 / np.sqrt(cin * 9))
        bias = _rand(torch, (cout,), 172, dev, bf, lo=-0.5, scale=0.1)
        xn = x.permute(0, 3, 1, 2)
        rec_ = {}
        if kind == "transpose":
            ho, wo = 2 * h, 2 * w

            def fn():
                return F.conv_transpose2d(xn, wt, bias, stride=2, padding=1,
                                          output_padding=1)
        else:
            ho, wo = (h + 1) // 2, (w + 1) // 2
            parts, xp = _library_parts(F, xn, 3, cout)

            def fn():
                return [F.conv2d(t, wt, bias, stride=2) for t in xp]
            rec_["pad_ms"] = timer(lambda: [
                F.pad(xn[sl], (1, 1, 1, 1), mode="reflect") for sl in parts])
            rec_["calls"] = len(parts)
            # the port's route (ConvLayer._strided): the pad written NHWC,
            # F.conv2d on its channels-last view
            xq = [reflect_pad_nhwc(x[sl], 1) for sl in parts]
            rec_["nhwc_pad_ms"] = timer(lambda: [
                reflect_pad_nhwc(x[sl], 1) for sl in parts])
            rec_["channels_last_ms"] = timer(lambda: [
                F.conv2d(t.permute(0, 3, 1, 2), wt, bias, stride=2)
                for t in xq])
            del xq
        bound, by = _bound((b * h * w * cin + b * ho * wo * cout
                            + wt.numel()) * 2,
                           2.0 * b * ho * wo * cout * cin * 9, "bf16")
        lib[key] = {"library_ms": timer(fn), **rec_, "bound_ms": bound,
                    "bound_by": by,
                    "shape": f"{b}x{h}x{w}x{cin}->{b}x{ho}x{wo}x{cout} k3 "
                             f"{kind} bf16"}
        del x, xn, fn
        if kind != "transpose":
            del xp
        torch.cuda.empty_cache()
    y = _rand(torch, (2 * BATCH, H, W, 64), 175, dev, bf, lo=-0.5)
    g = _rand(torch, (64,), 176, dev, torch.float32, lo=0.5)
    be = _rand(torch, (64,), 177, dev, torch.float32, lo=-0.5, scale=0.2)
    want = F.group_norm(y[:2].float().permute(0, 3, 1, 2), 64, g, be,
                        1e-5).relu().permute(0, 2, 3, 1)
    err, rel = _wide_rel(torch, group_norm(y[:2], g, be, "relu"), want,
                         "bf16")
    if rel > CHAIN_TOL["bf16"]:
        raise AssertionError(f"group_norm vs F.group_norm: {rel:.3g}")
    step = max(1, GN_CHUNK_ELEMS // y[0].numel())

    def library():
        return [torch.relu_(F.group_norm(y[i:i + step].permute(0, 3, 1, 2),
                                         64, g.to(bf), be.to(bf), 1e-5))
                for i in range(0, y.shape[0], step)]
    gn = {"ms": timer(lambda: group_norm(y, g, be, "relu")),
          "max_rel_err_vs_f32": rel,
          "bound_ms": 2 * y.numel() * 2 / PEAK_BYTES_S * 1e3,
          "bound_by": "bytes", "shape": f"{tuple(y.shape)} bf16 + relu"}
    try:
        gn["library_ms"] = timer(library)
    except RuntimeError as e:      # reported: the port does not call it
        gn["library_ms"], gn["library_error"] = None, str(e)[:200]
    lib["group_norm.enc0"] = gn
    del y, want
    torch.cuda.empty_cache()
    print(f"sedrfuse library parts: {json.dumps(lib)}")
    return lib


def check_fuse_net(torch, F, dev, timer):
    """PFNetv2's fuse net at the bench's 16 pairs of 1224x1024 in bf16, timed
    three ways: the serving route (PFNetv2.fusion: the
    block-diagonal fuse0 on conv_multi over the eight legs, fuse1 and
    fuse2 on conv_chain, the residual added a leg) and its three kernel
    launches alone; the library call, one grouped F.conv2d(groups=64) a
    layer on the channel-interleaved input (the interleave, pads and
    activations timed apart); and the bound of the grouped work (2 -> 2 ->
    2 -> 1 a channel) beside the block-diagonal convs' own bound (64x the
    operations). The route is checked against the f32 channels-into-batch
    fold on F.conv2d (TF32 off) over 2 of the pairs: within 2e-2 of its
    largest magnitude (bf16 storage between the three layers)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act, conv_chain
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import \
        conv_multi
    n, dt = BATCH, torch.bfloat16
    model = seeded_model(torch, "pfnetv2", 0).to(dev, dt).eval()
    legs = [_rand(torch, (2 * n, H, W, 16), 160 + i, dev, dt)
            for i in range(4)]
    (w0, b0), (w1, b1), (w2, b2) = model.fuse_weights()
    acts = [layer.act for layer in model.fuse]
    with torch.no_grad():
        y = model.fusion(legs, n)
        m32 = seeded_model(torch, "pfnetv2", 0).to(dev).eval()
        f32 = torch.cat([t.float() for t in legs], -1)
        ref = m32._fold(torch.cat([f32[:2], f32[n:n + 2]]), 2)
        scale = float(ref.abs().max())
        err = float((y[:2].float() - ref).abs().max())
        del m32, f32, ref
        if not err <= 2e-2 * scale:
            raise AssertionError(f"pfnetv2 fuse net: max err {err} of "
                                 f"{scale} against the f32 fold")
        z0 = conv_multi([(t, 0) for t in legs] + [(t, n) for t in legs],
                        w0, b0, acts[0])
        z1 = conv_chain(z0, w1, b1, acts[1])

        def convs():
            conv_multi([(t, 0) for t in legs] + [(t, n) for t in legs], w0,
                       b0, acts[0])
            conv_chain(z0, w1, b1, acts[1])
            conv_chain(z1, w2, b2, acts[2])
        # the library: grouped convs on the (c, {f1, f2}) interleaved input,
        # in batch chunks (torch's reflect pad indexes with 32 bits)
        gw = [layer.weight.detach().repeat(64, 1, 1, 1) for layer in
              model.fuse]
        gb = [layer.bias.detach().repeat(64) for layer in model.fuse]

        def interleave():
            f = torch.cat(legs, -1)
            return torch.stack([f[:n], f[n:]], -1).reshape(
                n, H, W, 128).permute(0, 3, 1, 2)
        zin = interleave()
        parts, xp0 = _library_parts(F, zin, 3, 128)

        def pad(t):
            return F.pad(t, (1, 1, 1, 1), mode="reflect")
        xps = [xp0]
        for i in range(2):
            xps.append([pad(apply_act(F.conv2d(t, gw[i], gb[i], groups=64),
                                      acts[i])) for t in xps[-1]])

        def grouped(sls=parts):
            outs = []
            for sl in sls:
                t = zin[sl]
                for i in range(3):
                    t = apply_act(F.conv2d(pad(t), gw[i], gb[i], groups=64),
                                  acts[i])
                outs.append(t)
            return outs
        f = torch.cat(legs, -1)
        check = grouped([slice(0, 2)])[0].float().permute(0, 2, 3, 1) + (
            f[:2].float() + f[n:n + 2].float())
        gerr = float((check - y[:2].float()).abs().max())
        del check, f
        hw = n * H * W
        io = (2 * hw * 64 + hw * 64) * 2          # f1 and f2 in, z out
        bd_ops = 2.0 * hw * 9 * (128 * 128 + 128 * 128 + 64 * 128)
        g_ops = 2.0 * hw * 9 * (64 * 2 * 2 + 64 * 2 * 2 + 64 * 1 * 2)
        bd_io = io + (2 * hw * 128 * 2) * 2       # z0 and z1 out and in
        rec = {
            "route_ms": timer(lambda: model.fusion(legs, n)),
            "block_diagonal_convs_ms": timer(convs),
            "library_ms": timer(lambda: [F.conv2d(t, gw[i], gb[i],
                                                  groups=64)
                                         for i in range(3) for t in xps[i]]),
            "library_calls": 3 * len(parts),
            "library_with_pads_and_acts_ms": timer(grouped),
            "library_interleave_ms": timer(interleave),
            "grouped_bound_ms": max(io / PEAK_BYTES_S,
                                    g_ops / PEAK_FLOPS["bf16"]) * 1e3,
            "grouped_bound_by": ("bytes" if io / PEAK_BYTES_S
                                 > g_ops / PEAK_FLOPS["bf16"]
                                 else "operations"),
            "block_diagonal_bound_ms": max(
                bd_io / PEAK_BYTES_S, bd_ops / PEAK_FLOPS["bf16"]) * 1e3,
            "block_diagonal_tflop": bd_ops / 1e12,
            "grouped_tflop": g_ops / 1e12,
            "max_rel_err_vs_f32_fold": err / scale,
            "max_abs_err_vs_grouped_bf16": gerr,
            "pairs": n}
    del legs, y, z0, z1, zin, xps, xp0, model
    torch.cuda.empty_cache()
    print(f"pfnetv2 fuse net: {json.dumps(rec)}")
    return rec


# DeepFuse's train step at the reference defaults (bs 16, 64x64 patches):
# (name, images, c_in, c_out, k) of the conv_valid launches. The siamese
# fold runs the encoder once over both images of the 16 pairs.
TRAIN_BS, PATCH = 16, 64
VALID_FWD = [("enc0", 2 * TRAIN_BS, 1, 16, 5),
             ("enc1", 2 * TRAIN_BS, 16, 32, 7),
             ("dec0", TRAIN_BS, 32, 32, 7), ("dec1", TRAIN_BS, 32, 16, 5),
             ("dec2", TRAIN_BS, 16, 1, 5)]
# dx of every layer but enc0 (the images carry no gradient): a VALID conv
# of the cotangent (c_out channels) zero-padded by k-1, back to c_in
VALID_DX = [(n, b, cin, cout, k) for n, b, cin, cout, k in VALID_FWD[1:]]
# SEDRFuse's train step (its stride-1 convs, k3): (name, images, c_in,
# c_out, h = w); the ResBlock's two convs are one shape, at 16x16
VALID_SEDR = [("enc0", 2 * TRAIN_BS, 1, 64, PATCH),
              ("res", 2 * TRAIN_BS, 256, 256, PATCH // 4),
              ("dec2", TRAIN_BS, 64, 1, PATCH)]


def _bound(nbytes, flops, dt):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dt]
    return max(t_b, t_f) * 1e3, "bytes" if t_b > t_f else "operations"


# conv_valid and conv_valid_dw: f32 within 1e-4, bf16 within 1e-3 of the
# plain output's largest magnitude (bf16 outputs beyond one bf16 ulp of
# each value); the f32 kernels' products are a 3xTF32 split, so an f32
# bound is also given at that rate: three TF32 products (495 TFLOP/s dense,
# H100 SXM data sheet) for each f32 one
VALID_TOL = {"f32": 1e-4, "bf16": 1e-3}
PEAK_3XTF32 = 495e12 / 3


def check_conv_valid(torch, F, dev, timer):
    """conv_valid (forward and dx) and conv_valid_dw against their plain
    versions at the train step's launches (f32 and bf16), a k3 layer, one
    20x50 image, the valid step's epilogues and one full-resolution
    forward, with controls that must miss by 10x (dx: the taps not flipped,
    the halo shifted by one pixel; dw: kh and kw swapped), dw's bits equal
    on two runs, and times: the kernel, its plain version and its library
    call (F.conv2d, conv2d_input, conv2d_weight on the same inputs, TF32
    off)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
        conv_valid, conv_valid_dw, conv_valid_dw_plain, conv_valid_dx,
        conv_valid_dx_plain, conv_valid_plain)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0,
         "min_control_rel_err": float("inf"), "tolerance_rel": VALID_TOL,
         "layers": {}}

    def check(key, got, want, dt, controls=(), ulp=True):
        # ulp: a bf16 output may round to the neighbouring bf16 value (dw
        # writes f32 from bf16 inputs: no rounding allowance)
        def rel(a, b):
            return _wide_rel(torch, a, b, dt if ulp else "f32")
        err, rel_ = rel(got, want)
        if rel_ > VALID_TOL[dt]:
            raise AssertionError(f"conv_valid {key}: err {err} is {rel_:.3g} "
                                 f"of max|y|, above {VALID_TOL[dt]}")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel_)
        for name, ctl in controls:
            c_rel = rel(got, ctl)[1]
            if c_rel <= 10 * VALID_TOL[dt]:
                raise AssertionError(f"conv_valid {key}: control {name} "
                                     f"passes ({c_rel:.3g})")
            r["min_control_rel_err"] = min(r["min_control_rel_err"], c_rel)

    cases = []
    for dt in ("f32", "bf16"):
        for name, b, cin, cout, k in VALID_FWD:
            cases.append((f"{name}.fwd.{dt}", "fwd", dt, b, PATCH, PATCH,
                          cin, cout, k, None, None))
            cases.append((f"{name}.dw.{dt}", "dw", dt, b, PATCH, PATCH, cin,
                          cout, k, None, None))
        for name, b, cin, cout, k in VALID_DX:
            cases.append((f"{name}.dx.{dt}", "dx", dt, b, PATCH, PATCH, cin,
                          cout, k, None, None))
        for name, b, cin, cout, hw in VALID_SEDR:
            cases += [(f"sedrfuse.{name}.{kind}.{dt}.step", kind, dt, b, hw,
                       hw, cin, cout, 3, None, None)
                      for kind in ("fwd", "dx", "dw")
                      if not (name == "enc0" and kind == "dx")]
        for kind in ("fwd", "dx", "dw"):
            cases += [(f"k3.{kind}.{dt}.check", kind, dt, TRAIN_BS, PATCH,
                       PATCH, 16, 32, 3, None, None),
                      (f"dec1.{kind}.{dt}.20x50", kind, dt, 1, 20, 50, 32, 16,
                       5, None, None)]
    cases += [("enc1.valid_relu.f32", "fwd", "f32", 2 * TRAIN_BS, PATCH,
               PATCH, 16, 32, 7, "relu", True),
              ("dec2.valid_none.f32", "fwd", "f32", TRAIN_BS, PATCH, PATCH,
               16, 1, 5, None, True),
              ("enc1.fwd.bf16.1224x1024", "fwd", "bf16", 2, H, W, 16, 32, 7,
               None, None)]
    for key, kind, dt, b, h, w, cin, cout, k, act, with_bias in cases:
        dtype = dts[dt]
        wt = _rand(torch, (cout, cin, k, k), 50 + k + cin, dev, torch.float32,
                   lo=-0.5, scale=2.0 / np.sqrt(cin * k * k)).to(dtype)
        bias = (_rand(torch, (cout,), 60 + cout, dev, torch.float32, lo=-0.5,
                      scale=0.1) if with_bias else None)
        macs = b * h * w * cin * cout * k * k
        esz = 2 if dt == "bf16" else 4
        controls = []
        if kind == "fwd":
            x = _rand(torch, (b, h + k - 1, w + k - 1, cin), 7, dev, dtype)
            lib_in = x.permute(0, 3, 1, 2).contiguous()

            def run():
                return conv_valid(x, wt, bias, act)

            def plain():
                return conv_valid_plain(x, wt, bias, act)

            def library():
                return F.conv2d(lib_in, wt, bias)
            want = plain()
            nbytes = (x.numel() + b * h * w * cout + wt.numel()) * esz
            shape = f"{tuple(x.shape)}->{(b, h, w, cout)}"
        elif kind == "dx":
            # the cotangent of a (h, w) output with c_out channels
            x = _rand(torch, (b, h, w, cout), 8, dev, dtype, lo=-0.5)
            lib_in = x.permute(0, 3, 1, 2).contiguous()
            in_size = (b, cin, h + k - 1, w + k - 1)

            def run():
                return conv_valid_dx(x, wt)

            def plain():
                return conv_valid_dx_plain(x, wt)

            def library():
                return torch.nn.grad.conv2d_input(in_size, wt, lib_in)
            want = plain()
            controls = [("taps not flipped",
                         conv_valid_dx_plain(x, wt.flip(2, 3))),
                        ("halo shifted by one", torch.roll(want, 1, dims=2))]
            nbytes = (x.numel() + b * (h + k - 1) * (w + k - 1) * cin
                      + wt.numel()) * esz
            shape = f"{tuple(x.shape)}->{(b, h + k - 1, w + k - 1, cin)}"
        else:
            x = _rand(torch, (b, h + k - 1, w + k - 1, cin), 7, dev, dtype,
                      lo=-0.5)
            dy = _rand(torch, (b, h, w, cout), 8, dev, dtype, lo=-0.5)
            lib_in = x.permute(0, 3, 1, 2).contiguous()
            lib_dy = dy.permute(0, 3, 1, 2).contiguous()

            def run():
                return conv_valid_dw(x, dy)

            def plain():
                return conv_valid_dw_plain(x, dy)

            def library():
                return torch.nn.grad.conv2d_weight(lib_in, wt.shape, lib_dy)
            want = conv_valid_dw_plain(x.double(), dy.double()).float()
            got = run()
            if not torch.equal(got, run()):
                raise AssertionError(f"conv_valid_dw {key}: two runs differ")
            controls = [("kh and kw swapped", want.transpose(2, 3))]
            nbytes = (x.numel() + dy.numel()) * esz + wt.numel() * 4
            shape = f"{tuple(x.shape)},{tuple(dy.shape)}->{tuple(wt.shape)}"
        check(key, run(), want, dt, controls, ulp=kind != "dw")
        bound, by = _bound(nbytes, 2.0 * macs, dt)
        layer = {
            "ms": timer(run), "plain_ms": timer(plain),
            "library_ms": timer(library), "bound_ms": bound, "bound_by": by,
            "shape": f"{shape} k{k} {dt}"
                     + (f" bias+{act}" if with_bias else "")}
        if dt == "f32":
            layer["bound_3xtf32_ms"] = max(nbytes / PEAK_BYTES_S,
                                           2.0 * macs / PEAK_3XTF32) * 1e3
        r["layers"][key] = layer
        del x, run, plain, library, want, controls
    return r


# the largest training shapes of rows 7, 8 and 15 beyond DeepFuse's and
# SEDRFuse's: MAFusion's DB1 conv1 (its full-scale decoder's 960 -> 480 k3
# at 64x64, 16 fused images), the largest dense k3 conv of any model's
# step; Res2Fusion's 'nl' attention of one modality (16 images, 4096
# queries, 64 keys, 112 channels)
TRAIN_CONV = ("mafusion.DB1.conv1", TRAIN_BS, 960, 480, 3, PATCH)
TRAIN_NL = (TRAIN_BS, PATCH * PATCH, (PATCH // 8) ** 2, 112)


def train_shape_times(torch, F, dev, timer):
    """Rows 8 and 15 (conv_valid forward, dx and dw, f32) at TRAIN_CONV and
    row 7 (nl_minmax, nl_apply, f32) at TRAIN_NL against their plain
    versions (f32 within VALID_TOL and TOL, relative to the plain output's
    largest magnitude), timed beside the plain versions, the library calls
    (F.conv2d, conv2d_input, conv2d_weight; SDPA on (q, k, k) for
    nl_apply, none for nl_minmax) and the bounds (bytes once each over
    PEAK_BYTES_S; products at f32 FMA and at 3xTF32); and the nl autograd
    Function's forward (the two kernels) and backward (the plain version
    recomputed in f32 under autograd) in Res2Fusion's step, by CUDA
    events."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_valid import (
        conv_valid, conv_valid_dw, conv_valid_dw_plain, conv_valid_dx,
        conv_valid_dx_plain, conv_valid_plain)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        NLSpatialFlash, nl_apply, nl_apply_plain, nl_minmax,
        nl_minmax_plain)
    f32 = torch.float32
    key, b, cin, cout, k, hw = TRAIN_CONV
    xp = _rand(torch, (b, hw + k - 1, hw + k - 1, cin), 301, dev, f32)
    w = _rand(torch, (cout, cin, k, k), 302, dev, f32, lo=-0.5, scale=0.05)
    dy = _rand(torch, (b, hw, hw, cout), 303, dev, f32, lo=-0.5)
    macs = b * hw * hw * k * k * cin * cout
    rec = {"layers": {}}
    xn = xp.permute(0, 3, 1, 2)
    dyn = dy.permute(0, 3, 1, 2)
    cases = {
        "fwd": (lambda: conv_valid(xp, w, site="forward"),
                lambda: conv_valid_plain(xp, w),
                lambda: F.conv2d(xn, w),
                (xp.numel() + w.numel() + dy.numel()) * 4),
        "dx": (lambda: conv_valid_dx(dy, w),
               lambda: conv_valid_dx_plain(dy, w),
               lambda: torch.nn.grad.conv2d_input(xn.shape, w, dyn),
               (xp.numel() + w.numel() + dy.numel()) * 4),
        "dw": (lambda: conv_valid_dw(xp, dy),
               lambda: conv_valid_dw_plain(xp, dy),
               lambda: torch.nn.grad.conv2d_weight(xn, w.shape, dyn),
               (xp.numel() + w.numel() + dy.numel()) * 4)}
    for mode, (run, plain, library, nbytes) in cases.items():
        with torch.no_grad():
            got, want = run(), plain()
            scale = float(want.float().abs().max())
            rel = float((got.float() - want.float()).abs().max()) / scale
        if rel > VALID_TOL["f32"]:
            raise AssertionError(f"{key} {mode}: {rel} of max|y|")
        bound, by = _bound(nbytes, 2.0 * macs, "f32")
        rec["layers"][f"{key}.{mode}.f32"] = {
            "ms": timer(run), "plain_ms": timer(plain, reps=1),
            "library_ms": timer(library), "bound_ms": bound, "bound_by": by,
            "bound_3xtf32_ms": max(nbytes / PEAK_BYTES_S,
                                   2.0 * macs / PEAK_3XTF32) * 1e3,
            "rel_err": rel,
            "shape": f"{b}x{hw}x{hw}, {cin} -> {cout}, k{k}"}
        del got, want
    del xp, w, dy, xn, dyn
    b, n, m, c = TRAIN_NL
    q = _rand(torch, (b, n, c), 311, dev, f32, lo=-0.5)
    kk = _rand(torch, (b, m, c), 312, dev, f32, lo=-0.5)
    lohi = nl_minmax_plain(q, kk)
    products = 2.0 * b * n * m * c
    nl_cases = {
        "nl_minmax": (lambda: nl_minmax(q, kk),
                      lambda: nl_minmax_plain(q, kk), None, products,
                      (q.numel() + kk.numel()) * 4),
        "nl_apply": (lambda: nl_apply(q, kk, lohi),
                     lambda: nl_apply_plain(q, kk, lohi),
                     lambda: F.scaled_dot_product_attention(
                         q[:, None], kk[:, None], kk[:, None]),
                     2.0 * products, (2 * q.numel() + kk.numel()) * 4)}
    for name, (run, plain, library, flops, nbytes) in nl_cases.items():
        with torch.no_grad():
            got, want = run(), plain()
            scale = (float((want[1] - want[0]).abs()) if name == "nl_minmax"
                     else float(want.abs().max()))
            rel = float((got - want).abs().max()) / scale
        if rel > TOL["f32"]:
            raise AssertionError(f"{name} at the training shape: {rel}")
        bound, by = _bound(nbytes, flops, "f32")
        rec["layers"][f"res2fusion.{name}.f32"] = {
            "ms": timer(run), "plain_ms": timer(plain, reps=1),
            "library_ms": None if library is None else timer(library),
            "bound_ms": bound, "bound_by": by, "rel_err": rel,
            "shape": f"q {b}x{n}x{c}, k {b}x{m}x{c}"}
    qg = q.clone().requires_grad_()
    kg = kk.clone().requires_grad_()
    cot = torch.randn_like(q)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    fwd, bwd = [], []
    for _ in range(4):
        start.record()
        out = NLSpatialFlash.apply(qg, kg)
        mid.record()
        torch.autograd.grad(out, (qg, kg), cot)
        end.record()
        end.synchronize()
        fwd.append(start.elapsed_time(mid))
        bwd.append(mid.elapsed_time(end))
    rec["nl_function_ms"] = {"forward": float(np.median(fwd[1:])),
                             "backward": float(np.median(bwd[1:]))}
    del q, kk, qg, kg, cot, out
    torch.cuda.empty_cache()
    print(f"training shapes: {json.dumps(rec)}")
    return rec


def write_train_fixture(torch, root, n_pairs=10, n_test=2, size=512):
    """Synthetic seeded BMP pairs: `n_pairs` under train/ (the CLI splits
    them 80/20 into train and valid) and `n_test` under test/."""
    from multi_modal_image_fusion_tpu_torch.data.io import imwrite
    r = np.random.RandomState(11)
    yy, xx = np.mgrid[0:size, 0:size]
    for split, n in (("train", n_pairs), ("test", n_test)):
        for mod in ("vis", "ir"):
            os.makedirs(os.path.join(root, "synthtrain", split, mod))
        for i in range(n):
            base = 127 + 100 * np.sin(xx / (11.0 + i)) * np.cos(yy / 19.0)
            vis = np.clip(base + r.randn(size, size) * 12, 0, 255)
            ir = np.clip(255 - base * 0.7 + r.randn(size, size) * 25, 0, 255)
            for mod, img in (("vis", vis), ("ir", ir)):
                imwrite(os.path.join(root, "synthtrain", split, mod,
                                     f"{i + 1}.bmp"), img.astype(np.uint8))


# the MetaFormer configurations' weights for the step (the CPU tests,
# tests/test_torch_train_myfusion.py, take these scales from here):
# conv_in's kernels |w|, the TransitionBlocks' |w| / 4 and, in the
# transformer, the other blocks' halved: at the plain draws some
# batch-norm input channels are constant over the batch (a relu6 dead or
# saturated everywhere), whose gradient is a difference of terms
# 1/sqrt(eps) = 316 times larger, a level, so no f32
# route's gradients come near float64 (the CPU proxy of this step: 8e4 of
# the largest gradient, mixformer_ls_concat)
FORMER_TRAIN_SCALES = {"myfusion_mixformer_ls_concat": (0.25, 1.0),
                       "myfusion_transformer_fs_elem": (0.25, 0.5)}
# a draw is taken for the step check when its step is live and its f32
# F.conv2d route's gradients lie within this share of the largest float64
# gradient (`train_seed`): at some draws every f32 route misses 1e-4 (the
# CPU proxy at seed 5: RFNNest 3.2e-4, UNFusion 1.5e-4 of the largest; on
# an H100 at bs 4, UNFusion's and MAFusion's steps with the forward, dx and
# dw of conv_valid computed in float64 miss as F.conv2d's do,
# ab_times.py --dw_split: the loss is outside the conv kernels), and a
# check against them would decide nothing about the kernels
TRAIN_COND = 3e-5
TRAIN_SEEDS = range(5, 29)
# the steps checked first (DeepFuse, DenseFuse, SEDRFuse) keep their
# weights (seed 5, no search)
TRAIN_FIXED = ("deepfuse", "densefuse", "sedrfuse")
TRAIN_STEP_REPS = 10
# the train steps whose busy share `profile_steps` measures: the main path's
# and, beside it, the slowest steps (the nest models, a MetaFormer)
PROFILED_STEPS = ("deepfuse", "unfusion", "mafusion",
                  "myfusion_mixformer_ls_concat")
_VALID_SITES = ("conv_valid", "conv_valid/forward", "conv_valid/dx",
                "conv_valid_dw", "conv_valid/valid")


def train_weights(torch, model, key):
    """FORMER_TRAIN_SCALES's kernels on a MetaFormer configuration, in
    place; other models unchanged."""
    if key not in FORMER_TRAIN_SCALES:
        return model
    down, other = FORMER_TRAIN_SCALES[key]
    from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
    with torch.no_grad():
        for n, m in model.named_modules():
            if not isinstance(m, ConvLayer):
                continue
            if n.startswith("conv_in"):
                m.weight.abs_()
            elif n.startswith("down"):
                m.weight.abs_().mul_(down)
            elif not n.startswith("conv_out"):
                m.weight.mul_(other)
    return model


def biases_under_norm(model):
    """The names of the conv biases a group or batch norm follows: their
    gradient is zero in exact arithmetic (the norm subtracts the mean),
    so what a step computes for them is rounding noise."""
    from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
    return {f"{n}.layers.0.bias" for n, m in model.named_modules()
            if isinstance(m, ConvLayer) and m.norm in ("group", "batch")
            and m.bias is not None}


def _step_grads(torch, model, a, b, fast, nl_plain, branches=None):
    """The loss parts and gradients of one step of `model` (train mode) on
    (a, b): inside fast_training(fast), with the 'nl' attention's plain
    version when `nl_plain`, in float64 with the Attention's plain
    einsums (SDPA refuses float64); and the launches it made. `branches`
    (a train/branches.py `Decisions`) is open around the forward and the
    loss: it records the step's piecewise decisions, or replays
    another step's."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    from multi_modal_image_fusion_tpu_torch.train.trainer import \
        make_loss_bundle
    model.train()
    before = dict(build.LAUNCHES)
    scope = plain_nl() if nl_plain else contextlib.nullcontext()
    f64 = plain_attention() if a.dtype == torch.float64 else \
        contextlib.nullcontext()
    with fast_training(fast), scope, f64:
        with branches or contextlib.nullcontext():
            y = model(a, b)
            total, parts = make_loss_bundle()(a, b, y)
        grads = torch.autograd.grad(total, list(model.parameters()),
                                    materialize_grads=True)
    torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}
    return ({k: float(v.detach()) for k, v in parts.items()},
            [g.double() for g in grads], launches, float(y.std()))


def train_seed(torch, dev, key, name, cfg, x1, x2):
    """The first weight seed of TRAIN_SEEDS (`seeded_model`, then
    `train_weights`) whose step is live (fused image std above 1e-3, a
    non-zero gradient) and whose f32 F.conv2d route lies within TRAIN_COND
    of the largest float64 gradient; seed 5 for TRAIN_FIXED. Returns (seed,
    model). Each draw passed over is printed with the worst gradient error
    of its F.conv2d f32 route and, if live, of its kernels route, over the
    largest float64 gradient: what the selection skips stays in the log
    (tests/test_torch_train_card.py holds every model at bs 4 with no
    condition on an f32 route)."""
    import copy
    if key in TRAIN_FIXED:
        return 5, seeded_model(torch, name, 5, **cfg).to(dev)
    for seed in TRAIN_SEEDS:
        model = train_weights(torch, seeded_model(torch, name, seed, **cfg),
                              key).to(dev)
        f32 = _step_grads(torch, copy.deepcopy(model), x1, x2, False, True)
        f64 = _step_grads(torch, copy.deepcopy(model).double(), x1.double(),
                          x2.double(), False, True)
        largest = max(float(g.abs().max()) for g in f64[1])
        cond = max(float((a - c).abs().max()) for a, c in zip(f32[1], f64[1]))
        live = f64[3] > 1e-3 and largest > 0
        if live and cond <= TRAIN_COND * largest:
            return seed, model
        kernels = "not run (not live)"
        if live:        # what the draw passed over reads through the kernels
            gk = _step_grads(torch, copy.deepcopy(model), x1, x2, True,
                             False)[1]
            worst = max(float((a - c).abs().max())
                        for a, c in zip(gk, f64[1]))
            kernels = f"{worst / largest:.3g}"
        print(f"train step ({key}): weight seed {seed} passed over (fused "
              f"std {f64[3]:.3g}, f32 route {cond / max(largest, 1e-30):.3g}"
              f" of the largest float64 gradient; the kernels route "
              f"{kernels})")
    raise AssertionError(f"{key}: no weight seed of {TRAIN_SEEDS} trains "
                         f"live and within {TRAIN_COND}")


def train_step_check(torch, dev, key="deepfuse", name=None, cfg=None):
    """One train step of the same weights and batch (bs 16, 64x64, train
    mode) through the kernels (fast_training(True): conv_valid's forward,
    dx and dw for every dense k3/k5/k7 conv; Res2Fusion's 'nl' attention
    through its autograd Function, nl_minmax and nl_apply forward), through
    F.conv2d in f32 (TF32 off) and through F.conv2d in float64, each route
    on its own deep copy of the model; the two F.conv2d routes take the
    plain 'nl' attention. Launches: the kernels route launches conv_valid
    (forward and dw) exactly when the model has a dense k3/k5/k7 conv (the
    JAX gate, `_valid_eligible`; none in MyFusion's default and
    transformer configurations) and the nl kernels exactly in Res2Fusion
    (one pair a modality); the F.conv2d routes none. The kernels' loss
    parts within 1e-5 relative of the f32 route's and every gradient
    within 1e-4 of the largest gradient magnitude of the f32 route's; each
    gradient within 1e-4 of its own largest magnitude of the float64
    route's (DeepFuse, DenseFuse), or, for every other model, within 1e-4
    of the largest float64 gradient, where the float64 step replays the
    kernels route's piecewise decisions (train/branches.py: activation
    kinks, max-pool choices, the losses' signs, SSIM's clamp; a handful of
    relu flips among millions carried UNFusion's and MAFusion's whole
    miss, PERF.md §6); the error against the plain float64 step is
    reported beside it, and the kernels route's decisions flip against the
    plain float64 step's at most FLIP_RATE of each kind's (train/
    branches.py `excess`; reported, `flips_vs_f64`) (a norm's backward
    removes each channel's mean gradient and a deep model's small leaves are sums of
    cancelling terms: every f32 route loses more than 1e-4 of some of their
    own largest magnitudes; F.conv2d's and the kernels' own errors are
    reported, `own_f64`). A model with batch norms: its new running
    statistics equal across the three routes within 1e-5 relative. Every
    gradient non-zero, but a parameter the loss never reaches (zero in
    float64: Res2ConvBlock's and MixConvBlock's dead dwconv, PMGI's dead
    transfer1[1]), which must be zero through the kernels too, and the
    bias of a conv that a group or batch norm follows (or, as IFCNN's
    enc0, whose only path to the loss runs through one): the norm
    subtracts it, so its gradient is zero in exact arithmetic; it must be
    below 1e-10 of the largest in float64 and within 1e-4 of the largest
    in f32 (rounding). Weights: `train_seed` (seed 5 for the three models
    checked first). Then each route's step time
    through the port's Trainer (fast=True and fast=False), the median of
    TRAIN_STEP_REPS steps after 3."""
    import copy
    from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
    from multi_modal_image_fusion_tpu_torch.train.branches import (
        FLIP_RATE, Decisions, excess, flips)
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    name, cfg = name or key, cfg or {}
    x1 = _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 12, dev, torch.float32)
    x2 = _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 13, dev, torch.float32)
    seed, model = train_seed(torch, dev, key, name, cfg, x1, x2)
    under_norm = biases_under_norm(model)
    valid = any(isinstance(m, ConvLayer) and m._valid_eligible()
                and m.stride == 1 and not m.transpose
                for m in model.modules())
    nl = name == "res2fusion"
    kernels_model = copy.deepcopy(model)
    rec = Decisions()
    pf, gf, lf, _ = _step_grads(torch, kernels_model, x1, x2, True, False,
                                rec)
    # the float64 step that takes the kernels route's branches
    _, g64r, _, _ = _step_grads(torch, copy.deepcopy(model).double(),
                                x1.double(), x2.double(), False, True,
                                Decisions(replay=rec.log))
    f32_model = copy.deepcopy(model)
    pp, gp, lp, _ = _step_grads(torch, f32_model, x1, x2, False, True)
    f64_model = copy.deepcopy(model).double()
    rec64 = Decisions()
    _, g64, l64, _ = _step_grads(torch, f64_model, x1.double(), x2.double(),
                                 False, True, rec64)
    # the replay absorbs every flipped branch's term: bound the flips
    flipped = flips(rec.log, rec64.log)
    del rec, rec64
    if excess(flipped):
        raise AssertionError(f"train step ({key}): the kernels route flips "
                             f"{excess(flipped)} ([calls, decided, differ]) "
                             f"against float64, above {FLIP_RATE} of the "
                             f"decisions")
    allowed = set(_VALID_SITES) if valid else set()
    if nl:
        allowed |= {"nl_minmax", "nl_apply"}
    if (lp or l64 or not set(lf) <= allowed
            or (valid and not (lf.get("conv_valid/forward")
                               and lf.get("conv_valid_dw")))
            or (nl and not lf.get("nl_minmax") == lf.get("nl_apply") == 2)):
        raise AssertionError(f"train step ({key}) launches: kernels {lf} "
                             f"(dense k3/5/7 {valid}, nl {nl}), F.conv2d "
                             f"{lp}, float64 {l64}")
    for k in pf:
        if abs(pf[k] - pp[k]) > 1e-5 * abs(pp[k]):
            raise AssertionError(f"train step ({key}) {k}: kernels {pf[k]} "
                                 f"vs F.conv2d {pp[k]}")
    stats_err = 0.0
    for (n, a), b, c in zip(kernels_model.named_buffers(),
                            f32_model.buffers(), f64_model.buffers()):
        if not n.endswith(("running_mean", "running_var")):
            continue
        scale = float(c.abs().max())
        err = max(float((a.double() - c).abs().max()),
                  float((b.double() - c).abs().max()))
        if err > 1e-5 * scale:
            raise AssertionError(f"train step ({key}) {n}: {err} above "
                                 f"1e-5 x {scale} across the routes")
        stats_err = max(stats_err, err / scale)
    largest = max(float(b.abs().max()) for b in gp)
    largest64 = max(float(c.abs().max()) for c in g64r)
    plain64 = max(float(c.abs().max()) for c in g64)
    own_rule = key in ("deepfuse", "densefuse")
    worst, worst64, worst_own, f32_own, own_f64 = 0.0, 0.0, 0.0, 0.0, {}
    worst_plain, exempt, dead = 0.0, 0, 0
    for (pname, _), a, b, c, c0 in zip(model.named_parameters(), gf, gp,
                                       g64r, g64):
        err = float((a - b).abs().max())
        if err > 1e-4 * largest:
            raise AssertionError(f"train step ({key}) grad {pname}: {err} "
                                 f"above 1e-4 x {largest} (F.conv2d f32)")
        own = float(c.abs().max())
        if own == 0.0:
            if float(a.abs().max()) != 0.0:
                raise AssertionError(f"train step ({key}): {pname} gets a "
                                     f"gradient through the kernels only")
            dead += 1
            continue
        if pname in under_norm or (pname.endswith(".bias")
                                   and own <= 1e-10 * largest64):
            if own > 1e-10 * largest64 or float(a.abs().max()) > \
                    1e-4 * largest:
                raise AssertionError(f"train step ({key}) grad {pname} "
                                     f"under a norm: "
                                     f"{float(a.abs().max())} (float64 "
                                     f"{own})")
            exempt += 1
            continue
        err64 = float((a - c).abs().max())
        f32_err64 = float((b - c0).abs().max())
        plain_err = float((a - c0).abs().max())
        worst_plain = max(worst_plain, plain_err / plain64)
        bound = 1e-4 * (own if own_rule else largest64)
        if err64 > bound:
            raise AssertionError(f"train step ({key}) grad {pname}: {err64} "
                                 f"above {bound} (F.conv2d float64 with the "
                                 f"kernels route's branches; its own largest "
                                 f"{own}; against plain float64 {plain_err}; "
                                 f"F.conv2d f32 {f32_err64})")
        worst = max(worst, err / largest)
        worst64 = max(worst64, err64 / largest64)
        worst_own = max(worst_own, err64 / own)
        f32_own = max(f32_own, f32_err64 / own)
        if err64 > 1e-4 * own:
            own_f64[pname] = {"kernels": err64 / own,
                              "conv2d_f32": f32_err64 / own}
    batch = (x1, x2)
    step_ms = {}
    for route, fast in (("kernels", True), ("conv2d", False)):
        trainer = Trainer(copy.deepcopy(model), make_lr_schedule(1e-4, 100, 12),
                          fast=fast)
        times = []
        with plain_nl() if (nl and not fast) else contextlib.nullcontext():
            for i in range(3 + TRAIN_STEP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        step_ms[route] = float(np.median(times[3:]))
        del trainer
    del kernels_model, f32_model, f64_model, model
    torch.cuda.empty_cache()
    return {"weight_seed": seed, "loss_parts": pf, "max_grad_rel_err": worst,
            "max_grad_rel_err_own_f64": worst_own,
            "f32_conv2d_rel_err_own_f64": f32_own,
            "f32_conv2d_rel_err_f64": max(
                float((b - c).abs().max()) for b, c in zip(gp, g64))
            / largest64,
            "params": len(gf), "biases_under_norm": exempt,
            "unreached_params": dead, "max_grad_rel_err_f64": worst64,
            "max_grad_rel_err_plain_f64": worst_plain,
            "flips_vs_f64": flipped,
            "own_f64": own_f64, "running_stats_rel_err": stats_err,
            "launches": lf, "step_ms": step_ms,
            "bound": "own" if own_rule else "largest_f64"}


def profile_steps(torch, dev, key="deepfuse", steps=20):
    """Busy share of the card over `steps` train steps of `key` (a
    TRAIN_CHECKS key) on one device batch (bs 16, 64x64, f32, fast):
    summed kernel time over wall time, from torch.profiler; the device time
    of the conv_valid kernels (forward and dx), of the dw kernel (by its
    name, and by the `conv_valid_dw` range around its wrapper), of the loss
    and of the optimizer update. Also the steps' wall time without the
    profiler. Weights: DeepFuse's from seed 6; the others' as the step
    check's first draw (seed 5, `train_weights`)."""
    from torch.autograd import DeviceType
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    name, cfg = {k: (n, c) for k, n, c in TRAIN_CHECKS}[key]
    seed = 6 if key == "deepfuse" else 5
    model = train_weights(torch, seeded_model(torch, name, seed, **cfg),
                          key).to(dev)
    trainer = Trainer(model, make_lr_schedule(1e-4, 32, 12), fast=True)
    batch = (_rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 14, dev, torch.float32),
             _rand(torch, (TRAIN_BS, PATCH, PATCH, 1), 15, dev, torch.float32))
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    conv_ms = sum(e.device_time_total for e in kernels
                  if "conv_valid_tc_kernel" in e.name) / 1e3
    dw_kernel_ms = sum(e.device_time_total for e in kernels
                       if "conv_valid_dw_kernel" in e.name) / 1e3

    def range_ms(name):
        return sum(e.device_time_total for e in events
                   if e.name == name and e.device_type == DeviceType.CPU) / 1e3
    # busy share against the unprofiled step: the profiler's own host cost
    # lengthens the profiled steps, not their kernels
    rec = {"steps": steps, "step_ms_unprofiled": plain_wall,
           "wall_ms_profiled": wall / steps, "kernel_ms": dev_ms / steps,
           "launches": len(kernels) / steps,
           "busy_share": dev_ms / steps / plain_wall,
           "busy_share_profiled": dev_ms / wall, "source": "torch.profiler"}
    if dev_ms == 0.0:
        # no device time in the trace: enqueue the steps behind a sleep so
        # the card runs them back to back, and time that with CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9))
        start.record()
        for _ in range(steps):
            trainer.train_step(batch)
        end.record()
        end.synchronize()
        dev_ms = start.elapsed_time(end)
        rec.update(kernel_ms=dev_ms / steps, busy_share=dev_ms / steps
                   / plain_wall, busy_share_profiled=None,
                   source="cuda events behind a sleep")
    rec.update({k + "_ms": v / steps for k, v in (
        ("conv_valid", conv_ms), ("dw", range_ms("conv_valid_dw")),
        ("dw_kernel", dw_kernel_ms),
        ("loss", range_ms("loss")), ("optimizer", range_ms("optimizer")))})
    return rec


def train_phase(torch, build, root):
    """The port's train CLI at the reference defaults with --fast_train;
    returns (launch counts, per-step seconds, checkpoint dir)."""
    from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    step_s = []
    orig = Trainer.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    Trainer.train_step = timed
    try:
        build.LAUNCHES.clear()
        ckpt_dir = train_cli.main([
            "--data", "synthtrain", "--data_root", root, "--ckpt_root",
            os.path.join(root, "ckpt"), "--epoch", "2", "--bs",
            str(TRAIN_BS), "--fast_train"])
        counts = dict(build.LAUNCHES)
    finally:
        Trainer.train_step = orig
    return counts, step_s, ckpt_dir


def bn_cli_path(torch, build, test_cli, root, dev):
    """A trained batch norm serves: IFCNN trained by the port's train CLI
    (--fast_train, one epoch of the synthetic fixture: 32 steps at bs 16
    on 64x64 patches, its batch norms in train mode, the valid batches in
    eval mode), then the port's test CLI on the card serving that
    checkpoint (every count set to 0 just before it: FORWARD_LAUNCHES a
    pair, 2 ssim_maps). The checkpoint's running statistics moved from the
    init's (enc1's num_batches_tracked twice dec0's: the encoder runs once
    a modality); the CLI's SSIM within 1e-4 of the f32 plain path's (the
    serving kernels' plain versions in f32, which fold those trained
    statistics, `plain_route`) and each pair's fused image through the
    kernels within 1e-4 of that path's largest magnitude."""
    from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
    from multi_modal_image_fusion_tpu_torch.data.dataset import \
        FusionDataset
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import (
        checkpoint_path, restore)
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ckpt_dir = train_cli.main([
        "--data", "synthtrain", "--data_root", root, "--ckpt_root",
        os.path.join(root, "bn_ckpt"), "--epoch", "1", "--bs", str(TRAIN_BS),
        "--model", "ifcnn", "--fast_train"])
    train_s = time.perf_counter() - t0
    train_counts = dict(build.LAUNCHES)
    if not (train_counts.get("conv_valid/forward")
            and train_counts.get("conv_valid_dw")):
        raise AssertionError(f"ifcnn train CLI launches {train_counts}")
    model = create_model("ifcnn", generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    restore(model, checkpoint_path(ckpt_dir))
    tracked = {k: int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    moved = [k for k, v in model.state_dict().items()
             if k.endswith("running_var") and not torch.equal(v, init[k])]
    enc, dec = (tracked[f"{m}.layers.1.num_batches_tracked"]
                for m in ("encode.1", "decode.0"))
    if len(moved) != 2 or not dec or enc != 2 * dec:
        raise AssertionError(f"ifcnn checkpoint statistics: moved {moved}, "
                             f"tracked {tracked}")
    build.LAUNCHES.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ssim, avg = test_cli.main([
            "--data", "synthtrain", "--data_root", root, "--ckpt_root",
            os.path.dirname(ckpt_dir), "--ckpt", os.path.basename(ckpt_dir)])
    counts = dict(build.LAUNCHES)
    ds = FusionDataset(os.path.join(root, "synthtrain"), "test", "test",
                       "ir")
    want = {k: v * len(ds) for k, v in FORWARD_LAUNCHES["ifcnn"].items()}
    want["ssim_maps"] = 2 * len(ds)
    if counts != want:
        raise AssertionError(f"ifcnn test CLI launches {counts}, want {want}")
    model = model.to(dev).eval()
    ref, y_err, y_max = [], 0.0, 0.0
    with torch.no_grad():
        for i in range(len(ds)):
            a, b = (torch.from_numpy(v)[None, ..., None].to(dev)
                    for v in ds[i])
            y_kernels = model(a, b)
            with plain_route("ifcnn"):
                y = model(a, b)
            y_err = max(y_err, float((y_kernels - y).abs().max()))
            y_max = max(y_max, float(y.abs().max()))
            ref.append(float((_plain_ssim(torch, a, y)
                              + _plain_ssim(torch, b, y))[0] * 0.5))
    ref_ssim = float(np.mean(ref))
    if not (np.isfinite(ssim) and abs(ssim - ref_ssim) <= 1e-4
            and y_err <= TOL["f32"] * max(y_max, 1.0)):
        raise AssertionError(f"ifcnn trained test CLI SSIM {ssim} vs the f32 "
                             f"plain path {ref_ssim}; fused max |d| {y_err}")
    rec = {"train_s": train_s, "train_launches": train_counts,
           "batches_tracked": tracked,
           "pairs": len(ds), "ssim": ssim, "ssim_f32_plain": ref_ssim,
           "fused_max_abs_err": y_err, "fused_max": y_max,
           "mean_ms": avg * 1e3,
           "int8": bn_int8_cli(torch, build, test_cli, root, dev, ckpt_dir,
                               model, ds)}
    print(f"ifcnn trained by the train CLI, served by the test CLI: "
          f"{json.dumps(rec)}")
    return rec


def bn_int8_cli(torch, build, test_cli, root, dev, ckpt_dir, model, ds):
    """The test CLI --int8 on the trained IFCNN checkpoint (its batch norms
    in conv_int8's epilogue), every count set to 0 just before it:
    FORWARD_LAUNCHES["ifcnn"] for each of its min(4, N) calibration
    pairs, INT8_FORWARD_LAUNCHES["ifcnn"] and 2 ssim_maps a pair; then,
    on the CLI's calibration, the int8 kernels against the plain int8
    path (`plain_int8`) on every pair, within max 2e-2 and mean 1e-4 of
    max|y| (tests/test_int8.py:121-128)."""
    from multi_modal_image_fusion_tpu_torch.ops.quant import calibrate
    build.LAUNCHES.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ssim, avg = test_cli.main([
            "--data", "synthtrain", "--data_root", root, "--ckpt_root",
            os.path.dirname(ckpt_dir), "--ckpt", os.path.basename(ckpt_dir),
            "--int8"])
    counts = dict(build.LAUNCHES)
    n_cal = min(4, len(ds))
    want = collections.Counter({k: v * n_cal for k, v in
                                FORWARD_LAUNCHES["ifcnn"].items()})
    want.update({k: v * len(ds)
                 for k, v in INT8_FORWARD_LAUNCHES["ifcnn"].items()})
    want["ssim_maps"] = 2 * len(ds)
    if counts != dict(want):
        raise AssertionError(f"ifcnn test CLI --int8 launches {counts}, "
                             f"want {dict(want)}")
    pairs = [tuple(torch.from_numpy(v)[None, ..., None].to(dev)
                   for v in ds[i]) for i in range(len(ds))]
    worst_max, worst_mean = int8_vs_plain(
        torch, model, pairs, calibrate(model, pairs[:n_cal]))
    if not (np.isfinite(ssim) and worst_max <= 2e-2
            and worst_mean <= 1e-4):
        raise AssertionError(f"ifcnn test CLI --int8: SSIM {ssim}; kernel "
                             f"vs plain int8 max {worst_max}, mean "
                             f"{worst_mean} of max|y|")
    return {"ssim": ssim, "mean_ms": avg * 1e3, "launches": counts,
            "kernel_vs_plain_max_rel": worst_max,
            "kernel_vs_plain_mean_rel": worst_mean}


def jax_ckpt_cli_path(torch, build, test_cli, root, dev):
    """The test CLI on the JAX package's IFCNN checkpoint committed in
    tests/torch_fixtures/ifcnn_jax (flax msgpack of a TrainState, read by
    train/checkpoint.py without flax, JAX or msgpack), every count set to
    0 just before it: FORWARD_LAUNCHES["ifcnn"] and 2 ssim_maps a pair.
    The restore takes every leaf (nothing missing, nothing unexpected);
    each pair's fused image (before the BMP's rounding) within 1e-4 of
    the largest magnitude of the f32 plain path's on the same weights
    (`plain_route`). Records whether flax and msgpack are installed."""
    import importlib.util
    import shutil
    from multi_modal_image_fusion_tpu_torch.data.dataset import \
        FusionDataset
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import (
        checkpoint_path, restore)
    run_dir = os.path.join(root, "jax_ckpt", "run")
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "torch_fixtures", "ifcnn_jax"), run_dir)
    fused = []
    keep = test_cli.save_result

    def save_result(img):
        fused.append(img.copy())
        return keep(img)
    build.LAUNCHES.clear()
    out = io.StringIO()
    test_cli.save_result = save_result
    try:
        with contextlib.redirect_stdout(out):
            ssim, avg = test_cli.main([
                "--data", "synthtrain", "--data_root", root, "--ckpt_root",
                os.path.dirname(run_dir), "--ckpt", "run"])
    finally:
        test_cli.save_result = keep
    counts = dict(build.LAUNCHES)
    ds = FusionDataset(os.path.join(root, "synthtrain"), "test", "test",
                       "ir")
    want = {k: v * len(ds) for k, v in FORWARD_LAUNCHES["ifcnn"].items()}
    want["ssim_maps"] = 2 * len(ds)
    if counts != want or len(fused) != len(ds):
        raise AssertionError(f"JAX checkpoint test CLI launches {counts}, "
                             f"want {want}; {len(fused)} images")
    model = create_model("ifcnn")
    left = restore(model, checkpoint_path(run_dir))
    if left != ([], []):
        raise AssertionError(f"JAX checkpoint restore left {left}")
    model = model.to(dev).eval()
    rel = 0.0
    with torch.no_grad(), plain_route("ifcnn"):
        for i in range(len(ds)):
            a, b = (torch.from_numpy(v)[None, ..., None].to(dev)
                    for v in ds[i])
            y = model(a, b)[0].float().cpu().numpy()
            rel = max(rel, float(np.abs(fused[i] - y).max()
                                 / np.abs(y).max()))
    if not (np.isfinite(ssim) and rel <= 1e-4):
        raise AssertionError(f"JAX checkpoint test CLI: SSIM {ssim}, fused "
                             f"images {rel} of the f32 plain path's max")
    rec = {"pairs": len(ds), "ssim": ssim, "mean_ms": avg * 1e3,
           "fused_max_rel_err": rel, "launches": counts,
           "flax_installed": importlib.util.find_spec("flax") is not None,
           "msgpack_installed":
               importlib.util.find_spec("msgpack") is not None}
    print(f"test CLI on the JAX IFCNN checkpoint: {json.dumps(rec)}")
    return rec


def plain_forward(torch, model, img1, img2):
    """The f32 DeepFuse forward through the plain versions only."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        conv_chain_plain, conv_gray_enter_plain, conv_gray_exit_plain)
    enc0, enc1 = model.encode
    dec0, dec1, dec2 = model.decode

    def p(layer):
        return layer.weight.float(), layer.bias.float(), layer.act

    t = conv_gray_enter_plain(img1.float(), img2.float(), *p(enc0))
    t = conv_chain_plain(t, *p(enc1))
    t = conv_chain_plain(t, *p(dec0), fuse_n=img1.shape[0])
    t = conv_chain_plain(t, *p(dec1))
    return conv_gray_exit_plain(t, *p(dec2))


def _plain_ssim(torch, x, y):
    from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import \
        ssim_maps_plain
    from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel
    ws = min(11, x.shape[1], x.shape[2])
    return ssim_maps_plain(x, y, gaussian_kernel(ws, 1.5), 1.0)[0].mean(
        dim=(1, 2, 3))


def write_cli_fixture(torch, root, n_pairs=CLI_PAIRS):
    """Synthetic 1224x1024 BMP pairs and a seeded DeepFuse checkpoint."""
    from multi_modal_image_fusion_tpu_torch.data.io import imwrite
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
        save_state_dict
    r = np.random.RandomState(7)
    for mod in ("vis", "ir"):
        os.makedirs(os.path.join(root, "data", "synth", "test", mod))
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n_pairs):
        base = 127 + 100 * np.sin(xx / (17.0 + i)) * np.cos(yy / 23.0)
        vis = np.clip(base + r.randn(H, W) * 10, 0, 255).astype(np.uint8)
        ir = np.clip(255 - base * 0.6 + r.randn(H, W) * 20, 0,
                     255).astype(np.uint8)
        imwrite(os.path.join(root, "data", "synth", "test", "vis",
                             f"{i + 1}.bmp"), vis)
        imwrite(os.path.join(root, "data", "synth", "test", "ir",
                             f"{i + 1}.bmp"), ir)
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(3))
    ckpt_dir = os.path.join(root, "ckpt", "run")
    save_state_dict(os.path.join(ckpt_dir, "epoch_best.pth"),
                    model.state_dict(), meta={"model": "deepfuse"})
    with open(os.path.join(ckpt_dir, "train.log"), "w") as f:
        f.write("synthetic run")
    return model


def _window_control(torch, got, want, what):
    """How far the kernel's maps miss the plain maps of the pair shifted by
    one row or one column, relative to max(|y|, 1): a control the checks
    must catch (10x TOL)."""
    worst = float("inf")
    for g, c in zip(got, want):
        g = g[:, :-1] if what == "row" else g[:, :, :-1]
        rel = float((g - c).abs().max()) / max(float(c.abs().max()), 1.0)
        if rel <= 10 * TOL["f32"]:
            raise AssertionError(f"control (shifted by one {what}) misses "
                                 f"by {rel:.3g} only")
        worst = min(worst, rel)
    return worst


def check_window(torch, F, dev, timer):
    """Rows 4 and 6: ssim_maps and moments at every shape the test and eval
    CLIs launch (ab_times.window_cases: the test CLI's 1x1224x1024 pair in
    0..1, the eval chunk's 16 pairs in 0..255 at its five MS-SSIM levels and
    its four VIF scales), f32, against their plain versions (TF32 off) at
    1e-4 of max(|y|, 1), each with the controls (the plain maps of the pair
    shifted by one row and by one column must miss by 10x); the 45x61 pairs
    with use_padding. Times per shape: the raw launch (the C entry on
    outputs allocated beforehand), the wrapper call, the wrapper's host time
    a call (host clock over 50 calls), the plain version, and the library:
    the five products stacked (timed apart), then two grouped F.conv2d
    passes (groups 5, a (ws, 1) then a (1, ws) window)."""
    from multi_modal_image_fusion_tpu_torch.ab_times import (
        window_cases, window_pair, window_raw)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.moments import (
        moments, moments_plain)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.ssim_kernel import (
        ssim_maps, ssim_maps_plain)
    from multi_modal_image_fusion_tpu_torch.ops.ssim import gaussian_kernel
    recs = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                   "min_control_rel_err": float("inf"),
                   "tolerance_rel": TOL["f32"], "layers": {}}
            for name in ("ssim_maps", "moments")}
    gen = torch.Generator(device=dev).manual_seed(60)

    def calls(kern, ws, rng):
        if kern == "ssim_maps":
            taps = gaussian_kernel(ws, 1.5)
            return (taps, lambda x, y, pad=False: ssim_maps(x, y, ws, rng,
                                                            pad, 1.5),
                    lambda x, y, pad=False: ssim_maps_plain(x, y, taps, rng,
                                                            pad))
        taps = gaussian_kernel(ws, ws / 5)
        return (taps, lambda x, y, pad=False: moments(x, y, ws, ws / 5, pad),
                lambda x, y, pad=False: moments_plain(x, y, taps, pad))

    def hold(r, got, want):
        for g, w_ in zip(got, want):
            err, rel = _err(torch, g, w_, "f32")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)

    for name, kern, n, h, w, ws in window_cases():
        r = recs[kern]
        rng = 1.0 if name.endswith("test_cli") else 255.0
        a, b = window_pair(torch, n, h, w, gen, dev)
        a, b = a * (rng / 255), b * (rng / 255)
        taps, call, plain = calls(kern, ws, rng)
        got = call(a, b)
        hold(r, got, plain(a, b))
        for what, sl in (("row", (slice(None), slice(1, None))),
                         ("column", (slice(None), slice(None),
                                     slice(1, None)))):
            r["min_control_rel_err"] = min(
                r["min_control_rel_err"],
                _window_control(torch, got, plain(a[sl], b[sl]), what))
        del got
        raw = window_raw(torch, kern, a, b, ws, rng)
        x5 = torch.stack((a, b, a * a, b * b, a * b), 1)[..., 0]
        t = torch.as_tensor(taps, device=dev)
        wv, wh = t.view(1, 1, ws, 1).expand(5, 1, ws, 1), \
            t.view(1, 1, 1, ws).expand(5, 1, 1, ws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call(a, b)
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        px = n * (h - ws + 1) * (w - ws + 1)
        if kern == "ssim_maps":
            # 3 products + 5 maps x ws taps x 2 passes x 2 flops + algebra
            bound, by = _bound(n * h * w * 8 + px * 12,
                               px * (3 + 20 * ws + 20), "f32")
        else:
            # 3 products a pixel; 5 maps x ws taps x 2 passes x 2 flops
            bound, by = _bound(n * h * w * 8 + px * 20,
                               3 * n * h * w + 20 * ws * px, "f32")
        r["layers"][name] = {
            "ms": timer(raw), "wrapper_ms": timer(lambda: call(a, b)),
            "wrapper_host_ms": host,
            "plain_ms": timer(lambda: plain(a, b)),
            "library_ms": timer(lambda: F.conv2d(
                F.conv2d(x5, wv, groups=5), wh, groups=5)),
            "library_products_ms": timer(lambda: torch.stack(
                (a, b, a * a, b * b, a * b), 1)),
            "bound_ms": bound, "bound_by": by,
            "shape": f"{n}x{h}x{w}x1 pair f32 ws{ws} VALID"}
        print(f"{kern} {name}: {json.dumps(r['layers'][name])}")
        del a, b, raw, x5
        torch.cuda.empty_cache()
    for kern, ws in (("ssim_maps", 11), ("moments", 3)):
        a, b = window_pair(torch, 2, 45, 61, gen, dev)
        _, call, plain = calls(kern, ws, 255.0)
        for pad in (False, True):
            hold(recs[kern], call(a, b, pad), plain(a, b, pad))
    return recs


def check_conv_multi(torch, F, dev, timer):
    """conv_multi against its plain version (the legs' concat, then
    conv_chain_plain): DenseFuse's dense convs and dec0 (fuse_n), VIFNet's
    8-leg dec0, NestFuse's 3-leg DB2_2 conv1, RFNNest's RFN1 res (two
    legs of one tensor at b_offs 0 and n) and fuse1, DIFNet's and PMGI's
    shapes and MyFusion's pwconv2 with its identity leg and DB2_1's k1 pw1
    at their scales of 1224x1024, bf16 batch 16 (the bench) and f32 one
    pair (the test CLI);
    k1, k5, 1-channel-leg and identity-leg cases at 45x61 in f32 and bf16;
    CHAIN_TOL, with the controls at the bench's shapes (for res the b_offs
    of its legs swapped; a k1 conv's input channels reversed). Times at
    the bench's shapes; the library time is
    one F.conv2d on the padded concat, the concat and the pad timed
    apart."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import (
        concat_legs, conv_multi, conv_multi_plain, identity_weights)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0,
         "min_control_rel_err": float("inf"), "tolerance_rel": CHAIN_TOL,
         "layers": {}}

    def case(key, legs, wt, bias, fuse_n, n_out, dt, timed):
        wt = wt.to(dts[dt])
        want = conv_multi_plain(legs, wt, bias, "relu", fuse_n, n_out)
        err, rel = _chain_err(torch, conv_multi(legs, wt, bias, "relu",
                                                fuse_n, n_out), want, dt)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        if timed:
            def cat():
                x = concat_legs(legs, fuse_n, n_out)
                return (x[:n_out] + x[n_out:] if fuse_n else x).permute(
                    0, 3, 1, 2)
            xn = cat()
            ctls = {}
            if wt.shape[-1] > 1:
                ctls["taps transposed"] = conv_multi(
                    legs, wt.transpose(2, 3), bias, "relu", fuse_n, n_out)
                ctls["zero halo"] = _zero_halo_plain(
                    torch, F, xn.permute(0, 2, 3, 1), wt, bias, "relu")
            else:                     # a k1 conv has one tap and no halo
                ctls["input channels reversed"] = conv_multi(
                    legs, wt.flip(1), bias, "relu", fuse_n, n_out)
            same = [(i, j) for i in range(len(legs))
                    for j in range(i + 1, len(legs))
                    if legs[i][0].shape[-1] == legs[j][0].shape[-1]
                    and legs[i][0] is not legs[j][0]]
            # else two legs of one tensor at other batch offsets (RFN's
            # res); one swap a case (VIFNet's dec0 has both kinds, and the
            # device no room for a third 16-pair output)
            halves = [(i, j) for i in range(len(legs))
                      for j in range(i + 1, len(legs))
                      if legs[i][0] is legs[j][0]
                      and legs[i][1] != legs[j][1]]
            if same or halves:
                i, j = (same or halves)[0]
                sw = list(legs)
                sw[i], sw[j] = legs[j], legs[i]
                what = "legs" if same else "b_offs of legs"
                ctls[f"{what} {i} and {j} swapped"] = conv_multi(
                    sw, wt, bias, "relu", fuse_n, n_out)
            if fuse_n:
                ctls["one half reversed"] = conv_multi(
                    [(torch.cat([t[:off + fuse_n],
                                 t[off + fuse_n:off + fuse_n + n_out]
                                 .flip(0)]), off) for t, off in legs],
                    wt, bias, "relu", fuse_n, n_out)
            _check_controls(torch, r, f"conv_multi {key}", want, ctls)
            del ctls, want
            k = wt.shape[-1]
            p = k // 2
            parts, xp = _library_parts(F, xn, k, wt.shape[0])
            bl = bias.to(dts[dt])
            h, w = xn.shape[2:]
            esz = 2 if dt == "bf16" else 4
            read = sum(n_out * h * w * t.shape[-1] for t, _ in legs)
            read *= 2 if fuse_n else 1
            bound, by = _bound(
                (read + n_out * h * w * wt.shape[0] + wt.numel()) * esz,
                2.0 * n_out * h * w * wt.shape[1] * wt.shape[0] * k * k, dt)
            r["layers"][key] = {
                "ms": timer(lambda: conv_multi(legs, wt, bias, "relu",
                                               fuse_n, n_out)),
                "plain_ms": timer(lambda: conv_multi_plain(
                    legs, wt, bias, "relu", fuse_n, n_out)),
                "library_ms": timer(lambda: [F.conv2d(t, wt, bl)
                                             for t in xp]),
                "library_concat_ms": timer(cat),
                "library_pad_ms": timer(lambda: [
                    F.pad(xn[sl], (p, p, p, p), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                **_tc_block(wt.shape[0], [t.shape[-1] for t, _ in legs], k,
                            dt, fuse_n),
                "bound_ms": bound, "bound_by": by,
                "shape": f"{len(legs)} legs {[t.shape[-1] for t, _ in legs]}"
                         f" b_offs {[o for _, o in legs]} fuse_n {fuse_n} -> "
                         f"{n_out}x{h}x{w}x{wt.shape[0]} k{k} {dt}"}
            del xn, xp
            stamp(f"conv_multi {key} checked and timed")

    def weights(cout, cin, k, seed):
        return (_rand(torch, (cout, cin, k, k), seed, dev, torch.float32,
                      lo=-0.5, scale=2.0 / np.sqrt(cin * k * k)),
                _rand(torch, (cout,), seed + 1, dev, torch.float32, lo=-0.5,
                      scale=0.1))

    for dt, n in (("bf16", BATCH), ("f32", 1)):
        dtype = dts[dt]
        timed = dt == "bf16"
        legs = [_rand(torch, (2 * n, H, W, 16), 90, dev, dtype, lo=-0.5)]
        for i in range(3):
            wt, bias = weights(16, 16 * (i + 1), 3, 91 + 2 * i)
            ls = [(t, 0) for t in legs]
            case(f"densefuse.conv{i}", ls, wt, bias, 0, 2 * n, dt, timed)
            legs.append(conv_multi(ls, wt.to(dtype), bias, "relu"))
        wt, bias = weights(64, 64, 3, 97)
        case("densefuse.dec0", [(t, 0) for t in legs], wt, bias, n, n, dt,
             timed)
        wt, bias = weights(128, 128, 3, 99)
        case("vifnet.dec0", [(t, 0) for t in legs] + [(t, n) for t in legs],
             wt, bias, 0, n, dt, timed)
        del legs
        torch.cuda.empty_cache()
        # NestFuse's DB2_2 conv1: legs 112 + 112 + 160 -> 192 at scale 1
        ls = [_rand(torch, (n, *_S[1], c), 120 + i, dev, dtype, lo=-0.5)
              for i, c in enumerate((112, 112, 160))]
        wt, bias = weights(192, 384, 3, 123)
        case("nestfuse.DB2_2.conv1", [(t, 0) for t in ls], wt, bias, 0, n,
             dt, timed)
        del ls
        # RFNNest's RFN1 (64 channels, scale 0): res over the two halves of
        # the encoder's batch (b_offs 0 and n), fuse1 (k1) over conv1's and
        # conv2's outputs
        f = _rand(torch, (2 * n, H, W, 64), 125, dev, dtype, lo=-0.5)
        wt, bias = weights(64, 128, 3, 126)
        case("rfnnest.RFN1.res", [(f, 0), (f, n)], wt, bias, 0, n, dt, timed)
        wt, bias = weights(64, 128, 1, 128)
        case("rfnnest.RFN1.fuse1", [(f[:n], 0), (f[n:], 0)], wt, bias, 0, n,
             dt, timed)
        del f
        torch.cuda.empty_cache()
        # DIFNet's ResBlock conv2 with its residual as an identity
        # leg (32 images), its fuse over the encoder batch's halves, PMGI's
        # 4-leg gradient3 (16-channel legs)
        t = [_rand(torch, (2 * n, H, W, 16), 130 + i, dev, dtype, lo=-0.5)
             for i in range(4)]
        wt, bias = weights(16, 16, 3, 134)
        wt = torch.cat([wt, identity_weights(3, 16).to(dev)], 1)
        case("difnet.enc1.conv2+identity", [(t[0], 0), (t[1], 0)], wt, bias,
             0, 2 * n, dt, timed)
        wt, bias = weights(16, 32, 3, 136)
        case("difnet.fuse", [(t[0], 0), (t[0], n)], wt, bias, 0, n, dt,
             timed)
        wt, bias = weights(16, 64, 3, 138)
        case("pmgi.gradient3", [(x[:n], 0) for x in t], wt, bias, 0, n, dt,
             timed)
        del t
        torch.cuda.empty_cache()
        # MyFusion: EB1_1's pwconv2 (64 -> 16, k1) with the identity
        # shortcut as a leg (32 images), DB2_1's pw1 over its legs (32 + 64
        # -> 48, k1, at scale 1)
        t = [_rand(torch, (2 * n, H, W, c), 140 + c, dev, dtype, lo=-0.5)
             for c in (64, 16)]
        wt, bias = weights(16, 64, 1, 141)
        wt = torch.cat([wt, identity_weights(1, 16).to(dev)], 1)
        case("myfusion.EB1_1.pwconv2+identity", [(x, 0) for x in t], wt,
             bias, 0, 2 * n, dt, timed)
        del t
        t = [_rand(torch, (n, *_S[1], c), 143 + c, dev, dtype, lo=-0.5)
             for c in (32, 64)]
        wt, bias = weights(48, 96, 1, 144)
        case("myfusion.DB2_1.pw1", [(x, 0) for x in t], wt, bias, 0, n, dt,
             timed)
        del t
        torch.cuda.empty_cache()
    for dt, dtype in dts.items():
        x = [_rand(torch, (2, 45, 61, 16), 100 + i, dev, dtype)
             for i in range(2)]
        g = [_rand(torch, (2, 45, 61, 1), 102 + i, dev, dtype)
             for i in range(2)]
        wt, bias = weights(16, 32, 1, 104)
        case("k1", [(t, 0) for t in x], wt, bias, 0, 2, dt, False)
        wt, bias = weights(32, 32, 5, 106)
        case("k5", [(t, 0) for t in x], wt, bias, 0, 2, dt, False)
        wt, bias = weights(16, 2, 5, 108)
        case("gray_legs", [(t, 0) for t in g], wt, bias, 0, 2, dt, False)
        wt, bias = weights(16, 16, 3, 110)
        wt = torch.cat([wt, identity_weights(3, 16).to(dev)], 1)
        case("identity_leg", [(t, 0) for t in x], wt, bias, 0, 2, dt, False)
    return r


NL_REPLACES = ("multi_modal_image_fusion_tpu/ops/pallas/nl_kernel.py:132 "
               "(nl_spatial_flash; pallas_call :160, _nl_minmax_kernel :58)",
               "multi_modal_image_fusion_tpu/ops/pallas/nl_kernel.py:132 "
               "(nl_spatial_flash; pallas_call :183, _nl_apply_kernel :102)")
RES2_BATCH = 2         # the res2fusion bench's pairs a forward
# the mafusion bench's pairs a forward: its decoder's 960-channel legs at
# scale 0 are 2.4 GB an image in bf16, its 480-channel hidden layer 1.2 GB
MAFUSION_BATCH = 4


# nl tolerances. nl_minmax: relative to the range hi - lo, both dtypes (the
# products of bf16 inputs are exact in f32; only the summation order
# differs). nl_apply: relative to the largest attention term |out - mean(k)|,
# the part of the output that the energies decide; bf16 5e-2: the kernel
# rounds the unnormalised weights to bf16 and the plain version the
# normalised ones, each 2^-9 a weight, and with 35 keys the output is a
# tenth of the keys' magnitude, so the two roundings differ by up to ~2e-2
# of it. The controls below (keys swapped within pairs, k's channels
# rolled, the range reduced per image) must fail these tolerances, and the
# smoke fails if they pass. NL_ROUND_TOL: bf16 nl_apply against
# nl_apply_flash_plain, the same function with the TPU kernel's rounding
# (nl_kernel.py:116-120), relative to the same attention term: both round
# the output to bf16 (2^-9 of a value), and the f32 exps and sums differ in
# implementation and order (expect ~1e-3).
NL_TOL = {"nl_minmax": {"f32": 1e-4, "bf16": 1e-4},
          "nl_apply": {"f32": 1e-4, "bf16": 5e-2}}
NL_ROUND_TOL = 1e-2
NL_KERNELS = {"nl_minmax": "nl_minmax_ws_kernel",
              "nl_apply": "nl_apply_ws_kernel"}


def _nl_inputs(torch, b, n, m, c, seed, dev, dtype):
    """q (b, n, c) and k (b, m, c), as the 'nl' spatial pooling of a (b, h,
    w, c) feature map gives them at n = h*w, m = (h//8)*(w//8), drawn apart:
    q uniform in [-1, 1), k uniform in [-1, 1) less its mean over the keys.
    Independent centred q and k make the normalised energies of a query
    span about half of [0, 1], and k's zero mean leaves only the attention
    term in the output, so a kernel that mixes up queries, keys or channels
    moves the whole of it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.rand((b, n, c), generator=g, device=dev) * 2 - 1
    k = torch.rand((b, m, c), generator=g, device=dev) * 2 - 1
    return q.to(dtype), (k - k.mean(1, keepdim=True)).to(dtype)


def _nl_values_plain(torch, q, k, v, lohi, block):
    """nl_apply_plain's function with separate values v: the control of a
    kernel that pairs the weights with the wrong keys."""
    out = torch.empty(v.shape[0], q.shape[1], v.shape[2], dtype=torch.float32,
                      device=q.device)
    for i in range(0, q.shape[1], block):
        e = torch.matmul(q[:, i:i + block].float(), k.float().transpose(1, 2))
        a = torch.softmax((e - lohi[0]) / (lohi[1] - lohi[0]), dim=-1)
        out[:, i:i + block] = torch.matmul(a.to(k.dtype).float(), v.float())
    return out


def _nl_rel(torch, name, got, want, scale, dt):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    return err, err / scale


# check_nl's cases: (dtype, batch, queries, keys, key, seed). The feature maps of
# Res2Fusion's attention (1224x1024: the res2fusion bench's nl call, bf16
# batch 2, and the test CLI's, f32 batch 1; 45x61; a ragged 20x50), then
# the edges of the bf16 kernels' tiling (64 keys a staged tile; 256 query
# rows a block in pass 1, 128 in pass 2): 3 full key tiles and a ragged
# one; full key tiles and a last block of one row; a last tile of one key
# and pass 1's last block half empty.
NL_CASES = [(dt, b, h * w, (h // 8) * (w // 8), f"{b}x{h}x{w}x112 {dt}",
             120 + h)
            for dt, b, h, w in (("bf16", RES2_BATCH, H, W), ("f32", 1, H, W),
                                ("bf16", 2, 45, 61), ("f32", 2, 45, 61),
                                ("bf16", 2, 20, 50), ("f32", 2, 20, 50))] + [
    ("bf16", b, n, m, f"{b}x{n}q{m}k bf16", 130 + i)
    for i, (b, n, m) in enumerate(((1, 1000, 3 * 64 + 17),
                                   (2, 3 * 256 + 1, 4 * 64),
                                   (1, 5 * 128, 2 * 64 + 1)))]


def check_nl(torch, F, dev, timer):
    """nl_minmax and nl_apply against the plain two-pass version
    (nl_spatial_plain's passes) on the card at NL_CASES, on _nl_inputs, at
    NL_TOL, and bf16 nl_apply against nl_apply_flash_plain (the TPU kernel's
    rounding) at NL_ROUND_TOL. Two controls a case must fail NL_TOL:
    nl_apply's plain function with the keys of the value product swapped
    within pairs (2j <-> 2j+1, as a misordered weight fragment would), and
    nl_minmax's with k's channels rolled by 8 (a misaddressed key
    fragment); a kernel that ignored q and weighted the keys uniformly
    would output mean(k) and miss by the whole attention term (1 in
    NL_TOL's units). Then the batch-global check (bf16 and f32, 2 images of
    1500 queries and 90 keys, image 1's queries scaled 3x so that lo and hi
    come from it): the kernels within NL_TOL of the global plain passes, and
    both passes reduced per image (image 0's own range) must miss. Times at
    the bench's shape, the key repack of the bf16 wrappers (pack_keys,
    inside the kernels' times) apart; nl_apply's library time is one
    scaled_dot_product_attention(q, k, k, scale=1/(hi-lo)), the same
    function since softmax is shift-invariant."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import (
        BLOCK, nl_apply, nl_apply_flash_plain, nl_apply_plain, nl_minmax,
        nl_minmax_plain, pack_keys)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                  "min_control_rel_err": float("inf"),
                  "tolerance_rel": NL_TOL[name], "layers": {}}
           for name in ("nl_minmax", "nl_apply")}
    rec["nl_apply"].update(rounding_rel_err=0.0,
                           rounding_tolerance_rel=NL_ROUND_TOL)

    def note(name, key, dt, err, rel, ctl):
        r, tol = rec[name], NL_TOL[name][dt]
        if rel > tol:
            raise AssertionError(f"{name} {key}: max abs err {err} is "
                                 f"{rel:.3g} of the scale, above {tol}")
        if ctl <= tol:
            raise AssertionError(f"{name} {key}: the control passes "
                                 f"({ctl:.3g} <= {tol}): the check cannot "
                                 f"tell a wrong kernel")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        r["min_control_rel_err"] = min(r["min_control_rel_err"], ctl)
        print(f"{name} {key}: err {rel:.3g}, control {ctl:.3g} "
              f"(tolerance {tol})")

    def check(dt, q, k, key):
        m = k.shape[1]
        lohi, want_lohi = nl_minmax(q, k), nl_minmax_plain(q, k)
        span = float(want_lohi[1] - want_lohi[0])
        ctl_lohi = nl_minmax_plain(q, torch.roll(k, 8, dims=2))
        note("nl_minmax", key, dt,
             *_nl_rel(torch, "nl_minmax", lohi, want_lohi, span, dt),
             float((ctl_lohi - want_lohi).abs().max()) / span)
        got, want = nl_apply(q, k, lohi), nl_apply_plain(q, k, want_lohi)
        scale = float((want.float() - k.float().mean(1, keepdim=True))
                      .abs().max())
        swap = torch.arange(m, device=dev) ^ 1
        swap[swap >= m] = m - 1
        ctl = _nl_values_plain(torch, q, k, k[:, swap], want_lohi, BLOCK)
        note("nl_apply", key, dt,
             *_nl_rel(torch, "nl_apply", got, want, scale, dt),
             float((ctl - want.float()).abs().max()) / scale)
        del ctl
        if dt == "bf16":
            flash = nl_apply_flash_plain(q, k, want_lohi)
            _, rel = _nl_rel(torch, "nl_apply", got, flash, scale, dt)
            _, rel_norm = _nl_rel(torch, "nl_apply", want, flash, scale, dt)
            if rel > NL_ROUND_TOL:
                raise AssertionError(f"nl_apply {key}: {rel:.3g} of the "
                                     f"scale from the TPU kernel's rounding,"
                                     f" above {NL_ROUND_TOL}")
            r = rec["nl_apply"]
            r["rounding_rel_err"] = max(r["rounding_rel_err"], rel)
            print(f"nl_apply {key}: rounding check err {rel:.3g} "
                  f"(tolerance {NL_ROUND_TOL}; nl_apply_plain's normalised "
                  f"rounding is {rel_norm:.3g} from it)")
        return lohi, want_lohi, want, scale

    for dt, b, n, m, key, seed in NL_CASES:
        q, k = _nl_inputs(torch, b, n, m, 112, seed, dev, dts[dt])
        lohi, _, want, scale = check(dt, q, k, key)
        stamp(f"nl {key} checked")
        if not (dt == "bf16" and n == H * W):
            continue
        esz = 2
        scores = 2.0 * b * n * m * 112
        bound, by = _bound((b * n * 112 + b * m * 112) * esz + 8, scores, dt)
        pack_ms = timer(lambda: pack_keys(k))
        rec["nl_minmax"]["layers"][key] = {
            "ms": timer(lambda: nl_minmax(q, k)),
            "plain_ms": timer(lambda: nl_minmax_plain(q, k)),
            "pack_ms": pack_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} {dt}"}
        q4, k4 = q[:, None], k[:, None]
        sdpa_scale = float(1.0 / (lohi[1] - lohi[0]))

        def library():
            return F.scaled_dot_product_attention(q4, k4, k4,
                                                  scale=sdpa_scale)
        lib_err = float((library()[:, 0].float() - want.float()).abs().max())
        bound, by = _bound((2 * b * n * 112 + b * m * 112) * esz, 2 * scores,
                           dt)
        rec["nl_apply"]["layers"][key] = {
            "ms": timer(lambda: nl_apply(q, k, lohi)),
            "plain_ms": timer(lambda: nl_apply_plain(q, k, lohi)),
            "pack_ms": pack_ms,
            "library_ms": timer(library),
            "library_rel_err": lib_err / scale,
            "bound_ms": bound, "bound_by": by,
            "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} {dt}"}
        del q4, k4, library
        stamp(f"nl {key} timed")
    del q, k, want
    for dt in ("bf16", "f32"):
        key = f"2x1500q90k {dt}, image 1 x3"
        q, k = _nl_inputs(torch, 2, 1500, 90, 112, 77, dev, dts[dt])
        q[1] *= 3
        _, want_lohi, want, scale = check(dt, q, k, key)
        own = nl_minmax_plain(q[:1], k[:1])
        ctl = {"nl_minmax": float((own - want_lohi).abs().max())
               / float(want_lohi[1] - want_lohi[0]),
               "nl_apply": _nl_rel(torch, "nl_apply",
                                   nl_apply_plain(q[:1], k[:1], own),
                                   want[:1], scale, dt)[1]}
        for name, c in ctl.items():
            if c <= NL_TOL[name][dt]:
                raise AssertionError(f"{name} {key}: the per-image control "
                                     f"passes ({c:.3g})")
            r = rec[name]
            r["batch_global_control_rel_err"] = min(
                r.get("batch_global_control_rel_err", float("inf")), c)
            print(f"{name} {key}: per-image control {c:.3g} "
                  f"(tolerance {NL_TOL[name][dt]})")
    torch.cuda.empty_cache()
    return rec


# Res2Fusion's depthwise convs, all 12 of a forward: (name, hexp channels,
# group width, k, window base, with the add of the previous group's output)
DW_LAYERS = ([("RB1.dw0", 64, 16, 1, 0, False)]
             + [(f"RB1.dw{i}", 64, 16, 3, 16 * i, i > 1) for i in (1, 2, 3)]
             + [("RB2.dw0", 384, 48, 1, 0, False)]
             + [(f"RB2.dw{i}", 384, 48, 3, 48 * i, i > 1) for i in range(1, 8)])


def _dw_raw(torch, x, wt, lo, add):
    """A zero-argument raw launch of conv_dw's C entry (taps packed, output
    allocated here once): the kernel without the wrapper's host work."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        DTYPE_CODES
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
        ARGTYPES, pack_taps)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.window import \
        window_entry
    fn = window_entry("mmif_conv_dw", ARGTYPES)
    b, h, w, cx = x.shape
    c, k = wt.shape[0], wt.shape[-1]
    wk, _ = pack_taps(wt)
    y = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    args = (DTYPE_CODES[x.dtype], x.data_ptr(), cx, lo,
            None if add is None else add.data_ptr(), c, wk.data_ptr(), None,
            y.data_ptr(), b, h, w, c, k, 0)

    def launch(wk=wk, y=y):   # keeps both alive
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"conv_dw: raw launch failed with error {err}")
        return y
    return launch


def _host_us(torch, fn, calls=50):
    """Host time of a call (no synchronisation inside the calls)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def check_conv_dw(torch, F, dev, timer):
    """conv_dw against F.conv2d(groups=C) in f32 on the window (its plain
    version) at all 12 of Res2Fusion's depthwise layers, with and without
    the add: 1224x1024 bf16 batch 4 (the res2fusion bench's two pairs) and
    f32 batch 2 (the test CLI's pair), and 45x61 in both dtypes. Controls at
    the two full sizes must miss by more than TOL: the plain output of the
    window shifted by 8 channels and, at k3, of a zero halo. Times at both
    full sizes: the wrapper call, the raw launch (the C entry on an output
    allocated beforehand) and the wrapper's host time a call; the library
    time is one F.conv2d(groups=C) on the reflect-padded window in the same
    dtype (the window's copy, the add and the pad timed apart)."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
        conv_dw, conv_dw_plain)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0,
         "min_control_rel_err": float("inf"), "tolerance_rel": TOL,
         "layers": {}}
    for dt, b, h, w in (("bf16", 2 * RES2_BATCH, H, W), ("f32", 2, H, W),
                        ("bf16", 2, 45, 61), ("f32", 2, 45, 61)):
        dtype = dts[dt]
        hexp = {cx: _rand(torch, (b, h, w, cx), 130 + cx, dev, dtype,
                          scale=6.0) for cx in (64, 384)}
        for name, cx, c, k, lo, with_add in DW_LAYERS:
            x = hexp[cx]
            wt = _rand(torch, (c, 1, k, k), 140 + k + c + lo, dev,
                       torch.float32, lo=-0.5, scale=2.0 / k).to(dtype)
            add = (_rand(torch, (b, h, w, c), 150 + c + lo, dev, dtype,
                         scale=3.0) if with_add else None)
            got = conv_dw(x, wt, None, None, lo, add)
            err, rel = _err(torch, got, conv_dw_plain(x, wt, None, None, lo,
                                                      add), dt)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            if h != H:
                continue
            scale = max(float(got.float().abs().max()), 1.0)
            shifted = lo + 8 if lo + 8 + c <= cx else lo - 8
            ctl = [conv_dw_plain(x, wt, None, None, shifted, add)]
            if k > 1:
                xin = x[..., lo:lo + c].float()
                if add is not None:
                    xin = xin + add.float()
                ctl.append(F.conv2d(F.pad(xin.permute(0, 3, 1, 2),
                                          (1, 1, 1, 1)), wt.float(),
                                    groups=c).permute(0, 2, 3, 1).to(dtype))
                del xin
            for want in ctl:
                miss = float((got.float() - want.float()).abs().max()) / scale
                if miss <= TOL[dt]:
                    raise AssertionError(f"conv_dw {name} {dt}: a control "
                                         f"passes ({miss:.3g})")
                r["min_control_rel_err"] = min(r["min_control_rel_err"], miss)
            del got, ctl

            def window():
                xw = x[..., lo:lo + c]
                return (xw if add is None else xw + add).permute(0, 3, 1, 2)
            xn = window()
            p = k // 2
            parts, xp = _library_parts(F, xn, k, c)
            reads = 2 if with_add else 1
            esize = 2 if dt == "bf16" else 4
            bound, by = _bound(
                (reads + 1) * b * h * w * c * esize + wt.numel() * 4,
                2.0 * b * h * w * c * k * k, dt)
            wrap = lambda: conv_dw(x, wt, None, None, lo, add)
            r["layers"][f"{name} {dt}"] = {
                "ms": timer(wrap),
                "raw_ms": timer(_dw_raw(torch, x, wt, lo, add)),
                "wrapper_host_us": _host_us(torch, wrap),
                "plain_ms": timer(
                    lambda: conv_dw_plain(x, wt, None, None, lo, add)),
                "library_ms": timer(lambda: [F.conv2d(t, wt, groups=c)
                                             for t in xp]),
                "library_window_ms": timer(window),
                "library_pad_ms": timer(lambda: [
                    F.pad(xn[sl], (p, p, p, p), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                "bound_ms": bound, "bound_by": by,
                "shape": f"{b}x{h}x{w}x{cx}[{lo}:{lo + c}]"
                         f"{' + add' if with_add else ''} k{k} {dt}"}
            del xn, xp
        del hexp, x, add
        torch.cuda.empty_cache()
        stamp(f"conv_dw {b}x{h}x{w} {dt} checked")
    return r


# MyFusion's conv_dw shapes in a default bf16 bench forward: (key, channels
# of the input tensor, channels convolved, window base, k, act, scale,
# images a pair): level 1's k1 down, the SepConvBlocks' dw at levels 1 and
# 4, the DCBlocks' hidden widths 24 and 40 (DB1_1, DB1_3); then
# MixConvBlock's four windows (k1, k3, k5, k7, each C channels of its 4C
# expansion, read in place) at level 1 (16 of 64 channels) and level 4
# (128 of 512), 32 images: the MixFormer's shapes where a level is shared
MYF_DW = [("myfusion.down1_1.dw", 8, 8, 0, 1, "relu6", 0, 2),
          ("myfusion.EB1_1.dwconv", 64, 64, 0, 3, None, 0, 2),
          ("myfusion.EB4_1.dwconv", 512, 512, 0, 3, None, 3, 2),
          ("myfusion.DB1_1.dw", 24, 24, 0, 3, "relu6", 0, 1),
          ("myfusion.DB1_3.dw", 40, 40, 0, 3, "relu6", 0, 1)]
MYF_DW += [(f"mixformer.EB{lv}.dwconvs.{i}", 4 * c, c, i * c, 2 * i + 1, None,
            scale, 2) for lv, c, scale in ((1, 16, 0), (4, 128, 3))
           for i in range(4)]
# its strided depthwise downs (TransitionBlock, k2 stride 2 VALID, relu6):
# (key, channels, scale of the input), 32 images
MYF_DOWNS = [("down2_1.dw", 16, 0), ("down3_1.dw", 32, 1),
             ("down4_1.dw", 64, 2)]


def check_myfusion(torch, F, dev, timer, rec):
    """MyFusion's conv_dw shapes (MYF_DW, MixConvBlock's k5 and k7 windows
    among them) against the plain version, bf16 at the bench's 16 pairs
    and f32 at the test CLI's pair (TOL of max(|y|, 1)), with a control
    that must miss by more than TOL at the bench's shape (k3, k5, k7: a
    zero halo; k1: the taps' channels reversed), timed in bf16 beside the
    plain version and one F.conv2d(groups=C) on the reflect-padded window
    (the pad timed apart); the records join rec's conv_dw layers. Then
    its three strided depthwise downs as the port runs them (F.conv2d(groups=C, stride=2) on the channels-last view,
    bias-free, then relu6; no Pallas kernel in the JAX package, XLA's
    grouped conv), each against the same conv in f32 and timed beside its
    bound. Returns the downs' record."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import (
        conv_dw, conv_dw_plain)
    from multi_modal_image_fusion_tpu_torch.ops.layers import ConvLayer
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = rec["conv_dw"]
    for key, cx, c, lo, k, act, scale, per_pair in MYF_DW:
        h, w = _S[scale]
        for dt, n in (("bf16", BATCH), ("f32", 1)):
            dtype, b = dts[dt], n * per_pair
            x = _rand(torch, (b, h, w, cx), 180 + cx + lo, dev, dtype,
                      lo=-0.5, scale=4.0)
            wt = _rand(torch, (c, 1, k, k), 181 + c, dev, torch.float32,
                       lo=-0.5, scale=2.0 / k).to(dtype)
            bias = _rand(torch, (c,), 182 + c, dev, torch.float32, lo=-0.5,
                         scale=0.2)

            def run(wt=wt):
                return conv_dw(x, wt, bias, act, lo)

            def plain():
                return conv_dw_plain(x, wt, bias, act, lo)
            want = plain()
            err, rel = _err(torch, run(), want, dt)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            if k > 1:
                ctl = apply_act(F.conv2d(
                    x[..., lo:lo + c].float().permute(0, 3, 1, 2),
                    wt.float(), bias, padding=k // 2, groups=c),
                    act).permute(0, 2, 3, 1)
                what = "zero halo"
            else:
                ctl, what = run(wt.flip(0)), "channels reversed"
            scale_y = max(float(want.float().abs().max()), 1.0)
            miss = float((ctl.float() - want.float()).abs().max()) / scale_y
            if miss <= TOL[dt]:
                raise AssertionError(f"conv_dw {key} {dt}: the control "
                                     f"({what}) passes ({miss:.3g})")
            r["min_control_rel_err"] = min(r["min_control_rel_err"], miss)
            del want, ctl
            if dt == "bf16":
                # a window of a wider tensor: the library convolves its
                # contiguous copy (timed apart), as torch's reflect pad
                # indexes the view's whole extent with 32 bits
                xw = x[..., lo:lo + c]
                window_ms = (timer(lambda: xw.contiguous()) if cx != c
                             else 0.0)
                xn = xw.contiguous().permute(0, 3, 1, 2)
                parts, xp = _library_parts(F, xn, k, c)
                p = k // 2
                bb = bias.to(dtype)
                bound, by = _bound(2 * b * h * w * c * 2 + wt.numel() * 2,
                                   2.0 * b * h * w * c * k * k, dt)
                r["layers"][f"{key} {dt}"] = {
                    "ms": timer(run), "plain_ms": timer(plain),
                    "library_ms": timer(lambda: [
                        F.conv2d(t, wt, bb, groups=c) for t in xp]),
                    "library_pad_ms": timer(lambda: [
                        F.pad(xn[sl], (p, p, p, p), mode="reflect")
                        for sl in parts]),
                    "library_calls": len(parts),
                    "library_window_ms": window_ms,
                    "host_us": _host_us(torch, run),
                    "bound_ms": bound, "bound_by": by,
                    "shape": f"{b}x{h}x{w}x{cx}[{lo}:{lo + c}] k{k} {act} "
                             f"{dt}"}
                del xn, xp, xw
            del x
            torch.cuda.empty_cache()
        stamp(f"conv_dw {key} checked")

    downs = {}
    for key, c, scale in MYF_DOWNS:
        h, w = _S[scale]
        b = 2 * BATCH
        layer = ConvLayer(c, c, 2, act="relu6", groups=c, use_bias=False,
                          stride=2, padding=0).to(dev)
        x = _rand(torch, (b, h, w, c), 185 + c, dev, torch.bfloat16,
                  scale=6.0)
        lb = layer.to(torch.bfloat16)
        with torch.no_grad():
            y = lb(x)
            want = torch.clamp(F.conv2d(
                x[:2].float().permute(0, 3, 1, 2), lb.weight.float(),
                stride=2, groups=c), 0.0, 6.0).permute(0, 2, 3, 1)
            err, rel = _wide_rel(torch, y[:2], want, "bf16")
            if rel > CHAIN_TOL["bf16"]:
                raise AssertionError(f"myfusion {key}: {rel:.3g} of the f32 "
                                     f"conv")
            ho, wo = y.shape[1:3]
            bound, by = _bound((b * h * w * c + b * ho * wo * c) * 2
                               + lb.weight.numel() * 2,
                               2.0 * b * ho * wo * c * 4, "bf16")
            downs[key] = {"library_ms": timer(lambda: lb(x)),
                          "max_rel_err_vs_f32": rel, "bound_ms": bound,
                          "bound_by": by,
                          "shape": f"{b}x{h}x{w}x{c} -> {b}x{ho}x{wo}x{c} "
                                   f"k2 s2 VALID depthwise + relu6 bf16"}
        del x, y, want, layer, lb
        torch.cuda.empty_cache()
    print(f"myfusion strided downs (cuDNN): {json.dumps(downs)}")
    return downs


# the transformer's attention at level 3 (306x256, 64 channels: 4 heads of
# 16, keys pooled by sr 4 to 76x64): (images, dtype), one image each, as
# the plain route's f32 score matrices take 6.1 GB an image and head
SDPA_CASES = [(1, "bf16"), (1, "f32")]
SDPA_TOL = {"bf16": 2e-2, "f32": 1e-4}
# exponentials a second: 132 SMs x 16 special-function lanes a clock at the
# SXM part's 1.98 GHz boost clock (an assumed peak, not a data-sheet rate)
PEAK_EXP_S = 132 * 16 * 1.98e9


def check_sdpa(torch, F, dev, timer):
    """The Attention's library call (ops/blocks.attention: torch's
    scaled_dot_product_attention under its flash and memory-efficient
    backends, a library call in place of the JAX package's XLA einsums)
    against its plain version (the einsum, softmax and einsum in f32) at
    MyFusion's level-3 shape, bf16 (flash) and f32 (memory-efficient), on
    centred values and queries scaled so that the attention is sharp (a
    near-uniform one would pass a wrong kernel), within SDPA_TOL of the
    plain output's largest magnitude; a control (k's channels rolled by
    one head) must miss by 10x. Timed beside the plain version and its
    bound: the largest of its bytes, its products at the dtype's peak and
    its exponentials at PEAK_EXP_S. A float64 input, which neither backend
    takes, must raise (no math-backend fallback)."""
    from multi_modal_image_fusion_tpu_torch.ops.blocks import (
        attention, attention_plain)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    h, w = _S[2]
    c, heads, sr = 64, 4, 4
    n, m = h * w, (h // sr) * (w // sr)
    rec = {"max_rel_err": 0.0, "min_control_rel_err": float("inf"),
           "tolerance_rel": SDPA_TOL, "layers": {}}
    for b, dt in SDPA_CASES:
        dtype = dts[dt]
        q = _rand(torch, (b, n, c), 190, dev, dtype, lo=-0.5, scale=16.0)
        k = _rand(torch, (b, m, c), 191, dev, dtype, lo=-0.5, scale=2.0)
        v = _rand(torch, (b, m, c), 192, dev, dtype, lo=-0.5, scale=2.0)
        with torch.no_grad():
            got = attention(q, k, v, heads)
            want = attention_plain(q, k, v, heads)
            scale = float(want.float().abs().max())
            rel = float((got.float() - want.float()).abs().max()) / scale
            ctl = attention(q, k.roll(16, dims=-1), v, heads)
            miss = float((ctl.float() - want.float()).abs().max()) / scale
        del got, ctl
        if rel > SDPA_TOL[dt] or miss <= 10 * SDPA_TOL[dt]:
            raise AssertionError(f"sdpa {dt}: {rel:.3g} of max|y| (control "
                                 f"{miss:.3g}), tolerance {SDPA_TOL[dt]}")
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        rec["min_control_rel_err"] = min(rec["min_control_rel_err"], miss)
        esize = 2 if dt == "bf16" else 4
        exps = b * heads * n * m
        times = {"bytes": (2 * b * n * c + 2 * b * m * c) * esize
                 / PEAK_BYTES_S * 1e3,
                 "operations": 4.0 * exps * (c // heads) / PEAK_FLOPS[dt]
                 * 1e3,
                 "exponentials": exps / PEAK_EXP_S * 1e3}
        by = max(times, key=times.get)
        rec["layers"][f"level3 {dt}"] = {
            "ms": timer(lambda: attention(q, k, v, heads)),
            "plain_ms": timer(lambda: attention_plain(q, k, v, heads),
                              reps=1),
            "bound_ms": times[by], "bound_by": by,
            "exponentials": exps, "rel_err": rel, "control_rel_err": miss,
            "shape": f"q {b}x{n}x{c}, k/v {b}x{m}x{c}, {heads} heads {dt}"}
        del q, k, v, want
        torch.cuda.empty_cache()
    x = torch.rand((1, 64, 16), device=dev, dtype=torch.float64)
    try:
        attention(x, x, x, 1)
    except RuntimeError:
        rec["float64_refused"] = True
    else:
        raise AssertionError("sdpa: a float64 input ran (math backend)")
    print(f"sdpa: {json.dumps(rec)}")
    return rec


WIDE_REPLACES = ("multi_modal_image_fusion_tpu/ops/pallas/conv_kernel.py:719 "
                 "(conv_tlane_chain; pallas_call :799)")
# conv_wide tolerances, relative to max|y| of the plain version on the same
# inputs (bf16 weights and inputs in bf16): f32 1e-4; bf16 1e-3 beyond one
# bf16 ulp of each output (both round an f32 sum to bf16; a sum taken in
# another order can land on the neighbouring value, 2^-7 of it). Each check
# at WIDE_CHECKS has controls that must miss by 10x: the kernel with the
# kh/kw taps transposed, and with two legs of one width swapped.
WIDE_TOL = {"f32": 1e-4, "bf16": 1e-3}
# (name, legs' channels, c_out, k, fuse_n, images out, h, w)
WIDE_CHECKS = [("DB3_1.conv1", [256, 1024], 640, 3, 0, 2, 306, 256),
               ("DB1_3.conv1", [16, 16, 16, 64], 56, 3, 0, 2, H, W),
               ("odd", [40, 24, 40], 40, 3, 0, 2, 45, 61),
               ("dbnet.dec0", [16, 16, 16, 16, 64], 64, 3, 2, 2, H, W),
               # NestFuse's c_out 8 and 56 (CB1_0, CB3_0 over the siamese
               # fold's 32 images) and 2-leg DB1_1 conv1 (16 pairs);
               # MAFusion's 4-leg DB1 conv1 at its bench's 4 pairs
               ("nestfuse.CB1_0.conv1", [16], 8, 3, 0, 32, H, W),
               ("nestfuse.CB3_0.conv1", [112], 56, 3, 0, 32, 306, 256),
               ("nestfuse.DB1_1.conv1", [64, 112], 88, 3, 0, 16, H, W),
               ("mafusion.DB1.conv1", [64, 128, 256, 512], 480, 3, 0, 4, H,
                W),
               # MyFusion's DB1_1 pw1: k1 over two legs to 24 (16 pairs)
               ("myfusion.DB1_1.pw1", [16, 32], 24, 1, 0, 16, H, W)]
# every conv_wide launch of one fused forward: (name, legs' channels, c_out,
# k, fuse (the siamese sum of the two halves), scale, images per pair).
# UNFusion's ECB k1 convs run on the siamese fold's 2 images a pair.
_S = [(H, W)]
for _ in range(3):
    _S.append(((_S[-1][0] + 1) // 2, (_S[-1][1] + 1) // 2))
WIDE_LAYERS = [
    ("unfusion.EB2_1.conv1", [32, 16], 24, 1, 0, 1, 2),
    ("unfusion.EB3_1.conv1", [48, 32], 40, 1, 0, 2, 2),
    ("unfusion.EB4_1.conv1", [64, 48], 56, 1, 0, 3, 2),
    ("unfusion.EB3_2.conv1", [48, 96, 64], 104, 1, 0, 2, 2),
    ("unfusion.EB4_2.conv1", [64, 128, 96], 144, 1, 0, 3, 2),
    ("unfusion.EB4_3.conv1", [64, 128, 304, 256], 376, 1, 0, 3, 2),
    ("unfusion.DB1_1.conv1", [16, 64], 40, 3, 0, 0, 1),
    ("unfusion.DB1_1.conv2", [40], 16, 3, 0, 0, 1),
    ("unfusion.DB2_1.conv1", [64, 256], 160, 3, 0, 1, 1),
    ("unfusion.DB2_1.conv2", [160], 64, 3, 0, 1, 1),
    ("unfusion.DB3_1.conv1", [256, 1024], 640, 3, 0, 2, 1),
    ("unfusion.DB3_1.conv2", [640], 256, 3, 0, 2, 1),
    ("unfusion.DB1_2.conv1", [16, 16, 64], 48, 3, 0, 0, 1),
    ("unfusion.DB1_2.conv2", [48], 16, 3, 0, 0, 1),
    ("unfusion.DB2_2.conv1", [64, 64, 256], 192, 3, 0, 1, 1),
    ("unfusion.DB2_2.conv2", [192], 64, 3, 0, 1, 1),
    ("unfusion.DB1_3.conv1", [16, 16, 16, 64], 56, 3, 0, 0, 1),
    ("unfusion.DB1_3.conv2", [56], 16, 3, 0, 0, 1),
    ("dbnet.dec0", [16, 16, 16, 16, 64], 64, 3, 1, 0, 1),
    ("dbnet.dec1", [64], 32, 3, 0, 0, 1),
    ("dbnet.dec2", [32], 16, 3, 0, 0, 1),
    # NestFuse: the convs whose output width is 8 mod 16 (nest_block)
    ("nestfuse.CB1_0.conv1", [16], 8, 3, 0, 0, 2),
    ("nestfuse.CB3_0.conv1", [112], 56, 3, 0, 2, 2),
    ("nestfuse.DB1_1.conv1", [64, 112], 88, 3, 0, 0, 1),
    ("nestfuse.DB2_1.conv1", [112, 160], 136, 3, 0, 1, 1),
    ("nestfuse.DB3_1.conv1", [160, 208], 184, 3, 0, 2, 1),
    ("nestfuse.DB1_2.conv1", [64, 64, 112], 120, 3, 0, 0, 1),
    ("nestfuse.DB1_3.conv1", [64, 64, 64, 112], 152, 3, 0, 0, 1),
    # MAFusion: every ConvBlock conv (wide_block), at its bench's pairs
    ("mafusion.CB1_0.conv1", [16], 8, 3, 0, 0, 2),
    ("mafusion.CB1_0.conv2", [8], 64, 1, 0, 0, 2),
    ("mafusion.CB2_0.conv1", [64], 32, 3, 0, 1, 2),
    ("mafusion.CB2_0.conv2", [32], 128, 1, 0, 1, 2),
    ("mafusion.CB3_0.conv1", [128], 64, 3, 0, 2, 2),
    ("mafusion.CB3_0.conv2", [64], 256, 1, 0, 2, 2),
    ("mafusion.CB4_0.conv1", [256], 128, 3, 0, 3, 2),
    ("mafusion.CB4_0.conv2", [128], 512, 1, 0, 3, 2),
    ("mafusion.DB3.conv1", [64, 128, 256, 512], 480, 3, 0, 2, 1),
    ("mafusion.DB3.conv2", [480], 256, 1, 0, 2, 1),
    ("mafusion.DB2.conv1", [64, 128, 256, 512], 480, 3, 0, 1, 1),
    ("mafusion.DB2.conv2", [480], 128, 1, 0, 1, 1),
    ("mafusion.DB1.conv1", [64, 128, 256, 512], 480, 3, 0, 0, 1),
    ("mafusion.DB1.conv2", [480], 64, 1, 0, 0, 1),
    # MyFusion: the DCBlocks' pw1 whose hidden width is 8 mod 16
    ("myfusion.DB1_1.pw1", [16, 32], 24, 1, 0, 0, 1),
    ("myfusion.DB1_3.pw1", [16, 16, 16, 32], 40, 1, 0, 0, 1),
]
# bf16 pairs of a model's timed layers where its bench runs another batch
WIDE_BENCH_PAIRS = {"mafusion": MAFUSION_BATCH}


def _wide_rel(torch, got, want, dt):
    """max |got - want| relative to max|want|; in bf16 beyond one bf16 ulp of
    each output. Taken in batch chunks of at most 2^28 elements: the f32
    temporaries of a whole 16-pair output (NestFuse's DB1_3 conv1 writes
    3.0e9 elements) would not fit beside its inputs."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    step = max(1, 2 ** 28 // max(1, got[:1].numel()))
    err, scale = 0.0, 0.0
    for i in range(0, got.shape[0], step):
        g, w = got[i:i + step].float(), want[i:i + step].float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite kernel output")
        d = (g - w).abs()
        if dt == "bf16":
            d = (d - torch.exp2(torch.floor(torch.log2(
                w.abs().clamp(min=1e-30))) - 7)).clamp(min=0)
        err = max(err, float(d.max()))
        scale = max(scale, float(w.abs().max()))
    return err, err / scale


def _tc_block(cout, cins, k, dt, fuse_n=0):
    """The bf16 wgmma body's N block for a layer, whether its weights stay
    resident and whether a fuse_n pair is summed in shared memory
    (conv_chain.py pick_bn_tc and tc_plan, as the launch picks them);
    nothing in f32."""
    if dt != "bf16":
        return {}
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        pick_bn_tc, tc_plan)
    bn = pick_bn_tc(cout, cins, k, fuse_n)
    plan = tc_plan(k, bn, sum(-(-c // 16) for c in cins), fuse_n)
    return {"bn": bn, "resident": bool(plan[0]), "pair": bool(plan[3])}


def check_conv_wide(torch, F, dev, timer):
    """conv_wide against its plain version (the legs' concat, reflect pad,
    F.conv2d in f32, TF32 off) on centred independent inputs: at
    WIDE_CHECKS with the controls, and at every launch of a UNFusion, a
    DBNet, a NestFuse and a MAFusion forward (WIDE_LAYERS) at 1224x1024,
    bf16 at the bench's pairs (16; MAFusion 4) and f32 at the test CLI's
    one pair, with times: the kernel, the plain
    version, and one F.conv2d on the padded concat in the same dtype (the
    concat and the pad timed apart); in bf16 the wgmma body's N block and
    whether its weights stay resident (tc_plan) beside each layer."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import \
        concat_legs
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_plain)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0,
         "min_control_rel_err": float("inf"), "tolerance_rel": WIDE_TOL,
         "layers": {}}

    def inputs(cins, cout, k, b, h, w, dt, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        legs = [((torch.rand((b, h, w, c), generator=g, device=dev) * 2 - 1)
                 .to(dts[dt]), 0) for c in cins]
        cin = sum(cins)
        wt = ((torch.rand((cout, cin, k, k), generator=g, device=dev) * 2 - 1)
              / np.sqrt(cin * k * k)).to(dts[dt])
        bias = (torch.rand((cout,), generator=g, device=dev) * 2 - 1) * 0.1
        return legs, wt, bias

    def check(key, got, want, dt):
        err, rel = _wide_rel(torch, got, want, dt)
        if rel > WIDE_TOL[dt]:
            raise AssertionError(f"conv_wide {key}: max err {err} is "
                                 f"{rel:.3g} of max|y|, above {WIDE_TOL[dt]}")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        return rel

    for name, cins, cout, k, fuse_n, n, h, w in WIDE_CHECKS:
        for dt in ("f32", "bf16"):
            key = f"{name} {dt}"
            legs, wt, bias = inputs(cins, cout, k, 2 * n if fuse_n else n,
                                    h, w, dt, 160 + len(cins))
            want = conv_wide_plain(legs, wt, bias, "relu", fuse_n)
            rel = check(key, conv_wide(legs, wt, bias, "relu", fuse_n), want,
                        dt)
            same = [(i, j) for i in range(len(cins))
                    for j in range(i + 1, len(cins)) if cins[i] == cins[j]]
            # a k1 conv has one tap: its input channels reversed instead
            ctls = ({"taps transposed": conv_wide(legs, wt.transpose(2, 3),
                                                  bias, "relu", fuse_n)}
                    if k > 1 else
                    {"input channels reversed": conv_wide(
                        legs, wt.flip(1), bias, "relu", fuse_n)})
            if same:
                i, j = same[0]
                sw = list(legs)
                sw[i], sw[j] = legs[j], legs[i]
                ctls[f"legs {i} and {j} swapped"] = conv_wide(
                    sw, wt, bias, "relu", fuse_n)
            for what, y in ctls.items():
                c = _wide_rel(torch, y, want, dt)[1]
                if c <= 10 * WIDE_TOL[dt]:
                    raise AssertionError(f"conv_wide {key}: the control "
                                         f"({what}) misses by {c:.3g} only")
                r["min_control_rel_err"] = min(r["min_control_rel_err"], c)
                print(f"conv_wide {key}: err {rel:.3g}, control ({what}) "
                      f"{c:.3g} (tolerance {WIDE_TOL[dt]})")
            del legs, want, ctls
        torch.cuda.empty_cache()
        stamp(f"conv_wide {name} checked")

    # which kernel a bf16 conv_wide launches: conv_chain's wgmma body
    legs, wt, bias = inputs([40, 24], 48, 3, 2, 45, 61, "bf16", 165)
    conv_wide(legs, wt, bias, "relu")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        conv_wide(legs, wt, bias, "relu")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "conv_" in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA]
    if len(names) != 1 or "conv_chain_tc_kernel" not in names[0]:
        raise AssertionError(f"bf16 conv_wide launched {names}, want one "
                             f"conv_chain_tc_kernel")
    r["bf16_kernel"] = names[0]
    print(f"bf16 conv_wide launches {names[0]}")

    for dt, pairs in (("bf16", BATCH), ("f32", 1)):
        for name, cins, cout, k, fuse, s, per_pair in WIDE_LAYERS:
            h, w = _S[s]
            if dt == "bf16":
                pairs = WIDE_BENCH_PAIRS.get(name.split(".")[0], BATCH)
            n = pairs * per_pair
            fuse_n = n if fuse else 0      # the siamese halves, n apart
            legs, wt, bias = inputs(cins, cout, k, 2 * n if fuse else n,
                                    h, w, dt, 170 + cout)

            def run():
                return conv_wide(legs, wt, bias, "relu", fuse_n)

            def plain():
                return conv_wide_plain(legs, wt, bias, "relu", fuse_n)
            check(f"{name} {dt}", run(), plain(), dt)

            def cat():
                x = concat_legs(legs, fuse_n, n)
                return (x[:n] + x[n:] if fuse_n else x).permute(0, 3, 1, 2)
            xn = cat()
            p = k // 2
            parts, xp = _library_parts(F, xn, k, cout)
            bl = bias.to(dts[dt])
            esz = 2 if dt == "bf16" else 4
            read = sum(cins) * (2 if fuse_n else 1)
            bound, by = _bound((read + cout) * n * h * w * esz
                               + wt.numel() * esz,
                               2.0 * n * h * w * sum(cins) * cout * k * k, dt)
            r["layers"][f"{name} {dt}"] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: [F.conv2d(t, wt, bl)
                                             for t in xp]),
                "library_concat_ms": timer(cat),
                "library_pad_ms": timer(lambda: [
                    F.pad(xn[sl], (p, p, p, p), mode="reflect")
                    for sl in parts]),
                "library_calls": len(parts),
                "bound_ms": bound, "bound_by": by,
                **_tc_block(cout, cins, k, dt, fuse_n),
                "shape": f"legs {cins} fuse_n {fuse_n} -> {n}x{h}x{w}x{cout}"
                         f" k{k} {dt}"}
            del legs, xn, xp, run, plain, cat
            torch.cuda.empty_cache()
        stamp(f"conv_wide {dt} layers timed")
    return r


# launches of one fused forward on the serving path, per model
FORWARD_LAUNCHES = {
    "densefuse": {"conv_gray_enter": 1, "conv_multi": 4, "conv_chain": 2,
                  "conv_gray_exit": 1},
    "densefuse_l1": {"conv_gray_enter": 1, "conv_multi": 3, "conv_chain": 3,
                     "conv_gray_exit": 1},
    "vifnet": {"conv_gray_enter": 1, "conv_multi": 4, "conv_chain": 3,
               "conv_gray_exit": 1},
    # conv_chain: RB1 shortcut and pwconv1 (k1, one tensor), dec0-dec2;
    # conv_multi: RB1 pwconv2 (4 legs), RB2 shortcut and pwconv1 (legs x16,
    # r1), RB2 pwconv2 (8 legs); conv_dw: 4 + 8 group convs; nl: one
    # spatial pooling per modality
    "res2fusion": {"conv_gray_enter": 1, "conv_chain": 5, "conv_multi": 4,
                   "conv_dw": 12, "nl_minmax": 2, "nl_apply": 2,
                   "conv_gray_exit": 1},
    # conv_chain: detail0; conv_multi: the dense growth; conv_wide: dec0
    # (fuse_n over the 5 legs) to dec2; the stride-2 convs are F.conv2d
    "dbnet": {"conv_gray_enter": 1, "conv_chain": 1, "conv_multi": 3,
              "conv_wide": 3, "conv_gray_exit": 1},
    # conv_chain: CB2_0-CB4_0 and the 6 ECBs' k3 convs; conv_wide: the 6
    # ECBs' k1 convs and the nested decoder's 12 k3 convs; conv_gray_exit:
    # conv_out (k1)
    "unfusion": {"conv_gray_enter": 1, "conv_chain": 9, "conv_wide": 18,
                 "conv_gray_exit": 1},
    # conv_gray_enter: conv_in (k1); conv_chain: CB2_0 and CB4_0 conv1, the
    # four encoder conv2 and the six decoder conv2; conv_wide: the convs
    # whose output width is 8 mod 16 (CB1_0 and CB3_0 conv1, the first
    # conv of DB1_1, DB2_1, DB3_1, DB1_2, DB1_3); conv_multi: DB2_2 conv1
    "nestfuse": {"conv_gray_enter": 1, "conv_chain": 12, "conv_wide": 7,
                 "conv_multi": 1, "conv_gray_exit": 1},
    # NestFuse's, and an RFN a scale: res and fuse1 on conv_multi, conv1,
    # conv2, fuse2 and fuse3 on conv_chain
    "rfnnest": {"conv_gray_enter": 1, "conv_chain": 28, "conv_wide": 7,
                "conv_multi": 9, "conv_gray_exit": 1},
    # every ConvBlock conv on conv_wide (4 encoder blocks, DB3, DB2, DB1)
    "mafusion": {"conv_gray_enter": 1, "conv_wide": 14, "conv_gray_exit": 1},
    # PFNetv1: two unshared encoders (1 enter, 3 conv_multi each), the 8-leg
    # decode0, decode1-3 conv_chain, decode4 the exit
    "pfnetv1": {"conv_gray_enter": 2, "conv_multi": 7, "conv_chain": 3,
                "conv_gray_exit": 1},
    # the dense growth and the block-diagonal fuse0 (8 legs) conv_multi;
    # fuse1, fuse2 and decode0-2 conv_chain
    "pfnetv2": {"conv_gray_enter": 1, "conv_multi": 4, "conv_chain": 5,
                "conv_gray_exit": 1},
    # the k7 enter over both images, enc1 and dec0 (batch norms folded),
    # the k1 exit
    "ifcnn": {"conv_gray_enter": 1, "conv_chain": 2, "conv_gray_exit": 1},
    # five ResBlocks (conv1 conv_chain; conv2 + the residual as an identity
    # leg, conv_multi) and the fuse over the batch halves (conv_multi)
    "difnet": {"conv_gray_enter": 1, "conv_chain": 5, "conv_multi": 6,
               "conv_gray_exit": 1},
    # the two two-gray-leg entries, gradient1 and intensity1 conv_chain,
    # the transfers and the later path convs over legs, decode over 8 legs
    "pmgi": {"conv_gray_enter": 2, "conv_chain": 2, "conv_multi": 8,
             "conv_gray_exit": 1},
    # enc0 over both images, the ResBlock's two convs (each followed by its
    # group norm), dec2; the stride-2 and transpose convs are cuDNN's
    "sedrfuse": {"conv_gray_enter": 1, "conv_chain": 2, "conv_gray_exit": 1},
    # MyFusion's default: conv_in's 8-channel enter over both images;
    # conv_chain: 4 TransitionBlock pw, 4 SepConvBlock pwconv1, 6 DCBlock
    # pw2; conv_dw: down1's k1, 4 SepConvBlock dw, 6 DCBlock dw;
    # conv_multi: 4 pwconv2 with the identity shortcut, the pw1 of DB2_1,
    # DB3_1, DB1_2 and DB2_2 over their legs; conv_wide: DB1_1's and
    # DB1_3's pw1 (24, 40); conv_out on the exit; the three strided
    # depthwise downs are cuDNN's
    "myfusion": {"conv_gray_enter": 1, "conv_chain": 14, "conv_dw": 11,
                 "conv_multi": 8, "conv_wide": 2, "conv_gray_exit": 1},
    # res2 + plain + rfn + maxpool, no level shared: each branch its
    # conv_in, down1's k1 dw, 4 pw, 4 Res2 blocks (pwconv1, 4 dw, pwconv2
    # over 4 legs); 4 RFNs; the plain decoder's 3 DCBlocks on one tensor
    "myfusion_res2_plain_rfn": {"conv_gray_enter": 2, "conv_chain": 38,
                                "conv_dw": 37, "conv_multi": 16,
                                "conv_gray_exit": 1},
    # transformer encoder, fs decoder, elem sum: a level's TransitionBlock
    # pw (level 1 also its k1 dw), the Attention's q, k, v, proj and the
    # FFN's pw1 (conv_chain), its dw (conv_dw), its pw2 with the block's
    # residual as an identity leg (conv_multi); the fs decoder's pw1 over
    # four legs to 120 (conv_wide), dw, pw2; the pools on cuDNN, the
    # attention on SDPA (tests/test_torch_myfusion_blocks.py LAUNCHES)
    "myfusion_transformer_fs_elem": {"conv_gray_enter": 1, "conv_chain": 27,
                                     "conv_dw": 8, "conv_multi": 4,
                                     "conv_wide": 3, "conv_gray_exit": 1},
    # mix_former encoder (levels 1-2 per branch), ls decoder, concat
    # fusion: 6 level instances of pw, MixConvBlock (pwconv1, four windows
    # k1-k7 on conv_dw, pwconv2 + identity) and the FFN; fuse1-4 over two
    # legs; DB3, DB2 pw1 over legs, DB1's on conv_wide
    "myfusion_mixformer_ls_concat": {"conv_gray_enter": 2, "conv_chain": 21,
                                     "conv_dw": 35, "conv_multi": 18,
                                     "conv_wide": 1, "conv_gray_exit": 1},
}
# MyFusion: its default benched, contract-held and CLI-tested; one more
# configuration through the test CLI (the res2 encoder, the per-branch
# route of unshared levels, the plain decoder, RFN, max-pool downs)
MYF_MODELS = ("myfusion",)
MYF_RES2 = dict(encoder="res2", decoder="plain", fusion_method="rfn",
                down_mode="maxpool", share_weight_levels=0)
# MyFusion's MetaFormer configurations (the reference goldens' two), each
# benched with its profile split into conv kernels, SDPA and torch ops,
# contract-held; the first also through the test CLI. Their f32 plain
# path for serving is the serving kernels' plain versions, which fold the
# batch norms as serving does (`plain_kernels`), the attention SDPA.
MYF_FORMERS = {
    "myfusion_transformer_fs_elem": dict(
        encoder="transformer", decoder="fs", fusion_method="elem",
        fusion_mode="sum"),
    "myfusion_mixformer_ls_concat": dict(
        encoder="mix_former", decoder="ls", fusion_method="concat",
        up_mode="nearest", share_weight_levels=2),
}
MYF_FORMER_CLI = "myfusion_mixformer_ls_concat"

# phase 6's train-step checks: (key, model name, configuration) of every
# model that trains (batch norms in train mode, the 'nl' attention's
# autograd Function, MyFusion's three benched configurations)
TRAIN_CHECKS = ([(n, n, {}) for n in (
    "deepfuse", "densefuse", "sedrfuse", "vifnet", "dbnet", "unfusion",
    "nestfuse", "rfnnest", "mafusion", "pfnetv1", "pfnetv2", "ifcnn",
    "difnet", "pmgi", "res2fusion", "myfusion")]
    + [(k, "myfusion", cfg) for k, cfg in MYF_FORMERS.items()])
# benched, contract-held and CLI-tested like the nest models; IFCNN,
# DIFNet and PMGI have batch norms
FIVE_MODELS = ("pfnetv1", "pfnetv2", "ifcnn", "difnet", "pmgi")
NORM_MODELS = ("ifcnn", "difnet", "pmgi")
# benched, contract-held, CLI-tested and train-step-checked; group norms
# (no statistics: its plain path is F.conv2d, fast_training(False))
GROUP_MODELS = ("sedrfuse",)
L1_PAIRS = 11
RES2_PAIRS = 3        # the res2fusion test CLI's pairs (the first, warmup)
WIDE_PAIRS = 3        # the dbnet, unfusion and nest models' test CLIs' pairs
NEST_MODELS = ("nestfuse", "rfnnest", "mafusion")


def seeded_model(torch, name, seed, **cfg):
    """create_model(name) with its weights drawn from `seed` and, where it
    has batch or group norms, their scale, bias and statistics too (from
    seed + 1000; scale in [0.5, 1.5], bias and mean within +-0.1, variance
    in [0.5, 2]): a norm at its init (1, 0, 0, 1) would fold to nothing."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    m = create_model(name, generator=torch.Generator().manual_seed(seed),
                     **cfg)
    g = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                c = bn.num_features
                bn.weight.copy_(0.5 + torch.rand(c, generator=g))
                bn.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                bn.running_mean.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
            elif isinstance(bn, torch.nn.GroupNorm):
                c = bn.num_channels
                bn.weight.copy_(0.5 + torch.rand(c, generator=g))
                bn.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
    return m


def live_seed(torch, dev, name, min_live=0.99, key=None, min_spread=0.0,
              **cfg):
    """The first weight seed of `name` (seeded_model) whose fused image is
    live: above the image's minimum at `min_live` of the pixels of 2
    seeded 128x128 pairs (f32, the card's F.conv2d route; where the model
    has batch norms the serving route's plain versions, `plain_route`).
    Most of the zoo's models end in a relu conv over non-negative
    features, so at a random init the sign of that conv's mean
    pre-activation is a coin flip a draw: NestFuse's seed-0 weights fuse
    every pair to 0 on every route, which would hold its contract
    vacuously, and a draw that clips part of the image fuses those pixels
    to a constant and flips the pixels near the clip under bf16's rounding
    of the weights (RFNNest's seed 1, a quarter of its pixels clipped,
    moved the mean SSIM by 1.28e-3 on the kernels and on F.conv2d in bf16
    alike). An output without relu (IFCNN, DIFNet, PMGI, PFNet) is live
    unless constant. With `min_spread` (MyFusion's MYF_FORMERS: 1e-3) the
    fused image's std must also pass that share of its largest magnitude:
    a MixFormer draw fused every pixel to one value, which f32 rounding on
    the card left a few ulps above the minimum at every pixel. The other
    models take no spread rule."""
    g = torch.Generator(device=dev).manual_seed(7)
    x1, x2 = (torch.rand((2, 128, 128, 1), generator=g, device=dev)
              for _ in range(2))
    for seed in range(64):
        m = seeded_model(torch, name, seed, **cfg)
        with torch.no_grad(), plain_route(key or name):
            y = m.to(dev).eval()(x1, x2)
        live = float((y > y.min()).float().mean())
        spread = float(y.std()) / max(float(y.abs().max()), 1e-30)
        if live >= min_live and spread > min_spread:
            print(f"{key or name}: weight seed {seed}, {live:.3f} of the "
                  f"fused pixels above the image's minimum")
            return seed
    raise AssertionError(f"{name}: no live weight seed below 64")


def plain_route(name):
    """The f32 plain path's scope on the card: F.conv2d for every conv
    (fast_training(False)), or for a model with batch norms (NORM_MODELS,
    MyFusion's MYF_FORMERS) the serving kernels' plain versions, the
    layers' convs on F.conv2d in f32 over the folded norms, as serving
    folds them (`plain_kernels`)."""
    from multi_modal_image_fusion_tpu_torch.ops.layers import fast_training
    if name in NORM_MODELS or name in MYF_FORMERS:
        return plain_kernels()
    return fast_training(False)


@contextlib.contextmanager
def plain_kernels():
    """ConvLayer's serving kernels replaced by their plain versions (F.pad
    + F.conv2d in f32 on the folded weight, rounded to the input's dtype
    first) on the card too: the plain path of a model with batch norms."""
    from multi_modal_image_fusion_tpu_torch.ops import layers
    from multi_modal_image_fusion_tpu_torch.ops.cuda import conv_chain as cc
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_dw import \
        conv_dw_plain
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_multi import \
        conv_multi_plain
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import \
        conv_wide_plain
    swap = {"conv_gray_enter": cc.conv_gray_enter_plain,
            "conv_gray_exit": cc.conv_gray_exit_plain,
            "conv_chain": cc.conv_chain_plain,
            "conv_multi": conv_multi_plain,
            "conv_dw": conv_dw_plain, "conv_wide": conv_wide_plain}
    kept = {k: getattr(layers, k) for k in swap}
    try:
        for k, fn in swap.items():
            setattr(layers, k, fn)
        yield
    finally:
        for k, fn in kept.items():
            setattr(layers, k, fn)


def bench_path(build, bench, name, batch=BATCH, model=None, seed=0,
               net=None):
    """The port's bench of `model` (default `name`) at `batch` pairs with
    every count set to 0 just before it; the counts must be exactly
    FORWARD_LAUNCHES[name] x (warmup + timed). `net`: the built model to
    time (seeded_model), else the bench's own init from `seed`."""
    build.LAUNCHES.clear()
    result, last = bench.run(seed=seed, model_name=model or name,
                             batch=batch, model=net)
    counts = dict(build.LAUNCHES)
    want = {k: v * (bench.ITERS + 1)
            for k, v in FORWARD_LAUNCHES[name].items()}
    if counts != want:
        raise AssertionError(f"{name} bench launches {counts}, want {want}")
    print(f"bench {name}: {json.dumps(result)}")
    return result, last, counts


# kernel-name prefixes of the port's kernels (csrc/), for the forward's split
# (conv_wide launches conv_chain_tc_kernel, so its time is in "conv"), and
# of torch's SDPA kernels (flash; memory-efficient, cutlass's fmha)
KERNEL_GROUPS = {"nl": ("nl_",), "conv": ("conv_",),
                 "sdpa": ("flash_", "fmha_")}


def profile_forward(torch, model, a, b, spans=()):
    """Where one fused forward's device time goes: torch.profiler over the
    forward (after one unprofiled warmup), the kernels' time summed by group
    (the nl kernels, the conv kernels, the rest: torch's own ops such as
    the channel attention's matmuls, the pool, the fusion's elementwise
    passes and copies), against the forward's wall time without the
    profiler (the device's busy share). `cudnn_conv_ms` is the part of the
    rest under aten::convolution (the stride-2 and transpose convs on
    cuDNN), `torch_ops_ms` the rest without it (norms, fusion, adds,
    copies); `<span>_ms` the device time under each profiler span named
    in `spans` (`record_function`), `upsample_ms` that of torch's bilinear
    upsample kernels. `model` may be any function of (a, b)."""
    from torch.autograd import DeviceType
    with torch.no_grad():
        model(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(a, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(a, b)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    split = {key: 0.0 for key in (*KERNEL_GROUPS, "other")}
    for e in kernels:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1]
        key = next((k for k, pre in KERNEL_GROUPS.items()
                    if name.startswith(pre)), "other")
        split[key] += e.device_time_total / 1e3
    total = sum(split.values())
    # the device time of a CPU op counts its kernels and its children's
    def under(op):
        return sum(e.device_time_total for e in prof.events()
                   if e.name == op and e.device_type == DeviceType.CPU) / 1e3
    cudnn = under("aten::convolution")
    # the torch ops by name: the aten ops' own device time (their kernels,
    # not their children's), the largest 8
    by_op = sorted(((getattr(a, "self_device_time_total", 0.0) / 1e3,
                     a.key) for a in prof.key_averages()
                    if a.key.startswith("aten::")), reverse=True)
    return {"wall_ms": wall, "kernel_ms": total, "busy_share": total / wall,
            "launches": len(kernels),
            **{f"{k}_ms": v for k, v in split.items()},
            "cudnn_conv_ms": cudnn, "torch_ops_ms": split["other"] - cudnn,
            "top_aten_ms": {k: v for v, k in by_op[:8] if v > 0},
            "upsample_ms": under("aten::upsample_bilinear2d"),
            **{f"{k}_ms": under(k) for k in spans},
            "source": "torch.profiler"}


def ssim_qabf(torch, x1, x2, y):
    """Per-pair (SSIM, Qabf): SSIM of the fused image against both inputs
    through the plain maps (data_range 1), Qabf through ops/metrics."""
    from multi_modal_image_fusion_tpu_torch.ops.metrics import calc_Qabf
    return ((_plain_ssim(torch, x1, y) + _plain_ssim(torch, x2, y)) * 0.5,
            calc_Qabf(x1, x2, y))


def contract(torch, dev, name, a16, b16, y16, chunk=4, seed=0, key=None,
             cfg=None):
    """The BASELINE contract on a bench's last timed batch: its bf16 kernel
    forward's mean SSIM and Qabf against the f32 forward of the same
    weights on the card's F.conv2d route (TF32 off; Res2Fusion's 'nl'
    attention through its plain version), and against the bf16 forward
    through F.conv2d (the same bf16 storage between layers, cuDNN's
    convs). Held within 1e-3 of f32 for every model, VIFNet too; the gap
    to the bf16 F.conv2d forward is printed beside it (for VIFNet the JAX
    package recorded a bf16 floor of 2.1e-3 dSSIM, docs/PARITY.md). The
    fused images must not be constant (std > 0); their largest |bf16 -
    f32| over max|f32| is printed beside the gaps, not gated. Weights from
    `seeded_model`; a model with batch norms takes the plain versions of
    the serving kernels for both references (`plain_route`). `key` names a
    MyFusion configuration `cfg` (MYF_FORMERS)."""
    route = key or name
    m32, m16 = (seeded_model(torch, name, seed, **(cfg or {})).to(
        dev, dt).eval() for dt in (torch.float32, torch.bfloat16))
    vals = {"kernel_bf16": [], "f32": [], "conv2d_bf16": []}
    # reported beside the gaps: the bf16 fused images' largest difference
    # to the f32 forward's over its largest magnitude (scale-free, where a
    # faint fused image makes the SSIM and Qabf gaps small too)
    d_max, y_max = 0.0, 0.0
    with torch.no_grad():
        for lo in range(0, a16.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            x1, x2 = a16[sl].float(), b16[sl].float()
            with plain_route(route), plain_nl():
                y32 = m32(x1, x2)
                yb = m16(a16[sl], b16[sl]).float()
            d_max = max(d_max, float((y16[sl].float() - y32).abs().max()))
            y_max = max(y_max, float(y32.abs().max()))
            for key, y in (("kernel_bf16", y16[sl].float()), ("f32", y32),
                           ("conv2d_bf16", yb)):
                vals[key].append(torch.stack(ssim_qabf(torch, x1, x2, y)))
            del y32, yb
    means = {k: torch.cat(v, 1).mean(1).tolist() for k, v in vals.items()}
    gap = [abs(a - b) for a, b in zip(means["kernel_bf16"], means["f32"])]
    d_bf16 = [abs(a - b) for a, b in zip(means["kernel_bf16"],
                                         means["conv2d_bf16"])]
    # a constant fused image would hold the contract vacuously
    std = float(y16.float().std())
    if not (all(np.isfinite(means["kernel_bf16"])) and max(gap) <= 1e-3
            and std > 0):
        raise AssertionError(f"{route} bf16 contract: {means}, "
                             f"fused std {std}")
    rec = {"ssim": {k: v[0] for k, v in means.items()}, "fused_std": std,
           "fused_max_rel_err": d_max / y_max if y_max else float("inf"),
           "qabf": {k: v[1] for k, v in means.items()},
           "d_f32": {"ssim": gap[0], "qabf": gap[1]},
           "d_conv2d_bf16": {"ssim": d_bf16[0], "qabf": d_bf16[1]},
           "held_against": "f32", "pairs": int(a16.shape[0])}
    print(f"bf16 contract {route}: {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def plain_nl():
    """Route the 'nl' spatial pooling through its plain two-pass version on
    the card too (the f32 plain path's reference; with a gradient, torch's
    autograd through it in place of the autograd Function)."""
    from multi_modal_image_fusion_tpu_torch.ops import fusion
    from multi_modal_image_fusion_tpu_torch.ops.cuda.nl_attention import \
        nl_spatial_plain
    kept = fusion.nl_spatial_diff
    fusion.nl_spatial_diff = nl_spatial_plain
    try:
        yield
    finally:
        fusion.nl_spatial_diff = kept


@contextlib.contextmanager
def plain_attention():
    """The Attention's SDPA replaced by its plain einsums (`attention_plain`)
    on the card: the float64 train step's reference route."""
    from multi_modal_image_fusion_tpu_torch.ops import blocks
    kept = blocks.attention
    blocks.attention = blocks.attention_plain
    try:
        yield
    finally:
        blocks.attention = kept


def model_cli_path(torch, build, test_cli, root, dev, key, name, cfg, pairs,
                   seed):
    """The port's test CLI on a seeded checkpoint of `name` (model_cfg
    `cfg`) over the first `pairs` synthetic pairs, every count set to 0
    just before it (exactly FORWARD_LAUNCHES[key] a pair, 2 ssim_maps); its
    SSIM against the f32 plain path on the card: F.conv2d for every conv
    (TF32 off; a model with batch norms: the serving kernels' plain
    versions, `plain_route`) and the plain 'nl' attention; and each pair's
    fused image through the kernels against that path's, within the f32
    tolerance. Weights from `seeded_model`. Beside the CLI's mean (every
    pair but the first) the record keeps each pair's time as the CLI
    printed it, their median without the first, and the host's garbage
    collections while the CLI ran (count and ms by generation, from
    `gc.callbacks`): a slow pair shows beside its cause or without one."""
    import shutil
    from multi_modal_image_fusion_tpu_torch.data.dataset import \
        FusionDataset
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
        save_state_dict
    data = f"synth{pairs}"
    for mod in ("vis", "ir"):
        dst = os.path.join(root, "data", data, "test", mod)
        os.makedirs(dst, exist_ok=True)
        for i in range(pairs):
            shutil.copy(os.path.join(root, "data", "synth", "test", mod,
                                     f"{i + 1}.bmp"), dst)
    model = seeded_model(torch, name, seed, **cfg)
    save_state_dict(os.path.join(root, "ckpt", f"{key}run", "epoch_best.pth"),
                    model.state_dict(), meta={"model": name, "model_cfg": cfg})
    gcs, t0 = {}, [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
            return
        n, ms = gcs.get(info["generation"], (0, 0.0))
        gcs[info["generation"]] = (n + 1,
                                   ms + (time.perf_counter() - t0[0]) * 1e3)
    build.LAUNCHES.clear()
    out = io.StringIO()
    gc.callbacks.append(on_gc)
    try:
        with contextlib.redirect_stdout(out):
            ssim, avg = test_cli.main([
                "--data", data, "--data_root", os.path.join(root, "data"),
                "--ckpt_root", os.path.join(root, "ckpt"),
                "--ckpt", f"{key}run"])
    finally:
        gc.callbacks.remove(on_gc)
    pair_ms = [float(v) for v in re.findall(r"^iter: \d+, .*time: "
                                            r"([0-9.]+)ms$", out.getvalue(),
                                            re.M)]
    counts = dict(build.LAUNCHES)
    want = {k: v * pairs for k, v in FORWARD_LAUNCHES[key].items()}
    want["ssim_maps"] = 2 * pairs
    if counts != want:
        raise AssertionError(f"{key} test CLI launches {counts}, want {want}")
    model = model.to(dev).eval()
    ds = FusionDataset(os.path.join(root, "data", data), "test", "test", "ir")
    ref, y_err, y_max = [], 0.0, 0.0
    with torch.no_grad():
        for i in range(len(ds)):
            a, b = (torch.from_numpy(v)[None, ..., None].to(dev)
                    for v in ds[i])
            y_kernels = model(a, b)
            with plain_route(key), plain_nl():
                y = model(a, b)
            y_err = max(y_err, float((y_kernels - y).abs().max()))
            y_max = max(y_max, float(y.abs().max()))
            ref.append(float((_plain_ssim(torch, a, y)
                              + _plain_ssim(torch, b, y))[0] * 0.5))
    ref_ssim = float(np.mean(ref))
    if not (np.isfinite(ssim) and abs(ssim - ref_ssim) <= 1e-4
            and y_err <= TOL["f32"] * max(y_max, 1.0)):
        raise AssertionError(f"{key} test CLI SSIM {ssim} vs the f32 plain "
                             f"path {ref_ssim}; fused max |d| {y_err}")
    rec = {"pairs": pairs, "ssim": ssim, "ssim_f32_plain": ref_ssim,
           "fused_max_abs_err": y_err, "fused_max": y_max,
           "mean_ms": avg * 1e3, "pair_ms": pair_ms,
           "median_ms": float(np.median(pair_ms[1:])),
           "gc": {f"gen{g}": {"count": n, "ms": ms}
                  for g, (n, ms) in sorted(gcs.items())}}
    print(f"test CLI {key}: {json.dumps(rec)}")
    return rec, counts


_CELL = re.compile(r'<c r="([A-Z]+)(\d+)"(?: t="inlineStr")?>'
                   r'(?:<v>([^<]*)</v>|<is><t>([^<]*)</t></is>)</c>')


def read_workbook(path):
    """{sheet name: {(column, row): str or float}} of an xlsx the eval CLI
    wrote."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        names = re.findall(r'<sheet name="([^"]*)"',
                           z.read("xl/workbook.xml").decode())
        return {name: {(col, int(row)): (float(v) if v else s)
                       for col, row, v, s in _CELL.findall(z.read(
                           f"xl/worksheets/sheet{i + 1}.xml").decode())}
                for i, name in enumerate(names)}


def eval_split(torch, root, eval_cli, imread_gray, eval_metrics):
    """Where the eval CLI's time goes, chunk by chunk over the same 51 dumped
    pairs, as eval_method and write_workbook spend it: the host decoding of
    a chunk's BMP files (3 a pair), eval_metrics on the card (host clock
    around the call and the copy of its values back, synchronised), and
    the xlsx writing of the 51 rows in each layout; then one full chunk's
    eval_metrics under torch.profiler, its device time by kernel name
    (ssim_maps and moments, whose kernels are the window_kernel instances
    with the SSIM and moments epilogues, and the torch rest) beside the
    chunk's host clock without the profiler. Run after the CLI's counts
    are read: its launches are not a path's."""
    from torch.autograd import DeviceType
    data = os.path.join(root, "data", "synth", "test")
    fused = os.path.join(root, "ckpt", "run", "synth")
    paths = [(os.path.join(data, "vis", f"{i}.bmp"),
              os.path.join(data, "ir", f"{i}.bmp"),
              os.path.join(fused, f"{i:0>2}.bmp"))
             for i in range(1, CLI_PAIRS + 1)]
    dev = torch.device("cuda")
    chunks, rows, full = [], [], None
    for lo in range(0, CLI_PAIRS, eval_cli.CHUNK):
        part = paths[lo:lo + eval_cli.CHUNK]
        t0 = time.perf_counter()
        imgs = [[imread_gray(p) for p in trio] for trio in part]
        t1 = time.perf_counter()
        stacks = [torch.from_numpy(np.stack([im[k] for im in imgs])[..., None])
                  .to(dev) for k in range(3)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            out = {k: v.cpu().numpy() for k, v in eval_metrics(*stacks)
                   .items()}
        t3 = time.perf_counter()
        rows += [{k: float(v[j]) for k, v in out.items()}
                 for j in range(len(part))]
        chunks.append({"pairs": len(part), "decode_ms": (t1 - t0) * 1e3,
                       "upload_ms": (t2 - t1) * 1e3,
                       "eval_metrics_ms": (t3 - t2) * 1e3})
        if len(part) == eval_cli.CHUNK:
            full = stacks
    names = [f"{i}.bmp" for i in range(1, CLI_PAIRS + 1)]
    xlsx = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sheet in ("method", "metric"):
            t0 = time.perf_counter()
            eval_cli.write_workbook(os.path.join(tmp, f"{sheet}.xlsx"),
                                    "deepfuse", names, rows, sheet)
            xlsx[sheet] = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        eval_metrics(*full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_metrics(*full)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=acts) as prof:
            eval_metrics(*full)
            torch.cuda.synchronize()
    by = {"ssim_maps": 0.0, "moments": 0.0, "rest": 0.0}
    launches = {"ssim_maps": 0, "moments": 0, "rest": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        key = ("ssim_maps" if "EpiSsim" in e.name else "moments"
               if "EpiMoments" in e.name else "rest")
        by[key] += e.device_time_total / 1e3
        launches[key] += 1
    n = sum(c["pairs"] for c in chunks)
    rec = {"chunks": chunks,
           "per_pair_ms": {k: sum(c[k] for c in chunks) / n for k in
                           ("decode_ms", "upload_ms", "eval_metrics_ms")},
           "xlsx_ms": xlsx,
           "xlsx_per_pair_ms": {k: v / n for k, v in xlsx.items()},
           "profiled_chunk": {"pairs": eval_cli.CHUNK, "wall_ms": wall,
                              "device_ms": by, "kernels": launches,
                              "device_busy": sum(by.values()) / wall}}
    print(f"eval split: {json.dumps(rec)}")
    return rec


def eval_path(torch, build, root):
    """The port's eval CLI in both sheet layouts over the 51 NN.bmp files
    the DeepFuse test CLI dumped, every count set to 0 just before; exact
    moments and ssim_maps counts (per eval_metrics call, i.e. per chunk of
    at most eval.CHUNK images: 8 moments = 2 VIF pyramids x 4 scales, 12
    ssim_maps = 2 SSIM + 2 x 5 MS-SSIM levels); every value finite; the
    card values of images 1-3, of the last image of the first full chunk
    and of the last image against the same function on CPU tensors (the
    plain versions): 1e-4 relative, VIFF 1e-3."""
    from multi_modal_image_fusion_tpu_torch.cli import eval as eval_cli
    from multi_modal_image_fusion_tpu_torch.data.io import imread_gray
    from multi_modal_image_fusion_tpu_torch.ops.metrics import eval_metrics
    args = ["--data", "synth", "--data_root", os.path.join(root, "data"),
            "--ckpt_root", os.path.join(root, "ckpt"), "--ckpt", "run"]
    build.LAUNCHES.clear()
    books, walls = {}, {}
    for sheet in ("method", "metric"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            path = eval_cli.main(args + ["--methods", f"deepfuse_{sheet}",
                                         "--sheet", sheet])
        walls[sheet] = time.perf_counter() - t0
        books[sheet] = read_workbook(path)
    counts = dict(build.LAUNCHES)
    chunks = -(-CLI_PAIRS // eval_cli.CHUNK)
    want = {"moments": 2 * chunks * 8, "ssim_maps": 2 * chunks * 12}
    if counts != want:
        raise AssertionError(f"eval launches {counts}, want {want}")
    cols = [chr(ord("B") + j) for j in range(len(eval_cli.METRIC_KEYS))]
    rows = books["method"]["deepfuse_method"]
    last = 3 + CLI_PAIRS
    if rows.get(("A", last)) != f"{CLI_PAIRS}.bmp" or ("A", last + 1) in rows:
        raise AssertionError("method workbook: not 51 image rows")
    if sorted(books["metric"]) != sorted(eval_cli.METRIC_LABELS):
        raise AssertionError(f"metric workbook sheets {sorted(books['metric'])}")
    for name, sheet in books["metric"].items():
        if sheet.get(("A", last)) != f"{CLI_PAIRS}.bmp":
            raise AssertionError(f"metric workbook sheet {name}: rows")
    values = [v for (c, r), v in rows.items() if r > 1 and c != "A"]
    if len(values) != 16 * (CLI_PAIRS + 2) or not np.isfinite(values).all():
        raise AssertionError("eval values missing or not finite")
    data = os.path.join(root, "data", "synth", "test")
    picks = (1, 2, 3, eval_cli.CHUNK, CLI_PAIRS)
    imgs = [np.stack([imread_gray(p) for p in paths])[..., None]
            for paths in ([os.path.join(data, "vis", f"{i}.bmp")
                           for i in picks],
                          [os.path.join(data, "ir", f"{i}.bmp")
                           for i in picks],
                          [os.path.join(root, "ckpt", "run", "synth",
                                        f"{i:0>2}.bmp") for i in picks])]
    with torch.no_grad():
        cpu = eval_metrics(*map(torch.from_numpy, imgs))
    worst = {}
    for j, key in enumerate(eval_cli.METRIC_KEYS):
        tol = 1e-3 if key == "viff" else 1e-4
        for i, img in enumerate(picks):
            card, want_v = rows[(cols[j], 3 + img)], float(cpu[key][i])
            d = abs(card - want_v) / max(abs(want_v), 1e-6)
            worst[key] = max(worst.get(key, 0.0), d)
            if d > tol:
                raise AssertionError(f"eval {key} image {img}: card {card} "
                                     f"vs CPU {want_v}")
    wall = sum(walls.values())
    split = eval_split(torch, root, eval_cli, imread_gray, eval_metrics)
    rec = {"pairs": CLI_PAIRS, "runs": 2, "wall_s": walls, "split": split,
           "ms_per_pair": wall * 1e3 / (2 * CLI_PAIRS), "chunks": chunks,
           "card_vs_cpu_images": list(picks), "card_vs_cpu_max_rel": worst,
           "mean": {k: rows[(cols[j], 2)]
                    for j, k in enumerate(eval_cli.METRIC_KEYS)}}
    print(f"eval CLI: {json.dumps(rec)}")
    return rec, counts



# ---------------------------------------------------------------------------
# int8 inference (rows 11 and 12): conv_int8 and conv_int8_chain
# ---------------------------------------------------------------------------

INT8_REPLACES = {
    "conv_int8": "multi_modal_image_fusion_tpu/ops/pallas/conv_int8.py:219 "
                 "(conv_tlane_dma_q; pallas_call :263)",
    "conv_int8_chain": "multi_modal_image_fusion_tpu/ops/pallas/"
                       "hiw_int8.py:260 (conv_hiw_chain_q; pallas_call :354)"}
# int8 checks against the plain versions: int8 outputs equal; f32 within
# 1e-6 of max|y|; bf16 within one bf16 ulp of each output (the integer dot
# is exact on both sides and both round the multiply-add once). A control
# (taps transposed; the fold left out of the weights; one fuse_n half's
# images in reverse order) must miss by more than 1e-2 of max|y|: 10x the
# 1e-3 quality budget.
INT8_TOL = {"f32": 1e-6, "bf16": 0.0, "int8": 0.0}
INT8_CONTROL = 1e-2
# DeepFuse's chain legs: (name, c_in, c_out, k, fuse, input, output);
# input/output "int8" is an int8-resident hop
CHAIN_CASES = [("enc1", 16, 32, 7, False, "float", "int8"),
               ("dec0", 32, 32, 7, True, "int8", "int8"),
               ("dec1", 32, 16, 5, False, "int8", "float"),
               ("enc1.nonres", 16, 32, 7, False, "float", "float"),
               ("dec0.nonres", 32, 32, 7, True, "float", "float")]
# ConvLayer-route layers as the int8 forwards launch them: (name, leg
# channels, c_out, k, act, images per pair in, fuse_n, h, w); the legs are
# read in place, with fuse_n the pair's halves summed first
ROW11_CASES = [
    ("deepfuse.enc0", [1], 16, 5, "relu", 2, False, H, W),
    ("deepfuse.enc1", [16], 32, 7, "relu", 2, False, H, W),
    ("deepfuse.dec0", [32], 32, 7, "relu", 2, True, H, W),
    ("deepfuse.dec1", [32], 16, 5, "relu", 1, False, H, W),
    ("deepfuse.dec2", [16], 1, 5, None, 1, False, H, W),
    ("densefuse.conv_in", [1], 16, 3, "relu", 2, False, H, W),
    ("densefuse.dense0", [16], 16, 3, "relu", 2, False, H, W),
    ("densefuse.dense1", [16, 16], 16, 3, "relu", 2, False, H, W),
    ("densefuse.dense2", [16, 16, 16], 16, 3, "relu", 2, False, H, W),
    ("densefuse.dec0", [16] * 4, 64, 3, "relu", 2, True, H, W),
    ("densefuse.dec1", [64], 32, 3, "relu", 1, False, H, W),
    ("densefuse.dec2", [32], 16, 3, "relu", 1, False, H, W),
    ("densefuse.dec3", [16], 1, 3, None, 1, False, H, W),
    ("unfusion.DB3_1.conv1", [256, 1024], 640, 3, "relu", 1, False, 306,
     256),
    # the new widest shapes: SEDRFuse's ResBlock conv (its group norm and
    # relu follow the kernel: act None) over the encoder's 32 images at
    # 1/4 scale; MAFusion's DB1 conv1 over its four legs at full scale,
    # one image (its bench forward takes four; the library's im2col of one
    # image is 21.6 GB in bf16)
    ("sedrfuse.res.conv1", [256], 256, 3, None, 2, False, 306, 256),
    ("mafusion.DB1.conv1", [64, 128, 256, 512], 480, 3, "relu", 1, False, H,
     W, 1)]


def _int8_err(torch, got, want, kind):
    """(max abs err, max err / max|want|) of kernel against plain; bf16
    beyond one bf16 ulp of each output."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite kernel output")
    d = (g - w).abs()
    if kind == "bf16":
        d = (d - torch.exp2(torch.floor(torch.log2(
            w.abs().clamp(min=1e-30))) - 7)).clamp(min=0)
    err = float(d.max())
    return err, err / max(float(w.abs().max()), 1e-30)


def _channel_spread(torch, c, dev):
    """Per-channel input scales spanning 100x (10^-1.5 to 10^0.5, in a
    fixed shuffled order), as feature channels do: with equal channel
    ranges the smooth fold is nearly constant, and a check could not tell
    a folded from an unfolded weight."""
    s = torch.logspace(-1.5, 0.5, c, device=dev)
    return s[torch.randperm(c, generator=torch.Generator().manual_seed(c))
             .to(dev)]


def _int_mm_library(torch, F, timer, q, qw):
    """One torch._int_mm on the im2col'd int8 input (K and N padded to
    multiples of 8), in chunks of whole images of at most 2^30 int8
    elements: (summed _int_mm ms, summed unfold ms, calls)."""
    cout, cin, k, _ = qw.shape
    p = k // 2
    b, h, w, _ = q.shape
    kk = cin * k * k
    kp, npad = -(-kk // 8) * 8, max(8, -(-cout // 8) * 8)
    wm = torch.zeros((kp, npad), dtype=torch.int8, device=q.device)
    wm[:kk, :cout] = qw.reshape(cout, kk).t()
    step = max(1, 2 ** 30 // (h * w * kp))

    def unfold(sl):
        x = q[sl].permute(0, 3, 1, 2).to(torch.bfloat16)   # exact: |q| <= 127
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        a = F.unfold(x, k).permute(0, 2, 1).reshape(-1, kk)
        return F.pad(a, (0, kp - kk)).to(torch.int8).contiguous()
    mm_ms = unfold_ms = 0.0
    calls = 0
    for i in range(0, b, step):
        sl = slice(i, i + step)
        a = unfold(sl)
        mm_ms += timer(lambda: torch._int_mm(a, wm))
        unfold_ms += timer(lambda: unfold(sl))
        calls += 1
        del a
    return mm_ms, unfold_ms, calls


def _int8_split(torch, run, reps=5):
    """(quantizer ms, conv ms) of one call of `run`, an int8 wrapper on a
    float input: the device time of its q8_quantize_kernel and
    conv_int8_tc_kernel launches under torch.profiler, over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    ms = {"q8_quantize_kernel": 0.0, "conv_int8_tc_kernel": 0.0}
    for e in prof.key_averages():
        for name in ms:
            if name in e.key:
                ms[name] += getattr(e, "self_device_time_total", getattr(
                    e, "self_cuda_time_total", 0)) / 1e3 / reps
    if not all(ms.values()):
        raise AssertionError(f"the profiler saw no device time of {ms}")
    return ms["q8_quantize_kernel"], ms["conv_int8_tc_kernel"]


def check_int8(torch, F, dev, timer):
    """Phase 3 for rows 11 and 12: conv_int8_chain at DeepFuse's chain legs
    and conv_int8 at DeepFuse's five, DenseFuse's eight and UNFusion's
    DB3_1 conv1 layers, against their plain versions (the exact integer
    conv) at 1224x1024 (bf16, the bench's 16 pairs; f32, the test CLI's
    pair), with the controls, and timed at the bench's shapes beside the
    plain version, one torch._int_mm on the im2col'd input (the unfold
    timed apart) and one bf16 F.conv2d on the padded input (the pad timed
    apart); for a float input also its two kernels apart (_int8_split),
    the quantizer beside its byte bound. Returns {kernel: record}."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8, conv_int8_chain, conv_int8_chain_plain, conv_int8_plain)
    from multi_modal_image_fusion_tpu_torch.ops.quant import (
        choose_fold, fold_weights, quantize_weights)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    recs = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                   "min_control_rel_err": float("inf"),
                   "tolerance_rel": INT8_TOL,
                   "control_must_exceed_rel": INT8_CONTROL, "layers": {}}
            for name in ("conv_int8", "conv_int8_chain")}

    def layer(cin, cout, k, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        w = (torch.rand((cout, cin, k, k), generator=g, device=dev) * 2 - 1) \
            / np.sqrt(cin * k * k)
        bias = (torch.rand((cout,), generator=g, device=dev) * 2 - 1) * 0.1
        return w, bias

    def note(kern, key, got, want, kind, controls):
        r = recs[kern]
        err, rel = _int8_err(torch, got, want, kind)
        if rel > INT8_TOL[kind]:
            raise AssertionError(f"{kern} {key}: max err {err} is {rel:.3g} "
                                 f"of max|y|, above {INT8_TOL[kind]}")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        for what, y in controls.items():
            c = _int8_err(torch, y, want, "f32")[1]
            if c <= INT8_CONTROL:
                raise AssertionError(f"{kern} {key}: the control ({what}) "
                                     f"misses by {c:.3g} only")
            r["min_control_rel_err"] = min(r["min_control_rel_err"], c)
        print(f"{kern} {key}: err {rel:.3g}; controls "
              f"{ {k: round(_int8_err(torch, y, want, 'f32')[1], 4) for k, y in controls.items()} }",
              flush=True)

    def timing(kern, key, run, plain, q, qw, x_float, bias, nbytes, ops,
               q_bytes=None):
        k = qw.shape[-1]
        mm_ms, unfold_ms, calls = _int_mm_library(torch, F, timer, q, qw)
        xn = x_float.permute(0, 3, 1, 2)
        parts, xp = _library_parts(F, xn, k, qw.shape[0])
        wb = qw.to(torch.bfloat16)
        bb = None if bias is None else bias.to(torch.bfloat16)
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS["int8"]
        recs[kern]["layers"][key] = {
            "ms": timer(run), "plain_ms": timer(plain),
            "library_ms": mm_ms, "library_unfold_ms": unfold_ms,
            "library_calls": calls,
            "library_conv_bf16_ms": timer(lambda: [F.conv2d(t, wb, bb)
                                                   for t in xp]),
            "library_pad_ms": timer(lambda: [
                F.pad(xn[sl], (k // 2,) * 4, mode="reflect")
                for sl in parts]),
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b > t_o else "operations",
            "tops": ops / 1e12}
        if q_bytes is not None:
            # a float input: the call's two kernels apart; the quantizer
            # moves q_bytes (its input read once, the int8 copy written)
            q_ms, conv_ms = _int8_split(torch, run)
            recs[kern]["layers"][key].update(
                quantize_ms=q_ms, quantize_bound_ms=q_bytes / PEAK_BYTES_S
                * 1e3, conv_ms=conv_ms)
        del xp

    # row 12: DeepFuse's chain legs
    for dt, pairs in (("bf16", BATCH), ("f32", 1)):
        dtype = dts[dt]
        for name, cin, cout, k, fuse, src, dst in CHAIN_CASES:
            n = pairs
            b_in = 2 * n if (fuse or name.startswith("enc1")) else n
            b_out = n if fuse else b_in
            w, bias = layer(cin, cout, k, 200 + cin + k)
            g = torch.Generator(device=dev).manual_seed(210 + cout)
            xf = ((torch.rand((b_in, H, W, cin), generator=g, device=dev)
                   * 2 - 0.5) * _channel_spread(torch, cin, dev)).to(dtype)
            amax = (xf[:n].float() + xf[n:].float() if fuse
                    else xf.float()).abs().amax(dim=(0, 1, 2))
            f = choose_fold(amax, w)
            qw, sw = quantize_weights(fold_weights(w, f))
            invf = 1.0 / f
            if src == "int8":
                x = torch.randint(-127, 128, (b_in, H, W, cin), generator=g,
                                  device=dev, dtype=torch.int8)
            else:
                x = xf
            out_int8 = dst == "int8"
            dq, b = sw, bias
            if out_int8:    # requant onto a grid that spans the outputs
                y = conv_int8_chain_plain(x, qw, sw, bias, "relu", invf,
                                          n if fuse else 0, out_dtype=dtype)
                f_next = y.float().abs().amax(dim=(0, 1, 2)).clamp(
                    min=1e-3) / 127.0
                dq, b = sw / f_next, bias / f_next
                del y
            fuse_n = n if fuse else 0

            def run(qw=qw, x=x):
                return conv_int8_chain(x, qw, dq, b, "relu", invf, fuse_n,
                                       out_int8, dtype)

            def plain():
                return conv_int8_chain_plain(x, qw, dq, b, "relu", invf,
                                             fuse_n, out_int8, dtype)
            want = plain()
            qw0, _ = quantize_weights(w)
            ctl = {"taps transposed": run(qw.transpose(2, 3).contiguous()),
                   "fold left out": run(qw0)}
            if fuse and n > 1:
                ctl["one half reversed"] = run(x=torch.cat(
                    [x[:n], x[n:].flip(0)]))
            note("conv_int8_chain", f"{name} {dt}", run(), want,
                 "int8" if out_int8 else dt, ctl)
            del ctl, want
            if dt == "bf16":
                if src == "int8":
                    q = (torch.clamp(x[:n].int() + x[n:].int(), -127, 127)
                         if fuse else x).to(torch.int8)
                else:
                    xs = x[:n] + x[n:] if fuse else x
                    q = torch.clamp(torch.round(xs.float() * invf), -127,
                                    127).to(torch.int8)
                esz_in = 1 if src == "int8" else 2
                esz_out = 1 if out_int8 else 2
                nbytes = (b_in * cin * esz_in + b_out * cout * esz_out) \
                    * H * W + qw.numel()
                ops = 2.0 * b_out * H * W * cin * cout * k * k
                q_bytes = None if src == "int8" else \
                    (b_in * cin * esz_in + b_out * -(-cin // 16) * 16) * H * W
                timing("conv_int8_chain", f"{name} {dt}", run, plain, q, qw,
                       xf[:n] + xf[n:] if fuse else xf, bias, nbytes, ops,
                       q_bytes)
                del q
            del x, xf
            torch.cuda.empty_cache()
        stamp(f"conv_int8_chain {dt} checked")

    # row 11: the ConvLayer route's layers, their legs read in place
    for dt, pairs in (("bf16", BATCH), ("f32", 1)):
        dtype = dts[dt]
        for name, cins, cout, k, act, per_pair, fuse, h, w_, *images in \
                ROW11_CASES:
            if dt == "f32" and not name.startswith("deepfuse"):
                continue
            cin = sum(cins)
            b_in = images[0] if images else pairs * per_pair
            fuse_n = b_in // 2 if fuse else 0
            b_out = fuse_n or b_in
            w, bias = layer(cin, cout, k, 300 + cin + k)
            g = torch.Generator(device=dev).manual_seed(310 + cout)
            x = ((torch.rand((b_in, h, w_, cin), generator=g, device=dev)
                  * 2 - 0.5) * _channel_spread(torch, cin, dev)).to(dtype)
            legs = [(x[..., c0:c0 + c].contiguous(), 0) for c0, c in
                    zip(np.cumsum([0] + cins[:-1]), cins)]
            xs = x[:fuse_n] + x[fuse_n:] if fuse else x   # the effective input
            del x
            f = choose_fold(xs.float().abs().amax(dim=(0, 1, 2)), w)
            qw, sw = quantize_weights(fold_weights(w, f))

            def run(qw=qw, sw=sw, legs=legs):
                return conv_int8(legs, qw, sw, f, bias, act, fuse_n)

            def plain():
                return conv_int8_plain(legs, qw, sw, f, bias, act, fuse_n)
            want = plain()
            qw0, sw0 = quantize_weights(w)
            ctl = {"fold left out": run(qw0, sw0)}
            if k > 1:
                ctl["taps transposed"] = run(qw.transpose(2, 3).contiguous())
            if fuse_n > 1:
                ctl["one half reversed"] = run(legs=[
                    (torch.cat([t[:fuse_n], t[fuse_n:].flip(0)]), 0)
                    for t, _ in legs])
            note("conv_int8", f"{name} {dt}", run(), want, dt, ctl)
            del ctl, want
            if dt == "bf16":
                q = torch.clamp(torch.round(xs.float() / f), -127, 127).to(
                    torch.int8)
                nbytes = (b_in * cin + b_out * cout) * h * w_ * 2 + qw.numel()
                ops = 2.0 * b_out * h * w_ * cin * cout * k * k
                q_bytes = (b_in * cin * 2 + b_out * -(-cin // 16) * 16) \
                    * h * w_
                timing("conv_int8", f"{name} {dt}", run, plain, q, qw, xs,
                       bias, nbytes, ops, q_bytes)
                del q
            del xs, legs
            torch.cuda.empty_cache()
        stamp(f"conv_int8 {dt} checked")
    return recs


# launches of one int8 forward (under quantized_inference), per model
INT8_FORWARD_LAUNCHES = {
    "deepfuse": {"conv_gray_enter": 1, "conv_int8_chain": 3,
                 "conv_gray_exit": 1},
    # every stride-1 conv: conv_in, the dense block's 3, dec0-dec3
    "densefuse": {"conv_int8": 8},
    # CB1_0-CB4_0, the 6 ECBs' and 6 DCBs' two convs, conv_out; the 6
    # stride-2 downs are F.conv2d
    "unfusion": {"conv_int8": 29},
    # every conv the JAX package's int8 gate admits (ops/layers.py
    # ConvLayer._int8_eligible; tests/test_torch_int8_plans.py): a batch
    # norm in conv_int8's epilogue, a group norm after it; the stride-2
    # and transpose convs (SEDRFuse) and the depthwise convs (MyFusion's
    # conv_dw: TransitionBlock's k1 dw, DCBlock's, FFN's and MixConv's
    # windows) stay float
    "ifcnn": {"conv_int8": 4},
    "difnet": {"conv_int8": 13},
    "pmgi": {"conv_int8": 13},
    "sedrfuse": {"conv_int8": 4},
    "nestfuse": {"conv_int8": 22},
    "rfnnest": {"conv_int8": 46},
    "mafusion": {"conv_int8": 16},
    "pfnetv1": {"conv_int8": 13},
    # the fuse net's three convs on the channels-into-batch fold
    "pfnetv2": {"conv_int8": 11},
    "myfusion": {"conv_int8": 26, "conv_dw": 11},
    "myfusion_sep_batch": {"conv_int8": 26, "conv_dw": 11},
    "myfusion_mixformer_ls_concat": {"conv_int8": 43, "conv_dw": 35},
    "myfusion_transformer_fs_elem": {"conv_int8": 36, "conv_dw": 8},
}
# the models and configurations whose --int8 bench, quality gap and
# kernel-vs-plain check run after the float benches: (key, model,
# configuration, pairs); MyFusion with batch norms is the sep frame
MYF_SEP_BATCH = dict(encoder="sep", norm="batch")
INT8_MODELS = (
    *((n, n, {}, BATCH) for n in ("ifcnn", "difnet", "pmgi", "sedrfuse",
                                  "nestfuse", "rfnnest")),
    ("mafusion", "mafusion", {}, MAFUSION_BATCH),
    *((n, n, {}, BATCH) for n in ("pfnetv1", "pfnetv2", "myfusion")),
    ("myfusion_sep_batch", "myfusion", MYF_SEP_BATCH, BATCH),
    ("myfusion_mixformer_ls_concat", "myfusion",
     MYF_FORMERS["myfusion_mixformer_ls_concat"], BATCH),
    ("myfusion_transformer_fs_elem", "myfusion",
     MYF_FORMERS["myfusion_transformer_fs_elem"], BATCH))


def int8_bench_path(torch, build, bench, name, key=None, net=None,
                    batch=BATCH):
    """The port's bench --int8 of `name` (`batch` pairs; `net` the built
    model whose weights it times, else the bench's own init from seed 0),
    every count set to 0 just before it. Its calibration forward is
    counted apart first (the same call on the same crop), so the counts
    must be exactly that plus INT8_FORWARD_LAUNCHES[key or name] x (warmup
    + timed)."""
    import copy
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.quant import calibrate
    model = (copy.deepcopy(net) if net is not None else create_model(
        name, generator=torch.Generator().manual_seed(0))).to(
            "cuda", torch.bfloat16).eval()
    r = np.random.RandomState(0)
    a, b = (torch.from_numpy(r.rand(1, 256, 256, 1).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(2))
    build.LAUNCHES.clear()
    calibrate(model, [(a, b)])
    cal = collections.Counter(build.LAUNCHES)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    result, last = bench.run(seed=0, model_name=name, int8=True, batch=batch,
                             model=net)
    counts = dict(build.LAUNCHES)
    want = collections.Counter({k: v * (bench.ITERS + 1) for k, v in
                                INT8_FORWARD_LAUNCHES[key or name].items()})
    want.update(cal)
    if counts != dict(want):
        raise AssertionError(f"{name} int8 bench launches {counts}, want "
                             f"{dict(want)}")
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    result["calibration_launches"] = dict(cal)
    print(f"bench {name} --int8: {json.dumps(result)}")
    return result, last, counts


def int8_quality(torch, dev, name, a16, b16, y_int8, chunk=4, make=None,
                 key=None):
    """The int8 gap to the BASELINE contract on the int8 bench's last batch,
    reported and not gated: mean SSIM and Qabf of the int8 forward against
    the f32 forward (the f32 plain path, `plain_route`: F.conv2d with TF32
    off, or the serving kernels' plain versions for a model with batch
    norms) and the bf16 kernel forward of the same weights (`make()`, a
    fresh copy of the bench's model; default the seed-0 init). DeepFuse
    also with MMIF_HIW_INT8_RES=0 (calibrated as the bench calibrates, on
    the first pair's 256x256 crop of this batch)."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.quant import (
        calibrate, quantized_inference)
    label = key or name
    make = make or (lambda: create_model(
        name, generator=torch.Generator().manual_seed(0)))
    m32, m16 = (make().to(dev, dt).eval()
                for dt in (torch.float32, torch.bfloat16))
    variants = {"int8": None}
    if name == "deepfuse":
        amax = calibrate(m16, [(a16[:1, :256, :256], b16[:1, :256, :256])])
        variants = {"int8_res1": "1", "int8_res0": "0"}
    vals = {k: [] for k in (*variants, "f32", "bf16")}
    with torch.no_grad():
        for lo in range(0, a16.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            x1, x2 = a16[sl].float(), b16[sl].float()
            with plain_route(label):
                ys = {"f32": m32(x1, x2)}
            ys["bf16"] = m16(a16[sl], b16[sl]).float()
            for key, flag in variants.items():
                if flag is None:
                    ys[key] = y_int8[sl].float()
                    continue
                with switches({"MMIF_HIW_INT8_RES": flag}), \
                        quantized_inference(amax):
                    ys[key] = m16(a16[sl], b16[sl]).float()
            for key, y in ys.items():
                vals[key].append(torch.stack(ssim_qabf(torch, x1, x2, y)))
            del ys
    means = {k: torch.cat(v, 1).mean(1).tolist() for k, v in vals.items()}
    rec = {"ssim": {k: v[0] for k, v in means.items()},
           "qabf": {k: v[1] for k, v in means.items()},
           "pairs": int(a16.shape[0]), "gated": False}
    for key in variants:
        if not all(np.isfinite(means[key])):
            raise AssertionError(f"{name} {key}: non-finite quality {means}")
        for ref in ("f32", "bf16"):
            rec[f"{key}_vs_{ref}"] = {
                "d_ssim": abs(means[key][0] - means[ref][0]),
                "d_qabf": abs(means[key][1] - means[ref][1])}
    print(f"int8 quality {label}: {json.dumps(rec)}")
    return rec


def int8_vs_plain(torch, model, pairs, amax):
    """(largest max, largest mean) over `pairs` of |kernels - plain| / max
    |plain| of `model`'s int8 forward under quantized_inference(amax), the
    plain int8 path (`plain_int8`) the reference."""
    from multi_modal_image_fusion_tpu_torch.ops.quant import \
        quantized_inference
    worst_max = worst_mean = 0.0
    with torch.no_grad(), quantized_inference(amax):
        for a, b in pairs:
            y = model(a, b).float()
            with plain_int8():
                yp = model(a, b).float()
            scale = float(yp.abs().max())
            d = (y - yp).abs()
            worst_max = max(worst_max, float(d.max()) / scale)
            worst_mean = max(worst_mean, float(d.mean()) / scale)
    return worst_max, worst_mean


def int8_plain_check(torch, dev, key, net, a16, b16):
    """The int8 kernels against the plain int8 path (`plain_int8`: the
    exact integer conv and the same f32 epilogue) on the card, the bf16
    model `net` on the first two pairs of an int8 bench's last batch,
    calibrated as the bench calibrates (the first pair's 256x256 crop),
    within tests/test_int8.py:121-128's model tolerance (max <= 2e-2,
    mean <= 1e-4 of max|y|). Returns the record."""
    from multi_modal_image_fusion_tpu_torch.ops.quant import calibrate
    pairs = 2
    model = net.to(dev, torch.bfloat16).eval()
    amax = calibrate(model, [(a16[:1, :256, :256].contiguous(),
                              b16[:1, :256, :256].contiguous())])
    worst_max, worst_mean = int8_vs_plain(
        torch, model, [(a16[i:i + 1], b16[i:i + 1]) for i in range(pairs)],
        amax)
    if not (worst_max <= 2e-2 and worst_mean <= 1e-4):
        raise AssertionError(f"{key} --int8: kernels vs plain int8 max "
                             f"{worst_max}, mean {worst_mean} of max|y|")
    rec = {"pairs": pairs, "max_rel": worst_max, "mean_rel": worst_mean}
    print(f"int8 kernels vs plain ({key}): {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def plain_int8():
    """Route ConvLayer's int8 kernels through their plain versions on the
    card too (the plain int8 path, the CLI check's reference)."""
    from multi_modal_image_fusion_tpu_torch.ops import layers
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_int8 import (
        conv_int8_chain_plain, conv_int8_plain)
    kernels = layers.conv_int8, layers.conv_int8_chain
    # ConvLayer hands the kernels its cached packing (`weights`), which the
    # plain versions do not take
    layers.conv_int8 = lambda *a, weights=None, **kw: conv_int8_plain(*a, **kw)
    layers.conv_int8_chain = lambda *a, weights=None, **kw: \
        conv_int8_chain_plain(*a, **kw)
    try:
        yield
    finally:
        layers.conv_int8, layers.conv_int8_chain = kernels


INT8_CLI_PLAIN_PAIRS = 6   # pairs held against the plain int8 path


def int8_cli_path(torch, build, test_cli, root, dev, float_ssim):
    """The port's test CLI --int8 (DeepFuse, f32) on the phase-4 fixture's
    51 pairs, every count set to 0 just before it: the calibrated count it
    prints, ms a pair, its SSIM beside the float run's, exact launch counts
    (4 calibration forwards through the float kernels, then 1 enter + 3
    conv_int8_chain + 1 exit a pair, 2 ssim_maps a pair); then the kernel
    path against the plain int8 path on the card over the first pairs,
    within tests/test_int8.py:121-128's model tolerance (max <= 2e-2, mean
    <= 1e-4 of max|y|), on the CLI's calibration."""
    from multi_modal_image_fusion_tpu_torch.data.dataset import \
        FusionDataset
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.quant import calibrate
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import restore
    build.LAUNCHES.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ssim, avg = test_cli.main([
            "--data", "synth", "--data_root", os.path.join(root, "data"),
            "--ckpt_root", os.path.join(root, "ckpt"), "--ckpt", "run",
            "--int8"])
    counts = dict(build.LAUNCHES)
    text = out.getvalue()
    m = re.search(r"^int8: calibrated (\d+) conv layers on (\d+) image "
                  r"pairs$", text, re.M)
    if m is None or m.groups() != ("5", "4"):
        raise AssertionError(f"test CLI --int8 printed no (or another) "
                             f"calibration line: {m and m.group(0)}")
    want = {"conv_gray_enter": 4 + CLI_PAIRS, "conv_chain": 3 * 4,
            "conv_gray_exit": 4 + CLI_PAIRS,
            "conv_int8_chain": 3 * CLI_PAIRS, "ssim_maps": 2 * CLI_PAIRS}
    if counts != want:
        raise AssertionError(f"test CLI --int8 launches {counts}, want "
                             f"{want}")
    iter_ms = [float(v) for v in re.findall(
        r"^iter: \d+, .*time: ([\d.]+)ms$", text, re.M)][1:]
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(0))
    restore(model, os.path.join(root, "ckpt", "run", "epoch_best.pth"))
    model = model.to(dev).eval()
    ds = FusionDataset(os.path.join(root, "data", "synth"), "test", "test",
                       "ir")
    pairs = [tuple(torch.from_numpy(v)[None, ..., None].to(dev)
                   for v in ds[i]) for i in range(INT8_CLI_PLAIN_PAIRS)]
    worst_max, worst_mean = int8_vs_plain(torch, model, pairs,
                                          calibrate(model, pairs[:4]))
    if not (np.isfinite(ssim) and worst_max <= 2e-2
            and worst_mean <= 1e-4):
        raise AssertionError(f"test CLI --int8: SSIM {ssim}; kernel vs "
                             f"plain int8 max {worst_max}, mean "
                             f"{worst_mean} of max|y|")
    rec = {"pairs": CLI_PAIRS, "calibrated_layers": 5,
           "calibration_pairs": 4, "ssim": ssim, "ssim_float": float_ssim,
           "d_ssim_float": abs(ssim - float_ssim), "mean_ms": avg * 1e3,
           "median_ms": float(np.median(iter_ms)),
           "kernel_vs_plain_max_rel": worst_max,
           "kernel_vs_plain_mean_rel": worst_mean,
           "plain_checked_pairs": INT8_CLI_PLAIN_PAIRS}
    print(f"test CLI --int8: {json.dumps(rec)}")
    return rec, counts


# ---------------------------------------------------------------------------
# DeepFuse's opt-in chain routes: conv_pair (row 10), conv_wide's s2d mode
# (row 9) and s2d_enter / s2d_exit (rows 13-14)
# ---------------------------------------------------------------------------

VARIANT_REPLACES = {
    "conv_pair_enter": "multi_modal_image_fusion_tpu/ops/pallas/"
                       "conv_kernel.py:970 (conv_tlane_chain_pair, enc0 + "
                       "enc1; pallas_call :1036)",
    "conv_pair_exit": "multi_modal_image_fusion_tpu/ops/pallas/"
                      "conv_kernel.py:970 (conv_tlane_chain_pair, dec1 + "
                      "dec2; pallas_call :1036)",
    "conv_wide_s2d": "multi_modal_image_fusion_tpu/ops/pallas/"
                     "conv_kernel.py:719 (conv_tlane_chain, s2d_f=2; "
                     "pallas_call :799)",
    "s2d_enter": "multi_modal_image_fusion_tpu/ops/pallas/s2d_io.py:155 "
                 "(s2d_chain_enter; pallas_call :171)",
    "s2d_exit": "multi_modal_image_fusion_tpu/ops/pallas/s2d_io.py:249 "
                "(s2d_chain_exit; pallas_call :260)",
}
VARIANT_SOURCES = {
    "conv_pair_enter": "multi_modal_image_fusion_tpu_torch/csrc/conv_pair.cu",
    "conv_pair_exit": "multi_modal_image_fusion_tpu_torch/csrc/conv_pair.cu",
    "conv_wide_s2d": "multi_modal_image_fusion_tpu_torch/csrc/conv_wide.cu",
    "s2d_enter": "multi_modal_image_fusion_tpu_torch/csrc/s2d_io.cu",
    "s2d_exit": "multi_modal_image_fusion_tpu_torch/csrc/s2d_io.cu",
}
# The pair and the packed conv are held to conv_wide's tolerance (WIDE_TOL,
# relative to max|y| of the plain version): f32 1e-4 (the same f32 products
# summed in another order); bf16 1e-3 beyond one bf16 ulp of each output
# (a single conv rounds an f32 sum to bf16, and another summation order can
# land on the neighbouring value; in the pair the mid is rounded to bf16 on
# both sides, and a one-ulp flip of a mid value moves an output by |w| x
# 2^-8 of one of its 400-784 terms, far inside 1e-3 of max|y|). Each has a
# control that must miss by 10x: the pair with the mid's halo computed as
# conv_a over the reflect-extended input; the packed conv with the
# phase-blind reflect of the packed tensor (conv_wide without s2d mode).
# s2d_enter and s2d_exit move values: bit for bit, and the control (the
# pack with the px phases swapped) must differ.
# DeepFuse's packed layers: (name, c_in, c_out, k, act, fuse_n) of the
# original layer; they run at (H/2, W/2) on 4x the channels, k5 -> k3 and
# k7 -> k5.
S2D_LAYERS = [("enc0", 1, 16, 5, "relu", False),
              ("enc1", 16, 32, 7, "relu", False),
              ("dec0", 32, 32, 7, "relu", True),
              ("dec1", 32, 16, 5, "relu", False),
              ("dec2", 16, 1, 5, None, False)]


def _extended_mid(torch, F, x, wa, ba, wb, bb, act_b):
    """The pair's control: conv_a over the input reflect-padded by pa + pb
    (the mid's halo not mirrored), cast, then conv_b VALID; in batch
    chunks under 2^31 elements."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import (
        apply_act, batch_step)
    p = wa.shape[-1] // 2 + wb.shape[-1] // 2
    b, h, w, c = x.shape
    step = batch_step(h + 2 * p, w + 2 * p, max(c, 32), 1)
    outs = []
    for i in range(0, b, step):
        xp = F.pad(x[i:i + step].float().permute(0, 3, 1, 2), (p,) * 4,
                   mode="reflect")
        mid = apply_act(F.conv2d(xp, wa.float(), ba), "relu").to(x.dtype)
        y = apply_act(F.conv2d(mid.float(), wb.float(), bb), act_b)
        outs.append(y.permute(0, 2, 3, 1).to(x.dtype))
        del xp, mid
    return torch.cat(outs)


def check_variants(torch, F, dev, timer):
    """Phase 3 for rows 10, 13, 14 and row 9's s2d mode, at 1224x1024: the
    bf16 bench's 16 pairs and the f32 test CLI's one pair, each kernel
    against its plain version with its control (see S2D_LAYERS' comment),
    and at the bench's shape the kernel, the plain version and the
    library: two F.conv2d for a pair (the pads and the mid's cast timed
    apart), one F.conv2d on the per-phase padded packed input (the pad
    timed apart), F.pixel_unshuffle / F.pixel_shuffle for rows 13-14 (the
    concat and the NHWC permute timed apart). Returns {kernel: record}."""
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_chain import \
        apply_act
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_pair import (
        ENTER_SHAPES, EXIT_SHAPES, conv_pair_enter, conv_pair_exit,
        conv_pair_plain, pair_tile)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.conv_wide import (
        conv_wide, conv_wide_into, conv_wide_plain)
    from multi_modal_image_fusion_tpu_torch.ops.cuda.s2d_io import (
        s2d_enter, s2d_enter_plain, s2d_exit, s2d_exit_plain)
    from multi_modal_image_fusion_tpu_torch.ops.s2d import (
        s2d_pack_bias, s2d_pack_weights, s2d_reflect_pad)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    recs = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                   "min_control_rel_err": float("inf"),
                   "tolerance_rel": WIDE_TOL, "layers": {}}
            for name in VARIANT_REPLACES}
    for name in ("s2d_enter", "s2d_exit"):
        recs[name]["tolerance_rel"] = "bit for bit"

    def note(kern, key, got, want, dt, ctl, what):
        r = recs[kern]
        err, rel = _wide_rel(torch, got, want, dt)
        if rel > WIDE_TOL[dt]:
            raise AssertionError(f"{kern} {key}: max err {err} is {rel:.3g} "
                                 f"of max|y|, above {WIDE_TOL[dt]}")
        c = _wide_rel(torch, ctl, want, dt)[1]
        if c <= 10 * WIDE_TOL[dt]:
            raise AssertionError(f"{kern} {key}: the control ({what}) misses "
                                 f"by {c:.3g} only")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        r["min_control_rel_err"] = min(r["min_control_rel_err"], c)
        print(f"{kern} {key}: err {rel:.3g}, control ({what}) {c:.3g} "
              f"(tolerance {WIDE_TOL[dt]})", flush=True)

    # row 10: the two pairs
    for kind, shapes in (("enter", ENTER_SHAPES), ("exit", EXIT_SHAPES)):
        kern = f"conv_pair_{kind}"
        for dt, pairs in (("bf16", BATCH), ("f32", 1)):
            dtype = dts[dt]
            (wa, ba), (wb, bb) = [
                ((_rand(torch, s, 400 + i, dev, torch.float32, -0.5, 2.0)
                  / np.sqrt(s[1] * s[2] * s[3])).to(dtype),
                 _rand(torch, (s[0],), 410 + i, dev, torch.float32, -0.5,
                       0.2))
                for i, s in enumerate(shapes)]
            act_b = "relu" if kind == "enter" else None
            args = (wa, ba, "relu", wb, bb, act_b)
            if kind == "enter":
                a = _rand(torch, (pairs, H, W, 1), 1, dev, dtype)
                b = _rand(torch, (pairs, H, W, 1), 2, dev, dtype)
                x = torch.cat([a, b])

                def run():
                    return conv_pair_enter(a, b, *args)
            else:
                x = _rand(torch, (pairs, H, W, 32), 420, dev, dtype, -0.5, 2.0)

                def run():
                    return conv_pair_exit(x, *args)

            def plain():
                return conv_pair_plain(x, *args)
            key = f"{x.shape[0]}x{H}x{W}x{x.shape[-1]} {dt}"
            got, want = run(), plain()
            ctl = _extended_mid(torch, F, x, wa, ba, wb, bb, act_b)
            note(kern, key, got, want, dt, ctl, "mid halo over the "
                 "extended input")
            # the second control: the fix-up left out on the bottom-right
            # tile of the bf16 walk only
            _, n_t = pair_tile(kind, 1, H, W, 0)
            (_, ty0, tx0, _, _), _ = pair_tile(kind, 1, H, W, n_t - 1)
            c2 = _wide_rel(torch, ctl[:, ty0:, tx0:], want[:, ty0:, tx0:],
                           dt)[1] * float(want[:, ty0:, tx0:].float().abs()
                                          .max()) / float(want.float().abs()
                                                          .max())
            if c2 <= 10 * WIDE_TOL[dt]:
                raise AssertionError(f"{kern} {key}: the corner control "
                                     f"misses by {c2:.3g} only")
            recs[kern]["min_corner_control_rel_err"] = min(
                recs[kern].get("min_corner_control_rel_err", float("inf")),
                c2)
            print(f"{kern} {key}: corner control (no fix-up on the "
                  f"bottom-right tile) {c2:.3g}", flush=True)
            del got, want, ctl
            torch.cuda.empty_cache()
            # FLOP a pixel: 2 (k_a^2 c_in c_mid + k_b^2 c_mid c_out)
            px = x.shape[0] * H * W
            flops = 2.0 * px * sum(s[1] * s[2] * s[3] * s[0] for s in shapes)
            esz = 2 if dt == "bf16" else 4
            nbytes = px * (x.shape[-1] + shapes[1][0]) * esz
            bound, by = _bound(nbytes, flops, dt)
            pa, pb = shapes[0][-1] // 2, shapes[1][-1] // 2
            xn = x.permute(0, 3, 1, 2)
            xa = F.pad(xn, (pa,) * 4, mode="reflect")
            mid = apply_act(F.conv2d(xa, wa, ba.to(dtype)), "relu")
            midp = F.pad(mid, (pb,) * 4, mode="reflect")
            recs[kern]["layers"][key] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: (F.conv2d(xa, wa, ba.to(dtype)),
                                             F.conv2d(midp, wb,
                                                      bb.to(dtype)))),
                "library_calls": 2,
                "library_pad_act_ms": timer(lambda: (
                    F.pad(xn, (pa,) * 4, mode="reflect"),
                    F.pad(torch.relu(mid), (pb,) * 4, mode="reflect"))),
                "bound_ms": bound, "bound_by": by,
                "shape": f"{key} k{shapes[0][-1]}+k{shapes[1][-1]}"}
            del xa, mid, midp, xn, x, run, plain
            torch.cuda.empty_cache()
        stamp(f"{kern} checked")

    # row 9's s2d mode: DeepFuse's five packed layers
    hp, wp_ = H // 2, W // 2
    for dt, pairs in (("bf16", BATCH), ("f32", 1)):
        dtype = dts[dt]
        for name, cin, cout, k, act, fuse in S2D_LAYERS:
            b_in = 2 * pairs if name in ("enc0", "enc1", "dec0") else pairs
            fuse_n = pairs if fuse else 0
            n = b_in - fuse_n
            x = _rand(torch, (b_in, hp, wp_, 4 * cin), 430 + cin, dev, dtype,
                      -0.5, 2.0)
            wt = (_rand(torch, (cout, cin, k, k), 431 + cout, dev, torch.float32,
                        -0.5, 2.0) / np.sqrt(cin * k * k)).to(dtype)
            bias = _rand(torch, (cout,), 432, dev, torch.float32, -0.5, 0.2)
            wpk, bpk = s2d_pack_weights(wt), s2d_pack_bias(bias)
            kp = wpk.shape[-1]

            def run():
                return conv_wide([(x, 0)], wpk, bpk, act, fuse_n, s2d_f=2)

            def plain():
                return conv_wide_plain([(x, 0)], wpk, bpk, act, fuse_n,
                                       s2d_f=2)
            key = f"{name} {dt}"
            got, want = run(), plain()
            note("conv_wide_s2d", key, got, want, dt,
                 conv_wide([(x, 0)], wpk, bpk, act, fuse_n),
                 "phase-blind reflect")
            if 4 * cout % 8:
                # 8-byte stores that stop at Cout: the output in the head of
                # a buffer one image longer, the sentinel past it untouched
                buf = torch.full((n + 1, hp, wp_, 4 * cout), 1234.0,
                                 dtype=dtype, device=dev)
                conv_wide_into(buf[:n], [(x, 0)], wpk, bpk, act, fuse_n,
                               s2d_f=2)
                if not (torch.equal(buf[:n], got)
                        and bool((buf[n] == 1234.0).all())):
                    raise AssertionError(f"conv_wide_s2d {key}: the output "
                                         f"buffer's sentinel past Cout was "
                                         f"written")
                recs["conv_wide_s2d"]["sentinel_untouched"] = True
            del got, want
            xin = x[:n] + x[n:] if fuse_n else x
            esz = 2 if dt == "bf16" else 4
            nbytes = ((b_in * 4 * cin + n * 4 * cout) * hp * wp_
                      + wpk.numel()) * esz
            flops = 2.0 * n * hp * wp_ * (4 * cin) * (4 * cout) * kp * kp
            bound, by = _bound(nbytes, flops, dt)
            xpad = s2d_reflect_pad(xin, kp // 2).permute(0, 3, 1, 2)
            bl = bpk.to(dtype)
            recs["conv_wide_s2d"]["layers"][key] = {
                "ms": timer(run), "plain_ms": timer(plain),
                "library_ms": timer(lambda: F.conv2d(xpad, wpk, bl)),
                "library_pad_ms": timer(lambda: s2d_reflect_pad(
                    xin, kp // 2)),
                "bound_ms": bound, "bound_by": by,
                **_tc_block(4 * cout, [4 * cin], kp, dt, fuse_n),
                "shape": f"{b_in}x{hp}x{wp_}x{4 * cin} fuse_n {fuse_n} -> "
                         f"{n}x{hp}x{wp_}x{4 * cout} k{kp} {dt}"}
            del x, xin, xpad, run, plain
            torch.cuda.empty_cache()
        stamp(f"conv_wide s2d {dt} checked")

    # rows 13-14: bit for bit, both image dtypes and both chain dtypes
    for in_dt, out_dt, pairs in (("bf16", "bf16", BATCH),
                                 ("f32", "bf16", 2), ("f32", "f32", 1)):
        a = _rand(torch, (pairs, H, W, 1), 5, dev, dts[in_dt])
        b = _rand(torch, (pairs, H, W, 1), 6, dev, dts[in_dt])
        t = s2d_enter(a, b, dts[out_dt])
        want = s2d_enter_plain(a, b, dts[out_dt])
        y = s2d_exit(t)
        if not (torch.equal(t, want) and torch.equal(y, s2d_exit_plain(t))
                and torch.equal(y, torch.cat([a, b]).to(dts[out_dt]))):
            raise AssertionError(f"s2d_enter/exit {in_dt}->{out_dt}: not "
                                 f"equal to the plain pack and unpack")
        diff = int((t != want[..., [1, 0, 3, 2]]).sum())
        if diff == 0:
            raise AssertionError("s2d_enter: the control (px phases "
                                 "swapped) equals the kernel")
        for kern in ("s2d_enter", "s2d_exit"):
            recs[kern]["min_control_rel_err"] = min(
                recs[kern]["min_control_rel_err"],
                float((t - want[..., [1, 0, 3, 2]]).abs().max()
                      / want.abs().max()))
        if in_dt != "bf16":
            continue
        esz = 2
        px = 2 * pairs * H * W
        x = torch.cat([a, b]).permute(0, 3, 1, 2)     # NCHW, one channel
        recs["s2d_enter"]["layers"][f"{2 * pairs}x{H}x{W} bf16"] = {
            "ms": timer(lambda: s2d_enter(a, b, torch.bfloat16)),
            "plain_ms": timer(lambda: s2d_enter_plain(a, b,
                                                      torch.bfloat16)),
            "library_ms": timer(lambda: F.pixel_unshuffle(x, 2)),
            "library_concat_ms": timer(lambda: torch.cat([a, b])),
            "library_permute_ms": timer(
                lambda: F.pixel_unshuffle(x, 2).permute(0, 2, 3, 1)
                .contiguous()),
            "bound_ms": 2 * px * esz / PEAK_BYTES_S * 1e3,
            "bound_by": "bytes",
            "shape": f"2 x {pairs}x{H}x{W}x1 -> {2 * pairs}x{H // 2}x"
                     f"{W // 2}x4 bf16"}
        tq = t[:pairs].contiguous()                   # the fused images
        tn = tq.permute(0, 3, 1, 2).contiguous()
        recs["s2d_exit"]["layers"][f"{pairs}x{H}x{W} bf16"] = {
            "ms": timer(lambda: s2d_exit(tq)),
            "plain_ms": timer(lambda: s2d_exit_plain(tq)),
            "library_ms": timer(lambda: F.pixel_shuffle(tn, 2)),
            "library_permute_ms": timer(
                lambda: tq.permute(0, 3, 1, 2).contiguous()),
            "bound_ms": 2 * pairs * H * W * esz / PEAK_BYTES_S * 1e3,
            "bound_by": "bytes",
            "shape": f"{pairs}x{H // 2}x{W // 2}x4 -> {pairs}x{H}x{W}x1 "
                     f"bf16"}
        del x, tq, tn
    for kern in ("s2d_enter", "s2d_exit"):
        recs[kern]["max_abs_err"] = recs[kern]["max_rel_err"] = 0.0
    torch.cuda.empty_cache()
    stamp("s2d_enter and s2d_exit checked")
    return recs


# DeepFuse's opt-in routes: the switches and the launches of one forward
VARIANTS = {
    "deepfuse_pair": {"MMIF_CHAIN_PAIR": "1"},
    "deepfuse_s2d": {"MMIF_S2D": "1", "MMIF_CHAIN_HIW": "0"},
    "deepfuse_s2d_io": {"MMIF_S2D": "1", "MMIF_CHAIN_HIW": "0",
                        "MMIF_S2D_IO": "1"},
}
FORWARD_LAUNCHES["deepfuse_pair"] = {"conv_pair_enter": 1, "conv_chain": 1,
                                     "conv_pair_exit": 1}
FORWARD_LAUNCHES["deepfuse_s2d"] = {"conv_wide": 5, "conv_wide/s2d": 5}
FORWARD_LAUNCHES["deepfuse_s2d_io"] = {"s2d_enter": 1, "conv_wide": 5,
                                       "conv_wide/s2d": 5, "s2d_exit": 1}
INT8_FORWARD_LAUNCHES["deepfuse_pair"] = FORWARD_LAUNCHES["deepfuse_pair"]


@contextlib.contextmanager
def switches(env):
    """Set environment switches for the block, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# phase "parallel": data parallelism (parallel/mesh.py, the Trainer's
# collectives, the batch norms' global statistics) and single-card height
# tiling (parallel/tiling.py)
# ---------------------------------------------------------------------------

DIST_SCHED = (1e-4, 10, 12)
# a rank's step against the one-process step on the global batch (JAX
# tests/test_parallel.py:29-50; on the card the one-process step replays
# the ranks' piecewise decisions: `ddp_two_rank_path`): the loss within
# DIST_LOSS_TOL, the
# averaged gradients within DIST_GRAD_TOL of the largest gradient, the
# parameters after the update within DIST_PARAM_TOL where their gradient
# passes DIST_GRAD_TOL of the largest and within 2 lr where it is rounding
# noise (Adam's first step moves a parameter by lr g / (|g| + eps), either
# way for a gradient that is zero in exact arithmetic: a conv bias under a
# batch norm; tests/test_torch_step_common.py's rule), the running
# statistics within DIST_STATS_TOL of their largest magnitude; the
# controls (no gradient all-reduce, per-rank batch statistics) must miss
# by 10x
DIST_LOSS_TOL, DIST_GRAD_TOL, DIST_PARAM_TOL, DIST_STATS_TOL = (
    1e-6, 1e-5, 1e-5, 1e-5)
DIST_CONTROLS = {"no_grad_sync": "all-reduce of the gradients removed",
                 "local_stats": "each rank's batch statistics its own"}
# height tiling on the card: f32 within TILE_TOL of max|y|; bf16 the chain
# standard (CHAIN_TOL, beyond one bf16 ulp of each output). The models of
# TILE_CUDNN run stride-2 convs on cuDNN, which picks its algorithm per
# shape: in bf16 UNFusion's encode.down2 (96 channels to scale 8) summed a
# slab in another order than the whole image and rounded 5.7e-5 of its
# outputs to the neighbouring bf16 value (every layer before it bit for
# bit; measured on one H100), which its deeper layers carry to 7.4e-3
# of max|y|. Their bf16 tiled output is held against the f32 whole
# forward instead: no farther from it than the bf16 whole output, its
# largest difference within CHAIN_TOL of max|y| more and its mean within
# 5 % more.
TILES, TILE_TOL = 4, 1e-5
TILE_MODELS = ("deepfuse", "mafusion", "unfusion", "res2fusion")
TILE_CUDNN = ("unfusion",)
# the models whose bf16 tiled forward is profiled beside the whole one:
# the slabs' bilinear upsamples (the span "tiled_bilinear", each a whole-
# height F.interpolate a channel chunk) against the conv kernels
TILE_PROFILED = ("mafusion", "unfusion")
TILE_CLI_MODEL, TILE_CLI_PAIRS = "unfusion", 3


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_rank(spec_path):
    """One rank of the data-parallel step check, in a process of its own
    under the env contract (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT):
    joins the gloo process group (`init_multihost(backend="gloo")`; two
    ranks may share one card), and for each case of the spec loads the
    model's state, broadcasts rank 0's, takes its slice of the global
    batch (`shard_batch`) and runs one Trainer step, recording the loss
    parts, the gradients as the step hands them to its update (averaged
    over the ranks), the parameters and buffers after it and the kernel
    launches, and where the case asks (`branches`) the piecewise decisions
    of its forward and loss (train/branches.py); then `timed_steps` more
    steps, each timed on the host clock between barriers. A case's
    `control` removes the gradient all-reduce or the global batch
    statistics. Writes <out>/<key>.rank<r>.pt."""
    import statistics
    from unittest import mock

    import torch
    import torch.distributed as dist
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops import layers
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build
    from multi_modal_image_fusion_tpu_torch.parallel import mesh
    from multi_modal_image_fusion_tpu_torch.train import trainer as tmod
    from multi_modal_image_fusion_tpu_torch.train.branches import Decisions
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    dev = mesh.init_multihost(spec["device"], backend="gloo")
    r = mesh.rank()
    data = np.load(spec["batch"])
    batch = tuple(torch.from_numpy(mesh.shard_batch(data[k])).to(dev)
                  for k in ("x1", "x2"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
    controls = {
        "no_grad_sync": lambda: mock.patch.object(
            tmod, "all_reduce_mean", lambda ts: list(ts)),
        "local_stats": lambda: mock.patch.object(
            layers, "_batch_moments",
            lambda xf: torch.var_mean(xf, dim=(0, 1, 2), correction=0))}
    try:
        for case in spec["cases"]:
            model = create_model(case["model"])
            model.load_state_dict(torch.load(case["state"],
                                             weights_only=True))
            model.to(dev)
            trainer = tmod.Trainer(model, make_lr_schedule(*DIST_SCHED),
                                   fast=case["fast"])
            mesh.broadcast_module(model)
            seen = {}
            update = trainer._update

            def spy(grads, trainer=trainer, seen=seen, update=update):
                seen.update(zip(trainer.params,
                                (g.detach().cpu() for g in grads)))
                return update(grads)
            trainer._update = spy
            ctl = case.get("control")
            branches = Decisions() if case.get("branches") else None
            with (controls[ctl]() if ctl else contextlib.nullcontext()):
                build.LAUNCHES.clear()
                with open_branches(trainer, branches):
                    parts, _ = trainer.train_step(batch)
                sync()
                rec = {
                    "parts": {k: float(v) for k, v in parts.items()},
                    "grads": dict(seen),
                    "params": {n: p.detach().cpu().clone() for n, p in
                               trainer.params.items()},
                    "buffers": {n: b.detach().cpu().clone() for n, b in
                                model.state_dict().items() if n.endswith(
                                    ("running_mean", "running_var"))},
                    "launches": dict(build.LAUNCHES),
                    "branches": [(k, d.cpu()) for k, d in
                                 (branches.log if branches else ())]}
                step_ms = []
                for _ in range(0 if ctl else spec.get("timed_steps", 0)):
                    t0 = time.perf_counter()
                    trainer.train_step(batch)
                    sync()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            rec["step_ms"] = statistics.median(step_ms) if step_ms else None
            torch.save(rec, os.path.join(spec["out"],
                                         f"{case['key']}.rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(spec, world=2, timeout=600):
    """Run `dist_rank` in `world` processes of this interpreter (the
    checkout's root as their working directory), each under the env
    contract with a free port; waits for all and raises with their
    output's tail if one fails. Every process it starts has ended when
    it returns."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = str(free_port())
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.dist_rank(sys.argv[1])", path],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, out[-4000:])
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError(f"data-parallel ranks failed: {failed}")


@contextlib.contextmanager
def open_branches(trainer, branches):
    """The Decisions mode `branches` (None: nothing) open around each
    forward and loss of `trainer`'s steps, not around their backward."""
    if branches is None:
        yield
        return
    apply, loss = trainer._apply, trainer.loss_bundle

    def inside(fn):
        def run(*args, **kwargs):
            with branches:
                return fn(*args, **kwargs)
        return run
    trainer._apply, trainer.loss_bundle = inside(apply), inside(loss)
    try:
        yield
    finally:
        trainer._apply, trainer.loss_bundle = apply, loss


def one_rank_step(torch, name, state, fast, x1, x2, dev, branches=None):
    """The step `dist_rank` records, with no process group: one Trainer
    step on the whole global batch; `branches` (a Decisions mode) records
    its piecewise decisions or replays another step's."""
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    model = create_model(name)
    model.load_state_dict(state)
    model.to(dev)
    trainer = Trainer(model, make_lr_schedule(*DIST_SCHED), fast=fast)
    seen = {}
    update = trainer._update

    def spy(grads):
        seen.update(zip(trainer.params, (g.detach().cpu() for g in grads)))
        return update(grads)
    trainer._update = spy
    with open_branches(trainer, branches):
        parts, _ = trainer.train_step((torch.from_numpy(x1).to(dev),
                                       torch.from_numpy(x2).to(dev)))
    return {"parts": {k: float(v) for k, v in parts.items()},
            "grads": seen,
            "params": {n: p.detach().cpu()
                       for n, p in trainer.params.items()},
            "buffers": {n: b.detach().cpu()
                        for n, b in model.state_dict().items()
                        if n.endswith(("running_mean", "running_var"))}}


def dist_errors(got, want, under_norm=()):
    """How far a rank's step lies from the one-process step: the loss's
    absolute difference; the gradients' largest difference over the
    largest gradient ("grads", the parameter it is at "grads_worst"; of
    them the conv biases a norm follows, named in `under_norm`,
    "grads_under_norm", the others "grads_rest"); the parameters' largest
    difference where the gradient passes DIST_GRAD_TOL of the largest
    ("params") and where it does not ("params_noise"); the running
    statistics' largest difference over their largest magnitude."""
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    gerr = {n: float((got["grads"][n] - g).abs().max()) / gmax
            for n, g in want["grads"].items()}
    worst = max(gerr, key=gerr.get)
    smax = max([float(b.abs().max()) for b in want["buffers"].values()]
               + [1e-30])
    params, noise = 0.0, 0.0
    for n, p in want["params"].items():
        d = (got["params"][n] - p).abs()
        live = want["grads"][n].abs() > DIST_GRAD_TOL * gmax
        params = max(params, float(d[live].max()) if live.any() else 0.0)
        noise = max(noise, float(d[~live].max()) if (~live).any() else 0.0)
    return {
        "loss": abs(got["parts"]["loss"] - want["parts"]["loss"]),
        "grads": gerr[worst], "grads_worst": worst,
        "grads_under_norm": max([gerr[n] for n in gerr if n in under_norm]
                                + [0.0]),
        "grads_rest": max([gerr[n] for n in gerr if n not in under_norm]
                          + [0.0]),
        "params": params, "params_noise": noise,
        "stats": max([float((got["buffers"][n] - b).abs().max())
                      for n, b in want["buffers"].items()] + [0.0]) / smax}


def dist_within(err):
    """True when every error of `dist_errors` is within its tolerance."""
    return (err["loss"] <= DIST_LOSS_TOL and err["grads"] <= DIST_GRAD_TOL
            and err["params"] <= DIST_PARAM_TOL
            and err["params_noise"] <= 2 * DIST_SCHED[0]
            and err["stats"] <= DIST_STATS_TOL)


def dist_missed_by(err, factor=10.0):
    """True when an error of `dist_errors` passes `factor` times its
    tolerance (a control)."""
    return (err["loss"] > factor * DIST_LOSS_TOL
            or err["grads"] > factor * DIST_GRAD_TOL
            or err["params"] > factor * DIST_PARAM_TOL
            or err["stats"] > factor * DIST_STATS_TOL)


# the 2-rank check's cases: (key, model, --fast_train, control), the CPU
# test's (tests/test_torch_dist.py): DeepFuse through the conv_valid
# kernels, IFCNN (batch norms) on F.conv2d and through the conv_valid
# kernels (--fast_train, the reference's own training mode)
DIST_CASES = (("deepfuse", "deepfuse", True, None),
              ("ifcnn", "ifcnn", False, None),
              ("ifcnn_fast", "ifcnn", True, None),
              ("deepfuse_no_grad_sync", "deepfuse", True, "no_grad_sync"),
              ("ifcnn_local_stats", "ifcnn", False, "local_stats"))


def ranks_branches(torch, got, b):
    """The global batch's piecewise decisions from the ranks' records of
    their slices of b images each: every decision of these steps has the
    batch first, m groups of it (m = 2 where a model's encoder runs on the
    two modalities' images concatenated), so a rank's (m b, ...) becomes
    (m, b, ...), the ranks join on the second axis, and the result is
    (m B, ...) again."""
    out = []
    for i, (kind, d) in enumerate(got[0]["branches"]):
        m = d.shape[0] // b
        parts = [g["branches"][i][1].reshape(m, b, *d.shape[1:])
                 for g in got]
        out.append((kind, torch.cat(parts, dim=1).reshape(
            m * b * len(got), *d.shape[1:])))
    return out


def ddp_two_rank_path(torch, dev, seeds, root):
    """Two gloo ranks on the one card (`run_ranks`), global batch TRAIN_BS
    pairs of PATCH x PATCH from a numpy seed: one step of each DIST_CASES
    model, each rank within the DIST tolerances of the one-process step on
    the card replaying the ranks' piecewise decisions (train/branches.py:
    relu masks, the fusion's and the losses' maximum, abs and clamp
    branches), where the ranks' decisions differ from the one-process
    step's in no kind by more than `excess` allows (with no flip the
    replay is the plain one-process step); both ranks' parameters equal;
    conv_valid launched on each rank where the case is --fast_train; the
    two controls missing the plain one-process step by 10x; 10 more steps
    each, timed. Reported beside each: the error against the plain
    one-process step, and the one-process step on the batch with its
    images in reverse order against the forward order (the same step
    summed in another order: the f32 noise the check sits in). IFCNN on
    --fast_train flips a relu output and a fusion maximum of 16.9 million
    against the one-process step, which move encode.1's gradient by
    3.3e-5 of the largest; against the replay 3.5e-7 (measured on one
    H100). Returns the record."""
    from multi_modal_image_fusion_tpu_torch.train.branches import (
        Decisions, excess, flips)
    rng = np.random.RandomState(21)
    x1, x2 = (rng.rand(TRAIN_BS, PATCH, PATCH, 1).astype(np.float32)
              for _ in range(2))
    np.savez(os.path.join(root, "batch.npz"), x1=x1, x2=x2)
    states, under_norm, cases = {}, {}, []
    for key, name, fast, ctl in DIST_CASES:
        if name not in states:
            model = seeded_model(torch, name, seeds.get(name, 0))
            states[name] = model.state_dict()
            under_norm[name] = biases_under_norm(model)
            torch.save(states[name], os.path.join(root, f"{name}.pth"))
        cases.append({"key": key, "model": name, "fast": fast,
                      "state": os.path.join(root, f"{name}.pth"),
                      **({"control": ctl} if ctl else {"branches": True})})
    run_ranks({"out": root, "device": dev.type, "batch":
               os.path.join(root, "batch.npz"), "cases": cases,
               "timed_steps": 10})
    rec = {}
    for case in cases:
        key, name, fast = case["key"], case["model"], case["fast"]
        own = Decisions()
        want = one_rank_step(torch, name, states[name], fast, x1, x2, dev,
                             branches=None if "control" in case else own)
        got = [torch.load(os.path.join(root, f"{key}.rank{r}.pt"),
                          weights_only=False) for r in range(2)]
        errs = [dist_errors(g, want, under_norm[name]) for g in got]
        same = max(float((got[0]["params"][n] - p).abs().max())
                   for n, p in got[1]["params"].items())
        r = rec[key] = {"errors": errs, "ranks_param_max_diff": same,
                        "launches": [g["launches"] for g in got],
                        "step_ms": [g["step_ms"] for g in got]}
        if "control" in case:
            r["control"] = DIST_CONTROLS[case["control"]]
            if not all(dist_missed_by(e) for e in errs):
                raise AssertionError(f"control {key} held: {errs}")
            continue
        r["reversed_batch_noise"] = dist_errors(one_rank_step(
            torch, name, states[name], fast, x1[::-1].copy(),
            x2[::-1].copy(), dev), want, under_norm[name])
        theirs = ranks_branches(torch, got, TRAIN_BS // len(got))
        r["flips"] = flips(theirs, own.log)
        replayed = one_rank_step(
            torch, name, states[name], fast, x1, x2, dev,
            branches=Decisions(replay=[(k, d.to(dev)) for k, d in theirs]))
        r["errors_vs_replay"] = [dist_errors(g, replayed, under_norm[name])
                                 for g in got]
        print(f"ddp 2 ranks {key}: {json.dumps(r)}")
        over = excess(r["flips"])
        if (not all(dist_within(e) for e in r["errors_vs_replay"]) or over
                or same != 0.0):
            raise AssertionError(f"2-rank step {key}: against the replay "
                                 f"{r['errors_vs_replay']}, flips "
                                 f"{r['flips']} (excess {over}), ranks' "
                                 f"parameters differ by {same}; against "
                                 f"the plain step {errs}; the reversed "
                                 f"batch's noise "
                                 f"{r['reversed_batch_noise']}")
        if fast and not all(g["launches"].get("conv_valid", 0) for g in got):
            raise AssertionError(f"2-rank step {key}: conv_valid launches "
                                 f"{r['launches']}")
    return rec


def _step_ms(torch, trainer, batch, steps=20, warmup=3):
    """Median host-clock ms of a train step, synchronised before and after
    each."""
    for _ in range(warmup):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def ddp_world1_path(torch, build, dev, root):
    """The train CLI under --multihost at WORLD_SIZE=1 over NCCL (DeepFuse,
    --fast_train, 1 epoch of one step on a fixture of 5 pairs of 128x128),
    its counts from 0, against the same CLI without it, and the plain CLI
    again, all on cuDNN's deterministic algorithms: the checkpoints equal
    bit for bit, or within 1e-6 where the plain run does not repeat itself
    either (the step's reflect pad sums its gradient with atomic adds: the
    cause is recorded with both differences). Then a DeepFuse step's time
    with no group, in a world-1 NCCL group, with no group again, in a
    world-1 gloo group and with no group again (no collective runs in a
    world-1 group: mesh.spans_ranks)."""
    from multi_modal_image_fusion_tpu_torch.cli import train as train_cli
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.parallel import mesh
    from multi_modal_image_fusion_tpu_torch.train.schedules import \
        make_lr_schedule
    from multi_modal_image_fusion_tpu_torch.train.trainer import Trainer
    data = os.path.join(root, "one_step")
    write_train_fixture(torch, data, n_pairs=5, n_test=1, size=128)
    args = ["--data", "synthtrain", "--data_root", data, "--fast_train",
            "--epoch", "1"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1"}

    def max_diff(a, b):
        if set(a) != set(b):
            raise AssertionError(f"world-1 checkpoint keys {sorted(b)}")
        return max(float((a[k].double() - b[k].double()).abs().max())
                   for k in a)
    runs, counts = {}, None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for key, extra in (("plain", []), ("multihost", ["--multihost"]),
                           ("plain_again", [])):
            build.LAUNCHES.clear()
            with switches(dict(env, MASTER_PORT=str(free_port()))
                          if extra else {}), \
                    contextlib.redirect_stderr(io.StringIO()):
                runs[key] = train_cli.main(args + extra + [
                    "--ckpt_root", os.path.join(root, f"ckpt_{key}")])
            if extra:
                counts = dict(build.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ck = {k: torch.load(os.path.join(d, "epoch_last.pth"), weights_only=True)
          for k, d in runs.items()}
    rec = {"checkpoint_max_abs_diff": max_diff(ck["plain"], ck["multihost"]),
           "checkpoint_plain_again_max_abs_diff": max_diff(
               ck["plain"], ck["plain_again"]),
           "cudnn_deterministic": True, "cause": None}
    diff = rec["checkpoint_max_abs_diff"]
    again = rec["checkpoint_plain_again_max_abs_diff"]
    if diff and (diff > 1e-6 or not again):
        raise AssertionError(f"world-1 NCCL checkpoint differs from the "
                             f"plain one's by {diff} (plain against plain: "
                             f"{again})")
    if diff:
        rec["cause"] = ("the plain step does not repeat itself bit for bit: "
                        "the reflect pad's backward sums with atomic adds "
                        "(torch's reflection_pad2d_backward on CUDA)")
    if not counts.get("conv_valid"):
        raise AssertionError(f"world-1 train CLI launches {counts}")
    g = torch.Generator().manual_seed(5)
    batch = tuple(torch.rand((TRAIN_BS, PATCH, PATCH, 1), generator=g).to(dev)
                  for _ in range(2))

    def trainer():
        m = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(0)).to(dev)
        return Trainer(m, make_lr_schedule(1e-4, 100, 12), fast=True)
    ms = {"no_group": _step_ms(torch, trainer(), batch)}
    for key, backend in (("world1_nccl", None), ("world1_gloo", "gloo")):
        with switches(dict(env, MASTER_PORT=str(free_port()))):
            mesh.init_multihost(backend=backend)
        try:
            ms[key] = _step_ms(torch, trainer(), batch)
        finally:
            torch.distributed.destroy_process_group()
        ms[f"no_group_after_{key}"] = _step_ms(torch, trainer(), batch)
    return {**rec, "launches": counts, "step_ms": ms}


def tiling_path(torch, build, dev, seeds):
    """Height tiling on the card: DeepFuse (whole-model slabs), MAFusion,
    UNFusion and Res2Fusion (two phases), f32 and bf16, one H x W pair
    reflect-padded to a multiple of 8 x TILES rows as the test CLI pads it
    (1248): `tiled_forward(TILES)` against the whole forward (f32 within
    TILE_TOL of max|y|, bf16 CHAIN_TOL beyond one ulp; TILE_CUDNN's bf16
    against the f32 whole forward), the kernels' launches counted (an enter and an exit a slab, every kernel of the
    whole forward at least as often), peak device memory and ms a pair
    (host clock, synchronised; the mean of 2 after one) both ways; in f32
    the controls, which must miss by 10x: halo 0, and MAFusion with the
    bilinear tile context off."""
    from unittest import mock

    from multi_modal_image_fusion_tpu_torch.cli.test import _reflect_pad
    from multi_modal_image_fusion_tpu_torch.parallel import tiling
    g = torch.Generator(device=dev).manual_seed(9)
    a, b = (torch.rand((1, H, W, 1), generator=g, device=dev)
            for _ in range(2))
    pad = -H % (8 * TILES)
    a, b = _reflect_pad(a, pad, 0), _reflect_pad(b, pad, 0)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        return y, peak, (time.perf_counter() - t0) * 1e3 / 2

    rec = {}
    for name in TILE_MODELS:
        per = FORWARD_LAUNCHES.get(name, {"conv_gray_enter": 1,
                                          "conv_chain": 3,
                                          "conv_gray_exit": 1})
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = seeded_model(torch, name, seeds.get(name, 0)).to(
                dev, dtype).eval()
            with torch.no_grad():
                y, peak_whole, ms_whole = timed(lambda: model(a, b))
                del y
                torch.cuda.empty_cache()
                build.LAUNCHES.clear()
                yt, peak_tiled, ms_tiled = timed(
                    lambda: tiling.tiled_forward(model, a, b, TILES))
                counts = {k: v // 3 for k, v in build.LAUNCHES.items()}
                y = model(a, b)
                vs_f32 = None
                if dt == "f32":
                    err, rel = _err(torch, yt, y, "f32")
                    rel = err / float(y.abs().max())
                    if rel > TILE_TOL:
                        raise AssertionError(f"tiled {name} f32: {rel}")
                    y32 = y.float()
                elif name in TILE_CUDNN:
                    err, rel = _wide_rel(torch, yt, y, dt)
                    scale = float(y32.abs().max())
                    d_t, d_w = ((v.float() - y32).abs() for v in (yt, y))
                    vs_f32 = {"tiled_max": float(d_t.max()) / scale,
                              "whole_max": float(d_w.max()) / scale,
                              "tiled_mean": float(d_t.mean()) / scale,
                              "whole_mean": float(d_w.mean()) / scale}
                    if (vs_f32["tiled_max"] > vs_f32["whole_max"]
                            + CHAIN_TOL[dt] or vs_f32["tiled_mean"]
                            > 1.05 * vs_f32["whole_mean"]):
                        raise AssertionError(f"tiled {name} {dt} against "
                                             f"f32: {vs_f32}")
                else:
                    err, rel = _chain_err(torch, yt, y, dt)
                if (counts.get("conv_gray_enter") != TILES
                        or counts.get("conv_gray_exit") != TILES
                        or any(counts.get(k, 0) < v for k, v in per.items())):
                    raise AssertionError(f"tiled {name} {dt} launches "
                                         f"{counts}")
                r = rec[f"{name} {dt}"] = {
                    "max_abs_diff": err, "rel": rel,
                    **({"against_f32": vs_f32} if vs_f32 else {}),
                    "peak_gb_whole": peak_whole, "peak_gb_tiled": peak_tiled,
                    "ms_whole": ms_whole, "ms_tiled": ms_tiled,
                    "launches_tiled": counts}
                if dt == "bf16" and name in TILE_PROFILED:
                    r["profile"] = {
                        "whole": profile_forward(torch, model, a, b),
                        "tiled": profile_forward(
                            torch, lambda x, z: tiling.tiled_forward(
                                model, x, z, TILES), a, b,
                            spans=("tiled_bilinear",))}
                if dt == "f32":
                    ctl = {"halo_0": tiling.tiled_forward(model, a, b, TILES,
                                                          halo=0)}
                    if name == "mafusion":
                        with mock.patch.object(
                                tiling, "tile_rows_ctx",
                                lambda *_: contextlib.nullcontext()):
                            ctl["no_tile_context"] = tiling.tiled_forward(
                                model, a, b, TILES)
                    scale = float(y.abs().max())
                    r["controls"] = {
                        k: float((v.float() - y.float()).abs().max()) / scale
                        for k, v in ctl.items()}
                    if min(r["controls"].values()) <= 10 * TILE_TOL:
                        raise AssertionError(f"tiling control held: {name} "
                                             f"{r['controls']}")
                del y, yt
            del model
            torch.cuda.empty_cache()
            print(f"tiled {name} {dt}: {json.dumps(r)}")
    rec["deepfuse int8"] = tiled_int8(torch, build, dev, a, b)
    print(f"tiled deepfuse int8: {json.dumps(rec['deepfuse int8'])}")
    return rec


def tiled_int8(torch, build, dev, a, b):
    """DeepFuse under --int8 (bf16, one calibration on a 256 x 256 crop of
    the pair, as the bench calibrates) tiled against whole, as the test
    CLI's --int8 --tiles runs it: equal within CHAIN_TOL beyond one bf16
    ulp (expected bit for bit: the same per-pixel arithmetic with the same
    scales), each slab on the int8 chain (INT8_FORWARD_LAUNCHES a slab),
    ms a pair both ways."""
    from multi_modal_image_fusion_tpu_torch.ops.quant import (
        calibrate, quantized_inference)
    from multi_modal_image_fusion_tpu_torch.parallel import tiling
    model = seeded_model(torch, "deepfuse", 0).to(dev, torch.bfloat16).eval()
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    amax = calibrate(model, [(a16[:, :256, :256].contiguous(),
                              b16[:, :256, :256].contiguous())])
    ms = {}
    with torch.no_grad(), quantized_inference(amax):
        y = model(a16, b16)
        build.LAUNCHES.clear()
        yt = tiling.tiled_forward(model, a16, b16, TILES)
        counts = dict(build.LAUNCHES)
        for key, fn in (("whole", lambda: model(a16, b16)),
                        ("tiled", lambda: tiling.tiled_forward(
                            model, a16, b16, TILES))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ms[key] = (time.perf_counter() - t0) * 1e3 / 3
    with torch.no_grad():
        plain = model(a16, b16)
    err, rel = _chain_err(torch, yt, y, "bf16")
    want = {k: v * TILES for k, v in INT8_FORWARD_LAUNCHES["deepfuse"].items()}
    if counts != want or torch.equal(plain, y):
        raise AssertionError(f"tiled deepfuse int8: launches {counts} (want "
                             f"{want}), int8 route ran: "
                             f"{not torch.equal(plain, y)}")
    return {"max_abs_diff": err, "rel": rel, "launches_tiled": counts,
            "ms_whole": ms["whole"], "ms_tiled": ms["tiled"]}


def tiled_cli_path(torch, build, test_cli, root, dev, seeds):
    """The test CLI with --tiles TILES on TILE_CLI_PAIRS synthetic H x W
    pairs (a seeded TILE_CLI_MODEL checkpoint), counts from 0: it notes
    the padding once, launches an enter and an exit a slab, and its SSIM
    equals the untiled CLI's on the same padded input (--pad_bucket 8 x
    TILES) within 1e-6."""
    from multi_modal_image_fusion_tpu_torch.train.checkpoint import \
        save_state_dict
    write_cli_fixture(torch, root, TILE_CLI_PAIRS)
    name = TILE_CLI_MODEL
    save_state_dict(os.path.join(root, "ckpt", "tiled", "epoch_best.pth"),
                    seeded_model(torch, name, seeds.get(name, 0)).state_dict(),
                    meta={"model": name})
    args = ["--data", "synth", "--data_root", os.path.join(root, "data"),
            "--ckpt_root", os.path.join(root, "ckpt"), "--ckpt", "tiled"]
    rec = {}
    for key, extra in (("tiled", ["--tiles", str(TILES)]),
                       ("whole", ["--pad_bucket", str(8 * TILES)])):
        build.LAUNCHES.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ssim, avg = test_cli.main(args + extra)
        rec[key] = {"ssim": ssim, "mean_ms": avg * 1e3,
                    "launches": dict(build.LAUNCHES),
                    "noted": out.getvalue().count("note: H=")}
    t = rec["tiled"]
    if (abs(t["ssim"] - rec["whole"]["ssim"]) > 1e-6 or t["noted"] != 1
            or t["launches"].get("conv_gray_enter") != TILES * TILE_CLI_PAIRS
            or t["launches"].get("ssim_maps") != 2 * TILE_CLI_PAIRS):
        raise AssertionError(f"test CLI --tiles {TILES}: {rec}")
    print(f"test CLI {name} --tiles {TILES}: {json.dumps(rec)}")
    return rec, t["launches"]


def parallel_phase(torch, build, test_cli, dev, seeds):
    """Phase "parallel" (its seconds stamped): height tiling
    (`tiling_path`, `tiled_cli_path`), the world-1 NCCL train CLI
    (`ddp_world1_path`) and two gloo ranks on the card
    (`ddp_two_rank_path`). Returns (record, launch counts of the tiled CLI
    and the world-1 train CLI)."""
    t0 = time.perf_counter()
    # the first live weight seed of each tiled model that has none yet
    seeds = {**{n: live_seed(torch, dev, n) for n in (*TILE_MODELS, "ifcnn")
                if n not in seeds and n != "deepfuse"}, **seeds}
    rec = {"tiling": tiling_path(torch, build, dev, seeds)}
    torch.cuda.empty_cache()
    stamp("parallel: tiled forwards checked")
    counts = collections.Counter()
    with tempfile.TemporaryDirectory() as root:
        rec["test_cli_tiles"], c = tiled_cli_path(torch, build, test_cli,
                                                  root, dev, seeds)
        counts.update(c)
        stamp("parallel: test CLI --tiles done")
        rec["ddp_world1"] = ddp_world1_path(torch, build, dev, root)
        counts.update(rec["ddp_world1"]["launches"])
        print(f"ddp world 1: {json.dumps(rec['ddp_world1'])}")
        stamp("parallel: world-1 NCCL train CLI done")
        rec["ddp_two_ranks"] = ddp_two_rank_path(torch, dev, seeds, root)
        print(f"ddp 2 ranks: {json.dumps(rec['ddp_two_ranks'])}")
    rec["seconds"] = time.perf_counter() - t0
    stamp(f"parallel phase done in {rec['seconds']:.1f} s")
    return rec, counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from multi_modal_image_fusion_tpu_torch import bench
    from multi_modal_image_fusion_tpu_torch.cli import test as test_cli
    from multi_modal_image_fusion_tpu_torch.data.dataset import FusionDataset
    from multi_modal_image_fusion_tpu_torch.models import create_model
    from multi_modal_image_fusion_tpu_torch.ops.cuda import build

    # phase 1
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2
    t0 = time.perf_counter()
    lib_path = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    build.library()
    sass, nl_sass, int8_sass, gray_sass, pair_sass, valid_sass = \
        tensor_core_report(build, lib_path)
    dw_ptxas = dw_ptxas_report(build)

    # phase 3
    timer = Timer(torch, dev)
    rec = check_kernels(torch, F, dev, timer)
    stamp("conv_chain, enter and exit checked")
    check_gray_legs(torch, F, dev, timer, rec)
    sedr_library = check_sedrfuse(torch, F, dev, timer, rec)
    stamp("sedrfuse kernels and library parts checked")
    fuse_net = check_fuse_net(torch, F, dev, timer)
    stamp("pfnetv2 fuse net timed")
    rec["conv_valid"] = check_conv_valid(torch, F, dev, timer)
    torch.cuda.empty_cache()
    stamp("conv_valid checked")
    rec.update(check_window(torch, F, dev, timer))
    stamp("ssim_maps and moments checked")
    rec["conv_multi"] = check_conv_multi(torch, F, dev, timer)
    torch.cuda.empty_cache()
    stamp("conv_multi checked")
    rec.update(check_nl(torch, F, dev, timer))
    stamp("nl_minmax and nl_apply checked")
    rec["conv_dw"] = check_conv_dw(torch, F, dev, timer)
    stamp("conv_dw checked")
    myf_downs = check_myfusion(torch, F, dev, timer, rec)
    stamp("myfusion conv_dw shapes and strided downs checked")
    sdpa = check_sdpa(torch, F, dev, timer)
    stamp("the attention's SDPA route checked")
    rec["conv_wide"] = check_conv_wide(torch, F, dev, timer)
    stamp("conv_wide checked")
    print(f"conv_wide layers: {json.dumps(rec['conv_wide']['layers'])}")
    rec.update(check_int8(torch, F, dev, timer))
    for name in ("conv_int8", "conv_int8_chain"):
        print(f"{name} layers: {json.dumps(rec[name]['layers'])}")
    rec.update(check_variants(torch, F, dev, timer))
    for name in VARIANT_REPLACES:
        print(f"{name} layers: {json.dumps(rec[name]['layers'])}")
    print("kernel checks passed")
    # the host clocks of the timed paths (the CLIs' pairs, the benches)
    # leave out collections over the smoke's own heap, which a user's CLI
    # process does not hold: one full collection, then every object alive
    # is frozen (unfrozen, a generation-2 collection over that heap took
    # 230.7 ms inside one MyFusion CLI pair on an H100 80GB HBM3); before
    # the seed search, whose forwards keep the card busy up to phase 4
    gc.collect()
    gc.freeze()
    # the weight seed of each new model's bench, contract and test CLI
    seeds = {name: live_seed(torch, dev, name)
             for name in (*NEST_MODELS, *FIVE_MODELS, *GROUP_MODELS,
                          *MYF_MODELS)}
    seeds["myfusion_res2_plain_rfn"] = live_seed(torch, dev, "myfusion",
                                                 **MYF_RES2)
    for key, cfg in MYF_FORMERS.items():
        seeds[key] = live_seed(torch, dev, "myfusion", key=key,
                               min_spread=1e-3, **cfg)
    seeds["myfusion_sep_batch"] = live_seed(
        torch, dev, "myfusion", key="myfusion_sep_batch", **MYF_SEP_BATCH)
    torch.cuda.empty_cache()

    # phase 4: main path, counts from 0
    build.LAUNCHES.clear()
    result, (a16, b16, y16) = bench.run(seed=0)
    fwd = bench.ITERS + 1
    bench_counts = dict(build.LAUNCHES)
    print(f"bench: {json.dumps(result)}")
    want = {"conv_gray_enter": fwd, "conv_chain": 3 * fwd,
            "conv_gray_exit": fwd}
    for k, v in want.items():
        if bench_counts.get(k, 0) != v:
            raise AssertionError(f"bench launches {bench_counts}, want {want}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        model = write_cli_fixture(torch, root)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_ssim, cli_time = test_cli.main([
                "--data", "synth", "--data_root", os.path.join(root, "data"),
                "--ckpt_root", os.path.join(root, "ckpt"), "--ckpt", "run"])
        counts = dict(build.LAUNCHES)
        print(out.getvalue().rstrip())
        iter_ms = [float(m) for m in re.findall(r"^iter: \d+, .*time: "
                                                r"([\d.]+)ms$", out.getvalue(),
                                                re.M)]
        if len(iter_ms) != CLI_PAIRS:
            raise AssertionError(f"CLI printed {len(iter_ms)} iterations, "
                                 f"want {CLI_PAIRS}")
        lat = np.array(iter_ms[1:])                # first = warmup
        cli_lat = {"pairs": len(lat), "mean_ms": cli_time * 1e3,
                   "median_ms": float(np.median(lat)),
                   "min_ms": float(lat.min()), "max_ms": float(lat.max())}
        fwd += CLI_PAIRS
        want = {"conv_gray_enter": fwd, "conv_chain": 3 * fwd,
                "conv_gray_exit": fwd, "ssim_maps": 2 * CLI_PAIRS}
        if counts != want:
            raise AssertionError(f"main-path launches {counts}, want {want}")

        # phase 5: outputs
        if "fps" not in out.getvalue():
            raise AssertionError("test CLI printed no fps")
        for i in range(CLI_PAIRS):
            bmp = os.path.join(root, "ckpt", "run", "synth", f"{i + 1:0>2}.bmp")
            if not os.path.isfile(bmp):
                raise AssertionError(f"missing {bmp}")
        model = model.to(dev)
        ds = FusionDataset(os.path.join(root, "data", "synth"), "test",
                           "test", "ir")
        ref = []
        with torch.no_grad():
            for i in range(len(ds)):
                a, b = (torch.from_numpy(v)[None, ..., None].to(dev)
                        for v in ds[i])
                y = plain_forward(torch, model, a, b)
                ref.append(float((_plain_ssim(torch, a, y)
                                  + _plain_ssim(torch, b, y))[0] * 0.5))
        ref_ssim = float(np.mean(ref))
        if not (np.isfinite(cli_ssim)
                and abs(cli_ssim - ref_ssim) <= 1e-4):
            raise AssertionError(f"CLI SSIM {cli_ssim} vs plain f32 "
                                 f"{ref_ssim}")
        print(f"test CLI: ssim {cli_ssim:.6f} (plain f32 on the card "
              f"{ref_ssim:.6f}), latency over {cli_lat['pairs']} pairs: "
              f"median {cli_lat['median_ms']:.3f} ms, mean "
              f"{cli_lat['mean_ms']:.3f} ms, min {cli_lat['min_ms']:.3f}, "
              f"max {cli_lat['max_ms']:.3f}")
        del model, ds, ref
        torch.cuda.empty_cache()
        main_counts = collections.Counter(counts)

        # eval path: the eval CLI over the 51 dumped pairs, counts from 0
        stamp("deepfuse bench and test CLI done")
        eval_rec, eval_counts = eval_path(torch, build, root)
        stamp("eval CLI done")
        main_counts.update(eval_counts)
        torch.cuda.empty_cache()

        # DenseFuse 'l1' and Res2Fusion through the test CLI, counts from 0
        l1_rec, l1_counts = model_cli_path(
            torch, build, test_cli, root, dev, "densefuse_l1", "densefuse",
            {"fusion_mode": "l1"}, L1_PAIRS, 4)
        main_counts.update(l1_counts)
        stamp("densefuse l1 test CLI done")
        res2_rec, res2_counts = model_cli_path(
            torch, build, test_cli, root, dev, "res2fusion", "res2fusion", {},
            RES2_PAIRS, 0)
        main_counts.update(res2_counts)
        stamp("res2fusion test CLI done")
        wide_cli = {}
        for name in ("dbnet", "unfusion", *NEST_MODELS, *FIVE_MODELS,
                     *GROUP_MODELS, *MYF_MODELS):
            wide_cli[name], counts = model_cli_path(
                torch, build, test_cli, root, dev, name, name, {}, WIDE_PAIRS,
                seeds.get(name, 0))
            main_counts.update(counts)
            stamp(f"{name} test CLI done")
        key = "myfusion_res2_plain_rfn"
        wide_cli[key], counts = model_cli_path(
            torch, build, test_cli, root, dev, key, "myfusion", MYF_RES2,
            WIDE_PAIRS, seeds[key])
        main_counts.update(counts)
        stamp(f"{key} test CLI done")
        key = MYF_FORMER_CLI
        wide_cli[key], counts = model_cli_path(
            torch, build, test_cli, root, dev, key, "myfusion",
            MYF_FORMERS[key], WIDE_PAIRS, seeds[key])
        main_counts.update(counts)
        stamp(f"{key} test CLI done")
        # the test CLI --int8 on the same 51 pairs, counts from 0
        int8_cli, counts = int8_cli_path(torch, build, test_cli, root, dev,
                                         cli_ssim)
        main_counts.update(counts)
        stamp("test CLI --int8 done")
        # the test CLI under the pair and packed switches (f32: no s2d_io)
        variant_cli = {}
        for key in ("deepfuse_pair", "deepfuse_s2d"):
            with switches(VARIANTS[key]):
                variant_cli[key], counts = model_cli_path(
                    torch, build, test_cli, root, dev, key, "deepfuse", {},
                    WIDE_PAIRS, 3)
            main_counts.update(counts)
            stamp(f"test CLI {key} done")
    torch.cuda.empty_cache()

    # BASELINE contract on the bench's last timed batch: its bf16 fused
    # pairs against the f32 plain forward of the same weights and inputs
    model = create_model("deepfuse",
                         generator=torch.Generator().manual_seed(0)).to(dev)
    x1, x2, y16 = a16.float(), b16.float(), y16.float()
    with torch.no_grad():
        y32 = plain_forward(torch, model, x1, x2)
        (s32, q32), (s16, q16) = (
            [float(v.mean()) for v in ssim_qabf(torch, x1, x2, y)]
            for y in (y32, y16))
        y_diff = float((y16 - y32).abs().max())
    if not (np.isfinite(s16) and abs(s16 - s32) <= 1e-3
            and np.isfinite(q16) and abs(q16 - q32) <= 1e-3):
        raise AssertionError(f"bf16 SSIM {s16} vs f32 {s32}, Qabf {q16} vs "
                             f"{q32}")
    print(f"bf16 contract ({y16.shape[0]} bench pairs): mean SSIM bf16 "
          f"{s16:.6f} vs f32 {s32:.6f} (|d| {abs(s16 - s32):.2e} <= 1e-3); "
          f"mean Qabf bf16 {q16:.6f} vs f32 {q32:.6f} (|d| "
          f"{abs(q16 - q32):.2e} <= 1e-3); "
          f"fused max |bf16 - f32| {y_diff:.4g} (f32 max "
          f"{float(y32.abs().max()):.4g})")
    contracts = {"deepfuse": {"ssim": {"kernel_bf16": s16, "f32": s32},
                              "qabf": {"kernel_bf16": q16, "f32": q32},
                              "held_against": "f32"}}
    del model, y32, y16, a16, b16, x1, x2
    torch.cuda.empty_cache()

    # DenseFuse, VIFNet and Res2Fusion benches, counts from 0, and their
    # contracts
    benches = {"deepfuse": result}
    for name, batch in (("densefuse", BATCH), ("vifnet", BATCH),
                        ("res2fusion", RES2_BATCH), ("dbnet", BATCH),
                        ("unfusion", BATCH), ("nestfuse", BATCH),
                        ("rfnnest", BATCH), ("mafusion", MAFUSION_BATCH),
                        *((m, BATCH) for m in (*FIVE_MODELS,
                                               *GROUP_MODELS,
                                               *MYF_MODELS))):
        torch.cuda.reset_peak_memory_stats()
        benches[name], (a16, b16, y16), counts = bench_path(
            build, bench, name, batch, seed=seeds.get(name, 0),
            net=seeded_model(torch, name, seeds.get(name, 0)))
        benches[name]["weight_seed"] = seeds.get(name, 0)
        benches[name]["peak_memory_gb"] = (torch.cuda.max_memory_allocated()
                                           / 2 ** 30)
        print(f"bench {name}: peak device memory "
              f"{benches[name]['peak_memory_gb']:.2f} GiB")
        main_counts.update(counts)
        torch.cuda.empty_cache()
        if name in ("res2fusion", "dbnet", "unfusion", *NEST_MODELS,
                    *FIVE_MODELS, *GROUP_MODELS, *MYF_MODELS):
            model = seeded_model(torch, name, seeds.get(name, 0)).to(
                dev, torch.bfloat16).eval()
            benches[name]["profile"] = profile_forward(torch, model, a16, b16)
            print(f"{name} forward profile: "
                  f"{json.dumps(benches[name]['profile'])}")
            del model
            torch.cuda.empty_cache()
        contracts[name] = contract(torch, dev, name, a16, b16, y16,
                                   chunk=2 if name == "mafusion" else 4,
                                   seed=seeds.get(name, 0))
        del a16, b16, y16
        torch.cuda.empty_cache()
        stamp(f"{name} bench and contract done")

    # MyFusion's MetaFormer configurations: bench (16 pairs), counts from
    # 0, a profiled forward (conv kernels, SDPA, torch ops), the contract
    for key, cfg in MYF_FORMERS.items():
        torch.cuda.reset_peak_memory_stats()
        seed = seeds[key]
        benches[key], (a16, b16, y16), counts = bench_path(
            build, bench, key, BATCH, model="myfusion", seed=seed,
            net=seeded_model(torch, "myfusion", seed, **cfg))
        benches[key].update({
            "weight_seed": seed, "model_cfg": cfg,
            "ms_per_forward": benches[key]["ms_per_pair"] * BATCH,
            "launches_per_forward": FORWARD_LAUNCHES[key],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        print(f"bench {key}: peak device memory "
              f"{benches[key]['peak_memory_gb']:.2f} GiB")
        main_counts.update(counts)
        torch.cuda.empty_cache()
        model = seeded_model(torch, "myfusion", seed, **cfg).to(
            dev, torch.bfloat16).eval()
        benches[key]["profile"] = profile_forward(torch, model, a16, b16)
        print(f"{key} forward profile: "
              f"{json.dumps(benches[key]['profile'])}")
        del model
        torch.cuda.empty_cache()
        contracts[key] = contract(torch, dev, "myfusion", a16, b16, y16,
                                  seed=seed, key=key, cfg=cfg)
        del a16, b16, y16
        torch.cuda.empty_cache()
        stamp(f"{key} bench and contract done")

    # int8 benches (rows 11 and 12), counts from 0 before each, and the
    # int8 quality gap (reported, not gated)
    int8_benches, int8_gap = {}, {}
    for name in ("deepfuse", "densefuse", "unfusion"):
        int8_benches[name], (a16, b16, y8), counts = int8_bench_path(
            torch, build, bench, name)
        int8_benches[name]["bf16_pairs_per_sec"] = benches[name]["value"]
        main_counts.update(counts)
        torch.cuda.empty_cache()
        int8_gap[name] = int8_quality(torch, dev, name, a16, b16, y8)
        del a16, b16, y8
        torch.cuda.empty_cache()
        stamp(f"{name} int8 bench and quality done")
    # --int8 of every other model and configuration that serves, on its
    # float bench's weights (the live seed), counts from 0 before each;
    # its quality gap (reported, not gated) and its int8 kernels against
    # the plain int8 path on the bench's last batch
    int8_plain = {}
    for key, name, cfg, batch in INT8_MODELS:
        seed = seeds[key]

        def make(name=name, seed=seed, cfg=cfg):
            return seeded_model(torch, name, seed, **cfg)
        net = make()
        int8_benches[key], (a16, b16, y8), counts = int8_bench_path(
            torch, build, bench, name, key, net=net, batch=batch)
        int8_benches[key].update(
            weight_seed=seed, model_cfg=cfg,
            bf16_pairs_per_sec=benches.get(key, {}).get("value"))
        main_counts.update(counts)
        torch.cuda.empty_cache()
        int8_gap[key] = int8_quality(torch, dev, name, a16, b16, y8,
                                     chunk=2 if name == "mafusion" else 4,
                                     make=make, key=key)
        int8_plain[key] = int8_plain_check(torch, dev, key, net, a16, b16)
        del a16, b16, y8, net
        torch.cuda.empty_cache()
        stamp(f"{key} int8 bench, quality and plain check done")

    # DeepFuse's opt-in routes (rows 9's s2d mode, 10, 13, 14): the bench
    # under each set of switches, counts from 0, beside the default bench
    # of phase 4, and its contract; then --int8 with MMIF_CHAIN_PAIR, which
    # takes the float pair route (no conv_int8_chain launch)
    variant_benches = {}
    for key, env in VARIANTS.items():
        torch.cuda.reset_peak_memory_stats()
        with switches(env):
            variant_benches[key], (a16, b16, y16), counts = bench_path(
                build, bench, key, BATCH, model="deepfuse")
        variant_benches[key]["peak_memory_gb"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)
        variant_benches[key]["default_pairs_per_sec"] = result["value"]
        variant_benches[key]["switches"] = env
        main_counts.update(counts)
        torch.cuda.empty_cache()
        contracts[key] = contract(torch, dev, "deepfuse", a16, b16, y16)
        del a16, b16, y16
        torch.cuda.empty_cache()
        stamp(f"{key} bench and contract done")
    with switches(VARIANTS["deepfuse_pair"]):
        int8_pair, _, counts = int8_bench_path(torch, build, bench,
                                               "deepfuse", "deepfuse_pair")
    int8_pair["int8_chain_pairs_per_sec"] = int8_benches["deepfuse"]["value"]
    main_counts.update(counts)
    torch.cuda.empty_cache()
    stamp("deepfuse --int8 with MMIF_CHAIN_PAIR done")

    # phase 6: training, counts from 0
    with tempfile.TemporaryDirectory() as root:
        write_train_fixture(torch, root)
        train_counts, step_s, ckpt_dir = train_phase(torch, build, root)
        steps, valid_batches = 2 * 32, 2 * 8
        want = {"conv_valid": 9 * steps + 5 * valid_batches,
                "conv_valid/forward": 5 * steps, "conv_valid/dx": 4 * steps,
                "conv_valid/valid": 5 * valid_batches,
                "conv_valid_dw": 5 * steps}
        if train_counts != want or len(step_s) != steps:
            raise AssertionError(f"training launches {train_counts} over "
                                 f"{len(step_s)} steps, want {want} over "
                                 f"{steps}")
        ms = np.array(step_s[3:]) * 1e3        # after epoch 1's first 3
        step_stats = {"steps": len(ms), "median_ms": float(np.median(ms)),
                      "p10_ms": float(np.percentile(ms, 10)),
                      "p90_ms": float(np.percentile(ms, 90)),
                      "min_ms": float(ms.min()), "max_ms": float(ms.max()),
                      "patches_per_s": TRAIN_BS * 1e3 / float(np.median(ms))}
        print(f"train CLI: {steps} steps, {valid_batches} valid batches, "
              f"launches {train_counts}; step median "
              f"{step_stats['median_ms']:.3f} ms (p10 "
              f"{step_stats['p10_ms']:.3f}, p90 {step_stats['p90_ms']:.3f}, "
              f"min {step_stats['min_ms']:.3f}, max "
              f"{step_stats['max_ms']:.3f}), "
              f"{step_stats['patches_per_s']:.1f} patches/s")
        step_check = {}
        for key, name, cfg in TRAIN_CHECKS:
            c = step_check[key] = train_step_check(torch, dev, key, name,
                                                   cfg)
            print(f"train step ({key}, weight seed {c['weight_seed']}), "
                  f"kernels vs F.conv2d: loss parts "
                  f"{c['loss_parts']}, max grad err "
                  f"{c['max_grad_rel_err']:.3g} of the largest gradient, "
                  f"against the float64 replay "
                  f"{c['max_grad_rel_err_f64']:.3g} of the largest (plain "
                  f"float64 {c['max_grad_rel_err_plain_f64']:.3g}, flips "
                  f"[calls, decided, differ] {c['flips_vs_f64']}; F.conv2d "
                  f"f32 "
                  f"{c['f32_conv2d_rel_err_f64']:.3g}) and "
                  f"{c['max_grad_rel_err_own_f64']:.3g} of a "
                  f"gradient's own largest (F.conv2d f32: "
                  f"{c['f32_conv2d_rel_err_own_f64']:.3g}; above 1e-4 of "
                  f"their own: {json.dumps(c['own_f64'])}), "
                  f"{c['params']} parameters ({c['biases_under_norm']}"
                  f" biases under a norm, {c['unreached_params']} the loss "
                  f"never reaches), running statistics across routes "
                  f"{c['running_stats_rel_err']:.3g}, launches "
                  f"{c['launches']}; step ms (bs {TRAIN_BS}, {PATCH}x"
                  f"{PATCH}): kernels {c['step_ms']['kernels']:.3f}, "
                  f"F.conv2d {c['step_ms']['conv2d']:.3f}")
        stamp("train step checks done")
        bn_cli = bn_cli_path(torch, build, test_cli, root, dev)
        stamp("ifcnn train CLI, test CLI and test CLI --int8 done")
        jax_cli = jax_ckpt_cli_path(torch, build, test_cli, root, dev)
        stamp("test CLI on the JAX checkpoint done")
        train_shapes = train_shape_times(torch, F, dev, timer)
        busy = {key: profile_steps(torch, dev, key) for key in PROFILED_STEPS}
        stamp("training done")
        print(f"train step profile: {json.dumps(busy)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_ssim, _ = test_cli.main([
                "--data", "synthtrain", "--data_root", root, "--ckpt_root",
                os.path.dirname(ckpt_dir), "--ckpt",
                os.path.basename(ckpt_dir)])
        if not np.isfinite(train_ssim):
            raise AssertionError(f"test CLI on the trained checkpoint: "
                                 f"SSIM {train_ssim}")
        print(f"test CLI on the trained checkpoint: ssim {train_ssim:.6f}")

    # phase "parallel": height tiling and data parallelism, counts from 0
    # before each path
    torch.cuda.empty_cache()
    parallel, counts = parallel_phase(torch, build, test_cli, dev, seeds)
    main_counts.update(counts)

    replaces = {
        "conv_gray_enter": "multi_modal_image_fusion_tpu/ops/pallas/"
                           "conv_kernel.py:357",
        "conv_chain": "multi_modal_image_fusion_tpu/ops/pallas/"
                      "hiw_kernel.py:335",
        "conv_gray_exit": "multi_modal_image_fusion_tpu/ops/pallas/"
                          "conv_kernel.py:383",
        "ssim_maps": "multi_modal_image_fusion_tpu/ops/pallas/"
                     "ssim_kernel.py:86",
        "moments": "multi_modal_image_fusion_tpu/ops/pallas/"
                   "moments_kernel.py:50",
        "conv_multi": "multi_modal_image_fusion_tpu/ops/pallas/"
                      "hiw_kernel.py:619",
        "nl_minmax": NL_REPLACES[0],
        "nl_apply": NL_REPLACES[1],
        "conv_dw": "multi_modal_image_fusion_tpu/ops/pallas/hiw_kernel.py:335 "
                   "(conv_hiw_chain; depthwise as diagonal bands :157-185)",
    }
    replaces["conv_wide"] = WIDE_REPLACES
    sources = {"conv_gray_enter":
                   "multi_modal_image_fusion_tpu_torch/csrc/conv_gray.cu",
               "conv_gray_exit":
                   "multi_modal_image_fusion_tpu_torch/csrc/conv_gray.cu",
               "ssim_maps": "multi_modal_image_fusion_tpu_torch/csrc/ssim.cu",
               "moments": "multi_modal_image_fusion_tpu_torch/csrc/moments.cu",
               "nl_minmax":
                   "multi_modal_image_fusion_tpu_torch/csrc/nl_attention.cu",
               "nl_apply":
                   "multi_modal_image_fusion_tpu_torch/csrc/nl_attention.cu",
               "conv_dw": "multi_modal_image_fusion_tpu_torch/csrc/conv_dw.cu",
               "conv_wide":
                   "multi_modal_image_fusion_tpu_torch/csrc/conv_wide.cu"}
    kernels = []
    main_counts.update(train_counts)
    counts = dict(main_counts)
    for name in ("conv_gray_enter", "conv_chain", "conv_gray_exit",
                 "ssim_maps", "moments", "conv_multi", "nl_minmax", "nl_apply",
                 "conv_dw", "conv_wide"):
        r = rec[name]
        # conv_wide: the sums are one bf16 bench forward of each model (16
        # pairs; MAFusion 4); conv_dw: the 12 layers of one bf16 res2fusion
        # bench forward (2 pairs) and MyFusion's shapes (MYF_DW, 16 pairs:
        # the default's five, MixConvBlock's four windows at levels 1 and
        # 4); their f32 launches at the test CLI's pair are under "layers"
        ls = [v for key, v in r["layers"].items()
              if name not in ("conv_wide", "conv_dw")
              or key.endswith(" bf16")]
        lib = [v["library_ms"] for v in ls]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(
                name, "multi_modal_image_fusion_tpu_torch/csrc/conv_chain.cu"),
            "replaces": replaces[name],
            "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"],
            **({"min_control_rel_err": r["min_control_rel_err"]}
               if "min_control_rel_err" in r else {}),
            "tolerance_rel": r.get("tolerance_rel", TOL),
            "ms": sum(v["ms"] for v in ls),
            "layers_summed": len(ls),
            "plain_ms": sum(v["plain_ms"] for v in ls),
            "bound_ms": sum(v["bound_ms"] for v in ls),
            "bound_by": "operations" if any(
                v["bound_by"] == "operations" for v in ls) else "bytes",
            "library_ms": None if None in lib else sum(lib),
            **({"sass": sass} if name in ("conv_chain", "conv_multi",
                                          "conv_wide")
               else {"sass": nl_sass[name]} if name in nl_sass
               else {"sass": gray_sass} if name.startswith("conv_gray")
               else {"ptxas": dw_ptxas} if name == "conv_dw"
               else {}),
            **({"body": "multi_modal_image_fusion_tpu_torch/csrc/"
                        "conv_chain.cuh (conv_chain_tc_kernel; f32: "
                        "conv_chain_kernel)"} if name == "conv_wide" else {}),
            **{key: r[key] for key in ("rounding_rel_err",
                                       "rounding_tolerance_rel",
                                       "batch_global_control_rel_err")
               if key in r},
            "layers": r["layers"],
        })
    # conv_int8: the sums are the bf16 layers checked at the benches' 16
    # pairs (DeepFuse's five with MMIF_HIW_INT8=0, DenseFuse's eight,
    # UNFusion's DB3_1 conv1); conv_int8_chain: one DeepFuse int8 forward's
    # three legs (enc1, dec0, dec1 with resident hops), bf16, 16 pairs
    for name in ("conv_int8", "conv_int8_chain"):
        r = rec[name]
        ls = [v for key, v in r["layers"].items() if key.endswith(" bf16")
              and ".nonres" not in key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multi_modal_image_fusion_tpu_torch/csrc/conv_int8.cuh",
            "replaces": INT8_REPLACES[name],
            "sass": {key: int8_sass[key] for key in ("igmma", "instances")},
            "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "min_control_rel_err": r["min_control_rel_err"],
            "tolerance_rel": r["tolerance_rel"],
            "ms": sum(v["ms"] for v in ls),
            "layers_summed": len(ls),
            "plain_ms": sum(v["plain_ms"] for v in ls),
            "bound_ms": sum(v["bound_ms"] for v in ls),
            "bound_by": "operations" if any(
                v["bound_by"] == "operations" for v in ls) else "bytes",
            "library_ms": sum(v["library_ms"] for v in ls),
            # the float inputs' quantizer pass within ms, beside its bound
            "quantize_ms": sum(v.get("quantize_ms", 0.0) for v in ls),
            "quantize_bound_ms": sum(v.get("quantize_bound_ms", 0.0)
                                     for v in ls),
            "layers": r["layers"],
        })
    # the opt-in routes' kernels: the sums are one bf16 bench forward of 16
    # pairs (conv_wide_s2d: its five packed layers; launches counted under
    # conv_wide/s2d, inside conv_wide's); the f32 checks are under "layers"
    for name in VARIANT_REPLACES:
        r = rec[name]
        ls = [v for key, v in r["layers"].items() if key.endswith(" bf16")]
        kernels.append({
            "name": name, "route": "cuda", "source": VARIANT_SOURCES[name],
            "replaces": VARIANT_REPLACES[name],
            "launches": counts.get("conv_wide/s2d" if name == "conv_wide_s2d"
                                   else name, 0),
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "min_control_rel_err": r["min_control_rel_err"],
            "tolerance_rel": r["tolerance_rel"],
            "ms": sum(v["ms"] for v in ls),
            "layers_summed": len(ls),
            "plain_ms": sum(v["plain_ms"] for v in ls),
            "bound_ms": sum(v["bound_ms"] for v in ls),
            "bound_by": "operations" if any(
                v["bound_by"] == "operations" for v in ls) else "bytes",
            "library_ms": sum(v["library_ms"] for v in ls),
            **({"sentinel_untouched": r["sentinel_untouched"]}
               if "sentinel_untouched" in r else {}),
            **({"sass": {k: v for k, v in pair_sass.items()
                         if k.startswith(name.split("_")[-1])}}
               if name.startswith("conv_pair") else {}),
            "layers": r["layers"],
        })
    # conv_valid: the sums are one train step's 9 launches in f32, the
    # training CLI's dtype; conv_valid_dw: its 5 dw launches; every shape
    # checked is under conv_valid's "layers"
    r = rec["conv_valid"]
    for name, ends in (("conv_valid", (".fwd.f32", ".dx.f32")),
                       ("conv_valid_dw", (".dw.f32",))):
        step = [v for key, v in r["layers"].items() if key.endswith(ends)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multi_modal_image_fusion_tpu_torch/csrc/"
                      "conv_valid.cuh",
            "replaces": ("multi_modal_image_fusion_tpu/ops/pallas/"
                         "conv_kernel.py:161 (conv_tlane_dma), "
                         "multi_modal_image_fusion_tpu/ops/pallas/"
                         "conv_vjp.py:71 (conv_valid_fast)"
                         if name == "conv_valid" else
                         "no Pallas kernel: the XLA einsums of "
                         "multi_modal_image_fusion_tpu/ops/pallas/"
                         "conv_vjp.py:94-106 (conv_valid_fast's dw)"),
            "launches": train_counts.get(name, 0),
            **({"launches_by_site": {k.split("/")[1]: v for k, v in
                                     train_counts.items() if "/" in k}}
               if name == "conv_valid" else {}),
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "min_control_rel_err": r["min_control_rel_err"],
            "tolerance_rel": r["tolerance_rel"],
            "sass": valid_sass,
            "ms": sum(v["ms"] for v in step),
            "layers_summed": len(step),
            "plain_ms": sum(v["plain_ms"] for v in step),
            "bound_ms": sum(v["bound_ms"] for v in step),
            "bound_3xtf32_ms": sum(v["bound_3xtf32_ms"] for v in step),
            "bound_by": "operations" if any(
                v["bound_by"] == "operations" for v in step) else "bytes",
            "library_ms": sum(v["library_ms"] for v in step),
            **({"layers": r["layers"]} if name == "conv_valid" else {}),
        })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    # a rough order for the redesign queue, not the time any path spends:
    # all main-path launches (bf16 benches, f32 batch-1 CLIs and int8
    # calibration alike) x the mean time the checked layers (bf16 16 pairs
    # where there is one) spend above their bounds, largest first
    excess = sorted(((k["launches"] * (k["ms"] - k["bound_ms"])
                      / k["layers_summed"], k["name"]) for k in kernels),
                    reverse=True)
    print("rough heuristic, launches of every path x mean (ms - bound_ms) "
          "of the checked layers: " + json.dumps(
              {name: round(v, 1) for v, name in excess}))
    print(json.dumps({"kernels": kernels,
                      "pairs_per_sec": result["value"],
                      "benches": benches,
                      "bf16_contract": contracts,
                      "cli_latency": cli_lat,
                      "test_cli_densefuse_l1": l1_rec,
                      "test_cli_res2fusion": res2_rec,
                      "pfnetv2_fuse_net": fuse_net,
                      "sedrfuse_library": sedr_library,
                      "myfusion_strided_downs": myf_downs,
                      "sdpa": sdpa,
                      **{f"test_cli_{k}": v for k, v in wide_cli.items()},
                      "int8_benches": int8_benches,
                      "int8_quality": int8_gap,
                      "int8_vs_plain": int8_plain,
                      "test_cli_int8": int8_cli,
                      "variant_benches": variant_benches,
                      "int8_bench_pair": int8_pair,
                      "test_cli_variants": variant_cli,
                      "eval": eval_rec,
                      "main_path_launches": counts,
                      "parallel": parallel,
                      "training": {"step": step_stats, "profile": busy,
                                   "step_check": step_check,
                                   "test_cli_ssim": train_ssim,
                                   "batch_norm_cli": bn_cli,
                                   "jax_checkpoint_cli": jax_cli,
                                   "shapes": train_shapes}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
