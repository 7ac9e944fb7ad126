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
// they are bound by arithmetic. In bf16 the arithmetic runs on the tensor
// cores as an implicit GEMM with warp-level mma.sync m16n8k16 (bf16 in, f32
// accumulate): M is a 2 x 64 tile of output pixels (4 warps, 32 pixels
// each), N a block of 16, 32 or 64 output channels (the wrapper picks the
// one that pads Cout least), K runs over legs x 16-channel chunks x k^2
// taps. For each chunk one reflect-indexed input tile plus its halo is
// staged in shared memory (16 channels a pixel, rows padded to 12 words so
// the fragment loads hit 32 distinct banks), next to the chunk's k^2 x N
// weights; every tap then reads a shifted window of that one tile. Channels
// past a leg's last are zero (the wrapper packs the weights with each leg's
// block padded to a multiple of 16), which covers the 40- and 56-channel
// legs. Epilogue: f32 bias and activation, round to bf16, store. No
// pipelining, wgmma or TMA yet: a simple kernel that is right first.
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
// common.cuh; conv_kernel.py:544-560 mirrors it on the TPU). Each 16-channel
// stage of the wide layers lies in one phase; enc0's 4 channels are one
// phase each (the per-channel path). dec2's 4 outputs use a 16-wide n block
// with the pairs past Cout left unstored. k5 at BN = 64 stages 76.8 KB of
// weights: the staging is dynamic shared memory.
//
// Not carried over from the TPU kernel: the guard layout, the kw_order
// weight permutation, the ssa/ssai/acc epilogues and the VMEM-driven c_in
// chunking. The halo is reflect index math in the tile load.
#include "conv_chain.cuh"

namespace mmif {

constexpr int WD_TH = 2, WD_TW = 64;  // output tile: 2 rows x 64 columns
constexpr int WD_THREADS = 128;       // 4 warps, 32 pixels of one row each
constexpr int WD_CK = 16;             // input channels a stage: one mma k-step
constexpr int WD_PW = 12;             // 32-bit words a staged row: 8 + 4 padding

template <int K, int NT>
struct WideSmem {
  static constexpr int IN_H = WD_TH + K - 1, IN_W = WD_TW + K - 1;
  static constexpr int IN_WORDS = IN_H * IN_W * WD_PW;   // [pixel][16 ch]
  static constexpr int W_WORDS = K * K * 8 * NT * WD_PW;  // [tap][co][16 ch]
  static constexpr size_t BYTES = (size_t)(IN_WORDS + W_WORDS) * 4;
};

template <int K, int NT>
__global__ void __launch_bounds__(WD_THREADS)
conv_wide_mma_kernel(Legs legs, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H,
                     int W, int Cout, int cout_pad, int cin_pad, int fuse_n, int act) {
  using S = WideSmem<K, NT>;
  constexpr int BN = 8 * NT;
  constexpr int P = K / 2;
  constexpr int IN_H = S::IN_H, IN_W = S::IN_W;
  // dynamic: k5 at BN = 64 stages 76.8 KB of weights, over the 48 KB of
  // static shared memory
  extern __shared__ uint4 wd_smem[];
  uint32_t* s_in = reinterpret_cast<uint32_t*>(wd_smem);
  uint32_t* s_w = s_in + S::IN_WORDS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int x0 = blockIdx.x * WD_TW, y0 = blockIdx.y * WD_TH;
  const int n_co = cout_pad / BN;
  const int b = blockIdx.z / n_co, co0 = (blockIdx.z % n_co) * BN;
  const int wr = warp >> 1;        // the warp's output row in the tile
  const int wc = (warp & 1) * 32;  // and its first output column

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  int wc0 = 0;  // the leg's first channel in the packed weight rows
  for (int l = 0; l < legs.n; ++l) {
    const int Cin = legs.cin[l];
    const size_t img = (size_t)H * W * Cin;
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(legs.x[l]);
    const __nv_bfloat16* xa = base + (size_t)(b + legs.b_off[l]) * img;
    const __nv_bfloat16* xs =
        fuse_n ? base + (size_t)(b + legs.b_off[l] + fuse_n) * img : nullptr;
    const int s2d = legs.s2d, cb = Cin >> 2;  // s2d: channels a phase
    // 8 channels a load where they lie in one phase
    const bool vec = (Cin % 8) == 0 && (!s2d || cb % 8 == 0);

    for (int ci0 = 0; ci0 < Cin; ci0 += WD_CK) {
      // stage the input tile: reflect halo (per phase in s2d mode), zeros
      // past the leg's channels, the fuse_n sibling added in f32 and
      // rounded to bf16 (as a bf16 add)
      for (int idx = tid; idx < IN_H * IN_W * 2; idx += WD_THREADS) {
        const int half = idx & 1, pix = idx >> 1;
        const int r = pix / IN_W, c = pix - r * IN_W;
        const int c0 = ci0 + 8 * half;
        const int ty = y0 - P + r, tx = x0 - P + c;
        const size_t off =
            src_pixel(ty, tx, H, W, s2d, s2d && c0 < Cin ? c0 / cb : 0) * Cin + c0;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (vec) {
          if (c0 < Cin && xs) {
            float v[8], s[8];
            load8(xa + off, v);
            load8(xs + off, s);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] += s[j];
            u = pack8_bf16(v);
          } else if (c0 < Cin) {
            u = *reinterpret_cast<const uint4*>(xa + off);
          }
        } else {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            v[j] = 0.f;
            if (c0 + j < Cin) {
              // s2d: each channel in its own phase's halo
              const size_t o =
                  s2d ? src_pixel(ty, tx, H, W, 1, (c0 + j) / cb) * Cin + c0 + j : off + j;
              v[j] = to_f32(xa[o]);
              if (xs) v[j] += to_f32(xs[o]);
            }
          }
          u = pack8_bf16(v);
        }
        *reinterpret_cast<uint4*>(s_in + pix * WD_PW + 4 * half) = u;
      }
      // stage the chunk's weights: k^2 x BN rows of 16 input channels
      for (int idx = tid; idx < K * K * BN * 2; idx += WD_THREADS) {
        const int half = idx & 1, row = idx >> 1;  // row = tap * BN + co
        const int tap = row / BN, co = row - tap * BN;
        const __nv_bfloat16* src =
            w + ((size_t)tap * cout_pad + co0 + co) * cin_pad + wc0 + ci0 + 8 * half;
        *reinterpret_cast<uint4*>(s_w + row * WD_PW + 4 * half) =
            *reinterpret_cast<const uint4*>(src);
      }
      __syncthreads();

#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          // B fragments: b0 = W[co = g][ci = 2t, 2t+1], b1 = ci + 8
          uint32_t bf[NT][2];
          const uint32_t* wrow = s_w + ((kh * K + kw) * BN + g) * WD_PW + t;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bf[j][0] = wrow[j * 8 * WD_PW];
            bf[j][1] = wrow[j * 8 * WD_PW + 4];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // A fragment: pixels g and g + 8 of the m-tile, shifted by the tap
            const uint32_t* p0 =
                s_in + ((wr + kh) * IN_W + wc + 16 * i + g + kw) * WD_PW + t;
            const uint32_t* p1 = p0 + 8 * WD_PW;
            const uint32_t a[4] = {p0[0], p1[0], p0[4], p1[4]};
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
          }
        }
      }
      __syncthreads();
    }
    wc0 += (Cin + WD_CK - 1) / WD_CK * WD_CK;
  }

  // epilogue: bias + activation in f32, round to bf16, two channels a store
  const int gy = y0 + wr;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = co0 + 8 * j + 2 * t;
    if (co >= Cout) continue;  // Cout even: both channels of the pair are past it
    const float bv0 = bias ? bias[co] : 0.f, bv1 = bias ? bias[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gx = x0 + wc + 16 * i + g + 8 * e;
        if (gx >= W) continue;
        __nv_bfloat16* dst = y + (((size_t)b * H + gy) * W + gx) * Cout + co;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(apply_act(acc[i][j][2 * e] + bv0, act),
                                  apply_act(acc[i][j][2 * e + 1] + bv1, act));
      }
    }
  }
}

template <int K, int NT>
static int launch_wide(const Legs& legs, const void* w, const float* bias, void* y, int b_out,
                       int h, int wd, int cout, int cout_pad, int cin_pad, int fuse_n, int act,
                       cudaStream_t s) {
  constexpr size_t smem = WideSmem<K, NT>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_wide_mma_kernel<K, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((wd + WD_TW - 1) / WD_TW, (h + WD_TH - 1) / WD_TH,
                  b_out * (cout_pad / (8 * NT)));
  conv_wide_mma_kernel<K, NT><<<grid, WD_THREADS, smem, s>>>(
      legs, static_cast<const __nv_bfloat16*>(w), bias, static_cast<__nv_bfloat16*>(y), h, wd,
      cout, cout_pad, cin_pad, fuse_n, act);
  return (int)cudaGetLastError();
}

template <int K>
static int wide_by_bn(int bn, const Legs& legs, const void* w, const float* bias, void* y,
                      int b_out, int h, int wd, int cout, int cout_pad, int cin_pad, int fuse_n,
                      int act, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_wide<K, 2>(legs, w, bias, y, b_out, h, wd, cout, cout_pad, cin_pad, fuse_n, act, s);
    case 32: return launch_wide<K, 4>(legs, w, bias, y, b_out, h, wd, cout, cout_pad, cin_pad, fuse_n, act, s);
    case 64: return launch_wide<K, 8>(legs, w, bias, y, b_out, h, wd, cout, cout_pad, cin_pad, fuse_n, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K>
static int wide_f32(const Legs& legs, const float* w, const float* bias, void* y, int b_out,
                    int h, int wd, int cout, int fuse_n, int act, cudaStream_t s) {
  if (cout % 16 == 0)
    return launch_chain<K, 16>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  if (cout % 8 == 0)
    return launch_chain<K, 8>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  return launch_chain<K, 4>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
}

template <int K>
static int wide_launch(int dtype, const Legs& legs, const void* w, const float* bias, void* y,
                       int b_out, int h, int wd, int cout, int bn, int cin_pad, int fuse_n,
                       int act, cudaStream_t s) {
  if (dtype == DT_F32)
    return wide_f32<K>(legs, static_cast<const float*>(w), bias, y, b_out, h, wd, cout, fuse_n,
                       act, s);
  if (dtype != DT_BF16 || bn <= 0) return (int)cudaErrorInvalidValue;
  const int cout_pad = (cout + bn - 1) / bn * bn;
  return wide_by_bn<K>(bn, legs, w, bias, y, b_out, h, wd, cout, cout_pad, cin_pad, fuse_n, act,
                       s);
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
// bf16: w is (k*k, cout_pad, cin_pad) bf16, cout_pad = cout rounded up to a
// multiple of bn (16, 32 or 64), cin_pad the sum of the legs' channel counts
// each rounded up to a multiple of 16, zeros in the padding.
// f32: w is [sum(cins)][k][k][cout] f32 and bn is ignored.
int mmif_conv_wide(int dtype, int n_legs, const void* const* xs, const int* cins,
                   const int* b_offs, const void* w, const float* bias, void* y, int b_out,
                   int h, int wd, int cout, int k, int bn, int fuse_n, int act, int s2d,
                   void* stream) {
  if (n_legs < 1 || n_legs > MAX_LEGS || cout < 4 || cout % 4 ||
      (k != 1 && k != 3 && k != 5) || (s2d && (n_legs != 1 || cins[0] % 4)))
    return (int)cudaErrorInvalidValue;
  Legs legs = {};
  int cin_pad = 0;
  for (int l = 0; l < n_legs; ++l) {
    if (cins[l] < 1) return (int)cudaErrorInvalidValue;
    legs.x[l] = xs[l];
    legs.cin[l] = cins[l];
    legs.b_off[l] = b_offs[l];
    cin_pad += (cins[l] + WD_CK - 1) / WD_CK * WD_CK;
  }
  legs.n = n_legs;
  legs.s2d = s2d ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return wide_launch<1>(dtype, legs, w, bias, y, b_out, h, wd, cout, bn, cin_pad, fuse_n, act, s);
    case 3: return wide_launch<3>(dtype, legs, w, bias, y, b_out, h, wd, cout, bn, cin_pad, fuse_n, act, s);
    default: return wide_launch<5>(dtype, legs, w, bias, y, b_out, h, wd, cout, bn, cin_pad, fuse_n, act, s);
  }
}

}  // extern "C"
