// Reflect-SAME k x k convolutions of the serving chain (DeepFuse k5/k7;
// DenseFuse and VIFNet k3; UNFusion's encoder, Res2Fusion's k1 and DBNet's
// dense convs), NHWC, f32 accumulate.
//
// Replaces four TPU kernels of multi_modal_image_fusion_tpu/ops/pallas/:
//   conv_chain      <- hiw_kernel.py:335 conv_hiw_chain (every chain conv,
//                      with the fuse_n siamese-sum prologue), one leg
//   conv_multi      <- hiw_kernel.py:619 conv_hiw_chain_multi: the same
//                      kernel over up to 8 legs with batch offsets
//   conv_gray_enter <- conv_kernel.py:357 _chain_enter_gray (via hiw_enter)
//                      fused with the c_in=1 entry conv (enc0)
//   conv_gray_exit  <- conv_kernel.py:383 _chain_exit_gray (via hiw_exit)
//                      fused with the c_out=1 exit conv (dec2)
//
// What bounds them on an H100: enc1 and dec0 (16/32 -> 32, k7) do ~25k MACs
// per output pixel against ~128 bytes of bf16 traffic, far above the card's
// ~295 operations-per-byte balance, so they are bound by the tensor cores'
// 989 TFLOP/s (2.035 ms each at 16 pairs of 1224x1024). The k3 DenseFuse and
// VIFNet layers do 2.3k-147k MACs against 64-512 bytes (72-576 operations
// per byte): the 16-channel ones are bound by their bytes, the 64- and
// 128-channel ones by operations. In bf16 conv_chain and conv_multi run the
// wgmma implicit GEMM of conv_chain.cuh on the tensor cores; in f32 its
// register-blocked FMA body (67 TFLOP/s of f32 CUDA cores; TF32 would miss
// the f32 budget). The thin enter (c_in=1) and exit (c_out=1) layers move
// more bytes than they compute and get their own f32 FMA loops. The TPU
// layout (H-major guard bands, banded weights, W-on-lanes strips) is not
// carried over: the halo is reflect index math in the tile load.
#include "conv_chain.cuh"

namespace mmif {

// Kernel sizes 1, 3, 5 and 7, as the TPU kernels take (DenseFuse and VIFNet
// run k3, DeepFuse k5 and k7); Cout a multiple of 16.
constexpr int CO_TILE = 16;

static int chain_f32(int k, const Legs& legs, const float* w, const float* bias, void* y,
                     int b_out, int h, int wd, int cout, int fuse_n, int act, cudaStream_t s) {
  switch (k) {
    case 1: return launch_chain<1, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 3: return launch_chain<3, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 5: return launch_chain<5, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    case 7: return launch_chain<7, CO_TILE>(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template int chain_tc_by_bn<1>(int, const TcArgs&, cudaStream_t);

// f32: w [sum cin][k][k][cout] f32, the FMA body; bf16: w packed for the
// wgmma body (conv_chain.cuh TcArgs::w) with N blocks of bn channels.
static int chain_launch(int dtype, int k, int bn, const Legs& legs, const void* w,
                        const float* bias, void* y, int b_out, int h, int wd, int cout,
                        int fuse_n, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % CO_TILE || b_out < 1 || h <= k / 2 || wd <= k / 2) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return chain_f32(k, legs, static_cast<const float*>(w), bias, y, b_out, h, wd, cout,
                     fuse_n, act, s);
  if (dtype == DT_BF16)
    return launch_tc(k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// conv_gray_enter: img1 (B,H,W,1) [+ img2] in T -> (B or 2B, H, W, Cout) in T
// ---------------------------------------------------------------------------
// K*K taps of one channel: the whole tile and the K x K x CO_T weights fit in
// static shared memory; each thread computes EN_PX pixels x CO_T channels.
constexpr int EN_TH = 8, EN_TW = 64, EN_PX = 4;
constexpr int EN_THREADS = (EN_TW / EN_PX) * EN_TH;  // 128

template <typename T, int K, int CO_T>
__global__ void __launch_bounds__(EN_THREADS)
conv_gray_enter_kernel(const T* __restrict__ img1, const T* __restrict__ img2,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       T* __restrict__ y, int B, int H, int W, int Cout, int act) {
  using G = TileGeom<EN_TW, EN_PX, K>;
  constexpr int P = K / 2;
  constexpr int IN_H = EN_TH + K - 1;
  __shared__ __align__(16) float s_in[IN_H * G::PITCH];
  __shared__ __align__(16) float s_w[K * K * CO_T];

  const int tid = threadIdx.x;
  const int tx = tid % (EN_TW / EN_PX);
  const int ty = tid / (EN_TW / EN_PX);
  const int x0 = blockIdx.x * EN_TW;
  const int y0 = blockIdx.y * EN_TH;
  const int n_co = Cout / CO_T;
  const int b = blockIdx.z / n_co;  // 0..B-1 from img1, B..2B-1 from img2
  const int co0 = (blockIdx.z % n_co) * CO_T;
  const T* src = b < B ? img1 + (size_t)b * H * W : img2 + (size_t)(b - B) * H * W;

  for (int idx = tid; idx < IN_H * G::PITCH; idx += EN_THREADS) {
    const int r = idx / G::PITCH, c = idx % G::PITCH;
    s_in[idx] = c < G::W_IN
                    ? to_f32(src[(size_t)reflect_index(y0 - P + r, H) * W +
                                 reflect_index(x0 - P + c, W)])
                    : 0.f;
  }
  for (int idx = tid; idx < K * K * CO_T; idx += EN_THREADS)
    s_w[idx] = w[(idx / CO_T) * Cout + co0 + idx % CO_T];
  __syncthreads();

  float acc[EN_PX][CO_T];
#pragma unroll
  for (int p = 0; p < EN_PX; ++p)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[p][c] = 0.f;

#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
    float v[4 * G::NV];
    const float4* row = reinterpret_cast<const float4*>(s_in + (ty + kh) * G::PITCH + tx * EN_PX);
#pragma unroll
    for (int q = 0; q < G::NV; ++q) {
      const float4 t = row[q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int kw = 0; kw < K; ++kw) {
      const float4* wr = reinterpret_cast<const float4*>(s_w + (kh * K + kw) * CO_T);
#pragma unroll
      for (int cq = 0; cq < CO_T / 4; ++cq) {
        const float4 wv = wr[cq];
#pragma unroll
        for (int p = 0; p < EN_PX; ++p) {
          const float xv = v[p + kw];
          acc[p][4 * cq + 0] = fmaf(xv, wv.x, acc[p][4 * cq + 0]);
          acc[p][4 * cq + 1] = fmaf(xv, wv.y, acc[p][4 * cq + 1]);
          acc[p][4 * cq + 2] = fmaf(xv, wv.z, acc[p][4 * cq + 2]);
          acc[p][4 * cq + 3] = fmaf(xv, wv.w, acc[p][4 * cq + 3]);
        }
      }
    }
  }

  const int gy = y0 + ty;
  if (gy >= H) return;
  float bv[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) bv[c] = bias ? bias[co0 + c] : 0.f;
#pragma unroll
  for (int p = 0; p < EN_PX; ++p) {
    const int gx = x0 + tx * EN_PX + p;
    if (gx >= W) continue;
    T* dst = y + (((size_t)b * H + gy) * W + gx) * Cout + co0;
    float o[CO_T];
#pragma unroll
    for (int c = 0; c < CO_T; ++c) o[c] = apply_act(acc[p][c] + bv[c], act);
#pragma unroll
    for (int c = 0; c < CO_T; c += 8) store8(dst + c, o + c);
  }
}

template <typename T, int K>
static int launch_enter(const void* img1, const void* img2, const float* w,
                        const float* bias, void* y, int b, int h, int wd, int cout, int act,
                        cudaStream_t stream) {
  const int b_out = img2 ? 2 * b : b;
  const dim3 grid((wd + EN_TW - 1) / EN_TW, (h + EN_TH - 1) / EN_TH, b_out * (cout / CO_TILE));
  conv_gray_enter_kernel<T, K, CO_TILE><<<grid, EN_THREADS, 0, stream>>>(
      static_cast<const T*>(img1), static_cast<const T*>(img2), w, bias, static_cast<T*>(y),
      b, h, wd, cout, act);
  return (int)cudaGetLastError();
}

// Built for the ported models' c_in=1 entry convs: k3 (DenseFuse and VIFNet
// conv_in) and k5 (DeepFuse enc0), Cout a multiple of 16, images already in
// the chain dtype (f32 in the test CLI, bf16 in the bench).
template <typename T>
static int enter_by_k(const void* img1, const void* img2, const float* w, const float* bias,
                      void* y, int b, int h, int wd, int cout, int k, int act,
                      cudaStream_t s) {
  if (cout % CO_TILE) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 3: return launch_enter<T, 3>(img1, img2, w, bias, y, b, h, wd, cout, act, s);
    case 5: return launch_enter<T, 5>(img1, img2, w, bias, y, b, h, wd, cout, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// conv_gray_exit: (B, H, W, Cin) in T -> (B, H, W, 1) in T, weights [Cin][K][K]
// ---------------------------------------------------------------------------
// One output channel: each thread computes EX_PX consecutive pixels, so one
// row segment load and one broadcast weight feed EX_PX FMAs.
constexpr int EX_TH = 8, EX_TW = 128, EX_PX = 8, EX_CI = 4;
constexpr int EX_THREADS = (EX_TW / EX_PX) * EX_TH;  // 128

template <typename T, int K>
__global__ void __launch_bounds__(EX_THREADS)
conv_gray_exit_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y, int H, int W,
                      int Cin, int act) {
  using G = TileGeom<EX_TW, EX_PX, K>;
  constexpr int P = K / 2;
  constexpr int IN_H = EX_TH + K - 1;
  __shared__ __align__(16) float s_in[EX_CI * IN_H * G::PITCH];
  __shared__ float s_w[EX_CI * K * K];

  const int tid = threadIdx.x;
  const int tx = tid % (EX_TW / EX_PX);
  const int ty = tid / (EX_TW / EX_PX);
  const int x0 = blockIdx.x * EX_TW;
  const int y0 = blockIdx.y * EX_TH;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc[EX_PX];
#pragma unroll
  for (int p = 0; p < EX_PX; ++p) acc[p] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += EX_CI) {
    for (int idx = tid; idx < IN_H * G::PITCH; idx += EX_THREADS) {
      const int r = idx / G::PITCH, c = idx % G::PITCH;
      const bool inside = c < G::W_IN;
      const size_t off = inside ? ((size_t)reflect_index(y0 - P + r, H) * W +
                                   reflect_index(x0 - P + c, W)) * Cin + ci0
                                : 0;
#pragma unroll
      for (int j = 0; j < EX_CI; ++j)
        s_in[(j * IN_H + r) * G::PITCH + c] =
            (inside && ci0 + j < Cin) ? to_f32(xb[off + j]) : 0.f;
    }
    for (int idx = tid; idx < EX_CI * K * K; idx += EX_THREADS)
      s_w[idx] = (ci0 + idx / (K * K) < Cin) ? w[(size_t)ci0 * K * K + idx] : 0.f;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < EX_CI; ++j) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float v[4 * G::NV];
        const float4* row = reinterpret_cast<const float4*>(
            s_in + (j * IN_H + ty + kh) * G::PITCH + tx * EX_PX);
#pragma unroll
        for (int q = 0; q < G::NV; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float wv = s_w[(j * K + kh) * K + kw];
#pragma unroll
          for (int p = 0; p < EX_PX; ++p) acc[p] = fmaf(v[p + kw], wv, acc[p]);
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + ty;
  if (gy >= H) return;
  const float bv = bias ? bias[0] : 0.f;
  T* dst = y + ((size_t)b * H + gy) * W;
#pragma unroll
  for (int p = 0; p < EX_PX; ++p) {
    const int gx = x0 + tx * EX_PX + p;
    if (gx < W) dst[gx] = from_f32<T>(apply_act(acc[p] + bv, act));
  }
}

template <typename T, int K>
static int launch_exit(const void* x, const float* w, const float* bias, void* y, int b,
                       int h, int wd, int cin, int act, cudaStream_t s) {
  const dim3 grid((wd + EX_TW - 1) / EX_TW, (h + EX_TH - 1) / EX_TH, b);
  conv_gray_exit_kernel<T, K><<<grid, EX_THREADS, 0, s>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), h, wd, cin, act);
  return (int)cudaGetLastError();
}

// Built for the ported models' c_out=1 exit convs: k1 (UNFusion conv_out),
// k3 (DenseFuse dec3, VIFNet dec4, DBNet dec3) and k5 (DeepFuse dec2).
template <typename T>
static int exit_by_k(int k, const void* x, const float* w, const float* bias, void* y, int b,
                     int h, int wd, int cin, int act, cudaStream_t s) {
  switch (k) {
    case 1: return launch_exit<T, 1>(x, w, bias, y, b, h, wd, cin, act, s);
    case 3: return launch_exit<T, 3>(x, w, bias, y, b, h, wd, cin, act, s);
    case 5: return launch_exit<T, 5>(x, w, bias, y, b, h, wd, cin, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// x (b_in, h, w, cin) in dtype; w as chain_launch takes it (bn: the bf16 N
// block, 16, 32, 48, 64, 96, 128 or 256; ignored in f32); bias f32 or null;
// y (b_out, h, w, cout) in dtype. fuse_n > 0: b_in == 2 * fuse_n == 2 * b_out.
// The kernel with one leg at batch offset 0.
int mmif_conv_chain(int dtype, const void* x, const void* w, const float* bias, void* y,
                    int b_out, int h, int wd, int cin, int cout, int k, int bn, int fuse_n,
                    int act, void* stream) {
  if (cin < 1) return (int)cudaErrorInvalidValue;
  Legs legs = {};
  legs.x[0] = x;
  legs.cin[0] = cin;
  legs.n = 1;
  return chain_launch(dtype, k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, stream);
}

// n_legs legs: xs[l] (B_l, h, w, cins[l]) in dtype, read at batch b + b_offs[l]
// (and b + b_offs[l] + fuse_n when fuse_n > 0) for output image b;
// w and bn as mmif_conv_chain takes them; bias f32 or null; y (b_out, h, w,
// cout).
int mmif_conv_multi(int dtype, int n_legs, const void* const* xs, const int* cins,
                    const int* b_offs, const void* w, const float* bias, void* y, int b_out,
                    int h, int wd, int cout, int k, int bn, int fuse_n, int act, void* stream) {
  if (n_legs < 1 || n_legs > MAX_LEGS) return (int)cudaErrorInvalidValue;
  Legs legs = {};
  for (int l = 0; l < n_legs; ++l) {
    if (cins[l] < 1) return (int)cudaErrorInvalidValue;
    legs.x[l] = xs[l];
    legs.cin[l] = cins[l];
    legs.b_off[l] = b_offs[l];
  }
  legs.n = n_legs;
  return chain_launch(dtype, k, bn, legs, w, bias, y, b_out, h, wd, cout, fuse_n, act, stream);
}

// img1, img2 (b, h, w, 1) in dtype (img2 may be null); w [k][k][cout] f32;
// y (b or 2b, h, w, cout) in dtype.
int mmif_conv_gray_enter(int dtype, const void* img1, const void* img2, const float* w,
                         const float* bias, void* y, int b, int h, int wd, int cout, int k,
                         int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return enter_by_k<float>(img1, img2, w, bias, y, b, h, wd, cout, k, act, s);
  if (dtype == DT_BF16)
    return enter_by_k<__nv_bfloat16>(img1, img2, w, bias, y, b, h, wd, cout, k, act, s);
  return (int)cudaErrorInvalidValue;
}

// x (b, h, w, cin) in dtype; w [cin][k][k] f32; y (b, h, w, 1) in dtype.
int mmif_conv_gray_exit(int dtype, const void* x, const float* w, const float* bias, void* y,
                        int b, int h, int wd, int cin, int k, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return exit_by_k<float>(k, x, w, bias, y, b, h, wd, cin, act, s);
  if (dtype == DT_BF16)
    return exit_by_k<__nv_bfloat16>(k, x, w, bias, y, b, h, wd, cin, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
