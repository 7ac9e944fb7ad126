// Reflect-SAME k x k convolutions of the DeepFuse chain, NHWC, f32 accumulate.
//
// Replaces three TPU kernels of multi_modal_image_fusion_tpu/ops/pallas/:
//   conv_chain      <- hiw_kernel.py:335 conv_hiw_chain (every chain conv,
//                      with the fuse_n siamese-sum prologue)
//   conv_gray_enter <- conv_kernel.py:357 _chain_enter_gray (via hiw_enter)
//                      fused with the c_in=1 entry conv (enc0)
//   conv_gray_exit  <- conv_kernel.py:383 _chain_exit_gray (via hiw_exit)
//                      fused with the c_out=1 exit conv (dec2)
//
// What bounds them on an H100: enc1 and dec0 (16/32 -> 32, k7) do ~25k MACs
// per output pixel against ~128 bytes of bf16 traffic, far above the card's
// ~295 operations-per-byte balance, so they are bound by arithmetic. These
// first kernels do that arithmetic on the CUDA cores in f32 (67 TFLOP/s
// peak, not the 989 TFLOP/s of bf16 tensor cores): each thread keeps a
// PX-pixel x CO_T-channel block of accumulators in registers, so every
// shared-memory load of an input row segment or a weight vector feeds
// 4-16 FMAs and the loop is FMA-bound rather than load-bound. The thin
// enter (c_in=1) and exit (c_out=1) layers move more bytes than they compute
// and get their own loops. The TPU layout (H-major guard bands, banded
// weights, W-on-lanes strips) is not carried over: the halo is reflect
// index math in the tile load, and the siamese sum is done in f32 there too.
#include "common.cuh"

namespace mmif {

// ---------------------------------------------------------------------------
// conv_chain: (B_in, H, W, Cin) -> (B_out, H, W, Cout), weights [Cin][K][K][Cout]
// ---------------------------------------------------------------------------
// One block computes a TH x TW output tile for CO_T output channels. The
// input tile plus halo is staged in shared memory CI_C channels at a time
// (f32, channel-major so a thread's row segment is one to three float4
// loads), next to the matching CI_C x K x K x CO_T weight slice.
constexpr int CH_TH = 8, CH_TW = 64, CH_PX = 4, CH_CI = 8;
constexpr int CH_THREADS = (CH_TW / CH_PX) * CH_TH;  // 128

template <int K, int CO_T>
struct ChainSmem {
  using G = TileGeom<CH_TW, CH_PX, K>;
  static constexpr int IN_H = CH_TH + K - 1;
  static constexpr int IN_FLOATS = CH_CI * IN_H * G::PITCH;
  static constexpr int W_FLOATS = CH_CI * K * K * CO_T;
  static constexpr size_t BYTES = (IN_FLOATS + W_FLOATS) * sizeof(float);
};

template <typename T, int K, int CO_T>
__global__ void __launch_bounds__(CH_THREADS)
conv_chain_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y, int H, int W,
                  int Cin, int Cout, int fuse_n, int act) {
  using S = ChainSmem<K, CO_T>;
  using G = typename S::G;
  constexpr int P = K / 2;
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);  // [CH_CI][IN_H][PITCH]
  float* s_w = s_in + S::IN_FLOATS;               // [CH_CI][K][K][CO_T]

  const int tid = threadIdx.x;
  const int tx = tid % (CH_TW / CH_PX);
  const int ty = tid / (CH_TW / CH_PX);
  const int x0 = blockIdx.x * CH_TW;
  const int y0 = blockIdx.y * CH_TH;
  const int n_co = Cout / CO_T;
  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * CO_T;

  const size_t img = (size_t)H * W * Cin;
  const T* xa = x + (size_t)b * img;
  const T* xs = fuse_n ? x + (size_t)(b + fuse_n) * img : nullptr;
  const bool vec = (Cin % 8) == 0;

  float acc[CH_PX][CO_T];
#pragma unroll
  for (int p = 0; p < CH_PX; ++p)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[p][c] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CH_CI) {
    // stage the input tile (reflect halo, siamese sum in f32)
    for (int idx = tid; idx < S::IN_H * G::PITCH; idx += CH_THREADS) {
      const int r = idx / G::PITCH, c = idx % G::PITCH;
      float v[CH_CI];
#pragma unroll
      for (int j = 0; j < CH_CI; ++j) v[j] = 0.f;
      if (c < G::W_IN) {
        const size_t off = ((size_t)reflect_index(y0 - P + r, H) * W +
                            reflect_index(x0 - P + c, W)) * Cin + ci0;
        if (vec) {
          load8(xa + off, v);
          if (xs) {
            float u[CH_CI];
            load8(xs + off, u);
#pragma unroll
            for (int j = 0; j < CH_CI; ++j) v[j] += u[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < CH_CI; ++j) {
            if (ci0 + j < Cin) {
              v[j] = to_f32(xa[off + j]);
              if (xs) v[j] += to_f32(xs[off + j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CH_CI; ++j) s_in[(j * S::IN_H + r) * G::PITCH + c] = v[j];
    }
    // stage the weight slice
    for (int idx = tid; idx < S::W_FLOATS; idx += CH_THREADS) {
      const int co = idx % CO_T;
      const int t = idx / CO_T;  // j * K * K + tap
      const int j = t / (K * K);
      s_w[idx] = (ci0 + j < Cin)
                     ? w[((size_t)(ci0 + j) * K * K + t % (K * K)) * Cout + co0 + co]
                     : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < CH_CI; ++j) {
      const float* s_in_j = s_in + j * S::IN_H * G::PITCH;
      const float* s_w_j = s_w + j * K * K * CO_T;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float v[4 * G::NV];
        const float4* row =
            reinterpret_cast<const float4*>(s_in_j + (ty + kh) * G::PITCH + tx * CH_PX);
#pragma unroll
        for (int q = 0; q < G::NV; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4* wr = reinterpret_cast<const float4*>(s_w_j + (kh * K + kw) * CO_T);
#pragma unroll
          for (int cq = 0; cq < CO_T / 4; ++cq) {
            const float4 wv = wr[cq];
#pragma unroll
            for (int p = 0; p < CH_PX; ++p) {
              const float xv = v[p + kw];
              acc[p][4 * cq + 0] = fmaf(xv, wv.x, acc[p][4 * cq + 0]);
              acc[p][4 * cq + 1] = fmaf(xv, wv.y, acc[p][4 * cq + 1]);
              acc[p][4 * cq + 2] = fmaf(xv, wv.z, acc[p][4 * cq + 2]);
              acc[p][4 * cq + 3] = fmaf(xv, wv.w, acc[p][4 * cq + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias + activation in f32, cast, 16-byte stores
  const int gy = y0 + ty;
  if (gy >= H) return;
  float bv[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) bv[c] = bias ? bias[co0 + c] : 0.f;
#pragma unroll
  for (int p = 0; p < CH_PX; ++p) {
    const int gx = x0 + tx * CH_PX + p;
    if (gx >= W) continue;
    T* dst = y + (((size_t)b * H + gy) * W + gx) * Cout + co0;
    float o[CO_T];
#pragma unroll
    for (int c = 0; c < CO_T; ++c) o[c] = apply_act(acc[p][c] + bv[c], act);
#pragma unroll
    for (int c = 0; c < CO_T; c += 8) store8(dst + c, o + c);
  }
}

template <typename T, int K, int CO_T>
static int launch_chain(const void* x, const float* w, const float* bias, void* y,
                        int b_out, int h, int wd, int cin, int cout, int fuse_n,
                        int act, cudaStream_t stream) {
  constexpr size_t smem = ChainSmem<K, CO_T>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_chain_kernel<T, K, CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((wd + CH_TW - 1) / CH_TW, (h + CH_TH - 1) / CH_TH, b_out * (cout / CO_T));
  conv_chain_kernel<T, K, CO_T><<<grid, CH_THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), h, wd, cin, cout, fuse_n, act);
  return (int)cudaGetLastError();
}

// Built for what DeepFuse launches: k5 and k7, Cout a multiple of 16.
constexpr int CO_TILE = 16;

template <typename T>
static int chain_by_k(int k, const void* x, const float* w, const float* bias, void* y,
                      int b_out, int h, int wd, int cin, int cout, int fuse_n, int act,
                      cudaStream_t s) {
  if (cout % CO_TILE) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 5: return launch_chain<T, 5, CO_TILE>(x, w, bias, y, b_out, h, wd, cin, cout, fuse_n, act, s);
    case 7: return launch_chain<T, 7, CO_TILE>(x, w, bias, y, b_out, h, wd, cin, cout, fuse_n, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Built for DeepFuse's enc0: k5, Cout a multiple of 16, images already in
// the chain dtype (f32 in the test CLI, bf16 in the bench).
template <typename T>
static int enter_k5(const void* img1, const void* img2, const float* w, const float* bias,
                    void* y, int b, int h, int wd, int cout, int k, int act,
                    cudaStream_t stream) {
  if (k != 5 || cout % CO_TILE) return (int)cudaErrorInvalidValue;
  const int b_out = img2 ? 2 * b : b;
  const dim3 grid((wd + EN_TW - 1) / EN_TW, (h + EN_TH - 1) / EN_TH, b_out * (cout / CO_TILE));
  conv_gray_enter_kernel<T, 5, CO_TILE><<<grid, EN_THREADS, 0, stream>>>(
      static_cast<const T*>(img1), static_cast<const T*>(img2), w, bias, static_cast<T*>(y),
      b, h, wd, cout, act);
  return (int)cudaGetLastError();
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

// Built for DeepFuse's dec2: k5.
template <typename T>
static int exit_k5(int k, const void* x, const float* w, const float* bias, void* y, int b,
                   int h, int wd, int cin, int act, cudaStream_t s) {
  if (k != 5) return (int)cudaErrorInvalidValue;
  const dim3 grid((wd + EX_TW - 1) / EX_TW, (h + EX_TH - 1) / EX_TH, b);
  conv_gray_exit_kernel<T, 5><<<grid, EX_THREADS, 0, s>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), h, wd, cin, act);
  return (int)cudaGetLastError();
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// x (b_in, h, w, cin) in dtype; w [cin][k][k][cout] f32; bias f32 or null;
// y (b_out, h, w, cout) in dtype. fuse_n > 0: b_in == 2 * fuse_n == 2 * b_out.
int mmif_conv_chain(int dtype, const void* x, const float* w, const float* bias, void* y,
                    int b_out, int h, int wd, int cin, int cout, int k, int fuse_n,
                    int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return chain_by_k<float>(k, x, w, bias, y, b_out, h, wd, cin, cout, fuse_n, act, s);
  if (dtype == DT_BF16)
    return chain_by_k<__nv_bfloat16>(k, x, w, bias, y, b_out, h, wd, cin, cout, fuse_n, act, s);
  return (int)cudaErrorInvalidValue;
}

// img1, img2 (b, h, w, 1) in dtype (img2 may be null); w [k][k][cout] f32;
// y (b or 2b, h, w, cout) in dtype.
int mmif_conv_gray_enter(int dtype, const void* img1, const void* img2, const float* w,
                         const float* bias, void* y, int b, int h, int wd, int cout, int k,
                         int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return enter_k5<float>(img1, img2, w, bias, y, b, h, wd, cout, k, act, s);
  if (dtype == DT_BF16)
    return enter_k5<__nv_bfloat16>(img1, img2, w, bias, y, b, h, wd, cout, k, act, s);
  return (int)cudaErrorInvalidValue;
}

// x (b, h, w, cin) in dtype; w [cin][k][k] f32; y (b, h, w, 1) in dtype.
int mmif_conv_gray_exit(int dtype, const void* x, const float* w, const float* bias, void* y,
                        int b, int h, int wd, int cin, int k, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return exit_k5<float>(k, x, w, bias, y, b, h, wd, cin, act, s);
  if (dtype == DT_BF16)
    return exit_k5<__nv_bfloat16>(k, x, w, bias, y, b, h, wd, cin, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
