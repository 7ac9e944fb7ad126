// VALID k x k convolution of a pre-padded NHWC input, f32 accumulate.
//
// Replaces the TPU kernel multi_modal_image_fusion_tpu/ops/pallas/
// conv_kernel.py:161 conv_tlane_dma, which the training path launches three
// ways: the forward and the dx of the differentiable conv
// (ops/pallas/conv_vjp.py:71 conv_valid_fast), and the valid step's conv
// with bias and activation fused into the epilogue.
//
//   y[b,i,j,co] = act(bias[co] + sum_{kh,kw,ci} xp[b,i+kh,j+kw,ci] * w[ci][kh][kw][co])
//
// xp is (B, H+K-1, W+K-1, Cin): the caller has padded it (reflect for the
// forward, zeros by K-1 for dx), so the tile load indexes it directly and
// there is no halo math. Any Cin >= 1 and Cout >= 1: the last chunk of input
// channels is zero-filled in shared memory and skipped in the FMA loop, the
// last chunk of output channels is masked at the weight load and the store.
//
// What bounds it on an H100: the wide launches (16/32 -> 32 channels, k7:
// enc1 and dec0 forward, dec0 and enc1 dx) do 12-25k MACs per output pixel
// against ~100-200 bytes of traffic, far above the card's balance, so they
// are bound by arithmetic; the thin ones (Cin or Cout = 1: enc0 forward,
// dec2 forward and dx) move more bytes than they compute. This first kernel
// takes conv_chain.cu's design for the wide case: a 8x64 output tile plus
// its halo staged in shared memory (f32, channel-major) 8 input channels at
// a time next to the matching weight slice, and a 4-pixel x 16-channel block
// of f32 accumulators per thread, so each shared-memory load feeds 4-16
// FMAs on the CUDA cores. The thin launches reuse the same loop (the FMA
// loop runs only over the real input channels); their time is dominated by
// launch overhead at the training shapes. The TPU kernel's W-on-lanes
// transposed strips, 128-lane rounding and kh-stacked A operand answer
// Mosaic and the MXU and are not carried over; the tensor cores (wgmma, TMA)
// are later work.
#include "common.cuh"

namespace mmif {

constexpr int VA_TH = 8, VA_TW = 64, VA_PX = 4, VA_CI = 8, VA_CO = 16;
constexpr int VA_THREADS = (VA_TW / VA_PX) * VA_TH;  // 128

template <int K>
struct ValidSmem {
  using G = TileGeom<VA_TW, VA_PX, K>;
  static constexpr int IN_H = VA_TH + K - 1;
  static constexpr int IN_FLOATS = VA_CI * IN_H * G::PITCH;
  static constexpr int W_FLOATS = VA_CI * K * K * VA_CO;
  static constexpr size_t BYTES = (IN_FLOATS + W_FLOATS) * sizeof(float);
};

// x (B, H+K-1, W+K-1, Cin) in T; w [Cin][K][K][Cout] f32; y (B, H, W, Cout)
template <typename T, int K>
__global__ void __launch_bounds__(VA_THREADS)
conv_valid_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ y, int H, int W,
                  int Cin, int Cout, int act) {
  using S = ValidSmem<K>;
  using G = typename S::G;
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);  // [VA_CI][IN_H][PITCH]
  float* s_w = s_in + S::IN_FLOATS;               // [VA_CI][K][K][VA_CO]

  const int Hp = H + K - 1, Wp = W + K - 1;
  const int tid = threadIdx.x;
  const int tx = tid % (VA_TW / VA_PX);
  const int ty = tid / (VA_TW / VA_PX);
  const int x0 = blockIdx.x * VA_TW;
  const int y0 = blockIdx.y * VA_TH;
  const int n_co = (Cout + VA_CO - 1) / VA_CO;
  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * VA_CO;
  const T* xb = x + (size_t)b * Hp * Wp * Cin;
  const bool vec = (Cin % 8) == 0;

  float acc[VA_PX][VA_CO];
#pragma unroll
  for (int p = 0; p < VA_PX; ++p)
#pragma unroll
    for (int c = 0; c < VA_CO; ++c) acc[p][c] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += VA_CI) {
    // stage the input tile: rows y0..y0+TH+K-2, columns x0..x0+TW+K-2 of xp
    for (int idx = tid; idx < S::IN_H * G::PITCH; idx += VA_THREADS) {
      const int r = idx / G::PITCH, c = idx % G::PITCH;
      const int gy = y0 + r, gx = x0 + c;
      float v[VA_CI];
#pragma unroll
      for (int j = 0; j < VA_CI; ++j) v[j] = 0.f;
      if (c < G::W_IN && gy < Hp && gx < Wp) {
        const size_t off = ((size_t)gy * Wp + gx) * Cin + ci0;
        if (vec) {
          load8(xb + off, v);
        } else {
#pragma unroll
          for (int j = 0; j < VA_CI; ++j)
            if (ci0 + j < Cin) v[j] = to_f32(xb[off + j]);
        }
      }
#pragma unroll
      for (int j = 0; j < VA_CI; ++j) s_in[(j * S::IN_H + r) * G::PITCH + c] = v[j];
    }
    // stage the weight slice, zeros past Cin and Cout
    for (int idx = tid; idx < S::W_FLOATS; idx += VA_THREADS) {
      const int co = idx % VA_CO;
      const int t = idx / VA_CO;  // j * K * K + tap
      const int j = t / (K * K);
      s_w[idx] = (ci0 + j < Cin && co0 + co < Cout)
                     ? w[((size_t)(ci0 + j) * K * K + t % (K * K)) * Cout + co0 + co]
                     : 0.f;
    }
    __syncthreads();

    const int jn = min(VA_CI, Cin - ci0);
#pragma unroll 1
    for (int j = 0; j < jn; ++j) {
      const float* s_in_j = s_in + j * S::IN_H * G::PITCH;
      const float* s_w_j = s_w + j * K * K * VA_CO;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float v[4 * G::NV];
        const float4* row =
            reinterpret_cast<const float4*>(s_in_j + (ty + kh) * G::PITCH + tx * VA_PX);
#pragma unroll
        for (int q = 0; q < G::NV; ++q) {
          const float4 t = row[q];
          v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4* wr = reinterpret_cast<const float4*>(s_w_j + (kh * K + kw) * VA_CO);
#pragma unroll
          for (int cq = 0; cq < VA_CO / 4; ++cq) {
            const float4 wv = wr[cq];
#pragma unroll
            for (int p = 0; p < VA_PX; ++p) {
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

  // epilogue: bias + activation in f32, cast, masked store of the channel chunk
  const int gy = y0 + ty;
  if (gy >= H) return;
  float bv[VA_CO];
#pragma unroll
  for (int c = 0; c < VA_CO; ++c) bv[c] = (bias && co0 + c < Cout) ? bias[co0 + c] : 0.f;
  const bool vec_out = (Cout % 8) == 0;
#pragma unroll
  for (int p = 0; p < VA_PX; ++p) {
    const int gx = x0 + tx * VA_PX + p;
    if (gx >= W) continue;
    T* dst = y + (((size_t)b * H + gy) * W + gx) * Cout + co0;
    float o[VA_CO];
#pragma unroll
    for (int c = 0; c < VA_CO; ++c) o[c] = apply_act(acc[p][c] + bv[c], act);
    if (vec_out) {
#pragma unroll
      for (int c = 0; c < VA_CO; c += 8)
        if (co0 + c < Cout) store8(dst + c, o + c);
    } else {
#pragma unroll
      for (int c = 0; c < VA_CO; ++c)
        if (co0 + c < Cout) dst[c] = from_f32<T>(o[c]);
    }
  }
}

template <typename T, int K>
static int launch_valid(const void* x, const float* w, const float* bias, void* y, int b,
                        int h, int wd, int cin, int cout, int act, cudaStream_t stream) {
  constexpr size_t smem = ValidSmem<K>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_valid_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_co = (cout + VA_CO - 1) / VA_CO;
  const dim3 grid((wd + VA_TW - 1) / VA_TW, (h + VA_TH - 1) / VA_TH, b * n_co);
  conv_valid_kernel<T, K><<<grid, VA_THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), h, wd, cin, cout, act);
  return (int)cudaGetLastError();
}

// Built for what DeepFuse's training launches: k5 and k7.
template <typename T>
static int valid_by_k(int k, const void* x, const float* w, const float* bias, void* y, int b,
                      int h, int wd, int cin, int cout, int act, cudaStream_t s) {
  if (cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 5: return launch_valid<T, 5>(x, w, bias, y, b, h, wd, cin, cout, act, s);
    case 7: return launch_valid<T, 7>(x, w, bias, y, b, h, wd, cin, cout, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// x (b, h+k-1, w+k-1, cin) in dtype; w [cin][k][k][cout] f32; bias f32 or
// null; y (b, h, w, cout) in dtype.
int mmif_conv_valid(int dtype, const void* x, const float* w, const float* bias, void* y,
                    int b, int h, int wd, int cin, int cout, int k, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return valid_by_k<float>(k, x, w, bias, y, b, h, wd, cin, cout, act, s);
  if (dtype == DT_BF16)
    return valid_by_k<__nv_bfloat16>(k, x, w, bias, y, b, h, wd, cin, cout, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
