// The conv_chain kernel body: a register-blocked f32-FMA reflect-SAME conv
// over up to MAX_LEGS input legs (csrc/conv_chain.cu explains the design).
// conv_chain.cu launches it for conv_chain and conv_multi; conv_wide.cu
// launches it for conv_wide's f32 path, with 8 or 4 output channels a
// block where Cout is not a multiple of 16, and for its s2d mode.
#pragma once

#include "common.cuh"

namespace mmif {

// ---------------------------------------------------------------------------
// conv_chain: L legs (B_l, H, W, Cin_l) -> (B_out, H, W, Cout), weights
// [sum Cin_l][K][K][Cout]
// ---------------------------------------------------------------------------
// A conv is linear in its input channels, so the conv over the channel
// concat of several legs is the sum of per-leg convs with the matching
// slices of the weight (legs in concat order):
//
//   y[b] = act(bias + sum_l conv(x_l[b + b_off_l] (+ x_l[b + b_off_l + fuse_n]), W_l))
//
// One leg at b_off 0 is the plain chain conv (conv_hiw_chain). Several legs
// replace hiw_kernel.py:619 conv_hiw_chain_multi: DenseBlock growth (the legs
// x0, y1, y2, y3 of DenseFuse and VIFNet), concat fusion across the siamese
// halves (VIFNet's decoder entry reads the same 4 legs at batch offsets 0 and
// n), and, with a centre-tap identity weight on a leg, a residual add.
//
// One block computes a TH x TW output tile for CO_T output channels. Each
// leg's input tile plus halo is staged in shared memory CI_C channels at a
// time (f32, channel-major so a thread's row segment is one to three float4
// loads), next to the matching CI_C x K x K x CO_T weight slice. The legs
// are an outer loop around the channel chunks, each with its own base
// pointer, channel count and batch offset; legs of any channel count work
// (a 1-channel leg loads scalars and runs one FMA channel).
constexpr int CH_TH = 8, CH_TW = 64, CH_PX = 4, CH_CI = 8;
constexpr int CH_THREADS = (CH_TW / CH_PX) * CH_TH;  // 128
constexpr int MAX_LEGS = 8;

// s2d: the one leg is space-to-depth packed (f = 2, ops/s2d.py; conv_wide's
// s2d mode): its halo is the packed reflect extension (src_pixel).
struct Legs {
  const void* x[MAX_LEGS];
  int cin[MAX_LEGS];
  int b_off[MAX_LEGS];
  int n;
  int s2d;
};

template <int K, int CO_T>
struct ChainSmem {
  using G = TileGeom<CH_TW, CH_PX, K>;
  static constexpr int IN_H = CH_TH + K - 1;
  static constexpr int IN_FLOATS = CH_CI * IN_H * G::PITCH;
  static constexpr int W_FLOATS = CH_CI * K * K * CO_T;
  static constexpr size_t BYTES = (IN_FLOATS + W_FLOATS) * sizeof(float);
};

// internal linkage: each source that includes this header has its own copy
namespace {

template <typename T, int K, int CO_T>
__global__ void __launch_bounds__(CH_THREADS)
conv_chain_kernel(Legs legs, const float* __restrict__ w, const float* __restrict__ bias,
                  T* __restrict__ y, int H, int W, int Cout, int fuse_n, int act) {
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

  float acc[CH_PX][CO_T];
#pragma unroll
  for (int p = 0; p < CH_PX; ++p)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[p][c] = 0.f;

  int wc0 = 0;  // the leg's first input channel in the concat (weight rows)
  for (int l = 0; l < legs.n; ++l) {
    const int Cin = legs.cin[l];
    const size_t img = (size_t)H * W * Cin;
    const T* base = static_cast<const T*>(legs.x[l]);
    const T* xa = base + (size_t)(b + legs.b_off[l]) * img;
    const T* xs = fuse_n ? base + (size_t)(b + legs.b_off[l] + fuse_n) * img : nullptr;
    const int s2d = legs.s2d, cb = Cin >> 2;  // s2d: channels a phase
    // 8 channels a load where they lie in one phase
    const bool vec = (Cin % 8) == 0 && (!s2d || cb % 8 == 0);

    for (int ci0 = 0; ci0 < Cin; ci0 += CH_CI) {
      // stage the input tile (reflect halo, fuse_n sibling added in f32)
      for (int idx = tid; idx < S::IN_H * G::PITCH; idx += CH_THREADS) {
        const int r = idx / G::PITCH, c = idx % G::PITCH;
        float v[CH_CI];
#pragma unroll
        for (int j = 0; j < CH_CI; ++j) v[j] = 0.f;
        if (c < G::W_IN) {
          const int ty = y0 - P + r, tx = x0 - P + c;
          const size_t off = src_pixel(ty, tx, H, W, s2d, s2d ? ci0 / cb : 0) * Cin + ci0;
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
                // s2d: each channel in its own phase's halo
                const size_t o = s2d ? src_pixel(ty, tx, H, W, 1, (ci0 + j) / cb) * Cin + ci0 + j
                                     : off + j;
                v[j] = to_f32(xa[o]);
                if (xs) v[j] += to_f32(xs[o]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < CH_CI; ++j) s_in[(j * S::IN_H + r) * G::PITCH + c] = v[j];
      }
      // stage the leg's weight slice
      for (int idx = tid; idx < S::W_FLOATS; idx += CH_THREADS) {
        const int co = idx % CO_T;
        const int t = idx / CO_T;  // j * K * K + tap
        const int j = t / (K * K);
        s_w[idx] = (ci0 + j < Cin)
                       ? w[((size_t)(wc0 + ci0 + j) * K * K + t % (K * K)) * Cout + co0 + co]
                       : 0.f;
      }
      __syncthreads();

      const int nj = min(CH_CI, Cin - ci0);
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
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
    wc0 += Cin;
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
    if constexpr (CO_T % 8 == 0) {
#pragma unroll
      for (int c = 0; c < CO_T; c += 8) store8(dst + c, o + c);
    } else {
#pragma unroll
      for (int c = 0; c < CO_T; ++c) dst[c] = from_f32<T>(o[c]);
    }
  }
}

}  // namespace

template <typename T, int K, int CO_T>
static int launch_chain(const Legs& legs, const float* w, const float* bias, void* y,
                        int b_out, int h, int wd, int cout, int fuse_n, int act,
                        cudaStream_t stream) {
  constexpr size_t smem = ChainSmem<K, CO_T>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_chain_kernel<T, K, CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((wd + CH_TW - 1) / CH_TW, (h + CH_TH - 1) / CH_TH, b_out * (cout / CO_T));
  conv_chain_kernel<T, K, CO_T><<<grid, CH_THREADS, smem, stream>>>(
      legs, w, bias, static_cast<T*>(y), h, wd, cout, fuse_n, act);
  return (int)cudaGetLastError();
}

}  // namespace mmif
