// s2d_enter / s2d_exit: the packed chain's entry and exit (f = 2,
// phase-major channels, ops/s2d.py), NHWC.
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/s2d_io.py:155
// s2d_chain_enter (pallas_call :171) and :249 s2d_chain_exit (:260):
//
//   enter: img1, img2 (B, H, W, 1) -> (2B, H/2, W/2, 4) in the chain dtype,
//          out[b, y, x, py*2 + px] = cast(img[b, 2y + py, 2x + px])
//   exit:  (n, H/2, W/2, 4) -> (n, H, W, 1), the inverse
//
// What bounds them on an H100: pure data movement (each input read once,
// each output written once; 0.16 GB for the enter of 16 bf16 pairs at
// 1224x1024), so the bytes over 3.35 TB/s. One thread a packed pixel: the
// two row pairs it reads are neighbours of the next thread's, so a warp's
// loads and stores are contiguous runs. The TPU kernel's lane bit-pun and
// strip DMAs solve Mosaic's tiling rules; here the phase split is index
// math.
#include "common.cuh"

namespace mmif {

constexpr int S2D_THREADS = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(S2D_THREADS)
s2d_enter_kernel(const TI* __restrict__ img1, const TI* __restrict__ img2,
                 TO* __restrict__ y, int B, int H, int W) {
  const int w2 = W / 2, h2 = H / 2;
  const size_t n_out = (size_t)2 * B * h2 * w2;
  for (size_t i = (size_t)blockIdx.x * S2D_THREADS + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * S2D_THREADS) {
    const int x = (int)(i % w2);
    const size_t t = i / w2;
    const int yy = (int)(t % h2);
    const int b = (int)(t / h2);
    const TI* src = (b < B ? img1 + (size_t)b * H * W : img2 + (size_t)(b - B) * H * W) +
                    (size_t)(2 * yy) * W + 2 * x;
    TO* dst = y + i * 4;
    dst[0] = from_f32<TO>(to_f32(src[0]));
    dst[1] = from_f32<TO>(to_f32(src[1]));
    dst[2] = from_f32<TO>(to_f32(src[W]));
    dst[3] = from_f32<TO>(to_f32(src[W + 1]));
  }
}

template <typename T>
__global__ void __launch_bounds__(S2D_THREADS)
s2d_exit_kernel(const T* __restrict__ x, T* __restrict__ y, int n, int H, int W) {
  const int w2 = W / 2, h2 = H / 2;
  const size_t n_in = (size_t)n * h2 * w2;
  for (size_t i = (size_t)blockIdx.x * S2D_THREADS + threadIdx.x; i < n_in;
       i += (size_t)gridDim.x * S2D_THREADS) {
    const int xx = (int)(i % w2);
    const size_t t = i / w2;
    const int yy = (int)(t % h2);
    const int b = (int)(t / h2);
    const T* src = x + i * 4;
    T* dst = y + ((size_t)b * H + 2 * yy) * W + 2 * xx;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[W] = src[2];
    dst[W + 1] = src[3];
  }
}

static unsigned s2d_blocks(size_t n) {
  const size_t b = (n + S2D_THREADS - 1) / S2D_THREADS;
  return (unsigned)(b < 65535 * 16 ? b : 65535 * 16);
}

template <typename TI, typename TO>
static int launch_enter_s2d(const void* img1, const void* img2, void* y, int b, int h, int w,
                            cudaStream_t s) {
  const size_t n = (size_t)2 * b * (h / 2) * (w / 2);
  s2d_enter_kernel<TI, TO><<<s2d_blocks(n), S2D_THREADS, 0, s>>>(
      static_cast<const TI*>(img1), static_cast<const TI*>(img2), static_cast<TO*>(y), b, h,
      w);
  return (int)cudaGetLastError();
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// img1, img2 (b, h, w, 1) in in_dtype; y (2b, h/2, w/2, 4) in out_dtype;
// h and w even.
int mmif_s2d_enter(int in_dtype, int out_dtype, const void* img1, const void* img2, void* y,
                   int b, int h, int w, void* stream) {
  if (h % 2 || w % 2 || h < 2 || w < 2 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    return launch_enter_s2d<float, float>(img1, img2, y, b, h, w, s);
  if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    return launch_enter_s2d<float, __nv_bfloat16>(img1, img2, y, b, h, w, s);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    return launch_enter_s2d<__nv_bfloat16, float>(img1, img2, y, b, h, w, s);
  if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    return launch_enter_s2d<__nv_bfloat16, __nv_bfloat16>(img1, img2, y, b, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// x (n, h/2, w/2, 4) in dtype -> y (n, h, w, 1); h and w are the unpacked
// sizes.
int mmif_s2d_exit(int dtype, const void* x, void* y, int n, int h, int w, void* stream) {
  if (h % 2 || w % 2 || h < 2 || w < 2 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cnt = (size_t)n * (h / 2) * (w / 2);
  if (dtype == DT_F32) {
    s2d_exit_kernel<float><<<s2d_blocks(cnt), S2D_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, h, w);
  } else if (dtype == DT_BF16) {
    s2d_exit_kernel<__nv_bfloat16><<<s2d_blocks(cnt), S2D_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, h, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
