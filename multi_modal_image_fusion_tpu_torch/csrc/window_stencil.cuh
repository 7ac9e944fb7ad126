// One separable Gaussian window stencil over a grayscale pair, the body of
// two kernels (VALID on input the caller padded; f32 throughout):
//
//   ssim_maps (csrc/ssim.cu)   <- multi_modal_image_fusion_tpu/ops/pallas/
//                                 ssim_kernel.py:86 ssim_maps_pallas: the SSIM
//                                 algebra (sigma^2 clamped at 0) over the five
//                                 filtered maps, writing ssim, cs, sigma1^2;
//   moments   (csrc/moments.cu) <- multi_modal_image_fusion_tpu/ops/pallas/
//                                 moments_kernel.py:50 moments_pallas: the five
//                                 maps mu1, mu2, E[x1^2], E[x2^2], E[x1*x2].
//
// Both filter the five products x, y, x^2, y^2, xy with a ws-tap window,
// vertically and then horizontally, the taps summed in tap order by f32 FMAs
// (the arithmetic of the plain versions, ops/ssim.py; a changed rounding
// shows first in the eval bundle's VIFF, whose sigma^2 = E[x^2] - mu^2 of
// values up to 255^2 cancels). Only the epilogue differs.
//
// What bounds them on an H100: memory traffic by the operation count per
// byte. An output reads 8 bytes and writes 12 (ssim) or 20 (moments)
// against ~20 ws operations: 2-12 a byte, below the card's f32 balance of
// ~20 (67 TFLOP/s over 3.35 TB/s). But at ws 11 the FMAs alone, ~110 an
// output, take 0.07 ms of an eval chunk's 0.12 ms byte bound at the f32
// rate, so whatever else is issued counts as much as the bytes. The design
// keeps every tap out of shared memory where a register can hold it:
//
// - Tall strips. A block owns WN_BW (128) output columns and a strip of at
//   least WN_MIN_ROWS (64) output rows, so the staged vertical halo of
//   ws - 1 rows costs at most a quarter at ws 17; every block of the grid is
//   resident at once (no second wave; window_plan).
// - The vertical pass in registers. A thread owns one staged column and, for
//   a group of WN_R (10) output rows, reads the R + ws - 1 input rows once
//   each, forms x^2, y^2 and xy once, and FMAs them into the 5 x R running
//   sums of the output rows each input row reaches. Shared reads a column
//   and output row: 2 (R + ws - 1) / R, against 2 ws of a tap-by-tap pass.
// - The horizontal pass register-blocked. A thread computes WN_C (8)
//   adjacent outputs of a row from the C + ws - 1 filtered values of a map,
//   read as 16-byte shared loads: 5 (C + ws - 1) / C values an output,
//   against 5 ws. Consecutive threads take consecutive rows (pitch 4 mod 32
//   words), so the 16-byte loads of a quarter warp hit 32 banks. The
//   outputs overwrite the filtered map they came from (a barrier a map), so
//   no staging buffer of their own is needed and three blocks fit an SM:
//   one block's five warps leave an SM mostly stalled (an H100 took 0.71 of
//   the time with two blocks an SM, 0.85 of that with three).
// - Staging by cp.async, 16 bytes a copy where the width is a multiple of 4
//   and both images are 16-byte aligned, else 4 (the MS-SSIM level of 77 and
//   the VIF scale of 125 columns). The copies fill a ring of input rows; the
//   next group's R rows are in flight while this group computes. Rows and
//   columns past the image are zero-filled (they feed only outputs that are
//   not stored). No index is divided by a runtime value.
// - Stores coalesced: a warp writes 128 consecutive bytes of a map row, after
//   the epilogue.
//
// Instances: ws is a template parameter for the windows the callers launch
// (11 for SSIM; 17, 9, 5, 3 for the VIF pyramid); WS = 0 is the generic
// instance for any ws up to WN_MAX_WS, its loops bounded at run time, right
// but not fast. No tensor cores: the work is FMAs on a memory-bound stencil.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#include <cmath>

namespace mmif {

constexpr int WN_MAX_WS = 17;
constexpr int WN_THREADS = 160;
constexpr int WN_BW = 128;        // output columns a block
constexpr int WN_R = 10;          // output rows a group (vertical register block)
constexpr int WN_C = 8;           // adjacent outputs a thread (horizontal)
constexpr int WN_MIN_ROWS = 64;   // output rows a strip at least
constexpr int WN_SV_P = 164;      // pitch of a filtered row in floats, 4 mod 32
static_assert(WN_THREADS == (WN_BW / WN_C) * WN_R, "horizontal: one thread a C-run");
static_assert(WN_THREADS >= WN_BW + WN_MAX_WS - 1, "vertical: one thread a column");

struct WinTaps {
  float t[WN_MAX_WS];
};

// One launch. Item = (img * strips + strip) * bands + band, one a block.
struct WinArgs {
  const float* a;
  const float* b;
  float* out[5];
  int H, W, OH, OW;
  int ws;                  // the window (read by the generic instance)
  int bands, strips, th;   // column bands, strips a band, output rows a strip
  int vec;                 // 16-byte copies
  float c1, c2;            // SSIM constants
  WinTaps taps;
};

// Shared memory: the ring of input rows, then the filtered maps (sv, which
// the horizontal pass overwrites with its outputs), then the taps of the
// generic instance; at most 74.3 KB (ws 17), so three blocks fit an SM.
template <int WS>
struct WinGeom {
  static constexpr int KW = WS > 0 ? WS : WN_MAX_WS;   // widest window served
  static constexpr int NQ = (WN_BW + KW - 1 + 3) / 4;  // 16-byte chunks a staged row
  static constexpr int IWP = 4 * NQ;                   // staged row pitch (floats)
  static constexpr int NR = 2 * WN_R + KW - 1;         // ring rows: a group's, the next R
  static constexpr int RING = NR * 2 * IWP;            // floats: [row][a|b][IWP]
  static constexpr int SV = 5 * WN_R * WN_SV_P;
  static constexpr size_t BYTES = (size_t)(RING + SV + WN_MAX_WS) * 4;
  static_assert(RING % 4 == 0 && SV % 4 == 0, "16-byte regions");
};

// 4-byte global -> shared copy; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Strip rows lo .. lo + cnt - 1 (image rows y0 + lo ..; columns x0 .. x0 +
// IWP - 1 of both images) into ring rows (row mod NR).
template <int WS>
__device__ __forceinline__ void wn_load_rows(const WinArgs& p, float* ring, int img, int x0,
                                             int y0, int lo, int cnt) {
  using G = WinGeom<WS>;
  if (p.vec) {
    constexpr int PER_ROW = 2 * G::NQ;
    for (int e = threadIdx.x; e < cnt * PER_ROW; e += WN_THREADS) {
      const int r = e / PER_ROW, rem = e - r * PER_ROW;
      const int m = rem >= G::NQ ? 1 : 0;
      const int q = rem - m * G::NQ;
      const int gy = y0 + lo + r, gx = x0 + 4 * q;
      const float* src = m ? p.b : p.a;
      const bool live = gy < p.H && gx < p.W;   // W % 4 == 0: a chunk is in or out
      cp_async16(smem_u32(ring + (2 * ((lo + r) % G::NR) + m) * G::IWP + 4 * q),
                 live ? src + ((size_t)img * p.H + gy) * p.W + gx : src, live ? 16 : 0);
    }
  } else {
    constexpr int PER_ROW = 2 * G::IWP;
    for (int e = threadIdx.x; e < cnt * PER_ROW; e += WN_THREADS) {
      const int r = e / PER_ROW, rem = e - r * PER_ROW;
      const int m = rem >= G::IWP ? 1 : 0;
      const int x = rem - m * G::IWP;
      const int gy = y0 + lo + r, gx = x0 + x;
      const float* src = m ? p.b : p.a;
      const bool live = gy < p.H && gx < p.W;
      cp_async4(smem_u32(ring + (2 * ((lo + r) % G::NR) + m) * G::IWP + x),
                live ? src + ((size_t)img * p.H + gy) * p.W + gx : src, live ? 4 : 0);
    }
  }
}

template <int WS>
__device__ __forceinline__ float wn_tap(const WinArgs& p, const float* s_taps, int d) {
  if constexpr (WS > 0) return p.taps.t[d];   // d is a constant once unrolled
  else return s_taps[d];
}

// Input row i of the group (x = a, y = b at this thread's column) into the
// running sums of the output rows o = i - d it reaches, tap d in order.
template <int WS>
__device__ __forceinline__ void wn_vrow(const WinArgs& p, const float* s_taps, int ws, int i,
                                        float u, float v, float (&acc)[5][WN_R]) {
  const float uu = u * u, vv = v * v, uv = u * v;
#pragma unroll
  for (int o = 0; o < WN_R; ++o) {
    const int d = i - o;
    if (d >= 0 && d < (WS > 0 ? WS : ws)) {
      const float t = wn_tap<WS>(p, s_taps, d);
      acc[0][o] = fmaf(t, u, acc[0][o]);
      acc[1][o] = fmaf(t, v, acc[1][o]);
      acc[2][o] = fmaf(t, uu, acc[2][o]);
      acc[3][o] = fmaf(t, vv, acc[3][o]);
      acc[4][o] = fmaf(t, uv, acc[4][o]);
    }
  }
}

// Vertical pass of one group: ring rows base .. base + R + ws - 2 (mod NR)
// -> sv[map][R][column].
template <int WS>
__device__ __forceinline__ void wn_vertical(const WinArgs& p, const float* ring, float* sv,
                                            const float* s_taps, int ws, int base) {
  using G = WinGeom<WS>;
  const int c = threadIdx.x;
  if (c >= WN_BW + ws - 1) return;
  float acc[5][WN_R];
#pragma unroll
  for (int m = 0; m < 5; ++m)
#pragma unroll
    for (int o = 0; o < WN_R; ++o) acc[m][o] = 0.f;
  auto row = [&](int i) {
    int rr = base + i;
    rr = rr >= G::NR ? rr - G::NR : rr;
    const float* s = ring + 2 * rr * G::IWP + c;
    wn_vrow<WS>(p, s_taps, ws, i, s[0], s[G::IWP], acc);
  };
  if constexpr (WS > 0) {
#pragma unroll
    for (int i = 0; i < WN_R + WS - 1; ++i) row(i);
  } else {
#pragma unroll 1
    for (int i = 0; i < WN_R + ws - 1; ++i) row(i);
  }
#pragma unroll
  for (int m = 0; m < 5; ++m)
#pragma unroll
    for (int o = 0; o < WN_R; ++o) sv[(m * WN_R + o) * WN_SV_P + c] = acc[m][o];
}

// Horizontal pass of one group, in place: thread t owns row t % R,
// outputs C (t / R) .. + C - 1 of each map, read from sv and written back
// over sv once every thread has read that map (a barrier a map; the next
// map's loads are issued under this map's FMAs).
template <int WS>
__device__ __forceinline__ void wn_horizontal(const WinArgs& p, float* sv, const float* s_taps,
                                              int ws) {
  const int r = threadIdx.x % WN_R, c0 = (threadIdx.x / WN_R) * WN_C;
  auto row = [&](int m) { return sv + (m * WN_R + r) * WN_SV_P + c0; };
  auto put = [&](int m, const float (&out)[WN_C]) {
    float4* dst = reinterpret_cast<float4*>(row(m));
    dst[0] = make_float4(out[0], out[1], out[2], out[3]);
    dst[1] = make_float4(out[4], out[5], out[6], out[7]);
  };
  if constexpr (WS > 0) {
    constexpr int NV = (WN_C + WS - 1 + 3) / 4;
    float v[2][4 * NV];
    auto load = [&](int m, float (&dst)[4 * NV]) {
      const float4* src = reinterpret_cast<const float4*>(row(m));
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const float4 f = src[q];
        dst[4 * q] = f.x; dst[4 * q + 1] = f.y; dst[4 * q + 2] = f.z; dst[4 * q + 3] = f.w;
      }
    };
    load(0, v[0]);
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      __syncthreads();   // every thread holds map m: it may be overwritten
      if (m + 1 < 5) load(m + 1, v[(m + 1) & 1]);
      float out[WN_C];
#pragma unroll
      for (int j = 0; j < WN_C; ++j) out[j] = 0.f;
#pragma unroll
      for (int d = 0; d < WS; ++d) {
        const float t = p.taps.t[d];
#pragma unroll
        for (int j = 0; j < WN_C; ++j) out[j] = fmaf(t, v[m & 1][j + d], out[j]);
      }
      put(m, out);
    }
  } else {
#pragma unroll 1
    for (int m = 0; m < 5; ++m) {
      const float* src = row(m);
      float out[WN_C];
#pragma unroll
      for (int j = 0; j < WN_C; ++j) out[j] = 0.f;
#pragma unroll 1
      for (int k = 0; k < WN_C + ws - 1; ++k) {
        const float x = src[k];
#pragma unroll
        for (int j = 0; j < WN_C; ++j) {
          const int d = k - j;
          if (d >= 0 && d < ws) out[j] = fmaf(s_taps[d], x, out[j]);
        }
      }
      __syncthreads();
      put(m, out);
    }
  }
}

// The epilogue and stores of one group: warp w takes rows 2w and 2w + 1 of
// the horizontal pass's outputs, lane l columns l + 32 j, so a warp writes
// 128 consecutive bytes of a map row at a time and every address is a row
// base plus a constant.
template <class Epi>
__device__ __forceinline__ void wn_store(const WinArgs& p, const float* sv, int img, int x0,
                                         int row0, int yend) {
  static_assert(WN_THREADS / 32 * 2 == WN_R && WN_BW == 4 * 32, "store layout");
  const int lane = threadIdx.x % 32, cols = p.OW - x0 - lane;
#pragma unroll   // independent outputs: their epilogues overlap
  for (int h = 0; h < 2; ++h) {
    const int r = 2 * (threadIdx.x / 32) + h;
    if (row0 + r < yend) {
      const size_t o = ((size_t)img * p.OH + row0 + r) * p.OW + x0 + lane;
      const float* s = sv + r * WN_SV_P + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (32 * j < cols) {
          float m[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) m[k] = s[k * WN_R * WN_SV_P + 32 * j];
          Epi::apply(p, o + 32 * j, m);
        }
      }
    }
  }
}

// ssim_maps: the SSIM algebra of ops/ssim.ssim_maps, its two IEEE divisions
// kept (out: ssim, cs, sigma1^2). The three products are rounded on their
// own (__fmul_rn is never contracted into the subtractions), as the plain
// version rounds its mu1^2, mu2^2 and mu1 mu2 maps.
struct EpiSsim {
  __device__ static __forceinline__ void apply(const WinArgs& p, size_t o, const float (&m)[5]) {
    const float mu1 = m[0], mu2 = m[1];
    const float mu1_sq = __fmul_rn(mu1, mu1), mu2_sq = __fmul_rn(mu2, mu2);
    const float mu1_mu2 = __fmul_rn(mu1, mu2);
    const float s1 = fmaxf(m[2] - mu1_sq, 0.f);
    const float s2 = fmaxf(m[3] - mu2_sq, 0.f);
    const float s12 = m[4] - mu1_mu2;
    const float m1v = 2.f * mu1_mu2 + p.c1;
    const float m2v = mu1_sq + mu2_sq + p.c1;
    const float v1 = 2.f * s12 + p.c2;
    const float v2 = s1 + s2 + p.c2;
    p.out[1][o] = v1 / v2;
    p.out[0][o] = (m1v * v1) / (m2v * v2);
    p.out[2][o] = s1;
  }
};

// moments: the five filtered maps as they are.
struct EpiMoments {
  __device__ static __forceinline__ void apply(const WinArgs& p, size_t o, const float (&m)[5]) {
#pragma unroll
    for (int k = 0; k < 5; ++k) p.out[k][o] = m[k];
  }
};

template <int WS, class Epi>
__global__ void __launch_bounds__(WN_THREADS, 3) window_kernel(WinArgs p) {
  using G = WinGeom<WS>;
  extern __shared__ __align__(16) float wn_smem[];
  float* ring = wn_smem;
  float* sv = ring + G::RING;
  float* s_taps = sv + G::SV;
  const int ws = WS > 0 ? WS : p.ws;
  if constexpr (WS == 0) {
    for (int i = threadIdx.x; i < ws; i += WN_THREADS) s_taps[i] = p.taps.t[i];
  }

  const int item = blockIdx.x;
  const int band = item % p.bands, rest = item / p.bands;
  const int strip = rest % p.strips, img = rest / p.strips;
  const int x0 = band * WN_BW, y0 = strip * p.th;
  const int yend = min(y0 + p.th, p.OH);
  const int ng = (yend - y0 + WN_R - 1) / WN_R;   // groups; the strip is never empty
  const int first = WN_R + ws - 1;                // input rows a group reads

  wn_load_rows<WS>(p, ring, img, x0, y0, 0, first);
  cp_async_commit();
  int base = 0;   // ring row of group g's first input row
#pragma unroll 1
  for (int g = 0; g < ng; ++g) {
    // the next group's new rows, into the ring rows group g - 1 alone read
    if (g + 1 < ng) wn_load_rows<WS>(p, ring, img, x0, y0, g * WN_R + first, WN_R);
    cp_async_commit();
    cp_async_wait<1>();   // this group's rows are in
    __syncthreads();
    wn_vertical<WS>(p, ring, sv, s_taps, ws, base);
    __syncthreads();
    wn_horizontal<WS>(p, sv, s_taps, ws);
    __syncthreads();
    wn_store<Epi>(p, sv, img, x0, y0 + g * WN_R, yend);
    base = base + WN_R >= G::NR ? base + WN_R - G::NR : base + WN_R;
  }
  cp_async_wait<0>();
}

// Per-instance launch state: the occupancy query costs more host time than
// the launch, so it is made once a device.
struct WinGridCache {
  int sms = 0, slots = 0;
  int dev = -1;
};

// The strips of a launch (p.bands, p.strips, p.th), one block a (image,
// strip, band), every block resident at once (at most `slots` = sms x
// blocks an SM). A strip has at least WN_MIN_ROWS rows, or, where such
// strips would leave slots idle (small images, batch 1), at least 4 (ws - 1)
// rows (the halo a quarter at most, as 64 rows give at ws 17) and one row
// group. More blocks an SM run faster (above), so the plan takes the least
// (th + ws - 1) x sqrt(blocks on the busiest SM), the larger grid on a tie.
// Rows a strip are a multiple of WN_R.
inline void window_plan(WinArgs& p, int n, int sms, int slots) {
  auto up = [](long long x, long long m) { return (x + m - 1) / m * m; };
  p.bands = (p.OW + WN_BW - 1) / WN_BW;
  const long long per = (long long)n * p.bands;
  const int tall = p.OH / WN_MIN_ROWS > 1 ? p.OH / WN_MIN_ROWS : 1;
  const int th_tall = (int)up((p.OH + tall - 1) / tall, WN_R);
  const bool idle = per * ((p.OH + th_tall - 1) / th_tall) < slots;
  const int lo = idle ? (int)up(4 * (p.ws - 1) > WN_R ? 4 * (p.ws - 1) : WN_R, WN_R)
                      : WN_MIN_ROWS;
  const int th_all = (int)up(p.OH, WN_R);
  double best = -1.0;
  long long best_w = 0;
  for (int th = th_all; th >= WN_R; th -= WN_R) {
    const int strips = (p.OH + th - 1) / th;
    const long long w = per * strips;
    if (th != th_all && (th < lo || w > slots)) continue;
    const double cost = (th + p.ws - 1) * sqrt((double)((w + sms - 1) / sms));
    if (best < 0 || cost < best || (cost == best && w > best_w)) {
      best = cost;
      best_w = w;
      p.th = th;
      p.strips = strips;
    }
  }
}

// One launch over n images of H x W (outputs OH x OW, set in p), one block
// a (image, strip, band). Returns a cudaError_t.
template <int WS, class Epi>
int window_launch(WinArgs p, int n, cudaStream_t stream) {
  using G = WinGeom<WS>;
  static WinGridCache cache;
  const void* kern = (const void*)window_kernel<WS, Epi>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (cache.dev != dev) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, WN_THREADS, G::BYTES);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    cache.sms = sms;
    cache.slots = sms * occ;
    cache.dev = dev;
  }
  window_plan(p, n, cache.sms, cache.slots);
  const long long grid = (long long)n * p.bands * p.strips;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  window_kernel<WS, Epi><<<(unsigned)grid, WN_THREADS, G::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// The argument block of a launch over (n, h, w) pairs already padded;
// the caller sets out[], the constants and checks the window.
inline WinArgs window_args(const float* a, const float* b, int h, int w, int ws,
                           const float* taps) {
  WinArgs p = {};
  p.a = a;
  p.b = b;
  p.H = h;
  p.W = w;
  p.OH = h - ws + 1;
  p.OW = w - ws + 1;
  p.ws = ws;
  for (int i = 0; i < ws; ++i) p.taps.t[i] = taps[i];
  p.vec = (w % 4 == 0) && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  return p;
}

}  // namespace mmif
