// Depthwise (groups = C) reflect-SAME conv over a channel window of a wider
// NHWC tensor, with an optional second tensor added to the input first.
//
// The depthwise instance of multi_modal_image_fusion_tpu/ops/pallas/
// hiw_kernel.py:335 conv_hiw_chain, which runs depthwise weights as diagonal
// bands of a dense conv (:157-185); the Res2 blocks' hierarchy
// (ops/blocks.py:286-292 of the JAX package) reads each group's channels in
// place from the expanded tensor (hiw_scale.py:50 hiw_channels) and adds the
// previous group's output before the conv. Here the window is a base
// channel and the tensor's own pixel stride, so the 384-channel expansion of
// a Res2 block is never sliced into copies, and the add happens in the load.
//
// What bounds it on an H100: bytes. Per output value it reads one input
// value (two with the add) and writes one, against 2 k^2 flops: at k3 that
// is 4.5 flops a byte in bf16, far below the card's balance. So the design
// makes each input byte cross DRAM once and L2 -> SM about once:
//
// - 2-D tiles on a resident grid. A block owns a slice of NG x 8 channels
//   (48 where C is a multiple of 48, so that one block reads a Res2 group's
//   whole window of a pixel, RB2's 96 contiguous bytes; else 16 or 8) and
//   walks strips of th output rows by DW_TX (32) pixels. The plan (dw_plan)
//   sizes the strips so that every block of the grid is resident at once (no
//   second wave), none shorter than DW_MIN_ROWS. The slice's K x K taps (and
//   bias) are loaded into registers once a block. Neighbouring block
//   indices take neighbouring tiles of a strip, so a halo column is read by
//   blocks that run together.
// - Staged input with its reflect halo. Each thread copies its own 16-byte
//   chunks of the strip's input rows (the window x[..., lo:lo+C] at pixel
//   stride x_pitch, and `add`) by cp.async into a ring of DW_NR raw rows of
//   DW_TX + K - 1 pixels, DW_AHEAD rows ahead of the row computed; the
//   reflect is in each copy's row and column address (reflect_index), so
//   the halo is the image's own pixels.
// - The add summed once per element. When row i's chunks are in, the thread
//   that copied them widens them to f32 and adds `add` (xf + add.float(),
//   as the plain version) into an f32 row, double-buffered. Only the
//   thread that copied a chunk reads it back, so the raw ring needs no
//   barrier; one barrier a row publishes the f32 row.
// - Vertical taps in registers. A thread owns one output pixel by 8
//   channels. It reads each f32 row once (its K vectors) and FMAs it into
//   the K output rows it reaches, held as a rolling window of K
//   accumulator rows; the row loop is unrolled by K, so every accumulator
//   index is a constant. A finished row is stored as 16-byte vectors, the
//   8 channels of consecutive lanes contiguous. (Two pixels a thread, to
//   reuse a row's vectors across pixels in registers, spilled at the 168
//   registers that 12 warps an SM leave, and ran slower.)
// - Conflict-free shared reads: an f32 pixel holds its 2 NG chunks at a
//   pitch of FP chunks (dw_fpitch), lanes take (group, pixel) with the
//   group fastest, and the 8 lanes of a quarter warp hit 8 bank groups.
// - The arithmetic of the plain version and of the kernel it replaces: for
//   each output, bias (or 0) first, then the taps dy-major and dx-minor by
//   fmaf in f32, the activation, one cast. Input row o + dy is consumed in
//   row order, and within a row the taps of one output come in dx order.
//
// k1 is a streaming pass (conv_dw_k1_kernel): read, add, scale, bias,
// activation, write; a thread owns 8 channels of a pixel, one launch covers
// the tensor with no loop. f32 runs the same bodies with 4 channels a
// chunk.
// k5 and k7 (MixConvBlock's dwconv2 and dwconv3) run the same tile body
// with the taps in shared memory instead of registers: K x K x 8 f32 taps
// are 200 and 392 registers a thread, past the 170 that 12 warps an SM
// leave (ptxas spilled). A thread reads a tap's 8 channels as two 16-byte
// vectors; the lanes of a warp that share a channel group read one
// address, which shared memory broadcasts, so a tap costs one wavefront
// per 8 FMAs of each lane.
//
// Instances: k1, and k3 in bf16 and f32 with NG 6, 2 and 1, with and
// without the add; k5 and k7 in bf16 and f32 with NG 2 and 1, without the
// add (dispatch_tile); the wrapper raises on anything else.
#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

constexpr int DW_MAX_C = 512;
constexpr int DW_TX = 32;             // thread columns of a tile
constexpr int DW_AHEAD = 3;           // staged rows in flight ahead of the computed one
constexpr int DW_NR = DW_AHEAD + 1;   // ring rows
constexpr int DW_MIN_ROWS = 16;       // output rows a strip at least
constexpr int DW_K1_THREADS = 256;

// The pitch, in 16-byte chunks, of a pixel of the f32 row: its 2 NG chunks
// and a pad, so that the 8 lanes of a quarter warp, which read the same
// half of 8 channels of (group g, pixel tx + j) with g fastest, hit 8
// different bank groups (2 NG + 2 for NG 2 and 6, 3 for NG 1).
constexpr int dw_fpitch(int ng) { return ng == 1 ? 3 : 2 * ng + 2; }

// Taps in shared memory from this kernel size on (see the header).
constexpr int DW_SMEM_TAPS_K = 5;

template <typename T, int K, int NG>
struct DwGeom {
  static constexpr int THREADS = NG * DW_TX;
  static constexpr int CH = 16 / (int)sizeof(T);  // channels a 16-byte chunk
  static constexpr int NQ = NG * 8 / CH;          // chunks a staged pixel
  static constexpr int NPOS = DW_TX + K - 1;      // staged pixels a row
  static constexpr int RAW = NPOS * NQ;           // chunks a staged row of one tensor
  static constexpr int COPIES = (RAW + THREADS - 1) / THREADS;   // a thread's a row
  static constexpr int FP = dw_fpitch(NG);        // chunks a pixel of the f32 row
  static constexpr int FROW = NPOS * FP;          // chunks an f32 row
  static constexpr bool SMEM_TAPS = K >= DW_SMEM_TAPS_K;
  static constexpr int TAPS = SMEM_TAPS ? K * K * NG * 2 : 0;   // chunks of taps
  static constexpr size_t bytes(bool add) {
    return ((size_t)(add ? 2 : 1) * DW_NR * RAW + 2 * FROW + TAPS) * 16;
  }
};

// One launch. The plan (slices, bands, strips, th, blocks_per_slice) is the
// tile kernel's; the k1 kernel reads only the tensors and sizes.
struct DwArgs {
  const void* x;
  const void* add;
  void* y;
  const float* w;      // [k*k][C] f32
  const float* bias;   // C f32 or null
  int x_pitch, lo, add_pitch;
  int B, H, W, C, act;
  int slices, bands, strips, th, blocks_per_slice;
};

// A staged chunk (plus its add) as f32 into the f32 row: 8 bf16 channels
// (two f32 chunks, halves of group m) or 4 f32 channels (half m % 2 of
// group m / 2). Half h of group g sits at chunk h NG + g of a pixel.
template <typename T, int NG, bool ADD>
__device__ __forceinline__ void dw_widen(const uint4* raw, const uint4* raw_add, float4* pix,
                                         int m) {
  if constexpr (sizeof(T) == 2) {
    float v[8];
    load8(reinterpret_cast<const __nv_bfloat16*>(raw), v);
    if constexpr (ADD) {
      float a[8];
      load8(reinterpret_cast<const __nv_bfloat16*>(raw_add), a);
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] += a[c];
    }
    pix[m] = make_float4(v[0], v[1], v[2], v[3]);
    pix[NG + m] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    float4 v = *reinterpret_cast<const float4*>(raw);
    if constexpr (ADD) {
      const float4 a = *reinterpret_cast<const float4*>(raw_add);
      v.x += a.x; v.y += a.y; v.z += a.z; v.w += a.w;
    }
    pix[(m % 2) * NG + m / 2] = v;
  }
}

template <typename T, int K, int NG, bool ADD>
__global__ void __launch_bounds__(NG * DW_TX, 12 / NG) conv_dw_tile_kernel(DwArgs p) {
  using G = DwGeom<T, K, NG>;
  constexpr int R = K / 2;
  extern __shared__ __align__(16) uint4 dw_smem[];
  uint4* const raw = dw_smem;                                          // [DW_NR][1 + ADD][RAW]
  float4* const frow = reinterpret_cast<float4*>(dw_smem + (ADD ? 2 : 1) * DW_NR * G::RAW);
  // [K*K][NG][2] f32 chunks of the slice's taps (SMEM_TAPS only)
  float4* const staps = frow + 2 * G::FROW;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ ad = static_cast<const T*>(p.add);
  T* __restrict__ y = static_cast<T*>(p.y);
  const int g = threadIdx.x % NG, tx = threadIdx.x / NG;
  const int c0 = (blockIdx.x % p.slices) * NG * 8;   // the slice's first channel
  const int ch = c0 + g * 8;                          // this thread's first channel

  float tw[G::SMEM_TAPS ? 1 : K * K][8], bs[8];
  if constexpr (G::SMEM_TAPS) {
    for (int e = threadIdx.x; e < G::TAPS; e += G::THREADS) {
      const int t = e / (2 * NG), q = e - t * 2 * NG;   // q = 2 group + half
      staps[e] = *reinterpret_cast<const float4*>(p.w + t * p.C + c0 + q * 4);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int t = 0; t < K * K; ++t) load8(p.w + t * p.C + ch, tw[t]);
  }
  if (p.bias != nullptr) {
    load8(p.bias + ch, bs);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) bs[c] = 0.f;
  }

  const int items = p.B * p.strips * p.bands;
#pragma unroll 1
  for (int it = blockIdx.x / p.slices; it < items; it += p.blocks_per_slice) {
    const int band = it % p.bands, rest = it / p.bands;
    const int strip = rest % p.strips, img = rest / p.strips;
    const int x0 = band * DW_TX, y0 = strip * p.th;
    const int nrows = min(p.th, p.H - y0) + K - 1;   // staged rows

    // this thread's chunks of a staged row (chunk e = pixel s, chunk m in
    // memory order): the global offsets of its column; it copies, widens
    // and adds them itself, so the raw ring needs no barrier
    int src[G::COPIES], asrc[G::COPIES];
#pragma unroll
    for (int r = 0; r < G::COPIES; ++r) {
      const int e = threadIdx.x + r * G::THREADS;
      const int s = e / G::NQ, m = e - s * G::NQ;
      const int gx = reflect_index(x0 - R + s, p.W);
      src[r] = gx * p.x_pitch + p.lo + c0 + m * G::CH;
      asrc[r] = gx * p.add_pitch + c0 + m * G::CH;
    }
    auto stage = [&](int i, int slot) {
      const size_t pix = ((size_t)img * p.H + reflect_index(y0 - R + i, p.H)) * p.W;
      uint4* rx = raw + slot * (ADD ? 2 : 1) * G::RAW;
#pragma unroll
      for (int r = 0; r < G::COPIES; ++r) {
        const int e = threadIdx.x + r * G::THREADS;
        if (e < G::RAW) {
          cp_async16(smem_u32(rx + e), x + pix * p.x_pitch + src[r], 16);
          if constexpr (ADD)
            cp_async16(smem_u32(rx + G::RAW + e), ad + pix * p.add_pitch + asrc[r], 16);
        }
      }
    };

#pragma unroll
    for (int i = 0; i < DW_AHEAD; ++i) {
      if (i < nrows) stage(i, i);
      cp_async_commit();
    }
    float acc[K][8];
#pragma unroll
    for (int s = 0; s < K; ++s)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[s][c] = 0.f;
    const int px = x0 + tx;
    int slot = 0;   // ring slot of row i
#pragma unroll 1
    for (int i0 = 0; i0 < nrows; i0 += K) {
#pragma unroll
      for (int u = 0; u < K; ++u) {   // row i = i0 + u: output row i's sums are acc[u]
        const int i = i0 + u;
        if (i < nrows) {   // uniform over the block
          cp_async_wait<DW_AHEAD - 1>();   // this thread's copies of row i are in
          float4* fr = frow + (i & 1) * G::FROW;
          {
            const uint4* rx = raw + slot * (ADD ? 2 : 1) * G::RAW;
#pragma unroll
            for (int r = 0; r < G::COPIES; ++r) {
              const int e = threadIdx.x + r * G::THREADS;
              if (e < G::RAW) {
                const int s = e / G::NQ;
                dw_widen<T, NG, ADD>(rx + e, rx + G::RAW + e, fr + s * G::FP, e - s * G::NQ);
              }
            }
          }
          __syncthreads();   // f32 row i is whole; every thread is done with row i - 2's
          if (i + DW_AHEAD < nrows) stage(i + DW_AHEAD, slot == 0 ? DW_NR - 1 : slot - 1);
          cp_async_commit();
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[u][c] = bs[c];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {   // in tap order
            const float4 lo4 = fr[(tx + dx) * G::FP + g];
            const float4 hi4 = fr[(tx + dx) * G::FP + NG + g];
            const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
            for (int dy = 0; dy < K; ++dy) {   // output row i - dy
              const int s = (u - dy + K) % K;
              const int t = dy * K + dx;
              float wv[8];
              if constexpr (G::SMEM_TAPS) {
                const float4 w0 = staps[(t * NG + g) * 2], w1 = staps[(t * NG + g) * 2 + 1];
                wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
                wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
              } else {
#pragma unroll
                for (int c = 0; c < 8; ++c) wv[c] = tw[t][c];
              }
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[s][c] = fmaf(wv[c], v[c], acc[s][c]);
            }
          }
          const int o = i - (K - 1);   // output row complete after row i
          if (o >= 0 && px < p.W) {
            const int s = (u + 1) % K;
            float out[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) out[c] = apply_act(acc[s][c], p.act);
            store8(y + (((size_t)img * p.H + y0 + o) * p.W + px) * p.C + ch, out);
          }
          slot = slot + 1 == DW_NR ? 0 : slot + 1;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the next strip's rows reuse the ring and the f32 rows
  }
}

// k1: one pixel's 8 channels a thread, a block of DW_K1_THREADS / (C / 8)
// whole pixels, as many blocks as pixels need (no loop: every warp's loads
// are in flight at once, and a warp's lanes read whole pixel windows).
template <typename T>
__global__ void __launch_bounds__(DW_K1_THREADS) conv_dw_k1_kernel(DwArgs p) {
  const int ng = p.C / 8;
  const int per = DW_K1_THREADS / ng;   // pixels a block
  const int t = threadIdx.x / ng;
  const long long pix = (long long)blockIdx.x * per + t;
  if (t >= per || pix >= (long long)p.B * p.H * p.W) return;
  const int ch = (threadIdx.x - t * ng) * 8;
  const T* const add = static_cast<const T*>(p.add);
  float v[8], w[8], out[8];
  load8(static_cast<const T*>(p.x) + pix * p.x_pitch + p.lo + ch, v);
  if (add != nullptr) {
    float a[8];
    load8(add + pix * p.add_pitch + ch, a);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] += a[c];
  }
  load8(p.w + ch, w);
  if (p.bias != nullptr) {
    load8(p.bias + ch, out);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = apply_act(fmaf(w[c], v[c], out[c]), p.act);
  store8(static_cast<T*>(p.y) + pix * p.C + ch, out);
}

// The tile plan: slices of NG x 8 channels, bands of DW_TX columns, strips
// of th rows. Strips as short as the resident slots ask (every block of
// the grid resident, none idle where the image allows), but never below
// DW_MIN_ROWS rows; blocks_per_slice blocks walk a slice's (image, strip,
// band) items, one each where they all fit.
inline void dw_plan(DwArgs& p, int ng, int slots) {
  p.slices = p.C / (8 * ng);
  p.bands = (p.W + DW_TX - 1) / DW_TX;
  const long long per = (long long)p.B * p.bands * p.slices;
  const long long most = p.H / DW_MIN_ROWS > 1 ? p.H / DW_MIN_ROWS : 1;
  long long strips = slots / per;
  strips = strips < 1 ? 1 : strips > most ? most : strips;
  p.th = (int)((p.H + strips - 1) / strips);
  p.strips = (p.H + p.th - 1) / p.th;
  const long long items = (long long)p.B * p.bands * p.strips;
  const long long fit = slots / p.slices > 1 ? slots / p.slices : 1;
  p.blocks_per_slice = (int)(items < fit ? items : fit);
}

// Per-instance launch state: the occupancy query costs more host time than
// the launch, so it is made once a device.
struct DwGridCache {
  int sms = 0, slots = 0;
  int dev = -1;
};

template <typename Kern>
int dw_slots(DwGridCache& cache, Kern kern, int threads, size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (cache.dev != dev) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && bytes > 0)
      e = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, bytes);
    if (e != cudaSuccess) return -(int)e;
    if (occ < 1) return -(int)cudaErrorInvalidConfiguration;
    cache.sms = sms;
    cache.slots = sms * occ;
    cache.dev = dev;
  }
  return cache.slots;
}

template <typename T, int K, int NG, bool ADD>
int launch_tile(DwArgs p, cudaStream_t stream) {
  using G = DwGeom<T, K, NG>;
  static DwGridCache cache;
  const int slots = dw_slots(cache, conv_dw_tile_kernel<T, K, NG, ADD>, G::THREADS,
                             G::bytes(ADD));
  if (slots < 0) return -slots;
  dw_plan(p, NG, slots);
  const long long grid = (long long)p.slices * p.blocks_per_slice;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_dw_tile_kernel<T, K, NG, ADD><<<(unsigned)grid, G::THREADS, G::bytes(ADD), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k1(DwArgs p, cudaStream_t stream) {
  const long long per = DW_K1_THREADS / (p.C / 8);
  const long long grid = ((long long)p.B * p.H * p.W + per - 1) / per;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_dw_k1_kernel<T><<<(unsigned)grid, DW_K1_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int K, int NG>
int launch_add(const DwArgs& p, cudaStream_t s) {
  return p.add != nullptr ? launch_tile<T, K, NG, true>(p, s)
                          : launch_tile<T, K, NG, false>(p, s);
}

template <typename T, int K>
int dispatch_ng(const DwArgs& p, cudaStream_t s) {
  if ((p.C / 8) % 6 == 0) return launch_add<T, K, 6>(p, s);
  if ((p.C / 8) % 2 == 0) return launch_add<T, K, 2>(p, s);
  return launch_add<T, K, 1>(p, s);
}

// k5 and k7: taps in shared memory, slices of 16 or 8 channels, no add
// (MixConvBlock's windows are 16-128 channels, never summed).
template <typename T, int K>
int dispatch_ng_wide_k(const DwArgs& p, cudaStream_t s) {
  if (p.add != nullptr) return (int)cudaErrorInvalidValue;
  if ((p.C / 8) % 2 == 0) return launch_tile<T, K, 2, false>(p, s);
  return launch_tile<T, K, 1, false>(p, s);
}

// The built windows.
template <typename T>
int dispatch_tile(int k, const DwArgs& p, cudaStream_t s) {
  if (k == 1) return launch_k1<T>(p, s);
  if (k == 3) return dispatch_ng<T, 3>(p, s);
  if (k == 5) return dispatch_ng_wide_k<T, 5>(p, s);
  if (k == 7) return dispatch_ng_wide_k<T, 7>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// y (B, H, W, C) contiguous = act(dwconv(x[..., lo:lo+C] + add) + bias), reflect-SAME.
// x: (B, H, W, x_pitch), read at channels [lo, lo + C); add: null or
// (B, H, W, add_pitch) read at [0, C); w: [k*k][C] f32; bias: null or C f32.
// C, x_pitch, lo and add_pitch multiples of 8, 16-byte aligned bases.
int mmif_conv_dw(int dtype, const void* x, int x_pitch, int lo, const void* add, int add_pitch,
                 const float* w, const float* bias, void* y, int B, int H, int W, int C, int k,
                 int act, void* stream) {
  if (B < 1 || H <= k / 2 || W <= k / 2 || C < 8 || C % 8 || C > DW_MAX_C || x_pitch % 8 ||
      lo % 8 || lo + C > x_pitch || (add != nullptr && (add_pitch % 8 || add_pitch < C)))
    return (int)cudaErrorInvalidValue;
  DwArgs p = {};
  p.x = x;
  p.add = add;
  p.y = y;
  p.w = w;
  p.bias = bias;
  p.x_pitch = x_pitch;
  p.lo = lo;
  p.add_pitch = add_pitch;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch_tile<float>(k, p, s);
  if (dtype == DT_BF16) return dispatch_tile<__nv_bfloat16>(k, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
