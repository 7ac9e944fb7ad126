// conv_pair: two chained reflect-SAME convs in one launch, the intermediate
// ("mid") in shared memory, NHWC, f32 accumulate.
//
// Replaces multi_modal_image_fusion_tpu/ops/pallas/conv_kernel.py:970
// conv_tlane_chain_pair (pallas_call :1036), DeepFuse's MMIF_CHAIN_PAIR
// route (models/zoo.py:510-540):
//
//   mid = cast(act_a(bias_a + conv_a(x)))        (reflect-SAME, chain dtype)
//   y   = cast(act_b(bias_b + conv_b(mid)))      (reflect-SAME)
//
// Two instances, DeepFuse's pairs:
//   enter: enc0 (1 -> 16, k5, relu) then enc1 (16 -> 32, k7, relu), reading
//          the grayscale pair straight from the two images and casting to
//          the chain dtype in the load (conv_gray_enter + conv_chain);
//   exit:  dec1 (32 -> 16, k5, relu) then dec2 (16 -> 1, k5, no act),
//          writing (B, H, W, 1).
//
// The mid's halo is the reflect of the mid (the TPU kernel mirrors its mid
// rows and lanes, conv_kernel.py:920-936), not conv_a over a reflect-
// extended input: a block computes conv_a over its whole mid tile (the
// output tile plus pb on each side) from an input tile with pa + pb of
// reflect halo, then, on a tile at the image border, overwrites every mid
// position outside the image with the mid at the reflected position, which
// lies within pb of the border and so inside the tile. The mid is rounded to
// the chain dtype before conv_b reads it, as the TPU kernel stores it in the
// input's dtype: the pair computes what two launches compute.
//
// What bounds them on an H100: the wide conv's products. The enter pair does
// 50,976 FLOP a pixel, the exit 26,400, against 6-68 bytes of traffic a
// pixel; the fusion saves the mid's round trip through device memory (1.28
// GB written and read again for the enter at 16 pairs of 1224x1024, 0.64 GB
// for the exit). In bf16 the wide conv runs on wgmma; with both operands in
// shared memory, at N = 32 (enc1) and N = 16 (dec1) shared memory's 128
// bytes a cycle, not the tensor cores, bound a product (2 KB of A and N x
// 32 bytes of B: 24 and 20 cycles against 16 and 8; conv_chain.cuh), so
// the exit takes dec1's A from registers (below). Both bf16 kernels have a
// persistent grid of one block of two warpgroups an SM with the wide conv's
// weights resident, and overlap one tile's wgmmas with the next tile's
// copies and thin-conv work:
//
// bf16 enter (pair_enter_kernel): a tile is 8 output rows of 64 pixels, the
// mid tile 14 x 70 positions. The tile's image rows and halo are staged as
// bf16 by cp.async (reflect in the source address; the halo columns at the
// image's sides filled from the staged row, as conv_gray.cu's enter does;
// f32 images, or a width that is not a multiple of 8, go through registers).
// enc0 runs on mma.sync m16n8k16 with conv_gray.cu's enter products (two
// kernel rows a k16 step, even and odd image columns in their own M tiles,
// B fragments packed by ops/cuda/conv_chain.py pack_gray_enter) over 3
// groups of 32 columns a mid row, and its epilogue (bias, activation, one
// rounding to bf16) writes the mid straight into the staging layout of the
// wgmma body: [channel half][row][pixel][8 channels], the halves 64 bytes
// apart modulo 128 (conv_chain.cuh TcGeom). enc1 is then 49 wgmma.m64n32k16
// a 64-pixel row, A a window of the mid through a no-swizzle descriptor
// moved by whole pixels per tap (wgmma.cuh), B enc1's 49 taps packed by
// pack_weights_tc (N block 32), resident. Two mid buffers: while the
// tensor cores work through tile t's wgmmas, the warps store tile t - 1's
// outputs, run enc0 and the reflect fix-up of tile t + 1 into the other
// buffer and issue the copy of tile t + 3's image rows (two staging
// buffers). enc1's epilogue goes through an output tile in shared memory
// ([pixel][32 channels], 16 bytes of padding a pixel) to coalesced 16-byte
// stores.
//
// bf16 exit (pair_exit_kernel): a tile is 20 output rows of 56 pixels, the
// mid tile 24 x 60. dec1's input (28 rows of 64 pixels) is staged as two
// 16-channel k-steps in a ring of two slots in the wgmma layout (cp.async,
// reflect in the address). dec1 runs wgmma.m64n16k16 over the mid
// positions at the staged pitch of 64, so a mid row is one m64 tile (its 4
// columns past 60 computed and dropped) and tap (kh, kw) of row r reads the
// pixels of tap (0, kw) of row r + kh: a warpgroup loads the A fragments of
// its 12 rows + 4 for one kw by ldmatrix and issues that kw's 5 x 12
// wgmmas with A in registers, so a wgmma reads its 512 bytes of B and a
// fifth of an A from shared memory instead of 2.5 KB (dec1's weights,
// packed by pack_weights_tc with N block 16, resident). Its epilogue writes
// the mid as conv_gray.cu's exit stages its input ([row][pixel][32 bytes],
// the halves swapped every 4 pixels) and the fix-up mirrors its border.
// dec2 runs conv_gray.cu's exit products on it (kw on N, one mma.sync a
// kernel row, pack_gray_exit's fragments), the shift-sum's P in its own
// buffer, and 2-byte row stores; a tile's fix-up, dec2 and stores run in
// pieces behind the batches of the next tile's first k-step, and a slot's
// next copy is issued as soon as its wgmmas are done.
//
// f32 (the test CLI, batch 1): one block of 8 warps an 8 x 64 output tile,
// every conv f32 FMAs (TF32 would miss the 1e-4 budget), the mid at an odd
// pitch in dynamic shared memory.
#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

constexpr int PR_THREADS = 256;  // 8 warps: two warpgroups in bf16
constexpr int PR_ACT_ANY = -1;   // act as a runtime argument (apply_act's switch)

namespace {

// The models' activations as template arguments, any other through the
// switch: a switch for every element of an epilogue costs a third of
// enc1's products (conv_chain.cuh).
template <int ACT>
__device__ __forceinline__ float pr_act(float v, int act) {
  if constexpr (ACT == PR_ACT_ANY)
    return apply_act(v, act);
  else
    return apply_act_c<ACT>(v);
}

__device__ __forceinline__ void st_shared32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src));
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

}  // namespace

// ---------------------------------------------------------------------------
// f32: FMAs (the test CLI's batch-1 route)
// ---------------------------------------------------------------------------
template <int KA, int KB, int CIN, int CMID, int COUT>
struct PairCfg {
  static constexpr int TH = 8, TW = 64;  // output tile
  static constexpr int PA = KA / 2, PB = KB / 2;
  static constexpr int MH = TH + 2 * PB, MW = TW + 2 * PB, M = MH * MW;  // mid tile
  static constexpr int IH = MH + 2 * PA, IW = MW + 2 * PA;             // input tile
  static constexpr int CC = CIN < 16 ? CIN : 16;  // input channels a stage
  static constexpr int NCH = CIN / CC;
  static_assert(CIN == CC * NCH, "CIN is 1 or a multiple of 16");
  static constexpr int SI = CC == 1 ? 1 : CC + 1;  // floats a staged pixel (odd pitch)
  static constexpr int SM = CMID + 1;
  static constexpr int IN_WORDS = (IH * IW * SI + 3) / 4 * 4;  // 16-byte aligned regions
  static constexpr int WA_WORDS = (KA * KA * CC * CMID + 3) / 4 * 4;
  static constexpr int MID_WORDS = (M * SM + 3) / 4 * 4;
  static constexpr int WB_WORDS = (KB * KB * CMID * COUT + 3) / 4 * 4;
  static constexpr size_t BYTES = (size_t)(IN_WORDS + WA_WORDS + MID_WORDS + WB_WORDS) * 4;
};

namespace {

// x1 (and x2 for a gray pair): the input images. CIN == 1: the gray pair
// (nsrc images each, f32 or bf16 by in_bf16), output image b < nsrc reads
// x1[b], else x2[b - nsrc]. CIN > 1: x1 (nsrc, H, W, CIN) f32.
// wa: [KA*KA][CIN][CMID], wb: [KB*KB][CMID][COUT], f32.
template <int KA, int KB, int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(PR_THREADS, 1)
conv_pair_kernel(const void* __restrict__ x1, const void* __restrict__ x2, int in_bf16,
                 const float* __restrict__ wa, const float* __restrict__ ba, int act_a,
                 const float* __restrict__ wb, const float* __restrict__ bb, int act_b,
                 float* __restrict__ y, int nsrc, int H, int W) {
  using C = PairCfg<KA, KB, CIN, CMID, COUT>;
  constexpr int TH = C::TH, TW = C::TW, PA = C::PA, PB = C::PB;
  constexpr int MH = C::MH, MW = C::MW, M = C::M, IH = C::IH, IW = C::IW;
  constexpr int CC = C::CC, SI = C::SI, SM = C::SM;
  extern __shared__ float4 pr_smem[];
  float* s_in = reinterpret_cast<float*>(pr_smem);
  float* s_wa = s_in + C::IN_WORDS;
  float* s_mid = s_wa + C::WA_WORDS;
  float* s_wb = s_mid + C::MID_WORDS;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int my0 = y0 - PB, mx0 = x0 - PB;  // the mid tile's origin in the image

  for (int idx = tid; idx < KB * KB * CMID * COUT; idx += PR_THREADS) s_wb[idx] = wb[idx];

  // stage input channels [ch*CC, ch*CC + CC) of the tile with pa + pb of
  // reflect halo, and the matching conv_a weights
  auto stage = [&](int ch) {
    if constexpr (CIN == 1) {
      const bool second = b >= nsrc;
      const size_t img = (size_t)(second ? b - nsrc : b) * H * W;
      const void* src = second ? x2 : x1;
      for (int pix = tid; pix < IH * IW; pix += PR_THREADS) {
        const int r = pix / IW, c = pix - r * IW;
        const size_t off =
            img + (size_t)reflect_index(my0 - PA + r, H) * W + reflect_index(mx0 - PA + c, W);
        s_in[pix] = in_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(src)[off])
                            : static_cast<const float*>(src)[off];
      }
    } else {
      const float* xb = static_cast<const float*>(x1) + (size_t)b * H * W * CIN + ch * CC;
      for (int idx = tid; idx < IH * IW * 2; idx += PR_THREADS) {
        const int half = idx & 1, pix = idx >> 1;
        const int r = pix / IW, c = pix - r * IW;
        const float* p = xb + ((size_t)reflect_index(my0 - PA + r, H) * W +
                               reflect_index(mx0 - PA + c, W)) * CIN + 8 * half;
        float v[8];
        load8(p, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s_in[pix * SI + 8 * half + j] = v[j];
      }
    }
    for (int idx = tid; idx < KA * KA * CC * CMID; idx += PR_THREADS) {
      const int co = idx % CMID, rest = idx / CMID;
      const int ci = rest % CC, tap = rest / CC;
      s_wa[idx] = wa[((size_t)tap * CIN + ch * CC + ci) * CMID + co];
    }
  };

  // ---- conv_a over the mid tile: CMID accumulators a position. One stage:
  // a position at a time. Several stages: every position of the thread
  // stays in registers across them. ----
  constexpr int NPA = (M + PR_THREADS - 1) / PR_THREADS;
  constexpr int G = C::NCH == 1 ? 1 : NPA;
  for (int i0 = 0; i0 < NPA; i0 += G) {
    float acc[G][CMID];
    int pos[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int m = min(tid + PR_THREADS * (i0 + i), M - 1);
      pos[i] = (m / MW) * IW + m % MW;
#pragma unroll
      for (int c = 0; c < CMID; ++c) acc[i][c] = 0.f;
    }
    for (int ch = 0; ch < C::NCH; ++ch) {
      if (C::NCH > 1 || i0 == 0) {
        stage(ch);
        __syncthreads();
      }
#pragma unroll 1
      for (int kh = 0; kh < KA; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KA; ++kw) {
#pragma unroll 4
          for (int ci = 0; ci < CC; ++ci) {
            const float4* w4 = reinterpret_cast<const float4*>(s_wa + ((kh * KA + kw) * CC + ci) * CMID);
            float wv[CMID];
#pragma unroll
            for (int q = 0; q < CMID / 4; ++q) {
              const float4 v = w4[q];
              wv[4 * q] = v.x; wv[4 * q + 1] = v.y; wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < G; ++i) {
              const float xv = s_in[(pos[i] + kh * IW + kw) * SI + ci];
#pragma unroll
              for (int c = 0; c < CMID; ++c) acc[i][c] = fmaf(xv, wv[c], acc[i][c]);
            }
          }
        }
      }
      if (C::NCH > 1) __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int m = tid + PR_THREADS * (i0 + i);
      if (m >= M) continue;
#pragma unroll
      for (int c = 0; c < CMID; ++c)
        s_mid[m * SM + c] = apply_act(acc[i][c] + (ba ? ba[c] : 0.f), act_a);
    }
  }
  __syncthreads();

  // ---- the mid's reflect halo: positions outside the image take the mid at
  // the reflected position (inside the image, so never overwritten here;
  // the clamp only serves ragged positions that feed no stored output) ----
  if (my0 < 0 || mx0 < 0 || my0 + MH > H || mx0 + MW > W) {
    for (int m = tid; m < M; m += PR_THREADS) {
      const int r = m / MW, c = m - r * MW;
      const int gy = my0 + r, gx = mx0 + c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) continue;
      const int ry = min(max(reflect_index(gy, H) - my0, 0), MH - 1);
      const int rx = min(max(reflect_index(gx, W) - mx0, 0), MW - 1);
      const float* src = s_mid + (ry * MW + rx) * SM;
#pragma unroll
      for (int q = 0; q < CMID; ++q) s_mid[m * SM + q] = src[q];
    }
    __syncthreads();
  }

  // ---- conv_b over the output tile: an item is one output pixel and CO_B
  // output channels ----
  constexpr int CO_B = COUT < 16 ? COUT : 16, NG = COUT / CO_B;
  for (int item = tid; item < TH * TW * NG; item += PR_THREADS) {
    const int o = item / NG, cg = item - o * NG;
    const int orow = o / TW, ocol = o - orow * TW;
    const int gy = y0 + orow, gx = x0 + ocol;
    if (gy >= H || gx >= W) continue;
    float acc[CO_B];
#pragma unroll
    for (int c = 0; c < CO_B; ++c) acc[c] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < KB; ++kh) {
#pragma unroll
      for (int kw = 0; kw < KB; ++kw) {
        const float* v = s_mid + ((orow + kh) * MW + ocol + kw) * SM;
        const float* wt = s_wb + (kh * KB + kw) * CMID * COUT + cg * CO_B;
#pragma unroll
        for (int ci = 0; ci < CMID; ++ci)
#pragma unroll
          for (int c = 0; c < CO_B; ++c) acc[c] = fmaf(v[ci], wt[ci * COUT + c], acc[c]);
      }
    }
    float* dst = y + (((size_t)b * H + gy) * W + gx) * COUT + cg * CO_B;
#pragma unroll
    for (int c = 0; c < CO_B; ++c)
      dst[c] = apply_act(acc[c] + (bb ? bb[cg * CO_B + c] : 0.f), act_b);
  }
}

}  // namespace

template <int KA, int KB, int CIN, int CMID, int COUT>
static int launch_pair_f32(const void* x1, const void* x2, int in_bf16, const void* wa,
                           const float* ba, int act_a, const void* wb, const float* bb, int act_b,
                           void* y, int nsrc, int n_out, int h, int w, cudaStream_t s) {
  using C = PairCfg<KA, KB, CIN, CMID, COUT>;
  auto kern = conv_pair_kernel<KA, KB, CIN, CMID, COUT>;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((w + C::TW - 1) / C::TW, (h + C::TH - 1) / C::TH, n_out);
  kern<<<grid, PR_THREADS, C::BYTES, s>>>(x1, x2, in_bf16, static_cast<const float*>(wa), ba,
                                          act_a, static_cast<const float*>(wb), bb, act_b,
                                          static_cast<float*>(y), nsrc, h, w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: both kernels
// ---------------------------------------------------------------------------
struct PairArgs {
  const void* x1;            // enter: img1 (B, H, W, 1); exit: x (B, H, W, 32) bf16
  const void* x2;            // enter: img2
  const __nv_bfloat16* wa;   // packed (ops/cuda/conv_pair.py pair_weights)
  const float* ba;
  const __nv_bfloat16* wb;
  const float* bb;
  int act_a, act_b;
  __nv_bfloat16* y;
  int B, H, W, in_bf16;      // B: images of x1 (the enter writes 2B)
  int tiles_x, tiles_y, n_tiles;
};

// tile -> (image, first row, first column), x fastest (ops/cuda/conv_pair.py
// pair_tile mirrors it)
__device__ __forceinline__ void pr_tile(const PairArgs& a, int tile, int th, int tw, int& b,
                                        int& y0, int& x0) {
  const int per_img = a.tiles_x * a.tiles_y;
  b = tile / per_img;
  const int r = tile - b * per_img;
  y0 = (r / a.tiles_x) * th;
  x0 = (r % a.tiles_x) * tw;
}

// The persistent grid: as many blocks as fit on the SMs beside `smem` bytes
// of dynamic shared memory, at most one a tile (every block resident at
// once). Sets the tiling of a. 0 or a cudaError_t. `cache` keeps the block
// count of the instance (the occupancy query costs more host time than the
// launch).
struct PairGrid {
  int blocks = 0;
  int dev = -1;
};

static int pair_grid(const void* kernel, PairGrid& cache, size_t smem, int th, int tw,
                     int b_out, PairArgs& a, int& grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (cache.dev != dev) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, PR_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    cache.blocks = sms * occ;
    cache.dev = dev;
  }
  a.tiles_x = (a.W + tw - 1) / tw;
  a.tiles_y = (a.H + th - 1) / th;
  const long long tiles = (long long)a.tiles_x * a.tiles_y * b_out;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  a.n_tiles = (int)tiles;
  grid = a.n_tiles < cache.blocks ? a.n_tiles : cache.blocks;
  return 0;
}

// ---- bf16 enter: enc0 (1 -> 16, k5) then enc1 (16 -> 32, k7) ----
constexpr int PE_TH = 8;                    // output rows a tile
constexpr int PE_MT = PE_TH / 2;            // m64 tiles (output rows) a warpgroup
constexpr int PE_MH = PE_TH + 6, PE_MW = 64 + 6;  // mid tile: enc1's k7 halo
constexpr int PE_HALF = (PE_MH * PE_MW * 16 + 127) / 128 * 128 + 64;
constexpr int PE_MID = 2 * PE_HALF;         // [half][row][pixel][8 channels] bf16
constexpr int PE_IN_H = PE_MH + 4;          // staged image rows: enc0's k5 halo
constexpr int PE_SW = 112;                  // staged columns a row: x0 - 8 .. x0 + 103
constexpr int PE_IN = PE_IN_H * PE_SW * 2;  // one staged tile, bf16
constexpr int PE_W1 = 49 * 32 * 32;         // enc1: [tap][half][32 n][8] bf16
constexpr int PE_OUT_PITCH = 80;            // bytes of a staged output pixel
constexpr int PE_OUT = PE_TH * 64 * PE_OUT_PITCH;
constexpr size_t PE_SMEM = (size_t)PE_W1 + 2 * PE_MID + PE_OUT + 2 * PE_IN;
// enc0 columns: 3 groups of 32 a mid row, column u of the groups is image
// column x0 - 4 + u (even u: even image column) and mid column u - 1
constexpr int PE_GROUPS = 3;
static_assert(32 * PE_GROUPS >= PE_MW + 1, "the groups cover the mid row");
static_assert(PE_SMEM <= 232448, "the enter's plan fits shared memory");

namespace {

// Stage tile `tile`'s image rows y0 - 5 .. y0 + 12 (reflected) and columns
// x0 - 8 .. x0 + 103 as bf16. vec (bf16 images, W a multiple of 8): each
// 8-column chunk lies inside the image or outside it; the inside ones are
// 16-byte cp.async, the outside ones filled by pe_halo once they land.
// Otherwise element loads with the reflect, rounded to bf16 (the cast to
// the chain dtype).
__device__ __forceinline__ void pe_stage(const PairArgs& a, int tile, __nv_bfloat16* d,
                                         bool vec) {
  if (tile >= a.n_tiles) return;
  int b, y0, x0;
  pr_tile(a, tile, PE_TH, 64, b, y0, x0);
  const bool second = b >= a.B;
  const size_t img = (size_t)(second ? b - a.B : b) * a.H * a.W;
  const void* src = second ? a.x2 : a.x1;
  if (vec) {
    const __nv_bfloat16* im = static_cast<const __nv_bfloat16*>(src) + img;
    for (int i = threadIdx.x; i < PE_IN_H * (PE_SW / 8); i += PR_THREADS) {
      const int r = i / (PE_SW / 8), c = i - r * (PE_SW / 8);
      const int xc = x0 - 8 + 8 * c;
      if (xc >= 0 && xc + 8 <= a.W)
        cp_async16(smem_u32(d + r * PE_SW + 8 * c),
                   im + (size_t)reflect_index(y0 - 5 + r, a.H) * a.W + xc, 16);
    }
  } else {
    for (int i = threadIdx.x; i < PE_IN_H * PE_SW; i += PR_THREADS) {
      const int r = i / PE_SW, c = i - r * PE_SW;
      const size_t off =
          img + (size_t)reflect_index(y0 - 5 + r, a.H) * a.W + reflect_index(x0 - 8 + c, a.W);
      const float v = a.in_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(src)[off])
                                : static_cast<const float*>(src)[off];
      d[i] = __float2bfloat16_rn(v);
    }
  }
}

// The staged columns outside the image (vec tiles at its left or right
// edge) from the columns they mirror. A column that mirrors one outside the
// stage feeds no stored output: it takes the nearest staged value.
__device__ __forceinline__ void pe_halo(const PairArgs& a, int tile, __nv_bfloat16* d) {
  int b, y0, x0;
  pr_tile(a, tile, PE_TH, 64, b, y0, x0);
  if (x0 >= 8 && x0 + PE_SW - 8 <= a.W) return;
  for (int sc = threadIdx.x; sc < PE_SW; sc += PR_THREADS) {
    const int xc = x0 - 8 + sc;
    if (xc >= 0 && xc < a.W) continue;
    const int src = min(max(reflect_index(xc, a.W) - (x0 - 8), 0), PE_SW - 1);
#pragma unroll
    for (int r = 0; r < PE_IN_H; ++r) d[r * PE_SW + sc] = d[r * PE_SW + src];
  }
}

// enc0 over the tile's mid: warp w takes (mid row, group) jobs w, w + 8, ...
// A lane's A pairs are the same words for even and odd columns at k5 (the
// window starts 2 columns left of an even column, 3 of an odd one); each
// parity has its own B (bq[parity][kernel-row pair][N tile]).
template <int ACT>
__device__ __forceinline__ void pe_enc0(const __nv_bfloat16* in, uint32_t mid,
                                        const uint2 (&bq)[2][3][2], const float (&b0)[2][2],
                                        int act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(in);
#pragma unroll 1
  for (int job = warp; job < PE_MH * PE_GROUPS; job += PR_THREADS / 32) {
    const int mr = job / PE_GROUPS, gp = job - mr * PE_GROUPS;
    float acc[2][2][4];
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[par][nt][e] = b0[nt][e & 1];
    // the word of column u = 32 gp + 2 g + par, taps 2 t, 2 t + 1: staged
    // column u + 4 - Q + 2 t (Q = 2 even, 3 odd)
    const uint32_t* r0 = words + mr * (PE_SW / 2) + 1 + 16 * gp + g + t;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint32_t* rq = r0 + 2 * q * (PE_SW / 2);
      uint32_t av[4];
      av[0] = rq[0];
      av[1] = rq[8];
      if (q < 2) {
        av[2] = rq[PE_SW / 2];
        av[3] = rq[PE_SW / 2 + 8];
      } else {
        av[2] = av[3] = 0u;
      }
#pragma unroll
      for (int par = 0; par < 2; ++par)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[par][nt], av, bq[par][q][nt].x, bq[par][q][nt].y);
    }
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int mc = 32 * gp + 2 * g + par + 16 * hh - 1;
        if (mc < 0 || mc >= PE_MW) continue;
        const uint32_t at = mid + (mr * PE_MW + mc) * 16 + 4 * t;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          st_shared32(at + nt * PE_HALF, pack_bf16(pr_act<ACT>(acc[par][nt][2 * hh], act),
                                                   pr_act<ACT>(acc[par][nt][2 * hh + 1], act)));
      }
  }
}

// The mid's reflect halo (see the header): a tile at the image's border
// overwrites every mid position outside the image with the mid at the
// reflected position. at(r, c, h) is the shared-memory address of channel
// half h of mid position (r, c) in the caller's layout.
template <class At>
__device__ __forceinline__ void pr_fixup(int my0, int mx0, int mh, int mw, int H, int W, At at) {
  if (my0 >= 0 && mx0 >= 0 && my0 + mh <= H && mx0 + mw <= W) return;
  for (int m = threadIdx.x; m < mh * mw; m += PR_THREADS) {
    const int r = m / mw, c = m - r * mw;
    const int gy = my0 + r, gx = mx0 + c;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) continue;
    const int ry = min(max(reflect_index(gy, H) - my0, 0), mh - 1);
    const int rx = min(max(reflect_index(gx, W) - mx0, 0), mw - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) st_shared16(at(r, c, h), ld_shared16(at(ry, rx, h)));
  }
}

// enc1's accumulators, bias and activation in f32, as bf16 pairs into the
// output tile ([pixel][32 channels], PE_OUT_PITCH bytes a pixel)
template <int ACT>
__device__ __forceinline__ void pe_stage_out(float (&acc)[PE_MT][16], const float (&b1)[4][2],
                                             uint32_t s_out, int wg, int act) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < PE_MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pix = (wg * PE_MT + m) * 64 + 16 * warp + g + 8 * e;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_shared32(s_out + pix * PE_OUT_PITCH + 16 * j + 4 * q,
                    pack_bf16(pr_act<ACT>(acc[m][4 * j + 2 * e] + b1[j][0], act),
                              pr_act<ACT>(acc[m][4 * j + 2 * e + 1] + b1[j][1], act)));
    }
}

// The output tile to global memory: 16 bytes (8 channels of a pixel) a
// thread, consecutive threads on consecutive bytes.
__device__ __forceinline__ void pe_store(const PairArgs& a, int tile, uint32_t s_out) {
  int b, y0, x0;
  pr_tile(a, tile, PE_TH, 64, b, y0, x0);
  for (int i = threadIdx.x; i < PE_TH * 64 * 4; i += PR_THREADS) {
    const int pix = i >> 2, c = i & 3;
    const int oy = y0 + (pix >> 6), ox = x0 + (pix & 63);
    if (oy < a.H && ox < a.W)
      *reinterpret_cast<uint4*>(a.y + (((size_t)b * a.H + oy) * a.W + ox) * 32 + 8 * c) =
          ld_shared16(s_out + pix * PE_OUT_PITCH + 16 * c);
  }
}

// enc0 of tile `tile` from staged buffer `in` into `mid`, then its fix-up.
// The caller has waited for the tile's copies.
template <int ACT>
__device__ __forceinline__ void pe_mid(const PairArgs& a, int tile, __nv_bfloat16* in,
                                       uint32_t mid, bool vec, const uint2 (&bq)[2][3][2],
                                       const float (&b0)[2][2]) {
  __syncthreads();  // the tile's copies visible to every thread
  if (vec) {
    pe_halo(a, tile, in);
    __syncthreads();
  }
  pe_enc0<ACT>(in, mid, bq, b0, a.act_a);
  __syncthreads();  // the mid written; `in` free for the next copy
  int b, y0, x0;
  pr_tile(a, tile, PE_TH, 64, b, y0, x0);
  pr_fixup(y0 - 3, x0 - 3, PE_MH, PE_MW, a.H, a.W, [mid](int r, int c, int h) {
    return mid + h * PE_HALF + (r * PE_MW + c) * 16;
  });
}

}  // namespace

// Tile t's image rows sit in staging buffer t % 2 (of the block's tiles)
// and its mid in buffer t % 2; the copy of tile t + 2 is issued once tile
// t's enc0 is done.
template <int ACT_A, int ACT_B>
__global__ void __launch_bounds__(PR_THREADS, 1) pair_enter_kernel(const __grid_constant__ PairArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_w1 = smem_u32(smem);
  const uint32_t s_mid = s_w1 + PE_W1;
  const uint32_t s_out = s_mid + 2 * PE_MID;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + PE_W1 + 2 * PE_MID + PE_OUT);
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform, so the descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool vec = a.in_bf16 && a.W % 8 == 0;

  for (int i = tid; i < PE_W1 / 16; i += PR_THREADS) cp_async16(s_w1 + 16 * i, a.wb + 8 * i, 16);
  uint2 bq[2][3][2];
  const uint2* wq = reinterpret_cast<const uint2*>(a.wa);
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) bq[par][q][nt] = __ldg(wq + ((par * 3 + q) * 2 + nt) * 32 + lane);
  float b0[2][2], b1[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * (lane & 3) + e;
      if (j < 2) b0[j][e] = a.ba ? __ldg(a.ba + c) : 0.f;
      b1[j][e] = a.bb ? __ldg(a.bb + c) : 0.f;
    }

  const int step = gridDim.x;
  int tile = blockIdx.x;
  pe_stage(a, tile, s_in, vec);
  cp_async_commit();
  pe_stage(a, tile + step, s_in + PE_IN / 2, vec);
  cp_async_commit();
  if (tile < a.n_tiles) {
    cp_async_wait<1>();
    pe_mid<ACT_A>(a, tile, s_in, s_mid, vec, bq, b0);
  }
  pe_stage(a, tile + 2 * step, s_in, vec);
  cp_async_commit();

  float acc[PE_MT][16];
  for (int it = 0; tile < a.n_tiles; ++it, tile += step) {
    const uint32_t mid = s_mid + (it & 1) * PE_MID;
    // the tile's mid (and its fix-up) visible to the async proxy and every
    // warpgroup; the output tile written
    fence_proxy_async();
    __syncthreads();
    const uint64_t da0 = wgmma_desc(mid + wg * PE_MT * PE_MW * 16, PE_HALF, 128);
    const uint64_t db0 = wgmma_desc(s_w1, 32 * 16, 128);
#pragma unroll
    for (int m = 0; m < PE_MT; ++m) fence_acc(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < 7; ++kh)
#pragma unroll
      for (int kw = 0; kw < 7; ++kw) {
        const uint64_t db = desc_add(db0, (kh * 7 + kw) * 1024);
#pragma unroll
        for (int m = 0; m < PE_MT; ++m)
          wgmma_bf16<32>(acc[m], desc_add(da0, ((m + kh) * PE_MW + kw) * 16), db,
                         kh > 0 || kw > 0);
      }
    wgmma_commit();
    // while the tensor cores work: the last tile's outputs, the next tile's
    // mid, the copy of the tile after the next one
    if (it > 0) pe_store(a, tile - step, s_out);
    const int next = tile + step;
    __nv_bfloat16* in_next = s_in + ((it + 1) & 1) * (PE_IN / 2);
    if (next < a.n_tiles) {
      cp_async_wait<1>();
      pe_mid<ACT_A>(a, next, in_next, s_mid + ((it + 1) & 1) * PE_MID, vec, bq, b0);
    }
    pe_stage(a, tile + 3 * step, in_next, vec);
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < PE_MT; ++m) fence_acc(acc[m]);
    __syncthreads();  // the last tile's outputs stored out of s_out
    pe_stage_out<ACT_B>(acc, b1, s_out, wg, a.act_b);
  }
  if ((int)blockIdx.x < a.n_tiles) {
    __syncthreads();
    pe_store(a, tile - step, s_out);
  }
  cp_async_wait<0>();
}

// ---- bf16 exit: dec1 (32 -> 16, k5) then dec2 (16 -> 1, k5) ----
constexpr int PX_TH = 20, PX_TW = 56;       // output tile
constexpr int PX_MH = PX_TH + 4, PX_MW = PX_TW + 4;  // mid tile: dec2's k5 halo
constexpr int PX_PITCH = 64;                // staged pixels a row: a mid row is one m64 tile
constexpr int PX_IH = PX_MH + 4;            // staged rows: dec1's k5 halo
constexpr int PX_MT = PX_MH / 2;            // mid rows (m64 tiles) a warpgroup
constexpr int PX_NF = PX_MT + 4;            // A fragments a warpgroup holds for one kw
// a half of a staged k-step: its rows and the pixels past the last row
// that the junk columns' last taps reach
constexpr int PX_HALF = ((PX_IH * PX_PITCH + 8) * 16 + 127) / 128 * 128 + 64;
constexpr int PX_SLOT = 2 * PX_HALF;        // one k-step: [half][pixel][8 channels]
constexpr int PX_W1 = 2 * 25 * 16 * 32;     // dec1: [k-step][tap][half][16 n][8] bf16
constexpr int PX_SCP = 64;                  // mid pixels a row for dec2: 4 strips of 16
constexpr int PX_MID = PX_MH * PX_SCP * 32; // [row][pixel][32 bytes]
constexpr int PX_PP = PX_SCP + 4;           // P row pitch (floats; 4 mod 16: no conflicts)
constexpr int PX_CH = 5;                    // dec2 output rows a job
constexpr int PX_PB = PX_TH * 5 * PX_PP * 4;
constexpr size_t PX_SMEM = (size_t)2 * PX_SLOT + PX_W1 + PX_MID + PX_PB;
static_assert(PX_MH % 2 == 0 && PX_PITCH >= PX_MW, "two warpgroups, a mid row an m-tile");
static_assert(PX_SCP >= PX_MW && PX_SCP % 16 == 0, "dec2's strips cover the mid row");
static_assert((PX_SCP / 16) * (PX_TH / PX_CH) == 2 * (PR_THREADS / 32),
              "dec2's jobs are two rounds of the warps");
static_assert(PX_SMEM <= 232448, "the exit's plan fits shared memory");

namespace {

// k-step ks of tile `tile`: the input rows y0 - 4 .. and pixels x0 - 4 ..
// (PX_IH x PX_PITCH, reflected in the source address), channels 16 ks ..
// 16 ks + 15, as [half][pixel][8 channels].
__device__ __forceinline__ void px_stage(const PairArgs& a, int tile, int ks, uint32_t slot) {
  if (tile >= a.n_tiles) return;
  int b, y0, x0;
  pr_tile(a, tile, PX_TH, PX_TW, b, y0, x0);
  const __nv_bfloat16* xb =
      static_cast<const __nv_bfloat16*>(a.x1) + (size_t)b * a.H * a.W * 32 + 16 * ks;
  for (int i = threadIdx.x; i < PX_IH * PX_PITCH * 2; i += PR_THREADS) {
    const int half = i & 1, pix = i >> 1;
    const int r = pix / PX_PITCH, c = pix - r * PX_PITCH;
    const size_t px = (size_t)reflect_index(y0 - 4 + r, a.H) * a.W + reflect_index(x0 - 4 + c, a.W);
    cp_async16(slot + half * PX_HALF + pix * 16, xb + px * 32 + 8 * half, 16);
  }
}

// dec1's accumulators (m-tile j of warpgroup wg is mid row wg PX_MT + j),
// bias and activation in f32, rounded to bf16 into the mid; the columns
// past the mid's dropped.
template <int ACT>
__device__ __forceinline__ void px_mid_out(float (&acc)[PX_MT][8], const float (&b1)[2][2],
                                           uint32_t s_mid, int wg, int act) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int mc = 16 * warp + g + 8 * e;
    if (mc >= PX_MW) continue;
    const int sw = (mc >> 2) & 1;
#pragma unroll
    for (int j = 0; j < PX_MT; ++j) {
      const uint32_t at = s_mid + ((wg * PX_MT + j) * PX_SCP + mc) * 32 + 4 * q;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        st_shared32(at + ((jj ^ sw) << 4),
                    pack_bf16(pr_act<ACT>(acc[j][4 * jj + 2 * e] + b1[jj][0], act),
                              pr_act<ACT>(acc[j][4 * jj + 2 * e + 1] + b1[jj][1], act)));
    }
  }
}

// Piece `part` (0-3) of a tile's way from the mid to outputs, spread over
// the next tile's first k-step: 0 the fix-up, 1 and 2 dec2's two rounds of
// jobs (P[o][kw][x] = sum_kh sum_ci mid[o + kh][x][ci] w[ci][kh][kw]: job
// (strip, PX_CH rows), a strip 16 mid columns loaded by ldmatrix a row),
// 3 out[o][x] = act(bias + sum_kw P[o][kw][x + kw]) in 2-byte stores,
// consecutive threads on consecutive pixels.
template <int ACT>
__device__ __forceinline__ void px_finish(const PairArgs& a, int tile, int part, uint32_t s_mid,
                                          float* s_p, const uint2 (&b2)[5], float bias2) {
  int b, y0, x0;
  pr_tile(a, tile, PX_TH, PX_TW, b, y0, x0);
  if (part == 0) {
    pr_fixup(y0 - 2, x0 - 2, PX_MH, PX_MW, a.H, a.W, [s_mid](int r, int c, int h) {
      return s_mid + (r * PX_SCP + c) * 32 + ((h ^ ((c >> 2) & 1)) << 4);
    });
    __syncthreads();
  } else if (part < 3) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int job = warp + (part - 1) * (PR_THREADS / 32);
    const int s = job % (PX_SCP / 16), o0 = (job / (PX_SCP / 16)) * PX_CH;
    // ldmatrix x4: lanes 0-7 pixels 0-7 channels 0-7, 8-15 pixels 8-15,
    // 16-23 pixels 0-7 channels 8-15, 24-31 pixels 8-15 channels 8-15
    const int px = 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8;
    const uint32_t base = s_mid + px * 32 + (((lane >> 4) ^ ((px >> 2) & 1)) << 4);
    float acc[PX_CH][4];
#pragma unroll
    for (int o = 0; o < PX_CH; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;
#pragma unroll
    for (int rr = 0; rr < PX_CH + 4; ++rr) {
      uint32_t av[4];
      ldmatrix_x4(av, base + (o0 + rr) * PX_SCP * 32);
#pragma unroll
      for (int kh = 0; kh < 5; ++kh) {
        const int o = rr - kh;
        if (o >= 0 && o < PX_CH) mma_bf16(acc[o], av, b2[kh].x, b2[kh].y);
      }
    }
#pragma unroll
    for (int o = 0; o < PX_CH; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kw = 2 * t + (e & 1);
        if (kw < 5) s_p[((o0 + o) * 5 + kw) * PX_PP + 16 * s + g + 8 * (e >> 1)] = acc[o][e];
      }
    if (part == 2) __syncthreads();
  } else {
    for (int i = threadIdx.x; i < PX_TH * PX_TW; i += PR_THREADS) {
      const int o = i / PX_TW, x = i - o * PX_TW;
      const int gy = y0 + o, gx = x0 + x;
      if (gy < a.H && gx < a.W) {
        float v = bias2;
#pragma unroll
        for (int kw = 0; kw < 5; ++kw) v += s_p[(o * 5 + kw) * PX_PP + x + kw];
        a.y[((size_t)b * a.H + gy) * a.W + gx] = __float2bfloat16_rn(pr_act<ACT>(v, a.act_b));
      }
    }
  }
}

}  // namespace

// Stage s of the block is tile blockIdx.x + (s / 2) * gridDim.x, k-step s %
// 2, in ring slot s % 2; stage s + 2's copy is issued once stage s's
// wgmmas are done. dec1 over a k-step is five batches, one a kw: with the
// mid's pitch 64, tap (kh, kw) of mid row r reads the staged pixels of tap
// (0, kw) of row r + kh, so a warpgroup loads the A fragments of its rows
// and kw (ldmatrix, PX_NF a batch) once and issues the 5 x PX_MT wgmmas of
// the batch with A in registers: a wgmma's shared-memory traffic is its B
// and a fifth of an A, not 2 KB of A. The previous tile's finish runs in
// pieces behind the first k-step's batches.
template <int ACT_A, int ACT_B>
__global__ void __launch_bounds__(PR_THREADS, 1) pair_exit_kernel(const __grid_constant__ PairArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_slot = smem_u32(smem);
  const uint32_t s_w1 = s_slot + 2 * PX_SLOT;
  const uint32_t s_mid = s_w1 + PX_W1;
  float* s_p = reinterpret_cast<float*>(smem + 2 * PX_SLOT + PX_W1 + PX_MID);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  for (int i = tid; i < PX_W1 / 16; i += PR_THREADS) cp_async16(s_w1 + 16 * i, a.wa + 8 * i, 16);
  uint2 b2[5];
  const uint2* wq = reinterpret_cast<const uint2*>(a.wb);
#pragma unroll
  for (int kh = 0; kh < 5; ++kh) b2[kh] = __ldg(wq + kh * 32 + lane);
  float b1[2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) b1[jj][e] = a.ba ? __ldg(a.ba + 8 * jj + 2 * (lane & 3) + e) : 0.f;
  const float bias2 = a.bb ? __ldg(a.bb) : 0.f;
  // this lane's ldmatrix row of its warp's 16 rows of an m-tile, and half
  const uint32_t a_lane = ((lane >> 4) * PX_HALF +
                           (wg * PX_MT * PX_PITCH + 16 * ((tid >> 5) & 3) + (lane & 7) +
                            ((lane >> 3) & 1) * 8) * 16);

  const int my_tiles =
      (int)blockIdx.x < a.n_tiles ? (a.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int S = 2 * my_tiles;
  px_stage(a, blockIdx.x, 0, s_slot);
  cp_async_commit();
  px_stage(a, blockIdx.x, 1, s_slot + PX_SLOT);
  cp_async_commit();

  float acc[PX_MT][8];
  int staged = -1;  // the tile whose mid waits in s_mid
  for (int s = 0; s < S; ++s) {
    // stage s landed and visible to every thread and the async proxy
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int ks = s & 1;
    const int tile = blockIdx.x + (s >> 1) * gridDim.x;
    const uint32_t slot = s_slot + ks * PX_SLOT;
    const uint64_t db0 = wgmma_desc(s_w1 + ks * (PX_W1 / 2), 16 * 16, 128);
#pragma unroll
    for (int kw = 0; kw < 5; ++kw) {
      uint32_t fa[PX_NF][4];
#pragma unroll
      for (int i = 0; i < PX_NF; ++i) ldmatrix_x4(fa[i], slot + a_lane + (i * PX_PITCH + kw) * 16);
#pragma unroll
      for (int i = 0; i < PX_NF; ++i) fence_regs(fa[i]);
#pragma unroll
      for (int j = 0; j < PX_MT; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < 5; ++kh) {
        const uint64_t db = desc_add(db0, (kh * 5 + kw) * 512);
        // a tile's first product overwrites the accumulators
        const int scale_d = ks > 0 || kh > 0 || kw > 0;
#pragma unroll
        for (int j = 0; j < PX_MT; ++j) wgmma_bf16_ra<16, 0>(acc[j], fa[j + kh], db, scale_d);
      }
      wgmma_commit();
      if (ks == 0 && staged >= 0 && kw < 4)
        px_finish<ACT_B>(a, staged, kw, s_mid, s_p, b2, bias2);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < PX_MT; ++j) fence_acc(acc[j]);
#pragma unroll
      for (int i = 0; i < PX_NF; ++i) fence_regs(fa[i]);
    }
    if (ks == 0) staged = -1;
    __syncthreads();  // every warpgroup done with the slot (and the last tile's mid)
    px_stage(a, blockIdx.x + ((s + 2) >> 1) * gridDim.x, ks, slot);
    cp_async_commit();
    if (ks == 1) {
      px_mid_out<ACT_A>(acc, b1, s_mid, wg, a.act_a);
      staged = tile;
    }
  }
  if (staged >= 0) {
    __syncthreads();
#pragma unroll 1
    for (int part = 0; part < 4; ++part) px_finish<ACT_B>(a, staged, part, s_mid, s_p, b2, bias2);
  }
  cp_async_wait<0>();
}

// The models' activations compiled in (enter relu/relu, exit relu/none),
// any other through the switch.
static PairArgs pair_args(const void* x1, const void* x2, int in_bf16, const void* wa,
                          const float* ba, int act_a, const void* wb, const float* bb, int act_b,
                          void* y, int b, int h, int w) {
  PairArgs a = {};
  a.x1 = x1;
  a.x2 = x2;
  a.wa = static_cast<const __nv_bfloat16*>(wa);
  a.ba = ba;
  a.act_a = act_a;
  a.wb = static_cast<const __nv_bfloat16*>(wb);
  a.bb = bb;
  a.act_b = act_b;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = b;
  a.H = h;
  a.W = w;
  a.in_bf16 = in_bf16;
  return a;
}

template <int ACT_A, int ACT_B>
static int launch_enter_tc(PairArgs a, cudaStream_t s) {
  const auto kernel = pair_enter_kernel<ACT_A, ACT_B>;
  static PairGrid cache;
  int grid = 0;
  const int e = pair_grid((const void*)kernel, cache, PE_SMEM, PE_TH, 64, 2 * a.B, a, grid);
  if (e) return e;
  if (grid > 0) kernel<<<grid, PR_THREADS, PE_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <int ACT_A, int ACT_B>
static int launch_exit_tc(PairArgs a, cudaStream_t s) {
  const auto kernel = pair_exit_kernel<ACT_A, ACT_B>;
  static PairGrid cache;
  int grid = 0;
  const int e = pair_grid((const void*)kernel, cache, PX_SMEM, PX_TH, PX_TW, a.B, a, grid);
  if (e) return e;
  if (grid > 0) kernel<<<grid, PR_THREADS, PX_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// DeepFuse's enter pair: img1, img2 (b, h, w, 1) in in_dtype; y (2b, h, w,
// 32) in dtype (the chain dtype). bf16: wa enc0's B fragments
// (pack_gray_enter), wb enc1's weights (pack_weights_tc, N block 32). f32:
// wa [25][1][16], wb [49][16][32]. ba f32 (16), bb f32 (32), or null.
int mmif_conv_pair_enter(int dtype, int in_dtype, const void* img1, const void* img2,
                         const void* wa, const float* ba, int act_a, const void* wb,
                         const float* bb, int act_b, void* y, int b, int h, int w,
                         void* stream) {
  if (h <= 3 || w <= 3 || b < 1 || (in_dtype != DT_F32 && in_dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_bf16 = in_dtype == DT_BF16;
  if (dtype == DT_F32)
    return launch_pair_f32<5, 7, 1, 16, 32>(img1, img2, in_bf16, wa, ba, act_a, wb, bb, act_b, y,
                                            b, 2 * b, h, w, s);
  if (dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const PairArgs a = pair_args(img1, img2, in_bf16, wa, ba, act_a, wb, bb, act_b, y, b, h, w);
  if (act_a == ACT_RELU && act_b == ACT_RELU) return launch_enter_tc<ACT_RELU, ACT_RELU>(a, s);
  return launch_enter_tc<PR_ACT_ANY, PR_ACT_ANY>(a, s);
}

// DeepFuse's exit pair: x (b, h, w, 32) in dtype; y (b, h, w, 1) in dtype.
// bf16: wa dec1's weights (pack_weights_tc, N block 16), wb dec2's B
// fragments (pack_gray_exit). f32: wa [25][32][16], wb [25][16][1]. ba f32
// (16), bb f32 (1), or null.
int mmif_conv_pair_exit(int dtype, const void* x, const void* wa, const float* ba, int act_a,
                        const void* wb, const float* bb, int act_b, void* y, int b, int h, int w,
                        void* stream) {
  if (h <= 2 || w <= 2 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_pair_f32<5, 5, 32, 16, 1>(x, nullptr, 0, wa, ba, act_a, wb, bb, act_b, y, b, b,
                                            h, w, s);
  if (dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const PairArgs a = pair_args(x, nullptr, 1, wa, ba, act_a, wb, bb, act_b, y, b, h, w);
  if (act_a == ACT_RELU && act_b == ACT_NONE) return launch_exit_tc<ACT_RELU, ACT_NONE>(a, s);
  return launch_exit_tc<PR_ACT_ANY, PR_ACT_ANY>(a, s);
}

}  // extern "C"
