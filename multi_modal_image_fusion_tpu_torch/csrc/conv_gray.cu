// The chain's first and last convs: conv_gray_enter (a grayscale image or
// pair, 1 channel -> Cout) and conv_gray_exit (Cin -> 1 channel), NHWC,
// reflect-SAME, f32 accumulate, bias and activation in f32, one rounding to
// the output dtype.
//
// Replaces two TPU kernels of multi_modal_image_fusion_tpu/ops/pallas/:
//   conv_gray_enter <- conv_kernel.py:357 _chain_enter_gray (via
//                      hiw_kernel.py:87 hiw_enter) fused with the entry
//                      conv that conv_hiw_chain (hiw_kernel.py:335) runs on
//                      it: c_in=1 over a pair as batch halves (DeepFuse
//                      enc0, DenseFuse/VIFNet/Res2Fusion/PFNet/DIFNet
//                      conv_in, DBNet's encode, UNFusion CB1_0, the k1
//                      conv_in of NestFuse, RFNNest and MAFusion, IFCNN's
//                      k7 enc0), or c_in=2 over two gray legs, the images
//                      as the two channels of one input (PMGI's entry convs
//                      over concat(i, i, j), zoo.py:1521-1526: the
//                      duplicate channel's weights summed on the host)
//   conv_gray_exit  <- conv_kernel.py:383 _chain_exit_gray (via
//                      hiw_kernel.py:105 hiw_exit) fused with the c_out=1
//                      exit conv (DeepFuse dec2, the dec3 of DenseFuse,
//                      VIFNet, Res2Fusion and DBNet, UNFusion conv_out, the
//                      last conv of IFCNN, DIFNet and PFNet), over one
//                      tensor or over up to 8 legs read in place (PMGI's
//                      decode over its 8-leg concat, zoo.py:1549-1551)
//
// The function is the JAX chain's: in bf16 the weights are rounded to bf16
// (hiw_kernel.py:387), the products are exact and summed in f32.
//
// What bounds them on an H100: bytes. At 16 pairs of 1224x1024 the enter
// writes 32 images x 16 channels (1.28 GB bf16, 0.38 ms at 3.35 TB/s) from
// 2 bytes a pixel; the exit reads 16 images x 16 channels (0.64 GB) to write
// 2 bytes a pixel. Their f32 FMAs (16.0 and 8.0 G at k5) alone would take
// 0.48 and 0.24 ms on the CUDA cores, above those bounds, so in bf16 the
// products run on the tensor cores (mma.sync m16n8k16, warp-level: the
// layers are far below the card's operations-per-byte balance, so the
// warpgroup MMA buys nothing here). Both kernels have a persistent grid
// (as many blocks as fit on the SMs, each walking tiles, x fastest), stage
// their input with cp.async (reflect index math in the source address: TMA
// fills out-of-bounds boxes with zeros), and store coalesced.
//
// conv_gray_enter: a tile is EN_TH output rows of EN_TW pixels, one warp a
// row. M = pixels, N = output channels (8 a tile of N), K = taps: for a
// pair of kernel rows (kh, kh + 1), A[x][j] = in[y + kh][x - Q + j] and
// A[x][8 + j] = in[y + kh + 1][x - Q + j], B[j][co] = w[co][kh][j - Q + P]
// (zero outside the K taps), so a k5 conv is 3 MMAs a 16 x 8 tile and a k3
// conv 2. A thread's A elements are bf16 pairs of one staged image row; a
// pair is one aligned 32-bit shared load only if it starts at an even
// column, so an M tile holds either the even or the odd pixels of 32, with
// its own window offset Q (QE even, QO odd) and B (the tap shift folded
// into the packed weights, ops/cuda/conv_chain.py pack_gray_enter). The
// staged input is the 1-channel image rows of the tile plus the halo, in a
// ring of two tiles (the next tile's copy is issued behind this tile's
// products); the reflect halo at the image's side edges is filled from the
// staged row in shared memory, so no thread waits on a global load. The
// outputs go to a shared-memory tile (16-byte chunks XOR-swizzled by their
// 128-byte row, so the accumulators' 4-byte writes and the 16-byte reads
// hit 32 banks), read back as 16-byte chunks and written by consecutive
// threads to consecutive addresses with a streaming hint: a tile row
// segment is contiguous in NHWC. A pass is 32 or 16 output channels (4 or 2
// N tiles), or 8 at k1 (MyFusion's conv_in: a pixel's pass is one 16-byte
// chunk in bf16, so each pixel's chunk is its own global row of 16 bytes).
//
// conv_gray_exit: a tile is EX_TH output rows of EX_TW pixels. kw on N: P[x]
// [kw] = sum_kh sum_ci in[y + kh][x][ci] w[ci][kh][kw] is one MMA a kernel
// row (M = 16 staged pixels, K = 16 channels, N = 8 >= K taps), and out[x] =
// sum_kw P[x + kw][kw] is a shift-sum through shared memory. A pixel's 16
// bf16 channels are one 32-byte row of the staged tile, loaded by ldmatrix
// (the two 16-byte halves swapped every 4 pixels, so its 8 rows hit 32
// banks). Each warp owns a 16-pixel column of the staged tile and walks its
// rows once, each row feeding the K output rows it reaches, so a staged
// pixel is read from shared memory once. A stage of the ring is one tile's
// 16 channels (Cin > 16 takes several) with that k-step's packed weights
// (pack_gray_exit), copied by one thread a staged column half (its reflect
// computed once); the next stage's copy is issued behind this stage's
// products. A channel count that is not a multiple of 8 is copied element
// by element (zero-filled to the k-step). Over legs (each a multiple of 8
// channels) a staged half of a k-step (8 channels bf16, 4 f32) lies in one
// leg: each copying thread finds its leg, tensor and batch offset from the
// half's channel in the concat, so the legs are read in place and never
// concatenated. The shift-sum's P tile takes the
// slot of the tile's last stage once every warp has read it, so a ring of
// two 8-row stages leaves room for two blocks an SM at k5 (gray_variants.py
// times the first design, a ring of 3 with P apart and one block an SM,
// and other tile heights).
//
// The enter's two-leg mode stages both images' rows (plane 0 then plane 1
// in a slot) and runs the tap pairs of each plane against its own B
// fragments, [parity][leg][tap pair][N tile][lane][4]: NQ more k16 steps.
//
// f32 (the test CLI, batch 1): the same tiles, staging, ring, grid and
// stores; the products are f32 FMAs (TF32 or bf16 would miss the 1e-4
// budget). The exit's f32 stage is 8 channels (32 bytes a pixel, as bf16).
#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

// ---- shared by both kernels ----

// act as a template argument for the models' activations (relu, none); any
// other goes through the switch (ACT_ANY): a switch for every element of
// the enter's epilogue costs as much as its MMAs.
constexpr int ACT_ANY = -1;

template <int ACT>
__device__ __forceinline__ float gray_act(float v, int act) {
  if constexpr (ACT == ACT_ANY)
    return apply_act(v, act);
  else
    return apply_act_c<ACT>(v);
}

constexpr int EX_MAX_LEGS = 8;

struct GrayArgs {
  const void* x;     // enter: img1 (B, H, W, 1)
  const void* x2;    // enter: img2 or null
  const void* w;     // packed weights (ops/cuda/conv_chain.py gray_weights)
  const float* bias;
  void* y;
  int B;             // enter: images of img1; exit: output images
  int H, W;
  int C;             // enter: Cout; exit: Cin, the legs' channels summed
  int act;
  int tiles_x, tiles_y, n_tiles;
  // exit: leg l is (B_l, H, W, leg_c[l]) at leg[l], its first channel
  // leg_c0[l] in the concat, output image b reading its image b + leg_b[l]
  int n_legs;
  const void* leg[EX_MAX_LEGS];
  int leg_c0[EX_MAX_LEGS], leg_c[EX_MAX_LEGS], leg_b[EX_MAX_LEGS];
};

// tile -> (image, first row, first column), x fastest
__device__ __forceinline__ void gray_tile(const GrayArgs& a, int tile, int th, int tw, int& b,
                                          int& y0, int& x0) {
  const int per_img = a.tiles_x * a.tiles_y;
  b = tile / per_img;
  const int r = tile - b * per_img;
  y0 = (r / a.tiles_x) * th;
  x0 = (r % a.tiles_x) * tw;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// a streaming store: the enter's output (1.28 GB at the bench) passes
// through L2 once
__device__ __forceinline__ void st_global16(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// byte offset of a 16-byte chunk's bytes after the XOR swizzle by 128-byte row
__device__ __forceinline__ int swz(int off) { return off ^ ((off >> 3) & 0x70); }

// The persistent grid: as many blocks as fit on the SMs beside `smem`
// bytes of dynamic shared memory, rounded down (every block resident at
// once), at most one a tile. Sets the tiling of a. 0 or a cudaError_t.
// `cache` keeps the block count of the instance's last shared-memory size
// (the occupancy query costs more host time than the launch).
struct GridCache {
  size_t smem = 0;
  int blocks = 0;
  int dev = -1;
};

static int gray_grid(const void* kernel, GridCache& cache, int threads, size_t smem, int th,
                     int tw, int b_out, GrayArgs& a, int& grid) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (cache.smem != smem || cache.dev != dev) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    cache.smem = smem;
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

// ---------------------------------------------------------------------------
// conv_gray_enter: img1 (B, H, W, 1) [+ img2] -> (B or 2B, H, W, Cout)
// ---------------------------------------------------------------------------
constexpr int EN_TH = 4;                      // output rows a tile, a warp each
constexpr int EN_TW = 128;                    // pixels a tile row, 4 groups of 32
constexpr int EN_THREADS = 32 * EN_TH;
constexpr int EN_HALO = 8;                    // staged columns each side
constexpr int EN_SW = EN_TW + 2 * EN_HALO;    // staged columns a row

template <int K>
struct EnGeom {
  static_assert(K % 2 == 1 && K <= 7, "the taps and their shift fit 8 columns");
  // k7: QE 4 and QO 3 put the even pixels' taps at B rows 1-7 and the odd
  // ones' at 0-6 of a k16 step's two kernel rows, four steps a plane
  static constexpr int P = K / 2;
  static constexpr int QE = P + (P & 1);      // window offset of even pixels
  static constexpr int QO = P + 1 - (P & 1);  // of odd pixels
  static constexpr int NQ = (K + 1) / 2;      // kernel-row pairs (k16 steps)
  static constexpr int IN_H = EN_TH + K - 1;  // staged rows
};

// Bytes of the enter's shared memory: a ring of two staged tiles of LEGS
// image planes, the weights (bf16: B fragments [parity][LEGS][NQ][Cout / 8]
// [lane][4]; f32: [LEGS][K][K][Cout]) and the output tile of one pass of CG
// channels.
template <typename T, int K, int LEGS>
__host__ __device__ constexpr int en_in_bytes() {
  return 2 * LEGS * EnGeom<K>::IN_H * EN_SW * (int)sizeof(T);
}
template <typename T, int K, int LEGS>
__host__ __device__ inline int en_w_bytes(int cout) {
  return sizeof(T) == 2 ? 2 * LEGS * EnGeom<K>::NQ * (cout / 8) * 256 : LEGS * K * K * cout * 4;
}

// Stage one tile's image rows and halo, columns x0 - EN_HALO .. x0 + EN_TW
// + EN_HALO, rows reflected in the source address. When W is a multiple of
// 16 bytes every chunk lies inside the image or outside it: the inside ones
// are 16-byte cp.async, the outside ones (the reflect halo at the image's
// left and right edge) are filled from the staged row by en_halo once the
// copies have landed. Otherwise the whole tile is reflected element loads.
// LEGS == 1: image b of the pair's 2B (img1's, then img2's); LEGS == 2:
// image b of img1 (plane 0) and of img2 (plane 1), plane l's rows from
// staged row l * IN_H.
template <typename T, int K, int LEGS>
__device__ __forceinline__ void en_stage(const GrayArgs& a, int tile, T* dst, bool vec) {
  using G = EnGeom<K>;
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CPR = EN_SW / EPC;
  int b, y0, x0;
  gray_tile(a, tile, EN_TH, EN_TW, b, y0, x0);
  const size_t plane = (size_t)a.H * a.W;
  const T* img0 = LEGS == 2 || b < a.B ? static_cast<const T*>(a.x) + (size_t)b * plane
                                       : static_cast<const T*>(a.x2) + (size_t)(b - a.B) * plane;
  const T* img1 = LEGS == 2 ? static_cast<const T*>(a.x2) + (size_t)b * plane : img0;
  for (int i = threadIdx.x; i < LEGS * G::IN_H * CPR; i += EN_THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const int l = LEGS == 2 && r >= G::IN_H;
    const T* row =
        (l ? img1 : img0) + (size_t)reflect_index(y0 - G::P + r - l * G::IN_H, a.H) * a.W;
    const int xc = x0 - EN_HALO + c * EPC;
    T* d = dst + r * EN_SW + c * EPC;
    if (vec) {
      if (xc >= 0 && xc + EPC <= a.W) cp_async16(smem_u32(d), row + xc, 16);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = row[reflect_index(xc + e, a.W)];
    }
  }
}

// The staged columns outside the image (vec tiles at its left or right
// edge, and past W in a ragged tile) from the staged columns they mirror. A
// column past W + EN_HALO - 2 feeds no stored pixel (an A row is one pixel)
// and may mirror one outside the stage: it takes the nearest staged value.
template <typename T, int K, int LEGS>
__device__ __forceinline__ void en_halo(const GrayArgs& a, int x0, T* in) {
  using G = EnGeom<K>;
  for (int sc = threadIdx.x; sc < EN_SW; sc += EN_THREADS) {
    const int xc = x0 - EN_HALO + sc;
    if (xc < 0 || xc >= a.W) {
      const int src = min(max(reflect_index(xc, a.W) - x0 + EN_HALO, 0), EN_SW - 1);
#pragma unroll
      for (int r = 0; r < LEGS * G::IN_H; ++r) in[r * EN_SW + sc] = in[r * EN_SW + src];
    }
  }
}

// Two activations of one pixel, channels c and c + 1, stored as T (bf16:
// one rounding, relu folded into the conversion).
template <int ACT>
__device__ __forceinline__ void store_act(unsigned char* p, float v0, float v1, int act, float) {
  *reinterpret_cast<float2*>(p) = make_float2(gray_act<ACT>(v0, act), gray_act<ACT>(v1, act));
}
template <int ACT>
__device__ __forceinline__ void store_act(unsigned char* p, float v0, float v1, int act,
                                          __nv_bfloat16) {
  uint32_t r;
  if constexpr (ACT == ACT_RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(v1), "f"(v0));
  else
    r = pack_bf16(gray_act<ACT>(v0, act), gray_act<ACT>(v1, act));
  *reinterpret_cast<uint32_t*>(p) = r;
}

// Accumulator layout (both dtypes): acc[par][nt][0..1] = pixel 32 gp + 2 g +
// par of the warp's row, channels nt * 8 + 2 t, +1 of the pass; [2..3] =
// the pixel 16 on. The accumulators start at the bias.
template <int NTG>
__device__ __forceinline__ void en_acc_init(float (&acc)[2][NTG][4], const float (&bb)[NTG][2]) {
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[par][nt][e] = bb[nt][e & 1];
}

// True when a 32-pixel group of the output tile is a whole number of
// swizzle periods (1 KB): a pixel's channels of a pass take 32 bytes or
// more. The 8-channel bf16 pass (16 bytes a pixel) is half a period.
template <int NTG, typename T>
__host__ __device__ constexpr bool en_whole_periods() {
  return 32 * 8 * NTG * (int)sizeof(T) % 1024 == 0;
}

// so[par][hh]: the byte offset of the thread's first pair (group 0, N tile
// 0) in the output tile, swizzled when groups are whole periods (group gp
// then adds gp * 32 pixels to it), else swizzled at each store with the
// group's pixels added first. N tile nt flips bits below the swizzle key's:
// its offset is the pair's ^ (nt * 8 * sizeof(T)).
template <int NTG, typename T>
__device__ __forceinline__ void en_offsets(int (&so)[2][2], int row, int g, int t) {
  constexpr int PXB = 8 * NTG * (int)sizeof(T);
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int off = (row * EN_TW + 2 * g + par + 16 * hh) * PXB + 2 * t * (int)sizeof(T);
      so[par][hh] = en_whole_periods<NTG, T>() ? swz(off) : off;
    }
}

template <int NTG, int ACT, typename T>
__device__ __forceinline__ void en_epilogue(unsigned char* s_out, const int (&so)[2][2], int gp,
                                            const float (&acc)[2][NTG][4], int act) {
  constexpr int PXB = 8 * NTG * (int)sizeof(T);
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int nt = 0; nt < NTG; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = so[par][hh] + gp * 32 * PXB;
        store_act<ACT>(s_out + ((en_whole_periods<NTG, T>() ? off : swz(off)) ^
                                (nt * 8 * (int)sizeof(T))),
                       acc[par][nt][2 * hh], acc[par][nt][2 * hh + 1], act, T());
      }
}

template <int K, int LEGS, int NTG, int ACT>
__device__ __forceinline__ void en_compute(const __nv_bfloat16* in, const unsigned char* s_w,
                                           unsigned char* s_out, int cout, int pass,
                                           const float (&bb)[NTG][2],
                                           uint2 (&bq)[2][LEGS * EnGeom<K>::NQ][NTG], bool load_b,
                                           int act) {
  using G = EnGeom<K>;
  constexpr int NQL = LEGS * G::NQ;  // k16 steps over the planes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (load_b) {
    const uint2* wb = reinterpret_cast<const uint2*>(s_w);
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int q = 0; q < NQL; ++q)
#pragma unroll
        for (int nt = 0; nt < NTG; ++nt)
          bq[par][q][nt] = wb[((par * NQL + q) * (cout / 8) + pass * NTG + nt) * 32 + lane];
  }
  const uint32_t* rows = reinterpret_cast<const uint32_t*>(in) + warp * (EN_SW / 2);
  int so[2][2];
  en_offsets<NTG, __nv_bfloat16>(so, warp, g, t);
#pragma unroll 1
  for (int gp = 0; gp < EN_TW / 32; ++gp) {
    float acc[2][NTG][4];
    en_acc_init(acc, bb);
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      // word of the pair (pixel 2 g + par, taps 2 t, 2 t + 1) in a staged row
      const int wo = (par ? (EN_HALO + 1 - G::QO) / 2 : (EN_HALO - G::QE) / 2) + 16 * gp + g + t;
#pragma unroll
      for (int lq = 0; lq < NQL; ++lq) {
        const int l = lq / G::NQ, q = lq - l * G::NQ;  // plane, tap pair
        const uint32_t* r0 = rows + (l * G::IN_H + 2 * q) * (EN_SW / 2);
        uint32_t av[4];
        av[0] = r0[wo];
        av[1] = r0[wo + 8];
        if (2 * q + 1 < K) {
          av[2] = r0[EN_SW / 2 + wo];
          av[3] = r0[EN_SW / 2 + wo + 8];
        } else {
          av[2] = av[3] = 0u;
        }
#pragma unroll
        for (int nt = 0; nt < NTG; ++nt) {
          uint32_t b[2] = {bq[par][lq][nt].x, bq[par][lq][nt].y};
          mma_bf16(acc[par][nt], av, b[0], b[1]);
        }
      }
    }
    en_epilogue<NTG, ACT, __nv_bfloat16>(s_out, so, gp, acc, act);
  }
}

// f32: the same pixels and channels a thread as the bf16 accumulators, by
// FMAs; ws is [LEGS][K][K][Cout] f32.
template <int K, int LEGS, int NTG, int ACT>
__device__ __forceinline__ void en_compute(const float* in, const unsigned char* s_w,
                                           unsigned char* s_out, int cout, int pass,
                                           const float (&bb)[NTG][2],
                                           uint2 (&)[2][LEGS * EnGeom<K>::NQ][NTG], bool, int act) {
  using G = EnGeom<K>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ws = reinterpret_cast<const float*>(s_w) + pass * 8 * NTG + 2 * t;
  int so[2][2];
  en_offsets<NTG, float>(so, warp, g, t);
#pragma unroll 1
  for (int gp = 0; gp < EN_TW / 32; ++gp) {
    float acc[2][NTG][4];
    en_acc_init(acc, bb);
#pragma unroll
    for (int lk = 0; lk < LEGS * K; ++lk) {
      const int l = lk / K, kh = lk - l * K;  // plane, kernel row
      // staged column of pixel 32 gp + 2 g is EN_HALO + 32 gp + 2 g
      const float* r = in + (l * G::IN_H + warp + kh) * EN_SW + EN_HALO + 32 * gp + 2 * g - G::P;
      float v[K + 1], u[K + 1];
#pragma unroll
      for (int j = 0; j <= K; ++j) {
        v[j] = r[j];
        u[j] = r[16 + j];
      }
#pragma unroll
      for (int kw = 0; kw < K; ++kw)
#pragma unroll
        for (int nt = 0; nt < NTG; ++nt) {
          const float2 wv = *reinterpret_cast<const float2*>(ws + (lk * K + kw) * cout + nt * 8);
          acc[0][nt][0] = fmaf(v[kw], wv.x, acc[0][nt][0]);
          acc[0][nt][1] = fmaf(v[kw], wv.y, acc[0][nt][1]);
          acc[1][nt][0] = fmaf(v[kw + 1], wv.x, acc[1][nt][0]);
          acc[1][nt][1] = fmaf(v[kw + 1], wv.y, acc[1][nt][1]);
          acc[0][nt][2] = fmaf(u[kw], wv.x, acc[0][nt][2]);
          acc[0][nt][3] = fmaf(u[kw], wv.y, acc[0][nt][3]);
          acc[1][nt][2] = fmaf(u[kw + 1], wv.x, acc[1][nt][2]);
          acc[1][nt][3] = fmaf(u[kw + 1], wv.y, acc[1][nt][3]);
        }
    }
    en_epilogue<NTG, ACT, float>(s_out, so, gp, acc, act);
  }
}

// The output tile of one pass to global memory: 16-byte chunks, consecutive
// threads on consecutive addresses of a row segment.
template <typename T, int NTG>
__device__ __forceinline__ void en_store(const GrayArgs& a, const unsigned char* s_out, int b,
                                         int y0, int x0, int pass) {
  constexpr int PXB = 8 * NTG * (int)sizeof(T);
  constexpr int NCH = EN_TH * EN_TW * PXB / 16;
  unsigned char* y = static_cast<unsigned char*>(a.y);
  for (int i = threadIdx.x; i < NCH; i += EN_THREADS) {
    const int off = 16 * i;
    const int pix = off / PXB, row = pix / EN_TW, px = pix - row * EN_TW;
    const int gy = y0 + row, gx = x0 + px;
    if (gy < a.H && gx < a.W) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_out + swz(off));
      st_global16(y + ((((size_t)b * a.H + gy) * a.W + gx) * a.C + pass * 8 * NTG) * sizeof(T) +
                      (off - pix * PXB),
                  v);
    }
  }
}

template <typename T, int K, int LEGS, int NTG, int ACT>
__global__ void __launch_bounds__(EN_THREADS)
gray_enter_kernel(const __grid_constant__ GrayArgs a) {
  using G = EnGeom<K>;
  constexpr int SLOT = LEGS * G::IN_H * EN_SW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);
  unsigned char* s_w = smem + en_in_bytes<T, K, LEGS>();
  const int wbytes = en_w_bytes<T, K, LEGS>(a.C);
  unsigned char* s_out = s_w + (wbytes + 127) / 128 * 128;
  const bool vec = a.W % (16 / (int)sizeof(T)) == 0;
  const int passes = a.C / (8 * NTG);

  for (int i = threadIdx.x; i < wbytes / 16; i += EN_THREADS)
    reinterpret_cast<uint4*>(s_w)[i] = __ldg(static_cast<const uint4*>(a.w) + i);
  float bb[NTG][2];
  uint2 bq[2][LEGS * G::NQ][NTG];
  int tile = blockIdx.x;
  if (tile < a.n_tiles) en_stage<T, K, LEGS>(a, tile, s_in, vec);
  cp_async_commit();
  for (int it = 0; tile < a.n_tiles; ++it, tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // this tile staged; the output tile read back
    int b, y0, x0;
    gray_tile(a, tile, EN_TH, EN_TW, b, y0, x0);
    if (vec && (x0 < EN_HALO || x0 + EN_TW + EN_HALO > a.W)) {
      en_halo<T, K, LEGS>(a, x0, s_in + (it & 1) * SLOT);
      __syncthreads();
    }
    for (int pass = 0; pass < passes; ++pass) {
      const bool load = it == 0 || passes > 1;
      if (load) {
        const int c0 = pass * 8 * NTG + 2 * (threadIdx.x & 3);
#pragma unroll
        for (int nt = 0; nt < NTG; ++nt) {
          bb[nt][0] = a.bias ? a.bias[c0 + 8 * nt] : 0.f;
          bb[nt][1] = a.bias ? a.bias[c0 + 8 * nt + 1] : 0.f;
        }
      }
      if (pass) __syncthreads();  // the last pass's output tile read back
      en_compute<K, LEGS, NTG, ACT>(s_in + (it & 1) * SLOT, s_w, s_out, a.C, pass, bb, bq, load,
                                    a.act);
      if (pass == 0) {  // the next tile's copy, behind this tile's products
        const int next = tile + gridDim.x;
        if (next < a.n_tiles) en_stage<T, K, LEGS>(a, next, s_in + ((it + 1) & 1) * SLOT, vec);
        cp_async_commit();
      }
      __syncthreads();
      en_store<T, NTG>(a, s_out, b, y0, x0, pass);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int K, int LEGS, int NTG, int ACT>
static int launch_enter(GrayArgs a, int b_out, cudaStream_t s) {
  const auto kernel = gray_enter_kernel<T, K, LEGS, NTG, ACT>;
  const size_t smem = en_in_bytes<T, K, LEGS>() + (en_w_bytes<T, K, LEGS>(a.C) + 127) / 128 * 128 +
                      (size_t)EN_TH * EN_TW * 8 * NTG * sizeof(T);
  static GridCache cache;
  int grid = 0;
  const int e =
      gray_grid((const void*)kernel, cache, EN_THREADS, smem, EN_TH, EN_TW, b_out, a, grid);
  if (e) return e;
  if (grid > 0) gray_enter_kernel<T, K, LEGS, NTG, ACT><<<grid, EN_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The models' entry convs, one gray leg: k1 (NestFuse, RFNNest, MAFusion:
// one tap, at row 0 of the even pixels' B and row 1 of the odd ones', the
// second kernel row of the k16 step zero; MyFusion's conv_in, 8 channels),
// k3 (DenseFuse, VIFNet, Res2Fusion, DBNet, UNFusion, PFNet, DIFNet), k5
// (DeepFuse) and k7 (IFCNN's enc0: four k16 steps, the last one's second
// kernel row zero); two gray legs: k5 (PMGI's gradient0 and intensity0).
// Cout a multiple of 16, in passes of 32 channels where Cout is a multiple
// of 32, else 16; at k1 on one leg also 8 mod 16, in passes of 8 (one N
// tile: a pixel's 8 bf16 channels are one 16-byte row of the output tile),
// with MyFusion's relu6 compiled in.
template <typename T, int K, int LEGS, int NTG>
static int enter_by_act(GrayArgs a, int b_out, cudaStream_t s) {
  switch (a.act) {
    case ACT_NONE: return launch_enter<T, K, LEGS, NTG, ACT_NONE>(a, b_out, s);
    case ACT_RELU: return launch_enter<T, K, LEGS, NTG, ACT_RELU>(a, b_out, s);
    case ACT_RELU6:
      if constexpr (NTG == 1) return launch_enter<T, K, LEGS, NTG, ACT_RELU6>(a, b_out, s);
      [[fallthrough]];
    default: return launch_enter<T, K, LEGS, NTG, ACT_ANY>(a, b_out, s);
  }
}

template <typename T, int K, int LEGS>
static int enter_by_n(GrayArgs a, int b_out, cudaStream_t s) {
  if (a.C % 32 == 0) return enter_by_act<T, K, LEGS, 4>(a, b_out, s);
  if (a.C % 16 == 0) return enter_by_act<T, K, LEGS, 2>(a, b_out, s);
  if constexpr (K == 1 && LEGS == 1) return enter_by_act<T, K, LEGS, 1>(a, b_out, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int enter_by_k(int k, int legs, GrayArgs a, int b_out, cudaStream_t s) {
  if (a.C % 8 || (a.C % 16 && (k != 1 || legs != 1))) return (int)cudaErrorInvalidValue;
  if (legs == 2) return k == 5 ? enter_by_n<T, 5, 2>(a, b_out, s) : (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return enter_by_n<T, 1, 1>(a, b_out, s);
    case 3: return enter_by_n<T, 3, 1>(a, b_out, s);
    case 5: return enter_by_n<T, 5, 1>(a, b_out, s);
    case 7: return enter_by_n<T, 7, 1>(a, b_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// conv_gray_exit: (B, H, W, Cin) -> (B, H, W, 1)
// ---------------------------------------------------------------------------
constexpr int EX_TH = 8;      // output rows a tile
constexpr int EX_TW = 128;    // output pixels a tile row
constexpr int EX_RING = 2;    // stages: two blocks an SM at k5

template <int K>
struct ExGeom {
  static constexpr int P = K / 2;
  static constexpr int SC = EX_TW + K - 1;    // staged columns that feed outputs
  static constexpr int NW = (SC + 15) / 16;   // warps: a 16-column m-tile each
  static constexpr int SCP = 16 * NW;         // staged columns in shared memory
  static constexpr int THREADS = 32 * NW;
  static constexpr int IN_H = EX_TH + K - 1;
  static constexpr int PP = SCP + 4;          // P row pitch (4 mod 16 floats: no conflicts)
  static constexpr int IN_BYTES = IN_H * SCP * 32;
};

// A stage's packed weights: bf16 B fragments [K][lane][4] of one 16-channel
// k-step; f32 [K][K][8] of one 8-channel step.
template <typename T, int K>
__host__ __device__ constexpr int ex_w_bytes() {
  return sizeof(T) == 2 ? K * 256 : K * K * 32;
}
template <typename T, int K>
__host__ __device__ constexpr int ex_slot_bytes() {
  return ExGeom<K>::IN_BYTES + ex_w_bytes<T, K>();
}
// The shift-sum's P tile [EX_TH][K][PP] f32 lives in the ring slot of the
// tile's last stage once its products are issued and every warp has read
// it (the slot's next copy comes a stage later).
template <typename T, int K>
__host__ __device__ constexpr int ex_smem_bytes() {
  static_assert(EX_TH * K * ExGeom<K>::PP * 4 <= ex_slot_bytes<T, K>(), "P fits a slot");
  return EX_RING * ex_slot_bytes<T, K>();
}

// Stage k-step ks of a tile: its rows and halo as [row][pixel][32 bytes],
// the two 16-byte halves of a pixel swapped when bit 2 of its column is
// set; then the k-step's weights. Thread 2c + h copies half h of staged
// column c in every row (the column's reflect computed once) from the leg
// that holds the half's channels: 16-byte cp.async from the reflected
// pixel when a channel row is 16-byte aligned (zero-filled past Cin), else
// element loads (one leg).
template <typename T, int K>
__device__ __forceinline__ void ex_stage(const GrayArgs& a, int tile, int ks, unsigned char* slot,
                                         bool vec) {
  using G = ExGeom<K>;
  constexpr int EPC = 16 / (int)sizeof(T);
  static_assert(2 * G::SC <= G::THREADS, "a thread a staged column half");
  int b, y0, x0;
  gray_tile(a, tile, EX_TH, EX_TW, b, y0, x0);
  const uint32_t s = smem_u32(slot);
  if (threadIdx.x < 2 * G::SC) {
    const int h = threadIdx.x & 1, c = threadIdx.x >> 1;
    const int ch = ks * 2 * EPC + h * EPC;  // the half's channel in the concat
    int l = 0;
#pragma unroll 1
    while (l + 1 < a.n_legs && ch >= a.leg_c0[l + 1]) ++l;
    const int lc = a.leg_c[l];
    const T* xb = static_cast<const T*>(a.leg[l]) + (size_t)(b + a.leg_b[l]) * a.H * a.W * lc;
    const size_t rs = (size_t)a.W * lc;
    const T* col = xb + (size_t)reflect_index(x0 - G::P + c, a.W) * lc + (ch - a.leg_c0[l]);
    const uint32_t dst = s + c * 32 + ((h ^ ((c >> 2) & 1)) << 4);
    const bool live = ch < a.C;
    if (vec && y0 - G::P >= 0 && y0 - G::P + G::IN_H <= a.H) {
      const T* p = col + (size_t)(y0 - G::P) * rs;
#pragma unroll
      for (int r = 0; r < G::IN_H; ++r)
        cp_async16(dst + r * G::SCP * 32, live ? p + r * rs : xb, live ? 16 : 0);
    } else {
#pragma unroll
      for (int r = 0; r < G::IN_H; ++r) {
        const T* src = col + (size_t)reflect_index(y0 - G::P + r, a.H) * rs;
        const uint32_t d = dst + r * G::SCP * 32;
        if (vec) {
          cp_async16(d, live ? src : xb, live ? 16 : 0);
        } else {
          alignas(16) T v[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e) v[e] = ch + e < lc ? src[e] : from_f32<T>(0.f);
          const uint4 u = *reinterpret_cast<const uint4*>(v);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d), "r"(u.x), "r"(u.y),
                       "r"(u.z), "r"(u.w)
                       : "memory");
        }
      }
    }
  }
  constexpr int WB = ex_w_bytes<T, K>();
  const unsigned char* w = static_cast<const unsigned char*>(a.w) + (size_t)ks * WB;
  for (int i = threadIdx.x; i < WB / 16; i += G::THREADS)
    cp_async16(s + G::IN_BYTES + 16 * i, w + 16 * i, 16);
}

// bf16: warp w's m-tile (staged columns 16 w ..) over the stage's rows;
// acc[o] = P of output row o, [0..1] column 16 w + g, kw 2 t, +1; [2..3]
// column + 8.
template <int K>
__device__ __forceinline__ void ex_compute(const unsigned char* slot, float (&acc)[EX_TH][4],
                                           __nv_bfloat16) {
  using G = ExGeom<K>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint2* wq = reinterpret_cast<const uint2*>(slot + G::IN_BYTES);
  uint32_t b[K][2];
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
    const uint2 v = wq[kh * 32 + lane];
    b[kh][0] = v.x;
    b[kh][1] = v.y;
  }
  // ldmatrix x4: lanes 0-7 pixels 0-7 channels 0-7, 8-15 pixels 8-15, 16-23
  // pixels 0-7 channels 8-15, 24-31 pixels 8-15 channels 8-15
  const int px = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t base = smem_u32(slot) + px * 32 + (((lane >> 4) ^ ((px >> 2) & 1)) << 4);
#pragma unroll
  for (int r = 0; r < G::IN_H; ++r) {
    uint32_t av[4];
    ldmatrix_x4(av, base + r * G::SCP * 32);
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const int o = r - kh;
      if (o >= 0 && o < EX_TH) mma_bf16(acc[o], av, b[kh][0], b[kh][1]);
    }
  }
}

template <int K>
__device__ __forceinline__ void ex_write_p(float* s_p, const float (&acc)[EX_TH][4],
                                           __nv_bfloat16) {
  using G = ExGeom<K>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int o = 0; o < EX_TH; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kw = 2 * t + (e & 1);
      if (kw < K) s_p[(o * K + kw) * G::PP + 16 * warp + g + 8 * (e >> 1)] = acc[o][e];
    }
}

// f32: thread (column c, half hf) computes output rows hf * EX_TH / 2 .. of
// column c by FMAs over the stage's 8 channels; acc[o][kw].
template <int K>
__device__ __forceinline__ void ex_compute(const unsigned char* slot,
                                           float (&acc)[EX_TH / 2][K], float) {
  using G = ExGeom<K>;
  constexpr int TH2 = EX_TH / 2, RR = TH2 + K - 1;
  const int c = threadIdx.x % G::SCP, hf = threadIdx.x / G::SCP;
  const int sw = (c >> 2) & 1;
  float x[RR][8];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const float4* p =
        reinterpret_cast<const float4*>(slot + ((hf * TH2 + rr) * G::SCP + c) * 32);
    const float4 lo = p[sw], hi = p[sw ^ 1];
    x[rr][0] = lo.x; x[rr][1] = lo.y; x[rr][2] = lo.z; x[rr][3] = lo.w;
    x[rr][4] = hi.x; x[rr][5] = hi.y; x[rr][6] = hi.z; x[rr][7] = hi.w;
  }
  const float4* wv = reinterpret_cast<const float4*>(slot + G::IN_BYTES);
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K; ++kw) {
      const float4 w0 = wv[(kh * K + kw) * 2], w1 = wv[(kh * K + kw) * 2 + 1];
#pragma unroll
      for (int o = 0; o < TH2; ++o) {
        const float* v = x[o + kh];
        float s = acc[o][kw];
        s = fmaf(v[0], w0.x, s); s = fmaf(v[1], w0.y, s);
        s = fmaf(v[2], w0.z, s); s = fmaf(v[3], w0.w, s);
        s = fmaf(v[4], w1.x, s); s = fmaf(v[5], w1.y, s);
        s = fmaf(v[6], w1.z, s); s = fmaf(v[7], w1.w, s);
        acc[o][kw] = s;
      }
    }
}

template <int K>
__device__ __forceinline__ void ex_write_p(float* s_p, const float (&acc)[EX_TH / 2][K], float) {
  using G = ExGeom<K>;
  const int c = threadIdx.x % G::SCP, hf = threadIdx.x / G::SCP;
#pragma unroll
  for (int o = 0; o < EX_TH / 2; ++o)
#pragma unroll
    for (int kw = 0; kw < K; ++kw)
      s_p[((hf * EX_TH / 2 + o) * K + kw) * G::PP + c] = acc[o][kw];
}

// out[x] = act(bias + sum_kw P[x + kw][kw]); consecutive threads on
// consecutive pixels of a row.
template <typename T, int K, int ACT>
__device__ __forceinline__ void ex_store(const GrayArgs& a, const float* s_p, int b, int y0,
                                         int x0) {
  using G = ExGeom<K>;
  const float bv = a.bias ? a.bias[0] : 0.f;
  T* y = static_cast<T*>(a.y);
  for (int i = threadIdx.x; i < EX_TH * EX_TW; i += G::THREADS) {
    const int o = i / EX_TW, px = i - o * EX_TW;
    const int gy = y0 + o, gx = x0 + px;
    if (gy < a.H && gx < a.W) {
      float v = bv;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) v += s_p[(o * K + kw) * G::PP + px + kw];
      y[((size_t)b * a.H + gy) * a.W + gx] = from_f32<T>(gray_act<ACT>(v, a.act));
    }
  }
}

template <typename T, int K>
struct ExAcc;
template <int K>
struct ExAcc<__nv_bfloat16, K> {
  float v[EX_TH][4];
};
template <int K>
struct ExAcc<float, K> {
  float v[EX_TH / 2][K];
};

template <typename T, int K, int ACT>
__global__ void __launch_bounds__(ExGeom<K>::THREADS)
gray_exit_kernel(const __grid_constant__ GrayArgs a) {
  constexpr int SLOT = ex_slot_bytes<T, K>();
  constexpr int CPS = 32 / (int)sizeof(T);  // channels a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int KS = (a.C + CPS - 1) / CPS;
  const bool vec = (a.C * (int)sizeof(T)) % 16 == 0;

  // stage s of this block: tile blockIdx.x + (s / KS) * gridDim.x, k-step s % KS
  auto issue = [&](int s) {
    const int tile = blockIdx.x + (s / KS) * gridDim.x;
    if (tile < a.n_tiles) ex_stage<T, K>(a, tile, s % KS, smem + (s % EX_RING) * SLOT, vec);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < EX_RING - 1; ++s) issue(s);
  ExAcc<T, K> acc;
  for (int s = 0;; ++s) {
    const int tile = blockIdx.x + (s / KS) * gridDim.x;
    if (tile >= a.n_tiles) break;
    const int ks = s % KS;
    cp_async_wait<EX_RING - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slot (and P) read
    if (ks == 0) {
      float* v = &acc.v[0][0];
#pragma unroll
      for (int i = 0; i < (int)(sizeof(acc.v) / sizeof(float)); ++i) v[i] = 0.f;
    }
    ex_compute<K>(smem + (s % EX_RING) * SLOT, acc.v, T());
    issue(s + EX_RING - 1);  // behind this stage's products
    if (ks == KS - 1) {
      float* s_p = reinterpret_cast<float*>(smem + (s % EX_RING) * SLOT);
      __syncthreads();  // every warp has read the slot
      ex_write_p<K>(s_p, acc.v, T());
      __syncthreads();
      int b, y0, x0;
      gray_tile(a, tile, EX_TH, EX_TW, b, y0, x0);
      ex_store<T, K, ACT>(a, s_p, b, y0, x0);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int K, int ACT>
static int launch_exit(GrayArgs a, cudaStream_t s) {
  const auto kernel = gray_exit_kernel<T, K, ACT>;
  constexpr size_t smem = ex_smem_bytes<T, K>();
  static GridCache cache;
  int grid = 0;
  const int e = gray_grid((const void*)kernel, cache, ExGeom<K>::THREADS, smem, EX_TH, EX_TW,
                          a.B, a, grid);
  if (e) return e;
  if (grid > 0) gray_exit_kernel<T, K, ACT><<<grid, ExGeom<K>::THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int exit_by_act(GrayArgs a, cudaStream_t s) {
  switch (a.act) {
    case ACT_NONE: return launch_exit<T, K, ACT_NONE>(a, s);
    case ACT_RELU: return launch_exit<T, K, ACT_RELU>(a, s);
    default: return launch_exit<T, K, ACT_ANY>(a, s);
  }
}

// The models' exit convs: k1 (UNFusion's, NestFuse's, RFNNest's and
// MAFusion's conv_out, IFCNN's dec1; PMGI's decode over 8 legs, tanh
// through the activation switch), k3 (DenseFuse, VIFNet, Res2Fusion and
// DBNet dec3, DIFNet, PFNet) and k5 (DeepFuse dec2); any Cin on one leg,
// legs of a multiple of 8 channels.
template <typename T>
static int exit_by_k(int k, const GrayArgs& a, cudaStream_t s) {
  switch (k) {
    case 1: return exit_by_act<T, 1>(a, s);
    case 3: return exit_by_act<T, 3>(a, s);
    case 5: return exit_by_act<T, 5>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The enter in either mode (legs 1: a pair as batch halves; 2: two gray
// legs), its arguments as the C entries below take them.
static int gray_enter(int legs, int dtype, const void* img1, const void* img2, const void* w,
                      const float* bias, void* y, int b, int h, int wd, int cout, int k, int act,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h <= k / 2 || wd <= k / 2 || (legs == 2 && !img2))
    return (int)cudaErrorInvalidValue;
  GrayArgs a = {};
  a.x = img1;
  a.x2 = img2;
  a.w = w;
  a.bias = bias;
  a.y = y;
  a.B = b;
  a.H = h;
  a.W = wd;
  a.C = cout;
  a.act = act;
  const int b_out = legs == 1 && img2 ? 2 * b : b;
  if (dtype == DT_F32) return enter_by_k<float>(k, legs, a, b_out, s);
  if (dtype == DT_BF16) return enter_by_k<__nv_bfloat16>(k, legs, a, b_out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// img1, img2 (b, h, w, 1) in dtype (img2 may be null); w packed by
// ops/cuda/conv_chain.py gray_weights (bf16: pack_gray_enter; f32:
// [k][k][cout] f32); bias f32 or null; y (b or 2b, h, w, cout) in dtype.
int mmif_conv_gray_enter(int dtype, const void* img1, const void* img2, const void* w,
                         const float* bias, void* y, int b, int h, int wd, int cout, int k,
                         int act, void* stream) {
  return gray_enter(1, dtype, img1, img2, w, bias, y, b, h, wd, cout, k, act, stream);
}

// Two gray legs: img1 and img2 (b, h, w, 1) the two input channels of one
// conv; w packed for a (cout, 2, k, k) weight (bf16 [parity][leg][...], f32
// [2][k][k][cout]); y (b, h, w, cout).
int mmif_conv_gray_enter_legs(int dtype, const void* img1, const void* img2, const void* w,
                              const float* bias, void* y, int b, int h, int wd, int cout, int k,
                              int act, void* stream) {
  return gray_enter(2, dtype, img1, img2, w, bias, y, b, h, wd, cout, k, act, stream);
}

// n_legs legs xs[l] (b_l, h, w, cins[l]) in dtype, output image i reading
// image i + boffs[l] of leg l; w packed by gray_weights for the legs'
// concat (bf16: pack_gray_exit; f32: [ceil(cin / 8)][k][k][8] f32); bias
// f32 or null; y (b_out, h, w, 1). More than one leg: each a multiple of 8
// channels.
int mmif_conv_gray_exit_legs(int dtype, int n_legs, const void* const* xs, const int* cins,
                             const int* boffs, const void* w, const float* bias, void* y,
                             int b_out, int h, int wd, int k, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_legs < 1 || n_legs > EX_MAX_LEGS || b_out < 1 || h <= k / 2 || wd <= k / 2)
    return (int)cudaErrorInvalidValue;
  GrayArgs a = {};
  a.w = w;
  a.bias = bias;
  a.y = y;
  a.B = b_out;
  a.H = h;
  a.W = wd;
  a.act = act;
  a.n_legs = n_legs;
  for (int l = 0; l < n_legs; ++l) {
    if (cins[l] < 1 || boffs[l] < 0 || (n_legs > 1 && cins[l] % 8))
      return (int)cudaErrorInvalidValue;
    a.leg[l] = xs[l];
    a.leg_c0[l] = a.C;
    a.leg_c[l] = cins[l];
    a.leg_b[l] = boffs[l];
    a.C += cins[l];
  }
  if (dtype == DT_F32) return exit_by_k<float>(k, a, s);
  if (dtype == DT_BF16) return exit_by_k<__nv_bfloat16>(k, a, s);
  return (int)cudaErrorInvalidValue;
}

// x (b, h, w, cin) in dtype: the exit over one leg.
int mmif_conv_gray_exit(int dtype, const void* x, const void* w, const float* bias, void* y,
                        int b, int h, int wd, int cin, int k, int act, void* stream) {
  const int boff = 0;
  return mmif_conv_gray_exit_legs(dtype, 1, &x, &cin, &boff, w, bias, y, b, h, wd, k, act,
                                  stream);
}

}  // extern "C"
