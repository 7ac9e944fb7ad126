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
// What bounds them on an H100: arithmetic. The enter pair does 50,976 FLOP
// a pixel, the exit pair 26,400, against 6-68 bytes of traffic a pixel. In
// bf16 the wide conv of each pair runs on the tensor cores with warp-level
// mma.sync m16n8k16 (bf16 products, f32 sums): enc1 with the mid tile as A
// (16 channels a pixel: each tap is one k-step), dec1 with the staged input
// as A (two 16-channel stages) and the 16 mid channels as N. The thin convs
// (enc0's 1 input channel, dec2's 1 output channel) are f32 FMAs. In f32
// every conv is f32 FMAs, never TF32. The price of the fusion is the halo
// recompute: conv_a runs on (TH + 2pb)(TW + 2pb) positions for TH x TW
// outputs, 1.33x of dec1 at the 16 x 64 bf16 tile (1.50x at the 8 x 64 f32
// tile), and the mid tile (74 KB for enc0's 22 x 70 x 16 in bf16) needs
// dynamic shared memory. One block of 8 warps a 16 x 64 (bf16) or 8 x 64
// (f32) output tile; no pipelining, wgmma or TMA yet.
#include <type_traits>

#include "common.cuh"

namespace mmif {

constexpr int PR_THREADS = 256;  // 8 warps

constexpr int pr_up4(int n) { return (n + 3) / 4 * 4; }  // 16-byte aligned regions

template <typename T, int KA, int KB, int CIN, int CMID, int COUT>
struct PairCfg {
  static_assert(CMID == 16, "the mid is one 16-channel mma k-step");
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int TH = BF ? 16 : 8, TW = 64;  // output tile
  static constexpr int PA = KA / 2, PB = KB / 2;
  static constexpr int MH = TH + 2 * PB, MW = TW + 2 * PB, M = MH * MW;  // mid tile
  static constexpr int IH = MH + 2 * PA, IW = MW + 2 * PA;             // input tile
  static constexpr int CC = CIN < 16 ? CIN : 16;  // input channels a stage
  static constexpr int NCH = CIN / CC;
  static_assert(CIN == CC * NCH, "CIN is 1 or a multiple of 16");
  static constexpr bool A_MMA = BF && CC == 16;      // conv_a on the tensor cores
  static constexpr bool B_MMA = BF && COUT % 8 == 0;  // conv_b on the tensor cores
  // 32-bit words a staged pixel: bf16 16 channels in 8 words padded to 12
  // (conflict-free fragment and 16-byte loads); f32 an odd pitch
  static constexpr int SI = CC == 1 ? 1 : (BF ? 12 : CC + 1);
  static constexpr int SM = BF ? 12 : CMID + 1;
  static constexpr int IN_WORDS = pr_up4(IH * IW * SI);
  static constexpr int WA_WORDS = pr_up4(A_MMA ? KA * KA * CMID * 12 : KA * KA * CC * CMID);
  static constexpr int MID_WORDS = pr_up4(M * SM);
  static constexpr int WB_WORDS = pr_up4(B_MMA ? KB * KB * COUT * 12 : KB * KB * CMID * COUT);
  static constexpr size_t BYTES = (size_t)(IN_WORDS + WA_WORDS + MID_WORDS + WB_WORDS) * 4;
};

namespace {

// x1 (and x2 for a gray pair): the input images. CIN == 1: the gray pair
// (nsrc images each, f32 or bf16 by in_bf16), output image b < nsrc reads
// x1[b], else x2[b - nsrc]. CIN > 1: x1 (nsrc, H, W, CIN) in T.
// wa: A_MMA bf16 [KA*KA][CMID][CIN], else f32 [KA*KA][CIN][CMID];
// wb: B_MMA bf16 [KB*KB][COUT][CMID], else f32 [KB*KB][CMID][COUT].
template <typename T, int KA, int KB, int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(PR_THREADS, 1)
conv_pair_kernel(const void* __restrict__ x1, const void* __restrict__ x2, int in_bf16,
                 const void* __restrict__ wa, const float* __restrict__ ba, int act_a,
                 const void* __restrict__ wb, const float* __restrict__ bb, int act_b,
                 T* __restrict__ y, int nsrc, int H, int W) {
  using C = PairCfg<T, KA, KB, CIN, CMID, COUT>;
  constexpr int TH = C::TH, TW = C::TW, PA = C::PA, PB = C::PB;
  constexpr int MH = C::MH, MW = C::MW, M = C::M, IH = C::IH, IW = C::IW;
  constexpr int CC = C::CC, SI = C::SI, SM = C::SM;
  extern __shared__ uint4 pr_smem[];
  uint32_t* s_in = reinterpret_cast<uint32_t*>(pr_smem);
  uint32_t* s_wa = s_in + C::IN_WORDS;
  uint32_t* s_mid = s_wa + C::WA_WORDS;
  uint32_t* s_wb = s_mid + C::MID_WORDS;
  float* s_in_f = reinterpret_cast<float*>(s_in);
  float* s_wa_f = reinterpret_cast<float*>(s_wa);
  float* s_mid_f = reinterpret_cast<float*>(s_mid);
  float* s_wb_f = reinterpret_cast<float*>(s_wb);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int my0 = y0 - PB, mx0 = x0 - PB;  // the mid tile's origin in the image

  // conv_b's weights, once
  if constexpr (C::B_MMA) {
    const uint4* src = static_cast<const uint4*>(wb);  // rows of 16 bf16
    for (int idx = tid; idx < KB * KB * COUT * 2; idx += PR_THREADS)
      *reinterpret_cast<uint4*>(s_wb + (idx >> 1) * 12 + 4 * (idx & 1)) = src[idx];
  } else {
    const float* src = static_cast<const float*>(wb);
    for (int idx = tid; idx < KB * KB * CMID * COUT; idx += PR_THREADS) s_wb_f[idx] = src[idx];
  }

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
        const float v = in_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(src)[off])
                                : static_cast<const float*>(src)[off];
        s_in_f[pix] = to_f32(from_f32<T>(v));  // the cast to the chain dtype
      }
    } else {
      const T* xb = static_cast<const T*>(x1) + (size_t)b * H * W * CIN + ch * CC;
      for (int idx = tid; idx < IH * IW * 2; idx += PR_THREADS) {
        const int half = idx & 1, pix = idx >> 1;
        const int r = pix / IW, c = pix - r * IW;
        const T* p = xb + ((size_t)reflect_index(my0 - PA + r, H) * W +
                           reflect_index(mx0 - PA + c, W)) * CIN + 8 * half;
        if constexpr (C::BF) {
          *reinterpret_cast<uint4*>(s_in + pix * SI + 4 * half) =
              *reinterpret_cast<const uint4*>(p);
        } else {
          float v[8];
          load8(p, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) s_in_f[pix * SI + 8 * half + j] = v[j];
        }
      }
    }
    if constexpr (C::A_MMA) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(wa);
      for (int idx = tid; idx < KA * KA * CMID * 2; idx += PR_THREADS) {
        const int half = idx & 1, row = idx >> 1;  // row = tap * CMID + co
        *reinterpret_cast<uint4*>(s_wa + row * 12 + 4 * half) =
            *reinterpret_cast<const uint4*>(src + (size_t)row * CIN + ch * CC + 8 * half);
      }
    } else {
      const float* src = static_cast<const float*>(wa);
      for (int idx = tid; idx < KA * KA * CC * CMID; idx += PR_THREADS) {
        const int co = idx % CMID, rest = idx / CMID;
        const int ci = rest % CC, tap = rest / CC;
        s_wa_f[idx] = src[((size_t)tap * CIN + ch * CC + ci) * CMID + co];
      }
    }
  };

  // ---- conv_a over the mid tile -> s_mid in the chain dtype ----
  if constexpr (C::A_MMA) {
    // implicit GEMM: M = the mid positions (16 a tile, row-major over the
    // tile, so a tile may wrap a row), N = CMID (2 n-tiles), K = taps x CC
    constexpr int NMT = (M + 15) / 16, NMT_W = (NMT + 7) / 8;
    float acc[NMT_W][2][4];
    int base0[NMT_W], base1[NMT_W];  // a lane's two A rows: input pixel at tap (0, 0)
#pragma unroll
    for (int j = 0; j < NMT_W; ++j) {
      const int m0 = min((warp + 8 * j) * 16 + g, M - 1), m1 = min(m0 + 8, M - 1);
      base0[j] = (m0 / MW) * IW + m0 % MW;
      base1[j] = (m1 / MW) * IW + m1 % MW;
#pragma unroll
      for (int n = 0; n < 2; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
    }
    for (int ch = 0; ch < C::NCH; ++ch) {
      stage(ch);
      __syncthreads();
#pragma unroll 1
      for (int kh = 0; kh < KA; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KA; ++kw) {
          uint32_t bf[2][2];
          const uint32_t* wrow = s_wa + ((kh * KA + kw) * CMID + g) * 12 + t;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            bf[n][0] = wrow[n * 8 * 12];
            bf[n][1] = wrow[n * 8 * 12 + 4];
          }
          const int sh = kh * IW + kw;
#pragma unroll
          for (int j = 0; j < NMT_W; ++j) {
            if (warp + 8 * j < NMT) {
              const uint32_t* p0 = s_in + (base0[j] + sh) * SI + t;
              const uint32_t* p1 = s_in + (base1[j] + sh) * SI + t;
              const uint32_t a[4] = {p0[0], p1[0], p0[4], p1[4]};
              mma_bf16(acc[j][0], a, bf[0][0], bf[0][1]);
              mma_bf16(acc[j][1], a, bf[1][0], bf[1][1]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NMT_W; ++j) {
      const int mt = warp + 8 * j;
      if (mt >= NMT) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int co = n * 8 + 2 * t;
        const float b0 = ba ? ba[co] : 0.f, b1 = ba ? ba[co + 1] : 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mt * 16 + g + 8 * e;
          if (m < M)
            s_mid[m * SM + co / 2] = pack_bf16(apply_act(acc[j][n][2 * e] + b0, act_a),
                                               apply_act(acc[j][n][2 * e + 1] + b1, act_a));
        }
      }
    }
  } else {
    // f32 FMAs, CMID accumulators a position. One stage: a position at a
    // time. Several stages: every position of the thread stays in
    // registers across them.
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
              const float4* w4 =
                  reinterpret_cast<const float4*>(s_wa_f + ((kh * KA + kw) * CC + ci) * CMID);
              float wv[CMID];
#pragma unroll
              for (int q = 0; q < CMID / 4; ++q) {
                const float4 v = w4[q];
                wv[4 * q] = v.x; wv[4 * q + 1] = v.y; wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
              }
#pragma unroll
              for (int i = 0; i < G; ++i) {
                const float xv = s_in_f[(pos[i] + kh * IW + kw) * SI + ci];
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
        float o[CMID];
#pragma unroll
        for (int c = 0; c < CMID; ++c) o[c] = apply_act(acc[i][c] + (ba ? ba[c] : 0.f), act_a);
        if constexpr (C::BF) {
#pragma unroll
          for (int c = 0; c < CMID; c += 8)
            *reinterpret_cast<uint4*>(s_mid + m * SM + c / 2) =
                make_uint4(pack_bf16(o[c], o[c + 1]), pack_bf16(o[c + 2], o[c + 3]),
                           pack_bf16(o[c + 4], o[c + 5]), pack_bf16(o[c + 6], o[c + 7]));
        } else {
#pragma unroll
          for (int c = 0; c < CMID; ++c) s_mid_f[m * SM + c] = o[c];
        }
      }
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
      const uint32_t* src = s_mid + (ry * MW + rx) * SM;
#pragma unroll
      for (int q = 0; q < (C::BF ? 8 : CMID); ++q) s_mid[m * SM + q] = src[q];
    }
    __syncthreads();
  }

  // ---- conv_b over the output tile ----
  if constexpr (C::B_MMA) {
    // M = 16 output pixels of one row a tile (TW % 16 == 0), N = COUT, each
    // tap one k-step over the 16 mid channels; two m-tiles a warp at a time
    constexpr int NT = COUT / 8, NMT = TH * TW / 16;
    for (int mt0 = warp * 2; mt0 < NMT; mt0 += 16) {
      float acc[2][NT][4];
      int base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = (mt0 + i) * 16 + g;
        base[i] = (o / TW) * MW + o % TW;
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
      }
#pragma unroll 1
      for (int kh = 0; kh < KB; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KB; ++kw) {
          uint32_t bf[NT][2];
          const uint32_t* wrow = s_wb + ((kh * KB + kw) * COUT + g) * 12 + t;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            bf[n][0] = wrow[n * 8 * 12];
            bf[n][1] = wrow[n * 8 * 12 + 4];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t* p0 = s_mid + (base[i] + kh * MW + kw) * SM + t;
            const uint32_t* p1 = p0 + 8 * SM;
            const uint32_t a[4] = {p0[0], p1[0], p0[4], p1[4]};
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], a, bf[n][0], bf[n][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int co = n * 8 + 2 * t;
          const float b0 = bb ? bb[co] : 0.f, b1 = bb ? bb[co + 1] : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = (mt0 + i) * 16 + g + 8 * e;
            const int gy = y0 + o / TW, gx = x0 + o % TW;
            if (gy >= H || gx >= W) continue;
            *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * H + gy) * W + gx) * COUT + co) =
                __floats2bfloat162_rn(apply_act(acc[i][n][2 * e] + b0, act_b),
                                      apply_act(acc[i][n][2 * e + 1] + b1, act_b));
          }
        }
      }
    }
  } else {
    // f32 FMAs: an item is one output pixel and CO_B output channels
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
          const int mp = (orow + kh) * MW + ocol + kw;
          float v[CMID];
          if constexpr (C::BF) {
            load8(reinterpret_cast<const __nv_bfloat16*>(s_mid + mp * SM), v);
            load8(reinterpret_cast<const __nv_bfloat16*>(s_mid + mp * SM + 4), v + 8);
          } else {
#pragma unroll
            for (int ci = 0; ci < CMID; ++ci) v[ci] = s_mid_f[mp * SM + ci];
          }
          const float* wt = s_wb_f + (kh * KB + kw) * CMID * COUT + cg * CO_B;
#pragma unroll
          for (int ci = 0; ci < CMID; ++ci)
#pragma unroll
            for (int c = 0; c < CO_B; ++c) acc[c] = fmaf(v[ci], wt[ci * COUT + c], acc[c]);
        }
      }
      T* dst = y + (((size_t)b * H + gy) * W + gx) * COUT + cg * CO_B;
#pragma unroll
      for (int c = 0; c < CO_B; ++c)
        dst[c] = from_f32<T>(apply_act(acc[c] + (bb ? bb[cg * CO_B + c] : 0.f), act_b));
    }
  }
}

}  // namespace

template <typename T, int KA, int KB, int CIN, int CMID, int COUT>
static int launch_pair(const void* x1, const void* x2, int in_bf16, const void* wa,
                       const float* ba, int act_a, const void* wb, const float* bb, int act_b,
                       void* y, int nsrc, int n_out, int h, int w, cudaStream_t s) {
  using C = PairCfg<T, KA, KB, CIN, CMID, COUT>;
  auto kern = conv_pair_kernel<T, KA, KB, CIN, CMID, COUT>;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((w + C::TW - 1) / C::TW, (h + C::TH - 1) / C::TH, n_out);
  kern<<<grid, PR_THREADS, C::BYTES, s>>>(x1, x2, in_bf16, wa, ba, act_a, wb, bb, act_b,
                                          static_cast<T*>(y), nsrc, h, w);
  return (int)cudaGetLastError();
}

}  // namespace mmif

using namespace mmif;

extern "C" {

// DeepFuse's enter pair: img1, img2 (b, h, w, 1) in in_dtype; y (2b, h, w,
// 32) in dtype (the chain dtype). enc0: wa [25][1][16] f32 (the chain
// dtype's values), ba f32 (16) or null; enc1: wb bf16 [49][32][16] (dtype
// bf16) or f32 [49][16][32], bb f32 (32) or null.
int mmif_conv_pair_enter(int dtype, int in_dtype, const void* img1, const void* img2,
                         const void* wa, const float* ba, int act_a, const void* wb,
                         const float* bb, int act_b, void* y, int b, int h, int w,
                         void* stream) {
  if (h <= 3 || w <= 3 || b < 1 || (in_dtype != DT_F32 && in_dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_bf16 = in_dtype == DT_BF16;
  if (dtype == DT_F32)
    return launch_pair<float, 5, 7, 1, 16, 32>(img1, img2, in_bf16, wa, ba, act_a, wb, bb, act_b,
                                               y, b, 2 * b, h, w, s);
  if (dtype == DT_BF16)
    return launch_pair<__nv_bfloat16, 5, 7, 1, 16, 32>(img1, img2, in_bf16, wa, ba, act_a, wb,
                                                       bb, act_b, y, b, 2 * b, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// DeepFuse's exit pair: x (b, h, w, 32) in dtype; y (b, h, w, 1) in dtype.
// dec1: wa bf16 [25][16][32] (dtype bf16) or f32 [25][32][16], ba f32 (16)
// or null; dec2: wb [25][16][1] f32 (the chain dtype's values), bb f32 (1)
// or null.
int mmif_conv_pair_exit(int dtype, const void* x, const void* wa, const float* ba, int act_a,
                        const void* wb, const float* bb, int act_b, void* y, int b, int h, int w,
                        void* stream) {
  if (h <= 2 || w <= 2 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_pair<float, 5, 5, 32, 16, 1>(x, nullptr, 0, wa, ba, act_a, wb, bb, act_b, y, b,
                                               b, h, w, s);
  if (dtype == DT_BF16)
    return launch_pair<__nv_bfloat16, 5, 5, 32, 16, 1>(x, nullptr, 0, wa, ba, act_a, wb, bb,
                                                       act_b, y, b, b, h, w, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
