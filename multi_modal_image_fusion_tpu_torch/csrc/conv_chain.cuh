// The conv_chain kernel bodies: a reflect-SAME conv over up to MAX_LEGS
// input legs (csrc/conv_chain.cu explains what bounds it). Two bodies:
//
// - bf16: conv_chain_tc_kernel, a wgmma implicit GEMM with an asynchronous
//   copy ring (design below). conv_chain.cu (k1) and conv_chain_k3/k5/k7.cu
//   instantiate it; conv_chain and conv_multi launch it (Cout a multiple of
//   16), and so does conv_wide (conv_wide.cu: Cout a multiple of 4, and its
//   s2d mode).
// - f32: conv_chain_kernel, register-blocked f32 FMAs. conv_chain.cu
//   launches it for conv_chain and conv_multi in f32; conv_wide.cu for its
//   f32 path, with 8 or 4 output channels a block where Cout is not a
//   multiple of 16, and for its s2d mode. TF32 would miss the f32 budget
//   over sums of up to 11,520 terms.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

// ---------------------------------------------------------------------------
// conv_chain: L legs (B_l, H, W, Cin_l) -> (B_out, H, W, Cout)
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

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM
// ---------------------------------------------------------------------------
// The function is the JAX kernel's in bf16 (hiw_kernel.py:297, :387): the
// weights are bf16, a fuse_n pair is summed and rounded to bf16 before the
// product, the products are exact and summed in f32, bias and activation
// are applied in f32 and the result rounded to bf16.
//
// GEMM view: M = output pixels, N = output channels, K = legs x 16-channel
// k-steps x k^2 taps. A block is two warpgroups (256 threads). A tile is TH
// = 2 * MT output rows of TC_TW = 64 pixels; warpgroup g owns rows g*MT ..
// g*MT + MT - 1, one m64 wgmma row block each. N is a block of BN output
// channels (16 to 256; the wrapper picks it and zero-pads Cout to a multiple
// of it), the grid's y; within it, every k-step's input tile is staged once
// for all BN channels. Each m64nNk16 reads its A (2 KB) and B (N x 32
// bytes) from shared memory, so below N = 64 shared memory's 128 bytes a
// cycle, not the tensor cores, bound the MMAs (16 + N / 4 cycles a wgmma
// against N / 2).
//
// Staging: for one (leg, k-step) the tile's input rows plus the reflect halo
// (TH + K - 1 rows of 64 + K - 1 pixels, 16 channels) lie in shared memory
// as [channel half][row][pixel][8 channels] bf16. A wgmma A operand is then
// K-major without swizzle: a core matrix is 8 consecutive pixels of one
// half (128 contiguous bytes), the two halves one leading byte offset
// apart. Tap (kh, kw) of output row r reads the window that starts at staged
// pixel (r + kh, kw): the same tile with the descriptor's start address
// moved by whole 16-byte pixels, so the k^2 taps cost no extra copies. B,
// the packed weights of one k-step, is [tap][half][n][8 ci] bf16, K-major
// too (ops/cuda/conv_chain.py pack_weights_tc writes it).
//
// The ring: R = 4, 3 or 2 stages of input tiles. A stage's copies are
// cp.async 16 bytes a thread with the reflect index math in the source
// address, zero-filled past a leg's last channel. A fuse_n pair, and a leg
// whose channel count is not a multiple of 8, go through registers (load,
// sum in f32, round to bf16, st.shared). A fuse_n pair is copied
// asynchronously instead, each half into its own buffer of the slot and the
// two summed in shared memory once the stage has landed, wherever a ring of
// such doubled slots fits (tc_plan): DBNet's five-leg dec0 (16 pairs at
// 1224x1024, H100) 18.4 -> 16.4 ms with its weights pushed into the ring.
// DeepFuse's k7 dec0 has no such plan at any N block and sums in registers.
// In s2d mode (conv_wide's packed
// leg) the source address is src_pixel's per-phase halo: a staged half of
// 8 channels lies in one phase when Cin / 4 is a multiple of 8 (DeepFuse's
// packed enc1, dec0, dec1 and dec2), else its channels go one by one
// through registers, each in its own phase (enc0: 4 channels, one a
// phase). Stage s + R - 1 is issued right
// after stage s's wgmmas, so copies and the fuse_n sums run while the
// tensor cores work through the queued wgmmas. (TMA's tiled mode
// zero-fills out-of-bounds reads and cannot make the halo; TMA loads of the
// interior tiles beside cp.async for the border ones were tried, made enc1
// faster and VIFNet's dec0 slower, and were not kept.) The weights of the
// block's N slice are resident (loaded once) when they fit beside the
// ring, which covers every DeepFuse and DenseFuse layer; otherwise each
// stage carries its k-step's weights in the ring. The grid is persistent:
// at most as many blocks as fit on the SMs, each walking tiles (tx
// fastest), so a resident weight is read once a block.
//
// Epilogue: f32 bias and activation on the accumulators, rounded to bf16
// into an output tile in shared memory ([pixel][BN] with rows padded by 16
// bytes, so the accumulator layout's 4-byte writes hit 32 banks); after
// the next stage's wgmmas are issued, the tile goes to global memory in
// coalesced 16-byte stores (8-byte ones for a Cout of 4 mod 8, conv_wide's
// packed dec2: a pixel is then 8-byte aligned and its last 4 channels end
// where the next pixel starts). The activation is a template argument, picked
// once a tile: a switch on it for every element (an indirect branch each)
// made enc1's epilogue cost as much as a third of its MMAs.
constexpr int TC_TW = 64;
constexpr int TC_WG = 2;
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_CK = 16;
constexpr int TC_SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to

// m-tiles a warpgroup: 64 to 128 accumulator registers a thread (2 m-tiles
// from BN 48 to 128, 4 at 32, 8 at 16, one at 256). Two m-tiles at BN 96
// and 128 halve the weight bytes a product reads when the weights stream
// through the ring, and halve the stages (each with its barrier and
// waits) a pixel takes: on an H100, 16 pairs, UNFusion's DB3_1 conv1
// (80 k-steps of k3 weights) 57.6 -> 41.3 ms, DB2_2 conv1 25.3 -> 18.0,
// the EB4_3 k1 conv 7.2 -> 4.5.
__host__ __device__ constexpr int tc_mt(int bn) {
  return bn >= 256 ? 1 : bn >= 96 ? 2 : (128 / bn > 8 ? 8 : 128 / bn);
}

template <int K_, int BN_>
struct TcGeom {
  static constexpr int K = K_, BN = BN_;
  static constexpr int MT = tc_mt(BN);
  static constexpr int TH = TC_WG * MT;
  static constexpr int IN_H = TH + K - 1, IN_W = TC_TW + K - 1;
  // one channel half of a staged tile; the halves start 64 bytes apart
  // modulo 128, so the two 16-byte copies of a pixel hit other banks
  static constexpr int HALF = (IN_H * IN_W * 16 + 127) / 128 * 128 + 64;
  static constexpr int IN_BYTES = 2 * HALF;
  static constexpr int W_BYTES = K * K * BN * 32;  // one k-step: [tap][half][n][8]
  static constexpr int OUT_PITCH = 2 * BN + 16;     // bytes of one staged output pixel
  static constexpr int OUT_BYTES = TH * TC_TW * OUT_PITCH;
};

struct TcArgs {
  Legs legs;
  int ks0[MAX_LEGS + 1];  // each leg's first k-step; ks0[legs.n] = KS
  const __nv_bfloat16* w;  // [Cout_pad / BN][KS][K * K][2][BN][8]
  const float* bias;
  __nv_bfloat16* y;
  int b_out, H, W, Cout, KS, fuse_n, act;
  int tiles_x, tiles_y, n_tiles;  // set by launch_chain_tc
  int resident, ring;             // set by tc_plan
  int pair;                       // set by tc_plan: a fuse_n pair summed in shared memory
};

// Resident weights with the deepest ring that fits, else the weights in the
// ring; with pair_ok, the first of these plans whose ring slots hold both
// halves of a fuse_n pair (pair), else one half. in_tile is a staged input
// tile, w_bytes one k-step's weights, fixed the rest (the output tile; the
// int8 body's also its dequant scales and biases); smem is the dynamic
// shared memory: the ring, the weights, the rest. The int8 body
// (conv_int8.cuh) plans with it too.
inline bool tc_plan_bytes(size_t in_tile, size_t w_bytes, size_t fixed, int ks, bool pair_ok,
                          int& resident, int& ring, int& pair, size_t& smem) {
  for (int p = pair_ok ? 1 : 0; p >= 0; --p) {
    const size_t in_bytes = in_tile * (p + 1);
    for (int res = 1; res >= 0; --res)
      for (int r = 4; r >= 2; --r) {
        const size_t s = res ? (size_t)r * in_bytes + (size_t)ks * w_bytes + fixed
                             : (size_t)r * (in_bytes + w_bytes) + fixed;
        if (s <= (size_t)TC_SMEM_MAX) {
          resident = res, ring = r, pair = p, smem = s;
          return true;
        }
      }
  }
  return false;
}

// The bf16 body's plan; ops/cuda/conv_chain.py tc_plan mirrors this choice
// to pick BN.
template <int K, int BN>
bool tc_plan(int ks, int fuse_n, int& resident, int& ring, int& pair, size_t& smem) {
  using G = TcGeom<K, BN>;
  return tc_plan_bytes(G::IN_BYTES, G::W_BYTES, G::OUT_BYTES, ks, fuse_n != 0, resident, ring,
                       pair, smem);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// The leg of k-step ks.
__device__ __forceinline__ int tc_leg(const TcArgs& a, int ks) {
  int l = 0;
  while (ks >= a.ks0[l + 1]) ++l;
  return l;
}

// True when k-step ks's 8-channel halves move as 16-byte copies: a leg of
// whole 8-channel groups that, in s2d mode, lie in one phase each.
__device__ __forceinline__ bool tc_vec(const TcArgs& a, int ks) {
  const int cin = a.legs.cin[tc_leg(a, ks)];
  return (cin % 8) == 0 && (!a.legs.s2d || ((cin >> 2) % 8) == 0);
}

// The batch image and tile row and column of tile (A: the launch
// parameters of this body or of conv_int8.cuh's).
template <typename A>
__device__ __forceinline__ void tc_tile(const A& a, int tile, int& b, int& ty, int& tx) {
  tx = tile % a.tiles_x;
  const int rest = tile / a.tiles_x;
  ty = rest % a.tiles_y;
  b = rest / a.tiles_y;
}

// The 16-byte copies of one leg's staged tile (k-step channels c0 ..
// c0 + 15, the halo in the source address; S2D: half h in phase ph[h]) into
// buf, zero-filled past the leg's last channel.
template <int K, int BN, bool S2D>
__device__ __forceinline__ void tc_copy_tile(const TcArgs& a, const __nv_bfloat16* x, int Cin,
                                             int c0, int y0, int x0, int ph0, int ph1,
                                             uint32_t buf) {
  using G = TcGeom<K, BN>;
  for (int i = threadIdx.x; i < G::IN_H * G::IN_W * 2; i += TC_THREADS) {
    const int half = i & 1, pix = i >> 1;
    const int r = pix / G::IN_W, c = pix - r * G::IN_W;
    const int ch = c0 + 8 * half;
    size_t px;
    if constexpr (S2D)
      px = src_pixel(y0 + r, x0 + c, a.H, a.W, 1, half ? ph1 : ph0);
    else
      px = (size_t)reflect_index(y0 + r, a.H) * a.W + reflect_index(x0 + c, a.W);
    const size_t off = px * Cin + ch;
    cp_async16(buf + half * G::HALF + pix * 16, ch < Cin ? x + off : x, ch < Cin ? 16 : 0);
  }
}

// Stage s's k-step weights (k-step ks; W_BYTES a k-step) into ring slot s
// % ring, when they are not resident: the end of both bodies' stage loads.
template <int W_BYTES, typename A, typename W>
__device__ __forceinline__ void tc_load_weights(const A& a, int ks, int s, uint32_t s_w,
                                                const W* wblk) {
  constexpr int WE = sizeof(W);
  if (!a.resident) {
    const W* src = wblk + (size_t)ks * (W_BYTES / WE);
    const uint32_t wdst = s_w + (s % a.ring) * W_BYTES;
    for (int i = threadIdx.x; i < W_BYTES / 16; i += TC_THREADS)
      cp_async16(wdst + 16 * i, src + (16 / WE) * i, 16);
  }
}

// Issue the copies of the block's stage s (tile s / KS, k-step s % KS) into
// ring slot s % ring: the input tile with its reflect halo (S2D: the packed
// leg's per-phase halo) and, when the weights are not resident, the
// k-step's weights.
template <int K, int BN, bool S2D>
__device__ __forceinline__ void tc_load_stage_t(const TcArgs& a, int s, uint32_t s_in,
                                                uint32_t s_w, const __nv_bfloat16* wblk) {
  using G = TcGeom<K, BN>;
  constexpr int P = K / 2;
  const int ks = s % a.KS;
  int b, ty, tx;
  tc_tile(a, blockIdx.x + (s / a.KS) * gridDim.x, b, ty, tx);
  const int l = tc_leg(a, ks);
  const int Cin = a.legs.cin[l];
  const int c0 = (ks - a.ks0[l]) * TC_CK;
  const size_t img = (size_t)a.H * a.W * Cin;
  const __nv_bfloat16* xa =
      static_cast<const __nv_bfloat16*>(a.legs.x[l]) + (size_t)(b + a.legs.b_off[l]) * img;
  const __nv_bfloat16* xs = a.fuse_n ? xa + (size_t)a.fuse_n * img : nullptr;
  // S2D: cb channels a phase; 8 channels move together where they lie in
  // one phase, the phase of half h being (c0 + 8 h) / cb
  const int cb = Cin >> 2;
  const bool vec = (Cin % 8) == 0 && (!S2D || cb % 8 == 0);
  const int ph0 = S2D && vec ? c0 / cb : 0, ph1 = S2D && vec ? (c0 + 8) / cb : 0;
  const uint32_t buf = s_in + (s % a.ring) * G::IN_BYTES;
  const int y0 = ty * G::TH - P, x0 = tx * TC_TW - P;
  if (vec && (!xs || a.pair)) {
    tc_copy_tile<K, BN, S2D>(a, xa, Cin, c0, y0, x0, ph0, ph1, buf);
    // pair: the fuse_n sibling into the slot's second buffer
    if (xs) tc_copy_tile<K, BN, S2D>(a, xs, Cin, c0, y0, x0, ph0, ph1,
                                     buf + a.ring * G::IN_BYTES);
  } else {
    for (int i = threadIdx.x; i < G::IN_H * G::IN_W * 2; i += TC_THREADS) {
      const int half = i & 1, pix = i >> 1;
      const int r = pix / G::IN_W, c = pix - r * G::IN_W;
      const int ch = c0 + 8 * half;
      size_t px;
      if constexpr (S2D)
        px = src_pixel(y0 + r, x0 + c, a.H, a.W, 1, half ? ph1 : ph0);
      else
        px = (size_t)reflect_index(y0 + r, a.H) * a.W + reflect_index(x0 + c, a.W);
      const size_t off = px * Cin + ch;
      // fuse_n: the pair summed in f32 and rounded once, a bf16 add; a
      // ragged leg (or an S2D half across phases): its channels one by
      // one, zeros past the last
      float v[8];
      if (vec) {
        if (ch < Cin) {
          float u[8];
          load8(xa + off, v);
          load8(xs + off, u);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += u[j];
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = 0.f;
          if (ch + j < Cin) {
            // S2D: each channel in its own phase's halo
            const size_t o = S2D ? src_pixel(y0 + r, x0 + c, a.H, a.W, 1, (ch + j) / cb) * Cin +
                                       ch + j
                                 : off + j;
            v[j] = to_f32(xa[o]);
            if (xs) v[j] += to_f32(xs[o]);
          }
        }
      }
      st_shared16(buf + half * G::HALF + pix * 16, pack8_bf16(v));
    }
  }
  tc_load_weights<G::W_BYTES>(a, ks, s, s_w, wblk);
}

// Eight bf16 channels at two shared addresses, summed in f32 and rounded to
// bf16.
__device__ __forceinline__ uint4 tc_sum_pair(uint32_t x, uint32_t y) {
  uint4 u, v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(x));
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(y));
  const __nv_bfloat162* hu = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&v);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(hu[i]), q = __bfloat1622float2(hv[i]);
    f[2 * i] = p.x + q.x;
    f[2 * i + 1] = p.y + q.y;
  }
  return pack8_bf16(f);
}

// The tile's accumulators, bias and activation ACT in f32, as bf16 pairs
// into the output tile in shared memory.
template <int K, int BN, int ACT>
__device__ __forceinline__ void tc_stage_out(const TcArgs& a, float (&acc)[TcGeom<K, BN>::MT][BN / 2],
                                             uint32_t s_out, int nb) {
  using G = TcGeom<K, BN>;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = nb * BN + 8 * j + 2 * q;
    const bool live = c < a.Cout;
    const float b0 = live && a.bias ? __ldg(a.bias + c) : 0.f;
    const float b1 = live && a.bias ? __ldg(a.bias + c + 1) : 0.f;
#pragma unroll
    for (int m = 0; m < G::MT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pix = (wg * G::MT + m) * TC_TW + 16 * warp + g + 8 * e;
        const uint32_t v = pack_bf16(apply_act_c<ACT>(acc[m][4 * j + 2 * e] + b0),
                                     apply_act_c<ACT>(acc[m][4 * j + 2 * e + 1] + b1));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(s_out + pix * G::OUT_PITCH + 16 * j + 4 * q),
                     "r"(v)
                     : "memory");
      }
  }
}

// The staged output tile to global memory: 16 bytes (8 channels of one
// pixel) a thread, consecutive threads on consecutive bytes. A Cout of 4
// mod 8 (conv_wide only) takes 8-byte stores of 4 channels, none past Cout.
template <int K, int BN>
__device__ __forceinline__ void tc_store_out(const TcArgs& a, int tile, uint32_t s_out, int nb) {
  using G = TcGeom<K, BN>;
  constexpr int CH = BN / 8;  // 16-byte chunks of a pixel
  int b, ty, tx;
  tc_tile(a, tile, b, ty, tx);
  if (a.Cout % 8) {
    for (int i = threadIdx.x; i < G::TH * TC_TW * 2 * CH; i += TC_THREADS) {
      const int pix = i / (2 * CH), c = i - pix * (2 * CH);
      const int oy = ty * G::TH + pix / TC_TW, ox = tx * TC_TW + pix % TC_TW;
      const int co = nb * BN + 4 * c;
      if (oy < a.H && ox < a.W && co < a.Cout) {
        uint2 v;
        asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                     : "=r"(v.x), "=r"(v.y)
                     : "r"(s_out + pix * G::OUT_PITCH + 8 * c));
        *reinterpret_cast<uint2*>(a.y + (((size_t)b * a.H + oy) * a.W + ox) * a.Cout + co) = v;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < G::TH * TC_TW * CH; i += TC_THREADS) {
    const int pix = i / CH, c = i - pix * CH;
    const int oy = ty * G::TH + pix / TC_TW, ox = tx * TC_TW + pix % TC_TW;
    const int co = nb * BN + 8 * c;
    if (oy < a.H && ox < a.W && co < a.Cout) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(s_out + pix * G::OUT_PITCH + 16 * c));
      *reinterpret_cast<uint4*>(a.y + (((size_t)b * a.H + oy) * a.W + ox) * a.Cout + co) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The stage loop of both wgmma conv bodies
// ---------------------------------------------------------------------------
// One loop runs this body (bf16, TcBf16 below) and the int8 one
// (conv_int8.cuh Q8Op): ring prologue, per stage the wait, the fuse_n pair
// sum in shared memory, the wgmmas over every tap, then while they run the
// previous tile's store and the next stage's copies, and a tile's epilogue
// after its last k-step. Op, the operand traits, gives what differs:
//   Args, Acc, G             launch parameters, accumulator type, geometry
//   W_BYTES                  one k-step's packed weights in a block's N slice
//   LBO, KW, TAP, HALVES     the A descriptor's leading byte offset, wgmmas a
//                            row of taps and the pixels between their taps,
//                            16-byte halves staged a pixel (tap pairs: 16, (K
//                            + 1) / 2, 2, 1; else HALF, K, 1, 2)
//   mma                      one wgmma
//   start                    the block's set-up before the ring's prologue
//   load_stage               stage s's copies into its ring slot: the input
//                            tile, then tc_load_weights
//   pair_vec, sum16          whether k-step ks, in a plan with a fuse_n pair
//                            in shared memory (TcArgs::pair), sums it there;
//                            16 bytes of it summed in place
//   stage_out<ACT>           the tile's epilogue into the output tile
//   store_out                the output tile to global memory
// Both are forced inline, so each instance compiles to the loop it had
// when each body held its own copy.

template <class Op>
__device__ __forceinline__ void tc_conv(const typename Op::Args& a) {
  using G = typename Op::G;
  constexpr int K = G::K, BN = G::BN, MT = G::MT;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t s_in = smem_u32(tc_smem);
  const uint32_t s_w = s_in + a.ring * G::IN_BYTES * (a.pair ? 2 : 1);
  const uint32_t s_out = s_w + (a.resident ? a.KS : a.ring) * Op::W_BYTES;
  // warp-uniform (a shuffle from lane 0), so the descriptors below live in
  // uniform registers and each wgmma's is one add of an immediate
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nb = blockIdx.y;
  constexpr int WE = sizeof(*a.w);  // bytes a weight element
  const auto wblk = a.w + (size_t)nb * a.KS * (Op::W_BYTES / WE);
  const int my_tiles =
      (int)blockIdx.x < a.n_tiles ? (a.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int S = my_tiles * a.KS;

  Op::start(a, s_out, nb);
  // resident weights: the block's N slice of every k-step, in the first group
  if (a.resident)
    for (int i = threadIdx.x; i < a.KS * (Op::W_BYTES / 16); i += TC_THREADS)
      cp_async16(s_w + 16 * i, wblk + (16 / WE) * i, 16);
  for (int s = 0; s < a.ring - 1; ++s) {
    if (s < S) Op::load_stage(a, s, s_in, s_w, wblk);
    cp_async_commit();
  }

  typename Op::Acc acc[MT][BN / 2];

  int staged = -1;  // the tile whose outputs wait in s_out
  for (int s = 0; s < S; ++s) {
    // stage s has landed (each thread's own copies and stores), is visible
    // to the async proxy, and every warpgroup is done with stage s - 1's slot
    if (a.ring == 4)
      cp_async_wait<2>();
    else if (a.ring == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    const int ks = s % a.KS;
    const uint32_t buf = s_in + (s % a.ring) * G::IN_BYTES;
    if (a.pair && Op::pair_vec(a, ks)) {
      // the fuse_n pair: the sibling's buffer added into the slot, as the
      // register path sums it
      for (int i = threadIdx.x; i < G::IN_H * G::IN_W * Op::HALVES; i += TC_THREADS) {
        const uint32_t at = Op::HALVES == 2 ? buf + (i & 1) * G::HALF + (i >> 1) * 16 : buf + i * 16;
        Op::sum16(at, at + a.ring * G::IN_BYTES);
      }
      fence_proxy_async();
      __syncthreads();
    }
    const uint32_t wk = s_w + (a.resident ? ks : s % a.ring) * Op::W_BYTES;
    const uint64_t da0 = wgmma_desc(buf + wg * MT * G::IN_W * 16, Op::LBO, 128);
    const uint64_t db0 = wgmma_desc(wk, BN * 16, 128);
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
    wgmma_fence();
    // every tap unrolled: the issue of one wgmma waits on no address math
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
#pragma unroll
      for (int j = 0; j < Op::KW; ++j) {
        const uint64_t db = desc_add(db0, (kh * Op::KW + j) * BN * 32);
        // a tile's first product overwrites the accumulators
        const int scale_d = ks > 0 || kh > 0 || j > 0;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          Op::mma(acc[m], desc_add(da0, ((m + kh) * G::IN_W + Op::TAP * j) * 16), db, scale_d);
      }
    }
    wgmma_commit();
    // while the tensor cores work through the queued wgmmas: the previous
    // tile's outputs to global memory, the copies of stage s + ring - 1
    // (into the slot stage s - 1 used). Interleaved with the wgmmas' issue
    // (a K-th after each row of taps) they made enc1 slower.
    if (staged >= 0) Op::store_out(a, staged, s_out, nb);
    staged = -1;
    if (s + a.ring - 1 < S) Op::load_stage(a, s + a.ring - 1, s_in, s_w, wblk);
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);

    if (ks != a.KS - 1) continue;
    // the tile's epilogue into s_out, once every thread has stored the
    // previous tile out of it
    __syncthreads();
    switch (a.act) {
      case ACT_RELU: Op::template stage_out<ACT_RELU>(a, acc, s_out, nb); break;
      case ACT_RELU6: Op::template stage_out<ACT_RELU6>(a, acc, s_out, nb); break;
      case ACT_LRELU: Op::template stage_out<ACT_LRELU>(a, acc, s_out, nb); break;
      case ACT_TANH: Op::template stage_out<ACT_TANH>(a, acc, s_out, nb); break;
      default: Op::template stage_out<ACT_NONE>(a, acc, s_out, nb);
    }
    staged = blockIdx.x + (s / a.KS) * gridDim.x;
  }
  if (staged >= 0) {
    __syncthreads();
    Op::store_out(a, staged, s_out, nb);
  }
  cp_async_wait<0>();
}

// The bf16 operand traits of tc_conv.
template <int K, int BN>
struct TcBf16 {
  using Args = TcArgs;
  using Acc = float;
  using G = TcGeom<K, BN>;
  static constexpr int W_BYTES = G::W_BYTES, LBO = G::HALF, KW = K, TAP = 1, HALVES = 2;
  static __device__ __forceinline__ void start(const TcArgs&, uint32_t, int) {}
  // the s2d flag is uniform over a launch: one test a stage, so the load
  // of a plain leg (conv_chain, conv_multi) is the code it always was
  static __device__ __forceinline__ void load_stage(const TcArgs& a, int s, uint32_t s_in,
                                                    uint32_t s_w, const __nv_bfloat16* wblk) {
    if (a.legs.s2d)
      tc_load_stage_t<K, BN, true>(a, s, s_in, s_w, wblk);
    else
      tc_load_stage_t<K, BN, false>(a, s, s_in, s_w, wblk);
  }
  static __device__ __forceinline__ bool pair_vec(const TcArgs& a, int ks) {
    return tc_vec(a, ks);
  }
  // summed in f32 and rounded once
  static __device__ __forceinline__ void sum16(uint32_t at, uint32_t sib) {
    st_shared16(at, tc_sum_pair(at, sib));
  }
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                             int scale_d) {
    wgmma_bf16<BN>(d, da, db, scale_d);
  }
  template <int ACT>
  static __device__ __forceinline__ void stage_out(const TcArgs& a, float (&acc)[G::MT][BN / 2],
                                                   uint32_t s_out, int nb) {
    tc_stage_out<K, BN, ACT>(a, acc, s_out, nb);
  }
  static __device__ __forceinline__ void store_out(const TcArgs& a, int tile, uint32_t s_out,
                                                   int nb) {
    tc_store_out<K, BN>(a, tile, s_out, nb);
  }
};

template <int K, int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_chain_tc_kernel(const __grid_constant__ TcArgs a) {
  tc_conv<TcBf16<K, BN>>(a);
}

// The persistent grid of a wgmma conv body (this one, conv_int8.cuh's): at
// most as many blocks of `kernel` as fit on the SMs beside `smem` of
// dynamic shared memory, n_nb slices of N in the grid's y. Sets the tiling
// of a (th rows of TC_TW pixels a tile). 0 or a cudaError_t.
template <typename A>
int tc_grid(const void* kernel, A& a, int th, size_t smem, int n_nb, dim3& grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, TC_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  a.tiles_x = (a.W + TC_TW - 1) / TC_TW;
  a.tiles_y = (a.H + th - 1) / th;
  const long long tiles = (long long)a.tiles_x * a.tiles_y * a.b_out;
  if (tiles > 0x7fffffffLL || n_nb > 65535) return (int)cudaErrorInvalidConfiguration;
  a.n_tiles = (int)tiles;
  // every block resident at once: the blocks of all N slices fit on the SMs
  // (rounding up put a few blocks in a second wave that then walked their
  // whole share of tiles alone, doubling the time of DB3_1 conv1's 5 slices)
  const int per_nb = sms * occ / n_nb > 0 ? sms * occ / n_nb : 1;
  grid = dim3((unsigned)(a.n_tiles < per_nb ? a.n_tiles : per_nb), (unsigned)n_nb);
  return 0;
}

template <int K, int BN>
int launch_chain_tc(TcArgs a, int cout_pad, cudaStream_t s) {
  using G = TcGeom<K, BN>;
  size_t smem = 0;
  if (!tc_plan<K, BN>(a.KS, a.fuse_n, a.resident, a.ring, a.pair, smem))
    return (int)cudaErrorInvalidValue;
  // opt in to the most shared memory once per instance; the launch asks for
  // what this call's plan needs
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_chain_tc_kernel<K, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid;
  const int e = tc_grid((const void*)conv_chain_tc_kernel<K, BN>, a, G::TH, smem,
                        cout_pad / BN, grid);
  if (e) return e;
  conv_chain_tc_kernel<K, BN><<<grid, TC_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 instances of one kernel size, by N block. conv_chain.cu
// instantiates k1, conv_chain_k3.cu, _k5.cu and _k7.cu the others, so they
// compile in parallel; conv_chain.cu and conv_wide.cu launch them.
template <int K>
int chain_tc_by_bn(int bn, const TcArgs& a, cudaStream_t s) {
  const int cout_pad = (a.Cout + bn - 1) / bn * bn;
  switch (bn) {
    case 16: return launch_chain_tc<K, 16>(a, cout_pad, s);
    case 32: return launch_chain_tc<K, 32>(a, cout_pad, s);
    case 48: return launch_chain_tc<K, 48>(a, cout_pad, s);
    case 64: return launch_chain_tc<K, 64>(a, cout_pad, s);
    case 96: return launch_chain_tc<K, 96>(a, cout_pad, s);
    case 128: return launch_chain_tc<K, 128>(a, cout_pad, s);
    case 256: return launch_chain_tc<K, 256>(a, cout_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch parameters of the bf16 body over legs (w packed by
// ops/cuda/conv_chain.py pack_weights_tc); launch_chain_tc sets the tiling
// and the plan.
inline TcArgs tc_args(const Legs& legs, const void* w, const float* bias, void* y, int b_out,
                      int h, int wd, int cout, int fuse_n, int act) {
  TcArgs a = {};
  a.legs = legs;
  a.ks0[0] = 0;
  for (int l = 0; l < legs.n; ++l) a.ks0[l + 1] = a.ks0[l] + (legs.cin[l] + TC_CK - 1) / TC_CK;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.b_out = b_out;
  a.H = h;
  a.W = wd;
  a.Cout = cout;
  a.KS = a.ks0[legs.n];
  a.fuse_n = fuse_n;
  a.act = act;
  return a;
}

extern template int chain_tc_by_bn<1>(int, const TcArgs&, cudaStream_t);
extern template int chain_tc_by_bn<3>(int, const TcArgs&, cudaStream_t);
extern template int chain_tc_by_bn<5>(int, const TcArgs&, cudaStream_t);
extern template int chain_tc_by_bn<7>(int, const TcArgs&, cudaStream_t);

// The bf16 body over legs for kernel size k (1, 3, 5 or 7) and N block bn:
// conv_chain.cu's and conv_wide.cu's entry points.
inline int launch_tc(int k, int bn, const Legs& legs, const void* w, const float* bias, void* y,
                     int b_out, int h, int wd, int cout, int fuse_n, int act, cudaStream_t s) {
  const TcArgs a = tc_args(legs, w, bias, y, b_out, h, wd, cout, fuse_n, act);
  switch (k) {
    case 1: return chain_tc_by_bn<1>(bn, a, s);
    case 3: return chain_tc_by_bn<3>(bn, a, s);
    case 5: return chain_tc_by_bn<5>(bn, a, s);
    case 7: return chain_tc_by_bn<7>(bn, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: register-blocked FMAs
// ---------------------------------------------------------------------------
// One block computes a TH x TW output tile for CO_T output channels. Each
// leg's input tile plus halo is staged in shared memory CI_C channels at a
// time (channel-major so a thread's row segment is one to three float4
// loads), next to the matching CI_C x K x K x CO_T weight slice. The legs
// are an outer loop around the channel chunks, each with its own base
// pointer, channel count and batch offset; legs of any channel count work
// (a 1-channel leg loads scalars and runs one FMA channel).
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

// internal linkage: each source that includes this header has its own copy
namespace {

template <int K, int CO_T>
__global__ void __launch_bounds__(CH_THREADS)
conv_chain_kernel(Legs legs, const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y, int H, int W, int Cout, int fuse_n, int act) {
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
    const float* base = static_cast<const float*>(legs.x[l]);
    const float* xa = base + (size_t)(b + legs.b_off[l]) * img;
    const float* xs = fuse_n ? base + (size_t)(b + legs.b_off[l] + fuse_n) * img : nullptr;
    const int s2d = legs.s2d, cb = Cin >> 2;  // s2d: channels a phase
    // 8 channels a load where they lie in one phase
    const bool vec = (Cin % 8) == 0 && (!s2d || cb % 8 == 0);

    for (int ci0 = 0; ci0 < Cin; ci0 += CH_CI) {
      // stage the input tile (reflect halo, fuse_n sibling added)
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
                v[j] = xa[o];
                if (xs) v[j] += xs[o];
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

  // epilogue: bias + activation, 16-byte stores
  const int gy = y0 + ty;
  if (gy >= H) return;
  float bv[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) bv[c] = bias ? bias[co0 + c] : 0.f;
#pragma unroll
  for (int p = 0; p < CH_PX; ++p) {
    const int gx = x0 + tx * CH_PX + p;
    if (gx >= W) continue;
    float* dst = y + (((size_t)b * H + gy) * W + gx) * Cout + co0;
    float o[CO_T];
#pragma unroll
    for (int c = 0; c < CO_T; ++c) o[c] = apply_act(acc[p][c] + bv[c], act);
    if constexpr (CO_T % 8 == 0) {
#pragma unroll
      for (int c = 0; c < CO_T; c += 8) store8(dst + c, o + c);
    } else {
#pragma unroll
      for (int c = 0; c < CO_T; ++c) dst[c] = o[c];
    }
  }
}

}  // namespace

template <int K, int CO_T>
static int launch_chain(const Legs& legs, const float* w, const float* bias, void* y,
                        int b_out, int h, int wd, int cout, int fuse_n, int act,
                        cudaStream_t stream) {
  constexpr size_t smem = ChainSmem<K, CO_T>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory; set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_chain_kernel<K, CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((wd + CH_TW - 1) / CH_TW, (h + CH_TH - 1) / CH_TH, b_out * (cout / CO_T));
  conv_chain_kernel<K, CO_T><<<grid, CH_THREADS, smem, stream>>>(
      legs, w, bias, static_cast<float*>(y), h, wd, cout, fuse_n, act);
  return (int)cudaGetLastError();
}

}  // namespace mmif
