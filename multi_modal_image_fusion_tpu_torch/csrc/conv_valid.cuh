// The train step's VALID convolution on Hopper's tensor cores: conv_valid
// (forward and dx, one implicit-GEMM body) and conv_valid_dw (the weight
// gradient). Entry points in conv_valid.cu; the k3, k5 and k7 instances in
// conv_valid_k3/k5/k7.cu, built in parallel.
//
// Replaces the TPU kernel multi_modal_image_fusion_tpu/ops/pallas/
// conv_kernel.py:161 conv_tlane_dma, which the training path launches three
// ways: the forward and the dx of the differentiable conv
// (ops/pallas/conv_vjp.py:71 conv_valid_fast), and the valid step's conv
// with bias and activation fused into the epilogue. conv_valid_dw replaces
// no Pallas kernel: the JAX package leaves dw to XLA einsums
// (conv_vjp.py:94-106). It was added because the same product as torch ops
// (one shifted copy and one skinny matmul a tap) took 4.77 ms and ~356
// launches of a DeepFuse train step on an H100.
//
//   forward  y[b,i,j,n]   = act(bias[n] + sum_{kh,kw,c} xp[b,i+kh,j+kw,c] w[n][c][kh][kw])
//   dx       dxp[b,p,q,n] = sum_{kh,kw,c} dy[b,p+kh-K+1,q+kw-K+1,c] w[c][n][K-1-kh][K-1-kw]
//   dw       dw[n][c][kh][kw] = sum_{b,i,j} xp[b,i+kh,j+kw,c] dy[b,i,j,n]
//
// dx is the full correlation of the cotangent: the stage load reads dy at
// the shifted position and zero-fills outside it (cp.async with a source
// size of 0), and the weight load reads the taps flipped with in and out
// swapped, so no padded cotangent or flipped weight is made in torch. Both
// kernels read their inputs and the OIHW weight in place.
//
// What bounds them on an H100: operations. At DeepFuse's train step (16
// pairs of 64x64 patches, f32) enc1 and dec0 do 3.3e9 and 1.6e9 MACs each
// way against a few MB, far above the card's balance. f32 FMAs peak at 67
// TFLOP/s; plain TF32 (495) keeps ~3 decimal digits, so f32 runs a 3xTF32
// split on the tensor cores: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
// hi), and lo*hi + hi*lo + hi*hi summed in f32 (mma.sync m16n8k8), smallest
// terms first: three products for f32 accuracy, up to 495/3 TFLOP/s. bf16
// (--amp bf16) runs mma.sync m16n8k16 with f32 accumulators. The tensor
// cores' own accumulation does not round to nearest, so f32's three
// products of a k-step, and dw's products of a stage, are summed in fresh
// registers and added to the running sums in f32.
//
// conv_valid: M = output pixels, N = output channels (BN 8, 16 or 32 a
// block), K = input channels x taps. An image is cut into strips of `tw`
// output columns (the whole width up to 136, so 64-70 wide patches are one
// strip), and a strip's pixels are flattened at the staged pitch P = tw + K
// - 1: position m = i * P + j, with j >= tw computed and not stored. Tap
// (kh, kw) of position m reads flattened input pixel m + kh * P + kw, so a
// tile of 96 consecutive positions reads one contiguous run of P-pitched
// pixels for each kernel row: a stage of the cp.async ring is that run
// (96 + K - 1 pixels) for one kernel row and one 32-byte chunk of input
// channels (8 f32 or 16 bf16), its two 16-byte halves swapped every 4 pixels
// so the ldmatrix of a 16-pixel A fragment hits 32 banks. The wasted share
// is (K - 1) / P plus the last tile's rounding: 9.2 % at the 64-wide k7
// forward, 8.85 % at the 70-wide k7 dx. A block of 12 warps computes two
// tiles of one N block at once (warps 0-5 and 6-11, 16 positions a warp,
// its A fragment of tap kw loaded by ldmatrix at a shift of kw pixels), so
// a stage's weights serve 192 positions; 384 threads leave 170 registers a
// thread (the f32 N-32 instances need more than 128). The weights are
// streamed with the stages: a slice (K taps of the kernel row, one channel
// chunk, BN channels) is read from the OIHW weight into registers one stage
// ahead, split (f32) and stored in fragment order, so a lane reads its B
// fragment as one 16-byte (f32 hi and lo) or 8-byte (bf16) shared load. In
// f32 each thread splits the input chunks it copied into hi (in place) and
// lo once its own copies have landed. There is one barrier a stage: the loads of
// later stages (the wait for and split of the next stage's copies, the next
// weights' stores, the copies of stage i + 3, the weight reads of stage i +
// 2) are issued between the taps' products, in their shadow. A persistent
// grid walks (N block, tile pair) items; the epilogue (bias, activation,
// rounding) stores the accumulators straight to the NHWC output. Channel
// counts that are not a multiple of 16 bytes (enc0's and dec2 dx's single
// channel) are staged element by element into the same zero-filled chunk.
//
// conv_valid_dw: M = (kw, 16 input channels), N = output channels (BN), K =
// output pixels. A block is one kernel row kh, one 16-channel block of the
// input and one N block (blockIdx.y), and one chunk of the batch's output
// rows (blockIdx.x, as many chunks as one wave of blocks holds); warp w takes
// kw = w, so its A operand is the staged input row shifted by w pixels. A
// stage is 64 output pixels of one row: xp's row i + kh (64 + K - 1 pixels)
// and dy's row i, both with padded pixel strides (f32 scalar fragment loads
// and bf16 ldmatrix.trans hit 32 banks), split as conv_valid's are, the next
// stage's copies issued between this stage's k-steps. The sums stay in
// registers across the block's rows; then each block writes its partial
// slice to scratch, and the last block of a (kh, channel block, N block)
// group by an atomic ticket sums the group's chunks in chunk order and
// writes dw as OIHW f32: the same bits every run.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace mmif {

// ---- tensor-core helpers ----

__device__ __forceinline__ void va_mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 x): hi and lo both TF32 (10-bit mantissa), rounded
// to nearest, ties away; the low 13 bits cleared, so x - hi is exact
__device__ __forceinline__ uint32_t va_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}
__device__ __forceinline__ void va_split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = va_tf32(__uint_as_float(x));
  lo = va_tf32(__uint_as_float(x) - __uint_as_float(hi));
}

// d = a * b, the accumulator input zero
__device__ __forceinline__ void va_mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += lo*hi + hi*lo + hi*hi, the small terms first, summed apart and
// added to acc in f32 (round to nearest)
__device__ __forceinline__ void va_mma_3xtf32(float (&acc)[4], const uint32_t (&ahi)[4],
                                              const uint32_t (&alo)[4], uint32_t b0hi,
                                              uint32_t b1hi, uint32_t b0lo, uint32_t b1lo) {
  float d[4];
  va_mma_tf32_z(d, alo, b0hi, b1hi);
  va_mma_tf32(d, ahi, b0lo, b1lo);
  va_mma_tf32(d, ahi, b0hi, b1hi);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

// The tensor cores add each product into the accumulator without rounding
// to nearest, so a long run of mma.sync on one accumulator drifts by up to
// an ulp of the running sum a step (summed into a tile's running sums, a
// DeepFuse train step's gradients missed the card test's 1e-4 of the
// largest against F.conv2d on an H100). conv_valid's three f32 products of
// a k-step go into fresh registers added to the running sums in f32
// (va_mma_3xtf32), dw's products of a stage (va_zero, va_add): the drift
// stays that of the short partial sum.
template <int NT>
__device__ __forceinline__ void va_zero(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[nt][q] = 0.f;
}
template <int NT>
__device__ __forceinline__ void va_add(float (&acc)[NT][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] += p[nt][q];
}

// acc += lo*hi + hi*lo + hi*hi into the accumulator itself (dw: a stage's
// partial sum)
__device__ __forceinline__ void va_mma_3xtf32_acc(float (&acc)[4], const uint32_t (&ahi)[4],
                                                  const uint32_t (&alo)[4], uint32_t b0hi,
                                                  uint32_t b1hi, uint32_t b0lo, uint32_t b1lo) {
  va_mma_tf32(acc, alo, b0hi, b1hi);
  va_mma_tf32(acc, ahi, b0lo, b1lo);
  va_mma_tf32(acc, ahi, b0hi, b1hi);
}

// f32: split the 16 bytes at `o` of `buf` into TF32 hi, in place, and lo at
// the same offset of `lo`.
__device__ __forceinline__ void va_split16(unsigned char* buf, unsigned char* lo, int o) {
  uint4 v = *reinterpret_cast<const uint4*>(buf + o);
  uint4 l;
  va_split(v.x, v.x, l.x);
  va_split(v.y, v.y, l.y);
  va_split(v.z, v.z, l.z);
  va_split(v.w, v.w, l.w);
  *reinterpret_cast<uint4*>(buf + o) = v;
  *reinterpret_cast<uint4*>(lo + o) = l;
}

__device__ __forceinline__ void va_ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void va_ldsm_x4_t(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void va_ldsm_x2_t(uint32_t& b0, uint32_t& b1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// raw bits of one element (f32: 32 bits; bf16: 16 bits in the low half)
__device__ __forceinline__ uint32_t va_bits(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ uint32_t va_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// 16 bytes of elements c0.. of one pixel row, element by element: those at
// or past `n` are zero (a channel count that is not a multiple of 16 bytes)
template <typename T>
__device__ __forceinline__ uint4 va_load16(const T* p, int c0, int n) {
  constexpr int E = 16 / sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (c0 + e < n) {
      const uint32_t v = va_bits(p + e);
      if constexpr (sizeof(T) == 4) w[e] = v;
      else w[e >> 1] |= v << (16 * (e & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- conv_valid: forward and dx ----

constexpr int VA_THREADS = 384;  // 12 warps, 16 positions each
constexpr int VA_BM = 96;        // output positions a tile
constexpr int VA_SUB = 2;        // tiles a block computes at once (warps 0-5, 6-11)
constexpr int VA_TWARPS = VA_BM / 16;  // warps a tile
constexpr int VA_RING = 4;       // input stages in the ring

struct VaF32 {
  using T = float;
  static constexpr int CK = 8;   // input channels a stage (32 bytes a pixel)
  static constexpr int WB = 16;  // bytes of a lane's B fragment: b0, b1 hi and lo
};
struct VaBf16 {
  using T = __nv_bfloat16;
  static constexpr int CK = 16;
  static constexpr int WB = 8;   // b0, b1 (two bf16 each)
};

template <class Op, int K, int BN>
struct VaGeom {
  static constexpr int NT = BN / 8;                    // n8 tiles
  static constexpr int SPIX = VA_BM + K - 1;           // staged pixels a stage
  static constexpr int IN_BYTES = SPIX * 32;
  static constexpr int W_ENTRIES = K * NT * 32;        // (kw, n tile, lane)
  static constexpr int W_BYTES = W_ENTRIES * Op::WB;
  static constexpr int W_VALS = K * Op::CK * BN;       // (n, c, kw), kw fastest
  static constexpr int VPT = (W_VALS + VA_THREADS - 1) / VA_THREADS;
  static constexpr int SLOT_BYTES = VA_SUB * IN_BYTES;  // a stage of both tiles
  static constexpr int LO_BYTES = Op::WB == 16 ? 2 * SLOT_BYTES : 0;  // f32: two stages' lo
  static constexpr size_t SMEM = (size_t)VA_RING * SLOT_BYTES + 2 * W_BYTES + LO_BYTES;
};

struct VaArgs {
  const void* x;      // forward: xp (B, Hin, Win, Cc); dx: dy (B, Hin, Win, Cc)
  const void* w;      // OIHW: forward (Cn, Cc, K, K); dx the forward's (Cc, Cn, K, K)
  const float* bias;  // forward only, or null
  void* y;            // (B, Hout, Wout, Cn)
  int B, Hin, Win, Cc, Cn, Hout, Wout;
  int dx, act, tw;    // tw: output columns a strip
};

struct VaTile {
  int b, x0, m0, n0;
  int r0, c0;  // the first position's row and column in the P-pitched strip
  bool valid;
};

// The walk: TS spatial tiles (image, strip, tile), N blocks slowest; a
// block's item is a pair of consecutive spatial tiles of one N block (the
// second missing past the last), so both share the stage's weights. Only
// what the stages use is kept (registers); va_tile works out the rest from
// the launch's arguments.
struct VaWalk {
  int P, PP, SPT, n_items;
  float p_inv;
  __device__ VaWalk(const VaArgs& a, int K, int CK, int BN) {
    P = a.tw + K - 1;
    p_inv = 1.f / P;
    const int TS = a.B * ((a.Wout + a.tw - 1) / a.tw) * ((a.Hout * P + VA_BM - 1) / VA_BM);
    PP = (TS + VA_SUB - 1) / VA_SUB;
    n_items = (a.Cn + BN - 1) / BN * PP;
    SPT = (a.Cc + CK - 1) / CK * K;
  }
  // s / P for 0 <= s < 2^20, by the float reciprocal and one correction
  __device__ __forceinline__ int div_p(int s) const {
    int d = __float2int_rz(s * p_inv);
    d += s - d * P >= P;
    d -= s - d * P < 0;
    return d;
  }
};

// Tile `sub` of item u.
template <int BN>
__device__ __forceinline__ VaTile va_tile(const VaArgs& a, const VaWalk& wk, int u, int sub) {
  const int n_strips = (a.Wout + a.tw - 1) / a.tw, MB = (a.Hout * wk.P + VA_BM - 1) / VA_BM;
  VaTile r;
  r.n0 = (u / wk.PP) * BN;
  int t = (u % wk.PP) * VA_SUB + sub;
  r.valid = t < a.B * n_strips * MB;
  r.m0 = (t % MB) * VA_BM;
  t /= MB;
  r.x0 = (t % n_strips) * a.tw;
  r.b = t / n_strips;
  r.r0 = r.m0 / wk.P;
  r.c0 = r.m0 - r.r0 * wk.P;
  return r;
}

// Stage the input of kernel row kh, channel chunk c of tile t: flattened
// pixels [m0 + kh * P, + SPIX) of the strip, 32 bytes each; threads lt =
// 0 .. nthreads - 1 of the tile's half of the block.
template <class Op, int K, int BN>
__device__ __forceinline__ void va_stage_input(const VaArgs& a, const VaWalk& wk, const VaTile& t,
                                               int c, int kh, uint32_t dst, bool vec, int lt,
                                               int nthreads) {
  using T = typename Op::T;
  constexpr int EH = 16 / sizeof(T);  // elements a 16-byte half
  const T* xb = static_cast<const T*>(a.x) + (size_t)t.b * a.Hin * a.Win * a.Cc;
  const int off = a.dx ? K - 1 : 0;   // dx: dy sits K - 1 pixels into its zero halo
  const int ch0 = c * Op::CK;
  for (int idx = lt; idx < VaGeom<Op, K, BN>::SPIX * 2; idx += nthreads) {
    const int p = idx >> 1, h = idx & 1;
    const int col = t.c0 + p, dr = wk.div_p(col);
    const int r = t.r0 + dr + kh - off, cc = t.x0 + col - dr * wk.P - off;
    const int ch = ch0 + h * EH;
    const bool in = r >= 0 && r < a.Hin && cc >= 0 && cc < a.Win && ch < a.Cc;
    const T* src = in ? xb + ((size_t)r * a.Win + cc) * a.Cc + ch : xb;
    const uint32_t d = dst + p * 32 + ((h ^ ((p >> 2) & 1)) << 4);
    if (vec) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      const uint4 v = in ? va_load16(src, ch, a.Cc) : make_uint4(0u, 0u, 0u, 0u);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d), "r"(v.x), "r"(v.y),
                   "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// f32: split the chunks this thread staged (va_stage_input's items) into
// TF32 hi, in place, and lo at the same offset of `lo`: after its own
// cp.async group has landed, no other thread's copy is read.
template <class Op, int K, int BN>
__device__ __forceinline__ void va_split_own(unsigned char* buf, unsigned char* lo, int lt,
                                             int nthreads) {
  for (int idx = lt; idx < VaGeom<Op, K, BN>::SPIX * 2; idx += nthreads) {
    const int p = idx >> 1;
    va_split16(buf, lo, p * 32 + (((idx & 1) ^ ((p >> 2) & 1)) << 4));
  }
}

// The next stage's weight slice into registers: value idx = (n, c, kw) of
// the slice (kw fastest, so a warp reads runs of K consecutive taps of the
// OIHW weight), the thread's VPT values. B[c][n] of tap (kh, kw) is the
// forward's w[n][c][kh][kw], dx's w[c][n][K-1-kh][K-1-kw]; zero outside
// the channels.
template <class Op, int K, int BN>
__device__ __forceinline__ void va_load_w(const VaArgs& a, uint32_t (&r)[VaGeom<Op, K, BN>::VPT],
                                          int chunk, int kh, int n0) {
  using G = VaGeom<Op, K, BN>;
  using T = typename Op::T;
  constexpr int KK = K * K;
  const T* w = static_cast<const T*>(a.w);
  const int ch0 = chunk * Op::CK;
  const int base = a.dx ? ch0 * a.Cn * KK + (K - 1 - kh) * K + K - 1 : ch0 * KK + kh * K;
  const int sc = a.dx ? a.Cn * KK : KK, sn = a.dx ? KK : a.Cc * KK, skw = a.dx ? -1 : 1;
#pragma unroll
  for (int e = 0; e < G::VPT; ++e) {
    const int idx = threadIdx.x + e * VA_THREADS;
    const int kw = idx % K, c = idx / K % Op::CK, n = n0 + idx / (K * Op::CK);
    const bool ok = (G::W_VALS % VA_THREADS == 0 || idx < G::W_VALS) && ch0 + c < a.Cc &&
                    n < a.Cn;
    r[e] = ok ? va_bits(w + (base + c * sc + n * sn + kw * skw)) : 0u;
  }
}

// ... and into the weight slot in fragment order: entry (kw, n tile, lane =
// 4 g + t) holds the lane's B fragment. f32 (m16n8k8): b0 = B[t][g], b1 =
// B[t + 4][g], each split, stored {b0 hi, b1 hi, b0 lo, b1 lo}; bf16
// (m16n8k16): b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g].
template <class Op, int K, int BN>
__device__ __forceinline__ void va_store_w(unsigned char* slot,
                                           const uint32_t (&r)[VaGeom<Op, K, BN>::VPT]) {
  using G = VaGeom<Op, K, BN>;
#pragma unroll
  for (int e = 0; e < G::VPT; ++e) {
    const int idx = threadIdx.x + e * VA_THREADS;
    if (G::W_VALS % VA_THREADS == 0 || idx < G::W_VALS) {
      const int kw = idx % K, c = idx / K % Op::CK, n = idx / (K * Op::CK);
      const int g = n & 7, nt = n >> 3;
      if constexpr (Op::WB == 16) {
        const int entry = (kw * G::NT + nt) * 32 + g * 4 + (c & 3);
        uint32_t hi, lo;
        va_split(r[e], hi, lo);
        uint32_t* w = reinterpret_cast<uint32_t*>(slot + entry * 16);
        w[c >> 2] = hi;
        w[2 + (c >> 2)] = lo;
      } else {
        const int entry = (kw * G::NT + nt) * 32 + g * 4 + ((c & 7) >> 1);
        *reinterpret_cast<unsigned short*>(slot + entry * 8 + (c >> 3) * 4 + (c & 1) * 2) =
            (unsigned short)r[e];
      }
    }
  }
}

// One stage's products: warp `wid` owns positions [16 wid, 16 wid + 16) of
// its tile (s_in, s_lo: that tile's part of the stage); tap kw's A fragment
// is the staged pixels shifted by kw.
// f32: s_in holds the stage's hi values, s_lo their lo values (va_split_own).
template <class Op, int K, int BN, class Hook>
__device__ __forceinline__ void va_compute(float (&acc)[BN / 8][4], uint32_t s_in, uint32_t s_lo,
                                           const unsigned char* s_w, int wid, int lane,
                                           Hook&& hook) {
  constexpr int NT = BN / 8;
  // ldmatrix x4: matrix j = lane / 8 is rows (j & 1) * 8 .. + 7, half j >> 1
  const int prow = wid * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int half = lane >> 4;
#pragma unroll
  for (int kw = 0; kw < K; ++kw) {
    const int p = prow + kw;
    const uint32_t off = p * 32 + ((half ^ ((p >> 2) & 1)) << 4);
    uint32_t a[4];
    va_ldsm_x4(a, s_in + off);
    if constexpr (Op::WB == 16) {
      uint32_t alo[4];
      va_ldsm_x4(alo, s_lo + off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = *reinterpret_cast<const uint4*>(s_w + ((kw * NT + nt) * 32 + lane) * 16);
        va_mma_3xtf32(acc[nt], a, alo, b.x, b.y, b.z, b.w);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = *reinterpret_cast<const uint2*>(s_w + ((kw * NT + nt) * 32 + lane) * 8);
        mma_bf16(acc[nt], a, b.x, b.y);
      }
    }
    if (kw < 4) hook(kw);  // the next stages' loads, in the shadow of this tap's products
  }
}

// Bias, activation and the output rounding of one tile's accumulators,
// stored to the NHWC output (positions past the strip or the image are
// not stored).
template <class Op, int K, int BN>
__device__ __forceinline__ void va_epilogue(const VaArgs& a, const VaWalk& wk, const VaTile& t,
                                            float (&acc)[BN / 8][4], int wid, int lane) {
  using T = typename Op::T;
  const int g = lane >> 2, tq = lane & 3;
  const bool pair_ok = (a.Cn & 1) == 0;
#pragma unroll
  if (!t.valid) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = t.m0 + wid * 16 + g + 8 * hh;
    const int i = m / wk.P, j = m % wk.P;
    if (j >= a.tw || t.x0 + j >= a.Wout || i >= a.Hout) continue;
    T* dst = static_cast<T*>(a.y) + (((size_t)t.b * a.Hout + i) * a.Wout + t.x0 + j) * a.Cn;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int n = t.n0 + nt * 8 + 2 * tq;
      if (n >= a.Cn) continue;
      float v0 = acc[nt][2 * hh], v1 = acc[nt][2 * hh + 1];
      if (a.bias) {
        v0 += a.bias[n];
        if (n + 1 < a.Cn) v1 += a.bias[n + 1];
      }
      v0 = apply_act(v0, a.act);
      v1 = apply_act(v1, a.act);
      if (pair_ok) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
        dst[n] = from_f32<T>(v0);
        if (n + 1 < a.Cn) dst[n + 1] = from_f32<T>(v1);
      }
    }
  }
}

// The next stage to stage (item p_u, its stage p_s, this half's tile p_t)
// and the next weights to read (item w_u, its stage w_s).
struct VaFeed {
  int p_u, p_s, w_u, w_s;
  VaTile p_t;
};

// Issue the copies of the next stage (this half of the block, its tile)
// into the ring slot at dst, and step to the stage after it.
template <class Op, int K, int BN>
__device__ __forceinline__ void va_stage_next(const VaArgs& a, const VaWalk& wk, VaFeed& f,
                                              uint32_t dst, int sub, int lt, bool vec) {
  using G = VaGeom<Op, K, BN>;
  if (f.p_t.valid)
    va_stage_input<Op, K, BN>(a, wk, f.p_t, f.p_s / K, f.p_s % K, dst + sub * G::IN_BYTES, vec,
                              lt, VA_THREADS / VA_SUB);
  if (++f.p_s == wk.SPT) {
    f.p_s = 0;
    f.p_u += gridDim.x;
    if (f.p_u < wk.n_items) f.p_t = va_tile<BN>(a, wk, f.p_u, sub);
  }
}

// Read the next weights into registers and step to the stage after them.
template <class Op, int K, int BN>
__device__ __forceinline__ void va_weights_next(const VaArgs& a, const VaWalk& wk, VaFeed& f,
                                                uint32_t (&r)[VaGeom<Op, K, BN>::VPT]) {
  va_load_w<Op, K, BN>(a, r, f.w_s / K, f.w_s % K, (f.w_u / wk.PP) * BN);
  if (++f.w_s == wk.SPT) {
    f.w_s = 0;
    f.w_u += gridDim.x;
  }
}

// Stage j's input landed for this thread's copies: split them (f32) into
// hi in place and lo into lo slot j % 2 (s_lo_sub: this half's part).
template <class Op, int K, int BN>
__device__ __forceinline__ void va_ready(unsigned char* smem, unsigned char* s_lo_sub, int j,
                                         int sub, int lt) {
  using G = VaGeom<Op, K, BN>;
  if constexpr (G::LO_BYTES > 0)
    va_split_own<Op, K, BN>(smem + (j % VA_RING) * G::SLOT_BYTES + sub * G::IN_BYTES,
                            s_lo_sub + (j & 1) * G::SLOT_BYTES, lt, VA_THREADS / VA_SUB);
}

// A persistent block walks items blockIdx.x, + gridDim.x, ... (a pair of
// tiles each: warps 0-5 the first, 6-11 the second); stage i of its walk is
// (item i / SPT, channel chunk, kernel row), kernel rows fastest. One
// barrier a stage: behind it every warp runs stage i's products, and
// between its taps' products each thread issues the loads of later stages,
// so they run in the products' shadow: it waits for its own copies of stage
// i + 1 and splits them (f32), stores stage i + 1's weights (read into
// registers one stage before), issues the copies of stage i + VA_RING - 1
// and reads stage i + 2's weights. The ring keeps VA_RING - 1 stages of
// input in flight.
template <class Op, int K, int BN>
__global__ void __launch_bounds__(VA_THREADS, 1) conv_valid_tc_kernel(const VaArgs a) {
  using G = VaGeom<Op, K, BN>;
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char va_smem[];
  const uint32_t s_in0 = smem_u32(va_smem);
  unsigned char* s_w0 = va_smem + VA_RING * G::SLOT_BYTES;
  unsigned char* s_lo = s_w0 + 2 * G::W_BYTES;  // f32: lo of stages i % 2
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sub = wid >= VA_TWARPS, wsub = wid - sub * VA_TWARPS;  // its tile, its 16 positions
  const int lt = threadIdx.x - sub * (VA_THREADS / VA_SUB);       // thread of this tile's half
  const VaWalk wk(a, K, Op::CK, BN);
  const int my_items =
      (int)blockIdx.x < wk.n_items ? (wk.n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int n_stages = my_items * wk.SPT;
  const bool vec = a.Cc % (16 / (int)sizeof(T)) == 0;

  // three places in the walk, each (item, stage of the item): the next
  // stage to stage (each half of the block stages its own tile of the
  // pair), the next weights to read, the stage being computed
  VaFeed f;
  f.p_u = f.w_u = blockIdx.x;
  f.p_s = f.w_s = 0;
  f.p_t = va_tile<BN>(a, wk, f.p_u, sub);
  int c_u = blockIdx.x, c_s = 0;
  unsigned char* s_lo_sub = s_lo + sub * G::IN_BYTES;

#pragma unroll 1
  for (int i = 0; i < VA_RING - 1; ++i) {
    if (i < n_stages) va_stage_next<Op, K, BN>(a, wk, f, s_in0 + i * G::SLOT_BYTES, sub, lt, vec);
    cp_async_commit();
  }
  uint32_t wr[G::VPT];
  if (n_stages > 0) {
    cp_async_wait<VA_RING - 2>();
    va_ready<Op, K, BN>(va_smem, s_lo_sub, 0, sub, lt);
    va_weights_next<Op, K, BN>(a, wk, f, wr);
    va_store_w<Op, K, BN>(s_w0, wr);
    if (n_stages > 1) va_weights_next<Op, K, BN>(a, wk, f, wr);
  }
  float acc[BN / 8][4];
  va_zero(acc);

#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    __syncthreads();  // stage i's input and weights in place; stage i - 1 read by all
    const bool more = i + 1 < n_stages;
    auto hook = [&](int kw) {
      if (kw == 0 && more) {
        cp_async_wait<VA_RING - 3>();  // this thread's copies of stage i + 1
        va_ready<Op, K, BN>(va_smem, s_lo_sub, i + 1, sub, lt);
      }
      if (kw == 1 && more) va_store_w<Op, K, BN>(s_w0 + ((i + 1) & 1) * G::W_BYTES, wr);
      if (kw == 2) {
        const int ip = i + VA_RING - 1;
        if (ip < n_stages)
          va_stage_next<Op, K, BN>(a, wk, f, s_in0 + (ip % VA_RING) * G::SLOT_BYTES, sub, lt, vec);
        cp_async_commit();
      }
      if (kw == (K > 3 ? 3 : K - 1) && i + 2 < n_stages) va_weights_next<Op, K, BN>(a, wk, f, wr);
    };
    va_compute<Op, K, BN>(acc, s_in0 + (i % VA_RING) * G::SLOT_BYTES + sub * G::IN_BYTES,
                          smem_u32(s_lo) + (i & 1) * G::SLOT_BYTES + sub * G::IN_BYTES,
                          s_w0 + (i & 1) * G::W_BYTES, wsub, lane, hook);
    if (++c_s == wk.SPT) {
      va_epilogue<Op, K, BN>(a, wk, va_tile<BN>(a, wk, c_u, sub), acc, wsub, lane);
      va_zero(acc);
      c_s = 0;
      c_u += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

template <class Op, int K, int BN>
int launch_valid_tc(const VaArgs& a, cudaStream_t s) {
  using G = VaGeom<Op, K, BN>;
  auto kern = conv_valid_tc_kernel<Op, K, BN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, VA_THREADS, G::SMEM);
    if (per_sm < 1) per_sm = 1;
  }
  const long P = a.tw + K - 1;
  const long ts = (long)a.B * ((a.Wout + a.tw - 1) / a.tw) * ((a.Hout * P + VA_BM - 1) / VA_BM);
  const long n_items = (ts + VA_SUB - 1) / VA_SUB * ((a.Cn + BN - 1) / BN);
  if (n_items < 1 || ts > (1L << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_items < (long)sms * per_sm ? n_items : (long)sms * per_sm);
  kern<<<grid, VA_THREADS, G::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// N blocks of 8, 16 or 32 output channels (the wrapper's pick).
template <int K>
int valid_tc_by_bn(int dtype, int bn, const VaArgs& a, cudaStream_t s) {
  if (dtype == DT_F32) {
    switch (bn) {
      case 8: return launch_valid_tc<VaF32, K, 8>(a, s);
      case 16: return launch_valid_tc<VaF32, K, 16>(a, s);
      case 32: return launch_valid_tc<VaF32, K, 32>(a, s);
    }
  } else if (dtype == DT_BF16) {
    switch (bn) {
      case 8: return launch_valid_tc<VaBf16, K, 8>(a, s);
      case 16: return launch_valid_tc<VaBf16, K, 16>(a, s);
      case 32: return launch_valid_tc<VaBf16, K, 32>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---- conv_valid_dw ----

constexpr int DW_QS = 64;    // output pixels of a row a stage
constexpr int DW_CB = 16;    // input channels a block (one m16 tile a warp)
constexpr int DW_RING = 4;

template <class Op, int K, int BN>
struct DwGeom {
  using T = typename Op::T;
  static constexpr int NT = BN / 8;
  static constexpr int THREADS = 32 * K;                  // warp w: kw = w
  static constexpr int CSX = DW_CB + 8;                   // staged xp pixel stride (elements)
  static constexpr int CSD = BN == 8 ? 8 : BN + 8;        // staged dy pixel stride
  static constexpr int XPIX = DW_QS + K - 1;
  static constexpr int X_BYTES = (XPIX * CSX * (int)sizeof(T) + 15) / 16 * 16;
  static constexpr int D_BYTES = DW_QS * CSD * (int)sizeof(T);
  static constexpr int STAGE = X_BYTES + D_BYTES;
  static constexpr int SLICE = K * DW_CB * BN;            // a block's partial sums
  static constexpr int LO_BYTES = sizeof(T) == 4 ? 2 * STAGE : 0;  // f32: two stages' lo
  static constexpr size_t SMEM = (size_t)DW_RING * STAGE + LO_BYTES;
};

struct DwArgs {
  const void* xp;     // (B, H + K - 1, W + K - 1, Cin)
  const void* dy;     // (B, H, W, Cout)
  float* part;        // [groups][chunks][SLICE] partial sums
  unsigned* ticket;   // [groups], zero before the launch; the last block resets it
  float* dw;          // (Cout, Cin, K, K) f32
  int B, H, W, Cin, Cout, chunks;
};

// Stage output row `row` (b * H + i), pixel segment `seg`, of group (kh,
// c0, n0): xp[b, i + kh, seg * QS + 0 .. XPIX - 1, c0 .. c0 + 15] and
// dy[b, i, seg * QS + 0 .. QS - 1, n0 .. n0 + BN - 1], zero outside.
template <class Op, int K, int BN>
__device__ __forceinline__ void dw_stage(const DwArgs& a, int row, int seg, int kh, int c0, int n0,
                                         unsigned char* dst, bool vec_x, bool vec_d) {
  using G = DwGeom<Op, K, BN>;
  using T = typename Op::T;
  constexpr int EH = 16 / sizeof(T);
  const int b = row / a.H, i = row % a.H;
  const int Hp = a.H + K - 1, Wp = a.W + K - 1;
  const int j0 = seg * DW_QS;
  const T* xrow = static_cast<const T*>(a.xp) + (((size_t)b * Hp + i + kh) * Wp) * a.Cin;
  const T* drow = static_cast<const T*>(a.dy) + (((size_t)b * a.H + i) * a.W) * a.Cout;
  const uint32_t sx = smem_u32(dst), sd = sx + G::X_BYTES;
  constexpr int XQ = DW_CB / EH;  // 16-byte pieces of a staged xp pixel
  for (int idx = threadIdx.x; idx < G::XPIX * XQ; idx += G::THREADS) {
    const int p = idx / XQ, q = idx % XQ;
    const int j = j0 + p, ch = c0 + q * EH;
    const bool in = j < Wp && ch < a.Cin;
    const T* src = in ? xrow + (size_t)j * a.Cin + ch : xrow;
    const uint32_t d = sx + (p * G::CSX + q * EH) * (int)sizeof(T);
    if (vec_x) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      const uint4 v = in ? va_load16(src, ch, a.Cin) : make_uint4(0u, 0u, 0u, 0u);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d), "r"(v.x), "r"(v.y),
                   "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
  constexpr int DQ = BN / EH > 0 ? BN / EH : 1;  // 16-byte pieces of a staged dy pixel
  for (int idx = threadIdx.x; idx < DW_QS * DQ; idx += G::THREADS) {
    const int p = idx / DQ, q = idx % DQ;
    const int j = j0 + p, ch = n0 + q * EH;
    const bool in = j < a.W && ch < a.Cout;
    const T* src = in ? drow + (size_t)j * a.Cout + ch : drow;
    const uint32_t d = sd + (p * G::CSD + q * EH) * (int)sizeof(T);
    if (vec_d) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      const uint4 v = in ? va_load16(src, ch, a.Cout) : make_uint4(0u, 0u, 0u, 0u);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d), "r"(v.x), "r"(v.y),
                   "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// f32: split the 16-byte pieces this thread staged (dw_stage's two loops,
// the same items) once its own copies have landed.
template <class Op, int K, int BN>
__device__ __forceinline__ void dw_split_own(unsigned char* stage, unsigned char* lo) {
  using G = DwGeom<Op, K, BN>;
  constexpr int XQ = DW_CB / 4, DQ = BN / 4;
  for (int idx = threadIdx.x; idx < G::XPIX * XQ; idx += G::THREADS)
    va_split16(stage, lo, (idx / XQ * G::CSX + idx % XQ * 4) * 4);
  for (int idx = threadIdx.x; idx < DW_QS * DQ; idx += G::THREADS)
    va_split16(stage, lo, G::X_BYTES + (idx / DQ * G::CSD + idx % DQ * 4) * 4);
}

// One stage's products of warp kw: A[cl][j] = xs[j + kw][cl], B[j][n] =
// ds[j][n], over the stage's DW_QS pixels.
// f32: `stage` holds the hi values, `lo` their lo values (dw_split_own).
template <class Op, int K, int BN, class Hook>
__device__ __forceinline__ void dw_compute(float (&acc)[BN / 8][4], const unsigned char* stage,
                                           const unsigned char* lo, int kw, int lane, Hook&& hook) {
  using G = DwGeom<Op, K, BN>;
  using T = typename Op::T;
  constexpr int NT = BN / 8;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
    const uint32_t* xh = reinterpret_cast<const uint32_t*>(stage);
    const uint32_t* xl = reinterpret_cast<const uint32_t*>(lo);
    const uint32_t* dh = reinterpret_cast<const uint32_t*>(stage + G::X_BYTES);
    const uint32_t* dl = reinterpret_cast<const uint32_t*>(lo + G::X_BYTES);
#pragma unroll
    for (int k0 = 0; k0 < DW_QS; k0 += 8) {
      const int i0 = (k0 + t + kw) * G::CSX + g, i1 = i0 + 4 * G::CSX;
      const uint32_t ahi[4] = {xh[i0], xh[i0 + 8], xh[i1], xh[i1 + 8]};
      const uint32_t alo[4] = {xl[i0], xl[i0 + 8], xl[i1], xl[i1 + 8]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j0 = (k0 + t) * G::CSD + nt * 8 + g, j1 = j0 + 4 * G::CSD;
        va_mma_3xtf32_acc(acc[nt], ahi, alo, dh[j0], dh[j1], dl[j0], dl[j1]);
      }
      if (k0 < 16) hook(k0 / 8);  // the next stages' loads, in these products' shadow
    }
  } else {
    const uint32_t sx = smem_u32(stage), sd = sx + G::X_BYTES;
    // ldmatrix.trans x4 of A: matrix j = lane / 8 is pixels (j >> 1) * 8 ..
    // + 7 (rows) by channels (j & 1) * 8 .. + 7; x2 of B: lanes 0-15 give
    // pixels 0-15 of the n tile's 8 channels
    const int ap = kw + ((lane >> 4) << 3) + (lane & 7), ac = ((lane >> 3) & 1) * 8;
    const int bp = lane & 15;
#pragma unroll
    for (int k0 = 0; k0 < DW_QS; k0 += 16) {
      uint32_t a[4];
      va_ldsm_x4_t(a, sx + ((k0 + ap) * G::CSX + ac) * 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        va_ldsm_x2_t(b0, b1, sd + ((k0 + bp) * G::CSD + nt * 8) * 2);
        mma_bf16(acc[nt], a, b0, b1);
      }
      if (k0 < 32) hook(k0 / 16);
    }
  }
}

template <class Op, int K, int BN>
__global__ void __launch_bounds__(32 * K, 1) conv_valid_dw_kernel(const DwArgs a) {
  using G = DwGeom<Op, K, BN>;
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  __shared__ unsigned s_last;
  const int lane = threadIdx.x & 31, kw = threadIdx.x >> 5;
  const int n_cb = (a.Cin + DW_CB - 1) / DW_CB;
  const int group = blockIdx.y;
  const int kh = group % K, cb = (group / K) % n_cb, nb = group / K / n_cb;
  const int c0 = cb * DW_CB, n0 = nb * BN;
  const size_t rows = (size_t)a.B * a.H;
  const int r0 = (int)(rows * blockIdx.x / a.chunks), r1 = (int)(rows * (blockIdx.x + 1) / a.chunks);
  const int n_seg = (a.W + DW_QS - 1) / DW_QS;
  const int n_stages = (r1 - r0) * n_seg;
  constexpr int EH = 16 / sizeof(T);
  const bool vec_x = a.Cin % EH == 0, vec_d = a.Cout % EH == 0 && BN >= EH;

  unsigned char* s_lo = dw_smem + DW_RING * G::STAGE;  // f32: lo of stages i % 2
#pragma unroll 1
  for (int i = 0; i < DW_RING - 1; ++i) {
    if (i < n_stages)
      dw_stage<Op, K, BN>(a, r0 + i / n_seg, i % n_seg, kh, c0, n0, dw_smem + i * G::STAGE,
                          vec_x, vec_d);
    cp_async_commit();
  }
  if (n_stages > 0) {  // stage 0's copies of this thread landed: split them (f32)
    cp_async_wait<DW_RING - 2>();
    if constexpr (G::LO_BYTES > 0) dw_split_own<Op, K, BN>(dw_smem, s_lo);
  }
  float acc[BN / 8][4], sp[BN / 8][4];
  va_zero(acc);
  // one barrier a stage; between the k-steps of stage i's products each
  // thread waits for its own copies of stage i + 1 and splits them (f32),
  // then issues the copies of stage i + DW_RING - 1
#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    __syncthreads();
    auto hook = [&](int ks) {
      if (ks == 0 && i + 1 < n_stages) {
        cp_async_wait<DW_RING - 3>();
        if constexpr (G::LO_BYTES > 0)
          dw_split_own<Op, K, BN>(dw_smem + ((i + 1) % DW_RING) * G::STAGE,
                                  s_lo + ((i + 1) & 1) * G::STAGE);
      }
      if (ks == 1) {
        const int ip = i + DW_RING - 1;
        if (ip < n_stages)
          dw_stage<Op, K, BN>(a, r0 + ip / n_seg, ip % n_seg, kh, c0, n0,
                              dw_smem + (ip % DW_RING) * G::STAGE, vec_x, vec_d);
        cp_async_commit();
      }
    };
    va_zero(sp);
    dw_compute<Op, K, BN>(sp, dw_smem + (i % DW_RING) * G::STAGE, s_lo + (i & 1) * G::STAGE, kw,
                          lane, hook);
    va_add(acc, sp);
  }
  cp_async_wait<0>();

  // this block's partial slice [kw][cl][n]: rows g, g + 8, columns 2t, 2t + 1
  float* part = a.part + ((size_t)group * a.chunks + blockIdx.x) * G::SLICE;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int n = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + (kw * DW_CB + g) * BN + n) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(part + (kw * DW_CB + g + 8) * BN + n) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.ticket + group, 1u) == (unsigned)a.chunks - 1u;
  __syncthreads();
  if (!s_last) return;
  // the group's last block: sum the chunks in chunk order, write OIHW
  __threadfence();
  const float* gpart = a.part + (size_t)group * a.chunks * G::SLICE;
  for (int e = threadIdx.x; e < G::SLICE; e += G::THREADS) {
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < a.chunks; ++c) s += __ldcg(gpart + (size_t)c * G::SLICE + e);
    const int n = e % BN, cl = (e / BN) % DW_CB, w = e / BN / DW_CB;
    const int co = n0 + n, ci = c0 + cl;
    if (co < a.Cout && ci < a.Cin) a.dw[((size_t)co * a.Cin + ci) * (K * K) + kh * K + w] = s;
  }
  if (threadIdx.x == 0) a.ticket[group] = 0u;
}

// per_sm non-null: only report how many blocks fit on a multiprocessor
// (the wrapper sizes the grid to one wave of them).
template <class Op, int K, int BN>
int launch_valid_dw(const DwArgs& a, cudaStream_t s, int* per_sm) {
  using G = DwGeom<Op, K, BN>;
  auto kern = conv_valid_dw_kernel<Op, K, BN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (per_sm) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, G::THREADS,
                                                                         G::SMEM);
  const long groups =
      (long)K * ((a.Cin + DW_CB - 1) / DW_CB) * ((a.Cout + BN - 1) / BN);
  if (groups > 65535 || a.chunks < 1 || (long)a.chunks > (long)a.B * a.H)
    return (int)cudaErrorInvalidValue;
  kern<<<dim3(a.chunks, (unsigned)groups), G::THREADS, G::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int valid_dw_by_bn(int dtype, int bn, const DwArgs& a, cudaStream_t s, int* per_sm) {
  if (dtype == DT_F32) {
    switch (bn) {
      case 8: return launch_valid_dw<VaF32, K, 8>(a, s, per_sm);
      case 16: return launch_valid_dw<VaF32, K, 16>(a, s, per_sm);
      case 32: return launch_valid_dw<VaF32, K, 32>(a, s, per_sm);
    }
  } else if (dtype == DT_BF16) {
    switch (bn) {
      case 8: return launch_valid_dw<VaBf16, K, 8>(a, s, per_sm);
      case 16: return launch_valid_dw<VaBf16, K, 16>(a, s, per_sm);
      case 32: return launch_valid_dw<VaBf16, K, 32>(a, s, per_sm);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern template int valid_tc_by_bn<3>(int, int, const VaArgs&, cudaStream_t);
extern template int valid_tc_by_bn<5>(int, int, const VaArgs&, cudaStream_t);
extern template int valid_tc_by_bn<7>(int, int, const VaArgs&, cudaStream_t);
extern template int valid_dw_by_bn<3>(int, int, const DwArgs&, cudaStream_t, int*);
extern template int valid_dw_by_bn<5>(int, int, const DwArgs&, cudaStream_t, int*);
extern template int valid_dw_by_bn<7>(int, int, const DwArgs&, cudaStream_t, int*);

}  // namespace mmif
