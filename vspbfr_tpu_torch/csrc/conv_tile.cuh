// The tile body shared by K1 / K1e (dense_conv.cu), K2 (dilated_conv.cu), K5
// (smart_fused.cu) and f32 K9 / K10 (stripe_conv.cu), and the PTX helpers
// they share with bf16 K9 / K10 (stripe_conv.cu, conv_pipe.cuh).
//
// A block owns TM output pixels (a TH x TW rectangle, TW a power of two) by
// TN output channels. Per pass over 64 bytes of input channels (CK = 32 in
// bf16, 16 in f32) it stages, with cp.async 16 bytes a copy, the input
// stripe the tile's taps read -- (TH + (KH-1) d) x (TW + (KW-1) d) pixels
// for taps spaced d apart, zero-filled outside the image and past Ci -- and
// the pass's (CK, TN) weight rows of every tap; it then runs one tile
// product per tap, a tap being only an offset into the stripe. Stripe rows
// are padded to 80 bytes and weight rows by 16 bytes, so that neither the
// fragment loads nor the FMA loads meet bank conflicts. Where Ci (or the
// weights' row) is no multiple of 16 bytes, or a pointer is not 16-byte
// aligned, the stage is filled by plain loads instead of cp.async. An input
// scale (B, Ci) multiplies the staged stripe in shared memory, in the
// input's dtype, after it arrives: the TPU kernel and the plain version
// round x * in_scale to the input's dtype there, so the weights are not
// scaled instead.
//
// The bodies that run the tile products:
// - bf16 (`MmaBody`): mma.sync m16n8k16 on the tensor cores, f32
//   accumulation. Eight warps in a WM x WN grid each own MT m16 by NT8 n8
//   tiles. ldmatrix.x4 takes each lane's own row address, so the shifted,
//   haloed pixel rows of a tap feed the A fragment directly; the weights
//   are staged (ci, co) as they lie in HWIO and reach the B fragment
//   through ldmatrix.x4.trans.
// - f32 (`FmaBody`): FMA on the CUDA cores (TF32 would not give the f32
//   result). Each thread owns PX pixels x G float4 channel groups; LPG
//   consecutive lanes share a pixel (a broadcast read) and cover LPG x 4
//   consecutive channels of a group, so the weight reads of a phase are
//   one contiguous 128-byte row segment and the stores fill whole
//   sectors.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace vspbfr {

// --- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; the bytes past `valid` (0..16) are zero-filled
// and the source is not read past them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void zero16(char* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// One 16-byte segment of a stripe or weight row: `valid` elements from src
// (0 .. 16 / sizeof(T)), zeros after them.
template <typename T>
__device__ __forceinline__ void load_seg(char* dst, const T* src, int valid,
                                         bool vec) {
  constexpr int E = 16 / (int)sizeof(T);
  valid = valid < 0 ? 0 : (valid > E ? E : valid);
  if (vec) {
    cp_async16(dst, src, valid * (int)sizeof(T));
  } else {
    T* d = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int k = 0; k < E; ++k) d[k] = k < valid ? src[k] : from_f<T>(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

namespace tile {

constexpr int NT = 256;                      // threads of a block
constexpr int kPassBytes = 64;               // input channels per pass
constexpr int kXRow = kPassBytes + 16;       // padded stripe row
constexpr int kXSegs = kPassBytes / 16;      // 16-byte copies per row
static_assert(NT % kXSegs == 0, "a thread keeps its segment of a row");

template <typename T>
constexpr int kCK = kPassBytes / (int)sizeof(T);   // channels per pass

// bf16 tile: WN warps across the channels, each NT8 n8 tiles and MT m16
// tiles.
template <int WN_, int NT8_, int MT_>
struct Mma {
  static constexpr int WN = WN_, NT8 = NT8_, MT = MT_, WM = 8 / WN_;
  static constexpr int TN = WN * NT8 * 8, TM = WM * MT * 16;
  static_assert(WM * WN == 8 && NT8 % 2 == 0, "8 warps, n16 B loads");
};

// f32 tile: LPG lanes per pixel, G float4 channel groups and PX pixels a
// lane.
template <int LPG_, int G_, int PX_>
struct Fma {
  static constexpr int LPG = LPG_, G = G_, PX = PX_;
  static constexpr int TN = LPG * G * 4, TM = PX * NT / LPG;
};

// The tiles of each dtype: by output channels of a block (64, 32, 16), and
// a 64-pixel one for images of at most 64 pixels.
template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  using N64 = Mma<2, 4, 4>;   // 256 px
  using N32 = Mma<1, 4, 4>;   // 512 px
  using N16 = Mma<1, 2, 2>;   // 256 px
  using Small = Mma<2, 4, 1>; // 64 px x 64 channels
};
template <>
struct Tiles<float> {
  using N64 = Fma<8, 2, 4>;   // 128 px
  using N32 = Fma<8, 1, 8>;   // 256 px
  using N16 = Fma<4, 1, 4>;   // 256 px
  using Small = Fma<8, 2, 2>; // 64 px x 64 channels
};

// Which tile a launch takes: the small one for images of at most 64
// pixels, else the narrowest channel tile that holds `cols` channels.
enum Pick : int { kN64 = 0, kN32 = 1, kN16 = 2, kSmall = 3 };
inline int pick_tile(int pixels, int cols) {
  if (pixels <= 64) return kSmall;
  if (cols <= 16) return kN16;
  if (cols <= 32) return kN32;
  return kN64;
}

// bytes of a staged weight row, padded by 16
template <typename T, class C>
__host__ __device__ constexpr int w_row() {
  return C::TN * (int)sizeof(T) + 16;
}

// The tile's shape for TM pixels over an OW-wide output: TW a power of two
// up to 16 (8 for a 64-pixel tile).
struct TileShape {
  int TH, TW;
};
inline TileShape tile_shape(int TM, int OW) {
  int tw = 1;
  while (tw < OW && tw < (TM >= 128 ? 16 : 8)) tw *= 2;
  return {TM / tw, tw};
}

// Bytes of shared memory of a block: stripe, weights, the pass's scales.
template <typename T, class C>
__host__ __device__ constexpr int smem_bytes(int SH, int SW, int taps) {
  return SH * SW * kXRow + taps * kCK<T> * w_row<T, C>() +
         kCK<T> * (int)sizeof(float);
}

// What one block's passes read: the stripe at (row0, col0) of image b, of
// SH x SW pixels, and taps KH x KW spaced d apart.
struct Pass {
  int H, W, Ci;
  int b, row0, col0, SH, SW;
  int KH, KW, d;
  bool vec_x;
};

// Where a 16-byte segment of a staged weight row comes from: its first
// element at tap 0, input channel 0 (`base`), the elements from one input
// channel to the next (`stride`), how many of its elements are weights
// (the rest are zero-filled), and whether cp.async may copy it.
template <typename T>
struct SegSrc {
  const T* base;
  int stride, valid;
  bool vec;
};

// The block's weight columns as one slice co0 .. co0 + TN of a (KH, KW,
// Ci, wCo) HWIO tensor.
template <typename T>
struct DenseCols {
  const T* w;
  int wCo, co0;
  bool vec;
  __device__ SegSrc<T> operator()(int col) const {
    const int co = co0 + col;
    return {w + co, wCo, wCo - co, vec};
  }
};

// --- bodies -----------------------------------------------------------------

template <class C>
struct MmaBody {
  static constexpr int MT = C::MT, NT8 = C::NT8, TN = C::TN;
  static constexpr int CK = kCK<__nv_bfloat16>;
  static constexpr int WROW = w_row<__nv_bfloat16, C>();
  float acc[MT][NT8][4];
  int a_row[MT];   // this lane's ldmatrix row (stripe index at tap 0, 0)
  int a_k, b_k, b_n, p0, c0;

  // TW: the pixels of a tile row; SW: the stripe's. A tile of more than
  // P pixels reads pixel P - 1 for the rest (its results are not stored).
  __device__ void init(int TW, int SW, int P = 1 << 30) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % C::WM, wn = warp / C::WM;
    p0 = wm * 16 * MT;
    c0 = wn * NT8 * 8;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      int p = p0 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      p = p < P ? p : P - 1;
      a_row[mi] = (p / TW) * SW + p % TW;
    }
    a_k = (lane >> 4) * 8;
    // ldmatrix.trans: lanes 8m .. 8m+7 address matrix m's rows (k), which
    // is k 0-7 / 8-15 (m & 1) of n 0-7 / 8-15 (m >> 1)
    b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
    b_n = c0 + (lane >> 4) * 8;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0.f;
  }

  __device__ void pass(const Pass& s, const char* xs, const char* ws) {
    for (int tap = 0; tap < s.KH * s.KW; ++tap) product(s, xs, ws, tap);
  }

  // the tile product of one tap
  __device__ __forceinline__ void product(const Pass& s, const char* xs,
                                          const char* ws, int tap) {
    const unsigned xs0 = smem_u32(xs), ws0 = smem_u32(ws);
    const int shift = ((tap / s.KW) * s.SW + tap % s.KW) * s.d;
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      unsigned a[MT][4], b[NT8][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], xs0 + (a_row[mi] + shift) * kXRow +
                               (kk + a_k) * 2);
#pragma unroll
      for (int nj = 0; nj < NT8 / 2; ++nj) {
        unsigned r[4];
        ldmatrix_x4_trans(r, ws0 + (tap * CK + kk + b_k) * WROW +
                                 (b_n + nj * 16) * 2);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT8; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // f(p, c, v): v[0..1] are the tile's pixel p at channels c, c + 1
  template <class F>
  __device__ void each(F&& f) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int ni = 0; ni < NT8; ++ni) {
          float v[2] = {acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]};
          f(p0 + mi * 16 + gr + half * 8, c0 + ni * 8 + 2 * t, v);
        }
  }
};

template <class C>
struct FmaBody {
  static constexpr int LPG = C::LPG, G = C::G, PX = C::PX;
  static constexpr int CK = kCK<float>;
  static constexpr int WROW = w_row<float, C>();
  float acc[PX][G][4];
  int row[PX];   // stripe index of each pixel at tap 0, 0
  int lc, pg;

  // as MmaBody::init
  __device__ void init(int TW, int SW, int P = 1 << 30) {
    lc = threadIdx.x % LPG;
    pg = threadIdx.x / LPG;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      int p = pg + (NT / LPG) * i;
      p = p < P ? p : P - 1;
      row[i] = (p / TW) * SW + p % TW;
    }
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][g][k] = 0.f;
  }

  __device__ void pass(const Pass& s, const char* xs, const char* ws) {
    for (int tap = 0; tap < s.KH * s.KW; ++tap) product(s, xs, ws, tap);
  }

  // the tile product of one tap
  __device__ __forceinline__ void product(const Pass& s, const char* xs,
                                          const char* ws, int tap) {
    const int shift = ((tap / s.KW) * s.SW + tap % s.KW) * s.d;
    const char* wtap = ws + tap * CK * WROW + lc * 16;
#pragma unroll 2
    for (int k4 = 0; k4 < CK; k4 += 4) {
      float4 a[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            xs + (row[i] + shift) * kXRow + k4 * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 bv[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          bv[g] = *reinterpret_cast<const float4*>(
              wtap + (k4 + q) * WROW + g * LPG * 16);
#pragma unroll
        for (int i = 0; i < PX; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4& ai = a[i];
            const float av = q == 0 ? ai.x : q == 1 ? ai.y
                           : q == 2 ? ai.z : ai.w;
            acc[i][g][0] = fmaf(av, bv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(av, bv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(av, bv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(av, bv[g].w, acc[i][g][3]);
          }
      }
    }
  }

  // f(p, c, v): v[0..3] are the tile's pixel p at channels c .. c + 3
  template <class F>
  __device__ void each(F&& f) const {
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v[4] = {acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]};
        f(pg + (NT / LPG) * i, g * LPG * 4 + lc * 4, v);
      }
  }
};

template <typename T, class C>
struct BodyOf;
template <class C>
struct BodyOf<__nv_bfloat16, C> {
  using type = MmaBody<C>;
};
template <class C>
struct BodyOf<float, C> {
  using type = FmaBody<C>;
};
template <typename T, class C>
using Body = typename BodyOf<T, C>::type;

// --- staging ----------------------------------------------------------------

// The stripe of one pass over input channels c0 .. c0 + CK: every element,
// zero-filled outside the image and past Ci. Each thread's pixel row and
// column are stepped, not divided out of its stripe index: a stripe can be
// several times its tile (K2's and K5's dilation-8 halos), and the address
// arithmetic is then much of a stage's instructions. A kernel that stages
// its stripe otherwise (K10's in-kernel padding) passes its own functor of
// this form to `run_passes`.
struct FullStripe {
  template <typename T>
  __device__ __forceinline__ void operator()(const T* __restrict__ x,
                                             const Pass& s, int c0,
                                             char* xs) const {
    constexpr int E = 16 / (int)sizeof(T);   // elements per segment
    constexpr int STEP = NT / kXSegs;        // pixels a trip
    const int tid = threadIdx.x;
    const int seg = tid % kXSegs;
    const int c = c0 + seg * E;
    const bool cin = c < s.Ci;
    const int dr = STEP / s.SW, dc = STEP % s.SW;
    int sp = tid / kXSegs;
    int r = sp / s.SW, col = sp % s.SW;
    const T* img = x + (size_t)s.b * s.H * s.W * s.Ci + c;
    for (; sp < s.SH * s.SW; sp += STEP) {
      const int iy = s.row0 + r, ix = s.col0 + col;
      const bool in = cin && (unsigned)iy < (unsigned)s.H &&
                      (unsigned)ix < (unsigned)s.W;
      const T* src = in ? img + ((size_t)iy * s.W + ix) * s.Ci : x;
      load_seg<T>(xs + sp * kXRow + seg * 16, src, in ? s.Ci - c : 0,
                  s.vec_x);
      r += dr;
      col += dc;
      if (col >= s.SW) {
        col -= s.SW;
        ++r;
      }
    }
  }
};

// The copies of one pass over input channels c0 .. c0 + CK: the stripe
// (`stripe`), the weights of every tap (the thread's weight segment from
// `wseg`, see SegSrc), and the pass's input scales (as f32; 0 past Ci).
template <typename T, class C, class Stripe>
__device__ __forceinline__ void stage_pass(const T* __restrict__ x,
                                           const SegSrc<T>& wseg,
                                           const T* __restrict__ isc,
                                           const Pass& s, int c0, char* xs,
                                           char* ws, float* iscs,
                                           const Stripe& stripe) {
  constexpr int E = 16 / (int)sizeof(T);   // elements per segment
  constexpr int CK = kCK<T>;
  constexpr int WSEGS = C::TN / E;         // 16-byte copies per weight row
  const int tid = threadIdx.x;
  stripe(x, s, c0, xs);
  const int rows = s.KH * s.KW * CK;
  static_assert(NT % WSEGS == 0, "a thread keeps its weight segment");
  const int seg = tid % WSEGS;
  for (int r = tid / WSEGS; r < rows; r += NT / WSEGS) {
    const int tap = r / CK, ci = c0 + r % CK;
    const bool in = ci < s.Ci && wseg.valid > 0;
    const T* src =
        in ? wseg.base + ((size_t)tap * s.Ci + ci) * wseg.stride : wseg.base;
    load_seg<T>(ws + r * w_row<T, C>() + seg * 16, src, in ? wseg.valid : 0,
                wseg.vec);
  }
  if (isc && tid < CK)
    iscs[tid] = c0 + tid < s.Ci ? to_f(isc[(size_t)s.b * s.Ci + c0 + tid])
                                : 0.f;
}

// The staged stripe times the pass's input scales, rounded to T (as
// x * in_scale is in the TPU kernel and the plain version).
template <typename T>
__device__ __forceinline__ void scale_stripe(const Pass& s, char* xs,
                                             const float* iscs) {
  constexpr int E = 16 / (int)sizeof(T);
  const int seg = threadIdx.x % kXSegs;
  float sc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) sc[k] = iscs[seg * E + k];
  for (int sp = threadIdx.x / kXSegs; sp < s.SH * s.SW; sp += NT / kXSegs) {
    T* p = reinterpret_cast<T*>(xs + sp * kXRow + seg * 16);
    float v[E];
    load_vec<E>(p, v);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] *= sc[k];
    store_vec<E>(p, v);
  }
}

// Every pass of a block: stage, wait, scale, run the tile products.
// `cols(c)` says where the weights of the block's column c lie (SegSrc);
// `stripe` stages each pass's stripe (FullStripe: every element).
template <typename T, class C, class Stripe = FullStripe>
__device__ __forceinline__ void run_passes(Body<T, C>& body,
                                           const T* __restrict__ x,
                                           const DenseCols<T>& cols,
                                           const T* __restrict__ isc,
                                           const Pass& s, char* smem,
                                           const Stripe& stripe = Stripe()) {
  constexpr int E = 16 / (int)sizeof(T);
  const SegSrc<T> wseg = cols((threadIdx.x % (C::TN / E)) * E);
  char* xs = smem;
  char* ws = xs + s.SH * s.SW * kXRow;
  float* iscs = reinterpret_cast<float*>(ws + s.KH * s.KW * kCK<T> *
                                                  w_row<T, C>());
  for (int c0 = 0; c0 < s.Ci; c0 += kCK<T>) {
    stage_pass<T, C>(x, wseg, isc, s, c0, xs, ws, iscs, stripe);
    cp_async_wait_all();
    __syncthreads();
    if (isc) {
      scale_stripe<T>(s, xs, iscs);
      __syncthreads();
    }
    body.pass(s, xs, ws);
    __syncthreads();
  }
}

// N consecutive channels of one output pixel, `valid` of them inside the
// tensor: one vector store when all are and `vec` (the address is then
// N-element aligned), else scalars.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, int valid, const float (&v)[N],
                                          bool vec) {
  if (vec && valid >= N) {
    if constexpr (std::is_same<T, float>::value && N == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value && N == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0],
                                                                     v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < valid) p[k] = from_f<T>(v[k]);
}

}  // namespace tile
}  // namespace vspbfr
