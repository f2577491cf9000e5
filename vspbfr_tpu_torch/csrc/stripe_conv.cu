// K9: stride-1 KHxKW convolution, NHWC x (KH, KW, Co, Ci) -> NHWC, explicit
// (possibly asymmetric) zero pads, as one tile product per tap over an
// input stripe staged in shared memory, f32 accumulation, output in x's
// dtype. K10: the same body for a 3x3 pad-1 conv with four ways of loading
// the stripe.
//
// Replaces the TPU kernels scripts/exp_pallas_conv.py:conv_pallas (K9: a
// haloed row stripe DMA'd into VMEM, then per tap one (pixels, Ci) @
// (Ci, Co) MXU dot) and scripts/exp_inkpad.py:run (K10: that body with the
// stripe loaded four ways, to find what zero padding inside the kernel
// costs against a padded copy in device memory).
//
// What bounds it on the H100: compute. At the scripts' shapes every input
// element feeds KH*KW*Co multiply-adds, far above the ~300 FLOP/byte ridge.
// Each block owns TH x TW = TM output pixels (TH a power of two: K10's
// h_t, so one block holds one stripe tile) by 64 output channels. Per pass
// over 64 bytes of input channels it stages the haloed input stripe
// (TH+KH-1) x (TW+KW-1) and the pass's weights for every tap with
// cp.async, 16 bytes a copy (rows padded to 80 bytes, so neither the
// fragment loads nor the FMA loads below meet bank conflicts), then runs
// one tile product per tap, the tap being only an offset into the stripe.
// The weights of a pass are staged by every block, so the larger TM the
// fewer bytes per multiply-add. One stage, so that two or three blocks
// share an SM and one block's copies overlap another's products: two
// stages (copies of the next pass in flight during this one) took twice
// the shared memory, left one block per SM and measured 8-27% slower on
// the H100 (PERF.md, section 6).
//
// - bf16: the tile products run on the tensor cores, mma.sync m16n8k16
//   (bf16 in, f32 accumulate), TM = 256. Eight warps in a 4 x 2 grid each
//   own 64 pixels x 32 channels; ldmatrix.x4 takes each lane's own row
//   address, so the shifted, haloed pixel rows of a tap feed the A fragment
//   directly.
// - f32: FMA on the CUDA cores (TF32 would not give the f32 result),
//   TM = 128. Each
//   thread owns 4 pixels x 8 channels and reads 16-byte vectors along the
//   channels; 8 consecutive lanes share a pixel (a broadcast) and cover 8
//   consecutive output channels (the stores fill whole sectors).
//
// The stripe load (template parameter LOAD):
// - kPredicated (K9, and K10 "legacy" on an input the wrapper padded in
//   device memory): every stripe element is copied, with a copy of 0 valid
//   bytes (zero fill) where it falls in the padding or past the image.
// - kInkpad (K10 "inkpad"): before the first pass the block zeroes the
//   halo in shared memory once -- the column halo where it lies outside the
//   image, and the first tile's top row and the last tile's bottom rows
//   (the first / middle / last-tile branches of exp_inkpad.py:67-83) --
//   and each pass copies only the interior rectangle, with no test per
//   element.
// - kNoMemset (K10 "nomemset", timing only): as kInkpad without zeroing the
//   column halo; output columns 0 and W-1 read whatever shared memory held.
// - kNoBranch (K10 "nobranch", timing only): every tile copies input rows
//   [s, s + TH + 2) with s = min(tile * TH, H - TH - 2) and no row shift;
//   the column halo is zeroed.
//
// Input channels that are not a multiple of the pass are zero-filled in
// shared memory (the copy's valid bytes); output channels past Co get zero
// weights and are not stored; pixels past the image are not stored. Where
// Ci * itemsize is not a multiple of 16 bytes, or a pointer is not 16-byte
// aligned, the stage is filled by plain loads instead of cp.async.
#include "conv_tile.cuh"

namespace vspbfr {
namespace {

constexpr int TN = 64;                       // output channels of a block
constexpr int NT = 256;                      // threads of a block
constexpr int kPassBytes = 64;               // input channels per pass
constexpr int kRowBytes = kPassBytes + 16;   // padded stripe / weight row
constexpr int kSegs = kPassBytes / 16;       // 16-byte copies per row
constexpr int kRowsPerSweep = NT / kSegs;    // rows one sweep of NT copies
static_assert(kRowsPerSweep == TN, "one sweep stages one tap's weights");

enum Load : int { kPredicated = 0, kInkpad = 1, kNoMemset = 2, kNoBranch = 3 };

struct Geom {
  int H, W, Ci, Co, KH, KW, py0, px0, OH, OW;
  int TH, TW, SH, SW;               // tile and stripe sides
  int tiles_x, tiles_y, co_tiles;
  int vec;                          // cp.async usable
};

// The accumulator and the per-pass tile products of each dtype.
template <typename T>
struct Body;

// bf16 on the tensor cores: warp (wm, wn) owns pixels wm*64 .. +64 and
// channels wn*32 .. +32 as MT x 4 m16n8 tiles.
template <>
struct Body<__nv_bfloat16> {
  static constexpr int TM = 256;
  static constexpr int MT = TM / 64;   // m16 tiles of a warp
  float acc[MT][4][4];
  int a_row[MT];    // this lane's ldmatrix row (stripe index at tap 0, 0)
  int a_k, b_n, b_k;
  int wm, wn;

  __device__ void init(const Geom& g) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = warp & 3;
    wn = warp >> 2;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int p = wm * 16 * MT + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      a_row[mi] = (p / g.TW) * g.SW + p % g.TW;
    }
    a_k = (lane >> 4) * 8;
    b_n = wn * 32 + (lane & 7) + (lane >> 4) * 8;
    b_k = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0.f;
  }

  __device__ void pass(const Geom& g, const char* xs, const char* ws) {
    const unsigned xs0 = smem_u32(xs), ws0 = smem_u32(ws);
    for (int tap = 0; tap < g.KH * g.KW; ++tap) {
      const int shift = (tap / g.KW) * g.SW + tap % g.KW;
#pragma unroll
      for (int kk = 0; kk < kPassBytes / 2; kk += 16) {
        unsigned a[MT][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldmatrix_x4(a[mi], xs0 + (a_row[mi] + shift) * kRowBytes +
                                 (kk + a_k) * 2);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4(r, ws0 + (tap * TN + b_n + nj * 16) * kRowBytes +
                             (kk + b_k) * 2);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  }

  __device__ void store(const Geom& g, __nv_bfloat16* y, int b, int oy0,
                        int ox0, int co0) {
    const int lane = threadIdx.x & 31;
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = wm * 16 * MT + mi * 16 + gr + half * 8;
        const int oy = oy0 + p / g.TW, ox = ox0 + p % g.TW;
        if (oy >= g.OH || ox >= g.OW) continue;
        __nv_bfloat16* yr = y + (((size_t)b * g.OH + oy) * g.OW + ox) * g.Co;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int co = co0 + wn * 32 + ni * 8 + 2 * t;
          const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
          if (co + 1 < g.Co && (g.Co & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(yr + co) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < g.Co) yr[co] = __float2bfloat16(v0);
            if (co + 1 < g.Co) yr[co + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
};

// f32 on the CUDA cores: lane group (warp*4 + lane/8) owns pixels
// pg + 32 i, lane % 8 owns channels tc + 8 j.
template <>
struct Body<float> {
  static constexpr int TM = 128;
  float acc[4][8];
  int row[4];   // stripe index of each pixel at tap 0, 0
  int tc, pg;

  __device__ void init(const Geom& g) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    tc = lane & 7;
    pg = warp * 4 + (lane >> 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg + 32 * i;
      row[i] = (p / g.TW) * g.SW + p % g.TW;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ void pass(const Geom& g, const char* xs, const char* ws) {
    for (int tap = 0; tap < g.KH * g.KW; ++tap) {
      const int shift = (tap / g.KW) * g.SW + tap % g.KW;
      const char* wrow = ws + (tap * TN + tc) * kRowBytes;
#pragma unroll
      for (int k4 = 0; k4 < kPassBytes; k4 += 16) {
        float4 a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              xs + (row[i] + shift) * kRowBytes + k4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(wrow + 8 * j * kRowBytes +
                                                   k4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float s = acc[i][j];
            s = fmaf(a[i].x, bv[j].x, s);
            s = fmaf(a[i].y, bv[j].y, s);
            s = fmaf(a[i].z, bv[j].z, s);
            s = fmaf(a[i].w, bv[j].w, s);
            acc[i][j] = s;
          }
      }
    }
  }

  __device__ void store(const Geom& g, float* y, int b, int oy0, int ox0,
                        int co0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg + 32 * i;
      const int oy = oy0 + p / g.TW, ox = ox0 + p % g.TW;
      if (oy >= g.OH || ox >= g.OW) continue;
      float* yr = y + (((size_t)b * g.OH + oy) * g.OW + ox) * g.Co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + tc + 8 * j;
        if (co < g.Co) yr[co] = acc[i][j];
      }
    }
  }
};

// The copies of one pass: the stripe (kPredicated: every element, zero
// fill outside the image; otherwise only the rectangle [r_lo, r_hi) x
// [c_lo, c_hi), whose halo was zeroed once) and the weights of every tap.
// A thread always copies segment `seg` of its rows; rows advance by
// kRowsPerSweep with no division.
template <typename T, int LOAD>
__device__ __forceinline__ void stage_pass(
    const T* __restrict__ x, const T* __restrict__ wt, const Geom& g, int b,
    int row0, int col0, int co0, int c0, int r_lo, int r_hi, int c_lo,
    int c_hi, char* xs, char* ws) {
  constexpr int E = 16 / (int)sizeof(T);   // elements per segment
  const int seg = threadIdx.x % kSegs, r0 = threadIdx.x / kSegs;
  const int c = c0 + seg * E;
  const bool vec = g.vec != 0;
  // the rectangle this pass copies, and where a thread's row starts in it
  const int rw = LOAD == kPredicated ? g.SW : c_hi - c_lo;
  const int nrows = LOAD == kPredicated ? g.SH * g.SW
                                        : (r_hi - r_lo) * max(rw, 0);
  if (nrows > 0) {
    const int step_r = kRowsPerSweep / rw, step_c = kRowsPerSweep % rw;
    int sr = (LOAD == kPredicated ? 0 : r_lo) + r0 / rw;
    int sc = (LOAD == kPredicated ? 0 : c_lo) + r0 % rw;
    const int c_end = LOAD == kPredicated ? g.SW : c_hi;
    for (int q = r0; q < nrows; q += kRowsPerSweep) {
      const int iy = row0 + sr, ix = col0 + sc;
      bool in = c < g.Ci;
      if constexpr (LOAD == kPredicated)
        in = in && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const T* src =
          in ? x + (((size_t)b * g.H + iy) * g.W + ix) * g.Ci + c : x;
      load_seg<T>(xs + (sr * g.SW + sc) * kRowBytes + seg * 16, src,
                  in ? g.Ci - c : 0, vec);
      sr += step_r;
      sc += step_c;
      if (sc >= c_end) {
        sc -= rw;
        ++sr;
      }
    }
  }
  // weights: one sweep per tap, this thread's row is output channel r0
  const int co = co0 + r0;
  const bool in = co < g.Co && c < g.Ci;
  const T* src = in ? wt + (size_t)co * g.Ci + c : wt;
  const size_t tap_stride = (size_t)g.Co * g.Ci;
  char* dst = ws + r0 * kRowBytes + seg * 16;
  for (int tap = 0; tap < g.KH * g.KW; ++tap) {
    load_seg<T>(dst + tap * TN * kRowBytes, in ? src + tap * tap_stride : wt,
                in ? g.Ci - c : 0, vec);
  }
}

// shared memory of a block: the stripe and every tap's weights
constexpr int smem_bytes(int SH, int SW, int taps) {
  return (SH * SW + taps * TN) * kRowBytes;
}

template <typename T, int LOAD>
__global__ void __launch_bounds__(NT)
stripe_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   T* __restrict__ y, Geom g) {
  extern __shared__ uint4 smem_raw[];
  char* xs = reinterpret_cast<char*>(smem_raw);      // [SH * SW][kRowBytes]
  char* ws = xs + g.SH * g.SW * kRowBytes;           // [taps * TN][kRowBytes]
  constexpr int CK = kPassBytes / (int)sizeof(T);    // channels per pass
  const int b = blockIdx.y;
  const int co_tile = blockIdx.x % g.co_tiles;
  const int pix_tile = blockIdx.x / g.co_tiles;
  const int tile_y = pix_tile / g.tiles_x, tile_x = pix_tile % g.tiles_x;
  const int oy0 = tile_y * g.TH, ox0 = tile_x * g.TW, co0 = co_tile * TN;

  // stripe row sr holds input row row0 + sr, stripe column sc input column
  // col0 + sc
  const int col0 = ox0 - g.px0;
  int row0 = oy0 - g.py0;
  // the rectangle each pass copies (kPredicated: all of it, tested per
  // element)
  int r_lo = 0, r_hi = g.SH;
  const int c_lo = max(0, -col0), c_hi = min(g.SW, g.W - col0);
  if constexpr (LOAD == kNoBranch) {
    row0 = min(oy0, g.H - g.SH);
  } else if constexpr (LOAD != kPredicated) {
    if (tile_y == 0) r_lo = g.py0;                             // first tile
    if (tile_y == g.tiles_y - 1) r_hi = min(g.SH, g.H - row0);  // last tile
  }

  if constexpr (LOAD != kPredicated) {
    // in-kernel padding: zero the halo once; no pass writes it
    for (int e = threadIdx.x; e < g.SH * g.SW * kSegs; e += NT) {
      const int sp = e / kSegs, seg = e % kSegs;
      const int sr = sp / g.SW, sc = sp % g.SW;
      const bool row_pad = sr < r_lo || sr >= r_hi;
      const bool col_pad = sc < c_lo || sc >= c_hi;
      const bool zero_cols = LOAD != kNoMemset;
      if (row_pad || (col_pad && zero_cols))
        zero16(xs + sp * kRowBytes + seg * 16);
    }
  }

  Body<T> body;
  body.init(g);
  for (int c0 = 0; c0 < g.Ci; c0 += CK) {
    stage_pass<T, LOAD>(x, wt, g, b, row0, col0, co0, c0, r_lo, r_hi, c_lo,
                        c_hi, xs, ws);
    cp_async_wait_all();
    __syncthreads();
    body.pass(g, xs, ws);
    __syncthreads();
  }
  body.store(g, y, b, oy0, ox0, co0);
}

template <typename T, int LOAD>
int launch(const void* x, const void* wt, void* y, const Geom& g, int B,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g.SH, g.SW, g.KH * g.KW);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(stripe_conv_kernel<T, LOAD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)g.tiles_x * g.tiles_y * g.co_tiles;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  stripe_conv_kernel<T, LOAD><<<dim3((unsigned)blocks, B), NT, smem,
                                stream>>>((const T*)x, (const T*)wt, (T*)y, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int load, const void* x, const void* wt, void* y, const Geom& g,
             int B, cudaStream_t s) {
  switch (load) {
    case kPredicated: return launch<T, kPredicated>(x, wt, y, g, B, s);
    case kInkpad: return launch<T, kInkpad>(x, wt, y, g, B, s);
    case kNoMemset: return launch<T, kNoMemset>(x, wt, y, g, B, s);
    case kNoBranch: return launch<T, kNoBranch>(x, wt, y, g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dtype_tile_pixels(int dtype) {
  return dtype == kF32 ? Body<float>::TM : Body<__nv_bfloat16>::TM;
}

}  // namespace
}  // namespace vspbfr

// x (B, H, W, Ci), wt (KH, KW, Co, Ci), y (B, OH, OW, Co), all in the dtype
// (0 f32, 1 bf16). load: 0 predicated (pads py0 / px0 tested per element),
// 1 inkpad, 2 nomemset, 3 nobranch (1-3: 3x3, pads 1, OH = H, OW = W).
// TH, the tile's rows, is a power of two dividing the dtype's tile (128
// pixels in f32, 256 in bf16). A kernel whose stripe and weights exceed a
// block's 227 KB of shared memory is refused.
extern "C" int vspbfr_stripe_conv(const void* x, const void* wt, void* y,
                                  int dtype, int load, int B, int H, int W,
                                  int Ci, int Co, int KH, int KW, int py0,
                                  int px0, int OH, int OW, int TH,
                                  void* stream) {
  using namespace vspbfr;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  const int tm = dtype_tile_pixels(dtype);
  if (TH < 1 || TH > tm || tm % TH || (TH & (TH - 1)))
    return (int)cudaErrorInvalidValue;
  if (load != kPredicated &&
      (KH != 3 || KW != 3 || py0 != 1 || px0 != 1 || OH != H || OW != W))
    return (int)cudaErrorInvalidValue;
  if (load == kNoBranch && H < TH + 2) return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == kF32 ? 4 : 2;
  Geom g;
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.KH = KH; g.KW = KW;
  g.py0 = py0; g.px0 = px0; g.OH = OH; g.OW = OW;
  g.TH = TH; g.TW = tm / TH; g.SH = TH + KH - 1; g.SW = g.TW + KW - 1;
  g.tiles_x = (OW + g.TW - 1) / g.TW;
  g.tiles_y = (OH + TH - 1) / TH;
  g.co_tiles = (Co + TN - 1) / TN;
  g.vec = (Ci * itemsize) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
          (uintptr_t)wt % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return dispatch<float>(load, x, wt, y, g, B, s);
  return dispatch<__nv_bfloat16>(load, x, wt, y, g, B, s);
}
