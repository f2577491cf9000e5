// K9: stride-1 KHxKW convolution, NHWC x -> NHWC, explicit (possibly
// asymmetric) zero pads, as one tile product per tap over an input stripe
// staged in shared memory, f32 accumulation, output in x's dtype. K10: the
// same kernel for a 3x3 pad-1 conv with four ways of loading the stripe.
//
// Replaces the TPU kernels scripts/exp_pallas_conv.py:conv_pallas (K9: a
// haloed row stripe DMA'd into VMEM, then per tap one (pixels, Ci) @
// (Ci, Co) MXU dot) and scripts/exp_inkpad.py:run (K10: that body with the
// stripe loaded four ways, to find what zero padding inside the kernel
// costs against a padded copy in device memory).
//
// What bounds it on the H100: compute. At the scripts' shapes every input
// element feeds KH*KW*Co multiply-adds, far above the ~300 FLOP/byte ridge.
// The launch plan (tile, stripe and ring sizes, which producer) comes from
// ops/stripe_conv.py:stripe_plan, field for field as `Plan` below.
//
// bf16: a warp-specialised block of three warpgroups on the tensor cores.
// - One producer warpgroup (setmaxnreg 40) fills two rings in shared
//   memory, each stage guarded by a full and an empty mbarrier: per chunk of
//   64 input channels, the haloed input stripe (TH + KH - 1) x (TW + KW - 1)
//   pixels x 128 bytes; per (chunk, tap), that tap's (64 ci x N co) weight
//   box. With TMA (Ci a multiple of 8, pointers 16-byte aligned) one thread
//   issues a 4-D box over x (C, W, H, B) at the stripe's origin and a 3-D
//   box over the (KH*KW, Co, Ci) weights; the hardware zero-fills the pads,
//   the halo past the image, the channels past Ci and the columns past Co,
//   so nothing is tested per element. Otherwise the warpgroup's 128 threads
//   write the same stages with plain loads and zero fill.
// - Two consumer warpgroups (setmaxnreg 232) own M/2 pixels each by N
//   output channels: wgmma m64nNk16 with A from registers (each lane's
//   ldmatrix.x4 row address is its own shifted, haloed pixel row, so a tap
//   is only an offset into the stripe) and B, the weight stage, as a
//   K-major operand. The next (chunk, tap)'s fragments load while this
//   one's group runs; the group is waited for before the next is issued,
//   and its weight stage is then released (a stripe after its last tap's
//   fragments are loaded). With a group left in flight behind the next
//   one, the 128-accumulator tiles came out wrong on the H100 (the
//   accumulators crossed the loop's back edge while a group still wrote
//   them).
// - Every stage is 128-byte rows in the 128-byte swizzle (conv_pipe.cuh), so
//   the fragment loads meet no bank conflicts and B needs no transpose.
// - Tiles (M pixels x N channels): 256 x 64, 256 x 128, 128 x 256 and
//   128 x 128 (thin tiles); a stripe serves every tap of its chunk, and each
//   is staged once per N output channels.
//
// f32: FMA on the CUDA cores (TF32 would not give the f32 result) through
// the tile body K1 and K2 share (conv_tile.cuh, FmaBody 128 px x 64
// channels, the HWIO weights of every tap staged per pass), one stage per
// pass.
//
// The stripe load (LOAD), K10's variants:
// - kPredicated (K9, and K10 "legacy" on an input the wrapper padded in
//   device memory): the stripe at (oy0 - py0, ox0 - px0), zeros outside
//   the image.
// - kInkpad (K10 "inkpad") and kNoMemset ("nomemset", timing only): on the
//   TMA path the same box as kPredicated: the hardware's out-of-bounds fill
//   is the in-kernel padding, and nomemset's columns 0 and W-1 come out as
//   inkpad's. In f32 the block zeroes the halo in shared memory once -- the
//   column halo where it lies outside the image (not for kNoMemset, whose
//   output columns 0 and W-1 then read whatever shared memory held) and the
//   first tile's top row and the last tile's bottom rows (the first /
//   middle / last-tile branches of exp_inkpad.py:67-83) -- and each pass
//   copies only the interior rectangle.
// - kNoBranch (K10 "nobranch", timing only): every tile reads input rows
//   [s, s + TH + 2) with s = min(tile * TH, H - TH - 2) and no row shift;
//   the column halo is zero.
//
// Output channels past Co get zero weights and are not stored; pixels past
// the image are not stored.
#include <string.h>

#include "conv_pipe.cuh"

namespace vspbfr {
namespace {

using namespace tile;

enum Load : int { kPredicated = 0, kInkpad = 1, kNoMemset = 2, kNoBranch = 3 };

// The launch plan of ops/stripe_conv.py:stripe_plan, in its PLAN_FIELDS
// order. grid: the blocks launched, each taking tiles grid apart (bf16; f32
// launches one block a tile). producer: bf16 1 = TMA, 0 = plain loads; f32
// 1 = cp.async, 0 = plain loads. The ring fields are bf16's (f32: one stage
// of the stripe and of every tap's weights).
struct Plan {
  int B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW;
  int M, N, TH, TW, SH, SW, tiles_x, tiles_y, co_tiles, grid;
  int producer, stripe_stages, w_stages, stripe_bytes, w_bytes, smem;
};
constexpr int kPlanFields = 27;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is ints");

constexpr int kSmemLimit = 227 * 1024;
constexpr int kBoxLimit = 256;   // TMA's largest box side

// The block's output tile and the input row / column of its stripe's
// first element.
struct Origin {
  int b, oy0, ox0, co0, row0, col0, tile_y;
};

// tile t: output channels fastest, then columns, rows, images
template <int LOAD>
__device__ __forceinline__ Origin origin(const Plan& g, int N, int t) {
  Origin o;
  const int co_tile = t % g.co_tiles;
  t /= g.co_tiles;
  o.ox0 = (t % g.tiles_x) * g.TW;
  t /= g.tiles_x;
  o.tile_y = t % g.tiles_y;
  o.b = t / g.tiles_y;
  o.oy0 = o.tile_y * g.TH;
  o.co0 = co_tile * N;
  o.col0 = o.ox0 - g.px0;
  o.row0 = LOAD == kNoBranch ? min(o.oy0, g.H - g.SH) : o.oy0 - g.py0;
  return o;
}

// --- bf16: TMA ring, wgmma --------------------------------------------------

constexpr int kChunk = 64;     // input channels of a stage: one 128-byte row
constexpr int kRow = 128;
constexpr int kWg = 128;       // threads of a warpgroup
constexpr int kThreads = 3 * kWg;
constexpr int kConsumerWarps = 8;
// the store's staging: per consumer warp its 16 accumulator rows by up to
// 128 channels in bf16
constexpr int kEpiRows = 16, kEpiSlab = 128;
constexpr int kEpiWarpBytes = kEpiRows * kEpiSlab * 2;
constexpr int kEpiBytes = kConsumerWarps * kEpiWarpBytes;

// MW m64 blocks of pixels per consumer warpgroup, N output channels
template <int MW_, int N_>
struct WgTile {
  static constexpr int MW = MW_, N = N_, M = 2 * 64 * MW;
  static_assert(MW * N <= 256, "128 accumulators a thread at most");
};

// The bf16 stages in shared memory: the stripe ring, the weight ring (both
// 1024-byte aligned), the store's staging, then the barriers.
struct Rings {
  unsigned stripes, weights;                   // shared addresses
  char* stripes_g;                             // the same, generic
  char* weights_g;
  char* epi;
  uint64_t *s_full, *s_empty, *w_full, *w_empty;
};

__device__ __forceinline__ Rings rings(const Plan& g, char* raw) {
  Rings r;
  const unsigned raw_s = smem_u32(raw);
  const unsigned pad = ((raw_s + 1023u) & ~1023u) - raw_s;
  r.stripes = raw_s + pad;
  r.stripes_g = raw + pad;
  r.weights = r.stripes + g.stripe_stages * g.stripe_bytes;
  r.weights_g = r.stripes_g + g.stripe_stages * g.stripe_bytes;
  r.epi = r.weights_g + g.w_stages * g.w_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(r.epi + kEpiBytes);
  r.s_full = bars;
  r.s_empty = bars + g.stripe_stages;
  r.w_full = bars + 2 * g.stripe_stages;
  r.w_empty = bars + 2 * g.stripe_stages + g.w_stages;
  return r;
}

// A ring position: stage and the parity of its current round.
struct Slot {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ int tile_count(const Plan& g) {
  return g.B * g.tiles_y * g.tiles_x * g.co_tiles;
}

// TMA producer (one thread): for each of the block's tiles, per chunk its
// stripe, then each tap's weights.
template <class Tl, int LOAD>
__device__ __forceinline__ void produce_tma(const Plan& g, const Rings& r,
                                            const CUtensorMap* xmap,
                                            const CUtensorMap* wmap) {
  const int chunks = (g.Ci + kChunk - 1) / kChunk, taps = g.KH * g.KW;
  const unsigned stripe_tx = g.SH * g.SW * kRow, w_tx = Tl::N * kRow;
  Slot s, w;
  for (int t = blockIdx.x; t < tile_count(g); t += gridDim.x) {
    const Origin o = origin<LOAD>(g, Tl::N, t);
    for (int c = 0; c < chunks; ++c) {
      pipe::mbar_wait(&r.s_empty[s.stage], s.phase ^ 1);
      pipe::mbar_expect_tx(&r.s_full[s.stage], stripe_tx);
      pipe::tma_load_4d(r.stripes + s.stage * g.stripe_bytes, xmap,
                        &r.s_full[s.stage], c * kChunk, o.col0, o.row0, o.b);
      s.next(g.stripe_stages);
      for (int tap = 0; tap < taps; ++tap) {
        pipe::mbar_wait(&r.w_empty[w.stage], w.phase ^ 1);
        pipe::mbar_expect_tx(&r.w_full[w.stage], w_tx);
        pipe::tma_load_3d(r.weights + w.stage * g.w_bytes, wmap,
                          &r.w_full[w.stage], c * kChunk, o.co0, tap);
        w.next(g.w_stages);
      }
    }
  }
}

// 8 consecutive channels from c of one row of a bf16 tensor, `valid` of
// them real, the rest zero, as one 16-byte chunk
__device__ __forceinline__ uint4 gather8(const __nv_bfloat16* src, int valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < valid) e[k] = src[k];
  return v;
}

// Plain producer (the warpgroup's 128 threads): the same stages in the same
// swizzled layout, element by element, for inputs TMA cannot take.
template <class Tl, int LOAD>
__device__ __forceinline__ void produce_plain(
    const Plan& g, const Rings& r, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wt) {
  const int chunks = (g.Ci + kChunk - 1) / kChunk, taps = g.KH * g.KW;
  const int i0 = threadIdx.x;
  Slot s, w;
  for (int t = blockIdx.x; t < tile_count(g); t += gridDim.x) {
    const Origin o = origin<LOAD>(g, Tl::N, t);
    for (int c = 0; c < chunks; ++c) {
      pipe::mbar_wait(&r.s_empty[s.stage], s.phase ^ 1);
      char* xs = r.stripes_g + s.stage * g.stripe_bytes;
      for (int e = i0; e < g.SH * g.SW * 8; e += kWg) {
        const int row = e >> 3, q = e & 7;
        const int iy = o.row0 + row / g.SW, ix = o.col0 + row % g.SW;
        const int ci = c * kChunk + q * 8;
        const bool in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        const __nv_bfloat16* src =
            x + (((size_t)o.b * g.H + iy) * g.W + ix) * g.Ci + ci;
        *reinterpret_cast<uint4*>(xs + pipe::sw128(0, row, q)) =
            gather8(src, in ? g.Ci - ci : 0);
      }
      pipe::fence_proxy_async();
      pipe::mbar_arrive(&r.s_full[s.stage]);
      s.next(g.stripe_stages);
      for (int tap = 0; tap < taps; ++tap) {
        pipe::mbar_wait(&r.w_empty[w.stage], w.phase ^ 1);
        char* ws = r.weights_g + w.stage * g.w_bytes;
        for (int e = i0; e < Tl::N * 8; e += kWg) {
          const int n = e >> 3, q = e & 7;
          const int co = o.co0 + n, ci = c * kChunk + q * 8;
          const __nv_bfloat16* src =
              wt + ((size_t)tap * g.Co + co) * g.Ci + ci;
          *reinterpret_cast<uint4*>(ws + pipe::sw128(0, n, q)) =
              gather8(src, co < g.Co ? g.Ci - ci : 0);
        }
        pipe::fence_proxy_async();
        pipe::mbar_arrive(&r.w_full[w.stage]);
        w.next(g.w_stages);
      }
    }
  }
}

// This lane's A fragments of one (chunk, tap): the four k16 steps of each
// m64 block, from the stripe at `xs` shifted by the tap.
template <int MW>
__device__ __forceinline__ void load_a(unsigned (&a)[4][MW][4], unsigned xs,
                                       const int (&a_row)[MW], int shift,
                                       int a_hi) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int row = a_row[mi] + shift;
      ldmatrix_x4(a[kk][mi], pipe::sw128(xs, row, 2 * kk + a_hi));
    }
}

// Consumer warpgroup cw (0, 1): for each of the block's tiles, pixels
// cw * M/2 .. + M/2 of the tile by its N channels, accumulated in
// registers and stored to y. The (chunk, tap) items run in order; the
// fragments of the next item load while this one's products run.
template <class Tl, int LOAD>
__device__ __forceinline__ void consume(const Plan& g, const Rings& r, int cw,
                                        __nv_bfloat16* __restrict__ y) {
  constexpr int MW = Tl::MW, N = Tl::N;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  int a_row[MW];   // this lane's ldmatrix row (stripe index at tap 0, 0)
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int p = cw * MW * 64 + mi * 64 + wq * 16 + (lane & 7) +
                  ((lane >> 3) & 1) * 8;
    a_row[mi] = (p / g.TW) * g.SW + p % g.TW;
  }
  const int a_hi = lane >> 4;   // the k8 half of the fragment this lane reads
  const int taps = g.KH * g.KW;
  const int items = (g.Ci + kChunk - 1) / kChunk * taps;
  // the stripe of the item whose fragments are loaded next: wait for it
  // at its first tap, release it after its last
  Slot s, w;
  auto fragments = [&](unsigned (&a)[4][MW][4], int tap) {
    if (tap == 0) pipe::mbar_wait(&r.s_full[s.stage], s.phase);
    load_a<MW>(a, r.stripes + s.stage * g.stripe_bytes, a_row,
               (tap / g.KW) * g.SW + tap % g.KW, a_hi);
    if (tap == taps - 1) {
      __syncwarp();
      if (lane == 0) pipe::mbar_arrive(&r.s_empty[s.stage]);
      s.next(g.stripe_stages);
    }
  };
  float acc[MW][N / 2];
  unsigned a[4][MW][4], a_next[4][MW][4];
  for (int t = blockIdx.x; t < tile_count(g); t += gridDim.x) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mi][i] = 0.f;
    fragments(a, 0);
    for (int it = 0, tap = 0; it < items; ++it) {
      pipe::mbar_wait(&r.w_full[w.stage], w.phase);
      const uint64_t desc =
          pipe::desc_sw128(r.weights + w.stage * g.w_bytes);
      pipe::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
          pipe::wgmma<N>(acc[mi], a[kk][mi], desc + 2 * kk);
      pipe::wgmma_commit();
      if (++tap == taps) tap = 0;
      if (it + 1 < items) fragments(a_next, tap);
      pipe::wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) pipe::fence_operand(acc[mi][i]);
      if (lane == 0) pipe::mbar_arrive(&r.w_empty[w.stage]);
      w.next(g.w_stages);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[kk][mi][q] = a_next[kk][mi][q];
    }

    // accumulator i of an m64 block: row gr (+8 for i & 2) of the warp's
    // 16, channels 8 * (i / 4) + 2 * tq, + 1
    const Origin o = origin<LOAD>(g, N, t);
    const int gr = lane >> 2, tq = lane & 3;
    const int p0 = cw * MW * 64 + wq * 16;   // the warp's first pixel
    if (o.co0 + N <= g.Co && (g.Co & 7) == 0 &&
        ((uintptr_t)y & 15) == 0) {
      // every channel of the tile inside y, rows of 16-byte multiples:
      // through the warp's staging, so each lane stores 16 bytes and a
      // warp whole rows
      constexpr int SLAB = N < kEpiSlab ? N : kEpiSlab;
      constexpr int CH = SLAB / 8;   // 16-byte chunks of a staged row
      char* st = r.epi + (threadIdx.x / 32 - 4) * kEpiWarpBytes;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int h = 0; h < N / SLAB; ++h) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int jl = 0; jl < CH; ++jl) {
              const int j = h * CH + jl;
              *reinterpret_cast<__nv_bfloat162*>(
                  st + (gr + 8 * half) * SLAB * 2 + ((jl ^ gr) << 4) +
                  tq * 4) = __floats2bfloat162_rn(acc[mi][4 * j + 2 * half],
                                                  acc[mi][4 * j + 2 * half +
                                                          1]);
            }
          __syncwarp();
#pragma unroll
          for (int k = 0; k < kEpiRows * CH / 32; ++k) {
            const int e = k * 32 + lane, row = e / CH, ch = e % CH;
            const uint4 v = *reinterpret_cast<const uint4*>(
                st + row * SLAB * 2 + ((ch ^ (row & 7)) << 4));
            const int p = p0 + mi * 64 + row;
            const int oy = o.oy0 + p / g.TW, ox = o.ox0 + p % g.TW;
            if (oy < g.OH && ox < g.OW)
              *reinterpret_cast<uint4*>(
                  y + (((size_t)o.b * g.OH + oy) * g.OW + ox) * g.Co +
                  o.co0 + h * SLAB + ch * 8) = v;
          }
          __syncwarp();
        }
    } else {
      const bool pairs = (g.Co & 1) == 0;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + mi * 64 + gr + half * 8;
          const int oy = o.oy0 + p / g.TW, ox = o.ox0 + p % g.TW;
          if (oy >= g.OH || ox >= g.OW) continue;
          __nv_bfloat16* yr =
              y + (((size_t)o.b * g.OH + oy) * g.OW + ox) * g.Co;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int co = o.co0 + 8 * j + 2 * tq;
            const float v[2] = {acc[mi][4 * j + 2 * half],
                                acc[mi][4 * j + 2 * half + 1]};
            store_run<__nv_bfloat16, 2>(yr + co, g.Co - co, v, pairs);
          }
        }
    }
  }
}

template <class Tl, int LOAD>
__global__ void __launch_bounds__(kThreads, 1)
stripe_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wt,
                   __nv_bfloat16* __restrict__ y, const Plan g) {
  extern __shared__ uint4 smem_raw[];
  const Rings r = rings(g, reinterpret_cast<char*>(smem_raw));
  const bool tma = g.producer != 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.stripe_stages; ++i) {
      pipe::mbar_init(&r.s_full[i], tma ? 1 : kWg);
      pipe::mbar_init(&r.s_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < g.w_stages; ++i) {
      pipe::mbar_init(&r.w_full[i], tma ? 1 : kWg);
      pipe::mbar_init(&r.w_empty[i], kConsumerWarps);
    }
    pipe::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    pipe::setmaxnreg_dec<40>();
    if (tma) {
      if (threadIdx.x == 0) produce_tma<Tl, LOAD>(g, r, &xmap, &wmap);
    } else {
      produce_plain<Tl, LOAD>(g, r, x, wt);
    }
  } else {
    pipe::setmaxnreg_inc<232>();
    consume<Tl, LOAD>(g, r, wg - 1, y);
  }
}

// --- f32: the shared FMA tile -----------------------------------------------

// K10's in-kernel padding in f32: each pass copies only the rectangle
// [r_lo, r_hi) x [c_lo, c_hi) of the stripe; the block zeroed the rest once.
// A thread always copies segment `seg` of its rows; rows advance by
// kRowsPerSweep with no division.
struct RectStripe {
  int r_lo, r_hi, c_lo, c_hi;
  template <typename T>
  __device__ __forceinline__ void operator()(const T* __restrict__ x,
                                             const Pass& s, int c0,
                                             char* xs) const {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int kRowsPerSweep = NT / kXSegs;
    const int seg = threadIdx.x % kXSegs, r0 = threadIdx.x / kXSegs;
    const int c = c0 + seg * E;
    const int rw = c_hi - c_lo;
    const int n = (r_hi - r_lo) * max(rw, 0);
    if (n <= 0) return;
    const int step_r = kRowsPerSweep / rw, step_c = kRowsPerSweep % rw;
    int sr = r_lo + r0 / rw, sc = c_lo + r0 % rw;
    const bool in = c < s.Ci;
    for (int q = r0; q < n; q += kRowsPerSweep) {
      const T* src = in ? x + (((size_t)s.b * s.H + s.row0 + sr) * s.W +
                               s.col0 + sc) * s.Ci + c
                        : x;
      load_seg<T>(xs + (sr * s.SW + sc) * kXRow + seg * 16, src,
                  in ? s.Ci - c : 0, s.vec_x);
      sr += step_r;
      sc += step_c;
      if (sc >= c_hi) {
        sc -= rw;
        ++sr;
      }
    }
  }
};

template <int LOAD>
__global__ void __launch_bounds__(NT)
stripe_conv_kernel_fma(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       const Plan g, int vec_w, int vec_y) {
  using C = Tiles<float>::N64;   // 128 px x 64 channels
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const Origin o = origin<LOAD>(g, C::TN, blockIdx.x);
  Pass s;
  s.H = g.H; s.W = g.W; s.Ci = g.Ci;
  s.b = o.b; s.row0 = o.row0; s.col0 = o.col0;
  s.SH = g.SH; s.SW = g.SW; s.KH = g.KH; s.KW = g.KW; s.d = 1;
  s.vec_x = g.producer != 0;
  FmaBody<C> body;
  body.init(g.TW, g.SW);
  const DenseCols<float> cols{w, g.Co, o.co0, vec_w != 0};
  if constexpr (LOAD == kPredicated) {
    run_passes<float, C>(body, x, cols, nullptr, s, smem);
  } else {
    // the rectangle each pass copies; the halo around it is zeroed once
    RectStripe rect{0, g.SH, max(0, -o.col0), min(g.SW, g.W - o.col0)};
    if constexpr (LOAD != kNoBranch) {
      if (o.tile_y == 0) rect.r_lo = g.py0;                        // first
      if (o.tile_y == g.tiles_y - 1)
        rect.r_hi = min(g.SH, g.H - o.row0);                       // last
    }
    for (int e = threadIdx.x; e < g.SH * g.SW * kXSegs; e += NT) {
      const int sp = e / kXSegs, seg = e % kXSegs;
      const int sr = sp / g.SW, sc = sp % g.SW;
      const bool row_pad = sr < rect.r_lo || sr >= rect.r_hi;
      const bool col_pad = sc < rect.c_lo || sc >= rect.c_hi;
      if (row_pad || (col_pad && LOAD != kNoMemset))
        zero16(smem + sp * kXRow + seg * 16);
    }
    run_passes<float, C>(body, x, cols, nullptr, s, smem, rect);
  }
  body.each([&](int p, int c, auto& v) {
    const int oy = o.oy0 + p / g.TW, ox = o.ox0 + p % g.TW;
    const int co = o.co0 + c;
    if (oy >= g.OH || ox >= g.OW || co >= g.Co) return;
    const size_t pix = ((size_t)o.b * g.OH + oy) * g.OW + ox;
    store_run<float, 4>(y + pix * g.Co + co, g.Co - co, v, vec_y != 0);
  });
}

// --- launch -----------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// The two boxes of the TMA producer: the stripe (64 channels x SW x SH x 1)
// over x (C, W, H, B), and one tap's (64 ci x N co) over the (KH*KW, Co, Ci)
// weights; 128-byte swizzle, zeros outside the tensor.
int encode_maps(const Plan& g, const void* x, const void* wt, CUtensorMap* xm,
                CUtensorMap* wm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorInitializationError;
  const cuuint64_t e = 2, ci = g.Ci;
  const cuuint64_t xdim[4] = {ci, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t xstride[3] = {ci * e, ci * g.W * e, ci * g.W * g.H * e};
  const cuuint32_t xbox[4] = {kChunk, (cuuint32_t)g.SW, (cuuint32_t)g.SH, 1};
  const cuuint64_t wdim[3] = {ci, (cuuint64_t)g.Co,
                              (cuuint64_t)(g.KH * g.KW)};
  const cuuint64_t wstride[2] = {ci * e, ci * g.Co * e};
  const cuuint32_t wbox[3] = {kChunk, (cuuint32_t)g.N, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  res = encode(wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt),
               wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}


template <class Tl, int LOAD>
int launch_bf16(const void* x, const void* wt, void* y, const Plan& g,
                cudaStream_t stream) {
  if (g.TH * g.TW != Tl::M || g.w_bytes != Tl::N * kRow)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm{}, wm{};
  if (g.producer) {
    const int err = encode_maps(g, x, wt, &xm, &wm);
    if (err) return err;
  }
  auto kernel = stripe_conv_kernel<Tl, LOAD>;
  const cudaError_t e = set_smem(kernel, g.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.grid, kThreads, g.smem, stream>>>(
      xm, wm, (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt,
      (__nv_bfloat16*)y, g);
  return (int)cudaGetLastError();
}

template <int LOAD>
int launch_tile(const void* x, const void* wt, void* y, const Plan& g,
                cudaStream_t s) {
  if (g.M == 256 && g.N == 64)
    return launch_bf16<WgTile<2, 64>, LOAD>(x, wt, y, g, s);
  if (g.M == 256 && g.N == 128)
    return launch_bf16<WgTile<2, 128>, LOAD>(x, wt, y, g, s);
  if (g.M == 128 && g.N == 256)
    return launch_bf16<WgTile<1, 256>, LOAD>(x, wt, y, g, s);
  if (g.M == 128 && g.N == 128)
    return launch_bf16<WgTile<1, 128>, LOAD>(x, wt, y, g, s);
  return (int)cudaErrorInvalidValue;
}

template <int LOAD>
int launch_f32(const void* x, const void* w, void* y, const Plan& g,
               cudaStream_t stream) {
  using C = Tiles<float>::N64;
  if (g.TH * g.TW != C::TM || g.N != C::TN ||
      g.smem < smem_bytes<float, C>(g.SH, g.SW, g.KH * g.KW))
    return (int)cudaErrorInvalidValue;
  const int vec_w = (g.Co * 4) % 16 == 0 && (uintptr_t)w % 16 == 0;
  const int vec_y = g.Co % 4 == 0 && (uintptr_t)y % 16 == 0;
  auto kernel = stripe_conv_kernel_fma<LOAD>;
  const cudaError_t e = set_smem(kernel, g.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.grid, NT, g.smem, stream>>>((const float*)x, (const float*)w,
                                       (float*)y, g, vec_w, vec_y);
  return (int)cudaGetLastError();
}

// The checks a plan must pass before anything is launched: its geometry is
// self-consistent, its shared memory within a block's, its TMA boxes
// within the hardware's and its TMA pointers aligned.
bool plan_ok(const Plan& g, int dtype, int load, const void* x,
             const void* wt) {
  if (g.B < 1 || g.H < 1 || g.W < 1 || g.Ci < 1 || g.Co < 1 || g.KH < 1 ||
      g.KW < 1 || g.OH < 1 || g.OW < 1 || g.TH < 1 || g.TW < 1)
    return false;
  if (g.SH != g.TH + g.KH - 1 || g.SW != g.TW + g.KW - 1) return false;
  if (g.tiles_x != (g.OW + g.TW - 1) / g.TW ||
      g.tiles_y != (g.OH + g.TH - 1) / g.TH ||
      g.co_tiles != (g.Co + g.N - 1) / g.N)
    return false;
  const long long tiles = (long long)g.B * g.tiles_y * g.tiles_x * g.co_tiles;
  if (tiles > 0x7fffffffLL || g.grid < 1 || g.grid > tiles ||
      (dtype == kF32 && g.grid != tiles))
    return false;
  if (g.smem < 1 || g.smem > kSmemLimit) return false;
  if (load != kPredicated &&
      (g.KH != 3 || g.KW != 3 || g.py0 != 1 || g.px0 != 1 || g.OH != g.H ||
       g.OW != g.W))
    return false;
  if (load == kNoBranch && g.H < g.SH) return false;
  if (dtype == kF32) return true;
  if (g.stripe_stages < 1 || g.w_stages < 1 || g.stripe_bytes % 1024 ||
      g.stripe_bytes < g.SH * g.SW * kRow ||
      g.smem < 1024 + g.stripe_stages * g.stripe_bytes +
                   g.w_stages * g.w_bytes + kEpiBytes +
                   2 * (g.stripe_stages + g.w_stages) * 8)
    return false;
  if (g.producer &&
      (g.SH > kBoxLimit || g.SW > kBoxLimit || (g.Ci * 2) % 16 ||
       (uintptr_t)x % 16 || (uintptr_t)wt % 16))
    return false;
  return true;
}

}  // namespace
}  // namespace vspbfr

// x (B, H, W, Ci) and y (B, OH, OW, Co) in the dtype (0 f32, 1 bf16); wt
// the weights, bf16 (KH, KW, Co, Ci), f32 (KH, KW, Ci, Co). load: 0
// predicated (pads py0 / px0), 1 inkpad, 2 nomemset, 3 nobranch (1-3: 3x3,
// pads 1, OH = H, OW = W). plan: ops/stripe_conv.py:stripe_plan's fields
// (`Plan`); a plan that fails `plan_ok` is refused before launch.
extern "C" int vspbfr_stripe_conv(const void* x, const void* wt, void* y,
                                  int dtype, int load, const int* plan,
                                  void* stream) {
  using namespace vspbfr;
  Plan g;
  memcpy(&g, plan, sizeof g);
  if ((dtype != kF32 && dtype != kBF16) || load < kPredicated ||
      load > kNoBranch || !plan_ok(g, dtype, load, x, wt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return load == kNoBranch ? launch_tile<kNoBranch>(x, wt, y, g, s)
                             : launch_tile<kPredicated>(x, wt, y, g, s);
  switch (load) {
    case kPredicated: return launch_f32<kPredicated>(x, wt, y, g, s);
    case kInkpad: return launch_f32<kInkpad>(x, wt, y, g, s);
    case kNoMemset: return launch_f32<kNoMemset>(x, wt, y, g, s);
    default: return launch_f32<kNoBranch>(x, wt, y, g, s);
  }
}
