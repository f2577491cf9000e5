// K1: dense stride-1 KHxKW convolution, NHWC x HWIO -> NHWC, explicit
// (possibly asymmetric) zero pads, optional per-(batch, in-channel) input
// scale (the modulated conv's style multiply), f32 accumulation.
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_conv.py:_conv_pallas
// (body _conv_kernel), which kept a haloed input stripe in VMEM and summed
// KHxKW per-tap (pixels, Ci) @ (Ci, Co) MXU dots.
//
// What bounds it on the H100: compute. At the main path's widths (3x3 convs
// with Ci = Co from 32 to 512 over 4..1024 px) every input element feeds
// 9*Co multiply-adds, far above the ~300 FLOP/byte ridge, so the products
// go where the card's rate is: in bf16 the tensor cores (989 TFLOP/s), in
// f32 the CUDA cores' FMA (67 TFLOP/s; TF32 would not give the f32 result).
// The design is K9's (stripe_conv.cu), generalised in conv_tile.cuh:
// - Tiles: a block owns a TH x TW pixel by TN channel output tile, picked
//   by Co and the image: 64 channels by 256 px (bf16) / 128 px (f32); 32
//   channels by 512 / 256 px and 16 by 256 px for narrow convs (the
//   1024 px decoder's C32, the 1x1 rate-1 conv and their gradients), so no
//   tile runs mostly on zero weights; 64 channels by 64 px for images of
//   at most 64 px (the 4-8 px convs, final_conv).
// - Loads: per 64-byte pass over the input channels, the haloed stripe and
//   the pass's weights of every tap by cp.async, 16 bytes a copy; its zero
//   fill gives the pads, the image's edge and Ci past the pass, with no
//   padded copy in device memory. Where Ci or Co is no multiple of 16
//   bytes or a pointer is misaligned (Ci 3 and 513, offset views), the
//   stage is filled by plain loads. `isc` scales the stripe in shared
//   memory after it arrives, rounding where the TPU kernel rounds.
// - Products: one tile product per tap, the tap an offset into the stripe.
//   bf16: mma.sync m16n8k16 fed by ldmatrix (A: the stripe's shifted pixel
//   rows; B: the HWIO weights through ldmatrix.trans). f32: 4-8 pixels x
//   4-8 channels of FMA a thread over 16-byte shared reads.
// - Stages: one, as K9 measured best on this card (two stages doubled the
//   shared memory, left one block per SM and ran 8-27% slower): two blocks
//   share an SM, and one block's copies overlap the other's products.
// Measured alternative: the bf16 64-channel tile on wgmma (m64n64k16, A
// from registers, B from the staged weights through a shared-memory
// descriptor). In turns with mma.sync on the H100 it ran alike at 128-512
// input channels and 12-20% slower at 64 (PERF.md, section 6): the single
// stage, not the product instruction, sets the pace, so mma.sync stays and
// the wgmma form was not kept. TMA loads into a ring of stages on
// mbarriers are the step that could give wgmma something to win (ROADMAP
// queue B).
//
// K1e (the same kernel with EPI = true) replaces _conv_pallas(fuse_epi=True)
// behind conv2d_dense_epilogue (pallas_conv.py:181-219, :524): the styled
// conv's epilogue -- demod scale, noise, bias, lrelu*sqrt2, post-activation
// adds, then an optional second noise / bias / lrelu stage -- runs on the
// f32 accumulator fragments before the store (each thread knows its
// (pixel, channel) pairs from the fragment layout), so the conv output
// never makes a round trip through device memory before its epilogue. The
// epilogue adds (post_add, noise) reads per output element; it does not
// change what bounds the conv. Operands come in the output's dtype; the
// arithmetic is f32. Where post-activation adds or a second stage follow
// the first activation, the wrapper may ask for that activation's sign as
// one byte per output element (`mask`): the backward needs it, and
// recovering it from the rounded bf16 output flips it wherever the first
// stage's value is within rounding of 0. The noises have nc = 1 value a
// pixel, or in the space-to-depth layout nc = 4, one a phase: channel co
// of Co adds the value of phase co / (Co / 4), `_expand_matrix`
// (pallas_epilogue.py:33) as an index instead of a product.
#include "conv_tile.cuh"

namespace vspbfr {
namespace {

using namespace tile;

constexpr int kMaxPost = 2;

// K1e's epilogue operands; a null pointer is an absent piece.
template <typename T>
struct Epilogue {
  const T* osc;              // (B, Co) demod scale
  const T* noise;            // (B, OH, OW, nc), already scaled by its gain
  const T* bias;             // (Co)
  const T* post[kMaxPost];   // (B, OH, OW, Co), added after the activation
  const T* noise2;           // second stage: (B, OH, OW, nc)
  const T* bias2;            // (Co)
  unsigned char* mask;       // (B, OH, OW, Co) out: first pre-activation >= 0
  int n_post, act, act2;
  int nc, cq;                // noise values a pixel (1 or 4), Co / nc
};

template <typename T>
__device__ __forceinline__ float apply_epilogue(const Epilogue<T>& e, float v,
                                                int b, size_t pix, int co,
                                                int Co) {
  // the pixel's noise value for channel co: its phase's where nc = 4
  const size_t nz = pix * e.nc + (e.nc > 1 ? co / e.cq : 0);
  if (e.osc) v *= to_f(e.osc[(size_t)b * Co + co]);
  if (e.noise) v += to_f(e.noise[nz]);
  if (e.bias) v += to_f(e.bias[co]);
  if (e.mask) e.mask[pix * Co + co] = v >= 0.f;
  if (e.act) v = lrelu_sqrt2(v);
#pragma unroll
  for (int k = 0; k < kMaxPost; ++k)
    if (k < e.n_post) v += to_f(e.post[k][pix * Co + co]);
  if (e.noise2) v += to_f(e.noise2[nz]);
  if (e.bias2) v += to_f(e.bias2[co]);
  if (e.act2) v = lrelu_sqrt2(v);
  return v;
}

struct Geom {
  int H, W, Ci, Co, KH, KW, py0, px0, OH, OW;
  int TH, TW, SH, SW;   // tile and stripe sides
  int tiles_x, co_tiles;
  int vec_x, vec_w, vec_y;
};

template <typename T, bool EPI, class C>
__global__ void __launch_bounds__(NT)
dense_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ isc, T* __restrict__ y, Geom g,
                  Epilogue<T> epi) {
  extern __shared__ uint4 smem_raw[];
  const int b = blockIdx.y;
  const int co_tile = blockIdx.x % g.co_tiles;
  const int pix_tile = blockIdx.x / g.co_tiles;
  const int oy0 = (pix_tile / g.tiles_x) * g.TH;
  const int ox0 = (pix_tile % g.tiles_x) * g.TW;
  const int co0 = co_tile * C::TN;
  Pass s;
  s.H = g.H; s.W = g.W; s.Ci = g.Ci;
  s.b = b; s.row0 = oy0 - g.py0; s.col0 = ox0 - g.px0;
  s.SH = g.SH; s.SW = g.SW; s.KH = g.KH; s.KW = g.KW; s.d = 1;
  s.vec_x = g.vec_x;

  Body<T, C> body;
  body.init(g.TW, g.SW);
  run_passes<T, C>(body, x, DenseCols<T>{w, g.Co, co0, g.vec_w != 0}, isc,
                   s, reinterpret_cast<char*>(smem_raw));

  body.each([&](int p, int c, auto& v) {
    constexpr int N = sizeof(v) / sizeof(float);
    const int oy = oy0 + p / g.TW, ox = ox0 + p % g.TW;
    const int co = co0 + c;
    if (oy >= g.OH || ox >= g.OW || co >= g.Co) return;
    const size_t pix = ((size_t)b * g.OH + oy) * g.OW + ox;
    if constexpr (EPI) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (co + k < g.Co) v[k] = apply_epilogue(epi, v[k], b, pix, co + k,
                                                 g.Co);
    }
    store_run<T, N>(y + pix * g.Co + co, g.Co - co, v, g.vec_y);
  });
}

template <typename T, bool EPI, class C>
int launch_tile(const void* x, const void* w, const void* isc, void* y,
                Geom g, int B, const Epilogue<T>& epi, cudaStream_t stream) {
  const TileShape ts = tile_shape(C::TM, g.OW);
  g.TH = ts.TH;
  g.TW = ts.TW;
  g.SH = g.TH + g.KH - 1;
  g.SW = g.TW + g.KW - 1;
  g.tiles_x = (g.OW + g.TW - 1) / g.TW;
  const int tiles_y = (g.OH + g.TH - 1) / g.TH;
  g.co_tiles = (g.Co + C::TN - 1) / C::TN;
  const int smem = smem_bytes<T, C>(g.SH, g.SW, g.KH * g.KW);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(dense_conv_kernel<T, EPI, C>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)g.tiles_x * tiles_y * g.co_tiles;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  dense_conv_kernel<T, EPI, C><<<dim3((unsigned)blocks, B), NT, smem,
                                 stream>>>((const T*)x, (const T*)w,
                                           (const T*)isc, (T*)y, g, epi);
  return (int)cudaGetLastError();
}

template <typename T, bool EPI>
int launch(const void* x, const void* w, const void* isc, void* y, int B,
           int H, int W, int Ci, int Co, int KH, int KW, int py0, int px0,
           int OH, int OW, const Epilogue<T>& epi, cudaStream_t stream) {
  constexpr int isz = (int)sizeof(T);
  Geom g{};
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.KH = KH; g.KW = KW;
  g.py0 = py0; g.px0 = px0; g.OH = OH; g.OW = OW;
  g.vec_x = (Ci * isz) % 16 == 0 && (uintptr_t)x % 16 == 0;
  g.vec_w = (Co * isz) % 16 == 0 && (uintptr_t)w % 16 == 0;
  // pairs (bf16) or quads (f32) of channels per store
  g.vec_y = Co % (isz == 2 ? 2 : 4) == 0 && (uintptr_t)y % 16 == 0;
  using Ts = Tiles<T>;
  switch (pick_tile(OH * OW, Co)) {
    case kSmall:
      return launch_tile<T, EPI, typename Ts::Small>(x, w, isc, y, g, B, epi,
                                                     stream);
    case kN16:
      return launch_tile<T, EPI, typename Ts::N16>(x, w, isc, y, g, B, epi,
                                                   stream);
    case kN32:
      return launch_tile<T, EPI, typename Ts::N32>(x, w, isc, y, g, B, epi,
                                                   stream);
    default:
      return launch_tile<T, EPI, typename Ts::N64>(x, w, isc, y, g, B, epi,
                                                   stream);
  }
}

template <typename T>
Epilogue<T> make_epilogue(const void* osc, const void* noise,
                          const void* bias, const void* post0,
                          const void* post1, const void* noise2,
                          const void* bias2, void* mask, int n_post, int act,
                          int act2, int nc, int Co) {
  Epilogue<T> e;
  e.osc = (const T*)osc;
  e.noise = (const T*)noise;
  e.bias = (const T*)bias;
  e.post[0] = (const T*)post0;
  e.post[1] = (const T*)post1;
  e.noise2 = (const T*)noise2;
  e.bias2 = (const T*)bias2;
  e.mask = (unsigned char*)mask;
  e.n_post = n_post;
  e.act = act;
  e.act2 = act2;
  e.nc = nc;
  e.cq = Co / nc;
  return e;
}

}  // namespace
}  // namespace vspbfr

extern "C" int vspbfr_dense_conv(const void* x, const void* w, const void* isc,
                                 void* y, int dtype, int B, int H, int W,
                                 int Ci, int Co, int KH, int KW, int py0,
                                 int px0, int OH, int OW, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float, false>(x, w, isc, y, B, H, W, Ci, Co, KH, KW, py0,
                                px0, OH, OW, Epilogue<float>{}, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, false>(x, w, isc, y, B, H, W, Ci, Co, KH,
                                        KW, py0, px0, OH, OW,
                                        Epilogue<__nv_bfloat16>{}, s);
  return (int)cudaErrorInvalidValue;
}

// K1e: K1 with the styled epilogue in the store. Null operands are absent;
// n_post <= 2; nc (1, or 4 with Co % 4 == 0) noise values a pixel; mask
// (uint8, the output's shape) is written when not null.
extern "C" int vspbfr_dense_conv_epi(
    const void* x, const void* w, const void* isc, void* y, const void* osc,
    const void* noise, const void* bias, const void* post0, const void* post1,
    const void* noise2, const void* bias2, void* mask, int n_post, int act,
    int act2, int nc,
    int dtype, int B, int H, int W, int Ci, int Co, int KH, int KW, int py0,
    int px0, int OH, int OW, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_post < 0 || n_post > kMaxPost ||
      !(nc == 1 || (nc == 4 && Co % 4 == 0)))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float, true>(
        x, w, isc, y, B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW,
        make_epilogue<float>(osc, noise, bias, post0, post1, noise2, bias2,
                             mask, n_post, act, act2, nc, Co),
        s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, true>(
        x, w, isc, y, B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW,
        make_epilogue<__nv_bfloat16>(osc, noise, bias, post0, post1, noise2,
                                     bias2, mask, n_post, act, act2, nc, Co),
        s);
  return (int)cudaErrorInvalidValue;
}
