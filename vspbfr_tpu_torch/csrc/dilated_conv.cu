// K2: several same-input 3x3 "same" dilated convolutions in one launch,
// their outputs concatenated on channels, with an optional per-(batch,
// in-channel) input scale and per-(batch, out-channel) output scale (the
// demodulation) applied at the store. NHWC in and out; each branch's
// (3, 3, Ci, Co_k) HWIO weights are read where they lie (one pointer a
// branch).
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_dilated.py:_multi_pallas
// (body _multi_kernel): SMART's four dilation-1/2/4/8 branches over one
// shared input stripe, so that each narrow branch (Co = C/4) does not run
// as its own lane-starved conv.
//
// What bounds it on the H100: compute at the large widths (9 * sum(Co)
// multiply-adds per input element), and at the small images the halo: a
// dilation-d tap reaches d pixels past the tile. The body is K1's
// (conv_tile.cuh: bf16 on the tensor cores with mma.sync, f32 as FMA on
// the CUDA cores; cp.async loads whose zero fill gives the halo) with the
// taps spaced d apart in the stripe.
// - One branch a block: blockIdx.x walks (pixel tile, branch, channel tile
//   of the branch), the branches of a pixel tile adjacent so that they
//   read its input while it is in L2. Each block stages a stripe with a
//   halo of its own d, not of the largest (the TPU kernel shared one
//   8-halo stripe: an 8x8 tile read a 24x24 window even for dilation 1),
//   and its N tile is the branch's width rounded to 16, 32 or 64 (16 at
//   512 px C64), so no product runs on another branch's columns. The input
//   is read once per branch.
// - Measured alternative: every branch in one block over one stripe with
//   the largest dilation's halo, as the TPU kernel, each column group
//   running its own branch's taps. In turns on the H100 it was 6-40%
//   slower in bf16 at every SMART shape and in f32 at C >= 128, and 6%
//   faster only in f32 at 512 px C64 (about 0.2 ms a launch; PERF.md,
//   section 6), so it was not kept.
// The concatenation costs nothing: each block stores into its branch's
// channels. At 4-8 px the 64-pixel tile is taken; most dilation-8 taps
// then fall in the zero halo.
//
// Groups (the space-to-depth layout's form, `_multi_ref` with groups = G,
// pallas_dilated.py:253): x's Ci channels are G groups of Cg = Ci / G,
// every branch's (3, 3, Cg, Co_k) weights are shared by the groups, and
// branch k's output block holds G x Co_k channels, group-major. The group
// is the grid's third dimension: a block stages its group's Cg channels of
// the stripe (the pass's channel offset and pixel stride, `Pass::coff` /
// `Pass::cs`) and stores at its group's offset in the branch's block, so
// the shared weights are read where they lie and no block-diagonal weight
// multiplies zeros (the TPU kernel assembled per-group weight rows).
#include "conv_tile.cuh"

namespace vspbfr {
namespace {

using namespace tile;

constexpr int MAXB = 8;

struct Branches {
  int n;
  int dil[MAXB];
  int width[MAXB];         // output channels of one group
  int off[MAXB];           // first channel of each branch in the concat
  int tile0[MAXB + 1];     // first channel tile of each branch
  int vec_w[MAXB];
  const void* w[MAXB];
};

struct Geom {
  int H, W, Ci, Cg, CoT;   // Cg: channels of a group; CoT: of the output
  int TH, TW, tiles_x, col_tiles;
  int P;                   // the largest dilation
  int vec_x, vec_y;
};

// The output scale and store of N channels of one pixel: channels co ..
// of branch k in group grp.
template <typename T, int N>
__device__ __forceinline__ void store_branch(const Geom& g,
                                             const Branches& br,
                                             const T* __restrict__ osc,
                                             T* __restrict__ y, int b,
                                             int oy, int ox, int k, int grp,
                                             int co, float (&v)[N]) {
  const int off = br.off[k] + grp * br.width[k], n = br.width[k] - co;
  if (oy >= g.H || ox >= g.W || n <= 0) return;
  if (osc) {
    const T* o = osc + (size_t)b * g.CoT + off + co;
#pragma unroll
    for (int q = 0; q < N; ++q)
      if (q < n) v[q] *= to_f(o[q]);
  }
  T* yr = y + (((size_t)b * g.H + oy) * g.W + ox) * g.CoT + off + co;
  store_run<T, N>(yr, n, v, g.vec_y && off % 4 == 0);
}

// One branch of one group a block; the stripe's halo is the branch's own
// dilation.
template <typename T, class C>
__global__ void __launch_bounds__(NT)
dilated_multi_kernel(const T* __restrict__ x, const T* __restrict__ isc,
                     const T* __restrict__ osc, T* __restrict__ y, Geom g,
                     Branches br) {
  extern __shared__ uint4 smem_raw[];
  const int b = blockIdx.y, grp = blockIdx.z;
  const int ct = blockIdx.x % g.col_tiles;
  const int pix_tile = blockIdx.x / g.col_tiles;
  int k = 0;
  while (k + 1 < br.n && ct >= br.tile0[k + 1]) ++k;
  const int d = br.dil[k];
  const int oy0 = (pix_tile / g.tiles_x) * g.TH;
  const int ox0 = (pix_tile % g.tiles_x) * g.TW;
  const int co0 = (ct - br.tile0[k]) * C::TN;
  Pass s;
  s.H = g.H; s.W = g.W; s.Ci = g.Cg;
  s.cs = g.Ci; s.coff = grp * g.Cg;
  s.b = b; s.row0 = oy0 - d; s.col0 = ox0 - d;
  s.SH = g.TH + 2 * d; s.SW = g.TW + 2 * d;
  s.KH = 3; s.KW = 3; s.d = d;
  s.vec_x = g.vec_x;

  Body<T, C> body;
  body.init(g.TW, s.SW);
  run_passes<T, C>(
      body, x,
      DenseCols<T>{(const T*)br.w[k], br.width[k], co0, br.vec_w[k] != 0},
      isc, s, reinterpret_cast<char*>(smem_raw));
  body.each([&](int p, int c, auto& v) {
    store_branch(g, br, osc, y, b, oy0 + p / g.TW, ox0 + p % g.TW, k, grp,
                 co0 + c, v);
  });
}

template <typename T, class C>
int launch_tile(const void* x, const void* isc, const void* osc, void* y,
                Geom g, Branches br, int B, int groups,
                cudaStream_t stream) {
  const TileShape ts = tile_shape(C::TM, g.W);
  g.TH = ts.TH;
  g.TW = ts.TW;
  g.tiles_x = (g.W + g.TW - 1) / g.TW;
  const int tiles_y = (g.H + g.TH - 1) / g.TH;
  int t = 0;
  for (int k = 0; k < br.n; ++k) {
    br.tile0[k] = t;
    t += (br.width[k] + C::TN - 1) / C::TN;
  }
  br.tile0[br.n] = t;
  g.col_tiles = t;
  // shared memory is set per launch, with room for the largest dilation's
  // stripe
  const int smem = smem_bytes<T, C>(g.TH + 2 * g.P, g.TW + 2 * g.P, 9);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = dilated_multi_kernel<T, C>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)g.tiles_x * tiles_y * g.col_tiles;
  if (blocks > 0x7fffffffLL || B > 65535 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, B, groups), NT, smem, stream>>>(
      (const T*)x, (const T*)isc, (const T*)osc, (T*)y, g, br);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* const* ws, const void* isc,
           const void* osc, void* y, int B, int H, int W, int Ci, int groups,
           int n, const int* dils, const int* cos, cudaStream_t stream) {
  constexpr int isz = (int)sizeof(T);
  if (groups < 1 || Ci % groups) return (int)cudaErrorInvalidValue;
  Branches br{};
  br.n = n;
  Geom g{};
  g.H = H; g.W = W; g.Ci = Ci; g.Cg = Ci / groups;
  int widest = 0;
  for (int k = 0; k < n; ++k) {
    if (dils[k] < 1 || cos[k] < 1) return (int)cudaErrorInvalidValue;
    br.dil[k] = dils[k];
    br.width[k] = cos[k];
    br.off[k] = g.CoT;
    br.w[k] = ws[k];
    br.vec_w[k] = (cos[k] * isz) % 16 == 0 && (uintptr_t)ws[k] % 16 == 0;
    g.CoT += groups * cos[k];
    g.P = dils[k] > g.P ? dils[k] : g.P;
    widest = cos[k] > widest ? cos[k] : widest;
  }
  g.vec_x = (Ci * isz) % 16 == 0 && (g.Cg * isz) % 16 == 0 &&
            (uintptr_t)x % 16 == 0;
  // pairs (bf16) or quads (f32) of channels per store; each branch's and
  // group's first channel is checked in the kernel
  g.vec_y = g.CoT % 4 == 0 && (uintptr_t)y % 16 == 0;
  using Ts = Tiles<T>;
  switch (pick_tile(H * W, widest)) {
    case kSmall:
      return launch_tile<T, typename Ts::Small>(x, isc, osc, y, g, br, B,
                                              groups, stream);
    case kN16:
      return launch_tile<T, typename Ts::N16>(x, isc, osc, y, g, br, B,
                                              groups, stream);
    case kN32:
      return launch_tile<T, typename Ts::N32>(x, isc, osc, y, g, br, B,
                                              groups, stream);
    default:
      return launch_tile<T, typename Ts::N64>(x, isc, osc, y, g, br, B,
                                              groups, stream);
  }
}

}  // namespace
}  // namespace vspbfr

// ws: n_branches pointers, each branch's (3, 3, Ci / groups, cos[k]) HWIO
// weights; dils / cos: n_branches host ints (dilation and output width of
// one group per branch).
extern "C" int vspbfr_dilated_multi_conv(const void* x, const void* const* ws,
                                         const void* isc, const void* osc,
                                         void* y, int dtype, int B, int H,
                                         int W, int Ci, int groups,
                                         int n_branches, const int* dils,
                                         const int* cos, void* stream) {
  using namespace vspbfr;
  if (n_branches < 1 || n_branches > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float>(x, ws, isc, osc, y, B, H, W, Ci, groups,
                         n_branches, dils, cos, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, ws, isc, osc, y, B, H, W, Ci, groups,
                                 n_branches, dils, cos, s);
  return (int)cudaErrorInvalidValue;
}
