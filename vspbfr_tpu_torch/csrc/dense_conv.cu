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
// 9*Co multiply-adds, far above the ~300 FLOP/byte ridge. This first form
// is an implicit GEMM on the CUDA cores: each block owns an 8x8-pixel by
// 64-channel output tile; per 16-channel input chunk it stages the haloed,
// style-scaled input tile and the chunk's weights in shared memory (the
// zero halo comes from bounds checks, not a padded copy), and each thread
// accumulates a 4-pixel x 4-channel register tile over every tap. Shared
// reads are broadcast or unit-stride, so there are no bank conflicts. It
// does not yet use the tensor cores (wgmma) or TMA; that is later work.
//
// K1e (the same kernel with EPI = true) replaces _conv_pallas(fuse_epi=True)
// behind conv2d_dense_epilogue (pallas_conv.py:181-219, :524): the styled
// conv's epilogue -- demod scale, noise, bias, lrelu*sqrt2, post-activation
// adds, then an optional second noise / bias / lrelu stage -- runs on the
// f32 accumulator before the store, so the conv output never makes a round
// trip through device memory before its epilogue. The epilogue adds
// (post_add, noise) reads per output element; it does not change what
// bounds the conv. Operands come in the output's dtype; the arithmetic is
// f32. With EPI = false the code is plain K1's. Where post-activation adds
// or a second stage follow the first activation, the wrapper may ask for
// that activation's sign as one byte per output element (`mask`): the
// backward needs it, and recovering it from the rounded bf16 output flips
// it wherever the first stage's value is within rounding of 0.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int TH = 8, TW = 8, TCO = 64, CK = 16, NT = 256;
constexpr int kMaxPost = 2;

// K1e's epilogue operands; a null pointer is an absent piece.
template <typename T>
struct Epilogue {
  const T* osc;              // (B, Co) demod scale
  const T* noise;            // (B, OH, OW, 1), already scaled by its gain
  const T* bias;             // (Co)
  const T* post[kMaxPost];   // (B, OH, OW, Co), added after the activation
  const T* noise2;           // second stage: (B, OH, OW, 1)
  const T* bias2;            // (Co)
  unsigned char* mask;       // (B, OH, OW, Co) out: first pre-activation >= 0
  int n_post, act, act2;
};

template <typename T>
__device__ __forceinline__ float apply_epilogue(const Epilogue<T>& e, float v,
                                                int b, size_t pix, int co,
                                                int Co) {
  if (e.osc) v *= to_f(e.osc[(size_t)b * Co + co]);
  if (e.noise) v += to_f(e.noise[pix]);
  if (e.bias) v += to_f(e.bias[co]);
  if (e.mask) e.mask[pix * Co + co] = v >= 0.f;
  if (e.act) v = lrelu_sqrt2(v);
#pragma unroll
  for (int k = 0; k < kMaxPost; ++k)
    if (k < e.n_post) v += to_f(e.post[k][pix * Co + co]);
  if (e.noise2) v += to_f(e.noise2[pix]);
  if (e.bias2) v += to_f(e.bias2[co]);
  if (e.act2) v = lrelu_sqrt2(v);
  return v;
}

template <typename T, bool EPI>
__global__ void __launch_bounds__(NT)
dense_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ isc, T* __restrict__ y, int H, int W,
                  int Ci, int Co, int KH, int KW, int py0, int px0, int OH,
                  int OW, int tiles_x, Epilogue<T> epi) {
  extern __shared__ float smem[];
  const int IH = TH + KH - 1, IW = TW + KW - 1;
  const int taps = KH * KW;
  float* xs = smem;                  // [CK][IH][IW]
  float* ws = smem + CK * IH * IW;   // [taps][CK][TCO]
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * TCO;
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;

  int pofs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    pofs[i] = (p / TW) * IW + (p % TW);
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    for (int e = tid; e < CK * IH * IW; e += NT) {
      const int ci = e % CK, pos = e / CK;
      const int iy = pos / IW, ix = pos % IW;
      const int gy = ty0 + iy - py0, gx = tx0 + ix - px0, gc = c0 + ci;
      float v = 0.f;
      if (gc < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * Ci + gc]);
        if (isc) v *= to_f(isc[(size_t)b * Ci + gc]);
      }
      xs[(ci * IH + iy) * IW + ix] = v;
    }
    for (int e = tid; e < taps * CK * TCO; e += NT) {
      const int co = e % TCO, r = e / TCO;
      const int ci = r % CK, tap = r / CK;
      const int gc = c0 + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < Ci && gco < Co) v = to_f(w[((size_t)tap * Ci + gc) * Co + gco]);
      ws[(tap * CK + ci) * TCO + co] = v;
    }
    __syncthreads();
    for (int tap = 0; tap < taps; ++tap) {
      const int toff = (tap / KW) * IW + (tap % KW);
#pragma unroll 4
      for (int ci = 0; ci < CK; ++ci) {
        const float* xr = xs + ci * IH * IW + toff;
        const float* wr = ws + (tap * CK + ci) * TCO + tc;
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xr[pofs[i]];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = wr[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int oy = ty0 + p / TW, ox = tx0 + p % TW;
    if (oy >= OH || ox >= OW) continue;
    const size_t pix = ((size_t)b * OH + oy) * OW + ox;
    T* yr = y + pix * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tc + 16 * j;
      if (co >= Co) continue;
      float v = acc[i][j];
      if constexpr (EPI) v = apply_epilogue(epi, v, b, pix, co, Co);
      yr[co] = from_f<T>(v);
    }
  }
}

template <typename T, bool EPI>
int launch(const void* x, const void* w, const void* isc, void* y, int B,
           int H, int W, int Ci, int Co, int KH, int KW, int py0, int px0,
           int OH, int OW, const Epilogue<T>& epi, cudaStream_t stream) {
  const int tiles_x = (OW + TW - 1) / TW, tiles_y = (OH + TH - 1) / TH;
  const size_t smem =
      (size_t)(CK * (TH + KH - 1) * (TW + KW - 1) + KH * KW * CK * TCO) *
      sizeof(float);
  cudaError_t err = set_smem(dense_conv_kernel<T, EPI>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles_x * tiles_y, (Co + TCO - 1) / TCO, B);
  dense_conv_kernel<T, EPI><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)isc, (T*)y, H, W, Ci, Co, KH, KW,
      py0, px0, OH, OW, tiles_x, epi);
  return (int)cudaGetLastError();
}

template <typename T>
Epilogue<T> make_epilogue(const void* osc, const void* noise,
                          const void* bias, const void* post0,
                          const void* post1, const void* noise2,
                          const void* bias2, void* mask, int n_post, int act,
                          int act2) {
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
// n_post <= 2; mask (uint8, the output's shape) is written when not null.
extern "C" int vspbfr_dense_conv_epi(
    const void* x, const void* w, const void* isc, void* y, const void* osc,
    const void* noise, const void* bias, const void* post0, const void* post1,
    const void* noise2, const void* bias2, void* mask, int n_post, int act,
    int act2,
    int dtype, int B, int H, int W, int Ci, int Co, int KH, int KW, int py0,
    int px0, int OH, int OW, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_post < 0 || n_post > kMaxPost) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float, true>(
        x, w, isc, y, B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW,
        make_epilogue<float>(osc, noise, bias, post0, post1, noise2, bias2,
                             mask, n_post, act, act2),
        s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, true>(
        x, w, isc, y, B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW,
        make_epilogue<__nv_bfloat16>(osc, noise, bias, post0, post1, noise2,
                                     bias2, mask, n_post, act, act2),
        s);
  return (int)cudaErrorInvalidValue;
}
