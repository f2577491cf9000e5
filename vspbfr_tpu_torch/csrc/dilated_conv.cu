// K2: several same-input 3x3 "same" dilated convolutions in one pass, their
// outputs concatenated on channels, with an optional per-(batch, in-channel)
// input scale and per-(batch, out-channel) output scale (the demodulation)
// applied at the store. NHWC in and out; the branch weights arrive already
// concatenated as one (3, 3, Ci, sum Co) HWIO tensor.
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_dilated.py:_multi_pallas
// (body _multi_kernel): SMART's four dilation-1/2/4/8 branches over one
// shared input stripe, so that each narrow branch (Co = C/4) does not run
// as its own lane-starved conv.
//
// What bounds it on the H100: compute at the large widths (9 * sum(Co)
// multiply-adds per input element), and the halo at the small ones: the
// shared input tile carries an 8-pixel halo on every side (the largest
// dilation), so an 8x8 tile reads a 24x24 window. The design reads that
// window once per 8-channel input chunk for all branches together; each
// thread owns 4 pixels x 4 output channels of the concatenated output and
// looks up its channels' dilations once, so the branches need no separate
// passes and the concatenation costs nothing. At 4x4 and 8x8 images most
// dilation-8 taps land in the zero halo, which is produced by bounds
// checks. CUDA cores only; wgmma comes later.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int TH = 8, TW = 8, TCO = 64, CK = 8, NT = 256, MAXB = 8;

struct Branches {
  int n;
  int dil[MAXB];
  int end[MAXB];  // exclusive end channel of each branch in the concat
};

template <typename T>
__global__ void __launch_bounds__(NT)
dilated_multi_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ isc, const T* __restrict__ osc,
                     T* __restrict__ y, int H, int W, int Ci, int CoT, int P,
                     Branches br, int tiles_x) {
  extern __shared__ float smem[];
  const int IH = TH + 2 * P, IW = TW + 2 * P;
  float* xs = smem;                 // [CK][IH][IW]
  float* ws = smem + CK * IH * IW;  // [9][CK][TCO]
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * TCO;
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;

  int pofs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    pofs[i] = (p / TW + P) * IW + (p % TW + P);
  }
  int dil[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tc + 16 * j;
    dil[j] = 0;
    for (int k = br.n - 1; k >= 0; --k)
      if (co < br.end[k]) dil[j] = br.dil[k];
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
      const int gy = ty0 + iy - P, gx = tx0 + ix - P, gc = c0 + ci;
      float v = 0.f;
      if (gc < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * Ci + gc]);
        if (isc) v *= to_f(isc[(size_t)b * Ci + gc]);
      }
      xs[(ci * IH + iy) * IW + ix] = v;
    }
    for (int e = tid; e < 9 * CK * TCO; e += NT) {
      const int co = e % TCO, r = e / TCO;
      const int ci = r % CK, tap = r / CK;
      const int gc = c0 + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < Ci && gco < CoT) v = to_f(w[((size_t)tap * Ci + gc) * CoT + gco]);
      ws[(tap * CK + ci) * TCO + co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3 - 1, kx = tap % 3 - 1;
      int toff[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) toff[j] = ky * dil[j] * IW + kx * dil[j];
#pragma unroll 2
      for (int ci = 0; ci < CK; ++ci) {
        const float* xr = xs + ci * IH * IW;
        const float* wr = ws + (tap * CK + ci) * TCO + tc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = wr[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(xr[pofs[i] + toff[j]], bv, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int oy = ty0 + p / TW, ox = tx0 + p % TW;
    if (oy >= H || ox >= W) continue;
    T* yr = y + (((size_t)b * H + oy) * W + ox) * CoT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tc + 16 * j;
      if (co >= CoT) continue;
      float v = acc[i][j];
      if (osc) v *= to_f(osc[(size_t)b * CoT + co]);
      yr[co] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* isc, const void* osc,
           void* y, int B, int H, int W, int Ci, int CoT, const Branches& br,
           cudaStream_t stream) {
  int P = 0;
  for (int k = 0; k < br.n; ++k) P = br.dil[k] > P ? br.dil[k] : P;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const size_t smem =
      (size_t)(CK * (TH + 2 * P) * (TW + 2 * P) + 9 * CK * TCO) * sizeof(float);
  cudaError_t err = set_smem(dilated_multi_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles_x * tiles_y, (CoT + TCO - 1) / TCO, B);
  dilated_multi_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)isc, (const T*)osc, (T*)y, H, W, Ci,
      CoT, P, br, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// dils / cos: n_branches host ints (dilation and output width per branch).
extern "C" int vspbfr_dilated_multi_conv(const void* x, const void* w,
                                         const void* isc, const void* osc,
                                         void* y, int dtype, int B, int H,
                                         int W, int Ci, int n_branches,
                                         const int* dils, const int* cos,
                                         void* stream) {
  using namespace vspbfr;
  if (n_branches < 1 || n_branches > MAXB) return (int)cudaErrorInvalidValue;
  Branches br;
  br.n = n_branches;
  int end = 0;
  for (int k = 0; k < MAXB; ++k) {
    if (k < n_branches) {
      end += cos[k];
      br.dil[k] = dils[k];
    } else {
      br.dil[k] = 0;
    }
    br.end[k] = end;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float>(x, w, isc, osc, y, B, H, W, Ci, end, br, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, isc, osc, y, B, H, W, Ci, end, br, s);
  return (int)cudaErrorInvalidValue;
}
