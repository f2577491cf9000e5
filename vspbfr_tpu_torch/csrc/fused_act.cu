// K7: bias + leaky ReLU times a gain over (..., C),
//
//     y = lrelu(x + bias[c], slope) * gain       (slope 0.2, gain sqrt2)
//
// bias optional. Read in x's dtype, computed in f32, stored once in x's
// dtype.
//
// Replaces the TPU kernel vspbfr_tpu/ops/fused_act.py:fused_leaky_relu_pallas
// (body _flr_kernel), which ran (block_n, C) row blocks with C % 128 == 0
// and fell back to XLA otherwise; here every C takes the kernel.
//
// What bounds it on the H100: bytes (read x, write y; two or three flops
// per element). The design is K6's: one thread per 16 bytes of x when C is
// a multiple of that width and x is 16-byte aligned, else one per element,
// in a grid-stride loop.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int NT = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
fused_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                   T* __restrict__ y, int n_vec, int C, float slope,
                   float gain) {
  const int cv = C / VEC;
  for (int v = blockIdx.x * NT + threadIdx.x; v < n_vec;
       v += gridDim.x * NT) {
    float a[VEC];
    load_vec<VEC>(x + (size_t)v * VEC, a);
    const int c = bias ? (v % cv) * VEC : 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float u = a[k];
      if (bias) u += to_f(bias[c + k]);
      a[k] = lrelu(u, slope, gain);
    }
    store_vec<VEC>(y + (size_t)v * VEC, a);
  }
}

template <typename T>
int launch(const void* x, const void* bias, void* y, int n, int C,
           int aligned, float slope, float gain, cudaStream_t stream) {
  constexpr int V = kVec16<T>;
  if (aligned && C % V == 0) {
    const int n_vec = n / V;
    fused_lrelu_kernel<T, V><<<stride_blocks(n_vec, NT), NT, 0, stream>>>(
        (const T*)x, (const T*)bias, (T*)y, n_vec, C, slope, gain);
  } else {
    fused_lrelu_kernel<T, 1><<<stride_blocks(n, NT), NT, 0, stream>>>(
        (const T*)x, (const T*)bias, (T*)y, n, C, slope, gain);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// x, y: n elements (n < 2^31) of trailing width C; bias (C) or null;
// aligned: x and y are 16-byte aligned.
extern "C" int vspbfr_fused_lrelu(const void* x, const void* bias, void* y,
                                  int dtype, int n, int C, int aligned,
                                  float slope, float gain, void* stream) {
  using namespace vspbfr;
  if (n < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float>(x, bias, y, n, C, aligned, slope, gain, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, bias, y, n, C, aligned, slope, gain, s);
  return (int)cudaErrorInvalidValue;
}
