// K6: the styled-conv epilogue as one elementwise pass over a conv output,
//
//     y = lrelu(out_scale[b, c] * x + noise[b, h, w] + bias[c]) * sqrt2
//
// NHWC, every piece optional (null pointer, act = 0), noise (B, H, W, 1)
// already scaled by its gain. Read in x's dtype, computed in f32, stored
// once in x's dtype.
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_epilogue.py:_pallas (body
// _kernel), which streamed (1, h_t, W, C) row blocks through VMEM with the
// (B, C) scale and the bias resident. Its packed nc = 4 noise (phases
// expanded by an in-register dot) belongs to the space-to-depth layout and
// is not ported.
//
// What bounds it on the H100: bytes. Per element it reads x and writes y
// and does four or five flops; the noise map is C times smaller than x and
// the (B, C) scale and the bias stay in L1. The design: one thread per 16
// bytes of x (4 f32 or 8 bf16 channels of one pixel) when C is a multiple
// of that width and x is 16-byte aligned, so loads and stores are full
// 128-bit transactions; otherwise one thread per element (C = 3, odd C).
// A grid-stride loop keeps the grid at most 8192 blocks.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int NT = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
epilogue_kernel(const T* __restrict__ x, const T* __restrict__ osc,
                const T* __restrict__ noise, const T* __restrict__ bias,
                T* __restrict__ y, int n_vec, int C, int HW, int act) {
  const int cv = C / VEC;
  for (int v = blockIdx.x * NT + threadIdx.x; v < n_vec;
       v += gridDim.x * NT) {
    const int pix = v / cv;
    const int c = (v - pix * cv) * VEC;
    float a[VEC];
    load_vec<VEC>(x + (size_t)v * VEC, a);
    const float nz = noise ? to_f(noise[pix]) : 0.f;
    const T* os = osc ? osc + (size_t)(pix / HW) * C + c : nullptr;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float u = a[k];
      if (os) u *= to_f(os[k]);
      if (noise) u += nz;
      if (bias) u += to_f(bias[c + k]);
      if (act) u = lrelu_sqrt2(u);
      a[k] = u;
    }
    store_vec<VEC>(y + (size_t)v * VEC, a);
  }
}

template <typename T>
int launch(const void* x, const void* osc, const void* noise,
           const void* bias, void* y, int act, int n, int C, int HW,
           int aligned, cudaStream_t stream) {
  constexpr int V = kVec16<T>;
  if (aligned && C % V == 0) {
    const int n_vec = n / V;
    epilogue_kernel<T, V><<<stride_blocks(n_vec, NT), NT, 0, stream>>>(
        (const T*)x, (const T*)osc, (const T*)noise, (const T*)bias, (T*)y,
        n_vec, C, HW, act);
  } else {
    epilogue_kernel<T, 1><<<stride_blocks(n, NT), NT, 0, stream>>>(
        (const T*)x, (const T*)osc, (const T*)noise, (const T*)bias, (T*)y, n,
        C, HW, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// x, y: n = B*H*W*C elements (n < 2^31); osc (B, C), noise (B, H, W, 1),
// bias (C): null when absent; HW = H*W; aligned: x and y are 16-byte
// aligned.
extern "C" int vspbfr_conv_epilogue(const void* x, const void* osc,
                                    const void* noise, const void* bias,
                                    void* y, int act, int dtype, int n, int C,
                                    int HW, int aligned, void* stream) {
  using namespace vspbfr;
  if (n < 1 || C < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float>(x, osc, noise, bias, y, act, n, C, HW, aligned, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, osc, noise, bias, y, act, n, C, HW,
                                 aligned, s);
  return (int)cudaErrorInvalidValue;
}
