// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads f32 or bf16 and accumulates in f32. Each C entry point
// takes a dtype code (0 = float32, 1 = bfloat16), launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vspbfr {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// leaky ReLU times a gain: StyleGAN2's fused activation is slope 0.2, gain
// sqrt(2).
__device__ __forceinline__ float lrelu(float v, float slope, float gain) {
  return (v >= 0.f ? v : slope * v) * gain;
}
__device__ __forceinline__ float lrelu_sqrt2(float v) {
  return lrelu(v, 0.2f, 1.41421356237309515f);
}

// VEC consecutive elements as f32: one 16-byte access when VEC elements
// fill 16 bytes (the pointer must then be 16-byte aligned), else scalars.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __bfloat162float(p[k]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = __float2bfloat16(v[k]);
  }
}

// Elements of T in one 16-byte access.
template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);

// Blocks for a grid-stride elementwise launch over n items of nt threads.
inline int stride_blocks(long long n, int nt) {
  const long long want = (n + nt - 1) / nt;
  return (int)(want < 1 ? 1 : (want > 8192 ? 8192 : want));
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace vspbfr
