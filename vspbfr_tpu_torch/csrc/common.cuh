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

// VEC consecutive elements as f32: 16-byte accesses when VEC elements
// fill 16 bytes or a multiple (the pointer must then be 16-byte aligned),
// else scalars.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
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

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// --- the elementwise streaming body of K6 and K7 ----------------------------
//
// One pass over a flat NHWC tensor x of n elements with C channels:
//
//     u = x * osc[b, c] + noise[pix] + bias[c]      (stage 1; mask = u >= 0)
//     u = lrelu(u, slope) * gain + post0 + post1
//     y = lrelu(u + noise2[pix] + bias2[c]) * sqrt2  (stage 2)
//
// every piece optional. x, y and the post-adds are in the working dtype T;
// osc (B, C), noise and noise2 (nc values a pixel), bias and bias2 (C) in
// O, float or bf16, each rounded to T as it is read (what the JAX
// wrappers' astype(x.dtype) does). The arithmetic is f32 in registers; y
// is stored once, in T. nc is 1, or 4 in the space-to-depth layout, where
// channel c of a pixel adds its phase's value, phase c / (C / 4)
// (`_expand_matrix`, pallas_epilogue.py:33, as an index).
//
// Bound by bytes (read x and the post-adds, write y; a few flops an
// element). The design:
// - a thread takes one VEC-element vector (16 bytes when VEC > 1) a trip
//   of a grid-stride loop and starts its loads (x, the post-adds) before
//   the arithmetic; the grid is at most kStreamWaves waves of the blocks
//   that fit on the card at once;
// - vectors run over the flat index, so any C (3, odd widths) moves 16
//   bytes a thread: one division finds a vector's first pixel and
//   channel; VEC = 1 serves pointers that are not 16-byte aligned; the
//   last n % VEC elements go one a thread;
// - WHOLE (C % VEC == 0, with nc = 4 also (C / 4) % VEC == 0, and the
//   scale and bias rows 16-byte aligned): the vector lies in one pixel and
//   one phase, so its noises are one load each and its
//   scale and bias values one 16-byte row access each (the rows stay in
//   L1); otherwise the lanes step on channel by channel from the first
//   and read their operands an element at a time;
// - FORM fixes at compile time which pieces a pass can have (a scale and
//   noise, post-adds, a second stage; K7 none of them): a bf16 vector is 8
//   elements, so every instruction an absent piece costs per element shows
//   in the time. Present pieces take the same instructions on every
//   element (an absent scale is 1, an absent noise or bias 0, a stage
//   without activation has slope and gain 1).
// Several vectors a thread a trip over a one-wave grid, each thread's
// channels and scale held in registers, was measured in turns against
// this body and was no faster (PERF.md section 6).

constexpr int kStreamThreads = 256;
constexpr int kStreamWaves = 8;   // the grid's cap, in waves of blocks
constexpr int kEpiPost = 2;   // post-adds a streaming pass takes
// FORM bits: the pieces a streaming pass can have beyond bias + activation
constexpr int kScaleNoise = 1;   // osc, noise and the sign mask
constexpr int kPosts = 2;        // post-adds
constexpr int kStage2 = 4;       // noise2, bias2 and the second activation

template <typename T, typename O>
struct StreamArgs {
  const T* x;
  T* y;
  const O* osc;               // (B, C)
  const O* noise;             // (B, H, W, nc): nc values a pixel
  const O* bias;              // (C)
  const T* post[kEpiPost];    // like x, added after stage 1's activation
  const O* noise2;            // stage 2: like noise
  const O* bias2;             // (C)
  unsigned char* mask;        // like x, out: stage 1's pre-activation >= 0
  int n_post;
  // the activations' gains and slope * gain: 1 and 1 where a stage has
  // none, so every element takes the same instructions
  float gain, sgain, gain2, sgain2;
  int n;                      // elements (< 2^31)
  int C, HW;
  int nc = 1, cq = 0;         // noise values a pixel (1 or 4); C / nc
};

// Where the noise value of (pixel, channel c) lies.
template <typename T, typename O>
__device__ __forceinline__ int noise_at(const StreamArgs<T, O>& a, int pix,
                                        int c) {
  return a.nc == 1 ? pix : pix * a.nc + c / a.cq;
}

// One operand value, read through the read-only path, rounded to T.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
template <typename T, typename O>
__device__ __forceinline__ float ld_op(const O* p) {
  if constexpr (sizeof(O) <= sizeof(T))   // already representable in T
    return ldg_f(p);
  else
    return to_f(from_f<T>(ldg_f(p)));
}

// VEC mask bytes in one store.
template <int VEC>
__device__ __forceinline__ void store_mask(unsigned char* p,
                                           const bool (&m)[VEC]) {
  if constexpr (VEC == 8) {
    unsigned long long bits = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) bits |= (unsigned long long)m[e] << (8 * e);
    *reinterpret_cast<unsigned long long*>(p) = bits;
  } else if constexpr (VEC == 4) {
    unsigned int bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) bits |= (unsigned int)m[e] << (8 * e);
    *reinterpret_cast<unsigned int*>(p) = bits;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = m[e];
  }
}

// The chain on one element: u is x's value, os the scale (1 where
// absent), a1 = noise + bias, pp the post-adds' sum, a2 = noise2 + bias2.
template <int FORM, typename T, typename O>
__device__ __forceinline__ float stream_elem(const StreamArgs<T, O>& a,
                                             float u, float os, float a1,
                                             float pp, float a2, bool& m) {
  u = (FORM & kScaleNoise) ? fmaf(u, os, a1) : u + a1;
  m = u >= 0.f;
  u *= m ? a.gain : a.sgain;
  if constexpr ((FORM & kPosts) != 0) u += pp;
  if constexpr ((FORM & kStage2) != 0) {
    u += a2;
    u *= u >= 0.f ? a.gain2 : a.sgain2;
  }
  return u;
}

// VEC operand values from p, each rounded to T: one 16-byte access (two for
// eight floats) when VEC > 1, p then 16-byte aligned. O is T or float.
template <typename T, typename O, int VEC>
__device__ __forceinline__ void ld_row(const O* p, float (&v)[VEC]) {
  load_vec<VEC>(p, v);
  if constexpr (sizeof(O) > sizeof(T)) {   // floats beside bf16 x
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = to_f(from_f<T>(v[e]));
  }
}

// The chain on the VEC elements from flat index f: one 16-byte access of
// x (and of each post-add) when VEC > 1.
template <typename T, typename O, int VEC, bool WHOLE, int FORM>
__device__ __forceinline__ void stream_vec(const StreamArgs<T, O>& a,
                                           int f) {
  constexpr bool SN = (FORM & kScaleNoise) != 0;
  constexpr bool POSTS = (FORM & kPosts) != 0;
  constexpr bool S2 = (FORM & kStage2) != 0;
  float u[VEC], p0[VEC] = {}, p1[VEC] = {};
  load_vec<VEC>(a.x + f, u);
  if constexpr (POSTS) {
    if (a.n_post > 0) load_vec<VEC>(a.post[0] + f, p0);
    if (a.n_post > 1) load_vec<VEC>(a.post[1] + f, p1);
  }
  const int C = a.C, HW = a.HW;
  // the first element's pixel and channel, its batch
  int pix = f / C, c = f - pix * C, b = SN ? pix / HW : 0;
  // each lane's scale (1 where absent), noise + bias and noise2 + bias2
  float os[VEC], a1[VEC], a2[VEC];
  if constexpr (WHOLE) {   // one pixel: its noises once, the rows as vectors
    const int q = SN || S2 ? noise_at(a, pix, c) : 0;
    const float nz = SN && a.noise ? ld_op<T>(a.noise + q) : 0.f;
    const float nz2 = S2 && a.noise2 ? ld_op<T>(a.noise2 + q) : 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) os[e] = 1.f, a1[e] = 0.f, a2[e] = 0.f;
    if (SN && a.osc) ld_row<T>(a.osc + b * C + c, os);
    if (a.bias) ld_row<T>(a.bias + c, a1);
    if (S2 && a.bias2) ld_row<T>(a.bias2 + c, a2);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a1[e] += nz, a2[e] += nz2;
  } else {   // the lanes step on channel by channel, pixel by pixel
    int r = pix - b * HW;   // the pixel in its batch
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (e > 0 && ++c == C) {
        c = 0;
        ++pix;
        if (SN && ++r == HW) {
          r = 0;
          ++b;
        }
      }
      const int q = SN || S2 ? noise_at(a, pix, c) : 0;
      os[e] = SN && a.osc ? ld_op<T>(a.osc + b * C + c) : 1.f;
      a1[e] = (a.bias ? ld_op<T>(a.bias + c) : 0.f) +
              (SN && a.noise ? ld_op<T>(a.noise + q) : 0.f);
      a2[e] = S2 ? (a.noise2 ? ld_op<T>(a.noise2 + q) : 0.f) +
                       (a.bias2 ? ld_op<T>(a.bias2 + c) : 0.f)
                 : 0.f;
    }
  }
  bool m[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    u[e] = stream_elem<FORM>(a, u[e], os[e], a1[e], p0[e] + p1[e], a2[e],
                             m[e]);
  store_vec<VEC>(a.y + f, u);
  if (SN && a.mask) store_mask<VEC>(a.mask + f, m);
}

template <typename T, typename O, int VEC, bool WHOLE, int FORM>
__device__ __forceinline__ void stream_body(const StreamArgs<T, O>& a) {
  // unsigned: n < 2^31 and the grid's threads are far fewer, so v + step
  // stays below 2^32
  const unsigned n_vec = a.n / VEC, step = gridDim.x * blockDim.x;
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  for (unsigned v = g; v < n_vec; v += step)
    stream_vec<T, O, VEC, WHOLE, FORM>(a, (int)(v * VEC));
  // the last n % VEC elements, one a thread
  if (VEC > 1 && g < a.n - n_vec * VEC)
    stream_vec<T, O, 1, true, FORM>(a, (int)(n_vec * VEC + g));
}

// Multiprocessors of the current device (read once per device).
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!count[dev])
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Launch a streaming kernel over a.n elements in vectors of VEC: one
// thread a vector, at most kStreamWaves waves of the blocks that fit on
// the card at once (a grid-stride loop takes the rest). per_sm caches the
// kernel's blocks per multiprocessor.
template <typename T, typename O, int VEC>
inline int stream_launch(void (*kernel)(StreamArgs<T, O>), int& per_sm,
                         const StreamArgs<T, O>& a, cudaStream_t stream) {
  constexpr long long NT = kStreamThreads;
  if (!per_sm &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, (int)NT,
                                                    0) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long want = (a.n / VEC + NT - 1) / NT;
  const long long fit =
      (long long)kStreamWaves * sm_count() * (per_sm > 0 ? per_sm : 1);
  const long long blocks = want < 1 ? 1 : (want < fit ? want : fit);
  kernel<<<(unsigned)blocks, (unsigned)NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vspbfr
