// K6: the styled-conv epilogue chain as one elementwise pass over a conv
// output (the JAX package's `_epi_ref`, pallas_conv.py:387),
//
//     u = out_scale[b, c] * x + noise[b, h, w] + bias[c]
//     u = lrelu(u) * sqrt2 + post0 + post1           (stage 1, the skips)
//     y = lrelu(u + noise2[b, h, w] + bias2[c]) * sqrt2   (stage 2)
//
// NHWC, every piece optional (null pointer, act / act2 = 0), the noises
// (B, H, W, nc) already scaled by their gains: nc = 1, or nc = 4 in the
// space-to-depth layout, where channel c adds phase c / (C / 4)'s value. x, y and the post-adds in
// x's dtype; the other operands in f32 or bf16 (one code for all), rounded
// to x's dtype as they are read. Computed in f32, stored once in x's
// dtype; where asked, the sign of stage 1's pre-activation is stored as one
// byte an element (the backward's slope where something follows stage 1).
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_epilogue.py:_pallas (body
// _kernel), which streamed (1, h_t, W, C) row blocks through VMEM with the
// (B, C) scale and the bias resident, one stage a call; XLA fused the
// post-adds and the second stage around it. Its packed nc = 4 noise
// (phases expanded by an in-register dot with a (4, C) 0/1 matrix) is here
// an index: a vector within one phase reads one value, others one an
// element (`noise_at`, common.cuh).
//
// What bounds it on the H100: bytes. Per element it reads x (and each
// post-add) and writes y, with a handful of flops; the noise maps are C
// times smaller than x and the (B, C) scale and the biases stay in
// registers or L1. One pass does the whole chain, so the post-adds and the
// second stage cost no extra round trip through device memory. The body,
// shared with K7, is `stream_body` (common.cuh): one 16-byte vector a
// thread a trip, flat vectors for any C, the pieces a pass lacks compiled
// out.
#include "common.cuh"

namespace vspbfr {
namespace {

template <typename T, typename O, int VEC, bool WHOLE, int FORM>
__global__ void __launch_bounds__(kStreamThreads)
epilogue_kernel(const StreamArgs<T, O> a) {
  stream_body<T, O, VEC, WHOLE, FORM>(a);
}

// The forms K6 takes: a scale, noise and mask always possible, with or
// without post-adds and a second stage. The one-element path (pointers off
// 16 bytes) takes the full form.
constexpr int kFull = kScaleNoise | kPosts | kStage2;

template <typename T, typename O, int VEC, bool WHOLE, int FORM>
int launch_kernel(const StreamArgs<T, O>& a, cudaStream_t stream) {
  static int per_sm = 0;
  return stream_launch<T, O, VEC>(epilogue_kernel<T, O, VEC, WHOLE, FORM>,
                                  per_sm, a, stream);
}

template <typename T, typename O, int VEC, bool WHOLE>
int launch_form(const StreamArgs<T, O>& a, int form, cudaStream_t stream) {
  if constexpr (VEC == 1) {
    return launch_kernel<T, O, 1, WHOLE, kFull>(a, stream);
  } else {
    switch (form) {
      case kScaleNoise:
        return launch_kernel<T, O, VEC, WHOLE, kScaleNoise>(a, stream);
      case kScaleNoise | kPosts:
        return launch_kernel<T, O, VEC, WHOLE, kScaleNoise | kPosts>(a,
                                                                     stream);
      case kScaleNoise | kStage2:
        return launch_kernel<T, O, VEC, WHOLE, kScaleNoise | kStage2>(a,
                                                                      stream);
      default:
        return launch_kernel<T, O, VEC, WHOLE, kFull>(a, stream);
    }
  }
}

template <typename T, typename O>
int launch(const void* x, void* y, const void* osc, const void* noise,
           const void* bias, const void* post0, const void* post1,
           const void* noise2, const void* bias2, void* mask, int n_post,
           int act, int act2, int n, int C, int HW, int aligned, int nc,
           cudaStream_t stream) {
  constexpr float kGain = 1.41421356237309515f, kSlope = 0.2f;
  StreamArgs<T, O> a;
  a.x = (const T*)x;
  a.y = (T*)y;
  a.osc = (const O*)osc;
  a.noise = (const O*)noise;
  a.bias = (const O*)bias;
  a.post[0] = (const T*)post0;
  a.post[1] = (const T*)post1;
  a.noise2 = (const O*)noise2;
  a.bias2 = (const O*)bias2;
  a.mask = (unsigned char*)mask;
  a.n_post = n_post;
  a.gain = act ? kGain : 1.f;
  a.sgain = act ? kSlope * kGain : 1.f;
  a.gain2 = act2 ? kGain : 1.f;
  a.sgain2 = act2 ? kSlope * kGain : 1.f;
  a.n = n;
  a.C = C;
  a.HW = HW;
  a.nc = nc;
  a.cq = C / nc;
  const int form = kScaleNoise | (n_post ? kPosts : 0) |
                   (noise2 || bias2 || act2 ? kStage2 : 0);
  constexpr int V = kVec16<T>;
  if (!aligned) return launch_form<T, O, 1, true>(a, form, stream);
  const bool rows =
      ((uintptr_t)osc | (uintptr_t)bias | (uintptr_t)bias2) % 16 == 0;
  if (C % V == 0 && (C / nc) % V == 0 && rows)
    return launch_form<T, O, V, true>(a, form, stream);
  return launch_form<T, O, V, false>(a, form, stream);
}

}  // namespace
}  // namespace vspbfr

// One launch's arguments, packed by the wrapper (LAUNCH_FIELDS,
// ops/epilogue.py): one buffer and the stream are cheaper to pass through
// ctypes than 20 arguments. x, y, post0, post1: n = B*H*W*C elements (n <
// 2^31) in `dtype`; osc (B, C), noise and noise2 (B, H, W, nc), bias and
// bias2 (C) in `op_dtype` (x's, or float32); each 0 when absent; n_post <=
// 2 (the posts are taken in order); mask (uint8, x's shape) written when
// not 0; HW = H*W; aligned: x, y and the posts are 16-byte aligned; nc: 1,
// or 4 with C % 4 == 0.
struct K6Launch {
  long long x, y, osc, noise, bias, post0, post1, noise2, bias2, mask;
  long long n_post, act, act2, dtype, op_dtype, n, C, HW, aligned, nc;
};

extern "C" int vspbfr_conv_epilogue(const K6Launch* p, void* stream) {
  using namespace vspbfr;
  if (p->n < 1 || p->n >= (1LL << 31) || p->C < 1 || p->HW < 1 ||
      p->n_post < 0 || p->n_post > kEpiPost ||
      !(p->nc == 1 || (p->nc == 4 && p->C % 4 == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define VSPBFR_K6(T, O)                                                      \
  return launch<T, O>((const void*)p->x, (void*)p->y, (const void*)p->osc,  \
                      (const void*)p->noise, (const void*)p->bias,          \
                      (const void*)p->post0, (const void*)p->post1,         \
                      (const void*)p->noise2, (const void*)p->bias2,        \
                      (void*)p->mask, (int)p->n_post, (int)p->act,          \
                      (int)p->act2, (int)p->n, (int)p->C, (int)p->HW,       \
                      (int)p->aligned, (int)p->nc, s)
  if (p->dtype == kF32 && p->op_dtype == kF32) VSPBFR_K6(float, float);
  if (p->dtype == kBF16 && p->op_dtype == kF32)
    VSPBFR_K6(__nv_bfloat16, float);
  if (p->dtype == kBF16 && p->op_dtype == kBF16)
    VSPBFR_K6(__nv_bfloat16, __nv_bfloat16);
#undef VSPBFR_K6
  return (int)cudaErrorInvalidValue;
}
