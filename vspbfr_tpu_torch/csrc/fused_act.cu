// K7: bias + leaky ReLU times a gain over (..., C),
//
//     y = lrelu(x + bias[c], slope) * gain       (slope 0.2, gain sqrt2)
//
// bias optional, in f32 or bf16, rounded to x's dtype as it is read. Read
// in x's dtype, computed in f32, stored once in x's dtype.
//
// Replaces the TPU kernel vspbfr_tpu/ops/fused_act.py:fused_leaky_relu_pallas
// (body _flr_kernel), which ran (block_n, C) row blocks with C % 128 == 0
// and fell back to XLA otherwise; here every C takes the kernel.
//
// What bounds it on the H100: bytes (read x, write y; two or three flops
// per element). It is K6 with the bias and the activation only: the same
// streaming body (`stream_body`, common.cuh) with the chain's other pieces
// compiled out, and its own slope and gain.
#include "common.cuh"

namespace vspbfr {
namespace {

template <typename T, typename O, int VEC, bool WHOLE>
__global__ void __launch_bounds__(kStreamThreads)
fused_lrelu_kernel(const StreamArgs<T, O> a) {
  stream_body<T, O, VEC, WHOLE, 0>(a);
}

template <typename T, typename O, int VEC, bool WHOLE>
int launch_form(const StreamArgs<T, O>& a, cudaStream_t stream) {
  static int per_sm = 0;
  return stream_launch<T, O, VEC>(fused_lrelu_kernel<T, O, VEC, WHOLE>,
                                  per_sm, a, stream);
}

template <typename T, typename O>
int launch(const void* x, const void* bias, void* y, int n, int C,
           int aligned, float slope, float gain, cudaStream_t stream) {
  StreamArgs<T, O> a = {};
  a.x = (const T*)x;
  a.y = (T*)y;
  a.bias = (const O*)bias;
  a.gain = gain;
  a.sgain = slope * gain;
  a.n = n;
  a.C = C;
  a.HW = 1;
  constexpr int V = kVec16<T>;
  if (!aligned) return launch_form<T, O, 1, true>(a, stream);
  if (C % V == 0 && (uintptr_t)bias % 16 == 0)
    return launch_form<T, O, V, true>(a, stream);
  return launch_form<T, O, V, false>(a, stream);
}

}  // namespace
}  // namespace vspbfr

// One launch's arguments, packed by the wrapper (LAUNCH_FIELDS,
// ops/fused_act.py), passed with the stream. x, y: n elements (n < 2^31)
// of trailing width C in `dtype`; bias (C) in `op_dtype` (x's, or
// float32), or 0; aligned: x and y are 16-byte aligned.
struct K7Launch {
  long long x, bias, y, dtype, op_dtype, n, C, aligned;
  double slope, gain;
};

extern "C" int vspbfr_fused_lrelu(const K7Launch* p, void* stream) {
  using namespace vspbfr;
  if (p->n < 1 || p->n >= (1LL << 31) || p->C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define VSPBFR_K7(T, O)                                                    \
  return launch<T, O>((const void*)p->x, (const void*)p->bias,            \
                      (void*)p->y, (int)p->n, (int)p->C, (int)p->aligned, \
                      (float)p->slope, (float)p->gain, s)
  if (p->dtype == kF32 && p->op_dtype == kF32) VSPBFR_K7(float, float);
  if (p->dtype == kBF16 && p->op_dtype == kF32)
    VSPBFR_K7(__nv_bfloat16, float);
  if (p->dtype == kBF16 && p->op_dtype == kBF16)
    VSPBFR_K7(__nv_bfloat16, __nv_bfloat16);
#undef VSPBFR_K7
  return (int)cudaErrorInvalidValue;
}
