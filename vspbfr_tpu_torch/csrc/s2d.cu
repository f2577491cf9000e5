// K4: grouped space-to-depth (phase gather), the inverse of K3,
//   y[b, i, j, (2*gy+gx)*inner + c] = x[b, 2i+gy, 2j+gx, c].
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_d2s.py:_s2d_pallas, which
// read each row parity as its own tile and merged adjacent column pairs
// into lanes. It is the backward of every subpixel up-conv (K1 + K3).
//
// What bounds it on the H100: memory bandwidth. It moves each byte once
// and computes nothing. For a fixed output pixel (b, i, j) the output row
// is the concatenation over gy of the 2*inner contiguous values
// x[b, 2i+gy, 2j : 2j+2, :], so consecutive threads write consecutive
// addresses and read runs of 2*inner contiguous elements. The permutation
// does not depend on the element type: the kernel moves opaque units of 16
// bytes (uint4) where inner * itemsize and the pointers allow it, else 8, 4
// or 2 bytes, so one kernel serves f32 and bf16.
#include "common.cuh"

namespace vspbfr {
namespace {

template <typename U>
__global__ void __launch_bounds__(256)
s2d_kernel(const U* __restrict__ x, U* __restrict__ y, long long total, int h,
           int w, int inner_u) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const int c = (int)(o % inner_u);
    long long r = o / inner_u;
    const int g = (int)(r % 4);
    r /= 4;
    const int j = (int)(r % w);
    r /= w;
    const int i = (int)(r % h);
    const long long b = r / h;
    const int gy = g >> 1, gx = g & 1;
    y[o] = x[((b * 2 * h + 2 * i + gy) * (2LL * w) + 2 * j + gx) *
                 (long long)inner_u + c];
  }
}

template <typename U>
int launch(const void* x, void* y, int B, int h, int w, int inner_u,
           cudaStream_t stream) {
  const long long total = (long long)B * 4 * h * w * inner_u;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  s2d_kernel<U><<<(unsigned)blocks, 256, 0, stream>>>(
      (const U*)x, (U*)y, total, h, w, inner_u);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// (h, w) is the OUTPUT grid (the input is 2h x 2w). unit_bytes in
// {16, 8, 4, 2}; inner_bytes = inner * itemsize must be a multiple of it
// (the wrapper checks this and the pointer alignment).
extern "C" int vspbfr_s2d(const void* x, void* y, int B, int h, int w,
                          int inner_bytes, int unit_bytes, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (unit_bytes <= 0 || inner_bytes % unit_bytes)
    return (int)cudaErrorInvalidValue;
  const int inner_u = inner_bytes / unit_bytes;
  switch (unit_bytes) {
    case 16: return launch<uint4>(x, y, B, h, w, inner_u, s);
    case 8: return launch<uint2>(x, y, B, h, w, inner_u, s);
    case 4: return launch<unsigned int>(x, y, B, h, w, inner_u, s);
    case 2: return launch<unsigned short>(x, y, B, h, w, inner_u, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
