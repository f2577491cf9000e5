// K3: grouped depth-to-space (phase interleave),
//   y[b, 2i+gy, 2j+gx, c] = x[b, i, j, (2*gy+gx)*inner + c].
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_d2s.py:_d2s_pallas, which
// wrote each row parity as its own contiguous tile.
//
// What bounds it on the H100: memory bandwidth. It moves each byte once
// and computes nothing. For a fixed output row (b, 2i+gy) the output is the
// concatenation over j of the 2*inner contiguous values
// x[b, i, j, 2*gy*inner : (2*gy+2)*inner], so consecutive threads read and
// write consecutive addresses in runs of 2*inner elements. The permutation
// does not depend on the element type: the kernel moves opaque units of
// 16 bytes (uint4) where inner * itemsize and the pointers allow it, else
// 8, 4 or 2 bytes, so one kernel serves f32 and bf16.
#include "common.cuh"

namespace vspbfr {
namespace {

template <typename U>
__global__ void __launch_bounds__(256)
d2s_kernel(const U* __restrict__ x, U* __restrict__ y, long long total, int h,
           int w, int inner_u) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const int c = (int)(o % inner_u);
    long long r = o / inner_u;
    const int ox = (int)(r % (2 * w));
    r /= 2 * w;
    const int oy = (int)(r % (2 * h));
    const long long b = r / (2 * h);
    const int i = oy >> 1, gy = oy & 1, j = ox >> 1, gx = ox & 1;
    y[o] = x[(((b * h + i) * w + j) * 4 + 2 * gy + gx) * (long long)inner_u + c];
  }
}

template <typename U>
int launch(const void* x, void* y, int B, int h, int w, int inner_u,
           cudaStream_t stream) {
  const long long total = (long long)B * 4 * h * w * inner_u;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  d2s_kernel<U><<<(unsigned)blocks, 256, 0, stream>>>(
      (const U*)x, (U*)y, total, h, w, inner_u);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// unit_bytes in {16, 8, 4, 2}; inner_bytes = inner * itemsize must be a
// multiple of it (the wrapper checks this and the pointer alignment).
extern "C" int vspbfr_d2s(const void* x, void* y, int B, int h, int w,
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
