// K8: two more forms of K3's phase interleave,
//   y[b, 2i+gy, 2j+gx, c] = x[b, i, j, (2*gy+gx)*inner + c],
// the forms scripts/exp_interleave.py compared on the TPU.
//
// Replaces the TPU kernel scripts/exp_interleave.py:_pallas_call with its
// two bodies, pallas_stack (one grid step per h_t input rows, each gy's two
// phases stacked into one output row) and pallas_repeat (each phase
// repeated along the row, then picked by the output column's parity).
//
// What bounds it on the H100: memory bandwidth; it moves each byte once and
// computes nothing. The two forms differ only in how they walk the data,
// which is what the TPU experiment measured:
//
// - stack: one block per (b, kRows input rows, a chunk of JT input
//   columns); kRows is 4, the script's h_t, and h need not be a multiple.
//   For each of its rows the block stages the chunk x[b, i, j0:j0+JT, :]
//   (contiguous in memory) in shared memory with 16-byte coalesced loads,
//   then writes the two output rows 2i and 2i+1 over columns 2*j0 ..
//   2*(j0+JT) as two contiguous streams read from the staged tile.
// - repeat: one thread per output unit, no loop: blockIdx.x is the output
//   row, blockIdx.y * blockDim.x + threadIdx.x the unit within it; the
//   source phase is 2*gy or 2*gy + 1 by the output column's parity.
//
// Neither calls K3 (csrc/d2s.cu, a grid-stride gather). Like K3 both move
// opaque units of 16 bytes (uint4) where inner * itemsize and the pointers
// allow it, else 8, 4 or 2 bytes, so one kernel serves f32 and bf16.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 32 * 1024;   // target size of one staged chunk
constexpr int kRows = 4;                 // input rows one stack block walks

template <typename U>
__global__ void __launch_bounds__(kThreads)
interleave_stack_kernel(const U* __restrict__ x, U* __restrict__ y, int h,
                        int w, int inner_u, int jt, int tiles_j) {
  extern __shared__ uint4 stage_raw[];
  U* tile = reinterpret_cast<U*>(stage_raw);
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_j) * kRows;
  const int j0 = (blockIdx.x % tiles_j) * jt;
  const int nj = min(jt, w - j0);
  const int in_run = 4 * inner_u * nj;    // units staged per input row
  const int out_run = 2 * inner_u * nj;   // units written per output row
  for (int i = i0; i < min(i0 + kRows, h); ++i) {
    const U* src = x + (((size_t)b * h + i) * w + j0) * 4 * inner_u;
    for (int e = threadIdx.x; e < in_run; e += kThreads) tile[e] = src[e];
    __syncthreads();
#pragma unroll
    for (int gy = 0; gy < 2; ++gy) {
      U* dst = y + (((size_t)b * 2 * h + 2 * i + gy) * 2 * w + 2 * j0) *
                       inner_u;
      for (int e = threadIdx.x; e < out_run; e += kThreads) {
        const int c = e % inner_u, q = e / inner_u;   // q = 2 * jj + gx
        dst[e] = tile[((q >> 1) * 4 + 2 * gy + (q & 1)) * inner_u + c];
      }
    }
    __syncthreads();
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
interleave_repeat_kernel(const U* __restrict__ x, U* __restrict__ y, int h,
                         int w, int inner_u) {
  const int row_units = 2 * w * inner_u;
  const int q = blockIdx.y * kThreads + threadIdx.x;
  if (q >= row_units) return;
  const long long orow = blockIdx.x;          // b * 2h + oy
  const int oy = (int)(orow % (2 * h));
  const long long b = orow / (2 * h);
  const int ox = q / inner_u, c = q % inner_u;
  const int gy = oy & 1;
  const int phase = (ox & 1) == 0 ? 2 * gy : 2 * gy + 1;
  y[orow * row_units + q] =
      x[((b * h + (oy >> 1)) * w + (ox >> 1)) * 4 * (long long)inner_u +
        phase * inner_u + c];
}

template <typename U>
int launch_stack(const void* x, void* y, int B, int h, int w, int inner_u,
                 cudaStream_t stream) {
  const int j_bytes = 4 * inner_u * (int)sizeof(U);
  int jt = kStageBytes / j_bytes;
  jt = jt < 1 ? 1 : (jt > w ? w : jt);
  const size_t smem = (size_t)jt * j_bytes;
  cudaError_t err = set_smem(interleave_stack_kernel<U>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_j = (w + jt - 1) / jt;
  const long long blocks = (long long)((h + kRows - 1) / kRows) * tiles_j;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  interleave_stack_kernel<U><<<dim3((unsigned)blocks, B), kThreads, smem,
                               stream>>>((const U*)x, (U*)y, h, w, inner_u,
                                         jt, tiles_j);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_repeat(const void* x, void* y, int B, int h, int w, int inner_u,
                  cudaStream_t stream) {
  const long long rows = 2LL * B * h;
  const long long row_blocks =
      (2LL * w * inner_u + kThreads - 1) / kThreads;
  if (rows > 0x7fffffffLL || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  interleave_repeat_kernel<U><<<dim3((unsigned)rows, (unsigned)row_blocks),
                                kThreads, 0, stream>>>((const U*)x, (U*)y, h,
                                                       w, inner_u);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vspbfr

// unit_bytes in {16, 8, 4, 2}; inner_bytes = inner * itemsize must be a
// multiple of it (the wrapper checks this and the pointer alignment).
extern "C" int vspbfr_interleave_stack(const void* x, void* y, int B, int h,
                                       int w, int inner_bytes,
                                       int unit_bytes, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (unit_bytes <= 0 || inner_bytes % unit_bytes)
    return (int)cudaErrorInvalidValue;
  const int iu = inner_bytes / unit_bytes;
  switch (unit_bytes) {
    case 16: return launch_stack<uint4>(x, y, B, h, w, iu, s);
    case 8: return launch_stack<uint2>(x, y, B, h, w, iu, s);
    case 4: return launch_stack<unsigned int>(x, y, B, h, w, iu, s);
    case 2: return launch_stack<unsigned short>(x, y, B, h, w, iu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vspbfr_interleave_repeat(const void* x, void* y, int B, int h,
                                        int w, int inner_bytes,
                                        int unit_bytes, void* stream) {
  using namespace vspbfr;
  cudaStream_t s = (cudaStream_t)stream;
  if (unit_bytes <= 0 || inner_bytes % unit_bytes)
    return (int)cudaErrorInvalidValue;
  const int iu = inner_bytes / unit_bytes;
  switch (unit_bytes) {
    case 16: return launch_repeat<uint4>(x, y, B, h, w, iu, s);
    case 8: return launch_repeat<uint2>(x, y, B, h, w, iu, s);
    case 4: return launch_repeat<unsigned int>(x, y, B, h, w, iu, s);
    case 2: return launch_repeat<unsigned short>(x, y, B, h, w, iu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
