// K5: the SMART core in one kernel. Four style-modulated 3x3 convs at
// dilations 1, 2, 4, 8 on the same input, each demodulated, concatenated
// on channels, then the 3x3 fusion conv:
//
//     br  = round(concat_k(demod_k * dilconv_k(x * style, ws_k)))
//     y   = conv3x3(zero_pad_1(br), wf)
//
// NHWC, the branch weights concatenated as one (3, 3, C, 4Cb) HWIO tensor
// and both weight sets already scaled by 1/sqrt(fan_in); f32 accumulation;
// the branch values rounded to x's dtype, as the composition (K2, then K1)
// stores K2's output. The fusion's bias, noise and activation are not
// part of it.
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_smart.py:_smart_fused_impl
// (body _smart_kernel). That kernel works in the 2x2 space-to-depth layout,
// where the even dilations become phase-diagonal tap matrices for the
// 128-lane MXU; those matrices exist only for that layout. This one works
// on the unpacked layout and keeps what the TPU kernel keeps out of device
// memory: the branch tensor.
//
// What bounds it on the H100: operations (9 * 4Cb * C multiply-adds per
// pixel for the branches and 9 * 4Cb * Cout for the fusion). The design:
// each block owns a TS x TS output tile and one image. Phase A computes
// the branches at the (TS+2)^2 pixels the fusion reads: per 64 branch
// channels and per 8-channel input chunk it stages the style-scaled input
// window (TS + 18 wide: the dilation-8 halo plus the fusion's 1) and the
// chunk's weights in shared memory (zero padding from bounds checks), and
// each thread accumulates up to 7 pixels x 4 consecutive channels in
// registers; the 4 channels share a branch (Cb % 4 == 0), so one input
// load feeds four FMAs. The branch values, demodulated and rounded, go to
// a shared (TS+2)^2 x 4Cb f32 buffer, where pixels outside the image are
// zero (they are the fusion's padding, not computed values:
// pallas_smart.py:128-140). Phase B runs the fusion conv out of that
// buffer, staging the fusion weights per 16 branch channels. TS is 8 where
// the buffer fits in ~100 KB of shared memory (4Cb <= 128) and the image
// is larger than 4x4, else 4; the halo recompute then costs (TS+2)^2/TS^2
// of the branch work: 1.56x at TS = 8, 2.25x at TS = 4. CUDA cores only;
// wgmma comes later.
#include "common.cuh"

namespace vspbfr {
namespace {

constexpr int NT = 256;
constexpr int NA = 64;    // branch channels per phase-A pass
constexpr int CK = 8;     // input channels per phase-A stage
constexpr int NB = 64;    // output channels per phase-B pass
constexpr int CKF = 16;   // branch channels per phase-B stage
constexpr int HALO = 9;   // dilation 8 + the fusion's 1

template <int TS>
constexpr int stage_floats() {
  constexpr int iw = TS + 2 * HALO;
  constexpr int a = CK * iw * iw + 9 * CK * NA;
  constexpr int b = 9 * CKF * NB;
  return a > b ? a : b;
}

template <int TS>
size_t smem_bytes(int cb4) {
  return ((size_t)(TS + 2) * (TS + 2) * cb4 + stage_floats<TS>()) *
         sizeof(float);
}

template <typename T, int TS>
__global__ void __launch_bounds__(NT)
smart_fused_kernel(const T* __restrict__ x, const T* __restrict__ sty,
                   const T* __restrict__ wb, const T* __restrict__ dv,
                   const T* __restrict__ wf, T* __restrict__ y, int H, int W,
                   int C, int Cb, int Co, int tiles_x) {
  constexpr int BT = TS + 2;                 // branch tile side
  constexpr int NPA = (BT * BT + 15) / 16;   // phase-A pixel slots
  constexpr int IW = TS + 2 * HALO;          // input window side
  constexpr int NPB = TS * TS / 16;          // phase-B pixel slots
  extern __shared__ float smem[];
  const int CB4 = 4 * Cb;
  float* buf = smem;                           // [BT * BT][CB4]
  float* stage = smem + BT * BT * CB4;
  float* xs = stage;                           // A: [CK][IW * IW]
  float* wsm = stage + CK * IW * IW;           // A: [9][CK][NA]
  float* wfs = stage;                          // B: [9][CKF][NB]
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TS;
  const int tx0 = (blockIdx.x % tiles_x) * TS;
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;

  // ---- phase A: the four branches at the (TS+2)^2 buffer pixels ----
  int pofs[NPA];
  bool pin[NPA];
#pragma unroll
  for (int i = 0; i < NPA; ++i) {
    const int p = tp + 16 * i;
    const int by = p / BT, bx = p % BT;
    const int gy = ty0 - 1 + by, gx = tx0 - 1 + bx;
    const bool ok = p < BT * BT;
    pofs[i] = ok ? (by + HALO - 1) * IW + (bx + HALO - 1)
                 : (HALO - 1) * IW + (HALO - 1);
    pin[i] = ok && gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
  for (int n0 = 0; n0 < CB4; n0 += NA) {
    int dil[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc * 4 + j;
      dil[j] = n < CB4 ? 1 << (n / Cb) : 0;
    }
    const bool uni = dil[0] == dil[1] && dil[0] == dil[2] && dil[0] == dil[3];
    float acc[NPA][4];
#pragma unroll
    for (int i = 0; i < NPA; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CK) {
      for (int e = tid; e < CK * IW * IW; e += NT) {
        const int ci = e % CK, pos = e / CK;
        const int gy = ty0 - HALO + pos / IW, gx = tx0 - HALO + pos % IW;
        const int gc = c0 + ci;
        float v = 0.f;
        if (gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f(x[(((size_t)b * H + gy) * W + gx) * C + gc]) *
              to_f(sty[(size_t)b * C + gc]);
        xs[ci * IW * IW + pos] = v;
      }
      for (int e = tid; e < 9 * CK * NA; e += NT) {
        const int n = e % NA, r = e / NA;
        const int ci = r % CK, tap = r / CK;
        const int gc = c0 + ci, gn = n0 + n;
        float v = 0.f;
        if (gc < C && gn < CB4) v = to_f(wb[((size_t)tap * C + gc) * CB4 + gn]);
        wsm[(tap * CK + ci) * NA + n] = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int tofs = (tap / 3 - 1) * IW + (tap % 3 - 1);
        int toff[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) toff[j] = tofs * dil[j];
#pragma unroll 2
        for (int ci = 0; ci < CK; ++ci) {
          const float* xr = xs + ci * IW * IW;
          const float4 w4 =
              *reinterpret_cast<const float4*>(wsm + (tap * CK + ci) * NA +
                                               tc * 4);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          if (uni) {
#pragma unroll
            for (int i = 0; i < NPA; ++i) {
              const float a = xr[pofs[i] + toff[0]];
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < NPA; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(xr[pofs[i] + toff[j]], wv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NPA; ++i) {
      const int p = tp + 16 * i;
      if (p >= BT * BT) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tc * 4 + j;
        if (n >= CB4) continue;
        float v = 0.f;
        if (pin[i]) {
          v = acc[i][j];
          if (dv) v *= to_f(dv[(size_t)b * CB4 + n]);
          v = to_f(from_f<T>(v));
        }
        buf[p * CB4 + n] = v;
      }
    }
  }
  __syncthreads();

  // ---- phase B: the 3x3 fusion conv out of the branch buffer ----
  int qofs[NPB];
#pragma unroll
  for (int i = 0; i < NPB; ++i) {
    const int q = tp + 16 * i;
    qofs[i] = (q / TS) * BT + q % TS;
  }
  for (int co0 = 0; co0 < Co; co0 += NB) {
    float acc[NPB][4];
#pragma unroll
    for (int i = 0; i < NPB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < CB4; c0 += CKF) {
      for (int e = tid; e < 9 * CKF * NB; e += NT) {
        const int co = e % NB, r = e / NB;
        const int c = r % CKF, tap = r / CKF;
        const int gc = c0 + c, gco = co0 + co;
        float v = 0.f;
        if (gc < CB4 && gco < Co) v = to_f(wf[((size_t)tap * CB4 + gc) * Co + gco]);
        wfs[(tap * CKF + c) * NB + co] = v;
      }
      __syncthreads();
      const int cn = CB4 - c0 < CKF ? CB4 - c0 : CKF;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int tb = (tap / 3) * BT + tap % 3;
#pragma unroll 4
        for (int c = 0; c < cn; ++c) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              wfs + (tap * CKF + c) * NB + tc * 4);
#pragma unroll
          for (int i = 0; i < NPB; ++i) {
            const float a = buf[(qofs[i] + tb) * CB4 + c0 + c];
            acc[i][0] = fmaf(a, w4.x, acc[i][0]);
            acc[i][1] = fmaf(a, w4.y, acc[i][1]);
            acc[i][2] = fmaf(a, w4.z, acc[i][2]);
            acc[i][3] = fmaf(a, w4.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NPB; ++i) {
      const int q = tp + 16 * i;
      const int oy = ty0 + q / TS, ox = tx0 + q % TS;
      if (oy >= H || ox >= W) continue;
      T* yr = y + (((size_t)b * H + oy) * W + ox) * Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + tc * 4 + j;
        if (co < Co) yr[co] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, int TS>
int launch_ts(const void* x, const void* sty, const void* wb, const void* dv,
              const void* wf, void* y, int B, int H, int W, int C, int Cb,
              int Co, cudaStream_t stream) {
  const size_t smem = smem_bytes<TS>(4 * Cb);
  cudaError_t err = set_smem(smart_fused_kernel<T, TS>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TS - 1) / TS, tiles_y = (H + TS - 1) / TS;
  dim3 grid(tiles_x * tiles_y, B);
  smart_fused_kernel<T, TS><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)sty, (const T*)wb, (const T*)dv, (const T*)wf,
      (T*)y, H, W, C, Cb, Co, tiles_x);
  return (int)cudaGetLastError();
}

// The tile side for a shape: 8 where its buffer fits in ~100 KB of shared
// memory and the image is larger than 4x4, else 4.
int pick_tile(int H, int W, int Cb) {
  return (smem_bytes<8>(4 * Cb) <= 100 * 1024 && (H > 4 || W > 4)) ? 8 : 4;
}

template <typename T>
int launch(const void* x, const void* sty, const void* wb, const void* dv,
           const void* wf, void* y, int B, int H, int W, int C, int Cb,
           int Co, cudaStream_t stream) {
  if (pick_tile(H, W, Cb) == 8)
    return launch_ts<T, 8>(x, sty, wb, dv, wf, y, B, H, W, C, Cb, Co, stream);
  return launch_ts<T, 4>(x, sty, wb, dv, wf, y, B, H, W, C, Cb, Co, stream);
}

}  // namespace
}  // namespace vspbfr

// x (B, H, W, C); sty (B, C); wb (3, 3, C, 4Cb) the four branches'
// weights concatenated (dilations 1, 2, 4, 8 in that order); dv (B, 4Cb)
// the demodulation or null; wf (3, 3, 4Cb, Co); y (B, H, W, Co).
extern "C" int vspbfr_smart_fused(const void* x, const void* sty,
                                  const void* wb, const void* dv,
                                  const void* wf, void* y, int dtype, int B,
                                  int H, int W, int C, int Cb, int Co,
                                  void* stream) {
  using namespace vspbfr;
  if (B < 1 || H < 1 || W < 1 || C < 1 || Cb < 1 || Co < 1 ||
      smem_bytes<4>(4 * Cb) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float>(x, sty, wb, dv, wf, y, B, H, W, C, Cb, Co, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, sty, wb, dv, wf, y, B, H, W, C, Cb, Co,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// The tile side K5 picks for a shape (so the caller can report it).
extern "C" int vspbfr_smart_tile(int H, int W, int Cb) {
  return vspbfr::pick_tile(H, W, Cb);
}
