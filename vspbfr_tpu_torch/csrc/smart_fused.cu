// K5: the SMART core in one kernel. Four style-modulated 3x3 convs at
// dilations 1, 2, 4, 8 on the same input, each demodulated, concatenated
// on channels, then the 3x3 fusion conv:
//
//     br  = round(concat_k(demod_k * dilconv_k(round(x * style), ws_k)))
//     y   = conv3x3(zero_pad_1(br), wf)
//
// NHWC, the branch weights concatenated as one (3, 3, C, 4Cb) HWIO tensor
// and both weight sets already scaled by 1/sqrt(fan_in); f32 accumulation;
// x * style and the branch values rounded to x's dtype, as the composition
// (K2, then K1) rounds them. The fusion's bias, noise and activation are
// not part of it.
//
// Replaces the TPU kernel vspbfr_tpu/ops/pallas_smart.py:_smart_fused_impl
// (body _smart_kernel). That kernel works in the 2x2 space-to-depth layout,
// where the even dilations become phase-diagonal tap matrices for the
// 128-lane MXU; those matrices exist only for that layout. This one works
// on the unpacked layout and keeps what the TPU kernel keeps out of device
// memory: the branch tensor.
//
// What bounds it on the H100: operations (9 * 4Cb * C multiply-adds per
// pixel for the branches and 9 * 4Cb * Co for the fusion), so both convs
// run on K1's and K2's tile body (conv_tile.cuh): in bf16 mma.sync on the
// tensor cores fed by ldmatrix, in f32 the register-tiled FMA (TF32 would
// not give the f32 result). The design:
// - A block owns a TH x TW output tile of one image. Its branch tile, the
//   (TH+2) x (TW+2) pixels the fusion reads, stays in shared memory in x's
//   dtype as slabs of 64 bytes of channels a pixel, each row padded to 80
//   bytes (the stripe rows of conv_tile.cuh), so that the fusion reads a
//   slab as K1 reads a staged stripe: without bank conflicts. Pixels
//   outside the image are stored as zero: they are the fusion's padding
//   (pallas_smart.py:128-140).
// - Branch phase: the block's branch channels go in segments of one
//   branch and at most the branch body's N columns. Each segment stages,
//   per 64-byte pass over the input channels, the stripe of its own
//   dilation's halo, (TH+2+2d) x (TW+2+2d) pixels, by cp.async with zero
//   fill, times the style in x's dtype, and the pass's weights; the branch
//   body's M covers the branch tile's pixels (taps spaced d apart in the
//   stripe). Taps that read only padding for the tile are skipped. Each
//   value is demodulated, rounded to x's dtype and stored in the branch
//   tile.
// - Fusion phase: the 3x3 conv out of the branch tile, one slab a pass,
//   64 output channels at a time, as K1 runs a pass.
// - Every plan takes more than half of a multiprocessor's shared memory,
//   so one block of 8 warps runs on each. The stages go through a ring
//   past the branch tile: the next is staged while the current one runs
//   wherever both fit.
// - Enough blocks at small images: a cluster of S blocks (1, 2, 4 or 8)
//   shares one tile. Block r computes branch channels [r, r + 1) * 4Cb / S
//   and writes them into the branch tile of every block of the cluster
//   (distributed shared memory), then, after a cluster barrier, the output
//   channels [r, r + 1) * co_split from its own full copy. The branch
//   tile is exchanged, not the fusion's partial sums: in bf16 it is half
//   as many bytes or fewer.
// The launch plan (tile, cluster, Co split, shared memory) is Python's,
// ops/smart.py::smart_plan, read here field by field (`Plan`) and checked.
#include <cstring>

#include "conv_tile.cuh"

namespace vspbfr {
namespace {

using namespace tile;

constexpr int kMaxD = 8;         // the largest dilation
constexpr int kPlanFields = 16;
// ops/smart.py PLAN_FIELDS, field for field
struct Plan {
  int B, H, W, C, Cb, Co;
  int kind, TH, TW, tiles_x, tiles_y;
  int cluster, co_split, slabs, buf_bytes, smem;
};

// which loads may be 16-byte copies: x's pixels, the branch and fusion
// weight rows, y's stores
struct Vec {
  int x, wb, wf, y;
};

// The bodies of each kind: the branch body (M covers the branch tile,
// N is a segment's width) and the fusion body (M is the output tile, N
// 64 channels). kind 0: 16x16 tiles, Cb <= 16; 1 (bf16): 16x16, Cb <= 32;
// 1 (f32): 8x8; 2: 8x8 (bf16) or 4x8 (f32).
template <typename T, int K>
struct Kind;
template <>
struct Kind<__nv_bfloat16, 0> {
  using Br = Mma<1, 2, 3>;   // 384 px (18 x 18) x 16
  using Fu = Mma<2, 4, 4>;   // 256 px x 64
  static constexpr int TH = 16, TW = 16;
};
template <>
struct Kind<__nv_bfloat16, 1> {
  using Br = Mma<1, 4, 3>;   // 384 px x 32
  using Fu = Mma<2, 4, 4>;
  static constexpr int TH = 16, TW = 16;
};
template <>
struct Kind<__nv_bfloat16, 2> {
  using Br = Mma<2, 4, 2>;   // 128 px (10 x 10) x 64
  using Fu = Mma<2, 4, 1>;   // 64 px x 64
  static constexpr int TH = 8, TW = 8;
};
template <>
struct Kind<float, 0> {
  using Br = Fma<4, 1, 6>;   // 384 px x 16
  using Fu = Fma<8, 2, 8>;   // 256 px x 64
  static constexpr int TH = 16, TW = 16;
};
template <>
struct Kind<float, 1> {
  using Br = Fma<8, 1, 4>;   // 128 px x 32
  using Fu = Fma<8, 2, 2>;   // 64 px x 64
  static constexpr int TH = 8, TW = 8;
};
template <>
struct Kind<float, 2> {
  using Br = Fma<8, 1, 2>;   // 64 px (6 x 10) x 32
  using Fu = Fma<16, 1, 2>;  // 32 px x 64
  static constexpr int TH = 4, TW = 8;
};

// --- distributed shared memory ------------------------------------------

__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned a, unsigned short v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(a), "h"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v at p in the branch tile of every block of the cluster (S of them).
template <typename U>
__device__ __forceinline__ void put(char* p, U v, int S) {
  if (S == 1) {
    *reinterpret_cast<U*>(p) = v;
    return;
  }
  const unsigned a = smem_u32(p);
  for (int r = 0; r < S; ++r) st_cluster(cluster_addr(a, r), v);
}

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned short bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// The taps of a 3x3 dilation-d conv over the n x m pixels at (r0, c0)
// that read some input inside the H x W image, for the pixels inside it:
// bit (ky + 1) * 3 + kx + 1.
__device__ __forceinline__ unsigned tap_mask(int H, int W, int r0, int n,
                                             int c0, int m, int d) {
  const int rl = max(r0, 0), rh = min(r0 + n, H) - 1;
  const int cl = max(c0, 0), chh = min(c0 + m, W) - 1;
  unsigned mask = 0;
#pragma unroll
  for (int ky = -1; ky <= 1; ++ky)
#pragma unroll
    for (int kx = -1; kx <= 1; ++kx)
      if (rl + ky * d < H && rh + ky * d >= 0 && cl + kx * d < W &&
          chh + kx * d >= 0)
        mask |= 1u << ((ky + 1) * 3 + kx + 1);
  return mask;
}

// The fusion weights are staged without a stripe.
struct NoStripe {
  template <typename T>
  __device__ __forceinline__ void operator()(const T*, const Pass&, int,
                                             char*) const {}
};

// Bytes of shared memory past the branch tile: the larger of the branch
// phase's stage (the dilation-8 stripe, the weights of a pass, its style)
// and the fusion's (the weights of a slab). The kernel keeps two stages in
// it at a time where they fit.
template <typename T, int K>
__host__ __device__ constexpr int stage_bytes() {
  using KD = Kind<T, K>;
  constexpr int br = smem_bytes<T, typename KD::Br>(
      KD::TH + 2 + 2 * kMaxD, KD::TW + 2 + 2 * kMaxD, 9);
  constexpr int fu = 9 * kCK<T> * w_row<T, typename KD::Fu>();
  return br > fu ? br : fu;
}

// One stage of a block's work and where it lies in the staging ring: a
// pass of a branch segment (its dilation's stripe over input channels c0
// .., the pass's weights of channels ch .. end of the concatenation, the
// style) or a slab of a fusion chunk (the slab's weights of output
// channels co0 ..).
struct Step {
  int phase;        // 0 branch, 1 fusion, 2 none
  int ch, end, d, c0;
  int co0, sl;
  int off, bytes;
};

// One block a multiprocessor (every plan's shared memory exceeds half of
// one), so ptxas may give a thread up to 255 registers.
template <typename T, int K>
__global__ void __launch_bounds__(NT, 1)
smart_fused_kernel(const T* __restrict__ x, const T* __restrict__ sty,
                   const T* __restrict__ wb, const T* __restrict__ dv,
                   const T* __restrict__ wf, T* __restrict__ y, Plan g,
                   Vec v) {
  using KD = Kind<T, K>;
  using CB = typename KD::Br;
  using CF = typename KD::Fu;
  constexpr int CK = kCK<T>;
  constexpr int E = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int TH = KD::TH, TW = KD::TW;
  constexpr int BH = TH + 2, BW = TW + 2, BP = BH * BW;   // branch tile
  constexpr int SLAB = BP * kXRow;
  constexpr int BW_ROWS = 9 * CK * w_row<T, CB>();
  extern __shared__ uint4 smem_raw[];
  char* buf = reinterpret_cast<char*>(smem_raw);
  char* ring = buf + g.buf_bytes;
  const int R = g.smem - g.buf_bytes;
  const int tid = threadIdx.x;
  const int S = g.cluster;
  const int rank = blockIdx.x % S;
  const int tile = blockIdx.x / S;
  const int b = blockIdx.y;
  const int ty0 = (tile / g.tiles_x) * TH, tx0 = (tile % g.tiles_x) * TW;
  const int CB4 = 4 * g.Cb;
  const int ch_lo = rank * (CB4 / S), ch_hi = ch_lo + CB4 / S;
  const int co_lo = rank * g.co_split;
  const int co_hi = min(g.Co, co_lo + g.co_split);

  // ---- the stages, in order ----
  auto branch_pass = [&](const Step& t) {
    Pass s;
    s.H = g.H; s.W = g.W; s.Ci = g.C;
    s.b = b; s.row0 = ty0 - 1 - t.d; s.col0 = tx0 - 1 - t.d;
    s.SH = BH + 2 * t.d; s.SW = BW + 2 * t.d;
    s.KH = 3; s.KW = 3; s.d = t.d;
    s.vec_x = v.x;
    return s;
  };
  Pass f;   // the fusion reads the branch tile as a stripe
  f.H = g.H; f.W = g.W; f.Ci = CB4;
  f.b = b; f.row0 = ty0 - 1; f.col0 = tx0 - 1;
  f.SH = BH; f.SW = BW; f.KH = 3; f.KW = 3; f.d = 1;
  f.vec_x = 1;
  auto segment = [&](Step t, int ch) {   // the segment from ch, its pass 0
    const int k = ch / g.Cb;
    t.phase = 0;
    t.ch = ch;
    t.end = min(min(ch_hi, (k + 1) * g.Cb), ch + CB::TN);
    t.d = 1 << k;
    t.c0 = 0;
    t.bytes = (BH + 2 * t.d) * (BW + 2 * t.d) * kXRow + BW_ROWS + CK * 4;
    return t;
  };
  auto chunk = [&](Step t, int co0, int sl) {
    t.phase = co0 < co_hi ? 1 : 2;
    t.co0 = co0;
    t.sl = sl;
    t.bytes = 9 * CK * w_row<T, CF>();
    return t;
  };
  auto next = [&](Step t) {
    if (t.phase == 0) {
      if (t.c0 + CK < g.C) {
        t.c0 += CK;
        return t;
      }
      return t.end < ch_hi ? segment(t, t.end) : chunk(t, co_lo, 0);
    }
    if (t.sl + 1 < g.slabs) return chunk(t, t.co0, t.sl + 1);
    return chunk(t, t.co0 + CF::TN, 0);
  };
  // the copies of a stage into the ring at t.off
  auto issue = [&](const Step& t) {
    char* at = ring + t.off;
    if (t.phase == 0) {
      const Pass s = branch_pass(t);
      const int co = t.ch + (tid % (CB::TN / E)) * E;
      const SegSrc<T> wseg{wb + co, CB4, t.end - co, v.wb && t.ch % E == 0};
      char* ws = at + s.SH * s.SW * kXRow;
      stage_pass<T, CB>(x, wseg, sty, s, t.c0, at, ws,
                        reinterpret_cast<float*>(ws + BW_ROWS), FullStripe());
    } else if (t.phase == 1) {
      const int co = t.co0 + (tid % (CF::TN / E)) * E;
      const SegSrc<T> wseg{wf + co, g.Co, co_hi - co, v.wf != 0};
      stage_pass<T, CF>((const T*)nullptr, wseg, (const T*)nullptr, f,
                        t.sl * CK, nullptr, at, nullptr, NoStripe());
    }
  };
  // issue nxt beside cur (after it, or from the ring's start) if it fits;
  // else it waits for cur's products (`late`)
  auto prefetch = [&](const Step& cur, Step& nxt) {
    if (nxt.phase == 2) return;
    if (cur.off + cur.bytes + nxt.bytes <= R) {
      nxt.off = cur.off + cur.bytes;
    } else if (nxt.bytes <= cur.off) {
      nxt.off = 0;
    } else {
      nxt.off = -1;
      return;
    }
    issue(nxt);
  };
  auto late = [&](Step& nxt) {
    if (nxt.phase == 2 || nxt.off >= 0) return;
    __syncthreads();
    nxt.off = 0;
    issue(nxt);
  };

  // the channels of the last slab past 4Cb are read by the fusion: zero
  if (CB4 % CK) {
    char* last = buf + (g.slabs - 1) * SLAB;
    for (int i = tid; i < BP * kXSegs; i += NT)
      zero16(last + (i / kXSegs) * kXRow + (i % kXSegs) * 16);
  }
  // the cluster's blocks have started before any writes into them
  if (S > 1) cluster_arrive();
  bool waited = S == 1;

  // ---- branch phase: this block's branch channels, a segment at a time ----
  Step cur = segment(Step{}, ch_lo);
  cur.off = 0;
  issue(cur);
  {
    Body<T, CB> body;
    unsigned taps = 0;
    while (cur.phase == 0) {
      Step nxt = next(cur);
      cp_async_wait_all();
      __syncthreads();
      const Pass s = branch_pass(cur);
      char* xs = ring + cur.off;
      char* ws = xs + s.SH * s.SW * kXRow;
      scale_stripe<T>(s, xs, reinterpret_cast<float*>(ws + BW_ROWS));
      prefetch(cur, nxt);
      __syncthreads();
      if (cur.c0 == 0) {
        body.init(BW, s.SW, BP);
        taps = tap_mask(g.H, g.W, ty0 - 1, BH, tx0 - 1, BW, cur.d);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        if (taps >> tap & 1) body.product(s, xs, ws, tap);
      if (cur.c0 + CK >= g.C) {
        if (!waited) {
          cluster_wait();
          waited = true;
        }
        // demod, round, zero outside the image, into every branch tile
        const int ch = cur.ch, end = cur.end;
        body.each([&](int p, int c, auto& vv) {
          constexpr int N = sizeof(vv) / sizeof(float);
          const int cc = ch + c;
          if (p >= BP || cc >= end) return;
          const int gy = ty0 - 1 + p / BW, gx = tx0 - 1 + p % BW;
          const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
          T q[N];
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float u = 0.f;
            if (in && cc + e < end) {
              u = vv[e];
              if (dv) u *= to_f(dv[(size_t)b * CB4 + cc + e]);
            }
            q[e] = from_f<T>(u);
          }
          char* dst =
              buf + (cc / CK) * SLAB + p * kXRow + (cc % CK) * sizeof(T);
          if (cc % N == 0 && cc + N <= end) {
            if constexpr (N == 2) {
              put(dst, (unsigned)bits(q[0]) | (unsigned)bits(q[1]) << 16, S);
            } else {
              put(dst,
                  make_uint4(bits(q[0]), bits(q[1]), bits(q[2]), bits(q[3])),
                  S);
            }
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e) {
              const int ce = cc + e;
              if (ce < end)
                put(buf + (ce / CK) * SLAB + p * kXRow + (ce % CK) * sizeof(T),
                    bits(q[e]), S);
            }
          }
        });
      }
      late(nxt);
      cur = nxt;
    }
  }
  // every branch tile is whole (and no block exits while its tile is
  // written)
  if (!waited) cluster_wait();
  if (S > 1) {
    cluster_arrive();
    cluster_wait();
  }

  // ---- fusion phase: this block's output channels from its branch tile ----
  const unsigned ftaps = tap_mask(g.H, g.W, ty0, TH, tx0, TW, 1);
  Body<T, CF> body;
  while (cur.phase == 1) {
    Step nxt = next(cur);
    cp_async_wait_all();
    __syncthreads();
    prefetch(cur, nxt);
    if (cur.sl == 0) body.init(TW, BW);
    const char* xs = buf + cur.sl * SLAB;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      if (ftaps >> tap & 1) body.product(f, xs, ring + cur.off, tap);
    if (cur.sl + 1 == g.slabs) {
      const int co0 = cur.co0;
      body.each([&](int p, int c, auto& vv) {
        constexpr int N = sizeof(vv) / sizeof(float);
        const int oy = ty0 + p / TW, ox = tx0 + p % TW, o = co0 + c;
        if (oy >= g.H || ox >= g.W || o >= co_hi) return;
        store_run<T, N>(y + (((size_t)b * g.H + oy) * g.W + ox) * g.Co + o,
                        co_hi - o, vv, v.y != 0);
      });
    }
    late(nxt);
    cur = nxt;
  }
}

template <typename T, int K>
int launch_kind(const void* x, const void* sty, const void* wb,
                const void* dv, const void* wf, void* y, const Plan& g,
                const Vec& v, cudaStream_t stream) {
  using KD = Kind<T, K>;
  constexpr int CK = kCK<T>;
  constexpr int BP = (KD::TH + 2) * (KD::TW + 2);
  const int CB4 = 4 * g.Cb;
  const int S = g.cluster;
  // the plan must be the one this kind was built for
  if (g.TH != KD::TH || g.TW != KD::TW || BP > KD::Br::TM ||
      KD::TH * KD::TW != KD::Fu::TM ||
      g.tiles_x != (g.W + KD::TW - 1) / KD::TW ||
      g.tiles_y != (g.H + KD::TH - 1) / KD::TH ||
      g.slabs != (CB4 + CK - 1) / CK || g.buf_bytes != g.slabs * BP * kXRow ||
      g.smem < g.buf_bytes + stage_bytes<T, K>() || g.smem > 227 * 1024 ||
      !(S == 1 || S == 2 || S == 4 || S == 8) || CB4 % S != 0 ||
      g.co_split < 1 || g.co_split % 8 != 0 || (long long)g.co_split * S < g.Co)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)g.tiles_x * g.tiles_y * S;
  if (blocks > 0x7fffffffLL || g.B > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = smart_fused_kernel<T, K>;
  cudaError_t err = set_smem(kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, g.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)sty,
                           (const T*)wb, (const T*)dv, (const T*)wf, (T*)y, g,
                           v);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* sty, const void* wb, const void* dv,
           const void* wf, void* y, const Plan& g, cudaStream_t stream) {
  constexpr int isz = (int)sizeof(T);
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  Vec v;
  v.x = (g.C * isz) % 16 == 0 && al(x);
  v.wb = (4 * g.Cb * isz) % 16 == 0 && al(wb);
  v.wf = (g.Co * isz) % 16 == 0 && al(wf);
  // pairs (bf16) or quads (f32) of channels per store
  v.y = g.Co % 4 == 0 && al(y);
  switch (g.kind) {
    case 0:
      return launch_kind<T, 0>(x, sty, wb, dv, wf, y, g, v, stream);
    case 1:
      return launch_kind<T, 1>(x, sty, wb, dv, wf, y, g, v, stream);
    case 2:
      return launch_kind<T, 2>(x, sty, wb, dv, wf, y, g, v, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vspbfr

// x (B, H, W, C); sty (B, C); wb (3, 3, C, 4Cb) the four branches'
// weights concatenated (dilations 1, 2, 4, 8 in that order); dv (B, 4Cb)
// the demodulation or null; wf (3, 3, 4Cb, Co); y (B, H, W, Co); plan:
// kPlanFields ints in `Plan` order (ops/smart.py smart_plan).
extern "C" int vspbfr_smart_fused(const void* x, const void* sty,
                                  const void* wb, const void* dv,
                                  const void* wf, void* y, int dtype,
                                  const int* plan, void* stream) {
  using namespace vspbfr;
  Plan g;
  static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is ints");
  memcpy(&g, plan, sizeof(Plan));
  if (g.B < 1 || g.H < 1 || g.W < 1 || g.C < 1 || g.Cb < 1 || g.Co < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch<float>(x, sty, wb, dv, wf, y, g, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, sty, wb, dv, wf, y, g, s);
  return (int)cudaErrorInvalidValue;
}
