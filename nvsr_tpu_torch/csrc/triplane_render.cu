// Triplane gather + decode for eval renders, for Hopper (sm_90a).
//
// Replaces the TPU megakernel nvsr_tpu/ops/pallas/tile_sampler.py:904
// (_mega_kernel_v2) with nvsr_tpu/ops/pallas/fused_decoder.py:130
// (decode_body) inlined; host side and plain PyTorch version in
// nvsr_tpu_torch/ops/fused_render.py, binding in nvsr_tpu_torch/kernels.py.
//
// What it computes, per point n = r * S + s of R rays x S sorted depths:
// p = o_r + d_r * z[r, s], normalized by the scene box and projected onto
// three planes; a bilinear border-clamped sample of each plane from a
// bf16 channel-last table [3, H, W, Cp] with bf16 x-weights bf16(1 - tx),
// bf16(tx), f32 row sums and an f32 y-lerp top + ty * (bot - top); then
// the triplane decoder (density MLP on the combined features, rgb MLP on
// [f0, f1, f2, view]) with bf16 operands, f32 accumulation, f32 bias and
// bf16 relu activations; rgb and sigma go to out[n, 0:3] and out[n, 3]
// (ray-major [R, S, 4]). The sigma_only variant skips the rgb branch and
// writes the fc_rgb bias into the rgb lanes; its sigma is the same code
// as the full decode's.
//
// The cubic variants (kCubic; the interp="cubic" branch of the TPU kernel,
// tile_sampler.py:1131-1143, with the geometry of prepare_ray_chunks
// :734-761) take a bicubic sample of each plane instead: the source
// coordinate is clipped to [-1, W] and [-1, H], x0 = floor, tx, y0, ty;
// the 4x4 window at cols clamp(x0-1 .. x0+2) and rows clamp(y0-1 .. y0+2)
// (torch's border); weights w_ij = bf16(cubic(i - tx) * cubic(j - ty))
// from the f32 cubic kernel (sampling.cuh); per row the f32 sum of its
// four weight*tap products, and the feature is the f32 sum of the rows in
// the order y0, y0+1, y0-1, y0+2 (the TPU kernel's A rows, then its B
// rows). Comb and decoder as above.
//
// The grids entries (kGrids; the counterpart of the TPU grids entry
// tiled_render_chunked, tile_sampler.py:1464, whose launcher _mega_finish
// :1510 takes _mega_kernel_v2 or, under NVSR_MEGA_V1=1, _mega_kernel
// :794) are bilinear only. They read each point's three normalized (x, y)
// from grids [3, N, 2] f32 instead of building them from o + d*z, take a
// bf16 view row per point [N, cvp], and write out[n] for the N points in
// their input order: the kernel works point by point, so the TPU's chunk
// order has no counterpart. They run with R = N, S = 1 (one "ray" per
// point). kV1 is _mega_kernel's own rounding (tile_sampler.py:845-847,
// 869-870; fused_decoder.py:213-217): the two x-interpolated rows are
// rounded to bf16 and the y-lerp is top * (1 - ty) + bot * ty in f32; it
// always decodes in full, as the TPU v1 kernel ignores sigma_only.
//
// All f32 steps before the decoder use _rn intrinsics so that no FMA
// contraction changes them: the features equal the plain version's bit
// for bit.
//
// What bounds it on the H100: per point the gather reads 3 planes x 4 taps
// x Cp bf16 (1152 B at Cp = 48, mostly from L2: a tile of rays touches a
// small patch of each plane; bicubic: 16 taps, 4608 B), while the full
// decoder is ~0.26 MFLOP (4+4 layers of width 128). At 989 TFLOP/s bf16
// and 3.35 TB/s the two are within a factor of a few of each other, so
// neither alone is the wall; what limits this simple design is latency
// and shared-memory traffic.
//
// What the design does about it. The TPU design (vertical-pair tables,
// per-chunk region DMAs, hat-weight gather matmuls, region clamps and their
// overflow repair) exists because Mosaic cannot gather in VMEM; here a
// point's taps are plain 16-byte loads, so none of it is carried over.
// The kernel is decoder.cuh's persistent, warp-specialised block: the
// gather warps fill a ring of feature stages, 64 points a share, while
// two consumer warpgroups decode the shares already gathered, so the
// loads of the next points are in flight while the tensor cores work.
// The gather of a share runs in two phases:
//   phase 0: one thread per (point, plane) computes the tap offsets and
//            weights into the gather's shared scratch (bicubic: 4 row
//            and 4 col offsets, 16 weights);
//   phase 1: one thread per (point, 8 channels) loads the taps as 16-byte
//            vectors (bilinear: the 12 of its 3 planes at once; bicubic:
//            kCubicRowsInFlight rows of a plane at once) and writes f0,
//            f1, f2 and comb (bf16), plus the view row, straight into the
//            wgmma A layout of the share's stage;
//   then a consumer warpgroup decodes the stage: wgmma with the
//            activations in registers, the weights streamed through a
//            ring of shared-memory slices (decoder.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "decoder.cuh"
#include "sampling.cuh"

namespace {

using namespace nvsr;

struct Geom {
  float lo[3], hi[3];
  float rot[3][3][2];                       // rot_mats[p, c, 1 + k]
};

struct Params {
  const bf16* table; int H, W, cp;
  const float* origins; const float* dirs; const float* z; int R, S;
  const float* grids;                       // [3, R, 2]: the grids entries
  const bf16* view; int cvp;
  Decoder dec;
  int align_corners, avg;
  float* out;
  Geom geom;
};

// per (point, plane) in shared memory: tap offsets and weights
template <bool kCubic> struct TapShape {
  static constexpr int kInts = kCubic ? 8 : 4;     // cubic: 4 rows, 4 cols
  static constexpr int kFloats = kCubic ? 16 : 3;  // cubic: w[row][col]
};

// bicubic taps in flight a gather thread: rows of a plane's 4x4 window
// (all 4 gained nothing on the H100 and need more registers; PERF.md §6)
constexpr int kCubicRowsInFlight = 2;

// offset from y0 of the r-th bicubic window row in feature-sum order:
// y0, y0+1, y0-1, y0+2
__device__ inline int cubic_row(int r) {
  return r == 2 ? -1 : (r == 3 ? 2 : r);
}

// The gather of a share's 64 points (decoder.cuh's Job)
template <bool kSigmaOnly, bool kCubic, bool kGrids, bool kV1>
struct Gather {
  static constexpr int kInts = TapShape<kCubic>::kInts;
  static constexpr int kFloats = TapShape<kCubic>::kFloats;
  const Params& P;              // the kernel's __grid_constant__ parameter
  long long N;

  __device__ void store(long long n, float4 o) const {
    *reinterpret_cast<float4*>(P.out + n * 4) = o;
  }

  __device__ void gather(int gt, long long base, const Parts& parts,
                         unsigned char* scratch) const {
    int* taps = reinterpret_cast<int*>(scratch);
    float* wts = reinterpret_cast<float*>(scratch) + kWgPoints * 3 * kInts;
    const int cp = P.cp;
    const bool ac = P.align_corners != 0;

    // phase 0: tap offsets (cells of the [3*H*W, Cp] table) and weights
    for (int item = gt; item < kWgPoints * 3; item += kGatherThreads) {
      const int i = item / 3, pl = item % 3;
      const long long n = base + i;
      int* t = taps + item * kInts;
      float* wv = wts + item * kFloats;
      for (int k = 0; k < kInts; ++k) t[k] = 0;
      for (int k = 0; k < kFloats; ++k) wv[k] = 0.0f;
      if (n < N) {
        float gx, gy;
        if (kGrids) {
          const float2 g =
              reinterpret_cast<const float2*>(P.grids)[pl * N + n];
          gx = g.x;
          gy = g.y;
        } else {
          const long long r = n / P.S;
          const float zz = P.z[n];
          float nc[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float pc = __fadd_rn(P.origins[r * 3 + c],
                                       __fmul_rn(P.dirs[r * 3 + c], zz));
            nc[c] = __fsub_rn(
                __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(pc, P.geom.lo[c])),
                          __fsub_rn(P.geom.hi[c], P.geom.lo[c])),
                1.0f);
          }
          const float (*rot)[2] = P.geom.rot[pl];
          gx = __fadd_rn(__fadd_rn(__fmul_rn(nc[0], rot[0][0]),
                                   __fmul_rn(nc[1], rot[1][0])),
                         __fmul_rn(nc[2], rot[2][0]));
          gy = __fadd_rn(__fadd_rn(__fmul_rn(nc[0], rot[0][1]),
                                   __fmul_rn(nc[1], rot[1][1])),
                         __fmul_rn(nc[2], rot[2][1]));
        }
        if (kCubic) {
          // t[0:4] = row starts (cells) in cubic_row order, t[4:8] = cols
          // x0-1 .. x0+2; wv[r * 4 + c] = bf16(wx_c * wy_r)
          int x0, y0;
          float tx, ty;
          cubic_coord(unnormalize(gx, P.W, ac), P.W, &x0, &tx);
          cubic_coord(unnormalize(gy, P.H, ac), P.H, &y0, &ty);
          float wx[4];
          for (int c = 0; c < 4; ++c) {
            wx[c] = cubic_weight(__fsub_rn((float)(c - 1), tx));
            t[4 + c] = min(max(x0 - 1 + c, 0), P.W - 1);
          }
          for (int r = 0; r < 4; ++r) {
            const int dy = cubic_row(r);
            t[r] = (pl * P.H + min(max(y0 + dy, 0), P.H - 1)) * P.W;
            const float wy = cubic_weight(__fsub_rn((float)dy, ty));
            for (int c = 0; c < 4; ++c)
              wv[r * 4 + c] = bf16r(__fmul_rn(wx[c], wy));
          }
        } else {
          const float x = fminf(fmaxf(unnormalize(gx, P.W, ac), 0.0f),
                                (float)(P.W - 1));
          const float y = fminf(fmaxf(unnormalize(gy, P.H, ac), 0.0f),
                                (float)(P.H - 1));
          const float x0f = floorf(x), y0f = floorf(y);
          const float tx = __fsub_rn(x, x0f);
          const int x0 = min((int)x0f, P.W - 1), y0 = min((int)y0f, P.H - 1);
          const int x1 = min(x0 + 1, P.W - 1), y1 = min(y0 + 1, P.H - 1);
          const int row0 = (pl * P.H + y0) * P.W;
          const int row1 = (pl * P.H + y1) * P.W;
          t[0] = row0 + x0; t[1] = row0 + x1;
          t[2] = row1 + x0; t[3] = row1 + x1;
          wv[0] = bf16r(__fsub_rn(1.0f, tx));
          wv[1] = bf16r(tx);
          wv[2] = __fsub_rn(y, y0f);
        }
      }
    }
    named_sync(kGatherBar, kGatherThreads);

    // phase 1: features of 8 channels of one point per item; the bilinear
    // taps of all three planes, or kCubicRowsInFlight rows of a bicubic
    // window, are loaded before their sums
    const int chunks = cp / 8;
    for (int item = gt; item < kWgPoints * chunks; item += kGatherThreads) {
      const int i = item / chunks, c8 = (item % chunks) * 8;
      float comb[8];
      uint4 lin[12];
      if (!kCubic) {
#pragma unroll
        for (int k = 0; k < 12; ++k)
          lin[k] = __ldg(reinterpret_cast<const uint4*>(
              P.table + (size_t)taps[(i * 3 + k / 4) * kInts + k % 4] * cp +
              c8));
      }
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        const int* t = taps + (i * 3 + pl) * kInts;
        const float* wv = wts + (i * 3 + pl) * kFloats;
        float f[8];
        if (kCubic) {
          constexpr int kRows = kCubicRowsInFlight;
#pragma unroll
          for (int r0 = 0; r0 < 4; r0 += kRows) {
            uint4 q[4 * kRows];
#pragma unroll
            for (int k = 0; k < 4 * kRows; ++k)
              q[k] = __ldg(reinterpret_cast<const uint4*>(
                  P.table + ((size_t)t[r0 + k / 4] + t[4 + k % 4]) * cp +
                  c8));
#pragma unroll
            for (int r = r0; r < r0 + kRows; ++r) {
              // row r's taps: [c * 8 + e]
              const bf16* v = reinterpret_cast<const bf16*>(q + 4 * (r - r0));
              const float* w = wv + r * 4;
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                float row = __fmul_rn(w[0], __bfloat162float(v[e]));
#pragma unroll
                for (int c = 1; c < 4; ++c)
                  row = __fadd_rn(
                      row, __fmul_rn(w[c], __bfloat162float(v[c * 8 + e])));
                f[e] = r == 0 ? row : __fadd_rn(f[e], row);
              }
            }
          }
        } else {
          const float w0 = wv[0], w1 = wv[1], ty = wv[2];
          // [k * 8 + e]
          const bf16* v = reinterpret_cast<const bf16*>(lin + 4 * pl);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float top =
                __fadd_rn(__fmul_rn(w0, __bfloat162float(v[e])),
                          __fmul_rn(w1, __bfloat162float(v[8 + e])));
            float bot =
                __fadd_rn(__fmul_rn(w0, __bfloat162float(v[16 + e])),
                          __fmul_rn(w1, __bfloat162float(v[24 + e])));
            if (kV1) {
              top = bf16r(top);
              bot = bf16r(bot);
              f[e] = __fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, ty)),
                               __fmul_rn(bot, ty));
            } else {
              f[e] = __fadd_rn(top, __fmul_rn(ty, __fsub_rn(bot, top)));
            }
          }
        }
        __align__(16) bf16 fo[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          comb[e] = pl == 0 ? f[e] : __fadd_rn(comb[e], f[e]);
          fo[e] = __float2bfloat16_rn(f[e]);
        }
        put8(parts.p[pl], i, c8, *reinterpret_cast<const uint4*>(fo));
      }
      __align__(16) bf16 co[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        co[e] =
            __float2bfloat16_rn(P.avg ? __fdiv_rn(comb[e], 3.0f) : comb[e]);
      put8(parts.p[3], i, c8, *reinterpret_cast<const uint4*>(co));
    }
    if (!kSigmaOnly) {
      const int vch = P.cvp / 8;
      for (int item = gt; item < kWgPoints * vch; item += kGatherThreads) {
        const int i = item / vch, c8 = (item % vch) * 8;
        const long long n = base + i;
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (n < N)
          q = __ldg(reinterpret_cast<const uint4*>(
              P.view + (size_t)(n / P.S) * P.cvp + c8));
        put8(parts.p[4], i, c8, q);
      }
    }
  }
};

template <bool kSigmaOnly, bool kCubic, bool kGrids, bool kV1>
__global__ void __launch_bounds__(kThreads, 1)
triplane_render_kernel(const __grid_constant__ Params P,
                       const __grid_constant__ Layout L) {
  static_assert(!(kGrids && kCubic), "the grids entries are bilinear");
  static_assert(!kV1 || (kGrids && !kSigmaOnly),
                "v1 is a full-decode grids entry");
  extern __shared__ __align__(128) unsigned char smem[];
  const Gather<kSigmaOnly, kCubic, kGrids, kV1> job{P, (long long)P.R * P.S};
  run_decoder<kSigmaOnly>(job, P.dec, L, job.N, smem);
}

template <bool kSigmaOnly, bool kCubic, bool kGrids = false, bool kV1 = false>
int launch(Params p, cudaStream_t stream) {
  set_slices(p.dec, p.cp, p.cvp);
  const Layout L = make_layout(p.cp, kSigmaOnly ? 0 : p.cvp,
                               TapShape<kCubic>::kInts,
                               TapShape<kCubic>::kFloats);
  return launch_persistent(
      triplane_render_kernel<kSigmaOnly, kCubic, kGrids, kV1>, p, L,
      (long long)p.R * p.S, stream);
}

Params make_params(const void* table, int H, int W, int cp,
                   const float* origins, const float* dirs, const float* z,
                   int R, int S, const void* view, int cvp, const void* w,
                   const float* b, const void* wh, const float* bh,
                   int n_density, int n_rgb, int skip_every,
                   const float* geom_host, int align_corners, int avg,
                   float* out) {
  Params p;
  p.table = static_cast<const bf16*>(table); p.H = H; p.W = W; p.cp = cp;
  p.origins = origins; p.dirs = dirs; p.z = z; p.R = R; p.S = S;
  p.grids = nullptr;
  p.view = static_cast<const bf16*>(view); p.cvp = cvp;
  p.dec.ws = static_cast<const bf16*>(w); p.dec.b = b;
  p.dec.whs = static_cast<const bf16*>(wh); p.dec.bh = bh;
  p.dec.n_density = n_density; p.dec.n_rgb = n_rgb;
  p.dec.skip_every = skip_every;
  p.align_corners = align_corners; p.avg = avg; p.out = out;
  if (geom_host)
    memcpy(&p.geom, geom_host, sizeof(Geom));
  else
    memset(&p.geom, 0, sizeof(Geom));
  return p;
}

}  // namespace

// Bytes of dynamic shared memory a launch takes for feature parts of cp
// (and view rows of cvp: 0 for the sigma-only entries) channels, bilinear
// or bicubic (mirrored by kernels.triplane_layout_bytes).
extern "C" int triplane_layout_bytes(int cp, int cvp, int cubic) {
  return (int)(cubic ? make_layout(cp, cvp, TapShape<true>::kInts,
                                   TapShape<true>::kFloats)
                     : make_layout(cp, cvp, TapShape<false>::kInts,
                                   TapShape<false>::kFloats))
      .total;
}

// C interface (ctypes). Returns a cudaError_t: 0 when the launch was
// accepted. geom_host: 24 host floats (box min, box max, rot[p][c][1:3]);
// w, b, wh, bh: the packed decoder (PackedDecoder.ws, b, whs, bh).
#define TRIPLANE_ARGS                                                        \
  const void *table, int H, int W, int cp, const float *origins,            \
      const float *dirs, const float *z, int R, int S, const void *view,    \
      int cvp, const void *w, const float *b, const void *wh,               \
      const float *bh, int n_density, int n_rgb, int skip_every,            \
      const float *geom_host, int align_corners, int avg, float *out,       \
      void *stream
#define TRIPLANE_PASS                                                        \
  table, H, W, cp, origins, dirs, z, R, S, view, cvp, w, b, wh, bh,         \
      n_density, n_rgb, skip_every, geom_host, align_corners, avg, out

extern "C" int triplane_render_full(TRIPLANE_ARGS) {
  return launch<false, false>(make_params(TRIPLANE_PASS),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int triplane_render_sigma_only(TRIPLANE_ARGS) {
  return launch<true, false>(make_params(TRIPLANE_PASS),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int triplane_render_cubic_full(TRIPLANE_ARGS) {
  return launch<false, true>(make_params(TRIPLANE_PASS),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int triplane_render_cubic_sigma_only(TRIPLANE_ARGS) {
  return launch<true, true>(make_params(TRIPLANE_PASS),
                            static_cast<cudaStream_t>(stream));
}

// The grids entries: grids [3, N, 2] f32, view [N, cvp] bf16 (unused by
// the sigma-only entry), out [N, 4] f32.
#define GRIDS_ARGS                                                           \
  const void *table, int H, int W, int cp, const float *grids, int N,       \
      const void *view, int cvp, const void *w, const float *b,             \
      const void *wh, const float *bh, int n_density, int n_rgb,            \
      int skip_every, int align_corners, int avg, float *out, void *stream

static Params grids_params(GRIDS_ARGS) {
  Params p = make_params(table, H, W, cp, nullptr, nullptr, nullptr, N, 1,
                         view, cvp, w, b, wh, bh, n_density, n_rgb,
                         skip_every, nullptr, align_corners, avg, out);
  p.grids = grids;
  return p;
}
#define GRIDS_PASS                                                           \
  table, H, W, cp, grids, N, view, cvp, w, b, wh, bh, n_density, n_rgb,     \
      skip_every, align_corners, avg, out, stream

extern "C" int triplane_render_grids_full(GRIDS_ARGS) {
  return launch<false, false, true, false>(
      grids_params(GRIDS_PASS), static_cast<cudaStream_t>(stream));
}

extern "C" int triplane_render_grids_sigma_only(GRIDS_ARGS) {
  return launch<true, false, true, false>(
      grids_params(GRIDS_PASS), static_cast<cudaStream_t>(stream));
}

extern "C" int triplane_render_grids_v1(GRIDS_ARGS) {
  return launch<false, false, true, true>(
      grids_params(GRIDS_PASS), static_cast<cudaStream_t>(stream));
}
