// Triplane plane sampler for Hopper (sm_90a): the trainable bilinear
// forward gather and its scatter-add backward, and the bicubic eval
// forward.
//
// Replaces the TPU kernel nvsr_tpu/ops/pallas/tile_sampler.py:311 (_kernel,
// launched by _tile_gather :350 -> pl.pallas_call :367) as the forward of
// tiled_plane_sample_trainable (:1775-1859) together with the XLA y-lerp of
// tiled_plane_sample_prechunked (:657-665); and the XLA backward
// _trainable_bwd (:1801-1856) with its table fold _fold_table_grad
// (:1753-1772). Host side and plain PyTorch versions in
// nvsr_tpu_torch/ops/plane_sample.py, binding in nvsr_tpu_torch/kernels.py.
//
// plane_sample_fwd: table T = bf16(planes) channel-last [P, H, W, Cp]
// (ops/fused_render.py::build_plane_table), grids [P, N, 2] f32 normalized
// (x, y) -> out [P, N, C] f32. Per plane and point:
//   xp = clip(unnorm(gx), 0, W-1), yp = clip(unnorm(gy), 0, H-1);
//   x0 = floor(xp), tx = xp - x0, x1 = min(x0+1, W-1); y likewise;
//   w0 = bf16(1 - tx), w1 = bf16(tx);
//   top = bf16(w0*T[y0,x0] + w1*T[y0,x1]), bot = bf16(w0*T[y1,x0] + ...)
//     (the TPU kernel's output rows are bf16);
//   out = top*(1 - ty) + bot*ty in f32, in that form.
// plane_sample_bwd: dout [P, N, C] f32 -> dplanes [P, C, H, W] f32 with
//   dtop = bf16(dout*(1-ty)), dbot = bf16(dout*ty) and the four products
//   w0*dtop, w1*dtop, w0*dbot, w1*dbot added at (y0,x0), (y0,x1), (y1,x0),
//   (y1,x1). Border folds of _fold_table_grad are the clamps of x1 and y1.
//   The grids get no gradient.
// plane_sample_cubic_fwd: the same table and grids -> out [P, N, C] f32,
//   the bicubic form of the TPU kernel (_tile_gather with kernel="cubic",
//   :301-306) with the y-combine of tiled_plane_sample_prechunked_bicubic
//   (:535-540). Per plane and point:
//   xs = clip(unnorm(gx), -1, W), ys likewise; x0 = floor(xs), tx = xs - x0;
//   y0, ty likewise; taps at cols clamp(x0-1 .. x0+2), rows clamp(y0-1 ..
//   y0+2) (torch's border: the 4x4 window clamps, not the coordinate);
//   x-weights wx_i = bf16(cubic(i - tx)), i = -1..2 (sampling.cuh);
//   row_j = bf16(sum_i wx_i * T[y0+j, x0+i]) (the TPU kernel's bf16 rows);
//   out = c_-1*row_-1 + c_0*row_0 + c_1*row_1 + c_2*row_2 in f32, left to
//   right, with c_j = cubic(j - ty) in f32.
// Every f32 step uses _rn intrinsics, so no FMA contraction changes it: the
// forwards equal their plain versions bit for bit; the backward's atomic
// order changes from run to run, so it agrees to f32 summation order.
//
// What bounds them on the H100: bytes. At the training path's shapes
// (P = 3, N = 65,536, C = 48, 200^2 planes) the forward writes 37.7 MB and
// reads an 11.5 MB table and 1.6 MB of grids; the backward reads 37.7 MB
// of dout and the grids and writes 23 MB of dplanes. The bicubic forward
// at the eval fine pass's shapes (P = 3, N = 262,144, C = 48, 800^2
// planes) writes 151 MB and reads 6.3 MB of grids and at most the 184 MB
// table; its 16 tap loads per point mostly hit L1/L2. Arithmetic is a few
// operations per byte.
//
// Why a direct gather replaces the TPU design: Mosaic cannot gather in
// VMEM, so the TPU kernel DMAs a [th, tw] region of vertical tap pairs per
// chunk of tile-coherent points and selects taps with a hat-weight matmul,
// clamping chunks whose footprint overflows the region; its backward is
// the transposed matmul scattered region by region. On Hopper a tap is a
// plain load and a gradient tap a plain atomic add, so there are no
// regions, chunk orders or clamps: rays are taken ray-major, and no
// footprint is ever clamped (overflow_frac is 0.0).
//   forward:  one thread per (plane, point, 8 channels): four 16-byte tap
//             loads, two 16-byte stores;
//   cubic forward: one thread per (plane, point, 8 channels): sixteen
//             16-byte tap loads, row by row, two 16-byte stores;
//   backward: one thread per (plane, point, channel), four f32 atomicAdds
//             into a channel-last [P, H, W, C] scratch (a warp's adds fall
//             on neighbouring addresses), then a shared-memory transpose
//             to [P, C, H, W].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // transpose tile
constexpr int kRows = 8;    // transpose block: kTile x kRows threads

// one point's bilinear footprint on one plane
struct Tap {
  long long i00, i01, i10, i11;   // cells of the [P * H * W] grid
  float w0, w1, ty;
};

// pn = p * N + n indexes grids [P, N, 2]
__device__ inline Tap make_tap(const float* grids, long long pn, int p, int H,
                               int W, bool ac) {
  const float2 g = *reinterpret_cast<const float2*>(grids + pn * 2);
  const float x = fminf(fmaxf(unnormalize(g.x, W, ac), 0.0f), (float)(W - 1));
  const float y = fminf(fmaxf(unnormalize(g.y, H, ac), 0.0f), (float)(H - 1));
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f);
  const int x0 = min((int)x0f, W - 1), y0 = min((int)y0f, H - 1);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const long long base = (long long)p * H * W;
  Tap t;
  t.i00 = base + (long long)y0 * W + x0;
  t.i01 = base + (long long)y0 * W + x1;
  t.i10 = base + (long long)y1 * W + x0;
  t.i11 = base + (long long)y1 * W + x1;
  t.w0 = bf16r(__fsub_rn(1.0f, tx));
  t.w1 = bf16r(tx);
  t.ty = __fsub_rn(y, y0f);
  return t;
}

__global__ void __launch_bounds__(kThreads)
plane_sample_fwd_kernel(const bf16* __restrict__ table, int cp,
                        const float* __restrict__ grids, int N, int P, int H,
                        int W, int C, int ac, float* __restrict__ out) {
  const int groups = C / 8;
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (long long)P * N * groups) return;
  const long long pn = item / groups;
  const int c8 = (int)(item % groups) * 8;
  const Tap t = make_tap(grids, pn, (int)(pn / N), H, W, ac != 0);
  uint4 q[4];
  const long long cells[4] = {t.i00, t.i01, t.i10, t.i11};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = __ldg(reinterpret_cast<const uint4*>(table + cells[k] * cp + c8));
  const bf16* v00 = reinterpret_cast<const bf16*>(&q[0]);
  const bf16* v01 = reinterpret_cast<const bf16*>(&q[1]);
  const bf16* v10 = reinterpret_cast<const bf16*>(&q[2]);
  const bf16* v11 = reinterpret_cast<const bf16*>(&q[3]);
  const float wt = __fsub_rn(1.0f, t.ty);
  float o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float top = bf16r(__fadd_rn(__fmul_rn(t.w0, __bfloat162float(v00[e])),
                                      __fmul_rn(t.w1, __bfloat162float(v01[e]))));
    const float bot = bf16r(__fadd_rn(__fmul_rn(t.w0, __bfloat162float(v10[e])),
                                      __fmul_rn(t.w1, __bfloat162float(v11[e]))));
    o[e] = __fadd_rn(__fmul_rn(top, wt), __fmul_rn(bot, t.ty));
  }
  float4* dst = reinterpret_cast<float4*>(out + pn * C + c8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(kThreads)
plane_sample_cubic_fwd_kernel(const bf16* __restrict__ table, int cp,
                              const float* __restrict__ grids, int N, int P,
                              int H, int W, int C, int ac,
                              float* __restrict__ out) {
  const int groups = C / 8;
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (long long)P * N * groups) return;
  const long long pn = item / groups;
  const int c8 = (int)(item % groups) * 8;
  const long long p = pn / N;
  const float2 g = *reinterpret_cast<const float2*>(grids + pn * 2);
  int x0, y0;
  float tx, ty;
  cubic_coord(unnormalize(g.x, W, ac != 0), W, &x0, &tx);
  cubic_coord(unnormalize(g.y, H, ac != 0), H, &y0, &ty);
  float wx[4];
  int col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wx[i] = bf16r(cubic_weight(__fsub_rn((float)(i - 1), tx)));
    col[i] = min(max(x0 - 1 + i, 0), W - 1);
  }
  float o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yj = min(max(y0 - 1 + j, 0), H - 1);
    const bf16* row = table + ((p * H + yj) * W) * cp + c8;
    uint4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = __ldg(
          reinterpret_cast<const uint4*>(row + (long long)col[i] * cp));
    const bf16* v = reinterpret_cast<const bf16*>(q);   // v[i * 8 + e]
    const float cy = cubic_weight(__fsub_rn((float)(j - 1), ty));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float acc = __fmul_rn(wx[0], __bfloat162float(v[e]));
#pragma unroll
      for (int i = 1; i < 4; ++i)
        acc = __fadd_rn(acc,
                        __fmul_rn(wx[i], __bfloat162float(v[i * 8 + e])));
      const float term = __fmul_rn(cy, bf16r(acc));
      o[e] = j == 0 ? term : __fadd_rn(o[e], term);
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + pn * C + c8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// acc: channel-last [P * H * W, C] f32, zeroed
__global__ void __launch_bounds__(kThreads)
plane_sample_bwd_kernel(const float* __restrict__ dout,
                        const float* __restrict__ grids, int N, int P, int H,
                        int W, int C, int ac, float* __restrict__ acc) {
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (long long)P * N * C) return;
  const long long pn = item / C;
  const int c = (int)(item % C);
  const Tap t = make_tap(grids, pn, (int)(pn / N), H, W, ac != 0);
  const float d = dout[item];
  const float dtop = bf16r(__fmul_rn(d, __fsub_rn(1.0f, t.ty)));
  const float dbot = bf16r(__fmul_rn(d, t.ty));
  atomicAdd(acc + t.i00 * C + c, __fmul_rn(t.w0, dtop));
  atomicAdd(acc + t.i01 * C + c, __fmul_rn(t.w1, dtop));
  atomicAdd(acc + t.i10 * C + c, __fmul_rn(t.w0, dbot));
  atomicAdd(acc + t.i11 * C + c, __fmul_rn(t.w1, dbot));
}

// [P, HW, C] -> [P, C, HW]; block (kTile, kRows), grid (HW/32, C/32, P)
__global__ void hwc_to_chw_kernel(const float* __restrict__ in, int HW, int C,
                                  float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const long long p = blockIdx.z;
  const int hw0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int hw = hw0 + j, c = c0 + threadIdx.x;
    if (hw < HW && c < C)
      tile[j][threadIdx.x] = in[(p * HW + hw) * C + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int c = c0 + j, hw = hw0 + threadIdx.x;
    if (hw < HW && c < C)
      out[(p * C + c) * HW + hw] = tile[threadIdx.x][j];
  }
}

unsigned blocks_for(long long items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
}

}  // namespace

// C interface (ctypes). Each returns a cudaError_t: 0 when every launch
// was accepted. Requires C % 8 == 0, Cp % 8 == 0 and C <= Cp (checked by
// the Python wrapper).
extern "C" int plane_sample_fwd(const void* table, int P, int H, int W,
                                int cp, int C, const float* grids, int N,
                                int align_corners, float* out, void* stream) {
  const long long items = (long long)P * N * (C / 8);
  if (items == 0) return 0;
  plane_sample_fwd_kernel<<<blocks_for(items), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(table), cp, grids, N, P, H, W, C,
      align_corners, out);
  return (int)cudaGetLastError();
}

extern "C" int plane_sample_cubic_fwd(const void* table, int P, int H, int W,
                                      int cp, int C, const float* grids, int N,
                                      int align_corners, float* out,
                                      void* stream) {
  const long long items = (long long)P * N * (C / 8);
  if (items == 0) return 0;
  plane_sample_cubic_fwd_kernel<<<blocks_for(items), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(table), cp, grids, N, P, H, W, C,
      align_corners, out);
  return (int)cudaGetLastError();
}

// scratch: [P, H, W, C] f32 (any contents); out: [P, C, H, W] f32
extern "C" int plane_sample_bwd(const float* dout, const float* grids, int P,
                                int N, int C, int H, int W, int align_corners,
                                float* scratch, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)P * H * W;
  cudaError_t err = cudaMemsetAsync(scratch, 0, cells * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)P * N * C;
  if (items > 0) {
    plane_sample_bwd_kernel<<<blocks_for(items), kThreads, 0, s>>>(
        dout, grids, N, P, H, W, C, align_corners, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((H * W + kTile - 1) / kTile),
                  (unsigned)((C + kTile - 1) / kTile), (unsigned)P);
  hwc_to_chw_kernel<<<grid, dim3(kTile, kRows), 0, s>>>(scratch, H * W, C,
                                                        out);
  return (int)cudaGetLastError();
}
