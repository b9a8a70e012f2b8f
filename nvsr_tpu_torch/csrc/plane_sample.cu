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
// What bounds them on the H100. Bytes, by count: at the training path's
// shapes (P = 3, N = 65,536, C = 48, 200^2 planes) the forward writes 37.7
// MB and reads an 11.5 MB table and 1.6 MB of grids; the backward reads
// 37.7 MB of dout and the grids and writes 23 MB of dplanes; the bicubic
// forward at the eval fine pass's shapes (P = 3, N = 262,144, C = 48,
// 800^2 planes) writes 151 MB and reads 6.3 MB of grids and ~2.5 MB of
// distinct table cells. In practice the bicubic forward is bound by
// instruction issue (~53 instructions an output value, 16 of them bf16
// unpacks) and the backward by its per-chunk phases (PERF.md, §6).
//
// Why a direct gather replaces the TPU design: Mosaic cannot gather in
// VMEM, so the TPU kernel DMAs a [th, tw] region of vertical tap pairs per
// chunk of tile-coherent points and selects taps with a hat-weight matmul,
// clamping chunks whose footprint overflows the region; its backward is
// the transposed matmul scattered region by region. On Hopper a tap is a
// plain load, so the forwards need no regions, chunk orders or clamps, and
// no footprint is ever clamped.
//   forward:  one thread per (plane, point, 8 channels): four 16-byte tap
//             loads, two 16-byte stores;
//   cubic forward: probes showed skipping the stores or reading every tap
//             from one cell barely moves it, so the design removes
//             instructions. Blocks of 8 warps walk one contiguous range of
//             points each (one wave: SM count x occupancy blocks). A warp
//             takes a batch of up to 32 points: each lane computes one
//             point's geometry (grid load, cubic_coord x 2, four bf16
//             x-weights, four f32 y-weights, row and column byte offsets)
//             once, and the point's lanes read it by __shfl_sync. A point
//             is served by L = C/8 lanes (at most 32) of one warp, 32/L
//             points a round; lane l computes channels 8l .. 8l+7 from 16
//             16-byte tap loads, all issued before the first is used. Bf16
//             x bf16 products are exact in f32, so the x-sum's
//             multiply-adds fuse without changing a bit, and the rows are
//             rounded two at a time. A round's outputs are one contiguous
//             run of out, staged in shared memory and written by
//             consecutive lanes as 16-byte streaming stores (__stcs);
//   backward: persistent blocks, one per SM, walk chunks of kBwdChunk
//             consecutive points of one plane (and slices of up to 64
//             channels); one warp stages the next chunk's grids and dout
//             rows with cp.async while the others work. Each tap finds its
//             cell's slot in a shared-memory table (atomicCAS on the keys;
//             twice as many slots as taps, so none is ever refused) and its
//             rank in that slot (an integer atomicAdd); a scan of the
//             counts puts the taps in slot order; a thread per (item: up to
//             16 taps of one slot, 16 channels) sums the products in
//             registers, a segmented warp sum merges a hot cell's items (a
//             plane seen edge-on puts hundreds of a chunk's taps on one
//             cell), and the first lane of each cell adds the sums to
//             dplanes [P, C, H, W] (red.global.add.f32, lanes over
//             neighbouring cells of a row, so neighbouring addresses).
//             sm_90 has no f32 atomic add in shared memory (it compiles to
//             a compare-and-swap loop), so none is used. Training's
//             tile-coherent chunks touch ~120 cells each, so 37.7M global
//             atomics become ~4.4M, no channel-last scratch or transpose is
//             left, and the output's memset is the only extra pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kCubicWarps = 8;            // cubic forward: warps a block
constexpr int kBwdChunk = 256;            // backward: points a task
constexpr int kBwdThreads = 1024;         // one per tap of a chunk
constexpr int kBwdSlice = 64;             // backward: channels a task
constexpr int kTaps = 4 * kBwdChunk;      // taps of a chunk
constexpr int kBwdSlots = 2 * kTaps;      // slot table: twice the taps
constexpr int kSeg = 16;                  // taps a summing thread
constexpr int kItems = kTaps + kTaps / kSeg;  // (slot, segment) items
static_assert(kBwdThreads == kTaps, "a thread per tap");

// one point's bilinear footprint on one plane
struct Tap {
  long long i00, i01, i10, i11;   // cells of the [P * H * W] grid
  int x0, x1, y0, y1;
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
  Tap t;
  t.x0 = min((int)x0f, W - 1);
  t.y0 = min((int)y0f, H - 1);
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  const long long base = (long long)p * H * W;
  t.i00 = base + (long long)t.y0 * W + t.x0;
  t.i01 = base + (long long)t.y0 * W + t.x1;
  t.i10 = base + (long long)t.y1 * W + t.x0;
  t.i11 = base + (long long)t.y1 * W + t.x1;
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

// One bicubic point's geometry, as its lanes receive it: byte offsets of
// its four table rows and four columns, the bf16 x-weights packed two to
// a word (bf16 values, so the packing is exact), the f32 y-weights.
struct CubicGeom {
  unsigned row[4], col[4];
  unsigned wx01, wx23;
  float cy[4];
};

__device__ inline unsigned bf16_bits(float v) {   // v is a bf16 value
  return __float_as_uint(v) >> 16;
}

__device__ inline CubicGeom cubic_geom(const float* grids, int pn, int N,
                                       int H, int W, int cp, bool ac) {
  const float2 g = *reinterpret_cast<const float2*>(grids + 2LL * pn);
  int x0, y0;
  float tx, ty;
  cubic_coord(unnormalize(g.x, W, ac), W, &x0, &tx);
  cubic_coord(unnormalize(g.y, H, ac), H, &y0, &ty);
  const unsigned p = (unsigned)(pn / N), row_bytes = 2u * W * cp;
  CubicGeom q;
  unsigned wb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wb[i] = bf16_bits(bf16r(cubic_weight(__fsub_rn((float)(i - 1), tx))));
    q.col[i] = 2u * cp * min(max(x0 - 1 + i, 0), W - 1);
    q.row[i] = row_bytes * (p * H + min(max(y0 - 1 + i, 0), H - 1));
    q.cy[i] = cubic_weight(__fsub_rn((float)(i - 1), ty));
  }
  q.wx01 = wb[0] | (wb[1] << 16);
  q.wx23 = wb[2] | (wb[3] << 16);
  return q;
}

__device__ inline CubicGeom shfl_geom(const CubicGeom& g, int src) {
  CubicGeom q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q.row[i] = __shfl_sync(0xffffffffu, g.row[i], src);
    q.col[i] = __shfl_sync(0xffffffffu, g.col[i], src);
    q.cy[i] = __shfl_sync(0xffffffffu, g.cy[i], src);
  }
  q.wx01 = __shfl_sync(0xffffffffu, g.wx01, src);
  q.wx23 = __shfl_sync(0xffffffffu, g.wx23, src);
  return q;
}

// bf16 rounding of two values at once (one F2FP), back in f32
__device__ inline void bf16r2(float& a, float& b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&r);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// Eight channels of one point from its 16 taps v[j][i] (8 bf16 each):
// row_j = bf16(sum_i wx_i * T), left to right; out = sum_j cy_j * row_j,
// left to right: the plain version's order and roundings. A product of
// two bf16 values (8-bit significands) is exact in f32, so the x-sum's
// fused multiply-add rounds exactly where the plain version's add does
// (the two differ only if a product falls below 2^-133, where f32 cannot
// hold it exactly); cy_j is f32, so the y-combine multiplies and adds
// apart.
__device__ inline void cubic_combine(const CubicGeom& g, const uint4 v[4][4],
                                     float o[8]) {
  const float wx[4] = {__uint_as_float(g.wx01 << 16),
                       __uint_as_float(g.wx01 & 0xffff0000u),
                       __uint_as_float(g.wx23 << 16),
                       __uint_as_float(g.wx23 & 0xffff0000u)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float row[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned w = reinterpret_cast<const unsigned*>(&v[j][i])[e / 2];
        const float t = __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
        row[e] = i == 0 ? __fmul_rn(wx[0], t) : __fmaf_rn(wx[i], t, row[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; e += 2) bf16r2(row[e], row[e + 1]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float term = __fmul_rn(g.cy[j], row[e]);
      o[e] = j == 0 ? term : __fadd_rn(o[e], term);
    }
  }
}

// lanes: lanes a point (L = min(C/8, 32)); ppr: points a round (32 / L);
// batch: points a warp batch (ppr x rounds <= 32); each block walks the
// batches [blockIdx.x * per_block, + per_block), its warps in turn. Lane
// l of a point computes channels 8l .. 8l+7 (then + 8L, ... for C > 256);
// each round's outputs, ppr whole rows (or 256 channels of one row), are
// one contiguous run of out, staged in shared memory and written by
// consecutive lanes as 16-byte streaming stores.
__global__ void __launch_bounds__(kCubicWarps * 32)
plane_sample_cubic_fwd_kernel(const bf16* __restrict__ table, int cp,
                              const float* __restrict__ grids, int N, int P,
                              int H, int W, int C, int ac, int lanes, int ppr,
                              int batch, int batches, int per_block,
                              float* __restrict__ out) {
  __shared__ __align__(16) float stage[kCubicWarps][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = P * N, groups = C / 8, span = 8 * lanes;
  const int slot = lane / lanes, li = lane - slot * lanes;
  const int b_end = min((blockIdx.x + 1) * per_block, batches);
  float4* buf = reinterpret_cast<float4*>(stage[warp]);
  for (int b = blockIdx.x * per_block + warp; b < b_end; b += kCubicWarps) {
    const int pn0 = b * batch;
    CubicGeom mine = {};
    if (lane < batch && pn0 + lane < total)
      mine = cubic_geom(grids, pn0 + lane, N, H, W, cp, ac != 0);
    for (int first = 0; first < batch; first += ppr) {
      const CubicGeom g = shfl_geom(mine, (first + slot) & 31);
      const int pn = pn0 + first + slot;
      const int rows = min(ppr, total - (pn0 + first));
      if (rows <= 0) break;   // warp-uniform: the batch's tail is past N
      for (int k = 0; k * lanes < groups; ++k) {
        const int grp = li + k * lanes;
        if (slot < ppr && pn < total && grp < groups) {
          const char* base = reinterpret_cast<const char*>(table) + 16 * grp;
          uint4 v[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[j][i] = __ldg(reinterpret_cast<const uint4*>(
                  base + (g.row[j] + g.col[i])));
          float o[8];
          cubic_combine(g, v, o);
          buf[(slot * span + 8 * li) / 4] = make_float4(o[0], o[1], o[2], o[3]);
          buf[(slot * span + 8 * li) / 4 + 1] =
              make_float4(o[4], o[5], o[6], o[7]);
        }
        __syncwarp();
        // the run: rows whole rows of C (C <= 256: span = C) or one row's
        // channels [k * span, + span); at most 256 floats, two 16-byte
        // vectors a lane
        const int n4 = rows * min(span, C - k * span) / 4;
        float4* dst = reinterpret_cast<float4*>(
            out + (long long)(pn0 + first) * C + k * span);
        if (lane < n4) __stcs(dst + lane, buf[lane]);
        if (lane + 32 < n4) __stcs(dst + lane + 32, buf[lane + 32]);
        __syncwarp();
      }
    }
  }
}

// asynchronous global -> shared copies (cp.async), waited for as a group
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The slot of `cell` (x, y of one plane) in a table of kBwdSlots slots,
// inserted if absent. The table holds at least twice the taps of a chunk,
// so an empty slot is always found. Neighbouring cells of a row get
// neighbouring slots, so the flush's lanes over slots add to neighbouring
// addresses.
__device__ inline int slot_of(int* keys, int cell, int x, int y) {
  unsigned h = ((unsigned)x + (unsigned)y * 0x9E3779B1u) & (kBwdSlots - 1);
  while (true) {
    const int key = *reinterpret_cast<volatile int*>(keys + h);
    if (key == cell) return (int)h;
    if (key == -1) {
      const int prev = atomicCAS(keys + h, -1, cell);
      if (prev == -1 || prev == cell) return (int)h;
    }
    h = (h + 1) & (kBwdSlots - 1);
  }
}

// Shared memory of the backward (bytes), for channel slices of up to cs
// channels: two dout row buffers [kBwdChunk][rs] f32 (rs = round_up(cs,
// 4) + 4) and two grid buffers [kBwdChunk][2] f32, the sorted taps' (f,
// w) [kTaps] f32 pairs (f = 1 - ty or ty, w = w0 or w1), keys, counts
// [kBwdSlots], the items' keys and starts [kItems + 1], each raw tap's
// slot and rank [kTaps], per point w0, w1, ty [kBwdChunk], the sorted
// taps' points [kTaps] u16.
__host__ __device__ inline int bwd_row_stride(int cs) {
  return (cs + 3) / 4 * 4 + 4;
}

__host__ __device__ inline size_t bwd_smem_bytes(int cs) {
  return (size_t)2 * kBwdChunk * (bwd_row_stride(cs) + 2) * 4 +
         (size_t)kTaps * 8 +
         (size_t)kBwdSlots * 8 + (size_t)(kItems + 1) * 8 + (size_t)kTaps * 4 +
         (size_t)kBwdChunk * 12 + (size_t)kTaps * 2;
}

// A task of the backward: (plane, chunk of kBwdChunk consecutive points,
// slice of at most kBwdSlice channels)
struct BwdTask {
  int p, n0, npts, c0, cs;
};

__device__ inline BwdTask bwd_task(int task, int N, int C, int chunks,
                                   int slices) {
  BwdTask k;
  const int slice = task % slices, pc = task / slices;
  k.p = pc / chunks;
  k.n0 = (pc - k.p * chunks) * kBwdChunk;
  k.npts = min(kBwdChunk, N - k.n0);
  k.c0 = slice * kBwdSlice;
  k.cs = min(kBwdSlice, C - k.c0);
  return k;
}

// a task's grids into `g` and dout rows, channels [c0, c0 + cs), into
// `rows` with cp.async (16-byte copies of dout when C % 4 == 0: then c0
// and cs are multiples of 4 too)
__device__ inline void bwd_stage(const float* __restrict__ dout,
                                 const float* __restrict__ grids,
                                 const BwdTask& k, int N, int C, int rs,
                                 float* rows, float* g, int tid, int nt) {
  const float* gsrc = grids + ((long long)k.p * N + k.n0) * 2;
  for (int i = tid; i < k.npts; i += nt) {
    cp_async4(g + 2 * i, gsrc + 2 * i);
    cp_async4(g + 2 * i + 1, gsrc + 2 * i + 1);
  }
  const float* src = dout + ((long long)k.p * N + k.n0) * C + k.c0;
  if (C % 4 == 0) {
    const int q4 = k.cs / 4;
    for (int i = tid; i < k.npts * q4; i += nt) {
      const int r = i / q4, c = 4 * (i - r * q4);
      cp_async16(rows + r * rs + c, src + (long long)r * C + c);
    }
  } else {
    for (int i = tid; i < k.npts * k.cs; i += nt) {
      const int r = i / k.cs, c = i - r * k.cs;
      cp_async4(rows + r * rs + c, src + (long long)r * C + c);
    }
  }
}

// acc[j] += w * bf16(d_j * f) over the taps [e0, e1) of one item, for
// the channels [c, c + 4 * blocks) of the rows (kBlocks > 0: that many
// blocks of four, fixed). The product w * bf16(...) of two bf16 values is
// exact in f32, so its multiply-add rounds exactly where the plain
// version's add does (but for products below 2^-133).
template <int kBlocks>
__device__ inline void sum_taps(float acc[16], const float* rows, int rs,
                                int c, const float2* tfw,
                                const unsigned short* tpt, int e0, int e1,
                                int blocks = kBlocks) {
  for (int e = e0; e < e1; ++e) {
    const float2 fw = tfw[e];
    const float* r = rows + tpt[e] * rs + c;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      if (jb < (kBlocks ? kBlocks : blocks)) {
        const float4 d = *reinterpret_cast<const float4*>(r + 4 * jb);
        float dv[4] = {__fmul_rn(d.x, fw.x), __fmul_rn(d.y, fw.x),
                       __fmul_rn(d.z, fw.x), __fmul_rn(d.w, fw.x)};
        bf16r2(dv[0], dv[1]);
        bf16r2(dv[2], dv[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[4 * jb + q] = __fmaf_rn(fw.y, dv[q], acc[4 * jb + q]);
      }
    }
  }
}

// Persistent blocks (one wave, one 1024-thread block per SM) walk the
// tasks; the last warp copies the next task's grids and dout rows
// (cp.async) into one of two buffers while the other warps sum this
// task's. Per task: each tap's cell gets its slot (atomicCAS on the keys)
// and its rank in the slot (an integer atomicAdd on the slot's count), a
// thread per tap; an exclusive scan of the counts; the taps scattered into
// slot order; then a thread per (item of up to kSeg taps of one slot,
// 16-channel group) sums its taps in registers, a segmented warp sum
// merges a slot's items, and the first lane of each slot adds the sums to
// dplanes, one red.global.add.f32 per channel, lanes over consecutive
// slots. No f32 atomic touches shared memory (sm_90 has none: it would be
// a compare-and-swap loop).
__global__ void __launch_bounds__(kBwdThreads)
plane_sample_bwd_kernel(const float* __restrict__ dout,
                        const float* __restrict__ grids, int N, int H, int W,
                        int C, int ac, int chunks, int slices, int tasks,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = bwd_row_stride(min(C, kBwdSlice));
  // the two row and grid buffers: rows + b * rows_n, gbuf + b * 2 *
  // kBwdChunk, b = 0, 1
  float* rows = reinterpret_cast<float*>(smem);
  const int rows_n = kBwdChunk * rs;
  float* gbuf = rows + 2 * rows_n;
  float2* tfw = reinterpret_cast<float2*>(gbuf + 4 * kBwdChunk);
  int* keys = reinterpret_cast<int*>(tfw + kTaps);
  int* cnt = keys + kBwdSlots;
  int* ikey = cnt + kBwdSlots;
  int* istart = ikey + kItems + 1;
  int* traw = istart + kItems + 1;
  float* pw0 = reinterpret_cast<float*>(traw + kTaps);
  float* pw1 = pw0 + kBwdChunk;
  float* pty = pw1 + kBwdChunk;
  unsigned short* tpt = reinterpret_cast<unsigned short*>(pty + kBwdChunk);
  __shared__ int items_total;
  __shared__ int warp_sums[kBwdThreads / 32];
  const int HW = H * W, t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the last warp stages the tasks' grids and dout rows (cp.async), the
  // next task's while the other warps sum this one: the copies' issue
  // waits on the memory system, so it stays out of the barrier-bound
  // phases
  const bool stager = warp == kBwdThreads / 32 - 1;
  int buf = 0;
  if (stager)
    bwd_stage(dout, grids, bwd_task(blockIdx.x, N, C, chunks, slices), N,
              C, rs, rows, gbuf, lane, 32);
  for (int task = blockIdx.x; task < tasks; task += gridDim.x, buf ^= 1) {
    const BwdTask k = bwd_task(task, N, C, chunks, slices);
    for (int i = t; i < kBwdSlots; i += kBwdThreads) {
      keys[i] = -1;
      cnt[i] = 0;
    }
    // this task's grids and rows have landed
    if (stager) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // a thread per tap: its point's geometry, its cell's slot, its rank
    if (t < 4 * k.npts) {
      const int pt = t >> 2, corner = t & 3;
      const Tap tp = make_tap(gbuf + buf * 2 * kBwdChunk, pt, 0, H, W,
                              ac != 0);
      const int x = corner & 1 ? tp.x1 : tp.x0;
      const int y = corner < 2 ? tp.y0 : tp.y1;
      const int s = slot_of(keys, y * W + x, x, y);
      traw[t] = (s << 11) | atomicAdd(cnt + s, 1);
      if (corner == 0) {
        pw0[pt] = tp.w0;
        pw1[pt] = tp.w1;
        pty[pt] = tp.ty;
      }
    }
    __syncthreads();

    // exclusive scan of (segments << 16 | count) over the slots, in slot
    // order (each thread a run of kBwdSlots / kBwdThreads slots), left in
    // cnt: a used slot's taps become ceil(count / kSeg) items of at most
    // kSeg taps, so a hot cell is summed by many threads
    {
      constexpr int run = kBwdSlots / kBwdThreads;
      int v[run], sum = 0;
#pragma unroll
      for (int j = 0; j < run; ++j) {
        const int c = cnt[t * run + j];
        v[j] = sum;
        sum += ((c + kSeg - 1) / kSeg << 16) | c;
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (lane == 31) warp_sums[warp] = incl;
      __syncthreads();
      // the warps' totals scanned by shuffles (32 warps, one per lane)
      int ws = warp_sums[lane], wincl = ws;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, wincl, d);
        if (lane >= d) wincl += u;
      }
      const int before =
          incl - sum + __shfl_sync(0xffffffffu, wincl - ws, warp);
#pragma unroll
      for (int j = 0; j < run; ++j) cnt[t * run + j] = before + v[j];
      if (t == kBwdThreads - 1) {
        const int all = before + sum;
        items_total = all >> 16;
        istart[all >> 16] = all & 0xffff;
      }
    }
    __syncthreads();

    // the taps in slot order: (f, w) = (1 - ty or ty, w0 or w1), the
    // point; the first tap of each item records the item's key and start
    if (t < 4 * k.npts) {
      const int v = traw[t], pt = t >> 2, corner = t & 3;
      const int slot = v >> 11, rank = v & 2047, pre = cnt[slot];
      const int pos = (pre & 0xffff) + rank;
      if (rank % kSeg == 0) {
        ikey[(pre >> 16) + rank / kSeg] = keys[slot];
        istart[(pre >> 16) + rank / kSeg] = pos;
      }
      const float ty = pty[pt];
      tfw[pos] = make_float2(corner < 2 ? __fsub_rn(1.0f, ty) : ty,
                             corner & 1 ? pw1[pt] : pw0[pt]);
      tpt[pos] = (unsigned short)pt;
    }
    __syncthreads();

    // per (item, 16-channel group): today's products, multiply-added in
    // registers from -0 (so the first returns the first product).
    // Lanes run over consecutive items, so the items of one slot (a hot
    // cell's segments) sit in neighbouring lanes: a segmented shuffle sum
    // leaves each slot's total in its first lane, and only those lanes add
    // to dplanes (red.global.add.f32), neighbouring cells of a row at
    // neighbouring addresses. Adds to one address would queue in L2 one
    // by one.
    const int items = items_total, cgroups = (k.cs + 15) / 16;
    const float* r0 = rows + buf * rows_n;
    if (stager && task + gridDim.x < tasks)
      bwd_stage(dout, grids, bwd_task(task + gridDim.x, N, C, chunks,
                                      slices),
                N, C, rs, rows + (buf ^ 1) * rows_n,
                gbuf + (buf ^ 1) * 2 * kBwdChunk, lane, 32);
    for (int base = warp * 32; !stager && base < items * cgroups;
         base += kBwdThreads - 32) {
      const int it = base + lane;
      const bool active = it < items * cgroups;
      const int cg = active ? it / items : 0, u = it - cg * items;
      const int key = active ? ikey[u] : -1 - lane;
      const int nch = min(16, k.cs - 16 * cg);
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = -0.0f;
      const int e1 = active ? istart[u + 1] : 0;
      const int e0 = active ? istart[u] : 0;
      if (nch == 16)
        sum_taps<4>(acc, r0, rs, 16 * cg, tfw, tpt, e0, e1);
      else
        sum_taps<0>(acc, r0, rs, 16 * cg, tfw, tpt, e0, e1, (nch + 3) / 4);
      // (key, cg) runs are contiguous: a segmented suffix sum over lanes
      // (every lane takes part in every shuffle: none sits behind a
      // short-circuit)
      const int key_up = __shfl_up_sync(0xffffffffu, key, 1);
      const int cg_up = __shfl_up_sync(0xffffffffu, cg, 1);
      const bool head = lane == 0 || key_up != key || cg_up != cg;
      if (__any_sync(0xffffffffu, !head)) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int key_dn = __shfl_down_sync(0xffffffffu, key, d);
          const int cg_dn = __shfl_down_sync(0xffffffffu, cg, d);
          const bool same = lane + d < 32 && key_dn == key && cg_dn == cg;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float v = __shfl_down_sync(0xffffffffu, acc[j], d);
            if (same) acc[j] = __fadd_rn(acc[j], v);
          }
        }
      }
      if (active && head) {
        float* o = out + ((long long)k.p * C + k.c0 + 16 * cg) * HW + key;
#pragma unroll
        for (int j = 0; j < 16; ++j, o += HW)
          if (j < nch) atomicAdd(o, acc[j]);
      }
    }
    // the tables and this buffer are reused by the task after next
    __syncthreads();
  }
}

unsigned blocks_for(long long items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// C interface (ctypes). Each returns a cudaError_t: 0 when every launch
// was accepted. The forwards require C % 8 == 0, Cp % 8 == 0 and C <= Cp
// (checked by the Python wrapper); the backward takes any C.
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
  const int total = P * N;
  if (total == 0 || C == 0) return 0;
  const int lanes = min(C / 8, 32), ppr = 32 / lanes;
  const int batch = ppr * (32 / ppr);
  const int batches = (total + batch - 1) / batch;
  int occ = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, plane_sample_cubic_fwd_kernel, kCubicWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  // one wave of blocks, each a contiguous range of whole warp turns
  const int wave = max(sm_count() * occ, 1);
  const int turns = (batches + kCubicWarps - 1) / kCubicWarps;
  const int per_block = kCubicWarps * ((turns + wave - 1) / wave);
  const int blocks = (batches + per_block - 1) / per_block;
  plane_sample_cubic_fwd_kernel<<<blocks, kCubicWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(table), cp, grids, N, P, H, W, C,
      align_corners, lanes, ppr, batch, batches, per_block, out);
  return (int)cudaGetLastError();
}

// out: [P, C, H, W] f32, zeroed here
extern "C" int plane_sample_bwd(const float* dout, const float* grids, int P,
                                int N, int C, int H, int W, int align_corners,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (long long)P * C * H * W * sizeof(float), s);
  if (err != cudaSuccess || (long long)P * N * C == 0) return (int)err;
  const int slices = (C + kBwdSlice - 1) / kBwdSlice;
  const int chunks = (N + kBwdChunk - 1) / kBwdChunk;
  const int tasks = P * chunks * slices;
  const size_t smem = bwd_smem_bytes(min(C, kBwdSlice));
  err = cudaFuncSetAttribute(plane_sample_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, plane_sample_bwd_kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = min(tasks, max(sm_count() * occ, 1));
  plane_sample_bwd_kernel<<<blocks, kBwdThreads, smem, s>>>(
      dout, grids, N, H, W, C, align_corners, chunks, slices, tasks, out);
  return (int)cudaGetLastError();
}
