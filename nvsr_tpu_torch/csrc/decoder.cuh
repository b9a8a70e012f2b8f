// The triplane decoder of the Hopper kernels, shared by
// triplane_render.cu (gather + decode) and fused_decode.cu (decode of
// tap-pair rows): the counterpart of nvsr_tpu/ops/pallas/fused_decoder.py
// :130 (decode_body).
//
// One block of kWarps warps holds kPoints points in shared memory: per
// point the bf16 features f0, f1, f2, comb and view, each a Part (pointer,
// row stride, width). decode() runs the density MLP on comb and the rgb
// MLP on [f0, f1, f2, view] layer by layer: the layer's bf16 weight block
// (ops/fused_render.py::PackedDecoder) is staged into shared memory and
// each warp multiplies its 16 points with nvcuda::wmma (bf16, f32
// accumulate), adds the f32 bias, applies relu and stores bf16 back in
// place; skip layers re-read the branch input. The heads give rgb (cols
// 0:3) and sigma (col 3). The sigma-only form skips the rgb branch and
// puts the fc_rgb bias in the rgb lanes; its sigma is the same code as the
// full decode's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nvsr {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kPoints = 64;                 // points per block
constexpr int kWarps = kPoints / 16;        // each warp owns 16 points
constexpr int kThreads = kWarps * 32;
constexpr int kWidth = 128;                 // decoder width
constexpr int kLdAct = kWidth + 8;          // padded strides spread banks
constexpr int kLdW = kWidth + 8;
constexpr int kHeadCols = 16;               // rgb cols 0:3, sigma col 3
constexpr int kLdHead = kHeadCols + 8;

// byte offsets into dynamic shared memory
struct Layout {
  int ldf, ldv;
  unsigned hd, hr, feat, fv, wbuf, stage, taps, wts, total;
};

// the packed decoder (ops/fused_render.py::PackedDecoder)
struct Decoder {
  const bf16* w; const float* b; const bf16* wh; const float* bh;
  int n_density, n_rgb, skip_every;
};

__host__ __device__ inline unsigned align128(unsigned x) {
  return (x + 127u) & ~127u;
}

__host__ __device__ inline bool is_skip(int every, int layer_num) {
  return every > 0 && layer_num > 0 && layer_num % every == 0;
}

// rows of layer ln's weight block: its input parts, in packing order
__host__ __device__ inline int layer_rows(bool rgb, int ln, int every,
                                          int cp, int cvp) {
  int first = rgb ? 3 * cp + cvp : cp;
  if (ln == 0) return first;
  return is_skip(every, ln - 1) ? kWidth + first : kWidth;
}

// the largest weight block decode() stages
inline int max_layer_rows(const Decoder& d, bool sigma_only, int cp,
                          int cvp) {
  int max_rows = 0;
  for (int br = 0; br < (sigma_only ? 1 : 2); ++br) {
    const int nl = br ? d.n_rgb : d.n_density;
    for (int ln = 0; ln < nl; ++ln) {
      const int rows = layer_rows(br == 1, ln, d.skip_every, cp, cvp);
      if (rows > max_rows) max_rows = rows;
    }
  }
  return max_rows;
}

// tap_ints / tap_floats: per (point, plane) scratch of a gather phase
// (0 for none)
inline Layout make_layout(int cp, int cvp, int max_rows, int tap_ints,
                          int tap_floats) {
  Layout L;
  L.ldf = cp + 8;
  L.ldv = cvp + 8;
  unsigned off = 0;
  L.hd = off;    off = align128(off + kPoints * kLdAct * 2);
  L.hr = off;    off = align128(off + kPoints * kLdAct * 2);
  L.feat = off;  off = align128(off + 4 * kPoints * L.ldf * 2);
  L.fv = off;    off = align128(off + kPoints * L.ldv * 2);
  unsigned wbytes = (unsigned)max_rows * kLdW * 2;
  unsigned hbytes = 2 * kWidth * kLdHead * 2;
  L.wbuf = off;  off = align128(off + (wbytes > hbytes ? wbytes : hbytes));
  L.stage = off; off = align128(off + kWarps * 2 * 256 * 4);
  L.taps = off;  off = align128(off + kPoints * 3 * tap_ints * 4);
  L.wts = off;   off = align128(off + kPoints * 3 * tap_floats * 4);
  L.total = off;
  return L;
}

struct Part { const bf16* ptr; int ld; int width; };

// global [rows, cols] bf16 (row-major, contiguous) -> shared, stride ldd
__device__ inline void stage_rows(bf16* dst, int ldd, const bf16* src,
                                  int rows, int cols) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * cols + c));
  }
}

// out[warp rows, 0:128] = bf16(relu(concat(parts) @ wbuf + bias)); a warp
// reads and writes only its own 16 rows, so `out` may be an input part.
__device__ inline void mma_layer(const Part* parts, int nparts,
                                 const bf16* wbuf, const float* bias,
                                 bf16* out, float* stage, int warp,
                                 int lane) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);
  int kb = 0;
  for (int p = 0; p < nparts; ++p) {
    const bf16* a_base = parts[p].ptr + warp * 16 * parts[p].ld;
    for (int k = 0; k < parts[p].width; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + k, parts[p].ld);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, wbuf + (kb + k) * kLdW + j * 16, kLdW);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
    kb += parts[p].width;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const float v = __fadd_rn(stage[e], bias[j * 16 + c]);
      out[(warp * 16 + r) * kLdAct + j * 16 + c] =
          __float2bfloat16_rn(fmaxf(v, 0.0f));
    }
    __syncwarp();
  }
}

// The decoder on the block's kPoints points, called by every thread after
// the features are in shared memory (f0, f1, f2, comb: cp wide; view: cvp
// wide, not read by the sigma-only form). hd, hr: [kPoints, kLdAct] bf16
// activations; wbuf: staged weights; stage: this warp's 512 floats.
// Returns, in lanes 0..15 of each warp, (r, g, b, sigma) of the warp's
// point warp * 16 + lane; other lanes' values are not defined.
template <bool kSigmaOnly>
__device__ inline float4 decode(const Decoder& D, Part f0, Part f1, Part f2,
                                Part comb, Part view, bf16* hd, bf16* hr,
                                bf16* wbuf, float* stage, int cp, int cvp,
                                int warp, int lane) {
  const bf16* wl = D.w;
  int li = 0;
  Part parts[5];
  for (int br = 0; br < (kSigmaOnly ? 1 : 2); ++br) {
    const bool rgb = br == 1;
    bf16* x = rgb ? hr : hd;
    const int nl = rgb ? D.n_rgb : D.n_density;
    for (int ln = 0; ln < nl; ++ln) {
      int np = 0;
      if (ln > 0) parts[np++] = Part{x, kLdAct, kWidth};
      if (ln == 0 || is_skip(D.skip_every, ln - 1)) {
        if (rgb) {
          parts[np++] = f0; parts[np++] = f1; parts[np++] = f2;
          parts[np++] = view;
        } else {
          parts[np++] = comb;
        }
      }
      const int rows = layer_rows(rgb, ln, D.skip_every, cp, cvp);
      stage_rows(wbuf, kLdW, wl, rows, kWidth);
      __syncthreads();
      mma_layer(parts, np, wbuf, D.b + li * kWidth, x, stage, warp, lane);
      __syncthreads();
      wl += (size_t)rows * kWidth;
      ++li;
    }
  }

  // heads: rows [0, 128) of the staged block are fc_rgb, [128, 256) fc_alpha
  stage_rows(wbuf, kLdHead, D.wh, 2 * kWidth, kHeadCols);
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_r;
  wmma::fill_fragment(acc_s, 0.0f);
  wmma::fill_fragment(acc_r, 0.0f);
#pragma unroll
  for (int k = 0; k < kWidth; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
    wmma::load_matrix_sync(a, hd + warp * 16 * kLdAct + k, kLdAct);
    wmma::load_matrix_sync(bw, wbuf + (kWidth + k) * kLdHead, kLdHead);
    wmma::mma_sync(acc_s, a, bw, acc_s);
    if (!kSigmaOnly) {
      wmma::load_matrix_sync(a, hr + warp * 16 * kLdAct + k, kLdAct);
      wmma::load_matrix_sync(bw, wbuf + k * kLdHead, kLdHead);
      wmma::mma_sync(acc_r, a, bw, acc_r);
    }
  }
  wmma::store_matrix_sync(stage, acc_s, 16, wmma::mem_row_major);
  wmma::store_matrix_sync(stage + 256, acc_r, 16, wmma::mem_row_major);
  __syncwarp();
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < 16) {
    const float* s = stage + lane * 16;
    const float* r = stage + 256 + lane * 16;
    o.x = kSigmaOnly ? D.bh[0] : __fadd_rn(r[0], D.bh[0]);
    o.y = kSigmaOnly ? D.bh[1] : __fadd_rn(r[1], D.bh[1]);
    o.z = kSigmaOnly ? D.bh[2] : __fadd_rn(r[2], D.bh[2]);
    o.w = __fadd_rn(s[3], D.bh[3]);
  }
  return o;
}

}  // namespace nvsr
