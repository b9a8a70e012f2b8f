// The triplane decoder of the Hopper kernels, shared by
// triplane_render.cu (gather + decode) and fused_decode.cu (decode of
// tap-pair rows): the counterpart of nvsr_tpu/ops/pallas/fused_decoder.py
// :130 (decode_body).
//
// What it computes, per point: the density MLP on comb and the rgb MLP on
// [f0, f1, f2, view] (bf16 features), layer by layer with bf16 operands, f32
// accumulation, an f32 bias added with __fadd_rn, relu, and the activation
// rounded to bf16; skip layers re-read the branch input. The heads give rgb
// (lanes 0:3, fc_rgb) and sigma (lane 3, fc_alpha). The sigma-only form
// skips the rgb branch and puts the fc_rgb bias in the rgb lanes; its sigma
// is the same code as the full decode's.
//
// What bounds it on the H100: the decoder is ~0.26 MFLOP a point (4+4
// layers of width 128) at 989 TFLOP/s bf16, while its inputs are ~1 KB a
// point; the kernels that hold it are bound by operations. What the design
// does about it (hopper-kernels guide §1):
//   * persistent, warp-specialised blocks of four warpgroups (512
//     threads), one block per SM, walking the 128-point tiles t =
//     blockIdx.x, +gridDim.x, ... as 64-point shares (shares 2j and 2j + 1
//     are tile j's halves):
//       - two producer warpgroups (kProducerWgs): their first seven warps
//         gather each share's features (the Job) into a ring of kStages
//         feature stages in shared memory, in the wgmma A layout; the
//         last warp streams the weights;
//       - the two consumer warpgroups after them decode the even and the
//         odd shares, one wgmma M tile of 64 points each;
//     so the next shares are gathered while the tensor cores decode this
//     one. A stage is handed over by mbarriers: "full" once every gather
//     thread has written it (count kGatherThreads), "empty" once each warp
//     of its consumer has completed the last wgmma that reads it (count
//     4): in the full decode the rgb branch's last feature read, in the
//     sigma-only decode the density branch's. Why seven gather warps: the
//     gather is latency-bound; with three (one producer warpgroup, 384
//     threads) the bicubic coarse pass was gather-bound and slower than
//     the serial design (PERF.md §6);
//   * setmaxnreg moves registers from the producer warpgroups
//     (kProducerRegs) to the consumers (kConsumerRegs), whose 64 f32
//     accumulators, 32 packed bf16 A registers and head outputs live in
//     registers through every layer; at 512 threads a thread starts with
//     at most 128;
//   * the weights, repacked once on the host (ops/fused_render.py
//     ::pack_decoder, PackedDecoder.ws) into the no-swizzle K-major layout
//     the wgmma B descriptor reads, are streamed once per 128 points in
//     contiguous 64-row K-slices of 16 KB through a ring of kRing slices in
//     shared memory, by 1-D bulk copies completing on mbarriers; the layer
//     sequence repeats for every tile, so the ring runs on across tiles;
//   * activations stay in registers: each layer is wgmma.m64n128k16 with
//     f32 accumulators in registers (64 a thread); the epilogue (bias,
//     relu, bf16) runs in registers and its packed bf16 pairs are the next
//     layer's A operand (the register form of wgmma); feature parts (comb,
//     f0/f1/f2/view, and the skip layers' re-read) are A from shared
//     memory, accumulated into the same registers;
//   * the heads (8 KB, resident) are wgmma.m64n16k16 from the registers;
//     the sigma head runs right after the density branch.
// Shared memory (make_layout): the weight ring 64 KB, the heads 8 KB, the
// barriers, kStages feature stages of 64 * (4 cp + cvp) bf16 and one tap
// scratch of the gather warps: 215,168 bytes at cp = cvp = 64 in bicubic,
// the widest that fused_render.supports admits, under the 232,448 a block
// may use (kernels.triplane_layout_bytes mirrors it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace nvsr {

typedef __nv_bfloat16 bf16;

constexpr int kWidth = 128;                 // decoder width
constexpr int kHeadCols = 16;               // rgb cols 0:3, sigma col 3
constexpr int kWgPoints = 64;               // points of a share
constexpr int kConsumers = 2;               // consumer warpgroups a block
constexpr int kTilePoints = kConsumers * kWgPoints;
constexpr int kWgThreads = 128;
// the producer warpgroups: their last warp streams the weights, the
// others gather
constexpr int kProducerWgs = 2;
constexpr int kProducerWarps = 4 * kProducerWgs;
constexpr int kWeightWarp = kProducerWarps - 1;
constexpr int kGatherThreads = 32 * (kProducerWarps - 1);
constexpr int kThreads = (kProducerWgs + kConsumers) * kWgThreads;
constexpr int kGatherBar = 1;               // named barrier of the gather
constexpr int kStages = 3;                  // feature stages in flight
// registers a thread after setmaxnreg; they must fit the SM's 65,536
constexpr int kProducerRegs = 104;
constexpr int kConsumerRegs = 152;
static_assert(kProducerWgs * kWgThreads * kProducerRegs +
                      kConsumers * kWgThreads * kConsumerRegs <=
                  65536,
              "setmaxnreg counts exceed the register file");
constexpr int kStepRows = 16;               // K rows of one wgmma
constexpr int kStepBytes = kStepRows * kWidth * 2;      // 4 KB
constexpr int kSliceSteps = 4;              // a ring slice: 64 K rows
constexpr int kSliceBytes = kSliceSteps * kStepBytes;   // 16 KB
constexpr int kRing = 4;                    // ring slices in flight
constexpr int kHeadStepBytes = kStepRows * kHeadCols * 2;
constexpr int kHeadBytes = 2 * (kWidth / kStepRows) * kHeadStepBytes;
// a feature part of a share, [width / 8][8 point groups][8][8] bf16:
// bytes of one 8-channel group of its 64 points
constexpr int kKGroupBytes = kWgPoints * 16;

// the packed decoder (ops/fused_render.py::PackedDecoder)
struct Decoder {
  const bf16* ws;     // weight stream: density slices, then rgb slices
  const float* b;     // [n_density + n_rgb, 128]
  const bf16* whs;    // heads fc_rgb, fc_alpha in the B layout
  const float* bh;    // [16]
  int n_density, n_rgb, skip_every;
  int d_slices, r_slices;
};

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

// the slices of each branch in the stream (ops/fused_render.py
// ::pack_stream pads each branch to whole slices)
inline void set_slices(Decoder& d, int cp, int cvp) {
  int rows[2] = {0, 0};
  for (int br = 0; br < 2; ++br)
    for (int ln = 0; ln < (br ? d.n_rgb : d.n_density); ++ln)
      rows[br] += layer_rows(br == 1, ln, d.skip_every, cp, cvp);
  d.d_slices = (rows[0] + kSliceSteps * kStepRows - 1) /
               (kSliceSteps * kStepRows);
  d.r_slices = (rows[1] + kSliceSteps * kStepRows - 1) /
               (kSliceSteps * kStepRows);
}

__host__ __device__ inline unsigned align128(unsigned x) {
  return (x + 127u) & ~127u;
}

// byte offsets into dynamic shared memory
struct Layout {
  int cp, cvp;                  // feature part widths (cvp 0: no view)
  unsigned ring, heads, bars, feat, scratch;
  unsigned feat_bytes, scratch_bytes, total;
};

// tap_ints / tap_floats: per (point, plane) scratch of the gather
__host__ __device__ inline Layout make_layout(int cp, int cvp, int tap_ints,
                                              int tap_floats) {
  Layout L;
  L.cp = cp;
  L.cvp = cvp;
  L.feat_bytes = align128(kWgPoints * (4 * cp + cvp) * 2);
  L.scratch_bytes = align128(kWgPoints * 3 * (tap_ints + tap_floats) * 4);
  unsigned off = 0;
  L.ring = off;    off += kRing * kSliceBytes;
  L.heads = off;   off += kHeadBytes;
  L.bars = off;    off = align128(off + 2 * (kRing + kStages) * 8);
  L.feat = off;    off += kStages * L.feat_bytes;
  L.scratch = off; off += L.scratch_bytes;
  L.total = off;
  return L;
}

// a share's feature parts f0, f1, f2, comb, view
struct Parts {
  unsigned char* p[5];
};

__device__ inline Parts make_parts(unsigned char* feat, int cp) {
  Parts P;
  for (int i = 0; i < 5; ++i) P.p[i] = feat + i * kWgPoints * cp * 2;
  return P;
}

// channels c8 .. c8 + 7 of point i (of 64) into a feature part
__device__ inline void put8(unsigned char* part, int i, int c8, uint4 v) {
  *reinterpret_cast<uint4*>(part + (c8 >> 3) * kKGroupBytes +
                            (i >> 3) * 128 + (i & 7) * 16) = v;
}

// A consumer warpgroup's position in the weight ring. Slices are taken in
// ring order; a slice is released (one arrival on its empty barrier) once
// the wgmma that read it have completed. A warpgroup holds at most the
// previous and the current slice, so the producer keeps the others loading.
struct Ring {
  uint32_t base, full, empty;
  int slot, within, held, rel;
  uint32_t phase;
  bool open;                    // wgmma issued since the last commit

  __device__ void release(bool leader) {
    if (leader) mbar_arrive(empty + 8 * rel);
    rel = (rel + 1) % kRing;
    --held;
  }

  // the B descriptor of the next K step of the stream
  __device__ uint64_t take(bool leader) {
    if (within == kSliceSteps) {
      slot = (slot + 1) % kRing;
      if (slot == 0) phase ^= 1u;
      within = 0;
    }
    if (within == 0) {
      if (open) {
        wgmma_commit();
        open = false;
      }
      wgmma_wait<1>();          // all but the previous slice's group
      while (held > 1) release(leader);
      mbar_wait(full + 8 * slot, phase);
      ++held;
    }
    open = true;
    // a K step of B (fused_render.to_b_layout): its two 8-row K halves
    // are 16 column groups x 128 B apart, the column groups 128 B apart
    const uint32_t a = base + slot * kSliceBytes + (within++) * kStepBytes;
    return smem_desc(a, (kWidth / 8) * 128, 128);
  }

  // end of a layer: its wgmma complete; at a branch end the rest of the
  // slice is padding
  __device__ void layer_end(bool branch_end, bool leader) {
    wgmma_commit();
    open = false;
    wgmma_wait<0>();
    if (branch_end) within = kSliceSteps;
    const int keep = within == kSliceSteps ? 0 : 1;
    while (held > keep) release(leader);
  }
};

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// (rgb, sigma) of two points of the warpgroup: rows 16 * warp + lane / 4
// (lo) and that + 8 (hi); defined in lanes with lane % 4 == 0
struct HeadOut {
  float4 lo, hi;
};

// the last layer of a branch of nl layers that reads the feature parts:
// layer 0 and every layer after a skip layer
__device__ inline int last_feature_layer(int nl, int every) {
  int last = 0;
  for (int ln = 1; ln < nl; ++ln)
    if (is_skip(every, ln - 1)) last = ln;
  return last;
}

// The decoder on a share's 64 points, whose feature parts (f0, f1, f2,
// comb, view; make_parts) are in the feature stage at address feat. Once
// the last wgmma that reads the stage has completed, lane 0 of each warp
// arrives on the stage's empty barrier `release`.
template <bool kSigmaOnly>
__device__ inline HeadOut decode(const Decoder& D, uint32_t feat, int cp,
                                 int cvp, uint32_t heads, Ring& ring,
                                 bool leader, int lane, uint32_t release) {
  float acc[64];
  uint32_t act[32];
  float sig[8], rgb[8];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sig[i] = rgb[i] = 0.0f;
  // the branch whose last feature read frees the stage
  const int rel_br = kSigmaOnly ? 0 : 1;
  const int rel_ln = last_feature_layer(kSigmaOnly ? D.n_density : D.n_rgb,
                                        D.skip_every);
  int li = 0;
#pragma unroll
  for (int br = 0; br < (kSigmaOnly ? 1 : 2); ++br) {
    const bool is_rgb = br == 1;
    const int nl = is_rgb ? D.n_rgb : D.n_density;
    for (int ln = 0; ln < nl; ++ln) {
      wgmma_fence();
      int scale = 0;
      if (ln > 0) {
#pragma unroll
        for (int kk = 0; kk < kWidth / kStepRows; ++kk) {
          wgmma_128_rs(acc, act + 4 * kk, ring.take(leader), scale);
          scale = 1;
        }
      }
      if (ln == 0 || is_skip(D.skip_every, ln - 1)) {
        // density: comb; rgb: f0, f1, f2, view
        for (int q = 0; q < (is_rgb ? 4 : 1); ++q) {
          const int p = is_rgb ? (q == 3 ? 4 : q) : 3;
          const int steps = (p == 4 ? cvp : cp) / kStepRows;
          for (int s = 0; s < steps; ++s) {
            const uint32_t a =
                feat + (p * kWgPoints * cp + s * kStepRows * kWgPoints) * 2;
            const uint64_t da = smem_desc(a, kKGroupBytes, 128);
            wgmma_128_ss(acc, da, ring.take(leader), scale);
            scale = 1;
          }
        }
      }
      ring.layer_end(ln == nl - 1, leader);
      if (br == rel_br && ln == rel_ln && lane == 0) mbar_arrive(release);
      // epilogue: act = bf16(relu(acc + bias)); acc[4j + e] is row
      // lane / 4 (+8 for e >= 2), col 8j + 2 (lane % 4) + (e & 1)
      const float* bias = D.b + li * kWidth + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kWidth / 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
        act[2 * j] = pack_bf16(fmaxf(__fadd_rn(acc[4 * j], bb.x), 0.0f),
                               fmaxf(__fadd_rn(acc[4 * j + 1], bb.y), 0.0f));
        act[2 * j + 1] =
            pack_bf16(fmaxf(__fadd_rn(acc[4 * j + 2], bb.x), 0.0f),
                      fmaxf(__fadd_rn(acc[4 * j + 3], bb.y), 0.0f));
      }
      ++li;
    }
    // the branch's head: fc_alpha after the density branch, fc_rgb after
    // the rgb branch (B at heads + head * 4 KB, 512 B a K step)
    const uint32_t hb = heads + (is_rgb ? 0 : kHeadBytes / 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWidth / kStepRows; ++kk) {
      const uint64_t db = smem_desc(hb + kk * kHeadStepBytes, 2 * 128, 128);
      if (is_rgb)
        wgmma_16_rs(rgb, act + 4 * kk, db, kk > 0);
      else
        wgmma_16_rs(sig, act + 4 * kk, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  // col c of the head is in lane 4 * row + c / 2: sigma (col 3) and blue
  // (col 2) come from the next lane
  const float s_lo = __shfl_down_sync(0xffffffffu, sig[1], 1);
  const float s_hi = __shfl_down_sync(0xffffffffu, sig[3], 1);
  const float b_lo = __shfl_down_sync(0xffffffffu, rgb[0], 1);
  const float b_hi = __shfl_down_sync(0xffffffffu, rgb[2], 1);
  HeadOut o;
  if (kSigmaOnly) {
    o.lo = make_float4(D.bh[0], D.bh[1], D.bh[2], __fadd_rn(s_lo, D.bh[3]));
    o.hi = make_float4(D.bh[0], D.bh[1], D.bh[2], __fadd_rn(s_hi, D.bh[3]));
  } else {
    o.lo = make_float4(__fadd_rn(rgb[0], D.bh[0]), __fadd_rn(rgb[1], D.bh[1]),
                       __fadd_rn(b_lo, D.bh[2]), __fadd_rn(s_lo, D.bh[3]));
    o.hi = make_float4(__fadd_rn(rgb[2], D.bh[0]), __fadd_rn(rgb[3], D.bh[1]),
                       __fadd_rn(b_hi, D.bh[2]), __fadd_rn(s_hi, D.bh[3]));
  }
  return o;
}

// the first point of this block's share k: tile blockIdx.x + (k / 2) *
// gridDim.x, half k % 2
__device__ inline long long share_base(long long k) {
  return (blockIdx.x + (k / kConsumers) * gridDim.x) * kTilePoints +
         (k % kConsumers) * kWgPoints;
}

// The persistent kernel body. Job gives the points' features and takes
// their outputs:
//   job.gather(gt, base, parts, scratch): the kGatherThreads gather
//     threads (gt) write the bf16 features of points base .. base + 63
//     (zeros past the end) into `parts`, with `scratch` (the layout's tap
//     scratch) for their own use; it may sync them with
//     named_sync(kGatherBar, kGatherThreads);
//   job.store(n, o): (r, g, b, sigma) of point n < N.
template <bool kSigmaOnly, class Job>
__device__ inline void run_decoder(const Job& job, const Decoder& D,
                                   const Layout& L, long long N,
                                   unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + L.bars, empty = full + 8 * kRing;
  const uint32_t ffull = empty + 8 * kRing, fempty = ffull + 8 * kStages;
  const long long tiles = (N + kTilePoints - 1) / kTilePoints;
  const long long my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long shares = kConsumers * my_tiles;
  const int slices = D.d_slices + (kSigmaOnly ? 0 : D.r_slices);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ffull + 8 * s, kGatherThreads);
      mbar_init(fempty + 8 * s, kWgThreads / 32);
    }
    mbar_init_fence();
  }
  // the heads, already in the B layout, stay resident
  for (int i = tid; i < kHeadBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem + L.heads)[i] =
        __ldg(reinterpret_cast<const uint4*>(D.whs) + i);
  fence_async_smem();
  __syncthreads();

  if (warp < kProducerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kWeightWarp) {
      // the weights: the stream's slices, once per tile, into the ring
      if (lane == 0) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(D.ws);
        int slot = 0;
        uint32_t phase = 0;
        for (long long t = 0; t < my_tiles; ++t) {
          for (int i = 0; i < slices; ++i) {
            mbar_wait(empty + 8 * slot, phase ^ 1u);
            mbar_arrive_expect_tx(full + 8 * slot, kSliceBytes);
            bulk_load(sbase + L.ring + slot * kSliceBytes,
                      src + (size_t)i * kSliceBytes, kSliceBytes,
                      full + 8 * slot);
            if (++slot == kRing) {
              slot = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else {
      // the gather: every share in order into the stage ring
      unsigned char* scratch = smem + L.scratch;
      int stage = 0;
      uint32_t phase = 0;
      for (long long k = 0; k < shares; ++k) {
        mbar_wait(fempty + 8 * stage, phase ^ 1u);
        job.gather(tid, share_base(k),
                   make_parts(smem + L.feat + stage * L.feat_bytes, L.cp),
                   scratch);
        // the stage's writes, visible to the consumers' wgmma
        fence_async_smem();
        mbar_arrive(ffull + 8 * stage);
        // every gather thread is done with the scratch before the next
        // share's taps overwrite it
        named_sync(kGatherBar, kGatherThreads);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = (warp - kProducerWarps) >> 2;
    const int wt = tid & (kWgThreads - 1);
    Ring ring = {sbase + L.ring, full, empty, 0, 0, 0, 0, 0u, false};
    const bool leader = wt == 0;
    for (long long k = wg; k < shares; k += kConsumers) {
      const int stage = (int)(k % kStages);
      const long long base = share_base(k);
      mbar_wait(ffull + 8 * stage, (uint32_t)((k / kStages) & 1));
      const HeadOut o = decode<kSigmaOnly>(
          D, sbase + L.feat + stage * L.feat_bytes, L.cp, L.cvp,
          sbase + L.heads, ring, leader, lane, fempty + 8 * stage);
      if ((lane & 3) == 0) {
        const long long n = base + (warp & 3) * 16 + (lane >> 2);
        if (n < N) job.store(n, o.lo);
        if (n + 8 < N) job.store(n + 8, o.hi);
      }
    }
  }
}

// Launch `kernel` (a __global__ taking (params, layout)) persistently:
// min(SMs, tiles) blocks of kThreads with the layout's dynamic shared
// memory. Returns a cudaError_t.
template <class Kernel, class Params>
inline int launch_persistent(Kernel kernel, const Params& p, const Layout& L,
                             long long N, cudaStream_t stream) {
  const long long tiles = (N + kTilePoints - 1) / kTilePoints;
  if (tiles == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, L.total, stream>>>(p, L);
  return (int)cudaGetLastError();
}

}  // namespace nvsr
