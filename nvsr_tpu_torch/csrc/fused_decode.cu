// The triplane decoder on tap-pair rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel nvsr_tpu/ops/pallas/fused_decoder.py:220
// (_kernel, launched by fused_decode :231); host side and plain PyTorch
// version in nvsr_tpu_torch/ops/fused_decoder.py, binding in
// nvsr_tpu_torch/kernels.py.
//
// What it computes, per point n of N: for each plane p the bf16 vertical
// tap pair rows[p * N + n] ([3N, 128], plane-major: the top tap's channels
// in lanes 0:64, the bottom tap's in 64:128) is y-lerped in f32 as
// top * (1 - ty) + bot * ty (fused_decoder.py:213-217, lerp_pair), over
// the first cp channels only (the packed weights' pad rows are zero, so
// the rest cannot count); comb = (f0 + f1 + f2) [/ 3] in f32; then the
// decoder of decoder.cuh (full decode) with the f32 view row [N, 64]
// rounded to bf16 at the first matmul, as decode_body does. out[n, 0:3] =
// rgb, out[n, 3] = sigma, out[n, 4:8] = 0 ([N, 8], the TPU kernel's
// OUT_LANES). All f32 steps before the decoder use _rn intrinsics: the
// features equal the plain version's bit for bit.
//
// What bounds it on the H100: per point it reads 3 x 256 B of tap pairs,
// 12 B of ty and 256 B of f32 view and writes 32 B (~1 KB), against the
// decoder's ~0.26 MFLOP: at 3.35 TB/s and 989 TFLOP/s bf16 the bytes are
// the larger bound counted per byte of the rows, but the kernel reads only
// the cp lanes of each half, so the decoder's operations bound it. The
// design is decoder.cuh's persistent kernel: for each 64-point share the
// gather warps, one thread per (point, 8 channels), load each plane's two
// 16-byte halves, lerp and write the bf16 features in the wgmma A layout
// into a feature stage in shared memory, while the consumer warpgroups
// decode the shares gathered before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder.cuh"

namespace {

using namespace nvsr;

constexpr int kHalf = 64;                   // channels per tap in a row
constexpr int kOutLanes = 8;

struct Params {
  const bf16* rows; const float* ty; const float* view; int N, cp, cvp;
  Decoder dec;
  int avg;
  float* out;
};

// the features of a share's 64 points (decoder.cuh's Job)
struct Lerp {
  const Params& P;              // the kernel's __grid_constant__ parameter
  long long N;

  __device__ void store(long long n, float4 o) const {
    float4* dst = reinterpret_cast<float4*>(P.out + n * kOutLanes);
    dst[0] = o;
    dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  __device__ void gather(int gt, long long base, const Parts& parts,
                         unsigned char*) const {
    // y-lerped features of 8 channels of one point per item
    const int chunks = P.cp / 8;
    for (int item = gt; item < kWgPoints * chunks; item += kGatherThreads) {
      const int i = item / chunks, c8 = (item % chunks) * 8;
      const long long n = base + i;
      float comb[8];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        uint4 q[2] = {make_uint4(0u, 0u, 0u, 0u),
                      make_uint4(0u, 0u, 0u, 0u)};
        float ty = 0.0f;
        if (n < N) {
          const bf16* row = P.rows + ((size_t)pl * N + n) * (2 * kHalf);
          q[0] = __ldg(reinterpret_cast<const uint4*>(row + c8));
          q[1] = __ldg(reinterpret_cast<const uint4*>(row + kHalf + c8));
          ty = __ldg(P.ty + pl * N + n);
        }
        const bf16* v = reinterpret_cast<const bf16*>(q);  // top, bottom
        __align__(16) bf16 fo[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = __fadd_rn(
              __fmul_rn(__bfloat162float(v[e]), __fsub_rn(1.0f, ty)),
              __fmul_rn(__bfloat162float(v[8 + e]), ty));
          comb[e] = pl == 0 ? f : __fadd_rn(comb[e], f);
          fo[e] = __float2bfloat16_rn(f);
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
    // the f32 view row, rounded to bf16
    const int vch = P.cvp / 8;
    for (int item = gt; item < kWgPoints * vch; item += kGatherThreads) {
      const int i = item / vch, c8 = (item % vch) * 8;
      const long long n = base + i;
      __align__(16) bf16 vo[8];
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
      if (n < N) {
        const float4* src =
            reinterpret_cast<const float4*>(P.view + n * kHalf + c8);
        a = __ldg(src);
        b = __ldg(src + 1);
      }
      vo[0] = __float2bfloat16_rn(a.x); vo[1] = __float2bfloat16_rn(a.y);
      vo[2] = __float2bfloat16_rn(a.z); vo[3] = __float2bfloat16_rn(a.w);
      vo[4] = __float2bfloat16_rn(b.x); vo[5] = __float2bfloat16_rn(b.y);
      vo[6] = __float2bfloat16_rn(b.z); vo[7] = __float2bfloat16_rn(b.w);
      put8(parts.p[4], i, c8, *reinterpret_cast<const uint4*>(vo));
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const __grid_constant__ Params P,
                    const __grid_constant__ Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Lerp job{P, (long long)P.N};
  run_decoder<false>(job, P.dec, L, job.N, smem);
}

}  // namespace

// C interface (ctypes). Returns a cudaError_t: 0 when the launch was
// accepted. rows [3N, 128] bf16, ty [3N] f32, view [N, 64] f32, out
// [N, 8] f32; w, b, wh, bh: the packed decoder (PackedDecoder.ws, b,
// whs, bh).
extern "C" int fused_decode(const void* rows, const float* ty,
                            const float* view, int N, int cp, int cvp,
                            const void* w, const float* b, const void* wh,
                            const float* bh, int n_density, int n_rgb,
                            int skip_every, int avg, float* out,
                            void* stream) {
  Params p;
  p.rows = static_cast<const bf16*>(rows); p.ty = ty; p.view = view;
  p.N = N; p.cp = cp; p.cvp = cvp;
  p.dec.ws = static_cast<const bf16*>(w); p.dec.b = b;
  p.dec.whs = static_cast<const bf16*>(wh); p.dec.bh = bh;
  p.dec.n_density = n_density; p.dec.n_rgb = n_rgb;
  p.dec.skip_every = skip_every;
  p.avg = avg; p.out = out;
  set_slices(p.dec, cp, cvp);
  return launch_persistent(fused_decode_kernel, p,
                           make_layout(cp, cvp, 0, 0), N,
                           static_cast<cudaStream_t>(stream));
}
