// Row gather out[n] = table[idx[n]], for Hopper (sm_90a).
//
// Replaces the TPU kernel nvsr_tpu/ops/pallas/gather_dma.py:29 (_kernel,
// launched by gather_rows_dma :56); host side and plain PyTorch version in
// nvsr_tpu_torch/ops/gather_dma.py, binding in nvsr_tpu_torch/kernels.py.
//
// What it computes: for an f32 table [HW, C] and int32 indices [N], the
// rows table[idx] -> [N, C]. The TPU kernel fetches whole 1024-float groups
// by DMA and selects the row with a one-hot contraction outside the kernel,
// because Mosaic cannot fetch a sub-tile slice; none of that is carried
// over. Here one thread copies one float4 of the output: a 16-byte load of
// table[idx[n], c:c+4] and a 16-byte store when C is a multiple of 4, four
// scalar copies otherwise (C of 1 or 2, where a float4 of the output spans
// rows). An index outside [0, HW) fails a device-side assert, as
// torch.index_select's does: the launch then reports an error on the next
// synchronizing call and the CUDA context is lost.
//
// What bounds it on the H100: bytes. Each output float is read once from
// the table and written once (plus 4 bytes of index per row), at 3.35
// TB/s; the simple design reads each index once per float4 it serves (from
// L1) and leaves the loads to the memory system, with no staging.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx, int HW, int C, long long n4,
                   float* __restrict__ out) {
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n4;
       t += (long long)gridDim.x * kThreads) {
    const long long e = t * 4;
    if (kVec) {
      const long long row = e / C, c = e % C;
      const int r = __ldg(idx + row);
      assert(r >= 0 && r < HW);
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(table + (long long)r * C + c));
      *reinterpret_cast<float4*>(out + e) = v;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long row = (e + k) / C, c = (e + k) % C;
        const int r = __ldg(idx + row);
        assert(r >= 0 && r < HW);
        out[e + k] = __ldg(table + (long long)r * C + c);
      }
    }
  }
}

}  // namespace

// C interface (ctypes). Returns a cudaError_t: 0 when the launch was
// accepted. table [HW, C] f32, idx [N] int32 in [0, HW), out [N, C] f32,
// N * C a multiple of 4.
extern "C" int gather_rows(const float* table, int HW, int C, const int* idx,
                           int N, float* out, void* stream) {
  const long long n4 = (long long)N * C / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1LL << 20) ? want : (1LL << 20));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (C % 4 == 0)
      gather_rows_kernel<true><<<blocks, kThreads, 0, s>>>(table, idx, HW, C,
                                                           n4, out);
    else
      gather_rows_kernel<false><<<blocks, kThreads, 0, s>>>(table, idx, HW, C,
                                                            n4, out);
  }
  return (int)cudaGetLastError();
}
