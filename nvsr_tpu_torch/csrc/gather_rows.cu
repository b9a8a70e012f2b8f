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
// over. An index outside [0, HW) fails a device-side assert, as
// torch.index_select's does: the launch then reports an error on the next
// synchronizing call and the CUDA context is lost.
//
// What bounds it on the H100: bytes. Each distinct row the indices name is
// read once and each output row written once, at 3.35 TB/s; the rows that
// repeat are rarely still in L2 (the table is 13x its size), so in
// practice every gathered row comes from memory. The design is a
// byte-bound copy: when C is a multiple of 4, a group of g lanes (the
// power of two at or above C / 4, at most a warp) takes a row and loads
// its index once; each lane keeps kRows x 2 16-byte loads in flight (two
// rows, two float4 a row at C = 256) before it stores any, and stores with
// __stcs (streaming, evict-first), so the output does not push table rows
// out of L2. The grid covers the rows once (G lane groups, group q takes
// rows q, q + G, ...): an SM-sized persistent grid, with equal runs of
// rows per group or a grid stride, read 2.7-4.6% slower than
// torch.index_select on the H100, this grid as fast (PERF.md).
// Other C (1 or 2, where a float4 of the output spans rows) take a scalar
// copy, one float a thread.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;          // rows of a lane group in flight
constexpr int kMinBlocks = 4;     // blocks a SM the vector copy is built for

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_rows_vec(const float4* __restrict__ table, const int* __restrict__ idx,
                int HW, int v4, int g_log2, long long N,
                float4* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = 1 << g_log2;
  const int groups = 32 >> g_log2;          // lane groups (rows) a warp
  const int li = lane & (g - 1);
  const long long G = (long long)gridDim.x * kWarps * groups;
  const long long q =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * groups +
      (lane >> g_log2);
  long long row[kRows];
  int src[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    row[u] = q + u * G;
    src[u] = 0;
    if (row[u] < N) {
      src[u] = __ldg(idx + row[u]);
      assert(src[u] >= 0 && src[u] < HW);
    }
  }
  for (int c = li; c < v4; c += 2 * g) {
    float4 v[kRows][2];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (row[u] < N && c + k * g < v4)
          v[u][k] = __ldg(table + (long long)src[u] * v4 + c + k * g);
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (row[u] < N && c + k * g < v4)
          __stcs(out + row[u] * v4 + c + k * g, v[u][k]);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_scalar(const float* __restrict__ table,
                   const int* __restrict__ idx, int HW, int C, long long n,
                   float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long row = e / C, c = e % C;
    const int r = __ldg(idx + row);
    assert(r >= 0 && r < HW);
    out[e] = __ldg(table + (long long)r * C + c);
  }
}

}  // namespace

// C interface (ctypes). Returns a cudaError_t: 0 when the launch was
// accepted. table [HW, C] f32, idx [N] int32 in [0, HW), out [N, C] f32,
// N * C a multiple of 4.
extern "C" int gather_rows(const float* table, int HW, int C, const int* idx,
                           int N, float* out, void* stream) {
  if (N == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0) {
    const int v4 = C / 4;
    int g_log2 = 0;
    while ((1 << g_log2) < v4 && g_log2 < 5) ++g_log2;
    const long long per_block = (long long)kWarps * (32 >> g_log2) * kRows;
    gather_rows_vec<<<(unsigned)((N + per_block - 1) / per_block), kThreads,
                      0, s>>>(reinterpret_cast<const float4*>(table), idx,
                              HW, v4, g_log2, N,
                              reinterpret_cast<float4*>(out));
  } else {
    const long long n = (long long)N * C;
    const long long want = (n + kThreads - 1) / kThreads;
    gather_rows_scalar<<<(unsigned)(want < (1LL << 20) ? want : (1LL << 20)),
                         kThreads, 0, s>>>(table, idx, HW, C, n, out);
  }
  return (int)cudaGetLastError();
}
