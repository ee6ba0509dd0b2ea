// Grouped SwiGLU over the rows routed to each held expert of an expert
// share (DeepSeek-V2's MoE layer in decode), float32 on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package multiplies every expert's
// capacity buffer with einsums (GShard), full or empty.  An expert share
// at decode batch sees ~2.4 rows an expert a step, so that path would read
// each expert's 94 MB of weights for a few rows, or multiply empty
// buffers; this kernel reads a held expert's weights only if rows were
// routed to it, and multiplies only those rows.
//
// Layout: xs[P][D] holds the routed rows sorted by held expert, expert e's
// rows at offsets[e] .. offsets[e + 1] - 1 (offsets on the card: the host
// never learns the counts, so nothing waits for the card).  Rows past
// offsets[n] are neither read nor written.  w_gate, w_up[n][D][F],
// w_down[n][F][D], as x @ W takes them.  h[P][F] is scratch, y[P][D] out:
//   h = silu(xs W_gate[e]) * (xs W_up[e]);   y = h W_down[e].
//
// Bound: bytes.  Each touched expert's three matrices are read once
// (3 D F floats) for a few rows, a multiply-add per weight and row.  A
// block owns one expert and kCols output columns, one a thread; it stages
// up to kRows of its expert's rows, kChunk inputs at a time, in shared
// memory and streams the weight rows through registers (neighbouring
// threads on neighbouring columns), kRows sums a thread.  An expert with no
// row returns at once; one with more than kRows rows takes its rows kRows
// at a time and reads its weights again for each pass (rare at decode).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kCols = 128;   // threads a block, one output column each
constexpr int kRows = 8;     // rows a pass
constexpr int kChunk = 128;  // inputs staged a step

__device__ __forceinline__ void stage(float (&xt)[kRows][kChunk],
                                      const float* __restrict__ x, int base,
                                      int nr, int k0, int K) {
  for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
    const int r = i / kChunk, c = i % kChunk;
    xt[r][c] = (r < nr && k0 + c < K)
                   ? x[static_cast<size_t>(base + r) * K + k0 + c]
                   : 0.f;
  }
}

// h[rows of e][col] = silu(x W_gate[e]) * (x W_up[e]), K = D, N = F.
__global__ void experts_gate_up_kernel(const float* __restrict__ xs,
                                       const int* __restrict__ offsets,
                                       const float* __restrict__ wg,
                                       const float* __restrict__ wu,
                                       float* __restrict__ h, int K, int N) {
  const int e = blockIdx.y;
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int r0 = offsets[e], r1 = offsets[e + 1];
  if (r1 <= r0) return;  // untouched: its weights are not read
  __shared__ float xt[kRows][kChunk];
  const float* g = wg + static_cast<size_t>(e) * K * N;
  const float* u = wu + static_cast<size_t>(e) * K * N;
  for (int base = r0; base < r1; base += kRows) {
    const int nr = min(kRows, r1 - base);
    float ag[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ag[r] = au[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();
      stage(xt, xs, base, nr, k0, K);
      __syncthreads();
      if (col < N) {
        const int kn = min(kChunk, K - k0);
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          const size_t w = static_cast<size_t>(k0 + kk) * N + col;
          const float vg = g[w], vu = u[w];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ag[r] = fmaf(xt[r][kk], vg, ag[r]);
            au[r] = fmaf(xt[r][kk], vu, au[r]);
          }
        }
      }
    }
    if (col < N) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const float a = ag[r];
          h[static_cast<size_t>(base + r) * N + col] =
              a / (1.f + expf(-a)) * au[r];
        }
      }
    }
  }
}

// y[rows of e][col] = h W_down[e], K = F, N = D.
__global__ void experts_down_kernel(const float* __restrict__ h,
                                    const int* __restrict__ offsets,
                                    const float* __restrict__ wd,
                                    float* __restrict__ y, int K, int N) {
  const int e = blockIdx.y;
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int r0 = offsets[e], r1 = offsets[e + 1];
  if (r1 <= r0) return;
  __shared__ float xt[kRows][kChunk];
  const float* d = wd + static_cast<size_t>(e) * K * N;
  for (int base = r0; base < r1; base += kRows) {
    const int nr = min(kRows, r1 - base);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();
      stage(xt, h, base, nr, k0, K);
      __syncthreads();
      if (col < N) {
        const int kn = min(kChunk, K - k0);
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          const float v = d[static_cast<size_t>(k0 + kk) * N + col];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xt[r][kk], v, acc[r]);
        }
      }
    }
    if (col < N) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) y[static_cast<size_t>(base + r) * N + col] = acc[r];
    }
  }
}

}  // namespace

REPRO_ERROR_STRING(experts)

// The two kernels over n held experts; returns the cudaError_t.
extern "C" int experts_launch(const float* xs, const int* offsets,
                              const float* wg, const float* wu,
                              const float* wd, float* h, float* y, int n,
                              int d, int f, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g1((f + kCols - 1) / kCols, n), g2((d + kCols - 1) / kCols, n);
  experts_gate_up_kernel<<<g1, kCols, 0, s>>>(xs, offsets, wg, wu, h, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  experts_down_kernel<<<g2, kCols, 0, s>>>(h, offsets, wd, y, f, d);
  return static_cast<int>(cudaGetLastError());
}
