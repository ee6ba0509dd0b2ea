// Block-ELL SpMV y = A x on Hopper, one kernel per engine (paper §3.2,
// §5.2).
//
// Replaces the TPU kernel src/repro/kernels/spmv/spmv.py::bell_spmv
// (_spmv_vpu_kernel / _spmv_mxu_kernel).  A is stored as
// blocks[nbr][mb][8][128] float32 with block-column ids cols[nbr][mb];
// spare slots are zero blocks at column 0, so repeated column ids simply
// accumulate.  Output y[nbr][8].
//
// Bound: bytes.  Every stored block is read once (4 KiB, 2048 useful
// flops), so the floor is the stored blocks plus the ids, x and y over the
// HBM rate.  The TPU walked the slots as a sequential grid axis carrying
// the output block in VMEM; here one CTA owns one block row, its four warps
// each walk every fourth slot keeping their sums in registers, and the four
// partials are added in shared memory once at the end, so no two CTAs touch
// the same output and enough warps are in flight to cover HBM latency.
//
// Vector engine: lane l covers columns 4l..4l+3 of every block with
// 16-byte loads, keeps 8 row partials across its warp's slots, and reduces
// them across the warp with shuffles once at the end.
// Matrix engine: DMMA m8n8k4 on values converted to double.  A is an 8x4
// slice of the block (lane (g, t) takes row g, columns 32t + s for k-step
// s, so its loads are 16-byte and contiguous); B holds the four matching x
// values in column 0 and zeros in columns 1-7.  That is the paper's
// 1/8-utilisation DASP point, kept on purpose.  Each block's product is
// accumulated in double over its 32 k-steps (four independent chains),
// rounded to float32, and added to the warp's float32 sum, as the reference
// adds one float32 dot per block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block row, each taking every 4th slot
constexpr int kBm = 8, kBn = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pick(const float (&v)[kBm], int r) {
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < kBm; ++i) out = (i == r) ? v[i] : out;
  return out;
}

// y[row][r] = sum over the warps' partials, in warp order.
__device__ __forceinline__ void combine_and_store(float (&part)[kWarps][kBm],
                                                  float* y, int row) {
  __syncthreads();
  if (threadIdx.x < kBm) {
    float sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[w][threadIdx.x]);
    y[static_cast<size_t>(row) * kBm + threadIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    spmv_vector_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ cols,
                       const float* __restrict__ x, float* __restrict__ y,
                       int mb, int ncb) {
  __shared__ float partial[kWarps][kBm];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* blk = reinterpret_cast<const float4*>(blocks) +
                      static_cast<size_t>(row) * mb * kBm * (kBn / 4);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float part[kBm];
#pragma unroll
  for (int r = 0; r < kBm; ++r) part[r] = 0.f;
#pragma unroll 2
  for (int j = warp; j < mb; j += kWarps) {
    // an out-of-range id reads column 0 and contributes nothing
    const int c = __ldg(cols + static_cast<size_t>(row) * mb + j);
    const bool ok = c >= 0 && c < ncb;
    float4 xv = __ldg(x4 + static_cast<size_t>(ok ? c : 0) * (kBn / 4) + lane);
    if (!ok) xv = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* b = blk + static_cast<size_t>(j) * kBm * (kBn / 4);
#pragma unroll
    for (int r = 0; r < kBm; ++r) {
      const float4 a = __ldg(b + r * (kBn / 4) + lane);
      part[r] = fmaf(a.x, xv.x, part[r]);
      part[r] = fmaf(a.y, xv.y, part[r]);
      part[r] = fmaf(a.z, xv.z, part[r]);
      part[r] = fmaf(a.w, xv.w, part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kBm; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[r] += __shfl_xor_sync(kFull, part[r], off);
  }
  if (lane < kBm) partial[warp][lane] = pick(part, lane);
  combine_and_store(partial, y, row);
}

__global__ void __launch_bounds__(kWarps * 32)
    spmv_matrix_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ cols,
                       const float* __restrict__ x, float* __restrict__ y,
                       int mb, int ncb) {
  __shared__ float partial[kWarps][kBm];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float4* blk = reinterpret_cast<const float4*>(blocks) +
                      static_cast<size_t>(row) * mb * kBm * (kBn / 4);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc = 0.f;  // row g's sum over this warp's slots, in lanes t == 0
  // the loop bound is uniform across the warp, as mma.sync needs
#pragma unroll 2
  for (int j = warp; j < mb; j += kWarps) {
    // an out-of-range id (uniform across the warp) contributes nothing
    const int c = __ldg(cols + static_cast<size_t>(row) * mb + j);
    const bool ok = c >= 0 && c < ncb;
    // row g, columns 32t .. 32t+31 of this block
    const float4* a4 = blk + static_cast<size_t>(j) * kBm * (kBn / 4) +
                       g * (kBn / 4) + t * 8;
    const float4* xs = x4 + static_cast<size_t>(ok ? c : 0) * (kBn / 4) + t * 8;
    // four independent accumulator chains, one per float4 component
    double d[4][2] = {{0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 a = __ldg(a4 + u);
      const float4 xv = (g == 0 && ok) ? __ldg(xs + u)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      dmma_884(d[0][0], d[0][1], a.x, xv.x, d[0][0], d[0][1]);
      dmma_884(d[1][0], d[1][1], a.y, xv.y, d[1][0], d[1][1]);
      dmma_884(d[2][0], d[2][1], a.z, xv.z, d[2][0], d[2][1]);
      dmma_884(d[3][0], d[3][1], a.w, xv.w, d[3][0], d[3][1]);
    }
    acc = __fadd_rn(acc, __double2float_rn((d[0][0] + d[1][0]) +
                                           (d[2][0] + d[3][0])));
  }
  if (t == 0) partial[warp][g] = acc;
  combine_and_store(partial, y, row);
}

}  // namespace

REPRO_ERROR_STRING(spmv)

// y[nbr][8] = blocks (x) x for 8x128 block-ELL.  Returns the cudaError_t.
extern "C" int spmv_launch(const float* blocks, const int* cols,
                           const float* x, float* y, int nbr, int mb, int ncb,
                           int matrix, void* stream) {
  if (nbr < 0 || mb < 0 || ncb <= 0) return cudaErrorInvalidValue;
  if (nbr == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(nbr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (matrix)
    spmv_matrix_kernel<<<grid, kWarps * 32, 0, s>>>(blocks, cols, x, y, mb,
                                                     ncb);
  else
    spmv_vector_kernel<<<grid, kWarps * 32, 0, s>>>(blocks, cols, x, y, mb,
                                                     ncb);
  return static_cast<int>(cudaGetLastError());
}
