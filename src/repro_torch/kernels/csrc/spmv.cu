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
// Matrix engine: DMMA m8n8k4 on A converted to double.  A is an 8x4 slice
// of the block (lane (g, t) takes row g, columns 4(t + 4u) + e at k-step
// (u, e)); B holds the four matching x values in column 0 and zeros in
// columns 1-7.  That is the paper's DASP point, kept on purpose: x fills one
// of B's 8 columns, so 1/8 of each MMA's output is useful work.  Each
// block's product is accumulated in double over its 32 k-steps (four
// independent chains), rounded to float32, and added to the warp's float32
// sum, as the reference adds one float32 dot per block.  The products are
// exact and the double sums round far below float32, so the result is the
// plain version's (spmv_plain, a float64 dot per block).
//   Why FP64 and not 3xTF32: DMMA keeps the plain version bit-for-bit in
// reach and its numerics unchanged; what held the first design back was
// not the DMMAs (32 per block, ~64 SM clocks) but the 64 float-to-double
// conversions per lane and block (x's included, zero on 28 of 32 lanes),
// at 16 per clock per SM, and loads that waited in the lane's chain.  Here
// x is converted once per call into a double copy (spmv_x_to_double, 128
// KiB for the bench matrix, served from L2) and B reads it from shared
// memory, or a zero pair on the lanes g != 0: only A's 32 conversions per
// lane and block remain.  Each warp streams its blocks through a ring of
// kStages stages in shared memory with cp.async (the 4 KiB block and its
// 1 KiB of double x), two blocks ahead of the one it multiplies, so the
// conversions and MMAs of one block overlap the loads of the next two.
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

// One staged block of the matrix kernel: A's 8x128 floats (row r's 16-byte
// chunk q at r * 32 + (q ^ 4(r & 1)), so that the 8 lanes of an LDS.128
// phase, rows 2p and 2p+1 and chunks t + 4u, hit 8 different bank groups)
// and the block's 128 x values as double.
struct Stage {
  float4 a[kBm * kBn / 4];
  double2 x[kBn / 2];
};
constexpr int kStages = 3;  // blocks in a warp's ring: two in flight ahead

__device__ __forceinline__ int swizzle(int r, int q) {
  return r * (kBn / 4) + (q ^ ((r & 1) << 2));
}

// cp.async of one block and its x span into a stage: lane l copies chunk l
// of every row and chunks l, l + 32 of x.
__device__ __forceinline__ void stage_block(Stage& st, const float4* a,
                                            const double2* x, int lane) {
#pragma unroll
  for (int r = 0; r < kBm; ++r)
    cp_async16(&st.a[swizzle(r, lane)], a + r * (kBn / 4) + lane);
  cp_async16(&st.x[lane], x + lane);
  cp_async16(&st.x[lane + 32], x + lane + 32);
}

__global__ void spmv_x_to_double(const float* __restrict__ x,
                                 double* __restrict__ xd, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    xd[i] = static_cast<double>(x[i]);
}

__global__ void __launch_bounds__(kWarps * 32)
    spmv_matrix_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ cols,
                       const double* __restrict__ xd, float* __restrict__ y,
                       int mb, int ncb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float partial[kWarps][kBm];
  __shared__ __align__(16) double2 zero_x[2];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  Stage* ring = reinterpret_cast<Stage*>(smem) + warp * kStages;
  if (threadIdx.x < 2) zero_x[threadIdx.x] = make_double2(0.0, 0.0);
  __syncthreads();
  const float4* blk = reinterpret_cast<const float4*>(blocks) +
                      static_cast<size_t>(row) * mb * kBm * (kBn / 4);
  const double2* x2 = reinterpret_cast<const double2*>(xd);
  const int* col = cols + static_cast<size_t>(row) * mb;
  // this warp's slots: warp, warp + kWarps, ...
  const int n = warp < mb ? (mb - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int i) {
    const int j = warp + kWarps * i;
    const int c = __ldg(col + j);
    const int cc = c >= 0 && c < ncb ? c : 0;
    stage_block(ring[i % kStages], blk + static_cast<size_t>(j) * kBm *
                (kBn / 4), x2 + static_cast<size_t>(cc) * (kBn / 2), lane);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  float acc = 0.f;  // row g's sum over this warp's slots, in lanes t == 0
  // the loop bound is uniform across the warp, as mma.sync needs
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of block i landed
    __syncwarp();                  // and every other lane's
    const Stage& st = ring[i % kStages];
    // an out-of-range id (uniform across the warp) contributes nothing:
    // B reads the zero pair, as do the lanes g != 0, whose B columns are 0
    const int c = __ldg(col + warp + kWarps * i);
    const bool use = g == 0 && c >= 0 && c < ncb;
    const double2* xs = use ? st.x : zero_x;
    const int xm = use ? ~0 : 0;
    // four independent accumulator chains, one per float4 component; k-step
    // (u, e) covers columns 4(t + 4u) + e
    double d[4][2] = {{0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = t + 4 * u;
      const float4 a = st.a[swizzle(g, q)];
      const double2 x0 = xs[(2 * q) & xm], x1 = xs[(2 * q + 1) & xm];
      dmma_884(d[0][0], d[0][1], a.x, x0.x, d[0][0], d[0][1]);
      dmma_884(d[1][0], d[1][1], a.y, x0.y, d[1][0], d[1][1]);
      dmma_884(d[2][0], d[2][1], a.z, x1.x, d[2][0], d[2][1]);
      dmma_884(d[3][0], d[3][1], a.w, x1.y, d[3][0], d[3][1]);
    }
    acc = __fadd_rn(acc, __double2float_rn((d[0][0] + d[1][0]) +
                                           (d[2][0] + d[3][0])));
    __syncwarp();  // the stage is refilled two iterations on
  }
  if (t == 0) partial[warp][g] = acc;
  combine_and_store(partial, y, row);
}

}  // namespace

REPRO_ERROR_STRING(spmv)

// y[nbr][8] = blocks (x) x for 8x128 block-ELL.  The matrix kernel takes
// xd, scratch for ncb * 128 doubles, and first fills it with x converted to
// double.  Returns the cudaError_t.
extern "C" int spmv_launch(const float* blocks, const int* cols,
                           const float* x, double* xd, float* y, int nbr,
                           int mb, int ncb, int matrix, void* stream) {
  if (nbr < 0 || mb < 0 || ncb <= 0 || (matrix && xd == nullptr))
    return cudaErrorInvalidValue;
  if (nbr == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(nbr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (matrix) {
    const int n = ncb * kBn;
    spmv_x_to_double<<<(n + 255) / 256, 256, 0, s>>>(x, xd, n);
    const int smem = kWarps * kStages * static_cast<int>(sizeof(Stage));
    cudaError_t e = cudaFuncSetAttribute(
        spmv_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    spmv_matrix_kernel<<<grid, kWarps * 32, smem, s>>>(blocks, cols, xd, y,
                                                        mb, ncb);
  } else {
    spmv_vector_kernel<<<grid, kWarps * 32, 0, s>>>(blocks, cols, x, y, mb,
                                                     ncb);
  }
  return static_cast<int>(cudaGetLastError());
}
