// Temporally blocked Table-3 stencils on Hopper, one kernel per engine
// (paper §3.3, §5.3).
//
// Replaces the TPU kernel src/repro/kernels/stencil/stencil.py::
// stencil_apply (_stencil_kernel with _vpu_step / _mxu_step).  Computes
// `steps` zero-boundary steps of a 2-D or 3-D stencil of radius r <= 3 over
// float32 u, fused in one pass over device memory.
//
// Bound: bytes.  The ideal pass reads u once and writes the result once
// (2 * 4 bytes per point); the arithmetic is t * 2|S| flops per point,
// below the float32 balance for the Table-3 depths.  The TPU kept whole
// padded rows of a leading-axis block in its on-chip VMEM; an SM has at
// most 227 KB of shared memory, so here the trailing axes are tiled too.
//
// Grid: one CTA per (leading-axis block of block_rows) x (trailing-axis
// tile).  The CTA walks its leading block in sub-tiles.  For each sub-tile
// it
//   1. loads the tile plus a halo of h = t*r on every axis into shared
//      memory with cp.async, zeros outside the domain;
//   2. runs t steps in shared memory between two buffers, each step on a
//      region that shrinks by r per side, separated by __syncthreads(),
//      zeroing every point outside the domain after each step (the
//      reference's _domain_mask);
//   3. writes the centre.
// The result is t zero-boundary steps exactly, the reference's trapezoid
// argument.
//
// Vector engine: shifted fused multiply-adds over the spec's offsets in
// the spec's order, as the reference's fused _vpu_step; the offsets (as
// shared-memory strides) and weights sit in __constant__ memory.
// Matrix engine: each step's per-axis passes are banded products on the
// FP64 tensor cores (DMMA m8n8k4, values converted to double), following
// _mxu_step: star = centre * tile + sum of passes, separable box = the
// product of the passes, each pass rounded to float32.  A warp computes an
// 8 lines x 8 positions output tile; it needs the 8 + 2r inputs around the
// positions, ceil((8 + 2r) / 4) k-steps, so only the MMA tiles that meet
// the band are multiplied.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoints = 343;  // 3-D box of radius 3
constexpr int kMaxTaps = 7;      // 2r + 1 for r <= 3
constexpr int kSmemLimit = 200 * 1024;

__constant__ int c_lin[kMaxPoints];   // offset as a shared-memory stride
__constant__ float c_w[kMaxPoints];

struct Params {
  const float* u;
  float* out;
  int N[3];      // domain extents; axis 0 is 1 for 2-D
  int H[3];      // halo per axis (0 on the unused axis)
  int T[3];      // output sub-tile extents
  int L[3];      // buffer extents, T + 2H
  int R[3];      // stencil radius per axis (0 on the unused axis)
  int lead;      // blocked axis: 0 for 3-D, 1 for 2-D
  int block_rows;
  int npts;
  int steps;
  int box;
  float center;
  float axw[3][kMaxTaps];  // per-axis 1-D weights, 2r + 1 used
};

struct Region {
  int lo[3], hi[3];
};

__device__ __forceinline__ int buf_index(const Params& p, int i0, int i1,
                                         int i2) {
  return (i0 * p.L[1] + i1) * p.L[2] + i2;
}

// the valid region after step s: the output tile grown by (t - s) * r
__device__ __forceinline__ Region region_after(const Params& p, int s) {
  Region r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int grow = (p.steps - s) * p.R[a];
    r.lo[a] = p.H[a] - grow;
    r.hi[a] = p.H[a] + p.T[a] + grow;
  }
  return r;
}

__device__ __forceinline__ bool inside(const Params& p, const int (&o)[3],
                                       int i0, int i1, int i2) {
  const int g0 = o[0] - p.H[0] + i0, g1 = o[1] - p.H[1] + i1,
            g2 = o[2] - p.H[2] + i2;
  return g0 >= 0 && g0 < p.N[0] && g1 >= 0 && g1 < p.N[1] && g2 >= 0 &&
         g2 < p.N[2];
}

// 4-byte global -> shared copy that bypasses registers; a source size of
// 0 writes zero instead of reading.
__device__ __forceinline__ void copy_async_or_zero(float* dst,
                                                   const float* src,
                                                   bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Calls f(i0, i1, i2) for every point of `r`, threads taking consecutive
// points.  Each thread divides once to find its first point and then steps
// by the CTA's width with carries, so the loops do no per-point division.
template <typename F>
__device__ __forceinline__ void for_each_point(const Region& r, F&& f) {
  const int e1 = r.hi[1] - r.lo[1], e2 = r.hi[2] - r.lo[2];
  const int n = (r.hi[0] - r.lo[0]) * e1 * e2;
  const int d2 = kThreads % e2, d1 = (kThreads / e2) % e1,
            d0 = kThreads / (e2 * e1);
  int idx = threadIdx.x;
  int i2 = idx % e2, i1 = (idx / e2) % e1, i0 = idx / (e2 * e1);
  for (; idx < n; idx += kThreads) {
    f(r.lo[0] + i0, r.lo[1] + i1, r.lo[2] + i2);
    i2 += d2;
    int carry = i2 >= e2;
    i2 -= carry * e2;
    i1 += d1 + carry;
    carry = i1 >= e1;
    i1 -= carry * e1;
    i0 += d0 + carry;
  }
}

// ---- vector engine: one step of shifted multiply-adds -----------------------

__device__ void vector_step(const Params& p, const int (&o)[3],
                            const float* cur, float* nxt, int s) {
  for_each_point(region_after(p, s), [&](int i0, int i1, int i2) {
    const int at = buf_index(p, i0, i1, i2);
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < p.npts; ++j)
      acc = __fmaf_rn(c_w[j], cur[at + c_lin[j]], acc);
    nxt[at] = inside(p, o, i0, i1, i2) ? acc : 0.f;
  });
}

// ---- matrix engine: one banded pass along `ax` on the tensor cores --------

// dst[q] (op)= sum_d w[d] * src[q + (d - r) e_ax] over region `reg`.
// accumulate: add to dst in float32; mask: zero points outside the domain.
__device__ void banded_pass(const Params& p, const int (&o)[3],
                            const float* src, float* dst, const Region& reg,
                            int ax, bool accumulate, bool mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = p.R[ax];
  const int nk = (8 + 2 * r + 3) / 4;
  const int b = ax == 0 ? 1 : 0, c = ax == 2 ? 1 : 2;  // the other axes
  const int eb = reg.hi[b] - reg.lo[b], ec = reg.hi[c] - reg.lo[c];
  const int eax = reg.hi[ax] - reg.lo[ax];
  const int lines = eb * ec;
  const int gm = (lines + 7) / 8, gn = (eax + 7) / 8;
  const int stride_ax = ax == 0 ? p.L[1] * p.L[2] : (ax == 1 ? p.L[2] : 1);

  double bfrag[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int d = 4 * kk + t - g;
    bfrag[kk] = (kk < nk && d >= 0 && d <= 2 * r)
                    ? static_cast<double>(p.axw[ax][d]) : 0.0;
  }

  for (int item = warp; item < gm * gn; item += kWarps) {
    const int mg = item / gn, ng = item % gn;
    // the line this lane feeds into A (row g of the 8x4 fragment)
    const int m = mg * 8 + g;
    const bool line_ok = m < lines;
    int pos[3];
    pos[b] = reg.lo[b] + (line_ok ? m / ec : 0);
    pos[c] = reg.lo[c] + (line_ok ? m % ec : 0);
    const int x0 = reg.lo[ax] + ng * 8;
    pos[ax] = 0;
    const int line_base = buf_index(p, pos[0], pos[1], pos[2]);
    double d0 = 0.0, d1 = 0.0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
        const int x = x0 - r + 4 * kk + t;
        const double a = (line_ok && x >= 0 && x < p.L[ax])
                             ? static_cast<double>(src[line_base + x * stride_ax])
                             : 0.0;
        dmma_884(d0, d1, a, bfrag[kk], d0, d1);
      }
    }
    // D[g][2t + i]: line m, positions x0 + 2t + i
    if (!line_ok) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = x0 + 2 * t + i;
      if (x >= reg.hi[ax]) continue;
      pos[ax] = x;
      const int at = buf_index(p, pos[0], pos[1], pos[2]);
      float v = __double2float_rn(i == 0 ? d0 : d1);
      if (accumulate) v = __fadd_rn(dst[at], v);
      if (mask && !inside(p, o, pos[0], pos[1], pos[2])) v = 0.f;
      dst[at] = v;
    }
  }
}

// One matrix-engine step; returns the buffer holding its result.
__device__ float* matrix_step(const Params& p, const int (&o)[3], float* cur,
                              float* nxt, int s) {
  const Region out = region_after(p, s);
  const int first = p.lead == 1 ? 1 : 0;  // first real axis
  if (!p.box) {
    for_each_point(out, [&](int i0, int i1, int i2) {
      const int at = buf_index(p, i0, i1, i2);
      nxt[at] = __fmul_rn(p.center, cur[at]);
    });
    for (int ax = first; ax < 3; ++ax) {
      __syncthreads();
      banded_pass(p, o, cur, nxt, out, ax, true, ax == 2);
    }
    return nxt;
  }
  // separable box: pass k keeps the previous step's extent along the axes
  // still to be passed, since those passes read neighbours there
  const Region prev = region_after(p, s - 1);
  float* src = cur;
  float* dst = nxt;
  for (int ax = first; ax < 3; ++ax) {
    Region reg = out;
    for (int a = ax + 1; a < 3; ++a) {
      reg.lo[a] = prev.lo[a];
      reg.hi[a] = prev.hi[a];
    }
    if (ax > first) __syncthreads();
    banded_pass(p, o, src, dst, reg, ax, false, ax == 2);
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

template <bool MMA>
__global__ void __launch_bounds__(kThreads) stencil_kernel(Params p) {
  extern __shared__ float smem[];
  const int vol = p.L[0] * p.L[1] * p.L[2];
  float* buf0 = smem;
  float* buf1 = smem + vol;
  // buf1 is read outside its valid region only by banded_pass, and only
  // where the band weight is zero: it must hold finite values, so clear it
  for (int i = threadIdx.x; i < vol; i += kThreads) buf1[i] = 0.f;

  const int bidx[3] = {static_cast<int>(blockIdx.z),
                       static_cast<int>(blockIdx.y),
                       static_cast<int>(blockIdx.x)};
  int start[3], end[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int span = a == p.lead ? p.block_rows : p.T[a];
    start[a] = bidx[a] * span;
    end[a] = min(start[a] + span, p.N[a]);
  }
  const int L = p.lead;
  for (int sub = start[L]; sub < end[L]; sub += p.T[L]) {
    int o[3] = {start[0], start[1], start[2]};
    o[L] = sub;
    __syncthreads();  // the previous sub-tile's writes are done
    // asynchronous copies, zero-filled outside the domain, all in flight
    // at once: the tile load waits on HBM latency once, not per element
    const Region whole = {{0, 0, 0}, {p.L[0], p.L[1], p.L[2]}};
    for_each_point(whole, [&](int i0, int i1, int i2) {
      const int g0 = o[0] - p.H[0] + i0, g1 = o[1] - p.H[1] + i1,
                g2 = o[2] - p.H[2] + i2;
      const bool ok = g0 >= 0 && g0 < p.N[0] && g1 >= 0 && g1 < p.N[1] &&
                      g2 >= 0 && g2 < p.N[2];
      const float* src =
          ok ? p.u + (static_cast<size_t>(g0) * p.N[1] + g1) * p.N[2] + g2
             : p.u;
      copy_async_or_zero(buf0 + buf_index(p, i0, i1, i2), src, ok);
    });
    copy_async_wait();
    float* cur = buf0;
    float* nxt = buf1;
    for (int s = 1; s <= p.steps; ++s) {
      __syncthreads();
      if (MMA) {
        float* res = matrix_step(p, o, cur, nxt, s);
        if (res == nxt) {
          nxt = cur;
          cur = res;
        }
      } else {
        vector_step(p, o, cur, nxt, s);
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
    __syncthreads();
    for_each_point(region_after(p, p.steps), [&](int i0, int i1, int i2) {
      const int g0 = o[0] + i0 - p.H[0], g1 = o[1] + i1 - p.H[1],
                g2 = o[2] + i2 - p.H[2];
      const int gl = L == 0 ? g0 : g1;
      if (gl < end[L] && g0 < p.N[0] && g1 < p.N[1] && g2 < p.N[2])
        p.out[(static_cast<size_t>(g0) * p.N[1] + g1) * p.N[2] + g2] =
            cur[buf_index(p, i0, i1, i2)];
    });
  }
}

}  // namespace

REPRO_ERROR_STRING(stencil)

// `steps` fused zero-boundary steps of a stencil over u (dims[3], the
// first being 1 for 2-D).  offs: npts x 3 offsets (first column 0 for
// 2-D); w: npts weights; axw: 3 x 7 per-axis 1-D weights (first row unused
// for 2-D).  Returns the cudaError_t.
extern "C" int stencil_launch(const float* u, float* out, const int* dims,
                              int ndim, const int* offs, const float* w,
                              int npts, const float* axw, float center,
                              int radius, int box, int steps, int block_rows,
                              int matrix, void* stream) {
  if ((ndim != 2 && ndim != 3) || radius < 1 || radius > 3 || steps < 1 ||
      steps > 3 || npts < 1 || npts > kMaxPoints || block_rows < 1)
    return cudaErrorInvalidValue;
  const int halo = steps * radius;
  if (halo > block_rows) return cudaErrorInvalidValue;
  Params p;
  p.u = u;
  p.out = out;
  p.lead = 3 - ndim;
  p.block_rows = block_rows;
  p.npts = npts;
  p.steps = steps;
  p.box = box;
  p.center = center;
  for (int a = 0; a < 3; ++a) {
    p.N[a] = dims[a];
    if (p.N[a] <= 0) return cudaSuccess;  // empty domain
    const bool real = a >= p.lead;
    p.R[a] = real ? radius : 0;
    p.H[a] = real ? halo : 0;
    for (int d = 0; d < kMaxTaps; ++d) p.axw[a][d] = axw[a * kMaxTaps + d];
  }
  // output sub-tile: 2-D (1, 32, 128), 3-D (8, 8, 32), shrunk until both
  // buffers fit the shared-memory budget
  int T[3];
  if (ndim == 2) {
    T[0] = 1; T[1] = 32; T[2] = 128;
  } else {
    T[0] = 8; T[1] = 8; T[2] = 32;
  }
  T[p.lead] = min(T[p.lead], block_rows);
  auto bytes = [&]() {
    long long v = 2LL * 4;
    for (int a = 0; a < 3; ++a) v *= T[a] + 2 * p.H[a];
    return v;
  };
  while (bytes() > kSmemLimit) {
    if (ndim == 3 && T[1] > 1) T[1] /= 2;
    else if (T[p.lead] > 1) T[p.lead] /= 2;
    else if (T[2] > 8) T[2] /= 2;
    else return cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) {
    p.T[a] = T[a];
    p.L[a] = T[a] + 2 * p.H[a];
  }
  int lin[kMaxPoints];
  for (int j = 0; j < npts; ++j)
    lin[j] = (offs[3 * j] * p.L[1] + offs[3 * j + 1]) * p.L[2] + offs[3 * j + 2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_lin, lin, npts * sizeof(int), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_w, w, npts * sizeof(float), 0,
                                cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  long long grid[3];
  for (int a = 0; a < 3; ++a) {
    const int span = a == p.lead ? block_rows : T[a];
    grid[a] = (p.N[a] + span - 1) / span;
  }
  if (grid[2] > 2147483647LL || grid[1] > 65535 || grid[0] > 65535)
    return cudaErrorInvalidValue;
  const dim3 g(static_cast<unsigned>(grid[2]), static_cast<unsigned>(grid[1]),
               static_cast<unsigned>(grid[0]));
  const int smem = static_cast<int>(bytes());
  if (matrix) {
    e = cudaFuncSetAttribute(stencil_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stencil_kernel<true><<<g, kThreads, smem, s>>>(p);
  } else {
    e = cudaFuncSetAttribute(stencil_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    stencil_kernel<false><<<g, kThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
