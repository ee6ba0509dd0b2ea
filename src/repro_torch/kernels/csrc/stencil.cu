// Temporally blocked Table-3 stencils on Hopper, one kernel per engine
// (paper §3.3, §5.3).
//
// Replaces the TPU kernel src/repro/kernels/stencil/stencil.py::
// stencil_apply (_stencil_kernel with _vpu_step / _mxu_step).  Computes
// `steps` (t <= 3) zero-boundary steps of a 2-D or 3-D stencil of radius
// r <= 3 over float32 u, fused in one pass over device memory.
//
// Bound: bytes.  The ideal pass reads u once and writes the result once
// (2 * 4 bytes per point); the arithmetic is t * 2|S| flops per point,
// below the float32 balance for the Table-3 depths.  The TPU kept whole
// padded rows of a leading-axis block in its on-chip VMEM; an SM has at
// most 227 KB of shared memory, so here the trailing axes are tiled and the
// blocked (leading) axis is streamed.
//
// Grid: one CTA per (leading-axis block of block_rows) x (trailing-axis
// tile).  A plane is one index of the blocked axis: a row in 2-D, a
// (y, x) slice in 3-D.  The CTA holds its tile plus a halo of 3r on the
// trailing axes and walks its block from h = t*r planes before it to h
// planes after it, P planes per pass of its loop (2.5-D temporal
// blocking; P = 8 rows in 2-D, 2 planes for the 3-D vector engine, 1 for
// the 3-D matrix engine):
//   * level 0 is the input: a ring of planes filled by cp.async two passes
//     ahead of the one being read, 16 bytes per copy where the rows are
//     16-byte aligned, 4 bytes otherwise, zero outside the domain;
//   * level s (1 <= s < t) is step s: a ring of planes.  Step s at plane q
//     reads level s - 1 at planes q - r .. q + r, so it runs r planes
//     behind step s - 1, a __syncthreads() between the steps of a pass (a
//     separable box's passes add their own);
//   * level t is written to device memory.
// Each input plane is loaded once per CTA; level s covers the tile grown
// by (t - s) * r per side (the reference's trapezoid), and every point
// outside the domain is zeroed after every step (its _domain_mask).
//
// The kernels are specialised at compile time on (ndim, radius, kind,
// engine): the offsets are immediate shared-memory strides, the FMA chain
// and the three possible steps unroll, the weights are kernel parameters,
// and the buffers are laid out for t = 3.  The spec's offset order, which
// fixes the rounding, is that of kernels/stencil/defs.py (_star,
// _box_separable); the launcher refuses any other.  Built as 8 objects
// in parallel (REPRO_PART, one per (ndim, kind, engine)).
//
// Vector engine: shifted fused multiply-adds over the spec's offsets in
// the spec's order from 0, as the reference's fused _vpu_step.  Each
// thread owns fixed points of the largest step's region and computes them
// for every plane of a pass; a star reads each point's column (its
// blocked-axis taps) once per pass and step.
// Matrix engine: each step's per-axis passes on the FP64 tensor cores (DMMA
// m8n8k4, values converted to double), as _mxu_step: star = centre * u +
// the passes in axis order, separable box = the product of the passes,
// each pass summed in double and rounded once to float32.  A warp computes
// 8 x 8 points: in 2-D the pass's 8 rows x 8 columns, every axis a banded
// product (ceil((8 + 2r) / 4) k-steps of the inputs around 8 positions);
// in 3-D 8 x 8 (y, x) points of one plane, y and x banded, and the
// blocked axis, which has one output plane, as 8 DMMAs that each put the
// 2r + 1 weights in one column of B and one column of points in A.  Every
// sum runs in the plain version's order.  A star's passes and centre term
// meet in registers and are written once; a box keeps each pass in
// scratch planes, since each pass widens the next one's input region.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace repro_stencil {

constexpr int kMaxPoints = 343;  // 3-D box of radius 3
constexpr int kMaxTaps = 7;      // 2r + 1 for r <= 3
constexpr int kMaxSteps = 3;
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const float* u;
  float* out;
  int n0, n1, n2;          // extents: blocked axis, y (1 in 2-D), x
  int steps;
  int block_rows;          // planes of the blocked axis per CTA
  int tiles_x, tiles_y;    // CTA tiles across x and y
  float center;            // a star's centre weight (matrix engine)
  float axw[3][kMaxTaps];  // 1-D weights along the blocked axis, y, x
  float w[kMaxPoints];     // the spec's weights, in its offset order
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int ipow(int b, int e) {
  return e == 0 ? 1 : b * ipow(b, e - 1);
}
__host__ __device__ constexpr int pow2(int n) {
  return n <= 1 ? 1 : 2 * pow2((n + 1) / 2);
}

// The spec's offsets in the order _star / _box_separable build them: tap j
// moves by off(j, a) along spec axis a (0 = the blocked axis).
template <int ND, int R, bool BOX>
struct Taps {
  static constexpr int N = BOX ? ipow(2 * R + 1, ND) : 1 + 2 * R * ND;
  __host__ __device__ static constexpr int off(int j, int a) {
    return BOX ? (j / ipow(2 * R + 1, ND - 1 - a)) % (2 * R + 1) - R
           : j == 0 || (j - 1) / (2 * R) != a
               ? 0
               : ((j - 1) % 2 ? 1 : -1) * (((j - 1) % (2 * R)) / 2 + 1);
  }
  __host__ __device__ static constexpr int dz(int j) { return off(j, 0); }
  __host__ __device__ static constexpr int dy(int j) {
    return ND == 3 ? off(j, 1) : 0;
  }
  __host__ __device__ static constexpr int dx(int j) {
    return off(j, ND - 1);
  }
};

// Plane-buffer geometry, as free functions so that a struct's constants can
// use them.  A CTA's output tile is TX columns (x 1 row in 2-D, x TX rows in
// 3-D), so that at t = 3 the level-1 region fits 256 columns (2-D) or 32 x
// 32 (3-D); the halo is 3r (x: rounded up to whole 16-byte chunks).  Level
// s's region grows by (t - s) * r per side.  The matrix engine's MMA tiles
// cover 8 x 8 points, and a banded pass reads 4 * ceil((8 + 2r) / 4)
// inputs around 8 positions, so its buffers extend past every region that
// far.
__host__ __device__ constexpr int tile_x(int nd, int r) {
  return ((nd == 3 ? 32 : 256) - 2 * (kMaxSteps - 1) * r) / 4 * 4;
}
__host__ __device__ constexpr int halo_x(int r) {
  return (kMaxSteps * r + 3) / 4 * 4;
}
__host__ __device__ constexpr int band_reach(int r) {
  return 4 * ((8 + 2 * r + 3) / 4) - 8 - r;
}
__host__ __device__ constexpr int plane_rows(int nd, int r, bool matrix) {
  const int ty = nd == 3 ? tile_x(nd, r) : 1, hy = nd == 3 ? kMaxSteps * r : 0;
  int v = ty + 2 * hy;
  for (int g = 0; matrix && nd == 3 && g <= kMaxSteps; ++g) {
    const int top = hy - g * r, span = (ty + 2 * g * r + 7) / 8 * 8;
    v = cmax(v, top + span + (g < kMaxSteps ? band_reach(r) : 0));
  }
  return v;
}
__host__ __device__ constexpr int plane_cols(int nd, int r, bool matrix) {
  const int tx = tile_x(nd, r), hx = halo_x(r);
  int v = tx + 2 * hx;
  for (int g = 0; matrix && g <= kMaxSteps; ++g) {
    const int left = hx - g * r, span = (tx + 2 * g * r + 7) / 8 * 8;
    v = cmax(v, left + span + (g < kMaxSteps ? band_reach(r) : 0));
  }
  return (v + 3) / 4 * 4;
}

// The CTA's place: the global (plane, y, x) of local plane 0 and of buffer
// row 0 / column 0, the steps, its output planes [h, h + nb) and the input
// planes it loads.
struct Cta {
  int z0, y0, x0, steps, h, nb, nload;
};

// A rectangle of a plane buffer: rows [y, y + ny) x columns [x, x + nx).
struct Rect {
  int y, ny, x, nx;
};

template <int ND, int R, bool BOX, bool MATRIX>
struct Stencil {
  using Tp = Taps<ND, R, BOX>;
  // planes each pass of the plane loop moves: 8 rows in 2-D (one MMA tile
  // deep), 2 planes (vector) or 1 (matrix) in 3-D
  static constexpr int P = ND == 2 ? 8 : (MATRIX ? 1 : 2);
  // 3-D vector: 512 threads, two points each (16 warps per CTA)
  static constexpr int THREADS = ND == 3 && !MATRIX ? 512 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int HX = halo_x(R);
  static constexpr int HY = ND == 3 ? kMaxSteps * R : 0;
  static constexpr int TX = tile_x(ND, R);
  static constexpr int TY = ND == 3 ? TX : 1;
  // passes of input copies in flight, the one being waited for included
  static constexpr int D = ND == 3 && MATRIX ? 2 : 3;
  static constexpr int NK = (8 + 2 * R + 3) / 4;  // k-steps, banded pass
  static constexpr int NKZ = (2 * R + 1 + 3) / 4;  // k-steps, 1-plane pass
  static constexpr int LOADY = TY + 2 * HY, LOADX = TX + 2 * HX;
  static constexpr int LY = plane_rows(ND, R, MATRIX);
  static constexpr int LX = plane_cols(ND, R, MATRIX);
  static constexpr int PLANE = LY * LX;
  // rings of whole planes, a power of two each: level 0 holds the planes
  // step 1 reads and those in flight, level s the planes step s + 1 reads
  static constexpr int RING0 = pow2(D * P + 2 * R), RINGS = pow2(P + 2 * R);
  static constexpr int SCRATCH = MATRIX && BOX ? (ND == 3 ? 2 : P) : 0;
  static constexpr int NPLANES = RING0 + (kMaxSteps - 1) * RINGS + SCRATCH;
  static constexpr int SMEM_BYTES = NPLANES * PLANE * 4;
  static_assert(SMEM_BYTES <= kSmemMax, "stencil planes exceed shared memory");
  // CTAs an SM holds by shared memory (228 KB, 1 KB reserved per CTA), at
  // most 3: the register cap of __launch_bounds__
  static constexpr int MIN_CTAS =
      cmax(1, (228 * 1024) / (SMEM_BYTES + 1024) < 3
                  ? (228 * 1024) / (SMEM_BYTES + 1024)
                  : 3);
  static_assert(TX % 4 == 0 && LX % 4 == 0, "rows must stay 16-byte aligned");
  // the vector engine's points: those of the largest level-1 region, one
  // per thread and slot
  static constexpr int NPTS = (ND == 3 ? TY + 4 * R : 1) * (TX + 4 * R);
  static constexpr int SLOTS = (NPTS + THREADS - 1) / THREADS;

  // level s's region for t steps: the tile grown by (t - s) r per side
  __device__ static Rect region(int t, int s) {
    const int g = (t - s) * R;
    return ND == 3 ? Rect{HY - g, TY + 2 * g, HX - g, TX + 2 * g}
                   : Rect{0, 1, HX - g, TX + 2 * g};
  }

  // level s's ring slot of plane q (any q: the rings are powers of two)
  __device__ static float* plane(float* smem, int s, int q) {
    return s == 0 ? smem + (q & (RING0 - 1)) * PLANE
                  : smem + (RING0 + (s - 1) * RINGS + (q & (RINGS - 1))) *
                               PLANE;
  }
  __device__ static float* scratch(float* smem, int k) {
    return smem + (NPLANES - SCRATCH + k) * PLANE;
  }

  // cp.async of input planes [P j, P j + P) into level 0, zero outside the
  // domain
  __device__ static void load(const Params& p, const Cta& c, float* smem,
                              int j) {
    if ((p.n2 & 3) == 0) {
      constexpr int CX = LOADX / 4, N = LOADY * CX;
      for (int k = threadIdx.x; k < P * N; k += THREADS) {
        const int e = k / N, row = k % N / CX, col = k % N % CX * 4;
        const int q = P * j + e, z = c.z0 + q;
        const int gy = c.y0 + row, gx = c.x0 + col;
        const bool ok = q < c.nload && z >= 0 && z < p.n0 && gy >= 0 &&
                        gy < p.n1 && gx >= 0 && gx < p.n2;
        const float* src =
            ok ? p.u + (static_cast<size_t>(z) * p.n1 + gy) * p.n2 + gx : p.u;
        cp_async16(plane(smem, 0, q) + row * LX + col, src, ok);
      }
    } else {
      constexpr int N = LOADY * LOADX;
      for (int k = threadIdx.x; k < P * N; k += THREADS) {
        const int e = k / N, row = k % N / LOADX, col = k % N % LOADX;
        const int q = P * j + e, z = c.z0 + q;
        const int gy = c.y0 + row, gx = c.x0 + col;
        const bool ok = q < c.nload && z >= 0 && z < p.n0 && gy >= 0 &&
                        gy < p.n1 && gx >= 0 && gx < p.n2;
        const float* src =
            ok ? p.u + (static_cast<size_t>(z) * p.n1 + gy) * p.n2 + gx : p.u;
        cp_async4(plane(smem, 0, q) + row * LX + col, src, ok);
      }
    }
  }

  __device__ static bool inside(const Params& p, const Cta& c, int row,
                                int col) {
    const int gy = c.y0 + row, gx = c.x0 + col;
    return gy >= 0 && gy < p.n1 && gx >= 0 && gx < p.n2;
  }
  __device__ static bool plane_in(const Params& p, const Cta& c, int q) {
    return c.z0 + q >= 0 && c.z0 + q < p.n0;
  }
  // the last step's value at buffer (row, col) of plane q, where it lies in
  // the tile and among the CTA's planes (`in`: in the domain)
  __device__ static void store(const Params& p, const Cta& c, int q, int row,
                               int col, float v, bool in) {
    if (in && q >= c.h && q < c.h + c.nb && row < HY + TY && col < HX + TX)
      p.out[(static_cast<size_t>(c.z0 + q) * p.n1 + c.y0 + row) * p.n2 +
            c.x0 + col] = v;
  }

  // step s moves planes [a, a + P) in pass i, a = P i - s r; false where
  // none of them is in the trapezoid or there is no step s
  __device__ static bool active(const Cta& c, int s, int i, int& a) {
    a = P * i - s * R;
    return s <= c.steps && a + P > s * R && a < c.nload - s * R;
  }

  // ---- vector engine ----------------------------------------------------

  // This thread's points: slot m is point threadIdx.x + THREADS m of the
  // largest level-1 region, at buffer offset at[m] (row[m], col[m]); bit s
  // of act[m] says whether it lies in level s's region, bit 0 whether in
  // the domain.
  struct Points {
    int at[SLOTS], row[SLOTS], col[SLOTS], act[SLOTS];
  };

  __device__ static Points make_points(const Params& p, const Cta& c) {
    constexpr int NX = TX + 4 * R, Y0 = ND == 3 ? HY - 2 * R : 0,
                  X0 = HX - 2 * R;
    Points pt;
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) {
      const int k = threadIdx.x + m * THREADS;
      const int row = Y0 + min(k, NPTS - 1) / NX,
                col = X0 + min(k, NPTS - 1) % NX;
      pt.at[m] = row * LX + col;
      pt.row[m] = row;
      pt.col[m] = col;
      int bits = inside(p, c, row, col) ? 1 : 0;
#pragma unroll
      for (int s = 1; s <= kMaxSteps; ++s) {
        const Rect g = region(c.steps, s);
        if (k < NPTS && s <= c.steps && row >= g.y && row < g.y + g.ny &&
            col >= g.x && col < g.x + g.nx)
          bits |= 1 << s;
      }
      pt.act[m] = bits;
    }
    return pt;
  }

  template <int S>
  __device__ static void vector_level(const Params& p, const Cta& c,
                                      const Points& pt, float* smem, int i) {
    int a;
    if (!active(c, S, i, a)) return;
    const bool last = S == c.steps;
    // level S - 1 at planes a - r .. a + P + r - 1
    const float* src[P + 2 * R];
#pragma unroll
    for (int k = 0; k < P + 2 * R; ++k) src[k] = plane(smem, S - 1, a - R + k);
    bool zin[P];
#pragma unroll
    for (int e = 0; e < P; ++e) zin[e] = plane_in(p, c, a + e);
    // a box's slots are a loop
#pragma unroll (BOX ? 1 : SLOTS)
    for (int m = 0; m < SLOTS; ++m) {
      if (!(pt.act[m] >> S & 1)) continue;
      const int at = pt.at[m];
      float own[P + 2 * R];  // a star's point's column, read once
      if constexpr (!BOX) {
#pragma unroll
        for (int k = 0; k < P + 2 * R; ++k) own[k] = src[k][at];
      }
#pragma unroll
      for (int e = 0; e < P; ++e) {
        float acc = 0.f;
        if constexpr (BOX) {
          // the taps in _box_separable's order, as loops short enough to
          // unroll whole: every offset an immediate
          constexpr int W = 2 * R + 1, WY = ND == 3 ? W : 1;
#pragma unroll
          for (int iz = 0; iz < W; ++iz)
#pragma unroll
            for (int iy = 0; iy < WY; ++iy)
#pragma unroll
              for (int ix = 0; ix < W; ++ix)
                acc = __fmaf_rn(p.w[(iz * WY + iy) * W + ix],
                                src[e + iz][at + (ND == 3 ? iy - R : 0) * LX +
                                            ix - R],
                                acc);
        } else {
#pragma unroll
          for (int j = 0; j < Tp::N; ++j) {
            const int dz = Tp::dz(j), dy = Tp::dy(j), dx = Tp::dx(j);
            acc = __fmaf_rn(p.w[j],
                            dy == 0 && dx == 0
                                ? own[e + R + dz]
                                : src[e + R][at + dy * LX + dx],
                            acc);
          }
        }
        const bool in = zin[e] && (pt.act[m] & 1);
        if (last) {
          store(p, c, a + e, pt.row[m], pt.col[m], acc, in);
        } else {
          plane(smem, S, a + e)[at] = in ? acc : 0.f;
        }
      }
    }
  }

  // ---- matrix engine ----------------------------------------------------

  // This lane's band fragments, in double: w[4k + t - g] of a banded pass
  // (B for x; A for the passes along y and, in 2-D, along the rows), and
  // w[4k + t] of the 3-D one-plane pass.
  struct Frag {
    double band_z[NK], band_y[NK], band_x[NK], col_z[NKZ];
  };

  __device__ static double weight(const Params& p, int axis, int d) {
    double v = 0.0;
#pragma unroll
    for (int e = 0; e <= 2 * R; ++e)
      if (e == d) v = static_cast<double>(p.axw[axis][e]);
    return v;
  }

  __device__ static Frag make_frag(const Params& p) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    Frag f;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      f.band_z[k] = weight(p, 0, 4 * k + t - g);
      f.band_y[k] = weight(p, 1, 4 * k + t - g);
      f.band_x[k] = weight(p, 2, 4 * k + t - g);
    }
#pragma unroll
    for (int k = 0; k < NKZ; ++k) f.col_z[k] = weight(p, 0, 4 * k + t);
    return f;
  }

  // f(row, col) for the top-left corner of every 8 x 8 MMA tile over a
  // rectangle (2-D: 8 columns, the rows being the pass's planes), one tile
  // per warp at a time
  template <typename F>
  __device__ static void each_tile(const Rect& a, F&& f) {
    const int ntx = (a.nx + 7) / 8;
    const int n = (ND == 3 ? (a.ny + 7) / 8 : 1) * ntx;
    for (int tile = threadIdx.x >> 5; tile < n; tile += WARPS) {
      const int ty = tile / ntx;
      f(a.y + ty * 8, a.x + (tile - ty * ntx) * 8);
    }
  }

  // A banded pass whose positions are the tile's rows: A = the band, B =
  // the inputs of row 4k + t - r (rows[k], this lane's) at the tile's
  // column g.
  __device__ static void pass_rows(const double (&band)[NK],
                                   const float* const (&rows)[NK], int col,
                                   double& d0, double& d1) {
    const int g = (threadIdx.x & 31) >> 2;
    d0 = d1 = 0.0;
#pragma unroll
    for (int k = 0; k < NK; ++k)
      dmma_884(d0, d1, band[k], static_cast<double>(rows[k][col + g]), d0,
               d1);
  }
  // A banded pass along x: A = the inputs of this lane's row at columns
  // 4k + t - r, B = the band.
  __device__ static void pass_x(const Frag& f, const float* row, int col,
                                double& d0, double& d1) {
    const int t = threadIdx.x & 3;
    d0 = d1 = 0.0;
#pragma unroll
    for (int k = 0; k < NK; ++k)
      dmma_884(d0, d1, static_cast<double>(row[col + 4 * k + t - R]),
               f.band_x[k], d0, d1);
  }
  // The 3-D pass along the blocked axis, one output plane: DMMA jn puts the
  // weights in column jn of B and the tile's column jn of points (planes
  // q - r + 4k + t: zsrc[k], this lane's) in A, so D[g][n] sums column n's
  // taps in tap order.
  __device__ static void pass_z1(const Frag& f,
                                 const float* const (&zsrc)[NKZ], int org,
                                 double& d0, double& d1) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    d0 = d1 = 0.0;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int k = 0; k < NKZ; ++k) {
        const double a =
            4 * k + t <= 2 * R ? static_cast<double>(zsrc[k][org + g * LX + jn])
                               : 0.0;
        dmma_884(d0, d1, a, g == jn ? f.col_z[k] : 0.0, d0, d1);
      }
    }
  }

  // 2-D: the tile's rows are the pass's 8 planes a .. a + 7
  template <int S>
  __device__ static void matrix_level_2d(const Params& p, const Cta& c,
                                         const Frag& f, float* smem, int i) {
    int a;
    if (!active(c, S, i, a)) return;
    const bool last = S == c.steps;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* rows[NK];  // level S - 1 at plane a - r + 4k + t
#pragma unroll
    for (int k = 0; k < NK; ++k) rows[k] = plane(smem, S - 1, a - R + 4 * k + t);
    const float* mine = plane(smem, S - 1, a + g);  // this lane's row
    float* dst = plane(smem, S, a + g);
    const bool zin = plane_in(p, c, a + g);
    const Rect out = region(c.steps, S);
    auto finish = [&](int col, double (&v)[2], const double* y) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = col + 2 * t + e;
        float r = __double2float_rn(v[e]);
        if constexpr (!BOX)
          r = __fadd_rn(__fadd_rn(__fmul_rn(p.center, mine[cl]),
                                  __double2float_rn(y[e])),
                        r);
        const bool in = zin && inside(p, c, 0, cl);
        if (last) {
          store(p, c, a + g, 0, cl, r, in);
        } else {
          dst[cl] = in ? r : 0.f;
        }
      }
    };
    if constexpr (!BOX) {
      each_tile(out, [&](int, int col) {
        double z[2], x[2];
        pass_rows(f.band_z, rows, col, z[0], z[1]);
        pass_x(f, mine, col, x[0], x[1]);
        finish(col, x, z);
      });
      return;
    }
    // separable box: the pass along the rows over level S - 1's columns
    // into scratch, then the x pass over S's region
    float* srow = scratch(smem, g);
    each_tile(region(c.steps, S - 1), [&](int, int col) {
      double z[2];
      pass_rows(f.band_z, rows, col, z[0], z[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        srow[col + 2 * t + e] = __double2float_rn(z[e]);
    });
    __syncthreads();
    each_tile(out, [&](int, int col) {
      double x[2];
      pass_x(f, srow, col, x[0], x[1]);
      finish(col, x, nullptr);
    });
  }

  // 3-D: 8 x 8 (y, x) tiles of plane a
  template <int S>
  __device__ static void matrix_level_3d(const Params& p, const Cta& c,
                                         const Frag& f, float* smem, int i) {
    int q;
    if (!active(c, S, i, q)) return;
    const bool last = S == c.steps;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* zsrc[NKZ];  // level S - 1 at plane q - r + 4k + t
#pragma unroll
    for (int k = 0; k < NKZ; ++k)
      zsrc[k] = plane(smem, S - 1, q - R + min(4 * k + t, 2 * R));
    const float* cur = plane(smem, S - 1, q);
    float* dst = plane(smem, S, q);
    const bool zin = plane_in(p, c, q);
    const Rect out = region(c.steps, S);
    // rows 4k + t - r below a tile's top row, of a plane
    auto band_rows = [&](const float* pl, int row, const float* (&rows)[NK]) {
#pragma unroll
      for (int k = 0; k < NK; ++k) rows[k] = pl + (row + 4 * k + t - R) * LX;
    };
    auto finish = [&](int row, int col, double (&v)[2]) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + g, cl = col + 2 * t + e;
        const float x = __double2float_rn(v[e]);
        const bool in = zin && inside(p, c, r, cl);
        if (last) {
          store(p, c, q, r, cl, x, in);
        } else {
          dst[r * LX + cl] = in ? x : 0.f;
        }
      }
    };
    if constexpr (!BOX) {
      each_tile(out, [&](int row, int col) {
        double z[2], y[2], x[2];
        const float* rows[NK];
        band_rows(cur, row, rows);
        pass_z1(f, zsrc, row * LX + col, z[0], z[1]);
        pass_rows(f.band_y, rows, col, y[0], y[1]);
        pass_x(f, cur + (row + g) * LX, col, x[0], x[1]);
        double v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // centre * u + the passes in axis order, in float32
          float s = __fmul_rn(p.center, cur[(row + g) * LX + col + 2 * t + e]);
          s = __fadd_rn(s, __double2float_rn(z[e]));
          s = __fadd_rn(s, __double2float_rn(y[e]));
          v[e] = __fadd_rn(s, __double2float_rn(x[e]));
        }
        finish(row, col, v);
      });
      return;
    }
    // separable box: the blocked-axis pass over level S - 1's region, the
    // y pass over S's rows and S - 1's columns, the x pass over S's region
    const Rect wide = region(c.steps, S - 1);
    float* s0 = scratch(smem, 0);
    float* s1 = scratch(smem, 1);
    each_tile(wide, [&](int row, int col) {
      double z[2];
      pass_z1(f, zsrc, row * LX + col, z[0], z[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s0[(row + g) * LX + col + 2 * t + e] = __double2float_rn(z[e]);
    });
    __syncthreads();
    each_tile(Rect{out.y, out.ny, wide.x, wide.nx}, [&](int row, int col) {
      double y[2];
      const float* rows[NK];
      band_rows(s0, row, rows);
      pass_rows(f.band_y, rows, col, y[0], y[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s1[(row + g) * LX + col + 2 * t + e] = __double2float_rn(y[e]);
    });
    __syncthreads();
    each_tile(out, [&](int row, int col) {
      double x[2];
      pass_x(f, s1 + (row + g) * LX, col, x[0], x[1]);
      finish(row, col, x);
    });
  }

  template <int S>
  __device__ static void level(const Params& p, const Cta& c, const Frag& f,
                               const Points& pt, float* smem, int i) {
    if (S > c.steps) return;
    // step S - 1's planes of this pass (and a box's last reads of scratch)
    if (S > 1) __syncthreads();
    if constexpr (!MATRIX) {
      vector_level<S>(p, c, pt, smem, i);
    } else if constexpr (ND == 2) {
      matrix_level_2d<S>(p, c, f, smem, i);
    } else {
      matrix_level_3d<S>(p, c, f, smem, i);
    }
  }

  __device__ static void run(const Params& p, float* smem) {
    // every buffer starts at zero: MMA tiles read past their regions where
    // the weights are zero, so every value there must be finite
    float4* v4 = reinterpret_cast<float4*>(smem);
    for (int k = threadIdx.x; k < NPLANES * PLANE / 4; k += THREADS)
      v4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int bx = blockIdx.x % p.tiles_x, rest = blockIdx.x / p.tiles_x;
    const int by = rest % p.tiles_y, bz = rest / p.tiles_y;
    const int h = p.steps * R;
    const int nb = min(p.block_rows, p.n0 - bz * p.block_rows);
    const Cta c = {bz * p.block_rows - h, by * TY - HY, bx * TX - HX,
                   p.steps, h, nb, nb + 2 * h};
    const int npass = (c.nload + P - 1) / P;  // until the last step ends
    Frag f;
    Points pt;
    if constexpr (MATRIX) {
      f = make_frag(p);
    } else {
      pt = make_points(p, c);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < D - 1; ++j) {
      if (P * j < c.nload) load(p, c, smem, j);
      cp_async_commit();
    }
    for (int i = 0; i < npass; ++i) {
      cp_async_wait<D - 2>();  // this thread's copies of pass i landed
      __syncthreads();         // everyone's; and pass i - 1 is done
      if (P * (i + D - 1) < c.nload) load(p, c, smem, i + D - 1);
      cp_async_commit();
      level<1>(p, c, f, pt, smem, i);
      level<2>(p, c, f, pt, smem, i);
      level<3>(p, c, f, pt, smem, i);
    }
    cp_async_wait<0>();
  }
};

template <int ND, int R, bool BOX, bool MATRIX>
__global__ void __launch_bounds__(Stencil<ND, R, BOX, MATRIX>::THREADS,
                                  Stencil<ND, R, BOX, MATRIX>::MIN_CTAS)
    stencil_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  Stencil<ND, R, BOX, MATRIX>::run(p, smem);
}

template <int ND, int R, bool BOX, bool MATRIX>
int launch(Params& p, cudaStream_t s) {
  using K = Stencil<ND, R, BOX, MATRIX>;
  p.tiles_x = (p.n2 + K::TX - 1) / K::TX;
  p.tiles_y = (p.n1 + K::TY - 1) / K::TY;
  const long long blocks = static_cast<long long>(p.tiles_x) * p.tiles_y *
                           ((p.n0 + p.block_rows - 1) / p.block_rows);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stencil_kernel<ND, R, BOX, MATRIX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  stencil_kernel<ND, R, BOX, MATRIX>
      <<<static_cast<unsigned>(blocks), K::THREADS, K::SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The kernels of (ndim, kind, engine) number k = 4 (ndim == 3) + 2 box +
// matrix, for a radius.  Object k of the parallel build (REPRO_PART = k)
// defines launch_part<k>; built as one object, the file defines all eight.
template <int K>
int launch_part(int radius, Params& p, cudaStream_t s);
#if defined(REPRO_PART)
template <> int launch_part<0>(int, Params&, cudaStream_t);
template <> int launch_part<1>(int, Params&, cudaStream_t);
template <> int launch_part<2>(int, Params&, cudaStream_t);
template <> int launch_part<3>(int, Params&, cudaStream_t);
template <> int launch_part<4>(int, Params&, cudaStream_t);
template <> int launch_part<5>(int, Params&, cudaStream_t);
template <> int launch_part<6>(int, Params&, cudaStream_t);
template <> int launch_part<7>(int, Params&, cudaStream_t);
template <>
int launch_part<REPRO_PART>(int radius, Params& p, cudaStream_t s)
#else
template <int K>
int launch_part(int radius, Params& p, cudaStream_t s)
#endif
{
#if defined(REPRO_PART)
  constexpr int K = REPRO_PART;
#endif
  constexpr int ND = K >= 4 ? 3 : 2;
  constexpr bool BOX = K / 2 % 2 == 1, MATRIX = K % 2 == 1;
  switch (radius) {
    case 1: return launch<ND, 1, BOX, MATRIX>(p, s);
    case 2: return launch<ND, 2, BOX, MATRIX>(p, s);
    case 3: return launch<ND, 3, BOX, MATRIX>(p, s);
  }
  return cudaErrorInvalidValue;
}

// whether npts x 3 offsets (first column 0 in 2-D) are the kernels' own
template <int ND, int R, bool BOX>
bool offsets_ok(const int* offs, int npts) {
  using Tp = Taps<ND, R, BOX>;
  if (npts != Tp::N) return false;
  for (int j = 0; j < npts; ++j)
    for (int a = 0; a < ND; ++a)
      if (offs[3 * j + 3 - ND + a] != Tp::off(j, a)) return false;
  return true;
}

template <int ND>
bool offsets_ok(const int* offs, int npts, int radius, bool box) {
  switch (radius * 2 + (box ? 1 : 0)) {
    case 2: return offsets_ok<ND, 1, false>(offs, npts);
    case 3: return offsets_ok<ND, 1, true>(offs, npts);
    case 4: return offsets_ok<ND, 2, false>(offs, npts);
    case 5: return offsets_ok<ND, 2, true>(offs, npts);
    case 6: return offsets_ok<ND, 3, false>(offs, npts);
    case 7: return offsets_ok<ND, 3, true>(offs, npts);
  }
  return false;
}

}  // namespace repro_stencil

#if !defined(REPRO_PART) || REPRO_PART == 0
REPRO_ERROR_STRING(stencil)

// `steps` fused zero-boundary steps of a stencil over u (dims[3], the
// first being 1 for 2-D).  offs: npts x 3 offsets (first column 0 for
// 2-D), in the order of kernels/stencil/defs.py; w: npts weights; axw:
// 3 x 7 per-axis 1-D weights (first row unused for 2-D).  Returns the
// cudaError_t.
extern "C" int stencil_launch(const float* u, float* out, const int* dims,
                              int ndim, const int* offs, const float* w,
                              int npts, const float* axw, float center,
                              int radius, int box, int steps, int block_rows,
                              int matrix, void* stream) {
  using namespace repro_stencil;
  if ((ndim != 2 && ndim != 3) || radius < 1 || radius > 3 || steps < 1 ||
      steps > kMaxSteps || npts < 1 || npts > kMaxPoints || block_rows < 1)
    return cudaErrorInvalidValue;
  if (steps * radius > block_rows) return cudaErrorInvalidValue;
  if (!(ndim == 2 ? offsets_ok<2>(offs, npts, radius, box)
                  : offsets_ok<3>(offs, npts, radius, box)))
    return cudaErrorInvalidValue;
  for (int a = 0; a < 3; ++a)
    if (dims[a] <= 0) return cudaSuccess;  // empty domain
  Params p;
  p.u = u;
  p.out = out;
  p.n0 = ndim == 3 ? dims[0] : dims[1];
  p.n1 = ndim == 3 ? dims[1] : 1;
  p.n2 = dims[2];
  p.steps = steps;
  p.block_rows = block_rows;
  p.center = center;
  // axw rows are spec axes placed at row axis + 3 - ndim
  const int rows[3] = {3 - ndim, 1, 2};
  for (int a = 0; a < 3; ++a)
    for (int d = 0; d < kMaxTaps; ++d)
      p.axw[a][d] = ndim == 2 && a == 1 ? 0.f : axw[rows[a] * kMaxTaps + d];
  for (int j = 0; j < kMaxPoints; ++j) p.w[j] = j < npts ? w[j] : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((ndim == 3 ? 4 : 0) + (box ? 2 : 0) + (matrix ? 1 : 0)) {
    case 0: return launch_part<0>(radius, p, s);
    case 1: return launch_part<1>(radius, p, s);
    case 2: return launch_part<2>(radius, p, s);
    case 3: return launch_part<3>(radius, p, s);
    case 4: return launch_part<4>(radius, p, s);
    case 5: return launch_part<5>(radius, p, s);
    case 6: return launch_part<6>(radius, p, s);
    default: return launch_part<7>(radius, p, s);
  }
}
#endif
