// STREAM SCALE / Triad / AXPY on Hopper, one kernel per engine (paper §3.1,
// §5.1).
//
// Replaces the TPU kernel src/repro/core/dispatch.py::_elementwise_grid with
// the bodies of kernels/{scale,triad,axpy}/*.py.  All three compute
//     out = q * m (+ add)
// (SCALE: q*b; Triad: q*c + b; AXPY: a*x + y) at the reference's rounding
// points: the vector bodies fuse the multiply-add (one rounding), the
// matrix bodies round each float32 dot and add the two in float32.
//
// Bound: bytes.  Each element is read once per input and written once, so
// the time floor is (inputs + 1) * n * sizeof(T) over the HBM rate; one
// multiply-add per element is nothing to the CUDA cores.  What keeps HBM
// busy on Hopper, measured with tools/kernel_points.py against designs that
// fill the card's CTA slots once and loop over the arrays (contiguous
// shares, or a front of pass-sized blocks; with a register double buffer
// and L1/L2 streaming hints), all of which ran slower at the STREAM bench
// points (PERF.md, Findings):
//   - one 16-byte chunk per input and thread, no loop: a CTA of 256
//     threads moves 256 consecutive chunks (4 KiB per array), and the grid
//     has one CTA per 256 chunks, so the hardware scheduler hands out
//     short CTAs in address order and the SMs read one narrow front of the
//     arrays;
//   - at most 32 registers a thread, so eight CTAs (64 warps, every thread
//     slot of the SM) are resident and each keeps its loads in flight at
//     once; the matrix engine's conversions and MMAs run while other warps
//     wait on theirs;
//   - plain cached loads (__ldg) and stores: L1::no_allocate loads and
//     st.global.cs stores measured ~1% slower;
//   - the ragged tail is handled inside the kernel (no padded copies), and
//     there is no shared memory.
//
// Vector engine: float32 arithmetic with q as a float32 kernel argument.
// Matrix engine (paper Fig. 5, A = B (qI)): every element goes through a
// tensor-core MMA against a fragment-sized scaled identity built in
// registers.
//   float32: DMMA m8n8k4 on values converted to double; B[k][n] = q iff
//            n == 2k, so D[g][2t] = q * A[g][t] lands in the thread that
//            loaded A[g][t].  The product is exact in double and rounded
//            once to float32: bit-equal to the reference's float32 dot.
//            Half of D and seven eighths of the MMA's multiplies are waste,
//            the paper's 8x4 DMMA point.
//   bfloat16: HMMA m16n8k16 with a float32 accumulator, two MMAs per 16x16
//            A tile (identity in B rows 0-7, then rows 8-15), so each
//            output again lands in the thread that loaded its input.  q is
//            rounded to bfloat16 first, as the reference casts qI to the
//            input dtype.
// Triad and AXPY issue two products, M (qI) and ADD I, each rounded to
// float32, and add them in float32, as the reference adds two float32 dots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
// At most 32 registers a thread, so eight CTAs (all 2048 threads) fit on an
// SM.
constexpr int kMinCtasPerSm = 8;

// 16 bytes: four float32 or eight bfloat16 values.
union Chunk {
  uint4 u;
  float f[4];
  uint32_t w[4];
};

template <bool BF16>
struct Elems {
  static constexpr int kPerChunk = BF16 ? 8 : 4;
};

template <bool BF16>
__device__ __forceinline__ Chunk load_chunk(const void* p, long long c,
                                            long long n) {
  constexpr int E = Elems<BF16>::kPerChunk;
  Chunk x;
  const long long first = c * E;
  if (first + E <= n) {
    x.u = __ldg(reinterpret_cast<const uint4*>(p) + c);
    return x;
  }
  x.u = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < E; ++i) {
    if (first + i >= n) break;
    if (BF16) {
      const uint32_t v = reinterpret_cast<const uint16_t*>(p)[first + i];
      x.w[i / 2] |= v << (16 * (i % 2));
    } else {
      x.f[i] = reinterpret_cast<const float*>(p)[first + i];
    }
  }
  return x;
}

template <bool BF16>
__device__ __forceinline__ void store_chunk(void* p, long long c, long long n,
                                            const Chunk& x) {
  constexpr int E = Elems<BF16>::kPerChunk;
  const long long first = c * E;
  if (first + E <= n) {
    reinterpret_cast<uint4*>(p)[c] = x.u;
    return;
  }
  for (int i = 0; i < E; ++i) {
    if (first + i >= n) break;
    if (BF16) {
      reinterpret_cast<uint16_t*>(p)[first + i] =
          static_cast<uint16_t>(x.w[i / 2] >> (16 * (i % 2)));
    } else {
      reinterpret_cast<float*>(p)[first + i] = x.f[i];
    }
  }
}

// ---- vector engine ------------------------------------------------------

template <bool ADD>
__device__ __forceinline__ float combine(float m, float add, float q) {
  return ADD ? __fmaf_rn(q, m, add) : __fmul_rn(q, m);
}

template <bool BF16, bool ADD>
__device__ __forceinline__ Chunk vector_chunk(const Chunk& m,
                                              const Chunk& add, float q) {
  Chunk y;
  if (BF16) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float lo = combine<ADD>(bf16_bits_to_float(m.w[w] & 0xffffu),
                                    bf16_bits_to_float(add.w[w] & 0xffffu), q);
      const float hi = combine<ADD>(bf16_bits_to_float(m.w[w] >> 16),
                                    bf16_bits_to_float(add.w[w] >> 16), q);
      y.w[w] = float_to_bf16_bits(lo) | (float_to_bf16_bits(hi) << 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) y.f[i] = combine<ADD>(m.f[i], add.f[i], q);
  }
  return y;
}

// ---- matrix engine ------------------------------------------------------

// Per-thread B fragments of the scaled identities qI and I.
struct MatrixB {
  double dq, d1;       // DMMA: q / 1 where g == 2t, else 0
  uint32_t hq, h1;     // HMMA: bf16 pair of B rows 2t, 2t+1 at column g
};

__device__ __forceinline__ MatrixB make_b(float q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  MatrixB b;
  b.dq = (g == 2 * t) ? static_cast<double>(q) : 0.0;
  b.d1 = (g == 2 * t) ? 1.0 : 0.0;
  const uint32_t bq = float_to_bf16_bits(q), b1 = float_to_bf16_bits(1.f);
  b.hq = ((g == 2 * t) ? bq : 0u) | (((g == 2 * t + 1) ? bq : 0u) << 16);
  b.h1 = ((g == 2 * t) ? b1 : 0u) | (((g == 2 * t + 1) ? b1 : 0u) << 16);
  return b;
}

__device__ __forceinline__ float dmma_term(float a, double b) {
  double d0, d1;
  dmma_884(d0, d1, static_cast<double>(a), b, 0.0, 0.0);
  return __double2float_rn(d0);
}

// Both halves of one 16x16 A tile times the scaled identity: out[0..7]
// follow the chunk's element order.
__device__ __forceinline__ void hmma_term(float (&out)[8], const Chunk& x,
                                          uint32_t b) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float lo[4], hi[4];
  hmma_16816_bf16(lo, x.w, b, 0u, zero);  // identity in B rows 0-7
  hmma_16816_bf16(hi, x.w, 0u, b, zero);  // identity in B rows 8-15
  out[0] = lo[0]; out[1] = lo[1]; out[2] = lo[2]; out[3] = lo[3];
  out[4] = hi[0]; out[5] = hi[1]; out[6] = hi[2]; out[7] = hi[3];
}

template <bool BF16, bool ADD>
__device__ __forceinline__ Chunk matrix_chunk(const Chunk& m,
                                              const Chunk& add,
                                              const MatrixB& b) {
  Chunk y;
  if (BF16) {
    float tm[8], ta[8];
    hmma_term(tm, m, b.hq);
    if (ADD) hmma_term(ta, add, b.h1);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float lo = tm[2 * w], hi = tm[2 * w + 1];
      if (ADD) {
        lo = __fadd_rn(lo, ta[2 * w]);
        hi = __fadd_rn(hi, ta[2 * w + 1]);
      }
      y.w[w] = float_to_bf16_bits(lo) | (float_to_bf16_bits(hi) << 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = dmma_term(m.f[i], b.dq);
      if (ADD) r = __fadd_rn(r, dmma_term(add.f[i], b.d1));
      y.f[i] = r;
    }
  }
  return y;
}

// Thread i of CTA j takes chunk 256 j + i.  A warp whose row starts past the
// last chunk leaves as a whole; in the last row, lanes past the array load
// zeros and store nothing, and the MMA still runs on all 32 lanes.
template <bool BF16, bool ADD, bool MMA>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    elementwise_kernel(const void* __restrict__ m,
                       const void* __restrict__ add, void* __restrict__ out,
                       long long n, float q) {
  constexpr int E = Elems<BF16>::kPerChunk;
  const long long total = (n + E - 1) / E;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads +
                        (threadIdx.x & ~31);
  if (row >= total) return;
  const long long c = row + (threadIdx.x & 31);
  const Chunk xm = load_chunk<BF16>(m, c, n);
  const Chunk xa = ADD ? load_chunk<BF16>(add, c, n) : xm;
  Chunk y;
  if constexpr (MMA) {
    y = matrix_chunk<BF16, ADD>(xm, xa, make_b(q));
  } else {
    y = vector_chunk<BF16, ADD>(xm, xa, q);
  }
  store_chunk<BF16>(out, c, n, y);
}

template <bool BF16, bool ADD, bool MMA>
void launch(const void* m, const void* add, void* out, long long n, float q,
            long long grid, cudaStream_t stream) {
  elementwise_kernel<BF16, ADD, MMA>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(m, add, out, n,
                                                             q);
}

template <bool BF16>
void launch_dtype(int has_add, int matrix, const void* m, const void* add,
                  void* out, long long n, float q, long long grid,
                  cudaStream_t s) {
  if (!has_add && !matrix)
    launch<BF16, false, false>(m, add, out, n, q, grid, s);
  else if (!has_add)
    launch<BF16, false, true>(m, add, out, n, q, grid, s);
  else if (!matrix)
    launch<BF16, true, false>(m, add, out, n, q, grid, s);
  else
    launch<BF16, true, true>(m, add, out, n, q, grid, s);
}

}  // namespace

REPRO_ERROR_STRING(elementwise)

// out = q * m (+ add) over n elements on `grid` CTAs of 256 threads, one
// 16-byte chunk per thread: grid must be ceil(chunks / 256), as the
// wrapper's elementwise_grid gives it.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int elementwise_launch(const void* m, const void* add, void* out,
                                  long long n, int has_add, float q, int bf16,
                                  int matrix, long long grid, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long e = bf16 ? 8 : 4;
  const long long total = (n + e - 1) / e;
  if (grid != (total + kThreads - 1) / kThreads || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_dtype<true>(has_add, matrix, m, add, out, n, q, grid, s);
  else
    launch_dtype<false>(has_add, matrix, m, add, out, n, q, grid, s);
  return static_cast<int>(cudaGetLastError());
}
