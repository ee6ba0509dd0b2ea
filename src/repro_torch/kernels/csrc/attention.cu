// Flash-decode: single-token GQA attention over a KV cache, on Hopper, one
// kernel per engine (the LM-serving op the paper's framework classifies).
//
// Replaces the TPU kernel src/repro/kernels/attention/flash_decode.py:70
// (flash_decode, body _flash_decode_kernel).  For every (batch b, KV head h)
// pair and each of its G query heads,
//     out[b][h][g] = softmax(q[b][h][g] . K[b][:, h]^T / sqrt(Dh)) V[b][:, h]
// with cache positions >= kv_len masked to -1e30 (not -inf: an all-masked
// block gives exp(0) = 1, so kv_len = 0 yields the mean of V, as the
// reference does) and the result acc / max(l, 1e-30) cast to q's dtype.
// q is (B, KH, G, Dh); k and v are (B, S, KH, Dh); all math is float32 or
// wider.
//
// Bound: bytes.  The whole cache is streamed once, 2 * B * S * KH * Dh *
// sizeof(T) bytes over the H100's 3.35 TB/s (every position, masked or not,
// as the reference reads and counts it), for 4 * G flops per cache element:
// far below the card's balance.  The TPU walked the S axis in order on one core carrying
// (m, l, acc) across grid steps; here S is cut into contiguous ranges, one
// CTA each (one reference KV block per CTA where that fills the card,
// shorter ranges where B * KH pairs alone would leave SMs idle), so enough
// loads are in flight to cover HBM latency.  Each CTA streams its range
// exactly once, keeps its online softmax state in registers, merges its
// warps' states in shared memory, and writes one float32 partial
// (m, l, acc); a second small kernel merges the partials of a pair:
//     m* = max m_i,  l* = sum l_i e^(m_i - m*),  acc* = sum acc_i e^(m_i - m*),
//     out = acc* / max(l*, 1e-30).
// With one range per pair the first kernel writes the output itself.
//
// Both engines share everything but the two contractions, as the
// reference's two kernel bodies do: a warp takes 16 cache positions per
// tile; lane (g, t) (g = lane / 4, t = lane % 4) loads elements
// [t*Dh/4, (t+1)*Dh/4) of K rows g and g + 8, and elements
// [g*Dh/8, (g+1)*Dh/8) of V rows; it keeps the online-softmax state of query
// heads 2t and 2t+1 and their output elements [g*Dh/8, (g+1)*Dh/8).  The
// heads are padded to 8, so G of the 8 head columns do useful work: 4 of 8
// at the Mistral-NeMo shape.
//   Matrix engine, on tensor cores:
//     q.K^T puts the cache positions on M and the heads on N.
//       float32:  DMMA m8n8k4 on values converted to double (two 8-row
//                 halves), products exact, rounded once to float32.
//       bfloat16: HMMA m16n8k16 with a float32 accumulator.
//     p.V: DMMA m8n8k4 with V^T on M (8 of Dh per MMA), the heads on N and 4
//     positions on K, accumulated in double.  p is a float32 value; rounding
//     it to bf16 for an HMMA would break the one-ulp tolerance, so p.V takes
//     the FP64 tensor cores for both types.
//   Vector engine, on the CUDA cores: the same products as FFMAs in
//   float32.  Each lane takes partial dots over its K span for every head
//   (q staged in shared memory), and a reduce-scatter over the four t lanes
//   (12 shuffles per tile) leaves it the full scores of heads 2t and 2t+1;
//   p.V walks the tile's 16 V rows, each lane its own span.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kMaxHeads = 8;       // query heads per KV head (MMA N)
constexpr int kTile = 16;          // cache positions per warp tile

struct Shape {
  int kh;       // KV heads
  int g;        // query heads per KV head
  int s;        // cache length
  int dh;       // head dim
  int kv_len;   // positions >= kv_len are masked
  int rows;     // cache positions per CTA
  int nsplit;   // CTAs per (b, h) pair
  float scale;  // 1 / sqrt(Dh), rounded as the reference rounds it
};

__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = bf16_bits_to_float(w & 0xffffu);
  hi = bf16_bits_to_float(w >> 16);
}

// N consecutive bfloat16 values at p as raw 32-bit words (N even), with the
// widest load the span allows (p is aligned to the span's byte size).
template <int N>
__device__ __forceinline__ void load_words(const __nv_bfloat16* p,
                                           uint32_t (&w)[N / 2]) {
  constexpr int W = N / 2;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z,
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = x.x, w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
  }
}

// N consecutive values at p as float32, zero where the row is out of range.
template <int N>
__device__ __forceinline__ void load_span(const float* p, bool ok,
                                          float (&o)[N]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = 0.f;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
      o[4 * i] = x.x, o[4 * i + 1] = x.y, o[4 * i + 2] = x.z,
      o[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + i);
      o[2 * i] = x.x, o[2 * i + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_span(const __nv_bfloat16* p, bool ok,
                                          float (&o)[N]) {
  uint32_t w[N / 2];
  if (ok) {
    load_words<N>(p, w);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) unpack2(w[i], o[2 * i], o[2 * i + 1]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// q.K^T of one tile: s[hf][i] = q[head 2t+i] . K[row tile0 + 8hf + g],
// before scaling.  k0 and k1 are the lane's spans of rows g and g + 8.
// ---------------------------------------------------------------------------

// Matrix, float32: two DMMA m8n8k4 chains per 8-row half.  The lane's B
// fragment is head g's span [t*DH/4, (t+1)*DH/4) of q.
template <int DH>
__device__ __forceinline__ void score_mma(const float (&k0)[DH / 4],
                                          const float (&k1)[DH / 4],
                                          const float (&qs)[DH / 4],
                                          float (&s)[2][2]) {
  double c[2][2][2] = {};  // [half][chain][column]
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) {
    const double b = qs[j];
    dmma_884(c[0][j & 1][0], c[0][j & 1][1], k0[j], b, c[0][j & 1][0],
             c[0][j & 1][1]);
    dmma_884(c[1][j & 1][0], c[1][j & 1][1], k1[j], b, c[1][j & 1][0],
             c[1][j & 1][1]);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      s[hf][i] = __double2float_rn(c[hf][0][i] + c[hf][1][i]);
}

// Matrix, bfloat16: one HMMA m16n8k16 per 16 elements of Dh.  K-slots 2t,
// 2t+1, 2t+8, 2t+9 of step kk are elements t*DH/4 + 4kk + 0..3: words 2kk
// and 2kk+1 of the lane's span.
template <int DH>
__device__ __forceinline__ void score_mma(const uint32_t (&k0)[DH / 8],
                                          const uint32_t (&k1)[DH / 8],
                                          const uint32_t (&qs)[DH / 8],
                                          float (&s)[2][2]) {
  float c[2][4] = {};  // two accumulator chains
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t a[4] = {k0[2 * kk], k1[2 * kk], k0[2 * kk + 1],
                           k1[2 * kk + 1]};
    hmma_16816_bf16(c[kk & 1], a, qs[2 * kk], qs[2 * kk + 1], c[kk & 1]);
  }
  s[0][0] = c[0][0] + c[1][0], s[0][1] = c[0][1] + c[1][1];
  s[1][0] = c[0][2] + c[1][2], s[1][1] = c[0][3] + c[1][3];
}

// Vector: partial dots over the lane's span for every head, q read from
// shared memory (sq: [head][t][DH/4 + 4], padded so that the four t lanes
// hit different banks), then a reduce-scatter over the four t lanes.
template <int DH>
__device__ __forceinline__ void score_fma(const float (&k0)[DH / 4],
                                          const float (&k1)[DH / 4],
                                          const float* sq, int heads, int t,
                                          float (&s)[2][2]) {
  constexpr int KS = DH / 4, QS = KS + 4;
  float part[2][kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    part[0][h] = part[1][h] = 0.f;
    if (h < heads) {
      const float4* q4 = reinterpret_cast<const float4*>(sq + (h * 4 + t) * QS);
#pragma unroll
      for (int j = 0; j < KS / 4; ++j) {
        const float4 qv = q4[j];
        part[0][h] = fmaf(k0[4 * j], qv.x, part[0][h]);
        part[0][h] = fmaf(k0[4 * j + 1], qv.y, part[0][h]);
        part[0][h] = fmaf(k0[4 * j + 2], qv.z, part[0][h]);
        part[0][h] = fmaf(k0[4 * j + 3], qv.w, part[0][h]);
        part[1][h] = fmaf(k1[4 * j], qv.x, part[1][h]);
        part[1][h] = fmaf(k1[4 * j + 1], qv.y, part[1][h]);
        part[1][h] = fmaf(k1[4 * j + 2], qv.z, part[1][h]);
        part[1][h] = fmaf(k1[4 * j + 3], qv.w, part[1][h]);
      }
    }
  }
  // each level keeps half of the heads and adds the partner's share of them:
  // t bit 1 picks heads 4..7 or 0..3, t bit 0 the upper or lower pair
  const bool b1 = t & 2, b0 = t & 1;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = part[hf][i], hi = part[hf][4 + i];
      r[i] = (b1 ? hi : lo) + __shfl_xor_sync(kFull, b1 ? lo : hi, 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lo = r[i], hi = r[2 + i];
      s[hf][i] = (b0 ? hi : lo) + __shfl_xor_sync(kFull, b0 ? lo : hi, 1);
    }
  }
}

// The lane's span of K as the score product takes it: raw bf16 words for
// the HMMA, float32 otherwise.
template <typename T, int DH, bool kMMA>
struct KSpan {
  float v[DH / 4];
  __device__ __forceinline__ void load(const T* p, bool ok) {
    load_span<DH / 4>(p, ok, v);
  }
};
template <int DH>
struct KSpan<__nv_bfloat16, DH, true> {
  uint32_t v[DH / 8];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, bool ok) {
    if (ok) {
      load_words<DH / 4>(p, v);
    } else {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) v[j] = 0u;
    }
  }
};

// ---------------------------------------------------------------------------
// the tile loop, one per engine
// ---------------------------------------------------------------------------

template <typename T, int DH, bool kMMA>
__device__ __forceinline__ void attention_tiles(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  constexpr int KS = DH / 4;  // a lane's span of a K row
  constexpr int VS = DH / 8;  // a lane's span of a V row = its acc chunks
  constexpr int QS = KS + 4;  // padded row of the staged q (vector engine)
  __shared__ __align__(16) float sm_p[kWarps][kTile][kMaxHeads];
  __shared__ float sm_m[kWarps * kMaxHeads], sm_l[kWarps * kMaxHeads];
  __shared__ float sm_acc[kWarps * kMaxHeads * DH];
  __shared__ __align__(16) float sm_q[kMMA ? 4 : kMaxHeads * 4 * QS];

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const size_t stride = static_cast<size_t>(sh.kh) * DH;
  const size_t head0 = (static_cast<size_t>(b) * sh.s * sh.kh + h) * DH;
  const T* kb = k + head0 + t * KS;
  const T* vb = v + head0 + g * VS;
  const T* qp = q + static_cast<size_t>(pair) * sh.g * DH;

  // the matrix engine's B fragment: head g's span [t*KS, (t+1)*KS) of q
  KSpan<T, DH, kMMA> qs;
  if constexpr (kMMA) {
    qs.load(qp + static_cast<size_t>(g) * DH + t * KS, g < sh.g);
  } else {
    for (int i = threadIdx.x; i < kMaxHeads * DH; i += kThreads) {
      const int hh = i / DH, d = i - hh * DH;
      sm_q[(hh * 4 + d / KS) * QS + d % KS] =
          hh < sh.g ? to_float(qp[i]) : 0.f;
    }
    __syncthreads();
  }

  // acc[d = g*VS + c][head 2t + i], in double on the tensor cores
  using Acc = typename std::conditional<kMMA, double, float>::type;
  Acc acc[VS][2] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads 2t, 2t+1

  // tile0 is uniform across the warp, as mma.sync and the shuffles need
  for (int tile0 = s0 + warp * kTile; tile0 < s1; tile0 += kWarps * kTile) {
    const int rows[2] = {tile0 + g, tile0 + 8 + g};
    const bool in[2] = {rows[0] < s1, rows[1] < s1};
    KSpan<T, DH, kMMA> k0, k1;
    k0.load(kb + rows[0] * stride, in[0]);
    k1.load(kb + rows[1] * stride, in[1]);
    float s[2][2];
    if constexpr (kMMA) {
      score_mma<DH>(k0.v, k1.v, qs.v, s);
    } else {
      score_fma<DH>(k0.v, k1.v, sm_q, sh.g, t, s);
    }
    float p[2][2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        s[hf][i] = rows[hf] < sh.kv_len ? s[hf][i] * sh.scale : kNegInf;
        if (in[hf]) mx = fmaxf(mx, s[hf][i]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      corr[i] = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        p[hf][i] = in[hf] ? expf(s[hf][i] - mx) : 0.f;
        psum += p[hf][i];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      l[i] = fmaf(l[i], corr[i], psum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < VS; ++c) acc[c][i] *= static_cast<Acc>(corr[i]);
    }
    // p (16 positions x 8 heads) through shared memory to the lanes that
    // multiply it into V
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 2; ++i) sm_p[warp][8 * hf + g][2 * t + i] = p[hf][i];
    __syncwarp();
    if constexpr (kMMA) {
      // B fragment: p[position 4ks + t][head g]; A: V row 4ks + t
#pragma unroll
      for (int ks = 0; ks < kTile / 4; ++ks) {
        const int r = tile0 + 4 * ks + t;
        float vs[VS];
        load_span<VS>(vb + r * stride, r < s1, vs);
        const double pb = sm_p[warp][4 * ks + t][g];
#pragma unroll
        for (int c = 0; c < VS; ++c)
          dmma_884(acc[c][0], acc[c][1], vs[c], pb, acc[c][0], acc[c][1]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTile / 4; ++ks) {
        float vs[4][VS];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = tile0 + 4 * ks + u;
          load_span<VS>(vb + r * stride, r < s1, vs[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 pu = *reinterpret_cast<const float2*>(
              &sm_p[warp][4 * ks + u][2 * t]);
#pragma unroll
          for (int c = 0; c < VS; ++c) {
            acc[c][0] = fmaf(pu.x, vs[u][c], acc[c][0]);
            acc[c][1] = fmaf(pu.y, vs[u][c], acc[c][1]);
          }
        }
      }
    }
    __syncwarp();
  }

  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm_m[warp * kMaxHeads + 2 * t + i] = m[i];
      sm_l[warp * kMaxHeads + 2 * t + i] = l[i];
    }
  }
#pragma unroll
  for (int c = 0; c < VS; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sm_acc[(warp * kMaxHeads + 2 * t + i) * DH + g * VS + c] =
          static_cast<float>(acc[c][i]);
  __syncthreads();

  // merge the warps' states; store the output (one range per pair) or this
  // range's float32 partial
  const int split = blockIdx.y;
  for (int idx = threadIdx.x; idx < sh.g * DH; idx += kThreads) {
    const int hh = idx / DH, d = idx - hh * DH;
    float mx = sm_m[hh];
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, sm_m[w * kMaxHeads + hh]);
    float lsum = 0.f, asum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w * kMaxHeads + hh] - mx);
      lsum = fmaf(sm_l[w * kMaxHeads + hh], wt, lsum);
      asum = fmaf(sm_acc[(w * kMaxHeads + hh) * DH + d], wt, asum);
    }
    if (sh.nsplit == 1) {
      out[(static_cast<size_t>(pair) * sh.g + hh) * DH + d] =
          from_float<T>(asum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t slot = static_cast<size_t>(pair) * sh.nsplit + split;
      part_acc[(slot * sh.g + hh) * DH + d] = asum;
      if (d == 0) {
        part_ml[(slot * sh.g + hh) * 2] = mx;
        part_ml[(slot * sh.g + hh) * 2 + 1] = lsum;
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_vector_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, Shape sh) {
  attention_tiles<T, DH, false>(q, k, v, out, part_ml, part_acc, sh);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_matrix_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, Shape sh) {
  attention_tiles<T, DH, true>(q, k, v, out, part_ml, part_acc, sh);
}

// ---------------------------------------------------------------------------
// merge of the ranges of one (b, h) pair: grid (pairs, G), one thread per d
// ---------------------------------------------------------------------------

template <typename T>
__global__ void attention_combine_kernel(const float* __restrict__ part_ml,
                                         const float* __restrict__ part_acc,
                                         T* __restrict__ out, Shape sh) {
  const int pair = blockIdx.x, g = blockIdx.y;
  const float* ml = part_ml + static_cast<size_t>(pair) * sh.nsplit * sh.g * 2;
  const float* ac = part_acc + static_cast<size_t>(pair) * sh.nsplit * sh.g *
                                   sh.dh;
  for (int d = threadIdx.x; d < sh.dh; d += blockDim.x) {
    float mx = ml[g * 2];
    for (int i = 1; i < sh.nsplit; ++i)
      mx = fmaxf(mx, ml[(i * sh.g + g) * 2]);
    float l = 0.f, acc = 0.f;
    for (int i = 0; i < sh.nsplit; ++i) {
      const float w = expf(ml[(i * sh.g + g) * 2] - mx);
      l = fmaf(ml[(i * sh.g + g) * 2 + 1], w, l);
      acc = fmaf(ac[(static_cast<size_t>(i) * sh.g + g) * sh.dh + d], w, acc);
    }
    out[(static_cast<size_t>(pair) * sh.g + g) * sh.dh + d] =
        from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, float* part_ml, float* part_acc,
                         int pairs, const Shape& sh, int matrix,
                         cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const dim3 grid(pairs, sh.nsplit);
  switch (sh.dh) {
#define REPRO_ATTENTION(DH)                                             \
  case DH:                                                              \
    if (matrix)                                                         \
      attention_matrix_kernel<T, DH><<<grid, kThreads, 0, s>>>(         \
          qt, kt, vt, ot, part_ml, part_acc, sh);                       \
    else                                                                \
      attention_vector_kernel<T, DH><<<grid, kThreads, 0, s>>>(         \
          qt, kt, vt, ot, part_ml, part_acc, sh);                       \
    break;
    REPRO_ATTENTION(16)
    REPRO_ATTENTION(32)
    REPRO_ATTENTION(64)
    REPRO_ATTENTION(128)
#undef REPRO_ATTENTION
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.nsplit == 1) return err;
  const int threads = sh.dh < 32 ? 32 : sh.dh;
  attention_combine_kernel<T><<<dim3(pairs, sh.g), threads, 0, s>>>(
      part_ml, part_acc, ot, sh);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING(attention)

// out (B, KH, G, Dh) = flash-decode of q (B, KH, G, Dh) over k, v
// (B, S, KH, Dh).  Each (b, h) pair's S positions are cut into nsplit ranges
// of `rows` positions; with nsplit > 1, part_ml (pairs * nsplit * G * 2) and
// part_acc (pairs * nsplit * G * Dh) float32 hold the ranges' partials.
// Both kernels take G <= 8 and Dh in {16, 32, 64, 128}.  Returns the
// cudaError_t.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, float* part_ml, float* part_acc,
                                int batch, int kh, int g, int s, int dh,
                                int kv_len, int rows, int nsplit, float scale,
                                int bf16, int matrix, void* stream) {
  if (batch < 0 || kh <= 0 || g <= 0 || g > kMaxHeads || s <= 0 ||
      rows <= 0 || nsplit <= 0 ||
      static_cast<long long>(rows) * nsplit < s ||
      static_cast<long long>(rows) * (nsplit - 1) >= s ||
      (nsplit > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const Shape sh{kh, g, s, dh, kv_len, rows, nsplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(q, k, v, out, part_ml, part_acc,
                                         batch * kh, sh, matrix, st)
           : launch_typed<float>(q, k, v, out, part_ml, part_acc, batch * kh,
                                 sh, matrix, st);
  return static_cast<int>(err);
}
