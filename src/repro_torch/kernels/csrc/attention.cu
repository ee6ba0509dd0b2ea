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
// Bound: bytes.  The positions the function needs are streamed once:
// 2 * B * L * KH * Dh * sizeof(T) bytes over the H100's 3.35 TB/s, with
// L = min(kv_len, S) (all S when kv_len <= 0), for 4 * G flops per cache
// element: far below the card's balance.  The TPU walked the S axis in
// order on one core carrying (m, l, acc) across grid steps; here the L
// positions are cut into contiguous ranges, one CTA each, so enough loads
// are in flight to cover HBM latency (kernels/_ext.py::attention_split:
// where the B * KH pairs leave CTA slots free, as many long ranges per pair
// as fill the slots once, since a CTA's start and end cost HBM time;
// otherwise one reference KV block per CTA).  No warp reads a tile that
// starts at or past `end` = L.  For kv_len >= 1 that is bit-identical to
// reading everything with the same ranges: a skipped tile would add p = 0
// with corr = 1, a skipped warp or range would be weighed by
// e^(-1e30 - m*) = 0.  Each CTA keeps its online softmax state in
// registers, merges its warps' states in shared memory, and writes one
// float32 partial (m, l, acc); a second small kernel merges the partials of
// a pair:
//     m* = max m_i,  l* = sum l_i e^(m_i - m*),  acc* = sum acc_i e^(m_i - m*),
//     out = acc* / max(l*, 1e-30).
// With one range per pair the first kernel writes the output itself.
//
// Both engines share everything but the two contractions, as the
// reference's two kernel bodies do: a warp takes 16 cache positions per
// tile; lane (g, t) (g = lane / 4, t = lane % 4) keeps the online-softmax
// state of query heads 2t and 2t+1 over the tile's positions g and g + 8.
// The heads are padded to a head tile HT of 8, the MMA's N, so G of the 8
// head columns do useful work: 4 of 8 at the Mistral-NeMo shape.  For
// 8 < G <= 16 (Qwen3-MoE: 64 query heads over 4 KV heads) the kernels are
// instantiated with HT = 16, two N tiles: lane (g, t) then keeps heads 2t,
// 2t+1, 2t+8 and 2t+9, every MMA of a tile is issued once per N tile on
// the same K / V fragments, and each K and V row is still read once for
// all G heads of its pair.  HT is a template parameter, so the G <= 8
// kernels are compiled as before.  The float32 matrix kernel at HT = 16
// keeps q in shared memory and its accumulator in float, each tile's p.V
// summed exactly in double by DMMA and rounded once: a double accumulator
// of 16 heads x Dh would take 128 registers a lane.
//
// float32, G <= 8 (both engines: attention_{vector,matrix}_ring_kernel):
// each lane takes elements [t*Dh/4, (t+1)*Dh/4) of K rows g and g + 8 and
// elements [g*Dh/8, (g+1)*Dh/8) of V rows from a ring in shared memory,
// which a producer warp fills ahead of the four consumer warps with the
// TMA's bulk copies, each stage completing on an mbarrier (below, "K and
// V staged through a TMA-fed ring").  The matrix kernel at G > 8 loads the
// same spans straight from global memory.
//   Matrix: q.K^T and p.V on DMMA m8n8k4 on values converted to double
//   (q.K^T with positions on M and heads on N; p.V with V^T on M, heads on
//   N, 4 positions on K), products exact.
//   Vector, G <= 8: the same products as FFMAs; each lane takes partial
//   dots over its K span for every head (q staged in shared memory), and a
//   reduce-scatter over the four t lanes (12 shuffles per tile) leaves it
//   the full scores of heads 2t and 2t+1; p.V walks the tile's 16 V rows,
//   each lane its own span.
//   Vector, 8 < G <= 16: its own kernel (attention_tiles_f32_h16, below).
//   At 16 heads its FFMA floor is 40% of the byte bound (0.056 against
//   0.140 ms at Qwen3-MoE's decode shape), so the kernel is bound by bytes
//   once no load waits in a lane's dependency chain.  It takes the
//   bfloat16 kernel's maps: K and V staged by cp.async a half-stage ahead
//   of the compute, each element read from global memory once and from
//   shared memory once for all 16 heads, one CTA of 144 KB per SM.
// bfloat16: a tile of K and V is 8 KiB at Dh = 128, about 640 SM clocks at
// the datasheet HBM rate, half of float32's budget for the same
// instructions per element.  So the tiles are staged: each warp streams its
// tiles through a ring of kRing stages in shared memory with cp.async, two
// tiles ahead of the one it computes, and no load sits in a lane's
// dependency chain.
//   Matrix: q.K^T on HMMA m16n8k16 (K tile from ldmatrix as A, q as B in
//   registers).  p.V on HMMA as well: p is split into two bfloat16 terms,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), |p - p_hi - p_lo| <= 2^-16 p,
//   and each 16 positions x 16 of Dh take two HMMAs (V^T from ldmatrix.trans
//   as A, p_hi then p_lo as B) into one float32 accumulator; V's products
//   are exact.  This replaces 64 DMMAs, ~2176 conversions to double and 32
//   double rescales per warp tile by 16 HMMAs and 32 float rescales.
//   Vector, G <= 8: scores as in float32 but read from the stage (one
//   shift or mask per bfloat16 value), for NH heads, G rounded up to a
//   power of two, each head's FFMAs unrolled and independent of the
//   others; p.V gives each lane 4 elements of Dh for those heads (none
//   padded at G = 4) over its share of the tile's positions, each V
//   element read from the stage by one lane only.  q stays staged in
//   shared memory: the eight g lanes read the same words, one broadcast
//   per load.
//   Vector, 8 < G <= 16: its own kernel (attention_tiles_bf16_h16, below),
//   register-blocked for the CUDA cores' FFMA issue rate: 32-position
//   tiles per warp, each K and V element unpacked once for all 16 heads.
// Dh 112 and 160 (Zamba2-7B, StableLM-2-12B) split a row into quarters of
// 28 and 40 elements and into 28 and 40 groups of 4, which do not divide a
// warp: the staged rows are padded to whole swizzle periods, and the maps
// below say where each takes a different path.
// The merge of the ranges is launched as a programmatic dependent of the
// range kernel, so it is scheduled while the range kernel's last CTAs run.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

// The call's shape, passed by value to the kernels; in a named namespace
// because the per-head-dim launchers below link across objects.
namespace repro_attention {
struct Shape {
  int kh;       // KV heads
  int g;        // query heads per KV head
  int s;        // cache length
  int dh;       // head dim
  int kv_len;   // positions >= kv_len are masked
  int end;      // positions >= end are never read
  int rows;     // cache positions per CTA
  int nsplit;   // CTAs per (b, h) pair
  float scale;  // 1 / sqrt(Dh), rounded as the reference rounds it
};
}  // namespace repro_attention

namespace {

using repro_attention::Shape;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kMaxHeads = 16;      // query heads per KV head: 2 MMA N tiles
constexpr int kTile = 16;          // cache positions per warp tile
constexpr int kRing = 3;           // bfloat16: tiles in a warp's ring

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

// The query head of lane slot j (j < HT / 4) of lane t: 2t, 2t+1 in the
// first N tile, 2t+8, 2t+9 in the second.
__device__ __forceinline__ int lane_head(int j, int t) {
  return 8 * (j >> 1) + 2 * t + (j & 1);
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

// Vector: partial dots over the lane's span for the first min(NH, heads)
// heads, q read from
// shared memory (sq: [head][t][DH/4 + 4], padded so that the four t lanes
// hit different banks; the eight g lanes read the same words, one
// broadcast), then a reduce-scatter over the four t lanes, one per N tile
// of 8 heads.
template <int DH, int NH, int HT>
__device__ __forceinline__ void score_fma(const float (&k0)[DH / 4],
                                          const float (&k1)[DH / 4],
                                          const float* sq, int heads, int t,
                                          float (&s)[2][HT / 4]) {
  constexpr int KS = DH / 4, QS = KS + 4;
  float part[2][HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    part[0][h] = part[1][h] = 0.f;
    if (h < NH && h < heads) {
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
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < HT / 8; ++n) {
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = part[hf][8 * n + i], hi = part[hf][8 * n + 4 + i];
        r[i] = (b1 ? hi : lo) + __shfl_xor_sync(kFull, b1 ? lo : hi, 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float lo = r[i], hi = r[2 + i];
        s[hf][2 * n + i] =
            (b0 ? hi : lo) + __shfl_xor_sync(kFull, b0 ? lo : hi, 1);
      }
    }
}

// The online-softmax step shared by every path: scale and mask the tile's
// scores s (positions rows[hf], heads lane_head(j, t)), update (m, l), and
// return the probabilities p and the old state's factor corr.
template <int NI>
__device__ __forceinline__ void softmax_step(float (&s)[2][NI],
                                             const int (&rows)[2],
                                             const bool (&in)[2],
                                             const Shape& sh, float (&m)[NI],
                                             float (&l)[NI], float (&p)[2][NI],
                                             float (&corr)[NI]) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
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
  }
}

// Merge the CTA's warps' states (sm_m, sm_l: [warp][head]; sm_acc:
// [warp][head][DH]); store the output (one range per pair) or this range's
// float32 partial.
template <typename T, int DH, int HT>
__device__ __forceinline__ void merge_warps(const float* sm_m,
                                            const float* sm_l,
                                            const float* sm_acc,
                                            T* __restrict__ out,
                                            float* __restrict__ part_ml,
                                            float* __restrict__ part_acc,
                                            const Shape& sh) {
  const int pair = blockIdx.x, split = blockIdx.y;
  for (int idx = threadIdx.x; idx < sh.g * DH; idx += kThreads) {
    const int hh = idx / DH, d = idx - hh * DH;
    float mx = sm_m[hh];
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, sm_m[w * HT + hh]);
    float lsum = 0.f, asum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w * HT + hh] - mx);
      lsum = fmaf(sm_l[w * HT + hh], wt, lsum);
      asum = fmaf(sm_acc[(w * HT + hh) * DH + d], wt, asum);
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

// ---------------------------------------------------------------------------
// float32, matrix engine at a head tile of 16: the tile loop with direct
// loads
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void attention_tiles_f32_mma16(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  constexpr int HT = 16;
  constexpr int KS = DH / 4;  // a lane's span of a K row
  constexpr int VS = DH / 8;  // a lane's span of a V row = its acc chunks
  constexpr int QS = KS + 4;  // padded row of the staged q
  constexpr int NI = HT / 4;  // heads per lane
  constexpr int NT = HT / 8;  // MMA N tiles
  constexpr int kAccN = kWarps * HT * DH, kQN = HT * 4 * QS;
  // sm_q is read only in the tile loop and sm_acc written only after it:
  // where the arrays exceed the 48 KB of static shared memory (Dh 160:
  // 56.8 KB), sm_acc takes sm_q's place
  constexpr bool kAccInQ =
      (kAccN + kQN + kWarps * kTile * HT + 2 * kWarps * HT) * 4 > 48 * 1024;
  __shared__ __align__(16) float sm_p[kWarps][kTile][HT];
  __shared__ float sm_m[kWarps * HT], sm_l[kWarps * HT];
  __shared__ float sm_acc_own[kAccInQ ? 1 : kAccN];
  __shared__ __align__(16) float sm_q[kAccInQ && kAccN > kQN ? kAccN : kQN];
  float* const sm_acc = kAccInQ ? sm_q : sm_acc_own;

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const int e1 = min(s1, sh.end);  // no tile starts at or past `end`
  const size_t stride = static_cast<size_t>(sh.kh) * DH;
  const size_t head0 = (static_cast<size_t>(b) * sh.s * sh.kh + h) * DH;
  const float* kb = k + head0 + t * KS;
  const float* vb = v + head0 + g * VS;
  const float* qp = q + static_cast<size_t>(pair) * sh.g * DH;

  for (int i = threadIdx.x; i < HT * DH; i += kThreads) {
    const int hh = i / DH, d = i - hh * DH;
    sm_q[(hh * 4 + d / KS) * QS + d % KS] = hh < sh.g ? qp[i] : 0.f;
  }
  __syncthreads();

  // acc[d = g*VS + c][head lane_head(j, t)]
  float acc[VS][NI] = {};
  float m[NI], l[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) m[j] = kNegInf, l[j] = 0.f;

  // tile0 is uniform across the warp, as mma.sync and the shuffles need
  for (int tile0 = s0 + warp * kTile; tile0 < e1; tile0 += kWarps * kTile) {
    const int rows[2] = {tile0 + g, tile0 + 8 + g};
    const bool in[2] = {rows[0] < s1, rows[1] < s1};
    float k0[KS], k1[KS];
    load_span<KS>(kb + rows[0] * stride, in[0], k0);
    load_span<KS>(kb + rows[1] * stride, in[1], k1);
    float s[2][NI];
    // one N tile at a time, its B fragment from the staged q
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float qn[KS];
      const float4* q4 =
          reinterpret_cast<const float4*>(sm_q + ((8 * nt + g) * 4 + t) * QS);
#pragma unroll
      for (int j = 0; j < KS / 4; ++j) {
        const float4 x = q4[j];
        qn[4 * j] = x.x, qn[4 * j + 1] = x.y, qn[4 * j + 2] = x.z,
        qn[4 * j + 3] = x.w;
      }
      float sn[2][2];
      score_mma<DH>(k0, k1, qn, sn);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 2; ++i) s[hf][2 * nt + i] = sn[hf][i];
    }
    float p[2][NI], corr[NI];
    softmax_step<NI>(s, rows, in, sh, m, l, p, corr);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int c = 0; c < VS; ++c) acc[c][i] *= corr[i];
    // p (16 positions x HT heads) through shared memory to the lanes that
    // multiply it into V
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        sm_p[warp][8 * hf + g][lane_head(j, t)] = p[hf][j];
    __syncwarp();
    // the tile's p.V exactly in double, one Dh chunk c at a time, then
    // rounded once into the float accumulator: A = V rows 4ks + t (all
    // four loaded first), B = p[position 4ks + t][head 8nt + g]
    float vr[kTile / 4][VS];
    double pb[kTile / 4][NT];
#pragma unroll
    for (int ks = 0; ks < kTile / 4; ++ks) {
      const int r = tile0 + 4 * ks + t;
      load_span<VS>(vb + r * stride, r < s1, vr[ks]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        pb[ks][nt] = sm_p[warp][4 * ks + t][8 * nt + g];
    }
#pragma unroll
    for (int c = 0; c < VS; ++c) {
      double d[NT][2] = {};
#pragma unroll
      for (int ks = 0; ks < kTile / 4; ++ks)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dmma_884(d[nt][0], d[nt][1], vr[ks][c], pb[ks][nt], d[nt][0],
                   d[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          acc[c][2 * nt + i] += __double2float_rn(d[nt][i]);
    }
    __syncwarp();
  }

  if constexpr (kAccInQ) __syncthreads();  // every warp is done with sm_q
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      sm_m[warp * HT + lane_head(j, t)] = m[j];
      sm_l[warp * HT + lane_head(j, t)] = l[j];
    }
  }
#pragma unroll
  for (int c = 0; c < VS; ++c)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      sm_acc[(warp * HT + lane_head(j, t)) * DH + g * VS + c] = acc[c][j];
  __syncthreads();
  merge_warps<float, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml, part_acc, sh);
}

// ---------------------------------------------------------------------------
// bfloat16: K and V staged through a ring in shared memory
// ---------------------------------------------------------------------------

// The 16-byte chunk c of staged row r sits at r * RC + (c ^ (r % SW)), so
// that the eight row addresses of an ldmatrix phase (eight rows, one chunk)
// fall in eight bank groups.  RC is the row's CH chunks rounded up to whole
// swizzle periods (Dh 112: 16, Dh 160: 24), so that c ^ (r % SW) stays in
// the row for every c < CH; at the power-of-two head dims RC = CH.
template <int DH>
struct Swizzle {
  static constexpr int CH = DH / 8;           // 16-byte chunks per row
  static constexpr int SW = CH < 8 ? CH : 8;  // swizzle period
  static constexpr int RC = (CH + SW - 1) / SW * SW;
  static __device__ __forceinline__ int at(int r, int c) {
    return r * RC + (c ^ (r & (SW - 1)));
  }
};

// One stage: the K and V rows of a 16-position tile.
template <int DH>
struct KVTile : Swizzle<DH> {
  uint4 k[kTile * Swizzle<DH>::RC];
  uint4 v[kTile * Swizzle<DH>::RC];
};

// The rest of the bfloat16 kernels' shared memory, after the ring: p^T
// (heads x positions) per warp, the warps' (m, l), and q staged as float32
// (vector engine; [head][t][DH/4 + 4]).  After the tile loop sm_acc reuses
// the ring.
template <int DH, int HT>
struct Aux {
  float p[kWarps][HT][kTile];
  float m[kWarps * HT], l[kWarps * HT];
  float q[HT * 4 * (DH / 4 + 4)];
};

template <int DH>
__host__ __device__ constexpr int ring_bytes() {
  return kWarps * kRing * static_cast<int>(sizeof(KVTile<DH>));
}
template <int DH, int HT>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<DH>() + static_cast<int>(sizeof(Aux<DH, HT>));
}

// cp.async of tile rows tile0 .. tile0 + 15 of K and V into a stage; rows at
// or past s1 (a range's ragged end) are zero-filled, not fetched.
template <int DH>
__device__ __forceinline__ void stage_tile(KVTile<DH>& st,
                                           const __nv_bfloat16* kb,
                                           const __nv_bfloat16* vb,
                                           size_t stride, int tile0, int s1,
                                           int lane) {
  constexpr int CH = KVTile<DH>::CH;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const int idx = lane + 32 * i, r = idx / CH, c = idx % CH;
    const bool ok = tile0 + r < s1;
    const size_t off = static_cast<size_t>(ok ? tile0 + r : tile0) * stride +
                       c * 8;
    cp_async16(&st.k[KVTile<DH>::at(r, c)], kb + off, ok);
    cp_async16(&st.v[KVTile<DH>::at(r, c)], vb + off, ok);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Vector engine: the lane's span [t*DH/4, (t+1)*DH/4) of staged K row r.
template <int DH>
__device__ __forceinline__ void k_span(const KVTile<DH>& st, int r, int t,
                                       float (&o)[DH / 4]) {
  using Tile = KVTile<DH>;
  constexpr int KS = DH / 4;  // elements per span
  uint32_t w[DH / 8];
  if constexpr (KS % 8 == 0) {
    constexpr int KC = KS / 8;  // whole chunks per span
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const uint4 x = st.k[Tile::at(r, t * KC + j)];
      w[4 * j] = x.x, w[4 * j + 1] = x.y, w[4 * j + 2] = x.z,
      w[4 * j + 3] = x.w;
    }
  } else {
    // half chunks of 4 elements (Dh 16: one; Dh 112: seven, the span
    // starting mid-chunk for odd t)
#pragma unroll
    for (int u = 0; u < KS / 4; ++u) {
      const int d0 = t * KS + 4 * u;
      const uint2 x = reinterpret_cast<const uint2*>(
          &st.k[Tile::at(r, d0 >> 3)])[(d0 >> 2) & 1];
      w[2 * u] = x.x, w[2 * u + 1] = x.y;
    }
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    o[2 * j] = bf16_lo(w[j]), o[2 * j + 1] = bf16_hi(w[j]);
}

// p as two bfloat16 terms, packed in pairs as an HMMA B register takes them.
__device__ __forceinline__ void split_bf16(float2 p, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(p.x - bf16_lo(hi), p.y - bf16_hi(hi));
  lo = reinterpret_cast<const uint32_t&>(r);
}

// NH: the vector engine's heads, a power of two >= G (the matrix engine
// always takes HT, one or two MMA N tiles); HT: the head tile, 8 or 16
template <int DH, bool kMMA, int NH, int HT>
__device__ __forceinline__ void attention_tiles_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  using Tile = KVTile<DH>;
  constexpr int KS = DH / 4;       // vector scores: a lane's span of a K row
  constexpr int QS = KS + 4;       // padded row of the staged q
  // vector p.V: NG groups of 4 Dh elements; where they divide the warp, LR
  // lanes per V row, 4 elements each, and 32 / LR position groups; else
  // (Dh 112, 160) every lane takes all positions and the groups lane +
  // 32u, u < NU (Dh 112: lanes 28..31 idle; Dh 160: lanes 0..7 take two)
  constexpr int NG = DH / 4;
  constexpr bool kRowSplit = 32 % NG == 0;
  constexpr int LR = kRowSplit ? NG : 32;  // lanes per V row
  constexpr int NU = (NG + 31) / 32;       // element groups per lane
  constexpr int NP = kTile * LR / 32;  // its positions per lane and tile
  constexpr int NI = HT / 4;           // heads per lane
  constexpr int NT = HT / 8;           // MMA N tiles
  static_assert(kWarps * HT * DH * 4 <= ring_bytes<DH>(),
                "sm_acc must fit in the ring it reuses");
  extern __shared__ __align__(16) unsigned char smem[];
  Aux<DH, HT>& aux =
      *reinterpret_cast<Aux<DH, HT>*>(smem + ring_bytes<DH>());
  auto& sm_p = aux.p;
  float* sm_m = aux.m;
  float* sm_l = aux.l;
  float* sm_q = aux.q;

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const int e1 = min(s1, sh.end);  // no tile starts at or past `end`
  const size_t stride = static_cast<size_t>(sh.kh) * DH;
  const size_t head0 = (static_cast<size_t>(b) * sh.s * sh.kh + h) * DH;
  const __nv_bfloat16* qp = q + static_cast<size_t>(pair) * sh.g * DH;
  Tile* ring = reinterpret_cast<Tile*>(smem) + warp * kRing;

  // matrix: acc[dc][4nt ..] is the HMMA C fragment of Dh rows 16dc + g
  // (+ 8) and heads 8nt + 2t, 8nt + 2t + 1; vector: acc[4u + e][head] for
  // Dh element 4 * (lane % LR + 32u) + e
  float acc[kMMA ? DH / 16 : 4 * NU][kMMA ? 4 * NT : HT] = {};
  float m[NI], l[NI];  // heads lane_head(j, t)
#pragma unroll
  for (int j = 0; j < NI; ++j) m[j] = kNegInf, l[j] = 0.f;

  // this warp's tiles start at first + i * kWarps * kTile, i < n (uniform
  // across the warp, as mma.sync and the shuffles need)
  const int first = s0 + warp * kTile;
  const int n = first < e1 ? (e1 - first + kWarps * kTile - 1) /
                                 (kWarps * kTile)
                           : 0;
  auto issue = [&](int i) {
    stage_tile<DH>(ring[i % kRing], k + head0, v + head0, stride,
                   first + i * kWarps * kTile, s1, lane);
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  // with the first tiles in flight: q as the score HMMA's B fragments
  // (matrix; (2t, 2t+1) and (2t+8, 2t+9) of head 8nt + g's 16-element step
  // kk), or staged in shared memory as float32 (vector)
  uint32_t qf[kMMA ? NT : 1][kMMA ? DH / 16 : 1][2];
  if constexpr (kMMA) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bool ok = 8 * nt + g < sh.g;
      const unsigned int* q32 = reinterpret_cast<const unsigned int*>(
          qp + static_cast<size_t>(ok ? 8 * nt + g : 0) * DH + 2 * t);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        qf[nt][kk][0] = ok ? __ldg(q32 + 8 * kk) : 0u;
        qf[nt][kk][1] = ok ? __ldg(q32 + 8 * kk + 4) : 0u;
      }
    }
  } else {
    for (int i = threadIdx.x; i < HT * DH; i += kThreads) {
      const int hh = i / DH, d = i - hh * DH;
      sm_q[(hh * 4 + d / KS) * QS + d % KS] =
          hh < sh.g ? __bfloat162float(qp[i]) : 0.f;
    }
    __syncthreads();
  }

  for (int i = 0; i < n; ++i) {
    if (i + kRing - 1 < n) issue(i + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // this lane's copies of tile i landed
    __syncwarp();                // and every other lane's
    const Tile& st = ring[i % kRing];
    const int tile0 = first + i * kWarps * kTile;
    const int rows[2] = {tile0 + g, tile0 + 8 + g};
    const bool in[2] = {rows[0] < s1, rows[1] < s1};
    float s[2][NI];
    if constexpr (kMMA) {
      // A: positions on M from ldmatrix (matrix j: rows 8(j & 1) + 0..7,
      // chunk 2kk + j / 2), shared by the N tiles; two accumulator chains
      const int r = (lane & 7) + 8 * ((lane >> 3) & 1), hc = lane >> 4;
      float c[2][NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &st.k[Tile::at(r, 2 * kk + hc)]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          hmma_16816_bf16(c[kk & 1][nt], a, qf[nt][kk][0], qf[nt][kk][1],
                          c[kk & 1][nt]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[0][2 * nt] = c[0][nt][0] + c[1][nt][0];
        s[0][2 * nt + 1] = c[0][nt][1] + c[1][nt][1];
        s[1][2 * nt] = c[0][nt][2] + c[1][nt][2];
        s[1][2 * nt + 1] = c[0][nt][3] + c[1][nt][3];
      }
    } else {
      float k0[KS], k1[KS];
      k_span<DH>(st, g, t, k0);
      k_span<DH>(st, g + 8, t, k1);
      score_fma<DH, NH, HT>(k0, k1, sm_q, NH, t, s);
    }
    float p[2][NI], corr[NI];
    softmax_step<NI>(s, rows, in, sh, m, l, p, corr);
    // p^T (HT heads x 16 positions) through shared memory to the lanes
    // that multiply it into V
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        sm_p[warp][lane_head(j, t)][8 * hf + g] = p[hf][j];
    __syncwarp();
    if constexpr (kMMA) {
#pragma unroll
      for (int dc = 0; dc < DH / 16; ++dc)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            acc[dc][4 * nt + i2] *= corr[2 * nt + i2];
            acc[dc][4 * nt + 2 + i2] *= corr[2 * nt + i2];
          }
      // B: p[positions 2t, 2t+1 (+ 8)][head 8nt + g], split in two bf16
      // terms
      uint32_t ph[NT][2], pl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          split_bf16(*reinterpret_cast<const float2*>(
                         &sm_p[warp][8 * nt + g][2 * t + 8 * j]),
                     ph[nt][j], pl[nt][j]);
      // A: V^T from ldmatrix.trans (matrix j: positions 8(j / 2) + 0..7,
      // chunk 2dc + (j & 1)), shared by the N tiles
      const int r = (lane & 7) + 8 * (lane >> 4), hc = (lane >> 3) & 1;
#pragma unroll
      for (int dc = 0; dc < DH / 16; ++dc) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, &st.v[Tile::at(r, 2 * dc + hc)]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(&acc[dc][4 * nt]);
          hmma_16816_bf16(d, a, ph[nt][0], ph[nt][1], d);
          hmma_16816_bf16(d, a, pl[nt][0], pl[nt][1], d);
        }
      }
    } else {
      // lane = rg * LR + dl owns Dh elements 4dl .. 4dl + 3 (and 4(dl +
      // 32u) .. + 3) of positions rg * NP .. rg * NP + NP - 1, for heads
      // 0 .. NH - 1
      const int rg = lane / LR, dl = lane % LR;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int gu = dl + 32 * u;
        float vv[NP][4];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          uint2 w = {0u, 0u};
          if (kRowSplit || gu < NG)
            w = reinterpret_cast<const uint2*>(
                &st.v[Tile::at(rg * NP + j, gu >> 1)])[gu & 1];
          vv[j][0] = bf16_lo(w.x), vv[j][1] = bf16_hi(w.x);
          vv[j][2] = bf16_lo(w.y), vv[j][3] = bf16_hi(w.y);
        }
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          // head hh's factor, from lane t = (hh % 8) / 2, slot
          // 2(hh / 8) + hh % 2
          const float ch = __shfl_sync(
              kFull, corr[2 * (hh >> 3) + (hh & 1)], (hh & 7) >> 1);
          float pv[NP];
          const float* ps = &sm_p[warp][hh][rg * NP];
          if constexpr (NP % 4 == 0) {
#pragma unroll
            for (int j = 0; j < NP; j += 4) {
              const float4 x = reinterpret_cast<const float4*>(ps)[j / 4];
              pv[j] = x.x, pv[j + 1] = x.y, pv[j + 2] = x.z, pv[j + 3] = x.w;
            }
          } else {
            const float2 x = *reinterpret_cast<const float2*>(ps);
            pv[0] = x.x, pv[1] = x.y;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * u + e][hh] *= ch;
#pragma unroll
            for (int j = 0; j < NP; ++j)
              acc[4 * u + e][hh] = fmaf(pv[j], vv[j][e], acc[4 * u + e][hh]);
          }
        }
      }
    }
    __syncwarp();  // sm_p and the stage are rewritten after this
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: sm_acc reuses it
  float* sm_acc = reinterpret_cast<float*>(smem);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      sm_m[warp * HT + lane_head(j, t)] = m[j];
      sm_l[warp * HT + lane_head(j, t)] = l[j];
    }
  }
  if constexpr (kMMA) {
#pragma unroll
    for (int dc = 0; dc < DH / 16; ++dc)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sm_acc[(warp * HT + 8 * nt + 2 * t + i) * DH + 16 * dc + 8 * hf +
                   g] = acc[dc][4 * nt + 2 * hf + i];
  } else {
    // add the position groups' sums: lanes dl, dl + LR, ...
#pragma unroll
    for (int off = LR; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          acc[e][hh] += __shfl_xor_sync(kFull, acc[e][hh], off);
    if (lane < LR) {
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (kRowSplit || lane + 32 * u < NG) {
#pragma unroll
          for (int hh = 0; hh < HT; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sm_acc[(warp * HT + hh) * DH + 4 * (lane + 32 * u) + e] =
                  acc[4 * u + e][hh];
        }
    }
  }
  __syncthreads();
  merge_warps<__nv_bfloat16, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml,
                                     part_acc, sh);
}

// ---------------------------------------------------------------------------
// vector engine, head tile 16: register-blocked FFMA tiles, K / V staged
// ---------------------------------------------------------------------------
//
// At 16 query heads a cache element costs 16 FFMAs in each contraction
// (1.88 G at Qwen3-MoE's decode shape, about 0.056 ms of the CUDA cores at
// 1.98 GHz), and an FFMA issues at the warp schedulers' full rate: every
// other instruction takes an FFMA's slot.  That floor is 80% of the byte
// bound in bfloat16 (0.070 ms) and 40% in float32 (0.140 ms).  So the
// design counts instructions per FFMA and keeps every global load out of a
// lane's dependency chain.  Both dtypes take the same maps, one kernel
// each (attention_tiles_bf16_h16, attention_tiles_f32_h16).
// - Each warp owns 32-position tiles (first + i * kWarps * 32) and its own
//   online-softmax state, merged with the other warps' once per range
//   (merge_warps).  Its tiles stream through a ring of L::STAGES
//   half-stages in shared memory (a tile's K rows, then its V rows: 8 KB
//   each at Dh 128 in bfloat16, 16 KB in float32) by cp.async, STAGES - 1
//   half-stages ahead of the one it computes.  All warps run the same
//   number of tiles, so the compiler sees converged warps around the
//   shuffles (no collective fallback code).
// - q.K^T: lane (t = lane / 8, g = lane % 8) sums over d-slice t (a
//   quarter of Dh) for all 16 heads and four rows g + 8(t ^ i), i < 4.
//   Each K element is read (bfloat16: unpacked) once, by one lane, for 16
//   FFMAs; q is staged once per CTA as float32 [d][head], pre-scaled by
//   log2(e) / sqrt(Dh), and each broadcast LDS.128 of it (4 heads of one
//   d) feeds 16 FFMAs.  Register i holds row g + 8(t ^ i), so the four
//   slices of a row meet in two shuffle levels without selects (lane t
//   keeps register 0, receives the partner's 2 and 3, then 1): 48 shuffles
//   and adds per tile for 2048 FFMAs.  The lane ends with the 16 scores of
//   row g + 8t.
// - Softmax in log2 units: p = 2^(s - m) is a subtract and one MUFU.EX2.
//   The running max moves only when a vote finds a score more than kLift
//   above it, so after the first tiles a tile pays one vote, not a warp
//   max and a rescale per head.
// - p.V: p through shared memory (2 KB per warp, broadcast reads); lane l
//   owns Dh elements 4l .. 4l + 3 of all 16 heads: per position four
//   LDS.128 of p, one load of the 4 V elements (bfloat16: LDS.64 and 4
//   unpacks; float32: LDS.128) and 64 FFMAs.
// - The contractions run as loops of 8-element (bfloat16 q.K^T), 4-element
//   (float32 q.K^T) and 8-row (p.V) bodies, not fully unrolled: the whole
//   tile unrolled is 13k instructions, too large for the instruction
//   caches (0.186 against 0.135 ms in bfloat16, tools/attention_variant.py).
// Per lane and tile at Dh 128: 4096 FFMAs and about 1500 other
// instructions in bfloat16.  Dh 112 and 160 take the same maps with
// 4-element K loads (bfloat16 Dh 112) and a second p.V element group for
// lanes 0..7 (Dh 160).
constexpr int kTileH = 32;  // positions per warp tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLift = 8.f;  // log2 units: the running max's slack
constexpr int kBlockSmem = 227 * 1024;  // shared memory a block may take

// The swizzle of a staged row of DH elements of T.  Swizzle counts
// bfloat16 elements: a float32 row of DH is a row of 2 DH of them, DH / 4
// chunks.
template <typename T, int DH>
using RowSwizzle = Swizzle<DH * static_cast<int>(sizeof(T)) / 2>;

// Dynamic shared memory: the warps' rings of STAGES half-stages, q ([d][16]
// float32, the head quads of d-slice t rotated by t, so that the four
// slices' broadcast loads fall in different bank groups), p per warp
// ([32][16], quads of row r rotated by r / 2 for the same reason on the
// lanes' stores).  After the tile loop the ring holds sm_acc and the
// warps' (m, l).  A warp's ring holds three half-stages in bfloat16 and
// two in float32, where one half-stage ahead is as many bytes in flight
// (and three would pass a block's 227 KB at Dh 160): 112 KB at Dh 128 in
// bfloat16, 144 KB in float32.
template <typename T, int DH>
struct H16Layout {
  using Z = RowSwizzle<T, DH>;
  static constexpr int HALF = kTileH * Z::RC;  // uint4 per half-stage
  static constexpr int Q = DH * 16 * 4;
  static constexpr int P = kWarps * kTileH * 16 * 4;
  static constexpr int STAGES = sizeof(T) == 2 ? 3 : 2;
  static constexpr int RING = kWarps * STAGES * HALF * 16;
  static constexpr int BYTES = RING + Q + P;
  static_assert(BYTES <= kBlockSmem, "the layout must fit one block");
  static_assert((kWarps * 16 * DH + 2 * kWarps * 16) * 4 <= RING,
                "sm_acc and (m, l) must fit in the ring they reuse");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of rows row0 .. row0 + 31 of K or V into a half-stage; rows at
// or past `bound` are not fetched.  Where a row's chunks divide the warp
// (Dh <= 128) the lane copies chunk c = lane % CH of rows lane / CH +
// i * (32 / CH): its source steps by whole rows and its swizzled chunk is
// c with a constant XOR, about six instructions a copy; rows past `bound`
// keep the stage's earlier contents (zero, or finite cache rows: p = 0
// multiplies them).  Else (Dh 112, 160) each copy maps its own row and
// chunk, and rows past `bound` are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(uint4* dst, const T* src,
                                           size_t stride, int row0, int bound,
                                           int lane) {
  using Z = RowSwizzle<T, DH>;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  if constexpr (32 % Z::CH == 0) {
    constexpr int RPI = 32 / Z::CH;  // rows a pass of the warp copies
    const int rl = lane / Z::CH, c = lane % Z::CH, lim = bound - row0;
    const T* p = src + static_cast<size_t>(row0 + rl) * stride + c * E;
#pragma unroll
    for (int i = 0; i < kTileH / RPI; ++i) {
      const int r = rl + i * RPI;
      // r % SW: rl's bits, then i * RPI's (RPI divides SW or covers it)
      const int phys = RPI >= Z::SW ? c ^ (rl & (Z::SW - 1))
                                    : c ^ rl ^ ((i * RPI) & (Z::SW - 1));
      if (r < lim) cp_async16(&dst[r * Z::RC + phys], p);
      p += RPI * stride;
    }
  } else {
#pragma unroll
    for (int i = 0; i < Z::CH; ++i) {  // kTileH * CH chunks, 32 a pass
      const int idx = lane + 32 * i, r = idx / Z::CH, c = idx - r * Z::CH;
      const bool ok = row0 + r < bound;
      const size_t off = static_cast<size_t>(ok ? row0 + r : 0) * stride +
                         c * E;
      cp_async16(&dst[Z::at(r, c)], src + off, ok);
    }
  }
}

template <int DH>
__device__ __forceinline__ void attention_tiles_bf16_h16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  using Z = Swizzle<DH>;
  using L = H16Layout<__nv_bfloat16, DH>;
  constexpr int HT = 16, R = L::STAGES;
  static_assert(R == 3, "the prologue stages two half-stages ahead");
  constexpr int KS = DH / 4;              // q.K^T: elements of a d-slice
  constexpr int W = KS % 8 == 0 ? 8 : 4;  // elements per K load
  // p.V: NG groups of 4 elements; where they divide the warp, LR lanes per
  // V row and 32 / LR row groups of NP rows, else (Dh 112, 160) all 32
  // rows per lane and the groups lane + 32u, u < NU
  constexpr int NG = DH / 4;
  constexpr bool kRowSplit = 32 % NG == 0;
  constexpr int LR = kRowSplit ? NG : 32;
  constexpr int NU = (NG + 31) / 32;
  constexpr int NP = kTileH * LR / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sm_q = reinterpret_cast<float*>(smem + L::RING);

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const int e1 = min(s1, sh.end);  // no tile starts at or past `end`
  const size_t stride = static_cast<size_t>(sh.kh) * DH;
  const size_t head0 = (static_cast<size_t>(b) * sh.s * sh.kh + h) * DH;
  const __nv_bfloat16* qp = q + static_cast<size_t>(pair) * sh.g * DH;
  uint4* const ring = reinterpret_cast<uint4*>(smem) + warp * R * L::HALF;
  float* const pw = reinterpret_cast<float*>(smem + L::RING + L::Q) +
                    warp * kTileH * HT;

  // this warp's tiles start at first + i * kWarps * kTileH, i < n: every
  // warp takes n rounds (n from the CTA's range alone, so that the
  // compiler sees a loop all lanes run together), and rows at or past e1
  // are neither read (zero-filled) nor counted (p = 0), as a warp's tile
  // past `end` would not be read.  Half stage j is tile j / 2's K (j even)
  // or V (j odd) rows
  const int first = s0 + warp * kTileH;
  const int n = (e1 - s0 + kWarps * kTileH - 1) / (kWarps * kTileH);
  auto issue = [&](int j) {
    if (j < 2 * n)
      stage_rows<__nv_bfloat16, DH>(ring + (j % R) * L::HALF,
                                    ((j & 1) ? v : k) + head0, stride,
                                    first + (j >> 1) * kWarps * kTileH, e1,
                                    lane);
    cp_async_commit();
  };
  if constexpr (32 % Z::CH == 0) {
    // rows past e1 are not fetched: the stage starts zeroed
    for (int i = lane; i < R * L::HALF; i += 32)
      ring[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }
  issue(0);
  issue(1);
  // with the first tiles in flight: q in log2 units, 8 elements a load
  const float qscale = sh.scale * kLog2e;
  for (int i = threadIdx.x; i < HT * DH / 8; i += kThreads) {
    const int hh = i / (DH / 8), d0 = (i - hh * (DH / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (hh < sh.g)
      x = __ldg(reinterpret_cast<const uint4*>(qp + hh * DH + d0));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = d0 + e;
      sm_q[d * HT + (((hh >> 2) + d / KS) & 3) * 4 + (hh & 3)] =
          (e & 1 ? bf16_hi(w[e >> 1]) : bf16_lo(w[e >> 1])) * qscale;
    }
  }
  __syncthreads();

  // q.K^T lanes: d-slice t, rows g + 8(t ^ i); the swizzle of those rows
  const int t = lane >> 3, g = lane & 7;
  const int sw = g & (Z::SW - 1);
  const float* qs[4];  // head quad qd of d-slice t
#pragma unroll
  for (int qd = 0; qd < 4; ++qd)
    qs[qd] = sm_q + t * KS * HT + ((qd + t) & 3) * 4;
  int rowoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rowoff[i] = (g + 8 * (t ^ i)) * Z::RC;
  const int rho = g + 8 * t;  // the row whose scores the lane ends with
  const int kc0 = (t * (KS / 8)) ^ sw;  // the lane's first K chunk
  // p.V lanes: row group rg, element groups dl + 32u; vo[u][x]: the uint2
  // of group dl + 32u in a row whose swizzle is x
  const int rg = lane / LR, dl = lane % LR;
  int vo[NU][Z::SW];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int x = 0; x < Z::SW; ++x)
      vo[u][x] = ((((dl + 32 * u) >> 1) ^ x) << 1) | ((dl + 32 * u) & 1);

  float acc[4 * NU][HT] = {};  // [4u + e][head]: Dh element 4(dl + 32u) + e
  float m[HT], l[HT];          // m warp-uniform; l the lane's rows' share
#pragma unroll
  for (int hh = 0; hh < HT; ++hh) m[hh] = kNegInf, l[hh] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int tile0 = first + i * kWarps * kTileH;
    issue(2 * i + R - 1);
    cp_async_wait<R - 1>();  // this lane's copies of K_i landed
    __syncwarp();            // and every other lane's
    const uint4* kt = ring + ((2 * i) % R) * L::HALF;
    float sc[4][HT] = {};
#pragma unroll 2
    for (int u = 0; u < KS / W; ++u) {
      uint32_t kw[4][W / 2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (W == 8) {
          // (t * KC + u) ^ sw is c0 ^ u where KC is a power of two
          constexpr int KC = KS / 8;
          const int ch = (KC & (KC - 1)) == 0 ? kc0 ^ u
                                              : (t * KC + u) ^ sw;
          const uint4 x = kt[rowoff[r] + ch];
          kw[r][0] = x.x, kw[r][1] = x.y, kw[r][2] = x.z, kw[r][3] = x.w;
        } else {
          const int d0 = t * KS + 4 * u;
          const uint2 x = reinterpret_cast<const uint2*>(
              &kt[rowoff[r] + ((d0 >> 3) ^ sw)])[(d0 >> 2) & 1];
          kw[r][0] = x.x, kw[r][1] = x.y;
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          kv[r] = e & 1 ? bf16_hi(kw[r][e >> 1]) : bf16_lo(kw[r][e >> 1]);
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs[qd] + (u * W + e) * HT);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sc[r][4 * qd] = fmaf(qv.x, kv[r], sc[r][4 * qd]);
            sc[r][4 * qd + 1] = fmaf(qv.y, kv[r], sc[r][4 * qd + 1]);
            sc[r][4 * qd + 2] = fmaf(qv.z, kv[r], sc[r][4 * qd + 2]);
            sc[r][4 * qd + 3] = fmaf(qv.w, kv[r], sc[r][4 * qd + 3]);
          }
        }
      }
    }
    // the four d-slices of row rho: t ^ 2's registers 2, 3, then t ^ 1's 1
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      sc[0][hh] += __shfl_xor_sync(kFull, sc[2][hh], 16);
      sc[1][hh] += __shfl_xor_sync(kFull, sc[3][hh], 16);
    }
#pragma unroll
    for (int hh = 0; hh < HT; ++hh)
      sc[0][hh] += __shfl_xor_sync(kFull, sc[1][hh], 8);

    // softmax: row rho is position tile0 + rho; at or past e1 it is not
    // read (p = 0), at or past kv_len masked to kNegInf
    const int pos = tile0 + rho;
    const bool in = pos < e1, keep = in && pos < sh.kv_len;
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) sc[0][hh] = keep ? sc[0][hh] : kNegInf;
    // the running max moves only when a score passes it by kLift (p <=
    // 2^kLift otherwise): one vote per tile, and after the first tiles
    // almost never a warp max and a rescale
    bool lift = false;
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) lift |= sc[0][hh] > m[hh] + kLift;
    if (__any_sync(kFull, lift)) {
      float mx[HT];
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) mx[hh] = fmaxf(sc[0][hh], m[hh]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int hh = 0; hh < HT; ++hh)
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], off));
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        const float corr = ex2(m[hh] - mx[hh]);
        m[hh] = mx[hh];
        l[hh] *= corr;
#pragma unroll
        for (int e = 0; e < 4 * NU; ++e) acc[e][hh] *= corr;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      const float sv = sc[0][hh];
      const float pv = in ? ex2(sv - m[hh]) : 0.f;
      l[hh] += pv;
      sc[0][hh] = pv;
    }
#pragma unroll
    for (int qd = 0; qd < 4; ++qd)
      *reinterpret_cast<float4*>(pw + rho * HT +
                                 ((qd + (rho >> 1)) & 3) * 4) =
          make_float4(sc[0][4 * qd], sc[0][4 * qd + 1], sc[0][4 * qd + 2],
                      sc[0][4 * qd + 3]);
    __syncwarp();  // p visible; every lane done with K_i's half-stage

    issue(2 * i + R);        // into K_i's half-stage
    cp_async_wait<R - 1>();  // V_i landed
    __syncwarp();
    const uint4* vt = ring + ((2 * i + 1) % R) * L::HALF;
    const uint2* vt2 = reinterpret_cast<const uint2*>(vt);
    constexpr int JU = NP < 8 ? NP : 8;  // rows per loop body
#pragma unroll 1
    for (int j0 = rg * NP; j0 < rg * NP + NP; j0 += JU) {
#pragma unroll
    for (int jk = 0; jk < JU; ++jk) {
      const int j = j0 + jk;
      // j0 is a multiple of 8 where NP is (Dh >= 64), of the swizzle
      // period always
      const int jr = NP % 8 == 0 ? (jk >> 1) & 3 : (j >> 1) & 3;
      float pj[HT];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        const float4 x = *reinterpret_cast<const float4*>(
            pw + j * HT + ((qd + jr) & 3) * 4);
        pj[4 * qd] = x.x, pj[4 * qd + 1] = x.y, pj[4 * qd + 2] = x.z,
        pj[4 * qd + 3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        uint2 w = {0u, 0u};
        if (kRowSplit || dl + 32 * u < NG)
          w = vt2[j * Z::RC * 2 + vo[u][jk & (Z::SW - 1)]];
        const float vv[4] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                             bf16_hi(w.y)};
#pragma unroll
        for (int hh = 0; hh < HT; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * u + e][hh] = fmaf(pj[hh], vv[e], acc[4 * u + e][hh]);
      }
    }
    }
    __syncwarp();  // p and V_i's half-stage are rewritten after this
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: sm_acc reuses it
  float* const sm_acc = reinterpret_cast<float*>(smem);
  float* const sm_m = sm_acc + kWarps * HT * DH;
  float* const sm_l = sm_m + kWarps * HT;
#pragma unroll
  for (int hh = 0; hh < HT; ++hh)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[hh] += __shfl_xor_sync(kFull, l[hh], off);
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      sm_m[warp * HT + hh] = m[hh] * kLn2;  // natural units for the merges
      sm_l[warp * HT + hh] = l[hh];
    }
  }
  // add the row groups' sums: lanes dl, dl + LR, ...
#pragma unroll
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int hh = 0; hh < HT; ++hh)
        acc[e][hh] += __shfl_xor_sync(kFull, acc[e][hh], off);
  if (lane < LR) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (kRowSplit || lane + 32 * u < NG) {
#pragma unroll
        for (int hh = 0; hh < HT; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm_acc[(warp * HT + hh) * DH + 4 * (lane + 32 * u) + e] =
                acc[4 * u + e][hh];
      }
  }
  __syncthreads();
  merge_warps<__nv_bfloat16, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml,
                                     part_acc, sh);
}

// float32 on the same maps, in a kernel of its own: the bfloat16 kernel's
// schedule moved by 4% when the two shared their softmax and merge steps
// as functions (tools/attention_variant.py).  A K or V half-stage is 16 KB
// at Dh 128, so a warp's ring of two takes 32 KB, the CTA 144 KB with q
// and p, and one CTA runs per SM (_ext.ctas_per_sm); each warp keeps the
// next half-stage in flight while it computes one, 64 KB per SM.  A K
// chunk is 4 elements of one row, one LDS.128 for 64 FFMAs; a V chunk is
// one lane's 4 elements of a p.V row.
template <int DH>
__device__ __forceinline__ void attention_tiles_f32_h16(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  using L = H16Layout<float, DH>;
  using Z = typename L::Z;
  constexpr int HT = 16, R = L::STAGES;
  constexpr int KS = DH / 4;  // q.K^T: elements of a d-slice
  constexpr int KC = KS / 4;  // its chunks
  // p.V: NG chunks; where they divide the warp, LR lanes per V row and
  // 32 / LR row groups of NP rows, else (Dh 112, 160) all 32 rows per lane
  // and the chunks lane + 32u, u < NU
  constexpr int NG = DH / 4;
  constexpr bool kRowSplit = 32 % NG == 0;
  constexpr int LR = kRowSplit ? NG : 32;
  constexpr int NU = (NG + 31) / 32;
  constexpr int NP = kTileH * LR / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sm_q = reinterpret_cast<float*>(smem + L::RING);

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const int e1 = min(s1, sh.end);  // no tile starts at or past `end`
  const size_t stride = static_cast<size_t>(sh.kh) * DH;
  const size_t head0 = (static_cast<size_t>(b) * sh.s * sh.kh + h) * DH;
  const float* qp = q + static_cast<size_t>(pair) * sh.g * DH;
  uint4* const ring = reinterpret_cast<uint4*>(smem) + warp * R * L::HALF;
  float* const pw = reinterpret_cast<float*>(smem + L::RING + L::Q) +
                    warp * kTileH * HT;

  // the bfloat16 kernel's rounds: n per warp, half-stage j tile j / 2's K
  // (j even) or V (j odd) rows, rows at or past e1 neither read nor counted
  const int first = s0 + warp * kTileH;
  const int n = (e1 - s0 + kWarps * kTileH - 1) / (kWarps * kTileH);
  auto issue = [&](int j) {
    if (j < 2 * n)
      stage_rows<float, DH>(ring + (j % R) * L::HALF,
                            ((j & 1) ? v : k) + head0, stride,
                            first + (j >> 1) * kWarps * kTileH, e1, lane);
    cp_async_commit();
  };
  if constexpr (32 % Z::CH == 0) {
    // rows past e1 are not fetched: the stage starts zeroed
    for (int i = lane; i < R * L::HALF; i += 32)
      ring[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < R - 1; ++j) issue(j);
  // with the first tiles in flight: q in log2 units, 4 elements a load
  const float qscale = sh.scale * kLog2e;
  for (int i = threadIdx.x; i < HT * DH / 4; i += kThreads) {
    const int hh = i / (DH / 4), d0 = (i - hh * (DH / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hh < sh.g)
      x = __ldg(reinterpret_cast<const float4*>(qp + hh * DH + d0));
    const float w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e;
      sm_q[d * HT + (((hh >> 2) + d / KS) & 3) * 4 + (hh & 3)] =
          w[e] * qscale;
    }
  }
  __syncthreads();

  // q.K^T lanes: d-slice t, rows g + 8(t ^ i); the swizzle of those rows
  const int t = lane >> 3, g = lane & 7;
  const int sw = g & (Z::SW - 1);
  const float* qs[4];  // head quad qd of d-slice t
#pragma unroll
  for (int qd = 0; qd < 4; ++qd)
    qs[qd] = sm_q + t * KS * HT + ((qd + t) & 3) * 4;
  int rowoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rowoff[i] = (g + 8 * (t ^ i)) * Z::RC;
  const int rho = g + 8 * t;      // the row whose scores the lane ends with
  const int kc0 = (t * KC) ^ sw;  // the lane's first K chunk
  // p.V lanes: row group rg, chunks dl + 32u; vo[u][x]: chunk dl + 32u of
  // a row whose swizzle is x
  const int rg = lane / LR, dl = lane % LR;
  int vo[NU][Z::SW];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int x = 0; x < Z::SW; ++x) vo[u][x] = (dl + 32 * u) ^ x;

  float acc[4 * NU][HT] = {};  // [4u + e][head]: element 4(dl + 32u) + e
  float m[HT], l[HT];          // m warp-uniform; l the lane's rows' share
#pragma unroll
  for (int hh = 0; hh < HT; ++hh) m[hh] = kNegInf, l[hh] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int tile0 = first + i * kWarps * kTileH;
    issue(2 * i + R - 1);
    cp_async_wait<R - 1>();  // this lane's copies of K_i landed
    __syncwarp();            // and every other lane's
    const float4* kt =
        reinterpret_cast<const float4*>(ring + ((2 * i) % R) * L::HALF);
    float sc[4][HT] = {};
#pragma unroll 2
    for (int u = 0; u < KC; ++u) {
      // (t * KC + u) ^ sw is kc0 ^ u where KC is a power of two
      const int ch = (KC & (KC - 1)) == 0 ? kc0 ^ u : (t * KC + u) ^ sw;
      float kv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = kt[rowoff[r] + ch];
        kv[r][0] = x.x, kv[r][1] = x.y, kv[r][2] = x.z, kv[r][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs[qd] + (4 * u + e) * HT);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sc[r][4 * qd] = fmaf(qv.x, kv[r][e], sc[r][4 * qd]);
            sc[r][4 * qd + 1] = fmaf(qv.y, kv[r][e], sc[r][4 * qd + 1]);
            sc[r][4 * qd + 2] = fmaf(qv.z, kv[r][e], sc[r][4 * qd + 2]);
            sc[r][4 * qd + 3] = fmaf(qv.w, kv[r][e], sc[r][4 * qd + 3]);
          }
        }
    }
    // the four d-slices of row rho: t ^ 2's registers 2, 3, then t ^ 1's 1
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      sc[0][hh] += __shfl_xor_sync(kFull, sc[2][hh], 16);
      sc[1][hh] += __shfl_xor_sync(kFull, sc[3][hh], 16);
    }
#pragma unroll
    for (int hh = 0; hh < HT; ++hh)
      sc[0][hh] += __shfl_xor_sync(kFull, sc[1][hh], 8);

    // softmax: row rho is position tile0 + rho; at or past e1 it is not
    // read (p = 0), at or past kv_len masked to kNegInf
    const int pos = tile0 + rho;
    const bool in = pos < e1, keep = in && pos < sh.kv_len;
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) sc[0][hh] = keep ? sc[0][hh] : kNegInf;
    // the running max moves only when a score passes it by kLift
    bool lift = false;
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) lift |= sc[0][hh] > m[hh] + kLift;
    if (__any_sync(kFull, lift)) {
      float mx[HT];
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) mx[hh] = fmaxf(sc[0][hh], m[hh]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int hh = 0; hh < HT; ++hh)
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], off));
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        const float corr = ex2(m[hh] - mx[hh]);
        m[hh] = mx[hh];
        l[hh] *= corr;
#pragma unroll
        for (int e = 0; e < 4 * NU; ++e) acc[e][hh] *= corr;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      const float pv = in ? ex2(sc[0][hh] - m[hh]) : 0.f;
      l[hh] += pv;
      sc[0][hh] = pv;
    }
#pragma unroll
    for (int qd = 0; qd < 4; ++qd)
      *reinterpret_cast<float4*>(pw + rho * HT +
                                 ((qd + (rho >> 1)) & 3) * 4) =
          make_float4(sc[0][4 * qd], sc[0][4 * qd + 1], sc[0][4 * qd + 2],
                      sc[0][4 * qd + 3]);
    __syncwarp();  // p visible; every lane done with K_i's half-stage

    issue(2 * i + R);        // into K_i's half-stage
    cp_async_wait<R - 1>();  // V_i landed
    __syncwarp();
    const float4* vt =
        reinterpret_cast<const float4*>(ring + ((2 * i + 1) % R) * L::HALF);
    constexpr int JU = NP < 8 ? NP : 8;  // rows per loop body
#pragma unroll 1
    for (int j0 = rg * NP; j0 < rg * NP + NP; j0 += JU) {
#pragma unroll
      for (int jk = 0; jk < JU; ++jk) {
        const int j = j0 + jk;
        // j0 is a multiple of 8 where NP is (Dh >= 64), of the swizzle
        // period always
        const int jr = NP % 8 == 0 ? (jk >> 1) & 3 : (j >> 1) & 3;
        float pj[HT];
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const float4 x = *reinterpret_cast<const float4*>(
              pw + j * HT + ((qd + jr) & 3) * 4);
          pj[4 * qd] = x.x, pj[4 * qd + 1] = x.y, pj[4 * qd + 2] = x.z,
          pj[4 * qd + 3] = x.w;
        }
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kRowSplit || dl + 32 * u < NG)
            w = vt[j * Z::RC + vo[u][jk & (Z::SW - 1)]];
          const float vv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int hh = 0; hh < HT; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * u + e][hh] = fmaf(pj[hh], vv[e], acc[4 * u + e][hh]);
        }
      }
    }
    __syncwarp();  // p and V_i's half-stage are rewritten after this
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: sm_acc reuses it
  float* const sm_acc = reinterpret_cast<float*>(smem);
  float* const sm_m = sm_acc + kWarps * HT * DH;
  float* const sm_l = sm_m + kWarps * HT;
#pragma unroll
  for (int hh = 0; hh < HT; ++hh)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[hh] += __shfl_xor_sync(kFull, l[hh], off);
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      sm_m[warp * HT + hh] = m[hh] * kLn2;  // natural units for the merges
      sm_l[warp * HT + hh] = l[hh];
    }
  }
  // add the row groups' sums: lanes dl, dl + LR, ...
#pragma unroll
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int hh = 0; hh < HT; ++hh)
        acc[e][hh] += __shfl_xor_sync(kFull, acc[e][hh], off);
  if (lane < LR) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (kRowSplit || lane + 32 * u < NG) {
#pragma unroll
        for (int hh = 0; hh < HT; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm_acc[(warp * HT + hh) * DH + 4 * (lane + 32 * u) + e] =
                acc[4 * u + e][hh];
      }
  }
  __syncthreads();
  merge_warps<float, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml, part_acc,
                             sh);
}

// ---------------------------------------------------------------------------
// float32, head tile 8: K and V staged through a TMA-fed ring, both engines
// ---------------------------------------------------------------------------
//
// A tile of 16 cache positions is 16 KB of K and V at Dh 128 in float32,
// about 640 SM clocks at the datasheet HBM rate when all 132 SMs stream.
// Loaded straight from global memory inside each lane's dependency chain,
// only occupancy hid the latency (77-82% of the byte bound).  Here the
// loads leave the consumers' chains altogether:
// - A CTA is four consumer warps, which keep the tile loop, lane maps and
//   arithmetic of the direct-load kernels (warp w takes the tiles s0 + 16w
//   + 64i; each lane's sums run in the same order, so a range's partial is
//   the same bit for bit), and one producer warp.
// - The producer copies each consumer warp's tiles into that warp's ring
//   of `depth` stages with the TMA: two tensor copies a tile
//   (cp.async.bulk.tensor), one for its 16 K rows and one for its 16 V
//   rows, boxes of tensor maps over the cache with each row cut into box
//   lines of up to 128 bytes.  One lane issues them.  Both complete on the
//   stage's `full` mbarrier, which that lane armed with the tile's byte
//   count first; a consumer warp waits on it, computes, and arrives on the
//   stage's `empty` mbarrier, on which the producer waits before it
//   refills the stage.  Positions past S lie outside the tensor: zero,
//   never read.  The consumers still take positions at or past the range's
//   end as zero, as the direct loads did.
// - The boxes are dense, and the TMA's swizzle spreads a wavefront's lanes
//   over the bank groups (RingLayout): K's image holds rows whole, V's
//   holds each box line of the 16 rows together, so that the swizzle key
//   of a V load follows its row and the matrix engine's four rows 4ks + t
//   land apart.  (Measured at Dh 128, data path alone: 1-D bulk copies,
//   one a row or quarter row, cost the TMA ~65 SM clocks each and held 24%
//   of the bound; boxes padded by zero-filled columns past the tensor's
//   edge 64-74%; dense boxes 91-93%.)
// - The ring takes the fewest stages a warp (at least two) that keep ~48
//   KB of each CTA's tiles in flight beyond the stages being computed
//   (RingLayout::DEPTH: 2 at Dh 112, 128 and 160, 3 at 64, 4 at 32, 7 at
//   16), but no more than the longest range has tiles a warp, so that a
//   short range asks for no shared memory it cannot fill and the producer
//   never waits for a stage it will not reuse.  One CTA runs per SM
//   (_ext.ctas_per_sm) and walks one long range; two where a short cache's
//   ranges cut for two leave rings of two or more stages that fit an SM
//   twice (_ext.attention_ranges; RingLayout::MIN_CTAS).
constexpr int kRingThreads = kThreads + 32;  // four consumer warps, a producer
constexpr int kSmSmem = 228 * 1024;    // shared memory of an SM
constexpr int kCtaReserved = 1024;     // of it, reserved for each CTA
// Bytes of K and V a CTA keeps in flight (one CTA per SM): HBM's 3.35 TB/s
// over 132 SMs for ~1.5 us of latency under load is ~38 KB (Little's law);
// a deeper ring only queues requests (Dh 128: 2 stages read 89-90% of the
// bound alone, 3 stages 88%)
constexpr int kInFlight = 48 * 1024;

// One stage: the K box's image, 16 rows each cut into NP parts of PW
// elements (row r, element e at (r * DH + e) * 4 bytes), then the V box's,
// the parts outermost (((16 * (e / PW) + r) * PW + e % PW) * 4).  A part
// is a box line: 128 bytes where a row holds a power-of-two number of them
// (Dh 32, 64, 128), the row where it is shorter (Dh 16: 64 bytes), else a
// quarter row (Dh 112, 160); fewer, longer lines keep the TMA's per-line
// cost down.  Through the TMA's swizzle over a line of 32, 64 or 128 bytes
// the 16-byte unit of byte a within its 128-byte line is XORed with the
// line's index modulo MASK + 1, so that a wavefront's lanes reach every
// bank group: K's (g, t), g of one parity pair, read quarter t of row g;
// the matrix engine's V loads (g, t) read span g of row 4ks + t, whose
// swizzle key follows the row; the vector engine's read span g of one row.
// Two lanes share a group only for the matrix V loads at Dh 16, 32, 64 and
// 112, for the vector V loads at Dh 112 and for K at 160.
template <int DH>
struct RingLayout {
  static constexpr int KS = DH / 4, VS = DH / 8, QS = KS + 4;
  static constexpr int PW =
      DH * 4 < 128 ? DH : (DH & (DH - 1)) == 0 ? 32 : KS;
  static constexpr int NP = DH / PW;
  static constexpr int MASK = PW * 4 == 128 ? 7 : PW * 4 == 64 ? 3
                              : PW * 4 == 32 ? 1 : 0;
  static constexpr int TILE = 2 * kTile * DH;  // floats: K's image, V's
  // after the ring: p [warp][position][head], (m, l) [warp][head], the
  // vector engine's q [head][t][QS], then the full and empty barriers; the
  // ring starts at a 1024-byte boundary, as the swizzle reads the address
  static constexpr int AUX = kWarps * kTile * 8 + 2 * kWarps * 8 + 8 * 4 * QS;
  static constexpr int bytes(int depth) {
    return 1024 + (kWarps * depth * TILE + AUX) * 4 + 2 * kWarps * depth * 8;
  }
  static constexpr int MAX_DEPTH =
      (kBlockSmem - 1024 - AUX * 4) / (kWarps * (TILE * 4 + 16));
  // stages a warp: the fewest (at least two) whose stages beyond the one a
  // warp computes hold kInFlight bytes of the CTA's tiles in flight
  static constexpr int DEPTH_FOR =
      1 + (kInFlight + kWarps * TILE * 4 - 1) / (kWarps * TILE * 4);
  static constexpr int DEPTH =
      DEPTH_FOR < 2 ? 2 : DEPTH_FOR > MAX_DEPTH ? MAX_DEPTH : DEPTH_FOR;
  // CTAs an SM must hold at once: two where two rings of two stages fit
  // its shared memory (Dh <= 64), for the short caches that
  // _ext.attention_ranges cuts for two CTAs per SM; the kernels are
  // compiled to fit that many in its registers too
  static constexpr int MIN_CTAS =
      2 * (bytes(2) + kCtaReserved) <= kSmSmem ? 2 : 1;
  // byte a of the image as the TMA placed it
  static __device__ __forceinline__ int at(int a) {
    return a ^ (((a >> 7) & MASK) << 4);
  }
  static_assert(KS % 4 == 0 && VS % 2 == 0, "16- and 8-byte spans");
  static_assert(TILE * 4 % 1024 == 0, "stages on 1024-byte boundaries");
  static_assert(MAX_DEPTH >= 2 && bytes(MAX_DEPTH) <= kBlockSmem,
                "two stages a warp must fit one block");
  static_assert(kWarps * 8 * DH <= kWarps * TILE,
                "sm_acc must fit in one stage a warp, which it reuses");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// The box of 5-D tensor map `map` at coordinates c (innermost first) into
// shared dst by the TMA, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int c0, int c1, int c2, int c3,
                                         int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}
// The 128 consumer threads' own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// N consecutive floats of an image from logical byte a, zero where the row
// is out of range.
template <int N, typename L>
__device__ __forceinline__ void stage_span(const unsigned char* img, int a,
                                           bool ok, float (&o)[N]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = 0.f;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(img + L::at(a + 16 * i));
      o[4 * i] = x.x, o[4 * i + 1] = x.y, o[4 * i + 2] = x.z,
      o[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x =
          *reinterpret_cast<const float2*>(img + L::at(a + 8 * i));
      o[2 * i] = x.x, o[2 * i + 1] = x.y;
    }
  }
}

// Matrix, float32, from a stage: score_mma's chains in score_mma's order,
// K rows g and g + 8 (image bytes a0, a1) and head g's span t of q (staged
// as the vector engine stages it) read four elements at a time, so that no
// span is held whole in registers.
template <int DH, typename L>
__device__ __forceinline__ void score_mma_staged(const unsigned char* kt,
                                                 int a0, int a1,
                                                 const bool (&in)[2],
                                                 const float* qg,
                                                 float (&s)[2][2]) {
  double c[2][2][2] = {};  // [half][chain][column]
#pragma unroll
  for (int u = 0; u < DH / 16; ++u) {
    const float4 qv = reinterpret_cast<const float4*>(qg)[u];
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (in[0]) x0 = *reinterpret_cast<const float4*>(kt + L::at(a0 + 16 * u));
    if (in[1]) x1 = *reinterpret_cast<const float4*>(kt + L::at(a1 + 16 * u));
    const float k0[4] = {x0.x, x0.y, x0.z, x0.w};
    const float k1[4] = {x1.x, x1.y, x1.z, x1.w};
    const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * u + e;
      const double b = qq[e];
      dmma_884(c[0][j & 1][0], c[0][j & 1][1], k0[e], b, c[0][j & 1][0],
               c[0][j & 1][1]);
      dmma_884(c[1][j & 1][0], c[1][j & 1][1], k1[e], b, c[1][j & 1][0],
               c[1][j & 1][1]);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      s[hf][i] = __double2float_rn(c[hf][0][i] + c[hf][1][i]);
}

// tk, tv: tensor maps over K as (PW, NP, KH, S, B) with boxes (PW, NP, 1,
// 16, 1), and over V as (PW, S, NP, KH, B) with boxes (PW, 16, NP, 1, 1)
// (RingLayout)
template <int DH, bool kMMA>
__device__ __forceinline__ void attention_tiles_f32_ring(
    const float* __restrict__ q, const CUtensorMap& tk,
    const CUtensorMap& tv, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh, int depth) {
  using L = RingLayout<DH>;
  constexpr int HT = 8;
  constexpr int KS = L::KS;  // a lane's span of a K row
  constexpr int VS = L::VS;  // a lane's span of a V row = its acc chunks
  constexpr int QS = L::QS;  // padded row of the staged q
  constexpr int NI = HT / 4;  // heads per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(
      smem + ((1024 - (smem_addr(smem) & 1023)) & 1023));
  float* const aux = ring + kWarps * depth * L::TILE;
  float(*const sm_p)[kTile][HT] = reinterpret_cast<float(*)[kTile][HT]>(aux);
  float* const sm_m = aux + kWarps * kTile * HT;
  float* const sm_l = sm_m + kWarps * HT;
  float* const sm_q = sm_l + kWarps * HT;
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm_q + HT * 4 * QS);
  uint64_t* const empty = full + kWarps * depth;

  const int pair = blockIdx.x;
  const int b = pair / sh.kh, h = pair - b * sh.kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * sh.rows;
  const int s1 = min(sh.s, s0 + sh.rows);
  const int e1 = min(s1, sh.end);  // no tile starts at or past `end`
  // consumer warp w's tiles start at s0 + 16w + 64i, i < tiles(w)
  auto tiles = [&](int w) {
    const int first = s0 + w * kTile;
    return first < e1 ? (e1 - first + kWarps * kTile - 1) / (kWarps * kTile)
                      : 0;
  };

  // the consumers' state (lane (g, t), as in the direct-load kernels):
  // acc[d = g*VS + c][head lane_head(j, t)], in double on the tensor cores
  const int g = lane >> 2, t = lane & 3;
  using Acc = typename std::conditional<kMMA, double, float>::type;
  Acc acc[VS][NI] = {};
  float m[NI], l[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) m[j] = kNegInf, l[j] = 0.f;

  // the producer, one lane: tile i of every consumer warp in turn, into
  // stage i % depth of its ring once the warp has released tile i - depth;
  // each warp's first tile is issued before the CTA's first barrier, as
  // soon as the stages' barriers exist
  const int n0 = warp == kWarps && lane == 0 ? tiles(0) : 0;
  auto issue = [&](int i, int w) {
    const int slot = w * depth + i % depth;
    const int tile0 = s0 + w * kTile + i * kWarps * kTile;
    float* const st = ring + slot * L::TILE;
    mbar_expect_tx(&full[slot], L::TILE * 4);
    tma_load(st, tk, 0, 0, h, tile0, b, &full[slot]);
    tma_load(st + kTile * DH, tv, 0, tile0, 0, h, b, &full[slot]);
  };
  if (warp == kWarps && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tk))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tv))
                 : "memory");
    for (int i = 0; i < kWarps * depth; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    // the barriers' initialisation visible to the TMA (the async proxy)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int w = 0; w < kWarps && 0 < tiles(w); ++w) issue(0, w);
  } else if (warp < kWarps) {
    // q staged as [head][t][QS], zero past G; the matrix engine's B
    // fragment is head g's span [t*KS, (t+1)*KS)
    const float* qp = q + static_cast<size_t>(pair) * sh.g * DH;
    for (int i = threadIdx.x; i < HT * DH; i += kThreads) {
      const int hh = i / DH, d = i - hh * DH;
      sm_q[(hh * 4 + d / KS) * QS + d % KS] = hh < sh.g ? qp[i] : 0.f;
    }
  }
  __syncthreads();

  if (warp == kWarps) {
    for (int i = 1; i < n0; ++i) {
      for (int w = 0; w < kWarps && i < tiles(w); ++w) {
        if (i >= depth)
          mbar_wait(&empty[w * depth + i % depth], (i / depth - 1) & 1);
        issue(i, w);
      }
    }
  } else {
    // the lane's span g of V's row 0 (part g * VS / PW); row r adds r * PW
    const int vspan =
        (16 * (g * VS / L::PW) * L::PW + g * VS % L::PW) * 4;
    const int n = tiles(warp);
    int stage = 0;
    uint32_t parity = 0;
    for (int i = 0; i < n; ++i) {
      // tile0 is uniform across the warp, as mma.sync and the shuffles need
      const int tile0 = s0 + warp * kTile + i * kWarps * kTile;
      const float* const kf = ring + (warp * depth + stage) * L::TILE;
      const auto* const kt = reinterpret_cast<const unsigned char*>(kf);
      const auto* const vt = reinterpret_cast<const unsigned char*>(
          kf + kTile * DH);
      mbar_wait(&full[warp * depth + stage], parity);
      const int rows[2] = {tile0 + g, tile0 + 8 + g};
      const bool in[2] = {rows[0] < s1, rows[1] < s1};
      const int a0 = (g * DH + t * KS) * 4, a1 = ((g + 8) * DH + t * KS) * 4;
      float s[2][NI];
      if constexpr (kMMA) {
        score_mma_staged<DH, L>(kt, a0, a1, in, sm_q + (g * 4 + t) * QS, s);
      } else {
        float k0[KS], k1[KS];
        stage_span<KS, L>(kt, a0, in[0], k0);
        stage_span<KS, L>(kt, a1, in[1], k1);
        score_fma<DH, HT, HT>(k0, k1, sm_q, sh.g, t, s);
      }
      float p[2][NI], corr[NI];
      softmax_step<NI>(s, rows, in, sh, m, l, p, corr);
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int c = 0; c < VS; ++c) acc[c][j] *= static_cast<Acc>(corr[j]);
      // p (16 positions x HT heads) through shared memory to the lanes
      // that multiply it into V
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          sm_p[warp][8 * hf + g][lane_head(j, t)] = p[hf][j];
      __syncwarp();
      if constexpr (kMMA) {
        // B fragment: p[position 4ks + t][head g]; A: V row 4ks + t
#pragma unroll
        for (int ks = 0; ks < kTile / 4; ++ks) {
          const int r = 4 * ks + t;
          float vs[VS];
          stage_span<VS, L>(vt, vspan + r * L::PW * 4, tile0 + r < s1, vs);
          const double pb = sm_p[warp][r][g];
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
            const int r = 4 * ks + u;
            stage_span<VS, L>(vt, vspan + r * L::PW * 4, tile0 + r < s1,
                              vs[u]);
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
      __syncwarp();  // every lane is done with the stage and with sm_p
      if (lane == 0) mbar_arrive(&empty[warp * depth + stage]);
      if (++stage == depth) stage = 0, parity ^= 1;
    }
  }

  // every copy has landed and every warp is done with its ring: sm_acc
  // reuses it
  __syncthreads();
  if (warp == kWarps) return;
  float* const sm_acc = ring;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      sm_m[warp * HT + lane_head(j, t)] = m[j];
      sm_l[warp * HT + lane_head(j, t)] = l[j];
    }
  }
#pragma unroll
  for (int c = 0; c < VS; ++c)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      sm_acc[(warp * HT + lane_head(j, t)) * DH + g * VS + c] =
          static_cast<float>(acc[c][j]);
  consumers_sync();
  merge_warps<float, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml, part_acc, sh);
}

template <int DH>
__global__ void __launch_bounds__(kRingThreads, RingLayout<DH>::MIN_CTAS)
    attention_vector_ring_kernel(const float* __restrict__ q,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 float* __restrict__ out,
                                 float* __restrict__ part_ml,
                                 float* __restrict__ part_acc, Shape sh,
                                 int depth) {
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  attention_tiles_f32_ring<DH, false>(q, tk, tv, out, part_ml, part_acc, sh,
                                      depth);
}

template <int DH>
__global__ void __launch_bounds__(kRingThreads, RingLayout<DH>::MIN_CTAS)
    attention_matrix_ring_kernel(const float* __restrict__ q,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 float* __restrict__ out,
                                 float* __restrict__ part_ml,
                                 float* __restrict__ part_acc, Shape sh,
                                 int depth) {
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  attention_tiles_f32_ring<DH, true>(q, tk, tv, out, part_ml, part_acc, sh,
                                     depth);
}

// HT: the head tile, 8 for G <= 8 and 16 for 8 < G <= 16 (one kernel each,
// so the G <= 8 kernels keep their registers); float32 at HT 8 is
// attention_{vector,matrix}_ring_kernel
template <typename T, int DH, int HT>
__global__ void __launch_bounds__(kThreads)
    attention_vector_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, Shape sh) {
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (std::is_same<T, float>::value)
    attention_tiles_f32_h16<DH>(q, k, v, out, part_ml, part_acc, sh);
  else if constexpr (HT == 16)
    attention_tiles_bf16_h16<DH>(q, k, v, out, part_ml, part_acc, sh);
  else if (sh.g <= 1)
    attention_tiles_bf16<DH, false, 1, 8>(q, k, v, out, part_ml, part_acc,
                                          sh);
  else if (sh.g <= 2)
    attention_tiles_bf16<DH, false, 2, 8>(q, k, v, out, part_ml, part_acc,
                                          sh);
  else if (sh.g <= 4)
    attention_tiles_bf16<DH, false, 4, 8>(q, k, v, out, part_ml, part_acc,
                                          sh);
  else
    attention_tiles_bf16<DH, false, 8, 8>(q, k, v, out, part_ml, part_acc,
                                          sh);
}

template <typename T, int DH, int HT>
__global__ void __launch_bounds__(kThreads)
    attention_matrix_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, Shape sh) {
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (std::is_same<T, float>::value)
    attention_tiles_f32_mma16<DH>(q, k, v, out, part_ml, part_acc, sh);
  else
    attention_tiles_bf16<DH, true, HT, HT>(q, k, v, out, part_ml, part_acc,
                                           sh);
}

// ---------------------------------------------------------------------------
// merge of the ranges of one (b, h) pair: grid (pairs, G), kWarps warps.
// Warp w sums the ranges w, w + kWarps, ... in order, lane l elements
// l, l + 32, ... of Dh, so that many ranges' loads are in flight at once;
// the warps' sums are then added in warp order.  E: elements per lane, 4
// for every Dh <= 128 (one kernel), 5 for Dh 160.
// ---------------------------------------------------------------------------

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    attention_combine_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, Shape sh) {
  __shared__ float sm_acc[kWarps][E * 32], sm_l[kWarps], sm_max[kWarps];
  // launched as a programmatic dependent of the range kernel: wait until
  // that grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int pair = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ml = part_ml + static_cast<size_t>(pair) * sh.nsplit * sh.g * 2;
  const float* ac = part_acc + static_cast<size_t>(pair) * sh.nsplit * sh.g *
                                   sh.dh;
  // kBatch of the warp's ranges at a time, every load of a batch issued
  // before the first is used; the first batch's loads are in flight while
  // the maximum over all ranges is taken
  constexpr int kBatch = 16;
  float mv[kBatch], lv[kBatch], av[kBatch][E];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + kWarps * u;
      const bool ok = i < sh.nsplit;
      mv[u] = ok ? __ldg(ml + (i * sh.g + g) * 2) : 0.f;
      lv[u] = ok ? __ldg(ml + (i * sh.g + g) * 2 + 1) : 0.f;
      const float* a = ac + (static_cast<size_t>(ok ? i : 0) * sh.g + g) *
                                sh.dh;
#pragma unroll
      for (int e = 0; e < E; ++e)
        av[u][e] = ok && lane + 32 * e < sh.dh ? __ldg(a + lane + 32 * e)
                                               : 0.f;
    }
  };
  load(warp);
  float mx = ml[g * 2];
  for (int i = threadIdx.x; i < sh.nsplit; i += kThreads)
    mx = fmaxf(mx, ml[(i * sh.g + g) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) sm_max[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_max[w]);
  float l = 0.f, acc[E] = {};
  for (int i0 = warp;;) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + kWarps * u < sh.nsplit) {
        const float w = expf(mv[u] - mx);
        l = fmaf(lv[u], w, l);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(av[u][e], w, acc[e]);
      }
    }
    i0 += kWarps * kBatch;
    if (i0 >= sh.nsplit) break;
    load(i0);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane + 32 * e] = acc[e];
  if (lane == 0) sm_l[warp] = l;
  __syncthreads();
  for (int d = threadIdx.x; d < sh.dh; d += kThreads) {
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lsum += sm_l[w];
      asum += sm_acc[w][d];
    }
    out[(static_cast<size_t>(pair) * sh.g + g) * sh.dh + d] =
        from_float<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

// The CUDA driver's tensor-map encoder, fetched through the runtime once
// (no link against libcuda); null where the installed CUDA lacks it.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 5-D float32 tensor map (dims innermost first; strides in bytes of dims
// 1..4) with boxes `box`, swizzled over `mask` + 1 16-byte units.
bool tensor_map(CUtensorMap* map, const float* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box, int mask) {
  const EncodeTiled encode = tensor_map_encoder();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      mask == 7   ? CU_TENSOR_MAP_SWIZZLE_128B
      : mask == 3 ? CU_TENSOR_MAP_SWIZZLE_64B
      : mask == 1 ? CU_TENSOR_MAP_SWIZZLE_32B
                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5,
                const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// float32 at a head tile of 8: the ring kernels, with a ring of
// RingLayout::DEPTH stages a warp, but no deeper than the longest range
// (range 0) has tiles a warp.
template <int DH>
cudaError_t launch_ring(const float* q, const float* k, const float* v,
                        float* out, float* part_ml, float* part_acc,
                        dim3 grid, const Shape& sh, int matrix,
                        cudaStream_t s) {
  using L = RingLayout<DH>;
  const cuuint64_t batch = grid.x / sh.kh, kh = sh.kh, len = sh.s;
  const cuuint64_t row = kh * DH * 4;  // bytes of a position's K (or V)
  // K: (element, part, head, position, batch); V: (element, position,
  // part, head, batch)
  const cuuint64_t part = L::PW * 4;
  const cuuint64_t k_dims[5] = {L::PW, L::NP, kh, len, batch};
  const cuuint64_t k_strides[4] = {part, DH * 4, row, row * len};
  const cuuint32_t k_box[5] = {L::PW, L::NP, 1, kTile, 1};
  const cuuint64_t v_dims[5] = {L::PW, len, L::NP, kh, batch};
  const cuuint64_t v_strides[4] = {row, part, DH * 4, row * len};
  const cuuint32_t v_box[5] = {L::PW, kTile, L::NP, 1, 1};
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, k_dims, k_strides, k_box, L::MASK) ||
      !tensor_map(&tv, v, v_dims, v_strides, v_box, L::MASK))
    return cudaErrorInvalidValue;
  auto kernel = matrix ? attention_matrix_ring_kernel<DH>
                       : attention_vector_ring_kernel<DH>;
  const int tiles = (min(sh.rows, sh.end) + kWarps * kTile - 1) /
                    (kWarps * kTile);
  const int depth = max(1, min(L::DEPTH, tiles));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(L::DEPTH));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRingThreads, L::bytes(depth), s>>>(q, tk, tv, out, part_ml,
                                                      part_acc, sh, depth);
  return cudaGetLastError();
}

template <typename T, int DH, int HT>
cudaError_t launch_tiles(const T* q, const T* k, const T* v, T* out,
                         float* part_ml, float* part_acc, dim3 grid,
                         const Shape& sh, int matrix, cudaStream_t s) {
  auto kernel = matrix ? attention_matrix_kernel<T, DH, HT>
                       : attention_vector_kernel<T, DH, HT>;
  // dynamic shared memory: the head-tile-16 vector kernels' layout and
  // the bfloat16 kernels' ring; the float32 matrix kernel's is static
  const bool h16 = !matrix && HT == 16;
  int smem = h16 ? H16Layout<T, DH>::BYTES : 0;
  if constexpr (!std::is_same<T, float>::value)
    if (!h16) smem = smem_bytes<DH, HT>();
  if (smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // the head-tile-16 vector kernels (bfloat16: two CTAs of 112 KB at Dh
    // 128; float32: one of 208 KB) need the largest shared-memory carveout
    if (e == cudaSuccess && h16)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, out, part_ml, part_acc, sh);
  return cudaGetLastError();
}

// The range kernel at head dim DH (head tile 8 for G <= 8, 16 above; the
// ring kernels for float32 at 8), then with several ranges per pair their
// merge.
template <typename T, int DH>
cudaError_t launch_dh(const T* q, const T* k, const T* v, T* out,
                      float* part_ml, float* part_acc, int pairs,
                      const Shape& sh, int matrix, cudaStream_t s) {
  const dim3 grid(pairs, sh.nsplit);
  cudaError_t err;
  if (sh.g > 8)
    err = launch_tiles<T, DH, 16>(q, k, v, out, part_ml, part_acc, grid, sh,
                                  matrix, s);
  else if constexpr (std::is_same<T, float>::value)
    err = launch_ring<DH>(q, k, v, out, part_ml, part_acc, grid, sh, matrix,
                          s);
  else
    err = launch_tiles<T, DH, 8>(q, k, v, out, part_ml, part_acc, grid, sh,
                                 matrix, s);
  if (err != cudaSuccess || sh.nsplit == 1) return err;
  // programmatic dependent launch: the merge is scheduled while the range
  // kernel's last CTAs run, instead of after it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, sh.g);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, attention_combine_kernel<T, DH <= 128 ? 4 : (DH + 31) / 32>,
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      out, sh);
}

}  // namespace

// The range kernels at head dim DH, both dtypes, and their merge.  Built as
// one object, the file instantiates every head dim (or only
// REPRO_ATTENTION_ONLY_DH's, tools/attention_variant.py); object k of the
// parallel build (-DREPRO_PART=k) instantiates head dim 16, 32, 64, 112,
// 128 or 160, and object 0 also holds the C entry point.
namespace repro_attention {
#ifdef REPRO_ATTENTION_ONLY_DH
constexpr int kOnlyDh = REPRO_ATTENTION_ONLY_DH;
#else
constexpr int kOnlyDh = 0;
#endif

template <int DH>
cudaError_t launch_head_dim(const void* q, const void* k, const void* v,
                            void* out, float* part_ml, float* part_acc,
                            int pairs, const Shape& sh, int bf16, int matrix,
                            cudaStream_t s) {
  if constexpr (kOnlyDh != 0 && kOnlyDh != DH) {
    return cudaErrorInvalidValue;
  } else if (bf16) {
    using T = __nv_bfloat16;
    return launch_dh<T, DH>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), part_ml, part_acc,
        pairs, sh, matrix, s);
  } else {
    return launch_dh<float, DH>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), part_ml,
        part_acc, pairs, sh, matrix, s);
  }
}

#define REPRO_HEAD_DIM(DH)                                                  \
  template cudaError_t launch_head_dim<DH>(                                 \
      const void*, const void*, const void*, void*, float*, float*, int,    \
      const Shape&, int, int, cudaStream_t)
#if defined(REPRO_PART)
#if REPRO_PART == 0
REPRO_HEAD_DIM(16);
extern REPRO_HEAD_DIM(32);
extern REPRO_HEAD_DIM(64);
extern REPRO_HEAD_DIM(112);
extern REPRO_HEAD_DIM(128);
extern REPRO_HEAD_DIM(160);
#elif REPRO_PART == 1
REPRO_HEAD_DIM(32);
#elif REPRO_PART == 2
REPRO_HEAD_DIM(64);
#elif REPRO_PART == 3
REPRO_HEAD_DIM(112);
#elif REPRO_PART == 4
REPRO_HEAD_DIM(128);
#elif REPRO_PART == 5
REPRO_HEAD_DIM(160);
#endif
#endif
#undef REPRO_HEAD_DIM
}  // namespace repro_attention

#if !defined(REPRO_PART) || REPRO_PART == 0
REPRO_ERROR_STRING(attention)

// out (B, KH, G, Dh) = flash-decode of q (B, KH, G, Dh) over k, v
// (B, S, KH, Dh).  Positions [0, end) are read, end = min(kv_len, S) for
// kv_len >= 1 and S otherwise (a caller may pass S to read every
// position); they are cut into nsplit ranges of `rows` positions, one CTA
// each.  With nsplit > 1, part_ml (pairs * nsplit * G * 2) and part_acc
// (pairs * nsplit * G * Dh) float32 hold the ranges' partials.  Both
// kernels take G <= 16 and Dh in {16, 32, 64, 112, 128, 160}.  Returns the
// cudaError_t.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, float* part_ml, float* part_acc,
                                int batch, int kh, int g, int s, int dh,
                                int kv_len, int end, int rows, int nsplit,
                                float scale, int bf16, int matrix,
                                void* stream) {
  if (batch < 0 || kh <= 0 || g <= 0 || g > kMaxHeads || s <= 0 ||
      end <= 0 || end > s || rows <= 0 || nsplit <= 0 ||
      static_cast<long long>(rows) * nsplit < end ||
      static_cast<long long>(rows) * (nsplit - 1) >= end ||
      (nsplit > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const Shape sh{kh, g, s, dh, kv_len, end, rows, nsplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using repro_attention::launch_head_dim;
  cudaError_t err;
  switch (dh) {
#define REPRO_ATTENTION(DH)                                                \
  case DH:                                                                 \
    err = launch_head_dim<DH>(q, k, v, out, part_ml, part_acc, batch * kh, \
                              sh, bf16, matrix, st);                       \
    break;
    REPRO_ATTENTION(16)
    REPRO_ATTENTION(32)
    REPRO_ATTENTION(64)
    REPRO_ATTENTION(112)
    REPRO_ATTENTION(128)
    REPRO_ATTENTION(160)
#undef REPRO_ATTENTION
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif
