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
// float32: each lane loads elements [t*Dh/4, (t+1)*Dh/4) of K rows g and
// g + 8 and elements [g*Dh/8, (g+1)*Dh/8) of V rows straight from global
// memory.
//   Matrix: q.K^T and p.V on DMMA m8n8k4 on values converted to double
//   (q.K^T with positions on M and heads on N; p.V with V^T on M, heads on
//   N, 4 positions on K), products exact.
//   Vector: the same products as FFMAs; each lane takes partial dots over
//   its K span for every head (q staged in shared memory), and a
//   reduce-scatter over the four t lanes (12 shuffles per tile) leaves it
//   the full scores of heads 2t and 2t+1; p.V walks the tile's 16 V rows,
//   each lane its own span.
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
//   Vector: scores as in float32 but read from the stage (one shift or mask
//   per bfloat16 value), for NH heads, G rounded up to a power of two, each
//   head's FFMAs unrolled and independent of the others; p.V gives each
//   lane 4 elements of Dh for those heads (none padded at G = 4) over its
//   share of the tile's positions, each V element read from the stage by
//   one lane only.  q stays staged in shared memory: the eight g lanes read
//   the same words, one broadcast per load.
// The merge of the ranges is launched as a programmatic dependent of the
// range kernel, so it is scheduled while the range kernel's last CTAs run.
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
constexpr int kMaxHeads = 16;      // query heads per KV head: 2 MMA N tiles
constexpr int kTile = 16;          // cache positions per warp tile
constexpr int kRing = 3;           // bfloat16: tiles in a warp's ring

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
// float32: the tile loop with direct loads, one per engine
// ---------------------------------------------------------------------------

template <int DH, bool kMMA, int HT>
__device__ __forceinline__ void attention_tiles_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    const Shape& sh) {
  constexpr int KS = DH / 4;  // a lane's span of a K row
  constexpr int VS = DH / 8;  // a lane's span of a V row = its acc chunks
  constexpr int QS = KS + 4;  // padded row of the staged q
  constexpr int NI = HT / 4;  // heads per lane
  constexpr int NT = HT / 8;  // MMA N tiles
  // matrix, HT = 8: q's B fragment in registers and a double accumulator
  constexpr bool kNarrowMMA = kMMA && HT == 8;
  __shared__ __align__(16) float sm_p[kWarps][kTile][HT];
  __shared__ float sm_m[kWarps * HT], sm_l[kWarps * HT];
  __shared__ float sm_acc[kWarps * HT * DH];
  __shared__ __align__(16) float sm_q[kNarrowMMA ? 4 : HT * 4 * QS];

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

  // the matrix engine's B fragment: head g's span [t*KS, (t+1)*KS) of q
  float qs[kNarrowMMA ? KS : 1];
  if constexpr (kNarrowMMA) {
    load_span<KS>(qp + static_cast<size_t>(g) * DH + t * KS, g < sh.g, qs);
  } else {
    for (int i = threadIdx.x; i < HT * DH; i += kThreads) {
      const int hh = i / DH, d = i - hh * DH;
      sm_q[(hh * 4 + d / KS) * QS + d % KS] = hh < sh.g ? qp[i] : 0.f;
    }
    __syncthreads();
  }

  // acc[d = g*VS + c][head lane_head(j, t)], in double on the tensor cores
  // at HT = 8
  using Acc = typename std::conditional<kNarrowMMA, double, float>::type;
  Acc acc[VS][NI] = {};
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
    if constexpr (kNarrowMMA) {
      score_mma<DH>(k0, k1, qs, s);
    } else if constexpr (kMMA) {
      // one N tile at a time, its B fragment from the staged q
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float qn[KS];
        const float4* q4 = reinterpret_cast<const float4*>(
            sm_q + ((8 * nt + g) * 4 + t) * QS);
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
    } else {
      score_fma<DH, HT, HT>(k0, k1, sm_q, sh.g, t, s);
    }
    float p[2][NI], corr[NI];
    softmax_step<NI>(s, rows, in, sh, m, l, p, corr);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int c = 0; c < VS; ++c) acc[c][i] *= static_cast<Acc>(corr[i]);
    // p (16 positions x HT heads) through shared memory to the lanes that
    // multiply it into V
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        sm_p[warp][8 * hf + g][lane_head(j, t)] = p[hf][j];
    __syncwarp();
    if constexpr (kNarrowMMA) {
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
    } else if constexpr (kMMA) {
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
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 pu = *reinterpret_cast<const float2*>(
                &sm_p[warp][4 * ks + u][8 * nt + 2 * t]);
#pragma unroll
            for (int c = 0; c < VS; ++c) {
              acc[c][2 * nt] = fmaf(pu.x, vs[u][c], acc[c][2 * nt]);
              acc[c][2 * nt + 1] = fmaf(pu.y, vs[u][c], acc[c][2 * nt + 1]);
            }
          }
        }
      }
    }
    __syncwarp();
  }

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
  __syncthreads();
  merge_warps<float, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml, part_acc, sh);
}

// ---------------------------------------------------------------------------
// bfloat16: K and V staged through a ring in shared memory
// ---------------------------------------------------------------------------

// One stage: the K and V rows of a 16-position tile.  The 16-byte chunk c of
// row r sits at r * CH + (c ^ (r % SW)), so that the eight row addresses of
// an ldmatrix phase (eight rows, one chunk) fall in eight bank groups.
template <int DH>
struct KVTile {
  static constexpr int CH = DH / 8;           // 16-byte chunks per row
  static constexpr int SW = CH < 8 ? CH : 8;  // swizzle period
  uint4 k[kTile * CH];
  uint4 v[kTile * CH];
  static __device__ __forceinline__ int at(int r, int c) {
    return r * CH + (c ^ (r & (SW - 1)));
  }
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
  uint32_t w[DH / 8];
  if constexpr (DH >= 32) {
    constexpr int KC = DH / 32;  // chunks per span
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const uint4 x = st.k[Tile::at(r, t * KC + j)];
      w[4 * j] = x.x, w[4 * j + 1] = x.y, w[4 * j + 2] = x.z,
      w[4 * j + 3] = x.w;
    }
  } else {  // half a chunk
    const uint2 x =
        reinterpret_cast<const uint2*>(&st.k[Tile::at(r, t >> 1)])[t & 1];
    w[0] = x.x, w[1] = x.y;
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
  constexpr int LR = DH / 4;       // vector p.V: lanes per V row, 4 each
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
  // (+ 8) and heads 8nt + 2t, 8nt + 2t + 1; vector: acc[e][head] for Dh
  // element 4 * (lane % LR) + e
  float acc[kMMA ? DH / 16 : 4][kMMA ? 4 * NT : HT] = {};
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
      // lane = rg * LR + dl owns Dh elements 4dl .. 4dl + 3 of positions
      // rg * NP .. rg * NP + NP - 1, for heads 0 .. NH - 1
      const int rg = lane / LR, dl = lane % LR;
      float vv[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const uint2 w = reinterpret_cast<const uint2*>(
            &st.v[Tile::at(rg * NP + j, dl >> 1)])[dl & 1];
        vv[j][0] = bf16_lo(w.x), vv[j][1] = bf16_hi(w.x);
        vv[j][2] = bf16_lo(w.y), vv[j][3] = bf16_hi(w.y);
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        // head hh's factor, from lane t = (hh % 8) / 2, slot 2(hh / 8) + hh % 2
        const float ch =
            __shfl_sync(kFull, corr[2 * (hh >> 3) + (hh & 1)], (hh & 7) >> 1);
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
          acc[e][hh] *= ch;
#pragma unroll
          for (int j = 0; j < NP; ++j)
            acc[e][hh] = fmaf(pv[j], vv[j][e], acc[e][hh]);
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
      for (int hh = 0; hh < HT; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm_acc[(warp * HT + hh) * DH + 4 * lane + e] = acc[e][hh];
    }
  }
  __syncthreads();
  merge_warps<__nv_bfloat16, DH, HT>(sm_m, sm_l, sm_acc, out, part_ml,
                                     part_acc, sh);
}

// HT: the head tile, 8 for G <= 8 and 16 for 8 < G <= 16 (one kernel each,
// so the G <= 8 kernels keep their registers)
template <typename T, int DH, int HT>
__global__ void __launch_bounds__(kThreads)
    attention_vector_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, Shape sh) {
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (std::is_same<T, float>::value)
    attention_tiles_f32<DH, false, HT>(q, k, v, out, part_ml, part_acc, sh);
  else if constexpr (HT == 16)
    attention_tiles_bf16<DH, false, 16, 16>(q, k, v, out, part_ml, part_acc,
                                            sh);
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
    attention_tiles_f32<DH, true, HT>(q, k, v, out, part_ml, part_acc, sh);
  else
    attention_tiles_bf16<DH, true, HT, HT>(q, k, v, out, part_ml, part_acc,
                                           sh);
}

// ---------------------------------------------------------------------------
// merge of the ranges of one (b, h) pair: grid (pairs, G), kWarps warps.
// Warp w sums the ranges w, w + kWarps, ... in order, lane l elements
// l, l + 32, ... of Dh, so that many ranges' loads are in flight at once;
// the warps' sums are then added in warp order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_combine_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, Shape sh) {
  constexpr int E = 128 / 32;  // elements per lane at the largest Dh
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

template <typename T, int DH, int HT>
cudaError_t launch_tiles(const T* q, const T* k, const T* v, T* out,
                         float* part_ml, float* part_acc, dim3 grid,
                         const Shape& sh, int matrix, cudaStream_t s) {
  auto kernel = matrix ? attention_matrix_kernel<T, DH, HT>
                       : attention_vector_kernel<T, DH, HT>;
  int smem = 0;
  if constexpr (!std::is_same<T, float>::value) {
    smem = smem_bytes<DH, HT>();
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, out, part_ml, part_acc, sh);
  return cudaGetLastError();
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
  cudaError_t err;
  switch (sh.dh) {
#define REPRO_ATTENTION(DH)                                              \
  case DH:                                                               \
    err = sh.g <= 8 ? launch_tiles<T, DH, 8>(qt, kt, vt, ot, part_ml,    \
                                             part_acc, grid, sh, matrix, \
                                             s)                          \
                    : launch_tiles<T, DH, 16>(qt, kt, vt, ot, part_ml,   \
                                              part_acc, grid, sh,        \
                                              matrix, s);                \
    break;
    REPRO_ATTENTION(16)
    REPRO_ATTENTION(32)
    REPRO_ATTENTION(64)
    REPRO_ATTENTION(128)
#undef REPRO_ATTENTION
    default:
      return cudaErrorInvalidValue;
  }
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
  return cudaLaunchKernelEx(&cfg, attention_combine_kernel<T>,
                            static_cast<const float*>(part_ml),
                            static_cast<const float*>(part_acc), ot, sh);
}

}  // namespace

REPRO_ERROR_STRING(attention)

// out (B, KH, G, Dh) = flash-decode of q (B, KH, G, Dh) over k, v
// (B, S, KH, Dh).  Positions [0, end) are read, end = min(kv_len, S) for
// kv_len >= 1 and S otherwise (a caller may pass S to read every
// position); they are cut into nsplit ranges of `rows` positions, one CTA
// each.  With nsplit > 1, part_ml (pairs * nsplit * G * 2) and part_acc
// (pairs * nsplit * G * Dh) float32 hold the ranges' partials.  Both
// kernels take G <= 16 and Dh in {16, 32, 64, 128}.  Returns the
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
  const cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(q, k, v, out, part_ml, part_acc,
                                         batch * kh, sh, matrix, st)
           : launch_typed<float>(q, k, v, out, part_ml, part_acc, batch * kh,
                                 sh, matrix, st);
  return static_cast<int>(err);
}
