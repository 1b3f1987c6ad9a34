// The mma.sync fragment helpers of the tensor-core bodies: K2's
// (mlp_fwd_tangents_mma.cuh) and the backward walk's bf16 and f32x3 tiers
// (mlp_bwd_mma.cuh).
//
// A warp multiplies a tile of 16 points (the rows of an m16n8k16 product)
// by a layer's weights. The width W is padded to N_p = 8 * tiles8(W)
// neurons; the accumulator of column tiles (2i, 2i + 1) is the A fragment
// of k-tile i of the next product (Half), so a product's output is the
// next one's operand in registers. The weights (the B operand) sit in
// shared memory in fragment order (half_word, stage_half), one 32-bit word
// per lane and half k-tile (bf16x2), two at f32x3 (hi, lo), so a lane's
// B registers are one 8- or 16-byte load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tier.cuh"

namespace mmafrag {

// 8-neuron tiles of a width: N_p = 8 * tiles8(W).
__host__ __device__ constexpr int tiles8(int w) { return (w + 7) / 8; }

// Two floats as a bf16x2 word, rounded to nearest even: `lo` in the lower
// half (the MMA's first element of the pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lower_f(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float upper_f(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// acc += A (16 x 16, row) @ B (16 x 8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma16816(float (&acc)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += A (16 x 8, row) @ B (8 x 8, col).
__device__ __forceinline__ void mma1688(float (&acc)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The transpose of an 8 x 8 bf16 matrix held as one word a lane (lane (g,
// q) holds row g, columns 2q and 2q + 1, as in a Half word): lane (g, q)
// gets row g of the transpose, i.e. column g of the input at rows 2q and
// 2q + 1.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t r;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(r) : "r"(x));
  return r;
}

// One 8-column half of an A fragment: rows g (word 0) and g + 8 (word 1),
// columns 2q and 2q + 1 of the half; lo only at f32x3.
struct Half {
  uint32_t hi[2];
  uint32_t lo[2];
};

// One B fragment word of a lane: rows (k) 2q and 2q + 1 of a half k-tile,
// column g of a column tile; lo only at f32x3.
struct BWord {
  uint32_t hi;
  uint32_t lo;
};

// The operand of the next product from four accumulator elements (rows g,
// g; g + 8, g + 8 at columns 2q, 2q + 1): rounded (bf16) or split (f32x3).
template <bool SPLIT>
__device__ __forceinline__ Half make_half(float x0, float x1, float x2, float x3) {
  Half h;
  h.hi[0] = pack_bf16x2(x0, x1);
  h.hi[1] = pack_bf16x2(x2, x3);
  if constexpr (SPLIT) {
    h.lo[0] = pack_bf16x2(x0 - lower_f(h.hi[0]), x1 - upper_f(h.hi[0]));
    h.lo[1] = pack_bf16x2(x2 - lower_f(h.hi[1]), x3 - upper_f(h.hi[1]));
  } else {
    h.lo[0] = h.lo[1] = 0u;
  }
  return h;
}

// Where lane `lane`'s hi word of half k-tile h sits in one column tile's
// fragments (T * 32 words at bf16, twice that at f32x3): the halves in
// pairs, one k16 step each, as a uint2 {hi_h, hi_h+1} a lane (bf16) or a
// uint4 {hi_h, hi_h+1, lo_h, lo_h+1} (f32x3), so that one vector load gives
// the MMA's two B registers side by side; then an odd last half as one
// word or a {hi, lo} uint2. Its lo word is 2 (pairs) or 1 (odd) further.
template <bool SPLIT, int T>
__host__ __device__ constexpr int half_word(int h, int lane) {
  constexpr int U = SPLIT ? 2 : 1;
  return h < 2 * (T / 2) ? (h / 2) * 64 * U + lane * 2 * U + (h % 2)
                         : (T / 2) * 64 * U + lane * U;
}

template <int T>
__host__ __device__ constexpr int lo_offset(int h) {
  return h < 2 * (T / 2) ? 2 : 1;
}

// The B words of one column tile for this lane, KT half k-tiles.
template <bool SPLIT, int KT>
__device__ __forceinline__ void load_tile_b(const uint32_t* __restrict__ p, int lane,
                                            BWord (&b)[KT]) {
#pragma unroll
  for (int h = 0; h + 1 < KT; h += 2) {
    if constexpr (SPLIT) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + half_word<SPLIT, KT>(h, lane));
      b[h] = {v.x, v.z};
      b[h + 1] = {v.y, v.w};
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p + half_word<SPLIT, KT>(h, lane));
      b[h] = {v.x, 0u};
      b[h + 1] = {v.y, 0u};
    }
  }
  if constexpr (KT % 2 == 1) {
    if constexpr (SPLIT) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + half_word<SPLIT, KT>(KT - 1, lane));
      b[KT - 1] = {v.x, v.y};
    } else {
      b[KT - 1] = {p[half_word<SPLIT, KT>(KT - 1, lane)], 0u};
    }
  }
}

// Stage the B words of one column tile's half k-tile h for lane `lane`:
// rows k = 8h + 2q, k + 1 and column g of the f32 weights at the tier.
template <bool SPLIT, int T>
__device__ __forceinline__ void stage_half(uint32_t* __restrict__ tile, int h, int lane, float w0,
                                           float w1) {
  const uint32_t hi = pack_bf16x2(w0, w1);
  uint32_t* p = tile + half_word<SPLIT, T>(h, lane);
  p[0] = hi;
  if constexpr (SPLIT) p[lo_offset<T>(h)] = pack_bf16x2(w0 - lower_f(hi), w1 - upper_f(hi));
}

// z[j] (the four elements of column tile j) = init + a @ B at the tier,
// over KT half k-tiles: m16n8k16 on pairs of halves, m16n8k8 on an odd
// last one. f32x3: cross = a_lo @ B_hi + a_hi @ B_lo and main = init +
// a_hi @ B_hi, then z = cross + main.
template <bool SPLIT, int NT, int KT>
__device__ __forceinline__ void product(float (&z)[NT][4], const Half (&a)[KT],
                                        const BWord (&b)[NT][KT], const float (&init)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float m[4] = {init[j][0], init[j][1], init[j][0], init[j][1]};
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h + 1 < KT; h += 2) {
      if constexpr (SPLIT) {
        mma16816(c, a[h].lo[0], a[h].lo[1], a[h + 1].lo[0], a[h + 1].lo[1], b[j][h].hi,
                 b[j][h + 1].hi);
        mma16816(c, a[h].hi[0], a[h].hi[1], a[h + 1].hi[0], a[h + 1].hi[1], b[j][h].lo,
                 b[j][h + 1].lo);
      }
      mma16816(m, a[h].hi[0], a[h].hi[1], a[h + 1].hi[0], a[h + 1].hi[1], b[j][h].hi,
               b[j][h + 1].hi);
    }
    if constexpr (KT % 2 == 1) {
      constexpr int h = KT - 1;
      if constexpr (SPLIT) {
        mma1688(c, a[h].lo[0], a[h].lo[1], b[j][h].hi);
        mma1688(c, a[h].hi[0], a[h].hi[1], b[j][h].lo);
      }
      mma1688(m, a[h].hi[0], a[h].hi[1], b[j][h].hi);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) z[j][e] = SPLIT ? c[e] + m[e] : m[e];
  }
}

// The value a tier's products see of one staged input weight (hi + lo at
// f32x3): the tangent seeds.
__device__ __forceinline__ float seed(float w) { return w; }
__device__ __forceinline__ float seed(tier::Pair w) { return w.hi + w.lo; }

// Bias element pair of column tile j for this lane (columns 8j + 2q, +1;
// 0 past the width). W is even, so both or neither are in range.
template <int W>
__device__ __forceinline__ void load_bias(const float* __restrict__ b, int j, int q,
                                          float (&out)[2]) {
  const int n = 8 * j + 2 * q;
  out[0] = n < W ? __ldg(b + n) : 0.f;
  out[1] = n < W ? __ldg(b + n + 1) : 0.f;
}

// Stage `nl` hidden layers from `w_h` (f32, (nl, W, W) row-major (in, out))
// into fragment order at the tier, as B = W (the forward product a @ W) or,
// with TRANS, B = W^T (the backward walk's cotangent product zbar @ W^T),
// block-strided, a lane's word a thread (the stores meet no bank twice);
// each thread has the
// loads of kStageUnroll words in flight at once (the stack is read once
// per block, from L2, and a load at a time would cost the serving grid
// tens of microseconds).
constexpr int kStageUnroll = 8;

template <bool SPLIT, int W, bool TRANS = false>
__device__ __forceinline__ void stage_hidden(uint32_t* __restrict__ dst,
                                             const float* __restrict__ w_h, int nl) {
  constexpr int T = tiles8(W);
  constexpr int kTileWords = T * 32 * (SPLIT ? 2 : 1);
  const int total = nl * T * T * 32;  // (layer, column tile, half, lane)
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageUnroll * blockDim.x) {
    float w0[kStageUnroll], w1[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      const int ln = i & 31;
      const int h = (i >> 5) % T;
      const int j = ((i >> 5) / T) % T;
      const int l = (i >> 5) / (T * T);
      const int k = 8 * h + 2 * (ln & 3);
      const int col = 8 * j + (ln >> 2);
      const float* src = w_h + static_cast<size_t>(l) * W * W;
      const bool in = i < total && k < W && col < W;
      if constexpr (TRANS) {  // B = W^T: element (k, col) is w[col][k]
        w0[u] = in ? src[col * W + k] : 0.f;
        w1[u] = in ? src[col * W + k + 1] : 0.f;
      } else {
        w0[u] = in ? src[k * W + col] : 0.f;
        w1[u] = in ? src[(k + 1) * W + col] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total)
        stage_half<SPLIT, T>(dst + (i >> 5) / T * kTileWords, (i >> 5) % T, i & 31, w0[u], w1[u]);
    }
  }
}

}  // namespace mmafrag
