// The backward walk of K1, K3 and K4 at the bf16 and f32x3 tiers on Hopper's
// tensor cores (included by continuity_train_step.cu, mlp_bwd.cu and
// mlp_bwd_rebuild.cu for the -DTIER_ONLY=1 and =2 variants; the f32 tier
// keeps the CUDA-core walk of mlp_bwd_common.cuh, whose header says what the
// walk computes, its state policies and its partial rows).
//
// Both tiers are bf16 operands against bf16 weights with f32 sums (tier.cuh,
// ops/tiers.py): bf16 one product of the rounded values, f32x3 three,
// (a_lo*w_hi + a_hi*w_lo) + a_hi*w_hi with the cross and main sums apart.
// That is what mma.sync m16n8k16 (m16n8k8 for an odd last half k-tile)
// computes, as K2's tensor-core body does (mlp_fwd_tangents_mma.cuh, whose
// fragment helpers mma_frag.cuh holds for both):
//
// * Points on the MMA's m. A tile of P points runs on P / 16 warps (the
//   2P threads of the lane-pair walk), a warp per 16 points. The width is
//   padded to N_p = 8 * tiles8(W) neurons with zero weights and biases, so
//   padded neurons keep value, tangents and cotangents 0 in both
//   directions. Lane (g, q) holds, for the primal and each tangent stream,
//   rows g and g + 8 and columns 8j + 2q, 8j + 2q + 1 of every column tile
//   j: the accumulator of a product is the next product's A operand
//   (Half), and the elementwise work (act, act', the state products, zbar
//   = (ca + act''*Dbar)*act', Dbar = sum_k ct^k u^k) needs no shuffle.
// * Products. The forward replay a <- act(a @ W + b), t^k <- (t^k @ W) *
//   act' (K4's segment re-runs too), and the cotangent product [zbar;
//   ubar^k] @ W^T, the stacked operand rounded (bf16) or split (f32x3) as
//   the tier says; the output layer's y = a @ w_out + b (K1 only) and its
//   cotangent ybar @ w_out^T. The 1 + K streams share each layer's B
//   fragments, loaded once per layer and product. The input layer runs on
//   the CUDA cores per accumulator element, in the tier's semantics.
// * Weights. Every hidden layer in two images in shared memory, in fragment
//   order (mma_frag.cuh stage_hidden): forward (B = W) and backward (B =
//   W^T), T^2 * 128 bytes a layer and direction (twice at f32x3). The plan
//   (plan() below; ops/walk_mma_plan.py mirrors it) keeps both directions
//   of the whole stack resident where they fit (two regions: no restaging
//   between tiles); else a StoreAll walk stages one region, the forward
//   images chunk by chunk and then the backward ones, and a Rebuild walk
//   keeps a forward and a backward region of `chunk` layers, a multiple of
//   its segment length C, so that a segment's re-run and its walk back
//   find both. A block stages a chunk once per tile where it needs it.
// * Weight gradient. dW = sum over points and streams of [a; t^k]^T
//   [zbar; ubar^k]. bf16: f32 products on the CUDA cores, as the pinned
//   tier says (mlp_bwd_common.cuh accum_square / accum_rect), from rows
//   staged out of the fragment layout: row n of stream s at (s*W + n) * ld
//   + point, ld = stage_ld(P) = 4 mod 32, so a warp's stores (rows 8j + 2q
//   + e, points g + 8e') meet 32 distinct banks (rows 2 apart start 8 banks
//   apart) and accum_square reads as before. f32x3: on the tensor cores with
//   both operands split, from registers: movmatrix transposes each 8 x 8
//   word of the split operands, so a warp multiplies its own 16 points as
//   the k of m16n8k16 (m = 16 input neurons, n = 8 output neurons) and
//   nothing is staged; each warp writes its partial dW and bias sums to
//   its own slot, in the staging blocks that the hidden layers leave unused
//   at f32x3. The bias sums (f32, of the unsplit zbar) reduce over g with
//   three shuffles. The input and output layers'
//   gradients (d_in, d_out <= 8 rows) stay accum_rect from staged rows at
//   both tiers.
// * States. The lane's own elements only, as float4 (rows g, g + 8 x
//   neurons n, n + 1): StoreAll in the device scratch, Rebuild's segment
//   buffer in shared memory. A warp's 16 points take S * W * 16 floats of a
//   state, tile j's float4 of lane (g, q) at s*4W + 32j + g*Q_j + q, Q_j =
//   min(4, W/2 - 4j) real neuron pairs (state_f4): a warp's 32 lanes write
//   contiguous 16-byte words (no bank conflict in shared memory, whole
//   lines in device memory) and a state takes the f32 walk's floats, so the
//   wrappers' scratch and ops/walk_plan.py are unchanged.
// * Determinism. Each block adds its tiles to its own partial row in tile
//   order and reduce_kernel sums the rows in block order; the reduction
//   buffer's slots are summed in slot order (flush). No atomics.
// * tanhf stays the accurate one and there is no fast math: tanh.approx's
//   2^-11 error would show at f32x3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_bwd_common.cuh"
#include "mma_frag.cuh"

namespace mlp_bwd {
namespace mma {

using mmafrag::BWord;
using mmafrag::Half;
using mmafrag::load_bias;
using mmafrag::load_tile_b;
using mmafrag::make_half;
using mmafrag::mma16816;
using mmafrag::mma1688;
using mmafrag::product;
using mmafrag::seed;
using mmafrag::stage_half;
using mmafrag::stage_hidden;
using mmafrag::tiles8;
using mmafrag::transpose8x8;

constexpr int kRows = 16;  // points per warp: the m16 of the MMA

// Bytes of one fragment word: a bf16x2, or a (hi, lo) pair of them at f32x3.
__host__ __device__ constexpr int unit_bytes(bool split) { return split ? 8 : 4; }

// Bytes of one hidden layer's image in one direction: T^2 * 128 (T = tiles8(W)),
// twice that at f32x3.
__host__ __device__ constexpr size_t layer_bytes(int W, bool split) {
  return static_cast<size_t>(tiles8(W)) * tiles8(W) * 32 * unit_bytes(split);
}

// Floats of the reduction buffer of a tile of P points: the bound of
// accum_rect's ranges (mlp_bwd::red_floats) and, at bf16, accum_square's.
// The f32x3 hidden layers' slots (one W*W + W a warp) take the staging
// blocks instead, which those layers leave unused: (P/16) * (W*W + W) <=
// 2 * S * W * stage_ld(P) for every W <= 32 (equal at W = 32, S = 1, P =
// 128).
__host__ __device__ inline int red_floats(int W, int S, int P, int max_out, bool split) {
  const int T = kLanes * P;
  int rect = 2 * T;
  const int in = (kMaxIn + 1) * W, out = (max_out + 1) * W;
  rect = rect > in ? rect : in;
  rect = rect > out ? rect : out;
  const int square = split ? 0 : square_splits(W, S, P, T) * (W * W + W);
  return square > rect ? square : rect;
}

// Dynamic shared memory of a walk, in bytes: the two staging blocks of S*W
// rows, the reduction buffer, Rebuild's segment buffer of `seg` states,
// `regions` regions of `chunk` hidden layers' images, w_in at the tier and
// the output layer's two images; every region 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int W, int S, int max_out, int chunk, int regions,
                                             bool split, int seg, int P) {
  using tier::align16;
  const size_t u = unit_bytes(split), t = tiles8(W);
  return 2 * align16(static_cast<size_t>(S) * W * stage_ld(P) * 4) +
         align16(static_cast<size_t>(red_floats(W, S, P, max_out, split)) * 4) +
         align16(static_cast<size_t>(seg) * S * W * P * 4) +
         align16(static_cast<size_t>(regions) * chunk * layer_bytes(W, split)) +
         align16(kMaxIn * 8 * t * u) + 2 * align16(t * 32 * u);
}

// The most hidden layers (at most n_stack) each of `regions` regions holds
// beside the rest within `limit` bytes; 0 when not even one does. A layer's
// bytes are a multiple of 128, so the regions need no alignment.
__host__ __device__ inline int fit_layers(int W, int S, int max_out, int n_stack, int regions,
                                          bool split, int seg, int P, long long limit) {
  const long long rest = static_cast<long long>(smem_bytes(W, S, max_out, 0, regions, split, seg, P));
  if (rest > limit) return 0;
  const long long fit = (limit - rest) / (regions * static_cast<long long>(layer_bytes(W, split)));
  return static_cast<int>(fit < n_stack ? fit : n_stack);
}

// A walk's plan: Rebuild's segment length (0 for StoreAll), the layers of a
// region and the regions (2: a forward and a backward one).
struct Plan {
  int ckpt, chunk, regions;
};

constexpr int kMaxAutoCkpt = 8;

// A Rebuild walk's chunk for segments of c layers: both directions in two
// regions of the whole stack, or of a multiple of c layers; 0 when no
// segment fits.
__host__ __device__ inline int rebuild_chunk(int W, int S, int max_out, int n_stack, bool split,
                                             int c, int P, long long limit) {
  const int f = fit_layers(W, S, max_out, n_stack, 2, split, c, P, limit);
  return f >= n_stack ? n_stack : f - f % c;
}

// The plan of a walk of n_stack hidden layers on tiles of P points within
// `limit` bytes of shared memory (ops/walk_mma_plan.py::plan computes the
// same). StoreAll: both directions of the whole stack where they fit, else
// one region of the most layers that fit. Rebuild: two regions; `ckpt` > 0
// asks for that C (cut to n_stack), 0 takes the largest C <= kMaxAutoCkpt
// that leaves the whole stack in the regions, else half of it, else one
// layer. Returns false when nothing fits.
__host__ __device__ inline bool plan(int W, int S, int max_out, int n_stack, bool split,
                                     bool rebuild, int ckpt, int P, long long limit, Plan* out) {
  if (!rebuild) {
    if (n_stack <= 0) {
      *out = Plan{0, 0, 1};
      return static_cast<long long>(smem_bytes(W, S, max_out, 0, 1, split, 0, P)) <= limit;
    }
    const int regions = fit_layers(W, S, max_out, n_stack, 2, split, 0, P, limit) >= n_stack ? 2 : 1;
    *out = Plan{0, fit_layers(W, S, max_out, n_stack, regions, split, 0, P, limit), regions};
    return out->chunk >= 1;
  }
  if (n_stack <= 0) {
    *out = Plan{1, 0, 2};
    return static_cast<long long>(smem_bytes(W, S, max_out, 0, 2, split, 1, P)) <= limit;
  }
  int c = 0;
  if (ckpt > 0) {
    c = ckpt < n_stack ? ckpt : n_stack;
    if (rebuild_chunk(W, S, max_out, n_stack, split, c, P, limit) < 1) return false;
  } else {
    const int top = kMaxAutoCkpt < n_stack ? kMaxAutoCkpt : n_stack;
    const int needs[3] = {n_stack, (n_stack + 1) / 2, 1};
    for (int i = 0; i < 3 && c == 0; ++i) {
      for (int cand = top; cand >= 1 && c == 0; --cand) {
        if (rebuild_chunk(W, S, max_out, n_stack, split, cand, P, limit) >= needs[i]) c = cand;
      }
    }
    if (c == 0) return false;
  }
  *out = Plan{c, rebuild_chunk(W, S, max_out, n_stack, split, c, P, limit), 2};
  return true;
}

// The opt-in shared memory of a block on the current device (0 on error).
inline long long device_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// z[j] (column tile j) = init + a @ B, the forward products at the tier,
// over KT half k-tiles. f32x3: mma_frag.cuh's product (K2's; the cross and
// main sums apart). bf16: one m16n8k8 per half k-tile from zero, the
// partial sums added in f32 in k order, then init. The H100's MMA
// truncates each addend to the alignment of the largest, its C operand
// included (tools/k2_mma_rounding.py); with eight products a sum and none
// carrying the running sum or the bias, the states the backward reads stay
// close enough to the plain tier's that the 100-layer walk meets
// compare_tier (K2's chained k16 sums put K3-bf16's dw_in at 1.9x the
// limit, these at 0.8x, the lane-pair walk at 0.6x; the cotangent
// product's sums move it by under 0.1x, so it keeps K2's; PERF.md,
// section 6).
template <bool SPLIT, int NT, int KT>
__device__ __forceinline__ void tier_product(float (&z)[NT][4], const Half (&a)[KT],
                                             const BWord (&b)[NT][KT],
                                             const float (&init)[NT][2]) {
  if constexpr (SPLIT) {
    product<true, NT, KT>(z, a, b, init);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float s[4];
#pragma unroll
      for (int h = 0; h < KT; ++h) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        mma1688(m, a[h].hi[0], a[h].hi[1], b[j][h].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = h == 0 ? m[e] : s[e] + m[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = s[e] + init[j][e & 1];
    }
  }
}

// ------------------------------------------------------------ lane helpers

// Where lane (g, q) keeps its float4 of column tile j of stream s in a
// warp's S * W * 16 floats of a state (in float4 units); -1 for a padded
// neuron pair.
template <int W>
__device__ __forceinline__ int state_f4(int s, int j, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int real = W / 2 - 4 * j, qj = real < 4 ? real : 4;
  return q < qj ? s * 4 * W + 32 * j + g * qj + q : -1;
}

template <int W, int K>
__device__ __forceinline__ void store_state(float* __restrict__ st, int lane,
                                            const float (&sa)[tiles8(W)][4],
                                            const float (&su)[tdim(K)][tiles8(W)][4]) {
  float4* p = reinterpret_cast<float4*>(st);
#pragma unroll
  for (int j = 0; j < tiles8(W); ++j) {
    const int o = state_f4<W>(0, j, lane);
    if (o < 0) continue;
    p[o] = make_float4(sa[j][0], sa[j][1], sa[j][2], sa[j][3]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      p[o + (1 + k) * 4 * W] = make_float4(su[k][j][0], su[k][j][1], su[k][j][2], su[k][j][3]);
  }
}

template <int W, int K>
__device__ __forceinline__ void load_state(const float* __restrict__ st, int lane,
                                           float (&sa)[tiles8(W)][4],
                                           float (&su)[tdim(K)][tiles8(W)][4]) {
  const float4* p = reinterpret_cast<const float4*>(st);
#pragma unroll
  for (int j = 0; j < tiles8(W); ++j) {
    const int o = state_f4<W>(0, j, lane);
    const float4 v = o < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : p[o];
    sa[j][0] = v.x; sa[j][1] = v.y; sa[j][2] = v.z; sa[j][3] = v.w;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 u = o < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : p[o + (1 + k) * 4 * W];
      su[k][j][0] = u.x; su[k][j][1] = u.y; su[k][j][2] = u.z; su[k][j][3] = u.w;
    }
  }
}

// The tangent t = u * act'(a) of one element of a state.
template <int ACT>
__device__ __forceinline__ float tangent(float u, float a) {
  return u * dact<ACT>(a);
}

// Rows `rows` (n < rows) of the accumulator layout v (NT column tiles) into
// staging rows row0 + n at column col (this warp's first point): element
// (j, e) is neuron 8j + 2q + (e & 1) of point g + 8 (e >> 1).
template <int NT>
__device__ __forceinline__ void stage_rows(float* __restrict__ s_X, int ld, int row0, int rows,
                                           int col, int lane, const float (&v)[NT][4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * q + (e & 1);
      if (n < rows) s_X[(row0 + n) * ld + col + g + 8 * (e >> 1)] = v[j][e];
    }
}

// The staged state rows [a; t^0; ...] (W rows each) of (sa, su).
template <int W, int ACT, int K>
__device__ __forceinline__ void stage_state(float* __restrict__ s_A, int ld, int col, int lane,
                                            const float (&sa)[tiles8(W)][4],
                                            const float (&su)[tdim(K)][tiles8(W)][4]) {
  constexpr int T = tiles8(W);
  stage_rows<T>(s_A, ld, 0, W, col, lane, sa);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t[T][4];
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = tangent<ACT>(su[k][j][e], sa[j][e]);
    stage_rows<T>(s_A, ld, (1 + k) * W, W, col, lane, t);
  }
}

// The operands of the next product from a state (sa, su): a, and t^k = u^k *
// act'(a), rounded or split.
template <bool SPLIT, int W, int ACT, int K>
__device__ __forceinline__ void state_halves(const float (&sa)[tiles8(W)][4],
                                             const float (&su)[tdim(K)][tiles8(W)][4],
                                             Half (&a)[tiles8(W)], Half (&t)[tdim(K)][tiles8(W)]) {
#pragma unroll
  for (int j = 0; j < tiles8(W); ++j) {
    a[j] = make_half<SPLIT>(sa[j][0], sa[j][1], sa[j][2], sa[j][3]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      t[k][j] = make_half<SPLIT>(tangent<ACT>(su[k][j][0], sa[j][0]),
                                 tangent<ACT>(su[k][j][1], sa[j][1]),
                                 tangent<ACT>(su[k][j][2], sa[j][2]),
                                 tangent<ACT>(su[k][j][3], sa[j][3]));
  }
}

// One hidden layer forward for every stream, from the layer's forward image
// `sw` and bias `b`: (sa, su) <- (act(a @ W + b), t^k @ W), the state it
// leaves; a, t^k <- its operands for the next layer (t^k = u^k * act'(a)).
template <class Tier, int W, int ACT, int K>
__device__ __forceinline__ void fwd_layer(const uint32_t* __restrict__ sw,
                                          const float* __restrict__ b, int lane,
                                          Half (&a)[tiles8(W)], Half (&t)[tdim(K)][tiles8(W)],
                                          float (&sa)[tiles8(W)][4],
                                          float (&su)[tdim(K)][tiles8(W)][4]) {
  constexpr bool SP = Tier::kSplit;
  constexpr int T = tiles8(W);
  constexpr int kTileWords = T * 32 * (SP ? 2 : 1);
  const int q = lane & 3;
  BWord bw[T][T];
#pragma unroll
  for (int j = 0; j < T; ++j) load_tile_b<SP, T>(sw + j * kTileWords, lane, bw[j]);
  float bias[T][2];
#pragma unroll
  for (int j = 0; j < T; ++j) load_bias<W>(b, j, q, bias[j]);
  tier_product<SP, T, T>(sa, a, bw, bias);
  const float zero[T][2] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) tier_product<SP, T, T>(su[k], t[k], bw, zero);
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[j][e] = act_fn<ACT>(sa[j][e]);
  state_halves<SP, W, ACT, K>(sa, su, a, t);
}

// From the cotangents (ca, ct^k) of a state (sa, su): zbar = (ca +
// act''*Dbar) * act', Dbar = sum_k ct^k u^k, and ubar^k = ct^k * act'.
template <int W, int ACT, int K>
__device__ __forceinline__ void state_bwd(const float (&sa)[tiles8(W)][4],
                                          const float (&su)[tdim(K)][tiles8(W)][4],
                                          const float (&ca)[tiles8(W)][4],
                                          const float (&ct)[tdim(K)][tiles8(W)][4],
                                          float (&zb)[tiles8(W)][4],
                                          float (&ub)[tdim(K)][tiles8(W)][4]) {
#pragma unroll
  for (int j = 0; j < tiles8(W); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = sa[j][e];
      const float d = dact<ACT>(a);
      if constexpr (K > 0) {
        float dbar = ct[0][j][e] * su[0][j][e];
#pragma unroll
        for (int k = 1; k < K; ++k) dbar = dbar + ct[k][j][e] * su[k][j][e];
        zb[j][e] = (ca[j][e] + ddact<ACT>(a, dbar)) * d;
      } else {
        zb[j][e] = ca[j][e] * d;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) ub[k][j][e] = ct[k][j][e] * d;
    }
}

// out <- in @ W^T for one stream: the cotangent product with the backward
// image's B fragments bw (K2's chained sums; tier_product says why).
template <bool SPLIT, int T>
__device__ __forceinline__ void cotangent(float (&out)[T][4], const Half (&in)[T],
                                          const BWord (&bw)[T][T]) {
  const float zero[T][2] = {};
  product<SPLIT, T, T>(out, in, bw, zero);
}

// The f32x3 weight gradient of this warp's 16 points into its slot `red`
// (W*W + W floats: dW[i][o] row-major, then db[o]): dW = sum over streams
// of A^T B, A = [a; t^k] of the layer's input state (split here from pa,
// pu), B = [zbar; ubar^k] (split already: the cotangent product's
// operands). Each 8 x 8 word of the operands is transposed (movmatrix), so
// the points are the k of the MMA: a-fragment (i = 16 mt + g (+8), points
// 2q, 2q + 1 (+8)) from tiles 2mt and 2mt + 1, b-fragment (points, o = 8 jo
// + g) from tile jo. db: f32 sums of the unsplit zbar over the warp's
// points.
template <int W, int ACT, int K>
__device__ __forceinline__ void wgrad_mma(const float (&pa)[tiles8(W)][4],
                                          const float (&pu)[tdim(K)][tiles8(W)][4],
                                          const Half (&zh)[tiles8(W)],
                                          const Half (&uh)[tdim(K)][tiles8(W)],
                                          const float (&zb)[tiles8(W)][4], int lane,
                                          float* __restrict__ red) {
  constexpr int T = tiles8(W), MT = (T + 1) / 2, S = 1 + K;
  float crs[MT][T][4], acc[MT][T][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) crs[m][j][e] = acc[m][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t ah[2 * MT][2], al[2 * MT][2], bh[T][2], bl[T][2];
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      if (j < T) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = s == 0 ? pa[j][e] : tangent<ACT>(pu[s > 0 ? s - 1 : 0][j][e], pa[j][e]);
        const Half h = make_half<true>(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ah[j][r] = transpose8x8(h.hi[r]);
          al[j][r] = transpose8x8(h.lo[r]);
        }
      } else {
        ah[j][0] = ah[j][1] = al[j][0] = al[j][1] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const Half& h = s == 0 ? zh[j] : uh[s > 0 ? s - 1 : 0][j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bh[j][r] = transpose8x8(h.hi[r]);
        bl[j][r] = transpose8x8(h.lo[r]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < T; ++j) {
        mma16816(crs[m][j], al[2 * m][0], al[2 * m + 1][0], al[2 * m][1], al[2 * m + 1][1],
                 bh[j][0], bh[j][1]);
        mma16816(crs[m][j], ah[2 * m][0], ah[2 * m + 1][0], ah[2 * m][1], ah[2 * m + 1][1],
                 bl[j][0], bl[j][1]);
        mma16816(acc[m][j], ah[2 * m][0], ah[2 * m + 1][0], ah[2 * m][1], ah[2 * m + 1][1],
                 bh[j][0], bh[j][1]);
      }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * m + g + 8 * (e >> 1), o = 8 * j + 2 * q + (e & 1);
        if (i < W && o < W) red[i * W + o] = crs[m][j][e] + acc[m][j][e];
      }
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = zb[j][e] + zb[j][e + 2];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      const int o = 8 * j + 2 * q + e;
      if (g == 0 && o < W) red[W * W + o] = v;
    }
}

// The epilogue of K3 and K4 on the tensor-core walk: ybar and dybar of the
// lane's elements (points p[e >> 1], output 2q + (e & 1)), loaded; zero
// past N and past d_out.
struct LoadedCotangents {
  static constexpr int kMaxOut = mlp_bwd::LoadedCotangents::kMaxOut;
  static constexpr int kExtra = 0;
  static constexpr bool kForward = false;  // the output layer's forward is not needed

  const float *ybar, *dybar;
  int n;

  template <class Tier, int K>
  __device__ __forceinline__ void output(const long long (&p)[2], int lane, int d_out,
                                         const float (&)[4], const float (&)[tdim(K)][4],
                                         float (&yb)[4], float (&ybt)[tdim(K)][4]) const {
    const int q = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pp = p[e >> 1];
      const int o = 2 * q + (e & 1);
      const bool live = pp < n && o < d_out;
      yb[e] = live ? ybar[pp * d_out + o] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        ybt[k][e] = live ? dybar[(static_cast<long long>(k) * n + pp) * d_out + o] : 0.f;
    }
  }

  __device__ __forceinline__ void stage(float*, int, int, int) const {}

  __device__ __forceinline__ void reduce(const float*, int, int, float*, bool) const {}
};

// The walk over this block's tiles on the tensor cores (the tiers'
// semantics and the walk's order are mlp_bwd_common.cuh's walk). Epi:
//   kMaxOut, kExtra, kForward (constants): most heads, floats of its own
//     sums, whether it needs the output layer's forward;
//   output<Tier, K>(p, lane, d_out, y, dy, yb, ybt): ybar and ybar^k of the
//     lane's elements from y and dy (the output layer's forward, when
//     kForward) or from its inputs;
//   stage(sB, ld, col, lane): its per-point values into staging rows >=
//     (1+K)*d_out;
//   reduce(s_B, ld, P, g_extra, first): its sums over the tile's points.
template <class Tier, class Policy, int W, int ACT, int K, class Epi>
__device__ __forceinline__ void walk(const WalkArgs& args, Epi& epi, unsigned char* smem) {
  using WV = typename Tier::WV;
  using tier::align16;
  constexpr bool SP = Tier::kSplit;
  constexpr int T = tiles8(W), NP = 8 * T, S = 1 + K, KS = tdim(K);
  constexpr int U = SP ? 2 : 1;
  constexpr int kTileWords = T * 32 * U;  // a column tile of a W-row image
  constexpr int kLayerWords = T * kTileWords;
  constexpr int kOut = Epi::kMaxOut;
  const int n_stack = args.n_stack, d_in = args.d_in, d_out = args.d_out, chunk = args.chunk;
  const int regions = args.regions;
  const int ckpt = Policy::kRebuild ? args.ckpt : 0;
  const int P = args.tile, ld = stage_ld(P);
  unsigned char* cur = smem;
  auto carve = [&](size_t bytes) { unsigned char* q = cur; cur += align16(bytes); return q; };
  float* s_A = reinterpret_cast<float*>(carve(static_cast<size_t>(S) * W * ld * 4));
  float* s_B = reinterpret_cast<float*>(carve(static_cast<size_t>(S) * W * ld * 4));
  float* s_red = reinterpret_cast<float*>(
      carve(static_cast<size_t>(red_floats(W, S, P, kOut, SP)) * 4));
  float* s_seg = reinterpret_cast<float*>(
      carve(static_cast<size_t>(Policy::kRebuild ? ckpt : 0) * S * W * P * 4));
  uint32_t* s_img = reinterpret_cast<uint32_t*>(
      carve(static_cast<size_t>(regions) * chunk * kLayerWords * 4));
  WV* s_win = reinterpret_cast<WV*>(carve(kMaxIn * NP * sizeof(WV)));
  uint32_t* s_wof = reinterpret_cast<uint32_t*>(carve(kTileWords * 4));  // B = w_out
  uint32_t* s_wob = reinterpret_cast<uint32_t*>(carve(kTileWords * 4));  // B = w_out^T

  const int tid = threadIdx.x, T_ = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // w_in at the tier ([c][N_p]) and the output layer's images, once per block
  for (int i = tid; i < kMaxIn * NP; i += T_) {
    const int c = i / NP, col = i % NP;
    s_win[i] = tier::w_ld(Tier::to_w(c < d_in && col < W ? args.w_in[c * W + col] : 0.f));
  }
  for (int i = tid; i < T * 32; i += T_) {
    const int h = i >> 5, ln = i & 31, lq = ln & 3, lg = ln >> 2;
    // forward: half k-tile h (neurons k, k + 1), column (output) lg
    const int k = 8 * h + 2 * lq;
    const bool in = k < W && lg < d_out;
    stage_half<SP, T>(s_wof, h, ln, in ? args.w_out[k * d_out + lg] : 0.f,
                      in ? args.w_out[(k + 1) * d_out + lg] : 0.f);
    // backward: column tile h (neuron 8h + lg), rows (outputs) 2lq, 2lq + 1
    const int nn = 8 * h + lg, o = 2 * lq;
    stage_half<SP, 1>(s_wob + h * 32 * U, 0, ln,
                      nn < W && o < d_out ? args.w_out[nn * d_out + o] : 0.f,
                      nn < W && o + 1 < d_out ? args.w_out[nn * d_out + o + 1] : 0.f);
  }

  // Per-block partial sums, in the flat order of the parameters' sorted
  // keys (b_hidden, b_in, b_out, w_hidden, w_in, w_out), then the extras.
  float* part = args.partial + blockIdx.x * (n_params(W, d_in, d_out, n_stack) + Epi::kExtra);
  float* g_bh = part;
  float* g_bin = g_bh + n_stack * W;
  float* g_bout = g_bin + W;
  float* g_wh = g_bout + d_out;
  float* g_win = g_wh + static_cast<long long>(n_stack) * W * W;
  float* g_wout = g_win + d_in * W;
  float* g_extra = g_wout + W * d_out;

  // This warp's part of each state (state_f4): in the device scratch
  // (StoreAll: state s at slot s; Rebuild: checkpoint s, state s*C, at slot
  // s) and Rebuild's segment buffer (slot i: state j0 + 1 + i).
  const size_t state_floats = static_cast<size_t>(S) * W * P;
  const size_t warp_floats = static_cast<size_t>(S) * W * kRows * warp;
  float* st0 = args.states +
               static_cast<size_t>(blockIdx.x) * scratch_states(n_stack, ckpt) * state_floats +
               warp_floats;
  auto state = [&](int s) { return st0 + static_cast<size_t>(s) * state_floats; };
  float* seg0 = s_seg + warp_floats;
  auto seg = [&](int i) { return seg0 + static_cast<size_t>(i) * state_floats; };
  auto fwd_slot = [&](int s) -> float* {
    if constexpr (Policy::kRebuild) {
      return (s % ckpt == 0 && s < n_stack) ? state(s / ckpt) : nullptr;
    } else {
      return state(s);
    }
  };

  // The images: region `regions == 2 ? dir : 0` holds chunk c of direction
  // dir (0 forward, 1 backward) when loaded[region] == 2 * c + dir. Two
  // regions of the whole stack are staged together, once per block.
  int loaded[2] = {-1, -1};
  auto stage = [&](int dir, int c) {
    const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
    const float* src = args.w_h + static_cast<size_t>(l0) * W * W;
    uint32_t* base = s_img + static_cast<size_t>(regions == 2 ? dir : 0) * chunk * kLayerWords;
    if (dir == 0) {
      stage_hidden<SP, W, false>(base, src, nl);
    } else {
      stage_hidden<SP, W, true>(base, src, nl);
    }
    loaded[regions == 2 ? dir : 0] = 2 * c + dir;
  };
  auto image = [&](int dir, int l) -> const uint32_t* {
    const int c = l / chunk, r = regions == 2 ? dir : 0;
    if (loaded[r] != 2 * c + dir) {
      __syncthreads();  // nobody reads the region any more
      stage(dir, c);
      if (regions == 2 && chunk >= n_stack && loaded[1 - r] < 0) stage(1 - dir, 0);
      __syncthreads();
    }
    return s_img + (static_cast<size_t>(r) * chunk + (l - c * chunk)) * kLayerWords;
  };

  const int col = kRows * warp;  // this warp's first point in the tile
  const int n_tiles = (args.n + P - 1) / P;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const long long base = static_cast<long long>(tile) * P + col;
    const long long p[2] = {base + g, base + g + 8};
    __syncthreads();  // the output layer's images are staged; the buffers are free

    // ---- forward: input layer on the CUDA cores, per accumulator element
    Half a[T], t[KS][T];
    float sa[T][4], su[KS][T][4];
    {
      typename Tier::Op xo[2][kMaxIn];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c)
          xo[rr][c] = Tier::op(p[rr] < args.n && c < d_in ? args.coords[p[rr] * d_in + c] : 0.f);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        float bias[2];
        load_bias<W>(args.b_in, j, q, bias);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * q + (e & 1);
          typename Tier::Acc z = Tier::acc(bias[e & 1]);
#pragma unroll
          for (int c = 0; c < kMaxIn; ++c) {
            if (c < d_in) Tier::mac(z, xo[e >> 1][c], s_win[c * NP + cl]);
          }
          sa[j][e] = act_fn<ACT>(Tier::fin(z));
#pragma unroll
          for (int k = 0; k < K; ++k) su[k][j][e] = seed(s_win[k * NP + cl]);
        }
      }
      state_halves<SP, W, ACT, K>(sa, su, a, t);
      store_state<W, K>(state(0), lane, sa, su);
    }
    // ---- forward: hidden stack
#pragma unroll 1
    for (int l = 0; l < n_stack; ++l) {
      fwd_layer<Tier, W, ACT, K>(image(0, l), args.b_h + static_cast<size_t>(l) * W, lane, a, t,
                                 sa, su);
      if (float* slot = fwd_slot(l + 1)) store_state<W, K>(slot, lane, sa, su);
    }

    // ---- the output cotangents (the output layer's forward for K1)
    float yb[4], ybt[KS][4];
    {
      float y[4] = {0.f, 0.f, 0.f, 0.f}, dy[KS][4];
      if constexpr (Epi::kForward) {
        BWord bo[1][T];
        load_tile_b<SP, T>(s_wof, lane, bo[0]);
        float init[1][2];
        init[0][0] = 2 * q < d_out ? __ldg(args.b_out + 2 * q) : 0.f;
        init[0][1] = 2 * q + 1 < d_out ? __ldg(args.b_out + 2 * q + 1) : 0.f;
        const float zero[1][2] = {};
        float yo[1][4];
        tier_product<SP, 1, T>(yo, a, bo, init);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = yo[0][e];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float d[1][4];
          tier_product<SP, 1, T>(d, t[k], bo, zero);
#pragma unroll
          for (int e = 0; e < 4; ++e) dy[k][e] = d[0][e];
        }
      }
      epi.template output<Tier, K>(p, lane, d_out, y, dy, yb, ybt);
    }

    // ---- output layer backward: stage s_L = [a; t^0; ...] and [ybar;
    // ybar^0; ...] (and the epilogue's rows)
    stage_state<W, ACT, K>(s_A, ld, col, lane, sa, su);
    {
      const float ybv[1][4] = {{yb[0], yb[1], yb[2], yb[3]}};
      stage_rows<1>(s_B, ld, 0, d_out, col, lane, ybv);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v[1][4] = {{ybt[k][0], ybt[k][1], ybt[k][2], ybt[k][3]}};
        stage_rows<1>(s_B, ld, (1 + k) * d_out, d_out, col, lane, v);
      }
      epi.stage(s_B, ld, col, lane);
    }
    __syncthreads();  // layer barrier
    Pending pend{g_wout, g_bout, W * d_out, d_out,
                 accum_rect<Tier, S>(s_A, W, s_B, d_out, ld, P, s_red)};
    const float* pend_red = s_red;  // where the pending product's ranges are
    epi.reduce(s_B, ld, P, g_extra, first);

    // cotangent into the last state: [ybar; ybar^k] (at the tier) @ w_out^T
    float ca[T][4], ct[KS][T][4];
    {
      BWord bo[T][1];
#pragma unroll
      for (int j = 0; j < T; ++j) load_tile_b<SP, 1>(s_wob + j * 32 * U, lane, bo[j]);
      const float zero[T][2] = {};
      const Half yh[1] = {make_half<SP>(yb[0], yb[1], yb[2], yb[3])};
      product<SP, T, 1>(ca, yh, bo, zero);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Half th[1] = {make_half<SP>(ybt[k][0], ybt[k][1], ybt[k][2], ybt[k][3])};
        product<SP, T, 1>(ct[k], th, bo, zero);
      }
    }

    // ---- hidden stack backward, layer j maps state j -> state j + 1; (sa,
    // su) holds state j + 1; the layer reads state j once, stages it (bf16)
    // or splits it (f32x3) for its weight gradient and keeps it for the next.
    auto back_layer = [&](int j, const float* st_prev) {
      const uint32_t* w = image(1, j);
      float pa[T][4], pu[KS][T][4];  // state j, loaded while the flush and state_bwd run
      load_state<W, K>(st_prev, lane, pa, pu);
      __syncthreads();  // the previous product is done: the buffers are free
      flush(pend_red, pend, first);
      float zb[T][4], ub[KS][T][4];
      state_bwd<W, ACT, K>(sa, su, ca, ct, zb, ub);
      Half zh[T], uh[KS][T];
#pragma unroll
      for (int jj = 0; jj < T; ++jj) {
        zh[jj] = make_half<SP>(zb[jj][0], zb[jj][1], zb[jj][2], zb[jj][3]);
#pragma unroll
        for (int k = 0; k < K; ++k)
          uh[k][jj] = make_half<SP>(ub[k][jj][0], ub[k][jj][1], ub[k][jj][2], ub[k][jj][3]);
      }
      if constexpr (SP) {
        __syncthreads();  // the flush has read the slots
        wgrad_mma<W, ACT, K>(pa, pu, zh, uh, zb, lane, s_A + warp * (W * W + W));
        pend = Pending{g_wh + static_cast<size_t>(j) * W * W, g_bh + j * W, W * W, W, P / kRows};
        pend_red = s_A;
      } else {
        stage_rows<T>(s_B, ld, 0, W, col, lane, zb);
#pragma unroll
        for (int k = 0; k < K; ++k) stage_rows<T>(s_B, ld, (1 + k) * W, W, col, lane, ub[k]);
        stage_state<W, ACT, K>(s_A, ld, col, lane, pa, pu);
        __syncthreads();  // layer barrier
        pend = Pending{g_wh + static_cast<size_t>(j) * W * W, g_bh + j * W, W * W, W,
                       accum_square<Tier, W, S, true>(s_A, s_B, ld, P, s_red)};
      }
#pragma unroll
      for (int jj = 0; jj < T; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sa[jj][e] = pa[jj][e];
#pragma unroll
          for (int k = 0; k < K; ++k) su[k][jj][e] = pu[k][jj][e];
        }
      BWord bw[T][T];
#pragma unroll
      for (int jj = 0; jj < T; ++jj) load_tile_b<SP, T>(w + jj * kTileWords, lane, bw[jj]);
      cotangent<SP, T>(ca, zh, bw);
#pragma unroll
      for (int k = 0; k < K; ++k) cotangent<SP, T>(ct[k], uh[k], bw);
    };
    if constexpr (Policy::kRebuild) {
      // segments of C layers in reverse: re-run each from its checkpoint
      // into the segment buffer, then walk it back
      const int n_seg = (n_stack + ckpt - 1) / ckpt;
#pragma unroll 1
      for (int sg = n_seg - 1; sg >= 0; --sg) {
        const int j0 = sg * ckpt, len = min(ckpt, n_stack - j0);
        const float* ck = state(sg);
        load_state<W, K>(ck, lane, sa, su);
        state_halves<SP, W, ACT, K>(sa, su, a, t);
#pragma unroll 1
        for (int i = 0; i < len; ++i) {
          fwd_layer<Tier, W, ACT, K>(image(0, j0 + i),
                                     args.b_h + static_cast<size_t>(j0 + i) * W, lane, a, t, sa,
                                     su);
          if (i + 1 < len) store_state<W, K>(seg(i), lane, sa, su);  // the last stays in (sa, su)
        }
#pragma unroll 1
        for (int j = j0 + len - 1; j >= j0; --j) back_layer(j, j == j0 ? ck : seg(j - j0 - 1));
      }
    } else {
#pragma unroll 1
      for (int j = n_stack - 1; j >= 0; --j) back_layer(j, state(j));
    }

    // ---- input layer backward: s_in = [x; e_0; ...], so dw_in[k, :] also
    // collects sum_p ubar_0^k (the tangent seeds are rows k of w_in)
    __syncthreads();
    flush(pend_red, pend, first);
    if (SP && pend_red == s_A) __syncthreads();  // the slots are read before the rows are staged
    {
      float zb[T][4], ub[KS][T][4];
      state_bwd<W, ACT, K>(sa, su, ca, ct, zb, ub);
      stage_rows<T>(s_B, ld, 0, W, col, lane, zb);
#pragma unroll
      for (int k = 0; k < K; ++k) stage_rows<T>(s_B, ld, (1 + k) * W, W, col, lane, ub[k]);
    }
    if (q == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int cl = col + g + 8 * rr;
        for (int c = 0; c < d_in; ++c) {
          s_A[c * ld + cl] = p[rr] < args.n ? args.coords[p[rr] * d_in + c] : 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) s_A[((1 + k) * d_in + c) * ld + cl] = c == k ? 1.f : 0.f;
        }
      }
    }
    __syncthreads();  // layer barrier
    pend = Pending{g_win, g_bin, d_in * W, W,
                   accum_rect<Tier, S>(s_A, d_in, s_B, W, ld, P, s_red, /*seed_rows=*/true)};
    __syncthreads();
    flush(s_red, pend, first);
  }
}

// K3 (StoreAll) and K4 (Rebuild) on the tensor cores.
template <class Tier, class Policy, int W, int ACT, int K>
__global__ void __launch_bounds__(kMaxThreads<Tier, W>)
    cotangent_walk_kernel_mma(const CotangentArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  LoadedCotangents epi{args.ybar, args.dybar, args.walk.n};
  mma::walk<Tier, Policy, W, ACT, K>(args.walk, epi, smem);
}

// One K3/K4 launch at a cheap tier: K and the activation picked at run
// time; smem bytes for the plan in a.walk.
template <class Tier, class Policy, int W, int ACT>
cudaError_t launch_walk_k(const CotangentArgs& a, int n_tangents, size_t smem, int grid,
                                float* out, int n_ent, cudaStream_t stream) {
  const int tile = a.walk.tile;
  switch (n_tangents) {
    case 0: return launch(cotangent_walk_kernel_mma<Tier, Policy, W, ACT, 0>, a, smem, grid,
                          tile, a.walk.partial, out, n_ent, stream);
    case 1: return launch(cotangent_walk_kernel_mma<Tier, Policy, W, ACT, 1>, a, smem, grid,
                          tile, a.walk.partial, out, n_ent, stream);
    case 2: return launch(cotangent_walk_kernel_mma<Tier, Policy, W, ACT, 2>, a, smem, grid,
                          tile, a.walk.partial, out, n_ent, stream);
    default: return launch(cotangent_walk_kernel_mma<Tier, Policy, W, ACT, 3>, a, smem, grid,
                           tile, a.walk.partial, out, n_ent, stream);
  }
}

template <class Tier, class Policy, int W>
cudaError_t launch_walk(const CotangentArgs& a, int n_tangents, int act, size_t smem,
                              int grid, float* out, int n_ent, cudaStream_t stream) {
  return act == 0
             ? launch_walk_k<Tier, Policy, W, 0>(a, n_tangents, smem, grid, out, n_ent, stream)
             : launch_walk_k<Tier, Policy, W, 1>(a, n_tangents, smem, grid, out, n_ent, stream);
}

}  // namespace mma
}  // namespace mlp_bwd
