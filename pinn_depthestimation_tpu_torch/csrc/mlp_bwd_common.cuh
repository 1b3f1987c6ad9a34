// The hand-written MLP backward shared by K1, K3 and K4, tiers f32, bf16 and
// f32x3.
//
// For every point p, with the coordinate tangent seeds e_0 .. e_{K-1}, the
// walk
//   1. replays the forward with K tangent streams (as K2 does), keeping the
//      layer states (a, u^0 .. u^{K-1}; u^k the tangent before the act'
//      scale) as its state policy says (below);
//   2. asks its epilogue for the output cotangents ybar (d_out) and
//      ybar^k (K x d_out): K1 computes them from the continuity losses
//      (continuity_train_step.cu), K3 and K4 load them (mlp_bwd.cu,
//      mlp_bwd_rebuild.cu);
//   3. walks back through the output layer, the hidden stack and the input
//      layer, whose tangent streams start as rows k of w_in, so dw_in[k, :]
//      also collects sum_p ubar_0^k (the tangent-seed term).
// Outputs: every parameter gradient summed over points, in the flat order
// of the parameters' sorted keys (b_hidden, b_in, b_out, w_hidden, w_in,
// w_out), then the epilogue's own sums (kExtra floats).
//
// State policies:
//   StoreAll  every layer state goes to a per-block scratch in device memory
//             and is read back in the walk (K1, K3: the JAX 'stream' body);
//   Rebuild   only every C-th state goes to the device scratch (the
//             checkpoints); the walk takes the segments of C layers in
//             reverse, re-runs each from its checkpoint into a segment
//             buffer of C states in shared memory, and walks it back (K4:
//             the JAX 'rebuild' body). One more forward replay, in exchange
//             for n_stack/C states of device memory instead of n_stack + 1.
//
// Tiers (tier.cuh, ops/tiers.py): at bf16 the weights sit in shared memory
// as bf16, each forward operand and each stacked cotangent is rounded to
// bf16 before it meets a weight, and the weight-gradient products, the sums
// and the staging rows stay f32. At f32x3 the weights sit in shared memory
// as bf16 (hi, lo) pairs (the bytes of f32, so every plan below comes out as
// at f32), the same operands are split before they meet a weight, and the
// weight-gradient products split both staged operands as they read them
// (the staging rows stay f32, so the bias sums see the unsplit values),
// except the input layer's tangent-seed rows, whose sums stay f32. At f32
// every rounding is the identity: true f32 FMAs on the CUDA cores, no TF32
// and no tensor-core product.
//
// Design. A tile of P points (P a multiple of 16, chosen per launch by
// ops/walk_plan.py so that the tiles of one call fill the SMs in one wave
// where they can) runs on one block of 2P threads: a lane pair per point.
// Lane h of a pair owns the output neurons [h*W/2, (h+1)*W/2) of every
// layer for all 1+K streams. Both lanes hold the layer's full input vectors
// (a, t^k forward; the cotangents ca, ct^k backward) in registers (W is a
// compile-time constant: one library per width); each computes its half of
// the layer's outputs from the hidden weights in shared memory (one chunk of
// whole layers when the stack does not fit) and the pair swaps halves with
// one __shfl_xor_sync per value. Elementwise work on the owned half only
// (tanh, the state products) is not repeated. States are laid out
// [state][component][point]; each lane stores and reads back only the
// components it owns, so the state buffers need no barrier, and the state
// of layer j, read once, stays in registers from the layer where it is
// staged for the weight gradient to the next, where its cotangent map needs
// it (one read of each state instead of two); its load starts before the
// layer's first barrier, so the latency overlaps the flush and state_bwd.
//
// Per layer the block forms the W x W weight gradient sum_{c,p} s_A[c][i][p]
// s_B[c][j][p] over the tile's points (s_A: the staged state rows [a;
// t^0..t^{K-1}], s_B: [zbar; ubar^0..]): every thread of the block takes a
// register tile of entries (4 x 5 at W=20: nine 16-byte operand loads feed
// 80 FMAs; 5 x 5 at W=10, 4 x 4 at 8, 16 and 32) and a contiguous range of
// the (stream block, four-point chunk) steps, reads the operand rows four
// points at a time (rows strided 4 banks apart and tiles interleaved so
// that a quarter-warp's loads fall in distinct banks), and writes its
// partial tile to a reduction buffer of at most kSquareRed floats; the
// partials are summed in range order by one fixed thread per entry after
// the next barrier, into the block's partial row. Two barriers per layer: one after
// staging, one before the buffers are staged again; the layer's reduction
// and its cotangent product sit between them. Gradients are sums over every
// point, and Hopper runs blocks in no order: each block of a fixed-size grid
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its own
// partial sums in a scratch row (in tile order); a second kernel sums the
// rows in block order. No atomics: the result is the same bit for bit from
// run to run.
//
// Levers weighed for this design (the split of PERF.md §5 is what ranked
// them): (1) more warps per SM: at the flagship's 12,516 points a thread per
// point gives 391 warps, three per SM, whatever the tile; a lane pair doubles
// that. Four lanes (W/4 neurons each) would double it again but swap 3/4 of
// every vector through shuffles and selects, W=10 does not split by four,
// and each lane would reload a quarter-row of weights per input for a
// quarter of the FMAs; the pair keeps the weight loads at W/2 per input and
// needs one shuffle per value. (2) state traffic: each state is read once
// and kept in registers (above). Rebuilding segments (K4's policy) would put
// the checkpoints in L2 but needs a C-state segment buffer in shared memory,
// which the flagship's 160 KB of weights leave no room for (not one state
// beside the whole stack at P = 96): it stays K4's. (3) the weight-gradient
// product runs on every thread (above) instead of (W/2)^2 threads reading
// one operand per FMA.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// of forward replay (twice for Rebuild, less the output layer) and
// 2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W of backward, plus L*W tanhf,
// against a few bytes of inputs and the weights: the CUDA cores' f32 FMA
// rate bounds it (the bf16 tier runs the same FMAs). What the design spends
// beyond that: StoreAll's layer states go to device memory and back once,
// the pair's shuffles (W*(1+K)/2 per layer and direction), and the shared-
// memory operand loads of the block products. Tensor cores are left for
// later work (ROADMAP.md).

#pragma once

#include <cuda_runtime.h>

#include <initializer_list>

#include "tier.cuh"

namespace mlp_bwd {

using tier::load_vec;
using tier::row_vec;
using tier::w_f;
using tier::w_ld;

// The state policies (header).
struct StoreAll {
  static constexpr bool kRebuild = false;
};
struct Rebuild {
  static constexpr bool kRebuild = true;
};

constexpr int kLanes = 2;      // threads per point (a lane pair)
constexpr int kTileStep = 16;  // a tile's point count is a multiple of this
constexpr int kMaxIn = 8;

// Most points per tile (the block has kLanes times as many threads): 160 for
// the narrow nets at f32 and bf16 (the CMB grid's 20,507 points in one wave
// of 129 tiles), 128 otherwise, so that the registers of one block fit
// (65,536 per SM: 204 a thread at 320 threads, 255 at 256) without spills.
template <class Tier, int W>
__host__ __device__ constexpr int max_tile() {
  return (W <= 10 && !Tier::kSplit) ? 160 : 128;
}

template <class Tier, int W>
constexpr int kMaxThreads = kLanes * max_tile<Tier, W>();

// Stride of a staging row for a tile of P points: a multiple of 4 (16-byte
// loads along the points) that is 4 mod 32, so that neighbouring rows start
// 4 banks apart.
__host__ __device__ inline int stage_ld(int P) { return P % 32 == 0 ? P + 4 : P + 20; }

// Size of a tangent-stream array dimension (C++ has no arrays of length 0).
__host__ __device__ constexpr int tdim(int k) { return k > 0 ? k : 1; }

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if constexpr (ACT == 0) {
    return tanhf(z);
  } else {
    return z >= 0.f ? z : 0.01f * z;
  }
}

// act' from the activation a (for LeakyReLU sign(a) == sign(z)).
template <int ACT>
__device__ __forceinline__ float dact(float a) {
  if constexpr (ACT == 0) {
    return 1.f - a * a;
  } else {
    return a >= 0.f ? 1.f : 0.01f;
  }
}

// d(act')/da times dbar: -2*a*dbar for tanh, 0 for LeakyReLU.
template <int ACT>
__device__ __forceinline__ float ddact(float a, float dbar) {
  if constexpr (ACT == 0) {
    return -2.f * a * dbar;
  } else {
    return 0.f;
  }
}

__device__ __forceinline__ float accumulate(float* dst, float v, bool first) {
  return first ? v : *dst + v;
}

// The full vector v[W] from each lane's owned half o[W/2] (lane h owns
// [h*W/2, (h+1)*W/2)); every lane of the warp calls it.
template <int W>
__device__ __forceinline__ void gather_pair(const float (&o)[W / 2], float (&v)[W], int h) {
  constexpr int H = W / 2;
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    const float other = __shfl_xor_sync(0xffffffffu, o[jj], 1);
    v[jj] = h ? other : o[jj];
    v[H + jj] = h ? o[jj] : other;
  }
}

// Element jj of this lane's half of v (a select: the index stays
// compile-time).
template <int W>
__device__ __forceinline__ float own(const float (&v)[W], int jj, int h) {
  return h ? v[W / 2 + jj] : v[jj];
}

// One hidden layer forward on the lane's half of the outputs: z = a @ w + b,
// z^k = t^k @ w (a and t^k prepared at the tier); a <- act(z), t^k <- z^k *
// act', gathered over the pair; the owned half of the state (a,
// z^0..z^{K-1}) goes to st[c * P] unless st is null.
template <class Tier, int W, int ACT, int K>
__device__ __forceinline__ void hidden_fwd(const typename Tier::WT* __restrict__ w,
                                           const float* __restrict__ b,
                                           float (&a)[W], float (&t)[tdim(K)][W],
                                           float* __restrict__ st, int P, int h) {
  using Acc = typename Tier::Acc;
  using Op = typename Tier::Op;
  using WV = typename Tier::WV;
  constexpr int H = W / 2;
  constexpr int V = row_vec<H>();
  const int j0 = h * H;
  Acc z[H], zt[tdim(K)][H];
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    z[jj] = Tier::acc(b[j0 + jj]);
#pragma unroll
    for (int k = 0; k < K; ++k) zt[k][jj] = Tier::acc(0.f);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const Op ai = Tier::op(a[i]);
    Op ti[tdim(K)];
#pragma unroll
    for (int k = 0; k < K; ++k) ti[k] = Tier::op(t[k][i]);
#pragma unroll
    for (int jj = 0; jj < H; jj += V) {
      WV wv[V];
      load_vec<V>(w + i * W + j0 + jj, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        Tier::mac(z[jj + v], ai, wv[v]);
#pragma unroll
        for (int k = 0; k < K; ++k) Tier::mac(zt[k][jj + v], ti[k], wv[v]);
      }
    }
  }
  float na[H], nt[tdim(K)][H];
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    na[jj] = act_fn<ACT>(Tier::fin(z[jj]));
    const float d = dact<ACT>(na[jj]);
    if (st != nullptr) st[(j0 + jj) * P] = na[jj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float u = Tier::fin(zt[k][jj]);
      if (st != nullptr) st[((1 + k) * W + j0 + jj) * P] = u;
      nt[k][jj] = u * d;
    }
  }
  gather_pair<W>(na, a, h);
#pragma unroll
  for (int k = 0; k < K; ++k) gather_pair<W>(nt[k], t[k], h);
}

// The owned half of a state (a, u^k) from st (component c at st[c * P]).
template <int W, int K>
__device__ __forceinline__ void load_half(const float* __restrict__ st, int P, int h,
                                          float (&sa)[W / 2], float (&su)[tdim(K)][W / 2]) {
  constexpr int H = W / 2;
  const int j0 = h * H;
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    sa[jj] = st[(j0 + jj) * P];
#pragma unroll
    for (int k = 0; k < K; ++k) su[k][jj] = st[((1 + k) * W + j0 + jj) * P];
  }
}

// (a, t^k) in full from a state st: t^k = u^k * act', as hidden_fwd made it.
template <int W, int ACT, int K>
__device__ __forceinline__ void load_state(const float* __restrict__ st, int P, int h,
                                           float (&a)[W], float (&t)[tdim(K)][W]) {
  constexpr int H = W / 2;
  float sa[H], su[tdim(K)][H], st_[tdim(K)][H];
  load_half<W, K>(st, P, h, sa, su);
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    const float d = dact<ACT>(sa[jj]);
#pragma unroll
    for (int k = 0; k < K; ++k) st_[k][jj] = su[k][jj] * d;
  }
  gather_pair<W>(sa, a, h);
#pragma unroll
  for (int k = 0; k < K; ++k) gather_pair<W>(st_[k], t[k], h);
}

// Stage the owned half of the state (sa, su) as s = [a; u^0*D; ...] into
// the sA rows (sA at this point's column).
template <int W, int ACT, int K>
__device__ __forceinline__ void stage_state(const float (&sa)[W / 2],
                                            const float (&su)[tdim(K)][W / 2], int h, int ld,
                                            float* __restrict__ sA) {
  constexpr int H = W / 2;
  const int j0 = h * H;
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    const float d = dact<ACT>(sa[jj]);
    sA[(j0 + jj) * ld] = sa[jj];
#pragma unroll
    for (int k = 0; k < K; ++k) sA[((1 + k) * W + j0 + jj) * ld] = su[k][jj] * d;
  }
}

// From the cotangent (ca, ct) of a state whose owned half is (sa, su), the
// cotangents of its layer's pre-activation and tangent streams: zbar = (ca
// + act''*Dbar)*D, ubar^k = ct^k*D, with Dbar = sum_k ct^k*u^k, on the
// owned half (zb, ub), staged into the sB rows [zbar; ubar^0; ...] and then
// gathered over the pair into ca and ct (in place).
template <int W, int ACT, int K>
__device__ __forceinline__ void state_bwd(const float (&sa)[W / 2],
                                          const float (&su)[tdim(K)][W / 2],
                                          float (&ca)[W], float (&ct)[tdim(K)][W], int h,
                                          int ld, float* __restrict__ sB) {
  constexpr int H = W / 2;
  const int j0 = h * H;
  float zb[H], ub[tdim(K)][H];
#pragma unroll
  for (int jj = 0; jj < H; ++jj) {
    const float a = sa[jj];
    const float d = dact<ACT>(a);
    float cti[tdim(K)];
#pragma unroll
    for (int k = 0; k < K; ++k) cti[k] = own<W>(ct[k], jj, h);
    const float cai = own<W>(ca, jj, h);
    if constexpr (K > 0) {
      float dbar = cti[0] * su[0][jj];
#pragma unroll
      for (int k = 1; k < K; ++k) dbar = dbar + cti[k] * su[k][jj];
      zb[jj] = (cai + ddact<ACT>(a, dbar)) * d;
    } else {
      zb[jj] = cai * d;
    }
    sB[(j0 + jj) * ld] = zb[jj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ub[k][jj] = cti[k] * d;
      sB[((1 + k) * W + j0 + jj) * ld] = ub[k][jj];
    }
  }
  gather_pair<W>(zb, ca, h);
#pragma unroll
  for (int k = 0; k < K; ++k) gather_pair<W>(ub[k], ct[k], h);
}

// The cotangent into a layer's input state, on the lane's half of its
// components: ca_i = sum_q zbar_q w[i][q] (and ct^k likewise) for i in the
// owned half, the stacked cotangents prepared at the tier, then gathered
// over the pair.
template <class Tier, int W, int K>
__device__ __forceinline__ void cotangent_product(const typename Tier::WT* __restrict__ w,
                                                  float (&ca)[W], float (&ct)[tdim(K)][W],
                                                  int h) {
  using Acc = typename Tier::Acc;
  using Op = typename Tier::Op;
  using WV = typename Tier::WV;
  constexpr int H = W / 2;
  constexpr int V = row_vec<W>();
  Op zo[W], zto[tdim(K)][W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    zo[q] = Tier::op(ca[q]);
#pragma unroll
    for (int k = 0; k < K; ++k) zto[k][q] = Tier::op(ct[k][q]);
  }
  float na[H], nt[tdim(K)][H];
#pragma unroll
  for (int ii = 0; ii < H; ++ii) {
    const typename Tier::WT* row = w + (h * H + ii) * W;
    Acc acc = Tier::acc(0.f), acct[tdim(K)];
#pragma unroll
    for (int k = 0; k < K; ++k) acct[k] = Tier::acc(0.f);
#pragma unroll
    for (int q = 0; q < W; q += V) {
      WV wv[V];
      load_vec<V>(row + q, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        Tier::mac(acc, zo[q + v], wv[v]);
#pragma unroll
        for (int k = 0; k < K; ++k) Tier::mac(acct[k], zto[k][q + v], wv[v]);
      }
    }
    na[ii] = Tier::fin(acc);
#pragma unroll
    for (int k = 0; k < K; ++k) nt[k][ii] = Tier::fin(acct[k]);
  }
  gather_pair<W>(na, ca, h);
#pragma unroll
  for (int k = 0; k < K; ++k) gather_pair<W>(nt[k], ct[k], h);
}

// Register tile of the square product: RI rows of s_A by RJ rows of s_B,
// each dividing W: 4 x 5 at W=20, 5 x 5 at W=10, 4 x 4 at 8, 16 and 32.
__host__ __device__ constexpr int square_ri(int W) {
  return W % 4 == 0 ? 4 : (W % 5 == 0 ? 5 : 2);
}
__host__ __device__ constexpr int square_rj(int W) {
  return W % 5 == 0 ? 5 : (W % 4 == 0 ? 4 : 2);
}

// Point ranges a block of T threads splits a product of `items` entries
// over (at least 1).
__host__ __device__ inline int splits(int items, int T) {
  return items < T ? T / items : 1;
}

// Ranges of the square product for a tile of P points on T threads: the S
// stream blocks of P/4 four-point chunks make S*P/4 steps, spread evenly
// over as many ranges as the threads allow and kSquareRed floats of partial
// sums hold (every range q steps, the last one fewer). The budget keeps the
// flagship's whole stack in one shared-memory chunk beside tiles of 96
// points, for K3's eight heads too.
constexpr int kSquareRed = 3456;
__host__ __device__ inline int square_splits(int W, int S, int P, int T) {
  const int tiles = (W / square_ri(W)) * (W / square_rj(W)), steps = S * (P / 4);
  const int fit = kSquareRed / (W * W + W), by_threads = splits(tiles, T);
  const int most = by_threads < fit ? by_threads : (fit > 0 ? fit : 1);
  const int q = (steps + most - 1) / most;
  return (steps + q - 1) / q;
}

// dw[i][j] = sum_{c<S} sum_p sA[c*W+i][p] * sB[c*W+j][p] and db[j] =
// sum_p sB[j][p] over the tile's P points, into red: the partial sums of
// range s at red[s * (W*W + W)] (dw row-major, then db). Thread item =
// (range s, tile t); tile (it, jt) holds rows i = it + (W/RI)*a (a < RI)
// and j = jt + (W/RJ)*b (b < RJ), the range s the steps [s*q, (s+1)*q)
// of (stream block c, four-point chunk). f32 products at f32 and bf16; at f32x3 both operands
// split as they are read, the products of a range summed as (cross) + main
// over every c and p (JAX mm_tn over the stack). Returns the number of
// ranges.
template <class Tier, int W, int S>
__device__ __forceinline__ int accum_square(const float* __restrict__ sA,
                                            const float* __restrict__ sB, int ld, int P,
                                            float* __restrict__ red) {
  static_assert(W % 2 == 0, "a lane pair needs an even width");
  constexpr int RI = square_ri(W), RJ = square_rj(W), NI = W / RI, NJ = W / RJ, NT = NI * NJ;
  const int T = blockDim.x, n_split = square_splits(W, S, P, T), chunks = P / 4;
  const int steps = S * chunks, q = (steps + n_split - 1) / n_split;
  for (int item = threadIdx.x; item < NT * n_split; item += T) {
    const int s = item / NT, t = item % NT, it = t / NJ, jt = t % NJ;
    const int k0 = s * q, k1 = min(steps, k0 + q);
    float out[RI][RJ], bsum[RJ];
#pragma unroll
    for (int b = 0; b < RJ; ++b) bsum[b] = 0.f;
    if constexpr (!Tier::kSplit) {
      float acc[RI][RJ];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RJ; ++b) acc[a][b] = 0.f;
#pragma unroll 1
      for (int k = k0; k < k1; ++k) {
        const int c = k / chunks, p = 4 * (k - c * chunks);
        const float* ra = sA + (c * W + it) * ld + p;
        const float* rb = sB + (c * W + jt) * ld + p;
        float4 x[RI], y[RJ];
#pragma unroll
        for (int a = 0; a < RI; ++a) x[a] = *reinterpret_cast<const float4*>(ra + a * NI * ld);
#pragma unroll
        for (int b = 0; b < RJ; ++b) y[b] = *reinterpret_cast<const float4*>(rb + b * NJ * ld);
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int b = 0; b < RJ; ++b) {
            acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
            acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
            acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
            acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
          }
        if (c == 0 && it == 0) {
#pragma unroll
          for (int b = 0; b < RJ; ++b) bsum[b] = bsum[b] + y[b].x + y[b].y + y[b].z + y[b].w;
        }
      }
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RJ; ++b) out[a][b] = acc[a][b];
    } else {
      tier::Acc3 acc[RI][RJ];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RJ; ++b) acc[a][b] = {0.f, 0.f};
#pragma unroll 1
      for (int k = k0; k < k1; ++k) {
        const int c = k / chunks, p0 = 4 * (k - c * chunks);
        const float* ra = sA + (c * W + it) * ld;
        const float* rb = sB + (c * W + jt) * ld;
#pragma unroll
        for (int p = p0; p < p0 + 4; ++p) {
          tier::Pair x[RI], y[RJ];
#pragma unroll
          for (int a = 0; a < RI; ++a) x[a] = tier::split(ra[a * NI * ld + p]);
#pragma unroll
          for (int b = 0; b < RJ; ++b) {
            const float yv = rb[b * NJ * ld + p];
            y[b] = tier::split(yv);
            if (c == 0 && it == 0) bsum[b] = bsum[b] + yv;
          }
#pragma unroll
          for (int a = 0; a < RI; ++a)
#pragma unroll
            for (int b = 0; b < RJ; ++b) tier::TierF32x3::mac(acc[a][b], x[a], y[b]);
        }
      }
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RJ; ++b) out[a][b] = tier::TierF32x3::fin(acc[a][b]);
    }
    float* r = red + s * (W * W + W);
#pragma unroll
    for (int a = 0; a < RI; ++a)
#pragma unroll
      for (int b = 0; b < RJ; ++b) r[(it + NI * a) * W + jt + NJ * b] = out[a][b];
    if (it == 0) {
#pragma unroll
      for (int b = 0; b < RJ; ++b) r[W * W + jt + NJ * b] = bsum[b];
    }
  }
  return n_split;
}

// The same product for the input and output layers (rows_a x rows_b, scalar
// loads, the entries split over point ranges of P / n columns). At f32x3
// with seed_rows (the input layer, whose rows c >= 1 are the tangent seeds'
// indicators) those rows add their f32 sums after the split product of row
// block 0, as JAX adds the folded sums of ubar to dw_in. Returns the number
// of ranges.
template <class Tier, int S>
__device__ __forceinline__ int accum_rect(const float* __restrict__ sA, int rows_a,
                                          const float* __restrict__ sB, int rows_b, int ld,
                                          int P, float* __restrict__ red,
                                          bool seed_rows = false) {
  const int E = rows_a * rows_b, T = blockDim.x, n_split = splits(E, T);
  for (int item = threadIdx.x; item < E * n_split; item += T) {
    const int s = item / E, e = item % E, i = e / rows_b, j = e % rows_b;
    const int p0 = s * P / n_split, p1 = (s + 1) * P / n_split;
    float acc = 0.f;
    if constexpr (!Tier::kSplit) {
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * rows_a + i) * ld;
        const float* b0 = sB + (c * rows_b + j) * ld;
        for (int p = p0; p < p1; ++p) acc = fmaf(a0[p], b0[p], acc);
      }
    } else {
      tier::Acc3 sp{0.f, 0.f};
      float seeds = 0.f;
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * rows_a + i) * ld;
        const float* b0 = sB + (c * rows_b + j) * ld;
        if (seed_rows && c > 0) {
          for (int p = p0; p < p1; ++p) seeds = fmaf(a0[p], b0[p], seeds);
        } else {
          for (int p = p0; p < p1; ++p) {
            tier::TierF32x3::mac(sp, tier::split(a0[p]), tier::split(b0[p]));
          }
        }
      }
      acc = tier::TierF32x3::fin(sp) + seeds;
    }
    float* r = red + s * (E + rows_b);
    r[e] = acc;
    if (i == 0) {
      float sb = 0.f;
      for (int p = p0; p < p1; ++p) sb += sB[j * ld + p];
      r[E + j] = sb;
    }
  }
  return n_split;
}

// A product's sums over its point ranges, in range order, into the block's
// partial row: entry e < n_dw to dw[e], the rest to db.
struct Pending {
  float *dw, *db;
  int n_dw, n_db, n_split;
};

__device__ __forceinline__ void flush(const float* __restrict__ red, const Pending& pd,
                                      bool first) {
  const int stride = pd.n_dw + pd.n_db;
  for (int e = threadIdx.x; e < stride; e += blockDim.x) {
    float s = red[e];
    for (int r = 1; r < pd.n_split; ++r) s += red[r * stride + e];
    float* dst = e < pd.n_dw ? pd.dw + e : pd.db + (e - pd.n_dw);
    *dst = accumulate(dst, s, first);
  }
}

// The pointers and sizes every walk takes. `tile` is the points per tile
// (P; the block has kLanes * P threads); `ckpt` is Rebuild's segment length
// C (0 for StoreAll).
struct WalkArgs {
  const float *coords, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *partial, *states;
  int n, d_in, d_out, n_stack, chunk, ckpt, tile;
};

// Floats of one block's partial-sum row: every gradient, then kExtra.
__host__ __device__ inline long long n_params(int W, int d_in, int d_out, int n_stack) {
  return static_cast<long long>(n_stack) * W * (W + 1) + W + d_out + d_in * W + W * d_out;
}

// States one block keeps in the device scratch: every state (StoreAll,
// ckpt 0) or the checkpoints 0, C, 2C, ... below n_stack (Rebuild).
__host__ __device__ inline int scratch_states(int n_stack, int ckpt) {
  if (ckpt <= 0) return n_stack + 1;
  const int n_seg = (n_stack + ckpt - 1) / ckpt;
  return n_seg > 0 ? n_seg : 1;
}

// Floats of the reduction buffer of a tile of P points (2P threads): the
// square product's ranges, and a bound on the rectangular ones (at most
// 2T when the entries are fewer than the threads, else one range).
__host__ __device__ inline int red_floats(int W, int S, int P, int max_out) {
  const int T = kLanes * P;
  const int square = square_splits(W, S, P, T) * (W * W + W);
  int rect = 2 * T;
  const int in = (kMaxIn + 1) * W, out = (max_out + 1) * W;
  rect = rect > in ? rect : in;
  rect = rect > out ? rect : out;
  return square > rect ? square : rect;
}

// Dynamic shared memory of a walk, in bytes: the f32 biases, the two
// staging blocks of S*W rows, the reduction buffer and Rebuild's segment
// buffer of `seg` states, then the weights at wt bytes each (a chunk of
// hidden layers, the input and output layers); every region 16-byte
// aligned. P: points per tile.
__host__ __device__ inline size_t smem_bytes(int W, int S, int max_out, int chunk, size_t wt,
                                             int seg, int P) {
  using tier::align16;
  return align16(static_cast<size_t>(chunk) * W * 4) + align16(W * 4) + align16(max_out * 4) +
         2 * align16(static_cast<size_t>(S) * W * stage_ld(P) * 4) +
         align16(static_cast<size_t>(red_floats(W, S, P, max_out)) * 4) +
         align16(static_cast<size_t>(seg) * S * W * P * 4) +
         align16(static_cast<size_t>(chunk) * W * W * wt) + align16(kMaxIn * W * wt) +
         align16(W * max_out * wt);
}

// Hidden layers one shared-memory chunk holds on the current device beside
// the rest, for tiles of P points (0 when not even one fits).
inline int chunk_layers(int W, int S, int max_out, int n_stack, size_t wt, int seg, int P) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  int fit = 0;
  while (fit < n_stack && smem_bytes(W, S, max_out, fit + 1, wt, seg, P) <=
                              static_cast<size_t>(max_smem))
    ++fit;
  return fit;
}

// Rebuild's segment length and chunk for tiles of P points. `ckpt` > 0 asks
// for that C (cut to n_stack); 0 takes the largest C <= kMaxAutoCkpt that
// leaves the whole stack in one chunk, else the largest that leaves at
// least half of it, else 1. Returns false when nothing fits.
constexpr int kMaxAutoCkpt = 8;
inline bool rebuild_plan(int W, int S, int max_out, int n_stack, size_t wt, int ckpt, int P,
                         int* c_out, int* chunk_out) {
  if (n_stack <= 0) {
    *c_out = 1;
    *chunk_out = 0;
    return smem_bytes(W, S, max_out, 0, wt, 1, P) > 0;
  }
  int c = 0;
  if (ckpt > 0) {
    c = ckpt < n_stack ? ckpt : n_stack;
  } else {
    const int top = kMaxAutoCkpt < n_stack ? kMaxAutoCkpt : n_stack;
    for (int need : {n_stack, (n_stack + 1) / 2, 1}) {
      for (int cand = top; cand >= 1 && c == 0; --cand) {
        if (chunk_layers(W, S, max_out, n_stack, wt, cand, P) >= need) c = cand;
      }
      if (c) break;
    }
    if (c == 0) return false;
  }
  const int chunk = chunk_layers(W, S, max_out, n_stack, wt, c, P);
  if (chunk < 1) return false;
  *c_out = c;
  *chunk_out = chunk;
  return true;
}

// The walk over this block's tiles. Epi supplies the output cotangents:
//   kMaxOut, kExtra (constants): most heads, floats of its own sums;
//   output<Tier>(p, active, a, t, s_wout, s_bout, d_out, yb, ybt): ybar and
//     ybar^k of point p from the last state (a, t^k) (both lanes of a pair);
//   stage(sB, ld): its per-point values into staging rows >= (1+K)*d_out
//     (lane 0 of the pair);
//   reduce(s_B, ld, P, g_extra, first): its sums over the tile's points.
template <class Tier, class Policy, int W, int ACT, int K, class Epi>
__device__ __forceinline__ void walk(const WalkArgs& args, Epi& epi, unsigned char* smem) {
  using WT = typename Tier::WT;
  using WV = typename Tier::WV;
  using Op = typename Tier::Op;
  using Acc = typename Tier::Acc;
  using tier::align16;
  constexpr int S = 1 + K;
  constexpr int H = W / 2;
  constexpr int kOut = Epi::kMaxOut;
  const int n_stack = args.n_stack, d_in = args.d_in, d_out = args.d_out, chunk = args.chunk;
  const int ckpt = Policy::kRebuild ? args.ckpt : 0;
  const int P = args.tile, ld = stage_ld(P);
  unsigned char* cur = smem;
  auto carve = [&](size_t bytes) { unsigned char* q = cur; cur += align16(bytes); return q; };
  float* s_bh = reinterpret_cast<float*>(carve(static_cast<size_t>(chunk) * W * 4));
  float* s_bin = reinterpret_cast<float*>(carve(W * 4));
  float* s_bout = reinterpret_cast<float*>(carve(kOut * 4));
  float* s_A = reinterpret_cast<float*>(carve(static_cast<size_t>(S) * W * ld * 4));
  float* s_B = reinterpret_cast<float*>(carve(static_cast<size_t>(S) * W * ld * 4));
  float* s_red = reinterpret_cast<float*>(
      carve(static_cast<size_t>(red_floats(W, S, P, kOut)) * 4));
  float* s_seg = reinterpret_cast<float*>(
      carve(static_cast<size_t>(Policy::kRebuild ? ckpt : 0) * S * W * P * 4));
  WT* s_wh = reinterpret_cast<WT*>(carve(static_cast<size_t>(chunk) * W * W * sizeof(WT)));
  WT* s_win = reinterpret_cast<WT*>(carve(kMaxIn * W * sizeof(WT)));
  WT* s_wout = reinterpret_cast<WT*>(carve(W * kOut * sizeof(WT)));

  const int tid = threadIdx.x, T = blockDim.x;
  const int q = tid / kLanes, h = tid % kLanes;  // point in the tile, lane of the pair
  tier::stage_weights<Tier>(s_win, args.w_in, d_in * W);
  for (int i = tid; i < W; i += T) s_bin[i] = args.b_in[i];
  tier::stage_weights<Tier>(s_wout, args.w_out, W * d_out);
  for (int i = tid; i < d_out; i += T) s_bout[i] = args.b_out[i];

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

  // This point's states in the device scratch (StoreAll: state s at slot s;
  // Rebuild: checkpoint s, state s*C, at slot s) and, for Rebuild, in the
  // segment buffer (slot i: state j0 + 1 + i). Component c of a state at
  // [c * P].
  const size_t state_floats = static_cast<size_t>(S) * W * P;
  float* st0 = args.states +
               static_cast<size_t>(blockIdx.x) * scratch_states(n_stack, ckpt) * state_floats + q;
  auto state = [&](int s) { return st0 + static_cast<size_t>(s) * state_floats; };
  float* seg0 = s_seg + q;
  auto seg = [&](int i) { return seg0 + static_cast<size_t>(i) * state_floats; };
  // where the forward puts state s (1 <= s <= n_stack), or null
  auto fwd_slot = [&](int s) -> float* {
    if constexpr (Policy::kRebuild) {
      return (s % ckpt == 0 && s < n_stack) ? state(s / ckpt) : nullptr;
    } else {
      return state(s);
    }
  };

  const int n_chunks = chunk > 0 ? (n_stack + chunk - 1) / chunk : 0;
  int loaded = -1;  // the chunk of hidden layers now in shared memory
  auto load_chunk = [&](int c) {
    if (c == loaded) return;
    __syncthreads();  // nobody reads the previous chunk any more
    const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
    tier::stage_weights<Tier>(s_wh, args.w_h + static_cast<size_t>(l0) * W * W, nl * W * W);
    const float* src_b = args.b_h + static_cast<size_t>(l0) * W;
    for (int i = tid; i < nl * W; i += T) s_bh[i] = src_b[i];
    __syncthreads();
    loaded = c;
  };
  // hidden layer l's weights and bias, its chunk loaded
  auto layer_w = [&](int l) {
    load_chunk(l / chunk);
    return s_wh + static_cast<size_t>(l - (l / chunk) * chunk) * W * W;
  };
  auto layer_b = [&](int l) { return s_bh + (l - (l / chunk) * chunk) * W; };

  float* sA = s_A + q;
  float* sB = s_B + q;
  const int n_tiles = (args.n + P - 1) / P;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const long long p = static_cast<long long>(tile) * P + q;
    const bool active = p < args.n;
    float x[kMaxIn];
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) x[c] = (active && c < d_in) ? args.coords[p * d_in + c] : 0.f;
    __syncthreads();  // the input/output weights are loaded; the buffers are free

    // ---- forward: input layer (tangent seeds are rows 0..K-1 of w_in)
    float a[W], t[tdim(K)][W];
    {
      float* st = state(0);
      Op xo[kMaxIn];
#pragma unroll
      for (int c = 0; c < kMaxIn; ++c) xo[c] = Tier::op(x[c]);
      float na[H], nt[tdim(K)][H];
#pragma unroll
      for (int jj = 0; jj < H; ++jj) {
        const int j = h * H + jj;
        Acc z = Tier::acc(s_bin[j]);
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) {
          if (c < d_in) Tier::mac(z, xo[c], w_ld(s_win[c * W + j]));
        }
        na[jj] = act_fn<ACT>(Tier::fin(z));
        const float d = dact<ACT>(na[jj]);
        st[j * P] = na[jj];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float u = w_f(s_win[k * W + j]);
          st[((1 + k) * W + j) * P] = u;
          nt[k][jj] = u * d;
        }
      }
      gather_pair<W>(na, a, h);
#pragma unroll
      for (int k = 0; k < K; ++k) gather_pair<W>(nt[k], t[k], h);
    }
    // ---- forward: hidden stack, chunk by chunk
    for (int c = 0; c < n_chunks; ++c) {
      load_chunk(c);
      const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
#pragma unroll 1
      for (int l = 0; l < nl; ++l) {
        hidden_fwd<Tier, W, ACT, K>(s_wh + l * W * W, s_bh + l * W, a, t, fwd_slot(l0 + l + 1),
                                    P, h);
      }
    }

    // ---- the output cotangents
    float yb[kOut], ybt[tdim(K)][kOut];
    epi.template output<Tier, W, K>(p, active, a, t, s_wout, s_bout, d_out, yb, ybt);

    // ---- output layer backward: stage s_L = [a; t^0; ...] (owned halves)
    // and [ybar; ybar^0; ...] (and the epilogue's rows, lane 0)
#pragma unroll
    for (int jj = 0; jj < H; ++jj) {
      const int i = h * H + jj;
      sA[i * ld] = own<W>(a, jj, h);
#pragma unroll
      for (int k = 0; k < K; ++k) sA[((1 + k) * W + i) * ld] = own<W>(t[k], jj, h);
    }
    if (h == 0) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        if (o < d_out) {
          sB[o * ld] = yb[o];
#pragma unroll
          for (int k = 0; k < K; ++k) sB[((1 + k) * d_out + o) * ld] = ybt[k][o];
        }
      }
      epi.stage(sB, ld);
    }
    __syncthreads();  // layer barrier
    Pending pend{g_wout, g_bout, W * d_out, d_out,
                 accum_rect<Tier, S>(s_A, W, s_B, d_out, ld, P, s_red)};
    epi.reduce(s_B, ld, P, g_extra, first);

    // cotangent into the last state: ybar stack (at the tier) @ w_out^T
    float ca[W], ct[tdim(K)][W];
    {
      Op ybo[kOut], ybto[tdim(K)][kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        ybo[o] = Tier::op(yb[o]);
#pragma unroll
        for (int k = 0; k < K; ++k) ybto[k][o] = Tier::op(ybt[k][o]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        Acc cai = Tier::acc(0.f), cti[tdim(K)];
#pragma unroll
        for (int k = 0; k < K; ++k) cti[k] = Tier::acc(0.f);
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          if (o < d_out) {
            const WV wv = w_ld(s_wout[i * d_out + o]);
            Tier::mac(cai, ybo[o], wv);
#pragma unroll
            for (int k = 0; k < K; ++k) Tier::mac(cti[k], ybto[k][o], wv);
          }
        }
        ca[i] = Tier::fin(cai);
#pragma unroll
        for (int k = 0; k < K; ++k) ct[k][i] = Tier::fin(cti[k]);
      }
    }

    // ---- hidden stack backward, layer j maps state j -> state j + 1. The
    // owned half of state j + 1 is in (sa, su); the layer reads state j
    // once, stages it for its weight gradient and keeps it for the next.
    float sa[H], su[tdim(K)][H];
    auto back_layer = [&](int j, const float* st_prev) {
      const WT* w = layer_w(j);
      float pa[H], pu[tdim(K)][H];  // state j, loaded while the flush and state_bwd run
      load_half<W, K>(st_prev, P, h, pa, pu);
      __syncthreads();  // the previous product is done: the buffers are free
      flush(s_red, pend, first);
      state_bwd<W, ACT, K>(sa, su, ca, ct, h, ld, sB);
#pragma unroll
      for (int jj = 0; jj < H; ++jj) {
        sa[jj] = pa[jj];
#pragma unroll
        for (int k = 0; k < K; ++k) su[k][jj] = pu[k][jj];
      }
      stage_state<W, ACT, K>(sa, su, h, ld, sA);
      __syncthreads();  // layer barrier
      pend = Pending{g_wh + static_cast<size_t>(j) * W * W, g_bh + j * W, W * W, W,
                     accum_square<Tier, W, S>(s_A, s_B, ld, P, s_red)};
      cotangent_product<Tier, W, K>(w, ca, ct, h);
    };
    if constexpr (Policy::kRebuild) {
      // segments of C layers in reverse: re-run each from its checkpoint
      // into the segment buffer, then walk it back
      const int n_seg = (n_stack + ckpt - 1) / ckpt;
#pragma unroll 1
      for (int sg = n_seg - 1; sg >= 0; --sg) {
        const int j0 = sg * ckpt, len = min(ckpt, n_stack - j0);
        const float* ck = state(sg);
        load_state<W, ACT, K>(ck, P, h, a, t);
#pragma unroll 1
        for (int i = 0; i < len; ++i) {
          const WT* w = layer_w(j0 + i);
          hidden_fwd<Tier, W, ACT, K>(w, layer_b(j0 + i), a, t, seg(i), P, h);
        }
        load_half<W, K>(seg(len - 1), P, h, sa, su);
#pragma unroll 1
        for (int j = j0 + len - 1; j >= j0; --j) {
          back_layer(j, j == j0 ? ck : seg(j - j0 - 1));
        }
      }
      if (n_stack == 0) load_half<W, K>(state(0), P, h, sa, su);
    } else {
      load_half<W, K>(state(n_stack), P, h, sa, su);
#pragma unroll 1
      for (int j = n_stack - 1; j >= 0; --j) back_layer(j, state(j));
    }

    // ---- input layer backward: s_in = [x; e_0; ...], so dw_in[k, :] also
    // collects sum_p ubar_0^k (the tangent seeds are rows k of w_in)
    __syncthreads();
    flush(s_red, pend, first);
    state_bwd<W, ACT, K>(sa, su, ca, ct, h, ld, sB);
    if (h == 0) {
      for (int c = 0; c < d_in; ++c) {
        sA[c * ld] = x[c];
#pragma unroll
        for (int k = 0; k < K; ++k) sA[((1 + k) * d_in + c) * ld] = c == k ? 1.f : 0.f;
      }
    }
    __syncthreads();  // layer barrier
    pend = Pending{g_win, g_bin, d_in * W, W,
                   accum_rect<Tier, S>(s_A, d_in, s_B, W, ld, P, s_red, /*seed_rows=*/true)};
    __syncthreads();
    flush(s_red, pend, first);
  }
}

// The epilogue of K3 and K4: the output cotangents of one point, loaded:
// ybar[p, :] and dybar[k, p, :]; zero past N, so padding points add
// nothing. The output layer's forward is not needed.
struct LoadedCotangents {
  static constexpr int kMaxOut = 8;
  static constexpr int kExtra = 0;

  const float *ybar, *dybar;
  int n;

  template <class Tier, int W, int K>
  __device__ __forceinline__ void output(long long p, bool active, const float (&)[W],
                                         const float (&)[tdim(K)][W],
                                         const typename Tier::WT* __restrict__,
                                         const float* __restrict__, int d_out,
                                         float (&yb)[kMaxOut],
                                         float (&ybt)[tdim(K)][kMaxOut]) const {
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const bool live = active && o < d_out;
      yb[o] = live ? ybar[p * d_out + o] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ybt[k][o] = live ? dybar[(static_cast<long long>(k) * n + p) * d_out + o] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void stage(float*, int) const {}

  __device__ __forceinline__ void reduce(const float*, int, int, float*, bool) const {}
};

// The arguments of K3 and K4.
struct CotangentArgs {
  WalkArgs walk;
  const float *ybar, *dybar;
};

// K3 (StoreAll) and K4 (Rebuild): the walk with loaded cotangents.
template <class Tier, class Policy, int W, int ACT, int K>
__global__ void __launch_bounds__(kMaxThreads<Tier, W>)
    cotangent_walk_kernel(const CotangentArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  LoadedCotangents epi{args.ybar, args.dybar, args.walk.n};
  walk<Tier, Policy, W, ACT, K>(args.walk, epi, smem);
}

namespace {

// out[e] = sum over blocks b, in order, of partial[b][e]: the fixed order
// keeps the gradients deterministic.
__global__ void reduce_kernel(const float* __restrict__ partial, int blocks, int n_ent,
                              float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_ent) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * n_ent + e];
  out[e] = s;
}

}  // namespace

// Launch a walk kernel on `grid` blocks of kLanes * tile threads, then the
// fixed-order reduction of its partial rows into `out` (n_ent floats).
// Returns a cudaError_t.
template <class Kernel, class KernelArgs>
cudaError_t launch(Kernel kernel, const KernelArgs& kargs, size_t smem, int grid, int tile,
                   const float* partial, float* out, int n_ent, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kLanes * tile, smem, stream>>>(kargs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<(n_ent + 255) / 256, 256, 0, stream>>>(partial, grid, n_ent, out);
  return cudaGetLastError();
}

// One K3/K4 launch at tier Tier and policy Policy: K and the activation
// picked at run time; smem bytes for the plan in a.walk.
template <class Tier, class Policy, int W, int ACT>
cudaError_t launch_cotangents_k(const CotangentArgs& a, int n_tangents, size_t smem, int grid,
                                float* out, int n_ent, cudaStream_t stream) {
  const int tile = a.walk.tile;
  switch (n_tangents) {
    case 0: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 0>, a, smem, grid, tile,
                          a.walk.partial, out, n_ent, stream);
    case 1: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 1>, a, smem, grid, tile,
                          a.walk.partial, out, n_ent, stream);
    case 2: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 2>, a, smem, grid, tile,
                          a.walk.partial, out, n_ent, stream);
    default: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 3>, a, smem, grid, tile,
                           a.walk.partial, out, n_ent, stream);
  }
}

template <class Tier, class Policy, int W>
cudaError_t launch_cotangents(const CotangentArgs& a, int n_tangents, int act, size_t smem,
                              int grid, float* out, int n_ent, cudaStream_t stream) {
  return act == 0
             ? launch_cotangents_k<Tier, Policy, W, 0>(a, n_tangents, smem, grid, out, n_ent, stream)
             : launch_cotangents_k<Tier, Policy, W, 1>(a, n_tangents, smem, grid, out, n_ent, stream);
}

// Whether a tile of `tile` points and a grid of `grid` blocks are a valid
// plan for n points (ops/walk_plan.py makes them).
template <class Tier, int W>
inline bool plan_ok(int n, int tile, int grid) {
  return tile >= kTileStep && tile % kTileStep == 0 && tile <= max_tile<Tier, W>() &&
         grid >= 1 && grid <= (n + tile - 1) / tile;
}

// The argument checks K3 and K4 share; true when the call is valid.
template <class Tier, int W>
inline bool cotangent_args_ok(const float* dybar, int n, int d_in, int d_out, int n_stack,
                              int n_tangents, int act, int grid, int tile) {
  return !(n <= 0 || d_in < 1 || d_in > kMaxIn || d_in > W || d_out < 1 ||
           d_out > LoadedCotangents::kMaxOut || d_out > W || n_stack < 0 || n_tangents < 0 ||
           n_tangents > 3 || n_tangents > d_in || (n_tangents > 0 && dybar == nullptr) ||
           (act != 0 && act != 1) || !plan_ok<Tier, W>(n, tile, grid));
}

}  // namespace mlp_bwd
