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
// every rounding is the identity.
//
// Design. One thread per point, 128 points per tile. The primal and the K
// tangent streams stay in registers (W is a compile-time constant: one
// library per width); the hidden weights sit in shared memory (one chunk of
// whole layers when the stack does not fit). States are laid out
// [state][component][thread], so neighbouring threads touch neighbouring
// addresses; each thread reads back only its own states, so the state
// buffers need no barrier. Per layer, each thread stages s_prev = [a;
// t^0..t^{K-1}] and [zbar; ubar^0..ubar^{K-1}] ((1+K)W floats each) in
// shared memory, and the block forms that layer's W x W weight gradient as a
// product over its 128 points (2 x 2 register tiles; rows padded to 129
// floats so no two lanes of a warp hit one bank). Gradients are sums over
// every point, and Hopper runs blocks in no order: each block of a
// fixed-size grid walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
// keeps its own partial sums in a scratch row (written by one fixed thread
// per entry, in tile order); a second kernel sums the rows in block order.
// No atomics: the result is the same bit for bit from run to run.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// of forward replay (twice for Rebuild, less the output layer) and
// 2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W of backward, plus L*W tanhf,
// against a few bytes of inputs and the weights: the CUDA cores' f32 FMA
// rate bounds it (the bf16 tier runs the same FMAs). What the design spends
// beyond that: StoreAll's layer states go to device memory and back, and
// the per-layer block product reads shared memory once per two FMAs.
// Tensor cores are left for later work (ROADMAP.md).

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

constexpr int kThreads = 128;          // points per tile = threads per block
constexpr int kLd = kThreads + 1;      // staging row stride: one bank per row
constexpr int kMaxIn = 8;

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

// One hidden layer forward: z = a @ w + b, z^k = t^k @ w (a and t^k
// prepared at the tier); a <- act(z), t^k <- z^k * act'; the state (a,
// z^0..z^{K-1}) goes to st[c * kThreads] unless st is null.
template <class Tier, int W, int ACT, int K>
__device__ __forceinline__ void hidden_fwd(const typename Tier::WT* __restrict__ w,
                                           const float* __restrict__ b,
                                           float (&a)[W], float (&t)[tdim(K)][W],
                                           float* __restrict__ st) {
  using Acc = typename Tier::Acc;
  using Op = typename Tier::Op;
  using WV = typename Tier::WV;
  constexpr int V = row_vec<W>();
  Acc z[W], zt[tdim(K)][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    z[j] = Tier::acc(b[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) zt[k][j] = Tier::acc(0.f);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const Op ai = Tier::op(a[i]);
    Op ti[tdim(K)];
#pragma unroll
    for (int k = 0; k < K; ++k) ti[k] = Tier::op(t[k][i]);
#pragma unroll
    for (int j = 0; j < W; j += V) {
      WV wv[V];
      load_vec<V>(w + i * W + j, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        Tier::mac(z[j + v], ai, wv[v]);
#pragma unroll
        for (int k = 0; k < K; ++k) Tier::mac(zt[k][j + v], ti[k], wv[v]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float na = act_fn<ACT>(Tier::fin(z[j]));
    const float d = dact<ACT>(na);
    float u[tdim(K)];
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = Tier::fin(zt[k][j]);
    if (st != nullptr) {
      st[j * kThreads] = na;
#pragma unroll
      for (int k = 0; k < K; ++k) st[((1 + k) * W + j) * kThreads] = u[k];
    }
    a[j] = na;
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][j] = u[k] * d;
  }
}

// (a, t^k) back from a state st: t^k = u^k * act', as hidden_fwd made it.
template <int W, int ACT, int K>
__device__ __forceinline__ void load_state(const float* __restrict__ st, float (&a)[W],
                                           float (&t)[tdim(K)][W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    a[i] = st[i * kThreads];
    const float d = dact<ACT>(a[i]);
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][i] = st[((1 + k) * W + i) * kThreads] * d;
  }
}

// From the cotangent (ca, ct) of a state (a, u) (read from st), the
// cotangents of its layer's pre-activation and tangent streams, written in
// place: ca <- zbar = (ca + act''*Dbar)*D, ct^k <- ubar^k = ct^k*D, with
// Dbar = sum_k ct^k*u^k. Also staged into sB rows [zbar; ubar^0; ...].
template <int W, int ACT, int K>
__device__ __forceinline__ void state_bwd(const float* __restrict__ st,
                                          float (&ca)[W], float (&ct)[tdim(K)][W],
                                          float* __restrict__ sB) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float a = st[i * kThreads];
    const float d = dact<ACT>(a);
    if constexpr (K > 0) {
      float u[K];
#pragma unroll
      for (int k = 0; k < K; ++k) u[k] = st[((1 + k) * W + i) * kThreads];
      float dbar = ct[0][i] * u[0];
#pragma unroll
      for (int k = 1; k < K; ++k) dbar = dbar + ct[k][i] * u[k];
      ca[i] = (ca[i] + ddact<ACT>(a, dbar)) * d;
    } else {
      ca[i] = ca[i] * d;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ct[k][i] *= d;
    sB[i * kLd] = ca[i];
#pragma unroll
    for (int k = 0; k < K; ++k) sB[((1 + k) * W + i) * kLd] = ct[k][i];
  }
}

// Stage s = [a; u^0*D; ...] of the state in st into sA rows.
template <int W, int ACT, int K>
__device__ __forceinline__ void stage_state(const float* __restrict__ st,
                                            float* __restrict__ sA) {
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
    const float a = st[i * kThreads];
    const float d = dact<ACT>(a);
    sA[i * kLd] = a;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sA[((1 + k) * W + i) * kLd] = st[((1 + k) * W + i) * kThreads] * d;
    }
  }
}

// dw[i][j] (+)= sum_{c<S} sum_p sA[c*W+i][p] * sB[c*W+j][p] and
// db[j] (+)= sum_p sB[j][p], over the block's points, in 2 x 2 tiles
// (W even). One fixed thread owns each entry. f32 products at f32 and
// bf16; at f32x3 both operands split as they are read, and the products
// summed as (cross) + main over every c and p (JAX mm_tn over the stack).
template <class Tier, int W, int S>
__device__ __forceinline__ void accum_square(const float* __restrict__ sA,
                                             const float* __restrict__ sB,
                                             float* __restrict__ dw,
                                             float* __restrict__ db, bool first) {
  static_assert(W % 2 == 0, "2 x 2 tiles need an even width");
  constexpr int H = W / 2;
  for (int tile = threadIdx.x; tile < H * H; tile += kThreads) {
    const int i0 = 2 * (tile / H), j0 = 2 * (tile % H);
    float c00, c01, c10, c11;
    if constexpr (!Tier::kSplit) {
      c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * W + i0) * kLd;
        const float* b0 = sB + (c * W + j0) * kLd;
#pragma unroll 4
        for (int p = 0; p < kThreads; ++p) {
          const float x0 = a0[p], x1 = a0[kLd + p];
          const float y0 = b0[p], y1 = b0[kLd + p];
          c00 = fmaf(x0, y0, c00);
          c01 = fmaf(x0, y1, c01);
          c10 = fmaf(x1, y0, c10);
          c11 = fmaf(x1, y1, c11);
        }
      }
    } else {
      tier::Acc3 e00{0.f, 0.f}, e01{0.f, 0.f}, e10{0.f, 0.f}, e11{0.f, 0.f};
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * W + i0) * kLd;
        const float* b0 = sB + (c * W + j0) * kLd;
#pragma unroll 2
        for (int p = 0; p < kThreads; ++p) {
          const tier::Pair x0 = tier::split(a0[p]), x1 = tier::split(a0[kLd + p]);
          const tier::Pair y0 = tier::split(b0[p]), y1 = tier::split(b0[kLd + p]);
          tier::TierF32x3::mac(e00, x0, y0);
          tier::TierF32x3::mac(e01, x0, y1);
          tier::TierF32x3::mac(e10, x1, y0);
          tier::TierF32x3::mac(e11, x1, y1);
        }
      }
      c00 = tier::TierF32x3::fin(e00);
      c01 = tier::TierF32x3::fin(e01);
      c10 = tier::TierF32x3::fin(e10);
      c11 = tier::TierF32x3::fin(e11);
    }
    float* d0 = dw + i0 * W + j0;
    d0[0] = accumulate(d0, c00, first);
    d0[1] = accumulate(d0 + 1, c01, first);
    d0[W] = accumulate(d0 + W, c10, first);
    d0[W + 1] = accumulate(d0 + W + 1, c11, first);
  }
  for (int j = threadIdx.x; j < W; j += kThreads) {
    float s = 0.f;
    for (int p = 0; p < kThreads; ++p) s += sB[j * kLd + p];
    db[j] = accumulate(db + j, s, first);
  }
}

// The same product for the input and output layers (rows_a x rows_b). At
// f32x3 with seed_rows (the input layer, whose rows c >= 1 are the
// tangent seeds' indicators) those rows add their f32 sums after the split
// product of row block 0, as JAX adds the folded sums of ubar to dw_in.
template <class Tier, int S>
__device__ __forceinline__ void accum_rect(const float* __restrict__ sA, int rows_a,
                                           const float* __restrict__ sB, int rows_b,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           bool first, bool seed_rows = false) {
  for (int e = threadIdx.x; e < rows_a * rows_b; e += kThreads) {
    const int i = e / rows_b, j = e % rows_b;
    float acc = 0.f;
    if constexpr (!Tier::kSplit) {
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * rows_a + i) * kLd;
        const float* b0 = sB + (c * rows_b + j) * kLd;
        for (int p = 0; p < kThreads; ++p) acc = fmaf(a0[p], b0[p], acc);
      }
    } else {
      tier::Acc3 sp{0.f, 0.f};
      float seeds = 0.f;
      for (int c = 0; c < S; ++c) {
        const float* a0 = sA + (c * rows_a + i) * kLd;
        const float* b0 = sB + (c * rows_b + j) * kLd;
        if (seed_rows && c > 0) {
          for (int p = 0; p < kThreads; ++p) seeds = fmaf(a0[p], b0[p], seeds);
        } else {
          for (int p = 0; p < kThreads; ++p) {
            tier::TierF32x3::mac(sp, tier::split(a0[p]), tier::split(b0[p]));
          }
        }
      }
      acc = tier::TierF32x3::fin(sp) + seeds;
    }
    dw[e] = accumulate(dw + e, acc, first);
  }
  for (int j = threadIdx.x; j < rows_b; j += kThreads) {
    float s = 0.f;
    for (int p = 0; p < kThreads; ++p) s += sB[j * kLd + p];
    db[j] = accumulate(db + j, s, first);
  }
}

// The pointers and sizes every walk takes. `ckpt` is Rebuild's segment
// length C (0 for StoreAll).
struct WalkArgs {
  const float *coords, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *partial, *states;
  int n, d_in, d_out, n_stack, chunk, ckpt;
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

// Dynamic shared memory of a walk, in bytes: the f32 biases, the two
// staging blocks of S*W rows and Rebuild's segment buffer of `seg` states,
// then the weights at wt bytes each (a chunk of hidden layers, the input
// and output layers); every region 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int W, int S, int max_out, int chunk, size_t wt,
                                             int seg) {
  using tier::align16;
  return align16(static_cast<size_t>(chunk) * W * 4) + align16(W * 4) + align16(max_out * 4) +
         2 * align16(static_cast<size_t>(S) * W * kLd * 4) +
         align16(static_cast<size_t>(seg) * S * W * kThreads * 4) +
         align16(static_cast<size_t>(chunk) * W * W * wt) + align16(kMaxIn * W * wt) +
         align16(W * max_out * wt);
}

// Hidden layers one shared-memory chunk holds on the current device beside
// the rest (0 when not even one fits).
inline int chunk_layers(int W, int S, int max_out, int n_stack, size_t wt, int seg) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  int fit = 0;
  while (fit < n_stack && smem_bytes(W, S, max_out, fit + 1, wt, seg) <=
                              static_cast<size_t>(max_smem))
    ++fit;
  return fit;
}

// Rebuild's segment length and chunk. `ckpt` > 0 asks for that C (cut to
// n_stack); 0 takes the largest C <= kMaxAutoCkpt that leaves the whole
// stack in one chunk, else the largest that leaves at least half of it,
// else 1. Returns false when nothing fits.
constexpr int kMaxAutoCkpt = 8;
inline bool rebuild_plan(int W, int S, int max_out, int n_stack, size_t wt, int ckpt,
                         int* c_out, int* chunk_out) {
  if (n_stack <= 0) {
    *c_out = 1;
    *chunk_out = 0;
    return smem_bytes(W, S, max_out, 0, wt, 1) > 0;
  }
  int c = 0;
  if (ckpt > 0) {
    c = ckpt < n_stack ? ckpt : n_stack;
  } else {
    const int top = kMaxAutoCkpt < n_stack ? kMaxAutoCkpt : n_stack;
    for (int need : {n_stack, (n_stack + 1) / 2, 1}) {
      for (int cand = top; cand >= 1 && c == 0; --cand) {
        if (chunk_layers(W, S, max_out, n_stack, wt, cand) >= need) c = cand;
      }
      if (c) break;
    }
    if (c == 0) return false;
  }
  const int chunk = chunk_layers(W, S, max_out, n_stack, wt, c);
  if (chunk < 1) return false;
  *c_out = c;
  *chunk_out = chunk;
  return true;
}

// The walk over this block's tiles. Epi supplies the output cotangents:
//   kMaxOut, kExtra (constants): most heads, floats of its own sums;
//   output<Tier>(p, active, a, t, s_wout, s_bout, d_out, yb, ybt): ybar and
//     ybar^k of point p from the last state (a, t^k);
//   stage(sB): its per-point values into staging rows >= (1+K)*d_out;
//   reduce(s_B, g_extra, first): its sums over the block's points.
template <class Tier, class Policy, int W, int ACT, int K, class Epi>
__device__ __forceinline__ void walk(const WalkArgs& args, Epi& epi, unsigned char* smem) {
  using WT = typename Tier::WT;
  using WV = typename Tier::WV;
  using Op = typename Tier::Op;
  using Acc = typename Tier::Acc;
  using tier::align16;
  constexpr int S = 1 + K;
  constexpr int kOut = Epi::kMaxOut;
  const int n_stack = args.n_stack, d_in = args.d_in, d_out = args.d_out, chunk = args.chunk;
  const int ckpt = Policy::kRebuild ? args.ckpt : 0;
  unsigned char* cur = smem;
  auto carve = [&](size_t bytes) { unsigned char* q = cur; cur += align16(bytes); return q; };
  float* s_bh = reinterpret_cast<float*>(carve(static_cast<size_t>(chunk) * W * 4));
  float* s_bin = reinterpret_cast<float*>(carve(W * 4));
  float* s_bout = reinterpret_cast<float*>(carve(kOut * 4));
  float* s_A = reinterpret_cast<float*>(carve(S * W * kLd * 4));  // S*W rows of kLd
  float* s_B = reinterpret_cast<float*>(carve(S * W * kLd * 4));  // S*W rows of kLd
  float* s_seg = reinterpret_cast<float*>(
      carve(static_cast<size_t>(Policy::kRebuild ? ckpt : 0) * S * W * kThreads * 4));
  WT* s_wh = reinterpret_cast<WT*>(carve(static_cast<size_t>(chunk) * W * W * sizeof(WT)));
  WT* s_win = reinterpret_cast<WT*>(carve(kMaxIn * W * sizeof(WT)));
  WT* s_wout = reinterpret_cast<WT*>(carve(W * kOut * sizeof(WT)));

  const int tid = threadIdx.x;
  tier::stage_weights<Tier>(s_win, args.w_in, d_in * W);
  for (int i = tid; i < W; i += kThreads) s_bin[i] = args.b_in[i];
  tier::stage_weights<Tier>(s_wout, args.w_out, W * d_out);
  for (int i = tid; i < d_out; i += kThreads) s_bout[i] = args.b_out[i];

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

  // This thread's states in the device scratch (StoreAll: state s at slot s;
  // Rebuild: checkpoint s, state s*C, at slot s) and, for Rebuild, in the
  // segment buffer (slot i: state j0 + 1 + i). Component c of a state at
  // [c * kThreads].
  const size_t state_floats = static_cast<size_t>(S) * W * kThreads;
  float* st0 = args.states +
               static_cast<size_t>(blockIdx.x) * scratch_states(n_stack, ckpt) * state_floats + tid;
  auto state = [&](int s) { return st0 + static_cast<size_t>(s) * state_floats; };
  float* seg0 = s_seg + tid;
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
    for (int i = tid; i < nl * W; i += kThreads) s_bh[i] = src_b[i];
    __syncthreads();
    loaded = c;
  };
  // hidden layer l's weights and bias, its chunk loaded
  auto layer_w = [&](int l) {
    load_chunk(l / chunk);
    return s_wh + static_cast<size_t>(l - (l / chunk) * chunk) * W * W;
  };
  auto layer_b = [&](int l) { return s_bh + (l - (l / chunk) * chunk) * W; };

  const int n_tiles = (args.n + kThreads - 1) / kThreads;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const long long p = static_cast<long long>(tile) * kThreads + tid;
    const bool active = p < args.n;
    float x[kMaxIn];
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) x[c] = (active && c < d_in) ? args.coords[p * d_in + c] : 0.f;
    __syncthreads();  // the input/output weights are loaded; staging is free

    // ---- forward: input layer (tangent seeds are rows 0..K-1 of w_in)
    float a[W], t[tdim(K)][W];
    {
      float* st = state(0);
      Op xo[kMaxIn];
#pragma unroll
      for (int c = 0; c < kMaxIn; ++c) xo[c] = Tier::op(x[c]);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        Acc z = Tier::acc(s_bin[j]);
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) {
          if (c < d_in) Tier::mac(z, xo[c], w_ld(s_win[c * W + j]));
        }
        a[j] = act_fn<ACT>(Tier::fin(z));
        const float d = dact<ACT>(a[j]);
        st[j * kThreads] = a[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float u = w_f(s_win[k * W + j]);
          st[((1 + k) * W + j) * kThreads] = u;
          t[k][j] = u * d;
        }
      }
    }
    // ---- forward: hidden stack, chunk by chunk
    for (int c = 0; c < n_chunks; ++c) {
      load_chunk(c);
      const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
#pragma unroll 1
      for (int l = 0; l < nl; ++l) {
        hidden_fwd<Tier, W, ACT, K>(s_wh + l * W * W, s_bh + l * W, a, t, fwd_slot(l0 + l + 1));
      }
    }

    // ---- the output cotangents
    float yb[kOut], ybt[tdim(K)][kOut];
    epi.template output<Tier, W, K>(p, active, a, t, s_wout, s_bout, d_out, yb, ybt);

    // ---- output layer backward: stage s_L = [a; t^0; ...] and
    // [ybar; ybar^0; ...] (and the epilogue's rows)
    __syncthreads();  // the previous tile's input-layer product is done
    float* sA = s_A + tid;
    float* sB = s_B + tid;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      sA[i * kLd] = a[i];
#pragma unroll
      for (int k = 0; k < K; ++k) sA[((1 + k) * W + i) * kLd] = t[k][i];
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      if (o < d_out) {
        sB[o * kLd] = yb[o];
#pragma unroll
        for (int k = 0; k < K; ++k) sB[((1 + k) * d_out + o) * kLd] = ybt[k][o];
      }
    }
    epi.stage(sB);
    __syncthreads();
    accum_rect<Tier, S>(s_A, W, s_B, d_out, g_wout, g_bout, first);
    epi.reduce(s_B, g_extra, first);

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

    // ---- hidden stack backward, layer j maps state j -> state j + 1
    constexpr int kVec = row_vec<W>();
    auto back_layer = [&](int j, const float* st_cur, const float* st_prev) {
      const WT* w = layer_w(j);
      __syncthreads();  // the previous layer's block product is done
      state_bwd<W, ACT, K>(st_cur, ca, ct, sB);
      stage_state<W, ACT, K>(st_prev, sA);
      __syncthreads();
      accum_square<Tier, W, S>(s_A, s_B, g_wh + static_cast<size_t>(j) * W * W, g_bh + j * W,
                               first);
      // cotangent into state j: [zbar; ubar^0; ...] (at the tier) @ w^T
      Op cao[W], cto[tdim(K)][W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        cao[q] = Tier::op(ca[q]);
#pragma unroll
        for (int k = 0; k < K; ++k) cto[k][q] = Tier::op(ct[k][q]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        Acc nai = Tier::acc(0.f), nti[tdim(K)];
#pragma unroll
        for (int k = 0; k < K; ++k) nti[k] = Tier::acc(0.f);
#pragma unroll
        for (int q = 0; q < W; q += kVec) {
          WV wv[kVec];
          load_vec<kVec>(w + i * W + q, wv);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            Tier::mac(nai, cao[q + v], wv[v]);
#pragma unroll
            for (int k = 0; k < K; ++k) Tier::mac(nti[k], cto[k][q + v], wv[v]);
          }
        }
        ca[i] = Tier::fin(nai);
#pragma unroll
        for (int k = 0; k < K; ++k) ct[k][i] = Tier::fin(nti[k]);
      }
    };
    if constexpr (Policy::kRebuild) {
      // segments of C layers in reverse: re-run each from its checkpoint
      // into the segment buffer, then walk it back
      const int n_seg = (n_stack + ckpt - 1) / ckpt;
#pragma unroll 1
      for (int sg = n_seg - 1; sg >= 0; --sg) {
        const int j0 = sg * ckpt, len = min(ckpt, n_stack - j0);
        const float* ck = state(sg);
        load_state<W, ACT, K>(ck, a, t);
#pragma unroll 1
        for (int i = 0; i < len; ++i) {
          const WT* w = layer_w(j0 + i);
          hidden_fwd<Tier, W, ACT, K>(w, layer_b(j0 + i), a, t, seg(i));
        }
#pragma unroll 1
        for (int j = j0 + len - 1; j >= j0; --j) {
          back_layer(j, seg(j - j0), j == j0 ? ck : seg(j - j0 - 1));
        }
      }
    } else {
#pragma unroll 1
      for (int j = n_stack - 1; j >= 0; --j) back_layer(j, state(j + 1), state(j));
    }

    // ---- input layer backward: s_in = [x; e_0; ...], so dw_in[k, :] also
    // collects sum_p ubar_0^k (the tangent seeds are rows k of w_in)
    __syncthreads();
    state_bwd<W, ACT, K>(state(0), ca, ct, sB);
    for (int c = 0; c < d_in; ++c) {
      sA[c * kLd] = x[c];
#pragma unroll
      for (int k = 0; k < K; ++k) sA[((1 + k) * d_in + c) * kLd] = c == k ? 1.f : 0.f;
    }
    __syncthreads();
    accum_rect<Tier, S>(s_A, d_in, s_B, W, g_win, g_bin, first, /*seed_rows=*/true);
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

  __device__ __forceinline__ void stage(float*) const {}

  __device__ __forceinline__ void reduce(const float*, float*, bool) const {}
};

// The arguments of K3 and K4.
struct CotangentArgs {
  WalkArgs walk;
  const float *ybar, *dybar;
};

// K3 (StoreAll) and K4 (Rebuild): the walk with loaded cotangents.
template <class Tier, class Policy, int W, int ACT, int K>
__global__ void __launch_bounds__(kThreads) cotangent_walk_kernel(const CotangentArgs args) {
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

// Launch a walk kernel on `grid` blocks, then the fixed-order reduction of
// its partial rows into `out` (n_ent floats). Returns a cudaError_t.
template <class Kernel, class KernelArgs>
cudaError_t launch(Kernel kernel, const KernelArgs& kargs, size_t smem, int grid,
                   const float* partial, float* out, int n_ent, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(kargs);
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
  switch (n_tangents) {
    case 0: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 0>, a, smem, grid,
                          a.walk.partial, out, n_ent, stream);
    case 1: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 1>, a, smem, grid,
                          a.walk.partial, out, n_ent, stream);
    case 2: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 2>, a, smem, grid,
                          a.walk.partial, out, n_ent, stream);
    default: return launch(cotangent_walk_kernel<Tier, Policy, W, ACT, 3>, a, smem, grid,
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

// The argument checks K3 and K4 share; true when the call is valid.
inline bool cotangent_args_ok(int W, const float* dybar, int n, int d_in, int d_out,
                              int n_stack, int n_tangents, int act, int grid) {
  return !(n <= 0 || d_in < 1 || d_in > kMaxIn || d_in > W || d_out < 1 ||
           d_out > LoadedCotangents::kMaxOut || d_out > W || n_stack < 0 || n_tangents < 0 ||
           n_tangents > 3 || n_tangents > d_in || (n_tangents > 0 && dybar == nullptr) ||
           (act != 0 && act != 1) || grid < 1 || grid > (n + kThreads - 1) / kThreads);
}

}  // namespace mlp_bwd
