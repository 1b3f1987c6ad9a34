// K1 for Hopper: the one-kernel training step of the continuity losses, tiers
// f32, bf16 and f32x3.
//
// Replaces the TPU kernel of the JAX package's ops/kernels_step.py:205
// _stats_and_grads (pallas_call at :272), whose body is ops/kernels_vjp.py:433
// _make_bwd_kernel_stream(train_epilogue=n_true). For every point p, with
// tangent seeds e_x, e_y, it computes
//   1. the forward pass with the two coordinate tangents (as K2 with K=2):
//      y = (U, V, h), y_x, y_y;
//   2. fc = mask*(h_x*U + h*U_x + h_y*V + h*V_y), anch = sel*(h - depth)
//      (anchored losses only), err_j = mask*(y_j - true_j) for j < n_true;
//   3. the statistics [sum fc^2, sum anch^2, sum err_j^2] over all points;
//   4. the output cotangents from the scales [res_scale, anchor_scale,
//      anchor_depth, fid_scale_0..] of kernels_step.py::_loss_scales, with
//      fbar = res_scale*fc:
//        Ubar = fid_0*err_0 + fbar*h_x,  Vbar = fid_1*err_1 + fbar*h_y,
//        hbar = anchor_scale*anch [+ fid_2*err_2] + fbar*(U_x + V_y),
//        ybar_x = (fbar*h, 0, fbar*U),   ybar_y = (0, fbar*h, fbar*V);
//   5. the walk back through the output layer, the hidden stack and the
//      input layer, whose tangent streams start as rows k of w_in, so
//      dw_in[k, :] also collects sum_p ubar_0^k (the tangent-seed term).
// Outputs: every parameter gradient and the statistics, summed over points.
//
// Design. The forward replay, the layer-state scratch and the backward walk
// (a lane pair per point, tiles sized per launch, the per-layer block
// product on every thread, per-block partial rows, the ordered second-pass
// sum, no atomics) are mlp_bwd_common.cuh's under its StoreAll policy (K1
// is always the JAX 'stream' body), which K3 and K4
// share; this file holds the continuity epilogue that turns the last state
// into the loss statistics and the output cotangents, and instantiates the
// walk at K=2 with three heads. At the bf16 tier (k1_train_step_bf16) the
// walk rounds as tier.cuh says, and the epilogue rounds the last state
// before w_out (JAX ops/kernels_vjp.py:569); at the f32x3 tier
// (k1_train_step_f32x3) the walk and the epilogue split those operands
// instead; the statistics and the cotangents stay f32.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// forward (238,200 for the 2->[20]x100->3 flagship at K=2) and about twice
// that backward (476,000), plus L*W tanhf, against a few bytes of inputs
// and ~0.6 MB of weights and gradients: the CUDA cores' f32 FMA rate bounds
// it. What the design spends beyond that: the layer states go to device
// memory and back once (24,240 B per point at the flagship, ~0.6 GB of
// traffic at 12,516 points), the lane pairs' shuffles and the block
// products' shared-memory loads (mlp_bwd_common.cuh). Tensor cores are
// left for later work (ROADMAP.md).
//
// Limits (the wrapper checks them first and raises): W in the compiled
// widths; 1 <= d_in <= 8 with the tangents on inputs 0 and 1; d_out = 3;
// 1 <= n_true <= 3, n_true <= 2 with the anchor; tanh (act 0) or
// LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#include "mlp_bwd_common.cuh"

#ifndef K1_WIDTH
#error "compile with -DK1_WIDTH=<hidden width>"
#endif

namespace {

using mlp_bwd::kMaxIn;
using mlp_bwd::accumulate;

constexpr int kOut = 3;                // heads (U, V, h)
constexpr int kStats = 8;              // fc^2, anch^2, err_0..2^2, 3 unused
constexpr int kStatRow = 9;            // first staging row of the statistics

struct Args {
  mlp_bwd::WalkArgs walk;
  const float *trues, *sel, *mask, *scal;
  int n_true, has_anchor;
};

// Steps 2-4 of the header: from the last state, the loss terms of one point
// and the output cotangents (both lanes of a pair); the statistics are
// staged after the cotangents (lane 0) and summed over the tile's points.
struct ContinuityEpilogue {
  static constexpr int kMaxOut = kOut;
  static constexpr int kExtra = kStats;

  const float *trues, *sel, *mask;
  float res_scale, anchor_scale, depth, fid_scale[3];
  int n_true, has_anchor;
  float fc, anch, err[3];  // this thread's point, for the statistics

  __device__ explicit ContinuityEpilogue(const Args& args)
      : trues(args.trues), sel(args.sel), mask(args.mask),
        res_scale(args.scal[0]), anchor_scale(args.scal[1]), depth(args.scal[2]),
        fid_scale{args.scal[3], args.scal[4], args.scal[5]},
        n_true(args.n_true), has_anchor(args.has_anchor) {}

  template <class Tier, int W, int K>
  __device__ __forceinline__ void output(long long p, bool active, const float (&a)[W],
                                         const float (&t)[mlp_bwd::tdim(K)][W],
                                         const typename Tier::WT* __restrict__ s_wout,
                                         const float* __restrict__ s_bout, int d_out,
                                         float (&yb)[kOut],
                                         float (&ybt)[mlp_bwd::tdim(K)][kOut]) {
    static_assert(K == 2, "the continuity losses differentiate w.r.t. (x, y)");
    // ---- output layer and the loss epilogue
    typename Tier::Acc ya[kOut], dya[2][kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      ya[o] = Tier::acc(s_bout[o]);
      dya[0][o] = Tier::acc(0.f);
      dya[1][o] = Tier::acc(0.f);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const typename Tier::Op aj = Tier::op(a[j]), t0 = Tier::op(t[0][j]), t1 = Tier::op(t[1][j]);
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const typename Tier::WV wv = tier::w_ld(s_wout[j * kOut + o]);
        Tier::mac(ya[o], aj, wv);
        Tier::mac(dya[0][o], t0, wv);
        Tier::mac(dya[1][o], t1, wv);
      }
    }
    float y[kOut], dy[2][kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      y[o] = Tier::fin(ya[o]);
      dy[0][o] = Tier::fin(dya[0][o]);
      dy[1][o] = Tier::fin(dya[1][o]);
    }
    const float U = y[0], V = y[1], h = y[2];
    const float Ux = dy[0][0], hx = dy[0][2], Vy = dy[1][1], hy = dy[1][2];
    const float m = active ? mask[p] : 0.f;
    const float s = active ? sel[p] : 0.f;
    fc = (hx * U + h * Ux + hy * V + h * Vy) * m;
    anch = has_anchor ? s * (h - depth) : 0.f;
    err[0] = 0.f;
    err[1] = 0.f;
    err[2] = 0.f;
    for (int j = 0; j < n_true; ++j) {
      err[j] = active ? m * (y[j] - trues[p * n_true + j]) : 0.f;
    }
    const float fbar = res_scale * fc;
    yb[0] = fbar * hx;
    yb[1] = fbar * hy;
    yb[2] = anchor_scale * anch + fbar * (Ux + Vy);
    for (int j = 0; j < n_true; ++j) yb[j] += fid_scale[j] * err[j];
    ybt[0][0] = fbar * h;
    ybt[0][1] = 0.f;
    ybt[0][2] = fbar * U;
    ybt[1][0] = 0.f;
    ybt[1][1] = fbar * h;
    ybt[1][2] = fbar * V;
  }

  __device__ __forceinline__ void stage(float* __restrict__ sB, int ld) const {
    sB[kStatRow * ld] = fc * fc;
    sB[(kStatRow + 1) * ld] = anch * anch;
#pragma unroll
    for (int j = 0; j < 3; ++j) sB[(kStatRow + 2 + j) * ld] = err[j] * err[j];
  }

  __device__ __forceinline__ void reduce(const float* __restrict__ s_B, int ld, int P,
                                         float* __restrict__ g_stats, bool first) const {
    for (int s = threadIdx.x; s < 5; s += blockDim.x) {
      float acc = 0.f;
      for (int q = 0; q < P; ++q) acc += s_B[(kStatRow + s) * ld + q];
      g_stats[s] = accumulate(g_stats + s, acc, first);
    }
    for (int s = 5 + threadIdx.x; s < kStats; s += blockDim.x) g_stats[s] = 0.f;
  }
};

template <class Tier, int W, int ACT>
__global__ void __launch_bounds__(mlp_bwd::kMaxThreads<Tier, W>)
k1_train_step_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  ContinuityEpilogue epi(args);
  mlp_bwd::walk<Tier, mlp_bwd::StoreAll, W, ACT, 2>(args.walk, epi, smem);
}

constexpr int kStreams = 3;  // the primal and two tangent streams

template <class Tier>
int chunk_layers(int n_stack, int tile) {
  return mlp_bwd::chunk_layers(K1_WIDTH, kStreams, kOut, n_stack, sizeof(typename Tier::WT), 0,
                               tile);
}

template <class Tier>
int run(const float* coords, const float* trues, const float* sel, const float* mask,
        const float* scal, const float* w_in, const float* b_in, const float* w_h,
        const float* b_h, const float* w_out, const float* b_out, float* partial,
        float* states, float* out, int n, int d_in, int n_stack, int n_true, int has_anchor,
        int act, int grid, int tile, void* stream) {
  constexpr int W = K1_WIDTH;
  if (n <= 0 || d_in < 2 || d_in > kMaxIn || n_stack < 0 || n_true < 1 || n_true > 3 ||
      (has_anchor && n_true > 2) || (act != 0 && act != 1) ||
      !mlp_bwd::plan_ok<Tier, W>(n, tile, grid))
    return cudaErrorInvalidValue;
  int chunk = 0;
  if (n_stack > 0) {
    chunk = chunk_layers<Tier>(n_stack, tile);
    if (chunk < 1) return cudaErrorInvalidValue;
  }
  const long long n_ent = mlp_bwd::n_params(W, d_in, kOut, n_stack) + kStats;
  const Args a{{coords, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, n, d_in, kOut,
                n_stack, chunk, 0, tile},
               trues, sel, mask, scal, n_true, has_anchor};
  const size_t smem =
      mlp_bwd::smem_bytes(W, kStreams, kOut, chunk, sizeof(typename Tier::WT), 0, tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0
             ? mlp_bwd::launch(k1_train_step_kernel<Tier, W, 0>, a, smem, grid, tile, partial,
                               out, static_cast<int>(n_ent), s)
             : mlp_bwd::launch(k1_train_step_kernel<Tier, W, 1>, a, smem, grid, tile, partial,
                               out, static_cast<int>(n_ent), s);
}

}  // namespace

extern "C" {

int k1_width() { return K1_WIDTH; }

// Threads per point: a block of a tile of P points has k1_lanes() * P
// threads.
int k1_lanes() { return mlp_bwd::kLanes; }

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most points a tile may hold, per tier.
#if WITH_TIER(0)
int k1_max_tile() { return mlp_bwd::max_tile<tier::TierF32, K1_WIDTH>(); }
#endif

#if WITH_TIER(1)
int k1_max_tile_bf16() { return mlp_bwd::max_tile<tier::TierBf16, K1_WIDTH>(); }
#endif

#if WITH_TIER(2)
int k1_max_tile_f32x3() { return mlp_bwd::max_tile<tier::TierF32x3, K1_WIDTH>(); }
#endif

// Hidden layers one shared-memory chunk holds on the current device for
// tiles of `tile` points (0 when not even one fits beside the staging
// rows), per tier.
#if WITH_TIER(0)
int k1_chunk_layers(int n_stack, int tile) { return chunk_layers<tier::TierF32>(n_stack, tile); }
#endif

#if WITH_TIER(1)
int k1_chunk_layers_bf16(int n_stack, int tile) {
  return chunk_layers<tier::TierBf16>(n_stack, tile);
}
#endif

#if WITH_TIER(2)
int k1_chunk_layers_f32x3(int n_stack, int tile) {
  return chunk_layers<tier::TierF32x3>(n_stack, tile);
}
#endif

// One training-step evaluation: K1 on a grid of `grid` blocks of tiles of
// `tile` points (ops/walk_plan.py) into `partial` (grid rows of n_params +
// 8 floats), then the fixed-order reduction into `out` (n_params + 8: the
// gradients in sorted-key order, then the statistics). `states` holds
// grid * (n_stack + 1) * 3W * tile floats. Returns a cudaError_t; nothing
// synchronises. k1_train_step_bf16 and k1_train_step_f32x3 take the same
// arguments at the bf16 and f32x3 tiers.
#if WITH_TIER(0)
int k1_train_step(const float* coords, const float* trues, const float* sel,
                  const float* mask, const float* scal, const float* w_in,
                  const float* b_in, const float* w_h, const float* b_h,
                  const float* w_out, const float* b_out, float* partial, float* states,
                  float* out, int n, int d_in, int n_stack, int n_true, int has_anchor,
                  int act, int grid, int tile, void* stream) {
  return run<tier::TierF32>(coords, trues, sel, mask, scal, w_in, b_in, w_h, b_h, w_out, b_out,
                            partial, states, out, n, d_in, n_stack, n_true, has_anchor, act,
                            grid, tile, stream);
}
#endif

#if WITH_TIER(1)
int k1_train_step_bf16(const float* coords, const float* trues, const float* sel,
                       const float* mask, const float* scal, const float* w_in,
                       const float* b_in, const float* w_h, const float* b_h,
                       const float* w_out, const float* b_out, float* partial, float* states,
                       float* out, int n, int d_in, int n_stack, int n_true, int has_anchor,
                       int act, int grid, int tile, void* stream) {
  return run<tier::TierBf16>(coords, trues, sel, mask, scal, w_in, b_in, w_h, b_h, w_out,
                             b_out, partial, states, out, n, d_in, n_stack, n_true, has_anchor,
                             act, grid, tile, stream);
}
#endif

#if WITH_TIER(2)
int k1_train_step_f32x3(const float* coords, const float* trues, const float* sel,
                        const float* mask, const float* scal, const float* w_in,
                        const float* b_in, const float* w_h, const float* b_h,
                        const float* w_out, const float* b_out, float* partial, float* states,
                        float* out, int n, int d_in, int n_stack, int n_true, int has_anchor,
                        int act, int grid, int tile, void* stream) {
  return run<tier::TierF32x3>(coords, trues, sel, mask, scal, w_in, b_in, w_h, b_h, w_out,
                              b_out, partial, states, out, n, d_in, n_stack, n_true, has_anchor,
                              act, grid, tile, stream);
}
#endif

}  // extern "C"
