// K3 for Hopper: the parameter gradients of the MLP with K coordinate
// tangents from given output cotangents, f32.
//
// Replaces the TPU kernel of the JAX package's ops/kernels_vjp.py:701
// packed_mlp_bwd(impl='stream') (pallas_call at :805), whose body is
// ops/kernels_vjp.py:433 _make_bwd_kernel_stream(train_epilogue=0): the
// backward of the custom VJP fused_apply_with_tangents. For
//   (y, dy) = mlp_apply_with_tangents(params, coords, e_0 .. e_{K-1})
// and cotangents ybar (N, d_out), dybar (K, N, d_out) it computes every
// parameter gradient, summed over points, with the input layer's
// tangent-seed term dw_in[k, :] += sum_p ubar_0^k. No gradient for coords.
//
// Design: the walk of mlp_bwd_common.cuh (shared with K1): a replay of the
// forward that keeps every layer state, then the backward with the
// per-layer block product over 128-point tiles, per-block partial rows and
// an ordered second-pass sum (no atomics: bit-identical from run to run).
// The epilogue here only loads ybar and dybar of the tile's points; the
// output layer's forward is not needed. One library per hidden width
// (-DK3_WIDTH=W), holding the K = 0..3 and tanh/LeakyReLU instantiations.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// of replay and 2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W of backward
// (17,440 for the 2->[10]x10->6 CMB net at K=2) against
// (d_in + (1+K)*d_out)*4 bytes of inputs: the f32 FMA rate bounds it. At
// the CMB's ~20,500 points that is ~160 tiles on 132 SMs, so the launch and
// the fill of the card dominate, not the FMAs.
//
// Limits (the wrapper checks them first and raises): W in the compiled
// widths; 1 <= d_in <= 8; 1 <= d_out <= 8; 0 <= K <= min(3, d_in); tanh
// (act 0) or LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#include "mlp_bwd_common.cuh"

#ifndef K3_WIDTH
#error "compile with -DK3_WIDTH=<hidden width>"
#endif

namespace {

using mlp_bwd::kMaxIn;
using mlp_bwd::kThreads;

constexpr int kMaxHeads = 8;
constexpr int kMaxTangents = 3;

struct Args {
  mlp_bwd::WalkArgs walk;
  const float *ybar, *dybar;
};

// The output cotangents of one point, loaded: ybar[p, :] and dybar[k, p, :];
// zero past N, so padding points add nothing.
struct LoadedCotangents {
  static constexpr int kMaxOut = kMaxHeads;
  static constexpr int kExtra = 0;

  const float *ybar, *dybar;
  int n;

  template <int W, int K>
  __device__ __forceinline__ void output(long long p, bool active, const float (&)[W],
                                         const float (&)[mlp_bwd::tdim(K)][W],
                                         const float* __restrict__, const float* __restrict__,
                                         int d_out, float (&yb)[kMaxOut],
                                         float (&ybt)[mlp_bwd::tdim(K)][kMaxOut]) const {
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

template <int W, int ACT, int K>
__global__ void __launch_bounds__(kThreads)
k3_mlp_bwd_kernel(const Args args) {
  extern __shared__ __align__(16) float smem[];
  LoadedCotangents epi{args.ybar, args.dybar, args.walk.n};
  mlp_bwd::walk<W, ACT, K>(args.walk, epi, smem);
}

template <int ACT, int K>
cudaError_t launch(const Args& a, int grid, float* out, int n_ent, cudaStream_t stream) {
  constexpr int W = K3_WIDTH;
  const size_t smem = mlp_bwd::smem_bytes(W, 1 + K, kMaxHeads, a.walk.chunk);
  return mlp_bwd::launch(k3_mlp_bwd_kernel<W, ACT, K>, a, smem, grid, a.walk.partial, out,
                         n_ent, stream);
}

template <int ACT>
cudaError_t launch_k(const Args& a, int n_tangents, int grid, float* out, int n_ent,
                     cudaStream_t stream) {
  switch (n_tangents) {
    case 0: return launch<ACT, 0>(a, grid, out, n_ent, stream);
    case 1: return launch<ACT, 1>(a, grid, out, n_ent, stream);
    case 2: return launch<ACT, 2>(a, grid, out, n_ent, stream);
    default: return launch<ACT, 3>(a, grid, out, n_ent, stream);
  }
}

}  // namespace

extern "C" {

int k3_width() { return K3_WIDTH; }

int k3_threads() { return kThreads; }

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hidden layers one shared-memory chunk holds on the current device for
// n_tangents streams (0 when not even one fits beside the staging rows).
int k3_chunk_layers(int n_stack, int n_tangents) {
  return mlp_bwd::chunk_layers(K3_WIDTH, 1 + n_tangents, kMaxHeads, n_stack);
}

// One backward: K3 on a grid of `grid` blocks into `partial` (grid rows of
// n_params floats), then the fixed-order reduction into `out` (n_params:
// the gradients in sorted-key order). `states` holds
// grid * (n_stack + 1) * (1 + n_tangents) * W * 128 floats. `dybar` may be
// null when n_tangents is 0. Returns a cudaError_t; nothing synchronises.
int k3_mlp_bwd(const float* coords, const float* ybar, const float* dybar,
               const float* w_in, const float* b_in, const float* w_h, const float* b_h,
               const float* w_out, const float* b_out, float* partial, float* states,
               float* out, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
               int grid, void* stream) {
  constexpr int W = K3_WIDTH;
  if (n <= 0 || d_in < 1 || d_in > kMaxIn || d_in > W || d_out < 1 || d_out > kMaxHeads ||
      d_out > W || n_stack < 0 || n_tangents < 0 || n_tangents > kMaxTangents ||
      n_tangents > d_in || (n_tangents > 0 && dybar == nullptr) || (act != 0 && act != 1) ||
      grid < 1 || grid > (n + kThreads - 1) / kThreads)
    return cudaErrorInvalidValue;
  int chunk = 1;
  if (n_stack > 0) {
    chunk = k3_chunk_layers(n_stack, n_tangents);
    if (chunk < 1) return cudaErrorInvalidValue;
  }
  const long long n_ent = mlp_bwd::n_params(W, d_in, d_out, n_stack);
  const Args a{{coords, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, n, d_in, d_out,
                n_stack, n_stack > 0 ? chunk : 0},
               ybar, dybar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? launch_k<0>(a, n_tangents, grid, out, static_cast<int>(n_ent), s)
                  : launch_k<1>(a, n_tangents, grid, out, static_cast<int>(n_ent), s);
}

}  // extern "C"
