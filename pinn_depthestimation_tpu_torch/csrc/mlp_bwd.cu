// K3 for Hopper: the parameter gradients of the MLP with K coordinate
// tangents from given output cotangents, every layer state stored; tiers
// f32, bf16 and f32x3.
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
// Design: the walk of mlp_bwd_common.cuh (shared with K1 and K4) under its
// StoreAll policy: a replay of the forward that keeps every layer state,
// then the backward with a lane pair per point, tiles sized per launch so
// that one call's tiles fill the SMs, the per-layer block product on every
// thread, per-block partial rows and an ordered second-pass sum (no
// atomics: bit-identical from run to run). The epilogue (LoadedCotangents)
// only loads ybar and dybar of the tile's points. One library per hidden width
// (-DK3_WIDTH=W), holding the K = 0..3, tanh/LeakyReLU and f32/bf16/f32x3
// instantiations; the bf16 and f32x3 entries are k3_mlp_bwd_bf16 and
// k3_mlp_bwd_f32x3. At the bf16 tier the JAX package runs K4 by default;
// K3-bf16 is its impl='stream'. At f32x3 K3 is the default, as at f32.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// of replay and 2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W of backward
// (17,440 for the 2->[10]x10->6 CMB net at K=2) against
// (d_in + (1+K)*d_out)*4 bytes of inputs: the f32 FMA rate bounds it. At
// the CMB's ~20,500 points the plan takes tiles of 160 points (129 tiles on
// 132 SMs, one wave), so the walk's serial chain per tile and the launch
// dominate, not the FMAs.
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

template <class Tier>
int chunk_layers(int n_stack, int n_tangents, int tile) {
  return mlp_bwd::chunk_layers(K3_WIDTH, 1 + n_tangents, mlp_bwd::LoadedCotangents::kMaxOut,
                               n_stack, sizeof(typename Tier::WT), 0, tile);
}

template <class Tier>
int run(const float* coords, const float* ybar, const float* dybar, const float* w_in,
        const float* b_in, const float* w_h, const float* b_h, const float* w_out,
        const float* b_out, float* partial, float* states, float* out, int n, int d_in,
        int d_out, int n_stack, int n_tangents, int act, int grid, int tile, void* stream) {
  constexpr int W = K3_WIDTH;
  if (!mlp_bwd::cotangent_args_ok<Tier, W>(dybar, n, d_in, d_out, n_stack, n_tangents, act, grid,
                                           tile))
    return cudaErrorInvalidValue;
  int chunk = 0;
  if (n_stack > 0) {
    chunk = chunk_layers<Tier>(n_stack, n_tangents, tile);
    if (chunk < 1) return cudaErrorInvalidValue;
  }
  const long long n_ent = mlp_bwd::n_params(W, d_in, d_out, n_stack);
  const mlp_bwd::CotangentArgs a{
      {coords, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, n, d_in, d_out, n_stack,
       chunk, 0, tile},
      ybar, dybar};
  const size_t smem = mlp_bwd::smem_bytes(W, 1 + n_tangents, mlp_bwd::LoadedCotangents::kMaxOut,
                                          chunk, sizeof(typename Tier::WT), 0, tile);
  return mlp_bwd::launch_cotangents<Tier, mlp_bwd::StoreAll, W>(
      a, n_tangents, act, smem, grid, out, static_cast<int>(n_ent),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int k3_width() { return K3_WIDTH; }

// Threads per point: a block of a tile of P points has k3_lanes() * P
// threads.
int k3_lanes() { return mlp_bwd::kLanes; }

// The most points a tile may hold, per tier.
#if WITH_TIER(0)
int k3_max_tile() { return mlp_bwd::max_tile<tier::TierF32, K3_WIDTH>(); }
#endif

#if WITH_TIER(1)
int k3_max_tile_bf16() { return mlp_bwd::max_tile<tier::TierBf16, K3_WIDTH>(); }
#endif

#if WITH_TIER(2)
int k3_max_tile_f32x3() { return mlp_bwd::max_tile<tier::TierF32x3, K3_WIDTH>(); }
#endif

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hidden layers one shared-memory chunk holds on the current device for
// n_tangents streams and tiles of `tile` points (0 when not even one fits
// beside the staging rows), per tier.
#if WITH_TIER(0)
int k3_chunk_layers(int n_stack, int n_tangents, int tile) {
  return chunk_layers<tier::TierF32>(n_stack, n_tangents, tile);
}
#endif

#if WITH_TIER(1)
int k3_chunk_layers_bf16(int n_stack, int n_tangents, int tile) {
  return chunk_layers<tier::TierBf16>(n_stack, n_tangents, tile);
}
#endif

#if WITH_TIER(2)
int k3_chunk_layers_f32x3(int n_stack, int n_tangents, int tile) {
  return chunk_layers<tier::TierF32x3>(n_stack, n_tangents, tile);
}
#endif

// One backward: K3 on a grid of `grid` blocks of tiles of `tile` points
// (ops/walk_plan.py) into `partial` (grid rows of n_params floats), then
// the fixed-order reduction into `out` (n_params: the gradients in
// sorted-key order). `states` holds
// grid * (n_stack + 1) * (1 + n_tangents) * W * tile floats. `dybar` may be
// null when n_tangents is 0. Returns a cudaError_t; nothing synchronises.
// k3_mlp_bwd_bf16 and k3_mlp_bwd_f32x3 take the same arguments at the bf16
// and f32x3 tiers.
#if WITH_TIER(0)
int k3_mlp_bwd(const float* coords, const float* ybar, const float* dybar,
               const float* w_in, const float* b_in, const float* w_h, const float* b_h,
               const float* w_out, const float* b_out, float* partial, float* states,
               float* out, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
               int grid, int tile, void* stream) {
  return run<tier::TierF32>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                            states, out, n, d_in, d_out, n_stack, n_tangents, act, grid, tile,
                            stream);
}
#endif

#if WITH_TIER(1)
int k3_mlp_bwd_bf16(const float* coords, const float* ybar, const float* dybar,
                    const float* w_in, const float* b_in, const float* w_h, const float* b_h,
                    const float* w_out, const float* b_out, float* partial, float* states,
                    float* out, int n, int d_in, int d_out, int n_stack, int n_tangents,
                    int act, int grid, int tile, void* stream) {
  return run<tier::TierBf16>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                             states, out, n, d_in, d_out, n_stack, n_tangents, act, grid,
                             tile, stream);
}
#endif

#if WITH_TIER(2)
int k3_mlp_bwd_f32x3(const float* coords, const float* ybar, const float* dybar,
                     const float* w_in, const float* b_in, const float* w_h, const float* b_h,
                     const float* w_out, const float* b_out, float* partial, float* states,
                     float* out, int n, int d_in, int d_out, int n_stack, int n_tangents,
                     int act, int grid, int tile, void* stream) {
  return run<tier::TierF32x3>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                              states, out, n, d_in, d_out, n_stack, n_tangents, act, grid,
                              tile, stream);
}
#endif

}  // extern "C"
