// K4 for Hopper: the parameter gradients of the MLP with K coordinate
// tangents from given output cotangents, by segmented recomputation; tiers
// f32, bf16 and f32x3.
//
// Replaces the TPU kernel of the JAX package's ops/kernels_vjp.py:268
// _make_bwd_kernel, launched by packed_mlp_bwd(impl='rebuild') (pallas_call
// at :805): the default backward of the custom VJP fused_apply_with_tangents
// at the bf16 tier. It computes K3's function (mlp_bwd.cu): for
//   (y, dy) = mlp_apply_with_tangents(params, coords, e_0 .. e_{K-1})
// and cotangents ybar (N, d_out), dybar (K, N, d_out), every parameter
// gradient summed over points, with the tangent-seed term of dw_in. No
// gradient for coords.
//
// Design: the walk of mlp_bwd_common.cuh under its Rebuild policy. The
// forward replay keeps only every C-th layer state (the checkpoints, in a
// per-block device scratch of ceil(n_stack / C) states); the backward takes
// the segments of C layers in reverse, re-runs each from its checkpoint
// into a segment buffer of C states in shared memory, and walks it back
// with the same lane pairs, per-layer block product, partial rows and
// ordered second-pass sum as K3 (no atomics: bit-identical from run to
// run). The segment buffer takes C*(1+K)*W*P*4 B (P points per tile)
// beside the weights and the staging rows, so C is what fits: the wrapper
// asks for a C (ckpt_every) or takes mlp_bwd::rebuild_plan's (the largest
// C <= 8 that leaves the whole stack in one chunk, else half of it; at
// f32x3 the weights take the bytes of f32, so the plan is f32's). One
// library per hidden width (-DK4_WIDTH=W), holding the K = 0..3,
// tanh/LeakyReLU and f32/bf16/f32x3 instantiations; the bf16 and f32x3
// entries are k4_mlp_bwd_bf16 and k4_mlp_bwd_f32x3. At f32x3 the
// JAX package reaches K4 only through impl='rebuild'.
//
// Bound on the H100: K3's operations plus one more forward replay of the
// hidden stack, 2*(L-1)*W^2*(1+K) per point; the CUDA cores' f32 FMA rate
// bounds it. In exchange it keeps n_stack/C states in device memory
// instead of n_stack + 1.
//
// Limits (the wrapper checks them first and raises): W in the compiled
// widths; 1 <= d_in <= 8; 1 <= d_out <= 8; 0 <= K <= min(3, d_in); tanh
// (act 0) or LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#include "mlp_bwd_common.cuh"

#ifndef K4_WIDTH
#error "compile with -DK4_WIDTH=<hidden width>"
#endif

namespace {

template <class Tier>
bool plan(int n_stack, int n_tangents, int ckpt, int tile, int* c, int* chunk) {
  return mlp_bwd::rebuild_plan(K4_WIDTH, 1 + n_tangents, mlp_bwd::LoadedCotangents::kMaxOut,
                               n_stack, sizeof(typename Tier::WT), ckpt, tile, c, chunk);
}

template <class Tier>
int run(const float* coords, const float* ybar, const float* dybar, const float* w_in,
        const float* b_in, const float* w_h, const float* b_h, const float* w_out,
        const float* b_out, float* partial, float* states, float* out, int n, int d_in,
        int d_out, int n_stack, int n_tangents, int act, int ckpt, int grid, int tile,
        void* stream) {
  constexpr int W = K4_WIDTH;
  if (!mlp_bwd::cotangent_args_ok<Tier, W>(dybar, n, d_in, d_out, n_stack, n_tangents, act, grid,
                                           tile) ||
      ckpt < 1)
    return cudaErrorInvalidValue;
  int c = 0, chunk = 0;
  if (!plan<Tier>(n_stack, n_tangents, ckpt, tile, &c, &chunk) || (n_stack > 0 && c != ckpt))
    return cudaErrorInvalidValue;
  const long long n_ent = mlp_bwd::n_params(W, d_in, d_out, n_stack);
  const mlp_bwd::CotangentArgs a{
      {coords, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, n, d_in, d_out, n_stack,
       chunk, c, tile},
      ybar, dybar};
  const size_t smem = mlp_bwd::smem_bytes(W, 1 + n_tangents, mlp_bwd::LoadedCotangents::kMaxOut,
                                          chunk, sizeof(typename Tier::WT), c, tile);
  return mlp_bwd::launch_cotangents<Tier, mlp_bwd::Rebuild, W>(
      a, n_tangents, act, smem, grid, out, static_cast<int>(n_ent),
      static_cast<cudaStream_t>(stream));
}

template <class Tier>
int ckpt_every(int n_stack, int n_tangents, int ckpt, int tile) {
  int c = 0, chunk = 0;
  return plan<Tier>(n_stack, n_tangents, ckpt, tile, &c, &chunk) ? c : 0;
}

template <class Tier>
int chunk_layers(int n_stack, int n_tangents, int ckpt, int tile) {
  return mlp_bwd::chunk_layers(K4_WIDTH, 1 + n_tangents, mlp_bwd::LoadedCotangents::kMaxOut,
                               n_stack, sizeof(typename Tier::WT), ckpt, tile);
}

}  // namespace

extern "C" {

int k4_width() { return K4_WIDTH; }

// Threads per point: a block of a tile of P points has k4_lanes() * P
// threads.
int k4_lanes() { return mlp_bwd::kLanes; }

// The most points a tile may hold, per tier.
#if WITH_TIER(0)
int k4_max_tile() { return mlp_bwd::max_tile<tier::TierF32, K4_WIDTH>(); }
#endif

#if WITH_TIER(1)
int k4_max_tile_bf16() { return mlp_bwd::max_tile<tier::TierBf16, K4_WIDTH>(); }
#endif

#if WITH_TIER(2)
int k4_max_tile_f32x3() { return mlp_bwd::max_tile<tier::TierF32x3, K4_WIDTH>(); }
#endif

const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The segment length C a launch on tiles of `tile` points takes on the
// current device: `ckpt` cut to n_stack when it fits, the planned C when
// `ckpt` is 0; 0 when nothing fits.
#if WITH_TIER(0)
int k4_ckpt_every(int n_stack, int n_tangents, int ckpt, int tile) {
  return ckpt_every<tier::TierF32>(n_stack, n_tangents, ckpt, tile);
}
#endif

#if WITH_TIER(1)
int k4_ckpt_every_bf16(int n_stack, int n_tangents, int ckpt, int tile) {
  return ckpt_every<tier::TierBf16>(n_stack, n_tangents, ckpt, tile);
}
#endif

#if WITH_TIER(2)
int k4_ckpt_every_f32x3(int n_stack, int n_tangents, int ckpt, int tile) {
  return ckpt_every<tier::TierF32x3>(n_stack, n_tangents, ckpt, tile);
}
#endif

// Hidden layers one shared-memory chunk holds beside a segment buffer of
// `ckpt` states of tiles of `tile` points (0 when not even one fits), per
// tier.
#if WITH_TIER(0)
int k4_chunk_layers(int n_stack, int n_tangents, int ckpt, int tile) {
  return chunk_layers<tier::TierF32>(n_stack, n_tangents, ckpt, tile);
}
#endif

#if WITH_TIER(1)
int k4_chunk_layers_bf16(int n_stack, int n_tangents, int ckpt, int tile) {
  return chunk_layers<tier::TierBf16>(n_stack, n_tangents, ckpt, tile);
}
#endif

#if WITH_TIER(2)
int k4_chunk_layers_f32x3(int n_stack, int n_tangents, int ckpt, int tile) {
  return chunk_layers<tier::TierF32x3>(n_stack, n_tangents, ckpt, tile);
}
#endif

// One backward: K4 with segments of `ckpt` layers (k4_ckpt_every's value)
// on a grid of `grid` blocks of tiles of `tile` points (ops/walk_plan.py)
// into `partial` (grid rows of n_params floats), then the fixed-order
// reduction into `out` (n_params: the gradients in sorted-key order).
// `states` holds grid * max(1, ceil(n_stack / ckpt)) * (1 + n_tangents) *
// W * tile floats (the checkpoints). `dybar` may be null
// when n_tangents is 0. Returns a cudaError_t; nothing synchronises.
// k4_mlp_bwd_bf16 and k4_mlp_bwd_f32x3 take the same arguments at the bf16
// and f32x3 tiers.
#if WITH_TIER(0)
int k4_mlp_bwd(const float* coords, const float* ybar, const float* dybar,
               const float* w_in, const float* b_in, const float* w_h, const float* b_h,
               const float* w_out, const float* b_out, float* partial, float* states,
               float* out, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
               int ckpt, int grid, int tile, void* stream) {
  return run<tier::TierF32>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                            states, out, n, d_in, d_out, n_stack, n_tangents, act, ckpt, grid,
                            tile, stream);
}
#endif

#if WITH_TIER(1)
int k4_mlp_bwd_bf16(const float* coords, const float* ybar, const float* dybar,
                    const float* w_in, const float* b_in, const float* w_h, const float* b_h,
                    const float* w_out, const float* b_out, float* partial, float* states,
                    float* out, int n, int d_in, int d_out, int n_stack, int n_tangents,
                    int act, int ckpt, int grid, int tile, void* stream) {
  return run<tier::TierBf16>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                             states, out, n, d_in, d_out, n_stack, n_tangents, act, ckpt, grid,
                             tile, stream);
}
#endif

#if WITH_TIER(2)
int k4_mlp_bwd_f32x3(const float* coords, const float* ybar, const float* dybar,
                     const float* w_in, const float* b_in, const float* w_h, const float* b_h,
                     const float* w_out, const float* b_out, float* partial, float* states,
                     float* out, int n, int d_in, int d_out, int n_stack, int n_tangents,
                     int act, int ckpt, int grid, int tile, void* stream) {
  return run<tier::TierF32x3>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial,
                              states, out, n, d_in, d_out, n_stack, n_tangents, act, ckpt, grid,
                              tile, stream);
}
#endif

}  // extern "C"
