// K3's and K4's wide body: the parameter gradients of the MLP with K
// coordinate tangents from given output cotangents, for the nets the narrow
// bodies (mlp_bwd.cu, mlp_bwd_rebuild.cu) do not take: hidden width 33-128,
// or d_in or d_out above 8 (any W <= 128, at run time). Tiers f32, bf16 and
// f32x3, one library per tier (-DTIER_ONLY); -DWIDE_REBUILD=0 builds K3
// (entries k3w_*), -DWIDE_REBUILD=1 K4 (k4w_*).
//
// Replaces, at those shapes, the TPU kernels of the JAX package's
// ops/kernels_vjp.py:701 packed_mlp_bwd (pallas_call at :805):
// impl='stream' (body _make_bwd_kernel_stream(train_epilogue=0)) with K3,
// impl='rebuild' (body _make_bwd_kernel, :268) with K4. Computes what the
// narrow K3 and K4 compute. Design and bound: mlp_wide.cuh, the walk with
// the loaded cotangents (wide::LoadedCotangents, which read dybar with the
// real d_out stride) under its StoreAll policy (K3: every state in the
// device scratch) or its Rebuild policy (K4: every C-th state and the last;
// the backward re-runs each segment of C layers from its checkpoint into
// C - 1 more slots, one more forward for ceil(L/C) + C state slots a block
// instead of L + 1).
//
// Limits (the wrapper checks them first and raises): 1 <= W, d_in, d_out <=
// 128; 0 <= K <= min(3, d_in); tanh (act 0) or LeakyReLU(0.01) (act 1);
// N < 2^31.

#include <cuda_runtime.h>

#include "mlp_wide.cuh"

#ifndef WIDE_REBUILD
#define WIDE_REBUILD 0
#endif

namespace {

using Policy = wide::Policy<WIDE_REBUILD>;

template <class Tier, int ACT, int K>
cudaError_t go(const wide::CotangentArgs& a, size_t smem, int grid, float* out, long long n_ent,
               cudaStream_t s) {
  auto kern = wide::cotangent_kernel<Tier, Policy, ACT, K>;
  return wide::launch(kern, smem, grid, s, a.g.partial, out, n_ent, a, n_ent);
}

template <class Tier, int ACT>
cudaError_t by_k(const wide::CotangentArgs& a, int K, size_t smem, int grid, float* out,
                 long long n_ent, cudaStream_t s) {
  switch (K) {
    case 0: return go<Tier, ACT, 0>(a, smem, grid, out, n_ent, s);
    case 1: return go<Tier, ACT, 1>(a, smem, grid, out, n_ent, s);
    case 2: return go<Tier, ACT, 2>(a, smem, grid, out, n_ent, s);
    default: return go<Tier, ACT, 3>(a, smem, grid, out, n_ent, s);
  }
}

template <class Tier>
int smem(int width, int d_in, int d_out, int n_tangents, int tile) {
  return static_cast<int>(wide::smem_bytes(wide::make_dims(width, d_in, d_out, 0, n_tangents, tile),
                                           3, wide::wt_bytes<Tier>()));
}

template <class Tier>
int run(const float* coords, const float* ybar, const float* dybar, const float* w_in,
        const float* b_in, const float* w_h, const float* b_h, const float* w_out,
        const float* b_out, float* partial, float* states, float* out, int n, int d_in, int d_out,
        int n_stack, int n_tangents, int act, int ckpt_every, int width, int grid, int tile,
        void* stream) {
  const wide::Dims d = wide::make_dims(width, d_in, d_out, n_stack, n_tangents, tile);
  if (!wide::dims_ok(d, n, grid) || (act != 0 && act != 1) || ckpt_every < 1 ||
      (n_tangents > 0 && dybar == nullptr))
    return cudaErrorInvalidValue;
  const wide::CotangentArgs a{{coords, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, n,
                               width, d_in, d_out, n_stack, tile, ckpt_every},
                              ybar, dybar};
  const long long n_ent = wide::Offsets(d).end;
  const size_t bytes = wide::smem_bytes(d, 3, wide::wt_bytes<Tier>());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? by_k<Tier, 0>(a, n_tangents, bytes, grid, out, n_ent, s)
                  : by_k<Tier, 1>(a, n_tangents, bytes, grid, out, n_ent, s);
}

}  // namespace

#if WIDE_REBUILD
#define WIDE_NAME(fn) k4w_##fn
#else
#define WIDE_NAME(fn) k3w_##fn
#endif

#define WIDE_ENTRIES(SUFFIX, TIER)                                                             \
  int WIDE_NAME(smem##SUFFIX)(int width, int d_in, int d_out, int n_tangents, int tile) {      \
    return smem<TIER>(width, d_in, d_out, n_tangents, tile);                                   \
  }                                                                                            \
  int WIDE_NAME(mlp_bwd##SUFFIX)(                                                              \
      const float* coords, const float* ybar, const float* dybar, const float* w_in,           \
      const float* b_in, const float* w_h, const float* b_h, const float* w_out,               \
      const float* b_out, float* partial, float* states, float* out, int n, int d_in,          \
      int d_out, int n_stack, int n_tangents, int act, int ckpt_every, int width, int grid,    \
      int tile, void* stream) {                                                                \
    return run<TIER>(coords, ybar, dybar, w_in, b_in, w_h, b_h, w_out, b_out, partial, states, \
                     out, n, d_in, d_out, n_stack, n_tangents, act, ckpt_every, width, grid,   \
                     tile, stream);                                                            \
  }

extern "C" {

int WIDE_NAME(threads)() { return wide::kThreads; }

// State slots of one block's scratch for n_stack hidden layers and segments
// of ckpt_every layers (ops/wide_plan.py computes the same).
int WIDE_NAME(state_slots)(int n_stack, int ckpt_every) {
  return Policy::slots(n_stack, ckpt_every);
}

const char* WIDE_NAME(error_string)(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Per tier: the shared-memory bytes of a tile of `tile` points, and one
// launch on `grid` blocks of tiles of `tile` points (ops/wide_plan.py) into
// `partial` (grid rows of n_params floats), then the fixed-order reduction
// into `out` (the gradients in sorted-key order). `states` holds grid *
// state_slots * (1 + K) * round4(W) * tile floats; `ckpt_every` is the
// segment length C (K4; K3 takes 1 and ignores it). Returns a cudaError_t;
// nothing synchronises.
#if WITH_TIER(0)
WIDE_ENTRIES(, tier::TierF32)
#endif
#if WITH_TIER(1)
WIDE_ENTRIES(_bf16, tier::TierBf16)
#endif
#if WITH_TIER(2)
WIDE_ENTRIES(_f32x3, tier::TierF32x3)
#endif

}  // extern "C"
