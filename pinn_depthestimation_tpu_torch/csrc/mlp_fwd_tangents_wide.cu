// K2's wide body: the fused MLP forward + K coordinate tangents for the nets
// the narrow body (mlp_fwd_tangents.cu) does not take: hidden width 33-128,
// or d_in or d_out above 8 (any W <= 128, at run time). Tiers f32, bf16 and
// f32x3, one library per tier (-DTIER_ONLY).
//
// Replaces, at those shapes, the TPU kernel ops/kernels.py::_mlp_kernel of
// the JAX package (launched by packed_mlp_fwd_tangents_raw), which takes any
// max(W, d_in, d_out) <= 128. Computes what the narrow body computes, in the
// same three modes (K = 0; K = 1 .. 3; K = 2 with the continuity epilogue
// fc). Design and bound: mlp_wide.cuh (two stream buffers; no state
// scratch). The launch plan (tile, grid, shared memory) is
// ops/wide_plan.py's; k2w_smem gives the bytes this library computes for a
// plan, which a card test holds to the plan's.
//
// Limits (the wrapper checks them first and raises): 1 <= W, d_in, d_out <=
// 128; 0 <= K <= min(3, d_in); the epilogue needs K = 2, d_in >= 2 and
// d_out >= 3; tanh (act 0) or LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#include "mlp_wide.cuh"

namespace {

template <class Tier, int ACT, int K, bool EPI>
cudaError_t go(const wide::FwdArgs& a, size_t smem, int grid, cudaStream_t s) {
  auto kern = wide::fwd_kernel<Tier, ACT, K, EPI>;
  return wide::launch(kern, smem, grid, s, nullptr, nullptr, 0, a);
}

template <class Tier, int ACT>
cudaError_t by_k(const wide::FwdArgs& a, int K, int epi, size_t smem, int grid, cudaStream_t s) {
  if (epi) return go<Tier, ACT, 2, true>(a, smem, grid, s);
  switch (K) {
    case 0: return go<Tier, ACT, 0, false>(a, smem, grid, s);
    case 1: return go<Tier, ACT, 1, false>(a, smem, grid, s);
    case 2: return go<Tier, ACT, 2, false>(a, smem, grid, s);
    default: return go<Tier, ACT, 3, false>(a, smem, grid, s);
  }
}

template <class Tier>
int smem(int width, int d_in, int d_out, int n_tangents, int tile) {
  return static_cast<int>(wide::smem_bytes(wide::make_dims(width, d_in, d_out, 0, n_tangents, tile),
                                           2, wide::wt_bytes<Tier>()));
}

template <class Tier>
int run(const float* x, const float* w_in, const float* b_in, const float* w_h, const float* b_h,
        const float* w_out, const float* b_out, float* y, float* dy, float* fc, int n, int d_in,
        int d_out, int n_stack, int n_tangents, int act, int epilogue, int width, int grid,
        int tile, void* stream) {
  const wide::Dims d = wide::make_dims(width, d_in, d_out, n_stack, n_tangents, tile);
  if (!wide::dims_ok(d, n, grid) || (act != 0 && act != 1) ||
      (epilogue && (n_tangents != 2 || d_in < 2 || d_out < 3 || fc == nullptr)) ||
      (!epilogue && (y == nullptr || (n_tangents > 0 && dy == nullptr))))
    return cudaErrorInvalidValue;
  const wide::FwdArgs a{{x, w_in, b_in, w_h, b_h, w_out, b_out, nullptr, nullptr, n, width, d_in,
                         d_out, n_stack, tile, 1},
                        y, dy, fc};
  const size_t bytes = wide::smem_bytes(d, 2, wide::wt_bytes<Tier>());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? by_k<Tier, 0>(a, n_tangents, epilogue, bytes, grid, s)
                  : by_k<Tier, 1>(a, n_tangents, epilogue, bytes, grid, s);
}

}  // namespace

#define K2W_ENTRIES(SUFFIX, TIER)                                                               \
  int k2w_smem##SUFFIX(int width, int d_in, int d_out, int n_tangents, int tile) {              \
    return smem<TIER>(width, d_in, d_out, n_tangents, tile);                                    \
  }                                                                                             \
  int k2w_mlp_fwd_tangents##SUFFIX(const float* x, const float* w_in, const float* b_in,        \
                                   const float* w_h, const float* b_h, const float* w_out,      \
                                   const float* b_out, float* y, float* dy, float* fc, int n,   \
                                   int d_in, int d_out, int n_stack, int n_tangents, int act,   \
                                   int epilogue, int width, int grid, int tile, void* stream) { \
    return run<TIER>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out,          \
                     n_stack, n_tangents, act, epilogue, width, grid, tile, stream);            \
  }

extern "C" {

int k2w_threads() { return wide::kThreads; }

const char* k2w_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Per tier: the shared-memory bytes of a tile of `tile` points, and one
// launch on `grid` blocks of tiles of `tile` points (ops/wide_plan.py).
// Returns a cudaError_t; nothing synchronises.
#if WITH_TIER(0)
K2W_ENTRIES(, tier::TierF32)
#endif
#if WITH_TIER(1)
K2W_ENTRIES(_bf16, tier::TierBf16)
#endif
#if WITH_TIER(2)
K2W_ENTRIES(_f32x3, tier::TierF32x3)
#endif

}  // extern "C"
