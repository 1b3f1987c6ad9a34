// K1's wide body: the one-kernel training step of the continuity losses for
// the nets the narrow body (continuity_train_step.cu) does not take: hidden
// width 33-128 or d_in above 8 (any W <= 128, at run time; heads (U, V, h)).
// Tiers f32, bf16 and f32x3, one library per tier (-DTIER_ONLY).
//
// Replaces, at those shapes, the TPU kernel of the JAX package's
// ops/kernels_step.py:205 _stats_and_grads (pallas_call at :272), body
// ops/kernels_vjp.py:433 _make_bwd_kernel_stream(train_epilogue=n_true). It
// computes what the narrow K1 computes (the loss statistics [sum fc^2, sum
// anch^2, sum err_j^2] and every parameter gradient; the epilogue's
// formulas are in that file's header). Design: mlp_wide.cuh, the walk under
// its StoreAll policy at K = 2 (three streams); the epilogue below turns the
// tile's [y; y_x; y_y] into the output cotangents in place, one thread per
// point, stages the statistics in the walk's free third buffer and sums them
// over the tile's points in order.
//
// What bounds it on the H100 (PERF.md, section 6): at f32 the FMAs (the
// forward, the cotangent and the weight-gradient products, a third each,
// 29.2 MFLOP a point at 2->[128]x100->3: 5.46 ms for 12,516 points at
// 66.9 TFLOP/s); at bf16 the weight-gradient third on the CUDA cores (1.82
// ms), the rest on the tensor cores; at f32x3 the tensor cores. Per launch
// the plan (ops/wide_plan.py) takes tiles of 32 points at W = 128 (the
// three 3-stream buffers fill the shared memory beside two weight slots)
// and 48 at W = 64, so that the 12,516 points take 3 and 2 nearly full
// rounds of the 132 SMs (392 and 261 tiles).
//
// Limits (the wrapper checks them first and raises): 1 <= W, d_in <= 128,
// d_in >= 2; d_out = 3; 1 <= n_true <= 3, n_true <= 2 with the anchor; tanh
// (act 0) or LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#include "mlp_wide.cuh"

namespace {

constexpr int kOut = 3;    // heads (U, V, h)
constexpr int kStats = 8;  // fc^2, anch^2, err_0..2^2, 3 unused
constexpr int kK = 2;      // tangents (x, y)

struct ContinuityEpilogue {
  const float *trues, *sel, *mask, *scal;
  int n_true, has_anchor;

  // `extra`: a free buffer, rows of ld floats (the statistics of each point)
  __device__ void output(float* __restrict__ Y, long long p_base, int nv, const wide::Dims& d,
                         float* __restrict__ extra, float* __restrict__ stats, bool first) const {
    const float res_scale = scal[0], anchor_scale = scal[1], depth = scal[2];
    const int ld = d.ld, sstr = d.sstr();
    for (int p = threadIdx.x; p < d.P; p += blockDim.x) {
      const bool active = p < nv;
      const long long q = p_base + p;
      const float U = Y[p], V = Y[ld + p], h = Y[2 * ld + p];
      const float Ux = Y[sstr + p], hx = Y[sstr + 2 * ld + p];
      const float Vy = Y[2 * sstr + ld + p], hy = Y[2 * sstr + 2 * ld + p];
      const float y[3] = {U, V, h};
      const float m = active ? mask[q] : 0.f;
      const float s = active ? sel[q] : 0.f;
      const float fc = (hx * U + h * Ux + hy * V + h * Vy) * m;
      const float anch = has_anchor ? s * (h - depth) : 0.f;
      float err[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < n_true; ++j) err[j] = active ? m * (y[j] - trues[q * n_true + j]) : 0.f;
      const float fbar = res_scale * fc;
      float yb[3] = {fbar * hx, fbar * hy, anchor_scale * anch + fbar * (Ux + Vy)};
      for (int j = 0; j < n_true; ++j) yb[j] += scal[3 + j] * err[j];
      // rows [0, Op): the padded heads' rows stay zero
      Y[p] = yb[0];
      Y[ld + p] = yb[1];
      Y[2 * ld + p] = yb[2];
      Y[sstr + p] = fbar * h;
      Y[sstr + ld + p] = 0.f;
      Y[sstr + 2 * ld + p] = fbar * U;
      Y[2 * sstr + p] = 0.f;
      Y[2 * sstr + ld + p] = fbar * h;
      Y[2 * sstr + 2 * ld + p] = fbar * V;
      for (int o = kOut; o < d.Op; ++o)
        for (int s = 0; s <= kK; ++s) Y[s * sstr + o * ld + p] = 0.f;
      extra[p] = fc * fc;
      extra[ld + p] = anch * anch;
      for (int j = 0; j < 3; ++j) extra[(2 + j) * ld + p] = err[j] * err[j];
    }
    __syncthreads();
    for (int s = threadIdx.x; s < kStats; s += blockDim.x) {
      float acc = 0.f;
      if (s < 5)
        for (int p = 0; p < d.P; ++p) acc += extra[s * ld + p];
      if (s < 5) {
        wide::accumulate(stats + s, acc, first);
      } else {
        stats[s] = 0.f;
      }
    }
  }
};

struct Args {
  wide::Args g;
  ContinuityEpilogue epi;
};

template <class Tier, int ACT>
__global__ void __launch_bounds__(wide::kThreads, 1) k1w_kernel(const Args a, long long n_ent) {
  extern __shared__ __align__(16) unsigned char smem[];
  ContinuityEpilogue epi = a.epi;
  wide::walk<Tier, wide::StoreAll, ACT, kK>(a.g, epi, smem, n_ent);
}

template <class Tier>
int smem(int width, int d_in, int tile) {
  return static_cast<int>(
      wide::smem_bytes<Tier>(wide::make_dims(width, d_in, kOut, 0, kK, tile), 3));
}

template <class Tier>
int image_bytes(int width, int d_in, int n_stack) {
  return static_cast<int>(
      wide::image_bytes<Tier>(wide::make_dims(width, d_in, kOut, n_stack, kK, 16), true));
}

template <class Tier>
int run(const float* coords, const float* trues, const float* sel, const float* mask,
        const float* scal, const float* w_in, const float* b_in, const float* w_h,
        const float* b_h, const float* w_out, const float* b_out, unsigned char* image,
        float* partial, float* states, float* out, int n, int d_in, int n_stack, int n_true,
        int has_anchor, int act, int width, int grid, int tile, void* stream) {
  const wide::Dims d = wide::make_dims(width, d_in, kOut, n_stack, kK, tile);
  if (!wide::dims_ok(d, n, grid) || d_in < 2 || n_true < 1 || n_true > 3 ||
      (has_anchor && n_true > 2) || (act != 0 && act != 1))
    return cudaErrorInvalidValue;
  const Args a{{coords, w_in, b_in, w_h, b_h, w_out, b_out, image, partial, states, n, width,
                d_in, kOut, n_stack, tile, 1},
               {trues, sel, mask, scal, n_true, has_anchor}};
  const long long n_ent = wide::Offsets(d).end + kStats;
  const size_t bytes = wide::smem_bytes<Tier>(d, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == 0) {
    auto kern = k1w_kernel<Tier, 0>;
    return wide::launch<Tier>(kern, a.g, d, bytes, grid, s, partial, out, n_ent, a, n_ent);
  }
  auto kern = k1w_kernel<Tier, 1>;
  return wide::launch<Tier>(kern, a.g, d, bytes, grid, s, partial, out, n_ent, a, n_ent);
}

}  // namespace

#define K1W_ENTRIES(SUFFIX, TIER)                                                               \
  int k1w_smem##SUFFIX(int width, int d_in, int tile) { return smem<TIER>(width, d_in, tile); } \
  int k1w_image_bytes##SUFFIX(int width, int d_in, int n_stack) {                               \
    return image_bytes<TIER>(width, d_in, n_stack);                                             \
  }                                                                                             \
  int k1w_train_step##SUFFIX(const float* coords, const float* trues, const float* sel,         \
                             const float* mask, const float* scal, const float* w_in,           \
                             const float* b_in, const float* w_h, const float* b_h,             \
                             const float* w_out, const float* b_out, unsigned char* image,      \
                             float* partial, float* states, float* out, int n, int d_in,        \
                             int n_stack, int n_true, int has_anchor, int act, int width,       \
                             int grid, int tile, void* stream) {                                \
    return run<TIER>(coords, trues, sel, mask, scal, w_in, b_in, w_h, b_h, w_out, b_out, image, \
                     partial, states, out, n, d_in, n_stack, n_true, has_anchor, act, width,    \
                     grid, tile, stream);                                                       \
  }

extern "C" {

int k1w_threads() { return wide::kThreads; }

const char* k1w_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Per tier: the shared-memory bytes of a tile of `tile` points, the bytes of
// the weight images, and one training-step evaluation: the images into
// `image`, the walk on `grid` blocks of tiles of `tile` points
// (ops/wide_plan.py) into `partial` (grid rows of n_params + 8 floats), then
// the fixed-order reduction into `out` (the gradients in sorted-key order,
// then the statistics). `states` holds grid * (n_stack + 1) * 3 * round16(W)
// * tile floats. Returns a cudaError_t; nothing synchronises.
#if WITH_TIER(0)
K1W_ENTRIES(, tier::TierF32)
#endif
#if WITH_TIER(1)
K1W_ENTRIES(_bf16, tier::TierBf16)
#endif
#if WITH_TIER(2)
K1W_ENTRIES(_f32x3, tier::TierF32x3)
#endif

}  // extern "C"
