// K2 for Hopper: fused MLP forward + K coordinate tangents, tiers f32, bf16
// and f32x3.
//
// Replaces the TPU kernel ops/kernels.py::_mlp_kernel of the JAX package
// (launched by packed_mlp_fwd_tangents_raw). Computes exactly what
// models/mlp.py::mlp_apply_with_tangents computes, for the coordinate-basis
// tangents e_0 .. e_{K-1}, in three modes:
//   K = 0          y (N, d_out) only (the Predictor's full-grid forward);
//   K = 1 .. 3     y and dy (K, N, d_out);
//   K = 2 + EPI    only fc (N,) = (h_x*U + h*U_x) + (h_y*V + h*V_y), the
//                  continuity residual at heads (U, V, h) = (0, 1, 2) and
//                  tangents (x, y) = (0, 1).
// At the bf16 tier (tier.cuh, ops/tiers.py) the weights are rounded to bf16
// as they are staged, the tangent seeds are rows of the rounded w_in, and
// every runtime operand (the coordinates, the activation, each scaled
// tangent stream, the last state) is rounded to bf16 before its product. At
// the f32x3 tier the weights are staged as bf16 (hi, lo) pairs, the seeds
// are rows of hi + lo, and the same operands are split into (hi, lo) and
// meet each weight in three FMAs summed as (cross) + main (tier.cuh).
//
// Design: one thread per point. The primal (W floats) and the K tangent
// streams (K*W floats) stay in registers through every layer, so the width
// W is a compile-time constant: this file is compiled once per supported
// width with -DK2_WIDTH=W. The hidden weights sit in dynamic shared memory
// (f32 or bf16 by tier); every thread of a warp reads the same weight at the
// same time (a broadcast), as a vector along a row where W allows. When the
// whole stack does not fit, it is staged in chunks of whole layers with
// __syncthreads around each chunk (one chunk for the 2->[20]x100->3
// flagship: 99*(20*20*4+20*4) = 166,320 B at f32, 87,120 B at bf16, of the
// 232,448 B a block may opt into). Threads past N compute on zeros and store
// nothing, so every thread reaches every barrier.
//
// Bound on the H100: per point the kernel does 2*(d_in*W + (L-1)*W^2 +
// W*d_out)*(1+K) FLOPs (about 238,000 for the flagship at K=2) plus L*W
// tanhf, and moves about 12 B of device memory (8 B in, 4 B out with the
// epilogue). It is bound by the CUDA cores' f32 FMA rate, never by memory:
// the design keeps every intermediate in registers and feeds the FMAs from
// broadcast shared-memory reads, one load per weight shared by the 1+K
// streams. The bf16 tier runs the same FMAs plus the conversions; the
// f32x3 tier three FMAs per product plus the splits, with twice the
// accumulator registers (z and zt hold (cross, main) pairs; ptxas reports
// the spills into build.log); tensor cores are later work.
//
// Limits (the wrapper checks them first and raises): W in the compiled
// widths; 1 <= d_in <= 8; 1 <= d_out <= 8; 0 <= K <= min(3, d_in); N < 2^31.
// tanh (act 0) and LeakyReLU(0.01) (act 1).

#include <cuda_runtime.h>

#include "tier.cuh"

#ifndef K2_WIDTH
#error "compile with -DK2_WIDTH=<hidden width>"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIn = 8;
constexpr int kMaxOut = 8;
constexpr int kMaxTangents = 3;

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if constexpr (ACT == 0) {
    return tanhf(z);
  } else {
    return z >= 0.f ? z : 0.01f * z;
  }
}

// Derivative from the pre-activation z and the activation a.
template <int ACT>
__device__ __forceinline__ float act_deriv(float z, float a) {
  if constexpr (ACT == 0) {
    return 1.f - a * a;
  } else {
    return z >= 0.f ? 1.f : 0.01f;
  }
}

using tier::load_vec;
using tier::row_vec;
using tier::w_f;
using tier::w_ld;

// a <- act(a @ w + b); t[k] <- (t[k] @ w) * act'(.), for one hidden layer
// whose (W, W) weights (row-major, (in, out)) and (W,) bias are in shared
// memory; a and t[k] prepared at the tier before the products.
template <class Tier, int W, int ACT, int K>
__device__ __forceinline__ void hidden_layer(const typename Tier::WT* __restrict__ w,
                                             const float* __restrict__ b,
                                             float (&a)[W],
                                             float (&t)[K > 0 ? K : 1][W]) {
  using Acc = typename Tier::Acc;
  using Op = typename Tier::Op;
  using WV = typename Tier::WV;
  constexpr int V = row_vec<W>();
  Acc z[W];
  Acc zt[K > 0 ? K : 1][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    z[j] = Tier::acc(b[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) zt[k][j] = Tier::acc(0.f);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const Op ai = Tier::op(a[i]);
    Op ti[K > 0 ? K : 1];
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
    const float zj = Tier::fin(z[j]);
    const float na = act_fn<ACT>(zj);
    const float d = act_deriv<ACT>(zj, na);
    a[j] = na;
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][j] = Tier::fin(zt[k][j]) * d;
  }
}

// The dynamic shared memory of one block: the f32 biases first, then the
// weights at the tier's type, each region 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int W, int chunk, size_t wt) {
  using tier::align16;
  return align16(chunk * W * 4) + align16(W * 4) + align16(kMaxOut * 4) +
         align16(chunk * W * W * wt) + align16(kMaxIn * W * wt) + align16(W * kMaxOut * wt);
}

template <class Tier, int W, int ACT, int K, bool EPI>
__global__ void __launch_bounds__(kThreads)
k2_mlp_fwd_tangents_kernel(const float* __restrict__ x,      // (n, d_in)
                           const float* __restrict__ w_in,   // (d_in, W)
                           const float* __restrict__ b_in,   // (W,)
                           const float* __restrict__ w_h,    // (n_stack, W, W)
                           const float* __restrict__ b_h,    // (n_stack, W)
                           const float* __restrict__ w_out,  // (W, d_out)
                           const float* __restrict__ b_out,  // (d_out,)
                           float* __restrict__ y,            // (n, d_out)
                           float* __restrict__ dy,           // (K, n, d_out)
                           float* __restrict__ fc,           // (n,)
                           int n, int d_in, int d_out, int n_stack, int chunk) {
  using WT = typename Tier::WT;
  using tier::align16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* cur = smem;
  auto carve = [&](size_t bytes) { unsigned char* p = cur; cur += align16(bytes); return p; };
  float* s_bh = reinterpret_cast<float*>(carve(chunk * W * 4));          // chunk * W
  float* s_bin = reinterpret_cast<float*>(carve(W * 4));                 // W
  float* s_bout = reinterpret_cast<float*>(carve(kMaxOut * 4));          // kMaxOut
  WT* s_wh = reinterpret_cast<WT*>(carve(chunk * W * W * sizeof(WT)));   // chunk * W * W
  WT* s_win = reinterpret_cast<WT*>(carve(kMaxIn * W * sizeof(WT)));     // kMaxIn * W
  WT* s_wout = reinterpret_cast<WT*>(carve(W * kMaxOut * sizeof(WT)));   // W * kMaxOut

  const int tid = threadIdx.x;
  tier::stage_weights<Tier>(s_win, w_in, d_in * W);
  for (int i = tid; i < W; i += kThreads) s_bin[i] = b_in[i];
  tier::stage_weights<Tier>(s_wout, w_out, W * d_out);
  for (int i = tid; i < d_out; i += kThreads) s_bout[i] = b_out[i];

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool active = p < n;
  float xin[kMaxIn];
#pragma unroll
  for (int c = 0; c < kMaxIn; ++c) xin[c] = (active && c < d_in) ? x[p * d_in + c] : 0.f;
  __syncthreads();

  // Input layer. The tangent seed of coordinate k is row k of (the tier's)
  // w_in times act' (models/mlp.py: (e_k @ w_in) * act'(z)).
  using Acc = typename Tier::Acc;
  using Op = typename Tier::Op;
  Op xo[kMaxIn];
#pragma unroll
  for (int c = 0; c < kMaxIn; ++c) xo[c] = Tier::op(xin[c]);
  float a[W];
  float t[K > 0 ? K : 1][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    Acc za = Tier::acc(s_bin[j]);
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) {
      if (c < d_in) Tier::mac(za, xo[c], w_ld(s_win[c * W + j]));
    }
    const float z = Tier::fin(za);
    a[j] = act_fn<ACT>(z);
    const float d = act_deriv<ACT>(z, a[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][j] = w_f(s_win[k * W + j]) * d;
  }

  // Hidden stack, staged chunk by chunk of whole layers.
  for (int l0 = 0; l0 < n_stack; l0 += chunk) {
    const int nl = min(chunk, n_stack - l0);
    __syncthreads();  // the previous chunk is no longer read
    const float* src_w = w_h + static_cast<size_t>(l0) * W * W;
    const float* src_b = b_h + static_cast<size_t>(l0) * W;
    tier::stage_weights<Tier>(s_wh, src_w, nl * W * W);
    for (int i = tid; i < nl * W; i += kThreads) s_bh[i] = src_b[i];
    __syncthreads();
#pragma unroll 1
    for (int l = 0; l < nl; ++l) {
      hidden_layer<Tier, W, ACT, K>(s_wh + l * W * W, s_bh + l * W, a, t);
    }
  }

  // Output layer.
  Acc yacc[kMaxOut];
  Acc dyacc[K > 0 ? K : 1][kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    yacc[o] = Tier::acc(o < d_out ? s_bout[o] : 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) dyacc[k][o] = Tier::acc(0.f);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const Op aj = Tier::op(a[j]);
    Op tj[K > 0 ? K : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) tj[k] = Tier::op(t[k][j]);
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < d_out) {
        const typename Tier::WV wv = w_ld(s_wout[j * d_out + o]);
        Tier::mac(yacc[o], aj, wv);
#pragma unroll
        for (int k = 0; k < K; ++k) Tier::mac(dyacc[k][o], tj[k], wv);
      }
    }
  }
  if (!active) return;
  float yo[kMaxOut];
  float dyo[K > 0 ? K : 1][kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    yo[o] = Tier::fin(yacc[o]);
#pragma unroll
    for (int k = 0; k < K; ++k) dyo[k][o] = Tier::fin(dyacc[k][o]);
  }

  if constexpr (EPI) {
    const float U = yo[0], V = yo[1], h = yo[2];
    fc[p] = (dyo[0][2] * U + h * dyo[0][0]) + (dyo[1][2] * V + h * dyo[1][1]);
  } else {
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < d_out) y[p * d_out + o] = yo[o];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < d_out) dy[(static_cast<long long>(k) * n + p) * d_out + o] = dyo[k][o];
      }
    }
  }
}

struct Args {
  const float *x, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *y, *dy, *fc;
  int n, d_in, d_out, n_stack;
};

template <class Tier, int ACT, int K, bool EPI>
cudaError_t launch(const Args& a, int chunk, size_t smem, cudaStream_t stream) {
  auto kernel = k2_mlp_fwd_tangents_kernel<Tier, K2_WIDTH, ACT, K, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(a.x, a.w_in, a.b_in, a.w_h, a.b_h, a.w_out,
                                             a.b_out, a.y, a.dy, a.fc, a.n, a.d_in,
                                             a.d_out, a.n_stack, chunk);
  return cudaGetLastError();
}

template <class Tier, int ACT>
cudaError_t dispatch_mode(const Args& a, int n_tangents, int epilogue, int chunk,
                          size_t smem, cudaStream_t stream) {
  if (epilogue) return launch<Tier, ACT, 2, true>(a, chunk, smem, stream);
  switch (n_tangents) {
    case 0: return launch<Tier, ACT, 0, false>(a, chunk, smem, stream);
    case 1: return launch<Tier, ACT, 1, false>(a, chunk, smem, stream);
    case 2: return launch<Tier, ACT, 2, false>(a, chunk, smem, stream);
    case 3: return launch<Tier, ACT, 3, false>(a, chunk, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Hidden layers one shared-memory chunk holds on the current device at
// weight size wt (0 when not even one fits).
int chunk_layers(int n_stack, size_t wt) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  constexpr int W = K2_WIDTH;
  int fit = 0;
  while (fit < n_stack && smem_bytes(W, fit + 1, wt) <= static_cast<size_t>(max_smem)) ++fit;
  return fit;
}

template <class Tier>
int run(const float* x, const float* w_in, const float* b_in, const float* w_h,
        const float* b_h, const float* w_out, const float* b_out, float* y, float* dy,
        float* fc, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
        int epilogue, void* stream) {
  if (n <= 0 || d_in < 1 || d_in > kMaxIn || d_out < 1 || d_out > kMaxOut ||
      n_tangents < 0 || n_tangents > kMaxTangents || n_tangents > d_in || n_stack < 0 ||
      (act != 0 && act != 1) || (epilogue && (n_tangents != 2 || d_out != 3)))
    return cudaErrorInvalidValue;
  constexpr int W = K2_WIDTH;
  const size_t wt = sizeof(typename Tier::WT);
  int chunk = 0;
  if (n_stack > 0) {
    chunk = chunk_layers(n_stack, wt);
    if (chunk < 1) return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(W, chunk, wt);
  const Args a{x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out, n_stack};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? dispatch_mode<Tier, 0>(a, n_tangents, epilogue, chunk, smem, s)
                  : dispatch_mode<Tier, 1>(a, n_tangents, epilogue, chunk, smem, s);
}

}  // namespace

extern "C" {

int k2_width() { return K2_WIDTH; }

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of hidden layers one shared-memory chunk holds on the current
// device (0 when not even one fits), per tier.
#if WITH_TIER(0)
int k2_chunk_layers(int n_stack) { return chunk_layers(n_stack, sizeof(float)); }
#endif

#if WITH_TIER(1)
int k2_chunk_layers_bf16(int n_stack) { return chunk_layers(n_stack, sizeof(__nv_bfloat16)); }
#endif

#if WITH_TIER(2)
int k2_chunk_layers_f32x3(int n_stack) {
  return chunk_layers(n_stack, sizeof(tier::TierF32x3::WT));
}
#endif

// One launch at the f32 tier, or (k2_mlp_fwd_tangents_bf16,
// k2_mlp_fwd_tangents_f32x3) at the bf16 or f32x3 tier, with the same
// arguments. Returns a cudaError_t: 0 on success; the launch does not
// synchronise.
#if WITH_TIER(0)
int k2_mlp_fwd_tangents(const float* x, const float* w_in, const float* b_in,
                        const float* w_h, const float* b_h, const float* w_out,
                        const float* b_out, float* y, float* dy, float* fc, int n, int d_in,
                        int d_out, int n_stack, int n_tangents, int act, int epilogue,
                        void* stream) {
  return run<tier::TierF32>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out,
                            n_stack, n_tangents, act, epilogue, stream);
}
#endif

#if WITH_TIER(1)
int k2_mlp_fwd_tangents_bf16(const float* x, const float* w_in, const float* b_in,
                             const float* w_h, const float* b_h, const float* w_out,
                             const float* b_out, float* y, float* dy, float* fc, int n,
                             int d_in, int d_out, int n_stack, int n_tangents, int act,
                             int epilogue, void* stream) {
  return run<tier::TierBf16>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out,
                             n_stack, n_tangents, act, epilogue, stream);
}
#endif

#if WITH_TIER(2)
int k2_mlp_fwd_tangents_f32x3(const float* x, const float* w_in, const float* b_in,
                              const float* w_h, const float* b_h, const float* w_out,
                              const float* b_out, float* y, float* dy, float* fc, int n,
                              int d_in, int d_out, int n_stack, int n_tangents, int act,
                              int epilogue, void* stream) {
  return run<tier::TierF32x3>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out,
                              n_stack, n_tangents, act, epilogue, stream);
}
#endif

}  // extern "C"
