// The hand-written MLP backward shared by K1 and K3, f32.
//
// For every point p, with the coordinate tangent seeds e_0 .. e_{K-1}, the
// walk
//   1. replays the forward with K tangent streams (as K2 does) and keeps
//      every layer state (a, u^0 .. u^{K-1}; u^k the tangent before the
//      act' scale) in a per-block scratch in device memory;
//   2. asks its epilogue for the output cotangents ybar (d_out) and
//      ybar^k (K x d_out): K1 computes them from the continuity losses
//      (continuity_train_step.cu), K3 loads them (mlp_bwd.cu);
//   3. walks back through the output layer, the hidden stack and the input
//      layer, whose tangent streams start as rows k of w_in, so dw_in[k, :]
//      also collects sum_p ubar_0^k (the tangent-seed term).
// Outputs: every parameter gradient summed over points, in the flat order
// of the parameters' sorted keys (b_hidden, b_in, b_out, w_hidden, w_in,
// w_out), then the epilogue's own sums (kExtra floats).
//
// Design. One thread per point, 128 points per tile. The primal and the K
// tangent streams stay in registers (W is a compile-time constant: one
// library per width); the hidden weights sit in shared memory (one chunk of
// whole layers when the stack does not fit). States are laid out
// [state][component][thread], so neighbouring threads touch neighbouring
// addresses. Per layer, each thread stages s_prev = [a; t^0..t^{K-1}] and
// [zbar; ubar^0..ubar^{K-1}] ((1+K)W floats each) in shared memory, and the
// block forms that layer's W x W weight gradient as a product over its 128
// points (2 x 2 register tiles; rows padded to 129 floats so no two lanes
// of a warp hit one bank). Gradients are sums over every point, and Hopper
// runs blocks in no order: each block of a fixed-size grid walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its own partial sums in
// a scratch row (written by one fixed thread per entry, in tile order); a
// second kernel sums the rows in block order. No atomics: the result is the
// same bit for bit from run to run.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// of forward replay and 2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W of
// backward, plus L*W tanhf, against a few bytes of inputs and the weights:
// the CUDA cores' f32 FMA rate bounds it. What the design spends beyond
// that: the layer states go to device memory and back, and the per-layer
// block product reads shared memory once per two FMAs. Tensor cores and
// segment recomputation are left for later work (ROADMAP.md).

#pragma once

#include <cuda_runtime.h>

namespace mlp_bwd {

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

template <int W>
__host__ __device__ constexpr int row_vec() {
  return (W % 4 == 0) ? 4 : ((W % 2 == 0) ? 2 : 1);
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else if constexpr (V == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    v[0] = r.x; v[1] = r.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ float accumulate(float* dst, float v, bool first) {
  return first ? v : *dst + v;
}

// One hidden layer forward: z = a @ w + b, z^k = t^k @ w; a <- act(z),
// t^k <- z^k * act'; the state (a, z^0..z^{K-1}) goes to st[c * kThreads].
template <int W, int ACT, int K>
__device__ __forceinline__ void hidden_fwd(const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           float (&a)[W], float (&t)[tdim(K)][W],
                                           float* __restrict__ st) {
  constexpr int V = row_vec<W>();
  float z[W], zt[tdim(K)][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    z[j] = b[j];
#pragma unroll
    for (int k = 0; k < K; ++k) zt[k][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; j += V) {
      float wv[V];
      load_vec<V>(w + i * W + j, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        z[j + v] = fmaf(a[i], wv[v], z[j + v]);
#pragma unroll
        for (int k = 0; k < K; ++k) zt[k][j + v] = fmaf(t[k][i], wv[v], zt[k][j + v]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float na = act_fn<ACT>(z[j]);
    const float d = dact<ACT>(na);
    st[j * kThreads] = na;
#pragma unroll
    for (int k = 0; k < K; ++k) st[((1 + k) * W + j) * kThreads] = zt[k][j];
    a[j] = na;
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][j] = zt[k][j] * d;
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
// (W even). One fixed thread owns each entry.
template <int W, int S>
__device__ __forceinline__ void accum_square(const float* __restrict__ sA,
                                             const float* __restrict__ sB,
                                             float* __restrict__ dw,
                                             float* __restrict__ db, bool first) {
  static_assert(W % 2 == 0, "2 x 2 tiles need an even width");
  constexpr int H = W / 2;
  for (int tile = threadIdx.x; tile < H * H; tile += kThreads) {
    const int i0 = 2 * (tile / H), j0 = 2 * (tile % H);
    float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
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

// The same product for the input and output layers (rows_a x rows_b).
template <int S>
__device__ __forceinline__ void accum_rect(const float* __restrict__ sA, int rows_a,
                                           const float* __restrict__ sB, int rows_b,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           bool first) {
  for (int e = threadIdx.x; e < rows_a * rows_b; e += kThreads) {
    const int i = e / rows_b, j = e % rows_b;
    float acc = 0.f;
    for (int c = 0; c < S; ++c) {
      const float* a0 = sA + (c * rows_a + i) * kLd;
      const float* b0 = sB + (c * rows_b + j) * kLd;
      for (int p = 0; p < kThreads; ++p) acc = fmaf(a0[p], b0[p], acc);
    }
    dw[e] = accumulate(dw + e, acc, first);
  }
  for (int j = threadIdx.x; j < rows_b; j += kThreads) {
    float s = 0.f;
    for (int p = 0; p < kThreads; ++p) s += sB[j * kLd + p];
    db[j] = accumulate(db + j, s, first);
  }
}

// The pointers and sizes every walk takes.
struct WalkArgs {
  const float *coords, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *partial, *states;
  int n, d_in, d_out, n_stack, chunk;
};

// Floats of one block's partial-sum row: every gradient, then kExtra.
__host__ __device__ inline long long n_params(int W, int d_in, int d_out, int n_stack) {
  return static_cast<long long>(n_stack) * W * (W + 1) + W + d_out + d_in * W + W * d_out;
}

// Dynamic shared memory of a walk: a chunk of hidden layers, the input and
// output layers, and the two staging blocks of S*W rows.
__host__ __device__ inline size_t smem_bytes(int W, int S, int max_out, int chunk) {
  return (static_cast<size_t>(chunk) * (W * W + W) + kMaxIn * W + W + W * max_out + max_out +
          2 * S * W * kLd) *
         sizeof(float);
}

// Hidden layers one shared-memory chunk holds on the current device (0 when
// not even one fits beside the staging rows).
inline int chunk_layers(int W, int S, int max_out, int n_stack) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  const long long per_layer = (W * W + W) * 4LL;
  const long long fit =
      (max_smem - static_cast<long long>(smem_bytes(W, S, max_out, 0))) / per_layer;
  return static_cast<int>(fit < n_stack ? fit : n_stack);
}

// The walk over this block's tiles. Epi supplies the output cotangents:
//   kMaxOut, kExtra (constants): most heads, floats of its own sums;
//   output(p, active, a, t, s_wout, s_bout, d_out, yb, ybt): ybar and
//     ybar^k of point p from the last state (a, t^k);
//   stage(sB): its per-point values into staging rows >= (1+K)*d_out;
//   reduce(s_B, g_extra, first): its sums over the block's points.
template <int W, int ACT, int K, class Epi>
__device__ __forceinline__ void walk(const WalkArgs& args, Epi& epi, float* smem) {
  constexpr int S = 1 + K;
  constexpr int kOut = Epi::kMaxOut;
  const int n_stack = args.n_stack, d_in = args.d_in, d_out = args.d_out, chunk = args.chunk;
  float* s_wh = smem;                           // chunk * W * W
  float* s_bh = s_wh + chunk * W * W;           // chunk * W
  float* s_win = s_bh + chunk * W;              // kMaxIn * W
  float* s_bin = s_win + kMaxIn * W;            // W
  float* s_wout = s_bin + W;                    // W * kOut
  float* s_bout = s_wout + W * kOut;            // kOut
  float* s_A = s_bout + kOut;                   // S*W rows of kLd
  float* s_B = s_A + S * W * kLd;               // S*W rows of kLd

  const int tid = threadIdx.x;
  for (int i = tid; i < d_in * W; i += kThreads) s_win[i] = args.w_in[i];
  for (int i = tid; i < W; i += kThreads) s_bin[i] = args.b_in[i];
  for (int i = tid; i < W * d_out; i += kThreads) s_wout[i] = args.w_out[i];
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

  // This thread's layer states: state s, component c at st0[(s*S*W + c) * kThreads].
  float* st0 = args.states + static_cast<size_t>(blockIdx.x) * (n_stack + 1) * S * W * kThreads + tid;
  auto state = [&](int s) { return st0 + static_cast<size_t>(s) * S * W * kThreads; };

  const int n_chunks = chunk > 0 ? (n_stack + chunk - 1) / chunk : 0;
  int loaded = -1;  // the chunk of hidden layers now in shared memory
  auto load_chunk = [&](int c) {
    if (c == loaded) return;
    __syncthreads();  // nobody reads the previous chunk any more
    const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
    const float* src_w = args.w_h + static_cast<size_t>(l0) * W * W;
    const float* src_b = args.b_h + static_cast<size_t>(l0) * W;
    for (int i = tid; i < nl * W * W; i += kThreads) s_wh[i] = src_w[i];
    for (int i = tid; i < nl * W; i += kThreads) s_bh[i] = src_b[i];
    __syncthreads();
    loaded = c;
  };

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
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float z = s_bin[j];
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) {
          if (c < d_in) z = fmaf(x[c], s_win[c * W + j], z);
        }
        a[j] = act_fn<ACT>(z);
        const float d = dact<ACT>(a[j]);
        st[j * kThreads] = a[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float u = s_win[k * W + j];
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
        hidden_fwd<W, ACT, K>(s_wh + l * W * W, s_bh + l * W, a, t, state(l0 + l + 1));
      }
    }

    // ---- the output cotangents
    float yb[kOut], ybt[tdim(K)][kOut];
    epi.template output<W, K>(p, active, a, t, s_wout, s_bout, d_out, yb, ybt);

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
    accum_rect<S>(s_A, W, s_B, d_out, g_wout, g_bout, first);
    epi.reduce(s_B, g_extra, first);

    // cotangent into the last state: ybar stack @ w_out^T
    float ca[W], ct[tdim(K)][W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ca[i] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) ct[k][i] = 0.f;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        if (o < d_out) {
          const float wv = s_wout[i * d_out + o];
          ca[i] = fmaf(yb[o], wv, ca[i]);
#pragma unroll
          for (int k = 0; k < K; ++k) ct[k][i] = fmaf(ybt[k][o], wv, ct[k][i]);
        }
      }
    }

    // ---- hidden stack backward, layer j maps state j -> state j + 1
    constexpr int kVec = row_vec<W>();
#pragma unroll 1
    for (int j = n_stack - 1; j >= 0; --j) {
      const int c = j / chunk;
      load_chunk(c);
      const float* w = s_wh + (j - c * chunk) * W * W;
      __syncthreads();  // the previous layer's block product is done
      state_bwd<W, ACT, K>(state(j + 1), ca, ct, sB);
      stage_state<W, ACT, K>(state(j), sA);
      __syncthreads();
      accum_square<W, S>(s_A, s_B, g_wh + static_cast<size_t>(j) * W * W, g_bh + j * W, first);
      // cotangent into state j: [zbar; ubar^0; ...] @ w^T
      float na[W], nt[tdim(K)][W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        na[i] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) nt[k][i] = 0.f;
#pragma unroll
        for (int q = 0; q < W; q += kVec) {
          float wv[kVec];
          load_vec<kVec>(w + i * W + q, wv);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            na[i] = fmaf(ca[q + v], wv[v], na[i]);
#pragma unroll
            for (int k = 0; k < K; ++k) nt[k][i] = fmaf(ct[k][q + v], wv[v], nt[k][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        ca[i] = na[i];
#pragma unroll
        for (int k = 0; k < K; ++k) ct[k][i] = nt[k][i];
      }
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
    accum_rect<S>(s_A, d_in, s_B, W, g_win, g_bin, first);
  }
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

}  // namespace mlp_bwd
