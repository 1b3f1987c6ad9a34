// K1 for Hopper: the one-kernel training step of the continuity losses, f32.
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
// Design. One thread per point, 128 points per tile. The primal and the two
// tangent streams stay in registers (W is a compile-time constant: one
// library per width, -DK1_WIDTH=W); the hidden weights sit in shared memory
// (one chunk of whole layers when the stack does not fit). The forward
// writes every layer state (a, u^1, u^2; u^k the tangent before the act'
// scale) to a per-block scratch laid out [state][component][thread], so
// neighbouring threads touch neighbouring addresses; the backward reads it
// back in reverse. Per layer, each thread stages s_prev = [a; t^1; t^2] and
// [zbar; ubar^1; ubar^2] (3W floats each) in shared memory, and the block
// forms that layer's W x W weight gradient as a product over its 128 points
// (2 x 2 register tiles; rows padded to 129 floats so no two lanes of a warp
// hit one bank). Gradients are sums over every point, and Hopper runs
// blocks in no order: each block of a fixed-size grid walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its own partial sums in
// a scratch row (written by one fixed thread per entry, in tile order);
// a second kernel sums the rows in block order. No atomics: the result is
// the same bit for bit from run to run.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// forward (238,200 for the 2->[20]x100->3 flagship at K=2) and about twice
// that backward (476,000), plus L*W tanhf, against a few bytes of inputs
// and ~0.6 MB of weights and gradients: the CUDA cores' f32 FMA rate bounds
// it. What the design spends beyond that: the layer states go to device
// memory and back (24,000 B per point at the flagship, ~0.6 GB of traffic
// at 12,516 points, mostly served by L2 only in part), and the per-layer
// block product reads shared memory once per two FMAs. Tensor cores and
// segment recomputation are left for later work (ROADMAP.md).
//
// Limits (the wrapper checks them first and raises): W in the compiled
// widths; 1 <= d_in <= 8 with the tangents on inputs 0 and 1; d_out = 3;
// 1 <= n_true <= 3, n_true <= 2 with the anchor; tanh (act 0) or
// LeakyReLU(0.01) (act 1); N < 2^31.

#include <cuda_runtime.h>

#ifndef K1_WIDTH
#error "compile with -DK1_WIDTH=<hidden width>"
#endif

namespace {

constexpr int kThreads = 128;          // points per tile = threads per block
constexpr int kLd = kThreads + 1;      // staging row stride: one bank per row
constexpr int kMaxIn = 8;
constexpr int kOut = 3;                // heads (U, V, h)
constexpr int kStats = 8;              // fc^2, anch^2, err_0..2^2, 3 unused
constexpr int kStatRow = 9;            // first staging row of the statistics

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
// t^k <- z^k * act'; the state (a, z^1, z^2) goes to st[c * kThreads].
template <int W, int ACT>
__device__ __forceinline__ void hidden_fwd(const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           float (&a)[W], float (&t)[2][W],
                                           float* __restrict__ st) {
  constexpr int V = row_vec<W>();
  float z[W], zt[2][W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    z[j] = b[j];
    zt[0][j] = 0.f;
    zt[1][j] = 0.f;
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
        zt[0][j + v] = fmaf(t[0][i], wv[v], zt[0][j + v]);
        zt[1][j + v] = fmaf(t[1][i], wv[v], zt[1][j + v]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float na = act_fn<ACT>(z[j]);
    const float d = dact<ACT>(na);
    st[j * kThreads] = na;
    st[(W + j) * kThreads] = zt[0][j];
    st[(2 * W + j) * kThreads] = zt[1][j];
    a[j] = na;
    t[0][j] = zt[0][j] * d;
    t[1][j] = zt[1][j] * d;
  }
}

// From the cotangent (ca, ct) of a state (a, u) (read from st), the
// cotangents of its layer's pre-activation and tangent streams, written in
// place: ca <- zbar = (ca + act''*Dbar)*D, ct^k <- ubar^k = ct^k*D, with
// Dbar = sum_k ct^k*u^k. Also staged into sB rows [zbar; ubar^1; ubar^2].
template <int W, int ACT>
__device__ __forceinline__ void state_bwd(const float* __restrict__ st,
                                          float (&ca)[W], float (&ct)[2][W],
                                          float* __restrict__ sB) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float a = st[i * kThreads];
    const float u0 = st[(W + i) * kThreads];
    const float u1 = st[(2 * W + i) * kThreads];
    const float d = dact<ACT>(a);
    const float dbar = ct[0][i] * u0 + ct[1][i] * u1;
    ca[i] = (ca[i] + ddact<ACT>(a, dbar)) * d;
    ct[0][i] *= d;
    ct[1][i] *= d;
    sB[i * kLd] = ca[i];
    sB[(W + i) * kLd] = ct[0][i];
    sB[(2 * W + i) * kLd] = ct[1][i];
  }
}

// Stage s = [a; u^1*D; u^2*D] of the state in st into sA rows.
template <int W, int ACT>
__device__ __forceinline__ void stage_state(const float* __restrict__ st,
                                            float* __restrict__ sA) {
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
    const float a = st[i * kThreads];
    const float d = dact<ACT>(a);
    sA[i * kLd] = a;
    sA[(W + i) * kLd] = st[(W + i) * kThreads] * d;
    sA[(2 * W + i) * kLd] = st[(2 * W + i) * kThreads] * d;
  }
}

// dw[i][j] (+)= sum_{c<3} sum_p sA[c*W+i][p] * sB[c*W+j][p] and
// db[j] (+)= sum_p sB[j][p], over the block's points, in 2 x 2 tiles
// (W even). One fixed thread owns each entry.
template <int W>
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
    for (int c = 0; c < 3; ++c) {
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
__device__ __forceinline__ void accum_rect(const float* __restrict__ sA, int rows_a,
                                           const float* __restrict__ sB, int rows_b,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           bool first) {
  for (int e = threadIdx.x; e < rows_a * rows_b; e += kThreads) {
    const int i = e / rows_b, j = e % rows_b;
    float acc = 0.f;
    for (int c = 0; c < 3; ++c) {
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

struct Args {
  const float *coords, *trues, *sel, *mask, *scal;
  const float *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *partial, *states;
  int n, d_in, n_stack, n_true, has_anchor, chunk;
};

template <int W, int ACT>
__global__ void __launch_bounds__(kThreads)
k1_train_step_kernel(const Args args) {
  extern __shared__ __align__(16) float smem[];
  const int n_stack = args.n_stack, d_in = args.d_in, chunk = args.chunk;
  float* s_wh = smem;                           // chunk * W * W
  float* s_bh = s_wh + chunk * W * W;           // chunk * W
  float* s_win = s_bh + chunk * W;              // kMaxIn * W
  float* s_bin = s_win + kMaxIn * W;            // W
  float* s_wout = s_bin + W;                    // W * 3
  float* s_bout = s_wout + W * kOut;            // 3
  float* s_A = s_bout + kOut;                   // 3W rows of kLd
  float* s_B = s_A + 3 * W * kLd;               // 3W rows of kLd

  const int tid = threadIdx.x;
  for (int i = tid; i < d_in * W; i += kThreads) s_win[i] = args.w_in[i];
  for (int i = tid; i < W; i += kThreads) s_bin[i] = args.b_in[i];
  for (int i = tid; i < W * kOut; i += kThreads) s_wout[i] = args.w_out[i];
  for (int i = tid; i < kOut; i += kThreads) s_bout[i] = args.b_out[i];

  const float res_scale = args.scal[0], anchor_scale = args.scal[1];
  const float depth = args.scal[2];
  const float fid_scale[3] = {args.scal[3], args.scal[4], args.scal[5]};
  const int n_true = args.n_true;

  // Per-block partial sums, in the flat order of the parameters' sorted
  // keys (b_hidden, b_in, b_out, w_hidden, w_in, w_out), then statistics.
  const long long n_params = static_cast<long long>(n_stack) * W * (W + 1) +
                             W + kOut + d_in * W + W * kOut;
  float* part = args.partial + blockIdx.x * (n_params + kStats);
  float* g_bh = part;
  float* g_bin = g_bh + n_stack * W;
  float* g_bout = g_bin + W;
  float* g_wh = g_bout + kOut;
  float* g_win = g_wh + static_cast<long long>(n_stack) * W * W;
  float* g_wout = g_win + d_in * W;
  float* g_stats = g_wout + W * kOut;

  // This thread's layer states: state s, component c at st0[(s*3W + c) * kThreads].
  float* st0 = args.states + static_cast<size_t>(blockIdx.x) * (n_stack + 1) * 3 * W * kThreads + tid;
  auto state = [&](int s) { return st0 + static_cast<size_t>(s) * 3 * W * kThreads; };

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

    // ---- forward: input layer (tangent seeds are rows 0, 1 of w_in)
    float a[W], t[2][W];
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
        const float u0 = s_win[j], u1 = s_win[W + j];
        st[j * kThreads] = a[j];
        st[(W + j) * kThreads] = u0;
        st[(2 * W + j) * kThreads] = u1;
        t[0][j] = u0 * d;
        t[1][j] = u1 * d;
      }
    }
    // ---- forward: hidden stack, chunk by chunk
    for (int c = 0; c < n_chunks; ++c) {
      load_chunk(c);
      const int l0 = c * chunk, nl = min(chunk, n_stack - l0);
#pragma unroll 1
      for (int l = 0; l < nl; ++l) {
        hidden_fwd<W, ACT>(s_wh + l * W * W, s_bh + l * W, a, t, state(l0 + l + 1));
      }
    }

    // ---- output layer and the loss epilogue
    float y[kOut], dy[2][kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      y[o] = s_bout[o];
      dy[0][o] = 0.f;
      dy[1][o] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float wv = s_wout[j * kOut + o];
        y[o] = fmaf(a[j], wv, y[o]);
        dy[0][o] = fmaf(t[0][j], wv, dy[0][o]);
        dy[1][o] = fmaf(t[1][j], wv, dy[1][o]);
      }
    }
    const float U = y[0], V = y[1], h = y[2];
    const float Ux = dy[0][0], hx = dy[0][2], Vy = dy[1][1], hy = dy[1][2];
    const float m = active ? args.mask[p] : 0.f;
    const float sel = active ? args.sel[p] : 0.f;
    const float fc = (hx * U + h * Ux + hy * V + h * Vy) * m;
    const float anch = args.has_anchor ? sel * (h - depth) : 0.f;
    float err[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < n_true; ++j) {
      err[j] = active ? m * (y[j] - args.trues[p * n_true + j]) : 0.f;
    }
    const float fbar = res_scale * fc;
    float yb[kOut] = {fbar * hx, fbar * hy, anchor_scale * anch + fbar * (Ux + Vy)};
    for (int j = 0; j < n_true; ++j) yb[j] += fid_scale[j] * err[j];
    const float ybx[kOut] = {fbar * h, 0.f, fbar * U};
    const float yby[kOut] = {0.f, fbar * h, fbar * V};

    // ---- output layer backward: stage s_L = [a; t^1; t^2] and
    // [ybar; ybar_x; ybar_y] and the statistics
    __syncthreads();  // the previous tile's input-layer product is done
    float* sA = s_A + tid;
    float* sB = s_B + tid;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      sA[i * kLd] = a[i];
      sA[(W + i) * kLd] = t[0][i];
      sA[(2 * W + i) * kLd] = t[1][i];
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      sB[o * kLd] = yb[o];
      sB[(kOut + o) * kLd] = ybx[o];
      sB[(2 * kOut + o) * kLd] = yby[o];
    }
    sB[kStatRow * kLd] = fc * fc;
    sB[(kStatRow + 1) * kLd] = anch * anch;
#pragma unroll
    for (int j = 0; j < 3; ++j) sB[(kStatRow + 2 + j) * kLd] = err[j] * err[j];
    __syncthreads();
    accum_rect(s_A, W, s_B, kOut, g_wout, g_bout, first);
    for (int s = tid; s < 5; s += kThreads) {
      float acc = 0.f;
      for (int q = 0; q < kThreads; ++q) acc += s_B[(kStatRow + s) * kLd + q];
      g_stats[s] = accumulate(g_stats + s, acc, first);
    }
    for (int s = 5 + tid; s < kStats; s += kThreads) g_stats[s] = 0.f;

    // cotangent into the last state: ybar stack @ w_out^T
    float ca[W], ct[2][W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ca[i] = 0.f;
      ct[0][i] = 0.f;
      ct[1][i] = 0.f;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float wv = s_wout[i * kOut + o];
        ca[i] = fmaf(yb[o], wv, ca[i]);
        ct[0][i] = fmaf(ybx[o], wv, ct[0][i]);
        ct[1][i] = fmaf(yby[o], wv, ct[1][i]);
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
      state_bwd<W, ACT>(state(j + 1), ca, ct, sB);
      stage_state<W, ACT>(state(j), sA);
      __syncthreads();
      accum_square<W>(s_A, s_B, g_wh + static_cast<size_t>(j) * W * W,
                      g_bh + j * W, first);
      // cotangent into state j: [zbar; ubar^1; ubar^2] @ w^T
      float na[W], nt[2][W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        na[i] = 0.f;
        nt[0][i] = 0.f;
        nt[1][i] = 0.f;
#pragma unroll
        for (int q = 0; q < W; q += kVec) {
          float wv[kVec];
          load_vec<kVec>(w + i * W + q, wv);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            na[i] = fmaf(ca[q + v], wv[v], na[i]);
            nt[0][i] = fmaf(ct[0][q + v], wv[v], nt[0][i]);
            nt[1][i] = fmaf(ct[1][q + v], wv[v], nt[1][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        ca[i] = na[i];
        ct[0][i] = nt[0][i];
        ct[1][i] = nt[1][i];
      }
    }

    // ---- input layer backward: s_in = [x; e_x; e_y], so dw_in[k, :] also
    // collects sum_p ubar_0^k (the tangent seeds are rows k of w_in)
    __syncthreads();
    state_bwd<W, ACT>(state(0), ca, ct, sB);
    for (int c = 0; c < d_in; ++c) {
      sA[c * kLd] = x[c];
      sA[(d_in + c) * kLd] = c == 0 ? 1.f : 0.f;
      sA[(2 * d_in + c) * kLd] = c == 1 ? 1.f : 0.f;
    }
    __syncthreads();
    accum_rect(s_A, d_in, s_B, W, g_win, g_bin, first);
  }
}

// out[e] = sum over blocks b, in order, of partial[b][e]: the fixed order
// keeps the gradients deterministic.
__global__ void k1_reduce_kernel(const float* __restrict__ partial, int blocks,
                                 int n_ent, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_ent) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * n_ent + e];
  out[e] = s;
}

size_t smem_bytes(int chunk) {
  constexpr int W = K1_WIDTH;
  return (static_cast<size_t>(chunk) * (W * W + W) + kMaxIn * W + W + W * kOut + kOut +
          2 * 3 * W * kLd) *
         sizeof(float);
}

template <int ACT>
cudaError_t launch(const Args& a, int grid, float* out, int n_ent, cudaStream_t stream) {
  auto kernel = k1_train_step_kernel<K1_WIDTH, ACT>;
  const size_t smem = smem_bytes(a.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_reduce_kernel<<<(n_ent + 255) / 256, 256, 0, stream>>>(a.partial, grid, n_ent, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_width() { return K1_WIDTH; }

int k1_threads() { return kThreads; }

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hidden layers one shared-memory chunk holds on the current device (0 when
// not even one fits beside the staging rows).
int k1_chunk_layers(int n_stack) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  constexpr int W = K1_WIDTH;
  const long long per_layer = (W * W + W) * 4LL;
  const long long fit = (max_smem - static_cast<long long>(smem_bytes(0))) / per_layer;
  return static_cast<int>(fit < n_stack ? fit : n_stack);
}

// One training-step evaluation: K1 on a grid of `grid` blocks into
// `partial` (grid rows of n_params + 8 floats), then the fixed-order
// reduction into `out` (n_params + 8: the gradients in sorted-key order,
// then the statistics). `states` holds grid * (n_stack + 1) * 3W * 128
// floats. Returns a cudaError_t; nothing synchronises.
int k1_train_step(const float* coords, const float* trues, const float* sel,
                  const float* mask, const float* scal, const float* w_in,
                  const float* b_in, const float* w_h, const float* b_h,
                  const float* w_out, const float* b_out, float* partial, float* states,
                  float* out, int n, int d_in, int n_stack, int n_true, int has_anchor,
                  int act, int grid, void* stream) {
  if (n <= 0 || d_in < 2 || d_in > kMaxIn || n_stack < 0 || n_true < 1 || n_true > 3 ||
      (has_anchor && n_true > 2) || (act != 0 && act != 1) || grid < 1 ||
      grid > (n + kThreads - 1) / kThreads)
    return cudaErrorInvalidValue;
  int chunk = 1;
  if (n_stack > 0) {
    chunk = k1_chunk_layers(n_stack);
    if (chunk < 1) return cudaErrorInvalidValue;
  }
  constexpr int W = K1_WIDTH;
  const long long n_ent = static_cast<long long>(n_stack) * W * (W + 1) + W + kOut +
                          d_in * W + W * kOut + kStats;
  const Args a{coords, trues, sel, mask, scal, w_in, b_in, w_h, b_h, w_out, b_out,
               partial, states, n, d_in, n_stack, n_true, has_anchor,
               n_stack > 0 ? chunk : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? launch<0>(a, grid, out, static_cast<int>(n_ent), s)
                  : launch<1>(a, grid, out, static_cast<int>(n_ent), s);
}

}  // extern "C"
