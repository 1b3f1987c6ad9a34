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
// The bf16 and f32x3 tiers (-DTIER_ONLY=1, 2) run on the tensor cores:
// mlp_fwd_tangents_mma.cuh has their design, bound and launch plan. This
// file holds the f32 tier, which stays true f32 on the CUDA cores (TF32 is
// not f32), and the C entries of all three.
//
// f32 design (ops/k2_plan.py::f32_plan decides every launch). The bits
// are pinned: each output neuron's sum is the bias, then fmaf over the
// inputs i = 0 .. W-1 in order, then the accurate tanhf and act'; the output
// layer sums over the neurons j in order; the continuity epilogue is one
// fixed expression. So K2-f32 gives the same bits at every launch shape, and
// what the design may choose is only who computes which sum, and when:
//   * A point takes G lanes (G = 1 or 2; the plan's `lanes`). Lane r of a
//     point's pair owns the C = W / G output neurons r*C .. r*C+C-1 of the
//     primal and of each tangent stream (the compiled widths are even) and
//     keeps them in registers; at each layer a lane takes its partner's C
//     values of each stream by one __shfl_xor_sync each, and feeds input i
//     from its own or its partner's values. G = 1 is one thread per point
//     with no exchange. The output layer gathers the full vectors the same
//     way; lane r computes the outputs r, r+G, ... (every lane all of them
//     for the epilogue, which lane 0 stores).
//   * A persistent grid: at most one block per SM (min(SMs, tiles)), each
//     block staging the hidden stack once. A warp's tile is 32/G points;
//     warp w of block b takes tile w * grid + b, then the same a round of
//     the grid's warps later (warp-major: few tiles still reach every SM).
//     The plan picks the block's warps so the rounds come out even.
//   * Staging by cp.async, issued at once and awaited once (each block
//     starting at its own place in the stack, so that the grid's copies
//     spread over the L2's slices): each hidden layer in shared memory as G
//     lane blocks (lane r's C columns of every row, row after row, so a
//     lane reads its weights in the order of its FMAs as 16-byte vectors),
//     then the biases. Where the stack does not fit one block's shared
//     memory (W = 32 at the flagship's depth) it is staged in chunks of
//     whole layers into two slots, the next chunk copied while the current
//     one computes, every warp of the block meeting at a barrier per chunk
//     and round.
// The flagship's 99 stacked layers take 1,680 B a layer at W = 20 (1,712 B
// at G = 2): 166,320 B of the 232,448 B a block may opt into.
//
// Bound on the H100 at f32: per point the kernel does 2*(d_in*W + (L-1)*W^2
// + W*d_out)*(1+K) FLOPs (about 238,000 for the flagship at K=2) plus L*W
// tanhf, and moves about 12 B of device memory (8 B in, 4 B out with the
// epilogue). It is bound by the CUDA cores' f32 FMA rate, never by memory.
// What binds in practice (tools/walk_breakdown.py --k2, PERF.md): with the
// staging, tanhf and the exchange dropped, two thirds of the time at the
// serving grid remain: the FFMA chains and the weights' way from shared
// memory, where a layer's W*W weights reach every point's registers whoever
// owns which neuron. The accurate tanhf and act' (~15 instructions each, no
// branch) take 14-18 %, and at G = 2 the exchange (C*(1+K) shuffles a lane
// and layer) 6-12 %. A point's cost is so about fixed, and the design buys
// fill: one thread a point in blocks of 256 would leave 27-51 of 132 SMs
// idle at the serving, legacy and CMB sizes with 2 warps a scheduler on the
// rest; here every SM holds a block, two lanes a point double the warps
// where one lane a point leaves fewer than 8 an SM, and one lane a point
// serves where the points fill the card anyway (10M) or at K = 3 (the four
// streams' exchange costs more than the warps buy). More lanes a point (4),
// or more points a lane to reuse each loaded weight, measured slower at
// these sizes (PERF.md).
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

// The activation and its derivative from the pre-activation z and the
// activation a; the tensor-core body (mlp_fwd_tangents_mma.cuh) uses them
// too.
template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if constexpr (ACT == 0) {
    return tanhf(z);
  } else {
    return z >= 0.f ? z : 0.01f * z;
  }
}

template <int ACT>
__device__ __forceinline__ float act_deriv(float z, float a) {
  if constexpr (ACT == 0) {
    return 1.f - a * a;
  } else {
    return z >= 0.f ? 1.f : 0.01f;
  }
}

}  // namespace

// The f32 tier's body, compiled only into the f32 variant.
#if WITH_TIER(0)
namespace k2f32 {

constexpr int kMaxIn = 8;
constexpr int kMaxOut = 8;
constexpr int kMaxTangents = 3;
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(K2_WIDTH % 2 == 0, "two lanes a point split the width in halves");

// The output neurons a lane owns when a point takes `lanes` lanes.
__host__ __device__ constexpr int cols(int W, int lanes) { return W / lanes; }

__host__ __device__ constexpr int ceil4(int n) { return (n + 3) / 4 * 4; }

// Floats of one lane's block of a hidden layer: its cols(W, lanes) columns
// of each of the W rows, row after row, padded to 16 bytes and, for lanes >
// 1, to an odd number of 16-byte words, so that the group's lanes, reading
// the same word of their blocks at once, meet distinct banks.
__host__ __device__ constexpr int block_floats(int W, int lanes) {
  const int n = ceil4(W * cols(W, lanes));
  return lanes == 1 || (n / 4) % 2 ? n : n + 4;
}

// Floats of one hidden layer in shared memory: the lanes' blocks, then the
// W biases (lane r's at r * cols), padded to 16 bytes.
__host__ __device__ constexpr int layer_floats(int W, int lanes) {
  return lanes * block_floats(W, lanes) + ceil4(W);
}

constexpr bool lanes_ok(int lanes) { return lanes == 1 || lanes == 2; }

// The most threads a block takes (its __launch_bounds__) at an estimate of
// a thread's registers: the state of every stream (the layer's inputs and
// its sums, and at two lanes the partner's inputs) plus 48. A block's warps
// are spread over the SM's four schedulers, 16,384 registers each, so a
// block of 4w warps leaves a thread 512/w registers: between 256 and 1,024
// threads, in steps of 128.
__host__ __device__ constexpr int max_threads(int W, int lanes, int K) {
  const int regs = ((lanes > 1 ? 3 : 2) * (1 + K) * cols(W, lanes) + 48 + 7) / 8 * 8;
  const int t = 128 * (512 / regs);
  return t > 1024 ? 1024 : (t < 256 ? 256 : t);
}

// The dynamic shared memory of one block: w_in, b_in, w_out, b_out, each
// 16-byte aligned, then `slots` slots of `chunk` hidden layers.
__host__ __device__ inline size_t smem_bytes(int W, int lanes, int chunk, int slots) {
  using tier::align16;
  return align16(kMaxIn * W * 4) + align16(W * 4) + align16(W * kMaxOut * 4) +
         align16(kMaxOut * 4) +
         static_cast<size_t>(slots) * chunk * layer_floats(W, lanes) * 4;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy n floats from device memory into shared memory, 4 bytes a copy.
__device__ __forceinline__ void stage_small(float* __restrict__ dst, const float* __restrict__ src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async<4>(dst + i, src + i);
}

// The floats one copy of the hidden weights moves: a lane's C columns of a
// row start at a multiple of C floats, so 4 (or 2) where W, C and the
// source's address allow it, else 1.
template <int W, int G>
__device__ __forceinline__ int copy_unit(const float* w_h) {
  constexpr int C = cols(W, G);
  const auto at = reinterpret_cast<unsigned long long>(w_h);
  if (W % 4 == 0 && C % 4 == 0 && at % 16 == 0) return 4;
  if (W % 2 == 0 && C % 2 == 0 && at % 8 == 0) return 2;
  return 1;
}

// Issue the copies of hidden layers [l0, l0 + nl) into `slot` in the layout
// of layer_floats and commit them as one group. Consecutive threads copy
// consecutive words of a row.
template <int W, int G>
__device__ void issue_chunk(float* __restrict__ slot, const float* __restrict__ w_h,
                            const float* __restrict__ b_h, int l0, int nl, int unit) {
  constexpr int C = cols(W, G);
  constexpr int BS = block_floats(W, G);
  constexpr int LF = layer_floats(W, G);
  const int per_row = W / unit;  // copies of a row
  const int total = nl * W * per_row;
  // each block starts at its own place in the chunk, so that the grid's
  // blocks, all copying the same stack at once, spread over the L2's slices
  const int start = static_cast<int>(static_cast<long long>(blockIdx.x) * total / gridDim.x);
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    const int u = v + start < total ? v + start : v + start - total;
    const int j = (u % per_row) * unit;
    const int row = u / per_row;  // l * W + i
    float* dst = slot + (row / W) * LF + (j / C) * BS + (row % W) * C + j % C;
    const float* src = w_h + (static_cast<size_t>(l0) * W + row) * W + j;
    if (unit == 4) {
      cp_async<16>(dst, src);
    } else if (unit == 2) {
      cp_async<8>(dst, src);
    } else {
      cp_async<4>(dst, src);
    }
  }
  for (int u = threadIdx.x; u < nl * W; u += blockDim.x) {
    cp_async<4>(slot + (u / W) * LF + G * BS + u % W, b_h + static_cast<size_t>(l0) * W + u);
  }
  cp_async_commit();
}

// The partner's values of one stream (G = 2: one __shfl_xor_sync a
// neuron; G = 1: none).
template <int G, int C>
__device__ __forceinline__ void partner(const float (&own)[C], float (&other)[C]) {
  if constexpr (G == 2) {
#pragma unroll
    for (int m = 0; m < C; ++m) other[m] = __shfl_xor_sync(kFullMask, own[m], 1);
  }
}

// Input i of a layer (neuron i of the one before): the lane's own value
// where it owns neuron i, else its partner's.
template <int G, int C>
__device__ __forceinline__ float input(const float (&own)[C], const float (&other)[C], int i,
                                       int r) {
  if constexpr (G == 1) {
    return own[i];
  } else {
    return i / C == r ? own[i % C] : other[i % C];
  }
}

// The input layer of lane r's neurons: a = act(x @ w_in + b_in); the
// tangent seed of coordinate k is row k of w_in times act' (models/mlp.py:
// (e_k @ w_in) * act'(z)).
template <int W, int G, int ACT, int K>
__device__ __forceinline__ void input_layer(const float (&xin)[kMaxIn], int d_in,
                                            const float* __restrict__ s_win,
                                            const float* __restrict__ s_bin, int r,
                                            float (&a)[cols(W, G)],
                                            float (&t)[K > 0 ? K : 1][cols(W, G)]) {
  constexpr int C = cols(W, G);
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int j = r * C + m;
    float z = s_bin[j];
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) {
      if (c < d_in) z = fmaf(xin[c], s_win[c * W + j], z);
    }
    a[m] = act_fn<ACT>(z);
    const float d = act_deriv<ACT>(z, a[m]);
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][m] = s_win[k * W + j] * d;
  }
}

// One hidden layer of lane r's neurons: a <- act(a @ w + b), t[k] <- (t[k]
// @ w) * act'(.), the layer at `layer` in shared memory; each weight loaded
// once for the 1+K streams.
template <int W, int G, int ACT, int K>
__device__ __forceinline__ void hidden_layer(const float* __restrict__ layer, int r,
                                             float (&a)[cols(W, G)],
                                             float (&t)[K > 0 ? K : 1][cols(W, G)]) {
  constexpr int C = cols(W, G);
  const float* __restrict__ w = layer + r * block_floats(W, G);
  const float* __restrict__ b = layer + G * block_floats(W, G) + r * C;
  float z[C];
  float zt[K > 0 ? K : 1][C];
#pragma unroll
  for (int m = 0; m < C; ++m) {
    z[m] = b[m];
#pragma unroll
    for (int k = 0; k < K; ++k) zt[k][m] = 0.f;
  }
  float ao[C];
  float to[K > 0 ? K : 1][C];
  partner<G, C>(a, ao);
#pragma unroll
  for (int k = 0; k < K; ++k) partner<G, C>(t[k], to[k]);
  float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float ai = input<G, C>(a, ao, i, r);
    float ti[K > 0 ? K : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) ti[k] = input<G, C>(t[k], to[k], i, r);
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int f = i * C + m;  // the lane's weights in the order of its FMAs
      if (f % 4 == 0) wv = *reinterpret_cast<const float4*>(w + f);
      const float wf = f % 4 == 0 ? wv.x : (f % 4 == 1 ? wv.y : (f % 4 == 2 ? wv.z : wv.w));
      z[m] = fmaf(ai, wf, z[m]);
#pragma unroll
      for (int k = 0; k < K; ++k) zt[k][m] = fmaf(ti[k], wf, zt[k][m]);
    }
  }
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const float zm = z[m];
    const float na = act_fn<ACT>(zm);
    const float d = act_deriv<ACT>(zm, na);
    a[m] = na;
#pragma unroll
    for (int k = 0; k < K; ++k) t[k][m] = zt[k][m] * d;
  }
}

// The output layer of one point and its stores (only where `active`).
template <int W, int G, int K, bool EPI>
__device__ __forceinline__ void output_layer(const float* __restrict__ s_wout,
                                             const float* __restrict__ s_bout, int d_out, int r,
                                             const float (&a)[cols(W, G)],
                                             const float (&t)[K > 0 ? K : 1][cols(W, G)],
                                             bool active, long long p, int n,
                                             float* __restrict__ y, float* __restrict__ dy,
                                             float* __restrict__ fc) {
  constexpr int C = cols(W, G);
  constexpr bool kAll = G == 1 || EPI;  // every lane computes every output
  constexpr int Q = kAll ? kMaxOut : (kMaxOut + G - 1) / G;
  float yo[Q];
  float dyo[K > 0 ? K : 1][Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const int o = kAll ? s : r + s * G;
    yo[s] = o < d_out ? s_bout[o] : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dyo[k][s] = 0.f;
  }
  float ao[C];
  float to[K > 0 ? K : 1][C];
  partner<G, C>(a, ao);
#pragma unroll
  for (int k = 0; k < K; ++k) partner<G, C>(t[k], to[k]);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float aj = input<G, C>(a, ao, j, r);
    float tj[K > 0 ? K : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) tj[k] = input<G, C>(t[k], to[k], j, r);
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const int o = kAll ? s : r + s * G;
      if (o < d_out) {
        const float wv = s_wout[j * d_out + o];
        yo[s] = fmaf(aj, wv, yo[s]);
#pragma unroll
        for (int k = 0; k < K; ++k) dyo[k][s] = fmaf(tj[k], wv, dyo[k][s]);
      }
    }
  }
  if (!active) return;

  if constexpr (EPI) {
    if (r == 0) {
      const float U = yo[0], V = yo[1], h = yo[2];
      fc[p] = (dyo[0][2] * U + h * dyo[0][0]) + (dyo[1][2] * V + h * dyo[1][1]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const int o = kAll ? s : r + s * G;
      if (o < d_out) y[p * d_out + o] = yo[s];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const int o = kAll ? s : r + s * G;
        if (o < d_out) dy[(static_cast<long long>(k) * n + p) * d_out + o] = dyo[k][s];
      }
    }
  }
}

// A warp's tile is 32 / G points: the lanes g*G .. g*G+G-1 take point g.
template <int W, int G, int ACT, int K, bool EPI>
__global__ void __launch_bounds__(max_threads(W, G, K))
k2_f32_kernel(const float* __restrict__ x,      // (n, d_in)
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
  using tier::align16;
  constexpr int C = cols(W, G);
  constexpr int P = 32 / G;  // points per warp tile
  constexpr int LF = layer_floats(W, G);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_win = reinterpret_cast<float*>(smem);
  float* s_bin = s_win + align16(kMaxIn * W * 4) / 4;
  float* s_wout = s_bin + align16(W * 4) / 4;
  float* s_bout = s_wout + align16(W * kMaxOut * 4) / 4;
  float* s_slot0 = s_bout + align16(kMaxOut * 4) / 4;
  float* s_slot1 = s_slot0 + static_cast<size_t>(chunk) * LF;

  const int lane = threadIdx.x & 31;
  const int r = lane % G;
  const int nchunks = n_stack > 0 ? (n_stack + chunk - 1) / chunk : 0;
  const long long tiles = (static_cast<long long>(n) + P - 1) / P;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long first = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;

  // Stage the input and output layers and the first chunk, and wait once.
  stage_small(s_win, w_in, d_in * W);
  stage_small(s_bin, b_in, W);
  stage_small(s_wout, w_out, W * d_out);
  stage_small(s_bout, b_out, d_out);
  const int unit = copy_unit<W, G>(w_h);
  if (nchunks > 0) {
    issue_chunk<W, G>(s_slot0, w_h, b_h, 0, min(chunk, n_stack), unit);
  } else {
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();

  // Every warp walks the same number of rounds when the stack has more
  // than one chunk (its barriers), computing only on the tiles it has.
  const long long rounds = nchunks > 1 ? (tiles + stride - 1) / stride : 0;
  long long c_all = 0;  // chunks consumed: chunk c_all sits in slot c_all % 2
  for (long long t = first, rnd = 0; nchunks > 1 ? rnd < rounds : t < tiles;
       t += stride, ++rnd) {
    const bool live = t < tiles;  // the same on every lane of the warp
    const long long p = t * P + lane / G;
    float xin[kMaxIn];
#pragma unroll
    for (int c = 0; c < kMaxIn; ++c) xin[c] = (live && p < n && c < d_in) ? x[p * d_in + c] : 0.f;
    float a[C];
    float tg[K > 0 ? K : 1][C];
    input_layer<W, G, ACT, K>(xin, d_in, s_win, s_bin, r, a, tg);
    if (nchunks <= 1) {
#pragma unroll 1
      for (int l = 0; l < n_stack; ++l) hidden_layer<W, G, ACT, K>(s_slot0 + l * LF, r, a, tg);
    } else {
      for (int c = 0; c < nchunks; ++c, ++c_all) {
        if (c_all > 0) {  // chunk c_all has arrived, and no warp still reads the one before
          cp_async_wait_all();
          __syncthreads();
        }
        if (c + 1 < nchunks || rnd + 1 < rounds) {
          const int nc = (c + 1) % nchunks;
          issue_chunk<W, G>((c_all & 1) ? s_slot0 : s_slot1, w_h, b_h, nc * chunk,
                            min(chunk, n_stack - nc * chunk), unit);
        }
        if (live) {
          const float* base = (c_all & 1) ? s_slot1 : s_slot0;
          const int nl = min(chunk, n_stack - c * chunk);
#pragma unroll 1
          for (int l = 0; l < nl; ++l) hidden_layer<W, G, ACT, K>(base + l * LF, r, a, tg);
        }
      }
    }
    if (live) output_layer<W, G, K, EPI>(s_wout, s_bout, d_out, r, a, tg, p < n, p, n, y, dy, fc);
  }
}

struct Args {
  const float *x, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *y, *dy, *fc;
  int n, d_in, d_out, n_stack;
};

template <int G, int ACT, int K, bool EPI>
cudaError_t launch(const Args& a, int grid, int threads, int chunk, size_t smem,
                   cudaStream_t stream) {
  if (threads > max_threads(K2_WIDTH, G, K)) return cudaErrorInvalidValue;
  auto kernel = k2_f32_kernel<K2_WIDTH, G, ACT, K, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a.x, a.w_in, a.b_in, a.w_h, a.b_h, a.w_out, a.b_out,
                                          a.y, a.dy, a.fc, a.n, a.d_in, a.d_out, a.n_stack,
                                          chunk);
  return cudaGetLastError();
}

template <int G, int ACT>
cudaError_t dispatch_mode(const Args& a, int n_tangents, int epilogue, int grid, int threads,
                          int chunk, size_t smem, cudaStream_t stream) {
  if (epilogue) return launch<G, ACT, 2, true>(a, grid, threads, chunk, smem, stream);
  switch (n_tangents) {
    case 0: return launch<G, ACT, 0, false>(a, grid, threads, chunk, smem, stream);
    case 1: return launch<G, ACT, 1, false>(a, grid, threads, chunk, smem, stream);
    case 2: return launch<G, ACT, 2, false>(a, grid, threads, chunk, smem, stream);
    case 3: return launch<G, ACT, 3, false>(a, grid, threads, chunk, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t dispatch_act(const Args& a, int n_tangents, int act, int epilogue, int grid,
                         int threads, int chunk, size_t smem, cudaStream_t stream) {
  if (act == 0) {
    return dispatch_mode<G, 0>(a, n_tangents, epilogue, grid, threads, chunk, smem, stream);
  }
  return dispatch_mode<G, 1>(a, n_tangents, epilogue, grid, threads, chunk, smem, stream);
}

int run(const float* x, const float* w_in, const float* b_in, const float* w_h,
        const float* b_h, const float* w_out, const float* b_out, float* y, float* dy,
        float* fc, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
        int epilogue, int grid, int threads, int lanes, int chunk, void* stream) {
  if (n <= 0 || d_in < 1 || d_in > kMaxIn || d_out < 1 || d_out > kMaxOut ||
      n_tangents < 0 || n_tangents > kMaxTangents || n_tangents > d_in || n_stack < 0 ||
      (act != 0 && act != 1) || (epilogue && (n_tangents != 2 || d_out != 3)) || grid < 1 ||
      threads < 32 || threads % 32 || !lanes_ok(lanes) ||
      (n_stack > 0 && (chunk < 1 || chunk > n_stack)))
    return cudaErrorInvalidValue;
  if (n_stack == 0) chunk = 0;
  const size_t smem = smem_bytes(K2_WIDTH, lanes, chunk, chunk < n_stack ? 2 : 1);
  const Args a{x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out, n_stack};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lanes == 1 ? dispatch_act<1>(a, n_tangents, act, epilogue, grid, threads, chunk, smem, s)
                    : dispatch_act<2>(a, n_tangents, act, epilogue, grid, threads, chunk, smem, s);
}

}  // namespace k2f32
#endif

#if WITH_TIER(1) || WITH_TIER(2)
#include "mlp_fwd_tangents_mma.cuh"
#endif

extern "C" {

int k2_width() { return K2_WIDTH; }

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#if WITH_TIER(0)
// What ops/k2_plan.py::f32_plan assumes of the f32 body: the most threads a
// block of `lanes` lanes a point takes at K tangents (the epilogue: K = 2;
// 0 for a lane count the body does not take), and the shared-memory bytes
// of `slots` slots of `chunk` hidden layers (the plan decides both).
int k2_f32_threads(int lanes, int n_tangents) {
  if (!k2f32::lanes_ok(lanes) || n_tangents < 0 || n_tangents > k2f32::kMaxTangents) return 0;
  return k2f32::max_threads(K2_WIDTH, lanes, n_tangents);
}
int k2_f32_smem(int lanes, int chunk, int slots) {
  if (!k2f32::lanes_ok(lanes)) return 0;
  return static_cast<int>(k2f32::smem_bytes(K2_WIDTH, lanes, chunk, slots));
}
#endif

#if WITH_TIER(1) || WITH_TIER(2)
// The tensor-core body's tile (points per warp) and, per tier, its warps
// per block and the shared-memory bytes of a chunk of hidden layers: what
// ops/k2_plan.py assumes (the plan decides the chunk).
int k2_mma_rows() { return k2mma::kRows; }
#endif

#if WITH_TIER(1)
int k2_mma_warps_bf16() { return k2mma::warps<tier::TierBf16, K2_WIDTH>(); }
int k2_mma_smem_bf16(int chunk) {
  return static_cast<int>(k2mma::smem_bytes(K2_WIDTH, chunk, false));
}
#endif

#if WITH_TIER(2)
int k2_mma_warps_f32x3() { return k2mma::warps<tier::TierF32x3, K2_WIDTH>(); }
int k2_mma_smem_f32x3(int chunk) {
  return static_cast<int>(k2mma::smem_bytes(K2_WIDTH, chunk, true));
}
#endif

// One launch at the f32 tier on the plan of ops/k2_plan.py::f32_plan: its
// grid, threads a block, lanes a point and hidden layers a chunk. Returns a
// cudaError_t: 0 on success; the launch does not synchronise.
#if WITH_TIER(0)
int k2_mlp_fwd_tangents(const float* x, const float* w_in, const float* b_in,
                        const float* w_h, const float* b_h, const float* w_out,
                        const float* b_out, float* y, float* dy, float* fc, int n, int d_in,
                        int d_out, int n_stack, int n_tangents, int act, int epilogue, int grid,
                        int threads, int lanes, int chunk, void* stream) {
  return k2f32::run(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out, n_stack,
                    n_tangents, act, epilogue, grid, threads, lanes, chunk, stream);
}
#endif

// One launch at the bf16 or f32x3 tier on the tensor cores, with the f32
// entry's arguments and then the launch plan's grid and hidden layers per
// shared-memory chunk (ops/k2_plan.py).
#if WITH_TIER(1)
int k2_mlp_fwd_tangents_bf16(const float* x, const float* w_in, const float* b_in,
                             const float* w_h, const float* b_h, const float* w_out,
                             const float* b_out, float* y, float* dy, float* fc, int n,
                             int d_in, int d_out, int n_stack, int n_tangents, int act,
                             int epilogue, int grid, int chunk, void* stream) {
  return k2mma::run<tier::TierBf16>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in,
                                    d_out, n_stack, n_tangents, act, epilogue, grid, chunk,
                                    stream);
}
#endif

#if WITH_TIER(2)
int k2_mlp_fwd_tangents_f32x3(const float* x, const float* w_in, const float* b_in,
                              const float* w_h, const float* b_h, const float* w_out,
                              const float* b_out, float* y, float* dy, float* fc, int n,
                              int d_in, int d_out, int n_stack, int n_tangents, int act,
                              int epilogue, int grid, int chunk, void* stream) {
  return k2mma::run<tier::TierF32x3>(x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n,
                                     d_in, d_out, n_stack, n_tangents, act, epilogue, grid,
                                     chunk, stream);
}
#endif

}  // extern "C"
