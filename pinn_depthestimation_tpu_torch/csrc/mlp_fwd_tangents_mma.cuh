// K2 at the bf16 and f32x3 tiers on Hopper's tensor cores (included by
// mlp_fwd_tangents.cu for the -DTIER_ONLY=1 and =2 variants, after the
// activation helpers act_fn and act_deriv it shares with the f32 tier's
// CUDA-core body there).
//
// Both tiers are bf16 operands with f32 sums (tier.cuh, ops/tiers.py):
// bf16 is one product a*w of the rounded values, f32x3 three, summed as
// (a_lo*w_hi + a_hi*w_lo) + a_hi*w_hi. That is what a warp-level
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// computes (and m16n8k8 for a last half k-tile), so every hidden layer
// z = a @ W + b of every stream is a few MMAs:
//
// * A warp owns a tile of 16 points (the rows of the MMA). The primal and
//   each of the K tangent streams is its own m16 operand; all of them use
//   the layer's B fragments, loaded once per layer from shared memory.
//   Thread (g = lane / 4, q = lane % 4) holds the primal and every tangent
//   of the same (point, neuron) pairs in the same registers: rows g and
//   g + 8, columns 8j + 2q and 8j + 2q + 1 of each 8-column tile j. So
//   t <- (t @ W) * act'(z) needs no shuffle.
// * The width W is padded to N_p = 8 * ceil(W / 8) neurons (T = N_p / 8
//   tiles of 8): padded weights and biases are zero, so padded neurons stay
//   0 (tanh(0) = 0, LeakyReLU(0) = 0) and their tangents 0 * 1 = 0. The
//   accumulator of column tiles (2i, 2i + 1) *is* the A fragment of k-tile
//   i of the next layer in the m16n8k16 layouts, so a layer ends in
//   registers: the activation and its derivative, then the operand of the
//   next product, rounded to bf16 (cvt.rn.bf16x2.f32, the tier's operand
//   rounding) or split into hi = rn(x), lo = rn(x - hi) (tier::split). An
//   odd last tile (W = 8, 20) runs as m16n8k8: the zero upper half of a
//   16-column k-tile (columns 24-31 at W = 20, K_p = 32) is never
//   multiplied and never stored.
// * The bias enters only the primal's main accumulator (the C operand of
//   its first MMA); the tangents start at 0. At f32x3 each tile keeps two
//   accumulators, the cross terms and the main term, added in f32 at the
//   layer end, as Tier::fin does.
// * The input layer (d_in <= 8) runs on the CUDA cores per accumulator
//   element, in the tier's semantics (coordinates and w_in rounded or
//   split; the tangent seeds are rows of the tier's w_in times act'). The
//   output layer is one 8-column tile of MMAs. The continuity epilogue
//   finds (U, V, h) in columns 0-2, i.e. on lanes q = 0 and q = 1 of each
//   quad: one __shfl_down_sync per value feeds lane q = 0.
// * Weights: a persistent grid (ops/k2_plan.py: one block per SM, up to
//   the SM count) whose warps walk the 16-point tiles warp-major (warp w of
//   block b takes tile w * grid + b, then the same a round of all warps
//   later), so a grid with fewer tiles than warps keeps every SM busy.
//   Each block stages the hidden stack once, converted from the f32
//   weights at staging (rounded at bf16, split into hi/lo at f32x3), in
//   fragment order: per layer and column tile j, one 32-bit word (bf16x2;
//   a hi/lo pair at f32x3) per lane and half k-tile, the two halves of a
//   k16 step side by side (half_word), so one 8- or 16-byte load per lane
//   gives an MMA's B registers in adjacent registers and a warp's load is
//   32 consecutive vectors (no bank conflict). A layer takes T^2 * 128 B
//   at bf16 (1,152 B at W = 20: the flagship's 99 layers in 114 KB) and
//   twice that at f32x3 (228,096 B for the flagship: one chunk). The hidden biases are read through the L1 cache. A stack
//   that does not fit is staged in chunks of whole layers, all warps of a
//   block meeting at a barrier around each chunk once per round of tiles.
//   Rows past N compute on zeros and store nothing.
// * tanhf stays the accurate one (no tanh.approx.f32, no fast math): its
//   2^-11 error would show at f32x3.
//
// Why mma.sync and not wgmma: one layer is a 16 x 24 x 24 product per
// stream at W = 20, and each layer needs the last one's result, so there
// is nothing for a 64-row asynchronous warpgroup product to overlap. At 10M
// points, K = 2 and W = 20 a bf16 layer is 18 MMAs per tile (54 at f32x3)
// against about 240 CUDA-core instructions per warp (12 accurate tanhf a
// lane, the act' and tangent products, the conversions, the fragment
// loads): the CUDA cores and the MUFU (two per tanhf), not the tensor
// cores, bind once the products leave the CUDA cores (PERF.md, section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_frag.cuh"
#include "tier.cuh"

namespace k2mma {

using namespace mmafrag;

constexpr int kRows = 16;  // points per warp tile: the m16 of the MMA
constexpr int kMaxIn = 8;
constexpr int kMaxOut = 8;

// Warps per block: one block per SM (the stack fills its shared memory),
// as many as the registers allow without a spill: 16 at bf16 (up to 128
// registers a thread) and 12 at f32x3 (168), whose hi/lo operands and two
// accumulators per tile need ~150 at W = 20; four fewer at W = 32.
template <class Tier, int W>
__host__ __device__ constexpr int warps() {
  return (Tier::kSplit ? 12 : 16) - (W > 20 ? 4 : 0);
}

// The dynamic shared memory of one block: `chunk` hidden layers of B
// fragments, w_in at the tier ([kMaxIn][N_p] floats, or (hi, lo) pairs),
// the output layer's B fragments; each region 16-byte aligned.
__host__ __device__ inline size_t smem_bytes(int W, int chunk, bool split) {
  using tier::align16;
  const size_t unit = split ? 8 : 4;
  const size_t t = static_cast<size_t>(tiles8(W));
  return align16(static_cast<size_t>(chunk) * t * t * 32 * unit) +
         align16(static_cast<size_t>(kMaxIn) * 8 * t * unit) + align16(t * 32 * unit);
}

// One hidden layer of every stream: a <- act(a @ W + b), t[k] <- (t[k] @
// W) * act'(.), with the layer's B fragments `sw` (T column tiles, each
// laid out as half_word says) in shared memory and its bias `b` in device
// memory.
template <class Tier, int W, int ACT, int K>
__device__ __forceinline__ void hidden_layer(const uint32_t* __restrict__ sw,
                                             const float* __restrict__ b, int lane, Half (&a)[tiles8(W)],
                                             Half (&t)[K > 0 ? K : 1][tiles8(W)]) {
  constexpr bool S = Tier::kSplit;
  constexpr int T = tiles8(W);
  const int q = lane & 3;
  constexpr int kTileWords = T * 32 * (S ? 2 : 1);
  BWord bw[T][T];
#pragma unroll
  for (int j = 0; j < T; ++j) load_tile_b<S, T>(sw + j * kTileWords, lane, bw[j]);
  float bias[T][2];
#pragma unroll
  for (int j = 0; j < T; ++j) load_bias<W>(b, j, q, bias[j]);

  float z[T][4];
  product<S, T, T>(z, a, bw, bias);
  float d[T][4];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float na[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      na[e] = act_fn<ACT>(z[j][e]);
      d[j][e] = act_deriv<ACT>(z[j][e], na[e]);
    }
    a[j] = make_half<S>(na[0], na[1], na[2], na[3]);
  }
  const float zero[T][2] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float zt[T][4];
    product<S, T, T>(zt, t[k], bw, zero);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      t[k][j] = make_half<S>(zt[j][0] * d[j][0], zt[j][1] * d[j][1], zt[j][2] * d[j][2],
                             zt[j][3] * d[j][3]);
    }
  }
}

template <class Tier, int W, int ACT, int K, bool EPI>
__global__ void __launch_bounds__(32 * warps<Tier, W>(), 1)
k2_mma_kernel(const float* __restrict__ x,      // (n, d_in)
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
  constexpr bool S = Tier::kSplit;
  constexpr int T = tiles8(W);
  constexpr int NP = 8 * T;
  constexpr int KS = K > 0 ? K : 1;
  constexpr int kTileWords = T * 32 * (S ? 2 : 1);  // one column tile's B words
  using WV = typename Tier::WV;
  using tier::align16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* cur = smem;
  auto carve = [&](size_t bytes) { unsigned char* p = cur; cur += align16(bytes); return p; };
  uint32_t* s_wh = reinterpret_cast<uint32_t*>(carve(static_cast<size_t>(chunk) * T * kTileWords * 4));
  WV* s_win = reinterpret_cast<WV*>(carve(kMaxIn * NP * sizeof(WV)));
  uint32_t* s_wout = reinterpret_cast<uint32_t*>(carve(kTileWords * 4));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;

  // w_in at the tier ([c][N_p], zero past d_in and W) and the output
  // layer's B fragments ([h][lane]), once per block
  for (int i = tid; i < kMaxIn * NP; i += blockDim.x) {
    const int c = i / NP, col = i % NP;
    s_win[i] = tier::w_ld(Tier::to_w(c < d_in && col < W ? w_in[c * W + col] : 0.f));
  }
  for (int i = tid; i < T * 32; i += blockDim.x) {  // (half, lane)
    const int k = 8 * (i >> 5) + 2 * (i & 3), o = (i & 31) >> 2;
    const bool in = k < W && o < d_out;
    stage_half<S, T>(s_wout, i >> 5, i & 31, in ? w_out[k * d_out + o] : 0.f,
                     in ? w_out[(k + 1) * d_out + o] : 0.f);
  }
  const bool one_chunk = chunk >= n_stack;
  if (one_chunk) stage_hidden<S, W>(s_wh, w_h, n_stack);
  __syncthreads();

  const long long tiles = (static_cast<long long>(n) + kRows - 1) / kRows;
  const long long stride = static_cast<long long>(gridDim.x) * warps<Tier, W>();
  const long long rounds = (tiles + stride - 1) / stride;
  for (long long r = 0; r < rounds; ++r) {
    const long long tile = r * stride + static_cast<long long>(warp) * gridDim.x + blockIdx.x;
    if (one_chunk && tile >= tiles) break;  // the whole warp; no barrier follows
    const long long p[2] = {tile * kRows + g, tile * kRows + g + 8};

    // Input layer on the CUDA cores, per accumulator element (row g + 8 *
    // (e >> 1), column 8j + 2q + (e & 1)).
    typename Tier::Op xo[2][kMaxIn];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int c = 0; c < kMaxIn; ++c)
        xo[rr][c] = Tier::op(p[rr] < n && c < d_in ? x[p[rr] * d_in + c] : 0.f);
    }
    Half a[T];
    Half t[KS][T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      float bias[2];
      load_bias<W>(b_in, j, q, bias);
      float av[4], tv[KS][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1);
        typename Tier::Acc za = Tier::acc(bias[e & 1]);
#pragma unroll
        for (int c = 0; c < kMaxIn; ++c) {
          if (c < d_in) Tier::mac(za, xo[e >> 1][c], s_win[c * NP + col]);
        }
        const float zz = Tier::fin(za);
        av[e] = act_fn<ACT>(zz);
        const float dd = act_deriv<ACT>(zz, av[e]);
#pragma unroll
        for (int k = 0; k < K; ++k) tv[k][e] = seed(s_win[k * NP + col]) * dd;
      }
      a[j] = make_half<S>(av[0], av[1], av[2], av[3]);
#pragma unroll
      for (int k = 0; k < K; ++k) t[k][j] = make_half<S>(tv[k][0], tv[k][1], tv[k][2], tv[k][3]);
    }

    // Hidden stack, from shared memory: all of it, or chunk by chunk.
    for (int l0 = 0; l0 < n_stack; l0 += chunk) {
      const int nl = min(chunk, n_stack - l0);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk is no longer read
        stage_hidden<S, W>(s_wh, w_h + static_cast<size_t>(l0) * W * W, nl);
        __syncthreads();
      }
#pragma unroll 1
      for (int l = 0; l < nl; ++l) {
        hidden_layer<Tier, W, ACT, K>(s_wh + static_cast<size_t>(l) * T * kTileWords,
                                      b_h + static_cast<size_t>(l0 + l) * W, lane, a, t);
      }
    }

    // Output layer: one 8-column tile (outputs 2q, 2q + 1 of rows g, g + 8).
    BWord bo[1][T];
    load_tile_b<S, T>(s_wout, lane, bo[0]);
    float binit[1][2];
    binit[0][0] = 2 * q < d_out ? __ldg(b_out + 2 * q) : 0.f;
    binit[0][1] = 2 * q + 1 < d_out ? __ldg(b_out + 2 * q + 1) : 0.f;
    const float zero[1][2] = {};
    float yo[1][4];
    float dyo[KS][1][4];
    product<S, 1, T>(yo, a, bo, binit);
#pragma unroll
    for (int k = 0; k < K; ++k) product<S, 1, T>(dyo[k], t[k], bo, zero);

    if constexpr (EPI) {
      // (U, V) on lane q = 0 (columns 0, 1), h on lane q = 1 (column 2)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float h = __shfl_down_sync(0xffffffffu, yo[0][2 * rr], 1);
        const float h_x = __shfl_down_sync(0xffffffffu, dyo[0][0][2 * rr], 1);
        const float h_y = __shfl_down_sync(0xffffffffu, dyo[1][0][2 * rr], 1);
        if (q == 0 && p[rr] < n) {
          const float U = yo[0][2 * rr], V = yo[0][2 * rr + 1];
          fc[p[rr]] = (h_x * U + h * dyo[0][0][2 * rr]) + (h_y * V + h * dyo[1][0][2 * rr + 1]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long pp = p[e >> 1];
        const int o = 2 * q + (e & 1);
        if (pp < n && o < d_out) {
          y[pp * d_out + o] = yo[0][e];
#pragma unroll
          for (int k = 0; k < K; ++k) dy[(static_cast<long long>(k) * n + pp) * d_out + o] = dyo[k][0][e];
        }
      }
    }
  }
}

template <class Tier, int ACT, int K, bool EPI>
cudaError_t launch(const float* x, const float* w_in, const float* b_in, const float* w_h,
                   const float* b_h, const float* w_out, const float* b_out, float* y, float* dy,
                   float* fc, int n, int d_in, int d_out, int n_stack, int grid, int chunk,
                   size_t smem, cudaStream_t stream) {
  auto kernel = k2_mma_kernel<Tier, K2_WIDTH, ACT, K, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * warps<Tier, K2_WIDTH>(), smem, stream>>>(x, w_in, b_in, w_h, b_h, w_out, b_out, y,
                                                     dy, fc, n, d_in, d_out, n_stack, chunk);
  return cudaGetLastError();
}

// One launch with the plan's grid and chunk (ops/k2_plan.py).
template <class Tier>
int run(const float* x, const float* w_in, const float* b_in, const float* w_h,
        const float* b_h, const float* w_out, const float* b_out, float* y, float* dy,
        float* fc, int n, int d_in, int d_out, int n_stack, int n_tangents, int act,
        int epilogue, int grid, int chunk, void* stream) {
  if (n <= 0 || d_in < 1 || d_in > kMaxIn || d_out < 1 || d_out > kMaxOut || n_tangents < 0 ||
      n_tangents > 3 || n_tangents > d_in || n_stack < 0 || (act != 0 && act != 1) ||
      (epilogue && (n_tangents != 2 || d_out != 3)) || grid < 1 || chunk < 0 ||
      (n_stack > 0 && chunk < 1))
    return cudaErrorInvalidValue;
  chunk = chunk < n_stack ? chunk : n_stack;
  const size_t smem = smem_bytes(K2_WIDTH, chunk, Tier::kSplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2MMA_ARGS x, w_in, b_in, w_h, b_h, w_out, b_out, y, dy, fc, n, d_in, d_out, n_stack, \
                   grid, chunk, smem, s
  if (epilogue)
    return act == 0 ? launch<Tier, 0, 2, true>(K2MMA_ARGS) : launch<Tier, 1, 2, true>(K2MMA_ARGS);
  switch (n_tangents * 2 + act) {
    case 0: return launch<Tier, 0, 0, false>(K2MMA_ARGS);
    case 1: return launch<Tier, 1, 0, false>(K2MMA_ARGS);
    case 2: return launch<Tier, 0, 1, false>(K2MMA_ARGS);
    case 3: return launch<Tier, 1, 1, false>(K2MMA_ARGS);
    case 4: return launch<Tier, 0, 2, false>(K2MMA_ARGS);
    case 5: return launch<Tier, 1, 2, false>(K2MMA_ARGS);
    case 6: return launch<Tier, 0, 3, false>(K2MMA_ARGS);
    default: return launch<Tier, 1, 3, false>(K2MMA_ARGS);
  }
#undef K2MMA_ARGS
}

}  // namespace k2mma
