// The wide body of K1, K2, K3 and K4: any hidden width W <= 128 and d_in,
// d_out <= 128 at run time, tiers f32, bf16 and f32x3.
//
// The narrow bodies (mlp_fwd_tangents.cu, mlp_bwd_common.cuh) keep a point's
// whole layer vectors in registers, so W is a compile-time constant there and
// at most 32: at W = 128 and K = 3 tangents a point's 512 floats do not fit in
// Hopper's 255 registers per thread, and the walk's reduction buffer holds no
// W*W + W at W >= 58. This body keeps the layer vectors in shared memory
// instead and computes with the width it is given. It replaces the same TPU
// kernels as the narrow bodies, at the shapes those do not take (the Pallas
// kernels take every max(W, d_in, d_out) <= 128, JAX ops/kernels.py:92-97):
//   K2  ops/kernels.py::_mlp_kernel (mlp_fwd_tangents_wide.cu);
//   K1  ops/kernels_step.py::_stats_and_grads (continuity_train_step_wide.cu);
//   K3  ops/kernels_vjp.py::packed_mlp_bwd(impl='stream') (mlp_bwd_wide.cu);
//   K4  ops/kernels_vjp.py::packed_mlp_bwd(impl='rebuild')
//       (mlp_bwd_wide.cu with -DWIDE_REBUILD=1).
// What each computes is what its narrow body computes (ops/tiers.py, the
// headers of those files).
//
// Design. A block of kThreads threads takes a tile of P points (P a multiple
// of 4, chosen per launch by ops/wide_plan.py) and walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... The tile's layer vectors for all
// S = 1 + K streams live in shared memory as [stream][row][point] (rows
// padded to a multiple of 4 with zeros, each row P + kPad floats apart so
// that a quarter-warp's 16-byte loads fall in distinct banks). One layer's
// weights are staged into shared memory at a time, at the tier's type, zero
// outside the real W x W. A layer is a block product: out[s][o][p] =
// sum_c in[s][c][p] * M[c][o]; each thread takes 4 outputs x 4 points of
// every stream in registers (one weight load feeds 4*S products) and loops
// over c at run time (no unrolling over the width). The padded neurons have
// zero weights and biases, so their activations, tangents and cotangents
// are zero (tanh(0) = LeakyReLU(0) = 0) and they add nothing to a real one.
//
// The walk (K1, K3, K4) replays the forward and keeps the layer states (a,
// u^0 .. u^{K-1}; u^k the tangent before the act' scale) in a per-block
// scratch in device memory: every state (StoreAll: K1, K3) or every C-th
// one and the last (Rebuild: K4; the backward re-runs each segment of C
// layers from its checkpoint into C - 1 more slots of the scratch). Then,
// through the output layer, the stack and the input layer, three buffers
// rotate: BAR (the cotangents [abar; tbar^k] of state j+1, then [zbar;
// ubar^k]), CUR (state j+1) and PRV (state j). The weight gradient of a
// layer, sum_{s,p} A[s][i][p] * B[s][j][p] with A = [a; t^k] of state j and
// B = [zbar; ubar^k], is a block product too (4 x 4 entries a thread); each
// block adds its tiles' sums to its own row of the partial buffer (the
// first tile stores), and a second kernel sums the rows in block order: no
// atomics, the same bits from run to run.
//
// Bound on the H100: per point 2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K) FLOPs
// forward and about twice that backward, on the CUDA cores (f32, bf16 and
// the f32x3 tier's three FMAs a product); the states cost 2*(L+1)*(1+K)*W*4
// bytes of device traffic per point (StoreAll), far below the FLOPs' time.
// What the simple design spends beyond the FMAs: one shared-memory operand
// load per product and the weights' staging per tile. Tensor cores at these
// widths are later work (ROADMAP.md).

#pragma once

#include <cuda_runtime.h>

#include "tier.cuh"

namespace wide {

using tier::load_vec;
using tier::w_f;

constexpr int kThreads = 256;  // threads of a block
constexpr int kPad = 4;        // floats past a buffer row's P points
constexpr int kMaxDim = 128;   // W, d_in and d_out at most
constexpr int kMaxTile = 256;  // points of a tile at most
constexpr int kExtraRows = 8;  // the epilogue's per-point rows (K1's statistics)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The shapes of one launch: real sizes, padded rows and the tile.
struct Dims {
  int W, d_in, d_out, n_stack, K;
  int Wp, Ip, Op, R;  // W, d_in, d_out rounded up to 4; R their largest
  int P, ld;          // points of a tile; floats between two rows
  __host__ __device__ int S() const { return 1 + K; }
  __host__ __device__ int sstr() const { return R * ld; }  // floats between streams
};

__host__ __device__ inline Dims make_dims(int W, int d_in, int d_out, int n_stack, int K,
                                          int P) {
  Dims d{W, d_in, d_out, n_stack, K, round4(W), round4(d_in), round4(d_out), 0, P, P + kPad};
  d.R = imax(d.Wp, imax(d.Ip, d.Op));
  return d;
}

// Shared-memory bytes of one launch with `nbuf` buffers of S streams and
// weights of `wt` bytes each (ops/wide_plan.py::smem_bytes computes the same).
inline size_t smem_bytes(const Dims& d, int nbuf, int wt) {
  const size_t w = static_cast<size_t>(imax(d.Wp * d.Wp, imax(d.Ip * d.Wp, d.Wp * d.Op)));
  return tier::align16(w * wt) + tier::align16(static_cast<size_t>(d.R) * 4) +
         static_cast<size_t>(nbuf) * d.S() * d.R * d.ld * 4 +
         static_cast<size_t>(kExtraRows) * d.ld * 4;
}

// Whether a launch's sizes and plan are valid (the wrapper checks first).
inline bool dims_ok(const Dims& d, int n, int grid) {
  return n > 0 && d.W >= 1 && d.W <= kMaxDim && d.d_in >= 1 && d.d_in <= kMaxDim &&
         d.d_out >= 1 && d.d_out <= kMaxDim && d.n_stack >= 0 && d.K >= 0 && d.K <= 3 &&
         d.K <= d.d_in && d.P >= 4 && d.P % 4 == 0 && d.P <= kMaxTile && grid >= 1 &&
         grid <= (n + d.P - 1) / d.P;
}

// The shared-memory regions of a block.
template <class Tier>
struct Smem {
  typename Tier::WT* w;  // one layer's weights
  float* vec;            // its bias
  float* buf[3];         // the stream buffers
  float* extra;          // kExtraRows rows of P points

  __device__ Smem(unsigned char* base, const Dims& d, int nbuf) {
    const size_t wbytes = static_cast<size_t>(imax(d.Wp * d.Wp, imax(d.Ip * d.Wp, d.Wp * d.Op))) *
                          sizeof(typename Tier::WT);
    w = reinterpret_cast<typename Tier::WT*>(base);
    vec = reinterpret_cast<float*>(base + tier::align16(wbytes));
    float* p = vec + tier::align16(static_cast<size_t>(d.R) * 4) / 4;
    for (int b = 0; b < 3; ++b) {
      buf[b] = b < nbuf ? p : nullptr;
      if (b < nbuf) p += static_cast<size_t>(d.S()) * d.sstr();
    }
    extra = p;
  }
};

template <int ACT>
__device__ __forceinline__ float act(float z) {
  if constexpr (ACT == 0) {
    return tanhf(z);
  } else {
    return z >= 0.f ? z : 0.01f * z;
  }
}

// act' from the activation (for LeakyReLU sign(a) == sign(z)).
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

// Stage the row-major (rows x cols) matrix src into dst as (Rr x Rc) at the
// tier's type, zero outside the real entries; transposed (dst[c][r] =
// src[r][c]) when `trans`. Block-strided.
template <class Tier>
__device__ void stage(typename Tier::WT* __restrict__ dst, const float* __restrict__ src,
                      int rows, int cols, int Rr, int Rc, bool trans) {
  const int n = Rr * Rc;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / Rc, c = e % Rc;  // dst row r, column c
    const int sr = trans ? c : r, sc = trans ? r : c;
    const bool live = trans ? (sr < rows && sc < cols) : (r < rows && c < cols);
    dst[e] = Tier::to_w(live ? src[static_cast<size_t>(sr) * cols + sc] : 0.f);
  }
}

// A vector of n real floats into dst[0, Rn), zero past n.
__device__ void stage_vec(float* __restrict__ dst, const float* __restrict__ src, int n,
                          int Rn) {
  for (int e = threadIdx.x; e < Rn; e += blockDim.x) dst[e] = (src && e < n) ? src[e] : 0.f;
}

// The block product out[s][o][p] = sum_{c < C} in[s][c][p] * M[c][o] for S
// streams, o < Oc (a multiple of 4), p < P; M is C x Oc at the tier's type.
// The bias, if any, starts stream 0's sums (JAX adds it after the product:
// a roundoff-level difference, as in the narrow bodies).
template <class Tier, int S>
__device__ void product(const float* __restrict__ in, int C, const typename Tier::WT* __restrict__ M,
                        int Oc, float* __restrict__ out, const float* __restrict__ bias,
                        const Dims& d) {
  const int pblocks = d.P / 4, nob = (Oc / 4) * pblocks, ld = d.ld, sstr = d.sstr();
  for (int ob = threadIdx.x; ob < nob; ob += blockDim.x) {
    const int p0 = (ob % pblocks) * 4, o0 = (ob / pblocks) * 4;
    typename Tier::Acc acc[S][4][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int oo = 0; oo < 4; ++oo)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          acc[s][oo][pp] = Tier::acc((s == 0 && bias) ? bias[o0 + oo] : 0.f);
    for (int c = 0; c < C; ++c) {
      typename Tier::WV w[4];
      load_vec<4>(M + static_cast<size_t>(c) * Oc + o0, w);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[4];
        load_vec<4>(in + s * sstr + c * ld + p0, x);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const typename Tier::Op op = Tier::op(x[pp]);
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) Tier::mac(acc[s][oo][pp], op, w[oo]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int oo = 0; oo < 4; ++oo) {
        float4 v;
        v.x = Tier::fin(acc[s][oo][0]);
        v.y = Tier::fin(acc[s][oo][1]);
        v.z = Tier::fin(acc[s][oo][2]);
        v.w = Tier::fin(acc[s][oo][3]);
        *reinterpret_cast<float4*>(out + s * sstr + (o0 + oo) * ld + p0) = v;
      }
  }
}

// The weight-gradient product's sums: f32 at f32 and bf16; at f32x3 both
// runtime operands split, (a_lo b_hi + a_hi b_lo) + a_hi b_hi (ops/tiers.py
// mm_tn).
template <class Tier>
struct WG {
  using Acc = float;
  static __device__ __forceinline__ Acc zero() { return 0.f; }
  static __device__ __forceinline__ void mac(Acc& c, float a, float b) { c = fmaf(a, b, c); }
  static __device__ __forceinline__ float fin(Acc c) { return c; }
};

template <>
struct WG<tier::TierF32x3> {
  using Acc = tier::Acc3;
  static __device__ __forceinline__ Acc zero() { return {0.f, 0.f}; }
  static __device__ __forceinline__ void mac(Acc& c, float a, float b) {
    const tier::Pair x = tier::split(a), y = tier::split(b);
    c.cross = fmaf(x.lo, y.hi, c.cross);
    c.cross = fmaf(x.hi, y.lo, c.cross);
    c.main = fmaf(x.hi, y.hi, c.main);
  }
  static __device__ __forceinline__ float fin(Acc c) { return c.cross + c.main; }
};

__device__ __forceinline__ float accumulate(const float* dst, float v, bool first) {
  return first ? v : *dst + v;
}

// G[i][j] (+)= sum_{s < S} sum_p A_s[i][p] * B[s][j][p] for i < Ri, j < Rj
// (multiples of 4), written for the real i < ni, j < nj into G (row stride
// nj); A_s are S row-major [row][point] operands (stride ld), B the
// stream buffer. `seed`: K rows of ubar whose point sums add to G's rows
// k < K (the input layer's tangent-seed term, f32); null elsewhere.
template <class Tier, int S>
__device__ void weight_grad(const float* const (&A)[S], int Ri, int ni, const float* __restrict__ B,
                            int Rj, int nj, const float* __restrict__ seed, int K,
                            float* __restrict__ G, bool first, const Dims& d) {
  using wg = WG<Tier>;
  const int jblocks = Rj / 4, nb = (Ri / 4) * jblocks, ld = d.ld, sstr = d.sstr();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int i0 = (b / jblocks) * 4, j0 = (b % jblocks) * 4;
    typename wg::Acc acc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = wg::zero();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* a_s = A[s];
      const float* b_s = B + s * sstr;
      for (int p = 0; p < d.P; p += 4) {
        float av[4][4], bv[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) load_vec<4>(a_s + (i0 + ii) * ld + p, av[ii]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) load_vec<4>(b_s + (j0 + jj) * ld + p, bv[jj]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) wg::mac(acc[ii][jj], av[ii][q], bv[jj][q]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = i0 + ii;
      if (i >= ni) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j >= nj) continue;
        float v = wg::fin(acc[ii][jj]);
        if (seed && i < K) {
          float t = 0.f;
          for (int p = 0; p < d.P; ++p) t += seed[i * sstr + j * ld + p];
          v += t;
        }
        float* g = G + static_cast<size_t>(i) * nj + j;
        *g = accumulate(g, v, first);
      }
    }
  }
}

// g[j] (+)= sum_p buf[j][p] for the real j < n (a bias gradient).
__device__ void bias_grad(const float* __restrict__ buf, int n, float* __restrict__ g, bool first,
                          const Dims& d) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float t = 0.f;
    for (int p = 0; p < d.P; ++p) t += buf[j * d.ld + p];
    g[j] = accumulate(g + j, t, first);
  }
}

// The per-launch constants and pointers of a forward or a walk.
struct Args {
  const float *coords, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  float *partial, *states;  // the walk's partial rows and state scratch
  int n, W, d_in, d_out, n_stack, tile, ckpt_every;
};

__host__ __device__ inline Dims dims_of(const Args& a, int K) {
  return make_dims(a.W, a.d_in, a.d_out, a.n_stack, K, a.tile);
}

// The tile's coordinates into rows [0, Ip) of stream 0 of buf (zero past
// d_in and past the last point).
__device__ void load_coords(float* __restrict__ buf, const Args& g, long long p_base, int nv,
                            const Dims& d) {
  for (int e = threadIdx.x; e < d.Ip * d.P; e += blockDim.x) {
    const int c = e / d.P, p = e % d.P;
    buf[c * d.ld + p] =
        (c < d.d_in && p < nv) ? g.coords[(p_base + p) * d.d_in + c] : 0.f;
  }
}

// The state scratch of this block's slot `slot`: [stream][Wp][P], compact.
__device__ __forceinline__ float* state_ptr(const Args& g, const Dims& d, int slots, int slot) {
  const size_t per = static_cast<size_t>(d.S()) * d.Wp * d.P;
  return g.states + (static_cast<size_t>(blockIdx.x) * slots + slot) * per;
}

__device__ void store_state(const float* __restrict__ buf, float* __restrict__ st, const Dims& d,
                            int S) {
  const int n = d.Wp * d.P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / d.P, p = e % d.P;
    for (int s = 0; s < S; ++s) st[static_cast<size_t>(s) * n + e] = buf[s * d.sstr() + i * d.ld + p];
  }
}

__device__ void load_state(float* __restrict__ buf, const float* __restrict__ st, const Dims& d,
                           int S) {
  const int n = d.Wp * d.P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / d.P, p = e % d.P;
    for (int s = 0; s < S; ++s) buf[s * d.sstr() + i * d.ld + p] = st[static_cast<size_t>(s) * n + e];
  }
}

// A state [a; u^k] in buf as the next layer's operands [a; t^k], t = u*act'(a).
template <int ACT, int K>
__device__ void to_operands(float* __restrict__ buf, const Dims& d) {
  const int n = d.Wp * d.P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int o = (e / d.P) * d.ld + e % d.P;
    const float da = dact<ACT>(buf[o]);
#pragma unroll
    for (int k = 1; k <= K; ++k) buf[k * d.sstr() + o] *= da;
  }
}

// The input layer's state from z in stream 0 of buf: a = act(z), u^k = the
// tier's w_in[k][i] (the tangent seeds).
template <class Tier, int ACT, int K>
__device__ void input_state(float* __restrict__ buf, const Args& g, const Dims& d) {
  const int n = d.Wp * d.P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / d.P, o = i * d.ld + e % d.P;
    buf[o] = act<ACT>(buf[o]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      buf[(k + 1) * d.sstr() + o] =
          i < d.W ? w_f(Tier::to_w(g.w_in[static_cast<size_t>(k) * d.W + i])) : 0.f;
  }
}

// One hidden layer's state from [z; u^k] in buf: a = act(z) (the bias is in
// z already).
template <int ACT>
__device__ void hidden_state(float* __restrict__ buf, const Dims& d) {
  const int n = d.Wp * d.P;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int o = (e / d.P) * d.ld + e % d.P;
    buf[o] = act<ACT>(buf[o]);
  }
}

// The policies of the walk's state scratch (header).
struct StoreAll {
  static constexpr bool kRebuild = false;
  static __host__ __device__ __forceinline__ int slots(int L, int) { return L + 1; }
  static __device__ __forceinline__ bool keeps(int, int, int) { return true; }
  static __device__ __forceinline__ int slot(int s, int, int) { return s; }
};

struct Rebuild {
  static constexpr bool kRebuild = true;
  // checkpoints 0, C, .. below L (ceil(L/C) of them), then L, then C - 1
  // segment slots
  static __host__ __device__ __forceinline__ int checkpoints(int L, int C) {
    return (L + C - 1) / C;
  }
  static __host__ __device__ __forceinline__ int slots(int L, int C) {
    return checkpoints(L, C) + C;
  }
  static __device__ __forceinline__ bool keeps(int s, int L, int C) {
    return s == L || s % C == 0;
  }
  static __device__ __forceinline__ int slot(int s, int L, int C) {
    const int m = checkpoints(L, C);
    return s == L ? m : (s % C == 0 ? s / C : m + s % C);
  }
};

// K3's policy (0) or K4's (1), by a compile-time flag.
template <int REBUILD>
struct PolicyOf {
  using type = StoreAll;
};
template <>
struct PolicyOf<1> {
  using type = Rebuild;
};
template <int REBUILD>
using Policy = typename PolicyOf<REBUILD>::type;

// Which states a forward writes to the scratch: none (K2), those the policy
// keeps (the walk's replay), or every one (K4's re-run of a segment).
enum Store { kNone, kKept, kAll };

// The forward of layers [l0, l1) from the operands [a; t^k] of state l0 in
// *X, leaving the operands of state l1 in *X (X and Y swap each layer);
// state l+1 goes to its slot of the scratch as `store` says.
template <class Tier, class Policy, int ACT, int K>
__device__ void hidden_forward(float*& X, float*& Y, int l0, int l1, const Args& g,
                               const Dims& d, Smem<Tier>& sm, Store store) {
  constexpr int S = 1 + K;
  const int L = d.n_stack, C = g.ckpt_every, slots = Policy::slots(L, C);
  for (int l = l0; l < l1; ++l) {
    stage<Tier>(sm.w, g.w_h + static_cast<size_t>(l) * d.W * d.W, d.W, d.W, d.Wp, d.Wp, false);
    stage_vec(sm.vec, g.b_h + static_cast<size_t>(l) * d.W, d.W, d.Wp);
    __syncthreads();
    product<Tier, S>(X, d.Wp, sm.w, d.Wp, Y, sm.vec, d);
    __syncthreads();
    hidden_state<ACT>(Y, d);
    if (store == kAll || (store == kKept && Policy::keeps(l + 1, L, C))) {
      __syncthreads();
      store_state(Y, state_ptr(g, d, slots, Policy::slot(l + 1, L, C)), d, S);
    }
    __syncthreads();
    to_operands<ACT, K>(Y, d);
    __syncthreads();
    float* t = X;
    X = Y;
    Y = t;
  }
}

// The forward of one tile up to the output layer's [y; dy^k], rows [0, Op)
// of *Y; *X holds the operands of the last state. The walk stores states.
template <class Tier, class Policy, int ACT, int K>
__device__ void forward_tile(float*& X, float*& Y, long long p_base, int nv, const Args& g,
                             const Dims& d, Smem<Tier>& sm, Store store) {
  constexpr int S = 1 + K;
  const int L = d.n_stack, C = g.ckpt_every, slots = Policy::slots(L, C);
  load_coords(X, g, p_base, nv, d);
  stage<Tier>(sm.w, g.w_in, d.d_in, d.W, d.Ip, d.Wp, false);
  stage_vec(sm.vec, g.b_in, d.W, d.Wp);
  __syncthreads();
  product<Tier, 1>(X, d.Ip, sm.w, d.Wp, Y, sm.vec, d);
  __syncthreads();
  input_state<Tier, ACT, K>(Y, g, d);
  if (store == kKept && Policy::keeps(0, L, C)) {
    __syncthreads();
    store_state(Y, state_ptr(g, d, slots, Policy::slot(0, L, C)), d, S);
  }
  __syncthreads();
  to_operands<ACT, K>(Y, d);
  __syncthreads();
  float* t = X;
  X = Y;
  Y = t;
  hidden_forward<Tier, Policy, ACT, K>(X, Y, 0, L, g, d, sm, store);
  stage<Tier>(sm.w, g.w_out, d.W, d.d_out, d.Wp, d.Op, false);
  stage_vec(sm.vec, g.b_out, d.d_out, d.Op);
  __syncthreads();
  product<Tier, S>(X, d.Wp, sm.w, d.Op, Y, sm.vec, d);
  __syncthreads();
}

// K2: the forward of every tile, then y and dy (or the continuity residual
// fc) of its points.
struct FwdArgs {
  Args g;
  float *y, *dy, *fc;
};

template <class Tier, int ACT, int K, bool EPI>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = make_dims(a.g.W, a.g.d_in, a.g.d_out, a.g.n_stack, K, a.g.tile);
  Smem<Tier> sm(smem, d, 2);
  const int tiles = (a.g.n + d.P - 1) / d.P;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p_base = static_cast<long long>(tile) * d.P;
    const int nv = static_cast<int>(a.g.n - p_base < d.P ? a.g.n - p_base : d.P);
    float *X = sm.buf[0], *Y = sm.buf[1];
    forward_tile<Tier, StoreAll, ACT, K>(X, Y, p_base, nv, a.g, d, sm, kNone);
    const int sstr = d.sstr();
    if constexpr (EPI) {
      // fc = (h_x*U + h*U_x) + (h_y*V + h*V_y), heads (U, V, h), tangents (x, y)
      for (int p = threadIdx.x; p < nv; p += blockDim.x) {
        const float U = Y[p], V = Y[d.ld + p], h = Y[2 * d.ld + p];
        const float Ux = Y[sstr + p], hx = Y[sstr + 2 * d.ld + p];
        const float Vy = Y[2 * sstr + d.ld + p], hy = Y[2 * sstr + 2 * d.ld + p];
        a.fc[p_base + p] = (hx * U + h * Ux) + (hy * V + h * Vy);
      }
    } else {
      const int n_out = nv * d.d_out;
      for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
        const int p = e / d.d_out, o = e % d.d_out;
        a.y[p_base * d.d_out + e] = Y[o * d.ld + p];
#pragma unroll
        for (int k = 0; k < K; ++k)
          a.dy[(static_cast<long long>(k) * a.g.n + p_base) * d.d_out + e] =
              Y[(k + 1) * sstr + o * d.ld + p];
      }
    }
    __syncthreads();  // the buffers are staged again for the next tile
  }
}

// The walk's offsets of the parameter gradients in a partial row, in the
// parameters' sorted-key order (b_hidden, b_in, b_out, w_hidden, w_in, w_out).
struct Offsets {
  long long bh, bin, bout, wh, win, wout, end;
  __host__ __device__ explicit Offsets(const Dims& d) {
    bh = 0;
    bin = bh + static_cast<long long>(d.n_stack) * d.W;
    bout = bin + d.W;
    wh = bout + d.d_out;
    win = wh + static_cast<long long>(d.n_stack) * d.W * d.W;
    wout = win + static_cast<long long>(d.d_in) * d.W;
    end = wout + static_cast<long long>(d.W) * d.d_out;
  }
};

// One tile's walk: the forward (states to the scratch), the epilogue's
// output cotangents in rows [0, Op) of BAR, then the backward into the
// block's partial row `row` (the first tile stores). `epi.output(Y, ...)`
// turns [y; dy^k] into [ybar; ybar^k] in place (K1) or loads them (K3, K4).
template <class Tier, class Policy, int ACT, int K, class Epi>
__device__ void walk_tile(long long p_base, int nv, bool first, const Args& g, const Dims& d,
                          Smem<Tier>& sm, Epi& epi, float* __restrict__ row) {
  constexpr int S = 1 + K;
  const int L = d.n_stack, C = g.ckpt_every, slots = Policy::slots(L, C);
  const Offsets off(d);
  float *X = sm.buf[0], *Y = sm.buf[1];
  forward_tile<Tier, Policy, ACT, K>(X, Y, p_base, nv, g, d, sm, kKept);
  epi.output(Y, p_base, nv, d, sm.extra, row + off.end, first);
  __syncthreads();
  // ---- the output layer: X = [a_L; t_L^k], Y = [ybar; ybar^k]
  {
    const float* A[S];
#pragma unroll
    for (int s = 0; s < S; ++s) A[s] = X + s * d.sstr();
    weight_grad<Tier, S>(A, d.Wp, d.W, Y, d.Op, d.d_out, nullptr, 0, row + off.wout, first, d);
    bias_grad(Y, d.d_out, row + off.bout, first, d);
  }
  stage<Tier>(sm.w, g.w_out, d.W, d.d_out, d.Op, d.Wp, true);
  __syncthreads();
  product<Tier, S>(Y, d.Op, sm.w, d.Wp, X, nullptr, d);  // [abar; tbar^k] of state L
  __syncthreads();
  float *BAR = X, *CUR = Y, *PRV = sm.buf[2];
  load_state(CUR, state_ptr(g, d, slots, Policy::slot(L, L, C)), d, S);
  __syncthreads();
  for (int j = L - 1; j >= 0; --j) {
    if constexpr (Policy::kRebuild) {
      // the top of a segment: re-run it from its checkpoint m*C into the
      // segment slots (states m*C+1 .. j), then state j+1 back into CUR
      const int m0 = (j / C) * C;
      if ((j == L - 1 || (j + 1) % C == 0) && j > m0) {
        float *RX = CUR, *RY = PRV;
        load_state(RX, state_ptr(g, d, slots, Policy::slot(m0, L, C)), d, S);
        __syncthreads();
        to_operands<ACT, K>(RX, d);
        __syncthreads();
        hidden_forward<Tier, Policy, ACT, K>(RX, RY, m0, j, g, d, sm, kAll);
        load_state(CUR, state_ptr(g, d, slots, Policy::slot(j + 1, L, C)), d, S);
      }
    }
    load_state(PRV, state_ptr(g, d, slots, Policy::slot(j, L, C)), d, S);
    __syncthreads();
    // [abar; tbar^k] -> [zbar; ubar^k] with state j+1 in CUR
    const int n = d.Wp * d.P, sstr = d.sstr();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int o = (e / d.P) * d.ld + e % d.P;
      const float a = CUR[o], da = dact<ACT>(a);
      float dbar = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dbar += BAR[(k + 1) * sstr + o] * CUR[(k + 1) * sstr + o];
      BAR[o] = (BAR[o] + ddact<ACT>(a, dbar)) * da;
#pragma unroll
      for (int k = 0; k < K; ++k) BAR[(k + 1) * sstr + o] *= da;
    }
    __syncthreads();
    // t^k of state j into CUR's tangent streams (CUR's a is not needed again)
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int o = (e / d.P) * d.ld + e % d.P;
      const float da = dact<ACT>(PRV[o]);
#pragma unroll
      for (int k = 1; k <= K; ++k) CUR[k * sstr + o] = PRV[k * sstr + o] * da;
    }
    stage<Tier>(sm.w, g.w_h + static_cast<size_t>(j) * d.W * d.W, d.W, d.W, d.Wp, d.Wp, true);
    __syncthreads();
    {
      const float* A[S];
      A[0] = PRV;
#pragma unroll
      for (int s = 1; s < S; ++s) A[s] = CUR + s * sstr;
      weight_grad<Tier, S>(A, d.Wp, d.W, BAR, d.Wp, d.W, nullptr, 0,
                           row + off.wh + static_cast<long long>(j) * d.W * d.W, first, d);
      bias_grad(BAR, d.W, row + off.bh + static_cast<long long>(j) * d.W, first, d);
    }
    __syncthreads();
    product<Tier, S>(BAR, d.Wp, sm.w, d.Wp, CUR, nullptr, d);  // the cotangents of state j
    __syncthreads();
    float* t = BAR;
    BAR = CUR;
    CUR = PRV;
    PRV = t;
  }
  // ---- the input layer: CUR = state 0
  {
    const int n = d.Wp * d.P, sstr = d.sstr();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int o = (e / d.P) * d.ld + e % d.P;
      const float a = CUR[o], da = dact<ACT>(a);
      float dbar = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dbar += BAR[(k + 1) * sstr + o] * CUR[(k + 1) * sstr + o];
      BAR[o] = (BAR[o] + ddact<ACT>(a, dbar)) * da;
#pragma unroll
      for (int k = 0; k < K; ++k) BAR[(k + 1) * sstr + o] *= da;
    }
  }
  load_coords(PRV, g, p_base, nv, d);
  __syncthreads();
  {
    const float* A[1] = {PRV};
    weight_grad<Tier, 1>(A, d.Ip, d.d_in, BAR, d.Wp, d.W, BAR + d.sstr(), K, row + off.win,
                         first, d);
    bias_grad(BAR, d.W, row + off.bin, first, d);
  }
  __syncthreads();  // the buffers are staged again for the next tile
}

template <class Tier, class Policy, int ACT, int K, class Epi>
__device__ void walk(const Args& g, Epi& epi, unsigned char* smem, long long n_ent) {
  const Dims d = dims_of(g, K);
  Smem<Tier> sm(smem, d, 3);
  float* row = g.partial + static_cast<long long>(blockIdx.x) * n_ent;
  const int tiles = (g.n + d.P - 1) / d.P;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p_base = static_cast<long long>(tile) * d.P;
    const int nv = static_cast<int>(g.n - p_base < d.P ? g.n - p_base : d.P);
    walk_tile<Tier, Policy, ACT, K>(p_base, nv, tile == static_cast<int>(blockIdx.x), g, d, sm,
                                    epi, row);
  }
}

// The epilogue of K3 and K4: ybar (N, d_out) and dybar (K, N, d_out) of the
// tile's points into rows [0, Op) of the buffer, zero past d_out and past N.
struct LoadedCotangents {
  const float *ybar, *dybar;
  int n, K;

  __device__ void output(float* __restrict__ Y, long long p_base, int nv, const Dims& d, float*,
                         float*, bool) const {
    const int cnt = d.Op * d.P;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int p = e / d.Op, o = e % d.Op;
      const bool live = p < nv && o < d.d_out;
      Y[o * d.ld + p] = live ? ybar[(p_base + p) * d.d_out + o] : 0.f;
      for (int k = 0; k < K; ++k)
        Y[(k + 1) * d.sstr() + o * d.ld + p] =
            live ? dybar[(static_cast<long long>(k) * n + p_base + p) * d.d_out + o] : 0.f;
    }
  }
};

struct CotangentArgs {
  Args g;
  const float *ybar, *dybar;
};

template <class Tier, class Policy, int ACT, int K>
__global__ void __launch_bounds__(kThreads) cotangent_kernel(const CotangentArgs a,
                                                             long long n_ent) {
  extern __shared__ __align__(16) unsigned char smem[];
  LoadedCotangents epi{a.ybar, a.dybar, a.g.n, K};
  walk<Tier, Policy, ACT, K>(a.g, epi, smem, n_ent);
}

// out[e] = sum over blocks b, in order, of partial[b][e]: the fixed order
// keeps the gradients deterministic.
__global__ void reduce_kernel(const float* __restrict__ partial, int blocks, long long n_ent,
                              float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_ent) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * n_ent + e];
  out[e] = s;
}

// Set the kernel's dynamic shared memory, launch it on `grid` blocks, then
// (for a walk, `out` not null) the fixed-order sum of its partial rows.
template <class Kernel, class... KArgs>
cudaError_t launch(Kernel kernel, size_t smem, int grid, cudaStream_t stream, const float* partial,
                   float* out, long long n_ent, KArgs... kargs) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(kargs...);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  const long long blocks = (n_ent + 255) / 256;
  reduce_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(partial, grid, n_ent, out);
  return cudaGetLastError();
}

// Bytes of one weight in shared memory at the tier.
template <class Tier>
constexpr int wt_bytes() {
  return static_cast<int>(sizeof(typename Tier::WT));
}

}  // namespace wide
