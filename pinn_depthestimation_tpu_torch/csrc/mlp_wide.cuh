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
// Layout. A block of kThreads threads (8 warps) takes a tile of P points (P
// a multiple of 16, chosen per launch by ops/wide_plan.py) and walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... The tile's layer vectors for
// all S = 1 + K streams live in shared memory as [stream][row][point], rows
// padded to a multiple of 16 with zeros, each row ld = P + 4 floats apart:
// ld / 4 is odd, so the rows of any 4 or 8 consecutive row indices start in
// distinct 16-byte bank groups (tests/test_torch_wide_plan.py counts the
// banks of every load below at every planned ld). A layer is a block
// product out[s][m][p] = sum_k A[m][k] * in[s][k][p], A the layer's weights
// (A = W^T forward, A = W for the cotangents); the padded neurons have zero
// weights and biases, so their activations, tangents and cotangents are
// zero (tanh(0) = LeakyReLU(0) = 0) and they add nothing to a real one.
//
// Weight images. A first kernel (images_kernel) writes every layer's A once
// per launch into device scratch at the tier's type and in the order the
// products read it: forward (W^T) and transposed (W) images of every layer,
// zero outside the real sizes, the bias after the weights. f32: rows of k,
// m contiguous. bf16: the m16n8k16 A fragments, one 16-byte word of four
// bf16x2 a lane per 16x16 block. f32x3: the same for the hi and for the lo
// halves, a block's hi words then its lo words. A product stages its image
// by 16-byte cp.async into two shared-memory slots, its k-tiles split in two
// chunks: chunk 1 lands while chunk 0 is multiplied, and the next product's
// chunk 0 (then chunk 1) while this one's chunk 1 (then its epilogue and
// the elementwise work between products) runs (struct Pipe). So no layer
// reads a weight from device memory with a thread, none is transposed with
// strided loads, and the staging overlaps the products.
//
// Products. f32: CUDA cores, a thread per 4 outputs x 4 points of every
// stream (one weight load feeds 4*S FMAs), k in order from the bias, as the
// narrow bodies sum. bf16 and f32x3: a warp per 32 outputs x 16 points of
// every stream on mma.sync m16n8k16 (bf16 operands, f32 sums), the weights
// the A operand (one 16-byte shared load per fragment, no conflict), the
// activations the B operand (four 4-byte loads, rounded with
// cvt.rn.bf16x2.f32; at f32x3 split into hi = rn(x), lo = rn(x - hi)), the
// f32x3 sums kept as the cross terms (x_lo w_hi + x_hi w_lo) and the main
// term x_hi w_hi, added at the end (Tier::fin). The epilogue of a product
// runs on its accumulators: the activation, the layer state to the device
// scratch and the next layer's operands [a; u * act'(a)] in one pass.
//
// The walk (K1, K3, K4) replays the forward and keeps the layer states (a,
// u^0 .. u^{K-1}; u^k the tangent before the act' scale) in a per-block
// scratch in device memory: every state (StoreAll: K1, K3) or every C-th
// one and the last (Rebuild: K4; the backward re-runs each segment of C
// layers from its checkpoint into C - 1 more slots of the scratch). Then,
// through the output layer, the stack and the input layer, three buffers
// rotate: BAR (the cotangents [abar; tbar^k] of state j+1, then [zbar;
// ubar^k]), CUR (state j+1) and PRV (state j). One elementwise pass per
// layer turns BAR into [zbar; ubar^k], reads state j from the scratch and
// forms the weight gradient's operands. The weight gradient G[i][j] =
// sum_{s,p} A[s][i][p] * B[s][j][p] (A = [a; t^k] of state j, B = [zbar;
// ubar^k]): f32 and bf16 on the CUDA cores (the bf16 tier keeps it f32),
// each lane 8 x 8 entries (4 x 4 below 128 x 128 outputs), its rows 4 and
// its columns 8 apart so that a warp's 16-byte loads meet no bank twice
// (four rows, then eight), 16 FMAs a load; f32x3 on mma.sync with both
// operands split (ops/tiers.py mm_tn). Each block adds its tiles' sums to
// its own row of the partial buffer (the first tile stores), and a second
// kernel sums the rows in block order: no atomics, the same bits from run to
// run. Latency: a weight gradient prefetches the partial-row entries it
// adds to into L2 when its warp tile starts and loads them all before its
// first store (a store may alias a later load, so interleaved they would
// wait on device memory one by one); each backward step prefetches the
// state the next step reads into L2 while its own products run.
//
// Bound on the H100 (PERF.md, section 6): per point 2*(d_in*W + (L-1)*W^2 +
// W*d_out)*(1+K) FLOPs forward and about twice that backward. f32: all on
// the CUDA cores' FMA rate. bf16: the products on the tensor cores, the
// weight gradients (a third of the FLOPs) on the f32 FMA rate, which binds.
// f32x3: three bf16 products of each on the tensor cores. The states cost
// 2*(L+1)*(1+K)*W*4 bytes of device traffic per point (StoreAll) and the
// partial rows W^2*4 bytes per layer and tile, below the FLOPs' time at f32
// and within it at bf16. On 2->[128]x100->3 the walk reaches 44 % of the
// f32 bound and 23 % of the bf16 one (the f32 weight gradient binds there);
// tools/walk_breakdown.py --wide splits its time (PERF.md, section 5).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tier.cuh"

namespace wide {

using tier::load_vec;
using tier::w_f;

constexpr int kThreads = 256;  // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;        // floats past a buffer row's P points
constexpr int kRound = 16;     // rows (W, d_in, d_out) and tiles round to this
constexpr int kMaxDim = 128;   // W, d_in and d_out at most
constexpr int kMaxTile = 256;  // points of a tile at most

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The shapes of one launch: real sizes, padded rows and the tile.
struct Dims {
  int W, d_in, d_out, n_stack, K;
  int Wp, Ip, Op, R;  // W, d_in, d_out rounded up to 16; R their largest
  int P, ld;          // points of a tile; floats between two rows
  __host__ __device__ int S() const { return 1 + K; }
  __host__ __device__ int sstr() const { return R * ld; }  // floats between streams
};

__host__ __device__ inline Dims make_dims(int W, int d_in, int d_out, int n_stack, int K,
                                          int P) {
  Dims d{W, d_in, d_out, n_stack, K, round16(W), round16(d_in), round16(d_out), 0, P, P + kPad};
  d.R = imax(d.Wp, imax(d.Ip, d.Op));
  return d;
}

// ---------------------------------------------------------------- images

// The images of a launch, in the order a tile's products use them:
// 0 the input layer (A = w_in^T), 1 + l hidden layer l (w_h[l]^T), L + 1 the
// output layer (w_out^T); then, for a walk, L + 2 the output layer's
// transpose (A = w_out) and L + 3 + l hidden layer l's (w_h[l]).
__host__ __device__ inline int img_in() { return 0; }
__host__ __device__ inline int img_fwd(int l) { return 1 + l; }
__host__ __device__ inline int img_out(const Dims& d) { return d.n_stack + 1; }
__host__ __device__ inline int img_bwd_out(const Dims& d) { return d.n_stack + 2; }
__host__ __device__ inline int img_bwd(const Dims& d, int l) { return d.n_stack + 3 + l; }
__host__ __device__ inline int n_images(const Dims& d, bool walk) {
  return walk ? 2 * d.n_stack + 3 : d.n_stack + 2;
}

// An image's k (input) and m (output) extents, padded.
struct Shape {
  int Kp, Mp;
};

__host__ __device__ inline Shape img_shape(const Dims& d, int idx) {
  if (idx == img_in()) return {d.Ip, d.Wp};
  if (idx == img_out(d)) return {d.Wp, d.Op};
  if (idx == img_bwd_out(d)) return {d.Op, d.Wp};
  return {d.Wp, d.Wp};
}

// Bytes of one weight of an image at the tier.
template <class Tier>
__host__ __device__ constexpr int wt_bytes() {
  return static_cast<int>(sizeof(typename Tier::WT));
}

// The k-tiles of chunk 0 (chunk 1 has the rest).
__host__ __device__ inline int chunk0_ktiles(int Kp) { return (Kp / 16 + 1) / 2; }

// Weight bytes of an image's largest shape and of a shared-memory slot
// (its largest chunk).
__host__ __device__ inline size_t max_weight_elems(const Dims& d) {
  return static_cast<size_t>(imax(d.Wp * d.Wp, imax(d.Ip * d.Wp, d.Wp * d.Op)));
}

__host__ __device__ inline size_t slot_elems(const Dims& d) {
  const Shape s[4] = {{d.Ip, d.Wp}, {d.Wp, d.Wp}, {d.Wp, d.Op}, {d.Op, d.Wp}};
  size_t m = 0;
  for (const Shape& x : s) {
    const size_t e = static_cast<size_t>(16 * chunk0_ktiles(x.Kp)) * x.Mp;
    m = e > m ? e : m;
  }
  return m;
}

// Bytes between two images in the scratch: the weights, then R floats of
// bias (the forward images' bias; zero in the transposed ones).
template <class Tier>
__host__ __device__ inline size_t img_stride(const Dims& d) {
  return tier::align16(max_weight_elems(d) * wt_bytes<Tier>()) +
         tier::align16(static_cast<size_t>(d.R) * 4);
}

template <class Tier>
__host__ __device__ inline size_t img_bias_off(const Dims& d) {
  return tier::align16(max_weight_elems(d) * wt_bytes<Tier>());
}

// Bytes of a launch's image scratch (ops/wide_plan.py::image_bytes).
template <class Tier>
inline size_t image_bytes(const Dims& d, bool walk) {
  return static_cast<size_t>(n_images(d, walk)) * img_stride<Tier>(d);
}

// Shared-memory bytes of one launch with `nbuf` buffers of S streams
// (ops/wide_plan.py::smem_bytes computes the same): two weight slots, the
// bias, the buffers.
template <class Tier>
inline size_t smem_bytes(const Dims& d, int nbuf) {
  return 2 * tier::align16(slot_elems(d) * wt_bytes<Tier>()) +
         tier::align16(static_cast<size_t>(d.R) * 4) +
         static_cast<size_t>(nbuf) * d.S() * d.R * d.ld * 4;
}

// Whether a launch's sizes and plan are valid (the wrapper checks first).
inline bool dims_ok(const Dims& d, int n, int grid) {
  return n > 0 && d.W >= 1 && d.W <= kMaxDim && d.d_in >= 1 && d.d_in <= kMaxDim &&
         d.d_out >= 1 && d.d_out <= kMaxDim && d.n_stack >= 0 && d.K >= 0 && d.K <= 3 &&
         d.K <= d.d_in && d.P >= 16 && d.P % 16 == 0 && d.P <= kMaxTile && grid >= 1 &&
         grid <= (n + d.P - 1) / d.P;
}

// The per-launch constants and pointers of a forward or a walk.
struct Args {
  const float *coords, *w_in, *b_in, *w_h, *b_h, *w_out, *b_out;
  unsigned char* image;     // the weight images
  float *partial, *states;  // the walk's partial rows and state scratch
  int n, W, d_in, d_out, n_stack, tile, ckpt_every;
};

__host__ __device__ inline Dims dims_of(const Args& a, int K) {
  return make_dims(a.W, a.d_in, a.d_out, a.n_stack, K, a.tile);
}

// A[m][k] of image idx from the parameters (0 outside the real sizes).
__device__ inline float a_value(const Args& g, const Dims& d, int idx, int m, int k) {
  const int L = d.n_stack, W = d.W;
  if (idx == img_in()) return (m < W && k < d.d_in) ? g.w_in[k * W + m] : 0.f;
  if (idx == img_out(d)) return (m < d.d_out && k < W) ? g.w_out[k * d.d_out + m] : 0.f;
  if (idx == img_bwd_out(d)) return (m < W && k < d.d_out) ? g.w_out[m * d.d_out + k] : 0.f;
  if (idx <= L) {
    const float* w = g.w_h + static_cast<size_t>(idx - 1) * W * W;
    return (m < W && k < W) ? w[k * W + m] : 0.f;
  }
  const float* w = g.w_h + static_cast<size_t>(idx - L - 3) * W * W;
  return (m < W && k < W) ? w[m * W + k] : 0.f;
}

__device__ inline float bias_value(const Args& g, const Dims& d, int idx, int m) {
  if (idx == img_in()) return m < d.W ? g.b_in[m] : 0.f;
  if (idx == img_out(d)) return m < d.d_out ? g.b_out[m] : 0.f;
  if (idx >= 1 && idx <= d.n_stack) return m < d.W ? g.b_h[static_cast<size_t>(idx - 1) * d.W + m] : 0.f;
  return 0.f;
}

// Two floats as a bf16x2 word, rounded to nearest even: `lo` in the lower
// half (the MMA's first element of the pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lower_f(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float upper_f(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// The lo word of a split pair whose hi word is `hi`.
__device__ __forceinline__ uint32_t lo_word(float x0, float x1, uint32_t hi) {
  return pack_bf16x2(x0 - lower_f(hi), x1 - upper_f(hi));
}

// acc += A (16 x 16, row) @ B (16 x 8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma16816(float (&acc)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Image words: f32, element (m, k) at k * Mp + m; bf16, word w of lane
// (g, q) of block (kt, mt) at ((kt * MT + mt) * 32 + lane) * 4 + w, the
// elements (m, k), (m, k + 1) with m = 16 mt + g + 8 (w & 1), k = 16 kt +
// 2 q + 8 (w >> 1); f32x3, the hi words at ((kt * MT + mt) * 64 + lane) *
// 4 + w and the lo words 128 further.
template <class Tier>
__global__ void __launch_bounds__(kThreads) images_kernel(const Args g, const Dims d, int first) {
  const int idx = first + blockIdx.y;
  const Shape sh = img_shape(d, idx);
  unsigned char* base = g.image + static_cast<size_t>(idx) * img_stride<Tier>(d);
  const int stride = blockDim.x * gridDim.x;
  if constexpr (Tier::kSplit || sizeof(typename Tier::WT) == 2) {
    const int MT = sh.Mp / 16, words = sh.Kp * sh.Mp / 2;  // hi words
    uint32_t* out = reinterpret_cast<uint32_t*>(base);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < words; e += stride) {
      const int w = e & 3, lane = (e >> 2) & 31, b = e >> 7;
      const int kt = b / MT, mt = b % MT;
      const int m = 16 * mt + (lane >> 2) + 8 * (w & 1), k = 16 * kt + 2 * (lane & 3) + 8 * (w >> 1);
      const float x0 = a_value(g, d, idx, m, k), x1 = a_value(g, d, idx, m, k + 1);
      const uint32_t hi = pack_bf16x2(x0, x1);
      if constexpr (Tier::kSplit) {
        out[(b * 64 + lane) * 4 + w] = hi;
        out[(b * 64 + 32 + lane) * 4 + w] = lo_word(x0, x1, hi);
      } else {
        out[e] = hi;
      }
    }
  } else {
    float* out = reinterpret_cast<float*>(base);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < sh.Kp * sh.Mp; e += stride)
      out[e] = a_value(g, d, idx, e % sh.Mp, e / sh.Mp);
  }
  float* bias = reinterpret_cast<float*>(base + img_bias_off<Tier>(d));
  if (blockIdx.x == 0)
    for (int m = threadIdx.x; m < sh.Mp; m += blockDim.x) bias[m] = bias_value(g, d, idx, m);
}

// ------------------------------------------------------ shared memory, pipe

// The shared-memory regions of a block.
template <class Tier>
struct Smem {
  unsigned char* slot[2];  // the two weight chunks of the staged image
  float* bias;             // its bias
  float* buf[3];           // the stream buffers

  __device__ Smem(unsigned char* base, const Dims& d, int nbuf) {
    const size_t sb = tier::align16(slot_elems(d) * wt_bytes<Tier>());
    slot[0] = base;
    slot[1] = base + sb;
    bias = reinterpret_cast<float*>(base + 2 * sb);
    float* p = bias + tier::align16(static_cast<size_t>(d.R) * 4) / 4;
    for (int b = 0; b < 3; ++b) {
      buf[b] = b < nbuf ? p : nullptr;
      if (b < nbuf) p += static_cast<size_t>(d.S()) * d.sstr();
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The 128-byte line of device memory at p into L2 (no register, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// `n` floats at p into L2, block-strided by lines.
__device__ __forceinline__ void prefetch_floats(const float* p, size_t n) {
  for (size_t o = static_cast<size_t>(threadIdx.x) * 32; o < n; o += kThreads * 32)
    prefetch_l2(p + o);
}

// `bytes` (a multiple of 16) from device to shared memory, block-strided.
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           size_t bytes) {
  for (size_t o = static_cast<size_t>(threadIdx.x) * 16; o < bytes; o += kThreads * 16)
    cp_async16(dst + o, src + o);
}

// The staging of the images: every product waits for its chunk 0 (and bias)
// at its start and its chunk 1 halfway, and issues the next image's chunk 0
// halfway and chunk 1 at its end; each issue is one commit group, so the
// waits count groups statically. `pending` is the image the slots hold or
// will hold (block-uniform); a product whose image is not it drains the
// copies and stages its own.
template <class Tier>
struct Pipe {
  const unsigned char* image;
  Dims d;
  Smem<Tier> sm;
  int pending;

  __device__ void issue(int idx, int chunk) {
    if (idx >= 0) {
      const Shape sh = img_shape(d, idx);
      const int k0 = 16 * chunk0_ktiles(sh.Kp);
      const int wb = wt_bytes<Tier>();
      const unsigned char* img = image + static_cast<size_t>(idx) * img_stride<Tier>(d);
      const size_t off = chunk ? static_cast<size_t>(k0) * sh.Mp * wb : 0;
      const size_t bytes = static_cast<size_t>(chunk ? sh.Kp - k0 : k0) * sh.Mp * wb;
      copy_async(sm.slot[chunk], img + off, bytes);
      if (chunk == 0)
        copy_async(reinterpret_cast<unsigned char*>(sm.bias), img + img_bias_off<Tier>(d),
                   static_cast<size_t>(sh.Mp) * 4);
    }
    cp_async_commit();
  }

  // Stage `idx` unless it is pending (both chunks issued).
  __device__ void ensure(int idx) {
    if (pending == idx) return;
    cp_async_wait<0>();
    __syncthreads();  // no thread reads the slots any more
    issue(idx, 0);
    issue(idx, 1);
    pending = idx;
  }
};

// --------------------------------------------------------------- elementwise

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

template <int NP>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[NP]) {
  if constexpr (NP == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The state scratch of this block's slot `slot`: [stream][Wp][P], compact.
__device__ __forceinline__ float* state_ptr(const Args& g, const Dims& d, int slots, int slot) {
  const size_t per = static_cast<size_t>(d.S()) * d.Wp * d.P;
  return g.states + (static_cast<size_t>(blockIdx.x) * slots + slot) * per;
}

// Product epilogues: store(m, p, v) gets the sums v[s][0..NP) of output row
// m, points p .. p + NP - 1, of the S streams the product computed.
//
// Raw: the sums into `out`.
template <int S>
struct RawOut {
  float* out;
  int sstr, ld;
  template <int NP>
  __device__ __forceinline__ void store(int m, int p, const float (&v)[S][NP]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) store_vec<NP>(out + s * sstr + m * ld + p, v[s]);
  }
};

// A hidden layer's state from [z; u^k]: a = act(z) (the bias is in z), the
// state [a; u^k] to `st` (if any), the operands [a; u^k * act'(a)] to `out`.
template <int ACT, int S>
struct HiddenState {
  float* out;
  float* st;
  int sstr, ld, sP, P;  // sP: floats between two streams of a state
  template <int NP>
  __device__ __forceinline__ void store(int m, int p, const float (&v)[S][NP]) const {
    float a[NP], da[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      a[i] = act<ACT>(v[0][i]);
      da[i] = dact<ACT>(a[i]);
    }
    store_vec<NP>(out + m * ld + p, a);
    if (st) store_vec<NP>(st + m * P + p, a);
#pragma unroll
    for (int s = 1; s < S; ++s) {
      float t[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) t[i] = v[s][i] * da[i];
      if (st) store_vec<NP>(st + s * sP + m * P + p, v[s]);
      store_vec<NP>(out + s * sstr + m * ld + p, t);
    }
  }
};

// The input layer's state from z (one stream): a = act(z), u^k = the tier's
// w_in[k][m] (the tangent seeds), stored and turned into operands as above.
template <class Tier, int ACT, int K>
struct InputState {
  float* out;
  float* st;
  const float* w_in;
  int W, sstr, ld, sP, P;
  template <int NP>
  __device__ __forceinline__ void store(int m, int p, const float (&v)[1][NP]) const {
    float a[NP], da[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      a[i] = act<ACT>(v[0][i]);
      da[i] = dact<ACT>(a[i]);
    }
    store_vec<NP>(out + m * ld + p, a);
    if (st) store_vec<NP>(st + m * P + p, a);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float u = m < W ? w_f(Tier::to_w(w_in[static_cast<size_t>(k) * W + m])) : 0.f;
      float uv[NP], t[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        uv[i] = u;
        t[i] = u * da[i];
      }
      if (st) store_vec<NP>(st + (k + 1) * sP + m * P + p, uv);
      store_vec<NP>(out + (k + 1) * sstr + m * ld + p, t);
    }
  }
};

// ------------------------------------------------------------------ products

// The f32 product on the CUDA cores, one thread per 4 rows m0.. x 4 points
// p0.. of every stream (the plan keeps (Mp / 4) * (P / 4) <= kThreads). The
// chunk's image rows k in [kb, ke) are at (k - kb) * Mp.
template <int S>
struct F32Product {
  float acc[S][4][4];
  int m0, p0;
  bool live;

  __device__ void init(const Dims& d, int Mp, const float* bias) {
    const int pblocks = d.P / 4, u = threadIdx.x;
    live = u < (Mp / 4) * pblocks;
    p0 = (u % pblocks) * 4;
    m0 = (u / pblocks) * 4;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int oo = 0; oo < 4; ++oo)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[s][oo][pp] = (s == 0 && live) ? bias[m0 + oo] : 0.f;
  }

  __device__ void run(const float* __restrict__ in, const unsigned char* slot, int kb, int ke,
                      int Mp, const Dims& d) {
    if (!live) return;
    const float* wc = reinterpret_cast<const float*>(slot);
    const int ld = d.ld, sstr = d.sstr();
#pragma unroll 2
    for (int k = kb; k < ke; ++k) {
      float w[4];
      load_vec<4>(wc + (k - kb) * Mp + m0, w);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[4];
        load_vec<4>(in + s * sstr + k * ld + p0, x);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) acc[s][oo][pp] = fmaf(x[pp], w[oo], acc[s][oo][pp]);
      }
    }
  }

  template <class Epi>
  __device__ void finish(const Epi& epi) const {
    if (!live) return;
#pragma unroll
    for (int oo = 0; oo < 4; ++oo) {
      float v[S][4];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) v[s][pp] = acc[s][oo][pp];
      epi.template store<4>(m0 + oo, p0, v);
    }
  }
};

// The bf16 / f32x3 product on the tensor cores, one warp per 2 m-tiles (32
// rows) x 16 points of every stream (the plan keeps (Mp / 32) * (P / 16) <=
// kWarps). Lane (g, q) holds rows 16 mt + g and + 8, points 16 pu + 8 nn +
// 2 q and + 1.
template <class Tier, int S>
struct MmaProduct {
  static constexpr bool kSplit = Tier::kSplit;
  float acc[2][S][2][4];
  float crs[kSplit ? 2 : 1][kSplit ? S : 1][2][4];
  int mt0, pu, MT;
  bool live;

  __device__ void init(const Dims& d, int Mp, const float* bias) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
    MT = Mp / 16;
    const int mgroups = (MT + 1) / 2, pblocks = d.P / 16;
    live = warp < mgroups * pblocks;
    pu = warp % pblocks;
    mt0 = (warp / pblocks) * 2;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const bool on = live && mt0 + mm < MT;
      const float b0 = on ? bias[16 * (mt0 + mm) + g] : 0.f;
      const float b1 = on ? bias[16 * (mt0 + mm) + g + 8] : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          acc[mm][s][nn][0] = acc[mm][s][nn][1] = s == 0 ? b0 : 0.f;
          acc[mm][s][nn][2] = acc[mm][s][nn][3] = s == 0 ? b1 : 0.f;
          if constexpr (kSplit)
#pragma unroll
            for (int e = 0; e < 4; ++e) crs[mm][s][nn][e] = 0.f;
        }
    }
  }

  // k-tiles [kb, ke) of the chunk in `slot`, whose first k-tile is kb.
  __device__ void run(const float* __restrict__ in, const unsigned char* slot, int kb, int ke,
                      int, const Dims& d) {
    if (!live) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int ld = d.ld, sstr = d.sstr();
    const uint4* words = reinterpret_cast<const uint4*>(slot);
    const bool two = mt0 + 1 < MT;
    for (int kt = kb; kt < ke; ++kt) {
      uint4 ahi[2], alo[2];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int b = (kt - kb) * MT + mt0 + (mm && two ? 1 : 0);
        if constexpr (kSplit) {
          ahi[mm] = words[b * 64 + lane];
          alo[mm] = words[b * 64 + 32 + lane];
        } else {
          ahi[mm] = words[b * 32 + lane];
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const float* b = in + s * sstr + (16 * kt + 2 * q) * ld + 16 * pu + 8 * nn + g;
          const float x0 = b[0], x1 = b[ld], x2 = b[8 * ld], x3 = b[9 * ld];
          const uint32_t h0 = pack_bf16x2(x0, x1), h1 = pack_bf16x2(x2, x3);
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            if (mm == 1 && !two) continue;
            if constexpr (kSplit) {
              const uint32_t l0 = lo_word(x0, x1, h0), l1 = lo_word(x2, x3, h1);
              mma16816(crs[mm][s][nn], alo[mm], h0, h1);
              mma16816(crs[mm][s][nn], ahi[mm], l0, l1);
            }
            mma16816(acc[mm][s][nn], ahi[mm], h0, h1);
          }
        }
    }
  }

  template <class Epi>
  __device__ void finish(const Epi& epi) const {
    if (!live) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      if (mt0 + mm >= MT) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float v[S][2];
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * half + i;
              if constexpr (kSplit) {
                v[s][i] = crs[mm][s][nn][e] + acc[mm][s][nn][e];
              } else {
                v[s][i] = acc[mm][s][nn][e];
              }
            }
          epi.template store<2>(16 * (mt0 + mm) + g + 8 * half, 16 * pu + 8 * nn + 2 * q, v);
        }
    }
  }
};

template <class Tier, int S>
using ProductOf = typename std::conditional<sizeof(typename Tier::WT) == 4 && !Tier::kSplit,
                                            F32Product<S>, MmaProduct<Tier, S>>::type;

// One layer: out = epi(A @ in) over the image `idx` (S streams of `in`),
// staged through the pipe; `next`: the image the following product uses (or
// -1), issued while this one runs.
template <class Tier, int S, class Epi>
__device__ void layer(Pipe<Tier>& pipe, int idx, int next, const float* __restrict__ in,
                      const Epi& epi) {
  const Dims& d = pipe.d;
  const Shape sh = img_shape(d, idx);
  const int k0 = chunk0_ktiles(sh.Kp), kt = sh.Kp / 16;
  constexpr bool kF32 = sizeof(typename Tier::WT) == 4 && !Tier::kSplit;
  pipe.ensure(idx);
  cp_async_wait<1>();
  __syncthreads();  // chunk 0 and the bias have landed; `in` is complete
  ProductOf<Tier, S> pr;
  pr.init(d, sh.Mp, pipe.sm.bias);
  if constexpr (kF32) {
    pr.run(in, pipe.sm.slot[0], 0, 16 * k0, sh.Mp, d);
  } else {
    pr.run(in, pipe.sm.slot[0], 0, k0, sh.Mp, d);
  }
  cp_async_wait<0>();
  __syncthreads();  // chunk 1 has landed; slot 0 and the bias are free
  pipe.issue(next, 0);
  if constexpr (kF32) {
    pr.run(in, pipe.sm.slot[1], 16 * k0, 16 * kt, sh.Mp, d);
  } else {
    pr.run(in, pipe.sm.slot[1], k0, kt, sh.Mp, d);
  }
  pr.finish(epi);
  __syncthreads();  // slot 1 is free; `out` is complete
  pipe.issue(next, 1);
  pipe.pending = next;
}

// ----------------------------------------------------------- weight gradients

// The weight-gradient product's sums on the CUDA cores: f32 at f32 and
// bf16; at f32x3 both runtime operands split, (a_lo b_hi + a_hi b_lo) +
// a_hi b_hi (ops/tiers.py mm_tn), each operand split once.
template <class Tier>
struct WG {
  using Acc = float;
  using Opnd = float;
  static __device__ __forceinline__ Acc zero() { return 0.f; }
  static __device__ __forceinline__ Opnd prep(float a) { return a; }
  static __device__ __forceinline__ void mac(Acc& c, Opnd a, Opnd b) { c = fmaf(a, b, c); }
  static __device__ __forceinline__ float fin(Acc c) { return c; }
};

template <>
struct WG<tier::TierF32x3> {
  using Acc = tier::Acc3;
  using Opnd = tier::Pair;
  static __device__ __forceinline__ Acc zero() { return {0.f, 0.f}; }
  static __device__ __forceinline__ Opnd prep(float a) { return tier::split(a); }
  static __device__ __forceinline__ void mac(Acc& c, Opnd x, Opnd y) {
    c.cross = fmaf(x.lo, y.hi, c.cross);
    c.cross = fmaf(x.hi, y.lo, c.cross);
    c.main = fmaf(x.hi, y.hi, c.main);
  }
  static __device__ __forceinline__ float fin(Acc c) { return c.cross + c.main; }
};

__device__ __forceinline__ void accumulate(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// v[a][b] into G[i0 + a*di][j0 + b*dj] (row stride nj) for the real i < ni,
// j < nj, added to the entries there unless `first`: every earlier entry is
// loaded before the first store (a store may alias a later load, so loads
// and stores interleaved would wait on device memory one at a time).
template <int NA, int NB>
__device__ __forceinline__ void store_rows(float* __restrict__ G, int nj, int ni, int i0, int di,
                                           int j0, int dj, float (&v)[NA][NB], bool first) {
  if (!first) {
    float old[NA][NB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int i = i0 + a * di, j = j0 + b * dj;
        old[a][b] = (i < ni && j < nj) ? G[static_cast<size_t>(i) * nj + j] : 0.f;
      }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) v[a][b] = old[a][b] + v[a][b];
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + a * di, j = j0 + b * dj;
      if (i < ni && j < nj) G[static_cast<size_t>(i) * nj + j] = v[a][b];
    }
}

// G[i][j] (+)= sum_{s < S} sum_p A_s[i][p] * B[s][j][p] for the real i < ni,
// j < nj, written into G (row stride nj); rows up to Ri of A and Rj of B
// exist in shared memory (multiples of 16). A lane holds TI x TJ entries:
// rows ib + li + 4 ii, columns jb + lj + 8 jj (li = lane / 8, lj = lane % 8),
// a warp 4 TI rows x 8 TJ columns; a load of 4 points is one 16-byte word,
// shared by the 8 (A) or 4 (B) lanes of a row. `seed`: K rows of ubar whose
// point sums add to G's rows k < K (the input layer's tangent-seed term,
// f32); null elsewhere.
template <class Tier, int S, int TI, int TJ>
__device__ void weight_grad_cc(const float* const (&A)[S], int Ri, int ni,
                               const float* __restrict__ B, int Rj, int nj,
                               const float* __restrict__ seed, int K, float* __restrict__ G,
                               bool first, const Dims& d) {
  using wg = WG<Tier>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, li = lane >> 3, lj = lane & 7;
  const int ig = (Ri + 4 * TI - 1) / (4 * TI), jg = (Rj + 8 * TJ - 1) / (8 * TJ);
  const int ld = d.ld, sstr = d.sstr();
  for (int t = warp; t < ig * jg; t += kWarps) {
    const int ib = (t / jg) * 4 * TI, jb = (t % jg) * 8 * TJ;
    int ra[TI], rb[TJ];  // row offsets, clamped into the buffers
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) ra[ii] = min(ib + li + 4 * ii, Ri - 1) * ld;
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) rb[jj] = min(jb + lj + 8 * jj, Rj - 1) * ld;
    if (!first)  // the partial row's entries are read back at the end
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) {
        const int i = ib + li + 4 * ii;
        if (lj == 0 && i < ni && jb < nj) prefetch_l2(G + static_cast<size_t>(i) * nj + jb);
      }
    typename wg::Acc acc[TI][TJ];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = wg::zero();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* a_s = A[s];
      const float* b_s = B + s * sstr;
      for (int p = 0; p < d.P; p += 4) {
        typename wg::Opnd av[TI][4], bv[TJ][4];
#pragma unroll
        for (int ii = 0; ii < TI; ++ii) {
          float x[4];
          load_vec<4>(a_s + ra[ii] + p, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) av[ii][e] = wg::prep(x[e]);
        }
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
          float x[4];
          load_vec<4>(b_s + rb[jj] + p, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[jj][e] = wg::prep(x[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int ii = 0; ii < TI; ++ii)
#pragma unroll
            for (int jj = 0; jj < TJ; ++jj) wg::mac(acc[ii][jj], av[ii][e], bv[jj][e]);
      }
    }
    // the sums, then every earlier entry loaded at once, then the stores
    float v[TI][TJ];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int i = ib + li + 4 * ii, j = jb + lj + 8 * jj;
        v[ii][jj] = wg::fin(acc[ii][jj]);
        if (seed && i < K && i < ni && j < nj) {
          float t = 0.f;
          for (int p = 0; p < d.P; ++p) t += seed[i * sstr + j * ld + p];
          v[ii][jj] += t;
        }
      }
    store_rows<TI, TJ>(G, nj, ni, ib + li, 4, jb + lj, 8, v, first);
  }
}

// The f32x3 weight gradient on the tensor cores: M = i (rows of A), N = j
// (rows of B), K = the points of every stream, 16 at a time; a warp per 2
// m-tiles x 4 n-tiles. A fragment word (row i, points p, p + 1) and B
// fragment word (row j, points p, p + 1) are 8-byte loads, both split.
template <int S>
__device__ void weight_grad_mma(const float* const (&A)[S], int Ri, int ni,
                                const float* __restrict__ B, int Rj, int nj,
                                float* __restrict__ G, bool first, const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int MT = Ri / 16, NT = Rj / 8, mg = (MT + 1) / 2, ng = (NT + 3) / 4;
  const int ld = d.ld, sstr = d.sstr();
  for (int t = warp; t < mg * ng; t += kWarps) {
    const int mt0 = (t / ng) * 2, nt0 = (t % ng) * 4;
    if (!first && q == 0)  // the partial row's entries are read back at the end
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * (mt0 + mm) + g + 8 * h;
          if (mt0 + mm < MT && i < ni && 8 * nt0 < nj)
            prefetch_l2(G + static_cast<size_t>(i) * nj + 8 * nt0);
        }
    float crs[2][4][4], acc[2][4][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) crs[mm][nn][e] = acc[mm][nn][e] = 0.f;
    int ra[2], rb[4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) ra[mm] = min(16 * (mt0 + mm), Ri - 16) + g;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) rb[nn] = min(8 * (nt0 + nn), Rj - 8) + g;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* a_s = A[s];
      const float* b_s = B + s * sstr;
      for (int p = 0; p < d.P; p += 16) {
        const int c = p + 2 * q;
        uint4 ahi[2], alo[2];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const float2 x0 = *reinterpret_cast<const float2*>(a_s + ra[mm] * ld + c);
          const float2 x1 = *reinterpret_cast<const float2*>(a_s + (ra[mm] + 8) * ld + c);
          const float2 x2 = *reinterpret_cast<const float2*>(a_s + ra[mm] * ld + c + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(a_s + (ra[mm] + 8) * ld + c + 8);
          ahi[mm] = make_uint4(pack_bf16x2(x0.x, x0.y), pack_bf16x2(x1.x, x1.y),
                               pack_bf16x2(x2.x, x2.y), pack_bf16x2(x3.x, x3.y));
          alo[mm] = make_uint4(lo_word(x0.x, x0.y, ahi[mm].x), lo_word(x1.x, x1.y, ahi[mm].y),
                               lo_word(x2.x, x2.y, ahi[mm].z), lo_word(x3.x, x3.y, ahi[mm].w));
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float2 y0 = *reinterpret_cast<const float2*>(b_s + rb[nn] * ld + c);
          const float2 y1 = *reinterpret_cast<const float2*>(b_s + rb[nn] * ld + c + 8);
          const uint32_t h0 = pack_bf16x2(y0.x, y0.y), h1 = pack_bf16x2(y1.x, y1.y);
          const uint32_t l0 = lo_word(y0.x, y0.y, h0), l1 = lo_word(y1.x, y1.y, h1);
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            mma16816(crs[mm][nn], alo[mm], h0, h1);
            mma16816(crs[mm][nn], ahi[mm], l0, l1);
            mma16816(acc[mm][nn], ahi[mm], h0, h1);
          }
        }
      }
    }
    // entry (mm, nn, e): row 16 (mt0 + mm) + g + 8 (e >> 1), column 8 (nt0 + nn)
    // + 2 q + (e & 1); every earlier entry loaded before the first store
    float v[2][4][4];
    bool ok[2][4][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * (mt0 + mm) + g + 8 * (e >> 1), j = 8 * (nt0 + nn) + 2 * q + (e & 1);
          ok[mm][nn][e] = mt0 + mm < MT && nt0 + nn < NT && i < ni && j < nj;
          v[mm][nn][e] = crs[mm][nn][e] + acc[mm][nn][e];
          if (!first && ok[mm][nn][e]) crs[mm][nn][e] = G[static_cast<size_t>(i) * nj + j];
        }
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * (mt0 + mm) + g + 8 * (e >> 1), j = 8 * (nt0 + nn) + 2 * q + (e & 1);
          if (ok[mm][nn][e])
            G[static_cast<size_t>(i) * nj + j] = first ? v[mm][nn][e]
                                                       : crs[mm][nn][e] + v[mm][nn][e];
        }
  }
}

// A layer's weight gradient (the output layer's or a hidden one's): f32x3
// on the tensor cores, else the CUDA cores with 8 x 8 entries a lane where
// that gives every warp a tile, 4 x 4 below.
template <class Tier, int S>
__device__ void weight_grad(const float* const (&A)[S], int Ri, int ni, const float* B, int Rj,
                            int nj, float* G, bool first, const Dims& d) {
  if constexpr (Tier::kSplit) {
    weight_grad_mma<S>(A, Ri, ni, B, Rj, nj, G, first, d);
  } else {
    if (((Ri + 31) / 32) * ((Rj + 63) / 64) >= kWarps) {
      weight_grad_cc<Tier, S, 8, 8>(A, Ri, ni, B, Rj, nj, nullptr, 0, G, first, d);
    } else {
      weight_grad_cc<Tier, S, 4, 4>(A, Ri, ni, B, Rj, nj, nullptr, 0, G, first, d);
    }
  }
}

// g[j] (+)= sum_p buf[j][p] for the real j < n (a bias gradient).
__device__ void bias_grad(const float* __restrict__ buf, int n, float* __restrict__ g, bool first,
                          const Dims& d) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float t = 0.f;
    for (int p = 0; p < d.P; ++p) t += buf[j * d.ld + p];
    accumulate(g + j, t, first);
  }
}

// --------------------------------------------------------------- the forward

// The tile's coordinates into rows [0, Ip) of stream 0 of buf (zero past
// d_in and past the last point).
__device__ void load_coords(float* __restrict__ buf, const Args& g, long long p_base, int nv,
                            const Dims& d) {
  for (int e = threadIdx.x; e < d.Ip * d.P; e += blockDim.x) {
    const int c = e / d.P, p = e % d.P;
    buf[c * d.ld + p] = (c < d.d_in && p < nv) ? g.coords[(p_base + p) * d.d_in + c] : 0.f;
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

template <class Policy>
__device__ __forceinline__ float* kept_state(const Args& g, const Dims& d, int s, Store store) {
  const int L = d.n_stack, C = g.ckpt_every;
  if (store == kAll || (store == kKept && Policy::keeps(s, L, C)))
    return state_ptr(g, d, Policy::slots(L, C), Policy::slot(s, L, C));
  return nullptr;
}

// The forward of layers [l0, l1) from the operands [a; t^k] of state l0 in
// *X, leaving the operands of state l1 in *X (X and Y swap each layer);
// state l+1 goes to its slot of the scratch as `store` says. `after`: the
// image the product after the last layer uses.
template <class Tier, class Policy, int ACT, int K>
__device__ void hidden_forward(Pipe<Tier>& pipe, const Args& g, float*& X, float*& Y, int l0,
                               int l1, int after, Store store) {
  constexpr int S = 1 + K;
  const Dims& d = pipe.d;
  for (int l = l0; l < l1; ++l) {
    const HiddenState<ACT, S> epi{Y, kept_state<Policy>(g, d, l + 1, store), d.sstr(), d.ld,
                                  d.Wp * d.P, d.P};
    layer<Tier, S>(pipe, img_fwd(l), l + 1 < l1 ? img_fwd(l + 1) : after, X, epi);
    float* t = X;
    X = Y;
    Y = t;
  }
}

// The forward of one tile up to the output layer's [y; dy^k], rows [0, Op)
// of *Y; *X holds the operands of the last state. The walk stores states;
// `after`: the image of the product after the output layer (-1: none).
template <class Tier, class Policy, int ACT, int K>
__device__ void forward_tile(Pipe<Tier>& pipe, const Args& g, float*& X, float*& Y,
                             long long p_base, int nv, Store store, int after) {
  constexpr int S = 1 + K;
  const Dims& d = pipe.d;
  const int L = d.n_stack;
  load_coords(X, g, p_base, nv, d);
  const InputState<Tier, ACT, K> in_epi{Y, kept_state<Policy>(g, d, 0, store), g.w_in, d.W,
                                        d.sstr(), d.ld, d.Wp * d.P, d.P};
  layer<Tier, 1>(pipe, img_in(), L ? img_fwd(0) : img_out(d), X, in_epi);
  float* t = X;
  X = Y;
  Y = t;
  hidden_forward<Tier, Policy, ACT, K>(pipe, g, X, Y, 0, L, img_out(d), store);
  layer<Tier, S>(pipe, img_out(d), after, X, RawOut<S>{Y, d.sstr(), d.ld});
}

// Launch the images kernel for images [first, first + count).
template <class Tier>
cudaError_t make_images(const Args& g, const Dims& d, int first, int count, cudaStream_t stream) {
  const int blocks = imax(1, imax(d.Wp * d.Wp, imax(d.Ip * d.Wp, d.Wp * d.Op)) / 2 / kThreads);
  images_kernel<Tier><<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(count)),
                        kThreads, 0, stream>>>(g, d, first);
  return cudaGetLastError();
}

// K2: the forward of every tile, then y and dy (or the continuity residual
// fc) of its points.
struct FwdArgs {
  Args g;
  float *y, *dy, *fc;
};

template <class Tier, int ACT, int K, bool EPI>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = make_dims(a.g.W, a.g.d_in, a.g.d_out, a.g.n_stack, K, a.g.tile);
  const Smem<Tier> sm(smem, d, 2);
  Pipe<Tier> pipe{a.g.image, d, sm, -1};
  const int tiles = (a.g.n + d.P - 1) / d.P;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p_base = static_cast<long long>(tile) * d.P;
    const int nv = static_cast<int>(a.g.n - p_base < d.P ? a.g.n - p_base : d.P);
    float *X = sm.buf[0], *Y = sm.buf[1];
    forward_tile<Tier, StoreAll, ACT, K>(pipe, a.g, X, Y, p_base, nv, kNone,
                                         tile + static_cast<int>(gridDim.x) < tiles ? img_in()
                                                                                     : -1);
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
    __syncthreads();  // the buffers are written again by the next tile
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ the walk

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

// [a; u^k] of a state from the scratch into buf (float4 e of Wp x P/4,
// thread-strided: the mapping of backward_pass).
__device__ void load_state(float* __restrict__ buf, const float* __restrict__ st, const Dims& d,
                           int S) {
  const int q4 = d.P / 4, n = d.Wp * q4;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int m = e / q4, p = (e % q4) * 4;
    for (int s = 0; s < S; ++s)
      *reinterpret_cast<float4*>(buf + s * d.sstr() + m * d.ld + p) =
          *reinterpret_cast<const float4*>(st + static_cast<size_t>(s) * d.Wp * d.P + m * d.P + p);
  }
}

// One layer's elementwise pass, float4 e of Wp x P/4 thread-strided (the
// mapping of load_state, so that a state it loaded needs no barrier):
// [abar; tbar^k] in BAR -> [zbar; ubar^k] with state j+1 [a; u^k] in CUR;
// then, if `st` (state j in the scratch), PRV = [a; u^k] of state j and
// CUR's tangent streams = its t^k = u^k * act'(a) (the weight gradient's
// operands [PRV_a; CUR_t^k]).
template <int ACT, int K>
__device__ void backward_pass(float* __restrict__ BAR, float* __restrict__ CUR,
                              float* __restrict__ PRV, const float* __restrict__ st,
                              const Dims& d) {
  const int q4 = d.P / 4, n = d.Wp * q4, sstr = d.sstr();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int m = e / q4, p = (e % q4) * 4, o = m * d.ld + p;
    float a[4], ab[4];
    load_vec<4>(CUR + o, a);
    load_vec<4>(BAR + o, ab);
    float dbar[4] = {0.f, 0.f, 0.f, 0.f}, da[4];
    float tb[K > 0 ? K : 1][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float u[4];
      load_vec<4>(BAR + (k + 1) * sstr + o, tb[k]);
      load_vec<4>(CUR + (k + 1) * sstr + o, u);
#pragma unroll
      for (int i = 0; i < 4; ++i) dbar[i] += tb[k][i] * u[i];
    }
    float z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      da[i] = dact<ACT>(a[i]);
      z[i] = (ab[i] + ddact<ACT>(a[i], dbar[i])) * da[i];
    }
    store_vec<4>(BAR + o, z);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float ub[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ub[i] = tb[k][i] * da[i];
      store_vec<4>(BAR + (k + 1) * sstr + o, ub);
    }
    if (st) {
      const size_t so = static_cast<size_t>(m) * d.P + p, sP = static_cast<size_t>(d.Wp) * d.P;
      float a0[4], da0[4];
      load_vec<4>(st + so, a0);
      store_vec<4>(PRV + o, a0);
#pragma unroll
      for (int i = 0; i < 4; ++i) da0[i] = dact<ACT>(a0[i]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float u[4], t[4];
        load_vec<4>(st + (k + 1) * sP + so, u);
        store_vec<4>(PRV + (k + 1) * sstr + o, u);
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] = u[i] * da0[i];
        store_vec<4>(CUR + (k + 1) * sstr + o, t);
      }
    }
  }
}

// Whether the backward step j starts by re-running its segment (Rebuild),
// and the first image step j's products use.
template <class Policy>
__device__ __forceinline__ bool reruns(int j, int L, int C) {
  const int m0 = (j / C) * C;
  return Policy::kRebuild && (j == L - 1 || (j + 1) % C == 0) && j > m0;
}

template <class Policy>
__device__ __forceinline__ int first_image(const Dims& d, int j, int C) {
  if (j < 0) return -1;
  return reruns<Policy>(j, d.n_stack, C) ? img_fwd((j / C) * C) : img_bwd(d, j);
}

// One tile's walk: the forward (states to the scratch), the epilogue's
// output cotangents in rows [0, Op) of BAR, then the backward into the
// block's partial row `row` (the first tile stores). `epi.output(Y, ...)`
// turns [y; dy^k] into [ybar; ybar^k] in place (K1) or loads them (K3, K4),
// with a free buffer for its per-point rows.
template <class Tier, class Policy, int ACT, int K, class Epi>
__device__ void walk_tile(Pipe<Tier>& pipe, const Args& g, long long p_base, int nv, bool first,
                          bool more, Epi& epi, float* __restrict__ row) {
  constexpr int S = 1 + K;
  const Dims& d = pipe.d;
  const Smem<Tier>& sm = pipe.sm;
  const int L = d.n_stack, C = g.ckpt_every, slots = Policy::slots(L, C), sstr = d.sstr();
  const Offsets off(d);
  float *X = sm.buf[0], *Y = sm.buf[1];
  forward_tile<Tier, Policy, ACT, K>(pipe, g, X, Y, p_base, nv, kKept, img_bwd_out(d));
  epi.output(Y, p_base, nv, d, sm.buf[2], row + off.end, first);
  // states L and L - 1 into L2 while the output layer runs: the backward
  // reads them next (each later step prefetches the state after its own)
  const size_t state_floats = static_cast<size_t>(S) * d.Wp * d.P;
  prefetch_floats(state_ptr(g, d, slots, Policy::slot(L, L, C)), state_floats);
  if (L > 0 && !reruns<Policy>(L - 1, L, C))
    prefetch_floats(state_ptr(g, d, slots, Policy::slot(L - 1, L, C)), state_floats);
  __syncthreads();
  // ---- the output layer: X = [a_L; t_L^k], Y = [ybar; ybar^k]
  {
    const float* A[S];
#pragma unroll
    for (int s = 0; s < S; ++s) A[s] = X + s * sstr;
    weight_grad<Tier, S>(A, d.Wp, d.W, Y, d.Op, d.d_out, row + off.wout, first, d);
    bias_grad(Y, d.d_out, row + off.bout, first, d);
  }
  // [abar; tbar^k] of state L into X once every warp is done with it
  layer<Tier, S>(pipe, img_bwd_out(d), first_image<Policy>(d, L - 1, C), Y,
                 RawOut<S>{X, sstr, d.ld});
  float *BAR = X, *CUR = Y, *PRV = sm.buf[2];
  load_state(CUR, state_ptr(g, d, slots, Policy::slot(L, L, C)), d, S);
  for (int j = L - 1; j >= 0; --j) {
    if (reruns<Policy>(j, L, C)) {
      // the top of a segment: re-run it from its checkpoint m0 into the
      // segment slots (states m0+1 .. j), then state j+1 back into CUR
      const int m0 = (j / C) * C;
      float *RX = CUR, *RY = PRV;
      __syncthreads();  // CUR and PRV are free
      load_state(RX, state_ptr(g, d, slots, Policy::slot(m0, L, C)), d, S);
      __syncthreads();
      {
        const int q4 = d.P / 4, n = d.Wp * q4;  // the operands [a; t^k] of state m0
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
          const int o = (e / q4) * d.ld + (e % q4) * 4;
          float a[4];
          load_vec<4>(RX + o, a);
#pragma unroll
          for (int k = 1; k <= K; ++k) {
            float u[4];
            load_vec<4>(RX + k * sstr + o, u);
#pragma unroll
            for (int i = 0; i < 4; ++i) u[i] *= dact<ACT>(a[i]);
            store_vec<4>(RX + k * sstr + o, u);
          }
        }
      }
      hidden_forward<Tier, Policy, ACT, K>(pipe, g, RX, RY, m0, j, img_bwd(d, j), kAll);
      load_state(CUR, state_ptr(g, d, slots, Policy::slot(j + 1, L, C)), d, S);
    }
    backward_pass<ACT, K>(BAR, CUR, PRV, state_ptr(g, d, slots, Policy::slot(j, L, C)), d);
    if (j > 0 && !reruns<Policy>(j - 1, L, C))
      prefetch_floats(state_ptr(g, d, slots, Policy::slot(j - 1, L, C)), state_floats);
    __syncthreads();
    {
      const float* A[S];
      A[0] = PRV;
#pragma unroll
      for (int s = 1; s < S; ++s) A[s] = CUR + s * sstr;
      weight_grad<Tier, S>(A, d.Wp, d.W, BAR, d.Wp, d.W,
                           row + off.wh + static_cast<long long>(j) * d.W * d.W, first, d);
      bias_grad(BAR, d.W, row + off.bh + static_cast<long long>(j) * d.W, first, d);
    }
    // the cotangents of state j into CUR once every warp is done with it
    layer<Tier, S>(pipe, img_bwd(d, j),
                   j > 0 ? first_image<Policy>(d, j - 1, C) : (more ? img_in() : -1), BAR,
                   RawOut<S>{CUR, sstr, d.ld});
    float* t = BAR;
    BAR = CUR;
    CUR = PRV;
    PRV = t;
  }
  // ---- the input layer: CUR = state 0
  backward_pass<ACT, K>(BAR, CUR, PRV, nullptr, d);
  load_coords(PRV, g, p_base, nv, d);
  __syncthreads();
  {
    const float* A[1] = {PRV};
    weight_grad_cc<Tier, 1, 4, 4>(A, d.Ip, d.d_in, BAR, d.Wp, d.W, BAR + sstr, K, row + off.win,
                                  first, d);
    bias_grad(BAR, d.W, row + off.bin, first, d);
  }
  __syncthreads();  // the buffers are written again by the next tile
}

template <class Tier, class Policy, int ACT, int K, class Epi>
__device__ void walk(const Args& g, Epi& epi, unsigned char* smem, long long n_ent) {
  const Dims d = dims_of(g, K);
  const Smem<Tier> sm(smem, d, 3);
  Pipe<Tier> pipe{g.image, d, sm, -1};
  float* row = g.partial + static_cast<long long>(blockIdx.x) * n_ent;
  const int tiles = (g.n + d.P - 1) / d.P;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p_base = static_cast<long long>(tile) * d.P;
    const int nv = static_cast<int>(g.n - p_base < d.P ? g.n - p_base : d.P);
    walk_tile<Tier, Policy, ACT, K>(pipe, g, p_base, nv, tile == static_cast<int>(blockIdx.x),
                                    tile + static_cast<int>(gridDim.x) < tiles, epi, row);
  }
  cp_async_wait<0>();
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
__global__ void __launch_bounds__(kThreads, 1) cotangent_kernel(const CotangentArgs a,
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

// Make the weight images, set the kernel's dynamic shared memory, launch it
// on `grid` blocks, then (for a walk, `out` not null) the fixed-order sum of
// its partial rows.
template <class Tier, class Kernel, class... KArgs>
cudaError_t launch(Kernel kernel, const Args& g, const Dims& d, size_t smem, int grid,
                   cudaStream_t stream, const float* partial, float* out, long long n_ent,
                   KArgs... kargs) {
  cudaError_t err = make_images<Tier>(g, d, 0, n_images(d, out != nullptr), stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(kargs...);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  const long long blocks = (n_ent + 255) / 256;
  reduce_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(partial, grid, n_ent, out);
  return cudaGetLastError();
}

}  // namespace wide
