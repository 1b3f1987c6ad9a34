// The precision tiers of the kernels (ops/tiers.py defines what each
// computes), shared by K2 (mlp_fwd_tangents.cu) and the backward walk of K1,
// K3 and K4 (mlp_bwd_common.cuh).
//
//   TierF32    f32 weights in shared memory; every product in f32.
//   TierBf16   bf16 weights in shared memory (rounded to nearest even as the
//              kernel stages them); every runtime operand rounded to bf16
//              before it meets a weight; f32 FMAs (a product of two bf16
//              values is exact in f32). Biases, sums and the weight-gradient
//              products stay f32.
//   TierF32x3  split-f32: each weight staged as a bf16 (hi, lo) pair
//              (__nv_bfloat162, the bytes of one f32, so the shared-memory
//              plans come out as at f32); each runtime operand split into
//              hi = bf16(a), lo = bf16(a - hi) before it meets a weight; each
//              product a*w three f32 FMAs of exact bf16 products, summed as
//              (a_lo*w_hi + a_hi*w_lo) + a_hi*w_hi in two accumulators, the
//              cross terms and the main term, as the JAX kernels add their
//              three bf16 dots. The weight-gradient products split both
//              runtime operands (mlp_bwd_common.cuh).
//
// A product site is written once for every tier with the tier's types:
//   Op   a runtime operand prepared once (Tier::op): a float, or a hi/lo pair;
//   WV   a weight as loaded from shared memory (load_vec, w_ld): a float, or
//        a hi/lo pair;
//   Acc  an accumulator (Tier::acc(init)): a float, or a (cross, main) pair;
// Tier::mac(acc, op, w) adds one product and Tier::fin(acc) is the sum. At
// f32 and bf16 Op, WV and Acc are float, op is the identity (f32) or the
// rounding (bf16), mac is one fmaf and fin the identity, so those
// instantiations compile to the instructions they did before the product
// abstraction existed, bit for bit. These products run on the CUDA cores:
// every product of the f32 tier, and the cheap tiers' products that stay
// scalar (the input layer's, the bf16 and f32x3 weight gradients of the
// input and output layers, the bf16 hidden ones). The cheap tiers' other
// products run on the tensor cores (mma_frag.cuh: K2's
// mlp_fwd_tangents_mma.cuh and the walk's mlp_bwd_mma.cuh), with the same
// semantics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// A library holds one tier when compiled with -DTIER_ONLY=0 (f32), 1 (bf16)
// or 2 (f32x3): ops/cuda_build.py compiles the tiers as separate variants so
// that their nvcc runs in parallel. Without it, a library holds every tier.
#ifdef TIER_ONLY
#define WITH_TIER(t) (TIER_ONLY == (t))
#else
#define WITH_TIER(t) 1
#endif

namespace tier {

// The f32x3 tier's split of one value, as floats (each bf16-valued).
struct Pair {
  float hi, lo;
};

// The f32x3 accumulator: the cross terms and the main term.
struct Acc3 {
  float cross, main;
};

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ Pair split(float x) {
  const float hi = bf16_rn(x);
  return {hi, bf16_rn(x - hi)};
}

struct TierF32 {
  static constexpr bool kSplit = false;
  using WT = float;  // the weights' type in shared memory
  using WV = float;  // a weight in registers
  using Op = float;
  using Acc = float;
  static __device__ __forceinline__ WT to_w(float w) { return w; }
  static __device__ __forceinline__ Op op(float x) { return x; }
  static __device__ __forceinline__ Acc acc(float init) { return init; }
  static __device__ __forceinline__ void mac(Acc& c, Op a, WV w) { c = fmaf(a, w, c); }
  static __device__ __forceinline__ float fin(Acc c) { return c; }
};

struct TierBf16 {
  static constexpr bool kSplit = false;
  using WT = __nv_bfloat16;
  using WV = float;
  using Op = float;
  using Acc = float;
  static __device__ __forceinline__ WT to_w(float w) { return __float2bfloat16_rn(w); }
  static __device__ __forceinline__ Op op(float x) { return bf16_rn(x); }
  static __device__ __forceinline__ Acc acc(float init) { return init; }
  static __device__ __forceinline__ void mac(Acc& c, Op a, WV w) { c = fmaf(a, w, c); }
  static __device__ __forceinline__ float fin(Acc c) { return c; }
};

struct TierF32x3 {
  static constexpr bool kSplit = true;
  using WT = __nv_bfloat162;  // .x = hi, .y = lo
  using WV = Pair;
  using Op = Pair;
  using Acc = Acc3;
  static __device__ __forceinline__ WT to_w(float w) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    __nv_bfloat162 r;
    r.x = hi;
    r.y = __float2bfloat16_rn(w - __bfloat162float(hi));
    return r;
  }
  static __device__ __forceinline__ Op op(float x) { return split(x); }
  // the initial value (a bias) rides the main term
  static __device__ __forceinline__ Acc acc(float init) { return {0.f, init}; }
  static __device__ __forceinline__ void mac(Acc& c, Op a, WV w) {
    c.cross = fmaf(a.lo, w.hi, c.cross);
    c.cross = fmaf(a.hi, w.lo, c.cross);
    c.main = fmaf(a.hi, w.hi, c.main);
  }
  static __device__ __forceinline__ float fin(Acc c) { return c.cross + c.main; }
};

// One weight from shared memory, in registers.
__device__ __forceinline__ float w_ld(float w) { return w; }
__device__ __forceinline__ float w_ld(__nv_bfloat16 w) { return __bfloat162float(w); }
__device__ __forceinline__ Pair w_ld(__nv_bfloat162 w) {
  const float2 f = __bfloat1622float2(w);
  return {f.x, f.y};
}

// The value the tier's products see of one weight, as one float (hi + lo
// at f32x3): the tangent seeds.
__device__ __forceinline__ float w_f(float w) { return w; }
__device__ __forceinline__ float w_f(__nv_bfloat16 w) { return __bfloat162float(w); }
__device__ __forceinline__ float w_f(__nv_bfloat162 w) {
  const float2 f = __bfloat1622float2(w);
  return f.x + f.y;
}

// Weights per shared-memory load along a row of W weights.
template <int W>
__host__ __device__ constexpr int row_vec() {
  return (W % 4 == 0) ? 4 : ((W % 2 == 0) ? 2 : 1);
}

// V consecutive weights from shared memory, in registers (one 16-, 8- or
// 4-byte load for f32 and f32x3, one 8- or 4-byte load for bf16).
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

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (V == 2) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = r.x; v[1] = r.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat162* __restrict__ p, Pair (&v)[V]) {
  if constexpr (V == 4) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = w_ld(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
  } else if constexpr (V == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    v[0] = w_ld(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    v[1] = w_ld(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  } else {
    v[0] = w_ld(p[0]);
  }
}

// Stage n weights from device memory (f32) into shared memory at the tier's
// type, block-strided.
template <class Tier>
__device__ __forceinline__ void stage_weights(typename Tier::WT* __restrict__ dst,
                                              const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = Tier::to_w(src[i]);
}

// Bytes rounded up to 16, so every shared-memory region starts 16-aligned.
__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

}  // namespace tier
