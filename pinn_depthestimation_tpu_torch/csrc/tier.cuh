// The precision tiers of the kernels (ops/tiers.py defines what each
// computes), shared by K2 (mlp_fwd_tangents.cu) and the backward walk of K1,
// K3 and K4 (mlp_bwd_common.cuh).
//
//   TierF32   f32 weights in shared memory; every product in f32.
//   TierBf16  bf16 weights in shared memory (rounded to nearest even as the
//             kernel stages them); every runtime operand rounded to bf16
//             before it meets a weight; f32 FMAs (a product of two bf16
//             values is exact in f32). Biases, sums and the weight-gradient
//             products stay f32.
//
// Both run on the CUDA cores: bf16 halves the weights' shared memory and
// adds one conversion per operand; it removes no FMA. At f32 every helper is
// the identity, so the f32 instantiations compute what they did before the
// tiers existed, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tier {

struct TierF32 {
  using WT = float;  // the weights' type in shared memory
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ WT to_w(float w) { return w; }
};

struct TierBf16 {
  using WT = __nv_bfloat16;
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ WT to_w(float w) { return __float2bfloat16_rn(w); }
};

__device__ __forceinline__ float w_f(float w) { return w; }
__device__ __forceinline__ float w_f(__nv_bfloat16 w) { return __bfloat162float(w); }

// Weights per shared-memory load along a row of W weights.
template <int W>
__host__ __device__ constexpr int row_vec() {
  return (W % 4 == 0) ? 4 : ((W % 2 == 0) ? 2 : 1);
}

// V consecutive weights from shared memory, as floats (one 16-, 8- or 4-byte
// load for f32, one 8- or 4-byte load for bf16).
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
