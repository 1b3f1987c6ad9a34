// Adam's update for Hopper: every leaf of a parameter group in one launch.
//
// Replaces no TPU kernel: the JAX package leaves Adam to optax under jit,
// where XLA fuses the update into the step. The port ran torch.optim.Adam's
// foreach path instead, seven multi_tensor_apply kernels a step (lerp, mul,
// addcmul, sqrt, div, add, addcdiv), each with its own launch and its own
// pass over the leaves; this kernel is optim/adam.py's update on the card.
//
// Per element of every leaf, in float32 and in the order of torch's
// non-capturable foreach Adam (so p, m and v keep every bit of it):
//   m = lerp(m, g, 1 - beta1)        torch's lerp: m + w*(g - m) for w < 0.5,
//                                    g - (g - m)*(1 - w) otherwise, one FMA
//   v = v * beta2
//   v = v + (1 - beta2) * (g * g)    addcmul: g*g rounded, then one FMA
//   d = sqrt(v) / bc2_sqrt + eps     each rounded (IEEE sqrt and division)
//   p = p + step_size * (m / d)      addcdiv: m/d rounded, then one FMA
// with step_size = -lr / (1 - beta1^t) and bc2_sqrt = (1 - beta2^t)^0.5
// worked out in double on the host from each leaf's step count t, as
// torch.optim.Adam works them out, and rounded to float as torch's foreach
// kernels take their scalars. Every operation is written as its IEEE
// intrinsic, so the compiler contracts nothing on its own.
//
// Bound on the H100: per element 16 bytes read (p, g, m, v) and 12 written,
// about 1.2 MB for the flagship's 41,703 parameters, 0.35 us at 3.35 TB/s;
// a launch costs more than that, so the design is one launch: the leaves'
// pointers and prefix offsets travel in one __grid_constant__ argument, the
// leaves form one index space of 4-element quads (a quad never straddles
// two leaves), one thread a quad, loaded as float4 where all four of the
// leaf's arrays are 16-byte aligned, element by element otherwise. No
// atomics, no second pass, no shared memory.
//
// The host entry adam_step works out the scalars from each leaf's step
// count (a CPU float32, torch's `step` state) plus one, and writes that count
// back once the launch succeeded.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 128;

// What the kernel reads: the host entry fills the gradients' pointers, the
// alignment flags and the scalars each step; optim/adam.py fills the rest
// once (its ctypes mirror is AdamLeaves).
struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int numel[kMaxLeaves];
  int quad_start[kMaxLeaves + 1];  // prefix sums of ceil(numel / 4)
  int vec[kMaxLeaves];             // p, g, m and v all 16-byte aligned
  float step_size[kMaxLeaves];     // -lr / (1 - beta1^t)
  float bc2_sqrt[kMaxLeaves];      // (1 - beta2^t)^0.5
  float w1, beta2, w2, eps;        // 1 - beta1, beta2, 1 - beta2, eps
  int n;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float w1,
                                       float beta2, float w2, float eps, float step_size,
                                       float bc2_sqrt) {
  const float diff = __fsub_rn(g, m);
  m = w1 < 0.5f ? __fmaf_rn(w1, diff, m) : __fmaf_rn(-diff, __fsub_rn(1.0f, w1), g);
  v = __fmaf_rn(w2, __fmul_rn(g, g), __fmul_rn(v, beta2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), eps);
  p = __fmaf_rn(step_size, __fdiv_rn(m, d), p);
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Leaves a) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= a.quad_start[a.n]) return;
  int l = 0;
  while (q >= a.quad_start[l + 1]) ++l;
  const int e = 4 * (q - a.quad_start[l]);
  const float w1 = a.w1, beta2 = a.beta2, w2 = a.w2, eps = a.eps;
  const float step_size = a.step_size[l], bc2_sqrt = a.bc2_sqrt[l];
  float* __restrict__ p = a.p[l] + e;
  const float* __restrict__ g = a.g[l] + e;
  float* __restrict__ m = a.m[l] + e;
  float* __restrict__ v = a.v[l] + e;
  const int count = min(4, a.numel[l] - e);
  if (a.vec[l] && count == 4) {
    float4 p4 = *reinterpret_cast<const float4*>(p);
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g));
    float4 m4 = *reinterpret_cast<const float4*>(m);
    float4 v4 = *reinterpret_cast<const float4*>(v);
    update(p4.x, g4.x, m4.x, v4.x, w1, beta2, w2, eps, step_size, bc2_sqrt);
    update(p4.y, g4.y, m4.y, v4.y, w1, beta2, w2, eps, step_size, bc2_sqrt);
    update(p4.z, g4.z, m4.z, v4.z, w1, beta2, w2, eps, step_size, bc2_sqrt);
    update(p4.w, g4.w, m4.w, v4.w, w1, beta2, w2, eps, step_size, bc2_sqrt);
    *reinterpret_cast<float4*>(m) = m4;
    *reinterpret_cast<float4*>(v) = v4;
    *reinterpret_cast<float4*>(p) = p4;
  } else {
    for (int i = 0; i < count; ++i) {
      float pi = p[i], mi = m[i], vi = v[i];
      update(pi, __ldg(g + i), mi, vi, w1, beta2, w2, eps, step_size, bc2_sqrt);
      m[i] = mi;
      v[i] = vi;
      p[i] = pi;
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

int adam_max_leaves() { return kMaxLeaves; }

int adam_leaves_bytes() { return static_cast<int>(sizeof(Leaves)); }

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One Adam step of every leaf of `a` on `device`: the gradients' pointers
// `grads` (one a leaf), the scalars worked out in double (pow, as Python's
// ** is) from each leaf's step count *steps[i] plus one, then one launch on
// `stream`; the raised counts are written back only if the launch succeeded.
// Returns the launch's CUDA error (0: none).
int adam_step(void* leaves, const void* const* grads, float* const* steps, double lr,
              double beta1, double beta2, double eps, int device, void* stream) {
  Leaves& a = *static_cast<Leaves*>(leaves);
  float next[kMaxLeaves];
  for (int i = 0; i < a.n; ++i) {
    a.g[i] = static_cast<const float*>(grads[i]);
    a.vec[i] = aligned16(a.p[i]) && aligned16(a.g[i]) && aligned16(a.m[i]) && aligned16(a.v[i]);
    const float t = next[i] = *steps[i] + 1.0f;
    const double bc1 = 1.0 - pow(beta1, static_cast<double>(t));
    const double bc2 = 1.0 - pow(beta2, static_cast<double>(t));
    a.step_size[i] = static_cast<float>((lr / bc1) * -1.0);
    a.bc2_sqrt[i] = static_cast<float>(pow(bc2, 0.5));
  }
  a.w1 = static_cast<float>(1.0 - beta1);
  a.beta2 = static_cast<float>(beta2);
  a.w2 = static_cast<float>(1.0 - beta2);
  a.eps = static_cast<float>(eps);
  int err = 0;
  if (a.quad_start[a.n] > 0) {  // else every leaf is empty: nothing to launch
    int previous = device;
    cudaGetDevice(&previous);
    if (previous != device) cudaSetDevice(device);
    const int blocks = (a.quad_start[a.n] + kThreads - 1) / kThreads;
    adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (previous != device) cudaSetDevice(previous);
  }
  if (err == 0)
    for (int i = 0; i < a.n; ++i) *steps[i] = next[i];
  return err;
}

}  // extern "C"
