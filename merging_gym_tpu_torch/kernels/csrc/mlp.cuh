// The types every kernel's nets share (Num, Net, MlpDims, Offsets), the
// first-occurrence argmax and the Phi(eps)-greedy pick.
//
// Every forward of the port runs qnet_tiled.cuh's register micro-tiles:
// each output of a layer is one thread's sum over the inputs in order, in
// f32, with one rounding per multiply and per add (__fmul_rn/__fadd_rn are
// never contracted into an FMA) -- the arithmetic of
// ops/fused_mlp.py:mlp_plain.  No tensor cores: TF32 would break f32
// agreement with the plain version.  In bf16 (T = __nv_bfloat16) weights
// and activations are stored in bf16, products are exact in f32, each
// layer's sum is rounded to bf16 and the bias is added in bf16
// (merging_gym_tpu/ops/fused_policy_rollout.py:_mlp_t).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace mgt {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// One Q-net's parameters: w_i [in_i, out_i] row-major, b_i [out_i].
template <typename T>
struct Net {
  const T *w0, *b0, *w1, *b1, *w2, *b2;
};

struct MlpDims {
  int in, h1, h2, a;
};

// Offsets of the six tensors in one flat parameter buffer (the trainers'
// layout): w0 [in][h1], b0 [h1], w1 [h1][h2], b1 [h2], w2 [h2][a], b2 [a].
struct Offsets {
  int w0, b0, w1, b1, w2, b2, P;
  __host__ __device__ explicit Offsets(MlpDims d) {
    w0 = 0;
    b0 = w0 + d.in * d.h1;
    w1 = b0 + d.h1;
    b1 = w1 + d.h1 * d.h2;
    w2 = b1 + d.h2;
    b2 = w2 + d.h2 * d.a;
    P = b2 + d.a;
  }
};

template <typename T>
Net<T> net_at(const void* flat, MlpDims d) {
  const T* f = static_cast<const T*>(flat);
  Offsets o(d);
  return Net<T>{f + o.w0, f + o.b0, f + o.w1, f + o.b1, f + o.w2, f + o.b2};
}

// First-occurrence argmax over q[0..a).
__device__ __forceinline__ int argmax0(const float* q, int a) {
  int best = 0;
  float best_q = q[0];
  for (int j = 1; j < a; ++j) {
    if (q[j] > best_q) {
      best_q = q[j];
      best = j;
    }
  }
  return best;
}

// The Phi(eps)-greedy pick shared by K4, K5 and K6 (the reference's
// "randn() <= eps" rule, main.py:105, as one uniform draw): keep the
// greedy action iff the mask word is below Phi(eps) * 2^32, else take the
// random word modulo the action count (ops/fused_actor.py:select).
__device__ __forceinline__ int phi_select(int greedy_a, uint32_t mask,
                                          uint32_t rand, uint32_t threshold,
                                          int a) {
  return mask < threshold ? greedy_a
                          : static_cast<int>(rand % static_cast<uint32_t>(a));
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mgt
