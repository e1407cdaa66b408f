// The Q-net forward of a tile of rows, for all threads of a block.
//
// Shared by K3 (qnet_mlp.cu) and K6 (policy_rollout.cu), so a greedy
// evaluation through K3 and one through K6 pick the same actions.  Each
// output of a layer is one thread's sum over the inputs in order, in f32,
// with one rounding per multiply and per add (__fmul_rn/__fadd_rn are never
// contracted into an FMA) -- the arithmetic of ops/fused_mlp.py:mlp_plain.
// No tensor cores: TF32 would break f32 agreement with the plain version.
// In bf16 (T = __nv_bfloat16) weights and activations are stored in bf16,
// products are exact in f32, each layer's sum is rounded to bf16 and the
// bias is added in bf16 (merging_gym_tpu/ops/fused_policy_rollout.py:_mlp_t).
#pragma once

#include <cuda_bf16.h>

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// y[r][j] = T(sum_k x[r][k] * w[k][j]) + b[j], then ReLU if kRelu.
template <typename T, bool kRelu, typename Y>
__device__ __forceinline__ void dense(const T* x, int rows, int K,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b, int J, Y* y) {
  for (int i = threadIdx.x; i < rows * J; i += blockDim.x) {
    const int r = i / J, j = i - r * J;
    const T* xr = x + r * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(Num<T>::to_f(xr[k]),
                                     Num<T>::to_f(w[k * J + j])));
    float h = Num<T>::to_f(Num<T>::from_f(acc));       // round to T
    h = Num<T>::to_f(Num<T>::from_f(__fadd_rn(h, Num<T>::to_f(b[j]))));
    if (kRelu) h = h > 0.0f ? h : 0.0f;
    store(y + i, h);
  }
}

// q[r][a] (f32) of rows x[r] (f32, [rows][in]); s_in/s_h1/s_h2 are shared
// scratch of rows*in, rows*h1 and rows*h2 elements.  Starts and ends with
// a block-wide barrier, so callers may write x before and read q after.
template <typename T>
__device__ void mlp_tile(const float* x, int rows, MlpDims d, Net<T> net,
                         T* s_in, T* s_h1, T* s_h2, float* q) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d.in; i += blockDim.x)
    s_in[i] = Num<T>::from_f(x[i]);
  __syncthreads();
  dense<T, true>(s_in, rows, d.in, net.w0, net.b0, d.h1, s_h1);
  __syncthreads();
  dense<T, true>(s_h1, rows, d.h1, net.w1, net.b1, d.h2, s_h2);
  __syncthreads();
  dense<T, false>(s_h2, rows, d.h2, net.w2, net.b2, d.a, q);
  __syncthreads();
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

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mgt
