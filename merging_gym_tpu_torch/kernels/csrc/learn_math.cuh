// Arithmetic shared by the trainers' learners and Adam: K5 and K7
// (dqn_trainer.cu), K8 (rainbow_trainer.cu) and K9 (drqn_trainer.cu).
//
// Every operation rounds once (__fmul_rn/__fadd_rn are never contracted
// into an FMA), so the plain versions (ops/fused_trainer.py:_adam_plain)
// repeat them bit for bit.
#pragma once

#include "common.cuh"

namespace mgt {

// acc + x * y with two roundings.
__device__ __forceinline__ float madd(float acc, float x, float y) {
  return __fadd_rn(acc, __fmul_rn(x, y));
}

// optax's Adam in f32; c1, c2 are the bias corrections 1 - b^t of this
// step, omb1 = 1 - b1 and omb2 = 1 - b2 as the host rounded them.
struct AdamHyper {
  float lr, b1, b2, omb1, omb2, eps, c1, c2;
};

// One Adam step of parameter i with gradient g; returns the new value.
__device__ __forceinline__ float adam_step(float g, float* __restrict__ p,
                                           float* __restrict__ m,
                                           float* __restrict__ v, int i,
                                           const AdamHyper& h) {
  const float mi = __fadd_rn(__fmul_rn(h.b1, m[i]), __fmul_rn(h.omb1, g));
  const float vi = __fadd_rn(__fmul_rn(h.b2, v[i]),
                             __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float upd = __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(mi, h.c1)),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, h.c2)),
                                        h.eps));
  const float pn = __fsub_rn(p[i], upd);
  p[i] = pn;
  m[i] = mi;
  v[i] = vi;
  return pn;
}

}  // namespace mgt
