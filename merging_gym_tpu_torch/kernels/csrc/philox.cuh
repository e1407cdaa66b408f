// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator that
// replaces the TPU's pltpu.prng_* streams.  ops/philox.py is the same
// generator in plain PyTorch; tests check both against Random123's known
// answers.  Counter layout: (step, env, stream, 0); key: the 64-bit seed.
#pragma once

#include <cstdint>

namespace mgt {

struct Bits4 {
  uint32_t x, y, z, w;
};

constexpr uint32_t kStreamActions = 0;
constexpr uint32_t kStreamReset = 1;
constexpr uint32_t kStreamOpponent = 2;  // K7: the opponent's goal and action
constexpr uint32_t kStreamGoal = 3;      // K7: the goal re-chosen after a step

__device__ __forceinline__ Bits4 philox4x32_10(Bits4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = Bits4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ Bits4 draw(uint32_t step, uint32_t env,
                                      uint32_t stream, uint32_t k0,
                                      uint32_t k1) {
  return philox4x32_10(Bits4{step, env, stream, 0u}, k0, k1);
}

}  // namespace mgt
