// K6: the learned-policy rollout as one launch.
//
// Replaces merging_gym_tpu/ops/fused_policy_rollout.py:_kernel (with its
// helpers _mlp_t, _argmax0 and _select).  Per step, both players' Q-nets
// act on the pre-step observation (player 2 on the half-swapped view, or
// L0), the actions are picked greedily or by the Phi(eps)-greedy quirk, the
// env steps and auto-resets, and only the events are written.
//
// A block owns `tile` envs.  Each env's state and its cached post-step
// coordinates live in the registers of thread `env % tile`; the Q-net
// layers are spread over all the block's threads with the activations in
// shared memory (mlp.cuh, the K3 code), the weights read through L1/L2.
//
// Bound on an H100: 2 nets x 2 x 22,500 flops per env-step against 28 B
// of output, so the kernel is bound by f32 operations on the CUDA cores;
// at 4,096 envs x 2,600 steps that is 958 GFLOP.  Its measured time beside
// that bound is in PERF.md (chip_smoke.py).
#include <cstdint>

#include "env_math.cuh"
#include "mlp.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kPolicyThreads = 256;

struct PolicyCfg {
  int p2_mlp, greedy, random_start;
  uint32_t threshold, k0, k1;
};

// Reset values from Philox stream 1 (ops/fused_rollout.py:random_reset_vals).
__device__ __forceinline__ void random_start(EnvState& s, uint32_t step,
                                             uint32_t env, uint32_t k0,
                                             uint32_t k1) {
  Bits4 b = draw(step, env, kStreamReset, k0, k1);
  const float scale = 1.0f / 16777216.0f;
  float u0 = static_cast<float>(b.x >> 8) * scale;
  float u1 = static_cast<float>(b.y >> 8) * scale;
  float u2 = static_cast<float>(b.z >> 8) * scale;
  float u3 = static_cast<float>(b.w >> 8) * scale;
  float r = sqrtf(-2.0f * logf(fmaxf(u0, (float)1e-7)));
  float theta = (float)(2.0 * 3.14159265358979) * u1;
  float z1 = r * cosf(theta), z2 = r * sinf(theta);
  s.pos1 = kStartPoint + 5.0f * z1;
  s.pos2 = kStartPoint + (u2 * kVehicleH - kVehicleH / 2.0f);
  s.vel1 = kStartVel + 3.0f * z2;
  s.vel2 = (kStartVel - 5.0f) + 15.0f * u3;
  s.winner = 0;
  s.t = 0;
}

template <typename T>
__global__ void __launch_bounds__(kPolicyThreads)
policy_kernel(Net<T> net1, Net<T> net2, int32_t* __restrict__ act_o,
              float* __restrict__ rew_o, int32_t* __restrict__ done_o,
              int32_t* __restrict__ win_o, int32_t* __restrict__ col_o,
              int T_steps, int N, int tile, MlpDims d, PolicyCfg pc,
              EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* obs1 = reinterpret_cast<float*>(smem);  // [tile][10]
  float* obs2 = obs1 + tile * 10;                // [tile][10]
  float* q1 = obs2 + tile * 10;                  // [tile][a]
  float* q2 = q1 + tile * d.a;                   // [tile][a]
  T* s_in = reinterpret_cast<T*>(q2 + tile * d.a);
  T* s_h1 = s_in + tile * d.in;
  T* s_h2 = s_h1 + tile * d.h1;

  const int env0 = blockIdx.x * tile;
  const int rows = min(tile, N - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const uint32_t env = static_cast<uint32_t>(env0 + e);
  const size_t sN = static_cast<size_t>(N);

  float sx1, sy1, sx2, sy2;  // coordinates of the deterministic start
  lon2coord(kStartPoint, 1.0f, sx1, sy1);
  lon2coord(kStartPoint, -1.0f, sx2, sy2);

  EnvState s;
  float x1 = sx1, y1 = sy1, x2 = sx2, y2 = sy2;
  start_state(s);
  if (owner && pc.random_start) {
    random_start(s, 0u, env, pc.k0, pc.k1);
    lon2coord(s.pos1, 1.0f, x1, y1);
    lon2coord(s.pos2, -1.0f, x2, y2);
  }

  for (int t = 0; t < T_steps; ++t) {
    if (owner) {  // pre-step observation from the cached coordinates
      float o[10] = {x2 - x1, y2 - y1, s.vel2 - s.vel1, kEndPoint - s.pos1,
                     s.vel1,  x1 - x2, y1 - y2, s.vel1 - s.vel2,
                     kEndPoint - s.pos2, s.vel2};
      for (int k = 0; k < 10; ++k) {
        obs1[e * 10 + k] = o[k];
        obs2[e * 10 + k] = o[(k + 5) % 10];
      }
    }
    mlp_tile<T>(obs1, rows, d, net1, s_in, s_h1, s_h2, q1);
    if (pc.p2_mlp) mlp_tile<T>(obs2, rows, d, net2, s_in, s_h1, s_h2, q2);
    if (!owner) continue;

    int a1 = argmax0(q1 + e * d.a, d.a);
    int a2 = pc.p2_mlp ? argmax0(q2 + e * d.a, d.a) : -1;
    if (!pc.greedy) {
      Bits4 b = draw(static_cast<uint32_t>(t), env, kStreamActions, pc.k0,
                     pc.k1);
      if (b.x >= pc.threshold) a1 = static_cast<int>(b.y % d.a);
      if (pc.p2_mlp && b.z >= pc.threshold) a2 = static_cast<int>(b.w % d.a);
    }
    StepOut o = env_step(s, a1, a2, cfg);

    const size_t row = static_cast<size_t>(t) * sN + env;
    act_o[2 * static_cast<size_t>(t) * sN + env] = a1;
    act_o[(2 * static_cast<size_t>(t) + 1) * sN + env] = a2;
    rew_o[2 * static_cast<size_t>(t) * sN + env] = o.r1;
    rew_o[(2 * static_cast<size_t>(t) + 1) * sN + env] = o.r2;
    done_o[row] = o.done;
    win_o[row] = s.winner;
    col_o[row] = o.col;

    x1 = o.x1; y1 = o.y1; x2 = o.x2; y2 = o.y2;
    if (o.done) {  // auto-reset, coordinates cache included
      if (pc.random_start) {
        random_start(s, static_cast<uint32_t>(t), env, pc.k0, pc.k1);
        lon2coord(s.pos1, 1.0f, x1, y1);
        lon2coord(s.pos2, -1.0f, x2, y2);
      } else {
        start_state(s);
        x1 = sx1; y1 = sy1; x2 = sx2; y2 = sy2;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* const* w1, const void* const* w2,
                   int32_t* act, float* rew, int32_t* done, int32_t* win,
                   int32_t* col, int T_steps, int N, int tile, MlpDims d,
                   PolicyCfg pc, EnvCfg cfg, cudaStream_t stream) {
  auto net = [](const void* const* w) {
    return Net<T>{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
                  static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
                  static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  };
  size_t smem = static_cast<size_t>(tile) * (20 + 2 * d.a) * sizeof(float) +
                static_cast<size_t>(tile) * (d.in + d.h1 + d.h2) * sizeof(T);
  cudaError_t err = allow_smem(policy_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (N + tile - 1) / tile;
  policy_kernel<T><<<blocks, kPolicyThreads, smem, stream>>>(
      net(w1), net(pc.p2_mlp ? w2 : w1), act, rew, done, win, col, T_steps,
      N, tile, d, pc, cfg);
  return cudaGetLastError();
}

}  // namespace mgt

extern "C" int mgt_policy_rollout(
    const void* w10, const void* b10, const void* w11, const void* b11,
    const void* w12, const void* b12, const void* w20, const void* b20,
    const void* w21, const void* b21, const void* w22, const void* b22,
    int32_t* act, float* rew, int32_t* done, int32_t* win, int32_t* col,
    int T, int N, int in, int h1, int h2, int a, int tile, int p2_mlp,
    int greedy, uint32_t threshold, int random_start, int bf16, uint32_t k0,
    uint32_t k1, int max_steps, float r_first, float r_second,
    float r_collision, float vel_penalty, float time_penalty,
    cudaStream_t stream) {
  using namespace mgt;
  if (T <= 0 || N <= 0) return 0;
  if (tile > kPolicyThreads) return static_cast<int>(cudaErrorInvalidValue);
  const void* w1[6] = {w10, b10, w11, b11, w12, b12};
  const void* w2[6] = {w20, b20, w21, b21, w22, b22};
  MlpDims d{in, h1, h2, a};
  PolicyCfg pc{p2_mlp, greedy, random_start, threshold, k0, k1};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(w1, w2, act, rew, done, win, col, T, N,
                                   tile, d, pc, cfg, stream)
           : launch<float>(w1, w2, act, rew, done, win, col, T, N, tile, d,
                           pc, cfg, stream);
  return static_cast<int>(err);
}
