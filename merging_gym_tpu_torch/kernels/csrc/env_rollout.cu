// K1 and K2: the vectorised auto-reset env rollout as one launch.
//
// Replaces merging_gym_tpu/ops/fused_rollout.py:_kernel (K1, trajectories)
// and :_kernel_counters (K2, per-env sums).  On the TPU the time axis was a
// sequential grid with the state in VMEM scratch; here one thread owns one
// env and loops over the T steps with its state in registers.  Writes to
// the env-last [T, c, N] outputs are then coalesced across each warp, and
// K2's counters stay in registers until one final write (no atomics: every
// reduction is per env).
//
// Bound on an H100: K1 moves 68 B per env-step (actions in, obs, rewards
// and events out), so it is bound by memory bytes; K2 moves almost nothing
// and is bound by the env arithmetic.  At 4,096 envs the grid is only 32
// blocks of 128 threads on 132 SMs, so neither comes near its bound; the
// measured times are in PERF.md (chip_smoke.py).
#include <cstdint>

#include "env_math.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kThreads = 128;

template <bool kCounters>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const int32_t* __restrict__ actions,  // [T, 2, N] or null
               float* __restrict__ obs,              // K1: [T, 10, N]
               float* __restrict__ rew,              // K1: [T, 2, N]
               int32_t* __restrict__ done_o,         // K1: [T, N]
               int32_t* __restrict__ win_o,          // K1: [T, N]
               int32_t* __restrict__ col_o,          // K1: [T, N]
               float* __restrict__ rewsum,           // K2: [2, N]
               int32_t* __restrict__ counts,         // K2: [4, N]
               int T, int N, uint32_t k0, uint32_t k1, EnvCfg cfg) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);
  EnvState s;
  start_state(s);
  float rs1 = 0.0f, rs2 = 0.0f;
  int episodes = 0, collisions = 0, wins1 = 0, wins2 = 0;

  for (int t = 0; t < T; ++t) {
    int a1, a2;
    if (actions != nullptr) {
      a1 = actions[(2 * static_cast<size_t>(t)) * sN + n];
      a2 = actions[(2 * static_cast<size_t>(t) + 1) * sN + n];
    } else {
      Bits4 b = draw(static_cast<uint32_t>(t), static_cast<uint32_t>(n),
                     kStreamActions, k0, k1);
      a1 = static_cast<int>(b.x % (kNumActions + 1)) - 1;
      a2 = static_cast<int>(b.y % (kNumActions + 1)) - 1;
    }
    StepOut o = env_step(s, a1, a2, cfg);

    if (kCounters) {
      rs1 = rs1 + o.r1;
      rs2 = rs2 + o.r2;
      episodes += o.done;
      collisions += o.col;
      wins1 += o.done && s.winner == 1 && !o.col;
      wins2 += o.done && s.winner == 2 && !o.col;
    } else {
      float* ob = obs + static_cast<size_t>(t) * 10 * sN + n;
      ob[0 * sN] = o.x2 - o.x1;
      ob[1 * sN] = o.y2 - o.y1;
      ob[2 * sN] = s.vel2 - s.vel1;
      ob[3 * sN] = kEndPoint - s.pos1;
      ob[4 * sN] = s.vel1;
      ob[5 * sN] = o.x1 - o.x2;
      ob[6 * sN] = o.y1 - o.y2;
      ob[7 * sN] = s.vel1 - s.vel2;
      ob[8 * sN] = kEndPoint - s.pos2;
      ob[9 * sN] = s.vel2;
      rew[(2 * static_cast<size_t>(t)) * sN + n] = o.r1;
      rew[(2 * static_cast<size_t>(t) + 1) * sN + n] = o.r2;
      done_o[static_cast<size_t>(t) * sN + n] = o.done;
      win_o[static_cast<size_t>(t) * sN + n] = s.winner;
      col_o[static_cast<size_t>(t) * sN + n] = o.col;
    }
    if (o.done) start_state(s);  // auto-reset to the deterministic start
  }
  if (kCounters) {
    rewsum[n] = rs1;
    rewsum[sN + n] = rs2;
    counts[n] = episodes;
    counts[sN + n] = collisions;
    counts[2 * sN + n] = wins1;
    counts[3 * sN + n] = wins2;
  }
}

inline EnvCfg make_cfg(int max_steps, float r_first, float r_second,
                       float r_collision, float vel_penalty,
                       float time_penalty) {
  return EnvCfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
                max_steps};
}

}  // namespace mgt

extern "C" int mgt_env_rollout(const int32_t* actions, float* obs, float* rew,
                               int32_t* done, int32_t* winner, int32_t* col,
                               int T, int N, uint32_t k0, uint32_t k1,
                               int max_steps, float r_first, float r_second,
                               float r_collision, float vel_penalty,
                               float time_penalty, cudaStream_t stream) {
  using namespace mgt;
  if (T <= 0 || N <= 0) return 0;
  EnvCfg cfg = make_cfg(max_steps, r_first, r_second, r_collision,
                        vel_penalty, time_penalty);
  int blocks = (N + kThreads - 1) / kThreads;
  rollout_kernel<false><<<blocks, kThreads, 0, stream>>>(
      actions, obs, rew, done, winner, col, nullptr, nullptr, T, N, k0, k1,
      cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_env_counters(const int32_t* actions, float* rewsum,
                                int32_t* counts, int T, int N, uint32_t k0,
                                uint32_t k1, int max_steps, float r_first,
                                float r_second, float r_collision,
                                float vel_penalty, float time_penalty,
                                cudaStream_t stream) {
  using namespace mgt;
  if (N <= 0) return 0;
  EnvCfg cfg = make_cfg(max_steps, r_first, r_second, r_collision,
                        vel_penalty, time_penalty);
  int blocks = (N + kThreads - 1) / kThreads;
  rollout_kernel<true><<<blocks, kThreads, 0, stream>>>(
      actions, nullptr, nullptr, nullptr, nullptr, nullptr, rewsum, counts,
      T, N, k0, k1, cfg);
  return static_cast<int>(cudaGetLastError());
}
