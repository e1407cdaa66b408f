// K1 and K2: the vectorised auto-reset env rollout as one launch.
//
// Replaces merging_gym_tpu/ops/fused_rollout.py:_kernel (K1, trajectories)
// and :_kernel_counters (K2, per-env sums).  On the TPU the time axis was a
// sequential grid with the state in VMEM scratch; here a group of kLanes
// lanes of one warp owns one env and loops over the T steps with its state
// in registers.  The outputs keep the env-last [T, c, N] layout; K2 keeps
// its counters in registers until one final write (no atomics: every
// reduction is per env).
//
// Bound on an H100: K1 moves 68 B per env-step (actions in, obs, rewards
// and events out), so it is bound by memory bytes; K2 moves almost nothing
// and is bound by the env arithmetic.  Neither bound is near: one env-step
// is a chain of dependent latencies (an IEEE division, an accurate sinf,
// the roundings, the collision test, done, the reset) and 4,096 envs give
// only 4,096 such chains, one warp or less for each of the card's 528
// schedulers.  So the design shortens the chain of one step and spreads
// the envs over every SM:
//  * kLanes = 4 lanes an env.  Lane (v, c) computes coordinate c (x, or y)
//    of vehicle v's lon2coord, the longest part of the step, rounds it,
//    and the lanes swap the rounded coordinates with three
//    __shfl_xor_sync; every lane keeps the whole state and does the short
//    rest of the step itself, so one shuffle sits on the chain.
//  * One warp a scheduler issues at most one instruction a cycle and
//    hides no latency with another warp, so the step is written without
//    branches (the only one left is sinf's slow path, never taken): the
//    divisions by constants as one multiply and two fmas (div_rn),
//    acc_of and the rewards as selects, the rounding as copysign.
//  * The reset branch is constant: starts are deterministic, so the
//    kinematics of the first step of an episode depend on the clamped
//    action alone (6 entries, the same for both vehicles).  A block builds
//    that table once into shared memory with env_step's own arithmetic.
//    The next step's kinematics from the continuing state are computed
//    beside this step's collision test and the two are selected by done,
//    so acc_of's division and the velocity and position updates leave the
//    chain.
//  * Actions (actions mode) or Philox draws (seed mode) are fetched in
//    groups of kAhead steps, each lane fetching kAhead / kLanes of them
//    into registers a group before they are stored to a ring of two
//    groups in shared memory, so no load or draw waits on the chain.  The
//    Philox counter stays (step, env, kStreamActions, 0) with env the
//    env's index, so seed-mode actions do not depend on the geometry.
//  * The step loop is not unrolled, so its body stays small (unrolled 8
//    steps deep, K1 was 81 KB of code and ran slower than the parent).
//  * K1: lane l stores words l, l + kLanes, ... of the 15 an env-step
//    (obs, rewards, done, winner, collision), so one store instruction
//    of a warp writes kLanes rows of 32 / kLanes envs.
//  * Built for one geometry: kThreads threads, kThreads / kLanes envs a
//    block (ops/fused_rollout.py:rollout_geometry: 128 blocks at 4,096
//    envs); the entry points refuse any other.
// Every value is env_step's, in its order: env_math.cuh's helpers or the
// branch-free forms below, each equal to them (div_rn by proof and test,
// round_away but for a zero's sign), so K1 and K2 equal their plain
// versions bit for bit.
#include <cstdint>

#include "env_math.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kLanes = 4;
constexpr int kThreads = 128;
constexpr int kEnvsPerBlock = kThreads / kLanes;
constexpr int kAhead = 8;   // steps of actions a group fetches
constexpr int kRing = 2 * kAhead;
constexpr int kMine = kAhead / kLanes;  // steps a lane fetches a group
constexpr int kWords = 15;  // K1's words an env-step: obs 10, rewards 2,
                            // done, winner, collision
constexpr int kSlots = (kWords + kLanes - 1) / kLanes;  // words a lane
static_assert(kLanes == 4, "lane (v, c): a vehicle and a coordinate");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kAhead % kLanes == 0, "each lane fetches kAhead / kLanes");

struct Kin {
  float vel, pos;
};

// x / d rounded to nearest, for d = 3 (acc_of) and d = 30000
// (lon2coord), without the slow-path branch of IEEE division: with
// r = RN(1 / d), q0 = x * r lies within 1.5 ulp of x / d, and one fma
// remainder and one fma correction leave the unrounded result within
// 2^-45 of x / d, relatively.  x / d is never a rounding midpoint and
// lies at least 2^-26 (d = 3) or 2^-35.9 (d = 30000) from every one,
// relatively, so the rounded result is IEEE division's (x normal or 0;
// tests/test_torch_rollout_geometry.py holds it against it).
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q0 = x * r;
  const float rem = __fmaf_rn(-q0, d, x);
  return __fmaf_rn(rem, r, q0);
}
constexpr float kInv3 = 0.3333333432674408f;       // RN(1 / kPredictionT)
constexpr float kInvR = 3.333333370392211e-05f;    // RN(1 / kR)
static_assert(kPredictionT == 3.0f && kR == 30000.0f, "div_rn's divisors");

// env_step's kinematics of one vehicle (acc_of, velocity, position),
// without branches: the quotient is formed and then dropped for a < 0.
__device__ __forceinline__ Kin advance(float vel, float pos, int a) {
  const int c = a > kNumActions - 1 ? kNumActions - 1 : (a < 0 ? 0 : a);
  const float q = div_rn(10.0f * (float)c - vel, kPredictionT, kInv3);
  const float acc = a < 0 ? 0.0f : q;
  const float v = fmaxf(0.0f, vel + acc * kDT);
  return Kin{v, pos + v * kDT};
}

// env_math.cuh:round_half_away as floor(|v| + 0.5) with v's sign: equal
// to it but for the sign of a zero, which no collision test can see.
__device__ __forceinline__ float round_away(float v) {
  return copysignf(floorf(fabsf(v) + 0.5f), v);
}

// env_math.cuh:reward_on_cross without branches.
__device__ __forceinline__ float cross_reward(bool crossed, int w, int self,
                                              float pen, const EnvCfg& cfg) {
  const float first = pen + cfg.r_first, second = pen + cfg.r_second;
  const float on = w == 0 ? first : (w == self ? 0.0f : second);
  return crossed ? on : pen;
}

// An action as the index of its kinematics: -1 and below (no
// acceleration) 0, a >= kNumActions - 1 kNumActions, else a + 1, so that
// acc_of(index - 1, vel) == acc_of(a, vel).
__device__ __forceinline__ uint32_t action_index(int a) {
  return a < 0 ? 0u : (a > kNumActions - 1 ? kNumActions : a + 1);
}

// The packed action indices of step s of env n: player 1 in bits 0-7,
// player 2 in bits 8-15.  Steps past T are never used: they are drawn, or
// loaded from row T - 1.
__device__ __forceinline__ uint32_t fetch_step(
    const int32_t* __restrict__ actions, int s, int T, int n, size_t sN,
    uint32_t k0, uint32_t k1) {
  if (actions != nullptr) {
    const size_t row = 2 * static_cast<size_t>(s < T ? s : T - 1);
    return action_index(actions[row * sN + n]) |
           action_index(actions[(row + 1) * sN + n]) << 8;
  }
  const Bits4 b = draw(static_cast<uint32_t>(s), static_cast<uint32_t>(n),
                       kStreamActions, k0, k1);
  return b.x % (kNumActions + 1) | (b.y % (kNumActions + 1)) << 8;
}

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
  __shared__ Kin reset_kin[kNumActions + 1];
  // The packed actions of two groups of kAhead steps, by step % kRing.
  __shared__ uint32_t ring[kRing][kEnvsPerBlock];
  if (threadIdx.x <= kNumActions)
    reset_kin[threadIdx.x] =
        advance(kStartVel, kStartPoint, static_cast<int>(threadIdx.x) - 1);
  __syncthreads();

  // The lane's role, read through a shuffle: ptxas then keeps it in a
  // register instead of reading the thread index (S2R, slow) again on the
  // chain of every step.
  const int l = __shfl_sync(0xffffffffu, threadIdx.x % kLanes,
                            threadIdx.x % 32);
  const int e = threadIdx.x / kLanes;  // the env within the block
  const int n = blockIdx.x * kEnvsPerBlock + e;
  const unsigned mask = __ballot_sync(0xffffffffu, n < N);
  if (n >= N) return;  // the masked tail: whole groups leave
  const size_t sN = static_cast<size_t>(N);
  // This lane's vehicle and coordinate: l = v + 2c.
  const int v = l & 1;
  const int c = l >> 1;

  // Lane l fetches steps s0 + l + kLanes * j of each group: groups 0 and 1
  // into the ring, group 2 into registers, stored when group 0 is done.
  uint32_t pend[kMine];
  if (T > 0) {
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int s = l + kLanes * j;
      ring[s][e] = fetch_step(actions, s, T, n, sN, k0, k1);
      ring[kAhead + s][e] = fetch_step(actions, kAhead + s, T, n, sN, k0, k1);
      pend[j] = fetch_step(actions, kRing + s, T, n, sN, k0, k1);
    }
  }
  __syncwarp(mask);

  // K1: lane l stores words l + kLanes * j of each env-step, through a
  // pointer that moves on by its array's step.
  char* out_p[kSlots];
  size_t out_step[kSlots];
  if constexpr (!kCounters) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int w = l + kLanes * j;
      out_p[j] = w < 10 ? reinterpret_cast<char*>(obs + w * sN + n)
               : w < 12 ? reinterpret_cast<char*>(rew + (w - 10) * sN + n)
               : w == 12 ? reinterpret_cast<char*>(done_o + n)
               : w == 13 ? reinterpret_cast<char*>(win_o + n)
                         : reinterpret_cast<char*>(col_o + n);
      out_step[j] = 4 * sN * (w < 10 ? 10 : w < 12 ? 2 : 1);
    }
  }

  // Post-step kinematics of step 0, taken from the start state.
  const uint32_t a0 = T > 0 ? ring[0][e] : 0u;
  Kin p1 = reset_kin[a0 & 0xffu], p2 = reset_kin[a0 >> 8];
  float pown = v == 0 ? p1.pos : p2.pos;  // this lane's vehicle's
  uint32_t an = T > 0 ? ring[1][e] : 0u;  // the actions of step t + 1
  int tc = 1, wprev = 0;  // post-step counter; winner before the step
  float rs1 = 0.0f, rs2 = 0.0f;
  int episodes = 0, collisions = 0, wins1 = 0, wins2 = 0;

  for (int t = 0; t < T; ++t) {
    // Step t + 1's kinematics from the continuing state and from the
    // start (its actions read a step ahead): both ready before step t's
    // done is known, and off the chain.
    const Kin n1 = advance(p1.vel, p1.pos, static_cast<int>(an & 0xffu) - 1);
    const Kin n2 = advance(p2.vel, p2.pos, static_cast<int>(an >> 8) - 1);
    const Kin r1 = reset_kin[an & 0xffu], r2 = reset_kin[an >> 8];
    // Step t + 2's actions, from a slot that this step's group boundary
    // does not rewrite.
    const uint32_t an2 = ring[(t + 2) % kRing][e];

    // lon2coord split over the lanes, the head of the chain.  The lanes
    // swap their coordinates rounded for the collision test (K1 also
    // unrounded, for the observation).
    float x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f;  // K1 only
    const float angle = kAngle0 - div_rn(pown, kR, kInvR);
    const float s = sinf(c == 0 ? angle : 0.5f * angle);
    const float vs = kTwoR * s * s;  // the versine of lon2coord
    const float mine =
        c == 0 ? kR * s : (v == 0 ? kHalfW + vs : kHalfW - vs);
    // Lane l ^ 1: the other vehicle; l ^ 2: the other coordinate.  The
    // test takes |a - b| either way round: x lanes |rx_v - rx_v'| and
    // |ry_v - ry_v'|, y lanes the same two the other way round.
    const float r = round_away(mine);
    const float o1 = __shfl_xor_sync(mask, r, 1);
    const float o2 = __shfl_xor_sync(mask, r, 2);
    const float o3 = __shfl_xor_sync(mask, r, 3);
    const float da = fabsf(r - o1), db = fabsf(o2 - o3);
    const bool col = c == 0 ? (da <= kVehicleH) & (db <= kVehicleW)
                            : (db <= kVehicleH) & (da <= kVehicleW);
    if constexpr (!kCounters) {
      const float u1 = __shfl_xor_sync(mask, mine, 1);
      const float u2 = __shfl_xor_sync(mask, mine, 2);
      const float u3 = __shfl_xor_sync(mask, mine, 3);
      x1 = v == 0 ? (c == 0 ? mine : u2) : (c == 0 ? u1 : u3);
      x2 = v == 0 ? (c == 0 ? u1 : u3) : (c == 0 ? mine : u2);
      y1 = v == 0 ? (c == 0 ? u2 : mine) : (c == 0 ? u3 : u1);
      y2 = v == 0 ? (c == 0 ? u3 : u1) : (c == 0 ? u2 : mine);
    }

    // Step t's events from its post-step state: env_step after the
    // kinematics, line for line, without branches.
    bool done = tc >= cfg.max_steps;
    const float pen1 =
        -cfg.time_penalty - cfg.vel_penalty * fabsf(p1.vel - kVRef);
    const float pen2 =
        -cfg.time_penalty - cfg.vel_penalty * fabsf(p2.vel - kVRef);
    const int w0 = wprev;
    const bool c1 = p1.pos > kEndPoint;  // strict for player 1
    float rw1 = cross_reward(c1, w0, 1, pen1, cfg);
    done = done | (c1 & (w0 == 2));
    const int w1 = (c1 & (w0 == 0)) ? 1 : w0;
    const bool c2 = p2.pos >= kEndPoint;  // inclusive for player 2
    float rw2 = cross_reward(c2, w1, 2, pen2, cfg);
    done = done | (c2 & (w1 == 1));
    const int winner = (c2 & (w1 == 0)) ? 2 : w1;
    done = done | col;
    const float penalty = col ? cfg.r_collision : 0.0f;
    rw1 = rw1 + penalty;
    rw2 = rw2 + penalty;

    if constexpr (kCounters) {
      rs1 = rs1 + rw1;
      rs2 = rs2 + rw2;
      episodes += done;
      collisions += col;
      wins1 += done && winner == 1 && !col;
      wins2 += done && winner == 2 && !col;
    } else {
      const uint32_t word[kWords] = {
          __float_as_uint(x2 - x1), __float_as_uint(y2 - y1),
          __float_as_uint(p2.vel - p1.vel),
          __float_as_uint(kEndPoint - p1.pos), __float_as_uint(p1.vel),
          __float_as_uint(x1 - x2), __float_as_uint(y1 - y2),
          __float_as_uint(p1.vel - p2.vel),
          __float_as_uint(kEndPoint - p2.pos), __float_as_uint(p2.vel),
          __float_as_uint(rw1), __float_as_uint(rw2),
          static_cast<uint32_t>(done), static_cast<uint32_t>(winner),
          static_cast<uint32_t>(col)};
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        uint32_t x = word[kLanes * j];
#pragma unroll
        for (int i = 1; i < kLanes; ++i)
          if (kLanes * j + i < kWords) x = l == i ? word[kLanes * j + i] : x;
        if (l + kLanes * j < kWords) {
          *reinterpret_cast<uint32_t*>(out_p[j]) = x;
          out_p[j] += out_step[j];
        }
      }
    }
    // Auto-reset: the start's kinematics where the episode ended.
    pown = done ? (v == 0 ? r1.pos : r2.pos) : (v == 0 ? n1.pos : n2.pos);
    p1 = done ? r1 : n1;
    p2 = done ? r2 : n2;
    tc = done ? 1 : tc + 1;
    wprev = done ? 0 : winner;

    if (t % kAhead == kAhead - 1) {
      // Group g = t / kAhead is read; group g + 2, fetched a group ago,
      // takes its slots, and group g + 3 is fetched.
      const int s0 = t + 1 + kAhead;
      __syncwarp(mask);
#pragma unroll
      for (int j = 0; j < kMine; ++j)
        ring[(s0 + l + kLanes * j) % kRing][e] = pend[j];
      __syncwarp(mask);
#pragma unroll
      for (int j = 0; j < kMine; ++j)
        pend[j] = fetch_step(actions, s0 + kAhead + l + kLanes * j, T, n, sN,
                             k0, k1);
    }
    an = an2;
  }
  if constexpr (kCounters) {
#pragma unroll
    for (int w = 0; w < 6; ++w) {
      if (w % kLanes != l) continue;
      switch (w) {
        case 0: rewsum[n] = rs1; break;
        case 1: rewsum[sN + n] = rs2; break;
        case 2: counts[n] = episodes; break;
        case 3: counts[sN + n] = collisions; break;
        case 4: counts[2 * sN + n] = wins1; break;
        default: counts[3 * sN + n] = wins2; break;
      }
    }
  }
}

inline EnvCfg make_cfg(int max_steps, float r_first, float r_second,
                       float r_collision, float vel_penalty,
                       float time_penalty) {
  return EnvCfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
                max_steps};
}

// The one geometry this file is built for, at N envs.
inline bool geometry_ok(int lanes, int threads, int blocks, int N) {
  return lanes == kLanes && threads == kThreads &&
         blocks == (N + kEnvsPerBlock - 1) / kEnvsPerBlock;
}

}  // namespace mgt

extern "C" int mgt_env_rollout(const int32_t* actions, float* obs, float* rew,
                               int32_t* done, int32_t* winner, int32_t* col,
                               int T, int N, uint32_t k0, uint32_t k1,
                               int max_steps, float r_first, float r_second,
                               float r_collision, float vel_penalty,
                               float time_penalty, int lanes, int threads,
                               int blocks, cudaStream_t stream) {
  using namespace mgt;
  if (N <= 0) return 0;
  if (!geometry_ok(lanes, threads, blocks, N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  EnvCfg cfg = make_cfg(max_steps, r_first, r_second, r_collision,
                        vel_penalty, time_penalty);
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
                                int lanes, int threads, int blocks,
                                cudaStream_t stream) {
  using namespace mgt;
  if (N <= 0) return 0;
  if (!geometry_ok(lanes, threads, blocks, N))
    return static_cast<int>(cudaErrorInvalidValue);
  EnvCfg cfg = make_cfg(max_steps, r_first, r_second, r_collision,
                        vel_penalty, time_penalty);
  rollout_kernel<true><<<blocks, kThreads, 0, stream>>>(
      actions, nullptr, nullptr, nullptr, nullptr, nullptr, rewsum, counts,
      T, N, k0, k1, cfg);
  return static_cast<int>(cudaGetLastError());
}
