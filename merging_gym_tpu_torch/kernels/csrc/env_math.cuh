// One env step of the two-player merging game, for one env in registers.
//
// Shared by the rollout kernels (env_rollout.cu: K1, K2) and the policy
// rollout (policy_rollout.cu: K6).  Mirrors core/env.py:step of the port op
// for op, and through it merging_gym_tpu/ops/fused_rollout.py:_env_step_math.
// Built with -fmad=false and without fast math: every add and multiply is
// rounded on its own and sinf is the accurate library function, as in the
// plain PyTorch version, so the two agree bit for bit.  (An approximate sin
// moves x = R*sin(angle), R = 30,000, by about 1e-2 m, which flips the
// rounded coordinates of the collision test.)
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mgt {

// Constants of core/constants.py.  Each is the Python double rounded once
// to float, as PyTorch rounds a Python scalar against a float tensor.
constexpr float kR = 30000.0f;
constexpr float kTwoR = 60000.0f;
constexpr float kHalfW = 150.0f;
constexpr float kAngle0 = (float)0.033320995878247196;  // atan2(H, R)
constexpr float kStartPoint = 50.0f;
constexpr float kEndPoint = 950.0f;
constexpr float kStartVel = 20.0f;
constexpr float kDT = (float)0.2;
constexpr float kVRef = 20.0f;
constexpr float kPredictionT = 3.0f;
constexpr float kVehicleW = 4.0f;
constexpr float kVehicleH = 8.0f;
constexpr int kNumActions = 5;

struct EnvCfg {
  float r_first, r_second, r_collision, vel_penalty, time_penalty;
  int max_steps;
};

// Per-env state: positions, velocities, winner machine, step counter.
struct EnvState {
  float pos1, pos2, vel1, vel2;
  int winner, t;
};

// Post-step events and the post-step coordinates of both vehicles.
struct StepOut {
  float r1, r2;
  bool done, col;
  float x1, y1, x2, y2;
};

__device__ __forceinline__ void lon2coord(float lon, float side, float& x,
                                          float& y) {
  float angle = kAngle0 - lon / kR;
  x = kR * sinf(angle);
  float half = 0.5f * angle;
  float versine = kTwoR * sinf(half) * sinf(half);
  y = kHalfW + side * versine;
}

__device__ __forceinline__ float round_half_away(float v) {
  float s = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return s * floorf(fabsf(v) + 0.5f);
}

__device__ __forceinline__ float acc_of(int a, float vel) {
  if (a < 0) return 0.0f;  // ACTION_NONE: the L0 arm
  int c = a > kNumActions - 1 ? kNumActions - 1 : a;
  return (10.0f * (float)c - vel) / kPredictionT;  // true division
}

__device__ __forceinline__ float reward_on_cross(bool crossed, int w,
                                                 int self, float pen,
                                                 const EnvCfg& cfg) {
  if (!crossed) return pen;
  if (w == 0) return pen + cfg.r_first;
  if (w == self) return 0.0f;  // already won: overwritten to 0
  return pen + cfg.r_second;
}

__device__ __forceinline__ StepOut env_step(EnvState& s, int a1, int a2,
                                            const EnvCfg& cfg) {
  StepOut o;
  float acc1 = acc_of(a1, s.vel1), acc2 = acc_of(a2, s.vel2);
  s.vel1 = fmaxf(0.0f, s.vel1 + acc1 * kDT);
  s.vel2 = fmaxf(0.0f, s.vel2 + acc2 * kDT);
  s.pos1 = s.pos1 + s.vel1 * kDT;
  s.pos2 = s.pos2 + s.vel2 * kDT;
  s.t = s.t + 1;
  bool done = s.t >= cfg.max_steps;

  float pen1 = -cfg.time_penalty - cfg.vel_penalty * fabsf(s.vel1 - kVRef);
  float pen2 = -cfg.time_penalty - cfg.vel_penalty * fabsf(s.vel2 - kVRef);

  int w0 = s.winner;
  bool c1 = s.pos1 > kEndPoint;   // strict for player 1
  float r1 = reward_on_cross(c1, w0, 1, pen1, cfg);
  done = done || (c1 && w0 == 2);
  int w1 = (c1 && w0 == 0) ? 1 : w0;

  bool c2 = s.pos2 >= kEndPoint;  // inclusive for player 2
  float r2 = reward_on_cross(c2, w1, 2, pen2, cfg);
  done = done || (c2 && w1 == 1);
  s.winner = (c2 && w1 == 0) ? 2 : w1;

  lon2coord(s.pos1, 1.0f, o.x1, o.y1);
  lon2coord(s.pos2, -1.0f, o.x2, o.y2);
  o.col = fabsf(round_half_away(o.x1) - round_half_away(o.x2)) <= kVehicleH &&
          fabsf(round_half_away(o.y1) - round_half_away(o.y2)) <= kVehicleW;
  o.done = done || o.col;
  float penalty = o.col ? cfg.r_collision : 0.0f;
  o.r1 = r1 + penalty;
  o.r2 = r2 + penalty;
  return o;
}

__device__ __forceinline__ void start_state(EnvState& s) {
  s.pos1 = s.pos2 = kStartPoint;
  s.vel1 = s.vel2 = kStartVel;
  s.winner = 0;
  s.t = 0;
}

}  // namespace mgt
