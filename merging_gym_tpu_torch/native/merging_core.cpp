// Native host-side runtime for the merging environment.
//
// The reference's per-step hot path runs through third-party native code:
// a quadprog QP solve (scripts/helper.py:182) and a GEOS polygon
// intersection (merging_gym/envs/merging_env.py:201-203) on every step.
// This module is the framework's own native equivalent: the closed-form
// control law, exact winner/reward state machine and rounded-AABB
// collision compiled to a batch-stepping C core, plus a dense
// equality-constrained KKT solver standing in for quadprog.
//
// A copy of native/merging_core.cpp for the PyTorch port, used from
// Python via ctypes (merging_gym_tpu_torch/core/native.py) for the
// host-side paths where a device round-trip is overkill: human play,
// single-env evaluation, CPU trajectory generation, and as a second
// independent parity oracle against core/oracle.py.
//
// Semantics mirror merging_env.py:138-195 statement for statement; see
// core/oracle.py for the line-by-line citations.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr double R = 30000.0;
constexpr double H = 1000.0;
constexpr double W = 300.0;
constexpr double DT = 0.2;
constexpr double START_POINT = 50.0;
constexpr double END_POINT = H - 50.0;
constexpr double VEHICLE_W = 4.0;
constexpr double VEHICLE_H = 8.0;
constexpr double PREDICTION_T = 3.0;
constexpr double V_REF = 20.0;
constexpr int TIMEOUT_STEPS = 2501;  // see core/constants.py
const double TARGET_VELS[5] = {0.0, 10.0, 20.0, 30.0, 40.0};

inline double round_half_away(double v) {
  return std::copysign(std::floor(std::fabs(v) + 0.5), v);
}

inline void lon2coord(double lon, double side, double* x, double* y) {
  const double angle = std::atan2(H, R) - lon / R;
  *x = R * std::sin(angle);
  *y = W / 2 + side * (R - R * std::cos(angle));  // oracle-exact form
}

inline bool collided(double pos1, double pos2) {
  double x1, y1, x2, y2;
  lon2coord(pos1, +1.0, &x1, &y1);
  lon2coord(pos2, -1.0, &x2, &y2);
  const double dlon = std::fabs(round_half_away(x1) - round_half_away(x2));
  const double dlat = std::fabs(round_half_away(y1) - round_half_away(y2));
  return dlon <= VEHICLE_H && dlat <= VEHICLE_W;
}

}  // namespace

extern "C" {

// Per-env state layout (doubles): pos1, vel1, acc1, pos2, vel2, acc2,
// r1_acc, r2_acc, time_stamp; (int32): t, winner, done.
struct EnvState {
  double pos1, vel1, acc1;
  double pos2, vel2, acc2;
  double r1_acc, r2_acc;
  double time_stamp;
  int32_t t, winner, done;
};

struct StepOut {
  double obs[10];
  double r1, r2;
  int32_t done, collision, winner;
};

void merge_reset(EnvState* s, int n) {
  for (int i = 0; i < n; ++i) {
    s[i] = EnvState{START_POINT, 20.0, 0.0, START_POINT, 20.0, 0.0,
                    0.0, 0.0, 0.0, 0, 0, 0};
  }
}

void merge_observe(const EnvState* s, int n, double* obs /* n x 10 */) {
  for (int i = 0; i < n; ++i) {
    double x1, y1, x2, y2;
    lon2coord(s[i].pos1, +1.0, &x1, &y1);
    lon2coord(s[i].pos2, -1.0, &x2, &y2);
    double* o = obs + 10 * i;
    o[0] = x2 - x1;
    o[1] = y2 - y1;
    o[2] = s[i].vel2 - s[i].vel1;
    o[3] = END_POINT - s[i].pos1;
    o[4] = s[i].vel1;
    o[5] = x1 - x2;
    o[6] = y1 - y2;
    o[7] = s[i].vel1 - s[i].vel2;
    o[8] = END_POINT - s[i].pos2;
    o[9] = s[i].vel2;
  }
}

// Batched step; actions < 0 mean "None" (acceleration forced to 0).
// Rewards parameterised as in EnvParams.
void merge_step(EnvState* s, const int32_t* a1, const int32_t* a2, int n,
                double r_first, double r_second, double r_collision,
                double vel_penalty, double time_penalty, StepOut* out) {
  for (int i = 0; i < n; ++i) {
    EnvState& e = s[i];
    e.time_stamp += DT;
    e.t += 1;
    if (e.t >= TIMEOUT_STEPS) e.done = 1;

    // Clamp to the action table like the jnp env (out-of-range reads
    // would be UB); negatives mean the "None" constant-velocity arm.
    const int c1 = a1[i] > 4 ? 4 : a1[i];
    e.acc1 = a1[i] < 0 ? 0.0 : (TARGET_VELS[c1] - e.vel1) / PREDICTION_T;
    e.vel1 = std::fmax(0.0, e.vel1 + e.acc1 * DT);
    e.pos1 += e.vel1 * DT;

    const int c2 = a2[i] > 4 ? 4 : a2[i];
    e.acc2 = a2[i] < 0 ? 0.0 : (TARGET_VELS[c2] - e.vel2) / PREDICTION_T;
    e.vel2 = std::fmax(0.0, e.vel2 + e.acc2 * DT);
    e.pos2 += e.vel2 * DT;

    double r1 = -time_penalty - vel_penalty * std::fabs(e.vel1 - V_REF);
    double r2 = -time_penalty - vel_penalty * std::fabs(e.vel2 - V_REF);

    if (e.pos1 > END_POINT) {
      if (e.winner == 0) {
        e.winner = 1;
        r1 += r_first;
      } else if (e.winner == 1) {
        r1 = 0.0;
      } else {
        r1 += r_second;
        e.done = 1;
      }
    }
    if (e.pos2 >= END_POINT) {
      if (e.winner == 0) {
        e.winner = 2;
        r2 += r_first;
      } else if (e.winner == 2) {
        r2 = 0.0;
      } else {
        r2 += r_second;
        e.done = 1;
      }
    }

    int32_t col = 0;
    if (collided(e.pos1, e.pos2)) {
      e.done = 1;
      r1 += r_collision;
      r2 += r_collision;
      col = 1;
    }

    e.r1_acc += r1;
    e.r2_acc += r2;

    StepOut& o = out[i];
    merge_observe(&e, 1, o.obs);
    o.r1 = r1;
    o.r2 = r2;
    o.done = e.done;
    o.collision = col;
    o.winner = e.winner;
  }
}

// Serial rollout with a fixed action table: steps until done or len
// exhausted.  Returns number of steps taken.  obs_out may be null.
int merge_rollout(EnvState* s, const int32_t* a1, const int32_t* a2, int len,
                  double r_first, double r_second, double r_collision,
                  double vel_penalty, double time_penalty,
                  double* obs_out /* len x 10 */, double* rew_out /* len x 2 */) {
  StepOut o;
  for (int t = 0; t < len; ++t) {
    merge_step(s, a1 + t, a2 + t, 1, r_first, r_second, r_collision,
               vel_penalty, time_penalty, &o);
    if (obs_out) std::memcpy(obs_out + 10 * t, o.obs, sizeof(o.obs));
    if (rew_out) {
      rew_out[2 * t] = o.r1;
      rew_out[2 * t + 1] = o.r2;
    }
    if (o.done) return t + 1;
  }
  return len;
}

// Dense equality-constrained QP via the KKT system with partial-pivot
// Gaussian elimination: min 1/2 u'Pu + q'u  s.t.  Au = b.
// P: n x n, A: m x n. Solution written to u (length n).
// Returns 0 on success, -1 on singular system.  Native replacement for
// the reference's quadprog backend (helper.py:182).
int eq_qp_solve(const double* P, const double* q, const double* A,
                const double* b, int n, int m, double* u) {
  const int dim = n + m;
  if (dim > 256) return -1;
  double M[256 * 257];  // augmented [KKT | rhs]
  const int stride = dim + 1;
  for (int i = 0; i < dim; ++i)
    for (int j = 0; j <= dim; ++j) M[i * stride + j] = 0.0;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) M[i * stride + j] = P[i * n + j];
    for (int j = 0; j < m; ++j) M[i * stride + (n + j)] = A[j * n + i];
    M[i * stride + dim] = -q[i];
  }
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) M[(n + i) * stride + j] = A[i * n + j];
    M[(n + i) * stride + dim] = b[i];
  }
  // Gaussian elimination with partial pivoting.
  for (int col = 0; col < dim; ++col) {
    int piv = col;
    for (int r = col + 1; r < dim; ++r)
      if (std::fabs(M[r * stride + col]) > std::fabs(M[piv * stride + col]))
        piv = r;
    if (std::fabs(M[piv * stride + col]) < 1e-12) return -1;
    if (piv != col)
      for (int j = 0; j <= dim; ++j)
        std::swap(M[piv * stride + j], M[col * stride + j]);
    const double d = M[col * stride + col];
    for (int r = 0; r < dim; ++r) {
      if (r == col) continue;
      const double f = M[r * stride + col] / d;
      if (f == 0.0) continue;
      for (int j = col; j <= dim; ++j) M[r * stride + j] -= f * M[col * stride + j];
    }
  }
  for (int i = 0; i < n; ++i) u[i] = M[i * stride + dim] / M[i * stride + i];
  return 0;
}

// The reference mpc_1d (helper.py:152-191): returns u[0].
double mpc_1d_action(double v0, double vt, double t) {
  constexpr int T = 10;
  const double dt = t / T;
  double P[T * T] = {};
  for (int i = 0; i + 1 < T; ++i) {
    // p'p for the first-difference operator + 0.01 I
    P[i * T + i] += 1.0;
    P[(i + 1) * T + (i + 1)] += 1.0;
    P[i * T + (i + 1)] -= 1.0;
    P[(i + 1) * T + i] -= 1.0;
  }
  for (int i = 0; i < T; ++i) P[i * T + i] += 0.01;
  double q[T] = {};
  double A[T];
  for (int i = 0; i < T; ++i) A[i] = dt;
  double b = vt - v0;
  double u[T];
  if (eq_qp_solve(P, q, A, &b, T, 1, u) != 0) return (vt - v0) / t;
  return u[0];
}

}  // extern "C"
