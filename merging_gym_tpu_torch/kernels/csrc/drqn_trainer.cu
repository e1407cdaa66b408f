// K9: the whole recurrent DQN (DRQN) trainer, one step as up to three
// kernels.
//
// Replaces merging_gym_tpu/ops/fused_drqn.py:_kernel, both of its call
// forms (_call, the VMEM ring, and _call_hbm, the HBM ring: on the card the
// ring always lives in device memory), with its helpers _cell_fwd,
// _cell_fwd_pair, drqn_learn_math and slab_to_batch.  On the TPU a chunk of
// T steps was the sequential grid of one launch with all state in VMEM, and
// the learner reduced over the whole batch on every step.  Blocks of an
// H100 run in no order and carry nothing across a grid, so a step is a
// sequence on one stream, issued by ops/fused_drqn.py:launch_drqn with no
// read-back inside a chunk (K5's design, dqn_trainer.cu).  The learn gate,
// the learn count, the target sync and Adam's step depend only on host
// counters, so they are launch arguments:
//
//   1. drqn_act: a block owns 16 envs.  The recurrent forward of each seat
//      from its own h/c (cell_tile: fc1, fc2, the LSTM cell, fc3, fc4; the
//      opponent is the live net on the half-swapped obs, a frozen net, or
//      L0), the first-occurrence argmax and the Phi(eps) pick on Philox
//      stream 0, the env step (env_math.cuh), the write of window slot
//      wl + 1 (the pre-reset obs, action, reward, done), the auto-reset, on
//      the window's last step the copy of the env's window column into ring
//      round r_cur and the post-reset obs into slot 0, the metrics, and the
//      h/c of both seats zeroed where the episode ended.
//   2. drqn_learn (learning steps): a block owns 4 sampled windows.  The
//      valid count msum over the whole batch (past burn-in, before the
//      first in-window done) as an integer, which is exact in any order;
//      the forward of the eval and target nets over all L + 1 timesteps
//      from zero state; per-timestep Double-DQN targets; dq =
//      onehot * ((2 / msum) * mask * diff); the hand backprop through the
//      heads (t < L), the LSTM recurrence from t = L - 1 down to 0, fc2 and
//      fc1; and the block's partial sums of all twelve gradients and of
//      mask * diff^2 over its rows (window by window, t in order).
//   3. drqn_adam (learning steps): one thread per parameter sums the
//      partials in block order (no atomics), copies tp := p first on a sync
//      step, and applies Adam; the loss is the summed mask * diff^2 / msum.
//
// The learner's memory: the backward needs, per window and timestep, the
// gates, c_prev, tanh(c), h, fc2's output and the head's pre-activation
// (~200 floats with the target net's), and fc1's pre-activation (200).  At
// 4 windows x 17 timesteps the first part (with the backward's own rows)
// is 119 KB of shared memory at L 16; fc1 is recomputed window by window
// where the fc1 and fc2 gradients need it (~7% more operations, nothing
// of it in device memory).  Those two gradients accumulate across the
// windows in the block's row of `work` (each thread re-reads its own
// running sum), which keeps the one order 0 + row 0 + row 1 + ...
//
// Every sum is one thread's, in index order from 0, with one rounding per
// multiply and per add (-fmad=false; the learner spells it with the
// intrinsics), sigmoid is 1 / (1 + expf(-x)) as one IEEE division and tanh
// is tanhf, the accurate library functions.  Two runs on the same inputs
// give the same bits, and the plain version (ops/fused_drqn.py:
// fused_drqn_chunk_plain) repeats every order, so the two agree bit for
// bit.  Layouts (ops/fused_drqn.py): a parameter set is one flat f32 buffer
// of 7,949 values, fc1 w [10][200], b; fc2 w [200][16], b; w_ih [16][64],
// b_ih; w_hh [16][64], b_hh; fc3 w [16][16], b; fc4 w [16][5], b; env rows
// [75][n]; window slot s = rows 16 s .. 16 s + 15.
//
// Bound on an H100: per step one or two recurrent forwards per env
// (~15,900 operations each) and on a learning step, per sampled window, two
// 17-step forwards and a 16-step backward (~1 MFLOP), all f32 on the CUDA
// cores; the sampled windows are 1.1 MB at B 1,024 and a parameter set
// 32 KB, so K9 is bound by operations.  The learner's grid is B / 4 blocks
// of 256 threads with 119 KB of shared memory each, and its recurrence is
// a chain of 2 x 17 + 16 dependent steps with block-wide barriers between
// them, every sum a scalar chain kept for exact agreement with the plain
// version, so K9 sits far from that bound; the measured times are in
// PERF.md.
#include <cstdint>

#include "env_math.cuh"
#include "learn_math.cuh"
#include "mlp.cuh"
#include "philox.cuh"

namespace mgt {
namespace drqn {

constexpr int kIn = 10, kH1 = 200, kHid = 16, kG = 4 * kHid, kA = 5;
constexpr int kSlot = 16;      // rows per window slot
constexpr int kThreads = 256;
constexpr int kActTile = 16;   // envs per drqn_act block
constexpr int kWindows = 4;    // sampled windows per drqn_learn block

// The flat parameter layout of ops/fused_drqn.py:LAYOUT.
constexpr int kW1 = 0;
constexpr int kB1 = kW1 + kIn * kH1;
constexpr int kW2 = kB1 + kH1;
constexpr int kB2 = kW2 + kH1 * kHid;
constexpr int kWih = kB2 + kHid;
constexpr int kBih = kWih + kHid * kG;
constexpr int kWhh = kBih + kG;
constexpr int kBhh = kWhh + kHid * kG;
constexpr int kW3 = kBhh + kG;
constexpr int kB3 = kW3 + kHid * kHid;
constexpr int kW4 = kB3 + kHid;
constexpr int kB4 = kW4 + kHid * kA;
constexpr int kP = kB4 + kA;
static_assert(kP == 7949, "the reference DRQN has 7,949 parameters");

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

// ((x2 w_ih + b_ih) + h w_hh) + b_hh for gate column j of one row.
__device__ __forceinline__ float gate_pre(const float* __restrict__ p,
                                          const float* x2, const float* h,
                                          int j) {
  float a = 0.0f;
  for (int k = 0; k < kHid; ++k) a = madd(a, x2[k], p[kWih + k * kG + j]);
  const float g = __fadd_rn(a, p[kBih + j]);
  float b = 0.0f;
  for (int k = 0; k < kHid; ++k) b = madd(b, h[k], p[kWhh + k * kG + j]);
  return __fadd_rn(__fadd_rn(g, b), p[kBhh + j]);
}

struct Cell {
  float gi, gf, gg, go, c, tc, h;
};

// The LSTM's elementwise tail for unit u of one row (gate order i, f, g, o).
__device__ __forceinline__ Cell cell_tail(const float* g, int u,
                                          float c_prev) {
  Cell o;
  o.gi = sigmoid(g[u]);
  o.gf = sigmoid(g[kHid + u]);
  o.gg = tanhf(g[2 * kHid + u]);
  o.go = sigmoid(g[3 * kHid + u]);
  o.c = __fadd_rn(__fmul_rn(o.gf, c_prev), __fmul_rn(o.gi, o.gg));
  o.tc = tanhf(o.c);
  o.h = __fmul_rn(o.go, o.tc);
  return o;
}

// One recurrent step of `rows` envs (x [rows][10], h, c [rows][16] in
// shared memory) -> q [rows][5], hn, cn [rows][16]; z1, x2, g and h3 are
// scratch.  Starts and ends with a block-wide barrier.
__device__ void cell_tile(const float* __restrict__ p, const float* x,
                          const float* h, const float* c, int rows,
                          float* z1, float* x2, float* g, float* h3,
                          float* hn, float* cn, float* q) {
  __syncthreads();
  dense<float, true>(x, rows, kIn, p + kW1, p + kB1, kH1, z1);
  __syncthreads();
  dense<float, false>(z1, rows, kH1, p + kW2, p + kB2, kHid, x2);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kG; i += blockDim.x) {
    const int r = i / kG, j = i - r * kG;
    g[i] = gate_pre(p, x2 + r * kHid, h + r * kHid, j);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kHid; i += blockDim.x) {
    const int r = i / kHid, u = i - r * kHid;
    const Cell o = cell_tail(g + r * kG, u, c[i]);
    hn[i] = o.h;
    cn[i] = o.c;
  }
  __syncthreads();
  dense<float, true>(hn, rows, kHid, p + kW3, p + kB3, kHid, h3);
  __syncthreads();
  dense<float, false>(h3, rows, kHid, p + kW4, p + kB4, kA, q);
  __syncthreads();
}

struct ActCfg {
  int n, L, wl, emit, r_cur, opp, greedy, random_start;
  uint32_t step, threshold, k0, k1;
};

__global__ void __launch_bounds__(kThreads)
act_kernel(const float* __restrict__ p, const float* __restrict__ opp,
           float* __restrict__ env, float* __restrict__ win,
           float* __restrict__ ring, float* __restrict__ met, ActCfg ac,
           EnvCfg cfg) {
  constexpr int T = kActTile;
  __shared__ float obs1[T * kIn], obs2[T * kIn];
  __shared__ float hs[2][T * kHid], cs[2][T * kHid];
  __shared__ float hn[2][T * kHid], cn[2][T * kHid];
  __shared__ float z1[T * kH1], x2[T * kHid], g[T * kG], h3[T * kHid];
  __shared__ float q[2][T * kA];

  const int env0 = blockIdx.x * T;
  const int rows = min(T, ac.n - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

  // Both seats' h and c: env rows 11 + 16 part + u, part = h1, c1, h2, c2.
  for (int i = threadIdx.x; i < 4 * kHid * rows; i += blockDim.x) {
    const int part = i / (kHid * rows), rem = i - part * kHid * rows;
    const int u = rem / rows, r = rem - u * rows;
    float* dst = (part & 1) ? cs[part >> 1] : hs[part >> 1];
    dst[r * kHid + u] = env[(11 + part * kHid + u) * sN + env0 + r];
  }
  EnvState s;
  float x1 = 0.f, y1 = 0.f, xb = 0.f, yb = 0.f, ep_rew = 0.f;
  float o[kIn];
  if (owner) {  // pos 2, vel 2, xy 4, winner, t, ep_reward
    s.pos1 = env[0 * sN + lane];
    s.pos2 = env[1 * sN + lane];
    s.vel1 = env[2 * sN + lane];
    s.vel2 = env[3 * sN + lane];
    x1 = env[4 * sN + lane];
    y1 = env[5 * sN + lane];
    xb = env[6 * sN + lane];
    yb = env[7 * sN + lane];
    s.winner = static_cast<int>(env[8 * sN + lane]);
    s.t = static_cast<int>(env[9 * sN + lane]);
    ep_rew = env[10 * sN + lane];
    const float pre[kIn] = {xb - x1, yb - y1, s.vel2 - s.vel1,
                            kEndPoint - s.pos1, s.vel1, x1 - xb, y1 - yb,
                            s.vel1 - s.vel2, kEndPoint - s.pos2, s.vel2};
    for (int k = 0; k < kIn; ++k) {
      o[k] = pre[k];
      obs1[e * kIn + k] = pre[k];
      obs2[e * kIn + k] = pre[(k + 5) % kIn];
    }
  }
  cell_tile(p, obs1, hs[0], cs[0], rows, z1, x2, g, h3, hn[0], cn[0], q[0]);
  if (ac.opp)
    cell_tile(opp, obs2, hs[1], cs[1], rows, z1, x2, g, h3, hn[1], cn[1],
              q[1]);
  if (!owner) return;

  int a1 = argmax0(q[0] + e * kA, kA);
  int a2 = ac.opp ? argmax0(q[1] + e * kA, kA) : -1;
  if (!ac.greedy) {
    const Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                         ac.k0, ac.k1);
    a1 = phi_select(a1, b.x, b.y, ac.threshold, kA);
    if (ac.opp) a2 = phi_select(a2, b.z, b.w, ac.threshold, kA);
  }
  const StepOut so = env_step(s, a1, a2, cfg);
  const bool done = so.done;

  // Window slot wl + 1: the pre-reset obs and the transition into it.
  const float next[kIn] = {so.x2 - so.x1, so.y2 - so.y1, s.vel2 - s.vel1,
                           kEndPoint - s.pos1, s.vel1, so.x1 - so.x2,
                           so.y1 - so.y2, s.vel1 - s.vel2,
                           kEndPoint - s.pos2, s.vel2};
  float* slot = win + static_cast<size_t>(ac.wl + 1) * kSlot * sN + lane;
  for (int k = 0; k < kIn; ++k) slot[k * sN] = next[k];
  slot[10 * sN] = static_cast<float>(a1);
  slot[11 * sN] = so.r1;
  slot[12 * sN] = done ? 1.0f : 0.0f;
  for (int k = 13; k < kSlot; ++k) slot[k * sN] = 0.0f;

  // Metrics: every reward counts; the win is read from the pre-step obs.
  ep_rew = ep_rew + so.r1;
  const bool won = done && (o[8] > o[3]);
  met[0 * sN + lane] = met[0 * sN + lane] + (done ? 1.0f : 0.0f);
  met[1 * sN + lane] = met[1 * sN + lane] + (so.col ? 1.0f : 0.0f);
  met[2 * sN + lane] = met[2 * sN + lane] + (won ? 1.0f : 0.0f);
  met[3 * sN + lane] = met[3 * sN + lane] + (done ? ep_rew : 0.0f);
  if (done) ep_rew = 0.0f;

  float nx1 = so.x1, ny1 = so.y1, nx2 = so.x2, ny2 = so.y2;
  if (done) {  // auto-reset (winner and t back to 0)
    if (ac.random_start) {
      random_start(s, ac.step, static_cast<uint32_t>(lane), ac.k0, ac.k1);
    } else {
      start_state(s);
    }
    lon2coord(s.pos1, 1.0f, nx1, ny1);
    lon2coord(s.pos2, -1.0f, nx2, ny2);
  }

  // The window's last step: flush the whole window column into the ring,
  // then start the next window at the post-reset obs.
  if (ac.emit) {
    const int WF = (ac.L + 1) * kSlot;
    float* dst = ring + static_cast<size_t>(ac.r_cur) * WF * sN + lane;
    const float* src = win + lane;
    for (int row = 0; row < WF; ++row) dst[row * sN] = src[row * sN];
    const float post[kIn] = {nx2 - nx1, ny2 - ny1, s.vel2 - s.vel1,
                             kEndPoint - s.pos1, s.vel1, nx1 - nx2,
                             ny1 - ny2, s.vel1 - s.vel2, kEndPoint - s.pos2,
                             s.vel2};
    for (int k = 0; k < kIn; ++k) win[k * sN + lane] = post[k];
  }

  env[0 * sN + lane] = s.pos1;
  env[1 * sN + lane] = s.pos2;
  env[2 * sN + lane] = s.vel1;
  env[3 * sN + lane] = s.vel2;
  env[4 * sN + lane] = nx1;
  env[5 * sN + lane] = ny1;
  env[6 * sN + lane] = nx2;
  env[7 * sN + lane] = ny2;
  env[8 * sN + lane] = static_cast<float>(s.winner);
  env[9 * sN + lane] = static_cast<float>(s.t);
  env[10 * sN + lane] = ep_rew;
  // h/c of both seats, zeroed on reset; under L0 seat 2 keeps its state.
  const float* h2 = ac.opp ? hn[1] : hs[1];
  const float* c2 = ac.opp ? cn[1] : cs[1];
  for (int u = 0; u < kHid; ++u) {
    const int k = e * kHid + u;
    env[(11 + u) * sN + lane] = done ? 0.0f : hn[0][k];
    env[(11 + kHid + u) * sN + lane] = done ? 0.0f : cn[0][k];
    env[(11 + 2 * kHid + u) * sN + lane] = done ? 0.0f : h2[k];
    env[(11 + 3 * kHid + u) * sN + lane] = done ? 0.0f : c2[k];
  }
}

struct LearnCfg {
  int n, B, L, burn_in, round, col;
  float gamma;
};

// Offsets (in floats) of the learner's shared arrays for W = kWindows
// windows of L steps; T1 = L + 1 timesteps of the forward, rows (w, t) at
// w * T1 + t, backward rows at w * L + t.
struct LearnLayout {
  int X, act, rew, dn, mask, lterm, x2e, x2t, gates, cprev, tc, he, ht,
      hst, cst, gpre, z3e, z3t, qe, qt, dq, dz3, dhh, da, dx2, dhn, dcn, ta,
      tb, total;
  __host__ __device__ explicit LearnLayout(int L) {
    constexpr int W = kWindows;
    const int T1 = L + 1, WT = W * T1, WL = W * L;
    int o = 0;
    X = o;     o += WT * kIn;   // the windows' obs
    act = o;   o += WL;         // action, reward, done, mask, mask * diff^2
    rew = o;   o += WL;
    dn = o;    o += WL;
    mask = o;  o += WL;
    lterm = o; o += WL;
    x2e = o;   o += WT * kHid;  // fc2 outputs, eval and target
    x2t = o;   o += WT * kHid;
    gates = o; o += WT * kG;    // eval: i, f, g, o after their activations
    cprev = o; o += WT * kHid;  // eval: c_{t-1}, tanh(c_t), h_t
    tc = o;    o += WT * kHid;
    he = o;    o += WT * kHid;
    ht = o;    o += WT * kHid;  // target: h_t
    hst = o;   o += 2 * W * kHid;  // recurrent state of both nets
    cst = o;   o += 2 * W * kHid;
    gpre = o;  o += 2 * W * kG;    // gate pre-activations of one step
    z3e = o;   o += WT * kHid;  // fc3 pre-activations, q
    z3t = o;   o += WT * kHid;
    qe = o;    o += WT * kA;
    qt = o;    o += WT * kA;
    dq = o;    o += WL * kA;    // backward rows
    dz3 = o;   o += WL * kHid;
    dhh = o;   o += WL * kHid;
    da = o;    o += WL * kG;
    dx2 = o;   o += WL * kHid;
    dhn = o;   o += W * kHid;   // dh, dc carried to the step before
    dcn = o;   o += W * kHid;
    ta = o;    o += T1 * kH1;   // fc1 of one window (pre-activation)
    tb = o;    o += L * kH1;    // dz1 of one window
    total = o;
  }
};

__global__ void __launch_bounds__(kThreads)
learn_kernel(const float* __restrict__ p, const float* __restrict__ tgt,
             const float* __restrict__ ring, float* __restrict__ work,
             int* __restrict__ msum_out, LearnCfg lc) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_count;
  const LearnLayout lay(lc.L);
  constexpr int W = kWindows;
  const int L = lc.L, T1 = L + 1, WT = W * T1, WL = W * L;
  float* X = sm + lay.X;
  float* act = sm + lay.act;
  float* rew = sm + lay.rew;
  float* dn = sm + lay.dn;
  float* mask = sm + lay.mask;
  float* lterm = sm + lay.lterm;
  float* x2[2] = {sm + lay.x2e, sm + lay.x2t};
  float* gates = sm + lay.gates;
  float* cprev = sm + lay.cprev;
  float* tcs = sm + lay.tc;
  float* hb[2] = {sm + lay.he, sm + lay.ht};
  float* hst = sm + lay.hst;
  float* cst = sm + lay.cst;
  float* gpre = sm + lay.gpre;
  float* z3[2] = {sm + lay.z3e, sm + lay.z3t};
  float* q[2] = {sm + lay.qe, sm + lay.qt};
  float* dq = sm + lay.dq;
  float* dz3 = sm + lay.dz3;
  float* dhh = sm + lay.dhh;
  float* da = sm + lay.da;
  float* dx2 = sm + lay.dx2;
  float* dhn = sm + lay.dhn;
  float* dcn = sm + lay.dcn;
  float* ta = sm + lay.ta;
  float* tb = sm + lay.tb;

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t sN = static_cast<size_t>(lc.n);
  const int WF = T1 * kSlot;
  // Window b of the batch is lane col * B + b of ring round `round`.
  const float* slab = ring + static_cast<size_t>(lc.round) * WF * sN +
                      static_cast<size_t>(lc.col) * lc.B;
  const int w0 = blockIdx.x * W;

  // ---- the valid count over the whole batch, and this block's windows --
  if (tid == 0) s_count = 0;
  __syncthreads();
  int cnt = 0;
  for (int b = tid; b < lc.B; b += nt) {
    float ended = 0.0f;
    for (int t = 0; t < L; ++t) {
      const float valid = t >= lc.burn_in ? __fsub_rn(1.0f, ended) : 0.0f;
      cnt += valid != 0.0f ? 1 : 0;
      if (b >= w0 && b < w0 + W) mask[(b - w0) * L + t] = valid;
      ended = fmaxf(ended, slab[((t + 1) * kSlot + 12) * sN + b]);
    }
  }
  atomicAdd(&s_count, cnt);  // integers: the total is the same in any order
  for (int i = tid; i < WT * kIn; i += nt) {
    const int w = i / (T1 * kIn), rem = i - w * T1 * kIn;
    const int t = rem / kIn, f = rem - t * kIn;
    X[i] = slab[(t * kSlot + f) * sN + w0 + w];
  }
  for (int i = tid; i < WL; i += nt) {
    const int w = i / L, t = i - w * L;
    const float* s = slab + ((t + 1) * kSlot + kIn) * sN + w0 + w;
    act[i] = s[0];
    rew[i] = s[sN];
    dn[i] = s[2 * sN];
  }
  __syncthreads();
  const int msum = max(s_count, 1);
  if (blockIdx.x == 0 && tid == 0) *msum_out = msum;
  const float two = __fdiv_rn(2.0f, static_cast<float>(msum));

  // ---- forward, input side: fc1 and fc2 of both nets, all timesteps -----
  for (int net = 0; net < 2; ++net) {
    const float* pp = net ? tgt : p;
    for (int w = 0; w < W; ++w) {
      dense<float, true>(X + w * T1 * kIn, T1, kIn, pp + kW1, pp + kB1, kH1,
                         ta);
      __syncthreads();
      dense<float, false>(ta, T1, kH1, pp + kW2, pp + kB2, kHid,
                          x2[net] + w * T1 * kHid);
      __syncthreads();
    }
  }

  // ---- forward, the recurrence of both nets from zero state ------------
  for (int i = tid; i < 2 * W * kHid; i += nt) {
    hst[i] = 0.0f;
    cst[i] = 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < T1; ++t) {
    for (int i = tid; i < 2 * W * kG; i += nt) {
      const int nw = i / kG, j = i - nw * kG;  // nw = net * W + w
      const int net = nw / W, w = nw - net * W;
      gpre[i] = gate_pre(net ? tgt : p, x2[net] + (w * T1 + t) * kHid,
                         hst + nw * kHid, j);
    }
    __syncthreads();
    for (int i = tid; i < 2 * W * kHid; i += nt) {
      const int nw = i / kHid, u = i - nw * kHid;
      const int net = nw / W, w = nw - net * W;
      const int row = w * T1 + t;
      const Cell o = cell_tail(gpre + nw * kG, u, cst[i]);
      if (net == 0) {
        float* gr = gates + row * kG;
        gr[u] = o.gi;
        gr[kHid + u] = o.gf;
        gr[2 * kHid + u] = o.gg;
        gr[3 * kHid + u] = o.go;
        cprev[row * kHid + u] = cst[i];
        tcs[row * kHid + u] = o.tc;
      }
      hb[net][row * kHid + u] = o.h;
      cst[i] = o.c;
      hst[i] = o.h;
    }
    __syncthreads();
  }

  // ---- heads of both nets, all timesteps ---------------------------------
  for (int i = tid; i < 2 * WT * kHid; i += nt) {
    const int net = i / (WT * kHid), rem = i - net * WT * kHid;
    const int row = rem / kHid, j = rem - row * kHid;
    const float* pp = net ? tgt : p;
    const float* hr = hb[net] + row * kHid;
    float a = 0.0f;
    for (int k = 0; k < kHid; ++k) a = madd(a, hr[k], pp[kW3 + k * kHid + j]);
    z3[net][rem] = __fadd_rn(a, pp[kB3 + j]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * WT * kA; i += nt) {
    const int net = i / (WT * kA), rem = i - net * WT * kA;
    const int row = rem / kA, j = rem - row * kA;
    const float* pp = net ? tgt : p;
    const float* zr = z3[net] + row * kHid;
    float a = 0.0f;
    for (int k = 0; k < kHid; ++k)
      a = madd(a, relu(zr[k]), pp[kW4 + k * kA + j]);
    q[net][rem] = __fadd_rn(a, pp[kB4 + j]);
  }
  __syncthreads();

  // ---- Double-DQN targets, dq and the loss terms, t < L ------------------
  for (int i = tid; i < WL; i += nt) {
    const int w = i / L, t = i - w * L;
    const int r0 = w * T1 + t, r1 = r0 + 1;
    const int star = argmax0(q[0] + r1 * kA, kA);
    const float boot = q[1][r1 * kA + star];
    const float target = __fadd_rn(
        rew[i], __fmul_rn(__fmul_rn(lc.gamma, boot), __fsub_rn(1.0f, dn[i])));
    const int a = static_cast<int>(act[i]);
    const float diff = __fsub_rn(q[0][r0 * kA + a], target);
    const float coef = __fmul_rn(__fmul_rn(two, mask[i]), diff);
    for (int j = 0; j < kA; ++j)
      dq[i * kA + j] = __fmul_rn(j == a ? 1.0f : 0.0f, coef);
    lterm[i] = __fmul_rn(__fmul_rn(mask[i], diff), diff);
  }
  __syncthreads();

  // ---- backward through the heads ---------------------------------------
  for (int i = tid; i < WL * kHid; i += nt) {
    const int r = i / kHid, k = i - r * kHid;
    const int w = r / L, t = r - w * L;
    float a = 0.0f;
    for (int j = 0; j < kA; ++j)
      a = madd(a, p[kW4 + k * kA + j], dq[r * kA + j]);
    dz3[i] = __fmul_rn(a, z3[0][(w * T1 + t) * kHid + k] > 0.0f ? 1.0f : 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < WL * kHid; i += nt) {
    const int r = i / kHid, k = i - r * kHid;
    float a = 0.0f;
    for (int j = 0; j < kHid; ++j)
      a = madd(a, p[kW3 + k * kHid + j], dz3[r * kHid + j]);
    dhh[i] = a;
  }

  // ---- backward through the recurrence, t = L - 1 down to 0 -------------
  for (int i = tid; i < W * kHid; i += nt) {
    dhn[i] = 0.0f;
    dcn[i] = 0.0f;
  }
  __syncthreads();
  for (int t = L - 1; t >= 0; --t) {
    for (int i = tid; i < W * kHid; i += nt) {
      const int w = i / kHid, u = i - w * kHid;
      const int r = w * L + t, row = w * T1 + t;
      const float* gr = gates + row * kG;
      const float gi = gr[u], gf = gr[kHid + u], gg = gr[2 * kHid + u],
                  go = gr[3 * kHid + u];
      const float tcv = tcs[row * kHid + u];
      const float dh = __fadd_rn(dhh[r * kHid + u], dhn[i]);
      const float dov = __fmul_rn(dh, tcv);
      const float dc = __fadd_rn(
          __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.0f, __fmul_rn(tcv, tcv))),
          dcn[i]);
      float* dar = da + r * kG;
      dar[u] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), gi),
                         __fsub_rn(1.0f, gi));
      dar[kHid + u] = __fmul_rn(
          __fmul_rn(__fmul_rn(dc, cprev[row * kHid + u]), gf),
          __fsub_rn(1.0f, gf));
      dar[2 * kHid + u] = __fmul_rn(__fmul_rn(dc, gi),
                                    __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      dar[3 * kHid + u] = __fmul_rn(__fmul_rn(dov, go), __fsub_rn(1.0f, go));
      dcn[i] = __fmul_rn(dc, gf);
    }
    __syncthreads();
    for (int i = tid; i < W * kHid; i += nt) {
      const int w = i / kHid, k = i - w * kHid;
      const float* dar = da + (w * L + t) * kG;
      float a = 0.0f;
      for (int j = 0; j < kG; ++j) a = madd(a, p[kWhh + k * kG + j], dar[j]);
      dhn[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < WL * kHid; i += nt) {  // dx2 = w_ih da
    const int r = i / kHid, k = i - r * kHid;
    float a = 0.0f;
    for (int j = 0; j < kG; ++j)
      a = madd(a, p[kWih + k * kG + j], da[r * kG + j]);
    dx2[i] = a;
  }
  __syncthreads();

  // ---- this block's partial sums over its rows ---------------------------
  float* out = work + static_cast<size_t>(blockIdx.x) * (kP + 1);
  for (int i = kB2 + tid; i <= kP; i += nt) {
    float acc = 0.0f;
    for (int r = 0; r < WL; ++r) {
      const int w = r / L, t = r - w * L, row = w * T1 + t;
      if (i < kWih) {                     // b2
        acc = __fadd_rn(acc, dx2[r * kHid + (i - kB2)]);
      } else if (i < kBih) {              // w_ih[k][j]: x2 * da
        const int k = (i - kWih) / kG, j = (i - kWih) - k * kG;
        acc = madd(acc, x2[0][row * kHid + k], da[r * kG + j]);
      } else if (i < kWhh) {              // b_ih
        acc = __fadd_rn(acc, da[r * kG + (i - kBih)]);
      } else if (i < kBhh) {              // w_hh[k][j]: h_{t-1} * da
        const int k = (i - kWhh) / kG, j = (i - kWhh) - k * kG;
        const float hp = t == 0 ? 0.0f : hb[0][(row - 1) * kHid + k];
        acc = madd(acc, hp, da[r * kG + j]);
      } else if (i < kW3) {               // b_hh
        acc = __fadd_rn(acc, da[r * kG + (i - kBhh)]);
      } else if (i < kB3) {               // w3[k][j]: h * dz3
        const int k = (i - kW3) / kHid, j = (i - kW3) - k * kHid;
        acc = madd(acc, hb[0][row * kHid + k], dz3[r * kHid + j]);
      } else if (i < kW4) {               // b3
        acc = __fadd_rn(acc, dz3[r * kHid + (i - kB3)]);
      } else if (i < kB4) {               // w4[k][a]: relu(z3) * dq
        const int k = (i - kW4) / kA, a = (i - kW4) - k * kA;
        acc = madd(acc, relu(z3[0][row * kHid + k]), dq[r * kA + a]);
      } else if (i < kP) {                // b4
        acc = __fadd_rn(acc, dq[r * kA + (i - kB4)]);
      } else {                            // mask * diff^2, for the loss
        acc = __fadd_rn(acc, lterm[r]);
      }
    }
    out[i] = acc;
  }
  // fc1 and fc2, window by window: fc1 recomputed, dz1 = (w2 dx2) * relu'.
  for (int w = 0; w < W; ++w) {
    __syncthreads();
    for (int i = tid; i < L * kH1; i += nt) {
      const int t = i / kH1, k = i - t * kH1;
      const float* xr = X + (w * T1 + t) * kIn;
      float a = 0.0f;
      for (int f = 0; f < kIn; ++f) a = madd(a, xr[f], p[kW1 + f * kH1 + k]);
      ta[i] = __fadd_rn(a, p[kB1 + k]);
    }
    __syncthreads();
    for (int i = tid; i < L * kH1; i += nt) {
      const int t = i / kH1, k = i - t * kH1;
      const float* d = dx2 + (w * L + t) * kHid;
      float a = 0.0f;
      for (int j = 0; j < kHid; ++j) a = madd(a, p[kW2 + k * kHid + j], d[j]);
      tb[i] = __fmul_rn(a, ta[i] > 0.0f ? 1.0f : 0.0f);
    }
    __syncthreads();
    for (int i = tid; i < kB2; i += nt) {
      float acc = w == 0 ? 0.0f : out[i];  // this thread's running sum
      for (int t = 0; t < L; ++t) {
        if (i < kB1) {                    // w1[f][k]: x * dz1
          const int f = i / kH1, k = i - f * kH1;
          acc = madd(acc, X[(w * T1 + t) * kIn + f], tb[t * kH1 + k]);
        } else if (i < kW2) {             // b1
          acc = __fadd_rn(acc, tb[t * kH1 + (i - kB1)]);
        } else {                          // w2[k][j]: relu(z1) * dx2
          const int k = (i - kW2) / kHid, j = (i - kW2) - k * kHid;
          acc = madd(acc, relu(ta[t * kH1 + k]),
                     dx2[(w * L + t) * kHid + j]);
        }
      }
      out[i] = acc;
    }
  }
}

struct AdamCfg {
  int blocks, sync;
  AdamHyper h;
};

// The shared Adam step (learn_math.cuh), with the loss divided by the
// learner's valid count.
__global__ void adam_kernel(const float* __restrict__ work,
                            float* __restrict__ p, float* __restrict__ tp,
                            float* __restrict__ m, float* __restrict__ v,
                            float* __restrict__ loss,
                            const int* __restrict__ msum, AdamCfg c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > kP) return;
  const float g = sum_partials(work, c.blocks, kP + 1, i);
  if (i == kP) {
    *loss = __fdiv_rn(g, static_cast<float>(*msum));
    return;
  }
  if (c.sync) tp[i] = p[i];  // the target sync comes before the update
  adam_step(g, p, m, v, i, c.h);
}

}  // namespace drqn
}  // namespace mgt

extern "C" int mgt_drqn_act(const float* p, const float* opp, float* env,
                            float* win, float* ring, float* met, int n, int L,
                            int wl, int emit, int r_cur, int opp_net,
                            int greedy, int random_start, uint32_t step,
                            uint32_t threshold, uint32_t k0, uint32_t k1,
                            int max_steps, float r_first, float r_second,
                            float r_collision, float vel_penalty,
                            float time_penalty, cudaStream_t stream) {
  using namespace mgt;
  using namespace mgt::drqn;
  if (n <= 0) return 0;
  if (L < 1 || wl < 0 || wl >= L || r_cur < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ActCfg ac{n, L, wl, emit, r_cur, opp_net, greedy, random_start,
            step, threshold, k0, k1};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  act_kernel<<<(n + kActTile - 1) / kActTile, kThreads, 0, stream>>>(
      p, opp, env, win, ring, met, ac, cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_drqn_learn(const float* p, const float* tgt,
                              const float* ring, float* work, int* msum,
                              int n, int B, int L, int burn_in, int round,
                              int col, float gamma, cudaStream_t stream) {
  using namespace mgt;
  using namespace mgt::drqn;
  if (B <= 0 || B % kWindows != 0 || L < 1 || round < 0 || col < 0 ||
      static_cast<long long>(col + 1) * B > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(LearnLayout(L).total) *
                      sizeof(float);
  cudaError_t err = allow_smem(learn_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  LearnCfg lc{n, B, L, burn_in, round, col, gamma};
  learn_kernel<<<B / kWindows, kThreads, smem, stream>>>(p, tgt, ring, work,
                                                          msum, lc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_drqn_adam(const float* work, float* p, float* tp, float* m,
                             float* v, float* loss, const int* msum,
                             int blocks, int sync, float lr, float b1,
                             float b2, float omb1, float omb2, float eps,
                             float c1, float c2, cudaStream_t stream) {
  using namespace mgt::drqn;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  AdamCfg c{blocks, sync, {lr, b1, b2, omb1, omb2, eps, c1, c2}};
  const int threads = 256;
  adam_kernel<<<(kP + threads) / threads, threads, 0, stream>>>(
      work, p, tp, m, v, loss, msum, c);
  return static_cast<int>(cudaGetLastError());
}
