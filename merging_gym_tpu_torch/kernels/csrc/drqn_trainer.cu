// K9: the whole recurrent DQN (DRQN) trainer, one step as one kernel
// before the ring has filled and four after.
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
//   1. drqn_act (act_kernel): a block owns `rows` envs, sized on the host
//      from the env count and the SM count (ops/fused_drqn.py:
//      act_geometry: 8 envs in 128 blocks at 1,024).  The recurrent
//      forward of each seat from its own h/c (fc1, fc2, the LSTM cell, fc3,
//      fc4, each layer a register-tiled pass of qnet_tiled.cuh on nets held
//      in shared memory; the opponent is the live net on the half-swapped
//      obs in the same passes, a frozen net, or L0), the first-occurrence
//      argmax and the Phi(eps) pick on Philox
//      stream 0, the env step (env_math.cuh), the write of window slot
//      wl + 1 (the pre-reset obs, action, reward, done), the auto-reset, on
//      the window's last step the copy of the env's window column into ring
//      round r_cur and the post-reset obs into slot 0, the metrics, and the
//      h/c of both seats zeroed where the episode ended.
//   2. drqn_learn_in (learning steps; in_kernel): the input side of both
//      nets over all B x (L + 1) rows of the sampled windows, gathered from
//      the ring: fc1 (ReLU), fc2 and x2 w_ih + b_ih, as three register-tiled
//      layers of qnet_tiled.cuh (layer_sums), with the block's rows sized on
//      the host from B and the SM count (ops/fused_drqn.py:learn_geometry).
//      The eval net's obs, relu(z1) and x2 at t < L go to the workspace,
//      both nets' x2 w_ih + b_ih to `gx`, and each block's share of the
//      valid count (past burn-in, before the first in-window done; an
//      integer, exact in any order) to `cnt`.
//   3. drqn_learn_rec (rec_kernel): one warp per window and net, W windows
//      a block.  msum = max(sum of cnt, 1); the 17-step recurrence of both
//      nets from zero state, each lane two of the 64 gate columns, h passed
//      by warp shuffles; both nets' heads; the Double-DQN targets, dq and
//      mask * diff^2; the backward through the heads and down the
//      recurrence from t = L - 1 to 0, the eval warp's lanes 0-15 carrying
//      dh through w_hh while lanes 16-31 take dx2 = w_ih da; then, over the
//      whole block, dz1 = (w2 dx2) * relu'(z1).  Each row's factors go to
//      the workspace.
//   4. drqn_learn_grad (grad_kernel): every gradient entry and the loss as
//      a sum over the workspace's rows in the plain version's order, then,
//      in the same thread, tp := p on a sync step and Adam (learn_math.cuh).
//
// The order of every sum is the plain version's (ops/fused_drqn.py:
// _grads_plain, fused_drqn_chunk_plain), so the two agree bit for bit.
// Each sum is one thread's chain from 0 in index order, with one rounding
// per multiply and per add (-fmad=false; spelt with the intrinsics), and a
// bias is added after its chain.  A gate is ((x2 w_ih + b_ih) + h w_hh) +
// b_hh, so its first term, which does not depend on h, is computed for
// every timestep ahead of the recurrence.  Sigmoid is 1 / (1 + expf(-x)) as
// one IEEE division and tanh is tanhf, the accurate library functions.  A
// gradient entry (and the loss) is, for each summation tile of kWindows
// windows x L rows in order, the tile's sum over its rows from 0 (window by
// window, t in order), added into the total from 0.  A bias's gradient is
// the sum of 1 x d over the same rows, which is the sum of d: the
// workspace keeps a column of ones beside each weight's first factor, so a
// bias is one more row of its weight's rectangles.  Two runs on the same
// inputs give the same bits.  Layouts (ops/fused_drqn.py): a parameter set
// is one flat f32 buffer of 7,949 values, fc1 w [10][200], b; fc2 w
// [200][16], b; w_ih [16][64], b_ih; w_hh [16][64], b_hh; fc3 w [16][16],
// b; fc4 w [16][5], b; env rows [75][n]; window slot s = rows 16 s ..
// 16 s + 15.
//
// Bound on an H100: per step one or two recurrent forwards per env
// (~15,900 operations each) and on a learning step, per sampled window, two
// 17-step forwards and a 16-step backward (~0.9 MFLOP), all f32 on the
// CUDA cores (no FMA, so at most half the card's f32 rate), so K9 is bound
// by operations.  What held the learner back, and what this design does:
// the old learner ran B / 4 blocks of 119 KB, one per SM in two waves, its
// recurrence 33 steps of block-wide barriers with most threads idle, every
// block re-counting the whole batch, fc1 and fc2 one output per thread, and
// its partial sums through an 8 MB buffer summed by a second kernel.  Now
// the valid count is taken once; the input side (~45% of the operations)
// runs as register-tiled layers over the whole card; the recurrence runs in
// one wave of warps that synchronise only within themselves, and takes
// dz1 too (one pass over the block's rows, no launch of its own); and the
// gradients are summed by rectangles of 16 x 8 entries with up to 128
// summation tiles in flight a block, the partials parked in shared memory.
// The row factors pass through a workspace of B x L rows of 596 floats
// (39 MB at B 1,024, L 16), written once and read back by the gradient
// kernel, whose speed is set by those reads: more threads a block (more
// loads in flight) made it faster, larger rectangles (fewer re-reads) did
// not.  The act kernel ran 64 blocks of 16 envs on 132 SMs, each output
// one thread's scalar chain over weights read from global memory, and the
// opponent's forward only after the ego's; now 8 envs a block fill 128
// SMs, the nets (31,796 B each) are held in shared memory, and both seats
// share each layer's phase.  The measured times are in PERF.md
// (chip_smoke.py).
#include <cstdint>

#include "act_tiled.cuh"
#include "env_math.cuh"
#include "learn_math.cuh"
#include "philox.cuh"

namespace mgt {
namespace drqn {

constexpr int kIn = 10, kH1 = 200, kHid = 16, kG = 4 * kHid, kA = 5;
constexpr int kSlot = 16;      // rows per window slot
constexpr int kThreads = kQnetThreads;
constexpr int kWindows = 4;    // windows per summation tile of the learner

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

struct ActCfg {
  int n, L, wl, emit, r_cur, opp, greedy, random_start;  // opp: kOpp*
  uint32_t step, threshold, k0, k1;
};

// The act kernel's arrays, in floats per row of a pass (seats x rows rows:
// seat 1's rows, then seat 2's where it plays a net), each row a multiple
// of 4 floats (16-byte rows for load4): the obs, h and c before the step,
// relu(z1), x2, h w_hh, the gates, h and c after it, relu(z3) and q.
// ops/fused_drqn.py:ACT_ROW_FLOATS mirrors the total.
constexpr int kAx = 0, kAh = 16, kAc = 36, kAz1 = 52, kAx2 = 256, kAgh = 276,
              kAg = 340, kAhn = 404, kAcn = 424, kAh3 = 440, kAq = 460,
              kActRowFloats = 468;
// Row strides: the obs, the 16-wide rows read by a layer (h, x2, h after
// the step, relu(z3)), c, relu(z1), the 64 gate columns, q.
constexpr int kSx = 16, kSh = 20, kSc = 16, kSz1 = 204, kSg = 64, kSq = 8;
static_assert(kAh == kAx + kSx && kAc == kAh + kSh && kAz1 == kAc + kSc &&
                  kAx2 == kAz1 + kSz1 && kAgh == kAx2 + kSh &&
                  kAg == kAgh + kSg && kAhn == kAg + kSg &&
                  kAcn == kAhn + kSh && kAh3 == kAcn + kSc &&
                  kAq == kAh3 + kSh && kActRowFloats == kAq + kSq,
              "act_kernel layout");
constexpr size_t kNetBytes = (kP * sizeof(float) + 15) / 16 * 16;  // 31,808

// Byte offsets of the act kernel's shared memory (ops/fused_drqn.py:
// act_smem mirrors it): the first g.resident of the launch's nets (the
// player's, then a frozen opponent's) held whole, then the arrays of seats
// x g.rows rows.  A net not held is read from global memory.
__host__ __device__ inline size_t act_tiles(ActGeom g) {
  return static_cast<size_t>(g.resident) * kNetBytes;
}

__host__ __device__ inline size_t act_total(ActGeom g, int seats) {
  return act_tiles(g) +
         static_cast<size_t>(seats) * g.rows * kActRowFloats * sizeof(float);
}

// Whether the host's geometry suits this layout: rows an owner thread each,
// at most the launch's nets held, nothing streamed, and the layout within
// the bytes the host sized.
inline bool act_layout_ok(ActGeom g, int seats, int nets) {
  return g.rows >= 1 && g.rows <= kActRowsMax && g.resident >= 0 &&
         g.resident <= nets && g.chunk == 0 &&
         act_total(g, seats) <= static_cast<size_t>(g.smem);
}

// Where an act layer's sums of the rows [r0, ...) of a pass go: + the
// seat's net's bias at bo (none at -1); for the gates then + h w_hh (gh)
// and + b_hh (at bo2); ReLU if rl; to y[r0 + row][j].
struct CellEpi {
  const float* net;
  int bo, bo2;
  bool rl;
  const float* gh;
  float* y;
  int ys, r0;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    float v = acc;
    if (bo >= 0) v = __fadd_rn(v, net[bo + j]);
    if (bo2 >= 0)
      v = __fadd_rn(__fadd_rn(v, gh[(r0 + r) * kSg + j]), net[bo2 + j]);
    if (rl) v = relu(v);
    y[(r0 + r) * ys + j] = v;
  }
};

// One layer K -> J (weights at wo of a net, [K][J]) of the pass's rows of
// x: all prows rows through net a, or, where the seats play different nets
// (b, a frozen opponent), seat 1's `rows` rows through a and seat 2's
// through b, as two staged_sums passes of one phase.  Returns the lead of
// a pass issued next in the phase.
template <int RM, int RN>
__device__ __forceinline__ int seat_sums(const float* a, const float* b,
                                         int wo, int K, int J, const float* x,
                                         int xs, int rows, int prows,
                                         CellEpi e, int lead = 0) {
  e.net = a;
  e.r0 = 0;
  if (b == nullptr)
    return staged_sums<float, RM, RN>(a + wo, K, J, x, xs, prows, e, lead);
  lead = staged_sums<float, RM, RN>(a + wo, K, J, x, xs, rows, e, lead);
  e.net = b;
  e.r0 = rows;
  return staged_sums<float, RM, RN>(b + wo, K, J, x + rows * xs, xs, rows, e,
                                    lead);
}

// A block of kThreads threads owns g.rows envs (ops/fused_drqn.py:
// act_geometry: 8 envs in 128 blocks at 1,024), thread e < rows env env0 +
// e.  The recurrent forward of both seats' rows from their own h/c: fc1
// and the gates' input products on RM x RN micro-tiles, fc2, fc3 and fc4
// one output a thread (fc2's 200-deep chains spread over the most
// threads), h w_hh in fc2's phase, the LSTM tail one thread a unit; every
// layer a staged_sums pass over nets held in shared memory (their copy
// overlapping the env rows' loads) or read from global memory.  In
// self-play both seats' rows go through one pass of the live net, a frozen
// opponent's rows through its own net in the same phases.  Then the picks,
// the env step, the window slot, the auto-reset, the flush, the metrics
// and the h/c of both seats, zeroed where the episode ended.
template <int RM, int RN>
__global__ void __launch_bounds__(kThreads, 1)
act_kernel(const float* __restrict__ p, const float* __restrict__ opp,
           float* __restrict__ env, float* __restrict__ win,
           float* __restrict__ ring, float* __restrict__ met, ActGeom g,
           ActCfg ac, EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool frozen = ac.opp == kOppFrozen;
  const int seats = ac.opp == kOppL0 ? 1 : 2;
  const int P = seats * g.rows;  // rows of each array
  float* const y = reinterpret_cast<float*>(smem + act_tiles(g));
  float* const x = y + P * kAx;
  float* const h = y + P * kAh;
  float* const c = y + P * kAc;
  float* const z1 = y + P * kAz1;
  float* const x2 = y + P * kAx2;
  float* const gh = y + P * kAgh;
  float* const gt = y + P * kAg;
  float* const hn = y + P * kAhn;
  float* const cn = y + P * kAcn;
  float* const h3 = y + P * kAh3;
  float* const q = y + P * kAq;

  const int env0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, ac.n - env0);
  const int prows = seats * rows;
  const int e = threadIdx.x, nt = blockDim.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

  // The nets: a for seat 1 (and seat 2 in self-play), b for a frozen seat 2.
  const float* na = p;
  const float* nb = frozen ? opp : nullptr;
  if (g.resident >= 1) {
    float* const held = reinterpret_cast<float*>(smem);
    stage(held, p, kP);
    na = held;
    if (frozen && g.resident >= 2) {
      float* const held2 = reinterpret_cast<float*>(smem + kNetBytes);
      stage(held2, opp, kP);
      nb = held2;
    }
    cp_async_commit();
  }

  // The seats' h and c: env rows 11 + 16 part + u, part = h1, c1, h2, c2.
  for (int i = e; i < 2 * seats * kHid * rows; i += nt) {
    const int part = i / (kHid * rows), rem = i - part * kHid * rows;
    const int u = rem / rows, r = rem - u * rows;
    const int row = (part >> 1) * rows + r;
    const float v = env[(11 + part * kHid + u) * sN + env0 + r];
    if (part & 1) {
      c[row * kSc + u] = v;
    } else {
      h[row * kSh + u] = v;
    }
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
#pragma unroll
    for (int k = 0; k < kIn; ++k) o[k] = pre[k];
    put_obs<0>(x + e * kSx, o);
    if (seats == 2) put_obs<5>(x + (rows + e) * kSx, o);
  }
  cp_async_wait_all();
  __syncthreads();

  // fc1; fc2 beside h w_hh; the gates; the tail; fc3; fc4.
  seat_sums<RM, RN>(na, nb, kW1, kIn, kH1, x, kSx, rows, prows,
                    {nullptr, kB1, -1, true, nullptr, z1, kSz1, 0});
  __syncthreads();
  int lead = seat_sums<1, 1>(na, nb, kW2, kH1, kHid, z1, kSz1, rows, prows,
                             {nullptr, kB2, -1, false, nullptr, x2, kSh, 0});
  seat_sums<RM, RN>(na, nb, kWhh, kHid, kG, h, kSh, rows, prows,
                    {nullptr, -1, -1, false, nullptr, gh, kSg, 0}, lead);
  __syncthreads();
  seat_sums<RM, RN>(na, nb, kWih, kHid, kG, x2, kSh, rows, prows,
                    {nullptr, kBih, kBhh, false, gh, gt, kSg, 0});
  __syncthreads();
  for (int i = e; i < prows * kHid; i += nt) {
    const int r = i / kHid, u = i - r * kHid;
    const Cell cl = cell_tail(gt + r * kSg, u, c[r * kSc + u]);
    hn[r * kSh + u] = cl.h;
    cn[r * kSc + u] = cl.c;
  }
  __syncthreads();
  seat_sums<1, 1>(na, nb, kW3, kHid, kHid, hn, kSh, rows, prows,
                  {nullptr, kB3, -1, true, nullptr, h3, kSh, 0});
  __syncthreads();
  seat_sums<1, 1>(na, nb, kW4, kHid, kA, h3, kSh, rows, prows,
                  {nullptr, kB4, -1, false, nullptr, q, kSq, 0});
  __syncthreads();
  if (!owner) return;

  int a1 = argmax0(q + e * kSq, kA);
  int a2 = seats == 2 ? argmax0(q + (rows + e) * kSq, kA) : -1;
  if (!ac.greedy) {
    const Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                         ac.k0, ac.k1);
    a1 = phi_select(a1, b.x, b.y, ac.threshold, kA);
    if (seats == 2) a2 = phi_select(a2, b.z, b.w, ac.threshold, kA);
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
  for (int u = 0; u < kHid; ++u) {
    env[(11 + u) * sN + lane] = done ? 0.0f : hn[e * kSh + u];
    env[(11 + kHid + u) * sN + lane] = done ? 0.0f : cn[e * kSc + u];
    if (seats == 2) {
      env[(11 + 2 * kHid + u) * sN + lane] =
          done ? 0.0f : hn[(rows + e) * kSh + u];
      env[(11 + 3 * kHid + u) * sN + lane] =
          done ? 0.0f : cn[(rows + e) * kSc + u];
    } else if (done) {
      env[(11 + 2 * kHid + u) * sN + lane] = 0.0f;
      env[(11 + 3 * kHid + u) * sN + lane] = 0.0f;
    }
  }
}

// ---- the learner ------------------------------------------------------------

// The learner's workspace: one row of kWsWidth floats per sampled window b
// and timestep t < L, row b * L + t, so that a summation tile is
// kWindows * L consecutive rows.  Each group starts on a multiple of 4
// floats (16-byte loads); a 1 after a weight's first factor is its bias's
// row.  The host writes the ones and zeros once (ops/fused_drqn.py:
// WS_GROUPS mirrors the columns); in_kernel and rec_kernel write the rest.
constexpr int kWsX = 0;      // in: obs (10); 1 (b1), 0
constexpr int kWsZ1r = 12;   // in: relu(z1) (200); 1 (b2), 0, 0, 0
constexpr int kWsDz1 = 216;  // rec: dz1 (200)
constexpr int kWsDx2 = 416;  // rec: dx2 (16)
constexpr int kWsX2h = 432;  // in: x2 (16); rec: h_{t-1} (16); 1 (b_ih, b_hh)
constexpr int kWsDa = 468;   // rec: da (64)
constexpr int kWsH = 532;    // rec: h (16); 1 (b3), 0, 0, 0
constexpr int kWsDz3 = 552;  // rec: dz3 (16)
constexpr int kWsZ3r = 568;  // rec: relu(z3) (16); 1 (b4, the loss)
constexpr int kWsDq = 588;   // rec: dq (5), mask * diff^2; 0, 0
constexpr int kWsWidth = 596;

__device__ __forceinline__ float* ws_row(float* ws, int b, int L, int t) {
  return ws + (static_cast<size_t>(b) * L + t) * kWsWidth;
}

// ---- 2. the input side ----------------------------------------------------

// The three layers of in_kernel as a Q-net of widths (in, h1, h2, a): fc1
// 10 -> 200, fc2 200 -> 16, the gates' input term 16 -> 64.  Its shared
// memory is qnet_tiled.cuh:QnetSmem of these widths (x, relu(z1), x2) with
// kInRowInts ints a row after it: the row's workspace row (-1 past t = L - 1
// and on the target net) and its row of gx.
__host__ __device__ inline MlpDims in_dims() {
  return MlpDims{kIn, kH1, kHid, kG};
}
constexpr int kInRowInts = 2;

struct InCfg {
  int n, B, L, burn_in, round, col;
};

struct EpiFc1 {  // z1 = sum + b1; relu(z1) to shared memory and ws
  const float* b1;
  float* y;
  int ys;
  float* ws;
  const int* wsrow;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    const float v = relu(__fadd_rn(acc, b1[j]));
    y[r * ys + j] = v;
    if (wsrow[r] >= 0)
      ws[static_cast<size_t>(wsrow[r]) * kWsWidth + kWsZ1r + j] = v;
  }
};

struct EpiFc2 {  // x2 = sum + b2, to shared memory and ws
  const float* b2;
  float* y;
  int ys;
  float* ws;
  const int* wsrow;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    const float v = __fadd_rn(acc, b2[j]);
    y[r * ys + j] = v;
    if (wsrow[r] >= 0)
      ws[static_cast<size_t>(wsrow[r]) * kWsWidth + kWsX2h + j] = v;
  }
};

struct EpiGx {  // x2 w_ih + b_ih into gx [net][b][t][64]
  const float* bih;
  float* gx;
  const int* gxrow;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    gx[static_cast<size_t>(gxrow[r]) * kG + j] = __fadd_rn(acc, bih[j]);
  }
};

// Block (x, net) owns `g.rows` rows of net `net` (0 eval, 1 target): its
// row r is timestep t = R / B of window b = R % B, R = x * rows + r, so
// consecutive rows are consecutive windows and the gather from the ring
// reads whole lines.
template <int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads)
in_kernel(const float* __restrict__ p, const float* __restrict__ tgt,
          const float* __restrict__ ring, float* __restrict__ ws,
          float* __restrict__ gx, int* __restrict__ cnt, InCfg ic,
          QnetGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const QnetSmem S(in_dims(), g, sizeof(float), kInRowInts);
  float* const wbuf = reinterpret_cast<float*>(smem);
  float* const s_in = reinterpret_cast<float*>(smem + S.in);
  float* const s_h1 = reinterpret_cast<float*>(smem + S.h1);
  float* const s_x2 = reinterpret_cast<float*>(smem + S.h2);
  int* const wsrow = reinterpret_cast<int*>(smem + S.q);
  int* const gxrow = wsrow + g.rows;
  const int st_in = act_stride(kIn), st_h1 = act_stride(kH1),
            st_x2 = act_stride(kHid);
  const int net = blockIdx.y;
  const bool eval = net == 0;
  const float* const pp = eval ? p : tgt;
  const int L = ic.L, B = ic.B, T1 = L + 1;
  const int R0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, B * T1 - R0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t sN = static_cast<size_t>(ic.n);
  // Window b of the batch is lane col * B + b of ring round `round`.
  const float* const slab = ring +
                            static_cast<size_t>(ic.round) * T1 * kSlot * sN +
                            static_cast<size_t>(ic.col) * B;

  if (tid == 0) s_count = 0;
  int c = 0;  // this thread's rows of the valid count (eval)
  for (int r = tid; r < rows; r += nt) {
    const int R = R0 + r, t = R / B, b = R - t * B;
    wsrow[r] = eval && t < L ? b * L + t : -1;
    gxrow[r] = (net * B + b) * T1 + t;
    if (!eval || t >= L || t < ic.burn_in) continue;
    float ended = 0.0f;
    for (int s = 0; s < t; ++s)
      ended = fmaxf(ended,
                    slab[(static_cast<size_t>(s + 1) * kSlot + kIn + 2) * sN +
                         b]);
    c += __fsub_rn(1.0f, ended) != 0.0f ? 1 : 0;
  }
  for (int i = tid; i < rows * kIn; i += nt) {  // obs of every row
    const int f = i / rows, r = i - f * rows;
    const int R = R0 + r, t = R / B, b = R - t * B;
    const float x = slab[(static_cast<size_t>(t) * kSlot + f) * sN + b];
    s_in[r * st_in + f] = x;
    if (eval && t < L) ws_row(ws, b, L, t)[kWsX + f] = x;
  }
  __syncthreads();
  if (eval) atomicAdd(&s_count, c);  // integers: the same in any order
  // fc1 (200 wide) and the input term (64 wide) take 8 x 4 micro-tiles, a
  // few passes of the block; fc2 (16 wide, the longest chains) the
  // host's RM x RN, which spreads it over every thread.
  EpiFc1 e1{pp + kB1, s_h1, st_h1, ws, wsrow};
  layer_sums<float, 8, 4>(pp + kW1, kIn, kH1, g.chunk, wbuf, s_in, st_in,
                          rows, e1);
  EpiFc2 e2{pp + kB2, s_x2, st_x2, ws, wsrow};
  layer_sums<float, RM, RN>(pp + kW2, kH1, kHid, g.chunk, wbuf, s_h1, st_h1,
                            rows, e2);
  EpiGx e3{pp + kBih, gx, gxrow};
  layer_sums<float, 8, 4>(pp + kWih, kHid, kG, g.chunk, wbuf, s_x2, st_x2,
                          rows, e3);
  if (eval && tid == 0) cnt[blockIdx.x] = s_count;
}

// ---- 3. the recurrence ---------------------------------------------------

struct RecCfg {
  int n, B, L, burn_in, round, col, W, ncnt;
  float gamma;
};

// rec_kernel's shared memory, in floats: both nets' heads, b_hh, the eval
// net's w2 with rows padded to 17 (for dz1), dx2 of every window's rows
// (row w * L + t), then per window `per` floats: one step's da, the eval
// net's gates after their activations, c_{t-1} and tanh(c_t) at t < L,
// both nets' h, fc3 pre-activations and q at t <= L, the window's actions,
// rewards and dones, dq, dz3 and dh from the heads.  The windows and da
// start on 16 bytes.  ops/fused_drqn.py:rec_smem mirrors it.
struct RecLayout {
  int w3, b3, w4, b4, bhh, w2, dx2, win;
  int da, gates, cprev, tc, hs, z3, qv, act, rew, dn, dq, dz3, dhh, per;
  int total;
  __host__ __device__ RecLayout(int W, int L) {
    const int T1 = L + 1;
    int o = 0;
    w3 = o;   o += 2 * kHid * kHid;
    b3 = o;   o += 2 * kHid;
    w4 = o;   o += 2 * kHid * kA;
    b4 = o;   o += 2 * kA;
    bhh = o;  o += 2 * kG;
    w2 = o;   o += kH1 * (kHid + 1);
    dx2 = o;  o += W * L * kHid;
    win = (o + 3) & ~3;
    int q = 0;
    da = q;    q += kG;
    gates = q; q += L * kG;
    cprev = q; q += L * kHid;
    tc = q;    q += L * kHid;
    hs = q;    q += 2 * T1 * kHid;
    z3 = q;    q += 2 * T1 * kHid;
    qv = q;    q += 2 * T1 * kA;
    act = q;   q += L;
    rew = q;   q += L;
    dn = q;    q += L;
    dq = q;    q += L * kA;
    dz3 = q;   q += L * kHid;
    dhh = q;   q += L * kHid;
    per = (q + 3) & ~3;
    total = win + W * per;
  }
};

constexpr int kRecWindowsMax = kThreads / 64;  // two warps a window

// Warp w < W of a block is the eval net on window blockIdx.x * W + w, warp
// W + w the target net on the same window.  No block-wide barrier falls
// inside the forward or the backward steps: a warp's lanes exchange h and
// the gates by shuffles and da through their own shared row.
__global__ void __launch_bounds__(kThreads, 2)
rec_kernel(const float* __restrict__ p, const float* __restrict__ tgt,
           const float* __restrict__ ring, const float* __restrict__ gx,
           const int* __restrict__ cnt, float* __restrict__ ws,
           int* __restrict__ msum_out, RecCfg rc) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_msum;
  const RecLayout lay(rc.W, rc.L);
  const int L = rc.L, T1 = L + 1, W = rc.W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wi = tid >> 5;
  const int net = wi >= W ? 1 : 0, w = wi - net * W;
  const int b = blockIdx.x * W + w;
  const bool hi = lane >= kHid;
  const int u = lane & (kHid - 1);
  float* const win = sm + lay.win + w * lay.per;
  const size_t sN = static_cast<size_t>(rc.n);
  const float* const slab = ring +
                            static_cast<size_t>(rc.round) * T1 * kSlot * sN +
                            static_cast<size_t>(rc.col) * rc.B;

  // ---- weights, the window's transitions, the valid count ---------------
  auto both = [&](int dst, int off, int count) {  // eval's, then target's
    for (int i = tid; i < 2 * count; i += nt) {
      const int nn = i >= count ? 1 : 0;
      sm[dst + i] = (nn ? tgt : p)[off + i - nn * count];
    }
  };
  both(lay.w3, kW3, kHid * kHid);
  both(lay.b3, kB3, kHid);
  both(lay.w4, kW4, kHid * kA);
  both(lay.b4, kB4, kA);
  both(lay.bhh, kBhh, kG);
  for (int i = tid; i < kH1 * kHid; i += nt) {
    const int k = i / kHid, j = i - k * kHid;
    sm[lay.w2 + k * (kHid + 1) + j] = p[kW2 + i];
  }

  if (net == 0) {
    for (int t = lane; t < L; t += 32) {
      const float* s =
          slab + (static_cast<size_t>(t + 1) * kSlot + kIn) * sN + b;
      win[lay.act + t] = s[0];
      win[lay.rew + t] = s[sN];
      win[lay.dn + t] = s[2 * sN];
    }
  }
  if (wi == 0) {
    int c = 0;
    for (int i = lane; i < rc.ncnt; i += 32) c += cnt[i];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(~0u, c, o);
    if (lane == 0) {
      s_msum = max(c, 1);
      if (blockIdx.x == 0) *msum_out = s_msum;
    }
  }
  __syncthreads();

  // ---- the forward recurrence from zero state ----------------------------
  // Lane l owns gate columns l and l + 32: i_u and g_u for l = u < 16, f_u
  // and o_u for l = 16 + u.  Both lanes of unit u then hold all four gates
  // and run its cell; h reaches every lane by shuffles.
  {
    const float* const pp = net ? tgt : p;
    float wa[kHid], wb[kHid], h[kHid];
#pragma unroll
    for (int k = 0; k < kHid; ++k) {
      wa[k] = pp[kWhh + k * kG + lane];
      wb[k] = pp[kWhh + k * kG + lane + 32];
      h[k] = 0.0f;
    }
    const float ba = sm[lay.bhh + net * kG + lane];
    const float bb = sm[lay.bhh + net * kG + lane + 32];
    const float* const gxw =
        gx + (static_cast<size_t>(net) * rc.B + b) * T1 * kG;
    float* const hs = win + lay.hs + net * T1 * kHid;
    float c = 0.0f;
    float g0 = gxw[lane], g1 = gxw[lane + 32];
    for (int t = 0; t < T1; ++t) {
      float n0 = 0.0f, n1 = 0.0f;  // the next step's input term, early
      if (t + 1 < T1) {
        n0 = gxw[(t + 1) * kG + lane];
        n1 = gxw[(t + 1) * kG + lane + 32];
      }
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int k = 0; k < kHid; ++k) {
        a0 = madd(a0, h[k], wa[k]);
        a1 = madd(a1, h[k], wb[k]);
      }
      const float v0 = sigmoid(__fadd_rn(__fadd_rn(g0, a0), ba));
      const float p1 = __fadd_rn(__fadd_rn(g1, a1), bb);
      const float v1 = hi ? sigmoid(p1) : tanhf(p1);
      const float o0 = __shfl_xor_sync(~0u, v0, kHid);
      const float o1 = __shfl_xor_sync(~0u, v1, kHid);
      const float gi = hi ? o0 : v0, gf = hi ? v0 : o0;
      const float gg = hi ? o1 : v1, go = hi ? v1 : o1;
      const float cn = __fadd_rn(__fmul_rn(gf, c), __fmul_rn(gi, gg));
      const float tcv = tanhf(cn);
      const float hv = __fmul_rn(go, tcv);
      if (!hi) {
        hs[t * kHid + u] = hv;
        if (net == 0 && t < L) {
          float* const gr = win + lay.gates + t * kG;
          gr[u] = gi;
          gr[kHid + u] = gf;
          gr[2 * kHid + u] = gg;
          gr[3 * kHid + u] = go;
          win[lay.cprev + t * kHid + u] = c;
          win[lay.tc + t * kHid + u] = tcv;
        }
      }
      c = cn;
#pragma unroll
      for (int k = 0; k < kHid; ++k) h[k] = __shfl_sync(~0u, hv, k);
      g0 = n0;
      g1 = n1;
    }
  }
  __syncwarp();

  // ---- the heads of both nets at every timestep --------------------------
  {
    const float* const hs = win + lay.hs + net * T1 * kHid;
    const float* const w3 = sm + lay.w3 + net * kHid * kHid;
    const float* const b3 = sm + lay.b3 + net * kHid;
    const float* const w4 = sm + lay.w4 + net * kHid * kA;
    const float* const b4 = sm + lay.b4 + net * kA;
    float* const z3 = win + lay.z3 + net * T1 * kHid;
    float* const qv = win + lay.qv + net * T1 * kA;
    for (int e = lane; e < T1 * kHid; e += 32) {
      const int t = e / kHid, j = e - t * kHid;
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < kHid; ++k)
        a = madd(a, hs[t * kHid + k], w3[k * kHid + j]);
      z3[e] = __fadd_rn(a, b3[j]);
    }
    __syncwarp();
    for (int e = lane; e < T1 * kA; e += 32) {
      const int t = e / kA, j = e - t * kA;
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < kHid; ++k)
        a = madd(a, relu(z3[t * kHid + k]), w4[k * kA + j]);
      qv[e] = __fadd_rn(a, b4[j]);
    }
  }
  __syncthreads();  // the target warps' q, for the eval warps

  if (net == 0) {
    const float* const he = win + lay.hs;
    const float* const z3 = win + lay.z3;
    const float* const qe = win + lay.qv;
    const float* const qt = win + lay.qv + T1 * kA;
    float* const dq = win + lay.dq;
    float* const dz3 = win + lay.dz3;
    float* const dhh = win + lay.dhh;

    // ---- Double-DQN targets, dq and the loss terms, t < L -----------------
    const float two = __fdiv_rn(2.0f, static_cast<float>(s_msum));
    for (int t = lane; t < L; t += 32) {
      float ended = 0.0f;
      for (int s = 0; s < t; ++s) ended = fmaxf(ended, win[lay.dn + s]);
      const float mask = t >= rc.burn_in ? __fsub_rn(1.0f, ended) : 0.0f;
      const int star = argmax0(qe + (t + 1) * kA, kA);
      const float boot = qt[(t + 1) * kA + star];
      const float target = __fadd_rn(
          win[lay.rew + t], __fmul_rn(__fmul_rn(rc.gamma, boot),
                                      __fsub_rn(1.0f, win[lay.dn + t])));
      const int a = static_cast<int>(win[lay.act + t]);
      const float diff = __fsub_rn(qe[t * kA + a], target);
      const float coef = __fmul_rn(__fmul_rn(two, mask), diff);
      float* const row = ws_row(ws, b, L, t);
      for (int j = 0; j < kA; ++j) {
        const float d = __fmul_rn(j == a ? 1.0f : 0.0f, coef);
        dq[t * kA + j] = d;
        row[kWsDq + j] = d;
      }
      row[kWsDq + kA] = __fmul_rn(__fmul_rn(mask, diff), diff);
    }
    __syncwarp();

    // ---- backward through the heads; the heads' rows of the workspace -----
    const float* const w3 = sm + lay.w3;
    const float* const w4 = sm + lay.w4;
    for (int e = lane; e < L * kHid; e += 32) {
      const int t = e / kHid, k = e - t * kHid;
      float a = 0.0f;
      for (int j = 0; j < kA; ++j) a = madd(a, w4[k * kA + j], dq[t * kA + j]);
      const float z = z3[t * kHid + k];
      const float d = __fmul_rn(a, z > 0.0f ? 1.0f : 0.0f);
      dz3[e] = d;
      float* const row = ws_row(ws, b, L, t);
      row[kWsDz3 + k] = d;
      row[kWsZ3r + k] = relu(z);
      row[kWsH + k] = he[t * kHid + k];
      row[kWsX2h + kHid + k] = t == 0 ? 0.0f : he[(t - 1) * kHid + k];
    }
    __syncwarp();
    for (int e = lane; e < L * kHid; e += 32) {
      const int t = e / kHid, k = e - t * kHid;
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < kHid; ++j)
        a = madd(a, w3[k * kHid + j], dz3[t * kHid + j]);
      dhh[e] = a;
    }
    __syncwarp();

    // ---- backward through the recurrence, t = L - 1 down to 0 -------------
    // Lane u < 16 runs unit u's cell and then dh_{t-1}[u] = sum_j w_hh[u][j]
    // da[j]; lane 16 + u takes dx2[u] = sum_j w_ih[u][j] da[j] meanwhile,
    // each with its row of 64 weights in registers.
    float* const da = win + lay.da;
    float* const dx2 = sm + lay.dx2 + w * L * kHid;
    float wr[kG];
    {
      const float* const row = p + (hi ? kWih : kWhh) + u * kG;
#pragma unroll
      for (int j = 0; j < kG; ++j) wr[j] = row[j];
    }
    float dhn = 0.0f, dcn = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      if (!hi) {
        const float* const gr = win + lay.gates + t * kG;
        const float gi = gr[u], gf = gr[kHid + u], gg = gr[2 * kHid + u],
                    go = gr[3 * kHid + u];
        const float tcv = win[lay.tc + t * kHid + u];
        const float dh = __fadd_rn(dhh[t * kHid + u], dhn);
        const float dov = __fmul_rn(dh, tcv);
        const float dc = __fadd_rn(
            __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.0f, __fmul_rn(tcv, tcv))),
            dcn);
        da[u] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), gi),
                          __fsub_rn(1.0f, gi));
        da[kHid + u] = __fmul_rn(
            __fmul_rn(__fmul_rn(dc, win[lay.cprev + t * kHid + u]), gf),
            __fsub_rn(1.0f, gf));
        da[2 * kHid + u] = __fmul_rn(__fmul_rn(dc, gi),
                                     __fsub_rn(1.0f, __fmul_rn(gg, gg)));
        da[3 * kHid + u] = __fmul_rn(__fmul_rn(dov, go), __fsub_rn(1.0f, go));
        dcn = __fmul_rn(dc, gf);
      }
      __syncwarp();
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < kG; j += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(da + j);
        a = madd(a, wr[j], d4.x);
        a = madd(a, wr[j + 1], d4.y);
        a = madd(a, wr[j + 2], d4.z);
        a = madd(a, wr[j + 3], d4.w);
      }
      float* const row = ws_row(ws, b, L, t);
      if (hi) {
        dx2[t * kHid + u] = a;
        row[kWsDx2 + u] = a;
      } else {
        dhn = a;
      }
      row[kWsDa + lane] = da[lane];
      row[kWsDa + lane + 32] = da[lane + 32];
      __syncwarp();
    }
  }
  __syncthreads();  // every window's dx2, for the whole block

  // ---- dz1 = (w2 dx2) * relu'(z1) of the block's rows --------------------
  // The block's rows are workspace rows blockIdx.x * W * L + rr, rr = w * L
  // + t.  kDz1 outputs a thread at once: their relu(z1) loads issued
  // first, then their chains side by side.
  constexpr int kDz1 = 4;
  const float* const w2 = sm + lay.w2;
  float* const wsb = ws + static_cast<size_t>(blockIdx.x) * W * L * kWsWidth;
  const int n1 = W * L * kH1;
  for (int e0 = tid; e0 < n1; e0 += kDz1 * nt) {
    int rr[kDz1], ks[kDz1];
    float z[kDz1], a[kDz1];
#pragma unroll
    for (int x = 0; x < kDz1; ++x) {
      const int e = min(e0 + x * nt, n1 - 1);
      rr[x] = e / kH1;
      ks[x] = e - rr[x] * kH1;
      z[x] = wsb[static_cast<size_t>(rr[x]) * kWsWidth + kWsZ1r + ks[x]];
      a[x] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kHid; ++j)
#pragma unroll
      for (int x = 0; x < kDz1; ++x)
        a[x] = madd(a[x], w2[ks[x] * (kHid + 1) + j],
                    sm[lay.dx2 + rr[x] * kHid + j]);
#pragma unroll
    for (int x = 0; x < kDz1; ++x)
      if (e0 + x * nt < n1)
        wsb[static_cast<size_t>(rr[x]) * kWsWidth + kWsDz1 + ks[x]] =
            __fmul_rn(a[x], z[x] > 0.0f ? 1.0f : 0.0f);
  }
}

// ---- 4. the gradients and Adam -------------------------------------------

// One gradient job: the sum over rows of ws[h + k] * ws[d + j] for k < K,
// j < J.  Entry (k, j) is parameter out + k * stride + j; the last row of
// each first factor is the column of ones, so its entries are the bias.
struct GradJob {
  int h, K, d, J, out, stride;
};

constexpr int kJobs = 5;

__host__ __device__ inline GradJob grad_job(int i) {
  switch (i) {
    case 0:  // w1 [10][200], b1
      return {kWsX, kIn + 1, kWsDz1, kH1, kW1, kH1};
    case 1:  // w2 [200][16], b2
      return {kWsZ1r, kH1 + 1, kWsDx2, kHid, kW2, kHid};
    case 2:  // w_ih [16][64] (k < 16), w_hh (16 <= k < 32), b_ih = b_hh
      return {kWsX2h, 2 * kHid + 1, kWsDa, kG, kWih, kG};
    case 3:  // w3 [16][16], b3
      return {kWsH, kHid + 1, kWsDz3, kHid, kW3, kHid};
    default:  // w4 [16][5], b4; column 5 of the bias row is the loss
      return {kWsZ3r, kHid + 1, kWsDq, kA + 1, kW4, kA};
  }
}

// A block of NT threads (256, 512 or 1,024, from the host's geometry) owns
// a kGradK x kGradJ rectangle of one job's entries.  Each of its groups of
// 8 threads sums one summation tile at a time, each
// thread a 4 x 4 micro-tile of the rectangle, reading its 4 + 4 factors of
// every row straight from the workspace (16-byte loads, four rows ahead;
// the workspace stays in the L2 cache).  A round's partials are parked in
// shared memory and one thread per entry adds them into its total in tile
// order.
constexpr int kGradK = 16, kGradJ = 8;
constexpr int kGradEntries = kGradK * kGradJ;  // 128
constexpr int kGradGroup = kGradEntries / 16;  // threads a summation tile

__host__ __device__ inline int grad_rects(int K, int J) {
  return (K + kGradK - 1) / kGradK * ((J + kGradJ - 1) / kGradJ);
}

__host__ __device__ inline int grad_blocks() {
  int n = 0;
  for (int i = 0; i < kJobs; ++i)
    n += grad_rects(grad_job(i).K, grad_job(i).J);
  return n;
}

// Bytes of grad_kernel's shared memory (ops/fused_drqn.py:learn_tiling): the
// groups' partial sums, 64 bytes a thread.
__host__ __device__ constexpr size_t grad_smem(int threads) {
  return static_cast<size_t>(threads) / kGradGroup * kGradEntries *
         sizeof(float);
}

struct GradCfg {
  int B, L, sync;
  AdamHyper h;
};

__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& h,
                                       const float4& d) {
  const float hv[4] = {h.x, h.y, h.z, h.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(hv[i], dv[c]));
}

template <int NT>
__global__ void __launch_bounds__(NT)
grad_kernel(const float* __restrict__ ws, float* __restrict__ p,
            float* __restrict__ tp, float* __restrict__ m,
            float* __restrict__ v, float* __restrict__ loss,
            const int* __restrict__ msum, GradCfg gc) {
  constexpr int kGroups = NT / kGradGroup;  // summation tiles in flight
  static_assert(kGradEntries <= NT, "one thread per entry adds partials");
  int rect = blockIdx.x, ji = 0;
  for (; ji < kJobs - 1; ++ji) {
    const GradJob j = grad_job(ji);
    const int n = grad_rects(j.K, j.J);
    if (rect < n) break;
    rect -= n;
  }
  const GradJob job = grad_job(ji);
  const int njb = (job.J + kGradJ - 1) / kGradJ;
  const int k0 = rect / njb * kGradK, j0 = rect % njb * kGradJ;

  extern __shared__ __align__(16) float s_part[];  // [group][entry]
  const int tid = threadIdx.x;
  const int grp = tid / kGradGroup, mk = (tid % kGradGroup) >> 1,
            mj = tid & 1;  // a 4 x 4 micro-tile of the 16 x 8 rectangle
  const int TR = kWindows * gc.L;  // rows of a summation tile
  const int ntiles = gc.B / kWindows;
  // This thread's columns; a micro-tile wholly past K or J reads nothing
  // (its entries are not stored).  The groups are padded so that a
  // micro-tile that starts inside its job stays inside its group.
  const bool mine = k0 + 4 * mk < job.K && j0 + 4 * mj < job.J;
  const float* const hcol = ws + job.h + k0 + 4 * mk;
  const float* const dcol = ws + job.d + j0 + 4 * mj;
  auto ld = [](const float* q) {
    return __ldg(reinterpret_cast<const float4*>(q));
  };

  float total = 0.0f;  // entry tid < 128: (tid / kGradJ, tid % kGradJ)
  for (int q0 = 0; q0 < ntiles; q0 += kGroups) {
    const int tile = q0 + grp;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    if (tile < ntiles && mine) {
      const size_t base = static_cast<size_t>(tile) * TR * kWsWidth;
      int r = 0;
      for (; r + 4 <= TR; r += 4) {  // rows in order, four loaded at once
        float4 h4[4], d4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          h4[u] = ld(hcol + base + static_cast<size_t>(r + u) * kWsWidth);
          d4[u] = ld(dcol + base + static_cast<size_t>(r + u) * kWsWidth);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) outer4(acc, h4[u], d4[u]);
      }
      for (; r < TR; ++r)
        outer4(acc, ld(hcol + base + static_cast<size_t>(r) * kWsWidth),
               ld(dcol + base + static_cast<size_t>(r) * kWsWidth));
    }
    __syncthreads();  // the last round's partials have been added
    if (tile < ntiles) {
      float* const part = s_part + grp * kGradEntries;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[(4 * mk + i) * kGradJ + 4 * mj + c] = acc[i][c];
    }
    __syncthreads();
    if (tid < kGradEntries)
      for (int g = 0; g < kGroups && q0 + g < ntiles; ++g)
        total = __fadd_rn(total, s_part[g * kGradEntries + tid]);
  }

  if (tid >= kGradEntries) return;
  const int k = k0 + tid / kGradJ, j = j0 + tid % kGradJ;
  if (k >= job.K || j >= job.J) return;
  if (ji == kJobs - 1 && j == kA) {  // column 5: sum of mask * diff^2
    if (k == kHid) *loss = __fdiv_rn(total, static_cast<float>(*msum));
    return;
  }
  int i = job.out + k * job.stride + j, i2 = -1;
  if (ji == 2 && k >= kHid) {
    if (k < 2 * kHid) {
      i = kWhh + (k - kHid) * kG + j;
    } else {  // b_ih and b_hh: the same sum, two parameters
      i = kBih + j;
      i2 = kBhh + j;
    }
  }
  if (gc.sync) {  // the target sync comes before the update
    tp[i] = p[i];
    if (i2 >= 0) tp[i2] = p[i2];
  }
  adam_step(total, p, m, v, i, gc.h);
  if (i2 >= 0) adam_step(total, p, m, v, i2, gc.h);
}

template <int NT>
cudaError_t launch_grad(const float* ws, float* p, float* tp, float* m,
                        float* v, float* loss, const int* msum, GradCfg gc,
                        int smem, cudaStream_t stream) {
  if (gc.B <= 0 || gc.B % kWindows != 0 || gc.L < 1 ||
      grad_smem(NT) > static_cast<size_t>(smem))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(grad_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  grad_kernel<NT><<<grad_blocks(), NT, smem, stream>>>(ws, p, tp, m, v, loss,
                                                       msum, gc);
  return cudaGetLastError();
}

template <int RM, int RN>
cudaError_t launch_in(const float* p, const float* tgt, const float* ring,
                      float* ws, float* gx, int* cnt, InCfg ic, QnetGeom g,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(in_kernel<RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ic.B * (ic.L + 1) + g.rows - 1) / g.rows, 2);
  in_kernel<RM, RN><<<grid, kQnetThreads, g.smem, stream>>>(p, tgt, ring, ws,
                                                            gx, cnt, ic, g);
  return cudaGetLastError();
}

// Whether (B, L, round, col) name B whole windows of a ring of n lanes.
inline bool batch_ok(int n, int B, int L, int round, int col) {
  return B > 0 && B % kWindows == 0 && L >= 1 && round >= 0 && col >= 0 &&
         static_cast<long long>(col + 1) * B <= n;
}

template <int RM, int RN>
cudaError_t launch_act(const float* p, const float* opp, float* env,
                       float* win, float* ring, float* met, ActGeom g,
                       ActCfg ac, EnvCfg cfg, cudaStream_t stream) {
  cudaError_t err = allow_smem(act_kernel<RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  act_kernel<RM, RN><<<(ac.n + g.rows - 1) / g.rows, kThreads, g.smem,
                       stream>>>(p, opp, env, win, ring, met, g, ac, cfg);
  return cudaGetLastError();
}

}  // namespace drqn
}  // namespace mgt

// Kernel 1 of a step (act_kernel) on `n` envs in the geometry (rows, rm x
// rn, resident, chunk 0, smem) of ops/fused_drqn.py:act_geometry;
// opp_mode: kOppL0, kOppSelf (the live net p plays seat 2) or kOppFrozen
// (opp).  A geometry its layout does not fit is refused
// (cudaErrorInvalidValue).
extern "C" int mgt_drqn_act(const float* p, const float* opp, float* env,
                            float* win, float* ring, float* met, int n, int L,
                            int wl, int emit, int r_cur, int opp_mode,
                            int greedy, int random_start, int rows, int rm,
                            int rn, int resident, int chunk, int smem,
                            uint32_t step,
                            uint32_t threshold, uint32_t k0, uint32_t k1,
                            int max_steps, float r_first, float r_second,
                            float r_collision, float vel_penalty,
                            float time_penalty, cudaStream_t stream) {
  using namespace mgt;
  using namespace mgt::drqn;
  if (n <= 0) return 0;
  const bool frozen = opp_mode == kOppFrozen;
  const ActGeom g{rows, resident, chunk, smem};
  if (L < 1 || wl < 0 || wl >= L || r_cur < 0 || opp_mode < kOppL0 ||
      opp_mode > kOppFrozen || (frozen && opp == nullptr) ||
      !act_layout_ok(g, opp_mode == kOppL0 ? 1 : 2, frozen ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ActCfg ac{n, L, wl, emit, r_cur, opp_mode, greedy, random_start,
                  step, threshold, k0, k1};
  const EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
                   max_steps};
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                   \
  case M * 16 + N:                                                       \
    return static_cast<int>(                                             \
        launch_act<M, N>(p, opp, env, win, ring, met, g, ac, cfg, stream));
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mgt_drqn_learn_in(const float* p, const float* tgt,
                                 const float* ring, float* ws, float* gx,
                                 int* cnt, int n, int B, int L, int burn_in,
                                 int round, int col, int rows, int rm, int rn,
                                 int chunk, int smem, cudaStream_t stream) {
  using namespace mgt;
  using namespace mgt::drqn;
  const QnetGeom g{rows, chunk, smem};
  if (!batch_ok(n, B, L, round, col) ||
      !qnet_geom_ok<float>(in_dims(), g, kInRowInts))
    return static_cast<int>(cudaErrorInvalidValue);
  const InCfg ic{n, B, L, burn_in, round, col};
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                   \
  case M * 16 + N:                                                       \
    return static_cast<int>(                                             \
        launch_in<M, N>(p, tgt, ring, ws, gx, cnt, ic, g, stream));
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mgt_drqn_learn_rec(const float* p, const float* tgt,
                                  const float* ring, const float* gx,
                                  const int* cnt, float* ws, int* msum, int n,
                                  int B, int L, int burn_in, int round,
                                  int col, int W, int ncnt, int smem,
                                  float gamma, cudaStream_t stream) {
  using namespace mgt::drqn;
  if (!batch_ok(n, B, L, round, col) || W < 1 || W > kRecWindowsMax ||
      B % W != 0 || ncnt < 1 ||
      static_cast<size_t>(RecLayout(W, L).total) * sizeof(float) >
          static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mgt::allow_smem(rec_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RecCfg rc{n, B, L, burn_in, round, col, W, ncnt, gamma};
  rec_kernel<<<B / W, 64 * W, smem, stream>>>(p, tgt, ring, gx, cnt, ws, msum,
                                              rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_drqn_learn_grad(const float* ws, float* p, float* tp,
                                   float* m, float* v, float* loss,
                                   const int* msum, int B, int L, int sync,
                                   float lr, float b1, float b2, float omb1,
                                   float omb2, float eps, float c1, float c2,
                                   int threads, int smem,
                                   cudaStream_t stream) {
  using namespace mgt::drqn;
  const GradCfg gc{B, L, sync, {lr, b1, b2, omb1, omb2, eps, c1, c2}};
  cudaError_t err = cudaErrorInvalidValue;
  switch (threads) {
#define MGT_CASE(T)                                                   \
  case T:                                                             \
    err = launch_grad<T>(ws, p, tp, m, v, loss, msum, gc, smem, stream); \
    break;
    MGT_CASE(256) MGT_CASE(512) MGT_CASE(1024)
#undef MGT_CASE
  }
  return static_cast<int>(err);
}
