// K7: the whole two-timescale h-DQN trainer, one step as three to five
// kernels (five when both learners learn).
//
// Replaces merging_gym_tpu/ops/fused_hdqn.py:_kernel (helper _goal_status;
// pallas_call at :349 _call, entry fused_hdqn_chunk).  On the TPU the T
// steps of a chunk were the sequential grid of one launch with both nets,
// their targets and Adam moments, both replay rings and the env state in
// VMEM.  On the H100 it follows K5's design (dqn_trainer.cu): a per-step
// sequence of kernels on one stream, issued by a host loop
// (ops/fused_hdqn.py), with no read-back inside a chunk.  Per step:
//
//   1. hdqn_act_env_store (this file): a block owns `rows` envs (sized from
//      n and the SM count, ops/fused_trainer.py:act_geometry: 8 envs in 128
//      blocks at 1,024).  Per env:
//      the meta forward on the obs gives a fresh goal where an option
//      starts (the return is zeroed there); the low forward on
//      [goal; obs]; unless the opponent is L0, its meta forward on the
//      half-swapped obs (its goal refreshed only where the ego's option
//      starts) and its low forward; the env step of env_math.cuh; the meta
//      forward on the post-step obs gives the goal re-chosen every step;
//      the intrinsic reward (new goal == status of the pre-step obs); the
//      lower slab [goal;obs, goal_new;next_obs, a1, intrinsic, done, pad],
//      stored into lower round r_lo for every env; the option end (done or
//      new goal == status of the post-step obs); the upper slab
//      [next_obs, next_obs, goal_new, extr, done, pad], stored into upper
//      round r_up only where the option ended (other lanes keep their old
//      row); the metrics (win tested on the post-step obs, episode reward
//      accumulated unconditionally); the auto-reset; state rows 0-14.
//      Each forward is one pass of act_tiled.cuh's register micro-tiles
//      over the block's 10- or 11-wide rows (the ego's upper and lower nets
//      held in shared memory for the launch where they fit, a frozen
//      opponent's streamed; in self-play the two seats' upper forwards are
//      one pass over 2 x rows rows, and so are their lower ones: 3 passes
//      a step, as against L0), then argmax0 and phi_select on the words at
//      (step, env, stream, 0): stream 0 for the goal and the action,
//      stream 2 for the opponent's goal and action, stream 3 for the
//      re-chosen goal (stream 1 is the random start).  Every block also
//      raises the step's flag any_end[i] where one of its envs ended an
//      option (__syncthreads_or, then one atomicOr: no order dependence).
//   2-3. the lower learner: learn_fwd_kernel + learn_grad_kernel of
//      dqn_trainer.cu on the lower ring (11 inputs, 32 fields per round).
//      Its gate, learn count, target sync and Adam step follow from host
//      counters, as in K5.
//   4-5. the upper learner: the same two kernels on the upper ring (10
//      inputs, 24 fields).  It learns only where some option ended, so
//      its learn count is data-dependent.  The host issues the pair once
//      the upper ring has filled (its host gate); both kernels read
//      any_end[i], return at once when it is 0, and otherwise count the
//      learns of this chunk before this one from any_end themselves (T is
//      a few hundred, so the sum is cheap, and nothing increments a counter
//      that others read).  The count before the chunk is read from state
//      row 15 once per chunk; Adam's bias corrections for each possible
//      count are a table computed on the host, as K5 computes them, so
//      CUDA's expf and torch.exp never meet.  At the chunk's end the host
//      reads any_end once and writes the new count into row 15.
//
// Every sum is one thread's, in a fixed order, with one rounding per
// multiply and per add (-fmad=false), so the plain version
// (fused_hdqn_chunk_plain) agrees bit for bit and two runs on the same
// inputs give the same bits.
//
// Bound on an H100: per step two meta forwards (10-200-100-3) and one low
// forward (11-200-100-5) per env, one more of each with an opponent net, and
// on a learning step both learners' three forwards and backward per
// sampled lane (about 5 x 23,000 multiply-adds each); the rings, state
// rows and ten parameter sets are a few MB, so K7 is bound by operations.
// Its act kernel runs on qnet_tiled.cuh's register micro-tiles over 128
// blocks at 1,024 envs, and the learners are K5's register-tiled ones
// (dqn_trainer.cu); without FMA (bit-equality) at most half of the bound
// is reachable.  The measured times are in PERF.md (chip_smoke.py).
#include <cstdint>

#include "act_tiled.cuh"
#include "env_math.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kObs = 10;
constexpr int kLoF = 32;  // lower ring fields: [goal;obs] 11, [goal';obs'] 11,
                          // action, intrinsic reward, done, pad 7
constexpr int kUpF = 24;  // upper ring fields: obs 10, next obs 10, goal,
                          // extrinsic return, done, pad

struct HdqnCfg {
  int n, r_lo, r_up, opp, greedy, random_start;  // opp: kOppL0, kOppSelf,
                                                 // kOppFrozen
  uint32_t step, threshold, k0, k1;
};

// hdqn.py:223-236: behind (0), alongside (1) or ahead (2) of the other car.
__device__ __forceinline__ int goal_status(const float* o) {
  return o[0] < -0.5f * o[9] ? 0 : (o[0] < 0.5f * o[9] ? 1 : 2);
}

// The Phi(eps)-greedy pick of row e of q[rows][a].
__device__ __forceinline__ int pick(const float* q, int e, int a,
                                    const HdqnCfg& hc, uint32_t mask,
                                    uint32_t rand) {
  const int best = argmax0(q + e * a, a);
  return hc.greedy ? best : phi_select(best, mask, rand, hc.threshold, a);
}

// A block owns `rows` envs, thread e < rows env env0 + e (its state in
// registers, its inputs written straight into the input tile).  Every
// forward is one pass of the block over its rows (act_tiled.cuh); the upper
// net, which runs twice a step, and the lower net are held in shared memory
// for the launch as far as they fit (g.resident: 2, 1 or 0, in that order).
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 1)
hdqn_act_env_store_kernel(Net<T> unet, Net<T> lnet, Net<T> opp_unet,
                          Net<T> opp_lnet, float* __restrict__ state,
                          float* __restrict__ lo_ring,
                          float* __restrict__ up_ring,
                          float* __restrict__ met,
                          int32_t* __restrict__ any_end, ActGeom g,
                          MlpDims du, MlpDims dl, HdqnCfg hc, EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpDims nets[2] = {du, dl};
  const int seats = hc.opp == kOppSelf ? 2 : 1;
  const ActSmem S(nets, 2, g, sizeof(T), seats);
  const NetSmem WU(du, sizeof(T));
  T* const s_in = reinterpret_cast<T*>(smem + S.in);
  const float* const q = reinterpret_cast<const float*>(smem + S.q);
  const int su = act_stride(du.in), sl = act_stride(dl.in);
  const long at_u = g.resident >= 1 ? 0 : -1;
  const long at_l = g.resident >= 2 ? static_cast<long>(WU.bytes) : -1;

  const int env0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, hc.n - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(hc.n);

  if (g.resident >= 1) {  // the upper net, then the lower, into shared
    stage_net(smem, WU, du, unet);  // memory while the state rows load
    cp_async_commit();
  }
  if (g.resident >= 2) {
    stage_net(smem + WU.bytes, NetSmem(dl, sizeof(T)), dl, lnet);
    cp_async_commit();
  }

  // Every thread runs the forwards (each pass is block-wide); thread e <
  // rows owns env lane, in registers.
  EnvState s{};
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, ep_rew = 0.f, extr = 0.f;
  int goal = 0, goal_op = 0;
  bool opt_start = false;
  float o[kObs] = {};
  Bits4 ba{}, bo{}, bg{};
  if (owner) {  // rows: pos 2, vel 2, xy 4, winner, t, ep_reward, goal,
                // goal_op, extr, option_start (row 15: the host's counter)
    s.pos1 = state[0 * sN + lane];
    s.pos2 = state[1 * sN + lane];
    s.vel1 = state[2 * sN + lane];
    s.vel2 = state[3 * sN + lane];
    x1 = state[4 * sN + lane];
    y1 = state[5 * sN + lane];
    x2 = state[6 * sN + lane];
    y2 = state[7 * sN + lane];
    s.winner = static_cast<int>(state[8 * sN + lane]);
    s.t = static_cast<int>(state[9 * sN + lane]);
    ep_rew = state[10 * sN + lane];
    goal = static_cast<int>(state[11 * sN + lane]);
    goal_op = static_cast<int>(state[12 * sN + lane]);
    extr = state[13 * sN + lane];
    opt_start = state[14 * sN + lane] > 0.5f;
    const float pre[kObs] = {x2 - x1, y2 - y1, s.vel2 - s.vel1,
                             kEndPoint - s.pos1, s.vel1, x1 - x2, y1 - y2,
                             s.vel1 - s.vel2, kEndPoint - s.pos2, s.vel2};
#pragma unroll
    for (int k = 0; k < kObs; ++k) o[k] = pre[k];
    put_obs<0>(s_in + e * su, o);
    if (seats == 2) put_obs<5>(s_in + (rows + e) * su, o);
    if (!hc.greedy) {
      const uint32_t l = static_cast<uint32_t>(lane);
      ba = draw(hc.step, l, kStreamActions, hc.k0, hc.k1);
      bo = draw(hc.step, l, kStreamOpponent, hc.k0, hc.k1);
      bg = draw(hc.step, l, kStreamGoal, hc.k0, hc.k1);
    }
  }
  // The upper net's copy has landed (the lower one's may still be in
  // flight); act_forward's first barrier publishes it.
  if (g.resident >= 2) cp_async_wait_prev();
  else cp_async_wait_all();

  // Option boundaries: a fresh goal and a zeroed return (hdqn.py:283-286),
  // in self-play the opponent's too, from the same pass.
  act_forward<T, RM, RN>(smem, S, g.chunk, du, unet, at_u, seats * rows);
  if (owner) {
    const int fresh = pick(q, e, du.a, hc, ba.x, ba.y);
    if (opt_start) {
      goal = fresh;
      extr = 0.0f;
    }
    if (seats == 2) {
      const int fresh_op = pick(q, rows + e, du.a, hc, bo.x, bo.y);
      if (opt_start) goal_op = fresh_op;
    }
    // The lower net's input rows: [goal; obs] (and [goal_op; swapped obs]).
    s_in[e * sl] = Num<T>::from_f(static_cast<float>(goal));
    put_obs<0>(s_in + e * sl + 1, o);
    if (seats == 2) {
      s_in[(rows + e) * sl] = Num<T>::from_f(static_cast<float>(goal_op));
      put_obs<5>(s_in + (rows + e) * sl + 1, o);
    }
  }
  cp_async_wait_all();
  act_forward<T, RM, RN>(smem, S, g.chunk, dl, lnet, at_l, seats * rows);
  int a1 = 0, a2 = -1;  // -1: ACTION_NONE, the L0 opponent
  if (owner) {
    a1 = pick(q, e, dl.a, hc, ba.z, ba.w);
    if (seats == 2) a2 = pick(q, rows + e, dl.a, hc, bo.z, bo.w);
  }

  if (hc.opp == kOppFrozen) {  // the frozen pair on the half-swapped obs
    if (owner) put_obs<5>(s_in + e * su, o);
    act_forward<T, RM, RN>(smem, S, g.chunk, du, opp_unet, -1, rows);
    if (owner) {
      const int fresh = pick(q, e, du.a, hc, bo.x, bo.y);
      if (opt_start) goal_op = fresh;
      s_in[e * sl] = Num<T>::from_f(static_cast<float>(goal_op));
      put_obs<5>(s_in + e * sl + 1, o);
    }
    act_forward<T, RM, RN>(smem, S, g.chunk, dl, opp_lnet, -1, rows);
    if (owner) a2 = pick(q, e, dl.a, hc, bo.z, bo.w);
  }

  StepOut so{};
  float nx[kObs] = {};
  if (owner) {
    so = env_step(s, a1, a2, cfg);
    const float next[kObs] = {so.x2 - so.x1, so.y2 - so.y1, s.vel2 - s.vel1,
                              kEndPoint - s.pos1, s.vel1, so.x1 - so.x2,
                              so.y1 - so.y2, s.vel1 - s.vel2,
                              kEndPoint - s.pos2, s.vel2};
#pragma unroll
    for (int k = 0; k < kObs; ++k) nx[k] = next[k];
    put_obs<0>(s_in + e * su, nx);
  }
  // The goal re-chosen from the post-step obs (hdqn.py:303).
  act_forward<T, RM, RN>(smem, S, g.chunk, du, unet, at_u, rows);

  bool opt_end = false;
  if (owner) {
    const int goal_new = pick(q, e, du.a, hc, bg.x, bg.y);
    const float done_f = so.done ? 1.0f : 0.0f;

    // Lower ring: every env, every step (hdqn.py:316).
    float* lo = lo_ring + static_cast<size_t>(hc.r_lo) * kLoF * sN + lane;
    lo[0] = static_cast<float>(goal);
    lo[(kObs + 1) * sN] = static_cast<float>(goal_new);
    for (int k = 0; k < kObs; ++k) {
      lo[(1 + k) * sN] = o[k];
      lo[(kObs + 2 + k) * sN] = nx[k];
    }
    lo[22 * sN] = static_cast<float>(a1);
    lo[23 * sN] = goal_new == goal_status(o) ? 1.0f : 0.0f;  // intrinsic
    lo[24 * sN] = done_f;
    for (int k = 25; k < kLoF; ++k) lo[k * sN] = 0.0f;

    // Option end and the upper ring, faithful meta transition: the final
    // state twice (hdqn.py:320-325).
    extr = extr + so.r1;
    opt_end = so.done || goal_new == goal_status(nx);
    if (opt_end) {
      float* up = up_ring + static_cast<size_t>(hc.r_up) * kUpF * sN + lane;
      for (int k = 0; k < kObs; ++k) {
        up[k * sN] = nx[k];
        up[(kObs + k) * sN] = nx[k];
      }
      up[20 * sN] = static_cast<float>(goal_new);
      up[21 * sN] = extr;
      up[22 * sN] = done_f;
      up[23 * sN] = 0.0f;
    }

    // Metrics: episodes, collisions, wins (post-step obs), episode returns
    // (every reward, hdqn.py:312).
    ep_rew = ep_rew + so.r1;
    const bool won = so.done && (nx[8] > nx[3]);
    met[0 * sN + lane] = met[0 * sN + lane] + done_f;
    met[1 * sN + lane] = met[1 * sN + lane] + (so.col ? 1.0f : 0.0f);
    met[2 * sN + lane] = met[2 * sN + lane] + (won ? 1.0f : 0.0f);
    met[3 * sN + lane] = met[3 * sN + lane] + (so.done ? ep_rew : 0.0f);
    if (so.done) ep_rew = 0.0f;

    float nx1 = so.x1, ny1 = so.y1, nx2 = so.x2, ny2 = so.y2;
    if (so.done) {  // auto-reset (winner and t back to 0)
      if (hc.random_start) {
        random_start(s, hc.step, static_cast<uint32_t>(lane), hc.k0, hc.k1);
      } else {
        start_state(s);
      }
      lon2coord(s.pos1, 1.0f, nx1, ny1);
      lon2coord(s.pos2, -1.0f, nx2, ny2);
    }
    state[0 * sN + lane] = s.pos1;
    state[1 * sN + lane] = s.pos2;
    state[2 * sN + lane] = s.vel1;
    state[3 * sN + lane] = s.vel2;
    state[4 * sN + lane] = nx1;
    state[5 * sN + lane] = ny1;
    state[6 * sN + lane] = nx2;
    state[7 * sN + lane] = ny2;
    state[8 * sN + lane] = static_cast<float>(s.winner);
    state[9 * sN + lane] = static_cast<float>(s.t);
    state[10 * sN + lane] = ep_rew;
    state[11 * sN + lane] = static_cast<float>(goal_new);
    state[12 * sN + lane] = static_cast<float>(goal_op);
    state[13 * sN + lane] = opt_end ? 0.0f : extr;
    state[14 * sN + lane] = opt_end ? 1.0f : 0.0f;
  }
  // The step's flag for the upper learner's gate.
  if (__syncthreads_or(opt_end ? 1 : 0) && threadIdx.x == 0)
    atomicOr(any_end, 1);
}

template <typename T, int RM, int RN>
cudaError_t launch_tile(const Net<T> (&n)[4], float* state, float* lo_ring,
                        float* up_ring, float* met, int32_t* any_end,
                        ActGeom g, MlpDims du, MlpDims dl, HdqnCfg hc,
                        EnvCfg cfg, cudaStream_t stream) {
  cudaError_t err = allow_smem(hdqn_act_env_store_kernel<T, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (hc.n + g.rows - 1) / g.rows;
  hdqn_act_env_store_kernel<T, RM, RN>
      <<<blocks, kQnetThreads, g.smem, stream>>>(
          n[0], n[1], n[2], n[3], state, lo_ring, up_ring, met, any_end, g,
          du, dl, hc, cfg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hdqn_act(const void* up, const void* lp, const void* oup,
                            const void* olp, float* state, float* lo_ring,
                            float* up_ring, float* met, int32_t* any_end,
                            ActGeom g, int rm, int rn, MlpDims du,
                            MlpDims dl, HdqnCfg hc, EnvCfg cfg,
                            cudaStream_t stream) {
  const MlpDims nets[2] = {du, dl};
  if (!act_geom_ok<T>(nets, 2, g, hc.opp == kOppSelf ? 2 : 1,
                      hc.opp == kOppFrozen || g.resident < 2))
    return cudaErrorInvalidValue;
  const bool frozen = hc.opp == kOppFrozen;
  const Net<T> n[4] = {net_at<T>(up, du), net_at<T>(lp, dl),
                       net_at<T>(frozen ? oup : up, du),
                       net_at<T>(frozen ? olp : lp, dl)};
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                       \
  case M * 16 + N:                                                           \
    return launch_tile<T, M, N>(n, state, lo_ring, up_ring, met, any_end, g, \
                                du, dl, hc, cfg, stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mgt

// up/lp: the meta (10 -> h1 -> h2 -> a_up) and low (11 -> ... -> a_lo)
// nets as flat buffers in the compute dtype; opp_up/opp_lp the frozen
// opponent's (read only when opp_mode is kOppFrozen; kOppSelf plays the
// ego's nets, kOppL0 none).  The geometry (rows, rm x rn, resident, chunk,
// smem) is ops/fused_trainer.py:act_geometry's; one its layout does not fit
// is refused (cudaErrorInvalidValue).  any_end points at this step's flag.
extern "C" int mgt_hdqn_act(const void* up, const void* lp,
                            const void* opp_up, const void* opp_lp,
                            float* state, float* lo_ring, float* up_ring,
                            float* met, int32_t* any_end, int n, int h1,
                            int h2, int a_up, int a_lo, int rows, int rm,
                            int rn, int resident, int chunk, int smem,
                            int bf16, int opp_mode, int greedy,
                            int random_start, uint32_t step, int r_lo,
                            int r_up, uint32_t threshold, uint32_t k0,
                            uint32_t k1, int max_steps, float r_first,
                            float r_second, float r_collision,
                            float vel_penalty, float time_penalty,
                            cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0) return 0;
  if (a_up <= 0 || a_lo <= 0 || opp_mode < kOppL0 || opp_mode > kOppFrozen)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims du{kObs, h1, h2, a_up};
  MlpDims dl{kObs + 1, h1, h2, a_lo};
  ActGeom g{rows, resident, chunk, smem};
  HdqnCfg hc{n, r_lo, r_up, opp_mode, greedy, random_start,
             step, threshold, k0, k1};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  cudaError_t err =
      bf16 ? launch_hdqn_act<__nv_bfloat16>(up, lp, opp_up, opp_lp, state,
                                            lo_ring, up_ring, met, any_end, g,
                                            rm, rn, du, dl, hc, cfg, stream)
           : launch_hdqn_act<float>(up, lp, opp_up, opp_lp, state, lo_ring,
                                    up_ring, met, any_end, g, rm, rn, du, dl,
                                    hc, cfg, stream);
  return static_cast<int>(err);
}
