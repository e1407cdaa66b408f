// K5: the whole Double-DQN trainer, one step as three kernels.
//
// Replaces merging_gym_tpu/ops/fused_trainer.py:_kernel (with its helpers
// learn_math, _fwd and _argmax0; entry fused_dqn_chunk).  On the TPU the
// T training steps of a chunk were the sequential grid of ONE launch, with
// every piece of state resident in VMEM.  Blocks of an H100 run in no
// order and carry nothing across a grid, and the learner reduces over the
// whole batch every step, so each step needs a reduction across blocks.
// The design is a per-step sequence of three launches on one stream,
// issued by the host wrapper in a loop (ops/fused_trainer.py), with no
// read-back inside a chunk: the learn gate, the learn count, the target
// sync and Adam's bias corrections depend only on host counters and are
// passed as launch arguments.  (One cooperative launch per chunk with grid
// syncs was the alternative; it needs the whole grid resident at once,
// which caps envs and lanes per launch, and three plain kernels are each
// easier to hold against the plain version.)
//
//   1. dqn_act_env_store: a block owns `tile` envs.  Both seats' actors
//      (mlp_tile of mlp.cuh, then argmax0 and the shared phi_select on the
//      four Philox words at (step, env, 0, 0); the opponent is the live
//      net, a frozen net, or L0), the env step of env_math.cuh, the [24]
//      transition slab stored into ring round r_cur (a lane whose ego has
//      won keeps its old row), the per-env metrics (win tested on the
//      pre-step obs) and the auto-reset.
//   2. dqn_learn_partials (only on a learning step): a block owns `tile`
//      of the B sampled lanes, gathered from the (round, lane-window)
//      draws.  Forward of p on x, of p and the target net on x', the TD
//      error, and the hand-derived backward of learn_math; each block
//      writes its partial sums of every gradient and of the squared TD
//      error to work[block][P + 1].
//   3. dqn_adam (only on a learning step): one thread per parameter sums
//      the partials in block order (a fixed order, no atomics), copies
//      tp := p first on a sync step, and applies Adam.
//
// Every sum is one thread's, in a fixed order, with one rounding per
// multiply and per add (-fmad=false): two runs on the same inputs give
// the same bits, and the plain version (fused_dqn_chunk_plain) sums in
// the same order, so the two agree bit for bit.  Parameters are one flat
// f32 buffer per set, in the [in, out] layout of mlp.cuh:
// w0 [in][h1], b0 [h1], w1 [h1][h2], b1 [h2], w2 [h2][a], b2 [a].  In
// bf16 the forward and backward operands are bf16 copies of the masters
// (refreshed by dqn_adam), products are exact in f32 and sums are f32;
// masters, gradients, the TD math and Adam stay f32.
//
// The learner (kernels 2 and 3) is shared with K7, the h-DQN trainer
// (hdqn_trainer.cu), which runs it twice per step: on its lower ring (11
// inputs, 32 fields per round) and on its upper ring (10 inputs, 24
// fields).  A ring round holds obs at fields [0, in), next obs at
// [in, 2 in), then action, reward and done; num_f is the fields per round.
// K7's upper learner learns only on steps where some option ended, so its
// learn count, target sync and Adam step depend on the data: it passes a
// device gate (DevGate), and both kernels read the per-step flags that its
// act kernel raised and count the learns before this one themselves.
//
// Bound on an H100: per step 2 actor forwards per env and, on a learning
// step, 3 forwards and a backward (about 5 x 22,500 multiply-adds) per
// sampled lane, all f32 on the CUDA cores; the ring, the env rows and the
// parameters are a few MB, so the trainer is bound by operations.  The
// grid is small (64 blocks for 1,024 envs or lanes), so it sits far from
// that bound; the measured times are in PERF.md (chip_smoke.py).
#include <cstdint>

#include "env_math.cuh"
#include "learn_math.cuh"
#include "mlp.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kTrainThreads = 256;
constexpr int kNumF = 24;  // K5's ring fields per round: obs 10, next obs
                           // 10, action, reward, done, pad

struct ActCfg {
  int n, r_cur, opp, greedy, random_start;
  uint32_t step, threshold, k0, k1;
};

template <typename T>
__global__ void __launch_bounds__(kTrainThreads)
act_env_store_kernel(Net<T> pnet, Net<T> onet, float* __restrict__ env,
                     float* __restrict__ ring, float* __restrict__ met,
                     int tile, MlpDims d, ActCfg ac, EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* obs1 = reinterpret_cast<float*>(smem);  // [tile][10]
  float* obs2 = obs1 + tile * 10;                // [tile][10]
  float* q1 = obs2 + tile * 10;                  // [tile][a]
  float* q2 = q1 + tile * d.a;                   // [tile][a]
  T* s_in = reinterpret_cast<T*>(q2 + tile * d.a);
  T* s_h1 = s_in + tile * d.in;
  T* s_h2 = s_h1 + tile * d.h1;

  const int env0 = blockIdx.x * tile;
  const int rows = min(tile, ac.n - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

  EnvState s;
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, ep_rew = 0.f;
  float o[10];
  if (owner) {  // the env rows: pos 2, vel 2, xy 4, winner, t, ep_reward
    s.pos1 = env[0 * sN + lane];
    s.pos2 = env[1 * sN + lane];
    s.vel1 = env[2 * sN + lane];
    s.vel2 = env[3 * sN + lane];
    x1 = env[4 * sN + lane];
    y1 = env[5 * sN + lane];
    x2 = env[6 * sN + lane];
    y2 = env[7 * sN + lane];
    s.winner = static_cast<int>(env[8 * sN + lane]);
    s.t = static_cast<int>(env[9 * sN + lane]);
    ep_rew = env[10 * sN + lane];
    const float pre[10] = {x2 - x1, y2 - y1, s.vel2 - s.vel1,
                           kEndPoint - s.pos1, s.vel1, x1 - x2, y1 - y2,
                           s.vel1 - s.vel2, kEndPoint - s.pos2, s.vel2};
    for (int k = 0; k < 10; ++k) {
      o[k] = pre[k];
      obs1[e * 10 + k] = pre[k];
      obs2[e * 10 + k] = pre[(k + 5) % 10];
    }
  }
  mlp_tile<T>(obs1, rows, d, pnet, s_in, s_h1, s_h2, q1);
  if (ac.opp) mlp_tile<T>(obs2, rows, d, onet, s_in, s_h1, s_h2, q2);
  if (!owner) return;

  int a1 = argmax0(q1 + e * d.a, d.a);
  int a2 = ac.opp ? argmax0(q2 + e * d.a, d.a) : -1;
  if (!ac.greedy) {
    Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                   ac.k0, ac.k1);
    a1 = phi_select(a1, b.x, b.y, ac.threshold, d.a);
    if (ac.opp) a2 = phi_select(a2, b.z, b.w, ac.threshold, d.a);
  }
  StepOut so = env_step(s, a1, a2, cfg);

  // Ring store; a lane whose ego has won keeps its old row.
  const bool stored = s.winner != 1;
  if (stored) {
    float* row = ring + static_cast<size_t>(ac.r_cur) * kNumF * sN + lane;
    const float next[10] = {so.x2 - so.x1, so.y2 - so.y1, s.vel2 - s.vel1,
                            kEndPoint - s.pos1, s.vel1, so.x1 - so.x2,
                            so.y1 - so.y2, s.vel1 - s.vel2,
                            kEndPoint - s.pos2, s.vel2};
    for (int k = 0; k < 10; ++k) {
      row[k * sN] = o[k];
      row[(10 + k) * sN] = next[k];
    }
    row[20 * sN] = static_cast<float>(a1);
    row[21 * sN] = so.r1;
    row[22 * sN] = so.done ? 1.0f : 0.0f;
    row[23 * sN] = 0.0f;
  }

  // Metrics: episodes, collisions, wins (pre-step obs), episode returns.
  ep_rew = ep_rew + (stored ? so.r1 : 0.0f);
  const bool won = so.done && (o[8] > o[3]);
  met[0 * sN + lane] = met[0 * sN + lane] + (so.done ? 1.0f : 0.0f);
  met[1 * sN + lane] = met[1 * sN + lane] + (so.col ? 1.0f : 0.0f);
  met[2 * sN + lane] = met[2 * sN + lane] + (won ? 1.0f : 0.0f);
  met[3 * sN + lane] = met[3 * sN + lane] + (so.done ? ep_rew : 0.0f);
  if (so.done) ep_rew = 0.0f;

  float nx1 = so.x1, ny1 = so.y1, nx2 = so.x2, ny2 = so.y2;
  if (so.done) {  // auto-reset (winner and t back to 0)
    if (ac.random_start) {
      random_start(s, ac.step, static_cast<uint32_t>(lane), ac.k0, ac.k1);
    } else {
      start_state(s);
    }
    lon2coord(s.pos1, 1.0f, nx1, ny1);
    lon2coord(s.pos2, -1.0f, nx2, ny2);
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
}

struct LearnCfg {
  int n, W, num_f, mask_terminal;
  float gamma, two_over_b;
};

// The device-side learn gate of K7's upper learner.  It learns on step
// `step` iff any_end[step] != 0, and its learn count there is `prior` plus
// the number of steps j in [first_open, step) with any_end[j] != 0 (the
// host gate is open from first_open on).  bias[2k], bias[2k + 1] are Adam's
// bias corrections for count prior + k, computed on the host.  any_end ==
// nullptr: no device gate (K5, K7's lower learner); the host decides.
struct DevGate {
  const int32_t* any_end;
  const float* bias;
  int step, first_open, prior, target_sync;
};

// -1 where the gate is shut, else the learns of this chunk before this one.
__device__ __forceinline__ int gate_count(const DevGate& g) {
  if (g.any_end[g.step] == 0) return -1;
  int k = 0;
  for (int j = g.first_open; j < g.step; ++j) k += g.any_end[j] != 0 ? 1 : 0;
  return k;
}

__device__ __forceinline__ bool gate_syncs(const DevGate& g, int k) {
  return (static_cast<long long>(g.prior) + k) % g.target_sync == 0;
}

template <typename T>
__global__ void __launch_bounds__(kTrainThreads)
learn_partials_kernel(Net<T> pnet, Net<T> tnet, const float* __restrict__ ring,
                      const int32_t* __restrict__ rounds,
                      const int32_t* __restrict__ cols,
                      float* __restrict__ work, int tile, MlpDims d,
                      LearnCfg lc, DevGate g) {
  if (g.any_end != nullptr) {  // the same decision in every thread
    const int k = gate_count(g);
    if (k < 0) return;
    if (gate_syncs(g, k)) tnet = pnet;  // the sync comes before the update
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = d.a, H1 = d.h1, H2 = d.h2, IN = d.in;
  float* x = reinterpret_cast<float*>(smem);  // [tile][in]
  float* xn = x + tile * IN;                  // [tile][in]
  float* qne = xn + tile * IN;                // [tile][a]
  float* qnt = qne + tile * A;                // [tile][a]
  float* q = qnt + tile * A;                  // [tile][a]
  float* dq = q + tile * A;                   // [tile][a]
  float* dz2 = dq + tile * A;                 // [tile][h2]
  float* dz1 = dz2 + tile * H2;               // [tile][h1]
  float* act = dz1 + tile * H1;               // [tile]
  float* rew = act + tile;                    // [tile]
  float* done = rew + tile;                   // [tile]
  float* diff2 = done + tile;                 // [tile]
  T* s_in = reinterpret_cast<T*>(diff2 + tile);  // [tile][in]
  T* s_h1 = s_in + tile * IN;                 // [tile][h1]
  T* s_h2 = s_h1 + tile * H1;                 // [tile][h2]
  T* dqc = s_h2 + tile * H2;                  // [tile][a]
  T* dz2c = dqc + tile * A;                   // [tile][h2]
  T* dz1c = dz2c + tile * H2;                 // [tile][h1]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * tile;
  const size_t sN = static_cast<size_t>(lc.n);

  // Gather the tile's lanes: lane b of the batch is column b % W of draw
  // k = b / W, i.e. ring round rounds[k], env cols[k] * W + b % W.  The
  // fields past done (padding) are not read.
  for (int i = tid; i < (2 * IN + 3) * tile; i += nt) {
    const int f = i / tile, r = i - f * tile, b = b0 + r;
    const int k = b / lc.W;
    const int src = cols[k] * lc.W + (b - k * lc.W);
    const float val =
        ring[(static_cast<size_t>(rounds[k]) * lc.num_f + f) * sN + src];
    if (f < IN) x[r * IN + f] = val;
    else if (f < 2 * IN) xn[r * IN + f - IN] = val;
    else if (f == 2 * IN) act[r] = val;
    else if (f == 2 * IN + 1) rew[r] = val;
    else done[r] = val;
  }
  mlp_tile<T>(xn, tile, d, pnet, s_in, s_h1, s_h2, qne);
  mlp_tile<T>(xn, tile, d, tnet, s_in, s_h1, s_h2, qnt);
  // Last, so that s_in, s_h1 and s_h2 keep x's activations.
  mlp_tile<T>(x, tile, d, pnet, s_in, s_h1, s_h2, q);

  if (tid < tile) {  // Double-DQN target and TD error of one lane
    const int r = tid;
    const int ai = static_cast<int>(act[r]);
    float boot = qnt[r * A + argmax0(qne + r * A, A)];
    if (lc.mask_terminal) boot = __fmul_rn(boot, __fsub_rn(1.0f, done[r]));
    const float target = __fadd_rn(rew[r], __fmul_rn(lc.gamma, boot));
    const float diff = __fsub_rn(q[r * A + ai], target);
    diff2[r] = __fmul_rn(diff, diff);
    const float g = __fmul_rn(lc.two_over_b, diff);
    for (int j = 0; j < A; ++j) {
      const float v = __fmul_rn(j == ai ? 1.0f : 0.0f, g);
      dq[r * A + j] = v;
      dqc[r * A + j] = Num<T>::from_f(v);
    }
  }
  __syncthreads();
  for (int i = tid; i < tile * H2; i += nt) {  // dz2 = (w2 dq) * relu'
    const int r = i / H2, j = i - r * H2;
    float acc = 0.0f;
    for (int a = 0; a < A; ++a)
      acc = madd(acc, Num<T>::to_f(pnet.w2[j * A + a]),
                 Num<T>::to_f(dqc[r * A + a]));
    dz2[i] = __fmul_rn(acc, Num<T>::to_f(s_h2[i]) > 0.0f ? 1.0f : 0.0f);
    dz2c[i] = Num<T>::from_f(dz2[i]);
  }
  __syncthreads();
  for (int i = tid; i < tile * H1; i += nt) {  // dz1 = (w1 dz2) * relu'
    const int r = i / H1, k = i - r * H1;
    float acc = 0.0f;
    for (int j = 0; j < H2; ++j)
      acc = madd(acc, Num<T>::to_f(pnet.w1[k * H2 + j]),
                 Num<T>::to_f(dz2c[r * H2 + j]));
    dz1[i] = __fmul_rn(acc, Num<T>::to_f(s_h1[i]) > 0.0f ? 1.0f : 0.0f);
    dz1c[i] = Num<T>::from_f(dz1[i]);
  }
  __syncthreads();

  // This block's partial sums over its lanes, in lane order.
  const Offsets o(d);
  float* out = work + static_cast<size_t>(blockIdx.x) * (o.P + 1);
  for (int i = tid; i <= o.P; i += nt) {
    float acc = 0.0f;
    if (i < o.b0) {                   // w0[ii][k]: x * dz1
      const int ii = i / H1, k = i - ii * H1;
      for (int r = 0; r < tile; ++r)
        acc = madd(acc, Num<T>::to_f(s_in[r * IN + ii]),
                   Num<T>::to_f(dz1c[r * H1 + k]));
    } else if (i < o.w1) {            // b0
      for (int r = 0; r < tile; ++r)
        acc = __fadd_rn(acc, dz1[r * H1 + (i - o.b0)]);
    } else if (i < o.b1) {            // w1[k][j]: h1 * dz2
      const int idx = i - o.w1, k = idx / H2, j = idx - k * H2;
      for (int r = 0; r < tile; ++r)
        acc = madd(acc, Num<T>::to_f(s_h1[r * H1 + k]),
                   Num<T>::to_f(dz2c[r * H2 + j]));
    } else if (i < o.w2) {            // b1
      for (int r = 0; r < tile; ++r)
        acc = __fadd_rn(acc, dz2[r * H2 + (i - o.b1)]);
    } else if (i < o.b2) {            // w2[j][a]: h2 * dq
      const int idx = i - o.w2, j = idx / A, a = idx - j * A;
      for (int r = 0; r < tile; ++r)
        acc = madd(acc, Num<T>::to_f(s_h2[r * H2 + j]),
                   Num<T>::to_f(dqc[r * A + a]));
    } else if (i < o.P) {             // b2
      for (int r = 0; r < tile; ++r)
        acc = __fadd_rn(acc, dq[r * A + (i - o.b2)]);
    } else {                          // squared TD error, for the loss
      for (int r = 0; r < tile; ++r) acc = __fadd_rn(acc, diff2[r]);
    }
    out[i] = acc;
  }
}

struct AdamCfg {
  int P, tiles, B, sync;
  AdamHyper h;
};

__global__ void adam_kernel(const float* __restrict__ work,
                            float* __restrict__ p, float* __restrict__ tp,
                            float* __restrict__ m, float* __restrict__ v,
                            __nv_bfloat16* __restrict__ pb,
                            __nv_bfloat16* __restrict__ tpb,
                            float* __restrict__ loss, AdamCfg c,
                            DevGate gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > c.P) return;
  if (gate.any_end != nullptr) {
    const int k = gate_count(gate);
    if (k < 0) return;
    c.sync = gate_syncs(gate, k) ? 1 : 0;
    c.h.c1 = gate.bias[2 * k];
    c.h.c2 = gate.bias[2 * k + 1];
  }
  const float g = sum_partials(work, c.tiles, c.P + 1, i);
  if (i == c.P) {
    *loss = __fdiv_rn(g, static_cast<float>(c.B));
    return;
  }
  if (c.sync) {  // the target sync comes before the update
    tp[i] = p[i];
    if (pb != nullptr) tpb[i] = pb[i];
  }
  const float pn = adam_step(g, p, m, v, i, c.h);
  if (pb != nullptr) pb[i] = __float2bfloat16_rn(pn);
}

template <typename T>
cudaError_t launch_act(const void* p, const void* opp, float* env,
                       float* ring, float* met, int tile, MlpDims d,
                       ActCfg ac, EnvCfg cfg, cudaStream_t stream) {
  size_t smem = static_cast<size_t>(tile) * (20 + 2 * d.a) * sizeof(float) +
                static_cast<size_t>(tile) * (d.in + d.h1 + d.h2) * sizeof(T);
  cudaError_t err = allow_smem(act_env_store_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (ac.n + tile - 1) / tile;
  act_env_store_kernel<T><<<blocks, kTrainThreads, smem, stream>>>(
      net_at<T>(p, d), net_at<T>(ac.opp ? opp : p, d), env, ring, met, tile,
      d, ac, cfg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_learn(const void* p, const void* tgt, const float* ring,
                         const int32_t* rounds, const int32_t* cols,
                         float* work, int B, int tile, MlpDims d, LearnCfg lc,
                         DevGate g, cudaStream_t stream) {
  size_t smem =
      static_cast<size_t>(tile) *
          (2 * d.in + 4 * d.a + d.h1 + d.h2 + 4) * sizeof(float) +
      static_cast<size_t>(tile) * (d.in + 2 * d.h1 + 2 * d.h2 + d.a) *
          sizeof(T);
  cudaError_t err = allow_smem(learn_partials_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  learn_partials_kernel<T><<<B / tile, kTrainThreads, smem, stream>>>(
      net_at<T>(p, d), net_at<T>(tgt, d), ring, rounds, cols, work, tile, d,
      lc, g);
  return cudaGetLastError();
}

}  // namespace mgt

extern "C" int mgt_dqn_act(const void* p, const void* opp, float* env,
                           float* ring, float* met, int n, int in, int h1,
                           int h2, int a, int tile, int bf16, int opp_net,
                           int greedy, int random_start, uint32_t step,
                           int r_cur, uint32_t threshold, uint32_t k0,
                           uint32_t k1, int max_steps, float r_first,
                           float r_second, float r_collision,
                           float vel_penalty, float time_penalty,
                           cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0) return 0;
  if (tile > kTrainThreads || in != 10)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims d{in, h1, h2, a};
  ActCfg ac{n, r_cur, opp_net, greedy, random_start, step, threshold, k0, k1};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  cudaError_t err =
      bf16 ? launch_act<__nv_bfloat16>(p, opp, env, ring, met, tile, d, ac,
                                       cfg, stream)
           : launch_act<float>(p, opp, env, ring, met, tile, d, ac, cfg,
                               stream);
  return static_cast<int>(err);
}

extern "C" int mgt_dqn_learn(const void* p, const void* tgt, const float* ring,
                             const int32_t* rounds, const int32_t* cols,
                             float* work, int n, int B, int K, int num_f,
                             int in, int h1, int h2, int a, int tile, int bf16,
                             int mask_terminal, float gamma, float two_over_b,
                             const int32_t* any_end, int step, int first_open,
                             int prior, int target_sync,
                             cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || K <= 0 || tile <= 0 || B % tile != 0 || tile > kTrainThreads
      || num_f < 2 * in + 3 || (any_end != nullptr && target_sync <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims d{in, h1, h2, a};
  LearnCfg lc{n, B / K, num_f, mask_terminal, gamma, two_over_b};
  DevGate g{any_end, nullptr, step, first_open, prior, target_sync};
  cudaError_t err =
      bf16 ? launch_learn<__nv_bfloat16>(p, tgt, ring, rounds, cols, work, B,
                                         tile, d, lc, g, stream)
           : launch_learn<float>(p, tgt, ring, rounds, cols, work, B, tile, d,
                                 lc, g, stream);
  return static_cast<int>(err);
}

extern "C" int mgt_dqn_adam(const float* work, float* p, float* tp, float* m,
                            float* v, void* pb, void* tpb, float* loss, int P,
                            int tiles, int B, int sync, float lr, float b1,
                            float b2, float omb1, float omb2, float eps,
                            float c1, float c2, const int32_t* any_end,
                            const float* bias, int step, int first_open,
                            int prior, int target_sync, cudaStream_t stream) {
  using namespace mgt;
  if (any_end != nullptr && (bias == nullptr || target_sync <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  AdamCfg c{P, tiles, B, sync, {lr, b1, b2, omb1, omb2, eps, c1, c2}};
  DevGate g{any_end, bias, step, first_open, prior, target_sync};
  const int threads = 256;
  adam_kernel<<<(P + threads) / threads, threads, 0, stream>>>(
      work, p, tp, m, v, static_cast<__nv_bfloat16*>(pb),
      static_cast<__nv_bfloat16*>(tpb), loss, c, g);
  return static_cast<int>(cudaGetLastError());
}
