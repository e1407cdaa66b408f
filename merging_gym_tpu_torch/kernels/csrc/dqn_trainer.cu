// K5: the whole Double-DQN trainer, one step as three kernels.
//
// Replaces merging_gym_tpu/ops/fused_trainer.py:_kernel (with its helpers
// learn_math, _fwd and _argmax0; entry fused_dqn_chunk).  On the TPU the
// T training steps of a chunk were the sequential grid of ONE launch, with
// every piece of state resident in VMEM.  Blocks of an H100 run in no
// order and carry nothing across a grid, and the learner reduces over the
// whole batch every step, so each step needs a reduction across blocks.
// The design is a per-step sequence of launches on one stream, issued by
// the host wrapper in a loop (ops/fused_trainer.py), with no read-back
// inside a chunk: the learn gate, the learn count, the target sync and
// Adam's bias corrections depend only on host counters and are passed as
// launch arguments.  (One cooperative launch per chunk with grid syncs was
// the alternative; it needs the whole grid resident at once, which caps
// envs and lanes per launch, and plain kernels are each easier to hold
// against the plain version.)
//
//   1. dqn_act_env_store: a block owns `rows` envs (sized from n and the SM
//      count, ops/fused_trainer.py:act_geometry: 8 envs in 128 blocks at
//      1,024).  Both seats' actors: the forwards on act_tiled.cuh's
//      register micro-tiles (the player's net held in shared memory for
//      the launch where it fits; in self-play one pass over both seats'
//      rows, a frozen opponent's net streamed in a second pass), then
//      argmax0 and the shared phi_select on the four Philox words at
//      (step, env, 0, 0); the env step of env_math.cuh, the [24] transition
//      slab stored into ring round r_cur (a lane whose ego has won keeps its
//      old row), the per-env metrics (win tested on the pre-step obs) and
//      the auto-reset.
//   2. learn_fwd_kernel (only on a learning step): a block owns `lanes` of
//      the B sampled lanes (sized from B and the SM count,
//      ops/fused_trainer.py:learn_geometry), gathered from the (round,
//      lane-window) draws: the target net's forward on x', the online
//      net's on x and x' together, the TD error and the hand-derived
//      backward of learn_math down to dz1, each lane's operands written to
//      a workspace row.
//   3. learn_grad_kernel (only on a learning step): every gradient entry
//      and the loss summed over the workspace's lanes in the plain
//      version's order, then, in the same thread, tp := p on a sync step
//      and Adam.
//
// A fully warm chunk (every step learns) runs as one CUDA graph of its
// 3 x T launches, captured once per chunk shape and replayed
// (ops/fused_trainer.py:ChunkGraph).  A graph's launch arguments are fixed,
// so what changes from chunk to chunk -- the Philox step and key, the
// ring's base round, the learn count and Adam's bias corrections, the
// learner's draws -- lies in a device-resident chunk header (ChunkHeader)
// that the host uploads before each replay; each launch reads it with its
// own constant step index i.  A null header pointer selects the launch
// arguments instead (the warm-up chunk, K7, direct launches).
//
// Every sum is one thread's chain in a fixed order, with one rounding per
// multiply and per add (-fmad=false): two runs on the same inputs give
// the same bits, and the plain version (fused_dqn_chunk_plain) sums in
// the same order, so the two agree bit for bit.  A forward output is
// summed in k order from 0; a gradient entry (and the loss) is, for each
// tile of `tile` lanes (ops/fused_trainer.py:learn_tile) in order, the
// tile's partial sum in lane order from 0, added into the total from 0.
// The tile fixes only that order: how many blocks run is the geometry's
// business.  Parameters are one flat f32 buffer per set, in the [in, out]
// layout of mlp.cuh: w0 [in][h1], b0 [h1], w1 [h1][h2], b1 [h2], w2
// [h2][a], b2 [a].  In bf16 the forward and backward operands are bf16
// copies of the masters (refreshed by learn_grad_kernel), products are
// exact in f32 and sums are f32; masters, gradients, the TD math and Adam
// stay f32.
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
// sampled lane, all f32 on the CUDA cores; the ring, the env rows, the
// 2.5 MB workspace and the parameters stay in L2, so the trainer is bound
// by operations, and without FMA (bit-equality) at most half of that
// bound is reachable.  Every forward is register-tiled (qnet_tiled.cuh):
// the act kernel's over 128 blocks at 1,024 envs, the learner's over 128
// blocks at B 1,024, and the learner's gradients are a register-tiled
// reduction over 133 blocks.  The measured times are in PERF.md
// (chip_smoke.py).
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "act_tiled.cuh"
#include "env_math.cuh"
#include "learn_math.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kNumF = 24;  // K5's ring fields per round: obs 10, next obs
                           // 10, action, reward, done, pad

// The chunk header of a graph replay; ops/fused_trainer.py:HEADER mirrors
// it.  Step i of the chunk draws at Philox step step0 + i (mod 2**32) under
// the key (k0, k1), stores into ring round (base + i) mod R, and learns with
// learn count prior + i: it syncs the target iff (prior + i) % target_sync
// == 0, and Adam's bias corrections for step prior + i + 1 are the floats
// 2 i and 2 i + 1 of the table that follows the header in its buffer.
struct ChunkHeader {
  uint32_t step0, k0, k1;
  int32_t base;
  int64_t prior;
};
static_assert(sizeof(ChunkHeader) == 24, "the header's layout is fixed");

// mlp.cuh's allow_smem once per (device, kernel) and larger size, not on
// every launch: a captured chunk then holds nothing but its launches.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> granted;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[{dev, reinterpret_cast<const void*>(kernel)}];
  if (have >= bytes) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) have = bytes;
  else cudaGetLastError();  // returned here, not left for the next launch
  return err;
}

struct ActCfg {
  int n, r_cur, opp, greedy, random_start;  // opp: kOppL0, kOppSelf, kOppFrozen
  uint32_t step, threshold, k0, k1;
  const ChunkHeader* hdr;  // non-null: step, r_cur, k0, k1 from it
  int i, rounds;           // with hdr: the step's index, the ring's rounds
};

// Kernel 1: a block owns `rows` envs, thread e < rows env env0 + e (its
// state in registers, its observation written straight into the input
// tile).  The player's forward runs on the block's rows (with the
// opponent's half-swapped rows in the same pass in self-play), a frozen
// opponent's in a second pass (act_tiled.cuh); then the picks, the env
// step, the ring store, the metrics and the auto-reset of each env.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 1)
act_env_store_kernel(Net<T> pnet, Net<T> onet, float* __restrict__ env,
                     float* __restrict__ ring, float* __restrict__ met,
                     ActGeom g, MlpDims d, ActCfg ac, EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (ac.hdr != nullptr) {  // a graph replay: this step's values
    ac.step = ac.hdr->step0 + static_cast<uint32_t>(ac.i);
    ac.r_cur = static_cast<int>((ac.hdr->base + ac.i) % ac.rounds);
    ac.k0 = ac.hdr->k0;
    ac.k1 = ac.hdr->k1;
  }
  const int seats = ac.opp == kOppSelf ? 2 : 1;
  const ActSmem S(&d, 1, g, sizeof(T), seats);
  T* const s_in = reinterpret_cast<T*>(smem + S.in);
  const float* const q = reinterpret_cast<const float*>(smem + S.q);
  const int st = act_stride(d.in);

  const int env0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, ac.n - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

  if (g.resident) {  // the player's net into shared memory, while the env
    stage_net(smem, NetSmem(d, sizeof(T)), d, pnet);  // rows load
    cp_async_commit();
  }
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
#pragma unroll
    for (int k = 0; k < 10; ++k) o[k] = pre[k];
    put_obs<0>(s_in + e * st, o);
    if (seats == 2) put_obs<5>(s_in + (rows + e) * st, o);
  }
  cp_async_wait_all();  // act_forward's first barrier publishes the net
  act_forward<T, RM, RN>(smem, S, g.chunk, d, pnet, g.resident ? 0 : -1,
                         seats * rows);
  int a1 = 0, a2 = -1;
  if (owner) {
    a1 = argmax0(q + e * d.a, d.a);
    if (seats == 2) a2 = argmax0(q + (rows + e) * d.a, d.a);
  }
  if (ac.opp == kOppFrozen) {
    if (owner) put_obs<5>(s_in + e * st, o);
    act_forward<T, RM, RN>(smem, S, g.chunk, d, onet, -1, rows);
    if (owner) a2 = argmax0(q + e * d.a, d.a);
  }
  if (!owner) return;

  if (!ac.greedy) {
    Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                   ac.k0, ac.k1);
    a1 = phi_select(a1, b.x, b.y, ac.threshold, d.a);
    if (ac.opp != kOppL0) a2 = phi_select(a2, b.z, b.w, ac.threshold, d.a);
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
  int n, W, num_f, mask_terminal, B;
  float gamma, two_over_b;
};

// The device-side learn gate of K7's upper learner.  It learns on step
// `step` iff any_end[step] != 0, and its learn count there is `prior` plus
// the number of steps j in [first_open, step) with any_end[j] != 0 (the
// host gate is open from first_open on).  bias[2k], bias[2k + 1] are Adam's
// bias corrections for count prior + k, computed on the host.  any_end ==
// nullptr: no device gate (K5, K7's lower learner); the host decides, or
// with `hdr` (K5's graph replay) the chunk header at step `step`: bias is
// then the header's table.
struct DevGate {
  const int32_t* any_end;
  const float* bias;
  int step, first_open, prior, target_sync;
  const ChunkHeader* hdr;
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

__device__ __forceinline__ bool header_syncs(const DevGate& g) {
  return (g.hdr->prior + g.step) % g.target_sync == 0;
}

// The learner's workspace: one row of f32 per sampled lane, written by
// learn_fwd_kernel and read by learn_grad_kernel.  Columns: x, h1 and h2
// (the T values of the online forward on x), dq with the squared TD error
// after it, dz2 and dz1 (f32), and in bf16 dq, dz2 and dz1 rounded to T
// (in f32 those columns are the f32 ones).  Every group starts on a
// multiple of 4 floats and the row is a multiple of 4 floats, so that
// learn_grad_kernel fetches 16 bytes at a time.
// ops/fused_trainer.py:workspace_width mirrors it.
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

struct WsCols {
  int x, h1, h2, dq, diff2, dz2, dz1, dqc, dz2c, dz1c, width;
  __host__ __device__ WsCols(MlpDims d, bool bf16) {
    x = 0;
    h1 = x + pad4(d.in);
    h2 = h1 + pad4(d.h1);
    dq = h2 + pad4(d.h2);
    diff2 = dq + d.a;
    dz2 = dq + pad4(d.a + 1);
    dz1 = dz2 + pad4(d.h2);
    width = dz1 + pad4(d.h1);
    dqc = dq;
    dz2c = dz2;
    dz1c = dz1;
    if (bf16) {
      dqc = width;
      dz2c = dqc + pad4(d.a);
      dz1c = dz2c + pad4(d.h2);
      width = dz1c + pad4(d.h1);
    }
  }
};

// Launch geometry of learn_fwd_kernel (ops/fused_trainer.py:learn_geometry):
// `lanes` sampled lanes per block, `chunk` elements of T in each weight
// buffer, `smem` bytes of shared memory per block.
struct LearnGeom {
  int lanes, chunk, smem;
};

// learn_fwd_kernel's shared memory: qnet_tiled.cuh's layout for 2 * lanes
// rows (the weight buffers; x, then x' of the block's lanes, and their h1
// and h2), then q of those rows, the target net's q of x', per lane the
// action, reward, done and squared TD error, dq and dq rounded to T (f32),
// and dz2 in T with h2's row stride (the input of the dz1 layer).
// ops/fused_trainer.py:learn_extra mirrors the part after QnetSmem.
struct LearnSmem {
  size_t q, qnt, lane, dq, dqc, dz2c, total;
  __host__ __device__ LearnSmem(MlpDims d, LearnGeom g, int elem) {
    const size_t L = static_cast<size_t>(g.lanes), A = d.a;
    q = QnetSmem(d, QnetGeom{2 * g.lanes, g.chunk, g.smem}, elem, 0).total;
    qnt = q + align16(2 * L * A * sizeof(float));
    lane = qnt + align16(L * A * sizeof(float));
    dq = lane + align16(L * 4 * sizeof(float));
    dqc = dq + align16(L * A * sizeof(float));
    dz2c = dqc + align16(L * A * sizeof(float));
    total = dz2c + L * act_stride(d.h2) * elem;
  }
};

template <typename T>
inline bool learn_geom_ok(MlpDims d, LearnGeom g) {
  return g.lanes > 0 && g.chunk > 0 && g.chunk * sizeof(T) % 16 == 0 &&
         LearnSmem(d, g, sizeof(T)).total <= static_cast<size_t>(g.smem);
}

// dz1 = (w1 dz2) * relu'(h1) of a lane, into the workspace: f32, and in
// bf16 also rounded to T.
template <typename T>
struct StoreDz1 {
  const T* s_h1;
  int st_h1;
  float* ws;  // the block's first row
  WsCols c;
  __device__ __forceinline__ void sum(int r, int k, float acc) {
    const float v = __fmul_rn(
        acc, Num<T>::to_f(s_h1[r * st_h1 + k]) > 0.0f ? 1.0f : 0.0f);
    float* row = ws + static_cast<size_t>(r) * c.width;
    row[c.dz1 + k] = v;
    if (c.dz1c != c.dz1) row[c.dz1c + k] = Num<T>::to_f(Num<T>::from_f(v));
  }
};

// Kernel A of the learner: a block owns `lanes` of the B sampled lanes.
// It gathers them from the ring, runs the target net on x' and the online
// net on x and x' together (qnet_layers of qnet_tiled.cuh: register
// micro-tiles of in-order chains, weights streamed through shared memory),
// the Double-DQN TD error, dq, dz2 = (w2 dq) * relu'(h2) (a few actions
// deep, one output per thread) and dz1 = (w1 dz2) * relu'(h1) as one more
// tiled layer over w1t, the online w1 transposed ([h2][h1], kept by
// learn_grad_kernel), and writes each lane's workspace row.
template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads)
learn_fwd_kernel(Net<T> pnet, Net<T> tnet, const T* __restrict__ w1t,
                 const float* __restrict__ ring,
                 const int32_t* __restrict__ rounds,
                 const int32_t* __restrict__ cols, float* __restrict__ ws,
                 MlpDims d, LearnCfg lc, LearnGeom lg, DevGate g) {
  if (g.any_end != nullptr) {  // the same decision in every thread
    const int k = gate_count(g);
    if (k < 0) return;
    if (gate_syncs(g, k)) tnet = pnet;  // the sync comes before the update
  } else if (g.hdr != nullptr && header_syncs(g)) {
    tnet = pnet;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const QnetSmem S(d, QnetGeom{2 * lg.lanes, lg.chunk, lg.smem}, sizeof(T),
                   0);
  const LearnSmem X(d, lg, sizeof(T));
  T* const wbuf = reinterpret_cast<T*>(smem);
  T* const s_in = reinterpret_cast<T*>(smem + S.in);
  T* const s_h1 = reinterpret_cast<T*>(smem + S.h1);
  T* const s_h2 = reinterpret_cast<T*>(smem + S.h2);
  float* const s_q = reinterpret_cast<float*>(smem + X.q);
  float* const s_qnt = reinterpret_cast<float*>(smem + X.qnt);
  float* const s_lane = reinterpret_cast<float*>(smem + X.lane);
  float* const s_dq = reinterpret_cast<float*>(smem + X.dq);
  float* const s_dqc = reinterpret_cast<float*>(smem + X.dqc);
  T* const s_dz2c = reinterpret_cast<T*>(smem + X.dz2c);
  const int A = d.a, H1 = d.h1, H2 = d.h2, IN = d.in;
  const int st_in = act_stride(IN), st_h1 = act_stride(H1),
            st_h2 = act_stride(H2);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * lg.lanes;
  const int rows = min(lg.lanes, lc.B - b0);
  const size_t sN = static_cast<size_t>(lc.n);
  const WsCols c(d, sizeof(T) == 2);
  float* const wsb = ws + static_cast<size_t>(b0) * c.width;

  // Gather the block's lanes: lane b of the batch is column b % W of draw
  // k = b / W, i.e. ring round rounds[k], env cols[k] * W + b % W.  Rows
  // 0..rows-1 of s_in take x, rows rows..2 rows-1 take x'.  The fields
  // past done (padding) are not read.
  auto gather = [&]() {
    for (int i = tid; i < (2 * IN + 3) * rows; i += nt) {
      const int f = i / rows, r = i - f * rows, b = b0 + r;
      const int k = b / lc.W;
      const int src = cols[k] * lc.W + (b - k * lc.W);
      const float val =
          ring[(static_cast<size_t>(rounds[k]) * lc.num_f + f) * sN + src];
      if (f < IN) s_in[r * st_in + f] = Num<T>::from_f(val);
      else if (f < 2 * IN)
        s_in[(rows + r) * st_in + f - IN] = Num<T>::from_f(val);
      else s_lane[r * 4 + f - 2 * IN] = val;  // action, reward, done
    }
  };
  auto none = []() {};
  StoreRows to_qnt{s_qnt, A}, to_q{s_q, A};
  qnet_layers<T, RM, RN>(d, tnet, lg.chunk, wbuf, s_in + rows * st_in, s_h1,
                         s_h2, rows, gather, to_qnt);
  // Last, so that rows 0..rows-1 of s_in, s_h1 and s_h2 keep x's layers.
  qnet_layers<T, RM, RN>(d, pnet, lg.chunk, wbuf, s_in, s_h1, s_h2,
                         2 * rows, none, to_q);

  if (tid < rows) {  // Double-DQN target and TD error of one lane
    const int r = tid;
    const float* lane = s_lane + r * 4;
    const int ai = static_cast<int>(lane[0]);
    float boot = s_qnt[r * A + argmax0(s_q + (rows + r) * A, A)];
    if (lc.mask_terminal) boot = __fmul_rn(boot, __fsub_rn(1.0f, lane[2]));
    const float target = __fadd_rn(lane[1], __fmul_rn(lc.gamma, boot));
    const float diff = __fsub_rn(s_q[r * A + ai], target);
    s_lane[r * 4 + 3] = __fmul_rn(diff, diff);
    const float gr = __fmul_rn(lc.two_over_b, diff);
    for (int j = 0; j < A; ++j) {
      const float v = __fmul_rn(j == ai ? 1.0f : 0.0f, gr);
      s_dq[r * A + j] = v;
      s_dqc[r * A + j] = Num<T>::to_f(Num<T>::from_f(v));
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * H2; i += nt) {  // dz2 = (w2 dq) * relu'(h2)
    const int r = i / H2, j = i - r * H2;
    float acc = 0.0f;
    for (int a = 0; a < A; ++a)
      acc = madd(acc, Num<T>::to_f(pnet.w2[j * A + a]), s_dqc[r * A + a]);
    const float v = __fmul_rn(
        acc, Num<T>::to_f(s_h2[r * st_h2 + j]) > 0.0f ? 1.0f : 0.0f);
    s_dz2c[r * st_h2 + j] = Num<T>::from_f(v);
    float* row = wsb + static_cast<size_t>(r) * c.width;
    row[c.dz2 + j] = v;
    if (c.dz2c != c.dz2) row[c.dz2c + j] = Num<T>::to_f(Num<T>::from_f(v));
  }
  // The rest of each lane's row: x, h1, h2, dq (and rounded), diff^2.
  const int head = IN + H1 + H2;
  for (int i = tid; i < rows * head; i += nt) {
    const int r = i / head, f = i - r * head;
    float* row = wsb + static_cast<size_t>(r) * c.width;
    if (f < IN) row[c.x + f] = Num<T>::to_f(s_in[r * st_in + f]);
    else if (f < IN + H1)
      row[c.h1 + f - IN] = Num<T>::to_f(s_h1[r * st_h1 + f - IN]);
    else
      row[c.h2 + f - IN - H1] = Num<T>::to_f(s_h2[r * st_h2 + f - IN - H1]);
  }
  for (int i = tid; i < rows * A; i += nt) {
    const int r = i / A, j = i - r * A;
    float* row = wsb + static_cast<size_t>(r) * c.width;
    row[c.dq + j] = s_dq[i];
    if (c.dqc != c.dq) row[c.dqc + j] = s_dqc[i];
    if (j == 0) row[c.diff2] = s_lane[r * 4 + 3];
  }
  // dz1 = (w1 dz2) * relu'(h1): sums over j of w1[k][j] dz2[j], in j order.
  StoreDz1<T> to_dz1{s_h1, st_h1, wsb, c};
  layer_sums<T, RM, RN>(w1t, H2, H1, lg.chunk, wbuf, s_dz2c, st_h2, rows,
                        to_dz1);
}

// Kernel B of the learner: every gradient entry (and the loss) as a sum
// over the B lanes of the workspace, in the plain version's order -- for
// each tile of `tile` lanes in order, the tile's partial sum in lane order
// from 0, added into the total from 0 -- then Adam on it.  A block owns a
// kGradK x kGradJ rectangle of one gradient; each thread a 4 x 4
// micro-tile of it (register tile accumulators) for one tile of lanes out
// of kGradGroups in flight; the groups' partials pass through shared memory
// and one thread per entry adds them into its total in tile order.  Lane
// chunks of the rectangle's columns are staged with cp.async, one round
// ahead.
constexpr int kGradThreads = 256;
constexpr int kGradK = 16, kGradJ = 16, kGradGroups = 16;
constexpr int kGradEntries = kGradK * kGradJ;  // = kGradThreads

// One gradient: sum over lanes of ws[h + k] * ws[d + j] for k < K, j < J
// (h < 0: a bias, the factor 1), into parameter out + k J + j.  The last
// job is b2 with the loss beside it: its column a (the squared TD error)
// goes to the loss.
struct GradJob {
  int h, K, d, J, out;
};

__device__ __forceinline__ int grad_rects(const GradJob& j) {
  return (j.K + kGradK - 1) / kGradK * ((j.J + kGradJ - 1) / kGradJ);
}

// Shared memory of learn_grad_kernel for summation tiles of `tile` lanes
// (ops/fused_trainer.py:grad_smem mirrors it).
__host__ __device__ inline size_t grad_smem(int tile) {
  return (2 * 2 * static_cast<size_t>(kGradGroups) * tile * 16 +
          static_cast<size_t>(kGradGroups) * kGradEntries) * sizeof(float);
}

struct GradCfg {
  int B, tile, sync;
  AdamHyper h;
};

__global__ void __launch_bounds__(kGradThreads)
learn_grad_kernel(const float* __restrict__ ws, int width,
                  float* __restrict__ p,
                  float* __restrict__ tp, float* __restrict__ m,
                  float* __restrict__ v, __nv_bfloat16* __restrict__ pb,
                  __nv_bfloat16* __restrict__ tpb, void* __restrict__ w1t,
                  float* __restrict__ loss, MlpDims d, GradCfg gc,
                  DevGate gate) {
  if (gate.any_end != nullptr) {
    const int k = gate_count(gate);
    if (k < 0) return;
    gc.sync = gate_syncs(gate, k) ? 1 : 0;
    gc.h.c1 = gate.bias[2 * k];
    gc.h.c2 = gate.bias[2 * k + 1];
  } else if (gate.hdr != nullptr) {
    gc.sync = header_syncs(gate) ? 1 : 0;
    gc.h.c1 = gate.bias[2 * gate.step];
    gc.h.c2 = gate.bias[2 * gate.step + 1];
  }
  const bool bf16 = pb != nullptr;
  const WsCols c(d, bf16);
  const Offsets o(d);
  const GradJob jobs[6] = {
      {c.x, d.in, c.dz1c, d.h1, o.w0}, {-1, 1, c.dz1, d.h1, o.b0},
      {c.h1, d.h1, c.dz2c, d.h2, o.w1}, {-1, 1, c.dz2, d.h2, o.b1},
      {c.h2, d.h2, c.dqc, d.a, o.w2},   {-1, 1, c.dq, d.a + 1, o.b2}};
  int rect = blockIdx.x, ji = 0;
  while (ji < 5 && rect >= grad_rects(jobs[ji]))
    rect -= grad_rects(jobs[ji++]);
  const GradJob job = jobs[ji];
  const int njb = (job.J + kGradJ - 1) / kGradJ;
  const int k0 = rect / njb * kGradK, j0 = rect % njb * kGradJ;

  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = kGradGroups * gc.tile;  // per round
  float* const s_buf = reinterpret_cast<float*>(smem);  // 2 x [h | d]
  float* const s_part = s_buf + 2 * 2 * lanes * 16;     // [group][entry]
  const int tid = threadIdx.x;
  const int ntiles = gc.B / gc.tile;
  const int nrounds = (ntiles + kGradGroups - 1) / kGradGroups;

  // Round q's lanes [q * lanes, ...): h columns k0.. and d columns j0..
  // into buffer q & 1, [lane][16] each (h = 1 for a bias), 16 bytes a
  // copy; a copy that starts inside its column group stays inside its
  // padding.
  auto fetch = [&](int q) {
    float* sh = s_buf + (q & 1) * 2 * lanes * 16;
    float* sd = sh + lanes * 16;
    const int lb = q * lanes;
    for (int i = tid; i < lanes * 8; i += kGradThreads) {
      const int l = i >> 3, u = 4 * (i & 3), b = lb + l;
      if (b >= gc.B) continue;
      const float* row = ws + static_cast<size_t>(b) * width;
      if (i & 4) {
        if (j0 + u < job.J)
          cp_async16(sd + l * 16 + u, row + job.d + j0 + u);
      } else if (job.h < 0) {
        *reinterpret_cast<float4*>(sh + l * 16 + u) =
            make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      } else if (k0 + u < job.K) {
        cp_async16(sh + l * 16 + u, row + job.h + k0 + u);
      }
    }
  };

  const int grp = tid / 16, mk = (tid & 15) >> 2, mj = tid & 3;
  float total = 0.0f;  // entry tid of the rectangle: (tid / 16, tid % 16)
  fetch(0);
  cp_async_commit();
  for (int q = 0; q < nrounds; ++q) {
    if (q + 1 < nrounds) fetch(q + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int t = q * kGradGroups + grp;
    if (t < ntiles) {
      const float* sh = s_buf + (q & 1) * 2 * lanes * 16 + grp * gc.tile * 16;
      const float* sd = sh + lanes * 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[i][cc] = 0.0f;
      for (int r = 0; r < gc.tile; ++r) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(sh + r * 16 + 4 * mk);
        const float4 d4 =
            *reinterpret_cast<const float4*>(sd + r * 16 + 4 * mj);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[i][cc] = __fadd_rn(acc[i][cc], __fmul_rn(hv[i], dv[cc]));
      }
      float* part = s_part + grp * kGradEntries;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          part[(4 * mk + i) * kGradJ + 4 * mj + cc] = acc[i][cc];
    }
    __syncthreads();
    for (int gi = 0; gi < kGradGroups && q * kGradGroups + gi < ntiles; ++gi)
      total = __fadd_rn(total, s_part[gi * kGradEntries + tid]);
  }

  const int k = k0 + tid / kGradJ, j = j0 + tid % kGradJ;
  if (k >= job.K || j >= job.J) return;
  if (ji == 5 && j == d.a) {  // the loss
    *loss = __fdiv_rn(total, static_cast<float>(gc.B));
    return;
  }
  const int i = job.out + k * job.J + j;
  if (gc.sync) {  // the target sync comes before the update
    tp[i] = p[i];
    if (bf16) tpb[i] = pb[i];
  }
  const float pn = adam_step(total, p, m, v, i, gc.h);
  if (bf16) pb[i] = __float2bfloat16_rn(pn);
  if (ji == 2) {  // w1[k][j] -> w1t[j][k]
    const size_t t = static_cast<size_t>(j) * d.h1 + k;
    if (bf16) static_cast<__nv_bfloat16*>(w1t)[t] = __float2bfloat16_rn(pn);
    else static_cast<float*>(w1t)[t] = pn;
  }
}

template <typename T, int RM, int RN>
cudaError_t launch_act_tile(Net<T> p, Net<T> o, float* env, float* ring,
                            float* met, ActGeom g, MlpDims d, ActCfg ac,
                            EnvCfg cfg, cudaStream_t stream) {
  cudaError_t err = allow_smem_once(act_env_store_kernel<T, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (ac.n + g.rows - 1) / g.rows;
  act_env_store_kernel<T, RM, RN><<<blocks, kQnetThreads, g.smem, stream>>>(
      p, o, env, ring, met, g, d, ac, cfg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(const void* p, const void* opp, float* env,
                       float* ring, float* met, ActGeom g, int rm, int rn,
                       MlpDims d, ActCfg ac, EnvCfg cfg, cudaStream_t stream) {
  if (!act_geom_ok<T>(&d, 1, g, ac.opp == kOppSelf ? 2 : 1,
                      ac.opp == kOppFrozen || g.resident < 1))
    return cudaErrorInvalidValue;
  const Net<T> pn = net_at<T>(p, d);
  const Net<T> on = net_at<T>(ac.opp == kOppFrozen ? opp : p, d);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                       \
  case M * 16 + N:                                                           \
    return launch_act_tile<T, M, N>(pn, on, env, ring, met, g, d, ac, cfg,   \
                                    stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int RM, int RN>
cudaError_t launch_fwd_tile(Net<T> pnet, Net<T> tnet, const T* w1t,
                            const float* ring, const int32_t* rounds,
                            const int32_t* cols, float* ws, MlpDims d,
                            LearnCfg lc, LearnGeom lg, DevGate g,
                            cudaStream_t stream) {
  cudaError_t err = allow_smem_once(learn_fwd_kernel<T, RM, RN>, lg.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (lc.B + lg.lanes - 1) / lg.lanes;
  learn_fwd_kernel<T, RM, RN><<<blocks, kQnetThreads, lg.smem, stream>>>(
      pnet, tnet, w1t, ring, rounds, cols, ws, d, lc, lg, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* p, const void* tgt, const void* w1t,
                       const float* ring, const int32_t* rounds,
                       const int32_t* cols, float* ws, MlpDims d, LearnCfg lc,
                       LearnGeom lg, int rm, int rn, DevGate g,
                       cudaStream_t stream) {
  if (!learn_geom_ok<T>(d, lg)) return cudaErrorInvalidValue;
  const Net<T> pnet = net_at<T>(p, d), tnet = net_at<T>(tgt, d);
  const T* wt = static_cast<const T*>(w1t);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                       \
  case M * 16 + N:                                                           \
    return launch_fwd_tile<T, M, N>(pnet, tnet, wt, ring, rounds, cols, ws,  \
                                    d, lc, lg, g, stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mgt

// Kernel 1 of a step (act_env_store_kernel) on `n` envs in the geometry
// (rows, rm x rn, resident, chunk, smem) of ops/fused_trainer.py:
// act_geometry; opp: kOppL0, kOppSelf (opp unused) or kOppFrozen.  With a
// chunk header `hdr` (a ChunkHeader on the device), step, r_cur, k0 and k1
// are read from it for step i of a ring of `rounds` rounds.  A geometry its
// layout does not fit is refused (cudaErrorInvalidValue).
extern "C" int mgt_dqn_act(const void* p, const void* opp, float* env,
                           float* ring, float* met, int n, int in, int h1,
                           int h2, int a, int rows, int rm, int rn,
                           int resident, int chunk, int smem, int bf16,
                           int opp_mode, int greedy, int random_start,
                           uint32_t step, int r_cur, uint32_t threshold,
                           uint32_t k0, uint32_t k1, int max_steps,
                           float r_first, float r_second, float r_collision,
                           float vel_penalty, float time_penalty,
                           const void* hdr, int i, int rounds,
                           cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0) return 0;
  if (in != 10 || opp_mode < kOppL0 || opp_mode > kOppFrozen ||
      (hdr != nullptr && (i < 0 || rounds <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims d{in, h1, h2, a};
  ActGeom g{rows, resident, chunk, smem};
  ActCfg ac{n, r_cur, opp_mode, greedy, random_start, step, threshold, k0,
            k1, static_cast<const ChunkHeader*>(hdr), i, rounds};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  cudaError_t err =
      bf16 ? launch_act<__nv_bfloat16>(p, opp, env, ring, met, g, rm, rn, d,
                                       ac, cfg, stream)
           : launch_act<float>(p, opp, env, ring, met, g, rm, rn, d, ac, cfg,
                               stream);
  return static_cast<int>(err);
}

// Kernel A of one learn (learn_fwd_kernel); `ws` holds B rows of
// WsCols(d).width floats, `w1t` the online w1 transposed, in T.  With a
// chunk header `hdr`, `tgt` is the target net and the header decides at
// step `step` whether p takes its place.
extern "C" int mgt_dqn_learn_fwd(const void* p, const void* tgt,
                                 const void* w1t, const float* ring,
                                 const int32_t* rounds, const int32_t* cols,
                                 float* ws, int n, int B, int K, int num_f,
                                 int in, int h1, int h2, int a, int bf16,
                                 int mask_terminal, float gamma,
                                 float two_over_b, int lanes, int rm, int rn,
                                 int chunk, int smem, const int32_t* any_end,
                                 int step, int first_open, int prior,
                                 int target_sync, const void* hdr,
                                 cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || K <= 0 || B % K != 0 || num_f < 2 * in + 3 ||
      (any_end != nullptr && target_sync <= 0) ||
      (hdr != nullptr && (any_end != nullptr || target_sync <= 0 || step < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims d{in, h1, h2, a};
  LearnCfg lc{n, B / K, num_f, mask_terminal, B, gamma, two_over_b};
  LearnGeom lg{lanes, chunk, smem};
  DevGate g{any_end, nullptr, step, first_open, prior, target_sync,
            static_cast<const ChunkHeader*>(hdr)};
  cudaError_t err =
      bf16 ? launch_fwd<__nv_bfloat16>(p, tgt, w1t, ring, rounds, cols, ws, d,
                                       lc, lg, rm, rn, g, stream)
           : launch_fwd<float>(p, tgt, w1t, ring, rounds, cols, ws, d, lc, lg,
                               rm, rn, g, stream);
  return static_cast<int>(err);
}

// Kernel B of one learn (learn_grad_kernel): the gradients and the loss
// from `ws`, summed in tiles of `tile` lanes, then Adam (the target sync
// first on a sync step), the bf16 copies pb/tpb (nullptr in f32) and w1t.
// With a chunk header `hdr`, the sync and c1, c2 (from `bias`, the
// header's table) are those of step `step`.
extern "C" int mgt_dqn_learn_grad(const float* ws, float* p, float* tp,
                                  float* m, float* v, void* pb, void* tpb,
                                  void* w1t, float* loss, int in, int h1,
                                  int h2, int a, int B, int tile, int sync,
                                  float lr, float b1, float b2, float omb1,
                                  float omb2, float eps, float c1, float c2,
                                  int smem, const int32_t* any_end,
                                  const float* bias, int step, int first_open,
                                  int prior, int target_sync, const void* hdr,
                                  cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || tile <= 0 || tile > 16 || B % tile != 0 ||
      grad_smem(tile) > static_cast<size_t>(smem) ||
      ((any_end != nullptr || hdr != nullptr) &&
       (bias == nullptr || target_sync <= 0)) ||
      (hdr != nullptr && (any_end != nullptr || step < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims d{in, h1, h2, a};
  GradCfg gc{B, tile, sync, {lr, b1, b2, omb1, omb2, eps, c1, c2}};
  DevGate g{any_end, bias, step, first_open, prior, target_sync,
            static_cast<const ChunkHeader*>(hdr)};
  const WsCols c(d, pb != nullptr);
  int blocks = 0;
  const int kj[3][2] = {{in, h1}, {h1, h2}, {h2, a}};
  for (const auto& w : kj)
    blocks += (w[0] + kGradK - 1) / kGradK * ((w[1] + kGradJ - 1) / kGradJ) +
              (w[1] + kGradJ - 1) / kGradJ;
  blocks += (a + 1 + kGradJ - 1) / kGradJ - (a + kGradJ - 1) / kGradJ;
  cudaError_t err = allow_smem_once(learn_grad_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  learn_grad_kernel<<<blocks, kGradThreads, smem, stream>>>(
      ws, c.width, p, tp, m, v, static_cast<__nv_bfloat16*>(pb),
      static_cast<__nv_bfloat16*>(tpb), w1t, loss, d, gc, g);
  return static_cast<int>(cudaGetLastError());
}
