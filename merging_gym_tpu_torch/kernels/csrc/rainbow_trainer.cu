// K8: the whole Rainbow (C51 + NoisyNet + Dueling) trainer, one step as a
// short sequence of kernels.
//
// Replaces merging_gym_tpu/ops/fused_rainbow.py:_kernel, both of its call
// forms (_call, the VMEM ring, and _call_hbm, the HBM ring: on the card the
// ring always lives in device memory), with its helpers _rb_fwd, _rb_q,
// _projection, rainbow_learn_math, nstep_batch_from_slabs, per_pick,
// per_gather_slabs and _fresh_eps.  On the TPU a chunk of T steps was the
// sequential grid of one launch with all state in VMEM, and the learner
// reduced over every lane on every step.  Blocks of an H100 run in no order
// and carry nothing across a grid, so a step is a sequence on one stream,
// issued by ops/fused_rainbow.py with no read-back inside a chunk (K5's
// design, dqn_trainer.cu):
//
//   1. rb_act (rb_act_kernel): a block owns `rows` envs, sized on the host
//      from the env count and the SM count (ops/fused_rainbow.py:
//      act_geometry: 8 envs in 128 blocks at 1,024).  The noisy dueling
//      C51 forward of the ego's scaled obs (the trunk and the four noisy
//      layers read as effective weights, each layer one register-tiled
//      pass of qnet_tiled.cuh on the online net held in shared memory; the
//      dueling combine, a softmax per action, E[Z]), the first-occurrence
//      argmax, the optional Phi(eps) pick; the opponent: the same net on
//      the left-rotated obs in the same passes, L0, or a frozen MLP
//      (act_tiled.cuh, streamed) through the Phi(0.7) pick; the env step
//      (env_math.cuh);
//      the unconditional [24] slab store (with PER its row 23 is
//      maxp ** alpha, maxp read before this step's learn); the metrics, the
//      per-lane episode count (env row 12), the step's finished episodes
//      added to ep_step (integer atomics: the total does not depend on the
//      order) and the auto-reset.
//   2. rb_per_pick (PER only, one block of 512 threads): the masked
//      priority grid staged in shared memory (a global workspace for a
//      grid too large, ops/fused_rainbow.py:pick_geometry) with 16-byte
//      loads, 128-lane chunk sums in lane order, their prefix in chunk
//      order, the B stratified targets, the inverse-CDF pick by one binary
//      search over the whole cdf (searchsorted(side='right'), clipped), the
//      importance weights.
//   3. rb_learn_fwd (learn_fwd_kernel): a block owns `lanes` of the B
//      sampled lanes, sized on the host from B and the SM count
//      (ops/fused_rainbow.py:learn_geometry).  The n-step reconstruction
//      from consecutive slabs, the target net's forward on the bootstrap
//      obs (selection and evaluation), the hat-form projection with the
//      faithful mask floor(b) != ceil(b), the online forward (its dueling
//      combine and softmax for the sampled action only), the CE on the
//      clamped selected-action distribution, and the hand backprop through
//      the clamp (strict-inequality mask), the softmax, the dueling
//      combine, the four noisy layers and the trunk.  Each lane writes its
//      row factors to a workspace and its CE to `ce` (for PER).
//   4. rb_learn_grad (learn_grad_kernel): every trunk and mu gradient
//      entry and the weighted CE summed over the workspace's lanes in the
//      plain version's order, then, in the same thread, Adam on that
//      parameter and on its sigma with the gradient dW * eps (bias
//      corrections from the host, as in K5).
//   5. rb_post, every step, one block a tile of one [in][out] matrix
//      (ops/fused_rainbow.py:post_geometry: 16 x 32 entries): fresh
//      factorised noise for both nets (after a learn, outside greedy mode),
//      each factor and bias entry drawn once a tile, the episodic target
//      sync decided from ep_step once a block (tp := p when
//      floor(total * (1 / sync_eps)) passes the synced count, env row 11),
//      the effective weights mu + sigma * eps of both nets, the transposes
//      of the online net's effective weights and of its w1 (the next
//      learn's backward) through shared memory; and in one more block, with
//      PER, the priority write-back max(ce + 1e-5, 1e-8) ** alpha at the
//      sampled slots (duplicates of a slot share one ce, so any write order
//      gives the same bits) and the running max (env row 13), reduced once.
//
// Every sum is one thread's chain in a fixed order, with one rounding per
// multiply and per add (-fmad=false), and expf/logf/sqrtf/cosf are the
// accurate library functions; x ** a is expf(a * logf(max(x, 1e-30))).  A
// forward or backward output is summed in index order from 0; a gradient
// entry (and the loss) is, for each tile of learn_tile(B) lanes in order,
// the tile's sum in lane order from 0, added into the total from 0.  Two
// runs on the same inputs give the same bits, and the plain version
// (ops/fused_rainbow.py:fused_rainbow_chunk_plain) repeats every order.
//
// Layouts (ops/fused_rainbow.py): a parameter set is one flat f32 buffer,
// linear1 w [10][32], b; linear2 w [32][64], b; then per noisy layer
// (value1 64->64, value2 64->51, advantage1 64->64, advantage2 64->255)
// w_mu [in][out], w_sigma, b_mu, b_sigma.  Noise, effective weights and the
// noisy part of the gradient share the element layout: per noisy layer
// w [in][out], then b.
//
// Bound on an H100: per step one or two actor forwards per env (~60,000
// operations each) and on a learning step two forwards and a backward
// (~250,000 operations) per sampled lane, all f32 on the CUDA cores; the
// ring, env rows and the parameter sets are a few MB, so K8 is bound by
// operations, and without FMA (bit-equality) at most half of that bound
// is reachable.  What held the learner back, and what its design does:
// the old learner ran B / 16 blocks (64 at B 1,024 on 132 SMs), every
// output a scalar chain over weights read from global memory and never
// reused across rows, about 20 barrier-separated phases with most threads
// idle, then ~120 partial sums a thread into a 7.85 MB buffer that a
// second kernel added up, one thread a parameter.  Now a block owns at
// most 8 lanes (128 blocks at B 1,024); each of the learn's 17 layers
// (both forwards, and the backward over the transposed weights that
// rb_post forms) is one register-tiled pass of qnet_tiled.cuh
// (staged_sums: micro-tiles of in-order chains) with its weights brought
// whole into one of two shared buffers two layers ahead (cp.async); the
// chains the plain version keeps sequential (softmax sums, E[Z], the
// projection, the CE) are one thread's each, per (lane, action) or per
// lane; and the gradients are summed by rectangles of 16 x 8 entries with
// up to every summation tile of the batch in flight, Adam fused, from a
// workspace of 784 floats a lane (3.2 MB at B 1,024).  The act kernel
// held it back as well: 64 blocks of 16 envs on 132 SMs, each output one
// thread's scalar chain over weights read from L2 inside the k loop, seven
// barrier-separated phases, the whole forward run twice in self-play.  Now
// a block owns 8 envs (128 blocks at 1,024); the online net (122,696 B) is
// copied into shared memory once a launch, while the env rows load and the
// first layers run; each layer is one staged_sums pass of RM x RN
// micro-tiles (both seats' rows in one pass in self-play); the head's
// elementwise steps run one thread an element and only its ordered chains
// one thread a (row, action).  The measured times are in PERF.md
// (chip_smoke.py).
#include <cstdint>

#include "act_tiled.cuh"
#include "env_math.cuh"
#include "learn_math.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kRbThreads = 256;
constexpr int kA = 5;
constexpr int kAtoms = 51;
constexpr int kIn = 10;
constexpr int kH0 = 32;
constexpr int kH1 = 64;
constexpr int kRbNumF = 24;
constexpr int kTrunkP = kIn * kH0 + kH0 + kH0 * kH1 + kH1;  // 2,464
// Outputs, element offsets and parameter offsets of the four noisy layers
// (functions: a constexpr array indexed at run time is not device code).
__host__ __device__ constexpr int out_of(int l) {
  return l == 0 ? kH1 : l == 1 ? kAtoms : l == 2 ? kH1 : kA * kAtoms;
}
__host__ __device__ constexpr int eoff(int l) {
  return l == 0 ? 0 : eoff(l - 1) + (kH1 + 1) * out_of(l - 1);
}
__host__ __device__ constexpr int poff(int l) {
  return l == 0 ? kTrunkP : poff(l - 1) + 2 * (kH1 + 1) * out_of(l - 1);
}
constexpr int kNumE = eoff(4);   // 28,210
constexpr int kNumP = poff(4);   // 58,884
constexpr int kNumG = kTrunkP + kNumE;  // 30,674
static_assert(kNumE == 28210 && kNumP == 58884, "K8 layout");
constexpr uint32_t kStreamFrozen = kStreamOpponent;
constexpr uint32_t kStreamNoise = 8;

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }
__device__ __forceinline__ float mask(float h) { return h > 0.0f ? 1.0f : 0.0f; }
__device__ __forceinline__ float powx(float x, float e) {
  return expf(fmul(e, logf(fmaxf(x, 1e-30f))));
}
// The support V_MIN + DELTA_Z * i, two roundings (fused_rainbow.py:137-140).
__device__ __forceinline__ float zsup(int i) {
  return fadd(-10.0f, fmul(0.4f, static_cast<float>(i)));
}

// One net as the kernels read it: the trunk from the parameter buffer, the
// noisy layers from the effective-weight buffer.
struct RbNet {
  const float *w0, *b0, *w1, *b1;
  const float* W[4];
  const float* B[4];
};

__host__ __device__ inline RbNet rb_net(const float* p, const float* weff) {
  RbNet n;
  n.w0 = p;
  n.b0 = p + kIn * kH0;
  n.w1 = n.b0 + kH0;
  n.b1 = n.w1 + kH0 * kH1;
  for (int l = 0; l < 4; ++l) {
    n.W[l] = weff + eoff(l);
    n.B[l] = weff + eoff(l) + kH1 * out_of(l);
  }
  return n;
}

// The dueling logit of action a at atom j: (zv[j] + adv[a][j]) - mean,
// the mean being the sum of adv[.][j] over the actions in order times 0.2.
__device__ __forceinline__ float duel_logit(const float* adv, const float* zv,
                                            int a, int j) {
  float mean = 0.0f;
  for (int b = 0; b < kA; ++b) mean = fadd(mean, adv[b * kAtoms + j]);
  mean = fmul(mean, 0.2f);
  return __fsub_rn(fadd(zv[j], adv[a * kAtoms + j]), mean);
}

// Row strides of the forwards' shared arrays (act kernel and learner), each
// a multiple of 4 floats (16-byte rows for load4): the scaled obs, h1, the
// 64-wide hidden layers, value2's 51 atoms, advantage2's 5 x 51, and a
// distribution's 51 atoms with its column 51 (atom_max, atom_sum).
constexpr int kSx = 16, kSh1 = 36, kSh = 68, kSv = 56, kSa = 260, kS51 = 52;

// d[51] := the largest of d[0..50] (first occurrence), or their sum in
// order from 0.
__device__ __forceinline__ void atom_max(float* d) {
  float lm = d[0];
  for (int j = 1; j < kAtoms; ++j)
    if (d[j] > lm) lm = d[j];
  d[kAtoms] = lm;
}

__device__ __forceinline__ void atom_sum(float* d) {
  float s = 0.0f;
  for (int j = 0; j < kAtoms; ++j) s = fadd(s, d[j]);
  d[kAtoms] = s;
}

// ---------------------------------------------------------------------------
// 1. act / env / store
// ---------------------------------------------------------------------------

struct RbActCfg {
  int n, r_cur, opp, roll, has_eps, draws, random_start, per;
  uint32_t step, threshold, thr70, k0, k1;
  float scale, alpha;
};

// The act kernel's arrays, in floats per row of a pass (seats x rows rows,
// seats 2 in self-play): the scaled obs, h1, h2, hv1 | ha1 (value1 and
// advantage1 side by side: one pass of 128 columns' tiles), value2's and
// advantage2's outputs, the distributions [A][52] (column 51: the max,
// then the sum; the atoms become d * z) and q.  ops/fused_rainbow.py:
// ACT_ROW_FLOATS mirrors the total.
constexpr int kAx = 0, kAh1 = 16, kAh2 = 52, kAh3 = 120, kAzv = 252,
              kAza = 308, kAdist = 568, kAq = 828, kActRowFloats = 836;
constexpr int kSh3 = 132;
static_assert(kAh1 == kAx + kSx && kAh2 == kAh1 + kSh1 &&
                  kAh3 == kAh2 + kSh && kAzv == kAh3 + kSh3 &&
                  kAza == kAzv + kSv && kAdist == kAza + kSa &&
                  kAq == kAdist + kA * kS51 && kActRowFloats == kAq + 8,
              "rb_act_kernel layout");
// The online net held whole: the trunk (kTrunkP floats from p), then the
// four noisy layers' effective weights (kNumE from wp); copied in three
// cp.async groups in the order the layers need them: the trunk, then
// value1, value2 and advantage1 (up to kCopySplit), then advantage2.
constexpr int kCopySplit = eoff(3);  // 11,635

// Byte offsets of the act kernel's shared memory (ops/fused_rainbow.py:
// act_smem mirrors it): the online net where it is held (g.resident 1;
// at 0 its layers are read from global memory), the arrays of seats x
// g.rows rows, then with a frozen opponent (od) the MLP's ActSmem
// (act_tiled.cuh) for g.rows rows, its weights streamed through two
// buffers of g.chunk floats.
struct RbActSmem {
  size_t tiles, mlp, total;
  __host__ __device__ RbActSmem(ActGeom g, int seats, const MlpDims* od) {
    tiles = g.resident ? align16(kNumG * sizeof(float)) : 0;
    mlp = tiles + static_cast<size_t>(seats) * g.rows * kActRowFloats *
                      sizeof(float);
    total = mlp;
    if (od != nullptr)
      total += ActSmem(od, 1, ActGeom{g.rows, 0, g.chunk, 0}, sizeof(float),
                       1).total;
  }
};

// Whether the host's geometry suits this layout: rows an owner thread each,
// the net held or not, buffers (a frozen opponent only) 16-byte sized that
// hold a k-row of every layer, and the layout within the bytes the host
// sized.
inline bool rb_act_geom_ok(ActGeom g, int seats, const MlpDims* od) {
  if (g.rows < 1 || g.rows > kActRowsMax || g.resident < 0 ||
      g.resident > 1 || g.chunk < 0)
    return false;
  if (od == nullptr ? g.chunk != 0
                    : g.chunk % 4 != 0 || g.chunk < od->h1 ||
                          g.chunk < od->h2 || g.chunk < od->a)
    return false;
  return RbActSmem(g, seats, od).total <= static_cast<size_t>(g.smem);
}

// Where an act layer's sums go: + the bias, ReLU if rl, to y[row][j].
struct ActEpi {
  const float* b;
  float* y;
  int ys;
  bool rl;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    const float v = fadd(acc, b[j]);
    y[r * ys + j] = rl ? relu(v) : v;
  }
};

// A block of kQnetThreads threads owns g.rows envs (ops/fused_rainbow.py:
// act_geometry: 8 envs in 128 blocks at 1,024), thread e < rows env env0 +
// e (its state in registers, its scaled obs written straight into the
// input array; in self-play the opponent's left-rotated one into row rows
// + e).  The noisy dueling C51 forward of the pass's rows: each of its six
// layers one staged_sums pass of RM x RN micro-tiles (value1 with
// advantage1, value2 with advantage2 in one phase each), on the online net
// held in shared memory (its copy overlapping the env rows' loads and the
// first layers) or read from global memory; then the dueling combine, the
// exp and the division one thread an element, the max, the softmax sum and
// E[Z] one thread's chain per (row, action).  A frozen MLP opponent's
// forward follows on act_tiled.cuh's act_forward, its weights streamed.
// Then the picks, the env step, the slab store, the metrics, the episode
// count and the auto-reset of each env.
template <int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 1)
rb_act_kernel(const float* __restrict__ p, const float* __restrict__ wp,
              Net<float> onet, MlpDims od, float* __restrict__ env,
              float* __restrict__ ring, float* __restrict__ met,
              int32_t* __restrict__ ep_step, ActGeom g, RbActCfg ac,
              EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool frozen = ac.opp == kOppFrozen;
  const int seats = ac.opp == kOppSelf ? 2 : 1;
  const RbActSmem S(g, seats, frozen ? &od : nullptr);
  const ActSmem M(&od, 1, ActGeom{g.rows, 0, g.chunk, 0}, sizeof(float), 1);
  const int P = seats * g.rows;  // rows of each array
  float* const y = reinterpret_cast<float*>(smem + S.tiles);
  float* const x = y + P * kAx;
  float* const h1 = y + P * kAh1;
  float* const h2 = y + P * kAh2;
  float* const h3 = y + P * kAh3;
  float* const zv = y + P * kAzv;
  float* const za = y + P * kAza;
  float* const dist = y + P * kAdist;
  float* const q = y + P * kAq;

  const int env0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, ac.n - env0);
  const int prows = seats * rows;
  const int e = threadIdx.x, nt = blockDim.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

  RbNet net = rb_net(p, wp);
  if (g.resident) {  // the online net into shared memory, in three groups
    float* const held = reinterpret_cast<float*>(smem);
    stage(held, p, kTrunkP);
    cp_async_commit();
    stage(held + kTrunkP, wp, kCopySplit);
    cp_async_commit();
    const int k4 = kCopySplit & ~3;  // 16-byte aligned on both sides
    stage(held + kTrunkP + k4, wp + k4, kNumE - k4);
    cp_async_commit();
    net = rb_net(held, held + kTrunkP);
  }

  EnvState s;
  float x1p = 0.f, y1p = 0.f, x2p = 0.f, y2p = 0.f, ep_rew = 0.f, maxp = 0.f;
  float o[10];
  if (owner) {
    s.pos1 = env[0 * sN + lane];
    s.pos2 = env[1 * sN + lane];
    s.vel1 = env[2 * sN + lane];
    s.vel2 = env[3 * sN + lane];
    x1p = env[4 * sN + lane];
    y1p = env[5 * sN + lane];
    x2p = env[6 * sN + lane];
    y2p = env[7 * sN + lane];
    s.winner = static_cast<int>(env[8 * sN + lane]);
    s.t = static_cast<int>(env[9 * sN + lane]);
    ep_rew = env[10 * sN + lane];
    maxp = env[13 * sN + lane];
    const float pre[10] = {x2p - x1p, y2p - y1p, s.vel2 - s.vel1,
                           kEndPoint - s.pos1, s.vel1, x1p - x2p, y1p - y2p,
                           s.vel1 - s.vel2, kEndPoint - s.pos2, s.vel2};
    float* const xr = x + e * kSx;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      o[k] = pre[k];
      xr[k] = fmul(pre[k], ac.scale);
    }
    // Self-play: state[roll:] + state[:roll] (a left rotation), scaled;
    // frozen: the half-swapped raw obs into the MLP's input tile.
    if (seats == 2)
      for (int k = 0; k < 10; ++k)
        x[(rows + e) * kSx + k] = xr[(k + ac.roll) % 10];
    if (frozen)
      put_obs<5>(reinterpret_cast<float*>(smem + S.mlp + M.in) +
                     e * act_stride(kIn),
                 o);
  }

  // ---- the forward of the pass's rows
  cp_async_wait<2>();  // the trunk (nothing is pending where not held)
  __syncthreads();
  ActEpi l1{net.b0, h1, kSh1, true};
  staged_sums<float, RM, RN>(net.w0, kIn, kH0, x, kSx, prows, l1);
  __syncthreads();
  ActEpi l2{net.b1, h2, kSh, true};
  staged_sums<float, RM, RN>(net.w1, kH0, kH1, h1, kSh1, prows, l2);
  cp_async_wait<1>();  // value1, value2, advantage1
  __syncthreads();
  ActEpi v1{net.B[0], h3, kSh3, true}, a1e{net.B[2], h3 + kH1, kSh3, true};
  int lead = staged_sums<float, RM, RN>(net.W[0], kH1, kH1, h2, kSh, prows,
                                        v1);
  staged_sums<float, RM, RN>(net.W[2], kH1, kH1, h2, kSh, prows, a1e, lead);
  cp_async_wait<0>();  // advantage2
  __syncthreads();
  ActEpi v2{net.B[1], zv, kSv, false}, a2e{net.B[3], za, kSa, false};
  lead = staged_sums<float, RM, RN>(net.W[1], kH1, kAtoms, h3, kSh3, prows,
                                    v2);
  staged_sums<float, RM, RN>(net.W[3], kH1, kA * kAtoms, h3 + kH1, kSh3,
                             prows, a2e, lead);
  __syncthreads();

  // ---- the dueling head: dist's row ra = r * kA + a
  const int nra = prows * kA;
  for (int i = e; i < nra * kAtoms; i += nt) {
    const int ra = i / kAtoms, j = i - ra * kAtoms, r = ra / kA;
    dist[ra * kS51 + j] = duel_logit(za + r * kSa, zv + r * kSv, ra - r * kA,
                                     j);
  }
  __syncthreads();
  for (int ra = e; ra < nra; ra += nt) atom_max(dist + ra * kS51);
  __syncthreads();
  for (int i = e; i < nra * kAtoms; i += nt) {
    float* const d = dist + (i / kAtoms) * kS51;
    const int j = i % kAtoms;
    d[j] = expf(__fsub_rn(d[j], d[kAtoms]));
  }
  __syncthreads();
  for (int ra = e; ra < nra; ra += nt) atom_sum(dist + ra * kS51);
  __syncthreads();
  for (int i = e; i < nra * kAtoms; i += nt) {  // softmax, times the support
    float* const d = dist + (i / kAtoms) * kS51;
    const int j = i % kAtoms;
    d[j] = fmul(__fdiv_rn(d[j], d[kAtoms]), zsup(j));
  }
  __syncthreads();
  for (int ra = e; ra < nra; ra += nt) {  // E[Z]
    const float* const d = dist + ra * kS51;
    float acc = 0.0f;
    for (int j = 0; j < kAtoms; ++j) acc = fadd(acc, d[j]);
    q[ra] = acc;
  }
  __syncthreads();

  int a1 = owner ? argmax0(q + e * kA, kA) : 0;
  int a2 = -1;
  if (owner && seats == 2) a2 = argmax0(q + (rows + e) * kA, kA);
  if (frozen) {
    act_forward<float, RM, RN>(smem + S.mlp, M, g.chunk, od, onet, -1, rows);
    if (owner)
      a2 = argmax0(reinterpret_cast<const float*>(smem + S.mlp + M.q) +
                       e * od.a,
                   kA);
  }

  bool done = false;
  if (owner) {
    if (ac.has_eps) {
      Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                     ac.k0, ac.k1);
      a1 = phi_select(a1, b.x, b.y, ac.threshold, kA);
      if (seats == 2) a2 = phi_select(a2, b.z, b.w, ac.threshold, kA);
    }
    if (frozen && ac.draws) {
      Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamFrozen,
                     ac.k0, ac.k1);
      a2 = phi_select(a2, b.x, b.y, ac.thr70, kA);
    }
    StepOut so = env_step(s, a1, a2, cfg);
    done = so.done;

    // Unconditional slab store; with PER row 23 is maxp ** alpha.
    float* row = ring + static_cast<size_t>(ac.r_cur) * kRbNumF * sN + lane;
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
    row[23 * sN] = ac.per ? powx(maxp, ac.alpha) : 0.0f;

    // Metrics (win on the pre-step obs) and the per-lane episode count.
    ep_rew = fadd(ep_rew, so.r1);
    const bool won = so.done && (o[8] > o[3]);
    met[0 * sN + lane] = met[0 * sN + lane] + (so.done ? 1.0f : 0.0f);
    met[1 * sN + lane] = met[1 * sN + lane] + (so.col ? 1.0f : 0.0f);
    met[2 * sN + lane] = met[2 * sN + lane] + (won ? 1.0f : 0.0f);
    met[3 * sN + lane] = met[3 * sN + lane] + (so.done ? ep_rew : 0.0f);
    if (so.done) ep_rew = 0.0f;
    env[12 * sN + lane] = env[12 * sN + lane] + (so.done ? 1.0f : 0.0f);

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
  const int ended = __syncthreads_count(owner && done);
  if (threadIdx.x == 0 && ended > 0) atomicAdd(ep_step, ended);
}

// ---------------------------------------------------------------------------
// 2. PER pick
// ---------------------------------------------------------------------------

struct RbPickCfg {
  int n, R, B, r_cur, stored, n_step;
  float inv_b, beta;
};

// The pick's grid: the R * n priorities in round-major order as C = R * n /
// 128 chunks of 128 lanes, chunk ch at ch * kPickStride floats (4 floats of
// pad, so the eight threads of a quarter warp reading their chunks as
// float4 hit different banks), then the C chunk sums, then their exclusive
// prefix.  Layout kPickShared holds it in shared memory; kPickGlobal, for a
// grid too large for a block (ops/fused_rainbow.py:pick_geometry), in a
// global workspace that the same block writes and then reads (L2).
constexpr int kPickThreads = 512;
constexpr int kPickStride = 132;
constexpr int kPickLoads = 4;
constexpr int kPickShared = 0, kPickGlobal = 1;

__host__ __device__ inline size_t pick_floats(int R, int n) {
  const size_t C = static_cast<size_t>(R) * (n / 128);
  return C * kPickStride + 2 * C;
}

// One block of kPickThreads threads (the fastest of 128 to 1,024 at R 8,
// n 1,024, PERF.md), five phases and three barriers:
//   1. the masked grid (a slot's age in [n_step - 1, stored - 1], else 0)
//      staged with coalesced 16-byte loads, each thread's least positive
//      priority folded by fminf (order-free) into a warp's;
//   2. each chunk's inclusive running sum in lane order from 0 (per_cdf's
//      `local`), one thread's 128-add chain over float4 reads, in place;
//   3. the chunk sums added in chunk order from 0 by thread 0 (`excl`,
//      `total`), the warps' minima folded into pmin;
//   4. per target u_b a binary search over the whole cdf,
//      cdf[i] = excl[i / 128] + local[i]: the cdf is non-decreasing
//      (rounding is monotone, and a chunk's last entry excl[c] + sum[c] is
//      excl[c + 1]), so the first index whose cdf exceeds u is exactly
//      searchsorted(side='right') of the plain version (clipped to the
//      last slot);
//   5. the pick's priority read from the ring by index, the weights.
// The critical path holds one 128-add chain, one C-add chain and
// ~log2(R * n) shared-memory probes per target; the only global loads are
// the staging's and one per target.
template <int kLayout>
__global__ void __launch_bounds__(kPickThreads)
    rb_per_pick_kernel(const float* __restrict__ ring,
                       const float* __restrict__ us, int32_t* __restrict__ sel,
                       float* __restrict__ wts, float* __restrict__ ws,
                       RbPickCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const g =
      kLayout == kPickShared ? reinterpret_cast<float*>(smem) : ws;
  const int G = c.n / 128, C = c.R * G, n4 = c.n / 4;
  float* const csum = g + static_cast<size_t>(C) * kPickStride;
  float* const excl = csum + C;
  __shared__ float warp_min[kPickThreads / 32];
  __shared__ float total_s, pmin_s;
  const int tid = threadIdx.x;
  constexpr int nt = kPickThreads;

  // kPickLoads float4 a thread in flight at once (all of them at R 8,
  // n 1,024), then their minima and stores.
  float mn = INFINITY;
  for (int q0 = tid; q0 < c.R * n4; q0 += kPickLoads * nt) {
    float4 v[kPickLoads];
#pragma unroll
    for (int u = 0; u < kPickLoads; ++u) {
      const int q = q0 + u * nt, r = q / n4, l = (q - r * n4) * 4;
      const int age = (c.r_cur - r + c.R) % c.R;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < c.R * n4 && age >= c.n_step - 1 && age <= c.stored - 1)
        v[u] = *reinterpret_cast<const float4*>(
            ring + (static_cast<size_t>(r) * kRbNumF + kRbNumF - 1) * c.n +
            l);
    }
#pragma unroll
    for (int u = 0; u < kPickLoads; ++u) {
      const int q = q0 + u * nt, r = q / n4, l = (q - r * n4) * 4;
      if (q >= c.R * n4) break;
      if (v[u].x > 0.0f) mn = fminf(mn, v[u].x);
      if (v[u].y > 0.0f) mn = fminf(mn, v[u].y);
      if (v[u].z > 0.0f) mn = fminf(mn, v[u].z);
      if (v[u].w > 0.0f) mn = fminf(mn, v[u].w);
      *reinterpret_cast<float4*>(g + static_cast<size_t>(r * G + l / 128) *
                                         kPickStride +
                                 (l & 127)) = v[u];
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  if ((tid & 31) == 0) warp_min[tid >> 5] = mn;
  __syncthreads();

  for (int ch = tid; ch < C; ch += nt) {
    float4* const q =
        reinterpret_cast<float4*>(g + static_cast<size_t>(ch) * kPickStride);
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      float4 v = q[j];
      v.x = acc = fadd(acc, v.x);
      v.y = acc = fadd(acc, v.y);
      v.z = acc = fadd(acc, v.z);
      v.w = acc = fadd(acc, v.w);
      q[j] = v;
    }
    csum[ch] = acc;
  }
  __syncthreads();

  if (tid == 0) {
    float run = 0.0f;
#pragma unroll 8
    for (int ch = 0; ch < C; ++ch) {
      excl[ch] = run;
      run = fadd(run, csum[ch]);
    }
    total_s = run;
    float m = INFINITY;
    for (int w = 0; w < nt / 32; ++w) m = fminf(m, warp_min[w]);
    pmin_s = m;
  }
  __syncthreads();

  const float total = total_s;
  const float nvalid = fmul(static_cast<float>(c.stored - (c.n_step - 1)),
                            static_cast<float>(c.n));
  const float ratio = __fdiv_rn(nvalid, total);
  const float wmax = powx(fmul(pmin_s, ratio), c.beta);
  const int last = C * 128 - 1;
  for (int b = tid; b < c.B; b += nt) {
    const float u = fmul(fadd(static_cast<float>(b), us[0]),
                         fmul(total, c.inv_b));
    int lo = 0, hi = last + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1, ch = mid >> 7;
      const float cdf = fadd(
          excl[ch], g[static_cast<size_t>(ch) * kPickStride + (mid & 127)]);
      if (cdf <= u) lo = mid + 1;
      else hi = mid;
    }
    const int idx = lo < last ? lo : last;
    const int r = idx / c.n, lane = idx - r * c.n;
    sel[b] = r;
    sel[c.B + b] = lane;
    const int age = (c.r_cur - r + c.R) % c.R;
    const float p =
        (age < c.n_step - 1 || age > c.stored - 1)
            ? 0.0f
            : ring[(static_cast<size_t>(r) * kRbNumF + kRbNumF - 1) * c.n +
                   lane];
    wts[b] = fmul(powx(fmul(p, ratio), -c.beta), wmax);
  }
}

// ---------------------------------------------------------------------------
// 3. the learner's forward and backward (learn_fwd_kernel)
// ---------------------------------------------------------------------------

struct RbLearnCfg {
  int n, R, B, n_step, per, faithful;
  float gamma, scale, inv_b;
};

// The workspace: one row of kWsWidth floats per sampled lane, written by
// learn_fwd_kernel and read by learn_grad_kernel.  Each group starts on a
// multiple of 4 floats (16-byte loads).  A 1 follows each first factor (x
// and the online net's hidden layers): its bias's row.  The weighted CE
// follows dl, so value2's bias row sums the loss beside the bias.  The
// host writes the ones and zeros once (ops/fused_rainbow.py:WS_GROUPS
// mirrors the columns); learn_fwd_kernel writes the rest.
constexpr int kWsX = 0;       // x (10); 1 (linear1 b), 0
constexpr int kWsH1 = 12;     // h1 (32); 1 (linear2 b), 0, 0, 0
constexpr int kWsH2 = 48;     // h2 (64); 1 (value1 b, advantage1 b), 0, 0, 0
constexpr int kWsHv1 = 116;   // hv1 (64); 1 (value2 b), 0, 0, 0
constexpr int kWsHa1 = 184;   // ha1 (64); 1 (advantage2 b), 0, 0, 0
constexpr int kWsDz1 = 252;   // dz1 (32)
constexpr int kWsDz2 = 284;   // dz2 (64)
constexpr int kWsDzv1 = 348;  // dzv1 (64)
constexpr int kWsDl = 412;    // dl (51), ce * w
constexpr int kWsDza1 = 464;  // dza1 (64)
constexpr int kWsDza2 = 528;  // dza2 (255), 0
constexpr int kWsWidth = 784;

// The online net's weights transposed, which rb_post forms for the
// backward: per noisy layer W^T [out][64], then w1^T [64][32].
__host__ __device__ constexpr int toff(int l) {
  return l == 0 ? 0 : toff(l - 1) + kH1 * out_of(l - 1);
}
constexpr int kNumT = toff(4) + kH0 * kH1;
static_assert(kNumT == 29824, "K8 transposed layout");

// learn_fwd_kernel's shared memory: two weight buffers of kChunk floats
// (the widest layer, advantage2, fits whole), then each array below with
// `lanes` rows, each row a multiple of 4 floats (16-byte rows for load4):
// the scaled obs and bootstrap obs; the hidden layers (the target's, then
// the online net's); the value2 and advantage2 outputs; the target's
// distribution [5][52] (column 51: the row's max, then its sum); the
// projection's mass, b and result; the sampled action's distribution
// (column 51 as in dist), proj * log c, g; dl; dza2 (first the target's
// d * z); dzv1, dza1, dz2 and the first of dz2's two sums; per lane the
// action, return, done, weight and sv, and from column 8 the target's q.
// ops/fused_rainbow.py:LANE_FLOATS mirrors the total.
constexpr int kChunk = kH1 * kA * kAtoms;  // 16,320
constexpr int kYx = 0, kYxn = 16, kYh1 = 32, kYh2 = 68, kYhv1 = 136,
              kYha1 = 204, kYzv2 = 272, kYza2 = 328, kYdist = 588,
              kYmass = 848, kYbb = 900, kYproj = 952, kYdsel = 1004,
              kYpce = 1056, kYg = 1108, kYdl = 1160, kYdza2 = 1216,
              kYdzv1 = 1476, kYdza1 = 1544, kYdz2 = 1612, kYav = 1680,
              kYsc = 1748;
// Row strides of those arrays: those of the forwards' shared arrays (kSx
// ..), and the per-lane scalars.
constexpr int kSsc = 16;
constexpr int kLaneFloats = 1764;
static_assert(kYsc + kSsc == kLaneFloats && kSa == kA * kS51,
              "learn_fwd_kernel layout");
constexpr int kLearnThreads = 256;

__host__ __device__ constexpr size_t learn_smem(int lanes) {
  return (2 * static_cast<size_t>(kChunk) +
          static_cast<size_t>(lanes) * kLaneFloats) *
         sizeof(float);
}

// Rows of a thread's micro-tile in a layer of J outputs over `lanes` rows:
// the fewest that leave no output without a thread of the block.
__host__ __device__ constexpr int learn_rm(int lanes, int J) {
  return lanes <= 1 || lanes * J <= kLearnThreads
             ? 1
             : 2 * learn_rm(lanes / 2, J);
}

// The 17 layers of one learn in order, and where each one's weights f32
// [K][J] (n = K * J floats) are: the target's and then the online net's
// linear1, linear2, value1, advantage1, value2, advantage2, each with its
// bias [J] right after its weights (in the parameter and the element
// layout alike); then the backward's value2^T, advantage2^T, value1^T,
// advantage1^T and w1^T.
constexpr int kLayers = 17;
constexpr int kBiased = 12;  // layers 0-11 have a bias

__device__ __forceinline__ const float* layer_w(int i, const RbNet& p,
                                                const RbNet& t,
                                                const float* wpt, int& n) {
  const RbNet& net = i < 6 ? t : p;
  switch (i < kBiased ? i % 6 : i) {
    case 0: n = kIn * kH0; return net.w0;
    case 1: n = kH0 * kH1; return net.w1;
    case 2: n = kH1 * kH1; return net.W[0];
    case 3: n = kH1 * kH1; return net.W[2];
    case 4: n = kH1 * kAtoms; return net.W[1];
    case 5: n = kH1 * kA * kAtoms; return net.W[3];
    case 12: n = kAtoms * kH1; return wpt + toff(1);
    case 13: n = kA * kAtoms * kH1; return wpt + toff(3);
    case 14: n = kH1 * kH1; return wpt + toff(0);
    case 15: n = kH1 * kH1; return wpt + toff(2);
    default: n = kH0 * kH1; return wpt + toff(4);
  }
}

// The layers' weights pass through the two buffers a whole layer at a
// time: layer i's go to buffer i & 1, requested (cp.async) two layers
// ahead, once layer i - 2 is done with it.
struct LayerPipe {
  float* buf;
  RbNet p, t;
  const float* wpt;
  __device__ __forceinline__ void fetch(int i) const {
    if (i < kLayers) {
      int n;
      const float* w = layer_w(i, p, t, wpt, n);
      stage(buf + (i & 1) * kChunk, w, n);
    }
    cp_async_commit();
  }
  // Layer i's weights, once they and everything stored before have landed.
  __device__ __forceinline__ const float* wait(int i) const {
    cp_async_wait_prev();
    __syncthreads();
    return buf + (i & 1) * kChunk;
  }
  __device__ __forceinline__ void release(int i) const {
    __syncthreads();
    fetch(i + 2);
  }
};

// Where a layer's sums go: + a first sum (add: dz2 = (dzv1 V1^T + dza1
// A1^T) * relu'(h2)), + the bias b (global), ReLU, * relu'(mask), to
// shared rows y and to the workspace at column col of the block's rows.
struct LearnEpi {
  bool rl;
  const float* add;
  int as;
  const float* mk;
  int ms;
  float* y;
  int ys;
  float* ws;
  int col;
  const float* b = nullptr;
  __device__ __forceinline__ void sum(int r, int j, float acc) {
    float v = acc;
    if (add != nullptr) v = fadd(add[r * as + j], v);
    if (b != nullptr) v = fadd(v, b[j]);
    if (rl) v = relu(v);
    if (mk != nullptr) v = fmul(v, mask(mk[r * ms + j]));
    if (y != nullptr) y[r * ys + j] = v;
    if (ws != nullptr) ws[static_cast<size_t>(r) * kWsWidth + col + j] = v;
  }
};

template <int LANES, int J>
__device__ __forceinline__ void learn_layer(const LayerPipe& pipe, int i,
                                            int K, const float* x, int xs,
                                            int rows, LearnEpi e) {
  if (i < kBiased) {
    int n;
    e.b = layer_w(i, pipe.p, pipe.t, pipe.wpt, n) + n;
  }
  staged_sums<float, learn_rm(LANES, J), 1>(pipe.wait(i), K, J, x, xs, rows,
                                            e);
  pipe.release(i);
}

// The six layers of a net (pipeline layers l0 ..) on the rows of x: the
// hidden layers and the value2 and advantage2 outputs; with ws, the hidden
// layers also go to the workspace.
template <int LANES>
__device__ __forceinline__ void net_layers(const LayerPipe& pipe, int l0,
                                           const float* x,
                                           float* h1, float* h2, float* hv1,
                                           float* ha1, float* zv2,
                                           float* za2, int rows, float* ws) {
  learn_layer<LANES, kH0>(pipe, l0, kIn, x, kSx, rows,
                          {true, nullptr, 0, nullptr, 0, h1, kSh1, ws,
                           kWsH1});
  learn_layer<LANES, kH1>(pipe, l0 + 1, kH0, h1, kSh1, rows,
                          {true, nullptr, 0, nullptr, 0, h2, kSh, ws, kWsH2});
  learn_layer<LANES, kH1>(pipe, l0 + 2, kH1, h2, kSh, rows,
                          {true, nullptr, 0, nullptr, 0, hv1, kSh, ws,
                           kWsHv1});
  learn_layer<LANES, kH1>(pipe, l0 + 3, kH1, h2, kSh, rows,
                          {true, nullptr, 0, nullptr, 0, ha1, kSh, ws,
                           kWsHa1});
  learn_layer<LANES, kAtoms>(pipe, l0 + 4, kH1, hv1, kSh, rows,
                             {false, nullptr, 0, nullptr, 0, zv2, kSv,
                              nullptr, 0});
  learn_layer<LANES, kA * kAtoms>(pipe, l0 + 5, kH1, ha1, kSh, rows,
                                  {false, nullptr, 0, nullptr, 0, za2, kSa,
                                   nullptr, 0});
}

// A block of kLearnThreads threads owns LANES of the B sampled lanes.
// Every layer is one staged_sums pass over the block's lanes; between
// them, the phases
// that the plain version writes elementwise run one thread an element,
// and its ordered sums (max, softmax sum, E[Z], projection, CE) one thread
// a chain.  The target net's distribution is needed for every action (its
// argmax picks one), the online net's only for the sampled one: each
// (lane, action) is computed on its own, so that keeps dsel's bits.
template <int LANES>
__global__ void __launch_bounds__(kLearnThreads)
learn_fwd_kernel(RbNet pnet, RbNet tnet, const float* __restrict__ wpt,
                 const float* __restrict__ ring,
                 const int32_t* __restrict__ rounds,
                 const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ sel, const float* __restrict__ wts,
                 const float* __restrict__ gpow, float* __restrict__ ws,
                 float* __restrict__ ce_out, RbLearnCfg lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const wbuf = reinterpret_cast<float*>(smem);
  float* const y = wbuf + 2 * kChunk;
  float* const x = y + LANES * kYx;
  float* const xn = y + LANES * kYxn;
  float* const h1 = y + LANES * kYh1;
  float* const h2 = y + LANES * kYh2;
  float* const hv1 = y + LANES * kYhv1;
  float* const ha1 = y + LANES * kYha1;
  float* const zv2 = y + LANES * kYzv2;
  float* const za2 = y + LANES * kYza2;
  float* const dist = y + LANES * kYdist;
  float* const mass = y + LANES * kYmass;
  float* const bk = y + LANES * kYbb;
  float* const proj = y + LANES * kYproj;
  float* const dsel = y + LANES * kYdsel;
  float* const pce = y + LANES * kYpce;
  float* const g = y + LANES * kYg;
  float* const dl = y + LANES * kYdl;
  float* const dza2 = y + LANES * kYdza2;
  float* const dzv1 = y + LANES * kYdzv1;
  float* const dza1 = y + LANES * kYdza1;
  float* const dz2 = y + LANES * kYdz2;
  float* const av = y + LANES * kYav;
  float* const sc = y + LANES * kYsc;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * LANES;
  const int rows = min(LANES, lc.B - b0);
  const size_t sN = static_cast<size_t>(lc.n);
  float* const wsb = ws + static_cast<size_t>(b0) * kWsWidth;
  const LayerPipe pipe{wbuf, pnet, tnet, wpt};
  pipe.fetch(0);
  pipe.fetch(1);

  // Gather and the n-step reconstruction (nstep_batch_from_slabs), one
  // thread per (lane, obs field).
  for (int i = tid; i < rows * kIn; i += nt) {
    const int r = i / kIn, q = i - r * kIn, b = b0 + r;
    int round, lane;
    if (lc.per) {
      round = sel[b];
      lane = sel[lc.B + b];
    } else {
      round = rounds[0];
      lane = cols[0] * lc.B + b;
    }
    float ret = 0.0f, alive = 1.0f, nxt = 0.0f;
    for (int k = 0; k < lc.n_step; ++k) {
      const int rk = (round + k) % lc.R;
      const float* s = ring + static_cast<size_t>(rk) * kRbNumF * sN + lane;
      const float done_k = s[22 * sN];
      ret = fadd(ret, fmul(fmul(gpow[k], s[21 * sN]), alive));
      const float sl = k < lc.n_step - 1 ? fmul(alive, done_k) : alive;
      nxt = fadd(nxt, fmul(sl, s[(10 + q) * sN]));
      alive = fmul(alive, __fsub_rn(1.0f, done_k));
    }
    const float* s0 = ring + static_cast<size_t>(round) * kRbNumF * sN + lane;
    const float xv = fmul(s0[q * sN], lc.scale);
    x[r * kSx + q] = xv;
    xn[r * kSx + q] = fmul(nxt, lc.scale);
    wsb[static_cast<size_t>(r) * kWsWidth + kWsX + q] = xv;
    if (q == 0) {
      float* const c = sc + r * kSsc;
      c[0] = s0[20 * sN];
      c[1] = ret;
      c[2] = alive < 0.5f ? 1.0f : 0.0f;
      c[3] = lc.per ? wts[b] : 1.0f;
    }
  }

  // ---- the target net on the bootstrap obs: every action's distribution,
  // E[Z], the argmax and the projection
  net_layers<LANES>(pipe, 0, xn, h1, h2, hv1, ha1, zv2, za2, rows, nullptr);
  const int nra = rows * kA;  // dist's row ra = r * kA + a
  for (int i = tid; i < nra * kAtoms; i += nt) {
    const int ra = i / kAtoms, j = i - ra * kAtoms, r = ra / kA;
    dist[ra * kS51 + j] = duel_logit(za2 + r * kSa, zv2 + r * kSv,
                                     ra - r * kA, j);
  }
  __syncthreads();
  for (int ra = tid; ra < nra; ra += nt) atom_max(dist + ra * kS51);
  __syncthreads();
  for (int i = tid; i < nra * kAtoms; i += nt) {
    float* const d = dist + (i / kAtoms) * kS51;
    const int j = i % kAtoms;
    d[j] = expf(__fsub_rn(d[j], d[kAtoms]));
  }
  __syncthreads();
  for (int ra = tid; ra < nra; ra += nt) atom_sum(dist + ra * kS51);
  __syncthreads();
  for (int i = tid; i < nra * kAtoms; i += nt) {
    const int ra = i / kAtoms, j = i - ra * kAtoms;
    float* const d = dist + ra * kS51;
    const float pr = __fdiv_rn(d[j], d[kAtoms]);
    d[j] = pr;
    dza2[ra * kS51 + j] = fmul(pr, zsup(j));
  }
  __syncthreads();
  for (int ra = tid; ra < nra; ra += nt) {
    float acc = 0.0f;
    for (int j = 0; j < kAtoms; ++j) acc = fadd(acc, dza2[ra * kS51 + j]);
    sc[(ra / kA) * kSsc + 8 + ra % kA] = acc;
  }
  __syncthreads();
  for (int i = tid; i < rows * kAtoms; i += nt) {
    const int r = i / kAtoms, k = i - r * kAtoms;
    const float* const c = sc + r * kSsc;
    const int star = argmax0(c + 8, kA);
    const float np_ = dist[(r * kA + star) * kS51 + k];
    const float z = zsup(k);
    float m = lc.faithful ? fmul(np_, z) : np_;
    const float nd = __fsub_rn(1.0f, c[2]);
    const float tz =
        fminf(fmaxf(fadd(c[1], fmul(fmul(nd, lc.gamma), z)), -10.0f), 10.0f);
    const float bb = fmul(__fsub_rn(tz, -10.0f), 2.5f);
    if (lc.faithful) m = fmul(m, floorf(bb) != ceilf(bb) ? 1.0f : 0.0f);
    mass[r * kS51 + k] = m;
    bk[r * kS51 + k] = bb;
  }
  __syncthreads();
  for (int i = tid; i < rows * kAtoms; i += nt) {
    const int r = i / kAtoms, a = i - r * kAtoms;
    const float fi = static_cast<float>(a);
    float acc = 0.0f;
    for (int k = 0; k < kAtoms; ++k) {
      const float hat =
          fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(bk[r * kS51 + k], fi))),
                0.0f);
      acc = fadd(acc, fmul(mass[r * kS51 + k], hat));
    }
    proj[r * kS51 + a] = acc;
  }

  // ---- the online net on the obs: the sampled action's distribution, the
  // CE, its gradient and the dueling backward
  net_layers<LANES>(pipe, 6, x, h1, h2, hv1, ha1, zv2, za2, rows, wsb);
  for (int i = tid; i < rows * kAtoms; i += nt) {
    const int r = i / kAtoms, j = i - r * kAtoms;
    dsel[r * kS51 + j] = duel_logit(za2 + r * kSa, zv2 + r * kSv,
                                    static_cast<int>(sc[r * kSsc]), j);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += nt) atom_max(dsel + r * kS51);
  __syncthreads();
  for (int i = tid; i < rows * kAtoms; i += nt) {
    float* const d = dsel + (i / kAtoms) * kS51;
    const int j = i % kAtoms;
    d[j] = expf(__fsub_rn(d[j], d[kAtoms]));
  }
  __syncthreads();
  for (int r = tid; r < rows; r += nt) atom_sum(dsel + r * kS51);
  __syncthreads();
  for (int i = tid; i < rows * kAtoms; i += nt) {
    const int r = i / kAtoms, j = i - r * kAtoms, e = r * kS51 + j;
    const float d = __fdiv_rn(dsel[e], dsel[r * kS51 + kAtoms]);
    const float c = fminf(fmaxf(d, 0.01f), 0.99f);
    const float inr = (d > 0.01f && d < 0.99f) ? 1.0f : 0.0f;
    const float gv = fmul(fmul(-__fdiv_rn(proj[e], c), inr),
                          fmul(sc[r * kSsc + 3], lc.inv_b));
    dsel[e] = d;
    g[e] = gv;
    pce[e] = fmul(proj[e], logf(c));
    mass[e] = fmul(gv, d);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += nt) {
    float acc = 0.0f, s = 0.0f;
    for (int j = 0; j < kAtoms; ++j) {
      acc = fadd(acc, pce[r * kS51 + j]);
      s = fadd(s, mass[r * kS51 + j]);
    }
    const float ce = -acc;
    ce_out[b0 + r] = ce;
    wsb[static_cast<size_t>(r) * kWsWidth + kWsDl + kAtoms] =
        fmul(ce, sc[r * kSsc + 3]);
    sc[r * kSsc + 4] = s;
  }
  __syncthreads();
  for (int i = tid; i < rows * kA * kAtoms; i += nt) {
    const int r = i / (kA * kAtoms), ra = i - r * kA * kAtoms;
    const int a = ra / kAtoms, j = ra - a * kAtoms, e = r * kS51 + j;
    const float d = dsel[e];
    const float dlv = __fsub_rn(fmul(d, g[e]), fmul(d, sc[r * kSsc + 4]));
    float* const wr = wsb + static_cast<size_t>(r) * kWsWidth;
    if (a == 0) {
      dl[r * kSv + j] = dlv;
      wr[kWsDl + j] = dlv;
    }
    const float oh = a == static_cast<int>(sc[r * kSsc]) ? 1.0f : 0.0f;
    const float v = fmul(__fsub_rn(oh, 0.2f), dlv);
    dza2[r * kSa + ra] = v;
    wr[kWsDza2 + ra] = v;
  }

  // ---- the backward through the four noisy layers and the trunk: sums
  // over j of W[k][j] dz[j], in j order, as layers over the transposes
  learn_layer<LANES, kH1>(pipe, 12, kAtoms, dl, kSv, rows,
                          {false, nullptr, 0, hv1, kSh, dzv1, kSh, wsb,
                           kWsDzv1});
  learn_layer<LANES, kH1>(pipe, 13, kA * kAtoms, dza2, kSa, rows,
                          {false, nullptr, 0, ha1, kSh, dza1, kSh, wsb,
                           kWsDza1});
  learn_layer<LANES, kH1>(pipe, 14, kH1, dzv1, kSh, rows,
                          {false, nullptr, 0, nullptr, 0, av, kSh, nullptr,
                           0});
  learn_layer<LANES, kH1>(pipe, 15, kH1, dza1, kSh, rows,
                          {false, av, kSh, h2, kSh, dz2, kSh, wsb, kWsDz2});
  learn_layer<LANES, kH0>(pipe, 16, kH1, dz2, kSh, rows,
                          {false, nullptr, 0, h1, kSh1, nullptr, 0, wsb,
                           kWsDz1});
}

// ---------------------------------------------------------------------------
// 4. the gradients and Adam (learn_grad_kernel)
// ---------------------------------------------------------------------------

// Parameter indices of the mu and sigma of element e.
__device__ __forceinline__ void mu_sigma(int e, int& mu, int& sg) {
  int l = 3;
  while (e < eoff(l)) --l;
  const int j = e - eoff(l), o = out_of(l), w = kH1 * o;
  if (j < w) {
    mu = poff(l) + j;
    sg = mu + w;
  } else {
    mu = poff(l) + 2 * w + (j - w);
    sg = mu + o;
  }
}

// One gradient job: the sum over lanes of ws[h + k] * ws[d + j] for k < K,
// j < J.  Entry (k, j < width) is index out + k * width + j of the
// parameters (jobs 0 and 1, the trunk) or of a noisy layer's elements
// (jobs 2-5): the last row of each first factor is the column of ones, so
// its entries are the bias, which follows its weight in both layouts.
// Column 51 of value2's job is the weighted CE, its bias row the loss.
struct RbGradJob {
  int h, K, d, J, width, out;
};

constexpr int kRbJobs = 6;

__host__ __device__ inline RbGradJob rb_grad_job(int i) {
  switch (i) {
    case 0:  // linear1 w [10][32], b
      return {kWsX, kIn + 1, kWsDz1, kH0, kH0, 0};
    case 1:  // linear2 w [32][64], b
      return {kWsH1, kH0 + 1, kWsDz2, kH1, kH1, kIn * kH0 + kH0};
    case 2:  // value1
      return {kWsH2, kH1 + 1, kWsDzv1, kH1, kH1, eoff(0)};
    case 3:  // value2, and the loss
      return {kWsHv1, kH1 + 1, kWsDl, kAtoms + 1, kAtoms, eoff(1)};
    case 4:  // advantage1
      return {kWsH2, kH1 + 1, kWsDza1, kH1, kH1, eoff(2)};
    default:  // advantage2
      return {kWsHa1, kH1 + 1, kWsDza2, kA * kAtoms, kA * kAtoms, eoff(3)};
  }
}

// A block of NT threads (256, 512 or 1,024, from the host's geometry) owns
// a kGradK x kGradJ rectangle of one job's entries.  Each of its groups of
// 8 threads sums one summation tile (`tile` lanes, ops/fused_rainbow.py:
// learn_tile) at a time, each thread a 4 x 4 micro-tile of the rectangle,
// reading its 4 + 4 factors of every lane straight from the workspace
// (16-byte loads, four lanes ahead; the workspace stays in the L2 cache).
// A round's partials are parked in shared memory and one thread per entry
// adds them into its total in tile order.
constexpr int kGradK = 16, kGradJ = 8;
constexpr int kGradEntries = kGradK * kGradJ;  // 128
constexpr int kGradGroup = kGradEntries / 16;  // threads a summation tile

__host__ __device__ inline int grad_rects(const RbGradJob& j) {
  return (j.K + kGradK - 1) / kGradK * ((j.J + kGradJ - 1) / kGradJ);
}

__host__ __device__ inline int grad_blocks() {
  int n = 0;
  for (int i = 0; i < kRbJobs; ++i) n += grad_rects(rb_grad_job(i));
  return n;
}

// Bytes of learn_grad_kernel's shared memory (ops/fused_rainbow.py:
// learn_tiling): the groups' partial sums, 64 bytes a thread.
__host__ __device__ constexpr size_t grad_smem(int threads) {
  return static_cast<size_t>(threads) / kGradGroup * kGradEntries *
         sizeof(float);
}

struct RbGradCfg {
  int B, tile;
  AdamHyper h;
};

__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& h,
                                       const float4& d) {
  const float hv[4] = {h.x, h.y, h.z, h.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = fadd(acc[i][c], fmul(hv[i], dv[c]));
}

template <int NT>
__global__ void __launch_bounds__(NT)
learn_grad_kernel(const float* __restrict__ ws, float* __restrict__ p,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ eps, float* __restrict__ loss,
                  RbGradCfg gc) {
  constexpr int kGroups = NT / kGradGroup;  // summation tiles in flight
  static_assert(kGradEntries <= NT, "one thread per entry adds partials");
  int rect = blockIdx.x, ji = 0;
  for (; ji < kRbJobs - 1; ++ji) {
    const int n = grad_rects(rb_grad_job(ji));
    if (rect < n) break;
    rect -= n;
  }
  const RbGradJob job = rb_grad_job(ji);
  const int njb = (job.J + kGradJ - 1) / kGradJ;
  const int k0 = rect / njb * kGradK, j0 = rect % njb * kGradJ;

  extern __shared__ __align__(16) float s_part[];  // [group][entry]
  const int tid = threadIdx.x;
  const int grp = tid / kGradGroup, mk = (tid % kGradGroup) >> 1,
            mj = tid & 1;  // a 4 x 4 micro-tile of the 16 x 8 rectangle
  const int TR = gc.tile;
  const int ntiles = gc.B / gc.tile;
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
      for (; r + 4 <= TR; r += 4) {  // lanes in order, four loaded at once
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
      for (int gi = 0; gi < kGroups && q0 + gi < ntiles; ++gi)
        total = fadd(total, s_part[gi * kGradEntries + tid]);
  }

  if (tid >= kGradEntries) return;
  const int k = k0 + tid / kGradJ, j = j0 + tid % kGradJ;
  if (k >= job.K || j >= job.J) return;
  if (j >= job.width) {  // value2's column 51: the loss, at the bias row
    if (k == job.K - 1) *loss = __fdiv_rn(total, static_cast<float>(gc.B));
    return;
  }
  const int i = job.out + k * job.width + j;
  if (ji < 2) {
    adam_step(total, p, m, v, i, gc.h);
    return;
  }
  int mu, sg;
  mu_sigma(i, mu, sg);
  adam_step(total, p, m, v, mu, gc.h);
  adam_step(fmul(total, eps[i]), p, m, v, sg, gc.h);
}

// ---------------------------------------------------------------------------
// 5. noise, target sync, effective weights, PER write-back
// ---------------------------------------------------------------------------

struct RbPostCfg {
  int n, R, B, i, regen, per_wb, check_sync;
  uint32_t k0, k1, step;
  float alpha, inv_sync, synced0;
};

// sign(x) * sqrt(|x|) of a Box-Muller normal at (step, idx, stream, 0).
__device__ __forceinline__ float scaled_normal(uint32_t step, uint32_t idx,
                                               uint32_t stream, uint32_t k0,
                                               uint32_t k1) {
  Bits4 b = draw(step, idx, stream, k0, k1);
  const float scale = 1.0f / 16777216.0f;
  const float u0 = fmul(static_cast<float>(b.x >> 8), scale);
  const float u1 = fmul(static_cast<float>(b.y >> 8), scale);
  const float r = __fsqrt_rn(fmul(-2.0f, logf(fmaxf(u0, 1e-7f))));
  const float z = fmul(r, cosf(fmul((float)(2.0 * 3.14159265358979), u1)));
  const float sgn = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  return fmul(sgn, __fsqrt_rn(fabsf(z)));
}

// rb_post's geometry (ops/fused_rainbow.py:post_geometry): a block owns a
// tile of kPostTi in-rows x kPostTo out-columns of one [in][out] matrix, in
// block order the online net's four noisy layers and its trunk's w1
// (matrix 4, transposed only), then the target net's four noisy layers;
// one block more does the lanes' work.  kPostThreads threads a block, each
// drawing at most one factor or bias entry and holding kPostEpt of the
// tile's entries (16 x 32 at 256 threads: the fastest of the tiles and
// thread counts timed, PERF.md); 117 blocks, one wave on 132 SMs.
struct PostGeom {
  int ti, to, threads, blocks;
};
constexpr int kPostTi = 16;
constexpr int kPostTo = 32;
constexpr int kPostThreads = 256;
constexpr int kPostEpt = 2;
constexpr int kPostMatrices = 9;
static_assert(kH0 % kPostTi == 0 && kH1 % kPostTi == 0 && kPostTo <= kH1,
              "a tile's rows divide every matrix's");
static_assert(kPostThreads % 32 == 0 && kPostThreads >= kPostTi + 2 * kPostTo,
              "one draw a thread at most");
static_assert(kPostEpt * kPostThreads == kPostTi * kPostTo,
              "kPostEpt entries a thread");

__host__ __device__ constexpr int post_rows(int m) {
  return m == 4 ? kH0 : kH1;
}
__host__ __device__ constexpr int post_cols(int m) {
  return m == 4 ? kH1 : out_of(m % 5);
}
__host__ __device__ constexpr int post_tiles(int m) {
  return (post_rows(m) / kPostTi) * ((post_cols(m) + kPostTo - 1) / kPostTo);
}
__host__ __device__ constexpr int post_blocks() {
  int b = 1;
  for (int m = 0; m < kPostMatrices; ++m) b += post_tiles(m);
  return b;
}
inline bool post_geom_ok(PostGeom g) {
  return g.ti == kPostTi && g.to == kPostTo && g.threads == kPostThreads &&
         g.blocks == post_blocks();
}

// Each noise entry is drawn once per tile: the tile's kPostTi in-factors
// and kPostTo out-factors (and, in a tile of in-row 0, its kPostTo bias
// entries) by one thread each, with the counters of the plain fresh_noise (stream
// kStreamNoise + 12 net + 3 layer: in, out, bias); an entry is then
// eps = f_out * f_in, one rounding, the same bits as the plain outer
// product.  The tile's mu and sigma (of p, and for the target net of tp
// too) are loaded before the draws, and the target sync, decided by thread
// 0 of each block from tot and ep_step with the f32 rule, picks p or tp
// after the barrier.  The online net's tile of effective weights (and w1)
// is staged transposed in shared memory, so both its reads and the stores
// of W^T [out][in] are coalesced.  On a sync every block copies its share
// of tp := p (16 bytes a thread, the first load issued at the start).  The
// lanes' block scatters the PER priorities (pre ** alpha; duplicate picks
// write the same bits), reduces max(ce + 1e-5, 1e-8) over the B lanes once
// (fmaxf is order-free) into env row 13, writes the synced count to env
// row 11 and the episode total to tot[i + 1].
__global__ void __launch_bounds__(kPostThreads)
    rb_post_kernel(const float* __restrict__ p, float* __restrict__ tp,
                   float* __restrict__ eps, float* __restrict__ teps,
                   float* __restrict__ wp, float* __restrict__ wt,
                   float* __restrict__ wpt, float* __restrict__ env,
                   float* __restrict__ ring, int32_t* __restrict__ tot,
                   const int32_t* __restrict__ ep_step,
                   const float* __restrict__ ce,
                   const int32_t* __restrict__ sel, RbPostCfg c) {
  constexpr int TI = kPostTi, TO = kPostTo, nt = kPostThreads;
  __shared__ float fin[TI], fout[TO], tile[TO * (TI + 1)];
  __shared__ int sync_s, now_s;
  __shared__ float synced_s, lane_max[nt / 32];
  const int tid = threadIdx.x;
  if (tid == 0) {
    bool sync = false;
    float synced = c.synced0;
    int now = 0;
    if (c.check_sync) {
      const int before = tot[c.i];
      now = before + ep_step[c.i];
      const float chunks = floorf(fmul(__int2float_rn(now), c.inv_sync));
      if (c.i > 0)
        synced = fmaxf(synced,
                       floorf(fmul(__int2float_rn(before), c.inv_sync)));
      sync = chunks > synced;
      synced = fmaxf(synced, chunks);
    }
    sync_s = sync;
    now_s = now;
    synced_s = synced;
  }

  // The first share of the target copy, loaded before anything waits (the
  // sync is known only after the barrier; without one it is not stored).
  const float4* const p4 = reinterpret_cast<const float4*>(p);
  const int c0 = blockIdx.x * nt + tid;
  const float4 cp0 = c0 < kNumP / 4 ? p4[c0] : make_float4(0, 0, 0, 0);

  // The block's matrix and tile, found once: the walk unrolls over the
  // nine matrices with their tile counts as constants.
  int m = kPostMatrices, i0 = 0, j0 = 0, b = blockIdx.x;
#pragma unroll
  for (int k = 0; k < kPostMatrices; ++k) {
    const int tc = (post_cols(k) + TO - 1) / TO;
    if (m == kPostMatrices) {
      if (b < post_tiles(k)) {
        m = k;
        i0 = (b / tc) * TI;
        j0 = (b - (b / tc) * tc) * TO;
      } else {
        b -= post_tiles(k);
      }
    }
  }
  if (m < kPostMatrices) {
    const int net = m < 5 ? 0 : 1, l = m % 5;
    const int rows = post_rows(m), cols = post_cols(m);
    const bool noisy = l < 4, regen = noisy && c.regen;
    const int mu0 = noisy ? poff(l) : kIn * kH0 + kH0;  // w1 when l == 4
    const int w_sz = rows * cols, e0 = noisy ? eoff(l) : 0;
    float* const ep = net ? teps : eps;

    float mu[kPostEpt], sg[kPostEpt], tmu[kPostEpt], tsg[kPostEpt],
        eo[kPostEpt];
#pragma unroll
    for (int k = 0; k < kPostEpt; ++k) {
      const int q = tid + k * nt, i = q / TO, j = q - i * TO;
      mu[k] = sg[k] = tmu[k] = tsg[k] = eo[k] = 0.0f;
      if (j0 + j >= cols) continue;
      const int at = (i0 + i) * cols + j0 + j;
      mu[k] = p[mu0 + at];
      if (!noisy) continue;
      sg[k] = p[mu0 + w_sz + at];
      if (net) {
        tmu[k] = tp[mu0 + at];
        tsg[k] = tp[mu0 + w_sz + at];
      }
      if (!regen) eo[k] = ep[e0 + at];
    }

    // The factors; a bias thread keeps its entry in a register.
    const uint32_t s = kStreamNoise + 12u * net + 3u * l;
    const int jb = j0 + tid - TI - TO;
    const bool bias = noisy && i0 == 0 && tid >= TI + TO &&
                      tid < TI + 2 * TO && jb < cols;
    float eb = 0.0f;
    if (regen) {
      if (tid < TI) {
        fin[tid] = scaled_normal(c.step, i0 + tid, s, c.k0, c.k1);
      } else if (tid < TI + TO) {
        if (j0 + tid - TI < cols)
          fout[tid - TI] =
              scaled_normal(c.step, j0 + tid - TI, s + 1, c.k0, c.k1);
      } else if (bias) {
        eb = scaled_normal(c.step, jb, s + 2, c.k0, c.k1);
      }
    } else if (bias) {
      eb = ep[e0 + w_sz + jb];
    }
    __syncthreads();

    const bool from_tp = net == 1 && !sync_s;
    float* const weff = net ? wt : wp;
#pragma unroll
    for (int k = 0; k < kPostEpt; ++k) {
      const int q = tid + k * nt, i = q / TO, j = q - i * TO;
      if (j0 + j >= cols) continue;
      float w = mu[k];
      if (noisy) {
        const int at = (i0 + i) * cols + j0 + j;
        const float e = regen ? fmul(fout[j], fin[i]) : eo[k];
        if (regen) ep[e0 + at] = e;
        w = fadd(from_tp ? tmu[k] : mu[k],
                 fmul(from_tp ? tsg[k] : sg[k], e));
        weff[e0 + at] = w;
      }
      if (net == 0) tile[j * (TI + 1) + i] = w;
    }
    if (bias) {
      const int bm = mu0 + 2 * w_sz + jb;
      const float* const src = from_tp ? tp : p;
      if (regen) ep[e0 + w_sz + jb] = eb;
      weff[e0 + w_sz + jb] = fadd(src[bm], fmul(src[bm + cols], eb));
    }
    if (net == 0) {  // W^T [out][in] (w1^T [64][32]) for the next backward
      __syncthreads();
      for (int q = tid; q < TI * TO; q += nt) {
        const int j = q / TI, i = q - j * TI;
        if (j0 + j < cols)
          wpt[toff(l) + (j0 + j) * rows + i0 + i] = tile[j * (TI + 1) + i];
      }
    }
  } else {
    __syncthreads();  // sync_s, now_s and synced_s
  }

  if (sync_s) {  // post-update params to the target, 16 bytes a thread
    float4* const tp4 = reinterpret_cast<float4*>(tp);
    if (c0 < kNumP / 4) tp4[c0] = cp0;
    for (int q = c0 + gridDim.x * nt; q < kNumP / 4; q += gridDim.x * nt)
      tp4[q] = p4[q];
  }
  if (m < kPostMatrices) return;

  const size_t sN = static_cast<size_t>(c.n);
  if (c.per_wb) {
    float mx = -INFINITY;
    for (int b2 = tid; b2 < c.B; b2 += nt) {
      const float pre = fmaxf(fadd(ce[b2], 1e-5f), 1e-8f);
      ring[(static_cast<size_t>(sel[b2]) * kRbNumF + kRbNumF - 1) * sN +
           sel[c.B + b2]] = powx(pre, c.alpha);
      mx = fmaxf(mx, pre);
    }
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if ((tid & 31) == 0) lane_max[tid >> 5] = mx;
    __syncthreads();
    for (int w = 0; w < nt / 32; ++w) mx = fmaxf(mx, lane_max[w]);
    for (int l = tid; l < c.n; l += nt)
      env[13 * sN + l] = fmaxf(env[13 * sN + l], mx);
  }
  if (c.check_sync) {
    for (int l = tid; l < c.n; l += nt) env[11 * sN + l] = synced_s;
    if (tid == 0) tot[c.i + 1] = now_s;
  }
}

}  // namespace mgt

namespace mgt {

template <int RM, int RN>
cudaError_t launch_rb_act(const float* p, const float* wp, Net<float> onet,
                          MlpDims od, float* env, float* ring, float* met,
                          int32_t* ep_step, ActGeom g, RbActCfg ac,
                          EnvCfg cfg, cudaStream_t stream) {
  cudaError_t err = allow_smem(rb_act_kernel<RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  rb_act_kernel<RM, RN>
      <<<(ac.n + g.rows - 1) / g.rows, kQnetThreads, g.smem, stream>>>(
          p, wp, onet, od, env, ring, met, ep_step, g, ac, cfg);
  return cudaGetLastError();
}

}  // namespace mgt

// Kernel 1 of a step (rb_act_kernel) on `n` envs in the geometry (rows,
// rm x rn, resident, chunk, smem) of ops/fused_rainbow.py:act_geometry;
// opp_mode: kOppL0, kOppSelf or kOppFrozen (opp, an MLP of widths 10 ->
// opp_h1 -> opp_h2 -> 5).  A geometry its layout does not fit is refused
// (cudaErrorInvalidValue).
extern "C" int mgt_rb_act(const float* p, const float* wp, const float* opp,
                          float* env, float* ring, float* met,
                          int32_t* ep_step, int n, int rows, int rm, int rn,
                          int resident, int chunk, int smem, int opp_mode,
                          int roll, int has_eps, int draws, int random_start,
                          int per, int r_cur, int opp_h1, int opp_h2,
                          uint32_t step, uint32_t threshold, uint32_t thr70,
                          uint32_t k0, uint32_t k1, float scale, float alpha,
                          int max_steps, float r_first, float r_second,
                          float r_collision, float vel_penalty,
                          float time_penalty, cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0) return 0;
  const bool frozen = opp_mode == kOppFrozen;
  if (opp_mode < kOppL0 || opp_mode > kOppFrozen || (frozen && opp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpDims od{kIn, frozen ? opp_h1 : 1, frozen ? opp_h2 : 1, kA};
  const ActGeom g{rows, resident, chunk, smem};
  if (!rb_act_geom_ok(g, opp_mode == kOppSelf ? 2 : 1,
                      frozen ? &od : nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbActCfg ac{n, r_cur, opp_mode, roll, has_eps, draws, random_start,
                    per, step, threshold, thr70, k0, k1, scale, alpha};
  const EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
                   max_steps};
  const Net<float> onet = net_at<float>(frozen ? opp : p, od);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                     \
  case M * 16 + N:                                                         \
    return static_cast<int>(launch_rb_act<M, N>(p, wp, onet, od, env, ring, \
                                                met, ep_step, g, ac, cfg,  \
                                                stream));
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The PER pick of one learn (rb_per_pick_kernel), in the layout of
// ops/fused_rainbow.py:pick_geometry: kPickShared with `smem` bytes (at
// least pick_floats(R, n) floats), or kPickGlobal with a workspace `ws` of
// `ws_floats` floats (at least as many).  A geometry that does not fit is refused
// (cudaErrorInvalidValue).
extern "C" int mgt_rb_per_pick(const float* ring, const float* us,
                               int32_t* sel, float* wts, float* ws, int n,
                               int R, int B, int r_cur, int stored,
                               int n_step, int layout, int smem,
                               long long ws_floats, float inv_b, float beta,
                               cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0 || n % 128 != 0 || R <= 0 || B <= 0 ||
      static_cast<long long>(R) * n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbPickCfg c{n, R, B, r_cur, stored, n_step, inv_b, beta};
  const size_t need = pick_floats(R, n);
  if (layout == kPickShared) {
    if (need * sizeof(float) > static_cast<size_t>(smem))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = allow_smem(rb_per_pick_kernel<kPickShared>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rb_per_pick_kernel<kPickShared><<<1, kPickThreads, smem, stream>>>(
        ring, us, sel, wts, nullptr, c);
  } else if (layout == kPickGlobal) {
    if (ws == nullptr || smem != 0 || ws_floats < 0 ||
        static_cast<size_t>(ws_floats) < need)
      return static_cast<int>(cudaErrorInvalidValue);
    rb_per_pick_kernel<kPickGlobal><<<1, kPickThreads, 0, stream>>>(
        ring, us, sel, wts, ws, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace mgt {

template <int LANES>
cudaError_t launch_learn_fwd(RbNet pnet, RbNet tnet, const float* wpt,
                             const float* ring, const int32_t* rounds,
                             const int32_t* cols, const int32_t* sel,
                             const float* wts, const float* gpow, float* ws,
                             float* ce, RbLearnCfg lc, int smem,
                             cudaStream_t stream) {
  cudaError_t err = allow_smem(learn_fwd_kernel<LANES>, smem);
  if (err != cudaSuccess) return err;
  learn_fwd_kernel<LANES>
      <<<(lc.B + LANES - 1) / LANES, kLearnThreads, smem, stream>>>(
          pnet, tnet, wpt, ring, rounds, cols, sel, wts, gpow, ws, ce, lc);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_learn_grad(const float* ws, float* p, float* m, float* v,
                              const float* eps, float* loss, RbGradCfg gc,
                              int smem, cudaStream_t stream) {
  if (grad_smem(NT) > static_cast<size_t>(smem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(learn_grad_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  learn_grad_kernel<NT><<<grad_blocks(), NT, smem, stream>>>(ws, p, m, v, eps,
                                                             loss, gc);
  return cudaGetLastError();
}

}  // namespace mgt

// The learner's forward and backward of one learn (learn_fwd_kernel):
// `lanes` lanes a block, `smem` bytes of shared memory a block (checked
// against learn_smem); each lane's row to `ws` (B rows of kWsWidth
// floats) and its CE to `ce`.
extern "C" int mgt_rb_learn_fwd(const float* p, const float* tp,
                                const float* wp, const float* wt,
                                const float* wpt, const float* ring,
                                const int32_t* rounds, const int32_t* cols,
                                const int32_t* sel, const float* wts,
                                const float* gpow, float* ws, float* ce,
                                int n, int R, int B, int n_step, int per,
                                int faithful, float gamma, float scale,
                                float inv_b, int lanes, int smem,
                                cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || n_step < 1 || lanes < 1 ||
      learn_smem(lanes) > static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbLearnCfg lc{n, R, B, n_step, per, faithful, gamma, scale, inv_b};
  const RbNet pnet = rb_net(p, wp), tnet = rb_net(tp, wt);
  switch (lanes) {
#define MGT_CASE(L)                                                       \
  case L:                                                                 \
    return static_cast<int>(launch_learn_fwd<L>(pnet, tnet, wpt, ring,    \
                                                rounds, cols, sel, wts,   \
                                                gpow, ws, ce, lc, smem,   \
                                                stream));
    MGT_CASE(1) MGT_CASE(2) MGT_CASE(4) MGT_CASE(8)
#undef MGT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradients of one learn from `ws`, summed in tiles of `tile` lanes
// (8 or 16, dividing B), then Adam (learn_grad_kernel); `threads` threads
// a block.
extern "C" int mgt_rb_learn_grad(const float* ws, float* p, float* m,
                                 float* v, const float* eps, float* loss,
                                 int B, int tile, float lr, float b1,
                                 float b2, float omb1, float omb2,
                                 float eps_adam, float c1, float c2,
                                 int threads, int smem, cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || (tile != 8 && tile != 16) || B % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RbGradCfg gc{B, tile, {lr, b1, b2, omb1, omb2, eps_adam, c1, c2}};
  cudaError_t err = cudaErrorInvalidValue;
  switch (threads) {
#define MGT_CASE(T)                                                        \
  case T:                                                                  \
    err = launch_learn_grad<T>(ws, p, m, v, eps, loss, gc, smem, stream); \
    break;
    MGT_CASE(256) MGT_CASE(512) MGT_CASE(1024)
#undef MGT_CASE
  }
  return static_cast<int>(err);
}

// Noise, target sync, effective weights and PER write-back of step i
// (rb_post_kernel) in the geometry (ti x to tiles, threads, blocks) of
// ops/fused_rainbow.py:post_geometry; any other is refused
// (cudaErrorInvalidValue).
extern "C" int mgt_rb_post(const float* p, float* tp, float* eps, float* teps,
                           float* wp, float* wt, float* wpt, float* env,
                           float* ring, int32_t* tot, const int32_t* ep_step,
                           const float* ce, const int32_t* sel, int n, int R,
                           int B, int i, int regen, int per_wb,
                           int check_sync, int ti, int to, int threads,
                           int blocks, uint32_t k0, uint32_t k1,
                           uint32_t step, float alpha, float inv_sync,
                           float synced0, cudaStream_t stream) {
  using namespace mgt;
  if (!post_geom_ok(PostGeom{ti, to, threads, blocks}))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbPostCfg c{n,  R,  B,    i,     regen,    per_wb, check_sync,
                    k0, k1, step, alpha, inv_sync, synced0};
  rb_post_kernel<<<blocks, kPostThreads, 0, stream>>>(
      p, tp, eps, teps, wp, wt, wpt, env, ring, tot, ep_step, ce, sel, c);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: chip_smoke.py times it by CUDA-graph replay as the floor
// under rb_post's and rb_per_pick's times.  No path of the port launches it.
__global__ void rb_empty_kernel() {}

extern "C" int mgt_rb_empty(cudaStream_t stream) {
  rb_empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
