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
//   1. rb_act: a block owns `tile` envs.  The noisy dueling C51 forward of
//      the ego's scaled obs (rb_forward: trunk, four noisy layers read as
//      effective weights, the dueling combine, a softmax per action, E[Z]),
//      the first-occurrence argmax, the optional Phi(eps) pick; the
//      opponent: the same net on the left-rotated obs, L0, or a frozen MLP
//      (mlp.cuh) through the Phi(0.7) pick; the env step (env_math.cuh);
//      the unconditional [24] slab store (with PER its row 23 is
//      maxp ** alpha, maxp read before this step's learn); the metrics, the
//      per-lane episode count (env row 12), the step's finished episodes
//      added to ep_step (integer atomics: the total does not depend on the
//      order) and the auto-reset.
//   2. rb_per_pick (PER only, one block): validity of each ring slot by its
//      age, 128-lane chunk sums in lane order, their prefix in chunk order,
//      the B stratified targets, the inverse-CDF pick by a binary search
//      over the chunk prefix and a scan inside the chunk
//      (searchsorted(side='right'), clipped), the importance weights.
//   3. rb_learn: a block owns `tile` lanes of the batch.  The n-step
//      reconstruction from consecutive slabs, the target net's forward on
//      the bootstrap obs (selection and evaluation), the hat-form
//      projection with the faithful mask floor(b) != ceil(b), the online
//      forward, the CE on the clamped selected-action distribution, and the
//      hand backprop through the clamp (strict-inequality mask), the
//      softmax, the dueling combine, the four noisy layers and the trunk.
//      Each block writes its partial sums (its lanes in lane order) of the
//      trunk and mu gradients and of the weighted CE; each lane's CE goes
//      to `ce` for PER.
//   4. rb_adam: one thread per parameter sums the partials in block order,
//      forms a sigma gradient as dW * eps, and applies Adam (bias
//      corrections from the host, as in K5).
//   5. rb_post, every step: fresh factorised noise for both nets (after a
//      learn, outside greedy mode), the episodic target sync decided from
//      ep_step (tp := p when floor(total * (1 / sync_eps)) passes the
//      synced count, env row 11), the effective weights mu + sigma * eps of
//      both nets, and with PER the priority write-back
//      max(ce + 1e-5, 1e-8) ** alpha at the sampled slots (duplicates of a
//      slot share one ce, so any write order gives the same bits) and the
//      running max (env row 13).
//
// Every sum is one thread's, in index order from 0, with one rounding per
// multiply and per add (-fmad=false), and expf/logf/sqrtf/cosf are the
// accurate library functions; x ** a is expf(a * logf(max(x, 1e-30))).
// Two runs on the same inputs give the same bits, and the plain version
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
// ring, env rows and the four parameter sets are a few MB, so K8 is bound
// by operations.  The learner's grid is small (B / 16 blocks) and every sum
// is a scalar chain kept for exact agreement with the plain version, so K8
// sits far from that bound; the measured times are in PERF.md.
#include <cstdint>

#include "env_math.cuh"
#include "learn_math.cuh"
#include "mlp.cuh"
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

// Per-row scratch of one forward, in shared memory.
struct RbFwd {
  float *h1, *h2, *hv1, *ha1, *zv2, *za2, *dist, *q;
  static constexpr int kFloats = kH0 + 3 * kH1 + kAtoms + 2 * kA * kAtoms + kA;
  __device__ static RbFwd at(float* base, int rows) {
    RbFwd f;
    f.h1 = base;
    f.h2 = f.h1 + rows * kH0;
    f.hv1 = f.h2 + rows * kH1;
    f.ha1 = f.hv1 + rows * kH1;
    f.zv2 = f.ha1 + rows * kH1;
    f.za2 = f.zv2 + rows * kAtoms;
    f.dist = f.za2 + rows * kA * kAtoms;
    f.q = f.dist + rows * kA * kAtoms;
    return f;
  }
};

// y[r][j] = sum_k x[r][k] * w[k][j] (k order, from 0) + b[j], for i in
// [i0, i0 + rows * J) of a combined index space, each thread its outputs.
__device__ __forceinline__ float dense_out(const float* x, int K,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int J, int r, int j) {
  const float* xr = x + r * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = fadd(acc, fmul(xr[k], w[k * J + j]));
  return fadd(acc, b[j]);
}

// The forward of `rows` rows of x [rows][10] (already scaled): the hidden
// layers, dist [rows][A][ATOMS] and q [rows][A].  Starts and ends with a
// block-wide barrier.
__device__ void rb_forward(const float* x, int rows, const RbNet& net,
                           const RbFwd& f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  for (int i = tid; i < rows * kH0; i += nt) {
    const int r = i / kH0, j = i - r * kH0;
    f.h1[i] = relu(dense_out(x, kIn, net.w0, net.b0, kH0, r, j));
  }
  __syncthreads();
  for (int i = tid; i < rows * kH1; i += nt) {
    const int r = i / kH1, j = i - r * kH1;
    f.h2[i] = relu(dense_out(f.h1, kH0, net.w1, net.b1, kH1, r, j));
  }
  __syncthreads();
  for (int i = tid; i < 2 * rows * kH1; i += nt) {  // value1, advantage1
    const int s = i / (rows * kH1), i2 = i - s * rows * kH1;
    const int r = i2 / kH1, j = i2 - r * kH1;
    const int l = s == 0 ? 0 : 2;
    (s == 0 ? f.hv1 : f.ha1)[i2] =
        relu(dense_out(f.h2, kH1, net.W[l], net.B[l], kH1, r, j));
  }
  __syncthreads();
  const int nv = rows * kAtoms, na = rows * kA * kAtoms;
  for (int i = tid; i < nv + na; i += nt) {  // value2, advantage2
    if (i < nv) {
      const int r = i / kAtoms, j = i - r * kAtoms;
      f.zv2[i] = dense_out(f.hv1, kH1, net.W[1], net.B[1], kAtoms, r, j);
    } else {
      const int i2 = i - nv, r = i2 / (kA * kAtoms), j = i2 - r * kA * kAtoms;
      f.za2[i2] = dense_out(f.ha1, kH1, net.W[3], net.B[3], kA * kAtoms, r,
                            j);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * kA; i += nt) {  // dueling combine + softmax
    const int r = i / kA, a = i - r * kA;
    const float* adv = f.za2 + r * kA * kAtoms;
    const float* zv = f.zv2 + r * kAtoms;
    float* d = f.dist + r * kA * kAtoms + a * kAtoms;
    float lm = 0.0f;
    for (int j = 0; j < kAtoms; ++j) {
      float mean = 0.0f;
      for (int b = 0; b < kA; ++b) mean = fadd(mean, adv[b * kAtoms + j]);
      mean = fmul(mean, 0.2f);
      const float logit = __fsub_rn(fadd(zv[j], adv[a * kAtoms + j]), mean);
      d[j] = logit;
      if (j == 0 || logit > lm) lm = logit;
    }
    float s = 0.0f;
    for (int j = 0; j < kAtoms; ++j) {
      d[j] = expf(__fsub_rn(d[j], lm));
      s = fadd(s, d[j]);
    }
    for (int j = 0; j < kAtoms; ++j) d[j] = __fdiv_rn(d[j], s);
  }
  __syncthreads();
  for (int i = tid; i < rows * kA; i += nt) {  // E[Z]
    const float* d = f.dist + i * kAtoms;
    float acc = 0.0f;
    for (int j = 0; j < kAtoms; ++j) acc = fadd(acc, fmul(d[j], zsup(j)));
    f.q[i] = acc;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. act / env / store
// ---------------------------------------------------------------------------

struct RbActCfg {
  int n, r_cur, opp, roll, has_eps, draws, random_start, per;
  uint32_t step, threshold, thr70, k0, k1;
  float scale, alpha;
};

__global__ void __launch_bounds__(kRbThreads)
rb_act_kernel(RbNet pnet, Net<float> onet, MlpDims od, float* __restrict__ env,
              float* __restrict__ ring, float* __restrict__ met,
              int32_t* __restrict__ ep_step, int tile, RbActCfg ac,
              EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x1 = reinterpret_cast<float*>(smem);  // [tile][10] ego, scaled
  float* x2 = x1 + tile * kIn;                 // [tile][10] opponent
  float* q2 = x2 + tile * kIn;                 // [tile][A] frozen MLP
  RbFwd f = RbFwd::at(q2 + tile * kA, tile);
  float* s_in = f.q + tile * kA;               // frozen MLP scratch
  float* s_h1 = s_in + tile * od.in;
  float* s_h2 = s_h1 + tile * od.h1;

  const int env0 = blockIdx.x * tile;
  const int rows = min(tile, ac.n - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const int lane = env0 + e;
  const size_t sN = static_cast<size_t>(ac.n);

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
    for (int k = 0; k < 10; ++k) {
      o[k] = pre[k];
      x1[e * kIn + k] = fmul(pre[k], ac.scale);
      // Self-play: state[roll:] + state[:roll] (a left rotation), scaled;
      // frozen: the half-swapped raw obs.
      x2[e * kIn + k] = ac.opp == 1 ? fmul(pre[(k + ac.roll) % 10], ac.scale)
                                    : pre[(k + 5) % 10];
    }
  }
  rb_forward(x1, rows, pnet, f);
  int a1 = owner ? argmax0(f.q + e * kA, kA) : 0;
  int a2 = -1;
  if (ac.opp == 1) {
    rb_forward(x2, rows, pnet, f);
    if (owner) a2 = argmax0(f.q + e * kA, kA);
  } else if (ac.opp == 2) {
    mlp_tile<float>(x2, rows, od, onet, s_in, s_h1, s_h2, q2);
    if (owner) a2 = argmax0(q2 + e * kA, kA);
  }

  bool done = false;
  if (owner) {
    if (ac.has_eps) {
      Bits4 b = draw(ac.step, static_cast<uint32_t>(lane), kStreamActions,
                     ac.k0, ac.k1);
      a1 = phi_select(a1, b.x, b.y, ac.threshold, kA);
      if (ac.opp == 1) a2 = phi_select(a2, b.z, b.w, ac.threshold, kA);
    }
    if (ac.opp == 2 && ac.draws) {
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

__device__ __forceinline__ float per_prio(const float* ring, const RbPickCfg& c,
                                          int r, int lane) {
  const int age = (c.r_cur - r + c.R) % c.R;
  if (age < c.n_step - 1 || age > c.stored - 1) return 0.0f;
  return ring[(static_cast<size_t>(r) * kRbNumF + kRbNumF - 1) * c.n + lane];
}

__global__ void rb_per_pick_kernel(const float* __restrict__ ring,
                                   const float* __restrict__ us,
                                   int32_t* __restrict__ sel,
                                   float* __restrict__ wts, RbPickCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = c.n / 128, C = c.R * G;
  float* incl = reinterpret_cast<float*>(smem);  // [C] inclusive prefix
  float* excl = incl + C;                        // [C] exclusive prefix
  float* cmin = excl + C;                        // [C] least priority > 0
  __shared__ float total, pmin;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int ch = tid; ch < C; ch += nt) {
    const int r = ch / G, l0 = (ch - r * G) * 128;
    float acc = 0.0f, mn = INFINITY;
    for (int j = 0; j < 128; ++j) {
      const float v = per_prio(ring, c, r, l0 + j);
      acc = fadd(acc, v);
      if (v > 0.0f) mn = fminf(mn, v);
    }
    incl[ch] = acc;
    cmin[ch] = mn;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f, mn = INFINITY;
    for (int ch = 0; ch < C; ++ch) {
      excl[ch] = run;
      run = fadd(run, incl[ch]);
      incl[ch] = run;
      mn = fminf(mn, cmin[ch]);
    }
    total = run;
    pmin = mn;
  }
  __syncthreads();
  const float nvalid = fmul(static_cast<float>(c.stored - (c.n_step - 1)),
                            static_cast<float>(c.n));
  const float ratio = __fdiv_rn(nvalid, total);
  const float wmax = powx(fmul(pmin, ratio), c.beta);
  for (int b = tid; b < c.B; b += nt) {
    const float u = fmul(fadd(static_cast<float>(b), us[0]),
                         fmul(total, c.inv_b));
    // Chunks whose inclusive prefix is <= u lie wholly at or below u.
    int lo = 0, hi = C;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (incl[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    long long idx = static_cast<long long>(lo) * 128;
    if (lo < C) {
      const int r = lo / G, l0 = (lo - r * G) * 128;
      float loc = 0.0f;
      for (int j = 0; j < 128; ++j) {
        loc = fadd(loc, per_prio(ring, c, r, l0 + j));
        if (fadd(excl[lo], loc) <= u) ++idx;
        else break;
      }
    }
    const long long last = static_cast<long long>(c.R) * c.n - 1;
    if (idx > last) idx = last;
    const int r = static_cast<int>(idx / c.n);
    const int lane = static_cast<int>(idx - static_cast<long long>(r) * c.n);
    sel[b] = r;
    sel[c.B + b] = lane;
    const float p = per_prio(ring, c, r, lane);
    wts[b] = fmul(powx(fmul(p, ratio), -c.beta), wmax);
  }
}

// ---------------------------------------------------------------------------
// 3. learner partial sums
// ---------------------------------------------------------------------------

struct RbLearnCfg {
  int n, R, B, n_step, per, faithful;
  float gamma, scale, inv_b;
};

__global__ void __launch_bounds__(kRbThreads)
rb_learn_kernel(RbNet pnet, RbNet tnet, const float* __restrict__ ring,
                const int32_t* __restrict__ rounds,
                const int32_t* __restrict__ cols,
                const int32_t* __restrict__ sel, const float* __restrict__ wts,
                const float* __restrict__ gpow, float* __restrict__ work,
                float* __restrict__ ce_out, int tile, RbLearnCfg lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile;
  float* x = reinterpret_cast<float*>(smem);  // [L][10] scaled obs
  float* xn = x + L * kIn;                    // [L][10] scaled bootstrap obs
  float* act = xn + L * kIn;                  // [L]
  float* rew = act + L;
  float* dn = rew + L;
  float* wgt = dn + L;
  float* sv = wgt + L;                        // [L] sum_j g * dsel
  float* cew = sv + L;                        // [L] ce * w
  RbFwd f = RbFwd::at(cew + L, L);
  float* proj = f.q + L * kA;                 // [L][51]
  float* tmp = proj + L * kAtoms;             // [L][51] mass, then log c
  float* bk = tmp + L * kAtoms;               // [L][51] b, then g
  float* dsel = bk + L * kAtoms;              // [L][51]
  float* dl = dsel + L * kAtoms;              // [L][51]
  float* dza2 = dl + L * kAtoms;              // [L][255]
  float* dzv1 = dza2 + L * kA * kAtoms;       // [L][64]
  float* dza1 = dzv1 + L * kH1;               // [L][64]
  float* dz2 = dza1 + L * kH1;                // [L][64]
  float* dz1 = dz2 + L * kH1;                 // [L][32]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * L;
  const size_t sN = static_cast<size_t>(lc.n);

  // Gather and the n-step reconstruction (nstep_batch_from_slabs).
  for (int r = tid; r < L; r += nt) {
    const int b = b0 + r;
    int round, lane;
    if (lc.per) {
      round = sel[b];
      lane = sel[lc.B + b];
    } else {
      round = rounds[0];
      lane = cols[0] * lc.B + b;
    }
    float ret = 0.0f, alive = 1.0f, nxt[10];
    for (int k = 0; k < 10; ++k) nxt[k] = 0.0f;
    for (int k = 0; k < lc.n_step; ++k) {
      const int rk = (round + k) % lc.R;
      const float* s = ring + static_cast<size_t>(rk) * kRbNumF * sN + lane;
      const float done_k = s[22 * sN];
      ret = fadd(ret, fmul(fmul(gpow[k], s[21 * sN]), alive));
      const float sl = k < lc.n_step - 1 ? fmul(alive, done_k) : alive;
      for (int q = 0; q < 10; ++q)
        nxt[q] = fadd(nxt[q], fmul(sl, s[(10 + q) * sN]));
      alive = fmul(alive, __fsub_rn(1.0f, done_k));
    }
    const float* s0 = ring + static_cast<size_t>(round) * kRbNumF * sN + lane;
    for (int q = 0; q < 10; ++q) {
      x[r * kIn + q] = fmul(s0[q * sN], lc.scale);
      xn[r * kIn + q] = fmul(nxt[q], lc.scale);
    }
    act[r] = s0[20 * sN];
    rew[r] = ret;
    dn[r] = alive < 0.5f ? 1.0f : 0.0f;
    wgt[r] = lc.per ? wts[b] : 1.0f;
  }

  // Target: selection and evaluation through the target net, projection.
  rb_forward(xn, L, tnet, f);
  for (int i = tid; i < L * kAtoms; i += nt) {
    const int r = i / kAtoms, k = i - r * kAtoms;
    const int star = argmax0(f.q + r * kA, kA);
    const float np_ = f.dist[r * kA * kAtoms + star * kAtoms + k];
    const float z = zsup(k);
    float mass = lc.faithful ? fmul(np_, z) : np_;
    const float nd = __fsub_rn(1.0f, dn[r]);
    const float tz =
        fminf(fmaxf(fadd(rew[r], fmul(fmul(nd, lc.gamma), z)), -10.0f),
              10.0f);
    const float bb = fmul(__fsub_rn(tz, -10.0f), 2.5f);
    if (lc.faithful) mass = fmul(mass, floorf(bb) != ceilf(bb) ? 1.0f : 0.0f);
    tmp[i] = mass;
    bk[i] = bb;
  }
  __syncthreads();
  for (int i = tid; i < L * kAtoms; i += nt) {
    const int r = i / kAtoms, a = i - r * kAtoms;
    const float fi = static_cast<float>(a);
    float acc = 0.0f;
    for (int k = 0; k < kAtoms; ++k) {
      const float hat =
          fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(bk[r * kAtoms + k], fi))),
                0.0f);
      acc = fadd(acc, fmul(tmp[r * kAtoms + k], hat));
    }
    proj[i] = acc;
  }

  // Online forward, CE and its gradient w.r.t. the selected distribution.
  rb_forward(x, L, pnet, f);
  for (int i = tid; i < L * kAtoms; i += nt) {
    const int r = i / kAtoms, j = i - r * kAtoms;
    const int a = static_cast<int>(act[r]);
    const float d = f.dist[r * kA * kAtoms + a * kAtoms + j];
    const float c = fminf(fmaxf(d, 0.01f), 0.99f);
    const float inr = (d > 0.01f && d < 0.99f) ? 1.0f : 0.0f;
    dsel[i] = d;
    tmp[i] = logf(c);
    bk[i] = fmul(fmul(-__fdiv_rn(proj[i], c), inr), fmul(wgt[r], lc.inv_b));
  }
  __syncthreads();
  for (int r = tid; r < L; r += nt) {
    float acc = 0.0f, s = 0.0f;
    for (int j = 0; j < kAtoms; ++j) {
      acc = fadd(acc, fmul(proj[r * kAtoms + j], tmp[r * kAtoms + j]));
      s = fadd(s, fmul(bk[r * kAtoms + j], dsel[r * kAtoms + j]));
    }
    const float ce = -acc;
    ce_out[b0 + r] = ce;
    cew[r] = fmul(ce, wgt[r]);
    sv[r] = s;
  }
  __syncthreads();
  for (int i = tid; i < L * kAtoms; i += nt) {
    const int r = i / kAtoms;
    dl[i] = __fsub_rn(fmul(dsel[i], bk[i]), fmul(dsel[i], sv[r]));
  }
  __syncthreads();
  for (int i = tid; i < L * kA * kAtoms; i += nt) {  // dueling backward
    const int r = i / (kA * kAtoms), ra = i - r * kA * kAtoms;
    const int a = ra / kAtoms, j = ra - a * kAtoms;
    const float oh = a == static_cast<int>(act[r]) ? 1.0f : 0.0f;
    dza2[i] = fmul(__fsub_rn(oh, 0.2f), dl[r * kAtoms + j]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * L * kH1; i += nt) {  // value1 / advantage1 outs
    const int s = i / (L * kH1), i2 = i - s * L * kH1;
    const int r = i2 / kH1, k = i2 - r * kH1;
    float acc = 0.0f;
    if (s == 0) {
      const float* W = pnet.W[1] + k * kAtoms;
      for (int j = 0; j < kAtoms; ++j)
        acc = fadd(acc, fmul(W[j], dl[r * kAtoms + j]));
      dzv1[i2] = fmul(acc, mask(f.hv1[i2]));
    } else {
      const float* W = pnet.W[3] + k * kA * kAtoms;
      for (int j = 0; j < kA * kAtoms; ++j)
        acc = fadd(acc, fmul(W[j], dza2[r * kA * kAtoms + j]));
      dza1[i2] = fmul(acc, mask(f.ha1[i2]));
    }
  }
  __syncthreads();
  for (int i = tid; i < L * kH1; i += nt) {  // trunk layer 2
    const int r = i / kH1, k = i - r * kH1;
    const float* Wv = pnet.W[0] + k * kH1;
    const float* Wa = pnet.W[2] + k * kH1;
    float av = 0.0f, aa = 0.0f;
    for (int j = 0; j < kH1; ++j) av = fadd(av, fmul(Wv[j], dzv1[r * kH1 + j]));
    for (int j = 0; j < kH1; ++j) aa = fadd(aa, fmul(Wa[j], dza1[r * kH1 + j]));
    dz2[i] = fmul(fadd(av, aa), mask(f.h2[i]));
  }
  __syncthreads();
  for (int i = tid; i < L * kH0; i += nt) {  // trunk layer 1
    const int r = i / kH0, k = i - r * kH0;
    const float* W = pnet.w1 + k * kH1;
    float acc = 0.0f;
    for (int j = 0; j < kH1; ++j) acc = fadd(acc, fmul(W[j], dz2[r * kH1 + j]));
    dz1[i] = fmul(acc, mask(f.h1[i]));
  }
  __syncthreads();

  // This block's partial sums over its lanes, in lane order.
  float* out = work + static_cast<size_t>(blockIdx.x) * (kNumG + 1);
  for (int gi = tid; gi <= kNumG; gi += nt) {
    const float *h, *dz;
    int K, J, idx;
    bool bias;
    if (gi == kNumG) {
      float acc = 0.0f;
      for (int r = 0; r < L; ++r) acc = fadd(acc, cew[r]);
      out[gi] = acc;
      continue;
    }
    if (gi < kTrunkP) {
      const int w0n = kIn * kH0, w1o = w0n + kH0, w1n = kH0 * kH1;
      if (gi < w0n) {
        h = x; K = kIn; dz = dz1; J = kH0; idx = gi; bias = false;
      } else if (gi < w1o) {
        dz = dz1; J = kH0; idx = gi - w0n; bias = true; h = nullptr; K = 0;
      } else if (gi < w1o + w1n) {
        h = f.h1; K = kH0; dz = dz2; J = kH1; idx = gi - w1o; bias = false;
      } else {
        dz = dz2; J = kH1; idx = gi - w1o - w1n; bias = true; h = nullptr;
        K = 0;
      }
    } else {
      const int e = gi - kTrunkP;
      int l = 3;
      while (e < eoff(l)) --l;
      const int loc = e - eoff(l);
      J = out_of(l);
      K = kH1;
      const float* hs[4] = {f.h2, f.hv1, f.h2, f.ha1};
      const float* ds[4] = {dzv1, dl, dza1, dza2};
      h = hs[l];
      dz = ds[l];
      bias = loc >= kH1 * J;
      idx = bias ? loc - kH1 * J : loc;
    }
    float acc = 0.0f;
    if (bias) {
      for (int r = 0; r < L; ++r) acc = fadd(acc, dz[r * J + idx]);
    } else {
      const int k = idx / J, j = idx - k * J;
      for (int r = 0; r < L; ++r)
        acc = fadd(acc, fmul(h[r * K + k], dz[r * J + j]));
    }
    out[gi] = acc;
  }
}

// ---------------------------------------------------------------------------
// 4. Adam
// ---------------------------------------------------------------------------

struct RbAdamCfg {
  int tiles, B;
  AdamHyper h;
};

// The gradient index of parameter k and, for a sigma, its noise element
// (-1 otherwise).
__device__ __forceinline__ int grad_index(int k, int& e) {
  e = -1;
  if (k < kTrunkP) return k;
  int l = 3;
  while (k < poff(l)) --l;
  const int j = k - poff(l), w = kH1 * out_of(l), o = out_of(l);
  const int base = eoff(l);
  if (j < w) return kTrunkP + base + j;
  if (j < 2 * w) {
    e = base + j - w;
    return kTrunkP + e;
  }
  if (j < 2 * w + o) return kTrunkP + base + w + (j - 2 * w);
  e = base + w + (j - 2 * w - o);
  return kTrunkP + e;
}

__global__ void rb_adam_kernel(const float* __restrict__ work,
                               float* __restrict__ p, float* __restrict__ m,
                               float* __restrict__ v,
                               const float* __restrict__ eps,
                               float* __restrict__ loss, RbAdamCfg c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > kNumP) return;
  int e = -1;
  const int gi = k == kNumP ? kNumG : grad_index(k, e);
  float g = sum_partials(work, c.tiles, kNumG + 1, gi);
  if (k == kNumP) {
    *loss = __fdiv_rn(g, static_cast<float>(c.B));
    return;
  }
  if (e >= 0) g = fmul(g, eps[e]);
  adam_step(g, p, m, v, k, c.h);
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

// Fresh noise of element e of net `net` (0 online, 1 target).
__device__ float fresh_eps(int e, int net, const RbPostCfg& c) {
  int l = 3;
  while (e < eoff(l)) --l;
  const int j = e - eoff(l), o = out_of(l), w = kH1 * o;
  const uint32_t s = kStreamNoise + 12u * net + 3u * l;
  if (j < w) {
    const int in = j / o, out = j - in * o;
    return fmul(scaled_normal(c.step, out, s + 1, c.k0, c.k1),
                scaled_normal(c.step, in, s, c.k0, c.k1));
  }
  return scaled_normal(c.step, j - w, s + 2, c.k0, c.k1);
}

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

__global__ void rb_post_kernel(const float* __restrict__ p,
                               float* __restrict__ tp, float* __restrict__ eps,
                               float* __restrict__ teps,
                               float* __restrict__ wp, float* __restrict__ wt,
                               float* __restrict__ env,
                               float* __restrict__ ring,
                               int32_t* __restrict__ tot,
                               const int32_t* __restrict__ ep_step,
                               const float* __restrict__ ce,
                               const int32_t* __restrict__ sel, RbPostCfg c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const size_t sN = static_cast<size_t>(c.n);
  bool sync = false;
  float synced = c.synced0;
  if (c.check_sync) {  // the same decision in every thread
    const int before = tot[c.i], now = before + ep_step[c.i];
    const float chunks = floorf(fmul(__int2float_rn(now), c.inv_sync));
    if (c.i > 0)
      synced = fmaxf(synced,
                     floorf(fmul(__int2float_rn(before), c.inv_sync)));
    sync = chunks > synced;
    synced = fmaxf(synced, chunks);
    if (k == 0) tot[c.i + 1] = now;
  }
  if (k < kNumP && sync) tp[k] = p[k];  // post-update params to the target
  if (k < 2 * kNumE) {
    const int net = k / kNumE, e = k - net * kNumE;
    float* ep = net ? teps : eps;
    if (c.regen) ep[e] = fresh_eps(e, net, c);
    int mu, sg;
    mu_sigma(e, mu, sg);
    const float* src = (net == 1 && !sync) ? tp : p;
    (net ? wt : wp)[e] = fadd(src[mu], fmul(src[sg], ep[e]));
  }
  if (c.per_wb) {
    for (int b = k; b < c.B; b += stride) {
      const float pre = fmaxf(fadd(ce[b], 1e-5f), 1e-8f);
      ring[(static_cast<size_t>(sel[b]) * kRbNumF + kRbNumF - 1) * sN +
           sel[c.B + b]] = powx(pre, c.alpha);
    }
    for (int l = k; l < c.n; l += stride) {
      float mx = env[13 * sN + l];
      for (int b = 0; b < c.B; ++b)
        mx = fmaxf(mx, fmaxf(fadd(ce[b], 1e-5f), 1e-8f));
      env[13 * sN + l] = mx;
    }
  }
  if (c.check_sync)
    for (int l = k; l < c.n; l += stride) env[11 * sN + l] = synced;
}

}  // namespace mgt

extern "C" int mgt_rb_act(const float* p, const float* wp, const float* opp,
                          float* env, float* ring, float* met,
                          int32_t* ep_step, int n, int tile, int opp_mode,
                          int roll, int has_eps, int draws, int random_start,
                          int per, int r_cur, int opp_h1, int opp_h2,
                          uint32_t step, uint32_t threshold, uint32_t thr70,
                          uint32_t k0, uint32_t k1, float scale, float alpha,
                          int max_steps, float r_first, float r_second,
                          float r_collision, float vel_penalty,
                          float time_penalty, cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0) return 0;
  if (tile <= 0 || tile > kRbThreads || (opp_mode == 2 && opp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDims od{kIn, opp_mode == 2 ? opp_h1 : 1, opp_mode == 2 ? opp_h2 : 1, kA};
  RbActCfg ac{n, r_cur, opp_mode, roll, has_eps, draws, random_start, per,
              step, threshold, thr70, k0, k1, scale, alpha};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  const size_t smem = static_cast<size_t>(tile) *
                      (2 * kIn + kA + RbFwd::kFloats + od.in + od.h1 + od.h2) *
                      sizeof(float);
  cudaError_t err = allow_smem(rb_act_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Net<float> onet = net_at<float>(opp_mode == 2 ? opp : p, od);
  rb_act_kernel<<<(n + tile - 1) / tile, kRbThreads, smem, stream>>>(
      rb_net(p, wp), onet, od, env, ring, met, ep_step, tile, ac, cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_rb_per_pick(const float* ring, const float* us,
                               int32_t* sel, float* wts, int n, int R, int B,
                               int r_cur, int stored, int n_step, float inv_b,
                               float beta, cudaStream_t stream) {
  using namespace mgt;
  if (n <= 0 || n % 128 != 0 || R <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RbPickCfg c{n, R, B, r_cur, stored, n_step, inv_b, beta};
  const size_t smem = static_cast<size_t>(3) * R * (n / 128) * sizeof(float);
  cudaError_t err = allow_smem(rb_per_pick_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rb_per_pick_kernel<<<1, 1024, smem, stream>>>(ring, us, sel, wts, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_rb_learn(const float* p, const float* tp, const float* wp,
                            const float* wt, const float* ring,
                            const int32_t* rounds, const int32_t* cols,
                            const int32_t* sel, const float* wts,
                            const float* gpow, float* work, float* ce, int n,
                            int R, int B, int tile, int n_step, int per,
                            int faithful, float gamma, float scale,
                            float inv_b, cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0 || tile <= 0 || B % tile != 0 || n_step < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RbLearnCfg lc{n, R, B, n_step, per, faithful, gamma, scale, inv_b};
  const size_t smem =
      static_cast<size_t>(tile) *
      (2 * kIn + 6 + RbFwd::kFloats + 5 * kAtoms + kA * kAtoms + 3 * kH1 +
       kH0) *
      sizeof(float);
  cudaError_t err = allow_smem(rb_learn_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rb_learn_kernel<<<B / tile, kRbThreads, smem, stream>>>(
      rb_net(p, wp), rb_net(tp, wt), ring, rounds, cols, sel, wts, gpow, work,
      ce, tile, lc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_rb_adam(const float* work, float* p, float* m, float* v,
                           const float* eps, float* loss, int tiles, int B,
                           float lr, float b1, float b2, float omb1,
                           float omb2, float eps_adam, float c1, float c2,
                           cudaStream_t stream) {
  using namespace mgt;
  RbAdamCfg c{tiles, B, {lr, b1, b2, omb1, omb2, eps_adam, c1, c2}};
  const int threads = 256;
  rb_adam_kernel<<<(kNumP + threads) / threads, threads, 0, stream>>>(
      work, p, m, v, eps, loss, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgt_rb_post(const float* p, float* tp, float* eps, float* teps,
                           float* wp, float* wt, float* env, float* ring,
                           int32_t* tot, const int32_t* ep_step,
                           const float* ce, const int32_t* sel, int n, int R,
                           int B, int i, int regen, int per_wb,
                           int check_sync, uint32_t k0, uint32_t k1,
                           uint32_t step, float alpha, float inv_sync,
                           float synced0, cudaStream_t stream) {
  using namespace mgt;
  RbPostCfg c{n, R, B, i, regen, per_wb, check_sync, k0, k1, step, alpha,
              inv_sync, synced0};
  const int threads = 256;
  rb_post_kernel<<<(kNumP + threads - 1) / threads, threads, 0, stream>>>(
      p, tp, eps, teps, wp, wt, env, ring, tot, ep_step, ce, sel, c);
  return static_cast<int>(cudaGetLastError());
}
