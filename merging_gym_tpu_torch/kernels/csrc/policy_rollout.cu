// K6: the learned-policy rollout as one launch.
//
// Replaces merging_gym_tpu/ops/fused_policy_rollout.py:_kernel (with its
// helpers _mlp_t, _argmax0 and _select).  Per step, both players' Q-nets
// act on the pre-step observation (player 2 on the half-swapped view, or
// L0), the actions are picked greedily or by the Phi(eps)-greedy quirk, the
// env steps and auto-resets, and only the events are written.
//
// Bound on an H100: 2 nets x 2 x 22,500 flops per env-step against 28 B
// of output, so the kernel is bound by f32 operations on the CUDA cores;
// at 4,096 envs x 2,600 steps that is 958 GFLOP.  The sums must equal the
// plain version's bit for bit (no FMA, no tensor cores, no split-k), so a
// multiply and an add are two instructions and the kernel reaches at most
// half of that bound.  Its measured time beside the bound is in PERF.md
// (chip_smoke.py).
//
// What the design does about it.  A block owns `rows` envs (chosen on the
// host from N and the SM count, ops/fused_policy_rollout.py:policy_geometry:
// 32 at 4,096 envs, 128 blocks, one a SM), and its 256 threads run each
// layer on qnet_tiled.cuh's register micro-tiles, RM x RN independent
// in-order chains a thread.  Where both nets fit in shared memory beside
// the activation tiles (the f32 reference nets, 2 x 91 KB at 32 envs),
// they are copied in once at the start of the launch (`resident`) and every
// step reads them from there; wider nets stream through two weight
// buffers every step, as K3's forward does (qnet_layers).  The two nets
// run one after the other on one set of h1/h2 tiles.  The env stays one
// thread per env: its state and cached coordinates live in the registers
// of thread `env % rows` (one warp at 32 envs), which writes the
// observation straight into the nets' input tiles.
#include <cstdint>

#include "env_math.cuh"
#include "philox.cuh"
#include "qnet_tiled.cuh"

namespace mgt {

struct PolicyCfg {
  int p2_mlp, greedy, random_start;
  uint32_t threshold, k0, k1;
};

// Launch geometry from the host: envs per block, weights resident or
// streamed, elements per weight buffer (streamed), shared bytes per block.
struct PolicyGeom {
  int rows, resident, chunk, smem;
};

// Byte offsets of a block's shared memory: the resident nets (NetSmem
// each) or the two weight buffers, one input tile per net, the h1 and h2
// tiles the nets share, and each net's f32 q (ops/fused_policy_rollout.py:
// policy_smem mirrors it).
struct PolicySmem {
  size_t in1, in2, h1, h2, q1, q2, total;
  __host__ __device__ PolicySmem(MlpDims d, PolicyGeom g, int elem,
                                 int nets) {
    const size_t rows = static_cast<size_t>(g.rows);
    const size_t in_tile = align16(rows * act_stride(d.in) * elem);
    in1 = g.resident ? nets * NetSmem(d, elem).bytes
                     : align16(2 * static_cast<size_t>(g.chunk) * elem);
    in2 = in1 + in_tile;
    h1 = in2 + (nets == 2 ? in_tile : 0);
    h2 = h1 + align16(rows * act_stride(d.h1) * elem);
    q1 = h2 + align16(rows * act_stride(d.h2) * elem);
    q2 = q1 + align16(rows * d.a * sizeof(float));
    total = q2 + (nets == 2 ? rows * d.a * sizeof(float) : 0);
  }
};

constexpr int kPolicyRowsMax = 32;  // owners are the first `rows` threads

// Whether the host's geometry suits this layout: rows an owner thread
// each, a streamed net's buffers hold a k-row of its widest layer and the
// second one starts 16-byte aligned, and the layout fits the bytes the host
// sized.
template <typename T>
inline bool policy_geom_ok(MlpDims d, PolicyGeom g, int nets) {
  if (g.rows <= 0 || g.rows > kPolicyRowsMax) return false;
  if (!g.resident &&
      (g.chunk < d.h1 || g.chunk < d.h2 || g.chunk < d.a ||
       g.chunk * sizeof(T) % 16 != 0))
    return false;
  return PolicySmem(d, g, sizeof(T), nets).total <=
         static_cast<size_t>(g.smem);
}

struct StoreQ {
  float* q;  // [rows][a] in shared memory
  int a;
  __device__ __forceinline__ void store(int r, int j, float v) {
    q[r * a + j] = v;
  }
};

struct NoFill {
  __device__ __forceinline__ void operator()() const {}
};

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 1)
policy_kernel(Net<T> net1, Net<T> net2, int32_t* __restrict__ act_o,
              float* __restrict__ rew_o, int32_t* __restrict__ done_o,
              int32_t* __restrict__ win_o, int32_t* __restrict__ col_o,
              int T_steps, int N, PolicyGeom g, MlpDims d, PolicyCfg pc,
              EnvCfg cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nets = pc.p2_mlp ? 2 : 1;
  const PolicySmem S(d, g, sizeof(T), nets);
  const NetSmem W(d, sizeof(T));
  T* const s_h1 = reinterpret_cast<T*>(smem + S.h1);
  T* const s_h2 = reinterpret_cast<T*>(smem + S.h2);
  const int st_in = act_stride(d.in);

  const int env0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, N - env0);
  const int e = threadIdx.x;
  const bool owner = e < rows;
  const uint32_t env = static_cast<uint32_t>(env0 + e);
  const size_t sN = static_cast<size_t>(N);

  if (g.resident) {  // both nets into shared memory, once
    stage_net(smem, W, d, net1);
    if (nets == 2) stage_net(smem + W.bytes, W, d, net2);
    cp_async_commit();
    cp_async_wait_all();  // resident_layers' first barrier publishes them
  }

  float sx1, sy1, sx2, sy2;  // coordinates of the deterministic start
  lon2coord(kStartPoint, 1.0f, sx1, sy1);
  lon2coord(kStartPoint, -1.0f, sx2, sy2);

  EnvState s;
  float x1 = sx1, y1 = sy1, x2 = sx2, y2 = sy2;
  start_state(s);
  if (owner && pc.random_start) {
    random_start(s, 0u, env, pc.k0, pc.k1);
    lon2coord(s.pos1, 1.0f, x1, y1);
    lon2coord(s.pos2, -1.0f, x2, y2);
  }

  NoFill nofill;
  for (int t = 0; t < T_steps; ++t) {
    if (owner) {  // pre-step observation from the cached coordinates
      float o[10] = {x2 - x1, y2 - y1, s.vel2 - s.vel1, kEndPoint - s.pos1,
                     s.vel1,  x1 - x2, y1 - y2, s.vel1 - s.vel2,
                     kEndPoint - s.pos2, s.vel2};
      T* in1 = reinterpret_cast<T*>(smem + S.in1) + e * st_in;
      T* in2 = reinterpret_cast<T*>(smem + S.in2) + e * st_in;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        in1[k] = Num<T>::from_f(o[k]);
        if (nets == 2) in2[k] = Num<T>::from_f(o[(k + 5) % 10]);
      }
    }
    for (int n = 0; n < nets; ++n) {
      const T* x_in = reinterpret_cast<const T*>(smem + (n ? S.in2 : S.in1));
      StoreQ epi{reinterpret_cast<float*>(smem + (n ? S.q2 : S.q1)), d.a};
      if (g.resident) {
        resident_layers<T, RM, RN>(d, net_in_smem<T>(smem + n * W.bytes, W),
                                   x_in, s_h1, s_h2, rows, epi);
      } else {
        qnet_layers<T, RM, RN>(d, n ? net2 : net1, g.chunk,
                               reinterpret_cast<T*>(smem), x_in, s_h1, s_h2,
                               rows, nofill, epi);
      }
    }
    if (!owner) continue;

    const float* q1 = reinterpret_cast<const float*>(smem + S.q1);
    const float* q2 = reinterpret_cast<const float*>(smem + S.q2);
    int a1 = argmax0(q1 + e * d.a, d.a);
    int a2 = pc.p2_mlp ? argmax0(q2 + e * d.a, d.a) : -1;
    if (!pc.greedy) {
      Bits4 b = draw(static_cast<uint32_t>(t), env, kStreamActions, pc.k0,
                     pc.k1);
      a1 = phi_select(a1, b.x, b.y, pc.threshold, d.a);
      if (pc.p2_mlp) a2 = phi_select(a2, b.z, b.w, pc.threshold, d.a);
    }
    StepOut o = env_step(s, a1, a2, cfg);

    const size_t row = static_cast<size_t>(t) * sN + env;
    act_o[2 * static_cast<size_t>(t) * sN + env] = a1;
    act_o[(2 * static_cast<size_t>(t) + 1) * sN + env] = a2;
    rew_o[2 * static_cast<size_t>(t) * sN + env] = o.r1;
    rew_o[(2 * static_cast<size_t>(t) + 1) * sN + env] = o.r2;
    done_o[row] = o.done;
    win_o[row] = s.winner;
    col_o[row] = o.col;

    x1 = o.x1; y1 = o.y1; x2 = o.x2; y2 = o.y2;
    if (o.done) {  // auto-reset, coordinates cache included
      if (pc.random_start) {
        random_start(s, static_cast<uint32_t>(t), env, pc.k0, pc.k1);
        lon2coord(s.pos1, 1.0f, x1, y1);
        lon2coord(s.pos2, -1.0f, x2, y2);
      } else {
        start_state(s);
        x1 = sx1; y1 = sy1; x2 = sx2; y2 = sy2;
      }
    }
  }
}

struct Events {
  int32_t* act;
  float* rew;
  int32_t *done, *win, *col;
};

template <typename T, int RM, int RN>
cudaError_t launch_tile(Net<T> n1, Net<T> n2, Events ev, int T_steps, int N,
                        PolicyGeom g, MlpDims d, PolicyCfg pc, EnvCfg cfg,
                        cudaStream_t stream) {
  if (!policy_geom_ok<T>(d, g, pc.p2_mlp ? 2 : 1))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(policy_kernel<T, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + g.rows - 1) / g.rows;
  policy_kernel<T, RM, RN><<<blocks, kQnetThreads, g.smem, stream>>>(
      n1, n2, ev.act, ev.rew, ev.done, ev.win, ev.col, T_steps, N, g, d, pc,
      cfg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* w1, const void* const* w2, Events ev,
                   int T_steps, int N, PolicyGeom g, int rm, int rn,
                   MlpDims d, PolicyCfg pc, EnvCfg cfg, cudaStream_t stream) {
  auto net = [](const void* const* w) {
    return Net<T>{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
                  static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
                  static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  };
  const Net<T> n1 = net(w1), n2 = net(pc.p2_mlp ? w2 : w1);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N_)                                                      \
  case M * 16 + N_:                                                          \
    return launch_tile<T, M, N_>(n1, n2, ev, T_steps, N, g, d, pc, cfg,      \
                                 stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mgt

extern "C" int mgt_policy_rollout(
    const void* w10, const void* b10, const void* w11, const void* b11,
    const void* w12, const void* b12, const void* w20, const void* b20,
    const void* w21, const void* b21, const void* w22, const void* b22,
    int32_t* act, float* rew, int32_t* done, int32_t* win, int32_t* col,
    int T, int N, int in, int h1, int h2, int a, int rows, int rm, int rn,
    int resident, int chunk, int smem, int p2_mlp, int greedy,
    uint32_t threshold, int random_start, int bf16, uint32_t k0,
    uint32_t k1, int max_steps, float r_first, float r_second,
    float r_collision, float vel_penalty, float time_penalty,
    cudaStream_t stream) {
  using namespace mgt;
  if (T <= 0 || N <= 0) return 0;
  const void* w1[6] = {w10, b10, w11, b11, w12, b12};
  const void* w2[6] = {w20, b20, w21, b21, w22, b22};
  MlpDims d{in, h1, h2, a};
  PolicyGeom g{rows, resident, chunk, smem};
  PolicyCfg pc{p2_mlp, greedy, random_start, threshold, k0, k1};
  EnvCfg cfg{r_first, r_second, r_collision, vel_penalty, time_penalty,
             max_steps};
  Events ev{act, rew, done, win, col};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(w1, w2, ev, T, N, g, rm, rn, d, pc, cfg,
                                   stream)
           : launch<float>(w1, w2, ev, T, N, g, rm, rn, d, pc, cfg, stream);
  return static_cast<int>(err);
}
