// The forwards of the act kernels of K5 (dqn_trainer.cu) and K7
// (hdqn_trainer.cu) on qnet_tiled.cuh's register micro-tiles; the act
// kernels of K8 (rainbow_trainer.cu: its frozen MLP opponent through
// act_forward) and K9 (drqn_trainer.cu) share the launch geometry, the
// opponent codes and put_obs.
//
// A block owns `rows` envs (ops/fused_trainer.py:act_geometry: the smallest
// power of two, at most kActRowsMax, whose blocks do not outnumber the SMs:
// 8 envs a block in 128 blocks at 1,024 envs), thread e < rows owns env
// env0 + e in registers and writes its inputs straight into the block's
// input tile.  Each forward is one pass of the block's 256 threads over a
// tile of rows: the nets a kernel runs more than once, or that fit, are held
// in shared memory for the launch (`resident`: stage_net once, then
// resident_layers), the others stream through two weight buffers
// (qnet_layers).  Where the opponent plays the ego's own nets (self-play)
// both seats' rows go through one pass of 2 x rows rows: each output is its
// own in-order chain, so the q are those of two passes, bit for bit.
#pragma once

#include <cstddef>

#include "qnet_tiled.cuh"

namespace mgt {

constexpr int kActRowsMax = 32;  // owners are the first `rows` threads

// The opponent of an act kernel: none (L0, action -1), the ego's own nets
// (self-play: one pass over both seats' rows), or frozen nets (streamed).
constexpr int kOppL0 = 0, kOppSelf = 1, kOppFrozen = 2;

// Launch geometry from the host: envs per block, how many of the kernel's
// nets (in its order) are held in shared memory, elements of each weight
// buffer (0: nothing streams), shared bytes per block.
struct ActGeom {
  int rows, resident, chunk, smem;
};

// Byte offsets of an act kernel's shared memory (ops/fused_trainer.py:
// act_smem mirrors it): the first g.resident of the `n` nets whole (NetSmem
// each, from 0), the two weight buffers where a net streams (chunk > 0),
// then the input, h1 and h2 tiles of `seats` x rows rows, as wide as the
// widest net's, and their f32 q.
struct ActSmem {
  size_t buf, in, h1, h2, q, total;
  __host__ __device__ ActSmem(const MlpDims* nets, int n, ActGeom g, int elem,
                              int seats) {
    const size_t prows = static_cast<size_t>(seats) * g.rows;
    MlpDims m{0, 0, 0, 0};
    buf = 0;
    for (int i = 0; i < n; ++i) {
      if (i < g.resident) buf += NetSmem(nets[i], elem).bytes;
      m.in = nets[i].in > m.in ? nets[i].in : m.in;
      m.h1 = nets[i].h1 > m.h1 ? nets[i].h1 : m.h1;
      m.h2 = nets[i].h2 > m.h2 ? nets[i].h2 : m.h2;
      m.a = nets[i].a > m.a ? nets[i].a : m.a;
    }
    in = buf + (g.chunk > 0 ? align16(2 * static_cast<size_t>(g.chunk) * elem)
                            : 0);
    h1 = in + align16(prows * act_stride(m.in) * elem);
    h2 = h1 + align16(prows * act_stride(m.h1) * elem);
    q = h2 + align16(prows * act_stride(m.h2) * elem);
    total = q + prows * m.a * sizeof(float);
  }
};

// Whether the host's geometry suits this layout: rows an owner thread each,
// at most the n nets held, where a net streams (`streams`) buffers that hold
// a k-row of every layer with the second one 16-byte aligned, and the layout
// within the bytes the host sized.
template <typename T>
inline bool act_geom_ok(const MlpDims* nets, int n, ActGeom g, int seats,
                        bool streams) {
  if (g.rows <= 0 || g.rows > kActRowsMax || g.resident < 0 ||
      g.resident > n || g.chunk < 0)
    return false;
  if (streams) {
    if (g.chunk * sizeof(T) % 16 != 0) return false;
    for (int i = 0; i < n; ++i)
      if (g.chunk < nets[i].h1 || g.chunk < nets[i].h2 || g.chunk < nets[i].a)
        return false;
  }
  return ActSmem(nets, n, g, sizeof(T), seats).total <=
         static_cast<size_t>(g.smem);
}

struct StoreRows {  // q of a forward's rows into shared memory, [row][a]
  float* q;
  int a;
  __device__ __forceinline__ void store(int r, int j, float v) {
    q[r * a + j] = v;
  }
};

struct NoFill {
  __device__ __forceinline__ void operator()() const {}
};

// One forward of the first `prows` rows of the input tile (T, act_stride(
// d.in) a row, written by the caller before the call) through `net`: held
// in shared memory at byte `at` of smem (at >= 0) or streamed through the
// weight buffers (at < 0).  q[row][d.a] (f32) goes to the q tile.  Ends with
// a block-wide barrier, so the caller may read q and write the next inputs.
template <typename T, int RM, int RN>
__device__ __forceinline__ void act_forward(unsigned char* smem,
                                            const ActSmem& S, int chunk,
                                            MlpDims d, Net<T> net, long at,
                                            int prows) {
  T* const s_in = reinterpret_cast<T*>(smem + S.in);
  T* const s_h1 = reinterpret_cast<T*>(smem + S.h1);
  T* const s_h2 = reinterpret_cast<T*>(smem + S.h2);
  StoreRows epi{reinterpret_cast<float*>(smem + S.q), d.a};
  if (at >= 0) {
    resident_layers<T, RM, RN>(
        d, net_in_smem<T>(smem + at, NetSmem(d, sizeof(T))), s_in, s_h1, s_h2,
        prows, epi);
  } else {
    NoFill none;
    qnet_layers<T, RM, RN>(d, net, chunk, reinterpret_cast<T*>(smem + S.buf),
                           s_in, s_h1, s_h2, prows, none, epi);
  }
}

// An observation into a row of an input tile, rotated by kShift (5: the
// other seat's half-swapped view); the indices are constants, so o stays in
// registers.
template <int kShift, typename T, int N>
__device__ __forceinline__ void put_obs(T* row, const float (&o)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) row[k] = Num<T>::from_f(o[(k + kShift) % N]);
}

}  // namespace mgt
