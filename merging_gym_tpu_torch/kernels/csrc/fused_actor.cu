// K4: the Q-net forward and the Phi(eps)-greedy pick as one launch.
//
// Replaces merging_gym_tpu/ops/fused_actor.py:_actor_kernel (entry
// fused_eps_greedy_actions).  The TPU kernel kept the weights resident in
// VMEM, ran the MLP on 512-row tiles and drew its selection bits from the
// TPU PRNG.  Here the forward is K3's (qnet_forward of qnet_tiled.cuh, so
// the Q-values are K3's bit for bit) with q kept in shared memory; then
// one thread per row takes argmax0 and the shared phi_select of mlp.cuh
// on the two Philox words at counter (0, row, 0, 0) under the caller's
// seed.  Only the int32 actions leave the block.
//
// Bound on an H100: at the reference widths a row costs 22,500
// multiply-adds for 44 B of input and output, so the kernel is bound by
// f32 operations on the CUDA cores (no tensor cores, no FMA: the sums
// must equal the plain version's, which caps it at half of the bound).
// Its measured time beside that bound is in PERF.md (chip_smoke.py).
#include <cstdint>

#include "philox.cuh"
#include "qnet_tiled.cuh"

namespace mgt {

struct StoreSmemQ {
  float* q;  // [rows][a] in shared memory
  int a;
  __device__ __forceinline__ void store(int r, int j, float v) {
    q[r * a + j] = v;
  }
};

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 2)
actor_kernel(const float* __restrict__ x, Net<T> net,
             int32_t* __restrict__ out, int B, QnetGeom g, MlpDims d,
             uint32_t threshold, uint32_t k0, uint32_t k1) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem + QnetSmem(d, g, sizeof(T), 0).q);
  StoreSmemQ epi{q, d.a};
  qnet_forward<T, RM, RN>(x, B, d, net, g, smem, epi);
  const int row0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, B - row0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const uint32_t row = static_cast<uint32_t>(row0 + r);
    Bits4 b = draw(0u, row, kStreamActions, k0, k1);
    out[row] =
        phi_select(argmax0(q + r * d.a, d.a), b.x, b.y, threshold, d.a);
  }
}

template <typename T, int RM, int RN>
cudaError_t launch_tile(const float* x, Net<T> net, int32_t* out, int B,
                        QnetGeom g, MlpDims d, uint32_t threshold,
                        uint32_t k0, uint32_t k1, cudaStream_t stream) {
  if (!qnet_geom_ok<T>(d, g, d.a)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(actor_kernel<T, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + g.rows - 1) / g.rows;
  actor_kernel<T, RM, RN><<<blocks, kQnetThreads, g.smem, stream>>>(
      x, net, out, B, g, d, threshold, k0, k1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* const* w, int32_t* out, int B,
                   QnetGeom g, int rm, int rn, MlpDims d, uint32_t threshold,
                   uint32_t k0, uint32_t k1, cudaStream_t stream) {
  Net<T> net{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
             static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
             static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  const float* xf = static_cast<const float*>(x);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N)                                                    \
  case M * 16 + N:                                                        \
    return launch_tile<T, M, N>(xf, net, out, B, g, d, threshold, k0, k1, \
                                stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mgt

extern "C" int mgt_fused_actor(const void* x, const void* w0, const void* b0,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, int32_t* out, int B, int in,
                               int h1, int h2, int a, int bf16, int rows,
                               int rm, int rn, int chunk, int smem,
                               uint32_t threshold, uint32_t k0, uint32_t k1,
                               cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0) return 0;
  const void* w[6] = {w0, b0, w1, b1, w2, b2};
  MlpDims d{in, h1, h2, a};
  QnetGeom g{rows, chunk, smem};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, out, B, g, rm, rn, d, threshold, k0,
                                   k1, stream)
           : launch<float>(x, w, out, B, g, rm, rn, d, threshold, k0, k1,
                           stream);
  return static_cast<int>(err);
}
