// K4: the Q-net forward and the Phi(eps)-greedy pick as one launch.
//
// Replaces merging_gym_tpu/ops/fused_actor.py:_actor_kernel (entry
// fused_eps_greedy_actions).  The TPU kernel kept the weights resident in
// VMEM, ran the MLP on 512-row tiles and drew its selection bits from the
// TPU PRNG.  Here a block owns `tile` rows: the forward is mlp_tile of
// mlp.cuh (K3's device code, so the Q-values are K3's bit for bit), then
// one thread per row takes argmax0 and the shared phi_select on the two
// Philox words at counter (0, row, 0, 0) under the caller's seed.  Only
// the int32 actions leave the block.
//
// Bound on an H100: at the reference widths a row costs 22,500
// multiply-adds for 44 B of input and output, so the kernel is bound by
// f32 operations on the CUDA cores (no tensor cores, no FMA: the sums
// must equal the plain version's).  Its measured time beside that bound
// is in PERF.md (chip_smoke.py).
#include <cstdint>

#include "mlp.cuh"
#include "philox.cuh"

namespace mgt {

constexpr int kActorThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kActorThreads)
actor_kernel(const float* __restrict__ x, Net<T> net,
             int32_t* __restrict__ out, int B, int tile, MlpDims d,
             uint32_t threshold, uint32_t k0, uint32_t k1) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);  // [tile][a]
  T* s_in = reinterpret_cast<T*>(q + tile * d.a);
  T* s_h1 = s_in + tile * d.in;
  T* s_h2 = s_h1 + tile * d.h1;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, B - row0);
  mlp_tile<T>(x + static_cast<size_t>(row0) * d.in, rows, d, net, s_in, s_h1,
              s_h2, q);
  const int r = threadIdx.x;
  if (r >= rows) return;
  const uint32_t row = static_cast<uint32_t>(row0 + r);
  Bits4 b = draw(0u, row, kStreamActions, k0, k1);
  out[row] = phi_select(argmax0(q + r * d.a, d.a), b.x, b.y, threshold, d.a);
}

template <typename T>
cudaError_t launch(const void* x, const void* const* w, int32_t* out, int B,
                   int tile, MlpDims d, uint32_t threshold, uint32_t k0,
                   uint32_t k1, cudaStream_t stream) {
  Net<T> net{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
             static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
             static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  size_t smem = static_cast<size_t>(tile) * d.a * sizeof(float) +
                static_cast<size_t>(tile) * (d.in + d.h1 + d.h2) * sizeof(T);
  cudaError_t err = allow_smem(actor_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (B + tile - 1) / tile;
  actor_kernel<T><<<blocks, kActorThreads, smem, stream>>>(
      static_cast<const float*>(x), net, out, B, tile, d, threshold, k0, k1);
  return cudaGetLastError();
}

}  // namespace mgt

extern "C" int mgt_fused_actor(const void* x, const void* w0, const void* b0,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, int32_t* out, int B, int in,
                               int h1, int h2, int a, int bf16, int tile,
                               uint32_t threshold, uint32_t k0, uint32_t k1,
                               cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0) return 0;
  if (tile > kActorThreads) return static_cast<int>(cudaErrorInvalidValue);
  const void* w[6] = {w0, b0, w1, b1, w2, b2};
  MlpDims d{in, h1, h2, a};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, out, B, tile, d, threshold, k0, k1,
                                   stream)
           : launch<float>(x, w, out, B, tile, d, threshold, k0, k1, stream);
  return static_cast<int>(err);
}
