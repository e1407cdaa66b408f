// K3: the whole Q-net forward (3 layers, ReLU) as one launch.
//
// Replaces merging_gym_tpu/ops/fused_mlp.py:_mlp_kernel.  The TPU kernel
// kept all weights resident in VMEM and streamed batch tiles through; here
// the forward is qnet_forward of qnet_tiled.cuh: blocks of `rows` rows,
// sized on the host so that even the main paths' small batches (256, 1,024)
// give every SM a block, register micro-tiles of RM x RN outputs per
// thread, and the weights streamed through shared memory in cp.async
// chunks.  Each block writes its rows' q.
//
// Bound on an H100: at the reference widths every row costs 22,500
// multiply-adds for 60 B of input and output, so the kernel is bound by
// f32 operations on the CUDA cores.  The sums must equal the plain
// version's, so no FMA: a multiply and an add are two instructions, and
// the kernel can reach at most half of the bound that counts an FMA's
// rate.  Its measured time beside that bound is in PERF.md (chip_smoke.py).
#include <cstdint>

#include "qnet_tiled.cuh"

namespace mgt {

struct StoreQ {
  float* q;  // the block's first row of out
  int a;
  __device__ __forceinline__ void store(int r, int j, float v) {
    q[r * a + j] = v;
  }
};

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kQnetThreads, 2)
qnet_kernel(const float* __restrict__ x, Net<T> net, float* __restrict__ out,
            int B, QnetGeom g, MlpDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  StoreQ epi{out + static_cast<size_t>(blockIdx.x) * g.rows * d.a, d.a};
  qnet_forward<T, RM, RN>(x, B, d, net, g, smem, epi);
}

template <typename T, int RM, int RN>
cudaError_t launch_tile(const float* x, Net<T> net, float* out, int B,
                        QnetGeom g, MlpDims d, cudaStream_t stream) {
  if (!qnet_geom_ok<T>(d, g, 0)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(qnet_kernel<T, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + g.rows - 1) / g.rows;
  qnet_kernel<T, RM, RN>
      <<<blocks, kQnetThreads, g.smem, stream>>>(x, net, out, B, g, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* const* w, void* out, int B,
                   QnetGeom g, int rm, int rn, MlpDims d,
                   cudaStream_t stream) {
  Net<T> net{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
             static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
             static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  const float* xf = static_cast<const float*>(x);
  float* q = static_cast<float*>(out);
  switch (rm * 16 + rn) {
#define MGT_CASE(M, N) \
  case M * 16 + N:     \
    return launch_tile<T, M, N>(xf, net, q, B, g, d, stream);
    MGT_QNET_TILES(MGT_CASE)
#undef MGT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mgt

extern "C" int mgt_qnet_mlp(const void* x, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int B, int in, int h1,
                            int h2, int a, int bf16, int rows, int rm,
                            int rn, int chunk, int smem,
                            cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0) return 0;
  const void* w[6] = {w0, b0, w1, b1, w2, b2};
  MlpDims d{in, h1, h2, a};
  QnetGeom g{rows, chunk, smem};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, out, B, g, rm, rn, d, stream)
           : launch<float>(x, w, out, B, g, rm, rn, d, stream);
  return static_cast<int>(err);
}
