// K3: the whole Q-net forward (3 layers, ReLU) as one launch.
//
// Replaces merging_gym_tpu/ops/fused_mlp.py:_mlp_kernel.  The TPU kernel
// kept all weights resident in VMEM and streamed batch tiles through; here
// a block owns `rows` rows, keeps their activations in shared memory
// (rows * (in + h1 + h2) elements) and reads the weights through L1/L2,
// where all blocks share them (22,805 f32 = 91 KB at 10-200-100-5).
//
// Bound on an H100: at the reference widths every row costs 22,500
// multiply-adds for 60 B of input and output, so the kernel is bound by
// f32 operations on the CUDA cores (no tensor cores: see mlp.cuh).  Its
// measured time beside that bound is in PERF.md (chip_smoke.py).
#include <cstdint>

#include "mlp.cuh"

namespace mgt {

constexpr int kMlpThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
qnet_kernel(const float* __restrict__ x, Net<T> net, float* __restrict__ out,
            int B, int tile, MlpDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);
  T* s_h1 = s_in + tile * d.in;
  T* s_h2 = s_h1 + tile * d.h1;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, B - row0);
  mlp_tile<T>(x + static_cast<size_t>(row0) * d.in, rows, d, net, s_in, s_h1,
              s_h2, out + static_cast<size_t>(row0) * d.a);
}

template <typename T>
cudaError_t launch(const void* x, const void* const* w, void* out, int B,
                   int tile, MlpDims d, cudaStream_t stream) {
  Net<T> net{static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
             static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
             static_cast<const T*>(w[4]), static_cast<const T*>(w[5])};
  size_t smem = static_cast<size_t>(tile) * (d.in + d.h1 + d.h2) * sizeof(T);
  cudaError_t err = allow_smem(qnet_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (B + tile - 1) / tile;
  qnet_kernel<T><<<blocks, kMlpThreads, smem, stream>>>(
      static_cast<const float*>(x), net, static_cast<float*>(out), B, tile,
      d);
  return cudaGetLastError();
}

}  // namespace mgt

extern "C" int mgt_qnet_mlp(const void* x, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int B, int in, int h1,
                            int h2, int a, int bf16, int tile,
                            cudaStream_t stream) {
  using namespace mgt;
  if (B <= 0) return 0;
  const void* w[6] = {w0, b0, w1, b1, w2, b2};
  MlpDims d{in, h1, h2, a};
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, out, B, tile, d, stream)
           : launch<float>(x, w, out, B, tile, d, stream);
  return static_cast<int>(err);
}
