// The Q-net forward of K3 (qnet_mlp.cu), K4 (fused_actor.cu), K6
// (policy_rollout.cu), the act kernels of K5 and K7 (act_tiled.cuh) and
// their learner (dqn_trainer.cu), register-tiled for Hopper.  That learner
// also runs its dz1 = w1 dz2 pass through layer_sums, K9's learner its
// input side (drqn_trainer.cu), and K8's learner and the act kernels of K8
// and K9 every layer of their nets through staged_sums
// (rainbow_trainer.cu, drqn_trainer.cu).
//
// A block owns `rows` rows of x (chosen on the host from B and the SM
// count, ops/fused_mlp.py:qnet_geometry) and keeps their activations in
// shared memory.  Each thread of a layer owns a micro-tile of RM rows x RN
// columns: RM * RN accumulators, each its own sequential chain over k in
// input order from 0, with one rounding per multiply and per add
// (__fmul_rn/__fadd_rn, never an FMA), so the outputs equal the plain
// versions' (ops/fused_mlp.py:mlp_plain_layers and the trainers' plain
// forwards) bit for bit.  The independent chains give the ILP; per k the
// RM activations are broadcast reads (four k at a time) and each of the RN
// weights is reused by the RM rows.  No tensor cores and no split-k: both
// would change the order of the sums.
//
// The weights pass through shared memory in chunks of whole k-rows, two
// buffers of `chunk` elements: cp.async fetches the next chunk (of this
// layer or the next) while the block computes on the current one, so a
// layer of any width streams through.  Where a layer has more micro-tiles
// than the block has threads, its chunks stream once per pass of tiles.
// The last layer (the actions) takes one output per thread.  A block that
// runs many forwards of the same nets (K6, once per env step) instead holds
// the weights in shared memory for the whole launch (stage_net once, then
// resident_layers each step): the same micro-tiles over all of k at once.
// In bf16: products of bf16 operands exact in f32, each sum rounded to
// bf16, the bf16 bias add, then ReLU (mlp.cuh).
#pragma once

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "mlp.cuh"

namespace mgt {

constexpr int kQnetThreads = 256;

// The micro-tiles (RM, RN) the launchers instantiate; the host picks one
// (ops/fused_mlp.py:QNET_TILES lists the same).
#define MGT_QNET_TILES(X) \
  X(1, 1) X(1, 4) X(2, 1) X(4, 1) X(4, 2) X(8, 2) X(8, 4)

struct QnetGeom {
  int rows;   // rows of x per block
  int chunk;  // elements of T in each of the two weight buffers
  int smem;   // bytes of shared memory per block (ops/fused_mlp.py:qnet_smem)
};

// Row stride of an activation tile: a multiple of 4 elements, so four k
// load as one vector, plus 4 to spread the row groups over the banks.
__host__ __device__ inline int act_stride(int k) { return (k + 3) / 4 * 4 + 4; }

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of a block's shared memory: the two weight buffers, the
// input, h1 and h2 tiles in T, and `q_per_row` f32 per row (K4's q).
struct QnetSmem {
  size_t in, h1, h2, q, total;
  __host__ __device__ QnetSmem(MlpDims d, QnetGeom g, int elem,
                               int q_per_row) {
    const size_t rows = static_cast<size_t>(g.rows);
    in = align16(2 * static_cast<size_t>(g.chunk) * elem);
    h1 = in + align16(rows * act_stride(d.in) * elem);
    h2 = h1 + align16(rows * act_stride(d.h1) * elem);
    q = h2 + align16(rows * act_stride(d.h2) * elem);
    total = q + rows * q_per_row * sizeof(float);
  }
};

// Whether the host's geometry suits this layout: the layout fits in the
// bytes the host sized, and the second weight buffer starts 16-byte
// aligned (cp.async.cg writes 16 B at a time).
template <typename T>
inline bool qnet_geom_ok(MlpDims d, QnetGeom g, int q_per_row) {
  return g.rows > 0 && g.chunk > 0 && g.chunk * sizeof(T) % 16 == 0 &&
         QnetSmem(d, g, sizeof(T), q_per_row).total <=
             static_cast<size_t>(g.smem);
}

// Four consecutive activations (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32 is exact
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Start copying n elements src -> dst (dst 16-byte aligned): 16-byte
// copies where src is aligned to 16, 4-byte ones where it is aligned to 4;
// what is left (a bf16 tail, a 2-byte aligned bf16 chunk) is copied now.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  const int bytes = n * static_cast<int>(sizeof(T));
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  int done = 0;
  if ((a & 15) == 0) {
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(d + 16 * i, s + 16 * i);
    done = n16 << 4;
  }
  if ((a & 3) == 0) {
    const int n4 = (bytes - done) >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async4(d + done + 4 * i, s + done + 4 * i);
    done += n4 << 2;
  }
  for (int i = done / static_cast<int>(sizeof(T)) + threadIdx.x; i < n;
       i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One layer of the block: K -> J, its k-rows per chunk, micro-tiles.
template <typename T>
struct QLayer {
  const T* w;
  const T* b;
  int K, J, kc, nchunks, nj, ntiles, passes;
};

template <typename T>
__device__ __forceinline__ QLayer<T> qlayer(const T* w, const T* b, int K,
                                            int J, int chunk, int rows,
                                            int rm, int rn) {
  QLayer<T> L;
  L.w = w;
  L.b = b;
  L.K = K;
  L.J = J;
  L.kc = K;
  if (K * J > chunk) {  // whole k-rows; four at a time keeps load4 aligned
    L.kc = chunk / J;
    if (L.kc >= 4) L.kc &= ~3;
  }
  L.nchunks = (K + L.kc - 1) / L.kc;
  L.nj = (J + rn - 1) / rn;
  L.ntiles = (rows + rm - 1) / rm * L.nj;
  L.passes = (L.ntiles + kQnetThreads - 1) / kQnetThreads;
  return L;
}

// The sums of the block's micro-tile `tile` of one layer over k in [k0,
// k1), whose weight rows k0.. are in wb; on the layer's first chunk they
// start from 0.
template <typename T, int RM, int RN>
__device__ __forceinline__ void tile_acc(float (&acc)[RM][RN],
                                         const QLayer<T>& L, const T* x,
                                         int xs, const T* wb, int k0, int k1,
                                         bool first, int rows, int tile) {
  const int rg = tile / L.nj, jg = tile - rg * L.nj, r0 = rg * RM;
  const T* xr[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) xr[i] = x + min(r0 + i, rows - 1) * xs;
  int jc[RN];
#pragma unroll
  for (int c = 0; c < RN; ++c) jc[c] = min(jg + c * L.nj, L.J - 1);
  if (first) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[i][c] = 0.0f;
  }
  const int J = L.J;
  int k = k0;
  if ((k0 & 3) == 0) {
    for (; k + 4 <= k1; k += 4) {
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) load4(xr[i] + k, a[i]);
      const T* wk = wb + (k - k0) * J;
      float w[4][RN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < RN; ++c) w[u][c] = Num<T>::to_f(wk[u * J + jc[c]]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < RN; ++c)
            acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a[i][u], w[u][c]));
    }
  }
  for (; k < k1; ++k) {
    const T* wk = wb + (k - k0) * J;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = Num<T>::to_f(xr[i][k]);
#pragma unroll
      for (int c = 0; c < RN; ++c)
        acc[i][c] =
            __fadd_rn(acc[i][c], __fmul_rn(a, Num<T>::to_f(wk[jc[c]])));
    }
  }
}

// tile_acc, and on the layer's last chunk the outputs rounded and biased
// into y (ReLU, as T) or, for the last layer, epi.store(row, col, q).
template <typename T, int RM, int RN, bool kLast, typename Epi>
__device__ __forceinline__ void tile_step(float (&acc)[RM][RN],
                                          const QLayer<T>& L, const T* x,
                                          int xs, const T* wb, int k0,
                                          int k1, bool first, bool last,
                                          int rows, int tile, T* y, int ys,
                                          Epi& epi) {
  tile_acc<T, RM, RN>(acc, L, x, xs, wb, k0, k1, first, rows, tile);
  if (!last) return;
  const int rg = tile / L.nj, jg = tile - rg * L.nj, r0 = rg * RM;
  const int J = L.J;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int r = r0 + i, j = jg + c * L.nj;
      if (r >= rows || j >= J) continue;
      float h = Num<T>::to_f(Num<T>::from_f(acc[i][c]));  // round to T
      h = Num<T>::to_f(Num<T>::from_f(__fadd_rn(h, Num<T>::to_f(L.b[j]))));
      if (kLast) {
        epi.store(r, j, h);
      } else {
        y[r * ys + j] = Num<T>::from_f(h > 0.0f ? h : 0.0f);
      }
    }
  }
}

// Where the schedule of (layer, pass, chunk) steps stands.
struct QStep {
  int l, p, c;
};

template <typename T>
__device__ __forceinline__ bool next_step(QStep& s, const QLayer<T> (&L)[3]) {
  if (++s.c < L[s.l].nchunks) return true;
  s.c = 0;
  if (++s.p < L[s.l].passes) return true;
  s.p = 0;
  return ++s.l < 3;
}

// The three layers of `rows` rows whose inputs (T, act_stride(d.in) per
// row) `fill` writes to x_in: h1, h2 into s_h1, s_h2, q through
// epi.store(row, column, value).  The first weight chunk is requested
// before fill runs.  Layers 1 and 2 use the RM x RN micro-tile; the last
// layer, a few actions wide, one output per thread, so its long sums
// spread over the most threads.  The callers derive every shared pointer
// from smem directly (no pointer arrays), so the compiler keeps the tile
// loads in the shared window (LDS).  Ends with a block-wide barrier, so
// the caller may read what epi stored in shared memory.
template <typename T, int RM, int RN, typename Fill, typename Epi>
__device__ __forceinline__ void qnet_layers(MlpDims d, Net<T> net,
                                            int chunk, T* wbuf,
                                            const T* x_in, T* s_h1, T* s_h2,
                                            int rows, Fill& fill, Epi& epi) {
  const int st_in = act_stride(d.in), st_h1 = act_stride(d.h1),
            st_h2 = act_stride(d.h2);
  const QLayer<T> L[3] = {
      qlayer(net.w0, net.b0, d.in, d.h1, chunk, rows, RM, RN),
      qlayer(net.w1, net.b1, d.h1, d.h2, chunk, rows, RM, RN),
      qlayer(net.w2, net.b2, d.h2, d.a, chunk, rows, 1, 1)};

  QStep cur{0, 0, 0}, pre{0, 0, 0};
  stage(wbuf, L[0].w, L[0].kc * L[0].J);
  cp_async_commit();
  fill();
  bool more = next_step(pre, L);
  float acc[RM][RN];
  float acc1[1][1];
  for (int s = 0;; ++s) {
    if (more) {
      const QLayer<T>& P = L[pre.l];
      const int k0 = pre.c * P.kc;
      stage(wbuf + ((s + 1) & 1) * chunk,
            P.w + static_cast<size_t>(k0) * P.J,
            (min(P.K, k0 + P.kc) - k0) * P.J);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* wb = wbuf + (s & 1) * chunk;
    const int tile = cur.p * kQnetThreads + threadIdx.x;
    const bool first = cur.c == 0;
    if (cur.l == 0) {
      if (tile < L[0].ntiles) {
        const int k0 = cur.c * L[0].kc;
        tile_step<T, RM, RN, false>(
            acc, L[0], x_in, st_in, wb, k0, min(L[0].K, k0 + L[0].kc),
            first, cur.c == L[0].nchunks - 1, rows, tile, s_h1, st_h1, epi);
      }
    } else if (cur.l == 1) {
      if (tile < L[1].ntiles) {
        const int k0 = cur.c * L[1].kc;
        tile_step<T, RM, RN, false>(
            acc, L[1], s_h1, st_h1, wb, k0, min(L[1].K, k0 + L[1].kc),
            first, cur.c == L[1].nchunks - 1, rows, tile, s_h2, st_h2, epi);
      }
    } else if (tile < L[2].ntiles) {
      const int k0 = cur.c * L[2].kc;
      tile_step<T, 1, 1, true>(
          acc1, L[2], s_h2, st_h2, wb, k0, min(L[2].K, k0 + L[2].kc), first,
          cur.c == L[2].nchunks - 1, rows, tile, s_h2, 0, epi);
    }
    __syncthreads();
    if (!next_step(cur, L)) break;
    more = more && next_step(pre, L);
  }
}

// The forward of the block's rows of x (f32 [B][in]) through qnet_layers,
// with the layout of QnetSmem.
template <typename T, int RM, int RN, typename Epi>
__device__ void qnet_forward(const float* __restrict__ x, int B, MlpDims d,
                             Net<T> net, QnetGeom g, unsigned char* smem,
                             Epi& epi) {
  const QnetSmem S(d, g, sizeof(T), 0);
  T* const wbuf = reinterpret_cast<T*>(smem);
  T* const s_in = reinterpret_cast<T*>(smem + S.in);
  T* const s_h1 = reinterpret_cast<T*>(smem + S.h1);
  T* const s_h2 = reinterpret_cast<T*>(smem + S.h2);
  const int st_in = act_stride(d.in);
  const int row0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, B - row0);
  const float* xb = x + static_cast<size_t>(row0) * d.in;
  auto fill = [&]() {
    for (int i = threadIdx.x; i < rows * d.in; i += blockDim.x) {
      const int r = i / d.in;
      s_in[r * st_in + (i - r * d.in)] = Num<T>::from_f(xb[i]);
    }
  };
  qnet_layers<T, RM, RN>(d, net, g.chunk, wbuf, s_in, s_h1, s_h2, rows, fill,
                         epi);
}

// One layer K -> J of `rows` rows of x (T, row stride xs, 16-byte aligned
// rows) without bias or rounding: the weights w [K][J] stream through the
// two buffers of `chunk` elements as in qnet_layers, and
// epi.sum(row, column, s) receives each output's sum, in k order from 0.
// Starts and ends with a block-wide barrier.
template <typename T, int RM, int RN, typename Epi>
__device__ __forceinline__ void layer_sums(const T* __restrict__ w, int K,
                                           int J, int chunk, T* wbuf,
                                           const T* x, int xs, int rows,
                                           Epi& epi) {
  const QLayer<T> L = qlayer<T>(w, nullptr, K, J, chunk, rows, RM, RN);
  __syncthreads();
  stage(wbuf, L.w, L.kc * L.J);
  cp_async_commit();
  float acc[RM][RN];
  int s = 0;
  for (int p = 0; p < L.passes; ++p) {
    for (int c = 0; c < L.nchunks; ++c, ++s) {
      const int nc = c + 1 < L.nchunks ? c + 1 : 0;
      if (nc != 0 || p + 1 < L.passes) {
        const int k0 = nc * L.kc;
        stage(wbuf + ((s + 1) & 1) * chunk, L.w + static_cast<size_t>(k0) * J,
              (min(K, k0 + L.kc) - k0) * J);
      }
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      const int tile = p * kQnetThreads + threadIdx.x;
      if (tile < L.ntiles) {
        const int k0 = c * L.kc;
        tile_acc<T, RM, RN>(acc, L, x, xs, wbuf + (s & 1) * chunk, k0,
                            min(K, k0 + L.kc), c == 0, rows, tile);
        if (c == L.nchunks - 1) {
          const int rg = tile / L.nj, jg = tile - rg * L.nj;
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int cc = 0; cc < RN; ++cc) {
              const int r = rg * RM + i, j = jg + cc * L.nj;
              if (r < rows && j < J) epi.sum(r, j, acc[i][cc]);
            }
        }
      }
      __syncthreads();
    }
  }
}

// One layer K -> J of `rows` rows of x (as in layer_sums) whose weights
// w [K][J] are whole at wb, in shared memory (brought there by the caller)
// or in global memory: epi.sum(row, column, s) receives each output's sum,
// in k order from 0.  No barrier (the Rainbow learner, rainbow_trainer.cu,
// streams its layers' weights two layers ahead itself), so two passes of
// one phase may follow each other: `lead` is the tiles a pass issued just
// before this one gave the block's first threads, and this pass's tiles
// start at the thread after them.  Returns the lead of a pass issued next.
template <typename T, int RM, int RN, typename Epi>
__device__ __forceinline__ int staged_sums(const T* wb, int K, int J,
                                           const T* x, int xs, int rows,
                                           Epi& epi, int lead = 0) {
  const QLayer<T> L = qlayer<T>(wb, nullptr, K, J, K * J, rows, RM, RN);
  const int nt = blockDim.x;
  const int first = (static_cast<int>(threadIdx.x) - lead % nt + nt) % nt;
  for (int tile = first; tile < L.ntiles; tile += nt) {
    float acc[RM][RN];
    tile_acc<T, RM, RN>(acc, L, x, xs, wb, 0, K, true, rows, tile);
    const int rg = tile / L.nj, jg = tile - rg * L.nj;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int r = rg * RM + i, j = jg + c * L.nj;
        if (r < rows && j < J) epi.sum(r, j, acc[i][c]);
      }
  }
  return lead + L.ntiles;
}

// Byte offsets of one net's six tensors held whole in shared memory, each
// 16-byte aligned (the cp.async destinations of stage_net), and its bytes.
struct NetSmem {
  size_t w0, b0, w1, b1, w2, b2, bytes;
  __host__ __device__ NetSmem(MlpDims d, int elem) {
    const size_t e = static_cast<size_t>(elem);
    w0 = 0;
    b0 = w0 + align16(static_cast<size_t>(d.in) * d.h1 * e);
    w1 = b0 + align16(d.h1 * e);
    b1 = w1 + align16(static_cast<size_t>(d.h1) * d.h2 * e);
    w2 = b1 + align16(d.h2 * e);
    b2 = w2 + align16(static_cast<size_t>(d.h2) * d.a * e);
    bytes = b2 + align16(d.a * e);
  }
};

// The net whose tensors lie at `base` in the layout of NetSmem.
template <typename T>
__device__ __forceinline__ Net<T> net_in_smem(const unsigned char* base,
                                              const NetSmem& o) {
  return Net<T>{reinterpret_cast<const T*>(base + o.w0),
                reinterpret_cast<const T*>(base + o.b0),
                reinterpret_cast<const T*>(base + o.w1),
                reinterpret_cast<const T*>(base + o.b1),
                reinterpret_cast<const T*>(base + o.w2),
                reinterpret_cast<const T*>(base + o.b2)};
}

// Start copying a whole net into shared memory at `base` (NetSmem layout);
// the caller commits, waits and syncs the block.
template <typename T>
__device__ __forceinline__ void stage_net(unsigned char* base,
                                          const NetSmem& o, MlpDims d,
                                          Net<T> net) {
  stage(reinterpret_cast<T*>(base + o.w0), net.w0, d.in * d.h1);
  stage(reinterpret_cast<T*>(base + o.b0), net.b0, d.h1);
  stage(reinterpret_cast<T*>(base + o.w1), net.w1, d.h1 * d.h2);
  stage(reinterpret_cast<T*>(base + o.b1), net.b1, d.h2);
  stage(reinterpret_cast<T*>(base + o.w2), net.w2, d.h2 * d.a);
  stage(reinterpret_cast<T*>(base + o.b2), net.b2, d.a);
}

// qnet_layers for a net whose weights and biases the block already holds
// in shared memory (`net` points there, net_in_smem): each layer's
// micro-tiles sum over all of k at once, with no chunks and no copies.
// The same sums in the same order, so the same bits.  Starts with a
// block-wide barrier (the caller's writes to x_in become visible) and ends
// with one (the caller may read what epi stored).
template <typename T, int RM, int RN, typename Epi>
__device__ __forceinline__ void resident_layers(MlpDims d, Net<T> net,
                                                const T* x_in, T* s_h1,
                                                T* s_h2, int rows, Epi& epi) {
  const int st_in = act_stride(d.in), st_h1 = act_stride(d.h1),
            st_h2 = act_stride(d.h2);
  const QLayer<T> L0 =
      qlayer(net.w0, net.b0, d.in, d.h1, d.in * d.h1, rows, RM, RN);
  const QLayer<T> L1 =
      qlayer(net.w1, net.b1, d.h1, d.h2, d.h1 * d.h2, rows, RM, RN);
  const QLayer<T> L2 = qlayer(net.w2, net.b2, d.h2, d.a, d.h2 * d.a, rows, 1, 1);
  float acc[RM][RN];
  float acc1[1][1];
  __syncthreads();
  for (int tile = threadIdx.x; tile < L0.ntiles; tile += blockDim.x)
    tile_step<T, RM, RN, false>(acc, L0, x_in, st_in, L0.w, 0, d.in, true,
                                true, rows, tile, s_h1, st_h1, epi);
  __syncthreads();
  for (int tile = threadIdx.x; tile < L1.ntiles; tile += blockDim.x)
    tile_step<T, RM, RN, false>(acc, L1, s_h1, st_h1, L1.w, 0, d.h1, true,
                                true, rows, tile, s_h2, st_h2, epi);
  __syncthreads();
  for (int tile = threadIdx.x; tile < L2.ntiles; tile += blockDim.x)
    tile_step<T, 1, 1, true>(acc1, L2, s_h2, st_h2, L2.w, 0, d.h2, true,
                             true, rows, tile, s_h2, 0, epi);
  __syncthreads();
}

}  // namespace mgt
