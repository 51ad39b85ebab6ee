// Shared device code of the f32 instantiations of the fused MLP kernels (the
// exactness checks of the NeRF and MinMax chains; every serving kernel runs
// on `wgmma`, hopper.cuh): the f32 policy and one `dense` routine that every
// layer goes through, and the launcher all kernels use.
//
// Layout. A thread block owns TILE consecutive rays. Activations live in
// shared memory RAY-MAJOR, [TILE][features + pad]; the weights stay in device
// memory as the packed panels w_t [out, in] (in = K, padded with zero
// columns to a multiple of 32) and are read through L1/L2. A layer is
// C[ray, out] = sum_k H[ray, k] * W[out, k], one FMA loop per output, and
// the epilogue (bias, activation) runs on the f32 sum before anything is
// stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {

constexpr int kW = 256;  // hidden width of all three nets

struct PF32 {
  using T = float;
  static constexpr int TILE = 32;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int PAD = 4;  // keeps rows 16-byte aligned for float4
  static __device__ __forceinline__ T rnd(float v) { return v; }
  static __device__ __forceinline__ float f(T v) { return v; }
  static __device__ __forceinline__ int col(int n) { return n; }
};

// A weight-blob value through the read-only path: the compiler may then keep
// one load for all the rows of a column instead of reloading after every
// store.
template <class T>
__device__ __forceinline__ T ro(const T* p) {
  return __ldg(p);
}

// round(a + b) in the pack dtype
template <class P>
__device__ __forceinline__ typename P::T add(typename P::T a,
                                             typename P::T b) {
  return P::rnd(P::f(a) + P::f(b));
}

template <class P>
__device__ __forceinline__ typename P::T relu(typename P::T v) {
  return P::rnd(fmaxf(P::f(v), 0.0f));
}

// ELU as the TPU kernel writes it: exp(min(x, 0)) - 1 in f32, rounded.
template <class P>
__device__ __forceinline__ typename P::T elu(typename P::T v) {
  float x = P::f(v);
  return P::rnd(x > 0.0f ? x : expf(fminf(x, 0.0f)) - 1.0f);
}

// ------------------------------------------------------------- f32 / FMA --

// A thread computes 8 rays of one output: the panel row is read once as
// float4 and the activations are broadcast reads. Sums run over k in order.
template <class P, class Epi>
__device__ __forceinline__ void dense_f32(const float* in, int ld, int K,
                                          const float* Wg, int Nout,
                                          Epi& epi) {
  constexpr int RB = 8;
  const int items = Nout * (P::TILE / RB);
  for (int it = threadIdx.x; it < items; it += P::THREADS) {
    const int n = it % Nout, r0 = (it / Nout) * RB;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    const float4* wr = reinterpret_cast<const float4*>(Wg + (size_t)n * K);
    for (int k4 = 0; k4 < K / 4; ++k4) {
      const float4 w = __ldg(wr + k4);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 h =
            *reinterpret_cast<const float4*>(in + (r0 + r) * ld + 4 * k4);
        acc[r] = fmaf(w.x, h.x, acc[r]);
        acc[r] = fmaf(w.y, h.y, acc[r]);
        acc[r] = fmaf(w.z, h.z, acc[r]);
        acc[r] = fmaf(w.w, h.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) epi(r0 + r, n, acc[r]);
  }
}

// One layer, C = in[TILE, K] x Wg[Nout, K]^T. fn(ray, out, acc) turns an f32
// accumulator into the value to keep (bias, activation), and the value goes
// to dst[ray * ld_dst + P::col(out)], an operand buffer in shared memory. The
// caller synchronises the block afterwards.
template <class P, class Fn>
__device__ __forceinline__ void dense_store(const typename P::T* in, int ld,
                                            int K, const typename P::T* Wg,
                                            int Nout, typename P::T* dst,
                                            int ld_dst, Fn fn) {
  auto sink = [&](int r, int n, float a) {
    dst[r * ld_dst + P::col(n)] = fn(r, n, a);
  };
  dense_f32<P>(in, ld, K, Wg, Nout, sink);
}

// The same product for a head: fn(ray, out, acc) is called for every element
// and stores what it wants where it wants.
template <class P, class Fn>
__device__ __forceinline__ void dense_each(const typename P::T* in, int ld,
                                           int K, const typename P::T* Wg,
                                           int Nout, Fn fn) {
  dense_f32<P>(in, ld, K, Wg, Nout, fn);
}

// Opt a kernel in to the dynamic shared memory it needs and launch it.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, int blocks, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pn
