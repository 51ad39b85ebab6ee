// Shared device code of the fused MLP kernels: the two pack-dtype policies
// (bf16 on tensor cores, f32 on plain FMAs) and one `dense` routine that
// every layer of every kernel goes through.
//
// Layout. A thread block owns TILE consecutive rays. Activations live in
// shared memory RAY-MAJOR, [TILE][features + pad], in the pack dtype; the
// weights stay in device memory as the packed panels w_t [out, in]
// (in = K, padded with zero columns to a multiple of 32) and are read
// through L1/L2. A layer is  C[ray, out] = sum_k H[ray, k] * W[out, k],
// so with `mma.sync.m16n8k16` (A row-major, B "col") both operands are read
// as pairs that are contiguous in k: A from shared memory with `ldmatrix`,
// B straight from the panel. The f32 accumulators stay in registers and the
// epilogue (round, bias, activation) runs on them before anything is stored.
//
// B loads and the k permutation (bf16). A lane reads 16 contiguous bytes of
// its panel row, k = 8t .. 8t+7 of a 32-wide chunk (t = lane % 4), with one
// load: four k-pairs, which are the B fragments of two `mma`s. (Reading the
// pairs an `mma` nominally wants, k = 2t, 2t+1 and 2t+8, 2t+9, takes four
// loads that each touch 8 cache lines.) A sum over k does not care about the
// order of k as long as A and B agree, so the activations are STORED with k
// permuted inside each chunk of 32: feature 8t + 2q + e sits at column
// 8q + 2t + e (`PBf16::col`). Then a plain `ldmatrix` of columns [0, 16) and
// [16, 32) of the chunk delivers exactly the A fragments that match the
// lane's k-pairs q = 0, 1 and q = 2, 3. Everything that writes or reads an
// operand buffer by feature index goes through `P::col`; for f32 it is the
// identity.
//
// int8 (`fused_nerf_q.cu`). The same scheme with `mma.sync.m16n8k32` on int8
// codes: operand buffers are [TILE][features + 16] bytes, a chunk is 64 codes
// wide, a lane's 16-byte load of its panel row (k = 16t .. 16t+15) feeds two
// `mma`s, and `col_s8` is the matching permutation. `ldmatrix ... b16` moves
// the codes two to a b16, which is exactly the A fragment m16n8k32 wants.
//
// Rounding. Every dot is rounded to the pack dtype before anything else is
// added; additions of biases and addends are done in f32 on the rounded
// values and rounded again. That is what `_mm(...) + b` means for bf16
// arrays, and it is a no-op for f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {

constexpr int kW = 256;  // hidden width of all three nets

struct PBf16 {
  using T = __nv_bfloat16;
  static constexpr bool kTensorCore = true;
  static constexpr int TILE = 64;      // rays per block
  static constexpr int THREADS = 256;  // 8 warps, each 64 rays x 32 outputs
  // Blocks per SM the register allocation must leave room for. Two blocks
  // of 64 rays hide each other's barriers and load latency; the cap of 128
  // registers this implies costs a few spilled words and is far cheaper than
  // losing the second block.
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int PAD = 8;                   // elements; keeps ldmatrix
                                                  // rows on distinct banks
  static __device__ __forceinline__ T rnd(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float f(T v) { return __bfloat162float(v); }
  // column of feature n in an operand buffer (see the head of this file)
  static __device__ __forceinline__ int col(int n) {
    return (n & ~31) | ((n & 6) << 2) | ((n >> 2) & 6) | (n & 1);
  }
};

struct PF32 {
  using T = float;
  static constexpr bool kTensorCore = false;
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

// ------------------------------------------------------------ bf16 / mma --

__device__ __forceinline__ void mma_16x8x16(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-row by 32-byte A tile (rows = rays, cols = k: 16 bf16 values or 32
// int8 codes) from shared memory. Lane l hands in the address of row l % 16
// at byte offset (l / 16) * 16; the four 8x8 b16 matrices arrive in the
// register order mma.m16n8k16 (bf16) and mma.m16n8k32 (int8) want for A.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// The pairs (out, out + 1) of a ray that a lane holds after a warp tile at
// (m0, n0), handed to sink(ray, out, acc0, acc1) as floats.
template <int MT, int NT, class Acc, class Sink>
__device__ __forceinline__ void warp_emit(const Acc (&acc)[MT][NT][4], int m0,
                                          int n0, Sink& sink) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int r = m0 + mi * 16 + g, n = n0 + ni * 8 + 2 * t;
      sink(r, n, (float)acc[mi][ni][0], (float)acc[mi][ni][1]);
      sink(r + 8, n, (float)acc[mi][ni][2], (float)acc[mi][ni][3]);
    }
}

// A warp adds MT*16 rays by NT*8 outputs of in[ray, k] . Wg[out, k], starting
// at (m0, n0), onto the f32 accumulators it holds.
template <int MT, int NT>
__device__ __forceinline__ void warp_acc_bf16(const __nv_bfloat16* in, int ld,
                                              int K, const __nv_bfloat16* Wg,
                                              int m0, int n0,
                                              float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* arow = in + (m0 + (lane & 15)) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* brow = Wg + (size_t)(n0 + g) * K + 8 * t;
  for (int kc = 0; kc < K; kc += 32) {
    uint4 bv[NT];  // k-pairs q = 0..3 of this lane, for every n-tile
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      bv[ni] = __ldg(reinterpret_cast<const uint4*>(brow + (size_t)ni * 8 * K + kc));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_a(a[mi], arow + mi * 16 * ld + kc + 16 * h);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const uint32_t b[2] = {h ? bv[ni].z : bv[ni].x, h ? bv[ni].w : bv[ni].y};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_16x8x16(acc[mi][ni], a[mi], b);
      }
    }
  }
}

// The whole product of a warp tile, its f32 sums handed to `sink`.
template <int MT, int NT, class Sink>
__device__ __forceinline__ void warp_tile_bf16(const __nv_bfloat16* in,
                                               int ld, int K,
                                               const __nv_bfloat16* Wg,
                                               int m0, int n0, Sink& sink) {
  float acc[MT][NT][4] = {};
  warp_acc_bf16<MT, NT>(in, ld, K, Wg, m0, n0, acc);
  warp_emit<MT, NT>(acc, m0, n0, sink);
}

// Nout is 256 or a small multiple of 8 (a head). Wide layers: each warp
// takes 64 rays by 32 outputs, so an A tile is reused for four products and a
// B pair for four.
template <class P, class Sink>
__device__ __forceinline__ void dense_bf16(const __nv_bfloat16* in, int ld,
                                           int K, const __nv_bfloat16* Wg,
                                           int Nout, Sink& epi) {
  static_assert(P::TILE == 64 && P::THREADS == 256, "8 warps of 64 rays");
  const int warp = threadIdx.x >> 5;
  if (Nout == 256) {
    warp_tile_bf16<4, 4>(in, ld, K, Wg, 0, warp * 32, epi);
  } else {
    const int items = (P::TILE / 16) * (Nout / 8);
    for (int it = warp; it < items; it += P::THREADS / 32)
      warp_tile_bf16<1, 1>(in, ld, K, Wg, (it % (P::TILE / 16)) * 16,
                           (it / (P::TILE / 16)) * 8, epi);
  }
}

// ------------------------------------------------------------ int8 / mma --

constexpr int kPadS8 = 16;  // bytes; keeps ldmatrix rows on distinct banks

// Column of feature n in an int8 operand buffer: inside a chunk of 64,
// feature 16t + 8h + 4j + e sits at byte 32h + 16j + 4t + e, so that a
// lane's 16 contiguous panel bytes (k = 16t .. 16t+15) are, word by word,
// the B fragments (k-quads 4t and 16 + 4t) of the chunk's two `mma`s.
__device__ __forceinline__ int col_s8(int n) {
  return (n & ~63) | ((n & 8) << 2) | ((n & 4) << 2) | ((n >> 2) & 12) |
         (n & 3);
}

__device__ __forceinline__ void mma_16x8x32_s8(int (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The int8 twin of warp_acc_bf16: K a multiple of 64, `ld` in bytes, summed
// exactly in int32.
template <int MT, int NT>
__device__ __forceinline__ void warp_acc_s8(const int8_t* in, int ld, int K,
                                            const int8_t* Wg, int m0, int n0,
                                            int (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* arow = in + (m0 + (lane & 15)) * ld + (lane >> 4) * 16;
  const int8_t* brow = Wg + (size_t)(n0 + g) * K + 16 * t;
  for (int kc = 0; kc < K; kc += 64) {
    uint4 bv[NT];  // k-quads q = 0..3 of this lane, for every n-tile
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      bv[ni] = __ldg(reinterpret_cast<const uint4*>(brow + (size_t)ni * 8 * K + kc));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_a(a[mi], arow + mi * 16 * ld + kc + 32 * h);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const uint32_t b[2] = {h ? bv[ni].z : bv[ni].x, h ? bv[ni].w : bv[ni].y};
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_16x8x32_s8(acc[mi][ni], a[mi], b);
      }
    }
  }
}

// The whole product of a warp tile. The sums go to `sink` as floats:
// |acc| <= 256 * 127 * 127 < 2^24, so the conversion is exact.
template <int MT, int NT, class Sink>
__device__ __forceinline__ void warp_tile_s8(const int8_t* in, int ld, int K,
                                             const int8_t* Wg, int m0, int n0,
                                             Sink& sink) {
  int acc[MT][NT][4] = {};
  warp_acc_s8<MT, NT>(in, ld, K, Wg, m0, n0, acc);
  warp_emit<MT, NT>(acc, m0, n0, sink);
}

// Same split of a layer over the block's 8 warps as dense_bf16.
template <class P, class Sink>
__device__ __forceinline__ void dense_s8(const int8_t* in, int ld, int K,
                                         const int8_t* Wg, int Nout,
                                         Sink& epi) {
  static_assert(P::TILE == 64 && P::THREADS == 256, "8 warps of 64 rays");
  const int warp = threadIdx.x >> 5;
  if (Nout == 256) {
    warp_tile_s8<4, 4>(in, ld, K, Wg, 0, warp * 32, epi);
  } else if (Nout == 128) {
    warp_tile_s8<4, 2>(in, ld, K, Wg, 0, warp * 16, epi);
  } else {
    const int items = (P::TILE / 16) * (Nout / 8);
    for (int it = warp; it < items; it += P::THREADS / 32)
      warp_tile_s8<1, 1>(in, ld, K, Wg, (it % (P::TILE / 16)) * 16,
                         (it / (P::TILE / 16)) * 8, epi);
  }
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
// accumulator into the value of the pack dtype to keep (round, bias,
// activation), and the value goes to dst[ray * ld_dst + P::col(out)], an
// operand buffer in shared memory; the bf16 path stores a lane's
// (out, out + 1) pair, which stays adjacent under `col`, as one word. The
// caller synchronises the block afterwards.
template <class P, class Fn>
__device__ __forceinline__ void dense_store(const typename P::T* in, int ld,
                                            int K, const typename P::T* Wg,
                                            int Nout, typename P::T* dst,
                                            int ld_dst, Fn fn) {
  if constexpr (P::kTensorCore) {
    auto sink = [&](int r, int n, float a0, float a1) {
      __nv_bfloat162 v;
      v.x = fn(r, n, a0);
      v.y = fn(r, n + 1, a1);
      *reinterpret_cast<__nv_bfloat162*>(dst + r * ld_dst + P::col(n)) = v;
    };
    dense_bf16<P>(in, ld, K, Wg, Nout, sink);
  } else {
    auto sink = [&](int r, int n, float a) { dst[r * ld_dst + n] = fn(r, n, a); };  // col is the identity
    dense_f32<P>(in, ld, K, Wg, Nout, sink);
  }
}

// The same product for a head: fn(ray, out, acc) is called for every element
// and stores what it wants where it wants.
template <class P, class Fn>
__device__ __forceinline__ void dense_each(const typename P::T* in, int ld,
                                           int K, const typename P::T* Wg,
                                           int Nout, Fn fn) {
  if constexpr (P::kTensorCore) {
    auto sink = [&](int r, int n, float a0, float a1) {
      fn(r, n, a0);
      fn(r, n + 1, a1);
    };
    dense_bf16<P>(in, ld, K, Wg, Nout, sink);
  } else {
    dense_f32<P>(in, ld, K, Wg, Nout, fn);
  }
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
