// Fused positional encoding -> NeRF MLP (-> alpha composite) for Hopper.
//
// Replaces two TPU kernels of pronerf_tpu/kernels/fused_nerf.py that share
// one chain (_forward): fused_nerf_raw_t (body _kernel), which returns raw
// [N, S, 4], and fused_nerf_composite_t (body _make_composite_kernel), which
// composites along the ray instead.
//
// Bound on this card: operations. A point costs about 0.59 M multiply-adds
// against 12 input and 16 output bytes; the 26 panels are about 1.2 MB in
// bf16 and stay in L2. Written layer by layer with a library, each [P, 256]
// activation would cross device memory twice and the chain would be
// memory-bound; here a block owns a tile of rays, loops over the ray's S
// samples itself, and keeps every activation of the chain in shared memory.
// The TPU kernel walks a (ray-block, sample) grid in order and revisits its
// output block to carry the transmittance; blocks on a GPU run in no order,
// so the sample loop is inside the block: the S raw results of a tile are
// kept in shared memory, and either stored as one contiguous chunk (raw) or
// composited by one thread per ray with the transmittance in a register
// (composite), in which case raw never reaches device memory.
//
// What limits it in practice is not the tensor cores but how each warp
// fetches its weight fragments through L1: common.cuh reads them as 16-byte
// loads against activations stored with a permuted k order, and keeps two
// blocks resident per SM.
//
// The frequency panel bx_t is 2^k by construction (one non-zero per row), so
// `bx_t . x` rounded to the pack dtype is exactly ldexp(x, k); the wrapper
// checks the panel before it drops it from the blob.
//
// Weight blob, pack dtype, in this order (w_t [out, K], K a multiple of 32):
//   w0p 256x64 b0 | w1..w4 256x256 + b | w5p 256x64 w5h 256x256 b5 |
//   w6 b6 w7 b7 | w_alpha 8x256 b_alpha 8 | w_feat 256x256 b_feat 256 |
//   wvf 128x256 bv 128 | w_rgb 8x128 b_rgb 8

#include "common.cuh"

namespace pn {

constexpr int kWH = 128;   // view branch width
constexpr int kL = 10;     // position octaves
constexpr int kPE = 64;    // 3 + 2 * 3 * kL = 63, padded

struct NerfBlob {
  static constexpr long long sq = (long long)kW * kW;
  static constexpr long long w0p = 0, b0 = w0p + kW * kPE;
  static constexpr long long w1 = b0 + kW;            // w_i at w1 + (i-1)*lay
  static constexpr long long lay = sq + kW;
  static constexpr long long w5p = w1 + 4 * lay, w5h = w5p + kW * kPE,
                             b5 = w5h + sq;
  static constexpr long long w6 = b5 + kW, w7 = w6 + lay;
  static constexpr long long w_alpha = w7 + lay, b_alpha = w_alpha + 8 * kW;
  static constexpr long long w_feat = b_alpha + 8, b_feat = w_feat + sq;
  static constexpr long long wvf = b_feat + kW, bv = wvf + kWH * kW;
  static constexpr long long w_rgb = bv + kWH, b_rgb = w_rgb + 8 * kWH;
  static constexpr long long total = b_rgb + 8;
};

struct NerfArgs {
  const float* pts;    // [S*3, N]
  const float* vcon;   // [128, N]
  const void* blob;
  int N, S;
  // raw
  float* raw;          // [N, S, 4]
  // composite
  const float* z;      // [S, N]
  const float* mm_add; // [S, N]
  const float* mm_mul; // [S, N]
  const float* dnorm;  // [N]
  float* rgb;          // [N, 3]
  float* depth;        // [N]
  float* disp;         // [N]
  float* acc;          // [N]
  float* weights;      // [N, S]
  float* sigma;        // [N, S]
  int white_bkgd;
};

template <class P>
constexpr size_t nerf_smem(int S) {
  return sizeof(typename P::T) *
             ((size_t)2 * P::TILE * (kW + P::PAD) +
              (size_t)P::TILE * (kPE + P::PAD) +
              (size_t)P::TILE * (kWH + P::PAD)) +
         sizeof(float) * P::TILE * S * 4;
}

template <class P, bool COMPOSITE>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS) nerf_kernel(NerfArgs a) {
  using T = typename P::T;
  using B = NerfBlob;
  constexpr int TILE = P::TILE, LD = kW + P::PAD, LDPE = kPE + P::PAD,
                LDVC = kWH + P::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufA = reinterpret_cast<T*>(smem_raw);
  T* bufB = bufA + TILE * LD;
  T* pe = bufB + TILE * LD;
  T* vc = pe + TILE * LDPE;
  float* res = reinterpret_cast<float*>(vc + TILE * LDVC);  // [TILE][S][4]

  const T* w = reinterpret_cast<const T*>(a.blob);
  const int N = a.N, S = a.S;
  const int base = blockIdx.x * TILE;

  // per-ray view contribution, cast to the pack dtype once for all samples
  for (int idx = threadIdx.x; idx < TILE * kWH; idx += P::THREADS) {
    const int r = idx % TILE, n = idx / TILE, ray = base + r;
    vc[r * LDVC + n] = P::rnd(ray < N ? a.vcon[(size_t)n * N + ray] : 0.0f);
  }

  // out = relu(round(in . w^T) + bias), the plain hidden layer
  auto hidden = [&](const T* in, int ld, int K, const T* wp, const T* bp,
                    T* out) {
    dense_store<P>(in, ld, K, wp, kW, out, LD, [&](int, int n, float acc) {
      return relu<P>(add<P>(P::rnd(acc), ro(bp + n)));
    });
    __syncthreads();
  };

  for (int s = 0; s < S; ++s) {
    // positional encoding rows [x(3) | sin(30) | cos(30) | 0]
    for (int idx = threadIdx.x; idx < TILE * 3; idx += P::THREADS) {
      const int r = idx % TILE, c = idx / TILE, ray = base + r;
      const T x =
          P::rnd(ray < N ? a.pts[(size_t)(3 * s + c) * N + ray] : 0.0f);
      T* row = pe + r * LDPE;
      row[P::col(c)] = x;
      const float xf = P::f(x);
#pragma unroll
      for (int k = 0; k < kL; ++k) {
        float sn, cs;
        sincosf(ldexpf(xf, k), &sn, &cs);
        row[P::col(3 + 3 * k + c)] = P::rnd(sn);
        row[P::col(3 + 3 * kL + 3 * k + c)] = P::rnd(cs);
      }
      if (c == 0) row[P::col(kPE - 1)] = P::rnd(0.0f);
    }
    __syncthreads();

    hidden(pe, LDPE, kPE, w + B::w0p, w + B::b0, bufA);
    hidden(bufA, LD, kW, w + B::w1, w + B::w1 + B::sq, bufB);
    hidden(bufB, LD, kW, w + B::w1 + B::lay, w + B::w1 + B::lay + B::sq, bufA);
    hidden(bufA, LD, kW, w + B::w1 + 2 * B::lay,
           w + B::w1 + 2 * B::lay + B::sq, bufB);
    hidden(bufB, LD, kW, w + B::w1 + 3 * B::lay,
           w + B::w1 + 3 * B::lay + B::sq, bufA);

    // layer 5: two separately rounded dots, added, then the bias
    dense_store<P>(pe, LDPE, kPE, w + B::w5p, kW, bufB, LD,
                   [&](int, int, float acc) { return P::rnd(acc); });
    __syncthreads();
    dense_store<P>(bufA, LD, kW, w + B::w5h, kW, bufB, LD,
                   [&](int r, int n, float acc) {
                     const T both =
                         add<P>(bufB[r * LD + P::col(n)], P::rnd(acc));
                     return relu<P>(add<P>(both, ro(w + B::b5 + n)));
                   });
    __syncthreads();

    hidden(bufB, LD, kW, w + B::w6, w + B::w6 + B::sq, bufA);
    hidden(bufA, LD, kW, w + B::w7, w + B::w7 + B::sq, bufB);

    // heads on h = bufB: sigma (row 0 of 8) and the feature layer
    float* rs = res + s * 4;
    dense_each<P>(bufB, LD, kW, w + B::w_alpha, 8,
                  [&](int r, int n, float acc) {
                    if (n == 0)
                      rs[r * S * 4 + 3] =
                          P::f(add<P>(P::rnd(acc), ro(w + B::b_alpha)));
                  });
    dense_store<P>(bufB, LD, kW, w + B::w_feat, kW, bufA, LD,
                   [&](int, int n, float acc) {
                     return add<P>(P::rnd(acc), ro(w + B::b_feat + n));
                   });
    __syncthreads();
    // view branch: relu(round(round(dot + vcon) + bv)), 128 wide, into bufB
    dense_store<P>(bufA, LD, kW, w + B::wvf, kWH, bufB, LD,
                   [&](int r, int n, float acc) {
                     const T withv = add<P>(P::rnd(acc), vc[r * LDVC + n]);
                     return relu<P>(add<P>(withv, ro(w + B::bv + n)));
                   });
    __syncthreads();
    dense_each<P>(bufB, LD, kWH, w + B::w_rgb, 8,
                  [&](int r, int n, float acc) {
                    if (n < 3)
                      rs[r * S * 4 + n] =
                          P::f(add<P>(P::rnd(acc), ro(w + B::b_rgb + n)));
                  });
    __syncthreads();
  }

  const int live = min(TILE, N - base);
  if constexpr (!COMPOSITE) {
    // the tile's [live, S, 4] results are one contiguous chunk of raw
    float4* dst = reinterpret_cast<float4*>(a.raw + (size_t)base * S * 4);
    const float4* src = reinterpret_cast<const float4*>(res);
    for (int idx = threadIdx.x; idx < live * S; idx += P::THREADS)
      dst[idx] = src[idx];
  } else {
    // one thread per ray; all f32, transmittance in a register
    for (int r = threadIdx.x; r < live; r += P::THREADS) {
      const int ray = base + r;
      const float dn = a.dnorm[ray];
      float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dsum = 0.0f,
            asum = 0.0f;
      float zs = a.z[ray];
      for (int s = 0; s < S; ++s) {
        const float* q = res + (r * S + s) * 4;
        const float znext = s + 1 < S ? a.z[(size_t)(s + 1) * N + ray] : 0.0f;
        const float dist = (s + 1 < S ? znext - zs : 1e10f) * dn;
        const float sig = q[3];
        float alpha =
            1.0f - expf(-fmaxf(sig + a.mm_add[(size_t)s * N + ray], 0.0f) *
                        dist);
        alpha *= fmaxf(a.mm_mul[(size_t)s * N + ray], 0.0f);
        const float wgt = alpha * trans;
        c0 += wgt * (1.0f / (1.0f + expf(-q[0])));
        c1 += wgt * (1.0f / (1.0f + expf(-q[1])));
        c2 += wgt * (1.0f / (1.0f + expf(-q[2])));
        dsum += wgt * zs;
        asum += wgt;
        trans *= 1.0f - alpha + 1e-10f;
        a.weights[(size_t)ray * S + s] = wgt;
        a.sigma[(size_t)ray * S + s] = sig;
        zs = znext;
      }
      const float ratio = dsum / asum;
      // max(1e-10, NaN) is NaN in the reference; fmaxf would drop it
      a.disp[ray] = 1.0f / (ratio != ratio ? ratio : fmaxf(1e-10f, ratio));
      if (a.white_bkgd) {
        c0 += 1.0f - asum;
        c1 += 1.0f - asum;
        c2 += 1.0f - asum;
      }
      a.rgb[(size_t)ray * 3 + 0] = c0;
      a.rgb[(size_t)ray * 3 + 1] = c1;
      a.rgb[(size_t)ray * 3 + 2] = c2;
      a.depth[ray] = dsum;
      a.acc[ray] = asum;
    }
  }
}

template <class P, bool COMPOSITE>
int run_nerf(const NerfArgs& a, cudaStream_t stream) {
  const int blocks = (a.N + P::TILE - 1) / P::TILE;
  return launch(nerf_kernel<P, COMPOSITE>, blocks, P::THREADS,
                nerf_smem<P>(a.S), stream, a);
}

inline bool nerf_args_ok(int N, int S, long long blob_elems) {
  return N > 0 && S > 0 && S <= 64 && blob_elems == NerfBlob::total;
}

}  // namespace pn

// Both return the CUDA error of the launch (0 = launched), or -1 for
// arguments the kernel does not take.
extern "C" int pn_fused_nerf_raw(const float* pts24_t, const float* vcon_t,
                                 const void* blob, long long blob_elems,
                                 float* raw, int N, int S, int pack_bf16,
                                 void* stream) {
  if (!pn::nerf_args_ok(N, S, blob_elems)) return -1;
  pn::NerfArgs a = {};
  a.pts = pts24_t;
  a.vcon = vcon_t;
  a.blob = blob;
  a.N = N;
  a.S = S;
  a.raw = raw;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return pack_bf16 ? pn::run_nerf<pn::PBf16, false>(a, s)
                   : pn::run_nerf<pn::PF32, false>(a, s);
}

extern "C" int pn_fused_nerf_composite(
    const float* pts24_t, const float* vcon_t, const float* z_t,
    const float* mm_add_t, const float* mm_mul_t, const float* dnorm,
    const void* blob, long long blob_elems, float* rgb, float* depth,
    float* disp, float* acc, float* weights, float* sigma, int N, int S,
    int white_bkgd, int pack_bf16, void* stream) {
  if (!pn::nerf_args_ok(N, S, blob_elems)) return -1;
  pn::NerfArgs a = {};
  a.pts = pts24_t;
  a.vcon = vcon_t;
  a.blob = blob;
  a.N = N;
  a.S = S;
  a.z = z_t;
  a.mm_add = mm_add_t;
  a.mm_mul = mm_mul_t;
  a.dnorm = dnorm;
  a.rgb = rgb;
  a.depth = depth;
  a.disp = disp;
  a.acc = acc;
  a.weights = weights;
  a.sigma = sigma;
  a.white_bkgd = white_bkgd;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return pack_bf16 ? pn::run_nerf<pn::PBf16, true>(a, s)
                   : pn::run_nerf<pn::PF32, true>(a, s);
}
