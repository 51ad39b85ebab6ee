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
// samples itself, and keeps every activation of the chain on the SM.
// The TPU kernel walks a (ray-block, sample) grid in order and revisits its
// output block to carry the transmittance; blocks on a GPU run in no order,
// so the sample loop is inside the block: the raw results of a tile are
// kept in shared memory, kResChunk samples at a time, and either stored
// (raw) or composited by one thread per ray with the transmittance in a
// register (composite), in which case raw never reaches device memory. The
// chunks make every buffer independent of S, so the kernels take any S, as
// the TPU kernel's sample grid axis does: a ray's running sums cross from
// one chunk to the next through its own outputs.
//
// Two kernels share that frame.
//
// bf16 (`nerf_wg_kernel`, the serving path). What stands between the chain
// and the tensor-core rate is operand traffic and everything that is not a
// product: the weights have to reach every SM once per 128 rays and sample
// (1.18 MB a pass, from L2), the activations change every layer, and each
// layer ends in an epilogue of a few hundred instructions a thread. The
// design:
//  * products are `wgmma` m64n128k16: a warpgroup owns 64 rays and computes a
//    256-wide layer as two halves of 128 outputs, f32 sums in 64 registers a
//    thread (with all 256 outputs at once, 128 accumulators beside the 64 A
//    registers, ptxas runs out of registers and serializes every product);
//  * activations never leave the registers: rounded, biased, clamped and
//    packed in pairs, the accumulators of one layer are the A fragments of
//    the next (hopper.cuh), so a hidden layer has no shared-memory round trip
//    and no block-wide barrier;
//  * weights stream through a ring of 32 KB stages in shared memory, filled
//    by bulk asynchronous copies that complete on mbarriers. The wrapper lays
//    the blob out as the stage images themselves (k-slabs of 64, 128-byte
//    swizzle, in the order the chain consumes them), so a stage is one
//    contiguous copy. One producer thread runs ahead of the consumers across
//    layer, sample and tile boundaries; a stage is released by every consumer
//    warp after the wait that covers its last read;
//  * a block is two consumer warpgroups (128 rays a weight pass) and a third
//    warpgroup of helpers, one block per SM, persistent: it walks tiles
//    blockIdx.x, + gridDim.x, ...; `setmaxnreg` moves the helpers' registers
//    to the consumers;
//  * the two consumer warpgroups take turns at the tensor cores, one block of
//    16 products each (named barriers), so that one's epilogue runs while the
//    other's products execute;
//  * the helpers do what is not a product: one thread fills the ring; three
//    warps write the PE rows ([x | sin | cos | 0], A of layer 0 and of layer
//    5's PE product, swizzled, read through a descriptor) up to two samples
//    ahead, and store or composite a finished tile while the consumers work on
//    the next one. mbarriers hand the PE and result buffers back and forth;
//  * layer 5 needs two separately rounded sums per output: per half, the PE
//    product is rounded and packed before the h product of that half;
//  * the two heads and the biases stay in shared memory for the block's
//    life; `vcon` is kept per tile in the order of the view layer's
//    accumulator fragments.
// Sharing each stage across a cluster of 2 or 4 blocks (multicast copies)
// was measured and is slower: L2 is not the limit, and the blocks of a
// cluster then wait for each other at every stage.
//
// f32 (`nerf_kernel<PF32>`, the exactness check, not on the serving path):
// plain FMA loops through common.cuh, activations in shared memory.
//
// DoNeRF (`donerf_wg_kernel`, the radiance net of `netarch = donerf`): the
// bf16 kernel's frame with another layer schedule (`DoNeRFNet`): the PE
// layer, six hidden layers of 256, then a head 256 -> 4 (padded to 8,
// resident in shared memory as the NeRF heads are), whose f32 sums take the
// per-ray direction term dcon = W7[:, 256:] . d_pe (computed outside, [4, N],
// the view features entering at the last layer) before they are rounded. The
// ring, the PE rows, the result buffers and the composite are the NeRF
// kernel's code; only the consumers' chain a sample and the blob differ.
//
// The frequency panel bx_t is 2^k by construction (one non-zero per row), so
// `bx_t . x` is exactly ldexp(x, k), taken from the f32 point in both
// kernels; only x itself and sin/cos are rounded to the pack dtype (as the
// XLA serving path encodes; the Pallas kernel rounds x first, which costs a
// trained scene 3.6 dB). The wrapper checks the panel before it drops it
// from the blob.
//
// Weight blob, f32, in this order (w_t [out, K], K a multiple of 32):
//   w0p 256x64 b0 | w1..w4 256x256 + b | w5p 256x64 w5h 256x256 b5 |
//   w6 b6 w7 b7 | w_alpha 8x256 b_alpha 8 | w_feat 256x256 b_feat 256 |
//   wvf 128x256 bv 128 | w_rgb 8x128 b_rgb 8
// Weight blob, bf16: 37 ring stages (WgBlob::stage_off), then the head
// slabs (w_alpha 4 x [8 x 64], w_rgb 2 x [8 x 64]), then the biases
// b0..b7 b_feat bv b_alpha b_rgb; see `_blob` in ../fused_nerf.py.
// DoNeRF blob, bf16: 25 ring stages (w0p, then w1..w6 in halves), the head
// slabs (w_out 4 x [8 x 64]), the biases b0..b6 b_out (DoWgBlob).

#include "common.cuh"
#include "hopper.cuh"

namespace pn {

constexpr int kWH = 128;   // view branch width (kL, kPE: hopper.cuh)

struct NerfBlob {  // the f32 blob, in elements
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
  const float* vcon;   // [128, N]; DoNeRF: the head's direction term [4, N]
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

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A tile's results cross shared memory this many samples at a time, as
// [ray][kResChunk][4]; S = 8, the release configs', is one chunk.
constexpr int kResChunk = 8;

// The streaming composite of one ray over samples [s0, s0 + n) of its S,
// whose raw results (rgb logits, sigma) are q [n][4]; all f32, transmittance
// in a register. Between chunks the running sums wait in the ray's own
// outputs (rgb, depth, acc, and the transmittance in disp), written and read
// back by the same thread, so a ray composites in one pass over its S
// samples, whatever the chunks, in the order of a single loop.
template <class T>
__device__ __forceinline__ void composite_ray(const NerfArgs& a, int ray,
                                              int s0, int n, const T* q) {
  const int N = a.N, S = a.S;
  const float dn = a.dnorm[ray];
  float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dsum = 0.0f,
        asum = 0.0f;
  if (s0 > 0) {
    c0 = a.rgb[(size_t)ray * 3 + 0];
    c1 = a.rgb[(size_t)ray * 3 + 1];
    c2 = a.rgb[(size_t)ray * 3 + 2];
    dsum = a.depth[ray];
    asum = a.acc[ray];
    trans = a.disp[ray];
  }
  float zs = a.z[(size_t)s0 * N + ray];
  for (int s = s0; s < s0 + n; ++s, q += 4) {
    const float znext = s + 1 < S ? a.z[(size_t)(s + 1) * N + ray] : 0.0f;
    const float dist = (s + 1 < S ? znext - zs : 1e10f) * dn;
    const float sig = as_f32(q[3]);
    float alpha =
        1.0f -
        expf(-fmaxf(sig + a.mm_add[(size_t)s * N + ray], 0.0f) * dist);
    alpha *= fmaxf(a.mm_mul[(size_t)s * N + ray], 0.0f);
    const float wgt = alpha * trans;
    c0 += wgt * (1.0f / (1.0f + expf(-as_f32(q[0]))));
    c1 += wgt * (1.0f / (1.0f + expf(-as_f32(q[1]))));
    c2 += wgt * (1.0f / (1.0f + expf(-as_f32(q[2]))));
    dsum += wgt * zs;
    asum += wgt;
    trans *= 1.0f - alpha + 1e-10f;
    a.weights[(size_t)ray * S + s] = wgt;
    a.sigma[(size_t)ray * S + s] = sig;
    zs = znext;
  }
  if (s0 + n < S) {   // more chunks to come: park the running sums
    a.rgb[(size_t)ray * 3 + 0] = c0;
    a.rgb[(size_t)ray * 3 + 1] = c1;
    a.rgb[(size_t)ray * 3 + 2] = c2;
    a.depth[ray] = dsum;
    a.acc[ray] = asum;
    a.disp[ray] = trans;
    return;
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

// The results of samples [s0, s0 + n) of `live` rays from `base`, res
// [ray][kResChunk][4], into raw [N, S, 4]: thread `t` of `threads` (one
// ray's n results are contiguous in raw). The index runs over whole chunks
// (a shift and a mask, no division: the helper warps that store a tile also
// write the next sample's PE rows); slots past n are skipped.
__device__ __forceinline__ float4 as_float4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 as_float4(const __nv_bfloat16* q) {
  const uint2 v = *reinterpret_cast<const uint2*>(q);
  return make_float4(hp::bf16_lo(v.x), hp::bf16_hi(v.x), hp::bf16_lo(v.y),
                     hp::bf16_hi(v.y));
}
template <class T>
__device__ __forceinline__ void store_raw(const NerfArgs& a, int base,
                                          int live, int s0, int n,
                                          const T* res, int t, int threads) {
  static_assert((kResChunk & (kResChunk - 1)) == 0, "a power of two");
  float4* dst = reinterpret_cast<float4*>(a.raw);
  for (int idx = t; idx < live * kResChunk; idx += threads) {
    const int r = idx / kResChunk, j = idx % kResChunk;
    if (j < n)
      dst[(size_t)(base + r) * a.S + s0 + j] = as_float4(res + idx * 4);
  }
}

// ------------------------------------------------------------------ f32 --

template <class P>
constexpr size_t nerf_smem() {
  return sizeof(typename P::T) *
             ((size_t)2 * P::TILE * (kW + P::PAD) +
              (size_t)P::TILE * (kPE + P::PAD) +
              (size_t)P::TILE * (kWH + P::PAD)) +
         sizeof(float) * P::TILE * kResChunk * 4;
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
  // [TILE][kResChunk][4]
  float* res = reinterpret_cast<float*>(vc + TILE * LDVC);

  const T* w = reinterpret_cast<const T*>(a.blob);
  const int N = a.N, S = a.S;
  const int base = blockIdx.x * TILE;
  const int live = min(TILE, N - base);

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

  for (int s0 = 0; s0 < S; s0 += kResChunk) {
    const int n_s = min(kResChunk, S - s0);
    for (int s = s0; s < s0 + n_s; ++s) {
      // positional encoding rows [x(3) | sin(30) | cos(30) | 0]
      for (int idx = threadIdx.x; idx < TILE * 3; idx += P::THREADS) {
        const int r = idx % TILE, c = idx / TILE, ray = base + r;
        const float xf = ray < N ? a.pts[(size_t)(3 * s + c) * N + ray] : 0.0f;
        T* row = pe + r * LDPE;
        row[P::col(c)] = P::rnd(xf);   // the arguments below from the f32 x
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
      hidden(bufB, LD, kW, w + B::w1 + B::lay, w + B::w1 + B::lay + B::sq,
             bufA);
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
      float* rs = res + (s - s0) * 4;
      dense_each<P>(bufB, LD, kW, w + B::w_alpha, 8,
                    [&](int r, int n, float acc) {
                      if (n == 0)
                        rs[r * kResChunk * 4 + 3] =
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
                        rs[r * kResChunk * 4 + n] =
                            P::f(add<P>(P::rnd(acc), ro(w + B::b_rgb + n)));
                    });
      __syncthreads();
    }
    // the chunk's results: stored, or composited by one thread per ray
    if constexpr (!COMPOSITE)
      store_raw(a, base, live, s0, n_s, res, threadIdx.x, P::THREADS);
    else
      for (int r = threadIdx.x; r < live; r += P::THREADS)
        composite_ray(a, base + r, s0, n_s, res + r * kResChunk * 4);
    __syncthreads();
  }
}

// ----------------------------------------------------------------- bf16 --

// The frame (kWgTile, kWgThreads, kHelpers, the ring, the turns, the dense
// products and epilogues, the PE rows' writer `wg_write_pe`) is hopper.cuh's.

struct WgBlob {  // the bf16 blob, in bytes
  static constexpr int kStageBytes = 32768;
  static constexpr int kStagesPerSample = 37;
  // stages 17 and 20 (the PE slab of each half of layer 5) are 16 KB
  __host__ __device__ static constexpr int stage_bytes(int i) {
    return i == 17 || i == 20 ? kStageBytes / 2 : kStageBytes;
  }
  __host__ __device__ static constexpr int stage_off(int i) {
    return i * kStageBytes - (i > 17 ? kStageBytes / 2 : 0) -
           (i > 20 ? kStageBytes / 2 : 0);
  }
  static constexpr int kRingBytes = 36 * kStageBytes;
  static constexpr int kAlphaBytes = 4 * 1024, kRgbBytes = 2 * 1024;
  static constexpr int kHeadBytes = kAlphaBytes + kRgbBytes;
  static constexpr int heads = kRingBytes, biases = heads + kHeadBytes;
  // bias offsets, in elements: b0..b7, b_feat, bv, b_alpha, b_rgb
  static constexpr int b_feat = 8 * kW, bv = b_feat + kW, b_alpha = bv + kWH,
                       b_rgb = b_alpha + 8, kBiases = b_rgb + 8;
  static constexpr long long kBlobElems = (biases + 2 * kBiases) / 2;
};
static_assert(WgBlob::stage_off(WgBlob::kStagesPerSample) ==
                  WgBlob::kRingBytes, "the stages tile the ring region");
static_assert(WgBlob::kStageBytes == kRingStageBytes, "a stage fills a slot");

// Shared memory of the bf16 kernel, from a 1,024-byte boundary. The PE rows
// have two buffers (the next sample's are written while this one's are read),
// the results two of one chunk each (the consumers fill one while the
// helpers empty the other), and the ring four weight stages, whatever S.
struct WgSmem {
  static constexpr int kPeBytes = kWgRays * kPE * 2;    // one warpgroup's rows
  static constexpr int pe = 0;                          // [2][2 wg][64][64]
  static constexpr int heads = pe + 4 * kPeBytes;       // as in the blob
  static constexpr int bias = heads + WgBlob::kHeadBytes;   // f32
  static constexpr int vfrag = bias + 10240;            // 2 x 128 x 32 words
  static constexpr int bars = vfrag + 2 * 128 * 32 * 4;
  static constexpr int res = bars + 256;   // 2 x [128][kResChunk][4] bf16
  static constexpr int kResBytes = kWgTile * kResChunk * 8;
  static constexpr int ring = (res + 2 * kResBytes + 1023) & ~1023;
  static constexpr int bytes = 1024 + ring + kMaxStages * WgBlob::kStageBytes;
};
static_assert(WgBlob::kBiases * 4 <= 10240, "bias region");
static_assert(WgSmem::bytes <= 232448, "what fits");

struct DoWgBlob {  // the DoNeRF bf16 blob, in bytes
  static constexpr int kStageBytes = 32768;
  // layer 0 (both halves in one stage), then layers 1..6 in four stages
  static constexpr int kStagesPerSample = 1 + 6 * 4;
  __host__ __device__ static constexpr int stage_bytes(int) {
    return kStageBytes;
  }
  __host__ __device__ static constexpr int stage_off(int i) {
    return i * kStageBytes;
  }
  static constexpr int kRingBytes = kStagesPerSample * kStageBytes;
  static constexpr int kHeadBytes = 4 * 1024;   // w_out 4 x [8 x 64]
  static constexpr int heads = kRingBytes, biases = heads + kHeadBytes;
  // bias offsets, in elements: b0..b6, b_out
  static constexpr int b_out = 7 * kW, kBiases = b_out + 8;
  static constexpr long long kBlobElems = (biases + 2 * kBiases) / 2;
};
static_assert(DoWgBlob::kHeadBytes <= WgBlob::kHeadBytes, "head region");
static_assert(DoWgBlob::kBiases * 4 <= 10240, "bias region");

// The layer schedule of a net on the warpgroup frame: its blob, and whether
// its chain is DoNeRF's (PE layer, six hidden layers, the head with the
// direction term) or the NeRF MLP's (skip at layer 5, the heads, the view
// branch).
struct NerfNet {
  using Blob = WgBlob;
  static constexpr bool kDoNeRF = false;
};
struct DoNeRFNet {
  using Blob = DoWgBlob;
  static constexpr bool kDoNeRF = true;
};

// The body of both bf16 kernels; `Net` picks the consumers' chain a sample
// and the blob, everything else is shared.
template <class Net, bool COMPOSITE>
__device__ __forceinline__ void wg_kernel_body(const NerfArgs& a) {
  using B = typename Net::Blob;
  using M = WgSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const uint32_t sm32 = hp::smem_u32(sm);

  const int N = a.N, S = a.S;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t n_stages = kMaxStages, n_res = 2;
  // mbarriers: the weight ring, the heads, the PE rows, the results
  const uint32_t full = sm32 + M::bars, empty = full + 8 * kMaxStages,
                 head_bar = empty + 8 * kMaxStages, pe_full = head_bar + 8,
                 pe_empty = pe_full + 16, res_full = pe_empty + 16,
                 res_empty = res_full + 16;
  const uint32_t ring_buf = sm32 + M::ring;
  const unsigned char* blob = static_cast<const unsigned char*>(a.blob);
  const int n_tiles = (N + kWgTile - 1) / kWgTile;

  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, 8);   // consumer warps
    }
    hp::mbar_init(head_bar, 1);
    for (int i = 0; i < 2; ++i) {
      hp::mbar_init(pe_full + 8 * i, 3);     // helper warps
      hp::mbar_init(pe_empty + 8 * i, 8);    // consumer warps
      hp::mbar_init(res_full + 8 * i, 8);    // consumer warps
      hp::mbar_init(res_empty + 8 * i, 3);   // helper warps
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------- helper warps --
    hp::setmaxnreg_dec<72>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    if (warp == 0) {
      // the weights: one thread keeps the ring full
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(head_bar, B::kHeadBytes);
        hp::bulk_g2s(sm32 + M::heads, blob + B::heads, B::kHeadBytes,
                     head_bar);
        WgRingFill fill = {{empty, n_stages, 0, 0}, full, ring_buf};
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
          for (int s = 0; s < S; ++s)
            for (int i = 0; i < B::kStagesPerSample; ++i)
              fill.put(blob + B::stage_off(i), B::stage_bytes(i));
      }
    } else {
      // Three warps do what is not a product. They write the PE rows, up to
      // two samples ahead of the consumers, and they store (raw) or
      // composite the chunk of samples of a tile the consumers have just
      // finished, while those work on the next one: after the second
      // sample's rows, when both PE buffers are full and there is nothing
      // else to do.
      const int t = tid - (kWgThreads - kHelpers);
      WgTurns pt = {pe_empty, 2, 0, 0}, rt = {res_full, n_res, 0, 0};
      auto output = [&](int tile, int s0) {
        hp::mbar_wait(rt.bar(), rt.phase);
        const int base = tile * kWgTile;
        const int live = min(kWgTile, N - base), n = min(kResChunk, S - s0);
        const __nv_bfloat16* res = reinterpret_cast<const __nv_bfloat16*>(
            sm + M::res + rt.at * M::kResBytes);
        if constexpr (!COMPOSITE) {
          store_raw(a, base, live, s0, n, res, t, kHelpers);
        } else {
          // one thread per ray, the same one for every chunk of the tile
          for (int r = t; r < live; r += kHelpers)
            composite_ray(a, base + r, s0, n,
                          res + (size_t)r * kResChunk * 4);
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(res_empty + 8 * rt.at);
        rt.next();
      };
      int done_tile = -1, done_s0 = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int s0 = 0; s0 < S; s0 += kResChunk) {
          const int n = min(kResChunk, S - s0);
          for (int s = s0; s < s0 + n; ++s) {
            hp::mbar_wait(pt.bar(), pt.phase ^ 1);
            wg_write_pe(a.pts, N, tile * kWgTile, s,
                        sm + M::pe + pt.at * 2 * M::kPeBytes, t);
            hp::fence_proxy_async();
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(pe_full + 8 * pt.at);
            pt.next();
            if (s == s0 + min(1, n - 1) && done_tile >= 0)
              output(done_tile, done_s0);
          }
          done_tile = tile;
          done_s0 = s0;
        }
      }
      if (done_tile >= 0) output(done_tile, done_s0);
    }
  } else {
    // ------------------------------------------------------ consumers --
    hp::setmaxnreg_inc<216>();
    const int wt = tid & 127, warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = 16 * warp + g;   // this thread's rows: row0, row0 + 8

    float* biasf = reinterpret_cast<float*>(sm + M::bias);
    uint32_t* vfrag = reinterpret_cast<uint32_t*>(sm + M::vfrag) + wg * 4096 + wt;
    const uint64_t alpha_desc = hp::desc_k128(sm32 + M::heads);
    const uint64_t rgb_desc =
        hp::desc_k128(sm32 + M::heads + WgBlob::kAlphaBytes);
    const float* bias_q = biasf + 2 * q;   // this thread's first column pair

    // the biases, once for the block's life, as f32
    {
      const __nv_bfloat16* bsrc =
          reinterpret_cast<const __nv_bfloat16*>(blob + B::biases);
      for (int i = tid; i < B::kBiases; i += 256)
        biasf[i] = __bfloat162float(bsrc[i]);
    }
    hp::mbar_wait(head_bar, 0);
    hp::named_barrier(3, 256);
    if (wg == 1) wg_turn_pass();

    WgRing ring = {{full, n_stages, 0, 0}, empty, ring_buf};
    WgTurns pt = {pe_full, 2, 0, 0}, rt = {res_empty, n_res, 0, 0};
    float acc[64];
    uint32_t h[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * kWgTile + wg * kWgRays;
      const int live = min(kWgRays, max(N - base, 0));

      if constexpr (Net::kDoNeRF) {
        // the direction term of this thread's rows and head columns (2 q,
        // 2 q + 1 of the 4; q < 2), f32, in the order of the head's
        // accumulators
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int r = row0 + 8 * (p >> 1), c = 2 * q + (p & 1);
          const float d = q < 2 && r < live
                              ? a.vcon[(size_t)c * N + base + r] : 0.0f;
          vfrag[p * 128] = __float_as_uint(d);
        }
      } else {
        // vcon of this thread's rows and columns in the view layer,
        // rounded, in the order of that layer's accumulator pairs
#pragma unroll 4
        for (int p = 0; p < 32; ++p) {
          const int r = row0 + 8 * (p & 1), c = 8 * (p >> 1) + 2 * q;
          const bool ok = r < live;
          const float v0 = ok ? a.vcon[(size_t)c * N + base + r] : 0.0f;
          const float v1 =
              ok ? a.vcon[(size_t)(c + 1) * N + base + r] : 0.0f;
          vfrag[p * 128] = hp::pack_bf16x2(v0, v1);
        }
      }
      // the results buffer of the tile's first chunk, once its last chunk
      // has left it
      hp::mbar_wait(rt.bar(), rt.phase ^ 1);
      // A point where the compiler sees the whole warpgroup together: without
      // one in the loop it issues every product serialized (ptxas C7520).
      hp::named_barrier(1 + wg, 128);
      auto res_of = [&](uint32_t at) {
        return reinterpret_cast<__nv_bfloat16*>(sm + M::res +
                                                at * M::kResBytes) +
               (size_t)wg * kWgRays * kResChunk * 4;
      };
      __nv_bfloat16* res = res_of(rt.at);

      for (int s = 0; s < S; ++s) {
        if (s > 0 && s % kResChunk == 0) {
          // a chunk of results is written: over to the output warps, and on
          // to the other buffer once it is free (no live state beyond s and
          // rt: the consumers' registers are at ptxas' limit)
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(res_full + 8 * rt.at);
          rt.next();
          hp::mbar_wait(rt.bar(), rt.phase ^ 1);
          res = res_of(rt.at);
        }
        hp::mbar_wait(pt.bar(), pt.phase);
        const uint64_t pe_desc = hp::desc_k128(
            sm32 + M::pe + (pt.at * 2 + wg) * M::kPeBytes);

        // layer 0: PE rows from shared memory; one stage holds both halves
        {
          const uint32_t stage = ring.wait();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            wg_dense128_ss(acc, pe_desc, 0, stage + hf * kSlab128Bytes, 4);
            wg_epilogue<Act::kRelu>(acc, h + 32 * hf, bias_q + hf * kWH);
          }
          ring.release(ring.advance());
        }
        if constexpr (Net::kDoNeRF) {
          // the sample's PE rows are read: layer 0 is their one reader
          if (lane == 0) hp::mbar_arrive(pe_empty + 8 * pt.at);
          pt.next();
          // layers 1..6
#pragma unroll 1
          for (int l = 1; l <= 6; ++l)
            wg_layer256<Act::kRelu>(acc, h, ring, bias_q + l * kW);
          // the head (columns 0..3 of 8, resident) on the last hidden
          // layer: its f32 sums plus the direction term, rounded; then the
          // bias, rounded
          float o[4] = {};
          wg_turn_wait();
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 16; ++kk) {
            const int j = 4 * kk;
            hp::wgmma_m64n8k16_rs(
                o, h[j], h[j + 1], h[j + 2], h[j + 3],
                alpha_desc + (kk / 4) * (1024 >> 4) + (kk % 4) * hp::kDescKStep,
                kk);
          }
          hp::wgmma_commit();
          wg_turn_pass();
          hp::wgmma_wait<0>();
          hp::keep(o);
          hp::keep(h);
          if (q < 2) {   // q = 0: rgb columns 0, 1; q = 1: rgb 2 and sigma
            __nv_bfloat16* rs = res + (s % kResChunk) * 4;
            const float b0 = biasf[B::b_out + 2 * q],
                        b1 = biasf[B::b_out + 2 * q + 1];
            auto head = [](float d, uint32_t dir, float b) {
              const float dd = d + __uint_as_float(dir);
              return __float2bfloat16_rn(
                  __bfloat162float(__float2bfloat16_rn(dd)) + b);
            };
            __nv_bfloat16* r0 = rs + (size_t)row0 * kResChunk * 4 + 2 * q;
            __nv_bfloat16* r8 = r0 + (size_t)8 * kResChunk * 4;
            r0[0] = head(o[0], vfrag[0], b0);
            r0[1] = head(o[1], vfrag[128], b1);
            r8[0] = head(o[2], vfrag[256], b0);
            r8[1] = head(o[3], vfrag[384], b1);
          }
        } else {
          // layers 1..4
#pragma unroll 1
          for (int l = 1; l <= 4; ++l)
            wg_layer256<Act::kRelu>(acc, h, ring, bias_q + l * kW);
          // layer 5, per half: the PE product, rounded and packed; then the h
          // product; added, biased, clamped
          {
            uint32_t lo[32];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              uint32_t pdot[32];
              wg_dense128_ss(acc, pe_desc, 0, ring.wait(), 4);
              ring.release(ring.advance());
#pragma unroll
              for (int p = 0; p < 32; ++p)
                pdot[p] = hp::pack_bf16x2(acc[2 * p], acc[2 * p + 1]);
              wg_dense128(acc, h, ring);
              uint32_t* out = hf ? h + 32 : lo;
#pragma unroll
              for (int p = 0; p < 32; ++p) {
                const float2 b = *reinterpret_cast<const float2*>(
                    bias_q + 5 * kW + hf * kWH + 8 * (p / 2));
                const uint32_t both = wg_add_packed(
                    pdot[p], hp::pack_bf16x2(acc[2 * p], acc[2 * p + 1]));
                out[p] = wg_add_pair<Act::kRelu>(both, b);
              }
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) h[i] = lo[i];
          }
          // this warp's last read of the sample's PE rows is behind it
          if (lane == 0) hp::mbar_arrive(pe_empty + 8 * pt.at);
          pt.next();
          // layers 6, 7
#pragma unroll 1
          for (int l = 6; l <= 7; ++l)
            wg_layer256<Act::kRelu>(acc, h, ring, bias_q + l * kW);

          __nv_bfloat16* rs = res + (s % kResChunk) * 4;   // [ray][chunk][4]
          // sigma head (column 0 of 8, resident) and the feature layer, on h7
          {
            float sig[4] = {};
            wg_turn_wait();
            hp::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 16; ++kk) {
              const int j = 4 * kk;
              hp::wgmma_m64n8k16_rs(
                  sig, h[j], h[j + 1], h[j + 2], h[j + 3],
                  alpha_desc + (kk / 4) * (1024 >> 4) + (kk % 4) * hp::kDescKStep,
                  kk);
            }
            hp::wgmma_commit();
            wg_turn_pass();
            hp::wgmma_wait<0>();
            hp::keep(sig);
            if (q == 0) {
              const float ba = biasf[B::b_alpha];
              rs[(size_t)row0 * kResChunk * 4 + 3] = __float2bfloat16_rn(
                  __bfloat162float(__float2bfloat16_rn(sig[0])) + ba);
              rs[(size_t)(row0 + 8) * kResChunk * 4 + 3] = __float2bfloat16_rn(
                  __bfloat162float(__float2bfloat16_rn(sig[2])) + ba);
            }
            wg_layer256<Act::kNone>(acc, h, ring, bias_q + B::b_feat);
          }
          // view branch: relu(round(round(dot + vcon) + bv)), 128 wide
          {
            wg_dense128(acc, h, ring);
#pragma unroll
            for (int p = 0; p < 32; ++p) {
              const float2 b = *reinterpret_cast<const float2*>(
                  bias_q + B::bv + 8 * (p / 2));
              const uint32_t withv = wg_add_packed(
                  hp::pack_bf16x2(acc[2 * p], acc[2 * p + 1]), vfrag[p * 128]);
              h[p] = wg_add_pair<Act::kRelu>(withv, b);
            }
          }
          // rgb head (columns 0..2 of 8, resident) on the 128 view features
          {
            float rgb[4] = {};
            wg_turn_wait();
            hp::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const int j = 4 * kk;
              hp::wgmma_m64n8k16_rs(
                  rgb, h[j], h[j + 1], h[j + 2], h[j + 3],
                  rgb_desc + (kk / 4) * (1024 >> 4) + (kk % 4) * hp::kDescKStep,
                  kk);
            }
            hp::wgmma_commit();
            wg_turn_pass();
            hp::wgmma_wait<0>();
            hp::keep(rgb);
            hp::keep(h);
            if (q < 2) {   // q = 0: columns 0, 1; q = 1: column 2
              const float b0 = biasf[B::b_rgb + 2 * q];
              auto head = [](float d, float b) {
                return __float2bfloat16_rn(
                    __bfloat162float(__float2bfloat16_rn(d)) + b);
              };
              rs[(size_t)row0 * kResChunk * 4 + 2 * q] = head(rgb[0], b0);
              rs[(size_t)(row0 + 8) * kResChunk * 4 + 2 * q] = head(rgb[2], b0);
              if (q == 0) {
                const float b1 = biasf[B::b_rgb + 1];
                rs[(size_t)row0 * kResChunk * 4 + 1] = head(rgb[1], b1);
                rs[(size_t)(row0 + 8) * kResChunk * 4 + 1] = head(rgb[3], b1);
              }
            }
          }
        }
      }

      // this warp's results of the tile's last chunk are written: over to
      // the output warps
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(res_full + 8 * rt.at);
      rt.next();
    }
  }
}

template <bool COMPOSITE>
__global__ void __launch_bounds__(kWgThreads, 1)
    nerf_wg_kernel(const __grid_constant__ NerfArgs a) {
  wg_kernel_body<NerfNet, COMPOSITE>(a);
}

template <bool COMPOSITE>
__global__ void __launch_bounds__(kWgThreads, 1)
    donerf_wg_kernel(const __grid_constant__ NerfArgs a) {
  wg_kernel_body<DoNeRFNet, COMPOSITE>(a);
}

template <class P, bool COMPOSITE>
int run_nerf(const NerfArgs& a, cudaStream_t stream) {
  const int blocks = (a.N + P::TILE - 1) / P::TILE;
  return launch(nerf_kernel<P, COMPOSITE>, blocks, P::THREADS,
                nerf_smem<P>(), stream, a);
}

// One persistent block per SM, at most one per tile.
template <class Net, bool COMPOSITE>
int run_nerf_wg(const NerfArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.N + kWgTile - 1) / kWgTile;
  const int blocks = sms < tiles ? sms : tiles;
  if constexpr (Net::kDoNeRF)
    return launch(donerf_wg_kernel<COMPOSITE>, blocks, kWgThreads,
                  WgSmem::bytes, stream, a);
  else
    return launch(nerf_wg_kernel<COMPOSITE>, blocks, kWgThreads,
                  WgSmem::bytes, stream, a);
}

// Any S: no buffer depends on it. Indices into [S*3, N], [S, N] and
// [N, S, 4] are taken in size_t; the one int product, live * n, is at most
// 128 * kResChunk.
inline bool nerf_args_ok(int N, int S, long long blob_elems, int pack_bf16) {
  if (N <= 0 || S <= 0) return false;
  if (!pack_bf16) return blob_elems == NerfBlob::total;
  return blob_elems == WgBlob::kBlobElems;
}

// The arguments of a raw launch and of a composite one, for the NeRF and
// the DoNeRF entries alike: ``con_t`` is the view term, [C, N].
inline NerfArgs raw_args(const float* pts24_t, const float* con_t,
                         const void* blob, float* raw, int N, int S) {
  NerfArgs a = {};
  a.pts = pts24_t;
  a.vcon = con_t;
  a.blob = blob;
  a.N = N;
  a.S = S;
  a.raw = raw;
  return a;
}

inline NerfArgs composite_args(
    const float* pts24_t, const float* con_t, const float* z_t,
    const float* mm_add_t, const float* mm_mul_t, const float* dnorm,
    const void* blob, float* rgb, float* depth, float* disp, float* acc,
    float* weights, float* sigma, int N, int S, int white_bkgd) {
  NerfArgs a = raw_args(pts24_t, con_t, blob, nullptr, N, S);
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
  return a;
}

}  // namespace pn

// Both return the CUDA error of the launch (0 = launched), or -1 for
// arguments the kernel does not take.
extern "C" int pn_fused_nerf_raw(const float* pts24_t, const float* vcon_t,
                                 const void* blob, long long blob_elems,
                                 float* raw, int N, int S, int pack_bf16,
                                 void* stream) {
  if (!pn::nerf_args_ok(N, S, blob_elems, pack_bf16)) return -1;
  const pn::NerfArgs a = pn::raw_args(pts24_t, vcon_t, blob, raw, N, S);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return pack_bf16 ? pn::run_nerf_wg<pn::NerfNet, false>(a, s)
                   : pn::run_nerf<pn::PF32, false>(a, s);
}

extern "C" int pn_fused_nerf_composite(
    const float* pts24_t, const float* vcon_t, const float* z_t,
    const float* mm_add_t, const float* mm_mul_t, const float* dnorm,
    const void* blob, long long blob_elems, float* rgb, float* depth,
    float* disp, float* acc, float* weights, float* sigma, int N, int S,
    int white_bkgd, int pack_bf16, void* stream) {
  if (!pn::nerf_args_ok(N, S, blob_elems, pack_bf16)) return -1;
  const pn::NerfArgs a = pn::composite_args(
      pts24_t, vcon_t, z_t, mm_add_t, mm_mul_t, dnorm, blob, rgb, depth, disp,
      acc, weights, sigma, N, S, white_bkgd);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return pack_bf16 ? pn::run_nerf_wg<pn::NerfNet, true>(a, s)
                   : pn::run_nerf<pn::PF32, true>(a, s);
}

// The DoNeRF kernel (bf16 only): dcon_t is the head's direction term
// [4, N]; the other arguments as above.
extern "C" int pn_fused_donerf_raw(const float* pts24_t, const float* dcon_t,
                                   const void* blob, long long blob_elems,
                                   float* raw, int N, int S, void* stream) {
  if (N <= 0 || S <= 0 || blob_elems != pn::DoWgBlob::kBlobElems) return -1;
  return pn::run_nerf_wg<pn::DoNeRFNet, false>(
      pn::raw_args(pts24_t, dcon_t, blob, raw, N, S),
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int pn_fused_donerf_composite(
    const float* pts24_t, const float* dcon_t, const float* z_t,
    const float* mm_add_t, const float* mm_mul_t, const float* dnorm,
    const void* blob, long long blob_elems, float* rgb, float* depth,
    float* disp, float* acc, float* weights, float* sigma, int N, int S,
    int white_bkgd, void* stream) {
  if (N <= 0 || S <= 0 || blob_elems != pn::DoWgBlob::kBlobElems) return -1;
  const pn::NerfArgs a = pn::composite_args(
      pts24_t, dcon_t, z_t, mm_add_t, mm_mul_t, dnorm, blob, rgb, depth, disp,
      acc, weights, sigma, N, S, white_bkgd);
  return pn::run_nerf_wg<pn::DoNeRFNet, true>(
      a, reinterpret_cast<cudaStream_t>(stream));
}
