// INT8 fused positional encoding -> NeRF MLP for Hopper (serving, quant =
// int8).
//
// Replaces the TPU kernel pronerf_tpu/kernels/fused_nerf_q.py:
// fused_nerf_raw_tq (body _kernel, chain _forward_q): the bf16 kernel's chain
// with eleven int8 x int8 -> int32 products, a per-channel `acc * A + B` and a
// requantisation to uint8-in-int8 codes between them. The two consumers of
// the positional encoding (K = 63) stay bf16 products with f32 sums. Raw
// [N, S, 4] f32 goes out.
//
// Bound on this card: operations. A point costs 557,696 int8 multiply-adds
// and 32,256 bf16 ones against 12 input and 16 output bytes; the panels are
// about 0.65 MB and stay in L2. As in fused_nerf.cu a block owns a tile of 64
// rays, loops over the ray's S samples itself (the TPU kernel's (ray-block,
// sample) grid is a choice for that machine), keeps every activation of the
// chain in shared memory, as int8 codes, and stores the tile's S results as
// one contiguous chunk.
//
// What the design does about the bound. fused_nerf.cu is limited by how each
// warp fetches its operand fragments, not by the tensor cores; int8 halves
// those bytes and `mma.m16n8k32` does twice the multiply-adds an instruction,
// so per multiply-add this kernel executes half the loads and half the
// `mma`s of the bf16 one (common.cuh: 16-byte loads of the panel rows against
// codes stored with a permuted k order). The operand buffers are half as
// large, so two blocks per SM fit with room to spare. The epilogue is where
// int8 costs more: a multiply, two adds, a floor, two clamps and a conversion
// per element instead of one rounding and one add.
//
// Rounding points (they are part of the function; the plain PyTorch version
// has the same): the product `acc * A` is rounded to f32 before B is added,
// so the epilogue is written with __fmul_rn / __fadd_rn, which the compiler
// never contracts into a fused multiply-add. A fused one would move t by up
// to half a unit in the last place and flip the codes that sit on a .5
// boundary. Layer 5 is (acc * A5 + pe_dot) + B5 and the view layer
// (acc * Av + vcon * vcon_scale) + Bv, in that order. Codes are
// clamp(floor(t + .5), 0, 254) - 127: the value 0 is code -127, and -128
// never occurs.
//
// The frequency panel bx_t is 2^k by construction, so `bx_t . x` is exactly
// ldexp(x, k); the wrapper checks the panel before it drops it from the blob.
//
// Weight blob, bytes, every section on a multiple of 16:
//   bf16  w0p 256x64 | w5p 256x64
//   int8  w1..w7 256x256 | wf 256x256 | wv 128x256 | wa 8x256 | wr 8x128
//   f32   A0 B0 A1 B1 .. A7 B7 (256 each) | Af Bf (256) |
//         Av Bv vcon_scale (128) | Aa Ba Ar Br (8)
//
// Shared memory: 87,040 bytes a block at S = 8 (two code buffers of 17 KB,
// the bf16 PE rows, the f32 view contribution, the staged results), so two
// blocks fit an SM with room to spare. __launch_bounds__(256, 2) caps the
// kernel at 128 registers; nvcc of CUDA 12.8 (-Xptxas -v, sm_90a) takes all
// 128, with a 48-byte stack frame of which 16 bytes are spills.

#include "common.cuh"

namespace pn {

constexpr int kQWH = 128;  // view branch width
constexpr int kQL = 10;    // position octaves
constexpr int kQPE = 64;   // 3 + 2 * 3 * kQL = 63, padded

struct NerfQBlob {  // byte offsets
  static constexpr long long sq = (long long)kW * kW;
  static constexpr long long w0p = 0, w5p = w0p + 2 * kW * kQPE;
  static constexpr long long wq = w5p + 2 * kW * kQPE;  // w_i at wq + (i-1)*sq
  static constexpr long long wf = wq + 7 * sq, wv = wf + sq;
  static constexpr long long wa = wv + kQWH * kW, wr = wa + 8 * kW;
  static constexpr long long cols = wr + 8 * kQWH;      // the f32 columns
  // float offsets inside the f32 section
  static constexpr int AB = 0;                 // A_i at 2*i*kW, B_i after it
  static constexpr int Af = 16 * kW, Bf = Af + kW;
  static constexpr int Av = Bf + kW, Bv = Av + kQWH, vscale = Bv + kQWH;
  static constexpr int Aa = vscale + kQWH, Ba = Aa + 8, Ar = Ba + 8,
                       Br = Ar + 8;
  static constexpr int n_cols = Br + 8;
  static constexpr long long total = cols + 4LL * n_cols;
};

constexpr int kLD8 = kW + kPadS8;              // bytes, int8 operand buffers
constexpr int kLDPE = kQPE + PBf16::PAD;       // bf16 elements
constexpr int kLDVC = kQWH + 8;                // floats

constexpr size_t nerf_q_smem(int S) {
  return (size_t)2 * PBf16::TILE * kLD8 +
         sizeof(__nv_bfloat16) * PBf16::TILE * kLDPE +
         sizeof(float) * PBf16::TILE * kLDVC +
         sizeof(float) * PBf16::TILE * S * 4;
}

// f32 in output-quant units -> int8 code
__device__ __forceinline__ int8_t requant(float t) {
  const float q = fminf(fmaxf(floorf(__fadd_rn(t, 0.5f)), 0.0f), 254.0f);
  return (int8_t)(__float2int_rn(q) - 127);
}

// acc * A + B with the product rounded first (never a fused multiply-add)
__device__ __forceinline__ float scale_shift(float acc, float A, float B) {
  return __fadd_rn(__fmul_rn(acc, A), B);
}

// (acc * A + mid) + B
__device__ __forceinline__ float scale_add_shift(float acc, float A, float mid,
                                                 float B) {
  return __fadd_rn(__fadd_rn(__fmul_rn(acc, A), mid), B);
}

// a lane's (out, out + 1) pair stays adjacent under col_s8: one 2-byte store
__device__ __forceinline__ void store_codes(int8_t* dst, int r, int n,
                                            int8_t c0, int8_t c1) {
  char2 v;
  v.x = c0;
  v.y = c1;
  *reinterpret_cast<char2*>(dst + r * kLD8 + col_s8(n)) = v;
}

__global__ void __launch_bounds__(PBf16::THREADS, PBf16::MIN_BLOCKS)
nerf_q_kernel(const float* __restrict__ pts, const float* __restrict__ vcon,
              const unsigned char* __restrict__ blob, float* __restrict__ raw,
              int N, int S) {
  using P = PBf16;
  using B = NerfQBlob;
  constexpr int TILE = P::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* bufA = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* bufB = bufA + TILE * kLD8;
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(bufB + TILE * kLD8);
  float* vc = reinterpret_cast<float*>(pe + TILE * kLDPE);
  float* res = vc + TILE * kLDVC;  // [TILE][S][4]

  const __nv_bfloat16* w0p =
      reinterpret_cast<const __nv_bfloat16*>(blob + B::w0p);
  const __nv_bfloat16* w5p =
      reinterpret_cast<const __nv_bfloat16*>(blob + B::w5p);
  const int8_t* wq = reinterpret_cast<const int8_t*>(blob + B::wq);
  const int8_t* wf = reinterpret_cast<const int8_t*>(blob + B::wf);
  const int8_t* wv = reinterpret_cast<const int8_t*>(blob + B::wv);
  const int8_t* wa = reinterpret_cast<const int8_t*>(blob + B::wa);
  const int8_t* wr = reinterpret_cast<const int8_t*>(blob + B::wr);
  const float* cols = reinterpret_cast<const float*>(blob + B::cols);

  const int base = blockIdx.x * TILE;

  // per-ray view contribution in hv-quant units, once for all samples
  for (int idx = threadIdx.x; idx < TILE * kQWH; idx += P::THREADS) {
    const int r = idx % TILE, n = idx / TILE, ray = base + r;
    vc[r * kLDVC + n] =
        ray < N ? __fmul_rn(vcon[(size_t)n * N + ray], ro(cols + B::vscale + n))
                : 0.0f;
  }

  // a lane's pair of per-channel columns
  auto pair = [&](int at, int n) {
    return __ldg(reinterpret_cast<const float2*>(cols + at + n));
  };

  // out = requant(acc * A + B) of an int8 layer of 256 outputs
  auto hidden = [&](const int8_t* in, const int8_t* wp, int at_a, int at_b,
                    int8_t* out) {
    auto sink = [&](int r, int n, float a0, float a1) {
      const float2 A = pair(at_a, n), Bc = pair(at_b, n);
      store_codes(out, r, n, requant(scale_shift(a0, A.x, Bc.x)),
                  requant(scale_shift(a1, A.y, Bc.y)));
    };
    dense_s8<P>(in, kLD8, kW, wp, kW, sink);
    __syncthreads();
  };
  auto layer = [&](int i, const int8_t* in, int8_t* out) {
    hidden(in, wq + (i - 1) * B::sq, B::AB + 2 * i * kW,
           B::AB + (2 * i + 1) * kW, out);
  };

  for (int s = 0; s < S; ++s) {
    // positional encoding rows [x(3) | sin(30) | cos(30) | 0], bf16
    for (int idx = threadIdx.x; idx < TILE * 3; idx += P::THREADS) {
      const int r = idx % TILE, c = idx / TILE, ray = base + r;
      const __nv_bfloat16 x =
          P::rnd(ray < N ? pts[(size_t)(3 * s + c) * N + ray] : 0.0f);
      __nv_bfloat16* row = pe + r * kLDPE;
      row[P::col(c)] = x;
      const float xf = P::f(x);
#pragma unroll
      for (int k = 0; k < kQL; ++k) {
        float sn, cs;
        sincosf(ldexpf(xf, k), &sn, &cs);
        row[P::col(3 + 3 * k + c)] = P::rnd(sn);
        row[P::col(3 + 3 * kQL + 3 * k + c)] = P::rnd(cs);
      }
      if (c == 0) row[P::col(kQPE - 1)] = P::rnd(0.0f);
    }
    __syncthreads();

    // layer 0: the bf16 PE product, its f32 sum straight into h0 codes
    {
      auto sink = [&](int r, int n, float a0, float a1) {
        const float2 A = pair(B::AB, n), Bc = pair(B::AB + kW, n);
        store_codes(bufA, r, n, requant(scale_shift(a0, A.x, Bc.x)),
                    requant(scale_shift(a1, A.y, Bc.y)));
      };
      dense_bf16<P>(pe, kLDPE, kQPE, w0p, kW, sink);
      __syncthreads();
    }
    layer(1, bufA, bufB);
    layer(2, bufB, bufA);
    layer(3, bufA, bufB);
    layer(4, bufB, bufA);

    // layer 5: (acc * A5 + pe_dot) + B5. Both sums of an output are needed
    // at once, so a warp takes its 32 outputs in two halves of 16 and holds
    // the f32 and the int32 accumulators of a half together.
    {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int g = lane >> 2, t = lane & 3;
      for (int half = 0; half < 2; ++half) {
        const int n0 = warp * 32 + half * 16;
        float facc[4][2][4] = {};
        warp_acc_bf16<4, 2>(pe, kLDPE, kQPE, w5p, 0, n0, facc);
        int iacc[4][2][4] = {};
        warp_acc_s8<4, 2>(bufA, kLD8, kW, wq + 4 * B::sq, 0, n0, iacc);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int r = mi * 16 + g, n = n0 + ni * 8 + 2 * t;
            const float2 A = pair(B::AB + 10 * kW, n),
                         Bc = pair(B::AB + 11 * kW, n);
            store_codes(
                bufB, r, n,
                requant(scale_add_shift(__int2float_rn(iacc[mi][ni][0]), A.x,
                                        facc[mi][ni][0], Bc.x)),
                requant(scale_add_shift(__int2float_rn(iacc[mi][ni][1]), A.y,
                                        facc[mi][ni][1], Bc.y)));
            store_codes(
                bufB, r + 8, n,
                requant(scale_add_shift(__int2float_rn(iacc[mi][ni][2]), A.x,
                                        facc[mi][ni][2], Bc.x)),
                requant(scale_add_shift(__int2float_rn(iacc[mi][ni][3]), A.y,
                                        facc[mi][ni][3], Bc.y)));
          }
      }
      __syncthreads();
    }

    layer(6, bufB, bufA);
    layer(7, bufA, bufB);

    // heads on h = bufB: sigma (row 0 of 8, f32, no requant) and the
    // feature layer
    float* rs = res + s * 4;
    {
      auto sink = [&](int r, int n, float a0, float) {
        if (n == 0)
          rs[r * S * 4 + 3] =
              scale_shift(a0, ro(cols + B::Aa), ro(cols + B::Ba));
      };
      dense_s8<P>(bufB, kLD8, kW, wa, 8, sink);
    }
    hidden(bufB, wf, B::Af, B::Bf, bufA);
    // view branch: requant((acc * Av + vcon') + Bv), 128 wide, into bufB
    {
      auto sink = [&](int r, int n, float a0, float a1) {
        const float2 A = pair(B::Av, n), Bc = pair(B::Bv, n);
        const float2 v = *reinterpret_cast<const float2*>(vc + r * kLDVC + n);
        store_codes(bufB, r, n,
                    requant(scale_add_shift(a0, A.x, v.x, Bc.x)),
                    requant(scale_add_shift(a1, A.y, v.y, Bc.y)));
      };
      dense_s8<P>(bufA, kLD8, kW, wv, kQWH, sink);
      __syncthreads();
    }
    {
      auto sink = [&](int r, int n, float a0, float a1) {
        if (n < 3) {
          const float2 A = pair(B::Ar, n), Bc = pair(B::Br, n);
          rs[r * S * 4 + n] = scale_shift(a0, A.x, Bc.x);
          if (n + 1 < 3) rs[r * S * 4 + n + 1] = scale_shift(a1, A.y, Bc.y);
        }
      };
      dense_s8<P>(bufB, kLD8, kQWH, wr, 8, sink);
    }
    __syncthreads();
  }

  // the tile's [live, S, 4] results are one contiguous chunk of raw
  const int live = min(TILE, N - base);
  float4* dst = reinterpret_cast<float4*>(raw + (size_t)base * S * 4);
  const float4* src = reinterpret_cast<const float4*>(res);
  for (int idx = threadIdx.x; idx < live * S; idx += P::THREADS)
    dst[idx] = src[idx];
}

}  // namespace pn

// Returns the CUDA error of the launch (0 = launched), or -1 for arguments
// the kernel does not take.
extern "C" int pn_fused_nerf_raw_q(const float* pts24_t, const float* vcon_t,
                                   const void* blob, long long blob_bytes,
                                   float* raw, int N, int S, void* stream) {
  if (N <= 0 || S <= 0 || S > 64 || blob_bytes != pn::NerfQBlob::total)
    return -1;
  const int blocks = (N + pn::PBf16::TILE - 1) / pn::PBf16::TILE;
  return pn::launch(pn::nerf_q_kernel, blocks, pn::PBf16::THREADS,
                    pn::nerf_q_smem(S), reinterpret_cast<cudaStream_t>(stream),
                    pts24_t, vcon_t,
                    reinterpret_cast<const unsigned char*>(blob), raw, N, S);
}
