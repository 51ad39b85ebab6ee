// The NeRF kernel's inputs for the served frame, in one pass: from the
// refine MinMax kernel's output, the sorted sampler depths and the rays to
// the query points, the view term and the composite's per-sample rows.
//
// No TPU kernel is replaced: the JAX package writes this step in XLA
// (pronerf_tpu/models/pronerf.py, steps 4 to 6). The PyTorch chain this
// kernel replaces (kernels/query_prep.py:query_inputs_chain) is about 35
// launches over [N, S] and [N, 3] tensors: the refine epilogue (two
// sigmoids, bin_constrain's midpoints, concatenations and lerp), the query
// points with their tanh offsets, the view direction's encoding, its product
// with the view weight (an f32 GEMM), the [S, N] transposes, the direction
// norm and the mean depth.
//
// Bound on this card: bytes. A ray reads its refine row (4 S + 3 floats),
// three [S] rows and three [3] vectors, and writes 3 S query points, R view
// rows (R = 128 for the NeRF MLP, 4 for DoNeRF's head), three [S] columns,
// rgb0, the norm and depth0.
//
// One thread a ray; a block of B threads strides over the rays (a few
// blocks an SM, so that each loads the view weight, rounded to bf16, into
// shared memory once):
//  * each thread copies its ray's refine row and three [S] rows into its own
//    rows of shared memory (odd strides: no bank is hit twice), float4 loads
//    where the rows allow them, eight in flight at a time, with no barrier;
//    a block-wide staged copy behind a barrier took 0.61 ms against 0.39 at
//    762,048 rays, 8 samples, 128 view rows (H100 SXM, 700 W);
//  * each thread writes its ray's column of every [rows, N] output: a warp's
//    32 rays are 128 contiguous bytes of each row;
//  * the view term sums four rows at once, four independent FMA chains.
//
// Same numbers as the chain on this card, bit for bit, except three sums:
// each f32 op is one rounding (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, nothing contracted into an FMA) in PyTorch's op order, with the
// accurate expf, tanhf, sinf and cosf its kernels call:
//  * sigmoid(x) = 1 / (1 + expf(-x)), for rgb0 and the refine sigmoids;
//  * bin_constrain: mid_s = 0.5 (d_{s+1} + d_s), the first bin's lower edge
//    0.5 (near + d_0), the last one's upper 0.5 (far + d_{S-1}), then
//    z = lower + (upper - lower) * sigmoid;
//  * the point o_c + d_c z_s, plus offset_scale * tanhf(offset) (with
//    add_offsets);
//  * the view encoding [v, sinf(2^l v), cosf(2^l v)] for l < 4 (2^l v is
//    exact), each value and each weight rounded to bf16;
//  * the transposed rows copy every bit.
// The three sums, as PyTorch's reductions form them where that was probed
// on this card (a tolerance each, tests/test_torch_query_prep_card.py):
//  * the view term, sum_k w_k v_k over the 27 encodings in k order: the
//    products of bf16 values are exact in f32, so only the order of the
//    sum can differ from cuBLAS';
//  * the norm of d as (d0^2 + d2^2) + d1^2 (two lanes of a short innermost
//    axis), rounded square root;
//  * depth0, the mean of z: four lanes (lane i sums z_i, z_{i+4}, ...),
//    (l0 + l2) + (l1 + l3), times the f32 reciprocal of S (PyTorch's mean on
//    the card is a sum divided by S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {

constexpr int kPrepMaxSamples = 32;
constexpr int kPrepMaxViewRows = 128;
constexpr int kPrepViewCols = 27;  // the view encoding at 4 octaves
constexpr int kPrepWStride = 28;   // a weight row in shared memory, padded

struct PrepArgs {
  const float* refine;  // [N, ld] refine output: S logits, 3 S offsets, rgb
  const float* depth;   // [N, S] sorted sampler depths
  const float* add;     // [N, S] density offsets in the depths' order
  const float* mul;     // [N, S] density scales in the depths' order
  const float* ndc_o;   // [N, 3]
  const float* ndc_d;   // [N, 3]
  const float* dirs;    // [N, 3] unit view directions
  const float* view_w;  // [R, ld_w] view weight, its first 27 columns read
  float* rgb0;          // [N, 3]
  float* pts;           // [3 S, N] query points, row 3 s + c
  float* vcon;          // [R, N] view term
  float* z_t;           // [S, N] bin-constrained depths
  float* add_t;         // [S, N]
  float* mul_t;         // [S, N]
  float* dnorm;         // [N] |d|
  float* depth0;        // [N] mean of z
  long long N, ld, ld_w;
  int S, R, add_offsets;
  int vec;    // the [N, S] inputs load as float4: S % 4 == 0, bases aligned
  int vec_refine;  // refine rows load as float4: ld % 4 == 0, ld > 4 S + 3,
                   // base aligned
  float near, far, offset_scale;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.sigmoid's one / (one + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Copy a ray's row of ``width`` floats from global memory into its row of
// shared memory, eight loads in flight at a time: float4 loads where the
// row is 16-byte aligned and may be read up to ``width`` rounded up to 4.
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int width, bool vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int nq = (width + 3) >> 2;
    for (int q0 = 0; q0 < nq; q0 += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (q0 + i < nq) v[i] = __ldg(s4 + q0 + i);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 4 * (q0 + i);
        if (c < width) dst[c] = v[i].x;
        if (c + 1 < width) dst[c + 1] = v[i].y;
        if (c + 2 < width) dst[c + 2] = v[i].z;
        if (c + 3 < width) dst[c + 3] = v[i].w;
      }
    }
  } else {
    for (int c0 = 0; c0 < width; c0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + i < width) v[i] = __ldg(src + c0 + i);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + i < width) dst[c0 + i] = v[i];
    }
  }
}

// acc + w . x over four (or, without ``last``, three) terms in order; a
// product of two bf16 values is exact, so fmaf rounds once, as the sum does
__device__ __forceinline__ float dot4(float4 w, const float* x, float acc,
                                      bool last) {
  acc = fmaf(w.x, x[0], acc);
  acc = fmaf(w.y, x[1], acc);
  acc = fmaf(w.z, x[2], acc);
  return last ? fmaf(w.w, x[3], acc) : acc;
}

template <int B>
__global__ void __launch_bounds__(B) query_prep_kernel(PrepArgs a) {
  extern __shared__ float4 smem[];
  const int S = a.S, width = 4 * S + 3;
  const int rs = width | 1, ss = S | 1;  // odd row strides
  float* w_s = reinterpret_cast<float*>(smem);     // [R][kPrepWStride]
  float* rows = w_s + a.R * kPrepWStride;          // [B][rs]
  float* dep = rows + B * rs;                      // [B][ss] each
  float* add = dep + B * ss;
  float* mul = add + B * ss;
  for (int e = threadIdx.x; e < a.R * kPrepWStride; e += B) {
    const int r = e / kPrepWStride, k = e - r * kPrepWStride;
    w_s[e] = k < kPrepViewCols ? bf16r(__ldg(a.view_w + r * a.ld_w + k))
                               : 0.0f;
  }
  __syncthreads();  // the weights are in
  const long long N = a.N;
  // a thread's rows in shared memory: refine, depth, mm_add, mm_mul
  float* row = rows + threadIdx.x * rs;
  float* d_row = dep + threadIdx.x * ss;
  float* add_row = add + threadIdx.x * ss;
  float* mul_row = mul + threadIdx.x * ss;
  for (long long n = (long long)blockIdx.x * B + threadIdx.x; n < N;
       n += (long long)gridDim.x * B) {
    load_row(row, a.refine + n * a.ld, width, a.vec_refine);
    load_row(d_row, a.depth + n * S, S, a.vec);
    load_row(add_row, a.add + n * S, S, a.vec);
    load_row(mul_row, a.mul + n * S, S, a.vec);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.rgb0[n * 3 + c] = sigmoid(row[4 * S + c]);
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = __ldg(a.ndc_o + n * 3 + c);
      d[c] = __ldg(a.ndc_d + n * 3 + c);
    }
    a.dnorm[n] = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[2], d[2])),
        __fmul_rn(d[1], d[1])));
    float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float lower = __fmul_rn(0.5f, __fadd_rn(d_row[0], a.near));
    for (int s0 = 0; s0 < S; s0 += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // lane j takes samples j, j + 4, ...
        const int s = s0 + j;
        if (s >= S) break;
        const float upper =
            s + 1 < S ? __fmul_rn(0.5f, __fadd_rn(d_row[s + 1], d_row[s]))
                      : __fmul_rn(0.5f, __fadd_rn(d_row[s], a.far));
        const float z = __fadd_rn(
            lower, __fmul_rn(__fsub_rn(upper, lower), sigmoid(row[s])));
        lower = upper;
        a.z_t[s * N + n] = z;
        a.add_t[s * N + n] = add_row[s];
        a.mul_t[s * N + n] = mul_row[s];
        lane[j] = __fadd_rn(lane[j], z);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float p = __fadd_rn(o[c], __fmul_rn(d[c], z));
          if (a.add_offsets)
            p = __fadd_rn(p, __fmul_rn(a.offset_scale,
                                       tanhf(row[S + 3 * s + c])));
          a.pts[(3 * s + c) * N + n] = p;
        }
      }
    }
    a.depth0[n] = __fmul_rn(
        __fadd_rn(__fadd_rn(lane[0], lane[2]), __fadd_rn(lane[1], lane[3])),
        __fdiv_rn(1.0f, (float)S));
    // the view encoding, rounded to bf16, and its product with each row
    float pe[kPrepWStride];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __ldg(a.dirs + n * 3 + c);
      pe[c] = bf16r(v);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float x = __fmul_rn(v, (float)(1 << l));
        pe[3 + 6 * l + c] = bf16r(sinf(x));
        pe[6 + 6 * l + c] = bf16r(cosf(x));
      }
    }
    pe[kPrepViewCols] = 0.0f;
    // four rows at once, each summed in k order: four independent chains
    int r = 0;
    for (; r + 4 <= a.R; r += 4) {
      const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                         r * (kPrepWStride / 4);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kPrepWStride / 4; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = dot4(w4[i * (kPrepWStride / 4) + q], pe + 4 * q, acc[i],
                        4 * q + 3 < kPrepViewCols);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) a.vcon[(r + i) * N + n] = acc[i];
    }
    for (; r < a.R; ++r) {
      const float4* w4 = reinterpret_cast<const float4*>(w_s) +
                         r * (kPrepWStride / 4);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kPrepWStride / 4; ++q)
        acc = dot4(w4[q], pe + 4 * q, acc, 4 * q + 3 < kPrepViewCols);
      a.vcon[r * N + n] = acc;
    }
  }
}

template <int B>
size_t smem_bytes(int S, int R) {
  return ((size_t)R * kPrepWStride + (size_t)B * ((4 * S + 3) | 1) +
          3 * (size_t)B * (S | 1)) * sizeof(float);
}

template <int B>
int launch(const PrepArgs& a, cudaStream_t s) {
  constexpr int kDevices = 64;
  static int sms[kDevices], raised[kDevices];  // by device, set once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kDevices) return -1;
  const size_t smem = smem_bytes<B>(a.S, a.R);
  if (!raised[dev]) {  // room for the largest S and R
    e = cudaFuncSetAttribute(
        query_prep_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<B>(kPrepMaxSamples, kPrepMaxViewRows));
    if (e != cudaSuccess) return (int)e;
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    raised[dev] = 1;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, query_prep_kernel<B>, B, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (a.N + B - 1) / B;
  const long long blocks = min(tiles, (long long)max(per_sm, 1) * sms[dev]);
  query_prep_kernel<B><<<(unsigned)blocks, B, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace pn

// Returns 0, -1 for arguments the kernel does not take (1 <= S <= 32,
// ld >= 4 S + 3, 1 <= R <= 128, ld_w >= 27, N >= 0), or the CUDA error of
// the launch.
extern "C" int pn_query_prep(
    const float* refine, long long ld, const float* depth, const float* add,
    const float* mul, const float* ndc_o, const float* ndc_d,
    const float* dirs, const float* view_w, long long ld_w, int R,
    long long N, int S, float near, float far, float offset_scale,
    int add_offsets, float* rgb0, float* pts, float* vcon, float* z_t,
    float* add_t, float* mul_t, float* dnorm, float* depth0, void* stream) {
  if (N < 0 || S < 1 || S > pn::kPrepMaxSamples || ld < 4LL * S + 3 ||
      R < 1 || R > pn::kPrepMaxViewRows || ld_w < pn::kPrepViewCols)
    return -1;
  if (N == 0) return 0;
  pn::PrepArgs a = {};
  a.refine = refine;
  a.depth = depth;
  a.add = add;
  a.mul = mul;
  a.ndc_o = ndc_o;
  a.ndc_d = ndc_d;
  a.dirs = dirs;
  a.view_w = view_w;
  a.rgb0 = rgb0;
  a.pts = pts;
  a.vcon = vcon;
  a.z_t = z_t;
  a.add_t = add_t;
  a.mul_t = mul_t;
  a.dnorm = dnorm;
  a.depth0 = depth0;
  a.N = N;
  a.ld = ld;
  a.ld_w = ld_w;
  a.S = S;
  a.R = R;
  a.add_offsets = add_offsets;
  a.near = near;
  a.far = far;
  a.offset_scale = offset_scale;
  auto fits = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  a.vec = S % 4 == 0 && fits(depth) && fits(add) && fits(mul);
  a.vec_refine = ld % 4 == 0 && ld >= 4LL * S + 4 && fits(refine);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 16) return pn::launch<128>(a, s);
  return pn::launch<64>(a, s);
}
