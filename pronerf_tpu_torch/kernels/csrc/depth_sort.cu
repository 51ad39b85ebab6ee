// Sorted sampler depths of the served frame: from the sampler net's raw
// output to the sorted candidate depths, their density corrections and
// their 3D depths, in one pass.
//
// No TPU kernel is replaced: the JAX package sorts with jnp.sort
// (pronerf_tpu/models/pronerf.py, step 2). The PyTorch chain this kernel
// replaces (ops/sampling.py:sort_sampler_depths) is about ten launches:
// sigmoid, mul, add, a stable torch.sort of S keys a ray (a block radix
// sort), two gathers of the payloads, then rsub, sub, reciprocal and mul
// for the 3D depth.
//
// Bound on this card: bytes. A ray reads 3 S floats of its sampler row and
// writes 4 S floats (depth, mm_add, mm_mul, z3d; [N, S] each, contiguous).
//
// One thread a ray, B rays a block:
//  * each thread loads its ray's row (columns 0 .. 3S - 1 of the row-major
//    [N, ld] sampler output; float4 loads where the row allows them, all in
//    flight at once) into its own row of shared memory;
//  * it turns its S logits into depths there, and sorts the S keys
//    (radix_key(depth) << 32 | index) in registers with a bitonic network of
//    P = S rounded up to a power of two (pads sort last); comparing the
//    index on equal keys makes the sort stable, as torch.sort(stable=True)
//    is: equal depths keep their payloads' order;
//  * it takes the S sorted depths, the corrections of the same indices and
//    their 3D depths into registers; the block then stages the four [B, S]
//    results in shared memory (over the rows, once every thread has read its
//    own) and writes each as one contiguous span, float4 by float4 where
//    S % 4 == 0. Writing them from each thread's registers instead, 32-byte
//    rows a thread, took twice the time (0.145 against 0.072 ms at 762,048
//    rays, 8 samples, on an H100 SXM at 700 W).
//
// Same numbers as the chain on this card, bit for bit:
//  * the order is the radix sort's: cub's key transform of the float's bits
//    (sign set: all bits flipped, else the sign bit), -0.0 taken as +0.0, a
//    NaN by its bits (the canonical NaN that a NaN logit gives sorts last);
//    equal keys in index order;
//  * each f32 op is one rounding, in PyTorch's op order, nothing contracted
//    into an FMA: the sigmoid 1 / (1 + expf(-x)); times f32(far - near);
//    plus f32(near); then 1 - z, minus f32(eps), and 1 / that (a division
//    of a Python scalar by a tensor is reciprocal() * 1.0 in PyTorch, and
//    the product by 1 is exact).
//  * the payloads are copied, every bit kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {

constexpr int kSortMaxSamples = 32;

struct SortArgs {
  const float* mm;  // [N, ld] sampler output: depth logits, mm_add, mm_mul
  float* depth;     // [N, S] sorted NDC depths
  float* add;       // [N, S] mm_add in the depths' order
  float* mul;       // [N, S] mm_mul in the depths' order
  float* z3d;       // [N, S] 3D depths of the sorted depths
  long long N, ld;
  int S;
  float range, near, eps;  // f32(far - near), f32(near), f32(ndc_eps)
  int vec_in;   // rows load as float4: ld, 3 S and the base fit 16 bytes
  int vec_out;  // results store as float4: S % 4 == 0, bases fit 16 bytes
};

// cub's radix key of a float for an ascending sort, -0.0 as +0.0
__device__ __forceinline__ uint32_t radix_key(float v) {
  uint32_t b = __float_as_uint(v);
  b = b == 0x80000000u ? 0u : b;
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

// sigmoid(logit) * (far - near) + near, as PyTorch's three kernels round it
__device__ __forceinline__ float ndc_depth(float logit, const SortArgs& a) {
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
  return __fadd_rn(__fmul_rn(s, a.range), a.near);
}

// ops/sampling.py:ndc_to_3d_depth, 1 / (1 - z - eps)
__device__ __forceinline__ float depth_3d(float z, const SortArgs& a) {
  return __fdiv_rn(1.0f, __fsub_rn(__fsub_rn(1.0f, z), a.eps));
}

template <int P, int B>
__global__ void __launch_bounds__(B) depth_sort_kernel(SortArgs a) {
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [B][stride], then [4][B S]
  const int S = a.S, width = 3 * S, stride = width | 1;
  const long long r0 = (long long)blockIdx.x * B;
  const int nb = (int)min((long long)B, a.N - r0);
  const bool live = (int)threadIdx.x < nb;
  float* row = rows + threadIdx.x * stride;
  float res[4][P];  // depth, mm_add, mm_mul, z3d of the sorted samples
  if (live) {
    const float* src = a.mm + (r0 + threadIdx.x) * a.ld;
    if (a.vec_in) {
#pragma unroll
      for (int q = 0; q < 3 * P / 4; ++q)
        if (4 * q < width) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
          row[4 * q] = v.x;
          row[4 * q + 1] = v.y;
          row[4 * q + 2] = v.z;
          row[4 * q + 3] = v.w;
        }
    } else {
      for (int c = 0; c < width; ++c) row[c] = __ldg(src + c);
    }
    unsigned long long key[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      key[i] = ~0ull;  // pads sort after every real key
      if (i < S) {
        const float z = ndc_depth(row[i], a);
        row[i] = z;
        key[i] = ((unsigned long long)radix_key(z) << 32) | (unsigned)i;
      }
    }
#pragma unroll
    for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
      for (int half = size >> 1; half > 0; half >>= 1) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int j = i ^ half;
          if (j > i) {
            const unsigned long long lo = min(key[i], key[j]);
            const unsigned long long hi = max(key[i], key[j]);
            const bool up = (i & size) == 0;
            key[i] = up ? lo : hi;
            key[j] = up ? hi : lo;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < S) {
        const int i = (int)(key[j] & 0xFFu);
        res[0][j] = row[i];
        res[1][j] = row[S + i];
        res[2][j] = row[2 * S + i];
        res[3][j] = depth_3d(res[0][j], a);
      }
  }
  __syncthreads();  // every row is read: stage the results over them
  const int span = B * S;  // floats a result's stage
  if (live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dst = rows + k * span + threadIdx.x * S;
      if (a.vec_out) {
#pragma unroll
        for (int j = 0; j + 3 < P; j += 4)
          if (j < S)
            *reinterpret_cast<float4*>(dst + j) = make_float4(
                res[k][j], res[k][j + 1], res[k][j + 2], res[k][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j)
          if (j < S) dst[j] = res[k][j];
      }
    }
  }
  __syncthreads();
  float* outs[4] = {a.depth, a.add, a.mul, a.z3d};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* dst = outs[k] + r0 * S;
    if (a.vec_out) {
      for (int e = threadIdx.x; e < nb * S / 4; e += B)
        reinterpret_cast<float4*>(dst)[e] = smem[(k * span >> 2) + e];
    } else {
      for (int e = threadIdx.x; e < nb * S; e += B)
        dst[e] = rows[k * span + e];
    }
  }
}

template <int P>
int launch(const SortArgs& a, cudaStream_t s) {
  constexpr int B = P <= 16 ? 128 : 64;
  const size_t smem =
      (size_t)max(B * ((3 * a.S) | 1), 4 * B * a.S) * sizeof(float);
  const long long blocks = (a.N + B - 1) / B;
  depth_sort_kernel<P, B><<<(unsigned)blocks, B, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace pn

// Returns 0, -1 for arguments the kernel does not take (1 <= S <= 32,
// ld >= 3 S, N >= 0), or the CUDA error of the launch.
extern "C" int pn_depth_sort(const float* mm, long long ld, long long N,
                             int S, float range, float near, float eps,
                             float* depth, float* add, float* mul, float* z3d,
                             void* stream) {
  if (N < 0 || S < 1 || S > pn::kSortMaxSamples || ld < 3LL * S) return -1;
  if (N == 0) return 0;
  pn::SortArgs a = {};
  a.mm = mm;
  a.depth = depth;
  a.add = add;
  a.mul = mul;
  a.z3d = z3d;
  a.N = N;
  a.ld = ld;
  a.S = S;
  a.range = range;
  a.near = near;
  a.eps = eps;
  auto fits = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  a.vec_in = ld % 4 == 0 && (3 * S) % 4 == 0 && fits(mm);
  a.vec_out = S % 4 == 0 && fits(depth) && fits(add) && fits(mul) &&
              fits(z3d);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (S <= 1) return pn::launch<1>(a, s);
  if (S <= 2) return pn::launch<2>(a, s);
  if (S <= 4) return pn::launch<4>(a, s);
  if (S <= 8) return pn::launch<8>(a, s);
  if (S <= 16) return pn::launch<16>(a, s);
  return pn::launch<32>(a, s);
}
