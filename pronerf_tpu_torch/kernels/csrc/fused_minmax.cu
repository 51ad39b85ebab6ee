// Fused MinMaxRay MLP (sampler / refine net) for Hopper.
//
// Replaces the TPU kernel pronerf_tpu/kernels/fused_minmax.py:fused_minmax_t
// (body _make_kernel): first layer pre-folded to [6 | rest] inputs, `depth`
// ELU layers of 256, a linear head padded to a multiple of 8, head written
// as f32.
//
// Bound on this card: operations. A ray costs about 0.34 M multiply-adds
// against 24 to 408 input bytes and 128 to 160 output bytes, far above the
// bf16 ridge; the weights (under 1 MB) stay in L2. What would make it
// memory-bound is writing each layer's [N, 256] activation back to device
// memory, so the design keeps the whole chain of a 64-ray tile in shared
// memory (two ping-pong buffers) and only x and the head cross the bus. The
// ragged last tile is masked here, not padded by the caller. The products
// and the way weight fragments are fetched are common.cuh's.
//
// Weights arrive as one contiguous blob in the pack dtype:
//   [w0 256 x Kpad | b0 256 | (w_i 256x256 | b_i 256) x (depth-1)
//    | wout out_pad x 256 | bout out_pad]
// with Kpad = C rounded up to a multiple of 32 (zero columns).

#include "common.cuh"

namespace pn {

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
minmax_kernel(const void* __restrict__ x, int x_is_bf16,
              const typename P::T* __restrict__ blob, float* __restrict__ out,
              int N, int C, int Kpad, int depth, int out_pad,
              long long out_stride_ray, long long out_stride_col) {
  using T = typename P::T;
  constexpr int TILE = P::TILE, LD = kW + P::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = Kpad + P::PAD;
  T* bufA = reinterpret_cast<T*>(smem_raw);
  T* bufB = bufA + TILE * LD;
  T* xs = bufB + TILE * LD;

  const int base = blockIdx.x * TILE;

  // x_t [C, N] -> xs [TILE, Kpad] in the pack dtype; rays are contiguous in
  // x_t, so consecutive threads read consecutive addresses.
  for (int idx = threadIdx.x; idx < TILE * Kpad; idx += P::THREADS) {
    const int r = idx % TILE, c = idx / TILE, ray = base + r;
    float v = 0.0f;
    if (ray < N && c < C) {
      const size_t at = (size_t)c * N + ray;
      v = x_is_bf16 ? __bfloat162float(
                          reinterpret_cast<const __nv_bfloat16*>(x)[at])
                    : reinterpret_cast<const float*>(x)[at];
    }
    xs[r * ldx + P::col(c)] = P::rnd(v);
  }
  __syncthreads();

  const T* w = blob;
  const T* b = w + (size_t)kW * Kpad;
  T* cur = bufA;
  T* nxt = bufB;
  dense_store<P>(xs, ldx, Kpad, w, kW, cur, LD, [&](int, int n, float acc) {
    return elu<P>(add<P>(P::rnd(acc), ro(b + n)));
  });
  __syncthreads();
  w = b + kW;
  for (int i = 1; i < depth; ++i) {
    b = w + (size_t)kW * kW;
    dense_store<P>(cur, LD, kW, w, kW, nxt, LD, [&](int, int n, float acc) {
      return elu<P>(add<P>(P::rnd(acc), ro(b + n)));
    });
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
    w = b + kW;
  }
  b = w + (size_t)out_pad * kW;
  dense_each<P>(cur, LD, kW, w, out_pad, [&](int r, int n, float acc) {
    const int ray = base + r;
    if (ray < N)
      out[ray * out_stride_ray + n * out_stride_col] =
          P::f(add<P>(P::rnd(acc), ro(b + n)));
  });
}

template <class P>
int run_minmax(const void* x, int x_is_bf16, const void* blob, float* out,
               int N, int C, int depth, int out_pad, long long sr,
               long long sc, cudaStream_t stream) {
  const int Kpad = (C + 31) / 32 * 32;
  const size_t smem =
      sizeof(typename P::T) *
      ((size_t)2 * P::TILE * (kW + P::PAD) + (size_t)P::TILE * (Kpad + P::PAD));
  const int blocks = (N + P::TILE - 1) / P::TILE;
  return launch(minmax_kernel<P>, blocks, P::THREADS, smem, stream, x,
                x_is_bf16, reinterpret_cast<const typename P::T*>(blob), out,
                N, C, Kpad, depth, out_pad, sr, sc);
}

}  // namespace pn

// Returns the CUDA error of the launch (0 = launched), or -1 for arguments
// the kernel does not take.
extern "C" int pn_fused_minmax(const void* x, int x_is_bf16, const void* blob,
                               long long blob_elems, float* out, int N, int C,
                               int depth, int out_pad,
                               long long out_stride_ray,
                               long long out_stride_col, int pack_bf16,
                               void* stream) {
  const int Kpad = (C + 31) / 32 * 32;
  const long long want = (long long)pn::kW * Kpad + pn::kW +
                         (long long)(depth - 1) * (pn::kW * pn::kW + pn::kW) +
                         (long long)out_pad * pn::kW + out_pad;
  if (N <= 0 || C <= 0 || depth < 1 || out_pad <= 0 || out_pad % 8 != 0 ||
      blob_elems != want)
    return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return pack_bf16
             ? pn::run_minmax<pn::PBf16>(x, x_is_bf16, blob, out, N, C, depth,
                                         out_pad, out_stride_ray,
                                         out_stride_col, s)
             : pn::run_minmax<pn::PF32>(x, x_is_bf16, blob, out, N, C, depth,
                                        out_pad, out_stride_ray,
                                        out_stride_col, s);
}
