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
// memory, so a block keeps the whole chain of its rays on the SM and only x
// and the head cross the bus.
//
// bf16 (`minmax_wg_kernel`, the serving path) runs on hopper.cuh's warpgroup
// frame, as the bf16 NeRF kernel does (see the head of fused_nerf.cu): the
// weights have to reach every SM once per 128 rays (0.7 MB a pass, from L2),
// so products are `wgmma` m64n128k16, the activations stay in registers
// from layer to layer (the ELU epilogue of one layer writes the A registers
// of the next), and the weights stream through a ring of 32 KB stages filled
// by bulk copies on mbarriers, in the order the chain consumes them. One
// persistent block per SM walks tiles of 128 rays: two consumer warpgroups
// of 64 rays that take turns at the tensor cores, and a helper warpgroup.
// What differs from the NeRF chain:
//  * layer 0 (K = C, padded to a multiple of 16: one k-step for the sampler,
//    seven for the refine net) takes A from shared memory through a
//    descriptor: three helper warps read x_t [C, N] along rays (coalesced),
//    round it to bf16 and write it transposed and swizzled, the pad columns
//    C..Kpad as zero (the panel's pad columns are zero too: left-over shared
//    memory times a zero weight can be NaN). One buffer is enough: the
//    consumers read it only in layer 0, and the helpers fill it for the next
//    tile while layers 1.. run;
//  * the A buffer and a layer-0 stage hold two k-slabs (K <= 128). A wider
//    input (the refine net of more samples or views: C = 6 + 3 V S) runs
//    layer 0 in passes of 128 k, the instantiation PASSES: each half of 128
//    outputs accumulates over the passes in the same registers, and the
//    helpers refill the A buffer for every (half, pass), 2 P fills a tile
//    instead of one. The stages are then the slabs of a pass; the blob's
//    bytes are the same either way;
//  * the head (out_pad = 32 or 40 rows, any multiple of 8) and the biases stay
//    in shared memory for the block's life; the head runs as m64n32k16
//    products and m64n8k16 for the rest, its rounded, biased values go to a
//    result buffer as bf16 (they are bf16 values), and the helper warps store
//    the tile to `out` coalesced for either stride pair while the consumers
//    work on the next one. The ragged last tile has zero A rows and its
//    missing rays are not stored.
//
// f32 (`minmax_kernel<PF32>`, the exactness check, not on the serving path):
// plain FMA loops through common.cuh, activations in shared memory.
//
// Weights, f32 blob (pack dtype f32), one contiguous buffer:
//   [w0 256 x Kpad | b0 256 | (w_i 256x256 | b_i 256) x (depth-1)
//    | wout out_pad x 256 | bout out_pad]
// with Kpad = C rounded up to a multiple of 32 (zero columns).
// Weights, bf16 blob: the ring stages of one tile (MmBlob::stage_off), then
// the head slabs (wout 4 x [out_pad x 64]), then the biases b0..b_{depth-1}
// bout; see `_blob` in ../fused_minmax.py.

#include "common.cuh"
#include "hopper.cuh"

namespace pn {

// ------------------------------------------------------------------ f32 --

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

// ----------------------------------------------------------------- bf16 --

constexpr int kMaxK0Slabs = 2;     // k-slabs of a layer-0 pass (128 k)
constexpr int kPassK = 64 * kMaxK0Slabs;
constexpr int kASlabBytes = kWgRays * 128;   // a warpgroup's 64 rows of 64 k

struct MmArgs {
  const void* x;       // [C, N], f32 or bf16
  const void* blob;
  float* out;
  long long sr, sc;    // strides of out: ray, column
  int x_is_bf16, N, C;
  int k0;              // C padded to a multiple of 16
  int n0;              // k-slabs of 64 that hold k0
  int passes;          // layer-0 passes of up to kMaxK0Slabs slabs
  int np;              // slabs of a pass: min(n0, kMaxK0Slabs)
  int depth, out_pad;
};

// The bf16 blob, in bytes. A tile consumes 2 P + 4 (depth - 1) ring stages:
// layer 0 as P stages per half of 128 outputs (the half's n0 slabs of
// [128 x 64], 16 KB each, two to a stage), then each hidden layer as four
// stages of two slabs (outputs 0..127 over all of k, then 128..255).
struct MmBlob {
  static constexpr int kStagesPerLayer = 4;
  static constexpr int kStageBytes = 32768;
  int n0, passes, depth, out_pad;
  __host__ __device__ int layer0_stages() const { return 2 * passes; }
  __host__ __device__ int stages_per_tile() const {
    return layer0_stages() + kStagesPerLayer * (depth - 1);
  }
  __host__ __device__ int stage_bytes(int i) const {
    if (i >= layer0_stages()) return kStageBytes;
    const int left = n0 - kMaxK0Slabs * (i % passes);   // slabs of the pass
    return (left < kMaxK0Slabs ? left : kMaxK0Slabs) * kSlab128Bytes;
  }
  __host__ __device__ int stage_off(int i) const {
    return i < layer0_stages()
               ? ((i / passes) * n0 + kMaxK0Slabs * (i % passes)) *
                     kSlab128Bytes
               : 2 * n0 * kSlab128Bytes +
                     (i - layer0_stages()) * kStageBytes;
  }
  __host__ __device__ int head_bytes() const { return out_pad * 512; }
  __host__ __device__ int heads() const { return stage_off(stages_per_tile()); }
  __host__ __device__ int biases() const { return heads() + head_bytes(); }
  __host__ __device__ int n_biases() const { return depth * kW + out_pad; }
  __host__ __device__ long long elems() const {
    return biases() / 2 + n_biases();
  }
};
static_assert(MmBlob::kStageBytes == kRingStageBytes, "a stage fills a slot");
static_assert(kMaxK0Slabs * kSlab128Bytes <= kRingStageBytes,
              "a layer-0 stage fits a slot");

// Shared memory of the bf16 kernel, from a 1,024-byte boundary: the layer-0
// A rows of a pass (one buffer, both warpgroups), the head slabs, the weight
// ring, the biases (bf16, as in the blob), two result buffers [128][out_pad]
// bf16, the mbarriers.
struct MmSmem {
  static constexpr int kLimit = 232448 - 1024;   // room to align the base
  int a, head, ring, stages, bias, res, res_bytes, bars, bytes;
  __host__ __device__ MmSmem(const MmBlob& b) {
    a = 0;
    head = a + 2 * (b.n0 < kMaxK0Slabs ? b.n0 : kMaxK0Slabs) * kASlabBytes;
    ring = head + b.head_bytes();
    res_bytes = kWgTile * b.out_pad * 2;
    const int rest = ((b.n_biases() * 2 + 15) & ~15) + 2 * res_bytes + 256;
    const int n = (kLimit - ring - rest) / kRingStageBytes;
    stages = n > kMaxStages ? kMaxStages : n;
    bias = ring + stages * kRingStageBytes;
    res = bias + ((b.n_biases() * 2 + 15) & ~15);
    bars = res + 2 * res_bytes;
    bytes = 1024 + bars + 256;
  }
};

// The rows of x_t of layer-0 pass `pass` (k in [kPassK pass, + kPassK)) for
// the tile of 128 rays from `base`, rounded to bf16, written by the helper
// threads (`t` of kHelpers) into the A buffer at `abuf`: warpgroup w's 64
// rays at + w * np * kASlabBytes, k-slab s of the pass at + s * kASlabBytes,
// row r of 128 bytes with the slab swizzle. An item is 8 columns of one ray:
// eight loads along rays (coalesced), one 16-byte store.
// The input's dtype is a template argument: a bf16 input is copied as it is,
// two values a word (with the dtype chosen per element the refine net's bf16
// input took twice the kernel's time). Loading four items before storing any
// was no faster for an f32 input and 0.1 ms slower for a bf16 one.
template <bool BF16>
__device__ __forceinline__ void mm_write_a(const MmArgs& a, int base,
                                           int pass, unsigned char* abuf,
                                           int t) {
  const int k_lo = kPassK * pass;
  const int items = kWgTile * (min(kPassK, a.k0 - k_lo) / 8);
  for (int idx = t; idx < items; idx += kHelpers) {
    const int r = idx % kWgTile, c0 = 8 * (idx / kWgTile), row = r % kWgRays;
    const int ray = base + r, k = k_lo + c0;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const size_t at = (size_t)(k + e) * a.N + ray;
      const bool ok0 = ray < a.N && k + e < a.C;
      const bool ok1 = ray < a.N && k + e + 1 < a.C;
      if constexpr (BF16) {
        const unsigned short* x = static_cast<const unsigned short*>(a.x);
        w[e / 2] = (ok0 ? (uint32_t)__ldg(x + at) : 0u) |
                   (ok1 ? (uint32_t)__ldg(x + at + a.N) << 16 : 0u);
      } else {
        const float* x = static_cast<const float*>(a.x);
        w[e / 2] = hp::pack_bf16x2(ok0 ? __ldg(x + at) : 0.0f,
                                   ok1 ? __ldg(x + at + a.N) : 0.0f);
      }
    }
    *reinterpret_cast<uint4*>(
        abuf + (r / kWgRays) * a.np * kASlabBytes + (c0 / 64) * kASlabBytes +
        row * 128 + ((((c0 % 64) >> 3) ^ (row & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Head columns [c0, c0 + 2 NACC) of this thread's rows: round(round(acc) +
// bias) as bf16 pairs into the result rows `res` ([ray][out_pad]); `bias`
// holds the head's biases in packed pairs.
template <int NACC>
__device__ __forceinline__ void mm_head_store(const float (&d)[NACC],
                                              uint32_t* res, int out_pad,
                                              int row0, int q, int c0,
                                              const uint32_t* bias) {
#pragma unroll
  for (int p = 0; p < NACC / 2; ++p) {
    const int r = row0 + 8 * (p % 2), c = c0 + 8 * (p / 2) + 2 * q;
    res[(r * out_pad + c) / 2] = wg_add_pair<Act::kNone>(
        hp::pack_bf16x2(d[2 * p], d[2 * p + 1]), bias[c / 2]);
  }
}

template <bool PASSES>
__global__ void __launch_bounds__(kWgThreads, 1)
    minmax_wg_kernel(const __grid_constant__ MmArgs a) {
  const MmBlob B = {a.n0, a.passes, a.depth, a.out_pad};
  const MmSmem M(B);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const uint32_t sm32 = hp::smem_u32(sm);

  const int N = a.N, out_pad = a.out_pad;
  const int tid = threadIdx.x, wg = tid >> 7;
  // mbarriers: the weight ring, the head, the A rows, the results
  const uint32_t full = sm32 + M.bars, empty = full + 8 * kMaxStages,
                 head_bar = empty + 8 * kMaxStages, a_full = head_bar + 8,
                 a_empty = a_full + 8, res_full = a_empty + 8,
                 res_empty = res_full + 16;
  const uint32_t ring_buf = sm32 + M.ring;
  const unsigned char* blob = static_cast<const unsigned char*>(a.blob);
  const int n_tiles = (N + kWgTile - 1) / kWgTile;

  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, 8);   // consumer warps
    }
    hp::mbar_init(head_bar, 1);
    hp::mbar_init(a_full, 3);            // helper warps
    hp::mbar_init(a_empty, 8);           // consumer warps
    for (int i = 0; i < 2; ++i) {
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
        hp::mbar_arrive_expect_tx(head_bar, B.head_bytes());
        hp::bulk_g2s(sm32 + M.head, blob + B.heads(), B.head_bytes(),
                     head_bar);
        WgRingFill fill = {{empty, (uint32_t)M.stages, 0, 0}, full, ring_buf};
        const int per_tile = B.stages_per_tile();
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
          for (int i = 0; i < per_tile; ++i)
            fill.put(blob + B.stage_off(i), B.stage_bytes(i));
      }
    } else {
      // Three warps write the A rows of the next tile as soon as the
      // consumers have read this one's (layer 0), then store the tile the
      // consumers finished last. With PASSES, the rows of every (half, pass)
      // of layer 0 in turn, and the store after the first of them.
      const int t = tid - (kWgThreads - kHelpers);
      WgTurns at = {a_empty, 1, 0, 0}, rt = {res_full, 2, 0, 0};
      auto output = [&](int tile) {
        hp::mbar_wait(rt.bar(), rt.phase);
        const int base = tile * kWgTile;
        const int live = min(kWgTile, N - base);
        const unsigned char* res = sm + M.res + rt.at * M.res_bytes;
        if (a.sc == 1 && a.sr == out_pad) {
          // [N, out_pad]: the tile's rows are one contiguous chunk
          float4* dst = reinterpret_cast<float4*>(a.out + (size_t)base * out_pad);
          const uint2* src = reinterpret_cast<const uint2*>(res);
          for (int idx = t; idx < live * out_pad / 4; idx += kHelpers) {
            const uint2 v = src[idx];
            dst[idx] = make_float4(hp::bf16_lo(v.x), hp::bf16_hi(v.x),
                                   hp::bf16_lo(v.y), hp::bf16_hi(v.y));
          }
        } else {
          // any other strides, e.g. [out_pad, N]: rays along the threads
          const __nv_bfloat16* src =
              reinterpret_cast<const __nv_bfloat16*>(res);
          for (int idx = t; idx < out_pad * kWgTile; idx += kHelpers) {
            const int n = idx / kWgTile, r = idx % kWgTile;
            if (r < live)
              a.out[(long long)(base + r) * a.sr + n * a.sc] =
                  __bfloat162float(src[r * out_pad + n]);
          }
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(res_empty + 8 * rt.at);
        rt.next();
      };
      const int fills = PASSES ? 2 * a.passes : 1;
      int finished = -1;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int f = 0; f < fills; ++f) {
          const int pass = PASSES ? f % a.passes : 0;
          hp::mbar_wait(at.bar(), at.phase ^ 1);
          if (a.x_is_bf16)
            mm_write_a<true>(a, tile * kWgTile, pass, sm + M.a, t);
          else
            mm_write_a<false>(a, tile * kWgTile, pass, sm + M.a, t);
          hp::fence_proxy_async();
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(a_full);
          at.next();
          if (f == 0 && finished >= 0) output(finished);
        }
        finished = tile;
      }
      if (finished >= 0) output(finished);
    }
  } else {
    // ------------------------------------------------------ consumers --
    hp::setmaxnreg_inc<216>();
    const int wt = tid & 127, warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = wg * kWgRays + 16 * warp + g;   // rows row0, row0 + 8

    // biases as packed bf16 pairs (word n / 2 holds columns n, n + 1)
    uint32_t* bias2 = reinterpret_cast<uint32_t*>(sm + M.bias);
    const uint32_t* bias_q = bias2 + q;   // this thread's first column pair
    const uint32_t* bias_out = bias2 + a.depth * kW / 2;
    const uint32_t head = sm32 + M.head, head_slab = out_pad * 128;
    const uint64_t a_desc = hp::desc_k128(sm32 + M.a + wg * a.np * kASlabBytes);
    const int ksteps0 = a.k0 / 16;

    // the biases, once for the block's life
    {
      const uint32_t* bsrc =
          reinterpret_cast<const uint32_t*>(blob + B.biases());
      for (int i = tid; i < B.n_biases() / 2; i += 256) bias2[i] = bsrc[i];
    }
    hp::mbar_wait(head_bar, 0);
    hp::named_barrier(3, 256);
    if (wg == 1) wg_turn_pass();

    WgRing ring = {{full, (uint32_t)M.stages, 0, 0}, empty, ring_buf};
    WgTurns at = {a_full, 1, 0, 0}, rt = {res_empty, 2, 0, 0};
    float acc[64];
    uint32_t h[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      // the results buffer of this tile, once its last tile has left it
      hp::mbar_wait(rt.bar(), rt.phase ^ 1);
      // A point where the compiler sees the whole warpgroup together: without
      // one in the loop it issues every product serialized (ptxas C7520).
      hp::named_barrier(1 + wg, 128);
      if constexpr (!PASSES) {
        hp::mbar_wait(at.bar(), at.phase);

        // layer 0: A from shared memory, one stage a half
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          wg_dense128_ss(acc, a_desc, kASlabBytes, ring.wait(), ksteps0);
          ring.release(ring.advance());
          wg_epilogue<Act::kElu>(acc, h + 32 * hf,
                                 bias_cols(bias_q, hf * kHalf));
        }
        // this warp's last read of the A rows is behind it
        if (lane == 0) hp::mbar_arrive(a_empty);
        at.next();
      } else {
        // layer 0 in passes: per half, the sums of every pass's stage into
        // the same accumulators, each pass's A rows filled in turn
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll 1
          for (int p = 0; p < a.passes; ++p) {
            hp::mbar_wait(at.bar(), at.phase);
            wg_dense128_ss(acc, a_desc, kASlabBytes, ring.wait(),
                           min(kPassK / 16, ksteps0 - p * (kPassK / 16)),
                           p > 0);
            ring.release(ring.advance());
            if (lane == 0) hp::mbar_arrive(a_empty);
            at.next();
          }
          wg_epilogue<Act::kElu>(acc, h + 32 * hf,
                                 bias_cols(bias_q, hf * kHalf));
        }
      }
#pragma unroll 1
      for (int l = 1; l < a.depth; ++l)
        wg_layer256<Act::kElu>(acc, h, ring, bias_cols(bias_q, l * kW));

      // the head, resident: 32 columns at a time, then 8
      uint32_t* res =
          reinterpret_cast<uint32_t*>(sm + M.res + rt.at * M.res_bytes);
      int c0 = 0;
#pragma unroll 1
      for (; c0 + 32 <= out_pad; c0 += 32) {
        float d[16] = {};
        wg_turn_wait();
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int j = 4 * kk;
          hp::wgmma_m64n32k16_rs(
              d, h[j], h[j + 1], h[j + 2], h[j + 3],
              hp::desc_k128(head + (kk / 4) * head_slab + c0 * 128) +
                  (kk % 4) * hp::kDescKStep,
              kk);
        }
        hp::wgmma_commit();
        wg_turn_pass();
        hp::wgmma_wait<0>();
        hp::keep(d);
        mm_head_store(d, res, out_pad, row0, q, c0, bias_out);
      }
#pragma unroll 1
      for (; c0 < out_pad; c0 += 8) {
        float d[4] = {};
        wg_turn_wait();
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int j = 4 * kk;
          hp::wgmma_m64n8k16_rs(
              d, h[j], h[j + 1], h[j + 2], h[j + 3],
              hp::desc_k128(head + (kk / 4) * head_slab + c0 * 128) +
                  (kk % 4) * hp::kDescKStep,
              kk);
        }
        hp::wgmma_commit();
        wg_turn_pass();
        hp::wgmma_wait<0>();
        hp::keep(d);
        mm_head_store(d, res, out_pad, row0, q, c0, bias_out);
      }
      hp::keep(h);

      // this warp's results of the tile are written: over to the helpers
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(res_full + 8 * rt.at);
      rt.next();
    }
  }
}

// What the bf16 kernel takes: any C, the blob of this form, and at least
// two ring stages beside the rest of its shared memory.
inline bool minmax_wg_ok(const MmArgs& a, long long blob_elems) {
  const MmBlob b = {a.n0, a.passes, a.depth, a.out_pad};
  return blob_elems == b.elems() && MmSmem(b).stages >= 2;
}

// One persistent block per SM, at most one per tile.
int run_minmax_wg(const MmArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.N + kWgTile - 1) / kWgTile;
  const MmSmem m(MmBlob{a.n0, a.passes, a.depth, a.out_pad});
  return launch(a.passes > 1 ? minmax_wg_kernel<true>
                             : minmax_wg_kernel<false>,
                sms < tiles ? sms : tiles, kWgThreads, m.bytes, stream, a);
}

}  // namespace pn

// Returns the CUDA error of the launch (0 = launched), or -1 for arguments
// the kernel does not take (see minmax_wg_ok for bf16).
extern "C" int pn_fused_minmax(const void* x, int x_is_bf16, const void* blob,
                               long long blob_elems, float* out, int N, int C,
                               int depth, int out_pad,
                               long long out_stride_ray,
                               long long out_stride_col, int pack_bf16,
                               void* stream) {
  if (N <= 0 || C <= 0 || depth < 1 || out_pad <= 0 || out_pad % 8 != 0)
    return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (pack_bf16) {
    pn::MmArgs a = {};
    a.x = x;
    a.blob = blob;
    a.out = out;
    a.sr = out_stride_ray;
    a.sc = out_stride_col;
    a.x_is_bf16 = x_is_bf16;
    a.N = N;
    a.C = C;
    a.k0 = (C + 15) / 16 * 16;
    a.n0 = (a.k0 + 63) / 64;
    a.passes = (a.n0 + pn::kMaxK0Slabs - 1) / pn::kMaxK0Slabs;
    a.np = a.n0 < pn::kMaxK0Slabs ? a.n0 : pn::kMaxK0Slabs;
    a.depth = depth;
    a.out_pad = out_pad;
    if (!pn::minmax_wg_ok(a, blob_elems)) return -1;
    return pn::run_minmax_wg(a, s);
  }
  const int Kpad = (C + 31) / 32 * 32;
  const long long want = (long long)pn::kW * Kpad + pn::kW +
                         (long long)(depth - 1) * (pn::kW * pn::kW + pn::kW) +
                         (long long)out_pad * pn::kW + out_pad;
  if (blob_elems != want) return -1;
  return pn::run_minmax<pn::PF32>(x, x_is_bf16, blob, out, N, C, depth,
                                  out_pad, out_stride_ray, out_stride_col, s);
}
