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
// about 0.6 MB and stay in L2. As in fused_nerf.cu a block owns tiles of
// rays, loops over the ray's S samples itself (the TPU kernel's (ray-block,
// sample) grid is a choice for that machine) and keeps every activation of
// the chain on the SM.
//
// `nerf_q_wg_kernel` runs on hopper.cuh's warpgroup frame, as the bf16 NeRF
// kernel does (see the head of fused_nerf.cu for the frame: persistent blocks
// of two consumer warpgroups of 64 rays and a helper warpgroup; weights
// through a ring of 32 KB stages filled by bulk copies; the PE rows written
// by the helper warps). What is int8:
//  * the products are `wgmma` m64nNk32 s8 x s8 -> s32 with the codes of the
//    activation as A in registers and the int8 panel from the ring (K-major,
//    the only layout `wgmma` takes for 8-bit operands; a slab is 128 k). A
//    256-wide layer arrives as two 32 KB stages of a half and runs as eight
//    eighths of 32 outputs (m64n32k32, 16 accumulators: with halves of 128
//    ptxas ran out of registers and serialized the products). Layer 0 and
//    the PE half of layer 5 stay bf16 m64n32k16 with A = the PE rows in
//    shared memory;
//  * the epilogue requantises each layer into the A registers of the next
//    (`wg_requant`, hopper.cuh): four codes a register, under a fixed
//    permutation of k that the wrapper applies to the K columns of every
//    panel reading a requantised activation. Hidden layers never leave the
//    registers;
//  * the epilogue bounds the kernel, not the tensor cores, and what costs
//    in it is the instruction mix (scripts/torch_nerf_q_variants.py): FRND
//    and F2I run at a quarter of the FADD rate and an FMNMX costs as much as
//    several FADDs, so the floor is an add rounded down and the clamp at 0
//    the saturation of an add, on t / 256 (the blob's columns are scaled by
//    2^-8, exactly); s32 -> f32 is one I2FP, which measured cheaper than
//    the integer-add form (`s32_f32`, `requant_byte`). Every rounding point
//    is kept. A hidden layer's eighths alternate between two accumulator
//    blocks: a warpgroup's epilogue of one eighth runs while the products of
//    the next execute (the two warpgroups do not take turns: they gained
//    nothing once the int8 products were this short);
//  * layer 5 adds an int8 sum and an f32 PE sum unrounded, (acc * A5 +
//    pe_dot) + B5, so both sums of an output are live at once. It runs in
//    eighths of 32 outputs (16 s32 + 16 f32 accumulators beside the 32 A
//    registers: in quarters ptxas spilled and serialized the products), two
//    to a stage of [PE slab | two int8 slabs] for 64 panel rows; layer 0
//    (f32 sums only) in eighths too, so that the f32 accumulators are 16;
//  * the view layer runs in eighths of 32 outputs; its `vcon * vcon_scale`
//    term (f32, the same for the S samples of a ray) is written once a tile
//    by the helper warps into shared memory, in the order of the view
//    layer's accumulators, so each thread reads its own values with
//    conflict-free loads (read from device memory in the epilogue, even one
//    eighth ahead or prefetched into L1, they cost a quarter of the kernel).
//    The 64 KB leave room for three ring slots, not four;
//  * the heads are m64n8k32 on resident slabs; the lane of q = 0 stores a
//    ray's [rgb, sigma] of a sample as one float4 straight to `raw`, so no
//    result buffer takes shared memory and S does not bound it.
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
// Weight blob, bytes (`_blob` in ../fused_nerf_q.py): the 21 ring stages of
// one sample (QBlob::stage_bytes), then the resident part: the head slabs
// (waq 2 x [8 x 128], wrq [8 x 128]) and the f32 columns (QBlob::c_*).
// Panels that read a requantised activation (w1..w7, wf, wv, wa, wr) have
// their K columns permuted (hopper.cuh); w0p and w5p (bf16, K = 63 + one
// zero column) do not.

#include "common.cuh"
#include "hopper.cuh"

namespace pn {

constexpr int kSlab64Bytes = 64 * 128;   // a slab of 64 panel rows

struct QBlob {  // the int8 blob, in bytes
  static constexpr int kStagesPerSample = 21;
  // stages 9..12 are layer 5's quarters [w5p slab | w5q slab 0 | slab 1] of
  // 64 rows; 19 and 20 the view layer's quarters [wvq slab 0 | slab 1];
  // stage 0 is w0p (256 rows), the others a half [128 rows x two slabs]
  static constexpr int kFirstQuarter5 = 9, kFirstView = 19;
  __host__ __device__ static constexpr int stage_bytes(int i) {
    return i >= kFirstView ? 16384
           : (i >= kFirstQuarter5 && i < kFirstQuarter5 + 4) ? 24576
                                                             : 32768;
  }
  static constexpr int kRingBytes = 608 * 1024;
  static constexpr int kAlphaBytes = 2 * 1024, kRgbBytes = 1024;
  static constexpr int kHeadBytes = kAlphaBytes + kRgbBytes;
  // the f32 columns, bytes from their start. Layers 0..7 and the feature
  // layer as 128 pairs {A(2p), A(2p+1), B(2p), B(2p+1)}; the view layer as
  // 64 such pairs, then vcon_scale [128]; then Aa Ba Ar Br, 8 each.
  static constexpr int c_feat = 8 * 2048, c_view = c_feat + 2048,
                       c_vscale = c_view + 1024, c_heads = c_vscale + 512,
                       kColBytes = c_heads + 128;
  static constexpr int resident = kRingBytes;
  static constexpr int kResidentBytes = kHeadBytes + kColBytes;
  static constexpr long long kBlobBytes = resident + kResidentBytes;
};

__host__ __device__ constexpr int q_ring_bytes() {
  int n = 0;
  for (int i = 0; i < QBlob::kStagesPerSample; ++i) n += QBlob::stage_bytes(i);
  return n;
}
static_assert(q_ring_bytes() == QBlob::kRingBytes,
              "the stages tile the ring region");
static_assert(QBlob::stage_bytes(0) == kRingStageBytes, "a stage fits a slot");

// Shared memory of the int8 kernel, from a 1,024-byte boundary: the PE rows
// (two buffers: the next sample's are written while this one's are read),
// the resident part of the blob (head slabs, then the columns), the
// mbarriers, the tile's vcon * vcon_scale (f32, in the order of the view
// layer's accumulators: [2 wg][64 elements][128 threads]), the weight ring
// of three slots (the fourth would not fit beside the 64 KB of vcon). The
// results go straight to device memory, so nothing here depends on S: what
// fits at S = 8 fits at every S.
struct QSmem {
  static constexpr int kPeBytes = kWgRays * kPE * 2;   // one warpgroup's rows
  static constexpr int pe = 0;                         // [2][2 wg][64][64]
  static constexpr int resident = pe + 4 * kPeBytes;
  static constexpr int cols = resident + QBlob::kHeadBytes;
  static constexpr int bars = resident + QBlob::kResidentBytes;
  static constexpr int vv = bars + 128;
  static constexpr int kVvBytes = 2 * 64 * 128 * 4;
  static constexpr int kStages = 3;
  static constexpr int ring = (vv + kVvBytes + 1023) & ~1023;
  static constexpr int kBytes = 1024 + ring + kStages * kRingStageBytes;
};
static_assert(QSmem::resident % 1024 == 0, "head slabs on a 1,024-byte line");
static_assert(QSmem::kStages <= kMaxStages, "ring barriers");
static_assert(QSmem::kBytes <= 232448, "fits the 227 KB of a block");

struct NerfQArgs {
  const float* pts;    // [S*3, N]
  const float* vcon;   // [128, N]
  const unsigned char* blob;
  float* raw;          // [N, S, 4]
  int N, S;
};

// vcon * vcon_scale of the 128 rays from `base` (`vscale` is the blob's,
// times 2^-8 as the other addends of the requant), written by the helper
// threads (`t` of kHelpers) into `vv` in the order of the view layer's
// accumulators: element i of eighth e of consumer thread wt of warpgroup w at
// vv[(w * 64 + 16 e + i) * 128 + wt], the (row, column) of that accumulator
// (hopper.cuh). Rays are read along the array, so the loads coalesce.
__device__ __forceinline__ void q_write_vcon(const NerfQArgs& a, int base,
                                             const float* vscale, float* vv,
                                             int t) {
  for (int idx = t; idx < kWgTile * 128; idx += kHelpers) {
    const int r = idx % kWgTile, c = idx / kWgTile;
    const float v = base + r < a.N ? a.vcon[(size_t)c * a.N + base + r] : 0.0f;
    const int w = r >> 6, row = r & 63;   // warpgroup, its row
    const int wt = 32 * (row >> 4) + 4 * (row & 7) + ((c >> 1) & 3);
    const int i = 16 * (c >> 5) + 4 * ((c >> 3) & 3) + 2 * ((row >> 3) & 1) +
                  (c & 1);
    vv[(w * 64 + i) * 128 + wt] = __fmul_rn(v, vscale[c]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    nerf_q_wg_kernel(const __grid_constant__ NerfQArgs a) {
  using M = QSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* sm = smem_raw + pad;
  const uint32_t sm32 = hp::smem_u32(sm);

  const int N = a.N, S = a.S;
  const int tid = threadIdx.x, wg = tid >> 7;
  // mbarriers: the weight ring, the resident part, the PE rows, the vcon
  const uint32_t full = sm32 + M::bars, empty = full + 8 * kMaxStages,
                 res_bar = empty + 8 * kMaxStages, pe_full = res_bar + 8,
                 pe_empty = pe_full + 16, vv_full = pe_empty + 16,
                 vv_empty = vv_full + 8;
  const uint32_t ring_buf = sm32 + M::ring;
  const int n_tiles = (N + kWgTile - 1) / kWgTile;

  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, 8);   // consumer warps
    }
    hp::mbar_init(res_bar, 1);
    for (int i = 0; i < 2; ++i) {
      hp::mbar_init(pe_full + 8 * i, 3);    // helper warps
      hp::mbar_init(pe_empty + 8 * i, 8);   // consumer warps
    }
    hp::mbar_init(vv_full, 3);
    hp::mbar_init(vv_empty, 8);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------- helper warps --
    hp::setmaxnreg_dec<72>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    if (warp == 0) {
      // the weights: one thread copies the resident part, then keeps the
      // ring full
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(res_bar, QBlob::kResidentBytes);
        hp::bulk_g2s(sm32 + M::resident, a.blob + QBlob::resident,
                     QBlob::kResidentBytes, res_bar);
        WgRingFill fill = {{empty, M::kStages, 0, 0}, full, ring_buf};
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
          for (int s = 0; s < S; ++s) {
            int off = 0;
            for (int i = 0; i < QBlob::kStagesPerSample; ++i) {
              fill.put(a.blob + off, QBlob::stage_bytes(i));
              off += QBlob::stage_bytes(i);
            }
          }
      }
    } else {
      // Three warps write the PE rows, up to two samples ahead, and once a
      // tile, after its first sample's rows, the tile's vcon * vcon_scale,
      // once the consumers' last view layer of the tile before is done.
      const int t = tid - (kWgThreads - kHelpers);
      const float* vscale =
          reinterpret_cast<const float*>(sm + M::cols + QBlob::c_vscale);
      float* vv = reinterpret_cast<float*>(sm + M::vv);
      WgTurns pt = {pe_empty, 2, 0, 0};
      uint32_t vv_phase = 0;
      hp::mbar_wait(res_bar, 0);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < S; ++s) {
          hp::mbar_wait(pt.bar(), pt.phase ^ 1);
          wg_write_pe(a.pts, N, tile * kWgTile, s,
                      sm + M::pe + pt.at * 2 * M::kPeBytes, t);
          hp::fence_proxy_async();
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(pe_full + 8 * pt.at);
          pt.next();
          if (s == 0) {
            hp::mbar_wait(vv_empty, vv_phase ^ 1);
            q_write_vcon(a, tile * kWgTile, vscale, vv, t);
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(vv_full);
            vv_phase ^= 1;
          }
        }
    }
  } else {
    // ------------------------------------------------------ consumers --
    hp::setmaxnreg_inc<216>();
    const int wt = tid & 127, warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = 16 * warp + g;   // this thread's rows: row0, row0 + 8

    // this thread's first column pair of each epilogue (see wg_requant): a
    // layer's pairs are 128 float4 apart
    const float4* cols = reinterpret_cast<const float4*>(sm + M::cols) + q;
    // this thread's copy of vcon * vcon_scale, element i at vv[i * 128]
    const float* vv = reinterpret_cast<const float*>(sm + M::vv) +
                      wg * 64 * 128 + wt;
    uint32_t vv_phase = 0;
    const float* head =   // Aa, Ba, Ar, Br
        reinterpret_cast<const float*>(sm + M::cols + QBlob::c_heads);
    const uint64_t alpha_desc = hp::desc_k128(sm32 + M::resident);
    const uint64_t rgb_desc =
        hp::desc_k128(sm32 + M::resident + QBlob::kAlphaBytes);
    hp::mbar_wait(res_bar, 0);

    WgRing ring = {{full, M::kStages, 0, 0}, empty, ring_buf};
    WgTurns pt = {pe_full, 2, 0, 0};
    uint32_t h[32];   // the codes of the current activation, as A registers
    // The accumulators of every product, in the same registers all the way
    // (as in the bf16 kernel), set once, here (a write to them inside the
    // loop makes ptxas serialize the products): s32 for two eighths of 32
    // outputs, f32 for an eighth of a PE product, s32 for a head (apart:
    // inside the block, ptxas serialized the products).
    int acc[32], head_acc[4];
    float pdot[16];
    int (&acc_e)[16] = *reinterpret_cast<int (*)[16]>(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) pdot[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) head_acc[i] = 0;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * kWgTile + wg * kWgRays;
      const int live = min(kWgRays, max(N - base, 0));
      // A point where the compiler sees the whole warpgroup together: without
      // one in the loop it issues every product serialized (ptxas C7520).
      hp::named_barrier(1 + wg, 128);

      for (int s = 0; s < S; ++s) {
        hp::mbar_wait(pt.bar(), pt.phase);
        const uint64_t pe_desc = hp::desc_k128(
            sm32 + M::pe + (pt.at * 2 + wg) * M::kPeBytes);

        // layer 0: the bf16 PE product in eighths of 32 outputs, all from
        // one stage; its f32 sums straight into h0 codes
        {
          const uint32_t stage = ring.wait();
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            hp::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              hp::wgmma_m64n32k16_ss(
                  pdot, pe_desc + kk * hp::kDescKStep,
                  hp::desc_k128(stage + e * (kSlab64Bytes / 2)) +
                      kk * hp::kDescKStep,
                  kk);
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::keep(pdot);
            wg_requant<16>(h + 4 * e, cols + 16 * e,
                           [&](int i, float ca, float cb) {
                             return __fadd_rn(__fmul_rn(pdot[i], ca), cb);
                           });
          }
          ring.release(ring.advance());
        }
        // layers 1..4
#pragma unroll 1
        for (int l = 1; l <= 4; ++l)
          wg_layer256_s8(acc, h, ring, cols + 128 * l);
        // layer 5 in eighths of 32 outputs, two to a stage [PE slab | two
        // int8 slabs] of 64 rows: the PE product and the int8 product queued
        // together, then (acc * A5 + pe_dot) + B5
        {
          uint32_t out[28];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            hp::wgmma_fence();
            const uint32_t stage = ring.wait() + (e % 2) * (kSlab64Bytes / 2);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              hp::wgmma_m64n32k16_ss(
                  pdot, pe_desc + kk * hp::kDescKStep,
                  hp::desc_k128(stage) + kk * hp::kDescKStep, kk);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              hp::wgmma_m64n32k32_s8(
                  acc_e, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2],
                  h[4 * kk + 3],
                  hp::desc_k128(stage + (1 + kk / 4) * kSlab64Bytes) +
                      (kk % 4) * hp::kDescKStep,
                  kk);
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            if (e % 2) ring.release(ring.advance());
            hp::keep(pdot);
            hp::keep(acc_e);
            hp::keep(h);
            // the last eighth's codes go straight into h: its products are
            // done
            wg_requant<16>(
                e < 7 ? out + 4 * e : h + 28, cols + 128 * 5 + 16 * e,
                [&](int i, float ca, float cb) {
                  return __fadd_rn(
                      __fadd_rn(__fmul_rn(s32_f32(acc[i]), ca), pdot[i]), cb);
                });
          }
#pragma unroll
          for (int i = 0; i < 28; ++i) h[i] = out[i];
        }
        // this warp's last read of the sample's PE rows is behind it
        if (lane == 0) hp::mbar_arrive(pe_empty + 8 * pt.at);
        pt.next();
        // layers 6, 7
#pragma unroll 1
        for (int l = 6; l <= 7; ++l)
          wg_layer256_s8(acc, h, ring, cols + 128 * l);

        // sigma head (column 0 of 8, resident) on h7: f32, no requant
        float sig0, sig1;
        {
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            hp::wgmma_m64n8k32_s8(
                head_acc, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2], h[4 * kk + 3],
                alpha_desc + (kk / 4) * (1024 >> 4) + (kk % 4) * hp::kDescKStep,
                kk);
          hp::wgmma_commit();
          hp::wgmma_wait<0>();
          hp::keep(head_acc);
          sig0 = __fadd_rn(__fmul_rn(s32_f32(head_acc[0]), head[0]), head[8]);
          sig1 = __fadd_rn(__fmul_rn(s32_f32(head_acc[2]), head[0]), head[8]);
        }
        // the feature layer (linear: its offset is folded into B)
        wg_layer256_s8(acc, h, ring, cols + 128 * 8);
        // view branch in eighths of 32 outputs (two to a stage): (acc * Av +
        // vcon * vcon_scale) + Bv, the second term from the helpers' copy
        // (a tile's first sample waits for it; its last releases it)
        if (s == 0) hp::mbar_wait(vv_full, vv_phase);
        uint32_t hv[16];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vc[16];
          hp::wgmma_fence();
          const uint32_t stage = ring.wait() + (e % 2) * (kSlab64Bytes / 2);
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            hp::wgmma_m64n32k32_s8(
                acc_e, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2], h[4 * kk + 3],
                hp::desc_k128(stage + (kk / 4) * kSlab64Bytes) +
                    (kk % 4) * hp::kDescKStep,
                kk);
          hp::wgmma_commit();
#pragma unroll
          for (int i = 0; i < 16; ++i) vc[i] = vv[(16 * e + i) * 128];
          hp::wgmma_wait<0>();
          if (e % 2) ring.release(ring.advance());
          hp::keep(acc_e);
          hp::keep(h);
          wg_requant<16>(
              hv + 4 * e, cols + 128 * 9 + 16 * e,
              [&](int i, float ca, float cb) {
                return __fadd_rn(
                    __fadd_rn(__fmul_rn(s32_f32(acc[i]), ca), vc[i]), cb);
              });
        }
        if (s == S - 1) {
          if (lane == 0) hp::mbar_arrive(vv_empty);
          vv_phase ^= 1;
        }
        // rgb head (columns 0..2 of 8, resident) on the 128 view codes; the
        // lane of q = 0 stores [rgb, sigma] of its rays, column 2 from the
        // lane of q = 1
        {
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hp::wgmma_m64n8k32_s8(head_acc, hv[4 * kk], hv[4 * kk + 1],
                                  hv[4 * kk + 2], hv[4 * kk + 3],
                                  rgb_desc + kk * hp::kDescKStep, kk);
          hp::wgmma_commit();
          hp::wgmma_wait<0>();
          hp::keep(head_acc);
          hp::keep(hv);
          const float* ar = head + 16 + 2 * q;   // Ar of columns 2q, 2q + 1
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = __fadd_rn(__fmul_rn(s32_f32(head_acc[i]), ar[i & 1]),
                             ar[8 + (i & 1)]);
          const float b0 = __shfl_down_sync(0xffffffffu, v[0], 1);
          const float b1 = __shfl_down_sync(0xffffffffu, v[2], 1);
          if (q == 0) {
            float* rs = a.raw + ((size_t)(base + row0) * S + s) * 4;
            if (row0 < live)
              *reinterpret_cast<float4*>(rs) = make_float4(v[0], v[1], b0, sig0);
            if (row0 + 8 < live)
              *reinterpret_cast<float4*>(rs + (size_t)8 * S * 4) =
                  make_float4(v[2], v[3], b1, sig1);
          }
        }
      }
    }
  }
}

// One persistent block per SM, at most one per tile.
inline int run_nerf_q_wg(const NerfQArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.N + kWgTile - 1) / kWgTile;
  return launch(nerf_q_wg_kernel, sms < tiles ? sms : tiles, kWgThreads,
                QSmem::kBytes, stream, a);
}

}  // namespace pn

// Returns the CUDA error of the launch (0 = launched), or -1 for arguments
// the kernel does not take. Any S: every index that S multiplies ([S*3, N],
// [N, S, 4]) is taken in size_t.
extern "C" int pn_fused_nerf_raw_q(const float* pts24_t, const float* vcon_t,
                                   const void* blob, long long blob_bytes,
                                   float* raw, int N, int S, void* stream) {
  if (N <= 0 || S <= 0 || blob_bytes != pn::QBlob::kBlobBytes)
    return -1;
  pn::NerfQArgs a = {};
  a.pts = pts24_t;
  a.vcon = vcon_t;
  a.blob = static_cast<const unsigned char*>(blob);
  a.raw = raw;
  a.N = N;
  a.S = S;
  return pn::run_nerf_q_wg(a, reinterpret_cast<cudaStream_t>(stream));
}
