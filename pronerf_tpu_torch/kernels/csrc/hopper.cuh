// Hopper building blocks shared by the kernels that run their products on
// `wgmma`: mbarriers, bulk asynchronous copies, the shared-memory matrix
// descriptor, the `wgmma` fence / commit / wait, the m64nNk16 bf16 products
// (N = 128, 32, 8) with A from registers (`_rs`) or from shared memory
// (`_ss`) and the m64nNk32 int8 products (N = 32, 8; A from registers),
// `setmaxnreg`, named barriers; then (namespace pn, after hp) the warpgroup
// frame that the NeRF (bf16 and int8) and the MinMax kernels are built on.
// Everything here needs `sm_90a`.
//
// Operand layout the products assume. B is a weight panel w_t [out, K] held
// K-MAJOR in slabs of 64 k: a slab is [rows][64] bf16, one row = 128 bytes,
// stored with the 128-byte swizzle (the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8)), groups of 8 rows 1,024 bytes apart, the slab itself on a
// 1,024-byte boundary. `desc_k128` describes such a slab; one k-step of 16
// advances the descriptor's address by 32 bytes. A from shared memory uses
// the same form with rows = rays. An int8 slab is the same 128 bytes a row,
// 128 k; one k-step of 32 advances the address by the same 32 bytes.
//
// Fragments (thread t of the warpgroup, warp w = t / 32, lane l, g = l / 4,
// q = l % 4). Accumulator register i of an m64nNk16 product is the element
//   row 16 w + g + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 q + (i % 2).
// The A operand of k-step j, as four registers of two bf16 each, is
//   a[0]: row g, k 16 j + 2 q + {0, 1}      a[1]: row g + 8, same k
//   a[2]: row g, k 16 j + 8 + 2 q + {0, 1}  a[3]: row g + 8, same k
// so the accumulators 8 j .. 8 j + 7 of a thread, rounded and packed in pairs,
// ARE that thread's A registers for k-step j of the next product: a chain of
// layers never has to leave the register file.
//
// int8 (m64nNk32, s32 sums). The accumulators are laid out as above. The A
// operand of k-step j is four registers of four codes each:
//   a[2 h]: row g, k 32 j + 16 h + 4 q + {0..3}   a[2 h + 1]: row g + 8, same k
// (h = 0, 1), so a thread's accumulator columns 8 c + 2 q + {0, 1} are NOT its
// A codes. They become so under a fixed permutation pi of k inside every chunk
// of 16: the next layer's weight panel holds at k position 16 m + 4 q + e the
// column of output 16 m + 8 (e / 2) + 2 q + (e % 2). The wrapper applies pi to
// the K columns of every panel that reads a requantised activation, when it
// builds the blob; the per-channel columns stay indexed by output. Then A
// register 2 m + r of a half (r = row half) packs the codes of accumulators
// 8 m + 2 r + {0, 1} and 8 m + 4 + 2 r + {0, 1} (`wg_requant`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {
namespace hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- barriers --

// bar.sync on a named barrier: `threads` threads (a multiple of 32) meet.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// bar.arrive: count this thread in without waiting.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// After the inits, before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts as having completed the phase of parity 1). A wait that does not end
// within seconds is a fault of the kernel: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// ------------------------------------------------------------ bulk copies --

// `bytes` (a multiple of 16) from device memory to this block's shared
// memory; completion is counted on `bar` as transferred bytes.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Writes made with ordinary stores become visible to `wgmma` and bulk copies
// (the asynchronous proxy) of this block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma --

// Descriptor of a K-major slab with the 128-byte swizzle (see the head).
__device__ __forceinline__ uint64_t desc_k128(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // LBO: unused here
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // SBO: 8 rows
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}
constexpr uint64_t kDescKStep = 32 >> 4;  // 16 bf16 along k

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving or reusing registers that products in flight
// still read or write: call on accumulators and A registers after the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Two f32 rounded to bf16 and packed, `lo` in the low half; with `RELU`,
// negative values become zero.
template <bool RELU = false>
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  if constexpr (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// Two packed bf16 pairs added, rounded once to bf16: for two bf16 values
// the same as their f32 sum rounded to bf16 (the sum is exact in f32, or the
// smaller value is too small to move the rounding).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// exp(x) in f32 to about 2 ulp (the bound CUDA states for `expf`) in four
// instructions, where `expf` takes several times as many: r = `ex2.approx`
// of t = x log2(e) rounded, then exp(x) = r e^d with d = x - t ln(2), a
// rounding error's worth, taken as r + r d. Results below 2^-126 flush to
// zero; x above 88.7 gives inf.
__device__ __forceinline__ float exp_f32(float x) {
  const float t = __fmul_rn(x, 1.44269502f);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(t));
  return fmaf(r, fmaf(t, -0.693147182f, x), r);
}

// D[64, N] (+)= A[64, 16] . B[N, 16]^T, bf16 operands, f32 sums. `scale_d`
// = 0 starts a new sum (D is not read). `_rs`: A from this thread's four
// registers; `_ss`: A through a descriptor. B always through a descriptor.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], 
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], 
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], 
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D[64, 32] (+)= A[64, 16] . B[32, 16]^T, bf16, A and B through descriptors.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64, N] (+)= A[64, 32] . B[N, 32]^T, int8 operands, exact s32 sums, A from
// this thread's four registers (each four codes, see the head of this file),
// B K-major through a descriptor (the only layout `wgmma` takes for 8-bit
// types). One k-step of 32 advances B's descriptor by 32 bytes, as for bf16.
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n8k32_s8(int (&d)[4],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

}  // namespace hp

// ------------------------------------------------------ warpgroup frame --
//
// The frame of a persistent block that streams a chain of 256-wide layers
// for 128 rays at a time (see the head of fused_nerf.cu for why it is built
// so): 384 threads, two consumer warpgroups of 64 rays each and a third
// warpgroup of helpers (warp 0 fills the weight ring, warps 1..3 do what is
// not a product). Weights arrive in a ring of up to kMaxStages slots of
// kRingStageBytes, each filled by one bulk copy of a stage image: one or two
// k-slabs (64 k, 128-byte swizzle, see the head of this file) of 128 or 256
// panel rows. The activations of a layer stay in the consumers' registers.

constexpr int kWgRays = 64;          // rays of one consumer warpgroup
constexpr int kWgTile = 2 * kWgRays; // rays of a block per weight pass
constexpr int kWgThreads = 384;      // two consumer warpgroups + the helpers
constexpr int kMaxStages = 4;
constexpr int kHelpers = 96;         // threads of the third warpgroup's warps
                                     // 1..3 (warp 0 fills the weight ring)
constexpr int kHalf = 128;           // outputs of one m64n128 product
constexpr int kRingStageBytes = 32768;   // a ring slot
constexpr int kSlab128Bytes = kHalf * 128;   // a slab of 128 panel rows

// A barrier that alternates between `n` buffers: use k waits on (and fills)
// buffer k % n, in the phase of parity (k / n) % 2.
struct WgTurns {
  uint32_t bars, n, at, phase;   // shared address of barrier 0
  __device__ __forceinline__ uint32_t bar() const { return bars + 8 * at; }
  __device__ __forceinline__ void next() {
    if (++at == n) {
      at = 0;
      phase ^= 1;
    }
  }
};

// The producer's view of the weight ring: one thread copies each stage
// image into the next slot once every consumer warp has released it.
struct WgRingFill {
  WgTurns empty;         // the slots' `empty` barriers
  uint32_t full, buf;    // shared addresses of `full` barrier 0 and slot 0
  __device__ __forceinline__ void put(const void* src, uint32_t bytes) {
    hp::mbar_wait(empty.bar(), empty.phase ^ 1);
    hp::mbar_arrive_expect_tx(full + 8 * empty.at, bytes);
    hp::bulk_g2s(buf + empty.at * kRingStageBytes, src, bytes,
                 full + 8 * empty.at);
    empty.next();
  }
};

// The consumer's view of the weight ring.
struct WgRing {
  WgTurns full;          // the stages' `full` barriers
  uint32_t empty, buf;   // shared addresses of `empty` barrier 0 and stage 0
  // Wait for the current stage; returns its shared address.
  __device__ __forceinline__ uint32_t wait() const {
    hp::mbar_wait(full.bar(), full.phase);
    return buf + full.at * kRingStageBytes;
  }
  // Move to the next stage; returns the slot left behind.
  __device__ __forceinline__ uint32_t advance() {
    const uint32_t left = full.at;
    full.next();
    return left;
  }
  // This warp has finished reading slot `sl`.
  __device__ __forceinline__ void release(uint32_t sl) const {
    if ((threadIdx.x & 31) == 0) hp::mbar_arrive(empty + 8 * sl);
  }
};

// The two consumer warpgroups take turns at the tensor cores: a warpgroup
// waits for its turn, queues one block of products, and hands the turn over
// before it waits for them. Its epilogue then runs while the other
// warpgroup's products execute. Named barriers 4 and 5; warpgroup 1 gives
// warpgroup 0 the first turn. Both warpgroups must take the same number of
// turns.
__device__ __forceinline__ void wg_turn_wait() {
  hp::named_barrier(4 + (threadIdx.x >> 7), 256);
}
__device__ __forceinline__ void wg_turn_pass() {
  hp::named_barrier_arrive(5 - (threadIdx.x >> 7), 256);
}

// acc[64, 128] = A . W^T for 128 rows of a panel of K = 256, which arrive as
// two stages of two k-slabs [128 x 64] each; A from the 64 registers `a`.
// Stage 0 is released once the products of stage 1 are queued behind it, so
// the tensor cores always have work. The warpgroup takes its turn before it
// queues the block and passes it on before it waits.
__device__ __forceinline__ void wg_dense128(float (&acc)[64],
                                            uint32_t (&a)[64], WgRing& ring) {
  uint32_t prev = 0;
  wg_turn_wait();
  hp::wgmma_fence();
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const uint32_t stage = ring.wait();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int j = 4 * (8 * st + kk);
      const uint64_t d = hp::desc_k128(stage + (kk / 4) * kSlab128Bytes) +
                         (kk % 4) * hp::kDescKStep;
      hp::wgmma_m64n128k16_rs(acc, a[j], a[j + 1], a[j + 2], a[j + 3], d,
                              st | kk);
    }
    hp::wgmma_commit();
    if (st > 0) {
      wg_turn_pass();
      hp::wgmma_wait<1>();
      ring.release(prev);
    }
    prev = ring.advance();
  }
  hp::wgmma_wait<0>();
  ring.release(prev);
  hp::keep(acc);
  hp::keep(a);
}

// acc[64, 128] = A . W^T over `ksteps` k-steps of 16, A from shared memory:
// rows of the warpgroup's rays in k-slabs of 64 (`a_desc` describes slab 0,
// the next slab `a_slab_bytes` further); W as k-slabs [128 x 64] from `slab`
// (shared address), one after the other. With `accumulate` the products add
// to the sums already in acc (a product over K in parts), else they
// overwrite them.
__device__ __forceinline__ void wg_dense128_ss(float (&acc)[64],
                                               uint64_t a_desc,
                                               uint32_t a_slab_bytes,
                                               uint32_t slab, int ksteps,
                                               int accumulate = 0) {
  wg_turn_wait();
  hp::wgmma_fence();
#pragma unroll 4
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint64_t step = (kk % 4) * hp::kDescKStep;
    hp::wgmma_m64n128k16_ss(
        acc, a_desc + (((kk / 4) * a_slab_bytes) >> 4) + step,
        hp::desc_k128(slab + (kk / 4) * kSlab128Bytes) + step,
        kk | accumulate);
  }
  hp::wgmma_commit();
  wg_turn_pass();
  hp::wgmma_wait<0>();
  hp::keep(acc);
}

// The activation an epilogue applies after the bias.
enum class Act { kNone, kRelu, kElu };

// round(v + bias) for the pair of columns a register holds, from the packed
// rounded dots `dots`, then the activation: kRelu clamps; kElu takes
// exp(min(x, 0)) - 1 in f32 on the rounded sum for x <= 0 and rounds again
// (the MinMax nets' ELU as the TPU kernel writes it; exp_f32, not `expf`,
// which took half of the MinMax kernel's time). The bias comes as two f32
// or as one packed bf16 pair.
template <Act A>
__device__ __forceinline__ uint32_t wg_act(uint32_t v) {
  if constexpr (A == Act::kElu) {
    // exp is taken of every x and dropped where x > 0 (no branch)
    const float x0 = hp::bf16_lo(v), x1 = hp::bf16_hi(v);
    const float e0 = hp::exp_f32(x0) - 1.0f, e1 = hp::exp_f32(x1) - 1.0f;
    return hp::pack_bf16x2(x0 > 0.0f ? x0 : e0, x1 > 0.0f ? x1 : e1);
  } else if constexpr (A == Act::kRelu) {
    return hp::pack_bf16x2<true>(hp::bf16_lo(v), hp::bf16_hi(v));
  } else {
    return v;
  }
}
template <Act A>
__device__ __forceinline__ uint32_t wg_add_pair(uint32_t dots, float2 b) {
  const float lo = hp::bf16_lo(dots) + b.x, hi = hp::bf16_hi(dots) + b.y;
  if constexpr (A == Act::kElu) return wg_act<A>(hp::pack_bf16x2(lo, hi));
  else return hp::pack_bf16x2<A == Act::kRelu>(lo, hi);
}
template <Act A>
__device__ __forceinline__ uint32_t wg_add_pair(uint32_t dots, uint32_t b2) {
  return wg_act<A>(hp::add_bf16x2(dots, b2));
}
// the same with another packed addend in the place of the bias, in f32
__device__ __forceinline__ uint32_t wg_add_packed(uint32_t dots, uint32_t v) {
  return hp::pack_bf16x2(hp::bf16_lo(dots) + hp::bf16_lo(v),
                         hp::bf16_hi(dots) + hp::bf16_hi(v));
}

// This thread's bias of column pair p of 128 outputs (n-tile p / 2), from
// its first pair `b`: f32 (two floats a pair) or packed bf16 (one word).
__device__ __forceinline__ float2 bias_pair(const float* b, int p) {
  return *reinterpret_cast<const float2*>(b + 8 * (p / 2));
}
__device__ __forceinline__ uint32_t bias_pair(const uint32_t* b, int p) {
  return b[4 * (p / 2)];
}
// the bias `n` columns further
__device__ __forceinline__ const float* bias_cols(const float* b, int n) {
  return b + n;
}
__device__ __forceinline__ const uint32_t* bias_cols(const uint32_t* b,
                                                     int n) {
  return b + n / 2;
}

// The epilogue of 128 outputs of a layer: out = act(round(round(acc) +
// bias)), accumulator pair p -> A register p (see the head of this file).
// `bias` points at this thread's first column pair of the 128 (shared
// memory).
template <Act A, class Bias>
__device__ __forceinline__ void wg_epilogue(const float (&acc)[64],
                                            uint32_t* a, const Bias* bias) {
#pragma unroll
  for (int p = 0; p < 32; ++p)
    a[p] = wg_add_pair<A>(hp::pack_bf16x2(acc[2 * p], acc[2 * p + 1]),
                          bias_pair(bias, p));
}

// One 256-wide layer of K = 256 on h, in place: two halves of 128 outputs,
// each four k-slabs in two stages. h is read by both halves, so the first
// half's outputs wait beside it.
template <Act A, class Bias>
__device__ __forceinline__ void wg_layer256(float (&acc)[64],
                                            uint32_t (&h)[64], WgRing& ring,
                                            const Bias* bias) {
  uint32_t lo[32];
  wg_dense128(acc, h, ring);
  wg_epilogue<A>(acc, lo, bias);
  wg_dense128(acc, h, ring);
  wg_epilogue<A>(acc, h + 32, bias_cols(bias, kHalf));
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = lo[i];
}


// ------------------------------------------------------- positional rows --

constexpr int kL = 10;     // position octaves
constexpr int kPE = 64;    // PE row: 3 + 2 * 3 * kL = 63, padded

// The PE rows [x(3) | sin(30) | cos(30) | 0] of sample s of 128 rays from
// `base` (points `pts` [S * 3, N]), bf16, swizzled, written by the helper
// threads (`t` of kHelpers) into the two warpgroups' buffers at `pe` (shared
// memory; warpgroup w at + w * 64 rows of 128 bytes). The A operand of a
// layer that reads the encoding through a descriptor. The sin/cos arguments
// are ldexp of the f32 point (exact); only x and the results are rounded.
// Rounding x first, as the Pallas kernel does, leaves the top octave's
// phase (2^9 x) wrong by radians.
__device__ __forceinline__ void wg_write_pe(const float* pts, int N, int base,
                                            int s, unsigned char* pe, int t) {
  for (int idx = t; idx < kWgTile * 3; idx += kHelpers) {
    const int r = idx % kWgTile, c = idx / kWgTile;
    const float xf =
        base + r < N ? pts[(size_t)(3 * s + c) * N + base + r] : 0.0f;
    unsigned char* row = pe + r * 128;   // 64 rows of 128 bytes a warpgroup
    auto put = [&](int col, __nv_bfloat16 v) {
      *reinterpret_cast<__nv_bfloat16*>(
          row + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1))) = v;
    };
    put(c, __float2bfloat16_rn(xf));
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      float sn, cs;
      sincosf(ldexpf(xf, k), &sn, &cs);
      put(3 + 3 * k + c, __float2bfloat16_rn(sn));
      put(3 + 3 * kL + 3 * k + c, __float2bfloat16_rn(cs));
    }
    if (c == 0) put(kPE - 1, __float2bfloat16_rn(0.0f));
  }
}

// ------------------------------------------------------- int8 epilogue --
//
// An int8 layer ends in t = acc * A + B per output (per-channel f32 columns,
// the product rounded before B is added), then the code clamp(floor(t + .5),
// 0, 254) - 127 of the next layer's A operand. Written with FRND and F2I
// (conversion instructions: 16 results a clock an SM on this card, a quarter
// of FADD) the floor took a sixth of the first int8 kernel; here it is
// I2FP / FMUL / FADD / one FMNMX / PRMT, with every rounding point kept. The
// wrapper stores every requantised layer's A and B (and the addends of
// layers 5 and view: the w5p panel, vcon_scale) times 2^-8, so the kernel
// computes t' = t / 256 exactly (a power of two commutes with every
// rounding, and nothing here comes near the subnormal range): the clamp at 0
// is then the saturation of the add of .5 / 256, which costs nothing, where
// an FMNMX costs as much as a few FADDs (the two FMNMX of the clamp took
// over a quarter of the kernel), and the floor lands in the low byte of an
// add with a unit in the last place of 1 / 256.

// The s32 sum of an int8 product as f32, exactly (|v| <= 256 * 127 * 127 <
// 2^24). One I2FP: measured cheaper than the bits of 1.5 * 2^23 + v less
// 1.5 * 2^23 (an IADD and an FADD), which gives the same value for |v| <
// 2^22 (`scripts/torch_nerf_q_variants.py`, copy `magic_s32`).
__device__ __forceinline__ float s32_f32(int v) {
  return __int2float_rn(v);
}

// The code of t = 256 t' in the low byte (the other bytes are not zero): y =
// clamp(t' + 2^-9, 0, 254 / 256) (clamping before the floor is clamping after
// it: floor is monotone and the bounds are whole codes; the saturation takes
// a NaN to 0), then y + 2^15 +
// 129 / 256 rounded down, whose unit in the last place is 1 / 256, so it is
// 2^15 + (floor(256 y) + 129) / 256, and the low byte of its bits is
// floor(256 y) + 129 = floor(256 y) - 127 mod 256.
__device__ __forceinline__ uint32_t requant_byte(float t) {
  float y;   // t' + 2^-9, saturated to [0, 1] (FADD.SAT: no FMNMX)
  asm("add.rn.sat.f32 %0, %1, 0f3B000000;\n" : "=f"(y) : "f"(t));
  return __float_as_uint(__fadd_rd(fminf(y, 0.9921875f), 32768.50390625f));
}

// The low bytes of four words, b0 lowest.
__device__ __forceinline__ uint32_t pack_bytes(uint32_t b0, uint32_t b1,
                                               uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// The codes of NACC accumulators of a thread (128 or 64 outputs of 64 rays)
// as the NACC / 4 A registers `a` of the next int8 product (see the head of
// this file). `t_of(i, A, B)` is the value t of accumulator i given the
// per-channel A and B of its column; `cols` points at this thread's first
// column pair, as {A(2 p), A(2 p + 1), B(2 p), B(2 p + 1)}: the pair of n-tile
// c (8 outputs) is cols[4 c].
template <int NACC, class T>
__device__ __forceinline__ void wg_requant(uint32_t* a, const float4* cols,
                                           T t_of) {
#pragma unroll
  for (int m = 0; m < NACC / 8; ++m) {
    const float4 c0 = cols[8 * m], c1 = cols[8 * m + 4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 8 * m + 2 * r;
      a[2 * m + r] = pack_bytes(requant_byte(t_of(i, c0.x, c0.z)),
                                requant_byte(t_of(i + 1, c0.y, c0.w)),
                                requant_byte(t_of(i + 4, c1.x, c1.z)),
                                requant_byte(t_of(i + 5, c1.y, c1.w)));
    }
  }
}

// Queue the products of one eighth of an int8 layer (32 outputs, K = 256)
// into d: A from the 32 registers h, B from 32 rows of each of the two
// k-slabs [128 x 128] of a stage, the first at shared address `rows`.
__device__ __forceinline__ void wg_eighth_s8(int (&d)[16], uint32_t (&h)[32],
                                             uint32_t rows) {
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hp::wgmma_m64n32k32_s8(
        d, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2], h[4 * kk + 3],
        hp::desc_k128(rows + (kk / 4) * kSlab128Bytes) +
            (kk % 4) * hp::kDescKStep,
        kk);
  hp::wgmma_commit();
}

// One 256-wide int8 layer of K = 256 on the codes h, in place, in eighths of
// 32 outputs: t = acc * A + B, requantised. The panel arrives as two stages
// of a half (eighths 0..3, then 4..7). The eighths alternate between the
// two halves of `acc`, so that the products of one run while the epilogue of
// the one before does: the tensor cores never wait for an epilogue of this
// warpgroup. Blocks of 16 accumulators keep ptxas' register budget: with
// halves of 128 outputs it serialized the products, and quarters left no
// room for the epilogue's saturating add. `cols` as for wg_requant, the
// layer's 128 pairs.
__device__ __forceinline__ void wg_layer256_s8(int (&acc)[32],
                                               uint32_t (&h)[32], WgRing& ring,
                                               const float4* cols) {
  int (&b0)[16] = *reinterpret_cast<int (*)[16]>(acc);
  int (&b1)[16] = *reinterpret_cast<int (*)[16]>(acc + 16);
  constexpr uint32_t kRows32 = 32 * 128;   // 32 panel rows of a slab
  uint32_t out[28];
  const uint32_t s0 = ring.wait();
  wg_eighth_s8(b0, h, s0);
  wg_eighth_s8(b1, h, s0 + kRows32);
  const uint32_t first = ring.advance();
  uint32_t s1 = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int (&d)[16] = e % 2 ? b1 : b0;
    if (e < 7) hp::wgmma_wait<1>();
    else hp::wgmma_wait<0>();
    hp::keep(d);
    if (e == 3) ring.release(first);   // eighths 0..3 read the first stage
    if (e == 7) {
      hp::keep(h);
      ring.release(ring.advance());
    }
    // the last eighth's codes go straight into h: its products are done
    wg_requant<16>(e < 7 ? out + 4 * e : h + 28, cols + 16 * e,
                   [&](int i, float ca, float cb) {
                     return __fadd_rn(__fmul_rn(s32_f32(d[i]), ca), cb);
                   });
    if (e + 2 < 8) {
      if (e + 2 == 4) s1 = ring.wait();
      wg_eighth_s8(d, h, (e + 2 < 4 ? s0 : s1) + ((e + 2) % 4) * kRows32);
    }
  }
#pragma unroll
  for (int i = 0; i < 28; ++i) h[i] = out[i];
}

}  // namespace pn
