// K1: batched logistic-regression log-density and gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel klara_tpu/ops/logreg.py: fused_logreg_value_grad
// -> _fused_core (the pl.pallas_call) -> _kernel, plus the wrapper's epilogue.
// For every chain c, with v = X^T y precomputed once by the caller:
//
//   value_c = p_c.v - sum_n softplus(x_n.p_c) - |p_c|^2 / (2 lam) - D/2 log(2 pi lam)
//   grad_c  = v - sigmoid(X p_c)^T X - p_c / lam
//
// What bounds it on an H100.  One evaluation at the main path's shape (C=16384
// chains, D=100, N=1024 data rows) is two products of 2*C*N*D = 3.36 GFLOP
// each.  At f32-grade accuracy on the tensor cores each product takes three
// TF32 passes (hi.hi + hi.lo + lo.hi): 3 x 6.71 GFLOP = 20.1 GFLOP, 0.041 ms
// at the card's 495 TFLOP/s dense TF32 rate.  Below that lie the elementwise
// work (16.8 M logits, each one exp, one log1p, one reciprocal and two TF32
// splits: about 0.02 ms of FP32 and special-function instructions) and the
// compulsory traffic (P in, gradient out, X and the values: 13.6 MB, 0.004 ms
// at 3.35 TB/s).  So the kernel is bound by operations, and the design's job
// is to keep the tensor cores fed: the logits must never reach device memory,
// and X, which every block needs in full, must arrive without the arithmetic
// waiting for it.  What the tensor cores read they read from shared memory:
// a tile of 32 data rows costs a block about 156 KB of operand reads and
// 53 KB of copies into the rings, against 128 bytes a clock, which is as
// near as the arithmetic itself.
//
// Design.  The function is attention with K = V = X and no running maximum:
// Z = P X^T, an elementwise map, then G += sigmoid(Z) X.
//   * Both products are wgmma.mma_async, TF32 operands, f32 accumulators.
//     Every operand is split once into hi = tf32(a), rounded to nearest by
//     cvt.rna (the tensor core would truncate), and lo = a - hi; the passes
//     are lo.hi, hi.lo and hi.hi.  PASSES = 1 keeps hi.hi only (about three
//     decimal digits).
//   * A block is two warpgroups (256 threads, so that a thread may hold up to
//     255 registers) and owns 64 chains.  Their P rows, split into hi and lo,
//     sit in shared memory for the whole loop in the core-matrix layout wgmma
//     reads (8 rows x 16 bytes, K-major, no swizzle).  The warpgroups take
//     the even and the odd data tiles; each keeps a 64 x DP gradient
//     accumulator in registers, and at the end the second hands its sums to
//     the first through shared memory.  16384 chains are 256 blocks (two
//     waves on 132 SMs), 4096 chains 64 blocks.  A 128-chain block whose
//     warpgroups took different chains and the same tiles (one wave at 16384
//     chains, half the traffic from L2) was timed too and was no faster at
//     16384 chains and twice as slow at 4096, so it is not kept.
//   * The logits never leave registers.  The first product's accumulator
//     fragment holds columns (2q, 2q+1) of each 8-column block for the thread
//     with id q in its quad; the second product's A fragment wants columns
//     (q, q+4).  The sum over data rows does not care in which order it runs,
//     so the transposed copy of X is stored with the rows of each 8-block in
//     the order 0,2,4,6,1,3,5,7 and the accumulator registers are handed on
//     as they are.  One exp(-|z|) serves softplus and sigmoid, on the
//     special-function unit (ex2, lg2, rcp).
//   * A warpgroup alternates between the tensor cores (a tile's logits, then
//     its gradient product) and the other pipes (the elementwise map, the
//     FP32 sums); the block's two warpgroups run out of step with each other,
//     so that one's products overlap the other's elementwise work.
//   * The tensor core adds into its accumulator by truncation, which biases
//     long chains of products (see the kernel): chains are kept short and
//     summed on the FP32 cores.
//   * The log-likelihood is summed row by row, y_n z_n - softplus(z_n), from
//     the kernel's own logits and the labels y (prepare_x(X, y) pads them):
//     the terms are small where the model fits, so the sum keeps its digits
//     and what the tensor cores lose of a logit enters only through
//     y_n - sigmoid(z_n).  Taking the first term as p.v instead would leave
//     two large sums' rounding standing against each other.
//   * X is constant per target and is prepared once, outside the kernel
//     (ops/logreg.py: prepare_x), as a sequence of tile images: for each tile
//     of 32 data rows the bytes of [X hi | X lo | X^T hi | X^T lo] exactly as
//     shared memory holds them (D padded with zeros to DP, a multiple of 8;
//     TF32 wgmma takes K-major operands only, hence the transposed copy).
//     They stream through rings of slots, one cp.async.bulk per slot with
//     completion on an mbarrier.  Each warpgroup has rings of its own, one
//     for X (read by the first product) and one for X^T (read by the
//     second): its first thread refills a slot as soon as wgmma's wait says
//     the warpgroup's reads are done, and the same warpgroup waits for that
//     copy later, so a slot's barrier is always in the phase its reader
//     expects and no "empty" barrier is needed.  X^T gets the deeper ring
//     (its slot is busy to the end of a tile; X's is free after the logits).
//     No tensor map is needed, so nothing is encoded per call.
//   * Ragged edges: chains >= C are zero rows whose results are not stored,
//     columns >= D are zeros in P and in the images, data rows >= N are zeros
//     in the images and masked after the elementwise map (they add nothing to
//     either sum, so no n_pad*log(2) correction is needed).  1 <= D <= 128;
//     DP is 104 up to D = 104 and 128 above.  Wider D takes the wide form
//     (below), which tiles D into 128-column tiles of the gradient.
//
// C interface for ctypes: returns the cudaError_t of the launch; the launch
// goes on the caller's stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 32;        // data rows per tile image
constexpr int kWarpgroup = 128;
constexpr int kThreads = 2 * kWarpgroup;
constexpr int kMaxBarriers = 16;  // 8 bytes each, in kBarrierBytes
constexpr int kBarrierBytes = 128;
constexpr int kSmemLimit = 232448;  // 227 KB a block may use on sm_90
constexpr int kMaxD = 128;

// ---------------------------------------------------------------- PTX pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier has left the phase of parity `parity`.  A barrier
// that does not complete within two seconds is a bug in this file: trap
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 255) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      if (now - t0 > 2000000000ull) __trap();
    }
  }
}

// One contiguous copy global -> shared, completion counted in bytes on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving uses of wgmma's registers across its
// asynchronous start and wait.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes between core matrices along K,
// `sbo` bytes between 8-row groups.  Adding (bytes >> 4) to a descriptor
// moves its start address.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x 32, f32) (+)= A (64 x 8, shared memory) . B (32 x 8, shared memory)^T, TF32
__device__ __forceinline__ void wgmma_m64n32k8_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 104, f32) (+)= A (64 x 8, registers) . B (104 x 8, shared memory)^T, TF32
__device__ __forceinline__ void wgmma_m64n104k8_rs(float (&d)[52], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      " %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      " %47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 8, registers) . B (128 x 8, shared memory)^T, TF32
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      " %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      " %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      " %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

template <int kDP>
__device__ __forceinline__ void wgmma_grad(float (&d)[kDP / 2], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc_b,
                                           int accumulate) {
  if constexpr (kDP == 104) {
    wgmma_m64n104k8_rs(d, a0, a1, a2, a3, desc_b, accumulate);
  } else {
    wgmma_m64n128k8_rs(d, a0, a1, a2, a3, desc_b, accumulate);
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(1 + e) and sigmoid(z) = 1 / (1 + e) or e / (1 + e) from one e = exp(-|z|):
// softplus(z) = max(z, 0) + log(1 + e) and sigmoid in their stable forms.  On
// the special-function unit: three instructions a logit (ex2, lg2, rcp), each
// good to about 2^-22, where the library's expf, log1pf and division cost
// several times the two products' instruction slots.  1 + e lies in [1, 2], so the
// logarithm's absolute error stays near 1e-7 a term.
__device__ __forceinline__ void log1pexp_sigmoid(float z, float& l, float& s) {
  const float e = ex2_approx(-1.4426950408889634f * fabsf(z));
  const float d = 1.0f + e;
  const float r = rcp_approx(d);
  l = lg2_approx(d) * 0.6931471805599453f;
  s = z >= 0.0f ? r : e * r;
}

// ------------------------------------------------------------------- kernel
// Shared memory (bytes):
//   [0, 128)                the rings' full mbarriers, one a slot
//   P                       hi then lo, each 64 x kDP TF32 in core-matrix order:
//        byte ((d / 4) * 8 + row / 8) * 128 + (row % 8) * 16 + (d % 4) * 4
//   X rings                 2 warpgroups x kXSlots x [X hi | X lo] of a tile
//   X^T rings               2 warpgroups x kXtSlots x [X^T hi | X^T lo] of a tile,
//                           each section kDP x 32 TF32:
//        X   (rows n, K = d): ((d / 4) * 4 + n / 8) * 128 + (n % 8) * 16 + (d % 4) * 4
//        X^T (rows d, K = n'): ((n' / 4) * (kDP / 8) + d / 8) * 128 + (d % 8) * 16 + (n' % 4) * 4
//      with n' the position of row n in the permuted order (see the note above).
template <int kDP, int kPasses, int kXSlots, int kXtSlots>
__global__ void __launch_bounds__(kThreads, 1)
logreg_value_grad_kernel(const float* __restrict__ P, const float* __restrict__ Ximg,
                         const float* __restrict__ Y, const float* __restrict__ v,
                         float* __restrict__ value,
                         float* __restrict__ grad, int C, int N, int D, float inv_lam,
                         float log_norm) {
  constexpr int kSec = kDP * kTileN * 4;  // bytes of one image section
  constexpr int kSlotBytes = 2 * kSec;    // hi and lo of a tile's X (or X^T)
  constexpr int kCopyBytes = kPasses == 3 ? 2 * kSec : kSec;  // one pass needs no lo
  constexpr int kPBytes = 64 * kDP * 4;   // one warpgroup's P hi (or lo)
  constexpr int kKD = kDP / 8;            // k-steps of the first product
  constexpr int kKN = kTileN / 8;         // k-steps of the second product
  constexpr int kAcc = kDP / 2;           // gradient accumulator registers

  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(2 * (kXSlots + kXtSlots) <= kMaxBarriers, "one mbarrier a slot");
  // mbarriers: a slot of an X ring is full, of an X^T ring; slot s of
  // warpgroup w is number w * slots + s of its kind
  const uint32_t x_full = smem_u32(smem), xt_full = x_full + 8 * 2 * kXSlots;
  unsigned char* Psm = smem + kBarrierBytes;
  unsigned char* x_ring = Psm + 2 * kPBytes;
  unsigned char* xt_ring = x_ring + 2 * kXSlots * kSlotBytes;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * 64;
  const int T = (N + kTileN - 1) / kTileN;

  // The warpgroup's index, broadcast so that the compiler can keep what
  // follows from it (tile, slot, descriptors) in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // Warpgroup w takes the tiles 2 i + w, i = 0, 1, ...; its i-th tile goes
  // through slot i % slots of its own rings, and phase i / slots of that
  // slot's barrier.  Only w reads the slot, and w's first thread refills it
  // once the products that read it are done (wgmma's wait covers the whole
  // warpgroup's reads): whoever waits on a slot has seen its previous phase
  // complete, so the parity it waits for names the copy it means.
  const bool leader = (tid & 127) == 0;
  auto load_x = [&](int w, int i) {
    const int s = w * kXSlots + i % kXSlots;
    mbar_expect_tx(x_full + 8 * s, kCopyBytes);
    bulk_copy_g2s(smem_u32(x_ring + s * kSlotBytes),
                  Ximg + (size_t)(2 * i + w) * (2 * kSlotBytes / 4), kCopyBytes, x_full + 8 * s);
  };
  auto load_xt = [&](int w, int i) {
    const int s = w * kXtSlots + i % kXtSlots;
    mbar_expect_tx(xt_full + 8 * s, kCopyBytes);
    bulk_copy_g2s(smem_u32(xt_ring + s * kSlotBytes),
                  Ximg + (size_t)(2 * i + w) * (2 * kSlotBytes / 4) + kSlotBytes / 4, kCopyBytes,
                  xt_full + 8 * s);
  };
  if (tid == 0) {
    for (int s = 0; s < 2 * kXSlots; ++s) mbar_init(x_full + 8 * s, 1);  // the expect_tx
    for (int s = 0; s < 2 * kXtSlots; ++s) mbar_init(xt_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_async();
    // Start filling both warpgroups' rings before anything else; the
    // __syncthreads() below orders these first fills before every wait.
    for (int w = 0; w < 2; ++w) {
      for (int i = 0; i < kXSlots && 2 * i + w < T; ++i) load_x(w, i);
      for (int i = 0; i < kXtSlots && 2 * i + w < T; ++i) load_xt(w, i);
    }
  }

  // Stage the block's P rows once, split into hi and lo.  A thread takes one
  // 16-byte chunk (4 columns of a row) at a time, in the order shared memory
  // holds them, so that a warp's stores fill whole core matrices without bank
  // conflicts; all of its loads are in flight together.
  {
    constexpr int kChunks = 64 * (kDP / 4), kBatch = 13;
    const bool vec = (D & 3) == 0;
#pragma unroll 1
    for (int base = tid; base < kChunks; base += kBatch * kThreads) {
      float4 p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;  // (d / 4) * 64 + row
        const int r = idx & 63, d = (idx >> 6) * 4;
        const float* src = P + (size_t)(c0 + r) * D + d;
        p[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (idx < kChunks && c0 + r < C) {
          if (vec && d + 3 < D) {
            p[u] = *reinterpret_cast<const float4*>(src);
          } else {
            if (d < D) p[u].x = src[0];
            if (d + 1 < D) p[u].y = src[1];
            if (d + 2 < D) p[u].z = src[2];
            if (d + 3 < D) p[u].w = src[3];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < kChunks) {
          unsigned char* dst = Psm + idx * 16;
          const uint4 hi = make_uint4(tf32_rna(p[u].x), tf32_rna(p[u].y), tf32_rna(p[u].z),
                                      tf32_rna(p[u].w));
          *reinterpret_cast<uint4*>(dst) = hi;
          if (kPasses == 3)
            *reinterpret_cast<uint4*>(dst + kPBytes) =
                make_uint4(tf32_rna(p[u].x - __uint_as_float(hi.x)),
                           tf32_rna(p[u].y - __uint_as_float(hi.y)),
                           tf32_rna(p[u].z - __uint_as_float(hi.z)),
                           tf32_rna(p[u].w - __uint_as_float(hi.w)));
        }
      }
    }
  }
  fence_proxy_async();  // P, before wgmma reads it
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = ((tid & 127) >> 5) * 16 + g;  // this thread's rows: row0 and row0 + 8
  const uint64_t dp_hi = make_desc(smem_u32(Psm), 8 * 128, 128);
  const uint64_t dp_lo = make_desc(smem_u32(Psm) + kPBytes, 8 * 128, 128);
  float G[kAcc], Gt[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) G[i] = 0.0f;
  // sums over this thread's data rows of softplus(z) - y z
  float sp0 = 0.0f, sp1 = 0.0f;
  uint32_t Sh[kTileN / 2], Sl[kTileN / 2];

  // The tensor core adds into its accumulator by truncation: every product
  // of a chain loses up to one unit in the last place of the running sum,
  // always toward zero.  Over the 39 products of a logit that biases z by
  // ~1e-6 |z|, and the value, which sums softplus over a thousand rows, by
  // ~1e-5 of its size; over the hundreds of products of a run of tiles it
  // biases the gradient as much.  So chains are kept short and are summed on
  // the FP32 cores, which round to nearest: the logits' hi.hi products go to
  // kZ accumulators of a few k-steps each and the two small passes to one of
  // their own (whose truncation is relative to its small size), and each
  // tile's gradient product gets a fresh accumulator Gt that is added to G.
  constexpr int kZ = 3;
  constexpr int kZn = kTileN / 2;
  for (int i_own = 0, t = wg; t < T; ++i_own, t += 2) {
    const int sx = wg * kXSlots + i_own % kXSlots;
    const int sxt = wg * kXtSlots + i_own % kXtSlots;
    // this thread's labels: data rows 8 j + 2 q and 8 j + 2 q + 1 of the tile
    float2 y2[kKN];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
      y2[j] = *reinterpret_cast<const float2*>(Y + t * kTileN + 8 * j + 2 * q);

    // Z = P X^T for the block's 64 chains and the tile's 32 rows.
    float Zs[kZn], Zb[kZ][kZn];
    mbar_wait(x_full + 8 * sx, (i_own / kXSlots) & 1);
    {
      const uint32_t st = smem_u32(x_ring + sx * kSlotBytes);
      const uint64_t dx_hi = make_desc(st, 4 * 128, 128);
      const uint64_t dx_lo = make_desc(st + kSec, 4 * 128, 128);
      wgmma_fence();
      if (kPasses == 3) {
#pragma unroll
        for (int k = 0; k < kKD; ++k)
          wgmma_m64n32k8_ss(Zs, dp_lo + k * (2 * 8 * 128 / 16), dx_hi + k * (2 * 4 * 128 / 16),
                            k > 0);
#pragma unroll
        for (int k = 0; k < kKD; ++k)
          wgmma_m64n32k8_ss(Zs, dp_hi + k * (2 * 8 * 128 / 16), dx_lo + k * (2 * 4 * 128 / 16), 1);
      }
#pragma unroll
      for (int k = 0; k < kKD; ++k) {
        constexpr int kPer = (kKD + kZ - 1) / kZ;  // k-steps a chain
        wgmma_m64n32k8_ss(Zb[k / kPer], dp_hi + k * (2 * 8 * 128 / 16),
                          dx_hi + k * (2 * 4 * 128 / 16), k % kPer > 0);
      }
      wgmma_commit();
      // While the products run, the leader refills the X^T slot that this
      // warpgroup's last gradient product is done with.
      if (leader && i_own >= 1 && t - 2 + 2 * kXtSlots < T) load_xt(wg, i_own - 1 + kXtSlots);
      wgmma_wait_all();
      // The logits are done with X of this tile: refill its slot.
      if (leader && t + 2 * kXSlots < T) load_x(wg, i_own + kXSlots);
      if (kPasses == 3) fence_regs(Zs);
#pragma unroll
      for (int c = 0; c < kZ; ++c) fence_regs(Zb[c]);
    }

    // The elementwise map and the gradient product Gt = sigmoid(Z) X, in two
    // halves of two k-steps each, so that the first half's products run
    // while the second half's map is computed.  Register 4 j + i of the
    // logits is row row0 + 8 (i / 2), data row 8 j + 2 q + (i % 2) of the tile,
    // and the product's A fragment (row0, k = q), (row0 + 8, q), (row0, q + 4),
    // (row0 + 8, q + 4) of k-step j is registers 4 j + 0, 2, 1, 3 as they are.
    const int n_base = t * kTileN + 2 * q;
    const bool ragged = (t + 1) * kTileN > N;
    const uint32_t st = smem_u32(xt_ring + sxt * kSlotBytes);
    const uint64_t dxt_hi = make_desc(st, kKD * 128, 128);
    const uint64_t dxt_lo = make_desc(st + kSec, kKD * 128, 128);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = half * (kZn / 2); i < (half + 1) * (kZn / 2); ++i) {
        float z = Zb[0][i];
#pragma unroll
        for (int c = 1; c < kZ; ++c) z += Zb[c][i];
        if (kPasses == 3) z += Zs[i];
        float l, sg;
        log1pexp_sigmoid(z, l, sg);
        // max(z, 0) - y z is exact for a label of 0 or 1, and for a row the
        // model fits both it and log(1 + e) are small: the sum keeps its digits
        float sp = fmaxf(z, 0.0f);
        sp = fmaf(-((i & 1) ? y2[i >> 2].y : y2[i >> 2].x), z, sp);
        sp += l;
        if (ragged && n_base + 8 * (i >> 2) + (i & 1) >= N) sp = sg = 0.0f;
        if (i & 2) sp1 += sp; else sp0 += sp;
        Sh[i] = tf32_rna(sg);
        if (kPasses == 3) Sl[i] = tf32_rna(sg - __uint_as_float(Sh[i]));
      }
      if (half == 0) mbar_wait(xt_full + 8 * sxt, (i_own / kXtSlots) & 1);
      wgmma_fence();
      if (kPasses == 3) {
#pragma unroll
        for (int j = half * (kKN / 2); j < (half + 1) * (kKN / 2); ++j)
          wgmma_grad<kDP>(Gt, Sl[4 * j], Sl[4 * j + 2], Sl[4 * j + 1], Sl[4 * j + 3],
                          dxt_hi + j * (2 * kKD * 128 / 16), j > 0);
#pragma unroll
        for (int j = half * (kKN / 2); j < (half + 1) * (kKN / 2); ++j)
          wgmma_grad<kDP>(Gt, Sh[4 * j], Sh[4 * j + 2], Sh[4 * j + 1], Sh[4 * j + 3],
                          dxt_lo + j * (2 * kKD * 128 / 16), 1);
      }
#pragma unroll
      for (int j = half * (kKN / 2); j < (half + 1) * (kKN / 2); ++j)
        wgmma_grad<kDP>(Gt, Sh[4 * j], Sh[4 * j + 2], Sh[4 * j + 1], Sh[4 * j + 3],
                        dxt_hi + j * (2 * kKD * 128 / 16), kPasses == 3 || j > 0);
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(Gt);
    fence_regs(Sh);  // the A fragments stay live until the products have read them
    if (kPasses == 3) fence_regs(Sl);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) G[i] += Gt[i];
  }

  {
    // The second warpgroup hands its partial sums to the first through the
    // (now idle) rings.
    float* xch = reinterpret_cast<float*>(x_ring);
    const int wt = tid & 127;
    __syncthreads();  // every tile is consumed
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) xch[i * kWarpgroup + wt] = G[i];
      xch[kAcc * kWarpgroup + wt] = sp0;
      xch[(kAcc + 1) * kWarpgroup + wt] = sp1;
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) G[i] += xch[i * kWarpgroup + wt];
    sp0 += xch[kAcc * kWarpgroup + wt];
    sp1 += xch[(kAcc + 1) * kWarpgroup + wt];
  }

  // Epilogue.  G[4 j + i] is row row0 + 8 (i / 2), column 8 j + 2 q + (i % 2).
  float pp0 = 0.0f, pp1 = 0.0f;
  const int ca = c0 + row0, cb = ca + 8;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int d = 8 * (i >> 2) + 2 * q + (i & 1);
    const int c = (i & 2) ? cb : ca;
    if (d < D && c < C) {
      const float p = P[(size_t)c * D + d];
      grad[(size_t)c * D + d] = v[d] - G[i] - p * inv_lam;
      if (i & 2) pp1 = fmaf(p, p, pp1); else pp0 = fmaf(p, p, pp0);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sp0 += __shfl_xor_sync(0xffffffffu, sp0, off);
    sp1 += __shfl_xor_sync(0xffffffffu, sp1, off);
    pp0 += __shfl_xor_sync(0xffffffffu, pp0, off);
    pp1 += __shfl_xor_sync(0xffffffffu, pp1, off);
  }
  // sp holds -sum_n (y_n z_n - softplus(z_n)), the log-likelihood summed row
  // by row from the kernel's own logits.
  if (q == 0) {
    if (ca < C) value[ca] = -sp0 - 0.5f * pp0 * inv_lam - log_norm;
    if (cb < C) value[cb] = -sp1 - 0.5f * pp1 * inv_lam - log_norm;
  }
}

// ------------------------------------------------------- the wide form
// For D > kMaxD the block's P rows and its gradient accumulator no longer fit
// beside the rings, so the wide form tiles D instead: block (x, y) owns chains
// 64 x .. 64 x + 63 and gradient columns 128 y .. 128 y + 127 (one 128-column
// tile of D), and for each tile of 32 data rows it
//   * computes the full logits Z = P X^T (64 x 32) over D in chunks of 32
//     columns, both operands staged in shared memory a chunk at a time;
//   * maps them (the same row-by-row softplus(z) - y z as above, and sigmoid),
//     masking data rows >= N;
//   * adds sigmoid(Z) X[:, tile] (64 x 128) into its accumulator.
// The logits are recomputed by each of the ceil(D / 128) column tiles (a
// wider accumulator would not fit in registers), so the form does
// (D / 128 + 1) / 2 times the operations of the two products; only the
// blocks of column tile 0 write the values.  Both products run on the FP32
// cores (FMA, f32 accumulators): at kTf32 every operand is rounded to TF32
// first, the counterpart of passes = 1.  256 threads: thread (ty, tx) =
// (tid / 8, tid % 8) holds chains ty and ty + 32, logits of data rows
// tx + 8 i (i < 4) and gradient columns 32 g + 4 tx + e (g, e < 4).  The
// products read shared memory 16 bytes a thread (rows padded to 36 floats,
// so that the 8 rows a warp reads at once start in 8 different banks): a
// quarter of the load instructions of scalar reads.  What bounds it:
// the FP32 cores, 67 TFLOP/s; at C = 16384, D = 256, N = 1024 its 26 GFLOP
// (the logits twice) need 0.4 ms.  It serves the widths the tensor-core form
// cannot hold; no benchmarked path is that wide.
constexpr int kWideChains = 64, kWideRows = 32, kWideK = 32, kWideCols = 128;

template <bool kTf32>
__device__ __forceinline__ float wide_operand(float x) {
  return kTf32 ? __uint_as_float(tf32_rna(x)) : x;
}

template <bool kTf32>
__global__ void __launch_bounds__(kThreads)
logreg_value_grad_wide_kernel(const float* __restrict__ P, const float* __restrict__ X,
                              const float* __restrict__ Y, const float* __restrict__ v,
                              float* __restrict__ value, float* __restrict__ grad, int C, int N,
                              int D, float inv_lam, float log_norm) {
  constexpr int kPad = 4;  // keeps rows 16-byte aligned
  __shared__ __align__(16) float Ps[kWideChains][kWideK + kPad];   // P, a chunk of 32 columns
  __shared__ __align__(16) float Xs[kWideRows][kWideK + kPad];     // X, the tile's rows, the same chunk
  __shared__ __align__(16) float Ss[kWideChains][kWideRows + kPad];  // sigmoid(Z) of the tile
  __shared__ __align__(16) float Xj[kWideRows][kWideCols];  // X, the tile's rows, this block's columns

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int c0 = blockIdx.x * kWideChains, j0 = blockIdx.y * kWideCols;
  float G[2][kWideCols / 8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < kWideCols / 8; ++m) G[a][m] = 0.0f;
  float sp[2] = {0.0f, 0.0f};  // sums of softplus(z) - y z over this thread's rows

  for (int n0 = 0; n0 < N; n0 += kWideRows) {
    float z[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) z[a][i] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += kWideK) {
      // neighbouring threads read neighbouring columns of one row
      for (int idx = tid; idx < kWideChains * kWideK; idx += kThreads) {
        const int r = idx / kWideK, k = idx % kWideK, c = c0 + r, d = k0 + k;
        Ps[r][k] = (c < C && d < D) ? wide_operand<kTf32>(P[(size_t)c * D + d]) : 0.0f;
      }
      for (int idx = tid; idx < kWideRows * kWideK; idx += kThreads) {
        const int r = idx / kWideK, k = idx % kWideK, n = n0 + r, d = k0 + k;
        Xs[r][k] = (n < N && d < D) ? wide_operand<kTf32>(X[(size_t)n * D + d]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kWideK; k += 4) {
        const float4 p0 = *reinterpret_cast<const float4*>(&Ps[ty][k]);
        const float4 p1 = *reinterpret_cast<const float4*>(&Ps[ty + 32][k]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(&Xs[tx + 8 * i][k]);
          z[0][i] = fmaf(p0.w, x.w, fmaf(p0.z, x.z, fmaf(p0.y, x.y, fmaf(p0.x, x.x, z[0][i]))));
          z[1][i] = fmaf(p1.w, x.w, fmaf(p1.z, x.z, fmaf(p1.y, x.y, fmaf(p1.x, x.x, z[1][i]))));
        }
      }
      __syncthreads();  // the chunk is read before the next overwrites it
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tx + 8 * i;
        float s = 0.0f;
        if (n < N) {
          const float e = expf(-fabsf(z[a][i]));
          const float r = 1.0f / (1.0f + e);
          s = z[a][i] >= 0.0f ? r : e * r;
          // max(z, 0) - y z is exact for a label of 0 or 1 (see above)
          sp[a] += fmaf(-Y[n], z[a][i], fmaxf(z[a][i], 0.0f)) + log1pf(e);
        }
        Ss[ty + 32 * a][tx + 8 * i] = wide_operand<kTf32>(s);
      }
    for (int idx = tid; idx < kWideRows * kWideCols; idx += kThreads) {
      const int r = idx / kWideCols, j = idx % kWideCols, n = n0 + r, d = j0 + j;
      Xj[r][j] = (n < N && d < D) ? wide_operand<kTf32>(X[(size_t)n * D + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int n = 0; n < kWideRows; n += 4) {
      const float4 s0 = *reinterpret_cast<const float4*>(&Ss[ty][n]);
      const float4 s1 = *reinterpret_cast<const float4*>(&Ss[ty + 32][n]);
      const float a0[4] = {s0.x, s0.y, s0.z, s0.w}, a1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 x = *reinterpret_cast<const float4*>(&Xj[n + r][32 * g + 4 * tx]);
          G[0][4 * g] = fmaf(a0[r], x.x, G[0][4 * g]);
          G[0][4 * g + 1] = fmaf(a0[r], x.y, G[0][4 * g + 1]);
          G[0][4 * g + 2] = fmaf(a0[r], x.z, G[0][4 * g + 2]);
          G[0][4 * g + 3] = fmaf(a0[r], x.w, G[0][4 * g + 3]);
          G[1][4 * g] = fmaf(a1[r], x.x, G[1][4 * g]);
          G[1][4 * g + 1] = fmaf(a1[r], x.y, G[1][4 * g + 1]);
          G[1][4 * g + 2] = fmaf(a1[r], x.z, G[1][4 * g + 2]);
          G[1][4 * g + 3] = fmaf(a1[r], x.w, G[1][4 * g + 3]);
        }
    }
    __syncthreads();  // Ss and Xj are read before the next tile overwrites them
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int c = c0 + ty + 32 * a;
    if (c < C) {
#pragma unroll
      for (int m = 0; m < kWideCols / 8; ++m) {
        const int d = j0 + 32 * (m >> 2) + 4 * tx + (m & 3);
        if (d < D) grad[(size_t)c * D + d] = v[d] - G[a][m] - P[(size_t)c * D + d] * inv_lam;
      }
    }
  }
  if (blockIdx.y != 0) return;
  // the values: the 8 threads of a chain (consecutive lanes) sum their rows'
  // terms and the chain's |p|^2
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int c = c0 + ty + 32 * a;
    float pp = 0.0f;
    if (c < C)
      for (int d = tx; d < D; d += 8) pp = fmaf(P[(size_t)c * D + d], P[(size_t)c * D + d], pp);
    float s = sp[a];
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      pp += __shfl_xor_sync(0xffffffffu, pp, off);
    }
    if (tx == 0 && c < C) value[c] = -s - 0.5f * pp * inv_lam - log_norm;
  }
}

// ---------------------------------------------------------------------- host
// Slots (of kDP x 32 x 2 TF32 each) that one warpgroup's two rings may hold
// beside the block's P rows: 3 at kDP = 104, 2 at 128.
template <int kDP>
constexpr int slots_that_fit() {
  int n = (kSmemLimit - kBarrierBytes - 2 * 64 * kDP * 4) / (2 * 2 * kDP * kTileN * 4);
  return n > kMaxBarriers / 2 ? kMaxBarriers / 2 : n;
}

template <int kDP, int kPasses>
cudaError_t launch(const float* P, const float* Ximg, const float* Y, const float* v,
                   float* value, float* grad, int C, int N, int D, float inv_lam,
                   float log_norm, cudaStream_t stream) {
  constexpr int kSlots = slots_that_fit<kDP>();
  static_assert(kSlots >= 2, "a warpgroup needs a slot of each ring");
  // X's slot is free again right after a tile's logits, X^T's only at the
  // tile's end: X^T gets what is left over one slot of X
  constexpr int kXSlots = 1, kXtSlots = kSlots - 1;
  constexpr int kSmem = kBarrierBytes + 2 * 64 * kDP * 4 + 2 * kSlots * 2 * kDP * kTileN * 4;
  auto kernel = logreg_value_grad_kernel<kDP, kPasses, kXSlots, kXtSlots>;
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<(C + 63) / 64, kThreads, kSmem, stream>>>(P, Ximg, Y, v, value, grad, C, N, D,
                                                     inv_lam, log_norm);
  return cudaGetLastError();
}

}  // namespace

// Ximg: the tile images of ops/logreg.py: prepare_x for this DP (104 or 128).
// Y: the labels, zero-padded to a whole number of tiles.
extern "C" int klara_logreg_value_grad_tf32(const float* P, const float* Ximg, const float* Y,
                                             const float* v, float* value, float* grad, int C,
                                             int N, int D, int DP, int passes, float inv_lam,
                                             float log_norm, void* stream) {
  if (Y == nullptr || C <= 0 || N <= 0 || D <= 0 || D > kMaxD || D > DP || (DP != 104 && DP != 128) ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KLARA_LAUNCH(DP_, PASSES_) \
  return (int)launch<DP_, PASSES_>(P, Ximg, Y, v, value, grad, C, N, D, inv_lam, log_norm, st)
  if (DP == 104) {
    if (passes == 3) KLARA_LAUNCH(104, 3);
    KLARA_LAUNCH(104, 1);
  }
  if (passes == 3) KLARA_LAUNCH(128, 3);
  KLARA_LAUNCH(128, 1);
#undef KLARA_LAUNCH
}

// The wide form, any D: X is (N, D) row-major as the caller holds it, Y the
// labels (at least N of them).  passes = 3: f32 products; 1: TF32 operands.
extern "C" int klara_logreg_value_grad_wide(const float* P, const float* X, const float* Y,
                                             const float* v, float* value, float* grad, int C,
                                             int N, int D, int passes, float inv_lam,
                                             float log_norm, void* stream) {
  if (Y == nullptr || C <= 0 || N <= 0 || D <= 0 || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((C + kWideChains - 1) / kWideChains, (D + kWideCols - 1) / kWideCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    logreg_value_grad_wide_kernel<false><<<blocks, kThreads, 0, st>>>(P, X, Y, v, value, grad, C,
                                                                     N, D, inv_lam, log_norm);
  else
    logreg_value_grad_wide_kernel<true><<<blocks, kThreads, 0, st>>>(P, X, Y, v, value, grad, C,
                                                                    N, D, inv_lam, log_norm);
  return (int)cudaGetLastError();
}
