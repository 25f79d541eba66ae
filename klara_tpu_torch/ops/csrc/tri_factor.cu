// K3: the two products of a batch with a lower-triangular factor, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.  It was
// added for the port's evaluations through a factor (core/target.py:
// through_factor, which the LGCP and whitened targets share), where at
// D = 4096 the two products were three quarters of the card's busy time.  For a
// (C, D) f32 batch A and the f32 factor L (lower-triangular, D x D):
//
//   forward   out[c, i] = shift[i] + sum_{j <= i} A[c, j] L[i, j]    (x = shift + A L^T)
//   gradient  out[c, j] = sum_{i >= j} A[c, i] L[i, j] - y[c, j]     (A L - y)
//
// the shift and y optional, in the epilogue.
//
// What bounds it on an H100.  At f32 grade on the tensor cores a product takes
// three TF32 passes (lo.hi + hi.lo + hi.hi, each operand split into
// hi = tf32(a), rounded to nearest by cvt.rna, and lo = tf32(a - hi)).  Over
// the factor's triangle, in 128-column tiles, that is 3 x 2 C 128^2 T(T+1)/2
// operations with T = D / 128: at C = 1024, D = 4096, 53.2 GFLOP, 0.1075 ms at
// the card's 495 TFLOP/s dense TF32 rate.  The compulsory traffic (the
// triangle's hi and lo images, 69 MB; the batch in and out, 34 MB) takes 0.03 ms
// at 3.35 TB/s.  So the kernel is bound by operations, and the design's job is
// to keep the tensor cores fed from L2: a 128 x 128 output tile reads 48 KB a
// chunk of 32 along K (the batch's rows 16 KB, the factor's hi and lo 32 KB) for
// 3.1 MFLOP, ~7.5 TB/s of L2 reads at the full rate across the card, which is
// above what its L2 serves.  That, and not the tensor cores, is the likely
// limit; tiles of 128 x 128 are the largest whose accumulators fit.
//
// Design.
//   * wgmma.mma_async, TF32 operands, f32 accumulators, m64n128k8 with A from
//     registers.  A block is two warpgroups (64 rows each of a 128 x 128
//     output tile).  The batch operand is split
//     in registers as it arrives: each thread loads its own rows straight from
//     global memory into registers (16-byte loads), one chunk ahead of the
//     products.  The K order inside a chunk is permuted so that a thread's A
//     fragment for the chunk's four k-steps is 8 contiguous floats of each of
//     its two rows: logical (step s, column kk) is physical column
//     8 (kk % 4) + 2 s + kk / 4.  The factor's images carry the same permutation.
//   * The factor is constant for a target, so its hi and lo halves are made
//     once (ops/factor.py: prepare_factor), as a sequence of slots, each the
//     bytes shared memory holds for one (output tile, K chunk): [hi | lo], each
//     128 x 32 TF32 in core-matrix order (8 rows x 16 bytes, K-major, no
//     swizzle).  TF32 wgmma takes K-major operands only, so the forward product
//     reads L's rows and the gradient L^T's.  Only the triangle's slots exist:
//     output tile t of the forward product has the K chunks [0, 4 (t + 1)), of
//     the gradient [4 t, 4 T).  Chunks that are all zero are never stored,
//     loaded or multiplied: at D = 4096, 528 of 1,024 chunk tiles of 128.
//     They stream through a ring of slots, one cp.async.bulk each, with
//     completion on an mbarrier; the last warp done with a slot refills it.
//   * Tiles differ in length (1 to T chunk tiles).  A persistent grid of one
//     block an SM takes them longest first, in a snake: block b of G takes
//     ranks b, 2G - 1 - b, 2G + b, ... of the tiles sorted by length, the row
//     tiles of one column tile next to each other (so that they read its slots
//     from L2 together).  At C = 1024, D = 4096 the 4,224 chunk tiles of 128
//     fall 32 to each of 132 blocks, which is also the longest tile's length.
//   * The tensor core adds into its accumulator by truncation (see logreg.cu):
//     over a K of 4096 that would bias the sums.  So an accumulator runs over
//     kRun k-steps only, small passes first (their truncation is relative to
//     their small size), the hi.hi steps last, and its sum is added to the
//     tile's on the FP32 cores, which round to nearest.  While one warpgroup
//     adds, the other's products run.  The two directions differ: a row of a
//     covariance's factor has its weight near the diagonal, so a few terms make
//     each forward sum and the truncation sets its error; there kRun is one
//     k-step (each with a fresh accumulator).  A column has a long tail of small
//     terms, each FP32 add rounds, and fewer adds are better: kRun is four.  On
//     the LGCP's factors (the H100, against float64, max error over the largest
//     entry) runs of four read 1.1-2.6 times cuBLAS f32's error forward, of one
//     0.9-1.5 times, for 12% more time; the gradient reads 0.3-0.4 times with
//     runs of four, 0.5-0.8 with runs of one.
//   * Ragged edges: batch rows >= C and columns >= D load as zeros and are not
//     stored; the images are zero beyond D.  Any C >= 1, any D >= 1.
//
// C interface for ctypes: returns the cudaError_t of the launch; the launch goes
// on the caller's stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // batch rows an output tile
constexpr int kBN = 128;               // output columns a tile
constexpr int kBK = 32;                // K a chunk: four k-steps of 8
constexpr int kChunks = kBN / kBK;     // chunks a 128-wide K tile
constexpr int kSec = kBN * kBK * 4;    // bytes of a slot's hi (or lo) section
constexpr int kSlotBytes = 2 * kSec;
constexpr int kSlots = 6;              // ring depth: 192 KB
constexpr int kWarps = 8;              // two warpgroups
constexpr int kThreads = kWarps * 32;
constexpr int kBarrierBytes = 128;
constexpr int kSmem = kBarrierBytes + kSlots * kSlotBytes;
static_assert(kSlots * (8 + 4) <= kBarrierBytes, "a full mbarrier and a counter a slot");

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

// ------------------------------------------------------------------ schedule
// The block's walk over its (output tile, K chunk) pairs, the same for every
// warp and for the copies kSlots chunks ahead.  Tiles sorted by length, longest first, the
// row tiles of one column tile next to each other: rank r is row tile r % Mt of
// length class r / Mt.  Block b takes ranks b, 2G - 1 - b, 2G + b, ... (ranks
// only grow, so the first past the end ends the walk).
struct Walk {
  int Mt, T, total, G, b, forward;
  int k;      // the block's k-th tile
  int m, t;   // its row tile and column tile
  int c, c_end;  // the chunk, and the end of the tile's chunks
  bool valid;

  __device__ void tile() {
    const int r = (k & 1) ? k * G + (G - 1 - b) : k * G + b;
    valid = r < total;
    if (!valid) return;
    m = r % Mt;
    const int cls = r / Mt;
    t = forward ? T - 1 - cls : cls;
    c = forward ? 0 : kChunks * t;
    c_end = forward ? kChunks * (t + 1) : kChunks * T;
  }

  __device__ void start(int Mt_, int T_, int G_, int b_, int forward_) {
    Mt = Mt_, T = T_, total = Mt_ * T_, G = G_, b = b_, forward = forward_, k = 0;
    tile();
  }

  // true when the step starts a new tile
  __device__ bool next() {
    if (++c < c_end) return false;
    ++k;
    tile();
    return true;
  }

  // the chunk's slot in the image: the column tiles' slots one after another
  __device__ size_t slot() const {
    const int base = forward ? kChunks * (t * (t + 1) / 2)
                             : kChunks * (t * T - t * (t - 1) / 2);
    return (size_t)base + (c - (forward ? 0 : kChunks * t));
  }
};

// Each consumer thread's rows of the batch, 8 floats of a chunk each: row0 and
// row0 + 8 at columns 32 c + 8 q .. + 7.
struct Rows {
  float4 v[2][2];
};

__device__ __forceinline__ void load_rows(Rows& out, const float* __restrict__ A, int C, int D,
                                          bool vec, int row, int col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int d = col + 4 * u;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < C) {
        const float* src = A + (size_t)r * D + d;
        if (vec) {
          if (d < D) x = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (d < D) x.x = __ldg(src);
          if (d + 1 < D) x.y = __ldg(src + 1);
          if (d + 2 < D) x.z = __ldg(src + 2);
          if (d + 3 < D) x.w = __ldg(src + 3);
        }
      }
      out.v[h][u] = x;
    }
  }
}

// ------------------------------------------------------------------- kernel
// Shared memory: [0, 128) the ring's mbarriers (a slot is full) and counters
// (the warps done with it), then kSlots slots of [hi | lo], each section
// 128 x 32 TF32:
//   byte (kc * 128 + n) * 16 + e * 4 holds the tile's row n at physical column
//   8 e + kc of the chunk; k-step s reads core matrices kc = 2 s and 2 s + 1.
// The block's chunk i goes through slot i % kSlots, phase i / kSlots of its
// barrier.  Thread 0 fills the first kSlots; after that the last of the eight
// warps to be done with chunk i refills its slot with chunk i + kSlots, so the
// slot's barrier is always in the phase its readers expect.  No warp is kept
// for the copies: eight warps share the SM's four schedulers two each, and so
// may hold 255 registers a thread (nine could hold 168).
__device__ __forceinline__ void load_slot(const Walk& w, const float* __restrict__ img,
                                          unsigned char* ring, uint32_t full, int s) {
  mbar_expect_tx(full + 8 * s, kSlotBytes);
  bulk_copy_g2s(smem_u32(ring + s * kSlotBytes), img + w.slot() * (kSlotBytes / 4), kSlotBytes,
                full + 8 * s);
}

// kRun: the k-steps of 8 an accumulator runs before the FP32 cores add it up
// (see the note above): one for the forward product, four for the gradient.
template <bool kForward>
__global__ void __launch_bounds__(kThreads, 1)
tri_factor_kernel(const float* __restrict__ A, const float* __restrict__ img,
                  const float* __restrict__ extra, float* __restrict__ out, int C, int D) {
  constexpr bool forward = kForward;
  constexpr int kRun = kForward ? 1 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_u32(smem);
  int* done = reinterpret_cast<int*>(smem + 8 * kSlots);
  unsigned char* ring = smem + kBarrierBytes;
  const int tid = threadIdx.x;
  const int Mt = (C + kBM - 1) / kBM, T = (D + kBN - 1) / kBN;

  Walk w, ahead;  // this chunk; the chunk kSlots later, which its release loads
  w.start(Mt, T, gridDim.x, blockIdx.x, forward);
  ahead = w;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);  // the expect_tx
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // the __syncthreads() below orders these first fills before every wait
  for (int s = 0; s < kSlots && ahead.valid; ++s, ahead.next())
    if (tid == 0) load_slot(ahead, img, ring, full, s);
  __syncthreads();

  // Warpgroup wg holds rows 64 wg .. 64 wg + 63 of a tile.
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + g;  // and row0 + 8
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool vec2 = (D & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0 &&
                    (reinterpret_cast<uintptr_t>(extra) & 7) == 0;

  float tot[64], acc[64];
  Rows raw;
  if (w.valid) load_rows(raw, A, C, D, vec, kBM * w.m + row0, kBK * w.c + 8 * q);
  bool first = true;  // the chunk starts its tile

  for (int i = 0; w.valid; ++i) {
    // Split this chunk's rows: element e of a row is k-step e / 2, column
    // q + 4 (e % 2) of the step's A fragment.
    uint32_t hi[2][8], lo[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x[8] = {raw.v[h][0].x, raw.v[h][0].y, raw.v[h][0].z, raw.v[h][0].w,
                          raw.v[h][1].x, raw.v[h][1].y, raw.v[h][1].z, raw.v[h][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hi[h][e] = tf32_rna(x[e]);
        lo[h][e] = tf32_rna(x[e] - __uint_as_float(hi[h][e]));
      }
    }
    const int m = w.m, t = w.t;
    const int s = i % kSlots;
    const bool last = w.next();  // the chunk ends its tile
    // the next chunk's rows load while this one's products run
    if (w.valid) load_rows(raw, A, C, D, vec, kBM * w.m + row0, kBK * w.c + 8 * q);

    mbar_wait(full + 8 * s, (i / kSlots) & 1);
    const uint32_t st = smem_u32(ring + s * kSlotBytes);
    const uint64_t d_hi = make_desc(st, 16 * 128, 128);
    const uint64_t d_lo = make_desc(st + kSec, 16 * 128, 128);
    constexpr int kStep = 2 * 16 * 128 / 16;  // two core matrices of K, in descriptor units
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += kRun) {
      wgmma_fence();
#pragma unroll
      for (int k = k0; k < k0 + kRun; ++k)
        wgmma_m64n128k8_rs(acc, lo[0][2 * k], lo[1][2 * k], lo[0][2 * k + 1], lo[1][2 * k + 1],
                           d_hi + k * kStep, k > k0);
#pragma unroll
      for (int k = k0; k < k0 + kRun; ++k)
        wgmma_m64n128k8_rs(acc, hi[0][2 * k], hi[1][2 * k], hi[0][2 * k + 1], hi[1][2 * k + 1],
                           d_lo + k * kStep, 1);
#pragma unroll
      for (int k = k0; k < k0 + kRun; ++k)
        wgmma_m64n128k8_rs(acc, hi[0][2 * k], hi[1][2 * k], hi[0][2 * k + 1], hi[1][2 * k + 1],
                           d_hi + k * kStep, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int r = 0; r < 64; ++r) tot[r] = first && k0 == 0 ? acc[r] : tot[r] + acc[r];
    }
    fence_regs(hi[0]);
    fence_regs(hi[1]);
    fence_regs(lo[0]);
    fence_regs(lo[1]);
    __syncwarp();
    if (lane == 0) {  // this warp is done with the slot; the last refills it
      __threadfence_block();
      if (atomicAdd(done + s, 1) % kWarps == kWarps - 1 && ahead.valid)
        load_slot(ahead, img, ring, full, s);
    }
    ahead.next();
    first = last;
    if (!last) continue;

    // Epilogue.  tot[4 j + e] is row row0 + 8 (e / 2), column 8 j + 2 q + (e % 2)
    // of the tile.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kBM * m + row0 + 8 * h;
      if (r >= C) continue;
      float* dst = out + (size_t)r * D;
      const float* y = (!forward && extra != nullptr) ? extra + (size_t)r * D : nullptr;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int d = kBN * t + 8 * j + 2 * q;
        float2 v = make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
        if (vec2 && d + 1 < D) {
          if (extra != nullptr) {
            const float2 x = forward ? *reinterpret_cast<const float2*>(extra + d)
                                     : *reinterpret_cast<const float2*>(y + d);
            v = forward ? make_float2(x.x + v.x, x.y + v.y) : make_float2(v.x - x.x, v.y - x.y);
          }
          *reinterpret_cast<float2*>(dst + d) = v;
        } else {
          if (d < D) dst[d] = extra == nullptr ? v.x : forward ? extra[d] + v.x : v.x - y[d];
          if (d + 1 < D)
            dst[d + 1] = extra == nullptr ? v.y : forward ? extra[d + 1] + v.y : v.y - y[d + 1];
        }
      }
    }
  }
}

}  // namespace

// A (C, D) f32 row-major; img: the factor's slots for the direction
// (ops/factor.py: prepare_factor), forward L's rows, else L^T's; extra: the
// shift (D,) for the forward product, y (C, D) for the gradient, or null; out
// (C, D).  grid: the blocks to launch (the card's SMs); fewer if there are
// fewer tiles.
extern "C" int klara_tri_factor(const float* A, const float* img, const float* extra, float* out,
                                int C, int D, int forward, int grid, void* stream) {
  if (A == nullptr || img == nullptr || out == nullptr || C <= 0 || D <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // the attribute is set once for each kernel
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(tri_factor_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tri_factor_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long tiles = (long)((C + kBM - 1) / kBM) * ((D + kBN - 1) / kBN);
  const int blocks = tiles < grid ? (int)tiles : grid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (forward)
    tri_factor_kernel<true><<<blocks, kThreads, kSmem, st>>>(A, img, extra, out, C, D);
  else
    tri_factor_kernel<false><<<blocks, kThreads, kSmem, st>>>(A, img, extra, out, C, D);
  return (int)cudaGetLastError();
}
