// K1: batched logistic-regression log-density and gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel klara_tpu/ops/logreg.py: fused_logreg_value_grad
// -> _fused_core (the pl.pallas_call) -> _kernel.  For every chain c, with
// v = X^T y precomputed once by the caller:
//
//   value_c = p_c.v - sum_n softplus(x_n.p_c) - |p_c|^2 / (2 lam) - D/2 log(2 pi lam)
//   grad_c  = v - sigmoid(X p_c)^T X - p_c / lam
//
// What bounds it.  One evaluation at the main path's shape (C=16384 chains,
// D=100, N=1024 data rows) is two products of 2*C*N*D = 3.4 GFLOP each,
// 6.7 GFLOP in all.  X is 0.4 MB and stays in L2; P is 6.5 MB and is read
// once.  So a kernel that keeps the (C, N) logits on chip is bound by FP32
// arithmetic (and, in this simple form, by shared-memory loads), while the
// plain PyTorch path pays two cuBLAS GEMMs plus a round trip of the 67 MB
// logits through device memory for softplus and sigmoid.
//
// Design (right and simple first; no tensor cores, TMA or wgmma yet):
//   * One block of 256 threads (8 warps) per tile of TC=64 chains.  The Pallas
//     grid's sequential data axis, which carried its accumulators in VMEM
//     scratch, becomes a loop over data tiles of TN=32 rows inside the block.
//   * The block's P rows sit in shared memory for the whole loop.  Per data
//     tile, X's rows are staged in shared memory, each warp forms the logits
//     Z for its 8 chains x 32 rows (one row per lane) on the FP32 cores,
//     accumulates softplus in the stable form max(z,0) + log1p(exp(-|z|)) (as
//     jax.nn.softplus), writes sigmoid(z) (stable form) to its own slice of
//     shared memory, and adds sigmoid(Z) X into per-thread register
//     accumulators (8 chains x 4 columns per thread).
//   * Ragged edges of C, N and D are masked in the kernel, not zero-padded in
//     device memory: rows n >= N contribute nothing to either sum, so no
//     n_pad*log(2) correction is needed (the Pallas wrapper needs one).
//   * The epilogue forms the finished value and gradient.
//   * D <= 128 (the wrapper raises otherwise).  Shared memory is dynamic and
//     sized from D at launch.
//
// C interface for ctypes: returns cudaGetLastError() after the launch; the
// launch goes on the caller's stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChainsPerWarp = 8;
constexpr int kTileC = kWarps * kChainsPerWarp;  // 64 chains per block
constexpr int kTileN = 32;                        // data rows per tile (one per lane)
constexpr int kMaxD = 128;                        // 4 columns per lane in the gradient

__device__ __forceinline__ float softplus_stable(float z) {
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid_stable(float z) {
  float e = expf(-fabsf(z));
  float r = 1.0f / (1.0f + e);
  return z >= 0.0f ? r : e * r;
}

// Shared-memory layout (floats):
//   Ps[kTileC][dp4]        the block's chains, columns >= D zeroed
//   Xs[kTileN][xs_stride]  the current data tile, rows >= N and columns >= D zeroed
//   Ss[kWarps][kChainsPerWarp][kTileN]  sigmoid of each warp's logits
__global__ void __launch_bounds__(kThreads)
logreg_value_grad_kernel(const float* __restrict__ P, const float* __restrict__ X,
                         const float* __restrict__ v, float* __restrict__ value,
                         float* __restrict__ grad, int C, int N, int D, int dp4,
                         int xs_stride, float inv_lam, float log_norm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ps = smem;
  float* Xs = Ps + kTileC * dp4;
  float* Ss = Xs + kTileN * xs_stride;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = blockIdx.x * kTileC;
  float* Sw = Ss + warp * kChainsPerWarp * kTileN;

  // Stage the block's P rows once.
  for (int idx = tid; idx < kTileC * dp4; idx += kThreads) {
    int r = idx / dp4, d = idx % dp4;
    int c = c0 + r;
    Ps[idx] = (c < C && d < D) ? P[(size_t)c * D + d] : 0.0f;
  }

  float acc[kChainsPerWarp][4];
  float sp[kChainsPerWarp];
#pragma unroll
  for (int i = 0; i < kChainsPerWarp; ++i) {
    sp[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += kTileN) {
    __syncthreads();  // P is staged / every warp is done with the last X tile
    for (int idx = tid; idx < kTileN * dp4; idx += kThreads) {
      int r = idx / dp4, d = idx % dp4;
      int n = n0 + r;
      Xs[r * xs_stride + d] = (n < N && d < D) ? X[(size_t)n * D + d] : 0.0f;
    }
    __syncthreads();

    // Logits: lane = data row, 8 chains per warp, 4 columns per step.
    float z[kChainsPerWarp];
#pragma unroll
    for (int i = 0; i < kChainsPerWarp; ++i) z[i] = 0.0f;
    const float* xrow = Xs + lane * xs_stride;
    for (int d = 0; d < dp4; d += 4) {
      float4 x4 = *reinterpret_cast<const float4*>(xrow + d);
#pragma unroll
      for (int i = 0; i < kChainsPerWarp; ++i) {
        float4 p4 = *reinterpret_cast<const float4*>(
            Ps + (warp * kChainsPerWarp + i) * dp4 + d);
        z[i] = fmaf(p4.x, x4.x, z[i]);
        z[i] = fmaf(p4.y, x4.y, z[i]);
        z[i] = fmaf(p4.z, x4.z, z[i]);
        z[i] = fmaf(p4.w, x4.w, z[i]);
      }
    }
    const bool row_ok = n0 + lane < N;
#pragma unroll
    for (int i = 0; i < kChainsPerWarp; ++i) {
      float s = 0.0f;
      if (row_ok) {
        sp[i] += softplus_stable(z[i]);
        s = sigmoid_stable(z[i]);
      }
      Sw[i * kTileN + lane] = s;
    }
    __syncwarp();

    // sigmoid(Z) X: lane owns columns 4*lane .. 4*lane+3.
    if (4 * lane < dp4) {
      for (int n = 0; n < kTileN; n += 4) {
        float4 xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xv[k] = *reinterpret_cast<const float4*>(Xs + (n + k) * xs_stride + 4 * lane);
#pragma unroll
        for (int i = 0; i < kChainsPerWarp; ++i) {
          float4 s4 = *reinterpret_cast<const float4*>(Sw + i * kTileN + n);
          float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][0] = fmaf(sv[k], xv[k].x, acc[i][0]);
            acc[i][1] = fmaf(sv[k], xv[k].y, acc[i][1]);
            acc[i][2] = fmaf(sv[k], xv[k].z, acc[i][2]);
            acc[i][3] = fmaf(sv[k], xv[k].w, acc[i][3]);
          }
        }
      }
    }
    __syncwarp();  // Sw is rewritten by the next tile
  }

  // Epilogue: per chain, p.v and |p|^2 from the staged rows, softplus sums
  // reduced across the warp, then the finished value and gradient.
#pragma unroll
  for (int i = 0; i < kChainsPerWarp; ++i) {
    const int r = warp * kChainsPerWarp + i;
    const int c = c0 + r;
    const float* prow = Ps + r * dp4;
    float pv = 0.0f, pp = 0.0f;
    for (int d = lane; d < D; d += 32) {
      pv = fmaf(prow[d], v[d], pv);
      pp = fmaf(prow[d], prow[d], pp);
    }
    float s = sp[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pv += __shfl_xor_sync(0xffffffffu, pv, off);
      pp += __shfl_xor_sync(0xffffffffu, pp, off);
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (c < C) {
      if (lane == 0) value[c] = pv - s - 0.5f * pp * inv_lam - log_norm;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int d = 4 * lane + j;
        if (d < D) grad[(size_t)c * D + d] = v[d] - acc[i][j] - prow[d] * inv_lam;
      }
    }
  }
}

}  // namespace

extern "C" int klara_logreg_value_grad_f32(const float* P, const float* X, const float* v,
                                            float* value, float* grad, int C, int N, int D,
                                            float inv_lam, float log_norm, void* stream) {
  if (C <= 0 || N <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const int dp4 = (D + 3) / 4 * 4;
  // an odd number of float4s per X row keeps the lanes' row reads conflict-free
  const int xs_stride = (dp4 / 4) % 2 == 1 ? dp4 : dp4 + 4;
  const size_t smem =
      sizeof(float) * ((size_t)kTileC * dp4 + (size_t)kTileN * xs_stride +
                       (size_t)kWarps * kChainsPerWarp * kTileN);
  cudaError_t err = cudaFuncSetAttribute(
      logreg_value_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + kTileC - 1) / kTileC;
  logreg_value_grad_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, X, v, value, grad, C, N, D, dp4, xs_stride, inv_lam, log_norm);
  return (int)cudaGetLastError();
}
