// K2: per-chain keyed random draws (Philox4x32-10) for sm_90a.
//
// Wrapper and plain PyTorch version: klara_tpu_torch/ops/keyed.py, whose
// docstring fixes the counter layout and every transform; this file follows
// it operation for operation.  K2 replaces no Pallas kernel: it is the port's
// counterpart of the JAX package's per-chain keys (jax.random.split(run_key,
// n_chains) in klara_tpu/jobs/job.py and klara_tpu/jobs/gibbs.py), so that a
// rank draws only its own chains whatever the draw's parameters.
//
// What bounds it on the H100: the integer instructions of its Philox calls
// (chip_smoke.py counts them from this file's SASS, by pipe); its bytes (the
// output, the parameters) are a few per element.  The design is the simple one: one
// thread per element, each running its own rejection loop and making the
// Philox calls that loop needs, no shared memory, no synchronisation.  The
// file is built with -fmad=false so that no multiply and add are contracted
// into one rounding: the plain version rounds each operation, and the two
// then agree bit for bit wherever the math library's results do.
//
// The launch goes to the caller's stream, allocates nothing and does not
// synchronise.  An element that reaches its cap is written as NaN and adds
// one to *overflow, which the wrapper reads once per run.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
enum Mode { kUniform = 0, kNormal = 1, kGamma = 2, kPoisson = 3, kBinomial = 4 };
constexpr int kMaxAttempts = 64;       // MAX_ATTEMPTS
constexpr double kPoissonInvMaxK = 100.0;  // POISSON_INV_MAX_K
constexpr int kBinomialInvMax = 1024;  // BINOMIAL_INV_MAX
constexpr int kCallBits = 12;          // CALL_BITS

struct Words {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{c0, c1, c2, c3};
}

// the counter of one element; call(j) is its Philox call j
struct Counter {
  uint32_t chain, step, site, elem, k0, k1;
  __device__ __forceinline__ Words call(int j) const {
    return philox(chain, step, site, (elem << kCallBits) | (uint32_t)j, k0, k1);
  }
};

__device__ __forceinline__ float u01f(uint32_t w) {
  return fmaxf((float)(w >> 8) * 5.9604644775390625e-08f, 2.98023223876953125e-08f);
}

__device__ __forceinline__ double u01d(uint32_t a, uint32_t b) {
  const uint64_t m = ((uint64_t)(a >> 5) << 26) | (uint64_t)(b >> 6);
  return fmax((double)m * 1.1102230246251565e-16, 5.5511151231257827e-17);
}

// the math library in the type of the draw
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }
__device__ __forceinline__ float tiny(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny(double) { return DBL_MIN; }

__device__ __forceinline__ float uniform(const Words& w, float) { return u01f(w.x); }
__device__ __forceinline__ double uniform(const Words& w, double) { return u01d(w.x, w.y); }

__device__ __forceinline__ float normal(const Words& w, float) {
  return sqrtf(-2.0f * logf(u01f(w.x))) * cosf(u01f(w.y) * 6.2831855f);
}

__device__ __forceinline__ double normal(const Words& w, double) {
  return sqrt(-2.0 * log(u01d(w.x, w.y))) * cos(u01d(w.z, w.w) * 6.283185307179586);
}

// Marsaglia & Tsang in T; *calls = Philox calls used, 0 for an invalid shape,
// -1 at the cap
template <typename T>
__device__ T gamma_draw(const Counter& ctr, T a, int* calls) {
  if (!(a > T(0)) || isinf(a)) {
    *calls = 0;
    return T(NAN);
  }
  const bool boost = a < T(1);
  const T aa = boost ? a + T(1) : a;
  const T d = aa - T(1) / T(3);
  const T c = T(1) / sq(T(9) * d);
  constexpr int per = sizeof(T) == 4 ? 1 : 2;
  for (int t = 0; t < kMaxAttempts; ++t) {
    const Words w = ctr.call(1 + per * t);
    const T x = normal(w, T());
    T u;
    if constexpr (sizeof(T) == 4) {
      u = u01f(w.z);
    } else {
      const Words w2 = ctr.call(2 + 2 * t);
      u = u01d(w2.x, w2.y);
    }
    const T y = T(1) + c * x;
    if (!(y > T(0))) continue;
    const T v = y * y * y;
    const T xx = x * x;
    if (u < T(1) - T(0.0331) * xx * xx || lg(u) < T(0.5) * xx + d * (T(1) - v + lg(v))) {
      T g = d * v;
      if (boost) {
        const T ub = uniform(ctr.call(0), T());
        g = g * ex(lg(ub) / a);
      }
      *calls = 1 + per * (t + 1);
      return g > tiny(T()) ? g : tiny(T());
    }
  }
  *calls = -1;
  return T(NAN);
}

__device__ double poisson_draw(const Counter& ctr, double lam, int* calls) {
  if (!(lam >= 0.0) || isinf(lam)) {
    *calls = 0;
    return NAN;
  }
  if (lam == 0.0) {
    *calls = 0;
    return 0.0;
  }
  if (lam < 10.0) {  // inversion
    for (int t = 0; t < kMaxAttempts; ++t) {
      const Words w = ctr.call(t);
      const double u = u01d(w.x, w.y);
      double p = exp(-lam), F = p, k = 0.0;
      while (u > F && k < kPoissonInvMaxK) {
        k = k + 1.0;
        p = p * lam / k;
        F = F + p;
      }
      if (u <= F) {
        *calls = t + 1;
        return k;
      }
    }
  } else {  // PTRS (Hormann 1993)
    const double slam = sqrt(lam), loglam = log(lam);
    const double b = 0.931 + 2.53 * slam;
    const double a = -0.059 + 0.02483 * b;
    const double invalpha = 1.1239 + 1.1328 / (b - 3.4);
    const double vr = 0.9277 - 3.6224 / (b - 2.0);
    for (int t = 0; t < kMaxAttempts; ++t) {
      const Words w = ctr.call(t);
      const double U = u01d(w.x, w.y) - 0.5, V = u01d(w.z, w.w);
      const double us = 0.5 - fabs(U);
      const double k = floor((2.0 * a / us + b) * U + lam + 0.43);
      const bool quick = us >= 0.07 && V <= vr;
      const bool bad = k < 0.0 || (us < 0.013 && V > us);
      if (quick || (!bad && log(V) + log(invalpha) - log(a / (us * us) + b) <=
                                -lam + k * loglam - lgamma(k + 1.0))) {
        *calls = t + 1;
        return k;
      }
    }
  }
  *calls = -1;
  return NAN;
}

__device__ __forceinline__ double stirling_tail(double k) {
  const double table[10] = {0.0810614667953272,  0.0413406959554092,  0.0276779256849983,
                            0.02079067210376509, 0.0166446911898211,  0.0138761288230707,
                            0.0118967099458917,  0.0104112652619720,  0.00925546218271273,
                            0.00833056343336287};
  if (k <= 9.0) return table[(int)fmin(fmax(k, 0.0), 9.0)];
  const double kp1sq = (k + 1.0) * (k + 1.0);
  return (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1.0);
}

__device__ double binomial_draw(const Counter& ctr, double n, double p, int* calls) {
  if (!(n >= 0.0) || isinf(n) || !(p >= 0.0 && p <= 1.0)) {
    *calls = 0;
    return NAN;
  }
  if (n == 0.0 || p == 0.0 || p == 1.0) {
    *calls = 0;
    return p == 1.0 ? n : 0.0;
  }
  const bool flip = p > 0.5;
  const double q = flip ? 1.0 - p : p;
  double k = 0.0;
  bool done = false;
  if (n * q < 10.0) {  // the sum of geometric draws
    const double logq = log1p(-q);
    double gsum = 0.0;
    Words w{};
    for (int j = 0; j < kBinomialInvMax; ++j) {
      if ((j & 1) == 0) w = ctr.call(j >> 1);
      const double u = (j & 1) ? u01d(w.z, w.w) : u01d(w.x, w.y);
      gsum = gsum + ceil(log(u) / logq);
      if (gsum > n) {
        *calls = (j >> 1) + 1;
        done = true;
        break;
      }
      k = k + 1.0;
    }
  } else {  // BTRS (Hormann 1993)
    const double stddev = sqrt(n * q * (1.0 - q));
    const double b = 1.15 + 2.53 * stddev;
    const double a = -0.0873 + 0.0248 * b + 0.01 * q;
    const double c = n * q + 0.5;
    const double v_r = 0.92 - 4.2 / b;
    const double r = q / (1.0 - q);
    const double alpha = (2.83 + 5.1 / b) * stddev;
    const double m = floor((n + 1.0) * q);
    for (int t = 0; t < kMaxAttempts && !done; ++t) {
      const Words w = ctr.call(t);
      const double u = u01d(w.x, w.y) - 0.5, v = u01d(w.z, w.w);
      const double us = 0.5 - fabs(u);
      const double kk = floor((2.0 * a / us + b) * u + c);
      const bool quick = us >= 0.07 && v <= v_r;
      const bool bad = kk < 0.0 || kk > n;
      bool ok = quick;
      if (!ok && !bad) {
        const double lv = log(v * alpha / (a / (us * us) + b));
        const double upper = (m + 0.5) * log((m + 1.0) / (r * (n - m + 1.0))) +
                             (n + 1.0) * log((n - m + 1.0) / (n - kk + 1.0)) +
                             (kk + 0.5) * log(r * (n - kk + 1.0) / (kk + 1.0)) +
                             stirling_tail(m) + stirling_tail(n - m) - stirling_tail(kk) -
                             stirling_tail(n - kk);
        ok = lv <= upper;
      }
      if (ok) {
        k = kk;
        *calls = t + 1;
        done = true;
      }
    }
  }
  if (!done) {
    *calls = -1;
    return NAN;
  }
  return flip ? n - k : k;
}

template <typename T>
__global__ void keyed_draws_kernel(int mode, T* out, int* calls_out, int* overflow,
                                   const long long* key, const long long* step_ptr,
                                   uint32_t step_add, uint32_t site, uint32_t offset, int chains,
                                   int elems, const T* p0, T s0, long long p0c, long long p0e,
                                   const T* p1, T s1, long long p1c, long long p1e) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)chains * elems) return;
  const long long c = i / elems, e = i % elems;
  const unsigned long long kk = (unsigned long long)*key;
  const uint32_t step = step_add + (step_ptr ? (uint32_t)(unsigned long long)*step_ptr : 0u);
  const Counter ctr{offset + (uint32_t)c, step, site, (uint32_t)e, (uint32_t)kk,
                    (uint32_t)(kk >> 32)};
  const T a0 = p0 ? p0[c * p0c + e * p0e] : s0;
  const T a1 = p1 ? p1[c * p1c + e * p1e] : s1;
  int n_calls = 1;
  T r;
  switch (mode) {
    case kUniform: r = uniform(ctr.call(0), T()); break;
    case kNormal: r = normal(ctr.call(0), T()); break;
    case kGamma: r = gamma_draw<T>(ctr, a0, &n_calls); break;
    case kPoisson: r = (T)poisson_draw(ctr, (double)a0, &n_calls); break;
    default: r = (T)binomial_draw(ctr, (double)a0, (double)a1, &n_calls); break;
  }
  if (n_calls < 0) atomicAdd(overflow, 1);
  out[i] = r;
  if (calls_out) calls_out[i] = n_calls;
}

}  // namespace

extern "C" int klara_keyed_draws(int mode, int f64, void* out, void* calls, void* overflow,
                                 const void* key, const void* step_ptr, unsigned step_add,
                                 unsigned site, unsigned offset, int chains, int elems,
                                 const void* p0, double s0, long long p0c, long long p0e,
                                 const void* p1, double s1, long long p1c, long long p1e,
                                 void* stream) {
  const long long n = (long long)chains * elems;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(key);
  const auto* sp = static_cast<const long long*>(step_ptr);
  int* co = static_cast<int*>(calls);
  int* ov = static_cast<int*>(overflow);
  if (f64) {
    keyed_draws_kernel<double><<<blocks, threads, 0, s>>>(
        mode, static_cast<double*>(out), co, ov, k, sp, step_add, site, offset, chains, elems,
        static_cast<const double*>(p0), s0, p0c, p0e, static_cast<const double*>(p1), s1, p1c,
        p1e);
  } else {
    keyed_draws_kernel<float><<<blocks, threads, 0, s>>>(
        mode, static_cast<float*>(out), co, ov, k, sp, step_add, site, offset, chains, elems,
        static_cast<const float*>(p0), (float)s0, p0c, p0e, static_cast<const float*>(p1),
        (float)s1, p1c, p1e);
  }
  return (int)cudaGetLastError();
}
