// K2: per-chain keyed random draws (Philox4x32-10) for sm_90a.
//
// Wrapper and plain PyTorch version: klara_tpu_torch/ops/keyed.py, whose
// docstring fixes the counter layout and every transform; this file follows
// it operation for operation.  K2 replaces no Pallas kernel: it is the port's
// counterpart of the JAX package's per-chain keys (jax.random.split(run_key,
// n_chains) in klara_tpu/jobs/job.py and klara_tpu/jobs/gibbs.py), so that a
// rank draws only its own chains whatever the draw's parameters.
//
// What bounds it on the H100.  Uniform and normal draws: the integer
// instructions of one Philox call an element and the transform's (the
// output's 4 or 8 bytes an element take less).  Gamma, Poisson and binomial:
// their rejection loops, where an element makes as many attempts as its draws
// need and some attempts run a slow test (for Poisson by PTRS three FP64 logs
// and lgamma, for binomial by BTRS five logs and four Stirling tails) whose
// FP64 instructions outweigh the Philox call.  chip_smoke.py counts each
// part's instructions by pipe from this file's SASS and weights them by the
// attempts and slow tests a run's elements made.
//
// The design.  Each (mode, type) is its own kernel, keyed_draws_each<D>,
// chosen on the host, so a mode carries only its own registers: one thread an
// element, its attempts in turn, the grid no larger than stays resident (at
// least kEachBlocks blocks an SM) and striding over the draw.  A draw the card
// holds at once runs in one wave, each element on a thread of its own; a
// thread keeps its element's constants (gamma's d and c, the PTRS and BTRS
// constants) while the next element's parameters are the same.  Every element
// sees its attempts in order, with the same counters and the same operations
// as the plain version's loop, so the bits are those of the plain version.
// Poisson below lam = 10 and binomial's geometric sums (n q < 10) run a whole
// inversion attempt inside the cheap test.  Flat indices are split into
// (chain, element) once a thread (32-bit where the draw fits) and moved on by
// the stride.
//
// A block-level queue that compacted the slow tests onto dense lanes (ballots
// and a prefix over the warps) was measured against this and left out: it
// lost for gamma and for Poisson within one wave, and no path of the port
// draws Poisson or binomial at the sizes where it won (PERF.md, K2's table).
//
// The file is built with -fmad=false so that no multiply and add are
// contracted into one rounding: the plain version rounds each operation, and
// the two then agree bit for bit wherever the math library's results do.  A
// launch goes to the caller's stream, allocates nothing and does not
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
constexpr int kThreads = 256;
// blocks an SM at least for the one-thread-an-element kernels (at most 64
// registers a thread), so that a draw of up to 4 x 256 threads an SM runs in
// one wave, each element on a thread of its own
constexpr int kEachBlocks = 4;
constexpr int kMaxDevices = 64;

// The launch arguments, packed by the wrapper (keyed.py: _ARGS)
struct Args {
  unsigned long long out, calls, overflow, key, step, p0, p1;  // 0: none
  double s0, s1;                     // the scalar parameters, where p0 or p1 is 0
  long long p0c, p0e, p1c, p1e;      // parameter strides: chain, element
  uint32_t step_add, site, offset;   // counter words
  int chains, elems, mode, f64, device;
};
static_assert(sizeof(Args) == 136, "Args must match keyed.py's _ARGS");

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

// what a thread reads once for all its elements: counter word 1 (the step)
// and the run key's two words
struct Run {
  uint32_t step, k0, k1;
};

__device__ __forceinline__ Run run_of(const Args& a) {
  const unsigned long long kk = *reinterpret_cast<const unsigned long long*>(a.key);
  const uint32_t step =
      a.step_add + (a.step ? (uint32_t)*reinterpret_cast<const unsigned long long*>(a.step) : 0u);
  return Run{step, (uint32_t)kk, (uint32_t)(kk >> 32)};
}

// the chain and the element within it of flat index i (32-bit division where
// the draw's indices fit)
__device__ __forceinline__ void split(const Args& a, long long i, uint32_t* c, uint32_t* e) {
  if ((unsigned long long)a.chains * (unsigned)a.elems <= 0xffffffffull) {
    *c = (uint32_t)i / (uint32_t)a.elems;
    *e = (uint32_t)i - *c * (uint32_t)a.elems;
  } else {
    *c = (uint32_t)(i / a.elems);
    *e = (uint32_t)(i % a.elems);
  }
}

// the counter of element e of chain c, and its parameters in T
template <typename T>
__device__ __forceinline__ Counter element(const Args& a, const Run& r, uint32_t c, uint32_t e,
                                           T* p0, T* p1) {
  *p0 = a.p0 ? reinterpret_cast<const T*>(a.p0)[c * a.p0c + e * a.p0e] : (T)a.s0;
  *p1 = a.p1 ? reinterpret_cast<const T*>(a.p1)[c * a.p1c + e * a.p1e] : (T)a.s1;
  return Counter{a.offset + c, r.step, a.site, e, r.k0, r.k1};
}

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

__constant__ double kStirlingTail[10] = {
    0.0810614667953272,  0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
    0.0166446911898211,  0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
    0.00925546218271273, 0.00833056343336287};

__device__ __forceinline__ double stirling_tail(double k) {
  if (k <= 9.0) return kStirlingTail[(int)fmin(fmax(k, 0.0), 9.0)];
  const double kp1sq = (k + 1.0) * (k + 1.0);
  return (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1.0);
}

// ---------------------------------------------------------------- the modes
// An attempt's outcome: the cheap test accepted or rejected it, or the slow
// test decides; kOverflow ends an element at its cap within one attempt.
enum Outcome { kNone, kAccept, kReject, kSlow, kOverflow };

// A mode holds one element's state in a thread's registers (a rejection
// mode keeps the constants of its parameters while the next element's are
// the same):
//   start(a, run, c, e, &value)  element e of chain c; false if it needs no
//                                attempt (value set)
//   cheap(t)                     attempt t: its Philox call(s), the cheap test
//   test(w...)                   the cheap test on given words (the SASS probe's)
//   slow()                       the slow test of the attempt the cheap test left
//   accept(t, &calls)            the value of accepted attempt t, the calls made
template <typename T, int M>
struct Transform {  // uniform and normal: one Philox call, always accepted
  using Out = T;
  Counter ctr;
  T value;

  __device__ bool start(const Args& args, const Run& run, uint32_t c, uint32_t e, T*) {
    T p0, p1;
    ctr = element<T>(args, run, c, e, &p0, &p1);
    return true;
  }
  __device__ int cheap(int) {
    const Words w = ctr.call(0);
    value = M == kUniform ? uniform(w, T()) : normal(w, T());
    return kAccept;
  }
  __device__ bool slow() const { return true; }
  __device__ T accept(int, int* calls) const {
    *calls = 1;
    return value;
  }
};

template <typename T>
struct Gamma {  // Marsaglia & Tsang in T
  using Out = T;
  static constexpr int kPer = sizeof(T) == 4 ? 1 : 2;  // Philox calls an attempt
  Counter ctr;
  T a, d, c, u, xx, v;
  T set_for = T(NAN);  // the shape whose d and c these are
  bool boost;

  __device__ bool start(const Args& args, const Run& run, uint32_t ci, uint32_t ei, T* value) {
    T p1;
    ctr = element<T>(args, run, ci, ei, &a, &p1);
    if (!(a > T(0)) || isinf(a)) {
      *value = T(NAN);
      return false;
    }
    boost = a < T(1);
    if (!(a == set_for)) {
      const T aa = boost ? a + T(1) : a;
      d = aa - T(1) / T(3);
      c = T(1) / sq(T(9) * d);
      set_for = a;
    }
    return true;
  }
  __device__ __forceinline__ int test(const Words& w, const Words& w2) {
    const T x = normal(w, T());
    if constexpr (sizeof(T) == 4) {
      u = u01f(w.z);
    } else {
      u = u01d(w2.x, w2.y);
    }
    const T y = T(1) + c * x;
    if (!(y > T(0))) return kReject;
    v = y * y * y;
    xx = x * x;
    return u < T(1) - T(0.0331) * xx * xx ? kAccept : kSlow;
  }
  __device__ int cheap(int t) {
    const Words w = ctr.call(1 + kPer * t);
    if constexpr (sizeof(T) == 4) {
      return test(w, w);
    } else {
      return test(w, ctr.call(2 + 2 * t));
    }
  }
  __device__ bool slow() const { return lg(u) < T(0.5) * xx + d * (T(1) - v + lg(v)); }
  __device__ T accept(int t, int* calls) const {
    T g = d * v;
    if (boost) {
      const T ub = uniform(ctr.call(0), T());
      g = g * ex(lg(ub) / a);
    }
    *calls = 1 + kPer * (t + 1);
    return g > tiny(T()) ? g : tiny(T());
  }
};

template <typename T>
struct Poisson {  // in f64: inversion below lam = 10, PTRS (Hormann 1993) at and above
  using Out = T;
  Counter ctr;
  double lam, loglam, a, b, vr, log_invalpha, V, us, k;
  double set_for = NAN;  // the rate whose PTRS constants these are
  bool inversion;

  __device__ bool start(const Args& args, const Run& run, uint32_t c, uint32_t e, T* value) {
    T p0, p1;
    ctr = element<T>(args, run, c, e, &p0, &p1);
    lam = (double)p0;
    if (!(lam >= 0.0) || isinf(lam)) {
      *value = (T)NAN;
      return false;
    }
    if (lam == 0.0) {
      *value = (T)0.0;
      return false;
    }
    inversion = lam < 10.0;
    if (!inversion && !(lam == set_for)) {
      set_for = lam;
      const double slam = sqrt(lam);
      loglam = log(lam);
      b = 0.931 + 2.53 * slam;
      a = -0.059 + 0.02483 * b;
      const double invalpha = 1.1239 + 1.1328 / (b - 3.4);
      vr = 0.9277 - 3.6224 / (b - 2.0);
      log_invalpha = log(invalpha);
    }
    return true;
  }
  __device__ __forceinline__ int test(const Words& w) {
    if (inversion) {
      const double u = u01d(w.x, w.y);
      double p = exp(-lam), F = p;
      k = 0.0;
      while (u > F && k < kPoissonInvMaxK) {
        k = k + 1.0;
        p = p * lam / k;
        F = F + p;
      }
      return u <= F ? kAccept : kReject;
    }
    const double U = u01d(w.x, w.y) - 0.5;
    V = u01d(w.z, w.w);
    us = 0.5 - fabs(U);
    k = floor((2.0 * a / us + b) * U + lam + 0.43);
    if (us >= 0.07 && V <= vr) return kAccept;
    if (k < 0.0 || (us < 0.013 && V > us)) return kReject;
    return kSlow;
  }
  __device__ int cheap(int t) { return test(ctr.call(t)); }
  __device__ bool slow() const {
    return log(V) + log_invalpha - log(a / (us * us) + b) <= -lam + k * loglam - lgamma(k + 1.0);
  }
  __device__ T accept(int t, int* calls) const {
    *calls = t + 1;
    return (T)k;
  }
};

template <typename T>
struct Binomial {  // in f64: p > 1/2 reflected; geometric sums where n q < 10, else BTRS
  using Out = T;
  Counter ctr;
  double n, logq, a, b, c, v_r, r, alpha, m, upper_m, st_m, st_nm, v, us, k;
  double n_for = NAN, p_for = NAN;  // the parameters whose constants these are
  int geo_calls;
  bool flip, geometric;

  __device__ bool start(const Args& args, const Run& run, uint32_t ci, uint32_t ei, T* value) {
    T p0, p1;
    ctr = element<T>(args, run, ci, ei, &p0, &p1);
    n = (double)p0;
    const double p = (double)p1;
    if (!(n >= 0.0) || isinf(n) || !(p >= 0.0 && p <= 1.0)) {
      *value = (T)NAN;
      return false;
    }
    if (n == 0.0 || p == 0.0 || p == 1.0) {
      *value = (T)(p == 1.0 ? n : 0.0);
      return false;
    }
    flip = p > 0.5;
    const double q = flip ? 1.0 - p : p;
    geometric = n * q < 10.0;
    if (n == n_for && p == p_for) return true;
    n_for = n;
    p_for = p;
    if (geometric) {
      logq = log1p(-q);
    } else {
      const double stddev = sqrt(n * q * (1.0 - q));
      b = 1.15 + 2.53 * stddev;
      a = -0.0873 + 0.0248 * b + 0.01 * q;
      c = n * q + 0.5;
      v_r = 0.92 - 4.2 / b;
      r = q / (1.0 - q);
      alpha = (2.83 + 5.1 / b) * stddev;
      m = floor((n + 1.0) * q);
      upper_m = (m + 0.5) * log((m + 1.0) / (r * (n - m + 1.0)));
      st_m = stirling_tail(m);
      st_nm = stirling_tail(n - m);
    }
    return true;
  }
  __device__ __forceinline__ int test(const Words& w) {
    const double u = u01d(w.x, w.y) - 0.5;
    v = u01d(w.z, w.w);
    us = 0.5 - fabs(u);
    k = floor((2.0 * a / us + b) * u + c);
    if (us >= 0.07 && v <= v_r) return kAccept;
    if (k < 0.0 || k > n) return kReject;
    return kSlow;
  }
  __device__ int cheap(int t) {
    if (geometric) {  // the whole sum of geometric draws: accepted, or the cap
      double gsum = 0.0;
      Words w{};
      k = 0.0;
      for (int j = 0; j < kBinomialInvMax; ++j) {
        if ((j & 1) == 0) w = ctr.call(j >> 1);
        const double u = (j & 1) ? u01d(w.z, w.w) : u01d(w.x, w.y);
        gsum = gsum + ceil(log(u) / logq);
        if (gsum > n) {
          geo_calls = (j >> 1) + 1;
          return kAccept;
        }
        k = k + 1.0;
      }
      return kOverflow;
    }
    return test(ctr.call(t));
  }
  __device__ bool slow() const {
    const double lv = log(v * alpha / (a / (us * us) + b));
    const double upper = upper_m + (n + 1.0) * log((n - m + 1.0) / (n - k + 1.0)) +
                         (k + 0.5) * log(r * (n - k + 1.0) / (k + 1.0)) + st_m + st_nm -
                         stirling_tail(k) - stirling_tail(n - k);
    return lv <= upper;
  }
  __device__ T accept(int t, int* calls) const {
    *calls = geometric ? geo_calls : t + 1;
    return (T)(flip ? n - k : k);
  }
};

// --------------------------------------------------------------- the kernels
// One thread an element: each thread runs its elements' attempts in turn,
// striding over the draw by the grid's threads
template <class D>
__global__ void __launch_bounds__(kThreads, kEachBlocks) keyed_draws_each(const Args a) {
  using T = typename D::Out;
  T* out = reinterpret_cast<T*>(a.out);
  int* calls = reinterpret_cast<int*>(a.calls);
  const Run run = run_of(a);
  const long long n = (long long)a.chains * a.elems, stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t c, e;  // the chain and element of i, moved on by the stride's
  split(a, i, &c, &e);
  const uint32_t dc = (uint32_t)(stride / a.elems), de = (uint32_t)(stride % a.elems);
  D d;
  for (; i < n; i += stride) {
    T value;
    int used = 0;
    if (d.start(a, run, c, e, &value)) {
      for (int t = 0;;) {
        int outcome = d.cheap(t);
        if (outcome == kSlow) outcome = d.slow() ? kAccept : kReject;
        if (outcome == kAccept) {
          value = d.accept(t, &used);
          break;
        }
        if (outcome == kOverflow || ++t == kMaxAttempts) {
          value = T(NAN);
          used = -1;
          atomicAdd(reinterpret_cast<int*>(a.overflow), 1);
          break;
        }
      }
    }
    out[i] = value;
    if (calls) calls[i] = used;
    c += dc;
    e += de;
    if (e >= (uint32_t)a.elems) {
      e -= a.elems;
      ++c;
    }
  }
}

// ------------------------------------------------------------------ the host
template <typename T>
const void* each_kernel(int mode) {
  switch (mode) {
    case kUniform: return (const void*)keyed_draws_each<Transform<T, kUniform>>;
    case kNormal: return (const void*)keyed_draws_each<Transform<T, kNormal>>;
    case kGamma: return (const void*)keyed_draws_each<Gamma<T>>;
    case kPoisson: return (const void*)keyed_draws_each<Poisson<T>>;
    case kBinomial: return (const void*)keyed_draws_each<Binomial<T>>;
    default: return nullptr;
  }
}

const void* kernel_of(int mode, int f64) {
  return f64 ? each_kernel<double>(mode) : each_kernel<float>(mode);
}

// threads of a kernel resident on the whole card (cached per device and kernel)
cudaError_t resident_threads(int mode, int f64, int device, long long* threads) {
  static long long cache[kMaxDevices][2][5];
  long long* slot = device >= 0 && device < kMaxDevices ? &cache[device][f64][mode] : nullptr;
  if (slot && *slot) {
    *threads = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(mode, f64), kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *threads = (long long)(per_sm * sms > 0 ? per_sm * sms : 1) * kThreads;
  if (slot) *slot = *threads;
  return cudaSuccess;
}

// as many blocks as stay resident and no more than the elements fill
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.mode < kUniform || a.mode > kBinomial) return cudaErrorInvalidValue;
  const long long n = (long long)a.chains * a.elems;
  const int f64 = a.f64 ? 1 : 0;
  long long resident = 0;
  const cudaError_t err = resident_threads(a.mode, f64, a.device, &resident);
  if (err != cudaSuccess) return err;
  const long long blocks = (min(n, resident) + kThreads - 1) / kThreads;
  void* params[] = {const_cast<Args*>(&a)};
  return cudaLaunchKernel(kernel_of(a.mode, f64), dim3((unsigned)blocks), dim3(kThreads), params,
                          0, s);
}

}  // namespace

// One keyed draw on `stream`: the device guard is entered only where the
// calling thread's current device is not the draw's.  Returns the launch's
// cudaError (0: launched).
extern "C" int klara_keyed_draws(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  const long long n = (long long)a->chains * a->elems;
  if (n <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  err = launch(*a, reinterpret_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (current != a->device) cudaSetDevice(current);
  return (int)err;
}

// The kernel of (mode, f64) on the current device: info[0] registers a
// thread, [1] local memory bytes a thread (spills), [2] static shared memory
// bytes a block, [3] threads a block, [4] blocks resident per SM.
extern "C" int klara_keyed_draws_info(int mode, int f64, int* info) {
  if (mode < kUniform || mode > kBinomial) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_of(mode, f64 ? 1 : 0);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = kThreads;
  info[4] = per_sm;
  return (int)err;
}
