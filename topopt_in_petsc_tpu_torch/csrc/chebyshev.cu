// One step of the Chebyshev-Jacobi smoother on f32 fields, in one pass:
// the step of solvers/chebyshev.py::chebyshev_smooth_plain that follows an
// operator application, with its coefficients.
//
// Replaces no TPU kernel: the JAX package's solvers/chebyshev.py leaves
// these vector updates to XLA, which fuses them; in eager PyTorch the
// step is six elementwise kernels and ~20 kernels on 0-d tensors for the
// coefficients.  Plain PyTorch version: ops/chebyshev.py::
// chebyshev_step_plain (one step), solvers/chebyshev.py::
// chebyshev_smooth_plain (the smoother).
//
// With theta, delta, sigma from lmax (the band) and rho, rho' the
// recurrence's coefficients at step k:
//
//   start from zero (k = 0, no A):  d = (dinv * b) / theta        (x is d)
//   start from x    (k = 0, A x):   r = b - A x;  d = (dinv * r) / theta;
//                                   x = x + d
//   step k >= 1     (A d):          r = r - A d;
//                                   d = (rho' rho) d
//                                       + (2 rho' / delta) (dinv r);
//                                   x = x + d  (d_old + d when x is d)
//
// Bit for bit: the coefficients are formed in registers from *lmax, and
// every operation is torch's f32 operation, in torch's order, rounded
// once (the _rn intrinsics keep nvcc from contracting a multiply and an
// add into an FMA): the smoother gives the plain version's bits.
//
// What bounds it on an H100: bytes, at ~1 operation per 4 bytes.  At 257^3
// nodes one (3, nx, ny, nz) field is 203.7 MB; a step reads r, A d, d,
// dinv, x and writes r, d, x, 8 passes, 1.63 GB, 0.486 ms at 3.35 TB/s.
// The torch step moved 16 passes.  The last step of a smoothing stores x
// alone (6 passes); a start from zero reads b and dinv and stores d (3),
// and the step after it reads no x, which is d (7).
//
// Design: flat 128-bit loads and stores over the contiguous fields (a
// scalar tail: 3 * 257^3 is odd; a scalar path where a pointer is not 16
// B aligned), one float4 per thread over a grid of 256-thread blocks that
// covers the field (a resident wave walking it by a grid stride, with up
// to 4 float4 of each thread in flight, ran a recurrence step at
// 86.0-87.3% of the bound at 257^3 on an H100, this grid at 90.6%),
// launched on the caller's stream, no allocation and no synchronisation.
// In place: an output may be its own input (r, d and x are updated where
// they lie); each element is read, then written, by one thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind { kFromZero, kFromX, kStep };

// What a step multiplies by: 1 / theta at a start, rho' rho and
// 2 rho' / delta in the recurrence.
struct Coef {
  float theta, c1, c2;
};

// The coefficients of step `step`, in solvers/chebyshev.py's f32
// operations: lmax * margin, lower * lmax, upper * lmax, 0.5 * (a + b),
// 0.5 * (a - b), theta / delta, and 1.0 / t as torch forms it,
// reciprocal(t) * 1.0 (the product by 1 is exact).
__device__ __forceinline__ Coef coefficients(const float* lmax_p,
                                             float margin, float lower,
                                             float upper, int step) {
  const float lmax = __fmul_rn(__ldg(lmax_p), margin);
  const float lmin = __fmul_rn(lmax, lower);
  const float lmax_b = __fmul_rn(lmax, upper);
  const float theta = __fmul_rn(__fadd_rn(lmax_b, lmin), 0.5f);
  const float delta = __fmul_rn(__fsub_rn(lmax_b, lmin), 0.5f);
  const float sigma = __fdiv_rn(theta, delta);
  float rho = __frcp_rn(sigma);
  float rho_new = rho;
  for (int k = 1; k <= step; ++k) {
    rho_new = __frcp_rn(__fsub_rn(__fmul_rn(sigma, 2.0f), rho));
    if (k < step) rho = rho_new;
  }
  return {theta, __fmul_rn(rho_new, rho),
          __fdiv_rn(__fmul_rn(rho_new, 2.0f), delta)};
}

// One element's step; r holds b at a start, and x the old d when x is d.
template <int kKind>
__device__ __forceinline__ void update(float& r, float ad, float& d,
                                       float dv, float& x, const Coef& c) {
  if (kKind == kFromZero) {
    d = __fdiv_rn(__fmul_rn(dv, r), c.theta);
  } else if (kKind == kFromX) {
    r = __fsub_rn(r, ad);
    d = __fdiv_rn(__fmul_rn(dv, r), c.theta);
    x = __fadd_rn(x, d);
  } else {
    r = __fsub_rn(r, ad);
    d = __fadd_rn(__fmul_rn(c.c1, d), __fmul_rn(c.c2, __fmul_rn(dv, r)));
    x = __fadd_rn(x, d);
  }
}

template <int kKind>
__device__ __forceinline__ void update4(float4& r, const float4& ad,
                                        float4& d, const float4& dv,
                                        float4& x, const Coef& c) {
  update<kKind>(r.x, ad.x, d.x, dv.x, x.x, c);
  update<kKind>(r.y, ad.y, d.y, dv.y, x.y, c);
  update<kKind>(r.z, ad.z, d.z, dv.z, x.z, c);
  update<kKind>(r.w, ad.w, d.w, dv.w, x.w, c);
}

// Reads and writes element i (T = float) or float4 i (T = float4) of the
// fields: what each kind reads and, with kStoreRD, stores r and d too.
template <int kKind, bool kStoreRD, bool kXIsD, typename T>
__device__ __forceinline__ void step_at(
    long long i, const T* r_in, const T* __restrict__ ad, const T* d_in,
    const T* __restrict__ dinv, const T* x_in, T* r_out, T* d_out, T* x_out,
    const Coef& c) {
  T r = r_in[i];
  const T dv = __ldg(dinv + i);
  T a{}, d{}, x{};
  if (kKind != kFromZero) a = __ldg(ad + i);
  if (kKind == kStep) d = d_in[i];
  if (kKind == kFromX || (kKind == kStep && !kXIsD)) x = x_in[i];
  if (kXIsD) x = d;
  if constexpr (sizeof(T) == sizeof(float4))
    update4<kKind>(r, a, d, dv, x, c);
  else
    update<kKind>(r, a, d, dv, x, c);
  if (kKind == kFromZero) {
    d_out[i] = d;
    return;
  }
  if (kStoreRD) {
    r_out[i] = r;
    d_out[i] = d;
  }
  x_out[i] = x;
}

template <int kKind, bool kStoreRD, bool kXIsD>
__global__ void __launch_bounds__(kThreads) chebyshev_step_kernel(
    const float* r_in, const float* __restrict__ ad, const float* d_in,
    const float* __restrict__ dinv, const float* x_in, float* r_out,
    float* d_out, float* x_out, const float* __restrict__ lmax,
    float margin, float lower, float upper, int step, long long n,
    long long n4) {
  const Coef c = coefficients(lmax, margin, lower, upper, step);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (long long i = t; i < n4; i += stride)
    step_at<kKind, kStoreRD, kXIsD>(
        i, reinterpret_cast<const float4*>(r_in),
        reinterpret_cast<const float4*>(ad),
        reinterpret_cast<const float4*>(d_in),
        reinterpret_cast<const float4*>(dinv),
        reinterpret_cast<const float4*>(x_in),
        reinterpret_cast<float4*>(r_out), reinterpret_cast<float4*>(d_out),
        reinterpret_cast<float4*>(x_out), c);
  for (long long i = 4 * n4 + t; i < n; i += stride)
    step_at<kKind, kStoreRD, kXIsD>(i, r_in, ad, d_in, dinv, x_in, r_out,
                                    d_out, x_out, c);
}

template <int kKind, bool kStoreRD, bool kXIsD>
int launch(const float* r_in, const float* ad, const float* d_in,
           const float* dinv, const float* x_in, float* r_out, float* d_out,
           float* x_out, const float* lmax, float margin, float lower,
           float upper, int step, long long n, bool vec,
           cudaStream_t stream) {
  const long long n4 = vec ? n / 4 : 0;
  const long long work = vec ? n4 : n;
  const long long grid = (work + kThreads - 1) / kThreads;
  chebyshev_step_kernel<kKind, kStoreRD, kXIsD>
      <<<static_cast<int>(grid), kThreads, 0, stream>>>(
      r_in, ad, d_in, dinv, x_in, r_out, d_out, x_out, lmax, margin, lower,
      upper, step, n, n4);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

extern "C" {

// One step of n elements.  r_in: b at a start (step 0), else r; ad: A x at
// a start from x, null at a start from zero, else A d; d_in: d (steps >= 1
// only); x_in: x (null at a start from zero; d_in itself when x is d);
// dinv; lmax: a device pointer to the f32 bound the band is formed from
// (times margin; lower and upper as solvers/chebyshev.py takes them, each
// rounded to f32 as torch rounds a scalar).  Outputs: d_out at a start
// from zero; else x_out, and r_out and d_out both or neither (the last
// step needs x alone).  An output may be its own input.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int chebyshev_step_f32(const void* r_in, const void* ad, const void* d_in,
                       const void* dinv, const void* x_in, void* r_out,
                       void* d_out, void* x_out, const void* lmax,
                       double margin, double lower, double upper, int step,
                       long long n, void* stream) {
  const int kind = step > 0 ? kStep : ad != nullptr ? kFromX : kFromZero;
  const bool store_rd = r_out != nullptr;
  const bool x_is_d = kind == kStep && x_in == d_in;
  const bool bad =
      n < 1 || step < 0 || r_in == nullptr || dinv == nullptr ||
      lmax == nullptr ||
      (kind == kFromZero ? d_out == nullptr
                         : x_in == nullptr || x_out == nullptr ||
                               store_rd != (d_out != nullptr)) ||
      (kind == kStep && d_in == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {r_in, ad, d_in, dinv, x_in, r_out, d_out, x_out};
  bool vec = true;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  const auto* f_r = static_cast<const float*>(r_in);
  const auto* f_ad = static_cast<const float*>(ad);
  const auto* f_d = static_cast<const float*>(d_in);
  const auto* f_dinv = static_cast<const float*>(dinv);
  const auto* f_x = static_cast<const float*>(x_in);
  auto* o_r = static_cast<float*>(r_out);
  auto* o_d = static_cast<float*>(d_out);
  auto* o_x = static_cast<float*>(x_out);
  const auto* f_lmax = static_cast<const float*>(lmax);
  const float m = static_cast<float>(margin);
  const float lo = static_cast<float>(lower);
  const float up = static_cast<float>(upper);
  auto st = static_cast<cudaStream_t>(stream);
#define TOPOPT_CHEB_LAUNCH(K, S, X)                                         \
  launch<K, S, X>(f_r, f_ad, f_d, f_dinv, f_x, o_r, o_d, o_x, f_lmax, m, lo, \
                  up, step, n, vec, st)
  if (kind == kFromZero) return TOPOPT_CHEB_LAUNCH(kFromZero, false, false);
  if (kind == kFromX)
    return store_rd ? TOPOPT_CHEB_LAUNCH(kFromX, true, false)
                    : TOPOPT_CHEB_LAUNCH(kFromX, false, false);
  if (x_is_d)
    return store_rd ? TOPOPT_CHEB_LAUNCH(kStep, true, true)
                    : TOPOPT_CHEB_LAUNCH(kStep, false, true);
  return store_rd ? TOPOPT_CHEB_LAUNCH(kStep, true, false)
                  : TOPOPT_CHEB_LAUNCH(kStep, false, false);
#undef TOPOPT_CHEB_LAUNCH
}

}  // extern "C"
