// Fused euler stage (K1) and weak Laplacian (K2) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_euler.py:_euler_kernel3 (reached
// through fused_advect_limit; its alternates _euler_kernel and
// _euler_kernel2 compute the same function) and :_laplace_kernel (through
// laplace_wk_t).  Plain PyTorch versions: ops/euler.py.
//
// Layout: T layout [E, 16, L], lane = tracer*nk + level; level fields
// [E, 16, nk]; metric pack [E, 10, 16] (ops/euler.py MET_ROWS).
//
// Bound on the H100: device-memory bytes.  A column (element, lane) is
// 16 points of one tracer-level; every operation of the stage is local to
// one column, so a column is one thread and nothing leaves registers
// between the loads of Qdp (and the stage-2 Laplacian input) and the store
// of the limited output.  K1 moves about 2-3 field passes (read Qdp, read
// bih on stage 2, write out) plus level fields that 35 tracers share
// through L1/L2; its arithmetic (two 4x4 contractions per point, up to 15
// limiter passes of ~10 flops per point) is far below the card's rate.
// Neighbouring threads take neighbouring lanes, so each of the 16 point
// loads of a warp is one coalesced 128-byte (f32) transaction.  The
// per-element metric rows and the 4x4 derivative live in shared memory.
//
// The limiter loop exits per column as soon as the column converges:
// converged columns are fixed points of the clip-redistribute body, so
// this equals the JAX package's group while_loop and its full unroll.
// Every 16-point sum uses the _sum16 pairwise tree; every 4x4 derivative
// sums its terms in the JAX roll order (common.cuh).  Built with
// --fmad=false so each product and sum rounds as in the plain version.

#include "common.cuh"

namespace {

using tse::ddx_rot;
using tse::ddy_rot;
using tse::kRRearth;
using tse::lap_wk;
using tse::sum16;

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

template <typename T, bool BIH>
__global__ void __launch_bounds__(kThreads)
euler_kernel(const T* __restrict__ qdp, const T* __restrict__ u,
             const T* __restrict__ v, const T* __restrict__ dp,
             const T* __restrict__ divdp, const T* __restrict__ met,
             const T* __restrict__ qmin, const T* __restrict__ qmax,
             const T* __restrict__ deriv, const T* __restrict__ dp0,
             const T* __restrict__ bih, T* __restrict__ out,
             T* __restrict__ qmin_out, T* __restrict__ qmax_out, int L,
             int nk, T dt, T nu_coef, int max_iter, T tol_rel) {
  __shared__ T sm[160];
  __shared__ T sD[16];
  const int64_t e = blockIdx.x;
  for (int i = threadIdx.x; i < 160; i += blockDim.x) sm[i] = met[e * 160 + i];
  if (threadIdx.x < 16) sD[threadIdx.x] = deriv[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int k = lane % nk;
  const T* d00 = sm;
  const T* d01 = sm + 16;
  const T* d10 = sm + 32;
  const T* d11 = sm + 48;
  const T* metdet = sm + 64;
  const T* rmetdet = sm + 80;
  const T* sp = sm + 96;
  const T* s00 = sm + 112;
  const T* s01 = sm + 128;
  const T* s11 = sm + 144;
  const int64_t base = e * 16 * L + lane;
  const int64_t lbase = e * 16 * nk + k;
  const T one = T(1);

  // advection RHS: qtens = qdp - dt * div(Vstar qdp)
  T q[16], c1[16], c2[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const T qp = qdp[base + int64_t(p) * L];
    const T rdp = one / dp[lbase + p * nk];
    const T gu = (u[lbase + p * nk] * rdp) * qp;
    const T gv = (v[lbase + p * nk] * rdp) * qp;
    c1[p] = (d00[p] * gu + d01[p] * gv) * metdet[p];
    c2[p] = (d10[p] * gu + d11[p] * gv) * metdet[p];
    q[p] = qp;
  }
  const T rr = T(kRRearth);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = a * 4 + b;
      const T div = ((ddx_rot<T, false>(sD, c1, a, b) +
                      ddy_rot<T, false>(sD, c2, a, b)) *
                     rmetdet[p]) * rr;
      q[p] = q[p] - dt * div;
    }
  }
  if (BIH) {
    // stage-2 hyperviscosity: second weak Laplacian of the DSS'd first
    T b[16], lap[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) b[p] = bih[base + int64_t(p) * L];
    lap_wk(sD, b, s00, s01, s11, lap);
    const T nd = nu_coef * dp0[k];
#pragma unroll
    for (int p = 0; p < 16; ++p) q[p] = q[p] + (nd * lap[p]) * (one / sp[p]);
  }

  // limiter 8 on x = qtens / dp_star
  T c[16], x[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const T dps = dp[lbase + p * nk] - dt * divdp[lbase + p * nk];
    c[p] = sp[p] * dps;
    x[p] = q[p] * (one / dps);
  }
  const T sumc = sum16(c);
  T cx[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) cx[p] = c[p] * x[p];
  const T mass = sum16(cx);
  const bool valid = sumc > T(0);
  const T safe = valid ? sumc : one;
  const int64_t brow = e * L + lane;
  T mn = qmin[brow];
  T mx = qmax[brow];
  mn = mass < mn * safe ? mass / safe : mn;
  mx = mass > mx * safe ? mass / safe : mx;
  qmin_out[brow] = mn;
  qmax_out[brow] = mx;
  if (!valid) {
#pragma unroll
    for (int p = 0; p < 16; ++p) out[base + int64_t(p) * L] = q[p] * sp[p];
    return;
  }
  const T tol = tol_rel * fabs(mass);
  for (int it = 0; it < max_iter; ++it) {
    T r[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) r[p] = (x[p] - clampv(x[p], mn, mx)) * c[p];
    const T addmass = sum16(r);
    if (fabs(addmass) <= tol) {
#pragma unroll
      for (int p = 0; p < 16; ++p) x[p] = clampv(x[p], mn, mx);
      break;
    }
    const bool pos = addmass > T(0);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const T xc = clampv(x[p], mn, mx);
      r[p] = (pos ? xc < mx : xc > mn) ? c[p] : T(0);
    }
    const T wsum = sum16(r);
    const T add = wsum > T(0) ? addmass / wsum : T(0);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const T xc = clampv(x[p], mn, mx);
      x[p] = (pos ? xc < mx : xc > mn) ? xc + add : xc;
    }
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) out[base + int64_t(p) * L] = x[p] * c[p];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
laplace_kernel(const T* __restrict__ s, const T* __restrict__ met,
               const T* __restrict__ deriv, T* __restrict__ out, int B) {
  __shared__ T sS[48];
  __shared__ T sD[16];
  const int64_t e = blockIdx.x;
  for (int i = threadIdx.x; i < 48; i += blockDim.x)
    sS[i] = met[e * 160 + 112 + i];
  if (threadIdx.x < 16) sD[threadIdx.x] = deriv[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int64_t base = e * 16 * B + lane;
  T q[16], lap[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) q[p] = s[base + int64_t(p) * B];
  lap_wk(sD, q, sS, sS + 16, sS + 32, lap);
#pragma unroll
  for (int p = 0; p < 16; ++p) out[base + int64_t(p) * B] = lap[p];
}

template <typename T>
int launch_euler(const void* qdp, const void* u, const void* v,
                 const void* dp, const void* divdp, const void* met,
                 const void* qmin, const void* qmax, const void* deriv,
                 const void* dp0, const void* bih, void* out, void* qmin_o,
                 void* qmax_o, int E, int L, int nk, double dt,
                 double nu_coef, int bih_mode, int max_iter, double tol,
                 void* stream) {
  if (E <= 0 || L <= 0 || nk <= 0 || (bih_mode != 0 && bih_mode != 2))
    return int(cudaErrorInvalidValue);
  const dim3 grid(E, (L + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EULER_ARGS                                                        \
  (const T*)qdp, (const T*)u, (const T*)v, (const T*)dp, (const T*)divdp, \
      (const T*)met, (const T*)qmin, (const T*)qmax, (const T*)deriv,     \
      (const T*)dp0, (const T*)bih, (T*)out, (T*)qmin_o, (T*)qmax_o, L,   \
      nk, T(dt), T(nu_coef), max_iter, T(tol)
  if (bih_mode == 2)
    euler_kernel<T, true><<<grid, kThreads, 0, st>>>(EULER_ARGS);
  else
    euler_kernel<T, false><<<grid, kThreads, 0, st>>>(EULER_ARGS);
#undef EULER_ARGS
  return int(cudaGetLastError());
}

template <typename T>
int launch_laplace(const void* s, const void* met, const void* deriv,
                   void* out, int E, int B, void* stream) {
  if (E <= 0 || B <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(E, (B + kThreads - 1) / kThreads);
  laplace_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const T*)s, (const T*)met, (const T*)deriv, (T*)out, B);
  return int(cudaGetLastError());
}

}  // namespace

#define EULER_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* qdp, const void* u, const void* v,         \
                      const void* dp, const void* divdp, const void* met,    \
                      const void* qmin, const void* qmax, const void* deriv, \
                      const void* dp0, const void* bih, void* out,           \
                      void* qmin_o, void* qmax_o, int E, int L, int nk,      \
                      double dt, double nu_coef, int bih_mode, int max_iter, \
                      double tol, void* stream) {                            \
    return launch_euler<T>(qdp, u, v, dp, divdp, met, qmin, qmax, deriv,     \
                           dp0, bih, out, qmin_o, qmax_o, E, L, nk, dt,      \
                           nu_coef, bih_mode, max_iter, tol, stream);        \
  }

EULER_ENTRY(tse_fused_advect_limit_f32, float)
EULER_ENTRY(tse_fused_advect_limit_f64, double)

extern "C" int tse_laplace_wk_t_f32(const void* s, const void* met,
                                    const void* deriv, void* out, int E,
                                    int B, void* stream) {
  return launch_laplace<float>(s, met, deriv, out, E, B, stream);
}

extern "C" int tse_laplace_wk_t_f64(const void* s, const void* met,
                                    const void* deriv, void* out, int E,
                                    int B, void* stream) {
  return launch_laplace<double>(s, met, deriv, out, E, B, stream);
}
