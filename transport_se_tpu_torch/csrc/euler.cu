// Fused euler stage (K1) and weak Laplacian (K2) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_euler.py:585 _euler_kernel3
// (reached through fused_advect_limit :803; its alternates _euler_kernel
// :453 and _euler_kernel2 :345 compute the same function) and :747
// _laplace_kernel (through laplace_wk_t).  Plain PyTorch versions:
// ops/euler.py.
//
// Layout: T layout [E, 16, L], lane = tracer*nk + level; level fields
// [E, 16, nk]; metric pack [E, 10, 16] (ops/euler.py MET_ROWS).
//
// K1's bound on the H100: device-memory bytes.  It reads Qdp (and bih on
// stage 2) and writes the limited output once, 2-3 passes over the field
// (NE30 f32, 35 x 72 lanes: 0.52-0.78 ms at 3.35 TB/s, mean 0.702 over the
// three stage kinds); its arithmetic is far below the card's rate.  A
// column (element, lane) is the 16 points of one tracer-level; every
// operation of the stage is local to a column.
//
// The first form (a thread per column, a block per 128-lane tile of an
// element) took 4.42 ms f32 / 9.26 ms f64 there, 16% / 15% of the bound
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 3).  Four causes, and
// what this form does about each:
//  1. Per-level work was redone for every tracer: each column loaded its
//     level's dp, u, v, divdp at 16 points and did 32 divisions (1/dp,
//     1/dp_star) and the sum of the limiter weights c, all of which depend
//     on (point, level) only.  Here a block owns one element (or a group of
//     its lanes when the elements alone would leave SMs idle) and computes
//     them once in its prologue into dynamic shared memory: a record per
//     level of u/dp, v/dp, c = spheremp*dp_star and 1/dp_star at the 16
//     points, sum16(c), and on stage 2 nu_coef*dp0 (and 1/spheremp per
//     point), each with the operations of the per-column form, so the bits
//     are the same.  The lane loop divides only in the limiter.
//  2. Registers: 109 (f32) and 210-220 (f64) at 128 threads, 25% / 12.5%
//     occupancy.  Here a thread reads its level record at fixed offsets
//     from one base register, and the element's metric rows and derivative
//     stay in shared memory (opaque_zero).  python -m
//     transport_se_tpu_torch.k1_variants measures the choices (same card,
//     means over the stage kinds): f32 1.174 ms at 80 registers (3 blocks
//     of 256, 37.5% occupancy, 8-20 B spilled), 1.373 ms at 64 (4 blocks,
//     50%, 128-148 B spilled), 1.251 ms at 119-120 (no spill); f64 2.030
//     ms at 128 (2 blocks, 100 B spilled), 2.398 ms at 166-222.  So
//     __launch_bounds__ asks 3 blocks in f32 and 2 in f64.
//  3. Each 128-lane block reloaded the 160-value metric pack and synced:
//     108,000 prologues at NE30.  Here 5400, each the level work of 35
//     tracers.
//  4. A warp runs the limiter as long as its slowest column.  Intrinsic
//     (the iteration is the plain version's, bit for bit).  Its passes
//     after the first cost 7-21% of K1 at f32's cap of 4 and 2-7% in f64
//     at 15 (chip_smoke.py phase 3, times at caps 1, 2, 4 and 15).
//
// Threads of a warp take consecutive lanes, so the 16 point loads and
// stores of Qdp, bih and the output are coalesced 128-byte (f32)
// transactions, and read the records of consecutive levels k = lane % nk,
// whose odd length (kRec) puts them on distinct banks, except where a warp
// wraps from level nk-1 to 0 (a few two-way conflicts, left unpadded).  A
// column's result depends only on its element's inputs, not on which
// elements share the launch (the face+overlap path re-runs K1 on the
// boundary elements and needs the same bits).
//
// The limiter loop (tse::limiter_iterate, shared with the row limiter K10)
// exits per column as soon as the column converges: converged columns are
// fixed points of the clip-redistribute body, so this equals the JAX
// package's group while_loop and its full unroll.
//
// K1 has a counting form (COUNT, launched where the caller passes a
// counter buffer; ops/euler.py does so inside counters.counting()): over
// its valid columns it adds the limiter's passes, the columns and the
// columns stopped at the cap unconverged, reduced in the block and added
// by one atomic a counter into one of `slots` rows of the buffer (the
// block's index modulo slots), so that many blocks do not queue on three
// addresses.  The form without counting carries none of it: its
// instructions, registers and bits are those of a kernel without counters.
// Every 16-point sum uses the _sum16 pairwise tree; every 4x4 derivative
// sums its terms in the JAX roll order (common.cuh).  Built with
// --fmad=false so each product and sum rounds as in the plain version.

#include <algorithm>

#include "common.cuh"

namespace {

using tse::ddx_rot;
using tse::ddy_rot;
using tse::kRRearth;
using tse::lap_wk;
using tse::limiter_iterate;
using tse::sum16;

constexpr int kThreads = 128;        // K2
constexpr int kEulerThreads = 256;   // K1
// K1's resident blocks per SM, asked of ptxas (a register cap of
// 65536 / (256 * blocks): 80 in f32, 128 in f64; see the note above) and
// aimed at when few elements fill the card
template <typename T>
struct EulerBlocks {
  static constexpr int value = sizeof(T) == 4 ? 3 : 2;
};

// Shared memory of K1 (in elements of T): metric pack, derivative,
// 1/spheremp, then one record of kRec per level: u/dp, v/dp, c and
// 1/dp_star at the 16 points, sumc, nu_coef*dp0.  A thread reads its
// level's record at fixed offsets from one base register; the odd record
// length puts the records of a warp's consecutive levels on distinct banks.
constexpr int kD = 160, kRsp = 176, kLevel = 192;
constexpr int kUs = 0, kVs = 16, kC = 32, kRd = 48, kSumc = 64, kNd = 65;
constexpr int kRec = 67;
inline size_t euler_smem_elems(int nk) { return kLevel + kRec * size_t(nk); }

// An opaque 0.  The metric rows and the derivative are the same for every
// lane of the block, so the compiler hoists their shared-memory loads out
// of the lane loop into registers and, at the register cap, spills them to
// local memory (k1_variants' no_opaque: 208-1276 B spilled, 1.8x the time
// in f32 and 2.9x in f64).  Offsetting their base by this value in each
// pass keeps them in shared memory, read where they are used.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.b32 %0, 0;" : "=r"(z));
  return z;
}

// The block's sums of a, b and c added to row (block index % slots) of
// counts [slots, 3]; every thread of the block calls it.
__device__ __forceinline__ void count_block(unsigned long long* counts,
                                            int slots, int a, int b, int c) {
  __shared__ int part[3][kEulerThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long sum = 0;
    for (int w = 0; w < kEulerThreads / 32; ++w) sum += part[threadIdx.x][w];
    const int64_t slot = (int64_t(blockIdx.y) * gridDim.x + blockIdx.x) % slots;
    atomicAdd(counts + slot * 3 + threadIdx.x, sum);
  }
}

template <typename T, bool BIH, bool COUNT>
__global__ void __launch_bounds__(kEulerThreads, EulerBlocks<T>::value)
euler_kernel(const T* __restrict__ qdp, const T* __restrict__ u,
             const T* __restrict__ v, const T* __restrict__ dp,
             const T* __restrict__ divdp, const T* __restrict__ met,
             const T* __restrict__ qmin, const T* __restrict__ qmax,
             const T* __restrict__ deriv, const T* __restrict__ dp0,
             const T* __restrict__ bih, T* __restrict__ out,
             T* __restrict__ qmin_out, T* __restrict__ qmax_out, int L,
             int nk, int group_lanes, T dt, T nu_coef, int max_iter,
             T tol_rel, unsigned long long* __restrict__ counts, int slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const srec = sm + kLevel;
  const int64_t e = blockIdx.x;
  const T one = T(1);

  // ---- prologue: everything that depends on (point, level) only ----
  for (int i = threadIdx.x; i < 160; i += blockDim.x) sm[i] = met[e * 160 + i];
  if (threadIdx.x < 16) sm[kD + threadIdx.x] = deriv[threadIdx.x];
  __syncthreads();
  const int64_t lb = e * 16 * nk;
  for (int i = threadIdx.x; i < 16 * nk; i += blockDim.x) {
    const int p = i / nk;
    T* const rec = srec + (i - p * nk) * kRec;
    const T dpi = dp[lb + i];
    const T rdp = one / dpi;
    rec[kUs + p] = u[lb + i] * rdp;
    rec[kVs + p] = v[lb + i] * rdp;
    const T dps = dpi - dt * divdp[lb + i];
    rec[kC + p] = sm[96 + p] * dps;
    rec[kRd + p] = one / dps;
  }
  if (BIH) {
    if (threadIdx.x < 16)
      sm[kRsp + threadIdx.x] = one / sm[96 + threadIdx.x];
    for (int k = threadIdx.x; k < nk; k += blockDim.x)
      srec[k * kRec + kNd] = nu_coef * dp0[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    T c[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) c[p] = srec[k * kRec + kC + p];
    srec[k * kRec + kSumc] = sum16(c);
  }
  __syncthreads();

  // ---- one column per thread and pass over the block's lanes ----
  const T rr = T(kRRearth);
  [[maybe_unused]] int n_pass = 0, n_cols = 0, n_capped = 0;  // COUNT
  const int lane_end = min(L, int(blockIdx.y + 1) * group_lanes);
  for (int lane = blockIdx.y * group_lanes + threadIdx.x; lane < lane_end;
       lane += blockDim.x) {
    const T* const rec = srec + (lane % nk) * kRec;
    const int64_t base = e * 16 * L + lane;
    const T* const m = sm + opaque_zero();
    const T* const D = m + kD;
    const T* d00 = m;
    const T* d01 = m + 16;
    const T* d10 = m + 32;
    const T* d11 = m + 48;
    const T* metdet = m + 64;
    const T* rmetdet = m + 80;
    const T* sp = m + 96;

    // advection RHS: qtens = qdp - dt * div(Vstar qdp)
    T q[16];
    {
      T c1[16], c2[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const T qp = qdp[base + int64_t(p) * L];
        const T gu = rec[kUs + p] * qp;
        const T gv = rec[kVs + p] * qp;
        c1[p] = (d00[p] * gu + d01[p] * gv) * metdet[p];
        c2[p] = (d10[p] * gu + d11[p] * gv) * metdet[p];
        q[p] = qp;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = a * 4 + b;
          const T div = ((ddx_rot<T, false>(D, c1, a, b) +
                          ddy_rot<T, false>(D, c2, a, b)) *
                         rmetdet[p]) * rr;
          q[p] = q[p] - dt * div;
        }
      }
    }
    if (BIH) {
      // stage-2 hyperviscosity: second weak Laplacian of the DSS'd first
      T b[16], lap[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) b[p] = bih[base + int64_t(p) * L];
      lap_wk(D, b, m + 112, m + 128, m + 144, lap);
      const T nd = rec[kNd];
      const T* const rsp = m + kRsp;
#pragma unroll
      for (int p = 0; p < 16; ++p) q[p] = q[p] + (nd * lap[p]) * rsp[p];
    }

    // limiter 8 on x = qtens / dp_star
    const T* const c = rec + kC;
    const T sumc = rec[kSumc];
    const bool valid = sumc > T(0);
    if (!valid) {
#pragma unroll
      for (int p = 0; p < 16; ++p) out[base + int64_t(p) * L] = q[p] * sp[p];
    }
    T x[16], cx[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) x[p] = q[p] * rec[kRd + p];
#pragma unroll
    for (int p = 0; p < 16; ++p) cx[p] = c[p] * x[p];
    const T mass = sum16(cx);
    const T safe = valid ? sumc : one;
    const int64_t brow = e * L + lane;
    T mn = qmin[brow];
    T mx = qmax[brow];
    mn = mass < mn * safe ? mass / safe : mn;
    mx = mass > mx * safe ? mass / safe : mx;
    qmin_out[brow] = mn;
    qmax_out[brow] = mx;
    if (!valid) continue;
    [[maybe_unused]] const int conv =
        limiter_iterate(x, c, mn, mx, tol_rel * fabs(mass), max_iter);
    if constexpr (COUNT) {
      n_pass += conv > 0 ? conv : max_iter;
      n_cols += 1;
      n_capped += conv == 0;
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) out[base + int64_t(p) * L] = x[p] * c[p];
  }
  if constexpr (COUNT) count_block(counts, slots, n_pass, n_cols, n_capped);
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

// K1's launch: a block per element, its lanes split into groups of whole
// 256-lane passes only when the elements alone would leave SMs idle
template <typename T, bool BIH, bool COUNT>
int launch_euler_kernel(const void* qdp, const void* u, const void* v,
                        const void* dp, const void* divdp, const void* met,
                        const void* qmin, const void* qmax, const void* deriv,
                        const void* dp0, const void* bih, void* out,
                        void* qmin_o, void* qmax_o, int E, int L, int nk,
                        double dt, double nu_coef, int max_iter, double tol,
                        void* counts, int slots, cudaStream_t st) {
  const size_t smem = euler_smem_elems(nk) * sizeof(T);
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(smem_max)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(euler_kernel<T, BIH, COUNT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int passes = (L + kEulerThreads - 1) / kEulerThreads;
  const int want = EulerBlocks<T>::value * sms;
  const int groups = E >= want ? 1 : std::min(passes, (want + E - 1) / E);
  const int group_lanes = (passes + groups - 1) / groups * kEulerThreads;
  const dim3 grid(E, (L + group_lanes - 1) / group_lanes);
  euler_kernel<T, BIH, COUNT><<<grid, kEulerThreads, smem, st>>>(
      (const T*)qdp, (const T*)u, (const T*)v, (const T*)dp, (const T*)divdp,
      (const T*)met, (const T*)qmin, (const T*)qmax, (const T*)deriv,
      (const T*)dp0, (const T*)bih, (T*)out, (T*)qmin_o, (T*)qmax_o, L, nk,
      group_lanes, T(dt), T(nu_coef), max_iter, T(tol),
      (unsigned long long*)counts, slots);
  return int(cudaGetLastError());
}

template <typename T>
int launch_euler(const void* qdp, const void* u, const void* v,
                 const void* dp, const void* divdp, const void* met,
                 const void* qmin, const void* qmax, const void* deriv,
                 const void* dp0, const void* bih, void* out, void* qmin_o,
                 void* qmax_o, int E, int L, int nk, double dt,
                 double nu_coef, int bih_mode, int max_iter, double tol,
                 void* stream, void* counts, int slots) {
  if (E <= 0 || L <= 0 || nk <= 0 || (bih_mode != 0 && bih_mode != 2) ||
      (counts != nullptr && slots <= 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bih2 = bih_mode == 2, count = counts != nullptr;
  return (bih2 ? (count ? launch_euler_kernel<T, true, true>
                        : launch_euler_kernel<T, true, false>)
               : (count ? launch_euler_kernel<T, false, true>
                        : launch_euler_kernel<T, false, false>))(
      qdp, u, v, dp, divdp, met, qmin, qmax, deriv, dp0, bih, out, qmin_o,
      qmax_o, E, L, nk, dt, nu_coef, max_iter, tol, counts, slots, st);
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
                      double tol, void* stream, void* counts, int slots) {   \
    return launch_euler<T>(qdp, u, v, dp, divdp, met, qmin, qmax, deriv,     \
                           dp0, bih, out, qmin_o, qmax_o, E, L, nk, dt,      \
                           nu_coef, bih_mode, max_iter, tol, stream, counts, \
                           slots);                                           \
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
