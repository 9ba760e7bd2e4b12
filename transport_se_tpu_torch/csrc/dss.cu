// Face DSS with epilogues (K4), limiter-bound prep (K5) and neighbour
// min/max (K6) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_dss.py:_dss_face_kernel (reached
// through dss_face_pallas), :_minmax_kernel (through minmax_prep_pallas)
// and :_nbr_minmax_kernel (through neighbor_minmax_pallas).  Plain PyTorch
// versions and the tables: ops/dss_face.py.
//
// Layout: T layout [E, 16, L], lane = tracer*nk + level, elements in raster
// face order; level fields [E, 16, nk]; bounds [E, L]; metric pack
// [E, 10, 16] (ops/euler.py MET_ROWS, rows 7-9 the folded Laplacian metric).
//
// Bound on the H100: device-memory bytes.  All three kernels do a few
// operations per byte.  K4 reads the field once and writes it once (plus
// avg read, or the Laplacian written, in its fused variants: about 2.6 GB
// per launch at NE30 f32, ~0.8 ms); K5 reads it once (~0.26 ms); K6 moves
// two [E, L] bound arrays in and out (~0.07 ms).
//
// Design, against the TPU form: the Pallas kernel streams blocks of whole
// element rows of one face through VMEM, takes the in-face partners as
// shifted slices of the block, and DMAs seam ghost strips (with zero or
// +-inf padding rows for the cube vertices) beside each block.  Here a
// thread owns one (element, lane) column, as K1 does, and reads each
// partner value straight from device memory through a host-built table:
// K4's [E, 16, 3] role-ordered partner slots (x-edge partner, corner
// diagonal, y-edge partner; -1 where absent) and K6's [E, 9] neighbour
// elements (self-padded at cube vertices).  A block is one element's 128
// adjacent lanes, so every partner read of a warp is one coalesced row
// segment; the partner rows are other blocks' own rows and mostly hit L2.
// No row blocks, ghost strips, lane chunks or padding.
//
// K4 adds the terms of each slot in the DSS_STORE order of the Pallas
// kernel, (x + (S_x + d)) + S_y on the i = 0, 3 planes and x + S_y on the
// others, with absent terms as zeros; the Laplacian epilogue is the
// shared lap_wk of common.cuh.  Built with --fmad=false, so kernel and
// plain version agree to the last bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T partner(const T* __restrict__ x, int64_t slot,
                                     int L, int lane) {
  return slot >= 0 ? x[slot * L + lane] : T(0);
}

template <typename T, bool AVG, bool MINMAX, bool LAP>
__global__ void __launch_bounds__(kThreads)
dss_face_kernel(const T* __restrict__ x, const int64_t* __restrict__ part,
                const T* __restrict__ rsp, const T* __restrict__ avg,
                const T* __restrict__ dp, const T* __restrict__ met,
                const T* __restrict__ deriv, T* __restrict__ out,
                T* __restrict__ qmin, T* __restrict__ qmax,
                T* __restrict__ lap, int L, int nk) {
  __shared__ int64_t sP[48];
  __shared__ T sR[16];
  __shared__ T sS[48];
  __shared__ T sD[16];
  const int64_t e = blockIdx.x;
  for (int i = threadIdx.x; i < 48; i += blockDim.x) sP[i] = part[e * 48 + i];
  if (rsp != nullptr && threadIdx.x < 16)
    sR[threadIdx.x] = rsp[e * 16 + threadIdx.x];
  if (LAP) {
    for (int i = threadIdx.x; i < 48; i += blockDim.x)
      sS[i] = met[e * 160 + 112 + i];
    if (threadIdx.x < 16) sD[threadIdx.x] = deriv[threadIdx.x];
  }
  __syncthreads();
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int64_t base = e * 16 * L + lane;

  T res[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int i = p >> 2;
    const T xp = x[base + int64_t(p) * L];
    const T sy = partner(x, sP[p * 3 + 2], L, lane);
    if (i == 0 || i == 3) {
      const T sx = partner(x, sP[p * 3], L, lane);
      const T d = partner(x, sP[p * 3 + 1], L, lane);
      res[p] = (xp + (sx + d)) + sy;
    } else {
      res[p] = xp + sy;
    }
  }
  if (rsp != nullptr) {
#pragma unroll
    for (int p = 0; p < 16; ++p) res[p] = res[p] * sR[p];
  }
  if (AVG) {
    // the fused qdp_time_avg, times 1/3 as dss_face_pallas evaluates its
    // "/ 3" (XLA folds a division by a constant into its reciprocal)
    const T third = T(1) / T(3);
#pragma unroll
    for (int p = 0; p < 16; ++p)
      res[p] = (avg[base + int64_t(p) * L] + T(2) * res[p]) * third;
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) out[base + int64_t(p) * L] = res[p];
  if (MINMAX) {
    const int64_t lbase = e * 16 * nk + lane % nk;
    T q[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) q[p] = res[p] / dp[lbase + p * nk];
    T mn = q[0], mx = q[0];
#pragma unroll
    for (int p = 1; p < 16; ++p) {
      mn = q[p] < mn ? q[p] : mn;
      mx = q[p] > mx ? q[p] : mx;
    }
    qmin[e * L + lane] = mn;
    qmax[e * L + lane] = mx;
    if (LAP) {
      T w[16];
      tse::lap_wk(sD, q, sS, sS + 16, sS + 32, w);
#pragma unroll
      for (int p = 0; p < 16; ++p) lap[base + int64_t(p) * L] = w[p];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
minmax_kernel(const T* __restrict__ x, const T* __restrict__ dp,
              T* __restrict__ qmin, T* __restrict__ qmax, int L, int nk) {
  const int64_t e = blockIdx.x;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int64_t base = e * 16 * L + lane;
  const int64_t lbase = e * 16 * nk + lane % nk;
  T mn = x[base] / dp[lbase], mx = mn;
#pragma unroll
  for (int p = 1; p < 16; ++p) {
    const T q = x[base + int64_t(p) * L] / dp[lbase + p * nk];
    mn = q < mn ? q : mn;
    mx = q > mx ? q : mx;
  }
  qmin[e * L + lane] = mn;
  qmax[e * L + lane] = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nbr_minmax_kernel(const T* __restrict__ qmin, const T* __restrict__ qmax,
                  const int64_t* __restrict__ nbr, T* __restrict__ gmin,
                  T* __restrict__ gmax, int L) {
  __shared__ int64_t sN[9];
  const int64_t e = blockIdx.x;
  if (threadIdx.x < 9) sN[threadIdx.x] = nbr[e * 9 + threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  T mn = qmin[e * L + lane], mx = qmax[e * L + lane];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const T a = qmin[sN[k] * L + lane];
    const T b = qmax[sN[k] * L + lane];
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  gmin[e * L + lane] = mn;
  gmax[e * L + lane] = mx;
}

// flags: 1 avg, 2 min/max of out/dp, 4 Laplacian of out/dp (needs 2)
template <typename T>
int launch_dss_face(const void* x, const void* part, const void* rsp,
                    const void* avg, const void* dp, const void* met,
                    const void* deriv, void* out, void* qmin, void* qmax,
                    void* lap, int E, int L, int nk, int flags,
                    void* stream) {
  if (E <= 0 || L <= 0 || nk <= 0 || flags < 0 || flags > 7 ||
      ((flags & 4) && !(flags & 2)) || ((flags & 3) && rsp == nullptr))
    return int(cudaErrorInvalidValue);
  const dim3 grid(E, (L + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSS_ARGS                                                            \
  (const T*)x, (const int64_t*)part, (const T*)rsp, (const T*)avg,          \
      (const T*)dp, (const T*)met, (const T*)deriv, (T*)out, (T*)qmin,      \
      (T*)qmax, (T*)lap, L, nk
#define DSS_CASE(F, A, M, P)                                                \
  case F:                                                                   \
    dss_face_kernel<T, A, M, P><<<grid, kThreads, 0, st>>>(DSS_ARGS);       \
    break;
  switch (flags) {
    DSS_CASE(0, false, false, false)
    DSS_CASE(1, true, false, false)
    DSS_CASE(2, false, true, false)
    DSS_CASE(3, true, true, false)
    DSS_CASE(6, false, true, true)
    DSS_CASE(7, true, true, true)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef DSS_CASE
#undef DSS_ARGS
  return int(cudaGetLastError());
}

template <typename T>
int launch_minmax(const void* x, const void* dp, void* qmin, void* qmax,
                  int E, int L, int nk, void* stream) {
  if (E <= 0 || L <= 0 || nk <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(E, (L + kThreads - 1) / kThreads);
  minmax_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const T*)x, (const T*)dp, (T*)qmin, (T*)qmax, L, nk);
  return int(cudaGetLastError());
}

template <typename T>
int launch_nbr_minmax(const void* qmin, const void* qmax, const void* nbr,
                      void* gmin, void* gmax, int E, int L, void* stream) {
  if (E <= 0 || L <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(E, (L + kThreads - 1) / kThreads);
  nbr_minmax_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          (const T*)qmin, (const T*)qmax, (const int64_t*)nbr, (T*)gmin,
          (T*)gmax, L);
  return int(cudaGetLastError());
}

}  // namespace

#define DSS_ENTRIES(SUFFIX, T)                                               \
  extern "C" int tse_dss_face_##SUFFIX(                                      \
      const void* x, const void* part, const void* rsp, const void* avg,     \
      const void* dp, const void* met, const void* deriv, void* out,         \
      void* qmin, void* qmax, void* lap, int E, int L, int nk, int flags,    \
      void* stream) {                                                        \
    return launch_dss_face<T>(x, part, rsp, avg, dp, met, deriv, out, qmin,  \
                              qmax, lap, E, L, nk, flags, stream);           \
  }                                                                          \
  extern "C" int tse_minmax_prep_##SUFFIX(const void* x, const void* dp,     \
                                          void* qmin, void* qmax, int E,     \
                                          int L, int nk, void* stream) {     \
    return launch_minmax<T>(x, dp, qmin, qmax, E, L, nk, stream);            \
  }                                                                          \
  extern "C" int tse_neighbor_minmax_##SUFFIX(                               \
      const void* qmin, const void* qmax, const void* nbr, void* gmin,       \
      void* gmax, int E, int L, void* stream) {                              \
    return launch_nbr_minmax<T>(qmin, qmax, nbr, gmin, gmax, E, L, stream);  \
  }

DSS_ENTRIES(f32, float)
DSS_ENTRIES(f64, double)
