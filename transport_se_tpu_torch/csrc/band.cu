// Banded face DSS of one shard with epilogues (K7) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_band.py:38 _band_kernel (with its
// XLA prep _band_prep_lite :227, reached through dss_band_pallas :268).
// Plain PyTorch version and wrapper: ops/band.py; tables:
// parallel/face_sharded.py.
//
// What it computes: for the shard's local elements x [eloc, 16, L] (T
// layout, lane = tracer*nk + level) and the halo-extended array
// ext = cat([x, halo]), every slot's DSS sum with its coincident slots,
// local or remote, then optionally times rspheremp [eloc, 16], the min/max
// over the 16 points of q = out/dp (dp [eloc, 16, nk], lane l holds level
// l % nk) and the weak Laplacian of q with the folded metric rows of the
// metric pack met [eloc, 10, 16].  Per slot the terms add in the band's
// order: ((x + x partner) + y partner) + corner on the i = 0, 3 planes and
// x + y partner on the others, absent terms as zeros, so the result equals
// the banded shifted-slice assembly (parallel/face_sharded.py) to the bit.
//
// Bound on the H100: device-memory bytes.  A launch reads the field once
// and writes it once, plus dp and the two [eloc, L] bounds, plus the
// Laplacian field: at NE30 f32 with 35 x 72 lanes and one shard holding the
// sphere 1.74 GB raw (0.52 ms at 3.35 TB/s), 1.87 GB with min/max
// (0.56 ms), 2.75 GB with the Laplacian (0.82 ms), the floors of K4.
//
// Design, against the TPU form: the Pallas kernel streams row-aligned
// bands of whole element rows through VMEM.  To get them it rebuilds the
// band from head/tail gathers and a dynamic_slice at the shard's row
// offset, derives the +-y partner rows in kernel under per-row face-
// transition masks, adds the y-seam patch strips under pl.when, and pads
// lanes to 128.  None of that carries over.  As in K4 (csrc/dss.cu), a
// thread owns one (local element, lane) column and keeps its 16 points in
// registers; each partner value is read straight from device memory
// through a host-built [eloc, 16, 3] int32 role table of flat slots of
// ext (parallel/face_sharded.py band_roles): slots below eloc*16 are read
// from x, the others from the halo, so ext is never assembled.  A block is
// one element's 128 adjacent lanes, so every partner read of a warp is
// one coalesced row segment.  Built with --fmad=false: kernel and plain
// version agree to the last bit, the Laplacian included.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T ext_at(const T* __restrict__ x,
                                    const T* __restrict__ halo, int32_t slot,
                                    int64_t nloc, int L, int lane) {
  if (slot < 0) return T(0);
  const int64_t s = slot;
  return s < nloc ? x[s * L + lane] : halo[(s - nloc) * L + lane];
}

template <typename T, bool SCALE, bool MINMAX, bool LAP>
__global__ void __launch_bounds__(kThreads)
dss_band_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                const int32_t* __restrict__ role, const T* __restrict__ rsp,
                const T* __restrict__ dp, const T* __restrict__ met,
                const T* __restrict__ deriv, T* __restrict__ out,
                T* __restrict__ qmin, T* __restrict__ qmax,
                T* __restrict__ lap, int L, int nk, int64_t nloc) {
  __shared__ int32_t sP[48];
  __shared__ T sR[16];
  __shared__ T sS[48];
  __shared__ T sD[16];
  const int64_t e = blockIdx.x;
  for (int i = threadIdx.x; i < 48; i += blockDim.x) sP[i] = role[e * 48 + i];
  if (SCALE && threadIdx.x < 16) sR[threadIdx.x] = rsp[e * 16 + threadIdx.x];
  if (LAP) {
    // rows 7-9 of the metric pack: the folded metric s00, s01, s11
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
    const T sy = ext_at(x, halo, sP[p * 3 + 1], nloc, L, lane);
    if (i == 0 || i == 3) {
      const T sx = ext_at(x, halo, sP[p * 3], nloc, L, lane);
      const T d = ext_at(x, halo, sP[p * 3 + 2], nloc, L, lane);
      res[p] = ((xp + sx) + sy) + d;
    } else {
      res[p] = xp + sy;
    }
  }
  if (SCALE) {
#pragma unroll
    for (int p = 0; p < 16; ++p) res[p] = res[p] * sR[p];
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

// flags: 1 scale by rsp, 2 min/max of out/dp (needs 1), 4 Laplacian of
// out/dp (needs 2)
template <typename T>
int launch_dss_band(const void* x, const void* halo, const void* role,
                    const void* rsp, const void* dp, const void* met,
                    const void* deriv, void* out, void* qmin, void* qmax,
                    void* lap, int E, int L, int nk, int flags,
                    void* stream) {
  if (E <= 0 || L <= 0 || nk <= 0 || (flags != 0 && flags != 1 &&
                                      flags != 3 && flags != 7))
    return int(cudaErrorInvalidValue);
  const dim3 grid(E, (L + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nloc = int64_t(E) * 16;
#define BAND_ARGS                                                           \
  (const T*)x, (const T*)halo, (const int32_t*)role, (const T*)rsp,         \
      (const T*)dp, (const T*)met, (const T*)deriv, (T*)out, (T*)qmin,      \
      (T*)qmax, (T*)lap, L, nk, nloc
#define BAND_CASE(F, S, M, P)                                               \
  case F:                                                                   \
    dss_band_kernel<T, S, M, P><<<grid, kThreads, 0, st>>>(BAND_ARGS);      \
    break;
  switch (flags) {
    BAND_CASE(0, false, false, false)
    BAND_CASE(1, true, false, false)
    BAND_CASE(3, true, true, false)
    BAND_CASE(7, true, true, true)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef BAND_CASE
#undef BAND_ARGS
  return int(cudaGetLastError());
}

}  // namespace

#define BAND_ENTRY(SUFFIX, T)                                                \
  extern "C" int tse_dss_band_##SUFFIX(                                      \
      const void* x, const void* halo, const void* role, const void* rsp,    \
      const void* dp, const void* met, const void* deriv, void* out,         \
      void* qmin, void* qmax, void* lap, int E, int L, int nk, int flags,    \
      void* stream) {                                                        \
    return launch_dss_band<T>(x, halo, role, rsp, dp, met, deriv, out, qmin, \
                              qmax, lap, E, L, nk, flags, stream);           \
  }

BAND_ENTRY(f32, float)
BAND_ENTRY(f64, double)
