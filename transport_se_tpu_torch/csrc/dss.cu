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
// per launch at NE30 f32, ~0.8 ms); K5 reads it and dp once and writes
// two [E, L] bounds (~0.30 ms); K6 moves two [E, L] bound arrays in and
// out (~0.07 ms).
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
// K5 takes K7's min/max form (band.cu).  Its first form, a thread per
// column with 16 IEEE divisions and 16 reads of dp[e, p, lane % nk] (each
// shared by the column's nq tracers), took 0.68-0.72 ms f32 / 1.03-1.11
// f64 at NE30 on an H100, 42% of its bound.
// Now a block takes an element and a group of its lanes; a prologue puts
// dp and its reciprocal into shared memory once per element and group,
// each thread owns 2 adjacent lanes in vector accesses, and q = x/dp runs
// inline (see minmax_kernel).
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

// K5's launch shape, as K7's min/max variant takes it: lanes a thread
// (vector accesses where L, nk and the pointers allow, else one), threads
// a block, lane passes a block (one dp prologue each).  Measured at NE30
// with k5_variants (PERF.md): 2 lanes a thread beat 4 in f32 and f64.
constexpr int kMinmaxVec = 2;
constexpr int kMinmaxThreads = 128;
constexpr int kMinmaxPasses = 4;
// measuring switches (k5_variants): q = x/dp by the IEEE division
// throughout; the bounds stored with the evict-first hint (st.global.cs)
constexpr bool kMinmaxIeeeDivide = false;
constexpr bool kMinmaxStreamStores = true;
constexpr int kSmemMax = 227 * 1024;

// dp and its reciprocal at one (point, level)
template <typename T>
struct DpRecip {
  T d, y;
};

// A block takes one element and a group of its lanes; a prologue puts the
// element's dp [16, nk] and its reciprocals into shared memory, then each
// thread owns V adjacent lanes (levels lev..lev+V-1 of one tracer: V
// divides nk and the lane) and walks the group's lanes in passes of
// threads*V.  q = x/dp runs inline (tse::div_by with the prologue's
// reciprocal), which gives the IEEE quotient while x lies in common.cuh's
// range (or is +0) and dp does; a thread whose x leaves it, or a block
// whose dp does, divides its columns with IEEE divisions.  The min and the
// max run over p = 0..15 in point order with strict comparisons, so of
// equal values (-0 and +0) the first point's is kept.
template <typename T, int V>
__global__ void __launch_bounds__(kMinmaxThreads)
minmax_kernel(const T* __restrict__ x, const T* __restrict__ dp,
              T* __restrict__ qmin, T* __restrict__ qmax, int L, int nk,
              int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  DpRecip<T>* sQ = reinterpret_cast<DpRecip<T>*>(smem);  // [16][nk]
  const int64_t e = blockIdx.x / groups;
  const int g = int(blockIdx.x - e * groups);
  const int tid = threadIdx.x;
  const int bd = blockDim.x;

  const T* dpe = dp + e * 16 * nk;
  bool slow_dp = false;
  for (int i = tid; i < 16 * nk; i += bd) {
    const T d = dpe[i];
    slow_dp |= tse::outside(d, tse::Bits<T>::d_lo, tse::Bits<T>::d_hi);
    sQ[i] = {d, tse::recip(d)};
  }
  slow_dp = __syncthreads_or(slow_dp) != 0 || kMinmaxIeeeDivide;

  const T* __restrict__ xe = x + e * 16 * L;
  for (int lane = (g * bd + tid) * V; lane < L; lane += groups * bd * V) {
    T q[16][V];
#pragma unroll
    for (int p = 0; p < 16; ++p)
      tse::load_v<V>(xe + int64_t(p) * L + lane, q[p]);
    const int lev = lane % nk;
    bool slow = slow_dp;
#pragma unroll
    for (int p = 0; p < 16; ++p)
#pragma unroll
      for (int v = 0; v < V; ++v)
        slow |= tse::outside_abs(q[p][v], tse::Bits<T>::q_lo,
                                 tse::Bits<T>::q_hi);
    if (!slow) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const DpRecip<T> a = sQ[p * nk + lev + v];
          q[p][v] = tse::div_by(q[p][v], a.d, a.y);
        }
    } else {
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v)
          q[p][v] = q[p][v] / sQ[p * nk + lev + v].d;
    }
    T mn[V], mx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mn[v] = q[0][v];
      mx[v] = q[0][v];
    }
#pragma unroll
    for (int p = 1; p < 16; ++p)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mn[v] = q[p][v] < mn[v] ? q[p][v] : mn[v];
        mx[v] = q[p][v] > mx[v] ? q[p][v] : mx[v];
      }
    tse::store_v<kMinmaxStreamStores, V>(qmin + e * L + lane, mn);
    tse::store_v<kMinmaxStreamStores, V>(qmax + e * L + lane, mx);
  }
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

// Launches K5 at lane width V; with config, fills config[5] = {lanes a
// thread, threads a block, lane groups an element, dynamic shared bytes a
// block, resident blocks per SM} instead
template <typename T, int V>
int run_minmax(const T* x, const T* dp, T* qmin, T* qmax, int E, int L,
               int nk, cudaStream_t st, int* config) {
  constexpr int threads = kMinmaxThreads;
  auto kernel = minmax_kernel<T, V>;
  const size_t smem = size_t(16) * nk * sizeof(DpRecip<T>);
  if (smem > size_t(kSmemMax)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int chunks = (L + threads * V - 1) / (threads * V);
  const int groups = (chunks + kMinmaxPasses - 1) / kMinmaxPasses;
  if (config != nullptr) {
    int resident = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, threads, smem);
    if (err != cudaSuccess) return int(err);
    config[0] = V;
    config[1] = threads;
    config[2] = groups;
    config[3] = int(smem);
    config[4] = resident;
    return 0;
  }
  const long long blocks = (long long)E * groups;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), threads, smem, st>>>(x, dp, qmin, qmax, L, nk,
                                                  groups);
  return int(cudaGetLastError());
}

template <int V, typename T>
bool aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (V * sizeof(T)) == 0;
}

// The vector width where L, nk and the pointers allow it, else one lane a
// thread (null pointers: the launch shape for aligned fields)
template <typename T>
int launch_minmax(const void* x, const void* dp, void* qmin, void* qmax,
                  int E, int L, int nk, void* stream, int* config = nullptr) {
  if (E <= 0 || L <= 0 || nk <= 0) return int(cudaErrorInvalidValue);
  constexpr int V = kMinmaxVec;
  const T *xt = (const T*)x, *dpt = (const T*)dp;
  T *mn = (T*)qmin, *mx = (T*)qmax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V > 1 && L % V == 0 && nk % V == 0 && aligned<V>(xt) &&
      aligned<V>(mn) && aligned<V>(mx))
    return run_minmax<T, V>(xt, dpt, mn, mx, E, L, nk, st, config);
  return run_minmax<T, 1>(xt, dpt, mn, mx, E, L, nk, st, config);
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
  /* out[5]: K5's launch shape for aligned fields */                         \
  extern "C" int tse_minmax_config_##SUFFIX(int L, int nk, int* out) {       \
    return launch_minmax<T>(nullptr, nullptr, nullptr, nullptr, 1, L, nk,    \
                            nullptr, out);                                   \
  }                                                                          \
  extern "C" int tse_neighbor_minmax_##SUFFIX(                               \
      const void* qmin, const void* qmax, const void* nbr, void* gmin,       \
      void* gmax, int E, int L, void* stream) {                              \
    return launch_nbr_minmax<T>(qmin, qmax, nbr, gmin, gmax, E, L, stream);  \
  }

DSS_ENTRIES(f32, float)
DSS_ENTRIES(f64, double)
