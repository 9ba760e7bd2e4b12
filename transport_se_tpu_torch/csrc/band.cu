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
// x + y partner on the others, absent terms as +0, then + 0: the plain
// version's chain always holds an absent term, so it never ends on -0,
// and the final + 0 gives the same zero here.  The result equals the
// banded shifted-slice assembly (parallel/face_sharded.py) to the bit.
//
// Limits: the prologue holds dp and its reciprocal for every (point,
// level) of an element in shared memory, so nk <= 887 (f32) / 443 (f64);
// beyond that the launch returns cudaErrorInvalidValue and the wrapper
// raises.
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
// lanes to 128.  None of that carries over.  Here a block takes one
// element and a group of its lanes:
//   - a prologue computes once into shared memory what depends only on
//     the element: the 48 partner slots of the host-built [eloc, 16, 3]
//     int32 role table (parallel/face_sharded.py band_roles) resolved to
//     row pointers into x or the halo (null: absent), so ext is never
//     assembled and no lane selects between x and the halo; rspheremp;
//     the metric rows s00, s01, s11 and the derivative matrix; and for
//     each (point, level) dp with its reciprocal for the inline division.
//     Whether every dp of the element lies in the division's range is
//     reduced by the prologue's barrier (__syncthreads_or);
//   - each thread then owns V adjacent lanes of the element (vector loads
//     and stores where L, nk and the pointers allow, else V = 1) and
//     keeps their 16 points in registers; a block walks its lanes in
//     passes of threads*V lanes;
//   - q = out/dp runs inline: nvcc's own fast-path operations with the
//     prologue's reciprocal (tse::div_by, shared with K3), which give the
//     IEEE quotient while out lies in the range of common.cuh (or is +0)
//     and dp does.  A thread whose operands leave the range divides its
//     columns with IEEE divisions instead: out is still in registers, so
//     nothing is read again, and only a warp that holds such a column
//     pays for it;
//   - the Laplacian epilogue runs lane by lane (tse::lap_wk, K2's and
//     K4's operation order) on the column's quotients;
//   - every output is stored with the evict-first hint.  Plain stores left
//     nvcc free to keep a whole pass's loads in flight at up to 255
//     registers a thread (2 blocks an SM); the hinted stores bound that
//     (72-128 registers with one or two lanes a thread), and keep the
//     outputs from pushing the partner rows out of L2.
// The launch shape (V, threads, resident blocks, passes) is set per dtype
// and variant in Shape below from measurements (k7_variants.py, PERF.md).
// Built with --fmad=false: kernel and plain version agree to the last bit,
// the Laplacian included.

#include "common.cuh"

namespace {

// Launch shape per variant: index 0 raw, 1 scale, 2 scale+min/max, 3
// scale+min/max+Laplacian.  vec: lanes a thread owns (1, 2 or 4); threads
// a block; min_blocks: resident blocks per SM asked of __launch_bounds__;
// passes: lane passes a block makes (more passes, fewer blocks and
// prologues).  Measured at NE30 (k7_variants): with min/max, one pass a
// block (a prologue a pass) was 1.5-2x slower than four in f32; in f64
// the epilogue variants are fastest at 256 threads held to 128 registers.
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int vec[4] = {4, 4, 2, 1};
  static constexpr int threads[4] = {128, 128, 128, 128};
  static constexpr int min_blocks[4] = {1, 1, 1, 1};
  static constexpr int passes[4] = {1, 1, 4, 4};
};
template <>
struct Shape<double> {
  static constexpr int vec[4] = {2, 2, 2, 1};
  static constexpr int threads[4] = {128, 128, 256, 256};
  static constexpr int min_blocks[4] = {1, 1, 2, 2};
  static constexpr int passes[4] = {1, 1, 2, 2};
};
constexpr int kSmemMax = 227 * 1024;
// measuring switches (k7_variants): q = out/dp by the IEEE division
// throughout; outputs stored with the evict-first hint (st.global.cs)
constexpr bool kIeeeDivide = false;
constexpr bool kStreamStores = true;

// *p = v, with the evict-first hint where kStreamStores
template <typename V>
__device__ __forceinline__ void put(V* p, V v) {
  if constexpr (kStreamStores) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// dp and its reciprocal at one (point, level)
template <typename T>
struct DpRecip {
  T d, y;
};

// V adjacent values at p (V*sizeof(T)-aligned), in 16- or 8-byte accesses
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* __restrict__ p, T (&r)[V]) {
  if constexpr (V == 1) {
    r[0] = *p;
  } else if constexpr (sizeof(T) == 4 && V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  } else if constexpr (sizeof(T) == 4 && V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    r[0] = a.x, r[1] = a.y;
  } else {
    static_assert(sizeof(T) == 8 && V % 2 == 0, "vector width");
#pragma unroll
    for (int c = 0; c < V / 2; ++c) {
      const double2 a = reinterpret_cast<const double2*>(p)[c];
      r[2 * c] = a.x, r[2 * c + 1] = a.y;
    }
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_v(T* __restrict__ p, const T (&r)[V]) {
  if constexpr (V == 1) {
    put(p, r[0]);
  } else if constexpr (sizeof(T) == 4 && V == 4) {
    put(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
  } else if constexpr (sizeof(T) == 4 && V == 2) {
    put(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
#pragma unroll
    for (int c = 0; c < V / 2; ++c)
      put(reinterpret_cast<double2*>(p) + c,
          make_double2(r[2 * c], r[2 * c + 1]));
  }
}

// a partner row's V lanes, +0 where the partner is absent (row == null;
// the same for the whole block, so no lane diverges)
template <int V, typename T>
__device__ __forceinline__ void partner_v(const T* row, int lane, T (&r)[V]) {
  if (row != nullptr) {
    load_v<V>(row + lane, r);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = T(0);
  }
}

// the index of a variant in Shape's tables
template <bool SCALE, bool MINMAX, bool LAP>
constexpr int kVariant = LAP ? 3 : MINMAX ? 2 : SCALE ? 1 : 0;

template <typename T, bool SCALE, bool MINMAX, bool LAP, int V>
__global__ void __launch_bounds__(
    Shape<T>::threads[kVariant<SCALE, MINMAX, LAP>],
    Shape<T>::min_blocks[kVariant<SCALE, MINMAX, LAP>])
dss_band_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                const int32_t* __restrict__ role, const T* __restrict__ rsp,
                const T* __restrict__ dp, const T* __restrict__ met,
                const T* __restrict__ deriv, T* __restrict__ out,
                T* __restrict__ qmin, T* __restrict__ qmax,
                T* __restrict__ lap, int L, int nk, int groups,
                int64_t nloc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* sP[48];
  __shared__ T sR[16];
  __shared__ T sS[48];
  __shared__ T sD[16];
  DpRecip<T>* sQ = reinterpret_cast<DpRecip<T>*>(smem);  // [16][nk]
  const int64_t e = blockIdx.x / groups;
  const int g = int(blockIdx.x - e * groups);
  const int tid = threadIdx.x;
  const int bd = blockDim.x;

  // ---- prologue: what depends on the element alone ----------------------
  for (int i = tid; i < 48; i += bd) {
    const int64_t s = role[e * 48 + i];
    sP[i] = s < 0 ? nullptr : (s < nloc ? x + s * L : halo + (s - nloc) * L);
  }
  if (SCALE && tid < 16) sR[tid] = rsp[e * 16 + tid];
  if (LAP) {
    // rows 7-9 of the metric pack: the folded metric s00, s01, s11
    for (int i = tid; i < 48; i += bd) sS[i] = met[e * 160 + 112 + i];
    if (tid < 16) sD[tid] = deriv[tid];
  }
  bool slow_dp = false;
  if (MINMAX) {
    const T* dpe = dp + e * 16 * nk;
    for (int i = tid; i < 16 * nk; i += bd) {
      const T d = dpe[i];
      slow_dp |= tse::outside(d, tse::Bits<T>::d_lo, tse::Bits<T>::d_hi);
      sQ[i] = {d, tse::recip(d)};
    }
  }
  // a dp of the element outside the division's range: IEEE divisions
  slow_dp = __syncthreads_or(slow_dp) != 0 || kIeeeDivide;

  // ---- V adjacent lanes a thread, in passes of bd*V lanes ---------------
  const T* __restrict__ xe = x + e * 16 * L;
  for (int lane = (g * bd + tid) * V; lane < L; lane += groups * bd * V) {
    T r[16][V];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int i = p >> 2;
      T xp[V], sy[V];
      load_v<V>(xe + int64_t(p) * L + lane, xp);
      partner_v<V>(sP[p * 3 + 1], lane, sy);
      if (i == 0 || i == 3) {
        T sx[V], d[V];
        partner_v<V>(sP[p * 3], lane, sx);
        partner_v<V>(sP[p * 3 + 2], lane, d);
#pragma unroll
        for (int v = 0; v < V; ++v)
          r[p][v] = (((xp[v] + sx[v]) + sy[v]) + d[v]) + T(0);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = (xp[v] + sy[v]) + T(0);
      }
      if (SCALE) {
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = r[p][v] * sR[p];
      }
    }
    // stored after every load of the pass: the partner pointers come from
    // shared memory, so nvcc cannot move their loads above a store to out
#pragma unroll
    for (int p = 0; p < 16; ++p)
      store_v<V>(out + e * 16 * L + int64_t(p) * L + lane, r[p]);
    if (!MINMAX) continue;

    // q = out/dp in place of out; lanes lane..lane+V-1 hold levels
    // lev..lev+V-1 (V divides nk and lane)
    const int lev = lane % nk;
    bool slow = slow_dp;
#pragma unroll
    for (int p = 0; p < 16; ++p)
#pragma unroll
      for (int v = 0; v < V; ++v)
        slow |= tse::outside_abs(r[p][v], tse::Bits<T>::q_lo,
                                 tse::Bits<T>::q_hi);
    if (!slow) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const DpRecip<T> a = sQ[p * nk + lev + v];
          r[p][v] = tse::div_by(r[p][v], a.d, a.y);
        }
    } else {
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = r[p][v] / sQ[p * nk + lev + v].d;
    }
    T mn[V], mx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mn[v] = r[0][v];
      mx[v] = r[0][v];
    }
#pragma unroll
    for (int p = 1; p < 16; ++p)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mn[v] = r[p][v] < mn[v] ? r[p][v] : mn[v];
        mx[v] = r[p][v] > mx[v] ? r[p][v] : mx[v];
      }
    store_v<V>(qmin + e * L + lane, mn);
    store_v<V>(qmax + e * L + lane, mx);
    if (LAP) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T q[16], w[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) q[p] = r[p][v];
        tse::lap_wk(sD, q, sS, sS + 16, sS + 32, w);
#pragma unroll
        for (int p = 0; p < 16; ++p) r[p][v] = w[p];
      }
#pragma unroll
      for (int p = 0; p < 16; ++p)
        store_v<V>(lap + e * 16 * L + int64_t(p) * L + lane, r[p]);
    }
  }
}

template <int V, typename T>
bool aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (V * sizeof(T)) == 0;
}

template <typename T>
struct BandArgs {
  const T* x;
  const T* halo;
  const int32_t* role;
  const T *rsp, *dp, *met, *deriv;
  T *out, *qmin, *qmax, *lap;
  int E, L, nk;
  cudaStream_t st;
};

// Launches the variant at lane width V; with config, fills config[5] =
// {lanes a thread, threads a block, lane groups an element, dynamic shared
// bytes a block, resident blocks per SM} instead
template <typename T, bool SCALE, bool MINMAX, bool LAP, int V>
int run(const BandArgs<T>& a, int* config) {
  constexpr int vi = kVariant<SCALE, MINMAX, LAP>;
  constexpr int threads = Shape<T>::threads[vi];
  auto kernel = dss_band_kernel<T, SCALE, MINMAX, LAP, V>;
  const size_t smem = MINMAX ? size_t(16) * a.nk * sizeof(DpRecip<T>) : 0;
  if (smem > size_t(kSmemMax)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int chunks = (a.L + threads * V - 1) / (threads * V);
  const int passes = Shape<T>::passes[vi];
  const int groups = (chunks + passes - 1) / passes;
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
  const long long blocks = (long long)a.E * groups;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), threads, smem, a.st>>>(
      a.x, a.halo, a.role, a.rsp, a.dp, a.met, a.deriv, a.out, a.qmin,
      a.qmax, a.lap, a.L, a.nk, groups, int64_t(a.E) * 16);
  return int(cudaGetLastError());
}

// The variant's vector width where L, nk and every field pointer allow it,
// else one lane a thread
template <typename T, bool SCALE, bool MINMAX, bool LAP>
int run_variant(const BandArgs<T>& a, int* config) {
  constexpr int V = Shape<T>::vec[kVariant<SCALE, MINMAX, LAP>];
  const bool vec = V > 1 && a.L % V == 0 && (!MINMAX || a.nk % V == 0) &&
                   aligned<V>(a.x) && aligned<V>(a.halo) &&
                   aligned<V>(a.out) &&
                   (!MINMAX || (aligned<V>(a.qmin) && aligned<V>(a.qmax))) &&
                   (!LAP || aligned<V>(a.lap));
  if (vec) return run<T, SCALE, MINMAX, LAP, V>(a, config);
  return run<T, SCALE, MINMAX, LAP, 1>(a, config);
}

// flags: 1 scale by rsp, 2 min/max of out/dp (needs 1), 4 Laplacian of
// out/dp (needs 2)
template <typename T>
int dispatch(const BandArgs<T>& a, int flags, int* config) {
  if (a.E <= 0 || a.L <= 0 || a.nk <= 0) return int(cudaErrorInvalidValue);
  switch (flags) {
    case 0:
      return run_variant<T, false, false, false>(a, config);
    case 1:
      return run_variant<T, true, false, false>(a, config);
    case 3:
      return run_variant<T, true, true, false>(a, config);
    case 7:
      return run_variant<T, true, true, true>(a, config);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

#define BAND_ENTRY(SUFFIX, T)                                                 \
  extern "C" int tse_dss_band_##SUFFIX(                                       \
      const void* x, const void* halo, const void* role, const void* rsp,     \
      const void* dp, const void* met, const void* deriv, void* out,          \
      void* qmin, void* qmax, void* lap, int E, int L, int nk, int flags,     \
      void* stream) {                                                         \
    const BandArgs<T> a{(const T*)x,    (const T*)halo, (const int32_t*)role, \
                        (const T*)rsp,  (const T*)dp,   (const T*)met,        \
                        (const T*)deriv, (T*)out,       (T*)qmin,             \
                        (T*)qmax,       (T*)lap,        E,                    \
                        L,              nk,             (cudaStream_t)stream}; \
    return dispatch(a, flags, nullptr);                                       \
  }                                                                           \
  /* out[5]: the launch shape of variant flags for aligned fields */          \
  extern "C" int tse_band_config_##SUFFIX(int L, int nk, int flags,           \
                                          int* out) {                         \
    BandArgs<T> a{};                                                          \
    a.E = 1;                                                                  \
    a.L = L;                                                                  \
    a.nk = nk;                                                                \
    return dispatch(a, flags, out);                                           \
  }

BAND_ENTRY(f32, float)
BAND_ENTRY(f64, double)
