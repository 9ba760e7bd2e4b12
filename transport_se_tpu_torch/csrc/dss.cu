// Face DSS with epilogues (K4), limiter-bound prep (K5) and neighbour
// min/max (K6) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_dss.py:73 _dss_face_kernel
// (reached through dss_face_pallas :214), :387 _minmax_kernel (through
// minmax_prep_pallas :402) and :442 _nbr_minmax_kernel (through
// neighbor_minmax_pallas :519).  Plain PyTorch versions and the tables:
// ops/dss_face.py.
//
// Layout: T layout [E, 16, L], lane = tracer*nk + level, elements in raster
// face order; level fields [E, 16, nk]; bounds [E, L]; metric pack
// [E, 10, 16] (ops/euler.py MET_ROWS, rows 7-9 the folded Laplacian metric).
//
// Bound on the H100: device-memory bytes.  All three kernels do a few
// operations per byte.  K4 reads the field once and writes it once, plus
// the partner table and rspheremp, plus per launch case the average field
// read, dp read and the two [E, L] bounds written, the metric pack read and
// the Laplacian written (chip_smoke.py dss_cost).  At NE30 f32 (E = 5400,
// 35 x 72 lanes) at 3.35 TB/s: raw 0.521 ms, scale 0.521, +avg 0.781,
// +min/max 0.561, +avg+min/max 0.821, +min/max+Laplacian 0.822,
// +avg+min/max+Laplacian 1.082; twice that in f64.  K5 reads the field and
// dp once and writes two [E, L] bounds (~0.30 ms); K6 moves two [E, L]
// bound arrays in and out (~0.07 ms).
//
// K4, against the TPU form: the Pallas kernel streams blocks of whole
// element rows of one face through VMEM, takes the in-face partners as
// shifted slices of the block, and DMAs seam ghost strips (with zero or
// +-inf padding rows for the cube vertices) beside each block.  None of
// that carries over.  Every partner comes through a host-built table,
// [E, 16, 3] role-ordered partner slots (x-edge partner, corner diagonal,
// y-edge partner; -1 where absent), and a block takes one element and a
// group of its lanes, in K7's form (band.cu):
//   - a prologue computes once into shared memory what depends only on
//     the element: the 48 partner slots resolved to row pointers into x
//     (null: absent), rspheremp, the metric rows s00, s01, s11 and the
//     derivative matrix, and for each (point, level) dp with its
//     reciprocal for the inline division.  Whether every dp of the element
//     lies in the division's range is reduced by the prologue's barrier
//     (__syncthreads_or);
//   - each thread owns V adjacent lanes (vector loads and stores where L,
//     nk and the pointers allow, else V = 1), keeps their 16 points in
//     registers, and a block walks its lanes in passes of threads*V lanes,
//     so one prologue serves several passes.  A partner row is another
//     block's own row: with the grid element-major, the +-y partner is
//     ne elements away, well inside a resident wave, and mostly hits L2;
//   - q = out/dp runs inline (tse::div_by with the prologue's
//     reciprocal), the IEEE quotient while out lies in common.cuh's range
//     (or is +0) and dp does; a thread whose out leaves it, or a block
//     whose dp does, divides with IEEE divisions (out is still in
//     registers, so nothing is read again);
//   - every output is stored with the evict-first hint, which bounds the
//     registers nvcc spends on loads in flight and keeps the outputs from
//     pushing partner rows out of L2.
// The launch shape (V, threads, resident blocks, passes) is set per dtype
// and launch case in Shape below (k4_variants.py measures the choices).
// Limits: with min/max the prologue holds 16 nk dp records, so a block
// needs 128 nk (f32) / 256 nk (f64) bytes of shared memory beside about
// 1 KB of tables: nk <= 1810 / 904 fit the 227 KB a block may have;
// beyond that the launch returns an error and the wrapper raises.
// Measured at NE30 f32 on an NVIDIA H100 80GB HBM3 at 700 W
// (k4_variants, the first form built from another tree in the same call):
// its first form, a thread per (element, lane) column with scalar loads
// of every partner, avg and dp value and 16 IEEE divisions per column,
// took 16.0 ms over a face subcycle's 12 launches, 51% of their bound;
// this form 10.5 ms, 77% (raw 0.61 against 0.83 ms, +min/max 0.78
// against 1.23, +min/max+Laplacian 1.09 against 1.91).  Of its choices,
// the IEEE division throughout cost 10-14% in the min/max cases, plain
// stores 10-18% (1.9x in f64, with spills), a lane-group-major grid
// 5-10%, one lane a thread 2-7%.
//
// K4 adds the terms of each slot in the DSS_STORE order of the Pallas
// kernel, (x + (S_x + d)) + S_y on the i = 0, 3 planes and x + S_y on the
// others, with absent terms as +0 (K7 adds ((x + S_x) + S_y) + d: the two
// JAX assemblies differ, and the port follows each).  The time average is
// (avg + 2 res) * (1/3), the min and the max run over the points in order
// with strict comparisons (the first of tied zeros kept), and the
// Laplacian epilogue is the shared lap_wk of common.cuh.  Built with
// --fmad=false, so kernel and plain version agree to the last bit.
//
// K6 keeps the Pallas kernel's separable form and its march over a face's
// rows (see nbr_minmax_kernel): its first form, a thread per (element,
// lane) reading the 9 neighbour rows of both arrays through the [E, 9]
// table, moved 9 times the arrays from L2 and took 0.15-0.16 ms f32 /
// 0.26 f64 at NE30 on an H100, 41% / 51% of its bound.  The seam rows and
// columns of a face's window come from the same table's edge slots.
//
// K5 takes K7's min/max form (band.cu).  Its first form, a thread per
// column with 16 IEEE divisions and 16 reads of dp[e, p, lane % nk] (each
// shared by the column's nq tracers), took 0.68-0.72 ms f32 / 1.03-1.11
// f64 at NE30 on an H100, 42% of its bound.
// Now a block takes an element and a group of its lanes; a prologue puts
// dp and its reciprocal into shared memory once per element and group,
// each thread owns 2 adjacent lanes in vector accesses, and q = x/dp runs
// inline (see minmax_kernel).

#include "common.cuh"

namespace {

constexpr int kSmemMax = 227 * 1024;

// dp and its reciprocal at one (point, level)
template <typename T>
struct DpRecip {
  T d, y;
};

// K4's launch shape per launch case: index 0 raw (no rspheremp), 1 scale,
// 2 +avg, 3 +min/max, 4 +avg+min/max, 5 +min/max+Laplacian,
// 6 +avg+min/max+Laplacian (kFaceCase).  vec: lanes a thread owns (1, 2
// or 4); threads a block; min_blocks: resident blocks per SM asked of
// __launch_bounds__; passes: lane passes a block makes (more passes, fewer
// blocks and prologues).  Measured at NE30 with k4_variants in two calls
// on an NVIDIA H100 80GB HBM3 at 700 W, each choice against its
// neighbours in the same call: with min/max one pass a block (a prologue a
// pass) was 12-33% slower in f32 than four; f32's avg+min/max and
// Laplacian cases gained 3-5% from 256 threads held to 128 registers (2
// lanes a thread, no spill), and its Laplacian cases 4% from 2 lanes a
// thread over one; f64's avg+min/max gained 5% from one lane a thread (2
// spill 32 B at 128 registers); 4 lanes a thread in f64 took 1.6-1.9x.
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int vec[7] = {4, 4, 4, 2, 2, 2, 2};
  static constexpr int threads[7] = {128, 128, 128, 128, 256, 256, 256};
  static constexpr int min_blocks[7] = {1, 1, 1, 1, 2, 2, 2};
  static constexpr int passes[7] = {1, 1, 1, 4, 4, 4, 4};
};
template <>
struct Shape<double> {
  static constexpr int vec[7] = {2, 2, 2, 2, 1, 1, 1};
  static constexpr int threads[7] = {128, 128, 128, 256, 256, 256, 256};
  static constexpr int min_blocks[7] = {1, 1, 1, 2, 2, 2, 2};
  static constexpr int passes[7] = {1, 1, 1, 2, 2, 2, 2};
};
// measuring switches (k4_variants): q = out/dp by the IEEE division
// throughout; outputs stored with the evict-first hint (st.global.cs);
// the grid lane-group-major (all elements of lane group 0 first) instead
// of element-major
constexpr bool kFaceIeeeDivide = false;
constexpr bool kFaceStreamStores = true;
constexpr bool kFaceLaneMajor = false;

// the index of a launch case in Shape's tables
template <bool SCALE, bool AVG, bool MINMAX, bool LAP>
constexpr int kFaceCase = LAP      ? (AVG ? 6 : 5)
                          : MINMAX ? (AVG ? 4 : 3)
                          : AVG    ? 2
                          : SCALE  ? 1
                                   : 0;

// a partner row's V lanes, +0 where the partner is absent (row == null;
// the same for the whole block, so no lane diverges)
template <int V, typename T>
__device__ __forceinline__ void partner_v(const T* row, int lane, T (&r)[V]) {
  if (row != nullptr) {
    tse::load_v<V>(row + lane, r);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = T(0);
  }
}

template <typename T, bool SCALE, bool AVG, bool MINMAX, bool LAP, int V>
__global__ void __launch_bounds__(
    Shape<T>::threads[kFaceCase<SCALE, AVG, MINMAX, LAP>],
    Shape<T>::min_blocks[kFaceCase<SCALE, AVG, MINMAX, LAP>])
dss_face_kernel(const T* __restrict__ x, const int64_t* __restrict__ part,
                const T* __restrict__ rsp, const T* __restrict__ avg,
                const T* __restrict__ dp, const T* __restrict__ met,
                const T* __restrict__ deriv, T* __restrict__ out,
                T* __restrict__ qmin, T* __restrict__ qmax,
                T* __restrict__ lap, int L, int nk, int groups, int nelem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* sP[48];
  __shared__ T sR[16];
  __shared__ T sS[48];
  __shared__ T sD[16];
  DpRecip<T>* sQ = reinterpret_cast<DpRecip<T>*>(smem);  // [16][nk]
  int64_t e;
  int g;
  if (kFaceLaneMajor) {
    g = int(blockIdx.x / unsigned(nelem));
    e = int64_t(blockIdx.x) - int64_t(g) * nelem;
  } else {
    e = blockIdx.x / unsigned(groups);
    g = int(blockIdx.x - e * groups);
  }
  const int tid = threadIdx.x;
  const int bd = blockDim.x;

  // ---- prologue: what depends on the element alone ----------------------
  for (int i = tid; i < 48; i += bd) {
    const int64_t s = part[e * 48 + i];
    sP[i] = s < 0 ? nullptr : x + s * L;
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
  slow_dp = __syncthreads_or(slow_dp) != 0 || kFaceIeeeDivide;

  // ---- V adjacent lanes a thread, in passes of bd*V lanes ---------------
  // the time average's 1/3, as dss_face_pallas evaluates its "/ 3" (XLA
  // folds a division by a constant into a product with its reciprocal)
  const T third = T(1) / T(3);
  const T* __restrict__ xe = x + e * 16 * L;
  for (int lane = (g * bd + tid) * V; lane < L; lane += groups * bd * V) {
    T r[16][V];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      T xp[V], sy[V];
      tse::load_v<V>(xe + int64_t(p) * L + lane, xp);
      partner_v<V>(sP[p * 3 + 2], lane, sy);
      if ((p >> 2) == 0 || (p >> 2) == 3) {
        T sx[V], d[V];
        partner_v<V>(sP[p * 3], lane, sx);
        partner_v<V>(sP[p * 3 + 1], lane, d);
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = (xp[v] + (sx[v] + d[v])) + sy[v];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = xp[v] + sy[v];
      }
      if (SCALE) {
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = r[p][v] * sR[p];
      }
      if (AVG) {
        T a[V];
        tse::load_v<V>(avg + e * 16 * L + int64_t(p) * L + lane, a);
#pragma unroll
        for (int v = 0; v < V; ++v) r[p][v] = (a[v] + T(2) * r[p][v]) * third;
      }
    }
    // stored after every load of the pass: the partner pointers come from
    // shared memory, so nvcc cannot move their loads above a store to out
#pragma unroll
    for (int p = 0; p < 16; ++p)
      tse::store_v<kFaceStreamStores, V>(out + e * 16 * L + int64_t(p) * L +
                                             lane,
                                         r[p]);
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
    tse::store_v<kFaceStreamStores, V>(qmin + e * L + lane, mn);
    tse::store_v<kFaceStreamStores, V>(qmax + e * L + lane, mx);
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
        tse::store_v<kFaceStreamStores, V>(
            lap + e * 16 * L + int64_t(p) * L + lane, r[p]);
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

// K6's launch shape (k6_variants measures the choices): a block takes one
// face, a strip of at most kNbrCols element columns, a segment of at most
// kNbrRows element rows, which it marches, and a chunk of kNbrChunk
// 16-byte lane vectors (threadIdx.x) for each of its columns (threadIdx.y);
// kNbrStages window rows are in shared memory at once, all but one in
// flight.  Measured at NE30 on an H100 (PERF.md): rings of 3, 4 and 6 rows
// were no faster than 2, nor were 8 or 30 rows, 6 or 15 columns, 16
// vectors or cached stores; within 1-3% of each other, 10% above two
// Tensor.copy_ calls of the same bytes
constexpr int kNbrChunk = 32;
constexpr int kNbrCols = 10;
constexpr int kNbrRows = 15;
constexpr int kNbrStages = 2;
// measuring switch (k6_variants): the bounds stored with the evict-first
// hint (st.global.cs)
constexpr bool kNbrStreamStores = true;
static_assert(kNbrCols >= 2, "a strip's halo columns need two columns");
static_assert(kNbrStages >= 2, "a row in flight beside the one reduced");

// A value's bits as an integer ordered as the values, -0 below +0 (IEEE
// 754-2019 minimum/maximum; NaN is not in the domain).  The map is its own
// inverse.
template <typename T>
struct Order;

template <>
struct Order<float> {
  using K = int;
  static __device__ __forceinline__ K key(float v) {
    const int i = __float_as_int(v);
    return i ^ ((i >> 31) & 0x7fffffff);
  }
  static __device__ __forceinline__ float value(K k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  }
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
};

template <>
struct Order<double> {
  using K = long long;
  static __device__ __forceinline__ K key(double v) {
    const long long i = __double_as_longlong(v);
    return i ^ ((i >> 63) & 0x7fffffffffffffffLL);
  }
  static __device__ __forceinline__ double value(K k) {
    return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
  }
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

// V values in one shared-memory access
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

// BYTES (4, 8 or 16, aligned) from device memory into shared memory
// without passing through a register (cp.async; 16 bytes bypass L1)
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
#else
  for (int i = 0; i < BYTES; ++i)
    static_cast<unsigned char*>(dst)[i] =
        static_cast<const unsigned char*>(src)[i];
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// until at most N of this thread's latest commit groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

struct NbrGrid {
  int chunks, segs, strips, rows, cols;
};

// The element at row y, column x of face f's window: the face's own rows
// and columns, the seam neighbours of its edge elements beyond them (the
// +x, -x, +y, -y slots of nbr), and -1 at the four corners (cube vertices)
__device__ __forceinline__ int window_elem(const int64_t* __restrict__ nbr,
                                           int f, int ne, int y, int x) {
  const int base = f * ne * ne;
  const bool yin = y >= 0 && y < ne, xin = x >= 0 && x < ne;
  if (yin && xin) return base + y * ne + x;
  if (yin)
    return int(nbr[int64_t(base + y * ne + (x < 0 ? 0 : ne - 1)) * 9 +
                   (x < 0 ? 2 : 1)]);
  if (xin)
    return int(nbr[int64_t(base + (y < 0 ? 0 : ne - 1) * ne + x) * 9 +
                   (y < 0 ? 4 : 3)]);
  return -1;
}

// The separable 3x3 reduce of the Pallas kernel: the row-direction minimum
// m1 of each element over itself and its x neighbours, then the minimum of
// m1 over the rows above and below.  A block marches its segment's rows
// from the one below to the one above.  Each window row (the strip's
// columns and one halo column on each side, both arrays) is copied once
// into a ring of kNbrStages rows in shared memory by cp.async, issued
// kNbrStages - 1 rows ahead of the row reduced; each thread takes its
// column's m1 from its own and the two adjacent columns there, and keeps
// m1 of the last row and the minimum of the last two in registers.  So a
// block reads (rows + 2)(cols + 2) element rows of each array for rows x
// cols outputs, 1.36 times the arrays at NE30 (the direct form read 9
// rows for each output).  The values are reduced as order-preserving
// integer keys: min and max are exact and independent of order, -0 below
// +0, so the kernel gives the plain version's bits at any association.
template <typename T, int V>
__global__ void __launch_bounds__(kNbrChunk * kNbrCols)
nbr_minmax_kernel(const T* __restrict__ qmin, const T* __restrict__ qmax,
                  const int64_t* __restrict__ nbr, T* __restrict__ gmin,
                  T* __restrict__ gmax, int ne, int L, NbrGrid g) {
  using O = Order<T>;
  using K = typename O::K;
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = kNbrChunk, bx = g.cols, span = W * V;
  const int wcols = bx + 2;
  // [stage][min, max][window column][lane]
  const int stage = 2 * wcols * span;
  T* sQ = reinterpret_cast<T*>(smem);
  int* sIdx = reinterpret_cast<int*>(sQ + kNbrStages * stage);

  int b = blockIdx.x;
  const int chunk = b % g.chunks;
  b /= g.chunks;
  const int seg = b % g.segs;
  b /= g.segs;
  const int strip = b % g.strips;
  const int f = b / g.strips;
  const int ex0 = strip * bx, ey0 = seg * g.rows;
  const int ncols = min(bx, ne - ex0), nrows = min(g.rows, ne - ey0);
  if (ncols <= 0 || nrows <= 0) return;
  const int w = threadIdx.x, c = threadIdx.y;
  const int tid = c * W + w, nthr = W * bx;
  const int lane = chunk * span + w * V;
  const bool live = lane < L;
  const bool own = c < ncols && live;

  // the window's elements: rows ey0-1 .. ey0+nrows, columns ex0-1 ..
  // ex0+ncols
  const int wc = ncols + 2;
  for (int i = tid; i < (nrows + 2) * wc; i += nthr)
    sIdx[i] = window_elem(nbr, f, ne, ey0 - 1 + i / wc, ex0 - 1 + i % wc);
  __syncthreads();

  // window row r (-1 .. nrows) into its stage, one commit group a row (an
  // empty one past the last): a thread copies window columns c and c + bx
  // of its lane vector
  const int nslots = wc * W;
  auto issue = [&](int r) {
    if (r <= nrows && live) {
      T* st = sQ + ((r + 1) % kNbrStages) * stage;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = tid + k * nthr;
        const int x = s / W;
        const int e = s < nslots ? sIdx[(r + 1) * wc + x] : -1;
        if (e >= 0) {
          constexpr int bytes = V * sizeof(T);
          const int64_t off = int64_t(e) * L + lane;
          copy_async<bytes>(st + x * span + w * V, qmin + off);
          copy_async<bytes>(st + (wcols + x) * span + w * V, qmax + off);
        }
      }
    }
    copy_commit();
  };

  const K pad_mn = O::key(O::inf()), pad_mx = O::key(-O::inf());
  K c_mn[V], c_mx[V], p_mn[V], p_mx[V];  // m1 of row r-1; min of r-2, r-1
#pragma unroll
  for (int v = 0; v < V; ++v) c_mn[v] = pad_mn, c_mx[v] = pad_mx;
  for (int j = -1; j < kNbrStages - 2; ++j) issue(j);
  for (int r = -1; r <= nrows; ++r) {
    copy_wait<kNbrStages - 2>();
    __syncthreads();
    // the stage of row r - 1, reduced by every thread before the barrier
    issue(r + kNbrStages - 1);
    if (!own) continue;
    const T* st = sQ + ((r + 1) % kNbrStages) * stage + c * span + w * V;
    const int* idx = sIdx + (r + 1) * wc + c;
    K n_mn[V], n_mx[V];  // m1 of row r
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const bool pad = idx[j] < 0;
      const P a = *reinterpret_cast<const P*>(st + j * span);
      const P z = *reinterpret_cast<const P*>(st + (wcols + j) * span);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const K ka = pad ? pad_mn : O::key(a.v[v]);
        const K kz = pad ? pad_mx : O::key(z.v[v]);
        n_mn[v] = j == 0 ? ka : min(n_mn[v], ka);
        n_mx[v] = j == 0 ? kz : max(n_mx[v], kz);
      }
    }
    if (r >= 1) {
      T omn[V], omx[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        omn[v] = O::value(min(p_mn[v], n_mn[v]));
        omx[v] = O::value(max(p_mx[v], n_mx[v]));
      }
      const int64_t at =
          int64_t(f * ne * ne + (ey0 + r - 1) * ne + ex0 + c) * L + lane;
      tse::store_v<kNbrStreamStores, V>(gmin + at, omn);
      tse::store_v<kNbrStreamStores, V>(gmax + at, omx);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p_mn[v] = min(c_mn[v], n_mn[v]), c_mn[v] = n_mn[v];
      p_mx[v] = max(c_mx[v], n_mx[v]), c_mx[v] = n_mx[v];
    }
  }
}

template <int V, typename T>
bool aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (V * sizeof(T)) == 0;
}

template <typename T>
struct FaceArgs {
  const T* x;
  const int64_t* part;
  const T *rsp, *avg, *dp, *met, *deriv;
  T *out, *qmin, *qmax, *lap;
  int E, L, nk;
  cudaStream_t st;
};

// Launches K4's case at lane width V; with config, fills config[5] =
// {lanes a thread, threads a block, lane groups an element, dynamic shared
// bytes a block, resident blocks per SM} instead
template <typename T, bool SCALE, bool AVG, bool MINMAX, bool LAP, int V>
int run_face(const FaceArgs<T>& a, int* config) {
  constexpr int vi = kFaceCase<SCALE, AVG, MINMAX, LAP>;
  constexpr int threads = Shape<T>::threads[vi];
  auto kernel = dss_face_kernel<T, SCALE, AVG, MINMAX, LAP, V>;
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
      a.x, a.part, a.rsp, a.avg, a.dp, a.met, a.deriv, a.out, a.qmin, a.qmax,
      a.lap, a.L, a.nk, groups, a.E);
  return int(cudaGetLastError());
}

// The case's vector width where L, nk and every field pointer allow it,
// else one lane a thread
template <typename T, bool SCALE, bool AVG, bool MINMAX, bool LAP>
int run_face_case(const FaceArgs<T>& a, int* config) {
  constexpr int V = Shape<T>::vec[kFaceCase<SCALE, AVG, MINMAX, LAP>];
  const bool vec = V > 1 && a.L % V == 0 && (!MINMAX || a.nk % V == 0) &&
                   aligned<V>(a.x) && aligned<V>(a.out) &&
                   (!AVG || aligned<V>(a.avg)) &&
                   (!MINMAX || (aligned<V>(a.qmin) && aligned<V>(a.qmax))) &&
                   (!LAP || aligned<V>(a.lap));
  if (vec) return run_face<T, SCALE, AVG, MINMAX, LAP, V>(a, config);
  return run_face<T, SCALE, AVG, MINMAX, LAP, 1>(a, config);
}

// flags: 1 avg, 2 min/max of out/dp, 4 Laplacian of out/dp (needs 2);
// flags 0 scales by rspheremp where rsp is given (scale), the others need
// it.  With config, the launch shape of that case (null pointers: aligned
// fields)
template <typename T>
int launch_dss_face(const FaceArgs<T>& a, int flags, bool scale,
                    int* config) {
  if (a.E <= 0 || a.L <= 0 || a.nk <= 0 || (flags != 0 && !scale))
    return int(cudaErrorInvalidValue);
  switch (flags) {
    case 0:
      return scale ? run_face_case<T, true, false, false, false>(a, config)
                   : run_face_case<T, false, false, false, false>(a, config);
    case 1:
      return run_face_case<T, true, true, false, false>(a, config);
    case 2:
      return run_face_case<T, true, false, true, false>(a, config);
    case 3:
      return run_face_case<T, true, true, true, false>(a, config);
    case 6:
      return run_face_case<T, true, false, true, true>(a, config);
    case 7:
      return run_face_case<T, true, true, true, true>(a, config);
    default:
      return int(cudaErrorInvalidValue);
  }
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

// Launches K6 at lane width V; with config, fills config[5] = {lanes a
// thread, threads a block, blocks, dynamic shared bytes a block, resident
// blocks per SM} instead
template <typename T, int V>
int run_nbr_minmax(const T* qmin, const T* qmax, const int64_t* nbr, T* gmin,
                   T* gmax, int ne, int L, cudaStream_t st, int* config) {
  auto kernel = nbr_minmax_kernel<T, V>;
  const int span = kNbrChunk * V;
  NbrGrid g;
  g.chunks = (L + span - 1) / span;
  g.strips = (ne + kNbrCols - 1) / kNbrCols;
  g.cols = (ne + g.strips - 1) / g.strips;
  g.segs = (ne + kNbrRows - 1) / kNbrRows;
  g.rows = (ne + g.segs - 1) / g.segs;
  const size_t smem =
      size_t(kNbrStages) * 2 * (g.cols + 2) * span * sizeof(T) +
      size_t(g.rows + 2) * (g.cols + 2) * sizeof(int);
  if (smem > size_t(kSmemMax)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 block(kNbrChunk, g.cols);
  const long long blocks = 6LL * g.strips * g.segs * g.chunks;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (config != nullptr) {
    int resident = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, int(block.x * block.y), smem);
    if (err != cudaSuccess) return int(err);
    config[0] = V;
    config[1] = int(block.x * block.y);
    config[2] = int(blocks);
    config[3] = int(smem);
    config[4] = resident;
    return 0;
  }
  kernel<<<unsigned(blocks), block, smem, st>>>(qmin, qmax, nbr, gmin, gmax,
                                                ne, L, g);
  return int(cudaGetLastError());
}

// E = 6 ne^2 elements in raster face order.  16-byte vectors where L and
// the pointers allow them, else one lane a thread (null pointers: the
// launch shape for aligned bounds)
template <typename T>
int launch_nbr_minmax(const void* qmin, const void* qmax, const void* nbr,
                      void* gmin, void* gmax, int E, int L, void* stream,
                      int* config = nullptr) {
  int ne = 1;
  while (6LL * (ne + 1) * (ne + 1) <= E) ++ne;
  if (E <= 0 || L <= 0 || 6 * ne * ne != E || ne < 2)
    return int(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const T *mn = (const T*)qmin, *mx = (const T*)qmax;
  T *gn = (T*)gmin, *gx = (T*)gmax;
  const int64_t* nb = (const int64_t*)nbr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L % V == 0 && aligned<V>(mn) && aligned<V>(mx) && aligned<V>(gn) &&
      aligned<V>(gx))
    return run_nbr_minmax<T, V>(mn, mx, nb, gn, gx, ne, L, st, config);
  return run_nbr_minmax<T, 1>(mn, mx, nb, gn, gx, ne, L, st, config);
}

}  // namespace

#define DSS_ENTRIES(SUFFIX, T)                                               \
  extern "C" int tse_dss_face_##SUFFIX(                                      \
      const void* x, const void* part, const void* rsp, const void* avg,     \
      const void* dp, const void* met, const void* deriv, void* out,         \
      void* qmin, void* qmax, void* lap, int E, int L, int nk, int flags,    \
      void* stream) {                                                        \
    const FaceArgs<T> a{(const T*)x,     (const int64_t*)part,             \
                        (const T*)rsp,   (const T*)avg,                    \
                        (const T*)dp,    (const T*)met,                    \
                        (const T*)deriv, (T*)out,                          \
                        (T*)qmin,        (T*)qmax,                         \
                        (T*)lap,         E,                                \
                        L,               nk,                               \
                        (cudaStream_t)stream};                             \
    return launch_dss_face<T>(a, flags, rsp != nullptr, nullptr);            \
  }                                                                          \
  /* out[5]: K4's launch shape of case (flags, scale) for aligned fields */  \
  extern "C" int tse_dss_face_config_##SUFFIX(int L, int nk, int flags,      \
                                              int scale, int* out) {         \
    FaceArgs<T> a{};                                                         \
    a.E = 1;                                                                 \
    a.L = L;                                                                 \
    a.nk = nk;                                                               \
    return launch_dss_face<T>(a, flags, scale != 0, out);                    \
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
  }                                                                          \
  /* out[5]: K6's launch shape for aligned bounds */                         \
  extern "C" int tse_nbr_minmax_config_##SUFFIX(int E, int L, int* out) {    \
    return launch_nbr_minmax<T>(nullptr, nullptr, nullptr, nullptr, nullptr, \
                                E, L, nullptr, out);                         \
  }

DSS_ENTRIES(f32, float)
DSS_ENTRIES(f64, double)
