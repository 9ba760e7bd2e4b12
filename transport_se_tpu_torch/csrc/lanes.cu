// The lane-group copies of the T subcycle's tracer-group plan (the lane
// kernels) for sm_90a.
//
// Replaces no TPU kernel: the JAX package holds a whole state per buffer
// and has no group plan.  Where four states of [E, 16, q*k] do not fit the
// card (NE120 with 35 tracers in f64: 25.96 GiB a state), model/core.py
// advances the state a group of tracers at a time, and these kernels move
// a group between the state and a contiguous group buffer:
//   gather:  group[r, c] = full[r, lo + c]      r < rows = E*16, c < W
//   scatter: full[r, lo + c] = group[r, c]
// with L the state's lanes a row (q*k), lo the group's first lane and W its
// lanes (g*k).  A group's lanes are one contiguous range of each row, so
// each is a strided copy of rows; the plain versions (ops/lanes.py) are a
// slice's copy, and the bits are the same.
//
// Bound on the H100: device-memory bytes, one read and one write of each
// value, no arithmetic.  A subcycle gathers and scatters every lane once,
// 4 x 27.87 GB at NE120 with 35 tracers in f64 (33.3 ms at 3.35 TB/s).
// So the design keeps every access wide and leaves the L2 alone:
//   - a warp copies a row, its threads on neighbouring 16-byte vectors
//     (uint4, any dtype: the copy moves bits), 4 vectors a thread loaded
//     before the first store, so that each thread keeps 64 bytes in
//     flight; where a row's offset, stride or width, or a pointer, is not
//     a multiple of 16 bytes the launch copies single values instead;
//   - the blocks are as many as the card holds at once and walk the rows
//     in turn, so no block waits for a short tail of rows;
//   - the stores carry the evict-first hint (st.global.cs): a group moves
//     gigabytes, far past the 50 MB L2, and nothing reads them soon;
//   - rows, offsets and strides are 64-bit: the full state holds 3.48e9
//     values at NE120, past 2^31.
// No atomics and no state shared between blocks; one kernel serves every
// shape.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// vectors a thread loads before it stores them
constexpr int kUnroll = 4;

// The rows' `width` units from src + r*ss + so to dst + r*ds + dof, a warp
// a row.
template <typename U>
__device__ __forceinline__ void copy_rows(const U* __restrict__ src,
                                          U* __restrict__ dst,
                                          long long rows, long long ss,
                                          long long so, long long ds,
                                          long long dof, int width) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < rows; r += nwarps) {
    const U* __restrict__ s = src + r * ss + so;
    U* __restrict__ d = dst + r * ds + dof;
    for (int c0 = lane; c0 < width; c0 += 32 * kUnroll) {
      U v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (c0 + 32 * j < width) v[j] = s[c0 + 32 * j];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (c0 + 32 * j < width) __stcs(d + c0 + 32 * j, v[j]);
    }
  }
}

// full [rows, L] lanes [lo, lo + W) -> group [rows, W]
template <typename U>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const U* __restrict__ full, U* __restrict__ group,
                   long long rows, long long L, long long lo, int W) {
  copy_rows(full, group, rows, L, lo, W, 0, W);
}

// group [rows, W] -> full [rows, L] lanes [lo, lo + W)
template <typename U>
__global__ void __launch_bounds__(kThreads)
lane_scatter_kernel(const U* __restrict__ group, U* __restrict__ full,
                    long long rows, long long L, long long lo, int W) {
  copy_rows(group, full, rows, W, 0, L, lo, W);
}

template <typename U>
int launch_unit(bool scatter, const void* x, void* y, long long rows,
                long long L, long long lo, long long W, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = scatter ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, lane_scatter_kernel<U>, kThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, lane_gather_kernel<U>, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  const long long need = (rows + kWarps - 1) / kWarps;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = unsigned(need < most ? need : most);
  if (scatter) {
    lane_scatter_kernel<U><<<blocks, kThreads, 0, st>>>(
        (const U*)x, (U*)y, rows, L, lo, int(W));
  } else {
    lane_gather_kernel<U><<<blocks, kThreads, 0, st>>>(
        (const U*)x, (U*)y, rows, L, lo, int(W));
  }
  return int(cudaGetLastError());
}

// x -> y: gather reads the state x and writes the group y, scatter reads
// the group x and writes the state y.  L, lo and W in values of ES bytes.
template <typename E>
int launch_lanes(bool scatter, const void* x, void* y, long long rows,
                 long long L, long long lo, long long W, void* stream) {
  constexpr long long ES = sizeof(E);
  if (rows < 0 || L < 1 || lo < 0 || W < 1 || lo + W > L ||
      W * ES / 16 > 0x7fffffffLL || W > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = (L * ES) % 16 == 0 && (lo * ES) % 16 == 0 &&
                    (W * ES) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (wide)
    return launch_unit<uint4>(scatter, x, y, rows, L * ES / 16,
                              lo * ES / 16, W * ES / 16, st);
  return launch_unit<E>(scatter, x, y, rows, L, lo, W, st);
}

}  // namespace

#define LANES_ENTRY(SUFFIX, E)                                              \
  extern "C" int tse_lane_gather_##SUFFIX(const void* full, void* group,    \
                                          long long rows, long long L,      \
                                          long long lo, long long W,        \
                                          void* stream) {                   \
    return launch_lanes<E>(false, full, group, rows, L, lo, W, stream);     \
  }                                                                         \
  extern "C" int tse_lane_scatter_##SUFFIX(const void* group, void* full,   \
                                           long long rows, long long L,     \
                                           long long lo, long long W,       \
                                           void* stream) {                  \
    return launch_lanes<E>(true, group, full, rows, L, lo, W, stream);      \
  }

LANES_ENTRY(f32, unsigned int)
LANES_ENTRY(f64, unsigned long long)
