// The remap's health check (the health kernel) for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the check to XLA
// (transport_se_tpu/ops/ppm.py ppm_fast_margin beside dp_star.min() in
// model/core.py).  Plain PyTorch version: ops/remap.py
// remap_health_t_plain.
//
// Layout: dp_star and dp_ref [E, 16, k], level minor; column c of the field
// is the k values from c*k on.  The check's value is the least of
//   (a) every width dp_star, and
//   (b) the fast cell search's margin over the interior interfaces
//       j = 0..k-2: min(tgt - pio[max(j-2, 0)], pio[min(j+4, k)] - tgt),
//       tgt = pin[j+1],
// with pio and pin the interface sums of dp_star and dp_ref from the bottom
// (pio[0] = 0, pio[k+1] = pio[k] + d[k], in level order).  Below 0 the
// remap must abort: a negative width, or an interface displaced by more
// than the remap's -2..+2 cell window.
//
// Bound on the H100: device-memory bytes, each width read once (NE120 with
// 72 levels: 0.80 GB in f32, 0.24 ms at 3.35 TB/s); a handful of additions
// and minima a value.  The design reads each byte once and keeps the
// prefix sums in registers:
//   - a block owns kCols columns at a time, a thread one column; it stages
//     the tile of both fields into shared memory with 16-byte loads
//     (neighbouring threads on neighbouring vectors, kUnroll vectors of
//     each field loaded before the first store), each column at an odd
//     stride, so that the column walks hit no bank twice;
//   - a thread then walks its column bottom-up, the two interface sums
//     sequential as in the plain version, with the last seven pio values
//     as a register window shifted a level at a time;
//   - the blocks are as many as the card holds at once and take the tiles
//     in turn; each writes its minimum, and a one-block second kernel
//     reduces those to the 0-dim value.
// The minima let a NaN through (fminf would drop it), as torch.minimum and
// .min() do, so a broken state still fails min_dp > 0.  Sums and
// differences round as in the plain version (no products, nothing to
// contract), and a minimum is exact, so kernel and plain version agree to
// the last bit whatever the block shape.

#include "common.cuh"

namespace {

// columns (threads) a block
constexpr int kCols = 64;
// threads of the reduction over the blocks' minima
constexpr int kReduceThreads = 256;
// vectors of each field a thread has in flight while staging
constexpr int kUnroll = 8;
constexpr int kSmemMax = 227 * 1024;

template <typename T>
struct Inf;
template <>
struct Inf<float> {
  static __device__ __forceinline__ float v() {
    return __int_as_float(0x7f800000);
  }
};
template <>
struct Inf<double> {
  static __device__ __forceinline__ double v() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

// min that keeps a NaN of either operand
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// nan_min over a warp; every lane gets the result
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// nan_min over the block (blockDim.x a multiple of 32, at most 1024);
// thread 0 gets the result
template <typename T>
__device__ __forceinline__ T block_min(T v) {
  __shared__ T w[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) w[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < int(blockDim.x >> 5) ? w[lane] : Inf<T>::v();
    v = warp_min(v);
  }
  return v;
}

// The odd column stride of a staged field
__host__ __device__ inline int col_stride(int nk) { return nk | 1; }

// The check over one column: its widths d and reference widths r, nk >= 4
// levels, each at stride 1
template <typename T>
__device__ __forceinline__ T walk_column(const T* d, const T* r, int nk) {
  // p0..p6 = pio[j-2 .. j+4], the indices clamped into [0, nk]
  T p0 = T(0), p1 = T(0), p2 = T(0);
  const T d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3];
  T p3 = d0;
  T p4 = p3 + d1;
  T p5 = p4 + d2;
  T p6 = p5 + d3;
  T m = nan_min(nan_min(d0, d1), nan_min(d2, d3));
  T tgt = r[0];
#pragma unroll 7
  for (int j = 0; j < nk - 1; ++j) {
    m = nan_min(m, nan_min(tgt - p0, p6 - tgt));
    // the width that brings pio[j+5]; past the top pio[nk] repeats (and
    // the width read is the top one, already in m)
    const int k = j + 4;
    const T dk = d[k < nk ? k : nk - 1];
    m = nan_min(m, dk);
    const T nx = k < nk ? p6 + dk : p6;
    p0 = p1;
    p1 = p2;
    p2 = p3;
    p3 = p4;
    p4 = p5;
    p5 = p6;
    p6 = nx;
    tgt = tgt + r[j + 1];
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kCols)
remap_health_kernel(const T* __restrict__ dps, const T* __restrict__ dpr,
                    T* __restrict__ part, long long ncols, int nk,
                    bool wide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = col_stride(nk);
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* sr = sd + kCols * S;
  const int tid = threadIdx.x;
  constexpr int V = 16 / sizeof(T);
  T m = Inf<T>::v();
  const long long ntiles = (ncols + kCols - 1) / kCols;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long c0 = tile * kCols;
    const int cols = int(ncols - c0 < kCols ? ncols - c0 : kCols);
    const int n = cols * nk;
    const T* __restrict__ gd = dps + c0 * nk;
    const T* __restrict__ gr = dpr + c0 * nk;
    if (wide) {
      // nk*sizeof(T) is a multiple of 16: a vector never leaves its row
      const int step = kCols * V;
      for (int i0 = tid * V; i0 < n; i0 += step * kUnroll) {
        T a[kUnroll][V], b[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * step;
          if (i < n) {
            tse::load_v<V>(gd + i, a[u]);
            tse::load_v<V>(gr + i, b[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * step;
          if (i < n) {
            const int row = i / nk, at = row * S + (i - row * nk);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              sd[at + v] = a[u][v];
              sr[at + v] = b[u][v];
            }
          }
        }
      }
    } else {
      for (int i = tid; i < n; i += kCols) {
        const int row = i / nk, at = row * S + (i - row * nk);
        sd[at] = gd[i];
        sr[at] = gr[i];
      }
    }
    __syncthreads();
    if (tid < cols)
      m = nan_min(m, walk_column(sd + tid * S, sr + tid * S, nk));
    __syncthreads();
  }
  m = block_min(m);
  if (tid == 0) part[blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
remap_health_reduce_kernel(const T* __restrict__ part, int n,
                           T* __restrict__ out) {
  T m = Inf<T>::v();
  for (int i = threadIdx.x; i < n; i += kReduceThreads)
    m = nan_min(m, part[i]);
  m = block_min(m);
  if (threadIdx.x == 0) out[0] = m;
}

template <typename T>
size_t smem_bytes(int nk) {
  return size_t(2) * kCols * col_stride(nk) * sizeof(T);
}

// blocks per SM and SMs of the current device for nk levels
template <typename T>
cudaError_t occupancy(int nk, int* per_sm, int* sms) {
  const size_t bytes = smem_bytes<T>(nk);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(remap_health_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, remap_health_kernel<T>, kCols, bytes);
  return err;
}

template <typename T>
int launch_health(const void* dps, const void* dpr, void* part, void* out,
                  long long ncols, int nk, int nparts, void* stream) {
  if (ncols <= 0 || nk < 4 || nparts <= 0 || smem_bytes<T>(nk) > kSmemMax)
    return int(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  cudaError_t err = occupancy<T>(nk, &per_sm, &sms);
  if (err != cudaSuccess) return int(err);
  const long long ntiles = (ncols + kCols - 1) / kCols;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  blocks = blocks < ntiles ? blocks : ntiles;
  blocks = blocks < nparts ? blocks : nparts;
  const bool wide = (nk * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dps) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dpr) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  remap_health_kernel<T><<<unsigned(blocks), kCols, smem_bytes<T>(nk), st>>>(
      (const T*)dps, (const T*)dpr, (T*)part, ncols, nk, wide);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  remap_health_reduce_kernel<T><<<1, kReduceThreads, 0, st>>>(
      (const T*)part, int(blocks), (T*)out);
  return int(cudaGetLastError());
}

// out[4]: threads (columns) a block, shared memory bytes a block, resident
// blocks per SM, blocks of a launch over a large field
template <typename T>
int health_config(int nk, int* out) {
  if (nk < 4 || smem_bytes<T>(nk) > kSmemMax)
    return int(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  cudaError_t err = occupancy<T>(nk, &per_sm, &sms);
  if (err != cudaSuccess) return int(err);
  out[0] = kCols;
  out[1] = int(smem_bytes<T>(nk));
  out[2] = per_sm;
  out[3] = sms * per_sm;
  return 0;
}

}  // namespace

#define HEALTH_ENTRY(SUFFIX, T)                                             \
  extern "C" int tse_remap_health_t_##SUFFIX(                               \
      const void* dp_star, const void* dp_ref, void* part, void* out,       \
      long long ncols, int nk, int nparts, void* stream) {                  \
    return launch_health<T>(dp_star, dp_ref, part, out, ncols, nk, nparts, \
                            stream);                                        \
  }                                                                         \
  extern "C" int tse_remap_health_config_##SUFFIX(int nk, int* out) {       \
    return health_config<T>(nk, out);                                       \
  }

HEALTH_ENTRY(f32, float)
HEALTH_ENTRY(f64, double)
