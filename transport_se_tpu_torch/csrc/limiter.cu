// Limiter 8 on rows of 16 GLL points (K10) for sm_90a.
//
// Replaces transport_se_tpu/ops/pallas_limiter.py:40 _limiter_kernel
// (reached through limiter_optim_pallas and limiter_optim_iter_full_pallas,
// the drop-in replacement for ops/limiter.py limiter_optim_iter_full).
// Plain PyTorch version: ops/limiter.py limiter_optim_iter_full_plain.
//
// Rows [N, 16] of ptens, bounds [N], and rows of sphweights and dpmass
// that may be shared by several ptens rows (see bcast_row).  Per row:
// x = ptens/dpmass and c = sphweights*dpmass; mass = sum(c*x) and
// sumc = sum(c) relax the bounds for feasibility (returned); then the
// clip-and-redistribute iteration of common.cuh, the body K1 runs, and
// out = x*dpmass.  A row with sumc <= 0 returns ptens unchanged.  The
// std-layout euler stage calls it with N = E*q*k rows (1.56 M at NE30),
// spheremp [E, 16] and dp_star [E, k, 16] read in place.
//
// Bound on the H100: device-memory bytes.  With [N, 16] weights and
// thicknesses a call reads three [N, 16] fields and two [N] bounds and
// writes one field and two bounds: 0.85 GB at NE30 f64, 0.25 ms at
// 3.35 TB/s.  The std stage's shared rows cut that to 0.50 GB (0.15 ms):
// the q tracer rows of an (element, level) read one dp_star row, through
// the caches.  The arithmetic (up to 15 passes of ~10 operations per
// point) is far below the card's rate.
//
// The first form (a thread a row, its 16 x, c and dpmass in registers,
// 16-byte vector loads, IEEE divisions) took 0.30-0.36 ms f64 / 0.13-0.18
// ms f32 there (NVIDIA H100 80GB HBM3, 700 W; 42-50% / 41-58% of the
// bound).  In f64 its row state (156 registers) held few warps resident,
// one load instruction of a warp touched 32 rows 128 bytes apart, a warp
// ran until the slowest of its 32 rows converged, and each row made 16
// IEEE divisions.  This form (launch shape per dtype in Shape):
//   - f64: a quad of lanes owns a row: lane t holds points t, t+4, t+8 and
//     t+12 (64 registers), so a warp's load is 8 rows x 32 adjacent bytes
//     and a warp waits for the slowest of 8 rows.  Every 16-point sum is
//     common.cuh's row_sum16, the _sum16 tree over the quad's lanes, and
//     the quad's lanes see the same addmass, so they leave the iteration
//     together.  f32: a thread a row, as before, where the quad's per-row
//     instructions (index arithmetic, exchanges) cost more than its
//     narrower rows save;
//   - x = ptens/dpmass runs inline (tse::div_by with the reciprocal of
//     dpmass, K3's and K7's form), which gives the IEEE quotient while
//     ptens and dpmass lie in common.cuh's ranges (ptens may be +0); a
//     lane whose operands leave them divides with IEEE divisions.
// Tried and dropped (k10_variants, PERF.md): a prologue that puts each
// dpmass row and its reciprocal into shared memory once for the q tracer
// rows that read it (its barrier held every row's loads back behind the
// dpmass loads: 0.28 against 0.21 ms f64); f32 rows in 16-byte accesses
// transposed in the quad; a pair of lanes a row; evict-first stores.
// The TPU kernel's [2048, 16] blocks, its VMEM transpose (points to
// sublanes) and its block-wide exit have no counterpart: every row exits on
// its own convergence, which equals the block exit because converged rows
// are fixed points of the body.  The divide, the weight product and the
// final multiply, which the TPU wrapper leaves to XLA, run in the kernel.
// python -m transport_se_tpu_torch.k10_variants measures the choices.
//
// K10 has a counting form (COUNT, launched through its own entry;
// ops/limiter.py does so inside counters.counting()): over its valid rows
// it adds the limiter's passes, the rows and the rows stopped at the cap
// unconverged, summed over the lanes of a warp that reach the count
// together and added by one atomic a counter into one of `slots` rows of
// the buffer (the block's index modulo slots), as K1's counting form adds
// its columns'.  The form without counting carries none of it.
//
// Every 16-point sum is the _sum16 pairwise tree and the build has
// --fmad=false, so the kernel and its plain version agree to the last bit.

#include "common.cuh"

namespace {

using tse::limiter_iterate;
using tse::put;
using tse::row_sum16;

// Launch shape per dtype (k10_variants, PERF.md): lanes a row (1: a
// thread the whole row; 4: a quad, row_sum16's layout), threads a block
// and the resident blocks per SM asked of __launch_bounds__.  At NE30 a
// quad a row was fastest in f64 and a thread a row in f32, where the
// quad's extra per-row instructions outweigh its narrower rows.
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int lanes = 1, threads = 128, min_blocks = 1;
};
template <>
struct Shape<double> {
  static constexpr int lanes = 4, threads = 128, min_blocks = 1;
};
template <typename T>
constexpr int kPoints = 16 / Shape<T>::lanes;  // points a lane owns
constexpr int kMaxIter = 15;                   // np*np - 1
// measuring switches (k10_variants): x = ptens/dpmass by the IEEE division
// throughout; the output stored with the evict-first hint (st.global.cs)
constexpr bool kIeeeDivide = false;
constexpr bool kStreamStores = false;

// lane t's points of a row in row_sum16's layout: one thread's sixteen in
// 16-byte accesses; a quad lane's t + 4i, one point a load
template <typename T>
__device__ __forceinline__ void load_pts(const T* __restrict__ row, int t,
                                         T (&v)[kPoints<T>]) {
  if constexpr (Shape<T>::lanes == 1) {
    tse::load_v<16>(row, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(row + t + 4 * i);
  }
}

template <typename T>
__device__ __forceinline__ void store_pts(T* __restrict__ row, int t,
                                          const T (&v)[kPoints<T>]) {
  if constexpr (Shape<T>::lanes == 1) {
    tse::store_v<kStreamStores, 16>(row, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) put<kStreamStores>(row + t + 4 * i, v[i]);
  }
}

// The row of a broadcast operand that ptens row r reads: the operand's
// rows repeat `rep` times in blocks of `inner` consecutive ptens rows.
// rep = inner = 1 is a full [N, 16] operand; for ptens [E, q, k, 16],
// spheremp [E, 16] is rep = q*k, inner = 1 and dp_star [E, k, 16] is
// rep = q, inner = k.  Row counts fit 32 bits (the launch checks).
__device__ __forceinline__ uint32_t bcast_row(uint32_t r, uint32_t rep,
                                              uint32_t inner) {
  return (r / (rep * inner)) * inner + r % inner;
}

// The counting form's tally of a valid row from the one lane that counts
// it: its passes (conv, or the cap where conv = 0: stopped unconverged),
// the row, and whether it was capped, summed over the lanes of the warp
// that arrive together and added by the first of them into row (block
// index % slots) of counts [slots, 3].
__device__ __forceinline__ void count_row(unsigned long long* counts,
                                          int slots, int conv) {
  const unsigned mask = __activemask();
  const unsigned passes =
      __reduce_add_sync(mask, unsigned(conv > 0 ? conv : kMaxIter));
  const unsigned capped = __popc(__ballot_sync(mask, conv == 0));
  if (int(threadIdx.x % 32) == __ffs(mask) - 1) {
    unsigned long long* const row = counts + size_t(blockIdx.x % slots) * 3;
    atomicAdd(row, (unsigned long long)passes);
    atomicAdd(row + 1, (unsigned long long)__popc(mask));
    atomicAdd(row + 2, (unsigned long long)capped);
  }
}

template <typename T, bool COUNT>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::min_blocks)
limiter_kernel(const T* __restrict__ ptens, const T* __restrict__ sph,
               const T* __restrict__ dpmass, const T* __restrict__ minp,
               const T* __restrict__ maxp, T* __restrict__ out,
               T* __restrict__ minp_out, T* __restrict__ maxp_out,
               uint32_t n, uint32_t sph_rep, uint32_t sph_inner,
               uint32_t dp_rep, uint32_t dp_inner, T tol_rel,
               unsigned long long* __restrict__ counts, int slots) {
  constexpr int R = Shape<T>::lanes;
  constexpr int P = kPoints<T>;
  // a row to R adjacent lanes: a quad's lanes leave together
  const uint32_t row = (blockIdx.x * Shape<T>::threads + threadIdx.x) / R;
  const int t = threadIdx.x % R;
  if (row >= n) return;
  T x0[P], x[P], c[P], dp[P];
  load_pts(ptens + size_t(row) * 16, t, x0);
  load_pts(sph + size_t(bcast_row(row, sph_rep, sph_inner)) * 16, t, c);
  load_pts(dpmass + size_t(bcast_row(row, dp_rep, dp_inner)) * 16, t, dp);
  const T mn0 = minp[row];
  const T mx0 = maxp[row];
  bool slow = kIeeeDivide;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    c[i] = c[i] * dp[i];
    slow |= tse::outside(dp[i], tse::Bits<T>::d_lo, tse::Bits<T>::d_hi) ||
            tse::outside_abs(x0[i], tse::Bits<T>::q_lo, tse::Bits<T>::q_hi);
  }
  if (!slow) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      x[i] = tse::div_by(x0[i], dp[i], tse::recip(dp[i]));
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = x0[i] / dp[i];
  }
  const T sumc = row_sum16(c);
  T cx[P];
#pragma unroll
  for (int i = 0; i < P; ++i) cx[i] = c[i] * x[i];
  const T mass = row_sum16(cx);
  const bool valid = sumc > T(0);
  const T safe = valid ? sumc : T(1);
  const T mn = mass < mn0 * safe ? mass / safe : mn0;
  const T mx = mass > mx0 * safe ? mass / safe : mx0;
  if (t == 0) {
    minp_out[row] = mn;
    maxp_out[row] = mx;
  }
  if (!valid) {
    store_pts(out + size_t(row) * 16, t, x0);
    return;
  }
  [[maybe_unused]] const int conv =
      limiter_iterate(x, c, mn, mx, tol_rel * fabs(mass), kMaxIter);
  if constexpr (COUNT) {
    if (t == 0) count_row(counts, slots, conv);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) x[i] = x[i] * dp[i];
  store_pts(out + size_t(row) * 16, t, x);
}

// counts: the counting form's int64 [slots, 3] buffer (COUNT), else null
template <typename T, bool COUNT>
int launch_limiter(const void* ptens, const void* sph, const void* dpmass,
                   const void* minp, const void* maxp, void* out,
                   void* minp_o, void* maxp_o, long long n,
                   long long sph_rep, long long sph_inner, long long dp_rep,
                   long long dp_inner, double tol, void* stream, void* counts,
                   int slots) {
  constexpr int R = Shape<T>::lanes, threads = Shape<T>::threads;
  if (n <= 0 || n > 0x7fffffffLL / R || sph_rep < 1 || sph_inner < 1 ||
      dp_rep < 1 || dp_inner < 1 || n % (sph_rep * sph_inner) ||
      n % (dp_rep * dp_inner) || (COUNT && (counts == nullptr || slots <= 0)))
    return int(cudaErrorInvalidValue);
  const long long blocks = (n * R + threads - 1) / threads;
  limiter_kernel<T, COUNT><<<unsigned(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      (const T*)ptens, (const T*)sph, (const T*)dpmass, (const T*)minp,
      (const T*)maxp, (T*)out, (T*)minp_o, (T*)maxp_o, uint32_t(n),
      uint32_t(sph_rep), uint32_t(sph_inner), uint32_t(dp_rep),
      uint32_t(dp_inner), T(tol), (unsigned long long*)counts, slots);
  return int(cudaGetLastError());
}

// out[3]: lanes a row, threads a block, resident blocks per SM
template <typename T>
int limiter_config(int* out) {
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, limiter_kernel<T, false>, Shape<T>::threads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = Shape<T>::lanes;
  out[1] = Shape<T>::threads;
  out[2] = resident;
  return 0;
}

}  // namespace

#define LIMITER_ENTRY(SUFFIX, T)                                            \
  extern "C" int tse_limiter_optim_##SUFFIX(                                \
      const void* ptens, const void* sph, const void* dpmass,               \
      const void* minp, const void* maxp, void* out, void* minp_o,          \
      void* maxp_o, long long n, long long sph_rep, long long sph_inner,    \
      long long dp_rep, long long dp_inner, double tol, void* stream) {     \
    return launch_limiter<T, false>(ptens, sph, dpmass, minp, maxp, out,    \
                                    minp_o, maxp_o, n, sph_rep, sph_inner,  \
                                    dp_rep, dp_inner, tol, stream, nullptr, \
                                    0);                                     \
  }                                                                         \
  extern "C" int tse_limiter_optim_count_##SUFFIX(                          \
      const void* ptens, const void* sph, const void* dpmass,               \
      const void* minp, const void* maxp, void* out, void* minp_o,          \
      void* maxp_o, long long n, long long sph_rep, long long sph_inner,    \
      long long dp_rep, long long dp_inner, double tol, void* stream,       \
      void* counts, int slots) {                                            \
    return launch_limiter<T, true>(ptens, sph, dpmass, minp, maxp, out,     \
                                   minp_o, maxp_o, n, sph_rep, sph_inner,   \
                                   dp_rep, dp_inner, tol, stream, counts,   \
                                   slots);                                  \
  }                                                                         \
  extern "C" int tse_limiter_config_##SUFFIX(int* out) {                    \
    return limiter_config<T>(out);                                          \
  }

LIMITER_ENTRY(f32, float)
LIMITER_ENTRY(f64, double)
