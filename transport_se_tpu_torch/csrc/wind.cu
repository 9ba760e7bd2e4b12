// The T subcycle's winds from their factored basis (the wind kernel) for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package evaluates the basis with four
// `jnp.einsum` calls that it leaves to XLA (transport_se_tpu/model/
// wind_basis.py WindBasis.eval).  The port evaluated it in plain PyTorch as
// a chain of broadcast products and sums (ops/wind.py wind_eval_t_plain,
// the plain version), 46 passes over level-width fields [E, 16, K] a tracer
// step; this kernel writes each of the four fields the T path reads once.
//
// Per point (e, p) and level k, over the T terms i of the basis:
//   fks_i = fk[i,k]*s[i], prs_i = prof[i,k]*s[i]
//   u     = u2d[0,e,p]*fks_0 + u2d[1,e,p]*fks_1 + ...   (left to right)
//   v     = the same with v2d;  un0 = u*dp0[k], vn0 = v*dp0[k]
//   divdp = g2d[0,e,p]*prs_0 + ...;  divdp_proj = the same with gp2d
// Every sum starts from its first product and adds the others in the
// order of the terms, as the plain chain does, terms that are all zero
// included (skipping them could change the sign of a zero).  The build
// has --fmad=false, so kernel and plain version agree to the last bit.
//
// Bound on the H100: device-memory bytes, nearly all of them stores.  It
// writes four [E, 16, K] fields and reads the four [T, E, 16] bases once:
// at NE120 (86,400 elements, K = 72, T = 6, f32) 1.59 + 0.13 GB, 0.515 ms
// at 3.35 TB/s.  Its arithmetic, 2T operations per value stored, is about
// 3 operations a byte, below the card's rate.  So the design keeps the
// stores wide and streaming and everything else off the memory bus:
//   - a block walks a flat range of (row, level) values, row = e*16 + p,
//     levels fastest, as the outputs lie.  A thread owns one 16-byte vector
//     of V levels of one row (V = 4 in f32, 2 in f64) in all four outputs,
//     so that neighbouring threads store to neighbouring addresses; where K
//     is not a multiple of V a vector could straddle two rows, and the
//     kernel is launched with V = 1 (scalar stores);
//   - the per-level factors fk*s, prof*s and dp0, (2T + 1)*K values, are
//     staged in shared memory once a block (3.7 KB at T = 6, K = 72 in
//     f32), and the blocks are as many as the card holds at once, each
//     looping over the range, so a block stages them once;
//   - a thread reads its row's 4T basis values once, those of up to 8
//     terms in one burst of loads before the first product: a loop that
//     loaded a term's four values and then multiplied left each load's
//     latency in line (0.849 against 0.715 ms a launch at NE120 f32, 1.856
//     against 1.532 f64, at 48 / 51 registers against 78 / 113, no spill;
//     NVIDIA H100 80GB HBM3, 700 W).  The ~K/V threads that share a row
//     find its values in L1;
//   - the outputs are stored with the evict-first hint (st.global.cs):
//     1.6 GB a call does not fit the 50 MB L2.
// No atomics and no state shared between blocks.  T, K and the row count
// come from the caller; one kernel serves every shape.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// terms whose basis values a thread loads together (DCMIP 1-1 has 6)
constexpr int kChunk = 8;
// the largest dynamic shared memory a block takes without opting in
constexpr int kMaxShared = 48 * 1024;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wind_kernel(const T* __restrict__ u2d, const T* __restrict__ v2d,
            const T* __restrict__ g2d, const T* __restrict__ gp2d,
            const T* __restrict__ s, const T* __restrict__ fk,
            const T* __restrict__ prof, const T* __restrict__ dp0,
            T* __restrict__ un0, T* __restrict__ vn0, T* __restrict__ divdp,
            T* __restrict__ divdp_proj, int nt, uint32_t rows, int nk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fks = reinterpret_cast<T*>(smem_raw);  // [nt, nk]
  T* prs = fks + nt * nk;                   // [nt, nk]
  T* dpk = prs + nt * nk;                   // [nk]
  const int tk = nt * nk;
  for (int j = threadIdx.x; j < 2 * tk + nk; j += kThreads) {
    if (j < tk) {
      fks[j] = fk[j] * s[j / nk];
    } else if (j < 2 * tk) {
      prs[j - tk] = prof[j - tk] * s[(j - tk) / nk];
    } else {
      dpk[j - 2 * tk] = dp0[j - 2 * tk];
    }
  }
  __syncthreads();
  const uint32_t nvec = rows * uint32_t(nk) / V;
  for (uint32_t w = blockIdx.x * kThreads + threadIdx.x; w < nvec;
       w += gridDim.x * kThreads) {
    const uint32_t flat = w * V;
    const uint32_t row = flat / uint32_t(nk);
    const int k0 = int(flat - row * uint32_t(nk));
    T u[V], v[V], d[V], p[V];
    for (int i0 = 0; i0 < nt; i0 += kChunk) {
      // the row's basis values of a chunk of terms, all loads issued
      // before the first product waits on one
      T bu[kChunk], bv[kChunk], bg[kChunk], bp[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (i0 + j < nt) {
          const size_t at = size_t(i0 + j) * rows + row;
          bu[j] = __ldg(u2d + at);
          bv[j] = __ldg(v2d + at);
          bg[j] = __ldg(g2d + at);
          bp[j] = __ldg(gp2d + at);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int i = i0 + j;
        if (i >= nt) break;
        T f[V], q[V];
        tse::load_v<V>(fks + i * nk + k0, f);
        tse::load_v<V>(prs + i * nk + k0, q);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          if (i == 0) {
            u[c] = bu[j] * f[c];
            v[c] = bv[j] * f[c];
            d[c] = bg[j] * q[c];
            p[c] = bp[j] * q[c];
          } else {
            u[c] = u[c] + bu[j] * f[c];
            v[c] = v[c] + bv[j] * f[c];
            d[c] = d[c] + bg[j] * q[c];
            p[c] = p[c] + bp[j] * q[c];
          }
        }
      }
    }
    T w0[V];
    tse::load_v<V>(dpk + k0, w0);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      u[c] = u[c] * w0[c];
      v[c] = v[c] * w0[c];
    }
    tse::store_v<true, V>(un0 + flat, u);
    tse::store_v<true, V>(vn0 + flat, v);
    tse::store_v<true, V>(divdp + flat, d);
    tse::store_v<true, V>(divdp_proj + flat, p);
  }
}

template <typename T>
size_t shared_bytes(int nt, int nk) {
  return size_t(2 * nt + 1) * nk * sizeof(T);
}

// the vector width of a launch: 16 bytes where K splits into them
template <typename T>
int vec_of(int nk) {
  constexpr int V = 16 / sizeof(T);
  return nk % V == 0 ? V : 1;
}

template <typename T, int V>
int resident_blocks(size_t smem, int* out) {
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, wind_kernel<T, V>, kThreads, smem));
}

template <typename T>
int launch_wind(const void* u2d, const void* v2d, const void* g2d,
                const void* gp2d, const void* s, const void* fk,
                const void* prof, const void* dp0, void* un0, void* vn0,
                void* divdp, void* divdp_proj, int nt, int ne, int nk,
                void* stream) {
  constexpr int VW = 16 / sizeof(T);
  const long long rows = 16LL * ne;
  const size_t smem = shared_bytes<T>(nt, nk);
  if (nt < 1 || ne < 1 || nk < 1 || rows * nk > 0x7fffffffLL ||
      smem > size_t(kMaxShared))
    return int(cudaErrorInvalidValue);
  const int V = vec_of<T>(nk);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaError_t(V == VW ? resident_blocks<T, VW>(smem, &per_sm)
                              : resident_blocks<T, 1>(smem, &per_sm));
  if (err != cudaSuccess) return int(err);
  const long long need = (rows * nk / V + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = unsigned(need < most ? need : most);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *a = (const T*)u2d, *b = (const T*)v2d, *g = (const T*)g2d,
          *gp = (const T*)gp2d, *sv = (const T*)s, *f = (const T*)fk,
          *pr = (const T*)prof, *w = (const T*)dp0;
  T *o1 = (T*)un0, *o2 = (T*)vn0, *o3 = (T*)divdp, *o4 = (T*)divdp_proj;
  if (V == VW) {
    wind_kernel<T, VW><<<blocks, kThreads, smem, st>>>(
        a, b, g, gp, sv, f, pr, w, o1, o2, o3, o4, nt, uint32_t(rows), nk);
  } else {
    wind_kernel<T, 1><<<blocks, kThreads, smem, st>>>(
        a, b, g, gp, sv, f, pr, w, o1, o2, o3, o4, nt, uint32_t(rows), nk);
  }
  return int(cudaGetLastError());
}

// out[4]: values a thread stores a field (V), threads a block, shared bytes
// a block, resident blocks per SM
template <typename T>
int wind_config(int nt, int nk, int* out) {
  const size_t smem = shared_bytes<T>(nt, nk);
  if (nt < 1 || nk < 1 || smem > size_t(kMaxShared))
    return int(cudaErrorInvalidValue);
  constexpr int VW = 16 / sizeof(T);
  const int V = vec_of<T>(nk);
  int per_sm = 0;
  const int err = V == VW ? resident_blocks<T, VW>(smem, &per_sm)
                          : resident_blocks<T, 1>(smem, &per_sm);
  if (err != 0) return err;
  out[0] = V;
  out[1] = kThreads;
  out[2] = int(smem);
  out[3] = per_sm;
  return 0;
}

}  // namespace

#define WIND_ENTRY(SUFFIX, T)                                               \
  extern "C" int tse_wind_eval_t_##SUFFIX(                                  \
      const void* u2d, const void* v2d, const void* g2d, const void* gp2d,  \
      const void* s, const void* fk, const void* prof, const void* dp0,     \
      void* un0, void* vn0, void* divdp, void* divdp_proj, int nt, int ne,  \
      int nk, void* stream) {                                               \
    return launch_wind<T>(u2d, v2d, g2d, gp2d, s, fk, prof, dp0, un0, vn0,  \
                          divdp, divdp_proj, nt, ne, nk, stream);           \
  }                                                                         \
  extern "C" int tse_wind_config_##SUFFIX(int nt, int nk, int* out) {       \
    return wind_config<T>(nt, nk, out);                                     \
  }

WIND_ENTRY(f32, float)
WIND_ENTRY(f64, double)
