// Streaming SpMM R[m, B] = A X[n, B] for any sparsity pattern, with A held
// as a CSR copy, for Hopper (sm_90a). X and R are row-major.
//
// Replaces the TPU kernel rsparse_tpu/ops/spmm_pallas.py::_spmm_call (f32
// only there, with a 9 MiB VMEM gate) and, for float64 and for matrices
// past that gate, the JAX package's host scatter in ops.gaxpy_multi.
//
// Why not the TPU design. The TPU kernel is one sequential grid over
// 1024-entry chunks of the CSC entry stream, carrying acc[m, B] in VMEM
// from chunk to chunk: acc[row_e, :] += v_e * X[col_e, :]. Blocks on the
// card run in parallel and carry nothing between them, and a CSC stream
// scattered by many blocks needs an atomic per entry and column plus a
// zero-fill pass. So the wrapper gathers A's values into CSR order (the
// transpose plan's permutation, cached per pattern on the host) and every
// output row is owned by one group of lanes: sums stay in registers, each
// element of R is written once, no atomics, no zero fill, the same result
// on every run.
//
// What bounds it on this card: device-memory bytes, and which bytes depends
// on the pattern. Each entry gathers a row of X. X is row-major, so a
// gather of any width touches whole 128-byte L2 lines. When the pattern
// has no locality and X is much larger than the 50 MiB L2, almost no X row
// is still in L2 when it is gathered again: the kernel moves about nnz * B
// values of X where the function needs n * B (at n = 2^20, 5.2 M entries,
// B = 128 in float64: ~5.3 GB against 1.07 GB). Slabs of a few RHS columns
// do not cut that here: a narrow slab of 2^20 rows still touches 2^20 L2
// lines (128 MiB), more than the L2 holds, and measured several times
// slower (`PERF.md`). Wide contiguous gathers with many in flight are the
// cheapest way to move those bytes.
//
// Design. A group of W lanes (a power of two, the least for which W lanes
// of 32 bytes cover B columns, at most 32) owns one output row and one
// tile of W * 32 bytes of columns (128 float64 or 256 float32 at W = 32);
// a second grid dimension covers wider B with ragged tiles. Lane l takes
// the columns c_lo + (k W + l) V + [0, V), k < K, of the tile starting at
// column c_lo, K V values being 32 bytes: float4
// vectors in float32 when B and X's base allow it, scalars otherwise and
// in float64 (two-double vectors measured slower on the stencil, no faster
// on the random pattern). The entry loop is unrolled by 2, so that two
// entries' gathers are in flight before their FMAs, and at least 5 CTAs of
// 256 threads stay on each SM (48 registers, no spill); unrolled by 4, or
// with no floor on the CTAs per SM, it was slower. A and X are read through
// the read-only path and R stored plainly: streaming hints on A's stream
// (evict first) and an evict-last policy on X were measured slower. Sums
// stay in registers and each element of R is written once. Offsets row*B
// and col*B are 64-bit.
//
// Residual form. With a matrix S[m, B] passed (the template flag Sub, set
// when the entry point gets S), the store writes R = S - A X: S's element
// is read once, beside the row's sums, and nothing else changes; the plain
// instantiation (Sub false) never reads S. It is the serve handles'
// refinement residual B - A X in one launch (`solve._make_serve_handle` on
// a card). There it replaces `solve._coo_amul` (the JAX package's
// `_coo_amul`, a segment sum that XLA lowers), which on the card is a
// gather of X into an [nnz, B] temporary, a product into a second, a zero
// fill and an atomic index_add_ per entry and column, then the
// subtraction. Its bound is A's CSR (12 bytes an entry in float64) and X,
// S and R once each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA (a multiple of every W)
constexpr int kMinBlocks = 5;  // CTAs per SM at least (registers <= 48)
constexpr int kUnroll = 2;     // entries gathered before their FMAs

template <typename T, int V>
struct Pack {
  T v[V];
};

// A gather of V values of X (V = 1, or a float4).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_x(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.v[0] = __ldg(p);
  } else {
    static_assert(V == 4 && sizeof(T) == 4, "vectors are float4");
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_r(T* p, const T (&a)[V]) {
  if constexpr (V == 1) {
    p[0] = a[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
}

// One output row of one tile of `tile` (= W K V) columns per group of W
// lanes; the tile is blockIdx.y. (`tile` is a run-time argument: with it
// folded into a constant, nvcc schedules the float64 loop differently and
// the kernel measured slower on the stencil.) Sub: R = S - A X; otherwise
// S is not read.
template <typename T, int V, int W, bool Sub>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_rows(const int* __restrict__ rowptr, const int* __restrict__ colidx,
          const T* __restrict__ vals, const T* __restrict__ X,
          const T* __restrict__ S, T* __restrict__ R, int m, int B,
          int tile) {
  constexpr int K = 32 / static_cast<int>(sizeof(T)) / V;
  constexpr int G = kThreads / W;  // rows per CTA
  const int row = blockIdx.x * G + threadIdx.x / W;
  if (row >= m) return;
  const int lane = threadIdx.x % W;
  const int c_lo = blockIdx.y * tile;
  const int c_hi = min(B, c_lo + tile);
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) on[k] = c_lo + (k * W + lane) * V < c_hi;
  T acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = T(0);
  const T* xs = X + c_lo + lane * V;
  const int e1 = __ldg(rowptr + row + 1);
  int e = __ldg(rowptr + row);
  for (; e + kUnroll <= e1; e += kUnroll) {
    int c[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c[u] = __ldg(colidx + e + u);
      v[u] = __ldg(vals + e + u);
    }
    Pack<T, V> xv[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (on[k])
          xv[u][k] =
              load_x<T, V>(xs + static_cast<int64_t>(c[u]) * B + k * W * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (on[k])
#pragma unroll
          for (int j = 0; j < V; ++j) acc[k][j] += v[u] * xv[u][k].v[j];
  }
  for (; e < e1; ++e) {
    const int c = __ldg(colidx + e);
    const T v = __ldg(vals + e);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (on[k]) {
        const Pack<T, V> x1 =
            load_x<T, V>(xs + static_cast<int64_t>(c) * B + k * W * V);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] += v * x1.v[j];
      }
  }
  const int64_t out = static_cast<int64_t>(row) * B + c_lo + lane * V;
  if constexpr (Sub) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (on[k]) {
        const Pack<T, V> s1 = load_x<T, V>(S + out + k * W * V);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = s1.v[j] - acc[k][j];
      }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (on[k]) store_r<T, V>(R + out + k * W * V, acc[k]);
}

template <typename T, int V, int W>
int launch_vw(const int* rowptr, const int* colidx, const T* vals, const T* X,
              const T* S, T* R, int m, int B, cudaStream_t s) {
  constexpr int G = kThreads / W;
  constexpr int tile = W * 32 / static_cast<int>(sizeof(T));
  const dim3 grid(static_cast<unsigned>((m + G - 1) / G),
                  static_cast<unsigned>((B + tile - 1) / tile));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (S != nullptr)
    spmm_rows<T, V, W, true><<<grid, kThreads, 0, s>>>(rowptr, colidx, vals,
                                                        X, S, R, m, B, tile);
  else
    spmm_rows<T, V, W, false><<<grid, kThreads, 0, s>>>(rowptr, colidx, vals,
                                                         X, S, R, m, B, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_v(const int* rowptr, const int* colidx, const T* vals, const T* X,
             const T* S, T* R, int m, int B, int W, cudaStream_t s) {
  switch (W) {
    case 1: return launch_vw<T, V, 1>(rowptr, colidx, vals, X, S, R, m, B, s);
    case 2: return launch_vw<T, V, 2>(rowptr, colidx, vals, X, S, R, m, B, s);
    case 4: return launch_vw<T, V, 4>(rowptr, colidx, vals, X, S, R, m, B, s);
    case 8: return launch_vw<T, V, 8>(rowptr, colidx, vals, X, S, R, m, B, s);
    case 16: return launch_vw<T, V, 16>(rowptr, colidx, vals, X, S, R, m, B, s);
    case 32: return launch_vw<T, V, 32>(rowptr, colidx, vals, X, S, R, m, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). rowptr [m + 1] and colidx
// [nnz] are int32 CSR arrays, vals [nnz] the values in CSR order, X [n, B]
// and R [m, B] row-major. S [m, B], row-major, or null: given, R = S - A X
// (the residual form), else R = A X. V is the vector width (1, or 4 in
// float32 only: then B is a multiple of 4 and X and S 16-byte aligned), W
// the lanes per row (1, 2, 4, 8, 16 or 32). Each returns cudaGetLastError()
// after the launch: 0 when it was accepted.
extern "C" int spmm_csr_f32(int device, const int* rowptr, const int* colidx,
                            const float* vals, const float* X, const float* S,
                            float* R, int m, int B, int V, int W,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 1)
    return launch_v<float, 1>(rowptr, colidx, vals, X, S, R, m, B, W, s);
  if (V == 4 && B % 4 == 0)
    return launch_v<float, 4>(rowptr, colidx, vals, X, S, R, m, B, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int spmm_csr_f64(int device, const int* rowptr, const int* colidx,
                            const double* vals, const double* X,
                            const double* S, double* R, int m, int B, int V,
                            int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (V != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v<double, 1>(rowptr, colidx, vals, X, S, R, m, B, W,
                             static_cast<cudaStream_t>(stream));
}
