// DIA (diagonal-format) SpMV r = A x for Hopper (sm_90a):
//
//     r[i] = sum_k dia[k, i] * x[i - off_k],   i < m,
//
// where a term is 0 when i - off_k lies outside [0, n). dia is the plan's
// [K, rr, 128] array read flat as [K, n_el] (n_el = rr * 128 >= max(m, n)).
//
// Replaces the TPU kernel rsparse_tpu/ops/spmv.py::_dia_kernel_tpu and, in
// float64, its XLA twin _dia_kernel_xla. On the TPU each shift of x was a
// pair of sublane and lane rolls with an iota select for the carry
// (_flat_shift), because Mosaic works on 2-D [sublane, lane] vectors; on
// the card a shift is an offset address, so x is read directly at i - off_k
// and needs no halo padding.
//
// What bounds it on this card: device-memory bytes once the loads are in
// flight. The function must read the K diagonals (K * n_el values), x once
// and write r once, at 2 FLOPs per stored diagonal value; x is re-read K
// times, but neighbouring diagonals hit the same lines in L1/L2. It stays
// bound by issue and latency instead while the loads of term k + 1 wait on
// term k (a runtime loop over K with a bounds check on every term) or while
// a capped grid walks the rows.
//
// Design. One thread per row, one pass: the grid covers the rows, 256 per
// CTA, with no cap and no grid-stride walk, so every load of the run is
// issued at once. Loads of dia, of x and the store of r are contiguous
// across a warp (one 128-byte line per warp and term). For K <= 8 (the 5-
// and 7-point stencils) K is a template argument and the offsets kernel
// arguments, so all 2K loads of a thread issue before its FMAs; a larger K
// stages the offsets in shared memory 256 at a time and unrolls the terms
// by 4. The wrapper computes on the host the row range [lo, hi) where every
// i - off_k lies in [0, n): a CTA inside it skips the bounds checks, and
// only the edge CTAs keep them. When the product's bytes exceed the L2
// (the wrapper decides: float64 at n = 2^20, K = 5), dia, read once per
// product, is loaded with the streaming hint (__ldcs, evict first) and r
// stored with __stcs, so that x keeps its lines; below that, dia stays in
// L2 for the next product on the same plan (an iterative solver's chain).
// k * n_el is a 64-bit offset.
//
// Measured against 16-byte vectors of 4 (float32) or 2 (float64) rows per
// thread: those read x at i - off_k one row at a time, four L1 wavefronts
// per warp where the one-row mapping needs one, and were slower with a
// cold L2 (`PERF.md`).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads (rows) per CTA
constexpr int kChunk = 256;    // offsets staged in shared memory at a time
constexpr int kFixed = 8;      // largest K with its own instantiation

struct Offsets {
  int o[kFixed];
};

template <typename T, bool kStream>
__device__ __forceinline__ T load_dia(const T* p) {
  return kStream ? __ldcs(p) : __ldg(p);
}

template <typename T, bool kStream>
__device__ __forceinline__ void store_r(T* p, T v) {
  if (kStream)
    __stcs(p, v);
  else
    *p = v;
}

// K known at compile time (0..kFixed): every load of the thread first.
template <typename T, int K, bool kStream, bool kInterior>
__device__ __forceinline__ T row_fixed(const T* __restrict__ dia,
                                       const Offsets& off,
                                       const T* __restrict__ x, int64_t n_el,
                                       int n, int64_t i) {
  T d[K > 0 ? K : 1], xv[K > 0 ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) d[k] = load_dia<T, kStream>(dia + k * n_el + i);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t c = i - off.o[k];
    xv[k] = (kInterior || (c >= 0 && c < n)) ? __ldg(x + c) : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) acc += d[k] * xv[k];
  return acc;
}

template <typename T, int K, bool kStream>
__global__ void __launch_bounds__(kThreads)
dia_fixed(const T* __restrict__ dia, Offsets off, const T* __restrict__ x,
          T* __restrict__ r, int64_t n_el, int m, int n, int lo, int hi) {
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = tile0 + threadIdx.x;
  if (i >= m) return;
  const T acc = tile0 >= lo && tile0 + kThreads <= hi  // the same for the CTA
                    ? row_fixed<T, K, kStream, true>(dia, off, x, n_el, n, i)
                    : row_fixed<T, K, kStream, false>(dia, off, x, n_el, n, i);
  store_r<T, kStream>(r + i, acc);
}

// Any K: offsets staged in shared memory, kChunk at a time.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
dia_staged(const T* __restrict__ dia, const int* __restrict__ offsets,
           const T* __restrict__ x, T* __restrict__ r, int K, int64_t n_el,
           int m, int n, int lo, int hi) {
  __shared__ int off_s[kChunk];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = tile0 + threadIdx.x;
  const bool live = i < m;  // no early return: the CTA meets at barriers
  const bool interior = tile0 >= lo && tile0 + kThreads <= hi;
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk's offsets are no longer read
    for (int k = threadIdx.x; k < kc; k += kThreads) off_s[k] = offsets[k0 + k];
    __syncthreads();
    if (!live) continue;
    const T* d = dia + static_cast<int64_t>(k0) * n_el + i;
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const int64_t c = i - off_s[k];
      if (interior || (c >= 0 && c < n))
        acc += load_dia<T, kStream>(d + k * n_el) * __ldg(x + c);
    }
  }
  if (live) store_r<T, kStream>(r + i, acc);
}

template <typename T, bool kStream>
void launch_s(const T* dia, const int* offsets, const Offsets& off,
              const T* x, T* r, int K, int64_t n_el, int m, int n, int lo,
              int hi, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
#define RSP_DIA_FIXED(KK)                                                  \
  case KK:                                                                 \
    dia_fixed<T, KK, kStream><<<blocks, kThreads, 0, s>>>(dia, off, x, r,  \
                                                          n_el, m, n, lo, hi); \
    break;
  switch (K) {
    RSP_DIA_FIXED(0)
    RSP_DIA_FIXED(1)
    RSP_DIA_FIXED(2)
    RSP_DIA_FIXED(3)
    RSP_DIA_FIXED(4)
    RSP_DIA_FIXED(5)
    RSP_DIA_FIXED(6)
    RSP_DIA_FIXED(7)
    RSP_DIA_FIXED(8)
    default:
      dia_staged<T, kStream><<<blocks, kThreads, 0, s>>>(
          dia, offsets, x, r, K, n_el, m, n, lo, hi);
  }
#undef RSP_DIA_FIXED
}

template <typename T>
int launch(int device, const T* dia, const int* offsets, const int* host_off,
           const T* x, T* r, int K, int64_t n_el, int m, int n, int lo, int hi,
           int stream_dia, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Offsets off{};
  for (int k = 0; k < K && k < kFixed; ++k) off.o[k] = host_off[k];
  if (stream_dia)
    launch_s<T, true>(dia, offsets, off, x, r, K, n_el, m, n, lo, hi, s);
  else
    launch_s<T, false>(dia, offsets, off, x, r, K, n_el, m, n, lo, hi, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). dia [K, n_el] flat, offsets
// [K] int32 on the device and host_off the same K offsets in host memory
// (read for K <= 8), x [n], r [m] (m >= 1); every i in [lo, hi) has all
// i - off_k in [0, n); stream_dia (0 or 1) asks for the evict-first loads
// of dia and streaming stores of r. Each returns cudaGetLastError() after
// the launch: 0 when it was accepted.
extern "C" int spmv_dia_f32(int device, const float* dia, const int* offsets,
                            const int* host_off, const float* x, float* r,
                            int K, int64_t n_el, int m, int n, int lo, int hi,
                            int stream_dia, void* stream) {
  return launch<float>(device, dia, offsets, host_off, x, r, K, n_el, m, n,
                       lo, hi, stream_dia, stream);
}

extern "C" int spmv_dia_f64(int device, const double* dia, const int* offsets,
                            const int* host_off, const double* x, double* r,
                            int K, int64_t n_el, int m, int n, int lo, int hi,
                            int stream_dia, void* stream) {
  return launch<double>(device, dia, offsets, host_off, x, r, K, n_el, m, n,
                        lo, hi, stream_dia, stream);
}
