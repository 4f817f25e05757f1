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
// with a bounds check and needs no halo padding.
//
// Design. One thread per output row, in a grid-stride loop. The offsets
// come from a device int32 array and are staged in shared memory, 256 at a
// time: each chunk is loaded once per block, then every thread adds that
// chunk's terms to its rows (a K of up to 256 is one chunk, and r is
// written once). Reads of dia[k, i] and of x[i - off_k] are contiguous
// across a warp. k * n_el is a 64-bit offset.
//
// What bounds it on this card: device-memory bytes. The function must read
// the K diagonals (K * n_el values), x once and write r once, at 2 FLOPs
// per stored diagonal value; x is re-read K times, but neighbouring
// diagonals hit the same lines in L1/L2. Padding of short diagonals
// (zeros stored at the ends) is read like any value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kChunk = 256;    // offsets staged in shared memory at a time
constexpr int kMaxBlocks = 2048;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv(const T* __restrict__ dia, const int* __restrict__ offsets,
         const T* __restrict__ x, T* __restrict__ r, int K, int64_t n_el,
         int m, int n) {
  __shared__ int off_s[kChunk];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int nchunks = K > 0 ? (K + kChunk - 1) / kChunk : 1;  // K = 0: r = 0
  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * kChunk;
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk's offsets are no longer read
    for (int k = threadIdx.x; k < kc; k += blockDim.x) off_s[k] = offsets[k0 + k];
    __syncthreads();
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < m; i += stride) {
      T acc = c == 0 ? T(0) : r[i];
      const T* d = dia + static_cast<int64_t>(k0) * n_el + i;
      for (int k = 0; k < kc; ++k) {
        const int64_t j = i - off_s[k];
        if (j >= 0 && j < n) acc += __ldg(d + k * n_el) * __ldg(x + j);
      }
      r[i] = acc;
    }
  }
}

template <typename T>
int launch(int device, const T* dia, const int* offsets, const T* x, T* r,
           int K, int64_t n_el, int m, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (static_cast<int64_t>(m) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < kMaxBlocks ? need : kMaxBlocks);
  dia_spmv<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dia, offsets, x, r, K, n_el, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). dia [K, n_el] flat, offsets
// [K] int32, x [n], r [m] (m >= 1). Each returns cudaGetLastError() after
// the launch: 0 when it was accepted.
extern "C" int spmv_dia_f32(int device, const float* dia, const int* offsets,
                            const float* x, float* r, int K, int64_t n_el,
                            int m, int n, void* stream) {
  return launch<float>(device, dia, offsets, x, r, K, n_el, m, n, stream);
}

extern "C" int spmv_dia_f64(int device, const double* dia, const int* offsets,
                            const double* x, double* r, int K, int64_t n_el,
                            int m, int n, void* stream) {
  return launch<double>(device, dia, offsets, x, r, K, n_el, m, n, stream);
}
