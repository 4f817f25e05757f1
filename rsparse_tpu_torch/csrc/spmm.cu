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
// output row is owned by one group of lanes.
//
// Design. A group of W lanes (W = 1..32, a power of two chosen by the
// wrapper from B) owns one output row and a tile of 4W columns; lane l
// takes columns l, l + W, l + 2W, l + 3W of the tile, so each step of the
// entry loop reads W contiguous values of X's row per column slot
// (coalesced, any B, no alignment condition). The sums stay in registers
// and each element of R is written exactly once: no atomics, no zero-fill,
// the same result on every run. Empty rows write zeros; a second grid
// dimension covers B wider than one tile. Offsets row*B and col*B are
// 64-bit.
//
// What bounds it on this card: device-memory bytes. Each entry reads one
// row of X (B values), scattered over X by the pattern, so the kernel moves
// at least nnz * B values of X where the function needs only n * B, unless
// the L2 cache (50 MB) holds the rows that neighbouring row groups share.
// The FLOPs (2 nnz B) are far below the card's rate. A later change can
// reorder rows for locality or stage reused X rows in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA (a multiple of every W)
constexpr int kSlots = 4;      // columns per lane in one tile

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
spmm_rows(const int* __restrict__ rowptr, const int* __restrict__ colidx,
          const T* __restrict__ vals, const T* __restrict__ X,
          T* __restrict__ R, int m, int B) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / W;
  if (row >= m) return;
  const int c0 = blockIdx.y * (kSlots * W) + static_cast<int>(threadIdx.x % W);
  T acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = T(0);
  const int e1 = rowptr[row + 1];
  for (int e = rowptr[row]; e < e1; ++e) {
    const T v = vals[e];
    const T* xr = X + static_cast<int64_t>(colidx[e]) * B;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = c0 + k * W;
      if (c < B) acc[k] += v * __ldg(xr + c);
    }
  }
  T* rr = R + row * B;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = c0 + k * W;
    if (c < B) rr[c] = acc[k];
  }
}

template <typename T, int W>
void launch_w(const int* rowptr, const int* colidx, const T* vals, const T* X,
              T* R, int m, int B, cudaStream_t s) {
  const int64_t threads = static_cast<int64_t>(m) * W;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((B + kSlots * W - 1) / (kSlots * W)));
  spmm_rows<T, W><<<grid, kThreads, 0, s>>>(rowptr, colidx, vals, X, R, m, B);
}

template <typename T>
int launch(int device, const int* rowptr, const int* colidx, const T* vals,
           const T* X, T* R, int m, int B, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch_w<T, 1>(rowptr, colidx, vals, X, R, m, B, s); break;
    case 2: launch_w<T, 2>(rowptr, colidx, vals, X, R, m, B, s); break;
    case 4: launch_w<T, 4>(rowptr, colidx, vals, X, R, m, B, s); break;
    case 8: launch_w<T, 8>(rowptr, colidx, vals, X, R, m, B, s); break;
    case 16: launch_w<T, 16>(rowptr, colidx, vals, X, R, m, B, s); break;
    case 32: launch_w<T, 32>(rowptr, colidx, vals, X, R, m, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). rowptr [m + 1] and colidx
// [nnz] are int32 CSR arrays, vals [nnz] the values in CSR order, X [n, B]
// and R [m, B] row-major. W is the lanes per row (1, 2, 4, 8, 16 or 32).
// Each returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int spmm_csr_f32(int device, const int* rowptr, const int* colidx,
                            const float* vals, const float* X, float* R,
                            int m, int B, int W, void* stream) {
  return launch<float>(device, rowptr, colidx, vals, X, R, m, B, W, stream);
}

extern "C" int spmm_csr_f64(int device, const int* rowptr, const int* colidx,
                            const double* vals, const double* X, double* R,
                            int m, int B, int W, void* stream) {
  return launch<double>(device, rowptr, colidx, vals, X, R, m, B, W, stream);
}
