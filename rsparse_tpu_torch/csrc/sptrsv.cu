// Level-scheduled sparse triangular solve (SpTRSV) over a batch of RHS
// columns, X[n, B] row-major, for Hopper (sm_90a).
//
// Replaces the TPU kernel rsparse_tpu/ops/sptrsv_pallas.py::_sweep_call and
// its f64 XLA twin (rsparse_tpu/solve.py::_tri_sweep_multi): one launch runs
// the whole level schedule of `solve.tri_plan`, in float or double.
//
//   scatter form (kinds 0/1, lsolve/usolve), per level:
//       x[j] /= d_j                       for the level's columns j
//       x[row_e] -= v_e * x[col_e]        for the level's entries e
//   gather form (kinds 2/3, ltsolve/utsolve), per level:
//       c[slot_e] += v_e * x[row_e]       for the level's entries e
//       x[j] = (x[j] - c[slot_j]) / d_j;  c[slot_j] = 0
//
// The `contrib` scratch c[wmax, B] is all-zero at every level's entry: the
// column phase re-zeroes each slot it consumes (the invariant of the TPU
// kernel), so the wrapper clears it once per launch.
//
// Design. RHS columns are independent, so each CTA owns a tile of `tile`
// columns (1..32, chosen by the wrapper) and walks every level itself;
// levels are separated by __syncthreads() and no grid-wide barrier is
// needed. Within a phase the CTA's threads stride over (item, column) pairs
// with the column fastest, so for wide tiles a warp touches one contiguous
// row segment of X. Several entries of one level can hit the same row, so
// the updates are atomicAdd. X is read with __ldcg (L2, bypassing L1)
// because other threads of the CTA update it through atomics, which
// complete in L2.
//
// What bounds it on this card: the serial level count (two CTA barriers and
// a chain of dependent L2 round trips per level) and the atomic traffic, one
// atomicAdd per entry and RHS column. A wide tile coalesces that traffic
// but leaves most SMs idle (B = 128 with 32-column tiles is 4 CTAs of the
// H100's 132 SMs, and each CTA then pays for 32 columns per level); one
// column per CTA spreads a batch over B SMs, each latency-bound on the
// level chain, which measured ~9x faster for the scatter form at B = 128.
// The gather form keeps 8 columns per CTA: with fewer, the lanes of a warp
// serialize on one contrib slot. Fewer levels (dense blocks solved as
// dense triangles) or a sync-free scheme are later changes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // threads per CTA

template <typename T, bool kScatter>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ eoff, const int* __restrict__ coff,
             const T* __restrict__ ev, const int* __restrict__ erow,
             const int* __restrict__ eb, const T* __restrict__ dv,
             const int* __restrict__ cid, T* x, T* contrib, int nlev, int B,
             int tile) {
  const int c0 = blockIdx.x * tile;
  const int tw = min(tile, B - c0);
  for (int lev = 0; lev < nlev; ++lev) {
    const int co = coff[lev];
    const int cc = coff[lev + 1] - co;
    const int eo = eoff[lev];
    const int ec = eoff[lev + 1] - eo;
    if constexpr (kScatter) {
      for (int k = threadIdx.x; k < cc * tw; k += blockDim.x) {
        const int q = co + k / tw;
        T* p = x + static_cast<size_t>(cid[q]) * B + c0 + k % tw;
        *p = __ldcg(p) / dv[q];
      }
      __syncthreads();
      for (int k = threadIdx.x; k < ec * tw; k += blockDim.x) {
        const int e = eo + k / tw;
        const int c = c0 + k % tw;
        const T v = ev[e] * __ldcg(x + static_cast<size_t>(eb[e]) * B + c);
        atomicAdd(x + static_cast<size_t>(erow[e]) * B + c, -v);
      }
    } else {
      for (int k = threadIdx.x; k < ec * tw; k += blockDim.x) {
        const int e = eo + k / tw;
        const int c = c0 + k % tw;
        const T v = ev[e] * __ldcg(x + static_cast<size_t>(erow[e]) * B + c);
        atomicAdd(contrib + static_cast<size_t>(eb[e]) * B + c, v);
      }
      __syncthreads();
      for (int k = threadIdx.x; k < cc * tw; k += blockDim.x) {
        const int slot = k / tw;
        const int c = c0 + k % tw;
        T* p = x + static_cast<size_t>(cid[co + slot]) * B + c;
        T* r = contrib + static_cast<size_t>(slot) * B + c;
        *p = (__ldcg(p) - __ldcg(r)) / dv[co + slot];
        *r = T(0);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int device, const int* eoff, const int* coff, const T* ev,
           const int* erow, const int* eb, const T* dv, const int* cid, T* x,
           T* contrib, int nlev, int B, int tile, int scatter, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scatter) {
    sweep_kernel<T, true><<<grid, kThreads, 0, s>>>(
        eoff, coff, ev, erow, eb, dv, cid, x, contrib, nlev, B, tile);
  } else {
    sweep_kernel<T, false><<<grid, kThreads, 0, s>>>(
        eoff, coff, ev, erow, eb, dv, cid, x, contrib, nlev, B, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). `tile` is the number of RHS
// columns per CTA (1..32). Each returns cudaGetLastError() after the
// launch: 0 when the kernel was accepted.
extern "C" int sptrsv_sweep_f32(int device, const int* eoff, const int* coff,
                                const float* ev, const int* erow,
                                const int* eb, const float* dv,
                                const int* cid, float* x, float* contrib,
                                int nlev, int B, int tile, int scatter,
                                void* stream) {
  return launch<float>(device, eoff, coff, ev, erow, eb, dv, cid, x, contrib,
                       nlev, B, tile, scatter, stream);
}

extern "C" int sptrsv_sweep_f64(int device, const int* eoff, const int* coff,
                                const double* ev, const int* erow,
                                const int* eb, const double* dv,
                                const int* cid, double* x, double* contrib,
                                int nlev, int B, int tile, int scatter,
                                void* stream) {
  return launch<double>(device, eoff, coff, ev, erow, eb, dv, cid, x, contrib,
                        nlev, B, tile, scatter, stream);
}
