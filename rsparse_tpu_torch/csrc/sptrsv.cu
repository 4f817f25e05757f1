// Sparse triangular solve (SpTRSV) over a batch of RHS columns, for Hopper
// (sm_90a): a dense super-level plus sparse levels, one launch per sweep.
//
// Replaces the TPU kernel rsparse_tpu/ops/sptrsv_pallas.py::_sweep_call and
// its f64 XLA twin (rsparse_tpu/solve.py::_tri_sweep_multi), which walk the
// whole level schedule of `tri_plan` (1,667 levels for each serve sweep at
// n = 16,384). This kernel runs the port's schedule (`solve.tri_plan` and
// its `dense` split), in float or double:
//
//   dense super-level: a fully dense triangle D (|D| = k, in solve order),
//       x_D[b] = (x_D[b] - sum_{a<b} M[b, a] x_D[a]) / d_b.
//     It runs before the sparse levels when D is closed under
//     predecessors, after them when D is closed under successors.
//   sparse levels (the other columns, re-levelled without D):
//     scatter form (kinds 0/1, lsolve/usolve): x[row_e] -= v_e * x[col_e]
//       for the level's entries, x[j] /= d_j for its columns;
//     gather form (kinds 2/3, ltsolve/utsolve): x[j] /= d_j, then
//       x[col_e] -= v_e * x[row_e];
//     with v_e divided by the diagonal of its column on the host side, so
//     one phase (one CTA barrier) per level: phase p applies level p's
//     entries and divides level p-1's columns (scatter), or divides level
//     p's columns and applies level p-1's entries (gather).
//   D's entries into rows outside D (only a first block in scatter form or
//     a last one in gather form has them) come as one more sparse level
//     next to the block, with no columns and undivided values: scattered
//     from the solved x_D, or gathered into x_D before the triangle.
//
// Design. RHS columns are independent: each CTA owns one of them (one
// column per CTA measured faster than two, see PERF.md) and runs the whole
// schedule; no grid-wide barrier. Instances (K factors of one pattern, the
// batched-values solvers) are independent too: blockIdx.y picks one, whose
// value streams (ev, dv, dpan, ddiag) and X sit instance-major at fixed
// strides; the index streams are shared. One launch covers all K x B
// columns.
//   - Dense super-level: x_D in shared memory, [kpad] (k padded to panels
//     of 32). M is packed by the host panel by panel, each panel
//     column-major over its rows at and below its diagonal block. Panel p
//     is applied while panel p+1 is solved: warp 0 applies panel p to panel
//     p+1's 32 rows and solves its diagonal block with warp shuffles, the
//     other warps apply panel p to the rows below (each thread one row, 32
//     coalesced loads issued 16 at a time, then their products) and stage
//     panel p+2's diagonal block in shared memory. One CTA barrier per
//     panel.
//   - Sparse levels, shared variant: when X's column fits in shared memory
//     beside x_D, the wrapper passes X^T so that the CTA loads its column
//     contiguously; it is updated with shared-memory atomics and stored
//     once at the end. Entry indices come packed in 32 bits (n <= 2^16).
//     Global variant (large n): X stays in device memory, row-major, read
//     with __ldcg and updated with atomicAdd, entry indices in two streams.
//   - Each phase's offsets, and each thread's first kBatch entries and
//     first column, are loaded while the phase before runs.
//
// What bounds it on this card. Not the bytes of the function: the serve
// pair (n = 16,384, B = 128, f32) needs ~57 MB moved once (the factor's
// values and row indices, X read and written), ~0.017 ms at 3.35 TB/s.
// Each CTA walks the whole schedule for its column: ~125 sparse phases and
// ~49 panels per sweep, each ending in a CTA barrier, and it streams the
// factor (~7 MB of sparse entries, ~5 MB of dense block, f32) from L2
// itself. The sparse entries' shared-memory atomics are, for floats,
// compare-and-swap loops (ATOMS.CAST), each thread's one after another.
// Later designs: per-target sums in place of the atomics, tensor-core
// (wgmma) panel updates across several RHS columns, thread-block clusters
// sharing the streamed factor through distributed shared memory, and fewer
// sparse phases (the fronts' own dense triangles as batched blocks).

#include <cuda_runtime.h>

#include <cstddef>

// The kernel's arguments (external linkage: the C entry points take it).
// Mirrors the ctypes structure in ops/sptrsv_cuda.py (pointers, then ints).
struct SweepArgs {
  const int* lvl;     // [nlev+1][2]: each sparse level's first column and
                      // first entry
  const int* cid;     // [ncols] columns, in level order
  const void* dv;     // [ncols] their diagonal values
  const int* esrc;    // [nents] entries, in level order: x index read
  const int* edst;    // [nents] x index updated
  const int* epk;     // [nents] the two packed, dst << 16 | src (n <= 2^16;
                      // read by the shared variant)
  const void* ev;     // [nents] value over the diagonal of its column
                      // (the block's outside entries: the value itself)
  const int* dcol;    // [k] dense block columns, in solve order
  const void* ddiag;  // [k] dense block diagonal values
  const void* dpan;   // [pan_total] packed panels of the dense block (see
                      // header)
  void* x;            // X, solved in place: row-major [n][B] in the
                      // global variant, [B][n] (X^T) in the shared one
  int nlev, ncols, nents;
  int k, kpad, dense_first;
  int n, B;
  int pan_total;  // values per instance of dpan
  int K;          // instances: ev, dv, ddiag, dpan and x are [K][...]
};

namespace {

constexpr int kThreads = 1024;  // threads per CTA
constexpr int kPanel = 32;      // dense panel width (one warp)
constexpr int kBatch = 4;       // stream loads issued together per lane

// Where the CTA's column of X lives: shared memory [n], or X itself
// (row-major [n][B], p pointing at the column's first value).
template <typename T, bool kShared>
struct XCol {
  T* p;
  int B;
  __device__ __forceinline__ T* at(int i) const {
    if constexpr (kShared) {
      return p + i;
    } else {
      return p + static_cast<size_t>(i) * B;
    }
  }
};

// X values updated by other threads' atomics are read through L2 (__ldcg)
// when X lives in device memory; shared memory is read directly.
template <bool kL2, typename T>
__device__ __forceinline__ T ldx(const T* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Solve one 32 x 32 diagonal block with warp shuffles: lane r holds row r
// of x (already updated by every earlier panel); dblk is the block,
// column-major, zero on and above the diagonal; rd is this lane's 1 / d.
// Returns the lane's solved value.
template <typename T>
__device__ __forceinline__ T diag_solve(T xb, const T* dblk, T rd, int lane) {
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (lane == j) xb *= rd;
    const T xj = __shfl_sync(0xffffffffu, xb, j);
    if (lane > j) xb -= dblk[j * kPanel + lane] * xj;
  }
  return xb;
}

// The dense super-level for the CTA's column. xd: [kpad] shared; dbuf:
// [2][32][32] shared, the diagonal blocks of the next two panels. Panel p
// is solved in the step before it: while warp 0 applies panel p to panel
// p+1's 32 rows and solves panel p+1's diagonal block (a chain of
// shuffles), the other warps apply panel p to the rows below and stage
// panel p+2's diagonal block. One CTA barrier per panel. Ends with a CTA
// barrier.
template <typename T, bool kScatter, bool kShared>
__device__ void dense_block(const SweepArgs& a, const XCol<T, kShared>& X,
                            T* xd, T* dbuf) {
  const T* dd = static_cast<const T*>(a.ddiag);
  const int k = a.k, kp = a.kpad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // diagonal block of the panel at P with R rows into dbuf[slot]
  auto stage = [&](const T* P, int R, int slot, int t0, int step) {
    for (int t = t0; t < kPanel * kPanel; t += step) {
      dbuf[slot * kPanel * kPanel + t] =
          P[static_cast<size_t>(t / kPanel) * R + t % kPanel];
    }
  };
  const T* P = static_cast<const T*>(a.dpan);
  stage(P, kp, 0, threadIdx.x, blockDim.x);
  if (kp > kPanel) stage(P + static_cast<size_t>(kPanel) * kp, kp - kPanel, 1,
                         threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    xd[i] = i < k ? ldx<!kShared>(X.at(a.dcol[i])) : T(0);
  }
  __syncthreads();
  if (warp == 0) {  // panel 0's diagonal block
    const T rd = lane < k ? T(1) / dd[lane] : T(1);
    xd[lane] = diag_solve(xd[lane], dbuf, rd, lane);
  }
  __syncthreads();
  for (int p0 = 0, pn = 0; p0 + kPanel < kp; p0 += kPanel, ++pn) {
    const int R = kp - p0;  // rows of panel pn, its diagonal block included
    const T* Pn = P + static_cast<size_t>(kPanel) * R;  // panel pn+1
    if (warp == 0) {  // look-ahead: panel pn+1
      T acc = T(0);
#pragma unroll 8
      for (int j = 0; j < kPanel; ++j) {
        acc += __ldg(P + static_cast<size_t>(j) * R + kPanel + lane) *
               xd[p0 + j];
      }
      const int i = p0 + kPanel + lane;
      const T rd = i < k ? T(1) / dd[i] : T(1);
      xd[i] = diag_solve(xd[i] - acc, dbuf + ((pn + 1) & 1) * kPanel * kPanel,
                         rd, lane);
    } else {  // the rows below panel pn+1, and panel pn+2's diagonal block
      const int t0 = threadIdx.x - 32, step = blockDim.x - 32;
      for (int r = 2 * kPanel + t0; r < R; r += step) {
        // half a panel's loads issued together, then their products
        // (measured faster than one unrolled load-multiply loop)
        constexpr int kHalf = kPanel / 2;
        T acc = T(0);
#pragma unroll
        for (int h = 0; h < kPanel; h += kHalf) {
          T m[kHalf];
#pragma unroll
          for (int j = 0; j < kHalf; ++j) {
            m[j] = __ldg(P + static_cast<size_t>(h + j) * R + r);
          }
#pragma unroll
          for (int j = 0; j < kHalf; ++j) acc += m[j] * xd[p0 + h + j];
        }
        xd[p0 + r] -= acc;
      }
      if (R > 2 * kPanel) {  // panel pn+2 exists
        stage(Pn + static_cast<size_t>(kPanel) * (R - kPanel), R - 2 * kPanel,
              pn & 1, t0, step);
      }
    }
    __syncthreads();
    P = Pn;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    *X.at(a.dcol[i]) = xd[i];
  }
  __syncthreads();
}

// One thread's share of a sparse-level phase: its first kBatch entries
// (tid + u * blockDim) and its first column (tid).
template <typename T>
struct Share {
  int s[kBatch], d[kBatch];
  T v[kBatch];
  int j;
  T dj;
};

// Entries e + u * kThreads: packed indices (shared variant) or the two
// index streams (global variant), and their values.
template <typename T, bool kPacked>
__device__ __forceinline__ void load_entries(const SweepArgs& a, int e,
                                             int (&s)[kBatch],
                                             int (&d)[kBatch],
                                             T (&v)[kBatch]) {
  const T* ev = static_cast<const T*>(a.ev);
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int eu = e + u * kThreads;
    const bool ok = eu < a.nents;
    if constexpr (kPacked) {
      const unsigned pk = ok ? static_cast<unsigned>(a.epk[eu]) : 0u;
      s[u] = static_cast<int>(pk & 0xffffu);
      d[u] = static_cast<int>(pk >> 16);
    } else {
      s[u] = ok ? a.esrc[eu] : 0;
      d[u] = ok ? a.edst[eu] : 0;
    }
    v[u] = ok ? ev[eu] : T(0);
  }
}

template <typename T, bool kShared>
__device__ __forceinline__ Share<T> load_share(const SweepArgs& a, int e0,
                                               int c0) {
  Share<T> sh{};
  load_entries<T, kShared>(a, e0 + threadIdx.x, sh.s, sh.d, sh.v);
  const int q = c0 + threadIdx.x;
  sh.j = q < a.ncols ? a.cid[q] : 0;
  sh.dj = q < a.ncols ? static_cast<const T*>(a.dv)[q] : T(1);
  return sh;
}

// The sparse levels for the CTA's column: nlev + 1 phases, one CTA barrier
// each. Entry values come divided by the diagonal of their column, so a
// level's entries and the divisions of its columns need no barrier between
// them: in the scatter form, phase p applies the entries of level p
// (x[row] -= (v / d_col) x[col], x[col] not yet divided) and divides the
// columns of level p-1; in the gather form it divides the columns of level
// p and applies the entries of level p-1 (x[col] -= (v / d_col) x[row]).
// Loaded during the phase before: each phase's offsets, and this thread's
// first kBatch entries and first column. Ends with a CTA barrier.
template <typename T, bool kScatter, bool kShared>
__device__ void sparse_levels(const SweepArgs& a, const XCol<T, kShared>& X) {
  if (a.nlev == 0) return;
  const T* dv = static_cast<const T*>(a.dv);
  const int2* lvl = reinterpret_cast<const int2*>(a.lvl);
  const int tid = threadIdx.x;
  // lvl[p - 1], lvl[p], lvl[p + 1] (clamped; lvl[0] = (0, 0))
  int2 lo = make_int2(0, 0), mid = lvl[0], hi = lvl[1];
  // phase p: entries [e0, e1), columns [c0, c1)
  auto ent_start = [&](int2 l, int2 m) { return kScatter ? m.y : l.y; };
  auto col_start = [&](int2 l, int2 m) { return kScatter ? l.x : m.x; };
  Share<T> cur =
      load_share<T, kShared>(a, ent_start(lo, mid), col_start(lo, mid));
  for (int p = 0; p <= a.nlev; ++p) {
    const int2 next_hi = p + 2 <= a.nlev ? lvl[p + 2] : hi;
    Share<T> nxt{};
    if (p < a.nlev) {
      nxt = load_share<T, kShared>(a, ent_start(mid, hi), col_start(mid, hi));
    }
    const int e0 = ent_start(lo, mid);
    const int e1 = kScatter ? hi.y : mid.y;
    const int c0 = col_start(lo, mid);
    const int c1 = kScatter ? mid.x : hi.x;
    for (int base = 0; base < e1 - e0; base += kBatch * kThreads) {
      int s[kBatch], d[kBatch];
      T v[kBatch];
      if (base == 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          s[u] = cur.s[u];
          d[u] = cur.d[u];
          v[u] = cur.v[u];
        }
      } else {
        load_entries<T, kShared>(a, e0 + base + tid, s, d, v);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + tid + u * kThreads < e1 - e0) {
          atomicAdd(X.at(d[u]), -v[u] * ldx<!kShared>(X.at(s[u])));
        }
      }
    }
    for (int q = tid; q < c1 - c0; q += kThreads) {
      const int j = q == tid ? cur.j : a.cid[c0 + q];
      const T dj = q == tid ? cur.dj : dv[c0 + q];
      T* px = X.at(j);
      *px = ldx<!kShared>(px) / dj;
    }
    __syncthreads();
    lo = mid;
    mid = hi;
    hi = next_hi;
    cur = nxt;
  }
}

template <typename T, bool kScatter, bool kShared>
__global__ void __launch_bounds__(kThreads) sweep_kernel(SweepArgs in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;  // the CTA's RHS column
  // the CTA's instance: its value streams and its X (64-bit offsets)
  const size_t inst = blockIdx.y;
  SweepArgs a = in;
  a.ev = static_cast<const T*>(in.ev) + inst * in.nents;
  a.dv = static_cast<const T*>(in.dv) + inst * in.ncols;
  a.ddiag = static_cast<const T*>(in.ddiag) + inst * in.k;
  a.dpan = static_cast<const T*>(in.dpan) + inst * in.pan_total;
  T* xg = static_cast<T*>(in.x) + inst * in.n * in.B;
  T* dbuf = reinterpret_cast<T*>(smem);                // [2][32][32] if k
  T* xd = dbuf + (a.k > 0 ? 2 * kPanel * kPanel : 0);  // [kpad]
  T* xs = xd + a.kpad;                                 // [n] if kShared
  const XCol<T, kShared> X{kShared ? xs : xg + c, a.B};
  T* xc = xg + static_cast<size_t>(c) * a.n;  // the column in X^T
  if constexpr (kShared) {
#pragma unroll 4
    for (int t = threadIdx.x; t < a.n; t += blockDim.x) xs[t] = xc[t];
    __syncthreads();
  }
  if (a.k > 0 && a.dense_first) {
    dense_block<T, kScatter, kShared>(a, X, xd, dbuf);
  }
  sparse_levels<T, kScatter, kShared>(a, X);
  if (a.k > 0 && !a.dense_first) {
    dense_block<T, kScatter, kShared>(a, X, xd, dbuf);
  }
  if constexpr (kShared) {
    __syncthreads();
#pragma unroll 4
    for (int t = threadIdx.x; t < a.n; t += blockDim.x) xc[t] = xs[t];
  }
}

// Dynamic shared memory of one CTA: the two diagonal-block buffers (when
// there is a dense block), x_D [kpad], and in the shared variant X's
// column [n] (the wrapper computes the same size).
size_t smem_bytes(const SweepArgs& a, int shared, size_t item) {
  return (static_cast<size_t>(a.k > 0 ? 2 * kPanel * kPanel : 0) +
          static_cast<size_t>(a.kpad) + (shared ? a.n : 0)) *
         item;
}

template <typename T, bool kScatter, bool kShared>
cudaError_t launch_one(const SweepArgs& a, size_t smem, cudaStream_t s) {
  auto fn = sweep_kernel<T, kScatter, kShared>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<dim3(a.B, a.K), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(int device, int scatter, int shared, const SweepArgs* a,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(*a, shared, sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scatter) {
    err = shared ? launch_one<T, true, true>(*a, smem, s)
                 : launch_one<T, true, false>(*a, smem, s);
  } else {
    err = shared ? launch_one<T, false, true>(*a, smem, s)
                 : launch_one<T, false, false>(*a, smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (bound with ctypes). `scatter`: kinds 0/1;
// `shared`: X's column in shared memory. One CTA per RHS column and
// instance. Each
// returns cudaGetLastError() after the launch: 0 when the kernel was
// accepted.
extern "C" int sptrsv_sweep_f32(int device, int scatter, int shared,
                                const SweepArgs* a, void* stream) {
  return launch<float>(device, scatter, shared, a, stream);
}

extern "C" int sptrsv_sweep_f64(int device, int scatter, int shared,
                                const SweepArgs* a, void* stream) {
  return launch<double>(device, scatter, shared, a, stream);
}

// The most dynamic shared memory one CTA may opt in to, in bytes (or -1).
extern "C" int sptrsv_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}
