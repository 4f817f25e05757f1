// Sparse triangular solve (SpTRSV) over a batch of RHS columns, for Hopper
// (sm_90a): a dense super-level plus sparse levels, one launch per sweep;
// or, for an L sweep of one instance over 32 or more RHS columns whose
// factor has a supernodal schedule several times shorter than its level
// schedule, that schedule run as one persistent launch (below).
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
// Supernodal variant (`snode_sweep_kernel`; kinds 0 and 2 of one instance,
// B >= 32, on a factor whose pattern `ops.snode` takes and whose panel
// tree is several times shorter than its level schedule, whether or not
// X's column fits in a CTA's shared memory: `launch_config` and
// SNODE_LEVELS in ops/sptrsv_cuda.py). The level schedule above gives each CTA one RHS
// column and some 2,600 barriers a sweep at n = 65,536 (2,108 sparse levels
// and a dense block of 1,961 columns for a 24^3 27-point factor, whose
// separators make the gather form's shared-memory atomics meet on one
// address), with X in device memory or shared memory and one 4-byte atomic
// per entry and column. Here the schedule is the factor's supernodes
// (`ops.snode`):
// panels of at most 32 consecutive columns with nested patterns, each a
// dense block (its triangle, then its rows below, row-major, packed by the
// value prepass with 1 / L[j, j] on the diagonal), and tasks: each bottom
// subtree of at most TASK_ENTRIES entries, walked level by level with a
// CTA barrier between levels, and each panel above them, its rows below
// shared among parts of at most PART_ROWS rows, one task each (kind 0: each
// part solves the triangle, the last to arrive on the group's arrival
// counter stores it; kind 2: each part adds its partial sums to the
// group's accumulator with `red.add`, the last solves and signals). A task
// works on a tile of 32 RHS columns of X (all 128 in one task measured
// 2.5-4.5x slower), row-major [n][B] in device
// memory, so that a warp's 32 lanes read or update 32 consecutive values
// of a row. The grid is as many CTAs as fit on the card at once; each takes
// (task, tile) tickets in topological order from an atomic counter, so a
// task only waits on tasks handed out earlier, to CTAs already running:
// no deadlock (a part never waits on another part). A task waits with
// acquire loads on its group's counter (kind 0: until each task of each
// child group has added one; kind 2: until its parent group has) and
// signals with a release; the counters are never reset, each launch's epoch
// says how far they have risen (the wrapper runs the launches on one plan's
// counters one after another, across streams too). Per panel and tile: kind 0
// solves the triangle (one warp, column by column, the RHS column in
// registers), stores the panel's rows, then applies the block below to the rows
// below with `red.add` reductions; kind 2 gathers the rows below through the
// transposed block, then solves the transposed triangle. A panel alone in its
// level shares its rows below among all 8 warps (kind 2's partial sums meet in
// shared memory). Rows below come in batches whose block rows and X values are
// loaded together and staged in shared memory; the reads that do not depend on
// X (the triangle and the first batch) are issued before the task's wait. FP32
// (or FP64) fused multiply-adds on the CUDA cores only.
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
//
// What bounds the supernodal variant (lap2d-256's L, n = 65,536, B = 128,
// f32, measured with a per-ticket timeline on the global timer): ~1.15 ms
// a kind 0 sweep and ~1.7 ms a kind 2 one, against 6.4 and 10.2 for the
// global variant, and a least time of 0.027 ms. Neither bytes nor the
// reductions: the critical path of dependent tasks. Kind 0 runs the 205
// bottom-subtree tasks (4 tiles each; ~130 us each, 16 levels of ~7 us:
// a few dependent round trips to L2 a level) in about three waves over
// the 264 resident CTAs, then the chain of ~124 panels up to the root,
// each ~5.5 us a part (the X load, the triangle on one warp, at most 64
// rows below, two barriers, the arrival and the release) plus ~1 us of
// hand-off; kind 2 the chain first (~7.5 us a part: the partial sums meet
// in L2), then the subtrees, ~200 us each. Fewer round trips a subtree
// level and a shorter triangle are the next steps. A 24^3 27-point factor
// (n = 13,824: a chain of 175 panels above the bottom subtrees, up to 31
// parts each) takes 1.39 ms a kind 0 sweep and 2.01 ms a kind 2 one,
// against 3.64 and 45.6 on the shared variant.

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

// The supernodal variant's arguments. Mirrors the ctypes structure
// `_SnArgs` in ops/sptrsv_cuda.py (pointers, then ints).
struct SnodeArgs {
  const int* task_lvl;  // [ngroup+1] each group's first level
  const int* lvl_pan;   // [nlevel+1] each level's first entry of pan
  const int* pan;       // [npanel] panels in group and level order
  const int* grp;       // [ntask] the task's group
  const int2* part;     // [ntask] its part and the group's parts
  const int4* pinfo;    // [npanel] first column, width, rows below, and
                        // the first of them in prow
  const int* pval;      // [npanel] the panel's block in val
  const int* prow;      // the rows below each panel, ascending
  const int* wait;      // [ntask] the group counter a task waits on (-1)
  const int* need;      // [ntask] how far it must rise in a launch
  const int* signal;    // [ntask] the group counter it adds one to (-1)
  const void* val;      // the packed blocks (ops/snode.py Panels)
  void* x;              // X, row-major [n][B], solved in place
  unsigned* ctr;        // [ngroup][ntile] dependency counters, the ticket,
                        // then [ngroup][ntile] arrivals of a group's parts
  void* acc;            // kind 2: [ngroup][ntile][32][32] the partial sums
                        // of a group's parts (zero between launches)
  int ntask, ngroup, n, B;
  int ntile;  // tiles of 32 RHS columns: ceil(B / 32)
  unsigned epoch;  // launches made before on these counters
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

// ---------------------------------------------------------------------------
// The supernodal variant (see the header): a persistent grid over the tasks
// of `ops.snode`, in tiles of 32 right-hand sides.
// ---------------------------------------------------------------------------

constexpr int kSnWarps = 8;  // warps per CTA (16 measured no faster)
constexpr int kSnThreads = kSnWarps * 32;
constexpr int kSnWidth = 32;  // most columns in a panel (ops/snode.py PANEL)
constexpr unsigned kFull = 0xffffffffu;

// Rows below a panel are taken in batches of kRows: their indices (one per
// lane), their block rows (lane j loads column j) and, in the gather form,
// their values of X are loaded together into registers and then staged in
// the warp's shared memory, so that a batch waits on memory once; each row
// is then applied from broadcast shared-memory reads.
template <typename T>
struct Sn {
  static constexpr int kRows = sizeof(T) == 4 ? 16 : 8;
  static constexpr int kTri = 32 * 36;  // a staged triangle, padded rows
  // shared memory: the partial sums [kSnWarps][kSnWidth][32], then each
  // warp's staging area: a triangle, a batch's block rows [kRows][32] and
  // its rows of X [kRows][32]
  static constexpr int kStage = kTri + 2 * kRows * 32;
  static constexpr size_t kSmem =
      (kSnWarps * kSnWidth * 32 + kSnWarps * kStage) * sizeof(T);
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Adds one to a counter with release semantics at the scope of the card:
// the writes that happen before it (the CTA's, through its barrier) are
// seen by whoever acquires the new value.
__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

// Four consecutive values from shared memory (16-byte aligned).
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void lds4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// One panel as a lane sees it: its RHS column `col` of X (row-major
// [n][B]; `on`: col < B), the panel's columns, rows below and block (whose
// diagonal slots hold 1 / L[j, j]).
template <typename T>
struct Panel {
  int f, w, m, wq;
  const int* rows;  // [m] rows below, ascending
  const T* blk;     // [w + m][wq] row-major: triangle, then the rows below
  T* x;             // X + col
  int B;
  bool on;

  __device__ __forceinline__ Panel(const SnodeArgs& a, int s, int col) {
    const int4 pi = a.pinfo[s];
    f = pi.x;
    w = pi.y;
    m = pi.z;
    wq = (w + 3) & ~3;
    rows = a.prow + pi.w;
    blk = static_cast<const T*>(a.val) + a.pval[s];
    B = a.B;
    on = col < a.B;
    x = static_cast<T*>(a.x) + (on ? col : 0);
  }
  __device__ __forceinline__ T* at(int r) const {
    return x + static_cast<size_t>(r) * B;
  }
  // the panel's rows of X (zero past w)
  __device__ __forceinline__ void load(T (&v)[kSnWidth]) const {
#pragma unroll
    for (int j = 0; j < kSnWidth; ++j) {
      v[j] = (j < w && on) ? __ldcg(at(f + j)) : T(0);
    }
  }
  __device__ __forceinline__ void store(const T (&v)[kSnWidth]) const {
    if (!on) return;
#pragma unroll
    for (int j = 0; j < kSnWidth; ++j) {
      if (j >= w) break;
      *at(f + j) = v[j];
    }
  }
  // the rows below that share `i` of `k` takes: [b0, b1)
  __device__ __forceinline__ int2 share(int i, int k) const {
    return make_int2(static_cast<int>(static_cast<long long>(m) * i / k),
                     static_cast<int>(static_cast<long long>(m) * (i + 1) / k));
  }
  // Loads into shared memory, every load issued before any store: with
  // `tri`, the triangle's first kRT rows (lane j loads column j of each
  // row) into tri [32][36], tri[i][j] = L[f+i, f+j] for j <= i < w, or
  // transposed, tri[j][i]; with kL, block rows [b0, b0 + nb) below (nb <=
  // kRows) into lb [kRows][32]; with kX, those rows of X into xb [kRows][32].
  // Zero past w and past nb. Returns the lane's row index (lane < nb).
  template <bool kTransposed, int kRT, bool kL, bool kX>
  __device__ __forceinline__ int stage(T* tri, T* lb, T* xb, int b0, int nb,
                                       int lane) const {
    constexpr int R = Sn<T>::kRows;
    const int rl = (kL || kX) && lane < nb ? __ldg(rows + b0 + lane) : 0;
    const T* src = blk + static_cast<size_t>(w + b0) * wq + lane;
    T t[kRT], l[R], xv[R];
    if (tri) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        t[i] = (i < w && lane <= i) ? __ldg(blk + i * wq + lane) : T(0);
      }
      if (kRT > 8) {  // a wide triangle first: fewer values live at once
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          tri[kTransposed ? lane * 36 + i : i * 36 + lane] = t[i];
        }
      }
    }
    if constexpr (kL) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        l[i] = (i < nb && lane < w) ? __ldg(src + i * wq) : T(0);
      }
    }
    if constexpr (kX) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = __shfl_sync(kFull, rl, i);
        xv[i] = (i < nb && on) ? __ldcg(at(row)) : T(0);
      }
    }
    if (tri && kRT <= 8) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        tri[kTransposed ? lane * 36 + i : i * 36 + lane] = t[i];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if constexpr (kL) lb[i * 32 + lane] = l[i];
      if constexpr (kX) xb[i * 32 + lane] = xv[i];
    }
    return rl;
  }
  // stage() with the triangle's rows sized to the panel: 8 when w <= 8
  template <bool kTransposed, bool kL, bool kX>
  __device__ __forceinline__ int stage_w(T* tri, T* lb, T* xb, int b0,
                                         int nb, int lane) const {
    return w <= 8 ? stage<kTransposed, 8, kL, kX>(tri, lb, xb, b0, nb, lane)
                  : stage<kTransposed, 32, kL, kX>(tri, lb, xb, b0, nb, lane);
  }
};

// Forward substitution, column by column, over the transposed staged
// triangle: v <- T^-1 v (the updates of one column are independent, their
// values read four at a time).
template <int kRT, typename T>
__device__ __forceinline__ void tri_lower(int w, const T* tri,
                                          T (&v)[kSnWidth]) {
#pragma unroll
  for (int j = 0; j < kRT; ++j) {
    if (j >= w) break;
    const T* col = tri + j * 36;
    const T vj = v[j] * col[j];
    v[j] = vj;
#pragma unroll
    for (int i4 = (j + 1) & ~3; i4 < kRT; i4 += 4) {
      T l[4];
      lds4(col + i4, l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i4 + k > j) v[i4 + k] -= l[k] * vj;
      }
    }
  }
}

// Backward substitution, row by row of the staged triangle, transposed:
// v <- T'^-1 v.
template <int kRT, typename T>
__device__ __forceinline__ void tri_upper(int w, const T* tri,
                                          T (&v)[kSnWidth]) {
#pragma unroll
  for (int i = kRT - 1; i >= 0; --i) {
    if (i >= w) continue;
    const T* row = tri + i * 36;
    const T vi = v[i] * row[i];
    v[i] = vi;
#pragma unroll
    for (int j4 = 0; j4 < i; j4 += 4) {
      T l[4];
      lds4(row + j4, l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j4 + k < i) v[j4 + k] -= l[k] * vi;
      }
    }
  }
}

// x[addr] += d, with no answer back (a reduction in L2).
__device__ __forceinline__ void red_add(float* p, float d) {
  asm volatile("red.relaxed.gpu.global.add.f32 [%0], %1;" ::"l"(p), "f"(d)
               : "memory");
}

__device__ __forceinline__ void red_add(double* p, double d) {
  asm volatile("red.relaxed.gpu.global.add.f64 [%0], %1;" ::"l"(p), "d"(d)
               : "memory");
}

// One staged block row against v, over the first kC chunks of 4 columns
// (the staged values past w are zero): all its shared-memory reads are
// issued before the products.
template <int kC, typename T>
__device__ __forceinline__ T row_dot(const T* lrow, const T (&v)[kSnWidth]) {
  T l[4 * kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    lds4(lrow + 4 * c, *reinterpret_cast<T(*)[4]>(l + 4 * c));
  }
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < 4 * kC; ++j) acc[j & 3] += l[j] * v[j];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// acc += one staged block row times xv, as row_dot's reads.
template <int kC, typename T>
__device__ __forceinline__ void row_axpy(const T* lrow, T xv,
                                         T (&acc)[kSnWidth]) {
  T l[4 * kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    lds4(lrow + 4 * c, *reinterpret_cast<T(*)[4]>(l + 4 * c));
  }
#pragma unroll
  for (int j = 0; j < 4 * kC; ++j) acc[j] += l[j] * xv;
}

// Kind 0, rows [r.x, r.y) below the panel: X[row] -= L[row, panel] v, the
// first batch already staged in lb (its row indices in rl). A warp's 32
// lanes update 32 consecutive values of a row of X; a narrow panel's
// rows two at a time.
template <int kC, typename T>
__device__ __forceinline__ void scatter_rows(const Panel<T>& P, int2 r,
                                             const T (&v)[kSnWidth], T* lb,
                                             int rl) {
  constexpr int R = Sn<T>::kRows;
  for (int b0 = r.x; b0 < r.y; b0 += R) {
    const int nb = min(R, r.y - b0);
    if (b0 != r.x) {
      __syncwarp();
      rl = P.template stage<true, 8, true, false>(nullptr, lb, nullptr, b0, nb,
                                                  threadIdx.x & 31);
      __syncwarp();
    }
    constexpr int kPair = kC <= 2 ? 2 : 1;  // rows a step (narrow: two)
    for (int t = 0; t < nb; t += kPair) {  // R is even: row t + 1 is staged
      T d[kPair];
      int rr[kPair];
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        d[q] = row_dot<kC>(lb + (t + q) * 32, v);
        rr[q] = __shfl_sync(kFull, rl, t + q);
      }
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        if (P.on && t + q < nb) red_add(P.at(rr[q]), -d[q]);
      }
    }
  }
}

// Kind 2, rows [r.x, r.y) below the panel: acc += L[row, panel]' X[row],
// the first batch already staged (block rows in lb, X in xb; rows past nb
// staged as zero); a narrow panel's rows two at a time.
template <int kC, typename T>
__device__ __forceinline__ void gather_rows(const Panel<T>& P, int2 r,
                                            T (&acc)[kSnWidth], T* lb, T* xb) {
  constexpr int R = Sn<T>::kRows;
  const int lane = threadIdx.x & 31;
  for (int b0 = r.x; b0 < r.y; b0 += R) {
    const int nb = min(R, r.y - b0);
    if (b0 != r.x) {
      __syncwarp();
      P.template stage<false, 8, true, true>(nullptr, lb, xb, b0, nb, lane);
      __syncwarp();
    }
    constexpr int kPair = kC <= 2 ? 2 : 1;  // rows past nb are zero
    for (int t = 0; t < nb; t += kPair) {
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        row_axpy<kC>(lb + (t + q) * 32, xb[(t + q) * 32 + lane], acc);
      }
    }
  }
}

// One level of a task: its panels (items). With few items, each is split
// over nsub warps (one item per warp group, `split`) that share the rows
// below it. Kind 0: the group's
// first warp solves the triangle and stores the panel's rows of X, and,
// when split, passes them to the others through `part`; then each applies
// them to its share of the rows below. Kind 2: each warp gathers its share
// of the rows below; when split, the partial sums meet in `part`; the
// first warp subtracts them from the panel's rows of X (kept in its own
// `part`), solves the transposed triangle and stores. Panels of at most 8
// columns take the narrow forms (kC = 2 chunks of 4 columns).
//
// Round 0's reads that do not depend on X (the triangle and the first
// batch of block rows) are its prologue, which the kernel issues before
// the task's wait; `staged` tells the run that they are done. The run ends
// with a CTA barrier.
template <typename T, bool kScatter>
struct Level {
  const SnodeArgs& a;
  int q0, items, nsub, rounds, tile, lane, warp, g;
  int2 pk;  // the task's part of its group's parts
  bool split;
  T *part, *tri, *lb, *xb, *mine;

  __device__ __forceinline__ Level(const SnodeArgs& a_, int l, int tile_,
                                   int g_, int2 pk_, T* part_, T* ws)
      : a(a_), tile(tile_), g(g_), pk(pk_), part(part_) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    q0 = a.lvl_pan[l];
    items = a.lvl_pan[l + 1] - q0;
    nsub = 1;
    while (nsub * 2 * items <= kSnWarps) nsub *= 2;
    split = nsub > 1;
    rounds = split ? 1 : (items + kSnWarps - 1) / kSnWarps;
    tri = ws;
    lb = ws + Sn<T>::kTri;
    xb = lb + Sn<T>::kRows * 32;
    mine = part + warp * kSnWidth * 32 + lane;
  }

  struct Unit {
    Panel<T> P;
    int2 r;
    int sub, nb;  // nb: rows in the first batch
    bool has, lead, rows;
  };

  __device__ __forceinline__ Unit unit(int k) const {
    const int u = warp + k * kSnWarps;
    const bool has = u < items * nsub;
    const int item = has ? u / nsub : 0, sub = u % nsub;
    const Panel<T> P(a, a.pan[q0 + item], tile * 32 + lane);
    const int2 t = P.share(pk.x, pk.y);  // the task's part, then the warp's
    const int2 r = make_int2(t.x + (t.y - t.x) * sub / nsub,
                             t.x + (t.y - t.x) * (sub + 1) / nsub);
    const bool rows = has && r.x < r.y;
    return Unit{P,   r, sub, rows ? min(Sn<T>::kRows, r.y - r.x) : 0,
                has, has && sub == 0, rows};
  }

  // the reads of a unit that do not depend on X (and, with kX, its first
  // batch of X); returns the row indices
  template <bool kX>
  __device__ __forceinline__ int stage(const Unit& U) const {
    return U.P.template stage_w<kScatter, true, kX>(U.lead ? tri : nullptr,
                                                    lb, xb, U.r.x, U.nb, lane);
  }
  __device__ __forceinline__ void prologue() const { stage<false>(unit(0)); }

  // Whether this task is the last of its group's parts to arrive: kind 0
  // arrives once it has read the panel's rows of X (each part solves the
  // triangle; the last stores it, so that no part reads a solved row),
  // kind 2 once it has added its partial sums (the last solves). The
  // arrival counter wraps to 0 at the group's last part, ready for the
  // next launch. Called by the lead warp.
  __device__ __forceinline__ bool last_part() const {
    __threadfence();  // each lane's reads or sums before the arrival
    __syncwarp();
    unsigned old = 0;
    if (lane == 0) {
      old = atomicInc(a.ctr + (a.ngroup + static_cast<size_t>(g)) * a.ntile +
                          1 + tile,
                      pk.y - 1);
    }
    const bool last = __shfl_sync(kFull, old, 0) ==
                      static_cast<unsigned>(pk.y - 1);
    __threadfence();  // the other parts' writes before what follows
    return last;
  }

  // Runs the level; returns, for the lead warp, whether the task signals
  // (in kind 2 only the last of a group's parts does).
  __device__ bool run(bool staged) const {
    bool ends = true;
    for (int k = 0; k < rounds; ++k) {
      const Unit U = unit(k);
      if (U.P.w <= 8) {
        ends = round<2>(U, staged && k == 0);
      } else {
        ends = round<8>(U, staged && k == 0);
      }
    }
    __syncthreads();
    return ends;
  }

  template <int kC>
  __device__ __forceinline__ bool round(const Unit& U, bool staged) const {
    constexpr int kRT = 4 * kC;  // the triangle's rows that can be nonzero
    T v[kSnWidth];
    if (U.lead) U.P.load(v);  // issued before the stage's stores
    if constexpr (kScatter) {
      const int rl =
          staged ? (lane < U.nb ? __ldg(U.P.rows + U.r.x + lane) : 0)
                 : stage<false>(U);
      __syncwarp();
      if (U.lead) {
        tri_lower<kRT>(U.P.w, tri, v);
        if (pk.y == 1 || last_part()) U.P.store(v);
        if (split) {
#pragma unroll
          for (int j = 0; j < kSnWidth; ++j) mine[j * 32] = v[j];
        }
      }
      if (split) {
        __syncthreads();
        if (U.has && U.sub > 0) {
          const T* from = mine - U.sub * kSnWidth * 32;
#pragma unroll
          for (int j = 0; j < kSnWidth; ++j) v[j] = from[j * 32];
        }
      }
      if (U.rows) scatter_rows<kC>(U.P, U.r, v, lb, rl);
      return true;
    } else {
      if (staged) {
        U.P.template stage<false, 8, false, true>(
            nullptr, nullptr, xb, U.r.x, U.nb, lane);
      } else {
        stage<true>(U);
      }
      if (U.lead) {
#pragma unroll
        for (int j = 0; j < kSnWidth; ++j) mine[j * 32] = v[j];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSnWidth; ++j) v[j] = T(0);
      if (U.rows) gather_rows<kC>(U.P, U.r, v, lb, xb);
      if (split) {
        if (U.has && U.sub > 0) {
#pragma unroll
          for (int j = 0; j < kSnWidth; ++j) mine[j * 32] = v[j];
        }
        __syncthreads();
        if (U.lead) {
          for (int q = 1; q < nsub; ++q) {
#pragma unroll
            for (int j = 0; j < kSnWidth; ++j) {
              v[j] += mine[(q * kSnWidth + j) * 32];
            }
          }
        }
      }
      bool solve = true;
      if (U.lead && pk.y > 1) {  // this part's sums into the group's
        T* sum = static_cast<T*>(a.acc) +
                 (static_cast<size_t>(g) * a.ntile + tile) * kSnWidth * 32 +
                 lane;
#pragma unroll
        for (int j = 0; j < kSnWidth; ++j) {
          if (j < U.P.w) red_add(sum + j * 32, v[j]);
        }
        solve = last_part();
        if (solve) {  // every part's sums, and zeros for the next launch
#pragma unroll
          for (int j = 0; j < kSnWidth; ++j) {
            v[j] = j < U.P.w ? __ldcg(sum + j * 32) : T(0);
          }
#pragma unroll
          for (int j = 0; j < kSnWidth; ++j) {
            if (j < U.P.w) sum[j * 32] = T(0);
          }
        }
      }
      if (U.lead && solve) {
#pragma unroll
        for (int j = 0; j < kSnWidth; ++j) v[j] = mine[j * 32] - v[j];
        tri_upper<kRT>(U.P.w, tri, v);
        U.P.store(v);
      }
      return solve;
    }
  }
};

// The persistent kernel: each CTA takes tickets t (task t / ntile, tile
// t % ntile) in order until they run out. It issues the prologue of the
// task's first level, then thread 0 waits for the task's counter
// (acquire), the CTA runs its levels, and thread 0 adds one to the counter
// it signals (after a fence). The ticket is taken with atomicInc, which
// wraps it back to 0 when the launch's last CTA has drawn its closing
// ticket; the counters are never reset: the launch's `epoch` (the
// launches made before on them) says how far each has risen already.
template <typename T, bool kScatter>
__global__ void __launch_bounds__(kSnThreads, sizeof(T) == 4 ? 2 : 1)
    snode_sweep_kernel(SnodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* part = reinterpret_cast<T*>(smem);
  T* ws = part + kSnWarps * kSnWidth * 32 + (threadIdx.x >> 5) * Sn<T>::kStage;
  __shared__ unsigned s_ticket;
  const unsigned total = static_cast<unsigned>(a.ntask) * a.ntile;
  unsigned* ticket = a.ctr + static_cast<size_t>(a.ngroup) * a.ntile;
  for (;;) {
    if (threadIdx.x == 0) {
      s_ticket = atomicInc(ticket, total + gridDim.x - 1);
    }
    __syncthreads();
    const unsigned t = s_ticket;
    if (t >= total) return;
    const int task = t / a.ntile, tile = t % a.ntile;
    const int g = a.grp[task];
    const int2 pk = a.part[task];
    const int l0 = a.task_lvl[g], l1 = a.task_lvl[g + 1];
    Level<T, kScatter>(a, l0, tile, g, pk, part, ws).prologue();
    if (threadIdx.x == 0) {
      const int w = a.wait[task];
      if (w >= 0) {
        const unsigned* c = a.ctr + static_cast<size_t>(w) * a.ntile + tile;
        const unsigned target = (a.epoch + 1u) * a.need[task];
        while (static_cast<int>(ld_acquire(c) - target) < 0) {
          __nanosleep(32);
        }
      }
    }
    __syncthreads();
    bool ends = true;
    for (int l = l0; l < l1; ++l) {
      ends = Level<T, kScatter>(a, l, tile, g, pk, part, ws).run(l == l0);
    }
    if (threadIdx.x == 0) {
      const int sig = a.signal[task];
      if (sig >= 0 && ends) {  // a release: the CTA's writes (its barrier)
        red_release(a.ctr + static_cast<size_t>(sig) * a.ntile + tile);
      }
    }
  }
}

template <typename T, bool kScatter>
cudaError_t snode_launch_one(int device, const SnodeArgs& a, cudaStream_t s) {
  auto fn = snode_sweep_kernel<T, kScatter>;
  const int smem = static_cast<int>(Sn<T>::kSmem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kSnThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(a.ntask) * a.ntile;
  const int grid = static_cast<int>(
      total < static_cast<long long>(per_sm) * sms ? total : per_sm * sms);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  fn<<<grid, kSnThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int snode_launch(int device, int scatter, const SnodeArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = scatter ? snode_launch_one<T, true>(device, *a, s)
                : snode_launch_one<T, false>(device, *a, s);
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

// The supernodal variant: `scatter` for kind 0, else kind 2. One persistent
// launch; returns cudaGetLastError() after it.
extern "C" int sptrsv_snode_f32(int device, int scatter, const SnodeArgs* a,
                                void* stream) {
  return snode_launch<float>(device, scatter, a, stream);
}

extern "C" int sptrsv_snode_f64(int device, int scatter, const SnodeArgs* a,
                                void* stream) {
  return snode_launch<double>(device, scatter, a, stream);
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
