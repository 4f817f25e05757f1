// rsymbolic.cpp — native host layer for rsparse_tpu.
//
// Implements the symbolic-analysis machinery of Tim Davis's CSparse
// ("Direct Methods for Sparse Linear Systems") that the TPU build runs once
// per sparsity pattern on the host: AMD fill-reducing ordering, elimination
// tree, postorder, column counts, QR row counts (vcount), factor-pattern
// builders (ereach / QR pattern replay), and level schedules for the device
// kernels. Also provides a complete native numeric path (chol/lu/qr +
// triangular solves) used as the small-problem fast path and as the
// correctness oracle for the device kernels.
//
// Behavioral parity targets are cited as reference file:line into
// /root/reference (the Rust rsparse crate); the code here is an independent
// C++ implementation of the same published algorithms.
//
// Build: g++ -O3 -fPIC -shared rsymbolic.cpp -o librsymbolic.so
// Binding: ctypes (see ../symbolic/native.py). All indices are int64_t
// (numpy int64), values double.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

typedef int64_t i64;

namespace {

inline i64 flip(i64 i) { return -i - 2; }
inline i64 unflip(i64 i) { return (i < 0) ? flip(i) : i; }
inline bool is_marked(const i64* w, i64 j) { return w[j] < 0; }
inline void set_mark(i64* w, i64 j) { w[j] = flip(w[j]); }

// Pattern-only CSC used internally by AMD's C-construction.
struct Pat {
  i64 m = 0, n = 0;
  std::vector<i64> p, i;
  i64 nnz() const { return p.empty() ? 0 : p[n]; }
};

// C = A' (counting sort; reference transpose semantics src/lib.rs:1178-1197)
Pat pat_transpose(const Pat& a) {
  Pat c;
  c.m = a.n;
  c.n = a.m;
  c.p.assign(a.m + 1, 0);
  c.i.assign(a.nnz(), 0);
  std::vector<i64> w(a.m, 0);
  for (i64 q = 0; q < a.nnz(); q++) w[a.i[q]]++;
  i64 nz = 0;
  for (i64 j = 0; j < a.m; j++) {
    c.p[j] = nz;
    nz += w[j];
    w[j] = c.p[j];
  }
  c.p[a.m] = nz;
  for (i64 j = 0; j < a.n; j++)
    for (i64 q = a.p[j]; q < a.p[j + 1]; q++) c.i[w[a.i[q]]++] = j;
  return c;
}

// C = A + B structural union in scatter order (reference add src/lib.rs:247-271)
Pat pat_add(const Pat& a, const Pat& b) {
  Pat c;
  c.m = a.m;
  c.n = b.n;
  c.p.assign(c.n + 1, 0);
  c.i.assign(a.nnz() + b.nnz(), 0);
  std::vector<i64> w(c.m, -1);
  i64 nz = 0;
  for (i64 j = 0; j < c.n; j++) {
    c.p[j] = nz;
    for (i64 q = a.p[j]; q < a.p[j + 1]; q++)
      if (w[a.i[q]] < j) { w[a.i[q]] = j; c.i[nz++] = a.i[q]; }
    for (i64 q = b.p[j]; q < b.p[j + 1]; q++)
      if (w[b.i[q]] < j) { w[b.i[q]] = j; c.i[nz++] = b.i[q]; }
  }
  c.p[c.n] = nz;
  c.i.resize(nz);
  return c;
}

// C = A*B structural, Gustavson scatter order (reference src/lib.rs:713-748)
Pat pat_multiply(const Pat& a, const Pat& b) {
  Pat c;
  c.m = a.m;
  c.n = b.n;
  c.p.assign(c.n + 1, 0);
  std::vector<i64> w(a.m, -1);
  std::vector<i64> ci;
  ci.reserve(a.nnz() + b.nnz());
  i64 nz = 0;
  for (i64 j = 0; j < b.n; j++) {
    c.p[j] = nz;
    for (i64 q = b.p[j]; q < b.p[j + 1]; q++) {
      i64 k = b.i[q];
      for (i64 s = a.p[k]; s < a.p[k + 1]; s++) {
        if (w[a.i[s]] < j) { w[a.i[s]] = j; ci.push_back(a.i[s]); nz++; }
      }
    }
  }
  c.p[b.n] = nz;
  c.i = std::move(ci);
  return c;
}

// drop diagonal entries in place (reference fkeep+diag src/lib.rs:2075-2095)
void pat_dropdiag(Pat& a) {
  i64 nz = 0;
  for (i64 j = 0; j < a.n; j++) {
    i64 q = a.p[j];
    a.p[j] = nz;
    for (; q < a.p[j + 1]; q++)
      if (a.i[q] != j) a.i[nz++] = a.i[q];
  }
  a.p[a.n] = nz;
}

// depth-first search + postorder of a tree (reference tdfs src/lib.rs:2412-2446)
i64 tdfs(i64 j, i64 k, i64* head, i64* next, i64* post, i64* stack) {
  i64 top = 0;
  stack[0] = j;
  while (top >= 0) {
    i64 p = stack[top];
    i64 i = head[p];
    if (i == -1) {
      top--;
      post[k++] = p;
    } else {
      head[p] = next[i];
      stack[++top] = i;
    }
  }
  return k;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// etree — elimination tree of triu(A) or of A'A without forming it
// (reference src/lib.rs:2026-2071)
// ---------------------------------------------------------------------------
void rt_etree(i64 m, i64 n, const i64* Ap, const i64* Ai, int ata, i64* parent) {
  std::vector<i64> ancestor(n, -1), prev;
  if (ata) prev.assign(m, -1);
  for (i64 k = 0; k < n; k++) {
    parent[k] = -1;
    ancestor[k] = -1;
    for (i64 q = Ap[k]; q < Ap[k + 1]; q++) {
      i64 i = ata ? prev[Ai[q]] : Ai[q];
      while (i != -1 && i < k) {
        i64 inext = ancestor[i];
        ancestor[i] = k;  // path compression
        if (inext == -1) parent[i] = k;
        i = inext;
      }
      if (ata) prev[Ai[q]] = k;
    }
  }
}

// ---------------------------------------------------------------------------
// post — postorder a forest (reference src/lib.rs:2213-2240)
// ---------------------------------------------------------------------------
void rt_post(i64 n, const i64* parent, i64* post) {
  std::vector<i64> w(3 * n, -1);
  i64* head = w.data();
  i64* next = w.data() + n;
  i64* stack = w.data() + 2 * n;
  for (i64 j = n - 1; j >= 0; j--) {
    if (parent[j] == -1) continue;
    next[j] = head[parent[j]];
    head[parent[j]] = j;
  }
  i64 k = 0;
  for (i64 j = 0; j < n; j++) {
    if (parent[j] != -1) continue;
    k = tdfs(j, k, head, next, post, stack);
  }
}

// ---------------------------------------------------------------------------
// counts — column counts of chol(A) or chol(A'A)
// (reference counts+cedge src/lib.rs:1756-1897)
// ---------------------------------------------------------------------------
static void cedge(i64 j, i64 i, i64* first, i64* maxfirst, i64* prevleaf,
                  i64* ancestor, i64* delta) {
  if (i <= j || first[j] <= maxfirst[i]) return;
  maxfirst[i] = first[j];
  i64 jprev = prevleaf[i];
  delta[j]++;
  if (jprev != -1) {
    i64 q = jprev;
    while (q != ancestor[q]) q = ancestor[q];
    i64 s = jprev;
    while (s != q) {
      i64 sp = ancestor[s];
      ancestor[s] = q;
      s = sp;
    }
    delta[q]--;
  }
  prevleaf[i] = j;
}

void rt_counts(i64 m, i64 n, const i64* Ap, const i64* Ai, const i64* parent,
               const i64* post, int ata, i64* delta) {
  Pat a;
  a.m = m;
  a.n = n;
  a.p.assign(Ap, Ap + n + 1);
  a.i.assign(Ai, Ai + Ap[n]);
  Pat at = pat_transpose(a);
  std::vector<i64> w(4 * n + (ata ? (n + m + 1) : 0), -1);
  i64* ancestor = w.data();
  i64* maxfirst = w.data() + n;
  i64* prevleaf = w.data() + 2 * n;
  i64* first = w.data() + 3 * n;
  i64* head = ata ? w.data() + 4 * n : nullptr;
  i64* next = ata ? w.data() + 5 * n + 1 : nullptr;
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    delta[j] = (first[j] == -1) ? 1 : 0;
    while (j != -1 && first[j] == -1) {
      first[j] = k;
      j = parent[j];
    }
  }
  if (ata) {
    for (i64 k = 0; k < n; k++) w[post[k]] = k;  // invert post (in ancestor area)
    for (i64 i = 0; i < m; i++) {
      i64 k = n;
      for (i64 q = at.p[i]; q < at.p[i + 1]; q++) k = std::min(k, w[at.i[q]]);
      next[i] = head[k];
      head[k] = i;
    }
  }
  for (i64 i = 0; i < n; i++) ancestor[i] = i;
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    if (parent[j] != -1) delta[parent[j]]--;
    if (ata) {
      for (i64 ii = head[k]; ii != -1; ii = next[ii])
        for (i64 q = at.p[ii]; q < at.p[ii + 1]; q++)
          cedge(j, at.i[q], first, maxfirst, prevleaf, ancestor, delta);
    } else {
      for (i64 q = at.p[j]; q < at.p[j + 1]; q++)
        cedge(j, at.i[q], first, maxfirst, prevleaf, ancestor, delta);
    }
    if (parent[j] != -1) ancestor[j] = parent[j];
  }
  for (i64 j = 0; j < n; j++)
    if (parent[j] != -1) delta[parent[j]] += delta[j];
}

// ---------------------------------------------------------------------------
// amd — approximate minimum degree ordering (reference src/lib.rs:1292-1752)
// order: 0 => C=A+A' (square), 1 => C=A'A minus dense rows, 2 => C=A'A.
// Returns 0 for natural ordering (order < 0), 1 on success.
// ---------------------------------------------------------------------------
static i64 wclear(i64 mark, i64 lemax, i64* w, i64 n) {
  if (mark < 2 || mark + lemax < 0) {
    for (i64 k = 0; k < n; k++)
      if (w[k] != 0) w[k] = 1;
    mark = 2;
  }
  return mark;
}

int rt_amd(int order, i64 m, i64 n, const i64* Ap, const i64* Ai, i64* perm) {
  if (order < 0) return 0;  // natural (reference src/lib.rs:1324-1326)

  Pat a;
  a.m = m;
  a.n = n;
  a.p.assign(Ap, Ap + n + 1);
  a.i.assign(Ai, Ai + Ap[n]);
  Pat at = pat_transpose(a);

  i64 dense = std::max<i64>(16, (i64)(10.0 * std::sqrt((double)n)));
  dense = std::min<i64>((i64)n - 2, dense);

  Pat c;
  if (order == 0 && n == m) {
    c = pat_add(a, at);  // C = A+A'
  } else if (order == 1) {
    // drop dense columns from AT (rows of A), then C = AT*AT'
    i64 p2 = 0;
    for (i64 j = 0; j < m; j++) {
      i64 q = at.p[j];
      at.p[j] = p2;
      if (at.p[j + 1] - q > dense) continue;
      for (; q < at.p[j + 1]; q++) at.i[p2++] = at.i[q];
    }
    at.p[m] = p2;
    at.i.resize(p2);
    Pat a2 = pat_transpose(at);
    c = pat_multiply(at, a2);
  } else {
    c = pat_multiply(at, a);  // C = A'A
  }
  at = Pat();

  pat_dropdiag(c);
  i64 cnz = c.p[n];
  i64 cap = cnz + cnz / 5 + 2 * n;  // elbow room for garbage collection
  c.i.resize(cap);

  std::vector<i64> W(8 * (n + 1), 0);
  i64* len = W.data();
  i64* nv = W.data() + (n + 1);
  i64* next = W.data() + 2 * (n + 1);
  i64* head = W.data() + 3 * (n + 1);
  i64* elen = W.data() + 4 * (n + 1);
  i64* degree = W.data() + 5 * (n + 1);
  i64* w = W.data() + 6 * (n + 1);
  i64* hhead = W.data() + 7 * (n + 1);
  i64* last = perm;  // use output as 'last' workspace (as the reference does)

  i64* Cp = c.p.data();
  i64* Ci = c.i.data();

  for (i64 k = 0; k < n; k++) len[k] = Cp[k + 1] - Cp[k];
  len[n] = 0;
  for (i64 i = 0; i <= n; i++) {
    head[i] = -1;
    last[i] = -1;
    next[i] = -1;
    hhead[i] = -1;
    nv[i] = 1;
    w[i] = 1;
    elen[i] = 0;
    degree[i] = len[i];
  }
  i64 lemax = 0;
  i64 mark = wclear(0, 0, w, n);
  elen[n] = -2;  // n is a dead element
  Cp[n] = -1;    // n is a root of the assembly tree
  w[n] = 0;

  i64 nel = 0;
  for (i64 i = 0; i < n; i++) {
    i64 d = degree[i];
    if (d == 0) {          // empty node
      elen[i] = -2;
      nel++;
      Cp[i] = -1;
      w[i] = 0;
    } else if (d > dense) {  // dense node
      nv[i] = 0;
      elen[i] = -1;
      nel++;
      Cp[i] = flip((i64)n);
      nv[n]++;
    } else {
      if (head[d] != -1) last[head[d]] = i;
      next[i] = head[d];
      head[d] = i;
    }
  }

  i64 mindeg = 0;
  while (nel < n) {
    // select node of minimum approximate degree
    i64 k;
    for (k = -1; mindeg < n && (k = head[mindeg]) == -1; mindeg++) {}
    if (next[k] != -1) last[next[k]] = -1;
    head[mindeg] = next[k];
    i64 elenk = elen[k];
    i64 nvk = nv[k];
    nel += nvk;

    // garbage collection
    if (elenk > 0 && cnz + mindeg >= cap) {
      for (i64 j = 0; j < n; j++) {
        i64 q = Cp[j];
        if (q >= 0) {
          Cp[j] = Ci[q];
          Ci[q] = flip(j);
        }
      }
      i64 qd = 0, qs = 0;
      while (qs < cnz) {
        i64 j = flip(Ci[qs++]);
        if (j >= 0) {
          Ci[qd] = Cp[j];
          Cp[j] = qd++;
          for (i64 k3 = 0; k3 < len[j] - 1; k3++) Ci[qd++] = Ci[qs++];
        }
      }
      cnz = qd;
    }

    // construct new element
    i64 dk = 0;
    nv[k] = -nvk;
    i64 p = Cp[k];
    i64 pk1 = (elenk == 0) ? p : cnz;
    i64 pk2 = pk1;
    for (i64 k1 = 1; k1 <= elenk + 1; k1++) {
      i64 e, pj, ln;
      if (k1 > elenk) {
        e = k;
        pj = p;
        ln = len[k] - elenk;
      } else {
        e = Ci[p++];
        pj = Cp[e];
        ln = len[e];
      }
      for (i64 k2 = 1; k2 <= ln; k2++) {
        i64 i = Ci[pj++];
        i64 nvi = nv[i];
        if (nvi <= 0) continue;
        dk += nvi;
        nv[i] = -nvi;
        Ci[pk2++] = i;
        if (next[i] != -1) last[next[i]] = last[i];
        if (last[i] != -1) {
          next[last[i]] = next[i];
        } else {
          head[degree[i]] = next[i];
        }
      }
      if (e != k) {
        Cp[e] = flip(k);
        w[e] = 0;
      }
    }
    if (elenk != 0) cnz = pk2;
    degree[k] = dk;
    Cp[k] = pk1;
    len[k] = pk2 - pk1;
    elen[k] = -2;

    // find set differences (scan1)
    mark = wclear(mark, lemax, w, n);
    for (i64 pk = pk1; pk < pk2; pk++) {
      i64 i = Ci[pk];
      i64 eln = elen[i];
      if (eln <= 0) continue;
      i64 nvi = -nv[i];
      i64 wnvi = mark - nvi;
      for (i64 q = Cp[i]; q <= Cp[i] + eln - 1; q++) {
        i64 e = Ci[q];
        if (w[e] >= mark) {
          w[e] -= nvi;
        } else if (w[e] != 0) {
          w[e] = degree[e] + wnvi;
        }
      }
    }

    // degree update (scan2)
    for (i64 pk = pk1; pk < pk2; pk++) {
      i64 i = Ci[pk];
      i64 p1 = Cp[i];
      i64 p2 = p1 + elen[i] - 1;
      i64 pn = p1;
      i64 h = 0, d = 0;
      for (i64 q = p1; q <= p2; q++) {
        i64 e = Ci[q];
        if (w[e] != 0) {
          i64 dext = w[e] - mark;
          if (dext > 0) {
            d += dext;
            Ci[pn++] = e;
            h += e;
          } else {
            Cp[e] = flip(k);  // aggressive absorption
            w[e] = 0;
          }
        }
      }
      elen[i] = pn - p1 + 1;
      i64 p3 = pn;
      i64 p4 = p1 + len[i];
      for (i64 q = p2 + 1; q < p4; q++) {
        i64 j = Ci[q];
        i64 nvj = nv[j];
        if (nvj <= 0) continue;
        d += nvj;
        Ci[pn++] = j;
        h += j;
      }
      if (d == 0) {  // mass elimination
        Cp[i] = flip(k);
        i64 nvi = -nv[i];
        dk -= nvi;
        nvk += nvi;
        nel += nvi;
        nv[i] = 0;
        elen[i] = -1;
      } else {
        degree[i] = std::min(degree[i], d);
        Ci[pn] = Ci[p3];
        Ci[p3] = Ci[p1];
        Ci[p1] = k;
        len[i] = pn - p1 + 1;
        h %= n;
        next[i] = hhead[h];
        hhead[h] = i;
        last[i] = h;  // save hash in last[i]
      }
    }
    degree[k] = dk;
    lemax = std::max(lemax, dk);
    mark = wclear(mark + lemax, lemax, w, n);

    // supernode detection
    for (i64 pk = pk1; pk < pk2; pk++) {
      i64 i = Ci[pk];
      if (nv[i] >= 0) continue;  // skip if i is dead
      i64 h = last[i];
      i = hhead[h];
      hhead[h] = -1;
      while (i != -1 && next[i] != -1) {
        i64 ln = len[i];
        i64 eln = elen[i];
        for (i64 q = Cp[i] + 1; q <= Cp[i] + ln - 1; q++) w[Ci[q]] = mark;
        i64 jlast = i;
        i64 j = next[i];
        while (j != -1) {
          bool ok = (len[j] == ln) && (elen[j] == eln);
          for (i64 q = Cp[j] + 1; ok && q < Cp[j] + ln; q++)
            if (w[Ci[q]] != mark) ok = false;
          if (ok) {  // i and j are identical: absorb j into i
            Cp[j] = flip(i);
            nv[i] += nv[j];
            nv[j] = 0;
            elen[j] = -1;
            j = next[j];
            next[jlast] = j;
          } else {
            jlast = j;
            j = next[j];
          }
        }
        i = next[i];
        mark++;
      }
    }

    // finalize new element
    p = pk1;
    for (i64 pk = pk1; pk < pk2; pk++) {
      i64 i = Ci[pk];
      i64 nvi = -nv[i];
      if (nvi <= 0) continue;
      nv[i] = nvi;
      i64 d = degree[i] + dk - nvi;
      d = std::min(d, (i64)n - nel - nvi);
      if (head[d] != -1) last[head[d]] = i;
      next[i] = head[d];
      last[i] = -1;
      head[d] = i;
      mindeg = std::min(mindeg, d);
      degree[i] = d;
      Ci[p++] = i;
    }
    nv[k] = nvk;
    len[k] = p - pk1;
    if (len[k] == 0) {
      Cp[k] = -1;
      w[k] = 0;
    }
    if (elenk != 0) cnz = p;
  }

  // post-ordering of the assembly tree
  for (i64 i = 0; i < n; i++) Cp[i] = flip(Cp[i]);
  for (i64 j = 0; j <= n; j++) head[j] = -1;
  for (i64 j = n; j >= 0; j--) {
    if (nv[j] > 0) continue;
    next[j] = head[Cp[j]];
    head[Cp[j]] = j;
  }
  for (i64 e = n; e >= 0; e--) {
    if (nv[e] <= 0) continue;
    if (Cp[e] != -1) {
      next[e] = head[Cp[e]];
      head[Cp[e]] = e;
    }
  }
  i64 k = 0;
  std::vector<i64> stack(n + 1);
  for (i64 i = 0; i <= n; i++) {
    if (Cp[i] == -1) k = tdfs(i, k, head, next, perm, stack.data());
  }
  return 1;
}

// ---------------------------------------------------------------------------
// vcount — QR row permutation, fictitious rows, nnz(V)
// (reference src/lib.rs:2450-2530). pinv has the reference layout: a
// (2m+n)-vector with pinv proper in [0, m2) and leftmost in [m+n, m+n+m).
// ---------------------------------------------------------------------------
void rt_vcount(i64 m, i64 n, const i64* Ap, const i64* Ai, const i64* parent,
               i64* pinv, i64* m2_out, i64* vnz_out) {
  i64* leftmost = pinv + m + n;
  std::vector<i64> w(m + 3 * n);
  i64* next = w.data();
  i64* head = w.data() + m;
  i64* tail = w.data() + m + n;
  i64* nque = w.data() + m + 2 * n;
  std::fill(head, head + n, -1);
  std::fill(tail, tail + n, -1);
  std::fill(nque, nque + n, 0);
  std::fill(leftmost, leftmost + m, -1);
  for (i64 k = n - 1; k >= 0; k--)
    for (i64 q = Ap[k]; q < Ap[k + 1]; q++) leftmost[Ai[q]] = k;
  for (i64 i = m - 1; i >= 0; i--) {
    pinv[i] = -1;
    i64 k = leftmost[i];
    if (k == -1) continue;
    if (nque[k] == 0) tail[k] = i;
    nque[k]++;
    next[i] = head[k];
    head[k] = i;
  }
  i64 vnz = 0, m2 = m;
  for (i64 k = 0; k < n; k++) {
    i64 i = head[k];
    vnz++;
    if (i < 0) i = m2++;  // add a fictitious row
    pinv[i] = k;
    nque[k]--;
    if (nque[k] <= 0) continue;
    vnz += nque[k];
    i64 pa = parent[k];
    if (pa != -1) {
      if (nque[pa] == 0) tail[pa] = tail[k];
      next[tail[k]] = head[pa];
      head[pa] = next[i];
      nque[pa] += nque[k];
    }
  }
  i64 k = n;
  for (i64 i = 0; i < m; i++)
    if (pinv[i] < 0) pinv[i] = k++;
  *m2_out = m2;
  *vnz_out = vnz;
}

// ---------------------------------------------------------------------------
// chol pattern — exact L pattern + per-row (ereach) patterns + etree levels.
// Inputs: C = triu(A(P,P)) (CSC), parent, cp (column pointers of L).
// Outputs: Lp/Li (CSC of L, ascending rows, diag first entry per column),
//          Rp/Rj (CSR row patterns excl. diag, ascending), level[k].
// The ereach walk mirrors reference src/lib.rs:1985-2022.
// ---------------------------------------------------------------------------
void rt_chol_pattern(i64 n, const i64* Cp, const i64* Ci, const i64* parent,
                     const i64* cp, i64* Lp, i64* Li, i64* Rp, i64* Rj,
                     i64* level) {
  std::vector<i64> w(n, -1), s(n), fill(n);
  for (i64 k = 0; k <= n; k++) Lp[k] = cp[k];
  for (i64 k = 0; k < n; k++) fill[k] = cp[k];
  i64 rnz = 0;
  for (i64 k = 0; k < n; k++) {
    Rp[k] = rnz;
    w[k] = k;
    i64 top = n;
    for (i64 q = Cp[k]; q < Cp[k + 1]; q++) {
      i64 i = Ci[q];
      if (i > k) continue;
      i64 len = 0;
      for (; w[i] != k; i = parent[i]) {
        s[len++] = i;
        w[i] = k;
      }
      while (len > 0) s[--top] = s[--len];
    }
    // row pattern (topological from the stack); sort ascending for the
    // batched dense triangular-solve kernel.
    i64 cnt = n - top;
    for (i64 t = 0; t < cnt; t++) Rj[rnz + t] = s[top + t];
    std::sort(Rj + rnz, Rj + rnz + cnt);
    // place L(k,i) in column i, and the diagonal L(k,k) in column k.
    // diag is the FIRST entry of column k (lsolve convention,
    // reference src/lib.rs:425-427) because column k starts at cp[k] and we
    // reserve it before any later row lands there.
    Li[fill[k]++] = k;
    for (i64 t = 0; t < cnt; t++) Li[fill[Rj[rnz + t]]++] = k;
    rnz += cnt;
  }
  Rp[n] = rnz;
  // etree levels: level[k] = 1 + max(level[children]) (ascending pass works
  // because parent[k] > k for elimination trees).
  for (i64 k = 0; k < n; k++) level[k] = 0;
  for (i64 k = 0; k < n; k++)
    if (parent[k] != -1) level[parent[k]] = std::max(level[parent[k]], level[k] + 1);
}

// ---------------------------------------------------------------------------
// chol numeric (host oracle / fast path) — up-looking Cholesky
// (reference src/lib.rs:278-337). Returns 0 on success, -1 if not positive
// definite.
// ---------------------------------------------------------------------------
int rt_chol_numeric(i64 n, const i64* Cp, const i64* Ci, const double* Cx,
                    const i64* parent, const i64* cp, i64* Lp, i64* Li,
                    double* Lx) {
  std::vector<i64> w(n, -1), s(n), fill(n);
  std::vector<double> x(n, 0.0);
  for (i64 k = 0; k <= n; k++) Lp[k] = cp[k];
  for (i64 k = 0; k < n; k++) fill[k] = cp[k];
  for (i64 k = 0; k < n; k++) {
    // pattern of L(k,:) via ereach, scatter A(:,k) values
    w[k] = k;
    i64 top = n;
    x[k] = 0.0;
    for (i64 q = Cp[k]; q < Cp[k + 1]; q++) {
      i64 i = Ci[q];
      if (i > k) continue;
      x[i] = Cx[q];
      i64 len = 0;
      for (; w[i] != k; i = parent[i]) {
        s[len++] = i;
        w[i] = k;
      }
      while (len > 0) s[--top] = s[--len];
    }
    double d = x[k];
    x[k] = 0.0;
    for (; top < n; top++) {
      i64 i = s[top];
      double lki = x[i] / Lx[Lp[i]];
      x[i] = 0.0;
      for (i64 q = Lp[i] + 1; q < fill[i]; q++) x[Li[q]] -= Lx[q] * lki;
      d -= lki * lki;
      Li[fill[i]] = k;
      Lx[fill[i]] = lki;
      fill[i]++;
    }
    if (d <= 0.0) return -1;  // NotPositiveDefinite
    Li[fill[k]] = k;
    Lx[fill[k]] = std::sqrt(d);
    fill[k]++;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// LU numeric (host oracle / fast path) — left-looking LU with partial
// pivoting (reference src/lib.rs:519-622, splsolve 2333-2365, reach
// 2256-2277, dfs 1916-1975). Returns 0 ok, -1 NoPivot, -2 capacity overflow
// (caller retries with bigger caps; lnz_out/unz_out hold needed sizes).
// ---------------------------------------------------------------------------
static i64 lu_dfs(i64 j, i64* Lp, const i64* Li, i64 top, i64* xi, i64* pstack,
                  const i64* pinv) {
  i64 head = 0;
  xi[0] = j;
  while (head >= 0) {
    j = xi[head];
    i64 jnew = pinv ? pinv[j] : j;
    if (!is_marked(Lp, j)) {
      set_mark(Lp, j);
      pstack[head] = (jnew < 0) ? 0 : unflip(Lp[jnew]);
    }
    bool done = true;
    i64 q2 = (jnew < 0) ? 0 : unflip(Lp[jnew + 1]);
    for (i64 q = pstack[head]; q < q2; q++) {
      i64 i = Li[q];
      if (is_marked(Lp, i)) continue;
      pstack[head] = q;
      xi[++head] = i;
      done = false;
      break;
    }
    if (done) {
      head--;
      xi[--top] = j;
    }
  }
  return top;
}

int rt_lu_numeric(i64 n, const i64* Ap, const i64* Ai, const double* Ax,
                  const i64* q_perm, double tol, i64 cap_l, i64 cap_u,
                  i64* Lp, i64* Li, double* Lx, i64* Up, i64* Ui, double* Ux,
                  i64* pinv, i64* lnz_out, i64* unz_out) {
  std::vector<double> x(n, 0.0);
  std::vector<i64> xi(2 * n, 0);
  std::fill(pinv, pinv + n, -1);
  std::fill(Lp, Lp + n + 1, 0);
  i64 lnz = 0, unz = 0;
  for (i64 k = 0; k < n; k++) {
    Lp[k] = lnz;
    Up[k] = unz;
    if (lnz + n > cap_l || unz + n > cap_u) {
      *lnz_out = 2 * cap_l + n;
      *unz_out = 2 * cap_u + n;
      return -2;
    }
    i64 col = q_perm ? q_perm[k] : k;
    // splsolve: x = L \ A(:,col); pattern in xi[top..n)
    i64 top = n;
    for (i64 q = Ap[col]; q < Ap[col + 1]; q++) {
      if (!is_marked(Lp, Ai[q]))
        top = lu_dfs(Ai[q], Lp, Li, top, xi.data(), xi.data() + n, pinv);
    }
    for (i64 q = top; q < n; q++) set_mark(Lp, xi[q]);  // restore L
    for (i64 q = top; q < n; q++) x[xi[q]] = 0.0;
    for (i64 q = Ap[col]; q < Ap[col + 1]; q++) x[Ai[q]] = Ax[q];
    for (i64 q = top; q < n; q++) {
      i64 j = xi[q];
      i64 jnew = pinv[j];
      if (jnew < 0) continue;
      for (i64 s = Lp[jnew] + 1; s < Lp[jnew + 1]; s++) x[Li[s]] -= Lx[s] * x[j];
    }
    // find pivot
    i64 ipiv = -1;
    double a_f = -1.0;
    for (i64 q = top; q < n; q++) {
      i64 i = xi[q];
      if (pinv[i] < 0) {
        double t = std::fabs(x[i]);
        if (t > a_f) {
          a_f = t;
          ipiv = i;
        }
      } else {
        Ui[unz] = pinv[i];
        Ux[unz] = x[i];
        unz++;
      }
    }
    if (ipiv == -1 || a_f <= 0.0) return -1;  // NoPivot
    if (pinv[col] < 0 && std::fabs(x[col]) >= a_f * tol) ipiv = col;
    // divide by pivot
    double pivot = x[ipiv];
    Ui[unz] = k;
    Ux[unz] = pivot;
    unz++;
    pinv[ipiv] = k;
    Li[lnz] = ipiv;
    Lx[lnz] = 1.0;
    lnz++;
    for (i64 q = top; q < n; q++) {
      i64 i = xi[q];
      if (pinv[i] < 0) {
        Li[lnz] = i;
        Lx[lnz] = x[i] / pivot;
        lnz++;
      }
      x[i] = 0.0;
    }
  }
  Lp[n] = lnz;
  Up[n] = unz;
  for (i64 q = 0; q < lnz; q++) Li[q] = pinv[Li[q]];
  *lnz_out = lnz;
  *unz_out = unz;
  return 0;
}

// ---------------------------------------------------------------------------
// Static-pivot LU pattern replay (device-LU symbolic phase).
// Replays the left-looking factorization with pinv = identity (GESP-style
// static pivoting — the pattern the device kernel factors; numeric partial
// pivoting falls back to rt_lu_numeric). Per column k of A(:,q):
//   reach of A(:,col) rows in graph(L) -> U rows {i<k} + L rows {i>k} + diag.
// Outputs (rows ascending): L with diag FIRST per column (lsolve convention,
// reference src/lib.rs:425-427), U with diag LAST (src/lib.rs:1232), and the
// column level schedule level[k] = 1 + max level over offdiag U rows (the
// columns whose L factors column k reads). Returns 0 ok, -1 structurally
// singular (diag unreachable), -2 capacity overflow (needed sizes in
// lnz_out/unz_out).
// ---------------------------------------------------------------------------
int rt_lu_pattern(i64 n, const i64* Ap, const i64* Ai, const i64* q_perm,
                  i64 cap_l, i64 cap_u,
                  i64* Lp, i64* Li, i64* Up, i64* Ui, i64* level,
                  i64* lnz_out, i64* unz_out) {
  std::vector<i64> xi(2 * n, 0);
  std::fill(Lp, Lp + n + 1, 0);
  // static pivoting: row k becomes pivotal at step k (identity pinv for
  // finished columns, -1 = not yet pivotal, matching lu_dfs's contract)
  std::vector<i64> spinv(n, -1);
  i64 lnz = 0, unz = 0;
  std::vector<i64> urows, lrows;
  for (i64 k = 0; k < n; k++) {
    Lp[k] = lnz;
    Up[k] = unz;
    i64 col = q_perm ? q_perm[k] : k;
    i64 top = n;
    for (i64 q = Ap[col]; q < Ap[col + 1]; q++) {
      if (!is_marked(Lp, Ai[q]))
        top = lu_dfs(Ai[q], Lp, Li, top, xi.data(), xi.data() + n, spinv.data());
    }
    for (i64 q = top; q < n; q++) set_mark(Lp, xi[q]);  // restore L marks
    urows.clear();
    lrows.clear();
    bool has_diag = false;
    for (i64 q = top; q < n; q++) {
      i64 i = xi[q];
      if (i < k)
        urows.push_back(i);
      else if (i > k)
        lrows.push_back(i);
      else
        has_diag = true;
    }
    if (!has_diag) return -1;  // structurally singular under static pivoting
    if (lnz + (i64)lrows.size() + 1 > cap_l ||
        unz + (i64)urows.size() + 1 > cap_u) {
      *lnz_out = 2 * cap_l + n;
      *unz_out = 2 * cap_u + n;
      return -2;
    }
    std::sort(urows.begin(), urows.end());
    std::sort(lrows.begin(), lrows.end());
    i64 lev = 0;
    for (i64 j : urows) lev = std::max(lev, level[j] + 1);
    level[k] = lev;
    for (i64 j : urows) Ui[unz++] = j;
    Ui[unz++] = k;  // diag last
    Li[lnz++] = k;  // diag first
    for (i64 i : lrows) Li[lnz++] = i;
    spinv[k] = k;
  }
  Lp[n] = lnz;
  Up[n] = unz;
  *lnz_out = lnz;
  *unz_out = unz;
  return 0;
}

// ---------------------------------------------------------------------------
// QR pattern replay — V and R column patterns, values-free
// (pattern logic of reference qr src/lib.rs:788-877 + scatter_no_x
// 2310-2329). Inputs: A + optional column perm q, parent (etree of C'C),
// pinv (vcount layout, 2m+n), m2. Outputs CSC patterns Vp/Vi and Rp/Ri.
// R columns are emitted in the reference's stack order (descending tree
// walk); the diagonal R(k,k) is the LAST entry of column k (usolve
// convention, reference src/lib.rs:1232).
// ---------------------------------------------------------------------------
void rt_qr_pattern(i64 m, i64 n, const i64* Ap, const i64* Ai, const i64* q_perm,
                   const i64* parent, const i64* pinv, i64 m2,
                   i64* Vp, i64* Vi, i64* Rp, i64* Ri) {
  const i64* leftmost = pinv + m + n;
  std::vector<i64> w(m2 + n, -1);
  i64* ws = w.data() + m2;
  i64 rnz = 0, vnz = 0;
  for (i64 k = 0; k < n; k++) {
    Rp[k] = rnz;
    Vp[k] = vnz;
    w[k] = k;
    Vi[vnz++] = k;
    i64 top = n;
    i64 col = q_perm ? q_perm[k] : k;
    for (i64 q = Ap[col]; q < Ap[col + 1]; q++) {
      i64 i = leftmost[Ai[q]];
      i64 len = 0;
      for (; w[i] != k; i = parent[i]) {
        ws[len++] = i;
        w[i] = k;
      }
      while (len > 0) ws[--top] = ws[--len];
      i = pinv[Ai[q]];
      if (i > k && w[i] < k) {
        Vi[vnz++] = i;
        w[i] = k;
      }
    }
    for (i64 q = top; q < n; q++) {
      i64 i = ws[q];
      Ri[rnz++] = i;
      if (parent[i] == k) {
        // scatter_no_x: merge V(:,i) pattern into V(:,k)
        for (i64 s = Vp[i]; s < Vp[i + 1]; s++) {
          if (w[Vi[s]] < k) {
            w[Vi[s]] = k;
            Vi[vnz++] = Vi[s];
          }
        }
      }
    }
    Ri[rnz++] = k;  // R(k,k), last entry of the column
  }
  Rp[n] = rnz;
  Vp[n] = vnz;
}

// ---------------------------------------------------------------------------
// QR numeric (host oracle / fast path) — Householder QR
// (reference src/lib.rs:788-877, house 2116-2147, happly 2099-2111).
// ---------------------------------------------------------------------------
static double house_host(double* x, double* beta, i64 len) {
  double sigma = 0.0;
  for (i64 i = 1; i < len; i++) sigma += x[i] * x[i];
  double s;
  if (sigma != 0.0) {
    s = std::sqrt(x[0] * x[0] + sigma);
    x[0] = (x[0] <= 0.0) ? (x[0] - s) : (-sigma / (x[0] + s));
    *beta = 1.0 / (-s * x[0]);
  } else {
    s = std::fabs(x[0]);
    *beta = (x[0] <= 0.0) ? 2.0 : 0.0;
    x[0] = 1.0;
  }
  return s;
}

void rt_qr_numeric(i64 m, i64 n, const i64* Ap, const i64* Ai, const double* Ax,
                   const i64* q_perm, const i64* parent, const i64* pinv,
                   i64 m2, i64* Vp, i64* Vi, double* Vx, i64* Rp, i64* Ri,
                   double* Rx, double* beta) {
  const i64* leftmost = pinv + m + n;
  std::vector<i64> w(m2 + n, -1);
  i64* ws = w.data() + m2;
  std::vector<double> x(m2, 0.0);
  i64 rnz = 0, vnz = 0;
  for (i64 k = 0; k < n; k++) {
    Rp[k] = rnz;
    Vp[k] = vnz;
    i64 p1 = vnz;
    w[k] = k;
    Vi[vnz++] = k;
    i64 top = n;
    i64 col = q_perm ? q_perm[k] : k;
    for (i64 q = Ap[col]; q < Ap[col + 1]; q++) {
      i64 i = leftmost[Ai[q]];
      i64 len = 0;
      for (; w[i] != k; i = parent[i]) {
        ws[len++] = i;
        w[i] = k;
      }
      while (len > 0) ws[--top] = ws[--len];
      i = pinv[Ai[q]];
      x[i] = Ax[q];
      if (i > k && w[i] < k) {
        Vi[vnz++] = i;
        w[i] = k;
      }
    }
    for (i64 q = top; q < n; q++) {
      i64 i = ws[q];
      // happly: apply (V(:,i), beta[i]) to x
      double tau = 0.0;
      for (i64 s = Vp[i]; s < Vp[i + 1]; s++) tau += Vx[s] * x[Vi[s]];
      tau *= beta[i];
      for (i64 s = Vp[i]; s < Vp[i + 1]; s++) x[Vi[s]] -= Vx[s] * tau;
      Ri[rnz] = i;
      Rx[rnz] = x[i];
      rnz++;
      x[i] = 0.0;
      if (parent[i] == k) {
        for (i64 s = Vp[i]; s < Vp[i + 1]; s++) {
          if (w[Vi[s]] < k) {
            w[Vi[s]] = k;
            Vi[vnz++] = Vi[s];
          }
        }
      }
    }
    for (i64 q = p1; q < vnz; q++) {
      Vx[q] = x[Vi[q]];
      x[Vi[q]] = 0.0;
    }
    Ri[rnz] = k;
    Rx[rnz] = house_host(Vx + p1, beta + k, vnz - p1);
    rnz++;
  }
  Rp[n] = rnz;
  Vp[n] = vnz;
}

// ---------------------------------------------------------------------------
// Host dense-RHS triangular solves (reference src/lib.rs:464-471, 505-512,
// 1230-1237, 1271-1278). Used by the host backend and the bench denominator.
// ---------------------------------------------------------------------------
void rt_lsolve(i64 n, const i64* Lp, const i64* Li, const double* Lx, double* x) {
  for (i64 j = 0; j < n; j++) {
    x[j] /= Lx[Lp[j]];
    for (i64 q = Lp[j] + 1; q < Lp[j + 1]; q++) x[Li[q]] -= Lx[q] * x[j];
  }
}

void rt_ltsolve(i64 n, const i64* Lp, const i64* Li, const double* Lx, double* x) {
  for (i64 j = n - 1; j >= 0; j--) {
    for (i64 q = Lp[j] + 1; q < Lp[j + 1]; q++) x[j] -= Lx[q] * x[Li[q]];
    x[j] /= Lx[Lp[j]];
  }
}

void rt_usolve(i64 n, const i64* Up, const i64* Ui, const double* Ux, double* x) {
  for (i64 j = n - 1; j >= 0; j--) {
    x[j] /= Ux[Up[j + 1] - 1];
    for (i64 q = Up[j]; q < Up[j + 1] - 1; q++) x[Ui[q]] -= Ux[q] * x[j];
  }
}

void rt_utsolve(i64 n, const i64* Up, const i64* Ui, const double* Ux, double* x) {
  for (i64 j = 0; j < n; j++) {
    for (i64 q = Up[j]; q < Up[j + 1] - 1; q++) x[j] -= Ux[q] * x[Ui[q]];
    x[j] /= Ux[Up[j + 1] - 1];
  }
}

// Least-squares apply for the qrsol m>=n branch (reference
// src/lib.rs:936-940): happly each reflector k=0..n-1 to the dense
// workspace x (reference happly, src/lib.rs:2099-2111), then R\x.
// The bench denominator for qrsol_wall_s (solve phase, factor amortized).
void rt_qr_ls_apply(i64 n, const i64* Vp, const i64* Vi, const double* Vx,
                    const double* beta, const i64* Rp, const i64* Ri,
                    const double* Rx, double* x) {
  for (i64 k = 0; k < n; k++) {
    double tau = 0.0;
    for (i64 s = Vp[k]; s < Vp[k + 1]; s++) tau += Vx[s] * x[Vi[s]];
    tau *= beta[k];
    for (i64 s = Vp[k]; s < Vp[k + 1]; s++) x[Vi[s]] -= Vx[s] * tau;
  }
  rt_usolve(n, Rp, Ri, Rx, x);
}

// ---------------------------------------------------------------------------
// Level schedules for the device triangular-solve kernels.
// kind: 0 = lsolve (lower, ascending, diag first), 1 = usolve (upper,
// descending, diag last), 2 = ltsolve (deps = rows>j in col j, descending),
// 3 = utsolve (deps = rows<j in col j, ascending).
// ---------------------------------------------------------------------------
// Level schedule = longest path over the solve dependency DAG. For a factor
// whose row labels are monotone within every column (the host engine's
// output) a single index-ordered pass suffices, but the multifrontal LU's
// elimination labels may CROSS front ranges after skeleton pivoting (entry
// row-label < column for L): the dependency graph is still acyclic (it is a
// relabeling of the execution dataflow), just not index-ordered. Kahn
// topological relaxation handles both; index-triangular inputs get the
// identical levels the old single pass produced. Returns -1 via level[0] if
// a cycle is detected (corrupt factor) — callers raise.
void rt_tri_levels(i64 n, const i64* Tp, const i64* Ti, int kind, i64* level) {
  std::fill(level, level + n, 0);
  if (n == 0) return;
  // Edges: kinds 0/1 (scatter forms) col -> offdiag rows of its column;
  // kinds 2/3 (gather forms) offdiag rows -> their column.
  const bool scatter = (kind == 0 || kind == 1);
  const i64 lo_off = (kind == 0 || kind == 2) ? 1 : 0;   // diag-first skip
  const i64 hi_off = (kind == 0 || kind == 2) ? 0 : 1;   // diag-last skip
  std::vector<i64> indeg(n, 0);
  if (scatter) {
    for (i64 j = 0; j < n; j++)
      for (i64 q = Tp[j] + lo_off; q < Tp[j + 1] - hi_off; q++)
        indeg[Ti[q]]++;
  } else {
    for (i64 j = 0; j < n; j++)
      indeg[j] = (Tp[j + 1] - hi_off) - (Tp[j] + lo_off);
    // gather forms need row -> column adjacency: build the transpose
  }
  std::vector<i64> tadj_p, tadj_i;
  if (!scatter) {
    i64 nz = Tp[n];
    tadj_p.assign(n + 1, 0);
    tadj_i.resize(nz);
    for (i64 j = 0; j < n; j++)
      for (i64 q = Tp[j] + lo_off; q < Tp[j + 1] - hi_off; q++)
        tadj_p[Ti[q] + 1]++;
    for (i64 r = 0; r < n; r++) tadj_p[r + 1] += tadj_p[r];
    std::vector<i64> w(tadj_p.begin(), tadj_p.end() - 1);
    for (i64 j = 0; j < n; j++)
      for (i64 q = Tp[j] + lo_off; q < Tp[j + 1] - hi_off; q++)
        tadj_i[w[Ti[q]]++] = j;
  }
  std::vector<i64> queue;
  queue.reserve(n);
  for (i64 j = 0; j < n; j++)
    if (indeg[j] == 0) queue.push_back(j);
  i64 done = 0;
  for (i64 head = 0; head < (i64)queue.size(); head++) {
    i64 j = queue[head];
    done++;
    if (scatter) {
      for (i64 q = Tp[j] + lo_off; q < Tp[j + 1] - hi_off; q++) {
        i64 r = Ti[q];
        if (level[r] < level[j] + 1) level[r] = level[j] + 1;
        if (--indeg[r] == 0) queue.push_back(r);
      }
    } else {
      for (i64 q = tadj_p[j]; q < tadj_p[j + 1]; q++) {
        i64 r = tadj_i[q];
        if (level[r] < level[j] + 1) level[r] = level[j] + 1;
        if (--indeg[r] == 0) queue.push_back(r);
      }
    }
  }
  if (done != n) level[0] = -1;  // cycle: corrupt factor, caller raises
}

// ---------------------------------------------------------------------------
// Host sequential SpMV r = A*x + y (reference gaxpy, src/lib.rs:411-421).
// Bench denominator: the reference's exact column-major accumulate loop.
// ---------------------------------------------------------------------------
void rt_gaxpy(i64 m, i64 n, const i64* Ap, const i64* Ai, const double* Ax,
              const double* x, const double* y, double* r) {
  for (i64 i = 0; i < m; i++) r[i] = y[i];
  for (i64 j = 0; j < n; j++)
    for (i64 q = Ap[j]; q < Ap[j + 1]; q++) r[Ai[q]] += Ax[q] * x[j];
}

// ---------------------------------------------------------------------------
// Host sequential SpGEMM C = A*B (reference Gustavson multiply,
// src/lib.rs:713-748 with the scatter of src/lib.rs:2281-2306).
// Bench denominator: the reference's exact column-wise scatter algorithm.
// Caller passes output buffers sized cap; returns nnz(C) or -1 on overflow
// (caller retries with a larger cap).
// ---------------------------------------------------------------------------
i64 rt_multiply(i64 am, i64 an, const i64* Ap, const i64* Ai, const double* Ax,
                i64 bn, const i64* Bp, const i64* Bi, const double* Bx,
                i64 cap, i64* Cp, i64* Ci, double* Cx) {
  std::vector<i64> w(am, -1);
  std::vector<double> x(am, 0.0);
  i64 nz = 0;
  for (i64 j = 0; j < bn; j++) {
    Cp[j] = nz;
    for (i64 p = Bp[j]; p < Bp[j + 1]; p++) {
      i64 k = Bi[p];
      double beta = Bx[p];
      for (i64 q = Ap[k]; q < Ap[k + 1]; q++) {
        i64 i = Ai[q];
        if (w[i] < j + 1) {
          if (nz >= cap) return -1;
          w[i] = j + 1;
          Ci[nz++] = i;
          x[i] = beta * Ax[q];
        } else {
          x[i] += beta * Ax[q];
        }
      }
    }
    for (i64 p = Cp[j]; p < nz; p++) Cx[p] = x[Ci[p]];
  }
  Cp[bn] = nz;
  return nz;
}

// ---------------------------------------------------------------------------
// Static-pivoting row matching (MC64-flavoured, SuperLU_DIST's GESP prep).
// Finds a row permutation placing large entries on the diagonal: greedy
// matching on entries sorted by descending |a_ij| / colmax_j, then Kuhn
// alternating-path augmentation (entries within a column tried largest
// first) for the leftovers. A perfect matching exists iff the nonzero
// pattern is structurally nonsingular. On success fills
// pinv[row] = matched column (the row's new position) and returns 1.
// The device LU's per-front threshold pivoting + tol stability margin
// (reference rule src/lib.rs:587-589) still guards the numerics downstream,
// so a merely-good (not provably optimal) matching suffices.
// ---------------------------------------------------------------------------
int rt_match(i64 n, const i64* Ap, const i64* Ai, const double* Ax,
             i64* pinv) {
  i64 nnz = Ap[n];
  std::vector<double> w(nnz, 0.0);
  std::vector<i64> colof(nnz);
  for (i64 j = 0; j < n; j++) {
    double cmax = 0.0;
    for (i64 q = Ap[j]; q < Ap[j + 1]; q++)
      cmax = std::max(cmax, std::fabs(Ax[q]));
    for (i64 q = Ap[j]; q < Ap[j + 1]; q++) {
      colof[q] = j;
      w[q] = (cmax > 0.0) ? std::fabs(Ax[q]) / cmax : 0.0;
    }
  }
  std::vector<i64> order(nnz);
  for (i64 q = 0; q < nnz; q++) order[q] = q;
  std::sort(order.begin(), order.end(),
            [&](i64 a, i64 b) { return w[a] > w[b]; });
  std::vector<i64> mrow(n, -1), mcol(n, -1);  // row->col, col->row
  for (i64 k = 0; k < nnz; k++) {
    i64 q = order[k];
    if (w[q] == 0.0) break;  // numeric zeros are structural for matching
    i64 i = Ai[q], j = colof[q];
    if (mrow[i] < 0 && mcol[j] < 0) { mrow[i] = j; mcol[j] = i; }
  }
  // per-column entry order by descending weight (for augmentation quality)
  std::vector<i64> eorder(nnz);
  {
    std::vector<i64> cur(n);
    for (i64 j = 0; j < n; j++) cur[j] = Ap[j];
    for (i64 k = 0; k < nnz; k++) {
      i64 q = order[k];
      eorder[cur[colof[q]]++] = q;
    }
  }
  std::vector<i64> visited(n, -1), stack_j(n), stack_p(n), row_from(n, -1);
  for (i64 j0 = 0; j0 < n; j0++) {
    if (mcol[j0] >= 0) continue;
    // iterative alternating-path DFS from column j0; tree edges are
    // column->row (a nonzero entry) and row->its matched column. Matches
    // flip only on success (commit-on-augment).
    i64 top = 0;
    stack_j[0] = j0;
    stack_p[0] = Ap[j0];
    i64 end_row = -1;
    while (top >= 0 && end_row < 0) {
      i64 j = stack_j[top];
      i64 q = stack_p[top];
      bool descended = false;
      for (; q < Ap[j + 1]; q++) {
        i64 e = eorder[q];
        if (w[e] == 0.0) continue;
        i64 i = Ai[e];
        if (visited[i] == j0) continue;
        visited[i] = j0;
        row_from[i] = j;
        if (mrow[i] < 0) {
          end_row = i;  // augmenting path found
          break;
        }
        stack_p[top] = q + 1;
        ++top;
        stack_j[top] = mrow[i];
        stack_p[top] = Ap[mrow[i]];
        descended = true;
        break;
      }
      if (end_row >= 0 || descended) continue;
      --top;  // column exhausted
    }
    if (end_row < 0) return 0;  // structurally singular (on nonzero values)
    // augment: flip entry edges along the path back to j0
    i64 i = end_row;
    while (true) {
      i64 j = row_from[i];
      i64 prev = mcol[j];
      mrow[i] = j;
      mcol[j] = i;
      if (j == j0) break;
      i = prev;
    }
  }
  for (i64 i = 0; i < n; i++) {
    if (mrow[i] < 0) return 0;
    pinv[i] = mrow[i];
  }
  return 1;
}

}  // extern "C"
