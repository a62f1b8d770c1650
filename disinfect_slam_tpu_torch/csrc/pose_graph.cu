// pose_graph_solve: one Gauss-Newton iteration of the loop closure's pose
// graph as one launch: the damped normal equations assembled from the
// edges and solved in float64 by LU with partial pivoting; the fused entry
// computes the edges' residuals and Jacobians in the same launch first.
//
// Replaces no TPU kernel: its counterpart is the body of the JAX
// `optimize_pose_graph` scan (disinfect_slam_tpu/systems/loop_closure.py:243,
// XLA ops inside jax.jit and lax.scan, no Pallas).  The port's plain
// version of this step (ops/cuda/pose_graph_kernel.py) is ~7000 small eager
// ops an iteration at the soak's 32 nodes and ~55000 at 256 nodes.
//
// What it computes, in the plain version's order of operations, so that
// the card gives the CPU's bits:
//   - (fused entry) each edge's residual r = se3_log(Z^-1 inv(T_i) T_j) w and
//     its 6x6 Jacobians against the two nodes, as torch's forward mode
//     computes them at xi = 0 (pose_graph_kernel.edge_jacobians_reference:
//     float32 primal and tangent, op by op, the polynomials in float64);
//   - each edge's six blocks: J_a^T J_a, J_a^T J_b, J_b^T J_a, J_b^T J_b
//     (6x6) and J_a^T r, J_b^T r (6), every entry summed over the 6
//     residual rows in index order (core/exact.mm);
//   - the blocks added into a dense [6n, 6n] H and [6n] g that start at
//     +0, the edges in order and an edge's blocks in the order (i, i),
//     (i, j), (j, i), (j, j), g_i, g_j, padded edges included;
//   - the diagonal added (node 0's gauge prior plus the damping);
//   - LU with partial pivoting on [H | g] (core/exact.solve_lu): at step k
//     the first largest |a[i][k]|, i >= k, a NaN counting as largest (as
//     torch.argmax), rows k and p swapped, l_i = a[i][k] / a[k][k] and
//     a[i][j] = a[i][j] - l_i a[k][j] (a multiply, then a subtract);
//   - back substitution column by column: x_i = rhs_i / a[i][i], then
//     rhs_r = rhs_r - a[r][i] x_i for r < i;
//   - dx = -x rounded once to float32.
// Every operation is one IEEE operation with one rounding (-fmad=false and
// the _rn intrinsics; no tensor cores), and each entry of [H | g] sees the
// plain version's operations in the plain version's order.  Only when they
// run and where the operand lives change, and the kernel leaves out only
// work that changes no bit: an edge whose Jacobians are all zero (it adds
// +-0 to entries that start at +0 and are never -0) and the division of a
// zero multiplier (the zero with the signs' xor).
//
// Blocked LU.  Entry (i, j) takes, at each step k in order, step k's row
// swap in its column and then its multiply-subtract; both depend only on
// column j and on step k's multipliers.  So the columns are dealt in
// panels of kNB to the CTAs in turn (panel b to CTA b mod G, every column
// of [H | g] in its owner's shared memory, whole), and:
//   - a panel is factored by its owner alone, one CTA barrier a pivot
//     step; rows are never moved: a row swap only relabels which physical
//     row holds a logical position (lpos), so the panel publishes, for its
//     kNB steps, each pivot's physical row, the multipliers of the rows
//     left below it (in the logical order the next panel starts from) and
//     of each pivot row before it became one;
//   - every CTA takes each of its trailing columns through the panel's kNB
//     steps at once: the pivot rows first, each the same chain of
//     multiply-subtracts it had (a triangular solve in step order), then
//     every other row, kNB multiply-subtracts in step order, loaded once;
//   - the owner of the next panel brings that panel up to date first and
//     factors it before the rest of its update (look-ahead), and releases
//     a flag in device memory; the other CTAs acquire it.  No grid barrier:
//     the chain is the m - 1 pivot steps at a CTA barrier's latency plus
//     one flag hand-over a panel.
// Blocked back substitution.  Each owner also writes its factored panel
// to device memory (hg).  The CTA that holds g then solves kNB unknowns at
// a time with one warp, bottom up, while its other warps give the rows
// below the next block the block's kNB subtractions in descending i (each
// rhs_r sees the plain sequence).
//
// The launch: G CTAs of kThreads, one an SM (their columns fill the shared
// memory), launched cooperatively when G > 1 so that all are resident at
// once (the flags spin); the wrapper takes one CTA for each block of
// columns up to the card's SMs (pose_graph_kernel.grid_shape).
// Where the columns do not fit the CTAs' shared memory (above 275 nodes on
// an H100) the same kernel keeps them in hg instead (kGlobal: every
// column at its place there, read and written by its owner only, g's at
// hg + m m) and a thread holds up to kMidSlots of a panel's rows (up to
// 4096 rows) or kWideSlots (up to kWideRows): the same operations in the
// same order, each trailing column's entries from L2 or device memory
// once a panel.  At 512 nodes the panels' pivot steps and the next
// panel's update are again most of a call (PERF.md §6).
// Above kWideRows (2730 nodes) the pass layout (kPasses, which the caller
// may also force at any m) takes any m: a thread strides over a panel's
// rows, each row's logical position kept in device memory (lpos) between
// pivot steps, the rows each panel leaves read from ibuf and the
// logical-to-physical map from prow instead of shared memory, and the
// pivot's logical and physical rows in a word each (the 16-bit halves of
// the other layouts' key stop at 65536 rows).  Each entry's chain of row
// swaps and multiply-subtracts in ascending k is unchanged, so the bits
// are the other layouts' at every m.
//
// What bounds it (the timeline, `timeline=`; PERF.md §5-6): the chain.  At
// 256 nodes (m = 1536) the panels' pivot steps are ~44% of a call (~1.1 us
// a step: the CTA's reduction of the pivot, its barrier, the divisions of
// the nonzero entries below it and the update of the panel's columns), the
// next panel's update by its owner ~30% (its rows' multipliers loaded from
// L2 and applied, ~6 us a panel), the hand-over and the publishing ~13%,
// the back substitution's chain of divisions ~11%.  The float64 operations
// the data needs are a small share of that (the bound in chip_smoke.py).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;          // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 8;                 // a panel's columns
constexpr int kMaxSlots = 4;           // panel rows a thread holds, the columns in shared memory
constexpr int kMidSlots = 8;           // the same, the columns in device memory, up to 4096 rows
constexpr int kWideSlots = 32;         // the same above (its arrays spill: ~1.4x slower)
constexpr int kWideRows = kThreads * kWideSlots;  // the largest m of the register layouts
constexpr int kSmemLimit = 232448;     // a CTA's shared memory on the H100
constexpr int kBlockVals = 156;        // an edge's entries: 4 blocks of 36, J_a^T r, J_b^T r
constexpr int kEdgeChunk = 256;        // edges staged in shared memory at a time

struct Args {
  double* ja;          // [E, 6, 6]: d residual_r / d xi_c of node i, [r][c]
  double* jb;          // [E, 6, 6]: the same of node j
  double* rd;          // [E, 6]: the residuals
  double* gv;          // [E][kBlockVals] each edge's block entries
  int* eflag;          // [E] 1: its Jacobians are all zero, 2: and its residual finite
  const int* ei;       // [E] edge source node
  const int* ej;       // [E] edge target node
  const double* diag;  // [m] added to H's diagonal
  const float* poses;  // fused: [n, 4, 4] the nodes' poses
  const float* zinv;   // fused: [E, 4, 4] the measurements' inverses
  const float* w;      // fused: [E] the edge weights
  float* dx;           // [m] out: -x, rounded to float32
  double* hg;          // [m + 1][m] the factored columns (column j at hg + j m; g's at hg + m m)
  double* lbuf;        // [rows][kNB] each panel's multipliers of the rows left below it
  int* ibuf;           // [rows] their physical rows, in logical order
  double* lpiv;        // [m][kNB] a pivot row's multipliers before it became one
  int* prow;           // [m] the physical row at each logical position
  int* lpos;           // pass layout: [m] each row of the panel's logical position
  unsigned* flags;     // [panels + 2], zeroed: panel b published; the Jacobians' count; the CTAs done
  unsigned long long* tl;  // null, or [8 + 4 panels] the timeline (see MARK)
  int e, m, fused;
};

__host__ __device__ inline int panels(int m) { return (m + kNB - 1) / kNB; }
// the columns of block b (panels, then g's block of one column)
__host__ __device__ inline int width(int b, int m) {
  return b < panels(m) ? (m - b * kNB < kNB ? m - b * kNB : kNB) : 1;
}
__host__ __device__ inline int col0(int b, int m) { return b < panels(m) ? b * kNB : m; }
// The blocks (the panels, then g's) are dealt to the CTAs in turn: block b
// to CTA b mod G, at local index b / G.
__host__ __device__ inline int owner(int b, int ctas) { return b % ctas; }
__host__ __device__ inline int local_of(int b, int ctas) { return b / ctas; }
__host__ __device__ inline int block_of(int lb, int c, int ctas) { return lb * ctas + c; }
// blocks a CTA holds at most
__host__ __device__ inline int local_blocks(int m, int ctas) {
  return (panels(m) + 1 + ctas - 1) / ctas;
}
// rows published by the panels before b (each full: m - (b' + 1) kNB)
__device__ __forceinline__ size_t published(int b, int m) {
  return static_cast<size_t>(b) * m - static_cast<size_t>(kNB) * b * (b + 1) / 2;
}

// Shared memory, in this order: the CTA's columns (local block lb, column
// jj at (lb kNB + jj) m; none where they live in device memory, `global`),
// the trailing update's pivot-row values U
// [kNB][lb kNB], the panels' pivot multipliers [2][kNB][kNB] (by parity),
// the back substitution's x [2][kNB], diagonal blocks [2][kNB][kNB] and the
// blocks of rows above them [2][kNB][kNB]; then 32-bit words: the
// reduction's keys [2][3][kWarps] ([2][4][kWarps] in the pass layout), the
// panels' pivot rows [2][kNB], the rows each panel leaves, in logical order
// [2][m] (the back substitution's logical-to-physical map after; none in
// the pass layout, `passes`), the staged edges [3][kEdgeChunk].
__host__ __device__ inline size_t smem_bytes(int m, int ctas, bool global, bool passes) {
  const size_t nlb = static_cast<size_t>(local_blocks(m, ctas));
  return 8 * ((global ? 0 : nlb * kNB * m) + kNB * nlb * kNB + 6 * kNB * kNB + 2 * kNB) +
         4 * ((passes ? 8 : 6) * kWarps + 2 * kNB + (passes ? 0 : 2 * static_cast<size_t>(m)) +
              3 * kEdgeChunk);
}

struct Smem {
  double* cols;
  double* u;
  double* lpiv;
  double* xs;
  double* ublk;
  double* ubel;
  unsigned* red;
  int* prow;
  int* left;
  int* rowmap;
  int* edges;
  int ucols;
};

__device__ Smem carve(unsigned char* raw, int m, int ctas, bool global, bool passes) {
  Smem s;
  const int nlb = local_blocks(m, ctas);
  double* d = reinterpret_cast<double*>(raw);
  s.cols = global ? nullptr : d;
  if (!global) d += static_cast<size_t>(nlb) * kNB * m;
  s.ucols = nlb * kNB;
  s.u = d;
  d += kNB * s.ucols;
  s.lpiv = d;
  d += 2 * kNB * kNB;
  s.xs = d;
  d += 2 * kNB;
  s.ublk = d;
  d += 2 * kNB * kNB;
  s.ubel = d;
  d += 2 * kNB * kNB;
  s.red = reinterpret_cast<unsigned*>(d);
  int* i = reinterpret_cast<int*>(s.red + (passes ? 8 : 6) * kWarps);
  s.prow = i;
  i += 2 * kNB;
  s.left = passes ? nullptr : i;
  s.rowmap = s.left;
  if (!passes) i += 2 * m;
  s.edges = i;
  return s;
}

// CTA c's local column lc (its local block lc / kNB, column lc % kNB, which
// must exist): in shared memory, or (kGlobal) at its place in hg
template <bool kGlobal>
__device__ __forceinline__ double* local_col(const Args& A, const Smem& S, int lc, int c,
                                             int ctas) {
  if (kGlobal) {
    return A.hg + static_cast<size_t>(col0(block_of(lc / kNB, c, ctas), A.m) + lc % kNB) * A.m;
  }
  return S.cols + static_cast<size_t>(lc) * A.m;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// every thread's writes before it visible to the CTAs that acquire *flag
// (the barrier orders them before thread 0's release, which is cumulative)
__device__ __forceinline__ void release(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, 1u);
}

// the same for a count that every CTA adds one to
__device__ __forceinline__ void arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// The timeline, where the caller asks for it (A.tl): 0 the launch's start,
// 1 the assembly's end (CTA 0), 2 and 3 the back substitution's start and
// end, 4 the Jacobians' end (the fused entry), 5 the edges' blocks' end,
// 6-7 unused; for panel b at 8 + 4 b: its owner's start on it (the flag of
// panel b - 1 seen), the factorization's start, its last pivot step's end,
// the flag released.
#define MARK(A, idx)                                              \
  do {                                                            \
    if ((A).tl != nullptr && threadIdx.x == 0) (A).tl[idx] = now_ns(); \
  } while (0)

// Wait until *flag reaches `want`.  The CTAs are resident together, so a
// wait ends within the factorization's time; one that lasts 5 s is a
// fault, and the kernel traps (the launch fails) instead of hanging.
__device__ __forceinline__ void acquire(const unsigned* flag, unsigned want) {
  if (threadIdx.x == 0 && ld_acquire(flag) < want) {
    const uint64_t t0 = now_ns();
    while (ld_acquire(flag) < want) {
      __nanosleep(20);
      if (now_ns() - t0 > 5000000000ull) __trap();
    }
  }
  __syncthreads();
}

// The pivot order as integers: the key of |a| (a double >= 0 orders as
// its bits, and a NaN is put above every number), then (logical row << 16
// | physical row), the lower first on equal keys: the first largest, a NaN
// counting as largest, as torch.argmax.
struct Best {
  unsigned hi, lo;  // the key's halves
  unsigned pk;      // logical << 16 | physical
};
constexpr unsigned kNone = 0xffffffffu;  // no row
constexpr Best kNoBest{0u, 0u, kNone};

__device__ __forceinline__ Best key(double a, int logical, int physical) {
  const double v = fabs(a);
  const unsigned long long k =
      isnan(v) ? ~0ull : static_cast<unsigned long long>(__double_as_longlong(v));
  return Best{static_cast<unsigned>(k >> 32), static_cast<unsigned>(k),
              (static_cast<unsigned>(logical) << 16) | static_cast<unsigned>(physical)};
}

__device__ __forceinline__ void take(Best& b, const Best& o) {
  if (o.hi > b.hi || (o.hi == b.hi && (o.lo > b.lo || (o.lo == b.lo && o.pk < b.pk)))) b = o;
}

__device__ __forceinline__ Best warp_best(const Best& b) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, b.hi);
  const unsigned lo = __reduce_max_sync(0xffffffffu, b.hi == hi ? b.lo : 0u);
  const unsigned pk = __reduce_min_sync(0xffffffffu, b.hi == hi && b.lo == lo ? b.pk : kNone);
  return Best{hi, lo, pk};
}

// The CTA's best of every thread's b: one barrier (the scratch is
// double-buffered by `par`, so the next call needs none before it).
__device__ __forceinline__ Best cta_best(Best b, const Smem& S, int par) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned* red = S.red + par * 3 * kWarps;
  b = warp_best(b);
  if (lane == 0) {
    red[warp] = b.hi;
    red[kWarps + warp] = b.lo;
    red[2 * kWarps + warp] = b.pk;
  }
  __syncthreads();
  Best o = kNoBest;
  if (lane < kWarps) o = Best{red[lane], red[kWarps + lane], red[2 * kWarps + lane]};
  return warp_best(o);
}

// The pass layout's pivot order: the same key, then the logical row, the
// lower first, and the physical row beside it, each in a word of its own.
struct BestW {
  unsigned hi, lo;  // the key's halves
  unsigned lg, ph;  // logical row, physical row
};
constexpr BestW kNoBestW{0u, 0u, kNone, kNone};

__device__ __forceinline__ BestW key_w(double a, int logical, int physical) {
  const Best k = key(a, 0, 0);
  return BestW{k.hi, k.lo, static_cast<unsigned>(logical), static_cast<unsigned>(physical)};
}

__device__ __forceinline__ void take(BestW& b, const BestW& o) {
  if (o.hi > b.hi || (o.hi == b.hi && (o.lo > b.lo || (o.lo == b.lo && o.lg < b.lg)))) b = o;
}

__device__ __forceinline__ BestW warp_best(const BestW& b) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, b.hi);
  const unsigned lo = __reduce_max_sync(0xffffffffu, b.hi == hi ? b.lo : 0u);
  const bool top = b.hi == hi && b.lo == lo;
  const unsigned lg = __reduce_min_sync(0xffffffffu, top ? b.lg : kNone);
  const unsigned ph = __reduce_min_sync(0xffffffffu, top && b.lg == lg ? b.ph : kNone);
  return BestW{hi, lo, lg, ph};
}

__device__ __forceinline__ BestW cta_best(BestW b, const Smem& S, int par) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned* red = S.red + par * 4 * kWarps;
  b = warp_best(b);
  if (lane == 0) {
    red[warp] = b.hi;
    red[kWarps + warp] = b.lo;
    red[2 * kWarps + warp] = b.lg;
    red[3 * kWarps + warp] = b.ph;
  }
  __syncthreads();
  BestW o = kNoBestW;
  if (lane < kWarps) {
    o = BestW{red[lane], red[kWarps + lane], red[2 * kWarps + lane], red[3 * kWarps + lane]};
  }
  return warp_best(o);
}

// A pivot step's multiplier a / d: a division unless a is +-0 and d finite
// and nonzero, where IEEE division gives the zero with the signs' xor.  The
// pose graph's H is sparse: most multipliers are zero, and their divisions
// were most of a pivot step at 128-256 nodes (PERF.md §6).
__device__ __forceinline__ double quotient(double a, double d) {
  if (a == 0.0 && d != 0.0 && isfinite(d)) return signbit(a) != signbit(d) ? -0.0 : 0.0;
  return __ddiv_rn(a, d);
}

// Factor panel b (its columns at blk, in this CTA's shared memory or in hg,
// already through every earlier panel), then publish it and release
// flags[b].  A thread holds the panel's rows t + q kThreads, q < kSlots.
// The panel's rows in logical order are panel b - 1's rows left
// (S.left[(b - 1) & 1], from its factorization in this CTA or from the
// update that brought this panel up to date).  Its own rows left, pivot
// rows and pivot multipliers also stay in shared memory (parity b & 1)
// for this CTA's own updates with it.
template <bool kGlobal, int kSlots>
__device__ void factor_panel(const Args& A, const Smem& S, int b, double* blk) {
  const int m = A.m, t = threadIdx.x;
  const int k0 = b * kNB, nbw = width(b, m), rows = m - k0;
  const int* act = S.left + ((b - 1) & 1) * m;
  // the slots after the last row are skipped (the wide layout's are mostly empty)
  const auto past = [&](int q) { return kSlots > kMaxSlots && t + q * kThreads >= rows; };
  int arow[kSlots], lpos[kSlots];
  MARK(A, 8 + 4 * b + 1);
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int s = t + q * kThreads;
    arow[q] = s < rows ? (b == 0 ? s : act[s]) : -1;
    lpos[q] = k0 + s;
  }
  // step kk's candidates: the rows left (lpos >= k) in column kk
  Best best = kNoBest;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (past(q)) break;
    if (arow[q] >= 0) take(best, key(blk[arow[q]], lpos[q], arow[q]));
  }
  for (int kk = 0; kk < nbw; ++kk) {
    const int k = k0 + kk;
    double* colk = blk + static_cast<size_t>(kk) * m;
    best = cta_best(best, S, kk & 1);
    const int p = static_cast<int>(best.pk >> 16), pr = static_cast<int>(best.pk & 0xffffu);
    const double akk = colk[pr];
    // the multipliers and column kk + 1 first, then the next step's
    // candidates, then the panel's other columns
    double l[kSlots];
    bool upd[kSlots];
    double* next = blk + static_cast<size_t>(kk + 1) * m;
    best = kNoBest;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (past(q)) break;
      const int r = arow[q];
      upd[q] = r >= 0 && lpos[q] >= k && r != pr;
      if (r == pr) {
        lpos[q] = k;
      } else if (lpos[q] == k) {
        lpos[q] = p;
      }
      if (upd[q]) {
        l[q] = quotient(colk[r], akk);
        colk[r] = l[q];
        if (kk + 1 < nbw) {
          next[r] = __dsub_rn(next[r], __dmul_rn(l[q], next[pr]));
          take(best, key(next[r], lpos[q], r));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (past(q)) break;
      if (!upd[q]) continue;
      const int r = arow[q];
      for (int jj = kk + 2; jj < nbw; ++jj) {
        double* cj = blk + static_cast<size_t>(jj) * m;
        cj[r] = __dsub_rn(cj[r], __dmul_rn(l[q], cj[pr]));
      }
    }
  }
  MARK(A, 8 + 4 * b + 2);
  __syncthreads();
  // the rows left, in logical order: ibuf, and their multipliers step by
  // step (lbuf [kk][row], so that a warp's stores and loads coalesce)
  const size_t off = published(b, m);
  const int nrows = rows - nbw;
  double* lb = A.lbuf + off * kNB;
  int* left = S.left + (b & 1) * m;
  int* sprow = S.prow + (b & 1) * kNB;
  double* slpiv = S.lpiv + (b & 1) * kNB * kNB;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (past(q)) break;
    const int r = arow[q];
    if (r < 0) continue;
    const int pos = lpos[q] - k0;
    if (pos >= nbw) {
      A.ibuf[off + pos - nbw] = r;
      left[pos - nbw] = r;
      for (int kk = 0; kk < nbw; ++kk) {
        lb[static_cast<size_t>(kk) * nrows + pos - nbw] = blk[static_cast<size_t>(kk) * m + r];
      }
    } else {
      A.prow[k0 + pos] = r;
      sprow[pos] = r;
      for (int kk = 0; kk < pos; ++kk) {
        const double v = blk[static_cast<size_t>(kk) * m + r];
        A.lpiv[static_cast<size_t>(k0 + pos) * kNB + kk] = v;
        slpiv[pos * kNB + kk] = v;
      }
    }
  }
  release(A.flags + b);
  MARK(A, 8 + 4 * b + 3);
  // the factored columns, for the back substitution (off the chain: it
  // waits for every CTA's count); in hg already where the columns live there
  if (kGlobal) return;
  double* dst = A.hg + static_cast<size_t>(k0) * m;
  for (size_t q = t; q < static_cast<size_t>(nbw) * m; q += kThreads) dst[q] = blk[q];
}

// factor_panel in the pass layout (any m): thread t takes the panel's rows
// t + q kThreads, each row's logical position in A.lpos between steps, the
// panel's rows in logical order from ibuf (panel b - 1's rows left).  Each
// row's operations and their order are factor_panel's; a thread reads and
// writes only its own rows' positions.
__device__ void factor_panel_passes(const Args& A, const Smem& S, int b, double* blk) {
  const int m = A.m, t = threadIdx.x;
  const int k0 = b * kNB, nbw = width(b, m), rows = m - k0;
  const int* act = b == 0 ? nullptr : A.ibuf + published(b - 1, m);
  int* lp = A.lpos;
  MARK(A, 8 + 4 * b + 1);
  // step 0's candidates, the positions set
  BestW best = kNoBestW;
  for (int s = t; s < rows; s += kThreads) {
    const int r = b == 0 ? s : act[s];
    lp[s] = k0 + s;
    take(best, key_w(blk[r], k0 + s, r));
  }
  for (int kk = 0; kk < nbw; ++kk) {
    const int k = k0 + kk;
    double* colk = blk + static_cast<size_t>(kk) * m;
    double* next = blk + static_cast<size_t>(kk + 1) * m;
    best = cta_best(best, S, kk & 1);
    const int p = static_cast<int>(best.lg), pr = static_cast<int>(best.ph);
    const double akk = colk[pr];
    best = kNoBestW;
    for (int s = t; s < rows; s += kThreads) {
      const int r = b == 0 ? s : act[s];
      int pos = lp[s];
      const bool upd = pos >= k && r != pr;
      if (r == pr) {
        pos = k;
        lp[s] = pos;
      } else if (pos == k) {
        pos = p;
        lp[s] = pos;
      }
      if (!upd) continue;
      const double l = quotient(colk[r], akk);
      colk[r] = l;
      if (kk + 1 < nbw) {
        next[r] = __dsub_rn(next[r], __dmul_rn(l, next[pr]));
        take(best, key_w(next[r], pos, r));
      }
      for (int jj = kk + 2; jj < nbw; ++jj) {
        double* cj = blk + static_cast<size_t>(jj) * m;
        cj[r] = __dsub_rn(cj[r], __dmul_rn(l, cj[pr]));
      }
    }
  }
  MARK(A, 8 + 4 * b + 2);
  __syncthreads();
  // the rows left, in logical order (ibuf), and their multipliers (lbuf);
  // the pivot rows and their multipliers (prow, lpiv and shared memory)
  const size_t off = published(b, m);
  const int nrows = rows - nbw;
  double* lb = A.lbuf + off * kNB;
  int* sprow = S.prow + (b & 1) * kNB;
  double* slpiv = S.lpiv + (b & 1) * kNB * kNB;
  for (int s = t; s < rows; s += kThreads) {
    const int r = b == 0 ? s : act[s];
    const int pos = lp[s] - k0;
    if (pos >= nbw) {
      A.ibuf[off + pos - nbw] = r;
      for (int kk = 0; kk < nbw; ++kk) {
        lb[static_cast<size_t>(kk) * nrows + pos - nbw] = blk[static_cast<size_t>(kk) * m + r];
      }
    } else {
      A.prow[k0 + pos] = r;
      sprow[pos] = r;
      for (int kk = 0; kk < pos; ++kk) {
        const double v = blk[static_cast<size_t>(kk) * m + r];
        A.lpiv[static_cast<size_t>(k0 + pos) * kNB + kk] = v;
        slpiv[pos * kNB + kk] = v;
      }
    }
  }
  release(A.flags + b);
  MARK(A, 8 + 4 * b + 3);
}

// The CTA's local blocks [lb0, lb1) through panel b's steps: its pivot
// rows and multipliers in S.prow / S.lpiv (parity b & 1), its rows left
// and their multipliers from this CTA's shared memory where it factored
// the panel, else from device memory (plain loads: written before the
// panel's flag, which this CTA acquired), and then kept in S.left for the
// next panel's factorization.
template <bool kGlobal, bool kPasses>
__device__ void update(const Args& A, const Smem& S, int b, int lb0, int lb1, int ctas) {
  const int m = A.m, t = threadIdx.x, c = blockIdx.x;
  const int k0 = b * kNB, nbw = width(b, m), nrows = m - k0 - nbw;
  const int ncols = (lb1 - lb0) * kNB;
  if (ncols <= 0) return;
  auto column = [&](int ci) -> double* {
    const int lb = lb0 + ci / kNB, jj = ci % kNB;
    return jj < width(block_of(lb, c, ctas), m) ? local_col<kGlobal>(A, S, lb * kNB + jj, c, ctas)
                                                : nullptr;
  };
  const int* sprow = S.prow + (b & 1) * kNB;
  const double* slpiv = S.lpiv + (b & 1) * kNB * kNB;
  int* left = kPasses ? nullptr : S.left + (b & 1) * m;
  // the pivot rows, one thread a column: each the chain of multiply-
  // subtracts it took before it became the pivot, in step order
  for (int ci = t; ci < ncols; ci += kThreads) {
    double* col = column(ci);
    if (col == nullptr) continue;
    double u[kNB];
#pragma unroll
    for (int kk = 0; kk < kNB; ++kk) {
      if (kk >= nbw) break;
      const int pr = sprow[kk];
      double x = col[pr];
#pragma unroll
      for (int q = 0; q < kk; ++q) x = __dsub_rn(x, __dmul_rn(slpiv[kk * kNB + q], u[q]));
      u[kk] = x;
      S.u[kk * S.ucols + ci] = x;
      col[pr] = x;
    }
  }
  __syncthreads();
  // every other row: kNB multiply-subtracts in step order; work items
  // (row, group of columns), as many groups as keep the CTA's threads busy
  const bool local = owner(b, ctas) == c;
  const double* own = kGlobal ? A.hg + static_cast<size_t>(k0) * m
                              : S.cols + static_cast<size_t>(local_of(b, ctas)) * kNB * m;
  const size_t off = published(b, m);
  const double* lbase = A.lbuf + off * kNB;
  const int per = max(1, min(ncols, ncols * nrows / (2 * kThreads)));
  const int groups = (ncols + per - 1) / per;
  for (int w = t; w < nrows * groups; w += kThreads) {
    const int q = w % nrows, g = w / nrows;
    double l[kNB];
    int r;
    if (kPasses) {
      r = A.ibuf[off + q];
#pragma unroll
      for (int kk = 0; kk < kNB; ++kk) l[kk] = kk < nbw ? lbase[static_cast<size_t>(kk) * nrows + q] : 0.0;
    } else if (local) {
      r = left[q];
#pragma unroll
      for (int kk = 0; kk < kNB; ++kk) l[kk] = kk < nbw ? own[static_cast<size_t>(kk) * m + r] : 0.0;
    } else {
      r = A.ibuf[off + q];
      if (g == 0) left[q] = r;
#pragma unroll
      for (int kk = 0; kk < kNB; ++kk) l[kk] = kk < nbw ? lbase[static_cast<size_t>(kk) * nrows + q] : 0.0;
    }
    for (int ci = g * per; ci < min(ncols, (g + 1) * per); ++ci) {
      double* col = column(ci);
      if (col == nullptr) continue;
      double x = col[r];
#pragma unroll
      for (int kk = 0; kk < kNB; ++kk) {
        if (kk < nbw) x = __dsub_rn(x, __dmul_rn(l[kk], S.u[kk * S.ucols + ci]));
      }
      col[r] = x;
    }
  }
  __syncthreads();
}

// ---- the edges' residuals and Jacobians (the fused entry) ----
//
// pose_graph_kernel.edge_jacobians_reference line by line, one thread an
// (edge, tangent direction): F and D are its Dual at one element, float32
// and float64 (h false where the operand has no tangent), and each
// operation below is the Dual operation of the same name.

constexpr int kSinTerms = 15;   // core/exact.SIN_TERMS
constexpr int kAtanTerms = 21;  // core/exact.ATAN_TERMS
constexpr double kTwoPi = 0x1.921fb54442d18p+2;
constexpr double kInvTwoPi = 0x1.45f306dc9c883p-3;
constexpr double kTanPi8 = 0x1.a827999fcef32p-2;
constexpr double kPi = 0x1.921fb54442d18p+1;
constexpr double kPi2 = 0x1.921fb54442d18p+0;
constexpr double kPi4 = 0x1.921fb54442d18p-1;
constexpr float kSixth = 0x1.555556p-3f;    // float32(1 / 6)
constexpr float kTwelfth = 0x1.555556p-4f;  // float32(1 / 12)

// 1/n! for n = 0..30, correctly rounded (core/exact.INV_FACT's values)
__constant__ double kInvFact[2 * kSinTerms + 1] = {
    0x1.0000000000000p+0,  0x1.0000000000000p+0,  0x1.0000000000000p-1,
    0x1.5555555555555p-3,  0x1.5555555555555p-5,  0x1.1111111111111p-7,
    0x1.6c16c16c16c17p-10, 0x1.a01a01a01a01ap-13, 0x1.a01a01a01a01ap-16,
    0x1.71de3a556c734p-19, 0x1.27e4fb7789f5cp-22, 0x1.ae64567f544e4p-26,
    0x1.1eed8eff8d898p-29, 0x1.6124613a86d09p-33, 0x1.93974a8c07c9dp-37,
    0x1.ae7f3e733b81fp-41, 0x1.ae7f3e733b81fp-45, 0x1.952c77030ad4ap-49,
    0x1.6827863b97d97p-53, 0x1.2f49b46814157p-57, 0x1.e542ba4020225p-62,
    0x1.71b8ef6dcf572p-66, 0x1.0ce396db7f853p-70, 0x1.761b413163819p-75,
    0x1.f2cf01972f578p-80, 0x1.3f3ccdd165fa9p-84, 0x1.88e85fc6a4e59p-89,
    0x1.d1ab1c2dccea3p-94, 0x1.0a18a2635085dp-98, 0x1.259f98b4358aep-103,
    0x1.3932c5047d60ep-108,
};

struct F {
  float p, t;
  bool h;
};
struct D {
  double p, t;
  bool h;
};

// the Dual operations for one element type (ADD ... the _rn intrinsics)
#define DUAL_OPS(T, S, ADD, SUB, MUL, DIV)                                                   \
  __device__ __forceinline__ T cst(S x) { return T{x, S(0), false}; }                        \
  __device__ __forceinline__ T add(T a, T b) {                                               \
    return T{ADD(a.p, b.p), a.h && b.h ? ADD(a.t, b.t) : (a.h ? a.t : b.t), a.h || b.h};     \
  }                                                                                          \
  __device__ __forceinline__ T sub(T a, T b) {                                               \
    return T{SUB(a.p, b.p), a.h && b.h ? SUB(a.t, b.t) : (a.h ? a.t : MUL(b.t, S(-1))),      \
             a.h || b.h};                                                                    \
  }                                                                                          \
  /* a number less a: rsub, the tangent negated */                                          \
  __device__ __forceinline__ T rsub(S x, T a) { return T{SUB(x, a.p), -a.t, a.h}; }          \
  __device__ __forceinline__ T neg(T a) { return T{-a.p, -a.t, a.h}; }                       \
  __device__ __forceinline__ T mul(T a, T b) {                                               \
    const S t = a.h && b.h ? ADD(MUL(b.t, a.p), MUL(a.t, b.p))                               \
                           : (a.h ? MUL(a.t, b.p) : MUL(b.t, a.p));                          \
    return T{MUL(a.p, b.p), t, a.h || b.h};                                                  \
  }                                                                                          \
  __device__ __forceinline__ T div(T a, T b) {                                               \
    const S r = DIV(a.p, b.p);                                                               \
    const S t = a.h && b.h ? DIV(SUB(a.t, MUL(b.t, r)), b.p)                                 \
                           : (a.h ? DIV(a.t, b.p) : DIV(MUL(MUL(b.t, r), S(-1)), b.p));      \
    return T{r, t, a.h || b.h};                                                              \
  }                                                                                          \
  /* torch.where: a missing tangent selected as +0 */                                       \
  __device__ __forceinline__ T where(bool c, T a, T b) {                                     \
    return T{c ? a.p : b.p, c ? (a.h ? a.t : S(0)) : (b.h ? b.t : S(0)), a.h || b.h};        \
  }

DUAL_OPS(F, float, __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn)
DUAL_OPS(D, double, __dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn)
#undef DUAL_OPS

// an element of a stack or cat whose parts have tangents (h): +0 if it has none
__device__ __forceinline__ F joined(F a, bool h) { return F{a.p, a.h ? a.t : 0.f, a.h || h}; }

__device__ __forceinline__ D to_d(F a) { return D{a.p, a.t, a.h}; }
__device__ __forceinline__ F to_f(D a) {
  return F{__double2float_rn(a.p), __double2float_rn(a.t), a.h};
}

__device__ __forceinline__ D dsqrt(D a) {
  const double r = __dsqrt_rn(a.p);
  return D{r, __ddiv_rn(a.t, __dmul_rn(2.0, r)), a.h};
}

__device__ __forceinline__ F sqrt_rn(F a) { return to_f(dsqrt(to_d(a))); }

__device__ __forceinline__ D dabs(D a) {
  const double sgn = a.p > 0.0 ? 1.0 : (a.p < 0.0 ? -1.0 : 0.0);
  return D{fabs(a.p), __dmul_rn(a.t, sgn), a.h};
}

__device__ __forceinline__ F as_f(F a) { return a; }
__device__ __forceinline__ F as_f(float a) { return cst(a); }

// core/exact.mm: o = a @ b, each entry summed in index order
template <int N, int K, int M, typename A, typename B>
__device__ __forceinline__ void mm(const A (&a)[N][K], const B (&b)[K][M], F (&o)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      F x = mul(as_f(a[i][0]), as_f(b[0][j]));
#pragma unroll
      for (int k = 1; k < K; ++k) x = add(x, mul(as_f(a[i][k]), as_f(b[k][j])));
      o[i][j] = x;
    }
  }
}

__device__ __forceinline__ F sq3(const F (&v)[3]) {
  return add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
}

__device__ __forceinline__ void skew(const F (&k)[3], F (&o)[3][3]) {
  const F z = cst(0.f);
  const bool h = k[0].h || k[1].h || k[2].h;
  const F e[3][3] = {{z, neg(k[2]), k[1]}, {k[2], z, neg(k[0])}, {neg(k[1]), k[0], z}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i][j] = joined(e[i][j], h);
}

// [r | t] over the row (0, 0, 0, 1)
__device__ __forceinline__ void rigid(const F (&r)[3][3], const F (&t)[3], F (&o)[4][4]) {
  bool h = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h = h || t[i].h;
#pragma unroll
    for (int j = 0; j < 3; ++j) h = h || r[i][j].h;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i][j] = joined(r[i][j], h);
    o[i][3] = joined(t[i], h);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) o[3][j] = joined(cst(j == 3 ? 1.f : 0.f), h);
}

__device__ void exp_se3_small(const F (&xi)[6], F (&o)[4][4]) {
  const F om[3] = {xi[0], xi[1], xi[2]};
  const F v[3][1] = {{xi[3]}, {xi[4]}, {xi[5]}};
  const F t2 = sq3(om);
  F ox[3][3], ox2[3][3], r[3][3], q[3][3], t[3][1];
  skew(om, ox);
  const F a = rsub(1.f, div(t2, cst(6.f)));
  const F b = rsub(0.5f, div(t2, cst(24.f)));
  const F cc = rsub(kSixth, div(t2, cst(120.f)));
  mm(ox, ox, ox2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const F eye = cst(i == j ? 1.f : 0.f);
      r[i][j] = add(add(eye, mul(a, ox[i][j])), mul(b, ox2[i][j]));
      q[i][j] = add(add(eye, mul(b, ox[i][j])), mul(cc, ox2[i][j]));
    }
  }
  mm(q, v, t);
  const F tv[3] = {t[0][0], t[1][0], t[2][0]};
  rigid(r, tv, o);
}

__device__ void inv_rigid(const F (&m)[4][4], F (&o)[4][4]) {
  F rt[3][3], nt[3][1], t[3][1];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rt[i][j] = m[j][i];
    nt[i][0] = neg(m[i][3]);
  }
  mm(rt, nt, t);
  const F tv[3] = {t[0][0], t[1][0], t[2][0]};
  rigid(rt, tv, o);
}

__device__ void dsincos(D theta, D* s_out, D* c_out) {
  D k = mul(theta, cst(kInvTwoPi));
  k = D{rint(k.p), 0.0, k.h};  // round: a zero tangent
  const D t = sub(theta, mul(k, cst(kTwoPi)));
  const D t2 = mul(t, t);
  D s = cst(kInvFact[2 * kSinTerms - 1]);  // (-1)^14 / 29!
  D c = cst(-kInvFact[2 * kSinTerms]);     // (-1)^15 / 30!
  for (int m = kSinTerms - 2; m >= 0; --m) {
    s = add(cst((m & 1) ? -kInvFact[2 * m + 1] : kInvFact[2 * m + 1]), mul(t2, s));
  }
  for (int m = kSinTerms - 1; m >= 0; --m) {
    c = add(cst((m & 1) ? -kInvFact[2 * m] : kInvFact[2 * m]), mul(t2, c));
  }
  *s_out = mul(t, s);
  *c_out = c;
}

__device__ D datan2(D y, D x) {
  const D ax = dabs(x), ay = dabs(y);
  const bool swap = ay.p > ax.p;
  const D num = where(swap, ax, ay);
  const D den = where(swap, ay, ax);
  const D z = div(num, where(den.p == 0.0, cst(1.0), den));
  const bool big = z.p > kTanPi8;
  const D zr = where(big, div(sub(z, cst(1.0)), add(z, cst(1.0))), z);
  const D z2 = mul(zr, zr);
  D p = cst(__ddiv_rn((kAtanTerms - 1) & 1 ? -1.0 : 1.0, 2.0 * kAtanTerms - 1.0));
  for (int k = kAtanTerms - 2; k >= 0; --k) {
    p = add(cst(__ddiv_rn(k & 1 ? -1.0 : 1.0, 2.0 * k + 1.0)), mul(z2, p));
  }
  D a = mul(zr, p);
  a = where(big, add(cst(kPi4), a), a);
  a = where(swap, rsub(kPi2, a), a);
  a = where(x.p < 0.0, rsub(kPi, a), a);
  return where(y.p < 0.0, neg(a), a);
}

__device__ void so3_log(const F (&r)[3][3], F (&o)[3]) {
  F vee[3] = {sub(r[2][1], r[1][2]), sub(r[0][2], r[2][0]), sub(r[1][0], r[0][1])};
  const bool hv = vee[0].h || vee[1].h || vee[2].h;
#pragma unroll
  for (int i = 0; i < 3; ++i) vee[i] = joined(vee[i], hv);
  const F trace = add(add(r[0][0], r[1][1]), r[2][2]);
  const F u = mul(sub(trace, cst(1.f)), cst(0.5f));
  const bool inside = u.p >= -1.f && u.p <= 1.f;
  // torch.clamp (a NaN stays), its tangent where the value is inside
  const F cos_t{u.p < -1.f ? -1.f : (u.p > 1.f ? 1.f : u.p), inside ? u.t : 0.f, u.h};
  const F s2 = sq3(vee);
  const bool small = s2.p < 4e-4f;
  const F s2_safe = where(small, cst(1.f), s2);
  const F sin_t = mul(cst(0.5f), sqrt_rn(s2_safe));
  const F theta = to_f(datan2(to_d(sin_t), to_d(cos_t)));
  const F fac = where(small, add(cst(0.5f), div(s2, cst(48.f))), div(theta, mul(cst(2.f), sin_t)));
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = mul(fac, vee[i]);
}

__device__ void se3_log(const F (&m)[4][4], F (&o)[6]) {
  const F r[3][3] = {{m[0][0], m[0][1], m[0][2]}, {m[1][0], m[1][1], m[1][2]},
                     {m[2][0], m[2][1], m[2][2]}};
  F om[3], ox[3][3], ox2[3][3], vinv[3][3], t[3][1];
  so3_log(r, om);
  const F t2 = sq3(om);
  skew(om, ox);
  const bool small = t2.p < 1e-4f;
  const F t2_safe = where(small, cst(1.f), t2);
  const F theta = sqrt_rn(t2_safe);
  D sd, cd;
  dsincos(to_d(theta), &sd, &cd);
  const F sn = to_f(sd), cs = to_f(cd);
  const F coef = where(small, add(cst(kTwelfth), div(t2, cst(720.f))),
                       div(rsub(1.f, div(mul(theta, sn), mul(cst(2.f), rsub(1.f, cs)))), t2_safe));
  mm(ox, ox, ox2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      vinv[i][j] = add(rsub(i == j ? 1.f : 0.f, mul(cst(0.5f), ox[i][j])), mul(coef, ox2[i][j]));
    }
  }
  const F mt[3][1] = {{m[0][3]}, {m[1][3]}, {m[2][3]}};
  mm(vinv, mt, t);
  const bool h = om[0].h || om[1].h || om[2].h || t[0][0].h || t[1][0].h || t[2][0].h;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = joined(om[i], h);
    o[3 + i] = joined(t[i][0], h);
  }
}

__device__ __forceinline__ void load4(const float* __restrict__ src, float (&o)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = __ldg(src + 4 * i + j);
}

// Edge k's residual's tangent in direction d (0-5: xi_i, 6-11: xi_j) and
// its primal: the column d of ja (d < 6) or jb, and for d = 0 the
// residual, as float64.
__device__ __noinline__ void edge_jacobian(const Args& A, int k, int d) {
  const int n = A.m / 6;
  int i0 = __ldg(A.ei + k), j0 = __ldg(A.ej + k);
  i0 = i0 < 0 || i0 >= n ? 0 : i0;  // outside the contract; kept in bounds
  j0 = j0 < 0 || j0 >= n ? 0 : j0;
  float ti[4][4], tj[4][4], zi[4][4];
  load4(A.poses + 16 * i0, ti);
  load4(A.poses + 16 * j0, tj);
  load4(A.zinv + 16 * k, zi);
  F xi_i[6], xi_j[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    xi_i[c] = F{0.f, d == c ? 1.f : 0.f, true};
    xi_j[c] = F{0.f, d == 6 + c ? 1.f : 0.f, true};
  }
  F ei[4][4], ej[4][4], a[4][4], b[4][4], ia[4][4], iab[4][4], mz[4][4], r[6];
  exp_se3_small(xi_i, ei);
  mm(ei, ti, a);
  exp_se3_small(xi_j, ej);
  mm(ej, tj, b);
  inv_rigid(a, ia);
  mm(ia, b, iab);
  mm(zi, iab, mz);
  se3_log(mz, r);
  const F wk = cst(__ldg(A.w + k));
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const F x = mul(r[q], wk);
    if (d < 6) {
      A.ja[36 * k + 6 * q + d] = x.t;
    } else {
      A.jb[36 * k + 6 * q + d - 6] = x.t;
    }
    if (d == 0) A.rd[6 * k + q] = x.p;
  }
}

// Every edge's Jacobians and residual, (edge, direction) items dealt over
// the grid, then every CTA's count: the assembly reads them all.
__device__ void edge_jacobians(const Args& A, int nbh) {
  const int ctas = gridDim.x;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < 12 * A.e; q += ctas * kThreads) {
    edge_jacobian(A, q / 12, q % 12);
  }
  arrive(A.flags + nbh);
  acquire(A.flags + nbh, static_cast<unsigned>(ctas));
}

// sum_r p[r][a] q[r][b] over the 6 residual rows in index order
__device__ __forceinline__ double gram(const double* p, const double* q, int a, int b, int qstride) {
  double s = __dmul_rn(__ldcg(p + a), __ldcg(q + b));
#pragma unroll
  for (int r = 1; r < 6; ++r) s = __dadd_rn(s, __dmul_rn(__ldcg(p + 6 * r + a), __ldcg(q + qstride * r + b)));
  return s;
}

// Each edge's block entries, (edge, entry) items dealt over the grid: the
// blocks (i, i), (i, j), (j, i), (j, j) at 36 b + 6 a + c (sum_r P[r][a]
// Q[r][c]), J_a^T r at 144 + a, J_b^T r at 150 + a; and its flag: an edge
// whose Jacobians are all zero adds +-0 to every H entry, which leaves the
// entry's bits (an entry starts at +0 and is never -0), and to g as well
// where its residual is finite, so the assembly skips it.  Then every
// CTA's count (the second on the same word in the fused entry).
__device__ void edge_blocks(const Args& A, int nbh) {
  const int ctas = gridDim.x;
  const size_t total = static_cast<size_t>(A.e) * (kBlockVals + 1);
  for (size_t q = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; q < total;
       q += static_cast<size_t>(ctas) * kThreads) {
    const int k = static_cast<int>(q / (kBlockVals + 1)), v = static_cast<int>(q % (kBlockVals + 1));
    const double* ja = A.ja + 36 * k;
    const double* jb = A.jb + 36 * k;
    const double* r = A.rd + 6 * k;
    if (v < 144) {
      const int blk = v / 36, a = (v % 36) / 6, c = v % 6;
      A.gv[static_cast<size_t>(k) * kBlockVals + v] = gram(blk < 2 ? ja : jb, blk & 1 ? jb : ja, a, c, 6);
    } else if (v < kBlockVals) {
      const int gi = (v - 144) / 6, a = (v - 144) % 6;
      A.gv[static_cast<size_t>(k) * kBlockVals + v] = gram(gi ? jb : ja, r, a, 0, 1);
    } else {
      bool zero = true, finite = true;  // every load issued, no early exit
#pragma unroll
      for (int i = 0; i < 36; ++i) zero &= (__ldcg(ja + i) == 0.0) & (__ldcg(jb + i) == 0.0);
#pragma unroll
      for (int i = 0; i < 6; ++i) finite &= isfinite(__ldcg(r + i));
      A.eflag[k] = (zero ? 1 : 0) | (zero && finite ? 2 : 0);
    }
  }
  arrive(A.flags + nbh);
  acquire(A.flags + nbh, static_cast<unsigned>(ctas * (A.fused ? 2 : 1)));
}

// H's and g's columns this CTA holds, from +0, edge by edge (the edges
// staged in shared memory kEdgeChunk at a time), then the diagonal.  Work
// items: (H column, a) takes the column's rows 6 X + a; (X, a) takes g's
// row 6 X + a.
template <bool kGlobal>
__device__ void assemble(const Args& A, const Smem& S, int nlb, int ctas) {
  const int m = A.m, n = m / 6, t = threadIdx.x, c = blockIdx.x, nbh = panels(m);
  if (kGlobal) {
    for (int lc = 0; lc < nlb * kNB; ++lc) {
      if (lc % kNB >= width(block_of(lc / kNB, c, ctas), m)) continue;
      double* col = local_col<true>(A, S, lc, c, ctas);
      for (int q = t; q < m; q += kThreads) col[q] = 0.0;
    }
  } else {
    const size_t entries = static_cast<size_t>(nlb) * kNB * m;
    for (size_t q = t; q < entries; q += kThreads) S.cols[q] = 0.0;
  }
  const bool own_g = c == owner(nbh, ctas);
  double* gcol = kGlobal ? A.hg + static_cast<size_t>(m) * m
                         : S.cols + static_cast<size_t>(local_of(nbh, ctas)) * kNB * m;
  const int h_items = nlb * kNB * 6, items = h_items + (own_g ? 6 * n : 0);
  int* se_i = S.edges;
  int* se_j = S.edges + kEdgeChunk;
  int* se_f = S.edges + 2 * kEdgeChunk;
  for (int e0 = 0; e0 < A.e; e0 += kEdgeChunk) {
    const int ne = min(kEdgeChunk, A.e - e0);
    __syncthreads();
    for (int q = t; q < ne; q += kThreads) {
      se_i[q] = __ldg(A.ei + e0 + q);
      se_j[q] = __ldg(A.ej + e0 + q);
      se_f[q] = __ldcg(A.eflag + e0 + q);
    }
    __syncthreads();
    for (int wi = t; wi < items; wi += kThreads) {
      if (wi < h_items) {
        const int lc = wi / 6, a = wi % 6;
        const int bb = block_of(lc / kNB, c, ctas), jj = lc % kNB;
        if (jj >= width(bb, m) || bb >= nbh) continue;  // no column, or g's
        const int j = col0(bb, m) + jj, J = j / 6, bc = j % 6;
        double* colp = local_col<kGlobal>(A, S, lc, c, ctas);
        for (int q = 0; q < ne; ++q) {
          const int I0 = se_i[q], J0 = se_j[q];
          if (se_f[q] & 1) continue;
          if (I0 < 0 || I0 >= n || J0 < 0 || J0 >= n) continue;  // outside the contract
          if (I0 != J && J0 != J) continue;
          const double* v = A.gv + static_cast<size_t>(e0 + q) * kBlockVals + 6 * a + bc;
          if (I0 == J) colp[6 * I0 + a] = __dadd_rn(colp[6 * I0 + a], __ldcg(v));
          if (J0 == J) colp[6 * I0 + a] = __dadd_rn(colp[6 * I0 + a], __ldcg(v + 36));
          if (I0 == J) colp[6 * J0 + a] = __dadd_rn(colp[6 * J0 + a], __ldcg(v + 72));
          if (J0 == J) colp[6 * J0 + a] = __dadd_rn(colp[6 * J0 + a], __ldcg(v + 108));
        }
      } else {
        const int X = (wi - h_items) / 6, a = (wi - h_items) % 6;
        double* e = gcol + 6 * X + a;
        for (int q = 0; q < ne; ++q) {
          const int I0 = se_i[q], J0 = se_j[q];
          if (se_f[q] & 2) continue;
          if (I0 < 0 || I0 >= n || J0 < 0 || J0 >= n) continue;
          if (I0 != X && J0 != X) continue;
          const double* v = A.gv + static_cast<size_t>(e0 + q) * kBlockVals + 144 + a;
          if (I0 == X) *e = __dadd_rn(*e, __ldcg(v));
          if (J0 == X) *e = __dadd_rn(*e, __ldcg(v + 6));
        }
      }
    }
  }
  __syncthreads();
  for (int lc = t; lc < nlb * kNB; lc += kThreads) {
    const int bb = block_of(lc / kNB, c, ctas), jj = lc % kNB;
    if (bb > nbh || jj >= width(bb, m)) continue;
    const int j = col0(bb, m) + jj;
    if (j < m) {
      double* e = local_col<kGlobal>(A, S, lc, c, ctas) + j;
      *e = __dadd_rn(*e, __ldg(A.diag + j));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// The back substitution, by the CTA that holds g (its column at rhs), a
// block of kNB unknowns at a time, bottom up, in two roles joined by two
// named barriers.  Warp 0 is the chain: it solves block b (lane j holds
// rhs of row k0 + j; every lane divides alike), hands the x on (barrier
// 1), waits until the other warps have given block b + 1's subtractions to
// the rows below its own (barrier 2), and gives block b - 1's rows block
// b's; the U blocks it reads are loaded a block ahead.  The other warps
// give every row below block b - 1 block b's subtractions, kMaxSlots rows
// a thread at a time, the first rows' U values loaded while warp 0 solves.
// Each rhs_r sees the plain descending i.
template <bool kPasses>
__device__ void back_substitute(const Args& A, const Smem& S, double* rhs) {
  const int m = A.m, t = threadIdx.x, lane = t % 32, nbh = panels(m);
  // the logical-to-physical map: prow itself in the pass layout
  const int* rowmap = kPasses ? A.prow : S.rowmap;
  if (!kPasses) {
    for (int i = t; i < m; i += kThreads) S.rowmap[i] = A.prow[i];
  }
  __syncthreads();
  if (t < 32) {
    // block b's diagonal block, [i][j] = a(k0 + j, k0 + i) for j <= i, and
    // the block of the kNB rows above it, [i][j] = a(k0 - kNB + j, k0 + i)
    double d[2], e[2];
    auto fetch = [&](int b) {
      const int k0 = b * kNB, nbw = width(b, m);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = lane + 32 * h, i = q / kNB, j = q % kNB;
        const double* col = A.hg + static_cast<size_t>(k0 + i) * m;
        d[h] = i < nbw && j <= i ? col[rowmap[k0 + j]] : 0.0;
        e[h] = b > 0 && i < nbw ? col[rowmap[k0 - kNB + j]] : 0.0;
      }
    };
    auto keep_fetched = [&](int b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        S.ublk[(b & 1) * kNB * kNB + lane + 32 * h] = d[h];
        S.ubel[(b & 1) * kNB * kNB + lane + 32 * h] = e[h];
      }
    };
    fetch(nbh - 1);
    keep_fetched(nbh - 1);
    __syncwarp();
    for (int b = nbh - 1; b >= 0; --b) {
      const int k0 = b * kNB, nbw = width(b, m);
      if (b > 0) fetch(b - 1);
      const double* ub = S.ublk + (b & 1) * kNB * kNB;
      const double* ue = S.ubel + (b & 1) * kNB * kNB;
      double rv = lane < nbw ? rhs[rowmap[k0 + lane]] : 0.0;
      double x[kNB];
#pragma unroll
      for (int i = kNB - 1; i >= 0; --i) {
        if (i >= nbw) continue;
        x[i] = __ddiv_rn(__shfl_sync(0xffffffffu, rv, i), ub[i * kNB + i]);
        if (lane == 0) {
          S.xs[(b & 1) * kNB + i] = x[i];
          A.dx[k0 + i] = -__double2float_rn(x[i]);
        }
        if (lane < i) {
          rv = __dsub_rn(rv, __dmul_rn(ub[i * kNB + lane], x[i]));
        }
      }
      bar_arrive(1);
      if (b < nbh - 1) bar_sync(2);
      if (b > 0 && lane < kNB) {
        const int pr = rowmap[k0 - kNB + lane];
        double v = rhs[pr];
#pragma unroll
        for (int i = kNB - 1; i >= 0; --i) {
          if (i < nbw) v = __dsub_rn(v, __dmul_rn(ue[i * kNB + lane], x[i]));
        }
        rhs[pr] = v;
      }
      if (b > 0) keep_fetched(b - 1);
      __syncwarp();
    }
  } else {
    constexpr int kUpdaters = kThreads - 32, kChunk = kUpdaters * kMaxSlots;
    for (int b = nbh - 1; b >= 0; --b) {
      const int k0 = b * kNB, nbw = width(b, m), below = k0 - kNB;
      const double* xs = S.xs + (b & 1) * kNB;
      for (int r0 = 0; r0 == 0 || r0 < below; r0 += kChunk) {
        double u[kMaxSlots][kNB];
        int pr[kMaxSlots];
#pragma unroll
        for (int q = 0; q < kMaxSlots; ++q) {
          const int r = r0 + t - 32 + q * kUpdaters;
          pr[q] = r < below ? rowmap[r] : -1;
#pragma unroll
          for (int i = 0; i < kNB; ++i) {
            u[q][i] = pr[q] >= 0 && i < nbw ? A.hg[static_cast<size_t>(k0 + i) * m + pr[q]] : 0.0;
          }
        }
        if (r0 == 0) bar_sync(1);
#pragma unroll
        for (int q = 0; q < kMaxSlots; ++q) {
          if (pr[q] < 0) continue;
          double v = rhs[pr[q]];
#pragma unroll
          for (int i = kNB - 1; i >= 0; --i) {
            if (i < nbw) v = __dsub_rn(v, __dmul_rn(u[q][i], xs[i]));
          }
          rhs[pr[q]] = v;
        }
      }
      if (b > 0) bar_arrive(2);
    }
  }
}

// kGlobal: [H | g]'s columns in hg instead of shared memory (the sizes
// whose columns do not fit), the same operations in the same order;
// kPasses: the pass layout (kGlobal too; kSlots unused).
template <bool kGlobal, int kSlots, bool kPasses>
__global__ void __launch_bounds__(kThreads, 1) pose_graph_kernel(Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ctas = gridDim.x, c = blockIdx.x, m = A.m;
  const Smem S = carve(smem_raw, m, ctas, kGlobal, kPasses);
  const auto factor = [&](int b, double* blk) {
    if constexpr (kPasses) {
      factor_panel_passes(A, S, b, blk);
    } else {
      factor_panel<kGlobal, kSlots>(A, S, b, blk);
    }
  };
  const int nbh = panels(m), nblk = nbh + 1;
  const int nlb = c < nblk ? (nblk - c + ctas - 1) / ctas : 0;  // this CTA's blocks
  // the first local block at or after block b
  auto first_local = [&](int b) { return b <= c ? 0 : (b - c + ctas - 1) / ctas; };
  auto blk = [&](int b) {
    return kGlobal ? A.hg + static_cast<size_t>(col0(b, m)) * m
                   : S.cols + static_cast<size_t>(local_of(b, ctas)) * kNB * m;
  };

  if (c == 0) MARK(A, 0);
  if (A.fused) edge_jacobians(A, nbh);
  if (c == 0) MARK(A, 4);
  edge_blocks(A, nbh);
  if (c == 0) MARK(A, 5);
  assemble<kGlobal>(A, S, nlb, ctas);
  if (c == 0) MARK(A, 1);
  if (c == owner(0, ctas)) factor(0, blk(0));
  for (int b = 0; b < nbh; ++b) {
    const bool mine = owner(b, ctas) == c;
    const bool ahead = b + 1 < nbh && owner(b + 1, ctas) == c;
    if (!mine) {
      acquire(A.flags + b, 1u);
      // the panel's pivot rows and multipliers, from its owner
      const int k0 = b * kNB, nbw = width(b, m);
      for (int q = threadIdx.x; q < kNB * kNB; q += kThreads) {
        const int kk = q / kNB, k = q % kNB;
        if (kk < nbw) {
          if (k == 0) S.prow[(b & 1) * kNB + kk] = A.prow[k0 + kk];
          if (k < kk) S.lpiv[(b & 1) * kNB * kNB + q] = A.lpiv[static_cast<size_t>(k0 + kk) * kNB + k];
        }
      }
      __syncthreads();
    }
    if (ahead) MARK(A, 8 + 4 * (b + 1));
    const int lb = first_local(b + 1);
    if (ahead) {
      // look-ahead: the next panel first, factored, then the rest
      update<kGlobal, kPasses>(A, S, b, lb, lb + 1, ctas);
      factor(b + 1, blk(b + 1));
      update<kGlobal, kPasses>(A, S, b, lb + 1, nlb, ctas);
    } else {
      update<kGlobal, kPasses>(A, S, b, lb, nlb, ctas);
    }
  }
  arrive(A.flags + nbh + 1);
  if (c == owner(nbh, ctas)) {
    acquire(A.flags + nbh + 1, static_cast<unsigned>(ctas));  // every CTA's columns in hg
    MARK(A, 2);
    back_substitute<kPasses>(A, S, blk(nbh));
    MARK(A, 3);
  }
}

// the chain probe's reduction scratch, rounded up to 16 bytes
__host__ __device__ inline size_t chain_scratch() {
  return (smem_bytes(1, 1, false, false) + 15) / 16 * 16;
}

// The order floor: the chain of the kernel's m - 1 pivot steps alone, on one
// column held by every CTA (col: m doubles): panel b's steps by its owner,
// each a column maximum over the rows left, the CTA's barrier and the
// multipliers, the panel's flag handed over where the owner changes; no
// assembly, update or back substitution.  out[c]: CTA c's last pivot row.
__global__ void __launch_bounds__(kThreads, 1) pose_graph_chain_kernel(const double* __restrict__ src,
                                                                       int m, unsigned* flags,
                                                                       int* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ctas = gridDim.x, c = blockIdx.x, t = threadIdx.x;
  Smem S = carve(smem_raw, 1, 1, false, false);  // only the reduction's scratch is used
  double* col = reinterpret_cast<double*>(smem_raw + chain_scratch());
  double* lvec = col + m;
  for (int i = t; i < m; i += kThreads) col[i] = src[i];
  __syncthreads();
  int last = -1;
  for (int b = c; b < panels(m); b += ctas) {
    if (b > 0 && ctas > 1) acquire(flags + b - 1, 1u);
    const int k0 = b * kNB;
    for (int k = k0; k < k0 + width(b, m) && k < m - 1; ++k) {
      Best best = kNoBest;
      for (int i = k + t; i < m; i += kThreads) take(best, key(col[i], i, i));
      best = cta_best(best, S, k & 1);
      const int pr = static_cast<int>(best.pk & 0xffffu);
      const double akk = col[pr];
      for (int i = k + 1 + t; i < m; i += kThreads) lvec[i] = quotient(col[i], akk);
      last = pr;
    }
    release(flags + b);
  }
  if (t == 0) out[c] = last;
}

inline size_t chain_smem(int m) { return chain_scratch() + 16 * static_cast<size_t>(m); }

template <typename Kernel>
cudaError_t launch(Kernel kernel, int ctas, size_t smem, cudaStream_t stream, void** args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemLimit);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // every CTA resident at once: the flags are spun on
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using KernelFn = void (*)(Args);

// the kernel with [H | g]'s columns in shared memory, or (global) in device
// memory, for m rows; passes: the pass layout
inline KernelFn kernel_for(int global, int m, int passes) {
  if (passes) return pose_graph_kernel<true, 1, true>;
  if (!global) return pose_graph_kernel<false, kMaxSlots, false>;
  return m <= kThreads * kMidSlots ? pose_graph_kernel<true, kMidSlots, false>
                                   : pose_graph_kernel<true, kWideSlots, false>;
}

inline size_t launch_smem(int m, int ctas, int global, int passes) {
  return smem_bytes(m, ctas, global != 0, passes != 0);
}

// whether the kernel takes m rows over `ctas` CTAs in that layout (the pass
// layout keeps the columns in device memory and takes any m)
inline bool takes(int m, int ctas, int global, int passes) {
  if (ctas < 1 || m < 1) return false;
  if (passes) {
    if (!global) return false;
  } else if (m > (global ? kWideRows : kThreads * kMaxSlots)) {
    return false;
  }
  return launch_smem(m, ctas, global, passes) <= static_cast<size_t>(kSmemLimit);
}

}  // namespace

// Whether the card holds `ctas` CTAs of the kernel at m rows at once (ok 1)
// or not (ok 0).
extern "C" int dst_pose_graph_shape(int m, int ctas, int global, int passes, int* ok) {
  *ok = 0;
  if (!takes(m, ctas, global, passes)) return static_cast<int>(cudaSuccess);
  const size_t smem = launch_smem(m, ctas, global, passes);
  const KernelFn kernel = kernel_for(global, m, passes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ok = per_sm * sms >= ctas;
  return static_cast<int>(cudaSuccess);
}

extern "C" int dst_pose_graph_solve(const double* ja, const double* jb, const double* rd,
                                    const int* ei, const int* ej, const double* diag, int e, int m,
                                    int ctas, int global, int passes, double* gv, int* eflag,
                                    double* hg, double* lbuf, int* ibuf, double* lpiv, int* prow,
                                    int* lpos, unsigned* flags, unsigned long long* tl, float* dx,
                                    void* stream) {
  if (!takes(m, ctas, global, passes) || e < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args A{const_cast<double*>(ja), const_cast<double*>(jb), const_cast<double*>(rd), gv, eflag, ei,
         ej, diag, nullptr, nullptr, nullptr, dx, hg, lbuf, ibuf, lpiv, prow, lpos, flags, tl, e, m,
         0};
  void* args[] = {&A};
  return static_cast<int>(launch(kernel_for(global, m, passes), ctas,
                                 launch_smem(m, ctas, global, passes),
                                 static_cast<cudaStream_t>(stream), args));
}

// The fused entry: the edges' residuals and Jacobians from the poses, then
// the solve; ja, jb, rd are its outputs (float64 of the float32 values).
extern "C" int dst_pose_graph_fused(const float* poses, const int* ei, const int* ej,
                                    const float* zinv, const float* w, const double* diag, int e,
                                    int m, int ctas, int global, int passes, double* ja,
                                    double* jb, double* rd, double* gv, int* eflag, double* hg,
                                    double* lbuf, int* ibuf, double* lpiv, int* prow, int* lpos,
                                    unsigned* flags, unsigned long long* tl, float* dx,
                                    void* stream) {
  if (!takes(m, ctas, global, passes) || e < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args A{ja, jb, rd, gv, eflag, ei, ej, diag, poses, zinv, w, dx, hg, lbuf, ibuf, lpiv, prow, lpos,
         flags, tl, e, m, 1};
  void* args[] = {&A};
  return static_cast<int>(launch(kernel_for(global, m, passes), ctas,
                                 launch_smem(m, ctas, global, passes),
                                 static_cast<cudaStream_t>(stream), args));
}

// The order floor's probe (see pose_graph_chain_kernel) at `ctas` CTAs;
// flags: panels(m) zeroed words.  Not on any path.
extern "C" int dst_pose_graph_chain(const double* col, int m, int ctas, unsigned* flags, int* out,
                                    void* stream) {
  if (ctas < 1 || m < 2 || chain_smem(m) > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&col, &m, &flags, &out};
  return static_cast<int>(launch(pose_graph_chain_kernel, ctas, chain_smem(m),
                                 static_cast<cudaStream_t>(stream), args));
}
