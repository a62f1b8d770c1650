// pose_graph_solve: one Gauss-Newton iteration of the loop closure's pose
// graph after its Jacobians, as one launch of one thread-block cluster:
// the damped normal equations assembled from the edges and solved in
// float64 by LU with partial pivoting.
//
// Replaces no TPU kernel: its counterpart is the body of the JAX
// `optimize_pose_graph` scan (disinfect_slam_tpu/systems/loop_closure.py:243,
// XLA ops inside jax.jit and lax.scan, no Pallas).  It was added because
// the port's plain version of this step (ops/cuda/pose_graph_kernel.py:
// pose_graph_solve_reference) is ~7000 small eager ops an iteration at the
// soak's 32 nodes (an index_add_ an edge, ~10 ops a pivot step of a
// 192-row LU) and ~55000 at 256 nodes, all on the host's clock while the
// tracker waits.
//
// What it computes, in the plain version's order of operations, so that
// the card gives the CPU's bits:
//   - each edge's six blocks: J_a^T J_a, J_a^T J_b, J_b^T J_a, J_b^T J_b
//     (6x6) and J_a^T r, J_b^T r (6), every entry summed over the 6
//     residual rows in index order, ((p0 q0 + p1 q1) + p2 q2) + ...
//     (core/exact.mm);
//   - the blocks added into a dense [6n, 6n] H and [6n] g that start at
//     +0, the edges in order and an edge's blocks in the order (i, i),
//     (i, j), (j, i), (j, j), g_i, g_j (index_add_ edge by edge), padded
//     edges included;
//   - the diagonal added (node 0's gauge prior plus the damping);
//   - LU with partial pivoting on [H | g] (core/exact.solve_lu): at step k
//     the first largest |a[i][k]|, i >= k, a NaN counting as largest (as
//     torch.argmax), rows k and p swapped, l_i = a[i][k] / a[k][k] and
//     a[i][j] = a[i][j] - l_i a[k][j] (a multiply, then a subtract);
//   - back substitution column by column: x_i = rhs_i / a[i][i], then
//     rhs_r = rhs_r - a[r][i] x_i for r < i;
//   - dx = -x rounded once to float32.
// Every operation is one IEEE operation with one rounding (the library is
// built with -fmad=false, and the arithmetic below is written with the
// _rn intrinsics), and each entry sees the plain version's operations in
// the plain version's order, so threads can split every step across
// entries.  The kernel skips only work that leaves every bit unchanged:
// it swaps and updates no column left of the pivot (those entries are
// never read again) and stores no multiplier into H.
//
// Layout: the cluster's C CTAs own the columns of [H | g] cyclically
// (column j lives in CTA j mod C, at local column j / C), each CTA's
// columns stored column-major ("the slab"), in its shared memory where
// the slab fits and in device memory otherwise (then it stays in L2:
// 18.9 MB at 256 nodes).  The wrapper chooses C and the memory from the
// size (pose_graph_kernel.cluster_shape).  A step k is:
//   - every CTA swaps rows k and p of its columns j >= k, and copies the
//     multipliers l of step k from the owner of column k;
//   - every CTA updates its columns j > k below row k; the owner of
//     column k + 1 updates that column first, then finds the next pivot
//     and writes its multipliers into its own shared memory and the pivot
//     row into every CTA's (look-ahead: the next pivot overlaps this
//     step's update), both double-buffered by the step's parity;
//   - one cluster barrier.
// The CTA that owns g then runs the back substitution, reading the other
// columns through distributed shared memory (or L2), and writes dx.
//
// What bounds it: the chain of m - 1 dependent pivot steps (m = 6n), each
// a column maximum, a cluster barrier and the update of the trailing
// [m - k, m - k] block.  At the soak's 32 nodes (m = 192) the barrier and
// the maximum dominate; at 256 nodes (m = 1536) the ~m^3 / 3 multiply-
// subtract pairs of the update (2.4 G float64 operations, which cannot be
// fused into FMAs) and their traffic between the CTAs and L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;       // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;     // the H100's largest (non-portable) cluster
constexpr int kSmemLimit = 232448;  // a CTA's shared memory on the H100
constexpr int kUnroll = 4;          // trailing-update entries a thread has in flight

struct Args {
  const double* ja;    // [E, 6, 6]: d residual_r / d xi_c of node i, [r][c]
  const double* jb;    // [E, 6, 6]: the same of node j
  const double* rd;    // [E, 6]: the residuals
  const int* ei;       // [E] edge source node
  const int* ej;       // [E] edge target node
  const double* diag;  // [m] added to H's diagonal
  float* dx;           // [m] out: -x, rounded to float32
  double* gslab;       // [C][cols][m] in device memory, or null: slabs in shared memory
  int e, m, cols;      // edges, rows of H (6 nodes), columns a CTA holds
};

// Shared memory, in this order: the slab (cols x m doubles, if it lives
// there), lvec[2][m] (the multipliers of the steps the CTA owns, by
// parity), lk[m] (step k's multipliers copied from their owner), the
// reduction's kWarps values, then its kWarps rows and the pivot rows
// piv[2] (by parity).
inline size_t smem_bytes(int m, int cols, bool shared) {
  return 8 * ((shared ? static_cast<size_t>(cols) * m : 0) + 3 * static_cast<size_t>(m) + kWarps) +
         4 * (kWarps + 2);
}

// (v1, i1) before (v2, i2) in the pivot order: larger |a| first, a NaN
// above every number, the lower row on a tie (torch.argmax's first maximum)
__device__ __forceinline__ bool better(double v1, int i1, double v2, int i2) {
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 || n2) return n1 && n2 ? i1 < i2 : n1;
  if (v1 != v2) return v1 > v2;
  return i1 < i2;
}

// sum_r p[r][a] q[r][b] over the 6 residual rows in index order
__device__ __forceinline__ double gram(const double* __restrict__ p, const double* __restrict__ q,
                                       int a, int b, int qstride) {
  double s = __dmul_rn(__ldg(p + a), __ldg(q + b));
#pragma unroll
  for (int r = 1; r < 6; ++r) s = __dadd_rn(s, __dmul_rn(__ldg(p + 6 * r + a), __ldg(q + qstride * r + b)));
  return s;
}

// The pivot of step s in column `col` (this CTA's column s, all m rows):
// the CTA's threads find the first largest |col[i]|, i >= s, write the
// multipliers l_i = col'[i] / col'[s] (col' with rows s and p swapped) for
// i > s into lvec, and the pivot row into piv[slot] of every CTA.
__device__ void pivot(const double* col, int s, int m, double* lvec, int slot, double* red_v,
                      int* red_i, int* piv, cg::cluster_group& cluster) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  double bv = -1.0;  // below every |a|
  int bi = INT_MAX;
  for (int i = s + t; i < m; i += kThreads) {
    const double v = fabs(col[i]);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const double ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? red_v[lane] : -1.0;
    bi = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const double ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) red_i[0] = bi;
  }
  __syncthreads();
  const int p = red_i[0];
  const double a_ss = col[p];  // the pivot, in row s after the swap
  for (int i = s + 1 + t; i < m; i += kThreads) {
    lvec[i] = __ddiv_rn(i == p ? col[s] : col[i], a_ss);
  }
  if (t < static_cast<int>(cluster.num_blocks())) *cluster.map_shared_rank(piv + slot, t) = p;
  __syncthreads();  // red_i is read above before the next pivot writes it
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) pose_graph_kernel(Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int m = A.m, cols = A.cols, n = m / 6;
  double* sm = reinterpret_cast<double*>(smem_raw);
  double* slab = kShared ? sm : A.gslab + static_cast<size_t>(c) * cols * m;
  double* lvec = (kShared ? sm + static_cast<size_t>(cols) * m : sm);  // [2][m]
  double* lk = lvec + 2 * m;
  double* red_v = lk + m;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* piv = red_i + kWarps;  // [2]
  // this CTA's columns j = c + C jl, jl < ncols (j <= m: column m is g)
  const int ncols = c <= m ? (m - c) / C + 1 : 0;
  auto local = [&](int j) { return slab + static_cast<size_t>(j / C) * m; };
  // the first local column at or right of global column j
  auto first_at = [&](int j) { return j <= c ? 0 : (j - c + C - 1) / C; };

  // ---- assembly: H and g from +0, edge by edge ----
  for (size_t q = t; q < static_cast<size_t>(ncols) * m; q += kThreads) slab[q] = 0.0;
  __syncthreads();
  // work item (jl, a): the entries of local column jl in rows 6 X + a
  for (int w = t; w < ncols * 6; w += kThreads) {
    const int jl = w / 6, a = w % 6;
    const int j = c + C * jl;
    double* colp = slab + static_cast<size_t>(jl) * m;
    if (j < m) {
      const int J = j / 6, b = j % 6;
      for (int k = 0; k < A.e; ++k) {
        const int I0 = __ldg(A.ei + k), J0 = __ldg(A.ej + k);
        if (I0 < 0 || I0 >= n || J0 < 0 || J0 >= n) continue;  // outside the contract
        const double* pa = A.ja + 36 * k;
        const double* pb = A.jb + 36 * k;
        if (I0 == J) colp[6 * I0 + a] = __dadd_rn(colp[6 * I0 + a], gram(pa, pa, a, b, 6));
        if (J0 == J) colp[6 * I0 + a] = __dadd_rn(colp[6 * I0 + a], gram(pa, pb, a, b, 6));
        if (I0 == J) colp[6 * J0 + a] = __dadd_rn(colp[6 * J0 + a], gram(pb, pa, a, b, 6));
        if (J0 == J) colp[6 * J0 + a] = __dadd_rn(colp[6 * J0 + a], gram(pb, pb, a, b, 6));
      }
    } else {
      for (int k = 0; k < A.e; ++k) {
        const int I0 = __ldg(A.ei + k), J0 = __ldg(A.ej + k);
        if (I0 < 0 || I0 >= n || J0 < 0 || J0 >= n) continue;
        const double* r = A.rd + 6 * k;
        colp[6 * I0 + a] = __dadd_rn(colp[6 * I0 + a], gram(A.ja + 36 * k, r, a, 0, 1));
        colp[6 * J0 + a] = __dadd_rn(colp[6 * J0 + a], gram(A.jb + 36 * k, r, a, 0, 1));
      }
    }
  }
  __syncthreads();
  for (int jl = t; jl < ncols; jl += kThreads) {
    const int j = c + C * jl;
    if (j < m) slab[static_cast<size_t>(jl) * m + j] = __dadd_rn(slab[static_cast<size_t>(jl) * m + j], __ldg(A.diag + j));
  }
  __syncthreads();
  if (c == 0 && m > 1) pivot(local(0), 0, m, lvec, 0, red_v, red_i, piv, cluster);
  cluster.sync();

  // ---- LU, one step a cluster barrier ----
  for (int k = 0; k < m - 1; ++k) {
    const int par = k & 1;
    const int owner = k % C;
    const int p = piv[par];
    const double* l = owner == c ? lvec + par * m : lk;
    if (owner != c) {
      const double* src = cluster.map_shared_rank(lvec + par * m, owner);
      for (int i = k + 1 + t; i < m; i += kThreads) lk[i] = src[i];
    }
    const int j0 = first_at(k);
    if (p != k) {
      for (int jl = j0 + t; jl < ncols; jl += kThreads) {
        double* colp = slab + static_cast<size_t>(jl) * m;
        const double v = colp[k];
        colp[k] = colp[p];
        colp[p] = v;
      }
    }
    __syncthreads();
    const int rows = m - k - 1;
    int ju = first_at(k + 1);  // the columns right of k
    const bool ahead = (k + 1) % C == c && k + 1 < m - 1;
    if (ahead) {
      // column k + 1 first, then its pivot, then the rest
      double* colp = local(k + 1);
      const double u = colp[k];
      for (int i = k + 1 + t; i < m; i += kThreads) colp[i] = __dsub_rn(colp[i], __dmul_rn(l[i], u));
      __syncthreads();
      pivot(colp, k + 1, m, lvec + (par ^ 1) * m, par ^ 1, red_v, red_i, piv, cluster);
      ++ju;
    }
    // entry q of the [ncols - ju, rows] block is (column ju + q / rows,
    // row k + 1 + q % rows); a thread takes q = t, t + kThreads, ...,
    // kUnroll at a time, every load issued before the first store (in
    // device memory the loads wait on L2, and one in flight a thread
    // would leave the update latency-bound)
    const int total = (ncols - ju) * rows;
    for (int q0 = t; q0 < total; q0 += kUnroll * kThreads) {
      double* dst[kUnroll];
      double x[kUnroll], u[kUnroll], lv[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int q = q0 + r * kThreads;
        if (q < total) {
          const int i = k + 1 + q % rows;
          double* colp = slab + static_cast<size_t>(ju + q / rows) * m;
          dst[r] = colp + i;
          x[r] = colp[i];
          u[r] = colp[k];
          lv[r] = l[i];
        }
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        if (q0 + r * kThreads < total) *dst[r] = __dsub_rn(x[r], __dmul_rn(lv[r], u[r]));
      }
    }
    cluster.sync();
  }

  // ---- back substitution, by the CTA that holds g ----
  if (c == m % C) {
    double* rhs = local(m);
    double* xs = red_v;
    for (int i = m - 1; i >= 0; --i) {
      const int oc = i % C;
      const double* colp;
      if (kShared) {
        colp = cluster.map_shared_rank(sm, oc) + static_cast<size_t>(i / C) * m;
      } else {
        colp = A.gslab + (static_cast<size_t>(oc) * cols + i / C) * m;
      }
      if (t == 0) {
        const double a_ii = kShared || oc == c ? colp[i] : __ldcg(colp + i);
        const double x = __ddiv_rn(rhs[i], a_ii);
        xs[0] = x;
        A.dx[i] = -__double2float_rn(x);
      }
      __syncthreads();
      const double x = xs[0];
      for (int r = t; r < i; r += kThreads) {
        const double a_ri = kShared || oc == c ? colp[r] : __ldcg(colp + r);
        rhs[r] = __dsub_rn(rhs[r], __dmul_rn(a_ri, x));
      }
      __syncthreads();
    }
  }
  cluster.sync();  // every CTA's shared memory lives until the last remote read
}

// The order floor: the chain of m - 1 pivot steps alone, on one column
// held by every CTA (col: m doubles): at step k CTA k mod C finds the
// pivot of rows k.., writes the multipliers and pushes the pivot row to
// every CTA, then the cluster barrier; no assembly, swap, update or back
// substitution.  out[c]: CTA c's last pivot row.
__global__ void __launch_bounds__(kThreads) pose_graph_chain_kernel(const double* __restrict__ src,
                                                                    int m, int* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  double* col = reinterpret_cast<double*>(smem_raw);
  double* lvec = col + m;  // [2][m]
  double* red_v = lvec + 2 * m;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* piv = red_i + kWarps;
  for (int i = threadIdx.x; i < m; i += kThreads) col[i] = src[i];
  if (threadIdx.x < 2) piv[threadIdx.x] = 0;
  cluster.sync();
  for (int k = 0; k < m - 1; ++k) {
    if (k % C == c) pivot(col, k, m, lvec + (k & 1) * m, k & 1, red_v, red_i, piv, cluster);
    cluster.sync();
  }
  if (threadIdx.x == 0) out[c] = piv[m & 1];
}

template <bool kShared>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int ctas, size_t smem,
                      cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(pose_graph_kernel<kShared>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pose_graph_kernel<kShared>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    set = true;
  }
  cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `ctas` CTAs of the kernel (with that much shared
// memory) the card can hold at once (0: it cannot schedule one).
extern "C" int dst_pose_graph_clusters(int m, int ctas, int shared, int* count) {
  if (ctas < 1 || ctas > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = m / ctas + 1;
  const size_t smem = smem_bytes(m, cols, shared != 0);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (shared) {
    err = configure<true>(cfg, attr, ctas, smem, nullptr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(count, pose_graph_kernel<true>, &cfg);
  } else {
    err = configure<false>(cfg, attr, ctas, smem, nullptr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(count, pose_graph_kernel<false>, &cfg);
  }
  return static_cast<int>(err);
}

extern "C" int dst_pose_graph_solve(const double* ja, const double* jb, const double* rd,
                                    const int* ei, const int* ej, const double* diag, int e, int m,
                                    int ctas, double* gslab, float* dx, void* stream) {
  if (ctas < 1 || ctas > kMaxCluster || m < 1 || e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = m / ctas + 1;  // ceil((m + 1) / ctas)
  const bool shared = gslab == nullptr;
  const size_t smem = smem_bytes(m, cols, shared);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{ja, jb, rd, ei, ej, diag, dx, gslab, e, m, cols};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (shared) {
    err = configure<true>(cfg, attr, ctas, smem, static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pose_graph_kernel<true>, A);
  } else {
    err = configure<false>(cfg, attr, ctas, smem, static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pose_graph_kernel<false>, A);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The order floor's probe (see pose_graph_chain_kernel), at the cluster
// size the solve of m rows runs with; not on any path.
extern "C" int dst_pose_graph_chain(const double* col, int m, int ctas, int* out, void* stream) {
  if (ctas < 1 || ctas > kMaxCluster || m < 2) return static_cast<int>(cudaErrorInvalidValue);
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(pose_graph_chain_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(pose_graph_chain_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(m, 1, true);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_graph_chain_kernel, col, m, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
