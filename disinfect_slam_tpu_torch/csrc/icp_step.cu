// icp_step: one iteration of point-to-plane ICP at one pyramid level.
//
// Replaces no TPU kernel: its counterpart is the body of the JAX
// `_icp_level` loop (disinfect_slam_tpu/systems/odometry.py:116), XLA ops
// inside jax.jit with no Pallas.  It was added for two reasons.  First, so
// that the card computes the CPU's bits through the tracker: the torch ops
// it replaces sum J^T W J in cuBLAS's order on the card and the CPU BLAS's
// order on the host, solve with cuSOLVER against LAPACK and take float32
// sin / cos / sqrt from different libraries, and the tracked trajectory
// amplifies each ulp.  Second, to cut an iteration's ~35 launches to two.
//
// Pass A (dst_icp_pixels): one thread a source pixel, 256 a block.  The
// transform by T and by the reference pose in SE3.apply_xyz's order
// ((r0 x + r1 y) + r2 z) + t, the projection with IEEE divisions, round
// half to even (rintf) and clip, the packed [N, 8] reference row (vertex,
// normal, validity: two float4 loads), the distance gate, the residual,
// the Huber weight and the Jacobian [p x n | n]; it writes the pixel's row
// of 16 floats: jw = jac * weight [6], jac [6], r, inlier, 1, 0.
//
// Pass B (dst_icp_solve): 8 blocks, one an accumulator.  The 29 float32
// sums over the pixels (the 21 upper-triangle entries of J^T W J, the 6 of
// J^T W r, sum r^2 over inliers and the inlier count), each product
// rounded to float32, each sum run by 8 interleaved accumulators (pixel p
// adds into p mod 8, every accumulator in pixel order; pass A wrote each
// accumulator's rows as one slab, which its block streams through shared
// memory with cp.async), then the 8 added in order by the last block to
// finish.  That is a float32 sum with XLA:CPU's 8-lane
// vector accumulation: a pairwise tree, a float64 sum or contiguous chunks
// move the tracked corridor of the soak test off the JAX soak's counts
// (PERF.md), so the kernel keeps the reference's accumulation.  Then one
// thread adds the 1e-6 damping, solves the 6x6 in float64 by LU with
// partial pivoting (jnp.linalg.solve's method; the first largest |pivot|,
// a NaN counting as largest, as torch.argmax), runs the se3 exp (sin and
// cos by one fixed polynomial) and the pose update in float64, and rounds
// T, rmse and the inlier count once to float32.
//
// Every operation is one IEEE operation with one rounding, and the
// library is built with -fmad=false, so ops/cuda/icp_kernel.py's
// icp_step_reference repeats the arithmetic op for op and gives the same
// bits on the CPU and the card.
//
// What bounds it: pass A, device memory (per pixel 12 B of source point,
// a 32 B reference row, a 64 B row out); pass B, the latency of its sums'
// chains of N / 8 dependent adds, which the fixed order makes serial (a
// first version streamed the rows through one block from device memory
// and took 13.4 ms a call at 640x480, load latency on every add).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kAcc = 8;
constexpr int kSums = 29;
constexpr int kTerms = 16;
constexpr int kSumThreads = 256;  // pass B: threads a block (8 blocks)
constexpr int kChunk = 512;       // pass B: rows a ring stage
constexpr int kStages = 4;        // pass B: ring stages (128 KB of shared memory)
constexpr int kSinTerms = 15;  // sin to t^29, cos to t^30
constexpr float kDamping = 1e-6f;  // the JAX package's 1e-6, a float32
constexpr double kTwoPi = 0x1.921fb54442d18p+2;
constexpr double kInvTwoPi = 0x1.45f306dc9c883p-3;

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

__global__ void __launch_bounds__(kBlock) icp_pixels_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float4* __restrict__ ref_pack, const float* __restrict__ ref_pose,
    const float* __restrict__ delta, int img_w, int img_h, float fx, float fy,
    float cx, float cy, float dist2, float4* __restrict__ terms,
    unsigned int* __restrict__ counter) {
  const int n = img_w * img_h;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i == 0) *counter = 0u;  // pass B's count of finished blocks
  if (i >= n) return;
  const float x = src[3 * i], y = src[3 * i + 1], zs = src[3 * i + 2];
  const float px = ((T[0] * x + T[1] * y) + T[2] * zs) + T[3];
  const float py = ((T[4] * x + T[5] * y) + T[6] * zs) + T[7];
  const float pz = ((T[8] * x + T[9] * y) + T[10] * zs) + T[11];
  const float* P = ref_pose;
  const float qx = ((P[0] * px + P[1] * py) + P[2] * pz) + P[3];
  const float qy = ((P[4] * px + P[5] * py) + P[6] * pz) + P[7];
  const float qz = ((P[8] * px + P[9] * py) + P[10] * pz) + P[11];
  const float u = fx * qx / qz + cx;
  const float v = fy * qy / qz + cy;
  // clipped as floats (a NaN to 0), as the plain version does
  const float uf = rintf(u), vf = rintf(v);
  const float wm = static_cast<float>(img_w - 1), hm = static_cast<float>(img_h - 1);
  const int ui = static_cast<int>(uf >= 0.f ? (uf <= wm ? uf : wm) : 0.f);
  const int vi = static_cast<int>(vf >= 0.f ? (vf <= hm ? vf : hm) : 0.f);
  const bool in_img = u >= 0.f && u <= wm && v >= 0.f && v <= hm && qz > 0.f;
  const size_t row = static_cast<size_t>(vi) * img_w + ui;
  const float4 g0 = __ldg(ref_pack + 2 * row);
  const float4 g1 = __ldg(ref_pack + 2 * row + 1);
  const float dx = px - g0.x, dy = py - g0.y, dz = pz - g0.z;
  const float nx = g0.w, ny = g1.x, nz = g1.y;
  const bool dist_ok = ((dx * dx + dy * dy) + dz * dz) < dist2;
  const bool valid = zs > 0.f && in_img && g1.z > 0.f && dist_ok;
  const float r = (nx * dx + ny * dy) + nz * dz;
  // torch.clamp's order and its NaN (a NaN stays a NaN)
  const float ra = fabsf(r);
  const float lo = ra < 1e-12f ? 1e-12f : ra;
  const float q = __ldg(delta) / lo;
  const float huber = q > 1.f ? 1.f : q;
  const float inl = valid ? 1.f : 0.f;
  const float wgt = inl * huber;
  const float j0 = py * nz - pz * ny, j1 = pz * nx - px * nz, j2 = px * ny - py * nx;
  // pixel i's row goes to its accumulator's slab: slab i % 8, row i / 8
  const int n8 = (n + kAcc - 1) / kAcc;
  float4* out = terms + 4 * (static_cast<size_t>(i % kAcc) * n8 + i / kAcc);
  out[0] = make_float4(j0 * wgt, j1 * wgt, j2 * wgt, nx * wgt);
  out[1] = make_float4(ny * wgt, nz * wgt, j0, j1);
  out[2] = make_float4(j2, nx, ny, nz);
  out[3] = make_float4(r, inl, 1.f, 0.f);
}

// sin and cos by core/exact.sincos's polynomial
__device__ void sincos_poly(double theta, double* s_out, double* c_out) {
  const double k = rint(theta * kInvTwoPi);
  const double t = theta - k * kTwoPi;
  const double t2 = t * t;
  double s = kInvFact[2 * kSinTerms - 1];  // (-1)^14 / 29!
  double c = -kInvFact[2 * kSinTerms];     // (-1)^15 / 30!
  for (int m = kSinTerms - 2; m >= 0; --m) {
    const double coef = (m & 1) ? -kInvFact[2 * m + 1] : kInvFact[2 * m + 1];
    s = coef + t2 * s;
  }
  for (int m = kSinTerms - 1; m >= 0; --m) {
    const double coef = (m & 1) ? -kInvFact[2 * m] : kInvFact[2 * m];
    c = coef + t2 * c;
  }
  *s_out = t * s;
  *c_out = c;
}

// out = a @ b for 3x3 a and 3 x cols b (row-major, b's row stride bs),
// each entry ((a0 b0 + a1 b1) + a2 b2)
__device__ void mat3(const double a[3][3], const double* b, int bs, int cols, double* out,
                     int os) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < cols; ++j)
      out[i * os + j] = (a[i][0] * b[j] + a[i][1] * b[bs + j]) + a[i][2] * b[2 * bs + j];
}

__global__ void __launch_bounds__(kSumThreads) icp_solve_kernel(
    const float4* __restrict__ terms, int n, float* __restrict__ partial,
    unsigned int* __restrict__ counter, const float* __restrict__ T,
    float* __restrict__ T_out, float* __restrict__ out) {
  // block j runs accumulator j of every sum: the rows of pixels j, j + 8,
  // ... (its slab), streamed through a ring of kStages chunks of shared
  // memory by cp.async; thread c < 29 folds sum c over them in order, and
  // the last block to finish adds the 8 accumulators and solves
  extern __shared__ float4 stage[];  // [kStages][kChunk * 4]
  __shared__ bool last;
  __shared__ float total[kSums];
  const int j = blockIdx.x, t = threadIdx.x;
  const int n8 = (n + kAcc - 1) / kAcc;
  const int live = n > j ? (n - j + kAcc - 1) / kAcc : 0;  // rows of real pixels
  const float4* slab = terms + static_cast<size_t>(j) * n8 * 4;
  const int chunks = (n8 + kChunk - 1) / kChunk;
  auto issue = [&](int k) {
    if (k < chunks) {
      float4* dst = stage + (k % kStages) * kChunk * 4;
      const int rows = min(kChunk, n8 - k * kChunk);
      const float4* src = slab + static_cast<size_t>(k) * kChunk * 4;
      for (int e = t; e < rows * 4; e += kSumThreads) __pipeline_memcpy_async(dst + e, src + e, 16);
    }
    __pipeline_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  // every sum's term is (row[a] * row[b]) * row[e], row[14] holding 1:
  // jw[a] jac[b - 6] * 1 (sums 0-20), jw[a] r * 1 (21-26), (r r) inlier
  // (27), inlier * 1 * 1 (28); x * 1 is x, so the plain version's products
  const int sc = t;  // the sum this thread folds
  int a = 13, b = 14, e = 14;
  if (sc < 21) {
    int k = sc;
    a = 0;
    while (k >= 6 - a) {
      k -= 6 - a;
      ++a;
    }
    b = 6 + a + k;
  } else if (sc < 27) {
    a = sc - 21;
    b = 12;
  } else if (sc == 27) {
    a = b = 12;
    e = 13;
  }
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) {
    issue(k + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();
    if (sc < kSums) {
      const float* rows = reinterpret_cast<const float*>(stage + (k % kStages) * kChunk * 4);
      const int i0 = k * kChunk;
      const int count = min(kChunk, n8 - i0);
      const int real = max(0, min(count, live - i0));
      int r = 0;
      if (k == 0) {  // the first row seeds the accumulator (a padded one with +0)
        acc = real > 0 ? (rows[a] * rows[b]) * rows[e] : 0.f;
        r = 1;
      }
#pragma unroll 8
      for (; r < real; ++r) {
        const float* row = rows + r * kTerms;
        acc = acc + (row[a] * row[b]) * row[e];
      }
      for (; r < count; ++r) acc = acc + 0.f;  // a padded pixel adds +0
    }
    __syncthreads();
  }
  if (sc < kSums) partial[j * 32 + sc] = acc;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == kAcc - 1;
  __syncthreads();
  if (!last) return;
  // the last block: the 8 accumulators of each sum added in order
  __threadfence();
  if (t < kSums) {
    const volatile float* pv = partial;
    float s = pv[t];
    for (int jj = 1; jj < kAcc; ++jj) s = s + pv[jj * 32 + t];
    total[t] = s;
  }
  __syncthreads();
  if (t != 0) return;
  double sums[kSums];
  for (int q = 0; q < kSums; ++q) sums[q] = static_cast<double>(total[q]);
  // [A | -b], A symmetric from its upper triangle, the damping on the diagonal
  double m[6][7];
  int idx = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      const double a = i == j ? sums[idx] + static_cast<double>(kDamping) : sums[idx];
      m[i][j] = a;
      m[j][i] = a;
      ++idx;
    }
  for (int i = 0; i < 6; ++i) m[i][6] = -sums[21 + i];
  for (int k = 0; k < 5; ++k) {
    int p = k;
    double best = fabs(m[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      const double a = fabs(m[i][k]);
      if (!isnan(best) && (isnan(a) || a > best)) {
        best = a;
        p = i;
      }
    }
    if (p != k) {
      for (int j = 0; j < 7; ++j) {
        const double tmp = m[k][j];
        m[k][j] = m[p][j];
        m[p][j] = tmp;
      }
    }
    for (int i = k + 1; i < 6; ++i) {
      const double l = m[i][k] / m[k][k];
      for (int j = k + 1; j < 7; ++j) m[i][j] = m[i][j] - l * m[k][j];
    }
  }
  // back substitution column by column, as core/exact.solve_lu
  double x[6];
  for (int i = 5; i >= 0; --i) {
    x[i] = m[i][6] / m[i][i];
    for (int r = 0; r < i; ++r) m[r][6] = m[r][6] - m[r][i] * x[i];
  }
  // the se3 exp of x = (omega, v) and T <- exp(x) T, in float64
  const double theta = sqrt((x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]) + 1e-12;
  const double k0 = x[0] / theta, k1 = x[1] / theta, k2 = x[2] / theta;
  const double kx[3][3] = {{0.0, -k2, k1}, {k2, 0.0, -k0}, {-k1, k0, 0.0}};
  double kx2[3][3];
  mat3(kx, &kx[0][0], 3, 3, &kx2[0][0], 3);
  double s, c;
  sincos_poly(theta, &s, &c);
  const double omc = 1.0 - c;
  const double fv = omc / theta, fw = (theta - s) / theta;
  double r_up[3][3], vmat[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double e = i == j ? 1.0 : 0.0;
      r_up[i][j] = (e + s * kx[i][j]) + omc * kx2[i][j];
      vmat[i][j] = (e + fv * kx[i][j]) + fw * kx2[i][j];
    }
  double t_up[3];
  mat3(vmat, &x[3], 1, 1, t_up, 1);
  double td[3][4];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) td[i][j] = static_cast<double>(T[4 * i + j]);
  double rt[3][4];
  mat3(r_up, &td[0][0], 4, 4, &rt[0][0], 4);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T_out[4 * i + j] = static_cast<float>(rt[i][j]);
    T_out[4 * i + 3] = static_cast<float>(rt[i][3] + t_up[i]);
  }
  T_out[12] = 0.f;
  T_out[13] = 0.f;
  T_out[14] = 0.f;
  T_out[15] = 1.f;
  const double n_in = sums[28];
  out[0] = static_cast<float>(sqrt(sums[27] / (n_in < 1.0 ? 1.0 : n_in)));
  out[1] = static_cast<float>(n_in);
}

}  // namespace

extern "C" int dst_icp_pixels(const float* T, const float* src, const void* ref_pack,
                              const float* ref_pose, const float* delta, int img_w, int img_h,
                              float fx, float fy, float cx, float cy, float dist2,
                              void* terms, unsigned int* counter, void* stream) {
  const int n = img_w * img_h;
  const int blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0) {
    icp_pixels_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        T, src, static_cast<const float4*>(ref_pack), ref_pose, delta, img_w, img_h, fx, fy, cx,
        cy, dist2, static_cast<float4*>(terms), counter);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dst_icp_solve(const void* terms, int n, float* partial, unsigned int* counter,
                             const float* T, float* T_out, float* out, void* stream) {
  const int smem = kStages * kChunk * kTerms * static_cast<int>(sizeof(float));
  // above 48 KB of dynamic shared memory only once allowed; the first call
  // of a step runs eagerly, before any capture
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        icp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  icp_solve_kernel<<<kAcc, kSumThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(terms), n, partial, counter, T, T_out, out);
  return static_cast<int>(cudaGetLastError());
}
