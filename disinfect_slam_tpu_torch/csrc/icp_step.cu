// icp_step: one iteration of point-to-plane ICP at one pyramid level, as
// one launch of one cluster of 8 CTAs.
//
// Replaces no TPU kernel: its counterpart is the body of the JAX
// `_icp_level` loop (disinfect_slam_tpu/systems/odometry.py:116), XLA ops
// inside jax.jit with no Pallas.  It was added for two reasons.  First, so
// that the card computes the CPU's bits through the tracker: the torch ops
// it replaces sum J^T W J in cuBLAS's order on the card and the CPU BLAS's
// order on the host, solve with cuSOLVER against LAPACK and take float32
// sin / cos / sqrt from different libraries, and the tracked trajectory
// amplifies each ulp.  Second, to cut an iteration's ~35 launches to one.
//
// What it computes.  Per source pixel: the transform by T and by the
// reference pose in SE3.apply_xyz's order ((r0 x + r1 y) + r2 z) + t, the
// projection with IEEE divisions, round half to even (rintf) and clip, the
// packed [N, 8] reference row (vertex, normal, validity: two float4
// loads), the distance gate, the residual, the Huber weight and the
// Jacobian [p x n | n]; then its 29 float32 products: jw_a jac_b for the
// 21 upper-triangle entries of J^T W J (jw = jac * weight), jw_a r for the
// 6 of J^T W r, (r r) inlier and the inlier.  Each of the 29 sums over the
// pixels is run by 8 interleaved accumulators: pixel p adds into
// accumulator p mod 8, each accumulator in pixel order, its first real
// pixel seeding it and a padded pixel (past N, up to a multiple of 8)
// adding +0; then the 8 are added in order 0..7.  That is a float32 sum
// with XLA:CPU's 8-lane vector accumulation: a pairwise tree, a float64
// sum or contiguous chunks move the tracked corridor of the soak test off
// the JAX soak's counts (PERF.md), so the kernel keeps the reference's
// accumulation.  Then one thread adds the 1e-6 damping, solves the 6x6 in
// float64 by LU with partial pivoting (jnp.linalg.solve's method; the
// first largest |pivot|, a NaN counting as largest, as torch.argmax), runs
// the se3 exp (sin and cos by one fixed polynomial) and the pose update in
// float64, and rounds T, rmse and the inlier count once to float32.
//
// Every operation is one IEEE operation with one rounding, and the
// library is built with -fmad=false, so ops/cuda/icp_kernel.py's
// icp_step_reference repeats the arithmetic op for op and gives the same
// bits on the CPU and the card.
//
// What bounds it: the order of the sums.  Each accumulator is a chain of
// N / 8 dependent float32 adds (38400 at 640x480), ~4.4 cycles each: the
// order floor, which `dst_icp_chain` times alone (0.087 ms at 640x480 on
// the H100).  The bytes (12 B of source point and a 32 B reference row a
// pixel, 13.5 MB at 640x480) take a twentieth of that.  The design feeds
// every chain an add at the add's own latency:
//
//   - CTA j of the cluster is accumulator j: its own pixels j, j + 8, ...
//     in order, no partial sums in device memory and no second launch;
//   - warp-specialised: 12 producer warps run the per-pixel arithmetic,
//     kPix pixels a thread in a part of a stage, kSlotWarps parts a stage
//     (the reference-row gather depends on the data, so many rows are in
//     flight), and write each pixel's 29 products into a ring of kStages
//     shared-memory stages laid out [stage][sum][row], the sum's stride
//     padded so that a quarter-warp's 16-byte loads fall in distinct
//     banks; each stage has a full / empty mbarrier pair, and no
//     __syncthreads runs in the loop;
//   - one consumer warp: lane c folds sum c, one 16-byte shared load
//     giving 4 consecutive rows of its sum and 4 dependent adds, from a
//     ring of kAhead loads in registers that runs on across stage
//     boundaries (the next stage's barrier tested early, waited on only
//     if it is not complete).  The consumer is warp 0 and warps 4, 8 and
//     12 stay idle, so that the chain's scheduler (a warp's scheduler is
//     its index mod 4) issues for the chain alone;
//   - the end: each CTA leaves its 29 partials in its shared memory, the
//     cluster synchronises, CTA 0 reads the 8 through distributed shared
//     memory and adds them in order, and its thread 0 solves.
//
// What is left (scripts/port_icp_variants.py, PERF.md): the consumer alone
// runs near the floor, and the producers bound the kernel at ~1.4x it.
// On 8 SMs their per-pixel arithmetic alone takes ~0.8 of the floor, and
// CTA j's stride-8 pixels make every warp load touch a cache line a lane.
// Letting producers share the consumer's scheduler slowed the chain;
// stores into other CTAs' rings (to make the loads contiguous) cost more
// than the loads they would save.
//
// Earlier designs: two launches (pass A writing a 64 B row a pixel to
// device memory, pass B's 8 blocks folding them, one warp's 29 lanes each
// making three scalar shared loads, two multiplies and an add a row, a
// __syncthreads pair every 512 rows, the last block found by a global
// counter) ran ~24 cycles a row; one block streaming the rows from device
// memory ran 13.4 ms a call at 640x480, load latency on every add.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kAcc = 8;                    // the cluster's CTAs: CTA j is accumulator j
constexpr int kSums = 29;                  // 21 of J^T W J, 6 of J^T W r, sum r^2, inliers
constexpr int kWarps = 16;                 // warp 0 consumes, 4 / 8 / 12 idle, 12 produce
constexpr int kThreads = 32 * kWarps;
constexpr int kProducers = kWarps - kWarps / 4;  // 12
constexpr int kPix = 4;                    // pixels a producer thread a part of a stage
constexpr int kSlotWarps = 2;              // producer warps filling a stage, a part each
constexpr int kStageRows = 32 * kPix * kSlotWarps;  // an accumulator's rows a stage
constexpr int kStride = kStageRows + 4;    // floats from one sum's rows to the next's
constexpr int kStages = 6;                 // the ring
constexpr int kStageFloats = kSums * kStride;
constexpr int kGroups = kStageRows / 4;    // 16-byte loads of a sum a stage
constexpr int kAhead = 8;                  // the consumer's loads in flight
constexpr int kSmem = kStages * kStageFloats * 4 + 2 * kStages * 8;
constexpr int kSinTerms = 15;  // sin to t^29, cos to t^30
constexpr float kDamping = 1e-6f;  // the JAX package's 1e-6, a float32
constexpr double kTwoPi = 0x1.921fb54442d18p+2;
constexpr double kInvTwoPi = 0x1.45f306dc9c883p-3;
static_assert(kStride % 32 == 4, "a quarter-warp's 16-byte loads in distinct banks");
// each part of a ring slot has one producer warp, which fills it round
// after round: a second owner could run two rounds ahead and pass a parity
// wait early
static_assert(kStages * kSlotWarps % kProducers == 0, "a slot part per producer warp");
static_assert(kSmem <= 232448, "a CTA's shared memory");
static_assert(kGroups >= 2 * kAhead, "the next stage is tested within the current one");

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

struct Level {
  const float* src;
  const float4* ref_pack;
  int img_w, img_h;
  float fx, fy, cx, cy, dist2;
};

// One producer thread's kPix pixels of its part of a stage: their 29
// products into the stage at the accumulator's rows base + lane, base +
// lane + 32, ... (those below `live`; stage_base: the stage's first
// row, so the part starts base - stage_base rows in).  Loads first for every
// pixel, so the source and the gathered reference rows of all kPix are in
// flight together.
__device__ __forceinline__ void produce(const Level& L, const float (&T)[12],
                                        const float (&P)[12], float delta, int j, int base,
                                        int stage_base, int lane, int live,
                                        float* __restrict__ stage) {
  float x[kPix], y[kPix], zs[kPix], px[kPix], py[kPix], pz[kPix];
  bool in_img[kPix];
  float4 g0[kPix], g1[kPix];
  const float wm = static_cast<float>(L.img_w - 1), hm = static_cast<float>(L.img_h - 1);
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int i = base + lane + 32 * q;  // the accumulator's row
    const size_t p = static_cast<size_t>(j) + static_cast<size_t>(kAcc) * (i < live ? i : 0);
    x[q] = __ldg(L.src + 3 * p);
    y[q] = __ldg(L.src + 3 * p + 1);
    zs[q] = __ldg(L.src + 3 * p + 2);
  }
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    px[q] = ((T[0] * x[q] + T[1] * y[q]) + T[2] * zs[q]) + T[3];
    py[q] = ((T[4] * x[q] + T[5] * y[q]) + T[6] * zs[q]) + T[7];
    pz[q] = ((T[8] * x[q] + T[9] * y[q]) + T[10] * zs[q]) + T[11];
    const float qx = ((P[0] * px[q] + P[1] * py[q]) + P[2] * pz[q]) + P[3];
    const float qy = ((P[4] * px[q] + P[5] * py[q]) + P[6] * pz[q]) + P[7];
    const float qz = ((P[8] * px[q] + P[9] * py[q]) + P[10] * pz[q]) + P[11];
    const float u = L.fx * qx / qz + L.cx;
    const float v = L.fy * qy / qz + L.cy;
    // clipped as floats (a NaN to 0), as the plain version does
    const float uf = rintf(u), vf = rintf(v);
    const int ui = static_cast<int>(uf >= 0.f ? (uf <= wm ? uf : wm) : 0.f);
    const int vi = static_cast<int>(vf >= 0.f ? (vf <= hm ? vf : hm) : 0.f);
    in_img[q] = u >= 0.f && u <= wm && v >= 0.f && v <= hm && qz > 0.f;
    const size_t row = static_cast<size_t>(vi) * L.img_w + ui;
    g0[q] = __ldg(L.ref_pack + 2 * row);
    g1[q] = __ldg(L.ref_pack + 2 * row + 1);
  }
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int r_in = base - stage_base + lane + 32 * q;  // the row within the stage
    if (base + lane + 32 * q >= live) break;  // rows grow with q: the rest are past the end
    const float dx = px[q] - g0[q].x, dy = py[q] - g0[q].y, dz = pz[q] - g0[q].z;
    const float nx = g0[q].w, ny = g1[q].x, nz = g1[q].y;
    const bool dist_ok = ((dx * dx + dy * dy) + dz * dz) < L.dist2;
    const bool valid = zs[q] > 0.f && in_img[q] && g1[q].z > 0.f && dist_ok;
    const float r = (nx * dx + ny * dy) + nz * dz;
    // torch.clamp's order and its NaN (a NaN stays a NaN)
    const float ra = fabsf(r);
    const float lo = ra < 1e-12f ? 1e-12f : ra;
    const float qh = delta / lo;
    const float huber = qh > 1.f ? 1.f : qh;
    const float inl = valid ? 1.f : 0.f;
    const float wgt = inl * huber;
    const float jac[6] = {py[q] * nz - pz[q] * ny, pz[q] * nx - px[q] * nz,
                          px[q] * ny - py[q] * nx, nx, ny, nz};
    float jw[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) jw[a] = jac[a] * wgt;
    float* out = stage + r_in;
    int s = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) out[kStride * s++] = jw[a] * jac[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) out[kStride * (21 + a)] = jw[a] * r;
    out[kStride * 27] = (r * r) * inl;
    out[kStride * 28] = inl;
  }
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

// The 29 sums -> the damped 6x6 solve, the se3 exp and T <- exp(x) T in
// float64, rounded once: T_out, rmse and the inlier count.
__device__ void solve_update(const float* total, const float* __restrict__ T,
                             float* __restrict__ T_out, float* __restrict__ out) {
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

__global__ void __cluster_dims__(kAcc, 1, 1) __launch_bounds__(kThreads, 1)
    icp_step_kernel(const float* __restrict__ T, const float* __restrict__ ref_pose,
                    const float* __restrict__ delta_p, Level L, float* __restrict__ T_out,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];  // [kStages][kSums][kStride]
  __shared__ float part[kSums];   // this CTA's accumulators
  __shared__ float total[kSums];  // CTA 0: the 8 added in order
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n = L.img_w * L.img_h;
  const int n8 = (n + kAcc - 1) / kAcc;
  const int live = n > j ? (n - j + kAcc - 1) / kAcc : 0;  // rows of real pixels
  const int stages = (live + kStageRows - 1) / kStageRows;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32 * kSlotWarps);  // the lanes of the warps filling it
      mbar_init(empty + s, 32);  // the consumer warp's lanes
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    // the consumer: lane c folds sum c over the stages in order (lanes
    // past the sums fold sum 28 again, unused), from a ring of kAhead
    // 16-byte loads in registers that runs on across stage boundaries:
    // the next stage's barrier is tested 2 kAhead groups before the end
    // of the current one and waited on kAhead groups before it
    const float* mine = ring + min(lane, kSums - 1) * kStride;
    const int whole = live / kStageRows;  // stages of kStageRows real rows
    float acc = 0.f;
    if (whole > 0) {
      mbar_wait(full, 0);
      float4 buf[kAhead];
#pragma unroll
      for (int d = 0; d < kAhead; ++d) buf[d] = *reinterpret_cast<const float4*>(mine + 4 * d);
      for (int k = 0; k < whole; ++k) {
        const int slot = k % kStages, next = (k + 1) % kStages;
        const bool more = k + 1 < whole;
        const float* cur = mine + slot * kStageFloats;
        const float* nxt = mine + next * kStageFloats;
        bool ready = true;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 v = buf[g % kAhead];
          if (g + 2 * kAhead == kGroups && more) ready = mbar_test(full + next, ((k + 1) / kStages) & 1);
          if (g + kAhead < kGroups) {
            buf[g % kAhead] = *reinterpret_cast<const float4*>(cur + 4 * (g + kAhead));
          } else if (more) {
            if (g + kAhead == kGroups && !ready) mbar_wait(full + next, ((k + 1) / kStages) & 1);
            buf[g % kAhead] = *reinterpret_cast<const float4*>(nxt + 4 * (g + kAhead - kGroups));
          }
          acc = g == 0 && k == 0 ? v.x : acc + v.x;  // the first real row seeds
          acc = acc + v.y;
          acc = acc + v.z;
          acc = acc + v.w;
        }
        mbar_arrive(empty + slot);
      }
    }
    const int tail = live - whole * kStageRows;  // the last stage's rows, partly filled
    if (tail > 0) {
      mbar_wait(full + whole % kStages, (whole / kStages) & 1);
      const float* rows = mine + (whole % kStages) * kStageFloats;
      int r = 0;
      if (whole == 0) {
        acc = rows[0];
        r = 1;
      }
      for (; r < tail; ++r) acc = acc + rows[r];
    }
    // a padded pixel adds +0 (an accumulator with no real pixel holds +0)
    if (lane < kSums) part[lane] = live < n8 ? acc + 0.f : acc;
  } else if (warp % 4 != 0) {
    // a producer: parts pw, pw + kProducers, ... of the stages in order
    const int pw = warp - warp / 4 - 1;
    float Tr[12], Pr[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      Tr[e] = __ldg(T + e);
      Pr[e] = __ldg(ref_pose + e);
    }
    const float delta = __ldg(delta_p);
    for (int g = pw; g < stages * kSlotWarps; g += kProducers) {
      const int k = g / kSlotWarps, slot = k % kStages;
      if (k >= kStages) mbar_wait(empty + slot, (k / kStages - 1) & 1);
      produce(L, Tr, Pr, delta, j, k * kStageRows + (g % kSlotWarps) * 32 * kPix,
              k * kStageRows, lane, live, ring + slot * kStageFloats);
      mbar_arrive(full + slot);
    }
  }
  // the end: CTA 0 adds the cluster's 8 accumulators in order and solves
  cluster.sync();
  if (j == 0 && t < kSums) {
    float s = part[t];
    for (int r = 1; r < kAcc; ++r) s = s + *cluster.map_shared_rank(part + t, r);
    total[t] = s;
  }
  cluster.sync();  // the other CTAs' shared memory lives until CTA 0 has read it
  if (j == 0 && t == 0) solve_update(total, T, T_out, out);
}

// The order floor: 29 chains of `rows` dependent float32 adds, in
// registers, one warp (a lane a chain, as the consumer folds them).
__global__ void __launch_bounds__(32) icp_chain_kernel(const float* __restrict__ seed,
                                                       int rows, float* __restrict__ out) {
  const int c = threadIdx.x;
  if (c >= kSums) return;
  const float inc = __ldg(seed + c);
  float acc = inc;
#pragma unroll 16
  for (int r = 1; r < rows; ++r) acc = acc + inc;
  out[c] = acc;
}

// above 48 KB of dynamic shared memory only once allowed; the first call
// of a step runs eagerly, before any capture
cudaError_t set_smem() {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        icp_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  return cudaSuccess;
}

}  // namespace

// How many of the kernel's 8-CTA clusters the card can hold at once (0:
// it cannot schedule one, and icp_step raises).
extern "C" int dst_icp_clusters(int* count) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kAcc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, icp_step_kernel, &cfg));
}

extern "C" int dst_icp_step(const float* T, const float* src, const void* ref_pack,
                            const float* ref_pose, const float* delta, int img_w, int img_h,
                            float fx, float fy, float cx, float cy, float dist2, float* T_out,
                            float* out, void* stream) {
  const cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Level L{src, static_cast<const float4*>(ref_pack), img_w, img_h, fx, fy, cx, cy, dist2};
  icp_step_kernel<<<kAcc, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      T, ref_pose, delta, L, T_out, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dst_icp_chain(const float* seed, int rows, float* out, void* stream) {
  icp_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(seed, rows, out);
  return static_cast<int>(cudaGetLastError());
}
