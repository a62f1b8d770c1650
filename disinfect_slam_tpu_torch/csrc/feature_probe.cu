// Hopper feature probe: the counterpart of the TPU probe
// scripts/probe_mosaic_features.py (P7), run by ops/cuda/feature_probe.py.
//
// P7 asked which primitives the Mosaic stack really had, with numerics
// (dynamic lane and sublane rolls, take_along_axis, an f32 MXU dot, 2D
// reshapes, strided lane slices, a 2D -> 3D reshape).  Here each kernel
// compiles for sm_90a a primitive the port's kernels rely on, or the
// Hopper counterpart of one of P7's, on a tiny input that feature_probe.py
// checks against numpy and torch:
//   - a lane rotate by __shfl_sync (P7's roll_lanes);
//   - shared-memory address arithmetic: a row roll (roll_sublanes), an
//     indexed gather (take_along_lanes), a reshape, a strided slice and a
//     reshape-and-sum (reshape_2d_*, strided_lane_slice, cast_2d_3d);
//   - a float32 dot without contraction (-fmad=false, as every source
//     here builds) beside the same dot by fmaf (f32_dot);
//   - __reduce_min_sync / __reduce_max_sync on int and unsigned words
//     (the footprint box of the splat kernels);
//   - shared and global atomicMin / atomicMax on int and on unsigned words
//     with the top bit set (the splat merges);
//   - a cp.async.bulk copy into shared memory completed on an mbarrier
//     (fuse_rows' ring, the sample probe's patches);
//   - __float2int_rz on +-inf and NaN (the projection's pixel);
//   - a double sqrt rounded to float against __fsqrt_rn (the splat range).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kRows = 64, kCols = 128;  // the shared-memory tile of the address probes

__global__ void feature_rotate_kernel(const float* __restrict__ x, int shift, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  out[i] = __shfl_sync(0xffffffffu, x[i], (lane - shift) & 31);
}

// out: [kRows][kCols] roll of the rows by `shift`, [kRows][kCols] gather
// x[r][idx[r][c]], [kRows * kCols / 8][8] reshape, [kRows][kCols / 8]
// every 8th word, [kRows][kCols / 8] sums of 8 consecutive words
__global__ void __launch_bounds__(512) feature_address_kernel(const float* __restrict__ x,
                                                      const int* __restrict__ idx, int shift,
                                                      float* __restrict__ out) {
  __shared__ float s[kRows][kCols];
  const int t = threadIdx.x;
  for (int i = t; i < kRows * kCols; i += blockDim.x) s[i / kCols][i % kCols] = x[i];
  __syncthreads();
  float* roll = out;
  float* take = roll + kRows * kCols;
  float* reshape = take + kRows * kCols;
  float* strided = reshape + kRows * kCols;
  float* sums = strided + kRows * kCols / 8;
  for (int i = t; i < kRows * kCols; i += blockDim.x) {
    const int r = i / kCols, c = i % kCols;
    roll[i] = s[(r - shift + kRows) % kRows][c];
    take[i] = s[r][idx[i]];
    const int flat = (i / 8) * 8 + i % 8;  // reshape (kRows * kCols / 8, 8)
    reshape[i] = s[flat / kCols][flat % kCols];
  }
  for (int i = t; i < kRows * kCols / 8; i += blockDim.x) {
    const int r = i / (kCols / 8), c = i % (kCols / 8);
    strided[i] = s[r][8 * c];
    float acc = 0.f;
    for (int k = 0; k < 8; ++k) acc += s[r][8 * c + k];
    sums[i] = acc;
  }
}

// out[2][m][n]: a @ b by s = s + a b (no contraction) and by fmaf
__global__ void feature_dot_kernel(const float* __restrict__ a, const float* __restrict__ b, int m,
                           int k, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const int r = i / n, c = i % n;
  float plain = 0.f, fused = 0.f;
  for (int j = 0; j < k; ++j) {
    const float x = a[r * k + j], y = b[j * n + c];
    plain = plain + x * y;
    fused = fmaf(x, y, fused);
  }
  out[i] = plain;
  out[m * n + i] = fused;
}

// out[4][warps]: per warp min and max as int, min and max as unsigned
__global__ void feature_reduce_kernel(const int* __restrict__ x, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int warps = gridDim.x * blockDim.x / 32;
  const unsigned all = 0xffffffffu;
  const int v = x[i];
  const int mn = __reduce_min_sync(all, v), mx = __reduce_max_sync(all, v);
  const unsigned umn = __reduce_min_sync(all, static_cast<unsigned>(v));
  const unsigned umx = __reduce_max_sync(all, static_cast<unsigned>(v));
  if ((threadIdx.x & 31) == 0) {
    const int w = i / 32;
    out[w] = mn;
    out[warps + w] = mx;
    out[2 * warps + w] = static_cast<int>(umn);
    out[3 * warps + w] = static_cast<int>(umx);
  }
}

// one CTA: value i merged into slot slots[i] of four shared arrays (int
// min, int max, unsigned min, unsigned max), written to out[0..3]
__global__ void __launch_bounds__(512) feature_shared_atomics_kernel(const int* __restrict__ vals,
                                                             const int* __restrict__ slots,
                                                             int n, int n_slots,
                                                             int* __restrict__ out) {
  __shared__ int smin[256], smax[256];
  __shared__ unsigned umin[256], umax[256];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    smin[i] = INT_MAX;
    smax[i] = INT_MIN;
    umin[i] = 0xffffffffu;
    umax[i] = 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = slots[i], v = vals[i];
    atomicMin(&smin[s], v);
    atomicMax(&smax[s], v);
    atomicMin(&umin[s], static_cast<unsigned>(v));
    atomicMax(&umax[s], static_cast<unsigned>(v));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    out[i] = smin[i];
    out[n_slots + i] = smax[i];
    out[2 * n_slots + i] = static_cast<int>(umin[i]);
    out[3 * n_slots + i] = static_cast<int>(umax[i]);
  }
}

// the same merges into out[4..7] in global memory (filled by the caller
// with INT_MAX, INT_MIN, 0xffffffff, 0), from every CTA
__global__ void feature_global_atomics_kernel(const int* __restrict__ vals, const int* __restrict__ slots,
                                      int n, int n_slots, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i], v = vals[i];
  int* g = out + 4 * n_slots;
  atomicMin(g + s, v);
  atomicMax(g + n_slots + s, v);
  atomicMin(reinterpret_cast<unsigned*>(g + 2 * n_slots) + s, static_cast<unsigned>(v));
  atomicMax(reinterpret_cast<unsigned*>(g + 3 * n_slots) + s, static_cast<unsigned>(v));
}

// one CTA: `chunks` bulk copies of 2 KB (a pool row) into shared memory on
// one mbarrier phase, then written back out by every thread
constexpr int kChunkWords = 512;
__global__ void __launch_bounds__(512) feature_bulk_copy_kernel(const float* __restrict__ src,
                                                        int chunks, float* __restrict__ dst) {
  __shared__ __align__(128) float s[4 * kChunkWords];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, chunks * kChunkWords * 4);
    for (int c = 0; c < chunks; ++c) {
      bulk_load(s + c * kChunkWords, src + c * kChunkWords, kChunkWords * 4, &bar);
    }
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < chunks * kChunkWords; i += blockDim.x) dst[i] = s[i];
}

__global__ void feature_float2int_kernel(const float* __restrict__ x, int n, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2int_rz(x[i]);
}

// out[2][n]: sqrt in double rounded to float, and __fsqrt_rn
__global__ void feature_sqrt_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __double2float_rn(sqrt(static_cast<double>(x[i])));
  out[n + i] = __fsqrt_rn(x[i]);
}

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// x, out f32 [32 * warps]
extern "C" int dst_probe_rotate(const float* x, int warps, int shift, float* out, void* stream) {
  feature_rotate_kernel<<<warps, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, shift, out);
  return done();
}

// x f32 [64][128], idx i32 [64][128] in [0, 128); out f32 [3 * 8192 + 2 * 1024]
extern "C" int dst_probe_address(const float* x, const int* idx, int shift, float* out,
                                 void* stream) {
  feature_address_kernel<<<1, 512, 0, static_cast<cudaStream_t>(stream)>>>(x, idx, shift, out);
  return done();
}

// a f32 [m][k], b f32 [k][n]; out f32 [2][m][n]
extern "C" int dst_probe_dot(const float* a, const float* b, int m, int k, int n, float* out,
                             void* stream) {
  feature_dot_kernel<<<(m * n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, m, k, n,
                                                                                out);
  return done();
}

// x i32 [32 * warps]; out i32 [4][warps]
extern "C" int dst_probe_reduce(const int* x, int warps, int* out, void* stream) {
  feature_reduce_kernel<<<warps, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return done();
}

// vals, slots i32 [n] (slots < n_slots <= 256); out i32 [8][n_slots], its
// last four rows filled by the caller
extern "C" int dst_probe_atomics(const int* vals, const int* slots, int n, int n_slots,
                                 int* out, void* stream) {
  if (n_slots > 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  feature_shared_atomics_kernel<<<1, 512, 0, s>>>(vals, slots, n, n_slots, out);
  feature_global_atomics_kernel<<<(n + 255) / 256, 256, 0, s>>>(vals, slots, n, n_slots, out);
  return done();
}

// src, dst f32 [chunks * 512], chunks <= 4, src 16-byte aligned
extern "C" int dst_probe_bulk_copy(const float* src, int chunks, float* dst, void* stream) {
  if (chunks < 1 || chunks > 4) return static_cast<int>(cudaErrorInvalidValue);
  feature_bulk_copy_kernel<<<1, 512, 0, static_cast<cudaStream_t>(stream)>>>(src, chunks, dst);
  return done();
}

extern "C" int dst_probe_float2int(const float* x, int n, int* out, void* stream) {
  feature_float2int_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return done();
}

// x f32 [n]; out f32 [2][n]
extern "C" int dst_probe_sqrt(const float* x, int n, float* out, void* stream) {
  feature_sqrt_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return done();
}
