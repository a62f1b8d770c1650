// fuse_rows: frame sampling + semantic TSDF fusion, in place on the pool.
//
// Replaces the TPU kernels fuse_rows_packed (K2) and fuse_rows (K3) of
// disinfect_slam_tpu/ops/pallas/fuse_kernel.py.  Those select each
// voxel's pixel from a VMEM patch with one-hot matmuls, take the pool
// rows from an XLA gather, hand updated rows back to an XLA scatter, and
// need a second, patch-DMA kernel (K3) for frames over 10 MB.  Here each
// thread loads its voxel's 32-byte pixel directly (no patch, no skipped
// voxel, no frame-size limit, so K3 is this kernel at 1920x1080), reads
// its pool row words through pool_idx and writes them back in place.
// Dense-backend pool indices of live rows are unique, so no two CTAs
// touch one row.
//
// Layout: one CTA of 512 threads per visible block row, the CUDA
// original's tsdf_integrate_kernel layout (voxel_tsdf.cu:474-481); rows at
// or past the device-side live count return at once.  Each CTA reduces
// min |tsdf| over its row (warp shuffles, then one warp over 16 partials)
// for space carving.
//
// Fusion formulas: voxel_tsdf.cu:149-205 as the JAX package states them
// (roundf rgb and weight, weight clamp, log-odds ht/lt with
// powf(0, 0) == 1, optional prob_eps clamp), op for op as the plain
// version fuse_math in ops/cuda/fuse_kernel.py; built with -fmad=false so
// no multiply-add is contracted.
//
// What bounds it: device memory bytes.  Per voxel it moves 13 B of
// pixel coordinates, depth and gate, 12 B of pool read and 12 B of pool
// write; the 9.8 MB VGA frame stays in the 50 MB L2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;
constexpr int kChannels = 8;
constexpr int kWarps = kVoxels / 32;

__device__ __forceinline__ float round_half_away(float x) {
  return x >= 0.f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

// torch.minimum(x, hi) for a finite hi: a NaN x stays NaN
__device__ __forceinline__ float min_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// min that propagates NaN, like torch.amin
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// log(x ** e) with C powf edge semantics: e == 0 contributes 0
__device__ __forceinline__ float pow_log(float x, float e) {
  return e == 0.f ? 0.f : e * logf(x);
}

__global__ void __launch_bounds__(kVoxels) fuse_rows_kernel(
    const float* __restrict__ img, int img_h, int img_w,
    const int* __restrict__ us, const int* __restrict__ vs,
    const float* __restrict__ zs, const uint8_t* __restrict__ gate,
    const int* __restrict__ pool_idx, const int* __restrict__ count,
    int num_blocks, float* __restrict__ tsdf, int* __restrict__ rgbw,
    float* __restrict__ prob, float* __restrict__ minabs, float truncation,
    float max_depth, float max_weight, float prob_eps, float prob_hi) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const int pool = __ldg(pool_idx + row);
  if (pool < 0 || pool >= num_blocks) return;
  const int t = threadIdx.x;
  const size_t vi = static_cast<size_t>(row) * kVoxels + t;
  const size_t pi = static_cast<size_t>(pool) * kVoxels + t;

  const int u = min(max(us[vi], 0), img_w - 1);
  const int v = min(max(vs[vi], 0), img_h - 1);
  const float4* px = reinterpret_cast<const float4*>(
      img + (static_cast<size_t>(v) * img_w + u) * kChannels);
  const float4 a = __ldg(px);
  const float4 b = __ldg(px + 1);
  const float depth = a.x, d2r = a.y, r_new = a.z, g_new = a.w;
  const float b_new = b.x, ht = b.y, lt = b.z;

  const float z = zs[vi];
  const float tsdf_old = tsdf[pi];
  const int word = rgbw[pi];
  const float prob_old = prob[pi];

  const float sdf = d2r * (depth - z);
  const bool update = gate[vi] && depth > 0.f && depth <= max_depth &&
                      sdf > -truncation;
  const float tsdf_new = min_hi(sdf / truncation, 1.f);
  const float w_new = (1.f - depth / max_depth) * 4.f;

  const float w_old = static_cast<float>((word >> 24) & 0xFF);
  const float r_old = static_cast<float>(word & 0xFF);
  const float g_old = static_cast<float>((word >> 8) & 0xFF);
  const float b_old = static_cast<float>((word >> 16) & 0xFF);
  const float w_comb = w_old + w_new;
  const float w_safe = w_comb == 0.f ? 1.f : w_comb;
  const float tsdf_upd = (tsdf_old * w_old + tsdf_new * w_new) / w_safe;
  const float r_upd = round_half_away((r_old * w_old + r_new * w_new) / w_safe);
  const float g_upd = round_half_away((g_old * w_old + g_new * w_new) / w_safe);
  const float b_upd = round_half_away((b_old * w_old + b_new * w_new) / w_safe);
  const float w_upd = min_hi(round_half_away(w_comb), max_weight);
  const float e_old = w_old / w_safe;
  const float e_new = w_new / w_safe;
  const float positive = expf(pow_log(prob_old, e_old) + pow_log(ht, e_new));
  const float negative =
      expf(pow_log(1.f - prob_old, e_old) + pow_log(lt, e_new));
  const float denom = positive + negative;
  float prob_upd = denom > 0.f ? positive / denom : prob_old;
  if (prob_eps > 0.f) {
    prob_upd = prob_upd < prob_eps ? prob_eps : min_hi(prob_upd, prob_hi);
  }

  float t_fin = tsdf_old;
  if (update) {
    t_fin = tsdf_upd;
    tsdf[pi] = tsdf_upd;
    rgbw[pi] = static_cast<int>(r_upd) | (static_cast<int>(g_upd) << 8) |
               (static_cast<int>(b_upd) << 16) |
               (static_cast<int>(w_upd) << 24);
    prob[pi] = prob_upd;
  }

  float m = fabsf(t_fin);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_min[kWarps];
  if ((t & 31) == 0) warp_min[t >> 5] = m;
  __syncthreads();
  if (t < 32) {
    m = t < kWarps ? warp_min[t] : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (t == 0) minabs[row] = m;
  }
}

}  // namespace

extern "C" int dst_fuse_rows(const float* img, int img_h, int img_w,
                             const int* us, const int* vs, const float* zs,
                             const uint8_t* gate, const int* pool_idx,
                             const int* count, int rows, int num_blocks,
                             float* tsdf, int* rgbw, float* prob,
                             float* minabs, float truncation, float max_depth,
                             float max_weight, float prob_eps, float prob_hi,
                             void* stream) {
  if (rows > 0) {
    fuse_rows_kernel<<<rows, kVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        img, img_h, img_w, us, vs, zs, gate, pool_idx, count, num_blocks,
        tsdf, rgbw, prob, minabs, truncation, max_depth, max_weight, prob_eps,
        prob_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
