// The splat renderer's per-voxel projection in registers: the input stage
// of splat_zbuf_rows (K4) and splat_payload_rows (K5), splat_rows.cu.
//
// Replaces the [S, 512] u0 / v0 / dq planes that eager torch wrote for the
// kernels (render_fast.project_splat_rows, about 45 ops over every voxel
// of every surface row): the kernels read each row's block position, its
// pool index and the voxel's tsdf word in place from the pool, and
// project here.
//
// Op for op as render_fast.project_splat_rows computes it with torch on
// the card, so that the buffers stay bit-equal to the plain version:
//   - the world point ((block << 3) + offset) * voxel_size;
//   - SE3.apply_xyz's left-to-right order ((r0 x + r1 y) + r2 z) + t, one
//     rounding per op (the sources build with -fmad=false: nothing is
//     contracted into an FMA);
//   - uf = (fx xc + cx z) / z as an IEEE division, the pixel
//     round_half_away(uf) converted by cvt.rzi (__float2int_rz: saturating,
//     NaN to 0), as torch's .to(torch.int32) converts on CUDA;
//   - in the image, z > 0, z <= max_depth and |tsdf| < band_tsdf, the
//     Python scalars rounded to float32 as torch rounds a Python float
//     against a float32 tensor (the wrapper passes them as C floats);
//   - the range: torch takes the root of the float32 sum xc xc + yc yc +
//     z z in double and rounds it to float, which is the correctly rounded
//     float root (a double carries more than 2 x 24 + 2 bits, so the second
//     rounding cannot move it), so here __fsqrt_rn (the feature probe
//     checks the two agree on the card); 0 replaced by 1;
//     z_corr = z + ((tsdf trunc) z) / range; dq = clamp(z_corr 4096, 0,
//     2^29) truncated to int;
//   - the floor pixel (floor(uf), floor(vf)).
// Only a voxel in the surface band needs the range, the depth and the
// floor pixel, so the others stop after the tsdf test.  A band voxel has
// z > 0 and a pixel in the image, so its floor pixel is finite and at
// least -1: the z = 0 saturation of the conversion never reaches a merge.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplatVoxels = 512;
constexpr int kSplatWarps = kSplatVoxels / 32;
constexpr int kSplatBig = 1 << 30;

struct SplatPose {
  float r[9];  // rotation entries r00..r22, row-major
  float t[3];
};

struct SplatCamera {
  float fx, fy, cx, cy;
  int img_h, img_w;
};

struct SplatConsts {
  float voxel_size, truncation, max_depth, band_tsdf;
};

// one band voxel's merge inputs: floor pixel and quantized depth
struct SplatVoxel {
  int u0, v0, dq;  // dq = kSplatBig outside the surface band
};

__device__ __forceinline__ float splat_round_half_away(float x) {
  return x >= 0.f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

// Voxel t (x fastest in the 8x8x8 block) of the block at (bx, by, bz)
// whose tsdf word is `tsdf`.
__device__ __forceinline__ SplatVoxel splat_project(int bx, int by, int bz, int t, float tsdf,
                                                    const SplatPose& pose,
                                                    const SplatCamera& cam,
                                                    const SplatConsts& c) {
  SplatVoxel out{0, 0, kSplatBig};
  if (!(fabsf(tsdf) < c.band_tsdf)) return out;
  const float px = static_cast<float>((bx << 3) + (t & 7)) * c.voxel_size;
  const float py = static_cast<float>((by << 3) + ((t >> 3) & 7)) * c.voxel_size;
  const float pz = static_cast<float>((bz << 3) + (t >> 6)) * c.voxel_size;
  const float xc = pose.r[0] * px + pose.r[1] * py + pose.r[2] * pz + pose.t[0];
  const float yc = pose.r[3] * px + pose.r[4] * py + pose.r[5] * pz + pose.t[1];
  const float z = pose.r[6] * px + pose.r[7] * py + pose.r[8] * pz + pose.t[2];
  if (!(z > 0.f && z <= c.max_depth)) return out;
  const float uf = (cam.fx * xc + cam.cx * z) / z;
  const float vf = (cam.fy * yc + cam.cy * z) / z;
  const int u = __float2int_rz(splat_round_half_away(uf));
  const int v = __float2int_rz(splat_round_half_away(vf));
  if (!(u >= 0 && u < cam.img_w && v >= 0 && v < cam.img_h)) return out;
  const float sum = xc * xc + yc * yc + z * z;
  float rng = __fsqrt_rn(sum);
  if (rng == 0.f) rng = 1.f;
  const float z_corr = z + ((tsdf * c.truncation) * z) / rng;
  const float q = fminf(fmaxf(z_corr * 4096.f, 0.f), 536870912.f);  // 2^29
  out.u0 = __float2int_rz(floorf(uf));
  out.v0 = __float2int_rz(floorf(vf));
  out.dq = __float2int_rz(q);
  return out;
}

}  // namespace
