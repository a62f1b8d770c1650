// raycast: the parity raycaster, one thread a pixel.
//
// Replaces no TPU kernel: its counterpart is the JAX raycaster
// (disinfect_slam_tpu/ops/raycast.py:186, a lax.while_loop of XLA ops
// under jax.jit, no Pallas).  The port's plain version
// (ops/raycast.py:raycast_reference) marches every pixel in lockstep, with
// one read of the device a march step; this is the CUDA original's
// ray_cast_kernel (voxel_tsdf.cu:232-307) with the plain version's
// arithmetic: each thread takes its pixel's whole function and stops its
// march at its crossing (the lockstep march changes nothing of an
// inactive ray's prev, lo, hi or hit).
//
// Per pixel, op for op as the plain version computes it (-fmad=false: one
// IEEE rounding an operation; divisions and the float64 roots correctly
// rounded):
//   - the ray: intrinsics_inv.project of (u, v, 1), the norm (float32
//     squares added left to right, the root in float64 rounded once), the
//     direction rotated by world_T_cam's quaternion (v + 2 (w c + c'),
//     c = u x v, c' = u x c), times float32(step_size / voxel_size); the
//     origin world_T_cam.t / voxel_size;
//   - the march from step 1: each sample's voxel (round half away), its
//     tsdf (+1 in a missing block), the front-surface crossing test
//     (prev > 0, curr <= 0, prev - curr <= 1.5); in a missing block the
//     whole steps whose rounded sample stays in the block (or, dense, in
//     the empty 4x4x4-block superblock the table marks -3) are skipped
//     (skip_steps: IEEE divisions, the 1e-9 and 1e-4 guards as float32,
//     floor, clamped to max_step); the march ends at the crossing or at
//     max_step;
//   - refine_iters bisection steps, the voxel of the final midpoint, its
//     rgb and probability, the six-sample central-difference normal and
//     the diffuse shade, the semantic overlay and the u8 casts;
//   - the depth: the midpoint's range from the origin times voxel_size.
// The dense backend reads a block table (the superblock-augmented one
// when the march skips superblocks); the hash backend probes max_probe
// slots from the block's bucket (ops/hash.py: the reference's 3-prime
// hash in uint32 arithmetic) for the first live entry with the block's
// packed key.
//
// Layout: one CTA a tile of kTileW x kTileH pixels, so that neighbouring
// rays walk neighbouring blocks; the volume is read through the
// read-only path.  What bounds it: the longest ray's chain of dependent
// samples (each a table or probe load, then the voxel's load).  Where the
// caller asks (non-null pointers), the kernel also records its work: each
// ray's march samples, and which index entries and pool rows it read (a
// flag each), from which chip_smoke.py counts the bound.
//
// dst_raycast_chase is the order floor's probe, on no path: one thread
// following a cycle of indices through device memory, a dependent load a
// step.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 16;
constexpr int kTileH = 8;
constexpr int kSuperEmpty = -3;  // an empty cell of an empty superblock
constexpr float kDefaultTsdf = 1.0f;  // core/state.DEFAULT_TSDF
constexpr float kDefaultProb = 0.0f;  // core/state.DEFAULT_PROB

struct Params {
  const int* table;      // dense: [grid cells] block table (-3 folded in); hash: entry_block
  const int* keys;       // hash: [entries] packed block keys; dense: null
  const float* tsdf;     // [blocks][block volume]
  const int* rgbw;       // [blocks][block volume], packed r | g << 8 | b << 16 | w << 24
  const float* prob;     // [blocks][block volume]
  const float* pose;     // world_T_cam's slots: t at 9-11, q (w, x, y, z) at 12-15
  uchar4* rgba;          // [H][W] out
  uchar4* normal;        // [H][W] out
  float* depth;          // [H][W] out
  unsigned char* hit;    // [H][W] out
  int* samples;          // null, or [H][W] out: the ray's march samples
  unsigned char* cells;  // null, or [index entries]: 1 where an entry was read
  unsigned char* rows;   // null, or [blocks]: 1 where a pool row's tsdf was read
  float fxi, fyi, cxi, cyi;  // the inverse intrinsics
  float voxel;           // voxel size
  float step;            // float32(step_size / voxel_size)
  float max_step_f;      // float32(max_step)
  int max_step, refine, img_h, img_w;
  int bl;                // block_len_log2
  int hash, skip, super_blocks;
  int glog2, org_x, org_y, org_z;  // dense: the window
  int bucket_mask, epb_log2, entry_mask, max_probe, coord_bits;  // hash
};

__device__ __forceinline__ float round_half_away(float x) {
  return x >= 0.f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

// the norm of (x, y, z): float32 squares added left to right, the root in
// float64 rounded once
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return static_cast<float>(sqrt(static_cast<double>((x * x + y * y) + z * z)));
}

// the pool row of the block holding voxel p, or a negative code: -1 a
// missing block, -3 (dense, superblock table) a missing block in an empty
// superblock or outside the window
__device__ __forceinline__ int lookup(const Params& P, int px, int py, int pz) {
  const int bx = px >> P.bl, by = py >> P.bl, bz = pz >> P.bl;
  if (!P.hash) {
    const int g = 1 << P.glog2;
    const int x = bx - P.org_x, y = by - P.org_y, z = bz - P.org_z;
    if (x < 0 || x >= g || y < 0 || y >= g || z < 0 || z >= g) {
      return P.super_blocks ? kSuperEmpty : -1;
    }
    const int cell = (x << (2 * P.glog2)) | (y << P.glog2) | z;
    if (P.cells != nullptr) P.cells[cell] = 1;
    return __ldg(P.table + cell);
  }
  const unsigned h = (static_cast<unsigned>(bx) * 73856093u) ^
                     (static_cast<unsigned>(by) * 19349669u) ^
                     (static_cast<unsigned>(bz) * 83492791u);
  const int base = static_cast<int>(h & static_cast<unsigned>(P.bucket_mask)) << P.epb_log2;
  const unsigned off = 1u << (P.coord_bits - 1);
  const int key = static_cast<int>((static_cast<unsigned>(bx) + off) |
                                   ((static_cast<unsigned>(by) + off) << P.coord_bits) |
                                   ((static_cast<unsigned>(bz) + off) << (2 * P.coord_bits)));
  for (int k = 0; k < P.max_probe; ++k) {
    const int slot = (base + k) & P.entry_mask;
    if (P.cells != nullptr) P.cells[slot] = 1;
    const int pool = __ldg(P.table + slot);
    if (pool >= 0 && __ldg(P.keys + slot) == key) return pool;
  }
  return -1;
}

__device__ __forceinline__ size_t voxel_index(const Params& P, int pool, int px, int py, int pz) {
  const int m = (1 << P.bl) - 1;
  const int vi = (px & m) + ((py & m) << P.bl) + ((pz & m) << (2 * P.bl));
  return (static_cast<size_t>(pool) << (3 * P.bl)) + vi;
}

__device__ __forceinline__ float tsdf_at(const Params& P, int pool, int px, int py, int pz) {
  if (P.rows != nullptr) P.rows[pool] = 1;
  return __ldg(P.tsdf + voxel_index(P, pool, px, py, pz));
}

__device__ __forceinline__ float read_tsdf(const Params& P, int px, int py, int pz) {
  const int pool = lookup(P, px, py, pz);
  return pool >= 0 ? tsdf_at(P, pool, px, py, pz) : kDefaultTsdf;
}

// whole extra steps from pos whose rounded sample stays inside p's
// aligned 2^s-voxel region (raycast_reference's skip_steps)
__device__ __forceinline__ int skip_steps(const Params& P, const float (&pos)[3],
                                          const int (&p)[3], int s, const float (&d)[3]) {
  const float span = static_cast<float>(1 << s);
  float j = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float base = static_cast<float>((p[k] >> s) << s);
    const float safe_lo = (base - 0.5f) + 1e-4f;
    const float safe_hi = (base + (span - 0.5f)) - 1e-4f;
    const float dd = fabsf(d[k]) > 1e-9f ? d[k] : 1.0f;
    const float jh = d[k] > 1e-9f ? (safe_hi - pos[k]) / dd : INFINITY;
    const float jl = d[k] < -1e-9f ? (safe_lo - pos[k]) / dd : INFINITY;
    j = fminf(j, fminf(jh, jl));
  }
  const float f = fminf(fmaxf(floorf(j), 0.f), P.max_step_f);
  return static_cast<int>(f);
}

__device__ __forceinline__ unsigned char to_u8(float x) {
  return static_cast<unsigned char>(static_cast<int>(x));
}

__global__ void __launch_bounds__(kTileW * kTileH) raycast_kernel(Params P) {
  const int u = blockIdx.x * kTileW + threadIdx.x;
  const int v = blockIdx.y * kTileH + threadIdx.y;
  if (u >= P.img_w || v >= P.img_h) return;
  const size_t pix = static_cast<size_t>(v) * P.img_w + u;

  // the ray: intrinsics_inv.project(u, v, 1), normalised, rotated
  const float cx_ = P.fxi * static_cast<float>(u) + P.cxi * 1.0f;
  const float cy_ = P.fyi * static_cast<float>(v) + P.cyi * 1.0f;
  const float cz_ = 1.0f;
  const float n = norm3(cx_, cy_, cz_);
  const float vx = cx_ / n, vy = cy_ / n, vz = cz_ / n;
  const float w = __ldg(P.pose + 12), ux = __ldg(P.pose + 13), uy = __ldg(P.pose + 14),
              uz = __ldg(P.pose + 15);
  const float c0 = uy * vz - uz * vy, c1 = uz * vx - ux * vz, c2 = ux * vy - uy * vx;
  const float e0 = uy * c2 - uz * c1, e1 = uz * c0 - ux * c2, e2 = ux * c1 - uy * c0;
  const float dir[3] = {vx + 2.0f * (w * c0 + e0), vy + 2.0f * (w * c1 + e1),
                        vz + 2.0f * (w * c2 + e2)};
  const float d[3] = {dir[0] * P.step, dir[1] * P.step, dir[2] * P.step};
  const float o[3] = {__ldg(P.pose + 9) / P.voxel, __ldg(P.pose + 10) / P.voxel,
                      __ldg(P.pose + 11) / P.voxel};

  // the march
  float prev = read_tsdf(P, static_cast<int>(round_half_away(o[0])),
                         static_cast<int>(round_half_away(o[1])),
                         static_cast<int>(round_half_away(o[2])));
  bool hit = false;
  float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
  int i = 1, samples = 0;
  do {
    ++samples;
    const float fi = static_cast<float>(i);
    const float pos[3] = {o[0] + d[0] * fi, o[1] + d[1] * fi, o[2] + d[2] * fi};
    const int p[3] = {static_cast<int>(round_half_away(pos[0])),
                      static_cast<int>(round_half_away(pos[1])),
                      static_cast<int>(round_half_away(pos[2]))};
    const int pool = lookup(P, p[0], p[1], p[2]);
    const float curr = pool >= 0 ? tsdf_at(P, pool, p[0], p[1], p[2]) : kDefaultTsdf;
    // front-surface crossing (voxel_tsdf.cu:260)
    if (prev > 0.f && curr <= 0.f && prev - curr <= 1.5f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = pos[k] - d[k];
        hi[k] = pos[k];
      }
      hit = true;
      break;
    }
    prev = curr;
    int adv = 1;
    if (P.skip && pool < 0) {
      adv += skip_steps(P, pos, p, pool == kSuperEmpty && P.super_blocks ? P.bl + 2 : P.bl, d);
    }
    i += adv;
  } while (i < P.max_step);
  if (P.samples != nullptr) P.samples[pix] = samples;

  if (!hit) {
    P.rgba[pix] = make_uchar4(0, 0, 0, 0);
    P.normal[pix] = make_uchar4(0, 0, 0, 0);
    P.depth[pix] = 0.f;
    P.hit[pix] = 0;
    return;
  }

  // binary refinement (voxel_tsdf.cu:265-274)
  float mid[3] = {(lo[0] + hi[0]) * 0.5f, (lo[1] + hi[1]) * 0.5f, (lo[2] + hi[2]) * 0.5f};
  for (int r = 0; r < P.refine; ++r) {
    const bool neg = read_tsdf(P, static_cast<int>(round_half_away(mid[0])),
                               static_cast<int>(round_half_away(mid[1])),
                               static_cast<int>(round_half_away(mid[2]))) < 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (neg) {
        hi[k] = mid[k];
      } else {
        lo[k] = mid[k];
      }
      mid[k] = (lo[k] + hi[k]) * 0.5f;
    }
  }
  const int f0 = static_cast<int>(round_half_away(mid[0]));
  const int f1 = static_cast<int>(round_half_away(mid[1]));
  const int f2 = static_cast<int>(round_half_away(mid[2]));
  const int pool = lookup(P, f0, f1, f2);
  float rgb[3] = {0.f, 0.f, 0.f}, prob = kDefaultProb;
  if (pool >= 0) {
    const size_t at = voxel_index(P, pool, f0, f1, f2);
    const int rw = __ldg(P.rgbw + at);
    rgb[0] = static_cast<float>(rw & 0xFF);
    rgb[1] = static_cast<float>((rw >> 8) & 0xFF);
    rgb[2] = static_cast<float>((rw >> 16) & 0xFF);
    prob = __ldg(P.prob + at);
  }

  // central-difference normal (voxel_tsdf.cu:280-291) and the diffuse shade
  const float n0 = read_tsdf(P, f0 + 1, f1, f2) - read_tsdf(P, f0 - 1, f1, f2);
  const float n1 = read_tsdf(P, f0, f1 + 1, f2) - read_tsdf(P, f0, f1 - 1, f2);
  const float n2 = read_tsdf(P, f0, f1, f2 + 1) - read_tsdf(P, f0, f1, f2 - 1);
  float nrm = norm3(n0, n1, n2);
  nrm = nrm == 0.f ? 1.0f : nrm;
  const float dot = (n0 * -dir[0] + n1 * -dir[1]) + n2 * -dir[2];
  const float diffusivity = fmaxf(dot / nrm, 0.f);

  // semantic overlay (voxel_tsdf.cu:293-299)
  const float alpha = fmaxf(prob - 0.5f, 0.f) / 0.5f;
  const float shade = diffusivity * 255.0f;
  const float ng = (1.0f - alpha) * shade;
  P.rgba[pix] = make_uchar4(to_u8(alpha * 255.0f + (1.0f - alpha) * rgb[0]),
                            to_u8((1.0f - alpha) * rgb[1]), to_u8((1.0f - alpha) * rgb[2]), 255);
  P.normal[pix] = make_uchar4(to_u8(alpha * 255.0f + ng), to_u8(ng), to_u8(ng), 255);
  // hit depth along the ray (world metres)
  P.depth[pix] = norm3(mid[0] - o[0], mid[1] - o[1], mid[2] - o[2]) * P.voxel;
  P.hit[pix] = 1;
}

// the order floor's probe: `steps` dependent loads i = next[i] by one
// thread, from i = start
__global__ void chase_kernel(const int* __restrict__ next, int start, int steps, int* out) {
  int i = start;
  for (int k = 0; k < steps; ++k) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

extern "C" int dst_raycast(const int* table, const int* keys, const float* tsdf, const int* rgbw,
                           const float* prob, const float* pose, const float* scalars,
                           const int* ints, void* rgba, void* normal, float* depth,
                           unsigned char* hit, int* samples, unsigned char* cells,
                           unsigned char* rows, void* stream) {
  Params P;
  P.table = table;
  P.keys = keys;
  P.tsdf = tsdf;
  P.rgbw = rgbw;
  P.prob = prob;
  P.pose = pose;
  P.rgba = static_cast<uchar4*>(rgba);
  P.normal = static_cast<uchar4*>(normal);
  P.depth = depth;
  P.hit = hit;
  P.samples = samples;
  P.cells = cells;
  P.rows = rows;
  P.fxi = scalars[0];
  P.fyi = scalars[1];
  P.cxi = scalars[2];
  P.cyi = scalars[3];
  P.voxel = scalars[4];
  P.step = scalars[5];
  P.max_step_f = scalars[6];
  P.max_step = ints[0];
  P.refine = ints[1];
  P.img_h = ints[2];
  P.img_w = ints[3];
  P.bl = ints[4];
  P.hash = ints[5];
  P.skip = ints[6];
  P.super_blocks = ints[7];
  P.glog2 = ints[8];
  P.org_x = ints[9];
  P.org_y = ints[10];
  P.org_z = ints[11];
  P.bucket_mask = ints[12];
  P.epb_log2 = ints[13];
  P.entry_mask = ints[14];
  P.max_probe = ints[15];
  P.coord_bits = ints[16];
  if (P.img_h <= 0 || P.img_w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P.img_w + kTileW - 1) / kTileW, (P.img_h + kTileH - 1) / kTileH);
  raycast_kernel<<<grid, dim3(kTileW, kTileH), 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The order floor's probe (not on any path): one thread, `steps` dependent
// loads through next (a cycle of indices in device memory) from `start`.
extern "C" int dst_raycast_chase(const int* next, int start, int steps, int* out,
                                 void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}
