// raycast: the parity raycaster, one thread a pixel, in persistent CTAs.
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
//     an empty 4x4x4-block superblock) are skipped (skip_steps: IEEE
//     divisions, the 1e-9 and 1e-4 guards as float32, floor, clamped to
//     max_step); the march ends at the crossing or at max_step;
//   - refine_iters bisection steps, the voxel of the final midpoint, its
//     rgb and probability, the six-sample central-difference normal and
//     the diffuse shade, the semantic overlay and the u8 casts;
//   - the depth: the midpoint's range from the origin times voxel_size.
//
// The index.  A block's code is its pool row, -1 for a missing block or
// -3 for a missing block in an empty superblock or outside the window:
// exactly ops/raycast.py:superblock_table's values, without the table.
// The dense backend reads the block table and, when the march skips
// superblocks, one occupancy bit a superblock (csrc/raycast_bits.cu,
// launched before this kernel in the same step): a clear bit is -3 with
// no load of the table; otherwise the cell is read and any negative value
// is -1 (between renders the table holds -1 or rows; allocation's claim
// codes exist only while it runs).  The hash backend probes max_probe
// slots from the block's bucket (ops/hash.py: the reference's 3-prime
// hash in uint32 arithmetic) for the first live entry with the block's
// packed key.  Each thread keeps its last block's coordinates and code in
// registers: a sample, a bisection step or a normal tap in the same block
// reuses them (the index does not change during a render, so no bit of
// the image does).
//
// The design, against the chain of dependent loads along a ray:
//   - the bits live in shared memory: each CTA copies them in once (one
//     cp.async.bulk, completing on an mbarrier), so a sample in an empty
//     superblock makes no global load.  Up to kBitsSmemBudget (32 KB at
//     grid_log2 = 8; 256 KB at 9 would not fit an SM) this is the layout;
//     above it the bits are read through __ldg (the device-memory layout,
//     also forced by the caller for an A/B);
//   - the last block's lookup in registers: a sample in the block of the
//     one before costs one load (its voxel), not two;
//   - persistent CTAs and dynamic tiles: as many CTAs of kThreads as the
//     card holds at once, each warp taking its next kTileW x kTileH tile
//     from a device counter (zeroed by a memset before the launch, a node
//     of the captured step), so a warp that drew short rays takes another
//     tile instead of holding its CTA's slot;
//   - fewer instructions a sample, each with the plain version's result:
//     skip_steps takes one IEEE division an axis, not two (the other is
//     +inf); a voxel's int is one add and a truncation (round_to_int); the
//     window test is unsigned; pool offsets are 32-bit.
// What bounds it on the H100 (PERF.md, scripts/port_raycast_variants.py):
// not that chain but the instructions a warp issues, both sides of each
// divergent branch: more resident warps (40 registers a thread, or 32)
// made it slower, the bits' layout and the launch geometry moved it by a
// few percent, the instruction cuts above by 13%.  512-thread CTAs at
// most 64 registers a thread (48: two CTAs, 32 warps an SM) were the
// fastest shape measured.
// Where the caller asks (non-null pointers), the kernel also records its
// work: each ray's march samples and its dependent global loads, and which
// index entries and pool rows it read (a flag each), from which
// chip_smoke.py counts the bound and the order floor.
//
// dst_raycast_chase is the order floor's probe, on no path: one thread
// following a cycle of indices through device memory, a dependent load a
// step.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 512;           // a CTA
constexpr int kMinCtas = 2;             // resident an SM: at most 64 registers a thread
constexpr int kTileW = 8, kTileH = 4;   // a warp's tile of pixels
// the tiles are numbered region by region, kRegionW x kRegionH tiles a
// region (32x16 pixels), so that warps taking consecutive tiles march
// neighbouring rays
constexpr int kRegionW = 4, kRegionH = 4;
constexpr int kRegionTiles = kRegionW * kRegionH;
constexpr int kBitsSmemBudget = 48 * 1024;  // ops/cuda/raycast_kernel.BITS_SMEM_BUDGET
constexpr int kMissing = -1;
constexpr int kSuperEmpty = -3;  // a missing block in an empty superblock or outside the window
constexpr float kDefaultTsdf = 1.0f;  // core/state.DEFAULT_TSDF
constexpr float kDefaultProb = 0.0f;  // core/state.DEFAULT_PROB

struct Params {
  const int* table;      // dense: [grid cells] block table; hash: entry_block
  const int* keys;       // hash: [entries] packed block keys; dense: null
  const unsigned* bits;  // dense with superblocks: [words] occupancy bits; else null
  const float* tsdf;     // [blocks][block volume]
  const int* rgbw;       // [blocks][block volume], packed r | g << 8 | b << 16 | w << 24
  const float* prob;     // [blocks][block volume]
  const float* pose;     // world_T_cam's slots: t at 9-11, q (w, x, y, z) at 12-15
  int* tile_counter;     // [1], 0 at the launch
  uchar4* rgba;          // [H][W] out
  uchar4* normal;        // [H][W] out
  float* depth;          // [H][W] out
  unsigned char* hit;    // [H][W] out
  // the record of the work: all four, or all null
  int* samples;          // [H][W] out: the ray's march samples
  unsigned char* cells;  // [index entries]: 1 where an entry was read
  unsigned char* rows;   // [blocks]: 1 where a pool row's tsdf was read
  int* loads;            // [H][W] out: the ray's dependent global loads
  float fxi, fyi, cxi, cyi;  // the inverse intrinsics
  float voxel;           // voxel size
  float step;            // float32(step_size / voxel_size)
  float max_step_f;      // float32(max_step)
  int max_step, refine, img_h, img_w;
  int bl;                // block_len_log2
  int hash, skip, super_blocks;
  int glog2, org_x, org_y, org_z;  // dense: the window
  int bucket_mask, epb_log2, entry_mask, max_probe, coord_bits;  // hash
  int bits_bytes;        // the bits' bytes (a multiple of 16)
  int regions_x, n_tiles;  // regions a row; tiles of all the regions
};

// the last block a thread looked up (bl >= 1, so no block coordinate is
// INT_MIN and the first lookup always loads)
struct LastBlock {
  int bx = INT_MIN, by = INT_MIN, bz = INT_MIN, code = kMissing;
};

// the int of round half away from zero: the plain version's floor(x + 0.5)
// for x >= 0 and ceil(x - 0.5) below, each the truncation of the same
// rounded sum (-0.0 gives 0 either way)
__device__ __forceinline__ int round_to_int(float x) {
  return __float2int_rz(x + copysignf(0.5f, x));
}

// the norm of (x, y, z): float32 squares added left to right, the root in
// float64 rounded once
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return static_cast<float>(sqrt(static_cast<double>((x * x + y * y) + z * z)));
}

// block (bx, by, bz)'s code: its pool row, kMissing or kSuperEmpty;
// `loads` counts its global loads, each waiting for the one before
template <bool kSmemBits>
__device__ __forceinline__ int block_code(const Params& P, const unsigned* sbits, int bx, int by,
                                          int bz, int& loads) {
  if (!P.hash) {
    const int g = 1 << P.glog2;
    const int x = bx - P.org_x, y = by - P.org_y, z = bz - P.org_z;
    if (static_cast<unsigned>(x) >= static_cast<unsigned>(g) ||
        static_cast<unsigned>(y) >= static_cast<unsigned>(g) ||
        static_cast<unsigned>(z) >= static_cast<unsigned>(g)) {
      return P.super_blocks ? kSuperEmpty : kMissing;
    }
    if (P.super_blocks) {
      const int sl = P.glog2 - 2;
      const int sb = ((x >> 2) << (2 * sl)) | ((y >> 2) << sl) | (z >> 2);
      unsigned word;
      if (kSmemBits) {
        word = sbits[sb >> 5];
      } else {
        word = __ldg(P.bits + (sb >> 5));
        ++loads;
      }
      if (((word >> (sb & 31)) & 1u) == 0) return kSuperEmpty;
    }
    const int cell = (x << (2 * P.glog2)) | (y << P.glog2) | z;
    if (P.cells != nullptr) P.cells[cell] = 1;
    ++loads;
    const int pool = __ldg(P.table + cell);
    return pool >= 0 ? pool : kMissing;
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
    ++loads;  // the slot's entry and key, loaded together
    const int pool = __ldg(P.table + slot);
    const int slot_key = __ldg(P.keys + slot);
    if (pool >= 0 && slot_key == key) return pool;
  }
  return kMissing;
}

// the code of the block holding voxel p, from the last block's when p
// lies in it (`loads` counts the index loads it makes)
template <bool kSmemBits>
__device__ __forceinline__ int lookup(const Params& P, const unsigned* sbits, LastBlock& last,
                                      int& loads, int px, int py, int pz) {
  const int bx = px >> P.bl, by = py >> P.bl, bz = pz >> P.bl;
  if (bx != last.bx || by != last.by || bz != last.bz) {
    last.bx = bx;
    last.by = by;
    last.bz = bz;
    last.code = block_code<kSmemBits>(P, sbits, bx, by, bz, loads);
  }
  return last.code;
}

// a pool row's voxel (the pool holds under 2^31 voxels: the wrapper checks)
__device__ __forceinline__ int voxel_index(const Params& P, int pool, int px, int py, int pz) {
  const int m = (1 << P.bl) - 1;
  const int vi = (px & m) + ((py & m) << P.bl) + ((pz & m) << (2 * P.bl));
  return (pool << (3 * P.bl)) + vi;
}

__device__ __forceinline__ float tsdf_at(const Params& P, int pool, int px, int py, int pz) {
  if (P.rows != nullptr) P.rows[pool] = 1;
  return __ldg(P.tsdf + voxel_index(P, pool, px, py, pz));
}

// the tsdf at voxel p (+1 in a missing block); `index` counts the index
// loads, `voxels` the voxel loads
template <bool kSmemBits>
__device__ __forceinline__ float read_tsdf(const Params& P, const unsigned* sbits, LastBlock& last,
                                           int& index, int& voxels, int px, int py, int pz) {
  const int pool = lookup<kSmemBits>(P, sbits, last, index, px, py, pz);
  if (pool < 0) return kDefaultTsdf;
  ++voxels;
  return tsdf_at(P, pool, px, py, pz);
}

// one of the shading's reads: they wait for the bisection, not for each
// other, so the ray's chain grows by the longest lookup among them
// (`longest`) and one voxel load
template <bool kSmemBits>
__device__ __forceinline__ float tap(const Params& P, const unsigned* sbits, LastBlock& last,
                                     int& longest, int& voxels, int px, int py, int pz) {
  int index = 0;
  const float t = read_tsdf<kSmemBits>(P, sbits, last, index, voxels, px, py, pz);
  longest = max(longest, index);
  return t;
}

// whole extra steps from pos whose rounded sample stays inside p's
// aligned 2^s-voxel region (raycast_reference's skip_steps).  The plain
// version takes min(jh, jl) of an axis, at most one of them finite (the
// other +inf, and neither NaN: pos is finite, d is not 0): the kernel
// computes that one, one IEEE division an axis
__device__ __forceinline__ int skip_steps(const Params& P, const float (&pos)[3],
                                          const int (&p)[3], int s, const float (&d)[3]) {
  const float span = static_cast<float>(1 << s);
  float j = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (fabsf(d[k]) > 1e-9f) {
      const float base = static_cast<float>((p[k] >> s) << s);
      const float bound = d[k] > 1e-9f ? (base + (span - 0.5f)) - 1e-4f   // safe_hi
                                       : (base - 0.5f) + 1e-4f;          // safe_lo
      j = fminf(j, (bound - pos[k]) / d[k]);
    }
  }
  const float f = fminf(fmaxf(floorf(j), 0.f), P.max_step_f);
  return static_cast<int>(f);
}

__device__ __forceinline__ unsigned char to_u8(float x) {
  return static_cast<unsigned char>(static_cast<int>(x));
}

// pixel (u, v)'s whole function
template <bool kSmemBits>
__device__ __forceinline__ void render_pixel(const Params& P, const unsigned* sbits, int u, int v) {
  const size_t pix = static_cast<size_t>(v) * P.img_w + u;
  LastBlock last;
  // the ray's dependent global loads: the march's and the bisection's
  // each wait for the one before (a sample's step follows its index code,
  // the march's end its tsdf)
  int chain = 0;

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
  float prev = read_tsdf<kSmemBits>(P, sbits, last, chain, chain,
                                    round_to_int(o[0]),
                                    round_to_int(o[1]),
                                    round_to_int(o[2]));
  bool hit = false;
  float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
  int i = 1, samples = 0;
  do {
    ++samples;
    const float fi = static_cast<float>(i);
    const float pos[3] = {o[0] + d[0] * fi, o[1] + d[1] * fi, o[2] + d[2] * fi};
    const int p[3] = {round_to_int(pos[0]),
                      round_to_int(pos[1]),
                      round_to_int(pos[2])};
    const int pool = lookup<kSmemBits>(P, sbits, last, chain, p[0], p[1], p[2]);
    float curr = kDefaultTsdf;
    if (pool >= 0) {
      ++chain;
      curr = tsdf_at(P, pool, p[0], p[1], p[2]);
    }
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
    if (P.loads != nullptr) P.loads[pix] = chain;
    return;
  }

  // binary refinement (voxel_tsdf.cu:265-274)
  float mid[3] = {(lo[0] + hi[0]) * 0.5f, (lo[1] + hi[1]) * 0.5f, (lo[2] + hi[2]) * 0.5f};
  for (int r = 0; r < P.refine; ++r) {
    const bool neg = read_tsdf<kSmemBits>(P, sbits, last, chain, chain,
                                          round_to_int(mid[0]),
                                          round_to_int(mid[1]),
                                          round_to_int(mid[2])) < 0.f;
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
  const int f0 = round_to_int(mid[0]);
  const int f1 = round_to_int(mid[1]);
  const int f2 = round_to_int(mid[2]);
  int longest = 0, voxels = 0;
  const int pool = lookup<kSmemBits>(P, sbits, last, longest, f0, f1, f2);
  float rgb[3] = {0.f, 0.f, 0.f}, prob = kDefaultProb;
  if (pool >= 0) {
    const int at = voxel_index(P, pool, f0, f1, f2);
    ++voxels;
    const int rw = __ldg(P.rgbw + at);
    rgb[0] = static_cast<float>(rw & 0xFF);
    rgb[1] = static_cast<float>((rw >> 8) & 0xFF);
    rgb[2] = static_cast<float>((rw >> 16) & 0xFF);
    prob = __ldg(P.prob + at);
  }

  // central-difference normal (voxel_tsdf.cu:280-291) and the diffuse shade
  const float n0 = tap<kSmemBits>(P, sbits, last, longest, voxels, f0 + 1, f1, f2) -
                   tap<kSmemBits>(P, sbits, last, longest, voxels, f0 - 1, f1, f2);
  const float n1 = tap<kSmemBits>(P, sbits, last, longest, voxels, f0, f1 + 1, f2) -
                   tap<kSmemBits>(P, sbits, last, longest, voxels, f0, f1 - 1, f2);
  const float n2 = tap<kSmemBits>(P, sbits, last, longest, voxels, f0, f1, f2 + 1) -
                   tap<kSmemBits>(P, sbits, last, longest, voxels, f0, f1, f2 - 1);
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
  if (P.loads != nullptr) P.loads[pix] = chain + longest + (voxels > 0 ? 1 : 0);
}

// the warp's next tile from the device counter: region t / kRegionTiles,
// tile t % kRegionTiles of it
__device__ __forceinline__ int next_tile(const Params& P, int lane) {
  int t = 0;
  if (lane == 0) t = atomicAdd(P.tile_counter, 1);
  return __shfl_sync(0xffffffffu, t, 0);
}

template <bool kSmemBits>
__global__ void __launch_bounds__(kThreads, kMinCtas) raycast_kernel(Params P) {
  extern __shared__ __align__(16) unsigned sbits[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x & 31;
  if (kSmemBits) {
    if (threadIdx.x == 0) {
      mbar_init(&bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&bar, static_cast<uint32_t>(P.bits_bytes));
      bulk_load(sbits, P.bits, static_cast<uint32_t>(P.bits_bytes), &bar);
    }
  }
  // the first tile's round trip overlaps the copy; every thread waits for
  // the bits (so none leaves while the copy is in flight)
  int t = next_tile(P, lane);
  if (kSmemBits) mbar_wait(&bar, 0);
  while (t < P.n_tiles) {
    const int region = t / kRegionTiles, tile = t % kRegionTiles;
    const int tx = (region % P.regions_x) * kRegionW + tile % kRegionW;
    const int ty = (region / P.regions_x) * kRegionH + tile / kRegionW;
    const int u = tx * kTileW + lane % kTileW, v = ty * kTileH + lane / kTileW;
    if (u < P.img_w && v < P.img_h) render_pixel<kSmemBits>(P, sbits, u, v);
    t = next_tile(P, lane);
  }
}

// the order floor's probe: `steps` dependent loads i = next[i] by one
// thread, from i = start
__global__ void chase_kernel(const int* __restrict__ next, int start, int steps, int* out) {
  int i = start;
  for (int k = 0; k < steps; ++k) i = __ldcg(next + i);
  *out = i;
}

using Kernel = void (*)(Params);

Kernel kernel_for(int bits_shared) {
  return bits_shared ? raycast_kernel<true> : raycast_kernel<false>;
}

// CTAs of the kernel resident on an SM, and the SMs of the current device
int resident(Kernel kernel, int smem, int* sms) {
  int device = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return per_sm;
}

}  // namespace

// bits: null, or the [bits_words] occupancy bits (csrc/raycast_bits.cu),
// read from shared memory where bits_shared is 1 (bits_words * 4 bytes,
// at most kBitsSmemBudget); tile_counter: int32 [1] scratch.
extern "C" int dst_raycast(const int* table, const int* keys, const unsigned* bits,
                           const float* tsdf, const int* rgbw, const float* prob,
                           const float* pose, const float* scalars, const int* ints,
                           int bits_words, int bits_shared, int* tile_counter, void* rgba,
                           void* normal, float* depth, unsigned char* hit, int* samples,
                           unsigned char* cells, unsigned char* rows, int* loads,
                           void* stream) {
  Params P;
  P.table = table;
  P.keys = keys;
  P.bits = bits;
  P.tsdf = tsdf;
  P.rgbw = rgbw;
  P.prob = prob;
  P.pose = pose;
  P.tile_counter = tile_counter;
  P.rgba = static_cast<uchar4*>(rgba);
  P.normal = static_cast<uchar4*>(normal);
  P.depth = depth;
  P.hit = hit;
  P.samples = samples;
  P.cells = cells;
  P.rows = rows;
  P.loads = loads;
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
  P.bits_bytes = bits_words * 4;
  const int tiles_x = (P.img_w + kTileW - 1) / kTileW, tiles_y = (P.img_h + kTileH - 1) / kTileH;
  P.regions_x = (tiles_x + kRegionW - 1) / kRegionW;
  const int regions = P.regions_x * ((tiles_y + kRegionH - 1) / kRegionH);
  P.n_tiles = regions * kRegionTiles;
  const bool want_bits = !P.hash && P.super_blocks;
  if (P.img_h <= 0 || P.img_w <= 0 || P.bl < 1 || want_bits != (bits != nullptr) ||
      (want_bits && (P.glog2 < 3 || bits_words < ((1 << (3 * (P.glog2 - 2))) + 31) / 32)) ||
      (bits_shared && (!want_bits || P.bits_bytes % 16 != 0 ||
                       P.bits_bytes > kBitsSmemBudget ||
                       (reinterpret_cast<uintptr_t>(bits) & 15) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool record = samples != nullptr;
  if (record != (cells != nullptr) || record != (rows != nullptr) ||
      record != (loads != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = kernel_for(bits_shared);
  const int smem = bits_shared ? P.bits_bytes : 0;
  int sms = 0;
  const int per_sm = resident(kernel, smem, &sms);
  const int warps = kThreads / 32;
  // persistent CTAs, as many as are resident at once, each warp taking
  // its next tile from the device counter
  const int grid = max(1, min(max(per_sm, 1) * max(sms, 1), (P.n_tiles + warps - 1) / warps));
  cudaError_t err = cudaMemsetAsync(tile_counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape on the current device for a layout: out[0] CTAs
// resident an SM, [1] threads a CTA, [2] dynamic shared memory a CTA
// (bytes), [3] registers a thread, [4] static shared memory (bytes), [5]
// SMs, [6] the pixels of a warp's tile.
extern "C" int dst_raycast_shape(int bits_shared, int bits_words, int* out) {
  const Kernel kernel = kernel_for(bits_shared);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = bits_shared ? bits_words * 4 : 0;
  int sms = 0;
  out[0] = resident(kernel, smem, &sms);
  out[1] = kThreads;
  out[2] = smem;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  out[5] = sms;
  out[6] = kTileW * kTileH;
  return static_cast<int>(cudaGetLastError());
}

// The order floor's probe (not on any path): one thread, `steps` dependent
// loads through next (a cycle of indices in device memory) from `start`.
extern "C" int dst_raycast_chase(const int* next, int start, int steps, int* out,
                                 void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}
