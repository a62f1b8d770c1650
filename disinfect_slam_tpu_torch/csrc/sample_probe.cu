// Hopper probes of the frame sampler (K1, sample_rows.cu) and of the
// stages of fuse_rows (K2): the counterparts of the TPU probes
// scripts/probe_sample2.py, probe_sample3.py, probe_sample4.py (P1-P3),
// probe_sample_overhead.py (P4), probe_kernel_stages.py (P5) and
// probe_mxu_shapes.py (P6), run by ops/cuda/sample_probe.py.
//
// P4 split K1's time into its pixel loads and its writes.  Here:
// sample_direct_kernel<mode>, K1's body (kFull), its pixel loads with one
// word written per voxel (kLoadsOnly: the xor of the pixel's eight words)
// and its writes without a pixel load (kWritesOnly).
//
// P1, P2 and P6 tuned the TPU's patch selection (blocks per grid step, the
// patch layout, the one-hot matmul shapes); P3 selected through exact
// one-hot matmuls on the MXU, the TPU's stand-in for a gather.  All four
// compute the exact samples of each block's aligned PH x PW window (origin
// the block's lowest in-image pixel, rounded down to 16 columns and 8 rows,
// clipped into the image, as ops/pallas/sample_kernel.py aligns it): a
// voxel in the image but outside the window comes back invalid and is
// counted (the TPU's sampler_skipped: voxels, and rows with any).
//
// Here sample_patch_kernel<PH, PW, Slots> (24x32 and 48x64; P3 is the
// 24x32 one at 4 rows a CTA: on Hopper the gather is a shared-memory load,
// and the one-hot form's 4096 int8 mma.sync a row would cost 37.5% of the
// byte bound alone).  What bounds it is the bytes moved: staging a whole
// window, one bulk copy a window row, moved 98 KB a row at 48x64 from L2
// and held L2-bound with no overlap.  So each row first reduces its
// voxels inside the window to their box (min and max of lu = u - u0 and
// lv = v - v0, by warp reductions), and only the box is staged, one bulk
// copy a box row (a pixel is 32 B, so every width meets the copy's
// 16-byte rule), through a ring of slots of slot_bytes each: with two
// slots the copy of the CTA's next strip or row is issued before the
// current one is selected, and the pixels of the row after next load
// meanwhile.  A box taller than a slot holds is staged in strips of box
// rows, one ring turn each, and each voxel selects in the strip that holds
// its row.  Each slot has its own mbarrier, armed by one producer (warp 0)
// a round, and the turn's parity is its round; a row with an empty box
// stages nothing and waits on nothing.  rows_per_cta consecutive rows a
// CTA (1, 4, 16: P1's batching) walk one ring; a CTA of one row has no next
// row to overlap and takes a one-slot ring, so more of them fit an SM.
// The row's box reduction is the one barrier a row in steady state: it
// also frees the slot the row before read.  256 threads of two voxels
// each: the registers of one voxel a thread at 512 threads a CTA left two
// CTAs an SM, and spilling to fit more was slower still.
//
// P5 attributed the TPU kernel's time to its stages.  Here:
// fuse_rows_kernel<kStage> (fuse_rows.cuh) stripped to the ring of pool
// rows (0), with the projection (1), with the frame sampling (2), each
// writing back unchanged the pool words of the voxels it lets through;
// the fusion (3) is fuse_rows itself, built in fuse_rows.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "fuse_rows.cuh"

namespace {

constexpr int kFull = 0, kLoadsOnly = 1, kWritesOnly = 2;

template <int Mode>
__global__ void __launch_bounds__(kVoxels) sample_direct_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ count, int rows,
    float* __restrict__ out, uint8_t* __restrict__ valid, uint32_t* __restrict__ words) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const size_t vi = static_cast<size_t>(row) * kVoxels + threadIdx.x;
  const int u = us[vi];
  const int v = vs[vi];
  const bool ok = u >= 0 && u < img_w && v >= 0 && v < img_h;
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
  if constexpr (Mode == kWritesOnly) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = ok ? static_cast<float>(c) : 0.f;
    valid[vi] = ok;
  } else {
    const int uc = min(max(u, 0), img_w - 1);
    const int vc = min(max(v, 0), img_h - 1);
    const float4* px = reinterpret_cast<const float4*>(
        img + (static_cast<size_t>(vc) * img_w + uc) * kChannels);
    const float4 a = __ldg(px);
    const float4 b = __ldg(px + 1);
    if constexpr (Mode == kFull) {
      const float s[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = ok ? s[c] : 0.f;
      valid[vi] = ok;
    } else {
      const uint32_t x = __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^
                         __float_as_uint(a.w) ^ __float_as_uint(b.x) ^ __float_as_uint(b.y) ^
                         __float_as_uint(b.z) ^ __float_as_uint(b.w);
      words[vi] = ok ? x : 0u;
    }
  }
}

// a row's box, packed as bytes: min lu, min lv, 255 - max lu, 255 - max lv
// over the voxels inside the window (a byte-wise minimum); kEmptyBox for none
constexpr uint32_t kEmptyBox = 0xFFFFFFFFu;
// 256 threads of two voxels each (voxels t and t + 256 of a row).  A CTA
// of several rows has a ring of two slots (four CTAs an SM at 24,576 B a
// slot, at most 64 registers); a CTA of one row takes one slot (five CTAs
// an SM, at most 48 registers: fewer spill, and spilling costs more than
// the CTAs gain)
constexpr int kPatchThreads = 256, kRingCtas = 4, kOneRowCtas = 5;
constexpr int kPer = kVoxels / kPatchThreads, kPatchWarps = kPatchThreads / 32;

__device__ __forceinline__ uint32_t warp_min_bytes(uint32_t w) {
  const unsigned all = 0xFFFFFFFFu;
  return __reduce_min_sync(all, w & 0xFFu) | __reduce_min_sync(all, (w >> 8) & 0xFFu) << 8 |
         __reduce_min_sync(all, (w >> 16) & 0xFFu) << 16 | __reduce_min_sync(all, w >> 24) << 24;
}

// a row's box in its window at (u0, v0) from this thread's pixels (u, v)
// of it, the same in every thread (one __syncthreads; red: this row's
// [kPatchWarps] scratch); `skip` gets the row's voxels in the image but
// outside the window (in every thread)
template <int PH, int PW>
__device__ __forceinline__ uint32_t row_box(const int (&u)[kPer], const int (&v)[kPer], int u0,
                                            int v0, int img_h, int img_w, int2* red,
                                            int& skip) {
  const int lane = threadIdx.x & 31;
  uint32_t w = kEmptyBox;
  unsigned sk = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int lu = u[j] - u0, lv = v[j] - v0;
    const bool in_patch = lu >= 0 && lu < PW && lv >= 0 && lv < PH;
    const bool in_img = u[j] >= 0 && u[j] < img_w && v[j] >= 0 && v[j] < img_h;
    if (in_patch)
      w = __vminu4(w, static_cast<uint32_t>(lu | lv << 8 | (255 - lu) << 16 | (255 - lv) << 24));
    sk += in_img && !in_patch;
  }
  const uint32_t wb = warp_min_bytes(w);
  sk = __reduce_add_sync(0xFFFFFFFFu, sk);
  if (lane == 0) red[threadIdx.x >> 5] = make_int2(static_cast<int>(wb), static_cast<int>(sk));
  __syncthreads();
  const int2 r = red[lane % kPatchWarps];
  skip = __reduce_add_sync(0xFFFFFFFFu, lane < kPatchWarps ? r.y : 0);
  return warp_min_bytes(static_cast<uint32_t>(r.x));
}

// how a box is staged, the same in every thread: box columns c0 .. c0 +
// bw - 1 and rows r0 .. r0 + bh - 1 of the window, sr box rows a strip (bw
// pixels of 32 B each in a slot of slot_bytes), `strips` ring turns
struct Plan {
  int c0, r0, bw, bh, sr, strips;
};

__device__ __forceinline__ Plan plan(uint32_t box, int slot_bytes) {
  Plan p;
  p.c0 = box & 0xFF;
  p.r0 = (box >> 8) & 0xFF;
  if (box == kEmptyBox) {
    p.bw = p.bh = p.sr = 1;
    p.strips = 0;
    return p;
  }
  p.bw = 255 - static_cast<int>((box >> 16) & 0xFF) - p.c0 + 1;
  p.bh = 255 - static_cast<int>(box >> 24) - p.r0 + 1;
  p.sr = min(p.bh, slot_bytes / (p.bw * kChannels * 4));
  p.strips = (p.bh + p.sr - 1) / p.sr;
  return p;
}

// warp 0: stage strip s of a box (box rows r0 + s sr .., at most sr) of the
// window at (u0, v0) into `slot` ([rows][bw][8] words), one bulk copy a box
// row, on `bar`
__device__ __forceinline__ void stage_strip(float* slot, const float* img, int img_w, int u0,
                                            int v0, const Plan& p, int s, uint64_t* bar) {
  const int lane = threadIdx.x;
  const int first = s * p.sr, n = min(p.sr, p.bh - first);
  const uint32_t row_bytes = static_cast<uint32_t>(p.bw) * kChannels * 4;
  if (lane == 0) mbar_arrive_expect_tx(bar, n * row_bytes);
  __syncwarp();
  for (int r = lane; r < n; r += 32) {
    bulk_load(slot + r * p.bw * kChannels,
              img + (static_cast<size_t>(v0 + p.r0 + first + r) * img_w + u0 + p.c0) * kChannels,
              row_bytes, bar);
  }
}

template <int PH, int PW, int Slots>
__global__ void __launch_bounds__(kPatchThreads, Slots == 1 ? kOneRowCtas : kRingCtas) sample_patch_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ pu0, const int* __restrict__ pv0,
    const int* __restrict__ count, int rows, int rows_per_cta, int slot_bytes,
    float* __restrict__ out, uint8_t* __restrict__ valid, int* __restrict__ skipped) {
  extern __shared__ __align__(128) float ring[];  // Slots slots of slot_bytes
  __shared__ __align__(8) uint64_t bar[Slots];
  __shared__ int2 red[2][kPatchWarps];
  const int t = threadIdx.x;
  const int n = min(__ldg(count), rows);
  if (t == 0) {
    for (int k = 0; k < Slots; ++k) mbar_init(&bar[k], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(first + rows_per_cta, n);
  if (first >= last) return;
  const int plane = rows * kVoxels;  // 8 planes < 2^31 words: rows <= 2^19
  const int slot_words = slot_bytes / 4;
  // ring turns issued and consumed: turn k uses slot k % Slots in its round
  // k / Slots, on that slot's mbarrier, armed once a round by warp 0
  int issued = 0, consumed = 0;
  const auto issue = [&](int u0, int v0, const Plan& q, int s) {
    if (t < 32) stage_strip(ring + (issued % Slots) * slot_words, img, img_w, u0, v0, q, s,
                            &bar[issued % Slots]);
    ++issued;
  };
  // this thread's pixels of the current row, of the next (its box is taken
  // during the current row) and of the one after (loading meanwhile)
  int u[kPer], v[kPer], nu[kPer], nv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = first * kVoxels + j * kPatchThreads + t;
    u[j] = us[i];
    v[j] = vs[i];
    nu[j] = Slots > 1 && first + 1 < last ? us[i + kVoxels] : 0;
    nv[j] = Slots > 1 && first + 1 < last ? vs[i + kVoxels] : 0;
  }
  int skip, skip_voxels = 0, skip_rows = 0;
  uint32_t box = row_box<PH, PW>(u, v, __ldg(pu0 + first), __ldg(pv0 + first), img_h, img_w,
                                 red[0], skip);
  skip_voxels += skip;
  skip_rows += skip > 0;
  for (int row = first; row < last; ++row) {
    const int u0 = __ldg(pu0 + row), v0 = __ldg(pv0 + row);
    const Plan p = plan(box, slot_bytes);
    // this row's first strip, unless the row before issued it (a row after
    // an empty box: the reads before it lie behind the last box's barrier)
    if (p.strips > 0 && issued == consumed) issue(u0, v0, p, 0);
    // the next row's box while this row's first strip is copied, so that
    // the next row's first strip can be issued while this row's last is read
    uint32_t nbox = kEmptyBox;
    int nnu[kPer], nnv[kPer];
    if constexpr (Slots > 1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = (row + 2) * kVoxels + j * kPatchThreads + t;
        nnu[j] = row + 2 < last ? us[i] : 0;
        nnv[j] = row + 2 < last ? vs[i] : 0;
      }
      if (row + 1 < last) {
        nbox = row_box<PH, PW>(nu, nv, __ldg(pu0 + row + 1), __ldg(pv0 + row + 1), img_h,
                               img_w, red[(row + 1 - first) & 1], skip);
        skip_voxels += skip;
        skip_rows += skip > 0;
      }
    }
    int mine[kPer];  // the strip holding each voxel, -1 outside the window
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int lu = u[j] - u0, lv = v[j] - v0;
      mine[j] = lu >= 0 && lu < PW && lv >= 0 && lv < PH ? (lv - p.r0) / p.sr : -1;
    }
    const int vi = row * kVoxels + t;
    for (int s = 0; s < p.strips; ++s) {
      if constexpr (Slots == 1) {
        if (s > 0) issue(u0, v0, p, s);
      } else if (issued == consumed + 1 && (s + 1 < p.strips || nbox != kEmptyBox)) {
        // one turn ahead: this row's next strip, or the next row's first
        if (s + 1 < p.strips)
          issue(u0, v0, p, s + 1);
        else
          issue(__ldg(pu0 + row + 1), __ldg(pv0 + row + 1), plan(nbox, slot_bytes), 0);
      }
      const int k = consumed % Slots;
      mbar_wait(&bar[k], (consumed / Slots) & 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (mine[j] != s) continue;
        const float4* px = reinterpret_cast<const float4*>(
            ring + k * slot_words +
            ((v[j] - v0 - p.r0 - s * p.sr) * p.bw + u[j] - u0 - p.c0) * kChannels);
        const float4 a = px[0], b = px[1];
        const float sv[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int c = 0; c < kChannels; ++c) out[c * plane + vi + j * kPatchThreads] = sv[c];
      }
      ++consumed;
      // every thread has read the slot before its next round is issued.
      // After a row's last strip the next issue into this slot comes after
      // the box barrier of row + 2 (taken during row + 1), or never
      if (s + 1 < p.strips || (row + 1 < last && row + 2 >= last)) __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (mine[j] < 0) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) out[c * plane + vi + j * kPatchThreads] = 0.f;
      }
      valid[vi + j * kPatchThreads] = mine[j] >= 0;
      if constexpr (Slots > 1) {
        u[j] = nu[j];
        v[j] = nv[j];
        nu[j] = nnu[j];
        nv[j] = nnv[j];
      }
    }
    box = nbox;
  }
  if (t == 0 && skip_voxels) {
    atomicAdd(skipped, skip_voxels);
    atomicAdd(skipped + 1, skip_rows);
  }
}

template <int PH, int PW>
int launch_patch(const float* img, int img_h, int img_w, const int* us, const int* vs,
                 const int* pu0, const int* pv0, const int* count, int rows, int rows_per_cta,
                 int slot_bytes, float* out, uint8_t* valid, int* skipped, cudaStream_t stream) {
  // a slot holds at least one window row, and slot 1 starts 128-byte aligned
  if (rows > (1 << 19) || rows_per_cta < 1 || slot_bytes < PW * kChannels * 4 ||
      slot_bytes % 128 || img_h < PH || img_w < PW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = rows_per_cta == 1 ? 1 : 2, smem = slots * slot_bytes;
  auto kernel = slots == 1 ? sample_patch_kernel<PH, PW, 1> : sample_patch_kernel<PH, PW, 2>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<(rows + rows_per_cta - 1) / rows_per_cta, kPatchThreads, smem, stream>>>(
      img, img_h, img_w, us, vs, pu0, pv0, count, rows, rows_per_cta, slot_bytes, out, valid,
      skipped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P4: mode 0 K1's body, 1 pixel loads with one word written, 2 writes only
extern "C" int dst_probe_sample_direct(int mode, const float* img, int img_h, int img_w,
                                       const int* us, const int* vs, const int* count,
                                       int rows, float* out, uint8_t* valid, uint32_t* words,
                                       void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<rows, kVoxels, 0, s>>>(img, img_h, img_w, us, vs, count, rows, out, valid, words);
  };
  switch (mode) {
    case kFull: args(sample_direct_kernel<kFull>); break;
    case kLoadsOnly: args(sample_direct_kernel<kLoadsOnly>); break;
    case kWritesOnly: args(sample_direct_kernel<kWritesOnly>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// P1/P2/P3/P6: shape 0 a 24x32 window, 1 a 48x64 window; pu0, pv0 i32
// [rows] the aligned window origins; slot_bytes each of the ring's two
// slots (a multiple of 128, at least one window row); skipped i32 [2]
// (voxels, rows), added to
extern "C" int dst_probe_sample_patch(int shape, const float* img, int img_h, int img_w,
                                      const int* us, const int* vs, const int* pu0,
                                      const int* pv0, const int* count, int rows,
                                      int rows_per_cta, int slot_bytes, float* out,
                                      uint8_t* valid, int* skipped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return launch_patch<24, 32>(img, img_h, img_w, us, vs, pu0, pv0, count, rows,
                                        rows_per_cta, slot_bytes, out, valid, skipped, s);
    case 1: return launch_patch<48, 64>(img, img_h, img_w, us, vs, pu0, pv0, count, rows,
                                        rows_per_cta, slot_bytes, out, valid, skipped, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P5: fuse_rows_kernel<stage> for stage 0, 1, 2 (the arguments of
// dst_fuse_rows; the pool words keep their values)
extern "C" int dst_probe_fuse_stage(int stage, const float* img, int img_h, int img_w,
                                    const int* block_pos, const int* pool_idx,
                                    const int* count, int rows, int num_blocks, float* tsdf,
                                    int* rgbw, float* prob, float* minabs,
                                    const float* pose12, const float* intrinsics4,
                                    float voxel_size, float truncation, float max_depth,
                                    float max_weight, float prob_eps, float prob_hi,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch_fuse_rows<0>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    case 1: return launch_fuse_rows<1>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    case 2: return launch_fuse_rows<2>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
