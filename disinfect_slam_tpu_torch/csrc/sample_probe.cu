// Hopper probes of the frame sampler (K1, sample_rows.cu) and of the
// stages of fuse_rows (K2), run by ops/cuda/sample_probe.py: the
// counterparts of the TPU probes scripts/probe_sample2.py,
// probe_sample3.py, probe_sample4.py (P1-P3), probe_sample_overhead.py
// (P4), probe_kernel_stages.py (P5) and probe_mxu_shapes.py (P6), and the
// port's own instruments of K1 and K2.
//
// P4 and P5 split the Pallas sampler into stripped modes, on inputs of
// their own: a random 480x640x8 frame, rows whose patch origin (u0, v0)
// lies on a 16 / 8 pixel grid and whose 512 voxels lie within 16 pixels
// of it.  Each mode writes 8 channel planes and a valid plane (vmask, the
// voxel inside the 24x32 patch), [V, 512] float32 each: P4 over all V
// rows nodma (vmask * c), dma_only (vmask times the patch's pixel (u0,
// v0)), stage1 (the pixel (u0, v0 + lv_c) through three bf16 splits) and
// full (the pixel (u0 + lu_c, v0 + lv_c) through three splits, which is
// the pixel itself); P5 over the 16-row steps whose first row lies below
// a live count read from device memory dma_only (lu_c), mxu (column 0's
// pixel through two splits, hi + mid, unmasked), mask_fold and vmem_img
// (the pixel through two splits, masked).  Here: sample_modes_kernel<Mode>,
// each thread four voxels (one 16-byte load of u and of v, two float4 of
// each pixel, nine float4 stores).  It is bound by its writes: P4 writes
// 604 MB and reads 134 MB (0.223 ms at 3.35 TB/s), P5 412 MB of 513 MB
// (0.153 ms).  The stores stream (__stcs) and so do the coordinate loads
// (__ldcs), so that the 9.8 MB frame stays in L2 for the pixel loads.
// The splits are __float2bfloat16_rn and back, added in float32 in the
// probes' order, (hi + mid) + lo.
//
// The port's instrument of K1 split its time into its pixel loads and its
// writes: sample_direct_kernel<mode>, K1's body (kFull), its pixel loads
// with one word written per voxel (kLoadsOnly: the xor of the pixel's
// eight words) and its writes without a pixel load (kWritesOnly).
#include <cuda_bf16.h>
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

// --- P4 / P5: the Pallas sampler's modes on their own inputs ---

constexpr int kProbePH = 24, kProbePW = 32, kTileRows = 16;
constexpr int kModesThreads = 256, kModesPer = 4;  // four voxels a thread
// kernel modes: P4 nodma, dma_only, stage1, full; P5 dma_only, mxu,
// mask_fold (= vmem_img)
constexpr int kNoDma = 0, kOrigin = 1, kStage1 = 2, kFull3 = 3, kLuC = 4, kMxu = 5, kFold2 = 6;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x through Splits bf16 splits, summed in float32 in the probes' order
template <int Splits>
__device__ __forceinline__ float splits(float x) {
  const float hi = bf16_round(x);
  const float r1 = __fsub_rn(x, hi);
  const float mid = bf16_round(r1);
  if constexpr (Splits == 2) return __fadd_rn(hi, mid);
  return __fadd_rn(__fadd_rn(hi, mid), bf16_round(__fsub_rn(r1, mid)));
}

template <int Mode>
__global__ void __launch_bounds__(kModesThreads) sample_modes_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ pu0, const int* __restrict__ pv0,
    const int* __restrict__ count, int rows, float* __restrict__ out) {
  constexpr bool kColLu = Mode == kFull3 || Mode == kFold2;
  constexpr bool kRowLv = Mode != kOrigin;
  const int quad = blockIdx.x * kModesThreads + threadIdx.x;
  const int row = quad / (kVoxels / kModesPer);
  if (row >= rows) return;
  // P5: the grid step of 16 rows runs when its first row is below count
  if (count != nullptr && (row & ~(kTileRows - 1)) >= __ldg(count)) return;
  const int u0 = __ldg(pu0 + row), v0 = __ldg(pv0 + row);
  const int4 u4 = __ldcs(reinterpret_cast<const int4*>(us) + quad);
  const int4 v4 = __ldcs(reinterpret_cast<const int4*>(vs) + quad);
  const int uu[kModesPer] = {u4.x, u4.y, u4.z, u4.w};
  const int vv[kModesPer] = {v4.x, v4.y, v4.z, v4.w};
  float o[kChannels + 1][kModesPer];
#pragma unroll
  for (int k = 0; k < kModesPer; ++k) {
    // int32 differences wrap, as the probes' do
    const int lu = static_cast<int>(static_cast<unsigned>(uu[k]) - static_cast<unsigned>(u0));
    const int lv = static_cast<int>(static_cast<unsigned>(vv[k]) - static_cast<unsigned>(v0));
    const float vmask = lu >= 0 && lu < kProbePW && lv >= 0 && lv < kProbePH ? 1.f : 0.f;
    const int lu_c = min(max(lu, 0), kProbePW - 1), lv_c = min(max(lv, 0), kProbePH - 1);
    o[kChannels][k] = vmask;
    if constexpr (Mode == kNoDma) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) o[c][k] = __fmul_rn(vmask, static_cast<float>(c));
    } else if constexpr (Mode == kLuC) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) o[c][k] = static_cast<float>(lu_c);
    } else {
      // the pixel, clamped into the frame (the probes' inputs never leave it)
      const long long pu = static_cast<long long>(u0) + (kColLu ? lu_c : 0);
      const long long pv = static_cast<long long>(v0) + (kRowLv ? lv_c : 0);
      const int col = static_cast<int>(min(max(pu, 0LL), static_cast<long long>(img_w - 1)));
      const int line = static_cast<int>(min(max(pv, 0LL), static_cast<long long>(img_h - 1)));
      const float4* px = reinterpret_cast<const float4*>(
          img + (static_cast<size_t>(line) * img_w + col) * kChannels);
      const float4 a = __ldg(px), b = __ldg(px + 1);
      const float s[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        float x = s[c];
        if constexpr (Mode == kStage1 || Mode == kFull3) x = splits<3>(x);
        if constexpr (Mode == kMxu || Mode == kFold2) x = splits<2>(x);
        o[c][k] = Mode == kMxu ? x : __fmul_rn(x, vmask);
      }
    }
  }
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
#pragma unroll
  for (int c = 0; c <= kChannels; ++c)
    __stcs(reinterpret_cast<float4*>(out + c * plane) + quad,
           make_float4(o[c][0], o[c][1], o[c][2], o[c][3]));
}
}  // namespace

// K1's split: mode 0 K1's body, 1 pixel loads with one word written, 2 writes only
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

// K2's stages: fuse_rows_kernel<stage> for stage 0, 1, 2 (the arguments of
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

// P4 / P5: mode 0-3 P4's nodma, dma_only, stage1, full; 4-6 P5's
// dma_only, mxu, mask_fold (vmem_img); img f32 [img_h, img_w, 8]; us, vs
// i32 [rows, 512]; pu0, pv0 i32 [rows] the patch origins; count i32 [1]
// (P5) or null (P4: every row); out f32 [9, rows, 512]; rows a multiple
// of 16, img, us, vs and out 16-byte aligned
extern "C" int dst_probe_sample_modes(int mode, const float* img, int img_h, int img_w,
                                      const int* us, const int* vs, const int* pu0,
                                      const int* pv0, const int* count, int rows, float* out,
                                      void* stream) {
  if (rows < 0 || rows % kTileRows || img_h < 1 || img_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = rows * (kVoxels / kModesPer) / kModesThreads;
  const auto go = [&](auto kernel) {
    kernel<<<ctas, kModesThreads, 0, s>>>(img, img_h, img_w, us, vs, pu0, pv0, count, rows,
                                          out);
  };
  switch (mode) {
    case kNoDma: go(sample_modes_kernel<kNoDma>); break;
    case kOrigin: go(sample_modes_kernel<kOrigin>); break;
    case kStage1: go(sample_modes_kernel<kStage1>); break;
    case kFull3: go(sample_modes_kernel<kFull3>); break;
    case kLuC: go(sample_modes_kernel<kLuC>); break;
    case kMxu: go(sample_modes_kernel<kMxu>); break;
    case kFold2: go(sample_modes_kernel<kFold2>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
