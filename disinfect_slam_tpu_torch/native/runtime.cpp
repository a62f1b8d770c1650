// Native host runtime of the PyTorch/CUDA port (a copy of
// disinfect_slam_tpu/native/runtime.cpp, so that the port builds nothing
// of the JAX package; disinfect_slam_tpu_torch/native/runtime.py binds it).
//
// The reference implements its host runtime in C++ (pose_manager,
// TSDFSystem's queue/thread, DataLogger); the latency-sensitive host
// plumbing stays native here too:
//
//   - PoseBuffer: lock-guarded timestamped pose store with binary-search
//     nearest/interpolated queries (utils/rotation_math/pose_manager.cc
//     semantics, plus the SLERP the reference left as a TODO)
//   - FrameQueue: bounded MPSC ring buffer for sensor frames with
//     drop-oldest backpressure and a watermark counter (the
//     "cannot catch up" warning threshold of tsdf_module.cc:62)
//   - steady/system clock helpers (utils/time.hpp)
//
// Exposed as a C ABI for ctypes; runtime.py compiles it with the system
// C++ compiler at first use.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- time
int64_t dstpu_monotonic_ms() {
  using namespace std::chrono;
  return duration_cast<milliseconds>(steady_clock::now().time_since_epoch())
      .count();
}

int64_t dstpu_system_ms() {
  using namespace std::chrono;
  return duration_cast<milliseconds>(system_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------- pose buffer
namespace {

struct Pose {
  int64_t ts;
  // quaternion (w, x, y, z) + translation
  double q[4];
  double t[3];
};

void mat_to_quat(const double* m /*3x4 row-major*/, double* q) {
  const double tr = m[0] + m[5] + m[10];
  if (tr > 0) {
    double s = std::sqrt(tr + 1.0) * 2;
    q[0] = 0.25 * s;
    q[1] = (m[9] - m[6]) / s;
    q[2] = (m[2] - m[8]) / s;
    q[3] = (m[4] - m[1]) / s;
  } else if (m[0] >= m[5] && m[0] >= m[10]) {
    double s = std::sqrt(1.0 + m[0] - m[5] - m[10]) * 2;
    q[0] = (m[9] - m[6]) / s;
    q[1] = 0.25 * s;
    q[2] = (m[1] + m[4]) / s;
    q[3] = (m[2] + m[8]) / s;
  } else if (m[5] >= m[10]) {
    double s = std::sqrt(1.0 + m[5] - m[0] - m[10]) * 2;
    q[0] = (m[2] - m[8]) / s;
    q[1] = (m[1] + m[4]) / s;
    q[2] = 0.25 * s;
    q[3] = (m[6] + m[9]) / s;
  } else {
    double s = std::sqrt(1.0 + m[10] - m[0] - m[5]) * 2;
    q[0] = (m[4] - m[1]) / s;
    q[1] = (m[2] + m[8]) / s;
    q[2] = (m[6] + m[9]) / s;
    q[3] = 0.25 * s;
  }
}

void quat_to_mat(const double* q, double* m /*3x3 row-major*/) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1 - 2 * (y * y + z * z);
  m[1] = 2 * (x * y - w * z);
  m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z);
  m[4] = 1 - 2 * (x * x + z * z);
  m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y);
  m[7] = 2 * (y * z + w * x);
  m[8] = 1 - 2 * (x * x + y * y);
}

void slerp(const double* a, const double* b, double alpha, double* out) {
  double dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
  double bb[4] = {b[0], b[1], b[2], b[3]};
  if (dot < 0) {
    for (int i = 0; i < 4; ++i) bb[i] = -bb[i];
    dot = -dot;
  }
  if (dot > 0.9995) {
    double n = 0;
    for (int i = 0; i < 4; ++i) {
      out[i] = a[i] + alpha * (bb[i] - a[i]);
      n += out[i] * out[i];
    }
    n = std::sqrt(n);
    for (int i = 0; i < 4; ++i) out[i] /= n;
    return;
  }
  const double theta = std::acos(std::min(std::max(dot, -1.0), 1.0));
  const double s = std::sin(theta);
  const double wa = std::sin((1 - alpha) * theta) / s;
  const double wb = std::sin(alpha * theta) / s;
  for (int i = 0; i < 4; ++i) out[i] = wa * a[i] + wb * bb[i];
}

struct PoseBuffer {
  std::vector<Pose> poses;
  std::mutex mtx;
  bool interpolate = true;
};

}  // namespace

void* dstpu_pose_buffer_new(int interpolate) {
  auto* pb = new PoseBuffer();
  pb->interpolate = interpolate != 0;
  return pb;
}

void dstpu_pose_buffer_free(void* h) { delete static_cast<PoseBuffer*>(h); }

// pose: 4x4 row-major float64 cam_T_world
void dstpu_pose_buffer_register(void* h, int64_t ts, const double* mat) {
  auto* pb = static_cast<PoseBuffer*>(h);
  Pose p;
  p.ts = ts;
  mat_to_quat(mat, p.q);
  p.t[0] = mat[3];
  p.t[1] = mat[7];
  p.t[2] = mat[11];
  std::lock_guard<std::mutex> lk(pb->mtx);
  pb->poses.push_back(p);
}

int64_t dstpu_pose_buffer_size(void* h) {
  auto* pb = static_cast<PoseBuffer*>(h);
  std::lock_guard<std::mutex> lk(pb->mtx);
  return static_cast<int64_t>(pb->poses.size());
}

// out: 4x4 row-major float64
void dstpu_pose_buffer_query(void* h, int64_t ts, double* out) {
  auto* pb = static_cast<PoseBuffer*>(h);
  Pose lo, hi;
  bool have_pair = false;
  {
    std::lock_guard<std::mutex> lk(pb->mtx);
    std::fill(out, out + 16, 0.0);
    out[0] = out[5] = out[10] = out[15] = 1.0;
    if (pb->poses.empty()) return;
    auto it = std::upper_bound(
        pb->poses.begin(), pb->poses.end(), ts,
        [](int64_t t, const Pose& p) { return t < p.ts; });
    if (it == pb->poses.begin()) {
      lo = hi = *it;
    } else if (it == pb->poses.end()) {
      lo = hi = pb->poses.back();
    } else {
      lo = *(it - 1);
      hi = *it;
      have_pair = true;
    }
  }
  Pose res = lo;
  if (have_pair) {
    const double span = static_cast<double>(hi.ts - lo.ts);
    const double alpha = span > 0 ? (ts - lo.ts) / span : 0.0;
    if (pb->interpolate) {
      slerp(lo.q, hi.q, alpha, res.q);
      for (int i = 0; i < 3; ++i)
        res.t[i] = (1 - alpha) * lo.t[i] + alpha * hi.t[i];
    } else {
      // nearest-neighbor pick (pose_manager.cc:36-43)
      res = (ts - lo.ts) < (hi.ts - ts) ? lo : hi;
    }
  }
  double r[9];
  quat_to_mat(res.q, r);
  out[0] = r[0]; out[1] = r[1]; out[2] = r[2]; out[3] = res.t[0];
  out[4] = r[3]; out[5] = r[4]; out[6] = r[5]; out[7] = res.t[1];
  out[8] = r[6]; out[9] = r[7]; out[10] = r[8]; out[11] = res.t[2];
  out[12] = 0; out[13] = 0; out[14] = 0; out[15] = 1;
}

// ---------------------------------------------------------- frame queue
namespace {

struct FrameQueue {
  std::vector<std::vector<uint8_t>> slots;
  std::vector<int64_t> stamps;
  size_t capacity;
  size_t head = 0;  // next pop
  size_t count = 0;
  uint64_t dropped = 0;
  std::mutex mtx;
  std::condition_variable cv;
  bool closed = false;
};

}  // namespace

void* dstpu_frame_queue_new(int64_t capacity) {
  auto* q = new FrameQueue();
  q->capacity = static_cast<size_t>(capacity);
  q->slots.resize(q->capacity);
  q->stamps.resize(q->capacity);
  return q;
}

void dstpu_frame_queue_free(void* h) { delete static_cast<FrameQueue*>(h); }

// Push a frame blob; drops the OLDEST entry when full (keeps the stream
// live, mirrors the logger's drop-with-warning, data_logger.hpp:39-41).
// Returns 1 if an old frame was dropped.
int dstpu_frame_queue_push(void* h, int64_t ts, const uint8_t* data,
                           int64_t size) {
  auto* q = static_cast<FrameQueue*>(h);
  int dropped = 0;
  {
    std::lock_guard<std::mutex> lk(q->mtx);
    if (q->count == q->capacity) {
      q->head = (q->head + 1) % q->capacity;
      --q->count;
      ++q->dropped;
      dropped = 1;
    }
    const size_t tail = (q->head + q->count) % q->capacity;
    q->slots[tail].assign(data, data + size);
    q->stamps[tail] = ts;
    ++q->count;
  }
  q->cv.notify_one();
  return dropped;
}

int64_t dstpu_frame_queue_depth(void* h) {
  auto* q = static_cast<FrameQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mtx);
  return static_cast<int64_t>(q->count);
}

uint64_t dstpu_frame_queue_dropped(void* h) {
  auto* q = static_cast<FrameQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mtx);
  return q->dropped;
}

void dstpu_frame_queue_close(void* h) {
  auto* q = static_cast<FrameQueue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mtx);
    q->closed = true;
  }
  q->cv.notify_all();
}

// Pop with timeout; returns payload size (copied into `out`, bounded by
// out_cap), 0 on timeout, -1 when closed and empty.
int64_t dstpu_frame_queue_pop(void* h, int64_t timeout_ms, int64_t* ts_out,
                              uint8_t* out, int64_t out_cap) {
  auto* q = static_cast<FrameQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mtx);
  if (!q->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [&] { return q->count > 0 || q->closed; }))
    return 0;
  if (q->count == 0) return -1;
  auto& slot = q->slots[q->head];
  const int64_t n = std::min<int64_t>(slot.size(), out_cap);
  std::memcpy(out, slot.data(), n);
  *ts_out = q->stamps[q->head];
  q->head = (q->head + 1) % q->capacity;
  --q->count;
  return n;
}

}  // extern "C"
