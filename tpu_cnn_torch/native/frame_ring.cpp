// frame_ring.cpp — native camera->engine frame pipeline (the data-loader).
// The port's copy of tpu_cnn/native/frame_ring.cpp (tpu_cnn_torch.native.ring).
//
// Role: the reference's capture path is a Python thread holding ONE latest
// frame plus per-frame Python preprocessing on the consumer side
// (software/realtime_detect.py:148-240,584-591). For TPU-rate engines the
// host must instead deliver PREPROCESSED batches: this ring lets any number
// of producer threads push raw camera frames — the center-crop/BT.601/
// area-resize runs HERE, off the GIL (ctypes releases it), via the same
// tcnn_preprocess kernel the parity tests pin — into a bounded circular
// buffer, while the consumer drains contiguous batches sized for the
// engine. Overflow drops the OLDEST unconsumed frame (realtime latest-wins
// semantics, like the reference's single-slot frame holder) and counts it.
//
// Concurrency: one mutex + condvar; producers preprocess into a private
// staging buffer BEFORE taking the lock, so the critical section is a
// memcpy. The consumer can block in tcnn_ring_wait (GIL released) for a
// batch to accumulate. tcnn_ring_age_s feeds the stall watchdog.
//
// Build: compiled into the host library tcnn_host with the oracle
// (tpu_cnn_torch/ops/_build.py, build_host).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" int tcnn_preprocess(const uint8_t* frames, int batch, int H, int W,
                               int channels, int bgr, int out_size,
                               uint8_t* out);

namespace {

using Clock = std::chrono::steady_clock;

struct FrameRing {
  std::mutex mu;
  std::condition_variable cv;
  int capacity = 0;
  int out_size = 0;
  std::vector<uint8_t> slots;  // capacity * out_size^2, circular
  uint64_t w = 0;              // next write index (monotonic)
  uint64_t r = 0;              // next read index (monotonic, r <= w)
  uint64_t dropped = 0;
  Clock::time_point last_push = Clock::now();

  size_t slot_bytes() const { return (size_t)out_size * out_size; }
  uint8_t* slot(uint64_t i) { return slots.data() + (i % capacity) * slot_bytes(); }
};

}  // namespace

extern "C" {

void* tcnn_ring_create(int capacity, int out_size) {
  if (capacity <= 0 || out_size <= 0) return nullptr;
  auto* r = new FrameRing();
  r->capacity = capacity;
  r->out_size = out_size;
  r->slots.resize((size_t)capacity * out_size * out_size);
  return r;
}

void tcnn_ring_destroy(void* ring) { delete (FrameRing*)ring; }

// Preprocess one raw frame (H x W x channels u8, bgr channel order when 3)
// and enqueue it. Returns the frame's sequence number (1-based), 0 on error.
// When the ring is full the OLDEST unconsumed frame is dropped.
uint64_t tcnn_ring_push(void* ring, const uint8_t* frame, int H, int W,
                        int channels, int bgr) {
  auto* r = (FrameRing*)ring;
  if (!r || !frame) return 0;
  // preprocess outside the lock into a per-call staging buffer
  std::vector<uint8_t> staged(r->slot_bytes());
  if (tcnn_preprocess(frame, 1, H, W, channels, bgr, r->out_size,
                      staged.data()) != 0)
    return 0;
  uint64_t seq;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->w - r->r == (uint64_t)r->capacity) {
      ++r->r;  // drop oldest
      ++r->dropped;
    }
    std::memcpy(r->slot(r->w), staged.data(), r->slot_bytes());
    seq = ++r->w;  // 1-based: seq of this frame == new w
    r->last_push = Clock::now();
  }
  r->cv.notify_all();
  return seq;
}

// Copy up to max_frames of the oldest unconsumed preprocessed frames into
// out (max_frames x out_size^2 u8). Returns the count (may be 0).
int tcnn_ring_pop(void* ring, uint8_t* out, int max_frames) {
  auto* r = (FrameRing*)ring;
  if (!r || !out || max_frames <= 0) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  int n = (int)(r->w - r->r);
  if (n > max_frames) n = max_frames;
  for (int i = 0; i < n; ++i)
    std::memcpy(out + (size_t)i * r->slot_bytes(), r->slot(r->r + i),
                r->slot_bytes());
  r->r += n;
  return n;
}

// Block until >= min_frames are available or timeout_s elapses. Returns the
// available count at wake-up (ctypes releases the GIL around this call).
int tcnn_ring_wait(void* ring, int min_frames, double timeout_s) {
  auto* r = (FrameRing*)ring;
  if (!r) return 0;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv.wait_for(lk, std::chrono::duration<double>(timeout_s),
                 [&] { return (int)(r->w - r->r) >= min_frames; });
  return (int)(r->w - r->r);
}

uint64_t tcnn_ring_dropped(void* ring) {
  auto* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  return r->dropped;
}

// Seconds since the last successful push — the stall-watchdog signal
// (reference: software/realtime_detect.py:205-231).
double tcnn_ring_age_s(void* ring) {
  auto* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  return std::chrono::duration<double>(Clock::now() - r->last_push).count();
}

}  // extern "C"
