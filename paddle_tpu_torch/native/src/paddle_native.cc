// Native host runtime for paddle_tpu_torch (a copy of paddle_tpu's).
//
// Reference analogs being re-implemented natively:
//   - C++ DataFeed / LoDTensorBlockingQueue (fluid/framework/data_feed.cc,
//     operators/reader/blocking_queue.h): a condvar blocking ring queue
//     used for host-side batch prefetch.
//   - collation / layout transforms the reference does inside its C++
//     feed pipeline: parallel batch stacking (memcpy fan-out) and fused
//     uint8-HWC -> float32-CHW normalize (the hot path feeding image
//     models; keeps the Python side GIL-free during collation).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Parallel batch collation: stack `n` equally-sized contiguous samples into
// one batch buffer using `nthreads` worker threads. A batch under
// kCollateThreadedBytes is one memcpy stream: below it, starting the threads
// costs more than they save.
// ---------------------------------------------------------------------------
static const int64_t kCollateThreadedBytes = int64_t(4) << 20;

void pn_collate(const void** srcs, int64_t n, void* dst,
                int64_t bytes_per_sample, int32_t nthreads) {
  if (n <= 0) return;
  char* out = static_cast<char*>(dst);
  if (nthreads <= 1 || n < 4 || n * bytes_per_sample < kCollateThreadedBytes) {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(out + i * bytes_per_sample, srcs[i], bytes_per_sample);
    }
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n) {
      std::memcpy(out + i * bytes_per_sample, srcs[i], bytes_per_sample);
    }
  };
  std::vector<std::thread> threads;
  int32_t t = nthreads < n ? nthreads : static_cast<int32_t>(n);
  threads.reserve(t);
  for (int32_t k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Fused uint8 HWC -> float32 CHW with per-channel mean/std (the classic
// ToTensor+Normalize+Transpose image path, one pass over memory).
// ---------------------------------------------------------------------------
void pn_u8hwc_to_f32chw(const uint8_t* src, float* dst, int64_t h,
                        int64_t w, int64_t c, const float* mean,
                        const float* std_, float scale) {
  std::vector<float> inv(c);
  for (int64_t ch = 0; ch < c; ++ch) inv[ch] = 1.0f / std_[ch];
  const int64_t hw = h * w;
  for (int64_t ch = 0; ch < c; ++ch) {
    float m = mean[ch];
    float iv = inv[ch];
    float* out = dst + ch * hw;
    const uint8_t* in = src + ch;
    for (int64_t i = 0; i < hw; ++i) {
      out[i] = (static_cast<float>(in[i * c]) * scale - m) * iv;
    }
  }
}

// batched variant over N images, threaded
void pn_u8hwc_to_f32chw_batch(const uint8_t** srcs, float* dst, int64_t n,
                              int64_t h, int64_t w, int64_t c,
                              const float* mean, const float* std_,
                              float scale, int32_t nthreads) {
  const int64_t per = c * h * w;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n) {
      pn_u8hwc_to_f32chw(srcs[i], dst + i * per, h, w, c, mean, std_,
                         scale);
    }
  };
  int32_t t = nthreads > 0 ? nthreads : 1;
  if (t == 1 || n < 2) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int32_t k = 0; k < t && k < n; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Blocking byte-buffer queue (LoDTensorBlockingQueue analog).
// Items are opaque byte blobs owned by the queue between push and pop.
// ---------------------------------------------------------------------------
struct PnQueue {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<std::vector<char>> items;
  size_t capacity;
  bool closed = false;
};

void* pn_queue_create(int64_t capacity) {
  auto* q = new PnQueue();
  q->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 1;
  return q;
}

void pn_queue_destroy(void* qp) { delete static_cast<PnQueue*>(qp); }

void pn_queue_close(void* qp) {
  auto* q = static_cast<PnQueue*>(qp);
  {
    std::lock_guard<std::mutex> g(q->mu);
    q->closed = true;
  }
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

// returns 1 on success, 0 if queue closed
int32_t pn_queue_push(void* qp, const void* data, int64_t size) {
  auto* q = static_cast<PnQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_full.wait(lk, [&] {
    return q->closed || q->items.size() < q->capacity;
  });
  if (q->closed) return 0;
  q->items.emplace_back(static_cast<const char*>(data),
                        static_cast<const char*>(data) + size);
  lk.unlock();
  q->not_empty.notify_one();
  return 1;
}

// peek next item size; -1 when closed+empty (end of stream)
int64_t pn_queue_next_size(void* qp) {
  auto* q = static_cast<PnQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [&] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return -1;
  return static_cast<int64_t>(q->items.front().size());
}

// pop into caller buffer (call next_size first); returns bytes or -1
int64_t pn_queue_pop(void* qp, void* out, int64_t out_cap) {
  auto* q = static_cast<PnQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [&] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return -1;
  auto item = std::move(q->items.front());
  q->items.pop_front();
  lk.unlock();
  q->not_full.notify_one();
  int64_t sz = static_cast<int64_t>(item.size());
  if (sz > out_cap) return -2;
  std::memcpy(out, item.data(), item.size());
  return sz;
}

int64_t pn_queue_size(void* qp) {
  auto* q = static_cast<PnQueue*>(qp);
  std::lock_guard<std::mutex> g(q->mu);
  return static_cast<int64_t>(q->items.size());
}

}  // extern "C"
