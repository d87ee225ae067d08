// Native host tracer + stats registry.
//
// Reference analogs:
//   - HostTracer spans (paddle/fluid/platform/profiler/host_tracer.cc,
//     RecordEvent): nested host spans recorded off the hot path with a
//     steady nanosecond clock, exported as chrome://tracing events.
//   - Memory/stat registry (paddle/phi/core/memory/stats.cc): named
//     int64 gauges with current + peak, thread-safe, surfaced to Python
//     as paddle.device.*.max_memory_allocated-style APIs.
//
// Span recording uses per-thread open-span stacks so begin/end pairs
// nest correctly per thread without the caller passing ids around.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Span {
  std::string name;
  double start_us;
  double dur_us;
  uint64_t tid;
};

struct Open {
  std::string name;
  double start_us;
};

std::mutex g_mu;
std::vector<Span> g_spans;
std::atomic<bool> g_enabled{false};

thread_local std::vector<Open> t_stack;

double now_us() {
  return std::chrono::duration<double, std::micro>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

uint64_t tid_hash() {
  return std::hash<std::thread::id>()(std::this_thread::get_id()) %
         1000000;
}

// ---- stats ----
struct Stat {
  int64_t current = 0;
  int64_t peak = 0;
};
std::mutex g_stat_mu;
std::map<std::string, Stat> g_stats;

}  // namespace

extern "C" {

void pn_prof_enable(int32_t on) { g_enabled.store(on != 0); }

int32_t pn_prof_enabled() { return g_enabled.load() ? 1 : 0; }

void pn_prof_clear() {
  std::lock_guard<std::mutex> g(g_mu);
  g_spans.clear();
}

void pn_prof_begin(const char* name) {
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  t_stack.push_back({name, now_us()});
}

void pn_prof_end() {
  if (t_stack.empty()) return;
  Open o = std::move(t_stack.back());
  t_stack.pop_back();
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  double end = now_us();
  std::lock_guard<std::mutex> g(g_mu);
  g_spans.push_back(
      {std::move(o.name), o.start_us, end - o.start_us, tid_hash()});
}

// Record a complete span directly (for pre-timed events).
void pn_prof_record(const char* name, double start_us, double dur_us) {
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> g(g_mu);
  g_spans.push_back({name, start_us, dur_us, tid_hash()});
}

int64_t pn_prof_count() {
  std::lock_guard<std::mutex> g(g_mu);
  return static_cast<int64_t>(g_spans.size());
}

// Fetch span i; returns name length (truncated to cap), or -1 if oob.
int64_t pn_prof_get(int64_t i, char* name_out, int64_t cap,
                    double* start_us, double* dur_us, int64_t* tid) {
  std::lock_guard<std::mutex> g(g_mu);
  if (i < 0 || i >= static_cast<int64_t>(g_spans.size())) return -1;
  const Span& s = g_spans[static_cast<size_t>(i)];
  int64_t n = static_cast<int64_t>(s.name.size());
  int64_t ncopy = n < cap - 1 ? n : cap - 1;
  std::memcpy(name_out, s.name.data(), ncopy);
  name_out[ncopy] = '\0';
  *start_us = s.start_us;
  *dur_us = s.dur_us;
  *tid = static_cast<int64_t>(s.tid);
  return n;
}

// ---- stats registry ----

// Apply delta; returns new current. Tracks peak.
int64_t pn_stat_update(const char* key, int64_t delta) {
  std::lock_guard<std::mutex> g(g_stat_mu);
  Stat& s = g_stats[key];
  s.current += delta;
  if (s.current > s.peak) s.peak = s.current;
  return s.current;
}

int64_t pn_stat_current(const char* key) {
  std::lock_guard<std::mutex> g(g_stat_mu);
  auto it = g_stats.find(key);
  return it == g_stats.end() ? 0 : it->second.current;
}

int64_t pn_stat_peak(const char* key) {
  std::lock_guard<std::mutex> g(g_stat_mu);
  auto it = g_stats.find(key);
  return it == g_stats.end() ? 0 : it->second.peak;
}

void pn_stat_reset_peak(const char* key) {
  std::lock_guard<std::mutex> g(g_stat_mu);
  auto it = g_stats.find(key);
  if (it != g_stats.end()) it->second.peak = it->second.current;
}

void pn_stat_clear() {
  std::lock_guard<std::mutex> g(g_stat_mu);
  g_stats.clear();
}

}  // extern "C"
