// MultiSlot data feed: native parser for the reference's PS training
// text format (paddle/fluid/framework/data_feed.cc MultiSlotDataFeed):
// each line holds, per slot, "<count> v1 ... vN". Parsing runs in C++
// worker threads (chunked at line boundaries) with no GIL, producing
// per-slot ragged arrays (values + row offsets) the python side wraps
// as numpy without copies.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct SlotData {
  std::vector<int64_t> ivals;
  std::vector<float> fvals;
  std::vector<int64_t> offsets;  // per-row value counts (prefix later)
};

struct FeedHandle {
  int64_t rows = 0;
  int num_slots = 0;
  std::vector<int> is_float;
  std::vector<SlotData> slots;  // merged
};

struct ChunkResult {
  int64_t rows = 0;
  std::vector<SlotData> slots;
};

void parse_chunk(const char* begin, const char* end, int num_slots,
                 const int* is_float, ChunkResult* out) {
  out->slots.resize(num_slots);
  const char* p = begin;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    if (line_end > p) {
      const char* q = p;
      bool ok = true;
      std::vector<std::pair<int64_t, int64_t>> spans(num_slots);
      for (int s = 0; s < num_slots && ok; ++s) {
        char* next = nullptr;
        long cnt = strtol(q, &next, 10);
        if (next == q || cnt < 0) { ok = false; break; }
        q = next;
        SlotData& sd = out->slots[s];
        for (long i = 0; i < cnt; ++i) {
          if (is_float[s]) {
            float v = strtof(q, &next);
            if (next == q) { ok = false; break; }
            sd.fvals.push_back(v);
          } else {
            long long v = strtoll(q, &next, 10);
            if (next == q) { ok = false; break; }
            sd.ivals.push_back(v);
          }
          q = next;
        }
        if (ok) sd.offsets.push_back(cnt);
      }
      if (ok) {
        out->rows += 1;
      } else {
        // drop partially parsed row data for consistency
        for (int s = 0; s < num_slots; ++s) {
          SlotData& sd = out->slots[s];
          if (static_cast<int64_t>(sd.offsets.size()) > out->rows) {
            int64_t extra = sd.offsets.back();
            sd.offsets.pop_back();
            if (is_float[s])
              sd.fvals.resize(sd.fvals.size() - extra);
            else
              sd.ivals.resize(sd.ivals.size() - extra);
          }
        }
      }
    }
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

void* pn_feed_parse(const char* path, int num_slots,
                    const int* is_float, int num_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  int nt = num_threads > 0 ? num_threads : 4;
  if (size < (1 << 16)) nt = 1;
  // chunk boundaries snapped to line starts
  std::vector<const char*> starts;
  const char* base = buf.data();
  const char* bend = base + size;
  starts.push_back(base);
  for (int t = 1; t < nt; ++t) {
    const char* cand = base + size * t / nt;
    while (cand < bend && *cand != '\n') ++cand;
    if (cand < bend) ++cand;
    starts.push_back(cand);
  }
  starts.push_back(bend);

  std::vector<ChunkResult> results(nt);
  std::vector<std::thread> workers;
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back(parse_chunk, starts[t], starts[t + 1],
                         num_slots, is_float, &results[t]);
  }
  for (auto& w : workers) w.join();

  auto* h = new FeedHandle();
  h->num_slots = num_slots;
  h->is_float.assign(is_float, is_float + num_slots);
  h->slots.resize(num_slots);
  for (auto& r : results) {
    h->rows += r.rows;
    for (int s = 0; s < num_slots; ++s) {
      SlotData& dst = h->slots[s];
      SlotData& src = r.slots[s];
      dst.ivals.insert(dst.ivals.end(), src.ivals.begin(),
                       src.ivals.end());
      dst.fvals.insert(dst.fvals.end(), src.fvals.begin(),
                       src.fvals.end());
      dst.offsets.insert(dst.offsets.end(), src.offsets.begin(),
                         src.offsets.end());
    }
  }
  return h;
}

int64_t pn_feed_rows(void* hp) {
  return static_cast<FeedHandle*>(hp)->rows;
}

int64_t pn_feed_slot_size(void* hp, int slot) {
  auto* h = static_cast<FeedHandle*>(hp);
  const SlotData& sd = h->slots[slot];
  return h->is_float[slot] ? static_cast<int64_t>(sd.fvals.size())
                           : static_cast<int64_t>(sd.ivals.size());
}

// values_out sized pn_feed_slot_size; offsets_out sized rows+1
void pn_feed_copy_slot(void* hp, int slot, void* values_out,
                       int64_t* offsets_out) {
  auto* h = static_cast<FeedHandle*>(hp);
  const SlotData& sd = h->slots[slot];
  if (h->is_float[slot]) {
    memcpy(values_out, sd.fvals.data(), sd.fvals.size() * sizeof(float));
  } else {
    memcpy(values_out, sd.ivals.data(),
           sd.ivals.size() * sizeof(int64_t));
  }
  int64_t acc = 0;
  offsets_out[0] = 0;
  for (size_t i = 0; i < sd.offsets.size(); ++i) {
    acc += sd.offsets[i];
    offsets_out[i + 1] = acc;
  }
}

void pn_feed_free(void* hp) { delete static_cast<FeedHandle*>(hp); }

}  // extern "C"
