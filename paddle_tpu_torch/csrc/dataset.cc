// Native dataset engine: multi-threaded file -> record ingestion with
// shuffle and contiguous batch extraction.
//
// Reference parity: paddle/fluid/framework/data_feed.cc (MultiSlotDataFeed
// text parsing on reader threads) + data_set.cc (DatasetImpl::LoadIntoMemory,
// LocalShuffle) — the C++ data path that feeds train_from_dataset.  The TPU
// build keeps this native so host-side parsing/shuffling never holds the
// GIL while XLA runs; records land in one flat float buffer that Python
// slices into per-slot numpy arrays without copies beyond the batch gather.
//
// Record format: one record per text line, whitespace-separated numbers,
// fixed record_dim values per line (short lines are zero-padded, long lines
// truncated — mirroring MultiSlotDataFeed's fixed slot schema).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Dataset {
  std::vector<std::string> files;
  int record_dim = 0;
  std::vector<float> data;     // num_records * record_dim
  std::vector<int64_t> order;  // shuffle permutation
  std::mutex mu;
  std::atomic<int64_t> next_file{0};
};

void parse_file(Dataset* ds, const std::string& path,
                std::vector<float>* local) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return;
  char buf[1 << 16];
  const int dim = ds->record_dim;
  size_t base = static_cast<size_t>(-1);
  int got = dim;  // "no open record"
  // getline-free chunked reader: a record ends at '\n'; over-long lines
  // continue across fgets chunks (values past dim are discarded, matching
  // the fixed-slot truncation contract of MultiSlotDataFeed)
  while (std::fgets(buf, sizeof(buf), f)) {
    bool line_end = std::strchr(buf, '\n') != nullptr;
    if (got >= dim && base == static_cast<size_t>(-1)) {
      // start a new record for this line
      base = local->size();
      local->resize(base + dim, 0.0f);
      got = 0;
    }
    const char* p = buf;
    char* end = nullptr;
    while (got < dim) {
      float v = std::strtof(p, &end);
      if (end == p) break;
      (*local)[base + got] = v;
      ++got;
      p = end;
    }
    if (line_end) {
      if (got == 0) local->resize(base);  // blank/garbage line
      base = static_cast<size_t>(-1);
      got = dim;
    }
    // else: same logical line continues in the next chunk
  }
  if (base != static_cast<size_t>(-1) && got == 0) local->resize(base);
  std::fclose(f);
}

}  // namespace

extern "C" {

void* ptds_new() { return new Dataset(); }

void ptds_free(void* h) { delete static_cast<Dataset*>(h); }

void ptds_set_filelist(void* h, const char** files, int n) {
  auto* ds = static_cast<Dataset*>(h);
  ds->files.assign(files, files + n);
}

// Parallel parse of the filelist into the flat in-memory store.
// Returns the number of records loaded.
int64_t ptds_load_into_memory(void* h, int record_dim, int nthreads) {
  auto* ds = static_cast<Dataset*>(h);
  ds->record_dim = record_dim;
  ds->data.clear();
  ds->next_file.store(0);
  if (nthreads < 1) nthreads = 1;
  // one buffer PER FILE, concatenated in filelist order: record order is
  // deterministic regardless of thread scheduling (required for the
  // shared-seed global_shuffle sharding to partition correctly)
  std::vector<std::vector<float>> locals(ds->files.size());
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    workers.emplace_back([ds, &locals]() {
      for (;;) {
        int64_t i = ds->next_file.fetch_add(1);
        if (i >= static_cast<int64_t>(ds->files.size())) break;
        parse_file(ds, ds->files[i], &locals[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
  size_t total = 0;
  for (auto& l : locals) total += l.size();
  ds->data.reserve(total);
  for (auto& l : locals)
    ds->data.insert(ds->data.end(), l.begin(), l.end());
  int64_t n = static_cast<int64_t>(ds->data.size()) / record_dim;
  ds->order.resize(n);
  for (int64_t i = 0; i < n; ++i) ds->order[i] = i;
  return n;
}

int64_t ptds_num_records(void* h) {
  // post-shard visible record count = size of the permutation
  auto* ds = static_cast<Dataset*>(h);
  return static_cast<int64_t>(ds->order.size());
}

// Restore the identity permutation over all loaded records (undoes
// shuffle + shard; lets global_shuffle re-derive a fresh partition).
void ptds_reset_order(void* h) {
  auto* ds = static_cast<Dataset*>(h);
  int64_t n = ds->record_dim
                  ? static_cast<int64_t>(ds->data.size()) / ds->record_dim
                  : 0;
  ds->order.resize(n);
  for (int64_t i = 0; i < n; ++i) ds->order[i] = i;
}

// Fisher-Yates over the index permutation (reference LocalShuffle).
void ptds_local_shuffle(void* h, uint64_t seed) {
  auto* ds = static_cast<Dataset*>(h);
  std::mt19937_64 gen(seed);
  std::shuffle(ds->order.begin(), ds->order.end(), gen);
}

// Gather records [start, start+count) of the current permutation into out
// (count * record_dim floats).  Returns records actually written.
int64_t ptds_get_batch(void* h, int64_t start, int64_t count, float* out) {
  auto* ds = static_cast<Dataset*>(h);
  int64_t n = ptds_num_records(h);
  int64_t written = 0;
  const int dim = ds->record_dim;
  for (int64_t i = start; i < start + count && i < n; ++i, ++written) {
    std::memcpy(out + written * dim, ds->data.data() + ds->order[i] * dim,
                sizeof(float) * dim);
  }
  return written;
}

// Keep every k-th record starting at r (rank r of world k) — the local
// shard of a globally shuffled dataset (reference GlobalShuffle semantics:
// shared seed + per-rank selection, no data motion needed on one host).
void ptds_shard(void* h, int64_t rank, int64_t world) {
  auto* ds = static_cast<Dataset*>(h);
  if (world <= 1) return;
  std::vector<int64_t> kept;
  for (size_t i = rank; i < ds->order.size();
       i += static_cast<size_t>(world))
    kept.push_back(ds->order[i]);
  ds->order.swap(kept);
}

void ptds_release_memory(void* h) {
  auto* ds = static_cast<Dataset*>(h);
  ds->data.clear();
  ds->data.shrink_to_fit();
  ds->order.clear();
}

}  // extern "C"
