// Native MPMC blocking queue for the data pipeline.
//
// Reference parity: paddle/fluid/framework/blocking_queue.h and
// operators/reader/blocking_queue.h — the bounded producer/consumer
// channel under the reference's DataLoader/buffered_reader.  Python's
// queue.Queue acquires the GIL on every op; this queue lets worker
// threads hand off batch buffers with a plain pthread mutex so the
// consumer thread wakes without GIL traffic, and stores ordered slots so
// out-of-order workers still yield deterministic batch order.
//
// C ABI (ctypes-friendly): queues hold (seq, ptr, len) triples; payload
// ownership stays with the Python side (buffers are pre-registered and
// identified by index).
//
// Build: paddle_tpu_torch/csrc/__init__.py compiles this file and
// dataset.cc with c++ into build/paddle_tpu_torch/ at first use.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>

namespace {

struct Item {
  int64_t seq;
  void* data;
  int64_t len;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(int64_t capacity, bool ordered)
      : capacity_(capacity), ordered_(ordered) {}

  // Returns 0 on success, -1 if closed.
  int Put(int64_t seq, void* data, int64_t len) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return closed_ || Size() < capacity_; });
    if (closed_) return -1;
    if (ordered_) {
      pending_[seq] = Item{seq, data, len};
      // drain in-order prefix into the ready deque
      while (!pending_.empty() && pending_.begin()->first == next_seq_) {
        ready_.push_back(pending_.begin()->second);
        pending_.erase(pending_.begin());
        ++next_seq_;
      }
    } else {
      ready_.push_back(Item{seq, data, len});
    }
    not_empty_.notify_all();
    return 0;
  }

  // Returns 0 on success (out params filled), -1 if closed+drained,
  // -2 on timeout.
  int Get(int64_t timeout_ms, int64_t* seq, void** data, int64_t* len) {
    std::unique_lock<std::mutex> lk(mu_);
    auto pred = [&] { return closed_ || !ready_.empty(); };
    if (timeout_ms < 0) {
      not_empty_.wait(lk, pred);
    } else if (!not_empty_.wait_for(
                   lk, std::chrono::milliseconds(timeout_ms), pred)) {
      return -2;
    }
    if (ready_.empty()) return -1;  // closed and drained
    Item it = ready_.front();
    ready_.pop_front();
    *seq = it.seq;
    *data = it.data;
    *len = it.len;
    not_full_.notify_all();
    return 0;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  int64_t ApproxSize() {
    std::lock_guard<std::mutex> lk(mu_);
    return Size();
  }

 private:
  int64_t Size() const {
    return static_cast<int64_t>(ready_.size() + pending_.size());
  }

  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Item> ready_;
  std::map<int64_t, Item> pending_;  // out-of-order staging (ordered mode)
  int64_t capacity_;
  int64_t next_seq_ = 0;
  bool ordered_;
  bool closed_ = false;
};

}  // namespace

extern "C" {

void* ptq_new(int64_t capacity, int ordered) {
  return new BlockingQueue(capacity, ordered != 0);
}

int ptq_put(void* q, int64_t seq, void* data, int64_t len) {
  return static_cast<BlockingQueue*>(q)->Put(seq, data, len);
}

int ptq_get(void* q, int64_t timeout_ms, int64_t* seq, void** data,
            int64_t* len) {
  return static_cast<BlockingQueue*>(q)->Get(timeout_ms, seq, data, len);
}

void ptq_close(void* q) { static_cast<BlockingQueue*>(q)->Close(); }

int64_t ptq_size(void* q) {
  return static_cast<BlockingQueue*>(q)->ApproxSize();
}

void ptq_free(void* q) { delete static_cast<BlockingQueue*>(q); }

const char* ptq_source_hash() {
  // sha256 of (blocking_queue.cc + dataset.cc) at build time; the
  // ctypes loader rebuilds when it disagrees with the sources on disk
#ifndef PTQ_SRC_HASH
#define PTQ_SRC_HASH "unknown"
#endif
  return PTQ_SRC_HASH;
}

}  // extern "C"
