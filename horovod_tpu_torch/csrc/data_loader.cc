// Native data loader of the PyTorch port (horovod_tpu_torch/data).
//
// A host reader, not a device kernel: the port's own copy of the JAX
// package's loader (horovod_tpu/native/data_loader.cc), same semantics,
// so that native and Python streams stay bitwise identical. The host
// must hide IO latency behind device steps, so this loader does the
// reference's per-worker dataset sharding
// (examples/keras_mnist_advanced.py:113-119 divides work by hvd.size())
// natively:
//
//   * fixed-size binary records in shard files,
//   * shards assigned round-robin by rank (file i -> rank i % world),
//   * reader threads fill a bounded prefetch queue of ready batches
//     (double buffering: the host reads batch k+1 while the device
//     runs step k),
//   * optional within-shard record shuffling, deterministic by
//     (seed, epoch) on every rank — a splitmix64-keyed stable sort,
//     chosen over std::shuffle because the SAME permutation is
//     reproducible from numpy in the pure-Python fallback
//     (horovod_tpu_torch/data `shuffle_perm`): native and fallback
//     yield bitwise-identical batch streams, the exact-resume contract,
//   * mid-epoch resume: hvd_dl_start_epoch_at skips the first
//     start_record entries of the (already shuffled) epoch order, so a
//     checkpointed data cursor restarts the stream at batch k without
//     re-reading batches 0..k-1 on the host.
//
// Plain C ABI consumed via ctypes (horovod_tpu_torch/data). Built at
// first use by horovod_tpu_torch/ops/_build.py::build_host:
// c++ -O2 -std=c++17 -shared -fPIC -pthread data_loader.cc -o <lib>.so

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// splitmix64 finalizer (Steele et al.) — the shared shuffle key both
// this loader and the Python fallback compute. Permutation = stable
// sort of indices by Mix64(seed * GOLDEN + epoch + i); stable so ties
// (astronomically unlikely) break identically to numpy's stable
// argsort.
inline uint64_t Mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Batch {
  std::vector<uint8_t> data;
  int64_t records = 0;
};

struct Loader {
  std::vector<std::string> files;   // this rank's shards
  int64_t record_bytes = 0;
  int64_t batch_records = 0;
  int64_t capacity = 0;             // max prefetched batches
  uint64_t seed = 0;
  bool shuffle = false;
  bool drop_remainder = false;

  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<Batch> queue;
  bool epoch_done = false;          // producer finished current epoch
  // Atomic: written in hvd_dl_start_epoch under the mutex but read
  // lock-free from the producer's hot loop via Stopping().
  std::atomic<bool> abort_epoch{false};
  std::atomic<bool> closed{false};
  std::thread producer;
  std::string error;

  // Sets error under the lock and wakes the consumer — a consumer
  // already parked in hvd_dl_next must re-evaluate its predicate.
  void Fail(const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu);
    error = msg;
    not_empty.notify_all();
  }

  bool Stopping() const {
    return closed.load() || abort_epoch.load();
  }

  ~Loader() {
    {
      // Hold the mutex while flipping closed: a producer between
      // predicate check and park would otherwise miss the wakeup.
      std::lock_guard<std::mutex> lk(mu);
      closed.store(true);
      not_full.notify_all();
      not_empty.notify_all();
    }
    if (producer.joinable()) producer.join();
  }
};

// Reads one epoch: every record of every owned shard, in shuffled order
// when requested, packed into batches pushed to the bounded queue.
// `start_record` entries of the epoch order are skipped first (the
// exact-resume fast path: resume at batch k costs zero reads of
// batches 0..k-1).
void ProduceEpoch(Loader* L, uint64_t epoch, int64_t start_record) {
  std::vector<std::pair<int, int64_t>> order;  // (file idx, record idx)
  std::vector<int64_t> counts(L->files.size(), 0);
  for (size_t fi = 0; fi < L->files.size(); ++fi) {
    FILE* f = fopen(L->files[fi].c_str(), "rb");
    if (!f) {
      L->Fail("cannot open " + L->files[fi]);
      return;
    }
    fseek(f, 0, SEEK_END);
    int64_t bytes = ftell(f);
    fclose(f);
    counts[fi] = bytes / L->record_bytes;
    for (int64_t r = 0; r < counts[fi]; ++r) order.emplace_back(fi, r);
  }
  if (L->shuffle) {
    const uint64_t base = L->seed * 0x9E3779B97F4A7C15ULL + epoch;
    std::vector<uint64_t> keys(order.size());
    for (size_t i = 0; i < order.size(); ++i) keys[i] = Mix64(base + i);
    std::vector<size_t> perm(order.size());
    for (size_t i = 0; i < perm.size(); ++i) perm[i] = i;
    std::stable_sort(perm.begin(), perm.end(),
                     [&keys](size_t a, size_t b) {
                       return keys[a] < keys[b];
                     });
    std::vector<std::pair<int, int64_t>> shuffled(order.size());
    for (size_t i = 0; i < perm.size(); ++i) shuffled[i] = order[perm[i]];
    order.swap(shuffled);
  }
  if (start_record > 0) {
    order.erase(order.begin(),
                order.begin() + std::min<int64_t>(
                    start_record, static_cast<int64_t>(order.size())));
  }

  Batch cur;
  cur.data.reserve(L->batch_records * L->record_bytes);
  int open_idx = -1;
  FILE* f = nullptr;
  std::vector<uint8_t> rec(L->record_bytes);
  for (auto& [fi, ri] : order) {
    if (L->Stopping()) break;
    if (fi != open_idx) {
      if (f) fclose(f);
      f = fopen(L->files[fi].c_str(), "rb");
      open_idx = fi;
      if (!f) {
        L->Fail("cannot reopen " + L->files[fi]);
        return;
      }
    }
    // Sequential reads when unshuffled; seek per record otherwise.
    if (fseek(f, ri * L->record_bytes, SEEK_SET) != 0 ||
        fread(rec.data(), 1, L->record_bytes, f) !=
            static_cast<size_t>(L->record_bytes)) {
      if (f) fclose(f);
      L->Fail("short read in " + L->files[fi]);
      return;
    }
    cur.data.insert(cur.data.end(), rec.begin(), rec.end());
    if (++cur.records == L->batch_records) {
      std::unique_lock<std::mutex> lk(L->mu);
      L->not_full.wait(lk, [L] {
        return L->Stopping() ||
               static_cast<int64_t>(L->queue.size()) < L->capacity;
      });
      if (L->Stopping()) break;
      L->queue.push_back(std::move(cur));
      cur = Batch();
      cur.data.reserve(L->batch_records * L->record_bytes);
      L->not_empty.notify_one();
    }
  }
  if (f) fclose(f);
  if (!L->drop_remainder && cur.records > 0 && !L->Stopping()) {
    std::unique_lock<std::mutex> lk(L->mu);
    L->not_full.wait(lk, [L] {
      return L->Stopping() ||
             static_cast<int64_t>(L->queue.size()) < L->capacity;
    });
    if (!L->Stopping()) {
      L->queue.push_back(std::move(cur));
      L->not_empty.notify_one();
    }
  }
  std::lock_guard<std::mutex> lk(L->mu);
  L->epoch_done = true;
  L->not_empty.notify_all();
}

}  // namespace

extern "C" {

// Creates a loader over `nfiles` NUL-terminated shard paths. Shards are
// assigned to this rank round-robin (i % world == rank). Returns an
// opaque handle, or 0 on bad arguments.
void* hvd_dl_open(const char** paths, int64_t nfiles,
                  int64_t record_bytes, int64_t batch_records,
                  int64_t capacity, int shuffle, uint64_t seed,
                  int64_t rank, int64_t world, int drop_remainder) {
  if (nfiles <= 0 || record_bytes <= 0 || batch_records <= 0 ||
      world <= 0 || rank < 0 || rank >= world) {
    return nullptr;
  }
  auto* L = new Loader();
  for (int64_t i = 0; i < nfiles; ++i) {
    if (i % world == rank) L->files.emplace_back(paths[i]);
  }
  L->record_bytes = record_bytes;
  L->batch_records = batch_records;
  L->capacity = capacity > 0 ? capacity : 4;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->drop_remainder = drop_remainder != 0;
  return L;
}

// Starts producing epoch `epoch` in the background at record offset
// `start_record` of the (shuffled) epoch order — the data-cursor
// resume entry point. Call once per epoch, then drain with
// hvd_dl_next until it returns 0.
int hvd_dl_start_epoch_at(void* handle, uint64_t epoch,
                          int64_t start_record) {
  auto* L = static_cast<Loader*>(handle);
  if (!L || L->closed.load() || start_record < 0) return -1;
  // The previous epoch may have been abandoned mid-drain with its
  // producer parked on a full queue: abort it, join, and discard any
  // stale batches so epoch N+1 never serves epoch-N data.
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->abort_epoch = true;
    L->not_full.notify_all();
    L->not_empty.notify_all();
  }
  if (L->producer.joinable()) L->producer.join();
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->queue.clear();
    L->abort_epoch = false;
    L->epoch_done = false;
    L->error.clear();
  }
  L->producer = std::thread(ProduceEpoch, L, epoch, start_record);
  return 0;
}

// Back-compat entry: a full epoch from record 0.
int hvd_dl_start_epoch(void* handle, uint64_t epoch) {
  return hvd_dl_start_epoch_at(handle, epoch, 0);
}

// Copies the next prefetched batch into `out` (capacity
// batch_records*record_bytes). Returns the number of records copied,
// 0 at epoch end, -1 on error/closed (hvd_dl_error explains).
int64_t hvd_dl_next(void* handle, uint8_t* out) {
  auto* L = static_cast<Loader*>(handle);
  if (!L) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  L->not_empty.wait(lk, [L] {
    return L->closed.load() || !L->queue.empty() || L->epoch_done ||
           !L->error.empty();
  });
  if (L->closed.load() || !L->error.empty()) return -1;
  if (L->queue.empty()) return 0;  // epoch_done and drained
  Batch b = std::move(L->queue.front());
  L->queue.pop_front();
  L->not_full.notify_one();
  lk.unlock();
  std::memcpy(out, b.data.data(), b.data.size());
  return b.records;
}

// Number of records this rank owns across its shards (for
// steps-per-epoch math; reference keras_mnist_advanced.py:113-119).
int64_t hvd_dl_num_records(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  if (!L) return -1;
  int64_t total = 0;
  for (auto& path : L->files) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    total += ftell(f) / L->record_bytes;
    fclose(f);
  }
  return total;
}

const char* hvd_dl_error(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  static thread_local std::string copy;
  if (!L) return "null handle";
  std::lock_guard<std::mutex> lk(L->mu);
  copy = L->error;
  return copy.c_str();
}

void hvd_dl_close(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
