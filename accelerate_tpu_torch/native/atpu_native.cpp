// Native host-IO runtime of accelerate_tpu_torch: threaded reads on the host.
//
// The port's own copy of the JAX package's library, byte for byte in its
// code. The card's input side is fed from the host: this library moves the
// bytes. Two primitives, exposed through a C ABI for ctypes:
//
//   1. par_read: parallel pread of many file regions into caller buffers
//      (used to load safetensors shards with one thread per stripe instead
//      of a single-threaded per-tensor loop).
//   2. A prefetch ring: a producer thread assembles fixed-size batches from
//      sample regions of a data file via a worker pool, `depth` batches
//      ahead of the consumer, into preallocated slots (bounded memory).
//      Sample schedule (shuffle/shard/skip) is decided by Python and passed
//      as explicit offsets — policy stays composable, C++ only moves bytes.
//
// Build: g++ -O3 -shared -fPIC -pthread (native/__init__.py, at first use).
// No deps beyond the C++17 standard library and POSIX pread.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Worker pool reading [offset, offset+size) regions into dest pointers.
// Returns 0 on success, -1 if any read failed or came up short.
int read_regions(int fd, const int64_t* offsets, const int64_t* sizes,
                 unsigned char* const* dests, int64_t n, int threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      int64_t off = offsets[i], remaining = sizes[i];
      unsigned char* dst = dests[i];
      while (remaining > 0) {
        ssize_t got = pread(fd, dst, static_cast<size_t>(remaining), off);
        if (got <= 0) { failed.store(1); return; }
        dst += got; off += got; remaining -= got;
      }
    }
  };
  int nt = static_cast<int>(std::min<int64_t>(threads, n));
  if (nt <= 1) { worker(); return failed.load() ? -1 : 0; }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load() ? -1 : 0;
}

struct Ring {
  int fd = -1;
  std::vector<int64_t> sample_offsets;  // byte offset of each scheduled sample
  int64_t sample_bytes = 0;
  int64_t batch_size = 0;
  int threads = 1;

  int64_t num_batches = 0;      // ceil(n_samples / batch_size)
  std::vector<std::vector<unsigned char>> slots;
  std::vector<int64_t> slot_batch;       // which batch a slot holds (-1 free)
  std::vector<int64_t> slot_valid;       // valid samples in that batch
  std::deque<int> free_slots;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  int64_t next_produce = 0;     // producer's next batch index
  int64_t next_consume = 0;     // consumer's next batch index
  bool stop = false;
  int error = 0;
  std::thread producer;

  ~Ring() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    if (producer.joinable()) producer.join();
    if (fd >= 0) close(fd);
  }

  void produce_loop() {
    const int64_t n = static_cast<int64_t>(sample_offsets.size());
    std::vector<int64_t> offs(batch_size), sizes(batch_size);
    std::vector<unsigned char*> dests(batch_size);
    while (true) {
      int slot;
      int64_t b;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_slots.empty(); });
        if (stop || next_produce >= num_batches) return;
        slot = free_slots.front();
        free_slots.pop_front();
        b = next_produce++;
      }
      int64_t start = b * batch_size;
      int64_t valid = std::min(batch_size, n - start);
      for (int64_t i = 0; i < valid; ++i) {
        offs[i] = sample_offsets[start + i];
        sizes[i] = sample_bytes;
        dests[i] = slots[slot].data() + i * sample_bytes;
      }
      int rc = read_regions(fd, offs.data(), sizes.data(), dests.data(), valid, threads);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (rc != 0) error = 1;
        slot_batch[slot] = b;
        slot_valid[slot] = valid;
      }
      cv_ready.notify_all();
      {
        std::lock_guard<std::mutex> lk(mu);
        if (next_produce >= num_batches) { cv_ready.notify_all(); }
        if (stop) return;
      }
    }
  }
};

}  // namespace

extern "C" {

// Source-hash stamp, injected at build time (-DATPU_SOURCE_HASH="...").
// The loader greps the binary for the "ATPU_HASH:<hash>" literal before
// dlopen-ing, so a stale or tampered cache is rebuilt instead of trusted.
#ifndef ATPU_SOURCE_HASH
#define ATPU_SOURCE_HASH "unstamped"
#endif
const char* atpu_source_hash() { return "ATPU_HASH:" ATPU_SOURCE_HASH; }

// Parallel gather of n regions from path into dests. Returns 0 / -1.
int atpu_par_read(const char* path, const int64_t* offsets, const int64_t* sizes,
                  unsigned char* const* dests, int64_t n, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int rc = read_regions(fd, offsets, sizes, dests, n, threads);
  close(fd);
  return rc;
}

// Create a prefetch ring over `path`. The schedule is `n_samples` byte
// offsets, each a region of `sample_bytes`. Batches of `batch_size` samples
// are assembled `depth` ahead by a producer thread using `threads` readers.
void* atpu_ring_create(const char* path, const int64_t* sample_offsets,
                       int64_t n_samples, int64_t sample_bytes,
                       int64_t batch_size, int depth, int threads) {
  if (n_samples <= 0 || sample_bytes <= 0 || batch_size <= 0 || depth <= 0) return nullptr;
  auto* r = new Ring();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) { delete r; return nullptr; }
  r->sample_offsets.assign(sample_offsets, sample_offsets + n_samples);
  r->sample_bytes = sample_bytes;
  r->batch_size = batch_size;
  r->threads = std::max(threads, 1);
  r->num_batches = (n_samples + batch_size - 1) / batch_size;
  int nslots = static_cast<int>(std::min<int64_t>(depth, r->num_batches));
  r->slots.resize(nslots);
  r->slot_batch.assign(nslots, -1);
  r->slot_valid.assign(nslots, 0);
  for (int i = 0; i < nslots; ++i) {
    r->slots[i].resize(static_cast<size_t>(batch_size * sample_bytes));
    r->free_slots.push_back(i);
  }
  r->producer = std::thread([r] { r->produce_loop(); });
  return r;
}

int64_t atpu_ring_num_batches(void* h) {
  return h ? static_cast<Ring*>(h)->num_batches : -1;
}

// Pop the next batch in order into `out` (batch_size*sample_bytes).
// Returns number of valid samples, 0 when exhausted, -1 on IO error.
int64_t atpu_ring_next(void* h, unsigned char* out) {
  auto* r = static_cast<Ring*>(h);
  if (!r) return -1;
  int64_t want;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->next_consume >= r->num_batches) return 0;
    want = r->next_consume;
  }
  int slot = -1;
  int64_t valid = 0;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_ready.wait(lk, [&] {
      if (r->error || r->stop) return true;
      for (size_t i = 0; i < r->slot_batch.size(); ++i)
        if (r->slot_batch[i] == want) return true;
      return false;
    });
    if (r->error) return -1;
    if (r->stop) return 0;
    for (size_t i = 0; i < r->slot_batch.size(); ++i)
      if (r->slot_batch[i] == want) { slot = static_cast<int>(i); break; }
    valid = r->slot_valid[slot];
  }
  std::memcpy(out, r->slots[slot].data(),
              static_cast<size_t>(valid * r->sample_bytes));
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->slot_batch[slot] = -1;
    r->free_slots.push_back(slot);
    r->next_consume = want + 1;
  }
  r->cv_free.notify_all();
  return valid;
}

void atpu_ring_destroy(void* h) { delete static_cast<Ring*>(h); }

}  // extern "C"
