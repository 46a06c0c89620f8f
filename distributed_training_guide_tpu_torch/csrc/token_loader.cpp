// Native token-batch loader: mmap + background prefetch assembly.
//
// The reference leans on torch's native DataLoader machinery (C++ pin-memory
// threads, reference C13/C26 — `related-topics/optimizing-data-loading`).
// This is the TPU-framework's native equivalent: a small C++ core that
//   - mmaps a flat int32 token file (zero-copy, page-cache backed),
//   - views it as [n_sequences, seq_len],
//   - deterministically shuffles sequence order per (seed, epoch)
//     (Fisher-Yates over mt19937_64 — stable across platforms),
//   - assembles [batch, seq_len] batches on worker threads *ahead* of the
//     consumer (bounded prefetch), releasing the GIL entirely (caller is
//     ctypes), so host-side batch assembly overlaps device compute.
//
// C ABI for ctypes (see ../data/native_loader.py). Single-consumer.
//
// Build (done on demand by ../data/native_loader.py):
//   g++ -O3 -shared -fPIC -std=c++17 -o libtokenloader.so token_loader.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <numeric>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Loader {
  int fd = -1;
  const int32_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t seq_len = 0;
  int64_t batch = 0;
  size_t n_seqs = 0;
  size_t n_batches = 0;
  uint64_t seed = 0;
  int64_t epoch = -1;
  int n_threads = 2;
  size_t prefetch_depth = 4;

  std::vector<uint32_t> perm;

  // prefetch machinery
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for its batch
  std::condition_variable cv_space;   // workers wait for queue space
  std::map<size_t, std::vector<int32_t>> ready;  // batch idx -> tokens
  std::atomic<size_t> next_claim{0};  // next batch index a worker builds
  size_t next_consume = 0;            // next batch index consumer takes
  bool stopping = false;

  void shuffle_for_epoch(int64_t e) {
    perm.resize(n_seqs);
    std::iota(perm.begin(), perm.end(), 0u);
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)e + 1);
    for (size_t i = n_seqs - 1; i > 0; --i) {
      size_t j = rng() % (i + 1);
      std::swap(perm[i], perm[j]);
    }
    epoch = e;
  }

  void worker_loop() {
    for (;;) {
      size_t idx = next_claim.fetch_add(1);
      if (idx >= n_batches) return;
      std::vector<int32_t> buf((size_t)batch * seq_len);
      for (int64_t b = 0; b < batch; ++b) {
        size_t seq = perm[idx * batch + b];
        std::memcpy(buf.data() + b * seq_len, data + (size_t)seq * seq_len,
                    sizeof(int32_t) * seq_len);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stopping || ready.size() < prefetch_depth ||
               idx < next_consume + prefetch_depth;
      });
      if (stopping) return;
      ready.emplace(idx, std::move(buf));
      cv_ready.notify_all();
    }
  }

  void start_epoch(int64_t e, size_t start_batch) {
    stop_workers();
    if (epoch != e) shuffle_for_epoch(e);
    {
      std::lock_guard<std::mutex> lk(mu);
      ready.clear();
      next_consume = start_batch;
      stopping = false;
    }
    next_claim.store(start_batch);
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { worker_loop(); });
  }

  void stop_workers() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
    std::lock_guard<std::mutex> lk(mu);
    stopping = false;
  }

  // returns 1 on success, 0 at end of epoch
  int next(int32_t* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_consume >= n_batches) return 0;
    size_t want = next_consume;
    cv_ready.wait(lk, [&] { return stopping || ready.count(want); });
    if (stopping) return 0;
    auto node = ready.extract(want);
    next_consume = want + 1;
    lk.unlock();
    cv_space.notify_all();
    std::memcpy(out, node.mapped().data(),
                sizeof(int32_t) * (size_t)batch * seq_len);
    return 1;
  }
};

}  // namespace

extern "C" {

void* tl_open(const char* path, int64_t seq_len, int64_t batch, uint64_t seed,
              int n_threads, int prefetch_depth) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(map, st.st_size, MADV_SEQUENTIAL);
  auto* L = new Loader();
  L->fd = fd;
  L->data = static_cast<const int32_t*>(map);
  L->file_bytes = st.st_size;
  L->seq_len = seq_len;
  L->batch = batch;
  L->n_seqs = (size_t)(st.st_size / sizeof(int32_t)) / seq_len;
  L->n_batches = L->n_seqs / batch;
  L->seed = seed;
  L->n_threads = n_threads > 0 ? n_threads : 2;
  L->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
  return L;
}

int64_t tl_num_batches(void* h) { return ((Loader*)h)->n_batches; }
int64_t tl_num_sequences(void* h) { return ((Loader*)h)->n_seqs; }

void tl_start_epoch(void* h, int64_t epoch, int64_t start_batch) {
  ((Loader*)h)->start_epoch(epoch, (size_t)start_batch);
}

int tl_next_batch(void* h, int32_t* out) { return ((Loader*)h)->next(out); }

void tl_close(void* h) {
  auto* L = (Loader*)h;
  L->stop_workers();
  munmap((void*)L->data, L->file_bytes);
  ::close(L->fd);
  delete L;
}

}  // extern "C"
