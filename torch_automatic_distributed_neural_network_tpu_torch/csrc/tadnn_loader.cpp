// Native data loader: the JAX package's native/tadnn_loader.cpp, copied
// for the PyTorch package (data/loader.py builds it with g++ at first use
// and binds it with ctypes).
//
// Reads a binary token corpus (header + flat little-endian tokens),
// serves step-indexed [batch, seq_len+1] windows with a deterministic
// per-epoch affine shuffle, and prefetches ahead on a background thread
// so the host-side input pipeline never blocks the training loop.
//
// Determinism contract (mirrored bit-for-bit by the Python fallback in
// data/loader.py): window w of epoch e maps to file window
//   perm_e(w) = (a_e * w + c_e) % n_windows
// with a_e/c_e derived from splitmix64(seed, epoch) and a_e forced odd
// and coprime to n_windows, so batch(step) is a pure function of
// (file, seq_len, batch_size, seed, step) — a resumed run sees the
// same batches (training/elastic.py).
//
// File format "TADN" v1:
//   u32 magic 0x4E444154 ("TADN") | u32 version=1 | u32 dtype (2|4 bytes)
//   u64 n_tokens | tokens...

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x4E444154;  // "TADN" little-endian

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

uint64_t gcd64(uint64_t a, uint64_t b) {
  while (b) {
    uint64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t dtype_bytes;
  uint32_t pad;
  uint64_t n_tokens;
};

struct Loader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  const uint8_t* tokens = nullptr;  // past the header
  uint64_t n_tokens = 0;
  uint32_t dtype_bytes = 2;

  int64_t seq_len = 0;    // window is seq_len + 1 tokens
  int64_t batch = 0;
  uint64_t seed = 0;
  uint64_t n_windows = 0;

  // prefetch ring: slot s holds the batch for step ring_step[s]
  int depth = 0;
  std::vector<std::vector<uint32_t>> ring;
  std::vector<std::atomic<int64_t>> ring_step;
  std::atomic<int64_t> want{0};  // next step the consumer will ask for
  std::atomic<bool> stop{false};
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;

  void epoch_params(uint64_t epoch, uint64_t* a, uint64_t* c) const {
    uint64_t s = splitmix64(seed ^ (epoch * 0x5851F42D4C957F2DULL + 1));
    uint64_t av = (splitmix64(s) % n_windows) | 1ULL;  // odd
    while (gcd64(av, n_windows) != 1) av += 2;
    *a = av % n_windows ? av % n_windows : 1;
    // av could reduce to 0 only if n_windows==1; guard keeps a valid
    *c = splitmix64(s + 1) % n_windows;
  }

  uint64_t window_start(int64_t global_row) const {
    uint64_t epoch = static_cast<uint64_t>(global_row) / n_windows;
    uint64_t w = static_cast<uint64_t>(global_row) % n_windows;
    uint64_t a, c;
    epoch_params(epoch, &a, &c);
    uint64_t pw = (a * w + c) % n_windows;
    return pw * static_cast<uint64_t>(seq_len);
  }

  void fill(int64_t step, uint32_t* out) const {
    const int64_t width = seq_len + 1;
    for (int64_t r = 0; r < batch; ++r) {
      uint64_t start = window_start(step * batch + r);
      const uint8_t* src = tokens + start * dtype_bytes;
      uint32_t* dst = out + r * width;
      if (dtype_bytes == 2) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        for (int64_t i = 0; i < width; ++i) dst[i] = s16[i];
      } else {
        std::memcpy(dst, src, width * sizeof(uint32_t));
      }
    }
  }

  // Slot protocol (seqlock-style): the worker marks a slot kFilling
  // before writing and stores the step after; a consumer that read
  // `step` before copying re-checks after the copy — any concurrent
  // overwrite leaves the slot != step at the re-check (a slot is reused
  // only for step + k*depth, never the same value), so a torn copy is
  // always detected and recomputed synchronously.
  static constexpr int64_t kFilling = -2;

  void prefetch_loop() {
    while (!stop.load(std::memory_order_acquire)) {
      int64_t base = want.load(std::memory_order_acquire);
      bool did = false;
      for (int d = 0; d < depth; ++d) {
        int64_t step = base + d;
        int slot = static_cast<int>(step % depth);
        if (ring_step[slot].load(std::memory_order_acquire) != step) {
          ring_step[slot].store(kFilling, std::memory_order_relaxed);
          // full fence: the kFilling store must become visible before
          // any of fill()'s plain data writes (store-store barrier), or
          // a consumer's torn copy could pass its re-check
          std::atomic_thread_fence(std::memory_order_seq_cst);
          fill(step, ring[slot].data());
          ring_step[slot].store(step, std::memory_order_release);
          did = true;
        }
      }
      if (!did) {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait_for(lk, std::chrono::milliseconds(50));
      }
    }
  }
};

}  // namespace

extern "C" {

void* tadnn_loader_open(const char* path, int64_t seq_len, int64_t batch,
                        uint64_t seed, int prefetch_depth) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  const Header* h = reinterpret_cast<const Header*>(map);
  if (h->magic != kMagic || h->version != 1 ||
      (h->dtype_bytes != 2 && h->dtype_bytes != 4)) {
    munmap(map, st.st_size);
    close(fd);
    return nullptr;
  }
  if (h->n_tokens > (UINT64_MAX - sizeof(Header)) / h->dtype_bytes) {
    munmap(map, st.st_size);  // header would overflow the size check
    close(fd);
    return nullptr;
  }
  uint64_t needed = sizeof(Header) + h->n_tokens * h->dtype_bytes;
  if (static_cast<uint64_t>(st.st_size) < needed ||
      h->n_tokens < static_cast<uint64_t>(seq_len) + 1) {
    munmap(map, st.st_size);
    close(fd);
    return nullptr;
  }

  Loader* L = new Loader();
  L->fd = fd;
  L->map = static_cast<const uint8_t*>(map);
  L->map_len = st.st_size;
  L->tokens = L->map + sizeof(Header);
  L->n_tokens = h->n_tokens;
  L->dtype_bytes = h->dtype_bytes;
  L->seq_len = seq_len;
  L->batch = batch;
  L->seed = seed;
  L->n_windows = (h->n_tokens - 1) / static_cast<uint64_t>(seq_len);
  L->depth = prefetch_depth > 0 ? prefetch_depth : 0;
  if (L->depth) {
    L->ring.resize(L->depth);
    for (auto& v : L->ring) v.resize(batch * (seq_len + 1));
    L->ring_step = std::vector<std::atomic<int64_t>>(L->depth);
    for (auto& s : L->ring_step) s.store(-1);
    L->worker = std::thread([L] { L->prefetch_loop(); });
  }
  return L;
}

int64_t tadnn_loader_n_windows(void* handle) {
  return static_cast<Loader*>(handle)->n_windows;
}

// Copies batch `step` into out[batch * (seq_len+1)] (uint32). Serves from
// the prefetch ring when the slot is ready, else computes synchronously.
int tadnn_loader_batch(void* handle, int64_t step, uint32_t* out) {
  Loader* L = static_cast<Loader*>(handle);
  if (step < 0) return -1;
  if (L->depth) {
    int slot = static_cast<int>(step % L->depth);
    bool served = false;
    if (L->ring_step[slot].load(std::memory_order_acquire) == step) {
      // Seqlock-pattern read: the memcpy races the worker's fill() when
      // the worker laps the ring between our two ring_step loads.  The
      // plain (non-atomic) copy of racing memory is formally UB in the
      // C++ memory model; it is the standard seqlock trade-off, accepted
      // deliberately here because (a) the re-check below discards any
      // torn copy before it is observable, (b) the data is plain
      // uint32 with no invariants a torn read could violate mid-copy,
      // and (c) copying through per-word relaxed atomics would forfeit
      // the vectorized memcpy on the hot path.  The acquire fence orders
      // the copy before the confirming load (the "version re-check").
      std::memcpy(out, L->ring[slot].data(),
                  L->ring[slot].size() * sizeof(uint32_t));
      std::atomic_thread_fence(std::memory_order_acquire);
      served =
          L->ring_step[slot].load(std::memory_order_relaxed) == step;
    }
    if (!served) L->fill(step, out);
    // monotonic max: replaying an old step (elastic resume) must not
    // rewind the ring and discard prefetched future batches
    int64_t cur = L->want.load(std::memory_order_relaxed);
    while (cur < step + 1 &&
           !L->want.compare_exchange_weak(cur, step + 1,
                                          std::memory_order_release)) {
    }
    L->cv.notify_one();
  } else {
    L->fill(step, out);
  }
  return 0;
}

void tadnn_loader_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (L->depth) {
    L->stop.store(true);
    L->cv.notify_one();
    if (L->worker.joinable()) L->worker.join();
  }
  munmap(const_cast<uint8_t*>(L->map), L->map_len);
  close(L->fd);
  delete L;
}

}  // extern "C"
