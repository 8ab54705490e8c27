// Shared-memory transport primitives of the Ape-X actor/learner split
// (the port's copy of dist_dqn_tpu/actors/_native/transport.cc, the same
// layout in shared memory).
//
//   * Ring   — multi-producer/single-consumer byte-record ring over a
//              file-backed mmap (works on /dev/shm and plain tmpfs alike).
//              A process-shared robust pthread mutex guards the head/tail
//              bookkeeping; the payload memcpy is the critical section.
//   * Mailbox— single-writer/many-reader seqlock broadcast slot: the act
//              reply channel of one actor. Readers never block the writer.
//
// Exposed as a C ABI for ctypes; built with g++ at first use
// (actors/transport.py build_native_lib).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x44514E5452494E47ull;  // "DQNTRING"

struct RingHeader {
  uint64_t magic;
  uint64_t capacity;  // data region size in bytes
  pthread_mutex_t mu;
  uint64_t head;      // monotonic write offset
  uint64_t tail;      // monotonic read offset
  uint64_t dropped;   // pushes rejected for lack of space
};

struct BoxHeader {
  uint64_t magic;
  uint64_t max_size;
  std::atomic<uint64_t> seq;  // seqlock: odd = write in progress
  uint64_t len;
  uint64_t version;
};

inline uint8_t* ring_data(RingHeader* h) {
  return reinterpret_cast<uint8_t*>(h) + sizeof(RingHeader);
}

inline uint8_t* box_data(BoxHeader* h) {
  return reinterpret_cast<uint8_t*>(h) + sizeof(BoxHeader);
}

inline uint64_t pad8(uint64_t n) { return (n + 7) & ~7ull; }

void* map_file(const char* path, uint64_t size, bool create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = open(path, flags, 0600);
  if (fd < 0) return nullptr;
  if (create) {
    if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
      close(fd);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    size = static_cast<uint64_t>(st.st_size);
  }
  void* p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  return p == MAP_FAILED ? nullptr : p;
}

// Copy into the circular data region starting at logical offset `off`.
void copy_in(RingHeader* h, uint64_t off, const uint8_t* src, uint64_t n) {
  uint64_t pos = off % h->capacity;
  uint64_t first = n < h->capacity - pos ? n : h->capacity - pos;
  std::memcpy(ring_data(h) + pos, src, first);
  if (n > first) std::memcpy(ring_data(h), src + first, n - first);
}

void copy_out(RingHeader* h, uint64_t off, uint8_t* dst, uint64_t n) {
  uint64_t pos = off % h->capacity;
  uint64_t first = n < h->capacity - pos ? n : h->capacity - pos;
  std::memcpy(dst, ring_data(h) + pos, first);
  if (n > first) std::memcpy(dst + first, ring_data(h), n - first);
}

}  // namespace

extern "C" {

void* dqn_ring_create(const char* path, uint64_t capacity) {
  uint64_t total = sizeof(RingHeader) + capacity;
  auto* h = static_cast<RingHeader*>(map_file(path, total, true));
  if (h == nullptr) return nullptr;
  h->magic = 0;
  h->capacity = capacity;
  h->head = h->tail = h->dropped = 0;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  // Robust: a producer dying mid-push must not deadlock the consumer.
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &attr);
  pthread_mutexattr_destroy(&attr);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  h->magic = kMagic;
  return h;
}

void* dqn_ring_attach(const char* path) {
  auto* h = static_cast<RingHeader*>(map_file(path, 0, false));
  if (h == nullptr || h->magic != kMagic) return nullptr;
  return h;
}

static int lock_mu(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

// 0 = ok, -1 = not enough space (recorded in `dropped`).
int dqn_ring_push(void* ring, const uint8_t* data, uint32_t len) {
  auto* h = static_cast<RingHeader*>(ring);
  uint64_t need = pad8(4ull + len);
  if (lock_mu(&h->mu) != 0) return -2;
  uint64_t free_b = h->capacity - (h->head - h->tail);
  if (need > free_b || need > h->capacity) {
    h->dropped++;
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  copy_in(h, h->head, reinterpret_cast<const uint8_t*>(&len), 4);
  copy_in(h, h->head + 4, data, len);
  h->head += need;
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Returns record length, -1 if empty.
long dqn_ring_peek_len(void* ring) {
  auto* h = static_cast<RingHeader*>(ring);
  if (lock_mu(&h->mu) != 0) return -2;
  long out = -1;
  if (h->head != h->tail) {
    uint32_t len;
    copy_out(h, h->tail, reinterpret_cast<uint8_t*>(&len), 4);
    out = static_cast<long>(len);
  }
  pthread_mutex_unlock(&h->mu);
  return out;
}

// Returns payload length; -1 empty; -2 out buffer too small (record kept).
long dqn_ring_pop(void* ring, uint8_t* out, uint64_t cap) {
  auto* h = static_cast<RingHeader*>(ring);
  if (lock_mu(&h->mu) != 0) return -3;
  if (h->head == h->tail) {
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  uint32_t len;
  copy_out(h, h->tail, reinterpret_cast<uint8_t*>(&len), 4);
  if (cap < len) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  copy_out(h, h->tail + 4, out, len);
  h->tail += pad8(4ull + len);
  pthread_mutex_unlock(&h->mu);
  return static_cast<long>(len);
}

uint64_t dqn_ring_dropped(void* ring) {
  return static_cast<RingHeader*>(ring)->dropped;
}

uint64_t dqn_ring_pending(void* ring) {
  auto* h = static_cast<RingHeader*>(ring);
  return h->head - h->tail;  // bytes outstanding (racy read; diagnostics)
}

void* dqn_box_create(const char* path, uint64_t max_size) {
  uint64_t total = sizeof(BoxHeader) + max_size;
  auto* h = static_cast<BoxHeader*>(map_file(path, total, true));
  if (h == nullptr) return nullptr;
  h->magic = 0;
  h->max_size = max_size;
  h->seq.store(0);
  h->len = 0;
  h->version = 0;
  std::atomic_thread_fence(std::memory_order_seq_cst);
  h->magic = kMagic;
  return h;
}

void* dqn_box_attach(const char* path) {
  auto* h = static_cast<BoxHeader*>(map_file(path, 0, false));
  if (h == nullptr || h->magic != kMagic) return nullptr;
  return h;
}

// Single writer only.
int dqn_box_write(void* box, const uint8_t* data, uint64_t len,
                  uint64_t version) {
  auto* h = static_cast<BoxHeader*>(box);
  if (len > h->max_size) return -1;
  h->seq.fetch_add(1, std::memory_order_acq_rel);  // -> odd
  std::memcpy(box_data(h), data, len);
  h->len = len;
  h->version = version;
  h->seq.fetch_add(1, std::memory_order_acq_rel);  // -> even
  return 0;
}

// Returns len (0 if never written), -2 if out buffer too small; fills
// *version. Retries while a write is in flight.
long dqn_box_read(void* box, uint8_t* out, uint64_t cap, uint64_t* version) {
  auto* h = static_cast<BoxHeader*>(box);
  for (;;) {
    uint64_t s1 = h->seq.load(std::memory_order_acquire);
    if (s1 & 1) continue;
    uint64_t len = h->len;
    uint64_t ver = h->version;
    if (len > cap) return -2;
    std::memcpy(out, box_data(h), len);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = h->seq.load(std::memory_order_acquire);
    if (s1 == s2) {
      *version = ver;
      return static_cast<long>(len);
    }
  }
}

}  // extern "C"
