// Shared-memory ring buffer of variable-size blocks (host-side runtime).
//
// The JAX package's csrc/shm_queue.cc below its header comment, byte for
// byte (tests/test_torch_channel.py holds the two equal): a cross-process
// queue feeding sampled batches from sampling worker processes to the
// process that trains or serves them. A SysV-shm byte ring with
// process-shared mutex/condvars: blocking enqueue on full, timeout
// dequeue, attach by shmid from another process; the segment is marked
// for removal when made, so it dies with the last process attached.
//
// C ABI so Python binds via ctypes (utils/build.py compiles it with g++).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <pthread.h>
#include <sys/ipc.h>
#include <sys/shm.h>

namespace {

struct QueueMeta {
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t capacity;     // ring payload bytes
  uint64_t head;         // read offset (monotonic)
  uint64_t tail;         // write offset (monotonic)
  uint64_t count;        // blocks currently queued
  uint32_t finished;     // producer-done flag (end-of-epoch protocol)
  uint32_t _pad;
};

// Each block: 8-byte little-endian size header, then payload, 8-byte aligned.
constexpr uint64_t kAlign = 8;

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

struct Queue {
  QueueMeta* meta;
  uint8_t* data;
  int shmid;
};

uint64_t used(const QueueMeta* m) { return m->tail - m->head; }

void write_ring(Queue* q, uint64_t pos, const void* src, uint64_t n) {
  uint64_t off = pos % q->meta->capacity;
  uint64_t first = q->meta->capacity - off;
  if (n <= first) {
    memcpy(q->data + off, src, n);
  } else {
    memcpy(q->data + off, src, first);
    memcpy(q->data, static_cast<const uint8_t*>(src) + first, n - first);
  }
}

void read_ring(Queue* q, uint64_t pos, void* dst, uint64_t n) {
  uint64_t off = pos % q->meta->capacity;
  uint64_t first = q->meta->capacity - off;
  if (n <= first) {
    memcpy(dst, q->data + off, n);
  } else {
    memcpy(dst, q->data + off, first);
    memcpy(static_cast<uint8_t*>(dst) + first, q->data, n - first);
  }
}

timespec deadline_ms(long ms) {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += ms / 1000;
  ts.tv_nsec += (ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return ts;
}

}  // namespace

extern "C" {

// Create a queue with `capacity` payload bytes. Returns an opaque handle
// (0 on failure).
void* shmq_create(uint64_t capacity) {
  uint64_t total = sizeof(QueueMeta) + capacity;
  int shmid = shmget(IPC_PRIVATE, total, IPC_CREAT | 0600);
  if (shmid < 0) return nullptr;
  void* addr = shmat(shmid, nullptr, 0);
  if (addr == reinterpret_cast<void*>(-1)) return nullptr;
  // destroy-on-last-detach (reference ShmQueue marks IPC_RMID the same way)
  shmctl(shmid, IPC_RMID, nullptr);
  auto* meta = static_cast<QueueMeta*>(addr);
  memset(meta, 0, sizeof(QueueMeta));
  meta->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutex_init(&meta->mutex, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&meta->not_full, &ca);
  pthread_cond_init(&meta->not_empty, &ca);

  auto* q = new Queue;
  q->meta = meta;
  q->data = static_cast<uint8_t*>(addr) + sizeof(QueueMeta);
  q->shmid = shmid;
  return q;
}

// Attach to an existing queue by shmid (consumer side after fork/spawn).
void* shmq_attach(int shmid) {
  void* addr = shmat(shmid, nullptr, 0);
  if (addr == reinterpret_cast<void*>(-1)) return nullptr;
  auto* q = new Queue;
  q->meta = static_cast<QueueMeta*>(addr);
  q->data = static_cast<uint8_t*>(addr) + sizeof(QueueMeta);
  q->shmid = shmid;
  return q;
}

int shmq_id(void* handle) { return static_cast<Queue*>(handle)->shmid; }

// Blocking enqueue of one block. Returns 0 ok, -1 if block can never fit.
int shmq_enqueue(void* handle, const void* buf, uint64_t size) {
  auto* q = static_cast<Queue*>(handle);
  QueueMeta* m = q->meta;
  uint64_t need = align_up(size + 8);
  if (need > m->capacity) return -1;
  pthread_mutex_lock(&m->mutex);
  while (m->capacity - used(m) < need) {
    pthread_cond_wait(&m->not_full, &m->mutex);
  }
  uint64_t hdr = size;
  write_ring(q, m->tail, &hdr, 8);
  write_ring(q, m->tail + 8, buf, size);
  m->tail += need;
  m->count += 1;
  pthread_cond_signal(&m->not_empty);
  pthread_mutex_unlock(&m->mutex);
  return 0;
}

// Peek next block's size, waiting up to timeout_ms. Returns size, or
// -1 on timeout (reference QueueTimeoutError), or -2 if finished+empty.
int64_t shmq_next_size(void* handle, long timeout_ms) {
  auto* q = static_cast<Queue*>(handle);
  QueueMeta* m = q->meta;
  timespec ts = deadline_ms(timeout_ms);
  pthread_mutex_lock(&m->mutex);
  while (m->count == 0) {
    if (m->finished) {
      pthread_mutex_unlock(&m->mutex);
      return -2;
    }
    if (timeout_ms < 0) {
      pthread_cond_wait(&m->not_empty, &m->mutex);
    } else if (pthread_cond_timedwait(&m->not_empty, &m->mutex, &ts) ==
               ETIMEDOUT) {
      pthread_mutex_unlock(&m->mutex);
      return -1;
    }
  }
  uint64_t hdr;
  read_ring(q, m->head, &hdr, 8);
  pthread_mutex_unlock(&m->mutex);
  return static_cast<int64_t>(hdr);
}

// Dequeue one block into buf (must be >= its size; call shmq_next_size
// first). Returns block size, -1 on timeout, -2 finished, -3 buf too small.
int64_t shmq_dequeue(void* handle, void* buf, uint64_t bufsize,
                     long timeout_ms) {
  auto* q = static_cast<Queue*>(handle);
  QueueMeta* m = q->meta;
  timespec ts = deadline_ms(timeout_ms);
  pthread_mutex_lock(&m->mutex);
  while (m->count == 0) {
    if (m->finished) {
      pthread_mutex_unlock(&m->mutex);
      return -2;
    }
    if (timeout_ms < 0) {
      pthread_cond_wait(&m->not_empty, &m->mutex);
    } else if (pthread_cond_timedwait(&m->not_empty, &m->mutex, &ts) ==
               ETIMEDOUT) {
      pthread_mutex_unlock(&m->mutex);
      return -1;
    }
  }
  uint64_t hdr;
  read_ring(q, m->head, &hdr, 8);
  if (hdr > bufsize) {
    pthread_mutex_unlock(&m->mutex);
    return -3;
  }
  read_ring(q, m->head + 8, buf, hdr);
  m->head += align_up(hdr + 8);
  m->count -= 1;
  pthread_cond_signal(&m->not_full);
  pthread_mutex_unlock(&m->mutex);
  return static_cast<int64_t>(hdr);
}

uint64_t shmq_count(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  pthread_mutex_lock(&q->meta->mutex);
  uint64_t c = q->meta->count;
  pthread_mutex_unlock(&q->meta->mutex);
  return c;
}

// Producer-side end-of-stream mark; wakes all waiting consumers.
void shmq_finish(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  pthread_mutex_lock(&q->meta->mutex);
  q->meta->finished = 1;
  pthread_cond_broadcast(&q->meta->not_empty);
  pthread_mutex_unlock(&q->meta->mutex);
}

void shmq_reset_finished(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  pthread_mutex_lock(&q->meta->mutex);
  q->meta->finished = 0;
  pthread_mutex_unlock(&q->meta->mutex);
}

// Detach this process's mapping (shm segment dies on last detach).
void shmq_close(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  shmdt(q->meta);
  delete q;
}

}  // extern "C"
