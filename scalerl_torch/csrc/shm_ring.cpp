// Lock-free shared-memory rollout ring for the actor->learner hot path.
//
// The runtime counterpart of the reference's free_queue/full_queue slot
// cycle (scalerl/impala/impala_atari.py:416-437), which paid a Python
// SimpleQueue + pickle round trip per slot handoff.  Here the two queues are
// Vyukov bounded MPMC rings of slot indices living in *caller-provided*
// shared memory (e.g. Python multiprocessing.shared_memory), so any number
// of actor processes and learner threads exchange trajectory slots with one
// atomic CAS each and zero serialization; slot payloads are written in
// place by numpy views over the same segment.
//
// Memory layout (64-byte aligned sections):
//   [RingHeader][free cells: num_slots_pow2][full cells: num_slots_pow2]
// Slot data lives wherever the caller wants (usually right after) — this
// module only manages indices.
//
// Build: scalerl_torch/native/build.py (g++ -O3 -shared -fPIC -std=c++17 ... -lpthread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

namespace {

constexpr uint32_t kMagic = 0x53524C52;  // "SRLR"

struct Cell {
  std::atomic<uint32_t> seq;
  uint32_t value;
};

struct Queue {
  alignas(64) std::atomic<uint32_t> head;  // enqueue ticket
  alignas(64) std::atomic<uint32_t> tail;  // dequeue ticket
};

struct RingHeader {
  uint32_t magic;
  uint32_t num_slots;
  uint32_t capacity;  // pow2 >= num_slots
  uint32_t mask;
  alignas(64) Queue free_q;
  alignas(64) Queue full_q;
  alignas(64) std::atomic<uint32_t> closed;
};

inline Cell* free_cells(RingHeader* h) {
  return reinterpret_cast<Cell*>(reinterpret_cast<char*>(h) + sizeof(RingHeader));
}

inline Cell* full_cells(RingHeader* h) {
  return free_cells(h) + h->capacity;
}

inline uint32_t pow2_at_least(uint32_t n) {
  uint32_t c = 1;
  while (c < n) c <<= 1;
  return c;
}

// Vyukov bounded MPMC enqueue; returns false when full.
bool q_push(Queue* q, Cell* cells, uint32_t mask, uint32_t value) {
  uint32_t pos = q->head.load(std::memory_order_relaxed);
  for (;;) {
    Cell* cell = &cells[pos & mask];
    uint32_t seq = cell->seq.load(std::memory_order_acquire);
    int32_t dif = static_cast<int32_t>(seq) - static_cast<int32_t>(pos);
    if (dif == 0) {
      if (q->head.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
        cell->value = value;
        cell->seq.store(pos + 1, std::memory_order_release);
        return true;
      }
    } else if (dif < 0) {
      return false;  // full
    } else {
      pos = q->head.load(std::memory_order_relaxed);
    }
  }
}

// Vyukov bounded MPMC dequeue; returns false when empty.
bool q_pop(Queue* q, Cell* cells, uint32_t mask, uint32_t* out) {
  uint32_t pos = q->tail.load(std::memory_order_relaxed);
  for (;;) {
    Cell* cell = &cells[pos & mask];
    uint32_t seq = cell->seq.load(std::memory_order_acquire);
    int32_t dif =
        static_cast<int32_t>(seq) - static_cast<int32_t>(pos + 1);
    if (dif == 0) {
      if (q->tail.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
        *out = cell->value;
        cell->seq.store(pos + mask + 1, std::memory_order_release);
        return true;
      }
    } else if (dif < 0) {
      return false;  // empty
    } else {
      pos = q->tail.load(std::memory_order_relaxed);
    }
  }
}

void sleep_us(long us) {
  timespec ts{0, us * 1000L};
  nanosleep(&ts, nullptr);
}

// Spin-then-sleep pop with deadline; timeout_us < 0 means block forever.
int timed_pop(RingHeader* h, Queue* q, Cell* cells, int64_t timeout_us,
              uint32_t* out) {
  int64_t waited = 0;
  int spins = 0;
  for (;;) {
    if (q_pop(q, cells, h->mask, out)) return 0;
    if (h->closed.load(std::memory_order_acquire)) return -2;
    if (timeout_us >= 0 && waited >= timeout_us) return -1;
    if (++spins < 64) continue;  // brief busy spin for low latency
    sleep_us(50);
    waited += 50;
  }
}

}  // namespace

extern "C" {

// Bytes needed for a ring managing num_slots indices.
uint64_t srl_ring_bytes(uint32_t num_slots) {
  uint32_t cap = pow2_at_least(num_slots);
  return sizeof(RingHeader) + 2ull * cap * sizeof(Cell);
}

// Initialize a ring in caller-provided zeroed memory; all slot indices
// start on the free queue.  Returns 0 on success.
int srl_ring_init(void* base, uint32_t num_slots) {
  auto* h = static_cast<RingHeader*>(base);
  h->num_slots = num_slots;
  h->capacity = pow2_at_least(num_slots);
  h->mask = h->capacity - 1;
  h->free_q.head.store(0);
  h->free_q.tail.store(0);
  h->full_q.head.store(0);
  h->full_q.tail.store(0);
  h->closed.store(0);
  Cell* fc = free_cells(h);
  Cell* uc = full_cells(h);
  for (uint32_t i = 0; i < h->capacity; ++i) {
    fc[i].seq.store(i, std::memory_order_relaxed);
    uc[i].seq.store(i, std::memory_order_relaxed);
  }
  for (uint32_t i = 0; i < num_slots; ++i) {
    q_push(&h->free_q, fc, h->mask, i);
  }
  h->magic = kMagic;
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return 0;
}

int srl_ring_check(void* base) {
  return static_cast<RingHeader*>(base)->magic == kMagic ? 0 : -3;
}

// Actor: take a free slot index.  Returns slot index >= 0, -1 on timeout,
// -2 if the ring is closed.
int32_t srl_ring_acquire(void* base, int64_t timeout_us) {
  auto* h = static_cast<RingHeader*>(base);
  uint32_t idx;
  int rc = timed_pop(h, &h->free_q, free_cells(h), timeout_us, &idx);
  return rc == 0 ? static_cast<int32_t>(idx) : rc;
}

// Actor: publish a filled slot.
int srl_ring_commit(void* base, uint32_t idx) {
  auto* h = static_cast<RingHeader*>(base);
  return q_push(&h->full_q, full_cells(h), h->mask, idx) ? 0 : -4;
}

// Learner: take a filled slot index.
int32_t srl_ring_pop_full(void* base, int64_t timeout_us) {
  auto* h = static_cast<RingHeader*>(base);
  uint32_t idx;
  int rc = timed_pop(h, &h->full_q, full_cells(h), timeout_us, &idx);
  return rc == 0 ? static_cast<int32_t>(idx) : rc;
}

// Learner: recycle a consumed slot.
int srl_ring_release(void* base, uint32_t idx) {
  auto* h = static_cast<RingHeader*>(base);
  return q_push(&h->free_q, free_cells(h), h->mask, idx) ? 0 : -4;
}

void srl_ring_close(void* base) {
  static_cast<RingHeader*>(base)->closed.store(1, std::memory_order_release);
}

int srl_ring_closed(void* base) {
  return static_cast<RingHeader*>(base)->closed.load(std::memory_order_acquire);
}

// Parallel batch gather: copy n src pointers into one contiguous dst
// (the learner's stack-into-batch hot path).  Single-threaded memcpy is
// memory-bandwidth-bound already; this exists so the learner host can stack
// without the Python loop + np.concatenate temporaries.
void srl_gather_batch(char* dst, const char** srcs, uint32_t n,
                      uint64_t bytes_per_src) {
  for (uint32_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * bytes_per_src, srcs[i], bytes_per_src);
  }
}

}  // extern "C"
