// Native shared-memory factor store (the reference's shm-typed-array role).
//
// The reference engine shares U/V factor matrices between its master and
// worker processes through a SysV shared-memory C++ addon (SURVEY.md C6c:
// shm.create/get/detach over shmget/shmat). In the rebuild the TRAINING
// side of that role is device-array shardings; what remains genuinely cross-process
// on the host is SERVING: several serving processes reading one copy of the
// trained factors while a trainer republishes them between epochs.
//
// This library provides that as POSIX shared memory (shm_open + mmap) with a
// seqlock-versioned header, so readers never observe a torn publish:
//
//   ycnr_shm_create(name, n_users, n_items, rank) -> handle
//   ycnr_shm_attach(name)                         -> handle (or NULL)
//   ycnr_shm_publish(handle, epoch, mu, U, V, bu, bi)
//   ycnr_shm_read(handle, U, V, bu, bi, &mu, retries) -> epoch (or -1)
//   ycnr_shm_epoch(handle)                        -> staleness peek
//   ycnr_shm_dims(handle, out[3])                 -> n_users, n_items, rank
//   ycnr_shm_detach(handle), ycnr_shm_unlink(name)
//
// Array shapes use the framework's zero-row padding convention
// (models/base.py): U is [(n_users+1) * rank] f32, V [(n_items+1) * rank],
// bu [n_users+1], bi [n_items+1].
//
// Build: g++ -O3 -shared -fPIC shm_store.cc -o libycnr_shm.so

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sched.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x59434e5253484d31ull;  // "YCNRSHM1"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t dtype;  // 0 = float32 (the only on-host factor dtype)
  std::atomic<uint32_t> seq;  // seqlock: odd while a publish is in flight
  uint32_t writer_pid;  // single-writer guard (0 in pre-guard segments)
  int64_t epoch;
  int64_t n_users, n_items, rank;
  double mu;
  int64_t total_bytes;  // full segment size, for attach-side mmap/munmap
};

static_assert(sizeof(Header) % 8 == 0, "header must keep arrays aligned");
static_assert(std::atomic<uint32_t>::is_always_lock_free,
              "seqlock requires lock-free 32-bit atomics");

struct Sizes {
  size_t u, v, bu, bi, total;
};

Sizes sizes_for(int64_t n_users, int64_t n_items, int64_t rank) {
  Sizes s;
  s.u = sizeof(float) * (size_t)(n_users + 1) * (size_t)rank;
  s.v = sizeof(float) * (size_t)(n_items + 1) * (size_t)rank;
  s.bu = sizeof(float) * (size_t)(n_users + 1);
  s.bi = sizeof(float) * (size_t)(n_items + 1);
  s.total = sizeof(Header) + s.u + s.v + s.bu + s.bi;
  return s;
}

float* arrays_base(Header* h) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(h)
                                  + sizeof(Header));
}

// pid recorded by the last ycnr_shm_create that refused because another
// live writer owns the segment (0 otherwise) — lets the Python side report
// WHICH process holds the store instead of a generic open failure.
std::atomic<uint32_t> g_busy_owner{0};

}  // namespace

extern "C" {

// Create (or recreate) the named segment sized for the given dims and map
// it read-write. Returns the mapping, or NULL on failure.
void* ycnr_shm_attach(const char* name);  // forward (reuse in create)

void* ycnr_shm_create(const char* name, int64_t n_users, int64_t n_items,
                      int64_t rank) {
  g_busy_owner.store(0, std::memory_order_relaxed);
  if (n_users <= 0 || n_items <= 0 || rank <= 0) return nullptr;
  const Sizes s = sizes_for(n_users, n_items, rank);
  // If a valid segment with IDENTICAL dims already exists, adopt it (a
  // restarted trainer keeps publishing where live readers are attached).
  // Otherwise unlink first: readers of the old segment keep their (still
  // valid) old mapping rather than seeing a resized header under their
  // feet; new attachers get the fresh segment.
  void* existing = ycnr_shm_attach(name);
  if (!existing) {
    // the name may exist but be mid-creation by a racing creator (magic is
    // written last): give it a grace period before declaring it garbage
    // and unlinking it out from under that creator (split-brain otherwise)
    int fd0 = shm_open(name, O_RDWR, 0600);
    if (fd0 >= 0) {
      close(fd0);
      for (int i = 0; i < 20 && !existing; i++) {
        usleep(10 * 1000);
        existing = ycnr_shm_attach(name);
      }
    }
  }
  if (existing) {
    Header* eh = static_cast<Header*>(existing);
    // single-writer guard: refuse to adopt while the recorded writer is
    // still alive (two writers on one seqlock lets readers validate torn
    // snapshots via seq ABA). pid 0 = pre-guard segment, adoptable.
    uint32_t owner = eh->writer_pid;
    if (owner != 0 && owner != (uint32_t)getpid()
        && kill((pid_t)owner, 0) == 0) {
      // NOTE: kill(pid, 0) cannot distinguish the real writer from an
      // unrelated process that recycled its pid after a trainer crash;
      // recovery in that case is manual shm_unlink (surfaced to Python
      // via ycnr_shm_busy_owner so the error can say so).
      g_busy_owner.store(owner, std::memory_order_relaxed);
      munmap(existing, (size_t)eh->total_bytes);
      return nullptr;
    }
    if (eh->n_users == n_users && eh->n_items == n_items
        && eh->rank == rank) {
      uint32_t seq = eh->seq.load(std::memory_order_relaxed);
      if (seq & 1) {
        // the previous writer died MID-PUBLISH: the payload is torn.
        // Invalidate it (epoch -1 = "nothing published", so readers get
        // the explicit not-ready signal instead of a half-written
        // snapshot), then re-even the seqlock for our own publishes.
        eh->epoch = -1;
        std::atomic_thread_fence(std::memory_order_release);
        eh->seq.store(seq + 1, std::memory_order_release);
      }
      eh->writer_pid = (uint32_t)getpid();
      return existing;
    }
    munmap(existing, (size_t)eh->total_bytes);
  }
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)s.total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* p = mmap(nullptr, s.total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);  // the mapping keeps the segment alive
  if (p == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(p);
  h->version = kVersion;
  h->dtype = 0;
  h->seq.store(0, std::memory_order_relaxed);
  h->writer_pid = (uint32_t)getpid();
  h->epoch = -1;  // nothing published yet
  h->n_users = n_users;
  h->n_items = n_items;
  h->rank = rank;
  h->mu = 0.0;
  h->total_bytes = (int64_t)s.total;
  // magic last, released: a racing ycnr_shm_create waits on it (grace
  // loop above) before judging the segment invalid
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kMagic;
  return p;
}

// Attach to an existing segment. Returns NULL if it does not exist or is
// not a valid store (wrong magic/version/size).
void* ycnr_shm_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(p);
  if (h->magic != kMagic || h->version != kVersion
      || h->total_bytes != (int64_t)st.st_size
      || sizes_for(h->n_users, h->n_items, h->rank).total
             != (size_t)st.st_size) {
    munmap(p, (size_t)st.st_size);
    return nullptr;
  }
  return p;
}

int ycnr_shm_dims(void* handle, int64_t out[3]) {
  Header* h = static_cast<Header*>(handle);
  out[0] = h->n_users;
  out[1] = h->n_items;
  out[2] = h->rank;
  return 0;
}

int64_t ycnr_shm_epoch(void* handle) {
  Header* h = static_cast<Header*>(handle);
  // acquire pairs with the publisher's final release store
  uint32_t s = h->seq.load(std::memory_order_acquire);
  if (s & 1) return -1;          // publish in flight
  if (h->epoch < 0) return -2;   // nothing published yet
  return h->epoch;
}

// After a create refusal: the live pid that owns the segment, else 0.
uint32_t ycnr_shm_busy_owner(void) {
  return g_busy_owner.load(std::memory_order_relaxed);
}

// Seqlock write: bump to odd, copy the payload, bump to even. Readers that
// overlap the copy observe an odd/changed seq and retry.
//
// Memory-model note: ordering the odd seq store before the payload memcpy
// via atomic_thread_fence(release) relies on the practical smp_wmb-style
// behavior of the fence (as in the Linux kernel seqlock); in the strict
// C++11 model a release fence orders prior writes against LATER ATOMIC
// stores, not the later plain memcpy, so this is formally a data race.
// It compiles to the intended barriers on x86/ARM (verified by the
// cross-process stress test); a standard-clean version would need the
// payload copied through relaxed atomic words at real cost.
int ycnr_shm_publish(void* handle, int64_t epoch, double mu, const float* U,
                     const float* V, const float* bu, const float* bi) {
  Header* h = static_cast<Header*>(handle);
  const Sizes s = sizes_for(h->n_users, h->n_items, h->rank);
  uint32_t seq = h->seq.load(std::memory_order_relaxed);
  h->seq.store(seq + 1, std::memory_order_relaxed);  // odd: writer active
  std::atomic_thread_fence(std::memory_order_release);
  float* base = arrays_base(h);
  memcpy(base, U, s.u);
  memcpy(reinterpret_cast<char*>(base) + s.u, V, s.v);
  memcpy(reinterpret_cast<char*>(base) + s.u + s.v, bu, s.bu);
  memcpy(reinterpret_cast<char*>(base) + s.u + s.v + s.bu, bi, s.bi);
  h->mu = mu;
  h->epoch = epoch;
  std::atomic_thread_fence(std::memory_order_release);
  h->seq.store(seq + 2, std::memory_order_release);  // even: stable
  return 0;
}

// Seqlock read: copy out, then verify seq did not move. Returns the epoch
// of the snapshot, or -1 if max_retries consecutive publishes tore it (or
// a writer died mid-publish), or -2 if nothing has been published yet.
// Waiting out a writer-in-flight window does NOT consume retries (a large
// publish memcpy takes milliseconds; spins are nanoseconds) — it yields,
// bounded separately so a dead writer cannot hang the reader forever.
int64_t ycnr_shm_read(void* handle, float* U, float* V, float* bu, float* bi,
                      double* mu, int max_retries) {
  Header* h = static_cast<Header*>(handle);
  const Sizes s = sizes_for(h->n_users, h->n_items, h->rank);
  const float* base = arrays_base(h);
  long odd_spins = 0;
  for (int attempt = 0; attempt <= max_retries;) {
    uint32_t s1 = h->seq.load(std::memory_order_acquire);
    if (s1 & 1) {  // writer mid-publish: wait it out, don't burn retries
      if (++odd_spins > (4 << 20)) return -1;  // ~seconds: writer is dead
      sched_yield();
      continue;
    }
    attempt++;
    if (h->epoch < 0) return -2;
    memcpy(U, base, s.u);
    memcpy(V, reinterpret_cast<const char*>(base) + s.u, s.v);
    memcpy(bu, reinterpret_cast<const char*>(base) + s.u + s.v, s.bu);
    memcpy(bi, reinterpret_cast<const char*>(base) + s.u + s.v + s.bu, s.bi);
    double m = h->mu;
    int64_t e = h->epoch;
    std::atomic_thread_fence(std::memory_order_acquire);
    if (h->seq.load(std::memory_order_relaxed) == s1) {
      *mu = m;
      return e;
    }
  }
  return -1;
}

int ycnr_shm_detach(void* handle) {
  Header* h = static_cast<Header*>(handle);
  // clean writer shutdown releases the single-writer guard so a successor
  // can adopt immediately (readers never set writer_pid)
  if (h->writer_pid == (uint32_t)getpid()) h->writer_pid = 0;
  return munmap(handle, (size_t)h->total_bytes);
}

int ycnr_shm_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
