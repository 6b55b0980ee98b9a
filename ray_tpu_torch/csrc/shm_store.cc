// Shared-memory arena object store — the native core of ray_tpu_torch's
// per-node object plane (its copy of the JAX package's cpp/shm_store.cc,
// with the symbols named rtpt_*). One mmap'd tmpfs file holds a header
// (robust process-shared mutex + hash-indexed object table + free list + per-pid pin registry) and a data
// region; every process of a session maps the same file, so sealed objects
// are zero-copy readable everywhere.
//
// (reference capability: src/ray/object_manager/plasma/ — PlasmaStore over
// dlmalloc'd shm with LRU eviction (eviction_policy.h:159) and fd passing
// (fling.cc). Design here is arena+offsets instead of fd-per-object: tmpfs
// is the transport, offsets are the handles, a robust pthread mutex replaces
// the store-server event loop for intra-node coordination. The pin registry
// plays the role of plasma's per-client object table: a client that dies
// holding pins has them released, so eviction can't wedge.)
//
// Build: g++ -O2 -shared -fPIC -o libshmstore.so shm_store.cc -lpthread
//
// All functions return >=0 on success; negative codes:
//   -1 not found / no space (create: even after eviction)
//   -2 already exists / state error
//   -3 internal capacity (index or free-list full)
//   -4 object larger than the whole data region (create_noevict only)

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055414E4136ULL;  // "RTPUANA6"
constexpr uint32_t kOidLen = 40;
constexpr uint32_t kMaxSlots = 32768;
constexpr uint32_t kMaxHoles = 8192;
constexpr uint32_t kHashSize = 65536;  // power of two, ~2x kMaxSlots
// One record per live (pid, slot) pin edge. Sized at kMaxSlots: overflowing
// it means >32k simultaneously pinned objects on one host — a pin taken
// past the cap still counts in refcount but is unattributable, so a reaper
// can't recover it if its holder is SIGKILLed (see pin_record).
constexpr uint32_t kMaxPins = 32768;

enum State : uint32_t { kFree = 0, kCreating = 1, kSealed = 2, kDeleting = 3 };

struct Entry {
  char oid[kOidLen];
  uint64_t offset;
  uint64_t size;
  uint32_t state;
  uint32_t refcount;
  uint64_t lru_tick;
  uint32_t hnext;        // hash-chain link: next slot index + 1, 0 = end
  int32_t creator_pid;   // writer of a kCreating entry (dead-writer reclaim)
};

struct Hole {
  uint64_t offset;
  uint64_t size;
};

// One (pid, slot) pin edge. Every record in [0, n_pins) is live (the
// registry swap-compacts on free), and a live record implies `count` refs
// on that slot's entry, so the slot cannot be recycled under it — reaping
// a dead pid's records is therefore always attributable.
struct PinRec {
  int32_t pid;
  uint32_t slot;
  uint32_t count;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;      // bytes in the data region
  uint64_t data_start;    // file offset where data begins
  uint64_t bump;          // next never-used byte (relative to data_start)
  uint64_t tick;          // LRU clock
  uint64_t used;          // live bytes (creating+sealed)
  uint32_t n_slots;
  uint32_t n_holes;
  uint32_t n_pins;        // high-water mark of the pin registry
  uint32_t slot_free_head;  // freed-slot stack: slot index + 1, 0 = empty
  pthread_mutex_t mutex;
  uint32_t hash[kHashSize];  // bucket heads: slot index + 1, 0 = empty
  Entry slots[kMaxSlots];
  Hole holes[kMaxHoles];
  PinRec pins[kMaxPins];
};

struct Store {
  Header* hdr;
  uint8_t* base;          // mapping base
  uint64_t map_len;
  int fd;
};

void lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->mutex);  // holder died
}

void unlock(Header* h) { pthread_mutex_unlock(&h->mutex); }

// ------------------------------------------------------------ hash index
// FNV-1a over the fixed-width (null-padded) id, masked to a bucket. The
// linear kMaxSlots scan this replaces was the dominant per-op cost once a
// few thousand objects were resident.

uint32_t oid_bucket(const char* oid) {
  char buf[kOidLen];
  memset(buf, 0, sizeof buf);
  strncpy(buf, oid, kOidLen);
  uint32_t hsh = 2166136261u;
  for (uint32_t i = 0; i < kOidLen; i++) {
    hsh ^= (uint8_t)buf[i];
    hsh *= 16777619u;
  }
  return hsh & (kHashSize - 1);
}

void hash_insert(Header* h, uint32_t idx) {
  uint32_t b = oid_bucket(h->slots[idx].oid);
  h->slots[idx].hnext = h->hash[b];
  h->hash[b] = idx + 1;
}

void hash_remove(Header* h, uint32_t idx) {
  uint32_t b = oid_bucket(h->slots[idx].oid);
  uint32_t* link = &h->hash[b];
  while (*link) {
    uint32_t cur = *link - 1;
    if (cur == idx) {
      *link = h->slots[cur].hnext;
      h->slots[cur].hnext = 0;
      return;
    }
    link = &h->slots[cur].hnext;
  }
}

Entry* find(Header* h, const char* oid) {
  uint32_t link = h->hash[oid_bucket(oid)];
  while (link) {
    Entry& e = h->slots[link - 1];
    if (e.state != kFree && strncmp(e.oid, oid, kOidLen) == 0) return &e;
    link = e.hnext;
  }
  return nullptr;
}

// pop a recycled slot (freed slots are stacked through hnext — the linear
// any-kFree scan this replaces made every create O(live objects) once the
// table had churned), else extend the high-water region
Entry* free_slot(Header* h) {
  if (h->slot_free_head) {
    uint32_t idx = h->slot_free_head - 1;
    h->slot_free_head = h->slots[idx].hnext;
    h->slots[idx].hnext = 0;
    return &h->slots[idx];
  }
  if (h->n_slots < kMaxSlots) return &h->slots[h->n_slots++];
  return nullptr;
}

// ------------------------------------------------------------- free list

// return a hole to the free list, merging with adjacent holes
void add_hole(Header* h, uint64_t offset, uint64_t size) {
  if (size == 0) return;
  if (offset + size == h->bump) {  // tail hole: give back to the bump region
    h->bump = offset;
    // absorb any hole now adjacent to the (moved) bump pointer
    bool merged = true;
    while (merged) {
      merged = false;
      for (uint32_t i = 0; i < h->n_holes; i++) {
        if (h->holes[i].offset + h->holes[i].size == h->bump) {
          h->bump = h->holes[i].offset;
          h->holes[i] = h->holes[--h->n_holes];
          merged = true;
          break;
        }
      }
    }
    return;
  }
  for (uint32_t i = 0; i < h->n_holes; i++) {
    Hole& o = h->holes[i];
    if (o.offset + o.size == offset) {        // extend o rightward
      o.size += size;
      return;
    }
    if (offset + size == o.offset) {          // extend o leftward
      o.offset = offset;
      o.size += size;
      return;
    }
  }
  if (h->n_holes < kMaxHoles) h->holes[h->n_holes++] = {offset, size};
  // else: the space is leaked until session cleanup — counted, not fatal
}

// retire an entry: unlink from the hash index, return its run to the free
// list, drop it from the live byte count (caller owns the lock)
void free_entry(Header* h, Entry* e) {
  uint32_t idx = (uint32_t)(e - h->slots);
  hash_remove(h, idx);
  add_hole(h, e->offset, e->size);
  h->used -= e->size;
  e->state = kFree;
  e->hnext = h->slot_free_head;  // push onto the freed-slot stack
  h->slot_free_head = idx + 1;
}

// ---------------------------------------------------------- pin registry

// free record i by moving the last live record into its place (if i IS the
// last, this self-assigns then shrinks) — scans stay O(live pin edges)
void pin_drop_at(Header* h, uint32_t i) {
  h->pins[i] = h->pins[h->n_pins - 1];
  h->n_pins--;
}

void pin_record(Header* h, uint32_t slot) {
  int32_t pid = (int32_t)getpid();
  for (uint32_t i = 0; i < h->n_pins; i++) {
    PinRec& r = h->pins[i];
    if (r.pid == pid && r.slot == slot) {
      r.count++;
      return;
    }
  }
  if (h->n_pins < kMaxPins) h->pins[h->n_pins++] = {pid, slot, 1};
  // registry full (>32k live pin edges): the pin still counts in refcount
  // but is unattributable — if its holder dies without releasing, that ref
  // leaks until session teardown. Reads/writes keep working; puts degrade
  // to the spill tier once unevictable bytes fill the arena.
}

void pin_unrecord(Header* h, uint32_t slot) {
  int32_t pid = (int32_t)getpid();
  for (uint32_t i = 0; i < h->n_pins; i++) {
    PinRec& r = h->pins[i];
    if (r.pid == pid && r.slot == slot) {
      if (--r.count == 0) pin_drop_at(h, i);
      return;
    }
  }
}

// drop `count` refs a (dead or exiting) pid held on a slot; reclaims a
// deferred delete whose last reader this was
void drop_refs(Header* h, uint32_t slot, uint32_t count) {
  Entry& e = h->slots[slot];
  if (e.state == kFree) return;  // invariant says never, but stay safe
  e.refcount = count >= e.refcount ? 0 : e.refcount - count;
  if (e.refcount == 0 && e.state == kDeleting) free_entry(h, &e);
}

// release every pin held by `pid`; with pid<0, every pin whose holder no
// longer exists. Returns the number of pin edges released.
// Known limitation: pid reuse between a holder's death and the reap makes
// kill(pid,0) succeed for the recycled pid, so that edge is skipped and its
// bytes stay unevictable until session teardown (puts degrade to the spill
// tier, no corruption). A (pid, start-time) identity — as the autoscaler's
// pid registry uses — would close this.
int release_pins_of(Header* h, int32_t pid) {
  int released = 0;
  uint32_t i = 0;
  while (i < h->n_pins) {
    PinRec& r = h->pins[i];
    bool match = pid >= 0 ? r.pid == pid
                          : (kill(r.pid, 0) != 0 && errno == ESRCH);
    if (!match) {
      i++;
      continue;
    }
    drop_refs(h, r.slot, r.count);
    released += (int)r.count;
    pin_drop_at(h, i);  // re-examine the record swapped into slot i
  }
  return released;
}

// ------------------------------------------------------------- allocator

// best-fit from the free list, else bump; -1 if no contiguous run fits
int64_t carve(Header* h, uint64_t size) {
  uint32_t best = kMaxHoles;
  uint64_t best_sz = UINT64_MAX;
  for (uint32_t i = 0; i < h->n_holes; i++) {
    if (h->holes[i].size >= size && h->holes[i].size < best_sz) {
      best = i;
      best_sz = h->holes[i].size;
    }
  }
  if (best != kMaxHoles) {
    Hole& o = h->holes[best];
    uint64_t off = o.offset;
    o.offset += size;
    o.size -= size;
    if (o.size == 0) h->holes[best] = h->holes[--h->n_holes];
    return (int64_t)off;
  }
  if (h->bump + size <= h->capacity) {
    uint64_t off = h->bump;
    h->bump += size;
    return (int64_t)off;
  }
  return -1;
}

// evict ONE least-recently-used sealed+unpinned object; false if none
bool evict_lru(Header* h) {
  Entry* victim = nullptr;
  for (uint32_t i = 0; i < h->n_slots; i++) {
    Entry& e = h->slots[i];
    if (e.state == kSealed && e.refcount == 0 &&
        (!victim || e.lru_tick < victim->lru_tick))
      victim = &e;
  }
  if (!victim) return false;
  free_entry(h, victim);
  return true;
}

// shared create body; `evict` selects plasma-style LRU eviction vs the
// caller-orchestrated path (Python spills the victim first, then retries)
int64_t create_impl(Store* s, const char* oid, uint64_t size, bool evict) {
  Header* h = s->hdr;
  lock(h);
  Entry* prev = find(h, oid);
  if (prev) {
    bool creator_dead =
        prev->creator_pid > 0 &&
        kill(prev->creator_pid, 0) != 0 && errno == ESRCH;
    if (prev->state == kCreating && creator_dead) {
      // orphaned create: the writer died mid-put (the robust mutex already
      // recovered the lock). Reclaim and start over.
      free_entry(h, prev);
    } else {
      // sealed/deleting — or a kCreating entry whose writer is STILL ALIVE
      // (two processes re-putting the same fetched object): freeing a live
      // writer's run out from under its pwrite would publish torn bytes.
      // -2 lets the caller treat it as already-present (the Python side
      // preserves its copy in the spill tier if the id isn't readable yet).
      unlock(h);
      return -2;
    }
  }
  if (size > h->capacity) {
    unlock(h);
    return evict ? -1 : -4;
  }
  int64_t off;
  bool tried_reap = false;
  while ((off = carve(h, size)) < 0) {
    if (!evict) {
      unlock(h);
      return -1;
    }
    if (evict_lru(h)) continue;
    // nothing evictable: pins held by dead processes may be the blocker
    if (!tried_reap) {
      tried_reap = true;
      if (release_pins_of(h, -1) > 0) continue;
    }
    unlock(h);
    return -1;
  }
  Entry* e = free_slot(h);
  if (!e) {
    add_hole(h, (uint64_t)off, size);
    unlock(h);
    return -3;
  }
  memset(e->oid, 0, kOidLen);
  strncpy(e->oid, oid, kOidLen);
  e->offset = (uint64_t)off;
  e->size = size;
  e->state = kCreating;
  e->refcount = 0;
  e->creator_pid = (int32_t)getpid();
  e->lru_tick = ++h->tick;
  hash_insert(h, (uint32_t)(e - h->slots));
  h->used += size;
  int64_t abs_off = (int64_t)(h->data_start + (uint64_t)off);
  unlock(h);
  return abs_off;
}

}  // namespace

extern "C" {

// Open (create=1: initialize if new) the arena at `path` with `capacity`
// data bytes. Returns an opaque handle or null.
void* rtpt_store_open(const char* path, uint64_t capacity, int create) {
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(Header) + capacity;
  flock(fd, LOCK_EX);  // serialize first-time initialization
  struct stat st;
  fstat(fd, &st);
  bool fresh = st.st_size == 0;
  if (fresh) {
    if (!create || ftruncate(fd, (off_t)total) != 0) {
      flock(fd, LOCK_UN);
      close(fd);
      return nullptr;
    }
  } else {
    total = (uint64_t)st.st_size;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    flock(fd, LOCK_UN);
    close(fd);
    return nullptr;
  }
  Header* hdr = (Header*)mem;
  if (fresh) {
    // no memset: the ftruncate'd tmpfs pages already read back zero, and
    // zeroing ~3 MB of header would fault every page at session start
    hdr->magic = kMagic;
    hdr->capacity = total - sizeof(Header);
    hdr->data_start = sizeof(Header);
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
  } else if (hdr->magic != kMagic) {
    munmap(mem, total);
    flock(fd, LOCK_UN);
    close(fd);
    return nullptr;
  }
  flock(fd, LOCK_UN);
  Store* s = new Store{hdr, (uint8_t*)mem, total, fd};
  return s;
}

void rtpt_store_close(void* handle) {
  Store* s = (Store*)handle;
  munmap(s->base, s->map_len);
  close(s->fd);
  delete s;
}

// Allocate `size` bytes for `oid`. Evicts LRU sealed objects as needed.
// Returns file offset of the data, or a negative code.
int64_t rtpt_store_create(void* handle, const char* oid, uint64_t size) {
  return create_impl((Store*)handle, oid, size, true);
}

// Allocate without evicting: -1 means "no contiguous run; spill/evict
// something and retry", -4 means "larger than the whole data region". The
// Python store drives this variant so eviction can SPILL victims to the
// disk tier instead of dropping the only copy.
int64_t rtpt_store_create_noevict(void* handle, const char* oid,
                                  uint64_t size) {
  return create_impl((Store*)handle, oid, size, false);
}

int rtpt_store_seal(void* handle, const char* oid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  if (!e || e->state != kCreating) {
    unlock(h);
    return e ? -2 : -1;
  }
  e->state = kSealed;
  e->lru_tick = ++h->tick;
  unlock(h);
  return 0;
}

// Pin + locate a sealed object. Returns absolute offset, fills *size_out.
int64_t rtpt_store_get(void* handle, const char* oid, uint64_t* size_out) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  if (!e || e->state != kSealed) {
    unlock(h);
    return -1;
  }
  e->refcount++;
  pin_record(h, (uint32_t)(e - h->slots));
  e->lru_tick = ++h->tick;
  *size_out = e->size;
  int64_t off = (int64_t)(h->data_start + e->offset);
  unlock(h);
  return off;
}

int rtpt_store_release(void* handle, const char* oid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  if (e && e->refcount > 0) {
    pin_unrecord(h, (uint32_t)(e - h->slots));
    e->refcount--;
    if (e->refcount == 0 && e->state == kDeleting) {
      // deferred delete: last reader unpinned
      free_entry(h, e);
    }
  }
  unlock(h);
  return e ? 0 : -1;
}

int rtpt_store_contains(void* handle, const char* oid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  int ok = (e && e->state == kSealed) ? 1 : 0;
  unlock(h);
  return ok;
}

int64_t rtpt_store_size(void* handle, const char* oid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  int64_t out = (e && e->state == kSealed) ? (int64_t)e->size : -1;
  unlock(h);
  return out;
}

int rtpt_store_delete(void* handle, const char* oid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* e = find(h, oid);
  if (!e || e->state == kDeleting) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0) {
    e->state = kDeleting;  // space reclaimed when the last reader releases
  } else {
    free_entry(h, e);
  }
  unlock(h);
  return 0;
}

// Copy the id of the current LRU sealed+unpinned object into `oid_out`
// (caller buffer >= 41 bytes; null-terminated here). Returns 0, or -1 when
// nothing is evictable.
int rtpt_store_lru_victim(void* handle, char* oid_out) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  Entry* victim = nullptr;
  for (uint32_t i = 0; i < h->n_slots; i++) {
    Entry& e = h->slots[i];
    if (e.state == kSealed && e.refcount == 0 &&
        (!victim || e.lru_tick < victim->lru_tick))
      victim = &e;
  }
  if (!victim) {
    unlock(h);
    return -1;
  }
  memcpy(oid_out, victim->oid, kOidLen);
  oid_out[kOidLen] = '\0';
  unlock(h);
  return 0;
}

// Release every pin held by processes that no longer exist (worker SIGKILL
// with mapped views). Returns the number of pin edges released.
int rtpt_store_reap_dead(void* handle) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  int n = release_pins_of(h, -1);
  unlock(h);
  return n;
}

// Release every pin held by `pid` (clean-exit path: a worker drops all its
// outstanding views in one call before disconnecting).
int rtpt_store_release_pid(void* handle, int32_t pid) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  int n = release_pins_of(h, pid);
  unlock(h);
  return n;
}

uint64_t rtpt_store_used(void* handle) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  uint64_t u = h->used;
  unlock(h);
  return u;
}

uint64_t rtpt_store_capacity(void* handle) {
  return ((Store*)handle)->hdr->capacity;
}

uint32_t rtpt_store_num_objects(void* handle) {
  Header* h = ((Store*)handle)->hdr;
  lock(h);
  uint32_t n = 0;
  for (uint32_t i = 0; i < h->n_slots; i++)
    if (h->slots[i].state == kSealed) n++;
  unlock(h);
  return n;
}

}  // extern "C"
