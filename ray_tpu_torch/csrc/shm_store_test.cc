// C-level test for the shm arena store: create/seal/get/release/delete,
// eviction under pressure, pin semantics, hole coalescing, multi-process
// sharing through fork, no-evict create + LRU victim query, and dead-pid
// pin reaping. Exits 0 on success; any failed check aborts.
//
// The port's copy of cpp/shm_store_test.cc, against ray_tpu_torch's library
// (symbols rtpt_*). Build+run (also driven by tests/test_torch_object_store.py):
//   g++ -O2 -o shm_store_test shm_store_test.cc -ldl -lpthread && ./shm_store_test

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <sys/wait.h>
#include <unistd.h>

typedef void* (*open_fn)(const char*, uint64_t, int);
typedef void (*close_fn)(void*);
typedef int64_t (*create_fn)(void*, const char*, uint64_t);
typedef int (*seal_fn)(void*, const char*);
typedef int64_t (*get_fn)(void*, const char*, uint64_t*);
typedef int (*rel_fn)(void*, const char*);
typedef int (*contains_fn)(void*, const char*);
typedef int (*del_fn)(void*, const char*);
typedef uint64_t (*used_fn)(void*);
typedef int64_t (*create2_fn)(void*, const char*, uint64_t);
typedef int (*victim_fn)(void*, char*);
typedef int (*reap_fn)(void*);
typedef int (*relpid_fn)(void*, int32_t);

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      fprintf(stderr, "FAILED %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      return 1;                                                         \
    }                                                                   \
  } while (0)

int main(int argc, char** argv) {
  const char* libpath = argc > 1 ? argv[1] : "./libshmstore.so";
  const char* arena = argc > 2 ? argv[2] : "/dev/shm/rtpt_test_arena";
  unlink(arena);

  void* dl = dlopen(libpath, RTLD_NOW);
  CHECK(dl != nullptr);
  auto store_open = (open_fn)dlsym(dl, "rtpt_store_open");
  auto store_close = (close_fn)dlsym(dl, "rtpt_store_close");
  auto store_create = (create_fn)dlsym(dl, "rtpt_store_create");
  auto store_seal = (seal_fn)dlsym(dl, "rtpt_store_seal");
  auto store_get = (get_fn)dlsym(dl, "rtpt_store_get");
  auto store_release = (rel_fn)dlsym(dl, "rtpt_store_release");
  auto store_contains = (contains_fn)dlsym(dl, "rtpt_store_contains");
  auto store_delete = (del_fn)dlsym(dl, "rtpt_store_delete");
  auto store_used = (used_fn)dlsym(dl, "rtpt_store_used");
  auto store_create_noevict =
      (create2_fn)dlsym(dl, "rtpt_store_create_noevict");
  auto store_lru_victim = (victim_fn)dlsym(dl, "rtpt_store_lru_victim");
  auto store_reap_dead = (reap_fn)dlsym(dl, "rtpt_store_reap_dead");
  auto store_release_pid = (relpid_fn)dlsym(dl, "rtpt_store_release_pid");
  CHECK(store_open && store_create && store_seal && store_get);
  CHECK(store_create_noevict && store_lru_victim && store_reap_dead &&
        store_release_pid);

  // 1 MiB arena
  void* s = store_open(arena, 1 << 20, 1);
  CHECK(s != nullptr);

  // basic create/seal/get roundtrip
  int64_t off = store_create(s, "obj_a", 1000);
  CHECK(off > 0);
  CHECK(store_contains(s, "obj_a") == 0);  // not sealed yet
  CHECK(store_seal(s, "obj_a") == 0);
  CHECK(store_contains(s, "obj_a") == 1);
  uint64_t sz = 0;
  int64_t goff = store_get(s, "obj_a", &sz);
  CHECK(goff == off && sz == 1000);
  CHECK(store_create(s, "obj_a", 10) == -2);  // duplicate
  CHECK(store_release(s, "obj_a") == 0);

  // delete frees space
  uint64_t used0 = store_used(s);
  CHECK(store_delete(s, "obj_a") == 0);
  CHECK(store_used(s) == used0 - 1000);
  CHECK(store_contains(s, "obj_a") == 0);

  // eviction: fill the arena with unpinned objects, then demand more
  for (int i = 0; i < 7; i++) {
    char oid[32];
    snprintf(oid, sizeof oid, "fill_%d", i);
    CHECK(store_create(s, oid, 128 * 1024) > 0);
    CHECK(store_seal(s, oid) == 0);
  }
  // 7*128K = 896K used; another 256K must evict the two oldest
  CHECK(store_create(s, "big", 256 * 1024) > 0);
  CHECK(store_seal(s, "big") == 0);
  CHECK(store_contains(s, "fill_0") == 0);  // LRU-evicted
  CHECK(store_contains(s, "big") == 1);

  // pinned objects survive eviction pressure
  uint64_t bsz;
  CHECK(store_get(s, "big", &bsz) > 0);  // pin
  for (int i = 0; i < 10; i++) {
    char oid[32];
    snprintf(oid, sizeof oid, "press_%d", i);
    int64_t r = store_create(s, oid, 128 * 1024);
    if (r > 0) store_seal(s, oid);
  }
  CHECK(store_contains(s, "big") == 1);  // still pinned, never evicted
  CHECK(store_release(s, "big") == 0);

  // deferred delete: delete-while-pinned reclaims at release
  CHECK(store_create(s, "pinned", 1024) > 0);
  CHECK(store_seal(s, "pinned") == 0);
  CHECK(store_get(s, "pinned", &sz) > 0);
  CHECK(store_delete(s, "pinned") == 0);
  CHECK(store_contains(s, "pinned") == 0);      // gone from the index
  uint64_t used1 = store_used(s);
  CHECK(store_release(s, "pinned") == 0);       // space returns now
  CHECK(store_used(s) == used1 - 1024);

  // cross-process: child writes, parent reads the same arena
  pid_t pid = fork();
  if (pid == 0) {
    void* cs = store_open(arena, 1 << 20, 0);
    if (!cs) _exit(2);
    int64_t o = store_create(cs, "from_child", 64);
    if (o <= 0) _exit(3);
    if (store_seal(cs, "from_child") != 0) _exit(4);
    store_close(cs);
    _exit(0);
  }
  int status = 0;
  waitpid(pid, &status, 0);
  CHECK(WIFEXITED(status) && WEXITSTATUS(status) == 0);
  CHECK(store_contains(s, "from_child") == 1);

  // no-evict create: a full arena reports -1 instead of evicting; the LRU
  // victim query names the object an orchestrated spill would take
  for (int i = 0; i < 10; i++) {
    char oid[32];
    snprintf(oid, sizeof oid, "ne_fill_%d", i);
    int64_t r = store_create(s, oid, 128 * 1024);
    if (r > 0) store_seal(s, oid);
  }
  uint64_t used_before = store_used(s);
  CHECK(store_create_noevict(s, "ne_big", 256 * 1024) == -1);
  CHECK(store_used(s) == used_before);                        // nothing evicted
  CHECK(store_create_noevict(s, "ne_huge", 4ull << 20) == -4);  // > capacity
  char victim[48];
  int64_t off2;
  while ((off2 = store_create_noevict(s, "ne_big", 256 * 1024)) == -1) {
    CHECK(store_lru_victim(s, victim) == 0);
    CHECK(store_contains(s, victim) == 1);
    CHECK(store_delete(s, victim) == 0);  // what an orchestrated spill does
  }
  CHECK(off2 > 0);
  CHECK(store_seal(s, "ne_big") == 0);

  // dead-pid pin reaping: a child pins an object and exits WITHOUT
  // releasing; the parent reaps the orphaned pin so eviction can't wedge
  pid_t pinner = fork();
  if (pinner == 0) {
    void* cs = store_open(arena, 1 << 20, 0);
    if (!cs) _exit(2);
    uint64_t psz;
    if (store_get(cs, "ne_big", &psz) <= 0) _exit(3);
    _exit(0);  // dies holding the pin (no release, no close)
  }
  waitpid(pinner, &status, 0);
  CHECK(WIFEXITED(status) && WEXITSTATUS(status) == 0);
  CHECK(store_reap_dead(s) == 1);  // exactly the orphaned pin
  CHECK(store_reap_dead(s) == 0);  // idempotent

  // kCreating protection: a live writer's in-progress entry must not be
  // reclaimed by a concurrent create of the same id…
  CHECK(store_create(s, "inflight", 1024) > 0);
  CHECK(store_create(s, "inflight", 1024) == -2);
  CHECK(store_create_noevict(s, "inflight", 1024) == -2);
  CHECK(store_seal(s, "inflight") == 0);
  // …but a DEAD writer's unsealed entry is reclaimed and re-creatable
  pid_t creator = fork();
  if (creator == 0) {
    void* cs = store_open(arena, 1 << 20, 0);
    if (!cs) _exit(2);
    if (store_create(cs, "orphaned", 2048) <= 0) _exit(3);
    _exit(0);  // dies mid-put, entry left kCreating
  }
  waitpid(creator, &status, 0);
  CHECK(WIFEXITED(status) && WEXITSTATUS(status) == 0);
  CHECK(store_create(s, "orphaned", 2048) > 0);
  CHECK(store_seal(s, "orphaned") == 0);

  // release_pid: clean-exit bulk release of this process's pins
  uint64_t s1, s2;
  CHECK(store_get(s, "ne_big", &s1) > 0);
  CHECK(store_get(s, "ne_big", &s2) > 0);
  CHECK(store_release_pid(s, (int32_t)getpid()) == 2);
  uint64_t used2 = store_used(s);
  CHECK(store_delete(s, "ne_big") == 0);
  CHECK(store_used(s) == used2 - 256 * 1024);  // freed NOW → refs were 0

  store_close(s);
  unlink(arena);
  printf("shm_store_test: all checks passed\n");
  return 0;
}
