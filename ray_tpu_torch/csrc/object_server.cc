// Native object-plane server: serves sealed shm objects to other hosts.
//
// The port's copy of the JAX package's cpp/object_server.cc, with its C
// symbols prefixed rtpt_, so the two packages never share or race on one
// library; it streams the port's rtpt_<namespace>_* segments and spill
// directory.
//
// Reference capability: the C++ object manager's chunked push/pull plane
// (reference: src/ray/object_manager/object_manager.h:128 — node-to-node
// transfer with admission control). Objects are sealed tmpfs
// files (file-per-object store) or spill-tier files, so the server is pure
// IO — epoll-free blocking threads, zero Python on the hot path, streaming
// straight from the page cache with a trivial binary wire format:
//
//   request:  [u32 oid_len LE][oid bytes]
//   response: [u64 size LE][payload bytes]   (size = UINT64_MAX → not found)
//
// Exposed via a C API loaded with ctypes
// (ray_tpu_torch/_private/native_object_server.py):
//   rtpt_objsrv_start(prefix, spill_dir, bind_host, port) -> handle
//   rtpt_objsrv_port(handle) -> bound port
//   rtpt_objsrv_stop(handle)
//
// Build: g++ -O2 -shared -fPIC -o ../build/libobjserver.so object_server.cc -lpthread

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kNotFound = ~0ULL;
constexpr uint32_t kMaxOidLen = 4096;

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::string prefix;     // e.g. /dev/shm/rtpt_<session>_
  std::string spill_dir;  // e.g. <TMPDIR>/ray_tpu_torch/spill_<session>
  std::atomic<bool> stop{false};
  pthread_t accept_thread{};
  // live connection fds + count: stop() shuts them down and waits for the
  // detached conn threads to exit before the Server is freed (no UAF)
  std::mutex conn_mu;
  std::set<int> conn_fds;
  std::atomic<int> conn_count{0};
};

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// oid must be a plain hex-ish token: reject path traversal outright
bool oid_ok(const std::string& oid) {
  if (oid.empty() || oid.size() > kMaxOidLen) return false;
  for (char c : oid) {
    if (!(isalnum(static_cast<unsigned char>(c)) || c == '_' || c == '-')) {
      return false;
    }
  }
  return true;
}

int open_object(const Server* s, const std::string& oid, uint64_t* size) {
  for (const std::string& path :
       {s->prefix + oid, s->spill_dir + "/" + oid}) {
    int fd = open(path.c_str(), O_RDONLY);
    if (fd >= 0) {
      struct stat st;
      if (fstat(fd, &st) == 0) {
        *size = static_cast<uint64_t>(st.st_size);
        return fd;
      }
      close(fd);
    }
  }
  return -1;
}

struct ConnArg {
  Server* srv;
  int fd;
};

void* conn_main(void* argp) {
  ConnArg* arg = static_cast<ConnArg*>(argp);
  Server* s = arg->srv;
  int fd = arg->fd;
  delete arg;
  int one = 1;
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    s->conn_fds.insert(fd);
  }
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  while (!s->stop.load()) {
    uint32_t oid_len = 0;
    if (!read_exact(fd, &oid_len, sizeof(oid_len))) break;
    if (oid_len == 0 || oid_len > kMaxOidLen) break;
    std::string oid(oid_len, '\0');
    if (!read_exact(fd, &oid[0], oid_len)) break;
    uint64_t size = kNotFound;
    int obj_fd = -1;
    if (oid_ok(oid)) obj_fd = open_object(s, oid, &size);
    if (obj_fd < 0) {
      uint64_t nf = kNotFound;
      if (!write_exact(fd, &nf, sizeof(nf))) break;
      continue;
    }
    bool ok = write_exact(fd, &size, sizeof(size));
    off_t off = 0;
    while (ok && static_cast<uint64_t>(off) < size) {
      ssize_t sent = sendfile(fd, obj_fd, &off, size - off);
      if (sent <= 0) {
        // sendfile can fail across fs types; fall back to read/write
        char buf[1 << 16];
        ssize_t r = pread(obj_fd, buf, sizeof(buf), off);
        if (r <= 0 || !write_exact(fd, buf, static_cast<size_t>(r))) {
          ok = false;
          break;
        }
        off += r;
      }
    }
    close(obj_fd);
    if (!ok) break;
  }
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    s->conn_fds.erase(fd);
  }
  close(fd);
  s->conn_count.fetch_sub(1);
  return nullptr;
}

void* accept_main(void* argp) {
  Server* s = static_cast<Server*>(argp);
  while (!s->stop.load()) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stop.load()) break;
      continue;
    }
    if (s->stop.load()) {
      close(fd);
      break;
    }
    auto* arg = new ConnArg{s, fd};
    s->conn_count.fetch_add(1);
    pthread_t t;
    if (pthread_create(&t, nullptr, conn_main, arg) == 0) {
      pthread_detach(t);
    } else {
      s->conn_count.fetch_sub(1);
      close(fd);
      delete arg;
    }
  }
  close(s->listen_fd);
  return nullptr;
}

}  // namespace

extern "C" {

void* rtpt_objsrv_start(const char* prefix, const char* spill_dir,
                        const char* bind_host, int port) {
  auto* s = new Server;
  s->prefix = prefix;
  s->spill_dir = spill_dir;
  s->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(s->listen_fd, 256) != 0) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  s->port = ntohs(addr.sin_port);
  if (pthread_create(&s->accept_thread, nullptr, accept_main, s) != 0) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  return s;
}

int rtpt_objsrv_port(void* handle) {
  return handle ? static_cast<Server*>(handle)->port : -1;
}

void rtpt_objsrv_stop(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Server*>(handle);
  s->stop.store(true);
  // unblock accept(): shutdown works regardless of the bind address; the
  // loopback self-connect is belt-and-braces for platforms where shutdown
  // on a listening socket is a no-op
  shutdown(s->listen_fd, SHUT_RDWR);
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd >= 0) {
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(s->port));
    inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
    connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    close(fd);
  }
  pthread_join(s->accept_thread, nullptr);
  // kick live connections off their blocking reads/writes, then wait for
  // every conn thread to finish before freeing the Server (UAF guard)
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (int cfd : s->conn_fds) shutdown(cfd, SHUT_RDWR);
  }
  for (int spins = 0; s->conn_count.load() > 0 && spins < 2000; ++spins) {
    usleep(5000);  // up to ~10s; threads exit as soon as their IO aborts
  }
  if (s->conn_count.load() == 0) {
    delete s;
  }  // else: leak the tiny Server rather than free it under a live thread
}

}  // extern "C"
