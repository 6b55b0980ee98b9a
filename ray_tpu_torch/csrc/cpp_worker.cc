// C++ worker of ray_tpu_torch: a native process that joins a session as a
// worker and executes REGISTERED C++ functions submitted from any driver.
//
// Tasks target functions by NAME (cross-language calls). The control plane
// is the port's framed protocol (ray_tpu_torch/_private/protocol.py); the
// language-neutral encoding is JSON frames: 8-byte little-endian length,
// then "\0JSN" + UTF-8 JSON. The GCS detects the codec per frame
// (_private/gcs.py, "register" with codec "json"), routes only tasks of
// lang "cpp" to a worker registered with language "cpp", and re-encodes
// its results for Python consumers (_convert_cross_lang_done).
//
// Built by ray_tpu_torch.cross_lang.ensure_cpp_worker_binary():
//   g++ -O2 -std=c++17 -o ray_tpu_torch/build/cpp_worker csrc/cpp_worker.cc
// Usage:  cpp_worker --address <host:port> [--node node-0] [--host host-0]
// Extend: add functions to install_functions() below (or link your own TU
// that calls ray_tpu_torch::register_function before
// ray_tpu_torch::worker_main).

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <random>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace ray_tpu_torch {

// ----------------------------------------------------------------- JSON
// Minimal JSON value + parser + serializer: the subset the control plane
// uses (objects, arrays, strings, doubles/ints, bools, null).

struct Json;
using JsonArr = std::vector<Json>;
using JsonObj = std::vector<std::pair<std::string, Json>>;

struct Json {
  enum Kind { NUL, BOOL, INT, DBL, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string s;
  JsonArr arr;
  JsonObj obj;

  Json() = default;
  static Json null() { return Json(); }
  static Json of(bool v) { Json j; j.kind = BOOL; j.b = v; return j; }
  static Json of(int64_t v) { Json j; j.kind = INT; j.i = v; return j; }
  static Json of(double v) { Json j; j.kind = DBL; j.d = v; return j; }
  static Json of(const std::string& v) { Json j; j.kind = STR; j.s = v; return j; }
  static Json of(const char* v) { return of(std::string(v)); }
  static Json array(JsonArr v = {}) { Json j; j.kind = ARR; j.arr = std::move(v); return j; }
  static Json object(JsonObj v = {}) { Json j; j.kind = OBJ; j.obj = std::move(v); return j; }

  double as_number() const {
    if (kind == INT) return static_cast<double>(i);
    if (kind == DBL) return d;
    throw std::runtime_error("not a number");
  }
  const Json* get(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  void set(const std::string& key, Json v) {
    obj.emplace_back(key, std::move(v));
  }
};

struct Parser {
  const char* p;
  const char* end;
  explicit Parser(const std::string& text)
      : p(text.data()), end(text.data() + text.size()) {}

  [[noreturn]] void fail(const char* why) {
    throw std::runtime_error(std::string("json parse: ") + why);
  }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  char peek() {
    skip_ws();
    if (p >= end) fail("eof");
    return *p;
  }
  void expect(char c) {
    if (peek() != c) fail("unexpected char");
    ++p;
  }
  bool consume(char c) {
    if (p < end && peek() == c) { ++p; return true; }
    return false;
  }

  Json parse_value() {
    char c = peek();
    if (c == '{') return parse_object();
    if (c == '[') return parse_array();
    if (c == '"') return Json::of(parse_string());
    if (c == 't') { literal("true"); return Json::of(true); }
    if (c == 'f') { literal("false"); return Json::of(false); }
    if (c == 'n') { literal("null"); return Json::null(); }
    return parse_number();
  }
  void literal(const char* lit) {
    size_t n = std::strlen(lit);
    if (static_cast<size_t>(end - p) < n || std::strncmp(p, lit, n) != 0)
      fail("bad literal");
    p += n;
  }
  Json parse_object() {
    expect('{');
    Json out = Json::object();
    if (consume('}')) return out;
    while (true) {
      std::string key = parse_string();
      expect(':');
      out.obj.emplace_back(std::move(key), parse_value());
      if (consume('}')) return out;
      expect(',');
    }
  }
  Json parse_array() {
    expect('[');
    Json out = Json::array();
    if (consume(']')) return out;
    while (true) {
      out.arr.push_back(parse_value());
      if (consume(']')) return out;
      expect(',');
    }
  }
  std::string parse_string() {
    expect('"');
    std::string out;
    while (p < end) {
      char c = *p++;
      if (c == '"') return out;
      if (c != '\\') { out += c; continue; }
      if (p >= end) fail("eof in escape");
      char e = *p++;
      switch (e) {
        case '"': out += '"'; break;
        case '\\': out += '\\'; break;
        case '/': out += '/'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'n': out += '\n'; break;
        case 'r': out += '\r'; break;
        case 't': out += '\t'; break;
        case 'u': {
          if (end - p < 4) fail("short \\u");
          unsigned cp = 0;
          for (int k = 0; k < 4; ++k) {
            char h = *p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else fail("bad hex");
          }
          // utf-8 encode (surrogate pairs folded to replacement — the
          // control plane never sends astral identifiers)
          if (cp < 0x80) out += static_cast<char>(cp);
          else if (cp < 0x800) {
            out += static_cast<char>(0xC0 | (cp >> 6));
            out += static_cast<char>(0x80 | (cp & 0x3F));
          } else {
            out += static_cast<char>(0xE0 | (cp >> 12));
            out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
            out += static_cast<char>(0x80 | (cp & 0x3F));
          }
          break;
        }
        default: fail("bad escape");
      }
    }
    fail("eof in string");
  }
  Json parse_number() {
    const char* start = p;
    if (p < end && *p == '-') ++p;
    bool is_int = true;
    while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' ||
                       *p == 'E' || *p == '+' || *p == '-')) {
      if (*p == '.' || *p == 'e' || *p == 'E') is_int = false;
      ++p;
    }
    std::string tok(start, p - start);
    if (tok.empty()) fail("bad number");
    if (is_int) {
      try {
        return Json::of(static_cast<int64_t>(std::stoll(tok)));
      } catch (...) { /* overflow: fall through to double */ }
    }
    return Json::of(std::stod(tok));
  }
};

inline Json parse_json(const std::string& text) {
  Parser parser(text);
  Json v = parser.parse_value();
  return v;
}

inline void dump_json(const Json& v, std::string& out) {
  switch (v.kind) {
    case Json::NUL: out += "null"; break;
    case Json::BOOL: out += v.b ? "true" : "false"; break;
    case Json::INT: out += std::to_string(v.i); break;
    case Json::DBL: {
      if (std::isfinite(v.d)) {
        char buf[32];
        std::snprintf(buf, sizeof(buf), "%.17g", v.d);
        out += buf;
      } else {
        out += "null";  // JSON has no inf/nan
      }
      break;
    }
    case Json::STR: {
      out += '"';
      for (unsigned char c : v.s) {
        switch (c) {
          case '"': out += "\\\""; break;
          case '\\': out += "\\\\"; break;
          case '\n': out += "\\n"; break;
          case '\r': out += "\\r"; break;
          case '\t': out += "\\t"; break;
          default:
            if (c < 0x20) {
              char buf[8];
              std::snprintf(buf, sizeof(buf), "\\u%04x", c);
              out += buf;
            } else {
              out += static_cast<char>(c);
            }
        }
      }
      out += '"';
      break;
    }
    case Json::ARR: {
      out += '[';
      for (size_t k = 0; k < v.arr.size(); ++k) {
        if (k) out += ',';
        dump_json(v.arr[k], out);
      }
      out += ']';
      break;
    }
    case Json::OBJ: {
      out += '{';
      for (size_t k = 0; k < v.obj.size(); ++k) {
        if (k) out += ',';
        dump_json(Json::of(v.obj[k].first), out);
        out += ':';
        dump_json(v.obj[k].second, out);
      }
      out += '}';
      break;
    }
  }
}

// ------------------------------------------------------------- transport
// Frame: 8-byte little-endian length, then "\0JSN" + JSON bytes (the
// Python MsgConnection auto-detects the magic; pickles never start with
// \0, so the discriminator is unambiguous).

static const char kMagic[4] = {'\0', 'J', 'S', 'N'};

class Conn {
 public:
  explicit Conn(int fd) : fd_(fd) {}
  ~Conn() { if (fd_ >= 0) ::close(fd_); }

  void send(const Json& msg) {
    std::string payload(kMagic, 4);
    dump_json(msg, payload);
    uint64_t n = payload.size();
    char head[8];
    for (int k = 0; k < 8; ++k) head[k] = static_cast<char>((n >> (8 * k)) & 0xFF);
    write_all(head, 8);
    write_all(payload.data(), payload.size());
  }

  Json recv() {
    char head[8];
    read_all(head, 8);
    uint64_t n = 0;
    for (int k = 7; k >= 0; --k) n = (n << 8) | static_cast<unsigned char>(head[k]);
    if (n > (1ull << 30)) throw std::runtime_error("oversized frame");
    std::string payload(n, '\0');
    read_all(payload.data(), n);
    if (n < 4 || std::memcmp(payload.data(), kMagic, 4) != 0)
      throw std::runtime_error("non-JSON frame for cpp worker");
    return parse_json(payload.substr(4));
  }

 private:
  void write_all(const char* p, size_t n) {
    while (n) {
      ssize_t w = ::send(fd_, p, n, 0);
      if (w <= 0) throw std::runtime_error("send failed");
      p += w;
      n -= static_cast<size_t>(w);
    }
  }
  void read_all(char* p, size_t n) {
    while (n) {
      ssize_t r = ::recv(fd_, p, n, 0);
      if (r <= 0) throw std::runtime_error("connection closed");
      p += r;
      n -= static_cast<size_t>(r);
    }
  }
  int fd_;
};

int dial(const std::string& host, const std::string& port) {
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res)
    throw std::runtime_error("resolve failed: " + host);
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) throw std::runtime_error("connect failed: " + host + ":" + port);
  return fd;
}

// -------------------------------------------------------------- registry

using Fn = std::function<Json(const JsonArr&)>;

std::map<std::string, Fn>& registry() {
  static std::map<std::string, Fn> r;
  return r;
}

void register_function(const std::string& name, Fn fn) {
  registry()[name] = std::move(fn);
}

void install_functions() {
  register_function("add", [](const JsonArr& a) {
    return Json::of(a.at(0).as_number() + a.at(1).as_number());
  });
  register_function("mul", [](const JsonArr& a) {
    return Json::of(a.at(0).as_number() * a.at(1).as_number());
  });
  register_function("concat", [](const JsonArr& a) {
    std::string out;
    for (const auto& v : a) out += v.s;
    return Json::of(out);
  });
  register_function("vec_sum", [](const JsonArr& a) {
    double total = 0;
    for (const auto& v : a.at(0).arr) total += v.as_number();
    return Json::of(total);
  });
  // something a native worker is FOR: a tight numeric loop
  register_function("monte_carlo_pi", [](const JsonArr& a) {
    auto n = static_cast<int64_t>(a.at(0).as_number());
    std::mt19937_64 rng(42);
    std::uniform_real_distribution<double> u(0.0, 1.0);
    int64_t in = 0;
    for (int64_t k = 0; k < n; ++k) {
      double x = u(rng), y = u(rng);
      if (x * x + y * y <= 1.0) ++in;
    }
    return Json::of(4.0 * static_cast<double>(in) / static_cast<double>(n));
  });
  register_function("fail_on_purpose", [](const JsonArr&) -> Json {
    throw std::runtime_error("intentional failure from C++");
  });
}

// ------------------------------------------------------------ worker loop

int worker_main(int argc, char** argv) {
  std::string address, node_id = "node-0", host_id = "host-0";
  for (int k = 1; k < argc; ++k) {
    std::string a = argv[k];
    if (a == "--address" && k + 1 < argc) address = argv[++k];
    else if (a == "--node" && k + 1 < argc) node_id = argv[++k];
    else if (a == "--host" && k + 1 < argc) host_id = argv[++k];
  }
  if (address.empty()) {
    std::fprintf(stderr, "usage: cpp_worker --address host:port\n");
    return 2;
  }
  auto colon = address.rfind(':');
  install_functions();

  Conn conn(dial(address.substr(0, colon), address.substr(colon + 1)));
  std::mt19937_64 rng(std::random_device{}());
  char widbuf[32];
  std::snprintf(widbuf, sizeof(widbuf), "cpp-%016llx",
                static_cast<unsigned long long>(rng()));
  std::string wid = widbuf;

  Json reg = Json::object();
  reg.set("type", Json::of("register"));
  reg.set("rid", Json::of(static_cast<int64_t>(1)));
  reg.set("wid", Json::of(wid));
  reg.set("kind", Json::of("worker"));
  reg.set("codec", Json::of("json"));
  reg.set("language", Json::of("cpp"));
  reg.set("pid", Json::of(static_cast<int64_t>(::getpid())));
  reg.set("node_id", Json::of(node_id));
  reg.set("host", Json::of(host_id));
  Json fns = Json::array();
  for (const auto& kv : registry()) fns.arr.push_back(Json::of(kv.first));
  reg.set("functions", fns);
  conn.send(reg);
  Json hello = conn.recv();
  const Json* ok = hello.get("ok");
  if (!ok || !ok->b) {
    std::fprintf(stderr, "registration refused\n");
    return 1;
  }
  std::fprintf(stderr, "cpp worker %s ready (%zu functions)\n", wid.c_str(),
               registry().size());

  while (true) {
    Json msg = conn.recv();
    const Json* type = msg.get("type");
    if (!type) continue;
    if (type->s == "exit" || type->s == "die") return 0;
    if (type->s != "exec") continue;
    const Json* spec = msg.get("spec");
    if (!spec) continue;
    const Json* tid = spec->get("task_id");
    const Json* fname = spec->get("func_name");
    const Json* args = spec->get("args");

    Json done = Json::object();
    done.set("type", Json::of("task_done"));
    done.set("wid", Json::of(wid));
    Json echo = Json::object();
    echo.set("task_id", tid ? *tid : Json::null());
    echo.set("kind", Json::of("task"));
    echo.set("num_returns", Json::of(static_cast<int64_t>(1)));
    done.set("spec", echo);

    Json value = Json::null();
    std::string error;
    try {
      if (!fname) throw std::runtime_error("spec missing func_name");
      auto it = registry().find(fname->s);
      if (it == registry().end())
        throw std::runtime_error("unknown cpp function: " + fname->s);
      value = it->second(args ? args->arr : JsonArr{});
    } catch (const std::exception& e) {
      error = e.what();
    }
    if (error.empty()) done.set("error", Json::null());
    else done.set("error", Json::of(error));
    Json results = Json::array();
    Json res = Json::array();
    res.arr.push_back(Json::of((tid ? tid->s : std::string()) + "r0000"));
    res.arr.push_back(Json::of("inline"));
    res.arr.push_back(value);
    res.arr.push_back(Json::of(static_cast<int64_t>(0)));
    results.arr.push_back(res);
    done.set("results", results);
    conn.send(done);
  }
}

}  // namespace ray_tpu_torch

int main(int argc, char** argv) {
  try {
    return ray_tpu_torch::worker_main(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "cpp worker fatal: %s\n", e.what());
    return 1;
  }
}
