// TCP key-value store: the coordination substrate of the port's elastic
// manager and rendezvous helpers (paddle_tpu_torch/distributed/kvstore.py).
//
// Host code, not a kernel: ops/_build.py compiles it with the host C++
// compiler (g++), at first use, into build/paddle_tpu_torch/. The wire
// protocol is the JAX package's csrc/kvstore.cc byte for byte, so either
// package's client talks to either package's server.
//
// Reference analog: the etcd3 store behind fleet's elastic manager
// (`python/paddle/distributed/fleet/elastic/manager.py:103,147`) and the
// gloo/KVStore rendezvous in fleet launch. Design: a single-process
// authoritative store (runs on host 0 or a sidecar), clients speak a
// tiny length-prefixed binary protocol over TCP; atomic ADD doubles as
// the barrier/sequence primitive. shutdown() closes live connection fds
// before joining handlers, and wire-declared sizes are bounded before
// allocation.
//
// Frame: u32 op, u32 key length, u32 value length, key, value; reply:
// i64 status, i64 payload length, payload.
// Ops: 1=SET 2=GET 3=DEL 4=ADD(i64 delta -> new value) 5=LIST(prefix)
//      6=close connection
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMaxKey = 1 << 16;    // 64 KiB
constexpr uint32_t kMaxVal = 1 << 26;    // 64 MiB

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::vector<std::thread> handlers;
  std::vector<int> conn_fds;
  std::mutex conn_mu;

  std::map<std::string, std::string> data;
  std::mutex mu;

  void handle(int fd) {
    for (;;) {
      uint32_t hdr[3];
      if (!read_full(fd, hdr, sizeof(hdr))) break;
      uint32_t op = hdr[0], klen = hdr[1], vlen = hdr[2];
      if (op == 6) break;
      if (klen > kMaxKey || vlen > kMaxVal) break;
      std::string key(klen, '\0'), val(vlen, '\0');
      if (klen && !read_full(fd, key.data(), klen)) break;
      if (vlen && !read_full(fd, val.data(), vlen)) break;

      int64_t status = 0;
      std::string reply;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (op == 1) {                       // SET
          data[key] = std::move(val);
        } else if (op == 2) {                // GET
          auto it = data.find(key);
          if (it == data.end()) status = -1;
          else reply = it->second;
        } else if (op == 3) {                // DEL
          status = data.erase(key) ? 0 : -1;
        } else if (op == 4) {                // ADD
          int64_t delta = 0;
          if (val.size() == 8) memcpy(&delta, val.data(), 8);
          int64_t cur = 0;
          auto it = data.find(key);
          if (it != data.end() && it->second.size() == 8)
            memcpy(&cur, it->second.data(), 8);
          cur += delta;
          std::string enc(8, '\0');
          memcpy(enc.data(), &cur, 8);
          data[key] = enc;
          reply = enc;
        } else if (op == 5) {                // LIST prefix
          for (auto it = data.lower_bound(key); it != data.end(); ++it) {
            if (it->first.compare(0, key.size(), key) != 0) break;
            if (!reply.empty()) reply.push_back('\n');
            reply += it->first;
          }
        } else {
          status = -2;
        }
      }
      int64_t shdr[2] = {status, static_cast<int64_t>(reply.size())};
      if (!write_full(fd, shdr, sizeof(shdr))) break;
      if (!reply.empty() && !write_full(fd, reply.data(), reply.size()))
        break;
    }
    close(fd);
  }

  bool start(int want_port) {
    listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0) return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    if (listen(listen_fd, 64) != 0) return false;
    accept_thread = std::thread([this] {
      for (;;) {
        int fd = accept(listen_fd, nullptr, nullptr);
        if (fd < 0) break;                    // listen fd closed -> exit
        if (stop.load()) { close(fd); break; }
        int one2 = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one2, sizeof(one2));
        {
          std::lock_guard<std::mutex> lk(conn_mu);
          conn_fds.push_back(fd);
        }
        handlers.emplace_back([this, fd] { handle(fd); });
      }
    });
    return true;
  }

  void shutdown_all() {
    stop.store(true);
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      close(listen_fd);
      listen_fd = -1;
    }
    {
      // unblock handlers stuck in recv() on live client connections
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
    }
    if (accept_thread.joinable()) accept_thread.join();
    for (auto& t : handlers)
      if (t.joinable()) t.join();
  }
};

struct Client {
  int fd = -1;
  std::string last;                           // reply buffer for get/list
  std::mutex mu;

  // status, and fills `last` with the reply payload
  int64_t request(uint32_t op, const std::string& key,
                  const std::string& val) {
    std::lock_guard<std::mutex> lk(mu);
    uint32_t hdr[3] = {op, static_cast<uint32_t>(key.size()),
                       static_cast<uint32_t>(val.size())};
    if (!write_full(fd, hdr, sizeof(hdr))) return -3;
    if (!key.empty() && !write_full(fd, key.data(), key.size())) return -3;
    if (!val.empty() && !write_full(fd, val.data(), val.size())) return -3;
    int64_t shdr[2];
    if (!read_full(fd, shdr, sizeof(shdr))) return -3;
    if (shdr[1] < 0 || shdr[1] > static_cast<int64_t>(kMaxVal)) return -3;
    last.resize(static_cast<size_t>(shdr[1]));
    if (shdr[1] && !read_full(fd, last.data(), last.size())) return -3;
    return shdr[0];
  }
};

}  // namespace

extern "C" {

void* kvs_server_start(int port) {
  auto* s = new Server();
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int kvs_server_port(void* h) { return static_cast<Server*>(h)->port; }

void kvs_server_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  s->shutdown_all();
  delete s;
}

void* kvs_connect(const char* host, int port, int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return nullptr;
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

int64_t kvs_set(void* h, const char* key, const char* val, int64_t vlen) {
  return static_cast<Client*>(h)->request(
      1, key, std::string(val, static_cast<size_t>(vlen)));
}

// returns value length (>= 0) or -1 absent / -3 io error; value kept in
// the client until the next call — fetch with kvs_copy
int64_t kvs_get(void* h, const char* key) {
  auto* c = static_cast<Client*>(h);
  int64_t st = c->request(2, key, "");
  return st == 0 ? static_cast<int64_t>(c->last.size()) : st;
}

int64_t kvs_del(void* h, const char* key) {
  return static_cast<Client*>(h)->request(3, key, "");
}

int64_t kvs_add(void* h, const char* key, int64_t delta) {
  auto* c = static_cast<Client*>(h);
  std::string enc(8, '\0');
  memcpy(enc.data(), &delta, 8);
  int64_t st = c->request(4, key, enc);
  if (st != 0 || c->last.size() != 8) return INT64_MIN;
  int64_t out;
  memcpy(&out, c->last.data(), 8);
  return out;
}

int64_t kvs_list(void* h, const char* prefix) {
  auto* c = static_cast<Client*>(h);
  int64_t st = c->request(5, prefix, "");
  return st == 0 ? static_cast<int64_t>(c->last.size()) : st;
}

void kvs_copy(void* h, char* buf, int64_t cap) {
  auto* c = static_cast<Client*>(h);
  size_t n = c->last.size();
  if (cap >= 0 && static_cast<size_t>(cap) < n)
    n = static_cast<size_t>(cap);
  memcpy(buf, c->last.data(), n);
}

void kvs_client_close(void* h) {
  auto* c = static_cast<Client*>(h);
  uint32_t hdr[3] = {6, 0, 0};
  write_full(c->fd, hdr, sizeof(hdr));
  close(c->fd);
  delete c;
}

}  // extern "C"
