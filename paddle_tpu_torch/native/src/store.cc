// Native TCP key-value rendezvous store.
//
// Reference analog: paddle/phi/core/distributed/store/tcp_store.h:121
// (TCPStore master/worker + tcp_utils) — the bootstrap KV store used for
// rendezvous, rank exchange and host barriers. Its role here: the
// host-level store of the elastic launcher; in-program collectives run
// over torch.distributed, so this store only ever carries small control
// messages (endpoints, barrier counters, heartbeats).
//
// Wire protocol (all little-endian, persistent connection per client):
//   request : u8 op | u32 keylen | key bytes | op-specific payload
//   SET(1)  : payload = u64 vallen | val        -> reply u8 1
//   GET(2)  : payload = i64 timeout_ms          -> reply i64 vallen | val
//             (blocks server-side until key set; vallen = -1 on timeout)
//   ADD(3)  : payload = i64 delta               -> reply i64 new_value
//   CHECK(4): payload = none                    -> reply u8 exists
//   DEL(5)  : payload = none                    -> reply u8 1
//   LIST(6) : key = prefix                      -> reply u32 count then
//             per entry u32 klen | key | u64 vlen | val
// The server runs one accept loop thread plus one thread per connection
// (worker count == world size: small and bounded).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct StoreServer {
  int listen_fd = -1;
  std::thread accept_thread;
  std::vector<std::thread> conn_threads;
  std::vector<int> conn_fds;  // guarded by mu; closed on stop to unblock
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::vector<char>> kv;
  std::map<std::string, int64_t> counters;
  std::atomic<bool> stopping{false};
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void serve_conn(StoreServer* s, int fd) {
  for (;;) {
    uint8_t op;
    if (!read_full(fd, &op, 1)) break;
    uint32_t klen;
    if (!read_full(fd, &klen, 4) || klen > (1u << 20)) break;
    std::string key(klen, '\0');
    if (!read_full(fd, key.data(), klen)) break;
    if (op == 1) {  // SET
      uint64_t vlen;
      if (!read_full(fd, &vlen, 8) || vlen > (1ull << 30)) break;
      std::vector<char> val(vlen);
      if (vlen && !read_full(fd, val.data(), vlen)) break;
      {
        std::lock_guard<std::mutex> g(s->mu);
        s->kv[key] = std::move(val);
      }
      s->cv.notify_all();
      uint8_t ok = 1;
      if (!write_full(fd, &ok, 1)) break;
    } else if (op == 2) {  // GET (blocking wait with timeout)
      int64_t timeout_ms;
      if (!read_full(fd, &timeout_ms, 8)) break;
      std::vector<char> val;
      int64_t vlen = -1;
      {
        std::unique_lock<std::mutex> lk(s->mu);
        auto pred = [&] {
          return s->stopping.load() || s->kv.count(key) > 0;
        };
        if (timeout_ms < 0) {
          s->cv.wait(lk, pred);
        } else {
          s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
        }
        auto it = s->kv.find(key);
        if (it != s->kv.end()) {
          val = it->second;
          vlen = static_cast<int64_t>(val.size());
        }
      }
      if (!write_full(fd, &vlen, 8)) break;
      if (vlen > 0 && !write_full(fd, val.data(), val.size())) break;
    } else if (op == 3) {  // ADD
      int64_t delta;
      if (!read_full(fd, &delta, 8)) break;
      int64_t now;
      {
        std::lock_guard<std::mutex> g(s->mu);
        now = (s->counters[key] += delta);
        // mirror into kv so GET/wait can observe counters too
        std::string repr = std::to_string(now);
        s->kv[key].assign(repr.begin(), repr.end());
      }
      s->cv.notify_all();
      if (!write_full(fd, &now, 8)) break;
    } else if (op == 4) {  // CHECK
      uint8_t exists;
      {
        std::lock_guard<std::mutex> g(s->mu);
        exists = s->kv.count(key) ? 1 : 0;
      }
      if (!write_full(fd, &exists, 1)) break;
    } else if (op == 5) {  // DEL
      {
        std::lock_guard<std::mutex> g(s->mu);
        s->kv.erase(key);
        s->counters.erase(key);
      }
      s->cv.notify_all();
      uint8_t ok = 1;
      if (!write_full(fd, &ok, 1)) break;
    } else if (op == 6) {  // LIST by prefix
      std::vector<std::pair<std::string, std::vector<char>>> hits;
      {
        std::lock_guard<std::mutex> g(s->mu);
        for (auto it = s->kv.lower_bound(key); it != s->kv.end(); ++it) {
          if (it->first.compare(0, key.size(), key) != 0) break;
          hits.emplace_back(it->first, it->second);
        }
      }
      uint32_t count = static_cast<uint32_t>(hits.size());
      if (!write_full(fd, &count, 4)) break;
      bool ok = true;
      for (auto& kvp : hits) {
        uint32_t hk = static_cast<uint32_t>(kvp.first.size());
        uint64_t hv = static_cast<uint64_t>(kvp.second.size());
        if (!write_full(fd, &hk, 4) ||
            !write_full(fd, kvp.first.data(), hk) ||
            !write_full(fd, &hv, 8) ||
            (hv && !write_full(fd, kvp.second.data(), hv))) {
          ok = false;
          break;
        }
      }
      if (!ok) break;
    } else {
      break;
    }
  }
  ::close(fd);
}

struct StoreClient {
  int fd = -1;
  std::mutex mu;  // one request/reply in flight per client
};

}  // namespace

extern "C" {

// Start server bound to 0.0.0.0:port. Returns handle or nullptr.
void* pn_store_server_start(int32_t port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new StoreServer();
  s->listen_fd = fd;
  s->accept_thread = std::thread([s] {
    for (;;) {
      int cfd = ::accept(s->listen_fd, nullptr, nullptr);
      if (cfd < 0) break;  // listen_fd closed -> shutdown
      int one2 = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one2, sizeof(one2));
      std::lock_guard<std::mutex> g(s->mu);
      if (s->stopping.load()) {
        ::close(cfd);
        break;
      }
      s->conn_fds.push_back(cfd);
      s->conn_threads.emplace_back(serve_conn, s, cfd);
    }
  });
  return s;
}

void pn_store_server_stop(void* h) {
  auto* s = static_cast<StoreServer*>(h);
  if (!s) return;
  s->stopping.store(true);
  s->cv.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // Unblock connection threads (recv returns once the fd is shut down),
  // then join them all before freeing the server state they reference.
  std::vector<std::thread> conns;
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
    conns.swap(s->conn_threads);
  }
  for (auto& t : conns) {
    if (t.joinable()) t.join();
  }
  delete s;
}

void* pn_store_connect(const char* host, int32_t port,
                       int32_t timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  std::string portstr = std::to_string(port);
  for (;;) {
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    int fd = -1;
    if (::getaddrinfo(host, portstr.c_str(), &hints, &res) == 0) {
      for (addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
        fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
        ::close(fd);
        fd = -1;
      }
      ::freeaddrinfo(res);
    }
    if (fd >= 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new StoreClient();
      c->fd = fd;
      return c;
    }
    if (std::chrono::steady_clock::now() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

void pn_store_client_close(void* h) {
  auto* c = static_cast<StoreClient*>(h);
  if (!c) return;
  ::close(c->fd);
  delete c;
}

static bool send_key(StoreClient* c, uint8_t op, const char* key) {
  uint32_t klen = static_cast<uint32_t>(std::strlen(key));
  return write_full(c->fd, &op, 1) && write_full(c->fd, &klen, 4) &&
         write_full(c->fd, key, klen);
}

int32_t pn_store_set(void* h, const char* key, const void* val,
                     int64_t len) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  uint64_t vlen = static_cast<uint64_t>(len);
  if (!send_key(c, 1, key) || !write_full(c->fd, &vlen, 8) ||
      (len && !write_full(c->fd, val, len)))
    return 0;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) ? ok : 0;
}

// Blocking get; returns value size, -1 on timeout/closed, -2 if out_cap
// too small (value is consumed either way).
int64_t pn_store_get(void* h, const char* key, void* out, int64_t out_cap,
                     int64_t timeout_ms) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (!send_key(c, 2, key) || !write_full(c->fd, &timeout_ms, 8))
    return -1;
  int64_t vlen;
  if (!read_full(c->fd, &vlen, 8)) return -1;
  if (vlen < 0) return -1;
  std::vector<char> buf(vlen);
  if (vlen && !read_full(c->fd, buf.data(), vlen)) return -1;
  if (vlen > out_cap) return -2;
  if (vlen) std::memcpy(out, buf.data(), vlen);
  return vlen;
}

int64_t pn_store_add(void* h, const char* key, int64_t delta) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (!send_key(c, 3, key) || !write_full(c->fd, &delta, 8))
    return INT64_MIN;
  int64_t now;
  return read_full(c->fd, &now, 8) ? now : INT64_MIN;
}

int32_t pn_store_check(void* h, const char* key) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (!send_key(c, 4, key)) return -1;
  uint8_t exists;
  return read_full(c->fd, &exists, 1) ? exists : -1;
}

int32_t pn_store_delete(void* h, const char* key) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (!send_key(c, 5, key)) return 0;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) ? ok : 0;
}

// List entries under prefix into a packed buffer:
//   per entry: u32 klen | key | u64 vlen | val
// Returns bytes written, -1 on transport error, -2 if out_cap too small
// (entries are consumed either way; caller retries with bigger cap).
int64_t pn_store_list(void* h, const char* prefix, void* out,
                      int64_t out_cap, int32_t* count_out) {
  auto* c = static_cast<StoreClient*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (!send_key(c, 6, prefix)) return -1;
  uint32_t count;
  if (!read_full(c->fd, &count, 4)) return -1;
  char* p = static_cast<char*>(out);
  int64_t used = 0;
  bool overflow = false;
  for (uint32_t i = 0; i < count; ++i) {
    uint32_t klen;
    if (!read_full(c->fd, &klen, 4)) return -1;
    std::vector<char> kbuf(klen);
    if (klen && !read_full(c->fd, kbuf.data(), klen)) return -1;
    uint64_t vlen;
    if (!read_full(c->fd, &vlen, 8)) return -1;
    std::vector<char> vbuf(vlen);
    if (vlen && !read_full(c->fd, vbuf.data(), vlen)) return -1;
    int64_t need = 4 + klen + 8 + static_cast<int64_t>(vlen);
    if (used + need > out_cap) {
      overflow = true;
      continue;
    }
    std::memcpy(p + used, &klen, 4);
    used += 4;
    std::memcpy(p + used, kbuf.data(), klen);
    used += klen;
    std::memcpy(p + used, &vlen, 8);
    used += 8;
    std::memcpy(p + used, vbuf.data(), vlen);
    used += static_cast<int64_t>(vlen);
  }
  *count_out = static_cast<int32_t>(count);
  return overflow ? -2 : used;
}

}  // extern "C"
