// Host-side coordination service for multi-process training.
//
// The PyTorch port's copy of autodist_tpu/runtime/native/coord.cc: the
// same wire protocol and the same extern "C" surface, so a client of
// either package talks to a server of the other.  It is the counterpart
// of the native TensorFlow-runtime features the reference drove for
// between-graph coordination: the size-1 FIFO token queues used as sync
// barriers and the depth-`staleness` queues of stale-synchronous parallel
// training (reference ps_synchronizer.py:335-458), the cross-worker
// strategy handoff the reference did over SFTP (coordinator.py:66-90), and
// named counters/barriers.  The collectives own the data plane; this
// service is the out-of-band control plane between processes, and the
// transport of the asynchronous parameter server's gradient and parameter
// blobs (autodist_tpu_torch/runner.py AsyncPSRunner).
//
// One chief process runs the server; every process (incl. the chief)
// connects a client over TCP.  Wire protocol, little-endian:
//   request:  [u32 len][u8 op][u16 klen][key][u32 vlen][val][i64 arg][i64 arg2]
//   response: [u32 len][u8 status][i64 ret][u32 vlen][val]
// `len` counts the bytes after the length field itself.  Blocking ops wait
// server-side on a condition variable with a millisecond deadline carried in
// `arg`/`arg2` (-1 = wait forever).
//
// Differences from the JAX package's copy, none in the format: a frame
// may hold up to kMaxFrameBytes (2 GiB; that copy stops at 64 MiB, below
// one BERT-base fp32 tree of 0.44 GB), but a connection that has not yet
// presented the server's token may send no frame above
// kMaxUnauthedFrameBytes; a frame's buffer grows as its bytes arrive, so
// a declared length commits no memory the peer has not sent; and a
// request's declared lengths are summed in 64 bits, so a forged `vlen`
// cannot wrap the sum back to `len` and read past the frame.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

enum Op : uint8_t {
  kPut = 1,
  kGet = 2,          // arg = timeout_ms (0 = immediate, -1 = forever)
  kBarrier = 3,      // arg = participant count, arg2 = timeout_ms
  kCounterAdd = 4,   // arg = delta; returns new value
  kQueuePut = 5,
  kQueueGet = 6,     // arg = timeout_ms
  kSspRegister = 7,  // key = worker name
  kSspReport = 8,    // key = worker name, arg = completed step
  kSspWait = 9,      // arg = step, arg2 = staleness; uses default timeout
  kAuth = 10,        // val = shared-secret token; must be a connection's
                     // first request when the server has a token
};

enum Status : uint8_t { kOk = 0, kTimeout = 1, kError = 2 };

// The largest frame (request or response, after its length field) either
// side accepts.
constexpr uint32_t kMaxFrameBytes = 2u << 30;
// The largest request a connection may send before its token matched:
// room for a kAuth frame.
constexpr uint32_t kMaxUnauthedFrameBytes = 64u << 10;

struct BarrierState {
  int64_t generation = 0;
  int64_t arrived = 0;
};

struct ServerState {
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<std::string, std::string> kv;
  std::unordered_map<std::string, std::deque<std::string>> queues;
  std::unordered_map<std::string, int64_t> counters;
  std::unordered_map<std::string, BarrierState> barriers;
  std::unordered_map<std::string, int64_t> progress;  // SSP: worker -> step
  bool stopping = false;
};

bool SendAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool RecvAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Reads `len` bytes into `buf`, growing it (doubling from 1 MiB) only as
// the bytes arrive.
bool RecvGrowing(int fd, std::vector<char>* buf, size_t len) {
  constexpr size_t kFirst = 1u << 20;
  buf->clear();
  while (buf->size() < len) {
    size_t got = buf->size();
    size_t n = std::min(len - got, std::max(kFirst, got));
    buf->resize(got + n);
    if (!RecvAll(fd, buf->data() + got, n)) return false;
  }
  return true;
}

struct Request {
  uint8_t op = 0;
  std::string key;
  std::string val;
  int64_t arg = 0;
  int64_t arg2 = 0;
};

// Reads one request of at most `max_len` bytes after its length field.
bool ReadRequest(int fd, Request* req, uint32_t max_len) {
  uint32_t len;
  if (!RecvAll(fd, &len, 4)) return false;
  if (len < 1 + 2 + 4 + 8 + 8 || len > max_len) return false;
  std::vector<char> buf;
  if (!RecvGrowing(fd, &buf, len)) return false;
  const char* p = buf.data();
  req->op = static_cast<uint8_t>(*p);
  p += 1;
  uint16_t klen;
  std::memcpy(&klen, p, 2);
  p += 2;
  if (static_cast<uint32_t>(1 + 2 + klen + 4 + 8 + 8) > len) return false;
  req->key.assign(p, klen);
  p += klen;
  uint32_t vlen;
  std::memcpy(&vlen, p, 4);
  p += 4;
  if (uint64_t{1} + 2 + klen + 4 + vlen + 8 + 8 != len) return false;
  req->val.assign(p, vlen);
  p += vlen;
  std::memcpy(&req->arg, p, 8);
  p += 8;
  std::memcpy(&req->arg2, p, 8);
  return true;
}

bool WriteResponse(int fd, uint8_t status, int64_t ret,
                   const std::string& val) {
  uint32_t len = 1 + 8 + 4 + static_cast<uint32_t>(val.size());
  std::vector<char> buf(4 + len);
  char* p = buf.data();
  std::memcpy(p, &len, 4);
  p += 4;
  *p = static_cast<char>(status);
  p += 1;
  std::memcpy(p, &ret, 8);
  p += 8;
  uint32_t vlen = static_cast<uint32_t>(val.size());
  std::memcpy(p, &vlen, 4);
  p += 4;
  if (!val.empty()) std::memcpy(p, val.data(), val.size());
  return SendAll(fd, buf.data(), buf.size());
}

// Waits on `state.cv` until `pred()` or the deadline; returns pred's value.
// timeout_ms < 0 waits until shutdown.
template <class Pred>
bool WaitFor(ServerState& state, std::unique_lock<std::mutex>& lk,
             int64_t timeout_ms, Pred pred) {
  auto stop_or_pred = [&] { return state.stopping || pred(); };
  if (timeout_ms < 0) {
    state.cv.wait(lk, stop_or_pred);
  } else {
    state.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), stop_or_pred);
  }
  return pred();
}

void HandleRequest(ServerState& state, const Request& req, int fd) {
  std::unique_lock<std::mutex> lk(state.mu);
  switch (req.op) {
    case kAuth: {
      // Already authenticated (or no token configured): idempotent OK.
      lk.unlock();
      WriteResponse(fd, kOk, 0, "");
      return;
    }
    case kPut: {
      state.kv[req.key] = req.val;
      state.cv.notify_all();
      lk.unlock();
      WriteResponse(fd, kOk, 0, "");
      return;
    }
    case kGet: {
      bool found = WaitFor(state, lk, req.arg, [&] {
        return state.kv.count(req.key) != 0;
      });
      std::string val = found ? state.kv[req.key] : "";
      lk.unlock();
      WriteResponse(fd, found ? kOk : kTimeout, 0, val);
      return;
    }
    case kBarrier: {
      BarrierState& b = state.barriers[req.key];
      int64_t gen = b.generation;
      b.arrived += 1;
      bool done;
      if (b.arrived >= req.arg) {
        b.arrived = 0;
        b.generation += 1;
        state.cv.notify_all();
        done = true;
      } else {
        done = WaitFor(state, lk, req.arg2, [&] {
          return state.barriers[req.key].generation != gen;
        });
        if (!done) state.barriers[req.key].arrived -= 1;  // withdraw
      }
      lk.unlock();
      WriteResponse(fd, done ? kOk : kTimeout, 0, "");
      return;
    }
    case kCounterAdd: {
      int64_t v = (state.counters[req.key] += req.arg);
      state.cv.notify_all();
      lk.unlock();
      WriteResponse(fd, kOk, v, "");
      return;
    }
    case kQueuePut: {
      state.queues[req.key].push_back(req.val);
      state.cv.notify_all();
      lk.unlock();
      WriteResponse(fd, kOk, 0, "");
      return;
    }
    case kQueueGet: {
      bool found = WaitFor(state, lk, req.arg, [&] {
        auto it = state.queues.find(req.key);
        return it != state.queues.end() && !it->second.empty();
      });
      std::string val;
      if (found) {
        val = state.queues[req.key].front();
        state.queues[req.key].pop_front();
      }
      lk.unlock();
      WriteResponse(fd, found ? kOk : kTimeout, 0, val);
      return;
    }
    case kSspRegister: {
      if (!state.progress.count(req.key)) state.progress[req.key] = -1;
      state.cv.notify_all();
      lk.unlock();
      WriteResponse(fd, kOk, 0, "");
      return;
    }
    case kSspReport: {
      state.progress[req.key] = std::max(state.progress[req.key], req.arg);
      state.cv.notify_all();
      lk.unlock();
      WriteResponse(fd, kOk, 0, "");
      return;
    }
    case kSspWait: {
      // Proceed with step `arg` once every registered worker has completed
      // step arg - 1 - staleness (arg2 = staleness): the bounded-staleness
      // gate of SSP (reference ps_synchronizer.py:387-458).
      int64_t step = req.arg, staleness = req.arg2;
      auto ready = [&] {
        int64_t min_done = INT64_MAX;
        for (const auto& it : state.progress)
          min_done = std::min(min_done, it.second);
        return state.progress.empty() || min_done >= step - 1 - staleness;
      };
      // Bounded default wait: waiting forever would deadlock behind a
      // crashed worker; callers re-issue on timeout if they want longer.
      bool ok = WaitFor(state, lk, 600000, ready);
      lk.unlock();
      WriteResponse(fd, ok ? kOk : kTimeout, 0, "");
      return;
    }
    default:
      lk.unlock();
      WriteResponse(fd, kError, 0, "unknown op");
  }
}

struct Server {
  ServerState state;
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  // Live connections only: a connection thread deregisters its fd (under
  // conn_mu) before closing it, so Stop never touches a recycled fd, and
  // detached threads don't accumulate across reconnecting clients.
  std::mutex conn_mu;
  std::condition_variable conn_cv;
  std::unordered_set<int> conn_fds;
  int active_conns = 0;

  std::string token;  // empty = unauthenticated (trusted loopback only)

  void Serve() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        // Transient errors (client reset before accept, fd exhaustion,
        // signal) must not kill the service; only a closed/invalid listen
        // socket means shutdown.
        if (errno == ECONNABORTED || errno == EINTR) continue;
        if (errno == EMFILE || errno == ENFILE) {
          std::this_thread::sleep_for(std::chrono::milliseconds(100));
          continue;
        }
        return;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      {
        std::lock_guard<std::mutex> g(conn_mu);
        conn_fds.insert(fd);
        active_conns += 1;
      }
      std::thread([this, fd] {
        Request req;
        // With a token configured, the first request must authenticate;
        // anything else (or a wrong token) terminates the connection
        // before it can touch barriers/KV/queues.
        bool authed = token.empty();
        while (ReadRequest(fd, &req, authed ? kMaxFrameBytes
                                            : kMaxUnauthedFrameBytes)) {
          if (!authed) {
            if (req.op == kAuth && req.val == token) {
              authed = true;
              if (!WriteResponse(fd, kOk, 0, "")) break;
              continue;
            }
            WriteResponse(fd, kError, 0, "");
            break;
          }
          HandleRequest(state, req, fd);
        }
        {
          std::lock_guard<std::mutex> g(conn_mu);
          conn_fds.erase(fd);
          active_conns -= 1;
          conn_cv.notify_all();
        }
        ::close(fd);
      }).detach();
    }
  }

  void StopConnections() {
    std::unique_lock<std::mutex> lk(conn_mu);
    for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
    conn_cv.wait(lk, [this] { return active_conns == 0; });
  }
};

}  // namespace

extern "C" {

// Starts a server on `bind_host:port` (port 0 = ephemeral; bind_host
// null/"" = all interfaces) requiring `token` (null/"" = no auth) on
// every connection.  Returns a handle or null.
void* coord_server_start(const char* bind_host, int port, const char* token) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (bind_host != nullptr && bind_host[0] != '\0') {
    if (::inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
      ::close(fd);
      return nullptr;
    }
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  if (token != nullptr) srv->token = token;
  srv->accept_thread = std::thread([srv] { srv->Serve(); });
  return srv;
}

// Adopts an already-bound, already-listening socket fd (the held-socket
// port reservation handoff: the caller binds an exclusive ephemeral
// port, keeps the socket held so no concurrent spawn can elect the same
// port, and hands the fd straight to the server — the port is never
// released between election and serve).  Takes ownership of `fd`.
void* coord_server_adopt(int fd, const char* token) {
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0) {
    return nullptr;
  }
  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  if (token != nullptr) srv->token = token;
  srv->accept_thread = std::thread([srv] { srv->Serve(); });
  return srv;
}

int coord_server_port(void* handle) {
  return handle ? static_cast<Server*>(handle)->port : -1;
}

void coord_server_stop(void* handle) {
  if (!handle) return;
  auto* srv = static_cast<Server*>(handle);
  {
    std::lock_guard<std::mutex> g(srv->state.mu);
    srv->state.stopping = true;
  }
  srv->state.cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  srv->accept_thread.join();
  srv->StopConnections();
  delete srv;
}

struct Client {
  int fd = -1;
  std::mutex mu;  // serializes request/response pairs on this connection
};

static int Call(Client* c, uint8_t op, const char* key, const void* val,
                uint32_t val_len, int64_t arg, int64_t arg2, char** out,
                uint32_t* out_len, int64_t* ret = nullptr);

void* coord_client_connect(const char* host, int port, int timeout_ms,
                           const char* token) {
  // Resolve hostname or IPv4 literal (chief addresses are usually
  // hostnames on a pod).
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
    return nullptr;
  sockaddr_in addr{};
  std::memcpy(&addr, res->ai_addr, sizeof(addr));
  addr.sin_port = htons(static_cast<uint16_t>(port));
  ::freeaddrinfo(res);
  // Simple retry loop instead of non-blocking connect: covers the common
  // "chief not up yet" race at job start.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    if (std::chrono::steady_clock::now() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  if (token != nullptr && token[0] != '\0') {
    if (Call(c, kAuth, "", token, static_cast<uint32_t>(std::strlen(token)),
             0, 0, nullptr, nullptr) != kOk) {
      ::close(c->fd);
      delete c;
      return nullptr;
    }
  }
  return c;
}

void coord_client_close(void* handle) {
  if (!handle) return;
  auto* c = static_cast<Client*>(handle);
  ::shutdown(c->fd, SHUT_RDWR);
  ::close(c->fd);
  delete c;
}

// Wakes any call blocked on this client (recv returns EOF) WITHOUT freeing
// it — safe to invoke from another thread while a Call is in flight; the
// owner closes (or leaks until exit) the husk later.
void coord_client_shutdown(void* handle) {
  if (!handle) return;
  ::shutdown(static_cast<Client*>(handle)->fd, SHUT_RDWR);
}

// Round-trips one request.  Returns status; *out/*out_len receive a
// malloc'd value buffer (caller frees with coord_free) and *ret the
// response's i64 field, when non-null.
static int Call(Client* c, uint8_t op, const char* key, const void* val,
                uint32_t val_len, int64_t arg, int64_t arg2, char** out,
                uint32_t* out_len, int64_t* ret) {
  if (c == nullptr) return kError;
  std::lock_guard<std::mutex> g(c->mu);
  uint16_t klen = static_cast<uint16_t>(std::strlen(key));
  // A frame the server would refuse (and drop the connection for) is not
  // sent at all.
  if (uint64_t{1} + 2 + klen + 4 + val_len + 8 + 8 > kMaxFrameBytes)
    return kError;
  uint32_t len = 1 + 2 + klen + 4 + val_len + 8 + 8;
  std::vector<char> buf(4 + len);
  char* p = buf.data();
  std::memcpy(p, &len, 4);
  p += 4;
  *p = static_cast<char>(op);
  p += 1;
  std::memcpy(p, &klen, 2);
  p += 2;
  std::memcpy(p, key, klen);
  p += klen;
  std::memcpy(p, &val_len, 4);
  p += 4;
  if (val_len) std::memcpy(p, val, val_len);
  p += val_len;
  std::memcpy(p, &arg, 8);
  p += 8;
  std::memcpy(p, &arg2, 8);
  if (!SendAll(c->fd, buf.data(), buf.size())) return kError;

  uint32_t rlen;
  if (!RecvAll(c->fd, &rlen, 4) || rlen < 1 + 8 + 4 || rlen > kMaxFrameBytes)
    return kError;
  std::vector<char> rbuf;
  if (!RecvGrowing(c->fd, &rbuf, rlen)) return kError;
  uint8_t status = static_cast<uint8_t>(rbuf[0]);
  if (ret) std::memcpy(ret, rbuf.data() + 1, 8);
  uint32_t vlen;
  std::memcpy(&vlen, rbuf.data() + 9, 4);
  if (vlen != rlen - 13) return kError;  // framing desync / truncation
  if (out && out_len) {
    *out = nullptr;
    *out_len = 0;
    if (vlen) {
      *out = static_cast<char*>(std::malloc(vlen));
      if (*out == nullptr) return kError;
      std::memcpy(*out, rbuf.data() + 13, vlen);
      *out_len = vlen;
    }
  }
  return status;
}

int coord_put(void* h, const char* key, const void* val, uint32_t len) {
  return Call(static_cast<Client*>(h), kPut, key, val, len, 0, 0, nullptr,
              nullptr);
}

int coord_get(void* h, const char* key, int64_t timeout_ms, char** out,
              uint32_t* out_len) {
  return Call(static_cast<Client*>(h), kGet, key, nullptr, 0, timeout_ms, 0,
              out, out_len);
}

int coord_barrier(void* h, const char* name, int64_t n, int64_t timeout_ms) {
  return Call(static_cast<Client*>(h), kBarrier, name, nullptr, 0, n,
              timeout_ms, nullptr, nullptr);
}

int coord_counter_add(void* h, const char* key, int64_t delta, int64_t* out) {
  return Call(static_cast<Client*>(h), kCounterAdd, key, nullptr, 0, delta, 0,
              nullptr, nullptr, out);
}

int coord_queue_put(void* h, const char* key, const void* val, uint32_t len) {
  return Call(static_cast<Client*>(h), kQueuePut, key, val, len, 0, 0, nullptr,
              nullptr);
}

int coord_queue_get(void* h, const char* key, int64_t timeout_ms, char** out,
                    uint32_t* out_len) {
  return Call(static_cast<Client*>(h), kQueueGet, key, nullptr, 0, timeout_ms,
              0, out, out_len);
}

int coord_ssp_register(void* h, const char* worker) {
  return Call(static_cast<Client*>(h), kSspRegister, worker, nullptr, 0, 0, 0,
              nullptr, nullptr);
}

int coord_ssp_report(void* h, const char* worker, int64_t step) {
  return Call(static_cast<Client*>(h), kSspReport, worker, nullptr, 0, step, 0,
              nullptr, nullptr);
}

int coord_ssp_wait(void* h, int64_t step, int64_t staleness) {
  return Call(static_cast<Client*>(h), kSspWait, "", nullptr, 0, step,
              staleness, nullptr, nullptr);
}

void coord_free(void* p) { std::free(p); }

}  // extern "C"
