// http_front.cpp — native HTTP serving front end (the C++ runtime layer).
// The port's copy of tpu_cnn/native/http_front.cpp
// (tpu_cnn_torch.apps.serve_native).
//
// Role: the Python HTTP stack (ThreadingHTTPServer) caps a real deployment
// well below device throughput; this front end accepts detect requests in
// C++ — socket accept, HTTP parse, body read, response write all happen
// off the GIL — and hands the ENGINE only what it must do in Python: one
// ctypes call that drains a batch of pending requests and one that posts
// the JSON results. Thread-per-connection (the service's concurrency is
// bounded by the relay/engine, not connection count), bounded queue with
// 503 push-back, per-ticket response rendezvous, request timeout -> 504.
//
//   POST /detect   body = raw img_bytes uint8 frame  -> 200 JSON
//   GET  /healthz  -> 200 JSON {pending, served}
//   GET  /stats    -> 200 JSON {pending, served, live_conns, p50_ms,
//                    p99_ms} — per-request enqueue->response latency
//                    percentiles over the last 4096 requests (the same
//                    window the Python front's /stats reports, so the
//                    load harness compares like for like)
//
// Build: compiled into the host library tcnn_host with the oracle
// (tpu_cnn_torch/ops/_build.py, build_host).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Pending {
  uint64_t ticket;
  std::vector<uint8_t> body;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  int img_bytes = 0;
  int queue_cap = 0;
  std::atomic<bool> stop{false};
  std::thread acceptor;

  std::mutex mu;
  std::condition_variable cv_req;   // worker waits for requests
  std::condition_variable cv_resp;  // connections wait for their response
  std::deque<Pending> queue;
  std::unordered_map<uint64_t, std::string> responses;
  // (ticket, post time) in post order — unclaimed responses (client died
  // before its result arrived) are purged after RESP_TTL so the map stays
  // bounded in a long-running service
  std::deque<std::pair<uint64_t, std::chrono::steady_clock::time_point>>
      resp_log;
  uint64_t next_ticket = 1;
  uint64_t served = 0;
  std::atomic<int> live_conns{0};
  // enqueue->response latency ring (ms), last 4096 served requests
  static constexpr int kLatCap = 4096;
  double lat_ring[kLatCap];
  int lat_n = 0;
  int lat_idx = 0;
};

constexpr auto RESP_TTL = std::chrono::seconds(60);

void purge_stale_responses(Server* s) {  // caller holds s->mu
  const auto now = std::chrono::steady_clock::now();
  while (!s->resp_log.empty() && now - s->resp_log.front().second > RESP_TTL) {
    s->responses.erase(s->resp_log.front().first);  // no-op if claimed
    s->resp_log.pop_front();
  }
}

bool read_n(int fd, uint8_t* dst, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::read(fd, dst + got, n - got);
    if (r <= 0) return false;
    got += (size_t)r;
  }
  return true;
}

void write_all(int fd, const std::string& s) {
  size_t off = 0;
  while (off < s.size()) {
    ssize_t w = ::write(fd, s.data() + off, s.size() - off);
    if (w <= 0) return;
    off += (size_t)w;
  }
}

void reply(int fd, int code, const char* status, const std::string& body) {
  char hdr[256];
  std::snprintf(hdr, sizeof(hdr),
                "HTTP/1.1 %d %s\r\nContent-Type: application/json\r\n"
                "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                code, status, body.size());
  write_all(fd, std::string(hdr) + body);
}

// Read the request head (start line + headers) byte-wise up to a cap.
bool read_head(int fd, std::string& head) {
  char c;
  while (head.size() < 8192) {
    ssize_t r = ::read(fd, &c, 1);
    if (r <= 0) return false;
    head.push_back(c);
    if (head.size() >= 4 && head.compare(head.size() - 4, 4, "\r\n\r\n") == 0)
      return true;
  }
  return false;
}

void handle_conn(Server* s, int fd) {
  std::string head;
  if (!read_head(fd, head)) {
    ::close(fd);
    return;
  }
  const bool is_detect = head.rfind("POST /detect", 0) == 0;
  const bool is_health = head.rfind("GET /healthz", 0) == 0;
  const bool is_stats = head.rfind("GET /stats", 0) == 0;
  if (is_stats) {
    uint64_t pend, served;
    double p50 = 0.0, p99 = 0.0;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      pend = s->queue.size();
      served = s->served;
      if (s->lat_n > 0) {
        std::vector<double> lats(s->lat_ring, s->lat_ring + s->lat_n);
        auto mid = lats.begin() + lats.size() / 2;
        std::nth_element(lats.begin(), mid, lats.end());
        p50 = *mid;
        auto hi = lats.begin() +
                  std::min(lats.size() - 1, (size_t)(lats.size() * 0.99));
        std::nth_element(lats.begin(), hi, lats.end());
        p99 = *hi;
      }
    }
    char buf[256];
    std::snprintf(buf, sizeof(buf),
                  "{\"pending\":%llu,\"served\":%llu,\"live_conns\":%d,"
                  "\"p50_ms\":%.3f,\"p99_ms\":%.3f}",
                  (unsigned long long)pend, (unsigned long long)served,
                  s->live_conns.load(), p50, p99);
    reply(fd, 200, "OK", buf);
    ::close(fd);
    return;
  }
  if (is_health) {
    uint64_t pend, served;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      pend = s->queue.size();
      served = s->served;
    }
    reply(fd, 200, "OK",
          "{\"status\":\"ok\",\"pending\":" + std::to_string(pend) +
              ",\"served\":" + std::to_string(served) + "}");
    ::close(fd);
    return;
  }
  if (!is_detect) {
    reply(fd, 404, "Not Found", "{\"error\":\"not found\"}");
    ::close(fd);
    return;
  }
  // Content-Length (case-insensitive scan)
  long clen = -1;
  {
    std::string low;
    low.reserve(head.size());
    for (char ch : head) low.push_back((char)tolower((unsigned char)ch));
    auto p = low.find("content-length:");
    if (p != std::string::npos) clen = atol(low.c_str() + p + 15);
  }
  if (clen != (long)s->img_bytes) {
    reply(fd, clen > (long)s->img_bytes ? 413 : 400,
          clen > (long)s->img_bytes ? "Payload Too Large" : "Bad Request",
          "{\"error\":\"body must be exactly " +
              std::to_string(s->img_bytes) + " raw uint8 bytes\"}");
    ::close(fd);
    return;
  }
  Pending p;
  p.body.resize(s->img_bytes);
  if (!read_n(fd, p.body.data(), p.body.size())) {
    ::close(fd);
    return;
  }
  uint64_t ticket;
  const auto t_in = std::chrono::steady_clock::now();
  {
    std::unique_lock<std::mutex> lk(s->mu);
    if ((int)s->queue.size() >= s->queue_cap) {
      lk.unlock();
      reply(fd, 503, "Service Unavailable",
            "{\"error\":\"queue full, retry\"}");
      ::close(fd);
      return;
    }
    ticket = p.ticket = s->next_ticket++;
    s->queue.push_back(std::move(p));
  }
  s->cv_req.notify_one();
  // rendezvous: wait for the engine worker's response for this ticket
  std::string body;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    bool ok = s->cv_resp.wait_for(
        lk, std::chrono::seconds(30), [&] {
          return s->stop.load() || s->responses.count(ticket) > 0;
        });
    auto it = s->responses.find(ticket);
    if (ok && it != s->responses.end()) {
      body = std::move(it->second);
      s->responses.erase(it);
      ++s->served;
      const double ms =
          std::chrono::duration<double, std::milli>(
              std::chrono::steady_clock::now() - t_in)
              .count();
      s->lat_ring[s->lat_idx] = ms;  // /stats percentile window
      s->lat_idx = (s->lat_idx + 1) % Server::kLatCap;
      if (s->lat_n < Server::kLatCap) ++s->lat_n;
    }
  }
  if (body.empty())
    reply(fd, 504, "Gateway Timeout", "{\"error\":\"engine timeout\"}");
  else
    reply(fd, 200, "OK", body);
  ::close(fd);
}

void accept_loop(Server* s) {
  while (!s->stop.load()) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stop.load()) break;
      continue;
    }
    s->live_conns.fetch_add(1);
    std::thread([s, fd] {
      handle_conn(s, fd);
      s->live_conns.fetch_sub(1);
    }).detach();
  }
}

}  // namespace

extern "C" {

// Start on host:port (port 0 = ephemeral). Returns handle or null.
void* tcnn_http_start(const char* host, int port, int img_bytes,
                      int queue_cap) {
  if (img_bytes <= 0 || queue_cap <= 0) return nullptr;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, (sockaddr*)&addr, &alen);

  auto* s = new Server();
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  s->img_bytes = img_bytes;
  s->queue_cap = queue_cap;
  s->acceptor = std::thread(accept_loop, s);
  return s;
}

int tcnn_http_port(void* h) { return h ? ((Server*)h)->port : -1; }

// Engine worker: block up to timeout_s for pending requests, then copy up
// to max_n frames into images (max_n x img_bytes) + their tickets.
// Returns the count taken (0 on timeout/stop).
int tcnn_http_take(void* h, uint8_t* images, uint64_t* tickets, int max_n,
                   double timeout_s) {
  auto* s = (Server*)h;
  if (!s || max_n <= 0) return 0;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_req.wait_for(lk, std::chrono::duration<double>(timeout_s),
                     [&] { return s->stop.load() || !s->queue.empty(); });
  int n = 0;
  while (n < max_n && !s->queue.empty()) {
    Pending& p = s->queue.front();
    std::memcpy(images + (size_t)n * s->img_bytes, p.body.data(),
                s->img_bytes);
    tickets[n] = p.ticket;
    s->queue.pop_front();
    ++n;
  }
  return n;
}

// Engine worker: post the JSON response for a ticket (wakes its connection).
void tcnn_http_respond(void* h, uint64_t ticket, const char* json, int len) {
  auto* s = (Server*)h;
  if (!s || !json || len <= 0) return;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    purge_stale_responses(s);
    s->responses.emplace(ticket, std::string(json, (size_t)len));
    s->resp_log.emplace_back(ticket, std::chrono::steady_clock::now());
  }
  s->cv_resp.notify_all();
}

uint64_t tcnn_http_served(void* h) {
  auto* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  return s->served;
}

void tcnn_http_stop(void* h) {
  auto* s = (Server*)h;
  if (!s) return;
  s->stop.store(true);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  s->cv_req.notify_all();
  s->cv_resp.notify_all();
  if (s->acceptor.joinable()) s->acceptor.join();
  // wait for detached connection threads to drain before freeing (their
  // response waits wake on the stop flag; bound the wait regardless)
  for (int i = 0; i < 2000 && s->live_conns.load() > 0; ++i) {
    s->cv_resp.notify_all();
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
  delete s;
}

}  // extern "C"
