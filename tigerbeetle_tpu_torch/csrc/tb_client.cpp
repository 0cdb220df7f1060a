// tb_client: thread-safe C-ABI cluster client with an internal IO thread.
//
// A copy of the JAX package's native/tb_client.cpp, for the port: built by
// tigerbeetle_tpu_torch/native.py `load_client` and bound by
// clients/c_client.py. Host code only; it touches no device.
//
// The native client runtime every language binding shares (the reference's
// equivalent is src/clients/c/tb_client.zig + tb_client/context.zig: a
// packet queue drained by one IO thread running the VSR client). Packets
// are submitted from any thread; the IO thread frames them as `request`
// messages (256-byte checksummed header, tigerbeetle_tpu_torch/vsr/header.py
// layout), sends to every replica (only the primary acts; the weak
// delivery contract tolerates the rest), resends on a timer, and completes
// packets when a matching `reply` arrives. One request in flight at a time
// (the reference serializes per-client requests the same way).
//
// Echo mode (reference: tb_client.zig init_echo) loops request bodies back
// without a network, for binding tests.

#include "blake2b.h"

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <pthread.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

// ------------------------------------------------------- header framing

const size_t HDR_SIZE = 256;
const uint8_t CMD_REQUEST = 5;
const uint8_t CMD_REPLY = 8;
const uint32_t SIZE_MAX_FRAME = 64u * 1024u * 1024u;

// Offsets per tigerbeetle_tpu_torch/vsr/header.py _FMT.
const size_t OFF_CSUM = 0;
const size_t OFF_CSUM_BODY = 16;
const size_t OFF_CLIENT = 48;
const size_t OFF_CLUSTER = 80;
const size_t OFF_SIZE = 88;
const size_t OFF_REQUEST = 128;
const size_t OFF_OPERATION = 136;
const size_t OFF_COMMAND = 138;

const char HDR_KEY[] = "tigerbeetle-tpu-checksumhdr";
const char BODY_KEY[] = "tigerbeetle-tpu-checksumbody";

void wr_u64(uint8_t *p, uint64_t v) { memcpy(p, &v, 8); }
void wr_u32(uint8_t *p, uint32_t v) { memcpy(p, &v, 4); }
void wr_u16(uint8_t *p, uint16_t v) { memcpy(p, &v, 2); }
uint64_t rd_u64(const uint8_t *p) { uint64_t v; memcpy(&v, p, 8); return v; }
uint32_t rd_u32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }

void header_seal(uint8_t *hdr, const uint8_t *body, uint32_t body_len) {
  wr_u32(hdr + OFF_SIZE, (uint32_t)(HDR_SIZE + body_len));
  tbp::checksum16(body, body_len, (const uint8_t *)BODY_KEY,
                  sizeof(BODY_KEY) - 1, hdr + OFF_CSUM_BODY);
  tbp::checksum16(hdr + 16, HDR_SIZE - 16, (const uint8_t *)HDR_KEY,
                  sizeof(HDR_KEY) - 1, hdr + OFF_CSUM);
}

bool header_valid(const uint8_t *hdr) {
  uint8_t digest[16];
  tbp::checksum16(hdr + 16, HDR_SIZE - 16, (const uint8_t *)HDR_KEY,
                  sizeof(HDR_KEY) - 1, digest);
  return memcmp(digest, hdr + OFF_CSUM, 16) == 0;
}

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000 + (uint64_t)(ts.tv_nsec / 1000000);
}

}  // namespace

extern "C" {

// ------------------------------------------------------------ public ABI

enum tbp_packet_status : uint8_t {
  TBP_PACKET_PENDING = 0,
  TBP_PACKET_OK = 1,
  TBP_PACKET_CLIENT_SHUTDOWN = 2,
  TBP_PACKET_INVALID = 3,
};

struct tbp_packet {
  struct tbp_packet *next;  // internal queue linkage; caller must zero
  void *user_data;          // opaque, returned in completions
  uint16_t operation;
  uint8_t status;           // tbp_packet_status, written at completion
  uint8_t reserved;
  uint32_t data_size;
  const uint8_t *data;      // request body (already operation-encoded)
  uint8_t *reply;           // malloc'd by the client; caller frees
  uint32_t reply_size;
};

typedef void (*tbp_completion_t)(void *ctx, struct tbp_packet *packet);

struct tbp_client;

}  // extern "C" (struct/typedef only; functions re-enter below)

namespace {

struct Conn {
  int fd = -1;
  bool connecting = false;
  std::vector<uint8_t> rx;
  std::vector<uint8_t> tx;
  size_t tx_off = 0;
};

}  // namespace

extern "C" {

struct tbp_client {
  uint64_t cluster;
  uint8_t client_id[16];
  bool echo;
  std::vector<sockaddr_in> addrs;
  std::vector<Conn> conns;

  pthread_mutex_t mu;
  pthread_cond_t cv;
  pthread_t thread;
  bool shutdown;
  int wake_pipe[2];

  tbp_packet *queue_head;
  tbp_packet *queue_tail;
  tbp_packet *inflight;
  uint32_t request_number;
  uint64_t last_send_ms;
  std::vector<uint8_t> frame;  // current request frame (header + body)

  tbp_completion_t on_completion;
  void *completion_ctx;
};

}  // extern "C"

namespace {

void conn_reset(Conn &c) {
  if (c.fd >= 0) close(c.fd);
  c.fd = -1;
  c.connecting = false;
  c.rx.clear();
  c.tx.clear();
  c.tx_off = 0;
}

void conn_dial(Conn &c, const sockaddr_in &addr) {
  conn_reset(c);
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return;
  fcntl(fd, F_SETFL, O_NONBLOCK);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int rc = connect(fd, (const sockaddr *)&addr, sizeof(addr));
  if (rc != 0 && errno != EINPROGRESS) {
    close(fd);
    return;
  }
  c.fd = fd;
  c.connecting = (rc != 0);
}

void conn_enqueue(Conn &c, const std::vector<uint8_t> &frame) {
  if (c.fd < 0) return;
  if (c.tx.size() - c.tx_off > SIZE_MAX_FRAME) return;  // backpressure: drop
  if (c.tx_off > 0 && c.tx_off == c.tx.size()) {
    c.tx.clear();
    c.tx_off = 0;
  }
  c.tx.insert(c.tx.end(), frame.begin(), frame.end());
}

void conn_flush(Conn &c) {
  while (c.fd >= 0 && c.tx_off < c.tx.size()) {
    ssize_t n = send(c.fd, c.tx.data() + c.tx_off, c.tx.size() - c.tx_off,
                     MSG_NOSIGNAL);
    if (n > 0) {
      c.tx_off += (size_t)n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
    conn_reset(c);  // error: weak delivery contract, reconnect on resend
    return;
  }
  if (c.tx_off == c.tx.size()) {
    c.tx.clear();
    c.tx_off = 0;
  }
}

void complete_packet(tbp_client *c, tbp_packet *p, uint8_t status,
                     const uint8_t *reply, uint32_t reply_size) {
  p->reply = nullptr;
  p->reply_size = 0;
  if (status == TBP_PACKET_OK && reply_size > 0) {
    p->reply = (uint8_t *)malloc(reply_size);
    memcpy(p->reply, reply, reply_size);
    p->reply_size = reply_size;
  }
  pthread_mutex_lock(&c->mu);
  p->status = status;  // last write: wait() reads it under mu
  pthread_cond_broadcast(&c->cv);
  pthread_mutex_unlock(&c->mu);
  if (c->on_completion) c->on_completion(c->completion_ctx, p);
}

void build_frame(tbp_client *c, tbp_packet *p) {
  c->request_number++;
  c->frame.assign(HDR_SIZE + p->data_size, 0);
  uint8_t *hdr = c->frame.data();
  memcpy(hdr + OFF_CLIENT, c->client_id, 16);
  wr_u64(hdr + OFF_CLUSTER, c->cluster);
  wr_u32(hdr + OFF_REQUEST, c->request_number);
  wr_u16(hdr + OFF_OPERATION, p->operation);
  hdr[OFF_COMMAND] = CMD_REQUEST;
  if (p->data_size) memcpy(hdr + HDR_SIZE, p->data, p->data_size);
  header_seal(hdr, hdr + HDR_SIZE, p->data_size);
}

// Returns true when the in-flight request completed.
bool conn_drain(tbp_client *c, Conn &conn) {
  for (;;) {
    uint8_t buf[256 * 1024];
    ssize_t n = recv(conn.fd, buf, sizeof(buf), 0);
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    if (n <= 0) {
      conn_reset(conn);
      return false;
    }
    conn.rx.insert(conn.rx.end(), buf, buf + n);
    while (conn.rx.size() >= HDR_SIZE) {
      const uint8_t *hdr = conn.rx.data();
      if (!header_valid(hdr)) {
        conn_reset(conn);  // corrupt stream: force reconnect
        return false;
      }
      uint32_t size = rd_u32(hdr + OFF_SIZE);
      if (size < HDR_SIZE || size > SIZE_MAX_FRAME) {
        conn_reset(conn);
        return false;
      }
      if (conn.rx.size() < size) break;
      uint8_t body_digest[16];
      tbp::checksum16(hdr + HDR_SIZE, size - HDR_SIZE,
                      (const uint8_t *)BODY_KEY, sizeof(BODY_KEY) - 1,
                      body_digest);
      bool body_ok = memcmp(body_digest, hdr + OFF_CSUM_BODY, 16) == 0;
      bool match = body_ok && hdr[OFF_COMMAND] == CMD_REPLY &&
                   rd_u64(hdr + OFF_CLUSTER) == c->cluster &&
                   memcmp(hdr + OFF_CLIENT, c->client_id, 16) == 0 &&
                   rd_u32(hdr + OFF_REQUEST) == c->request_number &&
                   c->inflight != nullptr;
      if (match) {
        tbp_packet *p = c->inflight;
        c->inflight = nullptr;
        complete_packet(c, p, TBP_PACKET_OK, hdr + HDR_SIZE,
                        size - HDR_SIZE);
        conn.rx.erase(conn.rx.begin(), conn.rx.begin() + size);
        return true;
      }
      conn.rx.erase(conn.rx.begin(), conn.rx.begin() + size);
    }
  }
  return false;
}

const uint64_t RESEND_MS = 500;

void *io_thread(void *arg) {
  tbp_client *c = (tbp_client *)arg;
  for (;;) {
    pthread_mutex_lock(&c->mu);
    bool shutdown = c->shutdown;
    if (!c->inflight && c->queue_head) {
      c->inflight = c->queue_head;
      c->queue_head = c->queue_head->next;
      if (!c->queue_head) c->queue_tail = nullptr;
      c->inflight->next = nullptr;
    }
    tbp_packet *p = c->inflight;
    pthread_mutex_unlock(&c->mu);

    if (shutdown) break;

    if (p && p->status == TBP_PACKET_PENDING && c->frame.empty()) {
      if (c->echo) {
        c->inflight = nullptr;
        complete_packet(c, p, TBP_PACKET_OK, p->data, p->data_size);
        continue;
      }
      build_frame(c, p);
      c->last_send_ms = 0;  // send immediately below
    }

    if (c->inflight && !c->frame.empty()) {
      uint64_t now = now_ms();
      if (now - c->last_send_ms >= RESEND_MS) {
        c->last_send_ms = now;
        for (size_t i = 0; i < c->conns.size(); i++) {
          if (c->conns[i].fd < 0) conn_dial(c->conns[i], c->addrs[i]);
          conn_enqueue(c->conns[i], c->frame);
        }
      }
    }

    // Poll: wake pipe + all sockets.
    std::vector<pollfd> fds;
    fds.push_back({c->wake_pipe[0], POLLIN, 0});
    for (Conn &conn : c->conns) {
      if (conn.fd < 0) continue;
      short ev = POLLIN;
      if (conn.connecting || conn.tx_off < conn.tx.size()) ev |= POLLOUT;
      fds.push_back({conn.fd, ev, 0});
    }
    poll(fds.data(), (nfds_t)fds.size(), 50);

    if (fds[0].revents & POLLIN) {
      uint8_t drain[64];
      while (read(c->wake_pipe[0], drain, sizeof(drain)) > 0) {}
    }
    size_t fi = 1;
    bool completed = false;
    for (Conn &conn : c->conns) {
      if (conn.fd < 0) continue;
      short re = fds[fi++].revents;
      if (re & (POLLERR | POLLHUP)) {
        conn_reset(conn);
        continue;
      }
      if (re & POLLOUT) {
        conn.connecting = false;
        conn_flush(conn);
      }
      if ((re & POLLIN) && !completed) completed = conn_drain(c, conn);
    }
    if (completed) c->frame.clear();
  }

  // Shutdown: fail everything still queued or in flight.
  pthread_mutex_lock(&c->mu);
  tbp_packet *p = c->inflight;
  c->inflight = nullptr;
  tbp_packet *q = c->queue_head;
  c->queue_head = c->queue_tail = nullptr;
  pthread_mutex_unlock(&c->mu);
  if (p) complete_packet(c, p, TBP_PACKET_CLIENT_SHUTDOWN, nullptr, 0);
  while (q) {
    tbp_packet *next = q->next;
    complete_packet(c, q, TBP_PACKET_CLIENT_SHUTDOWN, nullptr, 0);
    q = next;
  }
  for (Conn &conn : c->conns) conn_reset(conn);
  return nullptr;
}

// addresses: "host:port,host:port,...". Returns false on parse failure.
bool parse_addresses(const char *s, std::vector<sockaddr_in> *out) {
  std::string all(s ? s : "");
  size_t pos = 0;
  while (pos < all.size()) {
    size_t comma = all.find(',', pos);
    if (comma == std::string::npos) comma = all.size();
    std::string part = all.substr(pos, comma - pos);
    pos = comma + 1;
    size_t colon = part.rfind(':');
    if (colon == std::string::npos) return false;
    sockaddr_in addr;
    memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)atoi(part.c_str() + colon + 1));
    std::string host = part.substr(0, colon);
    if (host == "localhost") host = "127.0.0.1";
    if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) return false;
    out->push_back(addr);
  }
  return !out->empty();
}

tbp_client *client_new(uint64_t cluster, const uint8_t client_id[16],
                       bool echo) {
  tbp_client *c = new tbp_client();
  c->cluster = cluster;
  memcpy(c->client_id, client_id, 16);
  c->echo = echo;
  c->shutdown = false;
  c->queue_head = c->queue_tail = nullptr;
  c->inflight = nullptr;
  c->request_number = 0;
  c->last_send_ms = 0;
  c->on_completion = nullptr;
  c->completion_ctx = nullptr;
  pthread_mutex_init(&c->mu, nullptr);
  // Monotonic condvar clock: wall-clock steps must not skew wait deadlines.
  pthread_condattr_t attr;
  pthread_condattr_init(&attr);
  pthread_condattr_setclock(&attr, CLOCK_MONOTONIC);
  pthread_cond_init(&c->cv, &attr);
  pthread_condattr_destroy(&attr);
  if (pipe(c->wake_pipe) != 0) {
    delete c;
    return nullptr;
  }
  fcntl(c->wake_pipe[0], F_SETFL, O_NONBLOCK);
  fcntl(c->wake_pipe[1], F_SETFL, O_NONBLOCK);
  return c;
}

bool client_start(tbp_client *c, tbp_completion_t on_completion, void *ctx) {
  c->on_completion = on_completion;
  c->completion_ctx = ctx;
  c->conns.resize(c->addrs.size());
  return pthread_create(&c->thread, nullptr, io_thread, c) == 0;
}

void client_free(tbp_client *c) {
  close(c->wake_pipe[0]);
  close(c->wake_pipe[1]);
  pthread_mutex_destroy(&c->mu);
  pthread_cond_destroy(&c->cv);
  delete c;
}

}  // namespace

extern "C" {

int tbp_client_init(tbp_client **out, uint64_t cluster,
                    const uint8_t client_id[16], const char *addresses,
                    tbp_completion_t on_completion, void *ctx) {
  tbp_client *c = client_new(cluster, client_id, false);
  if (!c) return -1;
  if (!parse_addresses(addresses, &c->addrs)) {
    client_free(c);
    return -2;
  }
  if (!client_start(c, on_completion, ctx)) {
    client_free(c);
    return -3;
  }
  *out = c;
  return 0;
}

// Echo client: completes every packet with its own request body, no
// network (reference: tb_client init_echo — binding test harness).
int tbp_client_init_echo(tbp_client **out, uint64_t cluster,
                         const uint8_t client_id[16],
                         tbp_completion_t on_completion, void *ctx) {
  tbp_client *c = client_new(cluster, client_id, true);
  if (!c) return -1;
  if (!client_start(c, on_completion, ctx)) {
    client_free(c);
    return -3;
  }
  *out = c;
  return 0;
}

void tbp_client_submit(tbp_client *c, tbp_packet *p) {
  p->next = nullptr;
  p->status = TBP_PACKET_PENDING;
  p->reply = nullptr;
  p->reply_size = 0;
  pthread_mutex_lock(&c->mu);
  if (c->queue_tail) {
    c->queue_tail->next = p;
  } else {
    c->queue_head = p;
  }
  c->queue_tail = p;
  pthread_mutex_unlock(&c->mu);
  uint8_t one = 1;
  ssize_t n = write(c->wake_pipe[1], &one, 1);
  (void)n;
}

// Blocks until the packet completes; returns its status, or
// TBP_PACKET_PENDING (0) on timeout.
uint8_t tbp_client_wait(tbp_client *c, tbp_packet *p, uint32_t timeout_ms) {
  struct timespec deadline;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  deadline.tv_sec += timeout_ms / 1000;
  deadline.tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
  if (deadline.tv_nsec >= 1000000000L) {
    deadline.tv_sec += 1;
    deadline.tv_nsec -= 1000000000L;
  }
  pthread_mutex_lock(&c->mu);
  while (p->status == TBP_PACKET_PENDING) {
    if (pthread_cond_timedwait(&c->cv, &c->mu, &deadline) == ETIMEDOUT) break;
  }
  uint8_t status = p->status;
  pthread_mutex_unlock(&c->mu);
  return status;
}

void tbp_client_packet_free(tbp_packet *p) {
  if (p->reply) {
    free(p->reply);
    p->reply = nullptr;
    p->reply_size = 0;
  }
}

void tbp_client_deinit(tbp_client *c) {
  pthread_mutex_lock(&c->mu);
  c->shutdown = true;
  pthread_mutex_unlock(&c->mu);
  uint8_t one = 1;
  ssize_t n = write(c->wake_pipe[1], &one, 1);
  (void)n;
  pthread_join(c->thread, nullptr);
  client_free(c);
}

}  // extern "C"
