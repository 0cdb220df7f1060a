// Native storage engine: zoned data-file IO, checksums, WAL recovery scan.
//
// A copy of the JAX package's native/storage_engine.cpp, for the port
// (the reference's equivalent layer is src/storage.zig +
// src/vsr/journal.zig recovery over io_uring). Exposed as a C ABI consumed
// via ctypes (tigerbeetle_tpu_torch/native.py). Single-threaded, synchronous pread/pwrite —
// the replica event loop is single-threaded by design.
//
// BLAKE2b implemented from RFC 7693 (keyed mode), producing digests
// identical to Python's hashlib.blake2b(data, digest_size=16, key=...):
// the wire/disk checksum contract is shared across both runtimes.

#include "blake2b.h"

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ------------------------------------------------------------- BLAKE2b
// Implementation shared with tb_client.cpp via blake2b.h.

void tbs_checksum(const uint8_t *data, uint64_t len, const uint8_t *key,
                  uint64_t key_len, uint8_t *out16) {
  tbp::checksum16(data, (size_t)len, key, (size_t)key_len, out16);
}

// --------------------------------------------------------------- file io

int tbs_open(const char *path, uint64_t size, int create) {
  int flags = O_RDWR | (create ? O_CREAT : 0);
  int fd = open(path, flags, 0644);
  if (fd < 0) return -1;
  if (create && ftruncate(fd, (off_t)size) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int tbs_close(int fd) { return close(fd); }

int64_t tbs_read(int fd, uint64_t off, uint8_t *buf, uint64_t len) {
  uint64_t done = 0;
  while (done < len) {
    ssize_t n = pread(fd, buf + done, len - done, (off_t)(off + done));
    if (n < 0) return -1;
    if (n == 0) {
      memset(buf + done, 0, len - done);
      return (int64_t)len;
    }
    done += (uint64_t)n;
  }
  return (int64_t)done;
}

int64_t tbs_write(int fd, uint64_t off, const uint8_t *buf, uint64_t len) {
  uint64_t done = 0;
  while (done < len) {
    ssize_t n = pwrite(fd, buf + done, len - done, (off_t)(off + done));
    if (n < 0) return -1;
    done += (uint64_t)n;
  }
  return (int64_t)done;
}

int tbs_sync(int fd) { return fsync(fd); }

// ------------------------------------------------------------- WAL scan

// Header layout offsets (tigerbeetle_tpu_torch/vsr/header.py).
static const uint64_t HDR_SIZE = 256;
static const uint64_t OFF_CSUM_BODY = 16;
static const uint64_t OFF_SIZE = 88;
static const uint64_t OFF_OP = 104;
static const uint64_t OFF_COMMAND = 138;
// The reserved region, where the trace context rides: the header checksum
// covers it zeroed (vsr/header.py `_packed_tail`).
static const uint64_t OFF_RESERVED = 140;
static const uint8_t CMD_PREPARE = 6;
static const uint8_t CMD_RESERVED = 0;

static uint64_t rd_u64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static uint32_t rd_u32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static int header_valid(const uint8_t *hdr, const uint8_t *hdr_key,
                        uint64_t hdr_key_len) {
  uint8_t digest[16];
  uint8_t tail[HDR_SIZE - 16];
  memcpy(tail, hdr + 16, OFF_RESERVED - 16);
  memset(tail + (OFF_RESERVED - 16), 0, HDR_SIZE - OFF_RESERVED);
  tbs_checksum(tail, HDR_SIZE - 16, hdr_key, hdr_key_len, digest);
  // Accept prepare AND reserved commands: replica format writes valid
  // RESERVED headers into every slot so recovery can tell formatted-empty
  // (nack-eligible) from torn (must abstain); see vsr/journal.py.
  return memcmp(digest, hdr, 16) == 0 &&
         (hdr[OFF_COMMAND] == CMD_PREPARE ||
          hdr[OFF_COMMAND] == CMD_RESERVED);
}

// Scan the WAL rings and classify every slot.
// states_out[i]: 0 = clean, 1 = faulty (header known), 2 = unknown.
// headers_out: slot_count * 256 bytes (the adopted header for clean/faulty).
// scratch must hold prepare_size_max bytes.
int tbs_wal_scan(int fd, uint64_t hdr_zone_off, uint64_t prep_zone_off,
                 uint32_t slot_count, uint64_t prepare_size_max,
                 const uint8_t *hdr_key, uint64_t hdr_key_len,
                 const uint8_t *body_key, uint64_t body_key_len,
                 uint8_t *headers_out, uint8_t *states_out,
                 uint8_t *scratch) {
  for (uint32_t slot = 0; slot < slot_count; slot++) {
    uint8_t ring_hdr[256];
    if (tbs_read(fd, hdr_zone_off + (uint64_t)slot * HDR_SIZE, ring_hdr,
                 HDR_SIZE) < 0)
      return -1;
    int ring_ok = header_valid(ring_hdr, hdr_key, hdr_key_len);

    uint64_t prep_off = prep_zone_off + (uint64_t)slot * prepare_size_max;
    if (tbs_read(fd, prep_off, scratch, HDR_SIZE) < 0) return -1;
    int prep_hdr_ok = header_valid(scratch, hdr_key, hdr_key_len) &&
                      scratch[OFF_COMMAND] == CMD_PREPARE;
    int prep_ok = 0;
    if (prep_hdr_ok) {
      uint32_t size = rd_u32(scratch + OFF_SIZE);
      // Protocol bound: header + body <= message_size_max == slot stride
      // (mirrors vsr/journal.py append/recover).
      if (size >= HDR_SIZE && size <= prepare_size_max) {
        if (tbs_read(fd, prep_off + HDR_SIZE, scratch + HDR_SIZE,
                     size - HDR_SIZE) < 0)
          return -1;
        uint8_t digest[16];
        tbs_checksum(scratch + HDR_SIZE, size - HDR_SIZE, body_key,
                     body_key_len, digest);
        prep_ok = memcmp(digest, scratch + OFF_CSUM_BODY, 16) == 0;
      }
    }

    int ring_prepare = ring_ok && ring_hdr[OFF_COMMAND] == CMD_PREPARE;
    int ring_reserved = ring_ok && ring_hdr[OFF_COMMAND] == CMD_RESERVED;
    uint8_t *out_hdr = headers_out + (uint64_t)slot * HDR_SIZE;
    if (ring_prepare && prep_ok && memcmp(scratch, ring_hdr, 16) == 0) {
      states_out[slot] = 0;
      memcpy(out_hdr, ring_hdr, HDR_SIZE);
    } else if (prep_ok && ring_prepare &&
               rd_u64(scratch + OFF_OP) > rd_u64(ring_hdr + OFF_OP)) {
      states_out[slot] = 0;
      memcpy(out_hdr, scratch, HDR_SIZE);
    } else if (prep_ok && !ring_prepare) {
      // Ring header torn, absent, or still the formatted reserved one
      // (crash between prepare-body and header write): the prepare wins.
      states_out[slot] = 0;
      memcpy(out_hdr, scratch, HDR_SIZE);
    } else if (ring_prepare) {
      states_out[slot] = 1;
      memcpy(out_hdr, ring_hdr, HDR_SIZE);
    } else if (ring_reserved) {
      // Formatted-empty: provably never prepared -> clean, nack-eligible.
      states_out[slot] = 3;
      memset(out_hdr, 0, HDR_SIZE);
    } else {
      states_out[slot] = 2;
      memset(out_hdr, 0, HDR_SIZE);
    }
  }
  return 0;
}

// Append one prepare: body first, then the redundant header (write
// ordering is the torn-write defense; see vsr/journal.py).
int tbs_wal_append(int fd, uint64_t hdr_zone_off, uint64_t prep_zone_off,
                   uint32_t slot, uint64_t prepare_size_max,
                   const uint8_t *msg, uint64_t msg_len) {
  if (msg_len < HDR_SIZE || msg_len > prepare_size_max) return -1;
  if (tbs_write(fd, prep_zone_off + (uint64_t)slot * prepare_size_max, msg,
                msg_len) < 0)
    return -1;
  if (tbs_write(fd, hdr_zone_off + (uint64_t)slot * HDR_SIZE, msg,
                HDR_SIZE) < 0)
    return -1;
  return 0;
}

}  // extern "C"

// ===================================================== async IO engine
//
// The submission/completion engine under the event loop (reference:
// src/io/linux.zig io_uring submission — same contract, thread-pool
// backed here: submit read/write, poll completions, drain as the
// checkpoint barrier). Lock-based MPSC queues; worker threads execute
// pread/pwrite against the data file.

#include <pthread.h>

#include <deque>
#include <map>
#include <vector>

extern "C" {

struct tbio_op {
  uint64_t id;
  int is_write;
  int tracked;  // write whose completion the caller reaps via tbio_fetch
  uint64_t off;
  std::vector<uint8_t> buf;  // write payload, or read destination
  // Optional second ordered write (the WAL prepare->header pair: the
  // redundant header must hit the disk strictly AFTER its prepare body,
  // or torn-write recovery misclassifies the slot).
  uint64_t off2;
  std::vector<uint8_t> buf2;
  int64_t result;
};

struct tbio {
  int fd;
  pthread_mutex_t mu;
  pthread_cond_t cv_submit;   // workers wait for submissions
  pthread_cond_t cv_complete; // drain/fetch wait for completions
  std::deque<tbio_op *> submitted;
  std::map<uint64_t, tbio_op *> completed;  // READ completions only
  std::map<uint64_t, int> live;             // read ids not yet fetched
  uint64_t next_id;
  uint64_t inflight;
  bool failed;  // STICKY: any write ever failed (checked by every drain)
  bool shutdown;
  std::vector<pthread_t> workers;
};

}  // extern "C"

namespace {

void *tbio_worker(void *arg) {
  tbio *e = static_cast<tbio *>(arg);
  pthread_mutex_lock(&e->mu);
  for (;;) {
    while (e->submitted.empty() && !e->shutdown)
      pthread_cond_wait(&e->cv_submit, &e->mu);
    if (e->shutdown && e->submitted.empty()) break;
    tbio_op *op = e->submitted.front();
    e->submitted.pop_front();
    pthread_mutex_unlock(&e->mu);
    if (op->is_write) {
      op->result = tbs_write(e->fd, op->off, op->buf.data(), op->buf.size());
      if (op->result >= 0 && !op->buf2.empty()) {
        int64_t r2 =
            tbs_write(e->fd, op->off2, op->buf2.data(), op->buf2.size());
        op->result = r2 < 0 ? r2 : op->result + r2;
      }
    } else {
      op->result = tbs_read(e->fd, op->off, op->buf.data(), op->buf.size());
    }
    pthread_mutex_lock(&e->mu);
    if (op->is_write && !op->tracked) {
      // Untracked writes auto-reap at completion: the payload is freed
      // immediately (no RAM held across a checkpoint interval) and a
      // failure latches the STICKY flag so every later drain/sync reports
      // it — a lost LSM block write can never be silently consumed.
      if (op->result < 0) e->failed = true;
      delete op;
    } else {
      if (op->is_write && op->result < 0) e->failed = true;
      if (op->is_write) {
        // Payloads are dead weight once written; completions only carry
        // the result code. swap() actually releases the heap allocation
        // (clear() keeps capacity — up to message_size_max per op).
        std::vector<uint8_t>().swap(op->buf);
        std::vector<uint8_t>().swap(op->buf2);
      }
      e->completed[op->id] = op;
    }
    e->inflight--;
    pthread_cond_broadcast(&e->cv_complete);
  }
  pthread_mutex_unlock(&e->mu);
  return nullptr;
}

}  // namespace

extern "C" {

tbio *tbio_create(int fd, int workers) {
  if (workers < 1 || workers > 64) return nullptr;
  tbio *e = new tbio();
  e->fd = fd;
  e->next_id = 1;
  e->inflight = 0;
  e->failed = false;
  e->shutdown = false;
  pthread_mutex_init(&e->mu, nullptr);
  pthread_cond_init(&e->cv_submit, nullptr);
  pthread_cond_init(&e->cv_complete, nullptr);
  for (int i = 0; i < workers; i++) {
    pthread_t t;
    if (pthread_create(&t, nullptr, tbio_worker, e) != 0) {
      e->shutdown = true;
      pthread_cond_broadcast(&e->cv_submit);
      for (pthread_t w : e->workers) pthread_join(w, nullptr);
      delete e;
      return nullptr;
    }
    e->workers.push_back(t);
  }
  return e;
}

long tbio_submit_write(tbio *e, uint64_t off, const uint8_t *data,
                       uint64_t len) {
  tbio_op *op = new tbio_op();
  op->is_write = 1;
  op->tracked = 0;
  op->off = off;
  op->buf.assign(data, data + len);
  pthread_mutex_lock(&e->mu);
  op->id = e->next_id++;
  e->inflight++;
  e->submitted.push_back(op);
  pthread_cond_signal(&e->cv_submit);
  long id = static_cast<long>(op->id);
  pthread_mutex_unlock(&e->mu);
  return id;
}

// Tracked ordered write pair: data1@off1 then (strictly after) data2@off2,
// completion reported through tbio_poll/tbio_fetch like a read. This is
// the async WAL append (prepare body, then redundant header — reference:
// the journal's write_prepare -> write_header ordering,
// src/vsr/journal.zig).
long tbio_submit_write_pair(tbio *e, uint64_t off1, const uint8_t *data1,
                            uint64_t len1, uint64_t off2,
                            const uint8_t *data2, uint64_t len2) {
  tbio_op *op = new tbio_op();
  op->is_write = 1;
  op->tracked = 1;
  op->off = off1;
  op->buf.assign(data1, data1 + len1);
  op->off2 = off2;
  op->buf2.assign(data2, data2 + len2);
  pthread_mutex_lock(&e->mu);
  op->id = e->next_id++;
  e->inflight++;
  e->live[op->id] = 1;
  e->submitted.push_back(op);
  pthread_cond_signal(&e->cv_submit);
  long id = static_cast<long>(op->id);
  pthread_mutex_unlock(&e->mu);
  return id;
}

long tbio_submit_read(tbio *e, uint64_t off, uint64_t len) {
  tbio_op *op = new tbio_op();
  op->is_write = 0;
  op->off = off;
  op->buf.resize(len);
  pthread_mutex_lock(&e->mu);
  op->id = e->next_id++;
  e->inflight++;
  e->live[op->id] = 1;
  e->submitted.push_back(op);
  pthread_cond_signal(&e->cv_submit);
  long id = static_cast<long>(op->id);
  pthread_mutex_unlock(&e->mu);
  return id;
}

// Nonblocking: copy up to `max` completed ids out; the entries stay
// until fetched (reads) or reaped (writes) via tbio_fetch.
long tbio_poll(tbio *e, uint64_t *ids, long max) {
  pthread_mutex_lock(&e->mu);
  long n = 0;
  for (auto &kv : e->completed) {
    if (n >= max) break;
    ids[n++] = kv.first;
  }
  pthread_mutex_unlock(&e->mu);
  return n;
}

// Blocking fetch of one READ or TRACKED-WRITE completion: waits for
// `id`, copies read data into buf (len bytes max; writes carry no data),
// frees the entry. Returns the op's io result (bytes transferred) or -2
// if the id is unknown, already fetched, or was an untracked write
// (those auto-reap; never wait on them).
long tbio_fetch(tbio *e, uint64_t id, uint8_t *buf, uint64_t len) {
  pthread_mutex_lock(&e->mu);
  std::map<uint64_t, tbio_op *>::iterator it;
  for (;;) {
    it = e->completed.find(id);
    if (it != e->completed.end()) break;
    if (e->live.find(id) == e->live.end()) {
      pthread_mutex_unlock(&e->mu);
      return -2;
    }
    pthread_cond_wait(&e->cv_complete, &e->mu);
  }
  tbio_op *op = it->second;
  e->completed.erase(it);
  e->live.erase(id);
  pthread_mutex_unlock(&e->mu);
  long result = static_cast<long>(op->result);
  if (!op->is_write && buf != nullptr && result > 0) {
    uint64_t n = static_cast<uint64_t>(result) < len
                     ? static_cast<uint64_t>(result)
                     : len;
    memcpy(buf, op->buf.data(), n);
  }
  delete op;
  return result;
}

// Barrier: every submitted op is complete, optionally followed by
// fsync — the checkpoint durability point. A write failure is STICKY:
// once any async write has failed, every subsequent drain reports it
// (the caller must treat the storage as compromised).
int tbio_drain(tbio *e, int do_sync) {
  pthread_mutex_lock(&e->mu);
  while (e->inflight > 0) pthread_cond_wait(&e->cv_complete, &e->mu);
  int failed = e->failed ? 1 : 0;
  pthread_mutex_unlock(&e->mu);
  if (failed) return -1;
  if (do_sync) return tbs_sync(e->fd);
  return 0;
}

void tbio_destroy(tbio *e) {
  pthread_mutex_lock(&e->mu);
  e->shutdown = true;
  pthread_cond_broadcast(&e->cv_submit);
  pthread_mutex_unlock(&e->mu);
  for (pthread_t w : e->workers) pthread_join(w, nullptr);
  for (tbio_op *op : e->submitted) delete op;
  for (auto &kv : e->completed) delete kv.second;
  pthread_mutex_destroy(&e->mu);
  pthread_cond_destroy(&e->cv_submit);
  pthread_cond_destroy(&e->cv_complete);
  delete e;
}

}  // extern "C"
