// Native parameter-server hub — C++ implementation of the framed tensor
// protocol in distkeras_torch/runtime/networking.py (the executable spec is
// the Python SocketParameterServer; both speak identical bytes).
//
// Reference parity: distkeras/parameter_servers.py ran this hub as Python
// threads, so every commit serialized on the GIL (SURVEY.md §3.4).  Here
// accept/handler threads are native and the hub is at FEATURE PARITY with
// the production Python hub: row-sparse embedding traffic,
// Adasum flat-combining adaptive aggregation, the hot-standby replication
// feed (both sides), reconnect backpressure and health-report ingestion
// all run GIL-free, with the Python hub kept as the executable spec via
// the bit-parity test matrices in tests/.
//
// Wire format (all integers big-endian):
//   frame          := u64 payload_len, payload
//   tensor payload := u8 action, u32 num_tensors,
//                     num_tensors * (u64 nbytes, raw bytes)
//   actions: 'P' pull -> 'W' + center tensors
//            'C' commit (center-shaped f32 deltas) -> 'A'
//            'Q' int8 commit (per tensor: be f32 scale + int8 values) -> 'A'
//            'S' sparse pull: one int64 sorted-unique row-id blob per
//                sparse table -> 'V' + one blob per CENTER leaf (full f32
//                leaf for dense leaves, the requested [k, dim] row block
//                for sparse leaves)
//            'U' sparse f32 commit: per leaf in template order — one full
//                f32 blob for dense leaves, TWO blobs (int64 row ids, f32
//                [k, dim] row grads) for sparse leaves -> 'A'
//            'X' sparse int8 commit: same layout, every value blob a 'Q'
//                blob (the row block quantized as one unit) -> 'A'
//            'H' heartbeat -> 'A'
//            'M' health report (one JSON blob) -> 'A'; the report is
//                parked in a bounded ring the Python wrapper drains into
//                the process HealthCollector (runtime/native.py)
//            'T' trace-context announce -> 'T' + 8-byte monotonic ns
//            'G' reconnect announce -> 'Y' + 8-byte retry-after hint (ms;
//                nonzero only while an adaptive hub is shedding a storm)
//            'R' replication hello: this peer is a hot standby — it is
//                full-synced (one R frame: 9-byte header blob + the whole
//                center) and thereafter receives one R delta frame per
//                applied commit, written BEFORE the committing worker's
//                ack (the zero-acked-commit-loss contract)
//            'Z' shm attach request (u8 version + u64 capacity hint) ->
//                'Z' offer (two ring-file path blobs) or decline (zero
//                blobs); on offer the client confirms with one more 'Z'
//                (one 1-byte blob) and both sides switch the SAME byte
//                stream onto a pair of mmap rings — frames after the
//                confirm move over shared memory, byte-identical to the
//                socket encoding (opt-in, legacy peers never
//                see the action)
//            'B' bye -> connection closes
//
// Locking (the hot-path design):
//   - gate_ (std::shared_mutex): commits take it SHARED — many commits
//     apply concurrently — while pulls / snapshots / replica syncs /
//     restores take it EXCLUSIVE, so every snapshot is a consistent
//     (clock, center) pair exactly like the Python hub's single lock
//     gives, without serializing the commit plane behind it.
//   - meta_ (std::mutex): clock, fence, membership, every counter and the
//     commit log — held for nanoseconds per commit.
//   - stripes_[16]: per-leaf-group apply locks (leaf i -> stripe i % 16):
//     two concurrent commits walking the center pipeline through
//     different leaves instead of serializing on one center mutex.
//
// Receive path: one grow-once buffer per connection, filled with a single
// recv() per wakeup — a pipelined client's parked commit + pull request
// arrive in ONE syscall and are parsed back to back.  Acks for a parsed
// run of commits/heartbeats coalesce into one send (flushed before any
// other reply and before any blocking recv, so the client's max-inflight
// backpressure never deadlocks).  Weights replies leave via writev
// scatter-gather straight out of the snapshot buffer (header + per-tensor
// prefixes from a prebuilt arena) — the FlatFrameCodec layout without
// assembling a contiguous frame.
//
// Commit scaling modes (matching runtime/parameter_server.py):
//   0 delta:  center += d                (DOWNPOUR, elastic)
//   1 adag:   center += d / num_workers  (ADAG; elastic uses live members)
//   2 dynsgd: center += d / (staleness+1)
// Scales are computed in double and applied as float32, the exact
// arithmetic the Python hub's `delta * np.float32(scale)` performs (the
// bit-parity pins depend on it; the build also pins -ffp-contract=off so
// no FMA contraction can fuse the multiply-add differently).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#include <cstdio>

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <algorithm>
#include <atomic>
#include <deque>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

int64_t mono_ns() {
  timespec ts{};
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + int64_t(ts.tv_nsec);
}

uint64_t be64_decode(const unsigned char* b) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | b[i];
  return v;
}

void be64_encode(uint64_t v, unsigned char* b) {
  for (int i = 7; i >= 0; --i) { b[i] = v & 0xff; v >>= 8; }
}

uint32_t be32_decode(const unsigned char* b) {
  return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
         (uint32_t(b[2]) << 8) | b[3];
}

void be32_encode(uint32_t v, unsigned char* b) {
  b[0] = (unsigned char)(v >> 24);
  b[1] = (v >> 16) & 0xff;
  b[2] = (v >> 8) & 0xff;
  b[3] = v & 0xff;
}

float bef32_decode(const unsigned char* b) {
  uint32_t raw = be32_decode(b);
  float f;
  std::memcpy(&f, &raw, sizeof(f));
  return f;
}

bool read_exact(int fd, void* buf, size_t n, bool* timed_out = nullptr) {
  auto* p = static_cast<unsigned char*>(buf);
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, p + got, n - got, 0);
    if (r <= 0) {
      if (timed_out && r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
        *timed_out = true;
      return false;
    }
    got += size_t(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const unsigned char*>(buf);
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd, p + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += size_t(r);
  }
  return true;
}

// scatter-gather send with partial-write recovery (the weights-reply hot
// path: header + per-tensor prefixes + payload leave the kernel without
// ever being assembled into one contiguous frame)
bool writev_all(int fd, struct iovec* iov, int iovcnt) {
  int idx = 0;
  while (idx < iovcnt) {
    int batch = std::min(iovcnt - idx, 64);  // stay far under IOV_MAX
    ssize_t r = ::writev(fd, iov + idx, batch);
    if (r <= 0) return false;
    size_t left = size_t(r);
    while (left > 0 && idx < iovcnt) {
      if (left >= iov[idx].iov_len) {
        left -= iov[idx].iov_len;
        ++idx;
      } else {
        iov[idx].iov_base = static_cast<unsigned char*>(iov[idx].iov_base) + left;
        iov[idx].iov_len -= left;
        left = 0;
      }
    }
  }
  return true;
}

// minimal extraction of an integer JSON field (the 'T' announce blob is
// produced by our own client, so a full parser buys nothing)
int64_t json_int_field(const unsigned char* buf, size_t n, const char* key,
                       int64_t fallback) {
  std::string s(reinterpret_cast<const char*>(buf), n);
  std::string needle = std::string("\"") + key + "\"";
  size_t pos = s.find(needle);
  if (pos == std::string::npos) return fallback;
  pos = s.find(':', pos + needle.size());
  if (pos == std::string::npos) return fallback;
  ++pos;
  while (pos < s.size() && (s[pos] == ' ' || s[pos] == '\t')) ++pos;
  if (pos >= s.size() ||
      (s[pos] != '-' && !isdigit(static_cast<unsigned char>(s[pos]))))
    return fallback;
  return std::strtoll(s.c_str() + pos, nullptr, 10);
}

// bounded-time TCP connect (the standby feed loop's dial; a stopping
// standby must not park in connect() against a dead host for minutes)
int connect_to(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // hostname form: keep it simple — loopback only resolution for
    // "localhost" (the deployment path passes numeric addresses)
    if (std::strcmp(host, "localhost") == 0) {
      ::inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
    } else {
      ::close(fd);
      return -1;
    }
  }
  // non-blocking connect + poll: bounded, interruptible-by-timeout
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc != 0 && errno == EINPROGRESS) {
    pollfd pfd{fd, POLLOUT, 0};
    if (::poll(&pfd, 1, timeout_ms) != 1) { ::close(fd); return -1; }
    int err = 0;
    socklen_t len = sizeof(err);
    ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
    if (err != 0) { ::close(fd); return -1; }
  } else if (rc != 0) {
    ::close(fd);
    return -1;
  }
  ::fcntl(fd, F_SETFL, flags);
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// -- shared-memory frame ring -------------------------------------------------
// mmap-backed SPSC byte ring, layout-identical to networking.ShmFrameRing
// (the Python side maps the same file).  Native-endian header:
//   u64 magic @0, u64 capacity @8, u64 head @64, u64 tail @128,
//   u32 producer_closed @192, u32 consumer_closed @196, data @4096.
// head/tail are free-running TOTAL byte counters (capacity is a power of
// two; position = counter & (capacity-1)).  The producer stores only head,
// the consumer only tail — the SPSC contract that needs no lock, just
// release on the writer's own counter and acquire on the peer's.  The ring
// carries the exact framed byte stream the socket would, so wire parity
// holds by construction.
struct ShmRing {
  static constexpr uint64_t kMagic = 0x646b2d72696e6731ULL;  // "dk-ring1"
  static constexpr size_t kHeaderBytes = 4096;
  static constexpr int kSpin = 200;  // busy iterations before parking

  unsigned char* base_ = nullptr;
  size_t map_len_ = 0;
  uint64_t capacity_ = 0;
  bool producer_ = false;
  std::atomic<uint64_t>* head_ = nullptr;
  std::atomic<uint64_t>* tail_ = nullptr;
  std::atomic<uint32_t>* producer_closed_ = nullptr;
  std::atomic<uint32_t>* consumer_closed_ = nullptr;
  unsigned char* data_ = nullptr;

  ~ShmRing() {
    if (base_) {
      // severing a live connection must WAKE a parked peer (the protocol
      // model's sever_wakes_ring_peer rule): raise BOTH flags, then unmap
      producer_closed_->store(1, std::memory_order_release);
      consumer_closed_->store(1, std::memory_order_release);
      ::munmap(base_, map_len_);
    }
  }

  void bind_header() {
    capacity_ = *reinterpret_cast<uint64_t*>(base_ + 8);
    head_ = reinterpret_cast<std::atomic<uint64_t>*>(base_ + 64);
    tail_ = reinterpret_cast<std::atomic<uint64_t>*>(base_ + 128);
    producer_closed_ = reinterpret_cast<std::atomic<uint32_t>*>(base_ + 192);
    consumer_closed_ = reinterpret_cast<std::atomic<uint32_t>*>(base_ + 196);
    data_ = base_ + kHeaderBytes;
  }

  static ShmRing* create(const char* path, bool producer, uint64_t capacity) {
    // round up to a power of two >= one page (the Python opener validates)
    uint64_t cap = 4096;
    while (cap < capacity) cap <<= 1;
    int fd = ::open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, off_t(kHeaderBytes + cap)) != 0) {
      ::close(fd);
      ::unlink(path);
      return nullptr;
    }
    void* m = ::mmap(nullptr, size_t(kHeaderBytes + cap),
                     PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    ::close(fd);  // the mapping keeps the pages alive
    if (m == MAP_FAILED) {
      ::unlink(path);
      return nullptr;
    }
    auto* r = new ShmRing();
    r->base_ = static_cast<unsigned char*>(m);
    r->map_len_ = size_t(kHeaderBytes + cap);
    r->producer_ = producer;
    *reinterpret_cast<uint64_t*>(r->base_ + 8) = cap;
    r->bind_header();
    // magic stamped LAST (release): a racing opener either sees no magic
    // (not a ring yet) or a fully-initialized header
    reinterpret_cast<std::atomic<uint64_t>*>(r->base_)
        ->store(kMagic, std::memory_order_release);
    return r;
  }

  static ShmRing* open_existing(const char* path, bool producer) {
    int fd = ::open(path, O_RDWR);
    if (fd < 0) return nullptr;
    struct stat st {};
    if (::fstat(fd, &st) != 0 || size_t(st.st_size) <= kHeaderBytes) {
      ::close(fd);
      return nullptr;
    }
    void* m = ::mmap(nullptr, size_t(st.st_size), PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return nullptr;
    auto* base = static_cast<unsigned char*>(m);
    uint64_t magic = reinterpret_cast<std::atomic<uint64_t>*>(base)->load(
        std::memory_order_acquire);
    uint64_t cap = *reinterpret_cast<uint64_t*>(base + 8);
    if (magic != kMagic || cap == 0 || (cap & (cap - 1)) != 0 ||
        kHeaderBytes + cap != size_t(st.st_size)) {
      // not (yet) a ring: unmap WITHOUT touching the closed flags — this
      // mapping may be some other file entirely
      ::munmap(m, size_t(st.st_size));
      return nullptr;
    }
    auto* r = new ShmRing();
    r->base_ = base;
    r->map_len_ = size_t(st.st_size);
    r->producer_ = producer;
    r->bind_header();
    return r;
  }

  // busy-then-park: stay hot for kSpin iterations, then sleep with
  // exponential backoff 10us..1ms (the Python ring's exact policy).
  // false = deadline passed or the hub's stop flag cleared.
  static bool park(int* spins, int64_t started_ns, int timeout_ms,
                   const std::atomic<bool>* stop) {
    if (stop && !stop->load(std::memory_order_relaxed)) return false;
    if (timeout_ms > 0 &&
        mono_ns() - started_ns > int64_t(timeout_ms) * 1000000)
      return false;
    ++*spins;
    if (*spins <= kSpin) return true;
    int shift = *spins - kSpin;
    if (shift > 7) shift = 7;
    long ns = 10000L << shift;
    if (ns > 1000000L) ns = 1000000L;
    timespec ts{0, ns};
    ::nanosleep(&ts, nullptr);
    return true;
  }

  // sendall semantics; false = consumer gone / stop / deadline
  bool write(const unsigned char* p, size_t n, int timeout_ms,
             const std::atomic<bool>* stop) {
    uint64_t head = head_->load(std::memory_order_relaxed);
    size_t done = 0;
    int spins = 0;
    int64_t started = mono_ns();
    while (done < n) {
      if (consumer_closed_->load(std::memory_order_acquire)) return false;
      uint64_t tail = tail_->load(std::memory_order_acquire);
      uint64_t free_b = capacity_ - (head - tail);
      if (free_b == 0) {
        if (!park(&spins, started, timeout_ms, stop)) return false;
        continue;
      }
      spins = 0;
      uint64_t at = head & (capacity_ - 1);
      uint64_t chunk = uint64_t(n - done);
      if (chunk > free_b) chunk = free_b;
      if (chunk > capacity_ - at) chunk = capacity_ - at;
      std::memcpy(data_ + at, p + done, size_t(chunk));
      head += chunk;
      // payload first, head AFTER (release): the consumer's acquire load
      // of head can only ever observe fully-copied bytes
      head_->store(head, std::memory_order_release);
      done += size_t(chunk);
    }
    return true;
  }

  // one recv()-shaped read: >0 bytes out, 0 = clean EOF (producer closed
  // and drained), -1 = deadline / stop (deadline sets *timed_out)
  ssize_t read_some(unsigned char* p, size_t n, int timeout_ms,
                    const std::atomic<bool>* stop, bool* timed_out) {
    uint64_t tail = tail_->load(std::memory_order_relaxed);
    int spins = 0;
    int64_t started = mono_ns();
    for (;;) {
      uint64_t head = head_->load(std::memory_order_acquire);
      if (head != tail) {
        uint64_t at = tail & (capacity_ - 1);
        uint64_t chunk = head - tail;
        if (chunk > uint64_t(n)) chunk = uint64_t(n);
        if (chunk > capacity_ - at) chunk = capacity_ - at;
        std::memcpy(p, data_ + at, size_t(chunk));
        tail_->store(tail + chunk, std::memory_order_release);
        return ssize_t(chunk);
      }
      if (producer_closed_->load(std::memory_order_acquire)) {
        // one re-check: bytes published before the flag must drain first
        if (head_->load(std::memory_order_acquire) != tail) continue;
        return 0;
      }
      if (!park(&spins, started, timeout_ms, stop)) {
        if (timed_out && !(stop && !stop->load(std::memory_order_relaxed)))
          *timed_out = true;  // genuine deadline, not a hub shutdown
        return -1;
      }
    }
  }
};

// per-connection I/O endpoint: a TCP fd, optionally switched onto a ring
// pair mid-life by the 'Z' attach handshake.  The byte stream is identical
// either way — the rings carry the exact frames the socket would.
struct ConnIo {
  int fd = -1;
  ShmRing* rx = nullptr;  // client->hub ring (this side consumes)
  ShmRing* tx = nullptr;  // hub->client ring (this side produces)
  int timeout_ms = 0;     // ring deadline, mirroring SO_RCVTIMEO/SO_SNDTIMEO
  const std::atomic<bool>* stop = nullptr;  // hub running_ flag (wakes parks)
};

ssize_t io_recv_some(ConnIo& io, unsigned char* buf, size_t n,
                     bool* timed_out) {
  if (io.rx)
    return io.rx->read_some(buf, n, io.timeout_ms, io.stop, timed_out);
  ssize_t r = ::recv(io.fd, buf, n, 0);
  if (r < 0 && timed_out && (errno == EAGAIN || errno == EWOULDBLOCK))
    *timed_out = true;
  return r;
}

bool io_write_all(ConnIo& io, const void* buf, size_t n) {
  if (io.tx)
    return io.tx->write(static_cast<const unsigned char*>(buf), n,
                        io.timeout_ms, io.stop);
  return write_all(io.fd, buf, n);
}

bool io_writev_all(ConnIo& io, struct iovec* iov, int iovcnt) {
  if (!io.tx) return writev_all(io.fd, iov, iovcnt);
  // a ring write is a memcpy, not a syscall: segment-at-a-time keeps the
  // byte stream identical with zero gather cost
  for (int i = 0; i < iovcnt; ++i)
    if (!io.tx->write(static_cast<const unsigned char*>(iov[i].iov_base),
                      iov[i].iov_len, io.timeout_ms, io.stop))
      return false;
  return true;
}

// R-frame header kinds (first blob, 9 bytes big-endian: u64 clock, u8 kind)
constexpr int kReplDelta = 0;
constexpr int kReplSync = 1;
constexpr int kReplHello = 2;
// sparse row-delta frame: blobs past the header carry the
// U-commit layout (dense leaves whole, sparse leaves as ids + scaled
// rows).  Sent only to replicas whose hello announced kReplCapSparse
// (optional 10th header byte); legacy replicas keep the dense stream.
constexpr int kReplSparse = 3;
constexpr int kReplCapSparse = 1;

// one leaf of an incoming commit, aliasing the connection's receive buffer
// (or its dequantize scratch) — consumed before the next frame lands, the
// same zero-copy contract the Python hub's wire views follow
struct PartView {
  bool sparse = false;
  const float* vals = nullptr;   // dense: `size` floats; sparse: k*dim grads
  const int64_t* ids = nullptr;  // sparse only: k sorted-unique row ids
  int64_t k = 0;
};

// one leaf of a scaled/merged commit with owned storage (the adaptive
// combiner's working representation; Python's _scale_parts twin)
struct OwnedPart {
  bool sparse = false;
  std::vector<float> vals;
  std::vector<int64_t> ids;
};

// -- Adasum (arXiv:2006.02924) over per-leaf parts -----------------------------
// One merge rule for dense and sparse commits: sparse x sparse pairs dot on
// their row intersection and merge on the union, so idle rows cost nothing.
// Accumulation in double, coefficients cast to float32 for the combine —
// the Python combiner's arithmetic shape (no bit pin exists for merged
// batches; batch-of-one never reaches this code).

double adasum_dot(const std::vector<OwnedPart>& a,
                  const std::vector<OwnedPart>& b, const int64_t* dims) {
  double total = 0.0;
  for (size_t i = 0; i < a.size(); ++i) {
    if (a[i].sparse) {
      int64_t dim = dims[i];
      size_t ia = 0, ib = 0;
      while (ia < a[i].ids.size() && ib < b[i].ids.size()) {
        if (a[i].ids[ia] < b[i].ids[ib]) ++ia;
        else if (a[i].ids[ia] > b[i].ids[ib]) ++ib;
        else {
          const float* ga = a[i].vals.data() + int64_t(ia) * dim;
          const float* gb = b[i].vals.data() + int64_t(ib) * dim;
          for (int64_t j = 0; j < dim; ++j)
            total += double(ga[j]) * double(gb[j]);
          ++ia;
          ++ib;
        }
      }
    } else {
      for (size_t j = 0; j < a[i].vals.size(); ++j)
        total += double(a[i].vals[j]) * double(b[i].vals[j]);
    }
  }
  return total;
}

double adasum_normsq(const std::vector<OwnedPart>& p) {
  double total = 0.0;
  for (const auto& part : p)
    for (float v : part.vals) total += double(v) * double(v);
  return total;
}

std::vector<OwnedPart> adasum_pair(const std::vector<OwnedPart>& a,
                                   const std::vector<OwnedPart>& b,
                                   const int64_t* dims) {
  double na = adasum_normsq(a);
  double nb = adasum_normsq(b);
  if (na == 0.0) return b;
  if (nb == 0.0) return a;
  double dot = adasum_dot(a, b, dims);
  float alpha = float(1.0 - dot / (2.0 * na));
  float beta = float(1.0 - dot / (2.0 * nb));
  std::vector<OwnedPart> merged(a.size());
  for (size_t i = 0; i < a.size(); ++i) {
    OwnedPart& out = merged[i];
    out.sparse = a[i].sparse;
    if (a[i].sparse) {
      int64_t dim = dims[i];
      out.ids.reserve(a[i].ids.size() + b[i].ids.size());
      size_t ia = 0, ib = 0;
      while (ia < a[i].ids.size() || ib < b[i].ids.size()) {
        int64_t id;
        if (ib >= b[i].ids.size() ||
            (ia < a[i].ids.size() && a[i].ids[ia] <= b[i].ids[ib]))
          id = a[i].ids[ia];
        else
          id = b[i].ids[ib];
        out.ids.push_back(id);
        out.vals.insert(out.vals.end(), size_t(dim), 0.0f);
        float* row = out.vals.data() + (out.ids.size() - 1) * size_t(dim);
        if (ia < a[i].ids.size() && a[i].ids[ia] == id) {
          const float* ga = a[i].vals.data() + int64_t(ia) * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += alpha * ga[j];
          ++ia;
        }
        if (ib < b[i].ids.size() && b[i].ids[ib] == id) {
          const float* gb = b[i].vals.data() + int64_t(ib) * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += beta * gb[j];
          ++ib;
        }
      }
    } else {
      out.vals.resize(a[i].vals.size());
      for (size_t j = 0; j < out.vals.size(); ++j)
        out.vals[j] = alpha * a[i].vals[j] + beta * b[i].vals[j];
    }
  }
  return merged;
}

// balanced pairwise-tree reduction, the exact pairing Python's
// adasum_merge produces: (0,1), (2,3), ... with an odd tail carried up
std::vector<OwnedPart> adasum_merge(std::vector<std::vector<OwnedPart>>& items,
                                    const int64_t* dims) {
  while (items.size() > 1) {
    std::vector<std::vector<OwnedPart>> nxt;
    for (size_t i = 0; i + 1 < items.size(); i += 2)
      nxt.push_back(adasum_pair(items[i], items[i + 1], dims));
    if (items.size() % 2) nxt.push_back(std::move(items.back()));
    items = std::move(nxt);
  }
  return std::move(items[0]);
}

// true when any leaf is carried sparse by one commit and dense by another
// — the combiner applies such batches sequentially (merging would densify
// whole tables), matching Python's _mixed_repr rule
bool mixed_repr(const std::vector<std::vector<OwnedPart>>& commits) {
  for (size_t i = 0; i < commits[0].size(); ++i)
    for (size_t c = 1; c < commits.size(); ++c)
      if (commits[c][i].sparse != commits[0][i].sparse) return true;
  return false;
}

class ParameterServer {
 public:
  // stats() slot layout — runtime/native.py names these; keep in sync
  enum StatSlot {
    S_COMMITS = 0, S_PULLS, S_COMMIT_BYTES, S_PULL_BYTES, S_FENCED,
    S_LIVE_WORKERS, S_IDLE_EVICTIONS, S_CLOCK, S_LOG_DROPPED,
    S_SPARSE_ROWS_PULLED, S_SPARSE_ROWS_COMMITTED, S_SPARSE_WIRE_SAVED,
    S_REPLICAS_CONNECTED, S_REPLICAS_ATTACHED, S_REPLICA_DISCONNECTS,
    S_MERGE_BATCHES, S_MERGED_COMMITS, S_MAX_MERGE_BATCH,
    S_BACKPRESSURE_HINTS, S_REPL_FRAMES, S_PROMOTIONS,
    S_HEALTH_DROPPED, S_IS_STANDBY, S_PROMOTED, S_PROMOTED_AT_CLOCK,
    S_SYNCED, S_REPL_SPARSE_BYTES, S_REPL_SPARSE_SAVED, kStatCount
  };
  static constexpr int kStaleSlots = 64;   // exact small-int histograms
  static constexpr int kStripes = 16;      // apply-lock striping
  static constexpr int64_t kLogCapacity = 8192;
  static constexpr size_t kHealthRingCap = 256;

  ParameterServer(int port, int num_tensors, const int64_t* sizes, int mode,
                  int num_workers, int elastic, int idle_timeout_ms,
                  int num_sparse, const int32_t* sparse_leaves,
                  const int64_t* sparse_dims, int adaptive,
                  int64_t max_payload)
      : requested_port_(port), mode_(mode), num_workers_(num_workers),
        elastic_(elastic != 0), adaptive_(adaptive != 0),
        idle_timeout_ms_(idle_timeout_ms) {
    sizes_.assign(sizes, sizes + num_tensors);
    offsets_.resize(sizes_.size());
    sparse_dim_.assign(sizes_.size(), 0);
    int64_t total = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      offsets_[i] = total;
      total += sizes_[i];
    }
    for (int s = 0; s < num_sparse; ++s) {
      int leaf = int(sparse_leaves[s]);
      sparse_dim_[size_t(leaf)] = sparse_dims[s];
      sparse_leaves_.push_back(leaf);
    }
    for (int leaf : sparse_leaves_) {
      int64_t rows = sizes_[size_t(leaf)] / sparse_dim_[size_t(leaf)];
      sparse_touch_.emplace_back(size_t(rows), 0.0f);
      hot_rows_.push_back(0);
    }
    center_.assign(size_t(total), 0.0f);
    center_bytes_ = total * int64_t(sizeof(float));
    // request bound: passed down from Python (networking.max_request_payload)
    // so both hubs reject the exact same oversized prefixes
    max_payload_ = uint64_t(max_payload);
    // dense frame constants for the sparse wire-savings accounting
    // (mirrors the Python hub's _frame_bytes / _q_payload_bytes)
    dense_payload_f32_ = 5;
    q_payload_bytes_ = 5;
    for (int64_t s : sizes_) {
      dense_payload_f32_ += 8 + 4 * s;
      q_payload_bytes_ += 8 + 4 + s;
    }
    // prebuilt weights-reply skeleton for the writev send path: the
    // 13-byte header (len, 'W', count) + one 8-byte big-endian length
    // prefix per tensor, all constant for a fixed schema
    w_hdr_.resize(13);
    be64_encode(uint64_t(dense_payload_f32_), w_hdr_.data());
    w_hdr_[8] = 'W';
    be32_encode(uint32_t(sizes_.size()), w_hdr_.data() + 9);
    w_prefix_.resize(8 * sizes_.size());
    for (size_t i = 0; i < sizes_.size(); ++i)
      be64_encode(uint64_t(sizes_[i]) * 4, w_prefix_.data() + 8 * i);
  }

  ~ParameterServer() { stop(); }

  // enable the shm attach path: rings for 'Z'-capable clients are created
  // under this directory.  Call before start() (the Python wrapper does)
  void set_shm_dir(const char* dir) { shm_dir_ = dir ? dir : ""; }

  void set_replica_of(const char* host, int port, int retries,
                      int backoff_ms) {
    replica_host_ = host;
    replica_port_ = port;
    replica_retries_ = retries;
    replica_backoff_ms_ = backoff_ms;
    standby_.store(true);
  }

  // returns the bound port, or -1 on failure
  int start() {
    // bind on a local fd, publish into the atomic only once listening:
    // stop() (another thread) shuts the published fd down to wake the
    // accept loop, so the handoff itself must be race-free (TSAN-pinned
    // by the TSAN stress cell)
    int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (lfd < 0) return -1;
    int one = 1;
    ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(uint16_t(requested_port_));
    if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(lfd, 128) != 0) {
      ::close(lfd);
      return -1;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &len);
    bound_port_ = ntohs(addr.sin_port);
    listen_fd_.store(lfd);
    running_.store(true);
    accept_thread_ = std::thread([this] { accept_loop(); });
    if (replica_port_ >= 0) {
      replica_stop_.store(false);
      replica_thread_ = std::thread([this] { replica_loop(); });
    }
    return bound_port_;
  }

  void stop() {
    // one mutex serializes the WHOLE teardown: concurrent stop() calls
    // (user stop racing a destructor) must not both reach the thread
    // joins — joining the same std::thread twice is UB
    std::lock_guard<std::mutex> stop_guard(stop_mtx_);
    bool was_running = running_.exchange(false);
    if (!was_running && listen_fd_.load() < 0 && !replica_thread_.joinable())
      return;
    replica_stop_.store(true);
    stopped_.store(true);
    int rfd = replica_fd_.load();
    if (rfd >= 0) ::shutdown(rfd, SHUT_RDWR);
    // shutdown ONLY here — shutdown() wakes the blocked accept()
    // (EINVAL) but keeps the descriptor NUMBER reserved, so no accept()
    // call (nor this shutdown) can ever hit a kernel-reused fd.  The
    // close happens below, AFTER the accept thread is joined — the only
    // point where provably nothing references the descriptor.
    int lfd = listen_fd_.load();
    if (lfd >= 0) ::shutdown(lfd, SHUT_RDWR);
    {
      std::lock_guard<std::mutex> g(conn_mutex_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    if (feed_) feed_->close_all();
    if (accept_thread_.joinable()) accept_thread_.join();
    // exchange claims the close exactly once, after the join: the
    // accept loop has exited, so the fd is provably unreferenced
    lfd = listen_fd_.exchange(-1);
    if (lfd >= 0) ::close(lfd);
    if (replica_thread_.joinable()) replica_thread_.join();
    for (auto& t : handler_threads_)
      if (t.joinable()) t.join();
    handler_threads_.clear();
  }

  void get_weights(float* out) {
    std::unique_lock<std::shared_mutex> g(gate_);
    std::memcpy(out, center_.data(), center_.size() * sizeof(float));
  }

  void set_weights(const float* in) {
    std::unique_lock<std::shared_mutex> g(gate_);
    std::memcpy(center_.data(), in, center_.size() * sizeof(float));
  }

  int64_t num_updates() const { return num_updates_.load(); }
  int port() const { return bound_port_; }
  int64_t time_ns() const { return mono_ns(); }

  // restore a hub snapshot: center + commit clock + update count, with the
  // clock FENCE armed at the restored clock (restore semantics)
  void restore(const float* flat, int64_t clock, int64_t num_updates) {
    std::unique_lock<std::shared_mutex> g(gate_);
    std::lock_guard<std::mutex> m(meta_);
    std::memcpy(center_.data(), flat, center_.size() * sizeof(float));
    clock_ = clock;
    clock_fence_ = clock;
    num_updates_.store(num_updates);
  }

  // -- standby surface (replica_of; mirrors SocketParameterServer) ------------
  bool is_standby() const { return standby_.load(); }
  bool promoted() const { return promoted_flag_.load(); }

  int64_t promoted_at_clock() {
    std::lock_guard<std::mutex> m(meta_);
    return promoted_at_clock_;
  }

  bool wait_synced(int64_t timeout_ms) {
    // bounded poll on the sync/stop atomics.  This was a condvar, but
    // libstdc++'s wait_for lowers to pthread_cond_clockwait, which
    // gcc-10-era libtsan does not intercept — every TSAN run read the
    // wakeup as a phantom double-lock.  wait_synced is a once-per-attach
    // latency path, so millisecond polling granularity costs nothing
    // and keeps the hub condvar-free.
    const auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(timeout_ms);
    while (!synced_.load() && !stopped_.load()) {
      if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
        break;
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    return synced_.load();
  }

  // promote a standby: arm the clock fence at the replicated clock and
  // stop applying feed frames forever.  Idempotent; true if we promoted.
  bool promote() {
    {
      std::lock_guard<std::mutex> m(meta_);
      if (!standby_.load() || promoted_flag_.load()) return false;
      promoted_flag_.store(true);
      standby_.store(false);
      clock_fence_ = clock_;
      promoted_at_clock_ = clock_;
      ++promotions_;
    }
    replica_stop_.store(true);
    int fd = replica_fd_.load();
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    return true;
  }

  // -- in-process transport (transport="inproc") ------------------------------
  int64_t pull_direct(float* out) {
    std::unique_lock<std::shared_mutex> g(gate_);
    int64_t clock;
    {
      std::lock_guard<std::mutex> m(meta_);
      clock = clock_;
      ++pulls_;
      pull_bytes_ += center_bytes_;
    }
    std::memcpy(out, center_.data(), center_.size() * sizeof(float));
    return clock;
  }

  // pull_direct minus the telemetry (HubSnapshotter's uncounted read)
  int64_t snapshot_direct(float* out) {
    std::unique_lock<std::shared_mutex> g(gate_);
    std::lock_guard<std::mutex> m(meta_);
    std::memcpy(out, center_.data(), center_.size() * sizeof(float));
    return clock_;
  }

  // 0 = applied; 1 = refused (never-synced standby); 2 = refused (standby
  // probing a connected primary) — runtime/native.py raises on nonzero,
  // matching the Python hub's commit_direct standby errors
  int commit_direct(const float* flat, int64_t last_pull_clock,
                    int64_t worker = -1) {
    if (standby_.load()) {
      if (!synced_.load()) return 1;
      int fd = replica_fd_.load();
      if (fd >= 0) {
        ::shutdown(fd, SHUT_RDWR);
        return 2;
      }
      promote();  // feed down: its owner considers this the live hub
    }
    std::vector<PartView> parts(sizes_.size());
    const float* p = flat;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      parts[i].vals = p;
      p += sizes_[i];
    }
    commit_parts(parts, &last_pull_clock, worker, center_bytes_, 0, 0);
    return 0;
  }

  // -- sparse in-process transport --------------------------------------------
  // pull_sparse_direct minus the frame (the S/V exchange): ``ids`` is the
  // concatenation of each sparse table's sorted-unique row ids
  // (``counts[s]`` per table, sparse_leaves_ order); ``out`` receives the
  // per-leaf values in template order — dense leaves whole, sparse
  // leaves their [k, dim] row blocks.  Returns the snapshot clock,
  // -1 = never-synced standby refusal, -2 = invalid row ids.
  int64_t pull_sparse_direct(const int64_t* ids, const int64_t* counts,
                             float* out) {
    if (standby_.load() && !synced_.load()) return -1;
    {
      const int64_t* p = ids;
      for (size_t s = 0; s < sparse_leaves_.size(); ++s) {
        if (!check_row_ids(p, counts[s], size_t(sparse_leaves_[s])))
          return -2;
        p += counts[s];
      }
    }
    std::unique_lock<std::shared_mutex> g(gate_);
    const int64_t* ip = ids;
    float* op = out;
    int64_t rows_pulled = 0, raw = 0;
    size_t s = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      const float* c = center_.data() + offsets_[i];
      if (sparse_dim_[i] > 0) {
        int64_t dim = sparse_dim_[i];
        int64_t k = counts[s];
        for (int64_t r = 0; r < k; ++r)
          std::memcpy(op + r * dim, c + ip[r] * dim, size_t(dim) * 4);
        ip += k;
        op += k * dim;
        rows_pulled += k;
        raw += k * dim * 4;
        ++s;
      } else {
        std::memcpy(op, c, size_t(sizes_[i]) * 4);
        op += sizes_[i];
        raw += sizes_[i] * 4;
      }
    }
    int64_t clock;
    {
      std::lock_guard<std::mutex> m(meta_);
      clock = clock_;
      ++pulls_;
      pull_bytes_ += raw;
      sparse_rows_pulled_ += rows_pulled;
      {
        const int64_t* tp = ids;
        for (size_t t = 0; t < sparse_leaves_.size(); ++t) {
          touch_ids_locked(t, tp, counts[t]);
          tp += counts[t];
        }
        fold_touch_locked();
      }
    }
    return clock;
  }

  // commit_sparse_direct minus the frame (the U exchange): ``vals`` is
  // the concatenation of per-leaf payloads in template order (full f32
  // delta for dense leaves, [k, dim] row grads for sparse ones), ids/
  // counts as in pull_sparse_direct.  0 = applied, 1 = refused (never-
  // synced standby), 2 = refused (standby probing a live primary),
  // 3 = invalid row ids — runtime/native.py raises on nonzero.
  int commit_sparse_direct(const float* vals, const int64_t* ids,
                           const int64_t* counts, int64_t last_pull_clock,
                           int64_t worker) {
    std::vector<PartView> parts(sizes_.size());
    const float* vp = vals;
    const int64_t* ip = ids;
    size_t s = 0;
    int64_t rows = 0, raw = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      if (sparse_dim_[i] > 0) {
        int64_t k = counts[s];
        if (!check_row_ids(ip, k, i)) return 3;
        parts[i].sparse = true;
        parts[i].ids = ip;
        parts[i].k = k;
        parts[i].vals = vp;
        ip += k;
        vp += k * sparse_dim_[i];
        rows += k;
        raw += k * (8 + sparse_dim_[i] * 4);
        ++s;
      } else {
        parts[i].vals = vp;
        vp += sizes_[i];
        raw += sizes_[i] * 4;
      }
    }
    if (standby_.load()) {
      if (!synced_.load()) return 1;
      int fd = replica_fd_.load();
      if (fd >= 0) {
        ::shutdown(fd, SHUT_RDWR);
        return 2;
      }
      promote();  // feed down: its owner considers this the live hub
    }
    commit_parts(parts, &last_pull_clock, worker, raw, rows, 0);
    return 0;
  }

  // -- telemetry exports ------------------------------------------------------
  void stats(int64_t out[kStatCount]) {
    std::lock_guard<std::mutex> m(meta_);
    out[S_COMMITS] = commits_;
    out[S_PULLS] = pulls_;
    out[S_COMMIT_BYTES] = commit_bytes_;
    out[S_PULL_BYTES] = pull_bytes_;
    out[S_FENCED] = fenced_commits_;
    out[S_LIVE_WORKERS] = live_members_;
    out[S_IDLE_EVICTIONS] = idle_evictions_;
    out[S_CLOCK] = clock_;
    out[S_LOG_DROPPED] = log_dropped_;
    out[S_SPARSE_ROWS_PULLED] = sparse_rows_pulled_;
    out[S_SPARSE_ROWS_COMMITTED] = sparse_rows_committed_;
    out[S_SPARSE_WIRE_SAVED] = sparse_wire_saved_;
    out[S_REPLICAS_CONNECTED] = feed_ ? feed_->count_.load() : 0;
    out[S_REPLICAS_ATTACHED] = replicas_attached_;
    out[S_REPLICA_DISCONNECTS] = replica_disconnects_;
    out[S_MERGE_BATCHES] = merge_batches_;
    out[S_MERGED_COMMITS] = merged_commits_;
    out[S_MAX_MERGE_BATCH] = max_merge_batch_;
    out[S_BACKPRESSURE_HINTS] = backpressure_hints_;
    out[S_REPL_FRAMES] = repl_frames_;
    out[S_PROMOTIONS] = promotions_;
    out[S_HEALTH_DROPPED] = health_dropped_;
    out[S_IS_STANDBY] = standby_.load() ? 1 : 0;
    out[S_PROMOTED] = promoted_flag_.load() ? 1 : 0;
    out[S_PROMOTED_AT_CLOCK] = promoted_at_clock_;
    out[S_SYNCED] = synced_.load() ? 1 : 0;
    out[S_REPL_SPARSE_BYTES] = repl_sparse_bytes_;
    out[S_REPL_SPARSE_SAVED] = repl_sparse_saved_;
  }

  // decayed per-table hot-set estimates (one int64 per sparse leaf, in
  // sparse_leaves_ order) — dk_ps_hot_rows
  void hot_rows(int64_t* out) {
    std::lock_guard<std::mutex> m(meta_);
    for (size_t s = 0; s < hot_rows_.size(); ++s) out[s] = hot_rows_[s];
  }

  void staleness_hist(int64_t out[kStaleSlots + 1]) {
    std::lock_guard<std::mutex> m(meta_);
    std::memcpy(out, stale_hist_, sizeof(stale_hist_));
  }

  void merge_hist(int64_t out[kStaleSlots + 1]) {
    std::lock_guard<std::mutex> m(meta_);
    std::memcpy(out, merge_hist_, sizeof(merge_hist_));
  }

  int64_t drain_commits(int64_t* out, int64_t max_records) {
    std::lock_guard<std::mutex> m(meta_);
    int64_t n = 0;
    while (n < max_records && log_count_ > 0) {
      const CommitRecord& r = commit_log_[size_t(log_head_)];
      out[n * 5 + 0] = r.clock;
      out[n * 5 + 1] = r.worker;
      out[n * 5 + 2] = r.staleness;
      out[n * 5 + 3] = r.t_ns;
      out[n * 5 + 4] = r.dur_ns;
      log_head_ = (log_head_ + 1) % kLogCapacity;
      --log_count_;
      ++n;
    }
    return n;
  }

  // pop one parked health report (action 'M' payload) into out; returns
  // its length, 0 when the ring is empty, -1 when it exceeded cap (the
  // report is dropped and counted — never silently wedged)
  int64_t next_health(unsigned char* out, int64_t cap) {
    std::lock_guard<std::mutex> m(meta_);
    if (health_ring_.empty()) return 0;
    std::string& front = health_ring_.front();
    if (int64_t(front.size()) > cap) {
      health_ring_.pop_front();
      ++health_dropped_;
      return -1;
    }
    int64_t n = int64_t(front.size());
    std::memcpy(out, front.data(), front.size());
    health_ring_.pop_front();
    return n;
  }

  // -- adaptive controls (driven from runtime/native.py) ----------------------
  // per-worker multiplicative commit scale with an expiry deadline: the
  // Python-side AdaptiveRateController pushes its verdicts here, and an
  // expired verdict reads as 1.0 — so a dead controller can never pin a
  // worker's scale forever
  void set_rate_scale(int64_t worker, double scale, int64_t expires_ns) {
    std::lock_guard<std::mutex> g(rate_mtx_);
    rate_scales_[worker] = {scale, expires_ns};
  }

  void set_storm_params(int hellos, int window_ms, int shed_ms, int base_ms,
                        int cap_ms) {
    std::lock_guard<std::mutex> g(bp_mtx_);
    storm_hellos_ = hellos;
    storm_window_ns_ = int64_t(window_ms) * 1000000;
    storm_shed_ns_ = int64_t(shed_ms) * 1000000;
    retry_base_ms_ = base_ms;
    retry_cap_ms_ = cap_ms;
  }

  // arm shedding from an external storm verdict (the Python wrapper's
  // health-monitor subscription), mirroring the hub's _on_health_event
  void arm_storm() {
    std::lock_guard<std::mutex> g(bp_mtx_);
    int64_t now = mono_ns();
    if (now >= storm_until_ns_) retry_seq_ = 0;
    storm_until_ns_ = std::max(storm_until_ns_, now + storm_shed_ns_);
  }

 private:
  struct CommitRecord {
    int64_t clock, worker, staleness, t_ns, dur_ns;
  };

  // one queued adaptive commit: the submitter's stack owns it, the drain
  // winner fills in the verdict fields before releasing the drain lock
  // (the Python combiner's entry dict, minus the dict)
  struct CommitEntry {
    const std::vector<PartView>* parts;
    int64_t lpc, worker, wire_bytes, rows_committed, wire_saved;
    int64_t staleness = 0, rebased_lpc = 0;
    bool done = false;
  };

  // -- replication feed (primary side; Python's ReplicationFeed twin) ---------
  // attach full-syncs under the write gate, publish streams one R delta
  // frame per applied commit BEFORE the worker's ack leaves.  A replica's
  // immutable attach-time sync clock filters deltas its sync covered;
  // its attach-time hello capability decides which frame KINDS it is
  // ever sent — row-sparse commits go to kReplCapSparse replicas as one
  // kReplSparse row-delta frame (cost ∝ touched rows) and to legacy
  // replicas as the dense-materialized kReplDelta.
  struct ReplFeed {
    explicit ReplFeed(ParameterServer* hub) : hub(hub) {}
    ParameterServer* hub;
    std::mutex lock_;  // serializes attach + publish (Python's feed lock)
    struct Rep {
      int fd;
      int64_t sync_clock;
      bool sparse_ok;
    };
    std::vector<Rep> conns_;
    std::atomic<int> count_{0};
    // legacy (dense-only) replicas attached: the commit path reads this
    // lock-free to decide whether a sparse commit must ALSO materialize
    // the center-shaped delta.  Racy by design: a commit that read it
    // just before a legacy replica registered is densified on demand in
    // publish, under the feed lock
    std::atomic<int> dense_count_{0};
    std::vector<unsigned char> tx_;
    std::vector<unsigned char> sp_tx_;
    std::vector<float> fb_dense_;  // densify-on-demand scratch (lock_)

    // what a kReplSparse frame is packed from: the plain path's wire
    // views (scaled while packing — the same `scale * g` float product
    // the apply computed) or the adaptive path's pre-scaled owned parts
    struct SparseSrc {
      const std::vector<PartView>* views = nullptr;
      const std::vector<OwnedPart>* owned = nullptr;
      float scale = 1.0f;
    };

    // frame: [u64 len][R][u32 1+L][u64 9][9-byte hdr][per leaf u64+f32s]
    void pack_frame(int64_t clock, int kind, const float* flat) {
      size_t payload = 5 + 8 + 9;
      for (int64_t s : hub->sizes_) payload += 8 + size_t(s) * 4;
      tx_.resize(8 + payload);
      unsigned char* p = tx_.data();
      be64_encode(payload, p);
      p[8] = 'R';
      be32_encode(uint32_t(1 + hub->sizes_.size()), p + 9);
      p += 13;
      be64_encode(9, p);
      p += 8;
      be64_encode(uint64_t(clock), p);
      p[8] = (unsigned char)kind;
      p += 9;
      for (size_t i = 0; i < hub->sizes_.size(); ++i) {
        uint64_t nbytes = uint64_t(hub->sizes_[i]) * 4;
        be64_encode(nbytes, p);
        p += 8;
        std::memcpy(p, flat + hub->offsets_[i], nbytes);
        p += nbytes;
      }
    }

    // row-delta frame (kReplSparse): header blob + the U-commit layout —
    // dense leaves whole, sparse leaves as (ids, scaled rows)
    void pack_sparse(int64_t clock, const SparseSrc& sp) {
      const auto& sizes = hub->sizes_;
      const auto& dims = hub->sparse_dim_;
      size_t payload = 5 + 8 + 9;
      for (size_t i = 0; i < sizes.size(); ++i) {
        int64_t k = sp.views ? ((*sp.views)[i].sparse ? (*sp.views)[i].k : -1)
                             : ((*sp.owned)[i].sparse
                                    ? int64_t((*sp.owned)[i].ids.size())
                                    : -1);
        if (k >= 0)
          payload += 8 + size_t(k) * 8 + 8 + size_t(k * dims[i]) * 4;
        else
          payload += 8 + size_t(sizes[i]) * 4;
      }
      sp_tx_.resize(8 + payload);
      unsigned char* p = sp_tx_.data();
      be64_encode(payload, p);
      p[8] = 'R';
      be32_encode(uint32_t(1 + sizes.size() + hub->sparse_leaves_.size()),
                  p + 9);
      p += 13;
      be64_encode(9, p);
      p += 8;
      be64_encode(uint64_t(clock), p);
      p[8] = (unsigned char)kReplSparse;
      p += 9;
      for (size_t i = 0; i < sizes.size(); ++i) {
        bool sparse = sp.views ? (*sp.views)[i].sparse
                               : (*sp.owned)[i].sparse;
        const int64_t* ids = nullptr;
        const float* vals;
        int64_t k = 0, nvals;
        if (sp.views) {
          const PartView& v = (*sp.views)[i];
          ids = v.ids;
          vals = v.vals;
          k = v.k;
          nvals = sparse ? k * dims[i] : sizes[i];
        } else {
          const OwnedPart& o = (*sp.owned)[i];
          ids = o.ids.data();
          vals = o.vals.data();
          k = int64_t(o.ids.size());
          nvals = int64_t(o.vals.size());
        }
        if (sparse) {
          be64_encode(uint64_t(k) * 8, p);
          p += 8;
          std::memcpy(p, ids, size_t(k) * 8);
          p += size_t(k) * 8;
        }
        be64_encode(uint64_t(nvals) * 4, p);
        p += 8;
        float* out = reinterpret_cast<float*>(p);
        if (sp.scale == 1.0f)
          std::memcpy(out, vals, size_t(nvals) * 4);
        else
          for (int64_t j = 0; j < nvals; ++j) out[j] = sp.scale * vals[j];
        p += size_t(nvals) * 4;
      }
    }

    bool attach(int fd, int caps) {
      timeval tv{30, 0};  // REPLICA_SEND_TIMEOUT: a stuck replica must
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));  // not
      std::lock_guard<std::mutex> l(lock_);  // park the commit plane
      // register BEFORE the snapshot (the Python feed's order): a commit
      // whose lock-free count_ read comes after this store publishes, and
      // its publish waits on lock_ until the sync is out; a commit that
      // read count_ before it still holds the shared gate, so it has
      // applied by the time the snapshot below takes the gate.  Nothing
      // falls between the sync and the stream.  The sync clock stays -1
      // until the snapshot fills it in (publish cannot run meanwhile)
      bool sparse_ok = (caps & kReplCapSparse) != 0;
      conns_.push_back({fd, -1, sparse_ok});
      count_.store(int(conns_.size()));
      if (!sparse_ok) dense_count_.fetch_add(1);
      int64_t clock;
      {
        // pack the center STRAIGHT into the sync frame under the write
        // gate
        std::unique_lock<std::shared_mutex> g(hub->gate_);
        {
          std::lock_guard<std::mutex> m(hub->meta_);
          clock = hub->clock_;
        }
        pack_frame(clock, kReplSync, hub->center_.data());
      }
      conns_.back().sync_clock = clock;
      if (!write_all(fd, tx_.data(), tx_.size())) {
        // un-register: the standby never got its sync
        conns_.pop_back();
        count_.store(int(conns_.size()));
        if (!sparse_ok) dense_count_.fetch_sub(1);
        ::close(fd);
        return false;
      }
      {
        std::lock_guard<std::mutex> m(hub->meta_);
        ++hub->replicas_attached_;
      }
      return true;
    }

    // `dense` may be nullptr when the commit path observed only
    // sparse-capable replicas (then `sp` must be set); a LEGACY replica
    // whose attach raced that lock-free check is still served here by
    // densifying on demand under the feed lock — the Python feed's
    // exact contract (its registered sync clock snapshots BEFORE this
    // commit applied, so skipping it would lose the delta forever)
    void publish(int64_t clock, const float* dense,
                 const SparseSrc* sp = nullptr) {
      std::lock_guard<std::mutex> l(lock_);
      if (conns_.empty()) return;
      bool packed = false, sp_packed = false;
      std::vector<size_t> dead;
      for (size_t i = 0; i < conns_.size(); ++i) {
        if (conns_[i].sync_clock >= clock) continue;  // covered by sync
        bool ok;
        if (sp != nullptr && conns_[i].sparse_ok) {
          if (!sp_packed) {
            pack_sparse(clock, *sp);
            sp_packed = true;
          }
          ok = write_all(conns_[i].fd, sp_tx_.data(), sp_tx_.size());
          if (ok) {
            std::lock_guard<std::mutex> m(hub->meta_);
            hub->repl_sparse_bytes_ += int64_t(sp_tx_.size());
            int64_t dense_frame = 8 + 5 + 8 + 9;
            for (int64_t s : hub->sizes_) dense_frame += 8 + s * 4;
            int64_t saved = dense_frame - int64_t(sp_tx_.size());
            if (saved > 0) hub->repl_sparse_saved_ += saved;
          }
        } else {
          if (dense == nullptr) {
            // densify-on-demand: scatter the scaled sparse parts into a
            // center-shaped scratch (materialize_* take no locks; the
            // commit's part views stay valid — publish is synchronous
            // within the committing call)
            fb_dense_.assign(hub->center_.size(), 0.0f);
            if (sp->views != nullptr)
              hub->materialize_views(*sp->views, sp->scale,
                                     fb_dense_.data());
            else
              hub->materialize_owned(*sp->owned, fb_dense_.data());
            dense = fb_dense_.data();
          }
          if (!packed) {
            pack_frame(clock, kReplDelta, dense);
            packed = true;
          }
          ok = write_all(conns_[i].fd, tx_.data(), tx_.size());
        }
        if (!ok) dead.push_back(i);
      }
      for (size_t d = dead.size(); d > 0; --d) {
        size_t i = dead[d - 1];
        ::close(conns_[i].fd);
        if (!conns_[i].sparse_ok) dense_count_.fetch_sub(1);
        conns_.erase(conns_.begin() + long(i));
        std::lock_guard<std::mutex> m(hub->meta_);
        ++hub->replica_disconnects_;
      }
      count_.store(int(conns_.size()));
    }

    void close_all() {
      std::lock_guard<std::mutex> l(lock_);
      for (auto& r : conns_) {
        ::shutdown(r.fd, SHUT_RDWR);
        ::close(r.fd);
      }
      conns_.clear();
      count_.store(0);
      dense_count_.store(0);
    }
  };

  // -- scaling rules ----------------------------------------------------------
  // the scalar a commit is multiplied by, in double (cast to float32 at
  // the apply — `np.float32(commit_scale(staleness))` exactly).  Caller
  // holds meta_ (live_members_)
  double commit_scale_locked(int64_t staleness) {
    if (mode_ == 1) {
      int n = num_workers_;
      if (elastic_) {
        n = live_members_;
        if (n < 1) n = num_workers_;
        if (n > num_workers_) n = num_workers_;
      }
      return 1.0 / double(n);
    }
    if (mode_ == 2) return 1.0 / double(staleness + 1);
    return 1.0;
  }

  // the live per-worker adaptive rate (1.0 when unknown/expired/uncontexted)
  double rate_scale(int64_t worker) {
    if (worker < 0 || !adaptive_) return 1.0;
    std::lock_guard<std::mutex> g(rate_mtx_);
    auto it = rate_scales_.find(worker);
    if (it == rate_scales_.end()) return 1.0;
    if (mono_ns() >= it->second.second) {
      rate_scales_.erase(it);
      return 1.0;
    }
    return it->second.first;
  }

  // -- row-touch telemetry (caller holds meta_) -------------------------------
  // per-table exponentially-decayed touch counters: +1 per touched row
  // per sparse request, halved every kTouchDecayEvery folds; rows still
  // >= 1 then estimate the live hot set (dk_ps_hot_rows — the wrapper
  // surfaces them as ps.sparse_hot_rows{table=} gauges)
  static constexpr int kTouchDecayEvery = 64;

  void fold_touch_locked() {
    if (++touch_folds_ < kTouchDecayEvery) return;
    touch_folds_ = 0;
    for (size_t s = 0; s < sparse_touch_.size(); ++s) {
      int64_t hot = 0;
      for (float& v : sparse_touch_[s]) {
        v *= 0.5f;
        if (v >= 1.0f) ++hot;
      }
      hot_rows_[s] = hot;
    }
  }

  void touch_ids_locked(size_t table, const int64_t* ids, int64_t k) {
    auto& t = sparse_touch_[table];
    for (int64_t r = 0; r < k; ++r) t[size_t(ids[r])] += 1.0f;
  }

  void touch_rows_locked(const std::vector<PartView>& parts) {
    bool any = false;
    size_t s = 0;
    for (size_t i = 0; i < parts.size(); ++i) {
      if (sparse_dim_[i] <= 0) continue;
      if (parts[i].sparse) {
        touch_ids_locked(s, parts[i].ids, parts[i].k);
        any = true;
      }
      ++s;
    }
    if (any) fold_touch_locked();
  }

  // caller holds meta_: one commit-log record + the exact staleness count.
  // `clock` is the commit's OWN post-increment clock, captured in the
  // critical section that advanced it — re-reading clock_ here would
  // misattribute records under concurrent commits
  void record_commit_locked(int64_t clock, int64_t worker, int64_t staleness,
                            int64_t t0_ns, int64_t dur_ns) {
    ++commits_;
    int slot = staleness < 0 ? 0
               : (staleness >= kStaleSlots ? kStaleSlots : int(staleness));
    ++stale_hist_[slot];
    CommitRecord r{clock, worker, staleness, t0_ns, dur_ns};
    size_t idx = size_t((log_head_ + log_count_) % kLogCapacity);
    commit_log_[idx] = r;
    if (log_count_ == kLogCapacity) {
      log_head_ = (log_head_ + 1) % kLogCapacity;
      ++log_dropped_;
    } else {
      ++log_count_;
    }
  }

  // -- apply primitives (stripe-locked) ---------------------------------------
  // scale*delta added leaf by leaf under that leaf's stripe lock: two
  // commits touching different leaves apply concurrently, same-leaf adds
  // serialize (adds commute, so order is the async-SGD tolerance class)
  void apply_views(const std::vector<PartView>& parts, float scale) {
    for (size_t i = 0; i < parts.size(); ++i) {
      std::lock_guard<std::mutex> s(stripes_[i % kStripes]);
      float* c = center_.data() + offsets_[i];
      const PartView& p = parts[i];
      if (p.sparse) {
        int64_t dim = sparse_dim_[i];
        for (int64_t r = 0; r < p.k; ++r) {
          float* row = c + p.ids[r] * dim;
          const float* g = p.vals + r * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += scale * g[j];
        }
      } else {
        for (int64_t j = 0; j < sizes_[i]; ++j) c[j] += scale * p.vals[j];
      }
    }
  }

  void apply_owned(const std::vector<OwnedPart>& parts) {
    for (size_t i = 0; i < parts.size(); ++i) {
      std::lock_guard<std::mutex> s(stripes_[i % kStripes]);
      float* c = center_.data() + offsets_[i];
      const OwnedPart& p = parts[i];
      if (p.sparse) {
        int64_t dim = sparse_dim_[i];
        for (size_t r = 0; r < p.ids.size(); ++r) {
          float* row = c + p.ids[r] * dim;
          const float* g = p.vals.data() + int64_t(r) * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += g[j];
        }
      } else {
        for (int64_t j = 0; j < sizes_[i]; ++j) c[j] += p.vals[j];
      }
    }
  }

  // center += flat (the replicated path: the center applies EXACTLY the
  // bytes the R frame carries, so primary and replica perform identical
  // float additions — Python's `c += full` materialized-delta idiom)
  void add_from_flat(const float* flat) {
    for (size_t i = 0; i < sizes_.size(); ++i) {
      std::lock_guard<std::mutex> s(stripes_[i % kStripes]);
      float* c = center_.data() + offsets_[i];
      const float* d = flat + offsets_[i];
      for (int64_t j = 0; j < sizes_[i]; ++j) c[j] += d[j];
    }
  }

  // scaled center-shaped materialization of one commit (replication)
  void materialize_views(const std::vector<PartView>& parts, float scale,
                         float* flat) {
    for (size_t i = 0; i < parts.size(); ++i) {
      float* d = flat + offsets_[i];
      const PartView& p = parts[i];
      if (p.sparse) {
        int64_t dim = sparse_dim_[i];
        for (int64_t r = 0; r < p.k; ++r) {
          float* row = d + p.ids[r] * dim;
          const float* g = p.vals + r * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += scale * g[j];
        }
      } else {
        for (int64_t j = 0; j < sizes_[i]; ++j) d[j] += scale * p.vals[j];
      }
    }
  }

  void materialize_owned(const std::vector<OwnedPart>& parts, float* flat) {
    for (size_t i = 0; i < parts.size(); ++i) {
      float* d = flat + offsets_[i];
      const OwnedPart& p = parts[i];
      if (p.sparse) {
        int64_t dim = sparse_dim_[i];
        for (size_t r = 0; r < p.ids.size(); ++r) {
          float* row = d + p.ids[r] * dim;
          const float* g = p.vals.data() + int64_t(r) * dim;
          for (int64_t j = 0; j < dim; ++j) row[j] += g[j];
        }
      } else {
        for (int64_t j = 0; j < sizes_[i]; ++j) d[j] += p.vals[j];
      }
    }
  }

  // -- the ONE commit dispatch (plain or adaptive) ----------------------------
  void commit_parts(const std::vector<PartView>& parts,
                    int64_t* last_pull_clock, int64_t worker,
                    int64_t wire_bytes, int64_t rows_committed,
                    int64_t wire_saved) {
    if (adaptive_) {
      CommitEntry entry{&parts, *last_pull_clock, worker, wire_bytes,
                        rows_committed, wire_saved};
      commit_adaptive(entry);
      *last_pull_clock = entry.rebased_lpc;
      return;
    }
    std::shared_lock<std::shared_mutex> g(gate_);
    bool replicate;
    int64_t staleness, commit_clock;
    double dscale;
    {
      std::lock_guard<std::mutex> m(meta_);
      if (*last_pull_clock < clock_fence_) {
        *last_pull_clock = clock_fence_;
        ++fenced_commits_;
      }
      staleness = clock_ - *last_pull_clock;
      dscale = commit_scale_locked(staleness);
      replicate = feed_ && feed_->count_.load() > 0;
      ++clock_;
      commit_clock = clock_;
    }
    float scale = float(dscale);
    int64_t t0 = mono_ns();
    bool sparse_commit = false;
    for (const PartView& p : parts)
      if (p.sparse) {
        sparse_commit = true;
        break;
      }
    // a row-sparse commit applies in its native form (touched rows only,
    // the Python hub's idiom) and is FRAMED sparse for capable replicas;
    // the center-shaped materialization now exists only when a legacy
    // (dense-stream) replica is actually attached.  Dense commits keep
    // the dense path byte for byte
    bool need_dense =
        replicate && (!sparse_commit || feed_->dense_count_.load() > 0);
    std::vector<float> repl;
    if (sparse_commit) {
      apply_views(parts, scale);
      if (need_dense) {
        repl.assign(center_.size(), 0.0f);
        materialize_views(parts, scale, repl.data());
      }
    } else if (replicate) {
      repl.assign(center_.size(), 0.0f);
      materialize_views(parts, scale, repl.data());
      add_from_flat(repl.data());
    } else {
      apply_views(parts, scale);
    }
    int64_t dur = mono_ns() - t0;
    {
      std::lock_guard<std::mutex> m(meta_);
      record_commit_locked(commit_clock, worker, staleness, t0, dur);
      commit_bytes_ += wire_bytes;
      sparse_rows_committed_ += rows_committed;
      sparse_wire_saved_ += wire_saved;
      if (sparse_commit)
        touch_rows_locked(parts);
    }
    g.unlock();
    // the ack leaves only after this returns — the acked-commit-is-
    // kernel-owned replication contract (publish before ack)
    if (replicate) {
      ReplFeed::SparseSrc sp;
      if (sparse_commit) {
        sp.views = &parts;
        sp.scale = scale;
      }
      feed_->publish(commit_clock, need_dense ? repl.data() : nullptr,
                     sparse_commit ? &sp : nullptr);
    }
    num_updates_.fetch_add(1);
  }

  // flat-combining submit: enqueue, race for the drain lock, the winner
  // takes everything queued as one batch (Python _AdaptiveCombiner.commit)
  void commit_adaptive(CommitEntry& entry) {
    {
      std::lock_guard<std::mutex> q(comb_qlock_);
      comb_queue_.push_back(&entry);
    }
    std::lock_guard<std::mutex> d(comb_drain_);
    if (entry.done) return;  // a predecessor's batch already applied us
    std::vector<CommitEntry*> batch;
    {
      std::lock_guard<std::mutex> q(comb_qlock_);
      batch.swap(comb_queue_);
    }
    apply_batch(batch);
  }

  void apply_batch(std::vector<CommitEntry*>& batch) {
    std::shared_lock<std::shared_mutex> g(gate_);
    size_t K = batch.size();
    bool replicate;
    int64_t clock0, commit_clock;
    std::vector<double> dscales(K);
    int64_t t0 = mono_ns();
    {
      std::lock_guard<std::mutex> m(meta_);
      replicate = feed_ && feed_->count_.load() > 0;
      clock0 = clock_;
      for (size_t i = 0; i < K; ++i) {
        CommitEntry* e = batch[i];
        int64_t lpc = e->lpc;
        if (lpc < clock_fence_) {
          lpc = clock_fence_;
          ++fenced_commits_;
        }
        e->rebased_lpc = lpc;
        e->staleness = clock0 - lpc;
        dscales[i] = commit_scale_locked(e->staleness) * rate_scale(e->worker);
      }
      // a batch of K still advances the clock by K: staleness
      // bookkeeping, elastic denominators and the failover bound keep
      // their meaning (all members see the same base clock)
      clock_ += int64_t(K);
      commit_clock = clock_;
      ++merge_batches_;
      if (int64_t(K) > max_merge_batch_) max_merge_batch_ = int64_t(K);
      if (K > 1) merged_commits_ += int64_t(K) - 1;
      int slot = K >= size_t(kStaleSlots) ? kStaleSlots : int(K);
      ++merge_hist_[slot];
    }
    // scale each member by its own commit_scale x adaptive rate (owned
    // copies — the submitters' views alias their receive buffers)
    std::vector<std::vector<OwnedPart>> scaled(K);
    for (size_t i = 0; i < K; ++i) {
      const std::vector<PartView>& src = *batch[i]->parts;
      float fs = float(dscales[i]);
      scaled[i].resize(src.size());
      for (size_t l = 0; l < src.size(); ++l) {
        OwnedPart& o = scaled[i][l];
        o.sparse = src[l].sparse;
        if (o.sparse) {
          o.ids.assign(src[l].ids, src[l].ids + src[l].k);
          int64_t nv = src[l].k * sparse_dim_[l];
          o.vals.resize(size_t(nv));
          for (int64_t j = 0; j < nv; ++j) o.vals[j] = fs * src[l].vals[j];
        } else {
          o.vals.resize(size_t(sizes_[l]));
          for (int64_t j = 0; j < sizes_[l]; ++j)
            o.vals[j] = fs * src[l].vals[j];
        }
      }
    }
    // one Adasum tree merge for the batch — or sequential application for
    // a batch of one and the RARE mixed dense/sparse batch (merging the
    // latter would densify whole tables under the apply)
    std::vector<std::vector<OwnedPart>> applied;
    if (K > 1 && !mixed_repr(scaled)) {
      applied.push_back(adasum_merge(scaled, sparse_dim_.data()));
    } else {
      applied = std::move(scaled);
    }
    // ONE applied commit (uncontended, or the whole batch Adasum-merged)
    // that carries row-sparse parts applies sparse and streams as a
    // kReplSparse row-union frame; the dense materialization exists only
    // for the RARE sequential batch or an attached legacy replica
    bool sparse_single = false;
    if (applied.size() == 1)
      for (const OwnedPart& p : applied[0])
        if (p.sparse) {
          sparse_single = true;
          break;
        }
    bool need_dense =
        replicate && (!sparse_single || feed_->dense_count_.load() > 0);
    std::vector<float> repl;
    if (sparse_single) {
      apply_owned(applied[0]);
      if (need_dense) {
        repl.assign(center_.size(), 0.0f);
        materialize_owned(applied[0], repl.data());
      }
    } else if (replicate) {
      repl.assign(center_.size(), 0.0f);
      for (const auto& parts : applied) materialize_owned(parts, repl.data());
      add_from_flat(repl.data());
    } else {
      for (const auto& parts : applied) apply_owned(parts);
    }
    int64_t dur = mono_ns() - t0;
    {
      std::lock_guard<std::mutex> m(meta_);
      for (CommitEntry* e : batch) {
        record_commit_locked(commit_clock, e->worker, e->staleness, t0, dur);
        commit_bytes_ += e->wire_bytes;
        sparse_rows_committed_ += e->rows_committed;
        sparse_wire_saved_ += e->wire_saved;
        touch_rows_locked(*e->parts);
      }
    }
    g.unlock();
    // ONE R frame for the whole batch at its final clock, before any
    // member is acked.  Like the Python hub, publish happens after the
    // apply lock is released: cross-thread publish-order inversions only
    // reorder float additions (the feed's documented tolerance class)
    if (replicate) {
      ReplFeed::SparseSrc sp;
      if (sparse_single) sp.owned = &applied[0];
      feed_->publish(commit_clock, need_dense ? repl.data() : nullptr,
                     sparse_single ? &sp : nullptr);
    }
    num_updates_.fetch_add(int64_t(K));
    for (CommitEntry* e : batch) e->done = true;
  }

  // -- standby (replica_of) ---------------------------------------------------
  // wire-side split-brain guard: 0 = proceed (possibly just promoted),
  // 1 = drop the connection (commit refused).  Mirrors the Python hub's
  // _standby_commit_gate: a never-synced standby has nothing to take
  // over; a synced one with a CONNECTED feed severs it as a probe (a
  // live primary resyncs, a dead one fails the feed loop's reconnects
  // and promotes); a synced one with the feed already down promotes NOW
  int standby_commit_gate_wire() {
    if (!standby_.load()) return 0;
    if (!synced_.load()) return 1;
    int fd = replica_fd_.load();
    if (fd >= 0) {
      ::shutdown(fd, SHUT_RDWR);
      return 1;
    }
    promote();
    return 0;
  }

  // track the primary: connect, hello, apply the full sync then every
  // streamed delta under the write gate.  On feed loss, retry within
  // replica_retries_ (exponential backoff); once the budget is gone a
  // SYNCED standby promotes itself — a never-synced one keeps retrying
  // (promoting fresh init weights would discard the job)
  void replica_loop() {
    // a sparse-capable standby (this hub serves row-sparse tables)
    // announces kReplCapSparse and must parse VARIABLE-size kReplSparse
    // frames; a dense hub keeps the fixed-size stream byte for byte
    bool sparse_feed = !sparse_leaves_.empty();
    size_t expect = size_t(dense_payload_f32_) + 17;  // + (8 + 9) hdr blob
    size_t feed_limit = expect;
    for (int leaf : sparse_leaves_)
      feed_limit +=
          8 + 8 * size_t(sizes_[size_t(leaf)] / sparse_dim_[size_t(leaf)]);
    std::vector<unsigned char> frame(sparse_feed ? size_t(4096) : expect);
    std::vector<std::pair<const unsigned char*, uint64_t>> fblobs;
    std::vector<int64_t> fids;
    int failures = 0;
    while (!replica_stop_.load()) {
      int fd = connect_to(replica_host_.c_str(), replica_port_, 5000);
      if (fd >= 0 && replica_stop_.load()) {
        ::close(fd);
        return;
      }
      if (fd >= 0) {
        replica_fd_.store(fd);
        size_t hdr_len = sparse_feed ? 10 : 9;
        unsigned char hello[8 + 5 + 8 + 10];
        size_t hello_len = 8 + 5 + 8 + hdr_len;
        be64_encode(5 + 8 + hdr_len, hello);
        hello[8] = 'R';
        be32_encode(1, hello + 9);
        be64_encode(hdr_len, hello + 13);
        int64_t my_clock;
        {
          std::lock_guard<std::mutex> m(meta_);
          my_clock = clock_;
        }
        be64_encode(uint64_t(my_clock), hello + 21);
        hello[29] = (unsigned char)kReplHello;
        if (sparse_feed) hello[30] = (unsigned char)kReplCapSparse;
        bool ok = write_all(fd, hello, hello_len);
        while (ok && !replica_stop_.load()) {
          unsigned char hdr[8];
          if (!read_exact(fd, hdr, 8)) break;
          uint64_t n = be64_decode(hdr);
          if (sparse_feed ? (n > feed_limit || n < 22) : (n != expect))
            break;  // protocol: desync
          if (frame.size() < n) frame.resize(size_t(n));
          if (!read_exact(fd, frame.data(), size_t(n))) break;
          if (frame[0] != 'R') break;
          if (be64_decode(frame.data() + 5) != 9) break;
          int64_t fclock = int64_t(be64_decode(frame.data() + 13));
          int kind = frame[21];
          uint32_t nblobs = be32_decode(frame.data() + 1);
          if (kind == kReplSparse) {
            if (!sparse_feed) break;  // never announced the capability
            if (nblobs != 1 + sizes_.size() + sparse_leaves_.size()) break;
            if (!parse_blob_table(frame.data(), n, fblobs)) break;
          } else {
            // SYNC/DELTA are FIXED-size frames: pin the length exactly
            // (the dense apply loops below walk per-leaf prefixes
            // without re-bounding against n — a short frame must never
            // reach them)
            if (n != expect) break;
            if (nblobs != 1 + sizes_.size()) break;
          }
          const unsigned char* p = frame.data() + 22;
          {
            std::unique_lock<std::shared_mutex> g(gate_);
            std::lock_guard<std::mutex> m(meta_);
            if (promoted_flag_.load()) {
              replica_fd_.store(-1);
              ::close(fd);
              return;  // late frame post-promotion: never lands
            }
            if (kind == kReplSync) {
              float* c = center_.data();
              for (size_t i = 0; i < sizes_.size(); ++i) {
                if (be64_decode(p) != uint64_t(sizes_[i]) * 4) { ok = false; break; }
                std::memcpy(c + offsets_[i], p + 8, size_t(sizes_[i]) * 4);
                p += 8 + size_t(sizes_[i]) * 4;
              }
              if (!ok) break;
              clock_ = fclock;
              num_updates_.store(fclock);
              synced_.store(true);
            } else if (kind == kReplDelta) {
              float* c = center_.data();
              for (size_t i = 0; i < sizes_.size(); ++i) {
                if (be64_decode(p) != uint64_t(sizes_[i]) * 4) { ok = false; break; }
                const float* d = reinterpret_cast<const float*>(p + 8);
                float* dst = c + offsets_[i];
                for (int64_t j = 0; j < sizes_[i]; ++j) dst[j] += d[j];
                p += 8 + size_t(sizes_[i]) * 4;
              }
              if (!ok) break;
              if (fclock > clock_) clock_ = fclock;
              num_updates_.fetch_add(1);
            } else if (kind == kReplSparse) {
              // row-delta apply: center[ids] += rows for sparse leaves,
              // whole-leaf adds for dense ones (the U-commit layout
              // past the header blob)
              size_t b = 1;
              float* c = center_.data();
              for (size_t i = 0; ok && i < sizes_.size(); ++i) {
                if (sparse_dim_[i] > 0) {
                  uint64_t idb = fblobs[b].second;
                  if (idb % 8 != 0) { ok = false; break; }
                  int64_t k = int64_t(idb / 8);
                  fids.resize(size_t(k));
                  std::memcpy(fids.data(), fblobs[b].first, size_t(k) * 8);
                  if (!check_row_ids(fids.data(), k, i)) { ok = false; break; }
                  int64_t dim = sparse_dim_[i];
                  if (fblobs[b + 1].second != uint64_t(k * dim) * 4) {
                    ok = false;
                    break;
                  }
                  const float* rows =
                      reinterpret_cast<const float*>(fblobs[b + 1].first);
                  float* dst = c + offsets_[i];
                  for (int64_t r = 0; r < k; ++r) {
                    float* row = dst + fids[size_t(r)] * dim;
                    const float* gsrc = rows + r * dim;
                    for (int64_t j = 0; j < dim; ++j) row[j] += gsrc[j];
                  }
                  b += 2;
                } else {
                  if (fblobs[b].second != uint64_t(sizes_[i]) * 4) {
                    ok = false;
                    break;
                  }
                  const float* d =
                      reinterpret_cast<const float*>(fblobs[b].first);
                  float* dst = c + offsets_[i];
                  for (int64_t j = 0; j < sizes_[i]; ++j) dst[j] += d[j];
                  b += 1;
                }
              }
              if (!ok) break;
              if (fclock > clock_) clock_ = fclock;
              num_updates_.fetch_add(1);
            } else {
              break;
            }
            ++repl_frames_;
          }
          failures = 0;  // a live stream resets the loss budget
        }
        replica_fd_.store(-1);
        ::close(fd);
      }
      if (replica_stop_.load() || promoted_flag_.load()) return;
      ++failures;
      if (failures > replica_retries_) {
        if (synced_.load()) {
          promote();  // primary presumed dead: take over behind the fence
          return;
        }
        failures = replica_retries_;  // never synced: cap backoff, keep trying
      }
      int64_t wait_ms = int64_t(replica_backoff_ms_) << (failures - 1);
      int64_t waited = 0;
      while (waited < wait_ms && !replica_stop_.load()) {
        struct timespec ts{0, 20 * 1000 * 1000};
        nanosleep(&ts, nullptr);
        waited += 20;
      }
    }
  }

  // -- reconnect backpressure (actions G/Y) -----------------------------------
  // every hub answers G; only an adaptive hub in a live storm hints
  // nonzero, and only to announcers that have not already waited a slot
  // this episode — Python's _retry_after_ms verbatim
  int64_t retry_after_ms(int64_t waits_taken) {
    if (!adaptive_) return 0;
    int64_t now = mono_ns();
    std::lock_guard<std::mutex> g(bp_mtx_);
    if (waits_taken <= 0) hello_times_.push_back(now);
    while (!hello_times_.empty() &&
           now - hello_times_.front() > storm_window_ns_)
      hello_times_.pop_front();
    if (now >= storm_until_ns_ &&
        int64_t(hello_times_.size()) >= int64_t(storm_hellos_)) {
      storm_until_ns_ = now + storm_shed_ns_;
      retry_seq_ = 0;
    }
    int64_t hint = 0;
    if (now < storm_until_ns_ && waits_taken <= 0) {
      ++retry_seq_;
      hint = std::min<int64_t>(retry_cap_ms_,
                               int64_t(retry_base_ms_) * retry_seq_);
      std::lock_guard<std::mutex> m(meta_);
      ++backpressure_hints_;
    }
    return hint;
  }

  // -- serving loop -----------------------------------------------------------
  void accept_loop() {
    while (running_.load()) {
      int fd = ::accept(listen_fd_.load(), nullptr, nullptr);
      if (fd < 0) break;  // listener shut down by stop()
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      // kernel buffers sized to one full weights/commit frame (clamped to
      // [64 KiB, 8 MiB], matching networking.configure_socket)
      int64_t want = 8 + dense_payload_f32_ + 4096;
      int bufsz = int(std::min<int64_t>(std::max<int64_t>(want, 64 << 10), 8 << 20));
      ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
      ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
      if (idle_timeout_ms_ > 0) {
        // half-open liveness both directions (Python's conn.settimeout)
        timeval tv{};
        tv.tv_sec = idle_timeout_ms_ / 1000;
        tv.tv_usec = (idle_timeout_ms_ % 1000) * 1000;
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      }
      std::lock_guard<std::mutex> g(conn_mutex_);
      conn_fds_.push_back(fd);
      handler_threads_.emplace_back([this, fd] { handle_connection(fd); });
    }
    // NO close here: a spontaneous accept() failure (EMFILE storm)
    // exits this loop while stop() may still be about to shutdown the
    // fd it loaded — stop() owns the close, after joining this thread
  }

  // -- payload parsing --------------------------------------------------------
  bool parse_blob_table(const unsigned char* payload, uint64_t n,
                        std::vector<std::pair<const unsigned char*, uint64_t>>&
                            blobs) {
    if (n < 5) return false;
    uint32_t count = be32_decode(payload + 1);
    blobs.clear();
    uint64_t off = 5;
    for (uint32_t i = 0; i < count; ++i) {
      if (off + 8 > n) return false;
      uint64_t nbytes = be64_decode(payload + off);
      off += 8;
      if (off + nbytes > n) return false;
      blobs.emplace_back(payload + off, nbytes);
      off += nbytes;
    }
    return off == n;
  }

  // int64 row ids: in-bounds, strictly ascending (sorted AND unique — what
  // makes the fancy-indexed row apply exact), the Python _check_row_ids
  bool check_row_ids(const int64_t* ids, int64_t k, size_t leaf) {
    if (k == 0) return true;
    int64_t rows = sizes_[leaf] / sparse_dim_[leaf];
    if (ids[0] < 0 || ids[k - 1] >= rows) return false;
    for (int64_t r = 1; r < k; ++r)
      if (ids[r] <= ids[r - 1]) return false;
    return true;
  }

  // 'C'/'Q' payload -> dense PartViews (Q dequantized into qbuf, identical
  // math to the Python hub's _decode_qdelta: float(int8) * scale)
  bool parse_dense_commit(const unsigned char* payload, uint64_t n,
                          bool quantized, std::vector<float>& qbuf,
                          std::vector<std::pair<const unsigned char*, uint64_t>>& blobs,
                          std::vector<PartView>& parts) {
    if (!parse_blob_table(payload, n, blobs)) return false;
    if (blobs.size() != sizes_.size()) return false;
    parts.assign(sizes_.size(), PartView{});
    if (quantized) {
      int64_t total = 0;
      for (int64_t s : sizes_) total += s;
      qbuf.resize(size_t(total));
    }
    float* dst = qbuf.data();
    for (size_t i = 0; i < sizes_.size(); ++i) {
      if (quantized) {
        if (blobs[i].second != uint64_t(4 + sizes_[i])) return false;
        float scale = bef32_decode(blobs[i].first);
        const auto* q = reinterpret_cast<const signed char*>(blobs[i].first + 4);
        for (int64_t j = 0; j < sizes_[i]; ++j) dst[j] = float(q[j]) * scale;
        parts[i].vals = dst;
        dst += sizes_[i];
      } else {
        if (blobs[i].second != uint64_t(sizes_[i]) * 4) return false;
        parts[i].vals = reinterpret_cast<const float*>(blobs[i].first);
      }
    }
    return true;
  }

  // 'U'/'X' payload -> per-leaf PartViews: one blob for dense leaves, TWO
  // (ids, grads) for sparse leaves.  Row ids are copied into idsbuf (the
  // wire offset is unaligned); X value blobs dequantize into qbuf.
  bool parse_sparse_commit(const unsigned char* payload, uint64_t n,
                           bool quantized, std::vector<float>& qbuf,
                           std::vector<int64_t>& idsbuf,
                           std::vector<std::pair<const unsigned char*, uint64_t>>& blobs,
                           std::vector<PartView>& parts, int64_t* rows_out,
                           int64_t* wire_out) {
    if (!parse_blob_table(payload, n, blobs)) return false;
    if (blobs.size() != sizes_.size() + sparse_leaves_.size()) return false;
    // first pass: sizes (qbuf/idsbuf must not reallocate under pointers)
    size_t need_ids = 0, need_floats = 0, b = 0;
    int64_t wire = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      if (sparse_dim_[i] > 0) {
        uint64_t idb = blobs[b].second;
        if (idb % 8 != 0) return false;
        int64_t k = int64_t(idb / 8);
        wire += int64_t(idb);
        need_ids += size_t(k);
        uint64_t vb = blobs[b + 1].second;
        int64_t nv = k * sparse_dim_[i];
        if (quantized ? vb != uint64_t(4 + nv) : vb != uint64_t(nv) * 4)
          return false;
        wire += int64_t(vb);
        if (quantized) need_floats += size_t(nv);
        b += 2;
      } else {
        uint64_t vb = blobs[b].second;
        if (quantized ? vb != uint64_t(4 + sizes_[i])
                      : vb != uint64_t(sizes_[i]) * 4)
          return false;
        wire += int64_t(vb);
        if (quantized) need_floats += size_t(sizes_[i]);
        b += 1;
      }
    }
    idsbuf.resize(need_ids);
    qbuf.resize(need_floats);
    parts.assign(sizes_.size(), PartView{});
    int64_t* idst = idsbuf.data();
    float* dst = qbuf.data();
    int64_t rows = 0;
    b = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      if (sparse_dim_[i] > 0) {
        int64_t k = int64_t(blobs[b].second / 8);
        std::memcpy(idst, blobs[b].first, size_t(k) * 8);
        if (!check_row_ids(idst, k, i)) return false;
        parts[i].sparse = true;
        parts[i].ids = idst;
        parts[i].k = k;
        idst += k;
        rows += k;
        int64_t nv = k * sparse_dim_[i];
        if (quantized) {
          float scale = bef32_decode(blobs[b + 1].first);
          const auto* q =
              reinterpret_cast<const signed char*>(blobs[b + 1].first + 4);
          for (int64_t j = 0; j < nv; ++j) dst[j] = float(q[j]) * scale;
          parts[i].vals = dst;
          dst += nv;
        } else {
          parts[i].vals = reinterpret_cast<const float*>(blobs[b + 1].first);
        }
        b += 2;
      } else {
        if (quantized) {
          float scale = bef32_decode(blobs[b].first);
          const auto* q =
              reinterpret_cast<const signed char*>(blobs[b].first + 4);
          for (int64_t j = 0; j < sizes_[i]; ++j) dst[j] = float(q[j]) * scale;
          parts[i].vals = dst;
          dst += sizes_[i];
        } else {
          parts[i].vals = reinterpret_cast<const float*>(blobs[b].first);
        }
        b += 1;
      }
    }
    *rows_out = rows;
    *wire_out = wire;
    return true;
  }

  // -- replies ----------------------------------------------------------------
  bool send_weights(ConnIo& io, const float* snap) {
    std::vector<struct iovec> iov(1 + 2 * sizes_.size());
    iov[0].iov_base = w_hdr_.data();
    iov[0].iov_len = 13;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      iov[1 + 2 * i].iov_base = w_prefix_.data() + 8 * i;
      iov[1 + 2 * i].iov_len = 8;
      iov[2 + 2 * i].iov_base =
          const_cast<float*>(snap + offsets_[i]);
      iov[2 + 2 * i].iov_len = size_t(sizes_[i]) * 4;
    }
    return io_writev_all(io, iov.data(), int(iov.size()));
  }

  bool send_u64_reply(ConnIo& io, char action, uint64_t value) {
    unsigned char buf[8 + 5 + 8 + 8];
    be64_encode(5 + 8 + 8, buf);
    buf[8] = (unsigned char)action;
    be32_encode(1, buf + 9);
    be64_encode(8, buf + 13);
    be64_encode(value, buf + 21);
    return io_write_all(io, buf, sizeof(buf));
  }

  void handle_connection(int fd) {
    int64_t last_pull_clock;
    {
      std::lock_guard<std::mutex> m(meta_);
      last_pull_clock = clock_fence_;  // born-after-restore semantics
    }
    bool joined = false;
    bool handoff = false;   // socket ownership moved to the replication feed
    bool timed_out = false;
    int64_t ctx_worker = -1;
    int pending_acks = 0;
    std::vector<float> snapf(center_.size());
    std::vector<float> qbuf;
    std::vector<int64_t> idsbuf;
    std::vector<unsigned char> sp_tx;
    std::vector<std::pair<const unsigned char*, uint64_t>> blobs;
    std::vector<PartView> parts;
    // batched receive: one grow-once buffer, one recv() per wakeup — a
    // pipelined client's parked commit + pull request arrive together
    std::vector<unsigned char> rx(4096);
    size_t rx_begin = 0, rx_end = 0;
    // shm transport: after a completed 'Z' handshake the SAME
    // byte stream continues over this ring pair; every read/write below
    // routes through io so the switch is invisible to the protocol code
    ConnIo io{fd, nullptr, nullptr, idle_timeout_ms_, &running_};
    std::unique_ptr<ShmRing> shm_rx, shm_tx;

    auto flush_acks = [&]() -> bool {
      if (pending_acks == 0) return true;
      std::vector<unsigned char> acks(size_t(pending_acks) * 13);
      for (int i = 0; i < pending_acks; ++i) {
        unsigned char* p = acks.data() + size_t(i) * 13;
        be64_encode(5, p);
        p[8] = 'A';
        be32_encode(0, p + 9);
      }
      pending_acks = 0;
      return io_write_all(io, acks.data(), acks.size());
    };
    auto ensure = [&](size_t need) -> bool {
      while (rx_end - rx_begin < need) {
        // the client may be gating its next send on these acks
        // (max-inflight backpressure): never block in recv holding them
        if (!flush_acks()) return false;
        if (rx_begin + need > rx.size()) {
          std::memmove(rx.data(), rx.data() + rx_begin, rx_end - rx_begin);
          rx_end -= rx_begin;
          rx_begin = 0;
          if (need > rx.size()) rx.resize(need);
        }
        ssize_t r = io_recv_some(io, rx.data() + rx_end, rx.size() - rx_end,
                                 &timed_out);
        if (r <= 0) return false;
        rx_end += size_t(r);
      }
      return true;
    };

    while (running_.load()) {
      if (!ensure(8)) break;
      uint64_t n = be64_decode(rx.data() + rx_begin);
      if (n > max_payload_ || n < 5) break;  // garbage prefix: drop peer
      if (!ensure(8 + size_t(n))) break;
      const unsigned char* payload = rx.data() + rx_begin + 8;
      rx_begin += 8 + size_t(n);
      char action = char(payload[0]);

      if (action == 'P') {
        if (standby_.load() && !synced_.load()) break;  // no job state yet
        if (!flush_acks()) break;
        {
          // clock read and center snapshot are ONE consistent view: the
          // exclusive gate excludes every in-flight commit
          std::unique_lock<std::shared_mutex> g(gate_);
          {
            std::lock_guard<std::mutex> m(meta_);
            last_pull_clock = clock_;
            ++pulls_;
            pull_bytes_ += center_bytes_;
          }
          std::memcpy(snapf.data(), center_.data(),
                      center_.size() * sizeof(float));
        }
        if (!send_weights(io, snapf.data())) break;

      } else if (action == 'C' || action == 'Q') {
        if (!parse_dense_commit(payload, n, action == 'Q', qbuf, blobs, parts))
          break;
        if (standby_commit_gate_wire()) break;
        if (!joined) {
          joined = true;
          std::lock_guard<std::mutex> m(meta_);
          ++live_members_;
        }
        int64_t wire = int64_t(n) - 5 - 8 * int64_t(sizes_.size());
        commit_parts(parts, &last_pull_clock, ctx_worker, wire, 0, 0);
        ++pending_acks;

      } else if (action == 'U' || action == 'X') {
        if (sparse_leaves_.empty()) break;  // no sparse tables registered
        int64_t rows = 0, wire = 0;
        if (!parse_sparse_commit(payload, n, action == 'X', qbuf, idsbuf,
                                 blobs, parts, &rows, &wire))
          break;
        if (standby_commit_gate_wire()) break;
        if (!joined) {
          joined = true;
          std::lock_guard<std::mutex> m(meta_);
          ++live_members_;
        }
        // wire savings vs the like-for-like dense commit (the Python
        // hub's dense_equiv accounting: full f32 payload for U, full
        // int8 Q payload for X)
        int64_t dense_equiv =
            action == 'U' ? dense_payload_f32_ : q_payload_bytes_;
        int64_t saved = dense_equiv - wire;
        if (saved < 0) saved = 0;
        commit_parts(parts, &last_pull_clock, ctx_worker, wire, rows, saved);
        ++pending_acks;

      } else if (action == 'S') {
        if (sparse_leaves_.empty()) break;
        if (standby_.load() && !synced_.load()) break;
        if (!parse_blob_table(payload, n, blobs)) break;
        if (blobs.size() != sparse_leaves_.size()) break;
        // validate every table's ids before touching the center
        size_t need_ids = 0;
        bool bad = false;
        for (auto& bl : blobs) {
          if (bl.second % 8 != 0) { bad = true; break; }
          need_ids += size_t(bl.second / 8);
        }
        if (bad) break;
        idsbuf.resize(need_ids);
        int64_t* idst = idsbuf.data();
        std::vector<std::pair<const int64_t*, int64_t>> req(blobs.size());
        int64_t rows_pulled = 0;
        for (size_t s = 0; s < blobs.size(); ++s) {
          int64_t k = int64_t(blobs[s].second / 8);
          std::memcpy(idst, blobs[s].first, size_t(k) * 8);
          if (!check_row_ids(idst, k, size_t(sparse_leaves_[s]))) {
            bad = true;
            break;
          }
          req[s] = {idst, k};
          idst += k;
          rows_pulled += k;
        }
        if (bad) break;
        if (!flush_acks()) break;
        // V reply: one blob per CENTER leaf — full f32 leaf for dense,
        // the requested [k, dim] row block for sparse (VarFrameEncoder's
        // exact bytes), packed under the gate, sent after release
        uint64_t vpayload = 5;
        {
          size_t s = 0;
          for (size_t i = 0; i < sizes_.size(); ++i) {
            int64_t nb = sparse_dim_[i] > 0 ? req[s].second * sparse_dim_[i] * 4
                                            : sizes_[i] * 4;
            if (sparse_dim_[i] > 0) ++s;
            vpayload += 8 + uint64_t(nb);
          }
        }
        sp_tx.resize(8 + vpayload);
        int64_t raw_bytes = 0;
        {
          std::unique_lock<std::shared_mutex> g(gate_);
          unsigned char* p = sp_tx.data();
          be64_encode(vpayload, p);
          p[8] = 'V';
          be32_encode(uint32_t(sizes_.size()), p + 9);
          p += 13;
          size_t s = 0;
          for (size_t i = 0; i < sizes_.size(); ++i) {
            const float* c = center_.data() + offsets_[i];
            if (sparse_dim_[i] > 0) {
              int64_t dim = sparse_dim_[i];
              int64_t k = req[s].second;
              be64_encode(uint64_t(k * dim) * 4, p);
              p += 8;
              float* out = reinterpret_cast<float*>(p);
              for (int64_t r = 0; r < k; ++r)
                std::memcpy(out + r * dim, c + req[s].first[r] * dim,
                            size_t(dim) * 4);
              p += size_t(k * dim) * 4;
              raw_bytes += k * dim * 4;
              ++s;
            } else {
              be64_encode(uint64_t(sizes_[i]) * 4, p);
              p += 8;
              std::memcpy(p, c, size_t(sizes_[i]) * 4);
              p += size_t(sizes_[i]) * 4;
              raw_bytes += sizes_[i] * 4;
            }
          }
          {
            std::lock_guard<std::mutex> m(meta_);
            last_pull_clock = clock_;
            ++pulls_;
            pull_bytes_ += raw_bytes;  // raw tensor bytes, the dense basis
            sparse_rows_pulled_ += rows_pulled;
            int64_t saved =
                (8 + dense_payload_f32_) - int64_t(8 + vpayload);
            if (saved > 0) sparse_wire_saved_ += saved;
            for (size_t s = 0; s < req.size(); ++s)
              touch_ids_locked(s, req[s].first, req[s].second);
            fold_touch_locked();
          }
        }
        if (!io_write_all(io, sp_tx.data(), sp_tx.size())) break;

      } else if (action == 'H') {  // heartbeat: liveness proof, acked
        ++pending_acks;

      } else if (action == 'M') {
        // health report: park the JSON blob for the Python wrapper's
        // drain (runtime/native.py folds it into the HealthCollector);
        // malformed frames are ignored, never fatal — health must not
        // take down a training connection
        if (parse_blob_table(payload, n, blobs) && blobs.size() == 1) {
          std::lock_guard<std::mutex> m(meta_);
          if (health_ring_.size() >= kHealthRingCap) {
            health_ring_.pop_front();
            ++health_dropped_;
          }
          health_ring_.emplace_back(
              reinterpret_cast<const char*>(blobs[0].first),
              size_t(blobs[0].second));
        }
        ++pending_acks;

      } else if (action == 'T') {
        // trace-context announce: remember the worker for commit-log
        // attribution, reply with this hub's monotonic clock
        if (parse_blob_table(payload, n, blobs) && blobs.size() >= 1)
          ctx_worker = json_int_field(blobs[0].first, size_t(blobs[0].second),
                                      "worker_id", -1);
        if (!flush_acks()) break;
        if (!send_u64_reply(io, 'T', uint64_t(mono_ns()))) break;

      } else if (action == 'G') {
        // reconnect announce: answer with a retry-after hint (0 =
        // proceed); the blob carries the waits already taken this episode
        int64_t waits = 0;
        if (parse_blob_table(payload, n, blobs) && blobs.size() >= 1 &&
            blobs[0].second >= 8)
          waits = int64_t(be64_decode(blobs[0].first));
        if (!flush_acks()) break;
        if (!send_u64_reply(io, 'Y', uint64_t(retry_after_ms(waits)))) break;

      } else if (action == 'R') {
        // replica handshake: this peer is a hot standby, not a worker —
        // attach it to the replication feed and hand the socket over.
        // A 10th header byte (optional — legacy hellos are 9 bytes)
        // carries the standby's frame-kind capabilities
        if (io.rx) break;  // the feed owns a raw fd; no hello after attach
        if (!parse_blob_table(payload, n, blobs) || blobs.size() != 1 ||
            (blobs[0].second != 9 && blobs[0].second != 10))
          break;
        if (blobs[0].first[8] != kReplHello) break;
        int repl_caps = blobs[0].second >= 10 ? int(blobs[0].first[9]) : 0;
        if (!flush_acks()) break;
        {
          std::lock_guard<std::mutex> m(meta_);
          if (!feed_) feed_.reset(new ReplFeed(this));
        }
        {
          std::lock_guard<std::mutex> g(conn_mutex_);
          conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                          conn_fds_.end());
        }
        handoff = true;
        feed_->attach(fd, repl_caps);  // on failure attach closes the fd
        return;

      } else if (action == 'Z') {
        // shm attach handshake, resolved ENTIRELY inside this
        // dispatch arm: request (this frame) -> offer/decline + confirm
        // (both still over TCP) -> switch.  TCP FIFO makes the switch
        // point exact — the first post-confirm frame is already on the
        // ring — so the stream is never torn (the protocol model's
        // SHM_RULES walk every interleaving of this exchange)
        if (!parse_blob_table(payload, n, blobs) || blobs.size() != 1 ||
            blobs[0].second != 9)
          break;
        unsigned version = blobs[0].first[0];
        uint64_t cap_hint = be64_decode(blobs[0].first + 1);
        if (!flush_acks()) break;
        std::unique_ptr<ShmRing> cand_rx, cand_tx;
        std::string c2h_path, h2c_path;
        if (!shm_dir_.empty() && version == 1 && io.rx == nullptr) {
          char name[96];
          std::snprintf(name, sizeof(name), "/ring-%d-%llu", bound_port_,
                        (unsigned long long)shm_seq_.fetch_add(1));
          c2h_path = shm_dir_ + name + ".c2h";
          h2c_path = shm_dir_ + name + ".h2c";
          uint64_t cap = cap_hint;
          uint64_t floor_b = uint64_t(2) * uint64_t(8 + dense_payload_f32_);
          if (cap < floor_b) cap = floor_b;
          if (cap < (uint64_t(1) << 20)) cap = uint64_t(1) << 20;
          cand_rx.reset(ShmRing::create(c2h_path.c_str(), false, cap));
          if (cand_rx) cand_tx.reset(ShmRing::create(h2c_path.c_str(), true, cap));
          if (!cand_rx || !cand_tx) {  // dir vanished / ENOSPC -> decline
            cand_rx.reset();
            cand_tx.reset();
            ::unlink(c2h_path.c_str());
            ::unlink(h2c_path.c_str());
          }
        }
        bool offered = bool(cand_rx) && bool(cand_tx);
        {
          // offer: 'Z' + the two ring-file paths; decline: 'Z' + 0 blobs
          uint64_t zpay = 5;
          if (offered)
            zpay += 8 + c2h_path.size() + 8 + h2c_path.size();
          std::vector<unsigned char> zb(8 + size_t(zpay));
          be64_encode(zpay, zb.data());
          zb[8] = 'Z';
          be32_encode(offered ? 2u : 0u, zb.data() + 9);
          if (offered) {
            unsigned char* p = zb.data() + 13;
            be64_encode(c2h_path.size(), p);
            p += 8;
            std::memcpy(p, c2h_path.data(), c2h_path.size());
            p += c2h_path.size();
            be64_encode(h2c_path.size(), p);
            p += 8;
            std::memcpy(p, h2c_path.data(), h2c_path.size());
          }
          if (!io_write_all(io, zb.data(), zb.size())) {
            if (offered) {
              ::unlink(c2h_path.c_str());
              ::unlink(h2c_path.c_str());
            }
            break;
          }
        }
        if (!offered) continue;  // declined: the connection stays pure TCP
        // the next TCP frame MUST be the client's 'Z' confirm
        bool ok = ensure(8);
        bool attached = false;
        if (ok) {
          uint64_t n2 = be64_decode(rx.data() + rx_begin);
          ok = n2 >= 5 && n2 <= max_payload_ && ensure(8 + size_t(n2));
          if (ok) {
            const unsigned char* p2 = rx.data() + rx_begin + 8;
            rx_begin += 8 + size_t(n2);
            ok = char(p2[0]) == 'Z' && parse_blob_table(p2, n2, blobs) &&
                 blobs.size() == 1 && blobs[0].second == 1;
            attached = ok && blobs[0].first[0] == 1;
          }
        }
        // ring files are transient rendezvous: unlink as soon as the
        // handshake resolves — live mappings keep the memory alive
        ::unlink(c2h_path.c_str());
        ::unlink(h2c_path.c_str());
        if (!ok) break;  // torn handshake: drop peer (rings unmap + wake)
        if (attached) {
          if (rx_end != rx_begin) break;  // frames batched past the confirm
          shm_rx = std::move(cand_rx);
          shm_tx = std::move(cand_tx);
          io.rx = shm_rx.get();
          io.tx = shm_tx.get();
        }
        // confirm=0 (client mmap failed): rings destruct, stay on TCP

      } else {  // 'B' or unknown -> close
        break;
      }
    }
    if (timed_out) {
      std::lock_guard<std::mutex> m(meta_);
      ++idle_evictions_;
    }
    if (joined) {
      std::lock_guard<std::mutex> m(meta_);
      --live_members_;
    }
    if (!handoff) {
      ::close(fd);
      std::lock_guard<std::mutex> g(conn_mutex_);
      conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                      conn_fds_.end());
    }
  }

  // -- configuration ----------------------------------------------------------
  int requested_port_;
  int bound_port_ = -1;
  int mode_;
  int num_workers_;
  bool elastic_;
  bool adaptive_;
  int idle_timeout_ms_;
  uint64_t max_payload_ = 0;
  std::vector<int64_t> sizes_;
  std::vector<int64_t> offsets_;
  std::vector<int64_t> sparse_dim_;  // per leaf; 0 = dense
  std::vector<int> sparse_leaves_;   // ascending sparse leaf indices
  int64_t center_bytes_ = 0;
  int64_t dense_payload_f32_ = 0;  // payload bytes of a full f32 frame
  int64_t q_payload_bytes_ = 0;    // payload bytes of a full int8 Q commit
  std::vector<unsigned char> w_hdr_;     // prebuilt 'W' header (13 bytes)
  std::vector<unsigned char> w_prefix_;  // prebuilt per-tensor prefixes

  // -- center + clocks --------------------------------------------------------
  std::vector<float> center_;
  std::shared_mutex gate_;           // commits shared / snapshots exclusive
  std::mutex stripes_[kStripes];     // per-leaf-group apply locks
  std::mutex meta_;                  // clock, fence, counters, log, ring
  int64_t clock_ = 0;
  int64_t clock_fence_ = 0;
  std::atomic<int64_t> num_updates_{0};

  // -- telemetry (guarded by meta_) -------------------------------------------
  int64_t commits_ = 0, pulls_ = 0;
  int64_t commit_bytes_ = 0, pull_bytes_ = 0;
  int64_t fenced_commits_ = 0, idle_evictions_ = 0;
  int live_members_ = 0;
  int64_t sparse_rows_pulled_ = 0, sparse_rows_committed_ = 0;
  int64_t sparse_wire_saved_ = 0;
  int64_t repl_sparse_bytes_ = 0, repl_sparse_saved_ = 0;
  std::vector<std::vector<float>> sparse_touch_;  // per table, per row
  std::vector<int64_t> hot_rows_;                 // per table, decayed est.
  int64_t touch_folds_ = 0;
  int64_t replicas_attached_ = 0, replica_disconnects_ = 0;
  int64_t merge_batches_ = 0, merged_commits_ = 0, max_merge_batch_ = 0;
  int64_t backpressure_hints_ = 0;
  int64_t repl_frames_ = 0, promotions_ = 0;
  int64_t health_dropped_ = 0;
  int64_t promoted_at_clock_ = -1;
  int64_t stale_hist_[kStaleSlots + 1] = {};
  int64_t merge_hist_[kStaleSlots + 1] = {};
  std::vector<CommitRecord> commit_log_ =
      std::vector<CommitRecord>(size_t(kLogCapacity));
  int64_t log_head_ = 0, log_count_ = 0, log_dropped_ = 0;
  std::deque<std::string> health_ring_;

  // -- adaptive state ---------------------------------------------------------
  std::mutex comb_qlock_, comb_drain_;
  std::vector<CommitEntry*> comb_queue_;
  std::mutex rate_mtx_;
  std::unordered_map<int64_t, std::pair<double, int64_t>> rate_scales_;
  std::mutex bp_mtx_;
  std::deque<int64_t> hello_times_;
  int64_t storm_until_ns_ = 0;
  int64_t retry_seq_ = 0;
  int storm_hellos_ = 3;               // SocketParameterServer.STORM_HELLOS
  int64_t storm_window_ns_ = 5000000000;   // STORM_WINDOW_S
  int64_t storm_shed_ns_ = 3000000000;     // STORM_SHED_S
  int retry_base_ms_ = 50, retry_cap_ms_ = 2000;

  // -- replication ------------------------------------------------------------
  std::unique_ptr<ReplFeed> feed_;  // created under meta_ on first hello
  std::string replica_host_;
  int replica_port_ = -1;
  int replica_retries_ = 3;
  int replica_backoff_ms_ = 200;
  std::atomic<int> replica_fd_{-1};
  std::atomic<bool> replica_stop_{false};
  std::atomic<bool> standby_{false};
  std::atomic<bool> promoted_flag_{false};
  std::atomic<bool> synced_{false};
  std::atomic<bool> stopped_{false};
  std::mutex stop_mtx_;  // serializes concurrent stop() teardowns (join is UB twice)
  std::thread replica_thread_;

  // -- shm transport ----------------------------------------------------------
  std::string shm_dir_;               // empty = never offer the 'Z' attach
  std::atomic<uint64_t> shm_seq_{0};  // ring-file name uniquifier

  // -- serving ----------------------------------------------------------------
  std::atomic<bool> running_{false};
  std::atomic<int> listen_fd_{-1};
  std::thread accept_thread_;
  std::mutex conn_mutex_;
  std::vector<int> conn_fds_;
  std::vector<std::thread> handler_threads_;
};

}  // namespace

extern "C" {

void* dk_ps_create(int port, int num_tensors, const int64_t* sizes, int mode,
                   int num_workers, int elastic, int idle_timeout_ms,
                   int num_sparse, const int32_t* sparse_leaves,
                   const int64_t* sparse_dims, int adaptive,
                   int64_t max_payload) {
  return new ParameterServer(port, num_tensors, sizes, mode, num_workers,
                             elastic, idle_timeout_ms, num_sparse,
                             sparse_leaves, sparse_dims, adaptive,
                             max_payload);
}

void dk_ps_set_replica_of(void* ps, const char* host, int port, int retries,
                          int backoff_ms) {
  static_cast<ParameterServer*>(ps)->set_replica_of(host, port, retries,
                                                    backoff_ms);
}

int dk_ps_start(void* ps) { return static_cast<ParameterServer*>(ps)->start(); }
void dk_ps_stop(void* ps) { static_cast<ParameterServer*>(ps)->stop(); }
void dk_ps_get_weights(void* ps, float* out) {
  static_cast<ParameterServer*>(ps)->get_weights(out);
}
void dk_ps_set_weights(void* ps, const float* in) {
  static_cast<ParameterServer*>(ps)->set_weights(in);
}
int64_t dk_ps_num_updates(void* ps) {
  return static_cast<ParameterServer*>(ps)->num_updates();
}
int dk_ps_port(void* ps) { return static_cast<ParameterServer*>(ps)->port(); }
int64_t dk_ps_pull(void* ps, float* out) {
  return static_cast<ParameterServer*>(ps)->pull_direct(out);
}
int64_t dk_ps_snapshot(void* ps, float* out) {
  return static_cast<ParameterServer*>(ps)->snapshot_direct(out);
}
// 0 = applied, 1 = refused (never-synced standby), 2 = refused (standby
// probing a connected primary) — the wrapper raises on nonzero
int dk_ps_commit(void* ps, const float* flat, int64_t last_pull_clock) {
  return static_cast<ParameterServer*>(ps)->commit_direct(flat,
                                                          last_pull_clock);
}
int dk_ps_commit_ctx(void* ps, const float* flat, int64_t last_pull_clock,
                     int64_t worker) {
  return static_cast<ParameterServer*>(ps)->commit_direct(flat,
                                                          last_pull_clock,
                                                          worker);
}
// sparse direct pair: the S/V/U exchanges minus the frame —
// ids/counts concatenate each sparse table's sorted-unique row ids in
// sparse-leaf order; values concatenate per-leaf payloads in template
// order (dense whole, sparse [k, dim]).  GIL released by ctypes.
int64_t dk_ps_pull_sparse(void* ps, const int64_t* ids, const int64_t* counts,
                          float* out) {
  return static_cast<ParameterServer*>(ps)->pull_sparse_direct(ids, counts,
                                                               out);
}
int dk_ps_commit_sparse(void* ps, const float* vals, const int64_t* ids,
                        const int64_t* counts, int64_t last_pull_clock,
                        int64_t worker) {
  return static_cast<ParameterServer*>(ps)->commit_sparse_direct(
      vals, ids, counts, last_pull_clock, worker);
}
void dk_ps_hot_rows(void* ps, int64_t* out) {
  static_cast<ParameterServer*>(ps)->hot_rows(out);
}
void dk_ps_stats(void* ps, int64_t* out) {
  static_cast<ParameterServer*>(ps)->stats(out);
}
void dk_ps_staleness_hist(void* ps, int64_t* out65) {
  static_cast<ParameterServer*>(ps)->staleness_hist(out65);
}
void dk_ps_merge_hist(void* ps, int64_t* out65) {
  static_cast<ParameterServer*>(ps)->merge_hist(out65);
}
int64_t dk_ps_drain_commits(void* ps, int64_t* out, int64_t max_records) {
  return static_cast<ParameterServer*>(ps)->drain_commits(out, max_records);
}
int64_t dk_ps_next_health(void* ps, unsigned char* out, int64_t cap) {
  return static_cast<ParameterServer*>(ps)->next_health(out, cap);
}
void dk_ps_set_rate_scale(void* ps, int64_t worker, double scale,
                          int64_t expires_ns) {
  static_cast<ParameterServer*>(ps)->set_rate_scale(worker, scale, expires_ns);
}
void dk_ps_set_storm_params(void* ps, int hellos, int window_ms, int shed_ms,
                            int base_ms, int cap_ms) {
  static_cast<ParameterServer*>(ps)->set_storm_params(hellos, window_ms,
                                                      shed_ms, base_ms,
                                                      cap_ms);
}
void dk_ps_arm_storm(void* ps) {
  static_cast<ParameterServer*>(ps)->arm_storm();
}
int dk_ps_is_standby(void* ps) {
  return static_cast<ParameterServer*>(ps)->is_standby() ? 1 : 0;
}
int dk_ps_promoted(void* ps) {
  return static_cast<ParameterServer*>(ps)->promoted() ? 1 : 0;
}
int64_t dk_ps_promoted_at_clock(void* ps) {
  return static_cast<ParameterServer*>(ps)->promoted_at_clock();
}
int dk_ps_promote(void* ps) {
  return static_cast<ParameterServer*>(ps)->promote() ? 1 : 0;
}
int dk_ps_wait_synced(void* ps, int64_t timeout_ms) {
  return static_cast<ParameterServer*>(ps)->wait_synced(timeout_ms) ? 1 : 0;
}
int64_t dk_ps_time_ns(void* ps) {
  return static_cast<ParameterServer*>(ps)->time_ns();
}
void dk_ps_restore(void* ps, const float* flat, int64_t clock,
                   int64_t num_updates) {
  static_cast<ParameterServer*>(ps)->restore(flat, clock, num_updates);
}
void dk_ps_destroy(void* ps) { delete static_cast<ParameterServer*>(ps); }

// -- shm transport ------------------------------------------------------------
// enable the hub's 'Z' attach path: rings are created under `dir` (empty
// or NULL disables).  Must be called before dk_ps_start.
void dk_ps_shm_attach(void* ps, const char* dir) {
  static_cast<ParameterServer*>(ps)->set_shm_dir(dir);
}

// standalone ring handles: the TSAN stress legs and the cross-language
// layout pin drive the EXACT ring code the hub serves with
void* dk_shm_ring_create(const char* path, int producer, uint64_t capacity) {
  return ShmRing::create(path, producer != 0, capacity);
}
void* dk_shm_ring_open(const char* path, int producer) {
  return ShmRing::open_existing(path, producer != 0);
}
// sendall semantics: n on success, -1 on peer-gone/timeout
long long dk_shm_ring_write(void* ring, const void* buf, long long n,
                            int timeout_ms) {
  auto* r = static_cast<ShmRing*>(ring);
  return r->write(static_cast<const unsigned char*>(buf), size_t(n),
                  timeout_ms, nullptr)
             ? n
             : -1;
}
// recv semantics: bytes read, 0 = clean EOF (producer closed + drained),
// -1 = timeout
long long dk_shm_ring_read(void* ring, void* buf, long long cap,
                           int timeout_ms) {
  auto* r = static_cast<ShmRing*>(ring);
  return (long long)r->read_some(static_cast<unsigned char*>(buf),
                                 size_t(cap), timeout_ms, nullptr, nullptr);
}
// raise only THIS side's closed flag (peer drains then sees EOF /
// peer-gone); the mapping stays valid until dk_shm_ring_destroy
void dk_shm_ring_close(void* ring) {
  auto* r = static_cast<ShmRing*>(ring);
  (r->producer_ ? r->producer_closed_ : r->consumer_closed_)
      ->store(1, std::memory_order_release);
}
// raise BOTH flags (wake a parked peer), unmap, free the handle
void dk_shm_ring_destroy(void* ring) { delete static_cast<ShmRing*>(ring); }

}  // extern "C"
