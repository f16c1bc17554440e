// ThreadSanitizer stress harness for the C++ PS hub.
//
// Compiled TOGETHER with ps_server.cpp under -fsanitize=thread by the
// slow/tsan-marked cell in tests/test_analysis.py, then run: a
// sparse+adaptive primary with a hot-standby replica, hammered
// concurrently by inproc committers, raw-socket pull/commit clients, a
// sparse S/V/U client, a G/Y backpressure client, M health reports, a
// telemetry poller, two shm-ring clients ('Z' handshake then P/C over
// shared memory) and a raw SPSC ring producer/consumer pair —
// every production path of the native hub under one data-race
// microscope.  Any TSAN report fails the test (the cell runs with
// TSAN_OPTIONS=exitcode=66 and greps stderr).
//
// The harness only uses the extern "C" API plus the public wire format
// (frames byte-identical to networking.encode_tensors), so it compiles
// against ps_server.cpp without any header.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* dk_ps_create(int port, int num_tensors, const int64_t* sizes, int mode,
                   int num_workers, int elastic, int idle_timeout_ms,
                   int num_sparse, const int32_t* sparse_leaves,
                   const int64_t* sparse_dims, int adaptive,
                   int64_t max_payload);
void dk_ps_set_replica_of(void* ps, const char* host, int port, int retries,
                          int backoff_ms);
int dk_ps_start(void* ps);
void dk_ps_stop(void* ps);
int64_t dk_ps_pull(void* ps, float* out);
int dk_ps_commit_ctx(void* ps, const float* flat, int64_t last_pull_clock,
                     int64_t worker);
void dk_ps_stats(void* ps, int64_t* out);
void dk_ps_staleness_hist(void* ps, int64_t* out65);
int64_t dk_ps_drain_commits(void* ps, int64_t* out, int64_t max_records);
int64_t dk_ps_next_health(void* ps, unsigned char* out, int64_t cap);
void dk_ps_set_rate_scale(void* ps, int64_t worker, double scale,
                          int64_t expires_ns);
int64_t dk_ps_num_updates(void* ps);
int64_t dk_ps_time_ns(void* ps);
int dk_ps_wait_synced(void* ps, int64_t timeout_ms);
int dk_ps_promoted(void* ps);
void dk_ps_destroy(void* ps);
// shm transport
void dk_ps_shm_attach(void* ps, const char* dir);
void* dk_shm_ring_create(const char* path, int producer, uint64_t capacity);
void* dk_shm_ring_open(const char* path, int producer);
long long dk_shm_ring_write(void* ring, const void* buf, long long n,
                            int timeout_ms);
long long dk_shm_ring_read(void* ring, void* buf, long long cap,
                           int timeout_ms);
void dk_shm_ring_close(void* ring);
void dk_shm_ring_destroy(void* ring);
}

namespace {

constexpr int64_t kSizes[2] = {32, 16 * 4};  // leaf 1 = 16x4 sparse table
constexpr int32_t kSparseLeaves[1] = {1};
constexpr int64_t kSparseDims[1] = {4};
constexpr int64_t kTotal = kSizes[0] + kSizes[1];

std::atomic<bool> g_stop{false};
std::atomic<int> g_errors{0};

void fail(const char* what) {
  std::fprintf(stderr, "harness error: %s\n", what);
  g_errors.fetch_add(1);
}

// -- minimal wire helpers (big-endian framing, encode_tensors layout) --------

void put_u64(std::string& b, uint64_t v) {
  for (int i = 7; i >= 0; --i) b.push_back(char((v >> (8 * i)) & 0xff));
}
void put_u32(std::string& b, uint32_t v) {
  for (int i = 3; i >= 0; --i) b.push_back(char((v >> (8 * i)) & 0xff));
}

std::string frame(char action, const std::vector<std::string>& blobs) {
  std::string payload;
  payload.push_back(action);
  put_u32(payload, uint32_t(blobs.size()));
  for (const auto& b : blobs) {
    put_u64(payload, b.size());
    payload += b;
  }
  std::string out;
  put_u64(out, payload.size());
  return out + payload;
}

bool send_all(int fd, const std::string& data) {
  size_t off = 0;
  while (off < data.size()) {
    ssize_t n = ::send(fd, data.data() + off, data.size() - off, 0);
    if (n <= 0) return false;
    off += size_t(n);
  }
  return true;
}

bool recv_all(int fd, char* out, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t r = ::recv(fd, out + off, n - off, 0);
    if (r <= 0) return false;
    off += size_t(r);
  }
  return true;
}

// receive one frame, returning just the action byte (payload discarded)
bool recv_frame_action(int fd, char* action) {
  char hdr[8];
  if (!recv_all(fd, hdr, 8)) return false;
  uint64_t len = 0;
  for (int i = 0; i < 8; ++i) len = (len << 8) | uint8_t(hdr[i]);
  if (len < 5 || len > (64u << 20)) return false;
  std::vector<char> payload(len);
  if (!recv_all(fd, payload.data(), len)) return false;
  *action = payload[0];
  return true;
}

// receive one frame keeping the whole payload (action + count + blobs) —
// the 'Z' handshake needs the offer's path blobs, not just the action byte
bool recv_frame(int fd, std::string* payload) {
  char hdr[8];
  if (!recv_all(fd, hdr, 8)) return false;
  uint64_t len = 0;
  for (int i = 0; i < 8; ++i) len = (len << 8) | uint8_t(hdr[i]);
  if (len < 5 || len > (64u << 20)) return false;
  payload->resize(len);
  return recv_all(fd, &(*payload)[0], len);
}

// -- shm ring helpers (dk_shm_ring_* extern "C" surface) ---------------------

bool ring_send_all(void* ring, const std::string& data) {
  return dk_shm_ring_write(ring, data.data(), (long long)data.size(), 5000) ==
         (long long)data.size();
}

bool ring_recv_all(void* ring, char* out, size_t n) {
  size_t off = 0;
  while (off < n) {
    long long r = dk_shm_ring_read(ring, out + off, (long long)(n - off), 5000);
    if (r <= 0) return false;
    off += size_t(r);
  }
  return true;
}

// ring twin of recv_frame_action: one frame off the ring, payload discarded
bool ring_recv_frame_action(void* ring, char* action) {
  char hdr[8];
  if (!ring_recv_all(ring, hdr, 8)) return false;
  uint64_t len = 0;
  for (int i = 0; i < 8; ++i) len = (len << 8) | uint8_t(hdr[i]);
  if (len < 5 || len > (64u << 20)) return false;
  std::vector<char> payload(len);
  if (!ring_recv_all(ring, payload.data(), len)) return false;
  *action = payload[0];
  return true;
}

int dial(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

std::string f32_blob(const std::vector<float>& v) {
  return std::string(reinterpret_cast<const char*>(v.data()),
                     v.size() * sizeof(float));
}

// -- stress legs -------------------------------------------------------------

void inproc_leg(void* ps, int64_t worker) {
  std::vector<float> buf(kTotal), delta(kTotal, 1e-3f);
  while (!g_stop.load(std::memory_order_relaxed)) {
    int64_t clock = dk_ps_pull(ps, buf.data());
    (void)dk_ps_commit_ctx(ps, delta.data(), clock, worker);
  }
}

void socket_leg(int port, bool with_health) {
  int fd = dial(port);
  if (fd < 0) return fail("socket_leg dial");
  const std::string pull = frame('P', {});
  const std::string commit =
      frame('C', {f32_blob(std::vector<float>(kSizes[0], 1e-3f)),
                  f32_blob(std::vector<float>(size_t(kSizes[1]), 1e-3f))});
  const std::string health = frame(
      'M', {std::string("{\"worker\": \"7\", \"windows_total\": 1, "
                        "\"window_wall_ms\": 1.0}")});
  char action = 0;
  int step = 0;
  while (!g_stop.load(std::memory_order_relaxed)) {
    if (!send_all(fd, pull) || !recv_frame_action(fd, &action) ||
        action != 'W')
      break;  // hub stopping under us is fine mid-run
    if (!send_all(fd, commit) || !recv_frame_action(fd, &action) ||
        action != 'A')
      break;
    if (with_health && (step++ % 8) == 0) {
      if (!send_all(fd, health) || !recv_frame_action(fd, &action) ||
          action != 'A')
        break;
    }
  }
  send_all(fd, frame('B', {}));
  ::close(fd);
}

void sparse_leg(int port) {
  int fd = dial(port);
  if (fd < 0) return fail("sparse_leg dial");
  int64_t ids[3] = {1, 5, 9};
  std::string id_blob(reinterpret_cast<const char*>(ids), sizeof(ids));
  const std::string spull = frame('S', {id_blob});
  // U commit: dense leaf full f32 blob, then (ids, rows) for the table
  const std::string scommit = frame(
      'U', {f32_blob(std::vector<float>(kSizes[0], 1e-3f)), id_blob,
            f32_blob(std::vector<float>(3 * 4, 1e-3f))});
  char action = 0;
  while (!g_stop.load(std::memory_order_relaxed)) {
    if (!send_all(fd, spull) || !recv_frame_action(fd, &action) ||
        action != 'V')
      break;
    if (!send_all(fd, scommit) || !recv_frame_action(fd, &action) ||
        action != 'A')
      break;
  }
  send_all(fd, frame('B', {}));
  ::close(fd);
}

void backpressure_leg(int port) {
  while (!g_stop.load(std::memory_order_relaxed)) {
    int fd = dial(port);
    if (fd < 0) return fail("backpressure_leg dial");
    std::string waits(8, '\0');  // 8-byte BE zero: a fresh announcer
    char action = 0;
    if (!send_all(fd, frame('G', {waits})) ||
        !recv_frame_action(fd, &action) || action != 'Y') {
      ::close(fd);
      break;
    }
    send_all(fd, frame('B', {}));
    ::close(fd);
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
}

// Raw SPSC ring under TSAN: a producer thread streaming a byte counter
// through a deliberately tiny ring (forcing wraparound and ring-full parks)
// while this thread consumes and verifies the sequence, then EOF via
// dk_shm_ring_close.  Exercises the head/tail acquire/release protocol and
// the closed-flag wakeups with no hub in the loop.
void ring_pair_leg(const std::string& path) {
  void* prod = dk_shm_ring_create(path.c_str(), /*producer=*/1,
                                  /*capacity=*/1 << 12);
  if (!prod) return fail("ring_pair create");
  void* cons = dk_shm_ring_open(path.c_str(), /*producer=*/0);
  if (!cons) {
    dk_shm_ring_destroy(prod);
    return fail("ring_pair open");
  }
  ::unlink(path.c_str());  // mappings keep the memory alive
  std::atomic<uint64_t> sent{0};
  std::thread producer([&] {
    char chunk[777];  // odd size so frames straddle the wrap point
    uint64_t seq = 0;
    while (!g_stop.load(std::memory_order_relaxed)) {
      for (auto& c : chunk) c = char(seq++ & 0xff);
      if (dk_shm_ring_write(prod, chunk, sizeof(chunk), 5000) < 0)
        return fail("ring_pair write");
      sent.fetch_add(sizeof(chunk));
    }
    dk_shm_ring_close(prod);  // producer EOF wakes the parked consumer
  });
  char buf[1024];
  uint64_t got = 0, expect = 0;
  bool ok = true;
  for (;;) {
    long long r = dk_shm_ring_read(cons, buf, sizeof(buf), 5000);
    if (r <= 0) break;  // 0 = producer closed and drained
    for (long long i = 0; i < r; ++i)
      if (uint8_t(buf[i]) != uint8_t(expect++ & 0xff)) ok = false;
    got += uint64_t(r);
  }
  producer.join();
  if (!ok) fail("ring_pair byte mismatch");
  if (got != sent.load()) fail("ring_pair byte count");
  dk_shm_ring_destroy(cons);
  dk_shm_ring_destroy(prod);
}

// Full 'Z' handshake client: negotiate rings over TCP, then run the same
// P/C traffic as socket_leg with every frame crossing shared memory — the
// hub's ring producer racing our consumer (and vice versa) under TSAN.
void shm_leg(int port) {
  int fd = dial(port);
  if (fd < 0) return fail("shm_leg dial");
  std::string req(1, '\x01');  // SHM_VERSION
  put_u64(req, 1 << 16);       // capacity hint
  std::string offer;
  if (!send_all(fd, frame('Z', {req})) || !recv_frame(fd, &offer) ||
      offer[0] != 'Z') {
    ::close(fd);
    return fail("shm_leg handshake");
  }
  uint32_t count = 0;
  for (int i = 1; i <= 4; ++i) count = (count << 8) | uint8_t(offer[i]);
  if (count != 2) {  // 0 blobs = hub declined; shm_dir was attached, so fail
    ::close(fd);
    return fail("shm_leg declined");
  }
  std::string paths[2];  // [0]=c2h (we produce), [1]=h2c (we consume)
  size_t off = 5;
  for (int b = 0; b < 2; ++b) {
    uint64_t blen = 0;
    for (int i = 0; i < 8; ++i) blen = (blen << 8) | uint8_t(offer[off + i]);
    off += 8;
    paths[b] = offer.substr(off, blen);
    off += blen;
  }
  void* tx = dk_shm_ring_open(paths[0].c_str(), /*producer=*/1);
  void* rx = dk_shm_ring_open(paths[1].c_str(), /*producer=*/0);
  if (!tx || !rx) {
    send_all(fd, frame('Z', {std::string(1, '\x00')}));
    if (tx) dk_shm_ring_destroy(tx);
    if (rx) dk_shm_ring_destroy(rx);
    ::close(fd);
    return fail("shm_leg ring open");
  }
  if (!send_all(fd, frame('Z', {std::string(1, '\x01')}))) {
    dk_shm_ring_destroy(tx);
    dk_shm_ring_destroy(rx);
    ::close(fd);
    return fail("shm_leg confirm");
  }
  const std::string pull = frame('P', {});
  const std::string commit =
      frame('C', {f32_blob(std::vector<float>(kSizes[0], 1e-3f)),
                  f32_blob(std::vector<float>(size_t(kSizes[1]), 1e-3f))});
  char action = 0;
  while (!g_stop.load(std::memory_order_relaxed)) {
    if (!ring_send_all(tx, pull) || !ring_recv_frame_action(rx, &action) ||
        action != 'W')
      break;  // hub stopping under us is fine mid-run
    if (!ring_send_all(tx, commit) || !ring_recv_frame_action(rx, &action) ||
        action != 'A')
      break;
  }
  ring_send_all(tx, frame('B', {}));
  dk_shm_ring_close(tx);  // producer EOF so the hub handler exits cleanly
  dk_shm_ring_destroy(tx);
  dk_shm_ring_destroy(rx);
  ::close(fd);
}

void telemetry_leg(void* ps) {
  int64_t stats[32], hist[65], recs[5 * 64];  // 26 StatSlots, 5-wide records
  unsigned char health[4096];
  int64_t worker = 0;
  while (!g_stop.load(std::memory_order_relaxed)) {
    dk_ps_stats(ps, stats);
    dk_ps_staleness_hist(ps, hist);
    (void)dk_ps_drain_commits(ps, recs, 64);
    while (dk_ps_next_health(ps, health, sizeof(health)) > 0) {
    }
    (void)dk_ps_num_updates(ps);
    dk_ps_set_rate_scale(ps, worker++ % 4, 0.5,
                         dk_ps_time_ns(ps) + 1000000000LL);
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
  }
}

}  // namespace

int main() {
  char shm_template[] = "/dev/shm/dktsanXXXXXX";
  char tmp_template[] = "/tmp/dktsanXXXXXX";
  char* shm_dir = ::mkdtemp(shm_template);
  if (!shm_dir) shm_dir = ::mkdtemp(tmp_template);
  if (!shm_dir) {
    std::fprintf(stderr, "harness error: mkdtemp failed\n");
    return 2;
  }
  void* primary = dk_ps_create(0, 2, kSizes, /*mode=*/0, /*num_workers=*/4,
                               /*elastic=*/1, /*idle_timeout_ms=*/0,
                               /*num_sparse=*/1, kSparseLeaves, kSparseDims,
                               /*adaptive=*/1, /*max_payload=*/1 << 20);
  dk_ps_shm_attach(primary, shm_dir);  // enables the 'Z' arm for shm_leg
  int port = dk_ps_start(primary);
  if (port <= 0) {
    std::fprintf(stderr, "harness error: primary failed to bind\n");
    return 2;
  }
  void* standby = dk_ps_create(0, 2, kSizes, 0, 4, 1, 0, 1, kSparseLeaves,
                               kSparseDims, 0, 1 << 20);
  dk_ps_set_replica_of(standby, "127.0.0.1", port, /*retries=*/3,
                       /*backoff_ms=*/50);
  int sport = dk_ps_start(standby);
  if (sport <= 0) {
    std::fprintf(stderr, "harness error: standby failed to bind\n");
    return 2;
  }

  std::vector<std::thread> threads;
  threads.emplace_back(inproc_leg, primary, 0);
  threads.emplace_back(inproc_leg, primary, 1);
  threads.emplace_back(socket_leg, port, false);
  threads.emplace_back(socket_leg, port, true);
  threads.emplace_back(sparse_leg, port);
  threads.emplace_back(backpressure_leg, port);
  threads.emplace_back(telemetry_leg, primary);
  threads.emplace_back(shm_leg, port);
  threads.emplace_back(shm_leg, port);  // two shm attaches racing one hub
  threads.emplace_back(ring_pair_leg,
                       std::string(shm_dir) + "/ring-pair.raw");

  if (dk_ps_wait_synced(standby, 5000) != 1) fail("standby never synced");
  std::this_thread::sleep_for(std::chrono::milliseconds(1500));
  g_stop.store(true);
  for (auto& t : threads) t.join();

  if (dk_ps_promoted(standby) != 0) fail("standby promoted mid-stress");
  dk_ps_stop(standby);
  dk_ps_stop(primary);
  dk_ps_destroy(standby);
  dk_ps_destroy(primary);
  ::rmdir(shm_dir);  // ring files were unlinked at handshake/creation time
  if (g_errors.load() != 0) return 3;
  std::printf("tsan stress complete\n");
  return 0;
}
