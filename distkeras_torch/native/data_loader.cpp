// Native columnar data loader: mmap + page warming + chunk prefetch.
//
// The reference's data plane was Spark's JVM reading HDFS partitions; this
// framework's host-side analogue is a flat columnar container ("DKCOL")
// that maps straight into the process: zero-copy column views, an optional
// background warm thread that touches pages ahead of training (so the
// first epoch doesn't stall on page faults), and madvise-based prefetch
// hooks the Python chunked feeder calls one chunk ahead.
//
// Container layout (little-endian, written by distkeras_torch/data/colfile.py):
//   8  bytes magic "DKCOL1\0\0"
//   u32 ncols
//   per column:
//     u32 name_len, name bytes
//     u32 dtype_len, dtype bytes (numpy dtype.str, e.g. "<f4")
//     u32 ndim, ndim * i64 dims
//     u64 offset (from file start, 64-aligned), u64 nbytes
//
// C ABI (ctypes, no pybind11 in this environment):
//   dk_dl_open / dk_dl_close / dk_dl_error
//   dk_dl_ncols / dk_dl_col_name / dk_dl_col_dtype / dk_dl_col_ndim /
//   dk_dl_col_dim / dk_dl_col_nbytes / dk_dl_col_data
//   dk_dl_prefetch (madvise WILLNEED on a byte range of a column)
//   dk_dl_warmed_bytes (progress of the warm thread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Col {
  std::string name;
  std::string dtype;
  std::vector<int64_t> dims;
  uint64_t offset = 0;
  uint64_t nbytes = 0;
};

struct Handle {
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t size = 0;
  std::vector<Col> cols;
  std::thread warmer;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> warmed{0};

  ~Handle() {
    stop.store(true);
    if (warmer.joinable()) warmer.join();
    if (base) munmap(base, size);
    if (fd >= 0) close(fd);
  }
};

thread_local std::string g_error;

bool read_exact(const uint8_t*& p, const uint8_t* end, void* out, size_t n) {
  if (p + n > end) return false;
  std::memcpy(out, p, n);
  p += n;
  return true;
}

void warm_pages(Handle* h) {
  // touch one byte per page sequentially; volatile defeats dead-read
  // elimination.  This pulls the file through the page cache ahead of the
  // training loop's first pass.
  const long page = sysconf(_SC_PAGESIZE);
  volatile uint8_t sink = 0;
  for (uint64_t off = 0; off < h->size; off += static_cast<uint64_t>(page)) {
    if (h->stop.load(std::memory_order_relaxed)) return;
    sink ^= h->base[off];
    h->warmed.store(off + page, std::memory_order_relaxed);
  }
  (void)sink;
  h->warmed.store(h->size, std::memory_order_relaxed);
}

}  // namespace

extern "C" {

const char* dk_dl_error() { return g_error.c_str(); }

void* dk_dl_open(const char* path, int warm) {
  g_error.clear();
  auto h = new Handle();
  h->fd = open(path, O_RDONLY);
  if (h->fd < 0) {
    g_error = std::string("open failed: ") + strerror(errno);
    delete h;
    return nullptr;
  }
  struct stat st;
  if (fstat(h->fd, &st) != 0 || st.st_size < 12) {
    g_error = "stat failed or file too small";
    delete h;
    return nullptr;
  }
  h->size = static_cast<uint64_t>(st.st_size);
  void* m = mmap(nullptr, h->size, PROT_READ, MAP_SHARED, h->fd, 0);
  if (m == MAP_FAILED) {
    g_error = std::string("mmap failed: ") + strerror(errno);
    delete h;
    return nullptr;
  }
  h->base = static_cast<uint8_t*>(m);
  madvise(h->base, h->size, MADV_SEQUENTIAL);

  const uint8_t* p = h->base;
  const uint8_t* end = h->base + h->size;
  if (std::memcmp(p, "DKCOL1\0\0", 8) != 0) {
    g_error = "bad magic: not a DKCOL1 container";
    delete h;
    return nullptr;
  }
  p += 8;
  uint32_t ncols = 0;
  if (!read_exact(p, end, &ncols, 4) || ncols > 4096) {
    g_error = "bad column count";
    delete h;
    return nullptr;
  }
  for (uint32_t i = 0; i < ncols; ++i) {
    Col c;
    uint32_t nlen = 0, dlen = 0, ndim = 0;
    if (!read_exact(p, end, &nlen, 4) || nlen > 4096) goto corrupt;
    c.name.resize(nlen);
    if (!read_exact(p, end, c.name.data(), nlen)) goto corrupt;
    if (!read_exact(p, end, &dlen, 4) || dlen > 64) goto corrupt;
    c.dtype.resize(dlen);
    if (!read_exact(p, end, c.dtype.data(), dlen)) goto corrupt;
    if (!read_exact(p, end, &ndim, 4) || ndim > 32) goto corrupt;
    c.dims.resize(ndim);
    if (!read_exact(p, end, c.dims.data(), 8 * ndim)) goto corrupt;
    for (int64_t d : c.dims)
      if (d < 0) goto corrupt;  // negative dims would let numpy infer shapes
    if (!read_exact(p, end, &c.offset, 8)) goto corrupt;
    if (!read_exact(p, end, &c.nbytes, 8)) goto corrupt;
    // overflow-safe bounds check: offset + nbytes could wrap in uint64
    if (c.offset > h->size || c.nbytes > h->size - c.offset) goto corrupt;
    h->cols.push_back(std::move(c));
  }
  if (warm) h->warmer = std::thread(warm_pages, h);
  return h;
corrupt:
  g_error = "corrupt DKCOL header";
  delete h;
  return nullptr;
}

void dk_dl_close(void* handle) { delete static_cast<Handle*>(handle); }

// Release the handle WITHOUT unmapping: stops the warm thread and closes
// the fd, but leaves the mapping alive for the process lifetime so numpy
// views handed out earlier can never dangle (file-backed clean pages are
// reclaimable by the kernel, so the "leak" costs address space, not RAM).
void dk_dl_release(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  h->stop.store(true);
  if (h->warmer.joinable()) h->warmer.join();
  if (h->fd >= 0) { close(h->fd); h->fd = -1; }
  h->base = nullptr;  // ~Handle skips munmap
  delete h;
}

int32_t dk_dl_ncols(void* handle) {
  return static_cast<int32_t>(static_cast<Handle*>(handle)->cols.size());
}

const char* dk_dl_col_name(void* handle, int32_t i) {
  return static_cast<Handle*>(handle)->cols[i].name.c_str();
}

const char* dk_dl_col_dtype(void* handle, int32_t i) {
  return static_cast<Handle*>(handle)->cols[i].dtype.c_str();
}

int32_t dk_dl_col_ndim(void* handle, int32_t i) {
  return static_cast<int32_t>(static_cast<Handle*>(handle)->cols[i].dims.size());
}

int64_t dk_dl_col_dim(void* handle, int32_t i, int32_t j) {
  return static_cast<Handle*>(handle)->cols[i].dims[j];
}

int64_t dk_dl_col_nbytes(void* handle, int32_t i) {
  return static_cast<int64_t>(static_cast<Handle*>(handle)->cols[i].nbytes);
}

const uint8_t* dk_dl_col_data(void* handle, int32_t i) {
  auto* h = static_cast<Handle*>(handle);
  return h->base + h->cols[i].offset;
}

// madvise(WILLNEED) a byte range of column i — the chunked feeder calls
// this for chunk k+1 while the trainer consumes chunk k.
void dk_dl_prefetch(void* handle, int32_t i, int64_t start, int64_t nbytes) {
  auto* h = static_cast<Handle*>(handle);
  const Col& c = h->cols[i];
  if (start < 0 || nbytes <= 0 ||
      static_cast<uint64_t>(start + nbytes) > c.nbytes)
    return;
  const long page = sysconf(_SC_PAGESIZE);
  uint64_t abs = c.offset + static_cast<uint64_t>(start);
  uint64_t aligned = abs & ~static_cast<uint64_t>(page - 1);
  uint64_t len = abs + static_cast<uint64_t>(nbytes) - aligned;
  madvise(h->base + aligned, len, MADV_WILLNEED);
}

int64_t dk_dl_warmed_bytes(void* handle) {
  return static_cast<int64_t>(static_cast<Handle*>(handle)->warmed.load());
}

}  // extern "C"
