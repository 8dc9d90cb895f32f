// Native data IO: mmap'd token-file reader with async page prefetch.
//
// The port's own copy of autodist_tpu/runtime/native/dataio.cc, built
// by the host compiler at first use (autodist_tpu_torch/runtime/
// native.py).  The hot path is a flat binary token stream (the standard
// layout for LM corpora): windows are gathered straight out of the page
// cache with memcpy, and the *next* batch's pages are warmed with
// madvise(WILLNEED) so disk latency overlaps device compute.  No
// threads, no locks — the kernel's readahead is the async engine.
//
// C ABI for ctypes (autodist_tpu_torch/data.py).  All sizes in ITEMS,
// not bytes; windows are [offset, offset + window) half-open item ranges.
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct DioFile {
  int fd = -1;
  void* base = nullptr;
  size_t bytes = 0;
  int itemsize = 0;
};

}  // namespace

extern "C" {

// Open `path` as a flat array of `itemsize`-byte items.  Returns a
// handle, or nullptr on failure (missing file, empty file, mmap error,
// or size not a multiple of itemsize).
void* dio_open(const char* path, int itemsize) {
  if (itemsize <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0 ||
      st.st_size % itemsize != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  // Windows are random: default readahead would thrash; we prefetch
  // explicitly per-batch instead.
  ::madvise(base, st.st_size, MADV_RANDOM);
  auto* f = new DioFile();
  f->fd = fd;
  f->base = base;
  f->bytes = static_cast<size_t>(st.st_size);
  f->itemsize = itemsize;
  return f;
}

long long dio_num_items(void* h) {
  auto* f = static_cast<DioFile*>(h);
  return static_cast<long long>(f->bytes / f->itemsize);
}

// Copy n windows of `window` items into `out` (contiguous [n, window]
// row-major).  Returns 0, or -1 if any window is out of bounds (nothing
// is copied in that case).
int dio_gather(void* h, const long long* offsets, int n, long long window,
               void* out) {
  auto* f = static_cast<DioFile*>(h);
  const long long total = dio_num_items(h);
  if (window <= 0 || window > total || n < 0) return -1;
  for (int i = 0; i < n; ++i) {
    // offsets[i] > total - window, not offsets[i] + window > total:
    // the sum can overflow int64 and bypass the check.
    if (offsets[i] < 0 || offsets[i] > total - window) return -1;
  }
  const size_t row = static_cast<size_t>(window) * f->itemsize;
  auto* dst = static_cast<char*>(out);
  const auto* src = static_cast<const char*>(f->base);
  for (int i = 0; i < n; ++i) {
    std::memcpy(dst + static_cast<size_t>(i) * row,
                src + static_cast<size_t>(offsets[i]) * f->itemsize, row);
  }
  return 0;
}

// Ask the kernel to start paging in the given windows (page-aligned
// supersets).  Cheap and asynchronous: call with batch t+1's offsets
// right after gathering batch t.  Out-of-bounds windows are skipped.
int dio_prefetch(void* h, const long long* offsets, int n,
                 long long window) {
  auto* f = static_cast<DioFile*>(h);
  const long long total = dio_num_items(h);
  if (window <= 0 || window > total) return 0;
  const long page = sysconf(_SC_PAGESIZE);
  for (int i = 0; i < n; ++i) {
    if (offsets[i] < 0 || offsets[i] > total - window) continue;
    size_t lo = static_cast<size_t>(offsets[i]) * f->itemsize;
    size_t hi = lo + static_cast<size_t>(window) * f->itemsize;
    lo = (lo / page) * page;
    hi = ((hi + page - 1) / page) * page;
    if (hi > f->bytes) hi = f->bytes;
    ::madvise(static_cast<char*>(f->base) + lo, hi - lo, MADV_WILLNEED);
  }
  return 0;
}

void dio_close(void* h) {
  auto* f = static_cast<DioFile*>(h);
  if (f == nullptr) return;
  if (f->base != nullptr) ::munmap(f->base, f->bytes);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

}  // extern "C"
