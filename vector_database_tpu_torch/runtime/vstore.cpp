// Native out-of-core vector store: memory-mapped, append-only float32 rows
// (a copy of vector_database_tpu/runtime/vstore.cpp; the file format is the
// same, so a store written by either package opens in the other).
//
// The host-runtime tier of the package, the re-design of the reference's
// storage layer:
//   - the single memory-mapped temp file with bump-allocated regions
//     (reference VectorIndex/FileRangeStore.cs:18-43, 127-165) becomes a
//     persistent mmap'd row store feeding chunked host->device ingest
//     (the builder needs no per-range temp stores: the level-synchronous
//     device build keeps everything in device memory);
//   - the chunked dataset readers of the benchmark harness
//     (VectorIndex.MainTest/Program.cs:183-260) become native importers
//     (fvecs) writing straight into the mapped region.
//
// Exposed as a C ABI for ctypes; reads are zero-copy (the Python side wraps
// the mapped pointer in a numpy array).
//
// Build (runtime/native_store.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libvstore.so vstore.cpp

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x565354524f524531ULL;  // "VSTORE1"
constexpr uint64_t kHeaderBytes = 4096;

struct Header {
  uint64_t magic;
  uint64_t version;
  uint64_t dims;
  uint64_t count;     // rows written
  uint64_t capacity;  // rows mapped
};

struct Store {
  int fd = -1;
  Header* header = nullptr;  // start of the mapping
  float* data = nullptr;     // rows, header page skipped
  uint64_t mapped_bytes = 0;
  char error[256] = {0};
};

uint64_t file_bytes(uint64_t capacity, uint64_t dims) {
  return kHeaderBytes + capacity * dims * sizeof(float);
}

bool remap(Store* s, uint64_t capacity) {
  uint64_t want = file_bytes(capacity, s->header ? s->header->dims : 0);
  // callers pass dims via header; see vs_create/vs_open
  if (s->header) {
    if (ftruncate(s->fd, (off_t)want) != 0) {
      snprintf(s->error, sizeof(s->error), "ftruncate: %s", strerror(errno));
      return false;
    }
    Header saved = *s->header;
    munmap((void*)s->header, s->mapped_bytes);
    void* m = mmap(nullptr, want, PROT_READ | PROT_WRITE, MAP_SHARED,
                   s->fd, 0);
    if (m == MAP_FAILED) {
      s->header = nullptr;
      snprintf(s->error, sizeof(s->error), "mmap: %s", strerror(errno));
      return false;
    }
    s->header = (Header*)m;
    *s->header = saved;
    s->header->capacity = capacity;
    s->data = (float*)((char*)m + kHeaderBytes);
    s->mapped_bytes = want;
  }
  return true;
}

}  // namespace

extern "C" {

Store* vs_create(const char* path, uint64_t dims, uint64_t capacity_rows) {
  Store* s = new Store();
  if (dims == 0) {
    snprintf(s->error, sizeof(s->error), "dims must be > 0");
    return s;
  }
  if (capacity_rows == 0) capacity_rows = 1024;
  s->fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (s->fd < 0) {
    snprintf(s->error, sizeof(s->error), "open: %s", strerror(errno));
    return s;
  }
  uint64_t bytes = file_bytes(capacity_rows, dims);
  if (ftruncate(s->fd, (off_t)bytes) != 0) {
    snprintf(s->error, sizeof(s->error), "ftruncate: %s", strerror(errno));
    return s;
  }
  void* m =
      mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, s->fd, 0);
  if (m == MAP_FAILED) {
    snprintf(s->error, sizeof(s->error), "mmap: %s", strerror(errno));
    return s;
  }
  s->header = (Header*)m;
  s->data = (float*)((char*)m + kHeaderBytes);
  s->mapped_bytes = bytes;
  s->header->magic = kMagic;
  s->header->version = 1;
  s->header->dims = dims;
  s->header->count = 0;
  s->header->capacity = capacity_rows;
  return s;
}

Store* vs_open(const char* path) {
  Store* s = new Store();
  s->fd = open(path, O_RDWR);
  if (s->fd < 0) {
    snprintf(s->error, sizeof(s->error), "open: %s", strerror(errno));
    return s;
  }
  struct stat st;
  if (fstat(s->fd, &st) != 0 || (uint64_t)st.st_size < kHeaderBytes) {
    snprintf(s->error, sizeof(s->error), "bad store file");
    return s;
  }
  void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                 MAP_SHARED, s->fd, 0);
  if (m == MAP_FAILED) {
    snprintf(s->error, sizeof(s->error), "mmap: %s", strerror(errno));
    return s;
  }
  s->header = (Header*)m;
  s->data = (float*)((char*)m + kHeaderBytes);
  s->mapped_bytes = (uint64_t)st.st_size;
  if (s->header->magic != kMagic) {
    snprintf(s->error, sizeof(s->error), "bad magic");
    s->header = nullptr;
    return s;
  }
  // consistency: a truncated or corrupted header must error here, not
  // SIGBUS later when vs_rows/vs_read dereference past the mapping.
  // Division form: count * dims * 4 on corrupt values can wrap uint64.
  {
    uint64_t data_bytes = (uint64_t)st.st_size - kHeaderBytes;
    uint64_t dims = s->header->dims;
    bool ok = dims != 0 && dims <= data_bytes / sizeof(float) + 1 &&
              s->header->count <= s->header->capacity &&
              // vs_create always ftruncates to full capacity, so a
              // legit file covers it; appends rely on that coverage
              s->header->capacity <= data_bytes / (dims * sizeof(float));
    if (!ok) {
      snprintf(s->error, sizeof(s->error),
               "bad store file: header inconsistent with file size");
      s->header = nullptr;
    }
  }
  return s;
}

const char* vs_error(Store* s) { return s->error[0] ? s->error : nullptr; }

uint64_t vs_count(Store* s) { return s->header ? s->header->count : 0; }
uint64_t vs_dims(Store* s) { return s->header ? s->header->dims : 0; }
uint64_t vs_capacity(Store* s) {
  return s->header ? s->header->capacity : 0;
}

// Append rows (row-major float32). Grows the file geometrically.
int vs_append(Store* s, const float* rows, uint64_t nrows) {
  if (!s->header) return -1;
  uint64_t need = s->header->count + nrows;
  if (need > s->header->capacity) {
    uint64_t cap = s->header->capacity;
    while (cap < need) cap += cap / 2 + 1024;
    if (!remap(s, cap)) return -1;
  }
  memcpy(s->data + s->header->count * s->header->dims, rows,
         nrows * s->header->dims * sizeof(float));
  s->header->count = need;
  return 0;
}

// Zero-copy pointer to row `start` (valid until the next append/close).
const float* vs_rows(Store* s, uint64_t start) {
  if (!s->header || start > s->header->count) return nullptr;
  return s->data + start * s->header->dims;
}

// Copying read for callers that want an owned buffer.
int vs_read(Store* s, uint64_t start, uint64_t nrows, float* out) {
  if (!s->header || start + nrows > s->header->count) return -1;
  memcpy(out, s->data + start * s->header->dims,
         nrows * s->header->dims * sizeof(float));
  return 0;
}

int vs_flush(Store* s) {
  if (!s->header) return -1;
  return msync((void*)s->header, s->mapped_bytes, MS_SYNC);
}

void vs_close(Store* s) {
  if (s->header) munmap((void*)s->header, s->mapped_bytes);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

// Import an fvecs file (the SIFT/ann-benchmarks format: per row an int32
// dim followed by dim float32s). Returns rows imported, or -1.
// Transactional: a mid-file error (truncated row, dim mismatch) rewinds
// the row count to its pre-import value, so a fixed-and-retried import
// cannot leave the first half of the file duplicated in the store.
int64_t vs_import_fvecs(Store* s, const char* path) {
  if (!s->header) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(s->error, sizeof(s->error), "fopen: %s", strerror(errno));
    return -1;
  }
  const uint64_t count_before = s->header->count;
  int64_t imported = 0;
  const uint64_t dims = s->header->dims;
  float* buf = new float[dims];
  while (true) {
    int32_t d;
    if (fread(&d, sizeof(d), 1, f) != 1) break;  // EOF
    if ((uint64_t)d != dims) {
      snprintf(s->error, sizeof(s->error),
               "fvecs dim %d != store dims %llu", d,
               (unsigned long long)dims);
      imported = -1;
      break;
    }
    if (fread(buf, sizeof(float), dims, f) != dims) {
      snprintf(s->error, sizeof(s->error), "truncated fvecs row");
      imported = -1;
      break;
    }
    if (vs_append(s, buf, 1) != 0) {
      imported = -1;
      break;
    }
    ++imported;
  }
  delete[] buf;
  fclose(f);
  if (imported < 0 && s->header) s->header->count = count_before;
  return imported;
}

}  // extern "C"
