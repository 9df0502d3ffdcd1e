// Reads one serving batch of feature stacks from .npy files straight into
// caller-owned float32 buffers: for each request the proportional time crop
// of its rgb, flow and audio stacks (data/features.py crop_span, with Python
// slice semantics), truncated to the batch's bucket and zero-padded up to it,
// as features.load_features_from_npy followed by features.pad_stack gives
// them, bit for bit. Only the rows that survive the crop and the bucket are
// read. A second entry gives the serving plan each file's row count from
// its header alone, with the same parser.
//
// Plain C interface for ctypes (data/feature_reader.py), which releases the
// interpreter lock for the length of a call. The call runs on its own
// threads. It reads 2-D little-endian float32 files in C order; for any other
// file, or any failure other than a missing file, it reports PYTHON and
// leaves the whole batch to the Python path, which then loads or raises
// exactly as it always has.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

enum Status : int32_t { OK = 0, MISMATCH = 1, PYTHON = 2 };
enum Found : int32_t { FOUND = 0, MISSING = 1, OTHER = 2 };

constexpr size_t kMaxHeader = 10000;  // numpy's max_header_size

// A Python dict literal, as numpy writes an .npy header and ast reads it:
// exactly the keys 'descr', 'fortran_order' and 'shape'. Anything this
// parser does not take is left to numpy.
class HeaderParser {
 public:
  HeaderParser(const char* p, const char* end) : p_(p), end_(end) {}

  bool Parse(std::string* descr, bool* fortran, int64_t* rows,
             int64_t* cols) {
    bool seen[3] = {false, false, false};
    if (!Eat('{')) return false;
    while (!Eat('}')) {
      std::string key;
      if (!String(&key) || !Eat(':')) return false;
      if (key == "descr" && !seen[0]) {
        seen[0] = true;
        if (!String(descr)) return false;
      } else if (key == "fortran_order" && !seen[1]) {
        seen[1] = true;
        if (Word("False")) {
          *fortran = false;
        } else if (Word("True")) {
          *fortran = true;
        } else {
          return false;
        }
      } else if (key == "shape" && !seen[2]) {
        seen[2] = true;
        if (!Eat('(') || !Int(rows) || !Eat(',') || !Int(cols)) return false;
        Eat(',');
        if (!Eat(')')) return false;
      } else {
        return false;
      }
      if (!Eat(',')) {
        if (!Eat('}')) return false;
        break;
      }
    }
    Space();
    return p_ == end_ && seen[0] && seen[1] && seen[2];
  }

 private:
  void Space() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' ||
                         *p_ == '\r')) {
      ++p_;
    }
  }
  bool Eat(char c) {
    Space();
    if (p_ < end_ && *p_ == c) {
      ++p_;
      return true;
    }
    return false;
  }
  bool Word(const char* w) {
    Space();
    const size_t n = std::strlen(w);
    if (static_cast<size_t>(end_ - p_) < n || std::memcmp(p_, w, n)) {
      return false;
    }
    p_ += n;
    return true;
  }
  bool String(std::string* out) {
    Space();
    if (p_ >= end_ || (*p_ != '\'' && *p_ != '"')) return false;
    const char quote = *p_++;
    const char* start = p_;
    while (p_ < end_ && *p_ != quote) {
      if (*p_ == '\\' || *p_ == '\n') return false;
      ++p_;
    }
    if (p_ >= end_) return false;
    out->assign(start, p_);
    ++p_;
    return true;
  }
  bool Int(int64_t* v) {
    Space();
    if (p_ >= end_ || *p_ < '0' || *p_ > '9') return false;
    // a leading zero is a syntax error in Python 3 unless the number is 0
    if (*p_ == '0' && p_ + 1 < end_ && p_[1] >= '0' && p_[1] <= '9') {
      return false;
    }
    int64_t x = 0;
    while (p_ < end_ && *p_ >= '0' && *p_ <= '9') {
      if (x > (INT64_MAX - 9) / 10) return false;
      x = x * 10 + (*p_ - '0');
      ++p_;
    }
    *v = x;
    return true;
  }

  const char* p_;
  const char* end_;
};

bool ReadAt(int fd, void* dst, size_t bytes, off_t offset) {
  char* out = static_cast<char*>(dst);
  while (bytes > 0) {
    const ssize_t got = pread(fd, out, bytes, offset);
    if (got < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (got == 0) return false;
    out += got;
    bytes -= static_cast<size_t>(got);
    offset += got;
  }
  return true;
}

// One opened .npy file holding a (rows, cols) '<f4' array in C order.
struct Npy {
  int fd = -1;
  int64_t rows = 0;
  int64_t cols = 0;
  off_t data = 0;  // offset of the first element
  ~Npy() {
    if (fd >= 0) close(fd);
  }

  // MISSING only where open() finds no file (Python's FileNotFoundError).
  Found Open(const char* path) {
    fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return errno == ENOENT ? MISSING : OTHER;
    struct stat st;
    if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)) return OTHER;
    unsigned char pre[12];
    if (st.st_size < 12 || !ReadAt(fd, pre, sizeof pre, 0)) return OTHER;
    if (std::memcmp(pre, "\x93NUMPY", 6) != 0 || pre[7] != 0) return OTHER;
    size_t header_len;
    off_t start;
    if (pre[6] == 1) {
      header_len = pre[8] | (pre[9] << 8);
      start = 10;
    } else if (pre[6] == 2 || pre[6] == 3) {
      header_len = static_cast<size_t>(pre[8]) | (pre[9] << 8) |
                   (pre[10] << 16) | (static_cast<size_t>(pre[11]) << 24);
      start = 12;
    } else {
      return OTHER;
    }
    if (header_len > kMaxHeader ||
        st.st_size < start + static_cast<off_t>(header_len)) {
      return OTHER;
    }
    char header[kMaxHeader];
    if (!ReadAt(fd, header, header_len, start)) return OTHER;
    std::string descr;
    bool fortran = true;
    if (!HeaderParser(header, header + header_len)
             .Parse(&descr, &fortran, &rows, &cols) ||
        descr != "<f4" || fortran) {
      return OTHER;
    }
    data = start + static_cast<off_t>(header_len);
    // numpy reads the whole array, so a short file is its error to raise
    if (cols > 0 && rows > (INT64_MAX / 4 - data) / cols) return OTHER;
    if (st.st_size < data + rows * cols * 4) return OTHER;
    return FOUND;
  }

  bool Read(int64_t first, int64_t n, float* out) const {
    return ReadAt(fd, out, static_cast<size_t>(n * cols) * sizeof(float),
                  data + first * cols * static_cast<off_t>(sizeof(float)));
  }
};

// The rows [*first, *first + *n) that crop_a_segment keeps of a stack of
// `total` rows: crop_span's double arithmetic and truncation toward zero,
// then Python's slice clamping. False where Python would not reach a slice
// (a division by zero, NaN or a huge index): the Python path then decides.
bool Crop(int64_t total, double start, double end, double duration,
          int64_t* first, int64_t* n) {
  const double s = static_cast<double>(total) * (start / duration);
  const double e = static_cast<double>(total) * (end / duration);
  if (!(std::fabs(s) < 0x1p53) || !(std::fabs(e) < 0x1p53)) return false;
  int64_t si = static_cast<int64_t>(s);
  int64_t ei = static_cast<int64_t>(e);
  if (si == ei) {
    if (si == total) {
      si -= 1;
    } else {
      ei += 1;
    }
  }
  auto clamp = [total](int64_t i) {
    if (i < 0) return std::max<int64_t>(i + total, 0);
    return std::min(i, total);
  };
  si = clamp(si);
  ei = clamp(ei);
  *first = si;
  *n = std::max<int64_t>(ei - si, 0);
  return true;
}

struct Batch {
  const char* const* paths;  // rgb, flow, audio of each request
  const double* times;       // start, end, duration of each request
  int64_t vb, ab, d_vid, d_aud;
  float* rgb;
  float* flow;
  float* audio;
  int64_t* shapes;  // rgb rows, cols, flow rows, cols of each request
};

void Zero(float* row, int64_t from, int64_t bucket, int64_t width) {
  std::memset(row + from * width, 0,
              static_cast<size_t>((bucket - from) * width) * sizeof(float));
}

// Request i into output row i.
Status ReadRow(const Batch& b, int64_t i) {
  const char* const* path = b.paths + 3 * i;
  const double* t = b.times + 3 * i;
  float* rgb = b.rgb + i * b.vb * b.d_vid;
  float* flow = b.flow + i * b.vb * b.d_vid;
  float* audio = b.audio + i * b.ab * b.d_aud;

  // rgb and flow: a missing file or an empty crop is one zero row of both
  int64_t nv = 0;
  Npy fr, ff;
  Found found = fr.Open(path[0]);
  if (found == FOUND) found = ff.Open(path[1]);
  if (found == OTHER) return PYTHON;
  if (found == FOUND) {
    if (fr.rows != ff.rows || fr.cols != ff.cols) {
      int64_t* shape = b.shapes + 4 * i;
      shape[0] = fr.rows;
      shape[1] = fr.cols;
      shape[2] = ff.rows;
      shape[3] = ff.cols;
      return MISMATCH;
    }
    int64_t first;
    if (fr.cols != b.d_vid || !Crop(fr.rows, t[0], t[1], t[2], &first, &nv)) {
      return PYTHON;
    }
    nv = std::min(nv, b.vb);
    if (!fr.Read(first, nv, rgb) || !ff.Read(first, nv, flow)) return PYTHON;
  }
  Zero(rgb, nv, b.vb, b.d_vid);
  Zero(flow, nv, b.vb, b.d_vid);

  int64_t na = 0;
  Npy fa;
  found = fa.Open(path[2]);
  if (found == OTHER) return PYTHON;
  if (found == FOUND) {
    int64_t first;
    if (fa.cols != b.d_aud || !Crop(fa.rows, t[0], t[1], t[2], &first, &na)) {
      return PYTHON;
    }
    na = std::min(na, b.ab);
    if (!fa.Read(first, na, audio)) return PYTHON;
  }
  Zero(audio, na, b.ab, b.d_aud);
  return OK;
}

// Runs work() on min(threads, items) threads, this one among them; fewer
// where the system refuses a thread, this one working through the rest.
template <typename Work>
void RunOnThreads(int32_t threads, int32_t items, const Work& work) {
  std::vector<std::thread> pool;
  const int32_t extra = std::min(std::max(threads, 1), std::max(items, 1)) - 1;
  for (int32_t k = 0; k < extra; ++k) {
    try {
      pool.emplace_back(work);
    } catch (const std::system_error&) {
      break;
    }
  }
  work();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Requests [0, n_req) into output rows [0, n_req) and zero rows up to
// n_rows. rgb and flow are (n_rows, vb, d_vid), audio (n_rows, ab, d_aud).
// Returns the largest status of a request (status[i]; shapes[4 i..] for a
// MISMATCH); after a PYTHON the outputs are unspecified.
int32_t read_feature_batch(int32_t n_req, int32_t n_rows,
                           const char* const* paths, const double* times,
                           int32_t vb, int32_t ab, int32_t d_vid,
                           int32_t d_aud, float* rgb, float* flow,
                           float* audio, int32_t threads, int32_t* status,
                           int64_t* shapes) {
  const Batch b{paths, times, vb, ab, d_vid, d_aud, rgb, flow, audio, shapes};
  std::atomic<int64_t> next{0};
  std::atomic<bool> python{false};
  auto work = [&] {
    while (!python.load(std::memory_order_relaxed)) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_rows) return;
      if (i >= n_req) {
        Zero(b.rgb + i * b.vb * b.d_vid, 0, b.vb, b.d_vid);
        Zero(b.flow + i * b.vb * b.d_vid, 0, b.vb, b.d_vid);
        Zero(b.audio + i * b.ab * b.d_aud, 0, b.ab, b.d_aud);
        continue;
      }
      status[i] = ReadRow(b, i);
      if (status[i] == PYTHON) python.store(true);
    }
  };
  RunOnThreads(threads, n_rows, work);
  if (python.load()) return PYTHON;
  int32_t worst = OK;
  for (int32_t i = 0; i < n_req; ++i) worst = std::max(worst, status[i]);
  return worst;
}

// The row count of each of n .npy files from its header alone, on up to
// `threads` threads: status[i] is FOUND (rows[i] set: a file the reader
// takes), MISSING (open() found no file) or OTHER (any other file or
// failure, for the caller to decide).
void probe_feature_rows(int32_t n, const char* const* paths, int32_t threads,
                        int64_t* rows, int32_t* status) {
  std::atomic<int32_t> next{0};
  auto work = [&] {
    for (int32_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      Npy f;
      status[i] = f.Open(paths[i]);
      rows[i] = f.rows;
    }
  };
  RunOnThreads(threads, n, work);
}

}  // extern "C"
