// Native market-data CSV loader.
//
// Parses EOD-schema CSVs (`date,open,high,low,close,adjusted_close,volume`)
// from an mmap into column arrays with no intermediate Python objects, and
// fans out over a std::thread pool for multi-file loads. Dates come back as
// days since the unix epoch. Exposed through a plain C ABI consumed via
// ctypes (portfoliooptgp_tpu_torch/native.py), which builds it on first use.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC csv_loader.cc -o libcsvloader.so -lpthread

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

typedef struct {
  int64_t n_rows;
  int64_t *dates; // days since unix epoch
  double *open;
  double *high;
  double *low;
  double *close;
  double *adjusted_close;
  double *volume;
  char *error; // heap string, null on success
} EodTable;

} // extern "C"

namespace {

// Howard Hinnant's days_from_civil: civil date -> days since 1970-01-01.
int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

const char *parse_double(const char *p, const char *end, double *out) {
  // fast path for the [-]ddd[.ddd] numbers in market CSVs; strtod fallback
  // for scientific notation or other oddities
  const char *start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = *p == '-';
    ++p;
  }
  uint64_t ip = 0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9' && digits < 18) {
    ip = ip * 10 + static_cast<unsigned>(*p - '0');
    ++p;
    ++digits;
  }
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++p;
    uint64_t fp = 0;
    double scale = 1.0;
    int fdigits = 0;
    while (p < end && *p >= '0' && *p <= '9' && fdigits < 18) {
      fp = fp * 10 + static_cast<unsigned>(*p - '0');
      scale *= 10.0;
      ++p;
      ++fdigits;
    }
    v += static_cast<double>(fp) / scale;
  }
  if (p < end && (*p == 'e' || *p == 'E' || (*p >= '0' && *p <= '9'))) {
    // overly long or scientific: defer to strtod for exactness
    char *next = nullptr;
    *out = strtod(start, &next);
    return next && next <= end ? next : start;
  }
  if (digits == 0 && v == 0.0) {
    *out = 0.0; // empty field
    return start;
  }
  *out = neg ? -v : v;
  return p;
}

EodTable *make_error(const char *msg) {
  auto *t = static_cast<EodTable *>(calloc(1, sizeof(EodTable)));
  t->error = strdup(msg);
  return t;
}

EodTable *parse_buffer(const char *buf, size_t len) {
  const char *p = buf;
  const char *end = buf + len;
  // skip header line
  while (p < end && *p != '\n')
    ++p;
  if (p < end)
    ++p;

  // count remaining newlines for a single allocation
  size_t cap = 0;
  for (const char *q = p; q < end; ++q)
    if (*q == '\n')
      ++cap;
  ++cap; // possible last line without trailing newline

  auto *t = static_cast<EodTable *>(calloc(1, sizeof(EodTable)));
  t->dates = static_cast<int64_t *>(malloc(cap * sizeof(int64_t)));
  double **cols[6] = {&t->open, &t->high,           &t->low,
                      &t->close, &t->adjusted_close, &t->volume};
  for (auto **c : cols)
    *c = static_cast<double *>(malloc(cap * sizeof(double)));

  int64_t n = 0;
  while (p < end && n < static_cast<int64_t>(cap)) {
    // date: YYYY-MM-DD
    if (end - p < 10 || p[4] != '-' || p[7] != '-') {
      // skip malformed/blank line
      while (p < end && *p != '\n')
        ++p;
      if (p < end)
        ++p;
      continue;
    }
    int64_t y = (p[0] - '0') * 1000 + (p[1] - '0') * 100 + (p[2] - '0') * 10 +
                (p[3] - '0');
    unsigned m = (p[5] - '0') * 10 + (p[6] - '0');
    unsigned d = (p[8] - '0') * 10 + (p[9] - '0');
    t->dates[n] = days_from_civil(y, m, d);
    p += 10;
    for (int c = 0; c < 6; ++c) {
      if (p < end && *p == ',')
        ++p;
      double v;
      p = parse_double(p, end, &v);
      (*cols[c])[n] = v;
      // skip to next delimiter if strtod stopped early (e.g. quotes)
      while (p < end && *p != ',' && *p != '\n')
        ++p;
    }
    while (p < end && *p != '\n')
      ++p;
    if (p < end)
      ++p;
    ++n;
  }
  t->n_rows = n;
  return t;
}

} // namespace

extern "C" {

EodTable *eod_parse(const char *path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0)
    return make_error("open failed");
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return make_error("stat failed or empty file");
  }
  void *buf = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED)
    return make_error("mmap failed");
  EodTable *t = parse_buffer(static_cast<const char *>(buf), st.st_size);
  munmap(buf, st.st_size);
  return t;
}

void eod_free(EodTable *t) {
  if (!t)
    return;
  free(t->dates);
  free(t->open);
  free(t->high);
  free(t->low);
  free(t->close);
  free(t->adjusted_close);
  free(t->volume);
  free(t->error);
  free(t);
}

// Threaded multi-file load: out[i] receives the table for paths[i].
void eod_parse_many(const char **paths, int n, EodTable **out, int n_threads) {
  if (n_threads < 1)
    n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n)
        return;
      out[i] = eod_parse(paths[i]);
    }
  };
  int k = n_threads < n ? n_threads : n;
  pool.reserve(k);
  for (int i = 0; i < k; ++i)
    pool.emplace_back(worker);
  for (auto &th : pool)
    th.join();
}

} // extern "C"
