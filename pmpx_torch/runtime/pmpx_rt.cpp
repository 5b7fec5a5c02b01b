// pmpx_torch native runtime: host-side services around the device's
// compute path (the port's own copy of pmpx/runtime/pmpx_rt.cpp).
//
// The reference's C++ host layer (simple_net/**/*.cu main() functions) does
// four jobs besides launching kernels: parse big whitespace-float data files
// (get_data, conv_mp.cu:62-79), stream per-iteration traces to disk
// (conv_mp.cu:283-289), draw weighted resampling indices with
// std::discrete_distribution (conv_mp.cu:253-259), and compute summary
// statistics (mean/stddev, conv_mp.cu:38-61).  This library provides those
// services beside the card: the sampler itself never leaves the device,
// but data ingest, crash-resilient trace streaming (double-buffered,
// background writer thread) and golden-reference statistics run natively.
//
// C ABI only (consumed via ctypes).  pmpx_torch.runtime builds it with g++
// into pmpx_torch/_build/ at its first use.

#include <atomic>
#include <cerrno>
#include <cmath>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Fast whitespace-separated float file reader (mmap + manual parse).
// Returns number of floats parsed, or -1 on error.  Caller provides the
// output buffer; call with out == nullptr to query the count first.
// ---------------------------------------------------------------------------
long long rt_read_floats(const char* path, float* out, long long cap) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  size_t len = static_cast<size_t>(st.st_size);
  if (len == 0) {
    close(fd);
    return 0;
  }
  void* mem = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -1;
  const char* p = static_cast<const char*>(mem);
  const char* end = p + len;
  long long n = 0;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                       *p == '\r' || *p == ','))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {  // unparsable token; skip one char defensively
      ++p;
      continue;
    }
    if (out != nullptr) {
      if (n >= cap) break;
      out[n] = v;
    }
    ++n;
    p = next;
  }
  munmap(mem, len);
  return n;
}

// ---------------------------------------------------------------------------
// Streaming binary trace writer: append fixed-width float rows from a
// background thread; rows are durable once flushed (fsync'd on flush/close).
// File layout: 16-byte header {magic 'PMPX', uint32 width, uint64 reserved}
// then row-major float32 data.  Readers derive the row count from the file
// size, so a crash mid-write loses at most the final partial row.
// ---------------------------------------------------------------------------
struct TraceWriter {
  FILE* f = nullptr;
  uint32_t width = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<float>> queue;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<long long> rows_written{0};
  // true while a popped row is being fwritten; flush must wait for it too,
  // otherwise a row popped-but-not-yet-written would be invisible to the
  // empty-queue check and could miss the fsync it was acknowledged under
  std::atomic<bool> in_flight{false};

  void loop() {
    for (;;) {
      std::vector<float> row;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) break;
          continue;
        }
        row = std::move(queue.front());
        queue.pop_front();
        in_flight.store(true);
      }
      fwrite(row.data(), sizeof(float), row.size(), f);
      rows_written.fetch_add(1);
      in_flight.store(false);
    }
    fflush(f);
    fsync(fileno(f));
  }
};

void* rt_trace_open(const char* path, uint32_t width) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  const char magic[4] = {'P', 'M', 'P', 'X'};
  uint64_t reserved = 0;
  fwrite(magic, 1, 4, f);
  fwrite(&width, sizeof(width), 1, f);
  fwrite(&reserved, sizeof(reserved), 1, f);
  fflush(f);
  auto* w = new TraceWriter();
  w->f = f;
  w->width = width;
  w->worker = std::thread([w] { w->loop(); });
  return w;
}

void rt_trace_append(void* handle, const float* row) {
  auto* w = static_cast<TraceWriter*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.emplace_back(row, row + w->width);
  }
  w->cv.notify_one();
}

long long rt_trace_flush(void* handle) {
  auto* w = static_cast<TraceWriter*>(handle);
  // wait for the queue AND any in-flight row to drain, then fsync
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(w->mu);
      if (w->queue.empty() && !w->in_flight.load()) break;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  fflush(w->f);
  fsync(fileno(w->f));
  return w->rows_written.load();
}

long long rt_trace_close(void* handle) {
  auto* w = static_cast<TraceWriter*>(handle);
  rt_trace_flush(handle);
  w->stop.store(true);
  w->cv.notify_all();
  w->worker.join();
  long long rows = w->rows_written.load();
  fclose(w->f);
  delete w;
  return rows;
}

// Read a trace file written by TraceWriter. Returns rows read (<= cap).
long long rt_trace_read(const char* path, float* out, long long cap,
                        uint32_t* width_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t width;
  uint64_t reserved;
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "PMPX", 4) != 0 ||
      fread(&width, sizeof(width), 1, f) != 1 ||
      fread(&reserved, sizeof(reserved), 1, f) != 1) {
    fclose(f);
    return -1;
  }
  *width_out = width;
  long long rows = 0;
  std::vector<float> row(width);
  while (rows < cap &&
         fread(row.data(), sizeof(float), width, f) == width) {
    memcpy(out + rows * width, row.data(), width * sizeof(float));
    ++rows;
  }
  fclose(f);
  return rows;
}

// ---------------------------------------------------------------------------
// Weighted resampling with std::discrete_distribution + mt19937 — the exact
// host semantics of the reference (conv_mp.cu:253-259), kept as a golden
// reference for the on-device categorical resampler.
// ---------------------------------------------------------------------------
void rt_discrete_sample(const double* weights, int n, int* out,
                        int n_draws, uint64_t seed) {
  std::mt19937 gen(static_cast<uint32_t>(seed));
  std::discrete_distribution<> dist(weights, weights + n);
  for (int i = 0; i < n_draws; ++i) out[i] = dist(gen);
}

// ---------------------------------------------------------------------------
// Direct-sum autocovariance (double accumulation) — numerics oracle for the
// on-device FFT implementation in pmpx.metrics.ess.
// ---------------------------------------------------------------------------
void rt_autocov(const float* x, long long n, double* out, int maxlag) {
  double mean = 0.0;
  for (long long i = 0; i < n; ++i) mean += x[i];
  mean /= static_cast<double>(n);
  for (int k = 0; k <= maxlag; ++k) {
    double s = 0.0;
    for (long long i = 0; i + k < n; ++i)
      s += (x[i] - mean) * (x[i + k] - mean);
    out[k] = s / static_cast<double>(n);
  }
}

// mean / stddev helpers (conv_mp.cu:38-53 parity, double accumulation)
void rt_mean_std(const float* x, long long n, double* mean_out,
                 double* std_out) {
  double m = 0.0;
  for (long long i = 0; i < n; ++i) m += x[i];
  m /= static_cast<double>(n);
  double v = 0.0;
  for (long long i = 0; i < n; ++i) v += (x[i] - m) * (x[i] - m);
  v /= static_cast<double>(n);
  *mean_out = m;
  *std_out = v > 0 ? std::sqrt(v) : 0.0;
}

}  // extern "C"
