// nenhost: native host runtime for nenbody-tpu.
//
// The reference's runtime-around-compute is native Rust: a frame loop that
// records/submits command buffers and mirrors state into GPU buffers
// (src/main.rs:836-1013, gfx.rs:420-422). The equivalent here is the host
// side of the device loop: draining simulation snapshots to disk (frames,
// trajectories) without ever blocking the dispatch thread. This library
// provides that as a job ring + background worker:
//
//   - an MPSC job queue with one encoder/IO thread (the analog of the
//     reference's rayon command-recording pool, src/main.rs:584-647);
//   - a PNG encoder (zlib) for frame capture — the feature the reference
//     staged but never wired (BufferDimensions gfx.rs:129-155, png crate,
//     "C: capture" help text src/main.rs:111 with no key handler);
//   - a binary trajectory recorder (.nentraj) for checkpoint/replay;
//   - EMA step-time stats (the UI frametime readout, src/main.rs:69).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// PNG encoding (8-bit RGB/RGBA/gray, filter 0, one zlib stream)
// ---------------------------------------------------------------------------

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back(x >> 16);
  v.push_back(x >> 8);
  v.push_back(x);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

bool encode_png(int w, int h, int channels, const uint8_t* pixels,
                std::vector<uint8_t>& out) {
  if (channels != 1 && channels != 3 && channels != 4) return false;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.assign(sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;  // bit depth
  ihdr[9] = channels == 1 ? 0 : (channels == 3 ? 2 : 6);  // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // raw scanlines, each prefixed with filter byte 0
  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                6) != Z_OK)
    return false;
  put_chunk(out, "IDAT", z.data(), bound);
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const std::string& path, const uint8_t* data, size_t len) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  size_t n = std::fwrite(data, 1, len, f);
  std::fclose(f);
  return n == len;
}

// ---------------------------------------------------------------------------
// Host: job queue + worker thread
// ---------------------------------------------------------------------------

struct Host {
  std::deque<std::function<void()>> jobs;
  std::mutex mu;
  std::condition_variable cv_push, cv_drain;
  std::thread worker;
  std::atomic<long long> done{0};
  std::atomic<long long> errors{0};
  bool stop = false;
  bool busy = false;  // a popped job is still executing (guarded by mu)
  size_t max_queue;

  // step-time stats (EMA), host-side frametime readout
  std::mutex stats_mu;
  double ema_ms = 0.0;
  double ema_alpha = 0.1;
  long long samples = 0;

  explicit Host(size_t max_queue_) : max_queue(max_queue_) {
    worker = std::thread([this] { run(); });
  }

  void run() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [this] { return stop || !jobs.empty(); });
        if (jobs.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(jobs.front());
        jobs.pop_front();
        busy = true;  // flush() must not report drained mid-execution
      }
      job();
      {
        std::lock_guard<std::mutex> lk(mu);
        busy = false;
      }
      done.fetch_add(1);
      cv_drain.notify_all();
    }
  }

  // returns false if the queue is full (caller may run inline or drop)
  bool push(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (jobs.size() >= max_queue) return false;
      jobs.push_back(std::move(job));
    }
    cv_push.notify_one();
    return true;
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu);
    cv_drain.wait(lk, [this] { return jobs.empty() && !busy; });
  }

  ~Host() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_push.notify_all();
    if (worker.joinable()) worker.join();
  }
};

// ---------------------------------------------------------------------------
// Trajectory recorder (.nentraj): magic, version, n, dim; frames appended
// ---------------------------------------------------------------------------

struct Recorder {
  Host* host;
  FILE* f;
  uint32_t n;
  uint32_t dim;
  std::atomic<long long> frames{0};
};

}  // namespace

extern "C" {

void* nen_host_create(long long max_queue) {
  return new Host(max_queue > 0 ? static_cast<size_t>(max_queue) : 256);
}

void nen_host_destroy(void* h) { delete static_cast<Host*>(h); }

void nen_host_flush(void* h) { static_cast<Host*>(h)->flush(); }

long long nen_host_jobs_done(void* h) {
  return static_cast<Host*>(h)->done.load();
}

long long nen_host_errors(void* h) {
  return static_cast<Host*>(h)->errors.load();
}

// Async PNG write. Copies `data` (w*h*c bytes) before returning. Returns 1
// if queued, 0 if the queue was full and the frame was dropped (the viewer
// treats dropped frames like the reference's dropped-redraw warn,
// src/main.rs:902).
int nen_write_image_async(void* hv, const char* path, int w, int h, int c,
                          const uint8_t* data) {
  Host* host = static_cast<Host*>(hv);
  std::string p(path);
  std::vector<uint8_t> copy(data, data + static_cast<size_t>(w) * h * c);
  return host->push([host, p, w, h, c, copy = std::move(copy)]() {
    std::vector<uint8_t> png;
    if (!encode_png(w, h, c, copy.data(), png) ||
        !write_file(p, png.data(), png.size()))
      host->errors.fetch_add(1);
  })
             ? 1
             : 0;
}

// Synchronous PNG encode into a caller buffer (cap = buffer size). Returns
// encoded length, or -1 on failure / insufficient space.
long long nen_encode_png(int w, int h, int c, const uint8_t* data,
                         uint8_t* out, long long cap) {
  std::vector<uint8_t> png;
  if (!encode_png(w, h, c, data, png)) return -1;
  if (static_cast<long long>(png.size()) > cap) return -1;
  std::memcpy(out, png.data(), png.size());
  return static_cast<long long>(png.size());
}

void* nen_recorder_create(void* hv, const char* path, int n, int dim) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* r = new Recorder{static_cast<Host*>(hv), f, static_cast<uint32_t>(n),
                         static_cast<uint32_t>(dim)};
  const char magic[8] = {'N', 'E', 'N', 'T', 'R', 'J', '0', '1'};
  std::fwrite(magic, 1, 8, f);
  uint32_t hdr[2] = {r->n, r->dim};
  std::fwrite(hdr, 4, 2, f);
  return r;
}

// Append one frame (t, pos[n*dim], vel[n*dim]) asynchronously; copies data.
int nen_recorder_append(void* rv, long long t, const float* pos,
                        const float* vel) {
  auto* r = static_cast<Recorder*>(rv);
  size_t count = static_cast<size_t>(r->n) * r->dim;
  std::vector<float> p(pos, pos + count), v(vel, vel + count);
  bool ok = r->host->push([r, t, p = std::move(p), v = std::move(v)]() {
    std::fwrite(&t, 8, 1, r->f);
    std::fwrite(p.data(), 4, p.size(), r->f);
    std::fwrite(v.data(), 4, v.size(), r->f);
  });
  if (ok) r->frames.fetch_add(1);
  return ok ? 1 : 0;
}

long long nen_recorder_frames(void* rv) {
  return static_cast<Recorder*>(rv)->frames.load();
}

void nen_recorder_close(void* rv) {
  auto* r = static_cast<Recorder*>(rv);
  r->host->flush();
  std::fclose(r->f);
  delete r;
}

// EMA step-time stats: host-side frametime readout (src/main.rs:69, 894-897)
void nen_stats_record_ms(void* hv, double ms) {
  Host* host = static_cast<Host*>(hv);
  std::lock_guard<std::mutex> lk(host->stats_mu);
  host->ema_ms = host->samples == 0
                     ? ms
                     : host->ema_alpha * ms + (1 - host->ema_alpha) * host->ema_ms;
  host->samples++;
}

double nen_stats_ema_ms(void* hv) {
  Host* host = static_cast<Host*>(hv);
  std::lock_guard<std::mutex> lk(host->stats_mu);
  return host->ema_ms;
}

long long nen_stats_samples(void* hv) {
  Host* host = static_cast<Host*>(hv);
  std::lock_guard<std::mutex> lk(host->stats_mu);
  return host->samples;
}

}  // extern "C"
