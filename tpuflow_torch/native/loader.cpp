// tpuflow native trajectory-store loader.
//
// TPU-native rebuild of the reference's data pipeline hot path
// (SURVEY.md §2 "Dataset loader" / L1): the reference reads
// OpenFOAM-exported archives with Python (h5py) on the host; at
// multi-GB dataset scale that serializes batch assembly with the
// train step. This loader keeps the accelerator fed instead:
//
//   * .tpf store: JSON header + page-aligned raw float32 trajectory
//     arrays, read with pread(2) (no Python in the copy path, OS page
//     cache does read-ahead);
//   * fused per-channel affine normalization during the gather (one
//     pass, no second sweep over the batch);
//   * a std::thread worker pool + ticket API so Python can
//     double-buffer: issue the async gather for batch k+1, train on
//     batch k, wait on the ticket.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC -o _tpfloader.so loader.cpp -lpthread

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct ArrayMeta {
  int64_t shape[5];  // (N, T, H, W, C)
  int64_t offset;    // byte offset of array start
};

struct Store {
  int fd = -1;
  ArrayMeta lf{}, hf{};
  // In-flight readers pin the Store: tpf_close must not delete it (or
  // close/reuse the fd) under a thread that is mid-pread. Guarded by
  // g_mu; g_refs_cv signals the close waiter when refs hits 0.
  int refs = 0;
};

int64_t numel4(const int64_t* s) {  // per-trajectory elements (T*H*W*C)
  return s[1] * s[2] * s[3] * s[4];
}

// ---- minimal JSON field extraction (header is produced by our own
// writer, so a tolerant scan for "key": value is sufficient) ----
bool json_i64_array(const std::string& j, const std::string& key,
                    int64_t* out, int n) {
  auto p = j.find("\"" + key + "\"");
  if (p == std::string::npos) return false;
  p = j.find('[', p);
  if (p == std::string::npos) return false;
  ++p;
  for (int i = 0; i < n; ++i) {
    out[i] = strtoll(j.c_str() + p, nullptr, 10);
    p = j.find_first_of(",]", p);
    if (p == std::string::npos) return false;
    ++p;
  }
  return true;
}

bool json_i64(const std::string& j, const std::string& key, int64_t* out) {
  auto p = j.find("\"" + key + "\"");
  if (p == std::string::npos) return false;
  p = j.find(':', p);
  if (p == std::string::npos) return false;
  *out = strtoll(j.c_str() + p + 1, nullptr, 10);
  return true;
}

// ---- worker pool ----
struct Task {
  int64_t ticket;
  std::function<void()> fn;
};

class Pool {
 public:
  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  int64_t submit(std::function<void()> fn) {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t ticket = next_ticket_++;
    queue_.push_back(Task{ticket, std::move(fn)});
    cv_.notify_one();
    return ticket;
  }
  void wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return done_.count(ticket) > 0; });
    done_.erase(ticket);
  }

 private:
  void run() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      task.fn();
      {
        std::unique_lock<std::mutex> lk(mu_);
        done_.insert({task.ticket, true});
      }
      done_cv_.notify_all();
    }
  }
  std::vector<std::thread> threads_;
  std::deque<Task> queue_;
  std::map<int64_t, bool> done_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_ = false;
  int64_t next_ticket_ = 1;
};

std::mutex g_mu;
std::condition_variable g_refs_cv;
std::map<int64_t, Store*> g_stores;
int64_t g_next_handle = 1;
Pool* g_pool = nullptr;
std::string g_error;

void set_error(const std::string& e) {
  std::unique_lock<std::mutex> lk(g_mu);
  g_error = e;
}

// Pin the store for the duration of a read: ctypes releases the GIL
// during foreign calls, so another Python thread can call tpf_close
// while this thread is mid-gather. acquire/release + the close-side
// wait make that safe (close blocks until in-flight readers drain).
Store* acquire(int64_t h) {
  std::unique_lock<std::mutex> lk(g_mu);
  auto it = g_stores.find(h);
  if (it == g_stores.end()) return nullptr;
  ++it->second->refs;
  return it->second;
}

void release(Store* s) {
  std::unique_lock<std::mutex> lk(g_mu);
  if (--s->refs == 0) g_refs_cv.notify_all();
}

// Gather one (traj, [t0,t1)) window of array `which` into out,
// applying per-channel out = (x - mean[c]) * inv_std[c] when norm set.
bool gather(const Store* s, int which, int64_t traj, int64_t t0, int64_t t1,
            const float* mean, const float* inv_std, float* out) {
  const ArrayMeta& a = which == 0 ? s->lf : s->hf;
  const int64_t T = a.shape[1];
  if (traj < 0 || traj >= a.shape[0] || t0 < 0 || t1 > T || t0 >= t1)
    return false;
  const int64_t step = a.shape[2] * a.shape[3] * a.shape[4];
  const int64_t c = a.shape[4];
  const int64_t count = (t1 - t0) * step;
  const int64_t off =
      a.offset + (traj * numel4(a.shape) + t0 * step) * (int64_t)sizeof(float);
  int64_t bytes = count * (int64_t)sizeof(float);
  char* dst = reinterpret_cast<char*>(out);
  int64_t pos = off;
  while (bytes > 0) {
    ssize_t got = pread(s->fd, dst, bytes, pos);
    if (got < 0) {
      if (errno == EINTR) continue;  // signal landed mid-read: retry
      return false;
    }
    if (got == 0) return false;  // unexpected EOF (truncated store)
    dst += got;
    pos += got;
    bytes -= got;
  }
  if (mean != nullptr) {
    for (int64_t i = 0; i < count; ++i) {
      const int64_t ch = i % c;
      out[i] = (out[i] - mean[ch]) * inv_std[ch];
    }
  }
  return true;
}

}  // namespace

extern "C" {

const char* tpf_last_error() {
  // Copy under the lock: returning g_error.c_str() directly races with
  // a concurrent set_error reallocating the buffer (dangling pointer).
  static thread_local std::string copy;
  std::unique_lock<std::mutex> lk(g_mu);
  copy = g_error;
  return copy.c_str();
}

int64_t tpf_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    set_error(std::string("open failed: ") + path);
    return 0;
  }
  char magic[8] = {0};
  uint64_t header_len = 0;
  if (pread(fd, magic, 4, 0) != 4 || memcmp(magic, "TPF1", 4) != 0 ||
      pread(fd, &header_len, 8, 4) != 8 || header_len > (64 << 10)) {
    set_error("bad magic/header");
    close(fd);
    return 0;
  }
  std::string header(header_len, '\0');
  if (pread(fd, header.data(), header_len, 12) != (ssize_t)header_len) {
    set_error("short header read");
    close(fd);
    return 0;
  }
  auto* s = new Store();
  s->fd = fd;
  bool ok = json_i64_array(header, "lf_shape", s->lf.shape, 5) &&
            json_i64_array(header, "hf_shape", s->hf.shape, 5) &&
            json_i64(header, "lf_offset", &s->lf.offset) &&
            json_i64(header, "hf_offset", &s->hf.offset);
  if (!ok) {
    set_error("header missing fields");
    close(fd);
    delete s;
    return 0;
  }
  std::unique_lock<std::mutex> lk(g_mu);
  if (g_pool == nullptr)
    g_pool = new Pool(std::max(2u, std::thread::hardware_concurrency() / 4));
  int64_t h = g_next_handle++;
  g_stores[h] = s;
  return h;
}

void tpf_close(int64_t handle) {
  Store* s = nullptr;
  {
    std::unique_lock<std::mutex> lk(g_mu);
    auto it = g_stores.find(handle);
    if (it == g_stores.end()) return;
    s = it->second;
    g_stores.erase(it);  // no new acquires can find the handle
    // Wait for in-flight readers to release before freeing: a worker
    // can be mid-pread with the GIL dropped on the Python side.
    g_refs_cv.wait(lk, [&] { return s->refs == 0; });
  }
  close(s->fd);
  delete s;
}

// out_shapes: int64[10] = lf (N,T,h,w,C) then hf (N,T,H,W,C).
int tpf_info(int64_t handle, int64_t* out_shapes) {
  Store* s = acquire(handle);
  if (!s) return -1;
  memcpy(out_shapes, s->lf.shape, 5 * sizeof(int64_t));
  memcpy(out_shapes + 5, s->hf.shape, 5 * sizeof(int64_t));
  release(s);
  return 0;
}

// Synchronous batched gather: for b in [0,n): window [t0,t1) of
// trajectory traj_ids[b] into out[b] (contiguous (n, t1-t0, H, W, C)).
// mean/inv_std may be null (raw copy). which: 0 = lf, 1 = hf.
int tpf_read_batch(int64_t handle, int which, const int64_t* traj_ids,
                   int64_t n, int64_t t0, int64_t t1, const float* mean,
                   const float* inv_std, float* out) {
  Store* s = acquire(handle);
  if (!s) return -1;
  const ArrayMeta& a = which == 0 ? s->lf : s->hf;
  const int64_t win = (t1 - t0) * a.shape[2] * a.shape[3] * a.shape[4];
  int rc = 0;
  for (int64_t b = 0; b < n && rc == 0; ++b)
    if (!gather(s, which, traj_ids[b], t0, t1, mean, inv_std, out + b * win))
      rc = -2;
  release(s);
  return rc;
}

// Async variant: returns a ticket (>0); tpf_wait blocks until the
// gather completed. traj_ids/mean/inv_std/out must stay alive.
int64_t tpf_read_batch_async(int64_t handle, int which,
                             const int64_t* traj_ids, int64_t n, int64_t t0,
                             int64_t t1, const float* mean,
                             const float* inv_std, float* out,
                             int* status_out) {
  {
    std::unique_lock<std::mutex> lk(g_mu);
    if (g_stores.find(handle) == g_stores.end() || g_pool == nullptr)
      return 0;
  }
  // The queued task re-resolves the handle via acquire(): if the store
  // is closed before the task runs, the gather fails cleanly (-2)
  // instead of touching freed memory.
  std::vector<int64_t> ids(traj_ids, traj_ids + n);
  *status_out = 1;  // in flight
  return g_pool->submit([=] {
    int rc = tpf_read_batch(handle, which, ids.data(), n, t0, t1, mean,
                            inv_std, out);
    *status_out = rc == 0 ? 0 : -2;
  });
}

void tpf_wait(int64_t ticket) {
  if (g_pool != nullptr && ticket > 0) g_pool->wait(ticket);
}

}  // extern "C"
