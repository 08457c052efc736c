// Asynchronous file I/O engine for the NVMe optimizer tier and the
// layer-streamed parameter tier.
//
// The port's own copy of the JAX package's csrc/async_io.cpp (the
// reference's csrc/aio/py_lib/deepspeed_aio_thread.cpp and
// deepspeed_py_aio.cpp): a submit queue feeding a std::thread worker pool
// that issues pread/pwrite (O_DIRECT optional), a completion count and a
// drain barrier, with a C ABI for ctypes.

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Request {
  int64_t id;
  bool write;
  std::string path;
  void* buf;
  int64_t nbytes;
  int64_t offset;
};

class AsyncIOEngine {
 public:
  AsyncIOEngine(int num_threads, bool o_direct)
      : o_direct_(o_direct), stop_(false), next_id_(1), completed_(0),
        errors_(0) {
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] { worker(); });
    }
  }

  ~AsyncIOEngine() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  int64_t submit(bool write, const char* path, void* buf, int64_t nbytes,
                 int64_t offset) {
    Request r;
    r.write = write;
    r.path = path;
    r.buf = buf;
    r.nbytes = nbytes;
    r.offset = offset;
    {
      std::unique_lock<std::mutex> lk(mu_);
      r.id = next_id_++;
      queue_.push_back(r);
    }
    cv_.notify_one();
    return r.id;
  }

  // Block until all submitted requests completed; returns error count.
  int64_t drain() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] {
      return queue_.empty() && inflight_ == 0;
    });
    return errors_.load();
  }

  int64_t completed() const { return completed_.load(); }

 private:
  void worker() {
    for (;;) {
      Request r;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        r = queue_.front();
        queue_.pop_front();
        ++inflight_;
      }
      process(r);
      {
        std::unique_lock<std::mutex> lk(mu_);
        --inflight_;
        ++completed_;
        if (queue_.empty() && inflight_ == 0) done_cv_.notify_all();
      }
    }
  }

  void process(const Request& r) {
    int flags = r.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
    if (o_direct_) flags |= O_DIRECT;
#endif
    int fd = ::open(r.path.c_str(), flags, 0644);
    if (fd < 0 && o_direct_) {
      // filesystem may not support O_DIRECT (tmpfs): retry buffered
      fd = ::open(r.path.c_str(),
                  r.write ? (O_WRONLY | O_CREAT) : O_RDONLY, 0644);
    }
    if (fd < 0) {
      ++errors_;
      return;
    }
    int64_t off = r.offset;
    char* p = static_cast<char*>(r.buf);
    int64_t left = r.nbytes;
    while (left > 0) {
      ssize_t n = r.write ? ::pwrite(fd, p, left, off)
                          : ::pread(fd, p, left, off);
      if (n <= 0) {
        ++errors_;
        break;
      }
      p += n;
      off += n;
      left -= n;
    }
    ::close(fd);
  }

  bool o_direct_;
  bool stop_;
  int64_t next_id_;
  int64_t inflight_ = 0;
  std::atomic<int64_t> completed_, errors_;
  std::deque<Request> queue_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
};

}  // namespace

extern "C" {

void* ds_aio_create(int32_t num_threads, int32_t o_direct) {
  return new AsyncIOEngine(num_threads > 0 ? num_threads : 4, o_direct != 0);
}

void ds_aio_destroy(void* h) { delete static_cast<AsyncIOEngine*>(h); }

int64_t ds_aio_pwrite(void* h, const char* path, void* buf, int64_t nbytes,
                      int64_t offset) {
  return static_cast<AsyncIOEngine*>(h)->submit(true, path, buf, nbytes,
                                                offset);
}

int64_t ds_aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                     int64_t offset) {
  return static_cast<AsyncIOEngine*>(h)->submit(false, path, buf, nbytes,
                                                offset);
}

int64_t ds_aio_drain(void* h) {
  return static_cast<AsyncIOEngine*>(h)->drain();
}

int64_t ds_aio_completed(void* h) {
  return static_cast<AsyncIOEngine*>(h)->completed();
}

}  // extern "C"
