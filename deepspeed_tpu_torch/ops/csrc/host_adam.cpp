// Host-side Adam/AdamW, Adagrad and Lion for ZeRO-Offload.
//
// The port's own copy of the JAX package's csrc/host_adam.cpp (the
// reference's csrc/adam/cpu_adam_impl.cpp, csrc/adagrad/cpu_adagrad.cpp,
// csrc/lion/cpu_lion_impl.cpp). Contiguous fp32 loops that the compiler
// vectorizes to the host ISA (-O3 -march=native, without -ffast-math: its
// crtfastmath.o would set FTZ/DAZ for the whole process), run over a
// persistent std::thread pool. One change from the copy: ds_f32_to_bf16
// narrows a NaN to a quiet NaN, where the original's rounding carries a
// NaN whose high mantissa bits are zero into +-inf.
//
// C ABI (ctypes-friendly): all state is caller-owned flat fp32 buffers.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), pending_(0) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.back());
            jobs_.pop_back();
          }
          job();
          if (--pending_ == 0) {
            std::unique_lock<std::mutex> lk(mu_);
            done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void run(std::function<void()> job) {
    ++pending_;
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push_back(std::move(job));
    }
    cv_.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  std::vector<std::thread> workers_;
  std::vector<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_;
  std::atomic<int> pending_;
};

ThreadPool& pool() {
  static ThreadPool p(std::max(1u, std::thread::hardware_concurrency() / 2));
  return p;
}

inline void adam_span(float* __restrict p, const float* __restrict g,
                      float* __restrict m, float* __restrict v, int64_t n,
                      float lr, float beta1, float beta2, float eps,
                      float weight_decay, bool adamw, float bc1, float bc2) {
  const float one_m_b1 = 1.0f - beta1;
  const float one_m_b2 = 1.0f - beta2;
  // single contiguous loop: clang/gcc vectorize this to the native ISA
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
    float mi = beta1 * m[i] + one_m_b1 * grad;
    float vi = beta2 * v[i] + one_m_b2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float update = (mi / bc1) / (std::sqrt(vi / bc2) + eps);
    if (adamw && weight_decay != 0.0f) update += weight_decay * p[i];
    p[i] -= lr * update;
  }
}

}  // namespace

extern "C" {

// One fused Adam sweep over a flat fp32 buffer, parallelized across the
// host thread pool (reference ds_adam_step, csrc/adam/cpu_adam_impl.cpp).
void ds_host_adam_step(float* params, const float* grads, float* exp_avg,
                       float* exp_avg_sq, int64_t n, int32_t step, float lr,
                       float beta1, float beta2, float eps,
                       float weight_decay, int32_t adamw_mode) {
  const float bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
  const float bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  const int nthreads = pool().size();
  const int64_t chunk = std::max<int64_t>((n + nthreads - 1) / nthreads,
                                          1 << 16);
  for (int64_t off = 0; off < n; off += chunk) {
    const int64_t len = std::min(chunk, n - off);
    pool().run([=] {
      adam_span(params + off, grads + off, exp_avg + off, exp_avg_sq + off,
                len, lr, beta1, beta2, eps, weight_decay, adamw_mode != 0,
                bc1, bc2);
    });
  }
  pool().wait();
}

// Host Adagrad sweep (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_host_adagrad_step(float* params, const float* grads,
                          float* exp_avg_sq, int64_t n, float lr, float eps,
                          float weight_decay) {
  const int nthreads = pool().size();
  const int64_t chunk = std::max<int64_t>((n + nthreads - 1) / nthreads,
                                          1 << 16);
  for (int64_t off = 0; off < n; off += chunk) {
    const int64_t len = std::min(chunk, n - off);
    float* p = params + off;
    const float* g = grads + off;
    float* s = exp_avg_sq + off;
    pool().run([=] {
      for (int64_t i = 0; i < len; ++i) {
        float grad = g[i];
        if (weight_decay != 0.0f) grad += weight_decay * p[i];
        s[i] += grad * grad;
        p[i] -= lr * grad / (std::sqrt(s[i]) + eps);
      }
    });
  }
  pool().wait();
}

// Host Lion sweep (reference csrc/lion/cpu_lion_impl.cpp): sign of the
// interpolated momentum, decoupled weight decay.
void ds_host_lion_step(float* params, const float* grads, float* exp_avg,
                       int64_t n, float lr, float beta1, float beta2,
                       float weight_decay) {
  const float one_m_b1 = 1.0f - beta1;
  const float one_m_b2 = 1.0f - beta2;
  const int nthreads = pool().size();
  const int64_t chunk = std::max<int64_t>((n + nthreads - 1) / nthreads,
                                          1 << 16);
  for (int64_t off = 0; off < n; off += chunk) {
    const int64_t len = std::min(chunk, n - off);
    float* p = params + off;
    const float* g = grads + off;
    float* m = exp_avg + off;
    pool().run([=] {
      for (int64_t i = 0; i < len; ++i) {
        const float c = beta1 * m[i] + one_m_b1 * g[i];
        const float u = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
        p[i] -= lr * (u + weight_decay * p[i]);
        m[i] = beta2 * m[i] + one_m_b2 * g[i];
      }
    });
  }
  pool().wait();
}

// bf16 (stored as uint16) -> fp32 widening copy, vectorizable; used when
// grads arrive from device in bf16 (reference: cpu_adam half paths).
void ds_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
    std::memcpy(&dst[i], &bits, sizeof(float));
  }
}

// fp32 -> bf16 round-to-nearest-even. A NaN becomes the quiet NaN 0xFFFF,
// the word ATen's vectorized CPU cast gives every NaN: adding the rounding
// bias to a NaN whose mantissa bits 16-22 are zero (0x7F800001) would carry
// into the exponent and give +-inf.
void ds_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], sizeof(float));
    if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {
      dst[i] = 0xFFFFu;
      continue;
    }
    uint32_t lsb = (bits >> 16) & 1u;
    uint32_t rounded = bits + 0x7FFFu + lsb;
    dst[i] = static_cast<uint16_t>(rounded >> 16);
  }
}

// L2 norm over a flat buffer (overflow/clip support on host).
double ds_l2_norm_sq(const float* x, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += static_cast<double>(x[i]) * x[i];
  return acc;
}

}  // extern "C"
