// Host C++ (not a CUDA kernel): the Predictor's packing of each raw
// frame's crop window into one flat float32 buffer (awr_tpu_torch/data/
// windows.py), the host work before the upload.  One memcpy per window
// row when the frames' columns are contiguous; the threads take blocks of
// rows from a shared counter.  Called through ctypes, which drops the
// interpreter lock.
//
// Built at first use with the host C++ compiler into build/awr_tpu_torch/
// (awr_tpu_torch/kernels.py).  Bound by memory: one read of the windows'
// pixels and one write of the buffer.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// rows taken a block at a time from a shared counter, so a thread that
// another process holds off its core leaves its share to the others
constexpr int64_t kBlock = 32;

struct Job {
  const float* src;
  int64_t stride_b, stride_h, stride_w;
  const int32_t *v0, *u0, *w;
  const int64_t* base;
  float* dst;
  std::vector<int64_t> starts;  // starts[i]: window i's first row
  std::atomic<int64_t> next{0};
};

void copy_rows(Job* job) {
  const std::vector<int64_t>& starts = job->starts;
  const int64_t rows = starts.back();
  for (;;) {
    const int64_t lo = job->next.fetch_add(kBlock);
    if (lo >= rows) return;
    const int64_t hi = std::min(lo + kBlock, rows);
    int64_t i = std::upper_bound(starts.begin(), starts.end(), lo) -
                starts.begin() - 1;
    for (int64_t g = lo; g < hi; ++g) {
      while (g >= starts[i + 1]) ++i;
      const int64_t r = g - starts[i];
      const int64_t w = job->w[i];
      const float* s = job->src + i * job->stride_b +
                       (job->v0[i] + r) * job->stride_h +
                       job->u0[i] * job->stride_w;
      float* d = job->dst + job->base[i] + r * w;
      if (job->stride_w == 1) {
        std::memcpy(d, s, sizeof(float) * size_t(w));
      } else {
        for (int64_t c = 0; c < w; ++c) d[c] = s[c * job->stride_w];
      }
    }
  }
}

}  // namespace

// src: element [0, 0, 0] of n (H0, W0) float32 frames, strides in
// elements (any sign).  Window i: rows [v0[i], v0[i] + h[i]), columns
// [u0[i], u0[i] + w[i]) of frame i, written row by row to dst + base[i].
// The caller keeps every window inside its frame and the buffer.
extern "C" void awr_pack_windows(const float* src, int64_t n,
                                 int64_t stride_b, int64_t stride_h,
                                 int64_t stride_w, const int32_t* v0,
                                 const int32_t* u0, const int32_t* h,
                                 const int32_t* w, const int64_t* base,
                                 float* dst, int n_threads) {
  Job job;
  job.src = src;
  job.stride_b = stride_b;
  job.stride_h = stride_h;
  job.stride_w = stride_w;
  job.v0 = v0;
  job.u0 = u0;
  job.w = w;
  job.base = base;
  job.dst = dst;
  job.starts.assign(size_t(n) + 1, 0);
  int64_t floats = 0;
  for (int64_t i = 0; i < n; ++i) {
    job.starts[i + 1] = job.starts[i] + h[i];
    floats += int64_t(h[i]) * w[i];
  }
  // a thread for each MiB at least: a small call stays on this thread
  const int64_t by_size = std::max<int64_t>(1, floats / (1 << 18));
  const int64_t t = std::min<int64_t>(std::max(n_threads, 1), by_size);
  std::vector<std::thread> pool;
  for (int64_t k = 1; k < t; ++k) pool.emplace_back(copy_rows, &job);
  copy_rows(&job);
  for (auto& th : pool) th.join();
}
