// Multi-threaded image prefetcher for the dataset feed.
//
// The reference's message sources read + decode serially on the compute
// thread (srrg2_core MessageFileSource; the pipeline is single-threaded,
// SURVEY.md §2.3).  For an accelerator pipeline the host must hide decode latency
// behind device compute: this prefetcher decodes a window of upcoming files
// on a worker pool and hands frames out in order through a bounded queue.

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" uint8_t* psl_decode_file(const char* path, int* w, int* h,
                                    int* channels, int* bitdepth);

namespace {

struct Frame {
  uint8_t* pixels = nullptr;
  int w = 0, h = 0, channels = 0, bitdepth = 0;
  bool ready = false;
  bool failed = false;
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<Frame> frames;
  size_t next_to_schedule = 0;  // next index a worker may claim
  size_t next_to_consume = 0;   // next index the consumer waits for
  size_t window = 0;            // max decoded-ahead distance
  bool shutdown = false;
  std::mutex mu;
  std::condition_variable cv_worker;
  std::condition_variable cv_consumer;
  std::vector<std::thread> workers;

  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return shutdown ||
                 (next_to_schedule < paths.size() &&
                  next_to_schedule < next_to_consume + window);
        });
        if (shutdown) return;
        idx = next_to_schedule++;
      }
      Frame f;
      f.pixels = psl_decode_file(paths[idx].c_str(), &f.w, &f.h, &f.channels,
                                 &f.bitdepth);
      f.failed = (f.pixels == nullptr);
      f.ready = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        frames[idx] = f;
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* psl_prefetch_create(const char** paths, int n, int n_threads,
                          int window) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->frames.resize(n);
  p->window = window > 0 ? static_cast<size_t>(window) : 8;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i) {
    p->workers.emplace_back([p] { p->worker_loop(); });
  }
  return p;
}

// Blocks until the next in-order frame is decoded.  Returns the pixel
// buffer (caller frees with psl_free) or nullptr at end-of-stream / on
// decode failure (failure sets *w = -1).
uint8_t* psl_prefetch_next(void* handle, int* w, int* h, int* channels,
                           int* bitdepth) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_to_consume >= p->paths.size()) {
    *w = 0;
    return nullptr;  // end of stream
  }
  size_t idx = p->next_to_consume;
  p->cv_consumer.wait(lk, [&] { return p->frames[idx].ready; });
  Frame f = p->frames[idx];
  p->frames[idx] = Frame();  // ownership moves to caller
  p->next_to_consume++;
  p->cv_worker.notify_all();  // window advanced
  lk.unlock();
  if (f.failed) {
    *w = -1;
    return nullptr;
  }
  *w = f.w;
  *h = f.h;
  *channels = f.channels;
  *bitdepth = f.bitdepth;
  return f.pixels;
}

void psl_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->shutdown = true;
  }
  p->cv_worker.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& f : p->frames) {
    if (f.pixels) std::free(f.pixels);
  }
  delete p;
}

}  // extern "C"
