// Asynchronous binary trajectory recorder (host runtime).
//
// The reference has no trajectory capture at all; our CLI's --record-every
// originally wrote one compressed .npz per frame, which costs ~1 s per
// million-agent snapshot of pure zlib on the sim thread.  This native
// writer double-buffers frames through a background thread so the sim loop
// only pays one memcpy, and streams a simple framed binary format:
//
//   file   := magic "PTRJ0001" | frame*
//   frame  := i64 step | i64 n | f32 pos[n*2] | i32 dest[n]
//
// Read back with pedoni_tpu_torch.native.read_trajectory (pure NumPy).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Frame {
  int64_t step;
  std::vector<float> pos;
  std::vector<int32_t> dest;
};

struct Writer {
  FILE* f = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Frame> queue;
  bool closing = false;

  void run() {
    for (;;) {
      Frame fr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        fr = std::move(queue.front());
        queue.pop_front();
      }
      const int64_t n = static_cast<int64_t>(fr.dest.size());
      std::fwrite(&fr.step, sizeof(int64_t), 1, f);
      std::fwrite(&n, sizeof(int64_t), 1, f);
      if (n > 0) {
        std::fwrite(fr.pos.data(), sizeof(float), fr.pos.size(), f);
        std::fwrite(fr.dest.data(), sizeof(int32_t), fr.dest.size(), f);
      }
    }
  }
};

}  // namespace

extern "C" void* pedoni_traj_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  static const char kMagic[8] = {'P', 'T', 'R', 'J', '0', '0', '0', '1'};
  std::fwrite(kMagic, 1, 8, f);
  Writer* w = new Writer();
  w->f = f;
  w->worker = std::thread([w] { w->run(); });
  return w;
}

extern "C" void pedoni_traj_append(void* handle, int64_t step, int64_t n,
                                   const float* pos, const int32_t* dest) {
  Writer* w = static_cast<Writer*>(handle);
  Frame fr;
  fr.step = step;
  fr.pos.assign(pos, pos + 2 * n);
  fr.dest.assign(dest, dest + n);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(fr));
  }
  w->cv.notify_one();
}

extern "C" int64_t pedoni_traj_pending(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lk(w->mu);
  return static_cast<int64_t>(w->queue.size());
}

extern "C" void pedoni_traj_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv.notify_one();
  w->worker.join();
  // Drain anything the worker left (closing with empty queue races are
  // prevented by the predicate: it only exits when the queue is empty).
  std::fclose(w->f);
  delete w;
}
