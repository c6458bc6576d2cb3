// Host native runtime: sample conversion + threaded block feed.
//
// Native equivalents of the reference's C++ real-time layer where the work
// is genuinely host-bound (SURVEY.md §2.1):
//  * u8 -> float32 normalization    (readStdinBlockData, src/iofunc.cpp:128-135)
//  * float -> int16 PCM quantize    (threadMonoOnly.cpp:186-191, NaN->0 :188)
//  * bounded-queue producer thread  (std::queue + mutex + cvar, cap 6,
//                                    src/project.cpp:141-149,181-189,
//                                    QUEUE_ELEMS include/dy4.h:30)
// The DSP itself runs on the device (jax/XLA); this feed overlaps host reads
// and normalization with device compute, which is the role the reference's
// producer thread played for its consumer.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Elementwise conversions (compiler auto-vectorizes these loops)
// ---------------------------------------------------------------------------

void sdr_u8_normalize(const uint8_t* in, float* out, int64_t n) {
  constexpr float kScale = 1.0f / 128.0f;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (static_cast<float>(in[i]) - 128.0f) * kScale;
  }
}

void sdr_pcm_quantize(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i];
    if (std::isnan(v)) v = 0.0f;           // ref NaN clamp
    v *= 16384.0f;                          // ref full-scale factor
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(v);
  }
}

// ---------------------------------------------------------------------------
// Threaded block reader: producer thread fills a bounded queue of
// normalized float blocks from a file descriptor.
// ---------------------------------------------------------------------------

struct BlockReader {
  int fd;
  int64_t block_size;          // u8 samples per block
  size_t capacity;             // queue bound (ref QUEUE_ELEMS = 6)
  // the queue carries RAW bytes: the float consumer API normalizes at
  // pop (a ~0.1 ms pass, negligible against device block time), and the
  // raw consumer API hands the bytes straight to the device, where the
  // u8 front-end normalizes at a quarter of the host->device traffic
  std::queue<std::vector<uint8_t>> queue;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};
  std::thread producer;

  void run() {
    while (!stop.load()) {
      std::vector<uint8_t> raw(block_size);
      int64_t got = 0;
      while (got < block_size) {          // full-block read like the ref
        ssize_t r = ::read(fd, raw.data() + got, block_size - got);
        if (r <= 0) { goto done; }        // EOF/error: drop short tail
        got += r;
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return queue.size() < capacity || stop.load();
        });
        if (stop.load()) break;
        queue.push(std::move(raw));
      }
      cv_data.notify_one();
    }
  done:
    eof.store(true);
    cv_data.notify_all();
  }

  bool pop(std::vector<uint8_t>* block) {
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_data.wait(lk, [&] { return !queue.empty() || eof.load(); });
      if (queue.empty()) return false;
      *block = std::move(queue.front());
      queue.pop();
    }
    cv_space.notify_one();
    return true;
  }
};

void* sdr_reader_create(int fd, int64_t block_size, int capacity) {
  auto* r = new BlockReader();
  r->fd = fd;
  r->block_size = block_size;
  r->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 6;
  r->producer = std::thread([r] { r->run(); });
  return r;
}

// Returns 1 and fills `out` (block_size floats) when a block is available;
// 0 at end of stream.
int sdr_reader_next(void* handle, float* out) {
  auto* r = static_cast<BlockReader*>(handle);
  std::vector<uint8_t> block;
  if (!r->pop(&block)) return 0;
  sdr_u8_normalize(block.data(), out, static_cast<int64_t>(block.size()));
  return 1;
}

// Raw variant: fills `out` with the block's raw u8 bytes (device-side
// normalization path).  Returns 1 on success, 0 at end of stream.
int sdr_reader_next_u8(void* handle, uint8_t* out) {
  auto* r = static_cast<BlockReader*>(handle);
  std::vector<uint8_t> block;
  if (!r->pop(&block)) return 0;
  std::memcpy(out, block.data(), block.size());
  return 1;
}

// Number of blocks currently buffered (for tests/telemetry).
int sdr_reader_depth(void* handle) {
  auto* r = static_cast<BlockReader*>(handle);
  std::lock_guard<std::mutex> lk(r->mu);
  return static_cast<int>(r->queue.size());
}

void sdr_reader_destroy(void* handle) {
  auto* r = static_cast<BlockReader*>(handle);
  r->stop.store(true);
  r->cv_space.notify_all();
  if (r->producer.joinable()) r->producer.join();
  delete r;
}

}  // extern "C"
