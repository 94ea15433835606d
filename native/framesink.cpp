// framesink: asynchronous PNG frame writer for the engine's record path.
//
// The reference's host runtime is native (Rust) end to end; in this engine
// the compute path is JAX/XLA on the accelerator and the only host-side hot loop left is
// frame IO — PNG-encoding a 1080p frame in Python (PIL) costs ~50 ms on this
// box's single core, which would serialize the whole interactive/record
// loop.  This C++ component owns that path: a bounded queue + worker threads
// that zlib-compress and write PNGs off the simulation thread.
//
// C API (ctypes-friendly):
//   void* fs_create(const char* dir, int width, int height, int workers,
//                   int queue_capacity);
//   int   fs_submit(void* h, long frame_index, const unsigned char* rgb);
//         // copies the buffer; returns 0 ok, -1 queue full (caller may spin)
//   long  fs_pending(void* h);
//   void  fs_close(void* h);   // drains queue, joins workers, frees handle
//
// Build: g++ -O2 -shared -fPIC -o libframesink.so framesink.cpp -lz -lpthread

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

// Encode 8-bit RGB rows into a complete PNG byte stream.
std::vector<uint8_t> encode_png(const uint8_t* rgb, int w, int h) {
  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // raw scanlines with filter byte 0
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
  }
  uLongf zcap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> zbuf(zcap);
  // level 1: this sink favors throughput over ratio
  compress2(zbuf.data(), &zcap, raw.data(), static_cast<uLong>(raw.size()), 1);
  put_chunk(out, "IDAT", zbuf.data(), zcap);
  put_chunk(out, "IEND", nullptr, 0);
  return out;
}

struct Job {
  long index;
  std::vector<uint8_t> rgb;
};

struct Sink {
  std::string dir;
  int width, height;
  int queue_capacity;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  bool closing = false;

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_pop.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) return;  // closing and drained
        job = std::move(queue.front());
        queue.pop_front();
        cv_push.notify_one();
      }
      std::vector<uint8_t> png =
          encode_png(job.rgb.data(), width, height);
      char path[4096];
      std::snprintf(path, sizeof path, "%s/frame_%08ld.png", dir.c_str(),
                    job.index);
      std::FILE* f = std::fopen(path, "wb");
      if (f) {
        std::fwrite(png.data(), 1, png.size(), f);
        std::fclose(f);
      }
    }
  }
};

}  // namespace

extern "C" {

void* fs_create(const char* dir, int width, int height, int workers,
                int queue_capacity) {
  Sink* s = new Sink();
  s->dir = dir;
  s->width = width;
  s->height = height;
  s->queue_capacity = queue_capacity > 0 ? queue_capacity : 8;
  int n = workers > 0 ? workers : 1;
  for (int i = 0; i < n; ++i) s->workers.emplace_back(&Sink::worker, s);
  return s;
}

int fs_submit(void* h, long frame_index, const unsigned char* rgb) {
  Sink* s = static_cast<Sink*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (static_cast<int>(s->queue.size()) >= s->queue_capacity) return -1;
  Job job;
  job.index = frame_index;
  job.rgb.assign(rgb, rgb + static_cast<size_t>(s->width) * s->height * 3);
  s->queue.push_back(std::move(job));
  s->cv_pop.notify_one();
  return 0;
}

long fs_pending(void* h) {
  Sink* s = static_cast<Sink*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  return static_cast<long>(s->queue.size());
}

void fs_close(void* h) {
  Sink* s = static_cast<Sink*>(h);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->closing = true;
    s->cv_pop.notify_all();
  }
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
