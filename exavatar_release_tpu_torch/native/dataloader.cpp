// Native data loader: threaded PNG decode + prefetch ring (the port's copy
// of exavatar_release_tpu/native/dataloader.cpp; the port builds and loads
// its own, see loader.py).
//
// Equivalent of the reference's torch DataLoader worker pool (reference
// avatar/common/base.py:115: num_workers=8 subprocesses decoding pngs with
// cv2). Here: an in-process C++ thread pool with a bounded prefetch queue and
// a C ABI consumed via ctypes — no subprocess fork, no Python in the decode
// path, frames land in float buffers ready to be copied to the device. It is
// also what reads PNGs where cv2 is not installed.
//
// PNG support: 8-bit gray / RGB / RGBA / palette-free, non-interlaced
// (what the reference pipeline emits for images/ and masks/), inflated with
// the system zlib.
//
// Build (loader.py does it at first use): g++ -O3 -shared -fPIC dataloader.cpp -o <lib>.so -lz -lpthread
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int width = 0, height = 0, channels = 0;
  std::vector<float> data;  // CHW, [0, 1]
  bool ok = false;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::string& path) {
  Image img;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return img;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != size_t(size)) {
    fclose(f);
    return img;
  }
  fclose(f);

  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(buf.data(), magic, 8) != 0) return img;

  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t off = 8;
  while (off + 8 <= size_t(size)) {
    uint32_t len = be32(&buf[off]);
    const uint8_t* type = &buf[off + 4];
    const uint8_t* data = &buf[off + 8];
    if (off + 12 + len > size_t(size)) break;
    if (memcmp(type, "IHDR", 4) == 0) {
      width = be32(data);
      height = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (width <= 0 || height <= 0 || bit_depth != 8 || interlace != 0) return img;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return img;    // palette unsupported
  }

  size_t stride = size_t(width) * ch;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf out_len = raw.size();
  if (uncompress(raw.data(), &out_len, idat.data(), idat.size()) != Z_OK ||
      out_len != raw.size()) {
    return img;
  }

  // unfilter scanlines in place into a separate buffer
  std::vector<uint8_t> pix(stride * height);
  for (int y = 0; y < height; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &pix[stride * y];
    const uint8_t* up = y > 0 ? &pix[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(ch) ? dst[x - ch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(ch)) ? up[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return img;
      }
      dst[x] = uint8_t(v);
    }
  }

  img.width = width;
  img.height = height;
  img.channels = ch;
  img.data.resize(size_t(ch) * width * height);
  // HWC uint8 -> CHW float. A 256-entry LUT of x/255.0f keeps bit-exact
  // parity with numpy's `astype(float32) / 255.0` (multiplying by the
  // reciprocal differs in the last ulp and measurably perturbs training).
  float lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = float(v) / 255.0f;
  for (int c = 0; c < ch; ++c)
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x)
        img.data[(size_t(c) * height + y) * width + x] =
            lut[pix[size_t(y) * stride + size_t(x) * ch + c]];
  img.ok = true;
  return img;
}

struct Job {
  int64_t id;
  std::string path;
};

struct Result {
  int64_t id;
  Image img;
};

class Loader {
 public:
  Loader(int num_threads, int queue_cap) : cap_(queue_cap), stop_(false) {
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }
  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_jobs_.notify_all();
    cv_results_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void submit(int64_t id, const char* path) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] { return int(jobs_.size()) < cap_ || stop_; });
    jobs_.push(Job{id, path});
    cv_jobs_.notify_one();
  }

  // blocks until any result is ready; returns id, fills metadata
  int64_t wait_result(int* w, int* h, int* c) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_results_.wait(lk, [this] { return !results_.empty() || stop_; });
    if (results_.empty()) return -1;
    current_ = std::move(results_.front());
    results_.pop();
    *w = current_.img.width;
    *h = current_.img.height;
    *c = current_.img.channels;
    return current_.img.ok ? current_.id : -2;
  }

  void copy_current(float* dst) {
    memcpy(dst, current_.img.data.data(),
           current_.img.data.size() * sizeof(float));
  }

 private:
  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_jobs_.wait(lk, [this] { return !jobs_.empty() || stop_; });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
        cv_space_.notify_one();
      }
      Result r;
      r.id = job.id;
      r.img = decode_png(job.path);
      {
        std::lock_guard<std::mutex> lk(mu_);
        results_.push(std::move(r));
      }
      cv_results_.notify_one();
    }
  }

  int cap_;
  std::atomic<bool> stop_;
  std::mutex mu_;
  std::condition_variable cv_jobs_, cv_results_, cv_space_;
  std::queue<Job> jobs_;
  std::queue<Result> results_;
  Result current_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* exa_loader_create(int num_threads, int queue_cap) {
  return new Loader(num_threads, queue_cap);
}

void exa_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

void exa_loader_submit(void* loader, int64_t id, const char* path) {
  static_cast<Loader*>(loader)->submit(id, path);
}

int64_t exa_loader_wait(void* loader, int* w, int* h, int* c) {
  return static_cast<Loader*>(loader)->wait_result(w, h, c);
}

void exa_loader_copy(void* loader, float* dst) {
  static_cast<Loader*>(loader)->copy_current(dst);
}

// synchronous single-image decode (no pool)
int exa_decode_png(const char* path, float* dst, int dst_cap,
                   int* w, int* h, int* c) {
  Image img = decode_png(path);
  if (!img.ok) return -1;
  *w = img.width;
  *h = img.height;
  *c = img.channels;
  if (int(img.data.size()) > dst_cap) return -2;
  memcpy(dst, img.data.data(), img.data.size() * sizeof(float));
  return 0;
}

}  // extern "C"
