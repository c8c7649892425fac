// Native KITTI frame loader: minimal PNG decoder + threaded prefetcher.
//
// Counterpart of the reference's per-frame cv::imread in the hot loop
// (feature_tracking.cpp:57/:64 — decode serialized with compute). Here N
// worker threads decode ahead of the consumer into a bounded ring, so
// host-side image decode overlaps device compute entirely. A copy of
// vo_tpu/runtime/native/pngloader.cpp (the port imports nothing of vo_tpu).
//
// Decoder scope (exactly what KITTI odometry needs): 8-bit PNG, color
// types 0 (gray), 2 (RGB -> BT.601 luma), 3 (palette), 4/6 (alpha
// dropped), non-interlaced, any number of IDAT chunks, zlib inflate.
// Output is float32 [0, 255] row-major (H, W) — the pipelines' input
// format.
//
// Build: g++ -O3 -shared -fPIC pngloader.cpp -o libvopng.so -lz -lpthread
// (done on demand by vo_tpu_torch/runtime/loader.py, into
// vo_tpu_torch/_build/).

#include <zlib.h>

#include <atomic>
#include <cstdlib>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> px;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns true on success; fills img.
bool decode_png(const std::string& path, Image& img) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n > 0 ? size_t(n) : 0);
  if (n <= 8 || std::fread(buf.data(), 1, size_t(n), f) != size_t(n)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(buf.data(), sig, 8) != 0) return false;

  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  size_t off = 8;
  while (off + 8 <= buf.size()) {
    uint32_t len = be32(&buf[off]);
    if (off + 12 + len > buf.size()) return false;
    const char* tag = reinterpret_cast<const char*>(&buf[off + 4]);
    const uint8_t* data = &buf[off + 8];
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (len < 13) return false;
      w = int(be32(data));
      h = int(be32(data + 4));
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      palette.assign(data, data + len);
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (w <= 0 || h <= 0 || depth != 8 || interlace != 0) return false;

  int ch;
  switch (ctype) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 3: ch = 1; break;  // palette index
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return false;
  }

  const size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * size_t(h));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return false;
  }

  // Unfilter in place into `scan` rows.
  std::vector<uint8_t> prev(stride, 0), cur(stride);
  img.h = h;
  img.w = w;
  img.px.resize(size_t(h) * w);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    int filter = src[0];
    const uint8_t* s = src + 1;
    for (size_t i = 0; i < stride; ++i) {
      int a = (i >= size_t(ch)) ? cur[i - ch] : 0;
      int b = prev[i];
      int c = (i >= size_t(ch)) ? prev[i - ch] : 0;
      int x = s[i];
      switch (filter) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) / 2; break;
        case 4: x += paeth(a, b, c); break;
        default: return false;
      }
      cur[i] = uint8_t(x & 0xff);
    }
    float* out = &img.px[size_t(y) * w];
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = &cur[size_t(x) * ch];
      float v;
      if (ctype == 0 || ctype == 4) {
        v = float(px[0]);
      } else if (ctype == 3) {
        size_t pi = size_t(px[0]) * 3;
        if (pi + 2 >= palette.size()) return false;
        v = 0.299f * palette[pi] + 0.587f * palette[pi + 1] +
            0.114f * palette[pi + 2];
      } else {
        v = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      }
      out[x] = v;
    }
    std::swap(prev, cur);
  }
  return true;
}

// ---------------------------------------------------------------- loader

struct Loader {
  std::vector<std::string> paths;
  int ring = 16;
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::map<int, Image> done;
  int next_job = 0;      // next index a worker will take
  int consumer_pos = 0;  // lowest index the consumer still wants
  std::vector<std::thread> workers;

  void work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop || (next_job < int(paths.size()) &&
                          next_job < consumer_pos + ring);
        });
        if (stop) return;
        idx = next_job++;
      }
      Image im;
      bool ok = decode_png(paths[idx], im);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) im = Image{};  // h==0 marks failure
        done.emplace(idx, std::move(im));
        cv_consumer.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// Single-shot decode. Returns 0 on success; h/w set; out must hold
// out_capacity floats (pass 0/nullptr to query dims only — two-call).
int vo_png_decode(const char* path, float* out, long out_capacity, int* h,
                  int* w) {
  Image im;
  if (!decode_png(path, im)) return 1;
  *h = im.h;
  *w = im.w;
  if (out == nullptr) return 0;
  if (long(im.px.size()) > out_capacity) return 2;
  std::memcpy(out, im.px.data(), im.px.size() * sizeof(float));
  return 0;
}

void* vo_loader_create(const char** paths, int n_paths, int n_threads,
                       int ring) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->ring = ring > 2 ? ring : 2;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::work, L);
  return L;
}

// Blocking ordered fetch of frame `idx`. Frames below idx are discarded
// (forward-only iteration, like the VO loop). Returns 0 on success.
int vo_loader_get(void* handle, int idx, float* out, long out_capacity,
                  int* h, int* w) {
  auto* L = static_cast<Loader*>(handle);
  if (idx < 0 || idx >= int(L->paths.size())) return 3;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_job > idx && !L->done.count(idx)) {
    // Replay of an already-consumed frame: decode inline (the VO loop is
    // forward-only; this path only serves ad-hoc random access).
    lk.unlock();
    Image im;
    if (!decode_png(L->paths[idx], im)) return 1;
    *h = im.h;
    *w = im.w;
    if (long(im.px.size()) > out_capacity) return 2;
    std::memcpy(out, im.px.data(), im.px.size() * sizeof(float));
    return 0;
  }
  if (idx > L->consumer_pos) L->consumer_pos = idx;
  if (L->next_job < idx) L->next_job = idx;  // seek: skip ahead
  L->cv_worker.notify_all();
  L->cv_consumer.wait(lk, [&] { return L->done.count(idx) > 0; });
  Image im = std::move(L->done[idx]);
  L->done.erase(L->done.begin(), L->done.upper_bound(idx));
  L->consumer_pos = idx + 1;
  L->cv_worker.notify_all();
  lk.unlock();

  if (im.h == 0) return 1;
  *h = im.h;
  *w = im.w;
  if (long(im.px.size()) > out_capacity) return 2;
  std::memcpy(out, im.px.data(), im.px.size() * sizeof(float));
  return 0;
}

void vo_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_worker.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
