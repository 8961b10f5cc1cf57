// orbtpu_io — native dataset runtime for the JAX SLAM framework.
//
// The reference's IO path is C++ (cv::imread in the example mains,
// Examples/Monocular_LoadImages.cpp:151, RGBD_LoadImages.cpp); this is its
// This framework's equivalent: a libpng-based grayscale/depth decoder, a TUM
// sequence parser (rgb.txt/depth.txt + nearest-timestamp association, the
// associate.py convention), and a background prefetch pool that keeps the
// host->device pipeline fed while the chip computes. Exposed as a C ABI for
// ctypes (no pybind11 in this environment).
//
// Build: make -C native   (g++ -O3 -shared, links libpng/zlib/pthread)

#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0, height = 0, bit_depth = 0, channels = 0;
  std::vector<uint16_t> data;  // always widened to 16-bit storage
};

// Decode a PNG into gray (8/16-bit). Color inputs are converted to
// luminance with the integer BT.601 weights cv::cvtColor uses
// (Tracking.cc converts RGB->gray before extraction).
bool decode_png(const std::string& path, Image* out) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  out->channels = png_get_channels(png, info);
  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<png_byte> raw(rowbytes * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y) rows[y] = raw.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out->data.assign(size_t(out->width) * out->height, 0);
  const int ch = out->channels;
  for (int y = 0; y < out->height; ++y) {
    const png_byte* row = raw.data() + y * rowbytes;
    for (int x = 0; x < out->width; ++x) {
      uint32_t v;
      if (out->bit_depth == 16) {
        // PNG is big-endian
        const png_byte* p = row + size_t(x) * ch * 2;
        if (ch >= 3) {
          uint32_t r = (p[0] << 8) | p[1], g = (p[2] << 8) | p[3],
                   b = (p[4] << 8) | p[5];
          v = (299 * r + 587 * g + 114 * b) / 1000;
        } else {
          v = (p[0] << 8) | p[1];
        }
      } else {
        const png_byte* p = row + size_t(x) * ch;
        if (ch >= 3) {
          v = (299u * p[0] + 587u * p[1] + 114u * p[2]) / 1000u;
        } else {
          v = p[0];
        }
      }
      out->data[size_t(y) * out->width + x] = uint16_t(v);
    }
  }
  return true;
}

struct FrameRec {
  double timestamp;
  std::string rgb, depth;  // relative paths; depth may be empty
};

struct Sequence {
  std::string root;
  double depth_factor = 5000.0;
  std::vector<FrameRec> frames;
  int width = 0, height = 0;

  // prefetch machinery
  std::mutex mu;
  std::condition_variable cv;
  std::map<int, std::pair<Image, Image>> cache;  // idx -> (gray, depth)
  std::deque<int> queue;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  size_t cache_cap = 16;

  ~Sequence() {
    stop = true;
    cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

std::vector<std::pair<double, std::string>> parse_list(
    const std::string& path) {
  std::vector<std::pair<double, std::string>> out;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    double t;
    std::string p;
    if (ss >> t >> p) out.push_back({t, p});
  }
  return out;
}

void decode_pair(Sequence* s, int idx, Image* gray, Image* depth) {
  const FrameRec& fr = s->frames[idx];
  decode_png(s->root + "/" + fr.rgb, gray);
  if (!fr.depth.empty()) decode_png(s->root + "/" + fr.depth, depth);
}

void worker_loop(Sequence* s) {
  while (!s->stop) {
    int idx = -1;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [&] { return s->stop || !s->queue.empty(); });
      if (s->stop) return;
      idx = s->queue.front();
      s->queue.pop_front();
      if (s->cache.count(idx)) continue;
    }
    Image g, d;
    decode_pair(s, idx, &g, &d);
    {
      std::lock_guard<std::mutex> lk(s->mu);
      while (s->cache.size() >= s->cache_cap) s->cache.erase(s->cache.begin());
      s->cache[idx] = {std::move(g), std::move(d)};
    }
    s->cv.notify_all();
  }
}

}  // namespace

extern "C" {

// Opens a TUM-format sequence dir (rgb.txt [+ depth.txt]). Returns handle
// or nullptr. n_frames receives the frame count.
void* orbtpu_open_sequence(const char* root, double depth_factor,
                           int* n_frames, int n_workers) {
  auto s = std::make_unique<Sequence>();
  s->root = root;
  s->depth_factor = depth_factor;
  auto rgb = parse_list(s->root + "/rgb.txt");
  if (rgb.empty()) return nullptr;
  auto depth = parse_list(s->root + "/depth.txt");
  for (auto& [t, p] : rgb) {
    FrameRec fr{t, p, ""};
    if (!depth.empty()) {  // nearest-timestamp association, 20ms gate
      double best = 1e18;
      const std::string* bp = nullptr;
      for (auto& [td, pd] : depth) {
        double d = std::abs(td - t);
        if (d < best) {
          best = d;
          bp = &pd;
        }
      }
      if (bp && best <= 0.02) fr.depth = *bp;
      else continue;  // unmatched frames dropped, like associate.py
    }
    s->frames.push_back(fr);
  }
  // probe geometry from frame 0
  Image probe;
  if (!s->frames.empty() &&
      decode_png(s->root + "/" + s->frames[0].rgb, &probe)) {
    s->width = probe.width;
    s->height = probe.height;
  }
  for (int i = 0; i < std::max(1, n_workers); ++i)
    s->workers.emplace_back(worker_loop, s.get());
  *n_frames = int(s->frames.size());
  return s.release();
}

void orbtpu_sequence_shape(void* h, int* height, int* width) {
  auto* s = static_cast<Sequence*>(h);
  *height = s->height;
  *width = s->width;
}

// Queue background decodes for [start, start+count).
void orbtpu_prefetch(void* h, int start, int count) {
  auto* s = static_cast<Sequence*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (int i = start; i < start + count && i < int(s->frames.size()); ++i)
      if (!s->cache.count(i)) s->queue.push_back(i);
  }
  s->cv.notify_all();
}

// Blocking read of frame idx into caller-provided float32 buffers
// (gray in [0,255]; depth in meters via depth_factor). Returns 0 on success.
int orbtpu_read_frame(void* h, int idx, float* gray_out, float* depth_out,
                      double* timestamp) {
  auto* s = static_cast<Sequence*>(h);
  if (idx < 0 || idx >= int(s->frames.size())) return -1;
  Image g, d;
  bool have = false;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    auto it = s->cache.find(idx);
    if (it != s->cache.end()) {
      g = std::move(it->second.first);
      d = std::move(it->second.second);
      s->cache.erase(it);
      have = true;
    }
  }
  if (!have) decode_pair(s, idx, &g, &d);
  if (g.width == 0) return -2;
  *timestamp = s->frames[idx].timestamp;
  const size_t n = size_t(g.width) * g.height;
  const float gscale = (g.bit_depth == 16) ? (255.0f / 65535.0f) : 1.0f;
  for (size_t i = 0; i < n; ++i) gray_out[i] = g.data[i] * gscale;
  if (depth_out) {
    if (d.width) {
      const float dscale = 1.0f / float(s->depth_factor);
      for (size_t i = 0; i < n; ++i) depth_out[i] = d.data[i] * dscale;
    } else {
      std::memset(depth_out, 0, n * sizeof(float));
    }
  }
  return 0;
}

void orbtpu_close(void* h) { delete static_cast<Sequence*>(h); }

// Standalone PNG decode helper (gray float32 [0,255]); returns 0 on success.
int orbtpu_decode_png(const char* path, float* out, int* height, int* width,
                      int max_pixels) {
  Image img;
  if (!decode_png(path, &img)) return -1;
  if (img.width * img.height > max_pixels) return -2;
  *height = img.height;
  *width = img.width;
  const float s = (img.bit_depth == 16) ? (255.0f / 65535.0f) : 1.0f;
  const size_t n = size_t(img.width) * img.height;
  for (size_t i = 0; i < n; ++i) out[i] = img.data[i] * s;
  return 0;
}

}  // extern "C"
