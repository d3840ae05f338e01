// Native data plane for dvo_tpu: PNG decode, undistortion remap, and a
// multithreaded prefetching sequence loader.
//
// The reference's data plane is C++ (src/core/loader.cpp: cv::imread +
// cv::remap feeding the pipeline).  This rebuild keeps the data plane
// native too, so that PNG decode in Python does not bound end-to-end
// throughput of a device-side pipeline.  This
// library decodes + undistorts + normalizes on worker threads and hands
// ready float32 buffers to the Python driver via ctypes.
//
// Exposed C ABI:
//   dvo_png_info(path, &w, &h, &bitdepth)            -> 0 ok
//   dvo_decode_png_f32(path, out, w, h, scale)       -> 0 ok  (gray*scale)
//   dvo_remap_nearest(src, sh, sw, map_xy, dst, h, w, border, valid_out)
//   dvo_prefetch_create(paths, n, w, h, scale, map_xy, mh, mw, border, nthreads)
//   dvo_prefetch_next(handle, out, valid_out)        -> frame index or -1
//   dvo_prefetch_destroy(handle)

#include <png.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PNG decode

int dvo_png_info(const char* path, int* w, int* h, int* bitdepth) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  *bitdepth = png_get_bit_depth(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode any PNG to float32 grayscale * scale.  8-bit color uses the
// BT.601-ish luma the reference gets from cv::cvtColor BGR2GRAY
// (loader.cpp:59); 16-bit stays raw (depth images, scaled by caller via
// `scale` = 1/5000 for TUM depth, 1/255 for 8-bit gray).
int dvo_decode_png_f32(const char* path, float* out, int expect_w, int expect_h,
                       float scale) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  int w = static_cast<int>(png_get_image_width(png, info));
  int h = static_cast<int>(png_get_image_height(png, info));
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (w != expect_w || h != expect_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (depth == 16) png_set_swap(png);  // PNG is big-endian; read LE u16
  png_read_update_info(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> data(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; y++) rows[y] = data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  int channels = png_get_channels(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  if (depth == 16 && channels == 1) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(data.data());
    for (int i = 0; i < w * h; i++) out[i] = p[i] * scale;
  } else if (depth == 8 && channels == 1) {
    for (int i = 0; i < w * h; i++) out[i] = data[i] * scale;
  } else if (depth == 8 && (channels == 3 || channels == 4)) {
    // cv::COLOR_BGR2GRAY luma: 0.299 R + 0.587 G + 0.114 B (PNG is RGB).
    for (int i = 0; i < w * h; i++) {
      const uint8_t* px = data.data() + i * channels;
      float g = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      out[i] = g * scale;
    }
  } else {
    return 4;
  }
  return 0;
}

// ----------------------------------------------------------------- remapping

// Nearest-neighbour remap with constant border (reference uses cv::remap
// INTER_NEAREST + BORDER_CONSTANT INVALID, loader.cpp:39-41).
void dvo_remap_nearest(const float* src, int sh, int sw, const float* map_xy,
                       float* dst, int h, int w, float border,
                       uint8_t* valid_out) {
  for (int i = 0; i < h * w; i++) {
    float mx = map_xy[2 * i];
    float my = map_xy[2 * i + 1];
    // Round half-to-even to match cvRound / np.rint exactly.
    int x = static_cast<int>(std::nearbyintf(mx));
    int y = static_cast<int>(std::nearbyintf(my));
    if (x >= 0 && x < sw && y >= 0 && y < sh) {
      dst[i] = src[y * sw + x];
      if (valid_out) valid_out[i] = 1;
    } else {
      dst[i] = border;
      if (valid_out) valid_out[i] = 0;
    }
  }
}

// ------------------------------------------------------- prefetching loader

namespace {

struct Frame {
  int index = -1;
  std::vector<float> data;
  std::vector<uint8_t> valid;
  int status = 0;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int w = 0, h = 0;          // decoded size
  int out_h = 0, out_w = 0;  // after optional remap
  float scale = 1.0f;
  std::vector<float> map_xy;  // empty = no remap
  float border = 0.0f;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::queue<int> todo;
  std::vector<Frame> done;      // indexed by frame id
  std::vector<uint8_t> ready;
  std::atomic<int> next_out{0};
  std::atomic<bool> stop{false};
  size_t window = 8;            // decode at most this far ahead

  void worker() {
    std::vector<float> raw;
    while (!stop.load()) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (todo.empty()) return;
        idx = todo.front();
        // Bound read-ahead so memory stays flat on long sequences.
        if (idx >= next_out.load() + static_cast<int>(window)) {
          lk.unlock();
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
          continue;
        }
        todo.pop();
      }
      Frame f;
      f.index = idx;
      raw.resize(static_cast<size_t>(w) * h);
      f.status = dvo_decode_png_f32(paths[idx].c_str(), raw.data(), w, h, scale);
      f.data.resize(static_cast<size_t>(out_h) * out_w);
      f.valid.resize(static_cast<size_t>(out_h) * out_w);
      if (f.status == 0) {
        if (!map_xy.empty()) {
          dvo_remap_nearest(raw.data(), h, w, map_xy.data(), f.data.data(),
                            out_h, out_w, border, f.valid.data());
        } else {
          std::memcpy(f.data.data(), raw.data(), sizeof(float) * w * h);
          std::fill(f.valid.begin(), f.valid.end(), 1);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[idx] = std::move(f);
        ready[idx] = 1;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

void* dvo_prefetch_create(const char** paths, int n, int w, int h, float scale,
                          const float* map_xy, int map_h, int map_w,
                          float border, int nthreads) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n; i++) p->paths.emplace_back(paths[i]);
  p->w = w;
  p->h = h;
  p->scale = scale;
  p->border = border;
  if (map_xy && map_h > 0) {
    p->map_xy.assign(map_xy, map_xy + 2 * static_cast<size_t>(map_h) * map_w);
    p->out_h = map_h;
    p->out_w = map_w;
  } else {
    p->out_h = h;
    p->out_w = w;
  }
  p->done.resize(n);
  p->ready.assign(n, 0);
  for (int i = 0; i < n; i++) p->todo.push(i);
  int nt = nthreads > 0 ? nthreads : 2;
  for (int t = 0; t < nt; t++) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

int dvo_prefetch_next(void* handle, float* out, uint8_t* valid_out) {
  auto* p = static_cast<Prefetcher*>(handle);
  int idx = p->next_out.load();
  if (idx >= static_cast<int>(p->paths.size())) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return p->ready[idx] != 0; });
  Frame& f = p->done[idx];
  if (f.status != 0) {
    p->next_out.store(idx + 1);
    return -1000 - f.status;
  }
  std::memcpy(out, f.data.data(), sizeof(float) * f.data.size());
  if (valid_out) std::memcpy(valid_out, f.valid.data(), f.valid.size());
  f.data.clear();
  f.data.shrink_to_fit();
  p->next_out.store(idx + 1);
  return idx;
}

void dvo_prefetch_dims(void* handle, int* out_h, int* out_w) {
  auto* p = static_cast<Prefetcher*>(handle);
  *out_h = p->out_h;
  *out_w = p->out_w;
}

void dvo_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    std::queue<int>().swap(p->todo);
  }
  for (auto& t : p->workers)
    if (t.joinable()) t.join();
  delete p;
}

}  // extern "C"
