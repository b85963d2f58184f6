// tpuseg_torch native data loader (the port's copy of
// native/tpuseg_loader.cpp; the same C ABI and the same pixels).
//
// A worker-pool image loader that decodes JPEG (libjpeg) / PNG (libpng),
// bilinear-resizes to the model's static input size, and fills
// caller-provided uint8 RGB buffers, so host decode can overlap device
// compute.
//
// C ABI (consumed by tpuseg_torch/data/native_loader.py via ctypes):
//   void* nl_create(int threads);
//   void  nl_destroy(void* h);
//   int   nl_load_batch(void* h, const char** paths, int n,
//                       int out_h, int out_w, int keep_aspect,
//                       unsigned char* out,  // n*out_h*out_w*3
//                       int* orig_hw);       // n*2 (original h, w)
//   returns 0 on success, else the 1-based index of the first failed path.
//
// Built at first use by tpuseg_torch/data/native_loader.py::build:
//   g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared tpuseg_loader.cpp
//       -o libtpuseg_torch_loader.so -ljpeg -lpng -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB HWC
  int h = 0, w = 0;
};

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

bool decode_png(FILE* f, Image* out) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int c0 = fgetc(f);
  int c1 = fgetc(f);
  rewind(f);
  bool ok = false;
  if (c0 == 0xFF && c1 == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (c0 == 0x89 && c1 == 'P') {
    ok = decode_png(f, out);
  } else {
    ok = decode_jpeg(f, out);  // default attempt
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// Bilinear resize (half-pixel centers, matches cv2 INTER_LINEAR)
// ---------------------------------------------------------------------------

void resize_bilinear(const Image& src, int dst_h, int dst_w, int off_y,
                     int off_x, int fill, uint8_t* dst, int dst_stride_w) {
  const float sy = float(src.h) / dst_h;
  const float sx = float(src.w) / dst_w;
  std::vector<int> x0s(dst_w), x1s(dst_w);
  std::vector<float> fxs(dst_w);
  for (int x = 0; x < dst_w; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = int(floorf(fx));
    fxs[x] = fx - x0;
    if (x0 < 0) { x0 = 0; fxs[x] = 0.f; }
    x0s[x] = x0;
    x1s[x] = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
  }
  for (int y = 0; y < dst_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(floorf(fy));
    float wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0.f; }
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    const uint8_t* r0 = src.data.data() + size_t(y0) * src.w * 3;
    const uint8_t* r1 = src.data.data() + size_t(y1) * src.w * 3;
    uint8_t* drow = dst + (size_t(y + off_y) * dst_stride_w + off_x) * 3;
    for (int x = 0; x < dst_w; ++x) {
      float wx = fxs[x];
      const uint8_t* p00 = r0 + x0s[x] * 3;
      const uint8_t* p01 = r0 + x1s[x] * 3;
      const uint8_t* p10 = r1 + x0s[x] * 3;
      const uint8_t* p11 = r1 + x1s[x] * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        drow[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
  (void)fill;
}

// ---------------------------------------------------------------------------
// Worker pool
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  explicit Loader(int threads) {
    for (int i = 0; i < threads; ++i) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop();
          }
          task();
        }
      });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }

  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push(std::move(f));
    }
    cv.notify_one();
  }
};

}  // namespace

extern "C" {

void* nl_create(int threads) { return new Loader(threads > 0 ? threads : 1); }

void nl_destroy(void* h) { delete static_cast<Loader*>(h); }

int nl_load_batch(void* h, const char** paths, int n, int out_h, int out_w,
                  int keep_aspect, unsigned char* out, int* orig_hw) {
  Loader* loader = static_cast<Loader*>(h);
  std::atomic<int> failed{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; ++i) {
    loader->submit([&, i] {
      Image img;
      if (!decode_file(paths[i], &img) || img.w <= 0 || img.h <= 0) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
      } else {
        orig_hw[i * 2] = img.h;
        orig_hw[i * 2 + 1] = img.w;
        uint8_t* dst = out + size_t(i) * out_h * out_w * 3;
        if (keep_aspect) {
          // letterbox: scale longest edge, center, gray(128) fill
          float scale = std::min(float(out_w) / img.w, float(out_h) / img.h);
          int nw = int(img.w * scale + 0.5f);
          int nh = int(img.h * scale + 0.5f);
          memset(dst, 128, size_t(out_h) * out_w * 3);
          resize_bilinear(img, nh, nw, (out_h - nh) / 2, (out_w - nw) / 2,
                          128, dst, out_w);
        } else {
          resize_bilinear(img, out_h, out_w, 0, 0, 0, dst, out_w);
        }
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failed.load();
}

}  // extern "C"
