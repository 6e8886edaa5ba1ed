// Native stereo-sequence data loader: image decode + rectification remap +
// multi-threaded prefetch, exposed through a C ABI for ctypes.
//
// Runtime-role parity with the reference's host-side image path
// (plslam_mod.cpp:330-354: cv::imread + PinholeStereoCamera::rectifyImagesLR
// per frame on the main thread). Here decoding and remapping run in a
// background thread pool with a bounded prefetch queue so the accelerator
// never waits on the host: the Python driver pops ready rectified float32
// frames.
//
// Supported formats: 8-bit grayscale/RGB PNG (libpng), JPEG (libjpeg),
// binary PGM (P5). Color inputs are converted to luma.
//
// A copy of native/dataloader.cpp for gfplslam_torch/io/native_loader.py,
// which builds it with g++ at first use. PNG and JPEG are compiled in only
// where their headers are found (__has_include), so the loader builds on a
// machine without libpng/libjpeg; binary PGM always works.
// gfpl_loader_formats() reports what a build can decode.

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

#if __has_include(<png.h>)
#include <png.h>
#define GFPL_HAVE_PNG 1
#else
#define GFPL_HAVE_PNG 0
#endif
#if __has_include(<jpeglib.h>)
#include <jpeglib.h>
#define GFPL_HAVE_JPEG 1
#else
#define GFPL_HAVE_JPEG 0
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> data;  // grayscale float32
};

bool decode_png(const char* path, Image* out) {
#if GFPL_HAVE_PNG
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  unsigned char header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  std::vector<unsigned char> row(w * channels);
  out->w = (int)w;
  out->h = (int)h;
  out->data.resize((size_t)w * h);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + (size_t)y * w;
    if (channels == 1) {
      for (png_uint_32 x = 0; x < w; ++x) dst[x] = (float)row[x];
    } else {
      for (png_uint_32 x = 0; x < w; ++x) {
        const unsigned char* p = &row[x * channels];
        dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
#else
  (void)path;
  (void)out;
  return false;
#endif
}

bool decode_jpeg(const char* path, Image* out) {
#if GFPL_HAVE_JPEG
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize((size_t)out->w * out->h);
  std::vector<unsigned char> row(out->w);
  unsigned char* rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out->data.data() + (size_t)y * out->w;
    for (int x = 0; x < out->w; ++x) dst[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
#else
  (void)path;
  (void)out;
  return false;
#endif
}

bool decode_pgm(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int w, h, maxv;
  if (fscanf(fp, "%2s %d %d %d", magic, &w, &h, &maxv) != 4 ||
      strcmp(magic, "P5") != 0) {
    fclose(fp);
    return false;
  }
  fgetc(fp);  // single whitespace after header
  out->w = w;
  out->h = h;
  out->data.resize((size_t)w * h);
  std::vector<unsigned char> buf((size_t)w * h);
  if (fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    fclose(fp);
    return false;
  }
  for (size_t i = 0; i < buf.size(); ++i) out->data[i] = (float)buf[i];
  fclose(fp);
  return true;
}

bool decode_any(const char* path, Image* out) {
  size_t n = strlen(path);
  auto ends = [&](const char* s) {
    size_t m = strlen(s);
    return n >= m && strcasecmp(path + n - m, s) == 0;
  };
  if (ends(".png")) return decode_png(path, out);
  if (ends(".jpg") || ends(".jpeg")) return decode_jpeg(path, out);
  if (ends(".pgm")) return decode_pgm(path, out);
  return decode_png(path, out) || decode_pgm(path, out) ||
         decode_jpeg(path, out);
}

// Bilinear remap with border clamp (pinholeStereoCamera.cpp:106-119 role).
void remap(const Image& src, const float* map_x, const float* map_y, int w,
           int h, float* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float mx = map_x[y * w + x];
      float my = map_y[y * w + x];
      int x0 = (int)mx;
      int y0 = (int)my;
      float fx = mx - x0, fy = my - y0;
      auto clampi = [](int v, int lo, int hi) {
        return v < lo ? lo : (v > hi ? hi : v);
      };
      int x0c = clampi(x0, 0, src.w - 1), x1c = clampi(x0 + 1, 0, src.w - 1);
      int y0c = clampi(y0, 0, src.h - 1), y1c = clampi(y0 + 1, 0, src.h - 1);
      float i00 = src.data[(size_t)y0c * src.w + x0c];
      float i01 = src.data[(size_t)y0c * src.w + x1c];
      float i10 = src.data[(size_t)y1c * src.w + x0c];
      float i11 = src.data[(size_t)y1c * src.w + x1c];
      float top = i00 * (1 - fx) + i01 * fx;
      float bot = i10 * (1 - fx) + i11 * fx;
      dst[y * w + x] = top * (1 - fy) + bot * fy;
    }
  }
}

struct Frame {
  int index = -1;
  std::vector<float> left, right;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> paths_l, paths_r;
  std::vector<float> map_xl, map_yl, map_xr, map_yr;
  int out_w = 0, out_h = 0;
  bool rectify = false;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Frame> ready;
  size_t depth = 4;
  std::atomic<int> next_index{0};
  int pop_index = 0;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      int idx = next_index.fetch_add(1);
      if (stop.load() || idx >= (int)paths_l.size()) return;
      Frame f;
      f.index = idx;
      Image il, ir;
      f.ok = decode_any(paths_l[idx].c_str(), &il) &&
             decode_any(paths_r[idx].c_str(), &ir);
      if (f.ok) {
        f.left.resize((size_t)out_w * out_h);
        f.right.resize((size_t)out_w * out_h);
        if (rectify) {
          remap(il, map_xl.data(), map_yl.data(), out_w, out_h, f.left.data());
          remap(ir, map_xr.data(), map_yr.data(), out_w, out_h, f.right.data());
        } else {
          // center-crop/pad to the configured shape
          for (int y = 0; y < out_h; ++y)
            for (int x = 0; x < out_w; ++x) {
              f.left[y * out_w + x] =
                  (y < il.h && x < il.w) ? il.data[(size_t)y * il.w + x] : 0.f;
              f.right[y * out_w + x] =
                  (y < ir.h && x < ir.w) ? ir.data[(size_t)y * ir.w + x] : 0.f;
            }
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < depth * 4 || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(f));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths_l, const char** paths_r, int n_frames,
                    const float* map_xl, const float* map_yl,
                    const float* map_xr, const float* map_yr, int out_w,
                    int out_h, int n_threads, int queue_depth) {
  Loader* L = new Loader();
  for (int i = 0; i < n_frames; ++i) {
    L->paths_l.emplace_back(paths_l[i]);
    L->paths_r.emplace_back(paths_r[i]);
  }
  L->out_w = out_w;
  L->out_h = out_h;
  L->depth = queue_depth > 0 ? queue_depth : 4;
  size_t n = (size_t)out_w * out_h;
  if (map_xl && map_yl && map_xr && map_yr) {
    L->rectify = true;
    L->map_xl.assign(map_xl, map_xl + n);
    L->map_yl.assign(map_yl, map_yl + n);
    L->map_xr.assign(map_xr, map_xr + n);
    L->map_yr.assign(map_yr, map_yr + n);
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Pops frames strictly in sequence order. Returns the frame index, or -1
// when the sequence is exhausted, or -2 on decode failure for this frame.
int loader_next(void* handle, float* out_l, float* out_r) {
  Loader* L = (Loader*)handle;
  if (L->pop_index >= (int)L->paths_l.size()) return -1;
  std::vector<Frame> stash;
  Frame got;
  bool found = false;
  while (!found) {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return !L->ready.empty(); });
    while (!L->ready.empty()) {
      Frame f = std::move(L->ready.front());
      L->ready.pop();
      if (f.index == L->pop_index) {
        got = std::move(f);
        found = true;
      } else {
        stash.push_back(std::move(f));
      }
    }
    for (auto& f : stash) L->ready.push(std::move(f));
    stash.clear();
    L->cv_space.notify_all();
  }
  int idx = L->pop_index++;
  if (!got.ok) return -2;
  size_t n = (size_t)L->out_w * L->out_h;
  memcpy(out_l, got.left.data(), n * sizeof(float));
  memcpy(out_r, got.right.data(), n * sizeof(float));
  return idx;
}

void loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_space.notify_all();
  L->next_index.store(1 << 28);
  for (auto& t : L->workers) t.join();
  delete L;
}

// Bit 0: PNG, bit 1: JPEG compiled in (PGM always is).
int gfpl_loader_formats() { return GFPL_HAVE_PNG | (GFPL_HAVE_JPEG << 1); }

// Standalone single-image decode for tests / simple paths.
int decode_image(const char* path, float* out, int max_w, int max_h,
                 int* w, int* h) {
  Image img;
  if (!decode_any(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  if (img.w > max_w || img.h > max_h) return -2;
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  return 0;
}
}
