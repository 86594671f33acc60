// Native host-side image data plane for the generate path.
//
// The reference delegates all host image encode/decode to OpenCV's C++ core
// (cv2.imwrite at main.py:100-103); its writer loop is single-threaded and
// serialized with device pulls.  This module is the TPU-framework-native
// equivalent: a bounded-queue worker pool that JPEG-encodes RGB images
// (libjpeg-turbo) and PNG-encodes masks (libpng) off the Python thread, with
// the device's bit-packed binary-mask format (8 px/byte, MSB first — see
// FusedPipeline in train/generator.py) unpacked inside the encoder so the
// host never materializes the unpacked mask.
//
// Rationale: at the measured device rate (~440 z->(image,mask) samples/sec
// @1024^2, BASELINE.md) a single-threaded cv2 writer (~15-25 ms/pair) caps
// the end-to-end generate CLI at ~40-60 pairs/sec on real silicon.  Encode
// here runs GIL-free and scales with host cores.
//
// C ABI only (consumed via ctypes from gan_segmentation_tpu/native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// JPEG (libjpeg-turbo) — RGB HxWx3, quality as cv2.imwrite's default (95).
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool write_jpeg_file(const char* path, const uint8_t* rgb, int h, int w,
                     int quality) {
  // atomic: encode into <path>.tmp, rename into place on success — a file
  // at its final name is always complete, which `generate --resume`'s
  // contiguity scan relies on (the pool writes many files concurrently, so
  // a kill can tear any in-flight file, not just the newest index)
  const std::string tmp = std::string(path) + ".tmp";
  FILE* fp = std::fopen(tmp.c_str(), "wb");
  if (!fp) return false;

  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(fp);
    std::remove(tmp.c_str());
    return false;
  }

  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(fp);
  return std::rename(tmp.c_str(), path) == 0;
}

// ---------------------------------------------------------------------------
// PNG (libpng) — 8-bit grayscale HxW.  Masks hold small class ids (the
// reference stores argmax values directly, main.py:103); compression level 1
// matches cv2.imwrite's IMWRITE_PNG_COMPRESSION default.
// When `packed` the input rows are bit-packed MSB-first (w/8 bytes per row,
// np.unpackbits order) and are expanded to 0/1 bytes inside the row loop.
// ---------------------------------------------------------------------------

bool write_png_gray_file(const char* path, const uint8_t* gray, int h, int w,
                         bool packed) {
  // atomic tmp + rename, same discipline (and reason) as write_jpeg_file
  const std::string tmp = std::string(path) + ".tmp";
  FILE* fp = std::fopen(tmp.c_str(), "wb");
  if (!fp) return false;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    std::remove(tmp.c_str());
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    std::fclose(fp);
    std::remove(tmp.c_str());
    return false;
  }
  // allocated BEFORE setjmp: a longjmp must not skip a live destructor
  // (UB + leak); same discipline as read_png_gray's buffers
  std::vector<uint8_t> row;
  if (packed) row.resize(static_cast<size_t>(w));
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    std::remove(tmp.c_str());
    return false;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, 1);
  png_set_IHDR(png, info, static_cast<png_uint_32>(w),
               static_cast<png_uint_32>(h), 8, PNG_COLOR_TYPE_GRAY,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  if (packed) {
    const int wb = w / 8;
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = gray + static_cast<size_t>(y) * wb;
      for (int xb = 0; xb < wb; ++xb) {
        const uint8_t byte = src[xb];
        uint8_t* dst = row.data() + xb * 8;
        for (int bit = 0; bit < 8; ++bit)
          dst[bit] = (byte >> (7 - bit)) & 1u;  // MSB first == np.unpackbits
      }
      png_write_row(png, row.data());
    }
  } else {
    for (int y = 0; y < h; ++y) {
      png_write_row(png, const_cast<png_bytep>(
                             gray + static_cast<size_t>(y) * w));
    }
  }
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return std::rename(tmp.c_str(), path) == 0;
}

// ---------------------------------------------------------------------------
// Worker pool with a bounded job queue (backpressure instead of unbounded
// host memory: each queued 1024^2 job owns ~3.2 MB).
// ---------------------------------------------------------------------------

struct Job {
  std::string img_path;   // empty => no image
  std::string mask_path;  // empty => no mask
  std::vector<uint8_t> img;
  int img_h = 0, img_w = 0;
  std::vector<uint8_t> mask;
  int mask_h = 0, mask_w = 0;  // mask_w in PIXELS even when packed
  bool mask_packed = false;
};

class Writer {
 public:
  Writer(int n_threads, int queue_cap, int jpeg_quality)
      : cap_(queue_cap), quality_(jpeg_quality) {
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { run(); });
  }

  // Blocks while the queue is full; returns false after finish().
  bool submit(Job&& job) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [this] { return done_ || (int)queue_.size() < cap_; });
    if (done_) return false;
    queue_.push_back(std::move(job));
    not_empty_.notify_one();
    return true;
  }

  // Drains the queue, joins workers; returns the number of failed writes.
  int finish() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      done_ = true;
    }
    not_empty_.notify_all();
    not_full_.notify_all();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    return errors_.load();
  }

 private:
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [this] { return done_ || !queue_.empty(); });
        if (queue_.empty()) return;  // done_ && drained
        job = std::move(queue_.front());
        queue_.pop_front();
        not_full_.notify_one();
      }
      if (!job.img_path.empty() &&
          !write_jpeg_file(job.img_path.c_str(), job.img.data(), job.img_h,
                           job.img_w, quality_))
        errors_.fetch_add(1);
      if (!job.mask_path.empty() &&
          !write_png_gray_file(job.mask_path.c_str(), job.mask.data(),
                               job.mask_h, job.mask_w, job.mask_packed))
        errors_.fetch_add(1);
    }
  }

  const int cap_;
  const int quality_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Job> queue_;
  bool done_ = false;
  std::atomic<int> errors_{0};
  std::vector<std::thread> threads_;
};

// ---------------------------------------------------------------------------
// Decode side (the input data plane).  The reference's DataLoader decodes
// JPEG/PNG through OpenCV's C++ core in worker threads
// (`lib/core/segmentation.py:33-47` via cv2.imread in the datasets); the
// framework equivalent adds one thing OpenCV's path cannot do: the training
// scale factor (FFHQ trains at 0.5 of 1024^2 images, `01/main.py:97-99`) is
// fused INTO the JPEG decode as libjpeg DCT-domain scaling (scale_denom in
// {1,2,4,8}) — ~4x less IDCT work at 1/2 scale and no separate resize pass —
// and the output is RGB directly (no BGR->RGB flip copy).  Masks are decoded
// from 8-bit gray PNG and nearest-subsampled with cv2.INTER_NEAREST's
// src = dst*d grid.  Pixel values at denom>1 deviate from cv2's
// INTER_LINEAR downsample (DCT box-ish filter vs bilinear) — callers opt in.
// ---------------------------------------------------------------------------

struct Record {
  std::vector<uint8_t> img;  // RGB HxWx3
  int img_h = 0, img_w = 0;
  std::vector<uint8_t> mask;  // gray HxW
  int mask_h = 0, mask_w = 0;
};

bool read_jpeg_rgb(const char* path, int scale_denom, std::vector<uint8_t>* out,
                   int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(scale_denom);
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  const size_t stride = static_cast<size_t>(*w) * 3;
  out->resize(static_cast<size_t>(*h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// 8-bit grayscale PNG -> HxW bytes, nearest-subsampled by `d` (src = dst*d,
// cv2.INTER_NEAREST's grid for integer downscale).  Rejects non-gray PNGs
// (palette/RGB masks are not the reference's format) AND 16-bit gray
// (png_set_strip_16 keeps the high byte, which would zero small class
// ids stored as 16-bit values) -> caller falls back to cv2.
bool read_png_gray(const char* path, int d, std::vector<uint8_t>* out, int* h,
                   int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  std::vector<uint8_t> full;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  const png_uint_32 fh = png_get_image_height(png, info);
  const png_uint_32 fw = png_get_image_width(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);
  if (color != PNG_COLOR_TYPE_GRAY || fh == 0 || fw == 0 || depth == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  if (depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  png_read_update_info(png, info);

  full.resize(static_cast<size_t>(fh) * fw);
  rows.resize(fh);
  for (png_uint_32 y = 0; y < fh; ++y)
    rows[y] = full.data() + static_cast<size_t>(y) * fw;
  png_read_image(png, rows.data());  // handles interlace internally
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  *h = static_cast<int>((fh + d - 1) / d);  // ceil: matches libjpeg's dims
  *w = static_cast<int>((fw + d - 1) / d);
  if (d == 1) {
    *out = std::move(full);
    return true;
  }
  out->resize(static_cast<size_t>(*h) * *w);
  for (int y = 0; y < *h; ++y) {
    const uint8_t* src = full.data() + static_cast<size_t>(y) * d * fw;
    uint8_t* dst = out->data() + static_cast<size_t>(y) * *w;
    for (int x = 0; x < *w; ++x) dst[x] = src[static_cast<size_t>(x) * d];
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int gsio_abi_version() { return 2; }

// Decode an (image.jpg, mask.png) pair at 1/scale_denom scale (denom in
// {1,2,4,8}; fused into the JPEG IDCT).  Either path may be NULL/empty.
// Returns an opaque record (query dims, copy out, then free) or NULL on any
// decode failure.  Thread-safe; ctypes callers run GIL-free and scale across
// host cores.
void* gsio_read_pair(const char* img_path, const char* mask_path,
                     int scale_denom) {
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return nullptr;
  auto rec = std::make_unique<Record>();
  if (img_path && img_path[0]) {
    if (!read_jpeg_rgb(img_path, scale_denom, &rec->img, &rec->img_h,
                       &rec->img_w))
      return nullptr;
  }
  if (mask_path && mask_path[0]) {
    if (!read_png_gray(mask_path, scale_denom, &rec->mask, &rec->mask_h,
                       &rec->mask_w))
      return nullptr;
  }
  return rec.release();
}

// dims4 = {img_h, img_w, mask_h, mask_w} (0 where absent).
int gsio_record_dims(void* handle, int* dims4) {
  Record* r = static_cast<Record*>(handle);
  if (!r || !dims4) return 1;
  dims4[0] = r->img_h;
  dims4[1] = r->img_w;
  dims4[2] = r->mask_h;
  dims4[3] = r->mask_w;
  return 0;
}

// Copies into caller buffers sized from gsio_record_dims (img: HxWx3 RGB,
// mask: HxW).  NULL out-pointers skip that component.
int gsio_record_copy(void* handle, uint8_t* img_out, uint8_t* mask_out) {
  Record* r = static_cast<Record*>(handle);
  if (!r) return 1;
  if (img_out && !r->img.empty())
    std::memcpy(img_out, r->img.data(), r->img.size());
  if (mask_out && !r->mask.empty())
    std::memcpy(mask_out, r->mask.data(), r->mask.size());
  return 0;
}

void gsio_record_free(void* handle) { delete static_cast<Record*>(handle); }

void* gsio_writer_create(int n_threads, int queue_cap, int jpeg_quality) {
  if (n_threads < 1 || queue_cap < 1 || jpeg_quality < 1 || jpeg_quality > 100)
    return nullptr;
  return new Writer(n_threads, queue_cap, jpeg_quality);
}

// img: RGB HxWx3 C-contiguous (may be NULL with img_path NULL/empty).
// mask: HxW bytes, or HxW/8 bytes bit-packed MSB-first when mask_packed;
// mask_w is always the width in pixels (must be divisible by 8 when packed).
// Buffers are copied before return; the caller may free them immediately.
// Returns 0 on success, nonzero on invalid arguments or finished writer.
int gsio_writer_submit(void* handle, const char* img_path,
                       const char* mask_path, const uint8_t* img, int img_h,
                       int img_w, const uint8_t* mask, int mask_h, int mask_w,
                       int mask_packed) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return 1;
  Job job;
  if (img_path && img_path[0]) {
    if (!img || img_h < 1 || img_w < 1) return 2;
    job.img_path = img_path;
    job.img.assign(img, img + static_cast<size_t>(img_h) * img_w * 3);
    job.img_h = img_h;
    job.img_w = img_w;
  }
  if (mask_path && mask_path[0]) {
    if (!mask || mask_h < 1 || mask_w < 1) return 3;
    if (mask_packed && mask_w % 8 != 0) return 4;
    const size_t bytes = mask_packed
                             ? static_cast<size_t>(mask_h) * (mask_w / 8)
                             : static_cast<size_t>(mask_h) * mask_w;
    job.mask_path = mask_path;
    job.mask.assign(mask, mask + bytes);
    job.mask_h = mask_h;
    job.mask_w = mask_w;
    job.mask_packed = mask_packed != 0;
  }
  return w->submit(std::move(job)) ? 0 : 5;
}

int gsio_writer_finish(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  const int errors = w->finish();
  delete w;
  return errors;
}

// Synchronous single-file entry points (tests; simple callers).
int gsio_write_jpeg(const char* path, const uint8_t* rgb, int h, int w,
                    int quality) {
  return write_jpeg_file(path, rgb, h, w, quality) ? 0 : 1;
}

int gsio_write_png_gray(const char* path, const uint8_t* gray, int h, int w,
                        int packed) {
  return write_png_gray_file(path, gray, h, w, packed != 0) ? 0 : 1;
}

}  // extern "C"
