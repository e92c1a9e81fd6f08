// Copied from irw_tpu/native/src/irw_loader.cpp: the same code below this line, the two
// citations of the reference's files shortened; built by irw_tpu_torch/native/build.py.
// Native host image loader for irw_tpu.
//
// The reference keeps its host pipeline in Python: torch DataLoader workers
// run PIL decode + torchvision transforms per sample
// (reference main/datasets/base_dataset.py:77-110).  Here the host
// loader's hot path — file read → JPEG/PNG decode → geometry (crop/resize/
// flip) → uint8 HWC — is a C++ thread pool instead, exposed through a pure C
// ABI consumed via ctypes (irw_tpu/native/__init__.py).  Python computes the
// per-sample geometry "plan" (so augmentation sampling is identical to the
// PIL path), C++ executes it.
//
// Resampling matches PIL's antialiased convention: a triangle (BILINEAR) or
// Catmull-Rom a=-0.5 (BICUBIC) kernel stretched by the scale factor, applied
// separably with float accumulation — so outputs agree with Image.resize to
// within fixed-point rounding (PIL uses 8-bit fixed-point coefficients).
//
// Build: g++ -O3 -march=native -fPIC -shared -pthread irw_loader.cpp
//        -ljpeg -lpng -o libirwloader.so       (see ../build.py)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- image buf
struct ImageU8 {
  std::vector<uint8_t> data;  // HWC, RGB
  int w = 0, h = 0;
};

// Pathological headers (e.g. a valid JPEG header claiming 65500x65500)
// must degrade to a per-sample status, not abort the process.
constexpr long kMaxPixels = 100L * 1000 * 1000;  // 100 MP ≈ 300 MB RGB

// ---------------------------------------------------------------- jpeg
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// rc: 0 ok, 1 decode error, 2 unsupported (caller falls back to PIL)
// min_w/min_h > 0 requests libjpeg's DCT-domain scaled decode (M/8 IDCT
// scaling, the trick behind PIL's Image.draft): decode at the smallest
// M/8 scale whose output still covers (min_w, min_h), cutting IDCT + later
// resample work roughly quadratically when downscaling.
int decode_jpeg(const uint8_t* buf, size_t len, ImageU8& out, int min_w = 0,
                int min_h = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    // PIL handles CMYK via its own conversion tables; punt per-sample.
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr -> RGB
  if (static_cast<long>(cinfo.image_width) *
          static_cast<long>(cinfo.image_height) > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return 2;  // absurd claimed dims: let PIL decide
  }
  if (min_w > 0 && min_h > 0) {
    cinfo.scale_denom = 8;
    for (unsigned m = 1; m <= 8; ++m) {
      cinfo.scale_num = m;
      jpeg_calc_output_dimensions(&cinfo);
      if (static_cast<int>(cinfo.output_width) >= min_w &&
          static_cast<int>(cinfo.output_height) >= min_h)
        break;
    }
  }
  jpeg_start_decompress(&cinfo);
  out.w = static_cast<int>(cinfo.output_width);
  out.h = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  out.data.resize(static_cast<size_t>(out.w) * out.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_header_size(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------- png
struct PngReadState {
  const uint8_t* buf;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "read past end");
  }
  std::memcpy(out, st->buf + st->pos, n);
  st->pos += n;
}

int decode_png(const uint8_t* buf, size_t len, ImageU8& out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (static_cast<long>(w) * static_cast<long>(h) > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  // normalize everything to 8-bit RGB
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out.w = static_cast<int>(w);
  out.h = static_cast<int>(h);
  out.data.resize(static_cast<size_t>(out.w) * out.h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out.data.data() + static_cast<size_t>(y) * out.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------- dispatch
bool is_jpeg(const uint8_t* b, size_t n) {
  return n >= 3 && b[0] == 0xFF && b[1] == 0xD8 && b[2] == 0xFF;
}
bool is_png(const uint8_t* b, size_t n) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  return n >= 8 && std::memcmp(b, sig, 8) == 0;
}

int decode_any(const uint8_t* buf, size_t len, ImageU8& out, int min_w = 0,
               int min_h = 0) {
  if (is_jpeg(buf, len)) return decode_jpeg(buf, len, out, min_w, min_h);
  if (is_png(buf, len)) return decode_png(buf, len, out);
  return 2;  // unknown container -> PIL fallback
}

int read_file(const char* path, std::vector<uint8_t>& buf, long max_bytes = 0) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return 1;
  }
  if (max_bytes > 0 && sz > max_bytes) sz = max_bytes;  // header probe
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(buf.data(), 1, static_cast<size_t>(sz), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(sz) ? 0 : 1;
}

// ---------------------------------------------------------------- resample
// PIL-convention antialiased separable resampling (PIL Resample.c):
// the kernel is stretched by scale = in/out when downscaling, so every
// source pixel contributes — this is what Image.resize(..., BILINEAR) does
// (torchvision's Resize semantic, the one HostTransform mirrors).
inline double filter_triangle(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}
inline double filter_bicubic(double x) {  // Catmull-Rom family, a = -0.5
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct KernelRow {
  int xmin, xmax;             // source span [xmin, xmax)
  std::vector<float> weight;  // normalized (built in double, stored f32)
};

void build_kernel(int in_size, int out_size, int filter,
                  std::vector<KernelRow>& rows) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double base_support = filter == 1 ? 2.0 : 1.0;
  const double support = base_support * filterscale;
  std::vector<double> tmp;
  rows.resize(out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::floor(center - support));
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(std::ceil(center + support));
    if (xmax > in_size) xmax = in_size;
    KernelRow& r = rows[xx];
    r.xmin = xmin;
    r.xmax = xmax;
    tmp.assign(xmax - xmin, 0.0);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double arg = (x + 0.5 - center) / filterscale;
      const double wgt = filter == 1 ? filter_bicubic(arg) : filter_triangle(arg);
      tmp[x - xmin] = wgt;
      total += wgt;
    }
    r.weight.resize(tmp.size());
    for (size_t k = 0; k < tmp.size(); ++k)
      r.weight[k] = static_cast<float>(total != 0.0 ? tmp[k] / total : tmp[k]);
  }
}

void resize_aa(const ImageU8& src, int dw, int dh, int filter, ImageU8& dst) {
  std::vector<KernelRow> kx, ky;
  build_kernel(src.w, dw, filter, kx);
  build_kernel(src.h, dh, filter, ky);

  // horizontal pass: (h, w, 3) u8 -> (h, dw, 3) f32
  std::vector<float> tmp(static_cast<size_t>(src.h) * dw * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.data.data() + static_cast<size_t>(y) * src.w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int xx = 0; xx < dw; ++xx) {
      const KernelRow& r = kx[xx];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      const float* wp = r.weight.data();
      const uint8_t* p = srow + 3 * r.xmin;
      for (int x = r.xmin; x < r.xmax; ++x, p += 3) {
        const float wgt = *wp++;
        acc0 += wgt * p[0];
        acc1 += wgt * p[1];
        acc2 += wgt * p[2];
      }
      trow[3 * xx + 0] = acc0;
      trow[3 * xx + 1] = acc1;
      trow[3 * xx + 2] = acc2;
    }
  }

  // vertical pass: (h, dw, 3) f32 -> (dh, dw, 3) u8
  dst.w = dw;
  dst.h = dh;
  dst.data.resize(static_cast<size_t>(dw) * dh * 3);
  const int row_elems = dw * 3;
  std::vector<float> accrow(row_elems);
  for (int yy = 0; yy < dh; ++yy) {
    const KernelRow& r = ky[yy];
    uint8_t* drow = dst.data.data() + static_cast<size_t>(yy) * row_elems;
    std::memset(accrow.data(), 0, sizeof(float) * row_elems);
    for (int y = r.xmin; y < r.xmax; ++y) {
      const float wgt = r.weight[y - r.xmin];
      const float* trow = tmp.data() + static_cast<size_t>(y) * row_elems;
      for (int xx = 0; xx < row_elems; ++xx) accrow[xx] += wgt * trow[xx];
    }
    for (int xx = 0; xx < row_elems; ++xx) {
      int v = static_cast<int>(std::lround(accrow[xx]));
      drow[xx] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

int crop(const ImageU8& src, int left, int top, int cw, int ch, ImageU8& dst) {
  // The planner only emits in-bounds boxes (it computes them from the real
  // header dims), but clamp defensively; a degenerate result is an error
  // status, not UB.
  if (left < 0) left = 0;
  if (top < 0) top = 0;
  if (left + cw > src.w) cw = src.w - left;
  if (top + ch > src.h) ch = src.h - top;
  if (cw <= 0 || ch <= 0) return 1;
  dst.w = cw;
  dst.h = ch;
  dst.data.resize(static_cast<size_t>(cw) * ch * 3);
  for (int y = 0; y < ch; ++y)
    std::memcpy(dst.data.data() + static_cast<size_t>(y) * cw * 3,
                src.data.data() +
                    (static_cast<size_t>(y + top) * src.w + left) * 3,
                static_cast<size_t>(cw) * 3);
  return 0;
}

// ------------------------------------------------------------- pixel ops
// PIL-parity color augmentation (ImageEnhance / ImageOps.grayscale /
// ImageFilter.GaussianBlur semantics), so the reference's augmented train
// pipelines (voc_swt ColorJitter, SwAV color distortion —
// reference main/datasets/base_dataset.py:118-147) can run in the
// C++ thread pool instead of falling back to PIL.

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Pillow L-mode conversion (ITU-R 601-2), integer form used by convert("L")
inline int to_gray(const uint8_t* p) {
  return (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16;
}

// ImageEnhance.Brightness == blend(black, img, f)
void enhance_brightness(ImageU8& img, double f) {
  // Pillow's Blend.c truncates the float result (empirically verified)
  uint8_t lut[256];
  for (int v = 0; v < 256; ++v)
    lut[v] = clamp_u8(static_cast<int>(std::floor(v * f)));
  for (auto& v : img.data) v = lut[v];
}

// ImageEnhance.Contrast: blend(solid gray at round(mean of L), img, f)
void enhance_contrast(ImageU8& img, double f) {
  double total = 0.0;
  const size_t n = img.data.size() / 3;
  const uint8_t* p = img.data.data();
  for (size_t i = 0; i < n; ++i, p += 3) total += to_gray(p);
  const int mean = static_cast<int>(total / static_cast<double>(n) + 0.5);
  uint8_t lut[256];
  for (int v = 0; v < 256; ++v)
    lut[v] = clamp_u8(static_cast<int>(std::floor(mean + f * (v - mean))));
  for (auto& v : img.data) v = lut[v];
}

// ImageEnhance.Color == blend(grayscale(img), img, f)
void enhance_saturation(ImageU8& img, double f) {
  uint8_t* p = img.data.data();
  const size_t n = img.data.size() / 3;
  for (size_t i = 0; i < n; ++i, p += 3) {
    const int g = to_gray(p);
    for (int c = 0; c < 3; ++c)
      p[c] = clamp_u8(static_cast<int>(std::floor(g + f * (p[c] - g))));
  }
}

// ImageOps.grayscale(img).convert("RGB")
void to_grayscale(ImageU8& img) {
  uint8_t* p = img.data.data();
  const size_t n = img.data.size() / 3;
  for (size_t i = 0; i < n; ++i, p += 3) {
    const uint8_t g = static_cast<uint8_t>(to_gray(p));
    p[0] = p[1] = p[2] = g;
  }
}

// Separable Gaussian with sigma = radius (Pillow's documented GaussianBlur
// semantics; Pillow approximates with iterated box blurs, so this is
// augmentation-grade parity, same contract as the DCT-scaled decode),
// clamp-to-edge boundary.
void gaussian_blur(ImageU8& img, double radius) {
  if (radius <= 0.0 || img.w <= 0 || img.h <= 0) return;
  const double sigma = radius;
  const int half = std::max(1, static_cast<int>(std::ceil(sigma * 3.0)));
  std::vector<float> k(2 * half + 1);
  double total = 0.0;
  for (int i = -half; i <= half; ++i) {
    const double w = std::exp(-(i * i) / (2.0 * sigma * sigma));
    k[i + half] = static_cast<float>(w);
    total += w;
  }
  for (auto& w : k) w = static_cast<float>(w / total);

  const int W = img.w, H = img.h;
  std::vector<float> tmp(static_cast<size_t>(W) * H * 3);
  // horizontal
  for (int y = 0; y < H; ++y) {
    const uint8_t* srow = img.data.data() + static_cast<size_t>(y) * W * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int i = -half; i <= half; ++i) {
        int xs = x + i;
        xs = xs < 0 ? 0 : (xs >= W ? W - 1 : xs);
        const float w = k[i + half];
        const uint8_t* p = srow + 3 * xs;
        a0 += w * p[0];
        a1 += w * p[1];
        a2 += w * p[2];
      }
      trow[3 * x + 0] = a0;
      trow[3 * x + 1] = a1;
      trow[3 * x + 2] = a2;
    }
  }
  // vertical
  for (int y = 0; y < H; ++y) {
    uint8_t* drow = img.data.data() + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int i = -half; i <= half; ++i) {
        int ys = y + i;
        ys = ys < 0 ? 0 : (ys >= H ? H - 1 : ys);
        const float* p = tmp.data() + (static_cast<size_t>(ys) * W + x) * 3;
        const float w = k[i + half];
        a0 += w * p[0];
        a1 += w * p[1];
        a2 += w * p[2];
      }
      drow[3 * x + 0] = clamp_u8(static_cast<int>(std::lround(a0)));
      drow[3 * x + 1] = clamp_u8(static_cast<int>(std::lround(a1)));
      drow[3 * x + 2] = clamp_u8(static_cast<int>(std::lround(a2)));
    }
  }
}

void hflip(ImageU8& img) {
  for (int y = 0; y < img.h; ++y) {
    uint8_t* row = img.data.data() + static_cast<size_t>(y) * img.w * 3;
    for (int x = 0; x < img.w / 2; ++x) {
      for (int c = 0; c < 3; ++c)
        std::swap(row[3 * x + c], row[3 * (img.w - 1 - x) + c]);
    }
  }
}

// ------------------------------------------------------------ plan executor
// Plan: per-sample int32[stride] — packed steps of 6 ints:
//   [OP_END]                          terminate
//   [OP_CROP, left, top, w, h, _]
//   [OP_RESIZE, w, h, filter, _, _]   filter: 0 bilinear, 1 bicubic
//   [OP_FLIP]                         horizontal flip
//   [OP_BRIGHTNESS|CONTRAST|SATURATION, f_fp16, _, ...]  f = f_fp16/65536
//   [OP_GRAYSCALE]
//   [OP_BLUR, radius_fp16, _, ...]    sigma = radius_fp16/65536
enum {
  OP_END = 0,
  OP_CROP = 1,
  OP_RESIZE = 2,
  OP_FLIP = 3,
  OP_BRIGHTNESS = 4,
  OP_CONTRAST = 5,
  OP_SATURATION = 6,
  OP_GRAYSCALE = 7,
  OP_BLUR = 8,
};

int run_plan(ImageU8& img, const int32_t* plan, int stride) {
  int i = 0;
  while (i + 6 <= stride) {
    const int32_t op = plan[i];
    if (op == OP_END) break;
    if (op == OP_CROP) {
      ImageU8 out;
      if (crop(img, plan[i + 1], plan[i + 2], plan[i + 3], plan[i + 4], out))
        return 1;
      img = std::move(out);
    } else if (op == OP_RESIZE) {
      if (plan[i + 1] != img.w || plan[i + 2] != img.h) {
        ImageU8 out;
        resize_aa(img, plan[i + 1], plan[i + 2], plan[i + 3], out);
        img = std::move(out);
      }
    } else if (op == OP_FLIP) {
      hflip(img);
    } else if (op == OP_BRIGHTNESS) {
      enhance_brightness(img, plan[i + 1] / 65536.0);
    } else if (op == OP_CONTRAST) {
      enhance_contrast(img, plan[i + 1] / 65536.0);
    } else if (op == OP_SATURATION) {
      enhance_saturation(img, plan[i + 1] / 65536.0);
    } else if (op == OP_GRAYSCALE) {
      to_grayscale(img);
    } else if (op == OP_BLUR) {
      gaussian_blur(img, plan[i + 1] / 65536.0);
    } else {
      return 1;  // unknown op
    }
    i += 6;
  }
  return 0;
}

int load_one(const char* path, const int32_t* plan, int stride, int out_w,
             int out_h, int fast_scale, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (read_file(path, buf)) return 1;
  ImageU8 img;
  // When the plan opens with a plain resize, the decoder may stop at any
  // resolution still covering that target — enables JPEG DCT scaling.
  int min_w = 0, min_h = 0;
  if (fast_scale && stride >= 6 && plan[0] == OP_RESIZE) {
    min_w = plan[1];
    min_h = plan[2];
  }
  int rc = decode_any(buf.data(), buf.size(), img, min_w, min_h);
  if (rc) return rc;
  if (run_plan(img, plan, stride)) return 1;
  if (img.w != out_w || img.h != out_h) return 1;  // plan must land on target
  std::memcpy(out, img.data.data(), static_cast<size_t>(out_w) * out_h * 3);
  return 0;
}

}  // namespace

// ================================================================== C ABI
extern "C" {

// Decode path -> RGB8 into caller buffer sized w*h*3 (query size first).
// rc: 0 ok, 1 error, 2 unsupported-format (caller should use PIL).
int irw_image_size(const char* path, int* w, int* h) {
  // Header probe: read a bounded prefix, not the whole file (headers sit in
  // the first bytes; EXIF blobs can push a JPEG SOF out, so fall back to a
  // full read only if the prefix parse fails).
  std::vector<uint8_t> buf;
  if (read_file(path, buf, 256 * 1024)) return 1;
  if (is_jpeg(buf.data(), buf.size())) {
    if (jpeg_header_size(buf.data(), buf.size(), w, h) == 0) return 0;
    if (read_file(path, buf)) return 1;
    return jpeg_header_size(buf.data(), buf.size(), w, h);
  }
  if (is_png(buf.data(), buf.size())) {
    if (buf.size() < 24) return 1;
    // IHDR is always first: width/height big-endian at offsets 16/20
    const uint8_t* b = buf.data();
    *w = (b[16] << 24) | (b[17] << 16) | (b[18] << 8) | b[19];
    *h = (b[20] << 24) | (b[21] << 16) | (b[22] << 8) | b[23];
    return 0;
  }
  return 2;
}

int irw_decode(const char* path, uint8_t* out, int cap_w, int cap_h) {
  std::vector<uint8_t> buf;
  if (read_file(path, buf)) return 1;
  ImageU8 img;
  int rc = decode_any(buf.data(), buf.size(), img);
  if (rc) return rc;
  if (img.w != cap_w || img.h != cap_h) return 1;
  std::memcpy(out, img.data.data(), static_cast<size_t>(img.w) * img.h * 3);
  return 0;
}

// Batch load: n samples, each path + geometry plan -> out (n, out_h, out_w, 3)
// u8.  status[i]: 0 ok, 1 error, 2 unsupported (fallback per sample).
// Threaded over an atomic work index; n_threads <= 0 means hw concurrency.
// fast_scale != 0 allows JPEG DCT-domain scaled decode when a sample's plan
// starts with a resize (output differs from full-resolution decode by a few
// LSB — augmentation-grade, not bit-parity; pass 0 for exactness tests).
void irw_load_batch(const char** paths, int n, const int32_t* plans,
                    int plan_stride, int out_w, int out_h, int n_threads,
                    int fast_scale, uint8_t* out, int32_t* status) {
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next{0};
  const size_t sample_sz = static_cast<size_t>(out_w) * out_h * 3;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      // an exception (bad_alloc on a hostile image, length_error) must
      // become a per-sample status — never std::terminate the process
      try {
        status[i] = load_one(paths[i],
                             plans + static_cast<size_t>(i) * plan_stride,
                             plan_stride, out_w, out_h, fast_scale,
                             out + sample_sz * i);
      } catch (...) {
        status[i] = 1;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Standalone resize for tests/benchmarks: src (sh, sw, 3) u8 -> dst.
int irw_resize(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
               int dh, int filter) {
  ImageU8 s;
  s.w = sw;
  s.h = sh;
  s.data.assign(src, src + static_cast<size_t>(sw) * sh * 3);
  ImageU8 d;
  resize_aa(s, dw, dh, filter, d);
  std::memcpy(dst, d.data.data(), static_cast<size_t>(dw) * dh * 3);
  return 0;
}

int irw_abi_version() { return 1; }

}  // extern "C"
