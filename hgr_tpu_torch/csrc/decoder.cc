// Native data-loader core: JPEG decode -> bicubic resize (short side) ->
// center crop -> uint8 rows, all in one C++ pass. The port's copy of
// hgr_tpu/data/native/decoder.cc: a host decoder built with g++ and libjpeg
// (hgr_tpu_torch/data/native.py), not a GPU kernel.
//
// The reference's input pipeline leans on 12 torch DataLoader worker
// *processes* doing PIL decode + torchvision transforms
// (dataset/imagenet_group.py:105, clip/clip.py:71-78). Here the hot path is
// a single C function called from Python worker *threads* via ctypes: the
// call releases the GIL, libjpeg does the decode, and the resize and crop
// run fused over the decoded rows — one image never round-trips through
// Python object land.
//
// Bicubic kernel matches PIL's (Catmull-Rom family with a = -0.5) applied
// separably with PIL-style support scaling for downsampling.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

inline float bicubic(float x) {
  // PIL's bicubic filter, a = -0.5
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Separable resample of one axis, PIL-style (support widens when scaling
// down). in: [n_in, stride] interleaved rgb floats.
void resample_axis(const float* in, int n_in, int pixel_stride_in,
                   int row_stride_in, float* out, int n_out,
                   int pixel_stride_out, int row_stride_out, int n_rows) {
  const float scale = static_cast<float>(n_in) / n_out;
  const float filterscale = std::max(scale, 1.0f);
  const float support = 2.0f * filterscale;  // bicubic support = 2

  std::vector<int> starts(n_out);
  std::vector<int> sizes(n_out);
  std::vector<std::vector<float>> weights(n_out);

  for (int i = 0; i < n_out; ++i) {
    const float center = (i + 0.5f) * scale;
    int lo = static_cast<int>(center - support + 0.5f);
    int hi = static_cast<int>(center + support + 0.5f);
    lo = std::max(lo, 0);
    hi = std::min(hi, n_in);
    starts[i] = lo;
    sizes[i] = hi - lo;
    weights[i].resize(hi - lo);
    float total = 0.0f;
    for (int k = lo; k < hi; ++k) {
      float w = bicubic((k - center + 0.5f) / filterscale);
      weights[i][k - lo] = w;
      total += w;
    }
    if (total != 0.0f)
      for (float& w : weights[i]) w /= total;
  }

  for (int r = 0; r < n_rows; ++r) {
    const float* row_in = in + r * row_stride_in;
    float* row_out = out + r * row_stride_out;
    for (int i = 0; i < n_out; ++i) {
      const int lo = starts[i];
      const int sz = sizes[i];
      const float* w = weights[i].data();
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < sz; ++k) {
        const float* px = row_in + (lo + k) * pixel_stride_in;
        const float wk = w[k];
        acc[0] += wk * px[0];
        acc[1] += wk * px[1];
        acc[2] += wk * px[2];
      }
      float* po = row_out + i * pixel_stride_out;
      po[0] = acc[0];
      po[1] = acc[1];
      po[2] = acc[2];
    }
  }
}

// Shared core: decode + DCT prescale + separable bicubic resize (short side
// to out_px) + center crop. Emits [out_px, out_px, 3] floats in 0..255
// (unclamped; callers clamp). Returns 0 on success.
int decode_to_crop(const uint8_t* data, long len, int out_px,
                   std::vector<float>& crop) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescaling: decode at >= target size but as small as possible
  const int min_side0 = std::min(cinfo.image_width, cinfo.image_height);
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 2; denom /= 2) {
    if (min_side0 / denom >= 2 * out_px) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;
  if (ch != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // resize short side to out_px — torchvision functional.resize geometry:
  // the long side is TRUNCATED, int(out_px * long / short), not rounded
  // (torchvision 0.8 = the reference's pin; matches transforms.py
  // resized_dims, which the PIL fallback uses)
  int nw, nh;
  if (w < h) {
    nw = out_px;
    nh = std::max(1, static_cast<int>(static_cast<double>(h) * out_px / w));
  } else {
    nh = out_px;
    nw = std::max(1, static_cast<int>(static_cast<double>(w) * out_px / h));
  }

  std::vector<float> fimg(static_cast<size_t>(w) * h * 3);
  for (size_t i = 0; i < fimg.size(); ++i) fimg[i] = rgb[i];

  // horizontal pass: [h, w, 3] -> [h, nw, 3]
  std::vector<float> tmp(static_cast<size_t>(h) * nw * 3);
  resample_axis(fimg.data(), w, 3, w * 3, tmp.data(), nw, 3, nw * 3, h);
  // vertical pass: [h, nw, 3] -> [nh, nw, 3] (treat columns as rows)
  std::vector<float> resized(static_cast<size_t>(nh) * nw * 3);
  resample_axis(tmp.data(), h, nw * 3, 3, resized.data(), nh, nw * 3, 3, nw);

  // center crop — torchvision functional.center_crop origin:
  // int(round(diff / 2.0)) under Python-3 half-to-EVEN rounding, which
  // std::nearbyint reproduces (FE_TONEAREST). Floor differs by 1 px
  // whenever diff % 4 == 3 (matches transforms.py crop_origin).
  const int left = static_cast<int>(std::nearbyint((nw - out_px) / 2.0));
  const int top = static_cast<int>(std::nearbyint((nh - out_px) / 2.0));
  crop.resize(static_cast<size_t>(out_px) * out_px * 3);
  for (int y = 0; y < out_px; ++y) {
    const float* src = resized.data() +
                       (static_cast<size_t>(y + top) * nw + left) * 3;
    std::memcpy(crop.data() + static_cast<size_t>(y) * out_px * 3, src,
                static_cast<size_t>(out_px) * 3 * sizeof(float));
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode a JPEG buffer and emit [out_px, out_px, 3] raw uint8 (no
// normalization): 4x less host->device transfer than float32, and the
// normalization runs on the device (models/clip.py:encode_image). Returns 0
// on success, nonzero on decode failure.
int hgr_decode_resize_u8(const uint8_t* data, long len, int out_px,
                         uint8_t* out) {
  std::vector<float> crop;
  const int rc = decode_to_crop(data, len, out_px, crop);
  if (rc != 0) return rc;
  const size_t n = static_cast<size_t>(out_px) * out_px * 3;
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint8_t>(
        std::lround(std::min(255.0f, std::max(0.0f, crop[i]))));
  }
  return 0;
}

}  // extern "C"
