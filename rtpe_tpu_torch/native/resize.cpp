// Bilinear HWC resize with torch F.interpolate semantics.
//
// The data pipeline upsamples every sample's teacher maps (34 channels
// at half/quarter resolution) to image size on the host before batching
// (same place the reference calls F.interpolate, dataloaders.py:157-164).
// numpy needs ~130 ms per sample for that; this loop does it in ~15 ms
// on one core.  Tap math matches ops/resize.py `_bilinear_taps` exactly
// (float64 source coordinates, float32 blending).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

void taps(int in_size, int out_size, int align_corners,
          std::vector<int64_t>& lo, std::vector<float>& f) {
  lo.resize(out_size);
  f.resize(out_size);
  if (in_size == 1) {
    std::fill(lo.begin(), lo.end(), 0);
    std::fill(f.begin(), f.end(), 0.f);
    return;
  }
  for (int o = 0; o < out_size; ++o) {
    double src;
    if (align_corners) {
      src = (out_size == 1)
                ? 0.0
                : o * (double)(in_size - 1) / (double)(out_size - 1);
    } else {
      src = (o + 0.5) * (double)in_size / (double)out_size - 0.5;
      src = std::min(std::max(src, 0.0), (double)(in_size - 1));
    }
    int64_t l = (int64_t)std::floor(src);
    l = std::min(std::max(l, (int64_t)0), (int64_t)(in_size - 2));
    lo[o] = l;
    f[o] = (float)(src - (double)l);
  }
}

}  // namespace

extern "C" int bilinear_resize_hwc(const float* in, int ih, int iw, int c,
                                   float* out, int oh, int ow,
                                   int align_corners) {
  if (ih <= 0 || iw <= 0 || c <= 0 || oh <= 0 || ow <= 0) return 1;
  std::vector<int64_t> hlo, wlo;
  std::vector<float> hf, wf;
  taps(ih, oh, align_corners, hlo, hf);
  taps(iw, ow, align_corners, wlo, wf);

  // H pass: (ih, iw, c) -> (oh, iw, c)
  const int64_t row = (int64_t)iw * c;
  std::vector<float> tmp((int64_t)oh * row);
  for (int o = 0; o < oh; ++o) {
    const float* r0 = in + hlo[o] * row;
    const float* r1 = in + std::min<int64_t>(hlo[o] + 1, ih - 1) * row;
    const float fh = hf[o];
    float* dst = tmp.data() + (int64_t)o * row;
    for (int64_t k = 0; k < row; ++k)
      dst[k] = r0[k] + fh * (r1[k] - r0[k]);
  }

  // W pass: (oh, iw, c) -> (oh, ow, c)
  for (int o = 0; o < oh; ++o) {
    const float* src = tmp.data() + (int64_t)o * row;
    float* dst = out + (int64_t)o * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float* p0 = src + wlo[x] * c;
      const float* p1 = src + std::min<int64_t>(wlo[x] + 1, iw - 1) * c;
      const float fw = wf[x];
      float* q = dst + (int64_t)x * c;
      for (int k = 0; k < c; ++k) q[k] = p0[k] + fw * (p1[k] - p0[k]);
    }
  }
  return 0;
}
