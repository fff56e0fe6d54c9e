// Host-side image preprocessing core (C++/OpenMP).
//
// The reference delegates decode/resize/normalize to torchvision's C++ ops
// (reference trainer.py:69-94); this is the first-party equivalent for the
// host input pipeline: batched bilinear resize (align_corners=False, i.e.
// half-pixel centers, matching torchvision.transforms.Resize) fused with
// ToTensor scaling and per-channel normalization, HWC uint8 -> CHW float32,
// parallelized across the batch with OpenMP.
//
// The PyTorch port's copy of native/preproc.cc (the port imports nothing
// of the JAX package).  Built as a shared library at first use and bound
// via ctypes (image2text_torch/training/native.py); where it cannot be
// built, the uint8 path raises.

#include <cstdint>
#include <algorithm>

extern "C" {

// in:  (b, h, w, c) uint8, contiguous
// out: (b, c, size, size) float32, contiguous
// mean/std: (c,) float32, applied after /255 scaling
void resize_normalize_batch(const uint8_t* in, int64_t b, int64_t h,
                            int64_t w, int64_t c, float* out, int64_t size,
                            const float* mean, const float* stddev) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* img = in + i * h * w * c;
    float* dst = out + i * c * size * size;
    for (int64_t oy = 0; oy < size; ++oy) {
      // half-pixel-center source coordinate
      float sy = (static_cast<float>(oy) + 0.5f) * h / size - 0.5f;
      int64_t y0 = static_cast<int64_t>(sy >= 0 ? sy : sy - 1);  // floor
      float wy = sy - y0;
      int64_t y0c = std::min(std::max(y0, int64_t(0)), h - 1);
      int64_t y1c = std::min(std::max(y0 + 1, int64_t(0)), h - 1);
      wy = std::min(std::max(wy, 0.0f), 1.0f);
      for (int64_t ox = 0; ox < size; ++ox) {
        float sx = (static_cast<float>(ox) + 0.5f) * w / size - 0.5f;
        int64_t x0 = static_cast<int64_t>(sx >= 0 ? sx : sx - 1);
        float wx = sx - x0;
        int64_t x0c = std::min(std::max(x0, int64_t(0)), w - 1);
        int64_t x1c = std::min(std::max(x0 + 1, int64_t(0)), w - 1);
        wx = std::min(std::max(wx, 0.0f), 1.0f);
        const uint8_t* p00 = img + (y0c * w + x0c) * c;
        const uint8_t* p01 = img + (y0c * w + x1c) * c;
        const uint8_t* p10 = img + (y1c * w + x0c) * c;
        const uint8_t* p11 = img + (y1c * w + x1c) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                    wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
          v = v / 255.0f;
          v = (v - mean[ch]) / stddev[ch];
          dst[ch * size * size + oy * size + ox] = v;
        }
      }
    }
  }
}

// Caption-expansion shuffle core (reference training/utils.py:52-60):
// given a permutation, gather rows of images (b, n) float32 and labels
// (b, l) int64 in one parallel pass.
void permute_gather(const float* images, const int64_t* labels,
                    const int64_t* perm, int64_t b, int64_t img_stride,
                    int64_t lab_stride, float* images_out,
                    int64_t* labels_out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const int64_t src = perm[i];
    const float* is = images + src * img_stride;
    float* id = images_out + i * img_stride;
    std::copy(is, is + img_stride, id);
    const int64_t* ls = labels + src * lab_stride;
    int64_t* ld = labels_out + i * lab_stride;
    std::copy(ls, ls + lab_stride, ld);
  }
}

}  // extern "C"
