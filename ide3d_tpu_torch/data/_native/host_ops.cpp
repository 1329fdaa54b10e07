// host_ops: the loader's per-sample transforms on the host, in C++.
//
// Counterpart of ide3d_tpu/data/_native/host_ops.cpp with a plain C
// interface over raw pointers instead of the CPython / numpy C API: the
// caller (data/_native/__init__.py) checks shapes, dtypes and contiguity,
// allocates the outputs and calls through ctypes, which releases the
// interpreter lock for the call, so the loader threads of data/prefetch.py
// overlap. Built by g++ at first use (_build.build_host); no -march=native,
// so a library built on one host runs on another.
//
//   ide3d_onehot_seg      mask u8 [H,W] -> f32 [H,W,C] in {-1,+1}; ids >= C
//                         are class 0
//   ide3d_normalize_img   img u8 [H,W,3] -> f32 [H,W,3] in [-1,1]
//   ide3d_batch_assemble  B images (and masks) -> f32 [B,H,W,3] (and
//                         [B,H,W,C]), each optionally flipped in x

#include <cstdint>

namespace {

// mask [H, W] uint8 -> one-hot [H, W, C] float32 scaled to {-1, +1}.
void onehot_kernel(const uint8_t* mask, float* out, int64_t h, int64_t w, int num_classes,
                   bool flip_x) {
  const int64_t n = h * w * num_classes;
  for (int64_t i = 0; i < n; ++i) out[i] = -1.0f;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = mask + y * w;
    float* orow = out + y * w * num_classes;
    for (int64_t x = 0; x < w; ++x) {
      int cls = row[flip_x ? (w - 1 - x) : x];
      if (cls >= num_classes) cls = 0;
      orow[x * num_classes + cls] = 1.0f;
    }
  }
}

// img [H, W, 3] uint8 -> float32 in [-1, 1].
void normalize_kernel(const uint8_t* img, float* out, int64_t h, int64_t w, bool flip_x) {
  constexpr float kScale = 1.0f / 127.5f;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = img + y * w * 3;
    float* orow = out + y * w * 3;
    for (int64_t x = 0; x < w; ++x) {
      const uint8_t* px = row + (flip_x ? (w - 1 - x) : x) * 3;
      orow[x * 3 + 0] = px[0] * kScale - 1.0f;
      orow[x * 3 + 1] = px[1] * kScale - 1.0f;
      orow[x * 3 + 2] = px[2] * kScale - 1.0f;
    }
  }
}

}  // namespace

extern "C" {

void ide3d_onehot_seg(const uint8_t* mask, float* out, int64_t h, int64_t w, int num_classes,
                      int flip) {
  onehot_kernel(mask, out, h, w, num_classes, flip != 0);
}

void ide3d_normalize_img(const uint8_t* img, float* out, int64_t h, int64_t w, int flip) {
  normalize_kernel(img, out, h, w, flip != 0);
}

// segs and seg_out are null for a batch without masks.
void ide3d_batch_assemble(const uint8_t* const* imgs, const uint8_t* const* segs,
                          const int* flips, int64_t b, int64_t h, int64_t w, int num_classes,
                          float* img_out, float* seg_out) {
  for (int64_t i = 0; i < b; ++i) {
    normalize_kernel(imgs[i], img_out + i * h * w * 3, h, w, flips[i] != 0);
    if (segs != nullptr)
      onehot_kernel(segs[i], seg_out + i * h * w * num_classes, h, w, num_classes,
                    flips[i] != 0);
  }
}

}  // extern "C"
