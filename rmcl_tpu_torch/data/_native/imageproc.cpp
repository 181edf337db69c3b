// Native image pipeline for the rmcl_tpu_torch host data path.
//
// The reference's image preprocessing is PIL/torchvision C code under
// Python orchestration (reference vilt/transforms/utils.py:5-49:
// MinMaxResize -> ToTensor -> inception normalize).  This module fuses
// that path natively:
//
//   ip_resize_bicubic_u8   two-pass bicubic resample, BIT-EXACT to
//                          PIL.Image.resize(..., BICUBIC) on 8-bit RGB
//                          (same filter a=-0.5, same antialias support
//                          scaling, same fixed-point coefficient
//                          rounding and clip — Pillow Resample.c
//                          semantics); parity asserted elementwise in
//                          tests/test_torch_extras.py.
//   ip_normalize_hwc       u8 HWC -> float32 (x/255 - .5)/.5 in one
//                          pass (ToTensor + inception_normalize).
//
// Exposed via ctypes (rmcl_tpu_torch/data/_native/__init__.py); the
// Python PIL path runs where no g++ is on PATH.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

inline uint8_t clip8(int32_t in) {
    // Pillow clip8: INT32 accumulator, shift by PRECISION_BITS
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc
int precompute_coeffs(int inSize, int outSize, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
    const double support_base = 2.0;  // bicubic
    double scale = (double)inSize / outSize;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support_base * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;

    std::vector<double> prekk((size_t)outSize * ksize, 0.0);
    bounds.assign((size_t)outSize * 2, 0);
    for (int xx = 0; xx < outSize; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        double* k = &prekk[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[(size_t)xx * 2 + 0] = xmin;
        bounds[(size_t)xx * 2 + 1] = xmax;
    }
    kk.assign(prekk.size(), 0);
    for (size_t i = 0; i < prekk.size(); i++) {
        kk[i] = prekk[i] < 0
                    ? (int32_t)(-0.5 + prekk[i] * (1 << PRECISION_BITS))
                    : (int32_t)(0.5 + prekk[i] * (1 << PRECISION_BITS));
    }
    return ksize;
}

template <typename T>
static int patch_rows_scatter(const T* img, int h, int w,
                              int H, int W, int P, T* out) {
    if (P <= 0 || H % P || W % P) return 1;
    const int gw = W / P;
    const size_t prow = (size_t)P * P * 3;       // out row elements
    const size_t chunk = (size_t)P * 3;
    const int ch = h < H ? h : H;
    const int cw = w < W ? w : W;
    const int gimax = (ch + P - 1) / P, gjmax = (cw + P - 1) / P;
    // patch-major: each out row (one patch, P*P*3 elements) is written
    // sequentially; reads stride w*3 between the patch's image rows
    for (int gi = 0; gi < gimax; gi++) {
        const int y0 = gi * P;
        const int ny = (ch - y0) < P ? (ch - y0) : P;
        for (int gj = 0; gj < gjmax; gj++) {
            const int x0 = gj * P;
            const size_t nx = (size_t)((cw - x0) < P ? (cw - x0) : P) * 3;
            T* op = out + ((size_t)gi * gw + gj) * prow;
            const T* sp = img + ((size_t)y0 * w + x0) * 3;
            for (int ph = 0; ph < ny; ph++)
                memcpy(op + (size_t)ph * chunk, sp + (size_t)ph * w * 3,
                       nx * sizeof(T));
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// in:  (inH, inW, C) u8 contiguous;  out: (outH, outW, C) u8.
// Returns 0 on success.  Two-pass: horizontal into a temp
// (inH, outW, C), then vertical — Pillow's ImagingResample order.
int ip_resize_bicubic_u8(const uint8_t* in, int inH, int inW, int C,
                         int outH, int outW, uint8_t* out) {
    if (inH <= 0 || inW <= 0 || outH <= 0 || outW <= 0 || C != 3)
        return 1;  // RGB only (callers convert("RGB") first)

    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    const int hks = precompute_coeffs(inW, outW, hb, hk);
    const int vks = precompute_coeffs(inH, outH, vb, vk);

    std::vector<uint8_t> tmp((size_t)inH * outW * C);
    // horizontal (per output pixel gather; Pillow's INT32 accumulation)
    for (int y = 0; y < inH; y++) {
        const uint8_t* row = in + (size_t)y * inW * C;
        uint8_t* trow = tmp.data() + (size_t)y * outW * C;
        for (int xx = 0; xx < outW; xx++) {
            const int xmin = hb[(size_t)xx * 2 + 0];
            const int xmax = hb[(size_t)xx * 2 + 1];
            const int32_t* k = &hk[(size_t)xx * hks];
            int32_t s0 = 1 << (PRECISION_BITS - 1);
            int32_t s1 = s0, s2 = s0;
            const uint8_t* p = row + (size_t)xmin * C;
            for (int x = 0; x < xmax; x++, p += C) {
                s0 += (int32_t)p[0] * k[x];
                s1 += (int32_t)p[1] * k[x];
                s2 += (int32_t)p[2] * k[x];
            }
            trow[(size_t)xx * C + 0] = clip8(s0);
            trow[(size_t)xx * C + 1] = clip8(s1);
            trow[(size_t)xx * C + 2] = clip8(s2);
        }
    }
    // vertical: stream whole rows into an int32 accumulator — contiguous
    // loads, autovectorizes
    const size_t rowN = (size_t)outW * C;
    std::vector<int32_t> acc(rowN);
    for (int yy = 0; yy < outH; yy++) {
        const int ymin = vb[(size_t)yy * 2 + 0];
        const int ymax = vb[(size_t)yy * 2 + 1];
        const int32_t* k = &vk[(size_t)yy * vks];
        for (size_t i = 0; i < rowN; i++) acc[i] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) {
            const uint8_t* trow = tmp.data() + (size_t)(y + ymin) * rowN;
            const int32_t kv = k[y];
            for (size_t i = 0; i < rowN; i++)
                acc[i] += (int32_t)trow[i] * kv;
        }
        uint8_t* orow = out + (size_t)yy * rowN;
        for (size_t i = 0; i < rowN; i++) orow[i] = clip8(acc[i]);
    }
    return 0;
}

// u8 (h, w, 3) -> float32 (h, w, 3), (x/255 - 0.5)/0.5
// (ToTensor + inception_normalize, reference transforms/utils.py:46-49)
int ip_normalize_hwc(const uint8_t* in, int h, int w, int c, float* out) {
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++)
            lut[i] = ((float)i / 255.0f - 0.5f) / 0.5f;
        init = true;
    }
    const size_t n = (size_t)h * w * c;
    for (size_t i = 0; i < n; i++) out[i] = lut[in[i]];
    return 0;
}

// One normalized f32 image (h, w, 3) scattered into ONE batch
// element's patch rows (gh*gw, P*P*3), (ph, pw, ch) flat order,
// zero-padded to the (H, W) bucket canvas — the canvas itself is never
// materialized.  `out` (the batch element) must be pre-zeroed.
// Replaces collate's zero-canvas fill + numpy 6-D transpose
// (data/patch_rows.py:hwc_to_patch_rows), whose generic strided iterator
// ran at ~27 MB/s; this is pure row-segment memcpy.
int ip_image_to_patch_rows(const float* img, int h, int w,
                           int H, int W, int P, float* out) {
    return patch_rows_scatter(img, h, w, H, W, P, out);
}

// uint8 variant — same layout, 4x fewer bytes (the device normalizes
// on entry; models/vit.py normalize_image_inputs).
int ip_image_to_patch_rows_u8(const uint8_t* img, int h, int w,
                              int H, int W, int P, uint8_t* out) {
    return patch_rows_scatter(img, h, w, H, W, P, out);
}

}  // extern "C"
