// prometheus_io: the host data plane of the port's input and output paths,
// a copy of the JAX package's prometheus_tpu/native/prometheus_io.cpp with
// the same arithmetic, so both packages give bit-equal frames and records.
// Dependency-free C++ behind a C ABI (bound with ctypes):
//
//   - center_crop_resize_normalize: uint8 HWC -> central-square crop ->
//     antialiased (triangle) resize -> float32 CHW in [-1, 1] (the per-frame
//     transform of the training input path)
//   - decode_jpeg_crop_resize_normalize (built with -DPROMETHEUS_JPEG and
//     -ljpeg): libjpeg's DCT-downscaled decode fused with that transform
//   - encode_splat: pack gaussians into antimatter15 .splat records, sorted
//     by volume x opacity (the export loop: ~0.5M records a scene)
//   - u8_to_chw_f32: plain layout and normalisation of pre-sized frames
//
// Build: g++ -O3 -shared -fPIC -std=c++17 at first use into
// build/prometheus_torch/ (prometheus_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// Separable triangle-filter (antialiased bilinear, the PIL/torchvision
// `antialias=True` convention) resample weights for one output axis.
static void make_taps(int in_size, int out_size,
                      std::vector<int>& starts, std::vector<int>& counts,
                      std::vector<float>& weights, int& max_taps) {
    const float scale = static_cast<float>(in_size) / out_size;
    const float fscale = scale > 1.0f ? scale : 1.0f;   // filter stretch
    const float support = fscale;                        // triangle radius
    max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
    starts.resize(out_size);
    counts.resize(out_size);
    weights.assign(static_cast<size_t>(out_size) * max_taps, 0.0f);
    for (int o = 0; o < out_size; ++o) {
        const float center = (o + 0.5f) * scale;
        int lo = static_cast<int>(std::floor(center - support + 0.5f));
        int hi = static_cast<int>(std::floor(center + support + 0.5f));
        lo = std::max(lo, 0);
        hi = std::min(hi, in_size);
        float total = 0.0f;
        float* wrow = &weights[static_cast<size_t>(o) * max_taps];
        for (int x = lo; x < hi; ++x) {
            float t = 1.0f - std::abs((x + 0.5f - center) / fscale);
            if (t < 0.0f) t = 0.0f;
            wrow[x - lo] = t;
            total += t;
        }
        if (total <= 0.0f) {  // degenerate: nearest
            lo = std::min(std::max(static_cast<int>(center), 0), in_size - 1);
            hi = lo + 1;
            wrow[0] = 1.0f;
            total = 1.0f;
        }
        for (int i = 0; i < hi - lo; ++i) wrow[i] /= total;
        starts[o] = lo;
        counts[o] = hi - lo;
    }
}

// uint8 HWC (h, w, 3) -> central-square crop -> ANTIALIASED separable
// triangle resize to (out_size, out_size) -> float32 CHW in [-1, 1].
// (Single-pass fused training-input transform; plain 2-tap bilinear
// aliases badly on the common 3-8x downscales.) Returns 0 on success.
int center_crop_resize_normalize(const uint8_t* src, int h, int w,
                                 int out_size, float* dst) {
    if (h <= 0 || w <= 0 || out_size <= 0) return 1;
    const int s = h < w ? h : w;
    const int top = (h - s) / 2;
    const int left = (w - s) / 2;
    const int plane = out_size * out_size;

    std::vector<int> xs, xc, ys, yc;
    std::vector<float> xw, yw;
    int xt, yt;
    make_taps(s, out_size, xs, xc, xw, xt);
    make_taps(s, out_size, ys, yc, yw, yt);

    // pass 1: horizontal resample of the cropped rows -> (s, out_size, 3)
    std::vector<float> tmp(static_cast<size_t>(s) * out_size * 3);
    for (int y = 0; y < s; ++y) {
        const uint8_t* row = src + ((top + y) * w + left) * 3;
        float* trow = &tmp[static_cast<size_t>(y) * out_size * 3];
        for (int ox = 0; ox < out_size; ++ox) {
            const float* wrow = &xw[static_cast<size_t>(ox) * xt];
            const int lo = xs[ox], n = xc[ox];
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int i = 0; i < n; ++i) {
                const float wgt = wrow[i];
                const uint8_t* p = row + (lo + i) * 3;
                acc0 += wgt * p[0];
                acc1 += wgt * p[1];
                acc2 += wgt * p[2];
            }
            trow[ox * 3] = acc0;
            trow[ox * 3 + 1] = acc1;
            trow[ox * 3 + 2] = acc2;
        }
    }
    // pass 2: vertical resample + normalize + CHW scatter
    for (int oy = 0; oy < out_size; ++oy) {
        const float* wrow = &yw[static_cast<size_t>(oy) * yt];
        const int lo = ys[oy], n = yc[oy];
        for (int ox = 0; ox < out_size; ++ox) {
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int i = 0; i < n; ++i) {
                const float wgt = wrow[i];
                const float* p = &tmp[(static_cast<size_t>(lo + i) * out_size
                                       + ox) * 3];
                acc0 += wgt * p[0];
                acc1 += wgt * p[1];
                acc2 += wgt * p[2];
            }
            const int o = oy * out_size + ox;
            dst[o] = acc0 * (1.0f / 127.5f) - 1.0f;
            dst[plane + o] = acc1 * (1.0f / 127.5f) - 1.0f;
            dst[2 * plane + o] = acc2 * (1.0f / 127.5f) - 1.0f;
        }
    }
    return 0;
}

#ifdef PROMETHEUS_JPEG
// Fully-native frame path: JPEG bytes -> libjpeg(-turbo) DCT-downscaled
// decode (largest 1/2^k <= max_denom keeping the short side >= out_size —
// the same rule as transforms.decode_image_draft) -> central-square crop ->
// antialiased resize -> float32 CHW in [-1, 1], in ONE call with no
// intermediate Python objects. dims out: {full_w, full_h, dec_w, dec_h}
// (for per-axis intrinsics rescale). Returns 0 on success; nonzero asks the
// caller to fall back to the Python decoder (corrupt/exotic files).
int decode_jpeg_crop_resize_normalize(const uint8_t* data, int len,
                                      int out_size, int max_denom,
                                      float* dst, int* dims);
#endif

// uint8 HWC -> float32 CHW in [-1, 1] (no resize).
int u8_to_chw_f32(const uint8_t* src, int h, int w, float* dst) {
    const int plane = h * w;
    for (int i = 0; i < plane; ++i) {
        dst[i] = src[i * 3] * (1.0f / 127.5f) - 1.0f;
        dst[plane + i] = src[i * 3 + 1] * (1.0f / 127.5f) - 1.0f;
        dst[2 * plane + i] = src[i * 3 + 2] * (1.0f / 127.5f) - 1.0f;
    }
    return 0;
}

// Pack n gaussians into 32-byte .splat records, sorted descending by
// volume * opacity. Inputs are activated values. out must hold 32*n bytes.
// Returns the number of records written (after opacity pruning).
int encode_splat(const float* xyz, const float* rgb, const float* opacity,
                 const float* scales, const float* rots, int n,
                 float opacity_threshold, uint8_t* out) {
    const float SH_C0 = 0.28209479177387814f;
    std::vector<int> order;
    order.reserve(n);
    std::vector<float> keys(n);
    for (int i = 0; i < n; ++i) {
        if (opacity[i] >= opacity_threshold) {
            keys[i] = scales[i * 3] * scales[i * 3 + 1] * scales[i * 3 + 2]
                    * opacity[i];
            order.push_back(i);
        }
    }
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return keys[a] > keys[b]; });

    uint8_t* p = out;
    for (int idx : order) {
        std::memcpy(p, xyz + idx * 3, 12);
        std::memcpy(p + 12, scales + idx * 3, 12);
        for (int c = 0; c < 3; ++c) {
            float v = (0.5f + SH_C0 * rgb[idx * 3 + c]) * 255.0f;
            p[24 + c] = static_cast<uint8_t>(std::min(std::max(v, 0.f), 255.f));
        }
        float a = opacity[idx] * 255.0f;
        p[27] = static_cast<uint8_t>(std::min(std::max(a, 0.f), 255.f));
        float norm = 0.f;
        for (int c = 0; c < 4; ++c) norm += rots[idx * 4 + c] * rots[idx * 4 + c];
        norm = std::sqrt(std::max(norm, 1e-12f));
        for (int c = 0; c < 4; ++c) {
            float q = rots[idx * 4 + c] / norm * 128.0f + 128.0f;
            p[28 + c] = static_cast<uint8_t>(std::min(std::max(q, 0.f), 255.f));
        }
        p += 32;
    }
    return static_cast<int>(order.size());
}

#ifdef PROMETHEUS_JPEG
}  // extern "C"  (jpeglib.h must be included at file scope, outside it)

#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>

namespace {
struct PJErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};
void pj_error_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<PJErr*>(cinfo->err)->jb, 1);
}
void pj_silence(j_common_ptr, int) {}
}  // namespace

extern "C" {

int decode_jpeg_crop_resize_normalize(const uint8_t* data, int len,
                                      int out_size, int max_denom,
                                      float* dst, int* dims) {
    if (len <= 0 || out_size <= 0) return 1;
    jpeg_decompress_struct cinfo;
    PJErr jerr;
    std::vector<uint8_t> pixels;  // before setjmp: longjmp re-enters below,
                                  // we return normally, destructor runs
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = pj_error_exit;
    jerr.mgr.emit_message = pj_silence;    // no stderr spam on warnings
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 2;                           // caller falls back to Python
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    const int fw = static_cast<int>(cinfo.image_width);
    const int fh = static_cast<int>(cinfo.image_height);
    const int s = fw < fh ? fw : fh;
    int denom = 1;
    if (max_denom < 1) max_denom = 1;
    while (denom < max_denom && s / (2 * denom) >= out_size) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned>(denom);
    cinfo.out_color_space = JCS_RGB;        // turbo converts gray/YCbCr
    jpeg_start_decompress(&cinfo);
    const int dw = static_cast<int>(cinfo.output_width);
    const int dh = static_cast<int>(cinfo.output_height);
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    pixels.resize(static_cast<size_t>(dw) * dh * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = &pixels[static_cast<size_t>(cinfo.output_scanline)
                               * dw * 3];
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    dims[0] = fw;
    dims[1] = fh;
    dims[2] = dw;
    dims[3] = dh;
    return center_crop_resize_normalize(pixels.data(), dh, dw, out_size, dst);
}
#endif  // PROMETHEUS_JPEG

}  // extern "C"
