// Native batch image transform: crop + antialiased bilinear resize,
// multithreaded.
//
// The host half of the data path: the geometric part of the pipeline (crop
// box + resize to the model resolution) in C++ with a thread pool, feeding
// fixed-shape uint8 batches to the on-device preprocess (flip, scale,
// normalize). Same source as the JAX package's viscoin_tpu/native, so both
// give the same bytes. Exposed to Python via ctypes
// (viscoin_tpu_torch/native/__init__.py). This is host code, not a kernel.
//
// The resampler is PIL-equivalent BILINEAR: a separable triangle filter whose
// support scales with the downscale ratio (antialiasing), half-pixel centers.

#include <cstdint>
#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

struct FilterTable {
    std::vector<int> xmin;    // first source index per output pixel
    std::vector<int> xsize;   // number of taps per output pixel
    std::vector<float> weights;  // xsize taps per output pixel (stride = ksize)
    int ksize = 0;
};

// Triangle (bilinear) filter coefficients, PIL-style.
FilterTable build_filter(int in_size, int out_size, int offset) {
    FilterTable ft;
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = std::max(scale, 1.0);
    const double support = 1.0 * filterscale;
    ft.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    ft.xmin.resize(out_size);
    ft.xsize.resize(out_size);
    ft.weights.assign(static_cast<size_t>(out_size) * ft.ksize, 0.0f);

    for (int i = 0; i < out_size; ++i) {
        const double center = (i + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        double total = 0.0;
        float* w = &ft.weights[static_cast<size_t>(i) * ft.ksize];
        for (int j = xmin; j < xmax; ++j) {
            double x = (j - center + 0.5) / filterscale;
            double v = (x < 0) ? -x : x;
            v = (v < 1.0) ? 1.0 - v : 0.0;  // triangle
            w[j - xmin] = static_cast<float>(v);
            total += v;
        }
        if (total > 0) {
            for (int j = 0; j < xmax - xmin; ++j) w[j] /= static_cast<float>(total);
        }
        ft.xmin[i] = xmin + offset;
        ft.xsize[i] = xmax - xmin;
    }
    return ft;
}

inline uint8_t clamp_u8(float v) {
    int iv = static_cast<int>(v + 0.5f);
    return static_cast<uint8_t>(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
}

// Crop (top,left,ch,cw) of an (h,w,3) image, resample to (size,size,3).
void resize_region(const uint8_t* src, int w,
                   int top, int left, int ch, int cw,
                   uint8_t* dst, int size, std::vector<float>& tmp) {
    FilterTable fx = build_filter(cw, size, left);
    FilterTable fy = build_filter(ch, size, top);

    // Pass 1: horizontal — (ch, size, 3) float intermediate.
    tmp.resize(static_cast<size_t>(ch) * size * 3);
    for (int y = 0; y < ch; ++y) {
        const uint8_t* row = src + static_cast<int64_t>(top + y) * w * 3;
        float* out_row = &tmp[static_cast<size_t>(y) * size * 3];
        for (int ox = 0; ox < size; ++ox) {
            const float* wts = &fx.weights[static_cast<size_t>(ox) * fx.ksize];
            const int x0 = fx.xmin[ox];
            const int n = fx.xsize[ox];
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int j = 0; j < n; ++j) {
                const uint8_t* p = row + (x0 + j) * 3;
                const float wv = wts[j];
                acc0 += wv * p[0];
                acc1 += wv * p[1];
                acc2 += wv * p[2];
            }
            out_row[ox * 3 + 0] = acc0;
            out_row[ox * 3 + 1] = acc1;
            out_row[ox * 3 + 2] = acc2;
        }
    }

    // Pass 2: vertical.
    for (int oy = 0; oy < size; ++oy) {
        const float* wts = &fy.weights[static_cast<size_t>(oy) * fy.ksize];
        const int y0 = fy.xmin[oy] - top;  // tmp is already crop-relative in y
        const int n = fy.xsize[oy];
        uint8_t* out_row = dst + static_cast<int64_t>(oy) * size * 3;
        for (int ox = 0; ox < size * 3; ++ox) {
            float acc = 0;
            for (int j = 0; j < n; ++j) {
                acc += wts[j] * tmp[static_cast<size_t>(y0 + j) * size * 3 + ox];
            }
            out_row[ox] = clamp_u8(acc);
        }
    }
}

}  // namespace

extern "C" {

// srcs[i]: pointer to an (hs[i], ws[i], 3) uint8 HWC image.
// out: (n, size, size, 3) uint8, contiguous.
void vct_transform_batch(const uint8_t** srcs, const int* hs, const int* ws,
                         const int* tops, const int* lefts,
                         const int* chs, const int* cws,
                         uint8_t* out, int n, int size, int n_threads) {
    (void)hs;
    if (n_threads < 1) n_threads = 1;
    const int64_t item_bytes = static_cast<int64_t>(size) * size * 3;
    auto worker = [&](int tid) {
        std::vector<float> tmp;
        for (int i = tid; i < n; i += n_threads) {
            resize_region(srcs[i], ws[i], tops[i], lefts[i], chs[i], cws[i],
                          out + i * item_bytes, size, tmp);
        }
    };
    if (n_threads == 1) {
        worker(0);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
}

}  // extern "C"
