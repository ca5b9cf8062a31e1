// The per-frame preprocessing oracle in C++ on the host (the port's copy of
// the JAX package's native/lipreading_host.cpp): grayscale, the
// regression-tree landmark cascade and the mouth ROI, frame by frame, with
// the arithmetic of the numpy oracle (lipreading_tpu_torch/oracle):
//   * grayscale: Rec.601 on float32 (r*0.299 + g*0.587 + b*0.114)
//   * ROI: crop-interior-clamped half-pixel-centre bilinear (cv2
//     INTER_LINEAR crop+resize), normalise (g/255 - mean)/std
//   * ERT: nearest pixel via floor(x+0.5), heap-ordered tree descent, a
//     stage's pool gathered at the stage's entry
//
// Built with g++ at first use by lipreading_tpu_torch/native.py and bound
// with ctypes through this plain C interface.

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// [h*w*3] uint8 RGB -> [h*w] float32 luma (0..255)
void lr_grayscale(const uint8_t* rgb, int h, int w, float* out) {
    const int n = h * w;
    for (int i = 0; i < n; ++i) {
        const float r = (float)rgb[3 * i + 0];
        const float g = (float)rgb[3 * i + 1];
        const float b = (float)rgb[3 * i + 2];
        out[i] = r * 0.299f + g * 0.587f + b * 0.114f;
    }
}

static inline void interp_axis(int n, int off, int limit, int out_size,
                               int* i0, float* frac) {
    for (int j = 0; j < out_size; ++j) {
        float src = ((float)j + 0.5f) * ((float)n / (float)out_size) - 0.5f;
        src = std::min(std::max(src, 0.0f), (float)n - 1.0f);
        int i = (int)std::floor(src);
        i = std::min(i, std::max(n - 2, 0));
        frac[j] = src - (float)i;
        i0[j] = std::min(std::max(i + off, 0), limit - 2);
    }
}

// Bilinear-resample integer square crop (x0, y0, size) of gray [H, W] to
// [out_size, out_size]; optionally normalize (g/255 - mean)/std.
void lr_sample_roi(const float* gray, int H, int W,
                   int x0, int y0, int size, int out_size,
                   float mean, float stdev, int normalize, float* out) {
    if (out_size <= 0 || size <= 0 || H < 2 || W < 2) return;
    // heap interpolation tables: any out_size is legal (the old fixed
    // int[256] buffers were silent stack corruption past 256)
    std::vector<int> yi(out_size), xi(out_size);
    std::vector<float> yf(out_size), xf(out_size);
    interp_axis(size, y0, H, out_size, yi.data(), yf.data());
    interp_axis(size, x0, W, out_size, xi.data(), xf.data());
    for (int i = 0; i < out_size; ++i) {
        const float* row0 = gray + yi[i] * W;
        const float* row1 = gray + (yi[i] + 1) * W;
        const float wy = yf[i];
        float* o = out + i * out_size;
        for (int j = 0; j < out_size; ++j) {
            const float wx = xf[j];
            const float top = row0[xi[j]] * (1.0f - wx) + row0[xi[j] + 1] * wx;
            const float bot = row1[xi[j]] * (1.0f - wx) + row1[xi[j] + 1] * wx;
            float v = top * (1.0f - wy) + bot * wy;
            if (normalize) v = (v / 255.0f - mean) / stdev;
            o[j] = v;
        }
    }
}

// Full ERT cascade: gray [H, W] + square face box -> 68 landmarks (pixels).
// Layout of oracle/ert.py's ERTModel arrays (C-contiguous float32/int32).
void lr_ert_predict(const float* gray, int H, int W,
                    float bx, float by, float bsize,
                    const float* mean_shape,   // [68*2]
                    const int32_t* anchors,    // [S*P]
                    const float* offsets,      // [S*P*2]
                    const int32_t* feat1,      // [S*K*NN]
                    const int32_t* feat2,      // [S*K*NN]
                    const float* thresh,       // [S*K*NN]
                    const float* leaves,       // [S*K*NL*136]
                    int S, int P, int K, int D,
                    float* out) {              // [68*2] pixels
    const int NN = (1 << D) - 1;
    const int NL = 1 << D;
    float shape[136];
    for (int i = 0; i < 136; ++i) shape[i] = mean_shape[i];
    std::vector<float> vals(P > 0 ? P : 1);  // any pool size is legal

    for (int s = 0; s < S; ++s) {
        const int32_t* anc = anchors + s * P;
        const float* off = offsets + s * P * 2;
        for (int p = 0; p < P; ++p) {
            const int a = anc[p];
            const float px = (shape[2 * a] + off[2 * p]) * bsize + bx;
            const float py = (shape[2 * a + 1] + off[2 * p + 1]) * bsize + by;
            int xi = (int)std::floor(px + 0.5f);
            int yi = (int)std::floor(py + 0.5f);
            xi = std::min(std::max(xi, 0), W - 1);
            yi = std::min(std::max(yi, 0), H - 1);
            vals[p] = gray[yi * W + xi];
        }
        const int32_t* f1s = feat1 + s * K * NN;
        const int32_t* f2s = feat2 + s * K * NN;
        const float* ths = thresh + s * K * NN;
        const float* lvs = leaves + (size_t)s * K * NL * 136;
        for (int k = 0; k < K; ++k) {
            int node = 0;
            const int32_t* f1 = f1s + k * NN;
            const int32_t* f2 = f2s + k * NN;
            const float* th = ths + k * NN;
            for (int d = 0; d < D; ++d) {
                const bool right = (vals[f1[node]] - vals[f2[node]]) > th[node];
                node = 2 * node + 1 + (right ? 1 : 0);
            }
            const float* leaf = lvs + ((size_t)k * NL + (node - NN)) * 136;
            for (int i = 0; i < 136; ++i) shape[i] += leaf[i];
        }
    }
    for (int i = 0; i < 68; ++i) {
        out[2 * i] = shape[2 * i] * bsize + bx;
        out[2 * i + 1] = shape[2 * i + 1] * bsize + by;
    }
}

// Batched convenience: T frames through gray -> ERT (boxes given) -> ROI.
// frames: [T*H*W*3] u8; boxes: [T*3] float (x0, y0, size); landmarks out
// optional (pass null to skip); rois out [T*out_size^2].
void lr_preprocess_clip(const uint8_t* frames, int T, int H, int W,
                        const float* boxes,
                        const float* mean_shape, const int32_t* anchors,
                        const float* offsets, const int32_t* feat1,
                        const int32_t* feat2, const float* thresh,
                        const float* leaves, int S, int P, int K, int D,
                        float roi_margin, int out_size,
                        float mean, float stdev,
                        float* landmarks_out, float* rois_out) {
    float* gray = new float[(size_t)H * W];
    float lm[136];
    for (int t = 0; t < T; ++t) {
        lr_grayscale(frames + (size_t)t * H * W * 3, H, W, gray);
        const float* b = boxes + t * 3;
        lr_ert_predict(gray, H, W, b[0], b[1], b[2], mean_shape, anchors,
                       offsets, feat1, feat2, thresh, leaves, S, P, K, D, lm);
        if (landmarks_out) {
            for (int i = 0; i < 136; ++i) landmarks_out[t * 136 + i] = lm[i];
        }
        // mouth box from landmarks 48..67 (same geometry as oracle/roi.py)
        float mnx = 1e30f, mny = 1e30f, mxx = -1e30f, mxy = -1e30f;
        for (int i = 48; i < 68; ++i) {
            mnx = std::min(mnx, lm[2 * i]);
            mxx = std::max(mxx, lm[2 * i]);
            mny = std::min(mny, lm[2 * i + 1]);
            mxy = std::max(mxy, lm[2 * i + 1]);
        }
        const float cx = (mnx + mxx) * 0.5f, cy = (mny + mxy) * 0.5f;
        const float msize = std::max(mxx - mnx, mxy - mny) * (1.0f + roi_margin);
        // round_box
        int s = (int)std::floor(msize + 0.5f);
        s = std::max(2, std::min(s, std::min(H, W)));
        int x0 = (int)std::floor(cx - msize * 0.5f + 0.5f);
        int y0 = (int)std::floor(cy - msize * 0.5f + 0.5f);
        x0 = std::max(0, std::min(x0, W - s));
        y0 = std::max(0, std::min(y0, H - s));
        lr_sample_roi(gray, H, W, x0, y0, s, out_size, mean, stdev, 1,
                      rois_out + (size_t)t * out_size * out_size);
    }
    delete[] gray;
}

}  // extern "C"
