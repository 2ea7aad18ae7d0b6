// PNG scanline unfiltering for the port's PNG reader (utils/png.py).
//
// The five row filters of the PNG specification (section 9.2): each row of
// the decompressed image stream is one filter-type byte and `stride` filtered
// bytes; a byte is reconstructed from the raw byte and its reconstructed
// neighbours a (the byte `bpp` to the left), b (the byte above) and c (the
// byte above a):
//   0 None    x
//   1 Sub     x + a
//   2 Up      x + b
//   3 Average x + floor((a + b) / 2)
//   4 Paeth   x + PaethPredictor(a, b, c)
// all modulo 256, with a, b and c taken as 0 outside the image.  Average and
// Paeth depend on the byte just reconstructed, so they run byte by byte; the
// byte-lane width `bpp` is a template parameter for the widths that 8-bit
// grey, RGB and RGBA and 16-bit grey and RGB give, so that the compiler keeps
// the lanes in registers.
//
// A plain C ABI for ctypes, built at first use by data/native.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

template <int BPP>
bool unfilter_row(int ftype, const uint8_t* raw, const uint8_t* prev, uint8_t* cur,
                  int64_t stride, int bpp_runtime) {
    const int64_t bpp = BPP > 0 ? BPP : bpp_runtime;
    const int64_t head = bpp < stride ? bpp : stride;
    switch (ftype) {
    case 0:
        std::memcpy(cur, raw, static_cast<size_t>(stride));
        return true;
    case 1:
        std::memcpy(cur, raw, static_cast<size_t>(head));
        for (int64_t i = bpp; i < stride; ++i) cur[i] = static_cast<uint8_t>(raw[i] + cur[i - bpp]);
        return true;
    case 2:
        if (prev == nullptr) {
            std::memcpy(cur, raw, static_cast<size_t>(stride));
        } else {
            for (int64_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(raw[i] + prev[i]);
        }
        return true;
    case 3:
        if (prev == nullptr) {
            std::memcpy(cur, raw, static_cast<size_t>(head));
            for (int64_t i = bpp; i < stride; ++i)
                cur[i] = static_cast<uint8_t>(raw[i] + (cur[i - bpp] >> 1));
        } else {
            for (int64_t i = 0; i < head; ++i)
                cur[i] = static_cast<uint8_t>(raw[i] + (prev[i] >> 1));
            for (int64_t i = bpp; i < stride; ++i)
                cur[i] = static_cast<uint8_t>(raw[i] + ((cur[i - bpp] + prev[i]) >> 1));
        }
        return true;
    case 4:
        if (prev == nullptr) {  // b = c = 0: the predictor is a, as in Sub
            std::memcpy(cur, raw, static_cast<size_t>(head));
            for (int64_t i = bpp; i < stride; ++i) cur[i] = static_cast<uint8_t>(raw[i] + cur[i - bpp]);
        } else {
            for (int64_t i = 0; i < head; ++i)  // a = c = 0: the predictor is b
                cur[i] = static_cast<uint8_t>(raw[i] + prev[i]);
            for (int64_t i = bpp; i < stride; ++i)
                cur[i] = static_cast<uint8_t>(raw[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        }
        return true;
    default:
        return false;
    }
}

template <int BPP>
int64_t unfilter_rows(const uint8_t* src, int64_t h, int64_t stride, int bpp, uint8_t* dst) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * (stride + 1);
        uint8_t* cur = dst + y * stride;
        if (!unfilter_row<BPP>(row[0], row + 1, prev, cur, stride, bpp)) return y;
        prev = cur;
    }
    return -1;
}

}  // namespace

extern "C" {

// src: h rows of (1 + stride) bytes, each a filter-type byte then the
// filtered bytes; dst: h rows of stride bytes.  Returns -1, or the index of
// the first row whose filter type is not 0-4 (dst is then incomplete).
int64_t png_unfilter(const uint8_t* src, int64_t h, int64_t stride, int bpp, uint8_t* dst) {
    switch (bpp) {
    case 1: return unfilter_rows<1>(src, h, stride, bpp, dst);
    case 2: return unfilter_rows<2>(src, h, stride, bpp, dst);
    case 3: return unfilter_rows<3>(src, h, stride, bpp, dst);
    case 4: return unfilter_rows<4>(src, h, stride, bpp, dst);
    case 6: return unfilter_rows<6>(src, h, stride, bpp, dst);
    case 8: return unfilter_rows<8>(src, h, stride, bpp, dst);
    default: return unfilter_rows<0>(src, h, stride, bpp, dst);
    }
}

}  // extern "C"
