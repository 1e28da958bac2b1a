// Native PNG encoder for the output/logging path (the port's copy of
// splice_tpu/native/pngio.cpp; host code, not a device kernel).
//
// The run's output PNG is the one host-side cost left at a log boundary
// (every log_images_freq steps at full image resolution). This encoder
// writes RGB8 PNGs straight from the uint8 frame copied off the device:
// scanline filtering (none/sub/up heuristic) + zlib deflate + CRC, no
// Python-object churn, releasing the GIL via ctypes.
//
// Exposed C ABI (ctypes binding: splice_tpu_torch/utils/pngio.py):
//   int png_encode_rgb8(const uint8_t* rgb, int h, int w, int stride,
//                       int compress_level, uint8_t* out, size_t out_cap);
//     returns number of bytes written, or -1 on failure/overflow.
//   size_t png_max_size(int h, int w);
//
// Build: g++ -O3 -shared -fPIC pngio.cpp -lz -o libpngio.so

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

inline void put_be32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24);
    p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8);
    p[3] = uint8_t(v);
}

// Append one chunk: length + type + payload + CRC32(type|payload).
size_t write_chunk(uint8_t* out, const char type[4], const uint8_t* payload,
                   uint32_t len) {
    put_be32(out, len);
    std::memcpy(out + 4, type, 4);
    if (len) std::memcpy(out + 8, payload, len);
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, out + 4, len + 4);
    put_be32(out + 8 + len, uint32_t(crc));
    return 12 + len;
}

// Sum of absolute signed residuals — the standard minimum-sum-of-absolute-
// differences heuristic for picking a PNG scanline filter.
inline uint64_t residual_cost(const uint8_t* row, size_t n) {
    uint64_t s = 0;
    for (size_t i = 0; i < n; ++i) {
        int v = int8_t(row[i]);
        s += v < 0 ? -v : v;
    }
    return s;
}

}  // namespace

extern "C" {

size_t png_max_size(int h, int w) {
    size_t raw = size_t(h) * (size_t(w) * 3 + 1);
    return compressBound(raw) + 1024;
}

int png_encode_rgb8(const uint8_t* rgb, int h, int w, int stride,
                    int compress_level, uint8_t* out, size_t out_cap) {
    if (h <= 0 || w <= 0 || !rgb || !out) return -1;
    const size_t row_bytes = size_t(w) * 3;
    const size_t raw_size = size_t(h) * (row_bytes + 1);

    // Filtered image: per row choose None / Sub / Up by residual cost.
    std::vector<uint8_t> raw(raw_size);
    std::vector<uint8_t> sub(row_bytes), up(row_bytes);
    const uint8_t* prev = nullptr;
    size_t off = 0;
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = rgb + size_t(y) * stride;
        for (size_t i = 0; i < row_bytes; ++i)
            sub[i] = uint8_t(row[i] - (i >= 3 ? row[i - 3] : 0));
        uint64_t c_none = residual_cost(row, row_bytes);
        uint64_t c_sub = residual_cost(sub.data(), row_bytes);
        uint64_t c_up = UINT64_MAX;
        if (prev) {
            for (size_t i = 0; i < row_bytes; ++i)
                up[i] = uint8_t(row[i] - prev[i]);
            c_up = residual_cost(up.data(), row_bytes);
        }
        if (c_sub <= c_none && c_sub <= c_up) {
            raw[off++] = 1;
            std::memcpy(&raw[off], sub.data(), row_bytes);
        } else if (prev && c_up <= c_none) {
            raw[off++] = 2;
            std::memcpy(&raw[off], up.data(), row_bytes);
        } else {
            raw[off++] = 0;
            std::memcpy(&raw[off], row, row_bytes);
        }
        off += row_bytes;
        prev = row;
    }

    // zlib-compress the filtered stream.
    uLongf comp_cap = compressBound(raw_size);
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), raw_size,
                  compress_level) != Z_OK)
        return -1;

    // Assemble: signature, IHDR, IDAT, IEND.
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                   '\n'};
    size_t need = 8 + 12 + 13 + 12 + comp_cap + 12;
    if (need > out_cap) return -1;

    uint8_t* p = out;
    std::memcpy(p, sig, 8);
    p += 8;
    uint8_t ihdr[13];
    put_be32(ihdr, uint32_t(w));
    put_be32(ihdr + 4, uint32_t(h));
    ihdr[8] = 8;    // bit depth
    ihdr[9] = 2;    // color type: truecolor RGB
    ihdr[10] = 0;   // compression
    ihdr[11] = 0;   // filter method
    ihdr[12] = 0;   // no interlace
    p += write_chunk(p, "IHDR", ihdr, 13);
    p += write_chunk(p, "IDAT", comp.data(), uint32_t(comp_cap));
    p += write_chunk(p, "IEND", nullptr, 0);
    return int(p - out);
}

}  // extern "C"
