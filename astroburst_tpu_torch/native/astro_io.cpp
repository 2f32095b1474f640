// The port's host FITS codec: big-endian BITPIX {8, 16, 32, -32, -64}
// decoded to float32 with BSCALE/BZERO, and float32 encoded to
// big-endian -32 or 16 in chunks written straight to a file descriptor.
// OpenMP loops, a plain C ABI bound with ctypes
// (astroburst_tpu_torch/native/__init__.py, which builds this file with
// g++ at first use). Reference: src-tauri/src/infra/fits/reader.rs:42-101
// (decode_pixels) and writer.rs:100-119 (the big-endian encoders).
//
// The port's own copy of the JAX package's astroburst_tpu/native/
// astro_io.cpp, with five changes that make every result the bits of
// the plain numpy versions (io/fits_reader.py:decode_pixels_plain,
// io/fits_writer.py:_encode_plane):
//   a. built with -ffp-contract=off: raw * bscale + bzero is a multiply
//      and then an add, never one fused multiply-add (which keeps a
//      residue where the two terms cancel);
//   b. the multiply is skipped when bscale is 1 and the add when bzero
//      is 0, as numpy does: -0.0 + 0.0 would be +0.0;
//   c. the 16-bit encode divides by bscale (a product with 1/bscale
//      differs by an ulp before rounding);
//   d. NaN encodes to 0 at BITPIX 16 (casting NaN to an integer is
//      undefined; a vectorised pack gives -32768);
//   e. the thread count is an argument of every call.
// It leaves out the JAX copy's buffer encoders (astro_encode_be_f32,
// astro_encode_be_i16) and its masked scan, which nothing in the port
// calls: the writer encodes through astro_encode_be_to_fd.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstring>

#include <unistd.h>

namespace {

// unaligned word load + bswap intrinsic: GCC vectorizes these loops
// (VPSHUFB on x86) where the shift-or byte form stays scalar
inline uint16_t load_be16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return __builtin_bswap16(v);
}

inline uint32_t load_be32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return __builtin_bswap32(v);
}

inline uint64_t load_be64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return __builtin_bswap64(v);
}

// pixel i of a big-endian BITPIX array, exactly, in f64
template <int kBitpix>
inline double load_pixel(const uint8_t* src, int64_t i) {
    if constexpr (kBitpix == 8) {
        return static_cast<double>(src[i]);
    } else if constexpr (kBitpix == 16) {
        return static_cast<int16_t>(load_be16(src + 2 * i));
    } else if constexpr (kBitpix == 32) {
        return static_cast<int32_t>(load_be32(src + 4 * i));
    } else if constexpr (kBitpix == -32) {
        uint32_t bits = load_be32(src + 4 * i);
        float f;
        std::memcpy(&f, &bits, 4);
        return f;
    } else {
        uint64_t bits = load_be64(src + 8 * i);
        double d;
        std::memcpy(&d, &bits, 8);
        return d;
    }
}

template <int kBitpix, bool kMul, bool kAdd>
void decode(const uint8_t* src, float* dst, int64_t n, double bscale,
            double bzero, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
    for (int64_t i = 0; i < n; ++i) {
        double v = load_pixel<kBitpix>(src, i);
        if constexpr (kMul) v *= bscale;
        if constexpr (kAdd) v += bzero;
        dst[i] = static_cast<float>(v);
    }
}

template <int kBitpix>
void decode_scaled(const uint8_t* src, float* dst, int64_t n, double bscale,
                   double bzero, int threads) {
    const bool mul = bscale != 1.0;
    const bool add = bzero != 0.0;
    if (mul && add) {
        decode<kBitpix, true, true>(src, dst, n, bscale, bzero, threads);
    } else if (mul) {
        decode<kBitpix, true, false>(src, dst, n, bscale, bzero, threads);
    } else if (add) {
        decode<kBitpix, false, true>(src, dst, n, bscale, bzero, threads);
    } else {
        decode<kBitpix, false, false>(src, dst, n, bscale, bzero, threads);
    }
}

// BITPIX -32 at identity scaling: the bits byte-swapped, NaN payloads
// and signed zeros kept
void copy_be32(const uint8_t* src, float* dst, int64_t n, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits = load_be32(src + 4 * i);
        std::memcpy(&dst[i], &bits, 4);
    }
}

inline void store_be_f32(const float* src, uint8_t* dst) {
    uint32_t bits;
    std::memcpy(&bits, src, 4);
    bits = __builtin_bswap32(bits);
    std::memcpy(dst, &bits, 4);
}

// (v - bzero) / bscale clamped to [-32768, 32767] and rounded half away
// from zero (Rust's f64::round, writer.rs:100-119); NaN → 0
inline void store_be_i16(const float* src, uint8_t* dst, double bzero,
                         double bscale) {
    double physical = (static_cast<double>(*src) - bzero) / bscale;
    int16_t v = 0;
    if (physical == physical) {
        if (physical > 32767.0) physical = 32767.0;
        if (physical < -32768.0) physical = -32768.0;
        v = static_cast<int16_t>(physical >= 0.0 ? physical + 0.5
                                                 : physical - 0.5);
    }
    uint16_t bits = __builtin_bswap16(static_cast<uint16_t>(v));
    std::memcpy(dst, &bits, 2);
}

}  // namespace

extern "C" {

// Decode n big-endian pixels of the given BITPIX into float32:
// raw * bscale (when bscale != 1) + bzero (when bzero != 0) in f64,
// rounded once to f32. Returns 0, or -1 for an unsupported BITPIX.
int astro_decode_pixels(const uint8_t* src, float* dst, int64_t n,
                        int bitpix, double bscale, double bzero,
                        int threads) {
    switch (bitpix) {
        case 8:
            decode_scaled<8>(src, dst, n, bscale, bzero, threads);
            return 0;
        case 16:
            decode_scaled<16>(src, dst, n, bscale, bzero, threads);
            return 0;
        case 32:
            decode_scaled<32>(src, dst, n, bscale, bzero, threads);
            return 0;
        case -32:
            if (bscale == 1.0 && bzero == 0.0) {
                copy_be32(src, dst, n, threads);
            } else {
                decode_scaled<-32>(src, dst, n, bscale, bzero, threads);
            }
            return 0;
        case -64:
            decode_scaled<-64>(src, dst, n, bscale, bzero, threads);
            return 0;
        default:
            return -1;
    }
}

// Encode float32 → big-endian BITPIX 16 or -32 and write() it to an
// open fd in cache-resident chunks: the source crosses DRAM once and the
// bounce buffer stays in L2, where an encode into a full-size buffer and
// then f.write() reads the whole payload a third time. Returns 0, -1 for
// an unsupported BITPIX, or the errno of the failed write (EIO when
// write() wrote nothing).
int astro_encode_be_to_fd(const float* src, int64_t n, int bitpix,
                          double bzero, double bscale, int fd,
                          int threads) {
    constexpr int64_t kChunkBytes = 4 << 20;
    static thread_local uint8_t tls_buf[kChunkBytes];
    uint8_t* const buf = tls_buf;  // resolve TLS once, OUTSIDE the omp
                                   // regions (workers would otherwise
                                   // write their own copies)
    if (bitpix != 16 && bitpix != -32) return -1;
    const int bpp = bitpix == 16 ? 2 : 4;
    const int64_t per_chunk = kChunkBytes / bpp;
    for (int64_t start = 0; start < n; start += per_chunk) {
        const int64_t cnt = n - start < per_chunk ? n - start : per_chunk;
        if (bitpix == -32) {
#pragma omp parallel for schedule(static) num_threads(threads)
            for (int64_t i = 0; i < cnt; ++i) {
                store_be_f32(src + start + i, buf + 4 * i);
            }
        } else {
#pragma omp parallel for schedule(static) num_threads(threads)
            for (int64_t i = 0; i < cnt; ++i) {
                store_be_i16(src + start + i, buf + 2 * i, bzero, bscale);
            }
        }
        int64_t todo = cnt * bpp;
        const uint8_t* p = buf;
        while (todo > 0) {
            ssize_t wrote = write(fd, p, static_cast<size_t>(todo));
            if (wrote < 0 && errno == EINTR) continue;
            if (wrote < 0) return errno;
            if (wrote == 0) return EIO;
            todo -= wrote;
            p += wrote;
        }
    }
    return 0;
}

// _OPENMP of the build (0 without OpenMP)
int astro_openmp_version(void) {
#if defined(_OPENMP)
    return _OPENMP;
#else
    return 0;
#endif
}

}  // extern "C"
