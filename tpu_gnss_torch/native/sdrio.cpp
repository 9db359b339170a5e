// Copied from tpu_gnss/native/sdrio.cpp:1-258 (the whole file).
// tpu_gnss native host-side sample ingest.
//
// TPU-native equivalent of the reference's native sample frontends: the
// bit-packed file reader + unpacker (reference: c/search_offline.cpp:121-157)
// and the int8 I/Q deinterleavers used by the conversion tools
// (reference: c/conv_1bit_bin_to_hackrf_bin.cpp).  The device does all the
// math; this library only turns packed capture bytes into dense arrays at
// memory-bandwidth speed so host ingest never gates the TPU.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

// 256 x 8 LSB-first unpack table, built once.
struct UnpackTable {
    uint8_t t[256][8];
    UnpackTable() {
        for (int b = 0; b < 256; b++)
            for (int k = 0; k < 8; k++)
                t[b][k] = (b >> k) & 1;
    }
};
const UnpackTable kUnpack;

struct BipolarTable {
    int8_t t[256][8];
    BipolarTable() {
        for (int b = 0; b < 256; b++)
            for (int k = 0; k < 8; k++)
                t[b][k] = ((b >> k) & 1) ? -1 : 1;
    }
};
const BipolarTable kBipolar;

}  // namespace

extern "C" {

// Unpack n_bytes LSB-first packed bits -> {0,1} bytes. out has 8*n_bytes.
void sdrio_unpack_1bit(const uint8_t* in, int64_t n_bytes, uint8_t* out) {
    for (int64_t i = 0; i < n_bytes; i++)
        std::memcpy(out + 8 * i, kUnpack.t[in[i]], 8);
}

// Unpack to bipolar int8: bit 1 -> -1, bit 0 -> +1 (reference Bipolar()).
void sdrio_unpack_1bit_bipolar(const uint8_t* in, int64_t n_bytes, int8_t* out) {
    for (int64_t i = 0; i < n_bytes; i++)
        std::memcpy(out + 8 * i, kBipolar.t[in[i]], 8);
}

// Fused unpack + quadrature square-wave mix to planar int8 I/Q.
// lo_i/lo_q are 4-entry {0,1} tables; the LO phase index follows the exact
// ramp floor((i*lo_num/lo_den) mod 4), the precise-arithmetic form of the
// reference's float NCO (reference: c/search_offline.cpp:127,155-156).
// n_samples = 8*n_bytes outputs are written to out_i / out_q.
void sdrio_unpack_mix_1bit(const uint8_t* in, int64_t n_bytes,
                           const uint8_t* lo_i, const uint8_t* lo_q,
                           double lo_rate, int8_t* out_i, int8_t* out_q) {
    double phase = 0.0;
    int64_t n = 0;
    for (int64_t i = 0; i < n_bytes; i++) {
        int byte = in[i];
        for (int k = 0; k < 8; k++, n++) {
            int bit = (byte >> k) & 1;
            // Recompute phase index from the exact ramp to avoid float drift.
            int p = (int)phase;
            out_i[n] = (bit ^ lo_i[p]) ? -1 : 1;
            out_q[n] = (bit ^ lo_q[p]) ? -1 : 1;
            phase += lo_rate;
            if (phase >= 4.0) phase -= 4.0;
        }
    }
}

// Deinterleave signed int8 I/Q into planar float32 (HackRF format).
void sdrio_deinterleave_int8(const int8_t* in, int64_t n_pairs,
                             float* out_i, float* out_q) {
    for (int64_t i = 0; i < n_pairs; i++) {
        out_i[i] = (float)in[2 * i];
        out_q[i] = (float)in[2 * i + 1];
    }
}

// Deinterleave unsigned uint8 I/Q, centering at 128 (rtl-sdr format).
void sdrio_deinterleave_uint8(const uint8_t* in, int64_t n_pairs,
                              float* out_i, float* out_q) {
    for (int64_t i = 0; i < n_pairs; i++) {
        out_i[i] = (float)in[2 * i] - 128.0f;
        out_q[i] = (float)in[2 * i + 1] - 128.0f;
    }
}

// Pack {0,1} samples into LSB-first bytes (MATLAB 'ubit1' writer analog).
void sdrio_pack_1bit(const uint8_t* in, int64_t n_samples, uint8_t* out) {
    int64_t n_bytes = n_samples / 8;
    for (int64_t i = 0; i < n_bytes; i++) {
        int b = 0;
        for (int k = 0; k < 8; k++) b |= (in[8 * i + k] & 1) << k;
        out[i] = (uint8_t)b;
    }
    int rem = (int)(n_samples - 8 * n_bytes);
    if (rem) {
        int b = 0;
        for (int k = 0; k < rem; k++) b |= (in[8 * n_bytes + k] & 1) << k;
        out[n_bytes] = (uint8_t)b;
    }
}

// Streamed 1-bit capture -> interleaved int8 I/Q file conversion with the
// exact fs/4 quadrature LO patterns [1,0,-1,0] / [0,1,0,-1] — the native
// converter tool (reference: c/conv_1bit_bin_to_hackrf_bin.cpp and
// gps_bin1bit_log2bin.m:21-33), file-to-file in bounded memory.
// Returns samples converted, or -1 on I/O error.
#include <cstdio>

int64_t sdrio_convert_1bit_to_iq8(const char* in_path, const char* out_path,
                                  int gain) {
    const int64_t BLOCK = 1 << 20;  // bytes per read (8 Mbit)
    FILE* fin = std::fopen(in_path, "rb");
    if (!fin) return -1;
    FILE* fout = std::fopen(out_path, "wb");
    if (!fout) { std::fclose(fin); return -1; }

    static uint8_t inbuf[1 << 20];
    // 2 bytes I/Q out per input bit
    static int8_t outbuf[2 * 8 * (1 << 20)];
    const int8_t lo_i[4] = {1, 0, -1, 0};
    const int8_t lo_q[4] = {0, 1, 0, -1};
    int8_t g = (int8_t)(gain > 127 ? 127 : gain);
    int64_t total = 0;
    int phase = 0;  // samples mod 4, carried across blocks
    for (;;) {
        size_t nb = std::fread(inbuf, 1, BLOCK, fin);
        if (nb == 0) break;
        int64_t m = 0;
        for (size_t i = 0; i < nb; i++) {
            int byte = inbuf[i];
            for (int k = 0; k < 8; k++) {
                int8_t s = ((byte >> k) & 1) ? (int8_t)-1 : (int8_t)1;
                outbuf[m++] = (int8_t)(s * lo_i[phase] * g);
                outbuf[m++] = (int8_t)(s * lo_q[phase] * g);
                phase = (phase + 1) & 3;
            }
        }
        if (std::fwrite(outbuf, 1, (size_t)m, fout) != (size_t)m) {
            std::fclose(fin); std::fclose(fout); return -1;
        }
        total += m / 2;
    }
    std::fclose(fin);
    std::fclose(fout);
    return total;
}

// Streamed SDR capture -> 1-bit IF file conversion: the native analog of
// the MATLAB ingest scripts (reference: proc_rtl_bin_for_gps.m,
// proc_hackrf_bin_for_gps.m): center the interleaved I/Q rails, remove
// the capture-wide DC offset (two passes over the file, bounded memory),
// optionally digitally up-mix by e^{+j2πfc n/fs}, take the real part,
// hard-limit (negative -> bit 1) and pack LSB-first.
//
//   is_signed : 1 = int8 pairs (HackRF), 0 = uint8 pairs - 128 (rtl-sdr)
//   remove_dc : 1 = subtract the file-wide I/Q means (first pass)
//   mix       : 1 = multiply by e^{+j2π fc_over_fs n} before Re{}
// Returns samples written, or -1 on I/O error.
#include <cmath>

int64_t sdrio_convert_iq_to_1bit(const char* in_path, const char* out_path,
                                 int is_signed, int remove_dc, int mix,
                                 double fc_over_fs) {
    const int64_t BLOCK = 1 << 20;  // bytes per read (524288 I/Q pairs)
    static uint8_t inbuf[1 << 20];
    static uint8_t outbuf[(1 << 20) / 16 + 1];
    const double center = is_signed ? 0.0 : 128.0;

    double mean_i = 0.0, mean_q = 0.0;
    if (remove_dc) {
        FILE* f = std::fopen(in_path, "rb");
        if (!f) return -1;
        double sum_i = 0.0, sum_q = 0.0;
        int64_t n_pairs = 0;
        for (;;) {
            size_t nb = std::fread(inbuf, 1, BLOCK, f);
            if (nb < 2) break;
            size_t pairs = nb / 2;
            for (size_t i = 0; i < pairs; i++) {
                double vi = is_signed ? (double)(int8_t)inbuf[2 * i]
                                      : (double)inbuf[2 * i] - center;
                double vq = is_signed ? (double)(int8_t)inbuf[2 * i + 1]
                                      : (double)inbuf[2 * i + 1] - center;
                sum_i += vi;
                sum_q += vq;
            }
            n_pairs += (int64_t)pairs;
            if (nb < (size_t)BLOCK) break;
        }
        std::fclose(f);
        if (n_pairs) { mean_i = sum_i / n_pairs; mean_q = sum_q / n_pairs; }
    }

    FILE* fin = std::fopen(in_path, "rb");
    if (!fin) return -1;
    FILE* fout = std::fopen(out_path, "wb");
    if (!fout) { std::fclose(fin); return -1; }

    const double two_pi = 6.283185307179586476925286766559;
    double theta = 0.0;
    const double dtheta = two_pi * fc_over_fs;
    int64_t total = 0;
    int bitpos = 0;
    int acc = 0;
    for (;;) {
        size_t nb = std::fread(inbuf, 1, BLOCK, fin);
        if (nb < 2) break;
        size_t pairs = nb / 2;
        int64_t m = 0;
        for (size_t i = 0; i < pairs; i++) {
            double vi = (is_signed ? (double)(int8_t)inbuf[2 * i]
                                   : (double)inbuf[2 * i] - center) - mean_i;
            double v;
            if (mix) {
                double vq = (is_signed ? (double)(int8_t)inbuf[2 * i + 1]
                                       : (double)inbuf[2 * i + 1] - center)
                            - mean_q;
                v = vi * std::cos(theta) - vq * std::sin(theta);
                theta += dtheta;
                if (theta >= two_pi) theta -= two_pi;
            } else {
                v = vi;
            }
            acc |= (v < 0.0) << bitpos;
            if (++bitpos == 8) {
                outbuf[m++] = (uint8_t)acc;
                acc = 0;
                bitpos = 0;
            }
            total++;
        }
        if (m && std::fwrite(outbuf, 1, (size_t)m, fout) != (size_t)m) {
            std::fclose(fin); std::fclose(fout); return -1;
        }
        if (nb < (size_t)BLOCK) break;
    }
    if (bitpos) {
        uint8_t last = (uint8_t)acc;
        if (std::fwrite(&last, 1, 1, fout) != 1) {
            std::fclose(fin); std::fclose(fout); return -1;
        }
    }
    std::fclose(fin);
    std::fclose(fout);
    return total;
}

}  // extern "C"
