// Native video tier: MJPEG-in-AVI encoder (no external dependencies).
//
// The reference pipes PNG frames through ffmpeg to get a video artifact.
// Where ffmpeg is missing, the port carries its own encoder: a baseline
// sequential JPEG (4:2:0, ITU-T T.81 Annex K quantization tables scaled by
// quality, the standard Huffman tables) wrapped in a RIFF AVI container with
// the MJPG fourcc + idx1 index.  Plays in VLC/mpv/browsers' <video> via
// conversion, and every frame is a standalone JFIF.  The same source as
// gsmpm_tpu's csrc/gsmpm_video.cpp; only these comments differ.
//
// Streaming API (ctypes-consumed from gsmpm_tpu_torch/io/_native.py):
//   void* gsn_avi_begin(const char* path, int w, int h, int fps)
//   int   gsn_avi_add_frame(void* ctx, const unsigned char* rgb, int quality)
//   int   gsn_avi_end(void* ctx)   // writes headers/index, frees ctx
//
// Compiled with gsmpm_native.cpp into one library by
// gsmpm_tpu_torch/utils/build.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- JPEG ----

// ITU-T T.81 Annex K.1 quantization tables (natural order)
const int kQLum[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kQChr[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Standard Huffman tables (T.81 Annex K.3): bits[1..16] counts + values
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
    uint16_t code[256];
    uint8_t len[256];
};

void build_huff(const uint8_t* bits, const uint8_t* vals, HuffCode* h) {
    std::memset(h->len, 0, sizeof(h->len));
    uint16_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l]; ++i) {
            h->code[vals[k]] = code++;
            h->len[vals[k]] = (uint8_t)l;
            ++k;
        }
        code <<= 1;
    }
}

struct BitWriter {
    std::vector<uint8_t>* out;
    uint32_t acc = 0;
    int nbits = 0;
    void put(uint16_t code, int len) {
        acc = (acc << len) | (code & ((1u << len) - 1));
        nbits += len;
        while (nbits >= 8) {
            uint8_t b = (uint8_t)(acc >> (nbits - 8));
            out->push_back(b);
            if (b == 0xFF) out->push_back(0x00);  // byte stuffing
            nbits -= 8;
        }
    }
    void flush() {
        if (nbits > 0) put((uint16_t)((1 << (8 - nbits)) - 1), 8 - nbits);
    }
};

// AAN-free plain separable DCT-II (8x8); fast enough for frame export.
void fdct8x8(float* b) {
    static float c[8][8];
    static bool init = false;
    if (!init) {
        for (int u = 0; u < 8; ++u)
            for (int x = 0; x < 8; ++x)
                c[u][x] = (float)(std::cos((2 * x + 1) * u * M_PI / 16.0) *
                                  (u == 0 ? std::sqrt(0.125) : 0.5));
        init = true;
    }
    float t[64];
    for (int u = 0; u < 8; ++u)
        for (int x = 0; x < 8; ++x) {
            float s = 0;
            for (int k = 0; k < 8; ++k) s += c[u][k] * b[x * 8 + k];
            t[x * 8 + u] = s;
        }
    for (int v = 0; v < 8; ++v)
        for (int u = 0; u < 8; ++u) {
            float s = 0;
            for (int k = 0; k < 8; ++k) s += c[v][k] * t[k * 8 + u];
            b[v * 8 + u] = s;
        }
}

int bit_length(int v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

void encode_block(const float* blk, const int* qtab, int* prev_dc,
                  const HuffCode& dc, const HuffCode& ac, BitWriter* bw) {
    float b[64];
    std::memcpy(b, blk, sizeof(b));
    fdct8x8(b);
    int q[64];
    for (int i = 0; i < 64; ++i) {
        float v = b[kZigzag[i]] / (float)qtab[kZigzag[i]];
        int qi = (int)std::lround(v);
        // baseline AC Huffman symbols cap at size 10 (|coef| <= 1023); at
        // quality 100 (qtab entry 1) a full-scale DCT coef can hit 1024
        q[i] = qi < -1023 ? -1023 : (qi > 1023 ? 1023 : qi);
    }
    int diff = q[0] - *prev_dc;
    *prev_dc = q[0];
    int mag = diff < 0 ? -diff : diff;
    int nb = bit_length(mag);
    bw->put(dc.code[nb], dc.len[nb]);
    if (nb) bw->put((uint16_t)(diff < 0 ? diff + (1 << nb) - 1 : diff), nb);
    int run = 0;
    for (int i = 1; i < 64; ++i) {
        if (q[i] == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw->put(ac.code[0xF0], ac.len[0xF0]);  // ZRL
            run -= 16;
        }
        int m = q[i] < 0 ? -q[i] : q[i];
        int s = bit_length(m);
        int sym = (run << 4) | s;
        bw->put(ac.code[sym], ac.len[sym]);
        bw->put((uint16_t)(q[i] < 0 ? q[i] + (1 << s) - 1 : q[i]), s);
        run = 0;
    }
    if (run) bw->put(ac.code[0x00], ac.len[0x00]);  // EOB
}

void put16(std::vector<uint8_t>* v, uint16_t x) {
    v->push_back((uint8_t)(x >> 8));
    v->push_back((uint8_t)(x & 0xFF));
}

void scale_qtab(const int* base, int quality, int* out) {
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int s = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    for (int i = 0; i < 64; ++i) {
        int v = (base[i] * s + 50) / 100;
        out[i] = v < 1 ? 1 : (v > 255 ? 255 : v);
    }
}

// Encode one RGB frame (h, w, 3) as baseline JFIF 4:2:0 into `out`.
void encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                 std::vector<uint8_t>* out) {
    int qlum[64], qchr[64];
    scale_qtab(kQLum, quality, qlum);
    scale_qtab(kQChr, quality, qchr);
    HuffCode dcl, acl, dcc, acc;
    build_huff(kDcLumBits, kDcLumVals, &dcl);
    build_huff(kAcLumBits, kAcLumVals, &acl);
    build_huff(kDcChrBits, kDcChrVals, &dcc);
    build_huff(kAcChrBits, kAcChrVals, &acc);

    out->clear();
    // SOI + JFIF APP0
    const uint8_t app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                            'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                            0x00, 0x01, 0x00, 0x00};
    out->insert(out->end(), app0, app0 + sizeof(app0));
    // DQT x2
    for (int t = 0; t < 2; ++t) {
        out->push_back(0xFF);
        out->push_back(0xDB);
        put16(out, 67);
        out->push_back((uint8_t)t);
        const int* q = t == 0 ? qlum : qchr;
        for (int i = 0; i < 64; ++i) out->push_back((uint8_t)q[kZigzag[i]]);
    }
    // SOF0: 4:2:0 (Y 2x2, Cb 1x1, Cr 1x1)
    out->push_back(0xFF);
    out->push_back(0xC0);
    put16(out, 17);
    out->push_back(8);
    put16(out, (uint16_t)h);
    put16(out, (uint16_t)w);
    out->push_back(3);
    const uint8_t sof[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    out->insert(out->end(), sof, sof + sizeof(sof));
    // DHT x4
    struct {
        uint8_t cls_id;
        const uint8_t* bits;
        const uint8_t* vals;
        int nvals;
    } hts[4] = {{0x00, kDcLumBits, kDcLumVals, 12},
                {0x10, kAcLumBits, kAcLumVals, 162},
                {0x01, kDcChrBits, kDcChrVals, 12},
                {0x11, kAcChrBits, kAcChrVals, 162}};
    for (auto& t : hts) {
        out->push_back(0xFF);
        out->push_back(0xC4);
        put16(out, (uint16_t)(19 + t.nvals));
        out->push_back(t.cls_id);
        for (int l = 1; l <= 16; ++l) out->push_back(t.bits[l]);
        out->insert(out->end(), t.vals, t.vals + t.nvals);
    }
    // SOS
    const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00,
                           0x02, 0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
    out->insert(out->end(), sos, sos + sizeof(sos));

    BitWriter bw{out};
    int dcY = 0, dcCb = 0, dcCr = 0;
    int mbw = (w + 15) / 16, mbh = (h + 15) / 16;
    float Y[16 * 16], Cb[8 * 8], Cr[8 * 8];
    for (int my = 0; my < mbh; ++my) {
        for (int mx = 0; mx < mbw; ++mx) {
            // gather 16x16 RGB -> YCbCr, box-subsample chroma
            for (int cy = 0; cy < 8; ++cy)
                for (int cx = 0; cx < 8; ++cx) {
                    float sb = 0, sr = 0;
                    for (int dy = 0; dy < 2; ++dy)
                        for (int dx = 0; dx < 2; ++dx) {
                            int py = my * 16 + cy * 2 + dy;
                            int px = mx * 16 + cx * 2 + dx;
                            if (py >= h) py = h - 1;
                            if (px >= w) px = w - 1;
                            const uint8_t* p = rgb + (py * (long long)w + px) * 3;
                            float r = p[0], g = p[1], b = p[2];
                            float y = 0.299f * r + 0.587f * g + 0.114f * b;
                            Y[(cy * 2 + dy) * 16 + cx * 2 + dx] = y - 128.0f;
                            sb += -0.168736f * r - 0.331264f * g + 0.5f * b;
                            sr += 0.5f * r - 0.418688f * g - 0.081312f * b;
                        }
                    Cb[cy * 8 + cx] = sb * 0.25f;
                    Cr[cy * 8 + cx] = sr * 0.25f;
                }
            // 4 Y blocks then Cb, Cr
            for (int by = 0; by < 2; ++by)
                for (int bx = 0; bx < 2; ++bx) {
                    float blk[64];
                    for (int yy = 0; yy < 8; ++yy)
                        for (int xx = 0; xx < 8; ++xx)
                            blk[yy * 8 + xx] = Y[(by * 8 + yy) * 16 + bx * 8 + xx];
                    encode_block(blk, qlum, &dcY, dcl, acl, &bw);
                }
            encode_block(Cb, qchr, &dcCb, dcc, acc, &bw);
            encode_block(Cr, qchr, &dcCr, dcc, acc, &bw);
        }
    }
    bw.flush();
    out->push_back(0xFF);
    out->push_back(0xD9);  // EOI
}

// ----------------------------------------------------------------- AVI ----

struct AviCtx {
    FILE* f = nullptr;
    int w = 0, h = 0, fps = 25;
    long long movi_start = 0;
    std::vector<uint32_t> sizes;  // per-frame chunk payload sizes
};

void w32(FILE* f, uint32_t v) { fwrite(&v, 4, 1, f); }
void wtag(FILE* f, const char* t) { fwrite(t, 4, 1, f); }

void write_avi_headers(AviCtx* c, bool placeholder) {
    FILE* f = c->f;
    uint32_t nframes = (uint32_t)c->sizes.size();
    uint32_t maxsz = 0;
    uint64_t movisz = 4;  // 'movi'
    for (uint32_t s : c->sizes) {
        if (s > maxsz) maxsz = s;
        movisz += 8 + s + (s & 1);
    }
    uint32_t idxsz = nframes * 16;
    // riff size = everything after RIFF+size
    uint32_t riffsz = (uint32_t)(4 + (8 + 4 + 64 + 8 + 4 + 64 + 48) + 8 +
                                 movisz + 8 + idxsz);
    std::fseek(f, 0, SEEK_SET);
    wtag(f, "RIFF");
    w32(f, placeholder ? 0 : riffsz);
    wtag(f, "AVI ");
    // hdrl list
    wtag(f, "LIST");
    w32(f, 4 + 64 + 8 + 4 + 64 + 48);
    wtag(f, "hdrl");
    wtag(f, "avih");
    w32(f, 56);
    w32(f, 1000000u / (c->fps ? c->fps : 25));  // us per frame
    w32(f, 0);                                  // max bytes/sec
    w32(f, 0);
    w32(f, 0x10);  // AVIF_HASINDEX
    w32(f, nframes);
    w32(f, 0);
    w32(f, 1);  // streams
    w32(f, maxsz);
    w32(f, (uint32_t)c->w);
    w32(f, (uint32_t)c->h);
    w32(f, 0);
    w32(f, 0);
    w32(f, 0);
    w32(f, 0);
    // strl list
    wtag(f, "LIST");
    w32(f, 4 + 64 + 48);
    wtag(f, "strl");
    wtag(f, "strh");
    w32(f, 56);
    wtag(f, "vids");
    wtag(f, "MJPG");
    w32(f, 0);
    w32(f, 0);
    w32(f, 0);
    w32(f, 1);            // scale
    w32(f, (uint32_t)c->fps);  // rate
    w32(f, 0);
    w32(f, nframes);
    w32(f, maxsz);
    w32(f, 0xFFFFFFFFu);  // quality
    w32(f, 0);            // samplesize
    fwrite("\0\0\0\0", 1, 4, f);  // rcFrame left, top
    uint16_t wh[2] = {(uint16_t)c->w, (uint16_t)c->h};
    fwrite(wh, 2, 2, f);  // rcFrame right, bottom
    wtag(f, "strf");
    w32(f, 40);  // BITMAPINFOHEADER
    w32(f, 40);
    w32(f, (uint32_t)c->w);
    w32(f, (uint32_t)c->h);
    uint16_t planes_bpp[2] = {1, 24};
    fwrite(planes_bpp, 2, 2, f);
    wtag(f, "MJPG");
    w32(f, (uint32_t)(c->w * c->h * 3));
    w32(f, 0);
    w32(f, 0);
    w32(f, 0);
    w32(f, 0);
    // movi list header
    wtag(f, "LIST");
    w32(f, placeholder ? 0 : (uint32_t)movisz);
    wtag(f, "movi");
}

}  // namespace

extern "C" {

void* gsn_avi_begin(const char* path, int w, int h, int fps) {
    if (w <= 0 || h <= 0 || w > 0xFFFF || h > 0xFFFF) return nullptr;
    FILE* f = std::fopen(path, "wb");
    if (!f) return nullptr;
    AviCtx* c = new AviCtx;
    c->f = f;
    c->w = w;
    c->h = h;
    c->fps = fps > 0 ? fps : 25;
    write_avi_headers(c, /*placeholder=*/true);
    c->movi_start = std::ftell(f);
    return c;
}

int gsn_avi_add_frame(void* ctx, const unsigned char* rgb, int quality) {
    AviCtx* c = (AviCtx*)ctx;
    if (!c || !c->f) return -1;
    std::vector<uint8_t> jpg;
    encode_jpeg(rgb, c->w, c->h, quality, &jpg);
    wtag(c->f, "00dc");
    w32(c->f, (uint32_t)jpg.size());
    if (!jpg.empty()) fwrite(jpg.data(), 1, jpg.size(), c->f);
    if (jpg.size() & 1) fputc(0, c->f);  // RIFF word alignment
    c->sizes.push_back((uint32_t)jpg.size());
    return 0;
}

int gsn_avi_end(void* ctx) {
    AviCtx* c = (AviCtx*)ctx;
    if (!c) return -1;
    FILE* f = c->f;
    // idx1
    wtag(f, "idx1");
    w32(f, (uint32_t)(c->sizes.size() * 16));
    uint32_t off = 4;  // offsets are relative to 'movi' tag start + 4
    for (uint32_t s : c->sizes) {
        wtag(f, "00dc");
        w32(f, 0x10);  // AVIIF_KEYFRAME
        w32(f, off);
        w32(f, s);
        off += 8 + s + (s & 1);
    }
    write_avi_headers(c, /*placeholder=*/false);
    std::fclose(f);
    delete c;
    return 0;
}

}  // extern "C"
