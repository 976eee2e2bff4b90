// tcforge_host.cpp — native host-side I/O core for tcforge_tpu.
//
// Native analogue of the reference's C container/runtime layer
// (avilib/, Y4M handling, and the aclib byte-shuffling that feeds the
// pipeline): batched Y4M stream reading/writing, AVI movi scanning, and
// packed<->planar pixel shuffles, all operating on caller-provided
// buffers so the Python layer can hand them straight to jax.device_put.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: make -C native   (produces libtcforge_host.so)

#include <cmath>
#include <cstdint>
#if defined(__SSE2__) || defined(__AVX512F__)
#include <immintrin.h>
#endif
#include <climits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

extern "C" {

// ---------------------------------------------------------------------
// Y4M streaming

struct TCY4MReader {
    FILE *f;
    int width, height;
    int fps_num, fps_den;
    char chroma[32];
    long frame_bytes;        // payload bytes per frame (all planes)
};

// Parse "YUV4MPEG2 W.. H.. F..:.. I. A..:.. C...\n".
static bool parse_y4m_header(TCY4MReader *r, const char *line) {
    if (strncmp(line, "YUV4MPEG2", 9) != 0) return false;
    r->fps_num = 25; r->fps_den = 1;
    strcpy(r->chroma, "420");
    const char *p = line + 9;
    while (*p && *p != '\n') {
        while (*p == ' ') p++;
        if (!*p || *p == '\n') break;
        char tag = *p++;
        char val[64];
        int i = 0;
        while (*p && *p != ' ' && *p != '\n' && i < 63) val[i++] = *p++;
        val[i] = 0;
        switch (tag) {
            case 'W': r->width = atoi(val); break;
            case 'H': r->height = atoi(val); break;
            case 'F': sscanf(val, "%d:%d", &r->fps_num, &r->fps_den); break;
            case 'C': snprintf(r->chroma, sizeof(r->chroma), "%s", val);
                      break;
            default: break;  // I, A, X ignored
        }
    }
    if (r->width <= 0 || r->height <= 0) return false;
    long y = (long)r->width * r->height;
    if (!strncmp(r->chroma, "420", 3))
        r->frame_bytes = y + 2 * ((r->width / 2) * (long)(r->height / 2));
    else if (!strncmp(r->chroma, "422", 3))
        r->frame_bytes = y + 2 * ((r->width / 2) * (long)r->height);
    else if (!strncmp(r->chroma, "444", 3))
        r->frame_bytes = 3 * y;
    else if (!strncmp(r->chroma, "411", 3))
        r->frame_bytes = y + 2 * ((r->width / 4) * (long)r->height);
    else if (!strncmp(r->chroma, "mono", 4))
        r->frame_bytes = y;
    else
        return false;
    return true;
}

TCY4MReader *tc_y4m_open(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return nullptr;
    char line[256];
    if (!fgets(line, sizeof(line), f)) { fclose(f); return nullptr; }
    auto *r = new TCY4MReader();
    r->f = f;
    if (!parse_y4m_header(r, line)) {
        fclose(f);
        delete r;
        return nullptr;
    }
    return r;
}

int tc_y4m_width(TCY4MReader *r)   { return r->width; }
int tc_y4m_height(TCY4MReader *r)  { return r->height; }
int tc_y4m_fps_num(TCY4MReader *r) { return r->fps_num; }
int tc_y4m_fps_den(TCY4MReader *r) { return r->fps_den; }
long tc_y4m_frame_bytes(TCY4MReader *r) { return r->frame_bytes; }
const char *tc_y4m_chroma(TCY4MReader *r) { return r->chroma; }

// Read up to `count` frames into `out` (count * frame_bytes capacity).
// Returns frames read (< count at EOF), or -1 on stream error.
long tc_y4m_read_batch(TCY4MReader *r, uint8_t *out, long count) {
    long n = 0;
    char line[256];
    while (n < count) {
        if (!fgets(line, sizeof(line), r->f)) break;       // EOF
        if (strncmp(line, "FRAME", 5) != 0) return -1;
        size_t got = fread(out + n * r->frame_bytes, 1,
                           (size_t)r->frame_bytes, r->f);
        if (got < (size_t)r->frame_bytes) return -1;        // truncated
        n++;
    }
    return n;
}

void tc_y4m_close(TCY4MReader *r) {
    if (r) { fclose(r->f); delete r; }
}

struct TCY4MWriter { FILE *f; long frame_bytes; };

TCY4MWriter *tc_y4m_create(const char *path, int width, int height,
                           int fps_num, int fps_den, const char *chroma) {
    FILE *f = fopen(path, "wb");
    if (!f) return nullptr;
    fprintf(f, "YUV4MPEG2 W%d H%d F%d:%d Ip C%s\n", width, height,
            fps_num, fps_den, chroma);
    auto *w = new TCY4MWriter();
    w->f = f;
    long y = (long)width * height;
    if (!strncmp(chroma, "420", 3))
        w->frame_bytes = y + 2 * ((width / 2) * (long)(height / 2));
    else if (!strncmp(chroma, "422", 3))
        w->frame_bytes = y + 2 * ((width / 2) * (long)height);
    else if (!strncmp(chroma, "444", 3))
        w->frame_bytes = 3 * y;
    else if (!strncmp(chroma, "mono", 4))
        w->frame_bytes = y;
    else
        w->frame_bytes = y + 2 * ((width / 2) * (long)(height / 2));
    return w;
}

// Write `count` frames from `data` (count * frame_bytes).
long tc_y4m_write_batch(TCY4MWriter *w, const uint8_t *data, long count) {
    for (long n = 0; n < count; n++) {
        if (fwrite("FRAME\n", 1, 6, w->f) != 6) return n;
        if (fwrite(data + n * w->frame_bytes, 1, (size_t)w->frame_bytes,
                   w->f) != (size_t)w->frame_bytes)
            return n;
    }
    return count;
}

void tc_y4m_writer_close(TCY4MWriter *w) {
    if (w) { fclose(w->f); delete w; }
}

// ---------------------------------------------------------------------
// AVI movi scanning (index rebuild fast path; avilib idx semantics)

// Scan movi chunks from `offset`; fill up to `max` entries of
// (chunk_offset, payload_size, stream_kind) triples.  stream_kind:
// 0 = video (00d?), 1..99 = audio track+1 (NNwb).  Returns entries.
long tc_avi_scan_movi(const char *path, long movi_start, long *offsets,
                      long *sizes, int32_t *kinds, long max) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long end = ftell(f);
    fseek(f, movi_start, SEEK_SET);
    long n = 0;
    uint8_t hdr[8];
    long pos = movi_start;
    while (n < max && pos + 8 <= end) {
        if (fread(hdr, 1, 8, f) != 8) break;
        uint32_t size = hdr[4] | (hdr[5] << 8) | (hdr[6] << 16)
                        | ((uint32_t)hdr[7] << 24);
        if (!memcmp(hdr, "idx1", 4) || !memcmp(hdr, "RIFF", 4)) break;
        int kind = -1;
        if (hdr[0] == '0' && hdr[1] == '0' &&
            (hdr[2] == 'd' || hdr[2] == 'w'))
            kind = 0;
        else if (hdr[2] == 'w' && hdr[3] == 'b' &&
                 hdr[0] >= '0' && hdr[0] <= '9' &&
                 hdr[1] >= '0' && hdr[1] <= '9')
            kind = (hdr[0] - '0') * 10 + (hdr[1] - '0');
        if (kind >= 0) {
            offsets[n] = pos + 8;
            sizes[n] = (long)size;
            kinds[n] = kind;
            n++;
        }
        long skip = (long)size + (size & 1);
        pos += 8 + skip;
        if (fseek(f, pos, SEEK_SET) != 0) break;
    }
    fclose(f);
    return n;
}

// ---------------------------------------------------------------------
// Packed <-> planar pixel shuffles (img_yuv_packed.c byte halves)

// YUY2 (Y0 U Y1 V) -> planar 4:2:2
void tc_yuy2_to_planar(const uint8_t *src, uint8_t *y, uint8_t *u,
                       uint8_t *v, long width, long height) {
    long pairs = width / 2;
    for (long row = 0; row < height; row++) {
        const uint8_t *s = src + row * width * 2;
        uint8_t *yr = y + row * width;
        uint8_t *ur = u + row * pairs;
        uint8_t *vr = v + row * pairs;
        for (long i = 0; i < pairs; i++) {
            yr[2 * i]     = s[4 * i];
            ur[i]         = s[4 * i + 1];
            yr[2 * i + 1] = s[4 * i + 2];
            vr[i]         = s[4 * i + 3];
        }
    }
}

void tc_planar_to_yuy2(const uint8_t *y, const uint8_t *u,
                       const uint8_t *v, uint8_t *dst, long width,
                       long height) {
    long pairs = width / 2;
    for (long row = 0; row < height; row++) {
        uint8_t *d = dst + row * width * 2;
        const uint8_t *yr = y + row * width;
        const uint8_t *ur = u + row * pairs;
        const uint8_t *vr = v + row * pairs;
        for (long i = 0; i < pairs; i++) {
            d[4 * i]     = yr[2 * i];
            d[4 * i + 1] = ur[i];
            d[4 * i + 2] = yr[2 * i + 1];
            d[4 * i + 3] = vr[i];
        }
    }
}

// Byte-order shuffle for RGB variants: generic 3/4-channel permute.
void tc_shuffle_channels(const uint8_t *src, uint8_t *dst, long pixels,
                         int channels, const int32_t *perm) {
    for (long i = 0; i < pixels; i++) {
        const uint8_t *s = src + i * channels;
        uint8_t *d = dst + i * channels;
        for (int c = 0; c < channels; c++) d[c] = s[perm[c]];
    }
}

// ---------------------------------------------------------------------
// hqdn3d denoise cascade (the filter_hqdn3d.c:49-120 hot path): three
// integer LUT IIR passes — horizontal, vertical, temporal — fused into
// one sweep per frame.  Bit-identical to the jax lax.scan formulation
// in modules/filters/hqdn3d.py (same int32 arithmetic, same LUTs); this
// is the single-core CPU fast path (the GPU path is the Triton scans).
//
// LowPassMul: curr + coef[(prev - curr + 0x10007FF) >> 12]; the bias
// keeps the index non-negative.  The temporal pass can reach 8192
// (FrameAnt at 0xFFFF over a pixel at or just below 0): that index is
// clamped to 8191, whose coefficient is 0 like the curve's own value
// there (simil clamps to 0 beyond |i| = 4080).

static inline int32_t hq_tidx(int32_t diff) {
    int32_t i = (diff + 0x10007FF) >> 12;
    return i < 8191 ? i : 8191;
}

void tc_hqdn3d_plane(const uint8_t *src, long n, long h, long w,
                     const int32_t *sp, const int32_t *tp,
                     int32_t *ant, uint8_t *out) {
    enum { R = 4 };          // rows interleaved in the horizontal pass:
                             // each row's carry chain is serial, but R
                             // rows are independent — interleaving hides
                             // the sub/shift/load/add latency chain
    int32_t *hband = (int32_t *)malloc(sizeof(int32_t) * w * R);
    int32_t *rowprev = (int32_t *)malloc(sizeof(int32_t) * w);
    for (long f = 0; f < n; f++) {
        const uint8_t *s = src + f * h * w;
        uint8_t *o = out + f * h * w;
        for (long y0 = 0; y0 < h; y0 += R) {
            long rows = (y0 + R <= h) ? R : (h - y0);
            // horizontal IIR for the band (first column passes through)
            if (rows == R) {
                const uint8_t *s0 = s + (y0 + 0) * w;
                const uint8_t *s1 = s + (y0 + 1) * w;
                const uint8_t *s2 = s + (y0 + 2) * w;
                const uint8_t *s3 = s + (y0 + 3) * w;
                int32_t c0 = (int32_t)s0[0] << 16;
                int32_t c1 = (int32_t)s1[0] << 16;
                int32_t c2 = (int32_t)s2[0] << 16;
                int32_t c3 = (int32_t)s3[0] << 16;
                hband[0 * w] = c0;
                hband[1 * w] = c1;
                hband[2 * w] = c2;
                hband[3 * w] = c3;
                for (long x = 1; x < w; x++) {
                    int32_t p0 = (int32_t)s0[x] << 16;
                    int32_t p1 = (int32_t)s1[x] << 16;
                    int32_t p2 = (int32_t)s2[x] << 16;
                    int32_t p3 = (int32_t)s3[x] << 16;
                    c0 = p0 + sp[(c0 - p0 + 0x10007FF) >> 12];
                    c1 = p1 + sp[(c1 - p1 + 0x10007FF) >> 12];
                    c2 = p2 + sp[(c2 - p2 + 0x10007FF) >> 12];
                    c3 = p3 + sp[(c3 - p3 + 0x10007FF) >> 12];
                    hband[0 * w + x] = c0;
                    hband[1 * w + x] = c1;
                    hband[2 * w + x] = c2;
                    hband[3 * w + x] = c3;
                }
            } else {
                for (long r = 0; r < rows; r++) {
                    const uint8_t *sr = s + (y0 + r) * w;
                    int32_t carry = (int32_t)sr[0] << 16;
                    hband[r * w] = carry;
                    for (long x = 1; x < w; x++) {
                        int32_t c = (int32_t)sr[x] << 16;
                        carry = c + sp[(carry - c + 0x10007FF) >> 12];
                        hband[r * w + x] = carry;
                    }
                }
            }
            // vertical IIR (carry = previous output row) + temporal.
            // Column-parallel: AVX-512 gathers for the two LUT reads
            // (16 px per step; integer ops, bit-identical to scalar)
            for (long r = 0; r < rows; r++) {
                long y = y0 + r;
                const int32_t *hrow = hband + r * w;
                int32_t *antr = ant + y * w;
                uint8_t *orow = o + y * w;
                long x = 0;
#if defined(__AVX512F__)
                const __m512i kA = _mm512_set1_epi32(0x10007FF);
                const __m512i kB = _mm512_set1_epi32(0x1000007F);
                const __m512i kC = _mm512_set1_epi32(0x10007FFF);
                const __m512i kM = _mm512_set1_epi32(0xFFFF);
                const __m512i kTop = _mm512_set1_epi32(8191);
                for (; x + 16 <= w; x += 16) {
                    __m512i v;
                    if (y == 0) {
                        v = _mm512_loadu_si512(hrow + x);
                    } else {
                        __m512i c = _mm512_loadu_si512(hrow + x);
                        __m512i rp = _mm512_loadu_si512(rowprev + x);
                        __m512i idx = _mm512_srai_epi32(
                            _mm512_add_epi32(
                                _mm512_sub_epi32(rp, c), kA), 12);
                        __m512i lut = _mm512_i32gather_epi32(
                            idx, sp, 4);
                        v = _mm512_add_epi32(c, lut);
                    }
                    _mm512_storeu_si512(rowprev + x, v);
                    __m512i prev = _mm512_slli_epi32(
                        _mm512_loadu_si512(antr + x), 8);
                    __m512i idx2 = _mm512_min_epi32(_mm512_srai_epi32(
                        _mm512_add_epi32(
                            _mm512_sub_epi32(prev, v), kA), 12), kTop);
                    __m512i dst = _mm512_add_epi32(
                        v, _mm512_i32gather_epi32(idx2, tp, 4));
                    __m512i antv = _mm512_and_si512(
                        _mm512_srai_epi32(
                            _mm512_add_epi32(dst, kB), 8), kM);
                    _mm512_storeu_si512(antr + x, antv);
                    __m512i pix = _mm512_srai_epi32(
                        _mm512_add_epi32(dst, kC), 16);
                    _mm_storeu_si128(
                        (__m128i *)(orow + x),
                        _mm512_cvtepi32_epi8(pix));
                }
#endif
                if (y == 0) {
                    for (; x < w; x++) {
                        int32_t v = hrow[x];
                        rowprev[x] = v;
                        int32_t prev = antr[x] << 8;
                        int32_t dst = v + tp[hq_tidx(prev - v)];
                        antr[x] = ((dst + 0x1000007F) >> 8) & 0xFFFF;
                        orow[x] = (uint8_t)(((dst + 0x10007FFF) >> 16)
                                            & 0xFF);
                    }
                } else {
                    for (; x < w; x++) {
                        int32_t c = hrow[x];
                        int32_t v =
                            c + sp[(rowprev[x] - c + 0x10007FF) >> 12];
                        rowprev[x] = v;
                        int32_t prev = antr[x] << 8;
                        int32_t dst = v + tp[hq_tidx(prev - v)];
                        antr[x] = ((dst + 0x1000007F) >> 8) & 0xFFFF;
                        orow[x] = (uint8_t)(((dst + 0x10007FFF) >> 16)
                                            & 0xFF);
                    }
                }
            }
        }
    }
    free(hband);
    free(rowprev);
}

// ---------------------------------------------------------------------
// denoise3d cascade (filter_denoise3d.c:123-199): same three-pass shape
// as hqdn3d but in the uint8 domain with a 512-entry table per pass —
// LowPass(prev, curr, c) = curr + c[prev - curr + 256]; the temporal
// pass is an IIR on the previous OUTPUT frame.  Bit-identical to the
// lax.scan port in modules/filters/denoise3d.py.

void tc_denoise3d_plane(const uint8_t *src, long n, long h, long w,
                        const int32_t *ch, const int32_t *cv,
                        const int32_t *ct, int32_t *prev, uint8_t *out) {
    enum { R = 4 };
    int32_t *hband = (int32_t *)malloc(sizeof(int32_t) * w * R);
    int32_t *rowprev = (int32_t *)malloc(sizeof(int32_t) * w);
    for (long f = 0; f < n; f++) {
        const uint8_t *s = src + f * h * w;
        uint8_t *o = out + f * h * w;
        for (long y0 = 0; y0 < h; y0 += R) {
            long rows = (y0 + R <= h) ? R : (h - y0);
            if (rows == R) {
                const uint8_t *s0 = s + (y0 + 0) * w;
                const uint8_t *s1 = s + (y0 + 1) * w;
                const uint8_t *s2 = s + (y0 + 2) * w;
                const uint8_t *s3 = s + (y0 + 3) * w;
                int32_t c0 = s0[0], c1 = s1[0], c2 = s2[0], c3 = s3[0];
                hband[0 * w] = c0;
                hband[1 * w] = c1;
                hband[2 * w] = c2;
                hband[3 * w] = c3;
                for (long x = 1; x < w; x++) {
                    int32_t p0 = s0[x], p1 = s1[x], p2 = s2[x],
                            p3 = s3[x];
                    c0 = p0 + ch[c0 - p0 + 256];
                    c1 = p1 + ch[c1 - p1 + 256];
                    c2 = p2 + ch[c2 - p2 + 256];
                    c3 = p3 + ch[c3 - p3 + 256];
                    hband[0 * w + x] = c0;
                    hband[1 * w + x] = c1;
                    hband[2 * w + x] = c2;
                    hband[3 * w + x] = c3;
                }
            } else {
                for (long r = 0; r < rows; r++) {
                    const uint8_t *sr = s + (y0 + r) * w;
                    int32_t carry = sr[0];
                    hband[r * w] = carry;
                    for (long x = 1; x < w; x++) {
                        int32_t c = sr[x];
                        carry = c + ch[carry - c + 256];
                        hband[r * w + x] = carry;
                    }
                }
            }
            for (long r = 0; r < rows; r++) {
                long y = y0 + r;
                const int32_t *hrow = hband + r * w;
                int32_t *pr = prev + y * w;
                uint8_t *orow = o + y * w;
                if (y == 0) {
                    for (long x = 0; x < w; x++) {
                        int32_t v = hrow[x];
                        rowprev[x] = v;
                        int32_t d = v + ct[pr[x] - v + 256];
                        pr[x] = d;
                        orow[x] = (uint8_t)d;
                    }
                } else {
                    for (long x = 0; x < w; x++) {
                        int32_t c = hrow[x];
                        int32_t v = c + cv[rowprev[x] - c + 256];
                        rowprev[x] = v;
                        int32_t d = v + ct[pr[x] - v + 256];
                        pr[x] = d;
                        orow[x] = (uint8_t)d;
                    }
                }
            }
        }
    }
    free(hband);
    free(rowprev);
}

// ---------------------------------------------------------------------
// Batched intra 8x8 IDCT: (n, bh, bw, 64) int32 coefficient grids ->
// (n, bh*8, bw*8) uint8 planes.  Same math as mpeg2codec.py's
// _recon_intra_batch_core (pix = B^T (C B) with the orthonormal DCT-II
// basis, round-half-even, clip 0..255) but in plain double loops —
// XLA:CPU spends ~6 ms/frame on the tiny batched matmuls; this runs
// the same reconstruction in well under 1 ms (config 5's decode path).

static double tc_idct_basis[8][8];
static int tc_idct_basis_init = 0;

static void tc_idct_fill_basis() {
    if (tc_idct_basis_init) return;
    const double pi = 3.14159265358979323846;
    for (int k = 0; k < 8; k++) {
        double c = (k == 0) ? (1.0 / std::sqrt(2.0)) : 1.0;
        for (int n2 = 0; n2 < 8; n2++)
            tc_idct_basis[k][n2] =
                c / 2.0 * std::cos((2 * n2 + 1) * k * pi / 16.0);
    }
    tc_idct_basis_init = 1;
}

#if defined(__AVX512F__)
// AVX-512 path: one 8-double vector per basis/accumulator row.
// Accumulation order over k matches the scalar path (and numpy's
// dgemm) — FMA's single rounding differs from mul+add by <=1 ulp,
// which the integer round+clip absorbs (verified bit-identical to
// the float64 numpy reference in tests/test_mpeg2.py goldens).
static void tc_idct_block_avx512(const int32_t *c, uint8_t *o0,
                                 long row_stride,
                                 const __m512d basis[8]) {
    __m512d t[8];
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        const int32_t *ci = c + i * 8;
        for (int k = 0; k < 8; k++)
            acc = _mm512_fmadd_pd(_mm512_set1_pd((double)ci[k]),
                                  basis[k], acc);
        t[i] = acc;
    }
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        for (int k = 0; k < 8; k++) {
            double bki = ((const double *)&basis[k])[i];
            acc = _mm512_fmadd_pd(_mm512_set1_pd(bki), t[k], acc);
        }
        // round-half-even, clip 0..255, narrow to bytes
        acc = _mm512_roundscale_pd(
            acc, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
        acc = _mm512_max_pd(acc, _mm512_setzero_pd());
        acc = _mm512_min_pd(acc, _mm512_set1_pd(255.0));
        __m256i v32 = _mm512_cvtpd_epi32(acc);      // 8 x int32
        __m128i v8 = _mm256_cvtepi32_epi8(v32);     // 8 bytes (AVX512VL)
        _mm_storel_epi64((__m128i *)(o0 + i * row_stride), v8);
    }
}
#endif

void tc_idct_intra_batch(const int32_t *coef, long n, long bh, long bw,
                         uint8_t *out) {
    tc_idct_fill_basis();
    const long row_stride = bw * 8;          // output row length
#if defined(__AVX512F__)
    __m512d basis[8];
    for (int k = 0; k < 8; k++)
        basis[k] = _mm512_loadu_pd(tc_idct_basis[k]);
    for (long f = 0; f < n; f++) {
        const int32_t *cf = coef + f * bh * bw * 64;
        uint8_t *of = out + f * bh * 8 * row_stride;
        for (long by = 0; by < bh; by++)
            for (long bx = 0; bx < bw; bx++)
                tc_idct_block_avx512(
                    cf + (by * bw + bx) * 64,
                    of + by * 8 * row_stride + bx * 8,
                    row_stride, basis);
    }
    return;
#endif
    for (long f = 0; f < n; f++) {
        const int32_t *cf = coef + f * bh * bw * 64;
        uint8_t *of = out + f * bh * 8 * row_stride;
        for (long by = 0; by < bh; by++) {
            for (long bx = 0; bx < bw; bx++) {
                const int32_t *c = cf + (by * bw + bx) * 64;
                // t = C * B (row pass): j is the vector lane, k the
                // sequential accumulation (same order as the numpy
                // matmul -> bit-identical sums)
                double t[8][8];
                for (int i = 0; i < 8; i++) {
                    const int32_t *ci = c + i * 8;
                    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                    for (int k = 0; k < 8; k++) {
                        double cik = (double)ci[k];
                        for (int j = 0; j < 8; j++)
                            acc[j] += cik * tc_idct_basis[k][j];
                    }
                    for (int j = 0; j < 8; j++) t[i][j] = acc[j];
                }
                // pix = B^T * t  (column pass), round-half-even, clip
                uint8_t *o0 = of + by * 8 * row_stride + bx * 8;
                for (int i = 0; i < 8; i++) {
                    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                    for (int k = 0; k < 8; k++) {
                        double bki = tc_idct_basis[k][i];
                        for (int j = 0; j < 8; j++)
                            acc[j] += bki * t[k][j];
                    }
                    uint8_t *orow = o0 + i * row_stride;
                    for (int j = 0; j < 8; j++) {
                        double r = std::nearbyint(acc[j]);
                        if (r < 0.0) r = 0.0;
                        if (r > 255.0) r = 255.0;
                        orow[j] = (uint8_t)r;
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------
// MPEG-2 encoder motion estimation (io/mpeg2enc.py motion_search +
// halfpel_refine, ported BIT-EXACTLY: same candidate order (dy outer,
// dx inner), same strict-< first-minimum tie-break, same 1<<30
// invalid-candidate sentinel, same hierarchical pyramid (2x2 box
// +2>>2 decimation, (r+1)/2 half-res exhaustive on 8x8 blocks, +-2
// full-res refine with clip) and the decoder's half-pel rounding.
// XLA:CPU spends ~25 ms/frame on the search at SD; this runs ~1 ms.

static inline int sad_row16(const uint8_t* a, const uint8_t* b) {
#if defined(__SSE2__)
    __m128i va = _mm_loadu_si128((const __m128i*)a);
    __m128i vb = _mm_loadu_si128((const __m128i*)b);
    __m128i s = _mm_sad_epu8(va, vb);
    return _mm_cvtsi128_si32(s)
           + _mm_cvtsi128_si32(_mm_srli_si128(s, 8));
#else
    int s = 0;
    for (int i = 0; i < 16; i++)
        s += a[i] > b[i] ? a[i] - b[i] : b[i] - a[i];
    return s;
#endif
}

static inline int sad_row8(const uint8_t* a, const uint8_t* b) {
#if defined(__SSE2__)
    __m128i va = _mm_loadl_epi64((const __m128i*)a);
    __m128i vb = _mm_loadl_epi64((const __m128i*)b);
    return _mm_cvtsi128_si32(_mm_sad_epu8(va, vb));
#else
    int s = 0;
    for (int i = 0; i < 8; i++)
        s += a[i] > b[i] ? a[i] - b[i] : b[i] - a[i];
    return s;
#endif
}

#if defined(__SSE4_1__)
// 8 SADs of the 8-byte cur row vs ref offsets base..base+7 in one go:
// mpsadbw computes 8 four-byte SADs at successive offsets, so the low
// and high cur quads summed give the eight 8-byte SADs exactly.
static inline __m128i sad8x1_x8(const uint8_t* refrow,
                                const uint8_t* currow) {
    __m128i c = _mm_loadl_epi64((const __m128i*)currow);
    __m128i r0 = _mm_loadu_si128((const __m128i*)refrow);
    // imm=0: cur quad0 vs ref offsets i..i+3; imm=5 (BLK2=1, BLK1
    // offset +4): cur quad1 vs ref offsets i+4..i+7
    return _mm_add_epi16(_mm_mpsadbw_epu8(r0, c, 0),
                         _mm_mpsadbw_epu8(r0, c, 5));
}
#endif

static void me_exhaustive(const uint8_t* ref, const uint8_t* cur,
                          long h, long w, int r, int mb,
                          int32_t* mv, int32_t* sad_out) {
    long mbh = h / mb, mbw = w / mb;
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            long y0 = by * mb, x0 = bx * mb;
            int64_t best = INT64_MAX;
            int bdy = -r, bdx = -r;
#if defined(__SSE4_1__)
            // interior 8x8 fast path: sweep 8 dx offsets per mpsadbw
            // row pass; candidate order (dy, then dx ascending, first
            // strict minimum) is preserved by the scalar result scan
            if (mb == 8 && y0 - r >= 0 && y0 + 8 + r <= h
                && x0 - r >= 0 && x0 + 8 + r + 8 <= w) {
                const uint8_t* cp = cur + y0 * w + x0;
                for (int dy = -r; dy <= r; dy++) {
                    const uint8_t* rp = ref + (y0 + dy) * w + x0;
                    int dx = -r;
                    for (; dx + 7 <= r; dx += 8) {
                        __m128i acc = _mm_setzero_si128();
                        int row = 0;
                        for (; row < 4; row++)
                            acc = _mm_add_epi16(
                                acc, sad8x1_x8(rp + row * w + dx,
                                               cp + row * w));
                        // exact cutoff: if even the best partial of
                        // the 8 lanes already >= best, no lane can win
                        if ((_mm_extract_epi16(
                                 _mm_minpos_epu16(acc), 0) & 0xffff)
                            >= best)
                            continue;
                        for (; row < 8; row++)
                            acc = _mm_add_epi16(
                                acc, sad8x1_x8(rp + row * w + dx,
                                               cp + row * w));
                        // minpos returns the LOWEST index among tied
                        // minima — the same first-strict-minimum
                        // tie-break as the ascending scalar scan
                        __m128i mp = _mm_minpos_epu16(acc);
                        int mv16 = _mm_extract_epi16(mp, 0) & 0xffff;
                        if ((int64_t)mv16 < best) {
                            best = mv16;
                            bdy = dy;
                            bdx = dx + (_mm_extract_epi16(mp, 1)
                                        & 0xffff);
                        }
                    }
                    for (; dx <= r; dx++) {
                        int acc = 0;
                        int row = 0;
                        for (; row < 4; row++)
                            acc += sad_row8(rp + row * w + dx,
                                            cp + row * w);
                        if ((int64_t)acc >= best)
                            continue;
                        for (; row < 8; row++)
                            acc += sad_row8(rp + row * w + dx,
                                            cp + row * w);
                        if (acc < best) {
                            best = acc;
                            bdy = dy;
                            bdx = dx;
                        }
                    }
                }
                mv[(by * mbw + bx) * 2 + 0] = bdy;
                mv[(by * mbw + bx) * 2 + 1] = bdx;
                sad_out[by * mbw + bx] = (int32_t)best;
                continue;
            }
#endif
            for (int dy = -r; dy <= r; dy++) {
                bool oky = (y0 + dy >= 0) && (y0 + mb + dy <= h);
                for (int dx = -r; dx <= r; dx++) {
                    int32_t s;
                    if (!oky || x0 + dx < 0 || x0 + mb + dx > w) {
                        s = 1 << 30;
                    } else {
                        const uint8_t* rp =
                            ref + (y0 + dy) * w + x0 + dx;
                        const uint8_t* cp = cur + y0 * w + x0;
                        int acc = 0;
                        if (mb == 16)
                            for (int row = 0; row < 16; row++)
                                acc += sad_row16(rp + row * w,
                                                 cp + row * w);
                        else
                            for (int row = 0; row < 8; row++)
                                acc += sad_row8(rp + row * w,
                                                cp + row * w);
                        s = acc;
                    }
                    if (s < best) {
                        best = s;
                        bdy = dy;
                        bdx = dx;
                    }
                }
            }
            mv[(by * mbw + bx) * 2 + 0] = bdy;
            mv[(by * mbw + bx) * 2 + 1] = bdx;
            sad_out[by * mbw + bx] = (int32_t)best;
        }
    }
}

static void me_dec2(const uint8_t* p, long h, long w, uint8_t* out) {
    long h2 = h / 2, w2 = w / 2;
    for (long y = 0; y < h2; y++) {
        const uint8_t* r0 = p + 2 * y * w;
        const uint8_t* r1 = r0 + w;
        uint8_t* o = out + y * w2;
        for (long x = 0; x < w2; x++)
            o[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1]
                              + r1[2 * x] + r1[2 * x + 1] + 2) >> 2);
    }
}

static inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// integer-pel full search (hierarchical when r > 4), matching
// io/mpeg2enc.py motion_search
static void me16_int(const uint8_t* ref, const uint8_t* cur,
                     long h, long w, int r, int32_t* mv,
                     int32_t* sad_out) {
    long mbh = h / 16, mbw = w / 16;
    if (r <= 4) {
        me_exhaustive(ref, cur, h, w, r, 16, mv, sad_out);
        return;
    }
    long h2 = h / 2, w2 = w / 2;
    uint8_t* dref = (uint8_t*)malloc((size_t)(h2 * w2));
    uint8_t* dcur = (uint8_t*)malloc((size_t)(h2 * w2));
    me_dec2(ref, h, w, dref);
    me_dec2(cur, h, w, dcur);
    int32_t* cmv = (int32_t*)malloc(sizeof(int32_t) * mbh * mbw * 2);
    int32_t* csad = (int32_t*)malloc(sizeof(int32_t) * mbh * mbw);
    me_exhaustive(dref, dcur, h2, w2, (r + 1) / 2, 8, cmv, csad);
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            long i = by * mbw + bx;
            long y0 = by * 16, x0 = bx * 16;
            int basey = cmv[i * 2 + 0] * 2;
            int basex = cmv[i * 2 + 1] * 2;
            int64_t best = INT64_MAX;
            int bvy = 0, bvx = 0;
            for (int dy = -2; dy <= 2; dy++) {
                int vy = clampi(basey + dy, -r, r);
#if defined(__SSE4_1__)
                // vector fast path: unclamped contiguous dx window,
                // interior rows -> the five dx candidates in lanes
                // 0..4 of one mpsadbw sweep (5..7 masked), first-min
                // tie-break preserved by minpos' lowest-index rule
                if (basex - 2 >= -r && basex + 2 <= r
                    && y0 + vy >= 0 && y0 + 16 + vy <= h
                    && x0 + basex - 2 >= 0
                    && x0 + basex + 22 <= w) {
                    const uint8_t* cp = cur + y0 * w + x0;
                    const uint8_t* rp =
                        ref + (y0 + vy) * w + x0 + basex - 2;
                    const __m128i hi_mask = _mm_setr_epi16(
                        0, 0, 0, 0, 0, -1, -1, -1);
                    __m128i acc = _mm_setzero_si128();
                    int row = 0;
                    for (; row < 8; row++) {
                        const uint8_t* a = rp + row * w;
                        __m128i c16 = _mm_loadu_si128(
                            (const __m128i*)(cp + row * w));
                        __m128i r0 = _mm_loadu_si128(
                            (const __m128i*)a);
                        __m128i r1 = _mm_loadu_si128(
                            (const __m128i*)(a + 8));
                        __m128i s = _mm_add_epi16(
                            _mm_add_epi16(
                                _mm_mpsadbw_epu8(r0, c16, 0),
                                _mm_mpsadbw_epu8(r0, c16, 5)),
                            _mm_add_epi16(
                                _mm_mpsadbw_epu8(r1, c16, 2),
                                _mm_mpsadbw_epu8(r1, c16, 7)));
                        acc = _mm_add_epi16(acc, s);
                    }
                    __m128i part = _mm_or_si128(acc, hi_mask);
                    if ((_mm_extract_epi16(_mm_minpos_epu16(part), 0)
                         & 0xffff) >= best)
                        continue;     // exact: partial >= best
                    for (; row < 16; row++) {
                        const uint8_t* a = rp + row * w;
                        __m128i c16 = _mm_loadu_si128(
                            (const __m128i*)(cp + row * w));
                        __m128i r0 = _mm_loadu_si128(
                            (const __m128i*)a);
                        __m128i r1 = _mm_loadu_si128(
                            (const __m128i*)(a + 8));
                        __m128i s = _mm_add_epi16(
                            _mm_add_epi16(
                                _mm_mpsadbw_epu8(r0, c16, 0),
                                _mm_mpsadbw_epu8(r0, c16, 5)),
                            _mm_add_epi16(
                                _mm_mpsadbw_epu8(r1, c16, 2),
                                _mm_mpsadbw_epu8(r1, c16, 7)));
                        acc = _mm_add_epi16(acc, s);
                    }
                    __m128i mp = _mm_minpos_epu16(
                        _mm_or_si128(acc, hi_mask));
                    int mv16 = _mm_extract_epi16(mp, 0) & 0xffff;
                    if ((int64_t)mv16 < best) {
                        best = mv16;
                        bvy = vy;
                        bvx = basex - 2
                              + (_mm_extract_epi16(mp, 1) & 0xffff);
                    }
                    continue;
                }
#endif
                for (int dx = -2; dx <= 2; dx++) {
                    int vx = clampi(basex + dx, -r, r);
                    int32_t s;
                    if (y0 + vy < 0 || y0 + 16 + vy > h
                        || x0 + vx < 0 || x0 + 16 + vx > w) {
                        s = 1 << 30;
                    } else {
                        const uint8_t* rp =
                            ref + (y0 + vy) * w + x0 + vx;
                        const uint8_t* cp = cur + y0 * w + x0;
                        int acc = 0;
                        int row = 0;
                        for (; row < 8; row++)
                            acc += sad_row16(rp + row * w,
                                             cp + row * w);
                        // exact cutoff: rows are non-negative, so a
                        // partial SAD already >= best can never win
                        if ((int64_t)acc < best)
                            for (; row < 16; row++)
                                acc += sad_row16(rp + row * w,
                                                 cp + row * w);
                        s = acc;
                    }
                    if (s < best) {
                        best = s;
                        bvy = vy;
                        bvx = vx;
                    }
                }
            }
            mv[i * 2 + 0] = bvy;
            mv[i * 2 + 1] = bvx;
            sad_out[i] = (int32_t)best;
        }
    }
    free(dref);
    free(dcur);
    free(cmv);
    free(csad);
}

// half-pel SAD for one MB at half-pel vector (vy, vx); caller
// guarantees the referenced area is inside the picture.  SIMD keeps
// the exact MPEG rounding: pavgb IS (a+b+1)>>1, and the 4-tap
// (a0+a1+b0+b1+2)>>2 is evaluated widened to 16-bit.
static int32_t sad_halfpel_mb(const uint8_t* ref, const uint8_t* cur,
                              long w, long y0, long x0,
                              int vy, int vx,
                              int64_t cutoff = INT64_MAX) {
    long ry = y0 + (vy >> 1);
    long rx = x0 + (vx >> 1);
    int hy = vy & 1, hx = vx & 1;
    const uint8_t* cp = cur + y0 * w + x0;
    int acc = 0;
#if defined(__AVX2__)
    __m128i vacc = _mm_setzero_si128();
    const __m256i two = _mm256_set1_epi16(2);
    for (int row = 0; row < 16; row++) {
        if (row == 8) {
            // exact cutoff (rows non-negative): a partial SAD
            // already >= the running best cannot be selected
            int64_t part = _mm_cvtsi128_si32(vacc)
                + _mm_cvtsi128_si32(_mm_srli_si128(vacc, 8));
            if (part >= cutoff)
                return (int32_t)part;
        }
        const uint8_t* a = ref + (ry + row) * w + rx;
        const uint8_t* b = a + w;      // row below (hy)
        const uint8_t* cr = cp + row * w;
        __m128i p;
        if (hy && hx) {
            __m256i a0 = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)a));
            __m256i a1 = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)(a + 1)));
            __m256i b0 = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)b));
            __m256i b1 = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)(b + 1)));
            __m256i s = _mm256_add_epi16(
                _mm256_add_epi16(a0, a1),
                _mm256_add_epi16(_mm256_add_epi16(b0, b1), two));
            s = _mm256_srli_epi16(s, 2);
            __m256i packed = _mm256_packus_epi16(
                s, _mm256_permute2x128_si256(s, s, 0x01));
            p = _mm256_castsi256_si128(packed);
        } else if (hx) {
            p = _mm_avg_epu8(_mm_loadu_si128((const __m128i*)a),
                             _mm_loadu_si128((const __m128i*)(a + 1)));
        } else if (hy) {
            p = _mm_avg_epu8(_mm_loadu_si128((const __m128i*)a),
                             _mm_loadu_si128((const __m128i*)b));
        } else {
            p = _mm_loadu_si128((const __m128i*)a);
        }
        vacc = _mm_add_epi64(vacc, _mm_sad_epu8(
            p, _mm_loadu_si128((const __m128i*)cr)));
    }
    acc = _mm_cvtsi128_si32(vacc)
          + _mm_cvtsi128_si32(_mm_srli_si128(vacc, 8));
#else
    for (int row = 0; row < 16; row++) {
        if (row == 8 && (int64_t)acc >= cutoff)
            return acc;
        const uint8_t* a = ref + (ry + row) * w + rx;
        const uint8_t* b = a + w;      // row below (hy)
        const uint8_t* cr = cp + row * w;
        if (hy && hx) {
            for (int i = 0; i < 16; i++) {
                int p = (a[i] + a[i + 1] + b[i] + b[i + 1] + 2) >> 2;
                acc += p > cr[i] ? p - cr[i] : cr[i] - p;
            }
        } else if (hx) {
            for (int i = 0; i < 16; i++) {
                int p = (a[i] + a[i + 1] + 1) >> 1;
                acc += p > cr[i] ? p - cr[i] : cr[i] - p;
            }
        } else if (hy) {
            for (int i = 0; i < 16; i++) {
                int p = (a[i] + b[i] + 1) >> 1;
                acc += p > cr[i] ? p - cr[i] : cr[i] - p;
            }
        } else {
            acc += sad_row16(a, cr);
        }
    }
#endif
    return acc;
}

// full pipeline: integer search + half-pel refine ->
// mvh (mbh*mbw*2, half-pel units) and refined SAD
void tc_me16_refine(const uint8_t* ref, const uint8_t* cur,
                    long h, long w, int r,
                    int32_t* mvh, int32_t* sad_out) {
    long mbh = h / 16, mbw = w / 16;
    int32_t* mvi = (int32_t*)malloc(sizeof(int32_t) * mbh * mbw * 2);
    int32_t* sadi = (int32_t*)malloc(sizeof(int32_t) * mbh * mbw);
    me16_int(ref, cur, h, w, r, mvi, sadi);
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            long i = by * mbw + bx;
            long y0 = by * 16, x0 = bx * 16;
            int basey = mvi[i * 2 + 0] * 2;
            int basex = mvi[i * 2 + 1] * 2;
            int64_t best = INT64_MAX;
            int bvy = 0, bvx = 0;
            for (int dy = -1; dy <= 1; dy++) {
                for (int dx = -1; dx <= 1; dx++) {
                    int vy = basey + dy;
                    int vx = basex + dx;
                    int32_t s;
                    if (y0 + (vy >> 1) < 0
                        || y0 + 16 + (vy >> 1) + (vy & 1) > h
                        || x0 + (vx >> 1) < 0
                        || x0 + 16 + (vx >> 1) + (vx & 1) > w) {
                        s = 1 << 30;
                    } else {
                        s = sad_halfpel_mb(ref, cur, w, y0, x0,
                                           vy, vx, best);
                    }
                    if (s < best) {
                        best = s;
                        bvy = vy;
                        bvx = vx;
                    }
                }
            }
            mvh[i * 2 + 0] = bvy;
            mvh[i * 2 + 1] = bvx;
            sad_out[i] = (int32_t)best;
        }
    }
    free(mvi);
    free(sadi);
}

// ---------------------------------------------------------------------
// MPEG-2 encoder block pipeline (io/mpeg2enc.py encode_intra_math /
// _code_plane_inter, CPU fast path): forward DCT + quant + dequant
// (incl. 13818-2 mismatch control / 11172-2 oddification) + in-loop
// IDCT recon, all in double precision with round-half-even — the
// same numerics as the float64 numpy reference and the native
// decoder IDCT (the jax path keeps float32 on the device).  levels
// come out in NATURAL 8x8 order; zigzag happens host-side.

#if defined(__AVX512F__)
// 8-double-lane transforms (one zmm per row); k accumulates
// sequentially with FMA — internally consistent double math

static void fdct8x8(const double in[64], double out[64]) {
    tc_idct_fill_basis();
    __m512d basisT[8];   // basisT[k][j] = B[j][k]
    for (int k = 0; k < 8; k++) {
        double row[8];
        for (int j = 0; j < 8; j++) row[j] = tc_idct_basis[j][k];
        basisT[k] = _mm512_loadu_pd(row);
    }
    __m512d t[8];
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        for (int k = 0; k < 8; k++)
            acc = _mm512_fmadd_pd(_mm512_set1_pd(in[i * 8 + k]),
                                  basisT[k], acc);
        t[i] = acc;
    }
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        for (int k = 0; k < 8; k++)
            acc = _mm512_fmadd_pd(_mm512_set1_pd(tc_idct_basis[i][k]),
                                  t[k], acc);
        _mm512_storeu_pd(out + i * 8, acc);
    }
}

static void idct8x8_d(const int32_t in[64], double out[64]) {
    tc_idct_fill_basis();
    __m512d basis[8];
    for (int k = 0; k < 8; k++)
        basis[k] = _mm512_loadu_pd(tc_idct_basis[k]);
    __m512d t[8];
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        for (int k = 0; k < 8; k++)
            acc = _mm512_fmadd_pd(
                _mm512_set1_pd((double)in[i * 8 + k]), basis[k], acc);
        t[i] = acc;
    }
    for (int i = 0; i < 8; i++) {
        __m512d acc = _mm512_setzero_pd();
        for (int k = 0; k < 8; k++)
            acc = _mm512_fmadd_pd(
                _mm512_set1_pd(tc_idct_basis[k][i]), t[k], acc);
        _mm512_storeu_pd(out + i * 8, acc);
    }
}

#else

static void fdct8x8(const double in[64], double out[64]) {
    tc_idct_fill_basis();
    double t[8][8];
    // t = X * B^T  (t[i][j] = sum_k X[i][k] * B[j][k])
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            double acc = 0.0;
            for (int k = 0; k < 8; k++)
                acc += in[i * 8 + k] * tc_idct_basis[j][k];
            t[i][j] = acc;
        }
    // out = B * t  (out[i][j] = sum_k B[i][k] * t[k][j])
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            double acc = 0.0;
            for (int k = 0; k < 8; k++)
                acc += tc_idct_basis[i][k] * t[k][j];
            out[i * 8 + j] = acc;
        }
}

static void idct8x8_d(const int32_t in[64], double out[64]) {
    tc_idct_fill_basis();
    double t[8][8];
    // t = C * B
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            double acc = 0.0;
            for (int k = 0; k < 8; k++)
                acc += (double)in[i * 8 + k] * tc_idct_basis[k][j];
            t[i][j] = acc;
        }
    // out = B^T * t
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            double acc = 0.0;
            for (int k = 0; k < 8; k++)
                acc += tc_idct_basis[k][i] * t[k][j];
            out[i * 8 + j] = acc;
        }
}
#endif

static inline int32_t trunc_div_i64(int64_t a, int64_t d) {
    int64_t q = (a < 0 ? -a : a) / d;
    return (int32_t)(a < 0 ? -q : q);
}

#if defined(__AVX512F__)
// vector quantizers, bit-exact to the scalar forms: roundscale 0x08
// is round-half-even (= nearbyint under the default mode), 0x0B is
// trunc; double division is correctly rounded and |a/b - k| >= 1/b
// for non-divisible integer a,b, so trunc(fl(a/b)) == a/b in C ints.

// inter: lv[i] = clamp(trunc(round(coef)/2qs)) with round's sign;
// returns nonzero if any level != 0
static inline int quant_inter_vec(const double coef[64], int qs,
                                  int lim, int32_t lv[64]) {
    const __m512d vlim = _mm512_set1_pd((double)lim);
    const __m512d den = _mm512_set1_pd((double)(2 * qs));
    const __m512i sgn = _mm512_set1_epi64(
        (long long)0x8000000000000000LL);
    __mmask8 any = 0;
    for (int i = 0; i < 64; i += 8) {
        __m512d c = _mm512_roundscale_pd(
            _mm512_loadu_pd(coef + i), 0x08);
        __m512d q = _mm512_min_pd(
            _mm512_roundscale_pd(
                _mm512_div_pd(_mm512_abs_pd(c), den), 0x0B), vlim);
        any |= _mm512_cmp_pd_mask(q, _mm512_setzero_pd(),
                                  _CMP_NEQ_OQ);
        __m512d qsgn = _mm512_castsi512_pd(_mm512_or_si512(
            _mm512_and_si512(_mm512_castpd_si512(c), sgn),
            _mm512_castpd_si512(q)));
        _mm256_storeu_si256((__m256i*)(lv + i),
                            _mm512_cvtpd_epi32(qsgn));
    }
    return any != 0;
}

// intra: lv[i] = clamp(round(coef*32 / (2*W[i]*2qs)))
static inline void quant_intra_vec(const double coef[64],
                                   const double den[64], int lim,
                                   int32_t lv[64]) {
    const __m512d vlim = _mm512_set1_pd((double)lim);
    const __m512d nlim = _mm512_set1_pd(-(double)lim);
    const __m512d k32 = _mm512_set1_pd(32.0);
    for (int i = 0; i < 64; i += 8) {
        __m512d q = _mm512_roundscale_pd(
            _mm512_div_pd(_mm512_mul_pd(_mm512_loadu_pd(coef + i),
                                        k32),
                          _mm512_loadu_pd(den + i)), 0x08);
        q = _mm512_max_pd(_mm512_min_pd(q, vlim), nlim);
        _mm256_storeu_si256((__m256i*)(lv + i),
                            _mm512_cvtpd_epi32(q));
    }
}
#endif

// one intra 8x8 block: DCT + quant -> lv (scan order) and in-loop
// recon (shared by the full-plane and selected-block entry points)
static void enc_intra_block(const uint8_t* sp, long w, int qs, int m1,
                            const int32_t* intra_w,
                            const int32_t* scan,
                            int16_t* lo, uint8_t* rp,
                            const double* qden) {
    int lim = m1 ? 255 : 2047;
    double blk[64], coef[64];
    int32_t lv[64];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            blk[i * 8 + j] = (double)sp[i * w + j];
    fdct8x8(blk, coef);
    // DC: clip(round(C00/8), 0, 255)
    double dc = std::nearbyint(coef[0] / 8.0);
    if (dc < 0) dc = 0;
    if (dc > 255) dc = 255;
#if defined(__AVX512F__)
    quant_intra_vec(coef, qden, lim, lv);
#else
    (void)qden;
    for (int i = 0; i < 64; i++) {
        double q = std::nearbyint(
            coef[i] * 32.0
            / (2.0 * (double)intra_w[i] * (2.0 * qs)));
        if (q < -lim) q = -lim;
        if (q > lim) q = lim;
        lv[i] = (int32_t)q;
    }
#endif
    lv[0] = (int32_t)dc;
    for (int i = 0; i < 64; i++)
        lo[i] = (int16_t)lv[scan[i]];
    // dequant (+ mismatch) and recon
    int32_t deq[64];
    int64_t s = 0;
    for (int i = 0; i < 64; i++) {
        int64_t prod = (int64_t)lv[i] * 2 * intra_w[i] * (2 * qs);
        int32_t d = trunc_div_i64(prod, 32);
        if (m1 && d != 0 && (d % 2) == 0)
            d -= (d > 0) ? 1 : -1;               // oddify AC
        deq[i] = d;
    }
    deq[0] = lv[0] * 8;
    for (int i = 0; i < 64; i++) {
        if (deq[i] < -2048) deq[i] = -2048;
        if (deq[i] > 2047) deq[i] = 2047;
        s += deq[i];
    }
    if (!m1 && (s % 2) == 0)
        deq[63] ^= 1;                            // 7.4.4 mismatch
    double pix[64];
    idct8x8_d(deq, pix);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            double r = std::nearbyint(pix[i * 8 + j]);
            if (r < 0) r = 0;
            if (r > 255) r = 255;
            rp[i * w + j] = (uint8_t)r;
        }
}

// output index for one 8x8 block.  slot -2: natural (bh, bw, 64)
// order.  slot -1: luma blocks of a (nmb, 6, 64) MB-interleaved
// levels array (slot = 2*(by&1) + (bx&1)).  slot 4/5: chroma block
// of the same array.  Writing MB order directly replaces a host-side
// interleave copy of the whole levels tensor.
// 4:2:2 layouts (8 blocks/MB, chroma order Cb4 Cr5 Cb6 Cr7):
// slot -3 = luma into (nmb, 8, 64); slot 14/15 = Cb/Cr of a 16x8
// chroma MB (two vertically stacked 8x8 blocks per MB).
static inline long lv_index(long by, long bx, long bw, int slot) {
    if (slot == -2)
        return by * bw + bx;
    if (slot == -1)
        return (((by >> 1) * (bw >> 1) + (bx >> 1)) * 6
                + (by & 1) * 2 + (bx & 1));
    if (slot == -3)
        return (((by >> 1) * (bw >> 1) + (bx >> 1)) * 8
                + (by & 1) * 2 + (bx & 1));
    if (slot >= 14)
        return ((by >> 1) * bw + bx) * 8 + 4 + (by & 1) * 2
               + (slot - 14);
    return (by * bw + bx) * 6 + slot;
}

static void intra_qden(const int32_t* intra_w, int qs,
                       double qden[64]) {
    for (int i = 0; i < 64; i++)
        qden[i] = 2.0 * (double)intra_w[i] * (2.0 * qs);
}

void tc_enc_intra_plane(const uint8_t* plane, long h, long w, int qs,
                        int m1, const int32_t* intra_w,
                        const int32_t* scan,
                        int16_t* lv_out, uint8_t* rec_out, int slot) {
    long bh = h / 8, bw = w / 8;
    double qden[64];
    intra_qden(intra_w, qs, qden);
    for (long by = 0; by < bh; by++)
        for (long bx = 0; bx < bw; bx++)
            enc_intra_block(plane + by * 8 * w + bx * 8, w, qs, m1,
                            intra_w, scan,
                            lv_out + lv_index(by, bx, bw, slot) * 64,
                            rec_out + by * 8 * w + bx * 8, qden);
}

// selected-block intra encode (P-picture intra/inter decision: the
// fraction of intra MBs is typically <1%, so encoding only the chosen
// blocks replaces a full-plane intra alternative).  Recon is written
// IN PLACE into rec (the inter recon plane), replacing the MB mix.
void tc_enc_intra_sel(const uint8_t* plane, long h, long w, int qs,
                      int m1, const int32_t* intra_w,
                      const int32_t* scan, const int32_t* bys,
                      const int32_t* bxs, long nsel,
                      int16_t* lv_out, uint8_t* rec) {
    (void)h;
    double qden[64];
    intra_qden(intra_w, qs, qden);
    for (long s = 0; s < nsel; s++) {
        long off = (long)bys[s] * 8 * w + (long)bxs[s] * 8;
        enc_intra_block(plane + off, w, qs, m1, intra_w, scan,
                        lv_out + s * 64, rec + off, qden);
    }
}

void tc_enc_inter_plane(const uint8_t* cur, const uint8_t* pred,
                        long h, long w, int qs, int m1,
                        const int32_t* scan,
                        int16_t* lv_out, uint8_t* rec_out, int slot) {
    long bh = h / 8, bw = w / 8;
    int lim = m1 ? 255 : 2047;
    for (long by = 0; by < bh; by++) {
        for (long bx = 0; bx < bw; bx++) {
            double blk[64], coef[64];
            int32_t lv[64];
            const uint8_t* cp = cur + by * 8 * w + bx * 8;
            const uint8_t* pp = pred + by * 8 * w + bx * 8;
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 8; j++)
                    blk[i * 8 + j] = (double)cp[i * w + j]
                                     - (double)pp[i * w + j];
            fdct8x8(blk, coef);
#if defined(__AVX512F__)
            bool any = quant_inter_vec(coef, qs, lim, lv) != 0;
#else
            bool any = false;
            for (int i = 0; i < 64; i++) {
                // level = trunc(round(C) / (2*qs))  (flat W=16)
                int32_t c = (int32_t)std::nearbyint(coef[i]);
                if (c == 0) { lv[i] = 0; continue; }
                int32_t ac = c < 0 ? -c : c;
                int32_t q = ac / (2 * qs);
                if (q > lim) q = lim;
                if (c < 0) q = -q;
                lv[i] = q;
                if (q) any = true;
            }
#endif
            {
                int16_t* lo = lv_out + lv_index(by, bx, bw, slot) * 64;
                for (int i = 0; i < 64; i++)
                    lo[i] = (int16_t)lv[scan[i]];
            }
            uint8_t* rp = rec_out + by * 8 * w + bx * 8;
            if (!any) {
                // all-zero block: deq == 0, no mismatch flip, and
                // idct(0) == 0 -> recon is exactly the prediction
                for (int i = 0; i < 8; i++)
                    memcpy(rp + i * w, pp + i * w, 8);
                continue;
            }
            int32_t deq[64];
            int64_t s = 0;
            for (int i = 0; i < 64; i++) {
                int32_t q = lv[i];
                if (q == 0) { deq[i] = 0; continue; }
                int64_t mag = (2 * (int64_t)(q < 0 ? -q : q) + 1)
                              * 16 * (2 * qs);
                int32_t d = (int32_t)((q < 0 ? -1 : 1) * (mag / 32));
                if (m1 && d != 0 && (d % 2) == 0)
                    d -= (d > 0) ? 1 : -1;
                if (d < -2048) d = -2048;
                if (d > 2047) d = 2047;
                deq[i] = d;
                s += d;
            }
            if (!m1 && (s % 2) == 0)
                deq[63] ^= 1;
            double pix[64];
            idct8x8_d(deq, pix);
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 8; j++) {
                    double r = std::nearbyint(pix[i * 8 + j])
                               + (double)pp[i * w + j];
                    if (r < 0) r = 0;
                    if (r > 255) r = 255;
                    rp[i * w + j] = (uint8_t)r;
                }
        }
    }
}

// levels-only inter block pipeline: B pictures are never reference
// frames, so their in-loop recon (dequant + IDCT + add) is dead work
// — this skips it entirely (~40% of the inter-plane time).
void tc_enc_inter_levels(const uint8_t* cur, const uint8_t* pred,
                         long h, long w, int qs, int m1,
                         const int32_t* scan, int16_t* lv_out,
                         int slot) {
    long bh = h / 8, bw = w / 8;
    int lim = m1 ? 255 : 2047;
    for (long by = 0; by < bh; by++) {
        for (long bx = 0; bx < bw; bx++) {
            double blk[64], coef[64];
            int32_t lv[64];
            const uint8_t* cp = cur + by * 8 * w + bx * 8;
            const uint8_t* pp = pred + by * 8 * w + bx * 8;
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 8; j++)
                    blk[i * 8 + j] = (double)cp[i * w + j]
                                     - (double)pp[i * w + j];
            fdct8x8(blk, coef);
#if defined(__AVX512F__)
            quant_inter_vec(coef, qs, lim, lv);
#else
            for (int i = 0; i < 64; i++) {
                int32_t c = (int32_t)std::nearbyint(coef[i]);
                if (c == 0) { lv[i] = 0; continue; }
                int32_t ac = c < 0 ? -c : c;
                int32_t q = ac / (2 * qs);
                if (q > lim) q = lim;
                if (c < 0) q = -q;
                lv[i] = q;
            }
#endif
            int16_t* lo = lv_out + lv_index(by, bx, bw, slot) * 64;
            for (int i = 0; i < 64; i++)
                lo[i] = (int16_t)lv[scan[i]];
        }
    }
}

// half-pel motion-compensated prediction for a whole plane, matching
// io/mpeg2enc._mc_pred_half (coordinate clamping included)
// one MB of half-pel MC prediction into dst (stride dstride)
static void mc_pred_mb(const uint8_t* ref, long h, long w,
                       long by, long bx, int vy, int vx, int mby,
                       int mbx, uint8_t* dst, long dstride) {
    int iy = vy >> 1, ix = vx >> 1;
    int hy = vy & 1, hx = vx & 1;
#if defined(__AVX2__)
    // interior fast path: whole referenced window (incl. the
    // +1 half-pel taps) inside the picture -> no clamping
    if (mbx == 16
        && by * (long)mby + iy >= 0
        && by * (long)mby + iy + mby + hy <= h
        && bx * 16 + ix >= 0 && bx * 16 + ix + 16 + hx <= w) {
        const __m256i two = _mm256_set1_epi16(2);
        for (long r16 = 0; r16 < mby; r16++) {
            const uint8_t* a =
                ref + (by * mby + r16 + iy) * w + bx * 16 + ix;
            const uint8_t* b = a + w;
            uint8_t* op = dst + r16 * dstride;
            __m128i p;
            if (hx && hy) {
                __m256i a0 = _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i*)a));
                __m256i a1 = _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i*)(a + 1)));
                __m256i b0 = _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i*)b));
                __m256i b1 = _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i*)(b + 1)));
                __m256i s = _mm256_add_epi16(
                    _mm256_add_epi16(a0, a1),
                    _mm256_add_epi16(
                        _mm256_add_epi16(b0, b1), two));
                s = _mm256_srli_epi16(s, 2);
                __m256i pk = _mm256_packus_epi16(
                    s, _mm256_permute2x128_si256(s, s, 0x01));
                p = _mm256_castsi256_si128(pk);
            } else if (hx) {
                p = _mm_avg_epu8(
                    _mm_loadu_si128((const __m128i*)a),
                    _mm_loadu_si128((const __m128i*)(a + 1)));
            } else if (hy) {
                p = _mm_avg_epu8(
                    _mm_loadu_si128((const __m128i*)a),
                    _mm_loadu_si128((const __m128i*)b));
            } else {
                p = _mm_loadu_si128((const __m128i*)a);
            }
            _mm_storeu_si128((__m128i*)op, p);
        }
        return;
    }
    // 8-wide (chroma) interior fast path (8x8 at 4:2:0, 16x8 at
    // 4:2:2)
    if (mbx == 8
        && by * (long)mby + iy >= 0
        && by * (long)mby + iy + mby + hy <= h
        && bx * 8 + ix >= 0 && bx * 8 + ix + 8 + hx <= w) {
        const __m128i two8 = _mm_set1_epi16(2);
        for (long r8 = 0; r8 < mby; r8++) {
            const uint8_t* a =
                ref + (by * mby + r8 + iy) * w + bx * 8 + ix;
            const uint8_t* b = a + w;
            uint8_t* op = dst + r8 * dstride;
            __m128i p;
            if (hx && hy) {
                __m128i a0 = _mm_cvtepu8_epi16(
                    _mm_loadl_epi64((const __m128i*)a));
                __m128i a1 = _mm_cvtepu8_epi16(
                    _mm_loadl_epi64((const __m128i*)(a + 1)));
                __m128i b0 = _mm_cvtepu8_epi16(
                    _mm_loadl_epi64((const __m128i*)b));
                __m128i b1 = _mm_cvtepu8_epi16(
                    _mm_loadl_epi64((const __m128i*)(b + 1)));
                __m128i s = _mm_add_epi16(
                    _mm_add_epi16(a0, a1),
                    _mm_add_epi16(_mm_add_epi16(b0, b1), two8));
                s = _mm_srli_epi16(s, 2);
                p = _mm_packus_epi16(s, s);
            } else if (hx) {
                p = _mm_avg_epu8(
                    _mm_loadl_epi64((const __m128i*)a),
                    _mm_loadl_epi64((const __m128i*)(a + 1)));
            } else if (hy) {
                p = _mm_avg_epu8(
                    _mm_loadl_epi64((const __m128i*)a),
                    _mm_loadl_epi64((const __m128i*)b));
            } else {
                p = _mm_loadl_epi64((const __m128i*)a);
            }
            _mm_storel_epi64((__m128i*)op, p);
        }
        return;
    }
#endif
    for (long r = 0; r < mby; r++) {
        long yy = by * mby + r;
        long y0 = yy + iy;
        if (y0 < 0) y0 = 0;
        if (y0 > h - 1) y0 = h - 1;
        long y1 = yy + iy + 1;
        if (y1 < 0) y1 = 0;
        if (y1 > h - 1) y1 = h - 1;
        const uint8_t* r0 = ref + y0 * w;
        const uint8_t* r1 = ref + y1 * w;
        uint8_t* op = dst + r * dstride;
        for (long c = 0; c < mbx; c++) {
            long xx = bx * mbx + c;
            long x0 = xx + ix;
            if (x0 < 0) x0 = 0;
            if (x0 > w - 1) x0 = w - 1;
            long x1 = xx + ix + 1;
            if (x1 < 0) x1 = 0;
            if (x1 > w - 1) x1 = w - 1;
            int a = r0[x0], b = r0[x1];
            int cc = r1[x0], d = r1[x1];
            int p;
            if (hx && hy) p = (a + b + cc + d + 2) >> 2;
            else if (hx) p = (a + b + 1) >> 1;
            else if (hy) p = (a + cc + 1) >> 1;
            else p = a;
            op[c] = (uint8_t)p;
        }
    }
}

void tc_mc_pred_half2(const uint8_t* ref, long h, long w,
                      const int32_t* mvh, int mby, int mbx,
                      uint8_t* out) {
    long mbh = h / mby, mbw = w / mbx;
    for (long by = 0; by < mbh; by++)
        for (long bx = 0; bx < mbw; bx++) {
            long i = by * mbw + bx;
            mc_pred_mb(ref, h, w, by, bx,
                       mvh[i * 2 + 0], mvh[i * 2 + 1], mby, mbx,
                       out + by * mby * w + bx * mbx, w);
        }
}

void tc_mc_pred_half(const uint8_t* ref, long h, long w,
                     const int32_t* mvh, int mb, uint8_t* out) {
    tc_mc_pred_half2(ref, h, w, mvh, mb, mb, out);
}

// fused B-picture chroma path: MC-predict each MB only from the
// reference(s) its mode actually uses (0 fwd / 1 bwd / 2 bi-avg) —
// replaces two full-plane predictions plus a select pass with, on
// average, one prediction per MB.  pavgb == the MPEG (f+b+1)>>1.
void tc_b_mc_sel_pred2(const uint8_t* fref, const uint8_t* bref,
                       long h, long w, const int32_t* fmv,
                       const int32_t* bmv, const int32_t* mode,
                       int mby, int mbx, uint8_t* out) {
    long mbh = h / mby, mbw = w / mbx;
    uint8_t tmp[16 * 16];
    for (long by = 0; by < mbh; by++)
        for (long bx = 0; bx < mbw; bx++) {
            long i = by * mbw + bx;
            uint8_t* dst = out + by * mby * w + bx * mbx;
            int m = mode[i];
            if (m != 1)
                mc_pred_mb(fref, h, w, by, bx,
                           fmv[i * 2 + 0], fmv[i * 2 + 1], mby, mbx,
                           dst, w);
            if (m == 1)
                mc_pred_mb(bref, h, w, by, bx,
                           bmv[i * 2 + 0], bmv[i * 2 + 1], mby, mbx,
                           dst, w);
            else if (m == 2) {
                mc_pred_mb(bref, h, w, by, bx,
                           bmv[i * 2 + 0], bmv[i * 2 + 1], mby, mbx,
                           tmp, mbx);
                for (int r = 0; r < mby; r++)
                    for (int c = 0; c < mbx; c++)
                        dst[r * w + c] = (uint8_t)(
                            (dst[r * w + c] + tmp[r * mbx + c] + 1)
                            >> 1);
            }
        }
}

void tc_b_mc_sel_pred(const uint8_t* fref, const uint8_t* bref,
                      long h, long w, const int32_t* fmv,
                      const int32_t* bmv, const int32_t* mode,
                      int mb, uint8_t* out) {
    tc_b_mc_sel_pred2(fref, bref, h, w, fmv, bmv, mode, mb, mb,
                      out);
}

// B-picture helpers (io/mpeg2enc.py _b_native): per-MB SAD of the
// bi-directional average prediction, and the mode-based prediction
// select.  pavgb IS the MPEG (f+b+1)>>1 average, so both stay
// bit-exact with the numpy formulas they replace.

void tc_bisad(const uint8_t* fp, const uint8_t* bp,
              const uint8_t* cur, long h, long w, int32_t* sad_out) {
    long mbh = h / 16, mbw = w / 16;
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            int acc = 0;
#if defined(__SSE2__)
            __m128i vacc = _mm_setzero_si128();
            for (int r = 0; r < 16; r++) {
                long off = (by * 16 + r) * w + bx * 16;
                __m128i f = _mm_loadu_si128((const __m128i*)(fp + off));
                __m128i b = _mm_loadu_si128((const __m128i*)(bp + off));
                __m128i c = _mm_loadu_si128((const __m128i*)(cur + off));
                vacc = _mm_add_epi64(
                    vacc, _mm_sad_epu8(_mm_avg_epu8(f, b), c));
            }
            acc = _mm_cvtsi128_si32(vacc)
                  + _mm_cvtsi128_si32(_mm_srli_si128(vacc, 8));
#else
            for (int r = 0; r < 16; r++)
                for (int c = 0; c < 16; c++) {
                    long off = (by * 16 + r) * w + bx * 16 + c;
                    int p = (fp[off] + bp[off] + 1) >> 1;
                    int d = p - cur[off];
                    acc += d < 0 ? -d : d;
                }
#endif
            sad_out[by * mbw + bx] = acc;
        }
    }
}

// mode per MB: 0 = forward, 1 = backward, 2 = bi average
void tc_b_select_pred(const uint8_t* fp, const uint8_t* bp,
                      const int32_t* mode, long h, long w, int mb,
                      uint8_t* out) {
    long mbh = h / mb, mbw = w / mb;
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            int m = mode[by * mbw + bx];
            for (int r = 0; r < mb; r++) {
                long off = (by * mb + r) * w + bx * mb;
                if (m == 0) {
                    memcpy(out + off, fp + off, (size_t)mb);
                } else if (m == 1) {
                    memcpy(out + off, bp + off, (size_t)mb);
                } else {
#if defined(__SSE2__)
                    if (mb == 16) {
                        _mm_storeu_si128(
                            (__m128i*)(out + off),
                            _mm_avg_epu8(
                                _mm_loadu_si128(
                                    (const __m128i*)(fp + off)),
                                _mm_loadu_si128(
                                    (const __m128i*)(bp + off))));
                        continue;
                    }
                    if (mb == 8) {
                        _mm_storel_epi64(
                            (__m128i*)(out + off),
                            _mm_avg_epu8(
                                _mm_loadl_epi64(
                                    (const __m128i*)(fp + off)),
                                _mm_loadl_epi64(
                                    (const __m128i*)(bp + off))));
                        continue;
                    }
#endif
                    for (int c = 0; c < mb; c++)
                        out[off + c] =
                            (uint8_t)((fp[off + c] + bp[off + c] + 1)
                                      >> 1);
                }
            }
        }
    }
}

// per-16x16-MB mean-removed activity: floor(sum_i |256*x_i - S| / 256)
// where S = sum of the MB (exact integer form of the float
// sum|x - mean| used for the intra/inter decision)
void tc_mb_act(const uint8_t* plane, long h, long w,
               int32_t* act_out) {
    long mbh = h / 16, mbw = w / 16;
    for (long by = 0; by < mbh; by++) {
        for (long bx = 0; bx < mbw; bx++) {
            long s = 0;
            for (int r = 0; r < 16; r++) {
                long off = (by * 16 + r) * w + bx * 16;
#if defined(__SSE2__)
                __m128i v = _mm_loadu_si128(
                    (const __m128i*)(plane + off));
                __m128i sv = _mm_sad_epu8(v, _mm_setzero_si128());
                s += _mm_cvtsi128_si32(sv)
                     + _mm_cvtsi128_si32(_mm_srli_si128(sv, 8));
#else
                for (int c = 0; c < 16; c++) s += plane[off + c];
#endif
            }
            long acc = 0;
            for (int r = 0; r < 16; r++) {
                long off = (by * 16 + r) * w + bx * 16;
                for (int c = 0; c < 16; c++) {
                    long d = 256L * plane[off + c] - s;
                    acc += d < 0 ? -d : d;
                }
            }
            act_out[by * mbw + bx] = (int32_t)(acc / 256);
        }
    }
}

int tc_host_version() { return 6; }

}  // extern "C"
