/* fastio: the port's native host decoders for dataset files, with a plain C
 * interface loaded through ctypes (no Python.h, so no Python development
 * headers are needed to build it).
 *
 *   fastio_parse_obj     OBJ text -> float32 vertices [V,3], int64 faces [F,3]
 *   fastio_decode_rle    binvox payload of (value, count) byte pairs -> bytes
 *   fastio_png_unfilter  PNG scanlines (filter byte + row) -> raw rows
 *   fastio_png_adam7     the seven passes of an Adam7-interlaced PNG -> raw rows
 *   fastio_resample_u8   one pass of Pillow's 8-bit convolution resize
 *   fastio_free          frees what fastio_parse_obj allocated
 *
 * parse_obj and decode_rle keep the semantics of the JAX package's
 * csrc/fastio.c: polygons are strip-triangulated with a sliding window
 * ((i, i+1, i+2) for each vertex past the second, reference
 * serialization.py:117-121), runs of spaces and tabs separate tokens,
 * "v/vt/vn" references keep their vertex index, and the indices are returned
 * as written (the caller turns 1-based into 0-based). The PNG unfilter undoes
 * the five filter types of the PNG specification (section 9): None, Sub, Up,
 * Average and Paeth; Sub, Average and Paeth read the pixel to the left, which
 * is why this loop is native and not numpy. Adam7 (section 8.2) unfilters
 * each of its seven passes as an image of its own width and scatters the
 * pixels into the rows of the whole image, bit by bit below 8 bits a pixel.
 * The resample pass is Pillow's
 * ImagingResampleHorizontal_8bpc / Vertical_8bpc (libImaging/Resample.c) on
 * coefficients the caller computes: a 2^21 rounding bias, 22 fractional bits,
 * clipped to 0-255.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static int grow(void **buf, size_t *cap, size_t needed, size_t elem) {
    if (needed <= *cap) return 0;
    size_t ncap = *cap ? *cap * 2 : 1024;
    while (ncap < needed) ncap *= 2;
    void *nb = realloc(*buf, ncap * elem);
    if (!nb) return -1;
    *buf = nb;
    *cap = ncap;
    return 0;
}

/* Returns 0, or -1 when out of memory; *verts and *faces are malloc'd (NULL
 * when empty) and freed by the caller with fastio_free. */
int fastio_parse_obj(const char *data, int64_t len, float **verts_out, int64_t *n_verts,
                     int64_t **faces_out, int64_t *n_faces) {
    float *verts = NULL;
    size_t vcap = 0, vcount = 0;      /* floats */
    int64_t *faces = NULL;
    size_t fcap = 0, fcount = 0;      /* indices */
    const char *p = data;
    const char *end = data + len;
    int64_t poly[64];

    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p >= end) break;
        if (*p == 'v' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            for (int k = 0; k < 3; k++) {
                char *q;
                double val = strtod(p, &q);
                if (q == p) val = 0.0;
                p = q;
                if (grow((void **)&verts, &vcap, vcount + 1, sizeof(float)) < 0) goto nomem;
                verts[vcount++] = (float)val;
            }
        } else if (*p == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            int n = 0;
            while (p < end && *p != '\n' && n < 64) {
                while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
                if (p >= end || *p == '\n') break;
                char *q;
                long idx = strtol(p, &q, 10);
                if (q == p) break;
                p = q;
                /* skip the /texture/normal references */
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
                poly[n++] = idx;
            }
            for (int i = 0; i + 2 < n; i++) {
                if (grow((void **)&faces, &fcap, fcount + 3, sizeof(int64_t)) < 0) goto nomem;
                faces[fcount++] = poly[i];
                faces[fcount++] = poly[i + 1];
                faces[fcount++] = poly[i + 2];
            }
        }
        while (p < end && *p != '\n') p++;     /* the next line */
        if (p < end) p++;
    }
    *verts_out = verts;
    *n_verts = (int64_t)(vcount / 3);
    *faces_out = faces;
    *n_faces = (int64_t)(fcount / 3);
    return 0;
nomem:
    free(verts);
    free(faces);
    return -1;
}

void fastio_free(void *p) { free(p); }

/* Expands (value, count) pairs into out[total]; a short payload leaves zeros
 * after its last run, a long one is cut at total. Returns the bytes the
 * payload itself wrote. */
int64_t fastio_decode_rle(const uint8_t *data, int64_t len, uint8_t *out, int64_t total) {
    int64_t w = 0;
    for (int64_t i = 0; i + 1 < len && w < total; i += 2) {
        int64_t count = data[i + 1];
        if (w + count > total) count = total - w;
        memset(out + w, data[i], (size_t)count);
        w += count;
    }
    if (w < total) memset(out + w, 0, (size_t)(total - w));
    return w;
}

static uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

/* raw: height scanlines of 1 + stride bytes (the filter type, then the row);
 * out: height x stride. bpp is the bytes a pixel takes, at least 1. Returns 0,
 * or 1 + the row whose filter type is not 0-4. */
int64_t fastio_png_unfilter(const uint8_t *raw, int64_t height, int64_t stride, int64_t bpp,
                            uint8_t *out) {
    for (int64_t y = 0; y < height; y++) {
        const uint8_t *src = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y ? cur - stride : NULL;
        int64_t x;
        switch (raw[y * (stride + 1)]) {
        case 0:
            memcpy(cur, src, (size_t)stride);
            break;
        case 1:
            for (x = 0; x < stride; x++)
                cur[x] = (uint8_t)(src[x] + (x >= bpp ? cur[x - bpp] : 0));
            break;
        case 2:
            for (x = 0; x < stride; x++)
                cur[x] = (uint8_t)(src[x] + (up ? up[x] : 0));
            break;
        case 3:
            for (x = 0; x < stride; x++) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (x = 0; x < stride; x++) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                cur[x] = (uint8_t)(src[x] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}

/* in: [outer, n_in, inner] uint8; out: [outer, n_out, inner]. Output position
 * x sums taps start[x] .. start[x] + len[x] - 1 of the middle axis with the
 * fixed-point weights k[x * ksize + j]. Returns 0, or -1 when out of memory. */
int fastio_resample_u8(const uint8_t *in, int64_t outer, int64_t n_in, int64_t inner,
                       const int64_t *start, const int64_t *len, const int32_t *k,
                       int64_t ksize, int64_t n_out, uint8_t *out) {
    int64_t *acc = malloc((size_t)inner * sizeof(int64_t));
    if (!acc) return -1;
    for (int64_t o = 0; o < outer; o++) {
        for (int64_t x = 0; x < n_out; x++) {
            const uint8_t *base = in + (o * n_in + start[x]) * inner;
            const int32_t *kx = k + x * ksize;
            uint8_t *dst = out + (o * n_out + x) * inner;
            for (int64_t i = 0; i < inner; i++) acc[i] = 1 << 21;
            for (int64_t j = 0; j < len[x]; j++) {
                const uint8_t *row = base + j * inner;
                int64_t kj = kx[j];
                for (int64_t i = 0; i < inner; i++) acc[i] += row[i] * kj;
            }
            for (int64_t i = 0; i < inner; i++) {
                int64_t v = acc[i] >> 22;
                dst[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    free(acc);
    return 0;
}

/* raw: len bytes of the seven passes' scanlines, the empty passes left out;
 * out: height rows of (width * bits + 7) / 8 bytes, bits being a pixel's.
 * Returns 0, -1 when raw is too short, -2 when out of memory, or 1 + the
 * scanline (counted over all passes) whose filter type is not 0-4. */
int64_t fastio_png_adam7(const uint8_t *raw, int64_t len, int64_t width, int64_t height,
                         int64_t bits, uint8_t *out) {
    static const int x0[7] = {0, 4, 0, 2, 0, 1, 0}, y0[7] = {0, 0, 4, 0, 2, 0, 1};
    static const int dx[7] = {8, 8, 4, 4, 2, 2, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
    int64_t stride = (width * bits + 7) / 8, bpp = bits >= 8 ? bits / 8 : 1, pos = 0, line = 0;
    memset(out, 0, (size_t)(height * stride));
    /* no pass has more than width pixels a row and (height + 1) / 2 rows */
    uint8_t *pass = malloc((size_t)(stride * ((height + 1) / 2) + 1));
    if (!pass) return -2;
    for (int p = 0; p < 7; p++) {
        int64_t pw = width > x0[p] ? (width - x0[p] + dx[p] - 1) / dx[p] : 0;
        int64_t ph = height > y0[p] ? (height - y0[p] + dy[p] - 1) / dy[p] : 0;
        if (pw == 0 || ph == 0) continue;
        int64_t pstride = (pw * bits + 7) / 8;
        if (pos + ph * (pstride + 1) > len) {
            free(pass);
            return -1;
        }
        int64_t bad = fastio_png_unfilter(raw + pos, ph, pstride, bpp, pass);
        if (bad) {
            free(pass);
            return line + bad;
        }
        for (int64_t r = 0; r < ph; r++) {
            const uint8_t *src = pass + r * pstride;
            uint8_t *dst = out + (y0[p] + r * dy[p]) * stride;
            for (int64_t i = 0; i < pw; i++) {
                int64_t x = x0[p] + i * dx[p];
                if (bits >= 8) {
                    memcpy(dst + x * bpp, src + i * bpp, (size_t)bpp);
                } else {
                    int64_t si = i * bits, di = x * bits;
                    int v = (src[si / 8] >> (8 - bits - si % 8)) & ((1 << bits) - 1);
                    dst[di / 8] |= (uint8_t)(v << (8 - bits - di % 8));
                }
            }
        }
        pos += ph * (pstride + 1);
        line += ph;
    }
    free(pass);
    return 0;
}
