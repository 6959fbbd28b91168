/* jpeg: the port's JPEG decoder, with a plain C interface loaded through
 * ctypes (data/fastio.decode_jpeg). It computes what Pillow's decoder gives
 * on a Pillow built on libjpeg-turbo 3.1, which decodes with libjpeg's
 * defaults: the accurate integer IDCT (jidctint.c jpeg_idct_islow), fancy
 * upsampling (jdsample.c), block smoothing (jdcoefct.c), no DCT scaling, no
 * draft mode.
 *
 *   jpeg_decode   a whole file -> uint8 [height, width, components]
 *
 * The stages are libjpeg-turbo's, ported for what they compute, not block
 * by block:
 *   markers       SOI, APPn and COM (skipped; APP0 JFIF and APP14 Adobe are
 *                 read for the colour space), DQT with 8- and 16-bit tables,
 *                 DHT, DAC, SOF0/1/2/3/9/10 at 8-bit precision, DRI, RST0-7,
 *                 SOS, EOI (jdmarker.c)
 *   entropy       sequential Huffman (jdhuff.c), progressive Huffman
 *                 (jdphuff.c: DC first and refine, AC first and refine with
 *                 EOB runs) and arithmetic coding, sequential and progressive
 *                 (jdarith.c, with the DAC conditioning and the Qe table of
 *                 the JPEG specification, Table D.2), interleaved and
 *                 single-component scans, restart markers with libjpeg's
 *                 resynchronisation
 *   lossless      SOF3 (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
 *                 differences, predictors 1-7, the point transform, restarts
 *                 at whole MCU rows; no colour conversion and no fancy
 *                 upsampling, as libjpeg-turbo decodes such a frame
 *   smoothing     a progressive image whose scans leave some of the first
 *                 nine AC coefficients short of their last bit has them
 *                 estimated from the DC values of the 5x5 blocks around
 *                 (jdcoefct.c decompress_smooth_data); with no AC data at all
 *                 the DC value too
 *   IDCT          jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) in the 16-bit
 *                 arithmetic of libjpeg-turbo's x86 SIMD version, which Pillow
 *                 runs: equal to the C version on valid files, and on corrupt
 *                 ones equal to Pillow
 *   upsampling    full size, h2v1, h2v2 and h1v2 (4:4:0) fancy (triangle)
 *                 filters with their edge rules, and replication for the other
 *                 integral ratios (int_upsample, and h2v1 / h2v2 on a plane of
 *                 width <= 2)
 *   colour        YCbCr -> RGB (jdcolor.c ycc_rgb_convert, 16-bit fixed point)
 *                 and YCCK -> CMYK; grey, RGB and CMYK pass through
 *
 * Where libjpeg would stop with an error, or would run out of data before
 * the last scanline (Pillow raises OSError for both), jpeg_decode returns
 * JPEG_DAMAGED: hierarchical frames, samples of other than 8 bits,
 * fractional sampling ratios among them. Which truncated files still give
 * every scanline depends on how far libjpeg reads ahead: its bit reader
 * fills 57 bits at a time, it decodes an MCU through a faster reader when
 * 512 bytes a block are left in the buffer, and Pillow hands it the file in
 * 64 KiB reads. All three are reproduced. The arithmetic decoder cannot
 * suspend: where its data runs past the end of a read, libjpeg stops (so
 * Pillow reads no arithmetic-coded scan that crosses a 64 KiB boundary of
 * the file), and so on a lossless frame with arithmetic coding (SOF11),
 * which libjpeg-turbo does not decode. A message names the fault.
 */
#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { JPEG_OK = 0, JPEG_DAMAGED = 1, JPEG_NO_MEMORY = 3 };
enum { REACHED_SOS = 1, REACHED_EOI = 2 };

#define CHUNK 65536            /* Pillow's reads (ImageFile.MAXBLOCK) */
#define MIN_GET_BITS 57        /* a 64-bit bit buffer less 7 (jdhuff.h) */
#define LOOKAHEAD 8
#define FAST_BYTES 512         /* jdhuff.c BUFSIZE: bytes a block for the fast reader */
#define MAX_COMPS 4
#define MAX_BLOCKS 10          /* D_MAX_BLOCKS_IN_MCU */
#define ARITH_TBLS 16          /* NUM_ARITH_TBLS */
#define SAVED_COEFS 10         /* jdcoefct.c: the DC and the first 9 AC coefficients */

/* zigzag index -> natural index, with libjpeg's 16 spare entries for
 * corrupt data that runs past coefficient 63 */
static const int natural_order[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {               /* a DHT table as the file gives it */
    uint8_t bits[17];
    uint8_t vals[256];
    int defined;
} HuffSpec;

typedef struct {               /* jdhuff.c d_derived_tbl */
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t lookup[1 << LOOKAHEAD];   /* (code length << 8) | symbol, 9 << 8 if longer */
    uint8_t vals[256];
} Huff;

typedef enum { UP_FULL, UP_H2V1, UP_H2V2, UP_H1V2, UP_REPLICATE } Upsample;

typedef struct {
    int id, h, v, tq, dc_tbl, ac_tbl;
    int bw, bh;                /* width_in_blocks, height_in_blocks */
    int aw, ah;                /* blocks held: whole MCUs of an interleaved scan */
    int dw, dh;                /* downsampled_width, downsampled_height */
    int16_t *coef;             /* aw * ah blocks of 64 coefficients, natural order */
    int16_t qt[64];            /* the table latched at the component's first scan */
    uint16_t qt_raw[64];
    int latched;
    int coef_bits[64];         /* progressive: Al last sent per coefficient, -1 never */
    int prev_coef_bits[SAVED_COEFS];   /* coef_bits before the component's latest scan */
    uint8_t *plane;            /* bw * 8 x bh * 8 samples after the IDCT */
    int32_t *diff, *undiff;    /* lossless: aw x ah differences and their samples */
    int lossless_al;           /* lossless: the point transform of the component's scan */
    Upsample up;
    int hr, vr;                /* replication factors */
} Comp;

typedef struct {               /* what an entropy decoder's suspension restores */
    int64_t pos;
    uint64_t get_buffer;
    int bits_left;
    int unread_marker;
    int insufficient;
    int last_dc[MAX_COMPS];
    unsigned eobrun;
    int restarts_to_go;
    int next_restart;
} State;

typedef struct {               /* jdarith.c arith_entropy_decoder */
    int64_t c, a;              /* the C and A registers */
    int ct;                    /* bits left in C's buffer; -16 at a start, -1 after an error */
    int dc_context[MAX_COMPS];
    uint8_t dc_stats[ARITH_TBLS][64], ac_stats[ARITH_TBLS][256];
    uint8_t fixed_bin;         /* the fixed 0.5 probability state */
} Arith;

typedef struct {
    const uint8_t *data;
    int64_t len, limit;        /* limit: the end of the bytes libjpeg has been given */
    State s;
    jmp_buf fail, trailer_jb;
    int in_trailer;
    int status;
    char *msg;
    int64_t msg_cap;

    int saw_soi, saw_sof, progressive, arith, lossless, precision;
    int width, height, ncomp, hmax, vmax;
    Comp comp[MAX_COMPS];
    int qt_defined[4];
    uint16_t qt[4][64];
    HuffSpec dc_spec[4], ac_spec[4];
    int restart_interval;
    uint8_t dc_L[ARITH_TBLS], dc_U[ARITH_TBLS], ac_K[ARITH_TBLS];   /* DAC conditioning */
    Arith ar;
    int scan_number;           /* input_scan_number: the SOS markers read */
    int imcu_rows, last_good;  /* total_iMCU_rows; last_good_iMCU_row */
    int latch[MAX_COMPS][SAVED_COEFS], prev_latch[MAX_COMPS][SAVED_COEFS];
    int smooth;                /* smoothing_ok */
    int rows_to_go;            /* lossless: MCU rows left in the restart interval */
    int saw_jfif, saw_adobe, adobe_transform;
    int colour;                /* 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK */

    int ncs, cs[MAX_COMPS];    /* the scan's components, by index */
    int Ss, Se, Ah, Al;
    int mcus_per_row, mcu_rows, blocks_in_mcu, membership[MAX_BLOCKS];
    Huff dc_tab[4], ac_tab[4];
    Huff *dc_cur[MAX_BLOCKS], *ac_cur[MAX_BLOCKS];
    int16_t *blocks[MAX_BLOCKS];
    uint8_t *rows[MAX_COMPS];  /* one upsampled row of each component */
} Dec;

static void fail(Dec *d, int status, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->msg, (size_t)d->msg_cap, fmt, ap);
    va_end(ap);
    d->status = status;
    longjmp(d->fail, 1);
}

/* Out of data inside a marker segment: more of the file would be read, so
 * the file is truncated; after a single-scan image's last MCU it only ends
 * the reading of the trailing markers, which Pillow ignores. */
static void suspend(Dec *d) {
    if (d->in_trailer) longjmp(d->trailer_jb, 1);
    fail(d, JPEG_DAMAGED, "the file ends before the image data does");
}

static void *zalloc(Dec *d, size_t n) {
    void *p = calloc(n ? n : 1, 1);
    if (!p) fail(d, JPEG_NO_MEMORY, "out of memory");
    return p;
}

/* ---- markers (jdmarker.c) ---------------------------------------------- */

/* Pillow's next 64 KiB read: where libjpeg's marker reader runs out of what
 * it was given, it suspends and Pillow calls it again with more. Nothing
 * more is read once the last scanline is out (jpeg_finish_decompress). */
static int more_data(Dec *d) {
    if (d->in_trailer || d->limit >= d->len) return 0;
    d->limit = d->limit + CHUNK < d->len ? d->limit + CHUNK : d->len;
    return 1;
}

static int next_byte(Dec *d) {
    while (d->s.pos >= d->limit)
        if (!more_data(d)) suspend(d);
    return d->data[d->s.pos++];
}

static int read_u16(Dec *d) {
    int hi = next_byte(d);
    return (hi << 8) | next_byte(d);
}

static void skip_bytes(Dec *d, int64_t n) {
    if (n <= 0) return;
    while (d->s.pos + n > d->limit)
        if (!more_data(d)) {
            d->s.pos = d->limit;
            suspend(d);
        }
    d->s.pos += n;
}

/* The next marker code into unread_marker, skipping anything that is not
 * one; 0 when the data runs out first. */
static int next_marker(Dec *d) {
    for (;;) {
        int c;
        do {
            if (d->s.pos >= d->limit) return 0;
            c = d->data[d->s.pos++];
        } while (c != 0xFF);
        do {
            if (d->s.pos >= d->limit) return 0;
            c = d->data[d->s.pos++];
        } while (c == 0xFF);
        if (c != 0) {
            d->s.unread_marker = c;
            return 1;
        }
    }
}

static void get_sof(Dec *d, int progressive, int arith) {
    if (d->saw_sof) fail(d, JPEG_DAMAGED, "a second frame header (SOF)");
    int length = read_u16(d);
    d->precision = next_byte(d);
    d->height = read_u16(d);
    d->width = read_u16(d);
    d->ncomp = next_byte(d);
    length -= 8;
    if (d->height <= 0 || d->width <= 0 || d->ncomp <= 0)
        fail(d, JPEG_DAMAGED, "an empty image (%dx%d, %d components)", d->width, d->height,
             d->ncomp);
    if (length != d->ncomp * 3) fail(d, JPEG_DAMAGED, "a frame header of the wrong length");
    if (d->ncomp > MAX_COMPS) fail(d, JPEG_DAMAGED, "%d components", d->ncomp);
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        c->id = next_byte(d);
        int f = next_byte(d);
        c->h = (f >> 4) & 15;
        c->v = f & 15;
        c->tq = next_byte(d);
    }
    if (d->precision != 8) fail(d, JPEG_DAMAGED, "%d-bit samples", d->precision);
    d->saw_sof = 1;
    d->progressive = progressive;
    d->arith = arith;
}

static void get_sos(Dec *d) {
    if (!d->saw_sof) fail(d, JPEG_DAMAGED, "a scan before the frame header");
    int length = read_u16(d);
    int n = next_byte(d);
    if (length != n * 2 + 6 || n < 1 || n > MAX_COMPS)
        fail(d, JPEG_DAMAGED, "a scan header of the wrong length");
    int slot[MAX_COMPS] = {-1, -1, -1, -1};
    d->ncs = n;
    for (int i = 0; i < n; i++) {
        int cc = next_byte(d), f = next_byte(d), ci;
        /* libjpeg's test: the component's id matches and the scan slot of its
         * index is still empty */
        for (ci = 0; ci < d->ncomp && ci < MAX_COMPS; ci++)
            if (cc == d->comp[ci].id && slot[ci] < 0) break;
        if (ci == d->ncomp || ci == MAX_COMPS)
            fail(d, JPEG_DAMAGED, "a scan names component %d, which the frame lacks", cc);
        for (int pi = 0; pi < i; pi++)
            if (slot[pi] == ci) fail(d, JPEG_DAMAGED, "a scan names component %d twice", cc);
        slot[i] = ci;
        d->cs[i] = ci;
        d->comp[ci].dc_tbl = (f >> 4) & 15;
        d->comp[ci].ac_tbl = f & 15;
    }
    d->Ss = next_byte(d);
    d->Se = next_byte(d);
    int a = next_byte(d);
    d->Ah = (a >> 4) & 15;
    d->Al = a & 15;
    d->s.next_restart = 0;
    d->scan_number++;
}

static void get_dht(Dec *d) {
    int length = read_u16(d) - 2;
    while (length > 16) {
        int index = next_byte(d), count = 0;
        uint8_t bits[17];
        bits[0] = 0;
        for (int i = 1; i <= 16; i++) {
            bits[i] = (uint8_t)next_byte(d);
            count += bits[i];
        }
        length -= 17;
        if (count > 256 || count > length) fail(d, JPEG_DAMAGED, "a bad Huffman table");
        uint8_t vals[256] = {0};
        for (int i = 0; i < count; i++) vals[i] = (uint8_t)next_byte(d);
        length -= count;
        HuffSpec *spec;
        if (index & 0x10) {
            index -= 0x10;
            if (index >= 4) fail(d, JPEG_DAMAGED, "Huffman table index %d", index);
            spec = &d->ac_spec[index];
        } else {
            if (index >= 4) fail(d, JPEG_DAMAGED, "Huffman table index %d", index);
            spec = &d->dc_spec[index];
        }
        memcpy(spec->bits, bits, sizeof bits);
        memcpy(spec->vals, vals, sizeof vals);
        spec->defined = 1;
    }
    if (length != 0) fail(d, JPEG_DAMAGED, "a Huffman table segment of the wrong length");
}

static void get_dqt(Dec *d) {
    int length = read_u16(d) - 2;
    while (length > 0) {
        int n = next_byte(d), prec = n >> 4;
        n &= 15;
        if (n >= 4) fail(d, JPEG_DAMAGED, "quantisation table index %d", n);
        for (int i = 0; i < 64; i++)
            d->qt[n][natural_order[i]] = (uint16_t)(prec ? read_u16(d) : next_byte(d));
        d->qt_defined[n] = 1;
        length -= 65;
        if (prec) length -= 64;
    }
    if (length != 0) fail(d, JPEG_DAMAGED, "a quantisation table segment of the wrong length");
}

/* APP0 and APP14: the first 14 bytes tell JFIF and Adobe's transform */
static void get_interesting_appn(Dec *d, int marker) {
    int length = read_u16(d) - 2;
    int n = length >= 14 ? 14 : (length > 0 ? length : 0);
    uint8_t b[14];
    for (int i = 0; i < n; i++) b[i] = (uint8_t)next_byte(d);
    length -= n;
    if (marker == 0xE0 && n >= 14 && memcmp(b, "JFIF", 5) == 0) d->saw_jfif = 1;
    if (marker == 0xEE && n >= 12 && memcmp(b, "Adobe", 5) == 0) {
        d->saw_adobe = 1;
        d->adobe_transform = b[11];
    }
    skip_bytes(d, length);
}

/* get_dac: the arithmetic decoder's conditioning, L and U of a DC table
 * and K of an AC table */
static void get_dac(Dec *d) {
    int length = read_u16(d) - 2;
    while (length > 0) {
        int index = next_byte(d), val = next_byte(d);
        length -= 2;
        if (index >= 2 * ARITH_TBLS) fail(d, JPEG_DAMAGED, "DAC table index %d", index);
        if (index >= ARITH_TBLS) {
            d->ac_K[index - ARITH_TBLS] = (uint8_t)val;
        } else {
            d->dc_L[index] = (uint8_t)(val & 15);
            d->dc_U[index] = (uint8_t)(val >> 4);
            if (d->dc_L[index] > d->dc_U[index]) fail(d, JPEG_DAMAGED, "DAC value %d", val);
        }
    }
    if (length != 0) fail(d, JPEG_DAMAGED, "a DAC segment of the wrong length");
}

/* next_marker as read_markers calls it: where the data runs out, Pillow's
 * next read, and the search again from where it started */
static int next_marker_or_more(Dec *d) {
    for (;;) {
        int64_t at = d->s.pos;
        if (next_marker(d)) return 1;
        if (!more_data(d)) return 0;
        d->s.pos = at;
    }
}

static int read_markers(Dec *d) {
    for (;;) {
        if (d->s.unread_marker == 0) {
            if (!d->saw_soi) {
                int c = next_byte(d), c2 = next_byte(d);
                if (c != 0xFF || c2 != 0xD8) fail(d, JPEG_DAMAGED, "no SOI marker");
                d->s.unread_marker = c2;
            } else if (!next_marker_or_more(d)) {
                suspend(d);
            }
        }
        int m = d->s.unread_marker;
        if (((m >= 0xC0 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB)
             || (m >= 0xCD && m <= 0xCF)) && d->saw_sof)
            fail(d, JPEG_DAMAGED, "a second frame header (SOF%d)", m - 0xC0);
        switch (m) {
        case 0xD8:
            if (d->saw_soi) fail(d, JPEG_DAMAGED, "a second SOI marker");
            d->saw_soi = 1;
            d->restart_interval = 0;
            d->saw_jfif = d->saw_adobe = d->adobe_transform = 0;
            for (int i = 0; i < ARITH_TBLS; i++) {      /* get_soi */
                d->dc_L[i] = 0;
                d->dc_U[i] = 1;
                d->ac_K[i] = 5;
            }
            break;
        case 0xC0: case 0xC1: get_sof(d, 0, 0); break;
        case 0xC2: get_sof(d, 1, 0); break;
        case 0xC9: get_sof(d, 0, 1); break;
        case 0xCA: get_sof(d, 1, 1); break;
        case 0xC3:
            get_sof(d, 0, 0);
            d->lossless = 1;
            break;
        case 0xCB:          /* libjpeg-turbo decodes lossless frames with Huffman coding only */
            fail(d, JPEG_DAMAGED, "lossless JPEG with arithmetic coding (SOF11)");
            break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
            fail(d, JPEG_DAMAGED, "a hierarchical frame (SOF%d), which libjpeg does not decode",
                 m - 0xC0);
            break;
        case 0xDA:
            get_sos(d);
            d->s.unread_marker = 0;
            return REACHED_SOS;
        case 0xD9:
            d->s.unread_marker = 0;
            return REACHED_EOI;
        case 0xC4: get_dht(d); break;
        case 0xDB: get_dqt(d); break;
        case 0xDD:
            if (read_u16(d) != 4) fail(d, JPEG_DAMAGED, "a DRI segment of the wrong length");
            d->restart_interval = read_u16(d);
            break;
        case 0xE0: case 0xEE: get_interesting_appn(d, m); break;
        case 0xCC: get_dac(d); break;
        case 0xDC: case 0xFE:
        case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6: case 0xE7:
        case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC: case 0xED: case 0xEF:
            skip_bytes(d, read_u16(d) - 2);
            break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
            break;
        default:
            fail(d, JPEG_DAMAGED, "unknown marker 0x%02X", m);
        }
        d->s.unread_marker = 0;
    }
}

/* ---- Huffman decoding (jdhuff.c) ----------------------------------------- */

/* The standard tables of the JPEG specification, section K.3 (jstdhuff.c):
 * [is_dc][table] */
static const uint8_t std_bits[2][2][17] = {
    {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
     {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}},
    {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}},
};
static const uint8_t std_dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t std_ac_luminance[162] = {
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161,
    8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24, 25, 26,
    37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83,
    84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118,
    119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150,
    151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181,
    182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212,
    213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241,
    242, 243, 244, 245, 246, 247, 248, 249, 250
};
static const uint8_t std_ac_chrominance[162] = {
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66,
    145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37, 241,
    23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73,
    74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116,
    117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147,
    148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178,
    179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202,
    210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233,
    234, 242, 243, 244, 245, 246, 247, 248, 249, 250
};

/* jinit_huff_decoder's std_huff_tables: a sequential frame's DC and AC
 * tables 0 and 1 that no DHT has defined by the first scan are the
 * standard ones, as a Motion-JPEG frame needs; a progressive frame gets
 * none */
static void put_std_tables(Dec *d) {
    for (int is_dc = 0; is_dc < 2; is_dc++)
        for (int tblno = 0; tblno < 2; tblno++) {
            HuffSpec *spec = is_dc ? &d->dc_spec[tblno] : &d->ac_spec[tblno];
            if (spec->defined) continue;
            memcpy(spec->bits, std_bits[is_dc][tblno], 17);
            memset(spec->vals, 0, 256);
            if (is_dc)
                memcpy(spec->vals, std_dc_vals, sizeof std_dc_vals);
            else
                memcpy(spec->vals, tblno ? std_ac_chrominance : std_ac_luminance, 162);
            spec->defined = 1;
        }
}

static void make_table(Dec *d, int is_dc, int tblno, Huff *t) {
    if (tblno >= 4) fail(d, JPEG_DAMAGED, "Huffman table index %d", tblno);
    HuffSpec *spec = is_dc ? &d->dc_spec[tblno] : &d->ac_spec[tblno];
    if (!spec->defined) fail(d, JPEG_DAMAGED, "a scan without its Huffman table %d", tblno);
    char size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int i = spec->bits[l];
        if (p + i > 256) fail(d, JPEG_DAMAGED, "a bad Huffman table");
        while (i--) size[p++] = (char)l;
    }
    size[p] = 0;
    int nsym = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si) {
            code_of[p++] = code;
            code++;
        }
        if (code >= (1u << si)) fail(d, JPEG_DAMAGED, "a bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (spec->bits[l]) {
            t->valoffset[l] = p - (int32_t)code_of[p];
            p += spec->bits[l];
            t->maxcode[l] = (int32_t)code_of[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    for (int i = 0; i < (1 << LOOKAHEAD); i++) t->lookup[i] = (LOOKAHEAD + 1) << LOOKAHEAD;
    p = 0;
    for (int l = 1; l <= LOOKAHEAD; l++)
        for (int i = 1; i <= spec->bits[l]; i++, p++) {
            int look = (int)(code_of[p] << (LOOKAHEAD - l));
            for (int ctr = 1 << (LOOKAHEAD - l); ctr > 0; ctr--)
                t->lookup[look++] = (uint16_t)((l << LOOKAHEAD) | spec->vals[p]);
        }
    memcpy(t->vals, spec->vals, 256);
    if (is_dc)
        for (int i = 0; i < nsym; i++)       /* 16 codes a lossless difference of 32768 */
            if (spec->vals[i] > (d->lossless ? 16 : 15))
                fail(d, JPEG_DAMAGED, "a bad DC Huffman table");
}

/* jpeg_fill_bit_buffer: load bytes until 57 bits are buffered or a marker is
 * met; past a marker, feed zeros when more than the buffered bits are
 * needed. 0 when the data runs out first (libjpeg suspends). */
static int fill(Dec *d, int nbits) {
    State *s = &d->s;
    if (s->unread_marker == 0) {
        while (s->bits_left < MIN_GET_BITS) {
            if (s->pos >= d->limit) return 0;
            int c = d->data[s->pos++];
            if (c == 0xFF) {
                do {
                    if (s->pos >= d->limit) return 0;
                    c = d->data[s->pos++];
                } while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    s->unread_marker = c;
                    goto no_more_bytes;
                }
            }
            s->get_buffer = (s->get_buffer << 8) | (uint64_t)c;
            s->bits_left += 8;
        }
        return 1;
    }
no_more_bytes:
    if (nbits > s->bits_left) {
        s->insufficient = 1;
        s->get_buffer <<= MIN_GET_BITS - s->bits_left;
        s->bits_left = MIN_GET_BITS;
    }
    return 1;
}

#define CHECK_BITS(d, n, failure) \
    if ((d)->s.bits_left < (n) && !fill((d), (n))) { failure; }
#define GET_BITS(d, n) \
    ((int)((d)->s.get_buffer >> ((d)->s.bits_left -= (n))) & ((1 << (n)) - 1))
#define PEEK_BITS(d, n) ((int)((d)->s.get_buffer >> ((d)->s.bits_left - (n))) & ((1 << (n)) - 1))
#define EXTEND(r, n) ((r) < (1 << ((n) - 1)) ? (r) - (1 << (n)) + 1 : (r))

/* HUFF_DECODE / jpeg_huff_decode: a symbol, or -1 when the data runs out */
static int huff_decode(Dec *d, const Huff *t) {
    int nb;
    if (d->s.bits_left < LOOKAHEAD) {
        if (!fill(d, 0)) return -1;
        if (d->s.bits_left < LOOKAHEAD) {
            nb = 1;
            goto slow;
        }
    }
    {
        int look = t->lookup[PEEK_BITS(d, LOOKAHEAD)];
        nb = look >> LOOKAHEAD;
        if (nb <= LOOKAHEAD) {
            d->s.bits_left -= nb;
            return look & 0xFF;
        }
    }
slow:
    CHECK_BITS(d, nb, return -1);
    int32_t code = GET_BITS(d, nb);
    while (code > t->maxcode[nb]) {
        code <<= 1;
        CHECK_BITS(d, 1, return -1);
        code |= GET_BITS(d, 1);
        nb++;
    }
    if (nb > 16) return 0;
    return t->vals[(code + t->valoffset[nb]) & 0xFF];
}

/* decode_mcu_slow: 0 when the data runs out */
static int decode_mcu_slow(Dec *d) {
    for (int b = 0; b < d->blocks_in_mcu; b++) {
        int16_t *blk = d->blocks[b];
        int s = huff_decode(d, d->dc_cur[b]);
        if (s < 0) return 0;
        if (s) {
            CHECK_BITS(d, s, return 0);
            int r = GET_BITS(d, s);
            s = EXTEND(r, s);
        }
        int ci = d->membership[b];
        d->s.last_dc[ci] = (int)((unsigned)d->s.last_dc[ci] + (unsigned)s);
        blk[0] = (int16_t)d->s.last_dc[ci];
        for (int k = 1; k < 64; k++) {
            s = huff_decode(d, d->ac_cur[b]);
            if (s < 0) return 0;
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                CHECK_BITS(d, s, return 0);
                r = GET_BITS(d, s);
                blk[natural_order[k]] = (int16_t)EXTEND(r, s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }
    return 1;
}

/* FILL_BIT_BUFFER_FAST: six bytes when 16 bits or fewer are left; at a
 * marker, zero bytes and unread_marker set (the MCU is then decoded again
 * by the slow reader) */
static void fill_fast(Dec *d) {
    State *s = &d->s;
    if (s->bits_left > 16) return;
    for (int i = 0; i < 6; i++) {
        int c0 = d->data[s->pos++];
        /* 512 bytes a block remain, so this never reads past the end; if it
         * did, a marker would send the MCU to the slow reader */
        int c1 = s->pos < d->len ? d->data[s->pos] : 0xD9;
        s->get_buffer = (s->get_buffer << 8) | (uint64_t)c0;
        s->bits_left += 8;
        if (c0 == 0xFF) {
            s->pos++;
            if (c1 != 0) {
                s->unread_marker = c1;
                s->pos -= 2;
                s->get_buffer &= ~(uint64_t)0xFF;
            }
        }
    }
}

static int huff_decode_fast(Dec *d, const Huff *t) {
    fill_fast(d);
    int s = t->lookup[PEEK_BITS(d, LOOKAHEAD)];
    int nb = s >> LOOKAHEAD;
    d->s.bits_left -= nb;
    s &= 0xFF;
    if (nb > LOOKAHEAD) {
        s = (int)(d->s.get_buffer >> d->s.bits_left) & ((1 << nb) - 1);
        while (s > t->maxcode[nb]) {
            s <<= 1;
            s |= GET_BITS(d, 1);
            nb++;
        }
        s = nb > 16 ? 0 : t->vals[(s + t->valoffset[nb]) & 0xFF];
    }
    return s;
}

/* decode_mcu_fast: the same values; only how far ahead it reads differs */
static void decode_mcu_fast(Dec *d) {
    for (int b = 0; b < d->blocks_in_mcu; b++) {
        int16_t *blk = d->blocks[b];
        int s = huff_decode_fast(d, d->dc_cur[b]);
        if (s) {
            fill_fast(d);
            int r = GET_BITS(d, s);
            s = EXTEND(r, s);
        }
        int ci = d->membership[b];
        d->s.last_dc[ci] = (int)((unsigned)d->s.last_dc[ci] + (unsigned)s);
        blk[0] = (int16_t)d->s.last_dc[ci];
        for (int k = 1; k < 64; k++) {
            s = huff_decode_fast(d, d->ac_cur[b]);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                fill_fast(d);
                r = GET_BITS(d, s);
                blk[natural_order[k]] = (int16_t)EXTEND(r, s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }
}

/* jpeg_resync_to_restart */
static int resync(Dec *d, int desired) {
    int marker = d->s.unread_marker;
    for (;;) {
        int action;
        if (marker < 0xC0)
            action = 2;
        else if (marker < 0xD0 || marker > 0xD7)
            action = 3;
        else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
            action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
            action = 2;
        else
            action = 1;
        if (action == 1) {
            d->s.unread_marker = 0;
            return 1;
        }
        if (action == 3) return 1;
        if (!next_marker(d)) return 0;
        marker = d->s.unread_marker;
    }
}

/* process_restart: 0 when the data runs out */
static int process_restart(Dec *d) {
    d->s.bits_left = 0;
    if (d->s.unread_marker == 0 && !next_marker(d)) return 0;
    if (d->s.unread_marker == 0xD0 + d->s.next_restart)
        d->s.unread_marker = 0;
    else if (!resync(d, d->s.next_restart))
        return 0;
    d->s.next_restart = (d->s.next_restart + 1) & 7;
    for (int i = 0; i < d->ncs; i++) d->s.last_dc[i] = 0;
    d->s.eobrun = 0;
    d->s.restarts_to_go = d->restart_interval;
    if (d->s.unread_marker == 0) d->s.insufficient = 0;
    return 1;
}

/* ---- progressive Huffman decoding (jdphuff.c) ---------------------------- */

static int decode_dc_first(Dec *d) {
    for (int b = 0; b < d->blocks_in_mcu; b++) {
        int ci = d->membership[b];
        int s = huff_decode(d, d->dc_cur[b]);
        if (s < 0) return 0;
        if (s) {
            CHECK_BITS(d, s, return 0);
            int r = GET_BITS(d, s);
            s = EXTEND(r, s);
        }
        int last = d->s.last_dc[ci];
        if ((last >= 0 && s > INT32_MAX - last) || (last < 0 && s < INT32_MIN - last))
            fail(d, JPEG_DAMAGED, "a DC coefficient out of range");
        d->s.last_dc[ci] = last + s;
        d->blocks[b][0] = (int16_t)((unsigned)d->s.last_dc[ci] << d->Al);
    }
    return 1;
}

static int decode_dc_refine(Dec *d) {
    int p1 = 1 << d->Al;
    for (int b = 0; b < d->blocks_in_mcu; b++) {
        CHECK_BITS(d, 1, return 0);
        if (GET_BITS(d, 1)) d->blocks[b][0] = (int16_t)(d->blocks[b][0] | p1);
    }
    return 1;
}

static int decode_ac_first(Dec *d) {
    if (d->s.eobrun > 0) {
        d->s.eobrun--;
        return 1;
    }
    int16_t *blk = d->blocks[0];
    const Huff *t = d->ac_cur[0];
    for (int k = d->Ss; k <= d->Se; k++) {
        int s = huff_decode(d, t);
        if (s < 0) return 0;
        int r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            CHECK_BITS(d, s, return 0);
            r = GET_BITS(d, s);
            blk[natural_order[k]] = (int16_t)((unsigned)EXTEND(r, s) << d->Al);
        } else if (r == 15) {
            k += 15;
        } else {
            unsigned eobrun = 1u << r;
            if (r) {
                CHECK_BITS(d, r, return 0);
                eobrun += (unsigned)GET_BITS(d, r);
            }
            d->s.eobrun = eobrun - 1;
            break;
        }
    }
    return 1;
}

static int decode_ac_refine(Dec *d) {
    int p1 = 1 << d->Al, m1 = (int)(~0u << d->Al);
    int16_t *blk = d->blocks[0];
    const Huff *t = d->ac_cur[0];
    int k = d->Ss;
    unsigned eobrun = d->s.eobrun;
    if (eobrun == 0) {
        for (; k <= d->Se; k++) {
            int s = huff_decode(d, t);
            if (s < 0) return 0;
            int r = s >> 4;
            s &= 15;
            if (s) {
                CHECK_BITS(d, 1, return 0);
                s = GET_BITS(d, 1) ? p1 : m1;
            } else if (r != 15) {
                eobrun = 1u << r;
                if (r) {
                    CHECK_BITS(d, r, return 0);
                    eobrun += (unsigned)GET_BITS(d, r);
                }
                break;
            }
            do {
                int16_t *coef = blk + natural_order[k];
                if (*coef != 0) {
                    CHECK_BITS(d, 1, return 0);
                    if (GET_BITS(d, 1) && (*coef & p1) == 0)
                        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= d->Se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (eobrun > 0) {
        for (; k <= d->Se; k++) {
            int16_t *coef = blk + natural_order[k];
            if (*coef != 0) {
                CHECK_BITS(d, 1, return 0);
                if (GET_BITS(d, 1) && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
        }
        eobrun--;
    }
    d->s.eobrun = eobrun;
    return 1;
}

/* ---- arithmetic decoding (jdarith.c) ------------------------------------ */

/* jpeg_aritab (jaricom.c), the JPEG specification's Table D.2: per state,
 * Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state
 * 113 is the fixed 0.5 probability */
static const uint32_t aritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171
};

/* get_byte: libjpeg's arithmetic decoder cannot suspend, so running out of
 * what Pillow's reads have given is fatal */
static int arith_byte(Dec *d) {
    if (d->s.pos >= d->limit) {
        if (d->limit < d->len)
            fail(d, JPEG_DAMAGED, "arithmetic-coded data runs past a 64 KiB read of the "
                 "file, where libjpeg's arithmetic decoder cannot suspend");
        fail(d, JPEG_DAMAGED, "the file ends inside the image data");
    }
    return d->data[d->s.pos++];
}

/* arith_decode: one binary decision with the statistics bin *st */
static int arith_decode(Dec *d, uint8_t *st) {
    Arith *e = &d->ar;
    while (e->a < 0x8000) {            /* renormalisation, section D.2.6 */
        if (--e->ct < 0) {
            int data;
            if (d->s.unread_marker) {
                data = 0;              /* past a marker: zeros */
            } else {
                data = arith_byte(d);
                if (data == 0xFF) {
                    do data = arith_byte(d);
                    while (data == 0xFF);
                    if (data == 0) {
                        data = 0xFF;
                    } else {
                        d->s.unread_marker = data;
                        data = 0;
                    }
                }
            }
            e->c = (e->c << 8) | data;
            if ((e->ct += 8) < 0)
                if (++e->ct == 0) e->a = 0x8000;
        }
        e->a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* read_restart_marker and the statistics reset of jdarith.c process_restart;
 * a suspension there is fatal too */
static void arith_restart(Dec *d) {
    if (d->s.unread_marker == 0 && !next_marker(d))
        fail(d, JPEG_DAMAGED, "the data runs out at a restart marker, where libjpeg's "
             "arithmetic decoder cannot suspend");
    if (d->s.unread_marker == 0xD0 + d->s.next_restart)
        d->s.unread_marker = 0;
    else if (!resync(d, d->s.next_restart))
        fail(d, JPEG_DAMAGED, "the data runs out looking for a restart marker");
    d->s.next_restart = (d->s.next_restart + 1) & 7;
    for (int i = 0; i < d->ncs; i++) {
        Comp *c = &d->comp[d->cs[i]];
        if (!d->progressive || (d->Ss == 0 && d->Ah == 0)) {
            memset(d->ar.dc_stats[c->dc_tbl], 0, 64);
            d->s.last_dc[i] = 0;
            d->ar.dc_context[i] = 0;
        }
        if (!d->progressive || d->Ss) memset(d->ar.ac_stats[c->ac_tbl], 0, 256);
    }
    d->ar.c = 0;
    d->ar.a = 0;
    d->ar.ct = -16;
    d->s.restarts_to_go = d->restart_interval;
}

/* Figures F.19-F.24: a DC difference into last_dc[ci] (masked to 16 bits);
 * 0 after a magnitude overflow, which stops the scan's decoding */
static int arith_dc(Dec *d, int b) {
    int ci = d->membership[b], tbl = d->comp[d->cs[ci]].dc_tbl;
    uint8_t *st = d->ar.dc_stats[tbl] + d->ar.dc_context[ci];
    if (arith_decode(d, st) == 0) {
        d->ar.dc_context[ci] = 0;
        return 1;
    }
    int sign = arith_decode(d, st + 1), m, v;
    st += 2 + sign;
    if ((m = arith_decode(d, st)) != 0) {
        st = d->ar.dc_stats[tbl] + 20;
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) {
                d->ar.ct = -1;
                return 0;
            }
            st += 1;
        }
    }
    if (m < (int)((1L << d->dc_L[tbl]) >> 1))
        d->ar.dc_context[ci] = 0;
    else if (m > (int)((1L << d->dc_U[tbl]) >> 1))
        d->ar.dc_context[ci] = 12 + sign * 4;
    else
        d->ar.dc_context[ci] = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    d->s.last_dc[ci] = (d->s.last_dc[ci] + v) & 0xFFFF;
    return 1;
}

/* AC coefficients k = ss .. se into blk, each shifted up al bits; 0 after a
 * spectral or magnitude overflow */
static int arith_ac(Dec *d, int tbl, int16_t *blk, int ss, int se, int al) {
    uint8_t *stats = d->ar.ac_stats[tbl];
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (arith_decode(d, st)) break;        /* EOB */
        while (arith_decode(d, st + 1) == 0) {
            st += 3;
            if (++k > se) {
                d->ar.ct = -1;
                return 0;
            }
        }
        int sign = arith_decode(d, &d->ar.fixed_bin), m, v;
        st += 2;
        if ((m = arith_decode(d, st)) != 0) {
            if (arith_decode(d, st)) {
                m <<= 1;
                st = stats + (k <= d->ac_K[tbl] ? 189 : 217);
                while (arith_decode(d, st)) {
                    if ((m <<= 1) == 0x8000) {
                        d->ar.ct = -1;
                        return 0;
                    }
                    st += 1;
                }
            }
        }
        v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(d, st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[natural_order[k]] = (int16_t)((unsigned)v << al);
    }
    return 1;
}

/* One MCU of an arithmetic-coded scan (decode_mcu and the four progressive
 * decoders): after an overflow the rest of the scan decodes as nothing */
static void arith_mcu(Dec *d) {
    if (d->restart_interval) {
        if (d->s.restarts_to_go == 0) arith_restart(d);
        d->s.restarts_to_go--;
    }
    if (d->progressive && d->Ss == 0 && d->Ah != 0) {      /* DC refine: no error check */
        for (int b = 0; b < d->blocks_in_mcu; b++)
            if (arith_decode(d, &d->ar.fixed_bin)) d->blocks[b][0] |= (int16_t)(1 << d->Al);
        return;
    }
    if (d->ar.ct == -1) return;
    if (!d->progressive) {
        for (int b = 0; b < d->blocks_in_mcu; b++) {
            if (!arith_dc(d, b)) return;
            d->blocks[b][0] = (int16_t)d->s.last_dc[d->membership[b]];
            Comp *c = &d->comp[d->cs[d->membership[b]]];
            if (!arith_ac(d, c->ac_tbl, d->blocks[b], 1, 63, 0)) return;
        }
    } else if (d->Ss == 0) {                               /* DC first */
        for (int b = 0; b < d->blocks_in_mcu; b++) {
            if (!arith_dc(d, b)) return;
            d->blocks[b][0] = (int16_t)((unsigned)d->s.last_dc[d->membership[b]] << d->Al);
        }
    } else if (d->Ah == 0) {                               /* AC first */
        arith_ac(d, d->comp[d->cs[0]].ac_tbl, d->blocks[0], d->Ss, d->Se, d->Al);
    } else {                                               /* AC refine */
        int16_t *blk = d->blocks[0];
        uint8_t *stats = d->ar.ac_stats[d->comp[d->cs[0]].ac_tbl];
        int p1 = 1 << d->Al, m1 = (int)(~0u << d->Al), kex;
        for (kex = d->Se; kex > 0; kex--)
            if (blk[natural_order[kex]]) break;
        for (int k = d->Ss; k <= d->Se; k++) {
            uint8_t *st = stats + 3 * (k - 1);
            if (k > kex && arith_decode(d, st)) break;     /* EOB */
            for (;;) {
                int16_t *coef = blk + natural_order[k];
                if (*coef) {
                    if (arith_decode(d, st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                    break;
                }
                if (arith_decode(d, st + 1)) {
                    *coef = (int16_t)(arith_decode(d, &d->ar.fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > d->Se) {
                    d->ar.ct = -1;
                    return;
                }
            }
        }
    }
}

/* ---- frame and scan setup (jdinput.c, jdmaster.c, jdsample.c) ----------- */

static int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

static void initial_setup(Dec *d) {
    if (d->width > 65500 || d->height > 65500)
        fail(d, JPEG_DAMAGED, "an image of %dx%d", d->width, d->height);
    d->hmax = d->vmax = 1;
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4)
            fail(d, JPEG_DAMAGED, "sampling factors %dx%d", c->h, c->v);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    int du = d->lossless ? 1 : 8;             /* a lossless frame's "blocks" are samples */
    int mcus_x = ceil_div(d->width, d->hmax * du), mcus_y = ceil_div(d->height, d->vmax * du);
    d->imcu_rows = mcus_y;
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        c->bw = ceil_div((int64_t)d->width * c->h, d->hmax * du);
        c->bh = ceil_div((int64_t)d->height * c->v, d->vmax * du);
        c->dw = ceil_div((int64_t)d->width * c->h, d->hmax);
        c->dh = ceil_div((int64_t)d->height * c->v, d->vmax);
        c->aw = mcus_x * c->h;
        c->ah = mcus_y * c->v;
        for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
        if (d->hmax % c->h || d->vmax % c->v)      /* jinit_upsampler: JERR_FRACT_SAMPLE_NOTIMPL */
            fail(d, JPEG_DAMAGED, "sampling factors %dx%d under a %dx%d maximum, a fractional "
                 "ratio libjpeg does not upsample", c->h, c->v, d->hmax, d->vmax);
        c->hr = d->hmax / c->h;
        c->vr = d->vmax / c->v;
        if (c->hr == 1 && c->vr == 1)
            c->up = UP_FULL;
        else if (c->hr == 2 && c->vr == 1)
            c->up = c->dw > 2 ? UP_H2V1 : UP_REPLICATE;
        else if (c->hr == 1 && c->vr == 2)
            c->up = UP_H1V2;
        else if (c->hr == 2 && c->vr == 2)
            c->up = c->dw > 2 ? UP_H2V2 : UP_REPLICATE;
        else
            c->up = UP_REPLICATE;
        /* jinit_upsampler: no fancy upsampling where a block is one sample */
        if (d->lossless && c->up != UP_FULL) c->up = UP_REPLICATE;
    }
    for (int ci = 0; ci < d->ncomp && !d->lossless; ci++) {
        Comp *c = &d->comp[ci];
        c->coef = zalloc(d, (size_t)c->aw * c->ah * 64 * sizeof(int16_t));
    }
    /* default_decompress_parms: the colour space libjpeg assumes */
    if (d->ncomp == 1) {
        d->colour = 0;
    } else if (d->ncomp == 3) {
        int c0 = d->comp[0].id, c1 = d->comp[1].id, c2 = d->comp[2].id;
        if (d->saw_jfif)
            d->colour = 1;
        else if (d->saw_adobe)
            d->colour = d->adobe_transform == 0 ? 2 : 1;
        else        /* a lossless frame is taken as RGB whatever its component ids */
            d->colour = (d->lossless || (c0 == 82 && c1 == 71 && c2 == 66)) ? 2 : 1;
    } else if (d->ncomp == 4) {
        d->colour = d->saw_adobe && d->adobe_transform != 0 ? 4 : 3;
    } else {
        fail(d, JPEG_DAMAGED, "%d components", d->ncomp);
    }
    /* jinit_color_deconverter: a lossless frame is not colour converted */
    if (d->lossless && (d->colour == 1 || d->colour == 4))
        fail(d, JPEG_DAMAGED, "a lossless frame in %s, which libjpeg does not convert",
             d->colour == 1 ? "YCbCr" : "YCCK");
}

static void start_scan(Dec *d) {
    if (d->ncs == 1) {
        Comp *c = &d->comp[d->cs[0]];
        d->mcus_per_row = c->bw;
        d->mcu_rows = c->bh;
        d->blocks_in_mcu = 1;
        d->membership[0] = 0;
    } else {
        d->mcus_per_row = ceil_div(d->width, d->hmax * (d->lossless ? 1 : 8));
        d->mcu_rows = ceil_div(d->height, d->vmax * (d->lossless ? 1 : 8));
        d->blocks_in_mcu = 0;
        for (int i = 0; i < d->ncs; i++) {
            Comp *c = &d->comp[d->cs[i]];
            if (d->blocks_in_mcu + c->h * c->v > MAX_BLOCKS)
                fail(d, JPEG_DAMAGED, "more than %d blocks in an MCU", MAX_BLOCKS);
            for (int n = 0; n < c->h * c->v; n++) d->membership[d->blocks_in_mcu++] = i;
        }
    }
    for (int i = 0; i < d->ncs && !d->lossless; i++) {      /* latch_quant_tables */
        Comp *c = &d->comp[d->cs[i]];
        if (c->latched) continue;
        if (c->tq >= 4 || !d->qt_defined[c->tq])
            fail(d, JPEG_DAMAGED, "no quantisation table %d", c->tq);
        for (int k = 0; k < 64; k++) {
            c->qt_raw[k] = d->qt[c->tq][k];
            c->qt[k] = (int16_t)d->qt[c->tq][k];   /* libjpeg-turbo's 16-bit multipliers */
        }
        c->latched = 1;
    }
    if (d->progressive) {                   /* start_pass_phuff_decoder */
        int is_dc = d->Ss == 0, bad = 0;
        if (is_dc) {
            if (d->Se != 0) bad = 1;
        } else {
            if (d->Ss > d->Se || d->Se >= 64) bad = 1;
            if (d->ncs != 1) bad = 1;
        }
        if (d->Ah != 0 && d->Al != d->Ah - 1) bad = 1;
        if (d->Al > 13) bad = 1;
        if (bad)
            fail(d, JPEG_DAMAGED, "a bad progression (Ss %d, Se %d, Ah %d, Al %d)", d->Ss,
                 d->Se, d->Ah, d->Al);
        for (int i = 0; i < d->ncs; i++) {
            Comp *c = &d->comp[d->cs[i]];
            for (int k = d->Ss < 1 ? d->Ss : 1; k < SAVED_COEFS; k++)   /* up to MAX(Se, 9) */
                c->prev_coef_bits[k] = d->scan_number > 1 ? c->coef_bits[k] : 0;
            for (int k = d->Ss; k <= d->Se; k++) c->coef_bits[k] = d->Al;
        }
        for (int i = 0; i < d->ncs && !d->arith; i++) {
            Comp *c = &d->comp[d->cs[i]];
            if (is_dc) {
                if (d->Ah == 0) make_table(d, 1, c->dc_tbl, &d->dc_tab[c->dc_tbl]);
            } else {
                make_table(d, 0, c->ac_tbl, &d->ac_tab[c->ac_tbl]);
            }
        }
    } else if (!d->arith) {                 /* start_pass_huff_decoder, start_pass_lhuff_decoder */
        for (int i = 0; i < d->ncs; i++) {
            Comp *c = &d->comp[d->cs[i]];
            make_table(d, 1, c->dc_tbl, &d->dc_tab[c->dc_tbl]);
            if (!d->lossless) make_table(d, 0, c->ac_tbl, &d->ac_tab[c->ac_tbl]);
        }
    }
    for (int b = 0; b < d->blocks_in_mcu; b++) {
        Comp *c = &d->comp[d->cs[d->membership[b]]];
        /* a progressive AC scan has one component and reads its AC table */
        d->dc_cur[b] = &d->dc_tab[c->dc_tbl & 3];
        d->ac_cur[b] = &d->ac_tab[c->ac_tbl & 3];
    }
    for (int i = 0; i < MAX_COMPS; i++) d->s.last_dc[i] = 0;
    if (d->arith) {                         /* jdarith.c start_pass */
        for (int i = 0; i < d->ncs; i++) {
            Comp *c = &d->comp[d->cs[i]];
            if (!d->progressive || (d->Ss == 0 && d->Ah == 0)) {
                memset(d->ar.dc_stats[c->dc_tbl], 0, 64);
                d->ar.dc_context[i] = 0;
            }
            if (!d->progressive || d->Ss) memset(d->ar.ac_stats[c->ac_tbl], 0, 256);
        }
        d->ar.c = 0;
        d->ar.a = 0;
        d->ar.ct = -16;
    }
    d->s.eobrun = 0;
    d->s.bits_left = 0;
    d->s.get_buffer = 0;
    d->s.insufficient = 0;
    d->s.restarts_to_go = d->restart_interval;
}

/* The blocks of MCU (mx, my) of the current scan */
static void point_blocks(Dec *d, int mx, int my) {
    if (d->ncs == 1) {
        Comp *c = &d->comp[d->cs[0]];
        d->blocks[0] = c->coef + ((int64_t)my * c->aw + mx) * 64;
        return;
    }
    int b = 0;
    for (int i = 0; i < d->ncs; i++) {
        Comp *c = &d->comp[d->cs[i]];
        for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
                d->blocks[b++] =
                    c->coef + ((int64_t)(my * c->v + y) * c->aw + mx * c->h + x) * 64;
    }
}

/* Runs call until it has the data it needs. A suspension before the end of
 * the file is one of Pillow's 64 KiB reads ending: the work is done again
 * from its start with the next read appended. */
#define WITH_MORE_DATA(d, call)                                                  \
    do {                                                                         \
        State snap_ = (d)->s;                                                    \
        while (!(call)) {                                                        \
            if (!more_data(d))                                                   \
                fail((d), JPEG_DAMAGED, "the file ends inside the image data");  \
            (d)->s = snap_;                                                      \
        }                                                                        \
    } while (0)

/* One attempt at an MCU of a sequential scan (jdhuff.c decode_mcu): 0 when
 * the data runs out */
static int sequential_mcu_once(Dec *d, int single_scan) {
    if (d->restart_interval && d->s.restarts_to_go == 0 && !process_restart(d)) return 0;
    if (d->s.insufficient) return 1;
    int usefast = !d->restart_interval && d->s.unread_marker == 0
                  && d->limit - d->s.pos >= (int64_t)FAST_BYTES * d->blocks_in_mcu;
    if (single_scan)      /* decompress_onepass zeroes the MCU first */
        for (int b = 0; b < d->blocks_in_mcu; b++) memset(d->blocks[b], 0, 64 * sizeof(int16_t));
    if (usefast) {
        State before = d->s;
        decode_mcu_fast(d);
        if (d->s.unread_marker == 0) return 1;
        d->s = before;
    }
    return decode_mcu_slow(d);
}

static void sequential_mcu(Dec *d, int single_scan) {
    WITH_MORE_DATA(d, sequential_mcu_once(d, single_scan));
    if (d->restart_interval) d->s.restarts_to_go--;
}

static void progressive_mcu(Dec *d) {
    int ok = 1;
    if (d->restart_interval && d->s.restarts_to_go == 0) ok = process_restart(d);
    if (ok) {
        int is_dc = d->Ss == 0;
        if (is_dc && d->Ah != 0)
            ok = decode_dc_refine(d);     /* reads even past a marker: zeros change nothing */
        else if (!d->s.insufficient)
            ok = is_dc ? decode_dc_first(d) : d->Ah == 0 ? decode_ac_first(d)
                                                          : decode_ac_refine(d);
    }
    if (!ok) fail(d, JPEG_DAMAGED, "the file ends inside the image data");
    if (d->restart_interval) d->s.restarts_to_go--;
}

static void decode_scan(Dec *d, int single_scan) {
    int rows_per_imcu = d->ncs == 1 ? d->comp[d->cs[0]].v : 1;
    for (int my = 0; my < d->mcu_rows; my++)
        for (int mx = 0; mx < d->mcus_per_row; mx++) {
            point_blocks(d, mx, my);
            /* consume_data: the last iMCU row begun with the data sufficient */
            if (!d->s.insufficient) d->last_good = my / rows_per_imcu;
            if (d->arith) {
                if (single_scan)
                    for (int b = 0; b < d->blocks_in_mcu; b++)
                        memset(d->blocks[b], 0, 64 * sizeof(int16_t));
                arith_mcu(d);
            } else if (d->progressive) {
                progressive_mcu(d);
            } else {
                sequential_mcu(d, single_scan);
            }
        }
}

/* natural-order positions of the DC and the first 9 AC coefficients in
 * zigzag order */
static const int q_pos[SAVED_COEFS] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

/* smoothing_ok (jdcoefct.c): libjpeg smooths a progressive image's blocks
 * when one of the first 9 AC coefficients was not sent to its last bit;
 * the latches are what the smoothing reads, the second of them for iMCU rows
 * past the last one decoded with the data sufficient */
static void latch_smoothing(Dec *d) {
    int useful = 0;
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        if (!c->latched) return;
        for (int i = 0; i < SAVED_COEFS; i++)
            if (c->qt_raw[q_pos[i]] == 0) return;
        if (c->coef_bits[0] < 0) return;
        d->latch[ci][0] = c->coef_bits[0];
        for (int k = 1; k < SAVED_COEFS; k++) {
            d->prev_latch[ci][k] = d->scan_number > 1 ? c->prev_coef_bits[k] : -1;
            d->latch[ci][k] = c->coef_bits[k];
            if (c->coef_bits[k] != 0) useful = 1;
        }
    }
    d->smooth = useful;
}

/* ---- IDCT (jidctint.c jpeg_idct_islow) ----------------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172

/* jpeg_idct_islow as libjpeg-turbo's x86 SIMD version (SSE2 / AVX2), which
 * Pillow runs, computes it: the same butterfly and constants, in 16-bit
 * lanes where the C version has ints. Products of a coefficient and its
 * quantiser, and the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1,
 * wrap at 16 bits; the first pass's outputs saturate to 16 bits and the
 * second's to -128..127 (where the C version wraps through RANGE_MASK); a
 * block whose rows 1-7 are all zero takes the DC shortcut with a 16-bit
 * shift. On the coefficients of a valid file nothing wraps or saturates and
 * the two versions agree; a corrupt file can make them differ. */
static inline int16_t wrap16(int64_t x) { return (int16_t)(uint16_t)(uint64_t)x; }
static inline int32_t wrap32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
static inline int16_t sat16(int32_t x) {
    return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
static inline int32_t descale(int32_t x, int n) { return wrap32((int64_t)x + (1 << (n - 1))) >> n; }

/* One 1-D pass on the 8 frequencies in[0..7]: the outputs before their descale */
static void idct_1d(const int16_t *in, int32_t *out) {
    int32_t tmp0 = (int32_t)wrap16(in[0] + in[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (int32_t)wrap16(in[0] - in[4]) * (1 << CONST_BITS);
    int32_t tmp3 = in[2] * (FIX_0_541196100 + FIX_0_765366865) + in[6] * FIX_0_541196100;
    int32_t tmp2 = in[2] * FIX_0_541196100 + in[6] * (FIX_0_541196100 - FIX_1_847759065);
    int32_t tmp10 = wrap32((int64_t)tmp0 + tmp3), tmp13 = wrap32((int64_t)tmp0 - tmp3);
    int32_t tmp11 = wrap32((int64_t)tmp1 + tmp2), tmp12 = wrap32((int64_t)tmp1 - tmp2);
    int16_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
    int32_t z3r = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
    int32_t z4r = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
    int32_t o0 = wrap32((int64_t)in[7] * (FIX_0_298631336 - FIX_0_899976223)
                        + in[1] * -FIX_0_899976223 + z3r);
    int32_t o1 = wrap32((int64_t)in[5] * (FIX_2_053119869 - FIX_2_562915447)
                        + in[3] * -FIX_2_562915447 + z4r);
    int32_t o2 = wrap32((int64_t)in[5] * -FIX_2_562915447
                        + in[3] * (FIX_3_072711026 - FIX_2_562915447) + z3r);
    int32_t o3 = wrap32((int64_t)in[7] * -FIX_0_899976223
                        + in[1] * (FIX_1_501321110 - FIX_0_899976223) + z4r);
    out[0] = wrap32((int64_t)tmp10 + o3);
    out[7] = wrap32((int64_t)tmp10 - o3);
    out[1] = wrap32((int64_t)tmp11 + o2);
    out[6] = wrap32((int64_t)tmp11 - o2);
    out[2] = wrap32((int64_t)tmp12 + o1);
    out[5] = wrap32((int64_t)tmp12 - o1);
    out[3] = wrap32((int64_t)tmp13 + o0);
    out[4] = wrap32((int64_t)tmp13 - o0);
}

/* Columns of dequantised coefficients into a 16-bit workspace, then rows
 * into samples */
static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out, int stride) {
    int16_t ws[64], v[8];
    int32_t o[8];
    int ac = 0;
    for (int k = 8; k < 64; k++) ac |= in[k];
    for (int col = 0; col < 8; col++) {
        for (int k = 0; k < 8; k++) v[k] = wrap16((int32_t)in[k * 8 + col] * q[k * 8 + col]);
        if (!ac) {
            for (int k = 0; k < 8; k++) ws[k * 8 + col] = wrap16((int32_t)v[0] * (1 << PASS1_BITS));
            continue;
        }
        idct_1d(v, o);
        for (int k = 0; k < 8; k++) ws[k * 8 + col] = sat16(descale(o[k], CONST_BITS - PASS1_BITS));
    }
    for (int row = 0; row < 8; row++) {
        idct_1d(ws + row * 8, o);
        for (int k = 0; k < 8; k++) {
            int32_t x = sat16(descale(o[k], CONST_BITS + PASS1_BITS + 3));
            out[row * stride + k] = (uint8_t)((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
        }
    }
}

/* ---- upsampling and colour conversion (jdsample.c, jdcolor.c) ------------ */

/* Row y of component c at full width into out[0 .. 2 * dw) or [0 .. width) */
static void upsample_row(const Dec *d, const Comp *c, int y, uint8_t *out) {
    int stride = d->lossless ? c->aw : c->bw * 8;
    if (c->up == UP_FULL) {
        memcpy(out, c->plane + (int64_t)y * stride, (size_t)d->width);
    } else if (c->up == UP_REPLICATE) {
        const uint8_t *in = c->plane + (int64_t)(y / c->vr) * stride;
        for (int x = 0; x < d->width; x++) out[x] = in[x / c->hr];
    } else if (c->up == UP_H2V1) {             /* h2v1_fancy_upsample */
        const uint8_t *in = c->plane + (int64_t)y * stride;
        int v = in[0];
        out[0] = (uint8_t)v;
        out[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c->dw - 1; x++) {
            v = in[x] * 3;
            out[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
            out[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        int x = c->dw - 1;
        v = in[x];
        out[2 * x] = (uint8_t)((v * 3 + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = (uint8_t)v;
    } else if (c->up == UP_H1V2) {             /* h1v2_fancy_upsample */
        int r = y >> 1, bias = (y & 1) ? 2 : 1;
        int far = (y & 1) ? (r + 1 < c->dh ? r + 1 : c->dh - 1) : (r > 0 ? r - 1 : 0);
        const uint8_t *in0 = c->plane + (int64_t)r * stride;
        const uint8_t *in1 = c->plane + (int64_t)far * stride;
        for (int x = 0; x < d->width; x++) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {                                   /* h2v2_fancy_upsample */
        int r = y >> 1;
        int far = (y & 1) ? (r + 1 < c->dh ? r + 1 : c->dh - 1) : (r > 0 ? r - 1 : 0);
        const uint8_t *in0 = c->plane + (int64_t)r * stride;
        const uint8_t *in1 = c->plane + (int64_t)far * stride;
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < c->dw - 1; x++) {
            next_sum = in0[x + 1] * 3 + in1[x + 1];
            out[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            out[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
        }
        int x = c->dw - 1;
        out[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        out[2 * x + 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
    }
}

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static void write_pixels(Dec *d, uint8_t *out) {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {           /* build_ycc_rgb_table */
        int x = i - 128;
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = -FIX(0.71414) * x;
        cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    int n = d->ncomp;
    uint8_t **rows = d->rows;
    for (int ci = 0; ci < n; ci++) rows[ci] = zalloc(d, (size_t)d->width * 2 + 16);
    for (int y = 0; y < d->height; y++) {
        for (int ci = 0; ci < n; ci++) upsample_row(d, &d->comp[ci], y, rows[ci]);
        uint8_t *o = out + (int64_t)y * d->width * n;
        if (d->colour == 1 || d->colour == 4) {      /* ycc_rgb_convert, ycck_cmyk_convert */
            for (int x = 0; x < d->width; x++) {
                int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
                int r = yy + cr_r[cr];
                int g = yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS);
                int b = yy + cb_b[cb];
                if (d->colour == 4) {
                    r = 255 - r;
                    g = 255 - g;
                    b = 255 - b;
                }
                o[x * n] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
                o[x * n + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
                o[x * n + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
                if (n == 4) o[x * n + 3] = rows[3][x];
            }
        } else {
            for (int x = 0; x < d->width; x++)
                for (int ci = 0; ci < n; ci++) o[x * n + ci] = rows[ci][x];
        }
    }
}

/* ---- block smoothing (jdcoefct.c decompress_smooth_data) ----------------- */

/* The estimate num / (q << 8), rounded half away from zero, and below
 * 1 << al where al > 0 bits of the coefficient are still unsent */
static int16_t estimate(int64_t num, int64_t q, int al) {
    int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

/* Component ci's blocks through the IDCT, each with the coefficients it
 * lacks estimated from the DC values of the 5x5 blocks around it; at the
 * image's edges a missing neighbour is the nearer one. Rows are walked by
 * iMCU row (v block rows) as libjpeg walks them. */
static void smooth_blocks(Dec *d, int ci) {
    Comp *c = &d->comp[ci];
    int stride = c->bw * 8, v = c->v, last = d->imcu_rows - 1, last_col = c->bw - 1;
    const uint16_t *q = c->qt_raw;
    int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
    int64_t Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24], num;
    int16_t ws[64];
    for (int out = 0; out <= last; out++) {
        int block_rows = out < last ? v : (c->bh % v ? c->bh % v : v);
        const int *bits = out > d->last_good ? d->prev_latch[ci] : d->latch[ci];
        int change_dc = 1, Al;
        for (int k = 1; k < SAVED_COEFS; k++)
            if (bits[k] != -1) change_dc = 0;
        for (int br = 0; br < block_rows; br++) {
            /* which neighbour rows exist is judged by libjpeg on block rows
             * counted at this iMCU row's block_rows, short in the last iMCU
             * row of a component whose height is not a whole number of
             * iMCU rows; the rows read are the real ones */
            int row = out * v + br, irow = out * block_rows + br, irows = block_rows * (last + 1);
            int rp = irow > 0 ? row - 1 : row;
            int rpp = irow > 1 ? row - 2 : rp;
            int rn = irow < irows - 1 ? row + 1 : row;
            int rnn = irow < irows - 2 ? row + 2 : rn;
            const int16_t *pp = c->coef + (int64_t)rpp * c->aw * 64;
            const int16_t *p = c->coef + (int64_t)rp * c->aw * 64;
            const int16_t *cur = c->coef + (int64_t)row * c->aw * 64;
            const int16_t *n = c->coef + (int64_t)rn * c->aw * 64;
            const int16_t *nn = c->coef + (int64_t)rnn * c->aw * 64;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13,
                DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = pp[0];
            DC06 = DC07 = DC08 = DC09 = DC10 = p[0];
            DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
            DC16 = DC17 = DC18 = DC19 = DC20 = n[0];
            DC21 = DC22 = DC23 = DC24 = DC25 = nn[0];
            for (int bn = 0; bn <= last_col; bn++) {
                memcpy(ws, cur + (int64_t)bn * 64, sizeof ws);
                if (bn == 0 && bn < last_col) {
                    DC04 = DC05 = pp[64];
                    DC09 = DC10 = p[64];
                    DC14 = DC15 = cur[64];
                    DC19 = DC20 = n[64];
                    DC24 = DC25 = nn[64];
                }
                if (bn + 1 < last_col) {
                    int64_t o = (int64_t)(bn + 2) * 64;
                    DC05 = pp[o];
                    DC10 = p[o];
                    DC15 = cur[o];
                    DC20 = n[o];
                    DC25 = nn[o];
                }
                if ((Al = bits[1]) != 0 && ws[1] == 0) {              /* AC01 */
                    num = Q00 * (change_dc ?
                          (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                           3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                           3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                           DC24 + DC25) :
                          (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = estimate(num, Q01, Al);
                }
                if ((Al = bits[2]) != 0 && ws[8] == 0) {              /* AC10 */
                    num = Q00 * (change_dc ?
                          (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                           38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                           13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                          (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = estimate(num, Q10, Al);
                }
                if ((Al = bits[3]) != 0 && ws[16] == 0) {             /* AC20 */
                    num = Q00 * (change_dc ?
                          (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                           5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
                          (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = estimate(num, Q20, Al);
                }
                if ((Al = bits[4]) != 0 && ws[9] == 0) {              /* AC11 */
                    num = Q00 * (change_dc ?
                          (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                           DC25) :
                          (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                           DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = estimate(num, Q11, Al);
                }
                if ((Al = bits[5]) != 0 && ws[2] == 0) {              /* AC02 */
                    num = Q00 * (change_dc ?
                          (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                           7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
                          (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = estimate(num, Q02, Al);
                }
                if (change_dc) {
                    if ((Al = bits[6]) != 0 && ws[3] == 0) {          /* AC03 */
                        num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
                        ws[3] = estimate(num, Q03, Al);
                    }
                    if ((Al = bits[7]) != 0 && ws[10] == 0) {         /* AC12 */
                        num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
                        ws[10] = estimate(num, Q12, Al);
                    }
                    if ((Al = bits[8]) != 0 && ws[17] == 0) {         /* AC21 */
                        num = Q00 * (DC07 - 3 * DC12 + DC17 - DC09 + 3 * DC14 - DC19);
                        ws[17] = estimate(num, Q21, Al);
                    }
                    if ((Al = bits[9]) != 0 && ws[24] == 0) {         /* AC30 */
                        num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
                        ws[24] = estimate(num, Q30, Al);
                    }
                    num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
                    ws[0] = estimate(num, Q00, 0);                     /* the DC */
                }
                idct_islow(ws, c->qt, c->plane + (int64_t)row * 8 * stride + bn * 8, stride);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

static void reconstruct(Dec *d) {
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        int stride = c->bw * 8;
        c->plane = zalloc(d, (size_t)stride * c->bh * 8);
        if (d->smooth) {
            smooth_blocks(d, ci);
            continue;
        }
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++)
                idct_islow(c->coef + ((int64_t)by * c->aw + bx) * 64, c->qt,
                           c->plane + (int64_t)by * 8 * stride + bx * 8, stride);
    }
}

/* ---- lossless frames (jdlhuff.c, jddiffct.c, jdlossls.c) ---------------- */

/* One MCU of sample differences (jdlhuff.c decode_mcus): a Huffman-coded
 * magnitude category, 16 standing for 32768, then its bits; 0 when the data
 * runs out */
static int lossless_mcu(Dec *d, int mx, int my) {
    int b = 0;
    for (int i = 0; i < d->ncs; i++) {
        Comp *c = &d->comp[d->cs[i]];
        int h = d->ncs == 1 ? 1 : c->h, v = d->ncs == 1 ? 1 : c->v;
        for (int y = 0; y < v; y++)
            for (int x = 0; x < h; x++) {
                int s = huff_decode(d, d->dc_cur[b++]);
                if (s < 0) return 0;
                if (s == 16) {
                    s = 32768;
                } else if (s) {
                    CHECK_BITS(d, s, return 0);
                    int r = GET_BITS(d, s);
                    s = EXTEND(r, s);
                }
                c->diff[(int64_t)(my * v + y) * c->aw + mx * h + x] = s;
            }
    }
    return 1;
}

/* The samples of rows y0 .. y0 + n - 1 of component c from their
 * differences: a row after the scan's start or a restart predicts from the
 * left (its first sample from the middle value 1 << (7 - Al)), each later
 * row by the scan's predictor Ss from the sample to the left (Ra), above
 * (Rb) and above-left (Rc), its first sample from above. Sums wrap at 16
 * bits. *first is the component's state (jdlossls.c predict_undifference). */
static void undifference(Dec *d, Comp *c, int y0, int n, int *first) {
    int64_t stride = (int64_t)c->aw;
    for (int y = y0; y < y0 + n; y++) {
        const int32_t *df = c->diff + y * stride;
        int32_t *u = c->undiff + y * stride;
        const int32_t *up = y > 0 ? c->undiff + (y - 1) * stride : u;
        int Ra, Rb, Rc;
        if (*first) {
            Ra = (df[0] + (1 << (7 - d->Al))) & 0xFFFF;
            u[0] = Ra;
            for (int x = 1; x < c->dw; x++) u[x] = Ra = (df[x] + Ra) & 0xFFFF;
            *first = 0;
            continue;
        }
        Rb = up[0];
        u[0] = Ra = (df[0] + Rb) & 0xFFFF;
        for (int x = 1; x < c->dw; x++) {
            int64_t pred;
            Rc = Rb;
            Rb = up[x];
            switch (d->Ss) {
            case 1: pred = Ra; break;
            case 2: pred = Rb; break;
            case 3: pred = Rc; break;
            case 4: pred = (int64_t)Ra + Rb - Rc; break;
            case 5: pred = Ra + (((int64_t)Rb - Rc) >> 1); break;
            case 6: pred = Rb + (((int64_t)Ra - Rc) >> 1); break;
            default: pred = ((int64_t)Ra + Rb) >> 1; break;
            }
            u[x] = Ra = (int)((df[x] + pred) & 0xFFFF);
        }
    }
}

/* A lossless scan (jddiffct.c decompress_data): MCU rows of differences,
 * restarts only at whole MCU rows, and each iMCU row's sample rows
 * undifferenced once all of its MCU rows are decoded. A restart, or an MCU
 * row begun with the data run short, sets every component back to its
 * first-row prediction (the differences of such a row are zeros). */
static void lossless_scan(Dec *d) {
    if (d->Ss < 1 || d->Ss > 7 || d->Se != 0 || d->Ah != 0 || d->Al >= d->precision)
        fail(d, JPEG_DAMAGED, "a bad lossless scan (Ss %d, Se %d, Ah %d, Al %d)", d->Ss, d->Se,
             d->Ah, d->Al);
    if (d->restart_interval % d->mcus_per_row)
        fail(d, JPEG_DAMAGED, "a restart interval of %d MCUs in rows of %d",
             d->restart_interval, d->mcus_per_row);
    int first[MAX_COMPS] = {1, 1, 1, 1}, last = d->imcu_rows - 1;
    d->rows_to_go = d->restart_interval / d->mcus_per_row;
    for (int i = 0; i < d->ncs; i++) {
        Comp *c = &d->comp[d->cs[i]];
        if (!c->diff) {
            c->diff = zalloc(d, (size_t)c->aw * c->ah * sizeof(int32_t));
            c->undiff = zalloc(d, (size_t)c->aw * c->ah * sizeof(int32_t));
        }
        c->lossless_al = d->Al;
    }
    for (int row = 0; row <= last; row++) {
        Comp *c0 = &d->comp[d->cs[0]];
        int tail = c0->bh % c0->v ? c0->bh % c0->v : c0->v;   /* last_row_height */
        int mcu_rows = d->ncs > 1 ? 1 : row < last ? c0->v : tail;
        for (int k = 0; k < mcu_rows; k++) {
            int my = d->ncs > 1 ? row : row * c0->v + k;
            if (d->restart_interval && d->rows_to_go == 0) {
                WITH_MORE_DATA(d, process_restart(d));
                for (int i = 0; i < MAX_COMPS; i++) first[i] = 1;
                d->rows_to_go = d->restart_interval / d->mcus_per_row;
            }
            if (d->s.insufficient) {               /* zeros, and the predictors reset */
                for (int i = 0; i < d->ncs; i++) {
                    Comp *c = &d->comp[d->cs[i]];
                    int v = d->ncs == 1 ? 1 : c->v;
                    memset(c->diff + (int64_t)my * v * c->aw, 0,
                           (size_t)v * c->aw * sizeof(int32_t));
                }
                for (int i = 0; i < MAX_COMPS; i++) first[i] = 1;
            } else {
                for (int mx = 0; mx < d->mcus_per_row; mx++)
                    WITH_MORE_DATA(d, lossless_mcu(d, mx, my));
            }
            if (d->restart_interval) d->rows_to_go--;
        }
        for (int i = 0; i < d->ncs; i++) {
            Comp *c = &d->comp[d->cs[i]];
            int rows = row < last ? c->v : (c->dh - row * c->v);
            if (rows > c->v) rows = c->v;
            undifference(d, c, row * c->v, rows, &first[d->cs[i]]);
        }
    }
}

/* The sample planes: each sample shifted up by its scan's point transform,
 * kept to 8 bits (jdlossls.c simple_upscale / noscale) */
static void lossless_planes(Dec *d) {
    for (int ci = 0; ci < d->ncomp; ci++) {
        Comp *c = &d->comp[ci];
        c->plane = zalloc(d, (size_t)c->aw * c->ah);
        if (!c->undiff) continue;
        for (int64_t i = 0; i < (int64_t)c->aw * c->dh; i++)
            c->plane[i] = (uint8_t)(c->undiff[i] << c->lossless_al);
    }
}

/* ---- the whole file ------------------------------------------------------ */

static void decode(Dec *d) {
    d->limit = d->len < CHUNK ? d->len : CHUNK;
    if (read_markers(d) != REACHED_SOS) fail(d, JPEG_DAMAGED, "no image before EOI");
    initial_setup(d);
    if (!d->progressive && !d->arith && !d->lossless) put_std_tables(d);
    if (!d->progressive && d->ncs == d->ncomp) {
        /* one scan: the scanlines come as its MCUs are decoded, in the read
         * of Pillow's in which the scan header ends */
        start_scan(d);
        if (d->lossless)
            lossless_scan(d);
        else
            decode_scan(d, 1);
        /* jpeg_finish_decompress reads on to EOI in what it has been given;
         * running out there is no fault, a second scan is */
        d->in_trailer = 1;
        if (setjmp(d->trailer_jb) == 0)
            if (read_markers(d) == REACHED_SOS)
                fail(d, JPEG_DAMAGED, "a second scan after a single-scan image");
        d->in_trailer = 0;
    } else {
        /* several scans: libjpeg reads the whole file before the first
         * scanline; a Huffman decoder suspends and resumes where a read ends,
         * so only the arithmetic one sees the reads */
        if (!d->arith) d->limit = d->len;
        for (;;) {
            start_scan(d);
            if (d->lossless)
                lossless_scan(d);
            else
                decode_scan(d, 0);
            if (read_markers(d) == REACHED_EOI) break;
        }
        if (d->progressive) latch_smoothing(d);
    }
    if (d->lossless)
        lossless_planes(d);
    else
        reconstruct(d);
}

/* Decodes the JPEG file data[0 .. len) into out, width * height * channels
 * bytes, where width, height and channels are the frame's; writes a message
 * into msg unless the result is JPEG_OK. */
int jpeg_decode(const uint8_t *data, int64_t len, int64_t width, int64_t height,
                int64_t channels, uint8_t *out, char *msg, int64_t msg_cap) {
    Dec *d = calloc(1, sizeof(Dec));
    if (!d) {
        snprintf(msg, (size_t)msg_cap, "out of memory");
        return JPEG_NO_MEMORY;
    }
    d->data = data;
    d->len = len;
    d->ar.fixed_bin = 113;

    d->msg = msg;
    d->msg_cap = msg_cap;
    if (msg_cap > 0) msg[0] = 0;
    if (setjmp(d->fail) == 0) {
        decode(d);
        if (d->width != width || d->height != height || d->ncomp != channels)
            fail(d, JPEG_DAMAGED, "the frame is %dx%d with %d components, not %lldx%lld "
                 "with %lld", d->width, d->height, d->ncomp, (long long)width,
                 (long long)height, (long long)channels);
        write_pixels(d, out);
        d->status = JPEG_OK;
    }
    int status = d->status;
    for (int ci = 0; ci < MAX_COMPS; ci++) {
        free(d->comp[ci].coef);
        free(d->comp[ci].plane);
        free(d->comp[ci].diff);
        free(d->comp[ci].undiff);
        free(d->rows[ci]);
    }
    free(d);
    return status;
}
