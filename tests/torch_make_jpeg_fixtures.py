"""The JPEG variants the port's decoder is held to, and the committed corpus
of them for a machine without Pillow.

    python tests/torch_make_jpeg_fixtures.py     # needs Pillow: a CPU host

writes ``tests/torch_jpeg_fixtures/<name>.jpg`` for every variant and a
``manifest.json`` giving, for each file, what Pillow makes of it: its mode,
its shape and the sha256 of ``np.asarray(PIL.Image.open(f))`` and of
``.convert("RGB")``, or ``"damaged"`` where ``load()`` raises.
``chip_smoke.py`` decodes the corpus with the port and compares digests;
``tests/test_torch_jpeg.py`` writes the same variants under a temporary
directory and compares pixels with Pillow's, and checks that this host's
Pillow still gives the manifest's digests. Regenerate the corpus only on a
host with Pillow, and only when a variant changes.

Each variant is written from numpy pixels made from a seed. Most are
written by Pillow, some then patched byte for byte into layouts this Pillow
cannot write but libjpeg decodes: 4:1:1 sampling (a 4:2:0 file's luma
factors set to 4x1: the same six blocks an MCU, so its entropy-coded data
stays whole) and Adobe's YCCK (a CMYK file's transform byte set to 2). The
``LIBJPEG`` variants use what Pillow's encoder does not offer: arithmetic
coding (with DAC conditioning), 4:4:0 and other sampling factors, scan
scripts that leave coefficients unsent (libjpeg smooths those blocks). They
are written by a small encoder compiled here with ``gcc`` against the host's
libjpeg (its headers and ``-ljpeg``), so only the generator needs them: the
tests read those files from the committed corpus (``variant_bytes``).
Patched from them: 12-bit precision, a hierarchical frame and a fractional
sampling ratio, which Pillow refuses. A libjpeg of API 6.2 cannot write
lossless JPEG (SOF3), so ``lossless_jpeg`` here does: predictors 1-7, the point
transform, restarts, interleaved or one scan a component.
"""
from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg_fixtures")


def smooth(shape, seed: int) -> np.ndarray:
    """uint8 pixels of ``shape`` ([H, W] or [H, W, C]): waves plus noise."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    waves = np.stack([np.sin(x / (5.0 + 3 * k) + k) * 60 + np.cos(y / (4.0 + 2 * k) - k) * 50
                      for k in range(c)], -1) + 128
    out = np.clip(waves + rng.randint(-40, 41, (h, w, c)), 0, 255).astype(np.uint8)
    return out.reshape(shape)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like RGB image: discs of colour over shading, and fine texture."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w)
    img = np.full((h, w, 3), 90.0)
    for _ in range(12):
        cy, cx = rng.rand(2)
        r = 0.05 + 0.35 * rng.rand()
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.rand(3) * 255
    img *= (0.6 + 0.4 * np.cos(3 * x + 2 * y))[..., None]
    img += 20 * np.sin(40 * x + 25 * y)[..., None] + rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _save(pixels, mode, **kw) -> bytes:
    import PIL.Image
    buf = io.BytesIO()
    PIL.Image.fromarray(pixels, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _patch_sampling(data: bytes, old: int, new: int) -> bytes:
    """The file with the first component's sampling byte ``old`` set to ``new``."""
    b = bytearray(data)
    sof = b.index(b"\xff\xc0") if b"\xff\xc0" in b else b.index(b"\xff\xc2")
    assert b[sof + 11] == old, hex(b[sof + 11])
    b[sof + 11] = new
    return bytes(b)


def _adobe_transform(data: bytes, transform: int) -> bytes:
    b = bytearray(data)
    b[b.index(b"Adobe") + 11] = transform
    return bytes(b)


def _exif() -> bytes:
    import PIL.Image
    exif = PIL.Image.Exif()
    exif[0x010F] = "maker"
    exif[0x0112] = 6                    # an orientation, which Image.open does not apply
    return exif.tobytes()


def _variants():
    rgb = lambda h, w, seed: smooth((h, w, 3), seed)          # noqa: E731
    v = {}
    for name, sub in (("444", 0), ("422", 1), ("420", 2)):
        v[f"s{name}"] = lambda s=sub: _save(rgb(40, 56, 1), "RGB", subsampling=s)
        v[f"s{name}_progressive"] = lambda s=sub: _save(rgb(40, 56, 2), "RGB", subsampling=s,
                                                        progressive=True)
    v["s411"] = lambda: _patch_sampling(_save(rgb(48, 64, 3), "RGB", subsampling=2), 0x22, 0x41)
    v["s411_progressive"] = lambda: _patch_sampling(
        _save(rgb(48, 64, 4), "RGB", subsampling=2, progressive=True), 0x22, 0x41)
    v["grey"] = lambda: _save(smooth((37, 29), 5), "L")
    v["grey_progressive"] = lambda: _save(smooth((37, 29), 6), "L", progressive=True)
    v["optimize"] = lambda: _save(rgb(40, 56, 7), "RGB", optimize=True)
    v["optimize_progressive"] = lambda: _save(rgb(40, 56, 8), "RGB", optimize=True,
                                              progressive=True)
    v["restart_blocks"] = lambda: _save(rgb(40, 56, 9), "RGB", restart_marker_blocks=3)
    v["restart_rows"] = lambda: _save(rgb(40, 56, 10), "RGB", restart_marker_rows=1,
                                      subsampling=0)
    v["restart_progressive"] = lambda: _save(rgb(40, 56, 11), "RGB", restart_marker_blocks=2,
                                             progressive=True)
    for q in (1, 50, 95, 100):
        v[f"quality{q}"] = lambda q=q: _save(rgb(40, 56, 12 + q), "RGB", quality=q)
    v["qtables16"] = lambda: _save(rgb(40, 56, 13), "RGB", qtables=[
        [256 + 4 * i for i in range(64)], [300 + 7 * i for i in range(64)]])
    for w, h in ((1, 1), (7, 5), (17, 9), (33, 31), (300, 200)):
        v[f"size{w}x{h}"] = lambda w=w, h=h: _save(rgb(h, w, w + h), "RGB")
        v[f"size{w}x{h}_422_progressive"] = lambda w=w, h=h: _save(
            rgb(h, w, w * h), "RGB", subsampling=1, progressive=True)
    v["exif"] = lambda: _save(rgb(40, 56, 14), "RGB", exif=_exif())
    v["icc"] = lambda: _save(rgb(40, 56, 15), "RGB", icc_profile=bytes(range(256)) * 40)
    v["rgb"] = lambda: _save(rgb(40, 56, 16), "RGB", keep_rgb=True)
    v["cmyk"] = lambda: _save(smooth((40, 56, 4), 17), "CMYK")
    v["cmyk_progressive"] = lambda: _save(smooth((40, 56, 4), 18), "CMYK", progressive=True)
    v["ycck"] = lambda: _adobe_transform(_save(smooth((40, 56, 4), 19), "CMYK"), 2)
    v["truncated"] = lambda: _save(rgb(40, 56, 20), "RGB")[:900]
    v["photo"] = lambda: _save(photo(960, 1280, 21), "RGB", quality=90, subsampling=2)
    v["photo_progressive"] = lambda: _save(photo(960, 1280, 21), "RGB", quality=90,
                                           subsampling=2, progressive=True)
    return v


_ENCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* enc W H NCOMP QUALITY ARITH PROGRESSIVE RESTART SAMPLING SCRIPT DAC_L DAC_U DAC_K
 * SAMPLING "hv,hv,hv" ("" for the defaults); SCRIPT "n:c,c:Ss:Se:Ah:Al;..." or "";
 * pixels on stdin, the JPEG file on stdout */
int main(int argc, char **argv) {
    if (argc != 13) return 2;
    int w = atoi(argv[1]), h = atoi(argv[2]), nc = atoi(argv[3]);
    size_t n = (size_t)w * h * nc;
    unsigned char *px = malloc(n);
    if (!px || fread(px, 1, n, stdin) != n) return 3;
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr jerr;
    c.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&c);
    jpeg_stdio_dest(&c, stdout);
    c.image_width = w;
    c.image_height = h;
    c.input_components = nc;
    c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, atoi(argv[4]), TRUE);
    c.arith_code = atoi(argv[5]) ? TRUE : FALSE;
    c.restart_interval = atoi(argv[7]);
    for (int i = 0; i < 16; i++) {
        c.arith_dc_L[i] = atoi(argv[10]);
        c.arith_dc_U[i] = atoi(argv[11]);
        c.arith_ac_K[i] = atoi(argv[12]);
    }
    const char *samp = argv[8];
    for (int i = 0; i < nc && samp[0]; i++) {
        c.comp_info[i].h_samp_factor = samp[0] - '0';
        c.comp_info[i].v_samp_factor = samp[1] - '0';
        samp += samp[2] == ',' ? 3 : 2;
    }
    if (atoi(argv[6])) jpeg_simple_progression(&c);
    static jpeg_scan_info scans[64];
    char *p = argv[9];
    int ns = 0;
    while (*p) {
        jpeg_scan_info *s = &scans[ns++];
        s->comps_in_scan = (int)strtol(p, &p, 10);
        for (int i = 0; i < s->comps_in_scan; i++)
            s->component_index[i] = (int)strtol(p + 1, &p, 10);
        s->Ss = (int)strtol(p + 1, &p, 10);
        s->Se = (int)strtol(p + 1, &p, 10);
        s->Ah = (int)strtol(p + 1, &p, 10);
        s->Al = (int)strtol(p + 1, &p, 10);
        if (*p == ';') p++;
    }
    if (ns) {
        c.scan_info = scans;
        c.num_scans = ns;
    }
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    return 0;
}
"""


@functools.lru_cache(maxsize=None)
def _encoder() -> str:
    """The libjpeg encoder above, compiled once a process."""
    out = os.path.join(tempfile.mkdtemp(prefix="jpeg_encoder_"), "enc")
    subprocess.run(["gcc", "-O2", "-x", "c", "-", "-o", out, "-ljpeg"], input=_ENCODER.encode(),
                   check=True)
    return out


def libjpeg(pixels, quality=75, arith=False, progressive=False, restart=0, sampling="",
            script="", dac=(0, 1, 5)) -> bytes:
    """A JPEG of uint8 pixels ([H, W] grey or [H, W, 3] RGB, as YCbCr) written
    by the host's libjpeg: ``sampling`` "hv,hv,hv" per component, ``script``
    a scan script "n:c,..:Ss:Se:Ah:Al;..." (a first scan of DC only makes it
    progressive), ``dac`` the arithmetic coder's (L, U) of every DC table
    and K of every AC table."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    nc = 1 if pixels.ndim == 2 else pixels.shape[2]
    args = [w, h, nc, quality, int(arith), int(progressive), restart, sampling, script, *dac]
    return subprocess.run([_encoder(), *map(str, args)], input=pixels.tobytes(),
                          capture_output=True, check=True).stdout


_STD_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)   # codes of length 1-16
_STD_DC_CODES = {}                  # category -> (code, length), JPEG Table K.3
_code = 0
for _length, _count in enumerate(_STD_DC_BITS, 1):
    for _ in range(_count):
        _STD_DC_CODES[len(_STD_DC_CODES)] = (_code, _length)
        _code += 1
    _code <<= 1


class _BitWriter:
    """Entropy-coded bytes: MSB first, 0xFF stuffed with 0x00, 1-bit padding."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc, self.n = (self.acc << 1) | ((value >> i) & 1), self.n + 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def lossless_jpeg(planes, sampling, psv=1, pt=0, restart_rows=0, interleaved=True, ids=None,
                  jfif=False) -> bytes:
    """A lossless JPEG (SOF3, 8-bit) of uint8 component planes, each already
    at its component's size, with sampling factors [(h, v)]: predictor
    ``psv`` (1-7) on samples shifted down ``pt`` bits, the standard DC
    table, a restart every ``restart_rows`` MCU rows, one interleaved scan
    or one scan a component. A row after a scan's start or a restart
    predicts from the left (its first sample from 1 << (7 - pt)), later
    rows by ``psv``, their first sample from above; MCU padding codes
    zeros."""
    n = len(planes)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = planes[0].shape[0] * vmax // sampling[0][1]
    width = planes[0].shape[1] * hmax // sampling[0][0]
    ids = ids or list(range(1, n + 1))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xC3, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([n]) + b"".join(bytes([ids[i], h * 16 + v, 0])
                                            for i, (h, v) in enumerate(sampling)))
    out += _segment(0xC4, bytes([0, *_STD_DC_BITS]) + bytes(range(12)))
    for comps in ([list(range(n))] if interleaved else [[i] for i in range(n)]):
        unit = {c: sampling[c] if len(comps) > 1 else (1, 1) for c in comps}
        if len(comps) > 1:
            mcus_x, mcus_y = -(-width // hmax), -(-height // vmax)
        else:
            mcus_y, mcus_x = planes[comps[0]].shape
        if restart_rows:
            out += _segment(0xDD, (restart_rows * mcus_x).to_bytes(2, "big"))
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps)
                        + bytes([psv, 0, pt]))
        diffs = {}
        for c in comps:
            x = planes[c].astype(np.int64) >> pt
            d = np.zeros((mcus_y * unit[c][1], mcus_x * unit[c][0]), np.int64)
            for y in range(x.shape[0]):
                first = y % (restart_rows * unit[c][1]) == 0 if restart_rows else y == 0
                for i in range(x.shape[1]):
                    if first:
                        pred = x[y, i - 1] if i else 1 << (7 - pt)
                    elif i == 0:
                        pred = x[y - 1, 0]
                    else:
                        ra, rb, rc = x[y, i - 1], x[y - 1, i], x[y - 1, i - 1]
                        pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                    d[y, i] = (x[y, i] - pred + 32768) % 65536 - 32768
            diffs[c] = d
        bits, restarts = _BitWriter(), 0
        for my in range(mcus_y):
            if restart_rows and my and my % restart_rows == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + restarts % 8])
                bits, restarts = _BitWriter(), restarts + 1
            for mx in range(mcus_x):
                for c in comps:
                    h, v = unit[c]
                    for d in diffs[c][my * v:(my + 1) * v, mx * h:(mx + 1) * h].ravel():
                        s = int(abs(d)).bit_length()
                        bits.put(*_STD_DC_CODES[s])
                        if s:
                            bits.put(int(d) if d > 0 else int(d) + (1 << s) - 1, s)
        out += bits.flush()
    return bytes(out + b"\xff\xd9")


def _planes(pixels, sampling):
    """Component planes of [H, W(, C)] pixels at the given sampling factors,
    by taking every (hmax / h)-th column and (vmax / v)-th row."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    pixels = pixels.reshape(pixels.shape[:2] + (-1,))
    return [np.ascontiguousarray(pixels[::vmax // v, ::hmax // h, i])
            for i, (h, v) in enumerate(sampling)]


def _set_sof(data: bytes, offset: int, value: int) -> bytes:
    """The file with byte ``offset`` of its frame header (SOF0-15 marker at
    0) set to ``value``."""
    b = bytearray(data)
    sof = next(i for i in range(len(b) - 1) if b[i] == 0xFF and b[i + 1] in
               (0xC0, 0xC1, 0xC2, 0xC9, 0xCA))
    b[sof + offset] = value
    return bytes(b)


def _libjpeg_variants():
    rgb = lambda h, w, seed: smooth((h, w, 3), seed)          # noqa: E731
    dc_then_luma = "3:0,1,2:0:0:0:0;1:0:1:5:0:1;1:1:1:2:0:0"
    v = {
        "arith_s420": lambda: libjpeg(rgb(40, 56, 31), arith=True, sampling="22,11,11"),
        "arith_s420_progressive": lambda: libjpeg(rgb(40, 56, 32), arith=True,
                                                  progressive=True, sampling="22,11,11"),
        "arith_s444": lambda: libjpeg(rgb(40, 56, 33), arith=True, sampling="11,11,11"),
        "arith_restart": lambda: libjpeg(rgb(40, 56, 34), arith=True, restart=2,
                                         sampling="22,11,11"),
        "arith_restart_progressive": lambda: libjpeg(rgb(40, 56, 35), arith=True,
                                                     progressive=True, restart=3,
                                                     sampling="21,11,11"),
        "arith_grey": lambda: libjpeg(smooth((37, 29), 36), arith=True),
        "arith_grey_progressive": lambda: libjpeg(smooth((37, 29), 37), arith=True,
                                                  progressive=True),
        "arith_dac": lambda: libjpeg(rgb(40, 56, 38), quality=90, arith=True,
                                     progressive=True, sampling="22,11,11", dac=(1, 4, 12)),
        "s440": lambda: libjpeg(rgb(40, 56, 39), sampling="12,11,11"),
        "s440_progressive": lambda: libjpeg(rgb(40, 56, 40), progressive=True,
                                            sampling="12,11,11"),
        "s440_arith": lambda: libjpeg(rgb(40, 56, 41), arith=True, sampling="12,11,11"),
        "s141": lambda: libjpeg(rgb(40, 56, 42), sampling="14,11,11"),
        "s311": lambda: libjpeg(rgb(40, 56, 43), sampling="31,11,11"),
        "s_mixed": lambda: libjpeg(rgb(40, 56, 44), sampling="22,21,12"),
        "smooth_dc_only": lambda: libjpeg(rgb(40, 56, 45), sampling="22,11,11",
                                          script="3:0,1,2:0:0:0:0"),
        "smooth_partial": lambda: libjpeg(rgb(40, 56, 46), sampling="22,11,11",
                                          script=dc_then_luma),
        "smooth_arith": lambda: libjpeg(rgb(40, 56, 47), arith=True, sampling="12,11,11",
                                        script=dc_then_luma),
        "smooth_grey": lambda: libjpeg(smooth((37, 29), 48), script="1:0:0:0:0:1;1:0:1:63:0:2"),
        # the photo-like files chip_smoke.py times beside photo.jpg: the
        # arithmetic-coded ones stay under 64 KiB, past which Pillow reads none
        "photo_arith": lambda: libjpeg(photo(360, 480, 21), quality=85, arith=True,
                                       sampling="22,11,11"),
        "photo_arith_progressive": lambda: libjpeg(photo(360, 480, 21), quality=85,
                                                   arith=True, progressive=True,
                                                   sampling="22,11,11"),
        "photo_440": lambda: libjpeg(photo(360, 480, 21), quality=85, sampling="12,11,11"),
    }
    for w, h in ((1, 1), (7, 5), (17, 9), (33, 31)):
        v[f"size{w}x{h}_arith_progressive"] = lambda w=w, h=h: libjpeg(
            rgb(h, w, 50 + w + h), arith=True, progressive=True, sampling="22,11,11")
        v[f"size{w}x{h}_440_smooth"] = lambda w=w, h=h: libjpeg(
            rgb(h, w, 60 + w * h), sampling="12,11,11", script="3:0,1,2:0:0:0:0")
    s420, s440 = [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]
    v.update({
        "lossless_grey": lambda: lossless_jpeg(_planes(smooth((23, 29), 70), [(1, 1)]),
                                               [(1, 1)], psv=1),
        "lossless_grey_pt2": lambda: lossless_jpeg(_planes(smooth((23, 29), 71), [(1, 1)]),
                                                   [(1, 1)], psv=2, pt=2),
        "lossless_rgb": lambda: lossless_jpeg(_planes(rgb(24, 32, 72), [(1, 1)] * 3),
                                              [(1, 1)] * 3, psv=3, ids=[82, 71, 66]),
        "lossless_s420": lambda: lossless_jpeg(_planes(rgb(24, 32, 73), s420), s420, psv=4,
                                               pt=1),
        "lossless_restart": lambda: lossless_jpeg(_planes(rgb(24, 32, 74), s420), s420, psv=5,
                                                  restart_rows=2),
        # a restart inside an iMCU row of the 1x2 luma: libjpeg sets the
        # predictors of that iMCU row's both rows back, so the file decodes
        # unlike its pixels (as Pillow decodes it all the same)
        "lossless_scans": lambda: lossless_jpeg(_planes(rgb(24, 32, 75), s440), s440, psv=6,
                                                interleaved=False, restart_rows=3),
        "lossless_cmyk": lambda: lossless_jpeg(_planes(smooth((16, 20, 4), 76), [(1, 1)] * 4),
                                               [(1, 1)] * 4, psv=7),
        "size7x5_lossless": lambda: lossless_jpeg(_planes(rgb(6, 8, 77)[:5, :7], s420)[:1]
                                                  + _planes(rgb(6, 8, 77), s420)[1:], s420,
                                                  psv=7),
        # a JFIF file says YCbCr, which libjpeg does not convert in a lossless frame
        "lossless_ycbcr": lambda: lossless_jpeg(_planes(rgb(24, 32, 78), [(1, 1)] * 3),
                                                [(1, 1)] * 3, jfif=True),
    })
    # what Pillow refuses: 12-bit samples (at open), a hierarchical frame and
    # sampling factors of a fractional ratio, 3x2 under 2x1 (at load)
    v["precision12"] = lambda: _set_sof(v["arith_s444"](), 4, 12)
    v["hierarchical"] = lambda: _set_sof(v["s440"](), 1, 0xC5)
    v["fractional"] = lambda: _set_sof(_set_sof(v["s440"](), 11, 0x32), 14, 0x21)
    return v


VARIANTS = _variants()
LIBJPEG = _libjpeg_variants()


def variant_bytes(name: str) -> bytes:
    """A variant's bytes: written here by Pillow, or, for a ``LIBJPEG`` one,
    read from the committed corpus."""
    if name in LIBJPEG:
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
            return f.read()
    return VARIANTS[name]()


def write_variant(name: str, path: str) -> str:
    with open(path, "wb") as f:
        f.write(variant_bytes(name))
    return path


def digest(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def pillow_record(path: str):
    """What Pillow makes of the file: its mode, shape and digests, or "damaged"."""
    import PIL.Image
    try:
        with PIL.Image.open(path) as im:
            pixels = np.asarray(im)
            return {"mode": im.mode, "shape": list(pixels.shape), "sha256": digest(pixels),
                    "sha256_rgb": digest(np.asarray(im.convert("RGB")))}
    except OSError:
        return "damaged"


def main() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    manifest = {}
    for name, make in {**VARIANTS, **LIBJPEG}.items():
        path = os.path.join(FIXTURES, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(make())
        manifest[f"{name}.jpg"] = pillow_record(path)
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes in {FIXTURES}", file=sys.stderr)


if __name__ == "__main__":
    main()
