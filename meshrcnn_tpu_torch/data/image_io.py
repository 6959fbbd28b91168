"""PNG and JPEG reading, PNG writing and Pillow's two resampling filters,
without Pillow (the card's machine has none).

    pixels, mode = read_image(path)    # np.asarray(PIL.Image.open(path)), and its mode
    pixels, mode = read_png(path)      # the same, for PNG files only
    rgb = to_rgb(path)                 # PIL.Image.open(path).convert("RGB")
    mode = image_mode(path)            # PIL.Image.open(path).mode, from the header
    write_png(path, uint8 array)
    resize_bilinear(pixels, (w, h))    # Image.resize((w, h), BILINEAR)
    resize_nearest(pixels, (w, h))     # Image.resize((w, h), NEAREST)

Only numpy, ``zlib``, ``struct`` and the native decoders of ``data/fastio``
(the PNG scanline unfilter and Adam7 de-interlace, and the JPEG decoder
``csrc/jpeg.c``). A PNG or JPEG file gives exactly what Pillow gives it.
PNG: every bit depth and colour type, interlaced (Adam7) or not, in
Pillow's modes: palette images give their indices, 1-bit grey gives
booleans, 2- and 4-bit grey are scaled to 0-255 (Pillow's "L;2" and "L;4"),
16-bit grey is "I;16" (the uint16 values), 16-bit RGB, grey + alpha and
RGBA give the high byte of each sample ("RGB", and "RGBA" with the grey
copied thrice). JPEG: baseline, progressive, arithmetic-coded and lossless
files, any integral sampling ratio, give what Pillow gives on libjpeg-turbo,
bit for bit: mode "L" for one component, "RGB" for three (YCbCr converted
unless the file is RGB), "CMYK" for four, inverted as Pillow stores Adobe's
CMYK. The header walk that finds the mode is Pillow's
(JpegImageFile._open), so a file Pillow cannot open is damaged here too.

Errors: a file that is not a readable image raises ``DamagedImageError``,
an ``OSError`` like Pillow's own for such files, exactly where Pillow's
``open`` or ``load`` raises: PNG without its signature, with a bad chunk
CRC, a broken zlib stream or too little data; JPEG that ends before its
last scanline is decoded, or that libjpeg stops on (hierarchical frames,
samples of other than 8 bits, fractional sampling ratios, an arithmetic-
coded scan that runs past one of Pillow's 64 KiB reads). ``ValueError``
names the file and the format for what this module does not decode: GIF,
BMP, TIFF and WebP, by their magic bytes.

The resizes are Pillow's (libImaging/Resample.c and the NEAREST branch of
``_resize``, which goes through ImagingScaleAffine in Geometry.c), reproduced
bit for bit: BILINEAR is a separable convolution with a triangle filter whose
support widens by the downscale factor. For 8-bit images its coefficients are
made fixed-point at 22 bits and the horizontal pass is rounded to uint8 before
the vertical one; for float32 images (Pillow's mode "F") the coefficients stay
float64 and each pass is stored as float32. NEAREST takes the source pixel of
each output pixel's centre, stepping the source coordinate by repeated
addition as Pillow does.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from meshrcnn_tpu_torch.data import fastio

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# (offset, magic bytes, name) of the formats this module recognises and does not decode
_OTHER_FORMATS = ((0, b"GIF8", "GIF"), (0, b"BM", "BMP"), (0, b"II*\x00", "TIFF"),
                  (0, b"MM\x00*", "TIFF"), (8, b"WEBP", "WebP"))
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
# markers whose segment JpegImageFile._open reads as a frame header
_JPEG_SOF = {0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9, 0xFFCA,
             0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFDE}
# (bit depth, colour type) -> Pillow's mode of the image
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
          (8, 2): "RGB", (16, 2): "RGB",
          (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
          (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2          # Resample.c's fixed point for 8-bit images


class DamagedImageError(OSError):
    """The file is not a readable image: Pillow could not decode it either."""


def _header(path: str, data: bytes) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of a PNG's IHDR."""
    if not data.startswith(PNG_SIGNATURE):
        if data.startswith(JPEG_SIGNATURE):
            raise ValueError(f"{path}: JPEG is not read by read_png; read_image reads it")
        for offset, magic, name in _OTHER_FORMATS:
            if data[offset:offset + len(magic)] == magic:
                raise ValueError(f"{path}: {name} is not supported; only PNG and JPEG are "
                                 f"decoded")
        raise DamagedImageError(f"{path}: not an image file (no PNG or JPEG signature)")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise DamagedImageError(f"{path}: truncated or missing IHDR chunk")
    width, height, depth, ctype, _, filtering, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if filtering:                     # PngImagePlugin's IHDR check; any interlace flag is Adam7
        raise DamagedImageError(f"{path}: filter method {filtering}")
    if (depth, ctype) not in _MODES or width == 0 or height == 0:
        raise DamagedImageError(f"{path}: bit depth {depth} with colour type {ctype}, "
                                f"size {width}x{height}")
    return width, height, depth, ctype, interlace


def _jpeg_header(path: str, data: bytes) -> Tuple[int, int, str]:
    """(width, height, mode) of a JPEG file, read as Pillow's
    ``JpegImageFile._open`` reads it: marker by marker up to the first SOS,
    the last frame header giving size and mode, and raising
    ``DamagedImageError`` wherever ``PIL.Image.open`` raises."""
    n = len(data)
    pos, width, height, mode, icc = 3, 0, 0, None, []

    def damaged(why: str):
        return DamagedImageError(f"{path}: {why}")

    def segment() -> bytes:           # i16(fp.read(2)) - 2, then ImageFile._safe_read
        nonlocal pos
        if pos + 2 > n:
            raise damaged("the file ends inside a marker")
        size = int.from_bytes(data[pos:pos + 2], "big") - 2
        pos += 2
        if size <= 0:
            return b""
        if pos + size > n:
            raise damaged("the file ends inside a marker segment")
        pos += size
        return data[pos - size:pos]

    byte = 0xFF
    while True:
        if byte is None:
            raise damaged("the file ends before its first scan")
        if byte != 0xFF:              # junk between markers
            byte, pos = (data[pos], pos + 1) if pos < n else (None, pos)
            continue
        if pos >= n:
            raise damaged("the file ends inside a marker")
        marker, pos = 0xFF00 | data[pos], pos + 1
        if 0xFFC0 <= marker <= 0xFFFE:
            if marker in _JPEG_SOF:
                s = segment()
                if len(s) < 6:
                    raise damaged("a short frame header")
                height, width = struct.unpack(">HH", s[1:5])
                if s[0] != 8:
                    raise damaged(f"a JPEG of {s[0]}-bit samples")
                if s[5] not in _JPEG_MODES:
                    raise damaged(f"a JPEG of {s[5]} components")
                mode = _JPEG_MODES[s[5]]
                if icc and len(min(icc)) < 14:
                    raise damaged("a short ICC profile segment")
                icc = []
                if (len(s) - 6) % 3:
                    raise damaged("a frame header of the wrong length")
            elif marker == 0xFFDB:
                s = segment()
                while s:
                    length = 65 if s[0] < 16 else 129
                    if len(s) < length:
                        raise damaged("a bad quantisation table")
                    s = s[length:]
            elif 0xFFE0 <= marker <= 0xFFEF:
                _jpeg_app(path, marker, segment(), icc)
            elif marker in (0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDF, 0xFFFE):
                segment()
            if marker == 0xFFDA:
                break
            byte, pos = (data[pos], pos + 1) if pos < n else (None, pos)
        elif marker == 0xFFFF:        # fill byte before a marker
            byte = 0xFF
        elif marker == 0xFF00:
            byte, pos = (data[pos], pos + 1) if pos < n else (None, pos)
        else:
            raise damaged(f"no marker at byte {pos - 2}")
    if mode is None or width == 0 or height == 0:
        raise damaged("no frame header before the first scan, or an empty frame")
    return width, height, mode


def _jpeg_app(path: str, marker: int, s: bytes, icc: list) -> None:
    """The APPn parsing of JpegImagePlugin.APP that can fail: JFIF and Adobe
    need their version field, a Photoshop resource block its name length;
    ICC profile segments are kept for the frame header's check."""
    if marker in (0xFFE0, 0xFFEE) and s.startswith(b"JFIF" if marker == 0xFFE0 else b"Adobe"):
        if len(s) < 7:
            raise DamagedImageError(f"{path}: a short APP{marker & 15} segment")
    elif marker == 0xFFE2 and s.startswith(b"ICC_PROFILE\0"):
        icc.append(s)
    elif marker == 0xFFED and s.startswith(b"Photoshop 3.0\x00"):
        offset = 14
        while s[offset:offset + 4] == b"8BIM":
            offset += 4
            if offset + 2 > len(s):   # struct.error: the loop ends
                break
            code = int.from_bytes(s[offset:offset + 2], "big")
            offset += 2
            if offset >= len(s):      # IndexError: Image.open fails
                raise DamagedImageError(f"{path}: a short Photoshop resource block")
            offset += 1 + s[offset]
            offset += offset & 1
            if offset + 4 > len(s):
                break
            size = int.from_bytes(s[offset:offset + 4], "big")
            offset += 4
            if code == 0x03ED and len(s[offset:offset + size]) < 14:
                break
            offset += size
            offset += offset & 1


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def image_mode(path: str) -> str:
    """Pillow's mode of the image file, from its header alone."""
    data = _read(path)
    if data.startswith(JPEG_SIGNATURE):
        return _jpeg_header(path, data)[2]
    _, _, depth, ctype, _ = _header(path, data)
    return _MODES[depth, ctype]


def _decode_jpeg(path: str, data: bytes) -> Tuple[np.ndarray, str]:
    """(pixels as Pillow gives them, mode) of a JPEG file."""
    width, height, mode = _jpeg_header(path, data)
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    try:
        pixels = fastio.decode_jpeg(data, width, height, channels)
    except OSError as err:
        raise DamagedImageError(f"{path}: {err}") from None
    if mode == "L":
        return pixels[..., 0], mode
    if mode == "CMYK":                # Pillow's raw mode "CMYK;I": Adobe's inverted samples
        return 255 - pixels, mode
    return pixels, mode


def _decode_png(path: str, data: bytes):
    """(pixels as Pillow gives them, mode, palette [n, 3] uint8 or None) of a PNG."""
    width, height, depth, ctype, interlace = _header(path, data)
    idat, palette, pos = [], None, 8
    while True:
        if pos + 12 > len(data):
            raise DamagedImageError(f"{path}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise DamagedImageError(f"{path}: truncated {kind!r} chunk")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise DamagedImageError(f"{path}: bad CRC in the {kind!r} chunk")
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ctype == 3 and palette is None:
        raise DamagedImageError(f"{path}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise DamagedImageError(f"{path}: broken image data ({err})") from None
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    try:
        if interlace:
            rows = fastio.png_adam7(raw, width, height, channels * depth)
        else:
            rows = fastio.png_unfilter(raw, height, stride, channels * depth // 8)
    except ValueError as err:
        raise DamagedImageError(f"{path}: {err}") from None
    mode = _MODES[depth, ctype]
    if depth == 8:
        pixels = rows.reshape(height, width, channels)
        return (pixels[..., 0] if channels == 1 else pixels), mode, palette
    if depth == 16:                   # big-endian samples, in Pillow's raw modes
        if ctype == 0:                # "I;16B": the values
            return rows.view(">u2").astype(np.uint16), mode, palette
        high = np.ascontiguousarray(rows.reshape(height, width, channels, 2)[..., 0])
        if ctype == 4:                # "LA;16B" into RGBA: grey thrice, then alpha
            high = np.ascontiguousarray(high[..., [0, 0, 0, 1]])
        return high, mode, palette    # "RGB;16B", "RGBA;16B": the high bytes
    # 1, 2 or 4 bits a sample, most significant first, each row padded to a byte
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)
    samples = np.ascontiguousarray(samples[:, :width])
    if mode == "1":
        return samples.astype(bool), mode, palette
    if mode == "L":
        return samples * np.uint8(255 // ((1 << depth) - 1)), mode, palette
    return samples, mode, palette


def _decode(path: str):
    """(pixels, mode, palette or None) of a PNG or JPEG file, told apart by
    their signatures."""
    data = _read(path)
    if data.startswith(JPEG_SIGNATURE):
        return (*_decode_jpeg(path, data), None)
    return _decode_png(path, data)


def read_png(path: str) -> Tuple[np.ndarray, str]:
    """(``np.asarray(PIL.Image.open(path))``, Pillow's mode name) of a PNG file."""
    pixels, mode, _ = _decode_png(path, _read(path))
    return pixels, mode


def read_image(path: str) -> Tuple[np.ndarray, str]:
    """(``np.asarray(PIL.Image.open(path))``, Pillow's mode name) of a PNG or
    JPEG file."""
    pixels, mode, _ = _decode(path)
    return pixels, mode


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of CMYK pixels (libImaging/Convert.c
    cmyk2rgb): each channel nk - round(channel * nk / 255), nk = 255 - K."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def to_rgb(path: str) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert("RGB"))`` of a PNG or JPEG
    file: grey replicated, alpha dropped, palette indices looked up (indices
    past the palette black), CMYK by Pillow's formula."""
    pixels, mode, palette = _decode(path)
    if mode == "CMYK":
        return _cmyk_to_rgb(pixels)
    if mode == "RGB":
        return pixels
    if mode == "RGBA":
        return np.ascontiguousarray(pixels[..., :3])
    if mode == "P":
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pixels]
    grey = pixels[..., 0] if mode == "LA" else pixels
    if mode == "1":
        grey = grey.astype(np.uint8) * np.uint8(255)
    if mode == "I;16":                # Convert.c I16_RGB: values past 255 are 255
        grey = np.minimum(grey, 255).astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=-1)


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey), [H, W, 2] (grey + alpha), [H, W, 3] (RGB)
    or [H, W, 4] (RGBA) array as an 8-bit PNG: filter 0 on every row, zlib."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {pixels.dtype}")
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(pixels.shape[-1]) if pixels.ndim == 3 else None
    if ctype is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4] pixels, not {pixels.shape}")
    height, width = pixels.shape[:2]
    rows = np.zeros((height, 1 + width * pixels.shape[-1]), np.uint8)   # filter type 0
    rows[:, 1:] = pixels.reshape(height, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _bilinear_coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` with the triangle filter: per output
    pixel, the first input pixel of its window [out], the window's length
    [out] and its float64 weights [out, ksize], zero past the window's end."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xlen = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None] + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where((t < 1.0) & (x[None] < xlen[:, None]), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                 # summed in the C loop's order
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, xlen, w


def _resample_axis(pixels: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of ImagingResample along ``axis`` (1 horizontal, 0 vertical):
    native for uint8 images, numpy for float32 ones."""
    shape = pixels.shape
    xmin, xlen, w = _bilinear_coeffs(shape[axis], out_size)
    outer, inner = int(np.prod(shape[:axis])), int(np.prod(shape[axis + 1:]))
    flat = pixels.reshape(outer, shape[axis], inner)
    if pixels.dtype == np.uint8:
        k = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
        out = fastio.resample_u8(flat, xmin, xlen, k.astype(np.int32))
    else:
        index = np.minimum(xmin[:, None] + np.arange(w.shape[1])[None], shape[axis] - 1)
        acc = np.zeros((outer, out_size, inner), np.float64)
        for j in range(w.shape[1]):        # float64 sums in the C loop's order
            acc = acc + flat[:, index[:, j]].astype(np.float64) * w[None, :, j, None]
        out = acc.astype(np.float32)
    return out.reshape(shape[:axis] + (out_size,) + shape[axis + 1:])


def resize_bilinear(pixels: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(pixels).resize(size, Image.BILINEAR))`` for
    uint8 [H, W] or [H, W, C] pixels and float32 [H, W] ones; ``size`` is
    (width, height)."""
    pixels = np.asarray(pixels)
    if pixels.dtype not in (np.uint8, np.float32) or pixels.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear takes uint8 or float32 images, not "
                         f"{pixels.dtype} {pixels.shape}")
    width, height = size
    out = pixels
    if width != pixels.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != pixels.shape[0]:
        out = _resample_axis(out, height, 0)
    return out.copy() if out is pixels else out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """ImagingScaleAffine's source pixel of each output pixel: the coordinate
    starts at half a step and grows by one step an output pixel."""
    step = in_size / out_size
    coords = np.full(out_size, step)
    coords[0] = 0.0 + step * 0.5
    coords = np.add.accumulate(coords)      # sequential sums, as the C loop adds
    return np.minimum(coords.astype(np.int64), in_size - 1)


def resize_nearest(pixels: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(pixels).resize(size, Image.NEAREST))``;
    ``size`` is (width, height)."""
    pixels = np.asarray(pixels)
    width, height = size
    return pixels[_nearest_index(pixels.shape[0], height)[:, None],
                  _nearest_index(pixels.shape[1], width)[None, :]]
