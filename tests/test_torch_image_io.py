"""The port's image module (meshrcnn_tpu_torch/data/image_io.py) against
Pillow, which is its reference: every comparison is exact (bit for bit, dtype
and shape included), no tolerance.

Files come from Pillow where Pillow writes the mode (8-bit grey, grey +
alpha, RGB, RGBA, 1-bit grey, 1/2/4/8-bit palette; Pillow picks the filter of
each row) and from a small encoder here where it does not (2- and 4-bit grey,
16-bit samples of every colour type, Adam7 interlacing of every depth and
colour type, every one of the five filter types on every row, several IDAT
chunks, broken files). The resizes are held to ``Image.resize`` over
``hypothesis``-drawn sizes, up and down, uint8 and float32 (mode "F").
"""
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from meshrcnn_tpu_torch.data import image_io

RNG = np.random.RandomState(0)


def _pillow(path):
    with PIL.Image.open(path) as im:
        return np.asarray(im), im.mode, np.asarray(im.convert("RGB"))


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _check_against_pillow(path):
    want, mode, rgb = _pillow(path)
    got, got_mode = image_io.read_png(str(path))
    assert got_mode == mode
    _assert_same(got, want)
    _assert_same(image_io.to_rgb(str(path)), rgb)
    assert image_io.image_mode(str(path)) == mode


def _pillow_image(kind, h, w):
    if kind in ("RGB", "RGBA", "LA"):
        return PIL.Image.fromarray(RNG.randint(0, 256, (h, w, len(kind)), dtype=np.uint8), kind)
    if kind == "L":
        return PIL.Image.fromarray(RNG.randint(0, 256, (h, w), dtype=np.uint8))
    if kind == "1":
        return PIL.Image.fromarray(RNG.rand(h, w) > 0.5)
    bits = int(kind[1:])                     # "P8", "P4", "P2", "P1"
    im = PIL.Image.fromarray(RNG.randint(0, 1 << bits, (h, w), dtype=np.uint8), "P")
    im.putpalette(RNG.randint(0, 256, 3 << bits).tolist())
    return im


@pytest.mark.parametrize("kind", ["RGB", "RGBA", "L", "LA", "1", "P8", "P4", "P2", "P1"])
def test_read_png_and_to_rgb_equal_pillow_on_files_pillow_writes(tmp_path, kind):
    for h, w in ((1, 1), (13, 17), (40, 61)):
        path = tmp_path / f"{kind}_{h}x{w}.png"
        kw = {"bits": int(kind[1:])} if kind.startswith("P") else {}
        _pillow_image(kind, h, w).save(path, **kw)
        _check_against_pillow(path)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows, bpp, filters):
    """PNG scanlines of packed rows [H, stride], row i with filter filters[i]."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for row, ft in zip(rows.astype(np.int64), filters):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, upleft)])
        out.append(ft)
        out += bytes(((row - pred) % 256).astype(np.uint8))
        prev = row
    return bytes(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    """The packed rows [H, stride] of samples [H, W(, C)] at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16 if depth == 16 else np.uint8)
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-flat.shape[1] // per) * per), np.uint8)
        padded[:, :flat.shape[1]] = flat
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    return flat


# Adam7's passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _encode(path, samples, depth, ctype, filters=None, palette=None, interlace=0, splits=1):
    """A PNG of ``samples`` [H, W(, C)] at ``depth`` bits, colour type
    ``ctype``; interlaced, each non-empty Adam7 pass is filtered as an image
    of its own, row i of all the passes together with filter filters[i]."""
    h, w = samples.shape[:2]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    passes = [samples[y0::dy, x0::dx] for y0, x0, dy, dx in ADAM7] if interlace else [samples]
    passes = [p for p in passes if p.shape[0] and p.shape[1]]
    filters = filters if filters is not None else [0] * sum(p.shape[0] for p in passes)
    scanlines, row = b"", 0
    for p in passes:
        scanlines += _filter_rows(_pack(p, depth), bpp, filters[row:row + p.shape[0]])
        row += p.shape[0]
    data = zlib.compress(scanlines)
    cut = np.linspace(0, len(data), splits + 1).astype(int)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += b"".join(_chunk(b"IDAT", data[a:b]) for a, b in zip(cut, cut[1:]))
    Path(path).write_bytes(image_io.PNG_SIGNATURE + body + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0), (8, 2), (8, 3), (2, 3),
                                         (8, 4), (8, 6)])
def test_every_filter_type_depth_and_split_data_equal_pillow(tmp_path, depth, ctype):
    """Rows cycling through filters 0-4 (Pillow never writes Average), grey
    at 2 and 4 bits (scaled to 0-255 as Pillow's "L;2" / "L;4"), the image
    data split over three IDAT chunks."""
    h, w = 11, 13
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = RNG.randint(0, 1 << depth, (h, w, channels)).squeeze(-1 if channels == 1 else ())
    palette = RNG.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = tmp_path / f"d{depth}c{ctype}.png"
    _encode(path, samples, depth, ctype, [i % 5 for i in range(h)], palette, splits=3)
    _check_against_pillow(path)


def test_palette_index_past_the_palette_is_black(tmp_path):
    path = tmp_path / "short_palette.png"
    _encode(path, np.array([[0, 1, 5]]), 8, 3, palette=np.array([[10, 20, 30], [40, 50, 60]]))
    _check_against_pillow(path)
    np.testing.assert_array_equal(image_io.to_rgb(str(path))[0, 2], [0, 0, 0])


@pytest.mark.parametrize("channels", [None, 2, 3, 4])
def test_write_png_round_trips_through_pillow(tmp_path, channels):
    shape = (23, 31) if channels is None else (23, 31, channels)
    pixels = RNG.randint(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    image_io.write_png(str(path), pixels)
    _assert_same(np.asarray(PIL.Image.open(path)), pixels)
    _assert_same(image_io.read_png(str(path))[0], pixels)
    with pytest.raises(ValueError):
        image_io.write_png(str(path), pixels.astype(np.float32))


def _unsupported_files(root):
    jpeg = root / "photo.png"                  # a JPEG whatever its name says
    PIL.Image.fromarray(RNG.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(jpeg, "JPEG")
    gif = root / "anim.gif"
    PIL.Image.fromarray(RNG.randint(0, 256, (8, 8), dtype=np.uint8)).save(gif)
    grey16 = root / "grey16.png"
    _encode(grey16, RNG.randint(0, 1 << 16, (5, 6)), 16, 0)
    rgb16 = root / "rgb16.png"
    _encode(rgb16, RNG.randint(0, 1 << 16, (5, 6, 3)), 16, 2)
    interlaced = root / "adam7.png"
    _encode(interlaced, RNG.randint(0, 256, (5, 6, 3)), 8, 2, interlace=1)
    return {gif: "GIF"}, (grey16, rgb16, interlaced)


def test_unsupported_files_raise_naming_the_file_and_the_feature(tmp_path):
    """GIF (like BMP, TIFF and WebP) raises naming the file and the format;
    16-bit and interlaced PNG, which raised before the port read them,
    decode as Pillow decodes them."""
    unsupported, decoded = _unsupported_files(tmp_path)
    for path, feature in unsupported.items():
        for fn in (image_io.read_png, image_io.read_image, image_io.to_rgb):
            with pytest.raises(ValueError, match=re.escape(str(path)) + ".*" + feature):
                fn(str(path))
    for path in decoded:
        _check_against_pillow(path)
    # a JPEG, whatever its name says, decodes as Pillow decodes it; read_png
    # reads PNG only and says so (tests/test_torch_jpeg.py holds the decoder)
    jpeg = tmp_path / "photo.png"
    with PIL.Image.open(jpeg) as im:
        _assert_same(image_io.read_image(str(jpeg))[0], np.asarray(im))
        _assert_same(image_io.to_rgb(str(jpeg)), np.asarray(im.convert("RGB")))
        assert image_io.image_mode(str(jpeg)) == im.mode == "RGB"
    with pytest.raises(ValueError, match=re.escape(str(jpeg)) + ".*JPEG"):
        image_io.read_png(str(jpeg))
    # the header alone gives Pillow's mode of a 16-bit or interlaced PNG
    assert image_io.image_mode(str(tmp_path / "grey16.png")) == "I;16"
    assert image_io.image_mode(str(tmp_path / "rgb16.png")) == "RGB"
    assert image_io.image_mode(str(tmp_path / "adam7.png")) == "RGB"


ALL_DEPTHS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
              (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("depth,ctype", ALL_DEPTHS)
def test_adam7_and_16_bit_equal_pillow(tmp_path, depth, ctype):
    """Every bit depth and colour type interlaced (Adam7: seven passes, each
    filtered as an image of its own width, the empty ones absent at the
    small sizes), filters 0-4 cycling over the passes' rows; 16-bit samples
    also plain: "I;16" gives the values, RGB, grey + alpha and RGBA the high
    bytes, and ``to_rgb`` of "I;16" is Pillow's (values past 255 are 255)."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = RNG.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    for interlace in (1, 0) if depth == 16 else (1,):
        for h, w in ((1, 1), (1, 3), (2, 1), (5, 6), (9, 13), (17, 4)):
            samples = RNG.randint(0, 1 << depth, (h, w, channels)).squeeze(
                -1 if channels == 1 else ())
            if depth == 16:                # small values too, which "I;16" -> RGB keeps
                samples[::2] %= 300
            path = tmp_path / f"d{depth}c{ctype}i{interlace}_{h}x{w}.png"
            _encode(path, samples, depth, ctype, [i % 5 for i in range(3 * h)], palette,
                    interlace=interlace, splits=2)
            _check_against_pillow(path)


def test_damaged_interlaced_files_raise_where_pillow_raises(tmp_path):
    """A filter type outside 0-4 in a later pass, and passes cut short."""
    samples = RNG.randint(0, 256, (9, 11, 3))
    scanlines = b""
    for y0, x0, dy, dx in ADAM7:
        part = samples[y0::dy, x0::dx]
        scanlines += _filter_rows(_pack(part, 8), 3, [0] * part.shape[0])
    header = _chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 1))
    last = len(scanlines) - (11 * 3 + 1) * 4        # pass 7's first scanline
    bodies = {"bad filter": scanlines[:last] + b"\x05" + scanlines[last + 1:],
              "short": scanlines[:-5], "short pass 1": scanlines[:3]}
    for name, body in bodies.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(image_io.PNG_SIGNATURE + header + _chunk(b"IDAT", zlib.compress(body))
                         + _chunk(b"IEND", b""))
        with pytest.raises(image_io.DamagedImageError, match=re.escape(str(path))):
            image_io.read_image(str(path))
        with pytest.raises(OSError):
            with PIL.Image.open(path) as im:
                im.load()
    # IHDR: a filter method other than 0 is refused at open; any nonzero
    # interlace method is read as Adam7
    idat = _chunk(b"IDAT", zlib.compress(scanlines)) + _chunk(b"IEND", b"")
    for filtering, interlace in ((1, 1), (0, 2)):
        path = tmp_path / f"ihdr_{filtering}_{interlace}.png"
        path.write_bytes(image_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 11, 9, 8, 2, 0, filtering, interlace)) + idat)
        if filtering:
            with pytest.raises(image_io.DamagedImageError, match="filter method 1"):
                image_io.image_mode(str(path))
            with pytest.raises(OSError):
                PIL.Image.open(path)
        else:
            _check_against_pillow(path)


def test_damaged_files_raise_damaged_image_error(tmp_path):
    good = tmp_path / "good.png"
    image_io.write_png(str(good), RNG.randint(0, 256, (9, 7, 3), dtype=np.uint8))
    data = good.read_bytes()
    idat = data.index(b"IDAT")
    broken = {"truncated": data[:len(data) // 2], "not an image": b"hello, world" * 4,
              "bad crc": data[:idat + 6] + bytes([data[idat + 6] ^ 1]) + data[idat + 7:],
              "empty": b""}
    zdata = zlib.compress(b"\x07" + bytes(21))            # filter type 7 on a 1x7 RGB row
    broken["bad filter"] = (image_io.PNG_SIGNATURE
                            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 1, 8, 2, 0, 0, 0))
                            + _chunk(b"IDAT", zdata) + _chunk(b"IEND", b""))
    for name, body in broken.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(body)
        with pytest.raises(image_io.DamagedImageError, match=re.escape(str(path))):
            image_io.read_png(str(path))
        with pytest.raises(OSError):            # Pillow cannot read it either
            with PIL.Image.open(path) as im:
                im.load()


def _pillow_resize(pixels, size, resample):
    return np.asarray(PIL.Image.fromarray(pixels).resize(size, resample))


@pytest.mark.parametrize("shape,size", [((32, 32, 3), (137, 137)), ((137, 137, 3), (32, 32)),
                                        ((800, 1000, 3), (224, 179)), ((40, 60, 3), (64, 43)),
                                        ((200, 300, 3), (224, 224)), ((5, 3), (1, 1))])
def test_resizes_equal_pillow_at_the_paths_sizes(shape, size):
    """32 -> 137 (a render), 137 -> 32, a Pix3D image of 1000x800 letterboxed
    to 224, the demo's 300x200 -> 224x224; uint8, grey and RGB."""
    pixels = RNG.randint(0, 256, shape, dtype=np.uint8)
    _assert_same(image_io.resize_bilinear(pixels, size),
                 _pillow_resize(pixels, size, PIL.Image.BILINEAR))
    _assert_same(image_io.resize_nearest(pixels, size),
                 _pillow_resize(pixels, size, PIL.Image.NEAREST))


sizes = st.integers(1, 90)


@settings(max_examples=60, deadline=None)
@given(h=sizes, w=sizes, out_h=sizes, out_w=sizes, channels=st.sampled_from([None, 3]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_resizes_equal_pillow_over_drawn_sizes(h, w, out_h, out_w, channels, seed):
    rng = np.random.RandomState(seed)
    pixels = rng.randint(0, 256, (h, w) if channels is None else (h, w, channels),
                         dtype=np.uint8)
    _assert_same(image_io.resize_bilinear(pixels, (out_w, out_h)),
                 _pillow_resize(pixels, (out_w, out_h), PIL.Image.BILINEAR))
    _assert_same(image_io.resize_nearest(pixels, (out_w, out_h)),
                 _pillow_resize(pixels, (out_w, out_h), PIL.Image.NEAREST))
    mask = rng.rand(h, w).astype(np.float32)                 # Pillow's mode "F"
    _assert_same(image_io.resize_bilinear(mask, (out_w, out_h)),
                 _pillow_resize(mask, (out_w, out_h), PIL.Image.BILINEAR))


def test_nothing_imports_pillow(monkeypatch, tmp_path):
    """Under a ``sys.modules`` block every path of the module runs; and no
    source of the port or chip_smoke.py imports PIL or JAX."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    path = str(tmp_path / "x.png")
    pixels = RNG.randint(0, 256, (30, 20, 3), dtype=np.uint8)
    image_io.write_png(path, pixels)
    _assert_same(image_io.read_png(path)[0], pixels)
    _assert_same(image_io.to_rgb(path), pixels)
    assert image_io.resize_bilinear(pixels, (9, 11)).shape == (11, 9, 3)
    assert image_io.resize_nearest(pixels, (9, 11)).shape == (11, 9, 3)
    root = Path(__file__).resolve().parent.parent
    pattern = re.compile(r"^\s*(import|from) (PIL|jax)\b", re.M)
    for source in [*sorted((root / "meshrcnn_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]:
        assert not pattern.search(source.read_text()), source
