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

Each variant is written by Pillow from numpy pixels made from a seed. Some
are then patched byte for byte into layouts this Pillow cannot write but
libjpeg decodes: 4:1:1 sampling (a 4:2:0 file's luma factors set to 4x1: the
same six blocks an MCU, so its entropy-coded data stays whole) and Adobe's
YCCK (a CMYK file's transform byte set to 2).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg_fixtures")
TIMING = ("photo", "photo_progressive")      # the photo-like pair chip_smoke.py times


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


VARIANTS = _variants()


def write_variant(name: str, path: str) -> str:
    with open(path, "wb") as f:
        f.write(VARIANTS[name]())
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
    for name in VARIANTS:
        path = write_variant(name, os.path.join(FIXTURES, f"{name}.jpg"))
        manifest[f"{name}.jpg"] = pillow_record(path)
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes in {FIXTURES}", file=sys.stderr)


if __name__ == "__main__":
    main()
