"""The port's JPEG decoder (``data/image_io.read_image`` / ``to_rgb`` over
``csrc/jpeg.c``) against this host's Pillow, which is built on
libjpeg-turbo: equal pixels, dtype and mode on every variant of
``tests/torch_make_jpeg_fixtures.py`` (written here by Pillow from seeded
numpy pixels, or read from the committed corpus where the host's libjpeg
wrote them: arithmetic coding, 4:4:0 and other sampling ratios, scans that
leave coefficients unsent), ``DamagedImageError`` exactly where Pillow's
``open`` or ``load()`` raises on truncated, corrupt and refused files,
``ValueError`` naming the file and the feature only for lossless JPEG; then
the Pix3D scan, samples and batches on trees of JPEG and PNG photos against
the JAX data layer, and Pix3D train steps of the CLI on them with Pillow
blocked.
"""
import json
import os
import re
import sys
import threading

import numpy as np
import PIL.features
import PIL.Image
import pytest
import scipy.io

from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.data import datasets as jd
from meshrcnn_tpu.data import serialization as js
from meshrcnn_tpu_torch import train
from meshrcnn_tpu_torch.core.config import CapacityConfig
from meshrcnn_tpu_torch.data import datasets as pd
from meshrcnn_tpu_torch.data import fastio, image_io
from tests import torch_make_jpeg_fixtures as fx
from tests.test_torch_data import CAPS, _equal
from tests.test_torch_real_data import TINY, _block_pil


def _pillow(path):
    with PIL.Image.open(path) as im:
        return np.asarray(im), im.mode, np.asarray(im.convert("RGB"))


def _manifest():
    with open(os.path.join(fx.FIXTURES, "manifest.json")) as f:
        return json.load(f)


REFUSED = [n for n in fx.LIBJPEG if _manifest()[f"{n}.jpg"] == "damaged"]


@pytest.mark.parametrize("name", [n for n in [*fx.VARIANTS, *fx.LIBJPEG]
                                  if n != "truncated" and n not in REFUSED])
def test_decode_equals_pillow(tmp_path, name):
    path = fx.write_variant(name, str(tmp_path / f"{name}.jpg"))
    want, mode, want_rgb = _pillow(path)
    got, got_mode = image_io.read_image(path)
    assert got_mode == mode == image_io.image_mode(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    rgb = image_io.to_rgb(path)
    assert rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb, want_rgb)


def _noise(seed, shape, **kw):
    return lambda: fx._save(np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8),
                            "RGB", **kw)


def _app_padded(name, size):
    """A corpus file behind an APP5 segment of ``size`` zero bytes."""
    data = fx.variant_bytes(name)
    return data[:2] + b"\xff\xe5" + (size + 2).to_bytes(2, "big") + bytes(size) + data[2:]


TRUNCATED = {
    "baseline": fx.VARIANTS["size300x200"],
    "progressive": fx.VARIANTS["s420_progressive"],
    "restart": fx.VARIANTS["restart_blocks"],
    "grey": fx.VARIANTS["grey"],
    # cut 2 bytes short, the first decodes and the second does not: which one
    # does depends on libjpeg's faster reader of MCUs far from the data's end
    "fast_reader_decodes": _noise(6, (44, 45, 3), quality=87, subsampling=1),
    "fast_reader_damaged": _noise(259, (44, 45, 3), quality=87, subsampling=1),
    # past 64 KiB: Pillow's reads end inside the image data, which decides
    # whether the last MCUs go through the faster reader; cut 1 or 2 bytes
    # short this one decodes
    "large": _noise(6, (240, 320, 3), quality=95, subsampling=0),
    "arith": lambda: fx.variant_bytes("arith_s420"),
    "arith_progressive": lambda: fx.variant_bytes("arith_s420_progressive"),
    "arith_restart": lambda: fx.variant_bytes("arith_restart_progressive"),
    # arithmetic-coded data across the first 64 KiB read: libjpeg's arithmetic
    # decoder cannot suspend, so Pillow reads none of these
    "arith_past_64k": lambda: _app_padded("photo_arith", 56000),
}


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_files_are_damaged_where_pillow_raises(tmp_path, name):
    data = TRUNCATED[name]()
    n = len(data)
    cuts = {3, 120, n // 3, n // 2, n - 40, n - 3, n - 2, n - 1}
    if n > 70000:
        cuts |= {65536 + d for d in (-20, -2, 0, 2, 20)}
    outcomes = set()
    for cut in sorted(cuts):
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        try:
            with PIL.Image.open(path) as im:
                im.load()
                want = np.asarray(im)
        except OSError:
            want = None
        outcomes.add(want is None)
        if want is None:
            with pytest.raises(image_io.DamagedImageError, match=re.escape(path)):
                image_io.read_image(path)
        else:
            np.testing.assert_array_equal(image_io.read_image(path)[0], want, f"cut {cut}")
    assert True in outcomes
    if name in ("fast_reader_decodes", "large"):
        assert False in outcomes


@pytest.mark.parametrize("name", ["grey", "s444", "s420", "s411", "restart_blocks",
                                  "quality1", "qtables16", "s422_progressive", "cmyk",
                                  "arith_s420", "arith_s420_progressive", "arith_restart",
                                  "arith_dac", "s440", "smooth_partial", "smooth_arith",
                                  "lossless_s420", "lossless_restart", "lossless_scans"])
def test_corrupt_files_decode_as_pillow_decodes(tmp_path, name):
    """1 to 3 random bytes changed anywhere: where Pillow decodes, the same
    pixels (on corrupt coefficients libjpeg-turbo's SIMD IDCT wraps and
    saturates in 16 bits, and so does the port's; an arithmetic decoder that
    meets a marker goes on with zeros, and one that overflows decodes the
    rest of its scan as nothing; a lossless MCU row begun past a marker is
    zeros from the first-row predictor); where it raises, damaged. Nothing
    raises ValueError: every JPEG feature is decoded."""
    rng = np.random.RandomState(sum(map(ord, name)))
    data = fx.variant_bytes(name)
    path = str(tmp_path / "corrupt.jpg")
    for trial in range(40):
        b = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            b[rng.randint(len(b))] = rng.randint(256)
        with open(path, "wb") as f:
            f.write(b)
        try:
            with PIL.Image.open(path) as im:
                im.load()
                want = np.asarray(im)
        except OSError:
            want = None
        try:
            got = image_io.read_image(path)[0]
        except image_io.DamagedImageError:
            assert want is None, f"trial {trial}: Pillow decodes it"
            continue
        assert want is not None, f"trial {trial}: Pillow finds it damaged"
        np.testing.assert_array_equal(got, want, f"trial {trial}")


def _without_dht(data, index):
    """The file without its first DHT segment of table ``index`` (0x10 | n: AC)."""
    pos = data.index(b"\xff\xc4")            # no 0xFF 0xC4 inside entropy-coded data
    while data[pos + 4] != index:
        pos = data.index(b"\xff\xc4", pos + 2)
    return data[:pos] + data[pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big"):]


def test_missing_huffman_tables_and_repeated_scan_components(tmp_path):
    """A sequential file without a DHT decodes with the standard tables (as a
    Motion-JPEG frame does), a progressive one is damaged; a scan naming one
    component twice is damaged."""
    path = str(tmp_path / "t.jpg")
    for name, index in (("s420", 0x11), ("s420", 0x00), ("s420_progressive", 0x10)):
        with open(path, "wb") as f:
            f.write(_without_dht(fx.VARIANTS[name](), index))
        if name == "s420":
            np.testing.assert_array_equal(image_io.read_image(path)[0], _pillow(path)[0])
        else:
            with pytest.raises(image_io.DamagedImageError, match="Huffman table 0"):
                image_io.read_image(path)
    b = bytearray(fx.VARIANTS["s420"]())
    b[b.index(b"\xff\xda") + 7] = 3                     # components 1, 3, 3
    with open(path, "wb") as f:
        f.write(b)
    with pytest.raises(image_io.DamagedImageError, match="component 3 twice"):
        image_io.read_image(path)
    with pytest.raises(OSError):
        _pillow(path)


def _set_byte(data, marker, offset, value):
    b = bytearray(data)
    b[b.index(marker) + offset] = value
    return bytes(b)


def _scans_dropped(data, keep):
    """A progressive file cut before its scan ``keep`` + 1, then ended (EOI)."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[keep]] + b"\xff\xd9"


# byte patches of Pillow's files into layouts the decoder once refused:
# (patched file, the fault the message names where Pillow raises)
UNSUPPORTED = {
    "4:4:0": (lambda: fx._patch_sampling(fx._save(fx.smooth((48, 64, 3), 1), "RGB",
                                                  subsampling=1), 0x21, 0x12), None),
    # Huffman-coded data read as arithmetic-coded: decoded as libjpeg decodes it
    "arithmetic coding": (lambda: _set_byte(fx.VARIANTS["s420"](), b"\xff\xc0", 1, 0xC9),
                          None),
    # a lossless frame in a JFIF file, whose YCbCr libjpeg does not convert
    # in a lossless frame (over a scan of DCT parameters, refused too)
    "lossless": (lambda: _set_byte(fx.VARIANTS["s420"](), b"\xff\xc0", 1, 0xC3),
                 "lossless frame in YCbCr"),
    "hierarchical": (lambda: _set_byte(fx.VARIANTS["s420"](), b"\xff\xc0", 1, 0xC5),
                     "hierarchical"),
    "12-bit": (lambda: _set_byte(fx.VARIANTS["s420"](), b"\xff\xc0", 4, 12), "12-bit"),
    "coefficients unsent": (lambda: _scans_dropped(fx.VARIANTS["s420_progressive"](), 2), None),
}


@pytest.mark.parametrize("feature", UNSUPPORTED)
def test_unsupported_jpeg_raises_naming_the_file_and_the_feature(tmp_path, feature):
    """The features the decoder once refused: now equal to Pillow where
    Pillow decodes the file (4:4:0 upsampled by the triangle filter,
    arithmetic decoding, smoothing of the blocks whose coefficients the
    dropped scans leave unsent), and ``DamagedImageError`` naming the file
    and the fault where Pillow's ``open`` or ``load`` raises."""
    make, fault = UNSUPPORTED[feature]
    path = str(tmp_path / "photo.jpg")
    with open(path, "wb") as f:
        f.write(make())
    try:
        want = _pillow(path)
    except OSError:
        want = None
    assert (want is None) == (fault is not None)
    for fn in (image_io.read_image, image_io.to_rgb):
        if fault is not None:
            with pytest.raises(image_io.DamagedImageError,
                               match=re.escape(path) + ".*" + re.escape(fault)):
                fn(path)
    if want is not None:
        got, mode = image_io.read_image(path)
        assert mode == want[1]
        np.testing.assert_array_equal(got, want[0])
        np.testing.assert_array_equal(image_io.to_rgb(path), want[2])


@pytest.mark.parametrize("name", REFUSED)
def test_files_pillow_refuses_are_damaged(tmp_path, name):
    """12-bit samples (refused by Pillow's ``open``), a hierarchical frame and
    a fractional sampling ratio (by libjpeg at ``load``): damaged, naming
    the file, and the mode from the header as far as Pillow gets."""
    path = fx.write_variant(name, str(tmp_path / f"{name}.jpg"))
    with pytest.raises(OSError):
        _pillow(path)
    with pytest.raises(image_io.DamagedImageError, match=re.escape(path)):
        image_io.read_image(path)
    if name == "precision12":                  # PIL.UnidentifiedImageError at open
        with pytest.raises(image_io.DamagedImageError, match="12-bit"):
            image_io.image_mode(path)
    else:
        assert image_io.image_mode(path) == PIL.Image.open(path).mode == "RGB"


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_frames_equal_pillow(tmp_path, psv):
    """Lossless JPEG (SOF3) of each predictor, written here by the fixture
    generator's encoder: grey with a point transform, RGB 4:2:0 interleaved
    with restarts, 4:4:0 one scan a component; equal to Pillow, and for
    Pt = 0 equal to the pixels encoded (the grey file); cut short, damaged
    where Pillow raises."""
    grey = fx.smooth((13, 17), psv)
    rgb = fx.smooth((12, 18, 3), psv)
    s420, s440 = [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]
    files = {
        "grey": fx.lossless_jpeg(fx._planes(grey, [(1, 1)]), [(1, 1)], psv=psv),
        "grey_pt": fx.lossless_jpeg(fx._planes(grey, [(1, 1)]), [(1, 1)], psv=psv, pt=psv % 4),
        "s420": fx.lossless_jpeg(fx._planes(rgb, s420), s420, psv=psv, restart_rows=psv % 3),
        "s440": fx.lossless_jpeg(fx._planes(rgb, s440), s440, psv=psv, interleaved=False),
    }
    for name, data in files.items():
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        want, mode, want_rgb = _pillow(path)
        got, got_mode = image_io.read_image(path)
        assert got_mode == mode
        np.testing.assert_array_equal(got, want, name)
        np.testing.assert_array_equal(image_io.to_rgb(path), want_rgb, name)
        if name == "grey":
            np.testing.assert_array_equal(got, grey)
    data = files["s420"]
    for cut in (len(data) // 2, len(data) - 3, len(data) - 1):
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        try:
            want = _pillow(path)[0]
        except OSError:
            with pytest.raises(image_io.DamagedImageError, match=re.escape(path)):
                image_io.read_image(path)
        else:
            np.testing.assert_array_equal(image_io.read_image(path)[0], want)


def test_committed_corpus_matches_this_pillow_and_the_port():
    """The corpus chip_smoke.py decodes without Pillow: this host's Pillow,
    built on libjpeg-turbo, still gives the manifest's modes and digests,
    and so does the port."""
    assert PIL.features.check_feature("libjpeg_turbo")
    with open(os.path.join(fx.FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest) == sorted(f"{n}.jpg" for n in [*fx.VARIANTS, *fx.LIBJPEG])
    assert sum(os.path.getsize(os.path.join(fx.FIXTURES, n)) for n in manifest) < 1 << 20
    for name, record in manifest.items():
        path = os.path.join(fx.FIXTURES, name)
        assert fx.pillow_record(path) == record, name
        if record == "damaged":
            with pytest.raises(image_io.DamagedImageError):
                image_io.read_image(path)
            continue
        pixels, mode = image_io.read_image(path)
        assert (mode, list(pixels.shape), fx.digest(pixels), fx.digest(image_io.to_rgb(path))) \
            == (record["mode"], record["shape"], record["sha256"], record["sha256_rgb"]), name


def test_concurrent_decodes_agree_and_are_all_counted(tmp_path):
    """Loader threads decode at once (ctypes releases the interpreter lock):
    every result is the single-thread one and every call is counted."""
    path = fx.write_variant("s420", str(tmp_path / "a.jpg"))
    want = image_io.read_image(path)[0]
    before = fastio.calls["decode_jpeg"]
    threads, rounds, bad = 16, 20, []

    def work():
        for _ in range(rounds):
            if not np.array_equal(image_io.read_image(path)[0], want):
                bad.append(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert not bad
    assert fastio.calls["decode_jpeg"] - before == threads * rounds


def _write_pix3d_jpeg_tree(root):
    """A Pix3D tree whose photos are JPEG (RGB 4:2:0 baseline and
    progressive, grey, CMYK, truncated) and PNG; masks PNG."""
    for d in ("img", "mask", "model"):
        (root / d).mkdir(parents=True)
    rng = np.random.RandomState(0)
    verts = rng.rand(8, 3).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [4, 5, 6]], dtype=np.int64)
    photos = {
        "a.jpg": fx._save(fx.smooth((40, 60, 3), 1), "RGB"),
        "b.jpg": fx._save(fx.smooth((44, 52, 3), 2), "RGB", progressive=True),
        "c.jpg": fx._save(fx.smooth((40, 60), 3), "L"),
        "d.jpg": fx._save(fx.smooth((40, 60, 4), 4), "CMYK"),
        "e.jpg": fx._save(fx.smooth((40, 60, 3), 5), "RGB")[:700],
        "g.jpg": fx._save(fx.smooth((36, 64, 3), 7), "RGB", subsampling=0,
                          restart_marker_blocks=2),
    }
    manifest = []
    for i, name in enumerate(sorted(list(photos) + ["f.png"])):
        if name in photos:
            (root / "img" / name).write_bytes(photos[name])
        else:
            PIL.Image.fromarray(fx.smooth((40, 60, 3), 6)).save(root / "img" / name)
        stem = name.split(".")[0]
        h, w = (40, 60) if name in ("f.png", "a.jpg", "c.jpg", "d.jpg", "e.jpg") else {
            "b.jpg": (44, 52), "g.jpg": (36, 64)}[name]
        PIL.Image.fromarray((rng.rand(h, w) > 0.5).astype(np.uint8) * 255).save(
            root / "mask" / f"{stem}.png")
        scipy.io.savemat(root / "model" / f"{stem}.mat",
                         {"voxel": (rng.rand(32, 32, 32) > 0.7).astype(np.uint8)})
        js.save_mesh(verts, faces, str(root / "model" / stem))
        manifest.append({"img": f"img/{name}", "mask": f"mask/{stem}.png",
                         "voxel": f"model/{stem}.mat", "model": f"model/{stem}.obj",
                         "category": ("chair", "sofa", "desk")[i % 3], "bbox": [5, 5, 30, 35]})
    with open(root / "pix3d.json", "w") as f:
        json.dump(manifest, f)


def test_pix3d_scan_samples_and_batches_equal_jax_on_jpeg_photos(tmp_path, monkeypatch):
    _write_pix3d_jpeg_tree(tmp_path)
    ref = jd.pix3dDataset(str(tmp_path))
    (tmp_path / ".pix3d_scan_cache.json").unlink()
    want_items = [ref[i] for i in range(len(ref))]
    want = list(jd.dataLoader(ref, 2, 24, JaxCapacityConfig(**CAPS), image_size=64))
    before = fastio.calls["decode_jpeg"]
    with monkeypatch.context() as m:
        _block_pil(m)
        port = pd.pix3dDataset(str(tmp_path))
        assert port.records == ref.records
        assert [r["img"] for r in port.records] == ["img/a.jpg", "img/b.jpg", "img/f.png",
                                                    "img/g.jpg"]
        assert len(port) == len(want_items)
        for i, w in enumerate(want_items):
            _equal(port[i], w, f"item {i}")
        got = list(pd.dataLoader(port, 2, 24, CapacityConfig(**CAPS), image_size=64, workers=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal(g, w)
    assert fastio.calls["decode_jpeg"] > before


def test_pix3d_train_cli_steps_on_jpeg_photos_without_pillow(tmp_path, monkeypatch):
    ds = tmp_path / "ds"
    _write_pix3d_jpeg_tree(ds)
    _block_pil(monkeypatch)
    before = fastio.calls["decode_jpeg"]
    out = train.main(["--model", "Pix3D", "--device", "cpu", "--dataRoot", str(ds), "-b", "2",
                      "--num_sampels", "2", "--nEpoch", "1", "--workers", "2",
                      "--img_size", "64", "--rpn_pre_nms_top_n", "64",
                      "--rpn_post_nms_top_n", "32", "--roi_batch_size", "32",
                      "--checkpoint_root", str(tmp_path / "ck")] + TINY)
    assert out["state"].step == 1
    meters = {k: m.history for k, m in out["meters"].items()}
    assert all(np.isfinite(h).all() for h in meters.values()), meters
    assert fastio.calls["decode_jpeg"] > before


def _write_pix3d_mixed_tree(root):
    """A Pix3D tree of every kind of file the port newly decodes (JPEG:
    arithmetic baseline and progressive, 4:4:0, mixed sampling ratios,
    scans that leave coefficients unsent, lossless; PNG: Adam7 RGB, 16-bit
    RGB) and
    of files the scan drops (12-bit, hierarchical, a fractional ratio, a
    truncated arithmetic one; 16-bit grey and RGBA, whose modes are not
    RGB). Masks: PNG of modes "1", "L" and "I;16", interlaced, and JPEG."""
    from tests.test_torch_image_io import _encode
    for d in ("img", "mask", "model"):
        (root / d).mkdir(parents=True)
    rng = np.random.RandomState(1)
    verts = rng.rand(8, 3).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [4, 5, 6]], dtype=np.int64)
    corpus = {"a.jpg": "arith_s420", "b.jpg": "arith_s420_progressive", "c.jpg": "s440",
              "d.jpg": "smooth_partial", "e.jpg": "s_mixed", "j.jpg": "lossless_s420",
              "k.jpg": "precision12", "l.jpg": "hierarchical", "m.jpg": "fractional"}
    for name, variant in corpus.items():
        (root / "img" / name).write_bytes(fx.variant_bytes(variant))
    (root / "img" / "n.jpg").write_bytes(fx.variant_bytes("arith_s420")[:500])
    _encode(root / "img" / "f.png", fx.smooth((40, 56, 3), 71), 8, 2, interlace=1)
    _encode(root / "img" / "g.png", rng.randint(0, 1 << 16, (40, 56, 3)), 16, 2)
    _encode(root / "img" / "h.png", rng.randint(0, 1 << 16, (40, 56)), 16, 0)
    _encode(root / "img" / "i.png", rng.randint(0, 1 << 16, (40, 56, 4)), 16, 6)
    manifest = []
    for i, name in enumerate(sorted(os.listdir(root / "img"))):
        stem = name.split(".")[0]
        mask = (rng.rand(40, 56) > 0.5)
        kind = i % 5
        if kind == 0:
            PIL.Image.fromarray(mask).save(root / "mask" / f"{stem}.png")             # "1"
        elif kind == 1:
            PIL.Image.fromarray(mask.astype(np.uint8) * 255).save(root / "mask" / f"{stem}.png")
        elif kind == 2:                                                             # "I;16"
            _encode(root / "mask" / f"{stem}.png", mask * rng.randint(1, 600, mask.shape), 16, 0)
        elif kind == 3:
            _encode(root / "mask" / f"{stem}.png", mask.astype(np.uint8) * 255, 8, 0,
                    interlace=1)
        suffix = "jpg" if kind == 4 else "png"
        if kind == 4:
            PIL.Image.fromarray(mask.astype(np.uint8) * 255).save(
                root / "mask" / f"{stem}.jpg", quality=90)
        scipy.io.savemat(root / "model" / f"{stem}.mat",
                         {"voxel": (rng.rand(32, 32, 32) > 0.7).astype(np.uint8)})
        js.save_mesh(verts, faces, str(root / "model" / stem))
        manifest.append({"img": f"img/{name}", "mask": f"mask/{stem}.{suffix}",
                         "voxel": f"model/{stem}.mat", "model": f"model/{stem}.obj",
                         "category": ("chair", "sofa", "desk")[i % 3], "bbox": [5, 5, 30, 35]})
    with open(root / "pix3d.json", "w") as f:
        json.dump(manifest, f)


MIXED_KEPT = ["img/a.jpg", "img/b.jpg", "img/c.jpg", "img/d.jpg", "img/e.jpg", "img/f.png",
              "img/g.png", "img/j.jpg"]


@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    """The mixed tree and the JAX data layer's records, samples and batches
    of it: the JAX scan runs once a module."""
    root = tmp_path_factory.mktemp("mixed")
    _write_pix3d_mixed_tree(root)
    ref = jd.pix3dDataset(str(root))
    (root / ".pix3d_scan_cache.json").unlink()
    items = [ref[i] for i in range(len(ref))]
    batches = list(jd.dataLoader(ref, 2, 24, JaxCapacityConfig(**CAPS), image_size=64))
    return root, ref.records, items, batches


def test_pix3d_scan_samples_and_batches_equal_jax_on_every_kind_of_file(mixed_tree, monkeypatch):
    """The scan keeps exactly the JAX scan's records (the refused, truncated
    and non-RGB files dropped by both), every sample (masks of every mode,
    JPEG masks included) and every collated batch equal, without Pillow."""
    root, records, items, batches = mixed_tree
    before = dict(fastio.calls)
    with monkeypatch.context() as m:
        _block_pil(m)
        port = pd.pix3dDataset(str(root))
        assert port.records == records
        assert [r["img"] for r in port.records] == MIXED_KEPT
        assert len(port) == len(items)
        for i, w in enumerate(items):
            _equal(port[i], w, f"item {i}")
        got = list(pd.dataLoader(port, 2, 24, CapacityConfig(**CAPS), image_size=64, workers=2))
    assert len(got) == len(batches) == 4
    for g, w in zip(got, batches):
        _equal(g, w)
    assert fastio.calls["decode_jpeg"] > before["decode_jpeg"]
    assert fastio.calls["png_adam7"] > before["png_adam7"]


def test_pix3d_train_cli_two_steps_on_every_kind_of_file_without_pillow(mixed_tree, tmp_path,
                                                                        monkeypatch):
    root = mixed_tree[0]
    _block_pil(monkeypatch)
    before = dict(fastio.calls)
    out = train.main(["--model", "Pix3D", "--device", "cpu", "--dataRoot", str(root), "-b", "2",
                      "--num_sampels", "4", "--nEpoch", "1", "--workers", "2",
                      "--img_size", "64", "--rpn_pre_nms_top_n", "64",
                      "--rpn_post_nms_top_n", "32", "--roi_batch_size", "32",
                      "--checkpoint_root", str(tmp_path / "ck")] + TINY)
    assert out["state"].step == 2
    meters = {k: m.history for k, m in out["meters"].items()}
    assert all(np.isfinite(h).all() for h in meters.values()), meters
    assert all(fastio.calls[k] > before[k] for k in ("decode_jpeg", "png_adam7"))
