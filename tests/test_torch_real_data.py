"""Dataset files through the port with Pillow blocked (the card's machine has
no Pillow), against the JAX package reading the same files with Pillow.

Exact throughout: every sample (image, voxels, mesh, mask, box) and batch is
equal bit for bit, dtypes included; the port's mini-ShapeNet generator
writes binvox files equal byte for byte to tools/make_mini_shapenet.py's and
PNGs that decode to the same pixels. The block is
``monkeypatch.setitem(sys.modules, "PIL", None)`` (and "PIL.Image"), under
which any ``import PIL`` raises ImportError.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.data import datasets as jd
from meshrcnn_tpu_torch import download_dataset, make_mini_shapenet, train
from meshrcnn_tpu_torch.core.config import CapacityConfig
from meshrcnn_tpu_torch.data import datasets as pd
from meshrcnn_tpu_torch.data import fastio, image_io
from tests.test_torch_data import CAPS, _equal, _write_pix3d_fixture

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--featDim", "16", "-nr", "1", "--point_cloud_size", "256", "--vert_capacity", "512",
        "--face_capacity", "1024", "--edge_capacity", "2048"]


def _jax_tool():
    """tools/make_mini_shapenet.py, imported as a module."""
    spec = importlib.util.spec_from_file_location("jax_make_mini_shapenet",
                                                  ROOT / "tools" / "make_mini_shapenet.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _block_pil(m):
    m.setitem(sys.modules, "PIL", None)
    m.setitem(sys.modules, "PIL.Image", None)


@pytest.fixture(scope="module")
def shapenet_dir(tmp_path_factory):
    """A 4-model, 2-view mini-ShapeNet: binvox grids and PNGs from the JAX
    package's tool (Pillow writes the PNGs), meshes and manifest from the
    port's download_dataset on the CPU."""
    root = str(tmp_path_factory.mktemp("shapenet"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["make_mini_shapenet.py", "--root", root, "--num_models", "4",
                                "--views", "2", "--seed", "1"])
        _jax_tool().main()
    download_dataset.main(["--render_meshes", "--build_manifest", "--root", root,
                           "--device", "cpu"])
    return root


def test_port_reads_dataset_files_without_pillow_equal_to_jax(shapenet_dir, tmp_path,
                                                              monkeypatch):
    """The repair: with Pillow blocked the port reads a ShapeNet directory
    and the Pix3D on-disk fixture (scan, samples, letterboxed batches), each
    sample equal to the JAX package's, read with Pillow; and a Pix3D scan
    cache the JAX package wrote is read as it is."""
    ref = jd.shapeNet_Dataset(shapenet_dir)
    pix_root = tmp_path / "pix3d"
    pix_root.mkdir()
    _write_pix3d_fixture(pix_root)
    with monkeypatch.context() as m:
        _block_pil(m)
        port = pd.shapeNet_Dataset(shapenet_dir)
        got = [port[i] for i in range(len(port))]
        pix_port = pd.pix3dDataset(str(pix_root))            # scans, writes the cache
        pix_got = [pix_port[i] for i in range(len(pix_port))]
        pix_batches = list(pd.dataLoader(pix_port, 2, 24, CapacityConfig(**CAPS),
                                         image_size=64, workers=2))
    assert port.records == ref.records and len(got) == 8
    for i, sample in enumerate(got):
        _equal(sample, ref[i], f"shapenet item {i}")

    (pix_root / ".pix3d_scan_cache.json").unlink()         # the JAX package scans anew
    pix_ref = jd.pix3dDataset(str(pix_root))
    assert pix_port.records == pix_ref.records
    assert [r["img"] for r in pix_ref.records] == ["img/a.png", "img/b.png", "img/e.png"]
    for i, sample in enumerate(pix_got):
        _equal(sample, pix_ref[i], f"pix3d item {i}")
    want = list(jd.dataLoader(pix_ref, 2, 24, JaxCapacityConfig(**CAPS), image_size=64))
    assert len(pix_batches) == len(want) == 1
    _equal(pix_batches[0], want[0])
    cache = json.loads((pix_root / ".pix3d_scan_cache.json").read_text())   # the JAX one
    with monkeypatch.context() as m:
        _block_pil(m)
        assert pd.pix3dDataset(str(pix_root)).records == pix_ref.records
    assert json.loads((pix_root / ".pix3d_scan_cache.json").read_text()) == cache


def test_pix3d_scan_drops_what_the_reference_drops_and_raises_on_jpeg(tmp_path, monkeypatch):
    """A grey 16-bit PNG (Pillow's mode "I;16") and a truncated RGB PNG are
    dropped, as the JAX package drops them; a JPEG photo is decoded and kept,
    as the JAX package keeps it, and so is its arithmetic-coded twin (its
    Huffman-coded data read as arithmetic-coded, as libjpeg reads it); a file
    the port does not decode (a BMP) is not dropped without a word: the scan
    raises naming it."""
    _write_pix3d_fixture(tmp_path)
    manifest = json.loads((tmp_path / "pix3d.json").read_text())
    PIL.Image.fromarray(np.full((40, 60), 1000, np.uint16)).save(tmp_path / "img" / "g16.png")
    rgb = (tmp_path / "img" / "a.png").read_bytes()
    (tmp_path / "img" / "cut.png").write_bytes(rgb[:len(rgb) // 2])
    PIL.Image.open(tmp_path / "img" / "a.png").save(tmp_path / "img" / "photo.jpg")
    manifest += [dict(manifest[0], img=f"img/{name}") for name in ("g16.png", "cut.png",
                                                                   "photo.jpg")]
    (tmp_path / "pix3d.json").write_text(json.dumps(manifest))
    want = [r["img"] for r in jd.pix3dDataset(str(tmp_path)).records]
    (tmp_path / ".pix3d_scan_cache.json").unlink()
    with monkeypatch.context() as m:
        _block_pil(m)
        assert [r["img"] for r in pd.pix3dDataset(str(tmp_path)).records] == want == [
            "img/a.png", "img/b.png", "img/e.png", "img/photo.jpg"]
    arith = bytearray((tmp_path / "img" / "photo.jpg").read_bytes())
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9           # SOF9: arithmetic coding
    (tmp_path / "img" / "arith.jpg").write_bytes(bytes(arith))
    manifest += [dict(manifest[0], img="img/arith.jpg")]
    (tmp_path / "pix3d.json").write_text(json.dumps(manifest))
    want = [r["img"] for r in jd.pix3dDataset(str(tmp_path)).records]
    (tmp_path / ".pix3d_scan_cache.json").unlink()
    with monkeypatch.context() as m:
        _block_pil(m)
        assert [r["img"] for r in pd.pix3dDataset(str(tmp_path)).records] == want
    (tmp_path / ".pix3d_scan_cache.json").unlink()
    PIL.Image.open(tmp_path / "img" / "a.png").save(tmp_path / "img" / "photo.bmp")
    (tmp_path / "pix3d.json").write_text(json.dumps(manifest + [dict(manifest[0],
                                                                      img="img/photo.bmp")]))
    with pytest.raises(ValueError, match="photo.bmp.*BMP"):
        pd.pix3dDataset(str(tmp_path))


def test_generator_equals_the_jax_tool(tmp_path):
    tool = _jax_tool()
    for seed in (0, 5):
        ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(3):
            grid = make_mini_shapenet.make_grid(ours)
            np.testing.assert_array_equal(grid, tool.make_grid(theirs))
            for view in range(6):
                for size in (137, 64, 32):
                    _equal(make_mini_shapenet.render_view(grid, view, size),
                           tool.render_view(grid, view, size), f"view {view} size {size}")
    flags = ["--num_models", "3", "--views", "3", "--seed", "2", "--img_size", "137"]
    make_mini_shapenet.main(["--root", str(tmp_path / "port")] + flags)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["make_mini_shapenet.py", "--root", str(tmp_path / "jax")] + flags)
        tool.main()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.*"))
    assert len(files) == 12
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".binvox":
            assert a.read_bytes() == b.read_bytes(), rel
        else:
            _equal(np.asarray(PIL.Image.open(a)), np.asarray(PIL.Image.open(b)), str(rel))
            _equal(image_io.read_png(str(a))[0], image_io.read_png(str(b))[0], str(rel))


def test_train_cli_takes_a_step_on_generated_files_without_pillow(tmp_path, monkeypatch):
    """The port's whole file path, Pillow blocked: its generator, its
    download_dataset (cubify on the CPU), one train step of the CLI at the
    tiny widths, the native decoder used for every kind of file."""
    _block_pil(monkeypatch)
    ds = str(tmp_path / "ds")
    make_mini_shapenet.main(["--root", ds, "--num_models", "4", "--views", "1", "--seed", "0"])
    download_dataset.main(["--render_meshes", "--build_manifest", "--root", ds,
                           "--device", "cpu"])
    before = dict(fastio.calls)
    out = train.main(["--model", "ShapeNet", "--device", "cpu", "--dataRoot", ds, "-b", "2",
                      "--num_sampels", "2", "--nEpoch", "1", "--workers", "2",
                      "--checkpoint_root", str(tmp_path / "ck")] + TINY)
    assert out["state"].step == 1
    meters = {k: m.history for k, m in out["meters"].items()}
    assert all(np.isfinite(h).all() for h in meters.values()), meters
    assert {k: fastio.calls[k] > before[k] for k in ("parse_obj", "decode_rle",
                                                     "png_unfilter")} == dict.fromkeys(
        ("parse_obj", "decode_rle", "png_unfilter"), True)
