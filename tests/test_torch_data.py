"""The port's data layer (meshrcnn_tpu_torch/data/, core/batch.py,
core/mesh.pad_mesh_np) against the JAX package's, exactly: the same inputs
give the same arrays, bit for bit, and the same files.

Numpy only: no JAX program is built here. The loaders' split and order are
compared with the loader threads on and off, and the Pix3D on-disk fixture is
written as tests/test_data.py writes it.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.core.mesh import pad_mesh_np as jax_pad_mesh_np
from meshrcnn_tpu.data import datasets as jd
from meshrcnn_tpu.data import process as jp
from meshrcnn_tpu.data import serialization as js
from meshrcnn_tpu_torch.core.batch import Batch
from meshrcnn_tpu_torch.core.config import CapacityConfig
from meshrcnn_tpu_torch.core.mesh import pad_mesh_np
from meshrcnn_tpu_torch.data import datasets as pd
from meshrcnn_tpu_torch.data import process as pp
from meshrcnn_tpu_torch.data import serialization as ps

CAPS = dict(gt_verts=16, gt_faces=16)


def _equal(a, b, what=""):
    """Two samples, batches or dicts equal field by field, dtypes included."""
    if dataclasses.is_dataclass(a):
        a, b = ({f.name: getattr(x, f.name) for f in dataclasses.fields(x)} for x in (a, b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):                      # Mesh
        for x, y in zip(a, b):
            _equal(x, y, what)
    elif a is None:
        assert b is None, what
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=what)


def test_normalize_mesh_and_resample_voxels_equal_jax():
    rng = np.random.RandomState(0)
    for v in (rng.randn(50, 3) * 5, rng.rand(7, 3) * 0.4, np.float32([[10, 0, 0], [0, 10, 0]])):
        _equal(pp.normalize_mesh(v), jp.normalize_mesh(v))
    grid = (rng.rand(2, 32, 32, 32) > 0.8).astype(np.float32)
    for n in (48, 24, 16, 32, 33):                 # up, down, down, same, up
        _equal(pp.resample_voxels(grid, n), jp.resample_voxels(grid, n), f"n={n}")
    _equal(pp.resample_voxels(grid[:, :17, :17, :17], 24),
           jp.resample_voxels(grid[:, :17, :17, :17], 24))
    with pytest.raises(ValueError):
        pp.resample_voxels(grid[0], 24)


@pytest.mark.parametrize("nv,nf,vcap,fcap,ecap", [(8, 12, 16, 16, 40), (30, 50, 20, 64, 32),
                                                  (30, 50, 64, 20, None), (0, 0, 4, 4, 4)])
def test_pad_mesh_np_equals_jax_with_truncation(nv, nf, vcap, fcap, ecap):
    rng = np.random.RandomState(nv + nf)
    verts = rng.randn(nv, 3).astype(np.float64)
    faces = rng.randint(0, max(nv, 1), (nf, 3))
    _equal(pad_mesh_np(verts, faces, vcap, fcap, ecap),
           jax_pad_mesh_np(verts, faces, vcap, fcap, ecap))


def test_obj_round_trip_and_polygon_strip_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    verts = rng.randn(9, 3).astype(np.float32)
    faces = rng.randint(0, 9, (11, 3))
    ps.save_mesh(verts, faces, str(tmp_path / "port"))
    js.save_mesh(verts, faces, str(tmp_path / "jax"))
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    _equal(ps.load_mesh(str(tmp_path / "port.obj")), js.load_mesh(str(tmp_path / "jax.obj")))
    # polygons strip-triangulated, "v/vt/vn" tokens, runs of spaces, comments
    poly = tmp_path / "poly.obj"
    poly.write_text("# a comment\nv  0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                    "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf 2 3 5\n")
    got = ps.load_mesh(str(poly))
    _equal(got, js.load_mesh(str(poly)))
    np.testing.assert_array_equal(got.faces, [[0, 1, 2], [1, 2, 3], [1, 2, 4]])
    # a .binvox path reads the OBJ beside it, as the reference does
    _equal(ps.load_mesh(str(tmp_path / "port.binvox")), js.load_mesh(str(tmp_path / "port.obj")))


def test_voxel_files_equal_jax(tmp_path):
    import scipy.io
    rng = np.random.RandomState(2)
    for shape, p in (((16, 16, 16), 0.5), ((20, 24, 28), 0.97), ((32, 32, 32), -1.0)):
        v = rng.rand(*shape) > p
        ps.write_binvox(v, str(tmp_path / "p.binvox"))
        js.write_binvox(v, str(tmp_path / "j.binvox"))
        assert (tmp_path / "p.binvox").read_bytes() == (tmp_path / "j.binvox").read_bytes()
        got = ps.load_voxels(str(tmp_path / "p.binvox"))
        _equal(got, js.load_voxels(str(tmp_path / "p.binvox")))
        if len(set(shape)) == 1:     # binvox grids are cubes; others do not round-trip
            np.testing.assert_array_equal(got, v.astype(int))
    grid = rng.rand(8, 8, 8)
    ps.save_voxels(grid, str(tmp_path / "p"))
    js.save_voxels(grid, str(tmp_path / "j"))
    _equal(ps.load_voxels(str(tmp_path / "p.npy")), js.load_voxels(str(tmp_path / "j.npy")))
    scipy.io.savemat(tmp_path / "v.mat", {"voxel": (grid > 0.5).astype(np.uint8)})
    _equal(ps.load_voxels(str(tmp_path / "v.mat")), js.load_voxels(str(tmp_path / "v.mat")))
    with pytest.raises(ValueError):
        ps.load_voxels(str(tmp_path / "v.off"))


@pytest.mark.parametrize("pix3d", [False, True])
def test_synthetic_items_and_collate_equal_jax(pix3d):
    kw = dict(n=8, image_size=48, num_voxels=16, num_classes=10 if pix3d else 13, pix3d=pix3d)
    port, ref = pd.SyntheticDataset(**kw), jd.SyntheticDataset(**kw)
    for i in range(8):
        _equal(port[i], ref[i], f"item {i}")
    got = pd.collate([port[i] for i in range(3)], 24, CapacityConfig(**CAPS))
    want = jd.collate([ref[i] for i in range(3)], 24, JaxCapacityConfig(**CAPS))
    assert isinstance(got, Batch)
    _equal(got, want)
    assert got.batch_size == want.batch_size == 3


def test_letterbox_equals_jax():
    """``_resize_sample``: a non-square Pix3D sample letterboxed to 64x64 (image,
    box and mask), through collate as the loader calls it."""
    rng = np.random.RandomState(3)
    image = rng.rand(40, 60, 3).astype(np.float32)
    mask = np.zeros((40, 60), np.float32)
    mask[5:35, 5:30] = 1.0
    mesh = js.Mesh(rng.rand(8, 3).astype(np.float32), rng.randint(0, 8, (6, 3)))
    boxes = np.float32([[5, 5, 30, 60]])         # y2 past the image: clipped to 64
    s_port = pd.Sample(image, np.zeros((16, 16, 16)), mesh, 3, boxes, mask)
    s_ref = jd.Sample(image, np.zeros((16, 16, 16)), mesh, 3, boxes, mask)
    got, want = pd._resize_sample(s_port, 64), jd._resize_sample(s_ref, 64)
    _equal(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.image.shape == (64, 64, 3) and not got.image[43:].any()
    _equal(pd.collate([s_port, s_port], 24, CapacityConfig(**CAPS), image_size=64),
           jd.collate([s_ref, s_ref], 24, JaxCapacityConfig(**CAPS), image_size=64))


def test_synthetic_pix3d_path_never_imports_pil(monkeypatch):
    """The card's machine has no Pillow: a synthetic Pix3D batch at the CLI's
    size must collate without importing it, and a letterbox to another size
    (``image_io``'s resizes) runs without it too, equal to the JAX package's
    (Pillow's) letterbox."""
    want = jd._resize_sample(jd.SyntheticDataset(n=4, image_size=64, num_voxels=16,
                                                 num_classes=10, pix3d=True)[0], 32)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    ds = pd.SyntheticDataset(n=4, image_size=64, num_voxels=16, num_classes=10, pix3d=True)
    loader = pd.dataLoader(ds, 2, 24, CapacityConfig(**CAPS), image_size=64, workers=2)
    assert [b.images.shape for b in loader] == [(2, 64, 64, 3)] * 2
    _equal(dataclasses.asdict(pd._resize_sample(ds[0], 32)), dataclasses.asdict(want))


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_split_and_order_equal_jax(workers):
    ds_p, ds_j = pd.SyntheticDataset(n=21, image_size=32, num_voxels=16), jd.SyntheticDataset(
        n=21, image_size=32, num_voxels=16)
    for kw in (dict(num_train_samples=15), dict(train_ratio=0.6), {}):
        for test in (False, True):
            if test and not kw:
                continue                     # the whole set trains: no test side
            port = pd.DataLoader(ds_p, 4, 24, CapacityConfig(**CAPS), test=test, seed=7,
                                 workers=workers, **kw)
            after_port = np.random.rand()    # the global generator after the split
            ref = jd.DataLoader(ds_j, 4, 24, JaxCapacityConfig(**CAPS), test=test, seed=7,
                                **kw)
            assert after_port == np.random.rand()
            assert port.indices == ref.indices and len(port) == len(ref)
            for epoch in range(2):           # each epoch reshuffles, as the JAX loader
                got, want = list(port), list(ref)
                assert len(got) == len(want) == len(ref)
                for a, b in zip(got, want):
                    _equal(a, b, f"{kw} test={test} epoch {epoch}")
    with pytest.raises(ValueError):
        pd.DataLoader(ds_p, 4, 24, CapacityConfig(), num_train_samples=3, train_ratio=0.5)
    # no train sample: the test side is every index, in the split's order
    everything = pd.DataLoader(ds_p, 4, 24, CapacityConfig(), test=True, num_train_samples=0)
    assert everything.indices == pd.DataLoader(ds_p, 4, 24, CapacityConfig()).indices
    with pytest.raises(ValueError):
        pd.DataLoader(ds_p, 4, 24, CapacityConfig(), num_train_samples=0)


def _write_pix3d_fixture(root):
    """The on-disk tree of tests/test_data.py::test_pix3d_dataset_real_format_fixture."""
    import PIL.Image
    import scipy.io
    for d in ("img", "mask", "model"):
        (root / d).mkdir()
    rng = np.random.RandomState(0)
    verts = rng.rand(8, 3).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [4, 5, 6]], dtype=np.int64)
    manifest = []

    def add(name, mode, category="chair"):
        PIL.Image.new(mode, (60, 40), color=0).save(root / "img" / f"{name}.png")
        PIL.Image.fromarray(np.full((40, 60), 255, np.uint8)).save(root / "mask" / f"{name}.png")
        scipy.io.savemat(root / "model" / f"{name}.mat",
                         {"voxel": (rng.rand(32, 32, 32) > 0.7).astype(np.uint8)})
        js.save_mesh(verts, faces, str(root / "model" / name))
        manifest.append({"img": f"img/{name}.png", "mask": f"mask/{name}.png",
                         "voxel": f"model/{name}.mat", "model": f"model/{name}.obj",
                         "category": category, "bbox": [5, 5, 30, 35]})

    add("a", "RGB")
    add("b", "RGB", "sofa")
    add("c", "RGBA")      # dropped: alpha channel
    add("d", "L")         # dropped: grayscale
    add("e", "RGB", "desk")
    manifest.append(dict(manifest[0], img="img/missing.jpg"))      # dropped: unreadable
    with open(root / "pix3d.json", "w") as f:
        json.dump(manifest, f)


def test_pix3d_fixture_and_scan_cache_equal_jax(tmp_path):
    root = tmp_path / "ds"
    root.mkdir()
    _write_pix3d_fixture(root)
    port = pd.pix3dDataset(str(root))                   # scans and writes the cache
    cache = root / ".pix3d_scan_cache.json"
    written = json.loads(cache.read_text())
    ref = jd.pix3dDataset(str(root))                    # the JAX package reads it back
    assert port.records == ref.records
    assert [r["img"] for r in port.records] == ["img/a.png", "img/b.png", "img/e.png"]
    assert written["kept_imgs"] == [r["img"] for r in port.records]
    for i in range(len(port)):
        _equal(port[i], ref[i], f"item {i}")
    caps = CapacityConfig(**CAPS)
    got = list(pd.dataLoader(port, 2, 24, caps, image_size=64, workers=2))
    want = list(jd.dataLoader(ref, 2, 24, JaxCapacityConfig(**CAPS), image_size=64))
    assert len(got) == len(want) == 1
    _equal(got[0], want[0])
    # the cache is used: a kept list it names is what the scan returns ...
    cache.write_text(json.dumps(dict(written, kept_imgs=["img/b.png"])))
    assert [r["img"] for r in pd.pix3dDataset(str(root)).records] == ["img/b.png"]
    # ... until the manifest changes, and the class filter applies after it
    manifest = json.loads((root / "pix3d.json").read_text())
    (root / "pix3d.json").write_text(json.dumps(manifest[:-1]))
    sofa = pd.pix3dDataset(str(root), classes=["sofa"])
    assert [r["img"] for r in sofa.records] == ["img/b.png"]
    assert json.loads(cache.read_text())["kept_imgs"] == ["img/a.png", "img/b.png", "img/e.png"]
    assert [r["img"] for r in jd.pix3dDataset(str(root)).records] == [
        "img/a.png", "img/b.png", "img/e.png"]
