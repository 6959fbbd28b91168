"""The port's native decoder (meshrcnn_tpu_torch/csrc/fastio.c through
data/fastio.py) and its build (ops/cuda_build.host_build).

OBJ and binvox files decode exactly (bit for bit, dtypes included) as the
JAX package's ``load_mesh`` / ``read_binvox`` decode them, with its own
native ``_fastio`` on and off, and as the port's plain Python / numpy
decoders: polygons strip-triangulated, "v/vt/vn" references, runs of spaces,
CRLF line ends, 1-based faces, comments and normals skipped. (A tab after
"v" or "f" separates tokens for the native parsers only, the port's and the
JAX package's alike, so the files here have none.) Six processes that
build the library at once leave one library; a failed build raises.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from meshrcnn_tpu.data import serialization as js
from meshrcnn_tpu_torch.data import fastio
from meshrcnn_tpu_torch.data import serialization as ps
from meshrcnn_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parent.parent

OBJ_TEXTS = {
    "polygons and references": "# comment\nv  0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                               "vn 0 0 1\nvt 0.5 0.5\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf 2//1 3//1 5//1\n"
                               "f 1 2 3 4 5\n",
    "runs of spaces, CRLF": "v 0.5   -1.25e-3  7\nv 1 2 3\r\nv  -0 0.1 0.2 \n"
                            "f  1   2  3\nf 3  2 1\r\n\n",
    "no faces": "v 1 2 3\nv 4 5 6\n",
}


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


@pytest.fixture(params=[True, False], ids=["jax fastio on", "jax fastio off"])
def jax_fastio(request, monkeypatch):
    """The JAX decoders with their native module, or with it off, as
    tests/utils_tests/test_utils.py toggles it."""
    if not request.param:
        monkeypatch.setattr(js, "_fastio", None)
    elif js._fastio is None:
        pytest.fail("the JAX package's csrc/fastio did not build here")
    return request.param


def test_obj_decodes_as_jax_and_plain(tmp_path, jax_fastio):
    rng = np.random.RandomState(0)
    texts = dict(OBJ_TEXTS)
    path = tmp_path / "saved.obj"
    js.save_mesh(rng.randn(300, 3).astype(np.float32), rng.randint(0, 300, (500, 3)), str(path))
    texts["save_mesh, 1-based"] = path.read_text()
    for name, text in texts.items():
        path = tmp_path / f"{len(text)}.obj"
        path.write_text(text)
        got = ps.load_mesh(str(path))
        # the JAX Python parser gives a file without faces faces of shape (0,)
        _equal(got, [x.reshape(-1, 3) for x in js.load_mesh(str(path))])
        _equal(got, ps.load_mesh_plain(str(path)))
        _equal(ps.load_mesh(str(path).replace(".obj", ".binvox")), got)
    poly = ps.load_mesh(str(tmp_path / f"{len(OBJ_TEXTS['polygons and references'])}.obj"))
    np.testing.assert_array_equal(poly.faces, [[0, 1, 2], [1, 2, 3], [1, 2, 4], [0, 1, 2],
                                               [1, 2, 3], [2, 3, 4]])


def test_obj_with_faces_not_from_one_raises(tmp_path):
    path = tmp_path / "bad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nf 2 3 3\n")
    for load in (ps.load_mesh, ps.load_mesh_plain):
        with pytest.raises(ValueError, match="start at 2"):
            load(str(path))


def test_binvox_decodes_as_jax_and_plain(tmp_path, jax_fastio):
    rng = np.random.RandomState(1)
    for shape, p in (((32, 32, 32), 0.5), ((20, 24, 28), 0.97), ((32, 32, 32), 2.0),
                     ((32, 32, 32), -1.0), ((9, 9, 9), 0.2)):
        v = rng.rand(*shape) > p
        path = str(tmp_path / "v.binvox")
        ps.write_binvox(v, path)
        for fix in (True, False):
            with open(path, "rb") as f:
                got = ps.read_binvox(f, fix)
            with open(path, "rb") as f:
                want = js.read_binvox(f, fix)
            with open(path, "rb") as f:
                plain = ps.read_binvox_plain(f, fix)
            _equal((got,), (want,))
            _equal((got,), (plain,))
    # a payload that runs short leaves zeros, as the JAX native decoder does
    grid = np.ones((4, 4, 4), bool)
    ps.write_binvox(grid, path)
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:-2] + bytes([1, 40]))
    with open(path, "rb") as f:
        got = ps.read_binvox(f)
    assert got.sum() == 40 and got.dtype == np.int64
    if jax_fastio:
        with open(path, "rb") as f:
            _equal((got,), (js.read_binvox(f),))


def test_native_entry_points_count_their_calls_and_check_their_input():
    before = dict(fastio.calls)
    verts, faces = fastio.parse_obj(b"v 1 2 3\nf 1 1 1\n")
    np.testing.assert_array_equal(verts, [[1, 2, 3]])
    np.testing.assert_array_equal(faces, [[1, 1, 1]])
    np.testing.assert_array_equal(fastio.decode_rle(bytes([1, 3, 0, 2]), 6), [1, 1, 1, 0, 0, 0])
    rows = fastio.png_unfilter(bytes([1, 5, 6, 2, 1, 1]), 2, 2, 1)      # Sub, then Up
    np.testing.assert_array_equal(rows, [[5, 11], [6, 12]])
    with pytest.raises(ValueError, match="filter type 9"):
        fastio.png_unfilter(bytes([9, 0, 0]), 1, 2, 1)
    with pytest.raises(ValueError, match="scanlines"):
        fastio.png_unfilter(bytes([0, 0]), 1, 2, 1)
    # a 2x1 grey image interlaced: pixel 0 in pass 1, pixel 1 in pass 6 (Sub,
    # with no pixel to its left in the pass)
    np.testing.assert_array_equal(fastio.png_adam7(bytes([0, 7, 1, 9]), 2, 1, 8), [[7, 9]])
    with pytest.raises(ValueError, match="seven passes"):
        fastio.png_adam7(bytes([0, 7, 1]), 2, 1, 8)
    with pytest.raises(ValueError, match="filter type"):
        fastio.png_adam7(bytes([0, 7, 6, 9]), 2, 1, 8)
    with pytest.raises(ValueError, match="out of range"):
        fastio.resample_u8(np.zeros((1, 4, 1), np.uint8), np.array([3]), np.array([2]),
                           np.ones((1, 2), np.int32))
    jpeg = (Path(__file__).parent / "torch_jpeg_fixtures" / "s420.jpg").read_bytes()
    assert fastio.decode_jpeg(jpeg, 56, 40, 3).shape == (40, 56, 3)
    with pytest.raises(OSError, match="ends inside the image data"):
        fastio.decode_jpeg(jpeg[:len(jpeg) // 2], 56, 40, 3)
    with pytest.raises(OSError, match="not 57x40"):
        fastio.decode_jpeg(jpeg, 57, 40, 3)
    assert {k: fastio.calls[k] - before[k] for k in before} == {
        "parse_obj": 1, "decode_rle": 1, "png_unfilter": 2, "png_adam7": 3, "resample_u8": 0,
        "decode_jpeg": 3}


_BUILD = ("import pathlib, sys; from meshrcnn_tpu_torch.ops import cuda_build as b; "
          "b.BUILD_DIR = pathlib.Path(sys.argv[1]); print(b.host_build('fastio'))")


def test_six_concurrent_first_builds_end_with_one_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [Path(paths.pop()).name]
    lib = ctypes.CDLL(str(next(tmp_path.iterdir())))
    assert lib.fastio_png_unfilter is not None


def test_a_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fastio.c").write_text("int fastio_free(void) { return }\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="cc failed on .*fastio.c"):
        cuda_build.host_build("fastio")
    assert os.listdir(tmp_path / "build") == []
