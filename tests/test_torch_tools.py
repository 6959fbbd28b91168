"""The port's viewing, profiling and dataset tools and its single-sample
helpers against the JAX package's, on the CPU.

  * ``utils/rotation.rotation`` and ``utils/show._sample_surface``: equal in
    every bit (the same numpy operations);
  * the three ``utils/show`` views under matplotlib's Agg backend: the arrays
    handed to ``plot_trisurf``, ``voxels`` and ``scatter`` equal in every bit;
  * ``utils/profiling``: ``time_this`` logs, ``trace`` writes a trace file
    holding an ``annotate`` range;
  * ``plot_stats`` renders a stats file of the port;
  * ``download_dataset``: ``render_shapenet_meshes`` (the port's cubify) and
    ``build_manifest`` on a tiny binvox tree give the same OBJ files, byte
    for byte, and the same manifest as the JAX package's;
  * ``ops/sampling.face_areas`` (1e-6 relative) and ``sample_points`` with
    JAX's draws injected (1e-5 relative: float32 area sums in another
    order), ``utils/metrics.point_cloud_f1`` (within one point of a cloud,
    1 / 500, in precision and recall: Gram- and difference-form distances
    may put a near-tie at tau^2 on either side), ``paste_mask_in_image``,
    ``calc_precision_box`` and ``calc_precision_mask`` (equal).
"""
import json
import os
import shutil

import jax
import matplotlib
import numpy as np
import pytest
import torch

import download_dataset as jax_download
from meshrcnn_tpu.ops.sampling import face_areas as jax_face_areas
from meshrcnn_tpu.ops.sampling import sample_points as jax_sample_points
from meshrcnn_tpu.utils import metrics as jax_metrics
from meshrcnn_tpu.utils import show as jax_show
from meshrcnn_tpu.utils.rotation import rotation as jax_rotation
from meshrcnn_tpu_torch import download_dataset, plot_stats
from meshrcnn_tpu_torch.data.serialization import save_mesh, write_binvox
from meshrcnn_tpu_torch.ops import chamfer_cuda
from meshrcnn_tpu_torch.ops.sampling import face_areas, sample_points
from meshrcnn_tpu_torch.utils import metrics, profiling, show
from meshrcnn_tpu_torch.utils.meters import AverageMeter, save_stats
from meshrcnn_tpu_torch.utils.rotation import rotation
from tests.torch_parity import Replay, sampler_draws, t

matplotlib.use("Agg")


def _mesh(rng, V=40, F=60):
    verts = (rng.randn(V, 3) * 2.0).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    return verts, faces


@pytest.mark.parametrize("alpha", [0.0, -90.0, 33.3])
def test_rotation_equals_jax_in_every_bit(alpha):
    got, want = rotation(alpha), jax_rotation(alpha)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sample_surface_equals_jax_in_every_bit():
    verts, faces = _mesh(np.random.RandomState(1))
    np.testing.assert_array_equal(show._sample_surface(verts, faces, 500),
                                  jax_show._sample_surface(verts, faces, 500))


def _recorded_views(module, monkeypatch, obj_path, verts, faces, grid):
    """The arrays each ``show_*`` of ``module`` hands to matplotlib."""
    from mpl_toolkits.mplot3d import Axes3D
    import matplotlib.pyplot as plt
    calls = []
    for name in ("plot_trisurf", "voxels", "scatter"):
        orig = getattr(Axes3D, name)

        def record(self, *args, _orig=orig, _name=name, **kwargs):
            calls.append((_name, [np.asarray(a) for a in args]))
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(Axes3D, name, record)
    figs = [module.show_mesh(verts, faces, alpha=30.0, show=False),
            module.show_mesh(obj_path, show=False),
            module.show_voxels(grid, threshold=0.4, show=False),
            module.show_mesh_pointCloud(obj_path, num_points=300, show=False),
            module.show_mesh_pointCloud(verts, show=False)]
    for fig in figs:
        plt.close(fig)
    monkeypatch.undo()
    return calls


def test_show_views_plot_the_arrays_of_jax(monkeypatch, tmp_path):
    rng = np.random.RandomState(2)
    verts, faces = _mesh(rng)
    obj_path = str(tmp_path / "m.obj")
    save_mesh(verts, faces, obj_path)
    grid = rng.rand(6, 6, 6).astype(np.float32)
    got = _recorded_views(show, monkeypatch, obj_path, verts, faces, grid)
    want = _recorded_views(jax_show, monkeypatch, obj_path, verts, faces, grid)
    assert [c[0] for c in got] == [c[0] for c in want] == [
        "plot_trisurf", "plot_trisurf", "voxels", "scatter", "scatter"]
    for (_, a), (_, b) in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_time_this_and_trace(tmp_path, capsys):
    log = {}

    @profiling.time_this(log=log)
    def work(n):
        return torch.ones(n).sum()

    assert float(work(5)) == 5.0
    work(3)
    assert len(log["work"]) == 2 and all(dt >= 0 for dt in log["work"])

    @profiling.time_this
    def printed():
        return [torch.zeros(2)]
    printed()
    assert capsys.readouterr().out.startswith("printed: ")

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("port/annotated range"):
            torch.ones(64).cumsum(0)
    path = tmp_path / "tr" / "trace.json"
    assert path.stat().st_size > 0
    assert "port/annotated range" in path.read_text()


def test_plot_stats_renders_a_port_stats_file(tmp_path):
    meters = {k: AverageMeter(k) for k in ("voxel_loss", "chamfer_loss")}
    for epoch in range(3):
        for m in meters.values():
            m.update(1.0 / (epoch + 1))
            m.epoch_end()
    stats = str(tmp_path / "stats_0.st")
    save_stats(meters, stats)
    written = plot_stats.main(["--statsPath", stats, "--out", str(tmp_path / "plot")])
    assert sorted(os.path.basename(p) for p in written) == ["plot_chamfer_loss.png",
                                                            "plot_voxel_loss.png"]
    assert all(os.path.getsize(p) > 0 for p in written)


def _binvox_tree(root: str) -> None:
    """Two ShapeNet models (a 32^3 blob each) with their renderings."""
    rng = np.random.RandomState(3)
    zz, yy, xx = np.mgrid[:32, :32, :32]
    for synset, model_id in (("02691156", "a1"), ("03001627", "c7")):
        centre = rng.uniform(10, 22, 3)
        grid = ((zz - centre[0]) ** 2 + (yy - centre[1]) ** 2 + (xx - centre[2]) ** 2
                < rng.uniform(30, 60))
        vox_dir = os.path.join(root, "ShapeNetVox32", synset, model_id)
        os.makedirs(vox_dir)
        write_binvox(grid, os.path.join(vox_dir, "model.binvox"))
        png_dir = os.path.join(root, "ShapeNetRendering", synset, model_id, "rendering")
        os.makedirs(png_dir)
        for i in range(2):
            open(os.path.join(png_dir, f"{i:02d}.png"), "wb").close()


def test_download_dataset_renders_and_lists_as_jax(tmp_path):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    _binvox_tree(port_root)
    shutil.copytree(port_root, jax_root)
    download_dataset.main(["--render_meshes", "--build_manifest", "--root", port_root,
                           "--device", "cpu", "--batch", "1"])
    jax_download.render_shapenet_meshes(jax_root, 1)
    jax_download.build_manifest(jax_root)
    objs = []
    for dirpath, _, files in os.walk(port_root):
        objs += [os.path.relpath(os.path.join(dirpath, f), port_root)
                 for f in files if f.endswith(".obj")]
    assert len(objs) == 2
    for rel in objs:
        with open(os.path.join(port_root, rel)) as a, open(os.path.join(jax_root, rel)) as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(port_root, "shapenet.json")) as a, \
            open(os.path.join(jax_root, "shapenet.json")) as b:
        got, want = json.load(a), json.load(b)
    assert len(got) == 4
    assert json.dumps(got).replace(port_root, "R") == json.dumps(want).replace(jax_root, "R")


def test_render_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        download_dataset.main(["--render_meshes", "--root", str(tmp_path)])


def test_face_areas_and_sample_points_match_jax():
    rng = np.random.RandomState(4)
    verts, faces = _mesh(rng)
    mask = rng.rand(len(faces)) > 0.2
    want = np.asarray(jax_face_areas(verts, faces, mask))
    got = face_areas(t(verts), t(faces), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[~mask] == 0).all()

    key = jax.random.PRNGKey(9)
    for m, n in ((mask, 256), (np.zeros_like(mask), 64)):
        pts_w, valid_w = jax_sample_points(key, verts, faces, m, n)
        pts, valid = sample_points(t(verts), t(faces), t(m), n, Replay(sampler_draws(key, 1, n)))
        assert bool(valid) == bool(valid_w)
        assert rel_err_ok(pts.numpy(), np.asarray(pts_w), 1e-5)


def rel_err_ok(got, want, tol) -> bool:
    return float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


def test_point_cloud_f1_matches_jax_on_the_k2_route():
    rng = np.random.RandomState(5)
    p = rng.rand(500, 3).astype(np.float32)
    q = (p + rng.randn(500, 3).astype(np.float32) * 0.08)
    before = (chamfer_cuda.nn_bidir.launches, chamfer_cuda.chamfer_sums_fused.launches)
    for tau in (0.05, 0.1, 0.3):
        got = metrics.point_cloud_f1(t(p), t(q), tau)
        want = jax_metrics.point_cloud_f1(p, q, tau)
        assert all(abs(a - b) <= 1.0 / 500 + 1e-12 for a, b in zip(got[1:], want[1:]))
        assert abs(got[0] - want[0]) <= 2.0 / 500
    assert metrics.point_cloud_f1(p, p, 0.1) == (1.0, 1.0, 1.0)
    # CPU tensors take K1's plain twin: no kernel launch is counted
    assert (chamfer_cuda.nn_bidir.launches, chamfer_cuda.chamfer_sums_fused.launches) == before


def test_mask_paste_and_precision_helpers_equal_jax():
    rng = np.random.RandomState(6)
    mask = rng.rand(28, 28).astype(np.float32)
    for box in ([3.4, 5.6, 40.2, 50.9], [-2.0, 1.0, 10.0, 3.0], [60.0, 60.0, 70.0, 90.0]):
        np.testing.assert_array_equal(metrics.paste_mask_in_image(mask, box, 64, 64),
                                      jax_metrics.paste_mask_in_image(mask, box, 64, 64))
    pred = rng.uniform(0, 50, (5, 4)).astype(np.float32)
    pred[:, 2:] += pred[:, :2]
    gt = pred + rng.randn(5, 4).astype(np.float32) * 6
    assert (metrics.calc_precision_box(pred, gt)
            == jax_metrics.calc_precision_box(pred, gt))
    assert metrics.calc_precision_box(np.zeros((0, 4)), gt) == 0.0
    masks = rng.rand(4, 16, 16) > 0.5
    gts = masks ^ (rng.rand(4, 16, 16) > 0.8)
    assert metrics.calc_precision_mask(list(masks), gts) == \
        jax_metrics.calc_precision_mask(list(masks), gts)
    with pytest.raises(ValueError):
        metrics.calc_precision_mask(list(masks[:2]), gts)
