"""utils/checkpoint.py of the port (mirrors tests/test_checkpoint.py).

A checkpoint holds the model state, the optimizer's and the schedule's
state, the step, the generator of the step's draws and the model config,
and reloads exactly; it loads with ``weights_only=True``. A checkpoint of
another optimizer structure or a voxel-only one loads its matching model
entries through ``load_state_partial``, which counts shape mismatches as not
loaded; a ``mesh_feature_norm`` mismatch raises in both loads. The stats
files and meters equal the JAX package's; the CLIs' dtype rule.
"""
import copy

import numpy as np
import pytest
import torch

from meshrcnn_tpu.utils import meters as jax_meters
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig, resolve_backbone_dtype
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.ops.sampling import uniform_from
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state, make_train_step,
                                                    pix3d_lr)
from meshrcnn_tpu_torch.utils import meters
from meshrcnn_tpu_torch.utils.checkpoint import (checkpoint_dir, load_state, load_state_partial,
                                                 save_state)

TINY = dict(num_classes=13, cubify_threshold=0.2, voxel_out_channels=8, vert_capacity=256,
            face_capacity=512, edge_capacity=1024, num_refinement_stages=2,
            vertex_feature_dim=16)
SETTINGS = {"model": "ShapeNet", "voxel_only": False, "mesh_feature_norm": False,
            "backbone_dtype": "float32"}


def _config(**kw):
    base = dict(optimizer="adam", lr=1e-3, weight_decay=1e-4, point_cloud_size=64,
                loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5))
    return TrainConfig(**{**base, **kw})


def _batch(B=2):
    rng = np.random.RandomState(0)
    faces = np.zeros((B, 12, 3), np.int32)
    faces[:, :6] = rng.randint(0, 8, (B, 6, 3))
    mask = np.zeros((B, 12), bool)
    mask[:, :6] = True
    return Batch.from_host(type("B", (), dict(
        images=rng.rand(B, 48, 48, 3).astype(np.float32),
        voxels=(rng.rand(B, 8, 18, 18) > 0.5).astype(np.float32),
        gt_verts=rng.randn(B, 8, 3).astype(np.float32), gt_faces=faces, gt_faces_mask=mask,
        labels=rng.randint(0, 13, (B,)).astype(np.int32)))(), "cpu")


def _trained(config, steps=2, seed=0, **model_kw):
    """A tiny ShapeNet train state after ``steps`` steps, with its generator."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    state = create_train_state(ShapeNetModel(**{**TINY, **model_kw}), config, gen)
    step = make_train_step(config, uniform_from(gen))
    for _ in range(steps):
        step(state, _batch())
    return state


def _fresh(config, seed=1, **model_kw):
    torch.manual_seed(seed)
    return create_train_state(ShapeNetModel(**{**TINY, **model_kw}), config,
                              torch.Generator().manual_seed(seed))


def _assert_same(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            w = ob["state"][i][k]
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w, (i, k)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("config", [_config(), _config(optimizer="sgd", pix3d_schedule=True)],
                         ids=["adam", "sgd-pix3d-schedule"])
def test_round_trip_exact_and_resume_continues(tmp_path, config):
    state = _trained(config)
    path = save_state(state, str(tmp_path / "model"), SETTINGS, step=3)
    assert path.endswith("model_3.pt")
    raw = torch.load(path, weights_only=True)          # plain data only
    assert raw["settings"] == SETTINGS and raw["step"] == 2
    restored = load_state(path, _fresh(config), SETTINGS)
    _assert_same(state, restored)
    if config.pix3d_schedule:
        assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(pix3d_lr(2), rel=1e-15)
    # one more step from each: the same state, and the schedule continues
    for s in (state, restored):
        make_train_step(config, uniform_from(s.generator))(s, _batch())
    _assert_same(state, restored)
    if config.pix3d_schedule:
        assert restored.scheduler.last_epoch == restored.step == 3
        assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(pix3d_lr(3), rel=1e-15)


def test_resume_keeps_this_runs_hyperparameters(tmp_path):
    """A resumed run uses its own config's learning rate and weight decay, as
    the JAX optimizer (a function of the config) does; the moments come back."""
    state = _trained(_config())
    path = save_state(state, str(tmp_path / "model"), SETTINGS)
    restored = load_state(path, _fresh(_config(lr=5e-4, weight_decay=0.0)), SETTINGS)
    group = restored.optimizer.param_groups[0]
    assert group["lr"] == 5e-4 and group["weight_decay"] == 0.0
    p = next(iter(state.optimizer.state))
    q = restored.optimizer.param_groups[0]["params"][0]
    assert torch.equal(state.optimizer.state[p]["exp_avg"], restored.optimizer.state[q]["exp_avg"])


def test_partial_restore_across_optimizer_structures(tmp_path):
    """A checkpoint of a --train_backbone SGD run into an Adam run with a frozen
    backbone: ``load_state`` rejects it, ``load_state_partial`` merges every
    model entry and leaves the optimizer fresh."""
    writer = _trained(_config(optimizer="sgd", train_backbone=True))
    path = save_state(writer, str(tmp_path / "w"), SETTINGS)
    reader = _fresh(_config())
    with pytest.raises(ValueError, match="SGD"):
        load_state(path, reader, SETTINGS)
    n_loaded, n_total = load_state_partial(path, reader, SETTINGS)
    assert n_loaded == n_total == len(list(reader.model.parameters()))
    for k, v in writer.model.state_dict().items():
        assert torch.equal(v, reader.model.state_dict()[k]), k
    assert reader.step == 0 and not reader.optimizer.state


def test_voxel_only_into_full_model_partial_restore(tmp_path):
    """The curriculum: a voxel-only checkpoint loads into the full model only
    through ``load_state_partial``, which counts the refine stages as not loaded."""
    torch.manual_seed(0)
    vox = create_train_state(ShapeNetModel(**TINY, voxel_only=True), _config())
    path = save_state(vox, str(tmp_path / "vox"), dict(SETTINGS, voxel_only=True))
    full = _fresh(_config())
    with pytest.raises(ValueError, match="voxel_only"):
        load_state(path, full, SETTINGS)
    n_loaded, n_total = load_state_partial(path, full, SETTINGS)
    refine = [k for k, _ in full.model.named_parameters() if k.startswith("refine")]
    assert refine and n_total == len(list(full.model.parameters()))
    assert n_loaded == n_total - len(refine)
    assert torch.equal(full.model.voxelBranch.conv0.weight, vox.model.voxelBranch.conv0.weight)


def test_partial_restore_counts_shape_mismatches(tmp_path):
    """Another --featDim shares every name of the refine stages but not their
    shapes: those count as not loaded and keep their fresh initialisation."""
    writer = _trained(_config(), steps=0)
    path = save_state(writer, str(tmp_path / "w"), SETTINGS)
    wide = _fresh(_config(), vertex_feature_dim=32)
    before = copy.deepcopy(wide.model.state_dict())
    n_loaded, n_total = load_state_partial(path, wide, SETTINGS)
    mismatched = [k for k, p in wide.model.named_parameters()
                  if p.shape != writer.model.state_dict()[k].shape]
    assert mismatched and n_loaded == n_total - len(mismatched)
    for k in mismatched:
        assert torch.equal(wide.model.state_dict()[k], before[k]), k


def test_model_config_checks(tmp_path, capsys):
    """``mesh_feature_norm`` must agree in both loads; another ``backbone_dtype``
    loads with a warning (the weights are float32 either way)."""
    torch.manual_seed(0)
    model = Pix3DModel(num_classes=10, voxel_out_channels=8, vert_capacity=64,
                       face_capacity=128, edge_capacity=256, num_refinement_stages=1,
                       vertex_feature_dim=8, backbone_dtype="float32", mesh_feature_norm=True)
    settings = {"model": "Pix3D", "voxel_only": False, "mesh_feature_norm": True,
                "backbone_dtype": "float32"}
    state = create_train_state(model, _config())
    path = save_state(state, str(tmp_path / "p"), settings)
    for load in (load_state, load_state_partial):
        with pytest.raises(ValueError, match="mesh_feature_norm"):
            load(path, create_train_state(copy.deepcopy(model), _config()),
                 dict(settings, mesh_feature_norm=False))
    load_state(path, create_train_state(copy.deepcopy(model), _config()),
               dict(settings, backbone_dtype="bfloat16"))
    assert "warning" in capsys.readouterr().out


def test_checkpoint_dir_layout(tmp_path):
    import datetime
    path = checkpoint_dir(str(tmp_path), "Pix3D")
    assert path == str(tmp_path / "Pix3D" / "GCN" / datetime.date.today().isoformat())
    assert (tmp_path / "Pix3D" / "GCN").is_dir()


def test_resolve_backbone_dtype():
    """"auto" is bfloat16 on the card and float32 on the CPU; a dtype passes through."""
    assert resolve_backbone_dtype("auto", "cpu") == "float32"
    assert resolve_backbone_dtype("auto", "cuda:0") == "bfloat16"
    for name in ("float32", "bfloat16"):
        assert resolve_backbone_dtype(name, "cpu") == name


def test_meters_stats_files_and_progress_match_jax(tmp_path, capsys):
    """The meter dicts, their progress lines and the pickled ``.st`` stats of the
    port equal the JAX package's, and each package's ``load_stats`` reads both."""
    ours, theirs = meters.basic_metrics(), jax_meters.basic_metrics()
    assert list(ours) == list(theirs)
    assert [m.fmt for m in ours.values()] == [m.fmt for m in theirs.values()]
    assert list(meters.gcn_metrics(True)) == list(jax_meters.gcn_metrics(True))
    packs = [(meters, meters.gcn_metrics()), (jax_meters, jax_meters.gcn_metrics())]
    for epoch in range(2):
        for _, ms in packs:
            for i, m in enumerate(ms.values()):
                m.update(0.25 * i + epoch, 2)
        lines = []
        for mod, ms in packs:
            mod.ProgressMeter(7, ms.values(), prefix="Epoch: [0]").display(3)
            lines.append(capsys.readouterr().out)
        assert lines[0] == lines[1] and lines[0].startswith("Epoch: [0][3/7]\t")
        for _, ms in packs:
            for m in ms.values():
                m.epoch_end()
    meters.save_stats(packs[0][1], str(tmp_path / "port.st"))
    jax_meters.save_stats(packs[1][1], str(tmp_path / "jax.st"))
    assert (tmp_path / "port.st").read_bytes() == (tmp_path / "jax.st").read_bytes()
    for load in (meters.load_stats, jax_meters.load_stats):
        stats = load(str(tmp_path / "port.st"))
        assert stats["edge_loss"] == {"name": "edge_loss", "history": [1.0, 2.0]}
