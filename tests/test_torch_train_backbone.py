"""The port's backbone training (``python -m meshrcnn_tpu_torch.train_backbone``)
against the JAX step that train_backbone.py builds, written out the same way
here, and its checkpoints.

  * ShapeNet: one ResNet-50 classifier step (softmax cross-entropy, Adam
    after L2 weight decay) at 48x48, B=2, float32, as train_backbone.py:71-81;
  * Pix3D: one Mask R-CNN step (the sum of its RPN and RoI-head losses, SGD
    after L2 weight decay under the Pix3D schedule) at tests/test_pix3d.py's
    tiny sizes (64x64, RPN 64 / 32, 32 sampled RoIs and 8 mask RoIs an image),
    float32 detection stack, RoIAlign by corner gathers on the JAX side, the
    samplers' draws replayed (``torch_parity.maskrcnn_train_draws``), as
    train_backbone.py:150-163.

Tolerances and why: in train mode these tiny models are ill-conditioned
(BatchNorm over few values; the RPN's matches at IoU 0.7 / 0.3), so the loss,
each Mask R-CNN loss and the updated parameters are held within 4x JAX's own
spread, the largest change of four 1e-6 changes of the input images, plus
1e-4 of scale (tests/test_torch_pix3d_train.py); the classifier's accuracy
exactly (a count of argmax hits). The CLI's checkpoint layout, and
``load_backbone`` of its ``backbone_<epoch>.pt`` into a fresh model with every
backbone tensor loaded and none left fresh, are checked at small sizes.
"""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meshrcnn_tpu.models.pix3d import Pix3DMaskRCNN as JaxPix3DMaskRCNN
from meshrcnn_tpu.models.resnet import ResNet50 as JaxResNet50
from meshrcnn_tpu_torch import train, train_backbone
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DMaskRCNN, Pix3DModel
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.parallel.train_step import make_optimizer
from meshrcnn_tpu_torch.utils.meters import load_stats
from meshrcnn_tpu_torch.utils.torch_convert import load_backbone
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import (Replay, load_flax, maskrcnn_train_draws, nudged_images, t,
                                within_spread)

B = 2
LR, WD = 1e-4, 5e-6             # the CLI's defaults
KEY = jax.random.PRNGKey(8)
ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
PROPOSALS = TINY["rpn_post_nms_top_n"] + 1
HEADS = {k: TINY[k] for k in ("num_classes", "detections_per_img", "rpn_pre_nms_top_n",
                              "rpn_post_nms_top_n", "roi_batch_size", "mask_rois")}
MASKRCNN_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
                   "loss_mask")
SEEDS = (0, 1, 2)


def _sd(module: torch.nn.Module, params, batch_stats) -> dict:
    m = load_flax(module, {"params": params, "batch_stats": batch_stats})
    return {k: v.numpy().astype(np.float64) for k, v in m.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _jax_classifier_step(images, labels):
    """train_backbone.py:62-81 at float32, for ``images`` and its nudges."""
    model = JaxResNet50(num_classes=13)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(images)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))

    @jax.jit
    def step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            (logits, _), upd = model.apply({"params": p, "batch_stats": batch_stats},
                                           images, train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            acc = (jnp.argmax(logits, -1) == labels).mean()
            return loss, (acc, upd["batch_stats"])
        (loss, (acc, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, loss, acc

    def run(x):
        p, bs, _, loss, acc = step(variables["params"], variables["batch_stats"],
                                   tx.init(variables["params"]), x, labels)
        return {"loss": float(loss), "acc": float(acc)}, _sd(ResNet50(num_classes=13), p, bs)
    return variables, run(images), [run(x) for x in nudged_images(images, SEEDS)]


def test_classifier_step_matches_jax():
    rng = np.random.RandomState(0)
    images = rng.rand(B, 48, 48, 3).astype(np.float32)
    labels = rng.randint(0, 13, (B,)).astype(np.int32)
    variables, (want, want_sd), nudged = _jax_classifier_step(images, labels)

    model = load_flax(ResNet50(num_classes=13), variables)
    optimizer, _ = make_optimizer(TrainConfig(optimizer="adam", lr=LR, weight_decay=WD,
                                              train_backbone=True), model)
    loss, acc = train_backbone.classifier_step(model, optimizer, t(images), t(labels))
    spread = max(abs(n[0]["loss"] - want["loss"]) for n in nudged)
    assert abs(float(loss) - want["loss"]) <= 4 * spread + 1e-4 * max(want["loss"], 1.0)
    assert float(acc) == want["acc"]
    got = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items()
           if k in want_sd}
    params = [k for k in want_sd if "running_" not in k]
    stats = [k for k in want_sd if "running_" in k]
    within_spread(got, want_sd, [n[1] for n in nudged], params, "classifier update")
    within_spread(got, want_sd, [n[1] for n in nudged], stats, "classifier BN statistics")


@pytest.fixture(scope="module")
def maskrcnn_jax():
    """train_backbone.py:130-163's step on the tiny model, from the initial
    state, on the tiny batch and on each nudge of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
        batch = tiny_batch(B)
        model = JaxPix3DMaskRCNN(compute_dtype="float32", **HEADS)
        variables = jax.jit(functools.partial(model.init, train=False))(
            jax.random.PRNGKey(0), batch.images[:1])

        def lr(step):
            warm = 0.002 + (0.02 - 0.002) * jnp.minimum(step / 1000.0, 1.0)
            decay = jnp.where(step >= 10000, 0.01, jnp.where(step >= 8000, 0.1, 1.0))
            return warm * decay
        tx = optax.chain(optax.add_decayed_weights(WD), optax.sgd(lr))

        @jax.jit
        def step(params, batch_stats, opt_state, images, boxes, labels, masks, key):
            def loss_fn(p):
                (dets, losses, _), upd = model.apply(
                    {"params": p, "batch_stats": batch_stats}, images, train=True,
                    gt_boxes=boxes, gt_labels=labels, gt_masks=masks, rng=key,
                    mutable=["batch_stats"])
                total = sum(losses.values())
                return total, (losses, upd.get("batch_stats", batch_stats))
            (total, (losses, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_bs, new_opt, total, losses

        template = Pix3DMaskRCNN(compute_dtype="float32", **HEADS)

        def run(x):
            p, bs, _, total, losses = step(
                variables["params"], variables.get("batch_stats", {}),
                tx.init(variables["params"]), x, batch.boxes, batch.labels, batch.masks, KEY)
            metrics = {"loss": float(total), **{k: float(v) for k, v in losses.items()}}
            return metrics, _sd(template, p, bs)
        return dict(batch=batch, variables=variables, want=run(batch.images),
                    nudged=[run(x) for x in nudged_images(batch.images, SEEDS)])


def test_maskrcnn_step_matches_jax(maskrcnn_jax):
    batch = maskrcnn_jax["batch"]
    model = load_flax(Pix3DMaskRCNN(compute_dtype="float32", **HEADS), maskrcnn_jax["variables"])
    optimizer, scheduler = make_optimizer(TrainConfig(optimizer="sgd", weight_decay=WD,
                                                      train_backbone=True,
                                                      pix3d_schedule=True), model)
    uniform = Replay(maskrcnn_train_draws(KEY, B, ANCHORS, PROPOSALS, TINY["roi_batch_size"]))
    total, losses = train_backbone.maskrcnn_step(
        model, optimizer, scheduler, uniform, t(batch.images), t(batch.boxes), t(batch.labels),
        t(batch.masks))
    assert not uniform.draws
    assert optimizer.param_groups[0]["lr"] == pytest.approx(0.002 + 0.018 / 1000)
    want, want_sd = maskrcnn_jax["want"]
    got = {"loss": float(total), **{k: float(v) for k, v in losses.items()}}
    assert set(got) == set(want) == {"loss", *MASKRCNN_LOSSES}
    for k in want:
        spread = max(abs(n[0][k] - want[k]) for n in maskrcnn_jax["nudged"])
        assert abs(got[k] - want[k]) <= 4 * spread + 1e-4 * max(abs(want[k]), 1.0), (
            k, got[k], want[k], spread)
    sd = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items() if k in want_sd}
    params = [k for k in want_sd if "running_" not in k]
    within_spread(sd, want_sd, [n[1] for n in maskrcnn_jax["nudged"]], params, "Mask R-CNN update")


@pytest.mark.parametrize("model", ["ShapeNet", "Pix3D"])
def test_cli_checkpoint_loads_as_a_backbone(tmp_path, model):
    """Layout ``<root>/<Model>/backbone/<date>/backbone_0.pt`` + ``stats_0.st``;
    ``load_backbone`` takes every backbone tensor of it into a fresh model, and
    the train CLI starts from it with ``--backbone_path``."""
    out = train_backbone.main(["--model", model, "--device", "cpu", "-b", "2",
                               "--num_sampels", "2", "--nEpoch", "1", "--workers", "0",
                               "--checkpoint_root", str(tmp_path / "ck")])
    day = os.path.basename(out["dir"])
    assert out["dir"] == str(tmp_path / "ck" / model / "backbone" / day)
    assert sorted(os.listdir(out["dir"])) == ["backbone_0.pt", "stats_0.st"]
    stats = load_stats(out["stats"][0])
    want_keys = ({"loss", "acc", "batch_time"} if model == "ShapeNet" else
                 {"loss", "batch_time", "data_loading", *MASKRCNN_LOSSES})
    assert set(stats) == want_keys
    assert all(len(v["history"]) == 1 and np.isfinite(v["history"][0]) for v in stats.values())

    fresh = Pix3DModel() if model == "Pix3D" else ShapeNetModel()
    n_loaded, n_fresh = load_backbone(fresh, out["checkpoints"][0], maskrcnn=model == "Pix3D")
    trained = out["model"].state_dict()
    assert (n_loaded, n_fresh) == (len(trained), 0)
    sd = fresh.state_dict()
    assert all(torch.equal(sd[f"backbone.{k}"], v) for k, v in trained.items())

    small = ["--model", model, "--device", "cpu", "-b", "2", "--num_sampels", "2",
             "--nEpoch", "1", "-nr", "1", "--featDim", "16", "--vert_capacity", "512",
             "--face_capacity", "1024", "--edge_capacity", "2048", "--point_cloud_size", "128",
             "--workers", "0", "--backbone_path", out["checkpoints"][0],
             "--checkpoint_root", str(tmp_path / "gcn")]
    if model == "Pix3D":
        small += ["--img_size", "64", "--rpn_pre_nms_top_n", "64",
                  "--rpn_post_nms_top_n", "32", "--roi_batch_size", "32", "--optim", "SGD"]
    res = train.main(small)
    assert res["state"].step == 1
    sd = res["state"].model.state_dict()
    frozen = [k for k in trained if f"backbone.{k}" in sd and "running_" not in k
              and "num_batches" not in k]
    if model == "ShapeNet":          # the GCN step keeps the backbone frozen
        assert all(torch.equal(sd[f"backbone.{k}"], trained[k]) for k in frozen)
    shutil.rmtree(tmp_path)          # ~0.4-0.8 GB of full-width checkpoints


def test_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_backbone.main(["--model", "ShapeNet"])
