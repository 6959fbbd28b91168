"""The port's counterparts of tools/overfit_detector.py, quantify_normals.py
and quantify_knn.py against the JAX tools, on the CPU.

  * ``overfit_detector.detection_metrics`` on the same eval outputs (two
    batches of four 64x64 images, three slots each: valid and invalid slots,
    an image with no valid slot, two slots of equal IoU) equals the JAX
    tool's: AP_box, AP_mask and the valid fraction exactly, the mean best IoU
    to 1e-6 relative (float32 IoUs summed in another order);
  * a tiny run of ``overfit_detector.main`` (64x64 images, RPN 64 / 32,
    capacities 256/512/1024, one step) prints the JAX tool's lines, word for
    word but the numbers;
  * ``quantify_normals.measure`` on the teapot of the JAX tool, its noise
    and sampler draws at n=512 (so every kNN is exact, by design on both
    sides) against the numbers the JAX tool's ``main`` prints for it (its
    cubify mesh is the port's cubify, held against JAX's by
    tests/test_torch_cubify.py), to their printed precision
    plus 1e-4 (loss values, agreement statistics) and 2e-3 (gradient cosines
    and relative errors: float32 gradients through the eigensolver);
  * ``quantify_knn`` at n=2048, one trial: its approximate kNN takes the
    subtile the JAX CPU path takes (16), so recall, loss values and gradient
    agree with the JAX tool's printed numbers: recall within 2e-3 (distances
    in difference form against JAX's Gram form order near-ties apart), loss
    values within 1e-5 relative, the relative loss error within 1e-3
    absolute, gradient cosine within 1e-3 and relative L2 error within 2e-3.
"""
import functools
import importlib.util
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu_torch import overfit_detector, quantify_knn, quantify_normals
from meshrcnn_tpu_torch.core.config import CapacityConfig
from tests.torch_parity import sampler_draws

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _eval_outputs(seed: int, B: int = 4, D: int = 3, H: int = 64):
    """(images, GT boxes [B,1,4], GT masks [B,H,W], detection boxes [B,D,4],
    valid [B,D], mask probabilities [B,D,28,28]) as numpy."""
    rng = np.random.RandomState(seed)
    x0, y0 = rng.uniform(4, 20, (B, 1)), rng.uniform(4, 20, (B, 1))
    w, h = rng.uniform(16, 40, (B, 1)), rng.uniform(16, 40, (B, 1))
    gt = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)          # [B, 1, 4]
    boxes = (gt + rng.normal(0, 6, (B, D, 4))).astype(np.float32)
    boxes[0, 2] = boxes[0, 1]                                               # an IoU tie
    valid = rng.rand(B, D) > 0.3
    valid[0, 1:] = True
    valid[1] = False                                                        # no valid slot
    masks = np.zeros((B, H, H), np.float32)
    for b in range(B):
        x1, y1, x2, y2 = np.round(gt[b, 0]).astype(int)
        masks[b, y1:y2, x1:x2] = 1.0
    yy, xx = np.mgrid[:28, :28]
    blob = np.exp(-((yy - 13.5) ** 2 + (xx - 13.5) ** 2) / rng.uniform(60, 200, (B, D, 1, 1)))
    probs = (blob * rng.uniform(0.6, 1.2, (B, D, 1, 1))).astype(np.float32)
    probs[:, 0] = 0.9                            # slot 0's mask fills its box
    images = rng.rand(B, H, H, 3).astype(np.float32)
    return images, gt, masks, boxes, valid, probs


def test_detection_metrics_match_the_jax_tool():
    jax_tool = _jax_tool("overfit_detector")
    data = [_eval_outputs(s) for s in (0, 1)]

    def outputs(wrap):
        it = iter(data)

        def step(*args):
            _, _, _, boxes, valid, probs = next(it)
            return types.SimpleNamespace(
                detections=types.SimpleNamespace(boxes=wrap(boxes), valid=wrap(valid)),
                mask_probs=wrap(probs))
        return step

    jax_batches = [types.SimpleNamespace(images=im, boxes=gt, masks=m)
                   for im, gt, m, *_ in data]
    jax_step = outputs(jnp.asarray)
    want = jax_tool.detection_metrics(lambda state, images: jax_step(), None, jax_batches, None)
    port_step = outputs(torch.as_tensor)
    port_batches = [types.SimpleNamespace(images=torch.as_tensor(im), boxes=torch.as_tensor(gt),
                                          masks=torch.as_tensor(m)) for im, gt, m, *_ in data]
    got = overfit_detector.detection_metrics(lambda images: port_step(), port_batches)
    assert set(got) == set(want)
    for k in ("ap_box", "ap_mask", "any_valid_frac"):
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_allclose(got["mean_best_iou"], want["mean_best_iou"], rtol=1e-6)
    assert 0 < want["ap_box"] < 1 and 0 < want["ap_mask"] < 1 and want["any_valid_frac"] < 1


def _words(text: str) -> list:
    """The words of printed lines, every number replaced by #."""
    return re.sub(r"[-+]?\d+(\.\d+)?(e[-+]\d+)?", "#", text).split()


def test_tiny_run_prints_the_jax_tools_lines(monkeypatch, capsys):
    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    monkeypatch.setattr(overfit_detector, "CAPS", CapacityConfig(verts=256, faces=512,
                                                                 edges=1024))
    monkeypatch.setattr(overfit_detector, "Pix3DModel", functools.partial(
        Pix3DModel, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, roi_batch_size=32,
        mask_rois=8))
    rows = overfit_detector.main(["--device", "cpu", "--steps", "1", "--eval_every", "1",
                                  "--train_n", "2", "--test_n", "2", "--batch", "2",
                                  "--img_size", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "1 train batches, 1 test batches"
    source = (REPO / "tools" / "overfit_detector.py").read_text()
    template = re.search(r'print\(f"(step .*?)",\s*flush=True\)', source, re.S).group(1)
    template = re.sub(r'"\s*f"', "", template)
    jax_words = re.sub(r"\{[^{}]*\}", "#", template).split()
    assert [r["step"] for r in rows] == [1]
    for line in lines[1:]:
        assert _words(line) == jax_words, (line, jax_words)
    assert all(np.isfinite(r["loss"]) and set(r["train"]) == set(r["test"]) == {
        "ap_box", "ap_mask", "mean_best_iou", "any_valid_frac"} for r in rows)


def _numbers(text: str) -> list:
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", text)]


def _printed(text: str) -> list:
    """(value, half a unit of its last printed digit) of each name=value."""
    return [(float(v), 0.5 * 10.0 ** -len(d))
            for v, d in re.findall(r"=([-+]?\d+\.(\d+))", text)]


def test_quantify_normals_matches_the_jax_tool(monkeypatch, capsys):
    n, k = 512, 10
    monkeypatch.chdir(REPO)
    jax_tool = _jax_tool("quantify_normals")
    from meshrcnn_tpu.data.serialization import load_mesh as jax_load_mesh
    teapot = jax_load_mesh("tests/utils_tests/teapot.obj")
    meshes = {"teapot": (np.asarray(teapot.vertices, np.float32),
                         np.asarray(teapot.faces, np.int32))}
    port_meshes = quantify_normals.load_meshes(torch.device("cpu"))
    assert list(port_meshes) == ["teapot", "cubify"]
    monkeypatch.setattr(jax_tool, "load_meshes", lambda: meshes)
    monkeypatch.setattr(sys, "argv", ["quantify_normals.py", "--n", str(n), "--k", str(k)])
    jax_tool.main()
    jax_out = capsys.readouterr().out
    blocks = re.split(r"^\[", jax_out, flags=re.M)[1:]

    key = jax.random.PRNGKey(0)
    kp, kg = jax.random.split(key)
    kp2, kg2 = jax.random.split(jax.random.fold_in(key, 99))
    draws = {"pred": sampler_draws(kp, 1, n), "gt": sampler_draws(kg, 1, n),
             "pred2": sampler_draws(kp2, 1, n), "gt2": sampler_draws(kg2, 1, n)}
    for (name, (v, f)), block in zip(meshes.items(), blocks):
        pv, pf = port_meshes[name]
        np.testing.assert_array_equal(pv, v)
        np.testing.assert_array_equal(pf, f)
        noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (1,) + v.shape))[0]
        m = quantify_normals.measure(v, f, n, k, noise, draws, torch.device("cpu"))
        quantify_normals.report(name, m, n, k)
        port_out = capsys.readouterr().out
        assert _words(port_out) == _words("[" + block), (port_out, block)
        names = ["loss_face", "loss_pca_exact", "loss_pca_approx", "grad_cos", "grad_rel",
                 "self_pca", "self_face", "agree_mean", "agree_p10", "agree_frac"]
        tol = [1e-4] * 3 + [2e-3] * 4 + [1e-4] * 3
        printed = _printed(block)
        assert len(printed) == len(names)
        for key_name, (value, half), t in zip(names, printed, tol):
            assert abs(m[key_name] - value) <= half + t, (name, key_name, m[key_name], value)


def test_quantify_knn_matches_the_jax_tool(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["quantify_knn.py", "--n", "2048", "--trials", "1"])
    _jax_tool("quantify_knn").main()
    want = capsys.readouterr().out
    got_res = quantify_knn.main(["--device", "cpu", "--n", "2048", "--trials", "1"])
    got = capsys.readouterr().out
    assert _words(got) == _words(want)
    for (name, res), block in zip(got_res.items(), re.split(r"^\[", want, flags=re.M)[1:]):
        recall, val_rel, exact, approx, cos, rel = _numbers(block)
        row = res["trials"][0]
        assert abs(res["recall"] - recall) <= 2e-3, name
        assert abs(row["exact"] - exact) <= 1e-5 * abs(exact) + 5e-7, name
        assert abs(row["approx"] - approx) <= 1e-5 * abs(approx) + 5e-7, name
        assert abs(res["val_rel"] - val_rel) <= 1e-3, name
        assert abs(res["grad_cos"] - cos) <= 1e-3, name
        assert abs(res["grad_rel"] - rel) <= 2e-3, name
        assert res["recall"] < 1.0                      # the approximate kNN did run


def test_new_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path):
    from meshrcnn_tpu_torch import parity_recipes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (overfit_detector, quantify_normals, quantify_knn):
        assert tool.parser.get_default("device") == "cuda"
        with pytest.raises(RuntimeError, match="--device cpu"):
            tool.main([])
    assert parity_recipes.parser.get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        parity_recipes.main(["pix3d", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
