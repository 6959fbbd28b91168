"""The parity recipes' runner (``meshrcnn_tpu_torch.parity_recipes``), the
CLIs' ``--knn_normals`` and the frozen Pix3D detector, on the CPU.

  * each recipe's phases are its tools/run_*.sh script's commands, flag for
    flag: the script's text is parsed (never edited), its variables filled
    with the runner's values, and the runner's own flags (``--device``,
    ``--knn_normals``) set aside; the scripts' positional
    knobs default as the runner's flags do;
  * ``--knn_normals`` is on every phase of exactly the scripts that export
    ``MESHRCNN_FACE_NORMALS=0``;
  * the port's ``train`` and ``eval_model`` with ``--knn_normals`` on a tiny
    ShapeNet model (16 features, one stage, capacities 512/1024/2048,
    256-point clouds, so exact kNN on both sides) against what the JAX CLIs
    ``train.py`` / ``eval_model.py`` compute at the same flags with
    ``MESHRCNN_FACE_NORMALS=0`` set by ``monkeypatch``, through the functions
    they call (``shapenet_loss_fn``, ``harness.validate``) on the model they
    build, with a float32 backbone as the port's on the CPU: the same initial
    weights (the JAX CLIs' own ``PRNGKey(0)`` init, carried over by
    ``utils/jax_params.py``) and the JAX draws replayed into the port.
    One train step's losses (the forward before the update, in train mode)
    within 1e-4 relative, the eval's losses within 1e-4 of scale, its voxel
    IoU and f-scores to 1e-6, F1 within 2 points a sample and tau, as
    tests/test_torch_cli.py holds them;
  * the frozen Pix3D detector of ``run_pix3d_finetune.sh frozen`` (no
    ``--train_backbone``): three SGD steps of the tiny Pix3D model under the
    Pix3D schedule with grad clip 1.0 and weight decay leave every
    ``backbone.*`` parameter equal in every bit and move the mesh branch; the
    frozen and trained names are those the JAX optimizer (``make_optimizer``,
    ``multi_transform`` with ``set_to_zero``) gives no update and an update,
    mapped through ``utils/jax_params.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu import harness as jax_harness
from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.core.config import LossWeights as JaxLossWeights
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.data.datasets import SyntheticDataset as JaxSyntheticDataset
from meshrcnn_tpu.data.datasets import dataLoader as jax_data_loader
from meshrcnn_tpu.harness import validate as jax_validate
from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu.models.shapenet import ShapeNetModel as JaxShapeNetModel
from meshrcnn_tpu.parallel import train_step as jts
from meshrcnn_tpu_torch import eval_model, parity_recipes, train
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state, make_train_step,
                                                    trainable_parameters)
from meshrcnn_tpu_torch.utils import cli
from meshrcnn_tpu_torch.utils.checkpoint import save_state
from meshrcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.test_pix3d import TINY, tiny_batch
from tests.test_torch_cli import _State
from tests.torch_parity import (Replay, eval_metric_draws, load_flax, to_numpy_tree,
                                train_step_draws)

REPO = Path(__file__).resolve().parents[1]
RUNNER_ONLY = {"--device": 1, "--knn_normals": 0}
SCRIPTS = {"shapenet": "run_parity_experiment.sh", "pix3d": "run_pix3d_parity.sh",
           "pix3d_detection_scale": "run_pix3d_detection_scale.sh",
           "pix3d_finetune": "run_pix3d_finetune.sh"}


def _script(recipe: str) -> str:
    return (REPO / "tools" / SCRIPTS[recipe]).read_text()


def _script_commands(text: str, values: dict) -> list:
    """The ``python train.py`` / ``eval_model.py`` commands of a script as
    (cli, argv), its ``NAME="..."`` variables and ``values`` substituted."""
    text = text.replace("\\\n", " ")
    assigned = {}
    commands = []
    for line in text.splitlines():
        line = line.strip()
        m = re.match(r'^([A-Z0-9_]+)="(.*)"$', line)
        if m and m.group(1) not in values:
            assigned.setdefault(m.group(1), []).append(m.group(2))
        m = re.match(r"^python (train|eval_model)\.py (.*?)( 2>&1.*)?$", line)
        if m:
            commands.append((m.group(1), m.group(2)))

    def expand(s: str, env: dict) -> str:
        return re.sub(r"\$\{?([A-Z0-9_]+)\}?", lambda m: env[m.group(1)], s)
    out = []
    for variant in range(len(assigned.get("PHASE2", [None]))):
        env = dict(values)
        for name, texts in assigned.items():
            env[name] = expand(texts[min(variant, len(texts) - 1)], env)
        out.append([(kind, expand(args, env).replace('"', "").split())
                    for kind, args in commands])
    return out


def _without_runner_flags(argv: list) -> list:
    out, skip = [], 0
    for a in argv:
        if skip:
            skip -= 1
        elif a in RUNNER_ONLY:
            skip = RUNNER_ONLY[a]
        else:
            out.append(a)
    return out


def _script_defaults(text: str) -> dict:
    return dict(re.findall(r"^(N|EPOCHS|MODE)=\$\{\d:-([^}]+)\}$", text, re.M))


@pytest.mark.parametrize("recipe,mode", [("shapenet", None), ("pix3d", None),
                                         ("pix3d_detection_scale", None),
                                         ("pix3d_finetune", "frozen"),
                                         ("pix3d_finetune", "2e-3")])
def test_runner_phases_are_the_scripts_commands(recipe, mode):
    text = _script(recipe)
    defaults = _script_defaults(text)
    n, epochs = parity_recipes.DEFAULTS[recipe]
    if recipe != "shapenet":
        assert (str(n), str(epochs)) == (defaults["N"], defaults["EPOCHS"])
    if recipe == "pix3d_finetune":
        assert defaults["MODE"] == parity_recipes.parser.get_default("mode")
    argv = [recipe, "--out", "OUT", "--data_root", "DATA", "--ckpt", "CKPT"]
    args = parity_recipes.parser.parse_args(argv + (["--mode", mode] if mode else []))
    phases = parity_recipes.phases(args)
    size = str(int(round(n / 0.85)))
    values = {"DATA": "DATA", "OUT": "OUT", "N": str(n), "EPOCHS": str(epochs), "SIZE": size,
              "MODE": mode or "", "WARM": "{warm}", "FULL": "{full}"}
    values["CKPT"] = "CKPT" if recipe == "pix3d_finetune" else "{train}"
    values["CKPT2"] = "{train}"
    variants = _script_commands(text, values)
    want = variants[0 if mode in (None, "frozen") else 1]
    got = [(kind, _without_runner_flags(a)) for _, kind, a in phases]
    assert got == [("train" if k == "train" else "eval", a) for k, a in want]
    assert all(a[a.index("--device") + 1] == "cuda" for _, _, a in phases)


@pytest.mark.parametrize("recipe", parity_recipes.RECIPES)
def test_knn_normals_exactly_where_the_script_exports_face_normals_off(recipe):
    exported = "export MESHRCNN_FACE_NORMALS=0" in _script(recipe)
    args = parity_recipes.parser.parse_args([recipe, "--out", "O", "--data_root", "D",
                                             "--ckpt", "C"])
    assert {"--knn_normals" in a for _, _, a in parity_recipes.phases(args)} == {exported}
    assert train.parser.parse_args(["--model", "ShapeNet"]).knn_normals is False
    assert eval_model.parser.parse_args(["--model", "Pix3D"]).knn_normals is False


PCS, B, SIZE = 256, 2, 8
TINY_FLAGS = ["--featDim", "16", "-nr", "1", "--vert_capacity", "512", "--face_capacity",
              "1024", "--edge_capacity", "2048", "--point_cloud_size", str(PCS),
              "--workers", "2", "--num_devices", "1"]
TRAIN_FLAGS = ["--model", "ShapeNet", "-b", str(B), "--num_sampels", str(B),
               "--synthetic_size", str(SIZE), "--nEpoch", "1", "--normal", "0.1",
               "--print_freq", "1"] + TINY_FLAGS
EVAL_FLAGS = ["--model", "ShapeNet", "-b", str(B), "--synthetic_size", str(SIZE),
              "--test_ratio", "0.5"] + TINY_FLAGS


@pytest.fixture(scope="module")
def jax_refs():
    """What the JAX ``train.py`` and ``eval_model.py`` compute at these flags
    under ``MESHRCNN_FACE_NORMALS=0``, from the functions they call, on the
    ShapeNet model they build (its backbone in float32, as the port's on the
    CPU; the JAX CLIs' bfloat16 rounds on another path than the port's CPU
    convolutions) with their initial weights (``create_train_state``'s init
    at ``PRNGKey(0)``): the train step's losses of its first batch and key
    (``shapenet_loss_fn``, the forward before the update) and the eval's
    ``harness.validate``. The JAX eval metrics program is a module-level jit
    traced once a shape, so its cache is cleared around the environment
    change."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MESHRCNN_FACE_NORMALS", "0")
        jax_harness._shapenet_eval_metrics.clear_cache()
        jm = JaxShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                              vertex_feature_dim=16, num_refinement_stages=1,
                              vert_capacity=512, face_capacity=1024, edge_capacity=2048,
                              backbone_dtype="float32")
        variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
            jnp.zeros((1, 64, 64, 3), jnp.float32))
        caps = JaxCapacityConfig(verts=512, faces=1024, edges=2048)
        dataset = JaxSyntheticDataset(n=SIZE, image_size=137, num_voxels=32, num_classes=13)

        # each CLI draws its initialising batch first, and each pass of a
        # loader shuffles anew: the step and the eval see the second pass
        loader = jax_data_loader(dataset, B, 48, caps, num_train_samples=B)
        next(iter(loader))
        batch = next(iter(loader))
        config = JaxTrainConfig(point_cloud_size=PCS, loss_weights=JaxLossWeights(normal=0.1))
        losses = jax.jit(lambda v, b, k: jts.shapenet_loss_fn(
            jm, config, v["params"], v["batch_stats"], b, k)[1][0])
        train_losses = jax.device_get(losses(variables, jax.tree_util.tree_map(
            jnp.asarray, batch), jax.random.fold_in(jax.random.PRNGKey(0), 0)))

        loader = jax_data_loader(dataset, B, 48, caps, test=True, train_ratio=0.5)
        next(iter(loader))
        metrics = jax_validate(0, jts.make_eval_step(jm),
                               _State(variables["params"], variables["batch_stats"]),
                               loader, JaxTrainConfig(point_cloud_size=PCS), 13,
                               jax.random.PRNGKey(0))
    finally:
        jax_harness._shapenet_eval_metrics.clear_cache()
        mp.undo()
    return variables, train_losses, metrics


def _port_checkpoint(variables, tmp_path, config: TrainConfig) -> str:
    """The JAX weights in a checkpoint of the port's CLIs, with ``config``'s
    fresh optimizer state."""
    options = train.parser.parse_args(["--model", "ShapeNet", "--device", "cpu"] + TINY_FLAGS)
    settings = train.model_settings(options, torch.device("cpu"))
    model = load_flax(cli.build_model(settings, torch.device("cpu")), variables)
    return save_state(create_train_state(model, config), str(tmp_path / "start"), settings)


def test_train_knn_normals_matches_jax_cli(jax_refs, tmp_path):
    variables, want, _ = jax_refs
    flags = TRAIN_FLAGS + ["--knn_normals"]
    config = train.train_config(train.parser.parse_args(flags))
    assert config.face_normals is False
    path = _port_checkpoint(variables, tmp_path, config)
    draws = train_step_draws(jax.random.fold_in(jax.random.PRNGKey(0), 0), B, PCS,
                             num_stages=1)
    out = train.main(flags + ["--device", "cpu", "--model_path", path, "--checkpoint_root",
                              str(tmp_path / "ck")], uniform=Replay(draws))
    assert out["state"].step == 1
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss", "loss"):
        got = out["meters"][k].history[0]
        assert abs(got - float(want[k])) <= 1e-4 * abs(float(want[k])), (k, got, want[k])
    assert want["normal_loss"] < 0


def test_eval_knn_normals_matches_jax_cli(jax_refs, tmp_path):
    variables, _, want = jax_refs
    flags = EVAL_FLAGS + ["--knn_normals"]
    path = _port_checkpoint(variables, tmp_path, TrainConfig())
    draws = [d for i in range(SIZE // 2 // B) for d in
             eval_metric_draws(jax.random.fold_in(jax.random.PRNGKey(0), i), B, PCS,
                               num_stages=1)]
    got = eval_model.main(flags + ["--device", "cpu", "--model_path", path, "--output_path",
                                   str(tmp_path)], uniform=Replay(draws))
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    for k in ("voxel_iou", "f0_1", "f0_3", "f0_5"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for tau in (0.1, 0.3):
        assert abs(got[f"F1@{tau}"] - want[f"F1@{tau}"]) <= 2.0 / PCS, tau
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


def test_frozen_detector_stays_bit_equal_and_matches_jax_labels():
    torch.manual_seed(0)
    model = Pix3DModel(backbone_dtype="float32", **TINY)
    config = TrainConfig(optimizer="sgd", weight_decay=1e-4, grad_clip=1.0,
                         pix3d_schedule=True, train_backbone=False, point_cloud_size=128)
    trained = {n for n, p in model.named_parameters()
               if any(p is q for q in trainable_parameters(model, config))}

    # JAX's labels: the leaves its optimizer gives an update for a unit gradient
    jcfg = JaxTrainConfig(optimizer="sgd", weight_decay=1e-4, grad_clip=1.0,
                          pix3d_schedule=True, train_backbone=False)
    jm = JaxPix3DModel(backbone_dtype="float32", **TINY)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    params = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), shapes["params"])
    tx = jts.make_optimizer(jcfg, params)
    updates, _ = jax.jit(tx.update)(jax.tree_util.tree_map(np.ones_like, params),
                                    tx.init(params), params)
    moved = state_dict_from_jax(model, to_numpy_tree(updates), {})
    assert set(moved) == {n for n, _ in model.named_parameters()}
    assert {n for n, u in moved.items() if u.abs().sum() > 0} == trained
    assert trained == {n for n, _ in model.named_parameters() if not n.startswith("backbone.")}

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, config)
    step = make_train_step(config, lambda shape: torch.rand(shape))
    batch = Batch.from_host(tiny_batch(B), "cpu")
    for _ in range(3):
        metrics = step(state, batch)
        assert float(metrics["grads_finite"]) == 1.0
    after = dict(model.named_parameters())
    assert all(torch.equal(after[n], start[n]) for n in start if n.startswith("backbone."))
    assert any(not torch.equal(after[n], start[n]) for n in trained)
    assert int(state.scheduler.last_epoch) == 3
