"""Reference-style model API: ``model(images, targets) -> dict`` (counterpart of
meshrcnn_tpu/models/api.py; reference: meshRCNN/shapenet_model.py:43-99,
pix3d_model.py:46-117).

The reference's models are stateful modules whose forward returns a loss
dict in training mode and a prediction dict in eval mode. These wrappers give
the port's models that surface:

    model = ShapeNetAPI(residual=True, cubify_threshold=0.2)
    losses = model(images, targets)        # train mode: the loss dict, no update
    metrics = model.step(images, targets)  # one optimizer update (backward + step)
    model.eval()
    preds = model(images)                  # {'backbone', 'voxels', 'vertex_positions',
                                           #  'faces', 'edge_index', 'vertice_index',
                                           #  'face_index', 'mesh_index'}

Both run on the card unless ``device="cpu"`` is given; without a card they
raise. Inputs may be numpy arrays or tensors; ``targets`` is a batch with the
``Batch`` fields (``parallel/train_step.Batch`` of tensors, or any object of
numpy arrays with those attributes). In train mode the model reads the images
of ``targets``, as the JAX API does.

The models compute their backbones in bfloat16, the JAX models' default
compute dtype, which the JAX APIs build with; ``Pix3DAPI`` takes another
through ``backbone_dtype`` among its model keywords. Everything after the
backbone is float32.

Randomness (the point clouds the losses sample, and the Mask R-CNN samplers)
comes from ``uniform``, a ``Uniform`` source, by default one of a
``torch.Generator`` on the device seeded from ``seed``; the weights are
initialised from ``seed`` too. The train-mode call draws from it like
``step()``, so the two give the same losses on the same state and draws.

The train-mode call only evaluates the losses: it leaves every parameter and
buffer as it found it (BatchNorm's running statistics, which a train-mode
forward updates in place, are put back) and returns detached values.

Ragged outputs follow the reference's convention, built on the host by
``to_ragged``: ``vertex_positions`` is a list of per-stage [sum V, 3] arrays,
``vertice_index`` / ``face_index`` are per-sample counts, ``faces`` are
per-sample local indices and ``edge_index`` is a 2 x 2E array of global
indices, both directions. ``backbone`` and ``voxels`` stay tensors on the
device; the ragged parts and Pix3D's per-image detection dicts are numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from meshrcnn_tpu_torch.core.config import (CapacityConfig, LossWeights, Pix3DConfig,
                                            ShapeNetConfig, TrainConfig)
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.ops.sampling import Uniform, uniform_from
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_eval_step, make_train_step,
                                                    pix3d_loss_fn, shapenet_loss_fn)
from meshrcnn_tpu_torch.utils.checkpoint import load_state
from meshrcnn_tpu_torch.utils.cli import device_of

# the JAX models' default compute dtype of the backbone
BACKBONE_DTYPE = "bfloat16"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_ragged(stage_verts, mesh, mesh_valid=None):
    """Padded stage outputs -> the reference's ragged-concat convention:
    (stages, faces, edge_index, vertice_index, face_index) over the samples
    ``mesh_valid`` keeps (all without it)."""
    vmask = _np(mesh.verts_mask)
    fmask = _np(mesh.faces_mask)
    emask = _np(mesh.edges_mask)
    faces = _np(mesh.faces)
    edges = _np(mesh.edges)
    B = vmask.shape[0]
    keep = range(B) if mesh_valid is None else [b for b in range(B)
                                                if bool(_np(mesh_valid)[b])]
    vertice_index = [int(vmask[b].sum()) for b in keep]
    face_index = [int(fmask[b].sum()) for b in keep]
    offsets = np.cumsum([0] + vertice_index[:-1])

    stages = []
    for verts in stage_verts:
        v = _np(verts)
        stages.append(np.concatenate([v[b][vmask[b]] for b in keep], axis=0))
    cat_faces = np.concatenate([faces[b][fmask[b]] for b in keep], axis=0)
    cat_edges = np.concatenate(
        [edges[b][emask[b]] + off for b, off in zip(keep, offsets)], axis=0)
    edge_index = np.concatenate([cat_edges.T, cat_edges.T[::-1]], axis=1)
    return stages, cat_faces, edge_index, vertice_index, face_index


class _BaseAPI:
    """What both APIs share: the mode, the lazily made train state, ``step``
    and ``load``. A subclass sets ``model``, ``config``, ``settings`` (the
    model config a checkpoint of ``utils/checkpoint.save_state`` records) and
    ``_loss_fn``."""

    model: torch.nn.Module
    config: TrainConfig
    settings: dict

    def __init__(self, device: str, seed: int, uniform: Optional[Uniform]):
        self.device = device_of(device)
        self._seed = seed
        self.uniform = uniform or uniform_from(
            torch.Generator(device=self.device).manual_seed(seed))
        self.state = None
        self._training = True
        self._train_step = None

    def _build(self, make_model):
        """``make_model()`` initialised from the API's seed without touching
        torch's global generator, on the device."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self._seed)
            return make_model().to(self.device)

    def train(self):
        self._training = True
        return self

    def eval(self):
        self._training = False
        return self

    @property
    def training(self) -> bool:
        return self._training

    def _ensure_state(self):
        """The train state of ``model`` (the optimizer of ``config``), made on first use."""
        if self.state is None:
            self.state = create_train_state(self.model, self.config)
        return self.state

    def _images(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device, torch.float32)
        return torch.from_numpy(np.array(images, dtype=np.float32)).to(self.device)

    def _batch(self, targets) -> Batch:
        if isinstance(targets, Batch):
            return Batch(**{f.name: None if getattr(targets, f.name) is None
                            else getattr(targets, f.name).to(self.device)
                            for f in dataclasses.fields(Batch)})
        return Batch.from_host(targets, self.device)

    def load(self, path: str):
        """Restore a checkpoint of ``utils/checkpoint.save_state`` (the train
        CLI's) into the API's state: usable before any forward."""
        load_state(path, self._ensure_state(), self.settings)
        return self

    def step(self, images, targets) -> dict:
        """One optimizer update of the state (``make_train_step``): forward in
        train mode, loss, backward, optimizer. The counterpart of the
        reference's ``losses = model(...); loss.backward(); optimizer.step()``
        (reference: utils/train_utils.py:174-250). Returns the step's metrics
        (the losses and ``grads_finite``); ``state.step`` advances by one."""
        if not self._training:
            raise RuntimeError("step() requires training mode; call .train()")
        if targets is None:
            raise ValueError("In training mode, targets should be passed")
        state = self._ensure_state()
        if self._train_step is None:
            self._train_step = make_train_step(self.config, lambda shape: self.uniform(shape))
        return self._train_step(state, self._batch(targets))

    def _train_losses(self, targets) -> dict:
        """The train-mode loss dict without ``loss``; parameters and buffers unchanged."""
        if targets is None:
            raise ValueError("In training mode, targets should be passed")
        self._ensure_state()
        model = self.model
        model.train()
        saved = [(b, b.clone()) for b in model.buffers()]
        try:
            _, metrics = self._loss_fn(model, self.config, self._batch(targets), self.uniform)
        finally:
            with torch.no_grad():
                for buf, value in saved:
                    buf.copy_(value)
        return {k: v for k, v in metrics.items() if k != "loss"}

    def _ragged(self, out, result: dict, mesh_valid=None, mesh_index=None) -> dict:
        stages, faces, edge_index, v_index, f_index = to_ragged(out.stage_verts, out.mesh,
                                                                mesh_valid)
        result.update(vertex_positions=stages, faces=faces, edge_index=edge_index,
                      vertice_index=v_index, face_index=f_index, mesh_index=mesh_index)
        return result


class ShapeNetAPI(_BaseAPI):
    """Stateful reference-style wrapper around ShapeNetModel (shapenet_model.py:17-101)."""

    def __init__(self, residual: bool = False, cubify_threshold: float = 0.2,
                 vertex_feature_dim: int = 128, num_refinement_stages: int = 3,
                 voxel_only: bool = False, num_classes: int = 13,
                 voxel_out_channels: int = 48,
                 vert_capacity: int = 8192, face_capacity: int = 16384,
                 edge_capacity: int = 32768, config: Optional[TrainConfig] = None,
                 seed: int = 0, model_config: Optional[ShapeNetConfig] = None,
                 device: str = "cuda", uniform: Optional[Uniform] = None):
        super().__init__(device, seed, uniform)
        cfg = model_config or ShapeNetConfig(
            num_classes=num_classes, residual=residual,
            cubify_threshold=cubify_threshold,
            vertex_feature_dim=vertex_feature_dim,
            num_refinement_stages=num_refinement_stages, voxel_only=voxel_only,
            num_voxels=voxel_out_channels,
            capacities=CapacityConfig(verts=vert_capacity, faces=face_capacity,
                                      edges=edge_capacity))
        self.model_config = cfg
        self.settings = {
            "model": "ShapeNet", "num_classes": cfg.num_classes,
            "cubify_threshold": cfg.cubify_threshold,
            "vertex_feature_dim": cfg.vertex_feature_dim,
            "num_refinement_stages": cfg.num_refinement_stages,
            "voxel_only": cfg.voxel_only, "vert_capacity": cfg.capacities.verts,
            "face_capacity": cfg.capacities.faces, "edge_capacity": cfg.capacities.edges,
            "backbone_dtype": BACKBONE_DTYPE, "residual": cfg.residual,
            "voxel_out_channels": cfg.num_voxels}
        self.model = self._build(lambda: ShapeNetModel(
            **{k: v for k, v in self.settings.items() if k != "model"}))
        self.config = config or TrainConfig(loss_weights=LossWeights())
        self._loss_fn = shapenet_loss_fn

    def __call__(self, images, targets=None) -> dict:
        if self._training:
            return self._train_losses(targets)
        out = make_eval_step(self.model)(self._images(images))
        result = {"backbone": torch.softmax(out.logits, dim=-1), "voxels": out.voxels}
        if self.model.voxel_only:
            return result
        return self._ragged(out, result, mesh_index=[1] * out.voxels.shape[0])


class Pix3DAPI(_BaseAPI):
    """Stateful reference-style wrapper around Pix3DModel (pix3d_model.py:21-117).
    ``model_kwargs`` go to the model (RPN and RoI sizes, ``backbone_dtype``,
    ``mesh_feature_norm``)."""

    def __init__(self, cubify_threshold: float = 0.2, vertex_feature_dim: int = 128,
                 num_refinement_stages: int = 3, voxel_only: bool = False,
                 num_classes: int = 10, detections_per_img: int = 3,
                 vert_capacity: int = 4096, face_capacity: int = 8192,
                 edge_capacity: int = 16384, config: Optional[TrainConfig] = None,
                 seed: int = 0, model_config: Optional[Pix3DConfig] = None,
                 device: str = "cuda", uniform: Optional[Uniform] = None,
                 **model_kwargs):
        super().__init__(device, seed, uniform)
        cfg = model_config or Pix3DConfig(
            num_classes=num_classes, cubify_threshold=cubify_threshold,
            vertex_feature_dim=vertex_feature_dim,
            num_refinement_stages=num_refinement_stages, voxel_only=voxel_only,
            detections_per_img=detections_per_img,
            capacities=CapacityConfig(verts=vert_capacity, faces=face_capacity,
                                      edges=edge_capacity))
        self.model_config = cfg
        model_kwargs.setdefault("backbone_dtype", BACKBONE_DTYPE)
        self.settings = {
            "model": "Pix3D", "num_classes": cfg.num_classes,
            "cubify_threshold": cfg.cubify_threshold,
            "vertex_feature_dim": cfg.vertex_feature_dim,
            "num_refinement_stages": cfg.num_refinement_stages,
            "voxel_only": cfg.voxel_only, "detections_per_img": cfg.detections_per_img,
            "vert_capacity": cfg.capacities.verts, "face_capacity": cfg.capacities.faces,
            "edge_capacity": cfg.capacities.edges, **model_kwargs}
        self.model = self._build(lambda: Pix3DModel.from_config(cfg, **model_kwargs))
        self.config = config or TrainConfig(pix3d_schedule=True, optimizer="sgd",
                                            train_backbone=True)
        self._loss_fn = pix3d_loss_fn

    def __call__(self, images, targets=None) -> dict:
        if self._training:
            return self._train_losses(targets)
        out = make_eval_step(self.model)(self._images(images))
        det = out.detections
        fields = {k: _np(v) for k, v in (("boxes", det.boxes), ("labels", det.labels),
                                         ("scores", det.scores), ("valid", det.valid),
                                         ("masks", out.mask_probs))}
        backbone = [{k: v[b] for k, v in fields.items()} for b in range(det.valid.shape[0])]
        result = {"backbone": backbone, "voxels": out.voxels}
        if self.model.voxel_only:
            return result
        mesh_index = fields["valid"].sum(axis=1).astype(int).tolist()
        return self._ragged(out, result, out.mesh_valid, mesh_index)
