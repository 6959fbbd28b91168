"""Single-image inference and artifact export on a CUDA card (counterpart of
the JAX package's demo.py; reference: demo.py:18-103).

    python -m meshrcnn_tpu_torch.demo --model ShapeNet --imagePath img.png --savePath out/
    python -m meshrcnn_tpu_torch.demo --model Pix3D --imagePath img.png --device cpu ...

Runs the eval forward on one image and saves, for each object i (each image
for ShapeNet, each valid detection slot for Pix3D):
  <name>_voxel_obj{i}.npy                      the binarised occupancy grid
  <name>_mesh_stage{s}_obj_{i}.obj, s in 0..3  the mesh of each refinement stage
the reference's artifact layout. The models compute their backbones in
bfloat16, the JAX models' default. ``--modelPath`` takes a checkpoint of
``meshrcnn_tpu_torch.train``: ``load_state``, else the matching entries
through ``load_state_partial`` (another optimizer, a voxel-only checkpoint),
and it stops when nothing loads. Runs on the card unless ``--device cpu``;
without a card it raises.

``main`` decodes the image (``data/image_io``: PNG or JPEG, no Pillow; Pix3D images
resized to ``--img_size`` by Pillow's bilinear filter) and hands the [1, H,
W, 3] array to ``run``, which builds the model, runs it and writes the files.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

parser = argparse.ArgumentParser("model inference script")
parser.add_argument("--model", "-m", choices=["ShapeNet", "Pix3D"], required=True)
parser.add_argument("--featDim", type=int, default=128)
parser.add_argument("--modelPath", type=str, default="",
                    help="path to the trained checkpoint")
parser.add_argument("--num_refinement_stages", "-nr", type=int, default=3)
parser.add_argument("--threshold", "-th", type=float, default=0.5)
parser.add_argument("--residual", default=False, action="store_true")
parser.add_argument("--imagePath", type=str, required=True)
parser.add_argument("--savePath", type=str, default="eval/")
parser.add_argument("--show", default=False, action="store_true",
                    help="display the predicted voxels and meshes")
parser.add_argument("--vert_capacity", type=int, default=8192)
parser.add_argument("--face_capacity", type=int, default=16384)
parser.add_argument("--edge_capacity", type=int, default=32768)
parser.add_argument("--img_size", type=int, default=224, help="Pix3D input size")
parser.add_argument("--mesh_feature_norm", default=False, action="store_true",
                    help="param-free RMS norm of the RoI features feeding the mesh "
                         "branch (must match between train and eval)")
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")

# the JAX models' default compute dtype of the backbone
BACKBONE_DTYPE = "bfloat16"


def decode_image(path: str, is_pix3d: bool, img_size: int) -> np.ndarray:
    """The image file as a [1, H, W, 3] float32 array in [0, 1]; Pix3D images
    are resized to ``img_size`` x ``img_size`` (bilinear)."""
    from meshrcnn_tpu_torch.data import image_io

    img = image_io.to_rgb(path)
    if is_pix3d:
        img = image_io.resize_bilinear(img, (img_size, img_size))
    arr = img.astype(np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr[None]


def _settings(options) -> dict:
    """The model config of the flags, as a checkpoint records it."""
    settings = {"model": options.model, "num_classes": 10 if options.model == "Pix3D" else 13,
                "cubify_threshold": options.threshold, "vertex_feature_dim": options.featDim,
                "num_refinement_stages": options.num_refinement_stages, "voxel_only": False,
                "vert_capacity": options.vert_capacity,
                "face_capacity": options.face_capacity,
                "edge_capacity": options.edge_capacity, "backbone_dtype": BACKBONE_DTYPE}
    if options.model == "Pix3D":
        settings["mesh_feature_norm"] = options.mesh_feature_norm
    else:
        settings["residual"] = options.residual
    return settings


def run(options, images: np.ndarray) -> dict:
    """The eval forward of the flags' model on ``images`` [1, H, W, 3], its
    artifacts written under ``--savePath``. Returns the eval output and the
    paths written (``voxels``, ``meshes``)."""
    import torch

    from meshrcnn_tpu_torch.core.config import TrainConfig
    from meshrcnn_tpu_torch.data.serialization import save_mesh, save_voxels
    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
    from meshrcnn_tpu_torch.parallel.train_step import create_train_state, make_eval_step
    from meshrcnn_tpu_torch.utils.checkpoint import load_state, load_state_partial
    from meshrcnn_tpu_torch.utils.cli import device_of

    device = device_of(options.device)
    settings = _settings(options)
    kwargs = {k: v for k, v in settings.items() if k not in ("model", "voxel_only")}
    torch.manual_seed(0)
    cls = Pix3DModel if options.model == "Pix3D" else ShapeNetModel
    model = cls(**kwargs).to(device)
    if options.modelPath:
        state = create_train_state(model, TrainConfig())
        try:
            load_state(options.modelPath, state, settings)
            print(f"loaded checkpoint {options.modelPath}")
        except (ValueError, RuntimeError, KeyError):
            # another optimizer or a voxel-only checkpoint: inference needs
            # only the model's entries
            n_loaded, n_total = load_state_partial(options.modelPath, state, settings)
            print(f"partially loaded checkpoint {options.modelPath} "
                  f"({n_loaded}/{n_total} parameters)")
            if n_loaded == 0:
                raise SystemExit(f"error: no parameters could be loaded from "
                                 f"{options.modelPath}: wrong or corrupt checkpoint?")
            if n_loaded < n_total:
                print("warning: some parameters are missing from the checkpoint "
                      "(a voxel-only checkpoint into a full model?)")

    out = make_eval_step(model)(torch.from_numpy(np.array(images, np.float32)).to(device))

    os.makedirs(options.savePath, exist_ok=True)
    name = os.path.join(options.savePath,
                        os.path.splitext(os.path.basename(options.imagePath))[0])
    voxels = out.voxels.cpu().numpy()
    # Pix3D: one object a valid detection slot; ShapeNet: one an image
    obj_valid = (out.mesh_valid.cpu().numpy() if hasattr(out, "mesh_valid")
                 else np.ones((voxels.shape[0],), bool))
    written = {"voxels": [], "meshes": []}
    for i in range(voxels.shape[0]):
        if obj_valid[i]:
            save_voxels(voxels[i], f"{name}_voxel_obj{i}", threshold=options.threshold)
            written["voxels"].append(f"{name}_voxel_obj{i}.npy")

    vmask = out.mesh.verts_mask.cpu().numpy()
    fmask = out.mesh.faces_mask.cpu().numpy()
    faces = out.mesh.faces.cpu().numpy()
    for s, verts in enumerate(out.stage_verts):
        v = verts.cpu().numpy()
        for i in range(v.shape[0]):
            if obj_valid[i]:
                save_mesh(v[i][vmask[i]], faces[i][fmask[i]], f"{name}_mesh_stage{s}_obj_{i}")
                written["meshes"].append(f"{name}_mesh_stage{s}_obj_{i}.obj")
    print(f"saved artifacts under {options.savePath}")

    if options.show:
        from meshrcnn_tpu_torch.utils.show import show_mesh, show_voxels
        show_voxels(voxels[0], threshold=options.threshold)
        show_mesh(out.stage_verts[-1][0].cpu().numpy(), faces[0], vmask[0], fmask[0])
    return dict(written, out=out)


def main(argv=None) -> dict:
    options = parser.parse_args(argv)
    from meshrcnn_tpu_torch.utils.cli import device_of
    device_of(options.device)           # no card and no --device cpu: raise before decoding
    images = decode_image(options.imagePath, options.model == "Pix3D", options.img_size)
    return run(options, images)


if __name__ == "__main__":
    main()
