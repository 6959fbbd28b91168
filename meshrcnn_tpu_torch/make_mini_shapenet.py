"""Generate a reproducible mini-ShapeNet in the real on-disk layout
(counterpart of the JAX package's tools/make_mini_shapenet.py).

    python -m meshrcnn_tpu_torch.make_mini_shapenet --root dataset --num_models 60 --views 2
    python -m meshrcnn_tpu_torch.download_dataset --render_meshes --build_manifest --root dataset

writes

  <root>/ShapeNetVox32/<synset>/<model_id>/model.binvox   (32^3 RLE grids)
  <root>/ShapeNetRendering/<synset>/<model_id>/rendering/NN.png (137x137 RGB)

the layout of the ShapeNetRendering / ShapeNetVox32 archives (reference:
download_dataset.py:28-75), so that ``download_dataset``, ``shapeNet_Dataset``
and the train and eval CLIs run on files. Each shape is a union of 2-4 random
solid ellipsoids and boxes on the 32^3 lattice; each rendering is a
depth-shaded orthographic projection of that grid along a per-view axis, so
an image determines its shape. The same flags and seed draw the same
``RandomState`` numbers as the JAX tool: the binvox files are equal byte for
byte and the PNGs decode to the same pixels (renders are resized by
``image_io.resize_bilinear``, Pillow's bilinear filter, and written by
``image_io.write_png``). No Pillow.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from meshrcnn_tpu_torch.data.image_io import resize_bilinear, write_png
from meshrcnn_tpu_torch.data.serialization import write_binvox

parser = argparse.ArgumentParser("mini-ShapeNet generator")
parser.add_argument("--root", type=str, required=True)
parser.add_argument("--num_models", type=int, default=128)
parser.add_argument("--views", type=int, default=2)
parser.add_argument("--synset", type=str, default="02691156",
                    help="synset id the models are filed under (default: airplane)")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--img_size", type=int, default=137)


def make_grid(rng: np.random.RandomState, V: int = 32) -> np.ndarray:
    """Union of 2-4 random solid ellipsoids or boxes, clipped to the lattice."""
    g = np.zeros((V, V, V), dtype=bool)
    idx = np.stack(np.meshgrid(*[np.arange(V)] * 3, indexing="ij"), -1)
    for _ in range(rng.randint(2, 5)):
        c = rng.uniform(V * 0.3, V * 0.7, size=3)
        r = rng.uniform(V * 0.08, V * 0.28, size=3)
        if rng.rand() < 0.5:
            g |= (((idx - c) / r) ** 2).sum(-1) <= 1.0          # ellipsoid
        else:
            g |= (np.abs(idx - c) <= r).all(-1)                 # box
    if not g.any():                                             # never empty
        g[V // 2 - 2:V // 2 + 2, V // 2 - 2:V // 2 + 2, V // 2 - 2:V // 2 + 2] = True
    return g


def render_view(grid: np.ndarray, view: int, img_size: int) -> np.ndarray:
    """Depth-shaded orthographic projection along a per-view axis, as uint8
    RGB [img_size, img_size, 3]: nearer voxels brighter in red, the column's
    mass in green, the silhouette in blue."""
    perms = [(0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (1, 0, 2), (2, 1, 0)]
    g = np.transpose(grid, perms[view % len(perms)])
    if view % 2 == 1:
        g = g[::-1]
    V = g.shape[0]
    depth_idx = np.argmax(g, axis=0)                 # first occupied voxel
    hit = g.any(axis=0)
    shade = np.where(hit, 1.0 - depth_idx / V, 0.0)
    thickness = g.sum(axis=0) / V
    img = np.stack([shade, thickness, hit.astype(np.float32)], -1)
    return resize_bilinear((img * 255).astype(np.uint8), (img_size, img_size))


def main(argv=None) -> str:
    """Write the dataset of the flags in ``argv``; returns its root."""
    opt = parser.parse_args(argv)
    rng = np.random.RandomState(opt.seed)
    vox_root = os.path.join(opt.root, "ShapeNetVox32", opt.synset)
    render_root = os.path.join(opt.root, "ShapeNetRendering", opt.synset)
    for m in range(opt.num_models):
        mid = f"model{m:04d}"
        grid = make_grid(rng)
        vdir = os.path.join(vox_root, mid)
        os.makedirs(vdir, exist_ok=True)
        write_binvox(grid, os.path.join(vdir, "model.binvox"))
        rdir = os.path.join(render_root, mid, "rendering")
        os.makedirs(rdir, exist_ok=True)
        for v in range(opt.views):
            write_png(os.path.join(rdir, f"{v:02d}.png"), render_view(grid, v, opt.img_size))
    print(f"wrote {opt.num_models} models x {opt.views} views under {opt.root}")
    return opt.root


if __name__ == "__main__":
    main()
