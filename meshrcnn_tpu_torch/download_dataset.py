"""Dataset download and preparation (counterpart of the JAX package's
download_dataset.py; reference: download_dataset.py).

    python -m meshrcnn_tpu_torch.download_dataset --render_meshes --build_manifest --root dataset

  * ``--download_pix3d`` / ``--download_shapenet``: fetch pix3d.zip,
    ShapeNetRendering.tgz and ShapeNetVox32.tgz (reference: 28-75);
  * ``--render_meshes``: the ShapeNet ground-truth meshes are cubify(0.5) of
    the 32^3 binvox grids, in batches of ``--batch`` through the port's
    batched ``ops/cubify.cubify`` on the card (``--device cpu`` for the CPU;
    without a card it raises), normalised and saved as OBJ beside each grid
    (reference: 84-116);
  * ``--build_manifest``: ``<root>/shapenet.json``, one record {img,
    category, voxel, model} a rendering, with the synset-to-class map
    (reference: 119-174).
"""
from __future__ import annotations

import argparse
import json
import os
import urllib.request

import numpy as np

# synset id -> class name (reference: download_dataset.py:119-147)
SYNSET_TO_CLASS = {
    "02691156": "airplane", "02828884": "bench", "02933112": "closet",
    "02958343": "car", "03001627": "chair", "03211117": "tv",
    "03636649": "lamp", "03691459": "stereo", "03797390": "gun",
    "04256520": "sofa", "04379243": "table", "04401088": "phone",
    "04530566": "ship",
}

URLS = {
    "pix3d": "http://pix3d.csail.mit.edu/data/pix3d.zip",
    "shapenet_rendering": "http://ftp.cs.stanford.edu/cs/cvgl/ShapeNetRendering.tgz",
    "shapenet_vox32": "http://ftp.cs.stanford.edu/cs/cvgl/ShapeNetVox32.tgz",
}

parser = argparse.ArgumentParser("dataset download and preparation")
parser.add_argument("--download_pix3d", action="store_true")
parser.add_argument("--download_shapenet", action="store_true")
parser.add_argument("--render_meshes", action="store_true",
                    help="generate GT meshes via cubify(0.5) from binvox grids")
parser.add_argument("--build_manifest", action="store_true")
parser.add_argument("--root", type=str, default="dataset")
parser.add_argument("--batch", type=int, default=16,
                    help="cubify batch size for mesh rendering (reference used 16)")
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device of --render_meshes: 'cuda' (default) or 'cpu'")


def download(url: str, dest: str) -> None:
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    print(f"downloading {url} -> {dest}")
    urllib.request.urlretrieve(url, dest)


def render_shapenet_meshes(root: str, batch_size: int = 16, device="cuda") -> list:
    """Cubify the 32^3 binvox grids under ``root`` at threshold 0.5 into
    normalised OBJ ground-truth meshes beside them (reference:
    download_dataset.py:84-116); returns the OBJ paths written."""
    import torch

    from meshrcnn_tpu_torch.data.process import normalize_mesh
    from meshrcnn_tpu_torch.data.serialization import load_voxels, save_mesh
    from meshrcnn_tpu_torch.ops.cubify import cubify

    paths = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".binvox"):
                paths.append(os.path.join(dirpath, f))
    print(f"rendering {len(paths)} GT meshes via cubify(0.5)")
    written = []
    for i in range(0, len(paths), batch_size):
        chunk = paths[i:i + batch_size]
        grids = np.stack([np.asarray(load_voxels(p), dtype=np.float32) for p in chunk])
        mesh, _ = cubify(torch.from_numpy(grids).to(device), 0.5, vert_capacity=8192,
                         face_capacity=16384, edge_capacity=32768)
        vm = mesh.verts_mask.cpu().numpy()
        fm = mesh.faces_mask.cpu().numpy()
        verts = mesh.verts.cpu().numpy()
        faces = mesh.faces.cpu().numpy()
        for b, p in enumerate(chunk):
            v = normalize_mesh(verts[b][vm[b]])
            save_mesh(v, faces[b][fm[b]], p.replace(".binvox", ""))
            written.append(p.replace(".binvox", ".obj"))
    return written


def build_manifest(root: str) -> str:
    """Write ``<root>/shapenet.json``, the records {img, category, voxel, model}
    (reference: download_dataset.py:119-174); returns its path."""
    records = []
    render_root = os.path.join(root, "ShapeNetRendering")
    vox_root = os.path.join(root, "ShapeNetVox32")
    for synset, cls in SYNSET_TO_CLASS.items():
        sdir = os.path.join(render_root, synset)
        if not os.path.isdir(sdir):
            continue
        for model_id in sorted(os.listdir(sdir)):
            png_dir = os.path.join(sdir, model_id, "rendering")
            vox = os.path.join(vox_root, synset, model_id, "model.binvox")
            obj = vox.replace(".binvox", ".obj")
            if not (os.path.isdir(png_dir) and os.path.isfile(vox)):
                continue
            for png in sorted(os.listdir(png_dir)):
                if png.endswith(".png"):
                    records.append({"img": os.path.join(png_dir, png),
                                    "category": cls, "voxel": vox, "model": obj})
    out = os.path.join(root, "shapenet.json")
    with open(out, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {out}")
    return out


def main(argv=None) -> None:
    options = parser.parse_args(argv)
    if options.download_pix3d:
        download(URLS["pix3d"], os.path.join(options.root, "pix3d.zip"))
    if options.download_shapenet:
        download(URLS["shapenet_rendering"],
                 os.path.join(options.root, "ShapeNetRendering.tgz"))
        download(URLS["shapenet_vox32"],
                 os.path.join(options.root, "ShapeNetVox32.tgz"))
    if options.render_meshes:
        from meshrcnn_tpu_torch.utils.cli import device_of
        render_shapenet_meshes(options.root, options.batch, device_of(options.device))
    if options.build_manifest:
        build_manifest(options.root)


if __name__ == "__main__":
    main()
