"""matplotlib 3D views of meshes, voxel grids and point clouds (counterpart of
meshrcnn_tpu/utils/show.py; reference: utils/show.py:23-84).

numpy in, a matplotlib figure out, with the reference's conveniences: a str
path is read from disk (``data/serialization``), a mesh outside the unit ball
is normalised (``data/process.normalize_mesh``), an ``alpha``-degree rotation
about x is applied before drawing, and the point-cloud view samples the mesh
surface. Padded buffers with their masks are taken as they are. Tensors are
read through ``np.asarray``, so pass CPU ones. matplotlib is imported only
inside the functions.
"""
from __future__ import annotations

import numpy as np

from meshrcnn_tpu_torch.utils.rotation import rotation


def _unpad(arr, mask):
    arr = np.asarray(arr)
    if mask is None:
        return arr
    return arr[np.asarray(mask).astype(bool)]


def _as_mesh(mesh_or_verts, faces=None):
    """(verts, faces) from an OBJ path, a Mesh / (verts, faces) pair, or two arrays."""
    if isinstance(mesh_or_verts, str):
        from meshrcnn_tpu_torch.data.serialization import load_mesh
        m = load_mesh(mesh_or_verts)
        return np.asarray(m.vertices), np.asarray(m.faces)
    if faces is None:
        v, f = mesh_or_verts
        return np.asarray(v), np.asarray(f)
    return np.asarray(mesh_or_verts), np.asarray(faces)


def show_mesh(vertices, faces=None, verts_mask=None, faces_mask=None,
              alpha: float = 0.0, show: bool = True):
    """A triangle mesh by ``plot_trisurf`` (reference: show.py:23-46).

    ``vertices`` is an OBJ path, a Mesh / (verts, faces) pair, or a padded
    verts array with ``faces`` (and optional masks). 1-based faces are made
    0-based; the axes span [-1, 1] in the reference's (x, -z, y) order."""
    import matplotlib.pyplot as plt

    v, f = _as_mesh(vertices, faces)
    v = _unpad(v, verts_mask)
    f = _unpad(f, faces_mask).astype(np.int64)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    if len(v) and len(f):
        if np.abs(v).max() > 1:
            from meshrcnn_tpu_torch.data.process import normalize_mesh
            v = np.asarray(normalize_mesh(v))
        if f.min() == 1:
            f = f - 1
        v = v @ rotation(alpha)
        ax.set_xlim([-1, 1]); ax.set_ylim([-1, 1]); ax.set_zlim([-1, 1])
        ax.plot_trisurf(v[:, 0], -v[:, 2], f, v[:, 1], shade=True, color="grey")
    if show:
        plt.show()
    return fig


def show_voxels(voxels, threshold: float = 0.5, show: bool = True):
    """An occupancy grid, or the path of one (reference: show.py:49-62)."""
    import matplotlib.pyplot as plt

    if isinstance(voxels, str):
        from meshrcnn_tpu_torch.data.serialization import load_voxels
        voxels = load_voxels(voxels)
    grid = np.asarray(voxels) > threshold
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.voxels(grid, facecolors="grey", edgecolor="k")
    if show:
        plt.show()
    return fig


def show_mesh_pointCloud(mesh, faces=None, alpha: float = -90.0,
                         num_points: int = 5000, show: bool = True,
                         verts_mask=None, faces_mask=None):
    """A scatter of points sampled from the mesh surface (reference:
    show.py:65-84). Takes what ``show_mesh`` takes, or an [N, 3] point array,
    which is rotated and drawn as it is."""
    import matplotlib.pyplot as plt

    arr = np.asarray(mesh) if not isinstance(mesh, (str, tuple)) else None
    if arr is not None and faces is None and arr.ndim == 2 and arr.shape[1] == 3 \
            and verts_mask is None:
        points = arr
    else:
        v, f = _as_mesh(mesh, faces)
        v = _unpad(v, verts_mask)
        f = _unpad(f, faces_mask).astype(np.int64)
        points = _sample_surface(v, f, num_points)
    points = points @ rotation(alpha)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1)
    if show:
        plt.show()
    return fig


def _sample_surface(verts: np.ndarray, faces: np.ndarray, n: int) -> np.ndarray:
    """Area-weighted surface samples in numpy, seed 0, for viewing only (the
    differentiable sampler is ``ops/sampling.py``)."""
    if len(faces) == 0 or len(verts) == 0:
        return np.zeros((0, 3), np.float32)
    a, b, c = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    rng = np.random.RandomState(0)
    idx = rng.choice(len(faces), size=n, p=p)
    u, w = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + w) > 1
    u, w = np.where(flip, 1 - u, u), np.where(flip, 1 - w, w)
    return (a[idx] + u * (b[idx] - a[idx]) + w * (c[idx] - a[idx])).astype(np.float32)
