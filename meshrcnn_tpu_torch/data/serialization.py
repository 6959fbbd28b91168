"""Mesh and voxel file IO: OBJ read and write, binvox RLE, npy and .mat voxels
(counterpart of meshrcnn_tpu/data/serialization.py; reference: utils/serialization.py).

The same formats and conventions: OBJ faces are written 1-based
(serialization.py:35-37) and read back 0-based, polygons strip-triangulated
(117-121, 129-132); a binvox payload is (value, count) run pairs, expanded by
``np.repeat``, reshaped to its dims and transposed xzy -> xyz (44-92). The
decoders are numpy only.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

Mesh = namedtuple("Mesh", ["vertices", "faces"])


def save_voxels(voxels, filename: str, threshold: float = 0.5) -> None:
    """Binarise and save an occupancy grid as .npy int32 (reference: 13-18)."""
    voxels = np.asarray(voxels)
    np.save(filename, (voxels > threshold).astype(np.int32))


def save_mesh(vertices, faces, filename: str) -> None:
    """Write an OBJ file with 1-based face indices (reference: 21-41)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    if faces.size and faces.min() == 0:
        faces = faces + 1
    if not filename.endswith(".obj"):
        filename = filename + ".obj"
    with open(filename, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def load_mesh(filename: str) -> Mesh:
    """Parse an OBJ file; polygons are strip-triangulated (reference: 109-138)."""
    filename = filename.replace(".binvox", ".obj")
    vertices = []
    triangles = []
    with open(filename) as file:
        for line in file:
            parts = line.strip(" \n").split(" ")
            if parts[0] == "f":
                idx = [int(c.split("/")[0]) for c in parts[1:] if c]
                for i in range(len(idx) - 2):
                    triangles.append(idx[i:i + 3])
            elif parts[0] == "v":
                # runs of spaces give empty tokens ("v  1.9 0.1 0.5")
                vertices.append([float(c) for c in parts[1:] if c][:3])
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64)
    if triangles.size and triangles.min() == 1:
        triangles = triangles - 1
    if triangles.size and triangles.min() != 0:
        raise ValueError(f"{filename}: face indices start at {triangles.min()}, not 0 or 1")
    return Mesh(vertices, triangles)


def _read_binvox_header(fp):
    fp.readline()  # '#binvox 1'
    dims = list(map(int, fp.readline().strip().split(b" ")[1:]))
    translate = list(map(float, fp.readline().strip().split(b" ")[1:]))
    scale = list(map(float, fp.readline().strip().split(b" ")[1:]))[0]
    fp.readline()  # 'data'
    return dims, translate, scale


def read_binvox(fp, fix_coords: bool = True) -> np.ndarray:
    """Decode the binvox RLE payload into a dims^3 int grid (reference: 57-92)."""
    dims, _, _ = _read_binvox_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2]
    data = np.repeat(values, counts).astype(bool).reshape(dims)
    if fix_coords:
        data = np.transpose(data, (0, 2, 1))  # xzy -> xyz
    return 1 * data


def load_voxels(path: str) -> np.ndarray:
    """Load .npy / .mat (scipy, Pix3D) / .binvox occupancy grids (reference: 95-106)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".mat"):
        import scipy.io
        return scipy.io.loadmat(path)["voxel"]
    if not path.endswith(".binvox"):
        raise ValueError(f"unknown voxel format: {path}")
    with open(path, "rb") as f:
        return read_binvox(f)


def write_binvox(voxels: np.ndarray, path: str) -> None:
    """RLE-encode a boolean grid to binvox (the inverse of ``read_binvox``):
    runs of at most 255 equal values in xzy raster order."""
    v = np.asarray(voxels).astype(bool)
    dims = v.shape
    flat = np.transpose(v, (0, 2, 1)).reshape(-1).astype(np.uint8)
    starts = np.flatnonzero(np.r_[True, flat[1:] != flat[:-1]])
    lengths = np.diff(np.r_[starts, flat.size])
    out = bytearray(b"#binvox 1\n")
    out += f"dim {dims[0]} {dims[1]} {dims[2]}\n".encode()
    out += b"translate 0 0 0\nscale 1\ndata\n"
    payload = []      # a run longer than 255 splits into runs of 255 and the rest
    for value, length in zip(flat[starts], lengths):
        payload += [value, 255] * (length // 255)
        if length % 255:
            payload += [value, length % 255]
    out += bytes(np.asarray(payload, dtype=np.uint8))
    with open(path, "wb") as f:
        f.write(bytes(out))
