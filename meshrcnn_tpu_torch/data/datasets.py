"""Datasets and the padded-batch data loader
(counterpart of meshrcnn_tpu/data/datasets.py; reference: data/dataloader.py).

``shapeNet_Dataset`` / ``pix3dDataset`` parse the same json manifests and
return numpy samples; ``collate`` pads ragged ground-truth meshes into
fixed-capacity buffers (``core.mesh.pad_mesh_np``); ``dataLoader`` reproduces
the reference's seed-42 shuffled train/test split exactly
(dataloader.py:297-330). ``SyntheticDataset`` gives deterministic data for
tests and benches without the 100GB+ downloads.

Everything here is host numpy. Image files are decoded and resized by
``data/image_io`` (PNG and JPEG, Pillow's filters, no Pillow), meshes and voxels by the
native decoder of ``data/serialization``.
"""
from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from meshrcnn_tpu_torch.core.batch import Batch
from meshrcnn_tpu_torch.core.config import CapacityConfig
from meshrcnn_tpu_torch.core.mesh import pad_mesh_np
from meshrcnn_tpu_torch.data import image_io
from meshrcnn_tpu_torch.data.process import normalize_mesh, resample_voxels
from meshrcnn_tpu_torch.data.serialization import Mesh, load_mesh, load_voxels

SHAPENET_CLASSES = {"airplane": 0, "bench": 1, "closet": 2, "car": 3, "chair": 4,
                    "tv": 5, "lamp": 6, "stereo": 7, "gun": 8, "sofa": 9,
                    "table": 10, "phone": 11, "ship": 12}  # dataloader.py:213-225

PIX3D_CLASSES = {"bed": 1, "bookcase": 2, "chair": 3, "desk": 4, "misc": 5,
                 "sofa": 6, "table": 7, "tool": 8, "wardrobe": 9}  # dataloader.py:81-89


@dataclass
class Sample:
    image: np.ndarray          # [H, W, 3] float32 in [0, 1]
    voxels: np.ndarray         # [V, V, V]
    mesh: Mesh
    label: int
    boxes: Optional[np.ndarray] = None   # [1, 4] (Pix3D)
    mask: Optional[np.ndarray] = None    # [H, W] (Pix3D)


def _load_image(path: str) -> np.ndarray:
    arr = image_io.to_rgb(path).astype(np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr


class shapeNet_Dataset:
    """ShapeNet rendered-image dataset (reference: dataloader.py:212-280)."""

    category_idx = SHAPENET_CLASSES

    def __init__(self, dataset_path: str, classes: Optional[Sequence[str]] = None):
        with open(os.path.join(dataset_path, "shapenet.json")) as f:
            manifest = json.load(f)
        self.records = [p for p in manifest
                        if classes is None or p["category"] in classes]

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Sample:
        p = self.records[idx]
        image = _load_image(p["img"])
        mesh = load_mesh(p["model"])
        voxels = load_voxels(p["voxel"])
        return Sample(image=image, voxels=np.asarray(voxels),
                      mesh=mesh, label=self.category_idx[p["category"]])


class pix3dDataset:
    """Pix3D dataset (reference: dataloader.py:80-150); 9 categories + background."""

    category_idx = PIX3D_CLASSES

    def __init__(self, dataset_path: str, classes: Optional[Sequence[str]] = None):
        with open(os.path.join(dataset_path, "pix3d.json")) as f:
            manifest = json.load(f)
        self.root = dataset_path
        keep = self._scan(manifest)
        self.records = [p for p in keep
                        if classes is None or p["category"] in classes]

    def _scan(self, manifest) -> list:
        """The images the reference keeps, cached beside the manifest.

        The reference (dataloader.py:111-116) decodes each image and keeps
        the 3-channel ones, skipping unreadable files; a different kept set
        would shift every index of the seed-42 split. The mode check reads
        the header (Pillow's mode name, ``image_io.image_mode``); the body of
        an "RGB" image is then decoded, so a missing, truncated or corrupt
        file, or one Pillow refuses (a 12-bit or hierarchical JPEG), is
        skipped (``DamagedImageError`` is an ``OSError``) as the JAX scan's
        ``Image.open`` / ``load`` skips it. A file ``image_io`` does not
        decode (GIF, BMP, TIFF, WebP) raises: dropping it would change the
        kept set without a word.

        Decoding ~10k images takes minutes, so the kept list is cached in
        ``.pix3d_scan_cache.json`` (the JAX package's file and format), keyed
        by the manifest's (mtime, size) and a digest of every image's (path,
        mtime, size). The class filter applies after the scan, so the cache
        does not depend on it. A read-only dataset directory caches under
        ``~/.cache/meshrcnn_tpu_torch/`` instead, keyed by its absolute path.
        """
        import hashlib
        manifest_path = os.path.join(self.root, "pix3d.json")
        st = os.stat(manifest_path)
        h = hashlib.sha256()
        for p in manifest:
            h.update(p["img"].encode())
            try:
                ist = os.stat(os.path.join(self.root, p["img"]))
                h.update(f"{ist.st_mtime},{ist.st_size};".encode())
            except OSError:
                h.update(b"missing;")
        cache_key = [st.st_mtime, st.st_size, h.hexdigest()]

        root_hash = hashlib.sha256(
            os.path.abspath(self.root).encode()).hexdigest()[:16]
        cache_paths = [
            os.path.join(self.root, ".pix3d_scan_cache.json"),
            os.path.join(os.path.expanduser("~"), ".cache", "meshrcnn_tpu_torch",
                         f"pix3d_scan_{root_hash}.json"),
        ]
        for cp in cache_paths:
            try:
                with open(cp) as f:
                    cache = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(cache, dict) and cache.get("key") == cache_key:
                ok = set(cache.get("kept_imgs", ()))
                return [p for p in manifest if p["img"] in ok]
        kept = []
        for p in manifest:
            path = os.path.join(self.root, p["img"])
            try:
                if image_io.image_mode(path) != "RGB":
                    continue
                image_io.read_image(path)
            except OSError:       # missing or damaged: dropped, as the reference drops it
                continue
            kept.append(p)
        payload = {"key": cache_key, "kept_imgs": [p["img"] for p in kept]}
        for cp in cache_paths:
            try:
                os.makedirs(os.path.dirname(cp), exist_ok=True)
                with open(cp, "w") as f:
                    json.dump(payload, f)
                break
            except OSError:
                continue  # read-only dataset dir: try the user cache next
        return kept

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Sample:
        p = self.records[idx]
        image = _load_image(os.path.join(self.root, p["img"]))
        voxels = load_voxels(os.path.join(self.root, p["voxel"]))
        mesh = load_mesh(os.path.join(self.root, p["model"]))
        mask = image_io.read_image(os.path.join(self.root, p["mask"]))[0].astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        boxes = np.asarray(p["bbox"], dtype=np.float32).reshape(1, 4)
        return Sample(image=image, voxels=np.asarray(voxels), mesh=mesh,
                      label=self.category_idx[p["category"]], boxes=boxes, mask=mask)


class SyntheticDataset:
    """Deterministic random dataset with cuboid meshes, for tests and benches.

    With ``pix3d=True`` each sample also carries a GT box and instance mask (a
    square painted into the image) and 1-based labels, the Pix3D targets.
    """

    # label-keyed object colours, fixed across samples, so every head has a
    # learnable signal
    _PALETTE = np.random.RandomState(20240819).rand(64, 3) * 0.7 + 0.3

    def __init__(self, n: int = 64, image_size: int = 137, num_voxels: int = 32,
                 num_classes: int = 13, seed: int = 0, pix3d: bool = False):
        self.n = n
        self.image_size = image_size
        self.num_voxels = num_voxels
        self.num_classes = num_classes
        self.seed = seed
        self.pix3d = pix3d

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Sample:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H = self.image_size
        V = self.num_voxels
        image = rng.rand(H, H, 3).astype(np.float32) * 0.3
        voxels = np.zeros((V, V, V), dtype=np.float32)
        a, b = sorted(rng.randint(2, V - 2, 2).tolist())
        b = max(b, a + 2)
        voxels[a:b, a:b, a:b] = 1.0
        # cuboid mesh matching the voxel block
        lo, hi = float(a) - 0.5, float(b) - 0.5
        verts = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                          for z in (lo, hi)], dtype=np.float32)
        verts = normalize_mesh(verts)
        faces = np.array([[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
                          [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
                          [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7]],
                         dtype=np.int64)
        if not self.pix3d:
            # label = cuboid size bucket; the cuboid's footprint is painted into
            # the image, its brightness encoding the extent
            label = min((b - a - 1) * self.num_classes // (V - 3),
                        self.num_classes - 1)
            s0, s1 = int(a * H / V), max(int(b * H / V), int(a * H / V) + 1)
            image[s0:s1, s0:s1] = (0.35 + 0.6 * (b - a) / V) * self._PALETTE[label]
            return Sample(image=image, voxels=voxels, mesh=Mesh(verts, faces),
                          label=int(label))
        # an object square whose colour is keyed by the class label; its box
        # and mask are the targets
        x1, y1 = rng.randint(4, H // 2, 2).tolist()
        w, h = rng.randint(H // 4, H // 2, 2).tolist()
        x2, y2 = min(x1 + w, H - 2), min(y1 + h, H - 2)
        label = int(rng.randint(1, max(self.num_classes, 2)))  # 1-based fg class
        shade = 0.75 + 0.25 * rng.rand()
        image[y1:y2, x1:x2] = shade * self._PALETTE[label].astype(np.float32)
        mask = np.zeros((H, H), dtype=np.float32)
        mask[y1:y2, x1:x2] = 1.0
        boxes = np.asarray([[x1, y1, x2, y2]], dtype=np.float32)
        return Sample(image=image, voxels=voxels, mesh=Mesh(verts, faces),
                      label=label, boxes=boxes, mask=mask)


def _resize_sample(s: Sample, size: int) -> Sample:
    """Letterbox the image (and box and mask) to size x size.

    The static stand-in for torchvision's GeneralizedRCNNTransform
    (reference: pix3d_model.py:143): scale by size / max(h, w), keeping the
    aspect ratio, then zero-pad bottom and right to the square. Boxes scale by
    the one factor and are clipped to [0, size] (torchvision's
    clip_boxes_to_image allows x2 == size); masks ride the same transform.
    The image is resized as uint8 by Pillow's bilinear filter and the mask by
    its nearest one (``image_io``). A sample already at the size returns as it is.
    """
    h, w = s.image.shape[:2]
    if h == size and w == size:
        return s
    scale = size / max(h, w)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    img = (np.clip(s.image, 0, 1) * 255).astype(np.uint8)
    resized = image_io.resize_bilinear(img, (nw, nh)).astype(np.float32) / 255.0
    image = np.zeros((size, size, 3), dtype=np.float32)
    image[:nh, :nw] = resized
    boxes = s.boxes
    if boxes is not None:
        boxes = np.clip(boxes * np.float32(scale), 0, size).astype(np.float32)
    mask = s.mask
    if mask is not None:
        m = (np.asarray(mask) > 0.5).astype(np.uint8) * 255
        mr = (image_io.resize_nearest(m, (nw, nh)) > 127).astype(np.float32)
        mask = np.zeros((size, size), dtype=np.float32)
        mask[:nh, :nw] = mr
    return Sample(image=image, voxels=s.voxels, mesh=s.mesh, label=s.label,
                  boxes=boxes, mask=mask)


def collate(samples: Sequence[Sample], num_voxels: int,
            capacities: CapacityConfig, image_size: Optional[int] = None) -> Batch:
    """Pad and stack samples into one fixed-shape ``Batch`` (reference:
    dataloader.py:200-209, 283-294): voxels resampled to num_voxels^3, ragged
    meshes padded to the (gt_verts, gt_faces) capacities with masks, images
    letterboxed to ``image_size`` when it is given (Pix3D)."""
    if image_size is not None:
        samples = [_resize_sample(s, image_size) for s in samples]
    images = np.stack([s.image for s in samples]).astype(np.float32)
    voxels = np.stack([np.asarray(s.voxels, dtype=np.float32) for s in samples])
    if voxels.shape[1:] != (num_voxels,) * 3:
        voxels = resample_voxels(voxels, num_voxels).astype(np.float32)
    padded = [pad_mesh_np(s.mesh.vertices, s.mesh.faces,
                          capacities.gt_verts, capacities.gt_faces) for s in samples]
    return Batch(
        images=images,
        voxels=voxels,
        gt_verts=np.stack([p["verts"] for p in padded]),
        gt_verts_mask=np.stack([p["verts_mask"] for p in padded]),
        gt_faces=np.stack([p["faces"] for p in padded]),
        gt_faces_mask=np.stack([p["faces_mask"] for p in padded]),
        labels=np.asarray([s.label for s in samples], dtype=np.int32),
        boxes=(np.stack([s.boxes for s in samples])
               if samples[0].boxes is not None else None),
        masks=(np.stack([s.mask for s in samples])
               if samples[0].mask is not None else None),
    )


class DataLoader:
    """Epoch iterator over padded batches (host-side, numpy).

    The reference's split (dataloader.py:297-330): the indices are shuffled
    once after ``np.random.seed(42)`` on numpy's global generator, which this
    constructor sets, as the reference and the JAX package do; the first
    ``num_train_samples`` are the train split, the rest the test split. Each
    epoch shuffles the split with ``RandomState(seed)``, created here, so the
    data order restarts with every process, as in the JAX package.
    """

    def __init__(self, dataset, batch_size: int, num_voxels: int,
                 capacities: CapacityConfig, test: bool = False,
                 num_train_samples: Optional[int] = None,
                 train_ratio: Optional[float] = None,
                 seed: int = 0, drop_last: bool = True,
                 image_size: Optional[int] = None, workers: int = 0):
        if train_ratio is not None and num_train_samples is not None:
            raise ValueError("at most one of train_ratio and num_train_samples can be set")
        indices = list(range(len(dataset)))
        np.random.seed(42)  # the reference's split seed (dataloader.py:303)
        np.random.shuffle(indices)
        if train_ratio is None and num_train_samples is None:
            train_ratio = 1.0
        if train_ratio is not None:
            if not 0 < train_ratio <= 1.0:
                raise ValueError(f"train_ratio {train_ratio} is not in (0, 1]")
            num_train_samples = int(np.floor(len(dataset) * train_ratio))
        # a test split may take every index (eval_model's default --test_ratio 1)
        if not (0 if test else 1) <= num_train_samples <= len(dataset):
            raise ValueError(f"{num_train_samples} train samples of a dataset of "
                             f"{len(dataset)}")
        self.indices = indices[num_train_samples:] if test else indices[:num_train_samples]
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_voxels = num_voxels
        self.capacities = capacities
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.image_size = image_size
        self.workers = workers

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)

    def _load(self, chunk: list[int]) -> Batch:
        return collate([self.dataset[j] for j in chunk],
                       self.num_voxels, self.capacities, self.image_size)

    def __iter__(self) -> Iterator[Batch]:
        order = list(self.indices)
        self.rng.shuffle(order)
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if chunks and len(chunks[-1]) < self.batch_size and self.drop_last:
            chunks = chunks[:-1]
        if self.workers <= 0:
            for chunk in chunks:
                yield self._load(chunk)
            return
        # Threaded prefetch: file reads, native decodes and numpy release the
        # interpreter lock, so up to ``workers`` upcoming batches collate while
        # the device runs the current step. The lookahead is bounded and the
        # order is kept.
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            pending = deque()
            it = iter(chunks)
            for chunk in it:
                pending.append(ex.submit(self._load, chunk))
                if len(pending) > self.workers:
                    break
            for chunk in it:
                yield pending.popleft().result()
                pending.append(ex.submit(self._load, chunk))
            while pending:
                yield pending.popleft().result()


def dataLoader(dataset, batch_size: int, num_voxels: int,
               capacities: Optional[CapacityConfig] = None, test: bool = False,
               num_train_samples: Optional[int] = None,
               train_ratio: Optional[float] = None,
               image_size: Optional[int] = None, workers: int = 0) -> DataLoader:
    """The reference-named factory (dataloader.py:297)."""
    return DataLoader(dataset, batch_size, num_voxels,
                      capacities or CapacityConfig(), test=test,
                      num_train_samples=num_train_samples, train_ratio=train_ratio,
                      image_size=image_size, workers=workers)
