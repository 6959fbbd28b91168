"""How far the approximate kNN moves the PCA normal loss (counterpart of the
JAX package's tools/quantify_knn.py).

    python -m meshrcnn_tpu_torch.quantify_knn [--n 2048] [--k 10] [--tile 2048] [--trials 3]

The kNN + PCA normal estimator (``--knn_normals``) takes each point's k
nearest neighbours from K3's subtile-min candidates (K4 for one cloud), which
lose a true neighbour where two share a run of points. On the same clouds,
surface samples of random cuboids (the synthetic training shapes) and of a
unit sphere (a smooth control), drawn from ``np.random.RandomState(100 +
trial)`` as the JAX tool draws them, this measures against the exact kNN:

  * neighbour recall of ``knn`` (K4 on the card) within each cloud;
  * the normal loss -(sum_p / |p| + sum_q / |q|) at the clouds' nearest
    neighbours, its relative error, and the cosine and relative L2 error of
    its gradient with respect to the predicted cloud (K3 on the card).

Prints the JAX tool's lines, the means over ``--trials``. Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from meshrcnn_tpu_torch.ops.chamfer import batched_normal_distance, knn, nearest_neighbor
from meshrcnn_tpu_torch.utils.cli import device_of

parser = argparse.ArgumentParser("approximate-kNN deviation")
parser.add_argument("--n", type=int, default=2048, help="points per cloud")
parser.add_argument("--k", type=int, default=10)
parser.add_argument("--tile", type=int, default=2048)
parser.add_argument("--trials", type=int, default=3)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")


def sample_cuboid(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform samples on the surface of a random axis-aligned cuboid, jittered
    (the JAX tool's draws, in its order)."""
    ext = rng.uniform(0.3, 1.0, size=3)
    face = rng.randint(0, 6, size=n)
    uv = rng.uniform(-1.0, 1.0, size=(n, 2))
    pts = np.empty((n, 3), np.float32)
    for i in range(6):
        m = face == i
        axis = i // 2
        sign = 1.0 if i % 2 == 0 else -1.0
        others = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * ext[axis]
        pts[m, others[0]] = uv[m, 0] * ext[others[0]]
        pts[m, others[1]] = uv[m, 1] * ext[others[1]]
    return pts + rng.normal(0, 0.005, size=(n, 3)).astype(np.float32)


def sample_sphere(rng: np.random.RandomState, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def trial(p: torch.Tensor, q: torch.Tensor, k: int, tile: int) -> dict:
    """One pair of clouds [n, 3]: recall of the approximate kNN of p in p, and
    the exact and approximate normal losses and their gradients in p."""
    n = p.shape[0]
    _, idx_p = nearest_neighbor(p, q)
    _, idx_q = nearest_neighbor(q, p)
    ie = knn(p, p, k, tile, exact=True)[1].cpu().numpy()
    ia = knn(p, p, k, tile)[1].cpu().numpy()
    recall = float(np.mean([len(set(ie[i]) & set(ia[i])) / k for i in range(n)]))

    def value_and_grad(exact: bool):
        pp = p.clone().requires_grad_(True)
        a, b = batched_normal_distance(pp[None], q[None], idx_p[None], idx_q[None], k=k,
                                       tile=tile, exact=exact)
        loss = -(a[0] / pp.shape[0] + b[0] / q.shape[0])
        loss.backward()
        return float(loss.detach()), pp.grad.detach().double().ravel()

    ve, ge = value_and_grad(True)
    va, ga = value_and_grad(False)
    return {"recall": recall, "exact": ve, "approx": va,
            "val_rel": abs(va - ve) / max(abs(ve), 1e-12),
            "grad_cos": float(ge @ ga / max(float(ge.norm() * ga.norm()), 1e-12)),
            "grad_rel": float((ga - ge).norm() / max(float(ge.norm()), 1e-12))}


def main(argv=None) -> dict:
    """Measure both shapes; returns {shape: {"trials": [trial's dicts], and
    the means of recall, val_rel, grad_cos, grad_rel}}."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    results = {}
    for name, sampler in (("cuboid", sample_cuboid), ("sphere", sample_sphere)):
        rows = []
        for t in range(args.trials):
            rng = np.random.RandomState(100 + t)
            p = torch.as_tensor(sampler(rng, args.n), device=device)
            q = torch.as_tensor(sampler(rng, args.n), device=device)
            rows.append(trial(p, q, args.k, args.tile))
        means = {key: float(np.mean([r[key] for r in rows]))
                 for key in ("recall", "val_rel", "grad_cos", "grad_rel")}
        results[name] = dict(means, trials=rows)
        last = rows[-1]
        print(f"[{name}] n={args.n} k={args.k} trials={args.trials}")
        print(f"  knn recall:        {means['recall']:.4f}")
        print(f"  loss value rel-err {means['val_rel']:.2e}  (exact {last['exact']:.6f}, "
              f"approx {last['approx']:.6f})")
        print(f"  grad cosine sim    {means['grad_cos']:.6f}")
        print(f"  grad rel L2 err    {means['grad_rel']:.4f}", flush=True)
    return results


if __name__ == "__main__":
    main()
