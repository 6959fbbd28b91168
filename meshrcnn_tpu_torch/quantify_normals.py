"""How far face normals move the normal loss from the reference's kNN + PCA
estimate (counterpart of the JAX package's tools/quantify_normals.py).

    python -m meshrcnn_tpu_torch.quantify_normals [--n 4096] [--k 10]

The port's default normal loss uses the exact unit normal of the triangle
each point was sampled from; the reference estimates normals from the cloud
by kNN + PCA (``--knn_normals``). On two meshes, the teapot OBJ fixture
(smooth and curved) and a cubify lattice (flat facets and sharp edges), and
on the same clouds, this measures:

  * the two-sided |cos| normal loss with face normals, with PCA normals of
    the exact kNN, and with PCA normals of the approximate kNN (K3 on the card);
  * its gradient with respect to the predicted vertices, face against exact
    PCA (cosine, relative L2);
  * how well each estimator's gradient agrees with itself on clouds drawn
    anew (the noise floor of that cosine);
  * per point on the ground-truth cloud, |n_face . n_pca|.

The predicted mesh is the mesh with its vertices moved by 0.01 times a unit
normal draw, the ground truth the mesh itself; each cloud has ``--n`` points
and its nearest neighbours in the other are found once (K2 on the card).
Every draw comes from a generator seeded 0; ``measure`` takes them from the
caller. Prints the JAX tool's lines. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from meshrcnn_tpu_torch.data.serialization import load_mesh
from meshrcnn_tpu_torch.ops.chamfer import (batched_compute_normals, batched_normal_distance,
                                            chamfer_distance)
from meshrcnn_tpu_torch.ops.cubify import cubify
from meshrcnn_tpu_torch.ops.sampling import batched_sample_points
from meshrcnn_tpu_torch.utils.cli import device_of

TEAPOT = Path(__file__).resolve().parents[1] / "tests" / "utils_tests" / "teapot.obj"
# the uniform streams of a measurement, each three [1, n] draws of the sampler
STREAMS = ("pred", "gt", "pred2", "gt2")

parser = argparse.ArgumentParser("face-normal estimator deviation")
parser.add_argument("--n", type=int, default=4096, help="points per cloud")
parser.add_argument("--k", type=int, default=10)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")


def load_meshes(device: torch.device) -> Dict[str, tuple]:
    """{"teapot": (verts [V,3] float32, faces [F,3] int32), "cubify": ...}: the
    OBJ, and the cubify mesh of a 16^3 grid holding an 8^3 block and a 4 x 4 x 4
    bump, at threshold 0.5 (the JAX tool's grid)."""
    mesh = load_mesh(str(TEAPOT))
    out = {"teapot": (np.asarray(mesh.vertices, np.float32), np.asarray(mesh.faces, np.int32))}
    g = torch.zeros((1, 16, 16, 16), device=device)
    g[0, 4:12, 4:12, 4:12] = 1.0
    g[0, 6:10, 2:6, 6:10] = 1.0
    m, _ = cubify(g, 0.5, vert_capacity=2048, face_capacity=4096, edge_capacity=8192)
    nv, nf = int(m.verts_mask[0].sum()), int(m.faces_mask[0].sum())
    out["cubify"] = (m.verts[0, :nv].cpu().numpy().astype(np.float32),
                     m.faces[0, :nf].cpu().numpy().astype(np.int32))
    return out


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-12))


def measure(verts: np.ndarray, faces: np.ndarray, n: int, k: int, noise: np.ndarray,
            draws: Dict[str, Sequence[np.ndarray]], device: torch.device) -> dict:
    """The tool's numbers for one mesh: ``noise`` [V, 3] moves the predicted
    vertices (times 0.01); ``draws`` holds each of ``STREAMS``' three [1, n]
    uniforms (face choice, xi1, xi2). "pred" / "gt" sample the clouds of the
    losses (the same draws on every evaluation), "pred2" / "gt2" the clouds
    drawn anew for the self-consistency cosines."""
    gt_verts = torch.tensor(verts, device=device)[None]
    fc = torch.tensor(faces, device=device)[None].long()
    fm = torch.ones(fc.shape[:2], dtype=torch.bool, device=device)
    pred0 = gt_verts + 0.01 * torch.tensor(noise, device=device)[None]

    def sample(v, stream):
        it = iter(torch.tensor(d, device=device) for d in draws[stream])
        pts, _, nrm = batched_sample_points(v, fc, fm, n, lambda shape: next(it),
                                            return_normals=True)
        return pts, nrm

    def nn_index(cp, cg):
        _, ip, _, ig = chamfer_distance(cp[0].detach(), cg[0].detach())
        return ip[None], ig[None]

    cp, _ = sample(pred0, "pred")
    cg, nfg = sample(gt_verts, "gt")
    ip, ig = nn_index(cp, cg)

    def value_and_grad(kind: str, streams=("pred", "gt"), idx=None):
        pv = pred0.clone().requires_grad_(True)
        cp, nfp = sample(pv, streams[0])
        cg, nfg = sample(gt_verts, streams[1])
        i_p, i_g = idx if idx is not None else nn_index(cp, cg)
        kw = (dict(normals_p=nfp, normals_q=nfg) if kind == "face"
              else dict(exact=kind == "pca_exact"))
        a, b = batched_normal_distance(cp, cg, i_p, i_g, k=k, **kw)
        loss = -(a + b).sum() / n
        loss.backward()
        return float(loss.detach()), pv.grad.detach()

    lf, gf = value_and_grad("face", idx=(ip, ig))
    le, ge = value_and_grad("pca_exact", idx=(ip, ig))
    la, _ = value_and_grad("pca_approx", idx=(ip, ig))
    rel = float((gf - ge).double().norm() / max(float(ge.double().norm()), 1e-12))
    _, ge2 = value_and_grad("pca_exact", ("pred2", "gt2"))
    _, gf2 = value_and_grad("face", ("pred2", "gt2"))

    with torch.no_grad():
        npca = batched_compute_normals(cg, k=k, exact=True)
        agree = (nfg * npca).sum(-1).abs().double().cpu().numpy()
    return {"V": len(verts), "F": len(faces), "loss_face": lf, "loss_pca_exact": le,
            "loss_pca_approx": la, "grad_cos": _cos(gf, ge), "grad_rel": rel,
            "self_pca": _cos(ge, ge2), "self_face": _cos(gf, gf2),
            "agree_mean": float(agree.mean()), "agree_p10": float(np.percentile(agree, 10)),
            "agree_frac": float((agree > 0.9).mean())}


def report(name: str, m: dict, n: int, k: int) -> None:
    """Print the JAX tool's lines for one mesh."""
    print(f"[{name}] V={m['V']} F={m['F']} n={n} k={k}")
    print(f"  normal loss: face={m['loss_face']:+.4f}  pca_exact={m['loss_pca_exact']:+.4f}"
          f"  pca_approx={m['loss_pca_approx']:+.4f}")
    print(f"  grad vs pca_exact: cosine={m['grad_cos']:.3f} relL2={m['grad_rel']:.3f}")
    print(f"  resampling self-consistency: pca={m['self_pca']:.3f}"
          f"  face={m['self_face']:.3f}")
    print(f"  |n_face . n_pca| on GT cloud: mean={m['agree_mean']:.4f}"
          f"  p10={m['agree_p10']:.4f}  frac>0.9={m['agree_frac']:.3f}", flush=True)


def main(argv=None) -> dict:
    """Measure both meshes; returns {mesh: measure's dict}."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    g = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, (v, f) in load_meshes(device).items():
        noise = torch.randn(v.shape, generator=g, device=device).cpu().numpy()
        draws = {s: [torch.rand((1, args.n), generator=g, device=device).cpu().numpy()
                     for _ in range(3)] for s in STREAMS}
        results[name] = measure(v, f, args.n, args.k, noise, draws, device)
        report(name, results[name], args.n, args.k)
    return results


if __name__ == "__main__":
    main()
