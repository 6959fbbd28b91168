"""The port's initial weights against flax's, on a tiny ShapeNet model
(residual refinement, 16 features, one stage) and the tiny Pix3D model of
tests/test_pix3d.py, each built once in both packages; the flax leaves are
mapped to the port's names by ``utils/jax_params.py``.

  * every bias is exactly 0 and every BatchNorm scale 1, on both sides;
  * each kernel of 256 or more elements has the standard deviation of its
    flax counterpart within 6 / sqrt(2 n) relative (n elements: the sampling
    error of a standard deviation is about sigma / sqrt(2 n) on each side, so
    this is over four of its standard errors apart), and the one flax's rule
    gives it within the same;
  * every kernel lies within flax's truncation, +-2 sigma of ``lecun_normal``
    (sigma = sqrt(1 / fan_in) / 0.8796) or +-1/sqrt(fan_in) for GraphConv's
    uniform ``w0`` / ``w1``, the fan read from the flax kernel layout, and
    the JAX package's draws lie within the same bound;
  * a transposed conv with 8 inputs and 64 outputs has fan_in 8 * 2 * 2;
  * two equal seeds of torch's global generator give equal weights, another
    seed other weights.
"""
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu.models.shapenet import ShapeNetModel as JaxShapeNetModel
from meshrcnn_tpu_torch.models import cast, init
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from tests.test_pix3d import TINY
from tests.torch_parity import state_dict_from_flax

SHAPENET_TINY = dict(num_classes=13, residual=True, vertex_feature_dim=16,
                     num_refinement_stages=1, vert_capacity=512, face_capacity=1024,
                     edge_capacity=2048, backbone_dtype="float32")
PIX3D_TINY = dict(TINY, backbone_dtype="float32")
PORT_PIX3D_TINY = {k: v for k, v in PIX3D_TINY.items()
                   if k not in ("roi_batch_size", "mask_rois")}


def _port_models() -> dict:
    torch.manual_seed(0)
    return {"shapenet": ShapeNetModel(**SHAPENET_TINY),
            "pix3d": Pix3DModel(**PORT_PIX3D_TINY)}


@pytest.fixture(scope="module")
def pairs():
    """{name: (port model, the flax init's variables mapped to its names)};
    the two JAX inits compile in two threads."""
    jax_models = {"shapenet": JaxShapeNetModel(**SHAPENET_TINY),
                  "pix3d": JaxPix3DModel(**PIX3D_TINY)}

    def jax_init(m):
        return jax.jit(lambda x: m.init(jax.random.PRNGKey(0), x, train=False))(
            jnp.zeros((1, 64, 64, 3)))
    with ThreadPoolExecutor(2) as ex:
        variables = dict(zip(jax_models, ex.map(jax_init, jax_models.values())))
    port = _port_models()
    return {name: (port[name], state_dict_from_flax(port[name], v["params"], v["batch_stats"]))
            for name, v in variables.items()}


def _bounds(model: torch.nn.Module) -> dict:
    """{weight name: (flax's bound on its values, the standard deviation of its rule)}."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, init.FanInLinear):
            bound = 1.0 / math.sqrt(m.in_features)
            out[f"{name}.weight"] = (bound, bound / math.sqrt(3.0))
        elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            std = math.sqrt(1.0 / init.flax_fan_in(m))
            out[f"{name}.weight"] = (2.0 * std / init.TRUNCATED_STD, std)
    return out


@pytest.mark.parametrize("name", ["shapenet", "pix3d"])
def test_initial_weights_follow_flax(pairs, name):
    model, flax_sd = pairs[name]
    params = dict(model.named_parameters())
    assert set(params) <= set(flax_sd)
    bounds = _bounds(model)
    norms = {n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    compared = 0
    for n, p in params.items():
        port, ref = p.detach().double(), flax_sd[n].double()
        assert port.shape == ref.shape, n
        if n in bounds:
            bound, std = bounds[n]
            for side, w in (("port", port), ("jax", ref)):
                assert float(w.abs().max()) <= bound * (1 + 1e-6), (side, n)
            if p.numel() >= 256:
                tol = 6.0 / math.sqrt(2 * p.numel())
                assert abs(float(port.std()) / float(ref.std()) - 1.0) <= tol, n
                assert abs(float(port.std()) / std - 1.0) <= tol, n
                compared += 1
        elif n.endswith(".bias"):
            assert not port.any() and not ref.any(), n
        else:
            assert n[:-len(".weight")] in norms, n            # a BatchNorm scale
            assert torch.equal(port, torch.ones_like(port)), n
            assert torch.equal(ref, torch.ones_like(ref)), n
    assert compared > 50


def test_conv_transpose_fan_is_the_flax_kernel_layout():
    torch.manual_seed(1)
    layer = cast.ConvTranspose2d(8, 64, 2, stride=2)
    assert init.flax_fan_in(layer) == 8 * 2 * 2
    flax_layer = fnn.ConvTranspose(64, (2, 2), strides=(2, 2))
    kernel = np.asarray(flax_layer.init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 4, 4, 8)))["params"]["kernel"])
    assert kernel.shape == (2, 2, 8, 64)
    tol = 6.0 / math.sqrt(2 * kernel.size)
    port_std = float(layer.weight.detach().double().std())
    assert abs(port_std / float(kernel.std()) - 1.0) <= tol
    assert abs(port_std * math.sqrt(8 * 2 * 2) - 1.0) <= tol     # variance 1 / fan_in
    assert not layer.bias.detach().any()


def test_equal_generators_give_equal_weights():
    a, b = _port_models(), _port_models()
    for name in a:
        assert all(torch.equal(x, y) for x, y in zip(a[name].state_dict().values(),
                                                    b[name].state_dict().values()))
    with torch.random.fork_rng():
        torch.manual_seed(1)
        other = ShapeNetModel(**SHAPENET_TINY)
    assert not torch.equal(other.state_dict()["backbone.conv1.weight"],
                           a["shapenet"].state_dict()["backbone.conv1.weight"])
