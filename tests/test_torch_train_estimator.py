"""The port's train step with the reference normal estimator (normal weight
0.1, ``face_normals=False``) against the JAX package's ``make_train_step`` under
``MESHRCNN_FACE_NORMALS=0``, at the tiny model's shapes: 256 points per cloud
(exact kNN) and 1536 (K3's candidate path, subtile 16). The rig and its
tolerances are those of tests/test_torch_train_step.py."""
import pytest

from tests.test_torch_train_step import check_train_steps


@pytest.mark.parametrize("pcs", [256, 1536])
def test_train_steps_match_jax_estimator_recipe(pcs):
    check_train_steps("estimator", pcs)
