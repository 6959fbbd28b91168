"""The port's data-parallel train step of the tiny ShapeNet model with
residual refinement: the checks of tests/test_torch_dp_train.py (ranks equal
in every bit, the one-process emulation at 1e-6, JAX ``make_dp_train_step``
over 3 steps) on their own JAX program, so that xdist runs this module beside
that one.

Against JAX, the mesh losses and the refine stages' parameters are held only
within 2 lr a step, the rest (voxel loss, overflow, BN statistics, the other
parameters) within 4x JAX's spread. In train mode this model's refine stages
are not determined at float32 precision in JAX: its neighbour sums are
differences of prefix sums over all edges, whose rounding grows with the
running total, and the stage-2 features reach 9e6. 1e-6 changes of the input
images move JAX's pre-tanh offsets by 3.3e3 and the port's (exact segment
sums) by 22, and the port differs from JAX by 2.6e3, inside JAX's own change
at every layer; but ReLU then tanh turn that noise into offsets of 0 or 1, so
JAX's edge loss spans 4.649-4.722 under such changes while the port's stays
at 4.588 (``train_step`` on B=2; eval mode agrees to 1e-7 of scale).
ROADMAP Queue 3 logs it among the reference's faults."""
import pytest

from tests import test_torch_dp_train as base


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_jobs({"residual": base.shapenet_job(True)},
                         tmp_path_factory.mktemp("dp_train_residual"))


def test_ranks_equal_in_every_bit(runs):
    base.check_ranks_equal(runs["residual"])


def test_dp_steps_match_one_process_emulation(runs):
    base.check_emulation(runs["residual"])


@pytest.mark.parametrize("i", range(base.STEPS))
def test_dp_step_matches_jax(runs, i):
    base.check_shapenet_step(runs["residual"], base.jax_run(True), i, mesh_branch=False)
