"""The Instant-NGP edit (StudentTrainer on Trainer, with the teacher's
background) on the port's data mesh, at 2 ranks of a gloo mesh on the CPU,
against the port on one rank and the JAX package's unsharded
StudentTrainer: the checks and tolerances of test_torch_parallel_edit.py
(the proxy, the zones, one pretraining step on a full and on a padded
batch, one distillation step), on the narrow Instant-NGP teacher of
tests/torch_edit_setup.py.
"""

import pytest

import test_torch_parallel_edit as edit

_one_thread = edit._one_thread


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return edit.build_env(tmp_path_factory.mktemp("edit_ngp"), ("ngp",))


def test_sharded_proxy_is_the_one_rank_proxy(env):
    edit.check_proxy(env, "ngp")


def test_gathered_zones_are_the_one_rank_zones(env):
    edit.check_zones(env, "ngp")


def test_two_rank_pretraining_step_is_the_unsharded_step(env):
    edit.check_pretraining_step(env, "ngp")


def test_distillation_step_is_the_mean_gradient_step(env):
    edit.check_distillation_step(env, "ngp")
