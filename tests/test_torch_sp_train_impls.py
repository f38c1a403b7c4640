"""Training with the decoder's rows sharded over `sp` on the impls whose
backbone runs whole on every rank (`gather`, `bricked`), on two spawned
gloo ranks, held as tests/test_torch_sp_train.py holds the dense step:
the loss within LOSS_RTOL of the JAX package's unsharded train step, every
gradient leaf within LEAF_TOL x max(1, max |leaf|) of the one-process port
step, and both ranks' replicas bitwise equal. Each rank takes its chunk of
the backbone's rows, so its backbone gradients are its rows' share, summed
over `sp`. Sampled memories (the same numpy uniforms on every side);
`bricked` on one parity scene (B=1), 8^3 bricks.
"""

import pytest

from tests.test_torch_sp_train import STEP_OVERRIDES, check_case, \
    sharded_runs
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

# name -> (overrides, scenes, items, uniforms seed)
CASES = {
    "gather": (STEP_OVERRIDES + ["model.backbone_impl=gather"], "parity", 2,
               7),
    "bricked": (STEP_OVERRIDES + ["model.backbone_impl=bricked",
                                  "model.brick_dims=[8,8,8]",
                                  "model.brick_capacity=64"], "parity", 1,
                7),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sharded_runs(tmp_path_factory, CASES, "sp_train_impls")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_train_step_matches_jax_and_one_process(runs, case):
    check_case(runs, case)
