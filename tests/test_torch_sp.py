"""Sequence parallelism of the port's dense backbone (`model.sp_axis`) on
spawned gloo ranks, against the port's unsharded model and JAX's.

Two sp ranks each hold an x-slab of every level that `sp_min_per_shard`
shards (levels 0-1 of JAX's scenes' 24-cell grid, 0-2 of the parity
scenes' 40) and exchange halo planes; the decoder and the criterion run on
each rank's chunk of every level's rows. Held
against the one-process port on the same seeded weights:
- the eval forward with the InstanceNorm stubbed to `x * occ` (the
  counterpart of `test_dp_sp_backbone_exact_with_identity_norm`, JAX's
  scenes): max |diff| <= 1e-5 * max(1, std);
- the eval forward with the norm, within JAX's bounds
  (`tests/test_parallel_sp.py:112-113`), against the port's unsharded
  forward and JAX's on the same weights (`bridge.to_flax`);
- one train step's leaves: 1e-4 * max(1, max |leaf|) with the identity
  norm, 1e-2 with the norm; and one 2x2 (dp x sp) step, four ranks.
The forwards and steps with the norm run on the parity scenes (3x2 rooms,
`tests/torch_parity.py:scene_items`): on JAX's 2x1-room scenes the coarse
InstanceNorms hold one or two occupied cells an item, and the reordered sum
of their statistics alone moves a mask logit by 0.37 (the same split in
one process: 0.37), past JAX's bound, and in an sp=2 step a gradient leaf
by 0.27 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.train.loop import make_model as j_make_model
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.mask3d import build_model
from tests import torch_dist_worker as w
from tests.test_parallel_sp import _cfg, _eval_fn
from tests.test_torch_train_step import train_scenes
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

# JAX's bounds for the sharded forward (tests/test_parallel_sp.py:112-113)
JAX_BOUNDS = {"pred_class": dict(rtol=5e-2, atol=5e-2),
              "pred_masks": dict(rtol=5e-2, atol=2e-1)}
OUTPUTS = ("pred_class", "pred_masks", "backbone")
IDENTITY_TOL = 1e-5  # x max(1, std)
LEAF_TOL = {"identity": 1e-4, "norm": 1e-2}  # x max(1, max |leaf|)
LOSS_RTOL = 1e-5
STEP_OVERRIDES = w.SP_OVERRIDES + w.STEP_OVERRIDES


def _jax_forward():
    """JAX's unsharded eval forward on the parity scenes, on the port's
    seeded weights."""
    model = build_model(w.make_cfg(w.SP_OVERRIDES), device="cpu")
    variables = bridge.to_flax(model.state_dict())
    cfg = _cfg(None)
    batch = JCollate(point_bucket_multiple=w.SP_BUCKET)(
        train_scenes(j_make)).device
    fwd = _eval_fn(cfg, j_make_model(cfg), batch)
    out = fwd(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
              jax.tree_util.tree_map(jnp.asarray, variables["buffers"]),
              batch.coords, batch.counts, batch.dims, batch.feats)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded run (two spawns, started first) and every one-process
    reference (computed here while the ranks run)."""
    tmp = tmp_path_factory.mktemp("sp")
    sp = w.Ranks("sp_suite", 2, tmp, STEP_OVERRIDES)
    grid = w.Ranks("grid_suite", 4, tmp, STEP_OVERRIDES)
    ref = {
        "fwd_identity": w.forward(0, 1, w.SP_OVERRIDES, None, 1, 1, True,
                                  "sp"),
        "fwd_norm": w.forward(0, 1, w.SP_OVERRIDES, None, 1, 1, False,
                              "parity"),
        "step_identity": w.train_step(0, 1, STEP_OVERRIDES, None, 1, 1, "sp",
                                      True),
        "step_norm": w.train_step(0, 1, STEP_OVERRIDES, None, 1, 1,
                                  "parity"),
        "grid_identity": w.train_step(0, 1, STEP_OVERRIDES, None, 1, 1, "sp",
                                      True, n_items=4),
        "jax": _jax_forward(),
    }
    return {"sp": sp.results(), "grid": grid.results(), "ref": ref}


def _scaled(ref, got):
    return float(np.abs(got - ref).max()) / max(1.0, float(ref.std()))


def _worst_leaf(ref, got):
    """(name, max |g - ref| / max(1, max |ref|)) of the worst leaf."""
    errs = {k: float(np.abs(got[k] - ref[k]).max())
            / max(1.0, float(np.abs(ref[k]).max())) for k in ref}
    k = max(errs, key=errs.get)
    return k, errs[k]


@pytest.mark.parametrize("out", OUTPUTS)
def test_sp_forward_exact_with_identity_norm(runs, out):
    i = OUTPUTS.index(out)
    ref = runs["ref"]["fwd_identity"][i]
    for rank, r in enumerate(runs["sp"]):
        err = _scaled(ref, r["fwd_identity"][i])
        assert err <= IDENTITY_TOL, (rank, err)


@pytest.mark.parametrize("out", OUTPUTS[:2])
def test_sp_forward_with_norm_within_jax_bounds(runs, out):
    i = OUTPUTS.index(out)
    for r in runs["sp"]:
        np.testing.assert_allclose(r["fwd_norm"][i],
                                   runs["ref"]["fwd_norm"][i],
                                   **JAX_BOUNDS[out])


@pytest.mark.parametrize("out", OUTPUTS[:2])
def test_sp_forward_matches_jax_unsharded(runs, out):
    i = OUTPUTS.index(out)
    for r in runs["sp"]:
        np.testing.assert_allclose(r["fwd_norm"][i], runs["ref"]["jax"][i],
                                   **JAX_BOUNDS[out])


@pytest.mark.parametrize("norm", ["identity", "norm"])
def test_sp_train_step_leaves_match_unsharded(runs, norm):
    """Both sp ranks hold every gradient leaf of the unsharded step: the
    row-reading parameters' partial gradients summed over sp, the rest of
    the decoder's complete and not summed."""
    ref = runs["ref"][f"step_{norm}"]
    for rank, r in enumerate(runs["sp"]):
        got = r[f"step_{norm}"]
        assert abs(got[0]["loss"] - ref[0]["loss"]) <= \
            LOSS_RTOL * abs(ref[0]["loss"])
        name, err = _worst_leaf(ref[1], got[1])
        assert err <= LEAF_TOL[norm], (rank, name, err)


@pytest.mark.parametrize("norm", ["identity", "norm"])
def test_dp_sp_2x2_train_step_leaves_match_unsharded(runs, norm):
    """Four ranks, dp x sp = 2 x 2: each dp pair takes half of the batch,
    each sp pair the halves of its grids."""
    ref = runs["ref"]["grid_identity" if norm == "identity"
                      else "step_norm"]
    for rank, r in enumerate(runs["grid"]):
        got = r[f"step_{norm}"]
        assert abs(got[0]["loss"] - ref[0]["loss"]) <= \
            LOSS_RTOL * abs(ref[0]["loss"])
        name, err = _worst_leaf(ref[1], got[1])
        assert err <= LEAF_TOL[norm], (rank, name, err)


def test_ranks_hold_identical_replicas(runs):
    """Every rank ends the step with the same parameters, bit for bit."""
    for suite in ("sp", "grid"):
        for key in ("step_identity", "step_norm"):
            first = runs[suite][0][key][2]
            for r in runs[suite][1:]:
                for k, v in r[key][2].items():
                    assert np.array_equal(v, first[k]), (suite, key, k)


@pytest.mark.parametrize("op", ["conv3", "conv5", "norm"])
def test_slab_ops_on_four_ranks(runs, op):
    """The same-stride conv (k 3, and the 5^3 stem's two halo planes) and
    the norm on four x-slabs (interior ranks read both neighbours) against
    the whole grid: outputs and input gradients."""
    for r in runs["grid"]:
        got = r["slab_ops"]
        assert got[op] <= 1e-6 and got[op + "_grad"] <= 1e-5, got
