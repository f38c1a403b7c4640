"""Data-parallel training of the port on two spawned gloo ranks: one step of
small_config on two scenes (3x2 and 4x2 rooms), each rank on one, against
the port's one-process step on both (loss rtol 1e-5, every leaf within
1e-4 * max(1, max |leaf|)) and against the JAX package's single-device
step on the same weights (JAX's init, bridged) and batch, with whole levels as
memories (`model.max_sample_size`, so no torch-vs-JAX random draw enters)
and the tolerances of test_torch_train_parity.py's JAX-gradient test: the
one-process port sits 5.4e-3 from JAX on a stage-6 norm's bias of this
batch (the coarse norms of the 4x2-room scene amplify f32 rounding at
init), its decoder within 2.6e-5. The two scenes' CE weight sums
differ, so a CE normalised by a rank's own weight sum fails the gate: the
planted fault below shows it does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.train.loop import _sb_kwargs, init_state as j_init, \
    level_capacities as j_caps
from mask3d_tpu_torch import bridge
from tests import torch_dist_worker as w
from tests.test_e2e import small_config
from tests.test_torch_train_parity import PARITY_GRAD_TOL
from tests.test_torch_train_step import LOSS_RTOL, OVERRIDES, host_lsap
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

STEP = SMALL_OVERRIDES + w.STEP_OVERRIDES
MAX = ["model.max_sample_size=true"]
DP_LOSS_RTOL = 1e-5
DP_LEAF_TOL = 1e-4  # x max(1, max |leaf|)


def _jax_init(tmp):
    """JAX's initial state of small_config (the weights of every run here),
    its variables written to `tmp/weights.npz` for the ranks."""
    cfg = j_apply(small_config(), OVERRIDES + MAX)
    dev = JCollate(point_bucket_multiple=BUCKET)(w.dp_items(j_make)).device
    state, model, criterion, _ = j_init(cfg, dev)
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    path = tmp / "weights.npz"
    np.savez(path, **{"/".join(k): v for k, v in _flat(variables)})
    return cfg, dev, state, model, criterion, path


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_step(cfg, dev, state, model, criterion):
    """(loss, grads by port name) of JAX's `value_and_grad` of small_config
    on both scenes."""
    caps = j_caps(cfg, dev.coords.shape[1])

    def loss_fn(params):
        sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                     **_sb_kwargs(cfg, dev.grid_dims))
        out = model.apply(
            {"params": params, "buffers": state.buffers}, sb,
            dev.feats, dev.coords.astype(jnp.float32), False,
            grid_dims=dev.grid_dims,
            rngs={"sample": jax.random.PRNGKey(0),
                  "queries": jax.random.PRNGKey(0)})
        losses = criterion(out, dev.target.with_label_offset(
            cfg.data.prediction_label_offset), sb.levels[0].valid)
        return losses["loss"], losses

    with pytest.MonkeyPatch.context() as mp:
        host_lsap(mp)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(state.params)
    ref = bridge.from_flax({"params": flax_to_numpy(grads)})
    return float(loss), {k: v.numpy() for k, v in ref.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' steps (spawned first) and the one-process port and
    JAX steps, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg, dev, state, model, criterion, weights = _jax_init(tmp)
    ranks = w.Ranks("dp_suite", 2, tmp, STEP, str(weights))
    ref = {"max": w.train_step(0, 1, STEP + MAX, weights, 1, 1, "dp"),
           "sampled": w.train_step(0, 1, STEP, weights, 1, 1, "dp"),
           "jax": _jax_step(cfg, dev, state, model, criterion)}
    return {"dp": ranks.results(), "ref": ref}


def _worst_leaf(ref, got):
    errs = {k: float(np.abs(got[k] - ref[k]).max())
            / max(1.0, float(np.abs(ref[k]).max())) for k in ref}
    k = max(errs, key=errs.get)
    return k, errs[k]


def test_ranks_hold_halves_with_different_ce_weight_sums(runs):
    """Each rank collated one scene, padded to the pair's shapes (the
    one-process batch's), and the two scenes' CE weight sums differ."""
    shapes = [r["max"][3] for r in runs["dp"]]
    ref_shape = runs["ref"]["max"][3]
    assert shapes == [(1,) + ref_shape[1:]] * 2, (shapes, ref_shape)
    sums = [r["max"][4] for r in runs["dp"]]
    assert np.abs(sums[0] - sums[1]).max() > 0.5, sums


@pytest.mark.parametrize("memories", ["max", "sampled"])
def test_dp_step_matches_one_process_step(runs, memories):
    """Sampled: each rank draws the global batch's uniforms and keeps its
    rows, so the memories are the one-process step's."""
    ref = runs["ref"][memories]
    for rank, r in enumerate(runs["dp"]):
        got = r[memories]
        for k, v in ref[0].items():
            assert abs(got[0][k] - v) <= DP_LOSS_RTOL * max(1.0, abs(v)), \
                (rank, k, got[0][k], v)
        name, err = _worst_leaf(ref[1], got[1])
        assert err <= DP_LEAF_TOL, (rank, name, err)


def test_dp_ranks_update_alike(runs):
    """Both ranks apply the same update: the parameters after the step are
    bitwise equal."""
    for memories in ("max", "sampled"):
        a, b = (r[memories][2] for r in runs["dp"])
        for k in a:
            assert np.array_equal(a[k], b[k]), (memories, k)


def test_dp_step_matches_jax_single_device_step(runs):
    loss, grads = runs["ref"]["jax"]
    floor = 1e-4 * max(float(np.linalg.norm(g)) for g in grads.values())
    for rank, r in enumerate(runs["dp"]):
        got = r["max"]
        assert abs(got[0]["loss"] - loss) <= LOSS_RTOL * abs(loss)
        errs = {k: float(np.linalg.norm(got[1][k] - g))
                / max(float(np.linalg.norm(g)), floor)
                for k, g in grads.items()}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= PARITY_GRAD_TOL, (rank, worst, errs[worst])
        decoder = max(v for k, v in errs.items()
                      if not k.startswith("backbone"))
        assert decoder <= 1e-4, (rank, decoder)


def test_local_ce_normaliser_fails_the_gate(runs):
    """The planted fault: each rank divides its CE by its own weight sum."""
    ref = runs["ref"]["max"]
    for r in runs["dp"]:
        got = r["local_ce"]
        _, err = _worst_leaf(ref[1], got[1])
        assert err > DP_LEAF_TOL
        assert abs(got[0]["loss"] - ref[0]["loss"]) > \
            DP_LOSS_RTOL * abs(ref[0]["loss"])
