"""Training with the decoder's rows sharded over `sp` on the dense backbone,
on two spawned gloo ranks (one torch thread each), against the JAX
package's train step and the port's one-process step.

Each rank holds x-slabs of the backbone's sharded levels and one chunk of
every level's rows in the decoder and the criterion
(`parallel.mesh.RowChunks`). On the parity scenes (3x2 rooms,
`tests/torch_parity.py:scene_items`; `SP_OVERRIDES`: Res16UNet14A, hidden
32, sample sizes 16 ... 256 on levels of 112 ... 1792 rows), with whole
padded levels as memories (`max_sample_size`) and with sampled memories
(the same numpy uniforms on every side):
- the loss within LOSS_RTOL of the JAX package's unsharded train step on
  the same weights (`bridge.to_flax` of the port's seeded init) and
  scenes: its train-mode forward and criterion under `jax.jit`, scipy
  matching on both sides (tests/test_torch_train_step.py);
- every gradient leaf of each rank within LEAF_TOL x max(1, max |leaf|)
  of the one-process port step (run in a process of its own, one thread,
  as the ranks), and both ranks' updated parameters bitwise equal.
Also here: the adjoint of `comm.reduce_scatter_rows` on the two ranks;
the attention's partial form with its gradient, over two key chunks and
combined, against `jax.vjp` of the JAX package's XLA reference over the
whole keys; and the sampled memory's absent key slots (an item without
rows) dropped from the partial softmax.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mask3d_tpu.ops.pallas_attention as j_attention
from mask3d_tpu.config import Config as JConfig
from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.train.loop import _sb_kwargs, level_capacities as j_caps, \
    make_criterion as j_make_criterion, make_model as j_make_model
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.ops import masked_attention as ma
from mask3d_tpu_torch.train.loop import init_state
from tests import torch_dist_worker as w
from tests.test_torch_train_step import Uniforms, host_lsap, train_scenes
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

LOSS_RTOL = 1e-4  # against JAX's step
LEAF_TOL = 1e-4  # x max(1, max |leaf|), against the one-process port
ATTN_GRAD_TOL = 1e-5  # x max(1, max |grad|), f32
STEP_OVERRIDES = w.SP_OVERRIDES + w.STEP_OVERRIDES
# name -> (overrides, scenes, items, uniforms seed or None)
CASES = {
    "dense_whole": (STEP_OVERRIDES + ["model.max_sample_size=true"],
                    "parity", 2, None),
    "dense_sampled": (STEP_OVERRIDES, "parity", 2, 7),
}


def jax_losses(cases, monkeypatch):
    """name -> the JAX package's train-step loss of each case: its model
    in train mode and its criterion under `jax.jit` (XLA at optimization
    level 0, to compile fast), on the port's seeded weights. Each case is
    traced in turn and compiled and run in a thread, beside the next
    one's trace."""
    host_lsap(monkeypatch)
    jobs = {}
    pool = ThreadPoolExecutor(len(cases))
    for name, (ov, items, n, seed) in cases.items():
        variables = bridge.to_flax(init_state(
            w.make_cfg(ov), device="cpu").model.state_dict())
        params, buffers = (jax.tree_util.tree_map(jnp.asarray,
                                                  variables[k])
                           for k in ("params", "buffers"))
        cfg = j_apply(JConfig(), ov)
        dev = JCollate(point_bucket_multiple=w.SP_BUCKET)(
            train_scenes(j_make)[:n]).device
        model, criterion = j_make_model(cfg), j_make_criterion(cfg)
        caps = j_caps(cfg, dev.coords.shape[1])

        def loss_fn(params, buffers):
            sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                         **_sb_kwargs(cfg, dev.grid_dims))
            o = model.apply(
                {"params": params, "buffers": buffers}, sb, dev.feats,
                dev.coords.astype(jnp.float32), False,
                grid_dims=dev.grid_dims,
                rngs={"sample": jax.random.PRNGKey(0),
                      "queries": jax.random.PRNGKey(0)})
            return criterion(o, dev.target.with_label_offset(
                cfg.data.prediction_label_offset),
                sb.levels[0].valid)["loss"]

        with monkeypatch.context() as mp:
            if seed is not None:
                mp.setattr(jax.random, "uniform", Uniforms(seed).jax)
            lowered = jax.jit(loss_fn).lower(params, buffers)
        jobs[name] = pool.submit(
            lambda lowered=lowered, args=(params, buffers): float(
                lowered.compile(compiler_options={
                    "xla_backend_optimization_level": 0})(*args)))
    try:
        return {name: job.result() for name, job in jobs.items()}
    finally:
        pool.shutdown()


def sharded_runs(tmp_path_factory, cases, name, adjoint=False):
    """The sp=2 steps and the one-process ones (two spawns, started
    first), and JAX's losses, computed while they run."""
    tmp = tmp_path_factory.mktemp(name)
    ranks = w.Ranks("sp_train_suite", 2, tmp, cases, adjoint)
    refs = w.Ranks("port_steps", 1, tmp, cases)
    with pytest.MonkeyPatch.context() as mp:
        jax_out = jax_losses(cases, mp)
    return {"sp": ranks.results(), "ref": refs.results()[0], "jax": jax_out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sharded_runs(tmp_path_factory, CASES, "sp_train", adjoint=True)


def worst_leaf(ref, got):
    """(name, max |g - ref| / max(1, max |ref|)) of the worst leaf."""
    errs = {k: float(np.abs(got[k] - ref[k]).max())
            / max(1.0, float(np.abs(ref[k]).max())) for k in ref}
    k = max(errs, key=errs.get)
    return k, errs[k]


def check_case(runs, case):
    """The loss against JAX's, every leaf against the one-process step and
    the two ranks' replicas bitwise equal."""
    ref, want = runs["ref"][case], runs["jax"][case]
    for rank, r in enumerate(runs["sp"]):
        got = r[case]
        assert abs(got[0]["loss"] - want) <= LOSS_RTOL * abs(want), \
            (rank, got[0]["loss"], want)
        assert int(got[0]["batch_overflow"]) == 0
        name, err = worst_leaf(ref[1], got[1])
        assert err <= LEAF_TOL, (rank, name, err)
    first, second = (r[case][2] for r in runs["sp"])
    for k, v in first.items():
        assert np.array_equal(v, second[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_train_step_matches_jax_and_one_process(runs, case):
    check_case(runs, case)


def test_reduce_scatter_rows_adjoint(runs):
    """On two ranks the backward of `comm.reduce_scatter_rows` is the
    transpose of its forward (float64): sum_r <RS(x)_r, g_r> equals
    sum_r <x_r, RS^T(g)_r>, and each rank's input gradient is every
    rank's chunk gradient in row order."""
    got = [r["adjoint"] for r in runs["sp"]]
    fwd = sum(g[0] for g in got)
    bwd = sum(g[1] for g in got)
    assert abs(fwd - bwd) <= 1e-12 * max(1.0, abs(fwd)), (fwd, bwd)
    assert all(g[2] == 0.0 for g in got), got


def _attention_case(seed=0, b=2, nq=5, d=32, s=40):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, nq, d), (b, s, d), (b, s, d)))
    mask = rng.random((b, nq, s)) < 0.5
    mask[0, 1, :] = True  # a query blocked on every key
    mask[1, 2, :20] = True  # a query blocked on the first chunk
    mask[:, :, 30:] = True  # padding rows
    return q, k, v, mask


@pytest.mark.parametrize("bounds", [(0, 20, 40), (0, 0, 40),
                                    (0, 13, 26, 39, 40)])
def test_partial_attention_gradient_matches_jax_vjp(bounds):
    """The partial form over key chunks (one empty, one all padding, a
    query blocked on a whole chunk and one blocked everywhere) combined,
    with maxes detached: (q, k, v) gradients of a random cotangent within
    ATTN_GRAD_TOL of `jax.vjp` of the JAX package's `_xla_reference` over
    the whole keys."""
    h = 4
    q, k, v, mask = _attention_case()
    cot = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_attention._xla_reference(
        q_, k_, v_, jnp.asarray(mask), h), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tm = torch.tensor(mask)
    parts = [ma.masked_cross_attention_partial(
        tq, tk[:, a:b], tv[:, a:b], tm[:, :, a:b], h)
        for a, b in zip(bounds[:-1], bounds[1:])]
    outs, maxes, sums = zip(*parts)
    assert not any(m.requires_grad for m in maxes)
    out = ma.combine_partial_softmax(outs, maxes, sums, h)
    out.backward(torch.tensor(cot))
    for name, g, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        err = float(np.abs(g.numpy() - ref).max()) / max(
            1.0, float(np.abs(ref).max()))
        assert err <= ATTN_GRAD_TOL, (name, bounds, err)


def test_absent_key_slots_leave_an_item_without_rows():
    """A sampled memory on two ranks: each rank's slots of the other's
    rows are blocked with v zero and dropped (`drop_absent_keys`); an
    item whose every slot is blocked (no rows) then averages over its
    sampled keys alone, as the one-shot form does, and so does an item
    with keys; within 1e-6 of the one-shot softmax."""
    h = 4
    q, k, v, mask = (torch.tensor(x) for x in _attention_case(2, s=24))
    mask[0] = True  # item 0 has no rows: every slot padding
    ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
    owner = torch.tensor(np.random.default_rng(3).random((2, 24)) < 0.4)
    parts = []
    for mine in (owner, ~owner):
        o, m, s_ = ma.masked_cross_attention_partial(
            q, k, v * mine[..., None], mask | ~mine[:, None, :], h)
        parts.append(ma.drop_absent_keys(o, m, s_, (~mine).sum(dim=1), h)
                     + (m,))
    outs, sums, maxes = zip(*parts)
    got = ma.combine_partial_softmax(outs, maxes, sums, h)
    assert float((got - ref).abs().max()) <= 1e-6
    # without the drop, item 0's uniform weights span both ranks' slots
    raw = [ma.masked_cross_attention_partial(
        q, k, v * mine[..., None], mask | ~mine[:, None, :], h)
        for mine in (owner, ~owner)]
    bad = ma.combine_partial_softmax(*zip(*raw), h)
    assert float((bad - ref)[0].abs().max()) > 1e-2
