"""Training on the large-scene paths beyond the step parity tests
(tests/test_torch_train_bricked.py, test_torch_train_bf16.py): the
gradient of every brick op against `jax.vjp` of the JAX package's, the
bricked step's batch rule and brick-overflow skip, a JAX TrainState
resumed by the port's checkpoint reader against JAX's next optax update,
and the `measure_model_phases` segments against the JAX model's phase
markers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.sparse import brick_ops as J
from mask3d_tpu_torch import bridge, collate
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.sparse import brick_ops as T
from mask3d_tpu_torch.sparse import dense_ops as TD
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.loop import init_state, make_train_step
from tests.test_e2e import small_config
from tests.test_torch_brick_ops import CAP, GRID, _conv_w, _levels, \
    _mk_coarse, _scene, _t
from tests.test_torch_train_step import train_scenes
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401
from tests.torch_train_parity import BRICKED, one_scene


# ---------------------------------------------------------------- brick ops


def _vjp_pair(jfn, tfn, jargs, targs, rng):
    """(JAX cotangent-vector products, the port's .grad) of each
    differentiable argument for one random cotangent."""
    out, vjp = jax.vjp(jfn, *jargs)
    g = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    leaves = [a.clone().requires_grad_() for a in targs]
    got = tfn(*leaves)
    assert tuple(got.shape) == out.shape, (got.shape, out.shape)
    got.backward(_t(g))
    return want, [a.grad for a in leaves]


def _close(ref, got, tol=1e-5):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _coarse(s):
    """The scene's level 1: (dims, numpy level, occupancy, port level)."""
    cdims = tuple(g // 2 for g in GRID)
    coarse = _mk_coarse({k: np.asarray(getattr(s["lj"], k))
                         for k in ("key", "coords", "valid", "count",
                                   "dims")}, cdims)
    _, ct = _levels(coarse, stride=2)
    return cdims, coarse, TD.occupancy(ct, cdims), ct


@pytest.mark.parametrize("op", [
    "scatter_rows_dropped", "gather_rows", "halo_pad", "conv_same",
    "conv_down", "slots_to_dense", "dense_to_slots", "conv_tr",
    "instance_norm"])
def test_brick_op_grads_match_jax_vjp(op):
    """The gradient of each brick op against `jax.vjp` of JAX's, f32,
    within 1e-5 of max(1, max |ref|). `scatter_rows_dropped`: a capacity
    of 4 bricks, so the rows of the bricks past it, and the padding rows,
    are dropped (a zero gradient, as JAX's mode="drop")."""
    s = _scene(seed=1, n=200) if op == "scatter_rows_dropped" else _scene()
    rng, c = s["rng"], s["feats"].shape[-1]
    sj, st, tj, tt = s["sj"], s["st"], s["tj"], s["tt"]
    bj = J.scatter_rows(jnp.asarray(s["feats"]), tj, sj)
    bt = T.scatter_rows(_t(s["feats"]), tt, st)
    occ_j = J.occupancy(tj, sj, s["lj"].valid)
    occ_t = T.occupancy(tt, st, s["lt"].valid)
    if op == "scatter_rows_dropped":
        sj = J.make_brick_spec(GRID, (8, 8, 4), 4)
        st = T.make_brick_spec(GRID, (8, 8, 4), 4)
        tj, tt = J.build_tables(s["lj"], sj), T.build_tables(s["lt"], st)
        assert bool(tt.overflow)
        want, got = _vjp_pair(lambda f: J.scatter_rows(f, tj, sj),
                              lambda f: T.scatter_rows(f, tt, st),
                              [jnp.asarray(s["feats"])], [_t(s["feats"])],
                              rng)
        dropped = tt.row_flat.long() >= (st.capacity + 1) * st.cells
        assert int(dropped[s["lt"].valid[0]].sum()) > 0  # bricks past it
        assert float(got[0][0][dropped].abs().max()) == 0.0
    elif op == "gather_rows":
        want, got = _vjp_pair(
            lambda b: J.gather_rows(b, tj, sj, s["lj"].valid),
            lambda b: T.gather_rows(b, tt, st, s["lt"].valid),
            [bj], [bt], rng)
    elif op == "halo_pad":
        want, got = _vjp_pair(lambda b: J.halo_pad(b, tj, sj, 2),
                              lambda b: T.halo_pad(b, tt, st, 2),
                              [bj], [bt], rng)
    elif op == "conv_same":  # chunks of 5 slots
        w = rng.standard_normal((27, c, 5)).astype(np.float32) * 0.2
        want, got = _vjp_pair(
            lambda b, ww: J.conv_same(b, ww, occ_j, tj, sj, chunk=5),
            lambda b, ww: T.conv_same(b, ww, occ_t, tt, st, chunk=5),
            [bj, jnp.asarray(w)], [bt, _conv_w(w, 3)], rng)
        want = [want[0], _conv_w(np.asarray(want[1]), 3).numpy()]
    elif op == "conv_down":
        cdims, _, occ1, _ = _coarse(s)
        w = rng.standard_normal((8, c, 7)).astype(np.float32) * 0.3
        want, got = _vjp_pair(
            lambda b, ww: J.conv_down(b, ww, jnp.asarray(occ1.numpy()), tj,
                                      sj, cdims),
            lambda b, ww: T.conv_down(b, ww, occ1, tt, st, cdims),
            [bj, jnp.asarray(w)], [bt, _conv_w(w, 2)], rng)
        want = [want[0], _conv_w(np.asarray(want[1]), 2).numpy()]
    elif op == "slots_to_dense":
        half = rng.standard_normal((CAP, 4, 4, 2, c)).astype(np.float32)
        want, got = _vjp_pair(lambda h: J.slots_to_dense(h, tj, sj),
                              lambda h: T.slots_to_dense(h, tt, st),
                              [jnp.asarray(half)], [_t(half)], rng)
    elif op == "dense_to_slots":
        dense = rng.standard_normal((1, 16, 8, 4, c)).astype(np.float32)
        want, got = _vjp_pair(
            lambda d: J.dense_to_slots(d, tj, sj, 4, 4, 2),
            lambda d: T.dense_to_slots(d, tt, st, 4, 4, 2),
            [jnp.asarray(dense)], [_t(dense)], rng)
    elif op == "conv_tr":
        cdims, coarse, _, ct = _coarse(s)
        cfeats = rng.standard_normal((1, 256, c)).astype(np.float32)
        cfeats[0, int(coarse["count"][0]):] = 0
        cdense = TD.scatter_rows(_t(cfeats), ct, cdims)
        w = rng.standard_normal((8, c, 4)).astype(np.float32) * 0.3
        wt = _t(w.reshape(2, 2, 2, c, 4).transpose(3, 4, 0, 1, 2).copy())
        want, got = _vjp_pair(
            lambda d, ww: J.conv_tr(d, ww, occ_j, tj, sj),
            lambda d, ww: T.conv_tr(d, ww, occ_t, tt, st),
            [jnp.asarray(cdense.numpy()), jnp.asarray(w)], [cdense, wt], rng)
        want = [want[0], np.asarray(want[1]).reshape(2, 2, 2, c, 4)
                .transpose(3, 4, 0, 1, 2)]
    else:  # instance_norm, chunks of 5 slots
        g = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
        b = (0.1 * rng.standard_normal(c)).astype(np.float32)
        want, got = _vjp_pair(
            lambda x, gg, bb: J.instance_norm(x, occ_j, gg, bb),
            lambda x, gg, bb: T.instance_norm(x, occ_t, gg, bb, chunk=5),
            [bj, jnp.asarray(g), jnp.asarray(b)], [bt, _t(g), _t(b)], rng)
    for w_, g_ in zip(want, got):
        _close(w_, g_)


def test_brick_ops_backward_repeats_bitwise():
    """Two backwards of a bricked conv + norm + brick tap, under
    deterministic algorithms, give bitwise equal gradients."""
    s = _scene()
    st, tt, rng = s["st"], s["tt"], s["rng"]
    occ = T.occupancy(tt, st, s["lt"].valid)
    w = _t(rng.standard_normal((5, 6, 3, 3, 3)).astype(np.float32) * 0.2)
    feats = _t(s["feats"])
    grads = []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            f, ww = feats.clone().requires_grad_(), w.clone().requires_grad_()
            b = T.scatter_rows(f, tt, st)
            y = T.instance_norm(T.conv_same(b, ww, occ, tt, st, chunk=7),
                                occ, torch.ones(5), torch.zeros(5))
            rows = T.gather_rows(y, tt, st, s["lt"].valid)
            (rows * rows).sum().backward()
            grads.append((f.grad, ww.grad))
    finally:
        torch.use_deterministic_algorithms(prev)
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert float(grads[0][0][0, int(s["lt"].count[0]):].abs().max()) == 0.0


def test_bricked_batch_must_split_into_single_scenes():
    """A bricked batch of two scenes with grad_accum_steps 1 raises, naming
    both settings; with 2 it trains."""
    host = collate(train_scenes(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    for accum in (1, 2):
        cfg = apply_overrides(Config(), SMALL_OVERRIDES + BRICKED + [
            f"trainer.grad_accum_steps={accum}",
            "trainer.train_split_metrics=false"])
        state = init_state(cfg, device="cpu")
        step = make_train_step(cfg, make_criterion(cfg), device="cpu")
        if accum == 1:
            with pytest.raises(ValueError, match="grad_accum_steps") as e:
                step(state, host.device)
            assert "data.batch_size" in str(e.value)
            continue
        losses, _ = step(state, host.device)
        assert np.isfinite(float(losses["loss"])) and state.step == 1


def test_bricked_remat_backbone_matches_no_remat():
    """`model.remat_backbone=true` on bricked: the brick tables are built
    again in the recompute, and the loss and every gradient equal those
    of the step that keeps the backbone's activations."""
    host = collate(one_scene(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    grads = []
    for remat in ("false", "true"):
        cfg = apply_overrides(Config(), SMALL_OVERRIDES + BRICKED + [
            f"model.remat_backbone={remat}",
            "trainer.train_split_metrics=false"])
        state = init_state(cfg, device="cpu")
        losses, _ = make_train_step(cfg, make_criterion(cfg), "cpu")(
            state, host.device)
        grads.append((float(losses["loss"]), {
            k: p.grad for k, p in state.model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, rtol=1e-6, atol=1e-7, msg=k)


def test_brick_overflow_skips_the_update():
    """More occupied bricks than model.brick_capacity: the step is counted
    as an overflow and skipped (parameters and schedule stay), where the
    JAX package would train on the voxels it dropped."""
    host = collate(one_scene(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + BRICKED[:2] + [
        "model.brick_capacity=4", "trainer.train_split_metrics=false"])
    state = init_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses, _ = make_train_step(cfg, make_criterion(cfg), "cpu")(
        state, host.device)
    assert int(losses["batch_overflow"]) == 1 and state.step == 1
    assert state.scheduler.last_epoch == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------------ resume


_TRACED = {}  # repr(model config) -> (init shapes, model, batch)


def jax_variables_like(j_cfg, seed=0):
    """Random Flax params and buffers of the JAX Mask3D of `j_cfg`, their
    shapes from `jax.eval_shape` of its init (traced, not compiled, once
    per model config), and the model and example batch it was traced
    on."""
    from mask3d_tpu.sparse import build_sparse_batch as j_build
    from mask3d_tpu.train.loop import _sb_kwargs, level_capacities, \
        make_model

    key = repr((j_cfg.model, j_cfg.data, j_cfg.general.num_targets))
    if key not in _TRACED:
        dev = JCollate(point_bucket_multiple=BUCKET)(
            one_scene(j_make)).device
        model = make_model(j_cfg)
        caps = level_capacities(j_cfg, dev.coords.shape[1])

        def init():
            sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                         **_sb_kwargs(j_cfg, dev.grid_dims))
            return model.init(
                {"params": jax.random.PRNGKey(0),
                 "sample": jax.random.PRNGKey(1)}, sb, dev.feats,
                dev.coords.astype(jnp.float32), False,
                grid_dims=dev.grid_dims)

        _TRACED[key] = (jax.eval_shape(init), model, dev)
    shapes, model, dev = _TRACED[key]
    rng = np.random.default_rng(seed)

    def fill(x):
        return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(fill, dict(shapes)), model, dev


def write_jax_checkpoint(path, j_cfg, steps=2, seed=0):
    """A JAX package TrainState after `steps` optax updates of `j_cfg`'s
    optimizer on seeded random gradients, written by the JAX package's
    `save_checkpoint`. Returns (variables after `steps` updates, the
    state, the optimizer, a gradient maker)."""
    from mask3d_tpu.train.checkpoint import save_checkpoint
    from mask3d_tpu.train.loop import TrainState, make_optimizer

    variables, _, _ = jax_variables_like(j_cfg, seed)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(j_cfg)
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed + 1)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32)), params)

    import optax

    update = jax.jit(tx.update)
    for _ in range(steps):
        updates, opt_state = update(grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
    state = TrainState(step=jnp.asarray(steps, jnp.int32), params=params,
                       buffers=variables["buffers"], opt_state=opt_state,
                       rng=jax.random.PRNGKey(5))
    save_checkpoint(str(path), state, epoch=1)
    return state, tx, update, grads


RESUME_CASES = {
    "adamw": ["scheduler.gamma=0.9"],
    "adam": ["optimizer.name=adam", "scheduler.gamma=0.9"],
    "freeze_backbone": ["general.freeze_backbone=true",
                        "scheduler.gamma=0.9"],
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_jax_optimizer_state(case, tmp_path):
    """A JAX TrainState after two updates, resumed by the port and stepped
    once on the third gradient, against JAX's third update: parameters
    within 1e-5 (relative to each leaf's max), the lr of the third update
    and the step equal."""
    import optax

    ov = ["optimizer.lr=0.001"] + RESUME_CASES[case]
    j_cfg = j_apply(small_config(), ov)
    path = tmp_path / "last-epoch.ckpt"
    state, tx, update, grads = write_jax_checkpoint(path, j_cfg)
    g3 = grads()
    updates, _ = update(g3, state.opt_state, state.params)
    want = bridge.from_flax({"params": flax_to_numpy(
        optax.apply_updates(state.params, updates))})

    cfg = apply_overrides(Config(), SMALL_OVERRIDES + ov)
    p_state = init_state(cfg, seed=3, device="cpu")
    _, meta = ckpt.load_checkpoint(str(path), p_state.model, p_state,
                                   seed=cfg.general.seed)
    assert meta["epoch"] == 1 and p_state.step == 2
    lr3 = 0.001 * 0.9 ** 2  # exponential decay at the schedule's count 2
    for group in p_state.optimizer.param_groups:
        np.testing.assert_allclose(group["lr"], lr3, rtol=1e-6)
    grad = bridge.from_flax({"params": flax_to_numpy(g3)})
    trained = {id(p) for g in p_state.optimizer.param_groups
               for p in g["params"]}
    for name, p in p_state.model.named_parameters():
        if id(p) in trained:
            p.grad = grad[name].clone()
    if case == "freeze_backbone":
        assert not any(n.startswith("backbone.") and id(p) in trained
                       for n, p in p_state.model.named_parameters())
    p_state.optimizer.step()
    p_state.scheduler.step()
    for name, p in p_state.model.named_parameters():
        ref = want[name]
        err = float((p.detach() - ref).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref.abs().max())), (name, err)


def test_resume_refuses_what_it_cannot_resume(tmp_path):
    """A JAX file of params only, and a file of neither format, raise."""
    from flax import serialization

    j_cfg = small_config()
    variables, _, _ = jax_variables_like(j_cfg)
    bare = tmp_path / "params.ckpt"
    bare.write_bytes(serialization.to_bytes(variables))
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    state = init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="optimizer state"):
        ckpt.load_checkpoint(str(bare), state.model, state)
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\x93\x01\x02\x03")  # a msgpack array
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_checkpoint(str(junk), state.model, state)


# ------------------------------------------------------- measure phases


def test_measure_model_phases_names_match_jax():
    """The port's segments: "sparse_context_build", the JAX model's sown
    phase markers as `model_forward_<name>` (in the forward's order) and
    `model_forward_final_mask_module`, each recorded once, non-negative."""
    from mask3d_tpu.sparse import build_sparse_batch as j_build
    from mask3d_tpu.train.loop import _sb_kwargs, level_capacities
    from mask3d_tpu_torch.train.loop import measure_model_phases
    from mask3d_tpu_torch.utils import meter

    j_cfg = small_config()
    variables, model, dev = jax_variables_like(j_cfg)
    caps = level_capacities(j_cfg, dev.coords.shape[1])

    def apply(v):
        sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                     **_sb_kwargs(j_cfg, dev.grid_dims))
        return model.apply(v, sb, dev.feats, dev.coords.astype(jnp.float32),
                           True, grid_dims=dev.grid_dims,
                           mutable=["intermediates"])[1]

    # the model's own markers (the backbone's nested ones aside)
    sown = [k for k, v in jax.eval_shape(apply, variables)[
        "intermediates"].items() if not hasattr(v, "items")]
    want = (["sparse_context_build"]
            + [f"model_forward_{n}" for n in sown]
            + ["model_forward_final_mask_module"])

    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    state = init_state(cfg, device="cpu")
    host = collate(one_scene(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    meter.reset()
    segs = measure_model_phases(cfg, state.model, host.device, reps=1,
                                device="cpu")
    stats = meter.get_statistics()
    # eval_shape returns the markers sorted by name: compare as sets, and
    # the port's order with the forward's
    assert sorted(stats) == sorted(want), (list(stats), want)
    assert list(stats) == (
        ["sparse_context_build"]
        + [f"model_forward_{n}" for n in ("backbone_part1", "backbone_part2",
                                          "pos_enc", "queries")]
        + [f"model_forward_decoder_{d}" for d in range(2)]
        + ["model_forward_final_mask_module"]), list(stats)
    assert list(segs) == list(stats)[1:]
    assert all(s["count"] == 1 and s["min"] >= 0.0 for s in stats.values())
    assert state.model.training  # the caller's mode is kept
