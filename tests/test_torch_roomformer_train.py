"""Training and the engine of the RoomFormer baseline: one train step's
loss and gradients against `jax.value_and_grad` on carried weights, the
engine's AdamW against `optax.adamw` from a JAX engine checkpoint's
moments, that checkpoint's evaluation against JAX's, and the port engine
end to end on the CPU (fit, evaluate, resume, the entry)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mask3d_tpu.baseline import criterion2d as j_crit
from mask3d_tpu.baseline import roomformer as jrf
from mask3d_tpu_torch.baseline import criterion2d as t_crit
from mask3d_tpu_torch.baseline import engine
from mask3d_tpu_torch.baseline import roomformer as trf
from tests.torch_roomformer import TINY, floorplan_targets, \
    random_flax_params
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

LOSS_TOL = 1e-5  # relative
GRAD_TOL = 1e-4  # times max(1, max |JAX leaf|)
ADAMW_TOL = 1e-6
PROB_TOL = 1e-4
# the engine's model in these tests (the JAX engine test's sizes,
# tests/test_roomformer.py:243-291): RoomFormer defaults otherwise
ENGINE = dict(num_polys=3, num_queries=12, d_model=32, enc_layers=1,
              dec_layers=2)


def _grads_by_port_name(tree):
    return trf.flax_to_state_dict(tree["params"])


def test_train_step_loss_and_gradients_match_jax():
    """Criterion with the raster loss; every gradient leaf, the ones the
    detached reference points leave at zero included."""
    jm = jrf.RoomFormer(**TINY)
    params = random_flax_params(jm, (1, 64, 64, 1), seed=7)
    rng = np.random.default_rng(8)
    density = rng.random((2, 64, 64, 1)).astype(np.float32)
    tg = floorplan_targets(rng, 2, 3, 4, n_valid=[2, 1])
    crit = j_crit.RoomFormerCriterion(raster_res=16)

    def loss_fn(p):
        return crit(jm.apply(p, density),
                    {k: jnp.asarray(v) for k, v in tg.items()})["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = _grads_by_port_name(jax.device_get(grads))

    model = trf.load_flax(trf.RoomFormer(**TINY), params)
    with torch.backends.mkldnn.flags(enabled=False):
        losses = t_crit.RoomFormerCriterion(raster_res=16)(
            model(torch.from_numpy(density)),
            {k: torch.from_numpy(v) for k, v in tg.items()})
        losses["loss"].backward()
    np.testing.assert_allclose(float(losses["loss"].detach()), float(loss),
                               rtol=LOSS_TOL)
    worst = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[name].numpy()
        worst[name] = float(np.abs(g.numpy() - w).max()) / max(
            1.0, float(np.abs(w).max()))
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    assert float(want["decoder.1.cross_attn.sampling_offsets.weight"].abs()
                 .max()) > 0


class Floorplans:
    """In-memory FloorplanDataset: rectangle rooms drawn as walls
    (tests/test_roomformer.py's SyntheticFloorplans) on 128 x 128 maps
    (the polygons stay in the 256 frame; the model takes any size)."""

    def __init__(self, n=2, qp=4):
        from mask3d_tpu_torch.baseline.poly_ops import pad_polygons

        self.items = []
        for i in range(n):
            polys = [np.array([[40, 40], [120, 40], [120, 120], [40, 120]]),
                     np.array([[140, 60], [220, 60], [220, 180],
                               [140, 180]]) + i]
            density = np.zeros((128, 128, 1), np.float32)
            for p in (q // 2 for q in polys):
                y0, y1 = p[:, 1].min(), p[:, 1].max()
                x0, x1 = p[:, 0].min(), p[:, 0].max()
                density[y0:y1, [x0, x1], 0] = 1
                density[[y0, y1], x0:x1, 0] = 1
            self.items.append({"density": density,
                               "targets": pad_polygons(polys, qp),
                               "gt_polys": polys, "scene": f"synt_{i}"})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _trainer(tmp_path, name, **kw):
    ds = Floorplans()
    return engine.FloorplanTrainer(
        "unused", save_dir=str(tmp_path / name), batch_size=2,
        device="cpu", datasets={"train": ds, "validation": ds, "test": ds},
        **{**ENGINE, "max_epochs": 2, **kw})


def test_engine_batches_follow_the_jax_engines_order(tmp_path):
    """`_batches` shuffles with `np.random.default_rng(seed)` as the JAX
    engine does (engine.py:111-118): a port run sees JAX's batches."""
    tr = _trainer(tmp_path, "order")
    tr.datasets["train"] = Floorplans(n=5)
    rng = np.random.default_rng(1)  # the trainer's seed
    for _ in range(2):
        order = np.arange(5)
        rng.shuffle(order)
        want = [[f"synt_{i}" for i in order[s:s + 2]] for s in (0, 2, 4)]
        assert [b["scenes"] for b in tr._batches("train", True)] == want


def test_engine_fit_evaluate_and_resume(tmp_path):
    tr = _trainer(tmp_path, "run")
    tr.fit()
    last = os.path.join(str(tmp_path / "run"), "last-epoch.ckpt")
    assert os.path.exists(last)
    assert os.path.exists(os.path.join(str(tmp_path / "run"),
                                       "best_room_f1.ckpt")) or \
        tr.ckpt_mgr.best_values["room_f1"] == -np.inf
    metrics = tr.evaluate("test")
    for k in ("room", "corner", "angle"):
        for m in ("prec", "rec", "f1"):
            assert np.isfinite(metrics[f"{k}_{m}"])
    assert len(tr.timings["forward"]) == 1 and tr.state.step == 2

    again = _trainer(tmp_path, "resumed", max_epochs=3)
    again.load(last)
    assert again.epoch == 2 and again.state.step == 2
    for a, b in zip(tr.model.state_dict().values(),
                    again.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(tr.model.parameters(), again.model.parameters()):
        sa, sb = tr.optimizer.state[p], again.optimizer.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    again.fit()  # the third epoch only
    assert again.state.step == 3 and again.epoch == 2
    assert again.evaluate("test").keys() == metrics.keys()


@pytest.fixture(scope="module")
def jax_engine_checkpoint(tmp_path_factory):
    """A JAX engine checkpoint, `(params, opt_state)` as engine.py:133-139
    saves it, with random weights and AdamW moments at count 3; and the
    JAX model."""
    from optax._src.base import EmptyState
    from optax._src.transform import ScaleByAdamState

    from mask3d_tpu.train.checkpoint import save_checkpoint

    jm = jrf.RoomFormer(**ENGINE)
    params = random_flax_params(jm, (1, 128, 128, 1), seed=23)
    rng = np.random.default_rng(12)
    mu = jax.tree_util.tree_map(
        lambda x: (1e-3 * rng.normal(size=x.shape)).astype(np.float32),
        params)
    nu = jax.tree_util.tree_map(
        lambda x: (1e-6 * rng.random(x.shape)).astype(np.float32), params)
    opt_state = (ScaleByAdamState(count=jnp.asarray(3, jnp.int32), mu=mu,
                                  nu=nu), EmptyState(), EmptyState())
    # the structure optax.adamw builds
    ref = optax.adamw(2e-4, weight_decay=1e-4).init(params)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(opt_state)
    path = str(tmp_path_factory.mktemp("jax_engine") / "last-epoch.ckpt")
    save_checkpoint(path, (params, opt_state), epoch=4,
                    metadata={"room_f1": 0.0})
    return path, jm, params, opt_state


def test_jax_engine_checkpoint_adamw_update_matches_optax(
        jax_engine_checkpoint, tmp_path):
    """The moments and count carry into the port's AdamW, and one update
    from them with the same gradients gives optax.adamw's parameters."""
    path, _, params, opt_state = jax_engine_checkpoint
    tr = _trainer(tmp_path, "resume_jax")
    tr.load(path)
    assert tr.epoch == 5 and tr.state.step == 3
    rng = np.random.default_rng(13)
    grads = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    tx = optax.adamw(2e-4, weight_decay=1e-4)

    @jax.jit
    def update(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u)

    want = trf.flax_to_state_dict(
        jax.device_get(update(params, opt_state, grads))["params"])
    mu = trf.flax_to_state_dict(opt_state[0].mu["params"])
    g_port = trf.flax_to_state_dict(grads["params"])
    for name, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        assert float(st["step"]) == 3
        assert torch.equal(st["exp_avg"], mu[name])
        p.grad = g_port[name].clone()
    tr.optimizer.step()
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=ADAMW_TOL, err_msg=name)


def test_jax_engine_checkpoint_evaluates_to_jax_metrics(
        jax_engine_checkpoint, tmp_path):
    """The port engine on the JAX engine's checkpoint gives JAX's corner
    probabilities and coordinates within 1e-4 and, through them, the
    floorplan metrics that JAX's `evaluate` computes (its own polygon
    extraction and evaluator on an eager-free jitted apply)."""
    from mask3d_tpu.baseline.floorplan_eval import FloorplanEvaluator
    from mask3d_tpu.baseline.poly_ops import extract_room_polygons

    path, jm, params, _ = jax_engine_checkpoint
    tr = _trainer(tmp_path, "eval_jax")
    tr.load(path, resume=False)
    batch = next(tr._batches("test", shuffle=False))
    out = jax.jit(jm.apply)(params, jnp.asarray(batch["density"]))
    probs = np.asarray(jax.nn.sigmoid(out.pred_logits))
    coords = np.asarray(out.pred_coords)
    got_p, got_c = tr.infer(batch["density"])
    np.testing.assert_allclose(got_p, probs, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(got_c, coords, rtol=0, atol=PROB_TOL)
    # every decision is clear of the two packages' difference: no
    # probability at the 0.5 threshold, no corner at a rounding boundary
    assert np.abs(probs - 0.5).min() > 10 * np.abs(got_p - probs).max()
    frac = np.abs((coords * 255) % 1 - 0.5)
    assert frac.min() > 10 * 255 * np.abs(got_c - coords).max()
    ev = FloorplanEvaluator()
    n_polys = 0
    for i in range(len(batch["scenes"])):
        polys = extract_room_polygons(probs[i], coords[i])
        n_polys += len(polys)
        ev.evaluate_scene(polys, batch["gt_polys"][i])
    assert n_polys > 0
    assert tr.evaluate("test") == ev.summarize()


def test_engine_main_eval_on_the_cpu_and_refuses_cuda(tmp_path,
                                                      monkeypatch):
    """`main eval --device cpu` on written Structured3D scenes (the full
    default model, a port checkpoint, the bridge and the .las export), and
    the CUDA default raising where there is no card."""
    from mask3d_tpu_torch.data.synthetic import write_floorplan_scene

    root = str(tmp_path / "stru3d")
    rng = np.random.default_rng(0)
    for scene in ("scene_00000", "scene_03000", "scene_03250"):
        write_floorplan_scene(root, scene, rng, num_rooms_x=2,
                              num_rooms_y=2, room_size=12, height=6)
    save = str(tmp_path / "saved")
    tr = engine.FloorplanTrainer(root, save_dir=save, device="cpu")
    tr.ckpt_mgr.save_last(tr.state, 0, {})
    las = str(tmp_path / "las")
    _, metrics = engine.main([
        "eval", "--data_root", root, "--save_dir", save, "--device", "cpu",
        "--checkpoint", os.path.join(save, "last-epoch.ckpt"),
        "--export_las", "--las_dir", las])
    assert {"room_f1", "corner_f1", "angle_f1"} <= set(metrics)
    assert any(k.startswith("bridge_") for k in metrics)
    assert os.listdir(las) and os.path.exists(
        os.path.join(las, "test_scene_03250.las"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.main(["eval", "--data_root", root])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.FloorplanTrainer(root, save_dir=save)
