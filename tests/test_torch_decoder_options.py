"""The decoder options of the port against the JAX package's Mask3D at
`SMALL_KW` (tests/test_model.py:41) on the 16^3 scenes of
tests/test_model.py:203-264, `dense` backbone, the same numpy-seeded
weights on both sides: learned queries with the level embedding, pre-norm
layers and a set of layers a round; FPS queries with the backbone's rows as
their features; random positions; random normal features and positions.
The random draws come from numpy and are handed to `jax.random.uniform` /
`jax.random.normal` and to `torch.rand` / `torch.randn` in call order. One
gradient case: the first combination, the gradient of a fixed weighted sum
of every output on every decoder leaf.

The JAX backbone runs once and its outputs feed both decoders: inside the
JAX Mask3D through a parameter-free stand-in for `Res16UNet14A` (patched
into `mask3d_tpu.models.mask3d.BACKBONES` for the JAX calls only), so each
combination compiles the decoder alone; in the port through its
backbone's forward. The port's own backbone is held to JAX's in a test of
its own."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mask3d_tpu.models.mask3d as j_mask3d_mod
from mask3d_tpu.models.backbone import Res16UNet14A as JRes16UNet14A
from mask3d_tpu.models.mask3d import Mask3D as JMask3D
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.mask3d import Mask3D as TMask3D
from tests.test_model import SMALL_KW
from tests.test_torch_bottleneck import fill, init_shapes, j_batch, scene, \
    t_batch
from tests.torch_parity import assert_scaled_close
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

COMBOS = {
    "learned_level_embed_pre_norm_unshared": dict(
        non_parametric_queries=False, use_level_embed=True, pre_norm=True,
        shared_decoder=False),
    "np_features": dict(use_np_features=True),
    "random_queries": dict(non_parametric_queries=False,
                           random_queries=True),
    "random_query_both_normal": dict(non_parametric_queries=False,
                                     random_query_both=True,
                                     random_normal=True),
}
# max |diff| / max(1, std) of every output, port against JAX in fp32
TOL = 1e-4
# ||g_port - g_jax|| / max(||g_jax||, 1e-4 of the largest leaf norm) per
# decoder leaf (tests/test_torch_train_step.py::grad_errors); the
# attention's K biases have a true gradient of 0 (they shift all of a
# query's logits alike), so both sides return rounding noise there, held
# to K_BIAS_TOL of that floor (measured 4.8e-4 at most)
GRAD_TOL = 1e-4
K_BIAS_TOL = 1e-3


class Draws:
    """Random draws from numpy, handed out in call order: each
    `jax.random.uniform` / `normal` call of a shape in `shapes` (the
    queries' [B, Q, D] and [B, Q, 2D]; other calls, the initializers',
    draw from JAX) records one, each `torch.rand` / `randn` call takes the
    next, which must be of the same kind and shape."""

    def __init__(self, seed, shapes=()):
        self.rng = np.random.default_rng(seed)
        self.shapes = {tuple(s) for s in shapes}
        self.drawn = []
        self.i = 0
        self.real = {"uniform": jax.random.uniform,
                     "normal": jax.random.normal}

    def _jax(self, kind, key, shape, *a, **k):
        if tuple(shape) not in self.shapes:
            return self.real[kind](key, shape, *a, **k)
        draw = (self.rng.random(shape) if kind == "uniform"
                else self.rng.standard_normal(shape))
        self.drawn.append((kind, draw.astype(np.float32)))
        return jnp.asarray(self.drawn[-1][1])

    def _torch(self, kind, size, device=None):
        want, draw = self.drawn[self.i]
        assert want == kind and tuple(draw.shape) == tuple(size), (
            want, kind, draw.shape, size)
        self.i += 1
        return torch.from_numpy(draw).to(device)

    def patch(self, mp):
        mp.setattr(jax.random, "uniform",
                   lambda *a, **k: self._jax("uniform", *a, **k))
        mp.setattr(jax.random, "normal",
                   lambda *a, **k: self._jax("normal", *a, **k))
        mp.setattr(torch, "rand", lambda size, *a, generator=None,
                   device=None, **k: self._torch("uniform", size, device))
        mp.setattr(torch, "randn", lambda size, *a, generator=None,
                   device=None, **k: self._torch("normal", size, device))


@pytest.fixture(scope="module")
def backbone():
    """The scene, the backbone's numpy weights and JAX's backbone outputs
    on them: {"rows", "map0".."map4", "grid"}."""
    s = scene()
    coords, counts, dims, grid = s
    params = fill(init_shapes(JRes16UNet14A(in_channels=1,
                                            conv1_kernel_size=3), *s), 0)
    jb = JRes16UNet14A(in_channels=1, conv1_kernel_size=3, impl="dense")

    def fwd(p, c, n, d):
        sb = j_batch(c, n, d, grid, "dense")
        rows, maps, g = jb.apply({"params": p}, jnp.ones(c.shape[:2] + (1,)),
                                 sb, grid, True)
        return {"rows": rows, "grid": g,
                **{f"map{i}": m for i, m in enumerate(maps)}}

    outs = jax.jit(fwd)(params, coords, counts, dims)
    return s, params, jax.tree_util.tree_map(np.asarray, outs)


class StandIn(JRes16UNet14A):
    """A parameter-free `Res16UNet14A` whose call returns the outputs held
    in its `backbone_outs` collection (jit arguments, not constants)."""

    def __call__(self, feats, sb, grid_dims=None, return_grid=False):
        def get(name):
            return self.get_variable("backbone_outs", name)
        return get("rows"), [get(f"map{i}") for i in range(5)], get("grid")


def loss_weights(coords):
    """Fixed numpy weights of every class logit and mask logit of the
    first combination's outputs, whose weighted sum is differentiated."""
    rng = np.random.default_rng(9)
    n_out = SMALL_KW["num_decoders"] * 4 + 1
    b, n, q = coords.shape[0], coords.shape[1], SMALL_KW["num_queries"]
    wc = rng.normal(size=(n_out, b, q, SMALL_KW["num_classes"] + 1))
    wm = rng.normal(size=(n_out, b, n, q)) * 1e-2
    return wc.astype(np.float32), wm.astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs(backbone):
    """{combo: (variables, eval outputs, grads or None, draws)} of JAX's
    Mask3D: the first combination on numpy weights with the gradients of
    the weighted sum of `loss_weights`; the others on JAX's own initial
    weights, made in the traced forward (`apply` with the params
    collection mutable: one trace each). Each function is traced in turn
    (the draws recorded as it is), then all are compiled at once in
    threads (XLA's compiler releases the interpreter lock), at XLA's
    backend optimization level 0: the same functions, compiled faster;
    every comparison here is of fp32 values at 1e-4."""
    (coords, counts, dims, grid), _, outs = backbone
    rngs = {"params": jax.random.PRNGKey(0),
            "queries": jax.random.PRNGKey(2)}
    consts = {"backbone_outs": {"backbone": outs}}
    sb = jax.jit(lambda c, n, d: j_batch(c, n, d, grid, "dense"))(
        coords, counts, dims)
    # the backbone's outputs are arguments: as constants XLA would fold
    # the pooled pyramid over them at compile time
    args = (consts, sb, jnp.ones(coords.shape[:2] + (1,)),
            jnp.asarray(coords, jnp.float32))
    runs, lowered = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mask3d_mod, "BACKBONES",
                   {**j_mask3d_mod.BACKBONES, "Res16UNet14A": StandIn})
        b, q, d = coords.shape[0], SMALL_KW["num_queries"], \
            SMALL_KW["hidden_dim"]
        for i, (combo, kw) in enumerate(COMBOS.items()):
            model = JMask3D(**SMALL_KW, **kw, backbone_impl="dense")

            def call(v, c, *a, model=model):
                return model.apply({**v, **c}, *a, True, grid_dims=grid,
                                   rngs={"queries": rngs["queries"]})

            draws = Draws(5, shapes=[(b, q, d), (b, q, 2 * d)])
            with pytest.MonkeyPatch.context() as mp_draws:
                draws.patch(mp_draws)
                if i:
                    def fn(c, *a, model=model):
                        return model.apply(c, *a, True, grid_dims=grid,
                                           rngs=rngs,
                                           mutable=["params", "buffers"])
                    variables, fargs = None, args
                else:
                    variables = fill(jax.eval_shape(lambda c, *a: model.apply(
                        c, *a, True, grid_dims=grid, rngs=rngs,
                        mutable=["params", "buffers"])[1], *args), 1)
                    wc, wm = loss_weights(coords)

                    def loss(p, *a, call=call, variables=variables):
                        out = call({**variables, "params": p}, *a)
                        return (jnp.sum(out.aux_pred_class * wc)
                                + jnp.sum(out.aux_pred_masks * wm)), out

                    fn = jax.value_and_grad(loss, has_aux=True)
                    fargs = (variables["params"],) + args
                lowered.append((jax.jit(fn).lower(*fargs), fargs))
            runs[combo] = (variables, draws)
    with ThreadPoolExecutor(len(lowered)) as ex:
        compiled = list(ex.map(lambda lo: lo[0].compile(
            compiler_options={"xla_backend_optimization_level": 0}),
            lowered))
    out = {}
    for (combo, (variables, draws)), exe, (_, fargs) in zip(
            runs.items(), compiled, lowered):
        res = exe(*fargs)
        if variables is None:
            res, variables = res
            variables = jax.tree_util.tree_map(np.asarray, {
                k: variables[k] for k in ("params", "buffers")})
            grads = None
        else:
            (_, res), grads = res
        out[combo] = (variables, res, grads, draws)
    return out


def port_model(kw, backbone, variables):
    """The port's Mask3D on the same weights, its backbone's forward
    replaced by JAX's outputs (the decoder is what is compared here)."""
    _, bb_params, outs = backbone
    model = TMask3D(**SMALL_KW, **kw, backbone_impl="dense")
    tree = {"params": {**variables["params"], "backbone": bb_params},
            "buffers": variables["buffers"]}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    bridge.load_flax(model, tree)
    # and back, every new decoder leaf included
    want, got = (dict(bridge.flatten(t)) for t in (
        tree, bridge.to_flax(model.state_dict())))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    fixed = (torch.from_numpy(outs["rows"]),
             [torch.from_numpy(outs[f"map{i}"]) for i in range(5)],
             torch.from_numpy(outs["grid"]))
    model.backbone.forward = lambda *a, **k: fixed
    return model


def port_run(model, backbone, draws):
    (coords, counts, dims, grid), _, _ = backbone
    sb = t_batch(coords, counts, dims, grid, "dense")
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        out = model(sb, torch.ones(coords.shape[:2] + (1,)),
                    torch.tensor(coords).float(), grid,
                    generator=torch.Generator())
    assert draws.i == len(draws.drawn)
    return out, sb


def test_backbone_feats_match_jax(backbone):
    """The port's own Res16UNet14A on the backbone weights: its rows (a
    Mask3D's `backbone_feats`) and maps against JAX's, within the JAX
    package's own dense-vs-gather tolerance on these scenes
    (tests/test_model.py:232-239): 16^3 scenes put one or two occupied
    cells in some coarse items, where the InstanceNorms amplify rounding
    (tests/torch_parity.py), so the decoder tests feed both decoders
    JAX's backbone outputs."""
    (coords, counts, dims, grid), params, outs = backbone
    tb = TMask3D(**SMALL_KW, backbone_impl="dense").backbone
    tb.load_state_dict(bridge.backbone_from_flax(params), strict=True)
    sb = t_batch(coords, counts, dims, grid, "dense")
    with torch.no_grad():
        rows, maps, g = tb(torch.ones(coords.shape[:2] + (1,)), sb, grid)
    for want, got in [(outs["rows"], rows), (outs["grid"], g)] + [
            (outs[f"map{i}"], maps[i]) for i in range(5)]:
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("combo", list(COMBOS)[1:])
def test_decoder_option_matches_jax_eval(combo, backbone, jax_runs):
    """Every output of the eval forward (TOL) and the FPS positions
    (exact)."""
    kw = COMBOS[combo]
    variables, ref, _, draws = jax_runs[combo]
    model = port_model(kw, backbone, variables).eval()
    with torch.no_grad():
        out, sb = port_run(model, backbone, draws)
    n_draws = {"np_features": 0, "random_queries": 1,
               "random_query_both_normal": 1}[combo]
    assert len(draws.drawn) == n_draws
    valid = sb.levels[0].valid.numpy()
    assert_scaled_close(ref.aux_pred_class, out.aux_pred_class, TOL,
                        f"{combo} aux_pred_class")
    assert_scaled_close(np.asarray(ref.aux_pred_masks)[:, valid],
                        out.aux_pred_masks.numpy()[:, valid], TOL,
                        f"{combo} aux_pred_masks")
    assert out.backbone_feats is model.backbone.forward()[0]
    if ref.sampled_coords is None:
        assert out.sampled_coords is None
    else:
        np.testing.assert_array_equal(np.asarray(ref.sampled_coords),
                                      out.sampled_coords.numpy())


def test_learned_queries_level_embed_pre_norm_unshared_match_jax(
        backbone, jax_runs):
    """The first combination: every output of the eval forward (TOL) and
    the gradient of a fixed weighted sum of them on every decoder leaf
    (GRAD_TOL), the new leaves by name: the learned queries, the level
    embedding and the second round's layers."""
    kw = COMBOS["learned_level_embed_pre_norm_unshared"]
    variables, ref, grads, draws = jax_runs[
        "learned_level_embed_pre_norm_unshared"]
    assert not draws.drawn
    (coords, _, _, _), _, _ = backbone
    weights = loss_weights(coords)
    model = port_model(kw, backbone, variables).eval()
    out, sb = port_run(model, backbone, draws)
    loss = (out.aux_pred_class * torch.from_numpy(weights[0])).sum() \
        + (out.aux_pred_masks * torch.from_numpy(weights[1])).sum()
    loss.backward()
    valid = sb.levels[0].valid.numpy()
    assert_scaled_close(ref.aux_pred_class, out.aux_pred_class, TOL,
                        "aux_pred_class")
    assert_scaled_close(np.asarray(ref.aux_pred_masks)[:, valid],
                        out.aux_pred_masks.detach().numpy()[:, valid], TOL,
                        "aux_pred_masks")
    want = bridge.from_flax({"params": jax.tree_util.tree_map(
        np.asarray, grads)})
    floor = 1e-4 * max(float(v.norm()) for v in want.values())
    errs = {}
    for name, p in model.named_parameters():
        if name.startswith("backbone."):
            continue
        r = want[name].double()
        errs[name] = float((p.grad.double() - r).norm()) / max(
            float(r.norm()), floor)
    k_bias = {k: v for k, v in errs.items() if k.endswith("attn.k.bias")}
    assert len(k_bias) == 2 * 2 * 4 and max(k_bias.values()) <= K_BIAS_TOL
    errs = {k: v for k, v in errs.items() if k not in k_bias}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    for name in ("query_feat", "query_pos", "level_embed",
                 "cross.1_3.attn.q.weight", "ffn.1_0.lin1.weight",
                 "squeeze.1_2.weight"):
        g = dict(model.named_parameters())[name].grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, \
            name
