"""The rest of the port's backbones against the JAX package on the same
numpy-seeded weights and the 16^3 scenes of tests/test_model.py:203-264:
a shallow bottleneck Res16UNet (every LAYERS entry 1) on `dense`, `gather`
and `gather_pallas` (the plain version of its bf16 conv), the z-folded
stages, `SEResUNet14` and `ResUNet14`, the zoo's names, and the squeeze-
excitation gate's mean on every context. (The z-folded ops alone:
tests/test_torch_dense_ops.py; the bridge on the bottleneck's full trees:
tests/test_torch_zoo_bridge.py.)

The JAX side builds its sparse batch and runs its forward under one
`jax.jit` (an eager build compiles each small op alone: 17 s)."""

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.models import MODELS as J_MODELS
from mask3d_tpu.models import resunet as j_resunet
from mask3d_tpu.models.backbone import Res16UNet14A as JRes16UNet14A
from mask3d_tpu.models.backbone import Res16UNet50 as JRes16UNet50
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse import ops as j_ops
from mask3d_tpu.sparse import pallas_conv as j_pallas_conv
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch import models as t_models
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.models.resunet import RESUNETS as T_RESUNETS
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from mask3d_tpu_torch.sparse.sparse_conv import supports
from tests.test_model import make_scene_batch
from tests.torch_parity import assert_scaled_close
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

CAPS = [128, 64, 32, 16]
GRID = tuple((16 >> s,) * 3 for s in range(5))
# max |diff| / max(1, std) of every returned map, port against JAX in fp32
# on the same impl (summation order only)
TOL = 1e-4
# the JAX package's |diff| bounds for a bf16 gather-conv backbone
# (tests/test_pallas_conv.py:169-173), as tests/test_torch_gather_path.py
# holds the port's `gather_pallas` to JAX's
BF16_BOUNDS = dict(mean=5e-3, q999=5e-2, max=0.3)


class JShallowBottleneck(JRes16UNet50):
    LAYERS: Sequence[int] = (1, 1, 1, 1, 1, 1, 1, 1)


TShallowBottleneck = type("ShallowBottleneck", (T_BACKBONES["Res16UNet50"],),
                          dict(LAYERS=(1, 1, 1, 1, 1, 1, 1, 1)))


def fill(shapes, seed):
    """Numpy weights for a Flax parameter tree of ShapeDtypeStructs:
    He-normal kernels, norm scales in [0.5, 1.5] and small random biases
    (non-trivial, so the bridge's mapping of each shows)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        normal = rng.standard_normal(s.shape, dtype=np.float32)
        if name.endswith("kernel"):
            return normal * np.float32(math.sqrt(
                2.0 / math.prod(s.shape[:-1])))
        if name.endswith("scale"):
            return np.float32(0.5) + rng.random(s.shape, dtype=np.float32)
        if name.endswith("bias"):
            return normal * np.float32(0.2)
        return normal

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def scene(n=256, dims=(16, 16, 16), seed=3):
    """(numpy coords, counts, dims, per-level grid dims) of two items."""
    rng = np.random.default_rng(seed)
    coords, counts, d = make_scene_batch(rng, N=n, dims=dims)
    grid = tuple(tuple(max(1, g >> s) for g in dims) for s in range(5))
    return coords, counts, d, grid


def j_batch(coords, counts, dims, grid, impl, caps=CAPS):
    if impl == "dense":
        return j_build(coords, counts, dims, caps, grid_dims=grid,
                       conv1_kernel_size=None, build_block_maps=False,
                       build_pool_parents=False)
    return j_build(coords, counts, dims, caps, grid_dims=grid,
                   conv1_kernel_size=3)


def t_batch(coords, counts, dims, grid, impl, caps=CAPS):
    args = [torch.tensor(a) for a in (coords, counts, dims)]
    if impl == "dense":
        return t_build(*args, caps, grid)
    return t_build(*args, caps, grid, conv1_kernel_size=3,
                   build_block_maps=True, build_pool_parents=True)


def port_forward(model, coords, counts, dims, grid, impl, caps=CAPS):
    sb = t_batch(coords, counts, dims, grid, impl, caps)
    feats = torch.ones(coords.shape[:2] + (1,))
    with torch.no_grad():
        return model(feats, sb, grid), sb


def init_shapes(model, coords, counts, dims, grid, caps=CAPS):
    """The model's Flax parameter tree as ShapeDtypeStructs (traced)."""
    def init(c, n, d):
        feats = jnp.ones(c.shape[:2] + (1,), jnp.float32)
        return model.init(jax.random.PRNGKey(0), feats,
                          j_batch(c, n, d, grid, "gather", caps))
    return jax.eval_shape(init, coords, counts, dims)["params"]


def jax_bf16_conv(feats, weight, nbr_idx, nbr_ok, **_):
    """What the JAX package's Pallas sparse conv computes
    (`pallas_conv.sparse_conv_pallas`: bf16 feats and weights, f32 sums,
    an f32 output) in its XLA gather conv: its interpret mode takes 18 s
    here, and its own fallback (pallas_conv.py:307-310) rounds the output
    to bf16 as well, which the kernel does not."""
    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)
    return j_ops.sparse_conv(bf16(feats), bf16(weight), nbr_idx, nbr_ok)


GP_SCENE = dict(n=1024, dims=(32, 32, 16), seed=5)  # level 0 takes the
GP_CAPS = [512, 256, 128, 64]  # bf16 conv: capacity 1024
# name -> (JAX class, options, the impl JAX runs, scene, capacities)
JAX_CASES = {
    "bottleneck": (JShallowBottleneck, {}, "dense", {}, CAPS),
    "bottleneck_gather_pallas": (JShallowBottleneck, {}, "gather_pallas",
                                 GP_SCENE, GP_CAPS),
    "fold": (JRes16UNet14A, dict(fold_small_stages=True), "dense", {}, CAPS),
    "SEResUNet14": (j_resunet.SEResUNet14, dict(out_channels=8), "dense",
                    {}, CAPS),
    "ResUNet14": (j_resunet.ResUNet14, dict(out_channels=8), "gather", {},
                  CAPS),
}


@pytest.fixture(scope="module")
def jax_runs():
    """{case: (scene, numpy weights, JAX's (out, maps) as numpy)} of
    `JAX_CASES`. Each forward (its sparse batch built inside) is traced in
    turn, then all are compiled at once in threads (XLA's compiler
    releases the interpreter lock) at XLA's backend optimization level 0:
    the same functions, compiled faster. JAX's `gather_pallas` runs its
    Pallas conv's plain form (`jax_bf16_conv`)."""
    lowered, shapes = {}, {}
    for i, (case, (cls, kw, impl, sc, caps)) in enumerate(JAX_CASES.items()):
        s = scene(**sc)
        coords, counts, dims, grid = s
        opts = {k: v for k, v in kw.items() if k != "fold_small_stages"}
        if cls not in shapes:  # a class's tree does not depend on the scene
            shapes[cls] = init_shapes(cls(in_channels=1, conv1_kernel_size=3,
                                          **opts), *s, caps)
        params = fill(shapes[cls], i)
        model = cls(in_channels=1, conv1_kernel_size=3, impl=impl, **kw)

        def fwd(p, c, n, d, model=model, impl=impl, grid=grid, caps=caps):
            sb = j_batch(c, n, d, grid, impl, caps)
            feats = jnp.ones(c.shape[:2] + (1,), jnp.float32)
            return model.apply({"params": p}, feats, sb,
                               *((grid,) if impl == "dense" else ()))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_pallas_conv, "sparse_conv_pallas", jax_bf16_conv)
            lowered[case] = (s, params, jax.jit(fwd).lower(
                params, coords, counts, dims))
    with ThreadPoolExecutor(len(lowered)) as ex:
        exes = dict(zip(lowered, ex.map(lambda lo: lo[2].compile(
            compiler_options={"xla_backend_optimization_level": 0}),
            lowered.values())))
    out = {}
    for case, (s, params, _) in lowered.items():
        res, maps = exes[case](params, *s[:3])
        out[case] = (s, params, (np.asarray(res),
                                 [np.asarray(m) for m in maps]))
    return out


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_shallow_bottleneck_matches_jax(impl, jax_runs):
    """Every map of the port's dense and gather forwards against JAX's
    dense one, within the JAX package's own tolerance between its two fp32
    impls of this backbone on these scenes (tests/test_model.py:287-289):
    the 16^3 scenes leave one or two occupied cells in some coarse items,
    where the InstanceNorms amplify rounding (tests/torch_parity.py)."""
    s, params, (_, ref) = jax_runs["bottleneck"]
    tm = TShallowBottleneck(in_channels=1, conv1_kernel_size=3, impl=impl)
    tm.load_state_dict(bridge.backbone_from_flax(params), strict=True)
    (out, maps, grid), sb = port_forward(tm, *s, impl)
    assert [m.shape[-1] for m in maps] == [1024] * 5
    assert out is maps[-1]
    for i, (r, g) in enumerate(zip(ref, maps)):
        valid = sb.levels[4 - i].valid.numpy()
        np.testing.assert_allclose(g.numpy()[valid], r[valid], rtol=2e-3,
                                   atol=2e-3, err_msg=f"{impl} map {i}")
    assert (grid is None) == (impl != "dense")


def test_shallow_bottleneck_gather_pallas_within_bf16_bounds(jax_runs):
    """`gather_pallas` on a scene whose level 0 takes the bf16 conv
    (capacity 1024): the port's plain version against JAX's gather_pallas
    with the Pallas conv's function in XLA (`jax_bf16_conv`) on the same
    weights, within BF16_BOUNDS (both round their conv inputs to bf16, and
    an input a rounding apart can round to two bf16 values)."""
    s, params, (_, ref) = jax_runs["bottleneck_gather_pallas"]
    tm = TShallowBottleneck(in_channels=1, conv1_kernel_size=3,
                            impl="gather_pallas")
    tm.load_state_dict(bridge.backbone_from_flax(params), strict=True)
    (_, maps, _), sb = port_forward(tm, *s, "gather_pallas", GP_CAPS)
    assert supports(sb.levels[0].capacity)
    for i, (r, g) in enumerate(zip(ref, maps)):
        valid = sb.levels[4 - i].valid.numpy()
        diff = np.abs(g.numpy()[valid] - r[valid])
        stats = dict(mean=diff.mean(), q999=np.quantile(diff, 0.999),
                     max=diff.max())
        assert all(stats[k] < v for k, v in BF16_BOUNDS.items()), (i, stats)


def test_fold_small_stages_matches_jax_and_unfolded(jax_runs):
    """Stage 1 in the z-folded layout against JAX's folded forward, within
    the JAX package's own folded-vs-unfolded tolerance, 2e-4
    (tests/test_model.py:222-223; JAX's gap on these weights: 1.75e-4),
    and against the port's unfolded forward on the same state_dict within
    twice that (each differs from JAX's folded forward by up to 2e-4;
    measured 2.7e-4)."""
    s, params, (out_j, _) = jax_runs["fold"]
    sd = bridge.backbone_from_flax(params)
    outs = {}
    for fold in (True, False):
        tm = T_BACKBONES["Res16UNet14A"](in_channels=1, conv1_kernel_size=3,
                                         fold_small_stages=fold)
        tm.load_state_dict(sd, strict=True)
        (outs[fold], _, _), sb = port_forward(tm, *s, "dense")
    valid = sb.levels[0].valid.numpy()
    np.testing.assert_allclose(outs[True].numpy()[valid], out_j[valid],
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(outs[True], outs[False], rtol=4e-4,
                               atol=4e-4)


@pytest.mark.parametrize("name", ["SEResUNet14", "ResUNet14"])
def test_resunet_matches_jax(name, jax_runs):
    """The ResUNet head's logits and every map against JAX's (TOL), the
    squeeze-excitation gates included (on `dense`; `ResUNet14` on
    `gather`, whose padding rows hold the head's bias), and the weights
    back through `bridge.backbone_to_flax` leaf for leaf."""
    s, params, (out_j, ref) = jax_runs[name]
    impl = JAX_CASES[name][2]
    tm = T_RESUNETS[name](in_channels=1, out_channels=8, conv1_kernel_size=3,
                          impl=impl)
    tm.load_state_dict(bridge.backbone_from_flax(params), strict=True)
    back = bridge.backbone_to_flax(tm.state_dict())
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    (out, maps), sb = port_forward(tm, *s, impl)
    assert out is maps[-1] and out.shape[-1] == 8
    assert [m.shape[1] for m in maps] == [32, 64, 128, 256]
    for i, (r, g) in enumerate(zip(ref, maps)):
        rows = (np.ones(g.shape[:2], bool) if impl == "gather"
                else sb.levels[3 - i].valid.numpy())
        assert_scaled_close(r[rows], g.numpy()[rows], TOL,
                            f"{name} {impl} map {i}")
    assert len(tm.se) == (6 if name.startswith("SE") else 0)


def test_zoo_names_match_jax(capsys):
    assert sorted(t_models.MODELS) == sorted(J_MODELS)
    assert sorted(T_RESUNETS) == sorted(j_resunet.RESUNETS)
    assert t_models.load_model("ResUNet14") is t_models.MODELS["ResUNet14"]
    assert t_models.load_model("Res16UNet101") in t_models.get_models()
    assert t_models.load_model("NoSuchNet") is None
    assert "SEResUNet50" in capsys.readouterr().out
    for name, cls in t_models.MODELS.items():
        jcls = J_MODELS[name]
        assert tuple(cls.PLANES) == tuple(jcls.PLANES), name
        assert tuple(cls.LAYERS) == tuple(jcls.LAYERS), name
        assert (cls.BLOCK, cls.EXPANSION, cls.SE, cls.INIT_DIM) == (
            jcls.BLOCK, jcls.EXPANSION, jcls.SE, jcls.INIT_DIM), name


def test_global_mean_agrees_across_contexts():
    """The squeeze-excitation gate's per-item mean over occupied cells on
    one scene (B=1, the bricked context's batch) at levels 0 and 1: the
    dense grid's, the rows' (`gather`) and the bricks' (8^3 bricks at
    level 0) agree."""
    from mask3d_tpu_torch.models.backbone import _BrickCtx, _DenseCtx, \
        _GatherCtx

    coords, counts, dims, grid = scene()
    one = (coords[:1], counts[:1], dims[:1], grid)
    dense = _DenseCtx(t_batch(*one, "dense"), grid)
    gather = _GatherCtx(t_batch(*one, "gather"), use_kernel=False)
    sb = t_build(*[torch.tensor(a) for a in one[:3]], CAPS, grid,
                 build_pool_parents=True)
    bricked = _BrickCtx(sb, grid, brick_dims=(8, 8, 8), brick_capacity=8)
    rng = np.random.default_rng(6)
    for level in (0, 1):
        valid = dense.sb.levels[level].valid
        rows = torch.tensor(rng.normal(size=tuple(valid.shape) + (6,)),
                            dtype=torch.float32) * valid[..., None]
        want = dense.global_mean(dense.scatter(rows, level), level)
        grid_b = (bricked.scatter(rows, 0) if level == 0
                  else dense.scatter(rows, level))
        for got in (gather.global_mean(rows, level),
                    bricked.global_mean(grid_b, level)):
            torch.testing.assert_close(got.reshape(-1), want.reshape(-1),
                                       rtol=1e-5, atol=1e-6)
