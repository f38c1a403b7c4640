"""The port's large-scene paths against the JAX package on the CPU:
`bricked` Mask3D (fp32, and bf16 beside it), `gather` / `gather_pallas` in
bf16, the sort-based pyramid of `build_sparse_batch(grid_dims=None)` with
binary-search kernel maps, and the hall scene of `bench_large_scene.py`.

- Bricked: the scene, model and 5e-3 of tests/test_brick_ops.py::
  test_mask3d_bricked_matches_dense, JAX's weights through `bridge.py`,
  and the port's bricked against the port's dense; in bf16 the same pairs
  by the card's mean |diff| gate, 0.05 * max(1, std): on this small scene
  bf16 moves the class logits by 0.57 from fp32 in both packages, and a
  one-ulp change of a weight moves the bf16 logits by 0.03.
- bf16 gather paths: each bf16 row-space conv against JAX's on one input
  (a share of at most 1e-3 of the outputs one bf16 rounding apart: f32
  sums in another order); then Res16UNet14A maps on the 3x2-room scenes at
  bucket 1024 (levels 0 and 1 take the sparse-conv kernel's function),
  JAX's weights with random norm affines: the port's bf16 maps differ from
  JAX's bf16 maps by less than JAX's differ from its fp32 `gather` maps, in
  mean and 99.9% quantile of |diff| on every map. The max is printed, not
  held: 14 layers of bf16 storage amplify those rare flips, and at the
  stride-1 map of `gather` the port-to-JAX max read 0.41 against JAX's own
  bf16-to-fp32 0.37 (means 0.009 against 0.017).
- The sorting pyramid: levels, PoolMaps and kernel maps equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.models.backbone import BACKBONES as J_BACKBONES
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu_torch import bridge, build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.test_torch_train_step import compile_all
from tests.torch_parity import SMALL_OVERRIDES, flax_to_numpy, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)
GP_BUCKET = 1024
MASK3D_KW = dict(num_classes=1, hidden_dim=32, dim_feedforward=64,
                 num_queries=5, num_heads=4, num_decoders=2,
                 sample_sizes=(8, 16, 32, 64, 128),
                 backbone_name="Res16UNet14A", conv1_kernel_size=3)


def _floor_scene():
    """tests/test_brick_ops.py::test_mask3d_bricked_matches_dense's scene:
    a 16^3 grid, points on the lowest 4 z-layers, B=1."""
    rng = np.random.default_rng(0)
    dims = (16, 16, 16)
    n0 = int(rng.integers(120, 220))
    pts = np.stack([rng.integers(0, dims[0], n0),
                    rng.integers(0, dims[1], n0),
                    np.minimum(rng.integers(0, 4, n0), dims[2] - 1)],
                   1).astype(np.int32)
    pts = np.unique(pts, axis=0)
    pts = pts[np.argsort((pts[:, 0] * dims[1] + pts[:, 1]) * dims[2]
                         + pts[:, 2])]
    coords = np.zeros((1, 256, 3), np.int32)
    coords[0, :len(pts)] = pts
    return dict(coords=coords, counts=np.asarray([len(pts)], np.int32),
                dims=np.asarray([dims], np.int32),
                grid_dims=tuple(tuple(max(1, d >> s) for d in dims)
                                for s in range(5)),
                caps=[128, 64, 32, 16])


@pytest.fixture(scope="module")
def bricked():
    """JAX's bricked Mask3D eval outputs (fp32, bf16) and weights on the
    floor scene, and the port's bricked and dense outputs on those weights
    (fp32, bf16)."""
    from mask3d_tpu.models import Mask3D as JMask3D
    from mask3d_tpu_torch.models.mask3d import Mask3D as TMask3D

    s = _floor_scene()
    gd = s["grid_dims"]
    feats = jnp.ones((1, 256, 1), jnp.float32)
    raw = jnp.asarray(s["coords"], jnp.float32)
    sb_b = j_build(s["coords"], s["counts"], s["dims"], s["caps"],
                   conv1_kernel_size=None, build_block_maps=False,
                   grid_dims=gd)
    mb = JMask3D(**MASK3D_KW, backbone_impl="bricked", brick_dims=(8, 8, 4),
                 brick_capacity=64)
    variables = jax.jit(lambda sb: mb.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        sb, feats, raw, True, grid_dims=gd))(sb_b)
    ref = {}
    for name, dt in (("jax bricked", None), ("jax bricked_bf16",
                                             jnp.bfloat16)):
        m = JMask3D(**MASK3D_KW, backbone_impl="bricked",
                    brick_dims=(8, 8, 4), brick_capacity=64,
                    compute_dtype=dt)
        # fp32 eager, as the JAX test: its jitted forward differs by 0.23
        # in the class logits (fused f32 rounding, amplified by the
        # decoder); bf16, held by a mean, jitted
        fwd = (lambda v, sb: m.apply(v, sb, feats, raw, True, grid_dims=gd))
        out = (jax.jit(fwd) if dt else fwd)(variables, sb_b)
        ref[name] = (np.asarray(out.pred_class), np.asarray(out.pred_masks))
    flax_vars = flax_to_numpy(variables)

    t = {k: torch.tensor(s[k]) for k in ("coords", "counts", "dims")}
    outs = {}
    for name, impl, dtype in (("bricked", "bricked", None),
                              ("dense", "dense", None),
                              ("bricked_bf16", "bricked", torch.bfloat16),
                              ("dense_bf16", "dense", torch.bfloat16)):
        extra = (dict(brick_dims=(8, 8, 4), brick_capacity=64)
                 if impl == "bricked" else {})
        model = bridge.load_flax(TMask3D(
            **MASK3D_KW, backbone_impl=impl, compute_dtype=dtype, **extra),
            flax_vars).eval()
        sb = t_build(t["coords"], t["counts"], t["dims"], s["caps"], gd,
                     build_pool_parents=impl == "bricked")
        with torch.no_grad():
            out = model(sb, torch.ones(1, 256, 1), t["coords"].float(), gd)
        assert not bool(sb.any_overflow())
        outs[name] = (out.pred_class.numpy(), out.pred_masks.numpy())
    outs.update(ref)
    return dict(outs=outs,
                valid=np.arange(256)[None] < s["counts"][:, None])


@pytest.mark.parametrize("pair", [("jax bricked", "bricked"),
                                  ("dense", "bricked")])
def test_mask3d_bricked_matches(bricked, pair):
    """The port's bricked against JAX's bricked, and against the port's
    dense, within tests/test_brick_ops.py's 5e-3."""
    ref, got = (bricked["outs"][k] for k in pair)
    v = bricked["valid"]
    np.testing.assert_allclose(got[0], ref[0], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got[1][v], ref[1][v], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("pair", [("jax bricked_bf16", "bricked_bf16"),
                                  ("dense_bf16", "bricked_bf16")])
def test_mask3d_bricked_bf16_matches(bricked, pair):
    """bf16 bricked against JAX's bf16 bricked and the port's bf16 dense:
    finite, the card's mean |diff| gate (0.05 * max(1, std)) on the class
    logits and the valid mask logits."""
    v = bricked["valid"]
    (cd, md), (cb, mb) = (bricked["outs"][k] for k in pair)
    assert np.isfinite(cb).all() and np.isfinite(mb).all()
    for ref, got in ((cd, cb), (md[v], mb[v])):
        assert np.abs(got - ref).mean() <= 0.05 * max(1.0, float(ref.std()))


@pytest.fixture(scope="module")
def bf16_maps():
    """Res16UNet14A maps on bridged JAX weights: JAX `gather` fp32, JAX and
    port `gather` / `gather_pallas` in bf16."""
    dev = VoxelizeCollate(point_bucket_multiple=GP_BUCKET)(
        scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims

    def sb_of(c, n, d):
        return j_build(c, n, d, caps, grid_dims=gd, conv1_kernel_size=3)

    name = "Res16UNet14A"
    jbb = J_BACKBONES[name](in_channels=1, conv1_kernel_size=3,
                            impl="gather")
    params = jax.jit(lambda c, n, d, f: jbb.init(
        jax.random.PRNGKey(0), f, sb_of(c, n, d)))(
        dev.coords, dev.counts, dev.dims, dev.feats)["params"]
    rng = np.random.default_rng(1)
    params = {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                  if k.endswith("_scale") else
                  rng.normal(0, 0.2, v.shape).astype(np.float32)
                  if k.endswith("_bias") else np.asarray(v))
              for k, v in flax_to_numpy(params).items()}
    sd = bridge.from_flax({"params": {"backbone": params}})
    sd = {k[len("backbone."):]: v for k, v in sd.items()}
    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    sb = t_build(*t, caps, gd, conv1_kernel_size=3, build_block_maps=True,
                 build_pool_parents=True)
    feats = torch.tensor(np.asarray(dev.feats))
    out = {"valid": [sb.levels[4 - i].valid.numpy() for i in range(5)]}
    cases = (("gather", None), ("gather", "bf16"), ("gather_pallas", "bf16"))
    args = (params, dev.coords, dev.counts, dev.dims, dev.feats)
    lowered = {}
    for impl, dt in cases:  # traced in turn, compiled at once, run in turn
        jb = J_BACKBONES[name](
            in_channels=1, conv1_kernel_size=3, impl=impl,
            compute_dtype=jnp.bfloat16 if dt else None)
        lowered[(impl, dt)] = jax.jit(lambda p, c, n, d, f, jb=jb: jb.apply(
            {"params": p}, f, sb_of(c, n, d))).lower(*args)
    compiled = compile_all(lowered)
    for impl, dt in cases:
        _, maps = compiled[(impl, dt)](*args)
        out[("jax", impl, dt)] = [np.asarray(m.astype(jnp.float32),
                                             np.float64) for m in maps]
        if dt is None:
            continue
        tbb = T_BACKBONES[name](in_channels=1, conv1_kernel_size=3,
                                impl=impl, compute_dtype=torch.bfloat16)
        tbb.load_state_dict(sd, strict=True)
        with torch.no_grad():
            maps = tbb(feats, sb, gd)[1]
        out[("port", impl, dt)] = maps
    return out


@pytest.mark.parametrize("op", ["sparse_conv", "sparse_conv_down",
                                "sparse_conv_tr"])
def test_bf16_row_convs_match_jax(op):
    from mask3d_tpu.sparse import ops as JO
    from mask3d_tpu_torch.sparse import ops as TO

    dev = VoxelizeCollate(point_bucket_multiple=512)(scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                 conv1_kernel_size=None)
    tsb = t_build(*[torch.tensor(np.asarray(getattr(dev, f)))
                    for f in ("coords", "counts", "dims")], caps, None,
                  build_block_maps=True)
    rng = np.random.default_rng(7)
    c = 32
    lvl = 1 if op == "sparse_conv_tr" else 0
    x = rng.normal(size=(2, sb.levels[lvl].capacity, c)).astype(np.float32)
    k = 27 if op == "sparse_conv" else 8
    w = (rng.normal(size=(k, c, c)) / np.sqrt(k * c)).astype(np.float32)
    bf = dict(compute_dtype=jnp.bfloat16)
    if op == "sparse_conv":
        ref = JO.sparse_conv(x, w, sb.nbr_idx[0], sb.nbr_ok[0], **bf)
        got = TO.sparse_conv(torch.tensor(x), torch.tensor(w),
                             tsb.nbr_idx[0], tsb.nbr_ok[0],
                             compute_dtype=torch.bfloat16)
    elif op == "sparse_conv_down":
        ref = JO.sparse_conv_down(x, w, sb.pools[0], caps[0], **bf)
        got = TO.sparse_conv_down(torch.tensor(x), torch.tensor(w),
                                  tsb.pools[0], caps[0],
                                  compute_dtype=torch.bfloat16)
    else:
        ref = JO.sparse_conv_tr(x, w, sb.pools[0], sb.levels[0].valid, **bf)
        got = TO.sparse_conv_tr(torch.tensor(x), torch.tensor(w),
                                tsb.pools[0], tsb.levels[0].valid,
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    diff = np.abs(got - ref)
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    # one bf16 rounding apart: 2^-8 of the value (half an ulp each side)
    assert (diff <= 2.0 ** -7 * np.abs(ref)).all()


@pytest.mark.parametrize("impl", ["gather", "gather_pallas"])
def test_bf16_gather_maps_match_jax(bf16_maps, impl):
    f32 = bf16_maps[("jax", "gather", None)]
    ref = bf16_maps[("jax", impl, "bf16")]
    for i, (r, g, base, v) in enumerate(zip(
            ref, bf16_maps[("port", impl, "bf16")], f32,
            bf16_maps["valid"])):
        assert g.shape == r.shape and g.dtype in (torch.bfloat16,
                                                  torch.float32)
        ours = np.abs(g.float().numpy().astype(np.float64) - r)[v]
        cost = np.abs(r - base)[v]
        print(f"{impl} map {i}: max |diff| port-JAX {ours.max():.3g}, "
              f"JAX bf16-fp32 {cost.max():.3g}")
        for stat in (np.mean, lambda d: np.quantile(d, 0.999)):
            assert stat(ours) < stat(cost), (impl, i, stat(ours), stat(cost))


@pytest.mark.parametrize("impl", ["gather", "gather_pallas"])
def test_bf16_gather_infer_runs(impl):
    """small_config in bf16 through `build_model` and `infer` on the CPU:
    finite outputs of the fp32 shapes; in train mode (sampled memories)
    too."""
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + [
        f"model.backbone_impl={impl}", "model.compute_dtype=bfloat16",
        f"data.point_bucket_multiple={GP_BUCKET}"])
    host = collate(scene_items(), device="cpu",
                   point_bucket_multiple=GP_BUCKET)
    model = build_model(cfg, device="cpu", seed=0)
    out, overflow = infer(model, host.device, cfg, device="cpu")
    b, n = host.device.coords.shape[:2]
    assert tuple(out.pred_masks.shape) == (b, n, cfg.model.num_queries)
    assert bool(torch.isfinite(out.pred_masks).all()) and not bool(overflow)
    _assert_train_forward_runs(model, cfg, host.device)


def _assert_train_forward_runs(model, cfg, dev):
    """One train-mode forward (sampled memories, autograd on): finite
    outputs of the eval shapes that carry a gradient (the gradients
    themselves: tests/test_torch_train_bricked.py, _bf16.py)."""
    from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities

    model.train()
    sb = t_build(dev.coords, dev.counts, dev.dims,
                 level_capacities(cfg, dev.capacity), dev.grid_dims,
                 **_sb_kwargs(cfg))
    out = model(sb, dev.feats, dev.coords.float(), dev.grid_dims,
                generator=torch.Generator().manual_seed(0))
    b, n = dev.coords.shape[:2]
    assert tuple(out.pred_masks.shape) == (b, n, cfg.model.num_queries)
    assert bool(torch.isfinite(out.aux_pred_masks).all())
    assert bool(torch.isfinite(out.aux_pred_class).all())
    assert out.aux_pred_masks.requires_grad


@pytest.mark.parametrize("k0", [3, 5])
def test_sorted_pyramid_matches_jax(k0):
    """`build_sparse_batch(grid_dims=None)`: levels, PoolMaps and kernel
    maps (3^3 of every level, the k0^3 input conv's) equal to JAX's, on
    scenes that overflow the last level's capacity."""
    dev = VoxelizeCollate(point_bucket_multiple=512)(scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    caps[-1] = 4  # overflows: the dropped rows' parents must agree too
    ref = j_build(dev.coords, dev.counts, dev.dims, caps,
                  conv1_kernel_size=k0, build_block_maps=True)
    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    got = t_build(*t, caps, None, conv1_kernel_size=k0,
                  build_block_maps=True, build_pool_parents=True)
    assert got.occ == () and bool(got.pools[-1].overflow.any())

    def same(a, b, what):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), what)

    for li, (lj, lt) in enumerate(zip(ref.levels, got.levels)):
        for f in ("key", "coords", "valid", "count", "dims"):
            same(getattr(lj, f), getattr(lt, f), f"level {li} {f}")
        assert lj.stride == lt.stride
    for li, (pj, pt) in enumerate(zip(ref.pools, got.pools)):
        for f in ("parent", "kidx", "nchild", "overflow"):
            same(getattr(pj, f), getattr(pt, f), f"pool {li} {f}")
    for li in range(len(ref.levels)):
        same(ref.nbr_idx[li], got.nbr_idx[li], f"nbr_idx {li}")
        same(ref.nbr_ok[li], got.nbr_ok[li], f"nbr_ok {li}")
    same(ref.nbr0_idx, got.nbr0_idx, "nbr0_idx")
    same(ref.nbr0_ok, got.nbr0_ok, "nbr0_ok")


def test_gather_runs_without_grid_dims():
    """A batch without static grid dims: `gather` runs on the sorted
    pyramid and agrees with the same batch on the grid pyramid (the same
    levels; the maps differ only where not ok); dense and bricked
    raise."""
    import dataclasses

    host = collate(scene_items(), device="cpu", point_bucket_multiple=512)
    outs = []
    for dev in (host.device, dataclasses.replace(host.device,
                                                 grid_dims=None)):
        cfg = apply_overrides(Config(), SMALL_OVERRIDES
                              + ["model.backbone_impl=gather"])
        model = build_model(cfg, device="cpu", seed=0)
        out, overflow = infer(model, dev, cfg, device="cpu")
        assert not bool(overflow)
        outs.append(out)
    torch.testing.assert_close(outs[1].pred_class, outs[0].pred_class,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[1].pred_masks, outs[0].pred_masks,
                               rtol=1e-5, atol=1e-5)
    nogrid = dataclasses.replace(host.device, grid_dims=None)
    for impl in ("dense", "bricked"):
        cfg = apply_overrides(Config(), SMALL_OVERRIDES
                              + [f"model.backbone_impl={impl}"])
        model = build_model(cfg, device="cpu", seed=0)
        with pytest.raises(ValueError, match="grid dims"):
            infer(model, nogrid, cfg, device="cpu")


def test_bricked_entry_refusals(tmp_path):
    """`infer` flags a brick overflow; the trainer's test path runs bricked
    at test_batch_size 1 only; train mode runs bricked."""
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    items = scene_items(n=1)
    host = collate(items, device="cpu", point_bucket_multiple=512)
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + [
        "model.backbone_impl=bricked", "model.brick_dims=[8,8,8]",
        "model.brick_capacity=2"])
    model = build_model(cfg, device="cpu", seed=0)
    _, overflow = infer(model, host.device, cfg, device="cpu")
    assert bool(overflow)
    # a capacity above the scene's 15 occupied bricks, 17 slots left empty
    # (every slot is computed: 4096 of them took 46 s of the CPU at
    # inference and take minutes in train mode)
    cfg.model.brick_capacity = 32
    model = build_model(cfg, device="cpu", seed=0)
    out, overflow = infer(model, host.device, cfg, device="cpu")
    assert not bool(overflow) and bool(torch.isfinite(out.pred_masks).all())
    # in train mode at the same capacity
    _assert_train_forward_runs(build_model(cfg, device="cpu", seed=0), cfg,
                               host.device)
    cfg.general.save_dir = str(tmp_path)
    cfg.data.test_batch_size = 2
    trainer = InstanceSegmentationTrainer(
        cfg, datasets={"train": items, "validation": items, "test": items},
        device="cpu")
    with pytest.raises(ValueError, match="test_batch_size=1"):
        trainer.test()


def test_bench_large_scene_dry(capsys):
    """The hall scene's geometry (`--dry`): the JAX tool's numbers."""
    from mask3d_tpu_torch import bench_large_scene

    assert bench_large_scene.main(["--dry"]) == 0
    out = capsys.readouterr().out
    assert "888766 pts" in out, out
    assert "grid (1920, 168, 72)" in out, out
    assert "bricks (32, 8, 8): 5920 occupied of 11340 slots" in out, out
    assert "capacity 6912" in out, out
