"""The slice end to end: the JAX bench's inference stack on the dense path
(`bf16`, `int8`, `int8_chain`) in the PyTorch port against the JAX
package: Res16UNet18A (two blocks a stage, so the chain's junction runs) on
the 3x2-room scenes of `tests/torch_parity.py`, with JAX-initialised
weights (random norm affines, so the static int8 bounds differ per
channel) bridged into the port. `MIN_ROWS` is 0 in both packages, so
stages 7 and 8 fuse on these small grids, as `tests/test_pallas_chain.py:
226` does; the JAX chain runs at tile 512 (the tiling changes only the
order of its f32 sums) to keep its interpreter inside the test's time.

What is compared, and why there: the five backbone feature maps, which
feed the decoder. With random weights the decoder's 0.5 thresholds on the
attention masks amplify any rounding: on this fixture JAX's own `int8_chain`
and `int8` outputs miss the criterion of `tests/test_pallas_chain.py:
268-277` (class corr 0.99893, mask corr 0.98487, measured), so it is held
on the maps, where JAX's own spread is corr >= 0.9967.
- `bf16`: every conv in bf16 over 18 blocks makes rounding order visible
  (a single conv agrees with JAX but at 3e-5 of its outputs); the port's
  maps differ from JAX's by less than JAX's bf16 maps differ from the fp32
  ones (mean, 99.9% quantile and max |diff|, each map), and they are bf16.
- `int8`, `int8_chain`: mean |diff| from JAX's maps no larger than JAX's
  own `int8_chain`-to-`int8` difference on the same maps, and correlation
  above 0.995 on every map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.models.backbone import BACKBONES as J_BACKBONES
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse import pallas_chain as pc
from mask3d_tpu_torch import bridge, build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse import chain
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy, \
    scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

NAME = "Res16UNet18A"
CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)
INT8 = dict(compute_dtype="bfloat16", int8_stride1=True, int8_act_sigma=10.0,
            int8_residual=True, unit_features=True)
CONFIGS = {"fp32": {}, "bf16": dict(compute_dtype="bfloat16"), "int8": INT8,
           "int8_chain": dict(INT8, pallas_chain=True)}
CHAIN_TILE = dict(tile=512, sub=256)


def _j_opts(opts):
    return {k: (jnp.bfloat16 if v == "bfloat16" else v)
            for k, v in opts.items()}


def _t_opts(opts):
    return {k: (torch.bfloat16 if v == "bfloat16" else v)
            for k, v in opts.items()}


@pytest.fixture(scope="module")
def runs():
    """Backbone maps of every configuration, JAX and port, on one set of
    bridged weights, and the stages each side fused."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pc, "MIN_ROWS", 0)
    mp.setattr(chain, "MIN_ROWS", 0)
    fused = {"jax": [], "port": []}

    def recorder(side, real, **extra):
        def fused_stage(x, bound, occ, blocks, *args, **kwargs):
            fused[side].append((tuple(x.shape[1:]),
                                int(blocks[0]["w1"].shape[-1])))
            return real(x, bound, occ, blocks, *args, **kwargs, **extra)
        return fused_stage

    mp.setattr(pc, "fused_basic_stage", recorder(
        "jax", pc.fused_basic_stage, **CHAIN_TILE))
    mp.setattr(chain, "fused_basic_stage", recorder(
        "port", chain.fused_basic_stage))
    try:
        dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(
            scene_items()).device
        caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
        gd = dev.grid_dims

        def sb_of(c, n, d):
            return j_build(c, n, d, caps, grid_dims=gd,
                           build_block_maps=False, conv1_kernel_size=None,
                           build_pool_parents=False)

        jbb = J_BACKBONES[NAME](in_channels=1, conv1_kernel_size=3,
                                impl="dense")
        params = jax.jit(lambda c, n, d, f: jbb.init(
            jax.random.PRNGKey(0), f, sb_of(c, n, d), gd))(
            dev.coords, dev.counts, dev.dims, dev.feats)["params"]
        rng = np.random.default_rng(1)
        params = {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if k.endswith("_scale") else
                      rng.normal(0, 0.2, v.shape).astype(np.float32)
                      if k.endswith("_bias") else np.asarray(v))
                  for k, v in flax_to_numpy(params).items()}
        sd = bridge.from_flax({"params": {"backbone": params}})
        sd = {k[len("backbone."):]: v for k, v in sd.items()}
        t = {f: torch.tensor(np.asarray(getattr(dev, f)))
             for f in ("coords", "counts", "dims", "feats")}
        sb = t_build(t["coords"], t["counts"], t["dims"], caps, gd)

        out = {"jax": {}, "port": {}, "fused": fused}
        for name, opts in CONFIGS.items():
            tbb = T_BACKBONES[NAME](in_channels=1, conv1_kernel_size=3,
                                    **_t_opts(opts))
            tbb.load_state_dict(sd, strict=True)
            fused["port"].append(name)
            with torch.no_grad():
                out["port"][name] = tbb(t["feats"], sb, gd)[1]
            if name == "fp32":
                continue  # the port's fp32 maps are JAX's to 2e-4
            jb = J_BACKBONES[NAME](in_channels=1, conv1_kernel_size=3,
                                   impl="dense", **_j_opts(opts))
            fused["jax"].append(name)
            maps = jax.jit(lambda p, c, n, d, f: jb.apply(
                {"params": p}, f, sb_of(c, n, d), gd)[1])(
                params, dev.coords, dev.counts, dev.dims, dev.feats)
            out["jax"][name] = [np.asarray(m.astype(jnp.float32))
                                for m in maps]
        return out
    finally:
        mp.undo()


def _np(m):
    return m.float().numpy().astype(np.float64)


def test_port_fuses_the_stages_jax_fuses(runs):
    """Stages 7 and 8 (128 -> 96 at levels 1 and 0) and nothing else, on
    both sides, only in int8_chain."""
    f = runs["fused"]
    assert f["port"][0] == "fp32" and f["jax"] == f["port"][1:]
    at = f["jax"].index("int8_chain")
    assert f["jax"][:at] == ["bf16", "int8"]
    assert len(f["jax"][at + 1:]) == 2 and all(
        shape[-1] == 128 and planes == 96
        for shape, planes in f["jax"][at + 1:])


def test_bf16_maps_match_jax(runs):
    for i, (ref, got, f32) in enumerate(zip(
            runs["jax"]["bf16"], runs["port"]["bf16"],
            runs["port"]["fp32"])):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        ours, cost = np.abs(_np(got) - ref), np.abs(ref - _np(f32))
        for stat in (np.mean, lambda d: np.quantile(d, 0.999), np.max):
            assert stat(ours) < stat(cost), (i, stat(ours), stat(cost))


@pytest.mark.parametrize("name", ["int8", "int8_chain"])
def test_int8_maps_match_jax(runs, name):
    own = [np.abs(a - b).mean() for a, b in zip(runs["jax"]["int8_chain"],
                                                runs["jax"]["int8"])]
    ours = []
    for ref, got in zip(runs["jax"][name], runs["port"][name]):
        g = _np(got)
        assert got.dtype == torch.bfloat16 and np.isfinite(g).all()
        ours.append(np.abs(g - ref).mean())
        corr = np.corrcoef(ref.ravel(), g.ravel())[0, 1]
        assert corr > 0.995, (name, len(ours) - 1, corr)
    # JAX's own spread lives in the fused stages' maps (strides 2 and 1)
    assert min(own[3:]) > 0
    assert sum(ours) <= sum(own), (ours, own)


@pytest.mark.parametrize("name", ["bf16", "int8", "int8_chain"])
def test_infer_runs_the_configuration(name):
    """`build_model` takes the overrides and `infer` runs them on the CPU:
    finite outputs of the expected shapes."""
    ov = [f"model.{k}={str(v).lower()}" for k, v in CONFIGS[name].items()]
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + [
        f"model.backbone={NAME}"] + ov)
    host = collate(scene_items(), device="cpu", point_bucket_multiple=BUCKET)
    model = build_model(cfg, device="cpu", seed=0)
    assert model.backbone.compute_dtype == torch.bfloat16
    out, overflow = infer(model, host.device, cfg, device="cpu")
    b, n = host.device.coords.shape[:2]
    assert tuple(out.pred_masks.shape) == (b, n, cfg.model.num_queries)
    assert out.pred_masks.dtype == torch.float32
    assert bool(torch.isfinite(out.pred_masks).all()) and not bool(overflow)


def test_unit_features_refuses_real_features():
    """`model.unit_features` with non-constant features raises (the JAX
    package's init_state check, `train/loop.py:190-205`)."""
    ov = [f"model.{k}={str(v).lower()}" for k, v in INT8.items()]
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + ov)
    host = collate(scene_items(), device="cpu", point_bucket_multiple=BUCKET)
    assert host.device.feats_all_ones is True
    model = build_model(cfg, device="cpu")
    bad = host.device
    bad.feats = torch.as_tensor(bad.feats) * 2.0
    bad.feats_all_ones = None  # edited by hand: checked on its features
    with pytest.raises(ValueError, match="unit_features"):
        infer(model, bad, cfg, device="cpu")
    bad.feats_all_ones = False
    with pytest.raises(ValueError, match="unit_features"):
        infer(model, bad, cfg, device="cpu")
