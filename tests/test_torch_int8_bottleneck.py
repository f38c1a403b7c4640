"""The int8 stack on the bottleneck backbones against the JAX package:
the int8 conv past 384 outputs (channel groups), and the `int8`,
`int8_residual` and `pallas_chain` forwards of a shallow bottleneck whose
planes reach 128-256 (maps up to 1024 wide).

- The plain int8 conv at Cout 512 and 1024 (1x1 and 3^3) against JAX's
  `dense_conv_same_int8` on a small grid: bitwise (the integer sums are
  exact and the requant is the same arithmetic).
- The launch plan at Res16UNet50/101's int8 shapes: Cout above 384 splits
  into groups of GROUP_COUT, each with the tile of a Cout-256 conv (at
  least 4 fragments: no 16-cell tile), and a ValueError names a shape no
  tile fits.
- The backbone maps of `Int8Bottleneck` (Res16UNet50's blocks, planes
  128-256 at levels 2-4 and stages 3-5 of two blocks, so int8_residual's
  QGrid junctions run at 512 and 1024 channels and the 1x1 expands write
  1024) on the parity scenes of tests/torch_parity.py, on JAX-layout
  weights with random norm affines (the static bounds differ per channel),
  in f32 between the int8 convs, the port against JAX:
  - static scales (`int8_residual`, `pallas_chain`): max |diff| within
    STATIC_TOL x max(1, std), each map (f32 sums in another order; the
    quantized inputs agree);
  - dynamic absmax scales (`int8`): mean |diff| no larger than JAX's own
    spread between its forwards compiled at XLA's default and lowest
    optimization levels, each map (a scale an ulp apart moves every
    quantized input near a rounding boundary; JAX's eager and jitted
    forwards differ as much), the bound tests/test_torch_int8_path.py
    holds the basic-block stack to.
  `pallas_chain` runs the unfused int8 blocks on a bottleneck (JAX's
  `_blocks` gate, backbone.py:651-668): no fused stage, and the maps are
  bitwise those of `int8_residual`. (The bf16 forms: chip_smoke.py phase
  `config_matrix` holds the card to the CPU.)
(The kernel against its plain version at these shapes on the card:
tests/test_torch_card.py, which imports no JAX.)
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.models.backbone import Res16UNet50 as JRes16UNet50
from mask3d_tpu.sparse import dense_ops as jd
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse import chain, int8_ops
from mask3d_tpu_torch.sparse import int8_conv as ic
from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.test_torch_bottleneck import fill
from tests.test_torch_int8 import kernel_mirror, make_case, port_weight
from tests.torch_parity import BUCKET, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

# Res16UNet50's blocks at narrower fine stages: int8 convs (min(Cin, Cout)
# >= 96) run at levels 2-4, where JAX's XLA int8 conv on the CPU takes
# seconds (at Res16UNet50's 1024-wide level 0 it takes minutes)
PLANES = (32, 32, 128, 256, 128, 32, 32, 32)
LAYERS = (1, 1, 2, 2, 2, 1, 1, 1)
CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)  # tests/test_torch_int8_path.py
STATIC = dict(int8_stride1=True, int8_act_sigma=10.0, int8_residual=True)
CONFIGS = {
    "int8": dict(int8_stride1=True),  # dynamic absmax scales
    "int8_residual": STATIC,
    "int8_chain": dict(STATIC, pallas_chain=True),
}
STATIC_TOL = 1e-4  # max |diff| / max(1, std), static scales


class JInt8Bottleneck(JRes16UNet50):
    PLANES: Sequence[int] = PLANES
    LAYERS: Sequence[int] = LAYERS


TInt8Bottleneck = type("Int8Bottleneck", (T_BACKBONES["Res16UNet50"],),
                       dict(PLANES=PLANES, LAYERS=LAYERS))

# (grid dims, Cin, Cout, k) of Int8Bottleneck's and Res16UNet101's int8
# convs past 384 outputs and their neighbours, at the flagship's levels
LEVELS = ((112, 80, 40), (56, 40, 20), (28, 20, 10), (14, 10, 5), (7, 5, 3))
BOTTLENECK_INT8 = [
    (LEVELS[0], 288, 256, 1), (LEVELS[0], 256, 256, 3),
    (LEVELS[0], 256, 1024, 1), (LEVELS[0], 288, 1024, 1),
    (LEVELS[0], 1024, 256, 1), (LEVELS[1], 384, 1024, 1),
    (LEVELS[2], 128, 512, 1), (LEVELS[2], 256, 512, 1),
    (LEVELS[2], 512, 128, 1), (LEVELS[2], 128, 128, 3),
    (LEVELS[3], 1024, 256, 1), (LEVELS[3], 768, 1024, 1),
    (LEVELS[3], 512, 1024, 1), (LEVELS[3], 256, 1024, 1),
    (LEVELS[4], 1024, 256, 1), (LEVELS[4], 256, 1024, 1),
]


@pytest.mark.parametrize("k,cout,static", [(1, 512, True), (1, 1024, False),
                                           (3, 512, False),
                                           (3, 1024, True)])
def test_plain_int8_conv_past_384_outputs_matches_jax(k, cout, static):
    """`dense_conv_same_int8` at 512 and 1024 outputs, bitwise JAX's."""
    x, occ, w, bound = make_case(20 + k, cin=48, cout=cout, k=k,
                                 dims=(6, 5, 4))
    ref = jd.dense_conv_same_int8(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(occ),
        out_dtype=jnp.bfloat16,
        act_bound=jnp.asarray(bound) if static else None)
    got = int8_ops.dense_conv_same_int8(
        torch.tensor(x).bfloat16(), port_weight(w), torch.tensor(occ),
        act_bound=torch.tensor(bound) if static else None)
    assert got.shape[-1] == cout
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert np.abs(np.asarray(ref, np.float32)).max() > 0


@pytest.mark.parametrize("shape", BOTTLENECK_INT8)
def test_plan_at_bottleneck_shapes(shape):
    """Cout above 384 runs in channel groups of at most GROUP_COUT, each
    planned as a Cout-256 conv: at least 4 fragments a tile (never the
    16-cell tile a whole Cout of 1024 would leave), within the shared
    memory, the groups' blocks counted before splitting."""
    dims, cin, cout, k = shape
    p = ic.plan(8, dims, cin, cout, k)
    groups = 1 if cout <= 384 else -(-cout // ic.GROUP_COUT)
    assert (p.groups, p.coutg) == (groups, -(-cout // groups))
    assert p.coutg <= p.cout_p and p.groups * p.coutg >= cout
    frags = int(np.prod(p.tile_frags))
    assert frags >= 4 and frags * 16 >= 64
    assert frags == ic.WARPS // (p.cout_p // (8 * p.nt)) * p.mf
    assert p.smem <= ic.SMEM_BYTES
    tiles = 8 * p.tiles(dims)
    assert p.splits == 1 or tiles * p.groups * p.splits <= \
        ic.SMS + tiles * p.groups
    assert 127 * 127 * k ** 3 * p.cin_p < 2 ** 31


def test_plan_names_the_shape_no_tile_fits():
    with pytest.raises(ValueError, match="8192->1024 k=3"):
        ic.plan(8, LEVELS[0], 8192, 1024, 3)
    with pytest.raises(ValueError, match="MIN_FRAGS|no tile"):
        ic.plan(8, LEVELS[0], 1024, 1024, 3, mf=1)


def test_grouped_weights_pack_each_group():
    """A grouped plan's weights: each group of `coutg` outputs packed as a
    conv of that width, one after the other."""
    gen = torch.Generator().manual_seed(0)
    wq = torch.randint(-127, 128, (1, 64, 1024), generator=gen).to(
        torch.int8)
    p = ic.plan(2, (8, 8, 8), 64, 1024, 1)
    words = ic.pack_weights(wq, p.cin_p, p.cout_p, p.coutg)
    assert words.shape[0] == p.groups == 4
    for g in range(p.groups):
        back = ic.unpack_weights(words[g], 64, p.coutg)
        assert torch.equal(back, wq[..., g * p.coutg:(g + 1) * p.coutg])


@pytest.mark.parametrize("case", [((6, 5, 7), 64, 512, 1),
                                  ((7, 6, 5), 32, 1024, 3)])
def test_grouped_mirror_matches_plain(case):
    """The kernel's skip and split rules, mirrored per channel group (each
    group computes its outputs from the same live fragments), give the
    plain conv bitwise at 512 and 1024 outputs."""
    dims, cin, cout, k = case
    gen = torch.Generator().manual_seed(cout + k)
    occ = (torch.rand((2, *dims, 1), generator=gen) < 0.2).float()
    q = (torch.randint(-127, 128, (2, *dims, cin), generator=gen)
         * occ.int()).to(torch.int8)
    wq = torch.randint(-127, 128, (k ** 3, cin, cout), generator=gen).to(
        torch.int8)
    sw = torch.rand(cout, generator=gen) * 1e-3
    ref = ic.int8_conv_plain(q, occ, wq, sw)
    p = ic.plan(2, dims, cin, cout, k)
    assert p.groups > 1
    for splits in (1, 3):
        pl = dataclasses.replace(p, splits=splits)
        outs = [kernel_mirror(q, occ, wq[..., c0:c0 + p.coutg],
                              sw[c0:c0 + p.coutg], "none", pl)[0]
                for c0 in range(0, cout, p.coutg)]
        assert torch.equal(torch.cat(outs, dim=-1), ref.out)


@pytest.fixture(scope="module")
def runs():
    """Backbone maps of every configuration, JAX and port, on one set of
    JAX-layout weights; the port's fused stages (none expected)."""
    dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims
    args = (dev.coords, dev.counts, dev.dims, dev.feats)

    def sb_of(c, n, d):
        return j_build(c, n, d, caps, grid_dims=gd, build_block_maps=False,
                       conv1_kernel_size=None, build_pool_parents=False)

    shapes = jax.eval_shape(lambda c, n, d, f: JInt8Bottleneck(
        in_channels=1, conv1_kernel_size=3, impl="dense").init(
            jax.random.PRNGKey(0), f, sb_of(c, n, d), gd), *args)["params"]
    params = fill(shapes, 15)
    lowered = {}  # name -> (lowered forward, XLA optimization level)
    for name in ("int8", "int8_residual"):  # JAX's gate: no chain here
        model = JInt8Bottleneck(in_channels=1, conv1_kernel_size=3,
                                impl="dense", **CONFIGS[name])

        def fwd(p, c, n, d, f, model=model):
            return model.apply({"params": p}, f, sb_of(c, n, d), gd)[1]

        lo = jax.jit(fwd).lower(params, *args)
        lowered[name] = (lo, 0)
        if name == "int8":  # JAX's own spread: the default level
            lowered["int8_default"] = (lo, None)
    with ThreadPoolExecutor(len(lowered)) as ex:
        exes = dict(zip(lowered, ex.map(lambda lo: lo[0].compile(
            compiler_options={} if lo[1] is None else
            {"xla_backend_optimization_level": lo[1]}), lowered.values())))
    out = {"jax": {}, "port": {}, "fused": []}
    for name, exe in exes.items():
        out["jax"][name] = [np.asarray(m.astype(jnp.float32))
                            for m in exe(params, *args)]
    sd = bridge.backbone_from_flax(params)
    t = [torch.tensor(np.asarray(a)) for a in args]
    sb = t_build(*t[:3], caps, gd)
    real = chain.fused_basic_stage
    chain.fused_basic_stage = lambda *a, **k: out["fused"].append(a) or \
        real(*a, **k)
    try:
        for name, opts in CONFIGS.items():
            tm = TInt8Bottleneck(in_channels=1, conv1_kernel_size=3, **opts)
            tm.load_state_dict(sd, strict=True)
            n0 = ic.int8_conv.launches  # CPU: the plain version, no launch
            with torch.no_grad():
                maps = tm(t[3], sb, gd)[1]
            assert ic.int8_conv.launches == n0
            out["port"][name] = [m.float().numpy() for m in maps]
    finally:
        chain.fused_basic_stage = real
    out["valid"] = [sb.levels[4 - i].valid.numpy() for i in range(5)]
    return out


def test_pallas_chain_runs_the_unfused_int8_blocks(runs):
    assert runs["fused"] == []
    for a, b in zip(runs["port"]["int8_chain"], runs["port"]["int8_residual"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["int8_residual", "int8_chain"])
def test_static_int8_bottleneck_maps_match_jax(runs, name):
    for i, (ref, got, valid) in enumerate(zip(
            runs["jax"]["int8_residual"], runs["port"][name],
            runs["valid"])):
        r, g = ref[valid], got[valid]
        err = float(np.abs(g - r).max()) / max(1.0, float(r.std()))
        assert err <= STATIC_TOL, (name, i, err)


def test_dynamic_int8_bottleneck_maps_within_jax_spread(runs):
    for i, (ref, other, got, valid) in enumerate(zip(
            runs["jax"]["int8"], runs["jax"]["int8_default"],
            runs["port"]["int8"], runs["valid"])):
        own = np.abs(other[valid] - ref[valid]).mean()
        ours = np.abs(got[valid] - ref[valid]).mean()
        assert np.isfinite(got).all() and ours <= own, (i, ours, own)
