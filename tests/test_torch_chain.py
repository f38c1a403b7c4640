"""The fused int8 block chain of the PyTorch port against the JAX package's
Pallas chain (`mask3d_tpu/sparse/pallas_chain.py`, interpret mode on the
CPU): every chain step on the inputs and constants of the JAX run, and
whole fused stages; plus the port's kernel against its plain version on a
card.

The JAX stages run once per module, with `chain_conv` wrapped to record
each call's inputs and outputs; the port's steps then take those inputs,
unpacked from the TPU layout, and the same constants (A, B, inv, sw taken
from the JAX side). Tolerances: conv outputs and `yq` bitwise (integer sums
and the same two roundings of the affine); the sums within 1e-5 of
sum |term| (f32 summation order); whole stages within the JAX package's
own fused-vs-unfused tolerance (`tests/test_pallas_chain.py:185-196`),
which the port's f32 stats order can move by a quantize flip. The JAX
package and the repo's test helpers that import it are imported inside the
functions that need them, so the card-marked test collects where flax is
not importable (`tests.torch_threads` imports no JAX)."""

import numpy as np
import pytest
import torch

from mask3d_tpu_torch.sparse import chain
from mask3d_tpu_torch.sparse.int8_conv import int8_conv, int8_conv_plain
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

SIGMA = 8.0
STAGES = [(24, 48, 2), (48, 48, 2)]  # (cin, planes, blocks)
PORT_MODE = {"entry": "none", "mid": "affine", "junction": "join"}
# (stage, call index) of each kind of step in the recorded JAX runs
STEPS = {"entry_1x1": (0, 0), "mid": (0, 1), "junction_bf16_res": (0, 2),
         "entry": (1, 0), "junction_int8_res": (1, 2), "mid_after_junction":
         (1, 3)}


def stage_inputs(cin, planes, n, seed=None):
    """The JAX test's inputs: a bf16 grid, its occupancy, a valid static
    bound and the blocks (numpy, JAX layout)."""
    import jax.numpy as jnp
    from tests.test_pallas_chain import make_blocks, make_grid

    rng = np.random.default_rng(2 + n if seed is None else seed)
    x, occ = make_grid(rng, c=cin)
    bound = jnp.asarray(
        np.abs(np.asarray(x, np.float32)).max(axis=(0, 1, 2, 3)) * 1.05
        + 1e-3)
    return x, occ, bound, make_blocks(rng, cin, planes, n)


def torch_blocks(blocks):
    return [{k: torch.tensor(np.asarray(v)) for k, v in blk.items()}
            for blk in blocks]


def t(a, dtype=None):
    """jax array -> torch tensor (bf16 kept)."""
    import jax.numpy as jnp

    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)
    out = torch.tensor(a)
    return out.bfloat16() if dtype == torch.bfloat16 else out


@pytest.fixture(scope="module")
def jax_stages():
    """Per stage of STAGES: inputs, JAX (y, y_bound) and the recorded
    chain_conv calls."""
    from mask3d_tpu.sparse import pallas_chain as pc
    from tests.test_pallas_chain import SPEC_KW

    real = pc.chain_conv
    runs = []
    for cin, planes, n in STAGES:
        calls = []

        def record(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append((args, kwargs, out))
            return out

        x, occ, bound, blocks = stage_inputs(cin, planes, n)
        pc.chain_conv = record
        try:
            y, y_bound = pc.fused_basic_stage(
                x, bound, occ, blocks, x.shape[1:4], SIGMA, interpret=True,
                **SPEC_KW)
        finally:
            pc.chain_conv = real
        runs.append(dict(cin=cin, planes=planes, x=x, occ=occ, bound=bound,
                         blocks=blocks, y=np.asarray(y, np.float32),
                         y_bound=np.asarray(y_bound), calls=calls))
    return runs


def port_step(run, args, kwargs):
    """The port's int8_conv inputs of one recorded JAX call, unpacked."""
    import jax.numpy as jnp
    from mask3d_tpu.sparse import pallas_chain as pc

    x_packed, wq, consts, spec, mode = args
    planes = kwargs["cout"]
    cin = run["cin"] if mode == "entry" else planes
    kw = dict(stats=True)
    if mode == "entry":
        x = t(pc.unpack_grid(x_packed, spec, cin))
        if kwargs.get("wdq") is not None:
            kw["wdq"] = t(kwargs["wdq"][:, :cin, :planes])
            kw["swd"] = t(consts[0, pc._CSWD, :planes])
    else:
        x = t(pc.unpack_grid(x_packed, spec, cin), torch.bfloat16)
        kw["A"] = t(consts[:, pc._CA, :cin])
        kw["Bc"] = t(consts[:, pc._CB, :cin])
        kw["inv"] = t(consts[0, pc._CINV, :cin])
    if mode == "junction":
        res = kwargs["res_packed"]
        kw["res"] = t(pc.unpack_grid(res, spec, cin),
                      torch.bfloat16 if res.dtype == jnp.bfloat16 else None)
        kw["Ar"] = t(consts[:, pc._CAR, :cin])
        kw["Br"] = t(consts[:, pc._CBR, :cin])
    return (x, torch.tensor(np.asarray(run["occ"])),
            t(wq[:, :cin, :planes]), t(consts[0, pc._CSW, :planes]),
            PORT_MODE[mode]), kw


def assert_stats_close(got, ref_outs, ref_stats):
    """Each sum within 1e-5 of sum |term| over its cells."""
    terms = []
    for o in ref_outs:
        r = o.float()
        terms += [r.abs().sum(dim=(1, 2, 3)), (r * r).sum(dim=(1, 2, 3))]
    scale = torch.stack(terms, dim=1)
    assert got.shape == ref_stats.shape
    err = (got - ref_stats).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float(
        (err / (scale + 1e-30)).max())


@pytest.mark.parametrize("step", list(STEPS))
def test_chain_step_matches_jax(jax_stages, step):
    import jax.numpy as jnp
    from mask3d_tpu.sparse import pallas_chain as pc

    stage, call = STEPS[step]
    run = jax_stages[stage]
    args, kwargs, outs = run["calls"][call]
    mode, spec, planes = args[4], args[3], kwargs["cout"]
    assert step.split("_")[0] == mode
    if step.startswith("junction"):
        want_res = jnp.int8 if "int8" in step else jnp.bfloat16
        assert kwargs["res_packed"].dtype == want_res
    pargs, kw = port_step(run, args, kwargs)
    got = int8_conv(*pargs, **kw)

    raw = t(pc.unpack_grid(outs[0], spec, planes), torch.bfloat16)
    assert got.out.dtype == torch.bfloat16
    assert torch.equal(got.out, raw)
    assert raw.abs().max() > 0
    ref_outs = [raw]
    if mode == "entry" and "wdq" in kw:
        res_raw = t(pc.unpack_grid(outs[1], spec, planes), torch.bfloat16)
        assert torch.equal(got.out2, res_raw)
        ref_outs.append(res_raw)
    if mode == "junction":
        yq = t(pc.unpack_grid(outs[1], spec, planes))
        assert got.yq.dtype == torch.int8 and torch.equal(got.yq, yq)
    stats = t(outs[-1])[:, :, :planes]
    assert_stats_close(got.stats, ref_outs, stats)


@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_fused_stage_matches_jax(jax_stages, stage):
    run = jax_stages[stage]
    y, y_bound = chain.fused_basic_stage(
        t(run["x"], torch.bfloat16), torch.tensor(np.asarray(run["bound"])),
        torch.tensor(np.asarray(run["occ"])), torch_blocks(run["blocks"]),
        SIGMA)
    assert y.dtype == torch.bfloat16 and y.shape == run["y"].shape
    np.testing.assert_allclose(y_bound.numpy(), run["y_bound"], rtol=1e-6)
    got, want = y.float().numpy(), run["y"]
    step = run["y_bound"] / 127.0
    diff = np.abs(got - want)
    tol = 3.0 * step + 0.02 * np.abs(want) + 0.02
    assert float((diff > tol).mean()) == 0.0, float(diff.max())
    occupied = np.asarray(run["occ"])[..., 0] > 0
    assert float(np.median(diff[occupied])) == 0.0


def test_fused_stage_empty_item_stays_zero():
    import jax.numpy as jnp

    x, occ, bound, blocks = stage_inputs(24, 48, 2, seed=9)
    x, occ = np.array(x.astype(jnp.float32)), np.array(occ)
    x[1], occ[1] = 0, 0
    y, _ = chain.fused_basic_stage(
        torch.tensor(x).bfloat16(), torch.ones(24), torch.tensor(occ),
        torch_blocks(blocks), SIGMA)
    assert float(y[1].float().abs().max()) == 0.0
    assert bool(torch.isfinite(y.float()).all())


def random_step(mode, gen, dev, b=2, dims=(9, 6, 11), cin=96, cout=80,
                res_dtype=torch.int8, second=False, occ=None):
    """Random inputs of one chain step (or a plain int8 conv); `occ` one of
    None (30% occupied), "one" (a single occupied cell an item) or
    "empty_item" (the last item without any)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    kind = occ
    occ = (torch.rand((b,) + dims + (1,), generator=gen, device=dev)
           < 0.3).float()
    if kind == "one":
        occ.zero_()
        occ[:, dims[0] // 2, 1, dims[2] - 1] = 1.0
    elif kind == "empty_item":
        occ[-1] = 0.0
    k = 1 if mode == "conv1x1" else 3
    wq = torch.randint(-127, 128, (k ** 3, cin, cout), generator=gen,
                       device=dev).to(torch.int8)
    sw = rnd(cout).abs() * 1e-3
    kw = dict(stats=mode in ("entry", "affine", "join"))
    if mode in ("none", "conv1x1", "entry"):
        x = (torch.randint(-127, 128, (b,) + dims + (cin,), generator=gen,
                           device=dev) * occ).to(torch.int8)
        if second:
            kw["wdq"] = wq[13:14].clone()
            kw["swd"] = sw.flip(0).contiguous()
        return (x, occ, wq, sw, "none"), kw
    x = (rnd(*((b,) + dims + (cin,))) * occ).bfloat16()
    kw.update(A=rnd(b, cin), Bc=rnd(b, cin) * 0.1, inv=rnd(cin).abs() * 40)
    if mode == "join":
        res = rnd(*((b,) + dims + (cin,))) * occ
        kw.update(res=(res * 60).to(torch.int8) if res_dtype == torch.int8
                  else res.bfloat16(), Ar=rnd(b, cin) * 0.02,
                  Br=rnd(b, cin) * 0.1)
    return (x, occ, wq, sw, mode), kw


def stats_mirror(outs, occ, p):
    """The int8 conv kernel's f32 sums in its order, under plan `p`: each
    tile (or, when split, each run of 32 cells of an item) adds its cells'
    outputs and their squares one at a time from 0 (cells in the kernel's
    tile order, unoccupied ones 0), then an item's slots are added in 8
    interleaved runs (slots g, g + 8, ...) and the 8 run sums in order.
    Every step rounds to f32 on its own, as the kernel's do."""
    b, dims = occ.shape[0], tuple(occ.shape[1:4])
    rows = []
    for o in outs:
        r = o.float() * (occ > 0.5)
        c = r.shape[-1]
        if p.splits == 1:
            t = p.tile
            pads = [-(-d // s) * s for d, s in zip(dims, t)]
            full = r.new_zeros((b, *pads, c))
            full[:, :dims[0], :dims[1], :dims[2]] = r
            cells = full.view(
                b, pads[0] // t[0], t[0], pads[1] // t[1], t[1],
                pads[2] // t[2], t[2], c).permute(0, 1, 3, 5, 2, 4, 6, 7)
            cells = cells.reshape(b, -1, t[0] * t[1] * t[2], c)
        else:
            n = int(np.prod(dims))
            flat = r.new_zeros((b, -(-n // 32) * 32, c))
            flat[:, :n] = r.reshape(b, n, c)
            cells = flat.view(b, -1, 32, c)
        s1 = cells.new_zeros((b, cells.shape[1], c))
        s2 = torch.zeros_like(s1)
        for v in cells.unbind(2):
            s1 = s1 + v
            s2 = s2 + v * v
        for slots in (s1, s2):
            padded = slots.new_zeros((b, -(-slots.shape[1] // 8) * 8, c))
            padded[:, :slots.shape[1]] = slots
            runs = slots.new_zeros((b, 8, c))
            for run in padded.split(8, dim=1):
                runs = runs + run
            total = slots.new_zeros((b, c))
            for g in range(8):
                total = total + runs[:, g]
            rows.append(total)
    return torch.stack(rows, dim=1)


@pytest.mark.parametrize("mode,extra", [
    ("entry", dict(second=True)), ("affine", {}), ("join", {}),
    ("entry", dict(second=True, occ="empty_item")),
    ("affine", dict(cin=192, cout=128, dims=(7, 5, 3), b=8))])
def test_stats_order_within_tolerance(mode, extra):
    """The kernel's order of the f32 sums (stats_mirror), unsplit and split,
    stays within 1e-5 of sum |term| of the plain version's sums."""
    import dataclasses

    from mask3d_tpu_torch.sparse import int8_conv as ic

    gen = torch.Generator().manual_seed(1)
    args, kw = random_step(mode, gen, "cpu", **extra)
    ref = int8_conv_plain(*args, **kw)
    outs = [ref.out] + ([ref.out2] if ref.out2 is not None else [])
    k = round(args[2].shape[0] ** (1 / 3))
    p = ic.plan(args[0].shape[0], tuple(args[0].shape[1:4]),
                args[0].shape[-1], args[2].shape[-1], k, args[4])
    for pl in (dataclasses.replace(p, splits=1),
               dataclasses.replace(p, splits=3)):
        got = stats_mirror(outs, args[1], pl)
        assert_stats_close(got, outs, ref.stats)
        assert pl.stat_parts(tuple(args[0].shape[1:4])) == (
            pl.tiles(tuple(args[0].shape[1:4])) if pl.splits == 1 else
            -(-int(np.prod(args[0].shape[1:4])) // 32))


@pytest.mark.cuda
def test_int8_conv_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version at each branch of its
    design (needs a card; `chip_smoke.py` runs the flagship's shapes): every
    mode, k 1, the second 1x1 output, join with an int8 and a bf16
    residual, a fragment with one occupied cell, an empty item, ragged
    tiles, Cin 192 and 384, Cout 96, 256 and 384 (Res16UNet14D's widths),
    the split coarse shapes (and one fine grid unsplit); outputs bitwise,
    two launches bitwise equal, the f32 stats too, and bitwise equal to
    stats_mirror (the kernel's order of sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from mask3d_tpu_torch.sparse import int8_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("none", {}), ("conv1x1", {}), ("entry", dict(second=True)),
             ("entry", {}), ("affine", {}), ("join", {}),
             ("join", dict(res_dtype=torch.bfloat16)),
             ("none", dict(cin=384, cout=256, dims=(7, 5, 3))),
             ("none", dict(occ="one")), ("join", dict(occ="one")),
             ("entry", dict(second=True, occ="empty_item")),
             ("affine", dict(occ="empty_item", cout=96)),
             ("none", dict(cin=192, cout=128, dims=(28, 20, 10), b=8)),
             ("conv1x1", dict(cin=384, cout=256, dims=(14, 10, 5), b=8)),
             ("none", dict(cin=256, cout=256, dims=(14, 10, 5), b=8)),
             ("entry", dict(cin=128, cout=96, second=True, b=1,
                            dims=(112, 80, 40))),
             ("none", dict(cin=416, cout=384, dims=(20, 12, 4))),
             ("conv1x1", dict(cin=448, cout=384, dims=(10, 6, 2))),
             ("join", dict(cin=384, cout=384)),
             ("none", dict(cin=512, cout=384, dims=(7, 5, 3), b=8))]
    for mode, extra in cases:
        args, kw = random_step(mode, gen, "cuda", **extra)
        k = round(args[2].shape[0] ** (1 / 3))
        p_key = (args[0].shape[0], tuple(args[0].shape[1:4]),
                 args[0].shape[-1], args[2].shape[-1], k, args[4])
        p = ic.plan(*p_key)
        for out_dtype in ((torch.bfloat16, torch.float32)
                          if mode == "none" else (torch.bfloat16,)):
            got = int8_conv(*args, out_dtype=out_dtype, **kw)
            again = int8_conv(*args, out_dtype=out_dtype, **kw)
            ref = int8_conv_plain(*args, out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            what = (mode, extra, p.splits)
            assert torch.equal(got.out, ref.out), what
            assert torch.equal(got.out, again.out), what
            for a, r, a2 in ((got.out2, ref.out2, again.out2),
                             (got.yq, ref.yq, again.yq)):
                assert (a is None) == (r is None)
                assert a is None or torch.equal(a, r), what
                assert a is None or torch.equal(a, a2), what
            if kw["stats"]:
                outs = [ref.out] + ([ref.out2] if ref.out2 is not None
                                    else [])
                assert_stats_close(got.stats, outs, ref.stats)
                assert torch.equal(got.stats, again.stats), what
                # the kernel's order exactly: the same f32 roundings
                pl = ic.plan(*p_key, out_f32=out_dtype == torch.float32)
                assert torch.equal(got.stats.cpu(), stats_mirror(
                    [o.cpu() for o in outs], args[1].cpu(), pl)), what
