"""int8 eval ops of the PyTorch port against the JAX package, bitwise:
`quantize_static`, `dequantize` and `dense_conv_same_int8` (k 1 and 3,
dynamic absmax and static bounds, a QGrid input) on the same numpy inputs.
On CPU tensors the port runs the plain version of its int8 conv kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.sparse import dense_ops as jd
from mask3d_tpu_torch.sparse import int8_ops
from mask3d_tpu_torch.sparse import int8_conv as ic
from mask3d_tpu_torch.sparse.int8_conv import int8_conv, int8_conv_plain, \
    pack_weights
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)


def make_case(seed, cin=24, cout=48, k=3, b=2, dims=(12, 10, 8)):
    """A grid with zeros at unoccupied cells, its occupancy, a JAX-layout
    weight [k^3, Cin, Cout] and a bound that some |x| exceed (saturation)."""
    rng = np.random.default_rng(seed)
    occ = (rng.random((b,) + dims + (1,)) < 0.3).astype(np.float32)
    x = (rng.standard_normal((b,) + dims + (cin,)) * occ).astype(np.float32)
    w = (rng.standard_normal((k ** 3, cin, cout)) * 0.1).astype(np.float32)
    bound = (np.abs(rng.standard_normal(cin)) + 0.5).astype(np.float32)
    return x, occ, w, bound


def port_weight(w):
    """JAX [k^3, Cin, Cout] cube ravel -> the port's [Cout, Cin, k, k, k]."""
    k = round(w.shape[0] ** (1 / 3))
    return torch.tensor(w.reshape(k, k, k, w.shape[1], w.shape[2])
                        .transpose(4, 3, 0, 1, 2).copy())


def as_jax(x, bf16):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def as_torch(x, bf16):
    t = torch.tensor(x)
    return t.bfloat16() if bf16 else t


def test_quantize_static_and_dequantize_bitwise():
    x, _, _, bound = make_case(0)
    ref = jd.quantize_static(jnp.asarray(x), jnp.asarray(bound))
    got = int8_ops.quantize_static(torch.tensor(x), torch.tensor(bound))
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert int(np.abs(np.asarray(ref.q)).max()) == 127  # saturates
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        r = np.asarray(jd.dequantize(ref, jdt).astype(jnp.float32))
        g = int8_ops.dequantize(got, tdt)
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), r)


# (k, static bound, bf16 input and output)
CONV_CASES = [(3, True, True), (3, False, False), (1, True, True),
              (1, False, True), (3, False, True)]


@pytest.mark.parametrize("k,static,bf16", CONV_CASES)
def test_dense_conv_same_int8_bitwise(k, static, bf16):
    x, occ, w, bound = make_case(1 + k, k=k)
    ref = jd.dense_conv_same_int8(
        as_jax(x, bf16), jnp.asarray(w), jnp.asarray(occ),
        out_dtype=jnp.bfloat16 if bf16 else jnp.float32,
        act_bound=jnp.asarray(bound) if static else None)
    got = int8_ops.dense_conv_same_int8(
        as_torch(x, bf16), port_weight(w), torch.tensor(occ),
        out_dtype=torch.bfloat16 if bf16 else torch.float32,
        act_bound=torch.tensor(bound) if static else None)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert np.abs(np.asarray(ref, np.float32)).max() > 0


def test_dense_conv_same_int8_qgrid_input_bitwise():
    """A QGrid (int8_residual's junction output) feeds the conv as it is."""
    x, occ, w, bound = make_case(7, cin=48, cout=48)
    jq = jd.quantize_static(jnp.asarray(x, jnp.bfloat16), jnp.asarray(bound))
    tq = int8_ops.quantize_static(torch.tensor(x).bfloat16(),
                                  torch.tensor(bound))
    ref = jd.dense_conv_same_int8(jq, jnp.asarray(w), jnp.asarray(occ),
                                  out_dtype=jnp.bfloat16)
    got = int8_ops.dense_conv_same_int8(tq, port_weight(w),
                                        torch.tensor(occ))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_quantize_weights_matches_the_chain_prep():
    """The weight quantizer against the JAX chain's `prep_weights_int8`
    (without its lane embedding)."""
    from mask3d_tpu.sparse import pallas_chain as pc

    _, _, w, bound = make_case(3)
    sx = np.asarray(jd.quantize_static(jnp.zeros(1), jnp.asarray(bound))
                    .scale)
    full, sw_full = pc.prep_weights_int8(jnp.asarray(w), jnp.asarray(sx),
                                         24, 48, None, None)
    wq, sw = int8_ops.quantize_weights(torch.tensor(w), torch.tensor(sx))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(full)[:, :24, :48])
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_full)[:48])


def test_pack_weights_layout():
    """The kernel's B fragments: word j of lane 4 * gid + tig in [tap, k32,
    n16] holds input channels 32 * k32 + 16 * (j % 2) + 4 * tig + (0..3)
    of output 8 * (2 * n16 + j // 2) + gid, zero padded; unpacking gives
    wq back."""
    rng = np.random.default_rng(4)
    wq = torch.tensor(rng.integers(-127, 128, (27, 24, 40)), dtype=torch.int8)
    words = pack_weights(wq, 32, 64)
    assert words.dtype == torch.int32 and tuple(words.shape) == (27, 1, 4,
                                                                 32, 4)
    b = words.contiguous().view(torch.int8).view(27, 1, 4, 32, 4, 4)
    padded = torch.zeros((27, 32, 64), dtype=torch.int8)
    padded[:, :24, :40] = wq
    for tap, n16, lane, j in ((0, 0, 0, 0), (5, 1, 13, 1), (26, 3, 31, 3),
                              (9, 2, 6, 2)):
        gid, tig = lane // 4, lane % 4
        c0 = 16 * (j % 2) + 4 * tig
        o = 8 * (2 * n16 + j // 2) + gid
        assert torch.equal(b[tap, 0, n16, lane, j], padded[tap, c0:c0 + 4, o])
    assert torch.equal(ic.unpack_weights(words, 24, 40), wq)
    back = ic.unpack_weights(words, 32, 64)
    assert not back[:, 24:].any() and not back[:, :, 40:].any()
    wide = torch.tensor(rng.integers(-127, 128, (1, 384, 256)),
                        dtype=torch.int8)
    assert torch.equal(ic.unpack_weights(pack_weights(wide, 384, 256), 384,
                                         256), wide)


# (grid dims, Cin, Cout, k, step) of every int8 conv the flagship `int8`
# and `int8_chain` forwards launch (Res16UNet34C at bucket 49152: stages
# 3-8 with min(Cin, Cout) >= 96; chip_smoke.py counts them on the card)
LEVELS = ((112, 80, 40), (56, 40, 20), (28, 20, 10), (14, 10, 5), (7, 5, 3))
FLAGSHIP_INT8 = [
    (LEVELS[0], 96, 96, 3, "conv"), (LEVELS[0], 128, 96, 3, "conv"),
    (LEVELS[0], 128, 96, 1, "conv"), (LEVELS[1], 96, 96, 3, "conv"),
    (LEVELS[1], 128, 96, 3, "conv"), (LEVELS[1], 128, 96, 1, "conv"),
    (LEVELS[2], 128, 128, 3, "conv"), (LEVELS[2], 192, 128, 3, "conv"),
    (LEVELS[2], 192, 128, 1, "conv"), (LEVELS[3], 128, 128, 3, "conv"),
    (LEVELS[3], 256, 256, 3, "conv"), (LEVELS[3], 384, 256, 3, "conv"),
    (LEVELS[3], 384, 256, 1, "conv"), (LEVELS[4], 256, 256, 3, "conv"),
    (LEVELS[4], 128, 256, 3, "conv"), (LEVELS[4], 128, 256, 1, "conv"),
] + [(lv, cin, 96, 3, step) for lv in LEVELS[:2]
     for cin, step in ((128, "entry"), (96, "mid"), (96, "junction"))]
# the 384-wide stages 5-8 of Res16UNet14D / 18D (int8 convs of a CPU
# forward) at the flagship's grids
WIDE_INT8 = [(lv, cin, 384, k, "conv") for lv, cin in (
    (LEVELS[0], 416), (LEVELS[1], 416), (LEVELS[2], 448), (LEVELS[3], 512))
    for k in (1, 3)] + [(lv, 384, 384, 3, "conv") for lv in LEVELS[:4]]
STEP_MODE = {"conv": "none", "entry": "none", "mid": "affine",
             "junction": "join"}


@pytest.mark.parametrize("shape", FLAGSHIP_INT8 + WIDE_INT8)
def test_plan_at_flagship_shapes(shape):
    """The plan of every flagship int8 conv fits the shared memory, gives
    each warp mf fragments and every output channel a warp, keeps each
    ldmatrix phase free of bank conflicts, and splits only the small grids
    (at most one split per stage)."""
    dims, cin, cout, k, step = shape
    p = ic.plan(8, dims, cin, cout, k, STEP_MODE[step])
    for mf in ic.FRAGS_PER_WARP:  # every alternative fits too
        assert ic.plan(8, dims, cin, cout, k, STEP_MODE[step],
                       mf=mf).smem <= ic.SMEM_BYTES
    assert p.smem <= ic.SMEM_BYTES
    assert p.smem == ic.smem_bytes(p.cin_p, p.cout_p, p.npos, p.kcs,
                                   16 * int(np.prod(p.tile_frags)),
                                   int(np.prod(p.tile_frags)),
                                   step in ("mid", "junction"))
    assert p.mf == (2 if cout > 96 and k == 3 else 1)
    with pytest.raises(ValueError):  # a tile too large for the card
        ic.plan(8, dims, 8192, cout, k, mf=2)
    nr = p.cout_p // (8 * p.nt)
    assert ic.WARPS % nr == 0 and p.cout_p >= cout
    assert int(np.prod(p.tile_frags)) == ic.WARPS // nr * p.mf
    assert ic.conflict_free(p.ys, p.xs)
    hx, hy, hz = (t + k - 1 for t in p.tile)
    assert p.ys >= hz and p.xs >= hy * p.ys
    assert p.npos == (hx - 1) * p.xs + (hy - 1) * p.ys + hz
    assert p.kcs * p.cout_p * 32 <= max(ic.STAGE_BYTES, p.cout_p * 32)
    stages = k ** 3 * -(-(p.cin_p // 32) // p.kcs)
    assert 1 <= p.splits <= max(1, min(stages // ic.MIN_SPLIT_STAGES,
                                       ic.MAX_SPLITS))
    tiles = 8 * p.tiles(dims)
    assert p.splits == 1 or tiles * p.splits <= ic.SMS + tiles
    if dims == LEVELS[0]:
        assert p.splits == 1


@pytest.mark.parametrize("hy,hz", [(6, 6), (10, 10), (4, 18), (3, 3),
                                   (12, 5)])
def test_fragment_shapes_have_conflict_free_strides(hy, hz):
    """The halo strides the plan takes keep both ldmatrix phases of a 4x4x1
    fragment in 8 distinct bank groups, and a stride with a conflict is
    refused."""
    ys, xs = ic.halo_strides(hy, hz)
    assert ys >= hz and xs >= hy * ys and ic.conflict_free(ys, xs)
    assert np.prod(ic.FRAG) == 16 and not ic.conflict_free(8, 8 * hy)


def kernel_mirror(x, occ, wq, sw, mode, p, *, wdq=None, swd=None,
                  out_dtype=torch.bfloat16, **kw):
    """The kernel's work in plain PyTorch: only the cells of fragments with
    an occupied output are computed (16-cell fragments of `ic.FRAG`, tiles
    of `p.tile` from the origin), and each split sums its share of the
    (tap, chunk group) stages into its own integer partials, which are
    then added; the centre tap of `wdq` runs in split 0."""
    q = x if mode == "none" else ic.prologue_plain(
        x, occ, kw["A"], kw["Bc"], kw["inv"],
        kw.get("res") if mode == "join" else None, kw.get("Ar"),
        kw.get("Br"))
    b, gx, gy, gz, cin = q.shape
    k = round(wq.shape[0] ** (1 / 3))
    r = k // 2
    (tx, ty, tz), (fx, fy, fz) = p.tile, ic.FRAG
    pads = [-(-d // t) * t for d, t in zip((gx, gy, gz), p.tile)]
    o = torch.zeros((b, *pads), dtype=torch.bool)
    o[:, :gx, :gy, :gz] = occ[..., 0] > 0.5
    f = o.view(b, pads[0] // fx, fx, pads[1] // fy, fy, pads[2] // fz, fz)
    live = f.any(dim=6, keepdim=True).any(dim=4, keepdim=True).any(
        dim=2, keepdim=True).expand_as(f).reshape(b, *pads)
    live = live[:, :gx, :gy, :gz, None]
    qp = torch.nn.functional.pad(q.double(), (0, 0, r, r, r, r, r, r))
    nkc = p.cin_p // 32
    groups = -(-nkc // p.kcs)
    stages = [(tap, g * p.kcs * 32, min(cin, (g + 1) * p.kcs * 32))
              for tap in range(k ** 3) for g in range(groups)]

    def partial(tap, c0, c1, w):
        dx, dy, dz = tap // (k * k), (tap // k) % k, tap % k
        sh = qp[:, dx:dx + gx, dy:dy + gy, dz:dz + gz, c0:c1]
        return sh @ w[tap, c0:c1].double()

    acc = torch.zeros((b, gx, gy, gz, wq.shape[2]), dtype=torch.float64)
    for s in range(p.splits):
        part = torch.zeros_like(acc)
        lo, hi = (len(stages) * s // p.splits,
                  len(stages) * (s + 1) // p.splits)
        for tap, c0, c1 in stages[lo:hi]:
            if c0 < c1:
                part += partial(tap, c0, c1, wq)
        acc += torch.round(part) * live
    out = (acc.float() * sw * occ).to(out_dtype)
    out2 = None
    if wdq is not None:
        centre = torch.zeros_like(acc)
        for c0 in range(0, cin, 32 * p.kcs):
            centre += q[..., c0:c0 + 32 * p.kcs].double() @ \
                wdq[0, c0:c0 + 32 * p.kcs].double()
        out2 = (torch.round(centre * live).float() * swd * occ).to(
            torch.bfloat16)
    return out, out2, (q if mode == "join" else None)


def scene_occupancy():
    """The occupancy grids [B, X, Y, Z, 1] of the parity scenes' levels."""
    from torch_parity import scene_items

    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.data import collate as col
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
    from mask3d_tpu_torch.infer import level_capacities
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    cfg = apply_overrides(Config(), ["data.point_bucket_multiple=1024"])
    dev = col.collate(scene_items(make=make_synthetic_scene), device="cpu",
                      point_bucket_multiple=1024).device
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(cfg, dev.capacity),
                            dev.grid_dims)
    return [o.float() for o in sb.occ]


MIRROR = [  # (occupancy source, Cin, Cout, k, step)
    ("scene0", 96, 96, 3, "conv"), ("scene1", 128, 96, 3, "entry"),
    ("scene0", 96, 80, 3, "junction"),
    ("scene2", 128, 128, 1, "conv"),
    ("scene3", 256, 256, 3, "mid"),
    ("ragged", 96, 96, 3, "junction"),
    ("ragged", 384, 256, 3, "conv"),
    ("empty_item", 96, 96, 3, "entry"),
    ("scene3", 416, 384, 3, "conv"),
]


@pytest.fixture(scope="module")
def occupancies():
    occs = {f"scene{i}": o for i, o in enumerate(scene_occupancy())}
    rng = np.random.default_rng(11)
    occs["ragged"] = torch.tensor(  # dims no multiple of any tile
        (rng.random((2, 9, 7, 11, 1)) < 0.2).astype(np.float32))
    empty = (rng.random((2, 10, 9, 13, 1)) < 0.3).astype(np.float32)
    empty[1] = 0.0
    occs["empty_item"] = torch.tensor(empty)
    return occs


@pytest.mark.parametrize("case", MIRROR)
def test_skip_and_split_mirror_matches_plain(case, occupancies):
    """The kernel's skip rule and split, mirrored in plain PyTorch, give
    int8_conv_plain's outputs bitwise (conv, out2, yq), under the plan the
    wrapper picks (split where the grid is small) and unsplit."""
    import dataclasses

    src, cin, cout, k, step = case
    occ = occupancies[src]
    gen = torch.Generator().manual_seed(cin + cout + k)
    b, dims = occ.shape[0], tuple(occ.shape[1:4])

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen).to(torch.int8)

    wq, sw = int8(k ** 3, cin, cout), rnd(cout).abs() * 1e-3
    kw = dict(stats=step != "conv")
    mode = STEP_MODE[step]
    if mode == "none":
        x = (int8(b, *dims, cin).int() * occ.int()).to(torch.int8)
        if step == "entry":
            kw.update(wdq=int8(1, cin, cout), swd=rnd(cout).abs() * 1e-3)
    else:
        x = (rnd(b, *dims, cin) * occ).bfloat16()
        kw.update(A=rnd(b, cin), Bc=rnd(b, cin) * 0.1,
                  inv=rnd(cin).abs() * 40)
        if mode == "join":
            kw.update(res=(rnd(b, *dims, cin) * 60 * occ).to(torch.int8),
                      Ar=rnd(b, cin) * 0.02, Br=rnd(b, cin) * 0.1)
    ref = int8_conv_plain(x, occ, wq, sw, mode, **kw)
    p = ic.plan(b, dims, cin, cout, k, mode)
    plans = {p, dataclasses.replace(p, splits=1),
             dataclasses.replace(p, splits=5)}
    try:  # 2 fragments a warp: twice the tile, where it fits
        plans.add(ic.plan(b, dims, cin, cout, k, mode, mf=2))
    except ValueError:
        assert cin * cout >= 384 * 256
    for pl in plans:
        out, out2, yq = kernel_mirror(x, occ, wq, sw, mode, pl, **kw)
        assert torch.equal(out, ref.out), (case, pl.splits)
        assert (out2 is None) == (ref.out2 is None)
        assert out2 is None or torch.equal(out2, ref.out2)
        assert yq is None or torch.equal(yq, ref.yq)
    assert ref.out.float().abs().max() > 0


def test_int8_conv_wrapper_checks_and_cpu_plain():
    """A CPU tensor takes the plain version and counts no launch; bad
    arguments raise."""
    x, occ, w, bound = make_case(5)
    xq = int8_ops.quantize_static(torch.tensor(x), torch.tensor(bound))
    wq, sw = int8_ops.quantize_weights(torch.tensor(w), xq.scale)
    occ_t = torch.tensor(occ)
    n = int8_conv.launches
    got = int8_conv(xq.q, occ_t, wq, sw)
    ref = int8_conv_plain(xq.q, occ_t, wq, sw)
    assert torch.equal(got.out, ref.out) and int8_conv.launches == n
    with pytest.raises(TypeError):
        int8_conv(xq.q.float(), occ_t, wq, sw)  # mode none wants int8
    with pytest.raises(ValueError):
        int8_conv(torch.tensor(x).bfloat16(), occ_t, wq, sw,
                  "affine")  # no prologue consts
    with pytest.raises(ValueError):
        int8_conv(xq.q, occ_t[..., :5, :], wq, sw)
