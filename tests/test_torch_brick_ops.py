"""The port's bricked level-0 ops (`mask3d_tpu_torch/sparse/brick_ops.py`)
against the JAX package's `sparse/brick_ops.py` on the same numpy-seeded
scene (GRID 32x16x8, BRICK 8x8x4, as tests/test_brick_ops.py): the tables,
the row scatter/gather and the halo exactly; the convs and the norm within
1e-5 in f32, and against the port's dense ops. A capacity below the
occupied bricks is flagged and the bricked backbone raises on what it
cannot run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.sparse import brick_ops as J
from mask3d_tpu.sparse.core import SparseLevel as JLevel
from mask3d_tpu_torch.sparse import brick_ops as T
from mask3d_tpu_torch.sparse import dense_ops as TD
from mask3d_tpu_torch.sparse.core import SparseLevel as TLevel
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

GRID = (32, 16, 8)
BRICK = (8, 8, 4)
CAP = 64
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _level_np(coords, cap, dims=GRID):
    n = len(coords)
    keys = ((coords[:, 0] * dims[1] + coords[:, 1]) * dims[2]
            + coords[:, 2]).astype(np.int32)
    pad = cap - n
    coords = np.concatenate([coords, np.zeros((pad, 3), np.int32)])
    keys = np.concatenate([keys, np.full(pad, 2**31 - 1, np.int32)])
    return dict(key=keys[None], coords=coords[None],
                valid=(np.arange(cap) < n)[None],
                count=np.asarray([n], np.int32),
                dims=np.asarray(dims, np.int32)[None])


def _levels(a, stride=1):
    j = JLevel(**{k: jnp.asarray(v) for k, v in a.items()}, stride=stride)
    t = TLevel(**{k: _t(v) for k, v in a.items()}, stride=stride)
    return j, t


def _scene(seed=0, n=180, cap=256, c=6):
    """Unique random occupied cells of GRID and their features, both
    packages' levels, specs and tables."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(np.prod(GRID), size=n, replace=False))
    coords = np.stack([keys // (GRID[1] * GRID[2]),
                       (keys // GRID[2]) % GRID[1],
                       keys % GRID[2]], 1).astype(np.int32)
    lj, lt = _levels(_level_np(coords, cap))
    feats = rng.standard_normal((1, cap, c)).astype(np.float32)
    feats[0, n:] = 0
    sj = J.make_brick_spec(GRID, BRICK, CAP)
    st = T.make_brick_spec(GRID, BRICK, CAP)
    return dict(rng=rng, lj=lj, lt=lt, feats=feats, sj=sj, st=st,
                tj=J.build_tables(lj, sj), tt=T.build_tables(lt, st))


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _conv_w(w, k):
    """[K, Cin, Cout] cube ravel -> [Cout, Cin, k, k, k]."""
    return _t(w.reshape(k, k, k, w.shape[1], w.shape[2]).transpose(
        4, 3, 0, 1, 2).copy())


def _mk_coarse(lvl_np, dims):
    """The coarse level of the parent cells of the fine rows."""
    c = lvl_np["coords"][0][lvl_np["valid"][0]] // 2
    uk = np.unique((c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2])
    coords = np.stack([uk // (dims[1] * dims[2]), (uk // dims[2]) % dims[1],
                       uk % dims[2]], 1).astype(np.int32)
    return _level_np(coords, lvl_np["coords"].shape[1], dims)


def test_tables_match_jax():
    s = _scene()
    tj, tt = s["tj"], s["tt"]
    for name in ("slot_key", "brick_ok", "nbr", "row_flat", "overflow"):
        want = np.asarray(getattr(tj, name))
        got = getattr(tt, name).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), name)
    assert not bool(tt.overflow)
    assert int(tt.brick_ok.sum()) > 8  # several bricks, neighbours inside


def test_scatter_gather_and_halo_match_jax():
    s = _scene()
    bj = J.scatter_rows(jnp.asarray(s["feats"]), s["tj"], s["sj"])
    bt = T.scatter_rows(_t(s["feats"]), s["tt"], s["st"])
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert float(bt[CAP].abs().max()) == 0.0  # the sentinel stays zero
    rows = T.gather_rows(bt, s["tt"], s["st"], s["lt"].valid)
    np.testing.assert_array_equal(rows.numpy(), s["feats"])
    np.testing.assert_array_equal(
        T.occupancy(s["tt"], s["st"], s["lt"].valid).numpy(),
        np.asarray(J.occupancy(s["tj"], s["sj"], s["lj"].valid)))
    for h in (1, 2):
        np.testing.assert_array_equal(
            T.halo_pad(bt, s["tt"], s["st"], h).numpy(),
            np.asarray(J.halo_pad(bj, s["tj"], s["sj"], h)))
    # the brick layout agrees with the dense grid cell for cell
    dense = TD.scatter_rows(_t(s["feats"]), s["lt"], GRID)
    np.testing.assert_array_equal(
        T.slots_to_dense(bt[:CAP], s["tt"], s["st"]).numpy(), dense.numpy())


@pytest.mark.parametrize("k", [3, 5])
def test_conv_same_matches_jax_and_dense(k):
    s = _scene()
    rng, c, co = s["rng"], s["feats"].shape[-1], 5
    w = rng.standard_normal((k ** 3, c, co)).astype(np.float32) * 0.2
    bias = rng.standard_normal(co).astype(np.float32)
    bj = J.scatter_rows(jnp.asarray(s["feats"]), s["tj"], s["sj"])
    occ_j = J.occupancy(s["tj"], s["sj"], s["lj"].valid)
    want = J.conv_same(bj, jnp.asarray(w), occ_j, s["tj"], s["sj"],
                       bias=jnp.asarray(bias))
    bt = T.scatter_rows(_t(s["feats"]), s["tt"], s["st"])
    occ_t = T.occupancy(s["tt"], s["st"], s["lt"].valid)
    got = T.conv_same(bt, _conv_w(w, k), occ_t, s["tt"], s["st"],
                      bias=_t(bias))
    _close(want, got)
    # and the port's dense conv on the same scene (bias-free)
    got0 = T.conv_same(bt, _conv_w(w, k), occ_t, s["tt"], s["st"])
    dense = TD.dense_conv_same(TD.scatter_rows(_t(s["feats"]), s["lt"], GRID),
                               _conv_w(w, k),
                               TD.occupancy(s["lt"], GRID))
    _close(TD.gather_rows(dense, s["lt"], GRID).numpy(),
           T.gather_rows(got0, s["tt"], s["st"], s["lt"].valid))


def test_conv_same_chunked_equals_unchunked():
    s = _scene()
    w = s["rng"].standard_normal((27, 6, 5)).astype(np.float32) * 0.2
    bt = T.scatter_rows(_t(s["feats"]), s["tt"], s["st"])
    occ = T.occupancy(s["tt"], s["st"], s["lt"].valid)
    full = T.conv_same(bt, _conv_w(w, 3), occ, s["tt"], s["st"], chunk=0)
    for chunk in (24, 7):
        assert torch.equal(
            T.conv_same(bt, _conv_w(w, 3), occ, s["tt"], s["st"],
                        chunk=chunk), full)


def test_conv_down_and_tr_match_jax():
    s = _scene()
    rng, c = s["rng"], s["feats"].shape[-1]
    cdims = tuple(g // 2 for g in GRID)
    coarse = _mk_coarse({k: np.asarray(getattr(s["lj"], k))
                         for k in ("key", "coords", "valid", "count",
                                   "dims")}, cdims)
    cj, ct = _levels(coarse, stride=2)
    occ1 = TD.occupancy(ct, cdims)
    # conv_down
    w = rng.standard_normal((8, c, 7)).astype(np.float32) * 0.3
    bj = J.scatter_rows(jnp.asarray(s["feats"]), s["tj"], s["sj"])
    bt = T.scatter_rows(_t(s["feats"]), s["tt"], s["st"])
    want = J.conv_down(bj, jnp.asarray(w), jnp.asarray(occ1.numpy()),
                       s["tj"], s["sj"], cdims)
    got = T.conv_down(bt, _conv_w(w, 2), occ1, s["tt"], s["st"], cdims)
    _close(want, got)
    # conv_tr: out[2i+d] = in[i] @ w[d]
    cfeats = rng.standard_normal((1, 256, c)).astype(np.float32)
    cfeats[0, int(coarse["count"][0]):] = 0
    cdense = TD.scatter_rows(_t(cfeats), ct, cdims)
    w = rng.standard_normal((8, c, 4)).astype(np.float32) * 0.3
    wt = _t(w.reshape(2, 2, 2, c, 4).transpose(3, 4, 0, 1, 2).copy())
    occ_j = J.occupancy(s["tj"], s["sj"], s["lj"].valid)
    occ_t = T.occupancy(s["tt"], s["st"], s["lt"].valid)
    want = J.conv_tr(jnp.asarray(cdense.numpy()), jnp.asarray(w), occ_j,
                     s["tj"], s["sj"])
    got = T.conv_tr(cdense, wt, occ_t, s["tt"], s["st"])
    _close(want, got)
    dense = TD.dense_conv_tr(cdense, wt, TD.occupancy(s["lt"], GRID))
    _close(TD.gather_rows(dense, s["lt"], GRID).numpy(),
           T.gather_rows(got, s["tt"], s["st"], s["lt"].valid))


@pytest.mark.parametrize("chunk", [2048, 5])
def test_instance_norm_matches_jax(chunk):
    s = _scene()
    rng, c = s["rng"], s["feats"].shape[-1]
    g = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    bj = J.scatter_rows(jnp.asarray(s["feats"]), s["tj"], s["sj"])
    bt = T.scatter_rows(_t(s["feats"]), s["tt"], s["st"])
    want = J.instance_norm(bj, J.occupancy(s["tj"], s["sj"], s["lj"].valid),
                           jnp.asarray(g), jnp.asarray(b))
    occ_t = T.occupancy(s["tt"], s["st"], s["lt"].valid)
    got = T.instance_norm(bt, occ_t, _t(g), _t(b), chunk=chunk)
    _close(want, got)
    assert float(got[CAP].abs().max()) == 0.0


def test_overflow_is_flagged_and_drops_nothing_silently():
    """A capacity below the occupied bricks: both packages flag it (the
    JAX package then drops those voxels unread); the port's bricked
    backbone puts the flag into the sparse batch's `any_overflow()`."""
    from mask3d_tpu_torch.models.backbone import _BrickCtx
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    s = _scene(seed=1, n=200)
    tj = J.build_tables(s["lj"], J.make_brick_spec(GRID, BRICK, 4))
    tt = T.build_tables(s["lt"], T.make_brick_spec(GRID, BRICK, 4))
    assert bool(tj.overflow) and bool(tt.overflow)
    np.testing.assert_array_equal(tt.row_flat.numpy(),
                                  np.asarray(tj.row_flat))
    lt = s["lt"]
    sb = build_sparse_batch(lt.coords, lt.count, lt.dims, [256] * 4,
                            [tuple(max(1, d >> i) for d in GRID)
                             for i in range(5)])
    assert not bool(sb.any_overflow())
    _BrickCtx(sb, [tuple(max(1, d >> i) for d in GRID) for i in range(5)],
              brick_dims=BRICK, brick_capacity=4)
    assert bool(sb.any_overflow())


@pytest.mark.parametrize("bad", ["batch", "brick_dims", "odd", "int8"])
def test_bricked_refuses_what_it_cannot_run(bad):
    from mask3d_tpu_torch.models.backbone import BACKBONES
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    if bad == "int8":
        with pytest.raises(NotImplementedError):
            BACKBONES["Res16UNet14A"](impl="bricked", int8_stride1=True)
        return
    if bad == "odd":
        with pytest.raises(ValueError, match="even"):
            T.make_brick_spec((30, 16, 8), (3, 8, 4))
        return
    s = _scene()
    lt = s["lt"]
    grids = [tuple(max(1, d >> i) for d in GRID) for i in range(5)]
    b = 2 if bad == "batch" else 1
    sb = build_sparse_batch(lt.coords.expand(b, -1, -1),
                            lt.count.expand(b), lt.dims.expand(b, -1),
                            [256] * 4, grids)
    bb = BACKBONES["Res16UNet14A"](
        impl="bricked", conv1_kernel_size=3,
        brick_dims=(5, 8, 4) if bad == "brick_dims" else BRICK,
        brick_capacity=CAP)
    with pytest.raises(ValueError):
        bb(torch.ones(b, lt.coords.shape[1], 1), sb, grids)
