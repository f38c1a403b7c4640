"""Dense-grid ops and the row gather of the PyTorch port against the JAX
package's `sparse/dense_ops.py` and Pallas `monotone_gather` (interpret
mode on the CPU). Convolutions and norms within 1e-5; scatter, gather and
pools exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.sparse import dense_ops as J
from mask3d_tpu.sparse.core import build_base_level as j_base
from mask3d_tpu.sparse.pallas_gather import monotone_gather
from mask3d_tpu_torch.sparse import dense_ops as T
from mask3d_tpu_torch.sparse.core import build_base_level as t_base
from mask3d_tpu_torch.sparse.row_gather import row_gather
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

TOL = 1e-5
GRID = (7, 6, 5)  # odd dims exercise the pads and the overhang slice


def _t(a):
    return torch.tensor(np.asarray(a))


def _grid(rng, c, grid=GRID, b=2):
    occ = (rng.random((b,) + grid + (1,)) < 0.5).astype(np.float32)
    x = rng.normal(size=(b,) + grid + (c,)).astype(np.float32) * occ
    return x, occ


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _conv_w(w, k):
    """[K, Cin, Cout] cube ravel -> [Cout, Cin, k, k, k]."""
    return _t(w.reshape(k, k, k, w.shape[1], w.shape[2]).transpose(
        4, 3, 0, 1, 2).copy())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_dense_conv_same(k):
    rng = np.random.default_rng(k)
    x, occ = _grid(rng, 8)
    w = rng.normal(size=(k ** 3, 8, 16)).astype(np.float32) / k
    _close(J.dense_conv_same(x, w, occ),
           T.dense_conv_same(_t(x), _conv_w(w, k), _t(occ)))


def test_dense_conv_down():
    rng = np.random.default_rng(1)
    x, _ = _grid(rng, 8)
    occ_c = (rng.random((2, 4, 3, 3, 1)) < 0.6).astype(np.float32)
    w = rng.normal(size=(8, 8, 16)).astype(np.float32)
    _close(J.dense_conv_down(x, w, occ_c),
           T.dense_conv_down(_t(x), _conv_w(w, 2), _t(occ_c)))


def test_dense_conv_tr():
    rng = np.random.default_rng(2)
    xc = rng.normal(size=(2, 4, 3, 3, 8)).astype(np.float32)
    _, occ_f = _grid(rng, 1)
    w = rng.normal(size=(8, 8, 16)).astype(np.float32)
    wt = _t(w.reshape(2, 2, 2, 8, 16).transpose(3, 4, 0, 1, 2).copy())
    _close(J.dense_conv_tr(xc, w, occ_f), T.dense_conv_tr(_t(xc), wt,
                                                         _t(occ_f)))


def test_dense_instance_norm_keeps_empty_cells_zero():
    rng = np.random.default_rng(3)
    x, occ = _grid(rng, 16)
    g = rng.normal(size=(16,)).astype(np.float32)
    bt = rng.normal(size=(16,)).astype(np.float32)
    got = T.dense_instance_norm(_t(x), _t(occ), _t(g), _t(bt))
    _close(J.dense_instance_norm(x, occ, g, bt), got)
    assert not got.numpy()[np.broadcast_to(occ, got.shape) == 0].any()


def test_stem_is_conv_norm_relu():
    """The JAX fused z-folded stem equals conv -> norm -> relu."""
    rng = np.random.default_rng(4)
    _, occ = _grid(rng, 1)
    w = rng.normal(size=(125, 1, 32)).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    bt = rng.normal(size=(32,)).astype(np.float32)
    ref = J.dense_stem_fused(occ, w, occ, g, bt)
    got = torch.relu(T.dense_instance_norm(
        T.dense_conv_same(_t(occ), _conv_w(w, 5), _t(occ)), _t(occ), _t(g),
        _t(bt)))
    _close(ref, got)


def test_pools_and_coord_grid_exact():
    rng = np.random.default_rng(5)
    x, occ = _grid(rng, 3)
    np.testing.assert_array_equal(T.maxpool2(_t(occ)).numpy(),
                                  np.asarray(J.maxpool2(occ)))
    np.testing.assert_array_equal(T.sumpool2(_t(occ)).numpy(),
                                  np.asarray(J.sumpool2(occ)))
    _close(J.sumpool2(x), T.sumpool2(_t(x)))
    np.testing.assert_array_equal(
        T.cell_coord_grid(GRID, 2).numpy(),
        np.asarray(J.cell_coord_grid(GRID, 2)))


def _levels(rng, grid=(12, 10, 8), cap=256):
    coords = np.zeros((2, cap, 3), np.int32)
    counts = np.zeros((2,), np.int32)
    for b in range(2):
        pts = np.unique(rng.integers(0, grid, size=(150, 3)), axis=0)
        coords[b, :len(pts)] = pts
        counts[b] = len(pts)
    dims = np.tile(np.array(grid, np.int32), (2, 1))
    return (j_base(coords, counts, dims),
            t_base(_t(coords), _t(counts), _t(dims)))


def test_scatter_gather_occupancy_exact():
    rng = np.random.default_rng(6)
    grid = (12, 10, 8)
    jl, tl = _levels(rng, grid)
    feats = rng.normal(size=(2, 256, 5)).astype(np.float32)
    jd = J.scatter_rows(feats, jl, grid)
    td = T.scatter_rows(_t(feats), tl, grid)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(T.occupancy(tl, grid).numpy(),
                                  np.asarray(J.occupancy(jl, grid)))
    for mono in (False, True):
        np.testing.assert_array_equal(
            T.gather_rows(td, tl, grid).numpy(),
            np.asarray(J.gather_rows(jd, jl, grid, monotone=mono)))


def test_pooled_row_pyramid():
    rng = np.random.default_rng(7)
    grid = (16, 12, 8)
    coords = np.zeros((2, 512, 3), np.int32)
    counts = np.zeros((2,), np.int32)
    for b in range(2):
        pts = np.unique(rng.integers(0, grid, size=(400, 3)), axis=0)
        coords[b, :len(pts)] = pts
        counts[b] = len(pts)
    dims = np.tile(np.array(grid, np.int32), (2, 1))
    grid_dims = [grid]
    for _ in range(2):
        grid_dims.append(tuple(((d - 1) >> 1) + 1 for d in grid_dims[-1]))
    from mask3d_tpu.sparse import build_sparse_batch as j_build
    from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build

    caps = [256, 128]
    jsb = j_build(coords, counts, dims, caps, grid_dims=grid_dims,
                  build_block_maps=False, conv1_kernel_size=None,
                  build_pool_parents=False)
    tsb = t_build(_t(coords), _t(counts), _t(dims), caps, grid_dims)
    g = rng.normal(size=(2,) + grid + (6,)).astype(np.float32) * np.asarray(
        jsb.occ[0])
    ref = J.pooled_row_pyramid([g], jsb.occ, jsb.levels, grid_dims)
    got = T.pooled_row_pyramid([_t(g)], tsb.occ, tsb.levels, grid_dims)
    assert len(ref) == len(got) == 2
    for r, o in zip(ref, got):
        _close(r[0], o[0])


# tests/test_pallas_gather.py shapes: (b, n, c, m, seed, monotone idx)
GATHERS = [(2, 4096, 24, 512, 0, True), (2, 4096, 24, 512, 1, True),
           (1, 4096, 8, 512, 2, False), (3, 4096, 24, 768, 7, True),
           (2, 4096, 3, 512, 11, True)]


@pytest.mark.parametrize("case", range(len(GATHERS)))
def test_row_gather_matches_monotone_gather(case):
    """The plain row gather equals the JAX Pallas kernel (interpret mode)
    exactly: f32 sources select in f32 there."""
    b, n, c, m, seed, mono = GATHERS[case]
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    if mono:
        idx = np.cumsum(rng.integers(1, 6, size=(b, m)), axis=1).astype(
            np.int32)
    else:
        idx = rng.integers(0, n, size=(b, m)).astype(np.int32)
    ok = rng.random((b, m)) < 0.9
    tile = 256 if m % 256 == 0 else 128
    ref = monotone_gather(jnp.asarray(src), jnp.asarray(idx),
                          jnp.asarray(ok), tile, 2048)
    got = row_gather(_t(src), _t(idx), _t(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert jax.default_backend() == "cpu"


def test_zfold_conv_and_folded_stage_match_jax():
    """`dense_conv_same_zfold` against the JAX package's and the port's
    unfolded conv, and a two-block `dense_basic_stage_folded` against the
    JAX package's, on one grid (TOL); the JAX side jitted (an eager call
    compiles each small op alone)."""
    rng = np.random.default_rng(4)
    x, occ = _grid(rng, 8)
    w = rng.normal(size=(27, 8, 8)).astype(np.float32) / 8
    got = T.dense_conv_same_zfold(_t(x), _conv_w(w, 3), _t(occ))
    _close(jax.jit(J.dense_conv_same_zfold)(x, w, occ), got)
    _close(T.dense_conv_same(_t(x), _conv_w(w, 3), _t(occ)).numpy(), got)
    blocks = [dict(w1=rng.normal(size=(27, 8, 8)).astype(np.float32) / 8,
                   w2=rng.normal(size=(27, 8, 8)).astype(np.float32) / 8,
                   g1=rng.uniform(0.5, 1.5, 8).astype(np.float32),
                   b1=rng.normal(0, 0.2, 8).astype(np.float32),
                   g2=rng.uniform(0.5, 1.5, 8).astype(np.float32),
                   b2=rng.normal(0, 0.2, 8).astype(np.float32))
              for _ in range(2)]
    tblocks = [{k: _conv_w(v, 3) if k[0] == "w" else _t(v)
                for k, v in blk.items()} for blk in blocks]
    _close(jax.jit(J.dense_basic_stage_folded)(x, occ, blocks),
           T.dense_basic_stage_folded(_t(x), _t(occ), tblocks))
