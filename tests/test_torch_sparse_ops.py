"""Row-space sparse ops of the PyTorch port (`sparse/ops.py`) against the
JAX package's `mask3d_tpu/sparse/ops.py`, fp32, on the kernel maps and
PoolMaps of a real collated batch. Tolerance 1e-5 * max(1, std(ref)): both
sides sum in f32, in another order."""

import jax
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse import ops as J
from mask3d_tpu_torch.sparse import ops as T
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.torch_parity import BUCKET, assert_scaled_close, scene_items

TOL = 1e-5
CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)


@pytest.fixture(scope="module")
def sbs():
    """The gather-path sparse context of one batch in both packages."""
    dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(
        scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims
    ref = jax.jit(lambda c, n, d: j_build(
        c, n, d, caps, conv1_kernel_size=5, grid_dims=gd))(
        dev.coords, dev.counts, dev.dims)
    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    got = t_build(*t, caps, gd, conv1_kernel_size=5, build_block_maps=True,
                  build_pool_parents=True)
    return ref, got


def _feats(rng, level, c):
    """Random rows, zero on padding rows (as the backbone keeps them)."""
    n = level.key.shape[1]
    x = rng.normal(size=(level.key.shape[0], n, c)).astype(np.float32)
    return x * np.asarray(level.valid)[..., None]


@pytest.mark.parametrize("level,k", [(0, 27), (0, 125), (2, 27)])
def test_sparse_conv_matches(sbs, level, k):
    ref, got = sbs
    rng = np.random.default_rng(level + k)
    x = _feats(rng, ref.levels[level], 8)
    w = (rng.normal(size=(k, 8, 16)) / np.sqrt(8 * k)).astype(np.float32)
    if k == 27:
        j_map = (ref.nbr_idx[level], ref.nbr_ok[level])
        t_map = (got.nbr_idx[level], got.nbr_ok[level])
    else:
        j_map = (ref.nbr0_idx, ref.nbr0_ok)
        t_map = (got.nbr0_idx, got.nbr0_ok)
    want = J.sparse_conv(x, w, *j_map)
    out = T.sparse_conv(torch.tensor(x), torch.tensor(w), *t_map)
    assert out.dtype == torch.float32
    assert_scaled_close(want, out, TOL, f"sparse_conv L{level} K={k}")


@pytest.mark.parametrize("fine", [0, 3])
def test_sparse_conv_down_matches(sbs, fine):
    ref, got = sbs
    rng = np.random.default_rng(10 + fine)
    x = _feats(rng, ref.levels[fine], 8)
    w = rng.normal(size=(8, 8, 16)).astype(np.float32) / 8
    cap = ref.levels[fine + 1].capacity
    want = J.sparse_conv_down(x, w, ref.pools[fine], cap)
    out = T.sparse_conv_down(torch.tensor(x), torch.tensor(w),
                             got.pools[fine], cap)
    assert_scaled_close(want, out, TOL, "sparse_conv_down")


@pytest.mark.parametrize("coarse", [1, 4])
def test_sparse_conv_tr_matches(sbs, coarse):
    ref, got = sbs
    rng = np.random.default_rng(20 + coarse)
    x = _feats(rng, ref.levels[coarse], 16)
    w = rng.normal(size=(8, 16, 8)).astype(np.float32) / 4
    want = J.sparse_conv_tr(x, w, ref.pools[coarse - 1],
                            ref.levels[coarse - 1].valid)
    out = T.sparse_conv_tr(torch.tensor(x), torch.tensor(w),
                           got.pools[coarse - 1],
                           got.levels[coarse - 1].valid)
    assert_scaled_close(want, out, TOL, "sparse_conv_tr")


def test_avg_pool_chain_matches(sbs):
    """The row-space pooled pyramid: [coords | features] mean-pooled level
    by level, as the model's gather path does."""
    ref, got = sbs
    rng = np.random.default_rng(30)
    x = np.concatenate([np.asarray(ref.levels[0].coords, np.float32),
                        _feats(rng, ref.levels[0], 5)], axis=-1)
    xj, xt = x, torch.tensor(x)
    for i in range(len(ref.pools)):
        cap = ref.levels[i + 1].capacity
        xj = J.avg_pool(xj, ref.pools[i], cap)
        xt = T.avg_pool(xt, got.pools[i], cap)
        assert_scaled_close(xj, xt, TOL, f"avg_pool level {i + 1}")


def test_instance_norm_matches(sbs):
    ref, got = sbs
    rng = np.random.default_rng(40)
    x = _feats(rng, ref.levels[1], 12) * 3.0 + 1.0
    gamma = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    beta = rng.normal(0, 0.2, 12).astype(np.float32)
    want = J.instance_norm(x, ref.levels[1].valid, gamma, beta)
    out = T.instance_norm(torch.tensor(x), got.levels[1].valid,
                          torch.tensor(gamma), torch.tensor(beta))
    assert_scaled_close(want, out, TOL, "instance_norm")
    assert not bool(out[~got.levels[1].valid].any())


def test_gather_rows_ignores_idx_where_not_ok():
    """idx is never trusted where ok is false, out of range included (the
    drop-slot parents of `sparse_conv_tr` and the table maps' zeros)."""
    feats = torch.arange(2 * 5 * 3, dtype=torch.float32).view(2, 5, 3)
    idx = torch.tensor([[4, -7, 5, 0], [9, 2, 1, 4]], dtype=torch.int32)
    ok = torch.tensor([[True, False, False, True],
                       [False, True, True, True]])
    out = T.gather_rows(feats, idx, ok)
    want = torch.stack([feats[0, [4, 0, 0, 0]], feats[1, [0, 2, 1, 4]]])
    want = torch.where(ok[..., None], want, 0.0)
    assert torch.equal(out, want)
