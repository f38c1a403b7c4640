"""The JAX bench's input path in the port against the JAX package: the u8
key codec and the host-built coarse pyramid (numpy and C++) byte for byte,
the decode, `level_from_keys` and `build_sparse_batch(precomputed_levels=
...)` bit for bit, and `infer_u8` against JAX's bench sequence (decode,
`unpack_keys`, the precomputed build, `model.apply(aux_masks=False)`) and
against the port's own `infer`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import transfer as j_transfer
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse.core import pack_keys as j_pack, \
    unpack_keys as j_unpack
from mask3d_tpu.sparse.dense_ops import level_from_keys as j_level
from mask3d_tpu.train.loop import _sb_kwargs as j_sb_kwargs, init_state, \
    level_capacities as j_caps
from mask3d_tpu_torch import bridge, build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data import transfer
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.infer import encode_batch, infer_u8, \
    level_capacities
from mask3d_tpu_torch.sparse.context import build_sparse_batch
from mask3d_tpu_torch.sparse.dense_ops import level_from_keys
from tests.test_e2e import small_config
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, assert_scaled_close, \
    flax_to_numpy, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)


def _voxels(seed, b, n, extent, counts=None):
    """Random sorted unique voxels per item (the collator's order), with
    the per-item dims of their extent; `counts` caps each item."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, n, 3), np.int32)
    cnt = np.zeros(b, np.int32)
    dims = np.ones((b, 3), np.int32)
    for i in range(b):
        c = np.unique(rng.integers(0, extent, size=(n, 3)), axis=0)
        c = c[: n if counts is None else counts[i]]
        cnt[i] = len(c)
        if len(c):
            dims[i] = c.max(axis=0) + 1
            k = np.asarray(j_pack(c, dims[i][None]))
            coords[i, : len(c)] = c[np.argsort(k, kind="stable")]
    return coords, cnt, dims


# (seed, B, N, extent, counts, capacities): the level-1 capacity of 32
# truncates item 0; B=1 with capacity 33 puts every coarse table at an odd
# byte offset; the extent of 400 makes key gaps past 255 (escapes)
CASES = {
    "truncated": (5, 3, 256, (24, 20, 12), [256, 40, 3], [32, 64, 32, 16]),
    "b1_odd_capacity": (1, 1, 300, (30, 20, 16), None, [33, 65, 19, 9]),
    "escapes": (2, 2, 512, (400, 300, 40), [512, 0], [257, 131, 67, 35]),
}


def _case(name):
    seed, b, n, extent, counts, caps = CASES[name]
    coords, cnt, dims = _voxels(seed, b, n, extent, counts)
    return coords, cnt, dims, caps


@pytest.mark.parametrize("name", sorted(CASES))
def test_buffers_match_jax(name):
    """The port's C++ and numpy buffers equal JAX's `encode_pyramid_u8`
    (its C++ path) and its numpy path, byte for byte."""
    coords, cnt, dims, caps = _case(name)
    ref = j_transfer.encode_pyramid_u8(coords, cnt, dims, caps)
    base = j_transfer.encode_keys_u8(
        np.asarray(j_pack(coords, dims[:, None, :])).astype(np.int32), cnt,
        dims)
    ref_np = np.concatenate([base] + [
        j_transfer.encode_keys_u8(k, r, d, 1024)
        for k, r, d in j_transfer.coarse_pyramid_host(coords, cnt, dims,
                                                      caps)])
    np.testing.assert_array_equal(ref, ref_np)
    for use_native in (True, False):
        got = transfer.encode_pyramid_u8(coords, cnt, dims, caps,
                                         use_native=use_native)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    assert len(ref) == sum(transfer.pyramid_buf_sizes(len(cnt),
                                                      coords.shape[1], caps))
    if name == "escapes":  # the base level needs escape records
        n_esc = int((np.frombuffer(
            ref[len(cnt) * coords.shape[1]:][:4096 * 12].tobytes(),
            np.int32).reshape(-1, 3)[:, 1] < coords.shape[1]).sum())
        assert n_esc > len(cnt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_and_host_pyramid_match_jax(name):
    """The decode on the CPU equals JAX's `decode_pyramid_u8`; the port's
    `coarse_pyramid_host` and `level_from_keys` equal JAX's."""
    coords, cnt, dims, caps = _case(name)
    buf = transfer.encode_pyramid_u8(coords, cnt, dims, caps)
    b, n = coords.shape[:2]
    (rk, rc, rd), rcoarse = j_transfer.decode_pyramid_u8(
        jnp.asarray(buf), b, n, caps)
    (gk, gc, gd), gcoarse = transfer.decode_pyramid_u8(
        torch.from_numpy(buf), b, n, caps)
    for r, g in [(rk, gk), (rc, gc), (rd, gd)] + [
            (r, g) for rl, gl in zip(rcoarse, gcoarse)
            for r, g in zip(rl, gl)]:
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for i in range(b):
        np.testing.assert_array_equal(gk[i, : cnt[i]].numpy(), np.asarray(
            j_pack(coords[i, : cnt[i]], dims[i][None])))
    for (rk, rr, rd), (gk, gr, gd) in zip(
            j_transfer.coarse_pyramid_host(coords, cnt, dims, caps),
            transfer.coarse_pyramid_host(coords, cnt, dims, caps)):
        for r, g in ((rk, gk), (rr, gr), (rd, gd)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    for li, ((rk, rr, rd), cap) in enumerate(zip(rcoarse, caps)):
        ref = j_level(rk, rr, rd, stride=2 ** (li + 1), capacity=cap)
        got = level_from_keys(torch.tensor(np.asarray(rk)),
                              torch.tensor(np.asarray(rr)),
                              torch.tensor(np.asarray(rd)),
                              stride=2 ** (li + 1), capacity=cap)
        for field in ("key", "coords", "valid", "count", "dims"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(ref, field)))
        assert got.stride == ref.stride


def test_dropped_escape_record_changes_the_keys():
    """Every escape record counts: the decode of a buffer with one real
    record turned into a pad record (position N) loses that key."""
    coords, cnt, dims, caps = _case("escapes")
    b, n = coords.shape[:2]
    buf = transfer.encode_pyramid_u8(coords, cnt, dims, caps)
    rec = buf[b * n: b * n + 4096 * 12].view(np.int32).reshape(-1, 3)
    real = np.nonzero(rec[:, 1] < n)[0]
    bad = buf.copy()
    bad[b * n: b * n + 4096 * 12].view(np.int32).reshape(-1, 3)[
        real[-1], 1] = n
    (k0, _, _), _ = transfer.decode_pyramid_u8(torch.from_numpy(buf), b, n,
                                               caps)
    (k1, _, _), _ = transfer.decode_pyramid_u8(torch.from_numpy(bad), b, n,
                                               caps)
    assert not torch.equal(k0, k1)


@pytest.mark.parametrize("use_native", [True, False])
def test_escape_overflow_raises(use_native):
    """Too many escape records for the table raise, at the base level and
    at a coarse one (deltas of 5 * 40 * 40 and about 2.5 * 20 * 20)."""
    n = 64
    coords = np.zeros((1, n, 3), np.int32)
    coords[0, :, 0] = np.arange(n) * 5
    count, dims = np.array([n], np.int32), np.array([[320, 40, 40]], np.int32)
    with pytest.raises(ValueError, match="escape"):
        transfer.encode_batch_u8(coords, count, dims, escape_capacity=4,
                                 use_native=use_native)
    transfer.encode_pyramid_u8(coords, count, dims, [n, n],
                               use_native=use_native)
    with pytest.raises(ValueError, match="escape"):
        transfer.encode_pyramid_u8(coords, count, dims, [n, n],
                                   coarse_escape_capacity=2,
                                   use_native=use_native)


def _grid_dims(extent, levels=5):
    out, d = [], np.array(extent)
    for _ in range(levels):
        out.append(tuple(int(v) for v in d))
        d = ((d - 1) >> 1) + 1
    return out


@pytest.mark.parametrize("name", ["truncated", "b1_odd_capacity"])
def test_precomputed_build_matches_device_build(name):
    """The sparse batch from the precomputed levels equals the port's
    device build and JAX's precomputed build, bit for bit: every level,
    the occupancy grids and the overflow flags (the truncated case
    overflows)."""
    coords, cnt, dims, caps = _case(name)
    b, n = coords.shape[:2]
    gd = _grid_dims(CASES[name][3])
    buf = transfer.encode_pyramid_u8(coords, cnt, dims, caps)
    (k, c, d), coarse = transfer.decode_pyramid_u8(torch.from_numpy(buf), b,
                                                   n, caps)
    args = (torch.from_numpy(coords), torch.from_numpy(cnt),
            torch.from_numpy(dims), caps, gd)
    dev = build_sparse_batch(*args)
    pre = build_sparse_batch(*args, precomputed_levels=coarse)
    (_, _, _), jcoarse = j_transfer.decode_pyramid_u8(jnp.asarray(buf), b, n,
                                                      caps)
    ref = j_build(jnp.asarray(coords), jnp.asarray(cnt), jnp.asarray(dims),
                  caps, conv1_kernel_size=None, build_block_maps=False,
                  grid_dims=gd, precomputed_levels=jcoarse)
    if name == "truncated":
        assert any(bool(p.overflow.any()) for p in pre.pools)
    for lv_d, lv_p, lv_r in zip(dev.levels, pre.levels, ref.levels):
        for field in ("key", "coords", "valid", "count", "dims"):
            got = getattr(lv_p, field)
            assert got.dtype == getattr(lv_d, field).dtype, field
            assert torch.equal(got, getattr(lv_d, field)), field
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(lv_r, field)))
    for od, op, orf in zip(dev.occ, pre.occ, ref.occ):
        assert torch.equal(od, op)
        np.testing.assert_array_equal(op.numpy(), np.asarray(orf))
    for pd, pp, pr in zip(dev.pools, pre.pools, ref.pools):
        assert torch.equal(pd.overflow, pp.overflow)
        np.testing.assert_array_equal(pp.overflow.numpy(),
                                      np.asarray(pr.overflow))
        assert pp.parent is None and pp.kidx is None


def test_precomputed_levels_refuse_pool_parents():
    coords, cnt, dims, caps = _case("truncated")
    b, n = coords.shape[:2]
    buf = transfer.encode_pyramid_u8(coords, cnt, dims, caps)
    _, coarse = transfer.decode_pyramid_u8(torch.from_numpy(buf), b, n, caps)
    args = (torch.from_numpy(coords), torch.from_numpy(cnt),
            torch.from_numpy(dims), caps)
    with pytest.raises(ValueError, match="parents"):
        build_sparse_batch(*args, _grid_dims((24, 20, 12)),
                           build_pool_parents=True,
                           precomputed_levels=coarse)
    with pytest.raises(ValueError, match="grid dims"):
        build_sparse_batch(*args, None, precomputed_levels=coarse)


@pytest.fixture(scope="module")
def bench_forward():
    """JAX's bench sequence (`bench.py:258-285`) on small_config's
    Flax init at B=2 scenes of 3x2 rooms, and the port's model on the same
    weights."""
    cfg = small_config()
    host = JCollate(point_bucket_multiple=BUCKET)(scene_items())
    dev = host.device
    state, model, _, _ = init_state(cfg, dev)
    n_cap = int(dev.coords.shape[1])
    caps = j_caps(cfg, n_cap)
    buf = j_transfer.encode_pyramid_u8(np.asarray(dev.coords),
                                       np.asarray(dev.counts),
                                       np.asarray(dev.dims), caps)

    @jax.jit
    def run(params, buffers, buf):
        (keys, counts, dims), coarse = j_transfer.decode_pyramid_u8(
            buf, 2, n_cap, caps)
        coords = j_unpack(keys, dims)
        rows = jnp.arange(n_cap, dtype=jnp.int32)[None]
        coords = jnp.where((rows < counts[:, None])[..., None], coords, 0)
        feats = jnp.ones(keys.shape + (1,), jnp.float32)
        sb = j_build(coords, counts, dims, caps, precomputed_levels=coarse,
                     **j_sb_kwargs(cfg, dev.grid_dims))
        out = model.apply({"params": params, "buffers": buffers}, sb, feats,
                          coords.astype(jnp.float32), True,
                          grid_dims=dev.grid_dims, aux_masks=False)
        return out.pred_class, out.pred_masks

    ref = [np.asarray(o) for o in run(state.params, state.buffers,
                                      jnp.asarray(buf))]
    p_cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    p_model = bridge.load_flax(build_model(p_cfg, device="cpu"),
                               flax_to_numpy({"params": state.params,
                                              "buffers": state.buffers}))
    p_host = collate(scene_items(make=make_synthetic_scene), device="cpu",
                     point_bucket_multiple=BUCKET)
    return dict(ref=ref, buf=buf, cfg=p_cfg, model=p_model, host=p_host,
                grid_dims=dev.grid_dims)


def test_infer_u8_matches_jax_bench_and_infer(bench_forward):
    """`encode_batch` gives JAX's bench buffer; `infer_u8` matches JAX's
    bench forward within the fp32 parity bound (1e-4 * max(1, std)) and
    equals the port's `infer` on the collated batch bit for bit."""
    f = bench_forward
    cfg, host = f["cfg"], f["host"]
    assert host.device.grid_dims == f["grid_dims"]
    assert host.device.feats_all_ones
    buf, n_cap = encode_batch(host.device, cfg)
    np.testing.assert_array_equal(buf, f["buf"])
    assert n_cap == host.device.capacity
    assert level_capacities(cfg, n_cap) == j_caps(small_config(), n_cap)
    pc, pm = infer_u8(f["model"], buf, cfg, 2, n_cap, host.device.grid_dims,
                      device="cpu")
    assert_scaled_close(f["ref"][0], pc, 1e-4, "pred_class")
    assert_scaled_close(f["ref"][1], pm, 1e-4, "pred_masks")
    out, overflow = infer(f["model"], host.device, cfg, device="cpu")
    assert not bool(overflow)
    assert torch.equal(out.pred_class, pc)
    assert torch.equal(out.pred_masks, pm)


def test_infer_u8_refuses_other_impls(bench_forward):
    f = bench_forward
    cfg = apply_overrides(Config(), SMALL_OVERRIDES
                          + ["model.backbone_impl=gather"])
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="gather"):
        infer_u8(model, f["buf"], cfg, 2, f["host"].device.capacity,
                 f["grid_dims"], device="cpu")
