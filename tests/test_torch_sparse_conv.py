"""The bf16 sparse conv of the PyTorch port (`sparse/sparse_conv.py`):
its plain version against the JAX package's windowed Pallas kernel
`sparse_conv_pallas`, run as tests/test_pallas_conv.py runs it (the Pallas
interpreter on the CPU), on fixtures where JAX's window premise holds; the
eligibility rule; the wrapper's input checks and CPU dispatch; and, on a
card, the CUDA kernel against the plain version (the JAX package and the
repo's test helpers that import it are imported inside the test that needs
them, so the card-marked test collects where flax is not importable;
`tests.torch_threads` imports no JAX)."""

import numpy as np
import pytest
import torch

from mask3d_tpu_torch.sparse import sparse_conv as sc
from mask3d_tpu_torch.sparse.ops import sparse_conv as sparse_conv_f32
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

# bf16-rounded inputs on both sides, products exact in f32: the outputs
# differ by the f32 summation order only
TOL = 1e-5


def jax_all_hit(idx, ok, tile, window):
    """`pallas_conv._forward`'s window premise (per_offset mode): every ok
    neighbour of a tile lies in the window from its 16-aligned minimum.
    Where it fails JAX takes its slow branch, which rounds the output to
    bf16."""
    b, n, k = idx.shape
    idx_t = idx.reshape(b, n // tile, tile, k)
    ok_t = ok.reshape(idx_t.shape)
    bases = np.minimum(np.where(ok_t, idx_t, n - 1).min(axis=2), n - window)
    bases = np.maximum(bases, 0) & ~15
    return bool(np.all(np.where(ok_t, idx_t - bases[:, :, None, :] < window,
                                True)))


# (rows N, tile, window, kernel size, Cin, Cout)
CASES = [(512, 128, 256, 3, 8, 16), (512, 128, 256, 3, 1, 32),
         (1024, 256, 1024, 5, 1, 32), (1024, 256, 1024, 3, 16, 8)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_pallas_interpreter(case):
    import jax.numpy as jnp

    from mask3d_tpu.sparse.core import cube_offsets, neighbor_map
    from mask3d_tpu.sparse.pallas_conv import sparse_conv_pallas
    from tests.test_pallas_conv import _batch
    from tests.torch_parity import assert_scaled_close

    n, tile, window, ks, cin, cout = CASES[case]
    sb = _batch(dims=(48, 48, 16) if n > 512 else (32, 32, 16), n_cap=n)
    level = sb.levels[0]
    idx, ok = (np.asarray(a) for a in neighbor_map(level,
                                                   cube_offsets(ks // 2)))
    assert jax_all_hit(idx, ok, tile, window)
    rng = np.random.default_rng(case)
    feats = rng.normal(size=(2, n, cin)).astype(np.float32)
    feats *= np.asarray(level.valid)[..., None]
    w = (rng.normal(size=(ks ** 3, cin, cout)) / np.sqrt(cin * ks ** 3)
         ).astype(np.float32)
    want = np.asarray(sparse_conv_pallas(
        jnp.asarray(feats), jnp.asarray(w), idx, ok, tile, window))
    got = sc.sparse_conv_plain(torch.tensor(feats), torch.tensor(w),
                               torch.tensor(idx), torch.tensor(ok))
    assert got.dtype == torch.float32
    assert_scaled_close(want, got, TOL, f"case {case}")
    # the bf16 rounding is real: the fp32 conv of the same inputs differs
    f32 = sparse_conv_f32(torch.tensor(feats), torch.tensor(w),
                          torch.tensor(idx), torch.tensor(ok))
    assert float((f32 - got).abs().max()) > 10 * TOL


@pytest.mark.parametrize("n,want", [(65536, True), (1024, True),
                                    (512, False), (1024 + 128, False)])
def test_supports(n, want):
    assert sc.supports(n) is want


def _inputs(rng, b=2, n=40, k=27, cin=5, cout=6):
    feats = torch.tensor(rng.normal(size=(b, n, cin)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(k, cin, cout)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, n, (b, n, k)), dtype=torch.int32)
    ok = torch.tensor(rng.random((b, n, k)) < 0.3)
    return feats, w, idx, ok


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor runs the plain version and counts no launch."""
    args = _inputs(np.random.default_rng(0))
    before = sc.sparse_conv.launches
    by_shape = dict(sc.sparse_conv.launches_by_shape)
    torch.testing.assert_close(sc.sparse_conv(*args),
                               sc.sparse_conv_plain(*args), rtol=0, atol=0)
    assert sc.sparse_conv.launches == before
    assert sc.sparse_conv.launches_by_shape == by_shape


def test_plain_ignores_idx_where_not_ok():
    """idx is never trusted where ok is false (out of range included)."""
    feats, w, idx, ok = _inputs(np.random.default_rng(1))
    wild = torch.where(ok, idx, torch.full_like(idx, -7))
    torch.testing.assert_close(sc.sparse_conv_plain(feats, w, wild, ok),
                               sc.sparse_conv_plain(feats, w, idx, ok),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["idx_dtype", "ok_dtype", "ok_shape",
                                 "cin", "feats_rank"])
def test_wrapper_rejects_bad_inputs(bad):
    feats, w, idx, ok = _inputs(np.random.default_rng(2))
    with pytest.raises((TypeError, ValueError)):
        if bad == "idx_dtype":
            sc.sparse_conv(feats, w, idx.long(), ok)
        elif bad == "ok_dtype":
            sc.sparse_conv(feats, w, idx, ok.int())
        elif bad == "ok_shape":
            sc.sparse_conv(feats, w, idx, ok[:, :, :5])
        elif bad == "cin":
            sc.sparse_conv(feats, w[:, :4], idx, ok)
        else:
            sc.sparse_conv(feats[0], w, idx, ok)


# (level, N, K, Cin, Cout) of the 47 launches of the flagship
# `gather_pallas` forward (Res16UNet34C, bucket 49152)
FLAGSHIP = [(0, 49152, 27, 96, 96), (0, 49152, 27, 128, 96),
            (0, 49152, 125, 1, 32), (1, 24576, 27, 32, 32),
            (1, 24576, 27, 96, 96), (1, 24576, 27, 128, 96),
            (2, 12288, 27, 32, 64), (2, 12288, 27, 64, 64),
            (2, 12288, 27, 128, 128), (2, 12288, 27, 192, 128),
            (3, 6144, 27, 64, 128), (3, 6144, 27, 128, 128),
            (3, 6144, 27, 256, 256), (3, 6144, 27, 384, 256),
            (4, 3072, 27, 128, 256), (4, 3072, 27, 256, 256)]


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: "L%d-%d-%d-%d-%d"
                         % s)
def test_plan_at_flagship_shapes(shape):
    """The launch plan: the stem folds its offsets; other rows pad to 16
    channels; the block width holds Cout with less than one block of
    padding; 128-row tiles on the two fine levels, 64 below; the coarse
    levels (L3, L4) split their offsets, at least three offsets a split."""
    level, n, k, cin, cout = shape
    p = sc.plan(8, n, k, cin, cout)
    assert p.folded is (cin == 1)
    if p.folded:
        assert p.depth == 128 and p.splits == 1
    else:
        assert p.depth % 16 == 0 and 0 <= p.depth - cin < 16
    assert p.tn in (32, 64, 96, 128) and p.cout_pad % p.tn == 0
    assert 0 <= p.cout_pad - cout < p.tn
    assert p.warps == (8 if level <= 1 else 4)
    assert p.tile_rows == 16 * p.warps
    assert 1 <= p.splits <= min(sc.MAX_SPLITS, k // 3)
    assert (p.splits > 1) is (level >= 3)


@pytest.mark.parametrize("cin", [1, 3, 16, 45, 130])
def test_bf16_rows_pads_with_zeros(cin):
    """The wrapper's one cast: bf16 rows, zero past Cin up to a multiple of
    16 channels (or unpadded for the folded stem)."""
    rng = np.random.default_rng(cin)
    feats = torch.tensor(rng.normal(size=(2, 7, cin)), dtype=torch.float32)
    p = sc.plan(2, 7, 27, cin, 8)
    depth = 1 if p.folded else p.depth
    got = sc.bf16_rows(feats, depth)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == (2, 7, depth) and depth % 16 in (0, 1)
    assert torch.equal(got[..., :cin], feats.to(torch.bfloat16))
    assert not got[..., cin:].any()


@pytest.mark.parametrize("cin,k", [(1, 125), (1, 27), (45, 27), (130, 8)])
def test_bf16_weights_pads_with_zeros(cin, k):
    rng = np.random.default_rng(cin + k)
    w = torch.tensor(rng.normal(size=(k, cin, 70)), dtype=torch.float32)
    p = sc.plan(1, 64, k, cin, 70)
    got = sc.bf16_weights(w, p)
    w16 = w.to(torch.bfloat16)
    if p.folded:
        assert tuple(got.shape) == (p.depth, p.cout_pad)
        assert torch.equal(got[:k, :70], w16[:, 0])
        assert not got[k:].any() and not got[:, 70:].any()
    else:
        assert tuple(got.shape) == (k, p.depth, p.cout_pad)
        assert torch.equal(got[:, :cin, :70], w16)
        assert not got[:, cin:].any() and not got[..., 70:].any()


def split_of_offsets(nbr_ok, tile_rows: int, splits: int):
    """The partition of `csrc/sparse_conv.cu`: for each tile of `tile_rows` flat rows and
    each offset, the split whose block computes it, or -1 where no row of
    the tile is ok for that offset. Split s takes the active offsets of
    rank [a*s//S, a*(s+1)//S) among the tile's a active ones, in offset
    order. nbr_ok [B, N, K] -> int64 [tiles, K]."""
    k = nbr_ok.shape[-1]
    flat = nbr_ok.reshape(-1, k)
    pad = (-flat.shape[0]) % tile_rows
    flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    active = flat.reshape(-1, tile_rows, k).any(dim=1)  # [tiles, K]
    rank = active.long().cumsum(dim=1) - 1
    n_active = active.sum(dim=1, keepdim=True)
    # the last s with a*s//S <= rank
    s = torch.arange(splits + 1, device=nbr_ok.device)
    bounds = (n_active * s) // splits  # [tiles, S + 1]
    split = (rank[..., None] >= bounds[:, None, :-1]).long().sum(-1) - 1
    return torch.where(active, split, torch.full_like(split, -1))


def sparse_conv_split_plain(feats, weight, nbr_idx, nbr_ok, p):
    """The kernel's split computed in plain PyTorch: per split, the bf16
    conv over the offsets `split_of_offsets` gives it, then the partial
    sums added in split order (each tile's rows are 0 where it has no
    active offset)."""
    b, n, _ = feats.shape
    owner = split_of_offsets(nbr_ok, p.tile_rows, p.splits)
    rows = b * n
    tile = torch.arange(rows, device=feats.device) // p.tile_rows
    row_owner = owner[tile].reshape(b, n, -1)  # [B, N, K]
    out = None
    for s in range(p.splits):
        part = sc.sparse_conv_plain(feats, weight, nbr_idx,
                                 nbr_ok & (row_owner == s))
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 6, 9, 27])
def test_split_partition_of_offsets(splits):
    """Every offset that a row of a tile needs goes to exactly one split, in
    offset order, the splits' shares differing by at most one; offsets no
    row of the tile needs go to none."""
    rng = np.random.default_rng(splits)
    ok = torch.tensor(rng.random((2, 200, 27)) < 0.05)
    ok[1, 64:] = False  # tiles with no ok row, and a ragged last tile
    owner = split_of_offsets(ok, 64, splits)
    tiles = -(-400 // 64)
    assert tuple(owner.shape) == (tiles, 27)
    flat = torch.nn.functional.pad(ok.reshape(-1, 27), (0, 0, 0, 48))
    active = flat.reshape(tiles, 64, 27).any(dim=1)
    assert torch.equal(owner >= 0, active)
    assert bool((owner < splits).all())
    for t in range(tiles):
        got = owner[t][active[t]]
        assert bool((got[1:] >= got[:-1]).all())  # contiguous ranges
        sizes = torch.bincount(got, minlength=splits)
        assert int(sizes.max() - sizes.min()) <= 1
    assert not active[-2:].any()  # the ok-free tiles of item 1


def _coarse(rng, b, n, k, cin, cout, valid):
    """A coarse level: `valid` rows of each item hold ok neighbours among
    themselves, the rest of the capacity is padding."""
    feats, w, _, _ = _inputs(rng, b, n, k, cin, cout)
    idx = torch.tensor(rng.integers(0, max(valid, 1), (b, n, k)),
                       dtype=torch.int32)
    ok = torch.tensor(rng.random((b, n, k)) < 0.3)
    ok[:, valid:] = False
    return feats, w, idx, ok


# (b, n, k, cin, cout, valid rows per item, tile rows, splits)
SPLITS = [(2, 3072, 27, 32, 40, 105, 64, 9), (3, 517, 27, 45, 70, 517, 64, 3),
          (2, 640, 27, 16, 8, 0, 128, 6), (1, 300, 8, 5, 6, 300, 64, 2)]


@pytest.mark.parametrize("case", range(len(SPLITS)))
def test_split_emulation_matches_plain(case):
    """The kernel's split-K, emulated in plain PyTorch from its partition:
    the partial sums added in split order equal the unsplit conv (a coarse
    level with 105 valid rows in 3072, a ragged last tile, an item with no
    ok row at all), and rows with no ok offset come out 0."""
    b, n, k, cin, cout, valid, tile_rows, splits = SPLITS[case]
    rng = np.random.default_rng(10 + case)
    args = _coarse(rng, b, n, k, cin, cout, valid)
    args[3][-1] = False  # the last item: no row ok
    p = sc.Plan(False, -(-cin // 16) * 16, 32, 64, tile_rows // 16, splits)
    got = sparse_conv_split_plain(*args, p)
    want = sc.sparse_conv_plain(*args)
    scale = max(1.0, float(want.std()))
    assert float((got - want).abs().max()) <= TOL * scale
    assert not got[~args[3].any(dim=-1)].any()


def test_folded_stem_matches_plain():
    """The stem's fold, A[p, k] = bf16(feats[idx[p, k]]) where ok, times
    the [K, Cout] weights: the same sums as the per-offset conv."""
    rng = np.random.default_rng(7)
    feats, w, idx, ok = _inputs(rng, 2, 300, 125, 1, 32)
    p = sc.plan(2, 300, 125, 1, 32)
    rows = sc.bf16_rows(feats, 1)[..., 0].float()  # [B, N]
    j = idx.long().clamp(0, 299)
    a = torch.where(ok, torch.gather(rows, 1, j.reshape(2, -1)).reshape(
        j.shape), 0.0)
    a = torch.nn.functional.pad(a, (0, p.depth - 125))
    got = a @ sc.bf16_weights(w, p).float()[:, :32]
    want = sc.sparse_conv_plain(feats, w, idx, ok)
    assert float((got - want).abs().max()) <= TOL * max(1.0, float(
        want.std()))


def _card_case(rng, b, n, k, cin, cout, valid=None, dead_item=False):
    if valid is None:
        args = list(_inputs(rng, b, n, k, cin, cout))
    else:
        args = list(_coarse(rng, b, n, k, cin, cout, valid))
    if dead_item:
        args[3][-1] = False
    return [a.cuda() for a in args]


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version at the shapes its design
    branches on: the folded stem (Cin 1, K 125 and 27), Cin 3 / 45 / 130
    (padding to 16 channels), a coarse level with 105 valid rows in N=3072
    (split-K), an item with no ok row, ragged last tiles, Cout not a
    multiple of the block width; each launched twice, bitwise equal. Needs
    a card; `chip_smoke.py` runs the same check at the flagship's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    rng = np.random.default_rng(3)
    cases = [((2, 300, 27, 1, 32), {}), ((2, 1000, 125, 1, 32), {}),
             ((3, 517, 27, 45, 70), {}), ((1, 1000, 125, 3, 96), {}),
             ((2, 129, 27, 130, 200), {}),
             ((8, 3072, 27, 256, 256), dict(valid=105)),
             ((4, 3072, 27, 128, 256), dict(valid=105, dead_item=True)),
             ((2, 49152 // 8, 27, 96, 96), dict(dead_item=True)),
             ((2, 700, 27, 32, 5), {})]
    for (b, n, k, cin, cout), kw in cases:
        args = _card_case(rng, b, n, k, cin, cout, **kw)
        before = sc.sparse_conv.launches
        shape_before = sc.sparse_conv.launches_by_shape.get(
            (n, k, cin, cout), 0)
        got = sc.sparse_conv(*args)
        again = sc.sparse_conv(*args)
        ref = sc.sparse_conv_plain(*args)
        torch.cuda.synchronize()
        assert sc.sparse_conv.launches == before + 2
        assert sc.sparse_conv.launches_by_shape[(n, k, cin, cout)] == \
            shape_before + 2
        scale = max(1.0, float(ref.std()))
        assert float((got - ref).abs().max()) <= 1e-4 * scale, (b, n, k,
                                                                cin, cout)
        assert torch.equal(got, again), "two launches differ"
        assert not got[~args[3].any(dim=-1)].any()
