"""The bf16 sparse conv of the PyTorch port (`sparse/sparse_conv.py`):
its plain version against the JAX package's windowed Pallas kernel
`sparse_conv_pallas`, run as tests/test_pallas_conv.py runs it (the Pallas
interpreter on the CPU), on fixtures where JAX's window premise holds; the
eligibility rule; the wrapper's input checks and CPU dispatch; and, on a
card, the CUDA kernel against the plain version (the JAX package and the
repo's test helpers are imported inside the test that needs them, so the
card-marked test collects where neither flax nor this repo's `tests`
package is importable)."""

import numpy as np
import pytest
import torch

from mask3d_tpu_torch.sparse import sparse_conv as sc
from mask3d_tpu_torch.sparse.ops import sparse_conv as sparse_conv_f32

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


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against the plain version at odd sizes (ragged row
    tiles, Cin not a multiple of 32, every output-slice width); needs a
    card. `chip_smoke.py` runs the same check at the flagship's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    rng = np.random.default_rng(3)
    for (b, n, k, cin, cout) in ((2, 300, 27, 1, 32), (3, 517, 27, 45, 70),
                                 (1, 1000, 125, 3, 96), (2, 129, 27, 130,
                                                         200)):
        args = [a.cuda() for a in _inputs(rng, b, n, k, cin, cout)]
        before = sc.sparse_conv.launches
        shape_before = sc.sparse_conv.launches_by_shape.get(
            (n, k, cin, cout), 0)
        got = sc.sparse_conv(*args)
        ref = sc.sparse_conv_plain(*args)
        torch.cuda.synchronize()
        assert sc.sparse_conv.launches == before + 1
        assert sc.sparse_conv.launches_by_shape[(n, k, cin, cout)] == \
            shape_before + 1
        scale = max(1.0, float(ref.std()))
        assert float((got - ref).abs().max()) <= 1e-4 * scale
