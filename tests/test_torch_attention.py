"""Masked cross-attention, FPS and positional encodings of the PyTorch port
against the JAX package (its Pallas attention in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.models.posenc import fourier_embeddings as j_fourier
from mask3d_tpu.models.posenc import sine_embeddings as j_sine
from mask3d_tpu.ops.fps import furthest_point_sample as j_fps
from mask3d_tpu.ops.pallas_attention import masked_cross_attention as j_mca
from mask3d_tpu_torch.models.posenc import fourier_embeddings, \
    sine_embeddings
from mask3d_tpu_torch.ops.fps import furthest_point_sample
from mask3d_tpu_torch.ops.masked_attention import chunking, \
    masked_cross_attention


def _t(a):
    return torch.tensor(np.asarray(a))


# (B, Q, S, D, H, tile, valid keys per item)
ATTN = [(2, 25, 64, 32, 4, 16, (64, 40)),
        (2, 25, 256, 64, 8, 64, (200, 17)),
        (1, 8, 96, 32, 4, 32, (96,))]


@pytest.mark.parametrize("case", range(len(ATTN)))
def test_masked_attention_matches_pallas_interpret(case):
    b, nq, s, d, h, tile, counts = ATTN[case]
    rng = np.random.default_rng(case)
    q = rng.normal(size=(b, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, d)).astype(np.float32)
    v = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = rng.random((b, nq, s)) < 0.4
    for i, n in enumerate(counts):
        mask[i, :, n:] = True  # padding tail
    mask[0, 3] = True  # an all-blocked row: uniform weights
    mask[-1, 0, :counts[-1]] = False  # a fully open row
    ref = np.asarray(j_mca(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), h, tile=tile, interpret=True))
    got = masked_cross_attention(_t(q), _t(k), _t(v), _t(mask), h)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the all-blocked row is the plain mean of v over all keys (per head)
    np.testing.assert_allclose(got.numpy()[0, 3], v[0].mean(axis=0),
                               rtol=0, atol=1e-5)
    got8 = masked_cross_attention(_t(q), _t(k), _t(v),
                                  _t(mask.astype(np.uint8)), h)
    torch.testing.assert_close(got8, got, rtol=0, atol=0)


@pytest.mark.parametrize("b,nq,s", [(8, 25, 3072), (8, 25, 24576),
                                    (2, 40, 100), (1, 8, 32)])
def test_chunking_covers_keys(b, nq, s):
    chunk, nch = chunking(b, nq, s)
    assert chunk % 32 == 0 and nch * chunk >= s > (nch - 1) * chunk


@pytest.mark.parametrize("seed", [0, 1])
def test_fps_indices_equal(seed):
    """Integer voxel coordinates: distance ties are common; both take the
    first maximum. Item 1 has fewer valid points than samples."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 6, size=(3, 64, 3)).astype(np.float32)
    valid = np.ones((3, 64), bool)
    valid[1, 5:] = False
    valid[2, 40:] = False
    ref = np.asarray(j_fps(jnp.asarray(coords), jnp.asarray(valid), 12))
    got = furthest_point_sample(_t(coords), _t(valid), 12)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("normalize", [True, False])
def test_posenc(normalize):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(2, 50, 3)).astype(np.float32) * 5
    mins, maxs = xyz.min(axis=1), xyz.max(axis=1)
    mins[1, 2] = maxs[1, 2]  # a zero range stays finite
    gb = rng.normal(size=(3, 16)).astype(np.float32)
    # without normalization sin/cos take arguments up to 2*pi*|xyz|, whose
    # f32 rounding scales with them
    tol = 1e-6 if normalize else 1e-6 * 2 * np.pi * float(np.abs(xyz).max())
    ref = np.asarray(j_fourier(xyz, gb, mins, maxs, normalize=normalize))
    got = fourier_embeddings(_t(xyz), _t(gb), _t(mins), _t(maxs),
                             normalize=normalize)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    ref = np.asarray(j_sine(xyz, 32, mins, maxs, normalize=normalize))
    got = sine_embeddings(_t(xyz), 32, _t(mins), _t(maxs),
                          normalize=normalize)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
