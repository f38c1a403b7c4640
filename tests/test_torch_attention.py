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
from mask3d_tpu_torch.ops import masked_attention as ma
from mask3d_tpu_torch.ops.masked_attention import masked_cross_attention, \
    masked_cross_attention_plain, plan
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)


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


@pytest.mark.parametrize("b,nq,s,h,hd", [
    (8, 25, 3072, 8, 16), (8, 25, 24576, 8, 16), (8, 25, 6144, 8, 16),
    (8, 25, 12288, 8, 16), (2, 40, 100, 8, 16), (1, 8, 32, 4, 8),
    (8, 1, 24576, 8, 16), (3, 1, 70, 4, 32), (2, 40, 1000, 4, 32),
    (2, 25, 99, 16, 8), (1, 25, 5, 8, 16), (2, 100, 300, 8, 32)])
def test_chunking_covers_keys(b, nq, s, h, hd):
    """The launch plan covers every key exactly once, in whole tiles, and
    fits the kernel's thread and shared-memory limits; only the last warp
    of a block holds lanes without a (head, queries) group."""
    p = plan(b, nq, s, h, hd)
    assert p.ksl in (1, 2, 4) and h % p.hg == 0
    assert p.chunk % p.tile == 0 and p.nch * p.chunk >= s > (p.nch - 1) * \
        p.chunk
    owners = np.zeros(s, int)
    for c in range(p.nch):
        owners[c * p.chunk:min(s, (c + 1) * p.chunk)] += 1
    assert (owners == 1).all()
    assert p.threads % 32 == 0 and p.threads <= ma.MAX_THREADS
    lanes = p.hg * -(-nq // p.queries) * p.ksl
    assert lanes <= p.threads < lanes + 32
    assert p.queries == ma.QUERIES_PER_THREAD[hd]
    assert ma.smem_bytes(p.tile, p.hg * hd, nq) <= ma.SMEM_BYTES
    blocks = b * (h // p.hg) * p.nch
    assert blocks <= ma.SMS * ma.BLOCKS_PER_SM or p.nch == 1
    if (b, nq, h, hd) == (8, 25, 8, 16):  # 8 heads x 7 quads x 4 slices
        assert (p.ksl, p.hg, p.threads, p.queries) == (4, 8, 224, 4)
        # one wave: all but 4 of the 132 SMs take a block
        assert ma.SMS - b < blocks <= ma.SMS


def stream_emulation(q, k, v, mask, h, p):
    """The kernel's arithmetic order in plain PyTorch (f32): per chunk, per
    key slice, tiles folded into a running (max, sum, acc) with one rescale
    per tile; slices merged pairwise by lane distance 1, 2; then the
    chunks merged as mca_combine does."""
    b, nq, d = q.shape
    s, hd = k.shape[1], d // h
    qh = q.view(b, nq, h, hd)
    kh, vh = k.view(b, s, h, hd), v.view(b, s, h, hd)
    scale = 1.0 / np.sqrt(hd)
    parts = []
    for c in range(p.nch):
        lo, hi = c * p.chunk, min(s, (c + 1) * p.chunk)
        states = []
        for sl in range(p.ksl):
            m = torch.full((b, h, nq), -1e9)
            l = torch.zeros((b, h, nq))
            acc = torch.zeros((b, h, nq, hd))
            for t0 in range(lo, hi, p.tile):
                keys = [j for j in range(t0 + sl, min(hi, t0 + p.tile),
                                         p.ksl)]
                if not keys:
                    continue
                x = torch.einsum("bqhd,bkhd->bhqk", qh, kh[:, keys]) * scale
                x = x.masked_fill(mask[:, None, :, keys], -1e9)
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp(m - m_new)
                pr = torch.exp(x - m_new[..., None])
                l = l * corr + pr.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", pr, vh[:, keys])
                m = m_new
            states.append((m, l, acc))
        off = 1
        while off < p.ksl:
            merged = []
            for i in range(p.ksl):
                (m, l, a), (mo, lo_, ao) = states[i], states[i ^ off]
                mn = torch.maximum(m, mo)
                wa, wb = torch.exp(m - mn), torch.exp(mo - mn)
                merged.append((mn, l * wa + lo_ * wb,
                               a * wa[..., None] + ao * wb[..., None]))
            states, off = merged, off * 2
        parts.append(states[0])
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    out = acc / lsum.clamp_min(1e-20)[..., None]
    return out.permute(0, 2, 1, 3).reshape(b, nq, d)


@pytest.mark.parametrize("b,nq,s,h", [(2, 25, 700, 8), (1, 40, 100, 8),
                                      (2, 1, 333, 4)])
def test_stream_order_within_tolerance(b, nq, s, h):
    """The kernel's order of summation (slices, tiles, chunks) stays within
    the card check's ATTN_TOL of the one-shot softmax, with an all-blocked
    row and a fully open one."""
    rng = np.random.default_rng(7)
    d = h * 16
    q, k, v = (torch.tensor(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, nq, d), (b, s, d), (b, s, d)))
    mask = torch.tensor(rng.random((b, nq, s)) < 0.4)
    mask[0, 0] = True
    if nq > 1:
        mask[-1, 1] = False
    p = plan(b, nq, s, h, 16)
    p = ma.Plan(p.ksl, p.hg, p.threads, 2 * p.tile,
                -(-s // (2 * p.tile)))  # many chunks, ragged last tile
    got = stream_emulation(q, k, v, mask, h, p)
    ref = masked_cross_attention_plain(q, k, v, mask, h)
    assert float((got - ref).abs().max()) <= 1e-4


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
