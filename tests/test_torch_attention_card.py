"""The masked cross-attention kernel against its plain version on the card
(skipped without one; `chip_smoke.py` runs the flagship shapes too)."""

import pytest
import torch

from mask3d_tpu_torch.ops import masked_attention as ma

ATTN_TOL = 1e-4  # f32 summation order only


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 100, 3072, 24576])
def test_kernel_matches_plain_on_the_card(s):
    """B=8, D=128, H=8 at Q=25 and Q=1, with an all-blocked row, a fully
    open row and a padding tail per item; two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(s)
    b, d, h = 8, 128, 8
    for nq in (25, 1):
        q = torch.randn(b, nq, d, device="cuda", generator=gen)
        k = torch.randn(b, s, d, device="cuda", generator=gen)
        v = torch.randn(b, s, d, device="cuda", generator=gen)
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        count = (torch.arange(b, device="cuda") + 2) * s // 10
        mask |= torch.arange(s, device="cuda")[None, None] >= \
            count[:, None, None]
        mask[0, 0] = True  # all blocked: uniform weights
        mask[1, -1] = False  # fully open
        before = ma.masked_cross_attention.launches
        got = ma.masked_cross_attention(q, k, v, mask, h)
        again = ma.masked_cross_attention(q, k, v, mask, h)
        ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
        torch.cuda.synchronize()
        assert ma.masked_cross_attention.launches == before + 2
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= ATTN_TOL, (s, nq)
        assert torch.equal(got, again)
        torch.testing.assert_close(got[0, 0], v[0].mean(0).view(d),
                                   rtol=0, atol=ATTN_TOL)
