"""The row gather of the PyTorch port (`sparse/row_gather.py`) at the row
widths its kernel branches on: one thread per row below 16 bytes (C = 1,
3, 5), groups of lanes copying 16-byte vectors above (C = 96, 256), in f32
and bf16. On the CPU the wrapper's plain version against a numpy
reference; on a card the CUDA kernel against the plain version, bitwise.
`tests/test_torch_dense_ops.py` holds the plain version against the JAX
package's Pallas `monotone_gather`."""

import numpy as np
import pytest
import torch

from mask3d_tpu_torch.sparse import row_gather as rg

WIDTHS = [1, 3, 5, 96, 256]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(seed, c, dtype, b=2, n=500, m=300):
    """Indices out of range on both sides and ~20% of rows not ok."""
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.normal(size=(b, n, c)), dtype=torch.float32).to(
        dtype)
    idx = torch.tensor(rng.integers(-3, n + 5, (b, m)), dtype=torch.int32)
    ok = torch.tensor(rng.random((b, m)) < 0.8)
    return src, idx, ok


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_matches_numpy(c, dtype):
    """`out[b, t] = src[b, clamp(idx[b, t])]` where ok, else 0, exactly; a
    CPU tensor takes the plain version and counts no launch."""
    src, idx, ok = _inputs(c, c, dtype)
    before = rg.row_gather.launches
    got = rg.row_gather(src, idx, ok)
    assert rg.row_gather.launches == before
    assert got.dtype == dtype and tuple(got.shape) == (2, 300, c)
    s = src.float().numpy()
    j = np.clip(idx.numpy(), 0, 499)
    want = np.where(ok.numpy()[..., None],
                    np.take_along_axis(s, j[..., None], axis=1), 0.0)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("c", WIDTHS)
def test_kernel_bitwise_on_the_card(c, dtype):
    """The CUDA kernel equals the plain version bitwise and counts one
    launch; needs a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    src, idx, ok = (t.cuda() for t in _inputs(c, c, dtype))
    before = rg.row_gather.launches
    got = rg.row_gather(src, idx, ok)
    ref = rg.row_gather_plain(src, idx, ok)
    torch.cuda.synchronize()
    assert rg.row_gather.launches == before + 1
    assert torch.equal(got, ref)
