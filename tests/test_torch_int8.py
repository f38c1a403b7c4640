"""int8 eval ops of the PyTorch port against the JAX package, bitwise:
`quantize_static`, `dequantize` and `dense_conv_same_int8` (k 1 and 3,
dynamic absmax and static bounds, a QGrid input) on the same numpy inputs.
On CPU tensors the port runs the plain version of its int8 conv kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.sparse import dense_ops as jd
from mask3d_tpu_torch.sparse import int8_ops
from mask3d_tpu_torch.sparse.int8_conv import int8_conv, int8_conv_plain, \
    pack_weights


def make_case(seed, cin=24, cout=48, k=3, b=2, dims=(12, 10, 8)):
    """A grid with zeros at unoccupied cells, its occupancy, a JAX-layout
    weight [k^3, Cin, Cout] and a bound that some |x| exceed (saturation)."""
    rng = np.random.default_rng(seed)
    occ = (rng.random((b,) + dims + (1,)) < 0.3).astype(np.float32)
    x = (rng.standard_normal((b,) + dims + (cin,)) * occ).astype(np.float32)
    w = (rng.standard_normal((k ** 3, cin, cout)) * 0.1).astype(np.float32)
    bound = (np.abs(rng.standard_normal(cin)) + 0.5).astype(np.float32)
    return x, occ, w, bound


def port_weight(w):
    """JAX [k^3, Cin, Cout] cube ravel -> the port's [Cout, Cin, k, k, k]."""
    k = round(w.shape[0] ** (1 / 3))
    return torch.tensor(w.reshape(k, k, k, w.shape[1], w.shape[2])
                        .transpose(4, 3, 0, 1, 2).copy())


def as_jax(x, bf16):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def as_torch(x, bf16):
    t = torch.tensor(x)
    return t.bfloat16() if bf16 else t


def test_quantize_static_and_dequantize_bitwise():
    x, _, _, bound = make_case(0)
    ref = jd.quantize_static(jnp.asarray(x), jnp.asarray(bound))
    got = int8_ops.quantize_static(torch.tensor(x), torch.tensor(bound))
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert int(np.abs(np.asarray(ref.q)).max()) == 127  # saturates
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        r = np.asarray(jd.dequantize(ref, jdt).astype(jnp.float32))
        g = int8_ops.dequantize(got, tdt)
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), r)


# (k, static bound, bf16 input and output)
CONV_CASES = [(3, True, True), (3, False, False), (1, True, True),
              (1, False, True), (3, False, True)]


@pytest.mark.parametrize("k,static,bf16", CONV_CASES)
def test_dense_conv_same_int8_bitwise(k, static, bf16):
    x, occ, w, bound = make_case(1 + k, k=k)
    ref = jd.dense_conv_same_int8(
        as_jax(x, bf16), jnp.asarray(w), jnp.asarray(occ),
        out_dtype=jnp.bfloat16 if bf16 else jnp.float32,
        act_bound=jnp.asarray(bound) if static else None)
    got = int8_ops.dense_conv_same_int8(
        as_torch(x, bf16), port_weight(w), torch.tensor(occ),
        out_dtype=torch.bfloat16 if bf16 else torch.float32,
        act_bound=torch.tensor(bound) if static else None)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert np.abs(np.asarray(ref, np.float32)).max() > 0


def test_dense_conv_same_int8_qgrid_input_bitwise():
    """A QGrid (int8_residual's junction output) feeds the conv as it is."""
    x, occ, w, bound = make_case(7, cin=48, cout=48)
    jq = jd.quantize_static(jnp.asarray(x, jnp.bfloat16), jnp.asarray(bound))
    tq = int8_ops.quantize_static(torch.tensor(x).bfloat16(),
                                  torch.tensor(bound))
    ref = jd.dense_conv_same_int8(jq, jnp.asarray(w), jnp.asarray(occ),
                                  out_dtype=jnp.bfloat16)
    got = int8_ops.dense_conv_same_int8(tq, port_weight(w),
                                        torch.tensor(occ))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_quantize_weights_matches_the_chain_prep():
    """The weight quantizer against the JAX chain's `prep_weights_int8`
    (without its lane embedding)."""
    from mask3d_tpu.sparse import pallas_chain as pc

    _, _, w, bound = make_case(3)
    sx = np.asarray(jd.quantize_static(jnp.zeros(1), jnp.asarray(bound))
                    .scale)
    full, sw_full = pc.prep_weights_int8(jnp.asarray(w), jnp.asarray(sx),
                                         24, 48, None, None)
    wq, sw = int8_ops.quantize_weights(torch.tensor(w), torch.tensor(sx))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(full)[:, :24, :48])
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_full)[:48])


def test_pack_weights_layout():
    """The kernel's weight words: input channel 4g + j of output o in byte j
    of word [tap, g, o], zero padded."""
    rng = np.random.default_rng(4)
    wq = torch.tensor(rng.integers(-127, 128, (27, 24, 40)), dtype=torch.int8)
    words = pack_weights(wq, 32, 64)
    assert words.dtype == torch.int32 and tuple(words.shape) == (27, 8, 64)
    b = words.contiguous().view(torch.int8).view(27, 8, 64, 4)
    back = b.permute(0, 1, 3, 2).reshape(27, 32, 64)
    assert torch.equal(back[:, :24, :40], wq)
    assert not back[:, 24:].any() and not back[:, :, 40:].any()


def test_int8_conv_wrapper_checks_and_cpu_plain():
    """A CPU tensor takes the plain version and counts no launch; bad
    arguments raise."""
    x, occ, w, bound = make_case(5)
    xq = int8_ops.quantize_static(torch.tensor(x), torch.tensor(bound))
    wq, sw = int8_ops.quantize_weights(torch.tensor(w), xq.scale)
    occ_t = torch.tensor(occ)
    n = int8_conv.launches
    got = int8_conv(xq.q, occ_t, wq, sw)
    ref = int8_conv_plain(xq.q, occ_t, wq, sw)
    assert torch.equal(got.out, ref.out) and int8_conv.launches == n
    with pytest.raises(TypeError):
        int8_conv(xq.q.float(), occ_t, wq, sw)  # mode none wants int8
    with pytest.raises(ValueError):
        int8_conv(torch.tensor(x).bfloat16(), occ_t, wq, sw,
                  "affine")  # no prologue consts
    with pytest.raises(ValueError):
        int8_conv(xq.q, occ_t[..., :5, :], wq, sw)
