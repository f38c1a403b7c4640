"""int8 eval convolutions on dense grids: static or dynamic activation
scales folded into per-output-channel int8 weights, integer accumulation and
an f32 requant, through the int8 conv kernel (`sparse/int8_conv.py`).

The arithmetic mirrors the JAX package's op for op, so that the integer
inputs, and with them the outputs, are bitwise the same: the activation
scale sx = max(bound, 1e-8) * (1/127) and q = clip(round(x * (1/sx)), 127)
(a multiply by the reciprocal); the folded weight wf = w * sx, its scale
sw = max(absmax wf, 1e-12) * (1/127) and wq = clip(round(wf / sw), 127) (a
division); rounding half to even throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mask3d_tpu_torch.sparse.int8_conv import int8_conv


# from mask3d_tpu/sparse/dense_ops.py:170 QGrid
class QGrid(NamedTuple):
    """Statically quantized dense grid: deq = q * scale (per channel)."""

    q: torch.Tensor  # int8 [B, Gx, Gy, Gz, C]
    scale: torch.Tensor  # f32 [C], bound / 127


# from mask3d_tpu/models/backbone.py:498 _act_bound (the arithmetic)
def act_bound(sigma: float, gamma, beta):
    """Static per-channel bound sigma*|gamma| + |beta| on a norm's output,
    rounded once to f32, as a fused multiply-add: the JAX package's
    compiled model computes it so (its XLA contracts the expression), and
    the bound sets the int8 scales downstream, so an ulp here moves
    quantize boundaries everywhere after it."""
    return (sigma * gamma.double().abs() + beta.double().abs()).float()


def act_scale(bound):
    """Per-channel activation scale of a bound on |x|."""
    return torch.clamp_min(bound.float(), 1e-8) * (1.0 / 127.0)


def quantize(x, sx):
    """int8 clip(round(x / sx)), as x times the reciprocal of sx."""
    return torch.clamp(torch.round(x.float() * (1.0 / sx)), -127.0,
                       127.0).to(torch.int8)


# from mask3d_tpu/sparse/dense_ops.py:186 quantize_static
def quantize_static(x, bound) -> QGrid:
    """Quantize with the static per-channel bound; bitwise the input
    quantization of `dense_conv_same_int8` given the same bound."""
    sx = act_scale(bound)
    return QGrid(quantize(x, sx), sx)


# from mask3d_tpu/sparse/dense_ops.py:197 dequantize
def dequantize(qg: QGrid, dtype=torch.float32):
    return (qg.q.float() * qg.scale).to(dtype)


def weight_rows(weight):
    """[Cout, Cin, k, k, k] -> [k^3, Cin, Cout] in cube-ravel order."""
    return weight.permute(2, 3, 4, 1, 0).reshape(
        -1, weight.shape[1], weight.shape[0])


# from mask3d_tpu/sparse/dense_ops.py:201 dense_conv_same_int8 (its weight
# quantization, :244-247; and pallas_chain.py:197 prep_weights_int8 without
# the lane embedding)
def quantize_weights(w_rows, sx):
    """Fold the activation scales sx [Cin] into w [K, Cin, Cout], then
    quantize per output channel: returns (wq int8 [K, Cin, Cout], sw f32
    [Cout])."""
    wf = w_rows.float() * sx[None, :, None]
    aw = wf.abs().amax(dim=(0, 1))
    sw = torch.clamp_min(aw, 1e-12) * (1.0 / 127.0)
    wq = torch.clamp(torch.round(wf / sw), -127.0, 127.0).to(torch.int8)
    return wq, sw


def _quantize_input(x, act_bound):
    """(int8 grid, sx [Cin]) of a conv input: a QGrid as it is, else with
    the static bound or the absmax over the whole batch grid."""
    if isinstance(x, QGrid):
        return x.q, x.scale
    if act_bound is None:
        ax = x.float().abs().amax(dim=(0, 1, 2, 3))
    else:
        ax = act_bound
    sx = act_scale(ax)
    return quantize(x, sx), sx


# from mask3d_tpu/sparse/dense_ops.py:201 dense_conv_same_int8 (no bias)
def dense_conv_same_int8(x, weight, occ, out_dtype=torch.bfloat16,
                         act_bound=None):
    """Quantized submanifold conv (eval only). x: a grid [B, X, Y, Z, Cin]
    with zeros at unoccupied cells, or a QGrid; weight [Cout, Cin, k, k, k]
    with k 1 or 3; `act_bound` f32 [Cin], the static bound on |x|, or None
    for the dynamic absmax scale. Returns [B, X, Y, Z, Cout] out_dtype."""
    xq, sx = _quantize_input(x, act_bound)
    wq, sw = quantize_weights(weight_rows(weight), sx)
    return int8_conv(xq, occ, wq, sw, "none", out_dtype=out_dtype).out
