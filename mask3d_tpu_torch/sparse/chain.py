"""The fused int8 block chain of the dense eval path: a stack of stride-1
BasicBlocks on one grid level as int8 conv kernels (`sparse/int8_conv.py`)
with the InstanceNorm affine, ReLU, static quantize and residual join in
their prologues and the norm's sums in their epilogues.

Kernel steps for a 2-block stage (the flagship's stages 7 and 8):

    entry:    quantize(x); conv1 of block 0 (+ its 1x1 downsample)
              -> raw1 (+ res_raw), sums
    mid:      [affine1, relu, quantize] conv2 of block 0      -> raw2, sums
    junction: [affine2 + residual affine, relu, quantize] conv1 of block 1
              -> yq (block 0's output, int8), raw1, sums
    mid:      [affine1', relu, quantize] conv2 of block 1     -> raw2', sums
    join:     relu(raw2' * A2 + occ * B2 + residual), plain PyTorch -> bf16

The same BasicBlock stack as `Res16UNetBase._block` on the int8 path, up to
where the two round: here the affine runs in f32 from the kernels' sums;
there the norm rounds its constants and applies them in the grid's dtype.
So the two differ by quantize flips, and which stages fuse is part of the
model's numerics: the routing (`Res16UNetBase._blocks`) keeps the JAX
package's limits, `MIN_ROWS` included.

Port of the TPU kernel's function, not of its layout: the packed rows, the
128-lane padding and the occupancy in lane `cout` of `pallas_chain.py`
(:14-35), its paired-tap weights (:224-241) and its DMA schedule are Mosaic
workarounds. Here grids stay [B, X, Y, Z, C] beside an f32 occupancy grid.
"""

from __future__ import annotations

import torch

from mask3d_tpu_torch.sparse.int8_conv import int8_conv
from mask3d_tpu_torch.sparse.int8_ops import act_bound, act_scale, \
    quantize, quantize_weights

# from mask3d_tpu/sparse/pallas_chain.py:86 MIN_ROWS: the smallest grid,
# in the TPU layout's padded rows (X+4)(Y+2)(Z+2), that the routing fuses.
# Tests set it to 0.
MIN_ROWS = 16384


def padded_rows(grid_dims) -> int:
    """The TPU layout's row count of a grid: (X+4)(Y+2)(Z+2)."""
    gx, gy, gz = grid_dims
    return (gx + 4) * (gy + 2) * (gz + 2)


# from mask3d_tpu/sparse/pallas_chain.py:244 in_affine (no lane padding)
def in_affine(stats_sum, stats_sq, count, gamma, beta, eps: float = 1e-5):
    """InstanceNorm affine (A, B) f32 [B, C] from the sums of a conv's
    output: mean = sum/cnt, var = max(sq/cnt - mean^2, 0),
    A = gamma * rsqrt(var + eps), B = beta - mean * A."""
    cnt = torch.clamp_min(count.float(), 1.0)[:, None]
    mean = stats_sum / cnt
    var = torch.clamp_min(stats_sq / cnt - mean * mean, 0.0)
    rs = torch.rsqrt(var + eps)
    a = rs * gamma.float()
    return a, beta.float() - mean * a


# from mask3d_tpu/sparse/pallas_chain.py:270 quant_consts (no lane padding)
def quant_consts(bound):
    """(inv, s): the prologue's quantize multiplier 1/s and the scale s of
    a static bound."""
    s = act_scale(bound)
    return 1.0 / s, s


def _per_item(v, b: int):
    """A static [C] row as the per-(item, channel) [B, C] the kernel
    takes."""
    return v.float()[None].expand(b, -1).contiguous()


# from mask3d_tpu/sparse/pallas_chain.py:703 fused_basic_stage
def fused_basic_stage(x, bound_in, occ, blocks, sigma: float,
                      eps: float = 1e-5):
    """Run a stack of BasicBlocks through the chain.

    x: [B, X, Y, Z, cin] bf16 or f32, zeros at unoccupied cells;
    bound_in: f32 [cin], static bound on |x|; occ: f32 [B, X, Y, Z, 1] in
    {0, 1}; blocks: per-block dicts of w1, w2 ([27, Cin, planes], cube
    ravel) and g1, b1, g2, b2 (norm gamma/beta), plus wd [1, cin, planes],
    gd, bd on block 0 when cin != planes; sigma: `model.int8_act_sigma`.
    Returns (y bf16 [B, X, Y, Z, planes], bound_out f32 [planes])."""
    b = x.shape[0]
    cin = x.shape[-1]
    planes = blocks[0]["w1"].shape[-1]
    n = len(blocks)
    count = occ.float().sum(dim=(1, 2, 3))[:, 0]

    def sig_bound(g, bt):
        return act_bound(sigma, g, bt)

    # entry: quantize (zeros where empty), conv1 (+ the 1x1 downsample)
    sx = act_scale(bound_in)
    xq = quantize(x, sx) * occ.to(torch.int8)
    has_down = cin != planes
    b0 = blocks[0]
    wq1, sw1 = quantize_weights(b0["w1"], sx)
    wdq = swd = None
    if has_down:
        wdq, swd = quantize_weights(b0["wd"], sx)
    r = int8_conv(xq, occ, wq1, sw1, "none", wdq=wdq, swd=swd, stats=True)
    raw1, stats, res_raw = r.out, r.stats, r.out2

    zeros = torch.zeros((b, planes), dtype=torch.float32, device=x.device)
    if not has_down:  # block 0's identity residual: the quantized input
        res, res_a, res_b, bres = xq, _per_item(sx, b), zeros, bound_in

    for idx, blk in enumerate(blocks):
        a1, b1 = in_affine(stats[:, 0], stats[:, 1], count, blk["g1"],
                           blk["b1"], eps)
        inv1, s1 = quant_consts(sig_bound(blk["g1"], blk["b1"]))
        wq2, sw2 = quantize_weights(blk["w2"], s1)
        r = int8_conv(raw1, occ, wq2, sw2, "affine", A=a1, Bc=b1, inv=inv1,
                      stats=True)
        raw2, stats2 = r.out, r.stats
        a2, b2 = in_affine(stats2[:, 0], stats2[:, 1], count, blk["g2"],
                           blk["b2"], eps)
        if idx == 0 and has_down:
            res_a, res_b = in_affine(stats[:, 2], stats[:, 3], count,
                                     blk["gd"], blk["bd"], eps)
            res = res_raw
            bres = sig_bound(blk["gd"], blk["bd"])
        y_bound = sig_bound(blk["g2"], blk["b2"]) + bres

        if idx < n - 1:
            inv_y, s_y = quant_consts(y_bound)
            wq1n, sw1n = quantize_weights(blocks[idx + 1]["w1"], s_y)
            r = int8_conv(raw2, occ, wq1n, sw1n, "join", A=a2, Bc=b2,
                          res=res, Ar=res_a, Br=res_b, inv=inv_y,
                          stats=True)
            raw1, stats = r.out, r.stats
            # the next block's identity residual: this junction's output
            res, res_a, res_b, bres = r.yq, _per_item(s_y, b), zeros, y_bound
            continue

        # final join, plain PyTorch: the stage output feeds taps and skips
        occf = occ.float()
        o2 = raw2.float() * a2[:, None, None, None, :] + \
            occf * b2[:, None, None, None, :]
        res_t = res.float() * res_a[:, None, None, None, :]
        if res.dtype != torch.int8:
            res_t = res_t + occf * res_b[:, None, None, None, :]
        y = torch.clamp_min(o2 + res_t, 0.0)
        return y.to(torch.bfloat16), y_bound
