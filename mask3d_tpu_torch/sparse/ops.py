"""Row-space sparse ops of the gather path: gather-matmul convolutions over
kernel maps, stride-2 convs and average pooling over PoolMaps,
InstanceNorm over valid rows. The convs take `compute_dtype` (None: the
features' dtype, or bf16): the operands are rounded to it, the products
summed in f32, and the result written in it, as the JAX package's XLA
convs do.

Every feature tensor is `[B, N, C]` in the `[B, N]` row layout of
`sparse/core.py`; conv weights are `[K, Cin, Cout]` in `cube_offsets` order
(`[8, Cin, Cout]` by child position for the stride-2 convs). A segment sum
(a coarse row's children, `_segment_sum_batched`) gathers each of the
eight child positions from the PoolMap's table of the children's rows
(`core.child_row_table`, built once with the map) and adds them
in child-position order: the order in which the fine rows lie, so the sums
are those of a scatter-add in row order, and the same from run to run on
every device whatever `torch.use_deterministic_algorithms` says
(`scatter_add_` adds with atomics on CUDA there). Padding and overflowed
rows, whose parent is the coarse capacity, are dropped.
"""

from __future__ import annotations

import torch

from mask3d_tpu_torch.sparse.core import PoolMap


# from mask3d_tpu/sparse/ops.py:19 gather_rows
def gather_rows(feats, idx, ok):
    """feats [B, N, C], idx/ok [B, R] -> [B, R, C]: `feats[b, idx[b, r]]`,
    zero where not ok. idx is never trusted where not ok (clamped into
    range before the gather)."""
    n, c = feats.shape[1], feats.shape[2]
    j = idx.long().clamp(0, n - 1)
    g = torch.gather(feats, 1, j[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], g, 0.0)


def _cast(feats, weight, compute_dtype):
    if compute_dtype is None:
        return feats, weight
    return feats.to(compute_dtype), weight.to(compute_dtype)


# from mask3d_tpu/sparse/ops.py:28 sparse_conv (bias-free)
def sparse_conv(feats, weight, nbr_idx, nbr_ok, compute_dtype=None):
    """Same-stride sparse conv: out[b, p] = sum_k ok[b, p, k] *
    feats[b, nbr_idx[b, p, k]] @ weight[k], accumulated in f32.
    weight [K, Cin, Cout]; nbr_idx/nbr_ok [B, N, K]."""
    feats, weight = _cast(feats, weight, compute_dtype)
    out = feats.new_zeros(feats.shape[:2] + (weight.shape[-1],),
                          dtype=torch.float32)
    for k in range(weight.shape[0]):
        g = gather_rows(feats, nbr_idx[..., k], nbr_ok[..., k])
        out += torch.matmul(g.float(), weight[k].float())
    return out.to(feats.dtype)


# from mask3d_tpu/sparse/ops.py:58 _segment_sum_batched
def _segment_sum_batched(x, pool: PoolMap, coarse_capacity: int):
    """Per-item segment sum: x [B, N, C] -> [B, coarse_capacity, C], each
    coarse row the sum of its children's rows in child-position order (see
    the module docstring); rows whose parent is coarse_capacity drop. The
    table of the children's rows is the PoolMap's, built with it."""
    b, n, c = x.shape
    rows = pool.child_rows
    xz = torch.cat([x, x.new_zeros((b, 1, c))], dim=1)  # row n: none
    out = None
    for k in range(8):
        g = torch.gather(xz, 1, rows[..., k, None].expand(-1, -1, c))
        out = g if out is None else out + g
    return out


def _by_child(x, weight, kidx):
    """Row j times weight[kidx[j]]: sum over the 8 child positions of the
    rows at that position times its weight slice (f32)."""
    out = x.new_zeros(x.shape[:2] + (weight.shape[-1],), dtype=torch.float32)
    for k in range(weight.shape[0]):
        sel = (kidx == k)[..., None]
        out += torch.matmul(torch.where(sel, x, 0.0).float(),
                            weight[k].float())
    return out


# from mask3d_tpu/sparse/ops.py:72 sparse_conv_down (bias-free)
def sparse_conv_down(feats, weight, pool: PoolMap, coarse_capacity: int,
                     compute_dtype=None):
    """Stride-2 kernel-2 conv: out[b, i] = sum over the children j of i of
    feats[b, j] @ weight[kidx(j)]. weight [8, Cin, Cout]."""
    feats, weight = _cast(feats, weight, compute_dtype)
    per_row = _by_child(feats, weight, pool.kidx)
    return _segment_sum_batched(per_row, pool,
                                coarse_capacity).to(feats.dtype)


# from mask3d_tpu/sparse/ops.py:103 sparse_conv_tr (bias-free)
def sparse_conv_tr(feats_coarse, weight, pool: PoolMap, fine_valid,
                   compute_dtype=None):
    """Transposed stride-2 kernel-2 conv onto the finer level:
    out[b, j] = feats_coarse[b, parent(j)] @ weight[kidx(j)] for valid j.
    weight [8, Cin, Cout]."""
    feats_coarse, weight = _cast(feats_coarse, weight, compute_dtype)
    gathered = gather_rows(feats_coarse, pool.parent, fine_valid)
    return _by_child(gathered, weight, pool.kidx).to(feats_coarse.dtype)


# from mask3d_tpu/sparse/ops.py:138 avg_pool
def avg_pool(x, pool: PoolMap, coarse_capacity: int):
    """Stride-2 mean over the present children: [B, N_fine, C] ->
    [B, N_coarse, C]."""
    s = _segment_sum_batched(x, pool, coarse_capacity)
    denom = pool.nchild.clamp(min=1).to(s.dtype)[..., None]
    return (s / denom).to(x.dtype)


# from mask3d_tpu/sparse/ops.py:151 instance_norm
def instance_norm(feats, valid, gamma, beta, eps=1e-5):
    """Per-item, per-channel norm over each item's valid rows; padding rows
    come out 0."""
    v = valid[..., None]
    f32 = torch.where(v, feats.float(), 0.0)
    cnt = valid.float().sum(dim=1).clamp(min=1.0)[:, None, None]
    mean = f32.sum(dim=1, keepdim=True) / cnt
    sq = (f32 * f32).sum(dim=1, keepdim=True) / cnt
    var = (sq - mean * mean).clamp(min=0.0)
    out = (f32 - mean) * torch.rsqrt(var + eps) * gamma + beta
    return torch.where(v, out, 0.0).to(feats.dtype)

