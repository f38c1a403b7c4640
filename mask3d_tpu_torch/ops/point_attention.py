"""Edge-list point-transformer attention and relative-position ops (the
reference's pointops2 attention kernels), plain PyTorch as the JAX
package's are plain XLA.

An edge list of M (query row, key row) pairs: `index0[m]` is the query /
destination row, `index1[m]` the key / source row, over flat point sets
[N, h, c]; `edge_ok` masks padding edges. The aggregations sum over the
edges of each destination row (`index_add_`); a destination outside
[0, num_points) is dropped."""

from __future__ import annotations

import torch


def _where_ok(x, edge_ok):
    return x if edge_ok is None else torch.where(edge_ok[:, None], x, 0.0)


def _segment_sum(x, index, num_points: int):
    """x [M, ...] summed into rows `index` of [num_points, ...]."""
    index = index.long()
    index = torch.where((index >= 0) & (index < num_points), index,
                        num_points)
    out = x.new_zeros((num_points + 1,) + x.shape[1:])
    return out.index_add_(0, index, x)[:num_points]


# from mask3d_tpu/ops/point_attention.py:27 attention_step1
def attention_step1(q, k, index0, index1, edge_ok=None):
    """q, k [N, h, c] -> attn [M, h] = sum_c q[index0] * k[index1]."""
    out = torch.einsum("mhc,mhc->mh", q[index0.long()], k[index1.long()])
    return _where_ok(out, edge_ok)


# from mask3d_tpu/ops/point_attention.py:44 attention_step2
def attention_step2(attn, v, index0, index1, num_points: int, edge_ok=None):
    """attn [M, h], v [N, h, c] -> out [num_points, h, c]:
    out[n] = sum over the edges m into n of attn[m] * v[index1[m]]."""
    w = _where_ok(attn, edge_ok)
    return _segment_sum(w[..., None] * v[index1.long()], index0, num_points)


# from mask3d_tpu/ops/point_attention.py:60 rpe_table_lookup
def rpe_table_lookup(table, rel_idx):
    """table [L, h, c, 3], rel_idx [M, 3] -> [M, h, c]: the sum over the
    three axes a of table[rel_idx[m, a], :, :, a]."""
    rel = rel_idx.long()
    return (table[rel[:, 0], :, :, 0] + table[rel[:, 1], :, :, 1]
            + table[rel[:, 2], :, :, 2])


# from mask3d_tpu/ops/point_attention.py:70 dot_prod_with_idx
def dot_prod_with_idx(q, index, table, rel_idx, edge_ok=None):
    """q [N, h, c] -> [M, h] = sum_c q[index[m]] * rpe[m]."""
    out = torch.einsum("mhc,mhc->mh", q[index.long()],
                       rpe_table_lookup(table, rel_idx))
    return _where_ok(out, edge_ok)


# from mask3d_tpu/ops/point_attention.py:87 attention_step2_with_rel_pos_value
def attention_step2_with_rel_pos_value(attn, v, index0, index1, table,
                                       rel_idx, num_points: int,
                                       edge_ok=None):
    """`attention_step2` with the relative-position encoding added to the
    values: out[n] = sum over the edges m into n of attn[m] *
    (v[index1[m]] + rpe[m])."""
    ve = v[index1.long()] + rpe_table_lookup(table, rel_idx)
    w = _where_ok(attn, edge_ok)
    return _segment_sum(w[..., None] * ve, index0, num_points)


# from mask3d_tpu/ops/point_attention.py:104 aggregation
def aggregation(feats, position, weight, idx):
    """Vector-attention aggregation: feats [N, C], position [N, k, C],
    weight [N, k, C'] with C a multiple of C', idx [N, k] -> [N, C]:
    out[n, c] = sum_j (feats[idx[n, j], c] + position[n, j, c]) *
    weight[n, j, c // (C / C')]."""
    c, cp = feats.shape[-1], weight.shape[-1]
    if c % cp:
        raise ValueError(f"{c} channels do not split into {cp} weights")
    grouped = feats[idx.long()] + position
    return (grouped * weight.repeat_interleave(c // cp, dim=-1)).sum(dim=1)
