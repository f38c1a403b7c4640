"""Segment reductions: the mean, max or min of value rows over integer
segment ids, empty segments 0 (torch-scatter's convention). Ids outside
[0, num_segments) go to a trash segment that is dropped. Plain PyTorch,
as the JAX package's are plain XLA (`jax.ops.segment_*`).

Layout: values [N, C] with ids [N] -> [num_segments, C]; the batched form
takes [B, N, C] with ids and a valid mask [B, N]."""

from __future__ import annotations

import torch


# from mask3d_tpu/ops/segment.py:24 _clip_ids
def _clip_ids(segment_ids, num_segments: int):
    """Ids as int64 with every id outside [0, num_segments) sent to the
    trash slot num_segments."""
    ids = torch.as_tensor(segment_ids).long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _counts(ids, num_segments: int, dtype):
    return torch.zeros(num_segments + 1, dtype=dtype,
                       device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=dtype, device=ids.device))


# from mask3d_tpu/ops/segment.py:31 segment_mean
def segment_mean(values, segment_ids, num_segments: int):
    """Mean of the rows of each segment; an empty segment gives 0."""
    ids = _clip_ids(segment_ids, num_segments)
    total = values.new_zeros((num_segments + 1,) + values.shape[1:])
    total.index_add_(0, ids, values)
    count = _counts(ids, num_segments, values.dtype)
    shape = (-1,) + (1,) * (values.dim() - 1)
    return (total / count.clamp_min(1.0).reshape(shape))[:num_segments]


def _segment_extreme(values, segment_ids, num_segments: int, reduce: str):
    ids = _clip_ids(segment_ids, num_segments)
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    index = ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out.scatter_reduce_(0, index, values, reduce, include_self=False)
    count = _counts(ids, num_segments, torch.int32)
    shape = (-1,) + (1,) * (values.dim() - 1)
    out = torch.where(count.reshape(shape) > 0, out, 0.0)
    return out[:num_segments]


# from mask3d_tpu/ops/segment.py:47 segment_max
def segment_max(values, segment_ids, num_segments: int):
    """Max of the rows of each segment; an empty segment gives 0."""
    return _segment_extreme(values, segment_ids, num_segments, "amax")


# from mask3d_tpu/ops/segment.py:59 segment_min
def segment_min(values, segment_ids, num_segments: int):
    """Min of the rows of each segment; an empty segment gives 0."""
    return _segment_extreme(values, segment_ids, num_segments, "amin")


# from mask3d_tpu/ops/segment.py:73 batched_segment_reduce
def batched_segment_reduce(values, segment_ids, valid, num_segments: int,
                           reduce: str = "mean"):
    """Per item of the padded layout: values [B, N, C], ids [B, N], valid
    bool [B, N] -> [B, num_segments, C]; padding rows are dropped."""
    fns = {"mean": segment_mean, "max": segment_max, "min": segment_min}
    fn = fns[reduce]
    ids = torch.where(valid, torch.as_tensor(segment_ids).long(),
                      num_segments)
    return torch.stack([fn(v, i, num_segments)
                        for v, i in zip(values, ids)])
