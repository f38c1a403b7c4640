"""Standalone ops: masked cross-attention, furthest-point sampling, the
LSAP solver, segment reductions (`segment`), k-NN and ball query (`knn`)
and the edge-list point attention (`point_attention`)."""

# from mask3d_tpu/ops/__init__.py:18 furthest_point_sample (the exports)
from mask3d_tpu_torch.ops.fps import furthest_point_sample  # noqa: F401
from mask3d_tpu_torch.ops.lsap import linear_sum_assignment  # noqa: F401
from mask3d_tpu_torch.ops.point_attention import (  # noqa: F401
    aggregation,
    attention_step1,
    attention_step2,
    attention_step2_with_rel_pos_value,
    dot_prod_with_idx,
)
from mask3d_tpu_torch.ops.segment import (  # noqa: F401
    batched_segment_reduce,
    segment_max,
    segment_mean,
    segment_min,
)
