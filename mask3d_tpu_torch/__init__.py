"""PyTorch/CUDA port of mask3d_tpu: Mask3D room-instance segmentation on an
NVIDIA H100, with hand-written CUDA kernels for the masked cross-attention,
the grid-to-row gather and the sparse gather-conv of the `gather_pallas`
backbone.

Entry points (each takes `device`, default "cuda"; a CUDA request without
CUDA raises):
    build_model(cfg, device, seed) -> Mask3D with seeded random weights
    collate(items, device, **collate_kwargs) -> HostBatch
    infer(model, batch, cfg, aux_masks, device) -> (Mask3DOutput, overflow)
"""

from mask3d_tpu_torch.config import Config, apply_overrides  # noqa: F401
from mask3d_tpu_torch.data.collate import collate  # noqa: F401
from mask3d_tpu_torch.infer import infer  # noqa: F401
from mask3d_tpu_torch.models.mask3d import build_model  # noqa: F401
from mask3d_tpu_torch.ops.masked_attention import \
    masked_cross_attention  # noqa: F401
from mask3d_tpu_torch.sparse.row_gather import row_gather  # noqa: F401
