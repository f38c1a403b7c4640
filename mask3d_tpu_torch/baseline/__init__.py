"""The RoomFormer baseline in PyTorch (the JAX package's `baseline/`): the
floorplan model over 256x256 density maps, its criterion with the soft
rasterizer, the density-map dataset, the floorplan metrics, the evaluation
bridge that scores its polygons with the Mask3D evaluator
(`RoomFormer/mask3d_evaluator/roomformer_to_mask3d.py`), and the engine
`python -m mask3d_tpu_torch.baseline.engine train|eval`.
"""

from mask3d_tpu_torch.baseline.roomformer_bridge import (  # noqa: F401
    density_normalization,
    points_to_density_map,
    polygons_to_mask3d_prediction,
)
from mask3d_tpu_torch.baseline.roomformer import (  # noqa: F401
    RoomFormer,
    RoomFormerOutput,
)
from mask3d_tpu_torch.baseline.criterion2d import \
    RoomFormerCriterion  # noqa: F401
from mask3d_tpu_torch.baseline.floorplan_eval import (  # noqa: F401
    FloorplanEvaluator,
    SceneCADEvaluator,
)
