"""Instance-segmentation metrics: ScanNet-style mAP over IoU thresholds plus
precision/recall/F1 @ 0.5, mean matched IoU and successfully-detected-rooms.
"""

from mask3d_tpu_torch.evalm.evaluator import Mask3DEvaluator  # noqa: F401
