"""K-fold scene splitter: a copy of mask3d_tpu/utils/kfold.py.

Deterministic k-fold partitioning of a scene list for cross-validation
experiments; fold assignment is stable under the seed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


# from mask3d_tpu/utils/kfold.py:14 kfold_splits
def kfold_splits(scenes: Sequence[str], k: int, seed: int = 0
                 ) -> List[Tuple[List[str], List[str]]]:
    """Returns k (train_scenes, val_scenes) pairs covering all scenes."""
    assert k >= 2
    order = np.random.default_rng(seed).permutation(len(scenes))
    folds = [order[i::k] for i in range(k)]
    out = []
    for i in range(k):
        val = sorted(scenes[j] for j in folds[i])
        train = sorted(
            scenes[j] for f in folds[:i] + folds[i + 1:] for j in f
        )
        out.append((train, val))
    return out
