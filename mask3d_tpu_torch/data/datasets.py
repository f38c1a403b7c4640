"""Dataset readers: Structured3D / S3DIS / Matterport3D room segmentation.

A copy of mask3d_tpu/data/datasets.py.

Rebuild of the reference dataset classes (`mask3d/datasets/
semseg_structured3d.py`, `semseg_s3dis.py`, `semseg_matterport3d.py`): load
the rasterized `.ply` artifacts (records x,y,z,type,room_id — schema from
`datasets_preprocess/downsample_point_cloud/downsample_ply.py:107-112`),
filter invalid classes, collapse room types to the single `is_room` class,
apply augmentations, and hand item dicts to `VoxelizeCollate`.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from mask3d_tpu_torch.data.augment import make_augmentation
from mask3d_tpu_torch.data.ply import read_ply


# from mask3d_tpu/data/datasets.py:23 Structured3DSegmentationDataset
class Structured3DSegmentationDataset:
    """Reference `semseg_structured3d.py:16-268`.

    Single `is_room` class: every room-type label is clipped to 1
    (`semseg_structured3d.py:211`), class-21 (undefined-polygon) points are
    discarded (`:203`).
    """

    DATASET_CLASSES = {1: "is_room"}
    dataset_name = "structured3d_room_detection"

    def __init__(
        self,
        data_root: str,
        mode: str = "train",
        rasterization_factor: int = 150,
        valid_scenes_file_path: Optional[str] = None,
        volume_augmentations: Optional[str] = None,
        data_fraction: float = 1.0,
        filter_out_classes: Sequence[int] = (),
        filter_out_instance_ids: Sequence[int] = (-1, 0),
        prediction_label_offset: int = 1,
        augmentation_seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.mode = mode
        self.rasterization_factor = rasterization_factor
        self.valid_scenes_file_path = valid_scenes_file_path
        self.data_fraction = data_fraction
        self.filter_out_classes = tuple(filter_out_classes)
        self.filter_out_instance_ids = tuple(filter_out_instance_ids)
        self.prediction_label_offset = prediction_label_offset
        self.volume_augmentations = make_augmentation(
            volume_augmentations, augmentation_seed
        )
        self._data = self.get_filenames()
        self.labels_info = {
            i: {"name": name, "validation": True}
            for i, name in enumerate(self.DATASET_CLASSES.values())
        }

    # -- scene listing / splits --

    def get_scenes(self) -> List[str]:
        dataset_scenes = sorted(os.listdir(self.data_root))
        if not self.valid_scenes_file_path:
            return dataset_scenes
        valid = []
        with open(self.valid_scenes_file_path) as f:
            for line in f:
                s = line.strip()
                if s and s in dataset_scenes:
                    valid.append(s)
        return valid

    def split_of(self, scene: str) -> str:
        """Structured3D split by scene number (`semseg_structured3d.py:137-146`)."""
        num = int(scene.split("_")[-1])
        if num < 3000:
            return "train"
        if num < 3250:
            return "validation"
        if num < 3500:
            return "test"
        raise ValueError(f"Unknown scene number {num}")

    def get_filenames(self) -> List[str]:
        # "trainval" evaluates on train+validation together (reference
        # `data.test_dataset.mode=trainval`, experiment5 trainval scripts).
        wanted = (
            ("train", "validation") if self.mode == "trainval"
            else (self.mode,)
        )
        scenes = [s for s in self.get_scenes() if self.split_of(s) in wanted]
        assert scenes, "Empty dataset."
        if self.data_fraction is not None and self.data_fraction < 1.0:
            scenes = random.sample(
                scenes, int(len(scenes) * self.data_fraction)
            )
        return scenes

    # -- loading --

    def _artifact_path(self, scene: str) -> str:
        return os.path.join(
            self.data_root, scene,
            f"point_cloud_rasterized_{self.rasterization_factor}.ply",
        )

    def load(self, scene: str):
        v = read_ply(self._artifact_path(scene))
        coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
        features = np.ones((len(coords), 1), np.float32)
        semantic = np.asarray(v["type"]).astype(np.int32)
        instance = np.asarray(v["room_id"]).astype(np.int32)
        return coords, features, semantic, instance

    def _class_filter(self, semantic):
        """Drop class 21, collapse room types to is_room (`:203,211`)."""
        keep = semantic != 21
        return keep, np.clip(semantic, a_min=None, a_max=1)

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx: int) -> dict:
        scene = self._data[idx]
        coords, features, semantic, instance = self.load(scene)
        assert len(coords) == len(features) == len(semantic) == len(instance)

        raw_coordinates = coords.copy()
        raw_features = features.copy()

        keep, semantic = self._class_filter(semantic)
        coords = coords[keep]
        features = features[keep]
        semantic = semantic[keep]
        instance = instance[keep]
        raw_coordinates = raw_coordinates[keep]
        raw_features = raw_features[keep]

        labels = np.stack([semantic, instance], axis=-1).astype(np.int32)
        raw_labels = labels.copy()

        if self.volume_augmentations is not None and "train" in self.mode:
            aug = self.volume_augmentations(coords, features, labels)
            coords, features, labels = (
                aug["points"], aug["features"], aug["labels"]
            )
            if len(coords) == 0:
                raise ValueError(f"Empty augmented data for scene {scene}")
            # Row-dropping augmentations (random_dropout in the s3dis /
            # matterport presets) report which rows survived; subset the
            # raw arrays by the same rows so raw_coordinates[i] still
            # corresponds to coordinates[i] (the reference keeps them
            # aligned because volumentations transforms all arrays
            # together).
            kept = aug["kept_indices"]
            raw_coordinates = raw_coordinates[kept]
            raw_features = raw_features[kept]
            raw_labels = raw_labels[kept]

        return {
            "coordinates": coords,
            "features": features,
            "labels": labels,
            "raw_coordinates": raw_coordinates,
            "raw_features": raw_features,
            "raw_labels": raw_labels,
            "scene": scene,
            "idx": idx,
        }

    # -- label id remapping (`semseg_structured3d.py:250-268`) --

    def change_semantic_label_idxs_to_ids(self, output: np.ndarray):
        out = output.copy()
        for idx, label_id in enumerate(self.DATASET_CLASSES.keys()):
            out[output == idx] = label_id
        return out

    def change_semantic_label_ids_to_idxs(self, inp: np.ndarray):
        out = inp.copy()
        for idx, label_id in enumerate(self.DATASET_CLASSES.keys()):
            out[inp == label_id] = idx
        return out

    @property
    def data(self):
        return self._data


# from mask3d_tpu/data/datasets.py:195 S3DISSegmentationDataset
class S3DISSegmentationDataset(Structured3DSegmentationDataset):
    """Reference `semseg_s3dis.py`: areas 1,2,3,4,6 train; area 5 val=test;
    all points labelled is_room; instance id 0 is a VALID instance."""

    dataset_name = "s3dis_room_detection"
    SPLITS = {
        "train": ["area_1", "area_2", "area_3", "area_4", "area_6"],
        "validation": ["area_5"],
        "test": ["area_5"],
        "trainval": [
            "area_1", "area_2", "area_3", "area_4", "area_6", "area_5",
        ],
    }

    def __init__(self, *args, filter_out_instance_ids: Sequence[int] = (),
                 **kwargs):
        super().__init__(
            *args, filter_out_instance_ids=filter_out_instance_ids, **kwargs
        )

    def get_filenames(self) -> List[str]:
        scenes = self.SPLITS[self.mode]
        if self.data_fraction is not None and self.data_fraction < 1.0:
            scenes = random.sample(
                scenes, int(len(scenes) * self.data_fraction)
            )
        assert scenes, "Empty dataset."
        return scenes

    def load(self, scene: str):
        v = read_ply(self._artifact_path(scene))
        coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
        features = np.ones((len(coords), 1), np.float32)
        semantic = np.ones(len(coords), np.int32)  # all is_room
        instance = np.asarray(v["room_id"]).astype(np.int32)
        return coords, features, semantic, instance

    def _class_filter(self, semantic):
        return np.ones(len(semantic), bool), semantic


# from mask3d_tpu/data/datasets.py:236 Matterport3DSegmentationDataset
class Matterport3DSegmentationDataset(S3DISSegmentationDataset):
    """Reference `semseg_matterport3d.py`: split files list scan ids."""

    dataset_name = "matterport3d_room_detection"

    def __init__(self, *args, split_dir: Optional[str] = None, **kwargs):
        self.split_dir = split_dir
        super().__init__(*args, **kwargs)

    def get_filenames(self) -> List[str]:
        mode = {"validation": "val"}.get(self.mode, self.mode)
        if self.split_dir:
            path = os.path.join(self.split_dir, mode)
            with open(path) as f:
                scenes = [line.strip() for line in f if line.strip()]
        else:
            scenes = sorted(os.listdir(self.data_root))
        assert scenes, "Empty dataset."
        if self.data_fraction is not None and self.data_fraction < 1.0:
            scenes = random.sample(
                scenes, int(len(scenes) * self.data_fraction)
            )
        return scenes


DATASETS = {
    "structured3d": Structured3DSegmentationDataset,
    "s3dis": S3DISSegmentationDataset,
    "matterport3d": Matterport3DSegmentationDataset,
}
