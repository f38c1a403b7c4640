"""Write a synthetic Structured3D-format dataset to disk
(tools/make_synthetic_dataset.py of the JAX package).

Produces `<root>/scene_NNNNN/point_cloud_rasterized_<rf>.ply` files (binary
PLY, fields x, y, z, type, room_id: what `data/datasets.py`'s
`Structured3DSegmentationDataset.load` reads), byte for byte the JAX tool's
for the same arguments, so that `cli train` / `cli test` run end to end at
data scale without the licence-gated Structured3D download.

Scene numbering follows the reference split rule: train scenes are
numbered from 0 (< 3000), validation from 3000 (< 3250), test from 3250
(< 3500). The scene-shape mixture `CONFIGS` matches the reference dataset's
room counts (1-22 rooms a scene, 6.23 on average); the training rehearsal
(`train_rehearsal.py`) draws its scenes from the same mixture.

`pinned_grid_dims(root)` is the grid pin of the JAX package's data-scale
launcher and int8 recertification (the inline procedure of
tools/train_datascale.sh:39-53 and tools/recert_int8.sh:25-40): the
elementwise max of the scenes' voxel grid dims, each rounded up to a
multiple of 8, so one grid shape serves every batch.

Usage:
    python -m mask3d_tpu_torch.make_synthetic_dataset <root> \\
        [n_train] [n_val] [n_test] [seed]
(defaults 256, 32, n_val, 0; the JAX tool's argument order).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mask3d_tpu_torch.data.collate import voxelize_item
from mask3d_tpu_torch.data.ply import read_ply, write_ply
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

# from tools/make_synthetic_dataset.py:34 CONFIGS
# (nx, ny, multi_floor) -> rooms = nx*ny*(2 if mf); mixture mean 6.22,
# range 1-18 (<= num_queries 25 with matcher slack). The JAX package keeps
# a second copy in tools/train_rehearsal.py:41-50; the port keeps this one.
CONFIGS = [
    ((1, 1, False), 0.10),   # 1 room
    ((2, 1, False), 0.16),   # 2
    ((2, 2, False), 0.22),   # 4
    ((3, 2, False), 0.22),   # 6
    ((2, 2, True), 0.12),    # 8
    ((3, 2, True), 0.10),    # 12
    ((3, 3, True), 0.06),    # 18
    ((4, 3, False), 0.02),   # 12
]


# from tools/make_synthetic_dataset.py:46 make_item
def make_item(rng: np.random.Generator) -> dict:
    """One scene of the mixture: the draws (shape, room size, scene) in the
    JAX tool's order, so one generator gives the same scenes."""
    probs = np.array([w for _, w in CONFIGS])
    probs = probs / probs.sum()
    (nx, ny, mf) = CONFIGS[rng.choice(len(CONFIGS), p=probs)][0]
    rooms = nx * ny * (2 if mf else 1)
    # room_size varies so point counts span the dataset's range; cap
    # room-heavy scenes so every scene fits one point bucket.
    hi = min(45, 29 + int(17 * np.sqrt(8.0 / max(rooms, 8))))
    size = int(rng.integers(28, hi))
    return make_synthetic_scene(
        rng, num_rooms_x=nx, num_rooms_y=ny, room_size=size,
        height=14, jitter=0.3, dropout=0.25, multi_floor=mf,
    )


def ply_path(root: str, scene_name: str,
             rasterization_factor: int = 150) -> str:
    return os.path.join(root, scene_name,
                        f"point_cloud_rasterized_{rasterization_factor}.ply")


# from tools/make_synthetic_dataset.py:61 write_scene
def write_scene(root: str, scene_name: str, item: dict,
                rasterization_factor: int = 150) -> None:
    os.makedirs(os.path.join(root, scene_name), exist_ok=True)
    coords = item["coordinates"].astype(np.float32)
    labels = item["labels"]
    write_ply(
        ply_path(root, scene_name, rasterization_factor),
        {
            "x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
            # semantic "type" (all is_room class 1 here) + instance id
            "type": labels[:, 0].astype(np.int32),
            "room_id": labels[:, 1].astype(np.int32),
        },
        text=False,
    )


# from tools/make_synthetic_dataset.py:80 main
def main(root: str, n_train: int = 256, n_val: int = 32, n_test=None,
         seed: int = 0, rasterization_factor: int = 150) -> None:
    if n_test is None:
        n_test = n_val
    rng = np.random.default_rng(seed)
    counts = []
    # train < 3000 <= validation < 3250 <= test < 3500
    for base, n in ((0, n_train), (3000, n_val), (3250, n_test)):
        for i in range(n):
            item = make_item(rng)
            write_scene(root, f"scene_{base + i:05d}", item,
                        rasterization_factor)
            counts.append(len(item["coordinates"]))
    print(
        f"wrote {n_train} train + {n_val} val + {n_test} test scenes to "
        f"{root}; points/scene min/avg/max = {min(counts)}/"
        f"{int(np.mean(counts))}/{max(counts)}"
    )


def round_up_dims(dims) -> tuple:
    """Each grid dim rounded up to the collator's multiple of 8."""
    return tuple(int(-(-int(d) // 8) * 8) for d in dims)


# from tools/train_datascale.sh:39-53 GRID (also tools/recert_int8.sh:25-40)
def pinned_grid_dims(root: str, rasterization_factor: int = 150) -> tuple:
    """The elementwise max of the voxel grid dims of every scene under
    `root` (every split), rounded up to multiples of 8."""
    mx = np.zeros(3, np.int64)
    for scene in sorted(os.listdir(root)):
        v = read_ply(ply_path(root, scene, rasterization_factor))
        coords = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
        _, _, dims = voxelize_item(coords)
        mx = np.maximum(mx, np.asarray(dims, np.int64))
    return round_up_dims(mx)


if __name__ == "__main__":
    a = sys.argv[1:]
    if not a or a[0] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0 if a else 2)
    main(
        a[0],
        int(a[1]) if len(a) > 1 else 256,
        int(a[2]) if len(a) > 2 else 32,
        int(a[3]) if len(a) > 3 else None,
        int(a[4]) if len(a) > 4 else 0,
    )
