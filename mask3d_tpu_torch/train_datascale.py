"""Data-scale flagship training through the shipped entry path
(tools/train_datascale.sh of the JAX package): the experiment-1 launch
overrides -> `cli train` -> trainer -> evaluator, on a 256-train /
32-validation / 32-test synthetic Structured3D-format dataset (the
reference's room-count mixture, `make_synthetic_dataset.py`).

    python -m mask3d_tpu_torch.train_datascale [max_epochs] \\
        [--device cuda|cpu] [--root R] [--run-id ID] [override ...]

The dataset is written on the first run (`data/synth_stru3d`), and one
level-0 grid shape is pinned over the whole run as floor and ceiling
(`data.grid_dims_cap`: an augmented scene whose voxel box exceeds the pin,
after the stru3d preset's rotations and scales, is centre-cropped to fit by
the collator). The overrides are those of
experiment_launch_scripts/experiment1_voxel_size_150_train.sh, then the
data-scale script's own (micro-batch 1 x accumulation 16, remat, bucket
65536, lr 3e-4, validation every 5 epochs, `last` every 2), then the
caller's; later ones win, as in the shell. The run resumes from
`saved/experiment1_voxel_size_150/<run id>/last-epoch.ckpt`.

Left out: the shell's supervisor loop (tools/train_datascale.sh:57-107),
which relaunched the trainer after the JAX bench's TPU preemption or while
`/tmp/tpu_pause` existed. Nothing preempts the card's trainer, and the
trainer's own auto-resume covers a relaunch by hand.
"""

from __future__ import annotations

import os
import sys
from typing import Sequence

from mask3d_tpu_torch.make_synthetic_dataset import main as write_dataset
from mask3d_tpu_torch.make_synthetic_dataset import pinned_grid_dims

ROOT = os.path.join("data", "synth_stru3d")
RUN_ID = "r5_datascale"
EPOCHS = 100
SIZES = (256, 32, 32, 0)  # train, validation, test scenes; seed
EXPERIMENT_NAME = "experiment1_voxel_size_150"

# from experiment_launch_scripts/experiment1_voxel_size_150_train.sh:11-19 train
EXPERIMENT1 = [
    "trainer.grad_accum_steps=4",
    f"general.experiment_name={EXPERIMENT_NAME}",
    "data.dataset=structured3d",
    "trainer.max_epochs=30",
    "data.rasterization_factor=150",
    "general.filter_out_instances=false",
    "general.use_dbscan=false",
]


# from tools/train_datascale.sh:68-86 experiment1_voxel_size_150_train
def datascale_overrides(root: str, grid: Sequence[int], epochs: int,
                        run_id: str = RUN_ID) -> list:
    return [
        f"data.data_root={root}",
        "data.valid_scenes_file_path=null",
        f"data.grid_dims_cap=[{','.join(str(int(d)) for d in grid)}]",
        "data.point_bucket_multiple=65536",
        "trainer.grad_accum_steps=16",
        "data.test_batch_size=4",
        "data.volume_augmentations=stru3d",
        "model.remat_backbone=true",
        "optimizer.lr=0.0003",
        f"trainer.max_epochs={epochs}",
        "trainer.check_val_every_n_epoch=5",
        "trainer.save_last_every_n_epochs=2",
        "trainer.log_every_n_steps=16",
        "trainer.train_split_metrics=false",
        "general.use_dbscan=false",
        "general.scores_threshold=0.0",
        "general.export_las=false",
        f"general.experiment_id={run_id}",
    ]


def argv_for(root: str, grid, epochs: int, run_id: str = RUN_ID,
             device: str = "cuda", extra: Sequence[str] = ()) -> list:
    """`cli train`'s arguments: the experiment-1 overrides, the data-scale
    ones, then `extra`."""
    return (["train", "--device", device] + EXPERIMENT1
            + datascale_overrides(root, grid, epochs, run_id) + list(extra))


# from tools/train_datascale.sh:33-35 scene_00000
def main(epochs: int = EPOCHS, root: str = ROOT, run_id: str = RUN_ID,
         device: str = "cuda", extra: Sequence[str] = (),
         sizes: Sequence[int] = SIZES) -> int:
    """Write the dataset where `root/scene_00000` is missing (`sizes`:
    train, validation, test, seed), pin the grid and run `cli train`;
    returns its exit code."""
    from mask3d_tpu_torch import cli

    if not os.path.isdir(os.path.join(root, "scene_00000")):
        write_dataset(root, *sizes)
    grid = pinned_grid_dims(root)
    print(f"pinned grid_dims_cap={list(grid)}", flush=True)
    return cli.main(argv_for(root, grid, epochs, run_id, device, extra))


def cli_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--device": "cuda", "--root": ROOT, "--run-id": RUN_ID}
    rest = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            rest.append(a)
    epochs = EPOCHS
    if rest and rest[0].isdigit():
        epochs = int(rest.pop(0))
    return main(epochs, opts["--root"], opts["--run-id"], opts["--device"],
                rest)


if __name__ == "__main__":
    sys.exit(cli_main())
