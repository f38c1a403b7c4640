"""Entry point: train and test with Hydra-style override strings, as the
JAX package's `python -m mask3d_tpu.cli`:

    python -m mask3d_tpu_torch.cli train data.data_root=<root> \\
        general.experiment_name=run trainer.max_epochs=30

    python -m mask3d_tpu_torch.cli test \\
        general.checkpoint="saved/.../best_val_mean_ap_50.ckpt" \\
        data.test_batch_size=1 general.filter_out_instances=true

    python -m mask3d_tpu_torch.cli --device cpu general.train_mode=false ...

`--device {cuda,cpu}` (default cuda) picks where the model runs; it is
taken out of the arguments before the overrides are read. `train` fits the
model (resuming from the run directory's `last-epoch.ckpt`), writing
checkpoints and `metrics.csv` under `general.save_dir`. The checkpoint of
`test` is one the port or the JAX package wrote (`train/checkpoint.py`
reads both). `test` prints `k: v` for every metric, sorted. On CUDA the
run's convs and matmuls are full float32, and `trainer.deterministic`
(default true) asks for deterministic algorithms (`loop.configure_torch`).
"""

from __future__ import annotations

import logging
import random
import sys

import numpy as np

DEVICES = ("cuda", "cpu")


# from mask3d_tpu/cli.py:25 seed_everything
def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def _take_device(argv):
    """(device, remaining argv): `--device X` or `--device=X`, anywhere."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.partition("=")[2]
        else:
            rest.append(a)
    if device not in DEVICES:
        raise SystemExit(f"--device must be one of {DEVICES}, got {device!r}")
    return device, rest


# from mask3d_tpu/cli.py:31 main
def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    device, argv = _take_device(argv)
    # Two invocation forms: an explicit subcommand, or only overrides with
    # `general.train_mode` selecting the command.
    if argv and argv[0] in ("train", "test"):
        command, *overrides = argv
    else:
        command, overrides = None, argv

    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.train.loop import configure_torch
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    cfg = Config()
    apply_overrides(cfg, overrides)
    if command is None:
        command = "train" if cfg.general.train_mode else "test"
    cfg.general.train_mode = command == "train"
    seed_everything(cfg.general.seed)
    if device == "cuda":
        # before the trainer's first CUDA op (the cuBLAS workspace setting)
        configure_torch(cfg.trainer.deterministic)

    trainer = InstanceSegmentationTrainer(cfg, device=device)
    if command == "train":
        trainer.fit()
        return 0
    metrics = trainer.test()
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
