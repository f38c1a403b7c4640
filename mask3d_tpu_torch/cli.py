"""Entry point: test (and, once ported, train) with Hydra-style override
strings, as the JAX package's `python -m mask3d_tpu.cli`:

    python -m mask3d_tpu_torch.cli test \\
        general.checkpoint="saved/.../best_val_mean_ap_50.ckpt" \\
        data.test_batch_size=1 general.filter_out_instances=true

    python -m mask3d_tpu_torch.cli --device cpu general.train_mode=false ...

`--device {cuda,cpu}` (default cuda) picks where the model runs; it is
taken out of the arguments before the overrides are read. The checkpoint is
one the JAX package wrote (`train/checkpoint.py` reads it). `test` prints
`k: v` for every metric, sorted. `train` is not ported yet.
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
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    cfg = Config()
    apply_overrides(cfg, overrides)
    if command is None:
        command = "train" if cfg.general.train_mode else "test"
    cfg.general.train_mode = command == "train"
    if command == "train":
        raise NotImplementedError(
            "train is not ported yet (ROADMAP Queue 1 item 4); run "
            "`python -m mask3d_tpu.cli train` and test its checkpoint here")
    seed_everything(cfg.general.seed)

    trainer = InstanceSegmentationTrainer(cfg, device=device)
    metrics = trainer.test()
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
