"""Entry point: train and test with Hydra-style override strings, as the
JAX package's `python -m mask3d_tpu.cli`:

    python -m mask3d_tpu_torch.cli train data.data_root=<root> \\
        general.experiment_name=run trainer.max_epochs=30

    python -m mask3d_tpu_torch.cli test \\
        general.checkpoint="saved/.../best_val_mean_ap_50.ckpt" \\
        data.test_batch_size=1 general.filter_out_instances=true

    python -m mask3d_tpu_torch.cli --device cpu general.train_mode=false ...

`--device {cuda,cpu}` (default cuda) picks where the model runs; it is
taken out of the arguments before the overrides are read.

Data parallelism, one rank a card:

    python -m mask3d_tpu_torch.cli train trainer.num_data_parallel=4 ...

starts 4 local ranks (`torch.multiprocessing` spawn, an NCCL group on
localhost; the command raises on a host with fewer cards), and

    torchrun --nproc-per-node 4 [--nnodes ...] -m mask3d_tpu_torch.cli \
        train trainer.distributed=true trainer.num_data_parallel=4 ...

joins torchrun's ranks (NCCL on CUDA, gloo with `--device cpu`);
`num_data_parallel` must equal the world size. `data.batch_size` stays the
global batch. `train` fits the
model (resuming from the run directory's `last-epoch.ckpt`), writing
checkpoints and `metrics.csv` under `general.save_dir`. The checkpoint of
`test` is one the port or the JAX package wrote (`train/checkpoint.py`
reads both). `test` prints `k: v` for every metric, sorted. On CUDA the
run's convs and matmuls are full float32, and `trainer.deterministic`
(default true) asks for deterministic algorithms (`loop.configure_torch`).
"""

from __future__ import annotations

import logging
import os
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

    from mask3d_tpu_torch.parallel import dist

    cfg = Config()
    apply_overrides(cfg, overrides)
    if command is None:
        command = "train" if cfg.general.train_mode else "test"
    cfg.general.train_mode = command == "train"
    n = cfg.trainer.num_data_parallel
    if not cfg.trainer.distributed and n > 1:
        _launch_local(command, cfg, device, n)
        return 0
    # from mask3d_tpu/cli.py:60-64: before anything touches the card
    created = dist.maybe_initialize(cfg, device)
    try:
        if cfg.trainer.distributed and n != dist.process_count():
            raise ValueError(
                f"trainer.distributed=true: trainer.num_data_parallel={n} "
                f"must equal the world size {dist.process_count()}")
        _run(command, cfg, device)
    finally:
        if created:
            import torch.distributed

            torch.distributed.destroy_process_group()
    return 0


def _run(command, cfg, device):
    from mask3d_tpu_torch.parallel import dist
    from mask3d_tpu_torch.train.loop import configure_torch
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    seed_everything(cfg.general.seed)
    if device == "cuda":
        # before the trainer's first CUDA op (the cuBLAS workspace setting)
        configure_torch(cfg.trainer.deterministic)
    trainer = InstanceSegmentationTrainer(cfg, device=device)
    if command == "train":
        trainer.fit()
        return
    metrics = trainer.test()
    if dist.is_main_process():
        for k, v in sorted(metrics.items()):
            print(f"{k}: {v:.4f}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_local(command, cfg, device, n):
    """`n` ranks on this host, one a card, started with spawn (a forked
    child cannot use the parent's CUDA context); each joins an NCCL group
    on localhost and runs the command. A rank that fails fails the
    command."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device != "cuda" or cards < n:
        raise RuntimeError(
            f"trainer.num_data_parallel={n} runs one rank a CUDA card and "
            f"this host has {cards} card(s) (--device {device}); on the CPU "
            f"or across hosts use torchrun with trainer.distributed=true")
    import torch.multiprocessing as mp

    mp.spawn(_local_rank, args=(command, cfg, device, n, _free_port()),
             nprocs=n, join=True)


def _local_rank(rank, command, cfg, device, n, port):
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s rank{rank} %(levelname)s %(name)s: "
               f"%(message)s")
    cfg.trainer.distributed = True
    cfg.trainer.process_id = rank
    cfg.trainer.num_processes = n
    cfg.trainer.coordinator_address = f"localhost:{port}"
    os.environ["LOCAL_RANK"] = str(rank)
    from mask3d_tpu_torch.parallel import dist

    dist.maybe_initialize(cfg, device)
    try:
        _run(command, cfg, device)
    finally:
        import torch.distributed

        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
