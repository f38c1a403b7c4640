"""Process groups for data-parallel training over ranks.

The JAX package's `parallel/dist.py` wires `jax.distributed.initialize()`;
the port's counterpart is a `torch.distributed` process group:

- `maybe_initialize(cfg, device)` calls `init_process_group` when
  `trainer.distributed` is set (rank, world size and address from
  `process_id`, `num_processes` and `coordinator_address`, else torchrun's
  `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL
  with one card a local rank on CUDA, gloo on the CPU. It does nothing where
  a group is already initialised, so a caller (a test, `chip_smoke.py`, the
  cli's local launcher) may initialise the group itself.
- every rank draws the same epoch permutation (the trainer's generator is
  seeded from the config) and `local_batch_indices` slices each global
  batch by rank, so the ranks' items are the global batch with no
  duplication.
- `put_global(batch, device)` is this rank's slice of the batch on its
  device, padded to the shapes every rank of the group shares
  (`pad_to_group`): the same point and instance capacities and grid dims as
  the one-process batch of the same items.
- checkpoints, metrics and the config snapshot belong to rank 0
  (`is_main_process`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from mask3d_tpu_torch.device import resolve_device


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def local_device(device="cuda") -> torch.device:
    """`device` with this process's card index (the current device) where it
    names CUDA without one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(
            f"trainer.distributed=true needs {name} (torchrun sets it) or "
            f"the trainer's process_id / num_processes / "
            f"coordinator_address")
    return int(os.environ[name])


# from mask3d_tpu/parallel/dist.py:36 maybe_initialize
def maybe_initialize(cfg, device="cuda") -> bool:
    """`init_process_group` when `trainer.distributed` is set and no group
    is initialised yet; True where this call initialised one. NCCL on CUDA
    (the process's card is `LOCAL_RANK`, else the rank modulo the cards),
    gloo on the CPU."""
    t = cfg.trainer
    if not t.distributed or initialized():
        return False
    rank = t.process_id if t.process_id >= 0 else _env_int("RANK")
    world = (t.num_processes if t.num_processes > 0
             else _env_int("WORLD_SIZE"))
    addr = t.coordinator_address or (
        f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
        f"{_env_int('MASTER_PORT')}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    tdist.init_process_group(backend, init_method=f"tcp://{addr}",
                             world_size=world, rank=rank)
    return True


# from mask3d_tpu/parallel/dist.py:57 process_count
def process_count() -> int:
    return tdist.get_world_size() if initialized() else 1


# from mask3d_tpu/parallel/dist.py:61 process_index
def process_index() -> int:
    return tdist.get_rank() if initialized() else 0


# from mask3d_tpu/parallel/dist.py:65 is_main_process
def is_main_process() -> bool:
    """Checkpoint / metrics writer guard: rank 0, or no group."""
    return process_index() == 0


def barrier():
    """Every rank waits here (no-op without a group): after a write that
    other ranks then read."""
    if process_count() > 1:
        tdist.barrier()


# from mask3d_tpu/parallel/dist.py:70 local_batch_indices
def local_batch_indices(global_idxs: Sequence[int], pi: Optional[int] = None,
                        pc: Optional[int] = None) -> np.ndarray:
    """This rank's contiguous slice of one GLOBAL batch's indices; the
    global batch must divide evenly by the rank count. Deterministic in
    (pi, pc): every rank computes the same assignment without
    communication."""
    pi = process_index() if pi is None else pi
    pc = process_count() if pc is None else pc
    g = np.asarray(global_idxs)
    assert len(g) % pc == 0, (
        f"global batch size {len(g)} not divisible by {pc} processes"
    )
    per = len(g) // pc
    return g[pi * per:(pi + 1) * per]


def _pad_axis(x: np.ndarray, axis: int, size: int, value=0):
    if x.shape[axis] == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, size - x.shape[axis])
    return np.pad(x, pads, constant_values=value)


def pad_host_batch(host, n_cap: int, i_cap: int, grid0: Sequence[int],
                   all_ones: bool):
    """The HostBatch padded to `n_cap` points, `i_cap` instances and level-0
    grid `grid0` (coarser levels the collator's halving chain): the batch
    the collator makes of these items beside larger ones."""
    from mask3d_tpu_torch.data.batch import HostBatch

    d = host.device
    t = d.target
    gd = [tuple(int(v) for v in grid0)]
    for _ in range(len(d.grid_dims) - 1):
        gd.append(tuple(((v - 1) >> 1) + 1 for v in gd[-1]))
    target = dataclasses.replace(
        t, labels=_pad_axis(np.asarray(t.labels), 1, i_cap),
        masks=_pad_axis(_pad_axis(np.asarray(t.masks), 1, i_cap), 2, n_cap,
                        False),
        valid=_pad_axis(np.asarray(t.valid), 1, i_cap, False),
        point_instance_ids=_pad_axis(np.asarray(t.point_instance_ids), 1,
                                     n_cap))
    dev = dataclasses.replace(
        d, coords=_pad_axis(np.asarray(d.coords), 1, n_cap),
        feats=_pad_axis(np.asarray(d.feats), 1, n_cap), target=target,
        grid_dims=tuple(gd), feats_all_ones=all_ones)
    return HostBatch(
        device=dev, scenes=host.scenes,
        raw_coords=_pad_axis(host.raw_coords, 1, n_cap),
        raw_feats=_pad_axis(host.raw_feats, 1, n_cap),
        raw_labels=(None if host.raw_labels is None
                    else _pad_axis(host.raw_labels, 1, n_cap)))


def pad_to_group(host, group=None):
    """The HostBatch padded to the largest point capacity, instance
    capacity and level-0 grid of every rank of `group` (one MAX all-reduce
    of five integers; `feats_all_ones` only where it holds on every rank).
    Bucketing is monotone, so these are the one-process batch's shapes; the
    batch comes back as it is without a group."""
    from mask3d_tpu_torch.parallel import comm

    if comm.group_size(group) == 1:
        return host
    d = host.device
    ones = d.feats_all_ones
    local = torch.tensor(
        [d.coords.shape[1], d.target.labels.shape[1], *d.grid_dims[0],
         0 if ones is None else (1 if ones else -1)], dtype=torch.int64)
    # MAX over (1, -1, 0) gives 1 where any rank had ones; the MIN of
    # `ones` is wanted, so reduce its negation
    local[-1] = -local[-1]
    comm.all_reduce(local, tdist.ReduceOp.MAX, group)
    n_cap, i_cap, gx, gy, gz, neg = (int(v) for v in local)
    all_ones = None if neg == 0 else neg < 0
    return pad_host_batch(host, n_cap, i_cap, (gx, gy, gz), all_ones)


# from mask3d_tpu/parallel/dist.py:89 put_global
def put_global(host, device="cuda", group=None):
    """This rank's slice of the batch (`host`, a HostBatch of its own
    items) on its device, padded to the group's shapes (`pad_to_group`):
    the counterpart of assembling JAX's global dp-sharded array from each
    host's local slice. Returns (padded HostBatch, DeviceBatch on
    `device`)."""
    host = pad_to_group(host, group)
    return host, host.device.to(device)
