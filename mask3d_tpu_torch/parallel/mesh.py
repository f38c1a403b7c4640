"""Rank meshes for data- and sequence-parallel training.

The JAX package shards arrays over a device mesh and lets XLA's SPMD
partitioner insert the collectives (`mask3d_tpu/parallel/mesh.py`). The
port runs one process a rank and writes the collectives out:

- a `Mesh` holds the `dp` and `sp` process groups of this rank, laid out
  row-major as JAX's `devices.reshape(n_dp, n_sp)`: global rank
  `d * n_sp + s` is dp index d and sp index s;
- `use_mesh(mesh)` activates it (the counterpart of
  `jax.sharding.set_mesh`); the model, the criterion and the train step
  read the active mesh;
- data parallelism: each dp rank takes its rows of the batch
  (`shard_batch`); the train step sums the gradients, the CE normaliser and
  the logged losses over `dp` (`train/loop.py`, `train/criterion.py`);
- sequence parallelism (`model.sp_axis`): on the dense backbone each sp
  rank holds an x-slab of every level that `sp_min_per_shard` lets shard
  (`slab_plan`), and `models/backbone.py` runs the convs on the slabs with
  halo exchanges and the norms with summed statistics; on every impl, in
  training and at inference, every level's rows are split into `sp`
  contiguous chunks (`RowChunks`, the split of JAX's `maybe_constrain` on
  axis 1), and the decoder and the criterion run on the rank's chunk with
  their softmax, min/max, any-reductions and sums over points combined
  over `sp`, while the tiny query set stays replicated.

JAX's `maybe_constrain` (a sharding constraint for the SPMD partitioner) has
no torch meaning: the sharded context of `models/backbone.py` takes its
place, and `sp_axis` without an active mesh that carries it is a no-op as
there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from mask3d_tpu_torch.parallel import comm, dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_dp, n_sp) mesh and its two groups (None
    where the axis has one rank or there is no process group)."""

    axis_names: Tuple[str, ...]
    n_dp: int
    n_sp: int
    dp_rank: int
    sp_rank: int
    dp_group: object = None
    sp_group: object = None


def _need(n: int):
    have = dist.process_count()
    if n != have:
        raise ValueError(f"a mesh of {n} ranks in a process group of {have}"
                         f" (one rank a process: start {n} processes)")


# from mask3d_tpu/parallel/mesh.py:30 make_mesh
def make_mesh(num_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """A 1-D `dp` mesh over every rank of the process group (one rank
    without a group; a group of one rank runs its collectives)."""
    n = num_devices or dist.process_count()
    _need(n)
    group = tdist.group.WORLD if dist.initialized() else None
    return Mesh((axis, "sp"), n, 1, dist.process_index(), 0, group, None)


# from mask3d_tpu/parallel/mesh.py:61 make_mesh_2d
def make_mesh_2d(n_dp: int, n_sp: int, dp_axis: str = "dp",
                 sp_axis: str = "sp") -> Mesh:
    """(dp, sp) mesh: batch over `dp`, the grids' x axis over `sp`. Every
    rank creates every group (`new_group` is collective), in the same
    order."""
    _need(n_dp * n_sp)
    rank = dist.process_index()
    d, s = divmod(rank, n_sp)
    dp_group = sp_group = None
    if n_dp > 1:
        for s_ in range(n_sp):
            g = tdist.new_group([d_ * n_sp + s_ for d_ in range(n_dp)])
            if s_ == s:
                dp_group = g
    if n_sp > 1:
        for d_ in range(n_dp):
            g = tdist.new_group([d_ * n_sp + s_ for s_ in range(n_sp)])
            if d_ == d:
                sp_group = g
    return Mesh((dp_axis, sp_axis), n_dp, n_sp, d, s, dp_group, sp_group)


_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate `mesh` for the model, the criterion and the train step (None:
    no mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def dp_coords() -> Tuple[int, int, object]:
    """(n_dp, dp_rank, dp_group) of the active mesh; (1, 0, None) without
    one."""
    m = active_mesh()
    if m is None or m.dp_group is None:
        return 1, 0, None
    return m.n_dp, m.dp_rank, m.dp_group


def sp_group(sp_axis: Optional[str]):
    """The active mesh's sp group where `sp_axis` names an axis of it with
    more than one rank, else None (sp is then a no-op)."""
    m = active_mesh()
    if sp_axis is None or m is None or sp_axis not in m.axis_names[1:]:
        return None
    return m.sp_group if m.n_sp > 1 else None


# from mask3d_tpu/parallel/mesh.py:37 shard_batch
def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """This rank's rows of every array's leading (item) axis: a DeviceBatch,
    a dataclass of arrays, a dict, a tensor or a numpy array."""
    n = mesh.n_dp if axis == mesh.axis_names[0] else mesh.n_sp
    r = mesh.dp_rank if axis == mesh.axis_names[0] else mesh.sp_rank
    if n == 1:
        return batch

    def take(x):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: take(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if hasattr(getattr(x, f.name), "shape")
                or dataclasses.is_dataclass(getattr(x, f.name))})
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} items does not split over "
                             f"{n} {axis} ranks")
        return x[r * (b // n):(r + 1) * (b // n)]

    return take(batch)


# from mask3d_tpu/parallel/mesh.py:45 replicate
def replicate(tensors, mesh: Optional[Mesh] = None):
    """Rank 0's values of every tensor (parameters, buffers, optimizer
    state), broadcast in place over the process group; returns them. Torch
    has no donation, so the caller's tensors are the buffers."""
    tensors = list(tensors)
    if dist.process_count() > 1:
        for t in tensors:
            comm.broadcast(t.data, src=0, name="replicate")
    return tensors


def state_tensors(state) -> list:
    """Every tensor of a `train.loop.TrainState`: parameters, buffers and
    the optimizer's state, in a fixed order."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    for p in state.model.parameters():
        for v in state.optimizer.state.get(p, {}).values():
            if torch.is_tensor(v):
                out.append(v)
    return out


# from mask3d_tpu/parallel/mesh.py:100 sp_min_per_shard
def sp_min_per_shard(grid_x: int, sp_axis: Optional[str]) -> bool:
    """True when a grid of x extent `grid_x` shards over `sp_axis` of the
    active mesh: the per-shard extent must be >= 4, so no 3- or 5-window
    halo and no stride-2 window spans a whole shard. Coarser levels stay
    whole on every rank (they are tiny)."""
    m = active_mesh()
    if sp_group(sp_axis) is None:
        return False
    return grid_x // m.n_sp >= 4


@dataclasses.dataclass(frozen=True)
class Slab:
    """This rank's x-slab [x0, x1) of a level's grid; `bounds[r]` is rank
    r's start, `bounds[-1]` the grid's x extent."""

    group: object
    rank: int
    bounds: Tuple[int, ...]

    @property
    def x0(self) -> int:
        return self.bounds[self.rank]

    @property
    def x1(self) -> int:
        return self.bounds[self.rank + 1]


def slab_plan(grid_dims: Sequence[Sequence[int]], sp_axis: Optional[str]
              ) -> Optional[list]:
    """Per level, this rank's `Slab`, or None where the level stays whole;
    None where sp is off. The coarsest sharded level k splits its x extent
    evenly (the last rank takes the remainder); a finer level j's bounds are
    those times 2^(k-j), clipped to its extent, so a stride-2 conv or pool
    from a slab lands in the slab below it, and a transposed conv back."""
    group = sp_group(sp_axis)
    if group is None:
        return None
    m = active_mesh()
    n = m.n_sp
    gx = [int(g[0]) for g in grid_dims]
    sharded = [sp_min_per_shard(x, sp_axis) for x in gx]
    plan = [None] * len(gx)
    if not any(sharded):
        return plan
    k = max(i for i, s in enumerate(sharded) if s)
    if not all(sharded[:k + 1]):
        raise ValueError(f"sp shards a prefix of the levels: {sharded}")
    base = [r * (gx[k] // n) for r in range(n)] + [gx[k]]
    for j in range(k + 1):
        f = 2 ** (k - j)
        bounds = tuple(min(b * f, gx[j]) for b in base[:-1]) + (gx[j],)
        plan[j] = Slab(group, m.sp_rank, bounds)
    return plan


@dataclasses.dataclass(frozen=True)
class RowChunks:
    """This rank's contiguous chunk of every level's rows under sp: of a
    level of capacity N, rank r holds rows [r * c, (r + 1)
    * c) with c = ceil(N / n_sp), the last chunk cut at N (the split of an
    axis over a mesh axis in the JAX package's sharding)."""

    group: object
    rank: int
    n: int

    def bounds(self, cap: int) -> Tuple[int, ...]:
        c = -(-cap // self.n)
        return tuple(min(r * c, cap) for r in range(self.n)) + (cap,)

    def span(self, cap: int) -> Tuple[int, int]:
        b = self.bounds(cap)
        return b[self.rank], b[self.rank + 1]

    def take(self, x, cap: int, dim: int = 1):
        """This rank's chunk of rows [.., cap, ..] along `dim`."""
        lo, hi = self.span(cap)
        return x.narrow(dim, lo, hi - lo)

    def gather(self, x, cap: int, dim: int = 1, name: str = "row_chunks"):
        """Every rank's chunk along `dim`, whole: the level's `cap` rows."""
        return comm.gather_x(x, self.bounds(cap), self.group, name=name,
                             dim=dim)


def row_chunks(sp_axis: Optional[str]) -> Optional[RowChunks]:
    """The active mesh's row chunks where `sp_axis` names an sp axis of
    more than one rank, else None."""
    group = sp_group(sp_axis)
    if group is None:
        return None
    m = active_mesh()
    return RowChunks(group, m.sp_rank, m.n_sp)
