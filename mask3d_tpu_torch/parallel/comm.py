"""Collectives of the data- and sequence-parallel paths, and the autograd
Functions built on them.

Only `all_reduce`, `all_gather`, `broadcast` and `reduce` are used: NCCL
refuses two ranks on one card and gloo may refuse `send`/`recv` of CUDA
tensors, and these four run on both backends (a reduce-scatter is one
`reduce` a destination rank). `_staged` is the one place a tensor is
copied for a backend: a CUDA tensor goes through host memory for gloo only
(gloo's CUDA support depends on how PyTorch was built), a host tensor onto
the card for NCCL; the NCCL path never stages a CUDA tensor.

Autograd conventions of the sharded backbone (`models/backbone.py`): a
tensor sharded over `sp` (an x-slab of a grid) carries its true gradient on
its rank; a tensor replicated inside the backbone (a level too small to
shard) carries a partial gradient whose sum over the `sp` ranks is the true
one, so the backbone's parameter gradients are summed over `sp`; the
decoder runs whole on every `sp` rank with complete gradients, which are
not summed. The Functions below move tensors between those forms. At
inference the decoder's rows are split over `sp` instead
(`parallel.mesh.RowChunks`): each rank holds one contiguous chunk of every
level's rows, reduced from the slabs by `reduce_scatter_rows`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as tdist

# bytes each collective of this process moved (payload sizes), by name;
# `chip_smoke.py` reads them per step
BYTES: dict = {}


def reset_bytes():
    BYTES.clear()


def _count(name: str, t: torch.Tensor):
    BYTES[name] = BYTES.get(name, 0) + t.numel() * t.element_size()


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def group_size(group=None) -> int:
    if not _initialized():
        return 1
    return tdist.get_world_size(group)


def group_rank(group=None) -> int:
    if not _initialized():
        return 0
    return tdist.get_rank(group)


def _staged(t: torch.Tensor, group):
    """(tensor the backend takes, whether it is a copy of `t`)."""
    backend = tdist.get_backend(group)
    if backend == "gloo" and t.is_cuda:
        return t.cpu(), True
    if backend == "nccl" and not t.is_cuda:
        return t.to("cuda", torch.cuda.current_device()), True
    return t, False


def all_reduce(t: torch.Tensor, op=tdist.ReduceOp.SUM, group=None,
               name: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (a group of one rank runs it
    too); returns `t`. No-op without a process group."""
    if not _initialized():
        return t
    _count(name, t)
    work, copied = _staged(t.contiguous() if not t.is_contiguous() else t,
                           group)
    tdist.all_reduce(work, op=op, group=group)
    if copied or work is not t:
        t.copy_(work)
    return t


def all_gather(t: torch.Tensor, group=None, name: str = "all_gather"
               ) -> List[torch.Tensor]:
    """Every rank's `t` (equal shapes), in rank order, on `t`'s device."""
    if not _initialized():
        return [t]
    _count(name, t)
    work, copied = _staged(t.contiguous(), group)
    out = [torch.empty_like(work) for _ in range(group_size(group))]
    tdist.all_gather(out, work, group=group)
    if copied:
        out = [o.to(t.device) for o in out]
    return out


def reduce_scatter_rows(x: torch.Tensor, bounds, group,
                        name: str = "rows") -> torch.Tensor:
    """This rank's rows [bounds[r], bounds[r + 1]) (axis 1) of the sum of
    every rank's `x` over `group`: one `reduce` a destination rank. Counts
    the chunks this rank sends to the others. No gradient."""
    if not _initialized():
        return x[:, bounds[0]:bounds[1]]
    r = group_rank(group)
    mine = None
    for d in range(group_size(group)):
        part = x[:, bounds[d]:bounds[d + 1]].contiguous()
        if d != r:
            _count(name, part)
        work, copied = _staged(part, group)
        if not copied:
            work = work.clone()  # a reduce may overwrite a sender's buffer
        tdist.reduce(work, dst=tdist.get_global_rank(group, d), group=group)
        if d == r:
            mine = work.to(x.device) if copied else work
    return mine


def broadcast(t: torch.Tensor, src: int = 0, group=None,
              name: str = "broadcast") -> torch.Tensor:
    """In-place broadcast of `t` from global rank `src`; returns `t`."""
    if not _initialized():
        return t
    _count(name, t)
    work, copied = _staged(t, group)
    tdist.broadcast(work, src=src, group=group)
    if copied:
        t.copy_(work)
    return t


def max_over(x: torch.Tensor, group, name: str = "max") -> torch.Tensor:
    """The elementwise max of `x` over `group`, in place; no gradient."""
    return all_reduce(x, op=tdist.ReduceOp.MAX, group=group, name=name)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, forward and backward: per-rank partial sums
    (a sharded norm's statistics) whose total every rank reads. Each
    rank's gradient of its part is the sum of the ranks' gradients of the
    total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group=group, name="norm_stats")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), group=ctx.group,
                          name="norm_stats_grad"), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group) if group_size(group) > 1 else x


class _RowsFromSlabs(torch.autograd.Function):
    """Whole rows from each rank's rows (zero outside its slab): a sum
    forward. The rows feed the decoder, which runs whole on every rank, so
    the incoming gradient is the same on every rank and each rank keeps it
    as it is: the row gather's backward takes its own rows. (An autograd
    all-gather would sum the ranks' gradients, n_sp times the true one.)"""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group=group, name="rows")

    @staticmethod
    def backward(ctx, g):
        return g, None


def rows_from_slabs(x: torch.Tensor, group) -> torch.Tensor:
    return _RowsFromSlabs.apply(x, group) if group_size(group) > 1 else x


class _ToPartial(torch.autograd.Function):
    """A replicated backbone tensor handed to the decoder: identity forward;
    the decoder's complete gradient goes to `sp` rank 0 only, so that the
    sum over the ranks is the true gradient (the backbone convention)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.keep = group_rank(group) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def to_partial(x: torch.Tensor, group) -> torch.Tensor:
    return _ToPartial.apply(x, group) if group_size(group) > 1 else x


def _pad_x(x, extent):
    """Zero-pad axis 1 of `x` to `extent`."""
    if x.shape[1] == extent:
        return x
    pad = x.new_zeros((x.shape[0], extent - x.shape[1]) + x.shape[2:])
    return torch.cat([x, pad], dim=1)


def gather_x(x: torch.Tensor, bounds, group, name="slabs",
             dim: int = 1) -> torch.Tensor:
    """The whole grid from each rank's x-slab (axis `dim`, 1 by default),
    the slab of rank r spanning [bounds[r], bounds[r + 1]); also a level's
    rows from each rank's chunk. No gradient."""
    if dim != 1:
        return gather_x(x.movedim(dim, 1), bounds, group, name).movedim(
            1, dim)
    ext = max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:]))
    parts = all_gather(_pad_x(x, ext), group, name=name)
    return torch.cat([p[:, :b1 - b0] for p, b0, b1 in
                      zip(parts, bounds[:-1], bounds[1:])], dim=1)


class _GatherSlabs(torch.autograd.Function):
    """A sharded grid made whole on every rank for a replicated level. The
    replicated consumers hand back partial gradients, so the backward sums
    them over the ranks and keeps this rank's slab."""

    @staticmethod
    def forward(ctx, x, bounds, group):
        ctx.bounds, ctx.group = bounds, group
        return gather_x(x, bounds, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        g = all_reduce(g.contiguous().clone(), group=ctx.group,
                       name="slabs_grad")
        return g[:, ctx.bounds[r]:ctx.bounds[r + 1]], None, None


def gather_slabs(x: torch.Tensor, bounds, group) -> torch.Tensor:
    return _GatherSlabs.apply(x, tuple(bounds), group)


class _Halo(torch.autograd.Function):
    """`h` x-planes of each neighbour's slab on either side of this rank's
    (zeros at the grid's outer faces), from one all-gather of every rank's
    first and last `h` planes. Backward: the gradients of the planes lent
    to a neighbour come back from it by the same all-gather and are added
    to this rank's edge planes."""

    @staticmethod
    def forward(ctx, x, h, group):
        ctx.h, ctx.group = h, group
        r, n = group_rank(group), group_size(group)
        edges = all_gather(torch.cat([x[:, :h], x[:, -h:]], dim=1), group,
                           name="halo")
        zeros = x.new_zeros((x.shape[0], h) + x.shape[2:])
        left = edges[r - 1][:, h:] if r > 0 else zeros
        right = edges[r + 1][:, :h] if r < n - 1 else zeros
        return torch.cat([left, x, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        h, group = ctx.h, ctx.group
        r, n = group_rank(group), group_size(group)
        lent = all_gather(torch.cat([g[:, :h], g[:, -h:]], dim=1), group,
                          name="halo_grad")
        gx = g[:, h:-h].clone()
        if r > 0:  # rank r - 1 read my first planes as its right halo
            gx[:, :h] += lent[r - 1][:, h:]
        if r < n - 1:  # rank r + 1 read my last planes as its left halo
            gx[:, -h:] += lent[r + 1][:, :h]
        return gx, None, None


def halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """[B, X, Y, Z, C] -> [B, X + 2h, Y, Z, C] (see `_Halo`)."""
    return _Halo.apply(x, h, group)


def flat_all_reduce(tensors: List[Optional[torch.Tensor]], group,
                    name: str):
    """Sum every tensor over `group` in one all-reduce of their
    concatenation, in list order (None entries are skipped); in place."""
    live = [t for t in tensors if t is not None]
    if not _initialized() or not live:
        return
    flat = torch.cat([t.reshape(-1) for t in live])
    all_reduce(flat, group=group, name=name)
    o = 0
    for t in live:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
