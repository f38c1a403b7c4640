"""Collectives of the data- and sequence-parallel paths, and the autograd
Functions built on them.

Only `all_reduce`, `all_gather`, `broadcast` and `reduce` are used: NCCL
refuses two ranks on one card and gloo may refuse `send`/`recv` of CUDA
tensors, and these four run on both backends (a reduce-scatter is one
`reduce` a destination rank). `_staged` is the one place a tensor is
copied for a backend: a CUDA tensor goes through host memory for gloo only
(gloo's CUDA support depends on how PyTorch was built), a host tensor onto
the card for NCCL; the NCCL path never stages a CUDA tensor.

Gradient convention under `sp`. Every rank computes the same loss. A
tensor is *replicated* (the same on every rank: the queries, the class
logits, the loss), *rank-partial* (this rank's share of a sum over the
ranks, or this rank's chunk of the rows) or, inside the backbone, an
x-slab. A replicated tensor's gradient is complete on every rank; a
rank-partial tensor's is this rank's share. Megatron's pair of Functions
moves between the two:
- *entry* (`enter_partial`, replicated -> rank-partial work): identity
  forward, the gradient summed over the ranks backward. The queries enter
  the attention's partial form over this rank's keys and `mask_embed` the
  product with this rank's mask-feature rows through it, so their
  gradients (and all of the decoder's upstream) are complete;
- *exit* (`sum_partials`, rank-partial -> replicated): the sum over the
  ranks forward, the gradient as it is backward (every rank holds the same
  gradient of the sum, and each passes it to its own share). The
  criterion's mask sums and the FPS query features leave the row chunks
  through it.
`all_gather_partials` (the attention's softmax states) is an exit too: the
combine runs replicated on every rank, so each rank takes its own slot of
the replicated gradient back. `reduce_scatter_rows` hands the slabs' rows
to the row chunks (its adjoint all-gathers the chunks' gradients). The
parameters that read a level's rows (the backbone, the mask-feature head,
the memories' projections) therefore hold this rank's share of their
gradients, which the train step sums over `sp`; every other parameter's
is complete on every rank and is not summed (`train/loop.py`).

`sum_over` is another pair: a sum forward and a sum backward, for the
sharded norm's statistics, whose consumers are slab-local (each rank's
share of the total's gradient is summed back to every slab). Inside the
backbone a tensor replicated over `sp` (a level too small to shard)
carries a gradient whose sum over the ranks is the true one, as the
parameters' do.
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


def _reduce_scatter(x: torch.Tensor, bounds, group, name: str):
    """This rank's rows [bounds[r], bounds[r + 1]) (axis 1) of the sum of
    every rank's `x` over `group`: one `reduce` a destination rank. Counts
    the chunks this rank sends to the others."""
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


class _ReduceScatterRows(torch.autograd.Function):
    """Forward: `_reduce_scatter`. Backward, its adjoint: every rank's
    chunk gradient all-gathered, so that row i of each rank's `x` gets the
    gradient of the chunk that holds row i."""

    @staticmethod
    def forward(ctx, x, bounds, group, name):
        ctx.bounds, ctx.group, ctx.name = bounds, group, name
        return _reduce_scatter(x, bounds, group, name)

    @staticmethod
    def backward(ctx, g):
        return gather_x(g.contiguous(), ctx.bounds, ctx.group,
                        name=ctx.name + "_grad"), None, None, None


def reduce_scatter_rows(x: torch.Tensor, bounds, group,
                        name: str = "rows") -> torch.Tensor:
    """This rank's chunk [bounds[r], bounds[r + 1]) of the rows (axis 1) of
    the sum of every rank's `x` (each rank's slab rows, zeros elsewhere),
    with its gradient (`_ReduceScatterRows`)."""
    if not _initialized():
        return x[:, bounds[0]:bounds[1]]
    return _ReduceScatterRows.apply(x, tuple(bounds), group, name)


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


class _EnterPartial(torch.autograd.Function):
    """Entry: a replicated tensor into rank-partial work (see the module
    docstring). Identity forward; the ranks' gradients summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group,
                          name="entry_grad"), None


def enter_partial(x: torch.Tensor, group) -> torch.Tensor:
    return _EnterPartial.apply(x, group) if group_size(group) > 1 else x


class _SumPartials(torch.autograd.Function):
    """Exit: the ranks' partial sums into their replicated total (see the
    module docstring). Sum forward; the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group, name):
        return all_reduce(x.clone(), group=group, name=name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_partials(x: torch.Tensor, group, name: str = "partials"
                 ) -> torch.Tensor:
    return _SumPartials.apply(x, group, name) if group_size(group) > 1 \
        else x


class _GatherPartials(torch.autograd.Function):
    """Every rank's `x` stacked [R, ...] for a replicated consumer: the
    backward takes this rank's slot of the replicated gradient (a sum over
    the ranks would count it R times)."""

    @staticmethod
    def forward(ctx, x, group, name):
        ctx.rank = group_rank(group)
        return torch.stack(all_gather(x, group, name=name))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None, None


def all_gather_partials(x: torch.Tensor, group, name: str = "partials"
                        ) -> torch.Tensor:
    """[R, ...]: every rank's `x` in rank order (`_GatherPartials`)."""
    if group_size(group) == 1:
        return x[None]
    return _GatherPartials.apply(x, group, name)


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
