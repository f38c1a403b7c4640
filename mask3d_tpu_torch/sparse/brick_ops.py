"""Bricked dense execution: the level-0 grid as occupied dense bricks.

A scan whose level-0 grid is too large for the dense path (the hall scene
of `bench_large_scene.py`: 888,766 voxels on a 1920x168x72 = 23.2M-cell
grid, 3.8% occupied) keeps the dense executor by cutting ONLY level 0
into a static lattice of bricks (16x16x8 by default; the brick dims must
divide the level-0 grid dims and be even). The bricks that hold a voxel
get a slot of a packed `[NB + 1, bx, by, bz, C]` tensor, channels last
like every dense grid of the port; slot NB is an all-zero sentinel, and
`capacity` (NB) pads the occupied count. Coarser levels stay full dense
grids (stride 2 shrinks the cells 8x).

- Same-stride convs run per brick on a halo gathered from the 26
  neighbour slots (`halo_pad`: 27 slice copies over the slot axis, the
  sentinel giving zeros), then one cuDNN `F.conv3d` VALID over
  `[NB, C, bx+2h, by+2h, bz+2h]`, in chunks of `chunk` slots so the
  halo-padded tensor stays bounded.
- The stride-2 junctions are exact reshapes: a k=2 s=2 window never
  crosses a brick boundary (even brick dims), so `conv_down` convolves
  each brick and scatters the half-bricks into the level-1 grid, and
  `conv_tr` gathers each slot's coarse block and transposes it.
- `instance_norm` sums every brick in f32 in a fixed order of slot chunks.

Every op is differentiable and gives the gradient of the JAX package's
autodiff: the drop slot and the sentinel slot are sliced off after the
scatters, so a dropped row's gradient is zero; `index_put_` without
accumulation and the `index_select` backward are deterministic under
`torch.use_deterministic_algorithms(True)`; the brick tap's backward is
`RowGather`'s scatter-add. Where a gradient is wanted, the conv chunks are
concatenated (`torch.mul(out=)` takes no autograd) and each chunk is
checkpointed (its halo-padded copy is made again in the backward, not
kept), and the norm's sums are one Function that keeps only its input
(`_SumSq`): at the hall's level 0 (6,912 slots of 2,048 cells, 96
channels in bf16) each kept copy is 2.7-4.5 GB.

Semantics mirror `dense_ops` op for op (submanifold re-masking by the
occupancy, the two-pass InstanceNorm); `tests/test_torch_brick_ops.py`
holds each op to the JAX package's and to the port's dense one. Weights
are PyTorch's layouts, as in `dense_ops`. Rows come back from the bricks
through the row-gather kernel (`row_gather.py`), whose source here is the
whole flattened brick tensor, `(NB + 1) * cells` rows.

Unlike the JAX package, which computes `BrickTables.overflow` and never
reads it (more occupied bricks than the capacity drop their voxels), the
port's bricked backbone puts the flag into the sparse batch's
`any_overflow()`, which `infer` returns.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mask3d_tpu_torch.sparse.core import SparseLevel
from mask3d_tpu_torch.sparse.dense_ops import _bxyzc, _cast, _ncdhw
from mask3d_tpu_torch.sparse.row_gather import row_gather


# from mask3d_tpu/sparse/brick_ops.py:54 BrickSpec
class BrickSpec(NamedTuple):
    """Static geometry of the level-0 brick decomposition."""

    grid_dims: Tuple[int, int, int]
    brick_dims: Tuple[int, int, int]
    capacity: int  # NB: the most occupied bricks a scene may have

    @property
    def slots(self) -> Tuple[int, int, int]:
        return tuple(-(-g // b) for g, b in zip(self.grid_dims,
                                                self.brick_dims))

    @property
    def n_slots(self) -> int:
        sx, sy, sz = self.slots
        return sx * sy * sz

    @property
    def cells(self) -> int:
        bx, by, bz = self.brick_dims
        return bx * by * bz


# from mask3d_tpu/sparse/brick_ops.py:77 make_brick_spec
def make_brick_spec(grid_dims: Sequence[int], brick_dims=(16, 16, 8),
                    capacity: int = 8192) -> BrickSpec:
    """Raises ValueError where the brick dims do not divide the grid dims
    or are odd (the stride-2 junctions need even bricks)."""
    gd = tuple(int(d) for d in grid_dims)
    bd = tuple(int(d) for d in brick_dims)
    if len(bd) != 3 or any(g % b for g, b in zip(gd, bd)):
        raise ValueError(f"model.brick_dims {bd} must divide the level-0 "
                         f"grid dims {gd}")
    if any(b % 2 for b in bd):
        raise ValueError(f"model.brick_dims {bd} must be even")
    if capacity < 1:
        raise ValueError(f"model.brick_capacity {capacity} < 1")
    return BrickSpec(gd, bd, int(capacity))


# from mask3d_tpu/sparse/brick_ops.py:87 BrickTables
@dataclasses.dataclass
class BrickTables:
    """The index structure of one scene.

    slot_key: i64[NB] linear brick key per slot, ascending; empty slots
        hold `n_slots`.
    brick_ok: bool[NB] the slot holds an occupied brick.
    nbr: i64[NB, 27] slot of each neighbour brick ((dx, dy, dz) x-major,
        z fastest); missing or out-of-grid neighbours point at slot NB (the
        zero sentinel).
    row_flat: i32[N] flat cell (slot * cells + cell) of each voxel row;
        invalid rows, and rows of bricks past the capacity, point past the
        sentinel brick ((NB + 1) * cells), where scatters drop them.
    overflow: bool[] more occupied bricks than the capacity.
    """

    slot_key: torch.Tensor
    brick_ok: torch.Tensor
    nbr: torch.Tensor
    row_flat: torch.Tensor
    overflow: torch.Tensor


_OFFS = [(dx, dy, dz)
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


# from mask3d_tpu/sparse/brick_ops.py:112 build_tables
def build_tables(level: SparseLevel, spec: BrickSpec) -> BrickTables:
    """Brick tables from the level-0 rows of one item (B == 1)."""
    if level.coords.shape[0] != 1:
        raise ValueError(f"bricked execution is B=1, got a batch of "
                         f"{level.coords.shape[0]}")
    dev = level.coords.device
    c = level.coords[0].long()  # [N, 3]
    valid = level.valid[0]
    bx, by, bz = spec.brick_dims
    sx, sy, sz = spec.slots
    nb, ns = spec.capacity, spec.n_slots

    bkey = ((c[:, 0] // bx) * sy + c[:, 1] // by) * sz + c[:, 2] // bz
    bkey = torch.where(valid, bkey, ns)  # the sentinel key sorts last
    sk = torch.sort(bkey).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    first &= sk < ns
    slot_of_sorted = torch.cumsum(first.long(), 0) - 1
    overflow = first.sum() > nb
    # slot_key[s] = the s-th smallest occupied brick key; bricks past the
    # capacity, and every non-first row, write the drop slot nb
    slot_key = torch.full((nb + 1,), ns, dtype=torch.long, device=dev)
    slot_key[torch.where(first & (slot_of_sorted < nb), slot_of_sorted,
                         nb)] = sk
    slot_key = slot_key[:nb]
    brick_ok = slot_key < ns

    def find(keys):
        """Slot of each key, or nb (the sentinel) where it has none."""
        pos = torch.searchsorted(slot_key, keys).clamp(0, nb - 1)
        return torch.where(slot_key[pos] == keys, pos, nb)

    row_slot = find(bkey)
    cell = ((c[:, 0] % bx) * by + c[:, 1] % by) * bz + c[:, 2] % bz
    row_flat = torch.where(valid & (row_slot < nb),
                           row_slot * spec.cells + cell,
                           (nb + 1) * spec.cells).to(torch.int32)

    # neighbour table: [NB, 27]
    offs = torch.tensor(_OFFS, dtype=torch.long, device=dev)
    nx = (slot_key // (sy * sz))[:, None] + offs[:, 0]
    ny = ((slot_key // sz) % sy)[:, None] + offs[:, 1]
    nz = (slot_key % sz)[:, None] + offs[:, 2]
    inb = ((nx >= 0) & (nx < sx) & (ny >= 0) & (ny < sy) & (nz >= 0)
           & (nz < sz) & brick_ok[:, None])
    nkey = torch.where(inb, (nx * sy + ny) * sz + nz, ns)
    nbr = torch.where(inb, find(nkey.reshape(-1)).reshape(nkey.shape), nb)
    return BrickTables(slot_key, brick_ok, nbr, row_flat, overflow)


# ------------------------------------------------------------------ data ops


# from mask3d_tpu/sparse/brick_ops.py:175 scatter_rows
def scatter_rows(feats, tables: BrickTables, spec: BrickSpec):
    """[1, N, C] rows -> bricks [NB + 1, bx, by, bz, C] (zeros elsewhere,
    the sentinel included); rows that point past the sentinel are
    dropped."""
    c = feats.shape[-1]
    n_cells = (spec.capacity + 1) * spec.cells
    flat = feats.new_zeros((n_cells + 1, c))  # the last row: the drop slot
    flat[tables.row_flat.long()] = feats[0]
    return flat[:n_cells].view((spec.capacity + 1,) + spec.brick_dims + (c,))


# from mask3d_tpu/sparse/brick_ops.py:187 gather_rows (the row-gather kernel)
def gather_rows(bricks, tables: BrickTables, spec: BrickSpec, valid):
    """Bricks -> [1, N, C] rows (invalid rows zeroed): the row gather over
    the `(NB + 1) * cells` flattened cells."""
    c = bricks.shape[-1]
    flat = bricks.reshape(1, -1, c)
    idx = tables.row_flat.clamp(0, flat.shape[1] - 1).to(torch.int32)
    return row_gather(flat, idx[None].contiguous(), valid.contiguous())


# from mask3d_tpu/sparse/brick_ops.py:196 occupancy
def occupancy(tables: BrickTables, spec: BrickSpec, valid,
              dtype=torch.float32):
    """[NB + 1, bx, by, bz, 1] indicator of the occupied cells."""
    return scatter_rows(valid[..., None].to(dtype), tables, spec)


def _src(d: int, n: int, h: int) -> slice:
    """Cells of a neighbour brick in direction d that border this one."""
    return {-1: slice(n - h, n), 0: slice(0, n), 1: slice(0, h)}[d]


def _dst(d: int, n: int, h: int) -> slice:
    """Where those cells go in the halo-padded brick."""
    return {-1: slice(0, h), 0: slice(h, h + n),
            1: slice(h + n, h + 2 * n)}[d]


# from mask3d_tpu/sparse/brick_ops.py:203 halo_pad
def halo_pad(bricks, tables: BrickTables, spec: BrickSpec, h: int = 1):
    """[NB + 1, bx, by, bz, C] -> [NB, bx+2h, by+2h, bz+2h, C]: each brick
    with an h-cell halo from its neighbour slots (the sentinel: zeros)."""
    return _halo_pad_range(bricks, tables.nbr, spec, h, 0, spec.capacity)


# from mask3d_tpu/sparse/brick_ops.py:235 _halo_pad_range
def _halo_pad_range(bricks, nbr_rows, spec: BrickSpec, h: int, lo: int,
                    size: int):
    """`halo_pad` of slots [lo, lo + size) (`nbr_rows` = their rows of
    `nbr`); the source stays the whole brick tensor, since neighbours
    cross chunk boundaries."""
    bx, by, bz = spec.brick_dims
    c = bricks.shape[-1]
    out = bricks.new_zeros((size, bx + 2 * h, by + 2 * h, bz + 2 * h, c))
    for k, (dx, dy, dz) in enumerate(_OFFS):
        piece = bricks[:, _src(dx, bx, h), _src(dy, by, h), _src(dz, bz, h)]
        if dx == dy == dz == 0:
            piece = piece[lo: lo + size]
        else:
            piece = piece.index_select(0, nbr_rows[:, k])
        out[:, _dst(dx, bx, h), _dst(dy, by, h), _dst(dz, bz, h)] = piece
    return out


# ------------------------------------------------------------------ conv ops


class _Slots:
    """The [NB + 1, ...] output of a per-chunk op: slots [0, NB) from the
    chunks in order, then the zero sentinel slot. Without a gradient each
    chunk is masked into one buffer in place; with one, the masked chunks
    are concatenated (in-place `out=` writes take no autograd)."""

    def __init__(self, like, shape):
        self.grad = torch.is_grad_enabled()
        self.sentinel = (1,) + tuple(shape[1:])
        self.parts = []
        if not self.grad:
            self.out = like.new_empty(shape)
            self.out[-1].zero_()

    def put(self, lo: int, y, occ):
        """Slots [lo, lo + len(y)) = y * occ."""
        if self.grad:
            self.parts.append(y * occ)
        else:
            torch.mul(y, occ, out=self.out[lo: lo + y.shape[0]])

    def done(self):
        if not self.grad:
            return self.out
        zero = self.parts[-1].new_zeros(self.sentinel)
        return torch.cat(self.parts + [zero])


# from mask3d_tpu/sparse/brick_ops.py:266 conv_same
def conv_same(bricks, weight, occ_bricks, tables: BrickTables,
              spec: BrickSpec, bias=None, compute_dtype=None,
              chunk: int = 2048):
    """Same-stride submanifold conv on bricks (`dense_ops.dense_conv_same`
    on each brick and its halo). weight [Cout, Cin, k, k, k], k odd.
    `chunk` slots a halo-pad + conv step (0: one pass): it bounds the
    halo-padded tensor without changing the result."""
    k = weight.shape[-1]
    h = (k - 1) // 2
    x, w = _cast(bricks, weight, compute_dtype)
    nb = spec.capacity
    step = nb if chunk <= 0 else min(chunk, nb)
    out = _Slots(x, (nb + 1,) + spec.brick_dims + (w.shape[0],))
    for lo in range(0, nb, step):
        size = min(step, nb - lo)
        args = (x, w, bias, tables.nbr[lo: lo + size], spec, h, lo, size)
        if out.grad:
            # the backward pads the chunk again instead of keeping its
            # halo-padded copy (1.7x its cells)
            y = checkpoint(_conv_chunk, *args, use_reentrant=False)
        else:
            y = _conv_chunk(*args)
        out.put(lo, y, occ_bricks[lo: lo + size].to(y.dtype))
    return out.done()


def _conv_chunk(x, w, bias, nbr_rows, spec: BrickSpec, h: int, lo: int,
                size: int):
    """The VALID conv of slots [lo, lo + size) with their halo, [size, bx,
    by, bz, Cout] (bias added, not masked)."""
    xp = _halo_pad_range(x, nbr_rows, spec, h, lo, size)
    y = F.conv3d(_ncdhw(xp), w).permute(0, 2, 3, 4, 1)
    return y if bias is None else y + bias.to(y.dtype)


# from mask3d_tpu/sparse/brick_ops.py:304 conv_down
def conv_down(bricks, weight, occ_coarse, tables: BrickTables,
              spec: BrickSpec, coarse_dims, compute_dtype=None):
    """k=2 s=2 conv: bricks -> the DENSE level-1 grid [1, X/2, Y/2, Z/2,
    Cout] (`dense_ops.dense_conv_down`). weight [Cout, Cin, 2, 2, 2]."""
    x, w = _cast(bricks[: spec.capacity], weight, compute_dtype)
    half = _bxyzc(F.conv3d(_ncdhw(x), w, stride=2))
    dense = slots_to_dense(half, tables, spec)
    dense = dense[:, : coarse_dims[0], : coarse_dims[1], : coarse_dims[2]]
    return dense * occ_coarse.to(dense.dtype)


# from mask3d_tpu/sparse/brick_ops.py:321 slots_to_dense
def slots_to_dense(half_bricks, tables: BrickTables, spec: BrickSpec):
    """[NB, hx, hy, hz, C] blocks -> [1, Sx*hx, Sy*hy, Sz*hz, C] dense grid
    (empty slots zero)."""
    hx, hy, hz, c = half_bricks.shape[1:]
    sx, sy, sz = spec.slots
    ns = spec.n_slots
    grid = half_bricks.new_zeros((ns + 1, hx, hy, hz, c))
    grid[tables.slot_key] = half_bricks  # empty slots write the drop slot
    grid = grid[:ns].view(sx, sy, sz, hx, hy, hz, c)
    grid = grid.permute(0, 3, 1, 4, 2, 5, 6)
    return grid.reshape(1, sx * hx, sy * hy, sz * hz, c)


# from mask3d_tpu/sparse/brick_ops.py:338 dense_to_slots
def dense_to_slots(dense, tables: BrickTables, spec: BrickSpec, hx: int,
                   hy: int, hz: int):
    """[1, X', Y', Z', C] dense grid -> [NB, hx, hy, hz, C] per-slot
    blocks (X' etc. zero-padded up to Sx*hx; empty slots zero)."""
    sx, sy, sz = spec.slots
    c = dense.shape[-1]
    g = F.pad(dense[0], (0, 0, 0, sz * hz - dense.shape[3],
                         0, sy * hy - dense.shape[2],
                         0, sx * hx - dense.shape[1]))
    g = g.view(sx, hx, sy, hy, sz, hz, c).permute(0, 2, 4, 1, 3, 5, 6)
    g = g.reshape(sx * sy * sz, hx, hy, hz, c)
    g = torch.cat([g, g.new_zeros((1, hx, hy, hz, c))])  # empty slots
    key = torch.where(tables.brick_ok, tables.slot_key, spec.n_slots)
    return g.index_select(0, key)


# from mask3d_tpu/sparse/brick_ops.py:354 conv_tr
def conv_tr(dense, weight, occ_bricks, tables: BrickTables, spec: BrickSpec,
            compute_dtype=None):
    """k=2 s=2 transposed conv: the dense level-1 grid -> bricks
    (`dense_ops.dense_conv_tr`): out[2i+d] = in[i] @ w[d]. weight [Cin,
    Cout, 2, 2, 2]; `F.conv_transpose3d` meets that contract as it is (the
    JAX package flips its kernel for `lax.conv_transpose`'s)."""
    bx, by, bz = spec.brick_dims
    nb = spec.capacity
    blk = dense_to_slots(dense, tables, spec, bx // 2, by // 2, bz // 2)
    blk, w = _cast(blk, weight, compute_dtype)
    y = F.conv_transpose3d(_ncdhw(blk), w, stride=2).permute(0, 2, 3, 4, 1)
    out = _Slots(y, (nb + 1,) + y.shape[1:])
    out.put(0, y, occ_bricks[:nb].to(y.dtype))
    return out.done()


class _SumSq(torch.autograd.Function):
    """f32 per-channel sums of x and x * x over every cell, `chunk` slots
    at a time in slot order. The backward, ds + 2 x dsq in f32 cast to x's
    dtype, is the autodiff of those sums of `x.float()`; it keeps x alone
    (which the norm's affine keeps too), not an f32 copy of it."""

    @staticmethod
    def forward(ctx, x, chunk: int):
        c = x.shape[-1]
        s = torch.zeros(c, dtype=torch.float32, device=x.device)
        sq = torch.zeros_like(s)
        for lo in range(0, x.shape[0], chunk):
            x32 = x[lo: lo + chunk].reshape(-1, c).float()
            s += x32.sum(0)
            sq += (x32 * x32).sum(0)
        ctx.save_for_backward(x)
        ctx.chunk = chunk
        return s, sq

    @staticmethod
    def backward(ctx, ds, dsq):
        (x,) = ctx.saved_tensors
        dx = torch.empty_like(x)
        for lo in range(0, x.shape[0], ctx.chunk):
            x32 = x[lo: lo + ctx.chunk].float()
            dx[lo: lo + ctx.chunk] = (ds + 2.0 * x32 * dsq).to(x.dtype)
        return dx, None


# from mask3d_tpu/sparse/brick_ops.py:378 instance_norm
def instance_norm(bricks, occ_bricks, gamma, beta, eps: float = 1e-5,
                  chunk: int = 2048):
    """InstanceNorm over every brick of the (one) item: the math and the
    affine form of `dense_ops.dense_instance_norm` at B=1 (unoccupied
    cells must be exactly 0). The f32 sums run over `chunk` slots at a
    time, in slot order: one fixed order, so a run repeats bitwise."""
    s, sq = _SumSq.apply(bricks, chunk)
    cnt = occ_bricks.float().sum().clamp_min(1.0)
    mean = s / cnt
    var = (sq / cnt - mean * mean).clamp_min(0.0)
    rs = torch.rsqrt(var + eps)
    k = (rs * gamma).to(bricks.dtype)
    t = (beta - mean * rs * gamma).to(bricks.dtype)
    return bricks * k + occ_bricks.to(bricks.dtype) * t
