"""int8 same-stride conv with the block chain's prologues and epilogue:
`csrc/int8_conv.cu`.

`int8_conv(x, occ, wq, sw, mode, ...)` computes, on a [B, X, Y, Z, C] grid
with zero padding outside it,

    q   = prologue(x)                                     int8
    acc = sum over the k^3 taps and Cin of q * wq         (exact integers)
    out = (f32(acc) * sw * occ) cast to `out_dtype`

with `mode` one of
- "none": x is already the int8 grid (`dense_conv_same_int8`, a chain's
  entry);
- "affine": q = occ ? clip(rint(relu(x*A + Bc) * inv), +-127) : 0 from a
  bf16 raw conv output (a chain's mid step);
- "join": q from relu(x*A + Bc + res*Ar + Br), res int8 or bf16, and q is
  returned as `yq` too (a chain's junction).
Options: a second 1x1 output from the centre tap (`wdq`, `swd`, mode
"none") and `stats`, the per-(item, channel) sum and sum of squares of each
output after its cast ([B, 2 or 4, Cout]; the kernel adds them in an order
fixed by the plan, so they repeat bitwise from launch to launch).

On a CUDA tensor it launches the hand-written tensor-core kernel, in the
launch shape `plan()` picks (host-side, tested on the CPU), and adds one to
`int8_conv.launches`, to `int8_conv.launches_by_step[step]` and to
`int8_conv.launches_by_shape[((X, Y, Z), Cin, Cout, k, step)]`, where the
step is "conv" (mode none, no stats), "entry" (mode none with stats),
"mid" (affine) or "junction" (join). On a CPU tensor it runs
`int8_conv_plain`, the same arithmetic in plain PyTorch: the integer conv
as float64 products of the integer values, tap by tap, which are exact
(|acc| <= 127^2 * 27 * Cin < 2^31 for every plan, far inside float64's
2^53), item by item and in groups of output channels so that its float64
temporaries stay small at the bottleneck's 1024-wide level-0 grids.

Cout above 384 runs in channel groups of at most GROUP_COUT outputs: a grid
dimension of the kernel, each block computing its tile for one group with
the tile a Cout-256 conv takes (plan()).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mask3d_tpu_torch import cuda_build

MODES = ("none", "affine", "join")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
# the kernel's warps a block, weight ring depth and fragments a warp: the
# plan takes one fragment a warp (128 registers, two blocks an SM) except
# for the 3^3 convs wider than 96 outputs, which take two
# (tune_int8_conv.py)
WARPS, STAGES = 8, 3
FRAGS_PER_WARP = (1, 2)
SMEM_BYTES = 232448  # shared memory a block can use on the H100
SMS = 132  # streaming multiprocessors of the H100
# the kernel's 16-cell fragment (x, y, z): the flattest shape leaves the
# fewest fragments with an occupied cell on the flagship's fine levels
FRAG = (4, 4, 1)
STAGE_BYTES = 16384  # the most weight bytes a ring stage holds (>= 1 chunk)
# split the stages of each tile over blocks where the grid has fewer tiles
# than the card has SMs: about one block an SM, at least MIN_SPLIT_STAGES
# stages a split, at most MAX_SPLITS splits (tune_int8_conv.py)
MIN_SPLIT_STAGES = 4
MAX_SPLITS = 16
# outputs above 384 run in groups of at most this many channels, a grid
# dimension of the kernel: the warps then keep 4 or 8 fragments a tile
# (a whole Cout of 1024 in one block would leave each warp row one)
GROUP_COUT = 256
# the fewest 16-cell fragments a tile may hold: one fragment would stream
# every weight chunk for 16 cells
MIN_FRAGS = 2
# the plain version's output channels a float64 pass
PLAIN_GROUP = 256


class Int8ConvOut(NamedTuple):
    out: torch.Tensor  # [B, X, Y, Z, Cout] out_dtype
    out2: Optional[torch.Tensor]  # bf16 1x1 output (wdq), else None
    yq: Optional[torch.Tensor]  # int8 [B, X, Y, Z, Cin] (join), else None
    stats: Optional[torch.Tensor]  # f32 [B, 2 or 4, Cout] (stats), else None


def step_of(mode: str, stats: bool) -> str:
    """The chain step a call serves, the key of the launch counts."""
    if mode == "none":
        return "entry" if stats else "conv"
    return "mid" if mode == "affine" else "junction"


def _per_item(v):
    """[B, C] -> [B, 1, 1, 1, C] against a [B, X, Y, Z, C] grid."""
    return v[:, None, None, None, :]


def prologue_plain(x, occ, A, Bc, inv, res=None, Ar=None, Br=None):
    """The affine (+ residual join) -> relu -> static quantize prologue,
    masked by occupancy. Each product and sum is rounded on its own, as the
    kernel does (no fused multiply-add)."""
    h = x.float() * _per_item(A) + _per_item(Bc)
    if res is not None:
        h = h + res.float() * _per_item(Ar) + _per_item(Br)
    h = torch.clamp_min(h, 0.0)
    q = torch.clamp(torch.round(h * inv), -127.0, 127.0)
    return torch.where(occ > 0.5, q, 0.0).to(torch.int8)


def _conv_requant(q, wq, sw, occ, dtype):
    """(f32(integer conv of int8 q [B, X, Y, Z, Cin] with int8 wq [k^3,
    Cin, Cout], cube ravel) * sw * occ) cast to `dtype`. The integer sums
    are float64 products of the integer values, tap by tap, exact in any
    order; one item and PLAIN_GROUP output channels a pass."""
    k = round(wq.shape[0] ** (1.0 / 3.0))
    r = k // 2
    b, gx, gy, gz, cin = q.shape
    cout = wq.shape[2]
    out = torch.empty((b, gx, gy, gz, cout), dtype=dtype, device=q.device)
    w = wq.double()
    taps = list(itertools.product(range(k), repeat=3))
    for i in range(b):
        qp = F.pad(q[i].double(), (0, 0, r, r, r, r, r, r))
        o = occ[i].reshape(-1, 1)
        for c0 in range(0, cout, PLAIN_GROUP):
            c1 = min(cout, c0 + PLAIN_GROUP)
            acc = torch.zeros((gx * gy * gz, c1 - c0), dtype=torch.float64,
                              device=q.device)
            for t, (dx, dy, dz) in enumerate(taps):
                sh = qp[dx:dx + gx, dy:dy + gy, dz:dz + gz].reshape(-1, cin)
                acc += sh @ w[t, :, c0:c1]
            out[i, ..., c0:c1] = (acc.float() * sw[c0:c1] * o).to(
                dtype).view(gx, gy, gz, c1 - c0)
    return out


def _stats(*outs):
    rows = []
    for o in outs:
        r = o.float()
        rows += [r.sum(dim=(1, 2, 3)), (r * r).sum(dim=(1, 2, 3))]
    return torch.stack(rows, dim=1)


def int8_conv_plain(x, occ, wq, sw, mode="none", *, A=None, Bc=None,
                    inv=None, res=None, Ar=None, Br=None, wdq=None, swd=None,
                    out_dtype=torch.bfloat16, stats=False) -> Int8ConvOut:
    """The function of `int8_conv` in plain PyTorch."""
    yq = None
    if mode == "none":
        q = x
    else:
        q = prologue_plain(x, occ, A, Bc, inv, res if mode == "join" else
                           None, Ar, Br)
        if mode == "join":
            yq = q
    out = _conv_requant(q, wq, sw, occ, out_dtype)
    out2 = None
    if wdq is not None:
        out2 = _conv_requant(q, wdq, swd, occ, torch.bfloat16)
    st = None
    if stats:
        st = _stats(out) if out2 is None else _stats(out, out2)
    return Int8ConvOut(out, out2, yq, st)


def _check(x, occ, wq, sw, mode, A, Bc, inv, res, Ar, Br, wdq, swd,
           out_dtype):
    if mode not in MODES:
        raise ValueError(f"int8_conv: mode {mode!r} is not one of {MODES}")
    if x.dim() != 5 or wq.dim() != 3:
        raise ValueError(f"int8_conv wants x [B,X,Y,Z,Cin] and wq "
                         f"[k^3,Cin,Cout]; got {tuple(x.shape)}, "
                         f"{tuple(wq.shape)}")
    b, cin = x.shape[0], x.shape[-1]
    k = round(wq.shape[0] ** (1.0 / 3.0))
    if k ** 3 != wq.shape[0] or k not in (1, 3) or wq.shape[1] != cin:
        raise ValueError(f"int8_conv: weight {tuple(wq.shape)} does not fit "
                         f"a 1x1 or 3^3 conv of {cin} channels")
    cout = wq.shape[2]
    if tuple(occ.shape) != tuple(x.shape[:4]) + (1,) or \
            tuple(sw.shape) != (cout,):
        raise ValueError(f"int8_conv: occ {tuple(occ.shape)} or sw "
                         f"{tuple(sw.shape)} does not fit x "
                         f"{tuple(x.shape)} and {cout} outputs")
    if wq.dtype != torch.int8 or (mode == "none") != (x.dtype == torch.int8):
        raise TypeError(f"int8_conv: int8 weights and an int8 x exactly in "
                        f"mode none; got {wq.dtype}, {x.dtype}, {mode}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_conv: out_dtype {out_dtype}")
    if mode != "none":
        if A is None or Bc is None or inv is None:
            raise ValueError(f"int8_conv: mode {mode} needs A, Bc and inv")
        if tuple(A.shape) != (b, cin) or tuple(Bc.shape) != (b, cin) or \
                tuple(inv.shape) != (cin,):
            raise ValueError("int8_conv: A/Bc [B, Cin] and inv [Cin]")
    if mode == "join":
        if res is None or Ar is None or Br is None:
            raise ValueError("int8_conv: mode join needs res, Ar and Br")
        if res.shape != x.shape or res.dtype not in (torch.int8,
                                                     torch.bfloat16):
            raise ValueError(f"int8_conv: res {tuple(res.shape)} "
                             f"{res.dtype} does not fit x")
    if wdq is not None:
        if mode != "none" or k != 3 or tuple(wdq.shape) != (1, cin, cout) \
                or wdq.dtype != torch.int8 or swd is None:
            raise ValueError("int8_conv: the second 1x1 output takes mode "
                             "none, a 3^3 conv and int8 wdq [1, Cin, Cout] "
                             "with swd")
    devs = {t.device for t in (x, occ, wq, sw, A, Bc, inv, res, Ar, Br, wdq,
                               swd) if t is not None}
    if len(devs) != 1:
        raise ValueError("int8_conv: tensors on different devices")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _cdiv(a: int, d: int) -> int:
    return -(-a // d)


def conflict_free(ys: int, xs: int) -> bool:
    """Whether the 8 rows of each ldmatrix phase of a fragment (rows 0-7
    and 8-15, row = (ix * fy + iy) * fz + iz) fall in distinct 16-byte
    bank groups: their halo positions ix * xs + iy * ys + iz are distinct
    mod 8 (a shift by a tap or a fragment origin keeps that)."""
    fx, fy, fz = FRAG
    pos = [ix * xs + iy * ys + iz for ix in range(fx) for iy in range(fy)
           for iz in range(fz)]
    return all(len({p % 8 for p in pos[m:m + 8]}) == 8 for m in (0, 8))


def halo_strides(hy: int, hz: int) -> Tuple[int, int]:
    """(ys, xs): the least y and x strides of a halo position, at least
    hz and hy * ys, that keep the fragment's ldmatrix phases free of bank
    conflicts."""
    for ys in range(hz, hz + 8):
        for xs in range(hy * ys, hy * ys + 8):
            if conflict_free(ys, xs):
                return ys, xs
    raise ValueError(f"no conflict-free halo strides for a {hy}x{hz} halo")


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one call: `tile_frags` FRAG fragments a tile per
    axis, `ys`/`xs`/`npos` the halo's position strides and count, `kcs`
    32-channel chunks a weight stage, `splits` blocks sharing a tile's
    (tap, chunk) stages, `nt` n-tiles of 8 channels a warp (12 or 16),
    `cin_p`/`cout_p` the padded widths, `smem` the block's shared memory,
    `mf` fragments a warp, `groups` channel groups of `coutg` outputs (a
    grid dimension; `cout_p` is one group's padded width)."""

    tile_frags: Tuple[int, int, int]
    ys: int
    xs: int
    npos: int
    kcs: int
    splits: int
    nt: int
    cin_p: int
    cout_p: int
    smem: int
    mf: int = 1
    groups: int = 1
    coutg: int = 0

    @property
    def tile(self) -> Tuple[int, int, int]:
        return tuple(f * g for f, g in zip(FRAG, self.tile_frags))

    def tiles(self, dims) -> int:
        """Tiles of one item's grid."""
        t = self.tile
        return _cdiv(dims[0], t[0]) * _cdiv(dims[1], t[1]) * \
            _cdiv(dims[2], t[2])

    def stat_parts(self, dims) -> int:
        """The kernel's slots of partial sums for the stats of one item:
        one a tile, or, when split, one per 32 cells of the epilogue."""
        if self.splits == 1:
            return self.tiles(dims)
        return _cdiv(dims[0] * dims[1] * dims[2], 32)

    def args(self):
        """The kernel's plan array."""
        return (ctypes.c_int * 12)(*self.tile_frags, self.ys, self.xs,
                                    self.npos, self.kcs, self.splits,
                                    self.nt, self.mf, self.groups,
                                    self.coutg)


def smem_bytes(cin_p, cout_p, npos, kcs, cells, nfrag, prologue,
               out_f32=False) -> int:
    """The kernel's shared memory (its smem_layout): halo, weight ring (or,
    after the main loop, the tile's staged output rows where larger),
    prologue constants, tile occupancy and live flags."""
    staged = cells * (_round_up(cout_p * (4 if out_f32 else 2), 16) + 16)
    return (cin_p * npos + max(STAGES * kcs * cout_p * 32, staged)
            + (5 * cin_p * 4 if prologue else 0)
            + _round_up(cells, 16) + _round_up(nfrag, 16))


@functools.lru_cache(maxsize=None)
def plan(b: int, dims: Tuple[int, int, int], cin: int, cout: int, k: int,
         mode: str = "none", mf: Optional[int] = None,
         out_f32: bool = False) -> Plan:
    """The launch shape of one call on a [b, *dims, cin] grid: above 384
    outputs, channel groups of at most GROUP_COUT (a grid dimension), each
    planned as a conv of that width; the output channels a warp (16
    n-tiles of 8, or 12 at Cout <= 96 and where 16 do not split Cout over
    a divisor of the 8 warps, as at 384; every channel of the group in the
    block); the fragments a warp (`mf`, default as FRAGS_PER_WARP's note
    says); the tile, among the splits of the block's fragments over x, y,
    z, that computes and loads the fewest cells over the grid (ragged
    tiles and halos counted) and fits the shared memory; weight stages of
    at most STAGE_BYTES; and where the grid has fewer blocks than the card
    has SMs, a split of each tile's stages over blocks (see
    MIN_SPLIT_STAGES). Raises a ValueError naming the shape where no tile
    of at least MIN_FRAGS fragments fits, or the integer sums could pass
    int32."""
    shape = f"{cin}->{cout} k={k} on {tuple(dims)}"
    if 127 * 127 * k ** 3 * _round_up(cin, 32) >= 2 ** 31:
        raise ValueError(f"int8_conv kernel: {shape} could overflow its "
                         f"int32 sums")
    groups = 1 if cout <= 384 else _cdiv(cout, GROUP_COUT)
    coutg = _round_up(_cdiv(cout, groups), 2)
    if coutg <= 96:
        cout_p, nt = 96, 12
    else:
        cout_p, nt = _round_up(coutg, 128), 16
        if WARPS % (cout_p // (8 * nt)):
            cout_p, nt = _round_up(coutg, 96), 12
    nr = cout_p // (8 * nt)
    if WARPS % nr:
        raise ValueError(f"int8_conv kernel: Cout {cout} is too wide")
    if mf is None:  # the default, or one fragment a warp where the
        # default's tile does not fit
        try:
            return plan(b, dims, cin, cout, k, mode,
                        2 if coutg > 96 and k == 3 else 1, out_f32)
        except ValueError:
            mf = 1
    nfrag = WARPS // nr * mf
    if nfrag < MIN_FRAGS:
        raise ValueError(f"int8_conv kernel: {shape}: {nfrag} fragment "
                         f"tiles are below MIN_FRAGS")
    cin_p = _round_up(cin, 32)
    nkc = cin_p // 32
    best = None
    for kcs in range(max(1, min(nkc, STAGE_BYTES // (cout_p * 32))), 0, -1):
        for g in itertools.product(range(1, nfrag + 1), repeat=3):
            if g[0] * g[1] * g[2] != nfrag:
                continue
            tile = [f * n for f, n in zip(FRAG, g)]
            hx, hy, hz = (t + k - 1 for t in tile)
            ys, xs = halo_strides(hy, hz)
            npos = (hx - 1) * xs + (hy - 1) * ys + hz
            smem = smem_bytes(cin_p, cout_p, npos, kcs, nfrag * 16, nfrag,
                              mode != "none", out_f32)
            if smem > SMEM_BYTES:
                continue
            ntiles = 1
            for d, t in zip(dims, tile):
                ntiles *= _cdiv(d, t)
            cost = ntiles * (nfrag * 16 + hx * hy * hz)
            if best is None or cost < best[0]:
                best = (cost, g, ys, xs, npos, smem, ntiles, kcs)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"int8_conv kernel: no tile of {nfrag} fragments "
                         f"fits {shape}")
    _, g, ys, xs, npos, smem, ntiles, kcs = best
    stages = k ** 3 * _cdiv(nkc, kcs)
    splits = 1
    blocks = b * ntiles * groups
    if blocks < SMS:
        splits = max(1, min(MAX_SPLITS, stages // MIN_SPLIT_STAGES,
                            _cdiv(SMS, blocks)))
    return Plan(g, ys, xs, npos, kcs, splits, nt, cin_p, cout_p, smem, mf,
                groups, coutg)


def live_fragment_share(occ) -> float:
    """The share of the kernel's fragments (FRAG, laid from the grid's
    origin) that hold an occupied cell of occ [B, X, Y, Z, 1]: its unit of
    work."""
    o = occ[..., 0] > 0.5
    b = o.shape[0]
    fx, fy, fz = FRAG
    pads = [_round_up(d, f) for d, f in zip(o.shape[1:], FRAG)]
    full = torch.zeros((b, *pads), dtype=torch.bool, device=o.device)
    full[:, :o.shape[1], :o.shape[2], :o.shape[3]] = o
    f = full.view(b, pads[0] // fx, fx, pads[1] // fy, fy, pads[2] // fz,
                  fz)
    return float(f.any(dim=6).any(dim=4).any(dim=2).float().mean())


def pack_weights(wq, cin_p: int, cout_p: int, coutg: int = 0):
    """int8 [K, Cin, Cout] -> the kernel's B fragments, int32 [K, CinP/32,
    CoutP/16, 32, 4], zero padded: word j of lane l = 4 * gid + tig holds,
    for n-tile 2 * n16 + j // 2 and output column 8 * that + gid, the input
    channels 32 * k32 + 16 * (j % 2) + 4 * tig + (0..3) in bytes 0..3
    (mma.m16n8k32's b0 / b1). With `coutg`, each group of `coutg` outputs
    packed so, one after the other: [groups, K, CinP/32, CoutP/16, 32,
    4]."""
    if coutg and coutg < wq.shape[2]:
        return torch.stack([pack_weights(wq[..., c0:c0 + coutg], cin_p,
                                         cout_p)
                            for c0 in range(0, wq.shape[2], coutg)])
    k, cin, cout = wq.shape
    wp = torch.zeros((k, cin_p, cout_p), dtype=torch.int8, device=wq.device)
    wp[:, :cin, :cout] = wq
    v = wp.view(k, cin_p // 32, 2, 4, 4, cout_p // 16, 2, 8)
    # dims: tap, k32, which (b0/b1), tig, byte, n16, n-tile in pair, gid
    words = v.permute(0, 1, 5, 7, 3, 6, 2, 4).contiguous()
    return words.view(torch.int32).view(k, cin_p // 32, cout_p // 16, 32, 4)


def unpack_weights(words, cin: int, cout: int):
    """The inverse of `pack_weights`: int8 [K, Cin, Cout]."""
    k, kc, n16 = words.shape[:3]
    v = words.contiguous().view(torch.int8).view(k, kc, n16, 8, 4, 2, 2, 4)
    wp = v.permute(0, 1, 6, 4, 7, 2, 5, 3).reshape(k, kc * 32, n16 * 16)
    return wp[:, :cin, :cout]


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("int8_conv")
        lib.int8_conv.argtypes = ([ctypes.c_void_p] * 19
                                  + [ctypes.c_int] * 12
                                  + [ctypes.c_void_p] * 2)
        lib.int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib.int8_conv


def int8_conv(x, occ, wq, sw, mode="none", *, A=None, Bc=None, inv=None,
              res=None, Ar=None, Br=None, wdq=None, swd=None,
              out_dtype=torch.bfloat16, stats=False) -> Int8ConvOut:
    """x int8 (mode none) or bf16 [B, X, Y, Z, Cin], occ f32 0/1
    [B, X, Y, Z, 1], wq int8 [k^3, Cin, Cout] (k 1 or 3, cube ravel), sw
    f32 [Cout]; A, Bc, Ar, Br f32 [B, Cin] and inv f32 [Cin] for the
    prologues; res [B, X, Y, Z, Cin] int8 or bf16 (join)."""
    _check(x, occ, wq, sw, mode, A, Bc, inv, res, Ar, Br, wdq, swd,
           out_dtype)
    kw = dict(A=A, Bc=Bc, inv=inv, res=res, Ar=Ar, Br=Br, wdq=wdq, swd=swd,
              out_dtype=out_dtype, stats=stats)
    if x.device.type == "cpu":
        return int8_conv_plain(x, occ, wq, sw, mode, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if mode != "none" and x.dtype != torch.bfloat16:
        raise TypeError(f"int8_conv kernel takes a bf16 x in mode {mode}, "
                        f"got {x.dtype}")
    b, gx, gy, gz, cin = x.shape
    kvol, _, cout = wq.shape
    if cin % 16 or cout % 2:
        raise ValueError(f"int8_conv kernel needs Cin % 16 == 0 and Cout % 2 "
                         f"== 0, got {cin}, {cout}")
    if not (x.is_contiguous() and (res is None or res.is_contiguous())
            and x.data_ptr() % 16 == 0
            and (res is None or res.data_ptr() % 16 == 0)):
        raise ValueError("int8_conv kernel wants contiguous, aligned grids")
    dev = x.device
    k = round(kvol ** (1.0 / 3.0))
    p = plan(b, (gx, gy, gz), cin, cout, k, mode,
             out_f32=out_dtype == torch.float32)

    def f32(t):
        return None if t is None else t.float().contiguous()

    w = pack_weights(wq, p.cin_p, p.cout_p, p.coutg)
    wd = None if wdq is None else pack_weights(wdq, p.cin_p, p.cout_p,
                                               p.coutg)
    occ_c = occ.float().contiguous()
    grid = (b, gx, gy, gz)
    out = torch.empty(grid + (cout,), dtype=out_dtype, device=dev)
    out2 = None if wdq is None else torch.empty(
        grid + (cout,), dtype=torch.bfloat16, device=dev)
    yq = None if mode != "join" else torch.empty(
        grid + (cin,), dtype=torch.int8, device=dev)
    nstats = 2 if wdq is None else 4
    st = None if not stats else torch.zeros(
        (b, nstats, cout), dtype=torch.float32, device=dev)
    consts = [f32(t) for t in (sw, swd, A, Bc, Ar, Br, inv)]
    if out.numel() == 0:
        return Int8ConvOut(out, out2, yq, st)
    parts = part = part2 = None
    if stats:  # the kernel's per-tile sums, reduced in a fixed order
        parts = torch.empty((b * p.stat_parts((gx, gy, gz)), nstats, cout),
                            dtype=torch.float32, device=dev)
    if p.splits > 1:  # int32 partial sums, added by every split
        cells = b * gx * gy * gz
        part = torch.zeros((cells, p.groups * p.cout_p), dtype=torch.int32,
                           device=dev)
        if wdq is not None:
            part2 = torch.zeros_like(part)

    def ptr(t):
        return None if t is None else t.data_ptr()

    cuda_build.call(
        _kernel(), dev, "int8_conv", x.data_ptr(), ptr(res),
        occ_c.data_ptr(), w.data_ptr(), ptr(consts[0]), ptr(wd),
        ptr(consts[1]), ptr(consts[2]), ptr(consts[3]), ptr(consts[4]),
        ptr(consts[5]), ptr(consts[6]), out.data_ptr(), ptr(out2), ptr(yq),
        ptr(st), ptr(parts), ptr(part), ptr(part2), b, gx, gy, gz, cin, cout, p.cin_p,
        p.cout_p, k, _MODE_ID[mode],
        int(res is not None and res.dtype == torch.int8),
        int(out_dtype == torch.float32), p.args())
    step = step_of(mode, stats)
    int8_conv.launches += 1
    int8_conv.launches_by_step[step] = \
        int8_conv.launches_by_step.get(step, 0) + 1
    key = ((gx, gy, gz), cin, cout, k, step)
    int8_conv.launches_by_shape[key] = \
        int8_conv.launches_by_shape.get(key, 0) + 1
    return Int8ConvOut(out, out2, yq, st)


int8_conv.launches = 0
int8_conv.launches_by_step = {}  # "conv"/"entry"/"mid"/"junction" -> launches
int8_conv.launches_by_shape = {}  # ((X, Y, Z), Cin, Cout, k, step) -> launches
