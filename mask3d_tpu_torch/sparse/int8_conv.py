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
output after its cast ([B, 2 or 4, Cout]).

On a CUDA tensor it launches the hand-written kernel and adds one to
`int8_conv.launches`, to `int8_conv.launches_by_step[step]` and to
`int8_conv.launches_by_shape[((X, Y, Z), Cin, Cout, k, step)]`, where the
step is "conv" (mode none, no stats), "entry" (mode none with stats),
"mid" (affine) or "junction" (join). On a CPU tensor it runs
`int8_conv_plain`, the same arithmetic in plain PyTorch: the integer conv
as a float64 `F.conv3d` of the integer values, which is exact
(|acc| <= 127^2 * 27 * 384 < 2^28, far inside float64's 2^53).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mask3d_tpu_torch import cuda_build

MODES = ("none", "affine", "join")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
_LANE_TILE = 32  # the kernel's channel stage and output-channel tile


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


def _conv_exact(q, wq):
    """Integer conv of int8 q [B, X, Y, Z, Cin] with int8 wq [k^3, Cin,
    Cout] (cube ravel), as float64 [B, X, Y, Z, Cout] integer values."""
    k = round(wq.shape[0] ** (1.0 / 3.0))
    cin, cout = wq.shape[1], wq.shape[2]
    w = wq.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2).double()
    acc = F.conv3d(q.double().permute(0, 4, 1, 2, 3), w, padding=k // 2)
    # exact in any summation order; round guards against an algorithm
    # that is not (an FFT conv errs far below 0.5)
    return torch.round(acc).permute(0, 2, 3, 4, 1)


def _requant(acc, sw, occ, dtype):
    return (acc.float() * sw * occ).to(dtype)


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
    out = _requant(_conv_exact(q, wq), sw, occ, out_dtype)
    out2 = None
    if wdq is not None:
        out2 = _requant(_conv_exact(q, wdq), swd, occ, torch.bfloat16)
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


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("int8_conv")
        lib.int8_conv.argtypes = ([ctypes.c_void_p] * 16
                                  + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib.int8_conv


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_weights(wq, cin_p: int, cout_p: int):
    """int8 [K, Cin, Cout] -> the kernel's int32 [K, CinP/4, CoutP]: words
    of 4 consecutive input channels (channel 4g + j in byte j), zero
    padded to CinP and CoutP."""
    k, cin, cout = wq.shape
    wp = torch.zeros((k, cin_p, cout_p), dtype=torch.int8, device=wq.device)
    wp[:, :cin, :cout] = wq
    words = wp.view(k, cin_p // 4, 4, cout_p).permute(0, 1, 3, 2)
    return words.contiguous().view(torch.int32).view(k, cin_p // 4, cout_p)


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
    if cin % 4:
        raise ValueError(f"int8_conv kernel needs Cin % 4 == 0, got {cin}")
    if not (x.is_contiguous() and (res is None or res.is_contiguous())
            and x.data_ptr() % 16 == 0):
        raise ValueError("int8_conv kernel wants contiguous, aligned grids")
    dev = x.device
    cin_p, cout_p = _round_up(cin, _LANE_TILE), _round_up(cout, _LANE_TILE)

    def f32(t):
        return None if t is None else t.float().contiguous()

    w = pack_weights(wq, cin_p, cout_p)
    wd = None if wdq is None else pack_weights(wdq, cin_p, cout_p)
    occ_c = occ.float().contiguous()
    grid = (b, gx, gy, gz)
    out = torch.empty(grid + (cout,), dtype=out_dtype, device=dev)
    out2 = None if wdq is None else torch.empty(
        grid + (cout,), dtype=torch.bfloat16, device=dev)
    yq = None if mode != "join" else torch.empty(
        grid + (cin,), dtype=torch.int8, device=dev)
    st = None if not stats else torch.zeros(
        (b, 2 if wdq is None else 4, cout), dtype=torch.float32, device=dev)
    consts = [f32(t) for t in (sw, swd, A, Bc, Ar, Br, inv)]
    if out.numel() == 0:
        return Int8ConvOut(out, out2, yq, st)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    k = round(kvol ** (1.0 / 3.0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(fn(
            x.data_ptr(), ptr(res), occ_c.data_ptr(), w.data_ptr(),
            ptr(consts[0]), ptr(wd), ptr(consts[1]), ptr(consts[2]),
            ptr(consts[3]), ptr(consts[4]), ptr(consts[5]), ptr(consts[6]),
            out.data_ptr(), ptr(out2), ptr(yq), ptr(st), b, gx, gy, gz, cin,
            cout, cin_p, cout_p, k, _MODE_ID[mode],
            int(res is not None and res.dtype == torch.int8),
            int(out_dtype == torch.float32), stream), "int8_conv")
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
