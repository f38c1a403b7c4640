"""Gather-path sparse convolution in bf16: `csrc/sparse_conv.cu`.

`sparse_conv(feats, weight, nbr_idx, nbr_ok)` returns f32
`out[b, p] = sum_k ok[b, p, k] * bf16(feats[b, idx[b, p, k]]) @ bf16(W[k])`
with f32 products and accumulation: the function of the JAX package's
windowed Pallas conv (`sparse/pallas_conv.py`). On a CUDA tensor it
launches the hand-written tensor-core kernel and adds one to
`sparse_conv.launches` and to `sparse_conv.launches_by_shape[(N, K, Cin,
Cout)]`; on a CPU tensor it runs `sparse_conv_plain`, the same arithmetic in
plain PyTorch.

The kernel's launch shape comes from `plan()`, host-side and tested on the
CPU: bf16 rows padded to 16 channels (`bf16_rows`), or, for Cin = 1, the
offsets folded into the reduction depth; the output-channel width of a
block; 64- or 128-row tiles; and a split of each tile's active offsets
over several blocks (split-K) where few tiles would otherwise fill the
card.

It is differentiable in feats and weight (`SparseConv`): the backward is
the JAX package's (`pallas_conv.py:336-368`), one pass per kernel offset
in plain PyTorch on both devices: dF adds g @ W[k]^T at the offset's
neighbour rows where ok (a fixed-order scatter, `row_gather.
scatter_add_rows`), dW[k] = gathered(F)^T g. Both are f32 and, as in
JAX, use the f32 feats and weights, not the bf16-rounded ones of the
forward.

Which levels take it is the model's numerics, not a fallback: the backbone
sends a level here only where `supports(N)` holds (the JAX eligibility
rule); other levels run `ops.sparse_conv` in the model's compute dtype.
The kernel itself takes any N and Cin, and f32 or bf16 feats (a bf16
backbone's rows go in as they are; the output stays f32 and the backbone
casts it back, as the JAX package's `_GatherCtx` does).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mask3d_tpu_torch import cuda_build
from mask3d_tpu_torch.sparse import ops
from mask3d_tpu_torch.sparse.row_gather import scatter_add_rows

# 128-row tiles where a launch has at least this many of them, else 64
WIDE_TILES = 1024
# split-K: a call of R < SPLIT_BELOW rows (B * N) takes ceil(SPLIT_ROWS /
# R) splits, at most MAX_SPLITS and at least three offsets a split. The
# flagship's coarse levels (L3, L4: 6144 and 3072 rows an item) hold a few
# hundred valid rows in that capacity, so only split blocks fill the card.
# These constants and WIDE_TILES come from `tune_sparse_conv.py`, which
# times 64- and 128-row tiles x 1-6 splits at the flagship's 16 shapes
# (PERF.md).
SPLIT_BELOW = 65536
SPLIT_ROWS = 3 * 49152
MAX_SPLITS = 6


# from mask3d_tpu/sparse/pallas_conv.py:374 supports
def supports(n_rows: int, tile: int = 256, window: int = 1024) -> bool:
    """Whether a level of capacity N runs the bf16 conv: N % tile == 0 and
    N >= window."""
    return n_rows % tile == 0 and n_rows >= window


def sparse_conv_plain(feats, weight, nbr_idx, nbr_ok):
    """bf16-round feats and weight, then the fp32 gather-matmul conv."""
    return ops.sparse_conv(feats.to(torch.bfloat16).float(),
                           weight.to(torch.bfloat16).float(), nbr_idx, nbr_ok)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one call. `depth`: channels of a bf16 row (Cin
    padded to 16) or, folded, the offsets padded to 16; `tn`: output
    channels a block (Cout padded to `cout_pad`, a multiple of it); `warps`:
    16-row m-fragments a block; `splits`: blocks sharing a tile's active
    offsets."""

    folded: bool
    depth: int
    tn: int
    cout_pad: int
    warps: int
    splits: int

    @property
    def tile_rows(self) -> int:
        return 16 * self.warps


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, k: int, cin: int, cout: int) -> Plan:
    """The launch shape of one call (see the module docstring)."""
    folded = cin == 1
    depth = _round_up(k if folded else cin, 16)
    tn = next((t for t in (32, 64, 96) if cout <= t), 128)
    cout_pad = _round_up(cout, tn)
    rows = b * n
    warps = 8 if -(-rows // 128) * (cout_pad // tn) >= WIDE_TILES else 4
    splits = 1
    if not folded and rows < SPLIT_BELOW:
        splits = max(1, min(MAX_SPLITS, k // 3, -(-SPLIT_ROWS // rows)))
    return Plan(folded, depth, tn, cout_pad, warps, splits)


def bf16_rows(feats, depth: int):
    """f32 or bf16 [B, N, Cin] -> contiguous bf16 [B, N, depth], zero past
    Cin."""
    x = feats.to(torch.bfloat16)
    if depth != x.shape[-1]:
        x = F.pad(x, (0, depth - x.shape[-1]))
    return x.contiguous()


def bf16_weights(weight, p: Plan):
    """[K, Cin, Cout] -> bf16 [K, depth, cout_pad] (folded: [depth,
    cout_pad]), zero padded."""
    k, cin, cout = weight.shape
    w = weight.to(torch.bfloat16)
    if p.folded:
        w = w.reshape(k, cout)
        return F.pad(w, (0, p.cout_pad - cout, 0, p.depth - k)).contiguous()
    return F.pad(w, (0, p.cout_pad - cout, 0, p.depth - cin)).contiguous()


def _check(feats, weight, nbr_idx, nbr_ok):
    if feats.dim() != 3 or weight.dim() != 3 or nbr_idx.dim() != 3:
        raise ValueError(
            f"sparse_conv wants feats [B,N,Cin], weight [K,Cin,Cout], "
            f"nbr_idx/nbr_ok [B,N,K]; got {tuple(feats.shape)}, "
            f"{tuple(weight.shape)}, {tuple(nbr_idx.shape)}")
    b, n, cin = feats.shape
    k = weight.shape[0]
    if weight.shape[1] != cin or tuple(nbr_idx.shape) != (b, n, k) \
            or nbr_ok.shape != nbr_idx.shape or n == 0:
        raise ValueError(
            f"sparse_conv: shapes do not agree: feats {tuple(feats.shape)}, "
            f"weight {tuple(weight.shape)}, nbr_idx {tuple(nbr_idx.shape)}, "
            f"nbr_ok {tuple(nbr_ok.shape)}")
    if nbr_idx.dtype != torch.int32 or nbr_ok.dtype != torch.bool:
        raise TypeError(f"sparse_conv wants int32 nbr_idx and bool nbr_ok, "
                        f"got {nbr_idx.dtype} and {nbr_ok.dtype}")
    if not (feats.device == weight.device == nbr_idx.device
            == nbr_ok.device):
        raise ValueError("sparse_conv: tensors on different devices")


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("sparse_conv")
        lib.sparse_conv_bf16.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
            + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.sparse_conv_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib.sparse_conv_bf16


def _aligned(t):
    """t itself, or a copy where its data is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(feats, weight, nbr_idx, nbr_ok):
    """The kernel on a CUDA tensor (counted), the plain version on a CPU
    one."""
    if not cuda_build.use_kernel(feats, "sparse_conv"):
        return sparse_conv_plain(feats, weight, nbr_idx, nbr_ok)
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sparse_conv kernel takes float32 or bfloat16 "
                        f"feats, got {feats.dtype}")
    if weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sparse_conv kernel takes float32 or bfloat16 "
                        f"weights, got {weight.dtype}")
    if not (feats.is_contiguous() and nbr_idx.is_contiguous()
            and nbr_ok.is_contiguous()):
        raise ValueError("sparse_conv kernel wants contiguous tensors")
    b, n, cin = feats.shape
    k, _, cout = weight.shape
    if k > 255:
        raise ValueError(f"sparse_conv kernel takes at most 255 offsets, "
                         f"got {k}")
    out = torch.empty((b, n, cout), dtype=torch.float32, device=feats.device)
    if b * cout == 0:
        return out
    p = plan(b, n, k, cin, cout)
    rows16 = bf16_rows(feats, 1 if p.folded else p.depth)
    w16 = bf16_weights(weight, p)
    idx, ok = _aligned(nbr_idx), _aligned(nbr_ok)
    part = live = None
    if p.splits > 1:
        # touched only for tiles with an ok row
        part = torch.empty((p.splits, b * n, cout), dtype=torch.float32,
                           device=feats.device)
        live = torch.empty(-(-b * n // p.tile_rows), dtype=torch.int32,
                           device=feats.device)
    cuda_build.call(
        _kernel(), feats.device, "sparse_conv", rows16.data_ptr(),
        w16.data_ptr(), idx.data_ptr(), ok.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(),
        0 if live is None else live.data_ptr(), b * n, n, k, p.depth,
        p.cout_pad, cout, p.tn, p.warps, p.splits, int(p.folded))
    sparse_conv.launches += 1
    key = (n, k, cin, cout)
    sparse_conv.launches_by_shape[key] = \
        sparse_conv.launches_by_shape.get(key, 0) + 1
    return out


# from mask3d_tpu/sparse/pallas_conv.py:336 _bwd
def sparse_conv_backward(feats, weight, nbr_idx, nbr_ok, g,
                         needs=(True, True)):
    """(dF, dW) for the output cotangent g [B, N, Cout], f32 and cast to
    feats' and weight's dtypes; None where `needs` is false."""
    b, n, _ = feats.shape
    g = g.float()
    f32, w32 = feats.float(), weight.float()
    df = torch.zeros_like(f32) if needs[0] else None
    dw = torch.empty_like(w32) if needs[1] else None
    for k in range(weight.shape[0]):
        idx_k, ok_k = nbr_idx[..., k], nbr_ok[..., k]
        if df is not None:
            scatter_add_rows(g @ w32[k].t(), idx_k, ok_k, n, out=df)
        if dw is not None:
            gath = ops.gather_rows(f32, idx_k, ok_k)
            dw[k] = torch.einsum("bnc,bnd->cd", gath, g)
    return (None if df is None else df.to(feats.dtype),
            None if dw is None else dw.to(weight.dtype))


class SparseConv(torch.autograd.Function):
    """The kernel's forward with the JAX package's per-offset backward."""

    @staticmethod
    def forward(ctx, feats, weight, nbr_idx, nbr_ok):
        ctx.save_for_backward(feats, weight, nbr_idx, nbr_ok)
        return _forward(feats, weight, nbr_idx, nbr_ok)

    @staticmethod
    def backward(ctx, g):
        feats, weight, nbr_idx, nbr_ok = ctx.saved_tensors
        df, dw = sparse_conv_backward(feats, weight, nbr_idx, nbr_ok, g,
                                      ctx.needs_input_grad[:2])
        return df, dw, None, None


def sparse_conv(feats, weight, nbr_idx, nbr_ok):
    """feats [B, N, Cin] and weight [K, Cin, Cout] (f32 or bf16),
    nbr_idx i32 / nbr_ok bool [B, N, K] -> f32[B, N, Cout]."""
    _check(feats, weight, nbr_idx, nbr_ok)
    return SparseConv.apply(feats, weight, nbr_idx, nbr_ok)


sparse_conv.launches = 0
sparse_conv.launches_by_shape = {}  # (N, K, Cin, Cout) -> launches
