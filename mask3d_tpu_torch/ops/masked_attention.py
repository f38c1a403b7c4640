"""Masked multi-head cross-attention: `csrc/masked_attention.cu`.

`masked_cross_attention(q, k, v, mask, num_heads)` takes the JAX layout:
q [B, Q, D], k and v [B, S, D], mask [B, Q, S] bool or uint8 (True or
nonzero = blocked), and returns softmax(q k^T / sqrt(hd), blocked -> -1e9) v
as [B, Q, D]. A row with every key blocked gets uniform weights. On a CUDA
tensor it launches the hand-written kernel and adds one to
`masked_cross_attention.launches` and to
`masked_cross_attention.launches_by_shape[S]` (the key length); on a CPU
tensor it runs `masked_cross_attention_plain`, the one-shot softmax in
plain PyTorch.

`masked_cross_attention_partial` is the same kernel over one sequence-
parallel rank's chunk of the keys: beside the normalized output it returns
each (item, head, query)'s max logit and sum of exponentials, and
`combine_partial_softmax` merges the ranks' triples into the softmax over
every key (`models/mask3d.py` runs the decoder's rows sharded over `sp` at
inference). Its launches count in `masked_cross_attention.launches` and in
`masked_cross_attention.partial_by_shape[S]`; it has no gradient (the
sharded decoder runs at inference only).

It is differentiable in q, k and v (`MaskedCrossAttention`): the forward
is the kernel (or the plain version on the CPU), the backward the VJP of
the plain one-shot form, recomputed from the saved inputs, as the JAX
package's `custom_vjp` takes the VJP of its XLA form
(`pallas_attention.py:155-170`). The backward is plain PyTorch on both
devices.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mask3d_tpu_torch import cuda_build

KERNEL_HEAD_DIMS = (8, 16, 32)
KEYS_PER_SLICE = 16  # keys of a tile each thread takes (the kernel's)
STAGES = 3  # the kernel's shared-memory ring depth
MAX_THREADS = 256  # the kernel's launch bound
# queries a thread by head dim (the kernel's templates; 4 ran 25% faster
# than 2 at the flagship, tune_attention.py in PERF.md; 1 at hd 32, where
# the registers would not hold more)
QUERIES_PER_THREAD = {8: 4, 16: 4, 32: 1}
SMEM_BYTES = 232448  # shared memory a block can use on the H100
SMS = 132  # streaming multiprocessors of the H100
BLOCKS_PER_SM = 1  # the grid the chunk count aims at: one block an SM
# (tune_attention.py: more, smaller chunks were slower at every S)


# from mask3d_tpu/ops/pallas_attention.py:80 _xla_reference
def masked_cross_attention_plain(q, k, v, mask, num_heads: int):
    """One-shot masked softmax in f32 with the -1e9 fill."""
    b, nq, d = q.shape
    hd = d // num_heads

    def split(x):
        return x.reshape(x.shape[0], x.shape[1], num_heads, hd)

    logits = torch.einsum(
        "bqhd,bkhd->bhqk", split(q).float(), split(k).float()
    ) / (hd ** 0.5)
    logits = logits.masked_fill(mask.bool()[:, None], -1e9)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, split(v).float())
    return out.reshape(b, nq, d).to(q.dtype)


# the partial form: the same softmax over one chunk of the keys
def masked_cross_attention_partial_plain(q, k, v, mask, num_heads: int):
    """(out f32[B, Q, D] normalized over this chunk's keys, max f32[B, H,
    Q] of the logits with the -1e9 fill, sum f32[B, H, Q] of exp(logit -
    max)). A chunk without keys gives out 0, max -1e9 and sum 0."""
    b, nq, d = q.shape
    hd = d // num_heads
    s = k.shape[1]
    if s == 0:
        return (torch.zeros_like(q, dtype=torch.float32),
                q.new_full((b, num_heads, nq), -1e9, dtype=torch.float32),
                q.new_zeros((b, num_heads, nq), dtype=torch.float32))

    def split(x):
        return x.reshape(x.shape[0], x.shape[1], num_heads, hd)

    logits = torch.einsum(
        "bqhd,bkhd->bhqk", split(q).float(), split(k).float()
    ) / (hd ** 0.5)
    logits = logits.masked_fill(mask.bool()[:, None], -1e9)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    lsum = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, split(v).float())
    out = out / lsum.transpose(1, 2)[..., None]
    return out.reshape(b, nq, d), m, lsum


def combine_partial_softmax(outs, maxes, sums, num_heads: int):
    """The softmax over every key from the ranks' partial triples (lists in
    rank order of out [B, Q, D], max and sum [B, H, Q]): each rank's
    normalized output weighted by sum * exp(max - the ranks' max)."""
    b, nq, d = outs[0].shape
    hd = d // num_heads
    m = torch.stack(maxes)  # [R, B, H, Q]
    w = torch.stack(sums) * torch.exp(m - m.amax(dim=0, keepdim=True))
    o = torch.stack(outs).reshape(len(outs), b, nq, num_heads, hd)
    w = w.permute(0, 1, 3, 2)[..., None]  # [R, B, Q, H, 1]
    out = (o * w).sum(dim=0) / w.sum(dim=0).clamp_min(1e-20)
    return out.reshape(b, nq, d)


def _check(q, k, v, mask, num_heads):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"masked_cross_attention wants q [B,Q,D], k and v [B,S,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, nq, d = q.shape
    if k.shape[0] != b or k.shape[2] != d or d % num_heads:
        raise ValueError("masked_cross_attention: shape mismatch")
    if tuple(mask.shape) != (b, nq, k.shape[1]):
        raise ValueError(f"mask must be [B,Q,S], got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("masked_cross_attention: tensors on different "
                         "devices")


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one call: `ksl` key slices a (head, `queries`
    queries) group of lanes (adjacent lanes; tiles of 16 * ksl keys), `hg`
    heads a block, `threads` a block, `chunk` keys a block (whole tiles)
    and `nch` chunks an item."""

    ksl: int
    hg: int
    threads: int
    chunk: int
    nch: int
    queries: int = 4

    @property
    def tile(self) -> int:
        return KEYS_PER_SLICE * self.ksl


def _cdiv(a: int, d: int) -> int:
    return -(-a // d)


def smem_bytes(tile: int, width: int, nq: int) -> int:
    """Shared memory of a block: the ring of K and V tiles [tile][width +
    4] f32 and the mask tile [nq][tile] u8 (the kernel's stage_bytes)."""
    return STAGES * (2 * tile * (width + 4) * 4 + _cdiv(nq * tile, 16) * 16)


@functools.lru_cache(maxsize=None)
def plan(b: int, nq: int, s: int, num_heads: int, head_dim: int) -> Plan:
    """The launch shape: QUERIES_PER_THREAD[head_dim] queries a thread,
    the most key slices (4, 2, 1) and then the most heads a block (a
    divisor of H) that keep a block within MAX_THREADS threads and the
    shared memory; then chunks of whole tiles so that the
    grid holds about SMS * BLOCKS_PER_SM blocks. Raises where no shape
    fits (Q * 1 thread above MAX_THREADS, or a tile of 16 keys of one head
    beyond the shared memory)."""
    nqt = QUERIES_PER_THREAD[head_dim]
    for ksl in (4, 2, 1):
        tile = KEYS_PER_SLICE * ksl
        for hg in range(num_heads, 0, -1):
            if num_heads % hg:
                continue
            threads = _cdiv(hg * _cdiv(nq, nqt) * ksl, 32) * 32
            if threads <= MAX_THREADS and \
                    smem_bytes(tile, hg * head_dim, nq) <= SMEM_BYTES:
                groups = b * (num_heads // hg)
                tiles = max(1, _cdiv(s, tile))
                want = max(1, min(tiles, SMS * BLOCKS_PER_SM // groups))
                chunk = _cdiv(tiles, want) * tile
                return Plan(ksl, hg, threads, chunk, _cdiv(max(s, 1), chunk),
                            nqt)
    raise ValueError(f"masked_cross_attention kernel: no launch shape fits "
                     f"Q={nq}, H={num_heads}, hd={head_dim}")


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("masked_attention")
        lib.masked_cross_attention_f32.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
            + [ctypes.c_float, ctypes.c_void_p])
        lib.masked_cross_attention_f32.restype = ctypes.c_int
        _lib = lib
    return _lib.masked_cross_attention_f32


def _forward(q, k, v, mask, num_heads: int):
    """The kernel on a CUDA tensor (counted), the plain version on a CPU
    one."""
    if not cuda_build.use_kernel(q, "masked_cross_attention"):
        return masked_cross_attention_plain(q, k, v, mask, num_heads)
    return _launch(q, k, v, mask, num_heads)


def _launch(q, k, v, mask, num_heads: int, partial: bool = False):
    """One launch of the kernel: out, or with `partial` (out, max, sum)."""
    b, nq, d = q.shape
    s = k.shape[1]
    hd = d // num_heads
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError("masked_cross_attention kernel takes float32")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel supports head dims {KERNEL_HEAD_DIMS}, got "
                         f"hd={hd}")
    if not all(t.is_contiguous() for t in (q, k, v, mask)):
        raise ValueError("masked_cross_attention kernel wants contiguous "
                         "tensors")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("masked_cross_attention kernel wants 16-byte "
                         "aligned k and v")
    out = torch.empty_like(q)
    stats = None
    if partial:
        stats = torch.empty((2, b, num_heads, nq), dtype=torch.float32,
                            device=q.device)
    if b * nq * s == 0:
        if partial:  # no keys: out 0, max -1e9, sum 0 (the plain form's)
            return out.zero_(), stats[0].fill_(-1e9), stats[1].zero_()
        return out
    p = plan(b, nq, s, num_heads, hd)
    part_ml = torch.empty((2, b, p.nch, num_heads, nq), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, p.nch, num_heads, nq, hd),
                           dtype=torch.float32, device=q.device)
    m8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    if s % 16:  # the kernel copies mask rows in 16-byte pieces
        m8 = F.pad(m8, (0, 16 - s % 16), value=1)
    elif m8.data_ptr() % 16:
        m8 = m8.clone()
    cuda_build.call(
        _kernel(), q.device, "masked_cross_attention", q.data_ptr(),
        k.data_ptr(), v.data_ptr(), m8.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        None if stats is None else stats[0].data_ptr(),
        None if stats is None else stats[1].data_ptr(), b, nq, s,
        m8.shape[-1], num_heads, hd, p.ksl, p.queries, p.hg, p.threads,
        p.chunk, p.nch, 1.0 / math.sqrt(hd))
    masked_cross_attention.launches += 1
    by_shape = (masked_cross_attention.partial_by_shape if partial
                else masked_cross_attention.launches_by_shape)
    by_shape[s] = by_shape.get(s, 0) + 1
    return (out, stats[0], stats[1]) if partial else out


# from mask3d_tpu/ops/pallas_attention.py:160 _mca_bwd
def masked_cross_attention_backward(q, k, v, mask, num_heads: int, g,
                                    needs=(True, True, True)):
    """(dq, dk, dv) for the output cotangent g: the VJP of
    `masked_cross_attention_plain` at (q, k, v), None where `needs` is
    false."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((q, k, v), needs)]
        out = masked_cross_attention_plain(*leaves, mask, num_heads)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if n else None for n in needs)


class MaskedCrossAttention(torch.autograd.Function):
    """The kernel's forward with the plain form's VJP as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads):
        ctx.save_for_backward(q, k, v, mask)
        ctx.num_heads = num_heads
        return _forward(q, k, v, mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        grads = masked_cross_attention_backward(
            q, k, v, mask, ctx.num_heads, g, ctx.needs_input_grad[:3])
        return (*grads, None, None)


def masked_cross_attention(q, k, v, mask, num_heads: int):
    """q f32[B, Q, D]; k, v f32[B, S, D]; mask [B, Q, S] -> f32[B, Q, D]."""
    _check(q, k, v, mask, num_heads)
    return MaskedCrossAttention.apply(q, k, v, mask, num_heads)


def masked_cross_attention_partial(q, k, v, mask, num_heads: int):
    """The partial form over this rank's keys: q f32[B, Q, D]; k, v f32[B,
    S, D]; mask [B, Q, S] -> (out f32[B, Q, D], max f32[B, H, Q], sum
    f32[B, H, Q]); the kernel on a CUDA tensor, the plain form on a CPU
    one. No gradient."""
    _check(q, k, v, mask, num_heads)
    if not cuda_build.use_kernel(q, "masked_cross_attention"):
        return masked_cross_attention_partial_plain(q, k, v, mask, num_heads)
    return _launch(q, k, v, mask, num_heads, partial=True)


masked_cross_attention.launches = 0
masked_cross_attention.launches_by_shape = {}  # key length S -> launches
# the partial form's launches by its chunk's key length
masked_cross_attention.partial_by_shape = {}
