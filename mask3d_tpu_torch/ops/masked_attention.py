"""Masked multi-head cross-attention: `csrc/masked_attention.cu`.

`masked_cross_attention(q, k, v, mask, num_heads)` takes the JAX layout:
q [B, Q, D], k and v [B, S, D], mask [B, Q, S] bool or uint8 (True or
nonzero = blocked), and returns softmax(q k^T / sqrt(hd), blocked -> -1e9) v
as [B, Q, D]. A row with every key blocked gets uniform weights. On a CUDA
tensor it launches the hand-written kernel; on a CPU tensor it runs
`masked_cross_attention_plain`, the one-shot softmax in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mask3d_tpu_torch import cuda_build

KERNEL_HEAD_DIMS = (8, 16, 32)
_TK = 32  # keys per tile in the kernel
_QG = 32  # queries per block in the kernel
_TARGET_BLOCKS = 528  # 4 blocks per SM of the H100's 132


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


def chunking(b: int, nq: int, s: int):
    """(chunk, n_chunks) of the key axis: enough blocks to fill the card,
    each chunk a whole number of key tiles."""
    def cdiv(a, d):
        return -(-a // d)

    want = max(1, min(cdiv(_TARGET_BLOCKS, b * cdiv(nq, _QG)), cdiv(s, _TK)))
    chunk = cdiv(cdiv(s, want), _TK) * _TK
    return chunk, cdiv(s, chunk)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("masked_attention")
        lib.masked_cross_attention_f32.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.masked_cross_attention_f32.restype = ctypes.c_int
        _lib = lib
    return _lib.masked_cross_attention_f32


def masked_cross_attention(q, k, v, mask, num_heads: int):
    """q f32[B, Q, D]; k, v f32[B, S, D]; mask [B, Q, S] -> f32[B, Q, D]."""
    _check(q, k, v, mask, num_heads)
    if q.device.type == "cpu":
        return masked_cross_attention_plain(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"masked_cross_attention: unsupported device "
                         f"{q.device}")
    b, nq, d = q.shape
    s = k.shape[1]
    hd = d // num_heads
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError("masked_cross_attention kernel takes float32")
    if hd not in KERNEL_HEAD_DIMS or num_heads > 16:
        raise ValueError(f"kernel supports head dims {KERNEL_HEAD_DIMS} and "
                         f"at most 16 heads, got hd={hd}, h={num_heads}")
    if not all(t.is_contiguous() for t in (q, k, v, mask)):
        raise ValueError("masked_cross_attention kernel wants contiguous "
                         "tensors")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("masked_cross_attention kernel wants 16-byte "
                         "aligned k and v")
    out = torch.empty_like(q)
    if b * nq * s == 0:
        return out
    chunk, nch = chunking(b, nq, s)
    part_ml = torch.empty((2, b, nch, num_heads, nq), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, nch, num_heads, nq, hd), dtype=torch.float32,
                           device=q.device)
    m8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        cuda_build.check(
            fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
               part_ml[0].data_ptr(), part_ml[1].data_ptr(),
               part_acc.data_ptr(), out.data_ptr(), b, nq, s, num_heads, hd,
               chunk, nch, 1.0 / math.sqrt(hd), stream),
            "masked_cross_attention")
    masked_cross_attention.launches += 1
    return out


masked_cross_attention.launches = 0
