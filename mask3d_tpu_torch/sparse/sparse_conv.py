"""Gather-path sparse convolution in bf16: `csrc/sparse_conv.cu`.

`sparse_conv(feats, weight, nbr_idx, nbr_ok)` returns f32
`out[b, p] = sum_k ok[b, p, k] * bf16(feats[b, idx[b, p, k]]) @ bf16(W[k])`
with f32 products and accumulation: the function of the JAX package's
windowed Pallas conv (`sparse/pallas_conv.py`). On a CUDA tensor it
launches the hand-written kernel and adds one to `sparse_conv.launches`
and to `sparse_conv.launches_by_shape[(N, K, Cin, Cout)]`; on a CPU tensor
it runs `sparse_conv_plain`, the same arithmetic in plain PyTorch.

Which levels take it is the model's numerics, not a fallback: the backbone
sends a level here only where `supports(N)` holds (the JAX eligibility
rule); other levels run the fp32 `ops.sparse_conv`. The kernel itself takes
any N and Cin.
"""

from __future__ import annotations

import ctypes

import torch

from mask3d_tpu_torch import cuda_build
from mask3d_tpu_torch.sparse import ops


# from mask3d_tpu/sparse/pallas_conv.py:374 supports
def supports(n_rows: int, tile: int = 256, window: int = 1024) -> bool:
    """Whether a level of capacity N runs the bf16 conv: N % tile == 0 and
    N >= window."""
    return n_rows % tile == 0 and n_rows >= window


def sparse_conv_plain(feats, weight, nbr_idx, nbr_ok):
    """bf16-round feats and weight, then the fp32 gather-matmul conv."""
    return ops.sparse_conv(feats.to(torch.bfloat16).float(),
                           weight.to(torch.bfloat16).float(), nbr_idx, nbr_ok)


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
        lib.sparse_conv_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.sparse_conv_f32.restype = ctypes.c_int
        _lib = lib
    return _lib.sparse_conv_f32


def sparse_conv(feats, weight, nbr_idx, nbr_ok):
    """feats f32[B, N, Cin], weight [K, Cin, Cout] (f32 or bf16),
    nbr_idx i32 / nbr_ok bool [B, N, K] -> f32[B, N, Cout]."""
    _check(feats, weight, nbr_idx, nbr_ok)
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, weight, nbr_idx, nbr_ok)
    if feats.device.type != "cuda":
        raise ValueError(f"sparse_conv: unsupported device {feats.device}")
    if feats.dtype != torch.float32:
        raise TypeError(f"sparse_conv kernel takes float32 feats, got "
                        f"{feats.dtype}")
    if weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sparse_conv kernel takes float32 or bfloat16 "
                        f"weights, got {weight.dtype}")
    if not (feats.is_contiguous() and nbr_idx.is_contiguous()
            and nbr_ok.is_contiguous()):
        raise ValueError("sparse_conv kernel wants contiguous tensors")
    b, n, cin = feats.shape
    k, _, cout = weight.shape
    w16 = weight.to(torch.bfloat16).contiguous()
    out = torch.empty((b, n, cout), dtype=torch.float32, device=feats.device)
    if b * cout == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        cuda_build.check(fn(feats.data_ptr(), w16.data_ptr(),
                            nbr_idx.data_ptr(), nbr_ok.data_ptr(),
                            out.data_ptr(), b, n, k, cin, cout, stream),
                         "sparse_conv")
    sparse_conv.launches += 1
    key = (n, k, cin, cout)
    sparse_conv.launches_by_shape[key] = \
        sparse_conv.launches_by_shape.get(key, 0) + 1
    return out


sparse_conv.launches = 0
sparse_conv.launches_by_shape = {}  # (N, K, Cin, Cout) -> launches
