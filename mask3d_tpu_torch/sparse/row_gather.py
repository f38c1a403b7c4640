"""Row gather between dense grids and voxel rows: `csrc/row_gather.cu`.

`row_gather(src, idx, ok)` returns `out[b, t] = src[b, clamp(idx[b, t])]`
where `ok[b, t]`, else 0, in src's dtype. On a CUDA tensor it launches the
hand-written kernel (an f32 and a bf16 variant); on a CPU tensor it runs
`row_gather_plain`, the same function in plain PyTorch.

It is differentiable in src (`RowGather`): the backward is the JAX
package's (`pallas_gather.py:216-222`), an f32 scatter-add of the output
cotangent at idx where ok, in plain PyTorch on both devices. The scatter is
`index_put_(accumulate=True)`, whose CUDA implementation sums in a fixed
order, so a run repeats bitwise. It adds the entries of one index one after
another, so the entries where not ok (zeros) are spread over every row, one
a row in turn, rather than clamped onto one: a run of equal indices as long
as the padding (hundreds of thousands of entries at a building's level 0)
would serialize the scatter.
"""

from __future__ import annotations

import ctypes

import torch

from mask3d_tpu_torch import cuda_build


def row_gather_plain(src, idx, ok):
    """`torch.gather` along the row axis, then zero the rows where ~ok."""
    n, c = src.shape[1], src.shape[2]
    j = idx.long().clamp(0, n - 1)
    rows = torch.gather(src, 1, j[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=src.dtype,
                                                        device=src.device))


def _check(src, idx, ok):
    if src.dim() != 3 or idx.dim() != 2 or ok.shape != idx.shape:
        raise ValueError(
            f"row_gather wants src [B,N,C], idx and ok [B,M]; got "
            f"{tuple(src.shape)}, {tuple(idx.shape)}, {tuple(ok.shape)}")
    if idx.shape[0] != src.shape[0] or src.shape[1] == 0:
        raise ValueError("row_gather: batch mismatch or empty source")
    if idx.dtype != torch.int32 or ok.dtype != torch.bool:
        raise TypeError(f"row_gather wants int32 idx and bool ok, got "
                        f"{idx.dtype} and {ok.dtype}")
    if not (src.device == idx.device == ok.device):
        raise ValueError("row_gather: tensors on different devices")


_lib = None
# dtype -> (C entry point, elements in a 16-byte vector, count key)
_VARIANTS = {torch.float32: ("row_gather_f32", 4, "float32"),
             torch.bfloat16: ("row_gather_bf16", 8, "bfloat16")}


def _kernel(dtype):
    global _lib
    if _lib is None:
        lib = cuda_build.load("row_gather")
        for name, _, _ in _VARIANTS.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return getattr(_lib, _VARIANTS[dtype][0])


def _forward(src, idx, ok):
    """The kernel on a CUDA tensor (counted), the plain version on a CPU
    one."""
    if not cuda_build.use_kernel(src, "row_gather"):
        return row_gather_plain(src, idx, ok)
    if src.dtype not in _VARIANTS:
        raise TypeError(f"row_gather kernel takes float32 or bfloat16, got "
                        f"{src.dtype}")
    if not (src.is_contiguous() and idx.is_contiguous()
            and ok.is_contiguous()):
        raise ValueError("row_gather kernel wants contiguous tensors")
    b, n, c = src.shape
    m = idx.shape[1]
    out = torch.empty((b, m, c), dtype=src.dtype, device=src.device)
    if b * m * c == 0:
        return out
    _, per_vec, key = _VARIANTS[src.dtype]
    vec = int(c % per_vec == 0 and src.data_ptr() % 16 == 0)
    cuda_build.call(_kernel(src.dtype), src.device, "row_gather",
                    src.data_ptr(), idx.data_ptr(), ok.data_ptr(),
                    out.data_ptr(), b, m, n, c, vec)
    row_gather.launches += 1
    row_gather.launches_by_dtype[key] = \
        row_gather.launches_by_dtype.get(key, 0) + 1
    return out


def scatter_add_rows(g, idx, ok, n_rows: int, out=None):
    """f32 [B, n_rows, C]: the rows g[b, t] added at idx[b, t] where
    ok[b, t] (the masking comes first: a zero is added at row t mod n_rows
    where not ok), with a deterministic scatter, into `out` where given (in
    place), else into zeros."""
    b, m, c = g.shape
    if out is None:
        out = torch.zeros((b, n_rows, c), dtype=torch.float32,
                          device=g.device)
    contrib = torch.where(ok[..., None], g.float(), 0.0)
    spread = torch.arange(m, device=g.device) % n_rows
    rows = torch.where(ok, idx.long().clamp(0, n_rows - 1), spread)
    b_idx = torch.arange(b, device=g.device)[:, None].expand_as(idx)
    out.index_put_((b_idx, rows), contrib, accumulate=True)
    return out


class RowGather(torch.autograd.Function):
    """The kernel's forward with the JAX package's scatter-add backward."""

    @staticmethod
    def forward(ctx, src, idx, ok):
        ctx.save_for_backward(idx, ok)
        ctx.src_shape, ctx.src_dtype = src.shape, src.dtype
        return _forward(src, idx, ok)

    # from mask3d_tpu/sparse/pallas_gather.py:216 _bwd
    @staticmethod
    def backward(ctx, g):
        idx, ok = ctx.saved_tensors
        dsrc = scatter_add_rows(g, idx, ok, ctx.src_shape[1])
        return dsrc.to(ctx.src_dtype), None, None


def row_gather(src, idx, ok):
    """src f32 or bf16 [B, N, C], idx i32[B, M], ok bool[B, M] ->
    [B, M, C] in src's dtype."""
    _check(src, idx, ok)
    return RowGather.apply(src, idx, ok)


row_gather.launches = 0
row_gather.launches_by_dtype = {}  # "float32" / "bfloat16" -> launches
