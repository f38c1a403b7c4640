"""Linear sum assignment (Hungarian matching), batched.

`linear_sum_assignment(cost, method)` solves every problem of a batch of
cost matrices and returns the column of each row on the cost's device:

- `method="device"` (the default, as `matcher.lsap_method` is in the JAX
  package) is the JAX package's Jonker-Volgenant solver (its
  `_solve_square`, vmapped over the problems). On a CUDA tensor it launches
  `csrc/lsap.cu`: one thread block a problem, one thread a column, every
  problem of the batch in one launch, no host round trip. On a CPU tensor
  it runs `solve_square_plain`, the same loop in plain PyTorch, vectorised
  over the problems with a mask for the problems whose search has ended (as
  `vmap` runs a batched `while_loop`). Both return JAX's assignment, ties
  included: the same float32 operations in the same order, the strict
  `r < spc`, and the lowest column on a tied minimum.
- `method="host"` copies the costs to the host and solves each problem with
  scipy (the JAX package's parity oracle). Where the optimum is not unique
  it may pick another assignment than the device method.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment as _scipy_lsa

from mask3d_tpu_torch import cuda_build

# from mask3d_tpu/ops/lsap.py:27 SENT
SENT = 2**31 - 1  # "unassigned"
MAX_N = 1024  # the kernel's threads a block: one a column


def _where(mask, new, old):
    """`new` where the problem's mask is set, else `old` (the batched
    `while_loop`'s select); mask bool[P], tensors [P, ...]."""
    return torch.where(mask.view(-1, *([1] * (old.dim() - 1))), new, old)


# from mask3d_tpu/ops/lsap.py:30 _solve_square
def solve_square_plain(cost: torch.Tensor) -> torch.Tensor:
    """Exact LSAP of P square problems: cost f32[P, n, n] -> col4row
    i32[P, n]. A row at a time, a Dijkstra search for the shortest
    augmenting path from it, the dual update, then the augmentation;
    the problems whose search has ended keep their state. Sets
    `solve_square_plain.steps`: the search steps all problems took (the
    work that this data needs, for a bound)."""
    p, n = cost.shape[0], cost.shape[-1]
    dev = cost.device
    cost = cost.to(torch.float32)
    ar = torch.arange(p, device=dev)
    rows = torch.arange(n, device=dev)[None]
    inf = torch.tensor(float("inf"), device=dev)
    u = torch.zeros((p, n), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    col4row = torch.full((p, n), SENT, dtype=torch.int64, device=dev)
    row4col = torch.full_like(col4row, SENT)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for cur in range(n):
        sr = torch.zeros((p, n), dtype=torch.bool, device=dev)
        sc = torch.zeros_like(sr)
        spc = torch.full((p, n), float("inf"), device=dev)
        path = torch.zeros((p, n), dtype=torch.int64, device=dev)
        i = torch.full((p,), cur, dtype=torch.int64, device=dev)
        sink = torch.full((p,), SENT, dtype=torch.int64, device=dev)
        min_val = torch.zeros((p,), dtype=torch.float32, device=dev)
        while True:
            act = sink == SENT
            if not bool(act.any()):
                break
            steps = steps + act.sum()
            sr_n = sr.clone()
            sr_n[ar, i] = True
            r = ((min_val[:, None] + cost[ar, i]) - u[ar, i][:, None]) - v
            better = ~sc & (r < spc)
            spc_n = torch.where(better, r, spc)
            path_n = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, spc_n)
            j = torch.argmin(masked, dim=1)  # the first of a tied minimum
            mv = masked[ar, j]
            sc_n = sc.clone()
            sc_n[ar, j] = True
            nxt = row4col[ar, j]
            free = nxt == SENT
            sr, sc = _where(act, sr_n, sr), _where(act, sc_n, sc)
            spc, path = _where(act, spc_n, spc), _where(act, path_n, path)
            sink = _where(act, torch.where(free, j, sink), sink)
            i = _where(act, torch.where(free, i, nxt), i)
            min_val = _where(act, mv, min_val)

        # the dual update (scipy's _lsap.c, as JAX's)
        u = u.clone()
        u[:, cur] = u[:, cur] + min_val
        others = sr & (rows != cur)
        safe_col = torch.where(col4row == SENT, 0, col4row)
        u = torch.where(others, (u + min_val[:, None])
                        - torch.gather(spc, 1, safe_col), u)
        v = torch.where(sc, v - (min_val[:, None] - spc), v)

        # augment along the alternating path, from the sink back to `cur`
        j = sink
        done = torch.zeros((p,), dtype=torch.bool, device=dev)
        while not bool(done.all()):
            act = ~done
            i = path[ar, j]
            r4c = row4col.clone()
            r4c[ar, j] = i
            t = col4row[ar, i]
            c4r = col4row.clone()
            c4r[ar, i] = j
            row4col, col4row = _where(act, r4c, row4col), \
                _where(act, c4r, col4row)
            j = _where(act, torch.where(t == SENT, j, t), j)
            done = done | (act & (i == cur))
    solve_square_plain.steps = int(steps)
    return col4row.to(torch.int32)


solve_square_plain.steps = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = cuda_build.load("lsap")
        lib.lsap_solve.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
        lib.lsap_solve.restype = ctypes.c_int
        _lib = lib
    return _lib.lsap_solve


def solve_square(cost: torch.Tensor) -> torch.Tensor:
    """cost f32[P, n, n] -> col4row i32[P, n]: the kernel on a CUDA tensor
    (one launch, counted), `solve_square_plain` on a CPU one."""
    if not cuda_build.use_kernel(cost, "lsap"):
        return solve_square_plain(cost)
    p, n = cost.shape[0], cost.shape[-1]
    if n > MAX_N:
        raise ValueError(f"lsap kernel: {n} x {n} problems exceed its "
                         f"{MAX_N} threads a block (one a column)")
    cost = cost.to(torch.float32).contiguous()
    out = torch.empty((p, n), dtype=torch.int32, device=cost.device)
    if p * n == 0:
        return out
    cuda_build.call(_kernel(), cost.device, "lsap", cost.data_ptr(), p, n,
                    out.data_ptr())
    linear_sum_assignment.launches += 1
    return out


# from mask3d_tpu/ops/lsap.py:117 linear_sum_assignment (its padding)
def pad_square(cost: torch.Tensor) -> torch.Tensor:
    """cost f32[..., R, C] -> the square problems f32[P, n, n], n = max(R,
    C), P the product of the leading dims. The padding constant sits just
    above each problem's largest cost: every assignment of leftover rows or
    columns to padding then has the same total, so the optimum on the real
    submatrix is kept."""
    cost = cost.detach().to(torch.float32)
    r, c = cost.shape[-2], cost.shape[-1]
    n = max(r, c)
    pad_val = torch.amax(cost, dim=(-2, -1), keepdim=True) + 1.0
    sq = pad_val.expand(*cost.shape[:-2], n, n).clone()
    sq[..., :r, :c] = cost
    return sq.reshape(-1, n, n)


# from mask3d_tpu/ops/lsap.py:117 linear_sum_assignment
def linear_sum_assignment(cost: torch.Tensor, method: str = "device"
                          ) -> torch.Tensor:
    """Batched exact LSAP.

    cost: f32[..., R, C] (rectangular ok; padded to square with a
    per-problem constant). Returns col4row i32[..., R] on the cost's device:
    the column assigned to each row; rows matched to padding columns get
    their padded column index >= C (the caller filters with `col4row < C`).
    """
    if method not in ("device", "host"):
        raise ValueError(f"lsap method {method!r}: 'device' or 'host'")
    r = cost.shape[-2]
    flat = pad_square(cost)
    n = flat.shape[-1]
    if method == "host":
        out = torch.from_numpy(np.stack(
            [_scipy_lsa(x)[1] for x in flat.cpu().numpy()]
        ).astype(np.int32).reshape(flat.shape[:2])).to(cost.device)
    else:
        out = solve_square(flat)
    return out.reshape(*cost.shape[:-2], n)[..., :r]


linear_sum_assignment.launches = 0
