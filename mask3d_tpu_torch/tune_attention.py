"""The masked cross-attention kernel's launch plan against its
alternatives, and against the first kernel, on the card.

    python -m mask3d_tpu_torch.tune_attention [--old SOURCE]

At the flagship's four key lengths (B=8, Q=25, D=128, H=8, S in {3072,
6144, 12288, 24576}) it times, by CUDA-graph replay (device ms per call),
the package's kernel as `plan()` launches it and with 8, 4 or 2 heads a
block and the chunk counts that give 1-4 blocks per SM. With `--old`, also
a build of SOURCE, a kernel with the first kernel's C interface, launched
as that kernel was: the first kernel is `git show
2af830d:mask3d_tpu_torch/csrc/masked_attention.cu` (unchanged up to
66a7ade). Prints one line per (S, variant) and the bytes bound. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import subprocess

import torch

from mask3d_tpu_torch import cuda_build
from mask3d_tpu_torch.ops import masked_attention as ma
from mask3d_tpu_torch.profile_forward import graph_ms

ATTN_S = (3072, 6144, 12288, 24576)
B, Q, D, H = 8, 25, 128, 8
HBM_BYTES_PER_S = 3.35e12


def _new_fn(lib):
    fn = lib.masked_cross_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _old_fn(lib):
    fn = lib.masked_cross_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _old_chunking(b, nq, s, tk=32, qg=32, target=528):
    want = max(1, min(-(-target // (b * -(-nq // qg))), -(-s // tk)))
    chunk = -(-(-(-s // want)) // tk) * tk
    return chunk, -(-s // chunk)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="a CUDA source with the first kernel's "
                    "C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_attention needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    new = _new_fn(cuda_build.load("masked_attention"))
    old = _old_fn(cuda_build.load_source(args.old)) if args.old else None
    for line in cuda_build.build_logs.values():
        for row in line.splitlines():
            if "registers" in row or "spill" in row:
                print("  ptxas:", row.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    hd = D // H
    for s in ATTN_S:
        q = torch.randn(B, Q, D, device="cuda", generator=gen)
        k = torch.randn(B, s, D, device="cuda", generator=gen)
        v = torch.randn(B, s, D, device="cuda", generator=gen)
        m8 = (torch.rand(B, Q, s, device="cuda", generator=gen) < 0.4).view(
            torch.uint8)
        out = torch.empty_like(q)
        nbytes = 4 * (2 * B * Q * D + 2 * B * s * D) + B * Q * s
        print(f"S={s}: bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        base = ma.plan(B, Q, s, H, hd)
        tiles = -(-s // base.tile)
        plans = {"plan": base}
        for hg in (8, 4, 2):
            threads = -(-hg * -(-Q // base.queries) * base.ksl // 32) * 32
            if ma.smem_bytes(base.tile, hg * hd, Q) > ma.SMEM_BYTES or \
                    threads > ma.MAX_THREADS:
                continue
            for per_sm in (1, 2, 3, 4):
                want = max(1, min(tiles, ma.SMS * per_sm // (B * H // hg)))
                chunk = -(-tiles // want) * base.tile
                plans[f"hg {hg}, {per_sm}/SM"] = dataclasses.replace(
                    base, hg=hg, threads=threads, chunk=chunk,
                    nch=-(-s // chunk))
        for pname, p in plans.items():
            pm = torch.empty((2, B, p.nch, H, Q), device="cuda")
            pa = torch.empty((B, p.nch, H, Q, hd), device="cuda")

            def call(p=p, pm=pm, pa=pa):
                cuda_build.check(new(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
                    pm[0].data_ptr(), pm[1].data_ptr(), pa.data_ptr(),
                    out.data_ptr(), None, None, B, Q, s, s, H, hd, p.ksl,
                    p.queries, p.hg, p.threads, p.chunk, p.nch,
                    1.0 / math.sqrt(hd),
                    torch.cuda.current_stream().cuda_stream), "kernel")

            print(f"  kernel [{pname}: ksl {p.ksl} hg {p.hg} queries "
                  f"{p.queries} threads {p.threads} nch {p.nch}]: "
                  f"{graph_ms(call):.4f} ms")
        if old is not None:
            chunk, nch = _old_chunking(B, Q, s)
            pm = torch.empty((2, B, nch, H, Q), device="cuda")
            pa = torch.empty((B, nch, H, Q, hd), device="cuda")

            def call_old():
                cuda_build.check(old(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
                    pm[0].data_ptr(), pm[1].data_ptr(), pa.data_ptr(),
                    out.data_ptr(), B, Q, s, H, hd, chunk, nch,
                    1.0 / math.sqrt(hd),
                    torch.cuda.current_stream().cuda_stream), "old kernel")

            print(f"  old kernel [nch {nch}]: {graph_ms(call_old):.4f} ms")
        del q, k, v, m8


if __name__ == "__main__":
    main()
