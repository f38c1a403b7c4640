"""Where the flagship forward's device time goes.

    python -m mask3d_tpu_torch.profile_forward [--impl dense|gather_pallas]
                                               [--out trace.json]

Collates the bench's 8 synthetic scenes at bucket 49152, builds the flagship
fp32 model (seeded random weights) on the chosen backbone path
(`model.backbone_impl`, default dense), warms up, then traces one `infer`
with `torch.profiler` and prints the device time per kernel group (the
port's three CUDA kernels, convolutions, other PyTorch kernels), the wall
time of the traced forward and the device's idle share within it. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

import mask3d_tpu_torch as mt
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("masked_attention kernel", ("mca_partial", "mca_combine")),
    ("row_gather kernel", ("row_gather_kernel",)),
    ("sparse_conv kernel", ("sparse_conv_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "wgrad",
                              "dgrad", "fprop")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("index/scatter/cat", ("index", "scatter", "gather", "cat", "copy")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("dense", "gather_pallas"),
                    default="dense", help="model.backbone_impl")
    ap.add_argument("--out", default=None, help="chrome trace path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(Config(), ["data.point_bucket_multiple=49152",
                                     f"model.backbone_impl={args.impl}"])
    rng = np.random.default_rng(0)
    items = [make_synthetic_scene(rng, num_rooms_x=3, num_rooms_y=2,
                                  room_size=36, height=18, jitter=0.3,
                                  dropout=0.2, multi_floor=True)
             for _ in range(8)]
    host = mt.collate(items, device="cuda", point_bucket_multiple=49152)
    model = mt.build_model(cfg, device="cuda", seed=0)
    for _ in range(2):
        mt.infer(model, host.device, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        mt.infer(model, host.device, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    if args.out:
        prof.export_chrome_trace(args.out)
    per_group = collections.Counter()
    per_kernel = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        per_group[_group(evt.key)] += us / 1e3
        per_kernel[evt.key] += us / 1e3
    busy = sum(per_group.values())
    print(f"traced {args.impl} forward on {torch.cuda.get_device_name(0)}: "
          f"wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in per_group.most_common():
        print(f"  {group:28s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("top kernels:")
    for name, ms in per_kernel.most_common(12):
        print(f"  {ms:9.3f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
