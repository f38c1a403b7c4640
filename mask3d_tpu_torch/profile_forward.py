"""Where the flagship forward's device time goes.

    python -m mask3d_tpu_torch.profile_forward [--impl IMPL]
        [--config fp32|bf16|int8|int8_chain] [--scene flagship|hall]
        [--out trace.json]

Collates the bench's 8 synthetic scenes at bucket 49152 (or, `--scene
hall`, the hall scan of `bench_large_scene.py` at bucket 65536 with its
brick shape and capacity), builds the flagship model (seeded random
weights) on the chosen backbone path (`model.backbone_impl`, default
dense) in the chosen configuration (default fp32; `bf16`, `int8` and
`int8_chain` are the JAX bench's inference stack, `CONFIGS`; the int8
ones dense only), warms up, then traces one `infer` with
`torch.profiler` and prints the device time per kernel group (the port's
CUDA kernels, convolutions, other PyTorch kernels), the wall time of the
traced forward and the device's idle share within it. Needs a CUDA card.
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

# model overrides of each configuration: the JAX bench's flagship stack
# (bench.py:156-186) in bf16, int8, and int8 with the fused chain
_INT8 = ["model.compute_dtype=bfloat16", "model.int8_stride1=true",
         "model.int8_act_sigma=10", "model.int8_residual=true",
         "model.unit_features=true"]
CONFIGS = {"fp32": [], "bf16": ["model.compute_dtype=bfloat16"],
           "int8": _INT8, "int8_chain": _INT8 + ["model.pallas_chain=true"]}

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("masked_attention kernel", ("mca_partial", "mca_combine")),
    ("row_gather kernel", ("row_gather_kernel",)),
    ("sparse_conv kernel", ("sparse_conv_kernel",)),
    ("int8_conv kernel", ("int8_conv_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "wgrad",
                              "dgrad", "fprop")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("index/scatter/cat", ("index", "scatter", "gather", "cat", "copy")),
)


def flagship_items(seed: int = 0):
    """The bench's 8 synthetic scenes: 3x2 rooms of 36, height 18, two
    floors."""
    rng = np.random.default_rng(seed)
    return [make_synthetic_scene(rng, num_rooms_x=3, num_rooms_y=2,
                                 room_size=36, height=18, jitter=0.3,
                                 dropout=0.2, multi_floor=True)
            for _ in range(8)]


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device ms per call of `fn`: `iters` calls captured in one CUDA
    graph and replayed, CUDA events around the replays. Unlike back-to-back
    eager calls it leaves out the host's per-call cost (Python, dispatch),
    which exceeds the device time of a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("dense", "gather", "gather_pallas",
                                       "bricked"),
                    default="dense", help="model.backbone_impl")
    ap.add_argument("--config", choices=tuple(CONFIGS), default="fp32",
                    help="inference configuration (int8: dense only)")
    ap.add_argument("--scene", choices=("flagship", "hall"),
                    default="flagship")
    ap.add_argument("--out", default=None, help="chrome trace path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.scene == "hall":
        from mask3d_tpu_torch import bench_large_scene as bls

        host = bls.hall_batch("cuda")
        _, brick, cap = bls.geometry_lines(host.device)
        cfg = bls.variant_cfg(args.impl, "per_offset", brick, cap, None)
    else:
        cfg = apply_overrides(Config(), ["data.point_bucket_multiple=49152"])
        host = mt.collate(flagship_items(), device="cuda",
                          point_bucket_multiple=49152)
    cfg = apply_overrides(cfg, [f"model.backbone_impl={args.impl}"]
                          + CONFIGS[args.config])
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
    print(f"traced {args.scene} {args.impl} {args.config} forward on "
          f"{torch.cuda.get_device_name(0)}: "
          f"wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in per_group.most_common():
        print(f"  {group:28s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("top kernels:")
    for name, ms in per_kernel.most_common(12):
        print(f"  {ms:9.3f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
