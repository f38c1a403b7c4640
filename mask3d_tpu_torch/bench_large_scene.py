"""Large-scene bench: the backbone paths that serve scans whose level-0 grid
is too large for `backbone_impl=dense`, on the card.

    python -m mask3d_tpu_torch.bench_large_scene [--dry] [--dense] [--reps N]

The scene is the JAX package's synthetic hall scan (`make_hall_scene`,
seed 0): a 1920-cell open hall with floor, ceiling, two side walls and 260
furniture-like boxes, collated at `point_bucket_multiple=65536` (888,766
voxels on a 1920x168x72 level-0 grid, 3.8% occupied). `--dry` prints its
geometry (points, grid, the dense path's arithmetic, the occupied bricks
and the brick capacity) from the host alone. Otherwise the flagship
`Config()` (Res16UNet34C, hidden 128, 25 queries, 8 heads, 3 shared
decoders; seeded random weights, the same for every variant) runs the four
bf16 variants of the JAX tool: `bricked` (its brick shape and capacity
rule), `gather_pallas`, `gather_pallas+grouped_dx` (the TPU kernel's other
window schedule: the port runs the same CUDA kernel) and `gather`; each
prints ms a forward (median of `--reps` after a warm-up, fenced with
`torch.cuda.synchronize()`), points/s and the peak device memory.
`--dense` also tries `dense` in fp32 and bf16 once each and prints its
time and peak, or the error it raised.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

BUCKET = 65536
# the JAX tool's brick shapes, first that divides the grid, and its
# capacity rule: occupied bricks + 15%, rounded up to 256
BRICK_SHAPES = ((32, 8, 8), (16, 16, 8), (16, 8, 8), (8, 8, 8))
VARIANTS = (("bricked", "per_offset"), ("gather_pallas", "per_offset"),
            ("gather_pallas+grouped_dx", "grouped_dx"),
            ("gather", "per_offset"))


# from tools/bench_large_scene.py:27 make_hall_scene
def make_hall_scene(rng, length=1920, width=160, height=64, n_boxes=260):
    """Open-hall surface scan: floor, ceiling, two y-side walls (parallel
    to x) and clustered clutter (box tops and sides), 0.3-cell noise; the
    JAX package's scene draw for draw."""
    xs = np.arange(length)
    ys = np.arange(width)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    pts = [
        np.stack([gx, gy, np.zeros_like(gx)], 1),  # floor
        np.stack([gx, gy, np.full_like(gx, height - 1)], 1),  # ceiling
    ]
    zs = np.arange(height)
    wgx, wgz = np.meshgrid(xs, zs, indexing="ij")
    for wy in (0, width - 1):  # two side walls
        pts.append(np.stack(
            [wgx.ravel(), np.full(wgx.size, wy), wgz.ravel()], 1))
    for _ in range(n_boxes):  # furniture-like boxes: top + 4 sides
        sx = int(rng.integers(6, 40))
        sy = int(rng.integers(6, 24))
        sz = int(rng.integers(4, 20))
        x0 = int(rng.integers(0, length - sx))
        y0 = int(rng.integers(1, width - 1 - sy))
        bx = np.arange(x0, x0 + sx)
        by = np.arange(y0, y0 + sy)
        bz = np.arange(1, 1 + sz)
        fx, fy = np.meshgrid(bx, by, indexing="ij")
        pts.append(np.stack(
            [fx.ravel(), fy.ravel(), np.full(fx.size, 1 + sz)], 1))
        wx, wz = np.meshgrid(bx, bz, indexing="ij")
        for yy in (y0, y0 + sy - 1):
            pts.append(np.stack(
                [wx.ravel(), np.full(wx.size, yy), wz.ravel()], 1))
        wy2, wz2 = np.meshgrid(by, bz, indexing="ij")
        for xx in (x0, x0 + sx - 1):
            pts.append(np.stack(
                [np.full(wy2.size, xx), wy2.ravel(), wz2.ravel()], 1))
    coords = np.concatenate(pts).astype(np.float32)
    coords += rng.normal(scale=0.3, size=coords.shape).astype(np.float32)
    # instance labels: x-segments (irrelevant to the forward)
    seg = np.clip(coords[:, 0] // (length // 12), 0, 11).astype(np.int32)
    labels = np.stack([np.ones_like(seg), seg], 1)
    features = np.ones((len(coords), 1), np.float32)
    return {"coordinates": coords, "features": features, "labels": labels,
            "raw_coordinates": coords.copy(),
            "raw_features": features.copy(), "raw_labels": labels.copy(),
            "scene": "hall", "idx": 0}


def hall_batch(device="cpu"):
    """The hall scene (seed 0) collated at bucket 65536, on `device`."""
    from mask3d_tpu_torch.data.collate import collate

    item = make_hall_scene(np.random.default_rng(0))
    return collate([item], device=device, point_bucket_multiple=BUCKET)


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


# from tools/bench_large_scene.py:136 main (the brick geometry, :136-156)
def brick_geometry(batch, brick=None):
    """(brick dims, occupied bricks, slots, capacity) of item 0 of a
    collated batch: `brick`, or the first of BRICK_SHAPES that divides its
    level-0 grid dims, and occupied + 15% rounded up to 256."""
    gd0 = batch.grid_dims[0]
    brick = brick or next(bd for bd in BRICK_SHAPES
                          if all(int(g) % b == 0 for g, b in zip(gd0, bd)))
    n = int(_host(batch.counts)[0])
    c = _host(batch.coords[0])[:n].astype(np.int64)
    sy, sz = int(gd0[1]) // brick[1], int(gd0[2]) // brick[2]
    keys = np.unique((c[:, 0] // brick[0] * sy + c[:, 1] // brick[1]) * sz
                     + c[:, 2] // brick[2])
    slots = int(np.prod(gd0)) // int(np.prod(brick))
    return brick, len(keys), slots, -(-int(len(keys) * 1.15) // 256) * 256


def geometry_lines(batch):
    """The scene's geometry as printed lines, and (brick, capacity)."""
    gd0 = tuple(int(d) for d in batch.grid_dims[0])
    cells = int(np.prod(gd0))
    n = int(_host(batch.counts).sum())
    brick, nb, slots, cap = brick_geometry(batch)
    bcells = nb * int(np.prod(brick))
    # the dense path's largest conv input: block8_0 at level 0 takes the
    # 96-channel decoder output and the 32-channel skip
    elems = cells * 128
    return [
        f"scene: {n} pts, grid {gd0} = {cells / 1e6:.1f}M cells "
        f"(occupancy {n / cells:.3f}); capacity {batch.capacity} rows",
        f"dense path: one 96-ch bf16 level-0 grid = "
        f"{cells * 96 * 2 / 1e9:.2f} GB; block8_0's 128-ch input = "
        f"{elems / 1e9:.2f}G elements ({'over' if elems >= 2**31 else 'under'}"
        f" 2^31 in a batch of one)",
        f"bricks {brick}: {nb} occupied of {slots} slots -> capacity {cap} "
        f"({bcells / 1e6:.1f}M brick cells, {bcells / cells:.2f}x of dense; "
        f"largest brick tensor {(cap + 1) * int(np.prod(brick)) * 128 / 1e9:.2f}"
        f"G elements at 128 ch)",
    ], brick, cap


def variant_cfg(name, window_mode, brick, cap, dtype="bfloat16"):
    """Config() at bucket 65536 for one variant (`name` = impl[+suffix])."""
    from mask3d_tpu_torch.config import Config, apply_overrides

    ov = [f"data.point_bucket_multiple={BUCKET}",
          f"model.backbone_impl={name.split('+')[0]}",
          f"model.pallas_window_mode={window_mode}",
          f"model.brick_dims=[{brick[0]},{brick[1]},{brick[2]}]",
          f"model.brick_capacity={cap}"]
    if dtype is not None:
        ov.append(f"model.compute_dtype={dtype}")
    return apply_overrides(Config(), ov)


def time_forward(torch, model, batch, cfg, reps):
    """(median ms, all ms, peak GiB) of `infer` after one warm-up, each
    call fenced with `torch.cuda.synchronize()`; raises on an overflow."""
    from mask3d_tpu_torch.infer import infer

    _, overflow = infer(model, batch, cfg, device="cuda")
    if bool(overflow):
        raise RuntimeError("a pyramid level or the bricks overflowed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        infer(model, batch, cfg, device="cuda")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return (statistics.median(ms), ms,
            torch.cuda.max_memory_allocated() / 2**30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry", action="store_true",
                    help="print the scene's geometry only (no card)")
    ap.add_argument("--dense", action="store_true",
                    help="also try backbone_impl=dense in fp32 and bf16")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    host = hall_batch("cpu")
    lines, brick, cap = geometry_lines(host.device)
    print(f"collated the hall scene in {time.perf_counter() - t:.1f} s",
          flush=True)
    for line in lines:
        print(line, flush=True)
    if args.dry:
        return 0

    import torch

    from mask3d_tpu_torch.device import resolve_device
    from mask3d_tpu_torch.models.mask3d import build_model

    resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    batch = host.device.to("cuda")
    n = int(host.device.counts.sum())
    results = {}
    for name, mode in VARIANTS:
        cfg = variant_cfg(name, mode, brick, cap)
        model = build_model(cfg, device="cuda", seed=0)
        med, ms, peak = time_forward(torch, model, batch, cfg, args.reps)
        results[name] = med
        print(f"{name} bf16: {med:.1f} ms a forward (median of {args.reps}:"
              f" {', '.join(f'{m:.1f}' for m in ms)}) = "
              f"{n / med * 1e3 / 1e6:.4f}M pts/s, peak {peak:.2f} GiB",
              flush=True)
        del model
        torch.cuda.empty_cache()
    if args.dense:
        for dtype in (None, "bfloat16"):
            cfg = variant_cfg("dense", "per_offset", brick, cap, dtype)
            try:
                model = build_model(cfg, device="cuda", seed=0)
                med, ms, peak = time_forward(torch, model, batch, cfg, 1)
                print(f"dense {dtype or 'fp32'}: ran, {med:.1f} ms a forward,"
                      f" peak {peak:.2f} GiB", flush=True)
            except Exception as e:  # the finding is the error itself
                print(f"dense {dtype or 'fp32'}: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:400]}", flush=True)
            model = None
            torch.cuda.empty_cache()
    print(f"RESULT large scene ({n} pts) on {card}: " + ", ".join(
        f"{k} {n / v * 1e3 / 1e6:.4f}M pts/s" for k, v in results.items()),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
