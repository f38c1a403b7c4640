"""The sparse conv's launch plan against its alternatives on the card.

    python -m mask3d_tpu_torch.tune_sparse_conv

Counts the sparse-conv launches of one flagship `gather_pallas` forward by
(N, K, Cin, Cout), then times the kernel at each of those shapes, on the
batch's kernel map of that N and K, under the plan `sparse_conv.plan`
picks and under every other tile height (4 or 8 warps of 16 rows) and
split count (1, 2, 3, 4, 6): device ms per call, from one CUDA graph of 20
calls replayed 3 times. Prints one line per shape and the forward's sums
(launches x ms) for the picked and the best plans. Needs a CUDA card; the
constants of `plan` were set from its output (PERF.md).
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

import mask3d_tpu_torch as mt
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
from mask3d_tpu_torch.profile_forward import flagship_items, graph_ms
from mask3d_tpu_torch.sparse import sparse_conv as sc
from mask3d_tpu_torch.sparse.context import build_sparse_batch

BUCKET = 49152


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_sparse_conv needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cfg = apply_overrides(Config(), [f"data.point_bucket_multiple={BUCKET}",
                                     "model.backbone_impl=gather_pallas"])
    dev = mt.collate(flagship_items(), device="cuda",
                     point_bucket_multiple=BUCKET).device
    model = mt.build_model(cfg, device="cuda", seed=0)
    sc.sparse_conv.launches_by_shape.clear()
    mt.infer(model, dev, cfg, device="cuda")
    shapes = dict(sc.sparse_conv.launches_by_shape)
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(cfg, dev.capacity),
                            dev.grid_dims, **_sb_kwargs(cfg))
    maps = list(zip(range(sb.num_levels), sb.nbr_idx, sb.nbr_ok))
    maps.append((0, sb.nbr0_idx, sb.nbr0_ok))
    gen = torch.Generator(device="cuda").manual_seed(2)
    sums = {"picked": 0.0, "best": 0.0}
    real_plan = sc.plan
    for (n, k, cin, cout), launches in sorted(
            shapes.items(), key=lambda kv: (-kv[0][0],) + kv[0][1:]):
        level, idx, ok = next(m for m in maps if m[1] is not None
                              and tuple(m[1].shape[1:]) == (n, k))
        b = idx.shape[0]
        feats = torch.randn(b, n, cin, device="cuda", generator=gen)
        feats *= sb.levels[level].valid[..., None]
        w = torch.randn(k, cin, cout, device="cuda", generator=gen)
        picked = real_plan(b, n, k, cin, cout)
        plans = [picked] + [
            dataclasses.replace(picked, warps=wp, splits=s)
            for wp in (4, 8) for s in (1, 2, 3, 4, 6)
            if not picked.folded and (wp, s) != (picked.warps,
                                                 picked.splits)]
        times = []
        try:
            for p in plans:
                sc.plan = lambda *_, p=p: p
                times.append((graph_ms(
                    lambda: sc.sparse_conv(feats, w, idx, ok)), p))
        finally:
            sc.plan = real_plan
        best_ms, best = min(times, key=lambda t: t[0])
        sums["picked"] += launches * times[0][0]
        sums["best"] += launches * best_ms
        others = " ".join(f"w{p.warps}s{p.splits}:{t:.4f}"
                          for t, p in times[1:])
        print(f"L{level} N={n} K={k} {cin}->{cout} x{launches}: picked "
              f"w{picked.warps}s{picked.splits} {times[0][0]:.4f} ms, best "
              f"w{best.warps}s{best.splits} {best_ms:.4f} ms; {others}",
              flush=True)
    print(f"forward sums (launches x ms): picked {sums['picked']:.4f} ms, "
          f"best {sums['best']:.4f} ms")


if __name__ == "__main__":
    main()
