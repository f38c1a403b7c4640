"""The int8 conv's launch plan against its alternatives on the card.

    python -m mask3d_tpu_torch.tune_int8_conv

Run from the repo's root (it takes its inputs from `chip_smoke.py`'s
`int8_inputs`). Counts the int8 conv launches of one flagship `int8` and
one `int8_chain` forward by (grid, Cin, Cout, k, step), then, at each of
those shapes on the batch's occupancy of that grid (a junction with a
bf16 residual, as the flagship's), prints the share of the kernel's 4x4x1
fragments that hold an occupied cell and times the kernel under the plan
`int8_conv.plan` picks and under each alternative: 1 and 2 fragments a
warp, and half and twice the picked split count: device ms per call, one
CUDA graph of 20 calls replayed 3 times. Prints the forward's sums
(launches x ms) for the picked and the best plans. Needs a CUDA card; the
plan's defaults were set from its output (PERF.md).
"""

from __future__ import annotations

import subprocess
from dataclasses import replace

import torch

import mask3d_tpu_torch as mt
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
from mask3d_tpu_torch.profile_forward import CONFIGS, flagship_items, \
    graph_ms
from mask3d_tpu_torch.sparse import int8_conv as ic
from mask3d_tpu_torch.sparse.context import build_sparse_batch

BUCKET = 49152
STEP_MODE = {"conv": "none", "entry": "none", "mid": "affine",
             "junction": "join"}


def counted_shapes(dev):
    shapes = {}
    for config in ("int8", "int8_chain"):
        cfg = apply_overrides(Config(), [f"data.point_bucket_multiple="
                                         f"{BUCKET}"] + CONFIGS[config])
        model = mt.build_model(cfg, device="cuda", seed=0)
        mt.infer(model, dev, cfg, device="cuda")
        ic.int8_conv.launches_by_shape.clear()
        mt.infer(model, dev, cfg, device="cuda")
        for key, n in ic.int8_conv.launches_by_shape.items():
            if config == "int8" or key[4] != "conv":
                shapes[key] = n
        del model
    return shapes


def main():
    from chip_smoke import int8_inputs

    if not torch.cuda.is_available():
        raise SystemExit("tune_int8_conv needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cfg = apply_overrides(Config(), [f"data.point_bucket_multiple={BUCKET}"])
    dev = mt.collate(flagship_items(), device="cuda",
                     point_bucket_multiple=BUCKET).device
    shapes = counted_shapes(dev)
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(cfg, dev.capacity),
                            dev.grid_dims, **_sb_kwargs(cfg))
    level_of = {tuple(o.shape[1:4]): i for i, o in enumerate(sb.occ)}
    gen = torch.Generator(device="cuda").manual_seed(4)
    real_plan = ic.plan
    sums = {"picked": 0.0, "best": 0.0}
    try:
        for (dims, cin, cout, k, step), n in sorted(
                shapes.items(), key=lambda kv: (kv[0][4], kv[0][:4])):
            occ = sb.occ[level_of[dims]]
            share = ic.live_fragment_share(occ)
            args, kw = int8_inputs(torch, gen, occ, cin, cout, k, step,
                                   torch.bfloat16)
            b = occ.shape[0]
            base = real_plan(b, dims, cin, cout, k, STEP_MODE[step])
            variants = {"picked": base}
            for mf in ic.FRAGS_PER_WARP:
                variants[f"mf {mf}"] = real_plan(
                    b, dims, cin, cout, k, STEP_MODE[step], mf=mf)
            stages = k ** 3 * -(-(base.cin_p // 32) // base.kcs)
            for sp in {max(1, base.splits // 2),
                       min(stages, 2 * base.splits)}:
                variants[f"splits {sp}"] = replace(base, splits=sp)
            times = {}
            for name, p in variants.items():
                ic.plan = lambda *a, _p=p, **k: _p
                times[name] = graph_ms(lambda: ic.int8_conv(*args, **kw))
            ic.plan = real_plan
            best = min(times, key=times.get)
            sums["picked"] += n * times["picked"]
            sums["best"] += n * times[best]
            print(f"{step} {list(dims)} {cin}->{cout} k{k} x{n}: live "
                  f"4x4x1 fragments {share:.3f}; picked tile {base.tile} "
                  f"splits {base.splits} mf {base.mf}: "
                  + ", ".join(f"{k_} {v:.4f}" for k_, v in times.items())
                  + f" ms; best {best}", flush=True)
            del args, kw
    finally:
        ic.plan = real_plan
    print(f"forward sums (launches x ms): picked {sums['picked']:.4f} ms, "
          f"best per shape {sums['best']:.4f} ms")


if __name__ == "__main__":
    main()
