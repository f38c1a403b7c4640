"""Recertify the numeric-format stack on a trained flagship checkpoint
(tools/recert_int8.sh of the JAX package): the port's `cli test` on one
checkpoint and one written dataset (`make_synthetic_dataset.py`; the grid
pinned by `pinned_grid_dims`) in three variants, fp32, bf16 and the JAX
bench's int8 stack (`compute_dtype=bfloat16`, `int8_stride1`,
`int8_act_sigma=10`, `int8_residual`, `unit_features`), and each of
mean_ap, mean_ap_50 and mean_ap_25 of bf16 and int8 gated within 0.01 of
fp32. Prints one line a variant and key, the fp32 value beside the delta,
then `RECERT PASS` or `RECERT FAIL` (exit 1).

    python -m mask3d_tpu_torch.recert_int8 [checkpoint] [--root R] \\
        [--device cuda|cpu]

The checkpoint defaults to the data-scale run's
`saved/experiment1_voxel_size_150/r5_datascale/best_val_mean_ap_50.ckpt`
and the dataset to `data/synth_stru3d` (`train_datascale.py` writes both).
The metrics come from the trainer in this process (`cli.run`), not from
its printed lines. A pass at mAP ~ 0 certifies nothing: the fp32 values
are printed for that reason.
"""

from __future__ import annotations

import logging
import math
import os
import sys
from typing import Dict, Sequence

from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.make_synthetic_dataset import pinned_grid_dims

ROOT = os.path.join("data", "synth_stru3d")
CHECKPOINT = os.path.join("saved", "experiment1_voxel_size_150",
                          "r5_datascale", "best_val_mean_ap_50.ckpt")
MAP_TOL = 0.01
MAP_KEYS = ("mean_ap", "mean_ap_50", "mean_ap_25")
# from tools/recert_int8.sh:62-67 run_variant (bench.py's numeric stack)
VARIANTS = {
    "fp32": [],
    "bf16": ["model.compute_dtype=bfloat16"],
    "int8": ["model.compute_dtype=bfloat16", "model.int8_stride1=true",
             "model.int8_act_sigma=10", "model.int8_residual=true",
             "model.unit_features=true"],
}


# from tools/recert_int8.sh:42-53 COMMON
def common_overrides(root: str, grid: Sequence[int], checkpoint: str) -> list:
    return [
        f"data.data_root={root}",
        "data.valid_scenes_file_path=null",
        f"data.min_grid_dims=[{','.join(str(int(d)) for d in grid)}]",
        "data.point_bucket_multiple=65536",
        "data.test_batch_size=4",
        "general.use_dbscan=false",
        "general.scores_threshold=0.0",
        "general.export_las=false",
        f"general.checkpoint={checkpoint}",
        "general.experiment_id=recert_scratch",
    ]


def run_variant(name: str, root: str, grid, checkpoint: str,
                device: str = "cuda", extra: Sequence[str] = ()) -> dict:
    """`cli test` of one variant in this process; its metrics."""
    from mask3d_tpu_torch import cli

    cfg = apply_overrides(Config(), common_overrides(root, grid, checkpoint)
                          + VARIANTS[name] + list(extra))
    cfg.general.train_mode = False
    print(f"=== variant: {name} ===", flush=True)
    return cli.run("test", cfg, device)


def map_values(metrics: dict) -> Dict[str, float]:
    """The metrics whose key ends in one of MAP_KEYS (`test_mean_ap`,
    ...)."""
    return {k: float(v) for k, v in metrics.items() if k.endswith(MAP_KEYS)}


# from tools/recert_int8.sh:79-90 ref
def gate(runs: Dict[str, dict], tol: float = MAP_TOL):
    """(lines, ok): each key of fp32's mAPs against bf16's and int8's,
    |delta| <= tol (a missing or NaN value fails)."""
    ref = map_values(runs["fp32"])
    ok, lines = True, []
    for name in ("bf16", "int8"):
        got = map_values(runs[name])
        for k, v in sorted(ref.items()):
            g = got.get(k, float("nan"))
            d = abs(g - v)
            passed = d <= tol  # False for NaN
            ok &= passed
            lines.append(f"{name} {k}: {g:.4f} vs fp32 {v:.4f} "
                         f"(|d|={d:.4f}) {'OK' if passed else 'FAIL'}")
    if not ref or any(math.isnan(v) for v in ref.values()):
        ok = False
    lines.append(f"RECERT {'PASS' if ok else 'FAIL'}")
    return lines, ok


def main(checkpoint: str = CHECKPOINT, root: str = ROOT,
         device: str = "cuda", extra: Sequence[str] = ()) -> dict:
    """Run the three variants and the gate; returns {"runs", "lines",
    "ok", "grid"} (the caller exits 1 where not ok)."""
    if not os.path.isfile(checkpoint):
        raise FileNotFoundError(f"no checkpoint at {checkpoint}")
    grid = pinned_grid_dims(root)
    print(f"recert: {checkpoint} on {root}, pinned grid {grid}", flush=True)
    runs = {name: run_variant(name, root, grid, checkpoint, device, extra)
            for name in VARIANTS}
    lines, ok = gate(runs)
    for line in lines:
        print(line, flush=True)
    return dict(runs=runs, lines=lines, ok=ok, grid=grid)


def cli_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--root": ROOT, "--device": "cuda"}
    rest = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            rest.append(a)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    out = main(rest[0] if rest else CHECKPOINT, opts["--root"],
               opts["--device"])
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(cli_main())
