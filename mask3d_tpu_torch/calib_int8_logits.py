"""Calibrate the int8/bf16 logit-level parity bounds
(tools/calib_int8_logits.py of the JAX package). It runs on the card
unless `--device cpu` is given; the JAX tool is a CPU tool, and so is this
one with `--device cpu`.

Builds the parity16 fixture of the JAX package's tests/test_e2e.py (16
scenes of 2x1 rooms in one bucket shape, 8 batches of 2), trains its model
for `steps` epochs with the port's `make_train_step`, then prints per
variant (bf16, dynamic int8, static int8 at several `int8_act_sigma`) the
mask-logit error against fp32, max / 99.9% / 99% quantile of |delta|
normalised by the fp32 logits' std, and the evaluator's mAP deltas.

    python -m mask3d_tpu_torch.calib_int8_logits [steps] [--device cpu|cuda]

The port keeps its own copies of what the JAX tool takes from
tests/test_e2e.py: `small_config`, `parity_config`, `N_PARITY_SCENES`,
`_PARITY_BS`, `_variant_eval` and `_MAP_KEYS`. It trains
`parity_config`, the model `_variant_eval` scores (the JAX tool trains
`small_config`'s Res16UNet14A and then evaluates those weights in
`parity_config`'s Res16UNet18A model, whose second block of each stage has
no weights there).
"""

from __future__ import annotations

import sys

import numpy as np

from mask3d_tpu_torch.config import Config, apply_overrides

# from tests/test_e2e.py:143-144 N_PARITY_SCENES
N_PARITY_SCENES = 16
_PARITY_BS = 2  # scenes per batch (8 batches of 2)
# from tests/test_e2e.py:229 _MAP_KEYS
_MAP_KEYS = ("val_mean_ap", "val_mean_ap_50", "val_mean_ap_25")
STEPS = 14


# from tests/test_e2e.py:25 small_config
def small_config() -> Config:
    return apply_overrides(Config(), [
        "model.hidden_dim=32",
        "model.dim_feedforward=64",
        "model.num_queries=8",
        "model.num_heads=4",
        "model.num_decoders=2",
        "model.backbone=Res16UNet14A",
        "model.conv1_kernel_size=3",
        "model.sample_sizes=[32,64,128,256,512]",
        "data.point_bucket_multiple=512",
        "optimizer.lr=0.002",
        "scheduler.gamma=1.0",
    ])


# from tests/test_e2e.py:147 parity_config
def parity_config() -> Config:
    """small_config with two blocks a stage (Res16UNet18A), which exercise
    the int8 residual junctions."""
    return apply_overrides(small_config(), ["model.backbone=Res16UNet18A"])


# from tools/calib_int8_logits.py:28-46 rng
def parity_batches():
    """(scenes, cap, dims0, batches): the 16 scenes (generator seed 11),
    the largest point capacity and level-0 grid dims of a first collation
    at bucket 64, and the 8 batches re-collated into that one shape."""
    from mask3d_tpu_torch.data.collate import VoxelizeCollate
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(11)
    scenes = [
        make_synthetic_scene(rng, num_rooms_x=2, num_rooms_y=1,
                             room_size=12, height=6, jitter=0.0, dropout=0.5)
        for _ in range(N_PARITY_SCENES)
    ]
    probe = VoxelizeCollate(point_bucket_multiple=64)
    probed = [probe(scenes[i:i + _PARITY_BS])
              for i in range(0, N_PARITY_SCENES, _PARITY_BS)]
    cap = max(int(b.device.coords.shape[1]) for b in probed)
    dims0 = tuple(max(b.device.grid_dims[0][a] for b in probed)
                  for a in range(3))
    coll = VoxelizeCollate(point_bucket_multiple=cap, min_grid_dims=dims0)
    batches = [coll(scenes[i:i + _PARITY_BS])
               for i in range(0, N_PARITY_SCENES, _PARITY_BS)]
    return scenes, cap, dims0, batches


# from tests/test_e2e.py:196 _variant_eval
def _variant_eval(model, batches, overrides, device="cpu"):
    """The trained weights in a model of `parity_config` with the model
    overrides of `overrides`: (evaluator metrics over the 16 scenes, the
    raw mask logits)."""
    from mask3d_tpu_torch.evalm import Mask3DEvaluator
    from mask3d_tpu_torch.infer import infer
    from mask3d_tpu_torch.models.mask3d import build_model
    from mask3d_tpu_torch.postprocess import postprocess_item

    cfg2 = parity_config()
    for k, v in overrides.items():
        setattr(cfg2.model, k, v)
    model2 = build_model(cfg2, device=device)
    model2.load_state_dict(model.state_dict())
    model2.eval()
    preds, targets, logits = [], [], []
    for batch in batches:
        # the eval step's predictions (its losses are not read)
        out, _ = infer(model2, batch.device, cfg2, device=device)
        pred_class = out.pred_class.cpu().numpy()
        pred_masks = out.pred_masks.cpu().numpy()
        logits.append(pred_masks.astype(np.float32))
        counts = np.asarray(batch.device.counts)
        for b in range(_PARITY_BS):
            n = counts[b]
            preds.append(postprocess_item(
                pred_class[b], pred_masks[b, :n],
                np.asarray(batch.device.coords[b, :n], np.float32),
                batch.scenes[b], use_dbscan=False, scores_threshold=0.1))
            tv = np.asarray(batch.device.target.valid[b])
            targets.append({
                "labels": np.asarray(batch.device.target.labels[b])[tv],
                "masks": np.asarray(batch.device.target.masks[b])[tv][:, :n],
            })
    metrics = Mask3DEvaluator().evaluate(preds, targets, "val")
    return metrics, np.concatenate(logits, axis=0)


# from tools/calib_int8_logits.py:60-67 variants
def variants() -> dict:
    out = {
        "bf16": {"compute_dtype": "bfloat16"},
        "int8-dyn": {"int8_stride1": True, "compute_dtype": "bfloat16"},
    }
    for s in (4.0, 6.0, 8.0, 10.0, 14.0):
        out[f"int8-s{s:g}"] = {
            "int8_stride1": True, "compute_dtype": "bfloat16",
            "int8_act_sigma": s,
        }
    return out


# from tools/calib_int8_logits.py:17 main
def main(steps: int = STEPS, device: str = "cuda") -> dict:
    """Train, then print and return {variant: (max, p999, p99, mAP
    deltas)}."""
    from mask3d_tpu_torch.device import resolve_device
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    resolve_device(device)  # raises where CUDA is asked and absent
    _, _, _, batches = parity_batches()
    cfg = parity_config()
    state = init_state(cfg, batches[0].device, device=device)
    train_step = make_train_step(cfg, make_criterion(cfg), device=device)
    for _ in range(steps):
        for b in batches:
            losses, _p = train_step(state, b.device)
    print("final loss", float(losses["loss"]), flush=True)

    ref_m, ref_l = _variant_eval(state.model, batches, {}, device)
    scale = float(np.std(ref_l))
    print(f"fp32 logit std {scale:.3f}", flush=True)
    out = {}
    for name, ov in variants().items():
        m, lg = _variant_eval(state.model, batches, ov, device)
        d = np.abs(lg - ref_l) / scale
        dm = {k: m[k] - ref_m[k] for k in _MAP_KEYS}
        out[name] = (float(d.max()), float(np.quantile(d, 0.999)),
                     float(np.quantile(d, 0.99)), dm)
        print(
            f"{name:10s} max={d.max():.3f} p999={np.quantile(d, 0.999):.4f} "
            f"p99={np.quantile(d, 0.99):.4f} "
            + " ".join(f"d{k.split('_')[-1]}={v:+.4f}" for k, v in dm.items()),
            flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cuda"
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    main(int(args[0]) if args else STEPS, dev)
