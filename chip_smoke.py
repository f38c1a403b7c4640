#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`mask3d_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one, or when the package is not
beside this script. Phases:

1. Card and build: prints the card's name and power limit, builds both CUDA
   kernels from `mask3d_tpu_torch/csrc/` (one nvcc per source, in parallel).
2. Kernels against their plain PyTorch versions on the card, at the
   flagship's shapes: masked cross-attention at B=8, Q=25, D=128, H=8 and
   S in {3072, 6144, 12288, 24576} (max |err| <= 1e-4); the row gather
   with indices from a real collated batch at C in {3, 96, 128, 256}
   (bitwise equal). Each is timed beside its plain version, a PyTorch
   library call that computes the same function, and its bound.
3. The main path: 8 synthetic scenes collated at bucket 49152, the flagship
   Mask3D + Res16UNet34C (fp32, seeded random weights) through `infer`,
   with the kernels' launch counts read around that one forward
   (12 attention, 13 gather), then post-processing and the evaluator. The
   same weights at a small width run on the CPU (plain versions) and on the
   card (kernels), and must agree.
4. Times: the forward's median over 10 runs.

TF32 is switched off for convolutions and matmuls: the slice is fp32.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
ATTN_S = (3072, 6144, 12288, 24576)
ATTN_TOL = 1e-4
GATHER_C = {3: 1, 96: 0, 128: 2, 256: 3}  # channels -> level of that tap
BUCKET = 49152


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flagship_items(make_synthetic_scene, np, seed):
    """The bench's scenes: 3x2 rooms of 36, height 18, two floors."""
    rng = np.random.default_rng(seed)
    return [make_synthetic_scene(rng, num_rooms_x=3, num_rooms_y=2,
                                 room_size=36, height=18, jitter=0.3,
                                 dropout=0.2, multi_floor=True)
            for _ in range(8)]


def check_attention(torch, F, ma):
    """Kernel vs plain at each flagship level; returns per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, nq, d, h = 8, 25, 128, 8
    rows = []
    for s in ATTN_S:
        q = torch.randn(b, nq, d, device="cuda", generator=gen)
        k = torch.randn(b, s, d, device="cuda", generator=gen)
        v = torch.randn(b, s, d, device="cuda", generator=gen)
        mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
        count = (torch.arange(b, device="cuda") + 2) * s // 10
        mask |= torch.arange(s, device="cuda")[None, None] >= count[:, None,
                                                                   None]
        mask[0, 0] = True  # an all-blocked row: uniform weights
        mask[1, 1] = False  # a fully open row
        got = ma.masked_cross_attention(q, k, v, mask, h)
        ref = ma.masked_cross_attention_plain(q, k, v, mask, h)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= ATTN_TOL
        hd = d // h
        qh = q.view(b, nq, h, hd).transpose(1, 2)
        kh = k.view(b, s, h, hd).transpose(1, 2)
        vh = v.view(b, s, h, hd).transpose(1, 2)
        add = torch.zeros(b, 1, nq, s, device="cuda").masked_fill(
            mask[:, None], -1e9)
        row = dict(
            S=s, max_abs_err=err, ok=ok,
            ms=time_ms(torch, lambda: ma.masked_cross_attention(
                q, k, v, mask, h)),
            plain_ms=time_ms(torch, lambda: ma.masked_cross_attention_plain(
                q, k, v, mask, h), iters=5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=add)),
        )
        nbytes = 4 * (2 * b * nq * d + 2 * b * s * d) + b * nq * s
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * b * nq * s * d)
        log(f"attention S={s}: max|err| {err:.3g} (tol {ATTN_TOL}) "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
            f"sdpa {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
        rows.append(row)
        del q, k, v, mask, add
    return rows


def check_gather(torch, rg, dense_ops, batch, caps):
    """Kernel vs plain with idx/ok from a real batch's static keys."""
    from mask3d_tpu_torch.sparse.context import build_sparse_batch

    gen = torch.Generator(device="cuda").manual_seed(1)
    sb = build_sparse_batch(
        batch.coords, batch.counts, batch.dims,
        caps, batch.grid_dims)
    rows = []
    for c, li in GATHER_C.items():
        gd = batch.grid_dims[li]
        cells = gd[0] * gd[1] * gd[2]
        lvl = sb.levels[li]
        idx = dense_ops.static_keys(lvl, gd).clamp(0, cells - 1).to(
            torch.int32).contiguous()
        ok = lvl.valid.contiguous()
        b, m = idx.shape
        src = torch.randn(b, cells, c, device="cuda", generator=gen)
        got = rg.row_gather(src, idx, ok)
        ref = rg.row_gather_plain(src, idx, ok)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, ref))
        flat = src.view(b * cells, c)
        fidx = (idx.long() + torch.arange(b, device="cuda")[:, None]
                * cells).view(-1)
        row = dict(
            C=c, level=li, rows=b * m, equal=equal, max_abs_err=(
                got - ref).abs().max().item(),
            ms=time_ms(torch, lambda: rg.row_gather(src, idx, ok)),
            plain_ms=time_ms(torch, lambda: rg.row_gather_plain(
                src, idx, ok)),
            library_ms=time_ms(torch, lambda: flat.index_select(0, fidx)),
        )
        n_ok = int(ok.sum())
        nbytes = b * m * 5 + n_ok * c * 4 + b * m * c * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
        log(f"row_gather C={c} level {li} rows {b * m}: bitwise equal "
            f"{equal} kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
            f"ms index_select {row['library_ms']:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms")
        rows.append(row)
    return rows


def small_reference(torch, mt, cfg_mod, synth, np):
    """Same weights at a small width: the card (kernels) against the CPU
    (plain versions). Returns the max |diff| / max(1, std) over both
    outputs."""
    ov = ["model.hidden_dim=32", "model.dim_feedforward=64",
          "model.num_queries=8", "model.num_heads=4",
          "model.num_decoders=2", "model.backbone=Res16UNet14A",
          "model.conv1_kernel_size=3", "data.point_bucket_multiple=512"]
    cfg = cfg_mod.apply_overrides(cfg_mod.Config(), ov)
    rng = np.random.default_rng(3)
    items = [synth(rng, num_rooms_x=3, num_rooms_y=2, room_size=12,
                   height=6, jitter=0.0, dropout=0.5) for _ in range(2)]
    host = mt.collate(items, device="cpu", point_bucket_multiple=512)
    cpu_model = mt.build_model(cfg, device="cpu", seed=5)
    gpu_model = mt.build_model(cfg, device="cuda", seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ref, _ = mt.infer(cpu_model, host.device, cfg, aux_masks=True,
                      device="cpu")
    got, _ = mt.infer(gpu_model, host.device, cfg, aux_masks=True,
                      device="cuda")
    worst = 0.0
    for r, g in ((ref.aux_pred_class, got.aux_pred_class),
                 (ref.aux_pred_masks, got.aux_pred_masks)):
        scale = max(1.0, float(r.std()))
        worst = max(worst, float((g.cpu() - r).abs().max()) / scale)
    return worst


def main():
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mask3d_tpu_torch as mt
        from mask3d_tpu_torch import config as cfg_mod
        from mask3d_tpu_torch import cuda_build
        from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
        from mask3d_tpu_torch.evalm import Mask3DEvaluator
        from mask3d_tpu_torch.infer import level_capacities
        from mask3d_tpu_torch.ops import masked_attention as ma
        from mask3d_tpu_torch.postprocess import postprocess_item
        from mask3d_tpu_torch.sparse import dense_ops, row_gather as rg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    t_start = time.perf_counter()

    def phase(name, fn):
        try:
            return fn()
        except Exception:
            failures.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    def build():
        secs = cuda_build.build()
        log(f"built {', '.join(cuda_build.KERNELS)} in {secs:.2f} s")
        for name, text in cuda_build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        return secs

    if phase("build", build) is None:
        log("build failed; nothing else can run")
        return 1

    cfg = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}"])

    def collate():
        t = time.perf_counter()
        host = mt.collate(flagship_items(make_synthetic_scene, np, 0),
                          device="cuda",
                          point_bucket_multiple=BUCKET)
        log(f"collated 8 scenes in {time.perf_counter() - t:.2f} s: "
            f"capacity {host.device.capacity}, counts "
            f"{host.device.counts.tolist()}, grid {host.device.grid_dims}")
        return host

    host = phase("collate", collate)
    if host is None:
        return 1

    attn_rows = phase("attention kernel vs plain",
                      lambda: check_attention(torch, F, ma)) or []
    if any(not r["ok"] for r in attn_rows):
        failures.append("attention kernel disagrees with its plain version")
    gather_rows = phase("row gather kernel vs plain", lambda: check_gather(
        torch, rg, dense_ops, host.device,
        level_capacities(cfg, host.device.capacity))) or []
    if any(not r["equal"] for r in gather_rows):
        failures.append("row gather kernel disagrees with its plain version")

    model = phase("build model",
                  lambda: mt.build_model(cfg, device="cuda", seed=0))
    launches = {}
    fwd_ms = []

    def main_path():
        mt.infer(model, host.device, cfg, device="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ma.masked_cross_attention.launches = 0
        rg.row_gather.launches = 0
        out, overflow = mt.infer(model, host.device, cfg, device="cuda")
        torch.cuda.synchronize()
        launches["masked_attention"] = ma.masked_cross_attention.launches
        launches["row_gather"] = rg.row_gather.launches
        log(f"main path launches: {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        pc, pm = out.pred_class, out.pred_masks
        b, n = host.device.coords.shape[:2]
        q = cfg.model.num_queries
        assert tuple(pc.shape) == (b, q, cfg.model.num_classes + 1), pc.shape
        assert tuple(pm.shape) == (b, n, q), pm.shape
        assert bool(torch.isfinite(pc).all()) and bool(
            torch.isfinite(pm).all()), "non-finite outputs"
        assert not bool(overflow), "a pyramid level overflowed"
        n_dec = cfg.model.num_decoders * len(cfg.model.hlevels)
        assert launches["masked_attention"] == n_dec, launches
        assert launches["row_gather"] == 13, launches  # 5 taps + 4 x 2
        return pc.cpu().numpy(), pm.cpu().numpy()

    preds = phase("main path", main_path) if model is not None else None
    if preds is None:
        failures.append("main path did not run")

    def evaluate():
        pc, pm = preds
        dev = host.device
        counts = dev.counts.cpu().numpy()
        t = time.perf_counter()
        g = cfg.general
        items, targets = [], []
        for i in range(len(counts)):
            n = int(counts[i])
            items.append(postprocess_item(
                pc[i], pm[i, :n], host.raw_coords[i, :n], host.scenes[i],
                use_dbscan=g.use_dbscan, dbscan_eps=g.dbscan_eps,
                dbscan_min_points=g.dbscan_min_points,
                filter_out_instances=g.filter_out_instances,
                scores_threshold=g.scores_threshold,
                iou_threshold=g.iou_threshold))
            tv = dev.target.valid[i].cpu().numpy()
            targets.append({
                "labels": dev.target.labels[i].cpu().numpy()[tv],
                "masks": dev.target.masks[i].cpu().numpy()[tv][:, :n]})
        metrics = Mask3DEvaluator().evaluate(items, targets, "test")
        flat = {k: v for k, v in metrics.items() if not isinstance(v, dict)}
        log(f"metrics (random weights) after {time.perf_counter() - t:.1f} "
            f"s of postprocess+eval: {json.dumps(flat)}")
        assert all(np.isfinite(v) or np.isnan(v) for v in flat.values())

    if preds is not None:
        phase("postprocess and evaluator", evaluate)

    def reference():
        worst = small_reference(torch, mt, cfg_mod, make_synthetic_scene,
                                np)
        log(f"small forward, card vs CPU: max|diff|/max(1,std) {worst:.3g} "
            f"(tol 1e-4)")
        assert worst <= 1e-4, worst

    phase("card vs CPU at a small width", reference)

    def timing():
        for _ in range(2):
            mt.infer(model, host.device, cfg, device="cuda")
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(model, host.device, cfg, device="cuda")
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t) * 1e3)
        log(f"flagship fp32 forward, batch 8, bucket {BUCKET}: median "
            f"{statistics.median(fwd_ms):.2f} ms over 10 "
            f"(min {min(fwd_ms):.2f}, max {max(fwd_ms):.2f}) on {card}")

    if model is not None and preds is not None:
        phase("forward timing", timing)

    def kernel_entry(name, source, replaces, rows, key):
        main = rows[-1] if key == "S" else next(
            (r for r in rows if r["C"] == 96), rows[0] if rows else {})
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in rows),
                               default=None),
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"),
            "bound_by": main.get("bound_by"),
            "library_ms": main.get("library_ms"),
            "shapes": rows,
        }

    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    log(card)
    log(json.dumps({"kernels": [
        kernel_entry("masked_attention",
                     "mask3d_tpu_torch/csrc/masked_attention.cu",
                     "mask3d_tpu/ops/pallas_attention.py:102", attn_rows,
                     "S"),
        kernel_entry("row_gather", "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather_rows,
                     "C"),
    ], "forward_ms": fwd_ms}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
