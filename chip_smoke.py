#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`mask3d_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one, or when the package is not
beside this script. Phases:

1. Card and build: prints the card's name and power limit, builds the three
   CUDA kernels from `mask3d_tpu_torch/csrc/` (one nvcc per source, in
   parallel).
2. Kernels against their plain PyTorch versions on the card, at the
   flagship's shapes: masked cross-attention at B=8, Q=25, D=128, H=8 and
   S in {3072, 6144, 12288, 24576} (max |err| <= 1e-4); the row gather
   with indices from a real collated batch at C in {3, 96, 128, 256}
   (bitwise equal). Each is timed beside its plain version, a PyTorch
   library call that computes the same function where there is one, and
   its bound.
3. The main path: 8 synthetic scenes collated at bucket 49152, the flagship
   Mask3D + Res16UNet34C (fp32, seeded random weights) through `infer`,
   with the kernels' launch counts read around that one forward
   (12 attention, 13 gather), then post-processing and the evaluator. The
   same weights at a small width run on the CPU (plain versions) and on the
   card (kernels), and must agree.
4. The gather paths: the same scenes and weights through `infer` with
   `model.backbone_impl=gather` (fp32, no kernel: 12 attention launches)
   and `gather_pallas` (12 attention, 47 sparse conv, 0 gather launches),
   each compared with the dense forward on its outputs and backbone maps:
   `gather` within 1e-3 * max(1, std) (the same function in fp32; max
   |diff| of the maps, 99.9% quantile of the outputs), `gather_pallas`
   within a mean |diff| of 0.05 * max(1, std)
   (bf16 conv inputs at every level; the JAX package's bounds for one bf16
   level are printed beside). The sparse-conv wrapper counts its launches
   per (N, K, Cin, Cout) in that counted `gather_pallas` forward; the
   kernel is then held against its plain version at each of those shapes,
   on the batch's kernel map of that N and K (max |err| / max(1, std) <=
   1e-4). Two faults planted at run time (one kernel offset dropped in
   every same-stride conv; the pooled pyramid summing instead of
   averaging) must each fail both paths' gates. Then `gather_pallas` at a
   small width and bucket 1024, card against CPU: backbone maps within the
   JAX package's bf16 bounds (outputs printed).
5. Times: each forward's median over 10 runs.

TF32 is switched off for convolutions and matmuls: the slice is fp32 (the
`gather_pallas` convs round their inputs to bf16 by design).
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
ATTN_S = (3072, 6144, 12288, 24576)
ATTN_TOL = 1e-4
GATHER_C = {3: 1, 96: 0, 128: 2, 256: 3}  # channels -> level of that tap
# identical bf16-rounded inputs on both sides: f32 summation order only
SPCONV_TOL = 1e-4
# |diff| bounds of the JAX package for a bf16 gather-conv backbone against
# an fp32 one (tests/test_pallas_conv.py:169-173)
BF16_BOUNDS = dict(mean=5e-3, q999=5e-2, max=0.3)
# full-width path checks against the fp32 dense forward: `gather` computes
# the same function in fp32 (summation order only; max |diff| of the
# backbone maps / max(1, std)); `gather_pallas` rounds every conv input to
# bf16 (mean |diff| / max(1, std) of the maps and outputs)
FP32_PATH_TOL = 1e-3
BF16_PATH_MEAN = 0.05
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


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def kernel_map(sb, n, k):
    """(level, idx, ok): the batch's kernel map of N rows and K offsets."""
    maps = list(zip(range(sb.num_levels), sb.nbr_idx, sb.nbr_ok))
    maps.append((0, sb.nbr0_idx, sb.nbr0_ok))
    for level, idx, ok in maps:
        if idx is not None and tuple(idx.shape[1:]) == (n, k):
            return level, idx, ok
    raise LookupError(f"no kernel map with N={n}, K={k}")


def check_sparse_conv(torch, sc, sb, shape_launches):
    """Kernel vs plain at each (N, K, Cin, Cout) the counted forward
    launched, on the real batch's kernel map of that N and K; returns
    per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (n, k, cin, cout), n_launch in sorted(
            shape_launches.items(), key=lambda kv: (-kv[0][0],) + kv[0][1:]):
        level, idx, ok = kernel_map(sb, n, k)
        b = idx.shape[0]
        feats = torch.randn(b, n, cin, device="cuda", generator=gen)
        feats *= sb.levels[level].valid[..., None]
        w = torch.randn(k, cin, cout, device="cuda", generator=gen) / (
            k * cin) ** 0.5
        got = sc.sparse_conv(feats, w, idx, ok)
        ref = sc.sparse_conv_plain(feats, w, idx, ok)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scaled = err / max(1.0, ref.std().item())
        n_ok = int(ok.sum())
        row = dict(
            level=level, N=n, K=k, Cin=cin, Cout=cout, launches=n_launch,
            rows=b * n, ok_pairs=n_ok, max_abs_err=err, scaled_err=scaled,
            ok=bool(torch.isfinite(got).all()) and scaled <= SPCONV_TOL,
            ms=time_ms(torch, lambda: sc.sparse_conv(feats, w, idx, ok)),
            plain_ms=time_ms(torch, lambda: sc.sparse_conv_plain(
                feats, w, idx, ok), iters=3, warmup=1),
            library_ms=None,  # no single PyTorch call is a gather-conv
        )
        nbytes = b * n * k * 5 + b * n * cin * 4 + k * cin * cout * 2 + \
            b * n * cout * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * n_ok * cin * cout, BF16_FLOPS_PER_S)
        log(f"sparse_conv L{level} N={n} K={k} {cin}->{cout} x{n_launch}: "
            f"max|err| {err:.3g} scaled {scaled:.3g} (tol {SPCONV_TOL}) "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{n_ok / (b * n * k):.3f} of pairs ok")
        rows.append(row)
        del feats, w, got, ref
    return rows


def diff_stats(np, ref, got):
    """|got - ref| summary: mean, 99.9% quantile, max, and std(ref)."""
    ref = np.asarray(ref, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - ref)
    return dict(mean=float(diff.mean()), q999=float(np.quantile(diff, 0.999)),
                max=float(diff.max()), ref_std=float(ref.std()))


def within_bf16_bounds(stats):
    return all(stats[k] < v for k, v in BF16_BOUNDS.items())


def worst_ratio(stats, key, tol):
    """max over the compared tensors of stats[key] / (tol * max(1,
    std(ref))): the gate passes at <= 1."""
    return max(st[key] / (tol * max(1.0, st["ref_std"]))
               for st in stats.values())


def gate_ratio(path, stats):
    """A path's gate against the dense forward; passes at <= 1. `gather`:
    max |diff| of the backbone maps and the 99.9% quantile of the outputs
    (summation order can flip a threshold of the decoder's attention masks
    and move a few output values) within FP32_PATH_TOL * max(1, std);
    `gather_pallas`: mean |diff| of both within BF16_PATH_MEAN * max(1,
    std)."""
    if path == "gather":
        return max(
            st["q999" if what.startswith("pred") else "max"]
            / (FP32_PATH_TOL * max(1.0, st["ref_std"]))
            for what, st in stats.items())
    return worst_ratio(stats, "mean", BF16_PATH_MEAN)


def backbone_maps(torch, mdl, cfg, dev, sparse):
    """The five backbone feature maps [strides 16..1] as numpy arrays of
    their valid rows, through the context `infer` would build."""
    build_sparse_batch, level_capacities, sb_kwargs = sparse
    with torch.inference_mode():
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg, dev.capacity), dev.grid_dims,
            **sb_kwargs(cfg))
        _, maps, _ = mdl.backbone(dev.feats, sb, dev.grid_dims)
        n = sb.num_levels
        return [m[sb.levels[n - 1 - i].valid].cpu().numpy()
                for i, m in enumerate(maps)]


def small_models(mt, cfg_mod, synth, np, impl, bucket):
    """The small-width config, batch and one set of weights on the CPU and
    on the card."""
    ov = ["model.hidden_dim=32", "model.dim_feedforward=64",
          "model.num_queries=8", "model.num_heads=4",
          "model.num_decoders=2", "model.backbone=Res16UNet14A",
          "model.conv1_kernel_size=3",
          f"data.point_bucket_multiple={bucket}",
          f"model.backbone_impl={impl}"]
    cfg = cfg_mod.apply_overrides(cfg_mod.Config(), ov)
    rng = np.random.default_rng(3)
    items = [synth(rng, num_rooms_x=3, num_rooms_y=2, room_size=12,
                   height=6, jitter=0.0, dropout=0.5) for _ in range(2)]
    host = mt.collate(items, device="cpu", point_bucket_multiple=bucket)
    cpu_model = mt.build_model(cfg, device="cpu", seed=5)
    gpu_model = mt.build_model(cfg, device="cuda", seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cfg, host, cpu_model, gpu_model


def small_reference(torch, mt, cfg_mod, synth, np):
    """Same weights at a small width: the card (kernels) against the CPU
    (plain versions). Returns the max |diff| / max(1, std) over both
    outputs."""
    cfg, host, cpu_model, gpu_model = small_models(mt, cfg_mod, synth, np,
                                                   "dense", 512)
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


def small_reference_gather(torch, mt, cfg_mod, synth, np, sparse):
    """`gather_pallas` at a small width and bucket 1024 (levels 0 and 1
    take the kernel), card against CPU: diff_stats of the backbone's
    feature maps and of the final outputs."""
    cfg, host, cpu_model, gpu_model = small_models(
        mt, cfg_mod, synth, np, "gather_pallas", 1024)
    ref = backbone_maps(torch, cpu_model, cfg, host.device, sparse)
    got = backbone_maps(torch, gpu_model, cfg, host.device.to("cuda"),
                        sparse)
    maps = [diff_stats(np, r, g) for r, g in zip(ref, got)]
    out_ref, _ = mt.infer(cpu_model, host.device, cfg, device="cpu")
    out_got, _ = mt.infer(gpu_model, host.device, cfg, device="cuda")
    final = {w: diff_stats(np, getattr(out_ref, w).numpy(),
                           getattr(out_got, w).cpu().numpy())
             for w in ("pred_class", "pred_masks")}
    return maps, final


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
        from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
        from mask3d_tpu_torch.models import mask3d as mask3d_mod
        from mask3d_tpu_torch.models.backbone import _GatherCtx
        from mask3d_tpu_torch.ops import masked_attention as ma
        from mask3d_tpu_torch.postprocess import postprocess_item
        from mask3d_tpu_torch.sparse import dense_ops, row_gather as rg
        from mask3d_tpu_torch.sparse import ops as sparse_ops
        from mask3d_tpu_torch.sparse import sparse_conv as sc
        from mask3d_tpu_torch.sparse.context import build_sparse_batch
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

    cfg_gp = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}",
                           "model.backbone_impl=gather_pallas"])
    cfg_g = cfg_mod.apply_overrides(
        cfg_mod.Config(), [f"data.point_bucket_multiple={BUCKET}",
                           "model.backbone_impl=gather"])
    sparse = (build_sparse_batch, level_capacities, _sb_kwargs)

    model = phase("build model",
                  lambda: mt.build_model(cfg, device="cuda", seed=0))
    launches = {}
    shape_launches = {}  # path -> sparse conv launches by (N, K, Cin, Cout)
    fwd_ms = {}
    counters = {"masked_attention": ma.masked_cross_attention,
                "row_gather": rg.row_gather, "sparse_conv": sc.sparse_conv}

    def counted_forward(path, mdl, c):
        """One forward with every count set to 0 just before it and read
        just after; checks shapes, finiteness and overflow."""
        mt.infer(mdl, host.device, c, device="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        sc.sparse_conv.launches_by_shape.clear()
        out, overflow = mt.infer(mdl, host.device, c, device="cuda")
        torch.cuda.synchronize()
        launches[path] = {k: fn.launches for k, fn in counters.items()}
        shape_launches[path] = dict(sc.sparse_conv.launches_by_shape)
        log(f"{path} path launches: {launches[path]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        pc, pm = out.pred_class, out.pred_masks
        b, n = host.device.coords.shape[:2]
        q = c.model.num_queries
        assert tuple(pc.shape) == (b, q, c.model.num_classes + 1), pc.shape
        assert tuple(pm.shape) == (b, n, q), pm.shape
        assert bool(torch.isfinite(pc).all()) and bool(
            torch.isfinite(pm).all()), "non-finite outputs"
        assert not bool(overflow), "a pyramid level overflowed"
        return pc.cpu().numpy(), pm.cpu().numpy()

    n_dec = cfg.model.num_decoders * len(cfg.model.hlevels)

    def main_path():
        preds = counted_forward("dense", model, cfg)
        assert launches["dense"] == {"masked_attention": n_dec,
                                     "row_gather": 13,  # 5 taps + 4 x 2
                                     "sparse_conv": 0}, launches
        return preds

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

    gather_models = {}
    dense_ref = {}

    def path_stats(mdl, c, pc, pm):
        """diff_stats of a path's outputs and backbone maps against the
        dense forward on the same weights."""
        if not dense_ref:
            counts = host.device.counts.cpu().numpy()
            dense_ref["valid"] = (np.arange(preds[1].shape[1])[None]
                                  < counts[:, None])
            dense_ref["maps"] = backbone_maps(torch, model, cfg, host.device,
                                              sparse)
        valid = dense_ref["valid"]
        stats = {"pred_class": diff_stats(np, preds[0], pc),
                 "pred_masks": diff_stats(np, preds[1][valid], pm[valid])}
        maps = backbone_maps(torch, mdl, c, host.device, sparse)
        for i, (r, g) in enumerate(zip(dense_ref["maps"], maps)):
            stats[f"map{i} (stride {16 >> i})"] = diff_stats(np, r, g)
        return stats

    def gather_paths():
        """`gather` and `gather_pallas` at full width on the dense model's
        weights: launch counts, then outputs and backbone maps against the
        dense forward."""
        results = {}
        for path, c in (("gather", cfg_g), ("gather_pallas", cfg_gp)):
            mdl = mt.build_model(c, device="cuda", seed=0)
            mdl.load_state_dict(model.state_dict())
            pc, pm = counted_forward(path, mdl, c)
            # gather_pallas: the k=5 stem + 23 BasicBlocks x 2 convs, every
            # level eligible; gather runs them all in fp32 PyTorch
            assert launches[path] == {
                "masked_attention": n_dec, "row_gather": 0,
                "sparse_conv": 47 if path == "gather_pallas" else 0
            }, launches
            assert sum(shape_launches[path].values()) == \
                launches[path]["sparse_conv"], shape_launches
            stats = path_stats(mdl, c, pc, pm)
            for what, st in stats.items():
                log(f"{path} vs dense {what}: {json.dumps(st)}; within the "
                    f"JAX bf16 bounds {within_bf16_bounds(st)}")
            results[path] = stats
            gather_models[path] = (mdl, c)
        ratios = {path: gate_ratio(path, st) for path, st in results.items()}
        log(f"gate ratios against dense (pass at <= 1): {ratios}")
        for path, ratio in ratios.items():
            assert ratio <= 1.0, (path, results[path])

    if model is not None and preds is not None:
        phase("gather paths at full width", gather_paths)

    def sparse_conv_check():
        dev = host.device
        sb = build_sparse_batch(
            dev.coords, dev.counts, dev.dims,
            level_capacities(cfg_gp, dev.capacity), dev.grid_dims,
            **_sb_kwargs(cfg_gp))
        shapes = shape_launches["gather_pallas"]
        log(f"sparse_conv launches by (N, K, Cin, Cout) in the counted "
            f"gather_pallas forward: {shapes}")
        return check_sparse_conv(torch, sc, sb, shapes)

    spconv_rows = phase("sparse conv kernel vs plain",
                        sparse_conv_check) or []
    if not spconv_rows or any(not r["ok"] for r in spconv_rows):
        failures.append("sparse conv kernel not checked or disagrees with "
                        "its plain version")

    def planted_faults():
        """Each fault, patched in at run time and taken out again, must
        fail the gate of each gather path that its sound forward passed."""
        conv = _GatherCtx._conv

        def drop_offset(self, x, w, idx, ok):
            ok = ok.clone()
            ok[..., 0] = False
            return conv(self, x, w, idx, ok)

        def sum_pool(x, pool, cap):
            return sparse_ops.avg_pool(x, pool, cap) * \
                pool.nchild.clamp(min=1)[..., None]

        faults = {"offset 0 dropped in every same-stride conv":
                  (_GatherCtx, "_conv", drop_offset),
                  "pooled pyramid sums instead of averaging":
                  (mask3d_mod, "avg_pool", sum_pool)}
        for name, (owner, attr, fake) in faults.items():
            for path, (mdl, c) in gather_models.items():
                real = getattr(owner, attr)
                setattr(owner, attr, fake)
                try:
                    out, _ = mt.infer(mdl, host.device, c, device="cuda")
                    stats = path_stats(mdl, c, out.pred_class.cpu().numpy(),
                                       out.pred_masks.cpu().numpy())
                finally:
                    setattr(owner, attr, real)
                ratio = gate_ratio(path, stats)
                log(f"planted fault '{name}' on {path}: gate ratio "
                    f"{ratio:.4g} (must be > 1); "
                    f"{json.dumps({w: st['mean'] for w, st in stats.items()})}"
                    f" mean |diff|")
                assert ratio > 1.0, (name, path, ratio)

    if len(gather_models) == 2:
        phase("planted faults fail the gather gates", planted_faults)
    else:
        failures.append("planted faults not run")

    def reference_gp():
        maps, final = small_reference_gather(
            torch, mt, cfg_mod, make_synthetic_scene, np, sparse)
        for i, stats in enumerate(maps):
            log(f"small gather_pallas backbone map {i}, card vs CPU: "
                f"{json.dumps(stats)} (bounds {BF16_BOUNDS})")
        # printed, not gated: with random weights at this width the
        # decoder's mask thresholds amplify bf16 rounding flips (mean |diff|
        # 4x the full-width gate); the decoder on the gather paths is gated
        # by the full-width `gather` outputs against dense
        for what, st in final.items():
            log(f"small gather_pallas {what}, card vs CPU: {json.dumps(st)}")
        assert all(within_bf16_bounds(st) for st in maps), maps

    phase("gather_pallas card vs CPU at a small width", reference_gp)

    def timing(path, mdl, c):
        ms = fwd_ms.setdefault(path, [])
        for _ in range(2):
            mt.infer(mdl, host.device, c, device="cuda")
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mt.infer(mdl, host.device, c, device="cuda")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        log(f"flagship {path} forward, batch 8, bucket {BUCKET}: median "
            f"{statistics.median(ms):.2f} ms over 10 "
            f"(min {min(ms):.2f}, max {max(ms):.2f}) on {card}")

    if model is not None and preds is not None:
        phase("forward timing", lambda: timing("dense", model, cfg))
    for path, (mdl, c) in gather_models.items():
        phase(f"{path} forward timing",
              lambda: timing(path, mdl, c))

    def kernel_entry(name, source, replaces, rows, main, path, **extra):
        """`main` is the row of the shape the summary keys report; the
        launches are those of the path that runs the kernel."""
        main = main or {}
        return extra | {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(path, {}).get(name, 0),
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
                     attn_rows[-1] if attn_rows else None, "dense"),
        kernel_entry("row_gather", "mask3d_tpu_torch/csrc/row_gather.cu",
                     "mask3d_tpu/sparse/pallas_gather.py:198", gather_rows,
                     next((r for r in gather_rows if r["C"] == 96), None),
                     "dense"),
        kernel_entry("sparse_conv", "mask3d_tpu_torch/csrc/sparse_conv.cu",
                     "mask3d_tpu/sparse/pallas_conv.py:316", spconv_rows,
                     max(spconv_rows, key=lambda r: r["launches"] * r["ms"],
                         default=None), "gather_pallas",
                     forward_ms=sum(r["launches"] * r["ms"]
                                    for r in spconv_rows),
                     forward_bound_ms=sum(r["launches"] * r["bound_ms"]
                                          for r in spconv_rows)),
    ], "launches_by_path": launches, "forward_ms": fwd_ms}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
