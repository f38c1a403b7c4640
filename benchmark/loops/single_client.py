"""One client in a closed loop: a user who waits on each scan.

Set-up: the program's model with the benchmark's weights and the
traffic's unique batches drawn from the seed and collated once on the
host (the cut this loop makes: collation is not timed), the kernels built
and one call run. Window: from the first call, each call hands the host
batch to the entry (which copies it to the device and builds the sparse
batch) and brings `pred_class` and `pred_masks` back to the host before
the next call; calls start until `--seconds` have passed (and the scans
that the check samples have been called), and the last one is waited
for. A call's latency runs from its entry call to its
outputs on the host.

Cell keys: "entry" (`infer`).
"""

from __future__ import annotations

import importlib
import time

import numpy as np


def run(r):
    import torch
    entry_mod = importlib.import_module("mask3d_tpu_torch.infer")
    from mask3d_tpu_torch.data.collate import VoxelizeCollate

    with r.spans.span("setup.traffic"):
        unique = r.unique_batches()
    n_unique = len(unique)
    with r.spans.span("setup.model"):
        cfg, model = r.build_program()
    collator = VoxelizeCollate(
        point_bucket_multiple=int(r.traffic["bucket"]),
        build_targets=bool(r.traffic.get("targets", False)))
    with r.spans.span("setup.collate"):
        hosts = [collator(items).device for items in unique]
    r.counts = [np.asarray(h.counts) for h in hosts]
    r.n_cap = max(int(h.capacity) for h in hosts)
    if r.cell["entry"] != "infer":
        raise ValueError(f"single_client runs the entry `infer`, not "
                         f"{r.cell['entry']!r}")

    def call(model_, cfg_, u):
        with r.spans.span("dispatch"):
            out, overflow = entry_mod.infer(model_, hosts[u], cfg_,
                                            device=r.device)
        with r.spans.span("fetch"):
            pc = out.pred_class.cpu().numpy()
            pm = out.pred_masks.float().cpu().numpy()
            return pc, pm, bool(overflow)

    with r.spans.span("setup.warmup"), torch.inference_mode():
        call(model, cfg, 0)
        if r.device != "cpu":
            torch.cuda.synchronize()
    checks = set(r.check_indices())
    latencies, voxels, kept = [], 0, {}
    with r.profiler(), torch.inference_mode():
        win = r.spans.open("window")
        t0 = time.perf_counter()
        r.t_first_dispatch = t0
        i = 0
        while (time.perf_counter() < t0 + r.seconds
               or not checks <= set(r.forwards)):
            u = i % n_unique
            # the first call of a sampled scan: the model's hook keeps its
            # rounds
            r.tag = u if u in checks and u not in kept else None
            ts = time.perf_counter()
            _, pm, bad = call(model, cfg, u)
            latencies.append(time.perf_counter() - ts)
            r.forwards.append(u)
            r.attempted += 1
            r.failed += int(bad)
            voxels += int(r.counts[u].sum())
            if r.tag is not None:
                kept[u] = pm
                r.tag = None
            i += 1
        t1 = time.perf_counter()
        r.spans.close(win)
    r.window = (t0, t1)
    r.memory_peak = (torch.cuda.max_memory_allocated()
                     if r.device != "cpu" else 0)
    r.metrics["voxels_per_s"] = voxels / (t1 - t0)
    r.metrics["batch_latency_p95_ms"] = float(
        np.percentile(latencies, 95)) * 1e3
    r.metrics["peak_mem_gib"] = r.memory_peak / 2**30
    r.notes.append(f"window {t1 - t0:.3f} s, {len(latencies)} calls, "
                   f"latency p50 {np.percentile(latencies, 50) * 1e3:.1f} ms"
                   f" p95 over {len(latencies)} samples")
    r.samples = [r.kept(u, pm, r.counts[u]) for u, pm in
                 sorted(kept.items())]
    del model, kept
