"""Closed, pipelined batch inference: users segmenting stored scans in
batches, as the JAX bench drives it (`bench.py:302-383`).

Set-up: the program's model with the benchmark's weights, the traffic's
unique batches drawn from the seed and collated once (for their shapes:
one row capacity, and the run's static grid bucket, the elementwise
largest grid of every batch, which `infer_u8` takes), the kernels built
and two batches run end to end. Window: `feeders` host threads collate
(and, for `infer_u8`, encode) the cycled batches into a queue of 2; the
main thread dispatches each to the entry, keeps `in_flight` batches
queued on the device and fetches each batch's `pred_class` to the host
(`pred_masks` stays on the device). Dispatch stops at `--seconds` past
the first dispatch (or once the batches that the check samples have been
dispatched, if later), and the batches in flight are fetched. The window runs
from the first dispatch to the last fetch; a batch's latency from the
start of its collation to its fetch.

Cell keys: "entry" (`infer_u8` | `infer`), "feeders", "in_flight".
"""

from __future__ import annotations

import collections
import importlib
import queue
import threading
import time

import numpy as np


def setup(r):
    import torch
    entry_mod = importlib.import_module("mask3d_tpu_torch.infer")
    from mask3d_tpu_torch.data.collate import VoxelizeCollate

    with r.spans.span("setup.traffic"):
        unique = r.unique_batches()
    with r.spans.span("setup.model"):
        cfg, model = r.build_program()
    collator = VoxelizeCollate(
        point_bucket_multiple=int(r.traffic["bucket"]),
        build_targets=bool(r.traffic.get("targets", False)))
    with r.spans.span("setup.collate"):
        hosts = [collator(items) for items in unique]
    caps = {int(h.device.capacity) for h in hosts}
    if len(caps) != 1:
        raise ValueError(f"the traffic's batches take capacities {caps}: "
                         f"its bucket must hold every batch in one")
    n_cap = caps.pop()
    grid = tuple(tuple(max(int(h.device.grid_dims[li][a]) for h in hosts)
                       for a in range(3))
                 for li in range(len(hosts[0].device.grid_dims)))
    r.n_cap = n_cap
    r.counts = [np.asarray(h.device.counts) for h in hosts]
    entry = r.cell["entry"]
    b = int(r.traffic["batch_size"])

    def feed(items):
        host = collator(items)
        if entry == "infer_u8":
            buf, _ = entry_mod.encode_batch(host.device, cfg)
            return buf
        return host.device

    def dispatch(fed):
        """(pred_class, pred_masks, overflow flag or None) on the device."""
        if entry == "infer_u8":
            pc, pm = entry_mod.infer_u8(model, fed, cfg, b, n_cap, grid,
                                        device=r.device)
            return pc, pm, None
        out, overflow = entry_mod.infer(model, fed, cfg, device=r.device)
        return out.pred_class, out.pred_masks, overflow

    return feed, dispatch


def run(r):
    import torch

    feed, dispatch = setup(r)
    unique = r.unique_batches()
    n_unique = len(unique)
    with r.spans.span("setup.warmup"), torch.inference_mode():
        for u in range(min(2, n_unique)):  # every batch takes one shape
            dispatch(feed(unique[u]))[0].cpu()
        if r.device != "cpu":
            torch.cuda.synchronize()

    checks = set(r.check_indices())
    feeders = int(r.cell.get("feeders", 1))
    in_flight = int(r.cell.get("in_flight", 1))
    q = queue.Queue(maxsize=2)
    stop = threading.Event()
    errors = []

    def feeder(k):
        j = k
        try:
            while not stop.is_set():
                tf = time.perf_counter()
                with r.spans.span("feed"):
                    fed = feed(unique[j % n_unique])
                while not stop.is_set():
                    try:
                        q.put((j, tf, fed), timeout=0.05)
                        break
                    except queue.Full:
                        continue
                j += feeders
        except Exception as exc:  # handed to the main thread
            errors.append(exc)
            stop.set()

    def get():
        while True:
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if errors:
                    raise errors[0]

    pending = collections.deque()
    latencies, voxels = [], 0
    kept = {}
    win = None

    def fetch():
        nonlocal voxels
        j, tf, pc, pm, overflow, sampled = pending.popleft()
        with r.spans.span("fetch"):
            pc.cpu()
            bad = bool(overflow.any()) if overflow is not None else False
        latencies.append(time.perf_counter() - tf)
        u = j % n_unique
        voxels += int(r.counts[u].sum())
        r.failed += int(bad)
        if sampled:
            kept[u] = pm

    threads = [threading.Thread(target=feeder, args=(k,), daemon=True)
               for k in range(feeders)]
    with r.profiler(), torch.inference_mode():
        for th in threads:
            th.start()
        t0 = deadline = None
        while True:
            with r.spans.span("wait"):
                j, tf, fed = get()
            if t0 is None:
                win = r.spans.open("window")
                t0 = time.perf_counter()
                r.t_first_dispatch = t0
                deadline = t0 + r.seconds
            u = j % n_unique
            # the first forward of a sampled batch: the model's hook keeps
            # its rounds
            sampled = u in checks and u not in r.rounds
            r.tag = u if sampled else None
            with r.spans.span("dispatch"):
                pc, pm, overflow = dispatch(fed)
            r.tag = None
            pending.append((j, tf, pc, pm, overflow, sampled))
            r.forwards.append(j % n_unique)
            r.attempted += 1
            if len(pending) > in_flight:
                fetch()
            # the sampled batches are always among the window's (on the card
            # they are long done by the deadline)
            if time.perf_counter() >= deadline and checks <= set(r.forwards):
                break
        stop.set()
        while pending:
            fetch()
        t1 = time.perf_counter()
        r.spans.close(win)
    for th in threads:
        th.join(timeout=60)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a feeder thread did not stop")
    r.window = (t0, t1)
    r.memory_peak = (torch.cuda.max_memory_allocated()
                     if r.device != "cpu" else 0)
    window_s = t1 - t0
    r.metrics["voxels_per_s"] = voxels / window_s
    r.metrics["batch_latency_p95_ms"] = float(
        np.percentile(latencies, 95)) * 1e3
    r.metrics["peak_mem_gib"] = r.memory_peak / 2**30
    r.notes.append(f"window {window_s:.3f} s, {len(latencies)} batches, "
                   f"latency p50 {np.percentile(latencies, 50) * 1e3:.1f} ms"
                   f" p95 over {len(latencies)} samples")
    r.samples = [r.kept(u, pm.float().cpu().numpy(), r.counts[u])
                 for u, pm in sorted(kept.items())]
    del kept, pending, dispatch
